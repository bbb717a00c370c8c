"""HSTULayer, the block's pre/postprocessors and HSTUBlock: the port against
flax (KernelBackend.JNP), forward and the gradients of <out, w> for the
inputs and every param, with flax params carried over by `convert.py`
(fp32, rtol 1e-4, atol 1e-5)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from recsys_examples_torch import convert
from recsys_examples_torch.data.hstu_batch import random_hstu_batch as t_batch
from recsys_examples_torch.jagged.jagged_tensor import JaggedData as TJagged
from recsys_examples_torch.modules import config as tc
from recsys_examples_torch.modules.hstu_block import (
    HSTUBlock as TBlock,
    HSTUBlockPostprocessor as TPost,
    HSTUBlockPreprocessor as TPre,
)
from recsys_examples_torch.modules.hstu_layer import HSTULayer as TLayer, dropout
from recsys_examples_tpu.data.hstu_batch import as_device_batch
from recsys_examples_tpu.data.hstu_batch import random_hstu_batch as j_batch
from recsys_examples_tpu.jagged.jagged_tensor import make_jagged_data
from recsys_examples_tpu.modules import config as jc
from recsys_examples_tpu.modules.hstu_block import (
    HSTUBlock as JBlock,
    HSTUBlockPostprocessor as JPost,
    HSTUBlockPreprocessor as JPre,
)
from recsys_examples_tpu.modules.hstu_layer import HSTULayer as JLayer

TOL = dict(rtol=1e-4, atol=1e-5)
D, E = 32, 16
FEATS = ("item", "action", "user_id", "user_age")


def _configs(**kw):
    base = dict(hidden_size=D, num_layers=2, num_attention_heads=2, kv_channels=16,
                item_embedding_dim=E, contextual_embedding_dim=E, **kw)
    return (jc.HSTUConfig(**base, kernel_backend=jc.KernelBackend.JNP, dtype=jnp.float32,
                          position_encoding_config=jc.PositionEncodingConfig(64)),
            tc.HSTUConfig(**base, dtype=torch.float32,
                          position_encoding_config=tc.PositionEncodingConfig(64)))


def _batches(seed, cands):
    kw = dict(batch_size=3, max_history_len=12, item_vocab=50, action_vocab=5,
              contextual_vocabs={"user_id": 20, "user_age": 9},
              max_num_candidates=3 if cands else 0)
    return as_device_batch(j_batch(seed, **kw)), t_batch(seed, **kw).to("cpu")


def _perturbed(params, seed):
    """Params moved off their init values, so LN scales and biases count."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * rng.standard_normal(p.shape).astype(np.float32),
        nn.unbox(params))


def _vjp_both(jfn, tfn, params, inputs, seed):
    """Forward of both sides and the grads of <out, w> for the params and
    each of `inputs` (numpy arrays), compared."""
    jin = [jnp.asarray(x) for x in inputs]
    shape = jax.eval_shape(jfn, params, jin).shape
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)

    @jax.jit
    def fwd_bwd(p, ins):
        out, vjp = jax.vjp(jfn, p, ins)
        return out, vjp(jnp.asarray(w))

    jout, (jg_params, jg_inputs) = fwd_bwd(params, jin)
    tin = [torch.tensor(x, requires_grad=True) for x in inputs]
    tout, tmod = tfn(tin)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **TOL)
    (tout * torch.from_numpy(w)).sum().backward()
    for x, g in zip(tin, jg_inputs):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), **TOL)
    got = dict(jax.tree_util.tree_leaves_with_path(convert.flax_params(
        {k: p.grad for k, p in tmod.named_parameters()})))
    want = jax.tree_util.tree_leaves_with_path(jg_params)
    assert len(got) == len(want)
    for path, g in want:
        np.testing.assert_allclose(got[path], np.asarray(g), **TOL,
                                   err_msg=jax.tree_util.keystr(path))


def _jagged_inputs(seed, ctx):
    rng = np.random.default_rng(seed)
    lens = np.array([9, 0, 14, 5], np.int32)
    x = rng.standard_normal((int(lens.sum()) + 3, D)).astype(np.float32)
    x[lens.sum():] = 0
    nc = np.array([2, 0, 3, 1], np.int32)
    return x, lens, nc, (np.array([1, 0, 2, 1], np.int32) if ctx else None)


def _layer_case(ctx, **cfg_kw):
    jcfg, tcfg = _configs(**cfg_kw)
    x, lens, nc, cl = _jagged_inputs(0, ctx)
    mk = lambda v: make_jagged_data(
        v, jnp.asarray(lens), 14, num_candidates=jnp.asarray(nc), max_num_candidates=3,
        contextual_seqlen=None if cl is None else jnp.asarray(cl),
        contextual_max_seqlen=0 if cl is None else 2)
    jlayer = JLayer(jcfg)
    params = _perturbed(jlayer.init(jax.random.PRNGKey(0), mk(jnp.asarray(x)))["params"], 1)
    tlayer = TLayer(tcfg)
    tlayer.load_state_dict(convert.dense_state_dict(params))
    offs = torch.from_numpy(np.concatenate([[0], np.cumsum(lens)]))
    tj = lambda v: TJagged(
        values=v, seqlen=torch.from_numpy(lens), seqlen_offsets=offs, max_seqlen=14,
        max_num_candidates=3, num_candidates=torch.from_numpy(nc),
        contextual_max_seqlen=0 if cl is None else 2,
        contextual_seqlen=None if cl is None else torch.from_numpy(cl))
    _vjp_both(lambda p, ins: jlayer.apply({"params": p}, mk(ins[0])).values,
              lambda ins: (tlayer(tj(ins[0])).values, tlayer), params, [x], 2)
    return tlayer


@pytest.mark.parametrize("learnable_out,ctx", [(False, False), (True, True)])
def test_layer_matches_flax(learnable_out, ctx):
    _layer_case(ctx, learnable_output_layernorm=learnable_out)


@pytest.mark.parametrize("causal,ctx", [(True, True), (False, False)])
def test_layer_with_relative_bias_matches_flax(causal, ctx):
    """use_relative_attention_bias: the layer's `relative_bias/rel_bias`
    param crosses through convert.py both ways, and its gradient (drab
    summed over the batch, then along the diagonals) matches flax's."""
    tlayer = _layer_case(ctx, use_relative_attention_bias=True, is_causal=causal,
                         relative_bias_num_buckets=8, relative_bias_max_distance=6)
    assert tuple(tlayer.relative_bias.rel_bias.shape) == (8, 2)
    assert "relative_bias" in convert.flax_params(tlayer.state_dict())


def _embeddings(jb, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((jb.features[n].values.shape[0], E)).astype(np.float32)
            for n in FEATS]


@pytest.mark.parametrize("cands", [False, True])
def test_preprocessor_matches_flax(cands):
    jcfg, tcfg = _configs()
    jb, tb = _batches(3, cands)
    embs = _embeddings(jb, 4)
    jpre = JPre(jcfg)
    as_dict = lambda vals, wrap: dict(zip(FEATS, map(wrap, vals)))
    params = _perturbed(jpre.init(jax.random.PRNGKey(0), as_dict(embs, jnp.asarray),
                                  jb, False)["params"], 5)
    tpre = TPre(tcfg)
    tpre.load_state_dict(convert.dense_state_dict(params))
    _vjp_both(lambda p, ins: jpre.apply({"params": p}, dict(zip(FEATS, ins)), jb).values,
              lambda ins: (tpre(dict(zip(FEATS, ins)), tb).values, tpre), params, embs, 6)


def _post_input(cands):
    lens = np.array([7, 3, 11], np.int32)
    T = int(lens.sum()) + 1
    if cands:
        kw = dict(num_candidates=np.array([2, 0, 3], np.int32), max_num_candidates=3)
    else:
        # 1 contextual token each, then interleaved item/action rows
        lens = np.array([7, 3, 11], np.int32)
        T = 3 + 2 * 12
        kw = dict(contextual_seqlen=np.array([1, 1, 1], np.int32), contextual_max_seqlen=1)
    x = np.random.default_rng(7).standard_normal((T, D)).astype(np.float32)
    return x, lens, kw


@pytest.mark.parametrize("cands", [False, True])
def test_postprocessor_matches_flax(cands):
    x, lens, kw = _post_input(cands)
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    jpost = JPost()
    mk = lambda v: make_jagged_data(v, jnp.asarray(lens), 11,
                                    has_interleaved_action=True, **jkw)
    offs = torch.from_numpy(np.concatenate([[0], np.cumsum(lens)]))
    tpost = TPost()
    tfn = lambda ins: (tpost(TJagged(values=ins[0], seqlen=torch.from_numpy(lens),
                                     seqlen_offsets=offs, max_seqlen=11,
                                     has_interleaved_action=True, **tkw)).values, tpost)
    _vjp_both(lambda p, ins: jpost.apply({}, mk(ins[0])).values, tfn, {}, [x], 8)


@pytest.mark.parametrize("cands", [False, True])
def test_block_matches_flax(cands):
    jcfg, tcfg = _configs()
    jb, tb = _batches(9, cands)
    embs = _embeddings(jb, 10)
    jblock = JBlock(jcfg)
    params = _perturbed(jblock.init(jax.random.PRNGKey(0),
                                    dict(zip(FEATS, map(jnp.asarray, embs))), jb,
                                    False)["params"], 11)
    tblock = TBlock(tcfg)
    tblock.load_state_dict(convert.dense_state_dict(params))
    _vjp_both(lambda p, ins: jblock.apply({"params": p}, dict(zip(FEATS, ins)), jb).values,
              lambda ins: (tblock(dict(zip(FEATS, ins)), tb).values, tblock),
              params, embs, 12)


@pytest.mark.parametrize("time_encoding", [False, True])
def test_positional_encoder_matches_flax(time_encoding):
    """HSTUPositionalEncoder, with the timestamp buckets too, and the
    position clamp at seqlen - num_targets."""
    from recsys_examples_torch.modules.position_encoder import HSTUPositionalEncoder as TPE
    from recsys_examples_tpu.modules.position_encoder import HSTUPositionalEncoder as JPE

    x, lens, nc, _ = _jagged_inputs(13, False)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    ts = np.random.default_rng(14).integers(0, 5000, size=x.shape[0]).astype(np.int32)
    kw = dict(num_position_buckets=10, num_time_buckets=16, embedding_dim=D,
              use_time_encoding=time_encoding)
    jpe = JPE(**kw)
    jargs = lambda v: (v, jnp.asarray(lens), jnp.asarray(offs), jnp.asarray(nc),
                       jnp.asarray(ts))
    params = _perturbed(jpe.init(jax.random.PRNGKey(0), *jargs(jnp.asarray(x)))["params"], 15)
    tpe = TPE(**kw)
    tpe.load_state_dict(convert.dense_state_dict(params))
    targs = lambda v: (v, torch.from_numpy(lens), torch.from_numpy(offs),
                       torch.from_numpy(nc), torch.from_numpy(ts))
    _vjp_both(lambda p, ins: jpe.apply({"params": p}, *jargs(ins[0])),
              lambda ins: (tpe(*targs(ins[0])), tpe), params, [x], 16)


def test_recompute_layer_gives_the_same_grads():
    """recompute_layer (torch.utils.checkpoint per layer) changes memory,
    not results."""
    _, tcfg = _configs()
    _, tb = _batches(17, False)
    embs = [torch.from_numpy(e) for e in _embeddings(_batches(17, False)[0], 18)]
    grads = []
    for remat in (False, True):
        block = TBlock(dataclasses.replace(tcfg, recompute_layer=remat))
        gen = torch.Generator().manual_seed(1)
        for m in block.modules():
            if m is not block and hasattr(m, "init_weights"):
                m.init_weights(gen)
        out = block(dict(zip(FEATS, embs)), tb).values
        out.square().sum().backward()
        grads.append({n: p.grad.clone() for n, p in block.named_parameters()})
    for n, g in grads[0].items():
        torch.testing.assert_close(grads[1][n], g, rtol=0, atol=0, msg=n)


def test_dropout_keeps_and_scales_from_the_generator():
    x = torch.ones(4000)
    a = dropout(x, 0.25, torch.Generator().manual_seed(3))
    b = dropout(x, 0.25, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    kept = a != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.03
    assert torch.allclose(a[kept], torch.full_like(a[kept], 1 / 0.75))
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.25, None)
