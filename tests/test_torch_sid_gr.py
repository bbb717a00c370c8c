"""The port's SID-GR model against the JAX package's on the same numpy
batch and the same params (flax tree -> `convert.dense_state_dict`), fp32 on
the CPU, where the port's beam-decode attention runs its plain version:
the eval loss, `generate`, `generate_beam_decode`, and the stepwise
`beam_prefill` / `beam_step` / `beam_finalize` with a narrowing schedule, a
`width_pad` and a constraint processor. Paths, tokens and parents must be
equal; scores and losses within rtol/atol 1e-5 unless a test says otherwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_examples_torch import convert
from recsys_examples_torch.data.sid_batch import random_sid_batch as t_batch
from recsys_examples_torch.inference.sid_serving.item_constraints import (
    TrieConstraint as TTrie,
)
from recsys_examples_torch.inference.sid_serving import logits_processor as t_lp
from recsys_examples_torch.models.sid_gr import SIDGRConfig as TConfig
from recsys_examples_torch.models.sid_gr import SIDGRModel as TModel
from recsys_examples_tpu.data.sid_batch import random_sid_batch as j_batch
from recsys_examples_tpu.inference.sid_serving import logits_processor as j_lp
from recsys_examples_tpu.inference.sid_serving.item_constraints import (
    TrieConstraint as JTrie,
)
from recsys_examples_tpu.models.sid_gr import SIDGRConfig as JConfig
from recsys_examples_tpu.models.sid_gr import SIDGRModel as JModel

BASE = dict(num_hierarchies=3, codebook_size=32, hidden_size=32, num_layers=2,
            num_heads=2, head_dim=16, ffn_hidden=64, beam_width=4)
CONFIGS = {
    "base": BASE,      # tests/test_sid_gr.py's configuration
    "shared": dict(BASE, num_hierarchies=4, share_codebook=True, share_lm_head=True),
}
BATCH = dict(batch_size=4, max_history_items=6, codebook_size=32)
TOL = dict(rtol=1e-5, atol=1e-5)


def to_np(tree):
    return jax.tree.map(lambda x: np.asarray(x), tree)


def f32(tree):
    """flax initialises in float64 when x64 is on; both sides take fp32."""
    return jax.tree.map(lambda x: x.astype(jnp.float32), tree)


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    """(jax model, flax params, jax batch, torch model, torch batch)."""
    kw = CONFIGS[request.param]
    H = kw["num_hierarchies"]
    jb = j_batch(0, num_hierarchies=H, **BATCH)
    tb = t_batch(0, num_hierarchies=H, **BATCH)
    jm = JModel(JConfig(**kw))
    params = f32(jm.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                         jb, train=False)["params"])
    tm = TModel(TConfig(**kw), device="cpu")
    missing = tm.load_state_dict(convert.dense_state_dict(to_np(params)))
    assert not missing.missing_keys and not missing.unexpected_keys
    return jm, params, jb, tm, tb


def test_params_round_trip(pair):
    _, params, _, tm, _ = pair
    back = convert.flax_params(tm.state_dict())
    want = to_np(params)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_w) == len(flat_b)
    for path, leaf in flat_w:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_eval_loss_matches(pair):
    jm, params, jb, tm, tb = pair
    want, aux = jm.apply({"params": params}, jb, train=False)
    got, taux = tm(tb, train=False)
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(taux["per_hierarchy_loss"].detach().numpy(),
                               np.asarray(aux["per_hierarchy_loss"]), **TOL)
    got.backward()     # the loss is differentiable through the whole model
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in tm.parameters())
    tm.zero_grad()


@pytest.mark.parametrize("method", ["generate", "generate_beam_decode"])
def test_generation_matches(pair, method):
    jm, params, jb, tm, tb = pair
    want_p, want_s = jm.apply({"params": params}, jb, beam_width=4,
                              method=getattr(JModel, method))
    got_p, got_s = getattr(tm, method)(tb, beam_width=4)
    assert got_p.shape == want_p.shape and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)


def test_beam_decode_matches_own_baseline(pair):
    """The cached path against the port's own no-KV oracle; rtol 1e-4 as
    the JAX package's test of the same pair."""
    *_, tm, tb = pair
    p_a, s_a = tm.generate(tb, beam_width=4)
    p_b, s_b = tm.generate_beam_decode(tb, beam_width=4)
    assert torch.equal(p_a, p_b)
    np.testing.assert_allclose(s_a.numpy(), s_b.numpy(), rtol=1e-4, atol=1e-5)


def _tries(H):
    rng = np.random.default_rng(5)
    catalog = np.unique(rng.integers(0, 32, size=(60, H)).astype(np.int32), axis=0)
    return catalog, JTrie(catalog, 32), TTrie(catalog, 32, device="cpu")


def _mask_fns(jt, tt):
    def j_mask(step, paths):
        node = jnp.zeros(paths.shape[:2], jnp.int32)
        for s in range(step):
            node = jt.advance(node, paths[:, :, s], s)
        return jt.mask_logits(jnp.zeros(paths.shape[:2] + (32,)), node, step)

    def t_mask(step, paths):
        node = torch.zeros(paths.shape[:2], dtype=torch.int64)
        for s in range(step):
            node = tt.advance(node, paths[:, :, s], s)
        return tt.mask_logits(torch.zeros(paths.shape[:2] + (32,)), node, step)

    return j_mask, t_mask


def _in_catalog(catalog, paths, scores):
    allowed = {tuple(r) for r in catalog.tolist()}
    live = torch.isfinite(scores)
    assert live.any()
    assert all(tuple(p) in allowed for p in paths[live].tolist())


def _same_carry(jc, tc, rows=slice(None)):
    """Every field of a JAX and a port carry on batch rows `rows` (axis 1 of
    the stacked per-layer KV, axis 0 elsewhere)."""
    assert set(jc) == set(tc)
    pick = lambda name, x: x[:, rows] if name[:4] in ("ctx_", "beam") and name != "ctx_lens" \
        else x[rows]
    for name in ("tokens", "parents", "anc", "kv_parents", "ctx_lens"):
        np.testing.assert_array_equal(pick(name, tc[name].numpy()),
                                      pick(name, np.asarray(jc[name])), err_msg=name)
    for name in ("scores", "ctx_k", "ctx_v", "beam_k", "beam_v"):
        np.testing.assert_allclose(pick(name, tc[name].numpy()),
                                   pick(name, np.asarray(jc[name])), **TOL, err_msg=name)


def _to_jax_carry(tc):
    return {k: jnp.asarray(v.numpy().astype(np.int32) if not v.is_floating_point()
                           else v.numpy()) for k, v in tc.items()}


def _walk_all_slots(tokens, parents, h):
    """[B, Wm, h] token prefixes by following `parents` over all Wm slots, in
    numpy: the oracle of the port's prefix decode."""
    B, _, Wm = tokens.shape
    cur = np.tile(np.arange(Wm), (B, 1))
    out = np.zeros((B, Wm, h), np.int64)
    for s in range(h - 1, -1, -1):
        out[:, :, s] = np.take_along_axis(tokens[:, s], cur, 1)
        cur = np.take_along_axis(parents[:, s], cur, 1)
    return out


@pytest.mark.parametrize("constrained", [False, True])
@pytest.mark.parametrize("schedule,width_pad", [((6, 6, 6, 6), None), ((8, 5, 3, 3), 10)])
def test_stepwise_decode_matches(pair, schedule, width_pad, constrained):
    """beam_prefill -> beam_step ... -> beam_finalize with a narrowing width
    schedule (KV compaction) and padded slots: every integer field of the
    carry equal after every step, scores and KV close, and with a
    temperature + trie-constraint chain every returned path in the catalog.

    The JAX package decodes a beam's prefix from the first `width_in` slots
    only: after a narrowing step a parent index can lie beyond them, its
    gather fills the token with INT_MIN and the trie masks that beam by a
    wrong node. The port walks all slots. So the constrained narrowing run
    gives both packages the same carry at every step and compares: the
    prefix and the processed log-probs of every beam whose prefix JAX
    decoded, the whole carry on every batch row where it decoded them all
    (all rows until the width first narrows), and the port's prefix of every
    beam against a walk over all slots in numpy."""
    jm, params, jb, tm, tb = pair
    H = tm.config.num_hierarchies
    j_proc = t_proc = None
    catalog = None
    seen_j, seen_t = [], []
    if constrained:
        catalog, jt, tt = _tries(H)
        j_mask, t_mask = _mask_fns(jt, tt)
        j_chain = j_lp.make_chain(temperature=0.8, constraint_mask_fn=j_mask)
        t_chain = t_lp.make_chain(temperature=0.8, constraint_mask_fn=t_mask)

        def j_proc(step, logp, paths):
            out = j_chain(step, logp, paths)
            seen_j.append((np.asarray(paths), np.asarray(out)))
            return out

        def t_proc(step, logp, paths):
            out = t_chain(step, logp, paths)
            seen_t.append((paths.numpy().copy(), out.numpy().copy()))
            return out

    w0 = schedule[0]
    jc = jm.apply({"params": params}, jb, beam_width=w0, width_pad=width_pad,
                  logits_processor=j_proc, method=JModel.beam_prefill)
    tc = tm.beam_prefill(tb, beam_width=w0, width_pad=width_pad, logits_processor=t_proc)
    _same_carry(jc, tc)
    rows_held = beams_lost = 0
    for h in range(1, H):
        before = {k: v.clone() for k, v in tc.items()}
        if constrained:     # both step from the same carry
            jc = _to_jax_carry(tc)
        jc = jm.apply({"params": params}, jc, h, schedule[h - 1], schedule[h],
                      logits_processor=j_proc, method=JModel.beam_step)
        tc2 = tm.beam_step(tc, h, schedule[h - 1], schedule[h], logits_processor=t_proc)
        for k, v in before.items():     # the input carry is not written
            assert torch.equal(tc[k], v), k
        rows = slice(None)
        if constrained:
            (pj, lj), (pt, lt) = seen_j[-1], seen_t[-1]
            W = schedule[h - 1]
            np.testing.assert_array_equal(pt, _walk_all_slots(
                before["tokens"].numpy(), before["parents"].numpy(), h)[:, :W])
            decoded = (pj >= 0).all(-1)                 # [B, W]
            np.testing.assert_array_equal(pt[decoded], pj[decoded])
            np.testing.assert_allclose(lt[decoded], lj[decoded], **TOL)
            rows = decoded.all(1)
            if W == w0:
                assert rows.all()
            else:
                rows_held += int(rows.sum())
                beams_lost += int((~decoded).sum())
        tc = tc2
        _same_carry(jc, tc, rows)
    if constrained and len(set(schedule)) > 1:
        # the run shows both sides of the difference: beams JAX could not
        # decode, and batch rows held whole after the width narrowed
        assert beams_lost and rows_held
        jc = _to_jax_carry(tc)
    want_p, want_s = jm.apply({"params": params}, jc, schedule[H - 1],
                              method=JModel.beam_finalize)
    got_p, got_s = tm.beam_finalize(tc, schedule[H - 1])
    # beam_finalize of the JAX package walks the first W slots only: where a
    # parent index lies beyond them (after narrowing) its gather fills the
    # token with INT_MIN. The port walks all slots; it must agree everywhere
    # else, and always when the width is fixed
    want_p = np.asarray(want_p)
    in_range = want_p >= 0
    assert in_range.all() or len(set(schedule)) > 1
    np.testing.assert_array_equal(got_p.numpy()[in_range], want_p[in_range])
    np.testing.assert_array_equal(got_p.numpy(), _walk_all_slots(
        tc["tokens"].numpy(), tc["parents"].numpy(), H)[:, :schedule[H - 1]])
    assert (got_p >= 0).all() and (got_p < 32).all()
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)
    if constrained:
        _in_catalog(catalog, got_p, got_s)


def test_parent_beyond_the_width_follows_all_slots(pair):
    """The one place where the port leaves the JAX package on purpose, on a
    hand-made carry: beam 0's parent at the last step is slot 2 of a wider
    step, the final width is 2. JAX's walk over the first 2 slots fills the
    token it cannot reach with INT_MIN; the port returns slot 2's token."""
    jm, params, _, tm, _ = pair
    H = tm.config.num_hierarchies
    tokens = np.zeros((1, H, 3), np.int64)
    parents = np.zeros((1, H, 3), np.int64)
    tokens[0, H - 2] = [5, 6, 7]
    tokens[0, H - 1] = [1, 2, 0]
    parents[0, H - 1] = [2, 0, 0]
    scores = np.array([[-1.0, -2.0, -np.inf]], np.float32)
    carry = dict(scores=scores, tokens=tokens, parents=parents)
    want_p, _ = jm.apply(
        {"params": params},
        {"scores": jnp.asarray(scores), "tokens": jnp.asarray(tokens, jnp.int32),
         "parents": jnp.asarray(parents, jnp.int32)}, 2, method=JModel.beam_finalize)
    got_p, got_s = tm.beam_finalize({k: torch.from_numpy(v) for k, v in carry.items()}, 2)
    want_p = np.asarray(want_p)
    assert want_p[0, 0, H - 2] == np.iinfo(np.int32).min and got_p[0, 0, H - 2] == 7
    assert want_p[0, 1, H - 2] == got_p[0, 1, H - 2] == 5
    np.testing.assert_array_equal(got_p.numpy()[0, :, H - 1], [1, 2])
    np.testing.assert_array_equal(want_p[0, :, H - 1], [1, 2])
    assert got_s.tolist() == [[-1.0, -2.0]]


def test_bf16_forward_close_to_jax():
    """bf16 compute from fp32 params: flax rounds a Dense's product to bf16
    before it adds the bias, torch adds the bias to the fp32 sum, so the two
    differ by bf16 ulps; the loss agrees to 2e-2."""
    kw = dict(BASE)
    jb = j_batch(1, num_hierarchies=3, **BATCH)
    tb = t_batch(1, num_hierarchies=3, **BATCH)
    jm = JModel(JConfig(dtype=jnp.bfloat16, **kw))
    params = f32(jm.init({"params": jax.random.PRNGKey(0)}, jb, train=False)["params"])
    tm = TModel(TConfig(dtype=torch.bfloat16, **kw), device="cpu")
    tm.load_state_dict(convert.dense_state_dict(to_np(params)))
    want, _ = jm.apply({"params": params}, jb, train=False)
    got, _ = tm(tb, train=False)
    np.testing.assert_allclose(got.item(), float(want), rtol=2e-2)
    paths, scores = tm.generate_beam_decode(tb, beam_width=4)
    assert paths.shape == (4, 4, 3) and torch.isfinite(scores).all()


def test_init_weights_follow_flax_rules():
    tm = TModel(TConfig(**BASE), device="cpu").init_weights(torch.Generator().manual_seed(0))
    assert 0.5 < tm.codebook_0.embedding.std().item() * BASE["hidden_size"] ** 0.5 < 1.5
    assert 0.005 < tm.bos_token.std().item() < 0.04
    lin = tm.decoder.layers[0].fc1
    assert not lin.bias.any() and 0.5 < lin.weight.std().item() * lin.in_features ** 0.5 < 1.5
    loss, _ = tm(t_batch(0, num_hierarchies=3, **BATCH), train=False)
    assert torch.isfinite(loss)
