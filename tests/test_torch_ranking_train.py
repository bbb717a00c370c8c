"""HSTU ranking training: the port's RankingGR and GRTrainer against the JAX
package's on bench.py's CPU shape (batch 4, history 64, 2 layers, hidden 64,
2 heads x 32, embeddings 32, head (16, 8)), fp32, with the flax params
carried over by `convert.py`: with five static tables, with bench.py's two
dynamic tables (`item`, `user_id`, capacity 1 << 12, rowwise_adagrad) and
with the relative attention bias. Loss and params agree within rtol 1e-4,
atol 1e-5 (fp32 sums in another order; params where the gradient is above
its noise floor); the dynamic tables' keys, scores and counters bit for bit
and their values within rtol 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from recsys_examples_torch import convert
from recsys_examples_torch.data.hstu_batch import random_hstu_batch as t_batch
from recsys_examples_torch.dynamicemb import batched_table as tbt
from recsys_examples_torch.dynamicemb import dynamicemb_config as tdc
from recsys_examples_torch.dynamicemb import optimizer as tdo
from recsys_examples_torch.dynamicemb.sharded_collection import (
    ShardedDynamicEmbedding as TSharded,
)
from recsys_examples_torch.models.ranking_gr import RankingGR as TRankingGR
from recsys_examples_torch.modules import config as tc
from recsys_examples_torch.training.train_state import make_optimizer as t_opt
from recsys_examples_torch.training.trainer import GRTrainer as TTrainer
from recsys_examples_torch.utils.perf import hstu_flops_exact as t_flops
from recsys_examples_tpu.data.hstu_batch import as_device_batch
from recsys_examples_tpu.data.hstu_batch import random_hstu_batch as j_batch
from recsys_examples_tpu.dynamicemb import batched_table as jbt
from recsys_examples_tpu.dynamicemb import dynamicemb_config as jdc
from recsys_examples_tpu.dynamicemb import optimizer as jdo
from recsys_examples_tpu.dynamicemb.sharded_collection import (
    ShardedDynamicEmbedding as JSharded,
)
from recsys_examples_tpu.models.ranking_gr import RankingGR as JRankingGR
from recsys_examples_tpu.modules import config as jc
from recsys_examples_tpu.training.train_state import make_optimizer as j_opt
from recsys_examples_tpu.training.trainer import GRTrainer as JTrainer
from recsys_examples_tpu.training.trainer import GRTrainState
from recsys_examples_tpu.utils.perf import hstu_flops_exact as j_flops

TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_FLOOR = 1e-4       # fp32 noise floor of a gradient, relative to its leaf's largest
B, HIST, E, TASKS = 4, 64, 32, 8
CTX = {"user_id": 1000, "user_age": 100, "item_category_l1": 50}


DYNAMIC = ("item", "user_id")


def _configs(pkg, dynamic=False, **hstu_kw):
    """(HSTUConfig, RankingConfig) of bench.py's CPU shape in `pkg`; with
    `dynamic` the model keeps static tables for the three small features
    only, as bench.py's."""
    jax_side = pkg is jc
    kw = dict(hidden_size=64, num_layers=2, num_attention_heads=2, kv_channels=32,
              hidden_dropout=0.0,
              position_encoding_config=pkg.PositionEncodingConfig(
                  num_position_buckets=8192),
              item_embedding_dim=E, contextual_embedding_dim=E,
              dtype=jnp.float32 if jax_side else torch.float32, **hstu_kw)
    if jax_side:
        kw["kernel_backend"] = jc.KernelBackend.JNP
    tables = (("item", 1000), ("user_id", 1000), ("action", 100),
              ("user_age", 100), ("item_category_l1", 50))
    if dynamic:
        tables = tuple(t for t in tables if t[0] not in DYNAMIC)
    task = pkg.RankingConfig(
        embedding_configs=tuple(pkg.EmbeddingConfig((n,), n, v, E) for n, v in tables),
        prediction_head_arch=(16, TASKS), num_tasks=TASKS)
    return pkg.HSTUConfig(**kw), task


def _batch(make, seed, **kw):
    return make(seed=seed, batch_size=B, max_history_len=HIST, item_vocab=1000,
                action_vocab=100, contextual_vocabs=CTX, num_tasks=TASKS,
                value_zipf={"item": 1.05, "user_id": 1.05}, **kw)


def _init_both(seed=0, batch_kw=None, **hstu_kw):
    batch_kw = batch_kw or {}
    jmodel = JRankingGR(*_configs(jc, **hstu_kw))
    jb = as_device_batch(_batch(j_batch, seed, **batch_kw))
    key = jax.random.PRNGKey(seed)
    params = nn.unbox(jax.jit(lambda b: jmodel.init(
        {"params": key, "dropout": key}, b, train=False))(jb)["params"])
    tmodel = TRankingGR(*_configs(tc, **hstu_kw))
    tmodel.load_state_dict(convert.dense_state_dict(params))
    return jmodel, params, tmodel


def _sparse_tables(cfg, bt, opt, sharded, **kw):
    """bench.py's two dynamic tables at its CPU size."""
    mk = lambda: sharded(bt.DynamicEmbeddingTable(
        cfg.DynamicEmbTableOptions(embedding_dim=E, max_capacity=1 << 12,
                                   bucket_capacity=128),
        opt.SparseOptimizerArgs(optimizer="rowwise_adagrad", learning_rate=0.01)),
        mesh=None, **kw)
    return {name: mk() for name in DYNAMIC}


def _assert_params_close(tmodel, jparams, held, loose_atol):
    """Params within TOL where `held` (a tree of masks) is set, and within
    `loose_atol` elsewhere."""
    got = convert.flax_params(tmodel.state_dict())
    want = jax.tree_util.tree_map(np.asarray, jparams)
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    flat_h = dict(jax.tree_util.tree_leaves_with_path(held))
    assert flat_g.keys() == flat_w.keys() == flat_h.keys()
    for path, w in flat_w.items():
        g, h, name = flat_g[path], flat_h[path], jax.tree_util.keystr(path)
        np.testing.assert_allclose(g[h], w[h], err_msg=name, **TOL)
        np.testing.assert_allclose(g[~h], w[~h], rtol=0, atol=loose_atol, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1])
def test_ranking_loss_and_logits_match_jax(seed):
    jmodel, params, tmodel = _init_both(seed)
    jb = _batch(j_batch, seed)
    want_loss, want = jax.jit(lambda p, b: jmodel.apply({"params": p}, b, train=False))(
        params, as_device_batch(jb))
    with torch.no_grad():
        got_loss, got = tmodel(_batch(t_batch, seed).to("cpu"), train=False)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), **TOL)
    for key in ("logits", "labels", "valid"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL,
                                   err_msg=key)


def test_ranking_candidates_label_repack_matches_jax():
    """max_num_candidates > 0: logits are candidate-jagged-packed and the
    b-major labels are repacked to match (tests/test_models.py:176)."""
    jmodel, params, tmodel = _init_both(2, dict(max_num_candidates=5))
    jb = _batch(j_batch, 2, max_num_candidates=5)
    tb = _batch(t_batch, 2, max_num_candidates=5).to("cpu")
    assert (np.asarray(jb.num_candidates) < 5).any()   # a padded label slot
    want_loss, want = jax.jit(lambda p, b: jmodel.apply({"params": p}, b, train=False))(
        params, as_device_batch(jb))
    with torch.no_grad():
        got_loss, got = tmodel(tb, train=False)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), **TOL)
    for key in ("logits", "labels", "valid"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL,
                                   err_msg=key)


def test_param_grads_match_jax():
    """Every param's gradient, within atol 1e-5 of that param's largest."""
    jmodel, params, tmodel = _init_both(0)
    jb = _batch(j_batch, 0)
    want = jax.jit(jax.grad(lambda p, b: jmodel.apply({"params": p}, b, train=True)[0]))(
        params, as_device_batch(jb))
    loss, _ = tmodel(_batch(t_batch, 0).to("cpu"), train=True)
    loss.backward()
    got = dict(jax.tree_util.tree_leaves_with_path(convert.flax_params(
        {k: p.grad for k, p in tmodel.named_parameters()})))
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        w = np.asarray(w)
        np.testing.assert_allclose(got[path], w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=jax.tree_util.keystr(path))


def _three_adam_steps(jtr, jstate, jmodel, ttr, tstate, tmodel, lr):
    """Three train steps and an eval step on both sides; returns the states."""
    step = jax.jit(jtr.train_step)
    sparse = bool(jtr.sparse_tables)

    def loss_of(p, b, sp):
        emb = {n: t.forward(sp[n], b.features[n].values, train=False)[1]
               for n, t in jtr.sparse_tables.items()} if sparse else None
        return jmodel.apply({"params": p}, b, train=True, embeddings=emb)[0]

    grad = jax.jit(jax.grad(loss_of))
    held = jax.tree_util.tree_map(lambda p: np.ones(p.shape, bool), jstate.params)
    for s in range(3):
        jb = as_device_batch(_batch(j_batch, s))
        if sparse:      # the embeddings the step itself sees: after phase A
            probe = {n: t.forward(jstate.sparse[n], jb.features[n].values, train=True)[0]
                     for n, t in jtr.sparse_tables.items()}
        else:
            probe = {}
        g = jax.tree_util.tree_map(np.asarray, grad(jstate.params, jb, probe))
        held = jax.tree_util.tree_map(
            lambda h, g: h & ((g == 0) | (np.abs(g) > GRAD_FLOOR * np.abs(g).max())),
            held, g)
        jstate, jm = step(jstate, _batch(j_batch, s), jax.random.PRNGKey(1))
        tstate, tm = ttr.train_step(tstate, _batch(t_batch, s))
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), **TOL,
                                   err_msg=f"step {s}")
        assert int(tm["emb_overflow"]) == int(jm["emb_overflow"]) == 0
    assert tstate.step == 3
    _assert_params_close(tmodel, jstate.params, held, loose_atol=3 * lr)
    want, _ = jax.jit(jtr.eval_step)(jstate, as_device_batch(_batch(j_batch, 3)))
    got, _ = ttr.eval_step(tstate, _batch(t_batch, 3))
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    return jstate, tstate


def test_three_steps_with_dynamic_tables_match_jax_trainer():
    """bench.py's step on the CPU: `item` and `user_id` in dynamic tables
    (phases A and C), the rest static. After three steps the tables' keys,
    scores and counters are equal bit for bit (so every key sits in the same
    slot) and their values and optimizer state within rtol 1e-5 of what the
    gradients allow; nothing overflows; `eval_step` inserts nothing."""
    lr = 1e-3
    jmodel = JRankingGR(*_configs(jc, dynamic=True))
    jtr = JTrainer(jmodel, j_opt(lr, "adam"), _sparse_tables(jdc, jbt, jdo, JSharded))
    jstate = jax.jit(jtr.init)(jax.random.PRNGKey(0), as_device_batch(_batch(j_batch, 0)))
    jstate = jstate.replace(params=nn.unbox(jstate.params))
    jstate = jstate.replace(opt_state=jtr.tx.init(jstate.params))
    tmodel = TRankingGR(*_configs(tc, dynamic=True))
    ttr = TTrainer(tmodel, t_opt(lr, "adam"),
                   _sparse_tables(tdc, tbt, tdo, TSharded, device="cpu"), device="cpu")
    tstate = ttr.init(torch.Generator().manual_seed(0))
    tmodel.load_state_dict(convert.dense_state_dict(jstate.params))
    assert set(tstate.sparse) == set(DYNAMIC)
    assert not any(n.startswith(("embeddings.item.", "embeddings.user_id."))
                   for n in tmodel.state_dict())

    jstate, tstate = _three_adam_steps(jtr, jstate, jmodel, ttr, tstate, tmodel, lr)
    for name in DYNAMIC:
        ts, js = tstate.sparse[name], jstate.sparse[name]
        for f in ("keys", "scores", "inserted", "evicted", "overflowed"):
            np.testing.assert_array_equal(getattr(ts.table, f).numpy(),
                                          np.asarray(getattr(js.table, f)), err_msg=f)
        np.testing.assert_array_equal(ts.step.numpy(), np.asarray(js.step))
        assert int(ts.table.inserted) > 0 and int(ts.table.overflowed) == 0
        np.testing.assert_allclose(ts.table.values.numpy(), np.asarray(js.table.values),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
        np.testing.assert_allclose(ts.table.opt.numpy(), np.asarray(js.table.opt),
                                   rtol=1e-5, atol=1e-12, err_msg=name)
    # eval reads the tables and inserts nothing (checked by _three_adam_steps'
    # eval step having run): the states are as the train steps left them
    before = {n: convert.dynamic_table_to_numpy(s)["table"] for n, s in tstate.sparse.items()}
    ttr.eval_step(tstate, _batch(t_batch, 5))
    for n, s in tstate.sparse.items():
        for f, a in convert.dynamic_table_to_numpy(s)["table"].items():
            np.testing.assert_array_equal(a, before[n][f], err_msg=f"{n} {f}")


def test_three_steps_with_relative_bias_match_jax_trainer():
    """The same three steps with `use_relative_attention_bias`: each layer's
    `relative_bias/rel_bias` trains through rab and drab."""
    lr = 1e-3
    kw = dict(use_relative_attention_bias=True, relative_bias_num_buckets=32,
              relative_bias_max_distance=64)
    jmodel, params, tmodel = _init_both(0, **kw)
    assert "relative_bias" in params["hstu_block"]["layer_1"]
    jtr = JTrainer(jmodel, j_opt(lr, "adam"))
    jstate = GRTrainState(params=params, opt_state=jtr.tx.init(params), sparse={},
                          step=jnp.zeros((), jnp.int32))
    ttr = TTrainer(tmodel, t_opt(lr, "adam"), device="cpu")
    tstate = ttr.init(torch.Generator().manual_seed(0))
    tmodel.load_state_dict(convert.dense_state_dict(params))
    _three_adam_steps(jtr, jstate, jmodel, ttr, tstate, tmodel, lr)


def test_three_adam_steps_match_jax_trainer():
    """Adam at its defaults (eps 1e-8, as bench.py runs it). Where a gradient
    element lies at the fp32 noise floor, the two frameworks' sums in another
    order differ by a large share of it, and Adam's normalised step turns
    that into a param difference of order lr. So params are held to TOL where
    every step's JAX gradient is zero or above GRAD_FLOOR of its leaf's
    largest, and elsewhere to 3 lr, the most three Adam steps move an
    element. Readings at this shape: 387 of 651,736 elements fall below the
    floor (52 below 1e-5), and the one element past TOL (2.1e-5 apart) is
    among them."""
    lr = 1e-3
    jmodel, params, tmodel = _init_both(0)
    jtr = JTrainer(jmodel, j_opt(lr, "adam"))
    jstate = GRTrainState(params=params, opt_state=jtr.tx.init(params), sparse={},
                          step=jnp.zeros((), jnp.int32))
    ttr = TTrainer(tmodel, t_opt(lr, "adam"), device="cpu")
    tstate = ttr.init(torch.Generator().manual_seed(0))
    tmodel.load_state_dict(convert.dense_state_dict(params))
    _three_adam_steps(jtr, jstate, jmodel, ttr, tstate, tmodel, lr)


def test_losses_match_jax():
    from recsys_examples_torch.modules import losses as tl
    from recsys_examples_tpu.modules import losses as jl

    rng = np.random.default_rng(5)
    logits = (3 * rng.standard_normal((40, 6))).astype(np.float32)
    labels = rng.integers(0, 1 << 6, size=40).astype(np.int32)
    valid = rng.random(40) < 0.8
    t = lambda *a: [torch.from_numpy(x) for x in a]
    j = lambda *a: [jnp.asarray(x) for x in a]
    np.testing.assert_array_equal(tl.decode_bits(*t(labels), 6).numpy(),
                                  np.asarray(jl.decode_bits(*j(labels), 6)))
    for got, want in zip(tl.multi_task_bce_loss(*t(logits, labels, valid), 6),
                         jl.multi_task_bce_loss(*j(logits, labels, valid), 6)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    classes = labels % 6
    for got, want in zip(tl.cross_entropy_loss(*t(logits, classes, valid)),
                         jl.cross_entropy_loss(*j(logits, classes, valid))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("optimizer", ["adam", "adamw", "sgd", "adagrad"])
def test_make_optimizer_matches_optax(optimizer):
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((5, 3)).astype(np.float32)
    grads = [rng.standard_normal((5, 3)).astype(np.float32) for _ in range(3)]
    kw = dict(weight_decay=0.1) if optimizer == "adamw" else {}
    tx = j_opt(1e-2, optimizer, **kw)
    jp = jnp.asarray(p0)
    st = tx.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = t_opt(1e-2, optimizer, **kw)([tp])
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=1e-5, atol=1e-6)


def test_hstu_flops_exact_matches_jax():
    rng = np.random.default_rng(0)
    seqlens = 3 + 2 * rng.integers(1, 4096, size=32)
    for ctx, cand, causal in ((3, 0, True), (rng.integers(0, 3, 32), 5, False)):
        args = (seqlens, ctx, cand, 1024, 4, 256, 8)
        assert t_flops(*args, is_causal=causal) == j_flops(*args, is_causal=causal)
