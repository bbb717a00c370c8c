"""Tensor and sequence parallelism: the port's `RankingGR` and `HSTULayer` on
gloo ranks against the JAX package's, within the JAX package's own TP limits
(tests/test_tensor_parallel.py: loss rtol 1e-5, grads rtol 1e-4 and atol
1e-6).

  - `RankingGR` (tests/test_tensor_parallel.py's config: 2 layers, 2 heads,
    a static item table) at TP 2 and at dp 2 x tp 2, with and without the
    relative attention bias: one `GRTrainer.train_step` from the JAX init's
    params (carried over by `convert.tp_state_dict`) gives the global loss
    and the dense grads (summed over "data", the TP ranks' shards merged),
    held against JAX on one device and, without the bias, JAX on a (data 2,
    model 2) mesh;
  - the control: the output LayerNorm normalising each rank's slice alone
    must miss those limits;
  - the sequence-parallel layer on tests/test_sequence_parallel.py's
    inputs: outputs within that test's limits (rtol 2e-4, atol 2e-5), the
    input's and params' grads within the TP limits;
  - a (dcn 2, data 2, model 1) mesh: two train steps with the dynamic table
    row-sharded over ("dcn", "data") give the port's one-device losses and
    params.
W 2 and W 4 are one spawn each (`mesh.spawn_ranks`); JAX runs in the pytest
process, and its params reach the ranks as .npz files."""
import os

import numpy as np
import pytest
import torch

from recsys_examples_torch import convert
from recsys_examples_torch.data.hstu_batch import random_hstu_batch
from recsys_examples_torch.dynamicemb.batched_table import DynamicEmbeddingTable
from recsys_examples_torch.dynamicemb.dynamicemb_config import DynamicEmbTableOptions
from recsys_examples_torch.dynamicemb.optimizer import SparseOptimizerArgs
from recsys_examples_torch.dynamicemb.sharded_collection import ShardedDynamicEmbedding
from recsys_examples_torch.jagged.jagged_tensor import JaggedData
from recsys_examples_torch.models.ranking_gr import RankingGR
from recsys_examples_torch.modules.config import (
    EmbeddingConfig,
    HSTUConfig,
    PositionEncodingConfig,
    RankingConfig,
)
from recsys_examples_torch.modules.hstu_layer import HSTULayer
from recsys_examples_torch.parallel import collective_ops as co
from recsys_examples_torch.parallel import mesh as pm
from recsys_examples_torch.training.pretrain_gr_ranking import shard_hstu_batch
from recsys_examples_torch.training.train_state import make_optimizer
from recsys_examples_torch.training.trainer import GRTrainer

LOSS_TOL = dict(rtol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
SP_OUT_TOL = dict(rtol=2e-4, atol=2e-5)


def port_cfg(tp=2, rab=False, **kw):
    return HSTUConfig(hidden_size=32, num_layers=2, num_attention_heads=2, kv_channels=16,
                      hidden_dropout=0.0, dtype=torch.float32, tensor_model_parallel_size=tp,
                      use_relative_attention_bias=rab, **kw)


TASK = RankingConfig((EmbeddingConfig(("item",), "item_table", 1000, 32),),
                     prediction_head_arch=(16, 1))


def batch():
    return random_hstu_batch(seed=0, batch_size=8, max_history_len=16, item_vocab=1000,
                             max_num_candidates=4, num_tasks=1)


def layer_inputs(T=256, D=64):
    """tests/test_sequence_parallel.py's `_layer_inputs`."""
    rng = np.random.default_rng(0)
    lens = np.array([100, 60, 96], np.int32)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    vals = rng.standard_normal((T, D)).astype(np.float32) * 0.1
    vals[offs[-1]:] = 0
    return vals, offs, lens


def sp_cfg(tp):
    return HSTUConfig(hidden_size=64, num_layers=1, num_attention_heads=2, kv_channels=32,
                      hidden_dropout=0.0, dtype=torch.float32, tensor_model_parallel_size=tp,
                      sequence_parallel=tp > 1)


def _load(path):
    return {k: torch.from_numpy(v) for k, v in np.load(path).items()}


def _ranking_step(mesh, d, rab, control=False):
    """One train step (SGD at lr 0) on this data rank's block, from the TP
    shard of the JAX params that `convert.tp_state_dict` cut for this
    rank: the global loss and this rank's reduced grads."""
    tp, r = mesh.size("model"), mesh.index("model")
    dp, i = mesh.size("data"), mesh.index("data")
    model = RankingGR(port_cfg(tp, rab), TASK, device="cpu", mesh=mesh)
    trainer = GRTrainer(model, make_optimizer(0.0, "sgd"), device="cpu", mesh=mesh)
    state = trainer.init(torch.Generator().manual_seed(0))
    model.load_state_dict(_load(os.path.join(d, f"params_rab{int(rab)}_tp{r}.npz")))
    if control:
        for layer in model.hstu_block.layers:
            ln = layer.output_layernorm
            ln.group, ln.full_dim = None, ln.full_dim // tp
    state, m = trainer.train_step(state, shard_hstu_batch(batch(), dp, i))
    return dict(loss=float(m["loss"]),
                grads={n: p.grad.numpy().copy() for n, p in model.named_parameters()})


def _sp_layer(mesh, sd):
    """The SP layer on this rank's token block; outputs and grads of
    mean(out * w) gathered back to the full T."""
    tp, g = mesh.size("model"), mesh.group("model")
    layer = HSTULayer(sp_cfg(tp), "cpu", mesh)
    layer.load_state_dict({k: pm.shard_tensor(v, pm.partition_dim("layers.0." + k), tp,
                                              mesh.index("model")) for k, v in sd.items()})
    vals, offs, lens = layer_inputs()
    x = torch.from_numpy(vals).requires_grad_()
    jd = JaggedData(values=co.split_along_first_dim(x, g), seqlen=torch.from_numpy(lens).long(),
                    seqlen_offsets=torch.from_numpy(offs).long(), max_seqlen=128)
    out = co.gather_along_first_dim(layer(jd, train=False).values, g, replicated_output=True)
    w = torch.from_numpy(np.random.default_rng(1).standard_normal(out.shape).astype(np.float32))
    (out * w).mean().backward()
    grads = {n: p.grad.clone() for n, p in layer.named_parameters()}
    for n in pm.SP_REPLICATED:
        torch.distributed.all_reduce(grads[n], group=g)
    return dict(out=out.detach().numpy(), gx=x.grad.numpy(),
                grads={n: v.numpy() for n, v in grads.items()})


def multislice_cfg():
    return HSTUConfig(hidden_size=32, num_layers=1, num_attention_heads=2, kv_channels=16,
                      hidden_dropout=0.0, dtype=torch.float32,
                      position_encoding_config=PositionEncodingConfig(num_position_buckets=64))


def multislice_run(mesh, device="cpu"):
    """Two train steps with a dynamic item table on `mesh` (or one device)."""
    dp, d = (1, 0) if mesh is None else (mesh.size(mesh.data_axis), mesh.index(mesh.data_axis))
    table = DynamicEmbeddingTable(
        DynamicEmbTableOptions(embedding_dim=32, max_capacity=4096, bucket_capacity=64),
        SparseOptimizerArgs(optimizer="rowwise_adagrad", learning_rate=0.01), world_size=dp)
    sparse = {"item": ShardedDynamicEmbedding(table, mesh, device=device)}
    task = RankingConfig((), prediction_head_arch=(8, 1), num_tasks=1)
    trainer = GRTrainer(RankingGR(multislice_cfg(), task, device=device, mesh=mesh),
                        make_optimizer(1e-3), sparse, device=device, mesh=mesh)
    state = trainer.init(torch.Generator().manual_seed(3))
    b = random_hstu_batch(seed=0, batch_size=8, max_history_len=32, item_vocab=100_000,
                          max_num_candidates=4, num_tasks=1)
    losses = []
    for _ in range(2):
        state, m = trainer.train_step(state, shard_hstu_batch(b, dp, d))
        losses.append(float(m["loss"]))
    return dict(losses=losses, params={n: p.detach().numpy().copy()
                                       for n, p in state.model.named_parameters()})


def _worker(rank, world, d):
    res = {}
    if world == 2:
        mesh = pm.make_mesh(1, 2, "cpu")
        res["tp"] = _ranking_step(mesh, d, False)
        res["tp_rab"] = _ranking_step(mesh, d, True)
        res["control"] = _ranking_step(mesh, d, False, control=True)
        res["sp"] = _sp_layer(mesh, _load(os.path.join(d, "sp_layer.npz")))
    else:
        mesh = pm.make_mesh(2, 2, "cpu")
        res["dp_tp"] = _ranking_step(mesh, d, False)
        res["dp_tp_rab"] = _ranking_step(mesh, d, True)
        res["multislice"] = multislice_run(pm.make_multislice_mesh(2, 2, 1, "cpu"))
    torch.save(res, os.path.join(d, f"rank{rank}.pt"))


def _jax_refs(d):
    """Params (saved for the ranks) and loss/grads on one device and on a
    (data 2, model 2) mesh, with and without the bias; the SP layer's."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn

    from recsys_examples_tpu.data.hstu_batch import random_hstu_batch as j_batch
    from recsys_examples_tpu.jagged.jagged_tensor import JaggedData as JJagged
    from recsys_examples_tpu.models.ranking_gr import RankingGR as JRanking
    from recsys_examples_tpu.modules.config import (
        EmbeddingConfig as JEmb, HSTUConfig as JCfg, KernelBackend, RankingConfig as JTask)
    from recsys_examples_tpu.modules.hstu_layer import HSTULayer as JLayer
    from recsys_examples_tpu.parallel.mesh import make_mesh, shard_params

    b = j_batch(seed=0, batch_size=8, max_history_len=16, item_vocab=1000,
                max_num_candidates=4, num_tasks=1)
    task = JTask(embedding_configs=(JEmb(("item",), "item_table", 1000, 32),),
                 prediction_head_arch=(16, 1))
    mesh = make_mesh(dp=2, tp=2, devices=jax.devices()[:4])
    refs = {}
    for rab in (False, True):
        cfg = JCfg(hidden_size=32, num_layers=2, num_attention_heads=2, kv_channels=16,
                   hidden_dropout=0.0, kernel_backend=KernelBackend.JNP, dtype=jnp.float32,
                   tensor_model_parallel_size=2, use_relative_attention_bias=rab)
        model = JRanking(cfg, task)
        key = jax.random.PRNGKey(0)
        params = model.init({"params": key, "dropout": key}, b, train=False)["params"]
        tree = jax.tree_util.tree_map(np.asarray, nn.unbox(params))
        for r in range(2):
            np.savez(os.path.join(d, f"params_rab{int(rab)}_tp{r}.npz"),
                     **{k: v.numpy() for k, v in convert.tp_state_dict(tree, 2, r).items()})
        vg = jax.value_and_grad(lambda p: model.apply({"params": p}, b, train=False)[0])
        runs = {"single": jax.jit(vg)(params)}
        if not rab:     # (tests/test_tensor_parallel.py holds the mesh to one device)
            sharded = shard_params(mesh, params)
            with jax.set_mesh(mesh):     # as tests/test_tensor_parallel.py runs it
                runs["mesh"] = jax.jit(vg)(sharded)
        for name, (loss, grads) in runs.items():
            refs[(rab, name)] = (float(loss), {k: v.numpy() for k, v in convert.dense_state_dict(
                jax.tree_util.tree_map(np.asarray, nn.unbox(jax.device_get(grads)))).items()})
    # the SP layer (tests/test_sequence_parallel.py's config)
    cfg = JCfg(hidden_size=64, num_layers=1, num_attention_heads=2, kv_channels=32,
               hidden_dropout=0.0, kernel_backend=KernelBackend.JNP, dtype=jnp.float32)
    layer = JLayer(cfg)
    vals, offs, lens = layer_inputs()
    jd = JJagged(values=jnp.asarray(vals), seqlen=jnp.asarray(lens),
                 seqlen_offsets=jnp.asarray(offs), max_seqlen=128)
    params = layer.init(jax.random.PRNGKey(0), jd, False)["params"]
    sd = convert.dense_state_dict(jax.tree_util.tree_map(np.asarray, nn.unbox(params)))
    np.savez(os.path.join(d, "sp_layer.npz"), **{k: v.numpy() for k, v in sd.items()})
    w = jnp.asarray(np.random.default_rng(1).standard_normal(vals.shape).astype(np.float32))

    def f(p, x):
        out = layer.apply({"params": p}, jd.replace(values=x), False).values
        return (out * w).mean(), out

    (_, out), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(vals))
    refs["sp"] = dict(out=np.asarray(out), gx=np.asarray(gx), grads={
        k: v.numpy() for k, v in convert.dense_state_dict(
            jax.tree_util.tree_map(np.asarray, nn.unbox(gp))).items()})
    return refs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tensor_parallel")
    refs = _jax_refs(str(d))
    port = {}
    for W in (2, 4):
        pm.spawn_ranks(_worker, W, str(d), str(d))
        port[W] = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(W)]
    return refs, port


def _merged_grads(ranks, tp):
    """The TP ranks' grad shards (ranks of data index 0) merged."""
    return convert.merge_tp_state_dicts(
        [{k: torch.from_numpy(v) for k, v in r["grads"].items()} for r in ranks[:tp]])


def _assert_ranking(refs, ranks, rab, tp=2):
    loss = {r["loss"] for r in ranks}
    assert len(loss) == 1, loss                     # every rank logs the global loss
    got = _merged_grads(ranks, tp)
    for ref in ("single", "mesh") if (rab, "mesh") in refs else ("single",):
        want_loss, want = refs[(rab, ref)]
        np.testing.assert_allclose(ranks[0]["loss"], want_loss, **LOSS_TOL)
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v, **GRAD_TOL, err_msg=f"{ref} {k}")
    # the data ranks hold the same reduced grads
    for i in range(tp, len(ranks)):
        for k, v in ranks[i]["grads"].items():
            np.testing.assert_array_equal(v, ranks[i % tp]["grads"][k], err_msg=k)


@pytest.mark.parametrize("rab", [False, True], ids=["plain", "rab"])
@pytest.mark.parametrize("W", [2, 4], ids=["tp2", "dp2xtp2"])
def test_ranking_gr_matches_jax(runs, W, rab):
    refs, port = runs
    key = {(2, False): "tp", (2, True): "tp_rab", (4, False): "dp_tp", (4, True): "dp_tp_rab"}
    _assert_ranking(refs, [r[key[(W, rab)]] for r in port[W]], rab)


def test_per_rank_output_layernorm_fails_the_limits(runs):
    """Normalising each rank's H*dh/TP slice alone is a wrong answer that
    the limits above catch."""
    refs, port = runs
    ranks = [r["control"] for r in port[2]]
    want_loss, want = refs[(False, "single")]
    got = _merged_grads(ranks, 2)
    loss_ok = np.isclose(ranks[0]["loss"], want_loss, **LOSS_TOL)
    grads_ok = all(np.allclose(got[k].numpy(), v, **GRAD_TOL) for k, v in want.items())
    assert not (loss_ok and grads_ok)
    assert not grads_ok


def test_sequence_parallel_layer_matches_jax(runs):
    refs, port = runs
    want = refs["sp"]
    for r, res in enumerate(port[2]):
        got = res["sp"]
        np.testing.assert_allclose(got["out"], want["out"], **SP_OUT_TOL)
        np.testing.assert_allclose(got["gx"], want["gx"], **GRAD_TOL)
        for k, v in want["grads"].items():
            d = pm.partition_dim("layers.0." + k)
            np.testing.assert_allclose(
                got["grads"][k], pm.shard_tensor(torch.from_numpy(v), d, 2, r).numpy(),
                **GRAD_TOL, err_msg=k)


def test_multislice_mesh_steps_match_one_device(runs):
    _, port = runs
    want = multislice_run(None)
    for res in port[4]:
        got = res["multislice"]
        np.testing.assert_allclose(got["losses"], want["losses"], **LOSS_TOL)
        assert got["losses"][1] < got["losses"][0]
        for k, v in want["params"].items():
            np.testing.assert_allclose(got["params"][k], v, **GRAD_TOL, err_msg=k)
