"""The training entries on a mesh: the port's `main`s on gloo ranks against
the JAX package's `main`s on a mesh of virtual CPU devices.

  - `configs/ranking_dryrun_cpu.gin` (dp 2 x tp 2, sequence parallel, the
    balanced shuffler) through the port's `pretrain_gr_ranking.main` at
    W 4, against the JAX entry at dp 2 (its `jax.devices` cut to four, so
    its `make_mesh(dp=-1, tp=2)` is (2, 2) and both sides train on the same
    global batches). One gin file, the dryrun's lines with
    `TrainerArgs.eval_iters` lowered, goes to both. The port starts from the
    JAX run's initial params (each rank its TP shards). Held: the per-step
    losses within rtol 1e-5 (read exactly from both train steps), the final
    dense params within the TP grad limits (rtol 1e-4, atol 1e-6), each data
    shard's table per key (keys and scores bit for bit, value and optimizer
    rows within VAL_TOL) against the JAX shard of that data index, the TP
    replicas' tables equal, and the final eval AUC within 1e-6;
  - the retrieval entry at dp 2 (its in-batch negatives over the global
    batch) against the port's retrieval entry on one device at the global
    batch size (held against the JAX entry in
    tests/test_torch_training_entries.py), held the same way;
  - a ranking checkpoint saved at W 2 (dp 2) loads at W 1 and at W 4
    (dp 2 x tp 2) with the same tables (per key, bit for bit) and dense
    params.
W 2 and W 4 are one spawn each (`mesh.spawn_ranks`); the JAX run is in the
pytest process, with its init's table lookup (shapes for flax's init, no
state change) jitted: eager, its shard_map runs op by op for ~25 s. The ranks
import no JAX."""
import os

import numpy as np
import pytest
import torch

from recsys_examples_torch import convert
from recsys_examples_torch.dynamicemb.dynamicemb_config import EMPTY_KEY
from recsys_examples_torch.models.ranking_gr import RankingGR
from recsys_examples_torch.models.retrieval_gr import RetrievalGR
from recsys_examples_torch.parallel import mesh as pm
from recsys_examples_torch.training import pretrain_gr_ranking as t_rank
from recsys_examples_torch.training import pretrain_gr_retrieval as t_ret
from recsys_examples_torch.training.trainer import GRTrainer
from recsys_examples_torch.utils import gin_config as tgin

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = dict(rtol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
VAL_TOL = dict(rtol=1e-5, atol=1e-7)
EVAL_ITERS = 4


def dryrun_lines():
    lines = open(os.path.join(ROOT, "configs", "ranking_dryrun_cpu.gin")).read().splitlines()
    return [ln for ln in lines if not ln.startswith("TrainerArgs.eval_iters")] + [
        f"TrainerArgs.eval_iters = {EVAL_ITERS}"]


RETRIEVAL = [
    'TrainerArgs.max_train_iters = 3', 'TrainerArgs.log_interval = 1',
    'DatasetArgs.dataset_name = "random"', 'DatasetArgs.batch_size = 2',
    'DatasetArgs.max_history_len = 16', 'DatasetArgs.item_vocab_size = 500',
    'NetworkArgs.hidden_size = 32', 'NetworkArgs.num_layers = 1',
    'NetworkArgs.num_attention_heads = 2', 'NetworkArgs.kv_channels = 16',
    'NetworkArgs.kernel_backend = "jnp"', 'NetworkArgs.dtype = "float32"',
    'NetworkArgs.hidden_dropout = 0.0', 'DynamicEmbeddingArgs.capacity = 1024',
]


def ckpt_lines(ckpt_dir):
    """The dryrun at dp 2 x tp 1, with a checkpoint after its last step."""
    return [ln for ln in dryrun_lines() if "tensor_model_parallel_size" not in ln] + [
        "TensorModelParallelArgs.tensor_model_parallel_size = 1",
        "TrainerArgs.ckpt_save_interval = 2", f'TrainerArgs.ckpt_dir = "{ckpt_dir}"']


def table_contents(state) -> dict:
    """table name -> {key: (score, value row, opt row)} of the live keys."""
    out = {}
    for name, st in state.sparse.items():
        t = st.table
        keys = t.keys.reshape(-1).numpy()
        live = np.flatnonzero(keys != EMPTY_KEY)
        out[name] = dict(keys=keys[live], scores=t.scores.reshape(-1).numpy()[live],
                         values=t.values.numpy()[live],
                         opt=None if t.opt is None else t.opt.numpy()[live],
                         step=int(st.step[0]))
    return out


def _run_main(main, model_cls, gin, params=None):
    """`main` on `gin` (CPU) from `params` (a full state dict, each rank
    loading its TP shards) if given; returns the exact train losses, the
    rank's tables, dense state dict and last eval."""
    losses = []
    step = GRTrainer.train_step

    def recording(self, *a, **k):
        state, m = step(self, *a, **k)
        losses.append(float(m["loss"]))
        return state, m

    GRTrainer.train_step = recording
    init = model_cls.init_weights
    if params is not None:
        full = {k: torch.from_numpy(v) for k, v in np.load(params).items()}

        def load(self, g):
            lay = self.hstu_block.layers[0]
            self.load_state_dict({k: pm.shard_tensor(v, pm.partition_dim(k), lay.tp,
                                                     lay.tp_rank) for k, v in full.items()})
            return self
        model_cls.init_weights = load
    try:
        tgin.clear_config()
        state = main(["--gin-config-file", gin, "--device", "cpu"])
    finally:
        GRTrainer.train_step, model_cls.init_weights = step, init
    last_eval = (t_rank.LAST_EVAL_AUC if main is t_rank.main else t_ret.LAST_EVAL)
    return dict(losses=losses, tables=table_contents(state), step=state.step,
                dense={k: v.numpy().copy() for k, v in state.model.state_dict().items()},
                eval=last_eval)


def _load_checkpoint_at(mesh, gin, path):
    """A fresh ranking state on `mesh` (or one device) loaded from `path`."""
    from recsys_examples_torch.modules.config import RankingConfig
    from recsys_examples_torch.training.checkpoint import load_checkpoint
    from recsys_examples_torch.training.train_state import make_optimizer

    tgin.clear_config()
    tgin.parse_config_file(gin)
    ds, net, opt, demb, rank_args = (tgin.make(n) for n in (
        "DatasetArgs", "NetworkArgs", "OptimizerArgs", "DynamicEmbeddingArgs", "RankingArgs"))
    tp = 1 if mesh is None else mesh.size("model")
    sparse = t_rank.build_sparse_tables(ds, net, demb, "cpu", mesh)
    model = RankingGR(t_rank.build_hstu_config(net, tp, tp > 1), RankingConfig(
        (), prediction_head_arch=tuple(rank_args.prediction_head_arch),
        num_tasks=rank_args.num_tasks), device="cpu", mesh=mesh)
    trainer = GRTrainer(model, make_optimizer(opt.learning_rate), sparse, device="cpu",
                        mesh=mesh)
    state = trainer.init(torch.Generator().manual_seed(5))
    state = load_checkpoint(path, state, {n: t.table for n, t in sparse.items()}, mesh)
    return dict(tables=table_contents(state), step=state.step,
                dense={k: v.numpy().copy() for k, v in state.model.state_dict().items()})


def _worker(rank, world, d):
    res = {}
    if world == 2:
        # params from the entry's seed: the same at any data-parallel size
        res["retrieval"] = _run_main(t_ret.main, RetrievalGR, os.path.join(d, "retrieval.gin"))
        res["saved"] = _run_main(t_rank.main, RankingGR, os.path.join(d, "ckpt.gin"))
    else:
        res["dryrun"] = _run_main(t_rank.main, RankingGR, os.path.join(d, "dryrun.gin"),
                                  os.path.join(d, "dryrun_params.npz"))
        res["loaded"] = _load_checkpoint_at(pm.make_mesh(2, 2, "cpu"),
                                            os.path.join(d, "ckpt.gin"),
                                            os.path.join(d, "ckpt", "iter_0000002"))
    torch.save(res, os.path.join(d, f"w{world}_rank{rank}.pt"))


def _jit_init_lookup(monkeypatch):
    import jax

    from recsys_examples_tpu.training import trainer as j_trainer

    def dryrun(self, sparse, batch):
        return {name: jax.jit(tbl.forward, static_argnames="train")(
            sparse[name], batch.features[name].values, train=False)[1]
            for name, tbl in self.sparse_tables.items()} or None

    monkeypatch.setattr(j_trainer.GRTrainer, "_sparse_fwd_dryrun", dryrun)


def _jax_main(entry, gin, n_devices, monkeypatch, params_out):
    """The JAX entry on `n_devices` virtual devices: its initial params
    (saved as the port's state dict), exact per-step losses, final state and
    last eval."""
    import jax
    from flax import linen as nn

    from recsys_examples_tpu.training import trainer as j_trainer
    from recsys_examples_tpu.utils import gin_config as jgin

    real = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a: real(*a)[:n_devices])
    init = j_trainer.GRTrainer.init

    def capture(self, rng, batch):
        state = init(self, rng, batch)
        sd = convert.dense_state_dict(jax.tree_util.tree_map(np.asarray, nn.unbox(state.params)))
        np.savez(params_out, **{k: v.numpy() for k, v in sd.items()})
        return state

    monkeypatch.setattr(j_trainer.GRTrainer, "init", capture)
    _jit_init_lookup(monkeypatch)
    losses = []

    class Jax:
        """`jax` for the entry module, whose jitted train step's losses are
        kept (the log prints five decimals)."""

        def __getattr__(self, name):
            return getattr(jax, name)

        @staticmethod
        def jit(fn, **kw):
            jitted = jax.jit(fn, **kw)

            def call(*a, **k):
                out = jitted(*a, **k)
                if isinstance(out[1], dict) and "emb_overflow" in out[1]:
                    losses.append(float(out[1]["loss"]))
                return out
            return call

    monkeypatch.setattr(entry, "jax", Jax())
    jgin.clear_config()
    state = entry.main(["--gin-config-file", gin])
    return dict(losses=losses, state=state)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from recsys_examples_tpu.training import pretrain_gr_ranking as j_rank

    d = tmp_path_factory.mktemp("entries")
    (d / "dryrun.gin").write_text("\n".join(dryrun_lines()) + "\n")
    (d / "retrieval.gin").write_text("\n".join(RETRIEVAL) + "\n")
    (d / "retrieval_global.gin").write_text("\n".join(
        RETRIEVAL + ["DatasetArgs.batch_size = 4"]) + "\n")
    (d / "ckpt.gin").write_text("\n".join(ckpt_lines(d / "ckpt")) + "\n")
    # the W 2 ranks need nothing of JAX's: they run beside the JAX entry
    w2 = pm.spawn_ranks(_worker, 2, str(d), str(d), join=False)
    with pytest.MonkeyPatch.context() as mp:
        jx = _jax_main(j_rank, str(d / "dryrun.gin"), 4, mp, str(d / "dryrun_params.npz"))
    jx["eval"] = j_rank.LAST_EVAL_AUC
    while not w2.join():
        pass
    pm.spawn_ranks(_worker, 4, str(d), str(d))
    port = {W: [torch.load(d / f"w{W}_rank{r}.pt", weights_only=False) for r in range(W)]
            for W in (2, 4)}
    port[1] = _load_checkpoint_at(None, str(d / "ckpt.gin"), str(d / "ckpt" / "iter_0000002"))
    port["retrieval_global"] = _run_main(t_ret.main, RetrievalGR,
                                         str(d / "retrieval_global.gin"))
    return jx, port


def _jax_shard(jstate, name, dp, i):
    """{key: (score, value, opt)} of data shard i of a JAX table state."""
    t = jstate.sparse[name].table
    split = lambda a: None if a is None else np.split(np.asarray(a), dp)[i]
    keys = split(t.keys).reshape(-1)
    live = np.flatnonzero(keys != EMPTY_KEY)
    return dict(keys=keys[live], scores=split(t.scores).reshape(-1)[live],
                values=split(t.values)[live], opt=None if t.opt is None else split(t.opt)[live],
                step=int(split(jstate.sparse[name].step)[0]))


def _by_key(c):
    order = np.argsort(c["keys"])
    return {f: (None if c[f] is None else c[f][order]) for f in ("keys", "scores", "values", "opt")}


def _assert_tables_equal(got, want, exact=False):
    g, w = _by_key(got), _by_key(want)
    np.testing.assert_array_equal(g["keys"], w["keys"])
    np.testing.assert_array_equal(g["scores"], w["scores"])
    assert got["step"] == want["step"]
    for f in ("values", "opt"):
        if w[f] is None:
            assert g[f] is None
        elif exact:
            np.testing.assert_array_equal(g[f], w[f], err_msg=f)
        else:
            np.testing.assert_allclose(g[f], w[f], **VAL_TOL, err_msg=f)


def _assert_entry(jrun, ranks, dp, tp):
    import jax
    from flax import linen as nn

    want = jrun["losses"]
    assert len(want) == len(ranks[0]["losses"]) > 0
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want, **LOSS_TOL)
    jstate = jrun["state"]
    for name in jstate.sparse:
        for i in range(dp):
            replicas = ranks[i * tp:(i + 1) * tp]
            for r in replicas[1:]:          # the TP replicas of a data shard agree
                _assert_tables_equal(r["tables"][name], replicas[0]["tables"][name], exact=True)
            _assert_tables_equal(replicas[0]["tables"][name], _jax_shard(jstate, name, dp, i))
        assert sum(len(r["tables"][name]["keys"]) for r in ranks[::tp]) > 0
    got = convert.merge_tp_state_dicts(
        [{k: torch.from_numpy(v) for k, v in r["dense"].items()} for r in ranks[:tp]])
    want = convert.dense_state_dict(jax.tree_util.tree_map(np.asarray, nn.unbox(jstate.params)))
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), **PARAM_TOL, err_msg=k)


def test_ranking_dryrun_at_w4_matches_jax_at_dp2(runs):
    jx, port = runs
    _assert_entry(jx, [r["dryrun"] for r in port[4]], dp=2, tp=2)
    for r in port[4]:
        np.testing.assert_allclose(r["dryrun"]["eval"], jx["eval"], rtol=0, atol=1e-6)


def test_retrieval_at_dp2_matches_one_device_at_the_global_batch(runs):
    _, port = runs
    ranks, one = [r["retrieval"] for r in port[2]], port["retrieval_global"]
    assert len(one["losses"]) == 3
    for r in ranks:
        np.testing.assert_allclose(r["losses"], one["losses"], **LOSS_TOL)
        assert r["eval"].keys() == {"HR@10", "NDCG@10", "MRR"}
    for name, table in one["tables"].items():
        _assert_tables_equal(_union([r["tables"][name] for r in ranks]), table)
    for k, v in one["dense"].items():
        np.testing.assert_allclose(ranks[0]["dense"][k], v, **PARAM_TOL, err_msg=k)


def _union(contents):
    return {f: (None if contents[0][f] is None else np.concatenate([c[f] for c in contents]))
            if f != "step" else contents[0]["step"] for f in contents[0]}


@pytest.mark.parametrize("W", [1, 4])
def test_checkpoint_saved_at_w2_loads_at(runs, W):
    _, port = runs
    saved = [r["saved"] for r in port[2]]
    loaded = [port[1]] if W == 1 else [r["loaded"] for r in port[4]]
    stride = 1 if W == 1 else 2          # one rank per data shard
    for name in saved[0]["tables"]:
        _assert_tables_equal(_union([r["tables"][name] for r in loaded[::stride]]),
                             _union([r["tables"][name] for r in saved]), exact=True)
    want = saved[0]["dense"]
    got = convert.merge_tp_state_dicts(
        [{k: torch.from_numpy(v) for k, v in r["dense"].items()} for r in loaded[:stride]])
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert all(r["step"] == saved[0]["step"] == 2 for r in loaded)
