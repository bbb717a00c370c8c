"""The port's gin-driven training entries against the JAX package's, on
`tests/test_training_entries.py`'s tiny gin files (dropout 0, fp32) and,
for the ranking entry, on a tiny MovieLens file the test writes: both
`main`s run on one device (the JAX package's `jax.devices` is cut to the
first of the test mesh's eight), the port from the JAX package's initial
params, carried over by `convert.py`. Held: per-step losses from the `iter i: loss=` lines within
1e-5 (they print 5 decimals), final dense params within rtol 1e-4 and
atol 1e-6, the dynamic tables' keys, scores and counters bit for bit and
their values and optimizer rows within rtol 1e-5 and atol 1e-7, eval AUC
and HR / NDCG / MRR within 1e-6. Then `recompute_layer` with dropout: its
losses, gradients and params equal the unrecomputed run's bit for bit."""
import logging
import re

import jax
import numpy as np
import pytest
import torch
from flax import linen as nn

from recsys_examples_torch import convert
from recsys_examples_torch.data.hstu_batch import random_hstu_batch
from recsys_examples_torch.models.ranking_gr import RankingGR as TRanking
from recsys_examples_torch.models.retrieval_gr import RetrievalGR as TRetrieval
from recsys_examples_torch.modules.config import (
    EmbeddingConfig, HSTUConfig, PositionEncodingConfig, RankingConfig)
from recsys_examples_torch.training import pretrain_gr_ranking as t_rank
from recsys_examples_torch.training import pretrain_gr_retrieval as t_ret
from recsys_examples_torch.training.train_state import make_optimizer
from recsys_examples_torch.training.trainer import GRTrainer
from recsys_examples_torch.utils import gin_config as tgin
from recsys_examples_tpu.training import pretrain_gr_ranking as j_rank
from recsys_examples_tpu.training import pretrain_gr_retrieval as j_ret
from recsys_examples_tpu.training import trainer as j_trainer
from recsys_examples_tpu.utils import gin_config as jgin

PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
VALUE_TOL = dict(rtol=1e-5, atol=1e-7)

TINY = [
    'TrainerArgs.max_train_iters = 3',
    'TrainerArgs.log_interval = 1',
    'DatasetArgs.dataset_name = "random"',
    'DatasetArgs.batch_size = 2',
    'DatasetArgs.max_history_len = 16',
    'NetworkArgs.hidden_size = 32',
    'NetworkArgs.num_layers = 1',
    'NetworkArgs.num_attention_heads = 2',
    'NetworkArgs.kv_channels = 16',
    'NetworkArgs.kernel_backend = "jnp"',
    'NetworkArgs.dtype = "float32"',
    'NetworkArgs.hidden_dropout = 0.0',
    'DynamicEmbeddingArgs.capacity = 1024',
]
RANKING = TINY + [
    'DatasetArgs.max_num_candidates = 2',
    'DatasetArgs.item_vocab_size = 1000',
    'RankingArgs.prediction_head_arch = [8, 1]',
]
RETRIEVAL = TINY + ['DatasetArgs.item_vocab_size = 500']


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def losses(self):
        return [float(x) for line in self.lines
                for x in re.findall(r"^iter \d+: loss=(\S+)", line)]


@pytest.fixture
def lines(monkeypatch):
    """Log handlers on both packages' loggers."""
    out = {}
    for pkg in ("recsys_examples_tpu", "recsys_examples_torch"):
        h = out[pkg] = _Lines()
        logger = logging.getLogger(pkg)
        logger.addHandler(h)
    yield out
    for pkg, h in out.items():
        logging.getLogger(pkg).removeHandler(h)


def _run_both(tmp_path, monkeypatch, gin_lines, j_entry, t_entry, t_model):
    """JAX main, then the port's main from the JAX run's initial params;
    returns (jax state, port state)."""
    cfg = tmp_path / "entry.gin"
    cfg.write_text("\n".join(gin_lines))
    real = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a: real(*a)[:1])
    init, captured = j_trainer.GRTrainer.init, {}

    def capture(self, rng, batch):
        state = init(self, rng, batch)
        captured["params"] = jax.tree_util.tree_map(np.asarray, nn.unbox(state.params))
        return state

    monkeypatch.setattr(j_trainer.GRTrainer, "init", capture)
    jgin.clear_config()
    jstate = j_entry.main(["--gin-config-file", str(cfg)])
    sd = convert.dense_state_dict(captured["params"])
    monkeypatch.setattr(t_model, "init_weights",
                        lambda self, g: (self.load_state_dict(sd), self)[1])
    tgin.clear_config()
    tstate = t_entry.main(["--gin-config-file", str(cfg), "--device", "cpu"])
    return jstate, tstate


def _assert_states_close(jstate, tstate):
    assert tstate.step == int(jstate.step)
    got = dict(jax.tree_util.tree_leaves_with_path(convert.flax_params(
        tstate.model.state_dict())))
    want = jax.tree_util.tree_leaves_with_path(nn.unbox(jstate.params))
    assert len(got) == len(want)
    for path, w in want:
        np.testing.assert_allclose(got[path], np.asarray(w), **PARAM_TOL,
                                   err_msg=jax.tree_util.keystr(path))
    assert tstate.sparse.keys() == jstate.sparse.keys() and tstate.sparse
    for name, js in jstate.sparse.items():
        tt, jt = tstate.sparse[name].table, js.table
        for f in ("keys", "scores", "inserted", "evicted", "overflowed"):
            np.testing.assert_array_equal(getattr(tt, f).numpy(), np.asarray(getattr(jt, f)),
                                          err_msg=f"{name} {f}")
        assert int(tt.inserted[0]) > 0
        np.testing.assert_array_equal(tstate.sparse[name].step.numpy(), np.asarray(js.step))
        np.testing.assert_allclose(tt.values.numpy(), np.asarray(jt.values), **VALUE_TOL)
        np.testing.assert_allclose(tt.opt.numpy(), np.asarray(jt.opt), **VALUE_TOL)


def _assert_losses(lines, n):
    want = lines["recsys_examples_tpu"].losses()
    got = lines["recsys_examples_torch"].losses()
    assert len(got) == len(want) == n and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_ranking_main_matches_jax(tmp_path, monkeypatch, lines):
    n_eval = len(j_rank.EVAL_AUC_HISTORY), len(t_rank.EVAL_AUC_HISTORY)
    jstate, tstate = _run_both(tmp_path, monkeypatch, RANKING, j_rank, t_rank, TRanking)
    _assert_losses(lines, 3)
    _assert_states_close(jstate, tstate)
    assert (len(j_rank.EVAL_AUC_HISTORY), len(t_rank.EVAL_AUC_HISTORY)) == \
        (n_eval[0] + 1, n_eval[1] + 1)
    np.testing.assert_allclose(t_rank.LAST_EVAL_AUC, j_rank.LAST_EVAL_AUC, rtol=0, atol=1e-6)
    assert any(line.startswith("eval (8 batches) AUC") for line in
               lines["recsys_examples_torch"].lines)


def test_retrieval_main_matches_jax(tmp_path, monkeypatch, lines):
    jstate, tstate = _run_both(tmp_path, monkeypatch, RETRIEVAL, j_ret, t_ret, TRetrieval)
    _assert_losses(lines, 3)
    _assert_states_close(jstate, tstate)
    assert list(t_ret.LAST_EVAL) == list(j_ret.LAST_EVAL) == ["HR@10", "NDCG@10", "MRR"]
    for k, v in j_ret.LAST_EVAL.items():
        np.testing.assert_allclose(t_ret.LAST_EVAL[k], v, rtol=0, atol=1e-6, err_msg=k)
        assert 0.0 <= t_ret.LAST_EVAL[k] <= 1.0


@pytest.fixture
def movielens_npz(tmp_path):
    """A tiny ratings.dat in MovieLens-1M's format, preprocessed by the port."""
    from recsys_examples_torch.data.sequence_dataset import preprocess_movielens

    rng = np.random.default_rng(0)
    rows = [(u, int(rng.integers(1, 200)), int(rng.integers(1, 6)), int(t))
            for u in range(1, 25) for t in np.sort(rng.integers(0, 10 ** 6, rng.integers(6, 30)))]
    dat = tmp_path / "ratings.dat"
    dat.write_text("".join(f"{u}::{m}::{r}::{t}\n" for u, m, r, t in rows))
    out = tmp_path / "ml.npz"
    preprocess_movielens(str(dat), str(out))
    return str(out)


def test_ranking_main_on_a_movielens_file_matches_jax(tmp_path, monkeypatch, lines,
                                                      movielens_npz):
    """The file-backed path with actions (item/action interleave, an action
    table), a checkpoint and an eval in the loop, and eval on the holdout.
    The retrieval entry shares this path's train stream; its holdout stream
    is held in tests/test_torch_sequence_dataset.py."""
    gin = [line for line in RANKING if not line.startswith((
        "DatasetArgs.dataset_name", "DatasetArgs.batch_size", "DatasetArgs.max_num_candidates"))]
    gin += ['DatasetArgs.dataset_name = "movielens-1m"',
            f'DatasetArgs.dataset_path = "{movielens_npz}"',
            'DatasetArgs.batch_size = 4', 'DatasetArgs.action_vocab_size = 6',
            'DatasetArgs.max_num_candidates = 3', 'DatasetArgs.eval_max_num_candidates = 1',
            'TrainerArgs.eval_interval = 2', 'TrainerArgs.eval_iters = 2',
            'TrainerArgs.ckpt_save_interval = 2', f'TrainerArgs.ckpt_dir = "{tmp_path / "ckpt"}"']
    jstate, tstate = _run_both(tmp_path, monkeypatch, gin, j_rank, t_rank, TRanking)
    _assert_losses(lines, 3)
    _assert_states_close(jstate, tstate)
    assert set(tstate.sparse) == {"item", "action"}
    assert len(t_rank.EVAL_AUC_HISTORY) >= 2
    for got, want in zip(t_rank.EVAL_AUC_HISTORY[-2:], j_rank.EVAL_AUC_HISTORY[-2:]):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (tmp_path / "ckpt" / "iter_0000002" / "dense.pt").exists()
    assert (tmp_path / "ckpt" / "iter_0000002" / "dynamicemb_module" / "item.npz").exists()


CACHING = RANKING + [
    'TrainerArgs.max_train_iters = 4',
    'DatasetArgs.item_vocab_size = 150',
    'DynamicEmbeddingArgs.caching = True',
    'DynamicEmbeddingArgs.capacity = 32',
    'DynamicEmbeddingArgs.bucket_capacity = 16',
]


def test_caching_main_matches_jax(tmp_path, monkeypatch, lines):
    """`DynamicEmbeddingArgs.caching` in the ranking entry: a 64-row item
    table (two buckets of 32) over the host tier, ids from 150, four steps,
    so that the later prefetches evict and onboard. Losses, dense params,
    the device tier (keys, scores and counters bit for bit, values to
    VALUE_TOL) and the host tier (keys and scores bit for bit, rows to
    VALUE_TOL) and the cache's counters match the JAX entry's; on this
    stream the JAX prefetch evicts none of a batch's keys, so the two
    caches take the same victims."""
    from recsys_examples_tpu.dynamicemb import hybrid_storage as jhs

    made = []
    init = jhs.HybridDynamicEmbedding.__init__
    monkeypatch.setattr(jhs.HybridDynamicEmbedding, "__init__",
                        lambda self, *a, **k: (made.append(self), init(self, *a, **k))[1])
    jstate, tstate = _run_both(tmp_path, monkeypatch, CACHING, j_rank, t_rank, TRanking)
    _assert_losses(lines, 4)
    _assert_states_close(jstate, tstate)
    jcache, tcache = made[0], t_rank.LAST_CACHE
    assert tcache.stats == jcache.stats
    assert tcache.stats["evict_flushes"] > 0 and tcache.stats["host_onboards"] > 0, tcache.stats
    host = lambda c: {int(k): (r, int(sc)) for ks, rs, ss in c.host.export()
                      for k, r, sc in zip(ks, rs, ss)}
    th, jh = host(tcache), host(jcache)
    assert th.keys() == jh.keys() and th
    for k, (r, sc) in jh.items():
        assert th[k][1] == sc
        np.testing.assert_allclose(th[k][0], r, **VALUE_TOL)


def test_retrieval_ignores_caching_as_jax(tmp_path):
    """The JAX retrieval entry has no embedding cache and trains its tables
    as they are under `caching`; so does the port's."""
    cfg = tmp_path / "x.gin"
    cfg.write_text("\n".join(RETRIEVAL + ['TrainerArgs.max_train_iters = 1',
                                          'DynamicEmbeddingArgs.caching = True']))
    tgin.clear_config()
    t_rank.LAST_CACHE = None
    state = t_ret.main(["--gin-config-file", str(cfg), "--device", "cpu"])
    assert state.step == 1 and t_rank.LAST_CACHE is None
    assert int(state.sparse["item"].table.inserted[0]) > 0


def test_unknown_kernel_backend_raises(tmp_path):
    cfg = tmp_path / "x.gin"
    cfg.write_text("\n".join(RANKING + ['NetworkArgs.kernel_backend = "triton"']))
    tgin.clear_config()
    with pytest.raises(ValueError, match="kernel_backend"):
        t_rank.main(["--gin-config-file", str(cfg), "--device", "cpu"])


def _remat_run(recompute, steps=2):
    cfg = HSTUConfig(hidden_size=32, num_layers=2, num_attention_heads=2, kv_channels=16,
                     hidden_dropout=0.3, dtype=torch.float32, recompute_layer=recompute,
                     position_encoding_config=PositionEncodingConfig(num_position_buckets=64))
    task = RankingConfig((EmbeddingConfig(("item",), "item", 300, 32),),
                         prediction_head_arch=(8, 1), num_tasks=1)
    trainer = GRTrainer(TRanking(cfg, task), make_optimizer(1e-2, "adam"), device="cpu")
    state = trainer.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(7)
    losses, grads = [], []
    for s in range(steps):
        state, m = trainer.train_step(state, random_hstu_batch(s, 4, 20, 300,
                                                               max_num_candidates=2), gen)
        losses.append(m["loss"])
        grads.append({n: p.grad.clone() for n, p in state.model.named_parameters()})
    return losses, grads, state.model.state_dict(), gen.get_state()


def test_recompute_with_dropout_equals_no_recompute_bit_for_bit():
    """Each checkpointed layer's recompute draws the dropout bits its
    forward drew: losses, every gradient, the params after two steps and
    the generator's final state all equal the unrecomputed run's."""
    a, b = _remat_run(False), _remat_run(True)
    for la, lb in zip(a[0], b[0]):
        assert torch.equal(la, lb)
    for ga, gb in zip(a[1], b[1]):
        for n in ga:
            assert torch.equal(ga[n], gb[n]), n
    for n in a[2]:
        assert torch.equal(a[2][n], b[2][n]), n
    assert torch.equal(a[3], b[3])


def test_recompute_layer_replays_the_layer_dropout():
    """Without the replay the recompute would draw fresh bits: the
    checkpointed forward calls each layer twice, from one generator state."""
    from recsys_examples_torch.modules import hstu_block

    calls = []
    orig = hstu_block.HSTULayer.forward

    def spy(self, jd, train=True, generator=None):
        calls.append(None if generator is None else generator.get_state())
        return orig(self, jd, train, generator)

    hstu_block.HSTULayer.forward = spy
    try:
        _remat_run(True, steps=1)
    finally:
        hstu_block.HSTULayer.forward = orig
    assert len(calls) == 4          # 2 layers: forward, then recompute in backward
    fwd, recompute = calls[:2], calls[2:]
    assert torch.equal(fwd[1], recompute[0]) and torch.equal(fwd[0], recompute[1])


@pytest.mark.parametrize("causal,fwd_only", [(True, False), (False, True)])
def test_hstu_train_flops_matches_jax(causal, fwd_only):
    from recsys_examples_torch.utils.perf import hstu_train_flops as t_flops
    from recsys_examples_tpu.utils.perf import hstu_train_flops as j_flops

    seqlens = np.random.default_rng(0).integers(1, 4096, size=32)
    args = (seqlens, 1024, 4, 256, 8)
    kw = dict(causal=causal, fwd_only=fwd_only)
    assert t_flops(*args, **kw) == j_flops(*args, **kw)


def test_device_peak_tflops_from_the_card_name(monkeypatch):
    from recsys_examples_torch.utils import perf

    assert np.isnan(perf.device_peak_tflops("cpu"))
    for name, peak in (("NVIDIA H100 80GB HBM3", 989.0), ("NVIDIA H100 PCIe", 756.0),
                       ("NVIDIA H100 NVL", 835.0), ("NVIDIA A100-SXM4-80GB", float("nan"))):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None, n=name: n)
        np.testing.assert_equal(perf.device_peak_tflops("cuda"), peak)


def test_step_timer_and_watchdog(capsys):
    import time

    from recsys_examples_torch.utils.logger import StepTimer
    from recsys_examples_torch.utils.watchdog import watched_iter

    timer = StepTimer(device="cpu")
    timer.start()
    time.sleep(0.01)
    assert timer.stop() >= 0.01 and timer.ema is not None

    def slow():
        yield 1
        time.sleep(0.3)
        yield 2

    assert list(watched_iter(slow(), timeout=0.1)) == [1, 2]
    assert "[watchdog] iteration exceeded 0.1s" in capsys.readouterr().err
