"""The port's utilities against the JAX package's: `utils/observability.py`
(`table_stats` on a dynamic table that evicted, `named_scope` spans inside
`profiler_window`'s trace), and the
helpers that only tests and tools call: `jagged_dense_bmm_broadcast_add`,
`jagged_reduce_sum`, `hstu_cached_mha_reference` (fp32, within 1e-5),
`make_jagged_data`, `random_jagged_data`, `lengths_to_offsets` and
`sequence_dataset_iterator` (batches equal)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_examples_torch import convert
from recsys_examples_torch.data import sequence_dataset as tsd
from recsys_examples_torch.dynamicemb import batched_table as tbt
from recsys_examples_torch.dynamicemb import dynamicemb_config as tcfg
from recsys_examples_torch.dynamicemb import optimizer as topt
from recsys_examples_torch.jagged import jagged_tensor as tjt
from recsys_examples_torch.ops import hstu_attention_ref as tref
from recsys_examples_torch.ops import jagged as tjg
from recsys_examples_torch.training import gin_args as t_args
from recsys_examples_torch.utils import observability as tobs
from recsys_examples_tpu.data import sequence_dataset as jsd
from recsys_examples_tpu.dynamicemb import batched_table as jbt
from recsys_examples_tpu.dynamicemb import dynamicemb_config as jcfg
from recsys_examples_tpu.dynamicemb import optimizer as jopt
from recsys_examples_tpu.jagged import jagged_tensor as jjt
from recsys_examples_tpu.ops import hstu_attention_ref as jref
from recsys_examples_tpu.ops import jagged as jjg
from recsys_examples_tpu.training import gin_args as j_args
from recsys_examples_tpu.utils import observability as jobs

TOL = dict(rtol=1e-5, atol=1e-5)


def test_table_stats_matches_jax():
    """A table small enough that inserts evict: every counter equal."""
    def mk(cfg, bt, opt):
        return bt.DynamicEmbeddingTable(
            cfg.DynamicEmbTableOptions(embedding_dim=4, max_capacity=32, bucket_capacity=4),
            opt.SparseOptimizerArgs(optimizer="sgd"))

    jt = mk(jcfg, jbt, jopt)
    js = jt.init_state()
    for r in range(3):
        js, _, _ = jt.forward_train(js, jnp.arange(1 + 20 * r, 21 + 20 * r, dtype=jnp.int64))
    leaves = lambda h: {f: None if getattr(h, f) is None else np.asarray(getattr(h, f))
                        for f in convert.HASH_TABLE_FIELDS}
    ts = convert.dynamic_table_state(
        {"table": leaves(js.table), "counter": None, "step": np.asarray(js.step)}, device="cpu")
    want = jobs.table_stats(js)
    assert want["evicted"] > 0
    assert tobs.table_stats(ts) == want
    # and on a table the port filled itself
    tt = mk(tcfg, tbt, topt)
    st = tt.init_state("cpu")
    st, _, _ = tt.forward_train(st, torch.arange(1, 11, dtype=torch.int64))
    got = tobs.table_stats(st)
    assert got["size"] == got["inserted"] - got["evicted"] == 10 and got["capacity"] == 32


def test_device_timer_and_profiler_window(tmp_path):
    """Spans opened inside `profiler_window` are recorded and their ranges
    written into its trace; outside it nothing is recorded."""
    tobs.reset()
    x = torch.ones(64, 64)
    out_dir = str(tmp_path / "trace")
    with tobs.named_scope("qwen3/before"):
        pass
    with tobs.profiler_window(out_dir) as prof:
        for _ in range(3):
            with tobs.named_scope("qwen3/matmul"):
                y = x @ x
    assert float(y[0, 0]) == 64.0
    spans = tobs.snapshot()["spans"]
    tobs.reset()
    assert [s["name"] for s in spans] == ["qwen3/matmul"] * 3
    assert all(s["end_us"] > s["start_us"] and s["parent"] is None for s in spans)
    names = {e.key for e in prof.key_averages()}
    assert "qwen3/matmul" in names
    with open(os.path.join(out_dir, "trace.json")) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("name") == "qwen3/matmul"]
    assert len(events) == 3


def jagged_case(seed=0):
    rng = np.random.default_rng(seed)
    lens = np.array([3, 0, 5, 2])
    offs = np.concatenate([[0], np.cumsum(lens)])
    T = 12                                  # two padding rows past offs[-1]
    return rng, lens, offs, T


@pytest.mark.parametrize("with_bias", [False, True])
def test_jagged_dense_bmm_broadcast_add_matches_jax(with_bias):
    rng, lens, offs, T = jagged_case()
    vals = rng.standard_normal((T, 6)).astype(np.float32)
    dense = rng.standard_normal((4, 6, 5)).astype(np.float32)
    bias = rng.standard_normal((4, 5)).astype(np.float32) if with_bias else None
    want = jjg.jagged_dense_bmm_broadcast_add(
        jnp.asarray(vals), jnp.asarray(offs, jnp.int32), jnp.asarray(dense),
        None if bias is None else jnp.asarray(bias))
    got = tjg.jagged_dense_bmm_broadcast_add(
        torch.as_tensor(vals), torch.as_tensor(offs), torch.as_tensor(dense),
        None if bias is None else torch.as_tensor(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (got[offs[-1]:] == 0).all()


def test_jagged_reduce_sum_matches_jax():
    rng, lens, offs, T = jagged_case(1)
    vals = rng.standard_normal((T, 3)).astype(np.float32)
    want = jjg.jagged_reduce_sum(jnp.asarray(vals), jnp.asarray(offs, jnp.int32), 4)
    got = tjg.jagged_reduce_sum(torch.as_tensor(vals), torch.as_tensor(offs), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(got[1].numpy(), 0)


@pytest.mark.parametrize("targets,window", [(False, 0), (True, 0), (True, 3)])
def test_hstu_cached_mha_reference_matches_jax(targets, window):
    """Two new tokens per row over jagged keys of lengths 6, 9, 4."""
    rng = np.random.default_rng(2)
    lens = np.array([6, 9, 4])
    offs = np.concatenate([[0], np.cumsum(lens)])
    T, H, D, N, dl = int(offs[-1]), 2, 8, 10, 2
    k, v = (rng.standard_normal((T, H, D)).astype(np.float32) for _ in range(2))
    dq = rng.standard_normal((3 * dl, H, D)).astype(np.float32)
    dx = np.concatenate([offs[1:][i] - dl + np.arange(dl) for i in range(3)])
    nt = np.array([1, 3, 0]) if targets else None
    args = lambda cv, off_dtype: (
        N, N, 0.3, cv(dq), cv(k), cv(v), cv(dx.astype(off_dtype)), cv(offs.astype(off_dtype)),
        None if nt is None else cv(nt.astype(off_dtype)), window)
    want = jref.hstu_cached_mha_reference(*args(jnp.asarray, np.int32))
    got = tref.hstu_cached_mha_reference(*args(torch.as_tensor, np.int64))
    assert got.shape == (3 * dl, H, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_make_and_random_jagged_data_match_jax():
    seqlen = np.array([3, 0, 4])
    nc, ctx = np.array([1, 0, 2]), np.array([1, 0, 1])
    vals = np.random.default_rng(3).standard_normal((9, 5)).astype(np.float32)
    jd = jjt.make_jagged_data(jnp.asarray(vals), jnp.asarray(seqlen), 8,
                              num_candidates=jnp.asarray(nc), max_num_candidates=2,
                              contextual_seqlen=jnp.asarray(ctx), contextual_max_seqlen=1,
                              has_interleaved_action=True, scaling_seqlen=16)
    td = tjt.make_jagged_data(torch.as_tensor(vals), torch.as_tensor(seqlen), 8,
                              num_candidates=torch.as_tensor(nc), max_num_candidates=2,
                              contextual_seqlen=torch.as_tensor(ctx), contextual_max_seqlen=1,
                              has_interleaved_action=True, scaling_seqlen=16)
    for f in ("seqlen", "seqlen_offsets", "num_candidates", "num_candidates_offsets",
              "contextual_seqlen", "contextual_seqlen_offsets", "values"):
        np.testing.assert_array_equal(getattr(td, f).numpy(), np.asarray(getattr(jd, f)),
                                      err_msg=f)
    for f in ("max_seqlen", "max_num_candidates", "contextual_max_seqlen",
              "has_interleaved_action", "scaling_seqlen", "batch_size", "total_len",
              "hidden_dim"):
        assert getattr(td, f) == getattr(jd, f), f
    np.testing.assert_array_equal(td.token_mask().numpy(), np.asarray(jd.token_mask()))
    np.testing.assert_array_equal(
        tjt.lengths_to_offsets(torch.as_tensor(seqlen)).numpy(),
        np.asarray(jjt.lengths_to_offsets(jnp.asarray(seqlen))))
    # random values: the same layout, uniform in [0, 1), padding rows zero
    jr = jjt.random_jagged_data(jax.random.PRNGKey(0), jnp.asarray(seqlen), 5, 8, 9)
    tr = tjt.random_jagged_data(torch.Generator().manual_seed(0), torch.as_tensor(seqlen),
                                5, 8, 9)
    assert tuple(tr.values.shape) == jr.values.shape and tr.values.dtype == torch.float32
    np.testing.assert_array_equal(tr.seqlen_offsets.numpy(), np.asarray(jr.seqlen_offsets))
    np.testing.assert_array_equal((tr.values == 0).all(1).numpy()[7:],
                                  (np.asarray(jr.values) == 0).all(1)[7:])
    assert ((tr.values[:7] >= 0) & (tr.values[:7] < 1)).all() and (tr.values[7:] == 0).all()


def _leaves(batch):
    """An HSTUBatch's arrays by name, ids as int64."""
    out = {f"{k}.{p}": np.asarray(getattr(v, p)).astype(np.int64)
           for k, v in batch.features.items() for p in ("values", "lengths", "offsets")}
    for f in ("num_candidates", "labels", "label_lengths"):
        x = getattr(batch, f)
        out[f] = None if x is None else np.asarray(x).astype(np.int64)
    out["max_len"] = dict(batch.feature_to_max_seqlen)
    return out


def test_sequence_dataset_iterator_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    rows = [f"{u}::{int(rng.integers(1, 50))}::{int(rng.integers(1, 6))}::{t}"
            for u in range(1, 13) for t in range(int(rng.integers(4, 20)))]
    (tmp_path / "ratings.dat").write_text("\n".join(rows))
    npz = str(tmp_path / "seq.npz")
    tsd.preprocess_movielens(str(tmp_path / "ratings.dat"), npz, min_seq_len=3)
    kw = dict(dataset_name="movielens-1m", dataset_path=npz, batch_size=4,
              max_history_len=8, max_num_candidates=2, action_vocab_size=6)
    tit = tsd.sequence_dataset_iterator(t_args.DatasetArgs(**kw), t_args.TrainerArgs(seed=5))
    jit = jsd.sequence_dataset_iterator(j_args.DatasetArgs(**kw), j_args.TrainerArgs(seed=5))
    for _ in range(5):                    # past the end of one pass: the stream repeats
        got, want = _leaves(next(tit)), _leaves(next(jit))
        assert sorted(got) == sorted(want)
        for k in want:
            if isinstance(want[k], np.ndarray):
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            else:
                assert got[k] == want[k], k
