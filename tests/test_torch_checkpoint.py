"""The port's checkpoints: a dynamic table dumped by the JAX package loads
into the port exactly as into the JAX package (keys, scores, slots, values,
optimizer rows, counters and the step, bit for bit), and the other way; the
two packages' dumps of one state are the same files; and a port run saved
at step 2, loaded into a fresh state and stepped once equals the
uninterrupted step 3 bit for bit (dense params, optimizer state, loss, and
every key's table row)."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_examples_torch import convert
from recsys_examples_torch.data.hstu_batch import random_hstu_batch
from recsys_examples_torch.dynamicemb import batched_table as tbt
from recsys_examples_torch.dynamicemb import dynamicemb_config as tcfg
from recsys_examples_torch.dynamicemb import optimizer as topt
from recsys_examples_torch.dynamicemb.sharded_collection import ShardedDynamicEmbedding
from recsys_examples_torch.models.ranking_gr import RankingGR
from recsys_examples_torch.modules.config import (
    HSTUConfig, PositionEncodingConfig, RankingConfig)
from recsys_examples_torch.training import checkpoint as tck
from recsys_examples_torch.training.train_state import make_optimizer
from recsys_examples_torch.training.trainer import GRTrainer
from recsys_examples_tpu.dynamicemb import batched_table as jbt
from recsys_examples_tpu.dynamicemb import dynamicemb_config as jcfg
from recsys_examples_tpu.dynamicemb import optimizer as jopt
from recsys_examples_tpu.training import checkpoint as jck

FIELDS = ("keys", "scores", "values", "opt", "inserted", "evicted", "overflowed")


def _tables(optimizer="rowwise_adagrad"):
    kw = dict(embedding_dim=8, max_capacity=256, bucket_capacity=16)
    return (tbt.DynamicEmbeddingTable(tcfg.DynamicEmbTableOptions(**kw),
                                      topt.SparseOptimizerArgs(optimizer=optimizer,
                                                               learning_rate=0.1)),
            jbt.DynamicEmbeddingTable(jcfg.DynamicEmbTableOptions(**kw),
                                      jopt.SparseOptimizerArgs(optimizer=optimizer,
                                                               learning_rate=0.1)))


def _jax_state(jt, seed):
    """A JAX table after three insert + update rounds; 600 keys into 256
    slots, so buckets fill and evict. 200 distinct keys a round: one shape,
    so JAX compiles each round's functions once."""
    rng = np.random.default_rng(seed)
    st = jt.init_state()
    for _ in range(3):
        keys = np.sort(rng.choice(10_000, size=200, replace=False)).astype(np.int64)
        st, slots, _ = jt.forward_train(st, jnp.asarray(keys))
        grads = rng.standard_normal((len(keys), 8)).astype(np.float32)
        st = jt.backward(st, slots, jnp.asarray(grads))
    return st


def _numpy_state(st):
    tab = lambda h: None if h is None else {
        f: None if getattr(h, f) is None else np.asarray(getattr(h, f)) for f in FIELDS}
    return {"table": tab(st.table), "counter": tab(st.counter), "step": np.asarray(st.step)}


def _assert_states_equal(port_state, jax_state):
    got, want = convert.dynamic_table_to_numpy(port_state), _numpy_state(jax_state)
    for f in FIELDS:
        if want["table"][f] is None:
            assert got["table"][f] is None, f
        else:
            np.testing.assert_array_equal(got["table"][f], want["table"][f], err_msg=f)
    np.testing.assert_array_equal(got["step"], want["step"])


@pytest.mark.parametrize("optimizer", ["rowwise_adagrad", "sgd"])
def test_tables_cross_load_bit_for_bit(tmp_path, optimizer):
    tt, jt = _tables(optimizer)
    jstate = _jax_state(jt, 0)
    assert int(jstate.table.evicted[0]) > 0
    tstate = convert.dynamic_table_state(_numpy_state(jstate))
    n_j = jck.dump_table(str(tmp_path / "jax"), "item", jstate)
    n_t = tck.dump_table(str(tmp_path / "torch"), "item", tstate)
    assert n_j == n_t > 0
    # one state, two dumps: the same arrays and meta
    dj, dt = np.load(tmp_path / "jax" / "item.npz"), np.load(tmp_path / "torch" / "item.npz")
    assert sorted(dj.files) == sorted(dt.files)
    for k in dj.files:
        np.testing.assert_array_equal(dt[k], dj[k], err_msg=k)
        assert dt[k].dtype == dj[k].dtype, k
    assert json.loads((tmp_path / "torch" / "item.meta.json").read_text()) == \
        json.loads((tmp_path / "jax" / "item.meta.json").read_text())
    # each dump loads into either package alike; small load chunks, so the
    # chunk padding is exercised
    for src in ("jax", "torch"):
        want = jck.load_table(str(tmp_path / src), "item", jt, jt.init_state(), batch=64)
        got = tck.load_table(str(tmp_path / src), "item", tt, tt.init_state("cpu"), batch=64)
        _assert_states_equal(got, want)
        # re-insertion keeps every live key with its row
        live = want.table.keys.reshape(-1) != tcfg.EMPTY_KEY
        assert int(live.sum()) == n_j


def test_incremental_dump_by_score(tmp_path):
    tt, jt = _tables()
    jstate = _jax_state(jt, 1)
    tstate = convert.dynamic_table_state(_numpy_state(jstate))
    thr = int(np.asarray(jstate.step)[0])      # the last round's keys only
    n_t = tck.dump_table(str(tmp_path), "t", tstate, score_threshold=thr)
    n_j = jck.dump_table(str(tmp_path), "j", jstate, score_threshold=thr)
    assert 0 < n_t == n_j < int((np.asarray(jstate.table.keys) != tcfg.EMPTY_KEY).sum())
    assert (np.load(tmp_path / "t.npz")["scores"] >= thr).all()


def _trainer(seed):
    cfg = HSTUConfig(hidden_size=16, num_layers=2, num_attention_heads=2, kv_channels=8,
                     dtype=torch.float32, position_encoding_config=PositionEncodingConfig(
                         num_position_buckets=64))
    task = RankingConfig((), prediction_head_arch=(8, 1), num_tasks=1)
    table = tbt.DynamicEmbeddingTable(
        tcfg.DynamicEmbTableOptions(embedding_dim=16, max_capacity=1024, bucket_capacity=128),
        topt.SparseOptimizerArgs(optimizer="rowwise_adagrad", learning_rate=0.05))
    trainer = GRTrainer(RankingGR(cfg, task), make_optimizer(1e-2, "adam"),
                        {"item": ShardedDynamicEmbedding(table, device="cpu")}, device="cpu")
    return trainer, trainer.init(torch.Generator().manual_seed(seed))


def _rows_by_key(state):
    t = state.table
    keys = t.keys.reshape(-1)
    order = torch.argsort(keys)
    order = order[keys[order] != tcfg.EMPTY_KEY]
    return {"keys": keys[order], "scores": t.scores.reshape(-1)[order],
            "values": t.values[order], "opt": t.opt[order], "step": state.step}


def test_save_at_step_2_load_and_step_equals_uninterrupted(tmp_path):
    batches = [random_hstu_batch(s, 4, 24, 500, max_num_candidates=3) for s in range(3)]
    trainer, state = _trainer(0)
    for b in batches:
        state, m = trainer.train_step(state, b)
    want_loss = m["loss"]

    trainer2, state2 = _trainer(0)
    for b in batches[:2]:
        state2, _ = trainer2.train_step(state2, b)
    tck.save_checkpoint(str(tmp_path / "iter_2"), state2, state2.sparse)
    trainer3, fresh = _trainer(1)            # other initial params, empty table
    fresh = tck.load_checkpoint(str(tmp_path / "iter_2"), fresh,
                                {n: t.table for n, t in trainer3.sparse_tables.items()})
    assert fresh.step == 2
    fresh, m3 = trainer3.train_step(fresh, batches[2])
    assert fresh.step == state.step == 3
    assert torch.equal(m3["loss"], want_loss)
    for (n, p), (n3, p3) in zip(state.model.state_dict().items(),
                                fresh.model.state_dict().items()):
        assert n == n3 and torch.equal(p, p3), n
    for group, group3 in zip(state.optimizer.state_dict()["state"].values(),
                             fresh.optimizer.state_dict()["state"].values()):
        for k in group:
            assert torch.equal(group[k], group3[k]), k
    got, want = _rows_by_key(fresh.sparse["item"]), _rows_by_key(state.sparse["item"])
    for k in want:
        assert torch.equal(got[k], want[k]), k
