"""The port's tracer (`utils/observability.py`): spans and their parents, the
shared no-op while tracing is off, device counts read without a sync until
`snapshot()`, span times on the profiler's clock, and the spans and counters
of a train step with a dynamic table and of a Qwen3 serving tick, on the
CPU at tiny sizes."""
import json
import time
from collections import Counter

import numpy as np
import pytest
import torch

from recsys_examples_torch.data.hstu_batch import random_hstu_batch
from recsys_examples_torch.dynamicemb import batched_table, dynamicemb_config, optimizer
from recsys_examples_torch.dynamicemb.sharded_collection import ShardedDynamicEmbedding
from recsys_examples_torch.inference.sid_serving.engine import (
    Qwen3ServingEngine,
    ServingConfig,
)
from recsys_examples_torch.inference.sid_serving.scheduler import GRContinuousScheduler
from recsys_examples_torch.models.qwen3 import Qwen3Config, Qwen3Model
from recsys_examples_torch.models.ranking_gr import RankingGR
from recsys_examples_torch.modules import config as mc
from recsys_examples_torch.training.train_state import make_optimizer
from recsys_examples_torch.training.trainer import GRTrainer
from recsys_examples_torch.utils import observability as obs


@pytest.fixture(autouse=True)
def fresh():
    obs.reset()
    yield
    obs.reset()


def by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


def test_spans_nest_with_their_parents():
    with obs.tracing():
        with obs.named_scope("a", request_id="r1"):
            with obs.named_scope("b"):
                with obs.named_scope("c"):
                    pass
            with obs.named_scope("b"):
                t0 = time.perf_counter()
                obs.record("q", t0 - 0.002, t0, request_id="r2")
        with obs.named_scope("d"):
            pass
    snap = obs.snapshot()
    got = by_name(snap["spans"])
    assert Counter(s["name"] for s in snap["spans"]) == {"a": 1, "b": 2, "c": 1, "q": 1, "d": 1}
    a, d, c, q = got["a"][0], got["d"][0], got["c"][0], got["q"][0]
    assert a["parent"] is None and d["parent"] is None
    assert [b["parent"] for b in got["b"]] == [a["id"], a["id"]]
    assert c["parent"] == got["b"][0]["id"] and q["parent"] == got["b"][1]["id"]
    assert a["attrs"] == {"request_id": "r1"} and q["attrs"] == {"request_id": "r2"}
    assert q["end_us"] - q["start_us"] == pytest.approx(2000.0, abs=1.0)
    for s in snap["spans"]:
        assert s["end_us"] >= s["start_us"]
        if s["parent"] is not None and s["name"] != "q":
            p = next(x for x in snap["spans"] if x["id"] == s["parent"])
            assert p["start_us"] <= s["start_us"] <= s["end_us"] <= p["end_us"]
    # Unix-time microseconds
    assert abs(a["start_us"] - time.time_ns() / 1e3) < 60e6


def test_nothing_is_recorded_while_tracing_is_off():
    assert not obs.enabled()
    scope = obs.named_scope("off", request_id="r")
    assert scope is obs.named_scope("other")       # the one shared no-op
    with scope:
        obs.count("n", 3)
        obs.count("t", torch.ones((), dtype=torch.int64))
        obs.record("q", 0.0, 1.0)
    assert obs.snapshot() == {"spans": [], "counters": {}}
    with obs.tracing():
        assert obs.enabled() and obs.named_scope("on") is not scope
    assert not obs.enabled()


class _Lazy(torch.Tensor):
    """A CPU tensor that counts how often its value is read on the host."""
    reads = 0

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func in (torch.Tensor.item, torch.Tensor.__float__, torch.Tensor.__int__,
                    torch.Tensor.__bool__, torch.Tensor.tolist):
            cls.reads += 1
        return super().__torch_function__(func, types, args, kwargs or {})


def test_counters_take_device_tensors_without_reading_them():
    _Lazy.reads = 0
    with obs.tracing():
        for i in range(600):                 # past a fold of held counts
            obs.count("dev", torch.tensor(i % 3 + 1, dtype=torch.int64).as_subclass(_Lazy))
            obs.count("host", 2)
        obs.count("flag", torch.tensor([True, False, True]).sum().as_subclass(_Lazy))
    assert _Lazy.reads == 0
    snap = obs.snapshot()
    assert snap["counters"] == {"dev": 1200, "host": 1200, "flag": 2}
    assert isinstance(snap["counters"]["dev"], int)
    assert _Lazy.reads > 0
    obs.reset()
    assert obs.snapshot()["counters"] == {}


def test_span_times_land_on_their_profiler_events(tmp_path):
    with obs.profiler_window(str(tmp_path)):
        for i in range(3):
            with obs.named_scope(f"probe/{i}"):
                x = torch.ones(64, 64) @ torch.ones(64, 64)
                time.sleep(0.002)
    assert float(x[0, 0]) == 64.0
    assert not obs.enabled()
    trace = json.loads((tmp_path / "trace.json").read_text())
    base_us = trace["baseTimeNanoseconds"] / 1e3
    events = {e["name"]: e for e in trace["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"}
    spans = obs.snapshot()["spans"]
    assert sorted(s["name"] for s in spans) == ["probe/0", "probe/1", "probe/2"]
    for s in spans:
        ev = events[s["name"]]
        assert abs(s["start_us"] - (ev["ts"] + base_us)) < 5e3
        assert abs((s["end_us"] - s["start_us"]) - ev["dur"]) < 5e3


def _tiny_trainer():
    """A two-layer HSTU ranking model over an `item` dynamic table (the
    other features in static tables), fp32 on the CPU."""
    E = 16
    hstu = mc.HSTUConfig(hidden_size=32, num_layers=2, num_attention_heads=2, kv_channels=16,
                         hidden_dropout=0.0,
                         position_encoding_config=mc.PositionEncodingConfig(
                             num_position_buckets=64),
                         item_embedding_dim=E, contextual_embedding_dim=E,
                         dtype=torch.float32)
    tables = (("action", 10), ("user_id", 50))
    task = mc.RankingConfig(
        embedding_configs=tuple(mc.EmbeddingConfig((n,), n, v, E) for n, v in tables),
        prediction_head_arch=(8, 2), num_tasks=2)
    item = ShardedDynamicEmbedding(batched_table.DynamicEmbeddingTable(
        dynamicemb_config.DynamicEmbTableOptions(embedding_dim=E, max_capacity=256,
                                                 bucket_capacity=16),
        optimizer.SparseOptimizerArgs(optimizer="rowwise_adagrad", learning_rate=0.01)),
        device="cpu")
    trainer = GRTrainer(RankingGR(hstu, task), make_optimizer(1e-3, "adam"), {"item": item},
                        device="cpu")
    return trainer, trainer.init(torch.Generator().manual_seed(0))


def test_train_step_spans_and_table_counters():
    trainer, state = _tiny_trainer()
    batches = [random_hstu_batch(seed=s, batch_size=3, max_history_len=12, item_vocab=40,
                                 action_vocab=10, contextual_vocabs={"user_id": 50},
                                 num_tasks=2) for s in range(2)]
    state, _ = trainer.train_step(state, batches[0])       # untraced
    assert obs.snapshot() == {"spans": [], "counters": {}}
    with obs.tracing():
        for b in batches:
            state, m = trainer.train_step(state, b)
    assert torch.isfinite(m["loss"])
    snap = obs.snapshot()
    names = Counter(s["name"] for s in snap["spans"])
    want = ("train/step", "train/h2d", "emb/phase_a", "train/forward", "train/backward",
            "train/optimizer", "emb/phase_c", "train/metrics")
    assert names == {n: 2 for n in want}
    ids = {s["id"]: s for s in snap["spans"]}
    for s in snap["spans"]:
        parent = ids.get(s["parent"])
        assert (parent is None) == (s["name"] == "train/step")
        if parent is not None:
            assert parent["name"] == "train/step"
    # a step's children, in the order it runs them
    step = by_name(snap["spans"])["train/step"][1]
    kids = sorted((s for s in snap["spans"] if s["parent"] == step["id"]),
                  key=lambda s: s["start_us"])
    assert [s["name"] for s in kids] == list(want[1:])
    c = snap["counters"]
    # phase A looks up every id of the feature's buffer, its padding too
    uniq = sum(len(np.unique(b.features["item"].values)) for b in batches)
    assert c["emb/unique_keys"] == uniq
    assert c["emb/hits"] + c["emb/inserted"] + c["emb/overflowed"] == uniq
    assert c["emb/hits"] > 0 and c["emb/evicted"] == c["emb/overflowed"] == 0
    assert c["emb/insert_rounds"] >= 2


def test_serving_tick_spans_queue_and_pad_counters():
    torch.manual_seed(0)
    model = Qwen3Model(Qwen3Config.tiny(vocab_size=64), device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    engine = Qwen3ServingEngine(model, ServingConfig(beam_width=4, ctx_buckets=(16,),
                                                     batch_buckets=(4,)), num_steps=3)
    sched = GRContinuousScheduler(engine, max_batch=4)
    rng = np.random.default_rng(1)
    ctxs = [rng.integers(0, 64, size=(n,)).astype(np.int32) for n in (9, 13, 5)]
    with obs.tracing():
        rids = [sched.submit(c, top_k=2) for c in ctxs]
        time.sleep(0.002)
        assert sched.tick() == 3
        assert sched.tick() == 0                      # an empty queue: a bare tick
    snap = obs.snapshot()
    names = Counter(s["name"] for s in snap["spans"])
    assert names == {"serve/tick": 2, "serve/admit": 2, "serve/queue": 3,
                     "serve/generate": 1, "serve/pack": 2, "qwen3/prefill": 1,
                     "qwen3/expand": 1, "qwen3/decode_1": 1, "qwen3/decode_2": 1,
                     "qwen3/paths": 1, "serve/readback": 1, "serve/results": 1}
    spans = by_name(snap["spans"])
    ids = {s["id"]: s for s in snap["spans"]}
    parent = lambda s: ids[s["parent"]]["name"]
    assert {s["attrs"]["request_id"] for s in spans["serve/queue"]} == set(rids)
    assert all(parent(s) == "serve/admit" for s in spans["serve/queue"])
    assert parent(spans["serve/generate"][0]) == "serve/tick"
    assert all(parent(s) == "serve/generate" for n in ("serve/pack", "qwen3/prefill",
               "qwen3/decode_2", "serve/readback") for s in spans[n])
    assert snap["counters"] == {"serve/prefill_tokens": 4 * 16,
                                "serve/prefill_valid_tokens": 9 + 13 + 5}
    for rid, q in zip(rids, sorted(spans["serve/queue"],
                                   key=lambda s: rids.index(s["attrs"]["request_id"]))):
        r = sched.get_result(rid)
        assert len(r["sids"]) == 2
        assert r["queue_ms"] == pytest.approx((q["end_us"] - q["start_us"]) / 1e3, abs=1e-3)
        assert 2.0 <= r["queue_ms"] <= r["latency_ms"]
