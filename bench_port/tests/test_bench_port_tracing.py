"""The idle attribution (`core/attribution.py`) on a hand-made trace, and the
readers of the program's spans and counters: each reads nothing where the
program recorded nothing, and reads the spans and counters of a recording
made here."""
import time

import pytest

from bench_port.core import attribution as at
from bench_port.core import cell as cells
from bench_port.core.runctx import Reading
from bench_port.core.trace import Kernel, Trace
from recsys_examples_torch.utils import observability as obs

READERS = ("fwd_ms.train", "bwd_ms.train", "emb_device_ms.train", "emb_idle_ms.train",
           "queue_wait_ms.serve", "sched_self_ms.serve", "prefill_pad_share.serve",
           "decode_idle_ms.serve")


@pytest.fixture(autouse=True)
def fresh():
    obs.reset()
    yield
    obs.reset()


def trace(kernels, window_s):
    """A Trace of `kernels` ((start us, dur us, scopes)); busy is their
    union."""
    ks = [Kernel(f"k{i}", s, d, tuple(sc)) for i, (s, d, sc) in enumerate(kernels)]
    busy, end = 0.0, None
    for k in sorted(ks, key=lambda k: k.start_us):
        e = k.start_us + k.dur_us
        if end is None or k.start_us >= end:
            busy += k.dur_us
        elif e > end:
            busy += e - end
        end = e if end is None else max(end, e)
    return Trace(kernels=ks, window_s=window_s, busy_s=busy * 1e-6, idle_gaps=[])


def test_gaps_go_to_the_next_operations_innermost_span():
    tr = trace([
        (10, 5, ("step",)),                      # the window's first operation
        (20, 10, ("step", "fwd")),               # gap 15 -> 20: fwd
        (25, 10, ("step", "fwd")),               # overlaps: no gap
        (40, 5, ("step", "bwd", "Optimizer.step#Adam.step")),   # gap 35 -> 40
        (50, 5, ()),                             # gap 45 -> 50: no span
        (52, 1, ("step", "fwd")),                # inside [50, 55): no gap
        (70, 5, ("step",)),                      # gap 55 -> 70: step
    ], window_s=100e-6)
    got = at.idle_by_span(tr, known={"step", "fwd", "bwd"})
    assert got == pytest.approx({"fwd": 5e-6, "bwd": 5e-6, at.NO_SPAN: 5e-6,
                                 "step": 15e-6, at.EDGES: 35e-6})
    assert sum(got.values()) == pytest.approx(tr.window_s - tr.busy_s)
    # every host scope counts when `known` is None
    assert at.idle_by_span(tr)["Optimizer.step#Adam.step"] == pytest.approx(5e-6)
    assert at.idle_by_span(trace([], 1e-3)) == pytest.approx({at.EDGES: 1e-3})


def reading(tr=None, **counters):
    return Reading(spans={}, counters=counters, trace=tr, peaks={})


@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_without_the_programs_spans(name):
    assert at.program_snapshot() is None
    read = cells.reader(name)
    tr = trace([(10, 5, ("train/forward",)), (30, 5, ("qwen3/decode_1",))], 1e-4)
    assert read(reading(tr, generates=1.0)) is None
    assert read(reading(None, generates=1.0)) is None


def test_readers_read_the_programs_spans_and_counters():
    with obs.tracing():
        for _ in range(2):
            with obs.named_scope("train/step"):
                for name in ("emb/phase_a", "train/forward", "train/backward", "emb/phase_c"):
                    with obs.named_scope(name):
                        pass
        with obs.named_scope("serve/tick"):
            with obs.named_scope("serve/admit"):
                now = time.perf_counter()
                obs.record("serve/queue", now - 0.004, now)
                obs.record("serve/queue", now - 0.002, now)
            with obs.named_scope("serve/generate"):
                time.sleep(0.003)
        obs.count("serve/prefill_tokens", 400)
        obs.count("serve/prefill_valid_tokens", 300)
    tr = trace([(0, 10, ("train/step", "emb/phase_a")),
                (20, 30, ("train/step", "train/forward")),
                (60, 10, ("train/step", "train/backward")),
                (90, 4, ("train/step", "emb/phase_c")),
                (100, 6, ("qwen3/decode_1",))], 200e-6)
    r = reading(tr, generates=2.0)
    got = {n: cells.reader(n)(r) for n in READERS}
    assert got["fwd_ms.train"] == pytest.approx(30e-3 / 2)
    assert got["bwd_ms.train"] == pytest.approx(10e-3 / 2)
    assert got["emb_device_ms.train"] == pytest.approx(14e-3 / 2)
    assert got["emb_idle_ms.train"] == pytest.approx(20e-3 / 2)      # the gap 70 -> 90
    assert got["decode_idle_ms.serve"] is None          # no decode span was recorded
    assert got["queue_wait_ms.serve"] == pytest.approx(3.0, abs=1e-3)
    assert 0 <= got["sched_self_ms.serve"] < 3.0
    assert got["prefill_pad_share.serve"] == pytest.approx(25.0)
    with obs.tracing():
        with obs.named_scope("qwen3/decode_1"):
            pass
    assert cells.reader("decode_idle_ms.serve")(r) == pytest.approx(6e-3 / 2)  # 94 -> 100
