"""SID-GR serving soak and scheduler comparison (the port's copy of
tools/serving_soak.py).

The two schedulers on identical load:
  - batch   : `GRContinuousScheduler` (batch at a time, scheduler.py)
  - stepwise: `ContinuousGRScheduler` (continuous.py, pooled decode state),
              at each --steps-per-dispatch.
Arrivals of mixed context lengths interleaved with ticks; reports
throughput, latency percentiles, pool high water and leak checks.

Usage: python -m recsys_examples_torch.tools.serving_soak [--requests 32]
           [--device cuda]
Prints one JSON line per scheduler.
"""
import argparse
import json
import time

import numpy as np
import torch

from recsys_examples_torch.utils.device import resolve_device


def build(beam=16, layers=2, hidden=64, device="cuda", seed=0):
    """A random SID-GR model (4 hierarchies, codebook 256), bf16 on the card
    and fp32 on the CPU."""
    from recsys_examples_torch.models.sid_gr import SIDGRConfig, SIDGRModel

    dev = resolve_device(device)
    H = 4
    cfg = SIDGRConfig(
        num_hierarchies=H, codebook_size=256, hidden_size=hidden,
        num_layers=layers, num_heads=4, head_dim=hidden // 4,
        ffn_hidden=hidden * 4, beam_width=beam,
        dtype=torch.bfloat16 if dev.type == "cuda" else torch.float32,
    )
    model = SIDGRModel(cfg, device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(seed))
    return model, H


def drive(sched, contexts, label, warmup=True, backend=None):
    if warmup:
        # run every (step, batch bucket, ctx bucket) once before the measured
        # phase
        H = (sched.model.config.num_hierarchies if hasattr(sched, "model")
             else sched.engine.model.config.num_hierarchies)
        rng = np.random.default_rng(99)
        for n in (2, 24):
            for _ in range(3):
                sched.submit(rng.integers(0, 256, n * H).astype(np.int32))
            sched.run_until_empty()
        for r in list(getattr(sched, "finished", {})):
            sched.get_result(r)
        sched.metrics.clear()
    t0 = time.time()
    rids = []
    for i, c in enumerate(contexts):
        rids.append(sched.submit(c))
        # interleave submission with ticking (online load)
        if i % 2 == 1:
            sched.tick()
    sched.run_until_empty()
    total = time.time() - t0
    lats = []
    for rid in rids:
        r = sched.get_result(rid)
        assert r is not None and "error" not in r, r
        lats.append(r["latency_ms"])
    lats = np.asarray(lats)
    st = sched.status()
    out = {
        "scheduler": label,
        "requests": len(contexts),
        "total_s": round(total, 2),
        "req_per_s": round(len(contexts) / total, 2),
        "latency_ms_p50": round(float(np.percentile(lats, 50)), 1),
        "latency_ms_p99": round(float(np.percentile(lats, 99)), 1),
    }
    if "pool_high_water" in st:
        out["pool_high_water"] = st["pool_high_water"]
        out["pool_leaks"] = any(st["pool_leaks"].values())
    if hasattr(sched, "get_metrics"):
        m = sched.get_metrics()
        out["dispatches"] = m["counters"].get("dispatches", 0)
        out["steps_per_dispatch"] = m.get("steps_per_dispatch")
    if backend is not None:
        out["backend"] = backend
    print(json.dumps(out))
    return out


def make_contexts(requests, H, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(n) * H).astype(np.int32)
            for n in rng.choice([2, 4, 8, 24], requests)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--beam", type=int, default=16)
    ap.add_argument("--steps-per-dispatch", type=int, nargs="+", default=[1, 2, 3],
                    help="dispatch-coalescing factors to compare "
                    "(>= H-1 takes the pool-free full-chain path)")
    args = ap.parse_args(argv)

    from recsys_examples_torch.inference.sid_serving.continuous import ContinuousGRScheduler
    from recsys_examples_torch.inference.sid_serving.engine import (
        GRServingEngine,
        ServingConfig,
    )
    from recsys_examples_torch.inference.sid_serving.scheduler import (
        BeamPolicy,
        GRContinuousScheduler,
    )

    model, H = build(beam=args.beam, device=args.device)
    backend = model.device.type
    scfg = ServingConfig(beam_width=args.beam, ctx_buckets=(32, 128),
                         batch_buckets=(1, 2, 4, 8), max_batch_tokens=1024)
    contexts = make_contexts(args.requests, H)
    outs = []
    for spd in args.steps_per_dispatch:
        stepwise = ContinuousGRScheduler(
            model, scfg, max_batch=8, beam_policy=BeamPolicy(width=args.beam),
            steps_per_dispatch=spd)
        outs.append(drive(stepwise, contexts, f"stepwise-continuous/spd={spd}",
                          backend=backend))
    batch_sched = GRContinuousScheduler(GRServingEngine(model, scfg), max_batch=8)
    outs.append(drive(batch_sched, contexts, "batch-at-a-time", backend=backend))
    return outs


if __name__ == "__main__":
    main()
