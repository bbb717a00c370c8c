"""The training driver: one trainer object made in set-up from the seed,
driven through its first steps (the compared ones) and a warm-up pass over
the cell's pool of batches, then a window of steps that cycles through the
pool.

Set-up builds the program from the harness's weights, stages the pool on
the card and runs one pass over it; the first `compared_steps` of that pass
are read for the comparison: each step's loss, each leaf's gradient at the
first step as its optimizer got it, and each leaf's change after the last.
The reference then trains from the same weights on the same batches, once
the window has closed and the program is freed.

The window (untraced) runs whole steps until `seconds` have passed and ends
on a synchronize; the rate counts every token of every step in it. The
traced run times phases by the program's hooks over `trace_span_steps`
steps, then profiles `trace_profile_steps` steps."""
from __future__ import annotations

import statistics
import time
from typing import Dict

import torch

from bench_port.core import spans
from bench_port.core import weights as wts
from bench_port.core.cell import module
from bench_port.core.peaks import peaks_for
from bench_port.core.runctx import Outcome, Reading, RunContext, free, memory_peak, sync
from bench_port.core.trace import profiled


def _gap(p: float, r: float, floor: float) -> float:
    return abs(p - r) / max(abs(r), floor)


def compare(prog: dict, ref: dict, exclude_below: float) -> Dict[str, float]:
    """The numbers compared, each a worst case over the steps or the leaves:
    - loss_gap: a step's relative loss gap;
    - grad_gap: the gap between the program's and the reference's norm of
      a leaf's first gradient;
    - grad_dist: the norm of the difference of the two first gradients;
    - change_gap: the gap between the two norms of a leaf's change after
      the compared steps.
    Each is over the larger of the leaf's reference norm and the median
    leaf's. Leaves whose reference gradient is under `exclude_below` of the
    median leaf's move by rounding alone and are left out of the change."""
    nan = float("nan")
    if set(prog["grads"]) != set(ref["grads"]):
        return {"loss_gap": nan, "grad_gap": nan, "grad_dist": nan, "change_gap": nan}
    loss = max(_gap(p, r, 1e-30) for p, r in zip(prog["losses"], ref["losses"]))
    g_ref = {k: float(g.norm()) for k, g in ref["grads"].items()}
    g_med = statistics.median(g_ref.values())
    grad = dist = 0.0
    for k, g in ref["grads"].items():
        p = prog["grads"][k].float()
        floor = max(g_ref[k], g_med)
        grad = max(grad, abs(float(p.norm()) - g_ref[k]) / floor)
        dist = max(dist, float((p - g).norm()) / floor if p.shape == g.shape else nan)
    kept = [k for k, g in g_ref.items() if g >= exclude_below * g_med]
    c_ref = ref["change_norms"]
    c_med = statistics.median(c_ref[k] for k in kept)
    change = max(_gap(prog["change_norms"][k], c_ref[k], c_med) for k in kept)
    return {"loss_gap": loss, "grad_gap": grad, "grad_dist": dist, "change_gap": change}


def build(ctx: RunContext):
    """The program from the seed's weights, and the pool, host and staged."""
    cfg, dev = ctx.config, ctx.device
    fam = module("families", cfg["family"])
    prog = fam.Program(cfg, wts.make(fam.param_spec(cfg), ctx.seed, dev), dev)
    pool = fam.make_pool(ctx.workload, cfg, ctx.seed)
    staged = [prog.stage(b) for b in pool]
    free(dev)
    return fam, prog, pool, staged


def first_steps(ctx: RunContext, fam, prog, staged) -> dict:
    """Drive the program through the compared steps and read it."""
    n_cmp = ctx.workload["compared_steps"]
    readings = {"losses": []}
    for i, b in enumerate(staged[:n_cmp]):
        m = prog.step(b)
        readings["losses"].append(float(m["loss"]))
        if i == 0:
            readings["grads"] = {k: g.clone() for k, g in prog.first_grads().items()}
    p0 = wts.make(fam.param_spec(ctx.config), ctx.seed, ctx.device)
    readings["change_norms"] = prog.change_norms(p0)
    del p0
    free(ctx.device)
    return readings


def reference(ctx: RunContext, fam, pool, lowp: bool = False) -> dict:
    """The reference's readings (`lowp`: the control's) from the seed's
    weights on the compared batches."""
    w = wts.make(fam.param_spec(ctx.config), ctx.seed, ctx.device)
    out = fam.reference_readings(ctx.config, w, pool[:ctx.workload["compared_steps"]], lowp)
    del w
    free(ctx.device)
    return out


def run(ctx: RunContext) -> Outcome:
    wl, cfg, dev = ctx.workload, ctx.config, ctx.device
    fam, prog, pool, staged = build(ctx)
    # set-up: one pass over the pool, its first steps the compared ones
    readings = first_steps(ctx, fam, prog, staged)
    for b in staged[wl["compared_steps"]:]:
        prog.step(b)
    sync(dev)
    setup_s = time.perf_counter() - ctx.t0

    metrics, reading = {}, None
    losses, steps = [], 0
    if not ctx.trace:
        t0 = time.perf_counter()
        work = 0
        while time.perf_counter() - t0 < ctx.seconds:
            i = steps % len(staged)
            losses.append(prog.step(staged[i])["loss"])
            work += fam.tokens(pool[i], cfg)
            steps += 1
        sync(dev)
        window = time.perf_counter() - t0
        metrics = {"setup_s": setup_s, "train_tokens_per_s": work / window}
    else:
        peaks = peaks_for(torch.cuda.get_device_name(0)) if dev.startswith("cuda") else {}
        clock = spans.cuda_clock()
        with spans.timed_calls(prog.hooks(), clock) as marks:
            for _ in range(wl["trace_span_steps"]):
                losses.append(prog.step(staged[steps % len(staged)])["loss"])
                steps += 1
        sync(dev)
        ms = spans.ms(marks, clock)
        counters = {"span_steps": steps, "model_flops": 0.0, "attn_bound_s": 0.0}
        profiled_steps = []
        with profiled(lambda: sync(dev)) as out:
            for _ in range(wl["trace_profile_steps"]):
                profiled_steps.append(steps % len(staged))
                losses.append(prog.step(staged[profiled_steps[-1]])["loss"])
                steps += 1
        for i in profiled_steps:
            for k, v in fam.step_work(pool[i], cfg, peaks).items():
                counters[k] += v
        reading = Reading(spans=ms, counters=counters, trace=out["trace"], peaks=peaks)
    failed = sum(1 for x in losses if not torch.isfinite(x).item())
    overflow = prog.tables_overflowed()
    peak = memory_peak(dev)
    del prog, staged
    free(dev)

    compared = compare(readings, reference(ctx, fam, pool), wl["exclude_below"])
    compared["table_overflow"] = float(overflow)
    return Outcome(attempted=steps, failed=failed, metrics=metrics, compared=compared,
                   memory_peak_bytes=peak, reading=reading)

