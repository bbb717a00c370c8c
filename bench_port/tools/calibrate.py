"""Readings for the limits of a cell's comparison, on the card at the cell's
own size: the program's numbers over many seeds, the control's (the
reference computed with its products' operands in fp8, put in the
program's place) and, for a training cell, a planted fault's.

    python3 bench_port/tools/calibrate.py --workload <cell> --seeds 1,2,3
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--ticks 8]

One JSON line per seed and reading. Training: set-up and the compared steps
of a run, with no window; the fault leaves out half of every batch (the
mean taken over the rest). Serving: set-up and `--ticks` ticks of the
closed loop, then the drain and the run's sample; the control answering the
sample's requests by its own beam search. Not run by the benchmark's runs."""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_port.core import cell as cells  # noqa: E402
from bench_port.core import weights as wts  # noqa: E402
from bench_port.core.runctx import RunContext, free  # noqa: E402
from bench_port.drivers import serve, train  # noqa: E402


def train_seed(ctx, control: bool, fault: bool):
    fam, prog, pool, staged = train.build(ctx)
    got = train.first_steps(ctx, fam, prog, staged)
    del prog, staged
    free(ctx.device)
    want = train.reference(ctx, fam, pool)
    ex = ctx.workload["exclude_below"]
    yield "program", train.compare(got, want, ex)
    if control:
        yield "control", train.compare(train.reference(ctx, fam, pool, lowp=True), want, ex)
    if fault:
        prog = fam.Program(ctx.config, wts.make(fam.param_spec(ctx.config), ctx.seed,
                                                ctx.device), ctx.device)
        staged = [prog.stage(fam.half_batch(b, ctx.config))
                  for b in pool[:ctx.workload["compared_steps"]]]
        got = train.first_steps(ctx, fam, prog, staged)
        del prog, staged
        free(ctx.device)
        yield "half_batch", train.compare(got, want, ex)


def serve_seed(ctx, control: bool, ticks: int):
    import torch

    wl, cfg, dev = ctx.workload, ctx.config, ctx.device
    fam, prog, loop = serve.build(ctx)
    for _ in range(ticks):
        loop.tick(resubmit=True)
    loop.drain()
    checked = serve.sample(loop.answered, wl["check_requests"], ctx.seed)
    del prog, loop
    free(dev)
    w = serve.weights(ctx, fam)
    yield "program", fam.check(cfg, wl, w, checked)
    if control:
        ref = fam.ref
        lowp = ref.Qwen3Reference(cfg, w, lowp=True)
        ctl, k = [], wl["top_k"]
        for r in checked:
            # the control answers the same request by its own beam search
            last, kv = lowp.prefill(torch.as_tensor(r["context"], dtype=torch.int64,
                                                    device=dev))
            paths, scores = lowp.beam_search(last, kv, cfg["num_hierarchies"],
                                             wl["beam_width"])
            ctl.append(dict(r, paths=paths[:k].tolist(), scores=scores[:k].tolist()))
            del kv
        del lowp
        free(dev)
        yield "control", fam.check(cfg, wl, w, ctl)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--ticks", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = cells.resolve(args.workload)
    ints = lambda s: [int(x) for x in s.split(",") if x]
    controls, faults = set(ints(args.control_seeds)), set(ints(args.fault_seeds))
    for seed in ints(args.seeds):
        ctx = RunContext(workload=cell.workload, config=cell.config, seed=seed, seconds=0,
                         trace=False, device=args.device)
        t = time.perf_counter()
        if cell.workload["driver"] == "train":
            it = train_seed(ctx, seed in controls, seed in faults)
        else:
            it = serve_seed(ctx, seed in controls, args.ticks)
        for kind, numbers in it:
            print(json.dumps({"cell": cell.name, "seed": seed, "reading": kind, **numbers,
                              "s": round(time.perf_counter() - t, 1)}), flush=True)
        free(args.device)


if __name__ == "__main__":
    main()
