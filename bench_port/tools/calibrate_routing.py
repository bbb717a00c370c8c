"""Readings of a planted routing fault for a cell whose backbone has sparse
expert layers (`recsys_examples_torch/ops/moe.py`), on the card at the
cell's own size: the program with its routing broken underneath, answered
and compared as `tools/calibrate.py` compares a sound program.

    python3 bench_port/tools/calibrate_routing.py --workload <cell> --seeds 1,2
        [--faults weights_from_biased,select_unbiased] [--ticks 2]

Faults: `weights_from_biased` takes each selected expert's weight from the
biased score (sigmoid + expert_bias) instead of the sigmoid alone;
`select_unbiased` selects the top k by the sigmoid alone, ignoring the
bias. One JSON line per seed and fault. Not run by the benchmark's runs."""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_port.core import cell as cells  # noqa: E402
from bench_port.core.runctx import RunContext, free  # noqa: E402
from bench_port.tools import calibrate  # noqa: E402

FAULTS = ("weights_from_biased", "select_unbiased")


def faulted_route(kind: str, route):
    """`route` (ops/moe.py's) with the fault `kind` planted."""
    import torch

    def call(x, gate_weight, expert_bias, top_k, norm_topk_prob=True, scaling=1.0):
        if kind == "select_unbiased":
            return route(x, gate_weight, None, top_k, norm_topk_prob, scaling)
        s = torch.sigmoid(x.float() @ gate_weight.float().T) + expert_bias.float()
        experts = torch.topk(s, top_k, dim=-1).indices
        w = s.gather(1, experts)
        if norm_topk_prob:
            w = w / (w.sum(-1, keepdim=True) + 1e-6)
        return w * scaling, experts
    return call


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", default=",".join(FAULTS))
    ap.add_argument("--ticks", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from recsys_examples_torch.ops import moe

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = cells.resolve(args.workload)
    route = moe.route
    for seed in [int(x) for x in args.seeds.split(",") if x]:
        for kind in [f for f in args.faults.split(",") if f]:
            if kind not in FAULTS:
                raise SystemExit(f"unknown fault {kind!r}")
            ctx = RunContext(workload=cell.workload, config=cell.config, seed=seed, seconds=0,
                             trace=False, device=args.device)
            t = time.perf_counter()
            moe.route = faulted_route(kind, route)
            try:
                numbers = dict(calibrate.serve_seed(ctx, control=False, ticks=args.ticks))
            finally:
                moe.route = route
            print(json.dumps({"cell": cell.name, "seed": seed, "reading": kind,
                              **numbers["program"], "s": round(time.perf_counter() - t, 1)}),
                  flush=True)
            free(args.device)


if __name__ == "__main__":
    main()
