"""Run one cell of the port's benchmark once, on the card this process sees.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's name in BENCHMARK.json leads to its files: bench_port/workloads/
<cell>.json (its driver and traffic, and the limits of the comparison),
bench_port/configs/<config>.json (the model and its family), and one reader
bench_port/metrics/<metric>.py per per-layer metric. With --trace 0 the
last line of standard output holds the cell's end-to-end metrics; with
--trace 1 its per-layer metrics and the profiled window's busy and window
seconds. Either way the run checks what its timed path produced against
the plain reference, and prints each number compared beside its limit, as
the last lines on standard error and last in the result line.

A run fails, and prints no result, without CUDA or with fewer cards than
the cell asks for, and if JAX or the JAX package was loaded. Kernel builds
stay inside the checkout (the port builds into recsys_examples_torch/
_build/; TORCH_EXTENSIONS_DIR and TRITON_CACHE_DIR point into
.bench_port_cache/), so only the first run of a checkout compiles. CPU
kernels run on one host thread."""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_port.core import cell as cells  # noqa: E402
from bench_port.core.checks import judge, passed, print_checks  # noqa: E402
from bench_port.core.guard import forbidden_loaded  # noqa: E402
from bench_port.core.runctx import RunContext  # noqa: E402


def _environment():
    """Kernel caches inside the checkout; one host thread for CPU kernels,
    so the process's own thread pools do not compete with the thread that
    feeds the card."""
    cache = ROOT / ".bench_port_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def execute(cell: cells.Cell, seed: int, seconds: float, trace: bool,
            device: str = "cuda") -> dict:
    """Drive the cell once and return its result (everything but the
    device's name and count, which `main` adds)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device.startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()
    ctx = RunContext(workload=cell.workload, config=cell.config, seed=seed, seconds=seconds,
                     trace=trace, device=device, t0=T0)
    out = cells.module("drivers", cell.workload["driver"]).run(ctx)
    checks = judge(out.compared, cell.workload["limits"])
    result = {"correct": passed(checks) and out.failed == 0,
              "attempted": out.attempted, "failed": out.failed}
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = cells.reader(m["name"])(out.reading)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        tr = out.reading.trace
        result["metrics"] = metrics
        result["device"] = {"memory_peak_bytes": out.memory_peak_bytes,
                            "busy_s": tr.busy_s, "window_s": tr.window_s}
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": [[n, s] for n, s in tr.idle_gaps]}
    else:
        result["metrics"] = {m["name"]: {"value": out.metrics[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end}
        result["device"] = {"memory_peak_bytes": out.memory_peak_bytes}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    cell = cells.resolve(args.workload)

    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"error: the cell needs {cell.chips} CUDA device(s); this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    result = execute(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_loaded()
    if bad:
        print(f"error: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 1
    # the cards the run used: those on which it allocated memory
    used = [i for i in range(torch.cuda.device_count()) if torch.cuda.max_memory_allocated(i)]
    # keeps its place in the line: "checks" stays last
    result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                        "count": len(used), **result["device"]}
    print_checks(result["checks"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
