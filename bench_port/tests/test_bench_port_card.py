"""On the card, at each cell's own size: one seed of the program passes the
cell's limits and the control (the reference with its products' operands
in fp8, in the program's place) fails them. Skips without a CUDA device.

    python -m pytest bench_port/tests/test_bench_port_card.py -q"""
import pytest

from bench_port.core import cell as cells
from bench_port.core.checks import judge, passed
from bench_port.core.runctx import RunContext
from bench_port.tools import calibrate

CELLS = [w["name"] for w in cells.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_program_passes_and_control_fails_at_the_cells_size(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    c = cells.resolve(name)
    ctx = RunContext(workload=c.workload, config=c.config, seed=2**31 + 7, seconds=0,
                     trace=False, device="cuda")
    if c.workload["driver"] == "train":
        readings = dict(calibrate.train_seed(ctx, control=True, fault=False))
    else:
        readings = dict(calibrate.serve_seed(ctx, control=True, ticks=2))
    limits = {k: v for k, v in c.workload["limits"].items() if k != "table_overflow"}
    assert passed(judge(readings["program"], limits)), readings
    assert not passed(judge(readings["control"], limits)), readings
