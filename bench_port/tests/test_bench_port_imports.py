"""A run loads neither JAX nor the JAX package: every module of the harness
imported, and a tiny run of each driver made, in a fresh interpreter."""
import json
import subprocess
import sys

from bench_port.core import cell as cells
from bench_port.core.guard import forbidden_loaded

SCRIPT = r"""
import json, sys
sys.path.insert(0, {root!r})
import importlib, pkgutil
import bench_port.run
from bench_port.core import cell as cells
from bench_port.core.guard import forbidden_loaded
for pkg in ("core", "drivers", "families", "reference", "tools"):
    path = cells.BENCH_DIR / pkg
    for m in pkgutil.iter_modules([str(path)]):
        importlib.import_module(f"bench_port.{{pkg}}.{{m.name}}")
bench = cells.benchmark()
for m in bench["per_layer"]:
    cells.reader(m["name"])
from bench_port.tests import tiny
bench_port.run.execute(tiny.hstu(), 5, 0.5, False, device="cpu")
bench_port.run.execute(tiny.qwen3("qwen3_sid_ctx1k"), 5, 0.5, False, device="cpu")
print(json.dumps(forbidden_loaded()))
"""


def test_guard_compares_whole_top_level_names():
    assert forbidden_loaded(["recsys_examples_torch", "recsys_examples_torch.ops",
                             "jaxtyping", "flaxen.x"]) == []
    assert forbidden_loaded(["jax.numpy", "recsys_examples_tpu", "flax", "jaxlib.x"]) == \
        ["flax", "jax.numpy", "jaxlib.x", "recsys_examples_tpu"]


def test_a_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(root=str(cells.ROOT))],
                         capture_output=True, text=True, timeout=600, cwd=cells.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
