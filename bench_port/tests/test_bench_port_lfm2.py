"""The LFM2-MoE serving cell on the CPU at a tiny size: its weights load the
program strictly on `meta`, a sound run is correct and the control and the
planted routing faults are not, the work counts by hand, and the cell's
new readers."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_port import run
from bench_port.core import cell as cells
from bench_port.core import weights as wts
from bench_port.core.checks import judge, passed
from bench_port.core.runctx import Reading, RunContext
from bench_port.core.trace import Kernel, Trace
from bench_port.families import lfm2_moe_sid as fam
from bench_port.reference import lfm2_moe_ref
from bench_port.tests import tiny
from bench_port.tools import calibrate, calibrate_routing

SEED = 2**31 + 4321
NAME = "lfm2_sid_beam256"


def small() -> cells.Cell:
    """The cell cut to 5 layers of width 64 (3 MoE layers of 8 experts, the
    cell's top 4). The expert bias is drawn wider than the cell's, and the
    residual branches at full scale: at 3 MoE layers against its 38 a
    faulted routing moves the scores less, and 5 layers do not grow bf16
    rounding through their routers, which the cell's smaller branches are
    drawn against. The limits are the Qwen3 cells'."""
    return tiny._scaled(NAME, {
        "vocab_size": 512, "hidden_size": 64, "num_hidden_layers": 5,
        "layer_types": ["conv", "full_attention", "conv", "conv", "full_attention"],
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
        "intermediate_size": 96, "moe_intermediate_size": 32, "num_experts": 8,
        "num_dense_layers": 1, "expert_bias_std": 0.5, "init_operator_out_scale": 1.0,
        "init_ffn_out_scale": 1.0},
        {"callers": 4, "max_batch": 2, "ctx_min": 8, "ctx_max": 40, "length_cycle": 8,
         "beam_width": 16, "ctx_buckets": [64], "batch_buckets": [1, 2], "warm_ticks": 2,
         "check_requests": 3, "limits": {"score_gap": 0.45, "rank_gap": 0.65}})


def test_param_spec_loads_the_model_strictly_on_meta():
    c = small()
    prog = fam.Program(c.config, c.workload, wts.make(fam.param_spec(c.config), 1, "cpu"),
                       "cpu")
    names = {n for n, _, _ in fam.param_spec(c.config)}
    assert names == set(prog.engine.model.state_dict())
    assert prog.engine.model.layers[2].feed_forward.w13.device.type == "cpu"


def test_sound_run_is_correct():
    res = run.execute(small(), SEED, 0.5, False, device="cpu")
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("kind", calibrate_routing.FAULTS)
def test_routing_faults_are_not_correct(kind, monkeypatch):
    from recsys_examples_torch.ops import moe

    monkeypatch.setattr(moe, "route", calibrate_routing.faulted_route(kind, moe.route))
    res = run.execute(small(), SEED, 0.3, False, device="cpu")
    assert not res["correct"], res["checks"]


def test_control_is_not_correct():
    c = small()
    ctx = RunContext(workload=c.workload, config=c.config, seed=SEED, seconds=0,
                     trace=False, device="cpu")
    readings = dict(calibrate.serve_seed(ctx, control=True, ticks=2))
    assert passed(judge(readings["program"], c.workload["limits"])), readings
    assert not passed(judge(readings["control"], c.workload["limits"])), readings


def test_row_macs_by_hand_at_the_published_widths():
    cfg = cells.resolve(NAME).config
    D, V = 2048, 65536
    conv = 3 * D * D + 3 * D + D * D
    attn = D * (32 * 64 + 2 * 8 * 64) + 32 * 64 * D
    dense = 3 * D * 11776
    moe = D * 64 + 4 * 3 * D * 1536
    assert fam.row_macs(cfg) == D * V + 30 * conv + 10 * attn + 2 * dense + 38 * moe
    assert round(fam.row_macs(cfg) / 1e9, 2) == 2.33 and round(38 * moe / 1e9, 2) == 1.44


def test_generate_flops_decode_step_counts_the_reference():
    """One decode step's FLOPs against the reference's own products over W
    rows of one token (the conv taps are elementwise: not seen by the flop
    counter, counted apart)."""
    c = small().config
    w = wts.make(fam.param_spec(c), 3, "cpu")
    ref = lfm2_moe_ref.Lfm2MoeReference(c, w)
    n, W = 12, 5
    _, state = ref.prefill(torch.arange(n))
    with FlopCounterMode(display=False) as fc:
        ref.extend(state, torch.zeros(W, 1, dtype=torch.int64), last_only=True)
    taps = 2 * W * c["conv_L_cache"] * c["hidden_size"] * c["layer_types"].count("conv")
    assert fc.get_total_flops() + taps == (fam.generate_flops([n], W, 2, c)
                                           - fam.generate_flops([n], W, 1, c))


def test_gemm_work_by_hand():
    offsets = torch.tensor([0, 0, 5, 5, 9])           # experts 1 and 3 hit
    nbytes, flops = fam.gemm_work((offsets, (9, 64, 32, 32, False)))
    assert nbytes == 2 * 2 * 64 * 32 + 2 * 9 * 32 + 2 * 9 * 32 and flops == 2 * 9 * 32 * 64
    nbytes, _ = fam.gemm_work((offsets, (9, 32, 16, 32, True)))
    assert nbytes == 2 * 2 * 32 * 16 + 2 * 9 * 16 + 2 * 9 * 32 + 12 * 9


def reading(kernels, **counters):
    tr = Trace(kernels=[Kernel(n, s, d, sc) for n, s, d, sc in kernels], window_s=1e-3,
               busy_s=1e-4, idle_gaps=[])
    return Reading(spans={}, counters=counters, trace=tr, peaks={})


@pytest.mark.parametrize("metric", ["moe_ms.serve", "moe_gemm_roofline.serve", "conv_ms.serve"])
def test_new_readers(metric):
    read = cells.reader(metric)
    qwen3_like = [("gemm", 0.0, 10.0, ("qwen3/decode_1",))]
    assert read(reading(qwen3_like, generates=1.0)) is None
    assert read(Reading(spans={}, counters={}, trace=None, peaks={})) is None
    lfm2 = qwen3_like + [
        ("moe_grouped_gemm_kernel", 20.0, 30.0, ("qwen3/decode_1", "moe/experts")),
        ("index", 50.0, 5.0, ("qwen3/decode_1", "moe/route")),
        ("gather", 60.0, 4.0, ("qwen3/decode_1", "conv/layer", "conv/state")),
        ("mul", 70.0, 6.0, ("qwen3/decode_1", "conv/layer"))]
    got = read(reading(lfm2, generates=2.0, moe_gemm_bound_s=15e-6))
    want = {"moe_ms.serve": 35e-3 / 2, "moe_gemm_roofline.serve": 50.0,
            "conv_ms.serve": 10e-3 / 2}[metric]
    assert got == pytest.approx(want)


def test_idle_readers_charge_moe_and_conv_apart_from_decode():
    """Each idle gap goes to the innermost span of the operation after it:
    the MoE's and the conv's to their own readers, not to the decode
    step's."""
    from recsys_examples_torch.utils import observability as obs

    obs.reset()
    with obs.tracing():
        with obs.named_scope("qwen3/decode_1"):
            for name in ("moe/experts", "moe/route", "conv/layer", "conv/state"):
                with obs.named_scope(name):
                    pass
    r = reading([("gemm", 0.0, 10.0, ("qwen3/decode_1",)),
                 ("moe_grouped_gemm_kernel", 20.0, 30.0, ("qwen3/decode_1", "moe/experts")),
                 ("index", 50.0, 5.0, ("qwen3/decode_1", "moe/route")),
                 ("gather", 60.0, 4.0, ("qwen3/decode_1", "conv/layer", "conv/state")),
                 ("mul", 70.0, 6.0, ("qwen3/decode_1", "conv/layer")),
                 ("add", 80.0, 2.0, ("qwen3/decode_1",))], generates=2.0)
    try:
        got = {n: cells.reader(n)(r) for n in ("moe_idle_ms.serve", "conv_idle_ms.serve",
                                               "decode_idle_ms.serve")}
    finally:
        obs.reset()
    assert got == pytest.approx({"moe_idle_ms.serve": 10e-3 / 2,      # 10 -> 20
                                 "conv_idle_ms.serve": 11e-3 / 2,     # 55 -> 60, 64 -> 70
                                 "decode_idle_ms.serve": 4e-3 / 2})   # 76 -> 80
