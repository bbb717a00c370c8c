"""The LFM2-MoE SID beam-serving family: its weights, its requests (as the
Qwen3 family's), the program under test (`GRContinuousScheduler` over
`Qwen3ServingEngine` of `recsys_examples_torch`, on `Lfm2MoeModel`), the
work of a generate, of each K7 call and of each grouped-GEMM launch, and
the comparison with the plain reference.

The program's modules are imported inside the functions that build it."""
from __future__ import annotations

import contextlib
from typing import Dict, List

import torch

from bench_port.families import qwen3_sid
from bench_port.reference import lfm2_moe_ref as ref

Requests = qwen3_sid.Requests
weight_dtype = qwen3_sid.weight_dtype
k7_bound_s = qwen3_sid.k7_bound_s


def param_spec(cfg: dict):
    """(name, shape, init) of every parameter under the program's names:
    the embedding N(0, 1/hidden), every projection and expert matrix
    N(0, 1/fan_in), the conv kernels N(0, 1/L), every norm weight N(1,
    0.1^2), the expert bias N(expert_bias_mean, expert_bias_std^2).

    The matrices that write a residual branch back are drawn smaller: the
    operators' (conv out_proj, attention o_proj) at init_operator_out_scale
    times N(0, 1/fan_in), the FFNs' (dense and expert w2) at
    init_ffn_out_scale times it. At full scale each layer outweighs the
    embedding and the one before it, so a bf16 rounding that flips one
    router's top k (about 2% of rows a layer) grows into a different
    answer; drawn small, the embedding keeps a share of the residual stream
    and a flip stays a small change. The bias's mean changes no selection
    (top k of s + bias is the same under a shift) and no weight of a sound
    layer; near the selected experts' scores it makes weights taken from
    the biased scores far off."""
    D, V, L = cfg["hidden_size"], cfg["vocab_size"], cfg["conv_L_cache"]
    H, Hkv, dh = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    I, Im, E = cfg["intermediate_size"], cfg["moe_intermediate_size"], cfg["num_experts"]
    w = lambda fan_in, scale=1.0: ("normal", scale * fan_in ** -0.5)
    a_op, a_ffn = cfg["init_operator_out_scale"], cfg["init_ffn_out_scale"]
    norm = ("normal", 0.1, 1.0)
    spec = [("embed_tokens.weight", (V, D), w(D))]
    for i, kind in enumerate(cfg["layer_types"]):
        pre = f"layers.{i}"
        spec += [(f"{pre}.operator_norm", (D,), norm), (f"{pre}.ffn_norm", (D,), norm)]
        if kind == "full_attention":
            spec += [(f"{pre}.self_attn.q_proj.weight", (H * dh, D), w(D)),
                     (f"{pre}.self_attn.k_proj.weight", (Hkv * dh, D), w(D)),
                     (f"{pre}.self_attn.v_proj.weight", (Hkv * dh, D), w(D)),
                     (f"{pre}.self_attn.o_proj.weight", (D, H * dh), w(H * dh, a_op)),
                     (f"{pre}.self_attn.q_norm", (dh,), norm),
                     (f"{pre}.self_attn.k_norm", (dh,), norm)]
        else:
            spec += [(f"{pre}.conv.in_proj.weight", (3 * D, D), w(D)),
                     (f"{pre}.conv.conv.weight", (D, 1, L), w(L)),
                     (f"{pre}.conv.out_proj.weight", (D, D), w(D, a_op))]
        ff = f"{pre}.feed_forward"
        if i < cfg["num_dense_layers"]:
            spec += [(f"{ff}.w1.weight", (I, D), w(D)), (f"{ff}.w3.weight", (I, D), w(D)),
                     (f"{ff}.w2.weight", (D, I), w(I, a_ffn))]
        else:
            spec += [(f"{ff}.gate.weight", (E, D), w(D)),
                     (f"{ff}.expert_bias", (E,),
                      ("normal", cfg["expert_bias_std"], cfg["expert_bias_mean"])),
                     (f"{ff}.w13", (E, 2 * Im, D), w(D)),
                     (f"{ff}.w2", (E, D, Im), w(Im, a_ffn))]
    return spec + [("norm", (D,), norm)]


def row_macs(cfg: dict) -> int:
    """Multiply-adds of one row through every layer's projections, the conv
    kernels, the dense FFNs, the routers and the k selected experts, and
    the tied head (attention's scores and P v are counted apart)."""
    D, V, L = cfg["hidden_size"], cfg["vocab_size"], cfg["conv_L_cache"]
    H, Hkv, dh = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    I, Im, E = cfg["intermediate_size"], cfg["moe_intermediate_size"], cfg["num_experts"]
    k = cfg["num_experts_per_tok"]
    macs = D * V
    for i, kind in enumerate(cfg["layer_types"]):
        macs += (D * (H * dh + 2 * Hkv * dh) + H * dh * D if kind == "full_attention"
                 else 3 * D * D + L * D + D * D)
        macs += 3 * D * I if i < cfg["num_dense_layers"] else D * E + k * 3 * D * Im
    return macs


def generate_flops(ctx_lens, width: int, steps: int, cfg: dict) -> float:
    """Model FLOPs of the valid work of one generate: the prefill's rows
    over the real context tokens, with causal attention in the attention
    layers, and its head at the last position only; each decode step's B x W
    rows, their attention to the context and the beam's earlier steps."""
    D, V = cfg["hidden_size"], cfg["vocab_size"]
    H, dh = cfg["num_attention_heads"], cfg["head_dim"]
    A = sum(t == "full_attention" for t in cfg["layer_types"])
    per_row = 2 * row_macs(cfg)
    n = [float(x) for x in ctx_lens]
    B = len(n)
    flops = (per_row - 2 * D * V) * sum(n) + A * 4 * H * dh * sum(x * (x + 1) / 2 for x in n) \
        + 2 * D * V * B
    for h in range(1, steps):
        flops += per_row * B * width + A * 4 * H * dh * width * sum(x + h for x in n)
    return float(flops)


def gemm_work(call) -> tuple:
    """(bytes, FLOPs) that one recorded grouped-GEMM launch must move and
    compute: the weights of the experts it touches (rows > 0), its rows in
    and out (bf16), the scatter's weights and destinations; 2 rows K N
    FLOPs over the N weight rows."""
    offsets, (M, N, K, N_out, scatter) = call
    counts = offsets[1:] - offsets[:-1]
    touched = int((counts > 0).sum())
    nbytes = 2 * touched * N * K + 2 * M * K + 2 * M * N_out + (12 * M if scatter else 0)
    return nbytes, 2 * M * K * N


def moe_gemm_bound_s(calls, peaks: dict) -> float:
    """The least time the recorded grouped-GEMM launches could take, launch
    by launch."""
    return sum(max(b / peaks["hbm_bytes_per_s"], f / peaks["bf16_flops"])
               for b, f in map(gemm_work, calls))


class Program(qwen3_sid.Program):
    """The port's LFM2-MoE model from the harness's weights, behind the
    Qwen3 serving engine and the continuous scheduler."""

    def __init__(self, cfg: dict, wl: dict, weights: Dict[str, torch.Tensor], device):
        from recsys_examples_torch.inference.sid_serving.engine import (
            Qwen3ServingEngine, ServingConfig)
        from recsys_examples_torch.inference.sid_serving.scheduler import GRContinuousScheduler
        from recsys_examples_torch.models.lfm2_moe import Lfm2MoeConfig, Lfm2MoeModel

        mcfg = Lfm2MoeConfig(
            vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
            num_layers=cfg["num_hidden_layers"], num_heads=cfg["num_attention_heads"],
            num_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
            intermediate_size=cfg["intermediate_size"],
            moe_intermediate_size=cfg["moe_intermediate_size"],
            num_experts=cfg["num_experts"], num_experts_per_tok=cfg["num_experts_per_tok"],
            num_dense_layers=cfg["num_dense_layers"], layer_types=tuple(cfg["layer_types"]),
            conv_L_cache=cfg["conv_L_cache"], norm_topk_prob=cfg["norm_topk_prob"],
            routed_scaling_factor=float(cfg["routed_scaling_factor"]),
            use_expert_bias=cfg["use_expert_bias"], rms_norm_eps=cfg["norm_eps"],
            rope_theta=float(cfg["rope_parameters"]["rope_theta"]),
            tie_word_embeddings=cfg["tie_word_embeddings"], dtype=weight_dtype(cfg))
        model = Lfm2MoeModel(mcfg, device="meta")
        model.load_state_dict(weights, strict=True, assign=True)
        self.cfg, self.wl = cfg, wl
        self.engine = Qwen3ServingEngine(
            model, ServingConfig(beam_width=wl["beam_width"],
                                 ctx_buckets=tuple(wl["ctx_buckets"]),
                                 batch_buckets=tuple(wl["batch_buckets"])),
            num_steps=cfg["num_hierarchies"])
        self.sched = GRContinuousScheduler(self.engine, max_batch=wl["max_batch"])

    @contextlib.contextmanager
    def recording(self):
        """The Qwen3 family's recording (generates' lengths, K7 calls), and
        each grouped-GEMM launch's expert offsets and shape, kept on the
        device until `work` reads them."""
        from recsys_examples_torch.models import lfm2_moe as lm

        gg = lm.grouped_gemm

        with super().recording() as rec:
            rec["gemm"] = []

            def gg_rec(a, w, offsets, mode, *args, **kw):
                out = gg(a, w, offsets, mode, *args, **kw)
                rec["gemm"].append((offsets, (a.shape[0], w.shape[1], w.shape[2],
                                              out.shape[1], mode == "scatter")))
                return out

            lm.grouped_gemm = gg_rec
            try:
                yield rec
            finally:
                lm.grouped_gemm = gg

    def work(self, rec: dict, peaks: dict) -> Dict[str, float]:
        """The counters of a recorded window: generates, their model FLOPs,
        the least time of K7's calls and of the grouped-GEMM launches."""
        W, H = self.wl["beam_width"], self.cfg["num_hierarchies"]
        calls = [(o.to("cpu", torch.int64), shape) for o, shape in rec["gemm"]]
        return {"generates": float(len(rec["generates"])),
                "model_flops": sum(generate_flops(g, W, H, self.cfg) for g in rec["generates"]),
                "k7_calls": float(len(rec["k7"])),
                "k7_bound_s": k7_bound_s(rec["k7"], peaks),
                "moe_gemm_launches": float(len(calls)),
                "moe_gemm_bound_s": moe_gemm_bound_s(calls, peaks)}


def check(cfg: dict, wl: dict, weights, requests: List[dict]) -> Dict[str, float]:
    return ref.check(cfg, weights, requests, cfg["num_hierarchies"], wl["beam_width"])
