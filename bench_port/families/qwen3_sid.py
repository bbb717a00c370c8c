"""The Qwen3 SID beam-serving family: its weights, its requests, the program
under test (`GRContinuousScheduler` over `Qwen3ServingEngine` of
`recsys_examples_torch`), the work of a generate and of each K7 call, and
the comparison with the plain reference.

The program's modules are imported inside the functions that build it."""
from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch

from bench_port.reference import qwen3_ref as ref


def param_spec(cfg: dict):
    """(name, shape, init) of every parameter under the program's names:
    the embedding N(0, 1/hidden), every projection N(0, 1/fan_in), every
    norm weight N(1, 0.1^2)."""
    D, I, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    H, Hkv, dh = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    w = lambda fan_in: ("normal", fan_in ** -0.5)
    norm = ("normal", 0.1, 1.0)
    spec = [("embed_tokens.weight", (V, D), w(D))]
    for i in range(cfg["num_hidden_layers"]):
        pre = f"layers.{i}"
        spec += [(f"{pre}.input_layernorm", (D,), norm),
                 (f"{pre}.self_attn.q_proj.weight", (H * dh, D), w(D)),
                 (f"{pre}.self_attn.k_proj.weight", (Hkv * dh, D), w(D)),
                 (f"{pre}.self_attn.v_proj.weight", (Hkv * dh, D), w(D)),
                 (f"{pre}.self_attn.o_proj.weight", (D, H * dh), w(H * dh)),
                 (f"{pre}.self_attn.q_norm", (dh,), norm),
                 (f"{pre}.self_attn.k_norm", (dh,), norm),
                 (f"{pre}.post_attention_layernorm", (D,), norm),
                 (f"{pre}.mlp.gate_proj.weight", (I, D), w(D)),
                 (f"{pre}.mlp.up_proj.weight", (I, D), w(D)),
                 (f"{pre}.mlp.down_proj.weight", (D, I), w(I))]
    return spec + [("norm", (D,), norm)]


DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def weight_dtype(cfg: dict):
    return DTYPES[cfg["torch_dtype"]]


class Requests:
    """The request stream: context lengths from a fixed cycle of
    `length_cycle` lengths spread evenly over [ctx_min, ctx_max) and cut to
    whole items (multiples of `num_hierarchies`), each cycle in an order the
    seed draws; token ids uniform over the vocabulary. Every seed sends the
    same set of lengths."""

    def __init__(self, wl: dict, cfg: dict, seed: int):
        self.rng = np.random.default_rng(seed)
        lo, hi, n, H = wl["ctx_min"], wl["ctx_max"], wl["length_cycle"], cfg["num_hierarchies"]
        lens = lo + (np.arange(n) * (hi - lo)) // n
        self.cycle = np.maximum(lens - lens % H, H)
        self.vocab = cfg["vocab_size"]
        self.order: List[int] = []

    def next(self) -> np.ndarray:
        if not self.order:
            self.order = list(self.rng.permutation(self.cycle))
        return self.rng.integers(0, self.vocab, size=int(self.order.pop())).astype(np.int32)


def generate_flops(ctx_lens, width: int, steps: int, cfg: dict) -> float:
    """Model FLOPs of the valid work of one generate: the prefill's GEMMs
    and causal attention over the real context tokens and its head at the
    last position; each decode step's GEMMs over B x W rows, their attention
    to the context and the beam's earlier steps, and the tied head."""
    D, I, V, L = (cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"],
                  cfg["num_hidden_layers"])
    H, Hkv, dh = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    per_row = 2 * L * (D * H * dh + 2 * D * Hkv * dh + H * dh * D + 3 * D * I)
    n = np.asarray(ctx_lens, np.float64)
    B = len(n)
    flops = per_row * n.sum() + L * 4 * H * dh * (n * (n + 1) / 2).sum() + 2 * D * V * B
    for h in range(1, steps):
        rows = B * width
        flops += per_row * rows + L * 4 * H * dh * width * (n + h).sum() + 2 * D * V * rows
    return float(flops)


def k7_work(call) -> tuple:
    """(bytes, FLOPs) that one recorded K7 call must move and compute (the
    port's smoke script's `beam_work`, frozen): the valid context rows of K
    and V, q and out, the beam K/V rows the ancestry reaches, the indices;
    4 FLOPs per (query, key, head, dim) for the scores and P v."""
    (B, W, H, D), esz, S, Hkv, ctx_lens, N, anc = call
    ctx = int(ctx_lens.clamp(0, S).sum())
    nbytes = 2 * ctx * Hkv * D * esz + 2 * B * W * H * D * esz + B * 4
    if N:
        slots = anc.long() + W * torch.arange(B * N, device=anc.device).reshape(B, N, 1)
        nbytes += 2 * int(torch.unique(slots).numel()) * Hkv * D * esz + B * N * W * 4
    return nbytes, 4 * (ctx + B * N) * W * H * D


def k7_bound_s(calls, peaks: dict) -> float:
    """The least time the recorded K7 calls could take, call by call."""
    return sum(max(b / peaks["hbm_bytes_per_s"], f / peaks["bf16_flops"])
               for b, f in map(k7_work, calls))


class Program:
    """The port's Qwen3 model from the harness's weights, behind its serving
    engine and continuous scheduler."""

    def __init__(self, cfg: dict, wl: dict, weights: Dict[str, torch.Tensor], device):
        from recsys_examples_torch.inference.sid_serving.engine import (
            Qwen3ServingEngine, ServingConfig)
        from recsys_examples_torch.inference.sid_serving.scheduler import GRContinuousScheduler
        from recsys_examples_torch.models.qwen3 import Qwen3Config, Qwen3Model

        qcfg = Qwen3Config(
            vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
            num_layers=cfg["num_hidden_layers"], num_heads=cfg["num_attention_heads"],
            num_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
            intermediate_size=cfg["intermediate_size"], rms_norm_eps=cfg["rms_norm_eps"],
            rope_theta=float(cfg["rope_theta"]),
            tie_word_embeddings=cfg["tie_word_embeddings"], dtype=weight_dtype(cfg))
        model = Qwen3Model(qcfg, device="meta")
        model.load_state_dict(weights, strict=True, assign=True)
        self.cfg, self.wl = cfg, wl
        self.engine = Qwen3ServingEngine(
            model, ServingConfig(beam_width=wl["beam_width"],
                                 ctx_buckets=tuple(wl["ctx_buckets"]),
                                 batch_buckets=tuple(wl["batch_buckets"])),
            num_steps=cfg["num_hierarchies"])
        self.sched = GRContinuousScheduler(self.engine, max_batch=wl["max_batch"])

    def submit(self, context: np.ndarray) -> str:
        return self.sched.submit(context, top_k=self.wl["top_k"])

    def tick(self) -> int:
        return self.sched.tick()

    def take(self, rid: str):
        return self.sched.get_result(rid)

    def hooks(self):
        """(object, method names) whose calls the traced run times on the
        host: the scheduler's tick and the engine's generate."""
        return [(self.sched, ("tick",)), (self.engine, ("generate",))]

    @contextlib.contextmanager
    def recording(self):
        """Record, without device work, each generate's context lengths and
        each K7 call's shapes and index tensors; yields the dict that holds
        them."""
        from recsys_examples_torch.models import qwen3 as qm

        rec = {"generates": [], "k7": []}
        k7, gen = qm.beam_decode_attn, self.engine.generate

        def k7_rec(q, k_ctx, v_ctx, ctx_lens, k_beam, v_beam, anc, *a, **kw):
            rec["k7"].append((tuple(q.shape), q.element_size(), k_ctx.shape[1],
                              k_ctx.shape[2], ctx_lens, 0 if k_beam is None else k_beam.shape[1],
                              anc))
            return k7(q, k_ctx, v_ctx, ctx_lens, k_beam, v_beam, anc, *a, **kw)

        def gen_rec(contexts):
            rec["generates"].append([max(len(c), 1) for c in contexts])
            return gen(contexts)

        qm.beam_decode_attn, self.engine.generate = k7_rec, gen_rec
        try:
            yield rec
        finally:
            qm.beam_decode_attn = k7
            del self.engine.generate

    def work(self, rec: dict, peaks: dict) -> Dict[str, float]:
        """The counters of a recorded window: generates, their model FLOPs,
        and the least time K7's calls could take."""
        W, H = self.wl["beam_width"], self.cfg["num_hierarchies"]
        return {"generates": float(len(rec["generates"])),
                "model_flops": sum(generate_flops(g, W, H, self.cfg) for g in rec["generates"]),
                "k7_calls": float(len(rec["k7"])),
                "k7_bound_s": k7_bound_s(rec["k7"], peaks)}


def check(cfg: dict, wl: dict, weights, requests: List[dict]) -> Dict[str, float]:
    return ref.check(cfg, weights, requests, cfg["num_hierarchies"], wl["beam_width"])
