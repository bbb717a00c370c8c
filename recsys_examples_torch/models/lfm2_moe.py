"""LFM2-MoE decoder backbone for SID serving (HF `transformers`' `Lfm2Moe*`
classes; LFM2-24B-A2B by default). Port-only: the JAX package has no such
model.

Two layer kinds and two FFN kinds, on one residual stream:
  - a layer: h = x + op(rms(x, operator_norm)), out = h + ffn(rms(h,
    ffn_norm)); the final RMSNorm (`norm`, HF's `embedding_norm`) comes
    before the tied head.
  - op "conv" (gated short convolution): B, C, u = chunk3(in_proj(x)),
    z = B u, y_t = C_t (w_0 z_{t-L+1} + ... + w_{L-1} z_t) (depthwise and
    causal over L = `conv_L_cache` positions, zeros before position 0),
    then out_proj. Its per-position state is z.
  - op "full_attention": `Qwen3Attention` (QK-norm, RoPE by halves, causal
    GQA; kernel Q1 in prefill, K7 in decode). Its per-position state is
    (k, v).
  - ffn: a dense SwiGLU (w2(silu(w1 x) w3 x)) in the first
    `num_dense_layers` layers, the sparse expert layer (`ops/moe.py`) in the
    rest: sigmoid scores, top k of the scores plus `expert_bias`, weights
    from the unbiased scores, normalised, times `routed_scaling_factor`.

`prefill` and `decode_step` keep `Qwen3Model`'s contract, which
`qwen3_runtime.qwen3_generate_beam` drives: the context state of each layer
is (k, v) [B, N, Hkv, dh] for attention and (tail,) [B, L-1, D] for conv
(z at the context's last L-1 positions, zeros before position 0); each
decode step returns each layer's state of its own rows, (k, v) [B, W, Hkv,
dh] or (z,) [B, W, D], and reads the earlier steps' through the beam
ancestry (`beam_layout` tells the runtime the shapes). A conv layer reads
the previous L-1 z rows of each beam's own path: the context tail for the
first steps, then the beam slots through the ancestry, so no state is ever
reordered.

Each MoE layer keeps its experts stacked: `w13` [E, 2I, D] (gate rows, then
up rows) and `w2` [E, D, I], so loading copies nothing. The router's logits
are computed in fp32 from the bf16 normed input. Spans: `conv/layer` around
a conv layer's op (prefill and decode), `conv/state` around its state reads
in decode; `moe/route`, `moe/experts`, `moe/combine` in each MoE layer.
Counter `moe/routed_rows` (rows x top k)."""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from recsys_examples_torch.models.qwen3 import Qwen3Attention, Qwen3Model, _linear, _rms_norm
from recsys_examples_torch.modules.transformer import BeamAttnInputs, dense
from recsys_examples_torch.ops import moe
from recsys_examples_torch.ops.moe import grouped_gemm
from recsys_examples_torch.utils import observability
from recsys_examples_torch.utils.device import resolve_device
from recsys_examples_torch.utils.observability import named_scope

# LFM2-24B-A2B's `layer_types`: attention at 2, 6, ..., 38
LFM2_24B_LAYER_TYPES = tuple("full_attention" if i % 4 == 2 else "conv" for i in range(40))


@dataclasses.dataclass(frozen=True)
class Lfm2MoeConfig:
    """Defaults are LFM2-24B-A2B's (head_dim is hidden / heads, the family's
    convention; the head is tied). The attention fields keep
    `Qwen3Config`'s names, so `Qwen3Attention` takes this config."""
    vocab_size: int = 65_536
    hidden_size: int = 2048
    num_layers: int = 40
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 64
    intermediate_size: int = 11_776
    moe_intermediate_size: int = 1536
    num_experts: int = 64
    num_experts_per_tok: int = 4
    num_dense_layers: int = 2
    layer_types: Tuple[str, ...] = LFM2_24B_LAYER_TYPES
    conv_L_cache: int = 3
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    use_expert_bias: bool = True
    rms_norm_eps: float = 1e-5
    rope_theta: float = 1_000_000.0
    tie_word_embeddings: bool = True
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if len(self.layer_types) != self.num_layers:
            raise ValueError(f"{len(self.layer_types)} layer types for {self.num_layers} layers")
        if set(self.layer_types) - {"conv", "full_attention"}:
            raise ValueError(f"unknown layer types in {self.layer_types}")

    @staticmethod
    def tiny(vocab_size: int = 512) -> "Lfm2MoeConfig":
        """Small config for tests: both layer kinds, a dense and three MoE
        layers."""
        return Lfm2MoeConfig(
            vocab_size=vocab_size, hidden_size=64, num_layers=5, num_heads=4,
            num_kv_heads=2, head_dim=16, intermediate_size=96, moe_intermediate_size=32,
            num_experts=8, num_experts_per_tok=4, num_dense_layers=1,
            layer_types=("conv", "full_attention", "conv", "conv", "full_attention"),
            dtype=torch.float32)


class Lfm2ShortConv(nn.Module):
    def __init__(self, config: Lfm2MoeConfig, device=None):
        super().__init__()
        self.config = config
        D, L = config.hidden_size, config.conv_L_cache
        self.in_proj = _linear(D, 3 * D, device)
        self.conv = nn.Conv1d(D, D, L, groups=D, bias=False, device=device)  # weight [D, 1, L]
        self.out_proj = _linear(D, D, device)

    def _gates(self, x):
        b, c, u = dense(self.in_proj, x, self.config.dtype).chunk(3, dim=-1)
        return c, b * u

    def _out(self, c, acc):
        return dense(self.out_proj, (c.float() * acc).to(self.config.dtype), self.config.dtype)

    def prefill(self, x: torch.Tensor, lengths: torch.Tensor):
        """x [B, N, D] -> (out, tail [B, L-1, D]). Causal, so rows past a
        request's length never reach its valid positions."""
        L = self.config.conv_L_cache
        with named_scope("conv/layer"):
            c, z = self._gates(x)
            N = z.shape[1]
            zp = F.pad(z.float(), (0, 0, L - 1, 0))          # zeros before position 0
            w = self.conv.weight.float()[:, 0]                 # [D, L]
            acc = zp[:, L - 1:] * w[:, L - 1]
            for j in range(1, L):
                acc = acc + zp[:, L - 1 - j:L - 1 - j + N] * w[:, L - 1 - j]
            # z at positions len - L + 1 .. len - 1: index + L - 1 in zp
            idx = lengths[:, None] + torch.arange(L - 1, device=x.device)
            tail = torch.gather(zp, 1, idx[..., None].expand(-1, -1, z.shape[-1]))
            return self._out(c, acc), (tail.to(z.dtype),)

    def decode(self, x: torch.Tensor, tail: torch.Tensor, z_beam: Optional[torch.Tensor],
               ancestry: Optional[torch.Tensor]):
        """x [B, W, D] at beam step n + 1 (n = earlier steps in z_beam [B,
        n, W, D], ancestry [B, n, W]) -> (out, z [B, W, D])."""
        L = self.config.conv_L_cache
        B, W, D = x.shape
        n = 0 if z_beam is None else z_beam.shape[1]
        with named_scope("conv/layer"):
            c, z = self._gates(x)
            w = self.conv.weight.float()[:, 0]
            with named_scope("conv/state"):
                prev = []
                for j in range(1, L):          # position p - j: beam slot n - j
                    slot = n - j
                    if slot >= 0:
                        idx = ancestry[:, slot, :, None].expand(B, W, D)
                        prev.append(torch.gather(z_beam[:, slot], 1, idx))
                    else:
                        prev.append(tail[:, L - 1 + slot, None])
            acc = z.float() * w[:, L - 1]
            for j in range(1, L):
                acc = acc + prev[j - 1].float() * w[:, L - 1 - j]
            return self._out(c, acc), z


class Lfm2DenseFFN(nn.Module):
    def __init__(self, config: Lfm2MoeConfig, device=None):
        super().__init__()
        self.config = config
        D, I = config.hidden_size, config.intermediate_size
        self.w1 = _linear(D, I, device)
        self.w3 = _linear(D, I, device)
        self.w2 = _linear(I, D, device)

    def forward(self, x):
        dt = self.config.dtype
        return dense(self.w2, F.silu(dense(self.w1, x, dt)) * dense(self.w3, x, dt), dt)


class Lfm2SparseMoe(nn.Module):
    def __init__(self, config: Lfm2MoeConfig, device=None):
        super().__init__()
        self.config = config
        D, I, E = config.hidden_size, config.moe_intermediate_size, config.num_experts
        self.gate = _linear(D, E, device)
        self.expert_bias = nn.Parameter(torch.zeros(E, device=device))
        self.w13 = nn.Parameter(torch.empty(E, 2 * I, D, device=device))
        self.w2 = nn.Parameter(torch.empty(E, D, I, device=device))

    def forward(self, x):
        cfg = self.config
        dt, k, E = cfg.dtype, cfg.num_experts_per_tok, cfg.num_experts
        shape = x.shape
        x = x.reshape(-1, shape[-1]).to(dt)
        T = x.shape[0]
        with named_scope("moe/route"):
            weights, experts = moe.route(
                x, self.gate.weight, self.expert_bias if cfg.use_expert_bias else None, k,
                cfg.norm_topk_prob, cfg.routed_scaling_factor)
            order, offsets = moe.permute(experts, E)
            xs = x[order // k]
            scale = weights.reshape(-1)[order]
        observability.count("moe/routed_rows", T * k)
        with named_scope("moe/experts"):
            h = grouped_gemm(xs, self.w13.to(dt), offsets, "swiglu")
            y = grouped_gemm(h, self.w2.to(dt), offsets, "scatter", row_scale=scale,
                             dst_rows=order)
        with named_scope("moe/combine"):
            return moe.combine(y, T, dt).reshape(shape)


class Lfm2Layer(nn.Module):
    def __init__(self, config: Lfm2MoeConfig, index: int, device=None):
        super().__init__()
        self.config = config
        self.kind = "attn" if config.layer_types[index] == "full_attention" else "conv"
        D = config.hidden_size
        self.operator_norm = nn.Parameter(torch.ones(D, device=device))
        self.ffn_norm = nn.Parameter(torch.ones(D, device=device))
        if self.kind == "attn":
            self.self_attn = Qwen3Attention(config, device)
        else:
            self.conv = Lfm2ShortConv(config, device)
        self.feed_forward = (Lfm2DenseFFN(config, device) if index < config.num_dense_layers
                             else Lfm2SparseMoe(config, device))

    def _norm(self, x, w):
        return _rms_norm(x, w, self.config.rms_norm_eps).to(self.config.dtype)

    def _ffn(self, x):
        return x + self.feed_forward(self._norm(x, self.ffn_norm))

    def prefill(self, x, positions, lengths):
        h = self._norm(x, self.operator_norm)
        if self.kind == "attn":
            out, state = self.self_attn(h, positions, lengths=lengths)
        else:
            out, state = self.conv.prefill(h, lengths)
        return self._ffn(x + out), state

    def decode(self, x, positions, ctx, ctx_lens, beam, ancestry):
        h = self._norm(x, self.operator_norm)
        if self.kind == "attn":
            out, state = self.self_attn(h, positions, beam_ctx=BeamAttnInputs(
                k_ctx=ctx[0], v_ctx=ctx[1], ctx_lens=ctx_lens,
                k_beam=None if beam is None else beam[0],
                v_beam=None if beam is None else beam[1], ancestry=ancestry))
        else:
            out, z = self.conv.decode(h, ctx[0], None if beam is None else beam[0], ancestry)
            state = (z,)
        return self._ffn(x + out), state


State = Tuple[torch.Tensor, ...]


class Lfm2MoeModel(nn.Module):
    """Decoder stack with `Qwen3Model`'s prefill and beam-decode entry
    points. It lives on the card unless the caller passes a device."""

    def __init__(self, config: Lfm2MoeConfig, device="cuda"):
        super().__init__()
        cfg = self.config = config
        dev = resolve_device(device)
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, device=dev)
        self.layers = nn.ModuleList(Lfm2Layer(cfg, i, dev) for i in range(cfg.num_layers))
        self.norm = nn.Parameter(torch.ones(cfg.hidden_size, device=dev))
        if not cfg.tie_word_embeddings:
            self.lm_head = _linear(cfg.hidden_size, cfg.vocab_size, dev)

    device = Qwen3Model.device
    _embed = Qwen3Model._embed
    _logits = Qwen3Model._logits

    def beam_layout(self) -> List[Tuple[str, Tuple[Tuple[int, ...], ...]]]:
        """Per layer: its kind ("attn" or "conv") and the row shape of each
        tensor of its state at one beam step."""
        cfg = self.config
        kv = (cfg.num_kv_heads, cfg.head_dim)
        return [(l.kind, (kv, kv) if l.kind == "attn" else ((cfg.hidden_size,),))
                for l in self.layers]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "Lfm2MoeModel":
        """Random params for tests: the embedding normal(1 / sqrt(hidden)),
        every projection normal(1 / sqrt(fan in)), the expert bias
        normal(0.1), the conv kernel normal(1 / sqrt(L)), norms one."""
        dev = generator.device
        randn = lambda shape, std: std * torch.randn(shape, generator=generator, device=dev)
        for name, p in self.named_parameters():
            if name.endswith("norm"):
                p.fill_(1.0)
            elif name.endswith("expert_bias"):
                p.copy_(randn(p.shape, 0.1))
            elif name == "embed_tokens.weight":
                p.copy_(randn(p.shape, self.config.hidden_size ** -0.5))
            else:
                p.copy_(randn(p.shape, p.shape[-1] ** -0.5))
        return self

    def prefill(self, tokens: torch.Tensor, lengths: torch.Tensor
                ) -> Tuple[torch.Tensor, List[State]]:
        """tokens [B, N], lengths [B] -> (last_logits [B, V] fp32, per layer
        its context state: (k, v) [B, N, Hkv, dh] or (tail,) [B, L-1, D])."""
        B, N = tokens.shape
        dev = tokens.device
        x = self._embed(tokens)
        pos = torch.arange(N, device=dev)[None, :].expand(B, N)
        states = []
        for layer in self.layers:
            x, state = layer.prefill(x, pos, lengths)
            states.append(state)
        last = x[torch.arange(B, device=dev), (lengths - 1).clamp_min(0)]
        return self._logits(last), states

    def decode_step(
        self,
        tokens: torch.Tensor,        # [B, W] current beam tokens
        positions: torch.Tensor,     # [B, W] their positions
        ctx_state: List[State],
        ctx_lens: torch.Tensor,
        beam_state: Optional[List[State]],   # per layer, [B, n, W, ...] each
        ancestry: Optional[torch.Tensor],    # [B, n, W]
    ) -> Tuple[torch.Tensor, List[State]]:
        """One beam step. Returns (logits [B, W, V] fp32, per layer this
        step's state: (k, v) [B, W, Hkv, dh] or (z,) [B, W, D])."""
        x = self._embed(tokens)
        new = []
        for li, layer in enumerate(self.layers):
            x, state = layer.decode(x, positions, ctx_state[li], ctx_lens,
                                    None if beam_state is None else beam_state[li], ancestry)
            new.append(state)
        return self._logits(x), new
