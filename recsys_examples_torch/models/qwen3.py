"""Qwen3 decoder backbone for SID serving (counterpart of
recsys_examples_tpu/models/qwen3.py).

RMSNorm, per-head QK-norm then RoPE, GQA (num_kv_heads < num_heads), a
SwiGLU MLP and an optional tied embedding head.
  - `prefill`: a full causal pass over [B, N] token ids -> per-layer context
    KV and the last position's logits. Its attention is
    `ops.prefill_attention.prefill_attn`: kernel Q1 on CUDA tensors (a
    causal GQA flash attention that reads the kv heads where they lie and
    stops at each row's length), on CPU tensors the plain version (fp32
    scores, a -1e30 mask, an fp32 softmax, P cast to `dtype` before P.V), as
    the JAX package computes it outside any kernel.
  - `decode_step`: one beam step through `ops.beam_decode_attention.
    beam_decode_attn` (kernel K7 on CUDA tensors): the context KV is read once
    per batch row, the beam KV through ancestry indices, and the step's own
    k/v is appended as one more beam step with identity ancestry.

Submodules keep flax's names (`embed_tokens`, `layers.i` for flax's
`layer_i`, `self_attn.{q,k,v,o}_proj`, `q_norm`, `k_norm`, `mlp.{gate,up,
down}_proj`, `input_layernorm`, `post_attention_layernorm`, `norm`,
`lm_head`), except that flax's `embed_tokens.embedding` is
`embed_tokens.weight`; `convert.qwen3_state_dict` carries a flax tree
across. Params may be fp32 (flax's init) or bf16 (`load_hf_weights`); the
forward casts them to `config.dtype`, as flax's `dtype=` does.

`load_hf_weights` maps a HuggingFace Qwen3 checkpoint directory onto the
state_dict through a reader of the safetensors format written here with
torch and the standard library: no `safetensors` package, and bf16 without
numpy's help.
"""
from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from recsys_examples_torch.modules.mlp import lecun_normal_
from recsys_examples_torch.modules.transformer import BeamAttnInputs, dense
from recsys_examples_torch.ops.beam_decode_attention import beam_decode_attn
from recsys_examples_torch.ops.prefill_attention import prefill_attn
from recsys_examples_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Qwen3Config:
    """Defaults are Qwen3-1.7B's."""
    vocab_size: int = 151_936
    hidden_size: int = 2048
    num_layers: int = 28
    num_heads: int = 16
    num_kv_heads: int = 8
    head_dim: int = 128
    intermediate_size: int = 6144
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    tie_word_embeddings: bool = True
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def tiny(vocab_size: int = 512) -> "Qwen3Config":
        """Small config for tests."""
        return Qwen3Config(
            vocab_size=vocab_size, hidden_size=64, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=16,
            intermediate_size=128, dtype=torch.float32,
        )


def _rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 RMSNorm; the caller casts."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return x32 * torch.rsqrt(var + eps) * weight.float()


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """[.., P] int -> cos/sin [.., P, head_dim/2] (fp32)."""
    half = head_dim // 2
    freq = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=positions.device) / half))
    ang = positions.float()[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., P, H, D]; cos/sin [..., P, D/2]. HF's `rotate_half`: the first
    and second halves of the head dim are the rotation pairs."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    c, s = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def _linear(fan_in: int, fan_out: int, device) -> nn.Linear:
    return nn.Linear(fan_in, fan_out, bias=False, device=device)


class Qwen3Attention(nn.Module):
    def __init__(self, config: Qwen3Config, device=None):
        super().__init__()
        cfg = self.config = config
        H, Hkv, dh, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.hidden_size
        self.q_proj = _linear(D, H * dh, device)
        self.k_proj = _linear(D, Hkv * dh, device)
        self.v_proj = _linear(D, Hkv * dh, device)
        self.o_proj = _linear(H * dh, D, device)
        self.q_norm = nn.Parameter(torch.ones(dh, device=device))
        self.k_norm = nn.Parameter(torch.ones(dh, device=device))

    def forward(
        self,
        x: torch.Tensor,                          # [B, P, D], or [B, W, D] in decode
        positions: torch.Tensor,                  # [B, P] token positions
        lengths: Optional[torch.Tensor] = None,   # [B] valid positions (prefill)
        beam_ctx: Optional[BeamAttnInputs] = None,
    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        cfg = self.config
        H, Hkv, dh, dt = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.dtype
        B, P, _ = x.shape
        q = dense(self.q_proj, x, dt).reshape(B, P, H, dh)
        k = dense(self.k_proj, x, dt).reshape(B, P, Hkv, dh)
        v = dense(self.v_proj, x, dt).reshape(B, P, Hkv, dh)
        q = _rms_norm(q, self.q_norm, cfg.rms_norm_eps).to(dt)
        k = _rms_norm(k, self.k_norm, cfg.rms_norm_eps).to(dt)
        cos, sin = rope_cos_sin(positions, dh, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

        if beam_ctx is not None:
            # decode: P is the beam axis; this step's k/v joins the beam KV
            # as one more step whose ancestry is the identity
            W = P
            ident = torch.arange(W, device=x.device).expand(B, 1, W)
            if beam_ctx.k_beam is not None:
                kb = torch.cat([beam_ctx.k_beam, k[:, None]], dim=1)
                vb = torch.cat([beam_ctx.v_beam, v[:, None]], dim=1)
                anc = torch.cat([beam_ctx.ancestry.to(torch.int64), ident], dim=1)
            else:
                kb, vb, anc = k[:, None], v[:, None], ident
            out = beam_decode_attn(
                q, beam_ctx.k_ctx, beam_ctx.v_ctx, beam_ctx.ctx_lens, kb, vb, anc,
                sm_scale=dh ** -0.5).to(dt)
            return dense(self.o_proj, out.reshape(B, W, H * dh), dt), (k, v)

        # prefill: causal over each row's valid positions (query head h
        # reads kv head h // G)
        out = prefill_attn(q, k, v, lengths, dh ** -0.5)
        return dense(self.o_proj, out.reshape(B, P, H * dh), dt), (k, v)


class Qwen3MLP(nn.Module):
    def __init__(self, config: Qwen3Config, device=None):
        super().__init__()
        self.config = config
        D, I = config.hidden_size, config.intermediate_size
        self.gate_proj = _linear(D, I, device)
        self.up_proj = _linear(D, I, device)
        self.down_proj = _linear(I, D, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.config.dtype
        g = dense(self.gate_proj, x, dt)
        u = dense(self.up_proj, x, dt)
        return dense(self.down_proj, F.silu(g) * u, dt)


class Qwen3Layer(nn.Module):
    def __init__(self, config: Qwen3Config, device=None):
        super().__init__()
        self.config = config
        self.input_layernorm = nn.Parameter(torch.ones(config.hidden_size, device=device))
        self.self_attn = Qwen3Attention(config, device)
        self.post_attention_layernorm = nn.Parameter(
            torch.ones(config.hidden_size, device=device))
        self.mlp = Qwen3MLP(config, device)

    def forward(self, x, positions, lengths=None, beam_ctx=None):
        cfg = self.config
        h = _rms_norm(x, self.input_layernorm, cfg.rms_norm_eps).to(cfg.dtype)
        attn, kv = self.self_attn(h, positions, lengths=lengths, beam_ctx=beam_ctx)
        x = x + attn
        h = _rms_norm(x, self.post_attention_layernorm, cfg.rms_norm_eps).to(cfg.dtype)
        return x + self.mlp(h), kv


KV = Tuple[torch.Tensor, torch.Tensor]


class Qwen3Model(nn.Module):
    """Decoder stack with the prefill and beam-decode entry points. It lives
    on the card unless the caller passes a device."""

    def __init__(self, config: Qwen3Config, device="cuda"):
        super().__init__()
        cfg = self.config = config
        dev = resolve_device(device)
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, device=dev)
        self.layers = nn.ModuleList(Qwen3Layer(cfg, dev) for _ in range(cfg.num_layers))
        self.norm = nn.Parameter(torch.ones(cfg.hidden_size, device=dev))
        if not cfg.tie_word_embeddings:
            self.lm_head = _linear(cfg.hidden_size, cfg.vocab_size, dev)

    @property
    def device(self) -> torch.device:
        return self.norm.device

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "Qwen3Model":
        """Random params with flax's default init, drawn from `generator` (on
        its device): the embedding normal(1 / sqrt(hidden)), every Dense
        kernel lecun normal, every norm weight one."""
        emb = self.embed_tokens.weight
        emb.copy_(self.config.hidden_size ** -0.5 * torch.randn(
            emb.shape, generator=generator, device=generator.device))
        for m in self.modules():
            if isinstance(m, nn.Linear):
                lecun_normal_(m.weight, m.in_features, generator)
        for name, p in self.named_parameters():
            if name.endswith("norm"):
                p.fill_(1.0)
        return self

    def beam_layout(self):
        """Per layer: its kind and the row shapes of its state at one beam
        step, (k, v) [Hkv, dh] each (`qwen3_runtime`'s beam buffers)."""
        kv = (self.config.num_kv_heads, self.config.head_dim)
        return [("attn", (kv, kv))] * self.config.num_layers

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed_tokens.weight[tokens].to(self.config.dtype)

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        """fp32 logits: the tied head multiplies the fp32 normed h by the fp32
        embedding; an untied one rounds h to `dtype`, then computes in fp32."""
        cfg = self.config
        h = _rms_norm(h, self.norm, cfg.rms_norm_eps)
        if cfg.tie_word_embeddings:
            return h @ self.embed_tokens.weight.float().T
        return F.linear(h.to(cfg.dtype).float(), self.lm_head.weight.float())

    def prefill(self, tokens: torch.Tensor, lengths: torch.Tensor
                ) -> Tuple[torch.Tensor, List[KV]]:
        """tokens [B, N], lengths [B] -> (last_logits [B, V] fp32, ctx_kv: per
        layer (k, v) [B, N, Hkv, dh])."""
        B, N = tokens.shape
        dev = tokens.device
        x = self._embed(tokens)
        pos = torch.arange(N, device=dev)[None, :].expand(B, N)
        kvs = []
        for layer in self.layers:
            x, kv = layer(x, pos, lengths=lengths)
            kvs.append(kv)
        last = x[torch.arange(B, device=dev), (lengths - 1).clamp_min(0)]
        return self._logits(last), kvs

    def decode_step(
        self,
        tokens: torch.Tensor,        # [B, W] current beam tokens
        positions: torch.Tensor,     # [B, W] their positions
        ctx_kv: List[KV],
        ctx_lens: torch.Tensor,
        beam_kv: Optional[List[KV]],
        ancestry: Optional[torch.Tensor],
    ) -> Tuple[torch.Tensor, List[KV]]:
        """One beam step. Returns (logits [B, W, V] fp32, per-layer (k, v) of
        this step [B, W, Hkv, dh])."""
        x = self._embed(tokens)
        new_kv = []
        for li, layer in enumerate(self.layers):
            beam_ctx = BeamAttnInputs(
                k_ctx=ctx_kv[li][0], v_ctx=ctx_kv[li][1], ctx_lens=ctx_lens,
                k_beam=None if beam_kv is None else beam_kv[li][0],
                v_beam=None if beam_kv is None else beam_kv[li][1],
                ancestry=ancestry)
            x, kv = layer(x, positions, beam_ctx=beam_ctx)
            new_kv.append(kv)
        return self._logits(x), new_kv

    def forward(self, tokens, lengths):
        return self.prefill(tokens, lengths)


# ------------------------------------------------------------ weights

_HF_LAYER_MAP = {
    "self_attn.q_proj.weight": "self_attn.q_proj.weight",
    "self_attn.k_proj.weight": "self_attn.k_proj.weight",
    "self_attn.v_proj.weight": "self_attn.v_proj.weight",
    "self_attn.o_proj.weight": "self_attn.o_proj.weight",
    "self_attn.q_norm.weight": "self_attn.q_norm",
    "self_attn.k_norm.weight": "self_attn.k_norm",
    "mlp.gate_proj.weight": "mlp.gate_proj.weight",
    "mlp.up_proj.weight": "mlp.up_proj.weight",
    "mlp.down_proj.weight": "mlp.down_proj.weight",
    "input_layernorm.weight": "input_layernorm",
    "post_attention_layernorm.weight": "post_attention_layernorm",
}

# the safetensors format's names of the dtypes a Qwen3 checkpoint holds
_ST_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}


def _read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """One .safetensors file -> {name: CPU tensor}. The format: a little-endian
    u64 header length, a JSON header {name: {dtype, shape, data_offsets}},
    then the tensors' raw little-endian bytes."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(os.fstat(f.fileno()).st_size - 8 - n)
        f.readinto(data)
    raw = torch.frombuffer(data, dtype=torch.uint8) if data else torch.empty(0, dtype=torch.uint8)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name} has dtype {info['dtype']}, "
                             f"not one of {sorted(_ST_DTYPES)}")
        dtype = _ST_DTYPES[info["dtype"]]
        t = raw[begin:end]
        if begin % dtype.itemsize:   # a view must start on an element boundary
            t = t.clone()
        out[name] = t.view(dtype).reshape(info["shape"])
    return out


def load_hf_weights(path: str, cfg: Qwen3Config) -> Dict[str, torch.Tensor]:
    """A HuggingFace Qwen3 safetensors directory (every `*.safetensors` file,
    in sorted order) -> the port's state_dict, in `cfg.dtype`, on the CPU.
    HF's Linear weights are already nn.Linear's [out, in]."""
    tensors: Dict[str, torch.Tensor] = {}
    for f in sorted(f for f in os.listdir(path) if f.endswith(".safetensors")):
        tensors.update(_read_safetensors(os.path.join(path, f)))
    put = lambda t: t.to(cfg.dtype).clone()
    sd = {"embed_tokens.weight": put(tensors["model.embed_tokens.weight"]),
          "norm": put(tensors["model.norm.weight"])}
    if not cfg.tie_word_embeddings and "lm_head.weight" in tensors:
        sd["lm_head.weight"] = put(tensors["lm_head.weight"])
    for i in range(cfg.num_layers):
        for hf_key, name in _HF_LAYER_MAP.items():
            sd[f"layers.{i}.{name}"] = put(tensors[f"model.layers.{i}.{hf_key}"])
    return sd
