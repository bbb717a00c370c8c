"""Causal transformer decoder blocks for SID-GR, softmax attention
(counterpart of recsys_examples_tpu/modules/transformer.py).

SID sequences are short, so the decoder runs on the padded dense [B, N, D]
layout; the prefill's dense attention is plain PyTorch (it lies outside any
kernel in the JAX package too). A beam-decode step goes through
`ops.beam_decode_attention.beam_decode_attn` (kernel K7 on CUDA tensors).

Params keep flax's names (`q`, `k`, `v`, `proj`, `ln1`, `fc1`, ...; flax's
`layer_i` is `layers.i`), are fp32 and are cast to `dtype` inside the
forward, as flax's `dtype=` does. Scores accumulate in fp32, the softmax is
fp32, and P is cast to `dtype` before P.V. A masked score is -1e30, so a
fully masked padding row is a uniform average, not NaN.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from recsys_examples_torch.modules.attention_mask import padded_causal_mask
from recsys_examples_torch.modules.hstu_layer import LayerNorm
from recsys_examples_torch.modules.hstu_layer import dropout as apply_dropout
from recsys_examples_torch.modules.mlp import lecun_normal_
from recsys_examples_torch.ops.beam_decode_attention import beam_decode_attn

LN_EPS = 1e-6    # flax nn.LayerNorm's default
make_padded_causal_mask = padded_causal_mask    # the JAX module's name for it


@dataclasses.dataclass
class BeamAttnInputs:
    """Per-layer inputs of the fused beam-decode attention step."""
    k_ctx: torch.Tensor                 # [B, S, H, dh] prefill context keys
    v_ctx: torch.Tensor                 # [B, S, H, dh]
    ctx_lens: torch.Tensor              # [B]
    k_beam: Optional[torch.Tensor]      # [B, N, W, H, dh] previous decode steps
    v_beam: Optional[torch.Tensor]
    ancestry: Optional[torch.Tensor]    # [B, N, W]
    backend: str = "auto"


def dense(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax `Dense(dtype=...)`: input and fp32 params cast to `dtype`."""
    b = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), b)


@torch.no_grad()
def init_dense(lin: nn.Linear, generator: torch.Generator):
    """flax Dense's init: lecun normal kernel, zero bias."""
    lecun_normal_(lin.weight, lin.in_features, generator)
    if lin.bias is not None:
        lin.bias.zero_()


class MultiHeadAttention(nn.Module):
    def __init__(self, hidden: int, num_heads: int, head_dim: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.num_heads, self.head_dim, self.dtype = num_heads, head_dim, dtype
        inner = num_heads * head_dim
        self.q = nn.Linear(hidden, inner, device=device)
        self.k = nn.Linear(hidden, inner, device=device)
        self.v = nn.Linear(hidden, inner, device=device)
        self.proj = nn.Linear(inner, hidden, device=device)

    def init_weights(self, generator: torch.Generator):
        for lin in (self.q, self.k, self.v, self.proj):
            init_dense(lin, generator)

    def forward(
        self,
        x: torch.Tensor,                            # [B, Nq, D]
        kv_x: Optional[torch.Tensor] = None,        # [B, Nk, D] (defaults to x)
        mask: Optional[torch.Tensor] = None,        # [B, Nq, Nk] bool
        kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        return_kv: bool = False,
        beam_attn: Optional[BeamAttnInputs] = None,
    ):
        H, dh = self.num_heads, self.head_dim
        kv_x = x if kv_x is None else kv_x
        q = dense(self.q, x, self.dtype)
        k = dense(self.k, kv_x, self.dtype)
        v = dense(self.v, kv_x, self.dtype)
        if beam_attn is not None:
            # beam-decode step: x is [B, W, D]; the new token's own K/V is
            # appended as the last beam step with identity ancestry
            ba = beam_attn
            B, W = x.shape[:2]
            k_new = k.reshape(B, W, H, dh)
            v_new = v.reshape(B, W, H, dh)
            ident = torch.arange(W, dtype=torch.int32, device=x.device).expand(B, 1, W)
            if ba.k_beam is not None and ba.k_beam.shape[1] > 0:
                kb = torch.cat([ba.k_beam, k_new[:, None]], dim=1)
                vb = torch.cat([ba.v_beam, v_new[:, None]], dim=1)
                anc = torch.cat([ba.ancestry.to(torch.int32), ident], dim=1)
            else:
                kb, vb, anc = k_new[:, None], v_new[:, None], ident
            out = beam_decode_attn(
                q.reshape(B, W, H, dh), ba.k_ctx, ba.v_ctx, ba.ctx_lens, kb, vb, anc,
                sm_scale=1.0 / dh ** 0.5, backend=ba.backend,
            ).to(self.dtype)
            out = dense(self.proj, out.reshape(B, W, H * dh), self.dtype)
            return out, (k_new, v_new)
        B, Nq = x.shape[:2]
        q = q.reshape(B, Nq, H, dh)
        k = k.reshape(B, -1, H, dh)
        v = v.reshape(B, -1, H, dh)
        if kv_cache is not None:
            k = torch.cat([kv_cache[0], k], dim=1)
            v = torch.cat([kv_cache[1], v], dim=1)
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / (dh ** 0.5)
        if mask is not None:
            scores = torch.where(mask[:, None], scores, scores.new_full((), -1e30))
        p = torch.softmax(scores, dim=-1).to(self.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", p, v)
        out = dense(self.proj, out.reshape(B, Nq, H * dh), self.dtype)
        if return_kv:
            return out, (k, v)
        return out


class TransformerBlock(nn.Module):
    def __init__(self, hidden: int, num_heads: int, head_dim: int, ffn_hidden: int,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dropout, self.dtype = dropout, dtype
        self.ln1 = LayerNorm(hidden, LN_EPS, True, dtype, device)
        self.attn = MultiHeadAttention(hidden, num_heads, head_dim, dtype, device)
        self.ln2 = LayerNorm(hidden, LN_EPS, True, dtype, device)
        self.fc1 = nn.Linear(hidden, ffn_hidden, device=device)
        self.fc2 = nn.Linear(ffn_hidden, hidden, device=device)

    def init_weights(self, generator: torch.Generator):
        init_dense(self.fc1, generator)
        init_dense(self.fc2, generator)

    def forward(self, x, mask=None, kv_cache=None, return_kv=False, train=True,
                beam_attn=None, generator=None):
        drop = self.dropout > 0 and train
        attn = self.attn(self.ln1(x), mask=mask, kv_cache=kv_cache,
                         return_kv=return_kv, beam_attn=beam_attn)
        kv = None
        if return_kv or beam_attn is not None:
            attn, kv = attn
        if drop:
            attn = apply_dropout(attn, self.dropout, generator)
        x = x + attn
        h = dense(self.fc1, self.ln2(x), self.dtype)
        h = F.gelu(h, approximate="tanh")     # flax nn.gelu's default
        h = dense(self.fc2, h, self.dtype)
        if drop:
            h = apply_dropout(h, self.dropout, generator)
        x = x + h
        if kv is not None:
            return x, kv
        return x


class TransformerStack(nn.Module):
    def __init__(self, hidden: int, num_layers: int, num_heads: int, head_dim: int,
                 ffn_hidden: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerBlock(hidden, num_heads, head_dim, ffn_hidden, dropout, dtype, device)
            for _ in range(num_layers))
        self.final_ln = LayerNorm(hidden, LN_EPS, True, dtype, device)

    def forward(self, x, mask=None, kv_caches=None, return_kv=False, train=True,
                beam_attn: Optional[List[BeamAttnInputs]] = None, generator=None):
        new_kv = []
        for i, blk in enumerate(self.layers):
            cache = None if kv_caches is None else kv_caches[i]
            ba = None if beam_attn is None else beam_attn[i]
            out = blk(x, mask=mask, kv_cache=cache, return_kv=return_kv, train=train,
                      beam_attn=ba, generator=generator)
            if return_kv or ba is not None:
                x, kv = out
                new_kv.append(kv)
            else:
                x = out
        x = self.final_ln(x)
        if return_kv or beam_attn is not None:
            return x, new_kv
        return x
