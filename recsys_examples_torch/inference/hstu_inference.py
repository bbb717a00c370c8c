"""HSTU inference with a user-keyed KV cache, delta-q path (counterpart of
recsys_examples_tpu/inference/hstu_inference.py).

Only the new (uncached) tokens run through the network; each layer hands
back its new K/V for the cache append and attends the new queries over
[cached ++ new]. The paged path reads cached K/V straight from the page pool
(`ops.paged_hstu_attention`: the CUDA kernel on the card, its plain version
on the CPU); the gather path takes densely gathered K/V and runs
`delta_attention`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from recsys_examples_torch.modules.config import HSTUConfig
from recsys_examples_torch.modules.hstu_layer import LayerNorm
from recsys_examples_torch.ops.paged_hstu_attention import (
    paged_hstu_delta_attention,
)


def delta_attention(
    q: torch.Tensor,        # [B, S, H, dh] new-token queries
    k: torch.Tensor,        # [B, N, H, dh] full keys (cached ++ new, padded)
    v: torch.Tensor,        # [B, N, H, dh]
    q_pos: torch.Tensor,    # [B, S] global position of each new token
    kv_len: torch.Tensor,   # [B] total valid keys
    num_targets: Optional[torch.Tensor],
    alpha: float,
    scaling_seqlen: int,
) -> torch.Tensor:
    """SiLU delta attention of the new queries over the full sequence
    (plain PyTorch; the gather path's attention)."""
    B, S, H, dh = q.shape
    N = k.shape[1]
    sc = torch.einsum("bshd,bnhd->bhsn", q.float(), k.float()) * alpha
    p = F.silu(sc) * (1.0 / scaling_seqlen)
    col = torch.arange(N, device=q.device)[None, None, :]     # [1, 1, N]
    row = q_pos.to(torch.int64)[:, :, None]                   # [B, S, 1]
    kv_len = kv_len.to(torch.int64)
    if num_targets is not None:
        hist_end = (kv_len - num_targets.to(torch.int64))[:, None, None]
        rowc = torch.minimum(row, hist_end)
        colc = torch.minimum(col, hist_end)
    else:
        rowc, colc = row, col
    valid = (col == row) | (rowc - colc > 0)
    valid = valid & (col < kv_len[:, None, None])
    p = p * valid[:, None].to(p.dtype)
    out = torch.einsum("bhsn,bnhd->bshd", p.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


class PagedHSTUInferLayer(nn.Module):
    """One HSTU layer, inference path. Parameter names and shapes follow the
    flax layer (the uvqk kernel stays chunked [D, 4, H*dh]), so converting
    params is a plain copy (and a transpose for `linear_proj`)."""

    def __init__(self, config: HSTUConfig, device=None):
        super().__init__()
        cfg = self.config = config
        D, HD = cfg.hidden_size, cfg.num_attention_heads * cfg.kv_channels
        self.input_layernorm = LayerNorm(
            D, cfg.layernorm_epsilon, cfg.learnable_input_layernorm,
            cfg.dtype, device,
        )
        self.uvqk_kernel = nn.Parameter(torch.empty(D, 4, HD, device=device))
        self.uvqk_bias = (
            nn.Parameter(torch.zeros(4, HD, device=device))
            if cfg.add_uvqk_bias else None
        )
        self.output_layernorm = LayerNorm(
            HD, cfg.layernorm_epsilon, cfg.learnable_output_layernorm,
            cfg.dtype, device,
        )
        self.linear_proj = nn.Linear(HD, D, bias=False, device=device)

    def forward(
        self,
        x: torch.Tensor,                    # [B, S, D] new tokens
        cached_k: Optional[torch.Tensor],   # [B, Nc, H, dh] (gather path)
        cached_v: Optional[torch.Tensor],
        cached_len: torch.Tensor,           # [B] int32
        new_lens: torch.Tensor,             # [B] int32 valid new tokens
        num_targets: Optional[torch.Tensor],
        scaling_seqlen: int,
        paged: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
    ):
        cfg = self.config
        H, dh, D = cfg.num_attention_heads, cfg.kv_channels, cfg.hidden_size
        B, S, _ = x.shape
        normed = self.input_layernorm(x)
        # one GEMM over the four contiguous chunks [u | v | q | k], in cfg.dtype
        w = self.uvqk_kernel.to(cfg.dtype).reshape(D, 4 * H * dh)
        y = torch.matmul(normed, w).reshape(B, S, 4, H * dh)
        if self.uvqk_bias is not None:
            y = y + self.uvqk_bias.to(cfg.dtype)
        y = F.silu(y)
        u = y[:, :, 0]
        v_new = y[:, :, 1].reshape(B, S, H, dh)
        q = y[:, :, 2].reshape(B, S, H, dh)
        k_new = y[:, :, 3].reshape(B, S, H, dh)
        alpha = 1.0 / (dh ** 0.5)

        if paged is not None:
            k_pages, v_pages, page_table = paged
            attn = paged_hstu_delta_attention(
                q.contiguous(), k_pages, v_pages, page_table, cached_len,
                k_new.contiguous(), v_new.contiguous(), new_lens, num_targets,
                alpha=alpha, scaling_seqlen=scaling_seqlen,
            ).reshape(B, S, H * dh)
        else:
            # full K/V = cached ++ new: position p < cached_len comes from the
            # cache, p in [cached_len, cached_len + S) from new token p - cached
            Nc = cached_k.shape[1]
            N = Nc + S
            full_k = torch.cat([cached_k, k_new], dim=1)
            full_v = torch.cat([cached_v, v_new], dim=1)
            pos = torch.arange(N, device=x.device)[None, :]
            cl = cached_len.to(torch.int64)[:, None]
            src = torch.where(pos < cl, pos, Nc + (pos - cl)).clamp(0, N - 1)
            idx = src[:, :, None, None].expand(B, N, H, dh)
            full_k = torch.gather(full_k, 1, idx)
            full_v = torch.gather(full_v, 1, idx)
            q_pos = cl + torch.arange(S, device=x.device)[None, :]
            kv_len = cached_len.to(torch.int64) + new_lens.to(torch.int64)
            attn = delta_attention(
                q, full_k, full_v, q_pos, kv_len, num_targets,
                alpha=alpha, scaling_seqlen=scaling_seqlen,
            ).reshape(B, S, H * dh)

        y = self.output_layernorm(attn) * u
        out = F.linear(y, self.linear_proj.weight.to(cfg.dtype))
        if cfg.residual:
            out = out + x
        return out, k_new, v_new


class HSTUBlockInference(nn.Module):
    """Stack of PagedHSTUInferLayers; collects each layer's new K/V for the
    cache append."""

    def __init__(self, config: HSTUConfig, device=None):
        super().__init__()
        self.config = config
        self.layers = nn.ModuleList(
            PagedHSTUInferLayer(config, device) for _ in range(config.num_layers)
        )

    def forward(
        self, x, cached_k, cached_v, cached_len, new_lens, num_targets,
        scaling_seqlen, paged=None,
    ):
        ks, vs = [], []
        for i, layer in enumerate(self.layers):
            layer_paged = None
            if paged is not None:
                k_pages, v_pages, page_table = paged
                layer_paged = (k_pages[i], v_pages[i], page_table)
            x, k_new, v_new = layer(
                x,
                None if cached_k is None else cached_k[i],
                None if cached_v is None else cached_v[i],
                cached_len, new_lens, num_targets, scaling_seqlen,
                paged=layer_paged,
            )
            ks.append(k_new)
            vs.append(v_new)
        return x, torch.stack(ks), torch.stack(vs)


def strip_cached_tokens(
    values: torch.Tensor,   # [B, S_full, ...] dense per-user sequences
    lengths: torch.Tensor,  # [B] full lengths
    cached: torch.Tensor,   # [B] cached prefix lengths
    max_new: int,
):
    """Select the uncached suffix of each user. Returns
    (new_values [B, max_new, ...], new_lens [B] int32)."""
    B = values.shape[0]
    trail = values.shape[2:]
    idx = cached.to(torch.int64)[:, None] + torch.arange(
        max_new, device=values.device
    )[None, :]
    ok = idx < lengths.to(torch.int64)[:, None]
    idx = idx.clamp(0, values.shape[1] - 1)
    view = (B, max_new) + (1,) * len(trail)
    out = torch.gather(values, 1, idx.reshape(view).expand((B, max_new) + trail))
    out = torch.where(ok.reshape(view), out, out.new_zeros(()))
    new_lens = (lengths.to(torch.int64) - cached.to(torch.int64)).clamp_min(0)
    return out, new_lens.to(torch.int32)
