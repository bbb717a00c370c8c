"""Qwen3-backed SID beam generation (counterpart of
recsys_examples_tpu/inference/sid_serving/qwen3_runtime.py).

Prefill the context once, then `num_steps - 1` beam steps through the fused
beam-decode attention (kernel K7 on the card). The beam KV is never
reordered: ancestry indices name, for each final beam, the slot that holds
each earlier step's KV, and are re-rooted through the parents after every
step. An optional per-step logits mask and a logits processor chain (in
that order) plug in constrained decoding.

Everything runs on the model's device; `tokens` and `lengths` may be numpy
arrays or tensors. `qwen3_generate_beam` runs in spans (`named_scope`):
`serve/pack` (the inputs to the device), `qwen3/prefill`, `qwen3/expand`
(the first beam and the beam KV buffers), `qwen3/decode_h` for each decode
step h, and `qwen3/paths`.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from recsys_examples_torch.models.beam_search import (
    decode_paths,
    first_expand,
    init_beam,
    propagate,
)
from recsys_examples_torch.models.qwen3 import Qwen3Model
from recsys_examples_torch.utils.observability import named_scope


def _on(model: Qwen3Model, tokens, lengths):
    dev = model.device
    return (torch.as_tensor(tokens, device=dev).to(torch.int64),
            torch.as_tensor(lengths, device=dev).to(torch.int64))


def _log_softmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(logits.float(), dim=-1)


@torch.no_grad()
def qwen3_generate_beam(
    model: Qwen3Model,
    tokens,                 # [B, N] context (history SID stream)
    lengths,                # [B]
    num_steps: int,
    beam_width: int,
    logits_mask_fn: Optional[Callable[[int, torch.Tensor], torch.Tensor]] = None,
    logits_processor=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (paths [B, W, num_steps], scores [B, W]).

    logits_mask_fn(step, paths_so_far [B, W, step]) -> additive mask
    [B, W, V] (0 allowed, -inf or -1e30 banned). logits_processor: a
    `LogitsProcessor` or chain (`logits_processor.py`), applied after the
    mask."""
    cfg = model.config
    with named_scope("serve/pack"):
        tokens, lengths = _on(model, tokens, lengths)
    dev = tokens.device
    B, W, L = tokens.shape[0], beam_width, cfg.num_layers
    Hkv, dh = cfg.num_kv_heads, cfg.head_dim

    with named_scope("qwen3/prefill"):
        last_logits, ctx_kv = model.prefill(tokens, lengths)
    with named_scope("qwen3/expand"):
        logp0 = _log_softmax(last_logits)
        state = init_beam(B, W, num_steps, device=dev)
        if logits_mask_fn is not None:
            logp0 = logp0 + logits_mask_fn(
                0, torch.zeros((B, W, 0), dtype=torch.int64, device=dev))[:, 0]
        if logits_processor is not None:
            # one implicit beam at prefill (SIDGRModel.beam_prefill's contract)
            logp0 = logits_processor(
                0, logp0[:, None, :],
                torch.zeros((B, 1, 0), dtype=torch.int64, device=dev))[:, 0]
        state = first_expand(state, logp0)

        kv_shape = (B, num_steps - 1, W, Hkv, dh)
        beam_k = [torch.zeros(kv_shape, dtype=cfg.dtype, device=dev) for _ in range(L)]
        beam_v = [torch.zeros(kv_shape, dtype=cfg.dtype, device=dev) for _ in range(L)]
        A = torch.zeros((B, max(num_steps - 1, 1), W), dtype=torch.int64, device=dev)
        ident = torch.arange(W, device=dev).expand(B, W)

    for h in range(1, num_steps):
        with named_scope(f"qwen3/decode_{h}"):
            par = state.parents[:, h - 1, :]
            if h > 1:   # re-root the earlier steps' slots through the parents
                A[:, : h - 1] = torch.gather(A[:, : h - 1], 2,
                                             par[:, None, :].expand(B, h - 1, W))
            tok = state.tokens[:, h - 1, :]                      # [B, W]
            pos = (lengths[:, None] + (h - 1)).expand(B, W)
            logits, new_kv = model.decode_step(
                tok, pos, ctx_kv, lengths,
                [(beam_k[li][:, : h - 1], beam_v[li][:, : h - 1]) for li in range(L)]
                if h > 1 else None,
                A[:, : h - 1] if h > 1 else None,
            )
            for li in range(L):
                beam_k[li][:, h - 1] = new_kv[li][0]
                beam_v[li][:, h - 1] = new_kv[li][1]
            A[:, h - 1] = ident
            logp = _log_softmax(logits)
            if logits_mask_fn is not None or logits_processor is not None:
                paths_so_far = decode_paths(state)[:, :, :h]
                if logits_mask_fn is not None:
                    logp = logp + logits_mask_fn(h, paths_so_far)
                if logits_processor is not None:
                    logp = logits_processor(h, logp, paths_so_far)
            state = propagate(state, logp)
    with named_scope("qwen3/paths"):
        return decode_paths(state), state.scores


@torch.no_grad()
def teacher_forced_logp(model: Qwen3Model, tokens, lengths, paths, h: int) -> torch.Tensor:
    """log p(next token | context, paths[:, :, :h]) for every beam, by a
    prefill of the whole prefix (no KV cache): [B, W, V] fp32. The prefixes
    are padded to the context width plus paths' step count."""
    tokens, lengths = _on(model, tokens, lengths)
    dev = tokens.device
    B, W, S = paths.shape
    if h == 0:
        logits, _ = model.prefill(tokens, lengths)
        return _log_softmax(logits)[:, None].expand(B, W, -1)
    ext = torch.cat([tokens.repeat_interleave(W, dim=0), tokens.new_zeros((B * W, S))], dim=1)
    lens_bw = lengths.repeat_interleave(W)
    bw = torch.arange(B * W, device=dev)
    for hh in range(h):
        ext[bw, lens_bw + hh] = paths[:, :, hh].reshape(B * W)
    logits, _ = model.prefill(ext, lens_bw + h)
    return _log_softmax(logits).reshape(B, W, -1)


@torch.no_grad()
def qwen3_generate_reference(
    model: Qwen3Model,
    tokens,
    lengths,
    num_steps: int,
    beam_width: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The no-KV oracle of the cached path: re-runs the whole prefix of
    every beam at every step."""
    tokens, lengths = _on(model, tokens, lengths)
    B, W = tokens.shape[0], beam_width
    state = init_beam(B, W, num_steps, device=tokens.device)
    paths = state.tokens.new_zeros((B, W, num_steps))
    state = first_expand(state, teacher_forced_logp(model, tokens, lengths, paths, 0)[:, 0])
    for h in range(1, num_steps):
        state = propagate(state, teacher_forced_logp(
            model, tokens, lengths, decode_paths(state), h))
    return decode_paths(state), state.scores
