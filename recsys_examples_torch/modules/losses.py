"""Losses (counterpart of recsys_examples_tpu/modules/losses.py): multi-task
BCE over bit-encoded labels and cross-entropy for ranking, and the sampled
softmax with in-batch negatives for retrieval."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def decode_bits(encoded: torch.Tensor, bit_width: int) -> torch.Tensor:
    """int labels [N] -> [N, bit_width] of 0/1 (LSB = task 0)."""
    bits = torch.arange(bit_width, dtype=encoded.dtype, device=encoded.device)
    return (encoded[:, None] >> bits[None, :]) & 1


def multi_task_bce_loss(
    logits: torch.Tensor,   # [N, num_tasks]
    labels: torch.Tensor,   # [N] int (bit-encoded)
    valid: torch.Tensor,    # [N] bool
    num_tasks: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-element BCE-with-logits; returns (sum_loss [num_tasks], count)."""
    y = decode_bits(labels, num_tasks).float()
    x = logits.float()
    per = x.clamp_min(0) - x * y + torch.log1p(torch.exp(-x.abs()))
    per = per * valid[:, None].float()
    return per.sum(0), valid.sum().float()


def cross_entropy_loss(
    logits: torch.Tensor,   # [N, num_classes]
    labels: torch.Tensor,   # [N] int class ids
    valid: torch.Tensor,    # [N] bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, labels[:, None].to(torch.int64))[:, 0] * valid.float()
    return nll.sum(), valid.sum().float()


def in_batch_sampled_softmax_loss(
    query_emb: torch.Tensor,    # [N, D] L2-normalized user states
    target_emb: torch.Tensor,   # [N, D] L2-normalized supervision item embs
    target_ids: torch.Tensor,   # [N] int item ids (for dedup masking)
    valid: torch.Tensor,        # [N] bool
    temperature: float = 0.05,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sampled softmax with in-batch negatives: every valid row's target is
    a negative for every other row, except rows of the same item id."""
    logits = (query_emb.float() @ target_emb.float().T) / temperature
    same_item = target_ids[:, None] == target_ids[None, :]
    eye = torch.eye(logits.shape[0], dtype=torch.bool, device=logits.device)
    # negatives: valid columns, not the positive, not an id collision
    allowed = (valid[None, :] & ~same_item) | eye
    logits = torch.where(allowed, logits, -1e9)
    nll = -torch.diagonal(F.log_softmax(logits, dim=-1)) * valid.float()
    return nll.sum(), valid.sum().float()
