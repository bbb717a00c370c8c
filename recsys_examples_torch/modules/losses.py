"""Losses (counterpart of recsys_examples_tpu/modules/losses.py): multi-task
BCE over bit-encoded labels and cross-entropy for ranking, and the sampled
softmax with in-batch negatives for retrieval.

Each returns (sum over this rank's rows, count). Under data parallelism the
models divide the sum by the count summed over the data axis (`data_total`),
which makes each rank's loss its share of the global batch's mean; the
retrieval loss's negatives are the global batch's targets, gathered over the
data axis.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from recsys_examples_torch.parallel.collective_ops import gather_along_first_dim


def data_total(x: torch.Tensor, group) -> torch.Tensor:
    """`x` summed over the data axis (no gradient), or `x` detached without
    a group."""
    x = x.detach()
    if group is None:
        return x
    x = x.clone()
    dist.all_reduce(x, group=group)
    return x


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
    group: Optional["dist.ProcessGroup"] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sampled softmax with in-batch negatives: every valid row's target is
    a negative for every other row, except rows of the same item id. With
    `group` (the data axis) the negatives are every rank's targets: they are
    gathered (the gradient goes back by a reduce-scatter) and this rank's
    rows find their positives at its offset among them."""
    col0 = 0
    t_all, ids_all, valid_all = target_emb.float(), target_ids, valid
    if group is not None:
        t_all = gather_along_first_dim(t_all, group)
        ids_all = gather_along_first_dim(target_ids, group)
        valid_all = gather_along_first_dim(valid.to(torch.int32), group).bool()
        rows = gather_along_first_dim(
            torch.tensor([query_emb.shape[0]], device=query_emb.device), group)
        col0 = int(rows[:dist.get_rank(group)].sum())
    N = query_emb.shape[0]
    logits = (query_emb.float() @ t_all.T) / temperature
    same_item = target_ids[:, None] == ids_all[None, :]
    pos_col = torch.arange(N, device=logits.device) + col0
    eye = torch.zeros(logits.shape, dtype=torch.bool, device=logits.device)
    eye[torch.arange(N, device=logits.device), pos_col] = True
    # negatives: valid columns, not the positive, not an id collision
    allowed = (valid_all[None, :] & ~same_item) | eye
    logits = torch.where(allowed, logits, -1e9)
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, pos_col[:, None])[:, 0] * valid.float()
    return nll.sum(), valid.sum().float()
