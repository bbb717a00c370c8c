"""Streaming eval metrics: AUC (ranking), HR@k / NDCG@k / MRR (retrieval)
(counterpart of recsys_examples_tpu/modules/metrics.py).

The accumulator states are plain tensors on the trainer's device; an update
adds to them without waiting for the device, and `*_compute` reads nothing
back either. Under data parallelism each rank accumulates its rows and
`sum_over` adds the ranks' states before `*_compute`: the states are sums
(histogram counts, hits), so the metric does not depend on the world size.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.distributed as dist


def sum_over(state, group):
    """`state` (an AUCState or RetrievalMetricState) with every field summed
    over `group`; `state` itself without a group."""
    if group is None:
        return state
    fields = {}
    for f in dataclasses.fields(state):
        t = getattr(state, f.name).clone()
        dist.all_reduce(t, group=group)
        fields[f.name] = t
    return type(state)(**fields)


@dataclasses.dataclass
class AUCState:
    """Histogram-bucketed streaming AUC per task (a fixed bucket count keeps
    the state O(buckets) and mergeable with a sum)."""

    pos_hist: torch.Tensor  # [num_tasks, buckets] fp32
    neg_hist: torch.Tensor

    @staticmethod
    def init(num_tasks: int, buckets: int = 4096, device="cpu") -> "AUCState":
        z = torch.zeros((num_tasks, buckets), dtype=torch.float32, device=device)
        return AUCState(pos_hist=z, neg_hist=z.clone())


def auc_update(
    state: AUCState,
    logits: torch.Tensor,    # [N, num_tasks]
    labels01: torch.Tensor,  # [N, num_tasks] 0/1
    valid: torch.Tensor,     # [N] bool
) -> AUCState:
    num_tasks, buckets = state.pos_hist.shape
    p = torch.sigmoid(logits.float())
    idx = (p * buckets).to(torch.int32).clamp(0, buckets - 1).to(torch.int64)
    v = valid.float()[:, None]
    y = labels01.float()
    # one flat histogram row per task: cell t * buckets + idx
    flat = (idx + torch.arange(num_tasks, device=idx.device) * buckets).reshape(-1)
    pos = torch.zeros(num_tasks * buckets, dtype=torch.float32, device=idx.device)
    neg = torch.zeros_like(pos)
    pos.index_add_(0, flat, (y * v).reshape(-1))
    neg.index_add_(0, flat, ((1.0 - y) * v).reshape(-1))
    return AUCState(pos_hist=state.pos_hist + pos.view(num_tasks, buckets),
                    neg_hist=state.neg_hist + neg.view(num_tasks, buckets))


def auc_compute(state: AUCState) -> torch.Tensor:
    """[num_tasks] AUC from the histograms (trapezoidal over score buckets)."""
    pos, neg = state.pos_hist, state.neg_hist
    total_pos = pos.sum(1)
    total_neg = neg.sum(1)
    # P(score_pos > score_neg) + 0.5 P(equal), bucketed
    neg_cum_below = torch.cumsum(neg, 1) - neg
    auc = (pos * (neg_cum_below + 0.5 * neg)).sum(1)
    denom = total_pos * total_neg
    return torch.where(denom > 0, auc / denom.clamp_min(1.0), 0.5)


@dataclasses.dataclass
class RetrievalMetricState:
    """Accumulators for HR@k / NDCG@k / MRR over ranked candidate lists."""

    hit: torch.Tensor     # [num_ks]
    ndcg: torch.Tensor    # [num_ks]
    mrr: torch.Tensor     # []
    count: torch.Tensor   # []

    @staticmethod
    def init(num_ks: int, device="cpu") -> "RetrievalMetricState":
        z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
        return RetrievalMetricState(hit=z(num_ks), ndcg=z(num_ks), mrr=z(), count=z())


def retrieval_update(
    state: RetrievalMetricState,
    rank: torch.Tensor,    # [N] 1-based rank of the true item (0/huge = miss)
    valid: torch.Tensor,   # [N] bool
    ks: Tuple[int, ...],
) -> RetrievalMetricState:
    v = valid.float()
    r = rank.float()
    hits, ndcgs = [], []
    for k in ks:
        h = ((rank >= 1) & (rank <= k)).float() * v
        hits.append(h.sum())
        ndcgs.append((h / torch.log2(r + 1.0)).sum())
    mrr = torch.where(rank >= 1, 1.0 / r.clamp_min(1.0), 0.0) * v
    return RetrievalMetricState(
        hit=state.hit + torch.stack(hits),
        ndcg=state.ndcg + torch.stack(ndcgs),
        mrr=state.mrr + mrr.sum(),
        count=state.count + v.sum(),
    )


def retrieval_compute(
    state: RetrievalMetricState, ks: Tuple[int, ...]
) -> Dict[str, torch.Tensor]:
    c = state.count.clamp_min(1.0)
    out = {}
    for i, k in enumerate(ks):
        out[f"HR@{k}"] = state.hit[i] / c
        out[f"NDCG@{k}"] = state.ndcg[i] / c
    out["MRR"] = state.mrr / c
    return out
