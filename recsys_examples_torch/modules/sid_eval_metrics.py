"""SID-GR eval metrics: recall@k / NDCG@k / MRR over generated SID tuples
(counterpart of recsys_examples_tpu/modules/sid_eval_metrics.py)."""
from __future__ import annotations

from typing import Dict, Sequence

import torch


def sid_rank(
    paths: torch.Tensor,     # [B, W, H] beam-ordered generated SID tuples
    target: torch.Tensor,    # [B, H] true SID tuple
) -> torch.Tensor:
    """1-based rank of the exact target tuple among the beams (0 = miss),
    int32."""
    match = (paths == target[:, None, :]).all(-1)           # [B, W]
    first = match.int().argmax(1) + 1                        # first True
    return torch.where(match.any(1), first, 0).to(torch.int32)


def sid_eval_metrics(
    paths: torch.Tensor,
    target: torch.Tensor,
    ks: Sequence[int] = (1, 5, 10),
) -> Dict[str, torch.Tensor]:
    """recall@k and ndcg@k for each k, and mrr: fp32 means over the batch."""
    rank = sid_rank(paths, target)
    r = rank.float()
    hit = rank >= 1
    out = {}
    for k in ks:
        hk = (hit & (rank <= k)).float()
        out[f"recall@{k}"] = hk.mean()
        out[f"ndcg@{k}"] = torch.where(hk > 0, 1.0 / torch.log2(r + 1.0), 0.0).mean()
    out["mrr"] = torch.where(hit, 1.0 / r.clamp_min(1.0), 0.0).mean()
    return out
