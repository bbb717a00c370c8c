"""Fixed-width beam search over hierarchical SIDs (counterpart of
recsys_examples_tpu/models/beam_search.py).

Scores are fp32, tokens and parents int64 (torch's index type; they compare
equal to the JAX package's int32 values). Ties are real here (-inf scores of
dead beams and of banned tokens), and paths must equal the JAX package's, so
every top-k is `top_k_stable`: among equal values the lowest index comes
first, as `jax.lax.top_k` orders them (`torch.topk` promises no order).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from recsys_examples_torch.utils.device import resolve_device


class BeamState(NamedTuple):
    scores: torch.Tensor    # [B, W] accumulated log-probs
    tokens: torch.Tensor    # [B, H, W] chosen token per hierarchy
    parents: torch.Tensor   # [B, H, W] parent beam index per hierarchy
    step: int               # current hierarchy


def top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last dim, in descending order, equal values
    in ascending index order."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def init_beam(batch: int, beam_width: int, num_hierarchies: int,
              device="cuda") -> BeamState:
    """A fresh search on `device`: the card unless the caller names another."""
    device = resolve_device(device)
    scores = torch.full((batch, beam_width), -torch.inf, device=device)
    scores[:, 0] = 0.0   # only beam 0 is live pre-expansion
    zeros = lambda: torch.zeros((batch, num_hierarchies, beam_width),
                                dtype=torch.int64, device=device)
    return BeamState(scores=scores, tokens=zeros(), parents=zeros(), step=0)


def propagate(state: BeamState, log_probs: torch.Tensor) -> BeamState:
    """Accumulate scores and take the global top-W over (beam, token).
    log_probs: [B, W, C] per-beam next-token log-probs."""
    B, W, C = log_probs.shape
    total = state.scores[:, :, None] + log_probs
    top_scores, top_idx = top_k_stable(total.reshape(B, W * C), W)
    h = state.step
    tokens, parents = state.tokens.clone(), state.parents.clone()
    tokens[:, h, :] = top_idx % C
    parents[:, h, :] = top_idx // C
    return BeamState(scores=top_scores, tokens=tokens, parents=parents, step=h + 1)


def first_expand(state: BeamState, log_probs0: torch.Tensor) -> BeamState:
    """Hierarchy-0 expansion from the single BOS context: top-W tokens
    (parents all 0)."""
    W = state.scores.shape[1]
    top_scores, top_idx = top_k_stable(log_probs0, W)
    tokens, parents = state.tokens.clone(), state.parents.clone()
    tokens[:, 0, :] = top_idx
    parents[:, 0, :] = 0
    return BeamState(scores=top_scores, tokens=tokens, parents=parents,
                     step=state.step + 1)


def gather_beams(x: torch.Tensor, parents: torch.Tensor) -> torch.Tensor:
    """Reorder per-beam data [B, W, ...] by parent indices [B, W]."""
    idx = parents.to(torch.int64).reshape(parents.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(parents.shape + x.shape[2:]))


def build_ancestry(state: BeamState) -> torch.Tensor:
    """[B, H, W]: for each final beam w and hierarchy h, the beam index that
    produced the token at h on w's path. Walks the parents backwards;
    hierarchies not decoded yet (h >= step) keep the identity."""
    B, Hh, W = state.tokens.shape
    cur = torch.arange(W, device=state.tokens.device).expand(B, W)
    trace = [None] * Hh
    for h in range(Hh - 1, -1, -1):
        trace[h] = cur
        if h <= state.step - 1:
            cur = torch.gather(state.parents[:, h, :], 1, cur)
    return torch.stack(trace, dim=1)


def decode_paths(state: BeamState) -> torch.Tensor:
    """[B, W, H] final token tuples per beam, resolved through ancestry."""
    toks = torch.gather(state.tokens, 2, build_ancestry(state))
    return toks.transpose(1, 2)
