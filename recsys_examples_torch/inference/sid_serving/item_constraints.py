"""Item-catalog constraints for SID beam decode (counterpart of
recsys_examples_tpu/inference/sid_serving/item_constraints.py).

The catalog of valid SID tuples becomes a dense array trie:
  children[node, token] -> child node id (-1 = invalid prefix).
Each live beam carries its trie node id; the per-step logits mask is a
single gather. `reload` rebuilds the arrays from a new catalog (online
catalog updates). The trie is built in numpy and kept on `device`.
"""
from __future__ import annotations

import numpy as np
import torch

from recsys_examples_torch.models.beam_search import top_k_stable
from recsys_examples_torch.utils.device import resolve_device


class TrieConstraint:
    def __init__(self, catalog: np.ndarray, codebook_size: int, device="cuda"):
        """catalog: [num_items, H] valid SID tuples."""
        self.codebook_size = codebook_size
        self.num_hierarchies = catalog.shape[1]
        self.device = resolve_device(device)
        self.reload(catalog)

    def reload(self, catalog: np.ndarray) -> None:
        H = catalog.shape[1]
        C = self.codebook_size
        # build the trie level by level, from the single root (id 0)
        children_list = []
        prefix_ids = np.zeros(len(catalog), np.int64)
        num_nodes = 1
        for h in range(H):
            tok = catalog[:, h].astype(np.int64)
            pair = prefix_ids * C + tok
            uniq, inv = np.unique(pair, return_inverse=True)
            ch = np.full((num_nodes, C), -1, np.int64)
            ch[uniq // C, uniq % C] = np.arange(len(uniq), dtype=np.int64)
            children_list.append(ch)
            prefix_ids = inv.astype(np.int64)
            num_nodes = len(uniq)
        self.children = [torch.from_numpy(c).to(self.device) for c in children_list]
        self.num_items = len(catalog)

    def mask_logits(self, logits: torch.Tensor, node_ids: torch.Tensor,
                    hierarchy: int) -> torch.Tensor:
        """[B, W, C] logits + [B, W] trie nodes -> masked logits (invalid
        continuations to -inf)."""
        ch = self.children[hierarchy]
        allowed = ch[node_ids.clamp(0, ch.shape[0] - 1)] >= 0
        allowed = allowed & (node_ids >= 0)[..., None]
        return torch.where(allowed, logits, logits.new_full((), -torch.inf))

    def advance(self, node_ids: torch.Tensor, tokens: torch.Tensor,
                hierarchy: int) -> torch.Tensor:
        """[B, W] nodes + chosen tokens -> child node ids."""
        ch = self.children[hierarchy]
        nxt = ch[node_ids.clamp(0, ch.shape[0] - 1), tokens]
        return torch.where(node_ids >= 0, nxt, nxt.new_full((), -1))


class LogitsProcessor:
    """Temperature + optional top-k truncation before beam expansion."""

    def __init__(self, temperature: float = 1.0, top_k: int = 0):
        self.temperature = temperature
        self.top_k = top_k

    def __call__(self, logits: torch.Tensor) -> torch.Tensor:
        if self.temperature != 1.0:
            logits = logits / self.temperature
        if 0 < self.top_k < logits.shape[-1]:
            kth = top_k_stable(logits, self.top_k)[0][..., -1:]
            logits = torch.where(logits >= kth, logits,
                                 logits.new_full((), -torch.inf))
        return logits
