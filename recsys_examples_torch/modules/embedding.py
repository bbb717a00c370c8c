"""Static embedding collections (counterpart of
recsys_examples_tpu/modules/embedding.py).

Each table is a dense fp32 parameter `{table_name}_weight [vocab, dim]`; a
lookup is a gather, and its gradient is a dense [vocab, dim] tensor, as
flax's is. Dynamic (hash) tables are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from recsys_examples_torch.data.hstu_batch import HSTUBatch
from recsys_examples_torch.modules.config import EmbeddingConfig


class EmbeddingCollection(nn.Module):
    """Groups tables; returns feature -> jagged embedding values [cap, dim]."""

    def __init__(self, configs: Tuple[EmbeddingConfig, ...], device=None):
        super().__init__()
        self.configs = tuple(configs)
        for cfg in self.configs:
            self.register_parameter(
                f"{cfg.table_name}_weight",
                nn.Parameter(torch.empty(cfg.vocab_size, cfg.dim, device=device)))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """N(0, 1/vocab), flax's init for these tables."""
        for cfg in self.configs:
            w = getattr(self, f"{cfg.table_name}_weight")
            w.copy_(torch.randn(w.shape, generator=generator, device=generator.device)
                    * cfg.vocab_size ** -0.5)

    def forward(self, batch: HSTUBatch) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        for cfg in self.configs:
            table = getattr(self, f"{cfg.table_name}_weight")
            for feat in cfg.feature_names:
                ids = batch.features[feat]
                idx = ids.values.clamp(0, cfg.vocab_size - 1)
                valid = torch.arange(idx.shape[0], device=idx.device) < ids.offsets[-1]
                out[feat] = table[idx] * valid[:, None].to(table.dtype)
        return out
