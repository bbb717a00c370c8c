"""RetrievalGR: HSTU encoder + in-batch-negative sampled softmax
(counterpart of recsys_examples_tpu/models/retrieval_gr.py).

Training pairs: for every history position i (after de-interleave), the
query is the HSTU output at i and the supervision item is the *next* item
(i+1) in the same sequence; the last position has no target.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from recsys_examples_torch.data.hstu_batch import HSTUBatch
from recsys_examples_torch.jagged.jagged_tensor import JaggedData
from recsys_examples_torch.modules.config import HSTUConfig, RetrievalConfig
from recsys_examples_torch.modules.embedding import EmbeddingCollection
from recsys_examples_torch.modules.hstu_block import HSTUBlock
from recsys_examples_torch.modules.losses import data_total, in_batch_sampled_softmax_loss
from recsys_examples_torch.ops.jagged import row_to_batch


class RetrievalGR(nn.Module):
    """Submodules `embeddings` and `hstu_block`, as the flax model names
    them (`convert.dense_state_dict` maps the params across). Under a mesh
    the negatives are the global batch's targets and the loss is this rank's
    share of the global batch's (see `modules/losses.py`)."""

    def __init__(self, hstu_config: HSTUConfig, task_config: RetrievalConfig, device=None,
                 mesh=None):
        super().__init__()
        self.hstu_config = hstu_config
        self.task_config = task_config
        self.embeddings = EmbeddingCollection(task_config.embedding_configs, device)
        self.hstu_block = HSTUBlock(hstu_config, device, mesh)
        self.data_group = None if mesh is None else mesh.group(mesh.data_axis)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "RetrievalGR":
        """Random params with flax's init rules, drawn from `generator` (on
        its device)."""
        for m in self.modules():
            if m is not self and hasattr(m, "init_weights"):
                m.init_weights(generator)
        return self

    def encode(self, batch: HSTUBatch, train: bool = True,
               embeddings: Optional[Dict[str, torch.Tensor]] = None,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[Dict[str, torch.Tensor], JaggedData]:
        emb = dict(self.embeddings(batch))
        if embeddings:
            emb.update(embeddings)
        return emb, self.hstu_block(emb, batch, train, generator)

    def forward(self, batch: HSTUBatch, train: bool = True,
                embeddings: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Returns (scalar mean loss, aux with the query and target
        embeddings, target ids and valid rows)."""
        emb, jd = self.encode(batch, train, embeddings, generator)
        q = jd.values  # [Tq, D] L2-normalized user states
        Tq = q.shape[0]
        item = batch.features[batch.item_feature_name]
        item_emb = emb[batch.item_feature_name]  # [cap, D]

        # supervision: the next item in the same sequence, in the raw item
        # feature's layout
        offs = jd.seqlen_offsets
        b = row_to_batch(offs, Tq)
        rows = torch.arange(Tq, device=q.device)
        pos = rows - offs[b]
        item_offs = item.offsets.to(torch.int64)
        src = item_offs[b] + pos + 1
        has_next = (pos + 1) < (item_offs[b + 1] - item_offs[b])
        src = src.clamp(0, item.values.shape[0] - 1)
        target_emb = item_emb[src].float()
        eps = self.task_config.l2_norm_eps
        tnorm = torch.sqrt((target_emb * target_emb).sum(-1, keepdim=True) + eps * eps)
        target_emb = target_emb / tnorm
        target_ids = item.values[src]
        valid = (rows < offs[-1]) & has_next
        loss_sum, count = in_batch_sampled_softmax_loss(
            q.float(), target_emb, target_ids, valid,
            temperature=self.task_config.temperature, group=self.data_group)
        loss = loss_sum / data_total(count, self.data_group).clamp_min(1.0)
        return loss, {
            "query_emb": q,
            "target_emb": target_emb,
            "target_ids": target_ids,
            "valid": valid,
            "loss": loss,
        }
