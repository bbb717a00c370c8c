"""One dynamic table with its phase-A / phase-C entry points, and several features
grouped in one table (`GroupedShardedDynamicEmbedding`), on one device
(counterpart of recsys_examples_tpu/dynamicemb/sharded_collection.py,
`mesh=None` only).

  - Phase A (forward, no autograd): unique -> table lookup/insert ->
    per-token gather. Returns per-token embeddings plus a routing residual.
  - Phase B (caller): the dense model consumes the per-token embeddings.
  - Phase C (backward, no autograd): per-token grads -> sum by unique row
    -> fused sparse optimizer.

Row sharding over several devices (the all-to-all exchange of the JAX
package) belongs to the distribution slice: a `mesh` other than None raises.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from recsys_examples_torch.dynamicemb.batched_table import (
    DynamicEmbeddingTable,
    DynamicEmbTableState,
)
from recsys_examples_torch.dynamicemb.dynamicemb_config import EMPTY_KEY
from recsys_examples_torch.dynamicemb.unique_op import segmented_unique
from recsys_examples_torch.utils.device import resolve_device


class LookupResidual(NamedTuple):
    """Routing info from phase A needed by phase C."""

    reverse_idx: torch.Tensor   # [n] token -> local unique slot
    owner: torch.Tensor         # [n] dest rank per local unique (0)
    pos: torch.Tensor           # [n] slot within dest bucket
    recv_keys: torch.Tensor     # [n] keys this rank served
    recv_reverse: torch.Tensor  # [n] recv -> owner-unique slot
    slots: torch.Tensor         # [n] table slots of owner uniques
    num_unique: torch.Tensor    # [1] local unique count
    num_overflow: torch.Tensor  # [1] always 0 on one device


class ShardedDynamicEmbedding:
    """One dynamic table + its lookup and update logic, on `device` (CUDA
    unless the caller passes "cpu")."""

    def __init__(self, table: DynamicEmbeddingTable, mesh=None, device="cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "row-sharded dynamic tables (mesh != None) belong to the "
                "distribution slice; pass mesh=None")
        self.table = table
        self.mesh = None
        self.world = 1
        self.device = resolve_device(device)

    def init_state(self) -> DynamicEmbTableState:
        return self.table.init_state(self.device)

    # ------------------------------------------------------------ phase A
    @torch.no_grad()
    def forward(self, state: DynamicEmbTableState, ids: torch.Tensor, train: bool = True
                ) -> Tuple[DynamicEmbTableState, torch.Tensor, LookupResidual]:
        """ids [T] int64 -> (state, per-token embeddings [T, dim], residual).
        The state is updated in place when `train`."""
        return self._fwd_local(state, ids, train)

    def _fwd_local(self, state, ids, train=True):
        n = ids.shape[0]
        dev = ids.device
        uk, rev, _, nu = segmented_unique(ids)
        if train:
            state, slots, uemb = self.table.forward_train(state, uk)
        else:
            uemb = self.table.forward_eval(state, uk)
            slots = torch.full((n,), -1, dtype=torch.int64, device=dev)
        out = uemb.index_select(0, rev)
        out = torch.where((ids != EMPTY_KEY)[:, None], out, out.new_zeros(()))
        lane = torch.arange(n, dtype=torch.int32, device=dev)
        res = LookupResidual(
            reverse_idx=rev,
            owner=torch.zeros((n,), dtype=torch.int32, device=dev),
            pos=lane,
            recv_keys=uk,
            recv_reverse=lane,
            slots=slots,
            num_unique=nu.reshape(1),
            num_overflow=torch.zeros((1,), dtype=torch.int32, device=dev),
        )
        return state, out, res

    # ------------------------------------------------------------ phase C
    @torch.no_grad()
    def backward(self, state: DynamicEmbTableState, res: LookupResidual,
                 grad_out: torch.Tensor) -> DynamicEmbTableState:
        """grad_out [T, dim]: the per-token embedding grads."""
        return self._bwd_local(state, res, grad_out)

    def _bwd_local(self, state, res, grad_out):
        # token grads -> unique-row grads, summed in fp32
        gu = torch.zeros(grad_out.shape, dtype=torch.float32, device=grad_out.device)
        gu.index_add_(0, res.reverse_idx, grad_out.float())
        return self.table.backward(state, res.slots, gu, keys=res.recv_keys)


class GroupedShardedDynamicEmbedding:
    """Several sparse features served by one table pass (counterpart of the
    JAX package's `GroupedShardedDynamicEmbedding`), on one device: the
    feature index goes in bits 58 and up of the key, so dedup, lookup and
    insert run once for all of them. Ids outside [0, 2^58) would alias into
    another feature's keys and become EMPTY_KEY (skipped, zero rows)."""

    _TID_SHIFT = 58

    def __init__(self, table: DynamicEmbeddingTable, feature_names, mesh=None,
                 device="cuda"):
        if len(feature_names) >= 1 << 5:
            raise ValueError("too many grouped features")
        self.feature_names = tuple(feature_names)
        self.inner = ShardedDynamicEmbedding(table, mesh=mesh, device=device)
        self.table = table

    def init_state(self) -> DynamicEmbTableState:
        return self.inner.init_state()

    def _compose(self, ids: torch.Tensor, tid: int) -> torch.Tensor:
        ids = ids.to(torch.int64)
        ok = (ids != EMPTY_KEY) & (ids >= 0) & (ids < (1 << self._TID_SHIFT))
        return torch.where(ok, ids + (tid << self._TID_SHIFT), EMPTY_KEY)

    @torch.no_grad()
    def forward(self, state, ids_by_feature, train: bool = True):
        """ids_by_feature: {name: [T_f] int64}. Returns (state, {name: [T_f,
        dim]}, residual)."""
        parts = [self._compose(ids_by_feature[n], i) for i, n in enumerate(self.feature_names)]
        state, emb, res = self.inner.forward(state, torch.cat(parts), train=train)
        return state, dict(zip(self.feature_names, emb.split([p.shape[0] for p in parts]))), res

    @torch.no_grad()
    def backward(self, state, res: LookupResidual, grads_by_feature):
        g = torch.cat([grads_by_feature[n] for n in self.feature_names])
        return self.inner.backward(state, res, g)
