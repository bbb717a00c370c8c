"""Row-sharded dynamic tables with their phase-A / phase-C entry points, and
several features grouped in one table (`GroupedShardedDynamicEmbedding`)
(counterpart of recsys_examples_tpu/dynamicemb/sharded_collection.py).

  - Rows live on their owner rank of the mesh's data axis: owner =
    mix64(key + golden gamma) mod W (`route_owner`, bit for bit the JAX
    package's "hash_roundrobin" routing).
  - Phase A (forward, no autograd): local unique -> each unique key to its
    owner by `all_to_all_single` with exact splits (the counts go first) ->
    the owner dedups what it received (rank order) and looks up or inserts
    -> rows back by a second `all_to_all_single` -> per-token gather.
  - Phase B (caller): the dense model consumes the per-token embeddings.
  - Phase C (backward, no autograd): per-token grads summed per local unique
    -> to the owners by `all_to_all_single` -> summed per owner row in fp32
    in a fixed order (source rank, then lane) -> fused row optimizer.

The JAX package exchanges fixed-capacity buckets (`_cap`): keys past an
owner's bucket fall back to transient rows and `AdaptiveBucketing` grows the
cap. The exchange here is exact, so `num_overflow` is always 0 and nothing
grows. Without a mesh the table is local to one device; with one, even at
W = 1, the exchange runs through the collectives.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.distributed as dist

from recsys_examples_torch.dynamicemb.batched_table import (
    DynamicEmbeddingTable,
    DynamicEmbTableState,
)
from recsys_examples_torch.dynamicemb.dynamicemb_config import (
    EMPTY_KEY,
    _u64_const,
    splitmix64,
    umod,
)
from recsys_examples_torch.dynamicemb.unique_op import segmented_unique
from recsys_examples_torch.utils import observability
from recsys_examples_torch.utils.device import resolve_device
from recsys_examples_torch.utils.observability import named_scope

_GOLDEN_GAMMA = _u64_const(0x9E3779B97F4A7C15)


def route_owner(keys: torch.Tensor, W: int) -> torch.Tensor:
    """Owner rank per key: splitmix64 of key + the golden gamma, mod W, on
    int64 bits (the JAX package's `route_owner` / `route_owner_np`, bit for
    bit). The gamma decorrelates the owner from the bucket hash inside a
    shard (`hash_keys`, the bare finalizer)."""
    return umod(splitmix64(keys.to(torch.int64) + _GOLDEN_GAMMA), W)


def _count_lookup(table, keys, slots, before) -> None:
    """Phase A's counters while tracing is on (device counts, read only by
    `observability.snapshot()`): the unique keys the table looked up, the
    hits among them, and what the lookup added to the table's inserted,
    evicted and overflowed counters (`before`: those three before it)."""
    d = torch.cat([table.inserted, table.evicted, table.overflowed]) - before
    observability.count("emb/unique_keys", (keys != EMPTY_KEY).sum())
    observability.count("emb/hits", (slots >= 0).sum() - d[0])
    for i, name in enumerate(("emb/inserted", "emb/evicted", "emb/overflowed")):
        observability.count(name, d[i])


class LookupResidual(NamedTuple):
    """Routing info from phase A needed by phase C (this rank's)."""

    reverse_idx: torch.Tensor   # [n] token -> local unique slot
    owner: torch.Tensor         # [n] owner rank per local unique (W: padding)
    pos: torch.Tensor           # [n] lane of each local unique in the send buffer
    recv_keys: torch.Tensor     # [R] the owner-unique keys this rank served
    recv_reverse: torch.Tensor  # [r] received lane -> owner-unique slot
    slots: torch.Tensor         # [R] table slots of the owner uniques
    num_unique: torch.Tensor    # [1] local unique count
    num_overflow: torch.Tensor  # [1] always 0: the exchange is exact


# the exchange's residual: LookupResidual's fields, then the splits of its
# all-to-alls, [W] int64 on the host (keys sent to each owner, received from
# each rank)
ExchangeResidual = NamedTuple("ExchangeResidual", [
    *LookupResidual.__annotations__.items(),
    ("send_splits", torch.Tensor), ("recv_splits", torch.Tensor)])


class ShardedDynamicEmbedding:
    """One dynamic table, row-sharded over `mesh`'s data axis (or local with
    mesh=None), on `device` (CUDA unless the caller passes "cpu"). The state
    is this rank's shard. `axis` may be a tuple, e.g. ("dcn", "data"), to
    shard over the combined axis; by default the mesh's `data_axis`."""

    def __init__(self, table: DynamicEmbeddingTable, mesh=None, axis=None, device="cuda"):
        self.table = table
        self.mesh = mesh
        self.device = resolve_device(device)
        if mesh is None:
            self.axis, self.group, self.world, self.rank = None, None, 1, 0
        else:
            self.axis = axis if axis is not None else mesh.data_axis
            self.group = mesh.group(self.axis)
            self.world, self.rank = mesh.size(self.axis), mesh.index(self.axis)

    def init_state(self) -> DynamicEmbTableState:
        return self.table.init_state(self.device)

    # ------------------------------------------------------------ phase A
    @torch.no_grad()
    def forward(self, state: DynamicEmbTableState, ids: torch.Tensor, train: bool = True
                ) -> Tuple[DynamicEmbTableState, torch.Tensor, LookupResidual]:
        """ids [T] int64 (this rank's tokens) -> (state, per-token embeddings
        [T, dim], residual). The state is updated in place when `train`,
        inside the span `emb/phase_a`."""
        fwd = self._fwd_local if self.mesh is None else self._fwd_exchange
        if not train:
            return fwd(state, ids, False)
        with named_scope("emb/phase_a"):
            return fwd(state, ids, True)

    def _lookup(self, state, uk, train):
        if train:
            counting = observability.enabled()
            if counting:
                t = state.table
                before = torch.cat([t.inserted, t.evicted, t.overflowed])
            state, slots, uemb = self.table.forward_train(state, uk)
            if counting:
                _count_lookup(state.table, uk, slots, before)
        else:
            uemb = self.table.forward_eval(state, uk)
            slots = torch.full(uk.shape, -1, dtype=torch.int64, device=uk.device)
        return state, slots, uemb

    def _fwd_local(self, state, ids, train=True):
        n = ids.shape[0]
        dev = ids.device
        uk, rev, _, nu = segmented_unique(ids)
        state, slots, uemb = self._lookup(state, uk, train)
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

    def _exchange(self, x, send_splits, recv_splits):
        out = x.new_empty((sum(recv_splits),) + x.shape[1:])
        dist.all_to_all_single(out, x.contiguous(), recv_splits, send_splits, group=self.group)
        return out

    def _fwd_exchange(self, state, ids, train=True):
        W = self.world
        dev = ids.device
        n = ids.shape[0]
        uk, rev, _, nu = segmented_unique(ids)
        active = uk != EMPTY_KEY
        owner = torch.where(active, route_owner(uk, W), W)
        # the send buffer: the active uniques grouped by owner, in key order
        order = torch.sort(owner, stable=True)[1]
        counts = torch.bincount(owner, minlength=W + 1)[:W]
        send_n = torch.empty_like(counts)
        dist.all_to_all_single(send_n, counts, group=self.group)
        send_splits, recv_splits = counts.cpu(), send_n.cpu()
        ss, rs = send_splits.tolist(), recv_splits.tolist()
        pos = torch.empty((n,), dtype=torch.int64, device=dev)
        pos[order] = torch.arange(n, dtype=torch.int64, device=dev)
        send_keys = uk[order[:sum(ss)]]
        recv_keys = self._exchange(send_keys, ss, rs)
        # the owner's side: dedup the requests (rank order), look up / insert
        ruk, rrev, _, _ = segmented_unique(recv_keys)
        state, slots, uemb = self._lookup(state, ruk, train)
        got = self._exchange(uemb.index_select(0, rrev), rs, ss)
        # padding uniques sit past the sent lanes: their rows are zeros
        uemb_local = torch.cat([got, got.new_zeros((n - got.shape[0], got.shape[1]))])
        uemb_local = uemb_local.index_select(0, pos)
        out = uemb_local.index_select(0, rev)
        out = torch.where((ids != EMPTY_KEY)[:, None], out, out.new_zeros(()))
        res = ExchangeResidual(
            reverse_idx=rev, owner=owner.to(torch.int32), pos=pos,
            recv_keys=ruk, recv_reverse=rrev, slots=slots,
            num_unique=nu.reshape(1),
            num_overflow=torch.zeros((1,), dtype=torch.int32, device=dev),
            send_splits=send_splits, recv_splits=recv_splits,
        )
        return state, out, res

    # ------------------------------------------------------------ phase C
    @torch.no_grad()
    def backward(self, state: DynamicEmbTableState, res: LookupResidual,
                 grad_out: torch.Tensor) -> DynamicEmbTableState:
        """grad_out [T, dim]: the per-token embedding grads of this rank.
        Runs inside the span `emb/phase_c`."""
        with named_scope("emb/phase_c"):
            # token grads -> local unique-row grads, summed in fp32
            gu = torch.zeros(grad_out.shape, dtype=torch.float32, device=grad_out.device)
            gu.index_add_(0, res.reverse_idx, grad_out.float())
            if self.mesh is None:
                return self.table.backward(state, res.slots, gu, keys=res.recv_keys)
            ss, rs = res.send_splits.tolist(), res.recv_splits.tolist()
            send = torch.empty_like(gu)
            send[res.pos] = gu
            recv = self._exchange(send[:sum(ss)], ss, rs)
            # per owner row, in fp32, in lane order (source rank, then lane):
            # index_put_ with accumulate is deterministic on CUDA too
            gsum = torch.zeros((res.recv_keys.shape[0], gu.shape[1]), dtype=torch.float32,
                               device=gu.device)
            gsum.index_put_((res.recv_reverse,), recv, accumulate=True)
            return self.table.backward(state, res.slots, gsum, keys=res.recv_keys)


class AdaptiveBucketing:
    """The JAX package's overflow policy, kept as the API the entries call:
    there it grows the exchange's bucket cap after `patience` steps with
    overflow. The exchange here is exact, so `observe` never grows anything
    and returns False."""

    def __init__(self, tables, patience: int = 2, growth: float = 1.5,
                 max_factor: float = 16.0):
        self.tables = list(tables)
        self.patience = patience
        self.growth = growth
        self.max_factor = max_factor

    def observe(self, overflow_total) -> bool:
        return False


class GroupedShardedDynamicEmbedding:
    """Several sparse features served by one table pass (counterpart of the
    JAX package's `GroupedShardedDynamicEmbedding`): the feature index goes
    in bits 58 and up of the key, so dedup, the exchange, lookup and insert
    run once for all of them. Ids outside [0, 2^58) would alias into another
    feature's keys and become EMPTY_KEY (skipped, zero rows)."""

    _TID_SHIFT = 58

    def __init__(self, table: DynamicEmbeddingTable, feature_names, mesh=None, axis=None,
                 device="cuda"):
        if len(feature_names) >= 1 << 5:
            raise ValueError("too many grouped features")
        self.feature_names = tuple(feature_names)
        self.inner = ShardedDynamicEmbedding(table, mesh=mesh, axis=axis, device=device)
        self.table = table
        self.mesh = mesh

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
