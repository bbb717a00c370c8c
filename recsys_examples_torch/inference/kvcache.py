"""User-ID-keyed paged KV cache for HSTU inference (counterpart of
recsys_examples_tpu/inference/kvcache.py).

The state is a set of fixed-capacity tensors:
  - kv pages: k/v [L, P, page_size, H, dh]
  - user directory: user id -> (page list, cached length, LRU stamp);
    eviction is a vectorized LRU prefix eviction.

The directory arrays, the page ownership and the LRU stamps follow the JAX
package bit for bit. Two details carry that:
  - every sort is stable (`jnp.argsort` is), so ties among free slots and
    free pages resolve the same way;
  - indexed writes follow XLA's scatter: out-of-range indices are dropped
    and, where two rows write one place, the last row wins (`_write_plan`),
    without a host sync.

The directory functions return new tensors. `append_kvcache` writes the
page pools IN PLACE (JAX donates the state to the jitted step, which frees
it to do the same); callers that need the old pages must clone them first.

`HostKVStorage` is the host tier of evicted users' KV: host RAM (the native
C++ store, csrc/host_store.cpp), optionally over an SSD arena; `offload`
copies a user's KV to it, `onboard` copies it back to the card and appends
it to the paged cache.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple, Union

import numpy as np
import torch

from recsys_examples_torch.utils.device import resolve_device

_I64_MAX = 2 ** 63 - 1


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    num_layers: int
    num_heads: int
    head_dim: int
    page_size: int = 128
    num_pages: int = 1024           # device pages (shared pool)
    max_users: int = 256            # device user-directory slots
    max_pages_per_user: int = 32
    dtype: torch.dtype = torch.bfloat16

    @property
    def max_cached_len(self) -> int:
        return self.page_size * self.max_pages_per_user


@dataclasses.dataclass
class KVCacheState:
    k_pages: torch.Tensor     # [L, P, page, H, dh]
    v_pages: torch.Tensor
    user_ids: torch.Tensor    # [U] int64 (-1 empty)
    user_len: torch.Tensor    # [U] int32 cached tokens
    user_pages: torch.Tensor  # [U, maxp] int32 page ids (-1 unset)
    user_lru: torch.Tensor    # [U] int64 last-use stamp
    page_owner: torch.Tensor  # [P] int32 user slot owning each page (-1 free)
    clock: torch.Tensor       # [1] int64

    def replace(self, **kw) -> "KVCacheState":
        return dataclasses.replace(self, **kw)


def _write_plan(idx: torch.Tensor, n: int):
    """Where each entry of `idx` writes, in XLA's scatter semantics
    (`.at[idx].set(..., mode="drop")`): an index outside [0, n) is dropped,
    and of several entries for one index the last one wins.

    Returns (keep, dst, first, any_kept). `keep` marks the entries that land;
    `dst` sends each dropped entry to the index of the first landing entry
    (`first`), where it must write that entry's value, so every index receives
    one value however the device orders the writes. Nothing here waits for
    the device: a boolean-mask index (`idx[keep]`) would sync the host.
    """
    ok = (idx >= 0) & (idx < n)
    safe = torch.where(ok, idx, n).to(torch.int64)
    pos = torch.arange(idx.numel(), device=idx.device)
    last = torch.full((n + 1,), -1, dtype=torch.int64, device=idx.device)
    last = last.scatter_reduce(0, safe, pos, "amax")
    keep = ok & (last[safe] == pos)
    any_kept = keep.any()
    first = keep.to(torch.int32).argmax().view(1)    # a tensor, never an int
    dst = torch.where(keep, safe, torch.where(any_kept, safe[first], 0))
    return keep, dst, first, any_kept


def _fill(vals: torch.Tensor, keep, first, any_kept, current0, dim: int):
    """`vals` with each dropped entry (along `dim`) replaced by the value its
    redirected write must carry: the first landing value, or the current
    content of index 0 when nothing lands."""
    fill = torch.where(any_kept, vals.index_select(dim, first),
                       current0.unsqueeze(dim))
    shape = [1] * vals.dim()
    shape[dim] = -1
    return torch.where(keep.view(shape), vals, fill)


def _set_last(target: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """`target.at[idx].set(vals, mode="drop")` along dim 0, as XLA runs it.
    Returns a new tensor."""
    keep, dst, first, any_kept = _write_plan(idx, target.shape[0])
    if isinstance(vals, torch.Tensor):
        vals = vals.to(target.dtype)
    else:   # a fill, not a host-to-device copy of a Python scalar
        vals = torch.full((), vals, dtype=target.dtype, device=target.device)
    vals = vals.expand((idx.shape[0],) + target.shape[1:])
    out = target.clone()
    out[dst] = _fill(vals, keep, first, any_kept, target[0], 0)
    return out


def create_kvcache(
    cfg: KVCacheConfig, device: Union[str, torch.device, None] = "cuda"
) -> KVCacheState:
    dev = resolve_device(device)
    L, P, pg, H, dh = (
        cfg.num_layers, cfg.num_pages, cfg.page_size, cfg.num_heads,
        cfg.head_dim,
    )
    U, maxp = cfg.max_users, cfg.max_pages_per_user
    i32, i64 = torch.int32, torch.int64
    return KVCacheState(
        k_pages=torch.zeros((L, P, pg, H, dh), dtype=cfg.dtype, device=dev),
        v_pages=torch.zeros((L, P, pg, H, dh), dtype=cfg.dtype, device=dev),
        user_ids=torch.full((U,), -1, dtype=i64, device=dev),
        user_len=torch.zeros((U,), dtype=i32, device=dev),
        user_pages=torch.full((U, maxp), -1, dtype=i32, device=dev),
        user_lru=torch.zeros((U,), dtype=i64, device=dev),
        page_owner=torch.full((P,), -1, dtype=i32, device=dev),
        clock=torch.zeros((1,), dtype=i64, device=dev),
    )


def lookup_kvcache(
    state: KVCacheState, user_ids: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B] user ids -> (user slots or -1, cached lengths)."""
    eq = state.user_ids[None, :] == user_ids.to(torch.int64)[:, None]
    found = eq.any(dim=1)
    # argmax rejects bool; on ints it returns the first maximum, as JAX does
    first = eq.to(torch.int32).argmax(dim=1).to(torch.int32)
    slot = torch.where(found, first, -1)
    cached = torch.where(found, state.user_len[slot.clamp_min(0)], 0)
    return slot, cached


def allocate_kvcache(
    state: KVCacheState,
    cfg: KVCacheConfig,
    user_ids: torch.Tensor,   # [B] int64 (-1 = inactive row)
    total_len: torch.Tensor,  # [B] int32 tokens the user will have cached
) -> Tuple[KVCacheState, torch.Tensor]:
    """Ensure each user has a directory slot and enough pages; LRU-evict
    other users if the pool is short. Returns (state, user_slots [B])."""
    dev = state.user_ids.device
    U, P, pg, maxp = (
        cfg.max_users, cfg.num_pages, cfg.page_size, cfg.max_pages_per_user,
    )
    user_ids = user_ids.to(torch.int64)
    total_len = total_len.to(torch.int32)
    active = user_ids >= 0
    slot, _ = lookup_kvcache(state, user_ids)
    clock = state.clock + 1
    false_u = torch.zeros((U,), dtype=torch.bool, device=dev)

    # --- assign directory slots for new users (evict LRU non-batch users)
    in_batch = _set_last(false_u, slot.clamp_min(0), active & (slot >= 0))
    # eviction priority: free slots first, then lowest LRU, never in-batch
    slot_free = state.user_ids < 0
    prio = torch.where(
        in_batch, _I64_MAX, torch.where(slot_free, -1, state.user_lru)
    )
    order = torch.argsort(prio, stable=True)  # best victims first
    need_new = active & (slot < 0)
    new_rank = torch.cumsum(need_new.to(torch.int32), 0) - 1
    new_slot = order[new_rank.clamp(0, U - 1)].to(torch.int32)
    slot = torch.where(need_new, new_slot, slot)

    # release pages of evicted victims (their slot is being reused)
    victim = _set_last(false_u, torch.where(need_new, new_slot, U - 1), need_new)
    victim = victim & (state.user_ids >= 0)
    owner = state.page_owner
    page_owner = torch.where(
        victim[owner.clamp_min(0)] & (owner >= 0), -1, owner
    )
    user_ids_dir = torch.where(victim, -1, state.user_ids)
    user_len_dir = torch.where(victim, 0, state.user_len)
    user_pages_dir = torch.where(victim[:, None], -1, state.user_pages)

    # register new users
    new_at = torch.where(need_new, slot, U)
    user_ids_dir = _set_last(user_ids_dir, new_at, user_ids)
    user_len_dir = _set_last(user_len_dir, new_at, 0)
    act_at = torch.where(active, slot, U)
    lru = _set_last(state.user_lru, act_at, clock[0])

    # --- page allocation: pages needed per user beyond current
    have = (user_len_dir[slot.clamp_min(0)] + pg - 1) // pg
    have = torch.where(need_new, 0, have)
    want = ((total_len + pg - 1) // pg).clamp_max(maxp)
    need_pages = torch.where(active, (want - have).clamp_min(0), 0)  # [B]
    total_need = need_pages.sum()

    num_free = (page_owner < 0).sum()
    # LRU page eviction if short: evict whole users (lowest LRU, not in
    # batch) until enough pages are free
    in_batch2 = _set_last(false_u, act_at, True)
    upage_cnt = (user_pages_dir >= 0).sum(dim=1)
    evict_prio = torch.where(in_batch2 | (user_ids_dir < 0), _I64_MAX, lru)
    eorder = torch.argsort(evict_prio, stable=True)
    freed_cum = torch.cumsum(upage_cnt[eorder], 0)
    shortfall = (total_need - num_free).clamp_min(0)
    evict_k = torch.searchsorted(
        freed_cum, shortfall.reshape(1), side="left"
    )[0] + (shortfall > 0).to(torch.int64)
    evict_mask_sorted = (
        torch.arange(U, device=dev) < evict_k
    ) & (evict_prio[eorder] < _I64_MAX)
    evict_user = false_u.clone()
    evict_user[eorder] = evict_mask_sorted
    page_owner = torch.where(
        (page_owner >= 0) & evict_user[page_owner.clamp_min(0)],
        -1, page_owner,
    )
    user_ids_dir = torch.where(evict_user, -1, user_ids_dir)
    user_len_dir = torch.where(evict_user, 0, user_len_dir)
    user_pages_dir = torch.where(evict_user[:, None], -1, user_pages_dir)

    # hand out free pages: rank of each request among all needed pages
    free_pages = torch.argsort((page_owner >= 0).to(torch.int8), stable=True)
    start = torch.cumsum(need_pages, 0) - need_pages  # [B]
    pg_idx = torch.arange(maxp, dtype=torch.int32, device=dev)[None, :]
    is_new = (
        (pg_idx >= have[:, None]) & (pg_idx < want[:, None]) & active[:, None]
    )
    grant_rank = (start[:, None] + (pg_idx - have[:, None])).clamp(0, P - 1)
    granted = torch.where(is_new, free_pages[grant_rank].to(torch.int32), -1)
    # write granted pages into directories
    su = torch.where(active, slot, U)
    cur = user_pages_dir[su.clamp(0, U - 1)]
    newp = torch.where(is_new, granted, cur)
    user_pages_dir = _set_last(user_pages_dir, su, newp)
    page_owner = _set_last(
        page_owner,
        torch.where(is_new, granted, P).reshape(-1),
        slot.repeat_interleave(maxp),
    )

    new_state = state.replace(
        user_ids=user_ids_dir,
        user_len=user_len_dir,
        user_pages=user_pages_dir,
        user_lru=lru,
        page_owner=page_owner,
        clock=clock,
    )
    return new_state, torch.where(active, slot, -1)


def append_kvcache(
    state: KVCacheState,
    cfg: KVCacheConfig,
    slots: torch.Tensor,      # [B] user slots
    new_k: torch.Tensor,      # [L, B, S_new, H, dh]
    new_v: torch.Tensor,
    new_lens: torch.Tensor,   # [B] valid new tokens per user
) -> KVCacheState:
    """Write new tokens after each user's cached length. The page pools are
    written in place; the returned state shares them with `state`."""
    L, B, S, H, dh = new_k.shape
    pg, P = cfg.page_size, cfg.num_pages
    dev = slots.device
    sl = slots.clamp_min(0)
    base = state.user_len[sl]
    tok = torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    gpos = base[:, None] + tok                         # [B, S] global pos
    page_idx = (gpos // pg).clamp(0, cfg.max_pages_per_user - 1)
    in_page = gpos % pg
    pages = state.user_pages[sl]                       # [B, maxp]
    page_id = torch.gather(pages, 1, page_idx.to(torch.int64))  # [B, S]
    ok = (slots[:, None] >= 0) & (tok < new_lens[:, None]) & (page_id >= 0)
    flat = (torch.where(ok, page_id, P) * pg + in_page).reshape(-1)
    keep, dst, first, any_kept = _write_plan(flat, P * pg)
    for pool, new in ((state.k_pages, new_k), (state.v_pages, new_v)):
        rows = pool.view(L, P * pg, H, dh)
        src = new.reshape(L, B * S, H, dh).to(pool.dtype)
        rows[:, dst] = _fill(src, keep, first, any_kept, rows[:, 0], 1)
    new_len = torch.where(
        slots >= 0,
        (base + new_lens.to(torch.int32)).clamp_max(cfg.max_cached_len),
        0,
    ).to(torch.int32)
    user_len = _set_last(
        state.user_len, torch.where(slots >= 0, slots, cfg.max_users), new_len
    )
    return state.replace(user_len=user_len)


def gather_kvcache(
    state: KVCacheState,
    cfg: KVCacheConfig,
    slots: torch.Tensor,    # [B]
    max_len: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Read each user's cached KV into padded dense [L, B, max_len, H, dh]
    x2 + lengths [B]."""
    pg = cfg.page_size
    dev = slots.device
    sl = slots.clamp_min(0)
    lens = torch.where(slots >= 0, state.user_len[sl], 0)
    pos = torch.arange(max_len, dtype=torch.int32, device=dev)[None, :]
    page_idx = (pos // pg).clamp(0, cfg.max_pages_per_user - 1)
    in_page = (pos % pg).expand(slots.shape[0], max_len)
    pages = state.user_pages[sl]
    page_id = torch.gather(
        pages, 1, page_idx.to(torch.int64).expand(slots.shape[0], max_len)
    )
    ok = (pos < lens[:, None]) & (page_id >= 0)
    pid = torch.where(ok, page_id, 0).to(torch.int64)
    ip = in_page.to(torch.int64)
    m = ok[None, :, :, None, None]
    k = state.k_pages[:, pid, ip]
    v = state.v_pages[:, pid, ip]
    return (
        torch.where(m, k, k.new_zeros(())),
        torch.where(m, v, v.new_zeros(())),
        lens,
    )


def evict_users(state: KVCacheState, user_ids: torch.Tensor) -> KVCacheState:
    """Explicit eviction."""
    slot, _ = lookup_kvcache(state, user_ids)
    U = state.user_ids.shape[0]
    victim = _set_last(
        torch.zeros((U,), dtype=torch.bool, device=slot.device),
        torch.where(slot >= 0, slot, U), True,
    )
    owner = state.page_owner
    return state.replace(
        user_ids=torch.where(victim, -1, state.user_ids),
        user_len=torch.where(victim, 0, state.user_len),
        user_pages=torch.where(victim[:, None], -1, state.user_pages),
        page_owner=torch.where(
            (owner >= 0) & victim[owner.clamp_min(0)], -1, owner
        ),
    )


class HostKVStorage:
    """Host tier for evicted users' KV (counterpart of the JAX package's
    `HostKVStorage`). A user's K and V go to host RAM as one float32 row
    (bf16 values widen exactly), bucketed by cached length in power-of-two
    token widths (a user of n cached tokens lives in the smallest width >=
    n), one native store per width; the cached length rides in the score.
    With `ram_capacity_users` and `ssd_dir`, the least recently offloaded
    users beyond it spill to per-width memmap arenas under `ssd_dir` and
    are promoted back on lookup."""

    def __init__(self, cfg: KVCacheConfig, ram_capacity_users: int = 0,
                 ssd_dir: Optional[str] = None):
        self.cfg = cfg
        self._elems_per_token = 2 * cfg.num_layers * cfg.num_heads * cfg.head_dim
        self._stores = {}
        self._user_bucket = {}
        self._ram_cap = ram_capacity_users
        self._ssd_dir = ssd_dir
        self._ssd_stores = {}
        self._ssd_users = {}     # user -> width (rows living on SSD)
        self._lru = []           # RAM users, oldest first
        self.stats = {"ssd_spills": 0, "ssd_hits": 0}

    def _bucket(self, n: int) -> int:
        width = 1
        while width < n:
            width *= 2
        return min(width, self.cfg.max_cached_len)

    def _store_for(self, width: int):
        from recsys_examples_torch.utils.native import NativeHostStore

        st = self._stores.get(width)
        if st is None:
            st = self._stores[width] = NativeHostStore(self._elems_per_token * width)
        return st

    def __len__(self) -> int:
        return len(self._user_bucket) + len(self._ssd_users)

    def offload(self, state: KVCacheState, user_id: int) -> None:
        """Copy the user's cached KV to host RAM (no-op for a user without
        a cache on the card)."""
        dev = state.user_ids.device
        slot, cached = lookup_kvcache(state, torch.tensor([user_id], dtype=torch.int64,
                                                          device=dev))
        n = int(cached[0])
        if int(slot[0]) < 0 or n == 0:
            return
        width = self._bucket(n)
        k, v, _ = gather_kvcache(state, self.cfg, slot, width)
        row = np.concatenate([k[:, 0].float().cpu().numpy().reshape(-1),
                              v[:, 0].float().cpu().numpy().reshape(-1)])[None]
        uid = int(user_id)
        key = np.asarray([uid], np.int64)
        old = self._user_bucket.get(uid)
        if old is not None and old != width:
            self._stores[old].erase(key)
        self._store_for(width).put(key, row, np.asarray([n], np.int64))
        self._user_bucket[uid] = width
        if uid in self._lru:
            self._lru.remove(uid)
        self._lru.append(uid)
        self._ssd_evict_one(uid)
        self._maybe_spill()

    def _ssd_store_for(self, width: int):
        from recsys_examples_torch.dynamicemb.tiered_storage import SSDStore

        st = self._ssd_stores.get(width)
        if st is None:
            st = self._ssd_stores[width] = SSDStore(
                os.path.join(self._ssd_dir, f"kv_w{width}.bin"),
                self._elems_per_token * width, capacity=max(self._ram_cap * 8, 64))
        return st

    def _ssd_evict_one(self, uid: int) -> None:
        w = self._ssd_users.pop(uid, None)
        if w is not None:
            self._ssd_stores[w].erase(np.asarray([uid], np.int64))

    def _maybe_spill(self) -> None:
        if not self._ram_cap or self._ssd_dir is None:
            return
        while len(self._lru) > self._ram_cap:
            uid = self._lru.pop(0)
            w = self._user_bucket.pop(uid, None)
            if w is None:
                continue
            key = np.asarray([uid], np.int64)
            rows, scores, found = self._stores[w].get_scored(key)
            if found[0]:
                self._ssd_store_for(w).put(key, rows, scores[:1])
                self._ssd_users[uid] = w
                self.stats["ssd_spills"] += 1
            self._stores[w].erase(key)

    def _promote_from_ssd(self, uid: int) -> bool:
        w = self._ssd_users.get(uid)
        if w is None:
            return False
        key = np.asarray([uid], np.int64)
        rows, scores, found = self._ssd_stores[w].get(key)
        if not found[0]:
            self._ssd_users.pop(uid, None)
            return False
        self._store_for(w).put(key, rows, scores[:1])
        self._user_bucket[uid] = w
        self._lru.append(uid)
        self._ssd_stores[w].erase(key)
        self._ssd_users.pop(uid, None)
        self.stats["ssd_hits"] += 1
        self._maybe_spill()
        return True

    def lookup(self, user_id: int) -> int:
        """The user's cached token count on the host (0: none), promoting
        it from SSD to RAM when it lives there."""
        uid = int(user_id)
        width = self._user_bucket.get(uid)
        if width is None:
            if not self._promote_from_ssd(uid):
                return 0
            width = self._user_bucket[uid]
        _, scores, found = self._stores[width].get_scored(np.asarray([uid], np.int64))
        return int(scores[0]) if found[0] else 0

    def onboard(self, state: KVCacheState, user_id: int) -> KVCacheState:
        """Copy the user's host KV to the card: allocate its pages and
        append it (the page pools in place)."""
        n = self.lookup(user_id)
        if n == 0:
            return state
        width = self._user_bucket[int(user_id)]
        rows, found = self._stores[width].get(np.asarray([user_id], np.int64))
        if not found[0]:
            return state
        cfg = self.cfg
        dev = state.user_ids.device
        shape = (cfg.num_layers, width, cfg.num_heads, cfg.head_dim)
        half = self._elems_per_token * width // 2
        k = torch.from_numpy(rows[0, :half].reshape(shape)[:, :n]).to(dev)
        v = torch.from_numpy(rows[0, half:].reshape(shape)[:, :n]).to(dev)
        uid = torch.tensor([user_id], dtype=torch.int64, device=dev)
        lens = torch.tensor([n], dtype=torch.int32, device=dev)
        state, slots = allocate_kvcache(state, cfg, uid, lens)
        return append_kvcache(state, cfg, slots, k[:, None], v[:, None], lens)
