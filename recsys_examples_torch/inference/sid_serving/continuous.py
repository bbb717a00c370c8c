"""Continuous batching for SID-GR serving: stepwise decode over pooled
state (counterpart of recsys_examples_tpu/inference/sid_serving/
continuous.py).

  - Per-request decode state (context KV, beam KV, the beam-search arrays)
    lives in per-ctx-bucket pools of tensors on the model's device (the
    card unless the model was built elsewhere), allocated at the bucket's
    first admission. A request leases one slot at admission and releases
    it at completion; rows are read with `index_select` and written back
    with `index_copy_`. The last slot is a scratch slot: groups are padded
    to the batch bucket and pad lanes write there.
  - Every `tick()` advances every in-flight request, grouped by (step, ctx
    bucket), by up to `steps_per_dispatch` hierarchy steps
    (`SIDGRModel.beam_step`, kernel K7 on the card; the finalize too when
    the chain reaches H), then admits queued prefills under the slot leases
    and the token budget. A long-context request never blocks a short one.
  - `BeamPolicy.width_for(h)` gives step h's beam width (made
    non-increasing; `beam_step` compacts the beam KV when it narrows);
    score_margin prunes live beams by setting trailing scores to -inf.

`steps_per_dispatch` exists in the JAX package because an XLA dispatch cost
milliseconds on the TPU host. It is kept with the same meaning: one
"dispatch" is one call of a chained step function (prefill, a step chain,
a finalize), and `steps_per_dispatch >= H - 1` takes the pool-free path
that runs a whole request group in one call. Nothing is compiled here:
`_fns` records the distinct (kind, steps, batch bucket, ctx bucket) calls
made and `compile_count` counts them, the number the JAX package's jit cache
would hold.
"""
from __future__ import annotations

import dataclasses
import time
import uuid
from collections import defaultdict, deque
from typing import Dict, List, Optional

import numpy as np
import torch

from recsys_examples_torch.data.sid_batch import SIDBatch
from recsys_examples_torch.inference.sid_serving.engine import ServingConfig, _bucket
from recsys_examples_torch.inference.sid_serving.scheduler import (
    BeamPolicy,
    GRServingRequest,
)
from recsys_examples_torch.models.sid_gr import SIDGRModel

# carry key -> axis of the pool-slot dimension
_SLOT_AXIS = {
    "scores": 0, "tokens": 0, "parents": 0, "anc": 0, "kv_parents": 0,
    "ctx_lens": 0, "ctx_k": 1, "ctx_v": 1, "beam_k": 1, "beam_v": 1,
}


def _gather(pool: dict, idx: torch.Tensor) -> dict:
    return {k: v.index_select(_SLOT_AXIS[k], idx) for k, v in pool.items()}


def _scatter(pool: dict, idx: torch.Tensor, rows: dict) -> dict:
    """Write `rows` into the pool's slots `idx`, in place."""
    for k, v in pool.items():
        v.index_copy_(_SLOT_AXIS[k], idx, rows[k])
    return pool


class DecodePool:
    """Decode-state pool of one context bucket, with slot leases, a
    high-water mark and a leak check."""

    def __init__(self, slots: int):
        self.slots = slots          # includes 1 scratch slot (last)
        self.free = list(range(slots - 1))
        self.leased: set = set()
        self.high_water = 0
        self.arrays: Optional[dict] = None   # shaped at the first prefill

    @property
    def scratch_slot(self) -> int:
        return self.slots - 1

    def lease(self) -> Optional[int]:
        if not self.free:
            return None
        s = self.free.pop()
        self.leased.add(s)
        self.high_water = max(self.high_water, len(self.leased))
        return s

    def release(self, slot: int):
        if slot not in self.leased:
            raise RuntimeError(f"double release of slot {slot}")
        self.leased.remove(slot)
        self.free.append(slot)

    def check_leaks(self) -> bool:
        return len(self.free) + len(self.leased) == self.slots - 1


@dataclasses.dataclass
class _InFlight:
    req: GRServingRequest
    bucket: int
    slot: int
    step: int  # next hierarchy to decode (1..H-1); H => finalize


class ContinuousGRScheduler:
    """submit/tick/run_until_empty with interleaved prefill and stepwise
    decode over pooled state. `model` carries its params and device."""

    def __init__(
        self,
        model: SIDGRModel,
        cfg: ServingConfig,
        max_batch: int = 8,
        pool_slots: int = 17,
        request_timeout_s: float = 30.0,
        beam_policy: Optional[BeamPolicy] = None,
        steps_per_dispatch: int = 2,
        logits_processor=None,
    ):
        self.steps_per_dispatch = max(1, int(steps_per_dispatch))
        # an optional LogitsProcessorChain applied inside prefill and every
        # step; composes with the scheduled and score-margin policies
        self.logits_processor = logits_processor
        self.model = model.eval()
        self.cfg = cfg
        self.max_batch = max_batch
        self.request_timeout_s = request_timeout_s
        self.policy = beam_policy or BeamPolicy(width=cfg.beam_width)
        H = model.config.num_hierarchies
        # non-increasing width schedule (beam KV only compacts downward);
        # widths[h] = width of the survivors of step h
        w = [self.policy.width_for(h) for h in range(H)]
        for h in range(1, H):
            w[h] = min(w[h], w[h - 1])
        self.widths = w
        self.width_pad = w[0]

        self.queue: deque[GRServingRequest] = deque()
        self.inflight: List[_InFlight] = []
        self.finished: Dict[str, GRServingRequest] = {}
        self.pools: Dict[int, DecodePool] = {
            n: DecodePool(pool_slots) for n in cfg.ctx_buckets
        }
        self.metrics = defaultdict(float)
        self._fns: set = set()

    @property
    def compile_count(self) -> int:
        return len(self._fns)

    # ------------------------------------------------------------ step fns

    def _margin(self, rows: dict) -> dict:
        """score_margin: beams trailing the best by more than the margin
        stop competing."""
        if self.policy.kind == "score_margin":
            sc = rows["scores"]
            best = sc.max(dim=1, keepdim=True).values
            rows["scores"] = torch.where(sc >= best - self.policy.margin, sc, -torch.inf)
        return rows

    def _prefill(self, batch: SIDBatch) -> dict:
        return self.model.beam_prefill(batch, beam_width=self.widths[0],
                                       width_pad=self.width_pad,
                                       logits_processor=self.logits_processor)

    def _steps(self, rows: dict, h: int, h_end: int) -> dict:
        for hh in range(h, h_end):
            rows = self.model.beam_step(rows, hh, self.widths[hh - 1], self.widths[hh],
                                        logits_processor=self.logits_processor)
            rows = self._margin(rows)
        return rows

    def _finalize(self, rows: dict):
        return self.model.beam_finalize(rows, self.widths[-1])

    def _step_chain(self, pool: dict, idx: torch.Tensor, h: int, h_end: int):
        """Advance the pool's slots `idx` from step h to h_end; when h_end
        reaches H the finalize runs too and (paths, scores) come back."""
        rows = self._steps(_gather(pool, idx), h, h_end)
        _scatter(pool, idx, rows)
        if h_end >= self.model.config.num_hierarchies:
            return self._finalize(rows)
        return None

    # ------------------------------------------------------------ api
    def submit(self, context: np.ndarray, top_k: int = 10) -> str:
        req = GRServingRequest(
            request_id=uuid.uuid4().hex,
            context=np.asarray(context, np.int32),
            top_k=top_k,
            submitted_at=time.time(),
            deadline_s=self.request_timeout_s,
        )
        self.metrics["submitted"] += 1
        self.queue.append(req)
        return req.request_id

    def _slots(self, members, pool: DecodePool, Bb: int) -> torch.Tensor:
        """[Bb] slot indices of `members`, pad lanes at the scratch slot."""
        idx = np.full((Bb,), pool.scratch_slot, np.int64)
        for i, fl in enumerate(members):
            idx[i] = fl.slot
        return torch.from_numpy(idx).to(self.model.device)

    # ------------------------------------------------------------ tick
    @torch.no_grad()
    def tick(self) -> int:
        """Advance every in-flight request, finalize the completed ones, then
        admit queued prefills into free pool slots. Returns the number of
        requests progressed (steps + admits)."""
        now = time.time()
        progressed = 0
        alive = deque()
        for r in self.queue:
            if now - r.submitted_at > r.deadline_s:
                r.failed = True
                r.done = True
                r.result = {"error": "timeout"}
                self.finished[r.request_id] = r
                self.metrics["timeouts"] += 1
            else:
                alive.append(r)
        self.queue = alive

        H = self.model.config.num_hierarchies
        # finalized chunks are read back after every call of the tick has
        # been issued, so the device works while the host issues the next
        pending: List[tuple] = []
        groups = defaultdict(list)
        for fl in self.inflight:
            groups[(fl.step, fl.bucket)].append(fl)
        for (h, N), members in sorted(groups.items()):
            if h >= H:
                continue
            pool = self.pools[N]
            k = min(self.steps_per_dispatch, H - h)
            finalizes = h + k >= H
            for chunk_start in range(0, len(members), self.max_batch):
                chunk = members[chunk_start:chunk_start + self.max_batch]
                Bb = _bucket(len(chunk), self.cfg.batch_buckets)
                self._fns.add(("step", h, h + k, Bb, N))
                out = self._step_chain(pool.arrays, self._slots(chunk, pool, Bb), h, h + k)
                self.metrics["dispatches"] += 1
                if finalizes:
                    pending.append((chunk, *out, pool))
                for fl in chunk:
                    fl.step += k
                progressed += len(chunk)
                self.metrics["decode_steps"] += k * len(chunk)
        # stragglers at step H not finalized by a chain (normally none)
        pending_ids = {id(fl) for chunk, _, _, _ in pending for fl in chunk}
        done_now = [fl for fl in self.inflight
                    if fl.step >= H and id(fl) not in pending_ids]
        self.inflight = [fl for fl in self.inflight
                         if fl.step < H or id(fl) in pending_ids]
        by_bucket = defaultdict(list)
        for fl in done_now:
            by_bucket[fl.bucket].append(fl)
        for N, members in by_bucket.items():
            pool = self.pools[N]
            for cs in range(0, len(members), self.max_batch):
                chunk = members[cs:cs + self.max_batch]
                Bb = _bucket(len(chunk), self.cfg.batch_buckets)
                self._fns.add(("finalize", Bb, N))
                paths, scores = self._finalize(_gather(pool.arrays,
                                                       self._slots(chunk, pool, Bb)))
                self.metrics["dispatches"] += 1
                pending.append((chunk, paths, scores, pool))

        # read the finalized chunks back, which frees their leases for
        # admission
        if pending:
            for chunk, paths, scores, pool in pending:
                self._complete(chunk, paths.cpu().numpy(), scores.cpu().numpy(), pool)
            done_ids = {id(fl) for chunk, _, _, _ in pending for fl in chunk}
            self.inflight = [fl for fl in self.inflight if id(fl) not in done_ids]

        # admit prefills, grouped by ctx bucket. When the step chain covers
        # every hierarchy step, an admitted group runs whole in one
        # pool-free call (no lease, no scatter or gather)
        full_chain = H > 1 and self.steps_per_dispatch >= H - 1
        admit = defaultdict(list)
        budget = self.cfg.max_batch_tokens
        rest = deque()
        while self.queue:
            r = self.queue.popleft()
            N = _bucket(max(len(r.context), 1), self.cfg.ctx_buckets)
            pool = self.pools[N]
            if (
                len(admit[N]) < self.max_batch
                and budget >= N
                and (full_chain or len(pool.free) > len(admit[N]))
            ):
                admit[N].append(r)
                budget -= N
            else:
                rest.append(r)
        self.queue = rest
        if full_chain:
            full_pending = []
            for N, reqs in admit.items():
                Bb = _bucket(len(reqs), self.cfg.batch_buckets)
                batch = self._make_batch(reqs, Bb, N)
                for r in reqs:
                    r.admitted_at = time.time()
                self._fns.add(("full", Bb, N))
                paths, scores = self._finalize(self._steps(self._prefill(batch), 1, H))
                self.metrics["dispatches"] += 1
                self.metrics["prefills"] += len(reqs)
                self.metrics["decode_steps"] += (H - 1) * len(reqs)
                chunk = [_InFlight(req=r, bucket=N, slot=-1, step=H) for r in reqs]
                full_pending.append((chunk, paths, scores))
                progressed += len(reqs)
            for chunk, paths, scores in full_pending:
                self._complete(chunk, paths.cpu().numpy(), scores.cpu().numpy(), None)
            return progressed
        for N, reqs in admit.items():
            pool = self.pools[N]
            Bb = _bucket(len(reqs), self.cfg.batch_buckets)
            batch = self._make_batch(reqs, Bb, N)
            idx = np.full((Bb,), pool.scratch_slot, np.int64)
            for i, r in enumerate(reqs):
                slot = pool.lease()
                idx[i] = slot
                r.admitted_at = time.time()
                self.inflight.append(_InFlight(req=r, bucket=N, slot=slot, step=1))
            idx = torch.from_numpy(idx).to(self.model.device)
            if pool.arrays is None:
                # the bucket's first admission: the pool takes its shapes
                # from this prefill
                self._fns.update({("prefill", Bb, N), ("scatter", Bb, N)})
                carry = self._prefill(batch)
                pool.arrays = _scatter(self._init_pool_arrays(carry, N), idx, carry)
                self.metrics["dispatches"] += 2
            else:
                self._fns.add(("prefill_scatter", Bb, N))
                _scatter(pool.arrays, idx, self._prefill(batch))
                self.metrics["dispatches"] += 1
            progressed += len(reqs)
            self.metrics["prefills"] += len(reqs)
        return progressed

    def _complete(self, chunk, paths: np.ndarray, scores: np.ndarray, pool):
        """Record results for a finalized chunk and release its leases
        (pool None on the pool-free path)."""
        for i, fl in enumerate(chunk):
            p_i, s_i = self.policy.filter_results(paths[i], scores[i])
            keep = np.isfinite(s_i)
            p_i, s_i = p_i[keep], s_i[keep]
            k = min(fl.req.top_k, len(s_i))
            now = time.time()
            adm = fl.req.admitted_at or fl.req.submitted_at
            fl.req.result = {
                "sids": p_i[:k].tolist(),
                "scores": s_i[:k].tolist(),
                "latency_ms": (now - fl.req.submitted_at) * 1e3,
                "timing": {
                    "queue_ms": (adm - fl.req.submitted_at) * 1e3,
                    "decode_ms": (now - adm) * 1e3,
                    "total_ms": (now - fl.req.submitted_at) * 1e3,
                },
            }
            fl.req.done = True
            self.finished[fl.req.request_id] = fl.req
            if pool is not None:
                pool.release(fl.slot)
            self.metrics["completed"] += 1

    def _make_batch(self, reqs, Bb: int, N: int) -> SIDBatch:
        H = self.model.config.num_hierarchies
        sids = np.zeros((Bb * N,), np.int32)
        lens = np.zeros((Bb,), np.int32)
        pos = 0
        for i, r in enumerate(reqs):
            c = r.context
            n = min(len(c) - (len(c) % H), N)   # whole items only
            sids[pos:pos + n] = c[:n]
            lens[i] = n
            pos += n
        return SIDBatch(
            history_sids=sids,
            history_lengths=lens,
            history_offsets=np.concatenate([[0], np.cumsum(lens)]).astype(np.int32),
            candidate_sids=np.zeros((Bb, H), np.int32),
            batch_size=Bb,
            num_hierarchies=H,
            max_history_tokens=N,
        )

    def _init_pool_arrays(self, carry: dict, N: int) -> dict:
        S = self.pools[N].slots
        out = {}
        for k, v in carry.items():
            shape = list(v.shape)
            shape[_SLOT_AXIS[k]] = S
            out[k] = torch.zeros(shape, dtype=v.dtype, device=v.device)
        return out

    def run_until_empty(self, max_ticks: int = 10_000) -> None:
        for _ in range(max_ticks):
            if not self.queue and not self.inflight:
                return
            self.tick()

    def get_result(self, request_id: str) -> Optional[dict]:
        r = self.finished.pop(request_id, None)
        return r.result if r else None

    def status(self) -> dict:
        return {
            "queue_depth": len(self.queue),
            "inflight": len(self.inflight),
            "finished": len(self.finished),
            "compiled": self.compile_count,
            "pool_high_water": {n: p.high_water for n, p in self.pools.items()},
            "pool_free": {n: len(p.free) for n, p in self.pools.items()},
            "pool_leaks": {n: (not p.check_leaks()) for n, p in self.pools.items()},
            **{k: v for k, v in self.metrics.items()},
        }

    def get_metrics(self) -> dict:
        """Cumulative counters and live depths (`status()` reports the live
        and configured state)."""
        return {
            "counters": dict(self.metrics),
            "queue_depth": len(self.queue),
            "inflight": len(self.inflight),
            "pool_high_water": {n: p.high_water for n, p in self.pools.items()},
            "pool_utilization": {
                n: len(p.leased) / max(p.slots - 1, 1) for n, p in self.pools.items()
            },
            "compiled_executables": self.compile_count,
            "steps_per_dispatch": self.steps_per_dispatch,
        }
