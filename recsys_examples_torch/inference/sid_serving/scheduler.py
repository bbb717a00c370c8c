"""Continuous scheduler for SID-GR serving (counterpart of
recsys_examples_tpu/inference/sid_serving/scheduler.py): submit / tick /
run_until_empty, batches grouped by context bucket under a token budget,
request timeouts, a context -> result prefix cache, beam policies. Host code
only: the engine owns the device.

A request's times (`submitted_at`, `admitted_at`, its deadline and the
result's `latency_ms` and `queue_ms`) are on `time.perf_counter()`. A tick
runs inside the span `serve/tick`, with `serve/admit` (expiry, the batch, and
one `serve/queue` span a request admitted, from its submission to its
admission, carrying its `request_id`), the engine's `serve/generate` and
`serve/results`.
"""
from __future__ import annotations

import dataclasses
import time
import uuid
from collections import defaultdict, deque
from typing import Dict, List, Optional

import numpy as np

from recsys_examples_torch.inference.sid_serving.engine import (
    GRServingEngine,
    _bucket,
)
from recsys_examples_torch.utils import observability
from recsys_examples_torch.utils.observability import named_scope


@dataclasses.dataclass
class GRServingRequest:
    request_id: str
    context: np.ndarray              # flat SID stream
    top_k: int = 10
    submitted_at: float = 0.0
    admitted_at: float = 0.0     # when a tick took it into a batch
    deadline_s: float = 30.0
    result: Optional[dict] = None
    done: bool = False
    failed: bool = False


@dataclasses.dataclass(frozen=True)
class BeamPolicy:
    """Beam-width policy: fixed / scheduled / score-margin.

    `width_for` gives a stepwise decoder (`SIDGRModel.beam_step`) each
    hierarchy step's beam width. This batch scheduler only applies
    `filter_results` after generation."""
    kind: str = "fixed"            # fixed | scheduled | score_margin
    width: int = 64
    schedule: tuple = ()           # per-hierarchy widths when scheduled
    margin: float = 5.0            # score_margin: max logprob gap to keep

    def width_for(self, hierarchy: int) -> int:
        if self.kind == "scheduled" and self.schedule:
            return self.schedule[min(hierarchy, len(self.schedule) - 1)]
        return self.width

    def filter_results(self, paths, scores):
        """[W, H], [W] -> pruned (paths, scores) per score_margin."""
        if self.kind != "score_margin" or len(scores) == 0:
            return paths, scores
        keep = scores >= (scores.max() - self.margin)
        return paths[keep], scores[keep]


class GRContinuousScheduler:
    def __init__(
        self,
        engine: GRServingEngine,
        max_batch: int = 8,
        request_timeout_s: float = 30.0,
        beam_policy: Optional[BeamPolicy] = None,
        prefix_cache_size: int = 0,
    ):
        self.engine = engine
        self.max_batch = max_batch
        self.request_timeout_s = request_timeout_s
        self.beam_policy = beam_policy or BeamPolicy()
        self.queue: deque[GRServingRequest] = deque()
        self.finished: Dict[str, GRServingRequest] = {}
        self.metrics = defaultdict(float)
        # context -> result cache: SID generation is deterministic, so
        # identical contexts replay
        self._prefix_cache: "dict[bytes, dict]" = {}
        self._prefix_cache_size = prefix_cache_size

    # ------------------------------------------------------------ api
    def submit(self, context: np.ndarray, top_k: int = 10) -> str:
        req = GRServingRequest(
            request_id=uuid.uuid4().hex,
            context=np.asarray(context, np.int32),
            top_k=top_k,
            submitted_at=time.perf_counter(),
            deadline_s=self.request_timeout_s,
        )
        self.metrics["submitted"] += 1
        if self._prefix_cache_size:
            key = req.context.tobytes()
            hit = self._prefix_cache.get(key)
            if hit is not None and len(hit["sids"]) >= req.top_k:
                req.result = {
                    "sids": hit["sids"][: req.top_k],
                    "scores": hit["scores"][: req.top_k],
                    "latency_ms": 0.0,
                    "cached": True,
                }
                req.done = True
                self.finished[req.request_id] = req
                self.metrics["prefix_cache_hits"] += 1
                return req.request_id
        self.queue.append(req)
        return req.request_id

    def tick(self) -> int:
        """Process one batch: pop compatible requests (same ctx bucket),
        run generation, fill results. Returns number processed."""
        with named_scope("serve/tick"):
            with named_scope("serve/admit"):
                batch = self._admit()
            if not batch:
                return 0
            t0 = time.perf_counter()
            paths, scores = self.engine.generate([r.context for r in batch])
            self.metrics["batches"] += 1
            self.metrics["decode_time_s"] += time.perf_counter() - t0
            with named_scope("serve/results"):
                self._results(batch, paths, scores)
            return len(batch)

    def _admit(self) -> List[GRServingRequest]:
        """Expire timed-out requests, then take the next batch: head-of-line
        requests of one context bucket, under the token budget."""
        now = time.perf_counter()
        # expire timed-out requests
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
        if not self.queue:
            return []
        # group head-of-line requests by context bucket
        cfg = self.engine.cfg
        head = self.queue[0]
        hb = _bucket(max(len(head.context), 1), cfg.ctx_buckets)
        batch: List[GRServingRequest] = []
        rest = deque()
        budget = cfg.max_batch_tokens
        while self.queue and len(batch) < self.max_batch:
            r = self.queue.popleft()
            rb = _bucket(max(len(r.context), 1), cfg.ctx_buckets)
            if rb == hb and budget >= rb:
                batch.append(r)
                budget -= rb
            else:
                rest.append(r)
        self.queue.extend(rest)
        now = time.perf_counter()
        for r in batch:
            r.admitted_at = now
            observability.record("serve/queue", r.submitted_at, now,
                                 request_id=r.request_id)
        return batch

    def _results(self, batch: List[GRServingRequest], paths, scores) -> None:
        for i, r in enumerate(batch):
            p_i, s_i = self.beam_policy.filter_results(paths[i], scores[i])
            k = min(r.top_k, len(s_i))
            r.result = {
                "sids": p_i[:k].tolist(),
                "scores": s_i[:k].tolist(),
                "latency_ms": (time.perf_counter() - r.submitted_at) * 1e3,
                "queue_ms": (r.admitted_at - r.submitted_at) * 1e3,
            }
            if self._prefix_cache_size:
                if len(self._prefix_cache) >= self._prefix_cache_size:
                    self._prefix_cache.pop(next(iter(self._prefix_cache)))
                self._prefix_cache[r.context.tobytes()] = {
                    "sids": r.result["sids"],
                    "scores": r.result["scores"],
                }
            r.done = True
            self.finished[r.request_id] = r
            self.metrics["completed"] += 1

    def run_until_empty(self, max_ticks: int = 10_000) -> None:
        for _ in range(max_ticks):
            if not self.queue:
                return
            self.tick()

    def get_result(self, request_id: str) -> Optional[dict]:
        r = self.finished.pop(request_id, None)
        return r.result if r else None

    def status(self) -> dict:
        return {
            "queue_depth": len(self.queue),
            "finished": len(self.finished),
            "compiled_buckets": self.engine.compile_count,
            **{k: v for k, v in self.metrics.items()},
        }
