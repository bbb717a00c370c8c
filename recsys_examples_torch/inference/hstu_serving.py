"""Serving front end for KV-cached HSTU ranking inference (counterpart of
recsys_examples_tpu/inference/hstu_serving.py).

`RankingServer` pads a batch of requests into one bucketed engine call;
`DynamicBatcher` coalesces requests arriving within `batch_window_ms` into
one batch (Triton-style dynamic batching) with per-request deadlines and
queue-depth backpressure. `create_app`/`serve` put it behind HTTP with
aiohttp, imported only when they are called.

Endpoints:
  POST /predict  {"user_id": 1, "item_ids": [...], "num_candidates": 4}
                 -> {"scores": [...] }  (per-candidate logits)
  GET  /health, /metrics
"""
from __future__ import annotations

import asyncio
import time
from typing import List, Optional

import numpy as np

from recsys_examples_torch.inference.inference_ranking_gr import (
    InferenceRankingGR,
)


class QueueFullError(Exception):
    """Backpressure: the request queue is at capacity (HTTP 429)."""


class RequestTimeoutError(Exception):
    """The request's deadline passed before dispatch (HTTP 504)."""


class RankingServer:
    """Batches concurrent /predict requests into bucketed engine calls."""

    def __init__(
        self,
        runner: InferenceRankingGR,
        max_batch: int = 8,
        seq_buckets: tuple = (64, 256, 1024),
    ):
        self.runner = runner
        self.max_batch = max_batch
        self.seq_buckets = seq_buckets
        self.metrics = {"requests": 0, "batches": 0, "predict_time_s": 0.0}

    def _bucket(self, n: int) -> int:
        for b in self.seq_buckets:
            if n <= b:
                return b
        raise ValueError(f"sequence length {n} exceeds {self.seq_buckets[-1]}")

    def predict_batch(
        self,
        user_ids: List[int],
        item_ids: List[np.ndarray],
        num_candidates: List[int],
    ) -> List[np.ndarray]:
        """Synchronous batched prediction. Returns per-request candidate
        score arrays."""
        B = len(user_ids)
        maxlen = max(len(x) for x in item_ids)
        S = self._bucket(maxlen)
        ids = np.zeros((B, S), np.int64)
        lens = np.zeros((B,), np.int32)
        for i, seq in enumerate(item_ids):
            ids[i, : len(seq)] = seq
            lens[i] = len(seq)
        t0 = time.time()
        logits, new_lens = self.runner.forward_with_kvcache(
            np.asarray(user_ids, np.int64), ids, lens,
            np.asarray(num_candidates, np.int32), max_new=S,
        )
        logits_np = logits.cpu().numpy()
        new_np = new_lens.cpu().numpy()
        self.metrics["requests"] += B
        self.metrics["batches"] += 1
        self.metrics["predict_time_s"] += time.time() - t0
        out = []
        for i in range(B):
            nc = num_candidates[i]
            lo = max(int(new_np[i]) - nc, 0)
            out.append(logits_np[i, lo:int(new_np[i]), 0])
        return out


class DynamicBatcher:
    """Triton-style dynamic batcher over a RankingServer.

    One worker task drains the queue: it waits for the first request, then
    keeps admitting arrivals until `max_batch` or until `batch_window_ms`
    has elapsed since the first, drops requests whose deadline passed while
    queued, and runs ONE engine call for the batch (one card: the worker is
    the concurrency control)."""

    def __init__(
        self,
        server: RankingServer,
        max_batch: Optional[int] = None,
        batch_window_ms: float = 3.0,
        max_queue: int = 256,
        default_timeout_s: float = 5.0,
    ):
        self.server = server
        self.max_batch = max_batch or server.max_batch
        self.window_s = batch_window_ms / 1e3
        self.max_queue = max_queue
        self.default_timeout_s = default_timeout_s
        self.queue: asyncio.Queue = asyncio.Queue()
        self.metrics = {
            "enqueued": 0, "rejected_queue_full": 0, "timed_out": 0,
            "completed": 0, "engine_batches": 0, "engine_requests": 0,
        }
        self._worker: Optional[asyncio.Task] = None

    def _ensure_worker(self):
        if self._worker is None or self._worker.done():
            self._worker = asyncio.get_running_loop().create_task(
                self._drain_loop()
            )

    async def submit(self, user_id: int, item_ids: np.ndarray,
                     num_candidates: int,
                     timeout_s: Optional[float] = None) -> np.ndarray:
        # validate per request at the door: an oversize sequence fails only
        # its caller, never the requests it would be coalesced with
        self.server._bucket(len(item_ids))
        if self.queue.qsize() >= self.max_queue:
            self.metrics["rejected_queue_full"] += 1
            raise QueueFullError(f"queue at capacity {self.max_queue}")
        self._ensure_worker()
        fut = asyncio.get_running_loop().create_future()
        deadline = time.monotonic() + (
            self.default_timeout_s if timeout_s is None else timeout_s
        )
        self.queue.put_nowait((user_id, item_ids, num_candidates,
                               deadline, fut))
        self.metrics["enqueued"] += 1
        return await fut

    async def _drain_loop(self):
        loop = asyncio.get_running_loop()
        while True:
            batch = [await self.queue.get()]
            # admit arrivals until the window since the FIRST request closes
            # or the batch fills
            t_close = time.monotonic() + self.window_s
            while len(batch) < self.max_batch:
                wait = t_close - time.monotonic()
                if wait <= 0:
                    break
                try:
                    batch.append(
                        await asyncio.wait_for(self.queue.get(), wait)
                    )
                except asyncio.TimeoutError:
                    break
            now = time.monotonic()
            live = []
            for item in batch:
                *_, deadline, fut = item
                if fut.cancelled():
                    continue
                if now > deadline:
                    self.metrics["timed_out"] += 1
                    fut.set_exception(
                        RequestTimeoutError("deadline passed in queue")
                    )
                else:
                    live.append(item)
            if not live:
                continue
            uids = [it[0] for it in live]
            seqs = [it[1] for it in live]
            ncs = [it[2] for it in live]
            try:
                scores = await loop.run_in_executor(
                    None, lambda: self.server.predict_batch(uids, seqs, ncs),
                )
            except Exception as e:  # surface engine errors per request
                for *_, fut in live:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            self.metrics["engine_batches"] += 1
            self.metrics["engine_requests"] += len(live)
            for (*_, fut), sc in zip(live, scores):
                if not fut.done():
                    fut.set_result(sc)
                    self.metrics["completed"] += 1

    def get_metrics(self) -> dict:
        m = dict(self.metrics)
        m["queue_depth"] = self.queue.qsize()
        m["avg_batch_size"] = (
            m["engine_requests"] / m["engine_batches"]
            if m["engine_batches"] else 0.0
        )
        m["engine"] = dict(self.server.metrics)
        return m


def create_app(server: RankingServer, batcher: Optional[DynamicBatcher] = None):
    from aiohttp import web

    batcher = batcher or DynamicBatcher(server)

    async def predict(request):
        body = await request.json()
        user_id = int(body["user_id"])
        item_ids = np.asarray(body["item_ids"], np.int64)
        nc = int(body.get("num_candidates", 1))
        timeout_s = body.get("timeout_s")
        try:
            scores = await batcher.submit(user_id, item_ids, nc, timeout_s)
        except QueueFullError as e:
            return web.json_response({"error": str(e)}, status=429)
        except RequestTimeoutError as e:
            return web.json_response({"error": str(e)}, status=504)
        except ValueError as e:  # oversize sequence etc.: the caller's fault
            return web.json_response({"error": str(e)}, status=400)
        return web.json_response({"scores": scores.tolist()})

    async def health(request):
        return web.json_response({"status": "ok"})

    async def metrics(request):
        return web.json_response(batcher.get_metrics())

    app = web.Application()
    app.router.add_post("/predict", predict)
    app.router.add_get("/health", health)
    app.router.add_get("/metrics", metrics)
    return app


def serve(runner: InferenceRankingGR, host: str = "0.0.0.0",
          port: int = 8000) -> None:
    from aiohttp import web

    web.run_app(create_app(RankingServer(runner)), host=host, port=port)
