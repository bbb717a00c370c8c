"""HTTP /generate serving front for SID-GR, SGLang-style payload
(counterpart of recsys_examples_tpu/inference/sid_serving/http.py).

Endpoints:
  POST /generate  {"input_ids": [...], "sampling_params": {"top_k": 10}}
                  -> {"sids": [[...], ...], "scores": [...], ...}
  GET  /health, /metrics

It serves the batch scheduler (`scheduler.GRContinuousScheduler`) and the
stepwise one (`continuous.ContinuousGRScheduler`) alike: a background task
ticks the scheduler in a thread while it has queued or in-flight work.
A tick replaces the scheduler's queue, so submissions and ticks hold one
lock (both run in the executor, never blocking the event loop); the JAX
front submits from the loop while a tick runs, which can lose a request.
aiohttp is imported inside the functions that serve.
"""
from __future__ import annotations

import asyncio
import threading

import numpy as np


def create_app(scheduler):
    from aiohttp import web

    tasks = []
    lock = threading.Lock()

    def locked(fn, *args, **kw):
        with lock:
            return fn(*args, **kw)

    def _has_work():
        return bool(scheduler.queue) or bool(getattr(scheduler, "inflight", ()))

    async def ticker():
        loop = asyncio.get_running_loop()
        while True:
            if _has_work():
                await loop.run_in_executor(None, locked, scheduler.tick)
            else:
                await asyncio.sleep(0.002)

    async def on_startup(app):
        tasks.append(asyncio.create_task(ticker()))

    async def on_cleanup(app):
        for t in tasks:
            t.cancel()
        for t in tasks:
            try:
                await t
            except asyncio.CancelledError:
                pass
        tasks.clear()

    async def generate(request):
        body = await request.json()
        input_ids = body.get("input_ids") or body.get("context") or []
        top_k = int((body.get("sampling_params") or {}).get("top_k", body.get("top_k", 10)))
        rid = await asyncio.get_running_loop().run_in_executor(
            None, lambda: locked(scheduler.submit, np.asarray(input_ids, np.int32), top_k=top_k))
        for _ in range(int(scheduler.request_timeout_s / 0.005)):
            res = scheduler.get_result(rid)
            if res is not None:
                return web.json_response(res, status=504 if "error" in res else 200)
            await asyncio.sleep(0.005)
        return web.json_response({"error": "timeout"}, status=504)

    async def health(request):
        return web.json_response({"status": "ok"})

    async def metrics(request):
        # the stepwise scheduler splits counters from live state
        fn = getattr(scheduler, "get_metrics", scheduler.status)
        return web.json_response(fn())

    app = web.Application()
    app.router.add_post("/generate", generate)
    app.router.add_get("/health", health)
    app.router.add_get("/metrics", metrics)
    app.on_startup.append(on_startup)
    app.on_cleanup.append(on_cleanup)
    return app


def serve(scheduler, host="0.0.0.0", port=30000):
    from aiohttp import web

    web.run_app(create_app(scheduler), host=host, port=port)
