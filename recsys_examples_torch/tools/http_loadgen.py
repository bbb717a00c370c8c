"""HTTP load generator for the port's serving fronts (the port's copy of
tools/http_loadgen.py): Poisson-ish arrivals at a target rate with bounded
concurrency, reporting throughput, latency percentiles and HTTP error
counts.

Targets:
  --url http://host:port            an already-running server
  --inprocess ranking|sid           a demo server in this process (no port
                                    opened: aiohttp's TestServer) on --device

Usage:
  python -m recsys_examples_torch.tools.http_loadgen --inprocess ranking --requests 64
  python -m recsys_examples_torch.tools.http_loadgen --url http://localhost:8000 \
      --endpoint /predict
aiohttp is imported inside the functions that serve.
"""
import argparse
import asyncio
import json
import time

import numpy as np
import torch

from recsys_examples_torch.utils.device import resolve_device


def build_ranking_app(device="cuda"):
    """A 2-layer HSTU ranking server (`/predict`) over a frozen table of
    9,999 items: hidden 64 in bf16 on the card, 16 in fp32 on the CPU."""
    from recsys_examples_torch.dynamicemb.batched_table import DynamicEmbeddingTable
    from recsys_examples_torch.dynamicemb.dynamicemb_config import (
        DynamicEmbInitializerArgs,
        DynamicEmbInitializerMode,
        DynamicEmbTableOptions,
    )
    from recsys_examples_torch.dynamicemb.exportable_tables import freeze_table
    from recsys_examples_torch.dynamicemb.optimizer import SparseOptimizerArgs
    from recsys_examples_torch.inference.hstu_serving import RankingServer, create_app
    from recsys_examples_torch.inference.inference_ranking_gr import (
        InferenceDenseModule,
        InferenceRankingGR,
    )
    from recsys_examples_torch.inference.kvcache import KVCacheConfig
    from recsys_examples_torch.modules.config import HSTUConfig

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    D = 64 if on_card else 16
    cfg = HSTUConfig(hidden_size=D, num_layers=2, num_attention_heads=2,
                     kv_channels=D // 2, hidden_dropout=0.0,
                     dtype=torch.bfloat16 if on_card else torch.float32)
    kv = KVCacheConfig(num_layers=2, num_heads=2, head_dim=D // 2, page_size=16,
                       num_pages=512, max_users=64, max_pages_per_user=16,
                       dtype=cfg.dtype)
    tbl = DynamicEmbeddingTable(
        DynamicEmbTableOptions(
            embedding_dim=D, max_capacity=1 << 14, bucket_capacity=32,
            initializer_args=DynamicEmbInitializerArgs(
                mode=DynamicEmbInitializerMode.NORMAL, std_dev=0.3)),
        SparseOptimizerArgs(optimizer="sgd"))
    st = tbl.init_state(dev)
    st, _, _ = tbl.forward_train(st, torch.arange(1, 10000, dtype=torch.int64, device=dev))
    dense = InferenceDenseModule(cfg, head_arch=(D, 1)).init_weights(
        torch.Generator().manual_seed(0))
    runner = InferenceRankingGR(cfg, kv, dense, freeze_table(tbl, st), device=dev)
    runner.init_cache()
    app = create_app(RankingServer(runner, seq_buckets=(32, 128)))

    def gen_payload(rng):
        n = int(rng.integers(4, 28))
        return "/predict", {
            "user_id": int(rng.integers(0, 64)),
            "item_ids": rng.integers(1, 9999, n).tolist(),
            "num_candidates": int(rng.integers(1, 4)),
            "timeout_s": 120.0,   # tolerate the first call's kernel builds
        }

    return app, gen_payload


def build_sid_app(device="cuda"):
    """The stepwise SID-GR scheduler's `/generate` over a 2-layer model
    (4 hierarchies, codebook 64, beam 8)."""
    from recsys_examples_torch.inference.sid_serving.continuous import ContinuousGRScheduler
    from recsys_examples_torch.inference.sid_serving.engine import ServingConfig
    from recsys_examples_torch.inference.sid_serving.http import create_app
    from recsys_examples_torch.inference.sid_serving.scheduler import BeamPolicy
    from recsys_examples_torch.models.sid_gr import SIDGRConfig, SIDGRModel

    dev = resolve_device(device)
    H = 4
    cfg = SIDGRConfig(
        num_hierarchies=H, codebook_size=64, hidden_size=64, num_layers=2,
        num_heads=4, head_dim=16, ffn_hidden=256, beam_width=8,
        dtype=torch.bfloat16 if dev.type == "cuda" else torch.float32)
    model = SIDGRModel(cfg, device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(0))
    sched = ContinuousGRScheduler(
        model, ServingConfig(beam_width=8, ctx_buckets=(64,), batch_buckets=(1, 2, 4),
                             max_batch_tokens=4096),
        max_batch=4, beam_policy=BeamPolicy(kind="fixed", width=8))
    app = create_app(sched)

    def gen_payload(rng):
        n = int(rng.integers(2, 8))
        return "/generate", {"context": rng.integers(0, 64, n * H).tolist(), "top_k": 5}

    return app, gen_payload


async def drive(client, gen_payload, n_requests, rate_hz, concurrency):
    rng = np.random.default_rng(0)
    # warm-up outside the timed window (kernel builds, first calls)
    wpath, wpayload = gen_payload(np.random.default_rng(1))
    try:
        await client.post(wpath, json=wpayload)
    except Exception:
        pass
    sem = asyncio.Semaphore(concurrency)
    lat = []
    errors = {}

    async def one(path, payload):
        async with sem:
            t0 = time.perf_counter()
            try:
                r = await client.post(path, json=payload)
                await r.json()
                if r.status != 200:
                    errors[r.status] = errors.get(r.status, 0) + 1
                    return
            except Exception as e:
                errors[type(e).__name__] = (
                    errors.get(type(e).__name__, 0) + 1
                )
                return
            lat.append(time.perf_counter() - t0)

    t_start = time.perf_counter()
    tasks = []
    for _ in range(n_requests):
        path, payload = gen_payload(rng)
        tasks.append(asyncio.get_event_loop().create_task(
            one(path, payload)
        ))
        # Poisson-ish arrivals at rate_hz
        await asyncio.sleep(float(rng.exponential(1.0 / rate_hz)))
    await asyncio.gather(*tasks)
    wall = time.perf_counter() - t_start
    lat_ms = sorted(x * 1e3 for x in lat)

    def pct(p):
        return round(lat_ms[min(len(lat_ms) - 1,
                                int(p * len(lat_ms)))], 2) if lat_ms else None

    return {
        "completed": len(lat),
        "errors": errors,
        "wall_s": round(wall, 2),
        "throughput_rps": round(len(lat) / wall, 2),
        "latency_ms": {"p50": pct(0.5), "p90": pct(0.9), "p99": pct(0.99)},
    }


async def run_inprocess(kind, n_requests, rate_hz, concurrency, device="cuda"):
    from aiohttp.test_utils import TestClient, TestServer

    build = build_ranking_app if kind == "ranking" else build_sid_app
    app, gen_payload = build(device)
    async with TestClient(TestServer(app)) as client:
        return await drive(client, gen_payload, n_requests, rate_hz, concurrency)


async def run_url(url, endpoint, n_requests, rate_hz, concurrency):
    import aiohttp

    def gen_payload(_rng):
        n = int(_rng.integers(4, 28))
        return endpoint, {
            "user_id": int(_rng.integers(0, 64)),
            "item_ids": _rng.integers(1, 9999, n).tolist(),
            "num_candidates": 2,
        }

    async with aiohttp.ClientSession(base_url=url) as client:
        return await drive(client, gen_payload, n_requests, rate_hz, concurrency)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--url", default=None)
    ap.add_argument("--endpoint", default="/predict")
    ap.add_argument("--inprocess", choices=("ranking", "sid"), default=None)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--rate", type=float, default=50.0)
    ap.add_argument("--concurrency", type=int, default=16)
    args = ap.parse_args(argv)
    if not args.url and not args.inprocess:
        ap.error("need --url or --inprocess")
    if args.inprocess:
        dev = resolve_device(args.device)
        out = asyncio.run(run_inprocess(args.inprocess, args.requests, args.rate,
                                        args.concurrency, dev))
        out["target"] = f"inprocess:{args.inprocess}"
        out["backend"] = dev.type
    else:
        out = asyncio.run(run_url(args.url, args.endpoint, args.requests, args.rate,
                                  args.concurrency))
        out["target"] = args.url
        out["backend"] = "remote"
    out["bench"] = "http_loadgen"
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
