#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100: build its CUDA kernels, hold
each against its plain PyTorch version, run KV-cached HSTU ranking serving
at full width through them, and print one JSON summary.

Usage: python3 chip_smoke.py      (one card; exits non-zero without CUDA)

Phases (any failure exits non-zero):
  1. build   nvcc builds every kernel of the path from csrc/, in parallel.
  2. kernel  paged SiLU delta attention against its plain version in bf16 at
             the serving shapes (H=4, dh=256, page 128, B=8, S in {128, 512},
             ragged cache, with and without targets) and one small odd shape.
  3. main    HSTUConfig() defaults (8 layers, hidden 1024, 4 x 256, bf16,
             head (512, 1)), a 65,536-slot x 1024 item table, 8 users with
             2048 history tokens and 128 candidates: a cold pass feeding the
             history in 512-token chunks, then a warm call that recomputes
             only the candidates. Warm candidate logits must match a fresh
             full recompute on the dense gather path, and the kernel must
             have launched layers x calls times.
  4. serve   a DynamicBatcher over a RankingServer answers requests from a
             few users, some repeated, over the 64/256/1024 buckets.
The second-to-last lines are the `kernels` JSON line and the card's name and
power limit; the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import asyncio
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
BF16_FLOPS = 989e12             # H100 SXM dense bf16 tensor-core peak
FP32_FLOPS = 67e12              # H100 SXM fp32 outside the tensor cores
SEED = 0


def log(*a):
    print(*a, flush=True)


def cuda_time_ms(fn, iters):
    """Mean device time of fn() over `iters` runs, after a warm-up run."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def within(err, ref_scale):
    """The repo's kernel pass rule (tools/pallas_parity.py): err below
    2e-2 * max|ref| + 1e-3."""
    return err < 2e-2 * ref_scale + 1e-3


# ---------------------------------------------------------------- phase 2
def attention_case(gen, B, S, H, dh, pg, maxp, cached, new_lens, targets,
                   dtype=torch.bfloat16):
    dev = "cuda"
    P = B * maxp + 4
    r = lambda *s: torch.randn(*s, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(P, generator=gen, device=dev)[: B * maxp]
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)
    return dict(
        q=r(B, S, H, dh), k_pages=r(P, pg, H, dh), v_pages=r(P, pg, H, dh),
        page_table=perm.reshape(B, maxp).to(torch.int32).contiguous(),
        cached_len=i32(cached), new_k=r(B, S, H, dh), new_v=r(B, S, H, dh),
        new_lens=i32(new_lens),
        num_targets=None if targets is None else i32(targets),
    )


def attention_work(c):
    """Bytes the function must move and the FLOPs its valid (row, col) pairs
    need, for this case's data."""
    B, S, H, dh = c["q"].shape
    cached = c["cached_len"].cpu().numpy().astype(np.int64)
    new = np.minimum(c["new_lens"].cpu().numpy().astype(np.int64), S)
    tgt = (np.zeros_like(cached) if c["num_targets"] is None
           else c["num_targets"].cpu().numpy().astype(np.int64))
    pairs = 0
    for cb, nb, tb in zip(cached, new, tgt):
        i = np.arange(nb)
        rowc = np.minimum(cb + i, cb + nb - tb)
        pairs += int((np.minimum(cb, rowc) + 1 + np.clip(rowc - cb, 0, nb)).sum())
    esz = c["q"].element_size()
    tok = H * dh * esz
    nbytes = (4 * B * S * tok                     # q, new_k, new_v, out
              + 2 * int(cached.sum()) * tok        # cached K and V rows read
              + c["page_table"].numel() * 4 + 3 * B * 4)
    flops = 4 * pairs * H * dh
    return nbytes, flops


def phase_kernel(attn):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    H, dh, pg, B = 4, 256, 128, 8
    maxp = 19                                   # as the serving cache below
    full = maxp * pg
    cases = {
        # the main path's warm call: 2048 cached, 128 candidate targets
        "serve_warm": (128, [2048] * B, [128] * B, [128] * B),
        # a 512-token prefill chunk after 1536 cached tokens
        "prefill_512": (512, [1536] * B, [512] * B, None),
        "ragged_128": (128, [0, 1000, full, 2048, 127, 129, 1, 640],
                       [128, 100, 128, 1, 77, 128, 128, 5], None),
        "ragged_128_tgt": (128, [0, 1000, full, 2048, 127, 129, 1, 640],
                           [128, 100, 128, 1, 77, 128, 128, 5],
                           [16, 100, 0, 1, 30, 128, 2, 5]),
        "ragged_512_tgt": (512, [0, 1000, full - 300, 2048, 127, 129, 1, full],
                           [512, 300, 512, 1, 77, 511, 256, 5],
                           [128, 0, 64, 1, 7, 128, 3, 5]),
    }
    results = {}
    for name, (S, cached, new, tgt) in cases.items():
        results[name] = check_case(
            attn, name, attention_case(gen, B, S, H, dh, pg, maxp, cached, new, tgt),
            scaling=full)
    # one small odd shape: dh 32, 2 heads, page 16, odd S
    odd = attention_case(gen, 3, 40, 2, 32, 16, 5, [0, 37, 80], [40, 13, 39],
                         [3, 0, 39])
    results["odd_dh32"] = check_case(attn, "odd_dh32", odd, scaling=80)
    # the fp32 page mode (off the serving path, which runs bf16)
    f32 = attention_case(gen, 3, 40, 2, 64, 16, 5, [0, 37, 80], [40, 13, 39],
                         [3, 0, 39], dtype=torch.float32)
    results["odd_dh64_fp32"] = check_case(attn, "odd_dh64_fp32", f32, scaling=80)
    return results


def check_case(attn, name, c, scaling):
    dh = c["q"].shape[-1]
    args = [c[k] for k in ("q", "k_pages", "v_pages", "page_table", "cached_len",
                           "new_k", "new_v", "new_lens", "num_targets")]
    alpha = 1.0 / dh ** 0.5
    got = attn.paged_hstu_delta_attention(*args, alpha, scaling)
    torch.cuda.synchronize()
    want = attn.paged_hstu_delta_attention_ref(*args, alpha, scaling)
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    ok = within(err, scale) and torch.isfinite(got).all().item()
    kernel_ms = cuda_time_ms(
        lambda: attn.paged_hstu_delta_attention(*args, alpha, scaling), 20)
    plain_ms = cuda_time_ms(
        lambda: attn.paged_hstu_delta_attention_ref(*args, alpha, scaling), 5)
    nbytes, flops = attention_work(c)
    peak = BF16_FLOPS if c["q"].dtype == torch.bfloat16 else FP32_FLOPS
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / peak) * 1e3
    bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / peak else "operations"
    log(f"phase2 {name}: shape={tuple(c['q'].shape)} max_abs_err={err:.3e} "
        f"tol={2e-2 * scale + 1e-3:.3e} (2e-2*max|ref|+1e-3) kernel_ms={kernel_ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}: "
        f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
    if not ok:
        raise SystemExit(f"phase2 {name}: kernel disagrees with its plain version")
    return dict(err=err, kernel_ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


# ---------------------------------------------------------------- phase 3
def build_table(num_buckets, capacity, dim, num_keys, seed):
    """Item table with keys 1..num_keys placed in their hash bucket, values
    random from a seeded generator on the card."""
    from recsys_examples_torch.dynamicemb.dynamicemb_config import EMPTY_KEY, hash_keys
    from recsys_examples_torch.dynamicemb.exportable_tables import InferenceTableState

    keys = np.arange(1, num_keys + 1, dtype=np.int64)
    buckets = hash_keys(torch.from_numpy(keys), num_buckets).numpy()
    table = np.full((num_buckets, capacity), EMPTY_KEY, np.int64)
    fill = np.zeros(num_buckets, np.int64)
    for k, b in zip(keys, buckets):
        if fill[b] < capacity:
            table[b, fill[b]] = k
            fill[b] += 1
    gen = torch.Generator(device="cuda").manual_seed(seed)
    values = 0.1 * torch.randn(num_buckets * capacity, dim, generator=gen, device="cuda")
    return InferenceTableState(torch.from_numpy(table).cuda(), values), int(fill.sum())


def phase_main(attn):
    from recsys_examples_torch.inference.inference_ranking_gr import (
        InferenceDenseModule, InferenceRankingGR)
    from recsys_examples_torch.inference.kvcache import KVCacheConfig
    from recsys_examples_torch.modules.config import HSTUConfig

    cfg = HSTUConfig()
    B, hist, cand, chunk = 8, 2048, 128, 512
    S = hist + cand
    maxp = (S + 127) // 128 + 1
    kv_cfg = KVCacheConfig(
        num_layers=cfg.num_layers, num_heads=cfg.num_attention_heads,
        head_dim=cfg.kv_channels, page_size=128, num_pages=B * maxp * 2,
        max_users=B * 4, max_pages_per_user=maxp, dtype=cfg.dtype)
    table, n_keys = build_table(512, 128, cfg.hidden_size, 32768, SEED + 1)
    dense = InferenceDenseModule(cfg, (512, 1)).init_weights(
        torch.Generator().manual_seed(SEED))
    runner = InferenceRankingGR(cfg, kv_cfg, dense, table, device="cuda")
    log(f"phase3 config: {cfg.num_layers} layers, hidden {cfg.hidden_size}, "
        f"{cfg.num_attention_heads}x{cfg.kv_channels}, {cfg.dtype}, head (512, 1); "
        f"table {table.keys.numel()} slots x {cfg.hidden_size} ({n_keys} keys); "
        f"cache {kv_cfg.num_pages} pages of {kv_cfg.page_size}")

    rng = np.random.default_rng(SEED)
    users = np.arange(1, B + 1, dtype=np.int64)
    seq = rng.integers(1, 32768, size=(B, S)).astype(np.int64)
    lens = np.full((B,), S, np.int32)
    ncand = np.full((B,), cand, np.int32)

    def cold():
        runner.init_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for lo in range(0, S, chunk):
            cur = np.minimum(lens, lo + chunk)
            logits, _ = runner.forward_with_kvcache(
                users, seq, cur, ncand if lo + chunk >= S else None, chunk)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, logits

    def warm():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, new_lens = runner.forward_with_kvcache(users, seq, lens, ncand, cand)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, logits, new_lens

    cold()                                   # warm-up: cuBLAS, allocator
    calls = (S + chunk - 1) // chunk + 1
    attn.paged_hstu_delta_attention.launches = 0
    cold_ms, cold_logits = cold()
    warm_ms, logits, new_lens = warm()
    launches = attn.paged_hstu_delta_attention.launches
    warm_more = [warm()[0] for _ in range(4)]
    log(f"phase3 cold_ms={cold_ms:.2f} ({calls - 1} chunked calls) "
        f"warm_ms={warm_ms:.2f} warm_ms_median_of_5="
        f"{statistics.median([warm_ms] + warm_more):.2f} launches={launches} "
        f"expected={cfg.num_layers * calls}")
    if launches != cfg.num_layers * calls:
        raise SystemExit("phase3: the paged kernel did not carry every layer call")
    if not (torch.isfinite(logits).all() and torch.isfinite(cold_logits).all()):
        raise SystemExit("phase3: non-finite logits")
    if not (new_lens == cand).all():
        raise SystemExit(f"phase3: warm call recomputed {new_lens.tolist()} tokens")
    profile_call(lambda: runner.forward_with_kvcache(users, seq, lens, ncand, cand))

    # a fresh full recompute on the dense gather path (no kernel, no cache)
    fresh = InferenceRankingGR(cfg, kv_cfg, dense, table, device="cuda")
    fresh.init_cache()
    ref, _ = fresh.forward_with_kvcache(users, seq, lens, ncand, S,
                                        use_paged_kernel=False)
    warm_c = logits[:, :cand].float()
    ref_c = ref[:, hist:S].float()
    err = (warm_c - ref_c).abs().max().item()
    scale = ref_c.abs().max().item()
    log(f"phase3 warm candidates vs fresh recompute: max_abs_err={err:.4e} "
        f"max|ref|={scale:.4e} tol={2e-2 * scale + 1e-3:.4e} (2e-2*max|ref|+1e-3)")
    if not within(err, scale):
        raise SystemExit("phase3: warm logits disagree with the fresh recompute")
    del fresh
    torch.cuda.empty_cache()
    return runner, dict(cold_ms=cold_ms, warm_ms=warm_ms, launches=launches)


def profile_call(fn, top=10):
    """Device time of one call by kernel name (torch.profiler), and the
    share of the call's wall time the device was busy."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    log(f"phase3 profile of one warm call: wall_ms={wall_ms:.2f} "
        f"device_busy_ms={busy_ms:.2f} ({100 * busy_ms / wall_ms:.1f}% busy, "
        f"{len(events)} kernel names)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:90]}")


# ---------------------------------------------------------------- phase 4
def phase_serve(runner, attn):
    from recsys_examples_torch.inference.hstu_serving import DynamicBatcher, RankingServer

    runner.init_cache()
    srv = RankingServer(runner, max_batch=8, seq_buckets=(64, 256, 1024))
    batch_ms = []
    predict = srv.predict_batch

    def timed(*a):
        t0 = time.perf_counter()
        out = predict(*a)
        batch_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    srv.predict_batch = timed
    rng = np.random.default_rng(SEED + 2)
    base = {u: rng.integers(1, 32768, size=1024).astype(np.int64) for u in range(1, 7)}
    # (user, length, candidates): repeated users grow their history, so
    # later requests hit the cache; lengths span the three buckets
    waves = [
        [(1, 40, 8), (2, 200, 16), (3, 900, 32), (4, 60, 4), (5, 250, 16), (6, 1000, 64)],
        [(1, 56, 8), (2, 240, 16), (3, 1000, 32), (4, 64, 4), (5, 256, 16), (6, 1024, 64)],
        [(1, 180, 8), (2, 256, 16), (3, 1024, 32), (4, 600, 4)],
    ]
    launches0 = attn.paged_hstu_delta_attention.launches

    async def drive():
        b = DynamicBatcher(srv, batch_window_ms=5.0)
        outs = []
        for wave in waves:
            res = await asyncio.gather(*(b.submit(u, base[u][:n], nc) for u, n, nc in wave))
            outs.extend(zip(wave, res))
        return outs, b.get_metrics()

    outs, metrics = asyncio.run(drive())
    for (u, n, nc), scores in outs:
        if scores.shape != (nc,) or not np.isfinite(scores).all():
            raise SystemExit(f"phase4: bad scores for user {u} len {n}: {scores}")
    launches = attn.paged_hstu_delta_attention.launches - launches0
    log(f"phase4 requests={len(outs)} batches={metrics['engine_batches']} "
        f"completed={metrics['completed']} p50_batch_ms={statistics.median(batch_ms):.2f} "
        f"kernel_launches={launches}")
    if metrics["completed"] != len(outs) or launches == 0:
        raise SystemExit("phase4: not every request was answered through the kernel")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from recsys_examples_torch.ops import paged_hstu_attention as attn
    from recsys_examples_torch.utils import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    info = cuda_build.build(["paged_hstu_attention"])
    for name, i in info.items():
        log(f"phase1 build {name}: {i['seconds']:.1f} s")
        for line in i["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")

    k = phase_kernel(attn)
    runner, main_res = phase_main(attn)
    phase_serve(runner, attn)

    warm = k["serve_warm"]
    kernels = [{
        "name": "paged_hstu_delta_attention",
        "route": "cuda",
        "source": "recsys_examples_torch/csrc/paged_hstu_attention.cu",
        "replaces": "recsys_examples_tpu/ops/pallas/paged_hstu_attention.py:270",
        "launches": main_res["launches"],
        "max_abs_err": max(r["err"] for r in k.values()),
        "ms": warm["kernel_ms"],
        "plain_ms": warm["plain_ms"],
        "bound_ms": warm["bound_ms"],
        "bound_by": warm["bound_by"],
        "library_ms": None,
    }]
    log(f"phases took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
