#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100: build its CUDA kernels, hold
each against its plain PyTorch version, run KV-cached HSTU ranking serving,
the HSTU ranking train step (static tables; dynamic tables; dynamic tables
and the relative attention bias), SID-GR beam-search serving, the two int8
kernel modes, the gin-driven ranking and retrieval training entries, the
ranking export with its C++ replay, and SID-GR's stepwise serving and
training entry at full width through them, Qwen3 SID serving at
Qwen3-1.7B's widths and the port's tools, and print one JSON summary.

Usage: python3 chip_smoke.py      (one card; exits non-zero without CUDA)

Phases (any failure exits non-zero):
  1. build   nvcc builds every kernel of the path from csrc/, in parallel;
             no instance spills or passes its library's register ceiling,
             no setmaxnreg is dropped and ptxas serialises no wgmma chain.
             (b) the wgmma descriptors, TMA panels and register-A fragments
             of K1, K2/K3, K5 (the int8 s8 chain, exact, and V widened), K7
             (cp.async Q, a 3-D TMA chunk) and Q1 (128-key chunks), one tile
             pair per head dim, against torch.matmul.
  2. kernel  paged SiLU delta attention (K6: wgmma, keys split over a
             cluster) against its plain version in bf16 at the serving shapes
             (H=4, dh=256, page 128, B=8, S in {128, 512}, ragged cache, with
             and without targets), the decode shapes (S 8, history 3968, B 1
             and 8), unset pages mid-history beside an empty cache and caches
             ending inside a 64-key chunk, pages of 16 and 32 rows (head dims
             64, 128), one small odd shape and the fp32 scalar kernel; every
             case with padded rows exactly zero and two launches equal bit for
             bit, its plan, and event and profiler (device) times.
  3. main    HSTUConfig() defaults (8 layers, hidden 1024, 4 x 256, bf16,
             head (512, 1)), a 65,536-slot x 1024 item table, 8 users with
             2048 history tokens and 128 candidates: a cold pass feeding the
             history in 512-token chunks, then a warm call that recomputes
             only the candidates. Warm candidate logits must match a fresh
             full recompute on the dense gather path, and the kernel must
             have launched layers x calls times.
  4. serve   a DynamicBatcher over a RankingServer answers requests from a
             few users, some repeated, over the 64/256/1024 buckets.
  5. jagged  the jagged SiLU attention kernels K1 (forward), K2 (dq) and K3
             (dk, dv) through `hstu_attn_varlen` and its backward() against
             the plain forward and backward in bf16: H 4 x 256, lengths
             [2000, 37, 1024, 129, 0, 1], max_seqlen 2048, in the mask
             families causal, contextual + targets in groups of 2, window 64
             (also with a min-full tail), non-causal; H 2 x 64; then K2 and
             K3's 64-row tile edges (lengths 63-65, 127-129), contextual rows
             across a tile edge (c 70) with targets, a batch of whole tiles
             (interior tiles skip the mask), H 2 x 32 and 2 x 128; K1's
             128-row CTA edges (lengths 191-193, sequences whose consumer 1
             has no rows, c 70 and 130 across the consumer boundary).
  6. train   (a) one GRTrainer step through the kernels and the same step
             with the plain attention and the layer's plain pointwise chain,
             from the same params, at 2 layers, batch 8, history 512, on two
             batches, and a faulted control that the comparison must catch;
             (b) K1-K3 at the full-width batch's
             attention shape against the plain versions run sequence by
             sequence, K1, K2 and K3 launched twice and equal bit for bit, then
             bench.py's ranking train step (8 layers, hidden
             1024, 4 x 256, bf16, batch 32, history 4096, all five tables
             static, item/user_id at 1M rows): a warm-up pass over 7
             batches, then 6 timed steps over 6 of them, with step ms, TFLOP/s and MFU from
             hstu_flops_exact, launch counts of 8 per step for each kernel,
             and a torch.profiler step.
  7. tables  the dynamic embedding tables on the card at bench.py's table
             shape (capacity 1 << 22, bucket 128, dim 128, rowwise_adagrad):
             forward_train / backward steps on Zipf(1.05) ids over a 50M
             vocabulary, fresh and resident; then a flood that forces
             evictions in a small table (capacity 1 << 12), the same ids
             through the port on the card and on the CPU: keys, scores, slots
             and counters equal bit for bit, values to rtol 1e-5. Every
             resident key returns its row, table_size == inserted - evicted,
             no key is stored twice.
  8. rab     K4 (forward, dq + drab, dk/dv: the attention with a relative
             attention bias) through `hstu_attn_varlen(rab=...)` against the
             plain versions: rab [1,H,N,N], [B,H,N,N], [1,1,N,N], [B,1,N,N],
             fp32 and bf16, a row stride beyond max_seqlen, the mask families
             and lengths of phase 5, head dims 256 and 64, an odd row stride
             (N 131) in fp32 and bf16 at [1,H,N,N] (drab by atomics) and
             [B,H,N,N] (stored); K4's forward at K1's 128-row CTA edges
             (lengths 191-193, consumer 1 without rows, c 70 and 130) and
             its dk/dv at K3's 64-row tile edges (lengths 63-65, 127-129)
             and on a batch of whole tiles (interior tiles skip the mask
             but add the bias), each with an fp32 [1,H,N,N+3] and a bf16
             [B,H,N,N+3] bias (odd row stride); K4's dq and drab with a
             [B,H,N,N] bias launched twice and equal bit for bit.
  9. step    (a) bench.py's whole train step at full width: phase 6b's model
             with `item` and `user_id` in two dynamic tables (50M-id
             vocabularies, 4.2M rows each), a warm-up pass over the pool,
             then timed steps with the share of phases A and C, the tables'
             counters, a profiled step, and bench.py's JSON line; (b) the
             same step with use_relative_attention_bias (128 buckets, max
             distance 1024) for 2 timed steps, K4's launch counts of 8 per
             step, K4's times at the full-width shape beside K1-K3's (its
             kernels launched twice, out, dq, dk and dv equal bit for bit),
             peak memory, a profiled
             step; (c) phase 6a's kernels-against-plain step and its
             faulted control once more with dynamic tables and the bias.
 10. beam    K7 (beam-decode attention) through `beam_decode_attn` against
             its plain version, bf16 and fp32: the full-width decode step (B
             16, W 200, H = Hkv = 8 x 128, S 1025, the context lengths of the
             seed-0 SID batch, N 1..4 with random ancestry), GQA (Hkv 2, 1;
             groups of 2, 4 and 8 at W 200), N 0, W 1, 7, 64, 65, 128, 129
             and 256, D 64 and 32, context lengths 0 (with N 0 and N 3), 1, S
             and around 32- and 64-key chunk edges, every batch row held on
             its own scale and every case launched twice, equal bit for bit;
             phase 11's B 1 step under each split from 1 to the plan's,
             against the unsplit kernel too; kernel (event and device),
             plain and bound ms, and for the record
             `scaled_dot_product_attention` over the context keys alone.
 11. sid     `SIDGRModel` at benchmarks/benchmark_beam_decode.py's widths (4
             hierarchies, codebook 256, hidden 1024, 8 layers, 8 x 128, ffn
             4096, beam 200, bf16), `random_sid_batch(0, B, 256, 4, 256)`
             for B 1 and 16: `generate_beam_decode` timed, K7 launched 24
             times a call; at B 1 the no-KV `generate` as its oracle; the
             same call through the plain attention against the kernels, each
             K7 call of every decode step against the plain version on its
             own inputs, and faulted controls (sm_scale x 1.02) that both
             comparisons must catch; the benchmark's JSON line per B.
 12. sid_serve  benchmarks/benchmark_sid_serving.py's sidgr path (hidden 512,
             8 layers, 4 x 128, ffn 1024, bf16, beam 64, ctx 512, batch 8):
             the offline batch and per-request latency through
             `GRContinuousScheduler`, then a dozen requests of mixed lengths
             over `ServingConfig()`'s buckets with the prefix cache on; its
             JSON line.
 13. quant   K6-int8 against its plain version at
             benchmarks/benchmark_paged_kv.py's points (H 4 x 256, page 128,
             8 new tokens, history 1024 and 3968, batch 1 and 8, with and
             without targets) beside the bf16 kernel on the same pages, then
             pages of 16 and 32 rows with unset pages, an empty cache, the
             two-consumer instance and scales that do not ride TMA (H 2),
             with phase 2's padded-row and repeat checks; K5
             against its plain version at phase 5's lengths and mask families,
             at K1's 128-row CTA edges (c 70 and 130, head dims 32-256, a
             batch of whole tiles) and at the full-width training shape, each
             launched twice (equal bit for bit), its error against the bf16
             forward, its time beside K1's in turns and both bounds (S at the
             int8 rate, and both products at the bf16 rate).
 14. entries the gin-driven training entries as a user runs them
             (`training/pretrain_gr_ranking.py`, `pretrain_gr_retrieval.py`):
             (a) ranking on configs/ranking_kuairand_bench.gin (8 layers,
             hidden 1024, 4 x 256, bf16, batch 32, history 2048, 128
             candidates, an item table of 4,194,304 x 1024): 6 steps,
             checkpoints and evals at steps 3 and 6, a profiled step 5; K1-K3 at 8
             launches a step (counters and the entry's profile); the step-3
             checkpoint loaded into a fresh state gives step 3's eval AUC bit
             for bit and every dumped key its row; steps 4-6 again as bare
             train steps on the entry's batches, already on the card, with the
             entry's losses; (b) that model at 2
             layers with dropout 0.1: two steps with recompute_layer on and
             off, equal bit for bit; (c) a synthetic MovieLens-1M ratings.dat
             (6,040 users, 3,706 movies, ~1M rows) through
             preprocess_movielens, SequenceDataset on the native packer and
             PrefetchIterator in the ranking entry at
             ranking_movielens_1m.gin's widths: 12 steps (step 10 profiled)
             and an eval over the holdout; (d) the retrieval entry at retrieval_movielens_1m.gin's
             widths over (c)'s file: 12 steps, HR@10, NDCG@10 and MRR finite
             in [0, 1]; K1-K3 at 4 launches a step in both, and K1-K3
             against their plain versions (phase 5's check) at the lengths,
             mask and 4 x 64 heads of each entry's first attention call.
 15. cache   the embedding cache and its host tiers: (a) the ranking entry
             with DynamicEmbeddingArgs.caching at 14a's full width over a
             32,768-row item table and a 131,072-id vocabulary, 8 steps:
             host onboards and evict flushes > 0, no insert failure, no batch
             key left off the card by its prefetch, losses within 1e-5 of the
             entry uncached at 524,288 rows, the prefetch's share of the
             step, K1-K3 against their plain versions at its first attention
             call; (d) its item table frozen: inference_lookup and the
             exported program (torch.export, loaded back) equal forward_eval
             bit for bit; (b) a cache over TieredHostStorage (4,096 RAM rows
             of 14a's width over an SSD arena): rows come back through spill
             and promote bit for bit; (c) pooled SUM and MEAN and grouped
             tables at benchmark_dynamicemb.py's sizes (65,536 ids, 2,048
             bags, dim 128, capacity 1 << 22) against separate lookups, with
             step ms.
 16. kv      KV offload at phase 3's serving widths: a warmed user offloaded
             to the host tier, evicted and onboarded, then two users through
             a 1-user RAM tier over SSD (spill and promote); the warm call's
             scores equal the never-evicted call's bit for bit; K6 launches.
 17. repairs the shapes the kernels once refused, against their plain
             versions: K1-K5 at head dims 16, 48 and 96 (padded), K6 at head
             dim 96 and page sizes 24, 48 and 100, bf16 and int8 pages, K6-int8
             on fp32 queries, K7 at D 256 (GQA too) and D 96.
 18. mesh    the distribution slice at world size 1 over NCCL: (a) a
             process group from a FileStore in a temp dir; every collective
             of parallel/collective_ops.py forward and backward on CUDA
             tensors, and the dynamic table's exchange through
             all_to_all_single; (b) 14a's config through the ranking entry on
             the (data 1, model 1) mesh for 4 steps: the losses equal 14a's
             first four within 1e-5, K1-K3 at 8 launches a step, and against
             their plain versions at the first attention call; (c) K1-K3
             against their plain versions at a TP 2 rank's full-width shape,
             2 x 256 heads, on the first data half of that call's lengths.
 19. export  the ranking export at phase 3's widths (B 8, max_new 128,
             max_cached 2048): (a) `export_ranking_dense`, then
             `ExportedRankingDense`: its logits against the eager gather path
             within phase 3's tolerance (the paged K6 path's for the record);
             (b) the AOTInductor package: its build seconds, load, and call
             against (a), timed beside the eager gather path; (c) the C++
             runner `csrc/aoti_replay.cpp`: built against torch, a
             dry run that reads the spec's every input, and a real run on
             the same inputs whose logits' sum and max match (b)'s.
 20. sid     SID-GR's stepwise serving, HTTP front and training entry at
             phase 11's widths: (a) `ContinuousGRScheduler` at
             `ServingConfig()` (beam 64, ctx buckets 64/256/1024, batch
             buckets 1/4/8) over a wave of 32 requests in all three buckets,
             steps_per_dispatch 1 and 2: K7 against its plain version at the
             path's first call, K7's launches per tick, each request against
             `GRServingEngine.generate` on its context (rank-wise scores
             within 0.1, no beam clear of its neighbours differing) and a
             faulted control (K7 with sm_scale x 1.1) that this must catch;
             then a scheduled width policy, the score margin, and the trie
             constraint with the margin; ticks, req/s, median and p99 ms,
             the pools' high-water marks, one profiled decode tick; (b)
             /generate over HTTP for 8 requests when aiohttp imports (the
             line says whether it did); (c) `pretrain_sid_gr.main` on
             configs/sid_gr_random.gin as shipped, at (a)'s model widths
             (beam 200, 10 steps, one eval batch) and on sid_gr_file.gin over
             a synthetic interaction log through `preprocess_interactions`
             and `build_rq_sid_mapping`: step ms, eval metrics, K7's launches
             ((H - 1) x L per eval batch) and K7 against its plain version at
             each eval's first call.
 21. qwen3   Qwen3 SID serving at Qwen3Config()'s widths (Qwen3-1.7B: vocab
             151,936, hidden 2048, 28 layers, 16 q / 8 kv heads x 128,
             intermediate 6144, tied embedding) in bf16 from a seeded init:
             (a) `Qwen3ServingEngine.generate` at `ServingConfig()` (beam 64)
             with 4 steps on contexts drawn as benchmark_sid_serving.py's at
             --ctx 1024 --batch 8, then `GRContinuousScheduler` online: K7's 84
             launches a generate, offline batch ms, req/s, online median and
             p99, a profiled generate through `profiler_window` (the runtime's
             named scopes), the W x V sort's ms, peak memory, one JSON line;
             (b) K7 against its plain version at the path's first and last
             decode call; the cached decode's scores against the teacher-forced
             prefill of the same paths (B 2, context bucket 64) within
             QWEN3_LIMITS, in bf16 on three model seeds x two context draws
             and in fp32 (K7's fp32 kernel) on two draws; each faulted
             control of QWEN3_FAULTS (sm_scale x 1.1, ancestry not
             re-rooted, earlier steps' beam KV left out) must break it on
             every draw; (c) a 2-layer checkpoint at full width written in
             HF bf16 layout and read by `load_hf_weights` (no safetensors
             package): prefill logits and KV equal the built model's bit for
             bit; (d) the port's tools on the card at cut sizes
             (`kernel_parity`, `serving_soak --requests 32`, `http_loadgen
             --inprocess ranking|sid` for 32 requests, and the three
             convergence tools for 4 iterations), each JSON line on cuda.
 22. pointwise  the HSTU layer's fused pointwise kernels
             (`ops/hstu_pointwise.py`: input LayerNorm, uvqk bias + SiLU,
             LayerNorm times u, each forward and backward) at the hstu_train
             cell's shape (T 32,689, D 1024, bf16) against their plain
             versions, each output on its own (the rules of
             tests/test_torch_hstu_pointwise.py: two bf16 ulps, the column
             sums to a few fp32 ulps of their terms): event and device
             (events around calls queued behind a sleep kernel) ms, the byte
             bound, the plain version's ms, F.layer_norm's ms beside the
             input LayerNorm's, and the launches of one 8-layer full-width
             train step through them (48).
 23. moe     the grouped expert GEMM (`ops/moe.py`, both epilogues) against
             its plain version at LFM2-24B-A2B's widths (64 experts, top 4,
             D 2048, I 1536) from a router draw at the serving cell's 2,048
             rows (its decode step and its prefill alike), at 256 rows (batch
             1), and on a skewed routing with empty experts and experts of
             several row tiles; launched twice, equal bit for bit; event and
             device (queued) ms, the bound, the plain version's ms and
             `torch._grouped_mm`'s where the card's torch has it. K7 at D 64
             with GQA group 4 (32 / 8 heads, W 256, S 256, N 0-2). Then a
             4-layer LFM2 at full width through `qwen3_generate_beam`, with
             `torch.cuda.set_sync_debug_mode("error")` around every MoE
             layer and conv decode call (no host sync inside them), and its
             grouped-GEMM launches (2 a MoE layer a pass) and its prefill
             attention launches (Q1, one an attention layer: 10).
 24. prefill the causal GQA prefill attention Q1 (`ops/prefill_attention.py`)
             against its plain version and against its own arithmetic in
             plain PyTorch (`prefill_attn_tiled_ref`), on valid rows, rows at
             or past each length exactly zero, two launches equal bit for
             bit: at the qwen3_sid_ctx1k cell's shape (B 8, bucket 1024,
             contexts 512-1016, 16 / 8 heads of 128) and lfm2_sid_beam256's
             (B 8, bucket 256, 32 / 8 x 64), lengths 1, 127-129 and the whole
             bucket at a bucket + 3 (the teacher-forced prefill's), a padded
             head dim (96), the fp32 scalar kernel; at both cell shapes its
             event and device (queued) ms against the valid pairs' bound, the
             plain version's ms and, as a yardstick only, causal
             `F.scaled_dot_product_attention`'s. Then Qwen3-1.7B whole: its
             prefill at the ctx1k shape profiled (Q1, GEMMs, the rest) and a
             whole `qwen3_generate_beam` under
             `torch.cuda.set_sync_debug_mode("error")`, Q1 launched once a
             layer (28) on the wrapper's counter and on the tracer's.
The second-to-last lines are the `kernels` JSON line and the card's name and
power limit; the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import asyncio
import json
import logging
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

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


def median_time_ms(fn, iters, reps=3):
    """Median of `reps` readings of cuda_time_ms: one reading lengthened by a
    stall (once 5x a kernel's time at the main shape) does not become the
    kernel's time."""
    return statistics.median(cuda_time_ms(fn, iters) for _ in range(reps))


def device_ms(fn, pattern, iters=20):
    """Mean device time of one launch of the kernels whose profiler names
    match `pattern`, over `iters` calls of fn after a warm-up (torch.profiler;
    the mean over the launches it recorded): the kernel's own time, also
    where the host's launch rate bounds an event timing (a wrapper call
    costs the host 30-60 us)."""
    import re

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type.name == "CUDA" and re.search(pattern, e.key)]
    launches = sum(e.count for e in hits)
    if not launches:   # the profiler recorded none of them: no reading
        return float("nan")
    return sum(e.self_device_time_total for e in hits) / 1e3 / launches


SLEEP_CYCLES = 50_000_000    # >= 25 ms at the H100's top clock of 1.98 GHz


def queued_ms(fn, iters=20, reps=3):
    """Device time of one fn() call: CUDA events around `iters` calls
    queued behind a sleep kernel, so the card runs them back to back and
    the host's launch rate does not pace them; the median of `reps`
    readings. NaN if the host took 20 ms or more to queue them (the sleep
    may have ended first). Phase 22 reads this and not `device_ms`: late
    in this script's process the profiler recorded none of the pointwise
    forward kernels' launches, or 16 of 20."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters if queued_s < 0.02 else float("nan"))
    return statistics.median(times)


PAGED_KERNELS = r"paged_wgmma_kernel|scalar::kernel"


def within(err, ref_scale):
    """The repo's kernel pass rule (tools/pallas_parity.py): err below
    2e-2 * max|ref| + 1e-3."""
    return err < 2e-2 * ref_scale + 1e-3


def demangle(sym):
    """`ns::name<args>` of a mangled kernel symbol, its template arguments
    written as in C++ (the anonymous namespace dropped):
    `..N6scalar6kernelILi128EE..` reads `scalar::kernel<128>`,
    `..15dq_wgmma_kernelILi256ELb1EE..` `dq_wgmma_kernel<256, true>`."""
    import re

    if not sym.startswith("_ZN"):
        return sym
    rest, names = sym[3:], []
    while rest[:1].isdigit():
        n = re.match(r"\d+", rest).group(0)
        names.append(rest[len(n):len(n) + int(n)])
        rest = rest[len(n) + int(n):]
    names = [n for n in names if not n.startswith("_GLOBAL__N")]
    t = re.match(r"I((?:L[ib]\d+E)+)E", rest)
    if not t or not names:
        return "::".join(names) or sym
    args = [v if k == "i" else ("true" if v == "1" else "false")
            for k, v in re.findall(r"L([ib])(\d+)", t.group(1))]
    return "::".join(names) + f"<{', '.join(args)}>"


def ptxas_entries(report):
    """(kernel, registers, bytes spilled) of each entry in `-Xptxas -v`'s
    report, the kernel as `demangle` names it."""
    import re

    out, entry, spill = [], None, 0
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = demangle(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out.append((entry, int(m.group(1)), spill))
            entry = None
    return out


# Most registers of any kernel instance on the path, per library, as built
# for sm_90a by CUDA 12.8's nvcc (this script's own report); none of them
# may spill. K1, K4's forward and K5 (hstu_attention_fwd), K2, K3 and K4's
# dq and dk/dv (hstu_attention_bwd), K6's bf16 and int8 instances
# (paged_hstu_attention) and K7's bf16 kernel (beam_decode_attention) launch
# up to 384 threads for one CTA per SM, so ptxas holds them to 168 at entry;
# setmaxnreg then moves the producer's registers to the consumer warpgroups
# (240 each in K1 and K4's forward, 216 in K5 and K7, 232 in the backward
# and K6). The fp32 scalar kernels of K6 and K7 keep their own ceiling
# (ENTRY_CEILING). The grouped expert GEMM (moe_grouped_gemm) and the
# prefill attention Q1 (prefill_attention) launch 384 threads too, their
# consumers at 232 and 240. The fused pointwise kernels (hstu_layer_pointwise: 256
# threads, no setmaxnreg, no wgmma) are held to no spill within the 255
# registers a thread can have.
REGISTER_CEILING = {"hstu_attention_fwd": 168, "hstu_attention_bwd": 168,
                    "paged_hstu_attention": 168, "beam_decode_attention": 168,
                    "hstu_layer_pointwise": 255, "moe_grouped_gemm": 168,
                    "prefill_attention": 168}
ENTRY_CEILING = {"scalar::kernel": 128}
WGMMA_LIBS = tuple(n for n in REGISTER_CEILING if n != "hstu_layer_pointwise")


# ---------------------------------------------------------------- phase 1
def phase_build():
    from recsys_examples_torch.utils import cuda_build

    info = cuda_build.build(list(REGISTER_CEILING))
    for name, i in info.items():
        log(f"phase1 build {name}: {i['seconds']:.1f} s")
        for line in i["ptxas"].splitlines():
            if "warning" in line.lower() or "Performance Loss" in line:
                log(f"  {line.strip()[:300]}")
                # a warp-specialised kernel whose setmaxnreg is dropped runs
                # its consumers in 168 registers; one whose wgmma chains ptxas
                # serialises (note C7520) loses their overlap
                if "setmaxnreg" in line or (name in WGMMA_LIBS and "Performance Loss" in line):
                    raise SystemExit(f"phase1: {name}: {line.strip()}")
        for entry, regs, spill in ptxas_entries(i["ptxas"]):
            log(f"  ptxas {entry}: {regs} registers, {spill} bytes spilled")
            # the layout checks of phase 1b run 128 or 256 threads: no ceiling
            ceiling = next((c for k, c in ENTRY_CEILING.items() if k in entry),
                           REGISTER_CEILING[name])
            over = regs > ceiling and "tile_check" not in entry
            if over or spill:
                raise SystemExit(f"phase1: {entry} grew to {regs} registers, {spill} spilled")


def phase_tile_check():
    """1b. The wgmma descriptors, TMA panel layouts and register fragments,
    each by itself: each kernel's two product chains on one TMA-loaded tile
    pair per head dim against torch.matmul in fp32. K2/K3: the score chain
    K-major from the columns w * 32 of two consumers, the output chain
    MN-major from a thread-written product tile, from the columns w * dh/2.
    K1: the m64n64 score chain K-major, and the output chain with A in
    registers (a matrix put in the accumulator layout and repacked by
    `acc_to_a`, as K1 repacks P), B MN-major. K5: the int8 score chain
    (m64n64k32 s8) on two int8 tiles, which must equal the fp32 product of
    the widened tiles exactly, and the output chain on the tile's int8 rows
    widened as K5's widening warps do. K7: a Q tile copied into the panel
    layout by cp.async and a chunk of K/V loaded through a 3-D map, the
    score chain K-major and the output chain from the softmax's accumulator
    layout, B MN-major. Q1: a Q tile and a 128-key chunk both loaded
    through 3-D maps, the m64n128 score chain K-major and the output chain
    from the accumulator layout over 128 keys. Products of bf16 values are
    exact in fp32, so only the order of the sums differs."""
    import ctypes

    from recsys_examples_torch.utils import cuda_build

    checks = (("K2/K3", "hstu_attention_bwd", "hstu_bwd_tile_check_launch",
               ("score (K-major)", "output (MN-major)"), (32, 64, 128, 256)),
              ("K1", "hstu_attention_fwd", "hstu_fwd_tile_check_launch",
               ("score (K-major, n64)", "output (register A, MN-major)"), (32, 64, 128, 256)),
              ("K5", "hstu_attention_fwd", "hstu_fwd_i8_tile_check_launch",
               ("score (int8 K-major, m64n64k32, exact)", "output (widened V, MN-major)"),
               (32, 64, 128, 256)),
              ("K7", "beam_decode_attention", "beam_tile_check_launch",
               ("score (cp.async Q, 3-D TMA chunk, K-major)", "output (register A, MN-major)"),
               (32, 64, 128, 256)),
              ("Q1", "prefill_attention", "prefill_tile_check_launch",
               ("score (3-D TMA Q and 128-key chunk, K-major, n128)",
                "output (register A over 128 keys, MN-major)"), (64, 128)))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    r = lambda *sh: torch.randn(*sh, generator=gen, device="cuda").to(torch.bfloat16)
    i8 = lambda *sh: torch.randint(-127, 128, sh, generator=gen, device="cuda",
                                   dtype=torch.int32).to(torch.int8)
    for kernel, lib, entry, tags, dims in checks:
        fn = getattr(cuda_build.load(lib), entry)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        keys = 128 if kernel == "Q1" else 64
        for dh in dims:
            a, pm = r(64, dh), r(64, keys)
            b = i8(64, dh) if kernel == "K5" else r(64, dh)
            if kernel == "K5":
                a = i8(64, dh)
            # K7 and Q1 read their chunk from batch 1
            x = r(2, keys, dh) if kernel in ("K7", "Q1") else b
            s = torch.full((64, keys), float("nan"), device="cuda")
            o = torch.full((64, dh), float("nan"), device="cuda")
            err = fn(a.data_ptr(), x.data_ptr(), pm.data_ptr(), s.data_ptr(), o.data_ptr(), dh,
                     torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            if err:
                raise SystemExit(f"phase1b {kernel} dh={dh}: launch failed with error {err}")
            if kernel in ("K7", "Q1"):
                b = x[1]
            for tag, got, want in ((tags[0], s, a.float() @ b.float().T),
                                   (tags[1], o, pm.float() @ b.float())):
                e = (got - want).abs().max().item()
                scale = want.abs().max().item()
                tol = 0.0 if kernel == "K5" and got is s else 1e-4 * scale
                log(f"phase1b {kernel} dh={dh} {tag}: max_abs_err={e:.3e} "
                    f"max|ref|={scale:.3e} tol={tol:.3e}")
                if not e <= tol:
                    raise SystemExit(f"phase1b {kernel} dh={dh}: the {tag} chain disagrees "
                                     "with torch.matmul")


# ---------------------------------------------------------------- phase 2
def attention_case(gen, B, S, H, dh, pg, maxp, cached, new_lens, targets,
                   dtype=torch.bfloat16, unset=()):
    """Random operands of the paged attention; `unset`: (user, page slot)
    pairs whose page id is -1."""
    dev = "cuda"
    P = B * maxp + 4
    r = lambda *s: torch.randn(*s, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(P, generator=gen, device=dev)[: B * maxp]
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)
    page_table = perm.reshape(B, maxp).to(torch.int32).contiguous()
    for b, j in unset:
        page_table[b, j] = -1
    return dict(
        q=r(B, S, H, dh), k_pages=r(P, pg, H, dh), v_pages=r(P, pg, H, dh),
        page_table=page_table, cached_len=i32(cached), new_k=r(B, S, H, dh),
        new_v=r(B, S, H, dh), new_lens=i32(new_lens),
        num_targets=None if targets is None else i32(targets),
    )


def cached_rows_read(c):
    """Cached positions that lie on a set page: the page rows a call reads."""
    pg, maxp = c["k_pages"].shape[1], c["page_table"].shape[1]
    pos = torch.arange(maxp * pg, device=c["page_table"].device)
    on_set = (c["page_table"] >= 0).repeat_interleave(pg, dim=1)
    return int((on_set & (pos[None] < c["cached_len"][:, None])).sum())


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
              + 2 * cached_rows_read(c) * tok      # cached K and V rows read
              + c["page_table"].numel() * 4 + 3 * B * 4)
    flops = 4 * pairs * H * dh
    return nbytes, flops


def paged_plan(attn, c):
    """The wgmma instances' plan for this case, as the wrapper launches it."""
    return attn.paged_launch_plan(c["q"], c["k_pages"], c["page_table"])


def padded_rows_zero(got, new_lens):
    """Rows i >= new_len of every user are exact zeros."""
    S = got.shape[1]
    pad = torch.arange(S, device=got.device)[None, :] >= new_lens[:, None]
    return not bool(got[pad].any())


def phase_kernel(attn):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    H, dh, pg, B = 4, 256, 128, 8
    maxp = 19                                   # as the serving cache below
    full = maxp * pg
    hist = 3968                                 # phase 13's longest history
    # what the launch plan reads: clusters of 1-16 CTAs the card holds at once
    dev = torch.cuda.current_device()
    for int8 in (False, True):
        for nc in (1, 2):
            caps = {s: attn.paged_cluster_capacity(dev, int8, dh, nc, H, s)
                    for s in range(1, attn.MAX_SPLITS + 1)}
            log(f"phase2 cluster capacity int8={int(int8)} consumers={nc} dh={dh} H={H}: "
                f"{caps}")
            if caps[1] < 1:
                raise SystemExit("phase2: the card holds no CTA of the paged kernel")
    cases = {
        # the main path's warm call: 2048 cached, 128 candidate targets
        "serve_warm": (B, 128, [2048] * B, [128] * B, [128] * B),
        # a 512-token prefill chunk after 1536 cached tokens
        "prefill_512": (B, 512, [1536] * B, [512] * B, None),
        "ragged_128": (B, 128, [0, 1000, full, 2048, 127, 129, 1, 640],
                       [128, 100, 128, 1, 77, 128, 128, 5], None),
        "ragged_128_tgt": (B, 128, [0, 1000, full, 2048, 127, 129, 1, 640],
                           [128, 100, 128, 1, 77, 128, 128, 5],
                           [16, 100, 0, 1, 30, 128, 2, 5]),
        "ragged_512_tgt": (B, 512, [0, 1000, full - 300, 2048, 127, 129, 1, full],
                           [512, 300, 512, 1, 77, 511, 256, 5],
                           [128, 0, 64, 1, 7, 128, 3, 5]),
        # phase 13's decode shapes in bf16: one consumer, 4 and 8 splits
        "decode_b8": (B, 8, [hist] * B, [8] * B, None),
        "decode_b1": (1, 8, [hist], [8], None),
    }
    results = {}
    for name, (b, S, cached, new, tgt) in cases.items():
        mp = maxp if max(cached) <= full else -(-hist // pg)
        results[name] = check_case(
            attn, name, attention_case(gen, b, S, H, dh, pg, mp, cached, new, tgt),
            scaling=mp * pg)
    # unset pages mid-history, a user with nothing cached beside full ones,
    # caches that end inside a 64-key chunk
    holes = attention_case(gen, B, 128, H, dh, pg, maxp,
                           [2048, 0, 2000, 2048, 1500, 77, 2048, 2047],
                           [128, 128, 100, 5, 128, 64, 1, 128],
                           [128, 0, 50, 5, 0, 64, 1, 17],
                           unset=[(0, 5), (2, 3), (3, 15), (7, 0)])
    results["holes_128"] = check_case(attn, "holes_128", holes, scaling=full)
    # pages of 16 and 32 rows (64 / pg boxes a chunk), head dims 64 and 128,
    # the two-consumer instance with a part-filled second consumer (S 72)
    pg16 = attention_case(gen, 4, 128, 8, 64, 16, 130, [2048, 0, 1000, 333],
                          [128, 128, 77, 128], None, unset=[(0, 40), (3, 2)])
    results["pg16_dh64"] = check_case(attn, "pg16_dh64", pg16, scaling=2080)
    pg32 = attention_case(gen, 4, 72, 2, 128, 32, 40, [1280, 0, 700, 323], [72, 72, 5, 64],
                          [8, 0, 5, 0], unset=[(0, 7), (2, 21)])
    results["pg32_dh128"] = check_case(attn, "pg32_dh128", pg32, scaling=1280)
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
    """The kernel against its plain version (2e-2 max|ref| + 1e-3), padded
    rows exactly zero, two launches equal bit for bit; kernel and plain ms
    (medians of three readings) and the bound."""
    dh = c["q"].shape[-1]
    args = [c[k] for k in ("q", "k_pages", "v_pages", "page_table", "cached_len",
                           "new_k", "new_v", "new_lens", "num_targets")]
    alpha = 1.0 / dh ** 0.5
    got = attn.paged_hstu_delta_attention(*args, alpha, scaling)
    again = attn.paged_hstu_delta_attention(*args, alpha, scaling)
    torch.cuda.synchronize()
    want = attn.paged_hstu_delta_attention_ref(*args, alpha, scaling)
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    same, zeros = torch.equal(got, again), padded_rows_zero(got, c["new_lens"])
    ok = within(err, scale) and torch.isfinite(got).all().item() and same and zeros
    kernel_ms = median_time_ms(
        lambda: attn.paged_hstu_delta_attention(*args, alpha, scaling), 20)
    dev_ms = device_ms(lambda: attn.paged_hstu_delta_attention(*args, alpha, scaling),
                       PAGED_KERNELS)
    plain_ms = median_time_ms(
        lambda: attn.paged_hstu_delta_attention_ref(*args, alpha, scaling), 5)
    nbytes, flops = attention_work(c)
    peak = BF16_FLOPS if c["q"].dtype == torch.bfloat16 else FP32_FLOPS
    bound_ms, bound_by = bound_of(nbytes, flops, peak)
    plan = paged_plan(attn, c) if c["q"].dtype == torch.bfloat16 else None
    log(f"phase2 {name}: shape={tuple(c['q'].shape)} pg={c['k_pages'].shape[1]} "
        + (f"plan=(splits {plan.splits}, consumers {plan.consumers}, grid {plan.grid}) "
           if plan else "")
        + f"max_abs_err={err:.3e} tol={2e-2 * scale + 1e-3:.3e} (2e-2*max|ref|+1e-3) "
        f"bitwise_repeat={same} padded_rows_zero={zeros} kernel_ms={kernel_ms:.4f} "
        f"device_ms={dev_ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}: "
        f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
    if not ok:
        raise SystemExit(f"phase2 {name}: kernel disagrees with its plain version")
    return dict(err=err, kernel_ms=kernel_ms, device_ms=dev_ms, plain_ms=plain_ms,
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
    profile_call(lambda: runner.forward_with_kvcache(users, seq, lens, ncand, cand),
                 "phase3 profile of one warm call")

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


# The training attention kernels by name (regular expressions on the
# profiler's kernel names, mangled or not): K1 and K4's forward
# (hstu_attention_fwd.cu), K2, K3 and K4's dq and dk/dv
# (hstu_attention_bwd.cu); K4's are the RAB instances of K1-K3's templates.
def _instance(kernel, rab, fwd=False):
    """A kernel's profiler names: mangled or demangled, its bias flag, and
    for the forward template its third (int8) flag false."""
    flag, word = ("1", "true") if rab else ("0", "false")
    if fwd:
        return kernel + rf"(?:ILi\d+ELb{flag}ELb0E|<\d+, {word}, false>)"
    return kernel + rf"(?:ILi\d+ELb{flag}E|<\d+, {word}>)"


ATTN_KERNELS = {"K1": _instance("fwd_wgmma_kernel", False, fwd=True),
                "K2": _instance("dq_wgmma_kernel", False),
                "K3": _instance("dkv_wgmma_kernel", False)}
RAB_KERNELS = {"K4 fwd": _instance("fwd_wgmma_kernel", True, fwd=True),
               "K4 dq": _instance("dq_wgmma_kernel", True),
               "K4 dk/dv": _instance("dkv_wgmma_kernel", True)}
ATTN_NAMES = ("wgmma_kernel",)


def profile_call(fn, label, top=10, groups=None, split=None):
    """Device time of one call by kernel name (torch.profiler), and the
    share of the call's wall time the device was busy. `groups`: kind ->
    substrings of kernel names, for a breakdown by kind; `split`: label ->
    a regular expression of one kernel's names, for its device ms and
    launches apart."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return profile_report(prof, label, wall_ms, top, groups, split)


def profile_report(prof, label, wall_ms, top=10, groups=None, split=None):
    """Log a finished profile (see `profile_call`); returns {split label:
    launches}."""
    import re

    # device work only: user annotations (e.g. "Optimizer.step#Adam.step")
    # also carry device time, and would count their kernels twice
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
              and not getattr(e, "is_user_annotation", False) and "#" not in e.key]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    log(f"{label}: wall_ms={wall_ms:.2f} "
        f"device_busy_ms={busy_ms:.2f} ({100 * busy_ms / wall_ms:.1f}% busy, "
        f"{len(events)} kernel names)")
    if groups:
        totals = dict.fromkeys([*groups, "other"], 0.0)
        for e in events:
            name = e.key.lower()
            g = next((g for g, keys in groups.items() if any(k in name for k in keys)),
                     "other")
            totals[g] += e.self_device_time_total / 1e3
        log("  by kind: " + ", ".join(f"{g} {ms:.2f} ms" for g, ms in totals.items()))
    counts = {}
    if split:
        hits = {k: [e for e in events if re.search(key, e.key)] for k, key in split.items()}
        counts = {k: sum(e.count for e in h) for k, h in hits.items()}
        log("  by kernel: " + ", ".join(
            f"{k} {sum(e.self_device_time_total for e in h) / 1e3:.3f} ms "
            f"x{counts[k]}" for k, h in hits.items()))
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:90]}")
    return counts


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


# ---------------------------------------------------------------- phase 5
def jagged_attention_work(lengths, H, dh, opts, ctx=None, tgt=None, dev="cuda", rab=None):
    """Valid (row, col) pairs of this data's mask, and each kernel's bytes
    (inputs read once, outputs written once) and FLOPs: K1 runs 2 products
    per pair (S, P v), K2 3 (S, dP, dq), K3 4 (S, dP, dk, dv). With `rab`
    (K4) each kernel also reads, once, the bias cells that a valid pair
    reaches (for a broadcast batch dim the union over the sequences), and the
    dq kernel writes as many fp32 drab cells."""
    from recsys_examples_torch.ops.hstu_attention_ref import get_valid_attn_mask

    pairs = 0
    nmax = max(lengths)
    union = torch.zeros((nmax, nmax), dtype=torch.bool, device=dev)
    for b, n in enumerate(lengths):
        if n == 0:
            continue
        mask = get_valid_attn_mask(
            opts.causal, int(n), torch.tensor([n], device=dev),
            num_targets=None if tgt is None else torch.tensor([tgt[b]], device=dev),
            max_attn_len=opts.max_attn_len,
            num_contextuals=None if ctx is None else torch.tensor([ctx[b]], device=dev),
            min_full_attn_seq_len=opts.min_full_attn_seq_len,
            target_group_size=opts.target_group_size)
        pairs += int(mask.sum().item())
        if rab is not None:
            union[:n, :n] |= mask[0]
    T = int(sum(lengths))
    tile = T * H * dh * 2
    per_pair = 2 * H * dh
    cells = 0
    if rab is not None:
        cells = (int(union.sum().item()) if rab.shape[0] == 1 else pairs) * rab.shape[1]
    bias = cells * (rab.element_size() if rab is not None else 0)
    drab = cells * 4
    return {"pairs": pairs,
            "fwd": (4 * tile + bias, 2 * per_pair * pairs),
            "dq": (5 * tile + bias + drab, 3 * per_pair * pairs),
            "dkv": (6 * tile + bias, 4 * per_pair * pairs)}


def bound_of(nbytes, flops, peak=BF16_FLOPS):
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def attention_operands(gen, lengths, H, dh, pad=5):
    """Packed bf16 q, k, v and dO [T + pad, H, dh]; the pad rows belong to
    no sequence. v and dO are scaled so outputs and grads are of order 1."""
    T = int(sum(lengths)) + pad
    r = lambda s: (s * torch.randn(T, H, dh, generator=gen, device="cuda")).to(torch.bfloat16)
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(lengths)]), device="cuda")
    return r(1.0), r(1.0), r(32.0), r(32.0), offsets


def check_jagged_case(name, gen, lengths, H, dh, max_seqlen, kw, ctx=None, tgt=None,
                      time_it=False, rab_shape=None, rab_dtype=torch.float32,
                      phase="phase5", scaling_seqlen=-1):
    """K1-K3 (with `rab_shape`: K4, and drab) through `hstu_attn_varlen`
    (forward, then backward() of dO) against the plain forward and backward
    on the same inputs. `scaling_seqlen` -1 means `max_seqlen`."""
    from recsys_examples_torch.ops import hstu_attention as ha
    from recsys_examples_torch.ops.hstu_attention_ref import (
        hstu_attn_bwd_ref, hstu_mha_reference)

    q, k, v, do, offsets = attention_operands(gen, lengths, H, dh)
    i32 = lambda x: None if x is None else torch.tensor(x, dtype=torch.int32, device="cuda")
    nc, nt = i32(ctx), i32(tgt)
    alpha = 1.0 / dh ** 0.5
    scaling = max_seqlen if scaling_seqlen == -1 else scaling_seqlen
    opts = ha.AttnOptions(max_seqlen=max_seqlen, alpha=alpha, scaling_seqlen=scaling, **kw)
    rab = None
    if rab_shape is not None:
        rab = (0.5 * torch.randn(rab_shape, generator=gen, device="cuda")).to(rab_dtype)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    bias = None if rab is None else rab.clone().requires_grad_()
    out = ha.hstu_attn_varlen(*leaves, offsets, max_seqlen, num_contextuals=nc,
                              num_targets=nt, alpha=alpha, scaling_seqlen=scaling, rab=bias,
                              **kw)
    out.backward(do)
    torch.cuda.synchronize()
    got = [out.detach()] + [x.grad for x in leaves]
    ref_kw = dict(num_contextuals=nc, num_targets=nt, rab=rab, **opts.ref_kwargs())
    want = [hstu_mha_reference(max_seqlen, alpha, q, k, v, offsets, **ref_kw),
            *hstu_attn_bwd_ref(max_seqlen, alpha, q, k, v, do, offsets, **ref_kw)]
    tags = ("out", "dq", "dk", "dv")
    if rab is not None:
        got.append(bias.grad)
        tags += ("drab",)
        if bias.grad.dtype != rab.dtype or bias.grad.shape != rab.shape:
            raise SystemExit(f"{phase} {name}: drab is {bias.grad.dtype} "
                             f"{tuple(bias.grad.shape)}")
    total = int(sum(lengths))
    errs = {}
    for tag, g, w in zip(tags, got, want):
        err = (g.float() - w.float()).abs().max().item()
        scale = w.float().abs().max().item()
        # rows no sequence owns; for drab, cells past max_seqlen
        pad_zero = bool((g[total:] == 0).all().item()) if tag != "drab" else not bool(
            g[:, :, max_seqlen:].any().item() or g[:, :, :, max_seqlen:].any().item())
        ok = within(err, scale) and pad_zero and bool(torch.isfinite(g).all().item())
        log(f"{phase} {name} {tag}: max_abs_err={err:.3e} max|ref|={scale:.3e} "
            f"tol={2e-2 * scale + 1e-3:.3e} (2e-2*max|ref|+1e-3) pad_zero={pad_zero}")
        if not ok:
            raise SystemExit(f"{phase} {name}: {tag} disagrees with its plain version")
        errs[tag] = err
    res = {"err": max(errs.values()), "errs": errs}
    if time_it:   # K1-K3 only
        o32 = offsets.to(torch.int32)
        args = (q, k, v, o32, nc, nt, opts)
        bargs = (q, k, v, do, o32, nc, nt, opts)
        work = jagged_attention_work(lengths, H, dh, opts, ctx, tgt)
        res["kernel_ms"] = {
            "fwd": cuda_time_ms(lambda: ha.hstu_attn_fwd_cuda(*args), 10),
            "dq": cuda_time_ms(lambda: ha.hstu_attn_bwd_dq_cuda(*bargs), 10),
            "dkv": cuda_time_ms(lambda: ha.hstu_attn_bwd_dkv_cuda(*bargs), 10)}
        plain_fwd = cuda_time_ms(lambda: hstu_mha_reference(
            max_seqlen, alpha, q, k, v, offsets, **ref_kw), 3)
        plain_bwd = cuda_time_ms(lambda: hstu_attn_bwd_ref(
            max_seqlen, alpha, q, k, v, do, offsets, **ref_kw), 3)
        # the plain backward computes dq, dk and dv together
        res["plain_ms"] = {"fwd": plain_fwd, "dq": plain_bwd, "dkv": plain_bwd}
        res["bound"] = {kk: bound_of(*work[kk]) for kk in ("fwd", "dq", "dkv")}
        for kk in ("fwd", "dq", "dkv"):
            nbytes, flops = work[kk]
            log(f"phase5 {name} {kk}: kernel_ms={res['kernel_ms'][kk]:.4f} "
                f"plain_ms={res['plain_ms'][kk]:.4f} bound_ms={res['bound'][kk][0]:.4f} "
                f"({res['bound'][kk][1]}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP, "
                f"{work['pairs']} valid pairs)")
    return res


def phase_jagged():
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    H, dh, N = 4, 256, 2048
    lengths = [2000, 37, 1024, 129, 0, 1]
    ctx = [3, 3, 3, 3, 0, 1]
    tgt = [64, 4, 10, 7, 0, 0]
    cases = {
        "causal": (dict(), None, None),
        "ctx_tgt_group2": (dict(target_group_size=2), ctx, tgt),
        "window64": (dict(max_attn_len=64), None, None),
        "window64_minfull": (dict(max_attn_len=64, min_full_attn_seq_len=128), None, tgt),
        "noncausal": (dict(causal=False), None, None),
    }
    res = {}
    for name, (kw, c, t) in cases.items():
        res[name] = check_jagged_case(name, gen, lengths, H, dh, N, kw, c, t,
                                      time_it=name == "causal")
    res["odd_h2_dh64"] = check_jagged_case(
        "odd_h2_dh64", gen, [77, 0, 300, 5], 2, 64, 320,
        dict(target_group_size=3), [2, 0, 1, 0], [9, 0, 31, 2])
    # K2 and K3 at their 64-row tile edges; contextual rows across a tile
    # edge (c = 70) with targets; a batch of whole tiles without targets
    # (every tile below the diagonal skips the mask); head dims 32 and 128
    res["tile_edges"] = check_jagged_case(
        "tile_edges", gen, [63, 64, 65, 127, 128, 129], H, dh, 256, {})
    res["ctx70_tgt"] = check_jagged_case(
        "ctx70_tgt", gen, [300, 129, 200, 70], H, dh, 320, dict(target_group_size=2),
        [70, 70, 3, 70], [16, 0, 40, 0])
    res["interior"] = check_jagged_case("interior", gen, [512, 256, 1024], H, dh, 1024, {})
    for d in (32, 128):
        res[f"odd_h2_dh{d}"] = check_jagged_case(
            f"odd_h2_dh{d}", gen, [77, 0, 300, 5, 129], 2, d, 320,
            dict(target_group_size=3), [2, 0, 70, 0, 1], [9, 0, 31, 2, 3])
    # K1's 128-row CTA: lengths at its edges, consumer 1 without rows (64,
    # 191, 1), contextual rows across the consumer boundary (c 70) and past
    # the CTA (c 130), without and with targets
    res["cta_edges"] = check_jagged_case(
        "cta_edges", gen, [191, 192, 193, 64, 1], H, dh, 256, {})
    res["ctx70_130"] = check_jagged_case(
        "ctx70_130", gen, [300, 200, 260, 129], H, dh, 320, {}, [70, 130, 130, 70])
    res["ctx70_130_tgt"] = check_jagged_case(
        "ctx70_130_tgt", gen, [300, 200, 260, 129], H, dh, 320, dict(target_group_size=2),
        [70, 130, 130, 70], [16, 0, 40, 3])
    return res


# ---------------------------------------------------------------- phase 8
def phase_rab():
    """K4 against its plain version over the bias shapes, dtypes and masks."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    H, dh, N = 4, 256, 2048
    lengths = [2000, 37, 1024, 129, 0, 1]
    B = len(lengths)
    ctx = [3, 3, 3, 3, 0, 1]
    tgt = [64, 4, 10, 7, 0, 0]
    f32, bf16 = torch.float32, torch.bfloat16
    cases = {
        # the model's shape; an odd row stride beyond max_seqlen
        "1h_causal": (dict(), None, None, (1, H, N + 2, N + 3), f32),
        "bh_ctx_tgt_group2": (dict(target_group_size=2), ctx, tgt, (B, H, N, N), f32),
        "11_window64_bf16": (dict(max_attn_len=64), None, None, (1, 1, N, N), bf16),
        "1h_noncausal_bf16": (dict(causal=False), None, None, (1, H, N, N), bf16),
        "1h_ctx": (dict(), ctx, None, (1, H, N, N), f32),
    }
    res = {}
    for name, (kw, c, t, shape, dtype) in cases.items():
        res[name] = check_jagged_case(name, gen, lengths, H, dh, N, kw, c, t,
                                      rab_shape=shape, rab_dtype=dtype, phase="phase8")
    res["b1_h2_dh64"] = check_jagged_case(
        "b1_h2_dh64", gen, [77, 0, 300, 5], 2, 64, 320, dict(target_group_size=3),
        [2, 0, 1, 0], [9, 0, 31, 2], rab_shape=(4, 1, 320, 320), phase="phase8")
    # an odd row stride (N 131, as the model's 8195): every other row's drab
    # pairs are not 8-byte aligned
    odd = [100, 131, 67, 1]
    for dtype, tag in ((f32, "f32"), (bf16, "bf16")):
        for shape, kind in (((1, H, 131, 131), "1h"), ((len(odd), H, 131, 131), "bh")):
            name = f"odd131_{kind}_{tag}"
            res[name] = check_jagged_case(name, gen, odd, H, dh, 131, {}, rab_shape=shape,
                                          rab_dtype=dtype, phase="phase8")
    # K4's forward at K1's 128-row CTA edges (lengths 191-193; consumer 1
    # without rows at 64, 191 and 1; contextual rows across the consumer
    # boundary, c 70, and past the CTA, c 130), its dk/dv at K3's 64-row tile
    # edges and on whole tiles, whose interior tiles skip the mask but add
    # the bias; an odd row stride (N + 3), fp32 broadcast over the batch and
    # bf16 per sequence, whose cell pairs are unaligned on every other row
    edges = {
        "cta_edges": ([191, 192, 193, 64, 1], 256, None),
        "ctx70_130": ([300, 200, 260, 129], 320, [70, 130, 130, 70]),
        "tile_edges": ([63, 64, 65, 127, 128, 129], 256, None),
        "interior": ([512, 256, 1024], 1024, None),
    }
    for name, (lens, n, c) in edges.items():
        for dtype, tag, b in ((f32, "f32", 1), (bf16, "bf16", len(lens))):
            res[f"{name}_{tag}"] = check_jagged_case(
                f"{name}_{tag}", gen, lens, H, dh, n, {}, c, rab_shape=(b, H, n, n + 3),
                rab_dtype=dtype, phase="phase8")
    rab_dq_twice(gen, lengths, H, dh, N, dict(target_group_size=2), ctx, tgt)
    return res


def rab_dq_twice(gen, lengths, H, dh, N, kw, ctx, tgt):
    """K4's dq + drab launched twice on the same inputs with a [B,H,N,N]
    bias: each drab cell has one owner and is stored, so dq and drab are
    equal bit for bit."""
    from recsys_examples_torch.ops import hstu_attention as ha

    q, k, v, do, offsets = attention_operands(gen, lengths, H, dh)
    rab = 0.5 * torch.randn((len(lengths), H, N, N), generator=gen, device="cuda")
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device="cuda")
    opts = ha.AttnOptions(max_seqlen=N, alpha=dh ** -0.5, scaling_seqlen=N, **kw)
    args = (q, k, v, do, rab, offsets.to(torch.int32), i32(ctx), i32(tgt), opts)
    first, again = ha.hstu_attn_rab_bwd_dq_cuda(*args), ha.hstu_attn_rab_bwd_dq_cuda(*args)
    same = [torch.equal(a, b) for a, b in zip(first, again)]
    log(f"phase8 determinism: a second launch of K4's dq with a [B,H,N,N] bias equals the "
        f"first bit for bit: dq {same[0]}, drab {same[1]}")
    if not all(same):
        raise SystemExit("phase8: K4's dq or drab differs between two launches on the same "
                         "inputs")


# ---------------------------------------------------------------- phase 6
N_CTX, TASKS, EMB = 3, 8, 128
BIG_VOCAB = 1_000_000        # configs/ranking_random.gin item_vocab_size
DYN_VOCAB = 50_000_000       # bench.py's item and user_id vocabularies
DYN_CAPACITY = 1 << 22       # bench.py's per-chip shard of a dynamic table
DYNAMIC = ("item", "user_id")


def bench_model(layers, device="cuda", dynamic=False, rab=False):
    """bench.py's HSTU ranking configuration. All five tables static, or with
    `dynamic` only the three small ones (item and user_id then come from
    dynamic tables); `rab` turns the relative attention bias on (128
    buckets, max distance 1024)."""
    from recsys_examples_torch.models.ranking_gr import RankingGR
    from recsys_examples_torch.modules.config import (
        EmbeddingConfig, HSTUConfig, PositionEncodingConfig, RankingConfig)

    cfg = HSTUConfig(
        hidden_size=1024, num_layers=layers, num_attention_heads=4, kv_channels=256,
        hidden_dropout=0.0, dtype=torch.bfloat16, target_group_size=1,
        recompute_layer=False,
        position_encoding_config=PositionEncodingConfig(num_position_buckets=8192),
        item_embedding_dim=EMB, contextual_embedding_dim=EMB,
        use_relative_attention_bias=rab, relative_bias_num_buckets=128,
        relative_bias_max_distance=1024)
    tables = (("item", BIG_VOCAB), ("user_id", BIG_VOCAB), ("action", 100),
              ("user_age", 100), ("item_category_l1", 50))
    if dynamic:
        tables = tuple(t for t in tables if t[0] not in DYNAMIC)
    task = RankingConfig(
        embedding_configs=tuple(EmbeddingConfig((n,), n, v, EMB) for n, v in tables),
        prediction_head_arch=(512, TASKS), num_tasks=TASKS)
    return RankingGR(cfg, task, device=device)


def dyn_table(capacity=DYN_CAPACITY, device="cuda"):
    """One of bench.py's dynamic tables: dim 128, buckets of 128,
    rowwise_adagrad at lr 0.01, on `device`."""
    from recsys_examples_torch.dynamicemb.batched_table import DynamicEmbeddingTable
    from recsys_examples_torch.dynamicemb.dynamicemb_config import DynamicEmbTableOptions
    from recsys_examples_torch.dynamicemb.optimizer import SparseOptimizerArgs
    from recsys_examples_torch.dynamicemb.sharded_collection import ShardedDynamicEmbedding

    return ShardedDynamicEmbedding(DynamicEmbeddingTable(
        DynamicEmbTableOptions(embedding_dim=EMB, max_capacity=capacity, bucket_capacity=128),
        SparseOptimizerArgs(optimizer="rowwise_adagrad", learning_rate=0.01)),
        mesh=None, device=device)


def bench_batch(seed, batch, max_hist, vocab=BIG_VOCAB):
    """bench.py's batch with the token capacity equal to the batch's exact
    item total (the length draw reproduced from the seed, as bench.py
    does, without its rounding up to 2048). `vocab`: of item and user_id."""
    from recsys_examples_torch.data.hstu_batch import _zipf_lengths, random_hstu_batch

    total = int(_zipf_lengths(np.random.default_rng(seed), 1.2, batch, max_hist).sum())
    return random_hstu_batch(
        seed=seed, batch_size=batch, max_history_len=max_hist, item_vocab=vocab,
        action_vocab=100,
        contextual_vocabs={"user_id": vocab, "user_age": 100, "item_category_l1": 50},
        max_num_candidates=0, num_tasks=TASKS, zipf_a=1.2, token_capacity=total,
        value_zipf={"item": 1.05, "user_id": 1.05})


def seqlens_of(batch):
    """Post-preprocess lengths: 3 contextual tokens + interleaved history."""
    return N_CTX + 2 * np.asarray(batch.features["item"].lengths, np.int64)


def plain_attention(alpha_scale=1.0):
    """Swap the autograd Function's dispatch to the plain versions (CUDA
    tensors included) for a comparison run; returns the undo. alpha_scale
    other than 1 makes a faulted control (scores too large)."""
    from recsys_examples_torch.ops import hstu_attention as ha
    from recsys_examples_torch.ops.hstu_attention_ref import (
        hstu_attn_bwd_ref, hstu_mha_reference)

    saved = ha.hstu_attn_fwd, ha.hstu_attn_bwd
    ha.hstu_attn_fwd = lambda q, k, v, so, nc, nt, o, rab=None: hstu_mha_reference(
        o.max_seqlen, o.alpha * alpha_scale, q, k, v, so, num_contextuals=nc,
        num_targets=nt, rab=rab, **o.ref_kwargs())
    ha.hstu_attn_bwd = lambda q, k, v, do, so, nc, nt, o, rab=None, need_drab=True: \
        hstu_attn_bwd_ref(
            o.max_seqlen, o.alpha * alpha_scale, q, k, v, do.to(v.dtype), so,
            num_contextuals=nc, num_targets=nt, rab=rab, **o.ref_kwargs())

    def undo():
        ha.hstu_attn_fwd, ha.hstu_attn_bwd = saved
    return undo


def main_shape_kernels(batch, with_rab=False, tag="phase6"):
    """K1-K3 (`with_rab`: K4, with the model's fp32 [1, 4, 8195, 8195] bias,
    beside K1-K3 in turns) at the main path's attention shape (the full-width
    seed-0 batch: its offsets, 3 contextual rows each, H 4 x 256, the static
    bound 8195 as scaling): kernel time, bound, and the kernels against the
    plain versions run sequence by sequence (the dense-padded plain version
    of the whole batch would need [32, 4, 8195, 8195] fp32 scores)."""
    from recsys_examples_torch.ops import hstu_attention as ha
    from recsys_examples_torch.ops.hstu_attention_ref import (
        hstu_attn_bwd_ref, hstu_mha_reference)

    lengths = [int(n) for n in seqlens_of(batch)]
    N = 2 * 4096 + N_CTX
    H, dh = 4, 256
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    q, k, v, do, offsets = attention_operands(gen, lengths, H, dh, pad=0)
    o32 = offsets.to(torch.int32)
    nc = torch.full((len(lengths),), N_CTX, dtype=torch.int32, device="cuda")
    opts = ha.AttnOptions(max_seqlen=N, alpha=dh ** -0.5, scaling_seqlen=N)
    args, bargs = (q, k, v, o32, nc, None, opts), (q, k, v, do, o32, nc, None, opts)
    fns = {"fwd": lambda: ha.hstu_attn_fwd_cuda(*args),
           "dq": lambda: ha.hstu_attn_bwd_dq_cuda(*bargs),
           "dkv": lambda: ha.hstu_attn_bwd_dkv_cuda(*bargs)}
    rab = None
    if with_rab:
        rab = 0.5 * torch.randn((1, H, N, N), generator=gen, device="cuda")
        no_rab = fns
        fns = {"fwd": lambda: ha.hstu_attn_rab_fwd_cuda(q, k, v, rab, *args[3:]),
               "dq": lambda: ha.hstu_attn_rab_bwd_dq_cuda(q, k, v, do, rab, *bargs[4:]),
               "dkv": lambda: ha.hstu_attn_rab_bwd_dkv_cuda(q, k, v, do, rab, *bargs[4:])}
    dq_out = fns["dq"]()
    got = [fns["fwd"](), *(dq_out if with_rab else (dq_out,)), *fns["dkv"]()]
    if with_rab:    # out, dq, drab, dk, dv -> out, dq, dk, dv, drab
        got = [got[0], got[1], got[3], got[4], got[2]]
        # in turns: without, with, with, without the bias
        t = {kk: [median_time_ms(no_rab[kk], 3), median_time_ms(fns[kk], 3),
                  median_time_ms(fns[kk], 3), median_time_ms(no_rab[kk], 3)] for kk in fns}
        ms = {kk: (v[1] + v[2]) / 2 for kk, v in t.items()}
        ms_no_rab = {kk: (v[0] + v[3]) / 2 for kk, v in t.items()}
        # the bias's two costs in K4's dq: its reads alone, then its reads
        # and drab's atomics (the timed dq above)
        ms_no_drab = cuda_time_ms(lambda: ha.hstu_attn_rab_bwd_dq_cuda(
            q, k, v, do, rab, *bargs[4:], need_drab=False), 3)
    else:
        ms = {kk: median_time_ms(f, 5) for kk, f in fns.items()}

    # K1-K4 own their output rows: no order in their sums (K4's drab, summed
    # over the batch by atomics, has one)
    dq_again = fns["dq"]()
    again = dict(zip(("out", "dq", "dk", "dv"), [
        fns["fwd"](), dq_again[0] if with_rab else dq_again, *fns["dkv"]()]))
    same = {kk: torch.equal(g, again[kk]) for kk, g in zip(("out", "dq", "dk", "dv"), got)}
    log(f"{tag} main-shape determinism: a second launch equals the first bit for bit: "
        + ", ".join(f"{kk} {ok}" for kk, ok in same.items()))
    if not all(same.values()):
        raise SystemExit(f"{tag}: a kernel differs between two launches on the same inputs")
    del again, dq_again
    names = ("out", "dq", "dk", "dv") + (("drab",) if with_rab else ())
    errs = dict.fromkeys(names, 0.0)
    scales = dict.fromkeys(errs, 0.0)
    plain = {"fwd": 0.0, "bwd": 0.0}
    kw = dict(scaling_seqlen=N, num_contextuals=nc[:1])
    drab_ref = torch.zeros_like(rab) if with_rab else None
    for b, n in enumerate(lengths):
        s = slice(int(offsets[b]), int(offsets[b + 1]))
        one = torch.tensor([0, n], device="cuda")
        seq = [x[s] for x in (q, k, v, do)]
        if with_rab:
            kw["rab"] = rab[:, :, :n, :n]
        plain["fwd"] += cuda_time_ms(lambda: hstu_mha_reference(
            n, opts.alpha, *seq[:3], one, **kw), 1)
        plain["bwd"] += cuda_time_ms(lambda: hstu_attn_bwd_ref(
            n, opts.alpha, *seq, one, **kw), 1)
        want = [hstu_mha_reference(n, opts.alpha, *seq[:3], one, **kw),
                *hstu_attn_bwd_ref(n, opts.alpha, *seq, one, **kw)]
        for name, g, w in zip(names[:4], got, want):
            errs[name] = max(errs[name], (g[s].float() - w.float()).abs().max().item())
            scales[name] = max(scales[name], w.float().abs().max().item())
        if with_rab:    # the plain drab sums over the batch sequence by sequence
            drab_ref[:, :, :n, :n] += want[4]
        del want
    if with_rab:
        errs["drab"] = (got[4] - drab_ref).abs().max().item()
        scales["drab"] = drab_ref.abs().max().item()
    del drab_ref, got
    torch.cuda.empty_cache()
    for name in errs:
        log(f"{tag} main-shape {name}: max_abs_err={errs[name]:.3e} "
            f"max|ref|={scales[name]:.3e} tol={2e-2 * scales[name] + 1e-3:.3e}")
        if not within(errs[name], scales[name]):
            raise SystemExit(f"{tag}: {name} disagrees with its plain version at the "
                             "main path's shape")
    work = jagged_attention_work(lengths, H, dh, opts, ctx=[N_CTX] * len(lengths), rab=rab)
    res = {"ms": ms, "errs": errs,
           "plain_ms": {"fwd": plain["fwd"], "dq": plain["bwd"], "dkv": plain["bwd"]},
           "bound": {kk: bound_of(*work[kk]) for kk in fns}}
    for kk in fns:
        nbytes, flops = work[kk]
        log(f"{tag} main-shape {kk}: T={sum(lengths)} kernel_ms={ms[kk]:.4f} "
            + (f"(without the bias, same call: {ms_no_rab[kk]:.4f}) " if with_rab else "")
            + (f"(without drab: {ms_no_drab:.4f}) " if with_rab and kk == "dq" else "")
            + f"plain_ms(per sequence)={res['plain_ms'][kk]:.2f} "
            f"bound_ms={res['bound'][kk][0]:.4f} ({res['bound'][kk][1]}: "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP, "
            f"{flops / ms[kk] / 1e9:.1f} TFLOP/s, "
            f"{100 * res['bound'][kk][0] / ms[kk]:.1f}% of the bound)")
    return res


def rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()


# Phases 6a and 9c's limits: the worst param's gradient and Adam-update
# relative L2, each between the sound readings' largest and the faulted
# control's on the batches the phases use (H100: 6a grad 3.3e-2 /
# 8.2e-2, update 5.2e-4 / 6.7e-2; 9c grad 3.2e-2 / 6.9e-2, update 1.9e-3 /
# 8.2e-3). The loss, which sits at ln 2, does not answer a fault in the
# scores: over batch seeds 1-24 the sound 6a steps read 8.6e-8 to 2.2e-6 and
# the controls 6.0e-7 to 6.1e-6, over seeds 1-12 9c's 0 to 1.4e-6 and 5.2e-7
# to 3.5e-6 (H100; PERF.md section 6), a few fp32 ulps each. So it is printed
# and not held.
STEP_LIMITS = {"grad": 5e-2, "update": 5e-3}
UPDATE_FLOOR = 1 / 16    # bf16 noise floor of a gradient, relative to its param's largest


def plain_pointwise():
    """Swap `HSTULayer`'s fused pointwise ops for the eager chain they
    replace (plain PyTorch under autograd, CUDA tensors included); returns
    the undo."""
    from recsys_examples_torch.modules import hstu_layer as hl
    from recsys_examples_torch.ops.hstu_pointwise import bias_silu_ref, layer_norm_ref

    saved = hl.layer_norm, hl.uvqk_bias_silu

    def eager_layer_norm(x, scale, bias, eps, dtype, u=None):
        y = layer_norm_ref(x, scale, bias, eps, dtype)[0]
        return y if u is None else y * u

    hl.layer_norm, hl.uvqk_bias_silu = eager_layer_norm, bias_silu_ref

    def undo():
        hl.layer_norm, hl.uvqk_bias_silu = saved
    return undo


def phase_train_compare(dynamic_rab=False, tag="phase6a", seeds=(SEED + 7, SEED + 8)):
    """With `dynamic_rab` (phase 9c) the model has the relative attention
    bias (so the kernels are K4's) and its item and user_id embeddings come
    from dynamic tables, made anew for every step.
    (a) one GRTrainer step through the kernels against the same step with
    the plain attention and the eager pointwise chain (`plain_pointwise`),
    from the same params, at 2 layers (bf16), on the batches of `seeds`;
    then a faulted control, the plain step with scores 2% too large (alpha x
    1.02) on the last batch, which each held check must catch. Compared (the
    loss printed, not held): each param's gradient, and each param's Adam
    update on the elements
    whose plain gradient is above UPDATE_FLOOR of its param's largest
    (Adam's first step moves an element by about lr * sign(g), so below the
    noise floor the update is noise too)."""
    from recsys_examples_torch.training.train_state import make_optimizer
    from recsys_examples_torch.training.trainer import GRTrainer

    limits = STEP_LIMITS
    fault = 1.02
    model = bench_model(2, dynamic=dynamic_rab, rab=dynamic_rab)
    sparse = {n: dyn_table(1 << 16) for n in DYNAMIC} if dynamic_rab else None
    trainer = GRTrainer(model, make_optimizer(1e-3, "adam"), sparse)
    trainer.init(torch.Generator(device="cuda").manual_seed(SEED))
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}

    def step(batch, alpha_scale=None):
        undo = None if alpha_scale is None else (plain_attention(alpha_scale),
                                                 plain_pointwise())
        try:
            s = trainer.init(torch.Generator(device="cuda").manual_seed(SEED))
            with torch.no_grad():
                for n, p in s.model.named_parameters():
                    p.copy_(p0[n])
            s, m = trainer.train_step(s, batch)
        finally:
            for u in undo or ():
                u()
        params = dict(s.model.named_parameters())
        return (m["loss"].item(), {n: p.grad.detach().clone() for n, p in params.items()},
                {n: p.detach() - p0[n] for n, p in params.items()})

    def readings(ref, got):
        """{check: (reading, worst param)} of `got` against `ref`."""
        (loss_r, grad_r, upd_r), (loss_g, grad_g, upd_g) = ref, got
        upd = []
        for n, g in grad_r.items():
            keep = g.abs() > UPDATE_FLOOR * g.abs().max()
            if keep.any():
                upd.append((rel_l2(upd_g[n][keep], upd_r[n][keep]), n))
        return {"loss": (abs(loss_g - loss_r) / abs(loss_r), "-"),
                "grad": max((rel_l2(grad_g[n], grad_r[n]), n) for n in grad_r),
                "update": max(upd)}

    def show(label, r):
        return f"{label}: " + ", ".join(
            f"{k} {v:.3e} ({n}, " + (f"limit {limits[k]:g})" if k in limits else "not held)")
            for k, (v, n) in r.items())

    sound = []
    for seed in seeds:
        host = bench_batch(seed, 8, 512, DYN_VOCAB if dynamic_rab else BIG_VOCAB)
        batch = host.to("cuda")
        ref = step(batch, alpha_scale=1.0)
        sound.append(readings(ref, step(batch)))
        log(f"{tag} " + show(f"batch seed {seed}, {int(seqlens_of(host).sum())} tokens, "
                              "kernels against plain", sound[-1]))
    control = readings(ref, step(batch, alpha_scale=fault))
    log(f"{tag} " + show(f"control, plain with alpha x {fault} against plain", control))
    if any(r[k][0] >= lim for r in sound for k, lim in limits.items()):
        raise SystemExit(f"{tag}: the step through the kernels disagrees with the plain step")
    missed = [k for k, lim in limits.items() if control[k][0] < lim]
    if missed:
        raise SystemExit(f"{tag}: the faulted control passes the {missed} check")
    del ref, p0
    torch.cuda.empty_cache()


def phase_train():
    """(a), then (b) the full-width train step: bench.py's configuration with
    static tables, a warm-up pass over the batch pool, then a timed pass."""
    from recsys_examples_torch.ops import hstu_attention as ha
    from recsys_examples_torch.training.train_state import make_optimizer
    from recsys_examples_torch.training.trainer import GRTrainer
    from recsys_examples_torch.utils.perf import H100_PEAK_TFLOPS, hstu_flops_exact

    phase_train_compare()
    host = [bench_batch(s, 32, 4096) for s in range(7)]
    batches = [b.to("cuda") for b in host]
    main_shape = main_shape_kernels(host[0])

    model = bench_model(8)
    trainer = GRTrainer(model, make_optimizer(1e-3, "adam"))
    state = trainer.init(torch.Generator(device="cuda").manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase6b config: 8 layers, hidden 1024, 4x256, bf16, head (512, 8), "
        f"tables item/user_id {BIG_VOCAB} x {EMB} + 3 small, {n_params / 1e6:.1f}M params")
    # warm-up: one pass over the pool, so the allocator has grown to the
    # largest batch before the timed pass (as bench.py's warm-up cycle)
    for b in batches:
        state, m = trainer.train_step(state, b)
    torch.cuda.synchronize()
    log(f"phase6b warm-up over {len(batches)} batches, last loss={m['loss'].item():.5f}")

    counters = (ha.hstu_attn_fwd_cuda, ha.hstu_attn_bwd_dq_cuda, ha.hstu_attn_bwd_dkv_cuda)
    for c in counters:
        c.launches = 0
    step_ms, losses = [], []
    for b in batches[1:]:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = trainer.train_step(state, b)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(m["loss"].item())
    launches = [c.launches for c in counters]
    steps = len(step_ms)
    log(f"phase6b steps={steps} launches fwd/dq/dkv={launches} (expected {8 * steps} each) "
        f"losses={[round(x, 5) for x in losses]}")
    if launches != [8 * steps] * 3:
        raise SystemExit("phase6b: the attention kernels did not carry every layer")
    if not all(np.isfinite(losses)):
        raise SystemExit("phase6b: non-finite loss")

    tokens = [int(seqlens_of(b).sum()) for b in host[1:]]
    flops = [hstu_flops_exact(seqlens_of(b), N_CTX, 0, 1024, 4, 256, 8) for b in host[1:]]
    tflops = [f / (ms * 1e-3) / 1e12 for f, ms in zip(flops, step_ms)]
    for t, ms, tf in zip(tokens, step_ms, tflops):
        log(f"phase6b step tokens={t} step_ms={ms:.2f} TFLOP/s={tf:.1f} "
            f"MFU={100 * tf / H100_PEAK_TFLOPS:.2f}%")
    mean_tf = sum(flops) / (sum(step_ms) * 1e-3) / 1e12
    log(f"phase6b mean: step_ms={statistics.mean(step_ms):.2f} "
        f"median={statistics.median(step_ms):.2f} tokens={statistics.mean(tokens):.0f} "
        f"TFLOP/s={mean_tf:.1f} MFU={100 * mean_tf / H100_PEAK_TFLOPS:.2f}% "
        f"(hstu_flops_exact against {H100_PEAK_TFLOPS:.0f})")
    log(f"phase6b peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    profile_call(lambda: trainer.train_step(state, batches[1]),
                 f"phase6b profile of one train step ({tokens[0]} tokens)", top=20,
                 split=ATTN_KERNELS, groups={
                     "attention K1-K3": ATTN_NAMES,
                     "GEMM": ("gemm", "nvjet", "cutlass", "xmma"),
                     "gather/scatter": ("index", "scatter", "gather"),
                     "optimizer": ("multi_tensor", "adam"),
                 })
    del state, trainer, model
    torch.cuda.empty_cache()
    main_shape["launches"] = launches
    return main_shape


# ---------------------------------------------------------------- phase 7
def zipf_ids(rng, n, a=1.05, vocab=DYN_VOCAB):
    return torch.from_numpy((rng.zipf(a, size=(n,)).astype(np.int64) - 1) % vocab)


def table_invariants(tag, state):
    """table_size == inserted - evicted, and no key is stored twice."""
    from recsys_examples_torch.dynamicemb.dynamicemb_config import EMPTY_KEY
    from recsys_examples_torch.dynamicemb.hashtable import table_size

    t = state.table
    size, ins, ev, ov = (int(x) for x in (table_size(t), t.inserted, t.evicted, t.overflowed))
    live = t.keys.view(-1)[t.keys.view(-1) != EMPTY_KEY]
    distinct = int(torch.unique(live).numel())
    log(f"{tag}: size={size} inserted={ins} evicted={ev} overflowed={ov} "
        f"distinct_keys={distinct}")
    if size != ins - ev or distinct != size:
        raise SystemExit(f"{tag}: the table's counters or keys are inconsistent")
    return ins, ev, ov


def phase_tables():
    from recsys_examples_torch.dynamicemb.hashtable import lookup

    rng = np.random.default_rng(SEED + 9)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    # (a) bench.py's table shape on the card
    tbl = dyn_table()
    state = tbl.init_state()
    n = 32768
    pool = [zipf_ids(rng, n).cuda() for _ in range(4)]
    inserted = []
    for ids in pool + pool[:2]:     # four fresh batches, then two resident ones
        state, emb, res = tbl.forward(state, ids, train=True)
        # every looked-up resident key returns its row
        slots, found = lookup(state.table, ids)
        rows = state.table.values[slots.clamp_min(0)]
        if not (emb.shape == (n, EMB) and bool(torch.isfinite(emb).all())
                and bool(found.all()) and torch.equal(rows, emb)):
            raise SystemExit("phase7: a looked-up key did not return its stored row")
        grads = torch.randn(emb.shape, generator=gen, device="cuda")
        state = tbl.backward(state, res, grads)
        inserted.append(int(state.table.inserted))
    log(f"phase7 table {DYN_CAPACITY} x {EMB}, {n} ids a step: inserted after each step "
        f"{inserted}")
    table_invariants("phase7 bench table", state)
    if inserted[5] != inserted[3] or inserted[3] <= inserted[0]:
        raise SystemExit("phase7: resident keys were inserted again")
    # phase A and phase C of one table: a fresh batch once, then resident
    ids = zipf_ids(rng, n).cuda()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    _, emb, res = tbl.forward(state, ids, train=True)
    e1.record()
    torch.cuda.synchronize()
    t_fresh = e0.elapsed_time(e1)
    t_res = cuda_time_ms(lambda: tbl.forward(state, ids, train=True), 5)
    t_bwd = cuda_time_ms(lambda: tbl.backward(state, res, grads), 5)
    log(f"phase7 one table, {n} ids: forward fresh {t_fresh:.3f} ms, resident "
        f"{t_res:.3f} ms, backward {t_bwd:.3f} ms")
    del state, tbl
    torch.cuda.empty_cache()

    # (b) a flood in a small table, on the card and on the CPU
    card, cpu = dyn_table(1 << 12), dyn_table(1 << 12, device="cpu")
    sc, sp = card.init_state(), cpu.init_state()
    for step in range(6):
        ids = zipf_ids(rng, 3000)
        g = torch.from_numpy(rng.standard_normal((3000, EMB)).astype(np.float32))
        sc, ec, rc = card.forward(sc, ids.cuda(), train=True)
        sp, ep, rp = cpu.forward(sp, ids, train=True)
        if not torch.equal(rc.slots.cpu(), rp.slots):
            raise SystemExit(f"phase7 flood step {step}: slots differ between card and CPU")
        torch.testing.assert_close(ec.cpu(), ep, rtol=1e-5, atol=1e-7)
        sc = card.backward(sc, rc, g.cuda())
        sp = cpu.backward(sp, rp, g)
    for f in ("keys", "scores", "inserted", "evicted", "overflowed"):
        if not torch.equal(getattr(sc.table, f).cpu(), getattr(sp.table, f)):
            raise SystemExit(f"phase7 flood: {f} differ between card and CPU")
    if not torch.equal(sc.step.cpu(), sp.step):
        raise SystemExit("phase7 flood: step differs between card and CPU")
    torch.testing.assert_close(sc.table.values.cpu(), sp.table.values, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(sc.table.opt.cpu(), sp.table.opt, rtol=1e-5, atol=1e-7)
    _, evicted, _ = table_invariants("phase7 flood table (card)", sc)
    if evicted == 0:
        raise SystemExit("phase7 flood: nothing was evicted")
    log("phase7 flood: keys, scores, slots and counters equal bit for bit on card and "
        "CPU, values and optimizer rows within rtol 1e-5")


# ---------------------------------------------------------------- phase 9
def timed_spans(obj, names, spans):
    """Wrap obj's methods `names` so that each call records a CUDA event pair
    into spans[name]; returns the undo."""
    saved = {}
    for name in names:
        fn = saved[name] = getattr(obj, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = _fn(*a, **kw)
            e1.record()
            spans[_name].append((e0, e1))
            return out
        setattr(obj, name, wrapped)

    def undo():
        for name in saved:
            delattr(obj, name)
    return undo


def phase_step(rab):
    """bench.py's whole train step at full width, item and user_id in dynamic
    tables; with `rab` the relative attention bias too (phase 9b)."""
    from recsys_examples_torch.ops import hstu_attention as ha
    from recsys_examples_torch.training.train_state import make_optimizer
    from recsys_examples_torch.training.trainer import GRTrainer
    from recsys_examples_torch.utils.perf import H100_PEAK_TFLOPS, hstu_flops_exact

    tag = "phase9b" if rab else "phase9a"
    pool = 3 if rab else 7
    host = [bench_batch(s, 32, 4096, DYN_VOCAB) for s in range(pool)]
    batches = [b.to("cuda") for b in host]
    torch.cuda.reset_peak_memory_stats()
    model = bench_model(8, dynamic=True, rab=rab)
    sparse = {n: dyn_table() for n in DYNAMIC}
    trainer = GRTrainer(model, make_optimizer(1e-3, "adam"), sparse)
    state = trainer.init(torch.Generator(device="cuda").manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{tag} config: 8 layers, hidden 1024, 4x256, bf16, head (512, 8), dynamic tables "
        f"item/user_id {DYN_CAPACITY} x {EMB} (vocab {DYN_VOCAB}, rowwise_adagrad), "
        f"3 small static tables, relative attention bias {'on' if rab else 'off'}, "
        f"{n_params / 1e6:.1f}M dense params")
    for b in batches:           # warm-up: allocator, and the pool's keys resident
        state, m = trainer.train_step(state, b)
    torch.cuda.synchronize()
    warm = {n: int(s.table.inserted) for n, s in state.sparse.items()}
    log(f"{tag} warm-up over {len(batches)} batches, last loss={m['loss'].item():.5f}, "
        f"inserted {warm}")

    plain = (ha.hstu_attn_fwd_cuda, ha.hstu_attn_bwd_dq_cuda, ha.hstu_attn_bwd_dkv_cuda)
    biased = (ha.hstu_attn_rab_fwd_cuda, ha.hstu_attn_rab_bwd_dq_cuda,
              ha.hstu_attn_rab_bwd_dkv_cuda)
    counters, others = (biased, plain) if rab else (plain, biased)
    for c in counters + others:
        c.launches = 0
    spans = {"forward": [], "backward": []}
    undos = [timed_spans(t, ("forward", "backward"), spans) for t in sparse.values()]
    timed = batches[1:3] if rab else batches[1:]
    step_ms, losses, overflow = [], [], 0
    for b in timed:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = trainer.train_step(state, b)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(m["loss"].item())
        overflow += int(m["emb_overflow"])
    for undo in undos:
        undo()
    launches = [c.launches for c in counters]
    steps = len(step_ms)
    log(f"{tag} steps={steps} launches fwd/dq/dkv={launches} (expected {8 * steps} each) "
        f"losses={[round(x, 5) for x in losses]} emb_overflow={overflow}")
    if launches != [8 * steps] * 3 or any(c.launches for c in others):
        raise SystemExit(f"{tag}: the attention kernels did not carry every layer")
    if not all(np.isfinite(losses)) or overflow:
        raise SystemExit(f"{tag}: non-finite loss or embedding overflow")

    if len(spans["forward"]) != 2 * steps or len(spans["backward"]) != 2 * steps:
        raise SystemExit(f"{tag}: phases A and C did not run once per table and step")
    a_ms = [sum(e0.elapsed_time(e1) for e0, e1 in spans["forward"][i * 2:(i + 1) * 2])
            for i in range(steps)]
    c_ms = [sum(e0.elapsed_time(e1) for e0, e1 in spans["backward"][i * 2:(i + 1) * 2])
            for i in range(steps)]
    tokens = [int(seqlens_of(b).sum()) for b in host[1:1 + steps]]
    flops = [hstu_flops_exact(seqlens_of(b), N_CTX, 0, 1024, 4, 256, 8)
             for b in host[1:1 + steps]]
    tflops = [f / (ms * 1e-3) / 1e12 for f, ms in zip(flops, step_ms)]
    for t, ms, tf, a, c in zip(tokens, step_ms, tflops, a_ms, c_ms):
        log(f"{tag} step tokens={t} step_ms={ms:.2f} TFLOP/s={tf:.1f} "
            f"MFU={100 * tf / H100_PEAK_TFLOPS:.2f}% phase_A_ms={a:.2f} phase_C_ms={c:.2f} "
            f"(A+C {100 * (a + c) / ms:.1f}% of the step)")
    mean_tf = sum(flops) / (sum(step_ms) * 1e-3) / 1e12
    share = 100 * (sum(a_ms) + sum(c_ms)) / sum(step_ms)
    log(f"{tag} mean: step_ms={statistics.mean(step_ms):.2f} "
        f"median={statistics.median(step_ms):.2f} tokens={statistics.mean(tokens):.0f} "
        f"TFLOP/s={mean_tf:.1f} MFU={100 * mean_tf / H100_PEAK_TFLOPS:.2f}% "
        f"(hstu_flops_exact against {H100_PEAK_TFLOPS:.0f}) phases A+C {share:.1f}% "
        f"(A {statistics.mean(a_ms):.2f} ms, C {statistics.mean(c_ms):.2f} ms)")
    for n, s in state.sparse.items():
        ins, _, _ = table_invariants(f"{tag} table {n}", s)
        if ins != warm[n]:
            raise SystemExit(f"{tag}: table {n} inserted keys of a resident pool")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"{tag} peak memory {peak_gib:.1f} GiB")
    if not rab:     # bench.py's result line, for this backend
        print(json.dumps({
            "metric": "hstu_e2e_train_mfu",
            "value": round(100 * mean_tf / H100_PEAK_TFLOPS, 3), "unit": "%",
            "vs_baseline": round(100 * mean_tf / H100_PEAK_TFLOPS / 31.40, 4),
            "detail": {"step_ms": round(statistics.mean(step_ms), 2),
                       "achieved_tflops": round(mean_tf, 2),
                       "peak_tflops": H100_PEAK_TFLOPS,
                       "tokens": int(statistics.mean(tokens)),
                       "token_capacity": max(tokens),
                       "mean_capacity": round(statistics.mean(tokens), 1),
                       "batch_pool": len(batches), "backend": "cuda"}}), flush=True)
    profile_call(
        lambda: trainer.train_step(state, batches[1]),
        f"{tag} profile of one train step ({tokens[0]} tokens)", top=20,
        split=RAB_KERNELS if rab else ATTN_KERNELS, groups={
                     "attention": ATTN_NAMES,
                     "GEMM": ("gemm", "nvjet", "cutlass", "xmma"),
                     "gather/scatter": ("index", "scatter", "gather"),
                     "sort": ("sort", "radix"),
                     "optimizer": ("multi_tensor", "adam"),
                 })
    del state, trainer, model, sparse
    torch.cuda.empty_cache()
    return launches, host[0]


def phase_full_step():
    launches_a, host0 = phase_step(rab=False)
    rab_shape = main_shape_kernels(host0, with_rab=True, tag="phase9b")
    rab_shape["launches"], _ = phase_step(rab=True)
    phase_train_compare(dynamic_rab=True, tag="phase9c")
    return launches_a, rab_shape, host0


# ---------------------------------------------------------------- phase 10
SID_WIDTHS = dict(num_hierarchies=4, codebook_size=256, hidden_size=1024, num_layers=8,
                  num_heads=8, head_dim=128, ffn_hidden=4096, beam_width=200)
SID_HISTORY_ITEMS = 256


def beam_case(gen, B, W, H, Hkv, D, S, N, ctx_lens, dtype=torch.bfloat16):
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)
    c = dict(q=r(B, W, H, D), k_ctx=r(B, S, Hkv, D), v_ctx=r(B, S, Hkv, D),
             ctx_lens=torch.tensor(ctx_lens, dtype=torch.int32, device="cuda"),
             k_beam=None, v_beam=None, ancestry=None)
    if N:   # random, non-identity ancestry
        c.update(k_beam=r(B, N, W, Hkv, D), v_beam=r(B, N, W, Hkv, D),
                 ancestry=torch.randint(0, W, (B, N, W), generator=gen, device="cuda",
                                        dtype=torch.int32))
    return c


def beam_work(c):
    """Bytes the function must move (the valid context rows of K and V, q,
    out, the beam K/V rows the ancestry reaches, the indices) and the FLOPs
    of its (query, key) pairs, for this case's data."""
    B, W, H, D = c["q"].shape
    S, Hkv = c["k_ctx"].shape[1:3]
    esz = c["q"].element_size()
    ctx = int(c["ctx_lens"].clamp(0, S).sum().item())
    nbytes = 2 * ctx * Hkv * D * esz + 2 * B * W * H * D * esz + B * 4
    N = 0
    if c["k_beam"] is not None:
        N = c["k_beam"].shape[1]
        slots = c["ancestry"].long() + W * torch.arange(B * N, device="cuda").reshape(B, N, 1)
        nbytes += 2 * int(torch.unique(slots).numel()) * Hkv * D * esz + B * N * W * 4
    flops = 4 * (ctx + B * N) * W * H * D
    return nbytes, flops


# K7's limits, held on every batch row by itself: the rows' context lengths
# differ fifty-fold, and a long context's outputs are averages near 0.07
# beside a short one's 1.5 to 3, so one scale for the whole tensor would
# leave the long rows a tolerance as large as their values. Per row: the
# largest error against rtol * max|ref row| + atol (bf16: the repo's kernel
# pass rule), and the row's relative L2 error. The fp32 limits sit a decade
# or two above the fp32 kernel's own readings (PERF.md section 6).
BEAM_LIMITS = {
    torch.bfloat16: dict(rtol=2e-2, atol=1e-3, rel_l2=8e-3),
    torch.float32: dict(rtol=1e-4, atol=1e-5, rel_l2=1e-5),
}


def row_rel_l2(a, b):
    """[B]: relative L2 distance of a from b on each batch row."""
    a, b = a.float().flatten(1), b.float().flatten(1)
    return (a - b).norm(dim=1) / b.norm(dim=1).clamp_min(1e-30)


BEAM_KERNELS = r"beam_wgmma_kernel|scalar::kernel"


def beam_args(c):
    return [c[k] for k in ("q", "k_ctx", "v_ctx", "ctx_lens", "k_beam", "v_beam", "ancestry")]


def beam_errors(got, want):
    """(largest error, worst row's error over its tolerance, worst batch
    row's relative L2) against BEAM_LIMITS of want's dtype, and whether all
    pass."""
    lim = BEAM_LIMITS[want.dtype]
    row_err = (got.float() - want.float()).flatten(1).abs().amax(1)
    row_tol = lim["rtol"] * want.float().flatten(1).abs().amax(1) + lim["atol"]
    err, worst = row_err.max().item(), (row_err / row_tol).max().item()
    rel = row_rel_l2(got, want).max().item()
    ok = worst < 1 and rel < lim["rel_l2"] and bool(torch.isfinite(got).all().item())
    return err, worst, rel, ok


def check_beam_case(name, c, iters=20, sdpa=False, splits=None, timed=True):
    """K7 against its plain version on one case, launched twice (equal bit
    for bit); `splits` other than None launches the bf16 kernel with that
    split instead of the plan's. With `timed`, its event and device times
    (a wrapper call costs the host 30-60 us: below that the event time
    measures the host), the plain version's, the bound."""
    from recsys_examples_torch.ops import beam_decode_attention as bda

    D = c["q"].shape[-1]
    args = beam_args(c)
    scale = D ** -0.5
    run = lambda: bda._launch_cuda(*args, scale, splits=splits)
    got = run() if splits is not None else bda.beam_decode_attn(*args, sm_scale=scale)
    torch.cuda.synchronize()
    want = bda.beam_decode_attn_ref(*args, sm_scale=scale)
    lim = BEAM_LIMITS[c["q"].dtype]
    err, worst, rel, ok = beam_errors(got, want)
    same = torch.equal(got, run())
    N = 0 if c["k_beam"] is None else c["k_beam"].shape[1]
    line = (f"phase10 {name}: q={tuple(c['q'].shape)} Hkv={c['k_ctx'].shape[2]} "
            f"S={c['k_ctx'].shape[1]} N={N} {str(c['q'].dtype)[6:]}"
            + ("" if splits is None else f" splits={splits}")
            + f" max_abs_err={err:.3e} worst row at {worst:.3f} of its tol "
            f"({lim['rtol']:g}*max|ref row|+{lim['atol']:g}) worst row rel L2 {rel:.3e} "
            f"(limit {lim['rel_l2']:g}) repeat equal {same}")
    res = dict(err=err, out=got)
    if timed:
        kernel_ms = median_time_ms(run, iters)
        dev = device_ms(run, BEAM_KERNELS, iters)
        plain_ms = cuda_time_ms(lambda: bda.beam_decode_attn_ref(*args, sm_scale=scale), 3)
        nbytes, flops = beam_work(c)
        bf16 = c["q"].dtype == torch.bfloat16
        bound_ms, bound_by = bound_of(nbytes, flops, BF16_FLOPS if bf16 else FP32_FLOPS)
        line += (f" kernel_ms={kernel_ms:.4f} device_ms={dev:.4f} plain_ms={plain_ms:.4f} "
                 f"bound_ms={bound_ms:.4f} ({bound_by}: {nbytes / 1e6:.1f} MB, "
                 f"{flops / 1e9:.2f} GFLOP)")
        res.update(kernel_ms=kernel_ms, device_ms=dev, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by)
    if sdpa:   # for the record: the context keys alone, no ancestry-gathered tail
        import torch.nn.functional as F

        q, k, v = (c[x].transpose(1, 2) for x in ("q", "k_ctx", "v_ctx"))
        S = k.shape[2]
        keep = (torch.arange(S, device="cuda")[None] < c["ctx_lens"][:, None])[:, None, None]
        f = lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=keep, scale=scale, enable_gqa=q.shape[1] != k.shape[1])
        res["sdpa_ms"] = median_time_ms(f, iters)
        line += f" sdpa_over_context_ms={res['sdpa_ms']:.4f}"
    log(line)
    if not (ok and same):
        raise SystemExit(f"phase10 {name}: kernel disagrees with its plain version, or two "
                         "launches differ")
    return res


def phase_beam():
    """K7 against its plain version over shapes, dtypes and edge cases; the
    B 1 step under each split the plan can take, against the unsplit kernel
    too."""
    from recsys_examples_torch.data.sid_batch import random_sid_batch
    from recsys_examples_torch.ops import beam_decode_attention as bda

    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    B, W, H, D = 16, SID_WIDTHS["beam_width"], SID_WIDTHS["num_heads"], SID_WIDTHS["head_dim"]
    S = SID_HISTORY_ITEMS * 4 + 1
    # the decode step of phase 11's B 16 call: history + BOS per batch row
    lens = (random_sid_batch(SEED, B, SID_HISTORY_ITEMS, 4, 256).history_lengths + 1).tolist()
    res = {}
    for N in (1, 2, 3, 4):
        res[f"full_n{N}"] = check_beam_case(
            f"full_n{N}", beam_case(gen, B, W, H, H, D, S, N, lens), sdpa=N == 3)
    res["full_n3_fp32"] = check_beam_case(
        "full_n3_fp32", beam_case(gen, B, W, H, H, D, S, 3, lens, torch.float32), iters=5)
    edge = [0, 1, S, 64, 65, 63, 700, 2]    # no key, one, all, around a chunk edge
    # around the 32- and 64-key chunk edges
    edge2 = [31, 32, 33, 127, 128, 129, 96, 97]
    small = {
        "gqa_hkv2": (4, W, H, 2, D, S, 2, lens[:4]),
        "gqa_hkv1_n0": (4, W, H, 1, D, S, 0, lens[:4]),
        "n0": (4, W, H, H, D, S, 0, lens[4:8]),
        "w1": (8, 1, H, H, D, S, 2, edge),
        "w7": (8, 7, H, H, D, S, 3, edge),
        "w65_n0_edges": (8, 65, 2, 2, D, S, 0, edge),
        "d64": (3, 50, 4, 4, 64, 300, 2, [300, 1, 129]),
        "d32_gqa": (3, 33, 4, 2, 32, 77, 1, [77, 0, 40]),
        # the row tiles: W at and across a 64-row consumer and a 128-row CTA
        **{f"w{w}": (4, w, H, H, D, S, 3, lens[8:12]) for w in (64, 65, 128, 129, 256)},
        # GQA groups of 2, 4 and 8 at W 200 (one CTA's rows span heads)
        **{f"g{g}_w200": (4, W, H, H // g, D, S, 3, lens[12:16]) for g in (2, 4, 8)},
        "ctx0_n0": (2, W, H, H, D, S, 0, [0, 0]),
        "ctx0_n3": (2, W, H, H, D, S, 3, [0, 0]),
        # no context positions at all: the tail alone, or no key
        "s0_n2": (2, W, H, 2, D, 0, 2, [0, 5]),
        "s0_n0": (2, 7, H, H, D, 0, 0, [0, 0]),
        "edges_32_64": (8, 65, H, H, D, S, 2, edge2),
    }
    for name, (b, w, h, hkv, d, s, n, cl) in small.items():
        for dtype in (torch.bfloat16, torch.float32):
            tag = name + ("" if dtype == torch.bfloat16 else "_fp32")
            res[tag] = check_beam_case(
                tag, beam_case(gen, b, w, h, hkv, d, s, n, cl, dtype), iters=5)
    # a context broadcast over the batch (batch stride 0)
    for dtype in (torch.bfloat16, torch.float32):
        tag = "ctx_broadcast" + ("" if dtype == torch.bfloat16 else "_fp32")
        c = beam_case(gen, 4, W, H, 2, D, S, 2, lens[:4], dtype)
        c["k_ctx"], c["v_ctx"] = (c[k][:1].expand_as(c[k]) for k in ("k_ctx", "v_ctx"))
        res[tag] = check_beam_case(tag, c, iters=5)
    # rows with no key at all are zero, in the kernel and in its plain version
    c = beam_case(gen, 8, 65, 2, 2, D, S, 0, edge)
    out = bda.beam_decode_attn(c["q"], c["k_ctx"], c["v_ctx"], c["ctx_lens"])
    if out[0].any().item() or not out[1].any().item():
        raise SystemExit("phase10: ctx_len 0 with N 0 must give zeros, and only there")
    if res["ctx0_n0"]["out"].any().item() or res["s0_n0"]["out"].any().item() or \
            not res["ctx0_n3"]["out"].flatten(0, 2).any(1).all().item():
        raise SystemExit("phase10: ctx_len 0 (or S 0) must give zeros with N 0, and every "
                         "row a value with N 3")
    # the B 1 decode step (phase 11's B 1 call: its history + BOS) under every
    # split from 1 to the plan's, each against the plain version, the
    # unsplit kernel and itself
    lens1 = (random_sid_batch(SEED, 1, SID_HISTORY_ITEMS, 4, 256).history_lengths + 1).tolist()
    c = beam_case(gen, 1, W, H, H, D, S, 3, lens1)
    plan = bda.beam_launch_plan(c["q"], c["k_ctx"], 3)
    res["b1_n3"] = check_beam_case("b1_n3", c)
    one = check_beam_case("b1_n3", c, splits=1, timed=False)["out"]
    for k in range(1, plan.splits + 1):
        r = check_beam_case("b1_n3", c, splits=k, timed=k == plan.splits)
        err, worst, rel, ok = beam_errors(r["out"], one)
        log(f"phase10 b1_n3 splits={k} against the unsplit kernel: max_abs_err={err:.3e} "
            f"worst row at {worst:.3f} of its tol, rel L2 {rel:.3e}")
        if not ok:
            raise SystemExit(f"phase10 b1_n3: split {k} disagrees with the unsplit kernel")
    log(f"phase10 b1_n3 plan: splits {plan.splits}, tiles {plan.tiles}, grid {plan.grid}")
    for r in res.values():
        r.pop("out", None)
    return res


# ---------------------------------------------------------------- phase 11
def sid_model(seed=SEED, **overrides):
    from recsys_examples_torch.models.sid_gr import SIDGRConfig, SIDGRModel

    cfg = SIDGRConfig(**{**SID_WIDTHS, **overrides}, dtype=torch.bfloat16)
    model = SIDGRModel(cfg).init_weights(torch.Generator(device="cuda").manual_seed(seed))
    return model.eval()


def host_ms(fn, iters):
    """Median wall time of fn() ending in a synchronize, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def compare_beams(got, want, tol):
    """Two (paths [B, W, H], scores [B, W]) results of one search. Returns
    (largest rank-wise score difference, mean of it, beams whose path
    differs, beams whose path differs although their score is further than
    2 * tol from both neighbours')."""
    (pa, sa), (pb, sb) = got, want
    diff = (sa - sb).abs()
    differ = (pa != pb).any(-1)
    gap = (sb[:, :-1] - sb[:, 1:]).abs()
    inf = torch.full_like(sb[:, :1], float("inf"))
    clear = torch.minimum(torch.cat([inf, gap], 1), torch.cat([gap, inf], 1)) > 2 * tol
    return (diff.max().item(), diff.mean().item(), int(differ.sum().item()),
            int((differ & clear).sum().item()))


def traced_attention(run, keep, scale=1.0, replay=False, **kw):
    """run(**kw) with the decoder's beam-decode attention wrapped: the
    outputs of its first `keep` calls are kept, and `scale` other than 1
    makes a faulted control (attention scores too large). With `replay`
    every call's own inputs (this run's q, KV and ancestry, whatever beams it
    holds by then) also go through the plain version at the sound scale, and
    the worst batch row's relative L2 distance of each call is kept instead.
    Returns (run's result, what was kept)."""
    from recsys_examples_torch.modules import transformer
    from recsys_examples_torch.ops.beam_decode_attention import beam_decode_attn_ref

    saved, outs = transformer.beam_decode_attn, []

    def wrapped(*a, sm_scale, backend):
        out = saved(*a, sm_scale=sm_scale * scale, backend=backend)
        if replay:
            outs.append(row_rel_l2(out, beam_decode_attn_ref(*a, sm_scale=sm_scale)).max().item())
        elif len(outs) < keep:
            outs.append(out)
        return out

    transformer.beam_decode_attn = wrapped
    try:
        return run(**kw), outs
    finally:
        transformer.beam_decode_attn = saved


# Phase 11's limits. "attention": relative L2 between two runs' attention
# outputs in the first decode step (there both runs hold the same beams),
# and between each K7 call of any step and the plain version on that call's
# inputs, worst layer; it sits between the sound reading and the faulted
# control's (H100: 2.3e-3 and 2.3e-2 at least, both in layer 0; the deeper
# layers' attention is flatter and answers the fault with 1e-3 to 6e-3).
# "scores": rank-wise difference of two searches' final scores (sums of 4
# log-probs, of order -10): the top 200 of 256^4 candidates lie closer
# together than bf16 noise, so ranks swap and only a gross fault shows here
# (PERF.md section 6).
SID_LIMITS = {"attention": 8e-3, "scores": 1e-1}


def phase_sid():
    from recsys_examples_torch.data.sid_batch import random_sid_batch
    from recsys_examples_torch.ops.beam_decode_attention import beam_decode_attn

    torch.cuda.reset_peak_memory_stats()
    model = sid_model()
    cfg = model.config
    n_params = sum(p.numel() for p in model.parameters())
    L, H, W = cfg.num_layers, cfg.num_hierarchies, cfg.beam_width
    log(f"phase11 config: {H} hierarchies, codebook {cfg.codebook_size}, hidden "
        f"{cfg.hidden_size}, {L} layers, {cfg.num_heads}x{cfg.head_dim}, ffn "
        f"{cfg.ffn_hidden}, beam {W}, bf16, {n_params / 1e6:.1f}M params")
    expected = (H - 1) * L
    res = {}
    for B in (1, 16):
        batch = random_sid_batch(SEED, B, SID_HISTORY_ITEMS, H, cfg.codebook_size).to("cuda")
        run = lambda **kw: model.generate_beam_decode(batch, **kw)
        run()                                   # warm-up: cuBLAS, allocator
        beam_decode_attn.launches = 0
        paths, scores = run()
        torch.cuda.synchronize()
        launches = beam_decode_attn.launches
        if launches != expected:
            raise SystemExit(f"phase11 B={B}: K7 launched {launches} times, expected {expected}")
        if paths.shape != (B, W, H) or not bool(torch.isfinite(scores).all()) or \
                bool((paths < 0).any()) or bool((paths >= cfg.codebook_size).any()) or \
                bool((scores[:, :-1] < scores[:, 1:]).any()):
            raise SystemExit(f"phase11 B={B}: bad paths or scores")
        kv_ms = host_ms(run, 5)
        log(f"phase11 B={B}: history tokens {batch.history_lengths.tolist()} "
            f"generate_beam_decode_ms={kv_ms:.2f} (median of 5) K7 launches per call="
            f"{launches} best score {scores[0, 0].item():.4f} worst {scores[0, -1].item():.4f}")
        profile_call(run, f"phase11 B={B} profile of one generate_beam_decode", top=12, groups={
            "K7": ("beam_wgmma_kernel", "scalar::kernel"),
            "GEMM": ("gemm", "nvjet", "cutlass", "xmma"),
            "sort": ("sort", "radix"),
        })

        # the kernels against the plain attention on the card, and a faulted
        # control: the plain attention with scores 2% too large
        kernels, outs_k = traced_attention(run, L)
        plain, outs_p = traced_attention(run, L, attn_backend="plain")
        faulted, outs_f = traced_attention(run, L, scale=1.02, attn_backend="plain")
        sound_a = [rel_l2(k, p) for k, p in zip(outs_k, outs_p)]
        control_a = [rel_l2(f, p) for f, p in zip(outs_f, outs_p)]
        sound = compare_beams(kernels, plain, SID_LIMITS["scores"])
        control = compare_beams(faulted, plain, SID_LIMITS["scores"])
        show = lambda r: (f"score diff max {r[0]:.3e} mean {r[1]:.3e}, {r[2]} of {B * W} "
                          f"beams differ, {r[3]} of them clear of their neighbours")
        fmt = lambda xs: "[" + ", ".join(f"{x:.2e}" for x in xs) + "]"
        log(f"phase11 B={B} kernels against plain: step-1 attention rel L2 by layer "
            f"{fmt(sound_a)} (limit {SID_LIMITS['attention']:g}); {show(sound)} "
            f"(limit {SID_LIMITS['scores']:g})")
        log(f"phase11 B={B} control, plain with sm_scale x 1.02 against plain: "
            f"{fmt(control_a)}; {show(control)}")
        if max(sound_a) >= SID_LIMITS["attention"] or sound[0] >= SID_LIMITS["scores"] \
                or sound[3]:
            raise SystemExit(f"phase11 B={B}: the search through K7 disagrees with the plain one")
        if max(control_a) < SID_LIMITS["attention"]:
            raise SystemExit(f"phase11 B={B}: the faulted control passes the comparison")
        del outs_k, outs_p, outs_f, kernels, plain, faulted

        # every decode step by itself (N = 1, 2, 3 tail keys, the later ones
        # under the search's own re-rooted ancestry): each K7 call of a run
        # against the plain version on that call's inputs, worst batch row,
        # and the control: K7 with scores 2% too large against the same
        _, sound_r = traced_attention(run, 0, replay=True)
        _, control_r = traced_attention(run, 0, scale=1.02, replay=True)
        by_step = lambda xs: [xs[i * L:(i + 1) * L] for i in range(H - 1)]
        for h, (sr, cr) in enumerate(zip(by_step(sound_r), by_step(control_r)), 1):
            log(f"phase11 B={B} step {h} (N={h}) K7 against plain on its own inputs, worst row "
                f"rel L2 by layer {fmt(sr)} (limit {SID_LIMITS['attention']:g}); control "
                f"{fmt(cr)}")
            if len(sr) != L or max(sr) >= SID_LIMITS["attention"]:
                raise SystemExit(f"phase11 B={B}: K7 disagrees with its plain version in step {h}")
            if max(cr) < SID_LIMITS["attention"]:
                raise SystemExit(f"phase11 B={B}: the faulted control passes in step {h}")

        base_ms = None
        if B == 1:
            # the no-KV oracle. Not at B 16: its dense scores would be
            # [3200, 8, 1028, 1028] fp32, 108 GB a layer
            base = model.generate(batch)
            r = compare_beams((paths, scores), base, SID_LIMITS["scores"])
            log(f"phase11 B=1 generate_beam_decode against generate: {show(r)} "
                f"(limit {SID_LIMITS['scores']:g})")
            if r[0] >= SID_LIMITS["scores"] or r[3]:
                raise SystemExit("phase11: the cached search disagrees with the baseline")
            base_ms = host_ms(lambda: model.generate(batch), 2)
            del base
        print(json.dumps({
            "bench": "sid_beam_decode", "batch": B, "history_items": SID_HISTORY_ITEMS,
            "beam": W, "generate_ms": None if base_ms is None else round(base_ms, 1),
            "beam_decode_ms": round(kv_ms, 1),
            "speedup": None if base_ms is None else round(base_ms / kv_ms, 2),
            "backend": "cuda"}), flush=True)
        res[B] = dict(launches=launches, beam_decode_ms=kv_ms, generate_ms=base_ms)
        torch.cuda.empty_cache()
    log(f"phase11 peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    del model
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------- phase 12
def phase_sid_serve():
    from recsys_examples_torch.inference.sid_serving.engine import (
        GRServingEngine, ServingConfig)
    from recsys_examples_torch.inference.sid_serving.scheduler import GRContinuousScheduler
    from recsys_examples_torch.ops.beam_decode_attention import beam_decode_attn

    beam, ctx, batch, iters, H = 64, 512, 8, 20, 4
    model = sid_model(SEED + 12, hidden_size=512, num_heads=4, ffn_hidden=1024,
                      beam_width=beam)
    eng = GRServingEngine(model, ServingConfig(
        beam_width=beam, ctx_buckets=(ctx,), batch_buckets=(batch,)))
    rng = np.random.default_rng(SEED)

    def mk_ctx(lo=ctx // 2, hi=ctx):
        n = int(rng.integers(lo, hi))
        n -= n % H
        return rng.integers(0, 256, size=(max(n, H),)).astype(np.int32)

    # offline: batched generate throughput
    ctxs = [mk_ctx() for _ in range(batch)]
    eng.generate(ctxs)
    beam_decode_attn.launches = 0
    t0 = time.perf_counter()
    for _ in range(iters):
        paths, scores = eng.generate(ctxs)
    dt = (time.perf_counter() - t0) / iters
    launches = beam_decode_attn.launches
    if paths.shape != (batch, beam, H) or not np.isfinite(scores).all():
        raise SystemExit("phase12: bad offline answer")
    if launches != iters * (H - 1) * model.config.num_layers:
        raise SystemExit(f"phase12: K7 launched {launches} times over {iters} batches")
    # online: per-request latency through the scheduler
    sched = GRContinuousScheduler(eng, max_batch=batch)
    lat = []
    for _ in range(iters):
        rids = [sched.submit(mk_ctx(), top_k=10) for _ in range(batch)]
        sched.run_until_empty()
        for rid in rids:
            r = sched.get_result(rid)
            if r is None or len(r.get("sids", ())) != 10:
                raise SystemExit(f"phase12: request not answered: {r}")
            lat.append(r["latency_ms"])
    lat = np.asarray(lat)
    print(json.dumps({
        "metric": "sid_serving", "backbone": "sidgr", "beam": beam, "ctx_bucket": ctx,
        "batch": batch, "offline_batch_ms": round(dt * 1e3, 2),
        "offline_req_per_s": round(batch / dt, 2),
        "online_median_ms": round(float(np.median(lat)), 2),
        "online_p99_ms": round(float(np.percentile(lat, 99)), 2),
        "backend": "cuda"}), flush=True)
    profile_call(lambda: eng.generate(ctxs), "phase12 profile of one offline batch", top=8)

    # a dozen requests of mixed lengths over the default buckets, prefix cache on
    eng2 = GRServingEngine(model, ServingConfig())
    sched2 = GRContinuousScheduler(eng2, max_batch=8, prefix_cache_size=64)
    first = [mk_ctx(lo, hi) for lo, hi in
             ((4, 60), (8, 64), (70, 250), (100, 256), (300, 1000), (600, 1024),
              (4, 64), (200, 256), (900, 1024))]
    beam_decode_attn.launches = 0
    rids = [sched2.submit(c, top_k=5) for c in first]
    sched2.run_until_empty()
    answers = [sched2.get_result(r) for r in rids]
    repeats = [0, 4, 8]
    again = [sched2.get_result(sched2.submit(first[i], top_k=5)) for i in repeats]
    st = sched2.status()
    log(f"phase12 mixed: {len(first)} requests in {int(st['batches'])} batches over "
        f"{st['compiled_buckets']} buckets, {len(again)} repeated, prefix cache hits "
        f"{int(st['prefix_cache_hits'])}, K7 launches {beam_decode_attn.launches}")
    if any(a is None or len(a.get("sids", ())) != 5 for a in answers + again):
        raise SystemExit("phase12: a request of the mixed wave was not answered")
    if any(not a.get("cached") or a["sids"] != answers[i]["sids"]
           for a, i in zip(again, repeats)):
        raise SystemExit("phase12: a repeated request did not return the first answer")
    if st["completed"] != len(first) or st["queue_depth"] or not beam_decode_attn.launches:
        raise SystemExit("phase12: not every request went through the engine")
    del model
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 13
def phase_quant_paged(attn):
    """K6-int8 at benchmark_paged_kv.py's points, beside the bf16 kernel on the
    same pages, then at the edges: pages of 16 and 32 rows, unset pages mid-
    history, a user with nothing cached, caches that end inside a chunk, the
    two-consumer instance, heads whose scales do not ride TMA (H 2). Every
    case: padded rows exactly zero, two launches equal bit for bit. Returns
    the results and the launches of the drive over the eight points."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    H, dh, pg, S = 4, 256, 128, 8
    points = [(hist, B, tgt) for hist in (1024, 3968) for B in (1, 8) for tgt in (False, True)]
    cases = {}
    for hist, B, tgt in points:
        maxp = (hist + pg - 1) // pg
        c = attention_case(gen, B, S, H, dh, pg, maxp, [hist] * B, [S] * B,
                           [S // 2] * B if tgt else None)
        c["scaling"] = float(hist + S)
        cases[(hist, B, tgt)] = c
    edges = {
        "pg32_holes": attention_case(gen, 4, S, H, dh, 32, 124, [3968, 0, 1000, 2047],
                                     [8, 8, 3, 8], [4, 0, 0, 8],
                                     unset=[(0, 50), (2, 3), (3, 0)]),
        "pg16_s128_holes": attention_case(gen, 4, 128, H, dh, 16, 130, [2048, 0, 1000, 1543],
                                          [128, 128, 77, 100], None, unset=[(0, 40), (3, 9)]),
        "odd_dh64": attention_case(gen, 4, 40, 2, 64, 16, 6, [0, 37, 80, 96],
                                   [40, 13, 39, 33], [3, 0, 39, 7], unset=[(1, 1)]),
    }
    for c in edges.values():
        c["scaling"] = 136.0
    for c in (*cases.values(), *edges.values()):
        c["int8"] = attn.quantize_kv_pages(c["k_pages"], c["v_pages"])

    def call(c, quantized, fn=None):
        k8, v8, ks, vs = c["int8"]
        alpha = c["q"].shape[-1] ** -0.5
        args = [c[k] for k in ("q", "k_pages", "v_pages", "page_table", "cached_len",
                               "new_k", "new_v", "new_lens", "num_targets")]
        if quantized:
            args[1], args[2] = k8, v8
            return attn.paged_hstu_delta_attention(*args, alpha, c["scaling"],
                                                   k_scales=ks, v_scales=vs)
        return (fn or attn.paged_hstu_delta_attention)(*args, alpha, c["scaling"])

    def check(tag, c, got):
        """Against the plain version on the dequantized pages; padded rows,
        a second launch."""
        k8, v8, ks, vs = c["int8"]
        deq = dict(c, k_pages=k8.float() * ks[..., None], v_pages=v8.float() * vs[..., None])
        want = call(deq, False, attn.paged_hstu_delta_attention_ref)
        err = (got.float() - want.float()).abs().max().item()
        ref = want.float().abs().max().item()
        same, zeros = torch.equal(got, call(c, True)), padded_rows_zero(got, c["new_lens"])
        if not (within(err, ref) and bool(torch.isfinite(got).all()) and same and zeros):
            raise SystemExit(f"phase13: the int8 paged kernel disagrees at {tag}: "
                             f"err {err:.3e} of max {ref:.3e}, repeat equal {same}, "
                             f"padded rows zero {zeros}")
        return deq, err, ref

    # the drive: every point once through the public entry
    attn.paged_hstu_delta_attention_int8.launches = 0
    outs = {k: call(c, True) for k, c in cases.items()}
    torch.cuda.synchronize()
    launches = attn.paged_hstu_delta_attention_int8.launches
    if launches != len(points):
        raise SystemExit(f"phase13: the int8 paged kernel launched {launches} times")
    res = {}
    for key, c in cases.items():
        hist, B, tgt = key
        deq, err, ref = check(key, c, outs[key])
        bf16_out = call(c, False)
        err_bf16 = (outs[key].float() - bf16_out.float()).abs().max().item()
        t = [median_time_ms(lambda: call(c, False), 20), median_time_ms(lambda: call(c, True), 20),
             median_time_ms(lambda: call(c, True), 20), median_time_ms(lambda: call(c, False), 20)]
        ms, ms_bf16 = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
        dev = [device_ms(lambda: call(c, q), PAGED_KERNELS) for q in (True, False)]
        plain_ms = median_time_ms(lambda: call(deq, False, attn.paged_hstu_delta_attention_ref), 3)
        nbytes, flops = attention_work(c)
        rows = cached_rows_read(c)
        # int8 pages: one byte an element and two fp32 scales a (token, head)
        nbytes += -2 * rows * H * dh * 2 + 2 * rows * (H * dh + 4 * H)
        bound_ms, bound_by = bound_of(nbytes, flops)
        plan = paged_plan(attn, c)
        log(f"phase13 paged_int8 hist={hist} B={B} targets={tgt}: plan=(splits {plan.splits}, "
            f"consumers {plan.consumers}) max_abs_err={err:.3e} "
            f"tol={2e-2 * ref + 1e-3:.3e} (2e-2*max|ref|+1e-3) against the bf16 kernel on the "
            f"unquantized pages {err_bf16:.3e}; kernel_ms={ms:.4f} bf16_kernel_ms={ms_bf16:.4f} "
            f"(in turns) device_ms={dev[0]:.4f} bf16_device_ms={dev[1]:.4f} "
            f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}: "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
        res[key] = dict(err=err, kernel_ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, bf16_kernel_ms=ms_bf16, device_ms=dev[0],
                        bf16_device_ms=dev[1])
    for tag, c in edges.items():
        _, err, ref = check(tag, c, call(c, True))
        plan = paged_plan(attn, c)
        log(f"phase13 paged_int8 {tag}: shape={tuple(c['q'].shape)} pg={c['k_pages'].shape[1]} "
            f"plan=(splits {plan.splits}, consumers {plan.consumers}) max_abs_err={err:.3e} "
            f"tol={2e-2 * ref + 1e-3:.3e}")
        res[tag] = dict(err=err)
    return res, launches


INT8_OPS = 1979e12      # H100 SXM dense int8 tensor-core peak


def phase_quant_fwd(main_batch):
    """K5 at phase 5's lengths and mask families, at K1's 128-row CTA edges
    (c 70 and 130, head dims 32-256, a batch of whole tiles) and at the
    full-width training shape, against its plain version (each case launched
    twice, equal bit for bit), the bf16 forward and K1, with both bounds."""
    from recsys_examples_torch.ops import hstu_attention as ha
    from recsys_examples_torch.ops.hstu_attention_ref import hstu_mha_int8_reference

    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    i32 = lambda x: None if x is None else torch.tensor(x, dtype=torch.int32, device="cuda")

    def quantized(lengths, H, dh):
        q, k, v, _, offsets = attention_operands(gen, lengths, H, dh, pad=0)
        return (q, k, v), [ha.quantize_per_tensor(x) for x in (q, k, v)], offsets

    def check(tag, lengths, H, dh, N, alpha, **mask):
        _, ((q8, sq), (k8, sk), (v8, sv)), offsets = quantized(lengths, H, dh)
        run = lambda: ha.hstu_attn_varlen_quantized_calibrated(
            q8, k8, v8, sq, sk, sv, offsets, N, alpha=alpha, **mask)
        got = run()
        want = hstu_mha_int8_reference(N, alpha, q8, k8, v8, sq, sk, sv, offsets, **mask)
        err = (got.float() - want.float()).abs().max().item()
        ref = want.float().abs().max().item()
        same = torch.equal(got, run())
        log(f"phase13 fwd_int8 {tag}: lengths={lengths} H={H} dh={dh} max_abs_err={err:.3e} "
            f"max|ref|={ref:.3e} tol={2e-2 * ref + 1e-3:.3e} (2e-2*max|ref|+1e-3) "
            f"repeat equal {same}")
        if not (within(err, ref) and same) or bool(got[sum(lengths):].any()) \
                or got.dtype != torch.bfloat16:
            raise SystemExit(f"phase13: the int8 forward disagrees at {tag}")
        return err

    lengths = [2000, 37, 1024, 129, 0, 1]
    ctx, tgt = [3, 3, 3, 3, 0, 1], [64, 4, 10, 7, 0, 0]
    cases = {
        "causal": (dict(), None, None),
        "ctx_tgt_group2": (dict(target_group_size=2), ctx, tgt),
        "window64": (dict(max_attn_len=64), None, None),
        "window64_minfull": (dict(max_attn_len=64, min_full_attn_seq_len=128), None, tgt),
        "noncausal": (dict(causal=False), None, None),
    }
    errs = [check(name, lengths, 4, 256, 2048, 1 / 16, num_contextuals=i32(c),
                  num_targets=i32(t), **kw) for name, (kw, c, t) in cases.items()]
    errs.append(check("odd_h2_dh64", [77, 0, 300, 5], 2, 64, 320, 0.125,
                      num_contextuals=i32([2, 0, 1, 0]), num_targets=i32([9, 0, 31, 2]),
                      target_group_size=3))
    # K1's 128-row CTA: lengths at its edges, consumer 1 without rows,
    # contextual rows across the consumer boundary (c 70) and past the CTA
    # (c 130), with targets; every head dim; a batch of whole tiles (the
    # interior tiles skip the mask)
    for dh in (32, 64, 128, 256):
        errs.append(check(f"cta_edges_dh{dh}", [127, 128, 129, 257, 191, 64, 1], 2, dh, 320,
                          dh ** -0.5))
        errs.append(check(f"ctx70_130_dh{dh}", [300, 200, 260, 129], 2, dh, 320, dh ** -0.5,
                          num_contextuals=i32([70, 130, 130, 70]), num_targets=i32([9, 0, 31, 2]),
                          target_group_size=2))
    errs.append(check("whole_tiles", [512, 256, 1024, 128], 4, 256, 1024, 1 / 16))

    # the full-width training shape (phase 6b's): the drive, then the checks
    lengths = [int(n) for n in seqlens_of(main_batch)]
    N, H, dh = 2 * 4096 + N_CTX, 4, 256
    (q, k, v), ((q8, sq), (k8, sk), (v8, sv)), offsets = quantized(lengths, H, dh)
    nc = torch.full((len(lengths),), N_CTX, dtype=torch.int32, device="cuda")
    alpha = dh ** -0.5
    ha.hstu_attn_fwd_int8_cuda.launches = 0
    got = ha.hstu_attn_varlen_quantized_calibrated(
        q8, k8, v8, sq, sk, sv, offsets, N, num_contextuals=nc, alpha=alpha)
    torch.cuda.synchronize()
    launches = ha.hstu_attn_fwd_int8_cuda.launches
    if launches != 1:
        raise SystemExit(f"phase13: the int8 forward launched {launches} times")
    opts = ha.AttnOptions(max_seqlen=N, alpha=alpha, scaling_seqlen=N)
    o32 = offsets.to(torch.int32)
    k1 = lambda: ha.hstu_attn_fwd_cuda(q, k, v, o32, nc, None, opts)
    k5 = lambda: ha.hstu_attn_varlen_quantized_calibrated(
        q8, k8, v8, sq, sk, sv, offsets, N, num_contextuals=nc, alpha=alpha)
    t = [median_time_ms(k1, 3), median_time_ms(k5, 3), median_time_ms(k5, 3),
         median_time_ms(k1, 3)]
    ms, ms_k1 = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
    same = torch.equal(got, k5())
    full = k1()
    err = ref = quant_err = full_ref = plain_ms = 0.0
    for b, n in enumerate(lengths):     # the plain version, sequence by sequence
        s = slice(int(offsets[b]), int(offsets[b + 1]))
        one = torch.tensor([0, n], device="cuda")
        f = lambda: hstu_mha_int8_reference(
            n, alpha, q8[s], k8[s], v8[s], sq, sk, sv, one, scaling_seqlen=N,
            num_contextuals=nc[:1])
        plain_ms += cuda_time_ms(f, 1)
        want = f()
        err = max(err, (got[s].float() - want.float()).abs().max().item())
        ref = max(ref, want.float().abs().max().item())
        quant_err = max(quant_err, (got[s].float() - full[s].float()).abs().max().item())
        full_ref = max(full_ref, full[s].float().abs().max().item())
    work = jagged_attention_work(lengths, H, dh, opts, ctx=[N_CTX] * len(lengths))
    T = sum(lengths)
    nbytes = 3 * T * H * dh + T * H * dh * 2      # int8 q, k, v read; bf16 out written
    flops = work["fwd"][1]                        # S and P V, half each
    bf16_bound = bound_of(nbytes, flops)
    # S on int8 operands at the int8 rate, P V at the bf16 rate
    ops_ms = (flops / 2 / INT8_OPS + flops / 2 / BF16_FLOPS) * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms, bound_by = max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"
    log(f"phase13 fwd_int8 main-shape: T={T} max_abs_err={err:.3e} max|ref|={ref:.3e} "
        f"tol={2e-2 * ref + 1e-3:.3e} repeat equal {same}; against the bf16 forward on the "
        f"unquantized operands {quant_err:.3e} of max {full_ref:.3e}; kernel_ms={ms:.4f} "
        f"K1_ms={ms_k1:.4f} (in turns) plain_ms(per sequence)={plain_ms:.2f} "
        f"bound_ms={bound_ms:.4f} ({bound_by}: {nbytes / 1e6:.1f} MB, {flops / 2e9:.2f} GOP "
        f"int8 S + {flops / 2e9:.2f} GFLOP bf16 P V) bound_ms_at_bf16_rate="
        f"{bf16_bound[0]:.4f}")
    if not (within(err, ref) and same):
        raise SystemExit("phase13: the int8 forward disagrees at the main shape")
    return dict(err=max(errs + [err]), kernel_ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, bf16_bound_ms=bf16_bound[0], launches=launches, k1_ms=ms_k1)


# ---------------------------------------------------------------- phase 15
class PrefetchWatch:
    """While active, wraps the entry's cache's `prefetch`: the host time of
    each prefetch (it ends on a host read of the device, so the clock sees
    its device work), and the item keys each train step had to insert
    (table counter `inserted` across the step: a batch key that the
    prefetch left off the card)."""

    def __enter__(self):
        from recsys_examples_torch.dynamicemb.hybrid_storage import HybridDynamicEmbedding

        self.cls, self.orig = HybridDynamicEmbedding, HybridDynamicEmbedding.prefetch
        self.ms, self.step_inserts, self.after = [], [], None
        watch = self

        def spy(cache, state, keys):
            now = int(state.table.inserted[0])
            if watch.after is not None:
                watch.step_inserts.append(now - watch.after)
            t0 = time.perf_counter()
            out = watch.orig(cache, state, keys)
            watch.ms.append((time.perf_counter() - t0) * 1e3)
            watch.after = int(state.table.inserted[0])
            watch.state = state
            return out

        HybridDynamicEmbedding.prefetch = spy
        return self

    def __exit__(self, *exc):
        self.cls.prefetch = self.orig
        if self.after is not None:   # the last step
            self.step_inserts.append(int(self.state.table.inserted[0]) - self.after)


def phase_cache_entry(tmp, ref_ms=None):
    """15a. The ranking entry with `DynamicEmbeddingArgs.caching` at phase
    14a's full width (ranking_kuairand_bench.gin: 8 layers, hidden 1024,
    4 x 256, bf16, batch 32, history 2048, 128 candidates) over a 32,768-row
    item table and a 131,072-id vocabulary: about 10k ids a step, so from
    step 4 on every prefetch evicts to the host tier and onboards from it.
    Held: host onboards and evict flushes > 0, no insert failure, no batch
    key missing on the card after its prefetch (the train steps insert
    nothing), losses within 1e-5 of the same entry uncached at 524,288 rows
    on the same batches; K1-K3 against their plain versions at the entry's
    first attention call. Returns the run's numbers and its final state."""
    from recsys_examples_torch.training import pretrain_gr_ranking as rank

    tag = "phase15a"
    steps = 8
    common = [f"TrainerArgs.max_train_iters = {steps}", "TrainerArgs.log_interval = 1",
              "TrainerArgs.eval_iters = 1", "DatasetArgs.item_vocab_size = 131072"]
    cached_gin = entry_gin(tmp, "cached.gin", "ranking_kuairand_bench.gin", common + [
        "DynamicEmbeddingArgs.caching = True", "DynamicEmbeddingArgs.capacity = 32768"])
    plain_gin = entry_gin(tmp, "uncached.gin", "ranking_kuairand_bench.gin", common + [
        "DynamicEmbeddingArgs.capacity = 524288"])
    with FirstAttentionCall() as first, PrefetchWatch() as watch:
        state, launches, entry_log, seconds = run_entry(rank.main, cached_gin)
    cache = rank.LAST_CACHE
    rows = log_entry_steps(tag, entry_log, steps)
    check_launches(tag, launches, 8, steps, 1)
    ref_state, _, ref_log, _ = run_entry(rank.main, plain_gin)
    del ref_state
    ref_rows = ref_log.steps()
    losses, ref_losses = [r[1] for r in rows], [r[1] for r in ref_rows]
    step_ms = statistics.median(r[2] for r in rows[1:])
    ref_step_ms = statistics.median(r[2] for r in ref_rows[1:])
    pre_ms = statistics.median(watch.ms[1:])
    log(f"{tag} config: ranking_kuairand_bench.gin, caching, item table 32768 x 1024 "
        f"(rowwise adagrad: {cache.table.value_dim} floats a row) over a host tier, "
        f"131072-id vocabulary; main() took {seconds:.1f} s; cache stats {cache.stats}, "
        f"hit rate {cache.hit_rate():.4f}, host tier {len(cache.host)} rows")
    log(f"{tag} prefetch host ms per step {[round(x, 2) for x in watch.ms]} (median after "
        f"the first {pre_ms:.2f}, {100 * pre_ms / step_ms:.1f}% of the step); train-step "
        f"inserts per step {watch.step_inserts}")
    log(f"{tag} step_ms median after the first {step_ms:.1f} (uncached at 524288 rows, "
        f"same batches: {ref_step_ms:.1f}; phase 14a at 4194304 rows: "
        f"{'not run' if ref_ms is None else f'{ref_ms:.1f}'}); losses {losses}, uncached "
        f"{ref_losses}")
    st = cache.stats
    if not (st["host_onboards"] > 0 and st["evict_flushes"] > 0 and st["insert_failures"] == 0):
        raise SystemExit(f"{tag}: the cache did not evict and onboard cleanly: {st}")
    if len(watch.step_inserts) != steps or any(watch.step_inserts):
        raise SystemExit(f"{tag}: a train step inserted keys its prefetch left off the "
                         f"card: {watch.step_inserts}")
    if len(ref_losses) != steps or any(abs(a - b) > 1e-5 + 1e-9
                                       for a, b in zip(losses, ref_losses)):
        raise SystemExit(f"{tag}: the cached entry's losses left the uncached ones")
    check_main_path_attention(tag, first.call, 4, 256)
    return dict(step_ms=step_ms, ref_step_ms=ref_step_ms, prefetch_ms=pre_ms,
                stats=dict(st), launches=launches), state.sparse["item"], cache


def phase_tiered_roundtrip(tmp, value_dim):
    """15b. An embedding cache of 8,192 rows (14a's row: 1024 + the
    optimizer's) over a TieredHostStorage of 4,096 RAM rows and an SSD arena
    in a temp dir: 6,000 keys trained, two waves of 6,000 others push them
    to the host tier and down to SSD, then a prefetch brings them back
    through spill and promote. Their rows and optimizer rows must equal the
    ones that went out, bit for bit."""
    from recsys_examples_torch.dynamicemb.batched_table import DynamicEmbeddingTable
    from recsys_examples_torch.dynamicemb.dynamicemb_config import DynamicEmbTableOptions
    from recsys_examples_torch.dynamicemb.hashtable import lookup
    from recsys_examples_torch.dynamicemb.hybrid_storage import HybridDynamicEmbedding
    from recsys_examples_torch.dynamicemb.optimizer import SparseOptimizerArgs
    from recsys_examples_torch.dynamicemb.tiered_storage import TieredHostStorage

    tag = "phase15b"
    t0 = time.perf_counter()
    table = DynamicEmbeddingTable(DynamicEmbTableOptions(embedding_dim=1024, max_capacity=8192),
                                  SparseOptimizerArgs(optimizer="rowwise_adagrad"))
    assert table.value_dim == value_dim
    tiered = TieredHostStorage(value_dim, ram_capacity=4096,
                               ssd_path=os.path.join(tmp, "emb_ssd.bin"), ssd_capacity=16384)
    cache = HybridDynamicEmbedding(table, host_storage=tiered)
    state = cache.init_state()
    rng = np.random.default_rng(SEED + 15)
    waves = rng.choice(1 << 40, 18000, replace=False).astype(np.int64).reshape(3, 6000)
    for i, keys in enumerate(waves):
        cache.prefetch(state, keys)
        kt = torch.from_numpy(np.sort(keys)).cuda()
        state, slots, _ = table.forward_train(state, kt)
        table.backward(state, slots, torch.randn(len(keys), 1024, device="cuda"), keys=kt)
        if i == 0:
            out = torch.cat([state.table.values[slots], state.table.opt[slots]], 1).clone()
    back = torch.from_numpy(np.sort(waves[0])).cuda()
    _, found = lookup(state.table, back)
    gone = int((~found).sum())
    cache.prefetch(state, waves[0])
    slots, found = lookup(state.table, back)
    got = torch.cat([state.table.values[slots], state.table.opt[slots]], 1)
    same = bool(found.all()) and torch.equal(got, out)
    log(f"{tag} {gone} of 6000 keys had left the card; tiered stats {tiered.stats}, RAM "
        f"{tiered.ram_len} rows, SSD {tiered.ssd_len} rows; cache stats {cache.stats}; the "
        f"rows came back bit for bit: {same}; {time.perf_counter() - t0:.1f} s")
    if not (same and gone > 0 and tiered.stats["ssd_spills"] > 0
            and tiered.stats["ssd_hits"] > 0):
        raise SystemExit(f"{tag}: the tiered round trip lost or changed rows")


def phase_pooled_grouped():
    """15c. Pooled and grouped tables at benchmarks/benchmark_dynamicemb.py's
    on-accelerator sizes: 65,536 ids in 2,048 bags of 32, dim 128, capacity
    1 << 22 (rowwise adagrad). SUM and MEAN must equal the bag sums of the
    per-token rows of separate lookups (`torch.segment_reduce`); the grouped
    table (two features of 32,768 ids) each feature's rows of the inner
    table's own lookup. Train step ms (forward + backward)."""
    from recsys_examples_torch.dynamicemb.batched_table import DynamicEmbeddingTable
    from recsys_examples_torch.dynamicemb.dynamicemb_config import DynamicEmbTableOptions
    from recsys_examples_torch.dynamicemb.optimizer import SparseOptimizerArgs
    from recsys_examples_torch.dynamicemb.pooled import PooledDynamicEmbedding, PoolingMode
    from recsys_examples_torch.dynamicemb.sharded_collection import (
        GroupedShardedDynamicEmbedding, ShardedDynamicEmbedding)

    tag = "phase15c"
    n_ids, B, dim = 65536, 2048, 128
    rng = np.random.default_rng(SEED + 16)
    # the benchmark's ids: Zipf(1.1) folded into 4 x the capacity
    ids = torch.from_numpy(rng.zipf(1.1, n_ids).astype(np.int64) % (4 << 22)).cuda()
    offsets = torch.arange(B + 1, device="cuda", dtype=torch.int32) * (n_ids // B)
    res = {}

    def make():
        return DynamicEmbeddingTable(
            DynamicEmbTableOptions(embedding_dim=dim, max_capacity=1 << 22),
            SparseOptimizerArgs(optimizer="rowwise_adagrad"))

    for mode in (PoolingMode.SUM, PoolingMode.MEAN):
        inner = ShardedDynamicEmbedding(make())
        pe = PooledDynamicEmbedding(inner, mode)
        state = pe.init_state()
        g = torch.randn(B, dim, device="cuda")

        def step():
            st, pooled, r = pe.forward(state, ids, offsets)
            pe.backward(st, r, g)
            return pooled

        step()
        ms = median_time_ms(step, 5)
        _, pooled, _ = pe.forward(state, ids, offsets, train=False)
        _, rows, _ = inner.forward(state, ids, train=False)
        want = torch.segment_reduce(rows, "sum", lengths=offsets.diff())
        if mode == PoolingMode.MEAN:
            want = want / (n_ids // B)
        err = (pooled - want).abs().max().item()
        scale = want.abs().max().item()
        log(f"{tag} pooled {mode}: {n_ids} ids in {B} bags, dim {dim}: train step "
            f"(forward + backward) {ms:.3f} ms; against the bag sums of the per-token rows "
            f"max_abs_err={err:.3e} of max {scale:.3e} (limit 1e-5 * max + 1e-6)")
        if not err <= 1e-5 * scale + 1e-6:
            raise SystemExit(f"{tag}: the pooled {mode} forward disagrees")
        res[mode] = ms
    grouped = GroupedShardedDynamicEmbedding(make(), ("item", "user"))
    state = grouped.init_state()
    feats = {"item": ids[:n_ids // 2], "user": ids[n_ids // 2:]}
    grads = {k: torch.randn(v.shape[0], dim, device="cuda") for k, v in feats.items()}

    def gstep():
        st, emb, r = grouped.forward(state, feats)
        grouped.backward(st, r, grads)
        return emb

    gstep()
    ms = median_time_ms(gstep, 5)
    _, emb, _ = grouped.forward(state, feats, train=False)
    ok = True
    for i, (k, v) in enumerate(feats.items()):
        _, want, _ = grouped.inner.forward(state, grouped._compose(v, i), train=False)
        ok &= torch.equal(emb[k], want)
    log(f"{tag} grouped (item, user: 32768 ids each in one table): train step {ms:.3f} ms; "
        f"rows equal the inner table's lookup of the tagged keys: {ok}")
    if not ok:
        raise SystemExit(f"{tag}: the grouped forward disagrees")
    res["grouped"] = ms
    return res


def phase_frozen(table, state):
    """15d. 15a's item table frozen: `inference_lookup` and the exported
    program (`export_serialized`, loaded back) against `forward_eval`, for
    the table's keys and a few it lacks, bit for bit."""
    from recsys_examples_torch.dynamicemb import exportable_tables as ex
    from recsys_examples_torch.dynamicemb.dynamicemb_config import EMPTY_KEY

    tag = "phase15d"
    keys = state.table.keys.reshape(-1)
    keys = keys[keys != EMPTY_KEY]
    probe = torch.cat([keys, torch.tensor([-5, 1 << 50], device="cuda")])
    frozen = ex.freeze_table(None, state)
    t0 = time.perf_counter()
    blob = ex.export_serialized(frozen, sample_n=probe.shape[0])
    export_s = time.perf_counter() - t0
    prog = ex.load_serialized(blob)
    want = table.forward_eval(state, probe)
    got = ex.inference_lookup(frozen, probe)
    out = prog.module()(probe)
    ok = torch.equal(got, want) and torch.equal(out, want)
    log(f"{tag} {keys.shape[0]} keys + 2 absent: inference_lookup and the exported "
        f"program ({len(blob) / 2**20:.1f} MiB, exported in {export_s:.1f} s) equal "
        f"forward_eval bit for bit: {ok}")
    if not ok:
        raise SystemExit(f"{tag}: the frozen table disagrees with forward_eval")


def phase_cache(ref_ms=None):
    """Phase 15: the embedding cache and its host tiers on the card."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_cache_")
    t0 = time.perf_counter()
    try:
        res, state, cache = phase_cache_entry(tmp, ref_ms)
        phase_frozen(cache.table, state)
        del state, cache
        torch.cuda.empty_cache()
        phase_tiered_roundtrip(tmp, 1025)
        res["pooled"] = phase_pooled_grouped()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"phase15 took {time.perf_counter() - t0:.1f} s")
    return res


# ---------------------------------------------------------------- phase 16
def phase_kv_offload(attn):
    """16. KV offload at phase 3's serving widths
    (benchmarks/benchmark_hstu_inference.py's defaults: HSTUConfig(), 8
    users of 2048 history tokens and 128 candidates): warm the users, then
    offload a user to the host tier, evict it and onboard it back; the warm
    call must give the never-evicted call's scores bit for bit (K6's split
    depends on the lengths, not the page ids). Again with
    ram_capacity_users 1 and an SSD dir: two users offloaded (the first
    spills), evicted, onboarded (the first promoted back). K6's launches."""
    import shutil
    import tempfile

    from recsys_examples_torch.inference.inference_ranking_gr import (
        InferenceDenseModule, InferenceRankingGR)
    from recsys_examples_torch.inference.kvcache import (
        HostKVStorage, KVCacheConfig, evict_users, lookup_kvcache)
    from recsys_examples_torch.modules.config import HSTUConfig

    tag = "phase16"
    t0 = time.perf_counter()
    cfg = HSTUConfig()
    B, hist, cand, chunk = 8, 2048, 128, 512
    S = hist + cand
    maxp = (S + 127) // 128 + 1
    kv_cfg = KVCacheConfig(
        num_layers=cfg.num_layers, num_heads=cfg.num_attention_heads,
        head_dim=cfg.kv_channels, page_size=128, num_pages=B * maxp * 2,
        max_users=B * 4, max_pages_per_user=maxp, dtype=cfg.dtype)
    table, _ = build_table(512, 128, cfg.hidden_size, 32768, SEED + 1)
    dense = InferenceDenseModule(cfg, (512, 1)).init_weights(torch.Generator().manual_seed(SEED))
    runner = InferenceRankingGR(cfg, kv_cfg, dense, table, device="cuda")
    rng = np.random.default_rng(SEED)
    users = np.arange(1, B + 1, dtype=np.int64)
    seq = rng.integers(1, 32768, size=(B, S)).astype(np.int64)
    lens = np.full((B,), S, np.int32)
    ncand = np.full((B,), cand, np.int32)
    runner.init_cache()
    for lo in range(0, S, chunk):
        runner.forward_with_kvcache(users, seq, np.minimum(lens, lo + chunk),
                                    ncand if lo + chunk >= S else None, chunk)
    warm = lambda: runner.forward_with_kvcache(users, seq, lens, ncand, cand)[0]
    want = warm()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_kv_")
    attn.paged_hstu_delta_attention.launches = 0
    try:
        for name, host, moved in (
                ("RAM", HostKVStorage(kv_cfg), [4]),
                ("RAM 1 user + SSD", HostKVStorage(kv_cfg, ram_capacity_users=1, ssd_dir=tmp),
                 [2, 7])):
            t1 = time.perf_counter()
            for u in moved:
                host.offload(runner.kv_state, u)
            runner.kv_state = evict_users(runner.kv_state, torch.tensor(moved, device="cuda"))
            gone = lookup_kvcache(runner.kv_state, torch.tensor(moved, device="cuda"))[0]
            for u in moved:
                runner.kv_state = host.onboard(runner.kv_state, u)
            torch.cuda.synchronize()
            move_s = time.perf_counter() - t1
            _, cached = lookup_kvcache(runner.kv_state, torch.tensor(moved, device="cuda"))
            got = warm()
            same = torch.equal(got, want)
            log(f"{tag} {name}: users {moved} offloaded ({host._elems_per_token * 2048 * 4 / 2**20:.0f} "
                f"MiB a user as float32), evicted (slots after {gone.tolist()}), onboarded "
                f"(cached {cached.tolist()}) in {move_s:.2f} s; host stats {host.stats}; the "
                f"warm call's scores equal the never-evicted call's bit for bit: {same}")
            if not (same and bool((gone < 0).all()) and bool((cached == hist).all())):
                raise SystemExit(f"{tag}: the onboarded users' scores changed ({name})")
            if name != "RAM" and not (host.stats["ssd_spills"] and host.stats["ssd_hits"]):
                raise SystemExit(f"{tag}: the SSD tier was not used: {host.stats}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = attn.paged_hstu_delta_attention.launches
    log(f"{tag} K6 launches over the two warm calls: {launches} (expected "
        f"{2 * cfg.num_layers}); {time.perf_counter() - t0:.1f} s")
    if launches != 2 * cfg.num_layers:
        raise SystemExit(f"{tag}: K6 did not carry the warm calls")
    del runner
    torch.cuda.empty_cache()
    return dict(launches=launches)


# ---------------------------------------------------------------- phase 17
def phase_repairs(attn):
    """17. The shapes and modes the kernels once refused, each against its
    plain version with its phase's tolerance: K1-K3 (forward, dq, dk, dv)
    and K4 at head dims 16, 48 and 96 (zero-padded by the wrappers to 32,
    64 and 128), K5 at the same; K6 at head dim 96 and at page sizes 24 and
    48 (chunks of 48 keys, no box across an 8-row swizzle atom) and 100 (a
    64-key chunk and a 36-key remainder a page), bf16 and int8 pages; K6-int8
    on fp32 queries; K7 at its D 256 instance (H 8 = Hkv, and GQA 8 over 2)
    and at D 96 (padded to 128). Returns K7's D 256 step (timed) and the
    launches of its drive."""
    from recsys_examples_torch.ops import beam_decode_attention as bda
    from recsys_examples_torch.ops import hstu_attention as ha
    from recsys_examples_torch.ops.hstu_attention_ref import hstu_mha_int8_reference

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device="cuda")
    errs = []
    for dh in (16, 48, 96):
        r = check_jagged_case(f"dh{dh}", gen, [77, 0, 300, 5, 129], 2, dh, 320,
                              dict(target_group_size=3), [2, 0, 70, 0, 1], [9, 0, 31, 2, 3],
                              phase="phase17")
        errs.append(r["err"])
        r = check_jagged_case(f"rab_dh{dh}", gen, [77, 0, 300, 5], 2, dh, 320,
                              dict(target_group_size=3), [2, 0, 1, 0], [9, 0, 31, 2],
                              rab_shape=(4, 1, 320, 323), phase="phase17")
        errs.append(r["err"])
        # K5
        q, k, v, _, offsets = attention_operands(gen, [300, 129, 1, 64], 2, dh, pad=0)
        (q8, sq), (k8, sk), (v8, sv) = (ha.quantize_per_tensor(x) for x in (q, k, v))
        mask = dict(num_contextuals=i32([70, 0, 1, 3]), num_targets=i32([9, 5, 0, 2]),
                    target_group_size=2)
        got = ha.hstu_attn_varlen_quantized_calibrated(q8, k8, v8, sq, sk, sv, offsets, 320,
                                                       alpha=dh ** -0.5, **mask)
        want = hstu_mha_int8_reference(320, dh ** -0.5, q8, k8, v8, sq, sk, sv, offsets, **mask)
        err = (got.float() - want.float()).abs().max().item()
        ref = want.float().abs().max().item()
        log(f"phase17 fwd_int8 dh{dh}: max_abs_err={err:.3e} tol={2e-2 * ref + 1e-3:.3e} "
            "(2e-2*max|ref|+1e-3)")
        if not within(err, ref) or got.shape[-1] != dh:
            raise SystemExit(f"phase17: K5 disagrees at head dim {dh}")
        errs.append(err)
    # K6: a padded head dim, page sizes off the 8/16/32/64k set, bf16 and int8
    paged = {
        "dh96_pg128": attention_case(gen, 4, 72, 2, 96, 128, 17, [2048, 0, 1000, 333],
                                     [72, 72, 5, 64], [8, 0, 5, 0], unset=[(0, 7)]),
        "dh128_pg24": attention_case(gen, 4, 72, 2, 128, 24, 90, [2048, 0, 1000, 335],
                                     [72, 72, 5, 64], [8, 0, 5, 0], unset=[(0, 7), (2, 20)]),
        "dh64_pg48_s8": attention_case(gen, 4, 8, 4, 64, 48, 43, [2000, 47, 1000, 0],
                                       [8, 8, 3, 8], None, unset=[(0, 11)]),
        "dh256_pg100_s128": attention_case(gen, 2, 128, 4, 256, 100, 21, [2048, 637],
                                           [128, 100], [16, 0], unset=[(0, 3)]),
    }
    for name, c in paged.items():
        errs.append(check_case(attn, name, c, scaling=2100)["err"])
        k8, v8, ks, vs = attn.quantize_kv_pages(c["k_pages"], c["v_pages"])
        args = [c[x] for x in ("q", "k_pages", "v_pages", "page_table", "cached_len", "new_k",
                               "new_v", "new_lens", "num_targets")]
        args[1], args[2] = k8, v8
        deq = list(args)
        deq[1], deq[2] = k8.float() * ks[..., None], v8.float() * vs[..., None]
        alpha = c["q"].shape[-1] ** -0.5
        for qdt in (torch.bfloat16, torch.float32):
            a = list(args)
            d = list(deq)
            for i in (0, 5, 6):
                a[i] = d[i] = args[i].to(qdt)
            got = attn.paged_hstu_delta_attention(*a, alpha, 2100.0, k_scales=ks, v_scales=vs)
            want = attn.paged_hstu_delta_attention_ref(*d, alpha, 2100.0)
            err = (got.float() - want.float()).abs().max().item()
            ref = want.float().abs().max().item()
            zeros = padded_rows_zero(got, c["new_lens"])
            log(f"phase17 paged_int8 {name} q {str(qdt)[6:]}: max_abs_err={err:.3e} "
                f"tol={2e-2 * ref + 1e-3:.3e} (2e-2*max|ref|+1e-3) padded_rows_zero={zeros}")
            if not (within(err, ref) and zeros and got.dtype == qdt):
                raise SystemExit(f"phase17: K6-int8 disagrees at {name}, q {qdt}")
            errs.append(err)
    # K7 at D 256 (timed: the kernels line's D 256 row) and GQA; D 96 padded
    lens = [1025, 700, 1, 0, 513, 1024, 64, 65]
    c = beam_case(gen, 8, 64, 8, 8, 256, 1025, 3, lens)
    bda.beam_decode_attn.launches = 0     # the drive: one call through the wrapper
    bda.beam_decode_attn(*beam_args(c), sm_scale=256 ** -0.5)
    torch.cuda.synchronize()
    launches = bda.beam_decode_attn.launches
    step = check_beam_case("d256", c, iters=10)
    step["launches"] = launches
    for name, c in (("d256_gqa4", beam_case(gen, 4, 200, 8, 2, 256, 600, 2, [600, 1, 333, 64])),
                    ("d256_n0", beam_case(gen, 2, 7, 2, 2, 256, 130, 0, [130, 65])),
                    ("d96_gqa2", beam_case(gen, 3, 64, 4, 2, 96, 200, 2, [200, 0, 77]))):
        errs.append(check_beam_case(name, c, timed=False)["err"])
    step["repair_err"] = max(errs)
    log(f"phase17 took {time.perf_counter() - t0:.1f} s")
    return step


# ---------------------------------------------------------------- phase 14
CONFIGS = Path(__file__).resolve().parent / "configs"
ENTRY_LINE = re.compile(r"^iter (\d+): loss=(\S+) step=(\S+)ms tflops=(\S+) mfu=(\S+)%")
STEP_GROUPS = {"attention": ATTN_NAMES, "GEMM": ("gemm", "nvjet", "cutlass", "xmma"),
               "gather/scatter": ("index", "scatter", "gather"), "sort": ("sort", "radix"),
               "optimizer": ("multi_tensor", "adam")}


class EntryLog(logging.Handler):
    """The entry's own log lines (its logger also prints them)."""

    def __init__(self):
        super().__init__()
        self.lines = []
        logging.getLogger("recsys_examples_torch").addHandler(self)

    def emit(self, record):
        self.lines.append(record.getMessage())

    def close(self):
        logging.getLogger("recsys_examples_torch").removeHandler(self)
        super().close()

    def steps(self):
        """[(iter, loss, step ms, TFLOP/s, MFU %)] of the `iter i:` lines."""
        return [(int(m[1]), float(m[2]), float(m[3]), float(m[4]), float(m[5]))
                for m in map(ENTRY_LINE.match, self.lines) if m]


def entry_gin(tmp, name, config, lines):
    """A gin file in `tmp` that includes the repo's `config` by absolute path
    and overrides `lines`."""
    path = os.path.join(tmp, name)
    with open(path, "w") as f:
        f.write("\n".join([f'include "{CONFIGS / config}"', *lines]) + "\n")
    return path


def run_entry(main, gin_path):
    """`main` on `gin_path` with the attention counters at 0 just before;
    returns (state, [K1, K2, K3 launches], entry log, seconds)."""
    from recsys_examples_torch.ops import hstu_attention as ha
    from recsys_examples_torch.utils import gin_config

    counters = (ha.hstu_attn_fwd_cuda, ha.hstu_attn_bwd_dq_cuda, ha.hstu_attn_bwd_dkv_cuda)
    others = (ha.hstu_attn_rab_fwd_cuda, ha.hstu_attn_rab_bwd_dq_cuda,
              ha.hstu_attn_rab_bwd_dkv_cuda)
    gin_config.clear_config()
    entry_log = EntryLog()
    for c in counters + others:
        c.launches = 0
    t0 = time.perf_counter()
    try:
        state = main(["--gin-config-file", gin_path])
        torch.cuda.synchronize()
    finally:
        entry_log.close()
    seconds = time.perf_counter() - t0
    if any(c.launches for c in others):
        raise SystemExit("phase14: a bias kernel launched on a path without a bias")
    return state, [c.launches for c in counters], entry_log, seconds


class FirstAttentionCall:
    """While active, records the arguments of the first jagged attention call
    that a layer makes (`modules.hstu_attention`'s `hstu_attn_varlen`): the
    main path's lengths, mask and head shape. Adds no launch."""

    def __enter__(self):
        from recsys_examples_torch.modules import hstu_attention as mha

        self.module, self.orig, self.call = mha, mha.hstu_attn_varlen, None

        def spy(q, k, v, seq_offsets, max_seqlen, **kw):
            if self.call is None:
                ints = lambda t: None if t is None else [int(x) for x in t.tolist()]
                self.call = dict(
                    H=q.shape[1], dh=q.shape[2], lengths=np.diff(ints(seq_offsets)).tolist(),
                    max_seqlen=int(max_seqlen), ctx=ints(kw.get("num_contextuals")),
                    tgt=ints(kw.get("num_targets")),
                    scaling_seqlen=int(kw.get("scaling_seqlen", -1)),
                    rab=kw.get("rab") is not None,
                    mask={n: kw[n] for n in ("causal", "target_group_size", "max_attn_len",
                                             "min_full_attn_seq_len") if n in kw})
            return self.orig(q, k, v, seq_offsets, max_seqlen, **kw)

        mha.hstu_attn_varlen = spy
        return self

    def __exit__(self, *exc):
        self.module.hstu_attn_varlen = self.orig


def check_main_path_attention(tag, call, H, dh):
    """K1-K3 against their plain versions at the lengths, mask and head
    shape that the entry's first attention call had (phase 5's check and
    tolerance, on random q, k, v and dO)."""
    c = call
    if c is None or (c["H"], c["dh"]) != (H, dh) or c["rab"]:
        raise SystemExit(f"{tag}: expected a first attention call at H {H} x {dh} without "
                         f"a bias, recorded {c and {k: c[k] for k in ('H', 'dh', 'rab')}}")
    n = c["lengths"]
    log(f"{tag} the entry's first attention call: B {len(n)}, T {sum(n)}, lengths "
        f"{min(n)}..{max(n)}, max_seqlen {c['max_seqlen']}, scaling_seqlen "
        f"{c['scaling_seqlen']}, contextual {c['ctx'] and sorted(set(c['ctx']))}, targets "
        f"{c['tgt'] and sorted(set(c['tgt']))}, mask {c['mask']}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    return check_jagged_case("main_path", gen, n, H, dh, c["max_seqlen"], c["mask"],
                             c["ctx"], c["tgt"], phase=tag,
                             scaling_seqlen=c["scaling_seqlen"])


def check_launches(tag, launches, layers, steps, eval_batches):
    want = [layers * (steps + eval_batches), layers * steps, layers * steps]
    log(f"{tag} launches K1/K2/K3={launches} (expected {want}: {layers} layers x "
        f"{steps} steps, K1 also x {eval_batches} eval batches)")
    if launches != want:
        raise SystemExit(f"{tag}: the attention kernels did not carry every layer")


def log_entry_steps(tag, entry_log, steps):
    rows = entry_log.steps()
    if len(rows) != steps or not all(np.isfinite(r[1]) for r in rows):
        raise SystemExit(f"{tag}: expected {steps} finite `iter` lines, got {rows}")
    for it, loss, ms, tf, mfu in rows:
        log(f"{tag} iter {it}: loss={loss:.5f} step_ms={ms:.1f} TFLOP/s={tf:.1f} MFU={mfu:.2f}%")
    later = [r[2] for r in rows[1:]]
    log(f"{tag} step_ms after the first: median {statistics.median(later):.1f} "
        f"min {min(later):.1f} max {max(later):.1f}; MFU median "
        f"{statistics.median(r[4] for r in rows[1:]):.2f}% (the entry's hstu_train_flops "
        f"over its step time)")
    return rows


PROFILED = ["TrainerArgs.profile = True", "TrainerArgs.profile_step_start = 9",
            "TrainerArgs.profile_step_end = 9"]


def report_profiled_step(tag, module, rows, layers):
    """The entry's own profile of step 10 (PROFILED), by kind and kernel;
    K1-K3 must have launched once a layer in it."""
    counts = profile_report(module.LAST_PROFILE,
                            f"{tag} profile of the entry's step 10 (its own torch.profiler)",
                            rows[9][2], top=8, groups=STEP_GROUPS, split=ATTN_KERNELS)
    if counts != {"K1": layers, "K2": layers, "K3": layers}:
        raise SystemExit(f"{tag}: the profiled step ran {counts} attention kernels")


def phase_entry_ranking(tmp):
    """(a) The ranking entry on configs/ranking_kuairand_bench.gin at full
    width: 6 steps, a checkpoint and an eval at steps 3 and 6 (and the
    entry's own eval at the end), a profiled step 5;
    then the step-3 checkpoint loaded into a fresh state gives the step-3
    eval AUC bit for bit, and steps 4-6 again as bare train steps on the
    entry's own batches, with the entry's losses."""
    import itertools

    from recsys_examples_torch.dynamicemb.hashtable import lookup
    from recsys_examples_torch.models.ranking_gr import RankingGR
    from recsys_examples_torch.modules.config import RankingConfig
    from recsys_examples_torch.training import pretrain_gr_ranking as rank
    from recsys_examples_torch.training.checkpoint import load_checkpoint
    from recsys_examples_torch.training.train_state import make_optimizer
    from recsys_examples_torch.training.trainer import GRTrainer
    from recsys_examples_torch.utils import gin_config

    tag = "phase14a"
    steps, eval_iters = 6, 2
    ckpt = os.path.join(tmp, "ckpt")
    gin = entry_gin(tmp, "ranking.gin", "ranking_kuairand_bench.gin", [
        f"TrainerArgs.max_train_iters = {steps}", "TrainerArgs.log_interval = 1",
        "TrainerArgs.ckpt_save_interval = 3", "TrainerArgs.eval_interval = 3",
        f"TrainerArgs.eval_iters = {eval_iters}", f'TrainerArgs.ckpt_dir = "{ckpt}"',
        "TrainerArgs.profile = True", "TrainerArgs.profile_step_start = 4",
        "TrainerArgs.profile_step_end = 4"])
    n_hist = len(rank.EVAL_AUC_HISTORY)
    torch.cuda.reset_peak_memory_stats()
    state, launches, entry_log, seconds = run_entry(rank.main, gin)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"{tag} config: ranking_kuairand_bench.gin (8 layers, hidden 1024, 4 x 256, bf16, "
        f"batch 32, history 2048, 128 candidates, item table 4194304 x 1024 over a 50M "
        f"vocabulary); main() took {seconds:.1f} s, peak memory {peak_gib:.1f} GiB")
    rows = log_entry_steps(tag, entry_log, steps)
    check_launches(tag, launches, 8, steps, 3 * eval_iters)    # evals at 3, 6, the end
    prof_counts = profile_report(
        rank.LAST_PROFILE, f"{tag} profile of the entry's step 5 (its own torch.profiler)",
        rows[4][2], top=12, groups=STEP_GROUPS, split=ATTN_KERNELS)
    if prof_counts != {"K1": 8, "K2": 8, "K3": 8}:
        raise SystemExit(f"{tag}: the profiled step ran {prof_counts} attention kernels")
    history = rank.EVAL_AUC_HISTORY[n_hist:]
    if len(history) != 3:
        raise SystemExit(f"{tag}: expected evals at steps 3 and 6 and at the end, "
                         f"got {history}")
    inserted = int(state.sparse["item"].table.inserted[0])
    del state
    torch.cuda.empty_cache()

    # a fresh state from the step-3 checkpoint: its eval AUC is step 3's
    ds, net, opt, demb, tpa, rank_args, targs = (gin_config.make(n) for n in (
        "DatasetArgs", "NetworkArgs", "OptimizerArgs", "DynamicEmbeddingArgs",
        "TensorModelParallelArgs", "RankingArgs", "TrainerArgs"))
    sparse = rank.build_sparse_tables(ds, net, demb, "cuda")
    model = RankingGR(rank.build_hstu_config(net, 1), RankingConfig(
        (), prediction_head_arch=tuple(rank_args.prediction_head_arch),
        num_tasks=rank_args.num_tasks), device="cuda")
    trainer = GRTrainer(model, make_optimizer(
        opt.learning_rate, opt.optimizer_str, opt.adam_beta1, opt.adam_beta2, opt.adam_eps,
        opt.weight_decay), sparse)
    fresh = trainer.init(torch.Generator(device="cuda").manual_seed(SEED + 1))
    path = os.path.join(ckpt, "iter_0000003")
    t0 = time.perf_counter()
    fresh = load_checkpoint(path, fresh, {n: t.table for n, t in sparse.items()})
    load_s = time.perf_counter() - t0
    dumped = np.load(os.path.join(path, "dynamicemb_module", "item.npz"))
    table = fresh.sparse["item"].table
    slots, found = lookup(table, torch.from_numpy(dumped["keys"]).cuda())
    rows_equal = bool(found.all()) and torch.equal(
        table.values[slots], torch.from_numpy(dumped["values"]).cuda())
    size_mb = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path)
                  for f in fs) / 2**20
    auc = rank.run_eval(trainer, fresh, ds, targs, rank_args, iters=eval_iters)
    log(f"{tag} checkpoint iter_0000003: {len(dumped['keys'])} table rows "
        f"({size_mb:.0f} MiB on disk), loaded in {load_s:.2f} s, every key returns its "
        f"row: {rows_equal}; eval AUC at step 3 {history[0].tolist()}, after the load "
        f"{auc.tolist()}, final {history[2].tolist()}")
    if not rows_equal or not np.array_equal(auc, history[0]) or fresh.step != 3:
        raise SystemExit(f"{tag}: the checkpoint round trip is not exact")

    # steps 4-6 again from the loaded state, as bare train steps on batches
    # already on the card (phase 9a's loop): the entry's overhead by
    # difference. The entry's stream: its batch 0 went to init, batch i to step i
    batches = [b.to("cuda") for b in itertools.islice(rank.batch_iterator(ds, targs), 4,
                                                      steps + 1)]
    bare_ms, bare_loss = [], []
    for b in batches:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fresh, m = trainer.train_step(fresh, b)
        end.record()
        torch.cuda.synchronize()
        bare_ms.append(start.elapsed_time(end))
        bare_loss.append(m["loss"].item())
    entry_ms, entry_loss = [r[2] for r in rows[3:]], [r[1] for r in rows[3:]]
    log(f"{tag} steps 4-6: entry step_ms {entry_ms} (step 5 under the profiler), bare "
        f"train_step ms {[round(x, 2) for x in bare_ms]}; losses entry {entry_loss}, bare "
        f"{bare_loss}")
    # the entry logs 5 decimals (rounding <= 5e-6); the atomics of steps 4
    # and 5's backward may move the later losses by a few ulps
    if len(bare_loss) != 3 or any(abs(b - e) > 1e-5 for b, e in zip(bare_loss, entry_loss)):
        raise SystemExit(f"{tag}: the bare steps did not reproduce the entry's losses")
    tokens = [int(np.asarray(b.features['item'].lengths.cpu()).sum()) for b in batches]
    del fresh, trainer, model, sparse, batches
    torch.cuda.empty_cache()
    return dict(launches=launches, step_ms=statistics.median(r[2] for r in rows[1:]),
                losses=[r[1] for r in rows],
                mfu=statistics.median(r[4] for r in rows[1:]), peak_gib=peak_gib,
                bare_ms=bare_ms, entry_ms=entry_ms, tokens=tokens, inserted=inserted,
                auc=history[0].tolist())


def phase_entry_remat():
    """(b) Phase 14a's model at 2 layers with hidden_dropout 0.1: two steps
    with recompute_layer on and off, from the same params and generator
    seed, under deterministic algorithms (atomics in index_add_ would
    otherwise reorder sums between the runs). Losses and params equal bit
    for bit."""
    import dataclasses

    from recsys_examples_torch.data.hstu_batch import random_hstu_batch
    from recsys_examples_torch.models.ranking_gr import RankingGR
    from recsys_examples_torch.modules.config import RankingConfig
    from recsys_examples_torch.training import pretrain_gr_ranking as rank
    from recsys_examples_torch.training.train_state import make_optimizer
    from recsys_examples_torch.training.trainer import GRTrainer
    from recsys_examples_torch.utils import gin_config

    tag = "phase14b"
    gin_config.clear_config()
    gin_config.parse_config_file(str(CONFIGS / "ranking_kuairand_bench.gin"))
    ds, net, demb = (gin_config.make(n) for n in (
        "DatasetArgs", "NetworkArgs", "DynamicEmbeddingArgs"))
    host = [random_hstu_batch(seed=s, batch_size=ds.batch_size,
                              max_history_len=ds.max_history_len,
                              item_vocab=ds.item_vocab_size,
                              max_num_candidates=ds.max_num_candidates) for s in range(2)]
    runs = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for remat in (False, True):
            cfg = rank.build_hstu_config(dataclasses.replace(
                net, num_layers=2, hidden_dropout=0.1, recompute_layer=remat), 1)
            model = RankingGR(cfg, RankingConfig((), prediction_head_arch=(512, 1)),
                              device="cuda")
            trainer = GRTrainer(model, make_optimizer(1e-3, "adam"),
                                rank.build_sparse_tables(ds, net, demb, "cuda"))
            state = trainer.init(torch.Generator(device="cuda").manual_seed(SEED))
            gen = torch.Generator(device="cuda").manual_seed(SEED)
            torch.cuda.reset_peak_memory_stats()
            losses = []
            for b in host:
                state, m = trainer.train_step(state, b, gen)
                losses.append(m["loss"])
            torch.cuda.synchronize()
            runs[remat] = (torch.stack(losses), {k: v.clone() for k, v in
                                                 state.model.state_dict().items()},
                           torch.cuda.max_memory_allocated() / 2**30)
            del state, trainer, model
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    (l0, p0, m0), (l1, p1, m1) = runs[False], runs[True]
    same = torch.equal(l0, l1) and all(torch.equal(p0[k], p1[k]) for k in p0)
    log(f"{tag} 2 layers, dropout 0.1, two steps: losses without recompute "
        f"{l0.tolist()}, with {l1.tolist()}; params equal bit for bit: {same}; peak memory "
        f"{m0:.1f} GiB without, {m1:.1f} GiB with recompute")
    if not same or not torch.isfinite(l0).all():
        raise SystemExit(f"{tag}: recompute_layer with dropout changed the step")


def write_ml1m_ratings(path, seed=SEED):
    """A synthetic ratings.dat in MovieLens-1M's format and size: 6,040
    users with at least 20 ratings each, 3,706 rated movies (ids within
    1..3952), ratings 1-5 at ML-1M's frequencies, about 1M rows."""
    rng = np.random.default_rng(seed)
    counts = np.maximum(20, rng.lognormal(np.log(96), 1.0, 6040)).astype(np.int64)
    counts = np.minimum(counts * 1_000_209 // counts.sum() + 1, 2314)
    movies = np.sort(rng.choice(np.arange(1, 3953), 3706, replace=False))
    pop = 1.0 / np.arange(1, 3707) ** 0.8
    items = movies[rng.choice(3706, int(counts.sum()), p=pop / pop.sum())]
    users = np.repeat(np.arange(1, 6041), counts)
    ratings = rng.choice(np.arange(1, 6), len(users), p=[0.056, 0.108, 0.261, 0.349, 0.226])
    ts = 956703932 + rng.integers(0, 10 ** 8, len(users))
    rows = np.stack([users, items, ratings, ts], 1)
    with open(path, "w") as f:     # one formatting pass: np.savetxt takes ~3 s here
        f.write(("%d::%d::%d::%d\n" * len(rows)) % tuple(rows.ravel().tolist()))
    return len(users), len(np.unique(items))


def phase_entry_movielens(tmp):
    """(c) The file-backed ranking path at configs/ranking_movielens_1m.gin's
    widths over a synthetic ratings.dat: preprocess, then main() through
    SequenceDataset, the native packer and PrefetchIterator, 12 steps and
    an eval over the whole holdout; then K1-K3 against their plain versions
    at the shape and mask of the entry's first attention call."""
    from recsys_examples_torch.data import sequence_dataset as sd
    from recsys_examples_torch.training import pretrain_gr_ranking as rank
    from recsys_examples_torch.utils import native

    tag = "phase14c"
    ratings = os.path.join(tmp, "ratings.dat")
    t0 = time.perf_counter()
    n_rows, n_items = write_ml1m_ratings(ratings)
    t1 = time.perf_counter()
    npz = os.path.join(tmp, "ml1m_seq.npz")
    data = sd.preprocess_movielens(ratings, npz)
    t2 = time.perf_counter()
    lib = native.batch_assembler_lib()
    if lib is None:
        raise SystemExit(f"{tag}: the native packer did not build: {native.BUILD_ERRORS}")
    steps, users = 12, len(data["user_ids"])
    gin = entry_gin(tmp, "ml_ranking.gin", "ranking_movielens_1m.gin", [
        f'DatasetArgs.dataset_path = "{npz}"', f"TrainerArgs.max_train_iters = {steps}",
        "TrainerArgs.log_interval = 1", "TrainerArgs.eval_interval = 0",
        "TrainerArgs.eval_iters = 0", *PROFILED])
    sd._assemble_native.calls = 0
    with FirstAttentionCall() as first:
        state, launches, entry_log, seconds = run_entry(rank.main, gin)
    packed = sd._assemble_native.calls
    eval_batches = users // 128
    log(f"{tag} ratings.dat: {n_rows} rows, {n_items} movies, written in {t1 - t0:.1f} s; "
        f"preprocess_movielens {t2 - t1:.1f} s -> {users} users, "
        f"{len(data['item_ids'])} events; main() {seconds:.1f} s; the native packer "
        f"assembled {packed} batches")
    rows = log_entry_steps(tag, entry_log, steps)
    check_launches(tag, launches, 4, steps, eval_batches)
    report_profiled_step(tag, rank, rows, 4)
    auc = rank.LAST_EVAL_AUC
    log(f"{tag} eval AUC over the holdout ({eval_batches} batches): {auc.tolist()}")
    if packed < steps + 1 + eval_batches or not np.isfinite(auc).all():
        raise SystemExit(f"{tag}: the native packer was not used, or the AUC is not finite")
    del state
    torch.cuda.empty_cache()
    check = check_main_path_attention(tag, first.call, 4, 64)
    return dict(launches=launches, npz=npz, auc=auc.tolist(), errs=check["errs"])


def phase_entry_retrieval(tmp, npz):
    """(d) The retrieval entry at configs/retrieval_movielens_1m.gin's widths
    over (c)'s file: 12 steps and an eval over the whole holdout; then K1-K3
    against their plain versions at the entry's first attention call."""
    from recsys_examples_torch.training import pretrain_gr_retrieval as ret

    tag = "phase14d"
    steps = 12
    gin = entry_gin(tmp, "ml_retrieval.gin", "retrieval_movielens_1m.gin", [
        f'DatasetArgs.dataset_path = "{npz}"', f"TrainerArgs.max_train_iters = {steps}",
        "TrainerArgs.log_interval = 1", "TrainerArgs.eval_interval = 0", *PROFILED])
    torch.cuda.reset_peak_memory_stats()
    with FirstAttentionCall() as first:
        state, launches, entry_log, seconds = run_entry(ret.main, gin)
    users = len(np.load(npz)["user_ids"])
    log(f"{tag} main() {seconds:.1f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    rows = log_entry_steps(tag, entry_log, steps)
    check_launches(tag, launches, 4, steps, users // 128)
    report_profiled_step(tag, ret, rows, 4)
    metrics = ret.LAST_EVAL
    log(f"{tag} eval over the holdout: " + ", ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
    if list(metrics) != ["HR@10", "NDCG@10", "MRR"] or not all(
            np.isfinite(v) and 0.0 <= v <= 1.0 for v in metrics.values()):
        raise SystemExit(f"{tag}: retrieval metrics not finite in [0, 1]: {metrics}")
    del state
    torch.cuda.empty_cache()
    check = check_main_path_attention(tag, first.call, 4, 64)
    return dict(launches=launches, metrics=metrics, errs=check["errs"])


def phase_entries():
    """Phase 14: the gin-driven training entries on the card."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_entries_")
    t0 = time.perf_counter()
    try:
        res = {"ranking": phase_entry_ranking(tmp)}
        phase_entry_remat()
        res["movielens"] = phase_entry_movielens(tmp)
        res["retrieval"] = phase_entry_retrieval(tmp, res["movielens"]["npz"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase14 took {time.perf_counter() - t0:.1f} s")
    return res


# ---------------------------------------------------------------- phase 18
def phase_mesh_collectives():
    """(a) Every collective forward and backward at world size 1 over NCCL:
    each is the identity there (its backward too, grad_scale scales), and
    the table's exchange (all_to_all_single with its splits) returns the
    rows a local lookup returns."""
    from recsys_examples_torch.dynamicemb.sharded_collection import ShardedDynamicEmbedding
    from recsys_examples_torch.parallel import collective_ops as co
    from recsys_examples_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1, 1, "cuda")
    g = mesh.group("data")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
    x = torch.randn(37, 24, generator=gen, device="cuda")
    cot = torch.randn(37, 24, generator=gen, device="cuda")
    cases = {
        "gather_along_first_dim": (lambda t: co.gather_along_first_dim(t, g), 1.0),
        "gather_along_first_dim(replicated)": (
            lambda t: co.gather_along_first_dim(t, g, replicated_output=True), 1.0),
        "gather_along_last_dim": (lambda t: co.gather_along_last_dim(t, g), 1.0),
        "split_along_first_dim": (lambda t: co.split_along_first_dim(t, g), 1.0),
        "reduce_scatter_first_dim": (lambda t: co.reduce_scatter_first_dim(t, g), 1.0),
        "all_reduce": (lambda t: co.all_reduce(t, g), 1.0),
        "copy_to_group": (lambda t: co.copy_to_group(t, g), 1.0),
        "grad_scale": (lambda t: co.grad_scale(t, 0.5), 0.5),
        "jagged_allgather": (lambda t: co.jagged_allgather(
            t, torch.tensor([20, 17], device="cuda"), g)[0], 1.0),
    }
    for name, (fn, scale) in cases.items():
        leaf = x.clone().requires_grad_()
        out = fn(leaf)
        (out * cot).sum().backward()
        torch.cuda.synchronize()
        if not (torch.equal(out, x) and torch.equal(leaf.grad, cot * scale)):
            raise SystemExit(f"phase18a: {name} is not the identity at world size 1")
    table = dyn_table(capacity=1 << 16).table
    sharded = ShardedDynamicEmbedding(table, mesh, device="cuda")
    local = ShardedDynamicEmbedding(table, None, device="cuda")
    ids = zipf_ids(np.random.default_rng(SEED + 18), 40_000).cuda()
    st_m, st_l = sharded.init_state(), local.init_state()
    _, emb_m, res = sharded.forward(st_m, ids)
    _, emb_l, res_l = local.forward(st_l, ids)
    if not torch.equal(emb_m, emb_l):
        raise SystemExit("phase18a: the exchange's train rows differ from the local lookup's")
    sharded.backward(st_m, res, emb_m)
    local.backward(st_l, res_l, emb_l)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        _, emb_m, res = sharded.forward(st_m, ids, train=False)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) / 3 * 1e3
    t0 = time.perf_counter()
    for _ in range(3):
        _, emb_l, _ = local.forward(st_l, ids, train=False)
    torch.cuda.synchronize()
    local_ms = (time.perf_counter() - t0) / 3 * 1e3
    # after a row optimizer step: the token grads' index_add_ sums in any order
    err = (emb_m - emb_l).abs().max().item()
    if err > 1e-5 * emb_l.abs().max().item() or int(res.num_overflow.sum()) != 0:
        raise SystemExit(f"phase18a: the exchange's rows differ from the local lookup's "
                         f"after a step by {err:.3e}")
    log(f"phase18a {len(cases)} collectives forward and backward on NCCL at world size 1: "
        f"identity (grad_scale scales); the table exchange at 40,000 ids "
        f"({int(res.send_splits.sum())} unique): train rows equal the local lookup's bit "
        f"for bit, eval rows after a step within {err:.2e}; eval "
        f"lookup {fwd_ms:.2f} ms through all_to_all_single vs {local_ms:.2f} ms local "
        f"(host clock, mean of 3)")
    del st_m, st_l, sharded, local
    torch.cuda.empty_cache()
    return dict(exchange_ms=fwd_ms, local_ms=local_ms)


def phase_mesh_entry(ranking, tmp):
    """(b) Phase 14a's config through the ranking entry on the (1, 1) mesh
    for 4 steps, the launches per step, and K1-K3 at the first attention
    call; (c) K1-K3 at a TP 2 rank's shape on the first data half."""
    from recsys_examples_torch.ops import hstu_attention as ha
    from recsys_examples_torch.training import pretrain_gr_ranking as rank
    from recsys_examples_torch.training.trainer import GRTrainer

    tag, steps = "phase18b", 4
    gin = entry_gin(tmp, "mesh.gin", "ranking_kuairand_bench.gin", [
        f"TrainerArgs.max_train_iters = {steps}", "TrainerArgs.log_interval = 1",
        "TrainerArgs.eval_interval = 0", "TrainerArgs.eval_iters = 1"])
    counters = (ha.hstu_attn_fwd_cuda, ha.hstu_attn_bwd_dq_cuda, ha.hstu_attn_bwd_dkv_cuda)
    per_step, step = [], GRTrainer.train_step

    def counted(self, *a, **k):
        before = [c.launches for c in counters]
        out = step(self, *a, **k)
        per_step.append([c.launches - b for c, b in zip(counters, before)])
        if self.mesh is None or self.mesh.shape != {"data": 1, "model": 1}:
            raise SystemExit(f"{tag}: the entry did not train on the (1, 1) mesh")
        return out

    GRTrainer.train_step = counted
    try:
        with FirstAttentionCall() as first:
            state, launches, entry_log, seconds = run_entry(rank.main, gin)
    finally:
        GRTrainer.train_step = step
    rows = log_entry_steps(tag, entry_log, steps)
    losses = [r[1] for r in rows]
    log(f"{tag} the ranking entry on the (data 1, model 1) mesh over NCCL: main() took "
        f"{seconds:.1f} s; losses {losses}, phase 14a's first {steps}: "
        f"{ranking['losses'][:steps]}; K1/K2/K3 launches per step {per_step}")
    if any(abs(a - b) > 1e-5 for a, b in zip(losses, ranking["losses"][:steps])):
        raise SystemExit(f"{tag}: the mesh path's losses differ from phase 14a's")
    check_launches(tag, launches, 8, steps, 1)
    if any(p != [8, 8, 8] for p in per_step):
        raise SystemExit(f"{tag}: the attention kernels did not carry every layer")
    del state
    torch.cuda.empty_cache()
    check = check_main_path_attention(tag, first.call, 4, 256)
    c = first.call
    half = c["lengths"][:len(c["lengths"]) // 2]
    i32 = lambda v: None if v is None else v[:len(half)]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
    tp2 = check_jagged_case("tp2_rank", gen, half, 2, 256, c["max_seqlen"], c["mask"],
                            i32(c["ctx"]), i32(c["tgt"]), phase="phase18c",
                            scaling_seqlen=c["scaling_seqlen"])
    log(f"phase18c K1-K3 at a TP 2 rank's shape (2 x 256 heads, B {len(half)}, T "
        f"{sum(half)}): max_abs_err {tp2['errs']}")
    return dict(launches=launches, per_step=per_step, losses=losses,
                errs={t: max(check["errs"][t], tp2["errs"][t]) for t in check["errs"]})


def phase_mesh(ranking):
    """Phase 18: the mesh path at world size 1 over NCCL; the process group
    is destroyed before it returns."""
    import tempfile

    import torch.distributed as dist

    from recsys_examples_torch.parallel.mesh import init_distributed

    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    init_distributed("cuda", dist.FileStore(os.path.join(tmp, "store"), 1), 0, 1)
    try:
        if dist.get_backend() != "nccl":
            raise SystemExit(f"phase18: a CUDA device got {dist.get_backend()}")
        res = phase_mesh_collectives()
        res.update(phase_mesh_entry(ranking, tmp))
    finally:
        dist.destroy_process_group()
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    return res


# ---------------------------------------------------------------- phase 19
def phase_export():
    """Phase 19: the ranking export at phase 3's full width. (a) the
    `torch.export` program of the gather path against the eager gather path
    (and, for the record, the paged K6 path); (b) the AOTInductor package:
    its build seconds, load, and call against (a), timed beside the eager
    gather path; (c) the C++ runner: build, dry run, and a real run whose
    logits' sum and max match (b) at the same inputs."""
    import shutil
    import tempfile

    from recsys_examples_torch.dynamicemb.exportable_tables import inference_lookup
    from recsys_examples_torch.inference import export as ex
    from recsys_examples_torch.inference.inference_ranking_gr import (
        InferenceDenseModule, InferenceRankingGR)
    from recsys_examples_torch.inference.kvcache import (
        KVCacheConfig, gather_kvcache, lookup_kvcache)
    from recsys_examples_torch.modules.config import HSTUConfig

    cfg = HSTUConfig()
    B, hist, cand, chunk = 8, 2048, 128, 512
    maxp = (hist + cand + 127) // 128 + 1
    kv_cfg = KVCacheConfig(
        num_layers=cfg.num_layers, num_heads=cfg.num_attention_heads,
        head_dim=cfg.kv_channels, page_size=128, num_pages=B * maxp * 2,
        max_users=B * 4, max_pages_per_user=maxp, dtype=cfg.dtype)
    table, _ = build_table(512, 128, cfg.hidden_size, 32768, SEED + 1)
    dense = InferenceDenseModule(cfg, (512, 1)).init_weights(torch.Generator().manual_seed(SEED))
    runner = InferenceRankingGR(cfg, kv_cfg, dense, table, device="cuda")
    runner.init_cache()
    rng = np.random.default_rng(SEED + 19)
    users = np.arange(1, B + 1, dtype=np.int64)
    seq = rng.integers(1, 32768, size=(B, hist + cand)).astype(np.int64)
    for lo in range(0, hist, chunk):       # the history into the cache
        runner.forward_with_kvcache(users, seq, np.full((B,), lo + chunk, np.int32), None, chunk)
    kv = runner.kv_state
    slots, cached = lookup_kvcache(kv, torch.from_numpy(users).cuda())
    ck, cv, clen = gather_kvcache(kv, kv_cfg, slots, hist)
    clen = torch.minimum(clen, cached).to(torch.int32)
    emb = inference_lookup(table, torch.from_numpy(seq[:, hist:]).cuda().reshape(-1))
    emb = emb.reshape(B, cand, -1).to(cfg.dtype)
    nl = torch.full((B,), cand, dtype=torch.int32, device="cuda")
    nc = nl.clone()
    scaling = kv_cfg.max_cached_len
    inputs = (emb, ck, cv, clen, nl, nc)
    if clen.tolist() != [hist] * B:
        raise SystemExit(f"phase19: cached lengths {clen.tolist()}, expected {hist}")
    eager = lambda: runner.module(*inputs, scaling)
    with torch.no_grad():
        ref = eager()[0].float()
        page_table = kv.user_pages[slots]
        paged = runner.module(emb, None, None, clen, nl, nc, scaling,
                              paged=(kv.k_pages, kv.v_pages, page_table.contiguous()))[0].float()
    scale = ref.abs().max().item()
    tol = 2e-2 * scale + 1e-3
    log(f"phase19 config: {cfg.num_layers} layers, hidden {cfg.hidden_size}, "
        f"{cfg.num_attention_heads}x{cfg.kv_channels}, bf16; B {B}, max_new {cand}, "
        f"max_cached {hist}; the paged K6 path against the eager gather path (for the "
        f"record): max_abs_err={(paged - ref).abs().max().item():.4e} max|ref|={scale:.4e}")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_export_")
    entry_log = EntryLog()
    try:
        t0 = time.perf_counter()
        ex.export_ranking_dense(runner, B, cand, hist, tmp)
        export_s = time.perf_counter() - t0
        aoti_s = [float(m[1]) for m in (re.search(r"AOTInductor package .* built in (\S+) s", ln)
                                        for ln in entry_log.lines) if m]
        loaded = ex.ExportedRankingDense(tmp)
        got = loaded(*inputs)[0].float()
        err = (got - ref).abs().max().item()
        log(f"phase19a export_ranking_dense {export_s:.1f} s in all (torch.export, the "
            f"artifacts and the AOTInductor build of {aoti_s} s); {len(loaded.params)} "
            f"param inputs; the loaded program against the eager gather path: "
            f"max_abs_err={err:.4e} tol={tol:.4e} (2e-2*max|ref|+1e-3)")
        if not (within(err, scale) and torch.isfinite(got).all()):
            raise SystemExit("phase19a: the exported program disagrees with the eager path")
        if len(aoti_s) != 1:
            raise SystemExit("phase19b: the export built no AOTInductor package on the card")

        t0 = time.perf_counter()
        pkg = torch._inductor.aoti_load_package(os.path.join(tmp, ex.AOTI_PACKAGE))
        load_s = time.perf_counter() - t0
        aoti = lambda: pkg(*loaded.params, *inputs)
        with torch.no_grad():
            out = aoti()
            a_logits = out[0].float()
        a_err = (a_logits - got).abs().max().item()
        with torch.no_grad():
            aoti_ms = median_time_ms(aoti, 10)
            eager_ms = median_time_ms(eager, 10)
        log(f"phase19b AOTInductor package: built in {aoti_s[0]:.1f} s, loaded in "
            f"{load_s:.2f} s; its logits against 19a: max_abs_err={a_err:.4e} tol={tol:.4e}; "
            f"aoti_ms={aoti_ms:.3f} eager_gather_ms={eager_ms:.3f} (CUDA events, median of "
            f"3 x 10 calls)")
        if not (within(a_err, scale) and torch.isfinite(a_logits).all()):
            raise SystemExit("phase19b: the AOTInductor package disagrees with the program")

        t0 = time.perf_counter()
        binary = ex.build_aoti_replay()
        build_s = time.perf_counter() - t0
        spec = os.path.join(tmp, "replay_spec.txt")
        n_spec = sum(1 for ln in open(spec) if ln.startswith("input "))
        dry = subprocess.run([str(binary), "--spec", spec, "--dry-run"], capture_output=True,
                             text=True, timeout=120)
        dry_out = json.loads(dry.stdout.strip().splitlines()[-1]) if dry.returncode == 0 else {}
        log(f"phase19c aoti_replay built in {build_s:.1f} s ({binary.name}); dry run "
            f"{dry.stdout.strip()} (spec lists {n_spec} inputs) {dry.stderr.strip()[-300:]}")
        if dry_out.get("inputs") != n_spec or n_spec != len(loaded.params) + 6:
            raise SystemExit("phase19c: the C++ dry run does not read the spec's inputs")
        args = [t.detach().cpu() for t in (*loaded.params, *inputs)]
        ex.write_replay_artifacts(tmp, args, values=args, data="full_inputs.bin",
                                  spec="full_spec.txt")
        run = subprocess.run([str(binary), "--package", os.path.join(tmp, ex.AOTI_PACKAGE),
                              "--spec", os.path.join(tmp, "full_spec.txt")],
                             capture_output=True, text=True, timeout=600)
        if run.returncode != 0:
            raise SystemExit(f"phase19c: aoti_replay failed: {run.stderr[-2000:]}")
        cpp = json.loads(run.stdout.strip().splitlines()[-1])
        py = a_logits.double()
        sum_err = abs(cpp["logits_sum"] - py.sum().item())
        max_err = abs(cpp["logits_max"] - py.max().item())
        sum_tol = 1e-3 * py.abs().sum().item()
        log(f"phase19c C++ run: outputs {cpp['outputs']} logits_sum={cpp['logits_sum']:.6f} "
            f"(python {py.sum().item():.6f}, |diff| {sum_err:.3e}, tol {sum_tol:.3e}: 1e-3 x "
            f"sum|logits|) logits_max={cpp['logits_max']:.6f} (python {py.max().item():.6f}, "
            f"|diff| {max_err:.3e}, tol {tol:.3e}) on {cpp['device']} (the package's "
            f"device) median_ms={cpp['median_ms']:.3f} (host "
            f"clock, each call synchronised)")
        if (sum_err > sum_tol or max_err > tol or cpp["outputs"][0] != [B, cand, 1]
                or cpp["device"] != "cuda"):
            raise SystemExit("phase19c: the C++ replay's logits disagree with the package's")
    finally:
        entry_log.close()
        shutil.rmtree(tmp, ignore_errors=True)
    del runner, loaded, pkg
    torch.cuda.empty_cache()
    return dict(export_s=export_s, aoti_s=aoti_s[0], aoti_ms=aoti_ms, eager_ms=eager_ms,
                cpp_ms=cpp["median_ms"], err=err)


# ---------------------------------------------------------------- phase 20
class FirstBeamCall:
    """While active, keeps the inputs of the first beam-decode attention call
    that the decoder makes (`modules.transformer`'s `beam_decode_attn`).
    Adds no launch."""

    def __enter__(self):
        from recsys_examples_torch.modules import transformer

        self.module, self.orig, self.args = transformer, transformer.beam_decode_attn, None

        def spy(*a, sm_scale, backend):
            if self.args is None:
                self.args = (a, sm_scale)
            return self.orig(*a, sm_scale=sm_scale, backend=backend)

        transformer.beam_decode_attn = spy
        return self

    def __exit__(self, *exc):
        self.module.beam_decode_attn = self.orig

    def check(self, tag):
        """K7 on the recorded inputs against its plain version (BEAM_LIMITS,
        row by row), launched twice, equal bit for bit."""
        from recsys_examples_torch.ops import beam_decode_attention as bda

        if self.args is None:
            raise SystemExit(f"{tag}: no beam-decode attention call was recorded")
        a, scale = self.args
        got = bda.beam_decode_attn(*a, sm_scale=scale)
        want = bda.beam_decode_attn_ref(*a, sm_scale=scale)
        err, worst, rel, ok = beam_errors(got, want)
        same = torch.equal(got, bda.beam_decode_attn(*a, sm_scale=scale))
        q, k_ctx = a[0], a[1]
        N = 0 if a[4] is None else a[4].shape[1]
        log(f"{tag} K7 at the path's first call: q={tuple(q.shape)} S={k_ctx.shape[1]} N={N} "
            f"ctx_lens {int(a[3].min())}..{int(a[3].max())} max_abs_err={err:.3e} worst row at "
            f"{worst:.3f} of its tol, worst row rel L2 {rel:.3e} repeat equal {same}")
        if not (ok and same):
            raise SystemExit(f"{tag}: K7 disagrees with its plain version at the path's shape")
        return err


SERVE_LIMITS = {"scores": 1e-1}     # rank-wise final scores, as phase 11's


def sid_context(rng, lo, hi, H=4):
    n = int(rng.integers(lo, hi))
    n -= n % H
    return rng.integers(0, 256, size=(max(n, H),)).astype(np.int32)


def phase_continuous(model):
    """Phase 20a: `ContinuousGRScheduler` at `ServingConfig()`'s defaults over
    a mixed wave of 32 requests in all three context buckets."""
    from recsys_examples_torch.inference.sid_serving import logits_processor as lp
    from recsys_examples_torch.inference.sid_serving.continuous import ContinuousGRScheduler
    from recsys_examples_torch.inference.sid_serving.engine import (
        GRServingEngine, ServingConfig)
    from recsys_examples_torch.inference.sid_serving.item_constraints import TrieConstraint
    from recsys_examples_torch.inference.sid_serving.scheduler import BeamPolicy
    from recsys_examples_torch.ops.beam_decode_attention import beam_decode_attn

    cfg = ServingConfig()
    H = model.config.num_hierarchies
    rng = np.random.default_rng(SEED + 20)
    spans = [(4, 64), (68, 256), (260, 1024)]
    wave = [sid_context(rng, *spans[i % 3]) for i in range(32)]
    eng = GRServingEngine(model, cfg)

    def drive(label, policy=None, k=2, processor=None, top_k=cfg.beam_width, profile=False):
        sched = ContinuousGRScheduler(model, cfg, max_batch=8, beam_policy=policy,
                                      steps_per_dispatch=k, logits_processor=processor)
        per_tick, ticks = [], 0
        beam_decode_attn.launches = 0
        t0 = time.perf_counter()
        rids = [sched.submit(c, top_k=top_k) for c in wave]
        while sched.queue or sched.inflight:
            before = beam_decode_attn.launches
            sched.tick()
            ticks += 1
            per_tick.append(beam_decode_attn.launches - before)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res = [sched.get_result(r) for r in rids]
        st = sched.status()
        lat = np.asarray([r["latency_ms"] for r in res])
        log(f"phase20a {label}: steps_per_dispatch {k}, widths {sched.widths}: {ticks} ticks, "
            f"{32 / wall:.2f} req/s, latency median {np.median(lat):.1f} ms p99 "
            f"{np.percentile(lat, 99):.1f} ms, dispatches {int(st['dispatches'])}, step "
            f"functions {st['compiled']}, pool high water {st['pool_high_water']}, K7 "
            f"launches {sum(per_tick)} (per tick {per_tick})")
        if any(r is None or "error" in r or not r["sids"] for r in res) or \
                st["completed"] != 32 or any(st["pool_leaks"].values()):
            raise SystemExit(f"phase20a {label}: a request was not answered, or a lease leaked")
        for r in res:
            p, s = np.asarray(r["sids"]), np.asarray(r["scores"])
            if p.min() < 0 or p.max() >= 256 or not np.isfinite(s).all() or \
                    (np.diff(s) > 0).any():
                raise SystemExit(f"phase20a {label}: bad paths or scores")
        if profile:
            sched2 = ContinuousGRScheduler(model, cfg, max_batch=8, steps_per_dispatch=k)
            for c in wave[:8]:
                sched2.submit(c, top_k=top_k)
            sched2.tick()                       # admits the first groups
            profile_call(sched2.tick, f"phase20a profile of one decode tick "
                         f"({len(sched2.inflight)} requests in flight)", top=8, groups={
                             "K7": ("beam_wgmma_kernel", "scalar::kernel"),
                             "GEMM": ("gemm", "nvjet", "cutlass", "xmma"),
                             "gather/scatter": ("index", "scatter", "gather"),
                             "sort": ("sort", "radix")})
            sched2.run_until_empty()
        return res, dict(ticks=ticks, req_s=32 / wall, median_ms=float(np.median(lat)),
                         p99_ms=float(np.percentile(lat, 99)), launches=sum(per_tick),
                         high_water=st["pool_high_water"], per_tick=per_tick)

    def against_engine(label, res, scale=1.0):
        """Each request's beams against `GRServingEngine.generate` on its
        context (the sound engine): rank-wise score difference and beams
        whose path differs while their score is clear of its neighbours'."""
        worst, clear = 0.0, 0
        for c, r in zip(wave, res):
            p, s = eng.generate([c])
            got = (torch.tensor(r["sids"])[None], torch.tensor(r["scores"])[None])
            want = (torch.from_numpy(p.astype(np.int64)), torch.from_numpy(s))
            d = compare_beams(got, want, SERVE_LIMITS["scores"])
            worst, clear = max(worst, d[0]), clear + d[3]
        log(f"phase20a {label} against GRServingEngine.generate per request: score diff max "
            f"{worst:.3e} (limit {SERVE_LIMITS['scores']:g}), {clear} beams differ clear of "
            f"their neighbours")
        return worst, clear

    # K7 at the path's first decode shapes, and its launches
    with FirstBeamCall() as first:
        res1, m1 = drive("fixed width", k=1, profile=True)
    err = first.check("phase20a")
    res2, m2 = drive("fixed width", k=2)
    for label, res in (("k=1", res1), ("k=2", res2)):
        worst, clear = against_engine(label, res)
        if worst >= SERVE_LIMITS["scores"] or clear:
            raise SystemExit(f"phase20a {label}: the scheduler disagrees with the engine")
    # a faulted control: the scheduler's K7 with scores 10% too large
    res_c, _ = traced_attention(lambda: drive("control, K7 sm_scale x 1.1", k=2)[0], 0,
                                scale=1.1)
    worst, clear = against_engine("the control", res_c)
    if worst < SERVE_LIMITS["scores"] and not clear:
        raise SystemExit("phase20a: the faulted control passes the comparison")
    # the scheduled widths, the score margin, and the trie constraint with the margin
    drive("scheduled", BeamPolicy(kind="scheduled", width=64, schedule=(64, 64, 32, 16)), k=1)
    margin = drive("score margin 2.0", BeamPolicy(kind="score_margin", width=64, margin=2.0))[0]
    if any(max(r["scores"]) - min(r["scores"]) > 2.0 + 1e-4 for r in margin):
        raise SystemExit("phase20a: a beam outside the score margin")
    catalog = np.unique(rng.integers(0, 256, size=(20000, H)).astype(np.int32), axis=0)
    trie = TrieConstraint(catalog, 256)

    def mask(step, paths):
        node = torch.zeros(paths.shape[:2], dtype=torch.int64, device=paths.device)
        for s in range(step):
            node = trie.advance(node, paths[:, :, s], s)
        return trie.mask_logits(torch.zeros(paths.shape[:2] + (256,), device=paths.device),
                                node, step)

    trie_res = drive("trie + score margin 3.0", BeamPolicy(kind="score_margin", width=64,
                                                           margin=3.0), k=2,
                     processor=lp.make_chain(constraint_mask_fn=mask))[0]
    allowed = {tuple(r) for r in catalog.tolist()}
    if any(tuple(sid) not in allowed for r in trie_res for sid in r["sids"]):
        raise SystemExit("phase20a: a path outside the trie's catalog")
    return dict(err=err, fixed_k1=m1, fixed_k2=m2, wave=wave)


def phase_http(model, wave):
    """Phase 20b: /generate over HTTP (aiohttp's test server on a local port)
    for 8 requests, when aiohttp imports."""
    try:
        from aiohttp.test_utils import TestClient, TestServer
    except ImportError as e:
        log(f"phase20b /generate over HTTP: not run, aiohttp does not import here ({e})")
        return False
    from recsys_examples_torch.inference.sid_serving.continuous import ContinuousGRScheduler
    from recsys_examples_torch.inference.sid_serving.engine import ServingConfig
    from recsys_examples_torch.inference.sid_serving.http import create_app

    sched = ContinuousGRScheduler(model, ServingConfig(), max_batch=8)

    async def drive():
        async with TestClient(TestServer(create_app(sched))) as client:
            t0 = time.perf_counter()
            outs = await asyncio.gather(*(
                client.post("/generate", json={"input_ids": c.tolist(),
                                               "sampling_params": {"top_k": 10}})
                for c in wave[:8]))
            bodies = [(r.status, await r.json()) for r in outs]
            wall = time.perf_counter() - t0
            m = await (await client.get("/metrics")).json()
            return bodies, m, wall

    bodies, m, wall = asyncio.run(drive())
    ok = all(s == 200 and len(b["sids"]) == 10 and np.isfinite(b["scores"]).all()
             for s, b in bodies)
    log(f"phase20b /generate over HTTP: ran, aiohttp imports; 8 requests in {wall:.2f} s, "
        f"statuses {[s for s, _ in bodies]}, completed {m['counters'].get('completed')}, "
        f"dispatches {m['counters'].get('dispatches')}")
    if not ok or m["counters"].get("completed") != 8:
        raise SystemExit("phase20b: a /generate request failed")
    return True


def sid_entry(tmp, tag, gin_lines, eval_batches):
    """`pretrain_sid_gr.main` on a gin file of `gin_lines`: the step median,
    the eval metrics, K7's launches (held against (H - 1) x L a batch of
    each eval) and K7 against its plain version at the eval's first call."""
    from recsys_examples_torch.ops.beam_decode_attention import beam_decode_attn
    from recsys_examples_torch.training import pretrain_sid_gr
    from recsys_examples_torch.utils import gin_config

    path = os.path.join(tmp, f"{tag}.gin")
    with open(path, "w") as f:
        f.write("\n".join(gin_lines) + "\n")
    gin_config.clear_config()
    beam_decode_attn.launches = 0
    t0 = time.perf_counter()
    with FirstBeamCall() as first:
        model = pretrain_sid_gr.main(["--gin-config-file", path])
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = beam_decode_attn.launches
    gin_config.clear_config()
    cfg = model.config
    want = eval_batches * (cfg.num_hierarchies - 1) * cfg.num_layers
    steps = pretrain_sid_gr.LAST_STEP_MS
    ev = pretrain_sid_gr.LAST_EVAL
    log(f"phase20c {tag}: {len(steps)} steps in {seconds:.1f} s, step ms median "
        f"{statistics.median(steps[1:]):.2f} (first {steps[0]:.1f}), eval "
        + ", ".join(f"{k}={v:.4f}" for k, v in ev.items())
        + f"; K7 launches {launches} (expected {want}: {eval_batches} eval batches x "
        f"{cfg.num_hierarchies - 1} steps x {cfg.num_layers} layers)")
    if launches != want or not ev or not all(np.isfinite(v) and 0 <= v <= 1 for v in ev.values()):
        raise SystemExit(f"phase20c {tag}: the eval did not run through K7, or bad metrics")
    err = first.check(f"phase20c {tag}")
    del model
    torch.cuda.empty_cache()
    return dict(step_ms=statistics.median(steps[1:]), launches=launches, eval=dict(ev), err=err)


def phase_sid_entries():
    """Phase 20c: the SID-GR training entry on configs/sid_gr_random.gin as
    shipped, at the serving widths, and on sid_gr_file.gin's settings over a
    synthetic interaction log."""
    import shutil
    import tempfile

    from recsys_examples_torch.data.sid_sequence_dataset import (
        build_rq_sid_mapping, preprocess_interactions)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_sid_")
    res = {}
    try:
        shipped = (CONFIGS / "sid_gr_random.gin").read_text().splitlines()
        res["random"] = sid_entry(tmp, "sid_gr_random", shipped, 4)
        w = SID_WIDTHS
        wide = [f'include "{CONFIGS / "sid_gr_random.gin"}"',
                "SIDTrainerArgs.max_train_iters = 10", "SIDTrainerArgs.log_interval = 5",
                "SIDTrainerArgs.eval_iters = 1", "SIDNetworkArgs.dtype = 'bfloat16'"] + [
            f"SIDNetworkArgs.{k} = {w[k]}" for k in (
                "num_hierarchies", "codebook_size", "hidden_size", "num_layers",
                "num_heads", "head_dim", "ffn_hidden", "beam_width")]
        res["wide"] = sid_entry(tmp, "serving_widths", wide, 1)
        # a synthetic interaction log: 4,000 users, 3,000 items, Zipf item draws
        rng = np.random.default_rng(SEED + 20)
        raw, seq = os.path.join(tmp, "inter.csv"), os.path.join(tmp, "seq.npz")
        with open(raw, "w") as f:
            f.write("user_id,item_id,timestamp\n")
            for u in range(4000):
                n = int(rng.integers(3, 40))
                items = np.minimum(rng.zipf(1.2, n) - 1, 2999)
                for t, it in zip(np.sort(rng.integers(0, 10 ** 6, n)), items):
                    f.write(f"{u},{it},{t}\n")
        t0 = time.perf_counter()
        stats = preprocess_interactions(raw, seq)
        mapping = build_rq_sid_mapping(rng.normal(size=(stats["num_items"], 16)),
                                       [256] * 4, iters=10, seed=0)
        np.save(os.path.join(tmp, "map.npy"), mapping)
        log(f"phase20c file data: {stats['num_users']} users, {stats['num_items']} items, "
            f"{stats['num_interactions']} interactions, preprocess + RQ mapping "
            f"{time.perf_counter() - t0:.1f} s")
        file_lines = [f'include "{CONFIGS / "sid_gr_file.gin"}"',
                      f'SIDDatasetArgs.sequence_path = "{seq}"',
                      f'SIDDatasetArgs.sid_mapping_path = "{os.path.join(tmp, "map.npy")}"',
                      "SIDTrainerArgs.max_train_iters = 100", "SIDTrainerArgs.eval_interval = 50",
                      "SIDTrainerArgs.eval_iters = 8"]
        res["file"] = sid_entry(tmp, "sid_gr_file", file_lines, 3 * 8)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return res


def phase_sid_path():
    """Phase 20: SID-GR's stepwise serving, its HTTP front and its training
    entry on the card."""
    model = sid_model(SEED + 20, beam_width=64)
    res = phase_continuous(model)
    res["http"] = phase_http(model, res.pop("wave"))
    del model
    torch.cuda.empty_cache()
    res["entries"] = phase_sid_entries()
    return res


# ---------------------------------------------------------------- phase 21
class BeamCalls:
    """While active, keeps the inputs of the first and the last beam-decode
    attention call that the Qwen3 decoder makes (`models.qwen3`'s
    `beam_decode_attn`), and can hand the kernel a faulted call instead:
    `fault(args, sm_scale) -> (args, sm_scale)` (one of QWEN3_FAULTS).
    Adds no launch."""

    def __init__(self, fault=None):
        self.fault, self.first, self.last = fault, None, None

    def __enter__(self):
        from recsys_examples_torch.models import qwen3

        self.module, self.orig = qwen3, qwen3.beam_decode_attn

        def spy(*a, sm_scale, **kw):
            if self.first is None:
                self.first = (a, sm_scale)
            self.last = (a, sm_scale)
            if self.fault is not None:
                a, sm_scale = self.fault(a, sm_scale)
            return self.orig(*a, sm_scale=sm_scale, **kw)

        qwen3.beam_decode_attn = spy
        return self

    def __exit__(self, *exc):
        self.module.beam_decode_attn = self.orig

    def check(self, tag):
        """K7 on the first and last recorded inputs against its plain version
        (BEAM_LIMITS, row by row), each launched twice, equal bit for bit."""
        from recsys_examples_torch.ops import beam_decode_attention as bda

        errs = []
        for which, rec in (("first", self.first), ("last", self.last)):
            if rec is None:
                raise SystemExit(f"{tag}: no beam-decode attention call was recorded")
            a, scale = rec
            got = bda.beam_decode_attn(*a, sm_scale=scale)
            want = bda.beam_decode_attn_ref(*a, sm_scale=scale)
            err, worst, rel, ok = beam_errors(got, want)
            same = torch.equal(got, bda.beam_decode_attn(*a, sm_scale=scale))
            q, k_ctx = a[0], a[1]
            log(f"{tag} K7 at the path's {which} call: q={tuple(q.shape)} "
                f"Hkv={k_ctx.shape[2]} S={k_ctx.shape[1]} N={a[4].shape[1]} "
                f"ctx_lens {int(a[3].min())}..{int(a[3].max())} max_abs_err={err:.3e} "
                f"worst row at {worst:.3f} of its tol, worst row rel L2 {rel:.3e} "
                f"repeat equal {same}")
            if not (ok and same):
                raise SystemExit(f"{tag}: K7 disagrees with its plain version at the "
                                 f"path's {which} call")
            errs.append(err)
        return max(errs)


QWEN3_SEED = SEED + 21
QWEN3_STEPS = 4            # benchmark_sid_serving.py --hierarchies 4


# 21b's faulted controls, each a fault that a real bug would make in the
# decode's attention call (q, k_ctx, v_ctx, ctx_lens, k_beam, v_beam, ancestry)
def _fault_scale(a, scale):
    """The softmax scale 10% too large."""
    return a, scale * 1.1


def _fault_identity_ancestry(a, scale):
    """The earlier steps' slots not re-rooted through the parents."""
    anc = a[6]
    ident = torch.arange(anc.shape[2], device=anc.device).expand(anc.shape).contiguous()
    return a[:6] + (ident,), scale


def _fault_no_earlier_steps(a, scale):
    """The beam KV of the earlier decode steps left out: each beam sees the
    context and its own current token only."""
    return a[:4] + tuple(t[:, -1:].contiguous() for t in a[4:7]), scale


QWEN3_FAULTS = {"sm_scale x 1.1": _fault_scale,
                "identity ancestry": _fault_identity_ancestry,
                "earlier beam KV left out": _fault_no_earlier_steps}
# 21b: the cached path's scores (sums of 4 chosen-token log-probs) against
# the teacher-forced prefill of the same paths, at B 2, context bucket 64,
# full depth: the largest difference over the 128 paths, on every draw
# (model seed, context seed) of QWEN3_DRAWS. The path must stay under the
# limit of its dtype on every draw and every faulted control must exceed it
# on every draw. Each limit is the geometric mean of the path's largest and
# the faults' smallest reading on the H100 (bf16: 0.0862 and 0.2383, 1.66x
# room each side; fp32: 3.43e-5 and 0.2521, 86x; PERF.md section 6).
QWEN3_DRAWS = {torch.bfloat16: [(m, c) for m in range(3) for c in range(2)],
               torch.float32: [(0, 0), (0, 1)]}
QWEN3_LIMITS = {torch.bfloat16: 0.143, torch.float32: 3e-3}


def qwen3_model(cfg, seed=QWEN3_SEED, dev="cuda"):
    """A Qwen3Model of `cfg` on `dev` with flax's default init from a seeded
    generator, its params cast to `cfg.dtype` (bf16 as `load_hf_weights`
    gives them)."""
    from recsys_examples_torch.models.qwen3 import Qwen3Model

    model = Qwen3Model(cfg, device=dev).init_weights(torch.Generator(device=dev).manual_seed(seed))
    return model.to(cfg.dtype).eval()


def qwen3_contexts(rng, n, lo, hi, vocab, H=QWEN3_STEPS):
    """benchmark_sid_serving.py's `mk_ctx`: a length in [lo, hi) cut to whole
    items, ids uniform over the vocabulary."""
    out = []
    for _ in range(n):
        m = int(rng.integers(lo, hi))
        m -= m % H
        out.append(rng.integers(0, vocab, size=(max(m, H),)).astype(np.int32))
    return out


def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def empty_cache(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()


def phase_qwen3_path(cfg=None, dev="cuda", iters=5):
    """Phase 21a: `Qwen3ServingEngine.generate` on an offline batch of 8 at
    Qwen3-1.7B's widths, then `GRContinuousScheduler` online, as
    benchmark_sid_serving.py's qwen3 path does at --ctx 1024 --batch 8; a
    profiled generate; the W x V sort; peak memory. 21b's K7 checks ride on
    the offline batch's first generate."""
    import tempfile

    from recsys_examples_torch.inference.sid_serving.engine import (
        Qwen3ServingEngine, ServingConfig)
    from recsys_examples_torch.inference.sid_serving.scheduler import GRContinuousScheduler
    from recsys_examples_torch.models.beam_search import top_k_stable
    from recsys_examples_torch.models.qwen3 import Qwen3Config
    from recsys_examples_torch.ops.beam_decode_attention import beam_decode_attn
    from recsys_examples_torch.utils.observability import profiler_window

    cfg = cfg or Qwen3Config()
    on_card = torch.device(dev).type == "cuda"
    model = qwen3_model(cfg, dev=dev)
    scfg = ServingConfig()
    ctx, batch, W, H = 1024, 8, scfg.beam_width, QWEN3_STEPS
    eng = Qwen3ServingEngine(model, scfg, num_steps=H)
    rng = np.random.default_rng(SEED)
    mk = lambda n: qwen3_contexts(rng, n, ctx // 2, ctx, cfg.vocab_size)
    nparams = sum(p.numel() for p in model.parameters())
    log(f"phase21a config: vocab {cfg.vocab_size}, hidden {cfg.hidden_size}, "
        f"{cfg.num_layers} layers, {cfg.num_heads} q heads / {cfg.num_kv_heads} kv heads "
        f"x {cfg.head_dim}, intermediate {cfg.intermediate_size}, tied embedding "
        f"{cfg.tie_word_embeddings}, {nparams / 1e9:.3f}B params in bf16; beam {W}, "
        f"{H} steps, ctx buckets {scfg.ctx_buckets}, batch buckets {scfg.batch_buckets}")

    # offline: batched generate throughput; the first call is also 21b's K7
    # check at the path's first and last decode call
    ctxs = mk(batch)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    beam_decode_attn.launches = 0
    with BeamCalls() as calls:
        paths, scores = eng.generate(ctxs)
    launches = beam_decode_attn.launches
    expected = cfg.num_layers * (H - 1)
    if paths.shape != (batch, W, H) or not np.isfinite(scores).all():
        raise SystemExit(f"phase21a: bad offline answer {paths.shape}")
    if ((paths < 0) | (paths >= cfg.vocab_size)).any() or (np.diff(scores, axis=1) > 0).any():
        raise SystemExit("phase21a: tokens outside the vocabulary or scores out of order")
    if on_card and launches != expected:
        raise SystemExit(f"phase21a: K7 launched {launches} times in one generate, "
                         f"expected {expected}")
    k7_err = calls.check("phase21b")
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        eng.generate(ctxs)
    dt = (time.perf_counter() - t0) / iters
    peak_gib = torch.cuda.max_memory_allocated() / 2**30 if on_card else float("nan")

    # online: per-request latency through the batch scheduler
    sched = GRContinuousScheduler(eng, max_batch=batch)
    lat = []
    for _ in range(iters):
        rids = [sched.submit(c, top_k=10) for c in mk(batch)]
        sched.run_until_empty()
        for rid in rids:
            r = sched.get_result(rid)
            if r is None or len(r.get("sids", ())) != 10:
                raise SystemExit(f"phase21a: request not answered: {r}")
            lat.append(r["latency_ms"])
    lat = np.asarray(lat)

    # one profiled generate, through the port's profiler window (its chrome
    # trace goes to a temp dir); its scopes are the runtime's named_scope ranges
    sync(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as out_dir:
        with profiler_window(out_dir) as prof:
            t0 = time.perf_counter()
            eng.generate(ctxs)
            sync(dev)
            wall_ms = (time.perf_counter() - t0) * 1e3
    profile_report(prof, "phase21a profile of one offline generate (B 8)", wall_ms, top=12,
                   groups={"K7": ("beam_wgmma",), "sort": ("sort", "radix"),
                           "GEMM": ("gemm", "nvjet", "cutlass", "xmma"),
                           "softmax": ("softmax",)},
                   split={"K7": BEAM_KERNELS})
    events = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type.name == "CUDA" and "#" not in e.key
                  and not getattr(e, "is_user_annotation", False)) / 1e3
    scopes = {}
    for e in events:     # a scope's host range and its device-side annotation
        if e.key.startswith("qwen3/"):
            host, dev_ms = scopes.get(e.key, (0.0, 0.0))
            if e.device_type.name == "CPU":
                host += e.cpu_time_total / 1e3
            else:
                dev_ms += e.device_time_total / 1e3
            scopes[e.key] = (host, dev_ms)
    for name in sorted(scopes):
        log(f"  scope {name}: host range {scopes[name][0]:.2f} ms, device range "
            f"{scopes[name][1]:.2f} ms")
    if on_card and not {"qwen3/prefill", "qwen3/decode_1", f"qwen3/decode_{H - 1}"} <= set(scopes):
        raise SystemExit(f"phase21a: the profile lacks the runtime's scopes: {sorted(scopes)}")

    # the W x V sort of one decode step: `top_k_stable` over B x (W * V)
    x = torch.randn(batch, W * cfg.vocab_size, device=dev)
    sort_ms = cuda_time_ms(lambda: top_k_stable(x, W), 3) if on_card else float("nan")
    del x
    line = {
        "metric": "sid_serving", "backbone": "qwen3", "beam": W, "ctx_bucket": ctx,
        "batch": batch, "offline_batch_ms": round(dt * 1e3, 2),
        "offline_req_per_s": round(batch / dt, 2),
        "online_median_ms": round(float(np.median(lat)), 2),
        "online_p99_ms": round(float(np.percentile(lat, 99)), 2),
        "k7_launches_per_generate": launches,
        "profiled_busy_share": round(busy_ms / wall_ms, 4),
        "wv_sort_ms": round(sort_ms, 3), "peak_gib": round(peak_gib, 2),
        "backend": torch.device(dev).type}
    print(json.dumps(line), flush=True)
    return model, dict(line=line, launches=launches, err=k7_err)


def qwen3_check_draw(model, seed, limit):
    """One draw of 21b: two contexts of 8-63 tokens from `seed`; the cached
    path and each faulted control against the teacher-forced prefill of the
    paths each chose. Returns {name: largest |score - teacher-forced|}."""
    from recsys_examples_torch.inference.sid_serving.qwen3_runtime import (
        qwen3_generate_beam, teacher_forced_logp)

    rng = np.random.default_rng(SEED + 1 + seed)
    ctxs = qwen3_contexts(rng, 2, 8, 64, model.config.vocab_size)
    tokens = np.zeros((2, 64), np.int64)
    lens = np.array([len(c) for c in ctxs])
    for i, c in enumerate(ctxs):
        tokens[i, :len(c)] = c
    res = {}
    for name, fault in (("path", None), *QWEN3_FAULTS.items()):
        with BeamCalls(fault) as calls:
            paths, scores = qwen3_generate_beam(model, tokens, lens, QWEN3_STEPS, 64)
        if calls.first is None:
            raise SystemExit("phase21b: the decode made no beam-decode attention call")
        want = sum(torch.gather(teacher_forced_logp(model, tokens, lens, paths, h), 2,
                                paths[:, :, h:h + 1])[..., 0] for h in range(QWEN3_STEPS))
        diff = (scores - want).abs()
        res[name] = diff.max().item()
        log(f"phase21b {str(model.config.dtype)[6:]} ctx seed {seed} {name}: ctx lens "
            f"{lens.tolist()}, |score - teacher-forced| max {res[name]:.4e} median "
            f"{diff.median().item():.4e} (limit {limit})")
    return res


def phase_qwen3_check(model, dev="cuda"):
    """Phase 21b: the cached path (prefill, then K7 decode steps) against the
    teacher-forced prefill of the paths it chose, at B 2, context bucket 64,
    full depth, on every draw of QWEN3_DRAWS in bf16 (the path's kernel) and
    fp32 (K7's fp32 kernel, where bf16's rounding does not hide a fault);
    every faulted control of QWEN3_FAULTS must break the limit on every draw.
    `model` (bf16) serves the draws of model seed 0."""
    import dataclasses

    out = {}
    for dt, draws in QWEN3_DRAWS.items():
        limit, readings, cur, m = QWEN3_LIMITS[dt], {}, None, None
        for mseed, cseed in draws:
            if cur != mseed:
                m = None
                empty_cache(dev)
                m = (model if mseed == 0 and dt == model.config.dtype else
                     qwen3_model(dataclasses.replace(model.config, dtype=dt),
                                 seed=QWEN3_SEED + mseed, dev=dev))
                cur = mseed
            log(f"phase21b {str(dt)[6:]} draw: model seed {mseed}")
            for name, err in qwen3_check_draw(m, cseed, limit).items():
                readings.setdefault(name, []).append(err)
        m = None
        empty_cache(dev)
        path, faults = max(readings.pop("path")), {k: min(v) for k, v in readings.items()}
        log(f"phase21b {str(dt)[6:]} over {len(draws)} draws: path max {path:.4e}; "
            "faulted controls' min " + ", ".join(f"{k} {v:.4e}" for k, v in faults.items())
            + f"; limit {limit}")
        if not path < limit:
            raise SystemExit(f"phase21b: the cached decode ({dt}) disagrees with the "
                             "teacher-forced prefill")
        for k, v in faults.items():
            if not v > limit:
                raise SystemExit(f"phase21b: the faulted control '{k}' ({dt}) passed "
                                 "the comparison on some draw")
        out[str(dt)[6:]] = dict(path=path, **faults)
    return out


def write_hf_checkpoint(state_dict, path):
    """The port's Qwen3 state_dict as a HuggingFace checkpoint file in the
    safetensors format (bf16, the HF names), written here byte by byte: a
    little-endian u64 header length, a JSON header, the raw tensors."""
    import struct

    header, blobs, off = {}, [], 0
    for name, t in state_dict.items():
        hf = "model." + name + ("" if name.endswith(".weight") else ".weight")
        raw = t.detach().to(torch.bfloat16).contiguous().cpu().view(torch.uint8).numpy().tobytes()
        header[hf] = {"dtype": "BF16", "shape": list(t.shape),
                      "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    h = json.dumps(header).encode()
    h += b" " * (-len(h) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(h)))
        f.write(h)
        for b in blobs:
            f.write(b)
    return off


def phase_qwen3_loader(dev="cuda", cfg=None):
    """Phase 21c: a 2-layer checkpoint at full width written in HF bf16
    layout, read back by `load_hf_weights` (no safetensors package); its
    prefill logits equal those of the same weights built in memory, bit for
    bit."""
    import dataclasses
    import importlib.util
    import tempfile

    from recsys_examples_torch.models.qwen3 import Qwen3Config, Qwen3Model, load_hf_weights

    cfg = cfg or dataclasses.replace(Qwen3Config(), num_layers=2)
    built = qwen3_model(cfg, seed=QWEN3_SEED + 1, dev=dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_qwen3_") as tmp:
        nbytes = write_hf_checkpoint(built.state_dict(), os.path.join(tmp, "model.safetensors"))
        t0 = time.perf_counter()
        sd = load_hf_weights(tmp, cfg)
        load_s = time.perf_counter() - t0
    loaded = Qwen3Model(cfg, device=dev).to(torch.bfloat16).eval()
    loaded.load_state_dict(sd)
    rng = np.random.default_rng(SEED + 2)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(2, 64)), device=dev)
    lens = torch.as_tensor([64, 37], device=dev)
    with torch.no_grad():
        a, akv = built.prefill(tok, lens)
        b, bkv = loaded.prefill(tok, lens)
    same = torch.equal(a, b) and all(torch.equal(x, y) for p, q in zip(akv, bkv)
                                     for x, y in zip(p, q))
    log(f"phase21c HF checkpoint: {cfg.num_layers} layers at vocab {cfg.vocab_size}, hidden "
        f"{cfg.hidden_size}, {nbytes / 2**20:.1f} MiB of bf16, read by load_hf_weights in "
        f"{load_s:.2f} s (installed, though the loader uses neither: safetensors "
        f"{importlib.util.find_spec('safetensors') is not None}, ml_dtypes "
        f"{importlib.util.find_spec('ml_dtypes') is not None}); prefill logits and KV "
        f"equal bit for bit: {same}")
    if not same:
        raise SystemExit("phase21c: the loaded checkpoint's logits differ from the built model's")
    return same


def phase_tools(dev="cuda"):
    """Phase 21d: the port's tools on `dev`, each at a cut size in a temp dir;
    each prints its JSON line, and every backend must be `dev`'s."""
    import tempfile

    kind = torch.device(dev).type
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tools_") as tmp:
        return _run_tools(dev, kind, tmp)


def _run_tools(dev, kind, tmp):
    import contextlib
    import io

    from recsys_examples_torch.tools import (convergence_retrieval, convergence_sid,
                                             convergence_synthetic, http_loadgen,
                                             kernel_parity, serving_soak)

    runs = [
        ("kernel_parity", kernel_parity, ["--out", os.path.join(tmp, "kernel_parity.json")]),
        ("serving_soak", serving_soak, ["--requests", "32"]),
        ("http_loadgen ranking", http_loadgen, ["--inprocess", "ranking", "--requests", "32"]),
        ("http_loadgen sid", http_loadgen, ["--inprocess", "sid", "--requests", "32"]),
        ("convergence_synthetic", convergence_synthetic,
         ["--iters", "4", "--users", "300", "--eval-iters", "2", "--log-every", "2",
          "--workdir", os.path.join(tmp, "syn")]),
        ("convergence_retrieval", convergence_retrieval,
         ["--iters", "4", "--users", "300", "--log-every", "2", "--eval-every", "4",
          "--workdir", os.path.join(tmp, "ret")]),
        ("convergence_sid", convergence_sid,
         ["--iters", "4", "--users", "300", "--items", "100", "--eval-iters", "1",
          "--workdir", os.path.join(tmp, "sid")]),
    ]
    out = {}
    for name, mod, argv in runs:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            mod.main(argv + ["--device", dev])
        lines = [json.loads(ln) for ln in buf.getvalue().splitlines() if ln.startswith("{")]
        for ln in lines:
            log(f"phase21d {name}: {json.dumps(ln)}")
        log(f"phase21d {name} took {time.perf_counter() - t0:.1f} s")
        if not lines or any(ln.get("backend") != kind for ln in lines):
            raise SystemExit(f"phase21d {name}: no JSON line on {kind}")
        out[name] = lines
    if not out["kernel_parity"][0]["all_pass"]:
        raise SystemExit("phase21d kernel_parity: a kernel failed")
    for name in ("http_loadgen ranking", "http_loadgen sid"):
        if out[name][0]["completed"] != 32 or out[name][0]["errors"]:
            raise SystemExit(f"phase21d {name}: not every request was answered")
    return out


def phase_qwen3():
    """Phase 21: Qwen3 SID serving at Qwen3-1.7B's widths through K7, the HF
    weight loader, and the port's tools, on the card."""
    model, res = phase_qwen3_path()
    res["check"] = phase_qwen3_check(model)
    del model
    torch.cuda.empty_cache()
    res["loader"] = phase_qwen3_loader()
    torch.cuda.empty_cache()
    res["tools"] = phase_tools()
    return res


# ---------------------------------------------------------------- phase 22
POINTWISE_T, POINTWISE_D = 32689, 1024    # the hstu_train cell's tokens a step, H * dh


def pointwise_cases(hp, T=POINTWISE_T, D=POINTWISE_D, seed=SEED + 22):
    """{name: case} of the six fused pointwise kernels at [T, D] bf16: the
    learnable input LayerNorm, bias + SiLU over four chunks with the bias,
    and the LayerNorm (no params) times u. A case holds the kernel and plain
    calls, the names of their outputs (None left out), each column sum's
    terms' magnitudes summed (and whether the sum is rounded to bf16), the
    bytes read and written once, and for the input LayerNorm the library's
    call (F.layer_norm's ATen ops, its params in bf16)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bf, eps, e = torch.bfloat16, 1e-5, 2
    aten = torch.ops.aten
    rand = lambda: torch.randn(T, D, generator=gen, device="cuda")
    x, dy, attn, dout = (0.5 + 2 * rand()).to(bf), rand().to(bf), rand().to(bf), rand().to(bf)
    u = torch.nn.functional.silu(rand()).to(bf)
    scale = 1 + 0.3 * torch.randn(D, generator=gen, device="cuda")
    bias = 0.3 * torch.randn(D, generator=gen, device="cuda")
    z = [(2 * rand()).to(bf) for _ in range(4)]
    dz = [rand().to(bf) for _ in range(4)]
    ub = 0.5 * torch.randn(4, D, generator=gen, device="cuda")
    _, m_in, r_in = hp.layer_norm_ref(x, scale, bias, eps, bf)
    _, m_out, r_out = hp.layer_norm_ref(attn, None, None, eps, bf)
    xhat = (x.float() - m_in[:, None]) * r_in[:, None]
    dz_ref, _ = hp.bias_silu_bwd_ref(z, dz, ub)
    s_bf, b_bf = scale.to(bf), bias.to(bf)
    _, lib_mean, lib_rstd = aten.native_layer_norm(x, [D], s_bf, b_bf, eps)
    td, stats = T * D * e, 8 * T
    case = lambda kern, plain, outs, nbytes, sums=None, library=None: dict(
        kern=kern, plain=plain, outs=outs, sums=sums or {}, nbytes=nbytes, library=library)
    return {
        "ln_fwd": case(lambda: hp.layer_norm_cuda(x, scale, bias, eps),
                       lambda: hp.layer_norm_ref(x, scale, bias, eps, bf),
                       ("y", "mean", "rstd"), 2 * td + stats + 8 * D,
                       library=lambda: aten.native_layer_norm(x, [D], s_bf, b_bf, eps)),
        "ln_bwd": case(lambda: hp.layer_norm_bwd_cuda(x, dy, m_in, r_in, scale, bias),
                       lambda: hp.layer_norm_bwd_ref(x, dy, m_in, r_in, scale, bias, bf),
                       ("dx", "dscale", "dbias"), 3 * td + stats + 16 * D,
                       sums={"dscale": ((dy.float() * xhat).abs().sum(0), False),
                             "dbias": (dy.float().abs().sum(0), False)},
                       library=lambda: aten.native_layer_norm_backward(
                           dy, x, [D], lib_mean, lib_rstd, s_bf, b_bf, [True, True, True])),
        "bias_silu_fwd": case(lambda: hp.bias_silu_cuda(z, ub), lambda: hp.bias_silu_ref(z, ub),
                              tuple(f"out{c}" for c in range(4)), 8 * td + 16 * D),
        "bias_silu_bwd": case(lambda: hp.bias_silu_bwd_cuda(z, dz, ub),
                              lambda: hp.bias_silu_bwd_ref(z, dz, ub),
                              tuple(f"dz{c}" for c in range(4)) + ("dbias",),
                              12 * td + 32 * D,
                              sums={"dbias": (torch.stack([d.float().abs().sum(0)
                                                           for d in dz_ref]), True)}),
        "ln_mul_fwd": case(lambda: hp.layer_norm_cuda(attn, None, None, eps, u=u),
                           lambda: hp.layer_norm_ref(attn, None, None, eps, bf, u),
                           ("y", "mean", "rstd"), 3 * td + stats),
        "ln_mul_bwd": case(lambda: hp.layer_norm_bwd_cuda(attn, dout, m_out, r_out, None, None,
                                                          u),
                           lambda: hp.layer_norm_bwd_ref(attn, dout, m_out, r_out, None, None,
                                                         bf, u),
                           ("dattn", "du"), 5 * td + stats),
    }


def _flat(out):
    """The tensors of a pointwise call's result, None left out."""
    items = out if isinstance(out, (list, tuple)) else [out]
    flat = []
    for t in items:
        flat.extend(_flat(t) if isinstance(t, (list, tuple)) else [t])
    return [t for t in flat if t is not None]


# the card tests' tolerance for each row's fp32 statistics
STATS_TOL = {"mean": dict(rtol=1e-5, atol=1e-6), "rstd": dict(rtol=1e-5, atol=0)}


def pointwise_rules():
    """tests/test_torch_hstu_pointwise.py, whose `_bf16_close` and
    `_sum_close` are the pass rules of the pointwise kernels."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "test_torch_hstu_pointwise.py")
    spec = importlib.util.spec_from_file_location("hstu_pointwise_rules", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_pointwise(rules, name, c, got, want):
    """Each output against its own plain value: {output: max abs err}."""
    if len(got) != len(want) or len(got) != len(c["outs"]):
        raise SystemExit(f"phase22 {name}: {len(got)} outputs, plain {len(want)}, "
                         f"expected {len(c['outs'])}")
    errs = {}
    for out, g, w in zip(c["outs"], got, want):
        try:
            if out in c["sums"]:
                terms, round_bf16 = c["sums"][out]
                rules._sum_close(g.float(), w.float(), terms, out, round_bf16=round_bf16)
            elif out in STATS_TOL:
                torch.testing.assert_close(g, w, msg=out, **STATS_TOL[out])
            else:
                rules._bf16_close(g, w, out)
        except AssertionError as exc:
            raise SystemExit(f"phase22 {name}: {exc}")
        errs[out] = (g.float() - w.float()).abs().max().item()
    return errs


def phase_pointwise():
    """22. Each fused pointwise kernel against its plain version at the
    cell's shape, each output on its own under the card tests' rules, then
    its times; then one full-width 8-layer train step's launches."""
    from recsys_examples_torch.ops import hstu_pointwise as hp
    from recsys_examples_torch.training.train_state import make_optimizer
    from recsys_examples_torch.training.trainer import GRTrainer

    rules = pointwise_rules()
    res = {}
    for name, c in pointwise_cases(hp).items():
        errs = check_pointwise(rules, name, c, _flat(c["kern"]()), _flat(c["plain"]()))
        k_ms = median_time_ms(c["kern"], 20)
        d_ms = queued_ms(c["kern"])
        if not np.isfinite(d_ms):
            raise SystemExit(f"phase22 {name}: no device time")
        p_ms = median_time_ms(c["plain"], 3)
        lib_ms = None if c["library"] is None else median_time_ms(c["library"], 20)
        bound_ms, by = bound_of(c["nbytes"], 0)
        res[name] = {"kernel_ms": k_ms, "device_ms": d_ms, "plain_ms": p_ms,
                     "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": by,
                     "err": max(errs.values()), "errs": errs, "share": bound_ms / d_ms}
        log(f"phase22 {name}: kernel {k_ms:.4f} ms, device {d_ms:.4f} ms, bound {bound_ms:.4f} "
            f"ms ({by}; {100 * bound_ms / d_ms:.1f}% of it), plain {p_ms:.3f} ms"
            + ("" if lib_ms is None else f", F.layer_norm {lib_ms:.4f} ms")
            + ", max err " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    torch.cuda.empty_cache()
    model = bench_model(8)
    trainer = GRTrainer(model, make_optimizer(1e-3, "adam"))
    state = trainer.init(torch.Generator(device="cuda").manual_seed(SEED))
    batch = bench_batch(SEED + 22, 32, 4096).to("cuda")
    state, _ = trainer.train_step(state, batch)      # builds and warms
    before = hp.launches()
    state, m = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    res["step_launches"] = hp.launches() - before
    log(f"phase22 full-width step: {res['step_launches']} pointwise launches, "
        f"loss {m['loss'].item():.6f}")
    if res["step_launches"] != 48:
        raise SystemExit(f"phase22: {res['step_launches']} pointwise launches a step, not 48")
    del model, trainer, state
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------- phase 23
MOE_E, MOE_K, MOE_D, MOE_I = 64, 4, 2048, 1536    # LFM2-24B-A2B's expert layer
MOE_T = 2048      # the serving cell's rows: 8 x 256 beams a decode step, 8 x 256 prefill tokens


def moe_weights(gen):
    r = lambda *s, std: (std * torch.randn(*s, generator=gen, device="cuda")).bfloat16()
    return dict(gate=r(MOE_E, MOE_D, std=MOE_D ** -0.5), bias=r(MOE_E, std=0.02),
                w13=r(MOE_E, 2 * MOE_I, MOE_D, std=MOE_D ** -0.5),
                w2=r(MOE_E, MOE_D, MOE_I, std=MOE_I ** -0.5))


def moe_case(gen, w, T, skew=0.0):
    """A router draw over T rows (normed-like bf16 inputs); `skew` adds to
    the first experts' bias, so a few take several row tiles and the last
    get none."""
    from recsys_examples_torch.ops import moe

    x = torch.randn(T, MOE_D, generator=gen, device="cuda").bfloat16()
    bias = w["bias"].float() + skew * torch.linspace(1, -1, MOE_E, device="cuda")
    weights, experts = moe.route(x, w["gate"], bias, MOE_K)
    order, offsets = moe.permute(experts, MOE_E)
    xs = x[order // MOE_K]
    h = moe.grouped_gemm_ref(xs, w["w13"], offsets, "swiglu")
    return dict(xs=xs, h=h, offsets=offsets, order=order,
                scale=weights.reshape(-1)[order].contiguous())


def moe_gemm_calls(w, c):
    """(name, kernel call, plain call, library call or None, bytes, FLOPs) of
    each epilogue on case c."""
    from recsys_examples_torch.ops import moe

    M = c["xs"].shape[0]
    counts = c["offsets"][1:] - c["offsets"][:-1]
    touched = int((counts > 0).sum().item())
    lib = getattr(torch, "_grouped_mm", None)
    ends = c["offsets"][1:].contiguous()
    out = []
    for name, a, wt, kw in (
            ("swiglu", c["xs"], w["w13"], {}),
            ("scatter", c["h"], w["w2"], dict(row_scale=c["scale"], dst_rows=c["order"]))):
        N, K = wt.shape[1], wt.shape[2]
        n_out = N // 2 if name == "swiglu" else N
        nbytes = 2 * touched * N * K + 2 * M * K + 2 * M * n_out + (12 * M if kw else 0)
        out.append((name,
                    lambda a=a, wt=wt, kw=kw, name=name: moe.grouped_gemm(a, wt, c["offsets"],
                                                                          name, **kw),
                    lambda a=a, wt=wt, kw=kw, name=name: moe.grouped_gemm_ref(
                        a, wt, c["offsets"], name, **kw),
                    None if lib is None else
                    (lambda a=a, wt=wt: lib(a, wt.transpose(1, 2), offs=ends,
                                            out_dtype=torch.bfloat16)),
                    nbytes, 2 * M * K * N))
    return out


def phase_moe():
    """23. The grouped expert GEMM against its plain version and timed (each
    epilogue's largest error over the three routing cases); K7 at D 64, GQA
    group 4; LFM2-24B-A2B whole without a host sync in its MoE and conv
    layers, its grouped-GEMM launches counted over one generate."""
    from recsys_examples_torch.ops import moe

    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    w = moe_weights(gen)
    res = {}
    for tag, T, skew in (("t2048", MOE_T, 0.0), ("t256", 256, 0.0), ("skew", 600, 0.6)):
        c = moe_case(gen, w, T, skew)
        counts = (c["offsets"][1:] - c["offsets"][:-1]).tolist()
        for name, kern, plain, lib, nbytes, flops in moe_gemm_calls(w, c):
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ref = want.float().abs().max().item()
            rel = ((got.float() - want.float()).norm() / want.float().norm()).item()
            same = torch.equal(got, kern())
            line = (f"phase23 {tag} {name}: rows {sum(counts)}, experts hit "
                    f"{sum(n > 0 for n in counts)}, most rows {max(counts)}, max_abs_err "
                    f"{err:.3e} (max|ref| {ref:.3e}), rel L2 {rel:.3e}, repeat equal {same}")
            if not (within(err, ref) and rel < 8e-3 and same):
                log(line)
                raise SystemExit(f"phase23 {tag} {name}: kernel disagrees with its plain version")
            if tag == "t2048":
                k_ms = median_time_ms(kern, 20)
                d_ms = queued_ms(kern)
                p_ms = median_time_ms(plain, 3)
                lib_ms = None
                if lib is not None:
                    try:
                        lib_ms = median_time_ms(lib, 20)
                    except Exception as exc:   # noqa: BLE001 - a yardstick only
                        log(f"phase23 torch._grouped_mm refused: {str(exc)[:200]}")
                bound_ms, by = bound_of(nbytes, flops)
                res[name] = dict(kernel_ms=k_ms, device_ms=d_ms, plain_ms=p_ms, library_ms=lib_ms,
                                 bound_ms=bound_ms, bound_by=by, err=err)
                line += (f"; kernel {k_ms:.4f} ms, device {d_ms:.4f} ms, bound {bound_ms:.4f} ms "
                         f"({by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP; "
                         f"{100 * bound_ms / d_ms:.1f}% of it), plain {p_ms:.3f} ms, "
                         f"_grouped_mm {lib_ms if lib_ms is None else round(lib_ms, 4)} ms")
            log(line)
            res[f"err_{name}"] = max(res.get(f"err_{name}", 0.0), err)
        del c
    del w
    torch.cuda.empty_cache()
    # K7 at LFM2's attention widths: 32 query heads over 8 kv heads of 64
    bgen = torch.Generator(device="cuda").manual_seed(SEED + 123)
    lens = [256, 131, 200, 77, 252, 128, 1, 190]
    for N in (0, 1, 2):
        c = beam_case(bgen, 8, 256, 32, 8, 64, 256, N, lens)
        r = check_beam_case(f"lfm2 D64 G4 N{N}", c, timed=N == 2)
        res["k7_err"] = max(res.get("k7_err", 0.0), r["err"])
        if N == 2:
            res["k7_d64"] = {k: v for k, v in r.items() if k != "out"}
    res["sync"] = phase_moe_sync()
    return res


def lfm2_full_width(seed):
    """LFM2-24B-A2B whole (40 layers, 47.6 GB), built on `meta` and given
    bf16 weights drawn as `init_weights` draws them, so that no fp32 copy
    is ever made."""
    from recsys_examples_torch.models import lfm2_moe as lm

    cfg = lm.Lfm2MoeConfig()
    model = lm.Lfm2MoeModel(cfg, device="meta")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    weights = {}
    for name, p in model.named_parameters():
        if name.endswith("norm"):
            weights[name] = torch.ones(p.shape, dtype=torch.bfloat16, device="cuda")
            continue
        std = (0.1 if name.endswith("expert_bias") else cfg.hidden_size ** -0.5
               if name == "embed_tokens.weight" else p.shape[-1] ** -0.5)
        weights[name] = torch.randn(p.shape, generator=gen, device="cuda",
                                    dtype=torch.bfloat16).mul_(std)
    model.load_state_dict(weights, strict=True, assign=True)
    return cfg, model.eval()


def phase_moe_sync():
    """LFM2-24B-A2B whole through `qwen3_generate_beam` at the serving
    cell's batch and beam: every MoE layer's and conv decode's call under
    sync debug mode "error"; the grouped-GEMM launches of one generate
    counted (38 MoE layers x 2 epilogues x 4 passes)."""
    from recsys_examples_torch.inference.sid_serving.qwen3_runtime import qwen3_generate_beam
    from recsys_examples_torch.models import lfm2_moe as lm
    from recsys_examples_torch.ops import moe
    from recsys_examples_torch.ops.prefill_attention import prefill_attn

    cfg, model = lfm2_full_width(SEED + 223)

    def strict(fn):
        def call(*a, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return call

    rng = np.random.default_rng(SEED + 23)
    lens = rng.integers(128, 253, 8)
    tokens = np.zeros((8, 256), np.int64)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(0, cfg.vocab_size, n)
    qwen3_generate_beam(model, tokens, lens, 4, 256)   # builds and warms
    torch.cuda.synchronize()
    fwd, dec = lm.Lfm2SparseMoe.forward, lm.Lfm2ShortConv.decode
    lm.Lfm2SparseMoe.forward, lm.Lfm2ShortConv.decode = strict(fwd), strict(dec)
    before, q1_before = moe.grouped_gemm.launches, prefill_attn.launches
    try:
        paths, scores = qwen3_generate_beam(model, tokens, lens, 4, 256)
        torch.cuda.synchronize()
    finally:
        lm.Lfm2SparseMoe.forward, lm.Lfm2ShortConv.decode = fwd, dec
    launches = moe.grouped_gemm.launches - before
    q1 = prefill_attn.launches - q1_before
    ok = bool(torch.isfinite(scores).all().item())
    want = 2 * 4 * (cfg.num_layers - cfg.num_dense_layers)
    attn_layers = sum(t == "full_attention" for t in cfg.layer_types)
    log(f"phase23 sync: a whole LFM2-24B-A2B generate (B 8, W 256, 4 steps) ran its MoE and "
        f"conv decode calls under sync debug mode error; {launches} grouped-GEMM launches "
        f"({cfg.num_layers - cfg.num_dense_layers} MoE layers x 2 x 4 passes = {want}), "
        f"{q1} prefill attention (Q1) launches ({attn_layers} attention layers), "
        f"scores finite {ok}")
    if launches != want or q1 != attn_layers or not ok:
        raise SystemExit(f"phase23 sync: {launches} launches, {q1} Q1 launches, "
                         f"scores finite {ok}")
    del model
    torch.cuda.empty_cache()
    return {"launches": launches, "prefill_launches": q1}


# ---------------------------------------------------------------- phase 24
# The serving cells' prefill attention: B, bucket, context lengths [lo, hi),
# H, Hkv, D (qwen3_sid_ctx1k on Qwen3-1.7B; lfm2_sid_beam256's GQA layers)
PREFILL_CELLS = {"ctx1k": (8, 1024, (512, 1017), 16, 8, 128),
                 "lfm2": (8, 256, (128, 253), 32, 8, 64)}
# the rest: (name, B, N, lengths, H, Hkv, D, dtype); N 1027 is a bucket + 3,
# as the teacher-forced prefill pads
PREFILL_EDGES = (
    ("edges_g2_d128", 6, 1027, (1, 127, 128, 129, 1027, 700), 16, 8, 128, torch.bfloat16),
    ("edges_g4_d64", 5, 300, (1, 127, 128, 129, 300), 32, 8, 64, torch.bfloat16),
    ("padded_d96", 3, 200, (200, 0, 129), 4, 2, 96, torch.bfloat16),
    ("fp32_g2_d128", 3, 300, (300, 129, 1), 4, 2, 128, torch.float32),
    ("fp32_g4_d64", 2, 130, (130, 33), 8, 2, 64, torch.float32),
)
# Q1 against its own arithmetic in bf16: the worst batch row's relative L2
# (tests/test_torch_prefill_attention.py TILED_REL_L2)
PREFILL_TILED_REL_L2 = 1e-3


def prefill_case(gen, B, N, lengths, H, Hkv, D, dtype=torch.bfloat16):
    r = lambda *sh: torch.randn(*sh, generator=gen, device="cuda").to(dtype)
    return dict(q=r(B, N, H, D), k=r(B, N, Hkv, D), v=r(B, N, Hkv, D),
                lengths=torch.tensor(lengths, dtype=torch.int64, device="cuda"))


def prefill_work(c):
    """Bytes (q, k and v of the valid rows read once, the whole output
    written once, the lengths) and FLOPs (two products of 2 D a valid causal
    pair) of one call."""
    B, N, H, D = c["q"].shape
    Hkv = c["k"].shape[2]
    esz = c["q"].element_size()
    lens = c["lengths"].clamp(0, N).tolist()
    nbytes = sum(lens) * (H + 2 * Hkv) * D * esz + B * N * H * D * esz + B * 8
    return nbytes, 4 * sum(n * (n + 1) // 2 for n in lens) * H * D


def prefill_errors(got, want, lengths):
    """Over each batch row's valid rows: the largest error, the worst batch
    row's error over its tolerance (BEAM_LIMITS of the dtype: rtol x max|ref
    row| + atol), the worst batch row's relative L2, the share of values
    that differ at all, and whether the two-ulp rule of
    tests/test_torch_hstu_pointwise.py (`_bf16_close`) holds."""
    lim = BEAM_LIMITS[want.dtype]
    err = worst = rel = 0.0
    differ = total = 0
    two_ulp = True
    for b, n in enumerate(lengths.clamp(0, got.shape[1]).tolist()):
        if n == 0:
            continue
        g, w = got[b, :n].float(), want[b, :n].float()
        d = (g - w).abs()
        e, top = d.max().item(), w.abs().max().item()
        err = max(err, e)
        worst = max(worst, e / (lim["rtol"] * top + lim["atol"]))
        rel = max(rel, (d.norm() / w.norm().clamp_min(1e-30)).item())
        differ += int((d > 0).sum().item())
        total += d.numel()
        two_ulp &= not bool((d > w.abs() * 2.0 ** -6 + 1e-5 * top).any().item())
    share = differ / max(total, 1)
    return dict(err=err, worst=worst, rel=rel, share=share, bf16_close=two_ulp and share <= 0.01,
                ok=worst < 1 and rel < lim["rel_l2"])


def check_prefill_case(name, c, timed=False, iters=20):
    """Q1 on one case against its plain version (BEAM_LIMITS) and its tiled
    arithmetic (the same, and PREFILL_TILED_REL_L2), on valid rows; rows at
    or past each length exactly zero; two launches equal bit for bit. With `timed`, its event and queued (device) ms, the valid
    pairs' bound, the plain version's ms and causal SDPA's."""
    import torch.nn.functional as F

    from recsys_examples_torch.ops import prefill_attention as pa

    args = (c["q"], c["k"], c["v"], c["lengths"])
    B, N, H, D = c["q"].shape
    scale = D ** -0.5
    run = lambda: pa.prefill_attn(*args, scale)
    got = run()
    torch.cuda.synchronize()
    same = torch.equal(got, run())
    dense = prefill_errors(got, pa.prefill_attn_ref(*args, scale), c["lengths"])
    tiled = prefill_errors(got, pa.prefill_attn_tiled_ref(*args, scale), c["lengths"])
    pad = torch.arange(N, device="cuda")[None, :] >= c["lengths"][:, None]
    zero = bool((got[pad] == 0).all().item()) and bool(torch.isfinite(got).all().item())
    fmt = lambda e: (f"max_abs_err={e['err']:.3e} worst row at {e['worst']:.3f} of its tol, "
                     f"rel L2 {e['rel']:.3e}, {100 * e['share']:.2f}% of values differ, "
                     f"two-ulp rule {e['bf16_close']}")
    line = (f"phase24 {name}: q={tuple(c['q'].shape)} Hkv={c['k'].shape[2]} "
            f"{str(c['q'].dtype)[6:]} lengths {c['lengths'].tolist()[:8]}; against the plain "
            f"version {fmt(dense)}; against its tiled arithmetic {fmt(tiled)}; padded rows "
            f"zero {zero}, repeat equal {same}")
    res = dict(err=dense["err"], dense=dense, tiled=tiled)
    if timed:
        kernel_ms = median_time_ms(run, iters)
        dev_ms = queued_ms(run)
        plain_ms = cuda_time_ms(lambda: pa.prefill_attn_ref(*args, scale), 3)
        qt, kt, vt = (c[x].transpose(1, 2) for x in ("q", "k", "v"))
        lib_ms = None
        try:   # a yardstick only: the port never calls it
            lib_ms = median_time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, scale=scale, enable_gqa=H != c["k"].shape[2]), iters)
        except Exception as exc:   # noqa: BLE001
            log(f"phase24 {name}: F.scaled_dot_product_attention refused: {str(exc)[:200]}")
        nbytes, flops = prefill_work(c)
        bound_ms, by = bound_of(nbytes, flops)
        res.update(kernel_ms=kernel_ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=bound_ms, bound_by=by)
        line += (f"; kernel {kernel_ms:.4f} ms, device {dev_ms:.4f} ms, bound {bound_ms:.4f} ms "
                 f"({by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP; "
                 f"{100 * bound_ms / dev_ms:.1f}% of it), plain {plain_ms:.3f} ms, causal SDPA "
                 f"{lib_ms if lib_ms is None else round(lib_ms, 4)} ms")
    log(line)
    own = tiled["rel"] < (PREFILL_TILED_REL_L2 if c["q"].dtype == torch.bfloat16 else 1e-5)
    if not (dense["ok"] and tiled["ok"] and own and same and zero):
        raise SystemExit(f"phase24 {name}: Q1 disagrees with its plain version or its tiled "
                         "arithmetic, a padded row is not zero, or two launches differ")
    return res


def phase_prefill_model():
    """Qwen3-1.7B whole at the ctx1k shape: its prefill profiled by kind,
    then one `qwen3_generate_beam` (beam 64, 4 steps) under sync debug mode
    "error", its Q1 launches on the wrapper's counter and on the tracer's."""
    from recsys_examples_torch.inference.sid_serving.qwen3_runtime import qwen3_generate_beam
    from recsys_examples_torch.models.qwen3 import Qwen3Config
    from recsys_examples_torch.ops import prefill_attention as pa
    from recsys_examples_torch.utils import observability

    cfg = Qwen3Config()
    model = qwen3_model(cfg)
    rng = np.random.default_rng(SEED + 24)
    ctxs = qwen3_contexts(rng, 8, 512, 1017, cfg.vocab_size)
    tokens = np.zeros((8, 1024), np.int64)
    for i, ctx in enumerate(ctxs):
        tokens[i, :len(ctx)] = ctx
    tok = torch.as_tensor(tokens, device="cuda")
    lens = torch.as_tensor([len(ctx) for ctx in ctxs], device="cuda")
    qwen3_generate_beam(model, tok, lens, QWEN3_STEPS, 64)   # builds and warms
    torch.cuda.synchronize()
    split = profile_call(lambda: model.prefill(tok, lens),
                         f"phase24 Qwen3-1.7B prefill, B 8, bucket 1024, contexts "
                         f"{int(lens.min())}-{int(lens.max())}", top=8,
                         groups={"Q1": ("prefill_wgmma",),
                                 "GEMM": ("gemm", "nvjet", "cutlass", "xmma", "cublas"),
                                 "elementwise": ("elementwise", "vectorized"),
                                 "reduce": ("reduce",)},
                         split={"Q1": "prefill_wgmma_kernel"})
    before = pa.prefill_attn.launches
    with observability.tracing():
        observability.reset()
        torch.cuda.set_sync_debug_mode("error")
        try:
            paths, scores = qwen3_generate_beam(model, tok, lens, QWEN3_STEPS, 64)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        counted = observability.snapshot()["counters"].get(pa.COUNTER, 0)
    launches = pa.prefill_attn.launches - before
    ok = bool(torch.isfinite(scores).all().item())
    log(f"phase24 a whole Qwen3-1.7B generate (B 8, bucket 1024, beam 64, {QWEN3_STEPS} "
        f"steps) under sync debug mode error: Q1 launched {launches} times ({pa.COUNTER} "
        f"{counted}; {cfg.num_layers} layers), {split.get('Q1')} in the profiled prefill, "
        f"scores finite {ok}")
    if not (launches == counted == split.get("Q1") == cfg.num_layers and ok):
        raise SystemExit("phase24: Q1 did not launch once a layer in the generate")
    del model
    torch.cuda.empty_cache()
    return launches


def phase_prefill():
    """24. Q1 against its plain version and its tiled arithmetic at the
    serving cells' shapes (timed) and at the edges; then Qwen3-1.7B whole."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 24)
    rng = np.random.default_rng(SEED + 124)
    res, err = {}, 0.0
    for name, (B, N, (lo, hi), H, Hkv, D) in PREFILL_CELLS.items():
        lens = rng.integers(lo, hi, B).tolist()
        res[name] = check_prefill_case(name, prefill_case(gen, B, N, lens, H, Hkv, D),
                                       timed=True)
        err = max(err, res[name]["err"])
    for name, B, N, lens, H, Hkv, D, dt in PREFILL_EDGES:
        c = prefill_case(gen, B, N, lens, H, Hkv, D, dt)
        err = max(err, check_prefill_case(name, c)["err"])
    torch.cuda.empty_cache()
    res.update(err=err, launches=phase_prefill_model())
    return res

def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from recsys_examples_torch.ops import paged_hstu_attention as attn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} numpy {np.__version__} "
        f"device {torch.cuda.get_device_name(0)}")

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"[{name} took {time.perf_counter() - t0:.1f} s]")
        return out

    timed("phase 1", phase_build)
    timed("phase 1b", phase_tile_check)
    t_phases = time.perf_counter()

    res = {"paged": timed("phase 2", phase_kernel, attn)}
    runner, res["serve"] = timed("phase 3", phase_main, attn)
    timed("phase 4", phase_serve, runner, attn)
    del runner
    torch.cuda.empty_cache()
    res["jagged"] = timed("phase 5", phase_jagged)
    res["train"] = timed("phase 6", phase_train)
    timed("phase 7", phase_tables)
    res["rab"] = timed("phase 8", phase_rab)
    launches_9a, res["rab_shape"], host0 = timed("phase 9", phase_full_step)
    res["beam"] = timed("phase 10", phase_beam)
    res["sid"] = timed("phase 11", phase_sid)
    timed("phase 12", phase_sid_serve)
    res["paged_int8"], paged_int8_launches = timed("phase 13a", phase_quant_paged, attn)
    res["fwd_int8"] = timed("phase 13b", phase_quant_fwd, host0)
    res["entries"] = timed("phase 14", phase_entries)
    res["cache"] = timed("phase 15", phase_cache, res["entries"]["ranking"]["step_ms"])
    res["kv_offload"] = timed("phase 16", phase_kv_offload, attn)
    res["repairs"] = timed("phase 17", phase_repairs, attn)
    res["mesh"] = timed("phase 18", phase_mesh, res["entries"]["ranking"])
    res["export"] = timed("phase 19", phase_export)
    res["sid_path"] = timed("phase 20", phase_sid_path)
    res["qwen3"] = timed("phase 21", phase_qwen3)
    res["pointwise"] = timed("phase 22", phase_pointwise)
    res["moe"] = timed("phase 23", phase_moe)
    res["prefill"] = timed("phase 24", phase_prefill)

    warm = res["paged"]["serve_warm"]
    kernels = [{
        "name": "paged_hstu_delta_attention",
        "route": "cuda",
        "source": "recsys_examples_torch/csrc/paged_hstu_attention.cu",
        "replaces": "recsys_examples_tpu/ops/pallas/paged_hstu_attention.py:270",
        "launches": res["serve"]["launches"],     # phase 3's main path (not phase 4's)
        "max_abs_err": max(r["err"] for r in res["paged"].values()),
        "ms": warm["kernel_ms"],
        "device_ms": warm["device_ms"],            # torch.profiler, per launch
        "plain_ms": warm["plain_ms"],
        "bound_ms": warm["bound_ms"],
        "bound_by": warm["bound_by"],
        "library_ms": None,
    }]
    train = res["train"]
    for i, (kk, name, tags, line) in enumerate((
            ("fwd", "hstu_attn_fwd", ("out",), 1092),
            ("dq", "hstu_attn_bwd_dq", ("dq",), 1202),
            ("dkv", "hstu_attn_bwd_dkv", ("dk", "dv"), 1202))):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "recsys_examples_torch/csrc/"
                      + ("hstu_attention_fwd.cu" if kk == "fwd" else "hstu_attention_bwd.cu"),
            "replaces": f"recsys_examples_tpu/ops/pallas/hstu_attention.py:{line}",
            "launches": launches_9a[i],     # bench.py's step, phase 9a
            "entry_launches": res["entries"]["ranking"]["launches"][i],   # phase 14a
            "mesh_launches": res["mesh"]["launches"][i],    # phase 18b, the mesh path
            "max_abs_err": max([train["errs"][t] for t in tags]
                               + [res["mesh"]["errs"][t] for t in tags]
                               + [c["errs"][t] for c in res["jagged"].values() for t in tags]),
            "ms": train["ms"][kk],
            "plain_ms": train["plain_ms"][kk],
            "bound_ms": train["bound"][kk][0],
            "bound_by": train["bound"][kk][1],
            "library_ms": None,
        })
    shape = res["rab_shape"]
    for i, (kk, name, tags) in enumerate((
            ("fwd", "hstu_attn_rab_fwd", ("out",)),
            ("dq", "hstu_attn_rab_bwd_dq", ("dq", "drab")),
            ("dkv", "hstu_attn_rab_bwd_dkv", ("dk", "dv")))):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "recsys_examples_torch/csrc/"
                      + ("hstu_attention_fwd.cu" if kk == "fwd" else "hstu_attention_bwd.cu"),
            "replaces": "recsys_examples_tpu/ops/pallas/hstu_attention.py:1482",
            "launches": shape["launches"][i],   # the step with the bias, phase 9b
            "max_abs_err": max([shape["errs"][t] for t in tags]
                               + [c["errs"][t] for c in res["rab"].values() for t in tags]),
            "ms": shape["ms"][kk],
            "plain_ms": shape["plain_ms"][kk],
            "bound_ms": shape["bound"][kk][0],
            "bound_by": shape["bound"][kk][1],
            "library_ms": None,
        })
    step = res["beam"]["full_n3"]      # the last decode step of phase 11's B 16 call
    kernels.append({
        "name": "beam_decode_attn",
        "route": "cuda",
        "source": "recsys_examples_torch/csrc/beam_decode_attention.cu",
        "replaces": "recsys_examples_tpu/ops/pallas/beam_decode_attention.py:235",
        "launches": res["sid"][16]["launches"],     # one generate_beam_decode, B 16
        # phase 20a's wave of 32 through the stepwise scheduler (steps_per_dispatch
        # 2), and 20c's entry eval at the serving widths
        "serve_launches": res["sid_path"]["fixed_k2"]["launches"],
        "eval_launches": res["sid_path"]["entries"]["wide"]["launches"],
        # phase 21a: one Qwen3ServingEngine.generate at Qwen3-1.7B's widths
        "qwen3_launches": res["qwen3"]["launches"],
        "max_abs_err": max([r["err"] for r in res["beam"].values()]
                           + [res["sid_path"]["err"], res["qwen3"]["err"]]
                           + [e["err"] for e in res["sid_path"]["entries"].values()]),
        "ms": step["kernel_ms"],
        "device_ms": step["device_ms"],             # torch.profiler, per launch
        "plain_ms": step["plain_ms"],
        "bound_ms": step["bound_ms"],
        "bound_by": step["bound_by"],
        "library_ms": None,
    })
    d256 = res["repairs"]                # phase 17's D 256 step
    kernels.append({
        "name": "beam_decode_attn_d256",
        "route": "cuda",
        "source": "recsys_examples_torch/csrc/beam_decode_attention.cu",
        "replaces": "recsys_examples_tpu/ops/pallas/beam_decode_attention.py:235",
        "launches": d256["launches"],               # phase 17's D 256 drive
        "max_abs_err": d256["err"],
        "ms": d256["kernel_ms"],
        "device_ms": d256["device_ms"],
        "plain_ms": d256["plain_ms"],
        "bound_ms": d256["bound_ms"],
        "bound_by": d256["bound_by"],
        "library_ms": None,
    })
    fwd8 = res["fwd_int8"]
    kernels.append({
        "name": "hstu_attn_fwd_int8",
        "route": "cuda",
        "source": "recsys_examples_torch/csrc/hstu_attention_fwd.cu",
        "replaces": "recsys_examples_tpu/ops/pallas/hstu_attention.py:1541",
        "launches": fwd8["launches"],               # the full-width call, phase 13
        "max_abs_err": fwd8["err"],
        "ms": fwd8["kernel_ms"],
        "plain_ms": fwd8["plain_ms"],
        "bound_ms": fwd8["bound_ms"],
        "bound_by": fwd8["bound_by"],
        "library_ms": None,
    })
    paged8 = res["paged_int8"][(3968, 8, False)]
    kernels.append({
        "name": "paged_hstu_delta_attention_int8",
        "route": "cuda",
        "source": "recsys_examples_torch/csrc/paged_hstu_attention.cu",
        "replaces": "recsys_examples_tpu/ops/pallas/paged_hstu_attention.py:270",
        "launches": paged_int8_launches,            # the eight points, phase 13
        "max_abs_err": max(r["err"] for r in res["paged_int8"].values()),
        "ms": paged8["kernel_ms"],
        "device_ms": paged8["device_ms"],           # torch.profiler, per launch
        "plain_ms": paged8["plain_ms"],
        "bound_ms": paged8["bound_ms"],
        "bound_by": paged8["bound_by"],
        "library_ms": None,
    })
    for name, r in res["pointwise"].items():
        if name == "step_launches":
            continue
        kernels.append({
            "name": f"hstu_pointwise_{name}",
            "route": "cuda",
            "source": "recsys_examples_torch/csrc/hstu_layer_pointwise.cu",
            "replaces": None,       # none: XLA fuses this chain on the TPU
            "launches": res["pointwise"]["step_launches"] // 6,   # a full-width step, phase 22
            "max_abs_err": r["err"],
            "errs": r["errs"],      # each output's own
            "ms": r["kernel_ms"],
            "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],      # F.layer_norm, events, input LayerNorm only
        })
    g = res["moe"]
    for name in ("swiglu", "scatter"):
        kernels.append({
            "name": f"moe_grouped_gemm_{name}",
            "route": "cuda",
            "source": "recsys_examples_torch/csrc/moe_grouped_gemm.cu",
            "replaces": None,       # none: the JAX package has no expert layer
            "launches": g["sync"]["launches"] // 2,   # a whole generate, phase 23
            "max_abs_err": g[f"err_{name}"],          # this epilogue's own, three routings
            "ms": g[name]["kernel_ms"],
            "device_ms": g[name]["device_ms"],
            "plain_ms": g[name]["plain_ms"],
            "bound_ms": g[name]["bound_ms"],
            "bound_by": g[name]["bound_by"],
            "library_ms": g[name]["library_ms"],    # torch._grouped_mm, where present
        })
    pre = res["prefill"]
    for dh, cell in ((128, "ctx1k"), (64, "lfm2")):
        r = pre[cell]
        kernels.append({
            "name": f"prefill_attn_d{dh}",
            "route": "cuda",
            "source": "recsys_examples_torch/csrc/prefill_attention.cu",
            "replaces": None,       # none: the JAX package's prefill attention is plain jnp
            # a Qwen3 generate (phase 24); an LFM2 generate (phase 23)
            "launches": pre["launches"] if dh == 128 else res["moe"]["sync"]["prefill_launches"],
            "max_abs_err": pre["err"],
            "ms": r["kernel_ms"],
            "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],     # causal F.scaled_dot_product_attention
        })
    log(f"phases took {time.perf_counter() - t_phases:.1f} s after the build "
        f"({time.perf_counter() - t_start:.1f} s in all)")
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
