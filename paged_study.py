"""Measurements behind the paged attention kernel's design (K6, K6-int8,
`recsys_examples_torch/csrc/paged_hstu_attention.cu`) and the beam-decode
attention's (K7, `csrc/beam_decode_attention.cu`) with the int8 forward's
(K5), on one card. Run from the repo root:

    python3 paged_study.py splits
    python3 paged_study.py variants
    python3 paged_study.py clocks [st1]
    python3 paged_study.py compare PARENT_DIR
    python3 paged_study.py beam
    python3 paged_study.py beam_clocks
    python3 paged_study.py beam_compare PARENT_DIR
    python3 paged_study.py int8_fwd

- splits: the kernel's device time per split count at the serving, decode
  and prefill shapes, bf16 and int8 pages.
- variants: edited copies of the source, built beside the tree's library
  and timed in turns with it (base, variants..., base): the int8 instance
  with three widening warps, the int8 decode instance with one bf16 stage
  (and TMA-fed scales), the consumer with a two-chain score, no instance
  skipping the SiLU pass of padded warps, every instance skipping it. Each
  variant's output is compared with the base's bit for bit.
- clocks: cycle stamps of one widening thread and one consumer thread of
  CTA (0, 0, 0) per chunk of the int8 decode calls (an edited copy that
  records `clock64()`; reading the stamps clears them), optionally on the
  one-bf16-stage variant.
- compare: another checkout (e.g. the parent commit unpacked by
  `git archive`) against this one in turns (other, this, this, other):
  the kernel at the main shapes, and chip_smoke.py's phase 3 with a
  profile of one cold pass.
- beam: K7's variants in turns (base, variants..., base) at phase 10's B
  16 step (= phase 11's last B 16 step) and phase 11's B 1 steps: the base
  (128 rows, two consumers, 64-key chunks), an edited copy with 256 rows a
  CTA (four consumers of 64 rows, 32-key chunks, setmaxnreg 112 / 32), and
  one that issues S of the next context chunk before the softmax step of
  this one (pipelined), and one that runs each tail chunk on the tensor
  cores as a diagonal-masked chunk (diag_tail), and one whose score sums
  the even and the odd k-slices in two chains (twochain, K1's), each with
  its own plan; outputs compared within
  chip_smoke.py's BEAM_LIMITS; then the base's split sweep at B 1.
- beam_clocks: cycle stamps of the producer thread and consumer thread 0
  of the CTA of the longest context at the B 16 and B 1 steps, per chunk
  (an edited copy that records `clock64()`).
- beam_compare: another checkout against this one in turns (other, this,
  this, other): K7 at those shapes (device time; event time over 200
  calls, median of five; the host's time a wrapper call, 200 calls with no
  sync between them, median and least of five), K5 and K1 at the
  full-width training shape.
- int8_fwd: K5 at the full-width training shape in turns with edited
  copies of `csrc/hstu_attention_fwd.cu` (the widening warps skipping the
  widening, a timing-only diagnostic; the consumers in 232 registers and
  the producer's warpgroup in 40; the widening loop unrolled 4 ways) and
  with K1; each variant's output against the base's bit for bit.
The study calls the libraries' C entries itself, with the wrapper's plan or
a split of its own; it changes nothing in the package. Device times come
from torch.profiler (chip_smoke.device_ms), event times from
chip_smoke.median_time_ms. The card's cluster capacity, which the plan
reads, is printed by chip_smoke.py's phase 2.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from recsys_examples_torch.ops import beam_decode_attention as bda
from recsys_examples_torch.ops import paged_hstu_attention as attn
from recsys_examples_torch.utils import cuda_build

ROOT = Path(__file__).resolve().parent
NAME = "paged_hstu_attention"
ORDER = ("q", "k_pages", "v_pages", "page_table", "cached_len", "new_k", "new_v",
         "new_lens", "num_targets")
# (B, S, history, new tokens, targets) at H 4 x 256, pages of 128
SHAPES = {"serve_warm": (8, 128, 2048, 128, 128), "decode_b8": (8, 8, 3968, 8, None),
          "decode_b1": (1, 8, 3968, 8, None), "prefill_512": (8, 512, 1536, 512, None)}


def _entries(lib):
    """The bf16 and int8 launch entries of a loaded library, typed."""
    fb = lib.paged_hstu_delta_attention_launch
    f8 = lib.paged_hstu_delta_attention_int8_launch
    fb.argtypes, f8.argtypes = attn._ARGTYPES, attn._ARGTYPES_INT8   # as the wrapper passes them
    fb.restype = f8.restype = ctypes.c_int
    return fb, f8


def _calls(gen, name):
    """{"bf16", "int8"}: call(lib, splits=None) launches the kernel at one of
    SHAPES through `lib`'s C entry, with the wrapper's plan or `splits` CTAs
    a cluster, and returns its output."""
    B, S, hist, new, tgt = SHAPES[name]
    c = cs.attention_case(gen, B, S, 4, 256, 128, -(-hist // 128), [hist] * B, [new] * B,
                          None if tgt is None else [tgt] * B)
    k8, v8, ks, vs = attn.quantize_kv_pages(c["k_pages"], c["v_pages"])
    H, dh = c["q"].shape[2:]
    P, pg = c["k_pages"].shape[:2]
    maxp = c["page_table"].shape[1]
    scaling = float(hist + S)
    out = torch.empty_like(c["q"])
    ptr = lambda t: None if t is None else t.data_ptr()
    rest = [ptr(c[k]) for k in ORDER[3:]] + [out.data_ptr()]

    def call(int8, lib, splits=None):
        plan = attn.paged_launch_plan(c["q"], k8 if int8 else c["k_pages"], c["page_table"])
        dims = [B, S, H, dh, pg, maxp, P, splits or plan.splits, plan.consumers,
                0.0625, 1.0 / scaling, torch.cuda.current_stream().cuda_stream]
        fb, f8 = _entries(lib)
        if int8:
            err = f8(ptr(c["q"]), k8.data_ptr(), v8.data_ptr(), ks.data_ptr(), vs.data_ptr(),
                     *rest, *dims)
        else:
            err = fb(0, ptr(c["q"]), ptr(c["k_pages"]), ptr(c["v_pages"]), *rest, *dims)
        if err:
            raise SystemExit(f"{name}: launch failed: error {err}")
        return out

    return {"bf16": lambda lib, splits=None: call(False, lib, splits),
            "int8": lambda lib, splits=None: call(True, lib, splits)}


def splits():
    lib = cuda_build.load(NAME)
    gen = torch.Generator(device="cuda").manual_seed(7)
    for name in SHAPES:
        calls = _calls(gen, name)
        for k in (1, 2, 3, 4, 5, 6, 8, 12, 16):
            ms = {kind: cs.device_ms(lambda f=f: f(lib, k), cs.PAGED_KERNELS)
                  for kind, f in calls.items()}
            cs.log(f"splits {name} splits={k}: " + ", ".join(
                f"{kind} device_ms={v:.4f}" for kind, v in ms.items()))


# ---------------------------------------------------------------- edited copies
# Text edits of `csrc/paged_hstu_attention.cu` as it stood when these
# variants were timed; a later kernel need not keep them applying. When one
# no longer does, `variants` or `clocks` stops and names it.
# the int8 decode instance as first built: one bf16 stage, three int8
# stages and TMA-fed scales
ST1 = [("static constexpr int ST = I8 ? (NC == 1 ? 2 : 1) : (NC == 1 ? 3 : 2);",
        "static constexpr int ST = I8 ? 1 : (NC == 1 ? 3 : 2);"),
       ("static constexpr int RS = I8 ? 2 : 0;", "static constexpr int RS = I8 ? (NC == 1 ? 3 : 2) : 0;"),
       ("static constexpr bool TMA_SCALES = I8 && NC == 2;", "static constexpr bool TMA_SCALES = I8;")]
VARIANTS = {
    "wideners3": [("static constexpr int EXTRA = I8 && NC == 1;", "static constexpr int EXTRA = 0;")],
    "st1": ST1,
    "twochain": [
        ("    float sc[32];\n", "    float sc[32], odd[32];\n"),
        ("      sm90::score_chain<DH>(sc, q_s, kt);\n      sm90::wgmma_commit();\n"
         "      sm90::wgmma_wait<0>();\n      sm90::fence_regs(sc);\n",
         "      if constexpr (NC == 1) sm90::score_chain<DH>(sc, odd, q_s, kt);\n"
         "      else sm90::score_chain<DH>(sc, q_s, kt);\n      sm90::wgmma_commit();\n"
         "      sm90::wgmma_wait<0>();\n      sm90::fence_regs(sc);\n"
         "      if constexpr (NC == 1) {\n        sm90::fence_regs(odd);\n"
         "        for (int e = 0; e < 32; ++e) sc[e] += odd[e];\n      }\n")],
    "noskip": [("      silu_chunk<I8, NC == 1>(", "      silu_chunk<I8, false>(")],
    "skip2": [("      silu_chunk<I8, NC == 1>(", "      silu_chunk<I8, true>(")],
}
CLOCKS = [
    ("namespace wg {\n", "namespace wg {\n__device__ long long g_clk[2][64][4];\n"),
    ("    sm90::mbar_wait(&bars->kv.empty[st], ((u / S::ST) & 1) ^ 1);",
     "    const bool rec = blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && w == 0 && u < 64;\n"
     "    if (rec) g_clk[0][u][0] = clock64();\n"
     "    sm90::mbar_wait(&bars->kv.empty[st], ((u / S::ST) & 1) ^ 1);"),
    ("    bars->raw.consumer_wait(u);\n",
     "    bars->raw.consumer_wait(u);\n    if (rec) g_clk[0][u][1] = clock64();\n"),
    ("    if (a.scale_tma) {\n      for (int x = w;",
     "    if (rec) g_clk[0][u][2] = clock64();\n    if (a.scale_tma) {\n      for (int x = w;"),
    ("    if (w == 0) sm90::mbar_arrive(&bars->kv.full[st]);\n",
     "    if (w == 0) sm90::mbar_arrive(&bars->kv.full[st]);\n"
     "    if (rec) g_clk[0][u][3] = clock64();\n"),
    ("      bars->kv.consumer_wait(u);\n",
     "      bars->kv.consumer_wait(u);\n"
     "      const bool rec = blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && t == 0 && u < 64;\n"
     "      if (rec) g_clk[1][u][0] = clock64();\n"),
    ("      sm90::acc_to_a(pa, sc);\n",
     "      sm90::acc_to_a(pa, sc);\n      if (rec) g_clk[1][u][1] = clock64();\n"),
    ("      bars->kv.consumer_release(u);\n",
     "      bars->kv.consumer_release(u);\n      if (rec) g_clk[1][u][2] = clock64();\n"),
    ("#undef PAGED_CAP\n}\n",
     "#undef PAGED_CAP\n}\nextern \"C\" int paged_clocks(long long* d) {\n"
     "  static long long zero[2][64][4];\n"
     "  int e = (int)cudaMemcpyFromSymbol(d, wg::g_clk, sizeof(wg::g_clk));\n"
     "  return e ? e : (int)cudaMemcpyToSymbol(wg::g_clk, zero, sizeof(zero));\n}\n"),
]


def _build(tag, edits, name=NAME):
    """Start nvcc on an edited copy of the source; (process, library path)."""
    var = cuda_build.BUILD_DIR / "var"
    var.mkdir(parents=True, exist_ok=True)
    s = (cuda_build.CSRC_DIR / f"{name}.cu").read_text()
    for old, new in edits:
        if old not in s:
            raise SystemExit(f"{tag}: the source no longer holds {old!r}")
        s = s.replace(old, new)
    src, out = var / f"{name}_{tag}.cu", var / f"lib{name}_{tag}.so"
    src.write_text(s)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    cmd = [nvcc, *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC_DIR), "-o", str(out),
           str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out


def _load(tag, proc_out):
    proc, out = proc_out
    text, _ = proc.communicate()
    spills = [(e, sp) for e, _, sp in cs.ptxas_entries(text) if sp]
    cs.log(f"variant {tag}: nvcc rc={proc.returncode}, spilling instances {spills}")
    if proc.returncode:
        raise SystemExit(text[-3000:])
    return ctypes.CDLL(str(out))


def variants():
    base = cuda_build.load(NAME)
    procs = {tag: _build(tag, e) for tag, e in VARIANTS.items()}
    libs = {"base": base, **{tag: _load(tag, p) for tag, p in procs.items()}}
    gen = torch.Generator(device="cuda").manual_seed(11)
    for name in ("serve_warm", "decode_b8", "decode_b1"):
        for kind, f in _calls(gen, name).items():
            want = f(base).clone()
            same = [tag for tag in VARIANTS if torch.equal(f(libs[tag]), want)]
            res = [f"{tag} {cs.device_ms(lambda lib=libs[tag]: f(lib), cs.PAGED_KERNELS):.4f}"
                   for tag in ["base", *VARIANTS, "base"]]
            cs.log(f"variants {name} {kind} device_ms: " + ", ".join(res)
                   + f"; equal to base bit for bit: {same}")


def clocks(st1=False):
    lib = _load("clocks", _build("clocks", (ST1 if st1 else []) + CLOCKS))
    lib.paged_clocks.argtypes = [ctypes.c_void_p]
    gen = torch.Generator(device="cuda").manual_seed(11)
    for name in ("decode_b8", "decode_b1"):
        f = _calls(gen, name)["int8"]
        for _ in range(3):
            f(lib)
        torch.cuda.synchronize()
        buf = torch.zeros(2 * 64 * 4, dtype=torch.int64)
        if lib.paged_clocks(buf.data_ptr()):
            raise SystemExit("clocks: the copy failed")
        w, k = buf[:256].reshape(64, 4).tolist(), buf[256:].reshape(64, 4).tolist()
        cs.log(f"clocks {name} int8{' st1' if st1 else ''}: cycles from the first stamp; "
               "widener (stage free, int8 landed, widened, arrived) | consumer (got, SiLU "
               "done, released)")
        t0 = w[0][0]
        for u in range(64):
            if not any(w[u]):
                break
            cs.log(f"  chunk {u}: W " + " ".join(f"{x - t0:7d}" for x in w[u]) + " | C "
                   + " ".join(f"{x - t0:7d}" for x in k[u][:3]))


# ---------------------------------------------------------------- parent against change
ONE = r'''
import sys, numpy as np, torch
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, ".")
import chip_smoke as cs
from recsys_examples_torch.ops import beam_decode_attention as bda
from recsys_examples_torch.ops import paged_hstu_attention as attn
tag = sys.argv[1]
def device_ms(fn, iters=20):   # every kernel fn launches is the paged one
    fn(); torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters): fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    n = sum(e.count for e in hits)
    return sum(e.self_device_time_total for e in hits) / 1e3 / n if n else float("nan")
gen = torch.Generator(device="cuda").manual_seed(3)
for name, (B, S, hist, new, tgt) in SHAPES.items():
    c = cs.attention_case(gen, B, S, 4, 256, 128, -(-hist // 128), [hist] * B, [new] * B,
                          None if tgt is None else [tgt] * B)
    args = [c[k] for k in ORDER]
    k8, v8, ks, vs = attn.quantize_kv_pages(c["k_pages"], c["v_pages"])
    a8 = list(args); a8[1], a8[2] = k8, v8
    fb = lambda: attn.paged_hstu_delta_attention(*args, 0.0625, float(hist + S))
    f8 = lambda: attn.paged_hstu_delta_attention(*a8, 0.0625, float(hist + S), k_scales=ks,
                                                 v_scales=vs)
    r = {"bf16": fb} if S > 8 else {"bf16": fb, "int8": f8}
    cs.log(f"[{tag}] {name}: " + ", ".join(
        f"{k} device_ms={device_ms(f):.4f} event_ms={cs.median_time_ms(f, 20):.4f}"
        for k, f in r.items()))
runner, res = cs.phase_main(attn)
B, hist, cand, chunk = 8, 2048, 128, 512
S = hist + cand
rng = np.random.default_rng(cs.SEED)
users = np.arange(1, B + 1, dtype=np.int64)
seq = rng.integers(1, 32768, size=(B, S)).astype(np.int64)
lens = np.full((B,), S, np.int32); ncand = np.full((B,), cand, np.int32)
def cold():
    runner.init_cache()
    for lo in range(0, S, chunk):
        runner.forward_with_kvcache(users, seq, np.minimum(lens, lo + chunk),
                                    ncand if lo + chunk >= S else None, chunk)
cold(); torch.cuda.synchronize()
cs.profile_call(cold, f"[{tag}] profile of one cold pass", top=3)
'''


def compare(other):
    trees = [("other", Path(other).resolve()), ("this", ROOT), ("this", ROOT),
             ("other", Path(other).resolve())]
    head = f"SHAPES = {SHAPES!r}\nORDER = {ORDER!r}\n"
    for i, (tag, tree) in enumerate(trees):
        r = subprocess.run([sys.executable, "-c", head + ONE, f"{tag}{i}"], cwd=tree,
                           capture_output=True, text=True, env={**os.environ, "PYTHONPATH": ""})
        print("\n".join(l for l in r.stdout.splitlines()
                        if l.startswith(("[", "phase3", "  "))), flush=True)
        if r.returncode:
            print(r.stderr[-3000:], flush=True)
            raise SystemExit(f"compare: the run in {tree} failed")


# ---------------------------------------------------------------- K7: two CTA shapes
BEAM = "beam_decode_attention"
# the 256-row CTA: four consumers of 64 rows on 32-key chunks (STAGES =
# 256 / CK = 8), each in 112 registers
ROWS256 = [("constexpr int NC = 2;", "constexpr int NC = 4;"),
           ("constexpr int CK = 64;", "constexpr int CK = 32;")]
# the score in two chains, the even and the odd 16-wide k-slices (K1's)
TWOCHAIN = [("  float sc[CK / 2];\n", "  float sc[CK / 2], sodd[CK / 2];\n"),
            ("    sm90::score_chain<DH, CK>(sc, q_s, kt);\n    sm90::wgmma_commit();\n"
             "    sm90::wgmma_wait<0>();\n    sm90::fence_regs(sc);\n",
             "    sm90::score_chain<DH>(sc, sodd, q_s, kt);\n    sm90::wgmma_commit();\n"
             "    sm90::wgmma_wait<0>();\n    sm90::fence_regs(sc);\n    sm90::fence_regs(sodd);\n"
             "    for (int e = 0; e < CK / 2; ++e) sc[e] += sodd[e];\n")]


def _beam_cases(gen):
    """phase 10's full_n3 (phase 11's last B 16 step) and phase 11's B 1
    steps (N 1, 2, 3), at the SID-GR widths."""
    from recsys_examples_torch.data.sid_batch import random_sid_batch

    W, H, D, S = 200, 8, 128, cs.SID_HISTORY_ITEMS * 4 + 1
    lens = lambda B: (random_sid_batch(cs.SEED, B, cs.SID_HISTORY_ITEMS, 4, 256)
                      .history_lengths + 1).tolist()
    cases = {"b16_n3": cs.beam_case(gen, 16, W, H, H, D, S, 3, lens(16))}
    for n in (1, 2, 3):
        cases[f"b1_n{n}"] = cs.beam_case(gen, 1, W, H, H, D, S, n, lens(1))
    return cases


def _beam_entry(lib):
    fn = lib.beam_decode_attn_launch
    fn.argtypes, fn.restype = bda._ARGTYPES, ctypes.c_int   # as the wrapper passes them
    cap = lib.beam_cluster_capacity
    cap.argtypes, cap.restype = [ctypes.c_int] * 2, ctypes.c_int
    return fn, cap


def _beam_call(fn, c, splits):
    """call() launches the bf16 K7 on case c (N > 0) through the C entry fn,
    with the wrapper's arguments and `splits` CTAs a cluster, and returns
    its output."""
    q, kc, vc, kb, vb = (c[k] for k in ("q", "k_ctx", "v_ctx", "k_beam", "v_beam"))
    B, W, H, D = q.shape
    S, Hkv = kc.shape[1:3]
    lens = c["ctx_lens"].to(torch.int32).contiguous()
    anc = c["ancestry"].to(torch.int32).contiguous()
    out = torch.empty_like(q)

    def call():
        err = fn(0, q.data_ptr(), kc.data_ptr(), vc.data_ptr(), lens.data_ptr(), kb.data_ptr(),
                 vb.data_ptr(), anc.data_ptr(), out.data_ptr(), B, W, H, Hkv, D, S,
                 kb.shape[1], q.stride(0), q.stride(1), kc.stride(0), kc.stride(1),
                 *kb.stride()[:3], D ** -0.5, splits, torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"beam: launch failed: error {err}")
        return out

    return call


PIPELINED = """  const int mine = live ? nc : 0;
  float sn[CK / 2];
  for (int u = 0; u < (mine > 0 ? 1 : 0); ++u) {
    ring->consumer_wait(0);
    sm90::wgmma_fence();
    sm90::score_chain<DH, CK>(sc, q_s, stage(0));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
  }
  for (int u = 0; u < mine; ++u) {
    const int un = u + 1 < mine ? u + 1 : u;
    if (un != u) ring->consumer_wait(un);
    sm90::wgmma_fence();
    sm90::score_chain<DH, CK>(sn, q_s, stage(un));
    sm90::wgmma_commit();
    const int c0 = (T.c_begin + u) * CK;
    if (c0 + CK <= T.ctx_len)
      softmax_step<INTERIOR>(sc, mrow, lrow, corr, 0, t, c);
    else
      softmax_step<EDGE>(sc, mrow, lrow, corr, T.ctx_len - c0, t, c);
    for (int j = 0; j < O::NCH; ++j)
      for (int i = 0; i < O::CH / 2; ++i) o[j][i] *= corr[(i >> 1) & 1];
    sm90::acc_to_a(pa, sc);
    sm90::fence_out<DH>(o);
    sm90::wgmma_fence();
    sm90::pv_chain<DH, CK>(o, pa, stage(u) + KT::BYTES);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sn);
    sm90::fence_out<DH>(o);
    ring->consumer_release(u);
    for (int i = 0; i < CK / 2; ++i) sc[i] = sn[i];
  }
"""


DIAG_TAIL = """  const auto tail = [&](int u, int h) {
    ring->consumer_wait(u);
    const unsigned char* kt = stage(u);
    sm90::wgmma_fence();
    sm90::score_chain<DH, CK>(sc, q_s, kt);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    for (int i = 0; i < CK / 2; ++i)
      sc[i] = sm90::acc_col(t, i) + h * CK == sm90::acc_row(t, i) ? sc[i] * c : NEG;
    for (int x = 0; x < 2; ++x) {
      float mx = row_reduce<true>(sc, x);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(mrow[x], mx);
      corr[x] = ex2(mrow[x] - mn);
      mrow[x] = mn;
    }
    for (int i = 0; i < CK / 2; ++i) sc[i] = sc[i] == NEG ? 0.f : ex2(sc[i] - mrow[(i >> 1) & 1]);
    for (int x = 0; x < 2; ++x) {
      float rs = row_reduce<false>(sc, x);
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      lrow[x] = lrow[x] * corr[x] + rs;
    }
    for (int j = 0; j < O::NCH; ++j)
      for (int i = 0; i < O::CH / 2; ++i) o[j][i] *= corr[(i >> 1) & 1];
    sm90::acc_to_a(pa, sc);
    sm90::fence_out<DH>(o);
    sm90::wgmma_fence();
    sm90::pv_chain<DH, CK>(o, pa, kt + KT::BYTES);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_out<DH>(o);
    ring->consumer_release(u);
  };
"""


def _diag_tail(src):
    """The edit that runs each tail chunk on the tensor cores as a chunk
    whose mask is the diagonal (key j of row h CK + j)."""
    a = src.index("  const auto tail = [&](int u, int h) {")
    b = src.index("  const int mine = live ? nc : 0;")
    return [(src[a:b], DIAG_TAIL)]


def _pipelined(src):
    """The edit that issues S of the next context chunk before the softmax
    step of this one (FlashAttention-3's overlap within a warpgroup)."""
    a = src.index("  const int mine = live ? nc : 0;\n")
    b = src.index("  for (int u = mine; u < nc; ++u) skip(u);")
    return [(src[a:b], PIPELINED)]


def beam():
    base = cuda_build.load(BEAM)
    src = (cuda_build.CSRC_DIR / f"{BEAM}.cu").read_text()
    variants = {"rows256": (ROWS256, 2 * bda.BEAM_CTA_ROWS),
                "pipelined": (_pipelined(src), bda.BEAM_CTA_ROWS),
                "diag_tail": (_diag_tail(src), bda.BEAM_CTA_ROWS),
                "twochain": (TWOCHAIN, bda.BEAM_CTA_ROWS)}
    procs = {tag: _build(tag, e, BEAM) for tag, (e, _) in variants.items()}
    libs = {"base": (base, bda.BEAM_CTA_ROWS),
            **{tag: (_load(tag, procs[tag]), rows) for tag, (_, rows) in variants.items()}}
    gen = torch.Generator(device="cuda").manual_seed(12)
    for name, c in _beam_cases(gen).items():
        args = cs.beam_args(c)
        B, W, H, D = c["q"].shape
        S, Hkv = c["k_ctx"].shape[1:3]
        N = c["k_beam"].shape[1]
        calls, plans = {}, {}
        for tag, (lib, rows) in libs.items():
            fn, cap = _beam_entry(lib)
            plan = bda.beam_split_plan(B, W, H, Hkv, S, N, lambda s, cap=cap: cap(D, s), rows)
            plans[tag] = plan
            calls[tag] = _beam_call(fn, c, plan.splits)
        want = bda.beam_decode_attn_ref(*args, sm_scale=D ** -0.5)
        checks = {tag: cs.beam_errors(f(), want) for tag, f in calls.items()}
        order = ["base", *variants, "base"]
        ms = [cs.device_ms(calls[tag], cs.BEAM_KERNELS) for tag in order]
        cs.log(f"beam {name}: device_ms " + ", ".join(f"{t} {m:.4f}" for t, m in zip(order, ms))
               + "; plans " + ", ".join(f"{t} (splits {p.splits}, tiles {p.tiles})"
                                        for t, p in plans.items())
               + "; against the plain version " + ", ".join(
                   f"{t} err {e[0]:.3e} worst row {e[1]:.3f} of its tol rel L2 {e[2]:.3e} "
                   f"pass {e[3]}" for t, e in checks.items()))
    fn, _ = _beam_entry(base)
    c = _beam_cases(gen)["b1_n3"]
    for k in range(1, 17):
        f = _beam_call(fn, c, k)
        cs.log(f"beam b1_n3 splits={k}: device_ms={cs.device_ms(f, cs.BEAM_KERNELS):.4f}")


REC = "blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0"
BEAM_CLOCKS = [
    ("namespace wg {\n", "namespace wg {\n__device__ long long g_clk[2][64][4];\n"),
    ("      ring->producer_acquire(u, 2 * KT::BYTES);\n",
     "      ring->producer_acquire(u, 2 * KT::BYTES);\n"
     f"      if ({REC} && u < 64) g_clk[0][u][0] = clock64();\n"),
    ("      sm90::mbar_wait(&ring->empty[st], ((u / STAGES) & 1) ^ 1);\n",
     "      sm90::mbar_wait(&ring->empty[st], ((u / STAGES) & 1) ^ 1);\n"
     f"      if ({REC} && pt == 0 && u < 64) g_clk[0][u][1] = clock64();\n"),
    ("      if (pt == 0) sm90::mbar_arrive(&ring->full[(nc + k - 1) % STAGES]);\n",
     "      if (pt == 0) sm90::mbar_arrive(&ring->full[(nc + k - 1) % STAGES]);\n"
     f"      if ({REC} && pt == 0 && nc + k - 1 < 64) g_clk[0][nc + k - 1][2] = clock64();\n"),
    ("    ring->consumer_wait(u);\n    const unsigned char* kt = stage(u);\n",
     "    ring->consumer_wait(u);\n"
     f"    const bool rec = {REC} && threadIdx.x == 0 && u < 64;\n"
     "    if (rec) g_clk[1][u][0] = clock64();\n    const unsigned char* kt = stage(u);\n"),
    ("    sm90::acc_to_a(pa, sc);\n    sm90::fence_out<DH>(o);\n",
     "    sm90::acc_to_a(pa, sc);\n    if (rec) g_clk[1][u][1] = clock64();\n"
     "    sm90::fence_out<DH>(o);\n"),
    ("    sm90::fence_out<DH>(o);\n    ring->consumer_release(u);\n  };\n",
     "    sm90::fence_out<DH>(o);\n    ring->consumer_release(u);\n"
     "    if (rec) g_clk[1][u][2] = clock64();\n  };\n"),
    ("extern \"C\" int beam_cluster_capacity(",
     "extern \"C\" int beam_clocks(long long* d) {\n"
     "  static long long zero[2][64][4];\n"
     "  int e = (int)cudaMemcpyFromSymbol(d, wg::g_clk, sizeof(wg::g_clk));\n"
     "  return e ? e : (int)cudaMemcpyToSymbol(wg::g_clk, zero, sizeof(zero));\n}\n\n"
     "extern \"C\" int beam_cluster_capacity("),
]


def beam_clocks():
    lib = _load("clocks", _build("clocks", BEAM_CLOCKS, BEAM))
    lib.beam_clocks.argtypes = [ctypes.c_void_p]
    fn, cap = _beam_entry(lib)
    gen = torch.Generator(device="cuda").manual_seed(12)
    for name, c in _beam_cases(gen).items():
        if name not in ("b16_n3", "b1_n3"):
            continue
        B, W, H, D = c["q"].shape
        S, Hkv = c["k_ctx"].shape[1:3]
        plan = bda.beam_split_plan(B, W, H, Hkv, S, 3, lambda s: cap(D, s))
        for _ in range(3):
            _beam_call(fn, c, plan.splits)()
        torch.cuda.synchronize()
        buf = torch.zeros(2 * 64 * 4, dtype=torch.int64)
        if lib.beam_clocks(buf.data_ptr()):
            raise SystemExit("beam_clocks: the copy failed")
        pr, co = buf[:256].reshape(64, 4).tolist(), buf[256:].reshape(64, 4).tolist()
        t0 = min(x for x in pr[0][:1] + co[0][:1] if x)
        cs.log(f"beam_clocks {name} (splits {plan.splits}): cycles from the first stamp; use u: "
               "producer (stage acquired, tail: stage free, tail: handed on) | consumer 0 "
               "thread 0 (got the chunk, softmax step done, released)")
        for u in range(64):
            if not any(pr[u]) and not any(co[u]):
                break
            f = lambda xs: " ".join(f"{x - t0 if x else 0:7d}" for x in xs)
            cs.log(f"  use {u}: P {f(pr[u][:3])} | C {f(co[u][:3])}")


BEAM_ONE = r"""
import statistics, sys, time, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from recsys_examples_torch.data.sid_batch import random_sid_batch
from recsys_examples_torch.ops import beam_decode_attention as bda
from recsys_examples_torch.ops import hstu_attention as ha
tag = sys.argv[1]
torch.backends.cuda.matmul.allow_tf32 = False
pattern = r"beam_wgmma_kernel|tc::kernel"
gen = torch.Generator(device="cuda").manual_seed(12)
W, H, D, S = 200, 8, 128, cs.SID_HISTORY_ITEMS * 4 + 1
for B, n in ((16, 3), (1, 1), (1, 2), (1, 3)):
    lens = (random_sid_batch(cs.SEED, B, cs.SID_HISTORY_ITEMS, 4, 256).history_lengths + 1).tolist()
    c = cs.beam_case(gen, B, W, H, H, D, S, n, lens)
    args = [c[k] for k in ("q", "k_ctx", "v_ctx", "ctx_lens", "k_beam", "v_beam", "ancestry")]
    f = lambda: bda.beam_decode_attn(*args, sm_scale=D ** -0.5)
    f()
    torch.cuda.synchronize()
    host = []
    for _ in range(5):   # the wrapper's host cost: 200 calls, no sync between them
        t0 = time.perf_counter()
        for _ in range(200):
            f()
        host.append((time.perf_counter() - t0) / 200 * 1e3)
        torch.cuda.synchronize()
    cs.log(f"[{tag}] K7 B={B} N={n}: device_ms={cs.device_ms(f, pattern):.4f} "
           f"event_ms={cs.median_time_ms(f, 200, reps=5):.4f} "
           f"host_ms={statistics.median(host):.4f} (min {min(host):.4f})")
lengths = [int(x) for x in cs.seqlens_of(cs.bench_batch(cs.SEED, 32, 4096))]
q, k, v, _, offsets = cs.attention_operands(gen, lengths, 4, 256, pad=0)
(q8, sq), (k8, sk), (v8, sv) = [ha.quantize_per_tensor(x) for x in (q, k, v)]
N = 2 * 4096 + cs.N_CTX
nc = torch.full((len(lengths),), cs.N_CTX, dtype=torch.int32, device="cuda")
opts = ha.AttnOptions(max_seqlen=N, alpha=1 / 16, scaling_seqlen=N)
k1 = lambda: ha.hstu_attn_fwd_cuda(q, k, v, offsets.to(torch.int32), nc, None, opts)
k5 = lambda: ha.hstu_attn_varlen_quantized_calibrated(q8, k8, v8, sq, sk, sv, offsets, N,
                                                      num_contextuals=nc, alpha=1 / 16)
cs.log(f"[{tag}] full-width training shape (T={sum(lengths)}): K5 event_ms="
       f"{cs.median_time_ms(k5, 3):.4f} K1 event_ms={cs.median_time_ms(k1, 3):.4f}")
"""


def beam_compare(other):
    trees = [("other", Path(other).resolve()), ("this", ROOT), ("this", ROOT),
             ("other", Path(other).resolve())]
    for i, (tag, tree) in enumerate(trees):
        r = subprocess.run([sys.executable, "-c", BEAM_ONE, f"{tag}{i}"], cwd=tree,
                           capture_output=True, text=True, env={**os.environ, "PYTHONPATH": ""})
        print("\n".join(l for l in r.stdout.splitlines() if l.startswith("[")), flush=True)
        if r.returncode:
            print(r.stderr[-3000:], flush=True)
            raise SystemExit(f"beam_compare: the run in {tree} failed")


# ---------------------------------------------------------------- K5: variants
FWD = "hstu_attention_fwd"
INT8_VARIANTS = {
    "widen_off": [("    for (uint32_t v = w; v < BT * VPR; v += WIDEN) {",
                   "    for (uint32_t v = w; v < 0; v += WIDEN) {")],
    "regs232": [("  static constexpr int CONSUMER = I8 ? 216 : 240;",
                 "  static constexpr int CONSUMER = I8 ? 232 : 240;"),
                ("  static constexpr int PRODUCER = I8 ? 72 : 24;",
                 "  static constexpr int PRODUCER = I8 ? 40 : 24;")],
    "unroll4": [("    for (uint32_t v = w; v < BT * VPR; v += WIDEN) {",
                 "#pragma unroll 4\n    for (uint32_t v = w; v < BT * VPR; v += WIDEN) {")],
}


def int8_fwd():
    from recsys_examples_torch.ops import hstu_attention as ha

    procs = {tag: _build(tag, e, FWD) for tag, e in INT8_VARIANTS.items()}
    libs = {"base": cuda_build.load(FWD), **{tag: _load(tag, p) for tag, p in procs.items()}}
    gen = torch.Generator(device="cuda").manual_seed(13)
    lengths = [int(x) for x in cs.seqlens_of(cs.bench_batch(cs.SEED, 32, 4096))]
    q, k, v, _, offsets = cs.attention_operands(gen, lengths, 4, 256, pad=0)
    (q8, sq), (k8, sk), (v8, sv) = [ha.quantize_per_tensor(x) for x in (q, k, v)]
    N = 2 * 4096 + cs.N_CTX
    o32 = offsets.to(torch.int32)
    nc = torch.full((len(lengths),), cs.N_CTX, dtype=torch.int32, device="cuda")
    opts8 = ha.AttnOptions(max_seqlen=N, alpha=sq * sk / 16, scaling_seqlen=N)
    opts = ha.AttnOptions(max_seqlen=N, alpha=1 / 16, scaling_seqlen=N)

    def k5(lib):   # the C entry, with the arguments the wrapper passes
        fn = lib.hstu_attn_fwd_int8_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2 \
            + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out = torch.zeros(q8.shape, dtype=torch.bfloat16, device="cuda")
        err = fn(q8.data_ptr(), k8.data_ptr(), v8.data_ptr(), out.data_ptr(), o32.data_ptr(),
                 nc.data_ptr(), None, q8.shape[0], len(lengths), 4, 256, N, opts8.alpha, 1.0 / N,
                 1, 1, 0, 0, sv, torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"int8_fwd: launch failed with error {err}")
        return out

    k1 = lambda: ha.hstu_attn_fwd_cuda(q, k, v, o32, nc, None, opts)
    want = k5(libs["base"])
    same = [tag for tag in INT8_VARIANTS if torch.equal(k5(libs[tag]), want)]
    order = ["base", *INT8_VARIANTS, "base"]
    ms = [cs.median_time_ms(lambda lib=libs[tag]: k5(lib), 5) for tag in order]
    cs.log(f"int8_fwd (T={sum(lengths)}, H 4 x 256) event_ms: K1 {cs.median_time_ms(k1, 5):.4f}, "
           + ", ".join(f"{t} {m:.4f}" for t, m in zip(order, ms))
           + f", K1 {cs.median_time_ms(k1, 5):.4f}; equal to base bit for bit: {same}")


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("paged_study needs a CUDA card")
    cmd, rest = (sys.argv[1:2] or ["?"])[0], sys.argv[2:]
    cs.log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip())
    if cmd == "splits":
        splits()
    elif cmd == "variants":
        variants()
    elif cmd == "clocks":
        clocks(st1=rest == ["st1"])
    elif cmd == "compare" and len(rest) == 1:
        compare(rest[0])
    elif cmd == "beam":
        beam()
    elif cmd == "beam_clocks":
        beam_clocks()
    elif cmd == "beam_compare" and len(rest) == 1:
        beam_compare(rest[0])
    elif cmd == "int8_fwd":
        int8_fwd()
    else:
        raise SystemExit(__doc__)
