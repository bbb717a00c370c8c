"""Measurements behind the paged attention kernel's design (K6, K6-int8,
`recsys_examples_torch/csrc/paged_hstu_attention.cu`), on one card. Run from
the repo root:

    python3 paged_study.py splits
    python3 paged_study.py variants
    python3 paged_study.py clocks [st1]
    python3 paged_study.py compare PARENT_DIR

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


def _build(tag, edits):
    """Start nvcc on an edited copy of the source; (process, library path)."""
    var = cuda_build.BUILD_DIR / "var"
    var.mkdir(parents=True, exist_ok=True)
    s = (cuda_build.CSRC_DIR / f"{NAME}.cu").read_text()
    for old, new in edits:
        if old not in s:
            raise SystemExit(f"{tag}: the source no longer holds {old!r}")
        s = s.replace(old, new)
    src, out = var / f"{NAME}_{tag}.cu", var / f"lib{NAME}_{tag}.so"
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


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("paged_study needs a CUDA card")
    cmd, rest = (sys.argv[1:2] or ["?"])[0], sys.argv[2:]
    if cmd == "splits":
        splits()
    elif cmd == "variants":
        variants()
    elif cmd == "clocks":
        clocks(st1=rest == ["st1"])
    elif cmd == "compare" and len(rest) == 1:
        compare(rest[0])
    else:
        raise SystemExit(__doc__)
