"""Ahead-of-time export of the HSTU inference graph (counterpart of
recsys_examples_tpu/inference/export.py).

The JAX package serialises the dense forward with `jax.export` and replays
it from C++ through the PJRT C API. Here the artifact is a `torch.export`
program, and on the card an AOTInductor package that the C++ runner
`csrc/aoti_replay.cpp` loads with no Python in the serving process.

What is exported is the JAX export's function: the gather-KV dense forward
(`InferenceDenseModule` with `paged=None`) at fixed (B, max_new,
max_cached) bucket shapes. Its attention is the plain `delta_attention`, so
the graph holds no custom kernel and needs no `torch.library` op (the paged
path, whose attention is kernel K6, is not exported, as in JAX). The params
are run-time inputs, not constants: the program takes them first, through
`torch.func.functional_call`, in the JAX export's order and layout (the
flax tree's leaves, keys sorted at every level, a Dense kernel [in, out]),
so the replay spec lists the JAX package's inputs.

Artifacts per export:
  <path>/dense_fwd.pt2        the `torch.export` program (`torch.export.save`)
  <path>/params.pt            the state dict, the program's first inputs
  <path>/replay_spec.txt      flat input manifest (name, dtype, shape in call
                              order) for csrc/aoti_replay.cpp
  <path>/inputs.bin           the params' row-major bytes in that order (the
                              run-time inputs are zero-filled by the replay)
  <path>/dense_fwd.aoti.pt2   on the card only: the AOTInductor package

`build_aoti_replay` compiles the C++ runner ($CXX, c++ or g++) against
torch's headers and libraries into `recsys_examples_torch/_build/` at first
use; `compile_aoti` keeps Inductor's and Triton's caches in
`recsys_examples_torch/_build/inductor/`.
"""
from __future__ import annotations

import contextlib
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import List, Mapping, Sequence, Tuple

import torch
from torch import nn

from recsys_examples_torch.convert import flax_path
from recsys_examples_torch.inference.inference_ranking_gr import InferenceRankingGR
from recsys_examples_torch.utils.cuda_build import BUILD_DIR, CSRC_DIR
from recsys_examples_torch.utils.logger import print_rank_0

PROGRAM = "dense_fwd.pt2"
AOTI_PACKAGE = "dense_fwd.aoti.pt2"
PARAMS = "params.pt"
INDUCTOR_CACHE = BUILD_DIR / "inductor"


class _FlatDense(nn.Module):
    """(params..., emb, ck, cv, clen, new_lens, ncand) -> (logits, ks, vs):
    the dense module called with the given params, each in flax's layout
    (`flat_params`). The module is held outside the submodule tree, so its
    own weights are not lifted into the program."""

    def __init__(self, module: nn.Module, order: Sequence[Tuple[str, bool]], scaling: int):
        super().__init__()
        object.__setattr__(self, "_dense", module)
        self.order = tuple(order)
        self.scaling = scaling

    def forward(self, *args):
        n = len(self.order)
        params = {k: (p.t() if transposed else p)
                  for (k, transposed), p in zip(self.order, args[:n])}
        return torch.func.functional_call(
            self._dense, params, tuple(args[n:]) + (self.scaling,))


def flat_params(state: Mapping[str, torch.Tensor]) -> List[Tuple[str, bool]]:
    """The program's params: (state-dict key, transposed) in the order of
    the flax tree's leaves."""
    paths = {k: flax_path(k) for k in state}
    return [(k, paths[k][1]) for k in sorted(state, key=lambda k: paths[k][0])]


def _flat_values(state, order):
    return tuple(state[k].t().contiguous() if t else state[k] for k, t in order)


def export_ranking_dense(
    runner: InferenceRankingGR,
    batch_size: int,
    max_new: int,
    max_cached: int,
    path: str,
) -> str:
    """Export the dense forward (gather-KV path) for (B, max_new,
    max_cached) bucket shapes on the runner's device. Returns the program's
    path. On the card the AOTInductor package is built too."""
    os.makedirs(path, exist_ok=True)
    cfg, kcfg = runner.config, runner.kv_config
    H, dh, L = kcfg.num_heads, kcfg.head_dim, kcfg.num_layers
    scaling = cfg.scaling_seqlen if cfg.scaling_seqlen > 0 else kcfg.max_cached_len
    dev = runner.device
    state = {k: v.detach() for k, v in runner.module.state_dict().items()}
    order = flat_params(state)
    params = _flat_values(state, order)
    kv_shape = (L, batch_size, max_cached, H, dh)
    runtime = (
        torch.zeros((batch_size, max_new, cfg.hidden_size), dtype=cfg.dtype, device=dev),
        torch.zeros(kv_shape, dtype=kcfg.dtype, device=dev),
        torch.zeros(kv_shape, dtype=kcfg.dtype, device=dev),
        torch.zeros((batch_size,), dtype=torch.int32, device=dev),
        torch.zeros((batch_size,), dtype=torch.int32, device=dev),
        torch.zeros((batch_size,), dtype=torch.int32, device=dev),
    )
    args = params + runtime
    with torch.no_grad():
        program = torch.export.export(_FlatDense(runner.module, order, scaling), args)
    art = os.path.join(path, PROGRAM)
    torch.export.save(program, art)
    torch.save(state, os.path.join(path, PARAMS))
    write_replay_artifacts(path, args, values=params)
    if dev.type == "cuda":
        compile_aoti(program, path)
    return art


def _compilers() -> List[str]:
    """The C++ compilers on PATH, in order: $CXX, c++, g++."""
    names = [os.environ.get("CXX"), "c++", "g++"]
    found = [shutil.which(n) for n in names if n]
    out = [c for c in dict.fromkeys(found) if c]
    if not out:
        raise RuntimeError("no C++ compiler on PATH")
    return out


def _takes_openmp(cxx: str) -> bool:
    probe = subprocess.run([cxx, "-fopenmp", "-x", "c++", "-", "-o", os.devnull],
                           input="int main() { return 0; }\n", capture_output=True, text=True)
    return probe.returncode == 0


def _inductor_cxx() -> str:
    """A compiler for Inductor's build of the package's wrapper, which it
    always compiles and links with -fopenmp: the first that links OpenMP."""
    cands = _compilers()
    for cxx in cands:
        if _takes_openmp(cxx):
            return cxx
    raise RuntimeError(f"none of {cands} links OpenMP (-fopenmp), which the "
                       "AOTInductor package's wrapper needs")


@contextlib.contextmanager
def _inductor_cache():
    """Inductor's and Triton's caches under `INDUCTOR_CACHE` for the
    duration, as the nvcc builds are kept in `_build/`."""
    dirs = {"TORCHINDUCTOR_CACHE_DIR": INDUCTOR_CACHE,
            "TRITON_CACHE_DIR": INDUCTOR_CACHE / "triton"}
    old = {k: os.environ.get(k) for k in dirs}
    os.environ.update({k: str(v) for k, v in dirs.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def compile_aoti(program, path: str) -> str:
    """Build the AOTInductor package of `program` into `path`; returns its
    path."""
    from torch._inductor import aoti_compile_and_package
    from torch._inductor import config as inductor_config

    t0 = time.perf_counter()
    cxx = _inductor_cxx()
    with _inductor_cache(), inductor_config.patch({"cpp.cxx": (cxx,)}):
        out = aoti_compile_and_package(program, package_path=os.path.join(path, AOTI_PACKAGE))
    print_rank_0(f"export: AOTInductor package {out} built in "
                 f"{time.perf_counter() - t0:.1f} s with {cxx}")
    return out


_SPEC_DTYPE = {
    torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
    torch.float64: "f64", torch.int32: "s32", torch.int64: "s64", torch.int16: "s16",
    torch.int8: "s8", torch.uint32: "u32", torch.uint64: "u64", torch.uint16: "u16",
    torch.uint8: "u8", torch.bool: "pred",
}


def write_replay_artifacts(path: str, inputs: Sequence[torch.Tensor],
                           values: Sequence[torch.Tensor] = (),
                           data: str = "inputs.bin", spec: str = "replay_spec.txt"):
    """Write the C++ replay's manifest and payload for a program whose flat
    inputs have the shapes and dtypes of `inputs`. `values` is a prefix of
    those inputs with concrete tensors, written into `data` in call order;
    the replay zero-fills the rest."""
    lines = [
        "# aoti_replay input manifest: flattened call-order args of "
        f"{AOTI_PACKAGE}",
        f"data {data}",
    ]
    with open(os.path.join(path, data), "wb") as bf:
        for i, t in enumerate(inputs):
            dims = ",".join(str(d) for d in t.shape) if t.dim() else "-"
            lines.append(f"input arg{i} {_SPEC_DTYPE[t.dtype]} {dims}")
            if i < len(values):
                v = values[i]
                if v.shape != t.shape or v.dtype != t.dtype:
                    raise ValueError(f"value {i}: {v.dtype} {tuple(v.shape)} for an input "
                                     f"of {t.dtype} {tuple(t.shape)}")
                bf.write(v.detach().to("cpu").contiguous().reshape(-1)
                         .view(torch.uint8).numpy().tobytes())
    with open(os.path.join(path, spec), "w") as f:
        f.write("\n".join(lines) + "\n")


class ExportedRankingDense:
    """Replay side: the loaded program called with the saved params, on the
    export's device."""

    def __init__(self, path: str):
        self.program = torch.export.load(os.path.join(path, PROGRAM))
        self._fn = self.program.module()
        state = torch.load(os.path.join(path, PARAMS), weights_only=True)
        self.params: Tuple[torch.Tensor, ...] = _flat_values(state, flat_params(state))

    def __call__(self, emb, ck, cv, clen, new_lens, ncand):
        with torch.no_grad():
            return self._fn(*self.params, emb, ck, cv, clen, new_lens, ncand)


def _replay_command() -> List[str]:
    """Compile and link options of the C++ runner, against the running
    torch's headers and libraries."""
    from torch.utils import cpp_extension

    libs = cpp_extension.library_paths()
    cmd = ["-O2", "-std=c++17",
           f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}"]
    cmd += [f"-I{p}" for p in cpp_extension.include_paths()]
    cmd += [f"-L{p}" for p in libs] + [f"-Wl,-rpath,{p}" for p in libs]
    cmd += ["-Wl,--no-as-needed", "-ltorch", "-ltorch_cpu", "-lc10"]
    if any(Path(p, "libtorch_cuda.so").exists() for p in libs):
        cmd += ["-ltorch_cuda", "-lc10_cuda"]     # registers the CUDA backend
    return cmd


def aoti_replay_path() -> Path:
    """Where `build_aoti_replay` puts the runner: the name hashes the source,
    the compiler, the command and the torch version."""
    src = CSRC_DIR / "aoti_replay.cpp"
    h = hashlib.sha256(src.read_bytes() + " ".join([_compilers()[0], *_replay_command(),
                                                    torch.__version__])
                       .encode()).hexdigest()[:16]
    return BUILD_DIR / f"aoti_replay-{h}"


def build_aoti_replay() -> Path:
    """The C++ runner `csrc/aoti_replay.cpp`, compiled by the first of
    `_compilers()` into `_build/` if it is not there yet. Raises with the compiler's output when
    the build fails."""
    out = aoti_replay_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_compilers()[0], "-o", str(tmp),
                               str(CSRC_DIR / "aoti_replay.cpp"), *_replay_command()],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"aoti_replay build failed:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
        print_rank_0(f"export: built {out} in {time.perf_counter() - t0:.1f} s")
    return out
