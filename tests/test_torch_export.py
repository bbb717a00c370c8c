"""The port's ranking export (`inference/export.py`) against the JAX
package's (tests/test_export_and_serving.py's tiny fp32 config), with the
same dense params: the loaded `torch.export` program against JAX's loaded
`jax.export` artifact on the same inputs (rtol and atol 1e-5), the params
as run-time inputs (nothing baked into the program), and the C++ replay
triple: the spec lists JAX's inputs (params + 6, the same dtypes and
shapes in the same order) and `inputs.bin` holds the same bytes. The C++
runner's dry run is skipped when `csrc/aoti_replay.cpp` is not built, as
JAX's `pjrt_replay` test is; the AOTInductor package is built on the card
only (chip_smoke.py phase 19)."""
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from recsys_examples_torch import convert
from recsys_examples_torch.dynamicemb.exportable_tables import InferenceTableState
from recsys_examples_torch.inference import export as t_export
from recsys_examples_torch.inference.inference_ranking_gr import (
    InferenceDenseModule as TDense,
    InferenceRankingGR as TRunner,
)
from recsys_examples_torch.inference.kvcache import KVCacheConfig as TKVConfig
from recsys_examples_torch.modules.config import HSTUConfig as THSTUConfig
from recsys_examples_tpu.dynamicemb.exportable_tables import (
    InferenceTableState as JTableState,
)
from recsys_examples_tpu.inference import export as j_export
from recsys_examples_tpu.inference.inference_ranking_gr import (
    InferenceDenseModule as JDense,
    InferenceRankingGR as JRunner,
)
from recsys_examples_tpu.inference.kvcache import KVCacheConfig
from recsys_examples_tpu.modules.config import HSTUConfig, KernelBackend

MODEL = dict(hidden_size=16, num_layers=2, num_attention_heads=2, kv_channels=8)
KV = dict(num_layers=2, num_heads=2, head_dim=8, page_size=4, num_pages=64,
          max_users=8, max_pages_per_user=8)
B, S, NC = 2, 8, 16
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """Both packages' exports of the same dense params, at (B, S, NC)."""
    jcfg = HSTUConfig(**MODEL, hidden_dropout=0.0, kernel_backend=KernelBackend.JNP,
                      dtype=jnp.float32)
    mod = JDense(jcfg, head_arch=(8, 1))
    ck = jnp.zeros((2, B, 0, 2, 8), jnp.float32)
    params = jax.jit(lambda key: mod.init(
        key, jnp.zeros((B, S, 16), jnp.float32), ck, ck, jnp.zeros((B,), jnp.int32),
        jnp.full((B,), S, jnp.int32), None, 32))(jax.random.PRNGKey(0))["params"]
    params = jax.tree.map(lambda x: x.astype(jnp.float32), nn.unbox(params))
    table = JTableState(keys=jnp.zeros((2, 2), jnp.int64), values=jnp.zeros((4, 16)))
    jr = JRunner(config=jcfg, kv_config=KVCacheConfig(**KV, dtype=jnp.float32),
                 dense_params=params, item_table=table, head_arch=(8, 1))
    jpath = tmp_path_factory.mktemp("jax_export")
    j_export.export_ranking_dense(jr, B, S, NC, str(jpath))

    tcfg = THSTUConfig(**MODEL, dtype=torch.float32)
    dense = TDense(tcfg, head_arch=(8, 1))
    dense.load_state_dict(convert.dense_state_dict(jax.tree.map(np.asarray, params)))
    tr = TRunner(tcfg, TKVConfig(**KV, dtype=torch.float32), dense,
                 InferenceTableState(torch.zeros(2, 2, dtype=torch.int64), torch.zeros(4, 16)),
                 device="cpu")
    tpath = tmp_path_factory.mktemp("port_export")
    art = t_export.export_ranking_dense(tr, B, S, NC, str(tpath))
    assert art == str(tpath / "dense_fwd.pt2")
    assert not (tpath / "dense_fwd.aoti.pt2").exists()     # built on the card only
    return jr, jpath, tr, tpath, params


def _inputs(seed, cached):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(B, S, 16)).astype(np.float32)
    ck = rng.normal(size=(2, B, NC, 2, 8)).astype(np.float32)
    cv = rng.normal(size=(2, B, NC, 2, 8)).astype(np.float32)
    clen = np.asarray(cached, np.int32)
    new_lens = np.asarray([S, S - 3], np.int32)
    ncand = np.asarray([2, 3], np.int32)
    return emb, ck, cv, clen, new_lens, ncand


@pytest.mark.parametrize("seed,cached", [(1, [0, 0]), (2, [5, 16])])
def test_export_roundtrip_matches_jax(exported, seed, cached):
    jr, jpath, tr, tpath, params = exported
    args = _inputs(seed, cached)
    want = j_export.ExportedRankingDense(str(jpath), jr.dense_params)(
        *(jnp.asarray(a) for a in args))
    loaded = t_export.ExportedRankingDense(str(tpath))
    got = loaded(*(torch.from_numpy(a) for a in args))
    for g, w, name in zip(got, want, ("logits", "k", "v")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL, err_msg=name)
    eager = tr.module(*(torch.from_numpy(a) for a in args), tr.kv_config.max_cached_len)
    for g, e in zip(got, eager):
        np.testing.assert_allclose(g.numpy(), e.detach().numpy(), **TOL)
    # the params are run-time inputs: nothing is baked into the program
    assert not loaded.program.state_dict and not loaded.program.constants
    n_params = len(jax.tree.leaves(params))
    assert len(loaded.program.graph_signature.user_inputs) == n_params + 6


def _spec(path):
    lines = (path / "replay_spec.txt").read_text().splitlines()
    return [ln.split() for ln in lines if ln.startswith("input ")], \
        [ln for ln in lines if ln.startswith("data ")]


def test_replay_artifacts_match_jax(exported):
    """The spec's (dtype, shape) list is JAX's, in JAX's order; the params'
    bytes in inputs.bin are JAX's; the writer refuses a value of another
    shape."""
    _, jpath, _, tpath, params = exported
    (got, got_data), (want, want_data) = _spec(tpath), _spec(jpath)
    n_params = len(jax.tree.leaves(params))
    assert len(got) == len(want) == n_params + 6
    assert [ln[2:] for ln in got] == [ln[2:] for ln in want]
    assert got_data == want_data == ["data inputs.bin"]
    width = {"f32": 4, "bf16": 2, "s32": 4, "s64": 8}
    param_bytes = sum(width[dt] * int(np.prod([int(d) for d in dims.split(",")]))
                      for _, _, dt, dims in got[:n_params])
    blob = (tpath / "inputs.bin").read_bytes()
    assert len(blob) == param_bytes and blob == (jpath / "inputs.bin").read_bytes()
    with pytest.raises(ValueError, match="for an input"):
        t_export.write_replay_artifacts(str(tpath), [torch.zeros(2, 3)], [torch.zeros(3, 2)],
                                        data="bad.bin", spec="bad_spec.txt")


def test_cpp_dry_run(exported):
    """csrc/aoti_replay parses the spec and the blob (skipped unless built:
    `export.build_aoti_replay()` compiles it against torch)."""
    _, _, _, tpath, params = exported
    binary = t_export.aoti_replay_path()
    if not binary.exists():
        pytest.skip("recsys_examples_torch/csrc/aoti_replay.cpp not built")
    out = subprocess.run([str(binary), "--spec", str(tpath / "replay_spec.txt"), "--dry-run"],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert '"mode": "dry-run"' in out.stdout
    n = len(jax.tree.leaves(params)) + 6
    assert f'"inputs": {n}' in out.stdout
    assert f'"data_bytes": {(tpath / "inputs.bin").stat().st_size}' in out.stdout
