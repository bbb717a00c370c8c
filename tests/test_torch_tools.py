"""The port's tools (`recsys_examples_torch/tools/`) against the repo's
tools/: each data generator and oracle bound equals the JAX tool's for the
same seed (the JAX tool loaded from its path with importlib), and each tool
runs end to end on `--device cpu` at a tiny size and prints the JAX tool's
JSON keys."""
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from recsys_examples_torch.tools import build_sid_mapping as t_map
from recsys_examples_torch.tools import convergence_retrieval as t_ret
from recsys_examples_torch.tools import convergence_sid as t_sid
from recsys_examples_torch.tools import convergence_synthetic as t_syn
from recsys_examples_torch.tools import http_loadgen as t_http
from recsys_examples_torch.tools import kernel_parity as t_par
from recsys_examples_torch.tools import serving_soak as t_soak

TOOLS = Path(__file__).resolve().parents[1] / "tools"


def jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def last_json(capsys):
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    return [json.loads(ln) for ln in lines]


def test_synthetic_generator_and_oracle_match_jax(tmp_path):
    j = jax_tool("convergence_synthetic")
    from recsys_examples_torch.data.sequence_dataset import preprocess_movielens

    for task in ("pref", "item_bias"):
        tb, tc = t_syn.gen_ratings(tmp_path / "t.dat", n_users=40, task=task, seed=3)
        jb, jc = j.gen_ratings(tmp_path / "j.dat", n_users=40, task=task, seed=3)
        assert tb == jb
        np.testing.assert_array_equal(tc, jc)
        assert (tmp_path / "t.dat").read_text() == (tmp_path / "j.dat").read_text()
    preprocess_movielens(str(tmp_path / "t.dat"), str(tmp_path / "seq.npz"), min_seq_len=10)
    assert (t_syn.holdout_oracle_auc(str(tmp_path / "seq.npz"), tc)
            == j.holdout_oracle_auc(str(tmp_path / "seq.npz"), jc))
    ys = np.arange(50) % 3 == 0
    ps = np.random.default_rng(0).random(50)
    assert t_syn._auc(ps, ys) == j._auc(ps, ys)


def test_retrieval_generator_and_oracle_match_jax(tmp_path):
    j = jax_tool("convergence_retrieval")
    from recsys_examples_torch.data.sequence_dataset import preprocess_movielens

    tc = t_ret.gen_ratings(tmp_path / "t.dat", n_users=48, seed=2)
    jc = j.gen_ratings(tmp_path / "j.dat", n_users=48, seed=2)
    np.testing.assert_array_equal(tc, jc)
    assert (tmp_path / "t.dat").read_text() == (tmp_path / "j.dat").read_text()
    npz = str(tmp_path / "seq.npz")
    preprocess_movielens(str(tmp_path / "t.dat"), npz, min_seq_len=10)
    assert t_ret.oracle_metrics(npz, tc, 16) == j.oracle_metrics(npz, jc, 16)


def test_sid_generator_and_oracle_match_jax():
    j = jax_tool("convergence_sid")
    got, want = t_sid.generate(50, 20, 9, 4, 0.7, 5), j.generate(50, 20, 9, 4, 0.7, 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for k in (1, 5, 10, 100):
        assert t_sid.oracle_recall(k, 4, 0.7, 50) == j.oracle_recall(k, 4, 0.7, 50)


def test_sid_mapping_matches_jax(tmp_path):
    """The co-occurrence embeddings (fp64 products in torch here, numpy
    there) within 1e-9 of JAX's tool; the RQ mapping built from them equal."""
    j = jax_tool("build_sid_mapping")
    flat, offsets, _ = t_sid.generate(60, 40, 10, 3, 0.8, 1)
    got = t_map.cooccurrence_embeddings(flat, offsets, 60, dim=16, seed=1, device="cpu")
    want = j.cooccurrence_embeddings(flat, offsets, 60, dim=16, seed=1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    npz = str(tmp_path / "seq.npz")
    np.savez(npz, flat_items=flat, offsets=offsets, user_ids=np.arange(40, dtype=np.int64),
             num_items=np.int64(60))
    argv = ["--from-sequences", npz, "--codebook-sizes", "4,4,4", "--iters", "8",
            "--svd-dim", "16"]
    t_map.main(argv + ["--out", str(tmp_path / "t.npy"), "--device", "cpu"])
    old = sys.argv
    sys.argv = ["build_sid_mapping"] + argv + ["--out", str(tmp_path / "j.npy")]
    try:
        j.main()
    finally:
        sys.argv = old
    np.testing.assert_array_equal(np.load(tmp_path / "t.npy"), np.load(tmp_path / "j.npy"))


def test_kernel_parity_pass_rule_and_run(tmp_path, capsys):
    j = jax_tool("pallas_parity")
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((7, 5)), rng.standard_normal((7, 5))
    assert t_par._maxerr(a, b) == j._maxerr(a, b)
    out = tmp_path / "parity.json"
    t_par.main(["--device", "cpu", "--out", str(out)])
    (line,) = last_json(capsys)
    assert set(line) == {"bench", "all_pass", "cases", "backend", "artifact"}
    assert line["all_pass"] and line["backend"] == "cpu" and line["cases"] == 18
    art = json.loads(out.read_text())
    assert art["all_pass"] and {r["kernel"] for r in art["results"]} >= {
        "hstu_attn_varlen/causal/fwd", "hstu_attn_varlen_rab/drab",
        "hstu_attn_varlen_quantized_calibrated", "paged_hstu_delta_attention",
        "paged_hstu_delta_attention_int8", "beam_decode_attn"}


def test_serving_soak_contexts_and_run(capsys):
    # the JAX tool draws its contexts inline in main(); these are its lines
    rng = np.random.default_rng(0)
    want = [rng.integers(0, 256, int(n) * 4).astype(np.int32)
            for n in rng.choice([2, 4, 8, 24], 6)]
    got = t_soak.make_contexts(6, 4)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    t_soak.main(["--device", "cpu", "--requests", "6", "--steps-per-dispatch", "1", "3"])
    lines = last_json(capsys)
    assert [ln["scheduler"] for ln in lines] == [
        "stepwise-continuous/spd=1", "stepwise-continuous/spd=3", "batch-at-a-time"]
    keys = {"scheduler", "requests", "total_s", "req_per_s", "latency_ms_p50",
            "latency_ms_p99", "backend"}
    assert set(lines[-1]) == keys
    assert set(lines[0]) == keys | {"pool_high_water", "pool_leaks", "dispatches",
                                    "steps_per_dispatch"}
    assert all(ln["backend"] == "cpu" and ln["requests"] == 6 for ln in lines)
    assert not any(ln.get("pool_leaks") for ln in lines)


@pytest.mark.parametrize("kind", ["ranking", "sid"])
def test_http_loadgen_inprocess(kind, capsys):
    pytest.importorskip("aiohttp")
    t_http.main(["--device", "cpu", "--inprocess", kind, "--requests", "6", "--rate", "500"])
    (line,) = last_json(capsys)
    assert set(line) == {"completed", "errors", "wall_s", "throughput_rps", "latency_ms",
                         "target", "bench", "backend"}
    assert line["completed"] == 6 and line["errors"] == {} and line["backend"] == "cpu"


def test_convergence_synthetic_runs(tmp_path, capsys):
    t_syn.main(["--device", "cpu", "--iters", "3", "--users", "140", "--hidden", "16",
                "--layers", "1", "--eval-iters", "2",
                "--eval-every", "3", "--workdir", str(tmp_path)])
    line = last_json(capsys)[-1]
    assert set(line) == {"bench", "task", "iters", "holdout_auc", "best_holdout_auc",
                         "auc_history", "bayes_auc_upper_bound", "holdout_oracle_auc",
                         "backend"}
    assert line["backend"] == "cpu" and 0 <= line["holdout_auc"] <= 1


def test_convergence_retrieval_runs(tmp_path, capsys):
    t_ret.main(["--device", "cpu", "--iters", "3", "--users", "140", "--hidden", "16",
                "--layers", "1", "--eval-every", "3",
                "--workdir", str(tmp_path)])
    line = last_json(capsys)[-1]
    assert set(line) == {"bench", "iters", "final", "best_hr10", "oracle",
                         "random_baseline_hr10", "backend"}
    assert line["backend"] == "cpu" and set(line["final"]) == {"HR@10", "NDCG@10", "MRR"}


def test_convergence_sid_runs(tmp_path, capsys):
    t_sid.main(["--device", "cpu", "--iters", "3", "--items", "40", "--users", "40",
                "--seq-len", "8", "--hidden", "32", "--layers", "1", "--codebook-size", "8",
                "--beam", "4", "--eval-iters", "1", "--batch-size", "8",
                "--workdir", str(tmp_path)])
    line = last_json(capsys)[-1]
    assert set(line) == {"harness", "items", "p_signal", "succ_k", "unique_sid_tuples",
                         "metrics", "oracle", "random", "workdir", "backend"}
    assert line["backend"] == "cpu" and "recall@10" in line["metrics"]
