"""The port's Qwen3 backbone, its beam runtime, serving engine and HF weight
loader against the JAX package's on the same numpy inputs and params, at
`Qwen3Config.tiny` sizes on the CPU. The JAX beam attention runs its jnp
twin, the port's its plain version.

Tolerances: fp32 logits, KV and scores within rtol/atol 1e-4 (as
tests/test_qwen3.py); paths equal. In bf16 the logits and scores are held
to tools/pallas_parity.py's pass rule (error below 2e-2 * max|ref| + 1e-3);
rope's cos/sin within 2e-4 (angles up to 1,100 rad in fp32, whose ulp is
1.2e-4). The weight loader equals `convert.qwen3_state_dict` of the JAX
loader bit for bit, on fp32 and bf16 checkpoints and a sharded one.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_examples_torch import convert
from recsys_examples_torch.inference.sid_serving import engine as t_eng
from recsys_examples_torch.inference.sid_serving import logits_processor as t_lp
from recsys_examples_torch.inference.sid_serving import qwen3_runtime as t_rt
from recsys_examples_torch.inference.sid_serving.scheduler import GRContinuousScheduler
from recsys_examples_torch.models import qwen3 as tq
from recsys_examples_tpu.inference.sid_serving import engine as j_eng
from recsys_examples_tpu.inference.sid_serving import logits_processor as j_lp
from recsys_examples_tpu.inference.sid_serving import qwen3_runtime as j_rt
from recsys_examples_tpu.models import qwen3 as jq

V = 64
TOL = dict(rtol=1e-4, atol=1e-4)
STEPS, BEAM = 3, 4


def pass_rule(got, want):
    """tools/pallas_parity.py's `_maxerr` pass rule."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    assert err < 2e-2 * np.abs(want).max() + 1e-3, err


def build(dtype):
    """The JAX model and fp32 params from flax's init, and the port's model
    loaded from them."""
    jcfg = dataclasses.replace(jq.Qwen3Config.tiny(vocab_size=V),
                               dtype={"fp32": jnp.float32, "bf16": jnp.bfloat16}[dtype])
    tcfg = dataclasses.replace(tq.Qwen3Config.tiny(vocab_size=V),
                               dtype={"fp32": torch.float32, "bf16": torch.bfloat16}[dtype])
    jm = jq.Qwen3Model(jcfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 8), jnp.int32),
                     jnp.asarray([8, 8], jnp.int32))
    tm = tq.Qwen3Model(tcfg, device="cpu")
    tm.load_state_dict(convert.qwen3_state_dict(jax.tree.map(np.asarray, params)))
    return jm, params, tm


@pytest.fixture(scope="module")
def fp32():
    return build("fp32")


@pytest.fixture(scope="module")
def bf16():
    return build("bf16")


def context(seed, B=2, N=12, lens=(12, 7)):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, V, size=(B, N)).astype(np.int32), np.asarray(lens, np.int32))


def as_np(x):
    return convert.to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def test_state_dict_names_match_flax(fp32):
    _, params, tm = fp32
    sd = convert.qwen3_state_dict(jax.tree.map(np.asarray, params))
    assert sorted(sd) == sorted(tm.state_dict())
    assert "embed_tokens.weight" in sd and "layers.1.self_attn.q_norm" in sd


def test_rope_cos_sin_matches_jax():
    pos = np.arange(0, 1100, 7, dtype=np.int32)[None]
    jc, js = jq.rope_cos_sin(jnp.asarray(pos), 128, 1_000_000.0)
    tc, ts = tq.rope_cos_sin(torch.as_tensor(pos), 128, 1_000_000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=2e-4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=2e-4)
    x = np.random.default_rng(0).standard_normal((1, pos.shape[1], 2, 128)).astype(np.float32)
    np.testing.assert_allclose(
        tq.apply_rope(torch.as_tensor(x), tc, ts).numpy(),
        np.asarray(jq.apply_rope(jnp.asarray(x), jc, js)), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def prefill_pair(fp32):
    jm, params, tm = fp32
    tok, lens = context(0)
    jl, jkv = jm.apply(params, jnp.asarray(tok), jnp.asarray(lens), method=jq.Qwen3Model.prefill)
    tl, tkv = tm.prefill(torch.as_tensor(tok).long(), torch.as_tensor(lens).long())
    return (tok, lens), (jl, jkv), (tl, tkv)


def test_prefill_logits_and_kv_match_jax(prefill_pair):
    _, (jl, jkv), (tl, tkv) = prefill_pair
    assert tl.shape == (2, V) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **TOL)
    assert len(tkv) == len(jkv) == 2
    for (jk, jv), (tk, tv) in zip(jkv, tkv):
        assert tk.shape == (2, 12, 2, 16)
        np.testing.assert_allclose(tk.detach().numpy(), np.asarray(jk), **TOL)
        np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), **TOL)


def test_prefill_ignores_padding(fp32):
    _, _, tm = fp32
    tok, lens = context(0)
    tok2 = tok.copy()
    tok2[1, 7:] = V - 1
    a, _ = tm.prefill(torch.as_tensor(tok).long(), torch.as_tensor(lens).long())
    b, _ = tm.prefill(torch.as_tensor(tok2).long(), torch.as_tensor(lens).long())
    np.testing.assert_allclose(a[1].detach().numpy(), b[1].detach().numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_beam", [0, 2])
def test_decode_step_matches_jax(fp32, prefill_pair, n_beam):
    """One beam step over the prefill's context KV and n_beam earlier steps
    reached through random (non-identity) ancestry."""
    jm, params, tm = fp32
    (tok, lens), (_, jkv), (_, tkv) = prefill_pair
    rng = np.random.default_rng(5 + n_beam)
    B, W = 2, BEAM
    step_tok = rng.integers(0, V, size=(B, W)).astype(np.int32)
    pos = np.broadcast_to(lens[:, None] + n_beam, (B, W)).astype(np.int32)
    beam = [tuple(rng.standard_normal((B, n_beam, W, 2, 16)).astype(np.float32)
                  for _ in range(2)) for _ in range(2)] if n_beam else None
    anc = rng.integers(0, W, size=(B, n_beam, W)).astype(np.int32) if n_beam else None
    jl, jnew = jm.apply(
        params, jnp.asarray(step_tok), jnp.asarray(pos), jkv, jnp.asarray(lens),
        None if beam is None else [tuple(jnp.asarray(x) for x in kv) for kv in beam],
        None if anc is None else jnp.asarray(anc), "jnp", method=jq.Qwen3Model.decode_step)
    tl, tnew = tm.decode_step(
        torch.as_tensor(step_tok).long(), torch.as_tensor(pos).long(), tkv,
        torch.as_tensor(lens).long(),
        None if beam is None else [tuple(torch.as_tensor(x) for x in kv) for kv in beam],
        None if anc is None else torch.as_tensor(anc).long())
    assert tl.shape == (B, W, V)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **TOL)
    for (jk, jv), (tk, tv) in zip(jnew, tnew):
        np.testing.assert_allclose(tk.detach().numpy(), np.asarray(jk), **TOL)
        np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), **TOL)


def band_mask(np_mod):
    """Only tokens [8 step, 8 step + 8) are allowed at each step."""
    def mask_fn(step, paths):
        B, W = paths.shape[:2]
        allowed = np.full((V,), -1e30, np.float32)
        allowed[step * 8:(step + 1) * 8] = 0.0
        m = np.broadcast_to(allowed[None, None], (B, max(W, BEAM), V))
        return jnp.asarray(m) if np_mod == "jax" else torch.as_tensor(m.copy())
    return mask_fn


def processors(lp):
    suppress = lp.processors_from_specs([{"type": "token_suppress",
                                          "token_ids": list(range(32, 64))}])
    return lp.LogitsProcessorChain(tuple(suppress.processors)
                                   + tuple(lp.make_chain(top_k=1).processors))


GEN_CASES = ["plain", "mask", "processors"]


def gen_kwargs(case, side):
    if case == "mask":
        return dict(logits_mask_fn=band_mask(side))
    if case == "processors":
        return dict(logits_processor=processors(j_lp if side == "jax" else t_lp))
    return {}


@pytest.fixture(scope="module")
def jax_generations(fp32, bf16):
    """One jitted JAX run per (dtype, case), shared by the tests below."""
    out = {}
    tok, lens = context(1)
    for dtype, (jm, params, _) in (("fp32", fp32), ("bf16", bf16)):
        runs = {case: functools.partial(j_rt.qwen3_generate_beam, jm, backend="jnp",
                                        **gen_kwargs(case, "jax")) for case in GEN_CASES}
        runs["reference"] = functools.partial(j_rt.qwen3_generate_reference, jm)
        for case, fn in runs.items():
            p, s = jax.jit(lambda pr, t, n, fn=fn: fn(pr, t, n, num_steps=STEPS,
                                                      beam_width=BEAM))(
                params, jnp.asarray(tok), jnp.asarray(lens))
            out[dtype, case] = (np.asarray(p), np.asarray(s, np.float32))
    return out


@pytest.mark.parametrize("case", GEN_CASES)
def test_generate_beam_matches_jax_fp32(fp32, jax_generations, case):
    _, _, tm = fp32
    tok, lens = context(1)
    paths, scores = t_rt.qwen3_generate_beam(tm, tok, lens, num_steps=STEPS, beam_width=BEAM,
                                             **gen_kwargs(case, "torch"))
    want_p, want_s = jax_generations["fp32", case]
    assert paths.shape == (2, BEAM, STEPS) and scores.shape == (2, BEAM)
    np.testing.assert_array_equal(paths.numpy(), want_p)
    fin = np.isfinite(want_s)
    np.testing.assert_array_equal(np.isfinite(scores.numpy()), fin)
    np.testing.assert_allclose(scores.numpy()[fin], want_s[fin], **TOL)
    if case == "mask":
        p = paths.numpy()
        for h in range(STEPS):
            assert ((p[:, :, h] >= 8 * h) & (p[:, :, h] < 8 * h + 8)).all()
    if case == "processors":
        assert (paths.numpy() < 32).all()


def test_generate_reference_matches_jax_and_cached_path(fp32, jax_generations):
    _, _, tm = fp32
    tok, lens = context(1)
    paths, scores = t_rt.qwen3_generate_reference(tm, tok, lens, STEPS, BEAM)
    want_p, want_s = jax_generations["fp32", "reference"]
    np.testing.assert_array_equal(paths.numpy(), want_p)
    np.testing.assert_allclose(scores.numpy(), want_s, **TOL)
    cached_p, cached_s = t_rt.qwen3_generate_beam(tm, tok, lens, STEPS, BEAM)
    np.testing.assert_array_equal(cached_p.numpy(), paths.numpy())
    np.testing.assert_allclose(cached_s.numpy(), scores.numpy(), **TOL)


@pytest.mark.parametrize("case", GEN_CASES + ["reference"])
def test_generate_bf16_within_pass_rule(bf16, jax_generations, case):
    _, _, tm = bf16
    tok, lens = context(1)
    if case == "reference":
        paths, scores = t_rt.qwen3_generate_reference(tm, tok, lens, STEPS, BEAM)
    else:
        paths, scores = t_rt.qwen3_generate_beam(tm, tok, lens, STEPS, BEAM,
                                                 **gen_kwargs(case, "torch"))
    want_p, want_s = jax_generations["bf16", case]
    fin = np.isfinite(want_s)
    np.testing.assert_array_equal(np.isfinite(scores.numpy()), fin)
    pass_rule(scores.numpy()[fin], want_s[fin])
    np.testing.assert_array_equal(paths.numpy(), want_p)


def test_bf16_prefill_within_pass_rule(bf16):
    jm, params, tm = bf16
    tok, lens = context(0)
    jl, jkv = jm.apply(params, jnp.asarray(tok), jnp.asarray(lens), method=jq.Qwen3Model.prefill)
    tl, tkv = tm.prefill(torch.as_tensor(tok).long(), torch.as_tensor(lens).long())
    assert tkv[0][0].dtype == torch.bfloat16
    pass_rule(tl.detach().numpy(), jl)
    for (jk, _), (tk, _) in zip(jkv, tkv):
        pass_rule(as_np(tk), as_np(jk))


def test_serving_engine_matches_jax(fp32):
    jm, params, tm = fp32
    scfg = dict(beam_width=BEAM, ctx_buckets=(16,), batch_buckets=(2, 4))
    je = j_eng.Qwen3ServingEngine(jm, params, j_eng.ServingConfig(**scfg), num_steps=STEPS,
                                  attn_backend="jnp")
    te = t_eng.Qwen3ServingEngine(tm, t_eng.ServingConfig(**scfg), num_steps=STEPS)
    rng = np.random.default_rng(4)
    ctxs = [rng.integers(0, V, size=(9,)).astype(np.int32),
            rng.integers(0, V, size=(13,)).astype(np.int32),
            np.zeros((0,), np.int32)]          # an empty context decodes from 0
    wp, ws = je.generate(ctxs)
    tp, ts = te.generate(ctxs)
    assert tp.shape == (3, BEAM, STEPS) and tp.dtype == np.int32
    np.testing.assert_array_equal(tp, wp)
    np.testing.assert_allclose(ts, ws, **TOL)
    n = te.compile_count
    assert n == je.compile_count == 1
    te.generate(ctxs[:2])          # the 2-row bucket is new, a replay is not
    te.generate(ctxs[:2])
    assert te.compile_count == 2
    # the batch scheduler drives it unchanged
    sched = GRContinuousScheduler(te, max_batch=4)
    rid = sched.submit(ctxs[0], top_k=3)
    sched.run_until_empty()
    r = sched.get_result(rid)
    assert r["sids"] == tp[0][:3].tolist()


# ------------------------------------------------------------ weights

def hf_tensors(cfg, seed=3):
    """A synthetic HF-layout Qwen3 checkpoint (fp32 numpy)."""
    rng = np.random.default_rng(seed)
    H, Hkv, dh, D, I = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.hidden_size,
                        cfg.intermediate_size)
    r = lambda *s: rng.normal(size=s).astype(np.float32)
    t = {"model.embed_tokens.weight": r(cfg.vocab_size, D), "model.norm.weight": r(D)}
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        t.update({
            pre + "self_attn.q_proj.weight": r(H * dh, D),
            pre + "self_attn.k_proj.weight": r(Hkv * dh, D),
            pre + "self_attn.v_proj.weight": r(Hkv * dh, D),
            pre + "self_attn.o_proj.weight": r(D, H * dh),
            pre + "self_attn.q_norm.weight": r(dh),
            pre + "self_attn.k_norm.weight": r(dh),
            pre + "mlp.gate_proj.weight": r(I, D),
            pre + "mlp.up_proj.weight": r(I, D),
            pre + "mlp.down_proj.weight": r(D, I),
            pre + "input_layernorm.weight": r(D),
            pre + "post_attention_layernorm.weight": r(D),
        })
    return t


def save(tensors, path, dtype):
    from safetensors.torch import save_file

    save_file({k: torch.from_numpy(v).to(dtype).contiguous() for k, v in tensors.items()},
              str(path))


def assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("ckpt_dtype,cfg_dtype", [
    ("fp32", "fp32"), ("bf16", "bf16"), ("fp32", "bf16"), ("bf16", "fp32")])
def test_load_hf_weights_matches_jax(tmp_path, ckpt_dtype, cfg_dtype):
    pytest.importorskip("safetensors.torch")
    dt = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
    tcfg = dataclasses.replace(tq.Qwen3Config.tiny(vocab_size=V), dtype=dt[cfg_dtype][0])
    jcfg = dataclasses.replace(jq.Qwen3Config.tiny(vocab_size=V), dtype=dt[cfg_dtype][1])
    save(hf_tensors(tcfg), tmp_path / "model.safetensors", dt[ckpt_dtype][0])
    got = tq.load_hf_weights(str(tmp_path), tcfg)
    assert_same(got, convert.qwen3_state_dict(tq_jax_tree(jq.load_hf_weights(str(tmp_path),
                                                                             jcfg))))
    model = tq.Qwen3Model(tcfg, device="cpu")
    model.load_state_dict(got)
    logits, _ = model.prefill(torch.zeros((1, 4), dtype=torch.int64), torch.tensor([4]))
    assert torch.isfinite(logits).all()


def test_read_safetensors_refuses_other_dtypes(tmp_path):
    from safetensors.torch import save_file

    save_file({"ids": torch.arange(4)}, str(tmp_path / "ids.safetensors"))
    with pytest.raises(ValueError, match="I64"):
        tq._read_safetensors(str(tmp_path / "ids.safetensors"))


def tq_jax_tree(params):
    return jax.tree.map(np.asarray, params)


def test_load_hf_weights_sharded(tmp_path):
    """A checkpoint split over two files (and one file's tensors out of
    alignment) loads as the single file does."""
    pytest.importorskip("safetensors.torch")
    cfg = dataclasses.replace(tq.Qwen3Config.tiny(vocab_size=V), dtype=torch.bfloat16)
    t = hf_tensors(cfg, seed=7)
    (tmp_path / "one").mkdir()
    (tmp_path / "two").mkdir()
    save(t, tmp_path / "one" / "model.safetensors", torch.bfloat16)
    keys = sorted(t)
    half = len(keys) // 2
    save({k: t[k] for k in keys[:half]},
         tmp_path / "two" / "model-00001-of-00002.safetensors", torch.bfloat16)
    # the second shard mixes dtypes: a bf16 tensor of odd size ahead of fp32 ones
    from safetensors.torch import save_file

    second = {k: torch.from_numpy(t[k]) for k in keys[half:]}
    second["a.odd"] = torch.ones(3, dtype=torch.bfloat16)
    second["a.odd16"] = torch.ones(5, dtype=torch.float16)
    save_file(second, str(tmp_path / "two" / "model-00002-of-00002.safetensors"))
    want = tq.load_hf_weights(str(tmp_path / "one"), cfg)
    got = tq.load_hf_weights(str(tmp_path / "two"), cfg)
    assert_same(got, want)
    raw = tq._read_safetensors(str(tmp_path / "two" / "model-00002-of-00002.safetensors"))
    assert raw["a.odd"].dtype == torch.bfloat16 and raw["a.odd"].tolist() == [1.0] * 3
    assert raw["a.odd16"].dtype == torch.float16 and raw["a.odd16"].tolist() == [1.0] * 5
    for k in keys[half:]:
        assert raw[k].dtype == torch.float32 and np.array_equal(raw[k].numpy(), t[k])
