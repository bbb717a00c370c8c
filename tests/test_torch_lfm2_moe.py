"""The port's LFM2-MoE backbone (`models/lfm2_moe.py`), its sparse expert
layer (`ops/moe.py`) and the beam runtime's two-kind state against the
plain fp32 reference `bench_port/reference/lfm2_moe_ref.py`, at
`Lfm2MoeConfig.tiny` sizes on the CPU with seeded weights.

Tolerances: both sides compute in fp32 from the same weights, and differ
only in the order of sums (the conv's taps, the experts' combine, the
attention's plain beam version against a dense softmax): logits and
log-probabilities within rtol/atol 1e-4, as the Qwen3 backbone's tests
hold fp32 logits; the expert selection exact. The faulted routings move
the layer's output by orders of magnitude more than 1e-4."""
import numpy as np
import pytest
import torch

from bench_port.reference.lfm2_moe_ref import Lfm2MoeReference
from bench_port.tools import calibrate_routing
from recsys_examples_torch.inference.sid_serving.engine import Qwen3ServingEngine, ServingConfig
from recsys_examples_torch.inference.sid_serving.qwen3_runtime import qwen3_generate_beam
from recsys_examples_torch.inference.sid_serving.scheduler import GRContinuousScheduler
from recsys_examples_torch.models.lfm2_moe import Lfm2MoeConfig, Lfm2MoeModel
from recsys_examples_torch.ops import moe

TOL = dict(rtol=1e-4, atol=1e-4)
STEPS, BEAM = 4, 4


def ref_config(cfg: Lfm2MoeConfig) -> dict:
    """The config under the published (HF) keys the reference reads."""
    return {"num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
            "norm_eps": cfg.rms_norm_eps, "rope_parameters": {"rope_theta": cfg.rope_theta},
            "layer_types": list(cfg.layer_types), "num_dense_layers": cfg.num_dense_layers,
            "conv_L_cache": cfg.conv_L_cache, "num_experts_per_tok": cfg.num_experts_per_tok,
            "norm_topk_prob": cfg.norm_topk_prob,
            "routed_scaling_factor": cfg.routed_scaling_factor,
            "use_expert_bias": cfg.use_expert_bias}


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny shapes: one intra-op thread is fastest, and keeps the test's
    time when other test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    cfg = Lfm2MoeConfig.tiny()
    gen = torch.Generator().manual_seed(19)
    model = Lfm2MoeModel(cfg, device="cpu").init_weights(gen).eval()
    ref = Lfm2MoeReference(ref_config(cfg), model.state_dict())
    return cfg, model, ref


def contexts(cfg, lengths, seed=3):
    rng = np.random.default_rng(seed)
    N = max(lengths)
    tokens = np.zeros((len(lengths), N), np.int64)
    for i, n in enumerate(lengths):
        tokens[i, :n] = rng.integers(0, cfg.vocab_size, n)
    return tokens, np.asarray(lengths, np.int64)


def test_prefill_last_logits(pair):
    cfg, model, ref = pair
    tokens, lens = contexts(cfg, [1, 2, 5, 11])
    with torch.no_grad():
        got, _ = model.prefill(torch.as_tensor(tokens), torch.as_tensor(lens))
    for b, n in enumerate(lens):
        want, _ = ref.prefill(torch.as_tensor(tokens[b, :n]))
        torch.testing.assert_close(got[b], want, **TOL)


def test_every_decode_steps_logits_through_the_beam_state(pair):
    """Each decode step's log-probabilities, for every beam, against the
    reference's full forward over context + the beam's path; contexts of
    1, 2 and 3 tokens take the conv's previous rows from the context tail,
    zeros before position 0, and the ancestry."""
    cfg, model, ref = pair
    tokens, lens = contexts(cfg, [1, 2, 3, 13])
    seen = []

    def record(h, logp, paths):
        seen.append((h, logp.clone(), paths.clone()))
        return logp

    qwen3_generate_beam(model, tokens, lens, STEPS, BEAM, logits_processor=record)
    assert [h for h, _, _ in seen] == list(range(STEPS))
    for h, logp, paths in seen[1:]:
        for b, n in enumerate(lens):
            for w in range(BEAM):
                seq = torch.cat([torch.as_tensor(tokens[b, :n]), paths[b, w, :h]])
                last, _ = ref.prefill(seq)
                torch.testing.assert_close(logp[b, w], torch.log_softmax(last, -1), **TOL)


def test_serving_engine_and_scheduler_take_the_model(pair):
    cfg, model, _ = pair
    eng = Qwen3ServingEngine(model, ServingConfig(beam_width=BEAM, ctx_buckets=(16,),
                                                  batch_buckets=(1, 2)), num_steps=STEPS)
    sched = GRContinuousScheduler(eng, max_batch=2)
    tokens, lens = contexts(cfg, [3, 7])
    rids = [sched.submit(tokens[i, :n], top_k=2) for i, n in enumerate(lens)]
    sched.tick()
    paths, scores = qwen3_generate_beam(model, tokens, lens, STEPS, BEAM)
    for i, rid in enumerate(rids):
        r = sched.get_result(rid)
        assert [list(p) for p in r["sids"]] == paths[i, :2].tolist()
        np.testing.assert_allclose(r["scores"], scores[i, :2].numpy(), rtol=1e-5, atol=1e-5)


def _moe_case(cfg, model, li=2, rows=64, seed=5):
    ff = model.layers[li].feed_forward
    x = torch.randn(rows, cfg.hidden_size, generator=torch.Generator().manual_seed(seed))
    return ff, x


def test_moe_layer_biased_selection(pair):
    """The selection equals the reference's exactly, the bias changes it for
    some rows, and the layer's output matches."""
    cfg, model, ref = pair
    ff, x = _moe_case(cfg, model)
    w, e = moe.route(x, ff.gate.weight, ff.expert_bias, cfg.num_experts_per_tok)
    rw, re_ = ref.route(2, x)
    assert torch.equal(e.sort(-1).values, re_.sort(-1).values)
    torch.testing.assert_close(w.gather(1, e.argsort(-1)), rw.gather(1, re_.argsort(-1)), **TOL)
    _, unbiased = moe.route(x, ff.gate.weight, None, cfg.num_experts_per_tok)
    changed = (unbiased.sort(-1).values != e.sort(-1).values).any(-1)
    assert 0 < int(changed.sum()) < x.shape[0]
    with torch.no_grad():
        torch.testing.assert_close(ff(x), ref.moe(2, x), **TOL)


@pytest.mark.parametrize("fault", calibrate_routing.FAULTS)
def test_moe_layer_routing_faults_fail(pair, fault, monkeypatch):
    """Weights taken from the biased scores, or experts selected by the
    unbiased ones, fail the layer's comparison."""
    cfg, model, ref = pair
    ff, x = _moe_case(cfg, model)
    monkeypatch.setattr(moe, "route", calibrate_routing.faulted_route(fault, moe.route))
    with torch.no_grad():
        err = (ff(x) - ref.moe(2, x)).abs().max()
    assert err > 1e-2, err


def test_grouped_gemm_plain_path_with_empty_experts():
    """Experts 0, 2 and 5 get no rows; the plain version equals a row-by-row
    product with each row's own expert, in both epilogues."""
    g = torch.Generator().manual_seed(1)
    E, K, N = 6, 32, 16
    rows_of = [0, 3, 0, 5, 1, 0]
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(rows_of)]), dtype=torch.int32)
    M = int(offsets[-1])
    expert = torch.repeat_interleave(torch.arange(E), torch.tensor(rows_of))
    a = torch.randn(M, K, generator=g)
    w13 = torch.randn(E, 2 * N, K, generator=g)
    w2 = torch.randn(E, K, N, generator=g)
    h = moe.grouped_gemm(a, w13, offsets, "swiglu")
    p = torch.einsum("mk,mnk->mn", a, w13[expert])
    torch.testing.assert_close(h, torch.nn.functional.silu(p[:, :N]) * p[:, N:], **TOL)
    scale = torch.rand(M, generator=g)
    dst = torch.randperm(M, generator=g)
    y = moe.grouped_gemm(h, w2, offsets, "scatter", row_scale=scale, dst_rows=dst)
    want = torch.zeros(M, K)
    want[dst] = torch.einsum("mn,mkn->mk", h, w2[expert]) * scale[:, None]
    torch.testing.assert_close(y, want, **TOL)


def test_permute_sorts_rows_by_expert():
    experts = torch.tensor([[3, 1], [1, 0], [3, 2]])
    order, offsets = moe.permute(experts, 5)
    assert offsets.tolist() == [0, 1, 3, 4, 6, 6]
    assert experts.reshape(-1)[order].tolist() == [0, 1, 1, 2, 3, 3]
    assert order.tolist() == [3, 1, 2, 5, 0, 4]     # stable: slot order within an expert
