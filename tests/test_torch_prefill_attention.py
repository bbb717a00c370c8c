"""The causal GQA prefill attention (`ops/prefill_attention.py`).

On the CPU: the plain version is the models' former prefill attention bit
for bit; `prefill_attn_tiled_ref` (kernel Q1's arithmetic: 128-key tiles,
an online softmax, the unnormalised P rounded to the working dtype, one
final division, zero rows past the lengths) against the plain version on
valid rows, for GQA groups 2 and 4, head dims 64 and 128, lengths 1, 127,
128, 129 and the whole bucket, a bucket that is not a multiple of 128;
the tiny Qwen3 and LFM2 models' prefill (last logits, valid rows of every
layer's state) unchanged when the attention zeroes the padded rows as Q1
does; the wrapper's routing and its head-dim padding.

Marked `card` (skipped without CUDA; on the card:
`python3 -m pytest tests/test_torch_prefill_attention.py --noconftest -m card`):
Q1 against the plain version and its tiled arithmetic at the
qwen3_sid_ctx1k cell's shape and lfm2_sid_beam256's, at the edges, the
fp32 kernel, Q1 launched once a layer in a Qwen3-1.7B generate (28, on the
tracer's counter), and a refused launch raising. This file imports no JAX.
"""
import numpy as np
import pytest
import torch

from recsys_examples_torch.models import qwen3
from recsys_examples_torch.models.lfm2_moe import Lfm2MoeConfig, Lfm2MoeModel
from recsys_examples_torch.models.qwen3 import Qwen3Config, Qwen3Model
from recsys_examples_torch.ops import prefill_attention as pa
from recsys_examples_torch.ops.head_dims import instance_head_dim, pad_head_dim, unpad_head_dim
from recsys_examples_torch.utils import observability

FP32 = dict(rtol=1e-5, atol=1e-6)


def operands(B, N, H, Hkv, D, dtype=torch.float32, device="cpu", seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen, device=device).to(dtype)
    return r(B, N, H, D), r(B, N, Hkv, D), r(B, N, Hkv, D)


def former_attention(q, k, v, lengths, dh):
    """`Qwen3Attention`'s prefill attention before the kernel: the mask
    built in `prefill`, GQA by repeated kv heads, fp32 scores and softmax,
    P cast to the working dtype."""
    N = q.shape[1]
    ar = torch.arange(N)
    causal = ar[None, :, None] >= ar[None, None, :]
    valid = ar[None, :] < lengths[:, None]
    mask = causal & valid[:, :, None] & valid[:, None, :]
    G = q.shape[2] // k.shape[2]
    kr, vr = k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) * dh ** -0.5
    sc = torch.where(mask[:, None], sc, sc.new_full((), -1e30))
    p = torch.softmax(sc, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p.float(), vr.float()).to(q.dtype)


def row_rule(got, want, lengths):
    """K7's pass rule (chip_smoke.py BEAM_LIMITS), on each batch row's valid
    rows: the largest error under rtol x max|ref row| + atol and the
    relative L2 error under rel_l2; bf16 rtol 2e-2, atol 1e-3 (the repo's
    kernel rule), rel_l2 8e-3; fp32 1e-4, 1e-5 and 1e-5. The two
    arithmetics round P to bf16 at other points (before the normalisation,
    against a running max), so bf16 outputs differ by a rounding of P."""
    lim = ((2e-2, 1e-3, 8e-3) if want.dtype == torch.bfloat16 else (1e-4, 1e-5, 1e-5))
    for b, n in enumerate(lengths.tolist()):
        n = max(0, min(int(n), got.shape[1]))
        if n == 0:
            continue
        g, w = got[b, :n].float(), want[b, :n].float()
        d = (g - w).abs()
        assert d.max().item() < lim[0] * w.abs().max().item() + lim[1], f"batch row {b}"
        assert (d.norm() / w.norm()).item() < lim[2], f"batch row {b}"


def padded_rows(out, lengths):
    pad = torch.arange(out.shape[1], device=out.device)[None, :] >= lengths[:, None]
    return out[pad]


# ---------------------------------------------------------------- CPU
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_is_the_former_prefill_attention(dtype):
    q, k, v = operands(3, 40, 4, 2, 16, dtype)
    lengths = torch.tensor([40, 17, 1])
    want = former_attention(q, k, v, lengths, 16)
    assert torch.equal(pa.prefill_attn_ref(q, k, v, lengths, 16 ** -0.5), want)
    before = pa.prefill_attn.launches
    assert torch.equal(pa.prefill_attn(q, k, v, lengths, 16 ** -0.5), want)
    assert pa.prefill_attn.launches == before     # a CPU tensor never counts a launch


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,D", [(2, 128), (4, 64), (2, 64), (4, 128)])
def test_tiled_arithmetic_matches_plain_on_valid_rows(G, D, dtype):
    """N 300: three 128-key tiles, the last ragged; lengths at and around
    a tile edge and the whole bucket."""
    N, Hkv = 300, 2
    lengths = torch.tensor([1, 127, 128, 129, N])
    q, k, v = operands(len(lengths), N, G * Hkv, Hkv, D, dtype, seed=G + D)
    got = pa.prefill_attn_tiled_ref(q, k, v, lengths, D ** -0.5)
    want = pa.prefill_attn_ref(q, k, v, lengths, D ** -0.5)
    assert got.dtype == dtype
    if dtype == torch.float32:   # P is not rounded: the two differ in the order of sums
        for b, n in enumerate(lengths.tolist()):
            torch.testing.assert_close(got[b, :n], want[b, :n], **FP32)
    else:
        row_rule(got, want, lengths)
    assert (padded_rows(got, lengths) == 0).all()


def test_tiled_arithmetic_zeroes_a_row_without_context():
    q, k, v = operands(2, 10, 2, 1, 8)
    lengths = torch.tensor([0, 4])
    got = pa.prefill_attn_tiled_ref(q, k, v, lengths, 8 ** -0.5, tile=4)
    assert (got[0] == 0).all() and (got[1, 4:] == 0).all()
    torch.testing.assert_close(got[1, :4], pa.prefill_attn_ref(q, k, v, lengths, 8 ** -0.5)[1, :4],
                               **FP32)


@pytest.mark.parametrize("D", [16, 96])
def test_zero_padded_head_dims_leave_the_output_unchanged(D):
    """The wrapper pads a head dim to the next instance (64 or 128) and
    keeps the caller's sm_scale: zero columns add nothing to a score."""
    d = instance_head_dim(D, pa._HEAD_DIMS)
    q, k, v = operands(2, 33, 4, 2, D)
    lengths = torch.tensor([33, 20])
    got = unpad_head_dim(pa.prefill_attn_ref(pad_head_dim(q, d), pad_head_dim(k, d),
                                             pad_head_dim(v, d), lengths, D ** -0.5), D)
    torch.testing.assert_close(got, pa.prefill_attn_ref(q, k, v, lengths, D ** -0.5), **FP32)


def test_the_wrapper_refuses_what_it_does_not_take():
    q, k, v = operands(1, 4, 2, 1, 8)
    lengths = torch.tensor([4])
    with pytest.raises(ValueError, match="CUDA tensors"):
        pa._launch_cuda(q, k, v, lengths, 1.0)
    meta = torch.empty(1, 4, 2, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pa.prefill_attn(meta, meta[:, :, :1], meta[:, :, :1], lengths, 1.0)


def _tiny(family):
    if family == "qwen3":
        cfg = Qwen3Config.tiny()
        return cfg, Qwen3Model(cfg, device="cpu").init_weights(torch.Generator().manual_seed(7))
    cfg = Lfm2MoeConfig.tiny()
    return cfg, Lfm2MoeModel(cfg, device="cpu").init_weights(torch.Generator().manual_seed(7))


@pytest.mark.parametrize("family", ["qwen3", "lfm2"])
def test_prefill_is_unchanged_when_the_padded_rows_are_zeroed(family, monkeypatch):
    """The tiny models' prefill with the attention swapped for Q1's
    arithmetic (16-key tiles here: three, the last ragged, in a bucket of
    40): the last logits and every layer's state on valid rows stay within
    fp32 noise of the plain version's, though the padded rows' attention
    (the plain version's mean of V, Q1's zeros) and so the padded rows' K/V
    of later layers differ."""
    cfg, model = _tiny(family)
    rng = np.random.default_rng(11)
    lengths = torch.tensor([1, 7, 23, 40])
    tokens = torch.zeros((4, 40), dtype=torch.int64)
    for b, n in enumerate(lengths.tolist()):
        tokens[b, :n] = torch.as_tensor(rng.integers(0, cfg.vocab_size, n))
    with torch.no_grad():
        want_logits, want_state = model.prefill(tokens, lengths)
        monkeypatch.setattr(qwen3, "prefill_attn", lambda q, k, v, lens, scale:
                            pa.prefill_attn_tiled_ref(q, k, v, lens, scale, tile=16))
        got_logits, got_state = model.prefill(tokens, lengths)
    torch.testing.assert_close(got_logits, want_logits, rtol=1e-5, atol=1e-5)
    moved = False
    for got, want in zip(got_state, want_state):
        for g, w in zip(got, want):
            if g.shape[1] != tokens.shape[1]:     # a conv layer's tail: valid positions only
                torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
                continue
            for b, n in enumerate(lengths.tolist()):
                torch.testing.assert_close(g[b, :n], w[b, :n], rtol=1e-5, atol=1e-5)
            moved |= not torch.allclose(padded_rows(g, lengths), padded_rows(w, lengths))
    assert moved, "the padded rows never differed: the comparison would not see a leak"


# ---------------------------------------------------------------- on the card
# The serving cells' prefill attention: B, bucket, context lengths [lo, hi),
# H, Hkv, D (chip_smoke.py PREFILL_CELLS)
CELLS = {"qwen3_sid_ctx1k": (8, 1024, (512, 1017), 16, 8, 128),
         "lfm2_sid_beam256": (8, 256, (128, 253), 32, 8, 64)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# Q1 against its own arithmetic (`prefill_attn_tiled_ref`): per batch row,
# the relative L2 error under 1e-3. Only the fp32 sums' order differs, and a
# P that lies within fp32 noise of a bf16 rounding boundary may round the
# other way (H100, 700 W: 2e-5 to 1e-4 at the cells' shapes and the edges,
# against 2.8e-3 to 2.9e-3 from the plain version, which rounds P after the
# normalisation; PERF.md). Two bf16 ulps of each value
# (tests/test_torch_hstu_pointwise.py's `_bf16_close`) do not hold against
# either: an output that is a sum cancelling to near 0 moves by more than
# two ulps of itself when one P rounds the other way.
TILED_REL_L2 = 1e-3


def _check_q1(q, k, v, lengths):
    scale = q.shape[-1] ** -0.5
    got = pa.prefill_attn(q, k, v, lengths, scale)
    assert torch.equal(got, pa.prefill_attn(q, k, v, lengths, scale))
    row_rule(got, pa.prefill_attn_ref(q, k, v, lengths, scale), lengths)
    tiled = pa.prefill_attn_tiled_ref(q, k, v, lengths, scale)
    row_rule(got, tiled, lengths)
    for b, n in enumerate(lengths.clamp(0, q.shape[1]).tolist()):
        if n and q.dtype == torch.bfloat16:
            g, w = got[b, :n].float(), tiled[b, :n].float()
            assert ((g - w).norm() / w.norm()).item() < TILED_REL_L2, f"batch row {b}"
    assert (padded_rows(got, lengths) == 0).all() and torch.isfinite(got).all()


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_q1_matches_plain_at_the_cell_shape(cuda, cell):
    B, N, (lo, hi), H, Hkv, D = CELLS[cell]
    q, k, v = operands(B, N, H, Hkv, D, torch.bfloat16, cuda, seed=1)
    lengths = torch.as_tensor(np.random.default_rng(2).integers(lo, hi, B), device=cuda)
    before = pa.prefill_attn.launches
    _check_q1(q, k, v, lengths)
    assert pa.prefill_attn.launches - before == 2


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("G,D", [(2, 128), (4, 64), (2, 96)])
def test_q1_at_the_edges(cuda, dtype, G, D):
    """A bucket + 3 (the teacher-forced prefill's), lengths 0, 1 and around
    the 128-row tiles; D 96 runs padded to 128."""
    N, Hkv = 259, 2
    q, k, v = operands(7, N, G * Hkv, Hkv, D, dtype, cuda, seed=G + D)
    _check_q1(q, k, v, torch.tensor([0, 1, 127, 128, 129, 200, N], device=cuda))


@pytest.mark.card
def test_a_qwen3_generate_launches_q1_once_a_layer(cuda):
    from recsys_examples_torch.inference.sid_serving.qwen3_runtime import qwen3_generate_beam

    cfg = Qwen3Config()
    model = Qwen3Model(cfg, device=cuda).init_weights(torch.Generator(device=cuda).manual_seed(3))
    model = model.to(cfg.dtype).eval()
    tokens = torch.randint(0, cfg.vocab_size, (2, 128), device=cuda)
    lengths = torch.tensor([128, 77], device=cuda)
    with observability.tracing():
        observability.reset()
        qwen3_generate_beam(model, tokens, lengths, 4, 8)
        counted = observability.snapshot()["counters"][pa.COUNTER]
    assert counted == cfg.num_layers == 28


@pytest.mark.card
def test_a_refused_launch_raises(cuda):
    q, k, v = operands(1, 8, 2, 1, 64, torch.float16, cuda)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        pa.prefill_attn(q, k, v, torch.tensor([8], device=cuda), 1.0)
    q, k, v = (x.bfloat16() for x in (q, k, v))
    lengths = torch.tensor([8], device=cuda)
    out = torch.empty_like(q)
    assert pa._lib()(0, q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                     out.data_ptr(), 1, 8, 2, 1, 32, 8 * 2 * 64, 2 * 64, 8 * 64, 64, 1.0,
                     torch.cuda.current_stream().cuda_stream) == -1   # no D 32 instance
