"""The bf16 beam-decode attention kernel's plan (K7): the plain statements in
`ops/beam_decode_attention.py` that `csrc/beam_decode_attention.cu` copies
line by line. The row tiles cover every (query head, beam) row of a (batch
row, kv head) exactly once, in even shares; the ranks of a cluster take the
context chunks in order, each once, and one rank takes the tail; the split
follows the card's cluster capacity. Through `beam_decode_attn_split_ref`
(the kernel's arithmetic: an online softmax per rank over its chunks, the
states merged in rank order) against the JAX package's `beam_decode_attn`,
its Pallas kernel in interpret mode and its jnp twin. Inputs come from numpy
with a fixed seed and go to both sides.

Tolerances: fp32 inputs (neither side rounds P) agree per row to
FP32_RTOL * max|row| + FP32_ATOL, and per batch row to a relative L2 of
FP32_REL_L2 (the merge and the chunking change only the order of fp32 sums).
bf16 inputs (the kernel rounds P to bf16 before P V, as the Pallas kernel
rounds P to V's dtype) are held to chip_smoke.py's BEAM_LIMITS for bf16:
2e-2 * max|row| + 1e-3 per row and a relative L2 of 8e-3 per batch row."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from recsys_examples_torch.ops.beam_decode_attention import (
    BEAM_CHUNK,
    BEAM_CTA_ROWS,
    MAX_SPLITS,
    beam_batch_order,
    beam_decode_attn,
    beam_cta_chunks,
    beam_cta_rows,
    beam_decode_attn_ref,
    beam_decode_attn_split_ref,
    beam_row_tiles,
    beam_split_plan,
)
from recsys_examples_tpu.ops.pallas.beam_decode_attention import (
    beam_decode_attn as j_attn,
    beam_decode_attn_ref as j_ref,
)

FP32_RTOL, FP32_ATOL, FP32_REL_L2 = 2e-4, 2e-5, 1e-4
BF16_RTOL, BF16_ATOL, BF16_REL_L2 = 2e-2, 1e-3, 8e-3

# clusters of 1-16 CTAs of 384 threads at one CTA per SM that an H100 holds
# at once (the same count for K6's instances, PERF.md §6)
H100_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15, 9: 9, 10: 7, 11: 7,
                 12: 7, 13: 7, 14: 7, 15: 7, 16: 7}


@settings(max_examples=300, deadline=None)
@given(W=st.integers(1, 600), G=st.sampled_from([1, 2, 3, 4, 8]),
       cta_rows=st.sampled_from([BEAM_CTA_ROWS, 2 * BEAM_CTA_ROWS]))
def test_row_tiles_cover_each_row_once_in_even_shares(W, G, cta_rows):
    tiles = beam_row_tiles(W, G, cta_rows)
    spans = [beam_cta_rows(t, tiles, W, G) for t in range(tiles)]
    rows = [r for r0, r1 in spans for r in range(r0, r1)]
    assert rows == list(range(G * W))
    # row r is beam r // G of the group's query head r % G: every pair once
    pairs = {(r // G, r % G) for r in rows}
    assert len(pairs) == G * W and pairs == {(w, g) for w in range(W) for g in range(G)}
    sizes = [r1 - r0 for r0, r1 in spans]
    assert max(sizes) <= cta_rows and max(sizes) - min(sizes) <= 1
    # fewest tiles, and none with a handful of rows while another is full
    assert tiles == 1 or G * W > (tiles - 1) * cta_rows
    assert tiles == 1 or min(sizes) >= cta_rows // 2


@settings(max_examples=300, deadline=None)
@given(lens=st.lists(st.integers(-3, 1100), min_size=1, max_size=40),
       S=st.sampled_from([1, 64, 1025]))
def test_batch_order_is_longest_first(lens, S):
    """Each CTA ranks the batch rows by their context (clipped to [0, S]),
    longest first, ties by index: a permutation, the same as a stable sort."""
    order = beam_batch_order(lens, S)
    clip = [max(0, min(x, S)) for x in lens]
    assert sorted(order) == list(range(len(lens)))
    assert order == sorted(range(len(lens)), key=lambda i: (-clip[i], i))


@settings(max_examples=300, deadline=None)
@given(n_ctx=st.integers(0, 40), N=st.integers(0, 3), splits=st.integers(1, MAX_SPLITS))
def test_ranks_tile_the_context_and_one_takes_the_tail(n_ctx, N, splits):
    ranges = [beam_cta_chunks(r, splits, n_ctx, N) for r in range(splits)]
    chunks = [c for b, e, _ in ranges for c in range(b, e)]
    assert chunks == list(range(n_ctx))
    tails = [r for r, (_, _, tail) in enumerate(ranges) if tail]
    assert tails == ([splits - 1] if N else [])
    # an even share of the n_ctx + N units: the tail's steps count on the last rank
    units = [e - b + (N if tail else 0) for b, e, tail in ranges]
    share = -(-(n_ctx + N) // splits)
    assert all(u <= share for u in units[:-1])
    assert units[-1] <= max(share, N)


def test_plan_follows_the_cards_clusters():
    """No split at phase 10's and 11's B 16 step (256 clusters: two waves
    already); at B 1 the largest split whose 16 clusters fit in one wave
    (6: 17 clusters of 6 fit, 15 of 7 do not); at most the units a (batch
    row, kv head) can have."""
    h100 = H100_CLUSTERS.__getitem__
    b16 = beam_split_plan(16, 200, 8, 8, 1025, 3, h100)
    assert (b16.splits, b16.tiles, b16.grid) == (1, 2, (1, 2, 128))
    b1 = beam_split_plan(1, 200, 8, 8, 1025, 3, h100)
    assert (b1.splits, b1.tiles, b1.grid) == (6, 2, (6, 2, 8))
    # GQA: 8 query heads on 2 kv heads share a CTA's context pass
    gqa = beam_split_plan(1, 200, 8, 2, 1025, 3, h100)
    assert (gqa.splits, gqa.tiles, gqa.grid) == (8, 7, (8, 7, 2))
    assert beam_split_plan(1, 7, 2, 2, 100, 1, h100).splits == 3   # 2 chunks + 1 step
    assert beam_split_plan(1, 7, 2, 2, 100, 0, h100).splits == 2
    assert beam_split_plan(1, 64, 2, 2, 5000, 3, h100).splits == 16
    assert beam_split_plan(1, 64, 2, 2, 5000, 3, h100, cta_rows=2 * BEAM_CTA_ROWS).tiles == 1


def _case(seed, B, W, H, Hkv, D, S, N, ctx_lens):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    case = dict(q=f(B, W, H, D), k_ctx=f(B, S, Hkv, D), v_ctx=f(B, S, Hkv, D),
                ctx_lens=np.asarray(ctx_lens, np.int32), k_beam=None, v_beam=None,
                ancestry=None)
    if N:   # random, non-identity ancestry: several beams share a slot
        case.update(k_beam=f(B, N, W, Hkv, D), v_beam=f(B, N, W, Hkv, D),
                    ancestry=rng.integers(0, W, size=(B, N, W)).astype(np.int32))
    return case


ORDER = ("q", "k_ctx", "v_ctx", "ctx_lens", "k_beam", "v_beam", "ancestry")


def _within(got, want, rtol, atol, rel_l2):
    """Per (b, w, h) row: max error below rtol * max|row| + atol; per batch
    row: relative L2 below rel_l2 (rows with no key are exact zeros on both
    sides and count as 0)."""
    err = np.abs(got - want).max(-1)
    assert (err <= rtol * np.abs(want).max(-1) + atol).all(), err.max()
    num = np.linalg.norm((got - want).reshape(len(got), -1), axis=1)
    den = np.maximum(np.linalg.norm(want.reshape(len(want), -1), axis=1), 1e-30)
    assert (num / den <= rel_l2).all(), (num / den).max()


# (G, N, W, ctx_lens): GQA 1, 2 and 4, N 0-3, W 1, 7, 65 and 200, empty
# contexts, contexts around a 64-key chunk edge and the full S
CASES = [
    (1, 0, 1, [0, 150]), (1, 1, 7, [0, 64]), (1, 2, 65, [65, 1]), (1, 3, 200, [150, 63]),
    (2, 0, 7, [129, 0]), (2, 1, 65, [0, 0]), (2, 2, 200, [64, 150]), (2, 3, 1, [1, 127]),
    (4, 0, 65, [0, 128]), (4, 1, 200, [63, 65]), (4, 2, 1, [150, 0]), (4, 3, 7, [0, 1]),
]


@pytest.mark.parametrize("G,N,W,ctx_lens", CASES)
def test_split_matches_jax(G, N, W, ctx_lens):
    """fp32: the kernel's arithmetic split 1, 3 and 16 ways against the
    Pallas kernel in interpret mode, and against the jnp twin on the rows
    that have a key (the twin returns the mean of V for a row with none,
    the kernel and the port zero)."""
    Hkv, D, S = 2, 32, 150
    case = _case(sum(ctx_lens) + 7 * G + N, 2, W, G * Hkv, Hkv, D, S, N, ctx_lens)
    scale = D ** -0.5
    jin = [None if case[k] is None else jnp.asarray(case[k]) for k in ORDER]
    kernel = np.asarray(j_attn(*jin, sm_scale=scale, backend="pallas", interpret=True,
                               block_ctx=128))
    twin = np.asarray(j_ref(*jin, sm_scale=scale))
    tin = [None if case[k] is None else torch.from_numpy(case[k]) for k in ORDER]
    keyed = (np.asarray(ctx_lens) > 0) | (N > 0)
    for splits in (1, 3, 16):
        got = beam_decode_attn_split_ref(*tin, scale, splits=splits)
        assert got.dtype == torch.float32
        got = got.numpy()
        _within(got, kernel, FP32_RTOL, FP32_ATOL, FP32_REL_L2)
        _within(got[keyed], twin[keyed], FP32_RTOL, FP32_ATOL, FP32_REL_L2)
        assert not got[~keyed].any()


@pytest.mark.parametrize("G,N,W,ctx_lens", [CASES[3], CASES[6], CASES[9]])
def test_split_matches_pallas_interpret_bf16(G, N, W, ctx_lens):
    """bf16 q, K and V (the kernel's inputs): the split arithmetic, which
    rounds P to bf16 before P V, against the Pallas kernel in interpret mode
    on the same bf16 values, at the bf16 limits; and against the port's
    plain version."""
    Hkv, D, S = 2, 32, 150
    case = _case(3 * G + N, 2, W, G * Hkv, Hkv, D, S, N, ctx_lens)
    tin = [None if case[k] is None else torch.from_numpy(case[k]) for k in ORDER]
    tin = [t.bfloat16() if t is not None and t.is_floating_point() else t for t in tin]
    jin = [None if t is None else jnp.asarray(t.float().numpy()) for t in tin]
    jin = [t.astype(jnp.bfloat16) if t is not None and t.dtype == jnp.float32 else t
           for t in jin]
    scale = D ** -0.5
    kernel = np.asarray(j_attn(*jin, sm_scale=scale, backend="pallas", interpret=True,
                               block_ctx=128), np.float32)
    plain = beam_decode_attn_ref(*tin, sm_scale=scale).float().numpy()
    for splits in (1, 4):
        got = beam_decode_attn_split_ref(*tin, scale, splits=splits)
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        _within(got, kernel, BF16_RTOL, BF16_ATOL, BF16_REL_L2)
        _within(got, plain, BF16_RTOL, BF16_ATOL, BF16_REL_L2)



@pytest.mark.parametrize("N", [0, 2])
def test_split_without_context_positions(N):
    """S 0 (no context position at all): the tail alone against the jnp
    twin, and no key at all (N 0) as zeros; split 1 and 3 ways, and through
    the wrapper's CPU path (the plain version)."""
    G, Hkv, D, W = 2, 2, 32, 7
    case = _case(11 + N, 2, W, G * Hkv, Hkv, D, 0, N, [0, 5])
    tin = [None if case[k] is None else torch.from_numpy(case[k]) for k in ORDER]
    scale = D ** -0.5
    plain = beam_decode_attn(*tin, sm_scale=scale).numpy()
    if N:
        jin = [jnp.asarray(case[k]) for k in ORDER]
        want = np.asarray(j_ref(*jin, sm_scale=scale))
        _within(plain, want, FP32_RTOL, FP32_ATOL, FP32_REL_L2)
    else:
        want = np.zeros_like(plain)
        assert not plain.any()
    for splits in (1, 3):
        got = beam_decode_attn_split_ref(*tin, scale, splits=splits).numpy()
        _within(got, want, FP32_RTOL, FP32_ATOL, FP32_REL_L2)


@pytest.mark.parametrize("G,N", [(1, 3), (4, 1)])
def test_split_with_a_context_broadcast_over_the_batch(G, N):
    """A context shared by every batch row as a view of batch stride 0 (the
    kernel reads it through one batch of its map): the split arithmetic
    against the Pallas kernel in interpret mode on the materialised
    context."""
    Hkv, D, S, W = 2, 32, 150, 65
    case = _case(5 * G + N, 3, W, G * Hkv, Hkv, D, S, N, [150, 1, 64])
    for k in ("k_ctx", "v_ctx"):
        case[k] = np.ascontiguousarray(np.broadcast_to(case[k][:1], case[k].shape))
    jin = [jnp.asarray(case[k]) for k in ORDER]
    scale = D ** -0.5
    kernel = np.asarray(j_attn(*jin, sm_scale=scale, backend="pallas", interpret=True,
                               block_ctx=128))
    tin = [torch.from_numpy(case[k]) for k in ORDER]
    for i in (1, 2):
        tin[i] = tin[i][:1].expand(3, S, Hkv, D)
        assert tin[i].stride(0) == 0
    for splits in (1, 4):
        got = beam_decode_attn_split_ref(*tin, scale, splits=splits).numpy()
        _within(got, kernel, FP32_RTOL, FP32_ATOL, FP32_REL_L2)


@pytest.mark.parametrize("D, d", [(16, 32), (48, 64), (96, 128), (160, 256), (200, 256),
                                  (256, 256)])
def test_head_dim_padding(D, d):
    """K7 is built for head dims 32, 64, 128 and 256; its wrapper zero-pads
    any other head dim to the next one with sm_scale as the caller gave it.
    The padded plain version (GQA, a beam tail) equals the unpadded one on
    the first D columns (to 1e-5: the einsums' fp32 sums change order with
    the width) and is zero past them."""
    from recsys_examples_torch.ops.beam_decode_attention import _HEAD_DIMS
    from recsys_examples_torch.ops.head_dims import instance_head_dim, pad_head_dim

    assert instance_head_dim(D, _HEAD_DIMS) == d
    rng = np.random.default_rng(D)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    B, W, H, Hkv, S, N = 2, 3, 4, 2, 7, 2
    args = [f(B, W, H, D), f(B, S, Hkv, D), f(B, S, Hkv, D), torch.tensor([5, 7]),
            f(B, N, W, Hkv, D), f(B, N, W, Hkv, D),
            torch.from_numpy(rng.integers(0, W, (B, N, W)))]
    want = beam_decode_attn_ref(*args, sm_scale=0.3)
    padded = [pad_head_dim(x, d) if x.is_floating_point() else x for x in args]
    got = beam_decode_attn_ref(*padded, sm_scale=0.3)
    assert not got[..., D:].any()
    torch.testing.assert_close(got[..., :D], want, rtol=1e-5, atol=1e-5)
