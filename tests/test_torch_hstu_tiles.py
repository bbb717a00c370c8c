"""The tile plans of the forward K1 and the backward kernels K2 (dq) and K3
(dk/dv): the plain statements in `ops/hstu_attention_ref.py` that
`csrc/hstu_mask.cuh` copies line by line. Held against the dense mask of
`get_valid_attn_mask` (a tile certified interior is all valid; the tiles a
CTA or consumer visits cover every valid pair, the tiles it skips hold none)
and against the JAX kernel's own `_tile_fully_valid` and `_kv_extent` on the
same scalars."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from recsys_examples_torch.ops.hstu_attention_ref import (
    BWD_TILE,
    FWD_ROWS,
    causal_edge,
    causal_edge_valid,
    dkv_query_tiles,
    fwd_cta_tiles,
    fwd_tiles,
    get_valid_attn_mask,
    kv_tile_end,
    tile_fully_valid,
)
from recsys_examples_tpu.ops.pallas.hstu_attention import _kv_extent, _tile_fully_valid


@st.composite
def sequences(draw, overlap=True):
    """One sequence and a mask family: length 0-300, contextual rows, targets
    in groups of 1-3, causal or not, a window with or without a min-full
    tail, and a tile height (the kernels' 64, or smaller to visit more
    tiles). Without `overlap`, contextual and target rows fit in n."""
    n = draw(st.integers(0, 300))
    has_ctx, has_tgt = draw(st.booleans()), draw(st.booleans())
    c = draw(st.integers(0, n)) if has_ctx else 0
    t = draw(st.integers(0, n if overlap else n - c)) if has_tgt else 0
    window = draw(st.sampled_from([0, 0, 1, 7, 64]))
    return dict(
        n=n, c=c, t=t, has_ctx=has_ctx, has_tgt=has_tgt,
        group=draw(st.integers(1, 3)), causal=draw(st.booleans()), window=window,
        min_full=draw(st.sampled_from([0, 5, 64])) if window else 0,
        rows=draw(st.sampled_from([4, 16, BWD_TILE])))


def _dense(sq):
    """[n_pad, n_pad] validity of the sequence, padded with False to whole
    tiles."""
    n, rows = sq["n"], sq["rows"]
    n_pad = -(-max(n, 1) // rows) * rows
    out = np.zeros((n_pad, n_pad), bool)
    if n:
        one = lambda x: torch.tensor([x])
        m = get_valid_attn_mask(
            sq["causal"], n, one(n),
            num_targets=one(sq["t"]) if sq["has_tgt"] else None,
            max_attn_len=sq["window"],
            num_contextuals=one(sq["c"]) if sq["has_ctx"] else None,
            min_full_attn_seq_len=sq["min_full"], target_group_size=sq["group"])
        out[:n, :n] = m[0].numpy()
    return out


def _plan_kw(sq):
    return dict(causal=sq["causal"], has_context=sq["has_ctx"])


def _check_causal_edge(sq, valid):
    """Where `causal_edge` holds, its form is the dense mask pair for pair
    (the padding included)."""
    n, c = sq["n"], sq["c"]
    if causal_edge(n, c, causal=sq["causal"], has_targets=sq["has_tgt"],
                   max_attn_len=sq["window"]):
        r = np.arange(valid.shape[0])[:, None]
        assert (causal_edge_valid(r, r.T, n, c) == valid).all()


def _check_plan(sq):
    valid, rows, n, c, t = _dense(sq), sq["rows"], sq["n"], sq["c"], sq["t"]
    _check_causal_edge(sq, valid)
    starts = range(0, n, rows)
    for q0 in starts:
        for k0 in starts:
            if tile_fully_valid(q0, k0, n, c, t, rows, causal=sq["causal"],
                                max_attn_len=sq["window"]):
                assert valid[q0:q0 + rows, k0:k0 + rows].all(), (q0, k0)
    # K2: no valid pair of a query tile lies past its key extent
    for q0 in starts:
        end = kv_tile_end(q0, n, c, rows, **_plan_kw(sq))
        assert 0 < end <= n and not valid[q0:q0 + rows, end:].any(), q0
    # K3: the listed query tiles (distinct, inside the sequence) hold every
    # query row with a valid pair in the key tile
    for k0 in starts:
        tiles = dkv_query_tiles(k0, n, c, rows, **_plan_kw(sq))
        assert len(set(tiles)) == len(tiles) and all(0 <= r < n for r in tiles), tiles
        seen = np.zeros(valid.shape[0], bool)
        for r in tiles:
            seen[r:r + rows] = True
        assert not (valid[:, k0:k0 + rows].any(axis=1) & ~seen).any(), k0


@settings(max_examples=150, deadline=None)
@given(sequences())
def test_tile_plan_against_dense_mask(sq):
    _check_plan(sq)


@settings(max_examples=100, deadline=None)
@given(st.integers(0, 300), st.data())
def test_causal_edge_form_matches_dense_mask(n, data):
    """bench.py's configuration (causal, contextual rows, no targets, no
    window): every edge tile takes the causal form, and it is the mask."""
    has_ctx = data.draw(st.booleans())
    sq = dict(n=n, c=data.draw(st.integers(0, n)) if has_ctx else 0, t=0, has_ctx=has_ctx,
              has_tgt=False, group=1, causal=True, window=0, min_full=0, rows=BWD_TILE)
    assert causal_edge(n, sq["c"], causal=True, has_targets=False, max_attn_len=0)
    _check_causal_edge(sq, _dense(sq))


def test_causal_edge_needs_its_conditions():
    """Targets, a window, a non-causal mask or more contextual rows than the
    sequence holds each turn the causal form off."""
    kw = dict(causal=True, has_targets=False, max_attn_len=0)
    assert causal_edge(100, 3, **kw)
    for change in (dict(causal=False), dict(has_targets=True), dict(max_attn_len=8)):
        assert not causal_edge(100, 3, **{**kw, **change})
    assert not causal_edge(100, 101, **kw) and not causal_edge(100, -1, **kw)


# lengths at the kernels' tile edges, contextual rows across a tile edge,
# targets in groups, and sequences whose off-diagonal tiles are all interior
EDGE_CASES = [
    dict(n=n, c=0, t=0, has_ctx=False, has_tgt=False, group=1, causal=True, window=0,
         min_full=0, rows=BWD_TILE) for n in (63, 64, 65, 127, 128, 129, 256)
] + [
    dict(n=200, c=70, t=0, has_ctx=True, has_tgt=False, group=1, causal=True, window=0,
         min_full=0, rows=BWD_TILE),
    dict(n=300, c=70, t=40, has_ctx=True, has_tgt=True, group=2, causal=True, window=0,
         min_full=0, rows=BWD_TILE),
    dict(n=290, c=3, t=31, has_ctx=True, has_tgt=True, group=3, causal=True, window=64,
         min_full=64, rows=BWD_TILE),
    dict(n=129, c=0, t=0, has_ctx=False, has_tgt=False, group=1, causal=False, window=0,
         min_full=0, rows=BWD_TILE),
]


@pytest.mark.parametrize("sq", EDGE_CASES,
                         ids=[f"n{s['n']}_c{s['c']}_t{s['t']}_w{s['window']}"
                              f"{'' if s['causal'] else '_noncausal'}" for s in EDGE_CASES])
def test_tile_plan_at_tile_edges(sq):
    _check_plan(sq)


def test_interior_tiles_of_whole_tile_sequences():
    """A causal sequence of whole tiles without targets: every tile below the
    diagonal is certified, and none on it."""
    n = 4 * BWD_TILE
    for q0 in range(0, n, BWD_TILE):
        for k0 in range(0, q0 + 1, BWD_TILE):
            assert tile_fully_valid(q0, k0, n, 3, 0, causal=True, max_attn_len=0) == (k0 < q0)


@settings(max_examples=60, deadline=None)
@given(sequences(overlap=False))
def test_tile_plan_matches_jax_predicates(sq):
    """Where contextual and target rows fit in the sequence, the certificate
    and K2's extent are JAX's, scalar for scalar."""
    n, c, t, rows = sq["n"], sq["c"], sq["t"], sq["rows"]
    for q0 in range(0, n, rows):
        want = _kv_extent(jnp.int32(q0), jnp.int32(n), jnp.int32(c), rows,
                          causal=sq["causal"], has_context=sq["has_ctx"])
        assert kv_tile_end(q0, n, c, rows, **_plan_kw(sq)) == int(want)
        for k0 in range(0, n, rows):
            full = _tile_fully_valid(jnp.int32(q0), jnp.int32(k0), jnp.int32(n),
                                     jnp.int32(t), rows, rows, causal=sq["causal"],
                                     max_attn_len=sq["window"], has_targets=sq["has_tgt"])
            want = False if full is None else bool(full)
            assert tile_fully_valid(q0, k0, n, c, t, rows, causal=sq["causal"],
                                    max_attn_len=sq["window"]) == want, (q0, k0)


# ------------------------------------------------------------ K1
def _fwd_plan(sq):
    """K1's plan of one sequence, CTA by CTA: (m0, the CTA's key tiles, and
    per consumer (q0, its key tiles))."""
    n, c, kw = sq["n"], sq["c"], _plan_kw(sq)
    for m0 in range(0, n, FWD_ROWS):
        consumers = [(q0, fwd_tiles(q0, n, c, **kw)) for q0 in (m0, m0 + BWD_TILE)]
        yield m0, fwd_cta_tiles(m0, n, c, **kw), consumers


def _check_fwd_plan(sq):
    """Every valid pair of a consumer's rows lies in the key tiles it
    computes, every tile of the CTA it skips holds none, and the CTA walks
    exactly as far as its furthest consumer."""
    valid = _dense({**sq, "rows": FWD_ROWS})
    for m0, n_cta, consumers in _fwd_plan(sq):
        assert n_cta == max(k for _, k in consumers), m0
        for q0, mine in consumers:
            rows = valid[q0:q0 + BWD_TILE]
            assert 0 <= mine <= n_cta, (q0, mine, n_cta)
            # the tiles it skips, and every column past them, hold no valid pair
            assert not rows[:, mine * BWD_TILE:].any(), (q0, mine)
            for k0 in range(0, mine * BWD_TILE, BWD_TILE):
                if tile_fully_valid(q0, k0, sq["n"], sq["c"], sq["t"], causal=sq["causal"],
                                    max_attn_len=sq["window"]):
                    assert rows[:, k0:k0 + BWD_TILE].all(), (q0, k0)


@settings(max_examples=150, deadline=None)
@given(sequences())
def test_fwd_tile_plan_against_dense_mask(sq):
    _check_fwd_plan(sq)


# K1's 128-row CTA at its edges: lengths around 64, 128 and 192 rows (193
# leaves consumer 1 of the second CTA without rows), contextual rows across
# the consumer boundary (c 70) and past the CTA (c 130)
FWD_EDGE_CASES = [
    dict(n=n, c=0, t=0, has_ctx=False, has_tgt=False, group=1, causal=True, window=0,
         min_full=0, rows=BWD_TILE) for n in (63, 64, 65, 127, 128, 129, 191, 192, 193)
] + [
    dict(n=n, c=c, t=0, has_ctx=True, has_tgt=False, group=1, causal=True, window=0,
         min_full=0, rows=BWD_TILE) for n, c in ((200, 70), (300, 130), (129, 70))
] + [
    dict(n=300, c=70, t=40, has_ctx=True, has_tgt=True, group=2, causal=True, window=0,
         min_full=0, rows=BWD_TILE),
    dict(n=193, c=0, t=0, has_ctx=False, has_tgt=False, group=1, causal=False, window=0,
         min_full=0, rows=BWD_TILE),
]


@pytest.mark.parametrize("sq", FWD_EDGE_CASES,
                         ids=[f"n{s['n']}_c{s['c']}_t{s['t']}"
                              f"{'' if s['causal'] else '_noncausal'}" for s in FWD_EDGE_CASES])
def test_fwd_tile_plan_at_cta_edges(sq):
    _check_fwd_plan(sq)


def test_fwd_consumer_tiles_under_causal():
    """Without contextual rows consumer 0 skips the CTA's last key tile (it
    lies above its rows), consumer 1 computes every tile; with contextual
    rows in consumer 0's range it walks to the end; a consumer whose rows
    lie past the sequence computes nothing."""
    kw = dict(causal=True, has_context=False)
    n = 3 * FWD_ROWS
    for m0 in range(0, n, FWD_ROWS):
        n_cta = fwd_cta_tiles(m0, n, 0, **kw)
        assert fwd_tiles(m0, n, 0, **kw) == n_cta - 1
        assert fwd_tiles(m0 + BWD_TILE, n, 0, **kw) == n_cta
    ctx = dict(causal=True, has_context=True)
    assert fwd_tiles(0, n, 3, **ctx) == fwd_cta_tiles(0, n, 3, **ctx) == n // BWD_TILE
    assert fwd_tiles(BWD_TILE, n, 3, **ctx) == 2
    assert fwd_tiles(BWD_TILE, 64, 0, **kw) == 0 and fwd_cta_tiles(0, 64, 0, **kw) == 1


@settings(max_examples=60, deadline=None)
@given(sequences(overlap=False))
def test_fwd_tile_plan_matches_jax_predicates(sq):
    """Where contextual and target rows fit in the sequence: the CTA's extent
    is JAX's `_kv_extent` at BQ = 128, and each consumer's certificate of
    each tile it computes is JAX's `_tile_fully_valid` at 64 rows."""
    n, c, t = sq["n"], sq["c"], sq["t"]
    for m0, n_cta, consumers in _fwd_plan(sq):
        want = _kv_extent(jnp.int32(m0), jnp.int32(n), jnp.int32(c), FWD_ROWS,
                          causal=sq["causal"], has_context=sq["has_ctx"])
        assert n_cta == -(-int(want) // BWD_TILE), m0
        for q0, mine in consumers:
            for k0 in range(0, mine * BWD_TILE, BWD_TILE):
                full = _tile_fully_valid(jnp.int32(q0), jnp.int32(k0), jnp.int32(n),
                                         jnp.int32(t), BWD_TILE, BWD_TILE, causal=sq["causal"],
                                         max_attn_len=sq["window"], has_targets=sq["has_tgt"])
                want = False if full is None else bool(full)
                assert tile_fully_valid(q0, k0, n, c, t, causal=sq["causal"],
                                        max_attn_len=sq["window"]) == want, (q0, k0)


@pytest.mark.parametrize("dh, d", [(16, 32), (48, 64), (96, 128), (160, 256)])
def test_head_dim_padding(dh, d):
    """K1-K5 are built for head dims 32, 64, 128 and 256; their wrappers pad q,
    k, v and dO with zero columns to the next one and slice the outputs and
    gradients, alpha and the scaling unchanged. The plain forward and
    backward at the padded dim equal the unpadded ones on the first dh
    columns and are zero past them."""
    from recsys_examples_torch.ops.hstu_attention import _padded
    from recsys_examples_torch.ops.hstu_attention_ref import hstu_attn_bwd_ref, hstu_mha_reference

    rng = np.random.default_rng(dh)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    offs = torch.tensor([0, 5, 12, 12, 20])
    T, H = 20, 2
    q, k, v, do = f(T, H, dh), f(T, H, dh), f(T, H, dh), f(T, H, dh)
    (qp, kp, vp, dop), dh0 = _padded(q, k, v, do)
    assert dh0 == dh and qp.shape[-1] == d
    kw = dict(num_targets=torch.tensor([1, 2, 0, 3]), scaling_seqlen=9)
    want = hstu_mha_reference(9, 0.4, q, k, v, offs, **kw)
    got = hstu_mha_reference(9, 0.4, qp, kp, vp, offs, **kw)
    assert not got[..., dh:].any()
    torch.testing.assert_close(got[..., :dh], want, rtol=1e-5, atol=1e-5)
    g_want = hstu_attn_bwd_ref(9, 0.4, q, k, v, do, offs, **kw)[:3]
    g_got = hstu_attn_bwd_ref(9, 0.4, qp, kp, vp, dop, offs, **kw)[:3]
    for a, b in zip(g_got, g_want):
        assert not a[..., dh:].any()
        torch.testing.assert_close(a[..., :dh], b, rtol=1e-5, atol=1e-5)
