"""The paged attention kernel's plan (K6 and K6-int8): the plain statements
in `ops/paged_hstu_attention.py` that `csrc/paged_hstu_attention.cu` copies
line by line. Held against the dense delta mask of the plain version (every
chunk of a user is taken by exactly one CTA, the chunks hold every valid
pair, a certified chunk is all valid, each chunk's mask form is the dense
mask) and, through `paged_hstu_delta_attention_split_ref` (the kernel's
arithmetic: partials per split, summed in rank order), against the JAX
package's Pallas kernel in interpret mode. Inputs come from numpy with a
fixed seed and go to both sides."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from recsys_examples_torch.ops.paged_hstu_attention import (
    PAGED_CHUNK,
    _padded,
    paged_chunk_counts,
    paged_chunk_fully_valid,
    paged_chunk_valid,
    paged_cta_chunks,
    paged_chunk_span,
    paged_delta_valid,
    paged_hstu_delta_attention_ref,
    paged_hstu_delta_attention_split_ref,
    paged_page_chunking,
    paged_page_chunks,
    paged_query_blocks,
    paged_split_plan,
    quantize_kv_pages,
)
from recsys_examples_tpu.ops.pallas.paged_hstu_attention import (
    paged_hstu_delta_attention as jax_paged,
)

# clusters of 1-16 CTAs an H100 holds at once, as the card reports them for
# every instance (PERF.md §6)
H100_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15, 9: 9, 10: 7, 11: 7,
                 12: 7, 13: 7, 14: 7, 15: 7, 16: 7}


def h100(consumers, splits):
    return H100_CLUSTERS[splits]


@st.composite
def users(draw):
    """One user's cache and new tokens: page size, page-table row with unset
    pages, a cache that may end inside a chunk or past the table, new
    tokens, targets, S and a split count."""
    pg = draw(st.sampled_from([8, 12, 16, 24, 32, 48, 64, 96, 100, 128]))
    maxp = draw(st.integers(1, 12))
    S = draw(st.integers(1, 200))
    # often within a few positions of a chunk edge
    cached = draw(st.integers(0, maxp * pg + 70)
                  | st.integers(0, (maxp * pg) // PAGED_CHUNK + 1).map(
                      lambda k: max(0, PAGED_CHUNK * k + draw(st.integers(-3, 3)))))
    new_len = draw(st.integers(0, S))
    # targets beyond the new tokens move the history end below the cache
    tgt = draw(st.integers(0, new_len + 70)) if draw(st.booleans()) else None
    row = [draw(st.sampled_from([-1, 0, 1, 2, 3, 5])) for _ in range(maxp)]
    return dict(pg=pg, maxp=maxp, S=S, cached=cached, new_len=new_len, tgt=tgt, row=row,
                splits=draw(st.sampled_from([1, 2, 3, 4, 8, 16])))


def _dense(u):
    """[S, maxp * pg + S] validity of the user's (query, key) pairs."""
    t = lambda x: torch.tensor(x, dtype=torch.int32)
    return paged_delta_valid(t([u["row"]]), t([u["cached"]]), t([u["new_len"]]),
                             None if u["tgt"] is None else t([u["tgt"]]), u["S"],
                             u["pg"])[0].numpy()


def _blocks(u):
    """(m0, rows, n_page, n_tail) of each query block of the user."""
    _, rows, qblocks = paged_query_blocks(u["S"])
    for qb in range(qblocks):
        m0 = qb * rows
        yield (m0, rows, *paged_chunk_counts(u["cached"], u["new_len"], u["S"], m0, rows,
                                             u["maxp"], u["pg"]))


@settings(max_examples=300, deadline=None)
@given(users())
def test_chunks_cover_each_once_and_hold_every_valid_pair(u):
    valid, Nc = _dense(u), u["maxp"] * u["pg"]
    for m0, rows, n_page, n_tail in _blocks(u):
        n = n_page + n_tail
        taken = [c for r in range(u["splits"]) for c in range(*paged_cta_chunks(r, u["splits"], n))]
        assert taken == list(range(n))
        if n == 0:   # no live row in the block
            assert not valid[m0:m0 + rows].any()
            continue
        # no chunk lies wholly past the cache's reach or the block's rows
        assert n_page == 0 or paged_chunk_span(n_page - 1, u["pg"])[0] < min(u["cached"], Nc)
        assert (n_tail - 1) * PAGED_CHUNK < min(u["new_len"], u["S"], m0 + rows)
        # the page chunks tile [0, reach) in order, none crossing a unit of pages
        unit = paged_page_chunking(u["pg"])[0]
        ends = [sum(paged_chunk_span(c, u["pg"])) for c in range(n_page)]
        starts = [paged_chunk_span(c, u["pg"])[0] for c in range(n_page)]
        assert starts == ([0] + ends[:-1] if ends else [])
        assert all(s // unit == (e - 1) // unit for s, e in zip(starts, ends))
        i, col = np.nonzero(valid[m0:m0 + rows])
        page, tail = col[col < Nc], col[col >= Nc] - Nc
        assert (page < (ends[-1] if ends else 0)).all()
        assert (tail < n_tail * PAGED_CHUNK).all()


@settings(max_examples=300, deadline=None)
@given(users())
def test_certified_chunks_are_all_valid_and_forms_match_the_mask(u):
    """Every certified page chunk is valid for every live row (with targets,
    unset pages and caches that end inside a chunk), and the mask form the
    kernel evaluates on the other chunks is the dense mask."""
    valid, Nc = _dense(u), u["maxp"] * u["pg"]
    he = u["cached"] + u["new_len"] - (u["tgt"] or 0)
    live = min(u["new_len"], u["S"])
    for m0, rows, n_page, n_tail in _blocks(u):
        if live <= m0:
            continue
        r = torch.arange(m0, min(m0 + rows, live))
        want = valid[r.numpy()]
        for c in range(n_page + n_tail):
            form = paged_chunk_valid(r, c, n_page, u["cached"], u["new_len"], he, u["S"],
                                     u["row"], u["pg"], u["maxp"]).numpy()
            if c < n_page:
                c0, keys = paged_chunk_span(c, u["pg"])
                cols = np.arange(c0, c0 + PAGED_CHUNK)
                inside = (cols < Nc) & (cols < c0 + keys)
                dense = np.zeros_like(form)
                dense[:, inside] = want[:, cols[inside]]
                if paged_chunk_fully_valid(c, u["cached"], he, u["row"], u["pg"], u["maxp"]):
                    assert dense.all()
            else:
                t = np.arange((c - n_page) * PAGED_CHUNK, (c - n_page + 1) * PAGED_CHUNK)
                inside = t < u["S"]
                dense = np.zeros_like(form)
                dense[:, inside] = want[:, Nc + t[inside]]
            np.testing.assert_array_equal(form, dense)


def test_plan_follows_the_cards_clusters():
    """One consumer for S <= 64, two above; the largest split whose clusters
    the card holds at once, at most 16 and at most the chunks a user has;
    every page size is planned, in chunks of `paged_page_chunking`."""
    serve = paged_split_plan(8, 128, 4, 19, 128, h100)
    assert (serve.splits, serve.consumers, serve.rows, serve.grid) == (3, 2, 128, (3, 4, 8))
    assert paged_split_plan(8, 512, 4, 19, 128, h100).grid == (1, 4, 32)
    decode = paged_split_plan(1, 8, 4, 31, 128, h100)
    assert (decode.splits, decode.consumers, decode.grid) == (16, 1, (16, 4, 1))
    assert paged_split_plan(8, 8, 4, 31, 128, h100).splits == 3
    assert paged_split_plan(64, 8, 4, 31, 128, h100).splits == 1   # two waves anyway
    assert paged_split_plan(1, 40, 1, 1, 16, h100).splits == 2     # 1 page chunk + 1 tail
    # 4 pages of 24: 2 chunks of 48 keys, + 1 tail; of 96: 8 (64 + 32 a page);
    # of 4 rows (not on an 8-row box): 4 chunks of one page
    assert paged_split_plan(1, 8, 1, 4, 24, h100).splits == 3
    assert paged_split_plan(1, 8, 1, 4, 96, h100).splits == 9
    assert paged_split_plan(1, 8, 1, 4, 4, h100).splits == 5
    with pytest.raises(ValueError, match="page size"):
        paged_split_plan(1, 8, 1, 4, 0, h100)


@pytest.mark.parametrize("pg, want", [
    (8, (64, 1, 8, 8)), (16, (64, 1, 4, 16)), (32, (64, 1, 2, 32)), (64, (64, 1, 1, 64)),
    (128, (128, 2, 1, 64)), (24, (48, 1, 2, 24)), (48, (48, 1, 1, 48)), (40, (40, 1, 1, 40)),
    (12, (12, 1, 1, 12)), (4, (4, 1, 1, 4)), (96, (96, 2, 1, 64)), (100, (100, 2, 1, 64))])
def test_page_chunking(pg, want):
    """Chunks of whole pages on 8-row boxes within 64 keys, or 64-key cuts of
    a larger page with a remainder; the spans walk the cache in order."""
    assert paged_page_chunking(pg) == want
    unit, cpu = want[:2]
    spans = [paged_chunk_span(c, pg) for c in range(3 * cpu)]
    assert [s for s, _ in spans] == [sum(x) for x in [(0, 0)] + spans[:-1]]
    assert all(0 < n <= PAGED_CHUNK for _, n in spans)
    assert sum(n for _, n in spans[:cpu]) == unit
    for reach in range(0, 3 * unit + 1):   # the fewest chunks that cover [0, reach)
        n = paged_page_chunks(reach, pg)
        covered = sum(k for _, k in spans[:n])
        assert covered >= reach and (n == 0 or covered - spans[n - 1][1] < reach)


@pytest.mark.parametrize("dh, d", [(16, 32), (32, 32), (48, 64), (96, 128), (160, 256),
                                   (224, 256), (256, 256)])
def test_head_dim_padding(dh, d):
    """Any head dim pads with zero columns to the next built one (K6's
    wrapper): q, the pages and the new tokens, the pages' scales untouched;
    the padded plain version equals the unpadded one on the first dh
    columns (to 1e-5: fp32 sums change order with the width) and is zero
    past them."""
    case = _case(5, 2, 9, 2, dh, 6, 16, 3, cached=[20, 0], new_lens=[9, 4], targets=None)
    t = {k: None if v is None else torch.from_numpy(v) for k, v in case.items()}
    (q, kp, vp, nk, nv), dh0 = _padded(t["q"], t["k_pages"], t["v_pages"], t["new_k"],
                                       t["new_v"])
    assert dh0 == dh and {x.shape[-1] for x in (q, kp, vp, nk, nv)} == {d}
    args = dict(t, q=q, k_pages=kp, v_pages=vp, new_k=nk, new_v=nv)
    got = paged_hstu_delta_attention_ref(*[args[k] for k in ORDER], 0.3, 50.0)
    want = paged_hstu_delta_attention_ref(*[t[k] for k in ORDER], 0.3, 50.0)
    assert not got[..., dh:].any()
    torch.testing.assert_close(got[..., :dh], want, rtol=1e-5, atol=1e-5)


def _case(seed, B, S, H, dh, P, pg, maxp, cached, new_lens, targets):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    page_table = rng.permutation(P)[: B * maxp].reshape(B, maxp).astype(np.int32)
    # unset pages where the cache has not reached: the JAX kernel masks their
    # positions as the port does (it reads page 0 there; the port reads none)
    for b, c in enumerate(cached):
        page_table[b, -(-(c + 1) // pg):] = -1
    return dict(
        q=f(B, S, H, dh), k_pages=f(P, pg, H, dh), v_pages=f(P, pg, H, dh),
        page_table=page_table, cached_len=np.asarray(cached, np.int32),
        new_k=f(B, S, H, dh), new_v=f(B, S, H, dh),
        new_lens=np.asarray(new_lens, np.int32),
        num_targets=None if targets is None else np.asarray(targets, np.int32))


ORDER = ("q", "k_pages", "v_pages", "page_table", "cached_len", "new_k", "new_v",
         "new_lens", "num_targets")


def _pages_case(pg):
    """Caches that end inside a chunk and on a chunk edge, an empty one,
    unset pages past each cache, new tokens past a 64-key chunk (S 72) and
    targets."""
    maxp = 160 // pg
    return _case(pg, 4, 72, 2, 32, 4 * maxp + 3, pg, maxp,
                 cached=[0, 37, 128, 100], new_lens=[72, 13, 70, 1], targets=[3, 0, 64, 1])


@pytest.mark.parametrize("pg, mode", [
    (pg, mode) for pg in (8, 16) for mode in ("fp32", "bf16", "int8", "int8_bf16q")
] + [(24, "int8"), (48, "bf16")])     # chunks of 48 keys: two pages of 24, one of 48
def test_split_matches_pallas_interpret(mode, pg):
    """The kernel's arithmetic, split 1, 2, 4 and 8 ways, against the Pallas
    kernel in interpret mode on the same inputs. fp32 and bf16 (both round P
    and the output to bf16), and int8 pages under fp32 queries (neither
    rounds), agree to 2e-4. int8 pages under bf16 queries, the arithmetic
    the int8 kernel runs (p * v_scale rounded to bf16 before p . v8, where
    the Pallas kernel keeps fp32), are held to the kernels' pass rule
    2e-2 * max|ref| + 1e-3. Padded rows are exactly zero."""
    case = _pages_case(pg)
    alpha, scaling = 1.0 / 32 ** 0.5, 200.0
    t = {k: None if v is None else torch.from_numpy(v) for k, v in case.items()}
    j = {k: None if v is None else jnp.asarray(v) for k, v in case.items()}
    kw_t, kw_j = {}, {}
    if mode in ("bf16", "int8_bf16q"):
        for k in (("q", "k_pages", "v_pages", "new_k", "new_v") if mode == "bf16"
                  else ("q", "new_k", "new_v")):
            t[k] = t[k].to(torch.bfloat16)
            j[k] = jnp.asarray(t[k].float().numpy()).astype(jnp.bfloat16)
    if mode.startswith("int8"):
        k8, v8, ks, vs = quantize_kv_pages(t["k_pages"], t["v_pages"])
        t.update(k_pages=k8, v_pages=v8)
        j.update(k_pages=jnp.asarray(k8.numpy()), v_pages=jnp.asarray(v8.numpy()))
        kw_t = dict(k_scales=ks, v_scales=vs)
        kw_j = dict(k_scales=jnp.asarray(ks.numpy()), v_scales=jnp.asarray(vs.numpy()))
    want = np.asarray(jax_paged(*[j[k] for k in ORDER], alpha, scaling, backend="pallas",
                                interpret=True, **kw_j)).astype(np.float32)
    for splits in (1, 2, 4, 8):
        got = paged_hstu_delta_attention_split_ref(*[t[k] for k in ORDER], alpha, scaling,
                                                   splits=splits, **kw_t)
        assert got.dtype == t["q"].dtype
        got = got.float().numpy()
        if mode == "int8_bf16q":
            err = np.abs(got - want).max()
            assert err < 2e-2 * np.abs(want).max() + 1e-3, err
        else:
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
        for b, n in enumerate(case["new_lens"]):
            assert not got[b, n:].any()


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_split_padded_rows_are_exact_zeros(mode):
    """Rows i >= new_len take every certified chunk's sums unmasked; the
    split version zeroes them, as the kernel's store does, and equals the
    plain version elsewhere."""
    case = _case(9, 3, 130, 2, 32, 40, 64, 8, cached=[448, 256, 500],
                 new_lens=[5, 0, 130], targets=None)
    t = {k: None if v is None else torch.from_numpy(v) for k, v in case.items()}
    for k in ("q", "k_pages", "v_pages", "new_k", "new_v"):
        t[k] = t[k].to(torch.bfloat16)
    kw = {}
    plain = dict(t)
    if mode.startswith("int8"):
        k8, v8, ks, vs = quantize_kv_pages(t["k_pages"], t["v_pages"])
        t.update(k_pages=k8, v_pages=v8)
        kw = dict(k_scales=ks, v_scales=vs)
        plain.update(k_pages=k8.float() * ks[..., None], v_pages=v8.float() * vs[..., None])
    splits = paged_split_plan(3, 130, 2, 8, 64, h100).splits
    got = paged_hstu_delta_attention_split_ref(*[t[k] for k in ORDER], 0.2, 600.0,
                                               splits=splits, **kw)
    want = paged_hstu_delta_attention_ref(*[plain[k] for k in ORDER], 0.2, 600.0)
    for b, n in enumerate(case["new_lens"]):
        assert torch.count_nonzero(got[b, n:]) == 0
    assert (got.float() - want.float()).abs().max() <= 2e-2 * want.float().abs().max() + 1e-3
