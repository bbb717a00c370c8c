"""The frozen FLOP and byte counts at small shapes, against counts made
another way: the masks counted cell by cell, the reference's products
counted by torch's FLOP counter, a K7 call's bytes summed by hand."""
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_port.families import hstu_ranking as hr
from bench_port.families import qwen3_sid as qs
from bench_port.reference import qwen3_ref
from bench_port.tests import tiny
from bench_port.core import weights as wts


def dense_mask(n: int, c: int) -> torch.Tensor:
    i = torch.arange(n)
    return (i[None, :] <= i[:, None]) | (i[:, None] < c)


@pytest.mark.parametrize("n,c", [(1, 1), (3, 3), (4, 3), (10, 3), (65, 3), (130, 5), (7, 0)])
def test_mask_pairs_count_the_mask(n, c):
    assert hr.mask_pairs(n, c) == int(dense_mask(n, c).sum())


def test_flops_exact_matches_pairs():
    H, dh, D, L = 2, 16, 32, 3
    seqlens = np.array([3, 9, 20, 131])
    fwd = hr.hstu_flops_exact(seqlens, 3, 0, D, H, dh, L, has_bwd=False, residual=False)
    h = seqlens - 3
    gemm = L * (2 * seqlens * 4 * H * dh * D + 2 * seqlens * H * dh * D).sum()
    other = L * (seqlens * H * dh).sum()
    # the reference's count leaves out half of the diagonal of the history
    pairs = sum(hr.mask_pairs(int(n), 3) - (n - 3) / 2 for n in seqlens)
    assert fwd == pytest.approx(L * 4 * H * dh * pairs + gemm + other)
    full = hr.hstu_flops_exact(seqlens, 3, 0, D, H, dh, L)
    assert full == pytest.approx(3.5 * L * 4 * H * dh * pairs + 3 * gemm + 2 * other
                                 + L * (seqlens * H * D).sum())
    assert h.min() >= 0


def test_attention_work_bytes_and_flops():
    w = hr.attention_work([3, 11], 3, 2, 16)
    tile = 14 * 2 * 16 * 2
    pairs = hr.mask_pairs(3, 3) + hr.mask_pairs(11, 3)
    assert w["fwd"] == (4 * tile, 2 * 2 * 2 * 16 * pairs)
    assert w["dq"] == (5 * tile, 3 * 2 * 2 * 16 * pairs)
    assert w["dkv"] == (6 * tile, 4 * 2 * 2 * 16 * pairs)


def test_folded_zipf_law():
    pmf = hr.folded_zipf_pmf(1.2, 64)
    assert pmf.sum() == pytest.approx(1.0) and (pmf > 0).all()
    assert pmf[0] > pmf[1] > pmf[10]
    lens = hr.pool_lengths({"pool_batches": 4, "batch_size": 8, "history_zipf_a": 1.2,
                            "max_history": 64})
    assert len(lens) == 32 and lens.min() >= 1 and lens.max() <= 64


def test_generate_flops_decode_step_counts_the_reference():
    c = tiny.qwen3("qwen3_sid_ctx1k").config
    w = wts.make(qs.param_spec(c), 3, "cpu")
    ref = qwen3_ref.Qwen3Reference(c, w)
    n, W = 12, 5
    _, kv = ref.prefill(torch.arange(n))
    with FlopCounterMode(display=False) as fc:
        ref.extend(kv, torch.zeros(W, 1, dtype=torch.int64), last_only=True)
    steps2 = qs.generate_flops([n], W, 2, c)
    steps1 = qs.generate_flops([n], W, 1, c)
    assert fc.get_total_flops() == steps2 - steps1


def test_generate_flops_prefill_gemms():
    c = tiny.qwen3("qwen3_sid_ctx1k").config
    w = wts.make(qs.param_spec(c), 3, "cpu")
    ref = qwen3_ref.Qwen3Reference(c, w)
    n = 12
    with FlopCounterMode(display=False) as fc:
        ref.prefill(torch.arange(n))
    H, dh, L = c["num_attention_heads"], c["head_dim"], c["num_hidden_layers"]
    # the reference computes all n x n scores, the count only the causal ones
    dense_attn = L * 4 * H * dh * n * n
    causal_attn = L * 4 * H * dh * n * (n + 1) / 2
    assert fc.get_total_flops() - dense_attn == qs.generate_flops([n], 4, 1, c) - causal_attn


def test_k7_work_by_hand():
    B, W, H, Hkv, D, S, N = 2, 4, 4, 2, 8, 10, 2
    anc = torch.tensor([[[0, 0, 1, 1], [0, 1, 2, 3]], [[3, 3, 3, 3], [0, 1, 2, 3]]])
    ctx_lens = torch.tensor([7, 10])
    nbytes, flops = qs.k7_work(((B, W, H, D), 2, S, Hkv, ctx_lens, N, anc))
    uniq = 2 + 4 + 1 + 4
    assert nbytes == 2 * 17 * Hkv * D * 2 + 2 * B * W * H * D * 2 + B * 4 \
        + 2 * uniq * Hkv * D * 2 + B * N * W * 4
    assert flops == 4 * (17 + B * N) * W * H * D
