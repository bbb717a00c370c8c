"""The port's jagged ops against recsys_examples_tpu/ops/jagged.py, exact,
with a zero-length sequence in every batch."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_examples_torch.ops import jagged as tj
from recsys_examples_tpu.ops import jagged as jj

LENS_A = np.array([3, 0, 5, 2], np.int64)
LENS_B = np.array([1, 2, 0, 4], np.int64)


def _offs(lens):
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)


def _vals(rows, dim=3, seed=0):
    return np.random.default_rng(seed).standard_normal((rows, dim)).astype(np.float32)


def _check(got, want):
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            _check(g, w)
        return
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _both(fn_name, *args, **kw):
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    targs = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args]
    return getattr(tj, fn_name)(*targs, **kw), getattr(jj, fn_name)(*jargs, **kw)


@pytest.mark.parametrize("total", [10, 13])
def test_row_to_batch(total):
    _check(*_both("row_to_batch", _offs(LENS_A), total))


@pytest.mark.parametrize("max_len", [3, 6])
def test_jagged_to_padded_dense(max_len):
    _check(*_both("jagged_to_padded_dense", _vals(12), _offs(LENS_A), max_len))
    _check(*_both("jagged_to_padded_dense", _vals(12)[:, 0], _offs(LENS_A), max_len,
                  padding_value=-1.0))


def test_padded_dense_to_jagged():
    dense = np.random.default_rng(1).standard_normal((4, 5, 3)).astype(np.float32)
    _check(*_both("padded_dense_to_jagged", dense, _offs(LENS_A), 12))


def test_concat_2D_jagged():
    _check(*_both("concat_2D_jagged", _vals(11), _offs(LENS_A), _vals(8, seed=1),
                  _offs(LENS_B)))


def test_concat_multi_2D_jagged():
    lens_c = np.array([0, 1, 1, 1], np.int64)
    vals = [_vals(11), _vals(8, seed=1), _vals(4, seed=2)]
    offs = [_offs(LENS_A), _offs(LENS_B), _offs(lens_c)]
    got = tj.concat_multi_2D_jagged([torch.from_numpy(v) for v in vals],
                                    [torch.from_numpy(o) for o in offs])
    want = jj.concat_multi_2D_jagged([jnp.asarray(v) for v in vals],
                                     [jnp.asarray(o) for o in offs])
    _check(got, want)


def test_split_2D_jagged():
    lens = LENS_A + LENS_B
    _check(*_both("split_2D_jagged", _vals(int(lens.sum()) + 2), _offs(lens), LENS_A,
                  total_a=12, total_b=9))


def test_interleave_jagged():
    _check(*_both("interleave_jagged", _vals(7), _vals(7, seed=3)))


def test_lengths_to_offsets():
    _check(*_both("lengths_to_offsets", LENS_A))
