"""The port's SID batch generator against the JAX package's: the same seed
gives the same arrays, bit for bit."""
import numpy as np
import pytest
import torch

from recsys_examples_torch.data import sid_batch as t_sb
from recsys_examples_tpu.data import sid_batch as j_sb

FIELDS = ("history_sids", "history_lengths", "history_offsets", "candidate_sids")


@pytest.mark.parametrize("seed,B,items,H,C", [(0, 4, 6, 3, 32), (7, 1, 256, 4, 256),
                                              (3, 16, 9, 2, 5)])
def test_random_sid_batch_matches(seed, B, items, H, C):
    want = j_sb.random_sid_batch(seed, B, items, H, C)
    got = t_sb.random_sid_batch(seed, B, items, H, C)
    for f in FIELDS:
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (got.batch_size, got.num_hierarchies, got.max_history_tokens) == (
        want.batch_size, want.num_hierarchies, want.max_history_tokens)
    on_cpu = got.to("cpu")
    for f in FIELDS:
        t = getattr(on_cpu, f)
        assert t.dtype == torch.int64 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), getattr(got, f))
    assert on_cpu.to("cpu").history_sids.dtype == torch.int64   # idempotent


def test_make_sid_mapping_matches():
    np.testing.assert_array_equal(t_sb.make_sid_mapping(50, 4, 256, seed=2),
                                  j_sb.make_sid_mapping(50, 4, 256, seed=2))
