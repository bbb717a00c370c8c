"""Bucket hash and frozen-table lookup: the port against the JAX package,
bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_examples_torch import convert
from recsys_examples_torch.dynamicemb.dynamicemb_config import (
    EMPTY_KEY,
    hash_keys,
)
from recsys_examples_torch.dynamicemb.exportable_tables import inference_lookup
from recsys_examples_tpu.dynamicemb.batched_table import DynamicEmbeddingTable
from recsys_examples_tpu.dynamicemb.dynamicemb_config import (
    DynamicEmbInitializerArgs,
    DynamicEmbInitializerMode,
    DynamicEmbTableOptions,
    hash_keys as jax_hash_keys,
)
from recsys_examples_tpu.dynamicemb.exportable_tables import (
    freeze_table,
    inference_lookup as jax_inference_lookup,
)
from recsys_examples_tpu.dynamicemb.optimizer import SparseOptimizerArgs


@pytest.mark.parametrize("num_buckets", [1, 7, 16, 4096, 1_000_003, 2 ** 31 - 1])
def test_hash_keys_bit_exact(num_buckets):
    rng = np.random.default_rng(num_buckets)
    edge = np.asarray([-2 ** 63, -2 ** 63 + 1, -2 ** 62, -1, 0, 1, 2 ** 31,
                       2 ** 62, 2 ** 63 - 2, 2 ** 63 - 1], np.int64)
    keys = np.concatenate([
        edge, rng.integers(-2 ** 63, 2 ** 63 - 1, size=4096, dtype=np.int64),
        rng.integers(-1000, 1000, size=256, dtype=np.int64),
    ])
    want = np.asarray(jax_hash_keys(jnp.asarray(keys), num_buckets))
    got = hash_keys(torch.from_numpy(keys), num_buckets).numpy()
    np.testing.assert_array_equal(got, want)


def test_inference_lookup_exact():
    tbl = DynamicEmbeddingTable(
        DynamicEmbTableOptions(
            embedding_dim=8, max_capacity=256, bucket_capacity=16,
            initializer_args=DynamicEmbInitializerArgs(
                mode=DynamicEmbInitializerMode.NORMAL, std_dev=0.3
            ),
        ),
        SparseOptimizerArgs(optimizer="sgd"),
    )
    st = tbl.init_state()
    st, _, _ = tbl.forward_train(st, jnp.arange(1, 150, dtype=jnp.int64))
    frozen = freeze_table(tbl, st)
    rng = np.random.default_rng(0)
    # hits, misses, negative keys and the empty-slot sentinel
    keys = np.concatenate([
        rng.integers(1, 150, size=64), rng.integers(150, 10_000, size=32),
        [-5, 0, EMPTY_KEY],
    ]).astype(np.int64)
    want = np.asarray(jax_inference_lookup(frozen, jnp.asarray(keys)))
    port = convert.table_state(np.asarray(frozen.keys),
                               np.asarray(frozen.values))
    got = inference_lookup(port, torch.from_numpy(keys)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[64:].any()          # misses and EMPTY_KEY give zeros
    assert got[:64].any(axis=1).sum() > 32   # most inserted keys are hits
