"""The port's synthetic HSTU batch producer against the JAX package's: the
same seed gives the same arrays (ids int64 on the port's side, int32 on the
JAX side)."""
import numpy as np
import pytest
import torch

from recsys_examples_torch.data.hstu_batch import random_hstu_batch as t_batch
from recsys_examples_tpu.data.hstu_batch import random_hstu_batch as j_batch

KW = dict(batch_size=6, max_history_len=50, item_vocab=10_000, action_vocab=7,
          contextual_vocabs={"user_id": 5000, "user_age": 90}, num_tasks=3,
          value_zipf={"item": 1.05, "user_id": 1.05})


@pytest.mark.parametrize("seed,extra", [
    (0, {}),
    (1, dict(max_num_candidates=4)),
    (2, dict(max_num_candidates=3, token_capacity=-1)),
])
def test_random_hstu_batch_matches_jax(seed, extra):
    j = j_batch(seed, **KW, **extra)
    t = t_batch(seed, **KW, **extra)
    assert t.features.keys() == j.features.keys()
    for name, jf in j.features.items():
        tf = t.features[name]
        assert tf.values.dtype == np.int64 and tf.max_len == jf.max_len
        for field in ("values", "lengths", "offsets"):
            np.testing.assert_array_equal(getattr(tf, field), getattr(jf, field))
    for field in ("num_candidates", "labels", "label_lengths"):
        jv, tv = getattr(j, field), getattr(t, field)
        assert (jv is None) == (tv is None)
        if jv is not None:
            np.testing.assert_array_equal(tv, jv)
    for field in ("batch_size", "feature_to_max_seqlen", "item_feature_name",
                  "action_feature_name", "contextual_feature_names",
                  "max_num_candidates"):
        assert getattr(t, field) == getattr(j, field)

    dev = t.to("cpu")
    item = dev.features["item"]
    assert item.values.dtype == torch.int64 and item.offsets.dtype == torch.int64
    np.testing.assert_array_equal(item.values.numpy(), t.features["item"].values)
