"""The port's eval metrics against the JAX package's: AUC histograms and AUC
exactly equal on seeded logits with ties and bucket edges (counts are whole
numbers in fp32, so the sums are exact in any order; torch's and XLA's
sigmoid may differ by one ulp, which moves a logit across a bucket edge for
about one element in 2M of N(0, 16) logits, none here); HR@k / NDCG@k / MRR
within rtol 1e-6 (fp32 sums in another order) on seeded ranks."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_examples_torch.modules import metrics as tm
from recsys_examples_tpu.modules import metrics as jm


def _logits(seed, n, tasks):
    rng = np.random.default_rng(seed)
    x = (4 * rng.standard_normal((n, tasks))).astype(np.float32)
    x[: n // 8] = 0.0                       # p = 0.5 exactly: bucket edge 2048
    x[n // 8: n // 4] = x[n // 4: n // 4 + n // 8]   # ties
    x[-3:] = [[60.0] * tasks, [-60.0] * tasks, [20.0] * tasks]   # clipped ends
    return x


@pytest.mark.parametrize("seed,n,tasks,buckets", [(0, 2000, 1, 4096), (1, 777, 3, 4096),
                                                  (2, 504, 2, 16)])
def test_auc_matches_jax_exactly(seed, n, tasks, buckets):
    rng = np.random.default_rng(100 + seed)
    ts = tm.AUCState.init(tasks, buckets)
    js = jm.AUCState.init(tasks, buckets)
    for part in range(3):       # streaming: three updates
        x = _logits(seed * 10 + part, n, tasks)
        y = rng.integers(0, 2, size=(n, tasks)).astype(np.int32)
        valid = rng.random(n) < 0.9
        ts = tm.auc_update(ts, torch.from_numpy(x), torch.from_numpy(y),
                           torch.from_numpy(valid))
        js = jm.auc_update(js, jnp.asarray(x), jnp.asarray(y), jnp.asarray(valid))
    np.testing.assert_array_equal(ts.pos_hist.numpy(), np.asarray(js.pos_hist))
    np.testing.assert_array_equal(ts.neg_hist.numpy(), np.asarray(js.neg_hist))
    got, want = tm.auc_compute(ts).numpy(), np.asarray(jm.auc_compute(js))
    np.testing.assert_array_equal(got, want)
    assert ((got > 0.4) & (got < 0.6)).all()     # random labels


def test_auc_without_both_classes_is_half():
    ts = tm.AUCState.init(2)
    ts = tm.auc_update(ts, torch.ones(4, 2), torch.ones(4, 2, dtype=torch.int32),
                       torch.ones(4, dtype=torch.bool))
    np.testing.assert_array_equal(tm.auc_compute(ts).numpy(), [0.5, 0.5])


def test_auc_state_lives_on_the_given_device():
    assert tm.AUCState.init(1, device="cpu").pos_hist.device.type == "cpu"
    assert tm.RetrievalMetricState.init(2, device="cpu").hit.device.type == "cpu"


@pytest.mark.parametrize("seed", [0, 1])
def test_retrieval_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    ks = (1, 5, 10, 50)
    ts = tm.RetrievalMetricState.init(len(ks))
    js = jm.RetrievalMetricState.init(len(ks))
    for _ in range(3):
        n = 300
        rank = rng.integers(1, 120, size=n).astype(np.int32)
        rank[:6] = [1, 5, 10, 11, 50, 10 ** 6]                  # the k edges, a miss
        valid = rng.random(n) < 0.85
        ts = tm.retrieval_update(ts, torch.from_numpy(rank), torch.from_numpy(valid), ks)
        js = jm.retrieval_update(js, jnp.asarray(rank), jnp.asarray(valid), ks)
    got, want = tm.retrieval_compute(ts, ks), jm.retrieval_compute(js, ks)
    assert list(got) == list(want) == ["HR@1", "NDCG@1", "HR@5", "NDCG@5", "HR@10",
                                       "NDCG@10", "HR@50", "NDCG@50", "MRR"]
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6, err_msg=k)
        assert 0.0 <= got[k].item() <= 1.0
    np.testing.assert_array_equal(ts.hit.numpy(), np.asarray(js.hit))
    assert ts.count.item() == float(js.count)
