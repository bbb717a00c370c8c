"""The port's beam search against the JAX package's on the same numpy
log-probs, with tied and -inf scores: tokens, parents, ancestry and paths
equal, scores equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_examples_torch.models import beam_search as t_bs
from recsys_examples_tpu.models import beam_search as j_bs


def _logp(rng, shape, ties, banned):
    x = rng.standard_normal(shape).astype(np.float32)
    if ties:        # few distinct values: many exact ties (+ 0.0: no -0.0,
        x = np.round(x) + 0.0   # which XLA's top_k orders below 0.0)
    if banned:      # constrained tokens
        x[rng.random(shape) < 0.4] = -np.inf
    return x


def _same(ts, js):
    np.testing.assert_array_equal(ts.scores.numpy(), np.asarray(js.scores))
    np.testing.assert_array_equal(ts.tokens.numpy(), np.asarray(js.tokens))
    np.testing.assert_array_equal(ts.parents.numpy(), np.asarray(js.parents))
    assert ts.step == int(js.step)


@pytest.mark.parametrize("ties,banned", [(False, False), (True, False), (True, True)])
@pytest.mark.parametrize("W", [3, 40])
def test_search_matches_jax(ties, banned, W):
    """W = 40 is wider than the codebook, so first_expand already leaves
    -inf beams (when tokens are banned) and ties among them."""
    B, H, C = 3, 4, 32
    rng = np.random.default_rng(0)
    ts, js = t_bs.init_beam(B, W, H, device="cpu"), j_bs.init_beam(B, W, H)
    _same(ts, js)
    lp0 = _logp(rng, (B, C) if W <= C else (B, 64), ties, banned)
    ts = t_bs.first_expand(ts, torch.from_numpy(lp0))
    js = j_bs.first_expand(js, jnp.asarray(lp0))
    _same(ts, js)
    for h in range(1, H):
        np.testing.assert_array_equal(t_bs.decode_paths(ts).numpy(),
                                      np.asarray(j_bs.decode_paths(js)))
        lp = _logp(rng, (B, W, C), ties, banned)
        ts = t_bs.propagate(ts, torch.from_numpy(lp))
        js = j_bs.propagate(js, jnp.asarray(lp))
        _same(ts, js)
    np.testing.assert_array_equal(t_bs.build_ancestry(ts).numpy(),
                                  np.asarray(j_bs.build_ancestry(js)))
    np.testing.assert_array_equal(t_bs.decode_paths(ts).numpy(),
                                  np.asarray(j_bs.decode_paths(js)))


def test_top_k_stable_orders_ties_by_index():
    x = torch.tensor([[1.0, 3.0, 3.0, -torch.inf, 3.0, -torch.inf, 1.0]])
    v, i = t_bs.top_k_stable(x, 6)
    assert i.tolist() == [[1, 2, 4, 0, 6, 3]]
    assert v.tolist() == [[3.0, 3.0, 3.0, 1.0, 1.0, -float("inf")]]


def test_gather_beams_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 3, 4)).astype(np.float32)
    parents = rng.integers(0, 5, size=(2, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        t_bs.gather_beams(torch.from_numpy(x), torch.from_numpy(parents)).numpy(),
        np.asarray(j_bs.gather_beams(jnp.asarray(x), jnp.asarray(parents))))


def test_mechanics_of_the_jax_package_test():
    """tests/test_sid_gr.py::test_beam_search_mechanics on the port."""
    state = t_bs.init_beam(2, 3, 2, device="cpu")
    logp0 = torch.log(torch.tensor([[0.5, 0.3, 0.15, 0.05], [0.25, 0.25, 0.25, 0.25]]))
    state = t_bs.first_expand(state, logp0)
    assert state.tokens[0, 0].tolist() == [0, 1, 2]
    assert state.tokens[1, 0].tolist() == [0, 1, 2]     # a four-way tie: lowest first
    logp1 = torch.full((2, 3, 4), float(np.log(0.01)))
    logp1[0, 1, 3] = float(np.log(0.99))
    state = t_bs.propagate(state, logp1)
    assert t_bs.decode_paths(state)[0, 0].tolist() == [1, 3]
