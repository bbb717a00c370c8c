"""The port's collectives (`parallel/collective_ops.py`) and mesh
(`parallel/mesh.py`) on gloo ranks, and its key routing against the JAX
package's.

Each world size (2 and 4) is one spawn of CPU processes joined by a
FileStore (`mesh.spawn_ranks`); the ranks run every check and save their
outputs and input gradients, which the tests hold against the same
functions written out in plain torch over all ranks' inputs (outputs and
gradients within 1e-6; the values are O(1) sums of a few terms). The ranks
import no JAX: this module imports it only inside the tests."""
import os

import numpy as np
import pytest
import torch

from recsys_examples_torch.parallel import collective_ops as co
from recsys_examples_torch.parallel import mesh as pm

TOL = dict(rtol=1e-6, atol=1e-6)


def _x(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def _rows(r):
    return r + 2          # ragged: rank r holds r + 2 rows


def _run_case(fn, x, cot):
    x = x.clone().requires_grad_()
    out = fn(x)
    (out * cot).sum().backward()
    return out.detach(), x.grad


def _worker(rank, world, out_dir):
    import torch.distributed as dist

    g = dist.group.WORLD
    W = world
    res = {}
    full = sum(_rows(r) for r in range(W))
    res["gather"] = _run_case(lambda x: co.gather_along_first_dim(x, g),
                              _x(rank, _rows(rank), 3), _x(100 + rank, full, 3))
    res["gather_repl"] = _run_case(
        lambda x: co.gather_along_first_dim(x, g, replicated_output=True),
        _x(rank, _rows(rank), 3), _x(100, full, 3))
    res["gather_last"] = _run_case(lambda x: co.gather_along_last_dim(x, g),
                                   _x(rank, 4, 3), _x(200, 4, 3 * W))
    res["split"] = _run_case(lambda x: co.split_along_first_dim(x, g),
                             _x(300, 2 * W, 3), _x(400 + rank, 2, 3))
    res["reduce_scatter"] = _run_case(lambda x: co.reduce_scatter_first_dim(x, g),
                                      _x(rank, 2 * W, 3), _x(500 + rank, 2, 3))
    res["all_reduce"] = _run_case(lambda x: co.all_reduce(x, g), _x(rank, 5, 2), _x(600, 5, 2))
    res["copy_to"] = _run_case(lambda x: co.copy_to_group(x, g), _x(rank, 5, 2),
                               _x(700 + rank, 5, 2))
    res["grad_scale"] = _run_case(lambda x: co.grad_scale(x, 0.25), _x(rank, 3, 2),
                                  _x(800 + rank, 3, 2))
    # jagged: rank r holds r + 1 samples of lengths 1..r+1 in a buffer with 2
    # padding rows
    lengths = torch.arange(1, rank + 2)
    n = int(lengths.sum())
    vals = _x(rank, n + 2, 2).requires_grad_()
    gv, gl = co.jagged_allgather(vals, lengths, g)
    (gv * _x(900 + rank, gv.shape[0], 2)).sum().backward()
    res["jagged"] = (gv.detach(), gl, vals.grad)
    # the mesh: coordinates, group sizes, the combined axis
    tp = 2 if W == 4 else 1
    mesh = pm.make_mesh(-1, tp, "cpu")
    res["mesh"] = (mesh.shape, mesh.index("data"), mesh.index("model"),
                   dist.get_world_size(mesh.group("data")), dist.get_world_size(mesh.group("model")))
    ms = pm.make_multislice_mesh(2, -1, 1, "cpu")
    gd = ms.group(ms.data_axis)
    t = torch.tensor([float(rank)])
    dist.all_reduce(t, group=gd)
    res["multislice"] = (ms.shape, ms.data_axis, ms.index(ms.data_axis),
                         dist.get_world_size(gd), float(t))
    try:
        pm.make_mesh(-1, 3, "cpu")
        res["tp3"] = "no error"
    except ValueError as e:
        res["tp3"] = str(e)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.fixture(scope="module", params=[2, 4], ids=["W2", "W4"])
def ranks(request, tmp_path_factory):
    W = request.param
    d = tmp_path_factory.mktemp(f"collectives_w{W}")
    pm.spawn_ranks(_worker, W, str(d), str(d))
    return W, [torch.load(d / f"rank{r}.pt") for r in range(W)]


def _close(a, b):
    np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_gather_along_first_dim_ragged_and_its_reduce_scatter_backward(ranks):
    W, res = ranks
    xs = [_x(r, _rows(r), 3) for r in range(W)]
    offs = np.cumsum([0] + [_rows(r) for r in range(W)])
    gsum = sum(_x(100 + r, offs[-1], 3) for r in range(W))
    for r in range(W):
        out, gx = res[r]["gather"]
        _close(out, torch.cat(xs))
        _close(gx, gsum[offs[r]:offs[r + 1]])


def test_gather_with_replicated_consumers_keeps_the_rank_block(ranks):
    W, res = ranks
    offs = np.cumsum([0] + [_rows(r) for r in range(W)])
    for r in range(W):
        _close(res[r]["gather_repl"][1], _x(100, offs[-1], 3)[offs[r]:offs[r + 1]])


def test_gather_along_last_dim(ranks):
    W, res = ranks
    for r in range(W):
        out, gx = res[r]["gather_last"]
        _close(out, torch.cat([_x(q, 4, 3) for q in range(W)], 1))
        _close(gx, _x(200, 4, 3 * W)[:, 3 * r:3 * r + 3])


def test_split_along_first_dim_and_its_all_gather_backward(ranks):
    W, res = ranks
    for r in range(W):
        out, gx = res[r]["split"]
        _close(out, _x(300, 2 * W, 3)[2 * r:2 * r + 2])
        _close(gx, torch.cat([_x(400 + q, 2, 3) for q in range(W)]))


def test_reduce_scatter_first_dim(ranks):
    W, res = ranks
    total = sum(_x(q, 2 * W, 3) for q in range(W))
    for r in range(W):
        out, gx = res[r]["reduce_scatter"]
        _close(out, total[2 * r:2 * r + 2])
        _close(gx, torch.cat([_x(500 + q, 2, 3) for q in range(W)]))


def test_all_reduce_copy_to_and_grad_scale(ranks):
    W, res = ranks
    for r in range(W):
        out, gx = res[r]["all_reduce"]
        _close(out, sum(_x(q, 5, 2) for q in range(W)))
        _close(gx, _x(600, 5, 2))                 # identity backward
        out, gx = res[r]["copy_to"]
        _close(out, _x(r, 5, 2))
        _close(gx, sum(_x(700 + q, 5, 2) for q in range(W)))
        out, gx = res[r]["grad_scale"]
        _close(out, _x(r, 3, 2))
        _close(gx, 0.25 * _x(800 + r, 3, 2))


def test_jagged_allgather_sends_exact_lengths(ranks):
    W, res = ranks
    ns = [(q + 1) * (q + 2) // 2 for q in range(W)]
    want_v = torch.cat([_x(q, ns[q] + 2, 2)[:ns[q]] for q in range(W)])
    want_l = torch.cat([torch.arange(1, q + 2) for q in range(W)])
    offs = np.cumsum([0] + ns)
    gsum = sum(_x(900 + q, offs[-1], 2) for q in range(W))
    for r in range(W):
        gv, gl, gx = res[r]["jagged"]
        _close(gv, want_v)
        assert torch.equal(gl, want_l)
        _close(gx[:ns[r]], gsum[offs[r]:offs[r + 1]])
        assert not gx[ns[r]:].any()             # padding rows were not sent


def test_mesh_coordinates_and_groups(ranks):
    W, res = ranks
    tp = 2 if W == 4 else 1
    for r in range(W):
        shape, d, m, nd, nm = res[r]["mesh"]
        assert shape == {"data": W // tp, "model": tp}
        assert (d, m) == (r // tp, r % tp) and (nd, nm) == (W // tp, tp)
        shape, axis, idx, n, total = res[r]["multislice"]
        assert shape == {"dcn": 2, "data": W // 2, "model": 1}
        assert axis == ("dcn", "data") and idx == r and n == W
        assert total == sum(range(W))
        assert "does not divide" in res[r]["tp3"]


def test_backend_follows_the_requested_device():
    assert pm.backend_for("cpu") == "gloo"
    assert pm.backend_for("cuda") == "nccl" and pm.backend_for("cuda:1") == "nccl"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pm.init_distributed("cuda")


def test_init_distributed_needs_a_store_or_torchrun(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        pm.init_distributed("cpu")


def test_partition_table():
    assert pm.partition_dim("hstu_block.layers.3.uvqk_kernel") == 2
    assert pm.partition_dim("hstu_block.layers.0.linear_proj.weight") == 1
    assert pm.partition_dim("hstu_block.layers.0.relative_bias.rel_bias") == 1
    assert pm.partition_dim("hstu_block.layers.0.input_layernorm.scale") is None
    assert pm.partition_dim("head.layers.0.weight") is None
    assert pm.is_sp_replicated("hstu_block.layers.1.input_layernorm.bias")
    assert not pm.is_sp_replicated("hstu_block.layers.1.output_layernorm.bias")


@pytest.mark.parametrize("W", [1, 2, 3, 4, 8])
def test_route_owner_matches_jax_bit_for_bit(W):
    from recsys_examples_torch.dynamicemb.sharded_collection import route_owner
    from recsys_examples_tpu.dynamicemb.sharded_collection import route_owner_np

    rng = np.random.default_rng(W)
    keys = np.concatenate([
        rng.integers(-2 ** 63, 2 ** 63 - 1, size=40_000, dtype=np.int64),
        rng.integers(0, 1 << 20, size=30_000).astype(np.int64),
        rng.integers(0, 1 << 20, size=30_000).astype(np.int64)
        + (rng.integers(0, 32, size=30_000).astype(np.int64) << 58),
        np.array([0, -1, 2 ** 63 - 1, -2 ** 63], np.int64)])
    got = route_owner(torch.from_numpy(keys), W).numpy()
    np.testing.assert_array_equal(got, route_owner_np(keys, W))
