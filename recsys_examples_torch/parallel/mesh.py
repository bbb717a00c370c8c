"""Process groups, the (data, model) device mesh and the tensor-parallel
partition table (counterpart of recsys_examples_tpu/parallel/mesh.py).

One process per rank. The mesh is a `torch.distributed.device_mesh.DeviceMesh`
over ("data", "model"), or ("dcn", "data", "model") across slices:

  - dense params: replicated over "data" (gradients all-reduced over it by
    the trainer), the HSTU layers' head-group params split over "model" as
    `TP_PARTITIONS` says (the counterpart of flax's `nn.with_partitioning`);
  - dynamic tables: row-sharded over "data" (or ("dcn", "data")), keys, rows
    and gradients exchanged by `all_to_all_single` with exact splits
    (`dynamicemb/sharded_collection.py`);
  - batches: each data rank takes its contiguous block of the global batch's
    samples; the ranks of one data group take the same block.

Rank r sits at mesh coordinate (r // tp, r % tp), or (r // (dp tp),
(r // tp) % dp, r % tp): row-major, as the JAX package reshapes its device
list. The backend follows the device the caller asked for: NCCL for CUDA,
gloo for the CPU.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from recsys_examples_torch.utils.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
DCN_AXIS = "dcn"

Axis = Union[str, Tuple[str, ...]]


def backend_for(device: Union[str, torch.device]) -> str:
    """NCCL for a CUDA device, gloo for the CPU: never chosen by what the
    machine has."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(device: Union[str, torch.device] = "cuda", store=None,
                     rank: Optional[int] = None, world_size: Optional[int] = None
                     ) -> torch.device:
    """Join this process to the default process group and return its device.

    With `store` (a `torch.distributed.Store`, e.g. a `FileStore`), `rank`
    and `world_size` are given by the caller; without one they come from
    the `torchrun` environment (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
    `MASTER_ADDR`, `MASTER_PORT`). A CUDA device is `cuda:LOCAL_RANK`
    (`cuda:rank` with a store). A group that exists already is kept if its
    backend fits the device, and refused otherwise."""
    device = resolve_device(device)
    backend = backend_for(device)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()}, but device "
                               f"{device} needs {backend}")
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    elif store is not None:
        if rank is None or world_size is None:
            raise ValueError("a store needs rank and world_size")
        local = rank
    else:
        missing = [k for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK") if k not in os.environ]
        if missing:
            raise RuntimeError(f"init_distributed without a store needs the torchrun "
                               f"environment; {missing} not set")
        local = int(os.environ["LOCAL_RANK"])
    if device.type == "cuda":
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        if store is not None:
            dist.init_process_group(backend, store=store, rank=rank, world_size=world_size)
        else:
            dist.init_process_group(backend, init_method="env://")
    return device


class Mesh:
    """A `DeviceMesh` with named axes, and a process group for the combined
    ("dcn", "data") axis when the mesh spans slices."""

    def __init__(self, device_mesh, combined: Dict[Tuple[str, ...], "dist.ProcessGroup"]):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, device_mesh.mesh.shape))
        self._combined = combined

    @property
    def data_axis(self) -> Axis:
        """The axis the tables shard over and the dense gradients reduce
        over: "data", or ("dcn", "data") across slices."""
        return (DCN_AXIS, DATA_AXIS) if DCN_AXIS in self.shape else DATA_AXIS

    def size(self, axis: Axis) -> int:
        axes = (axis,) if isinstance(axis, str) else axis
        n = 1
        for a in axes:
            n *= self.shape[a]
        return n

    def index(self, axis: Axis) -> int:
        """This rank's coordinate along `axis` (row-major over a tuple)."""
        axes = (axis,) if isinstance(axis, str) else axis
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.device_mesh.get_local_rank(a)
        return i

    def group(self, axis: Axis) -> "dist.ProcessGroup":
        if isinstance(axis, str):
            return self.device_mesh.get_group(axis)
        if len(axis) == 1:
            return self.device_mesh.get_group(axis[0])
        return self._combined[tuple(axis)]


def make_mesh(dp: int = -1, tp: int = 1, device: Union[str, torch.device] = "cuda") -> Mesh:
    """Mesh of shape (dp, tp) with axes ("data", "model") over the default
    process group's ranks. dp=-1 uses all ranks that tp leaves. A tp that
    does not divide the world, or a dp x tp that is not the world, raises."""
    world = dist.get_world_size()
    if world % tp:
        raise ValueError(f"tensor_model_parallel_size {tp} does not divide the world "
                         f"size {world}")
    if dp == -1:
        dp = world // tp
    if dp * tp != world:
        raise ValueError(f"dp x tp = {dp} x {tp} != world size {world}")
    dm = init_device_mesh(torch.device(device).type, (dp, tp),
                          mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    return Mesh(dm, {})


def make_multislice_mesh(dp_dcn: int, dp: int = -1, tp: int = 1,
                         device: Union[str, torch.device] = "cuda") -> Mesh:
    """Mesh ("dcn", "data", "model") for data parallelism across slices
    (dcn) and dp x tp within each; ranks are ordered slice-major. Also
    makes the group of the combined ("dcn", "data") axis, which the tables
    shard over and the dense gradients reduce over."""
    world = dist.get_world_size()
    if world % dp_dcn:
        raise ValueError(f"dp_dcn {dp_dcn} does not divide the world size {world}")
    per_slice = world // dp_dcn
    if per_slice % tp:
        raise ValueError(f"tensor_model_parallel_size {tp} does not divide {per_slice} "
                         "ranks per slice")
    if dp == -1:
        dp = per_slice // tp
    if dp * tp != per_slice:
        raise ValueError(f"dp x tp = {dp} x {tp} != {per_slice} ranks per slice")
    dm = init_device_mesh(torch.device(device).type, (dp_dcn, dp, tp),
                          mesh_dim_names=(DCN_AXIS, DATA_AXIS, MODEL_AXIS))
    # one group per model index over the (dcn, data) plane; every rank takes
    # part in creating all of them, in the same order
    ranks = dm.mesh.reshape(dp_dcn * dp, tp).t().tolist()
    mine, _ = dist.new_subgroups_by_enumeration(ranks)
    return Mesh(dm, {(DCN_AXIS, DATA_AXIS): mine})


# ---------------------------------------------------------------- TP partitions
# Which dim of which HSTU-layer param is split over "model" (head groups),
# by the param's name inside a layer. The uvqk projection is column-split
# (its [D, 4, H*dh] kernel on the last dim), the output projection
# row-split (nn.Linear's [D, H*dh] weight on its input dim), and the output
# LayerNorm's elementwise params and the relative bias's per-head columns
# follow the heads. Every other param is replicated over "model".
TP_PARTITIONS: Dict[str, int] = {
    "uvqk_kernel": 2,
    "uvqk_bias": 1,
    "linear_proj.weight": 1,
    "output_layernorm.scale": 0,
    "output_layernorm.bias": 0,
    "relative_bias.rel_bias": 1,
}
# Replicated params inside the sequence-parallel region: each rank sees its
# tokens only, so their gradients are summed over "model".
SP_REPLICATED = ("input_layernorm.scale", "input_layernorm.bias")


def _layer_param(name: str) -> Optional[str]:
    """The name inside its HSTU layer of a model param name, or None."""
    parts = name.split(".")
    for i in range(len(parts) - 2):
        if parts[i] == "layers" and parts[i + 1].isdigit():
            return ".".join(parts[i + 2:])
    return None


def partition_dim(name: str) -> Optional[int]:
    """The dim of model param `name` that is split over "model", or None."""
    inner = _layer_param(name)
    return None if inner is None else TP_PARTITIONS.get(inner)


def is_sp_replicated(name: str) -> bool:
    inner = _layer_param(name)
    return inner is not None and inner in SP_REPLICATED


def shard_tensor(t: torch.Tensor, dim: Optional[int], tp: int, rank: int) -> torch.Tensor:
    """Rank `rank`'s shard of the full tensor `t` along `dim` (all of `t`
    when dim is None)."""
    if dim is None or tp == 1:
        return t
    if t.shape[dim] % tp:
        raise ValueError(f"a dim of {t.shape[dim]} does not split over tp {tp}")
    n = t.shape[dim] // tp
    return t.narrow(dim, rank * n, n)


def local_heads(num_heads: int, tp: int) -> int:
    if num_heads % tp:
        raise ValueError(f"{num_heads} heads do not split over tensor_model_parallel_size {tp}")
    return num_heads // tp


# ---------------------------------------------------------------- CPU ranks
def spawn_ranks(fn, world: int, workdir: str, *args, join: bool = True):
    """Run `fn(rank, world, *args)` in `world` new processes on the CPU, each
    joined to a gloo process group through a `FileStore` in `workdir` (no
    port is opened). `fn` must be importable by name (a module-level
    function). Waits for them and raises if a rank fails; with join=False
    returns at once a context whose `join()` does that."""
    import tempfile

    import torch.multiprocessing as mp

    store = tempfile.mktemp(prefix="store_", dir=workdir)
    return mp.start_processes(_rank_main, args=(fn, world, store, args), nprocs=world,
                              join=join, start_method="spawn")


def _rank_main(rank: int, fn, world: int, store_path: str, args) -> None:
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    init_distributed("cpu", dist.FileStore(store_path, world), rank, world)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
