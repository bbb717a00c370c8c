"""Checkpoint save/load (counterpart of recsys_examples_tpu/training/checkpoint.py).

Two parts:
  - dense: `torch.save` of the model's and the optimizer's `state_dict`
    and the step, in `<path>/dense.pt` (the JAX package writes orbax here);
  - dynamic tables: per table the compacted live (key, score, value row,
    optimizer row) arrays in `<path>/dynamicemb_module/<name>.npz` with a
    `<name>.meta.json` beside it. The format is the JAX package's, so a table
    dumped by either package loads into the other. A load re-inserts the
    keys through the hash path: slots may differ from the dumped table's,
    but every key returns its row, whatever the world size.

Under a mesh the dense state is saved unsharded, once: the params split over
"model" (and their optimizer state) are gathered and rank 0 writes them; a
load splits them again for the loading mesh. Each data rank of model index 0
dumps its table shard as `<name>.<rank>-of-<W>.npz`; a load reads every
shard file (or the single `<name>.npz`) and inserts the keys that the
loading rank owns (`route_owner` at its own world size). So a checkpoint
saved at one world size loads at any other.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from recsys_examples_torch.dynamicemb.batched_table import (
    DynamicEmbeddingTable,
    DynamicEmbTableState,
)
from recsys_examples_torch.dynamicemb.dynamicemb_config import EMPTY_KEY
from recsys_examples_torch.dynamicemb.hashtable import insert_and_evict
from recsys_examples_torch.dynamicemb.sharded_collection import route_owner
from recsys_examples_torch.parallel.mesh import MODEL_AXIS, partition_dim, shard_tensor
from recsys_examples_torch.training.trainer import GRTrainState

DENSE_FILE = "dense.pt"


def _gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim)


def _map_dense(state: GRTrainState, fn) -> Dict:
    """The model's and optimizer's state dicts with `fn(tensor, partition dim)`
    applied to every split param and its optimizer state."""
    names = [n for n, _ in state.model.named_parameters()]
    model = {k: fn(v, partition_dim(k)) for k, v in state.model.state_dict().items()}
    osd = state.optimizer.state_dict()
    opt = {"param_groups": osd["param_groups"], "state": {
        i: {k: fn(v, partition_dim(names[i])) if torch.is_tensor(v) and v.dim() else v
            for k, v in st.items()} for i, st in osd["state"].items()}}
    return {"model": model, "optimizer": opt, "step": state.step}


def save_dense(path: str, state: GRTrainState, mesh=None) -> None:
    """Write the unsharded dense state (rank 0 under a mesh, after the
    params split over "model" are gathered on every rank)."""
    if mesh is not None and mesh.size(MODEL_AXIS) > 1:
        g = mesh.group(MODEL_AXIS)
        dense = _map_dense(state, lambda t, d: t if d is None else _gather_dim(t, d, g))
    else:
        dense = {"model": state.model.state_dict(),
                 "optimizer": state.optimizer.state_dict(), "step": state.step}
    if mesh is None or dist.get_rank() == 0:
        os.makedirs(path, exist_ok=True)
        torch.save(dense, os.path.join(path, DENSE_FILE))


def load_dense(path: str, target: GRTrainState, mesh=None) -> GRTrainState:
    """Load into `target`'s model and optimizer, in place, on their device;
    under a mesh each rank keeps its shards of the split params."""
    device = next(target.model.parameters()).device
    dense = torch.load(os.path.join(path, DENSE_FILE), map_location=device)
    if mesh is not None and mesh.size(MODEL_AXIS) > 1:
        tp, r = mesh.size(MODEL_AXIS), mesh.index(MODEL_AXIS)
        names = [n for n, _ in target.model.named_parameters()]
        shard = lambda t, d: shard_tensor(t, d, tp, r).clone()
        dense["model"] = {k: shard(v, partition_dim(k)) for k, v in dense["model"].items()}
        for i, st in dense["optimizer"]["state"].items():
            d = partition_dim(names[i])
            for k, v in st.items():
                if torch.is_tensor(v) and v.dim():
                    st[k] = shard(v, d)
    target.model.load_state_dict(dense["model"])
    target.optimizer.load_state_dict(dense["optimizer"])
    target.step = int(dense["step"])
    return target


def dump_table(
    path: str,
    name: str,
    state: DynamicEmbTableState,
    score_threshold: int = 0,
) -> int:
    """Compacted dump of live (optionally score-filtered) entries;
    score_threshold > 0 gives incremental dumps by score. Returns the number
    of entries written."""
    keys = state.table.keys.reshape(-1).cpu().numpy()
    scores = state.table.scores.reshape(-1).cpu().numpy()
    live = keys != EMPTY_KEY
    if score_threshold > 0:
        live &= scores >= score_threshold
    rows = torch.from_numpy(np.flatnonzero(live)).to(state.table.values.device)
    os.makedirs(path, exist_ok=True)
    extra = {}
    if state.table.opt is not None:
        extra["opt"] = state.table.opt.index_select(0, rows).cpu().numpy()
    values = state.table.values.index_select(0, rows).cpu().numpy()
    np.savez(
        os.path.join(path, f"{name}.npz"),
        keys=keys[live],
        scores=scores[live],
        values=values,
        **extra,
    )
    meta = {
        "name": name,
        "num_entries": int(live.sum()),
        "value_dim": int(values.shape[1]),
        "step": int(state.step[0]),
        "score_threshold": score_threshold,
    }
    with open(os.path.join(path, f"{name}.meta.json"), "w") as f:
        json.dump(meta, f)
    return meta["num_entries"]


def _table_files(path: str, name: str) -> List[str]:
    """The dump of table `name`: `<name>.npz`, or its shards in rank order."""
    single = os.path.join(path, f"{name}.npz")
    if os.path.exists(single):
        return [single]
    shards = sorted(glob.glob(os.path.join(path, f"{name}.*-of-*.npz")))
    if not shards:
        raise FileNotFoundError(f"no dump of table {name!r} in {path}")
    return shards


def load_table(
    path: str,
    name: str,
    table: DynamicEmbeddingTable,
    state: DynamicEmbTableState,
    batch: int = 65536,
    world: int = 1,
    rank: int = 0,
) -> DynamicEmbTableState:
    """Re-insert dumped entries through the hash path into `state` (in
    place, on its device), in chunks of `batch` keys padded with EMPTY_KEY,
    as the JAX package does: both packages give the same slots. With
    `world` > 1 only the keys that `rank` owns are inserted."""
    files = _table_files(path, name)
    parts = [np.load(f) for f in files]
    keys = np.concatenate([d["keys"] for d in parts])
    scores = np.concatenate([d["scores"] for d in parts])
    values = np.concatenate([d["values"] for d in parts])
    opt = np.concatenate([d["opt"] for d in parts]) if "opt" in parts[0].files else None
    if world > 1:
        mine = (route_owner(torch.from_numpy(keys), world) == rank).numpy()
        keys, scores, values = keys[mine], scores[mine], values[mine]
        opt = None if opt is None else opt[mine]
    dev = state.table.keys.device
    vdtype = state.table.values.dtype

    def chunk(a, i, fill, dtype):
        c = torch.from_numpy(np.ascontiguousarray(a[i:i + batch])).to(dev, dtype)
        pad = batch - c.shape[0]
        if not pad:
            return c
        return torch.cat([c, torch.full((pad, *c.shape[1:]), fill, dtype=dtype, device=dev)])

    for i in range(0, len(keys), batch):
        insert_and_evict(
            state.table, chunk(keys, i, EMPTY_KEY, torch.int64),
            chunk(scores, i, 0, torch.int64), chunk(values, i, 0, vdtype),
            None if opt is None else chunk(opt, i, 0, vdtype),
            update_existing_values=True, rounds=table.options.insert_rounds)
    with open(files[0][:-len(".npz")] + ".meta.json") as f:
        meta = json.load(f)
    state.step = torch.tensor([meta["step"]], dtype=torch.int64, device=dev)
    return state


def save_checkpoint(
    path: str,
    dense_state: GRTrainState,
    sparse_states: Dict[str, DynamicEmbTableState],
    mesh=None,
) -> None:
    """Dense state and table dumps under `path`; under a mesh every rank
    calls it (the gathers are collective) and it returns when all files are
    written."""
    save_dense(path, dense_state, mesh)
    emb_dir = os.path.join(path, "dynamicemb_module")
    if mesh is None:
        for name, st in sparse_states.items():
            dump_table(emb_dir, name, st)
        return
    if mesh.index(MODEL_AXIS) == 0:
        axis = mesh.data_axis
        shard = f"{mesh.index(axis):05d}-of-{mesh.size(axis):05d}"
        for name, st in sparse_states.items():
            dump_table(emb_dir, f"{name}.{shard}", st)
    dist.barrier()


def load_checkpoint(
    path: str,
    dense_target: GRTrainState,
    tables: Dict[str, DynamicEmbeddingTable],
    mesh=None,
) -> GRTrainState:
    """`dense_target` with the saved model, optimizer and step loaded in
    place, and each of `tables` re-filled into a fresh state on the model's
    device (this rank's shard under a mesh)."""
    state = load_dense(path, dense_target, mesh)
    state.sparse = {}       # the target's own tables are replaced: free them first
    device = next(state.model.parameters()).device
    emb_dir = os.path.join(path, "dynamicemb_module")
    world, rank = (1, 0) if mesh is None else (mesh.size(mesh.data_axis),
                                               mesh.index(mesh.data_axis))
    state.sparse = {name: load_table(emb_dir, name, table, table.init_state(device),
                                     world=world, rank=rank)
                    for name, table in tables.items()}
    return state
