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
"""
from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch

from recsys_examples_torch.dynamicemb.batched_table import (
    DynamicEmbeddingTable,
    DynamicEmbTableState,
)
from recsys_examples_torch.dynamicemb.dynamicemb_config import EMPTY_KEY
from recsys_examples_torch.dynamicemb.hashtable import insert_and_evict
from recsys_examples_torch.training.trainer import GRTrainState

DENSE_FILE = "dense.pt"


def save_dense(path: str, state: GRTrainState) -> None:
    os.makedirs(path, exist_ok=True)
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": state.step}, os.path.join(path, DENSE_FILE))


def load_dense(path: str, target: GRTrainState) -> GRTrainState:
    """Load into `target`'s model and optimizer, in place, on their device."""
    device = next(target.model.parameters()).device
    dense = torch.load(os.path.join(path, DENSE_FILE), map_location=device)
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


def load_table(
    path: str,
    name: str,
    table: DynamicEmbeddingTable,
    state: DynamicEmbTableState,
    batch: int = 65536,
) -> DynamicEmbTableState:
    """Re-insert dumped entries through the hash path into `state` (in
    place, on its device), in chunks of `batch` keys padded with EMPTY_KEY,
    as the JAX package does: both packages give the same slots."""
    data = np.load(os.path.join(path, f"{name}.npz"))
    keys, scores, values = data["keys"], data["scores"], data["values"]
    opt = data["opt"] if "opt" in data.files else None
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
    with open(os.path.join(path, f"{name}.meta.json")) as f:
        meta = json.load(f)
    state.step = torch.tensor([meta["step"]], dtype=torch.int64, device=dev)
    return state


def save_checkpoint(
    path: str,
    dense_state: GRTrainState,
    sparse_states: Dict[str, DynamicEmbTableState],
) -> None:
    save_dense(path, dense_state)
    emb_dir = os.path.join(path, "dynamicemb_module")
    for name, st in sparse_states.items():
        dump_table(emb_dir, name, st)


def load_checkpoint(
    path: str,
    dense_target: GRTrainState,
    tables: Dict[str, DynamicEmbeddingTable],
) -> GRTrainState:
    """`dense_target` with the saved model, optimizer and step loaded in
    place, and each of `tables` re-filled into a fresh state on the model's
    device."""
    state = load_dense(path, dense_target)
    state.sparse = {}       # the target's own tables are replaced: free them first
    device = next(state.model.parameters()).device
    emb_dir = os.path.join(path, "dynamicemb_module")
    state.sparse = {name: load_table(emb_dir, name, table, table.init_state(device))
                    for name, table in tables.items()}
    return state
