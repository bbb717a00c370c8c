"""Carry weights and state across from the JAX package's numpy form.

All inputs are numpy arrays (or anything `np.asarray` takes), so nothing
here needs JAX:
  - `dense_state_dict` / `flax_params`: a flax param tree (an
    `InferenceDenseModule`'s, a whole `RankingGR`'s or a `SIDGRModel`'s:
    `codebook_i/embedding`, `bos_token`, `decoder/layer_i/{ln1,ln2,attn/
    {q,k,v,proj},fc1,fc2}`, `decoder/final_ln`, `lm_head_i`) -> the port's
    `state_dict()`, and back to numpy. flax `Dense` kernels are [in, out]
    and become `nn.Linear.weight` [out, in]. A layer's
    `relative_bias/rel_bias` crosses like any other param.
  - `table_state`: an `InferenceTableState`'s keys/values -> the port's.
  - `kvcache_state` / `kvcache_to_numpy`: a `KVCacheState` as a mapping of
    field name -> array, both ways.
  - `dynamic_table_state` / `dynamic_table_to_numpy`: a training
    `DynamicEmbTableState` (hash table, optional admission counter table,
    step) as nested mappings of field name -> array, both ways.
  - `tp_state_dict` / `merge_tp_state_dicts`: a flax param tree -> one
    tensor-parallel rank's shards of the port's state_dict, following
    `parallel.mesh.TP_PARTITIONS`; and the ranks' shards -> the unsharded
    state_dict (which `flax_params` turns into the tree).
  - `dynamic_table_shard`: the JAX package's row-sharded table state (each
    leaf the W shards' arrays stacked on the leading dim, as its
    `shard_map` lays them out) -> one data rank's state.
  - `qwen3_state_dict`: a `Qwen3Model`'s flax tree (from `init` or from the
    JAX `load_hf_weights`) -> the port's `Qwen3Model` state_dict.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from recsys_examples_torch.dynamicemb.batched_table import DynamicEmbTableState
from recsys_examples_torch.dynamicemb.exportable_tables import InferenceTableState
from recsys_examples_torch.dynamicemb.hashtable import HashTableState
from recsys_examples_torch.inference.kvcache import KVCacheState
from recsys_examples_torch.parallel.mesh import partition_dim, shard_tensor

KVCACHE_FIELDS = (
    "k_pages", "v_pages", "user_ids", "user_len", "user_pages", "user_lru",
    "page_owner", "clock",
)
HASH_TABLE_FIELDS = (
    "keys", "scores", "values", "opt", "inserted", "evicted", "overflowed",
)


def to_torch(x, device="cpu") -> torch.Tensor:
    """numpy -> torch, bit-preserving; bfloat16 arrays (ml_dtypes) go
    through fp32, which holds every bf16 value exactly."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch -> numpy; bf16 comes back as fp32 (exact)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _torch_name(part: str) -> str:
    prefix, _, i = part.rpartition("_")
    return f"layers.{i}" if prefix == "layer" and i.isdigit() else part


def dense_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax param tree (nested dicts, unboxed) -> the port's state_dict.

    Module names map one to one, except that flax's `layer_i` is the port's
    `layers.i` and a `Dense` kernel [in, out] becomes `nn.Linear.weight`
    [out, in]."""
    sd = {}

    def walk(tree, path):
        for name, sub in tree.items():
            if isinstance(sub, Mapping):
                walk(sub, path + [_torch_name(name)])
            elif name == "kernel" and np.ndim(sub) == 2:
                sd[".".join(path + ["weight"])] = np.asarray(sub).T
            else:
                sd[".".join(path + [name])] = sub

    walk(params, [])
    return {k: to_torch(v) for k, v in sd.items()}


def qwen3_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """A `Qwen3Model` flax tree (with or without its {"params": ...} wrapper)
    -> the port's state_dict: `dense_state_dict`'s rules, and flax
    `nn.Embed`'s `embed_tokens.embedding` is `embed_tokens.weight`."""
    params = params.get("params", params)
    sd = dense_state_dict(params)
    sd["embed_tokens.weight"] = sd.pop("embed_tokens.embedding")
    return sd


def flax_path(key: str) -> Tuple[Tuple[str, ...], bool]:
    """A state_dict key -> its path in the flax param tree, and whether the
    tensor is an `nn.Linear.weight` (the transpose of flax's kernel)."""
    parts = key.split(".")
    names = []
    for i, part in enumerate(parts):
        if i > 0 and parts[i - 1] == "layers":
            names[-1] = f"layer_{part}"
        else:
            names.append(part)
    if names[-1] == "weight":
        names[-1] = "kernel"
        return tuple(names), True
    return tuple(names), False


def flax_params(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The inverse of `dense_state_dict`: a state_dict -> the flax param
    tree, as numpy arrays (for comparing params after a train step)."""
    tree: Dict = {}
    for key, t in state_dict.items():
        names, transposed = flax_path(key)
        value = to_numpy(t).T if transposed else to_numpy(t)
        node = tree
        for n in names[:-1]:
            node = node.setdefault(n, {})
        node[names[-1]] = value
    return tree


def table_state(keys, values, device="cpu") -> InferenceTableState:
    return InferenceTableState(
        keys=to_torch(keys, device), values=to_torch(values, device)
    )


def kvcache_state(arrays: Mapping, device="cpu") -> KVCacheState:
    return KVCacheState(**{f: to_torch(arrays[f], device) for f in KVCACHE_FIELDS})


def kvcache_to_numpy(state: KVCacheState) -> Dict[str, np.ndarray]:
    return {f: to_numpy(getattr(state, f)) for f in KVCACHE_FIELDS}


def _hash_table(arrays: Optional[Mapping], device) -> Optional[HashTableState]:
    if arrays is None:
        return None
    return HashTableState(**{
        f: None if arrays[f] is None else to_torch(arrays[f], device).contiguous()
        for f in HASH_TABLE_FIELDS})


def dynamic_table_state(arrays: Mapping, device="cpu") -> DynamicEmbTableState:
    """{"table": {field: array}, "counter": {field: array} or None,
    "step": [1] int64} (the leaves of a JAX `DynamicEmbTableState`, `opt`
    None for sgd) -> the port's state on `device`."""
    return DynamicEmbTableState(
        table=_hash_table(arrays["table"], device),
        counter=_hash_table(arrays.get("counter"), device),
        step=to_torch(arrays["step"], device))


def dynamic_table_to_numpy(state: DynamicEmbTableState) -> Dict:
    """The inverse of `dynamic_table_state`."""
    tab = lambda h: None if h is None else {
        f: None if getattr(h, f) is None else to_numpy(getattr(h, f))
        for f in HASH_TABLE_FIELDS}
    return {"table": tab(state.table), "counter": tab(state.counter),
            "step": to_numpy(state.step)}


def tp_state_dict(params: Mapping, tp: int, rank: int) -> Dict[str, torch.Tensor]:
    """A flax param tree -> tensor-parallel rank `rank`'s state_dict (of
    `tp`): the params that `TP_PARTITIONS` splits cut to the rank's heads."""
    return {k: shard_tensor(v, partition_dim(k), tp, rank).clone()
            for k, v in dense_state_dict(params).items()}


def merge_tp_state_dicts(shards) -> Dict[str, torch.Tensor]:
    """The tensor-parallel ranks' state_dicts (in rank order) -> the
    unsharded state_dict (replicated params from rank 0)."""
    out = {}
    for k, v in shards[0].items():
        d = partition_dim(k)
        out[k] = v if d is None or len(shards) == 1 else torch.cat([s[k] for s in shards], d)
    return out


def dynamic_table_shard(arrays: Mapping, world: int, rank: int,
                        device="cpu") -> DynamicEmbTableState:
    """Data rank `rank`'s state from the nested mapping of a JAX table state
    row-sharded over `world` ranks: every leaf is cut to its rank-th equal
    part of the leading dim (keys and scores [W nb, C], values and opt
    [W cap, dim], the counters and step [W])."""
    cut = lambda a: None if a is None else np.split(np.asarray(a), world)[rank]
    tab = lambda h: None if h is None else {f: cut(h[f]) for f in HASH_TABLE_FIELDS}
    return dynamic_table_state({"table": tab(arrays["table"]),
                                "counter": tab(arrays.get("counter")),
                                "step": cut(arrays["step"])}, device)
