"""Carry weights and state across from the JAX package's numpy form.

All inputs are numpy arrays (or anything `np.asarray` takes), so nothing
here needs JAX:
  - `dense_state_dict` / `flax_params`: a flax param tree (an
    `InferenceDenseModule`'s or a whole `RankingGR`'s) -> the port's
    `state_dict()`, and back to numpy. flax `Dense` kernels are [in, out]
    and become `nn.Linear.weight` [out, in].
  - `table_state`: an `InferenceTableState`'s keys/values -> the port's.
  - `kvcache_state` / `kvcache_to_numpy`: a `KVCacheState` as a mapping of
    field name -> array, both ways.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from recsys_examples_torch.dynamicemb.exportable_tables import InferenceTableState
from recsys_examples_torch.inference.kvcache import KVCacheState

KVCACHE_FIELDS = (
    "k_pages", "v_pages", "user_ids", "user_len", "user_pages", "user_lru",
    "page_owner", "clock",
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


def flax_params(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The inverse of `dense_state_dict`: a state_dict -> the flax param
    tree, as numpy arrays (for comparing params after a train step)."""
    tree: Dict = {}
    for key, t in state_dict.items():
        parts = key.split(".")
        names = []
        for i, part in enumerate(parts):
            if i > 0 and parts[i - 1] == "layers":
                names[-1] = f"layer_{part}"
            else:
                names.append(part)
        value = to_numpy(t)
        if names[-1] == "weight":
            names[-1], value = "kernel", value.T
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
