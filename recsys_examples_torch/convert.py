"""Carry weights and state across from the JAX package's numpy form.

All inputs are numpy arrays (or anything `np.asarray` takes), so nothing
here needs JAX:
  - `dense_state_dict`: a flax `InferenceDenseModule` param tree (nested
    dicts, unboxed) -> the port's `InferenceDenseModule.state_dict()`. flax
    `Dense` kernels are [in, out] and become `nn.Linear.weight` [out, in].
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


def _index(name: str) -> int:
    prefix, _, i = name.rpartition("_")
    if prefix != "layer":
        raise KeyError(f"unexpected module name {name}")
    return int(i)


def dense_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax {hstu_block/layer_i/..., head/layer_i/...} -> state_dict."""
    sd = {}
    for name, layer in params["hstu_block"].items():
        pre = f"hstu_block.layers.{_index(name)}."
        for ln in ("input_layernorm", "output_layernorm"):
            for p in ("scale", "bias"):
                if p in layer.get(ln, {}):
                    sd[f"{pre}{ln}.{p}"] = layer[ln][p]
        sd[pre + "uvqk_kernel"] = layer["uvqk_kernel"]
        if "uvqk_bias" in layer:
            sd[pre + "uvqk_bias"] = layer["uvqk_bias"]
        sd[pre + "linear_proj.weight"] = np.asarray(layer["linear_proj"]["kernel"]).T
    for name, lin in params["head"].items():
        pre = f"head.layers.{_index(name)}."
        sd[pre + "weight"] = np.asarray(lin["kernel"]).T
        if "bias" in lin:
            sd[pre + "bias"] = lin["bias"]
    return {k: to_torch(v) for k, v in sd.items()}


def table_state(keys, values, device="cpu") -> InferenceTableState:
    return InferenceTableState(
        keys=to_torch(keys, device), values=to_torch(values, device)
    )


def kvcache_state(arrays: Mapping, device="cpu") -> KVCacheState:
    return KVCacheState(**{f: to_torch(arrays[f], device) for f in KVCACHE_FIELDS})


def kvcache_to_numpy(state: KVCacheState) -> Dict[str, np.ndarray]:
    return {f: to_numpy(getattr(state, f)) for f in KVCACHE_FIELDS}
