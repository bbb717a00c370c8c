"""Workload-balanced data-parallel batch shuffling on the host (counterpart
of recsys_examples_tpu/data/batch_shuffler.py).

A global batch is re-permuted in numpy before it reaches a device, so that
each data-parallel rank's contiguous block of samples carries an even share
of the attention work. Cost model: HSTU work per sample ~ n^2 + 8 n
(n = tokens), the quadratic attention term dominating.

The partitioners are the native C++ cores of `csrc/kk_partition.cpp`
(Karmarkar-Karp largest differencing with equal part sizes, and greedy LPT
with a per-part cap), built by `utils/native.py`, with a numpy LPT when the
library cannot be built.
"""
from __future__ import annotations

import ctypes
import dataclasses
import heapq
import warnings
from typing import Tuple

import numpy as np

from recsys_examples_torch.data.hstu_batch import JaggedIds


def hstu_sample_cost(
    seqlen: np.ndarray, hidden: int = 1, heads_x_dim: int = 1
) -> np.ndarray:
    """Per-sample attention+GEMM cost estimate."""
    n = seqlen.astype(np.float64)
    return n * n + 8.0 * n


def _lpt_python(costs: np.ndarray, num_parts: int) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy longest-processing-time with a per-part cardinality cap."""
    n = len(costs)
    per = (n + num_parts - 1) // num_parts
    order = np.argsort(-costs)
    loads = [(0.0, i) for i in range(num_parts)]
    heapq.heapify(loads)
    counts = np.zeros(num_parts, np.int64)
    assign = np.zeros(n, np.int64)
    spill = []
    for idx in order:
        load, part = heapq.heappop(loads)
        while counts[part] >= per:
            spill.append((load, part))
            load, part = heapq.heappop(loads)
        assign[idx] = part
        counts[part] += 1
        heapq.heappush(loads, (load + float(costs[idx]), part))
        for it in spill:
            heapq.heappush(loads, it)
        spill.clear()
    part_loads = np.zeros(num_parts)
    np.add.at(part_loads, assign, costs)
    return assign, part_loads


def karmarkar_karp(
    costs: np.ndarray, num_parts: int, *, method: str = "best"
) -> Tuple[np.ndarray, np.ndarray]:
    """Multiway partition with equal per-part cardinality.

    Returns (assignment [N] in [0, num_parts), part_loads [num_parts]).

    method="kk": Karmarkar-Karp largest differencing (native core).
    method="lpt": greedy LPT with a per-part cap (native, or numpy without
    the library).
    method="best" (default): both, keeping the lower max-load; without the
    native library, LPT alone (KK would be the same numpy LPT).
    """
    from recsys_examples_torch.utils.native import kk_partition_lib

    lib = kk_partition_lib()
    if method == "best":
        if lib is None:
            return karmarkar_karp(costs, num_parts, method="lpt")
        a_kk, l_kk = karmarkar_karp(costs, num_parts, method="kk")
        a_lpt, l_lpt = karmarkar_karp(costs, num_parts, method="lpt")
        return (a_kk, l_kk) if l_kk.max() < l_lpt.max() else (a_lpt, l_lpt)
    if lib is None:
        if method == "kk":
            warnings.warn(
                "karmarkar_karp(method='kk'): csrc/kk_partition.cpp could not be "
                "built; falling back to greedy LPT (NOT the KK algorithm)",
                RuntimeWarning, stacklevel=2)
        return _lpt_python(costs, num_parts)
    native_fn = lib.kk_partition if method == "kk" else lib.lpt_partition
    n = len(costs)
    per = (n + num_parts - 1) // num_parts
    c = np.ascontiguousarray(costs, np.float64)
    assign = np.zeros(n, np.int32)
    loads = np.zeros(num_parts, np.float64)
    native_fn(
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(n), ctypes.c_int32(num_parts), ctypes.c_int64(per),
        assign.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        loads.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return assign.astype(np.int64), loads


def balanced_permutation(seqlen: np.ndarray, num_parts: int) -> np.ndarray:
    """Permutation that groups samples into load-balanced contiguous
    DP-rank blocks (rank r gets perm[r*per:(r+1)*per])."""
    assign, _ = karmarkar_karp(hstu_sample_cost(seqlen), num_parts)
    return np.argsort(assign, kind="stable")


def balance_stats(seqlen: np.ndarray, num_parts: int):
    costs = hstu_sample_cost(seqlen)
    _, loads = karmarkar_karp(costs, num_parts)
    naive = costs.reshape(num_parts, -1).sum(axis=1)
    return {
        "balanced_max_over_mean": float(loads.max() / max(loads.mean(), 1e-9)),
        "naive_max_over_mean": float(naive.max() / max(naive.mean(), 1e-9)),
    }


def _permute_jagged(vals: np.ndarray, offs: np.ndarray, lens: np.ndarray,
                    perm: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(values, lengths, offsets) with the samples in `perm`'s order."""
    new_lens = lens[perm]
    new_offs = np.concatenate([[0], np.cumsum(new_lens)]).astype(offs.dtype)
    out = np.zeros_like(vals)
    for j, src in enumerate(perm):
        n = new_lens[j]
        out[new_offs[j]:new_offs[j] + n] = vals[offs[src]:offs[src] + n]
    return out, new_lens, new_offs


def shuffle_hstu_batch(batch, num_parts: int):
    """Reorder an HSTUBatch's samples by the balanced permutation so that
    DP rank r's contiguous sample block [r*per, (r+1)*per) carries an even
    share of the O(n^2) attention work. numpy leaves in, numpy leaves out."""
    item = batch.features[batch.item_feature_name]
    lengths = np.asarray(item.lengths)
    perm = balanced_permutation(lengths, num_parts)

    def reorder_feature(f: JaggedIds) -> JaggedIds:
        vals, lens, offs = _permute_jagged(
            np.asarray(f.values), np.asarray(f.offsets), np.asarray(f.lengths), perm)
        return JaggedIds(values=vals, lengths=lens, offsets=offs, max_len=f.max_len)

    feats = {n: reorder_feature(f) for n, f in batch.features.items()}
    kw = {}
    if batch.num_candidates is not None:
        kw["num_candidates"] = np.asarray(batch.num_candidates)[perm]
    if batch.labels is not None:
        B = batch.batch_size
        lab = np.asarray(batch.labels)
        cap_per = lab.shape[0] // B
        kw["labels"] = lab.reshape(B, cap_per)[perm].reshape(-1)
        kw["label_lengths"] = np.asarray(batch.label_lengths)[perm]
    if batch.timestamps is not None:
        # timestamps align with the item values: the item feature's permutation
        kw["timestamps"], _, _ = _permute_jagged(
            np.asarray(batch.timestamps), np.asarray(item.offsets), lengths, perm)
    return dataclasses.replace(batch, features=feats, **kw)
