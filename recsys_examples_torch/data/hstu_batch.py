"""Batch containers and the synthetic (Zipf) batch producer for HSTU
training (counterpart of recsys_examples_tpu/data/hstu_batch.py).

The producer is numpy, a copy of the JAX package's, so the same seed gives
the same arrays. It keeps ids int64, where the JAX producer narrows them to
int32. `HSTUBatch.to(device)` makes the tensors a model takes: every integer
array becomes an int64 tensor, torch's index type.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class JaggedIds:
    """A jagged list of ids per sample (one sparse feature)."""

    values: "np.ndarray | torch.Tensor"    # [cap] ids, padded with 0
    lengths: "np.ndarray | torch.Tensor"   # [B]
    offsets: "np.ndarray | torch.Tensor"   # [B+1]
    max_len: int

    @property
    def capacity(self) -> int:
        return self.values.shape[0]


@dataclasses.dataclass
class HSTUBatch:
    """One training/eval batch.

    features: name -> JaggedIds. The item feature holds the history followed
    by the candidates (when num_candidates is set). labels: per-candidate
    (or per-item when there are no candidates) bit-encoded multi-task
    labels.
    """

    features: Dict[str, JaggedIds]
    batch_size: int
    feature_to_max_seqlen: Mapping[str, int]
    item_feature_name: str
    action_feature_name: Optional[str] = None
    contextual_feature_names: Tuple[str, ...] = ()
    max_num_candidates: int = 0
    num_candidates: "Optional[np.ndarray | torch.Tensor]" = None   # [B]
    labels: "Optional[np.ndarray | torch.Tensor]" = None           # [label_cap]
    label_lengths: "Optional[np.ndarray | torch.Tensor]" = None    # [B]
    timestamps: "Optional[np.ndarray | torch.Tensor]" = None       # item-aligned

    def to(self, device) -> "HSTUBatch":
        """The same batch with tensors on `device` (integers as int64)."""
        def t(x):
            if x is None:
                return None
            x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
            return x.to(device, torch.int64 if not x.is_floating_point() else x.dtype)

        feats = {n: dataclasses.replace(f, values=t(f.values), lengths=t(f.lengths),
                                        offsets=t(f.offsets))
                 for n, f in self.features.items()}
        return dataclasses.replace(
            self, features=feats, num_candidates=t(self.num_candidates),
            labels=t(self.labels), label_lengths=t(self.label_lengths),
            timestamps=t(self.timestamps))


def _zipf_lengths(rng: np.random.Generator, a: float, batch: int, max_len: int):
    ln = rng.zipf(a, size=(batch,)).astype(np.int64)
    # fold extreme draws back into range, keep at least 1
    ln = np.minimum((ln - 1) % max_len + 1, max_len)
    return ln.astype(np.int32)


def random_hstu_batch(
    seed: int,
    batch_size: int,
    max_history_len: int,
    item_vocab: int,
    *,
    action_vocab: int = 0,
    contextual_vocabs: Optional[Mapping[str, int]] = None,
    max_num_candidates: int = 0,
    num_tasks: int = 1,
    zipf_a: float = 1.2,
    full_capacity: bool = False,
    token_capacity: int = 0,
    value_zipf: Optional[Mapping[str, float]] = None,
) -> HSTUBatch:
    """Synthetic batch with Zipf-distributed history lengths (numpy leaves).

    `full_capacity=True` makes every sequence max-length. `token_capacity`
    sizes the item buffer (0: batch x max length; -1: the total rounded up
    to 512). `value_zipf`: feature name -> alpha; those features draw their
    ids from Zipf(alpha) folded into the vocab."""
    rng = np.random.default_rng(seed)
    value_zipf = value_zipf or {}
    if full_capacity:
        hist = np.full((batch_size,), max_history_len, np.int32)
    else:
        hist = _zipf_lengths(rng, zipf_a, batch_size, max_history_len)
    ncand = None
    if max_num_candidates > 0:
        ncand = rng.integers(1, max_num_candidates + 1, size=(batch_size,))
        ncand = ncand.astype(np.int32)
    item_len = hist + (ncand if ncand is not None else 0)
    item_max = max_history_len + max_num_candidates
    cap = batch_size * item_max
    if token_capacity == -1:
        token_capacity = int(-(-int(item_len.sum()) // 512) * 512)
    if token_capacity > 0:
        total = int(item_len.sum())
        assert token_capacity >= total, (token_capacity, total)
        cap = min(cap, token_capacity)

    def mk_ids(lengths, capacity, vocab, zipf_alpha=None):
        total = int(lengths.sum())
        vals = np.zeros((capacity,), np.int64)
        if zipf_alpha is not None:
            draw = rng.zipf(zipf_alpha, size=(total,)).astype(np.int64)
            vals[:total] = (draw - 1) % vocab
        else:
            vals[:total] = rng.integers(0, vocab, size=(total,))
        offs = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
        return JaggedIds(values=vals, lengths=lengths.astype(np.int32),
                         offsets=offs, max_len=int(capacity // batch_size))

    features = {"item": mk_ids(item_len, cap, item_vocab, value_zipf.get("item"))}
    feature_to_max_seqlen = {"item": item_max}
    action_name = None
    if action_vocab > 0:
        action_name = "action"
        features["action"] = mk_ids(
            item_len, cap, action_vocab, value_zipf.get("action")
        )
        feature_to_max_seqlen["action"] = item_max
    ctx_names = ()
    if contextual_vocabs:
        ctx_names = tuple(contextual_vocabs.keys())
        for name, vocab in contextual_vocabs.items():
            ln = np.ones((batch_size,), np.int32)
            features[name] = mk_ids(ln, batch_size, vocab, value_zipf.get(name))
            feature_to_max_seqlen[name] = 1

    if ncand is not None:
        label_len = ncand
        label_cap = batch_size * max_num_candidates
    else:
        label_len = item_len
        label_cap = cap
    total_labels = int(label_len.sum())
    lab = np.zeros((label_cap,), np.int32)
    lab[:total_labels] = rng.integers(0, 1 << num_tasks, size=(total_labels,))

    return HSTUBatch(
        features=features,
        batch_size=batch_size,
        feature_to_max_seqlen=feature_to_max_seqlen,
        item_feature_name="item",
        action_feature_name=action_name,
        contextual_feature_names=ctx_names,
        max_num_candidates=max_num_candidates,
        num_candidates=ncand,
        labels=lab,
        label_lengths=label_len.astype(np.int32),
    )
