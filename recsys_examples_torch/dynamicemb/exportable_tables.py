"""Frozen (inference) dynamic tables and their export (counterpart of
recsys_examples_tpu/dynamicemb/exportable_tables.py).

A frozen table is the training table without its optimizer columns and
without mutation: a pure lookup (missing keys give zeros). `export_serialized`
packs that lookup as a `torch.export` program, serialised to bytes by
`torch.export.save` (the JAX package's jax.export artifact); `load_serialized`
reads it back. The lookup launches no custom kernel, so it exports without
`torch.library`.
"""
from __future__ import annotations

import dataclasses
import io

import torch

from recsys_examples_torch.dynamicemb.dynamicemb_config import EMPTY_KEY, hash_keys


@dataclasses.dataclass
class InferenceTableState:
    keys: torch.Tensor     # [num_buckets, C] int64
    values: torch.Tensor   # [num_buckets * C, dim] embedding columns only

    @property
    def bucket_capacity(self) -> int:
        return self.keys.shape[1]

    @property
    def num_buckets(self) -> int:
        return self.keys.shape[0]


def inference_lookup(state: InferenceTableState, keys: torch.Tensor) -> torch.Tensor:
    """Pure lookup: [n] ids -> [n, dim]; missing keys and `EMPTY_KEY` give
    zeros."""
    C = state.bucket_capacity
    keys = keys.to(torch.int64)
    b = hash_keys(keys, state.num_buckets)
    bucket_keys = state.keys[b]
    match = (bucket_keys == keys[:, None]) & (keys[:, None] != EMPTY_KEY)
    found = match.any(dim=1)
    # argmax rejects bool; on ints it returns the first maximum, as JAX does
    slot = b * C + match.to(torch.int32).argmax(dim=1)
    emb = state.values[torch.where(found, slot, torch.zeros_like(slot))]
    return torch.where(found[:, None], emb, emb.new_zeros(()))


def freeze_table(table, state) -> InferenceTableState:
    """The training state's keys and embedding columns (`table`, a
    DynamicEmbeddingTable, for the JAX package's signature). Shares the
    tensors: later training steps show through."""
    return InferenceTableState(keys=state.table.keys, values=state.table.values)


class _Lookup(torch.nn.Module):
    """`inference_lookup` over a frozen table, its tensors held as buffers."""

    def __init__(self, state: InferenceTableState):
        super().__init__()
        self.register_buffer("keys", state.keys)
        self.register_buffer("values", state.values)

    def forward(self, keys: torch.Tensor) -> torch.Tensor:
        return inference_lookup(InferenceTableState(self.keys, self.values), keys)


def export_serialized(state: InferenceTableState, sample_n: int = 1024) -> bytes:
    """The lookup of `sample_n` int64 ids as a serialised `torch.export`
    program, on the table's device."""
    sample = torch.zeros((sample_n,), dtype=torch.int64, device=state.keys.device)
    program = torch.export.export(_Lookup(state), (sample,))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_serialized(blob: bytes):
    """The program of `export_serialized`; call `.module()(keys)`."""
    return torch.export.load(io.BytesIO(blob))
