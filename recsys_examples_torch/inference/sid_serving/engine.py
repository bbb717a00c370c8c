"""SID-GR serving engine: bucketed batched beam generation (counterpart of
recsys_examples_tpu/inference/sid_serving/engine.py `GRServingEngine`).

Requests are padded to a (batch bucket, context bucket) shape and run the
whole prefill + KV-cached beam decode (`SIDGRModel.generate_beam_decode`,
kernel K7 on the card). PyTorch runs eagerly, so there is nothing to compile:
`compile_count` counts the (batch, ctx) buckets first seen, the number the
JAX package's jit cache would hold. The batch is built in numpy, moved to
the model's device once, and paths and scores are read back once per call.

A call runs inside the span `serve/generate`, with `serve/pack` (the
padding), the model's spans and `serve/readback` inside it. While tracing is
on it counts the prefill's padded tokens (`serve/prefill_tokens`, batch
bucket x context bucket) and the requests' own (`serve/prefill_valid_tokens`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Set, Tuple

import numpy as np

from recsys_examples_torch.data.sid_batch import SIDBatch
from recsys_examples_torch.inference.sid_serving.qwen3_runtime import qwen3_generate_beam
from recsys_examples_torch.models.sid_gr import SIDGRModel
from recsys_examples_torch.utils import observability
from recsys_examples_torch.utils.observability import named_scope


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    beam_width: int = 64
    ctx_buckets: Tuple[int, ...] = (64, 256, 1024)    # context tokens
    batch_buckets: Tuple[int, ...] = (1, 4, 8)
    max_batch_tokens: int = 16384      # admission memory budget


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} exceeds max bucket {buckets[-1]}")


class GRServingEngine:
    """`model` carries its own params and device (the card unless it was
    built with another)."""

    def __init__(self, model: SIDGRModel, cfg: ServingConfig):
        self.model = model.eval()
        self.cfg = cfg
        self._seen: Set[Tuple[int, int]] = set()
        self.compile_count = 0

    def generate(self, contexts: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
        """contexts: per-request flat SID history streams.

        Returns (paths [B, W, H] int32, scores [B, W] float32)."""
        with named_scope("serve/generate"):
            with named_scope("serve/pack"):
                B = len(contexts)
                Bb = _bucket(B, self.cfg.batch_buckets)
                H = self.model.config.num_hierarchies
                maxlen = max((len(c) for c in contexts), default=1)
                N = _bucket(max(maxlen, H), self.cfg.ctx_buckets)
                sids = np.zeros((Bb * N,), np.int32)
                lens = np.zeros((Bb,), np.int32)
                pos = 0
                for i, c in enumerate(contexts):
                    n = len(c) - (len(c) % H)  # whole items only
                    sids[pos:pos + n] = c[:n]
                    lens[i] = n
                    pos += n
                batch = SIDBatch(
                    history_sids=sids,
                    history_lengths=lens,
                    history_offsets=np.concatenate([[0], np.cumsum(lens)]).astype(np.int32),
                    candidate_sids=np.zeros((Bb, H), np.int32),
                    batch_size=Bb,
                    num_hierarchies=H,
                    max_history_tokens=N,
                )
                self._record_batch(Bb, N, lens)
            with named_scope("sid_gr/generate"):
                paths, scores = self.model.generate_beam_decode(
                    batch, beam_width=self.cfg.beam_width)
            return self._readback(paths, scores, B)

    def _record_batch(self, Bb: int, N: int, lens: np.ndarray) -> None:
        """The (Bb, N) bucket's first use, and the prefill's token counters
        (`lens`: the requests' own tokens, 0 in padding rows)."""
        if (Bb, N) not in self._seen:
            self._seen.add((Bb, N))
            self.compile_count += 1
        observability.count("serve/prefill_tokens", Bb * N)
        observability.count("serve/prefill_valid_tokens", int(lens.sum()))

    @staticmethod
    def _readback(paths, scores, B: int) -> Tuple[np.ndarray, np.ndarray]:
        with named_scope("serve/readback"):
            return (paths[:B].to("cpu").numpy().astype(np.int32),
                    scores[:B].to("cpu").numpy())

    def warmup(self):
        """Run every bucket combination once."""
        H = self.model.config.num_hierarchies
        for Bb in self.cfg.batch_buckets:
            for N in self.cfg.ctx_buckets:
                self.generate([np.zeros((min(H, N),), np.int32)] * Bb)


class Qwen3ServingEngine(GRServingEngine):
    """Serving over the Qwen3 backbone: contexts are flat SID token streams in
    the Qwen3 vocab, padded into a [batch bucket, context bucket] block; an
    empty context decodes from position 0 (its length counts as 1)."""

    def __init__(self, model, cfg: ServingConfig, num_steps: int,
                 logits_mask_fn: Optional[Callable] = None):
        super().__init__(model, cfg)
        self.num_steps = num_steps
        self.logits_mask_fn = logits_mask_fn

    def generate(self, contexts: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
        with named_scope("serve/generate"):
            with named_scope("serve/pack"):
                B = len(contexts)
                Bb = _bucket(B, self.cfg.batch_buckets)
                maxlen = max((len(c) for c in contexts), default=1)
                N = _bucket(max(maxlen, 1), self.cfg.ctx_buckets)
                tokens = np.zeros((Bb, N), np.int64)
                lens = np.zeros((Bb,), np.int64)
                for i, c in enumerate(contexts):
                    tokens[i, :len(c)] = c
                    lens[i] = len(c)
                lens = np.maximum(lens, 1)
                self._record_batch(Bb, N, lens[:B])
            # the runtime moves tokens and lengths to the card in its own
            # `serve/pack` span
            paths, scores = qwen3_generate_beam(
                self.model, tokens, lens, num_steps=self.num_steps,
                beam_width=self.cfg.beam_width, logits_mask_fn=self.logits_mask_fn)
            return self._readback(paths, scores, B)

    def warmup(self):
        for Bb in self.cfg.batch_buckets:
            for N in self.cfg.ctx_buckets:
                self.generate([np.zeros((1,), np.int32)] * Bb)
