"""Logits-processor pipeline for SID-GR serving (counterpart of
recsys_examples_tpu/inference/sid_serving/logits_processor.py).

Processors are functions of (step, logp [B, W, V], paths [B, W, step])
applied to each decode step's log-probabilities before beam propagation;
`SIDGRModel.beam_prefill` / `beam_step` take one as an argument. Composition
order matters: temperature rescales, top-k and constraints mask with -inf.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from recsys_examples_torch.models.beam_search import top_k_stable


class LogitsProcessor:
    """Base: __call__(step, logp [B, W, V], paths [B, W, step]) -> logp."""

    def __call__(self, step: int, logp: torch.Tensor,
                 paths: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class TemperatureProcessor(LogitsProcessor):
    """Rescale by 1/temperature then re-normalize. temperature=1 is the
    identity; <1 sharpens, >1 flattens the beam-score distribution."""

    temperature: float = 1.0

    def __call__(self, step, logp, paths):
        if self.temperature == 1.0:
            return logp
        return torch.log_softmax(logp / self.temperature, dim=-1)


@dataclasses.dataclass(frozen=True)
class TopKProcessor(LogitsProcessor):
    """Keep each beam's k best tokens, -inf the rest. k=0 disables."""

    k: int = 0

    def __call__(self, step, logp, paths):
        if self.k <= 0 or self.k >= logp.shape[-1]:
            return logp
        kth = top_k_stable(logp, self.k)[0][..., -1:]
        return torch.where(logp >= kth, logp, logp.new_full((), -torch.inf))


@dataclasses.dataclass(frozen=True)
class ConstraintProcessor(LogitsProcessor):
    """Wrap an item-constraint mask fn (built over a `TrieConstraint`):
    mask_fn(step, paths [B, W, step]) -> additive mask [B, W, V]
    (0 allowed / -inf banned)."""

    mask_fn: Callable[[int, torch.Tensor], torch.Tensor] = None

    def __call__(self, step, logp, paths):
        if self.mask_fn is None:
            return logp
        return logp + self.mask_fn(step, paths)


@dataclasses.dataclass(frozen=True)
class LogitsProcessorChain(LogitsProcessor):
    """Ordered composition."""

    processors: Tuple[LogitsProcessor, ...] = ()

    def __call__(self, step, logp, paths):
        for p in self.processors:
            logp = p(step, logp, paths)
        return logp

    def __bool__(self):
        return bool(self.processors)


def _gated(steps, step) -> bool:
    return steps is not None and step not in steps


@dataclasses.dataclass(frozen=True)
class TokenSuppressProcessor(LogitsProcessor):
    """-inf the listed token ids, optionally only at the listed hierarchy
    steps. `steps=None` = every step."""

    token_ids: Tuple[int, ...] = ()
    steps: Optional[Tuple[int, ...]] = None
    fill_value: float = -float("inf")

    def __call__(self, step, logp, paths):
        if not self.token_ids or _gated(self.steps, step):
            return logp
        mask = torch.zeros(logp.shape[-1], dtype=torch.bool, device=logp.device)
        mask[list(self.token_ids)] = True
        return torch.where(mask, logp.new_full((), self.fill_value), logp)


@dataclasses.dataclass(frozen=True)
class TokenBiasProcessor(LogitsProcessor):
    """Additive per-token log-prob bias: `token_bias` holds (token id,
    bias) pairs; a token listed twice takes both."""

    token_bias: Tuple[Tuple[int, float], ...] = ()
    steps: Optional[Tuple[int, ...]] = None

    def __call__(self, step, logp, paths):
        if not self.token_bias or _gated(self.steps, step):
            return logp
        ids = torch.tensor([t for t, _ in self.token_bias], device=logp.device)
        vals = torch.tensor([b for _, b in self.token_bias], dtype=logp.dtype,
                            device=logp.device)
        bias = torch.zeros(logp.shape[-1], dtype=logp.dtype, device=logp.device)
        return logp + bias.index_add_(0, ids, vals)


def processor_from_spec(spec: dict) -> LogitsProcessor:
    """Build a processor from an HTTP/request JSON spec."""
    ptype = spec.get("type")
    steps = spec.get("steps")
    steps = None if steps is None else tuple(int(s) for s in steps)
    if ptype in ("token_suppress", "suppress_tokens", "bad_tokens"):
        ids = spec.get("token_ids", spec.get("suppressed_token_ids"))
        if ids is None:
            raise ValueError("token_suppress requires token_ids")
        return TokenSuppressProcessor(
            tuple(int(t) for t in ids), steps=steps,
            fill_value=float(spec.get("fill_value", -float("inf"))),
        )
    if ptype in ("token_bias", "bias_tokens"):
        bias = spec.get("token_bias", spec.get("biases"))
        if bias is None:
            raise ValueError("token_bias requires token_bias")
        items = bias.items() if hasattr(bias, "items") else bias
        return TokenBiasProcessor(
            tuple((int(t), float(b)) for t, b in items), steps=steps,
        )
    if ptype == "temperature":
        return TemperatureProcessor(float(spec.get("temperature", 1.0)))
    if ptype == "top_k":
        return TopKProcessor(int(spec.get("k", 0)))
    raise ValueError(f"unsupported logits processor type: {ptype!r}")


def processors_from_specs(specs) -> LogitsProcessorChain:
    if specs is None:
        return LogitsProcessorChain(())
    return LogitsProcessorChain(tuple(processor_from_spec(s) for s in specs))


def make_chain(
    temperature: float = 1.0,
    top_k: int = 0,
    constraint_mask_fn: Optional[Callable] = None,
) -> LogitsProcessorChain:
    """The default pipeline order: temperature -> top-k -> constraints."""
    procs = []
    if temperature != 1.0:
        procs.append(TemperatureProcessor(temperature))
    if top_k > 0:
        procs.append(TopKProcessor(top_k))
    if constraint_mask_fn is not None:
        procs.append(ConstraintProcessor(constraint_mask_fn))
    return LogitsProcessorChain(tuple(procs))
