"""GR trainer: the dense train step (counterpart of
recsys_examples_tpu/training/trainer.py `GRTrainer`).

One step = the dense forward and backward (the JAX trainer's phase B) and
the dense optimizer update. Every table is a static `EmbeddingCollection`
table, updated by the dense optimizer with the rest of the params; the
dynamic hash tables (phases A and C) are not ported yet. PyTorch updates
the params and the optimizer state in place.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from recsys_examples_torch.data.hstu_batch import HSTUBatch
from recsys_examples_torch.training.train_state import OptimizerFactory
from recsys_examples_torch.utils.device import resolve_device


@dataclasses.dataclass
class GRTrainState:
    model: nn.Module                    # the params, updated in place
    optimizer: torch.optim.Optimizer
    step: int = 0


class GRTrainer:
    """init / train_step / eval_step for a GR model on one device (CUDA
    unless the caller passes `device="cpu"`)."""

    def __init__(self, model: nn.Module, tx: OptimizerFactory,
                 sparse_tables: Optional[Dict] = None,
                 device: Union[str, torch.device, None] = "cuda"):
        if sparse_tables:
            raise NotImplementedError("dynamic tables: slice 3")
        self.device = resolve_device(device)
        self.model = model
        self.tx = tx

    def init(self, generator: torch.Generator) -> GRTrainState:
        """Random params from `generator` (flax's init rules), on the
        trainer's device, and a fresh optimizer."""
        model = self.model.to(self.device).init_weights(generator)
        return GRTrainState(model=model, optimizer=self.tx(model.parameters()))

    def train_step(self, state: GRTrainState, batch: HSTUBatch,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[GRTrainState, Dict[str, torch.Tensor]]:
        """One fwd/bwd and optimizer step. `generator` supplies the dropout
        bits (needed when the config has dropout). The loss stays on the
        device: nothing here waits for the card."""
        batch = batch.to(self.device)
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss, _ = state.model(batch, train=True, generator=generator)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach()}

    @torch.no_grad()
    def eval_step(self, state: GRTrainState, batch: HSTUBatch):
        state.model.eval()
        return state.model(batch.to(self.device), train=False)
