"""GR trainer: fused sparse (dynamic embedding) + dense train step
(counterpart of recsys_examples_tpu/training/trainer.py `GRTrainer`).

  one step =
    phase A  sparse forward   (no autograd: unique, lookup, insert)
    phase B  dense fwd/bwd    (autograd; grads flow to the per-token
                               embedding tensors returned by phase A)
    dense optimizer update    (torch.optim)
    phase C  sparse backward  (token grads summed per unique row, fused
                               row optimizer on the table)

Features listed in `sparse_tables` use dynamic hash tables; the others use
the model's static `EmbeddingCollection` tables, updated by the dense
optimizer. PyTorch updates the params, the optimizer state and the table
states in place.

Under a mesh (one process per rank, `parallel/mesh.py`) each rank trains on
its data rank's block of the global batch. The model's loss is the rank's
share of the global batch's loss (its numerator over the numerator and
denominator summed over the data axis: JAX's global-batch semantics); the
dense gradients are summed over the data axis before the optimizer, and the
gradients of the replicated params inside the sequence-parallel region over
"model" first. The tables exchange their keys, rows and gradients over the
data axis themselves. The logged loss and `emb_overflow` are summed over the
data axis.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn

from recsys_examples_torch.data.hstu_batch import HSTUBatch
from recsys_examples_torch.dynamicemb.batched_table import DynamicEmbTableState
from recsys_examples_torch.dynamicemb.sharded_collection import ShardedDynamicEmbedding
from recsys_examples_torch.modules.losses import data_total
from recsys_examples_torch.parallel.mesh import MODEL_AXIS, is_sp_replicated
from recsys_examples_torch.training.train_state import OptimizerFactory
from recsys_examples_torch.utils.device import resolve_device
from recsys_examples_torch.utils.observability import named_scope


@dataclasses.dataclass
class GRTrainState:
    model: nn.Module                    # the params, updated in place
    optimizer: torch.optim.Optimizer
    sparse: Dict[str, DynamicEmbTableState] = dataclasses.field(default_factory=dict)
    step: int = 0


class GRTrainer:
    """init / train_step / eval_step for a GR model on `device` (CUDA unless
    the caller passes `device="cpu"`), on one device or, with `mesh`, on this
    rank's part of the mesh (the model and the tables built on the same
    mesh).

    sparse_tables: feature name -> ShardedDynamicEmbedding for dynamic
    (hash) tables; features not listed use the model's static tables.
    """

    def __init__(self, model: nn.Module, tx: OptimizerFactory,
                 sparse_tables: Optional[Dict[str, ShardedDynamicEmbedding]] = None,
                 device: Union[str, torch.device, None] = "cuda", mesh=None):
        self.device = resolve_device(device)
        self.model = model
        self.tx = tx
        self.mesh = mesh
        self.sparse_tables = dict(sparse_tables or {})
        for name, tbl in self.sparse_tables.items():
            if tbl.device.type != self.device.type:
                raise ValueError(f"table {name!r} is on {tbl.device}, the trainer "
                                 f"on {self.device}")
            if tbl.mesh is not mesh:
                raise ValueError(f"table {name!r} and the trainer are not on one mesh")
        self.data_group = None if mesh is None else mesh.group(mesh.data_axis)
        cfg = getattr(model, "hstu_config", None)
        self.sp_group = (mesh.group(MODEL_AXIS) if cfg is not None and cfg.sequence_parallel
                         and cfg.tensor_model_parallel_size > 1 else None)

    def init(self, generator: torch.Generator) -> GRTrainState:
        """Random params from `generator` (flax's init rules), on the
        trainer's device, a fresh optimizer and empty tables."""
        model = self.model.to(self.device).init_weights(generator)
        return GRTrainState(
            model=model, optimizer=self.tx(model.parameters()),
            sparse={name: tbl.init_state() for name, tbl in self.sparse_tables.items()})

    def train_step(self, state: GRTrainState, batch: HSTUBatch,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[GRTrainState, Dict[str, torch.Tensor]]:
        """One step. `generator` supplies the dropout bits (needed when the
        config has dropout). The metrics stay on the device. With dynamic
        tables phase A reads one flag per table from the device (see
        `dynamicemb/hashtable.py`); nothing else here waits for the card.

        Spans (`utils/observability.py`): `train/step`, and inside it
        `train/h2d`, phase A's `emb/phase_a` (one a table), `train/forward`,
        `train/backward` (with the gradient reduction), `train/optimizer`,
        phase C's `emb/phase_c` and `train/metrics`."""
        with named_scope("train/step"):
            with named_scope("train/h2d"):
                batch = batch.to(self.device)
            state.model.train()
            state.optimizer.zero_grad(set_to_none=True)

            # ---- phase A: sparse forward; the embeddings are autograd leaves
            emb, residuals = {}, {}
            for name, tbl in self.sparse_tables.items():
                _, e, residuals[name] = tbl.forward(
                    state.sparse[name], batch.features[name].values, train=True)
                emb[name] = e.requires_grad_()

            # ---- phase B: dense fwd/bwd and the dense optimizer
            with named_scope("train/forward"):
                loss, _ = state.model(batch, train=True, embeddings=emb or None,
                                      generator=generator)
            with named_scope("train/backward"):
                loss.backward()
                self._reduce_grads(state.model)
            with named_scope("train/optimizer"):
                state.optimizer.step()

            # ---- phase C: sparse backward (fused row optimizer)
            for name, tbl in self.sparse_tables.items():
                tbl.backward(state.sparse[name], residuals[name], emb[name].grad)

            with named_scope("train/metrics"):
                emb_overflow = sum((r.num_overflow.sum() for r in residuals.values()),
                                   torch.zeros((), dtype=torch.int32, device=self.device))
                state.step += 1
                return state, {"loss": data_total(loss, self.data_group),
                               "emb_overflow": data_total(emb_overflow, self.data_group)}

    def _reduce_grads(self, model: nn.Module):
        """Sum the sequence-parallel region's replicated grads over "model",
        then every dense grad over the data axis (one flat buffer each; a
        param this rank's block did not reach gets a zero grad, so every
        rank's buffer has the same layout)."""
        if self.mesh is None:
            return
        params = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        for _, p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.sp_group is not None:
            _all_reduce_flat([p.grad for n, p in params if is_sp_replicated(n)], self.sp_group)
        _all_reduce_flat([p.grad for _, p in params], self.data_group)

    @torch.no_grad()
    def eval_step(self, state: GRTrainState, batch: HSTUBatch):
        """Loss and aux on `batch`; the tables are read, nothing is inserted."""
        batch = batch.to(self.device)
        state.model.eval()
        emb = {}
        for name, tbl in self.sparse_tables.items():
            _, emb[name], _ = tbl.forward(
                state.sparse[name], batch.features[name].values, train=False)
        loss, aux = state.model(batch, train=False, embeddings=emb or None)
        return data_total(loss, self.data_group), aux


def _all_reduce_flat(grads, group) -> None:
    """Sum `grads` over `group` in place, as one flat buffer."""
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))
