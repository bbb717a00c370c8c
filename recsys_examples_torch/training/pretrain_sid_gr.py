"""SID-GR pretraining entry point (counterpart of
recsys_examples_tpu/training/pretrain_sid_gr.py).

Usage:
    python -m recsys_examples_torch.training.pretrain_sid_gr \\
        [--gin-config-file configs/sid_gr_random.gin] [--max-train-iters N] \\
        [--device cuda|cpu]

A step is `SIDGRModel.forward(train=True)`, its backward and an Adam step
with optax's semantics (`training/train_state.py`); eval runs
`generate_beam_decode` (kernel K7 on the card) and `sid_eval_metrics`.
`--device` defaults to CUDA and raises without a card.

Dropout draws its bits from one generator seeded once from
`SIDTrainerArgs.seed`, so every step draws a fresh mask. (The JAX entry
hands the same dropout key to every step, so there every step draws the same
mask; both shipped configs train at dropout 0.)
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import time

import numpy as np
import torch

from recsys_examples_torch.data.sid_batch import random_sid_batch
from recsys_examples_torch.models.sid_gr import SIDGRConfig, SIDGRModel
from recsys_examples_torch.modules.sid_eval_metrics import sid_eval_metrics
from recsys_examples_torch.training.train_state import make_optimizer
from recsys_examples_torch.utils import gin_config
from recsys_examples_torch.utils.device import resolve_device
from recsys_examples_torch.utils.gin_config import configurable
from recsys_examples_torch.utils.logger import print_rank_0
from recsys_examples_torch.utils.watchdog import watched_iter


@configurable
@dataclasses.dataclass(frozen=True)
class SIDTrainerArgs:
    max_train_iters: int = 100
    log_interval: int = 10
    eval_interval: int = 0
    eval_iters: int = 4
    batch_size: int = 32
    max_history_items: int = 64
    seed: int = 1234
    learning_rate: float = 1e-3


@configurable
@dataclasses.dataclass(frozen=True)
class SIDDatasetArgs:
    """dataset_name "random" keeps the synthetic generator; "file" trains
    from a preprocessed sequence npz + PID->SID mapping file."""

    dataset_name: str = "random"
    sequence_path: str = ""
    sid_mapping_path: str = ""
    shuffle: bool = True


@configurable
@dataclasses.dataclass(frozen=True)
class SIDNetworkArgs:
    num_hierarchies: int = 4
    codebook_size: int = 256
    hidden_size: int = 256
    num_layers: int = 4
    num_heads: int = 4
    head_dim: int = 64
    ffn_hidden: int = 1024
    dropout: float = 0.0
    share_lm_head: bool = False
    beam_width: int = 32
    dtype: str = "float32"


# final-eval metrics of the last main() run, and its step times (ms, each
# ended by reading the step's loss back), for harnesses
LAST_EVAL: dict = {}
LAST_STEP_MS: list = []


def _batches(ta, na, da):
    """(make_batch(i), make_eval_batches()) for the configured data."""
    if da.dataset_name == "file":
        from recsys_examples_torch.data.sid_sequence_dataset import (
            SIDSequenceDataset,
            load_sequences,
            load_sid_mapping,
        )

        flat, offs, _users, _n_items = load_sequences(da.sequence_path)
        mapping = load_sid_mapping(da.sid_mapping_path, na.num_hierarchies)
        if int(mapping.max()) >= na.codebook_size:
            raise ValueError("SID mapping exceeds codebook_size")
        train_ds = SIDSequenceDataset(
            flat, offs, mapping, batch_size=ta.batch_size,
            max_history_items=ta.max_history_items, split="train",
            shuffle=da.shuffle, seed=ta.seed, drop_last=True,
        )
        eval_ds = SIDSequenceDataset(
            flat, offs, mapping, batch_size=ta.batch_size,
            max_history_items=ta.max_history_items, split="eval",
            shuffle=False, drop_last=True,
        )
        train_iter = [iter(train_ds)]

        def make_batch(i):
            # cycle epochs, reshuffling each pass
            try:
                return next(train_iter[0])
            except StopIteration:
                train_ds.seed += 1
                train_iter[0] = iter(train_ds)
                return next(train_iter[0])

        return make_batch, lambda: iter(eval_ds)

    def make_batch(i):
        return random_sid_batch(ta.seed + i, ta.batch_size, ta.max_history_items,
                                na.num_hierarchies, na.codebook_size)

    return make_batch, lambda: None


def main(argv=None) -> SIDGRModel:
    """Train (and evaluate) as configured; returns the trained model."""
    p = argparse.ArgumentParser(prog="pretrain_sid_gr")
    p.add_argument("--gin-config-file", default=None)
    p.add_argument("--max-train-iters", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; cpu for tests)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if args.gin_config_file:
        gin_config.parse_config_file(args.gin_config_file)
    ta = gin_config.make("SIDTrainerArgs")
    if args.max_train_iters is not None:
        ta = dataclasses.replace(ta, max_train_iters=args.max_train_iters)
    na = gin_config.make("SIDNetworkArgs")
    da = gin_config.make("SIDDatasetArgs")

    cfg = SIDGRConfig(
        num_hierarchies=na.num_hierarchies,
        codebook_size=na.codebook_size,
        hidden_size=na.hidden_size,
        num_layers=na.num_layers,
        num_heads=na.num_heads,
        head_dim=na.head_dim,
        ffn_hidden=na.ffn_hidden,
        dropout=na.dropout,
        share_lm_head=na.share_lm_head,
        beam_width=na.beam_width,
        dtype=torch.bfloat16 if na.dtype == "bfloat16" else torch.float32,
    )
    make_batch, make_eval_batches = _batches(ta, na, da)
    # the JAX entry draws one batch to shape its init and trains from the
    # next draw on; the port draws it too, so both train on the same stream
    make_batch(0)
    model = SIDGRModel(cfg, device=device).init_weights(
        torch.Generator(device=device).manual_seed(ta.seed))
    opt = make_optimizer(ta.learning_rate, "adam")(model.parameters())
    dropout_gen = torch.Generator(device=device).manual_seed(ta.seed)

    print_rank_0(f"SID-GR training: {ta.max_train_iters} iters")
    losses = []
    LAST_STEP_MS.clear()
    t0 = time.perf_counter()
    for i in watched_iter(range(ta.max_train_iters), timeout=600):
        t_step = time.perf_counter()
        batch = make_batch(i)
        loss, _ = model(batch, train=True, generator=dropout_gen)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        LAST_STEP_MS.append((time.perf_counter() - t_step) * 1e3)
        if (i + 1) % ta.log_interval == 0:
            print_rank_0(
                f"iter {i + 1}: loss={np.mean(losses[-ta.log_interval:]):.5f} "
                f"step={LAST_STEP_MS[-1]:.2f}ms"
            )
        if ta.eval_interval and (i + 1) % ta.eval_interval == 0:
            run_eval(model, ta, na, eval_batches=make_eval_batches())
    print_rank_0(f"done in {time.perf_counter() - t0:.1f}s")
    agg = run_eval(model, ta, na, eval_batches=make_eval_batches())
    LAST_EVAL.clear()
    LAST_EVAL.update(agg)
    return model


def run_eval(model: SIDGRModel, ta, na, eval_batches=None) -> dict:
    """Mean recall/ndcg@{1,5,10} and MRR of `generate_beam_decode` over
    `ta.eval_iters` batches (synthetic ones when `eval_batches` is None).
    The params are the model's own."""
    if eval_batches is None:
        eval_batches = (
            random_sid_batch(777 + j, ta.batch_size, ta.max_history_items,
                             na.num_hierarchies, na.codebook_size)
            for j in range(ta.eval_iters)
        )
    ms = []
    for batch in itertools.islice(eval_batches, ta.eval_iters):
        batch = batch.to(model.device)
        paths, _ = model.generate_beam_decode(batch)
        ms.append(sid_eval_metrics(paths, batch.candidate_sids))
    if not ms:
        print_rank_0("eval: no batches")
        return {}
    agg = {k: float(np.mean([float(m[k]) for m in ms])) for k in ms[0]}
    print_rank_0("eval: " + ", ".join(f"{k}={v:.4f}" for k, v in agg.items()))
    return agg


if __name__ == "__main__":
    main()
