"""HSTU retrieval pretraining entry point (counterpart of
recsys_examples_tpu/training/pretrain_gr_retrieval.py): HSTU encoder +
in-batch-negative sampled softmax; eval = HR@k / NDCG@k / MRR of the held-out
next item ranked against the batch's target embeddings.

Usage:
    python -m recsys_examples_torch.training.pretrain_gr_retrieval \\
        --gin-config-file configs/retrieval_movielens_1m.gin \\
        [--max-train-iters N] [--device cuda|cpu]

`--device` defaults to CUDA and raises without a card. The mesh, the
batch sharding and the training loop (checkpoints included) are
`pretrain_gr_ranking`'s, also under `torchrun`. Under data parallelism the
in-batch negatives of the loss are the global batch's targets, gathered over
the data axis, and every data rank evaluates whole eval batches (see
`run_eval`). As in the JAX package, this
entry has no embedding cache: `DynamicEmbeddingArgs.caching` leaves its
tables as they are.
"""
from __future__ import annotations

import torch

from recsys_examples_torch.data.hstu_batch import random_hstu_batch
from recsys_examples_torch.data.sequence_dataset import make_sequence_dataset
from recsys_examples_torch.models.retrieval_gr import RetrievalGR
from recsys_examples_torch.modules.config import RetrievalConfig
from recsys_examples_torch.modules.metrics import (
    RetrievalMetricState,
    retrieval_compute,
    retrieval_update,
)
from recsys_examples_torch.training import gin_args  # noqa: F401 (registers)
from recsys_examples_torch.training.pretrain_gr_ranking import (
    build_hstu_config,
    build_mesh,
    build_sparse_tables,
    read_args,
    static_tables,
    train,
)
from recsys_examples_torch.training.train_state import make_optimizer
from recsys_examples_torch.training.trainer import GRTrainer, GRTrainState
from recsys_examples_torch.utils import gin_config
from recsys_examples_torch.utils.logger import print_rank_0


def _parse_ks(eval_metrics) -> tuple:
    ks = []
    for m in eval_metrics:
        if "@" in m:
            ks.append(int(m.split("@")[1]))
    return tuple(sorted(set(ks))) or (10,)


# the profile of the last main()'s `TrainerArgs.profile` window, for tools
LAST_PROFILE = None


def main(argv=None):
    global LAST_PROFILE
    device, trainer_args = read_args(argv, "pretrain_gr_retrieval")
    ds = gin_config.make("DatasetArgs")
    net = gin_config.make("NetworkArgs")
    opt = gin_config.make("OptimizerArgs")
    demb = gin_config.make("DynamicEmbeddingArgs")
    tpa = gin_config.make("TensorModelParallelArgs")
    ret_args = gin_config.make("RetrievalArgs")

    device, mesh = build_mesh(device, tpa.tensor_model_parallel_size)
    hstu_cfg = build_hstu_config(net, tpa.tensor_model_parallel_size,
                                 sequence_parallel=tpa.sequence_parallel)
    task_cfg = RetrievalConfig(
        embedding_configs=static_tables(ds, net, demb),
        temperature=ret_args.temperature,
        num_negatives=ret_args.num_negatives,
        eval_metrics=tuple(ret_args.eval_metrics),
    )
    trainer = GRTrainer(
        RetrievalGR(hstu_cfg, task_cfg, device=device, mesh=mesh),
        make_optimizer(opt.learning_rate, opt.optimizer_str, opt.adam_beta1,
                       opt.adam_beta2, opt.adam_eps, opt.weight_decay),
        build_sparse_tables(ds, net, demb, device, mesh), device=device, mesh=mesh,
    )
    state, LAST_PROFILE = train(
        trainer, ds, net, trainer_args,
        lambda st: run_eval(trainer, st, ds, trainer_args, ret_args),
        "retrieval training")
    return state


LAST_EVAL = None
EVAL_HISTORY = []


def _eval_batches(ds, trainer_args, iters):
    """Holdout batches for file datasets (leave-one-out: the target is the
    true held-out next item); synthetic random ones otherwise."""
    if ds.dataset_name == "random":
        for j in range(iters):
            yield random_hstu_batch(
                seed=77771 + j,
                batch_size=ds.batch_size,
                max_history_len=ds.max_history_len,
                item_vocab=ds.item_vocab_size,
                action_vocab=ds.action_vocab_size,
                max_num_candidates=ds.max_num_candidates,
                num_tasks=ds.num_tasks,
            )
        return
    nc_eval = ds.eval_max_num_candidates or ds.max_num_candidates
    sd = make_sequence_dataset(ds, max_num_candidates=nc_eval)
    yield from sd.batches(ds.batch_size, train=False, seed=0, shuffle=False)


def run_eval(trainer: GRTrainer, state: GRTrainState, ds, trainer_args, ret_args,
             iters=8):
    """Rank the true next item among the batch's target embeddings.

    As in the JAX entry, a row is ranked against the targets of every row
    of the eval batch, valid or not: in the packed batch a sequence's last
    row points at the next sample's first item. A data rank's block of
    samples has other targets at its edges, so under data parallelism every
    rank evaluates the whole eval batch (the tables serve its keys through
    the exchange) and holds the global metric state."""
    ks = _parse_ks(ret_args.eval_metrics)
    mstate = RetrievalMetricState.init(len(ks), device=trainer.device)
    for batch in _eval_batches(ds, trainer_args, iters):
        _, aux = trainer.eval_step(state, batch)
        q = aux["query_emb"].float()                     # [Tq, D]
        tids = aux["target_ids"]
        # candidate corpus = the batch's target embeddings; the true item's
        # rank among them by dot-product score, other rows of its id aside
        scores = q @ aux["target_emb"].float().T         # [Tq, Tq]
        own = torch.diagonal(scores)
        same_item = tids[None, :] == tids[:, None]
        rank = 1 + ((scores > own[:, None]) & ~same_item).sum(1)
        mstate = retrieval_update(mstate, rank, aux["valid"], ks)
    vals = retrieval_compute(mstate, ks)
    global LAST_EVAL
    LAST_EVAL = {k: float(v) for k, v in vals.items()}
    EVAL_HISTORY.append(LAST_EVAL)
    print_rank_0("eval " + ", ".join(f"{k}={v:.4f}" for k, v in LAST_EVAL.items()))


if __name__ == "__main__":
    main()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
