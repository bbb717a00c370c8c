"""HSTU ranking pretraining entry point (counterpart of
recsys_examples_tpu/training/pretrain_gr_ranking.py): gin config -> mesh ->
dataloader -> model -> trainer -> train loop with watchdog, MFU logging,
periodic eval (AUC) and checkpointing.

Usage, on one device:
    python -m recsys_examples_torch.training.pretrain_gr_ranking \\
        --gin-config-file configs/ranking_random.gin \\
        [--max-train-iters N] [--device cuda|cpu]
and on a mesh, one process per rank:
    torchrun --nproc_per_node N -m recsys_examples_torch.training.pretrain_gr_ranking \\
        --gin-config-file configs/ranking_dryrun_cpu.gin [--device cpu]

`--device` defaults to CUDA and raises without a card. Under `torchrun` (or
with a process group that the caller started, `parallel.mesh.
init_distributed`) the entry builds the (data, model) mesh with
`TensorModelParallelArgs.tensor_model_parallel_size` ranks on "model" (a
size that does not divide the world raises): the dynamic tables are
row-sharded over "data", the HSTU layers split over "model" (with
`sequence_parallel`, their tokens too). Every rank builds the same global
batch of batch_size x dp samples from the same seed, balanced over the data
ranks when `DatasetArgs.balanced_shuffler` is set and dp > 1, and trains on
its data rank's contiguous block of samples (`shard_hstu_batch`). Without a
process group the entry trains on one device and a tensor-parallel size
above 1 raises.

`DynamicEmbeddingArgs.caching` makes the item table a cache on the card over
a host tier (`dynamicemb/hybrid_storage.py`; the action table stays
uncached): each train batch's item ids are prefetched before its step,
inside the step's timer (under a mesh each rank prefetches the global
batch's keys it owns into its shard, over its own host store). As in the
JAX package, eval batches are not prefetched (their misses read the eval
initializer) and a checkpoint holds the device tier only.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from recsys_examples_torch.data.batch_shuffler import shuffle_hstu_batch
from recsys_examples_torch.data.hstu_batch import HSTUBatch, JaggedIds, random_hstu_batch
from recsys_examples_torch.data.sequence_dataset import (
    PrefetchIterator,
    make_sequence_dataset,
)
from recsys_examples_torch.dynamicemb.batched_table import DynamicEmbeddingTable
from recsys_examples_torch.dynamicemb.dynamicemb_config import (
    DynamicEmbScoreStrategy,
    DynamicEmbTableOptions,
)
from recsys_examples_torch.dynamicemb.hybrid_storage import HybridDynamicEmbedding
from recsys_examples_torch.dynamicemb.optimizer import SparseOptimizerArgs
from recsys_examples_torch.dynamicemb.sharded_collection import (
    AdaptiveBucketing,
    ShardedDynamicEmbedding,
)
from recsys_examples_torch.models.ranking_gr import RankingGR
from recsys_examples_torch.modules.config import (
    EmbeddingConfig,
    HSTUConfig,
    PositionEncodingConfig,
    RankingConfig,
)
from recsys_examples_torch.modules.losses import decode_bits
from recsys_examples_torch.modules.metrics import AUCState, auc_compute, auc_update, sum_over
from recsys_examples_torch.parallel.mesh import init_distributed, make_mesh
from recsys_examples_torch.training import gin_args  # noqa: F401 (registers)
from recsys_examples_torch.training.checkpoint import save_checkpoint
from recsys_examples_torch.training.train_state import make_optimizer
from recsys_examples_torch.training.trainer import GRTrainer, GRTrainState
from recsys_examples_torch.utils import gin_config
from recsys_examples_torch.utils.device import resolve_device
from recsys_examples_torch.utils.logger import StepTimer, print_rank_0
from recsys_examples_torch.utils.perf import device_peak_tflops, hstu_train_flops
from recsys_examples_torch.utils.watchdog import watched_iter

KERNEL_BACKENDS = ("pallas", "jnp")


def build_hstu_config(net, tp: int, sequence_parallel: bool = False) -> HSTUConfig:
    if net.kernel_backend not in KERNEL_BACKENDS:
        raise ValueError(f"kernel_backend {net.kernel_backend!r} not in {KERNEL_BACKENDS}")
    return HSTUConfig(
        sequence_parallel=sequence_parallel and tp > 1,
        hidden_size=net.hidden_size,
        num_layers=net.num_layers,
        num_attention_heads=net.num_attention_heads,
        kv_channels=net.kv_channels,
        hidden_dropout=net.hidden_dropout,
        dtype=torch.bfloat16 if net.dtype == "bfloat16" else torch.float32,
        target_group_size=net.target_group_size,
        max_attn_len=net.max_attn_len,
        position_encoding_config=PositionEncodingConfig(
            num_position_buckets=net.position_num_buckets,
            use_time_encoding=net.use_time_encoding,
        ),
        recompute_layer=net.recompute_layer,
        scaling_seqlen=net.scaling_seqlen,
        tensor_model_parallel_size=tp,
    )


def build_mesh(device: torch.device, tp: int):
    """(device, mesh): under `torchrun` or a process group the caller
    started, this rank's device and the (data, model) mesh with `tp` ranks
    on "model"; on one device (device, None), where tp > 1 raises."""
    if not dist.is_initialized() and "WORLD_SIZE" not in os.environ:
        if tp > 1:
            raise ValueError(f"tensor_model_parallel_size {tp} does not divide the world "
                             "size 1 (start one process per rank, e.g. with torchrun)")
        return device, None
    device = init_distributed(device)
    return device, make_mesh(-1, tp, device)


def build_sparse_tables(ds, net, demb, device, mesh=None) -> dict:
    """feature -> ShardedDynamicEmbedding: the item table, and an action
    table when the dataset has actions; {} with static tables. Under a mesh
    they are row-sharded over its data axis."""
    if not demb.use_dynamic_embedding:
        return {}
    dp = 1 if mesh is None else mesh.size(mesh.data_axis)
    opt = SparseOptimizerArgs(optimizer=demb.optimizer, learning_rate=demb.learning_rate,
                              weight_decay=demb.weight_decay)
    sparse = {"item": ShardedDynamicEmbedding(DynamicEmbeddingTable(
        DynamicEmbTableOptions(
            embedding_dim=net.hidden_size,
            max_capacity=demb.capacity,
            bucket_capacity=demb.bucket_capacity,
            score_strategy=DynamicEmbScoreStrategy(demb.score_strategy),
            admission_threshold=demb.admission_threshold,
        ), opt, world_size=dp), mesh=mesh, device=device)}
    if ds.action_vocab_size > 0:
        sparse["action"] = ShardedDynamicEmbedding(DynamicEmbeddingTable(
            DynamicEmbTableOptions(
                embedding_dim=net.hidden_size,
                max_capacity=1 << 12,
                bucket_capacity=demb.bucket_capacity,
            ), opt, world_size=dp), mesh=mesh, device=device)
    return sparse


def build_cache(demb, sparse, device, mesh=None):
    """The item table's host tier and prefetch (`DynamicEmbeddingArgs.caching`
    with dynamic tables), or None."""
    if not (demb.use_dynamic_embedding and demb.caching):
        return None
    return HybridDynamicEmbedding(sparse["item"].table, mesh=mesh, device=device)


def static_tables(ds, net, demb):
    """The model's static item table when the tables are not dynamic."""
    if demb.use_dynamic_embedding:
        return ()
    return (EmbeddingConfig(("item",), "item_table", ds.item_vocab_size, net.hidden_size),)


def batch_iterator(ds, trainer_args, dp: int = 1):
    """Synthetic or file-backed stream of numpy batches (per-shard
    batch_size x dp samples); wrap it in PrefetchIterator for overlap."""
    if ds.dataset_name == "random":
        i = 0
        while True:
            yield random_hstu_batch(
                seed=trainer_args.seed + i,
                batch_size=ds.batch_size * dp,
                max_history_len=ds.max_history_len,
                item_vocab=ds.item_vocab_size,
                action_vocab=ds.action_vocab_size,
                max_num_candidates=ds.max_num_candidates,
                num_tasks=ds.num_tasks,
            )
            i += 1
    else:
        sd = make_sequence_dataset(ds)
        yield from sd.batches(
            ds.batch_size * dp, train=True, seed=trainer_args.seed,
            shuffle=ds.shuffle,
        )


def _block(n: int, parts: int, i: int):
    """[start, end) of part i of n items split into `parts` contiguous blocks
    (the first n % parts blocks one longer)."""
    q, r = divmod(n, parts)
    start = i * q + min(i, r)
    return start, start + q + (i < r)


def _slice_jagged(values, offsets, b0, b1, cap):
    """Samples [b0, b1) of a jagged buffer, repacked from 0 and padded with
    zeros to `cap` rows."""
    offsets = np.asarray(offsets)
    lo, hi = int(offsets[b0]), int(offsets[b1])
    values = np.asarray(values)
    out = np.zeros((cap,) + values.shape[1:], values.dtype)
    out[:hi - lo] = values[lo:hi]
    return out, (offsets[b0:b1 + 1] - lo).astype(offsets.dtype)


def shard_hstu_batch(batch: HSTUBatch, dp: int, rank: int) -> HSTUBatch:
    """Data rank `rank`'s contiguous block of the batch's samples: what the
    JAX package's P("data") on the leading dim means. Each jagged buffer keeps
    its share of the global buffer's padding rows (rank r takes padding // dp,
    plus one while r < padding % dp), so padding keys reach the tables iff
    they do in the global batch. Candidate labels are b-major strided; other
    labels follow the item feature's tokens."""
    if dp == 1:
        return batch
    b0, b1 = _block(batch.batch_size, dp, rank)

    def cap(capacity, lengths):
        """This block's rows and its share of the padding rows."""
        lengths = np.asarray(lengths)
        lo, hi = _block(capacity - int(lengths.sum()), dp, rank)
        return int(lengths[b0:b1].sum()) + hi - lo

    feats = {}
    for name, f in batch.features.items():
        c = cap(f.capacity, f.lengths)
        vals, offs = _slice_jagged(f.values, f.offsets, b0, b1, c)
        feats[name] = JaggedIds(values=vals, lengths=np.asarray(f.lengths)[b0:b1],
                                offsets=offs, max_len=f.max_len)
    item = batch.features[batch.item_feature_name]
    kw = {}
    if batch.num_candidates is not None:
        kw["num_candidates"] = np.asarray(batch.num_candidates)[b0:b1]
    if batch.labels is not None:
        lab = np.asarray(batch.labels)
        kw["label_lengths"] = np.asarray(batch.label_lengths)[b0:b1]
        if batch.max_num_candidates > 0:
            per = lab.shape[0] // batch.batch_size
            kw["labels"] = lab[b0 * per:b1 * per]
        else:
            loffs = np.concatenate([[0], np.cumsum(batch.label_lengths)])
            kw["labels"] = _slice_jagged(lab, loffs, b0, b1,
                                         cap(lab.shape[0], batch.label_lengths))[0]
    if batch.timestamps is not None:
        kw["timestamps"] = _slice_jagged(batch.timestamps, item.offsets, b0, b1,
                                         feats[batch.item_feature_name].capacity)[0]
    return dataclasses.replace(batch, features=feats, batch_size=b1 - b0, **kw)


def read_args(argv, entry: str):
    """(device, TrainerArgs) from the command line, with the gin file bound."""
    p = argparse.ArgumentParser(prog=entry)
    p.add_argument("--gin-config-file", default=None)
    p.add_argument("--max-train-iters", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; cpu for tests)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if args.gin_config_file:
        gin_config.parse_config_file(args.gin_config_file)
    trainer_args = gin_config.make("TrainerArgs")
    if args.max_train_iters is not None:
        trainer_args = dataclasses.replace(trainer_args, max_train_iters=args.max_train_iters)
    return device, trainer_args


def log_step(i, losses, dt, batch, ds, net, trainer_args, peak):
    item_len = np.asarray(batch.features["item"].lengths)
    fl = hstu_train_flops(
        item_len * (2 if ds.action_vocab_size else 1),
        net.hidden_size, net.num_attention_heads, net.kv_channels, net.num_layers,
    )
    tflops = fl / dt / 1e12
    print_rank_0(
        f"iter {i + 1}: loss={np.mean(losses[-trainer_args.log_interval:]):.5f} "
        f"step={dt * 1e3:.1f}ms tflops={tflops:.1f} mfu={100 * tflops / peak:.2f}%"
    )


def nan_tripwire(i, state: GRTrainState, batch):
    """Report which parts of the state went non-finite when the loss is
    NaN, and whether the batch's ids and lengths look sane."""
    bad = []
    tensors = [(n, p) for n, p in state.model.named_parameters()]
    for name, st in state.sparse.items():
        tensors += [(f"sparse.{name}.values", st.table.values)]
        if st.table.opt is not None:
            tensors += [(f"sparse.{name}.opt", st.table.opt)]
    for n, t in tensors:
        if not bool(torch.isfinite(t).all()):
            bad.append(n)
        if len(bad) >= 8:
            break
    print_rank_0(f"[nan-tripwire] loss NaN at iter {i + 1}; non-finite state "
                 f"leaves: {bad or 'none (transient batch?)'}")
    probs = []
    for name, feat in batch.features.items():
        ln = np.asarray(feat.lengths)
        vals = np.asarray(feat.values)
        if (ln < 0).any() or ln.sum() > vals.shape[0]:
            probs.append(f"{name}.lengths bad (sum={ln.sum()})")
        if np.issubdtype(vals.dtype, np.integer) and (vals < 0).any():
            probs.append(f"{name}.values negative ids")
    print_rank_0(f"[nan-tripwire] batch check: {probs or 'batch leaves look sane'}")
    if os.environ.get("REXTPU_HALT_ON_NAN"):
        raise FloatingPointError("loss NaN")


class StepProfiler:
    """torch.profiler over the steps [start, end] when `TrainerArgs.profile`
    is set; the trace goes to `<tmp>/rextorch_trace.json` and the profile
    object to `.last`."""

    def __init__(self, trainer_args, device: torch.device):
        self.args = trainer_args
        self.device = device
        self.prof = None
        self.last = None

    def before(self, i):
        if self.args.profile and i == self.args.profile_step_start:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts, acc_events=True)
            self.prof.start()

    def after(self, i):
        if self.prof is not None and i == self.args.profile_step_end:
            self.prof.stop()
            path = os.path.join(tempfile.gettempdir(), "rextorch_trace.json")
            self.prof.export_chrome_trace(path)
            print_rank_0(f"profile of iters {self.args.profile_step_start + 1}-{i + 1}: {path}")
            self.last, self.prof = self.prof, None


def data_rank(mesh):
    """(dp, this rank's data index) of `mesh`, (1, 0) without one."""
    if mesh is None:
        return 1, 0
    return mesh.size(mesh.data_axis), mesh.index(mesh.data_axis)


def train(trainer: GRTrainer, ds, net, trainer_args, evaluate, what: str, cache=None):
    """The training loop both entries share: returns (state, the profile of
    the `TrainerArgs.profile` window or None).

    The batch stream is assembled on a worker thread. The JAX entries
    initialise their params on the first batch and train from the second;
    this loop draws the first batch too, so both train on one stream. Under
    a mesh the stream yields global batches (balanced over the data ranks
    with `balanced_shuffler`) and each rank steps on its data rank's block.
    Each step waits for the device once (`StepTimer`); `evaluate(state)`
    runs at every `eval_interval` and at the end. `cache` (a
    HybridDynamicEmbedding over the item table) prefetches each train
    batch's item ids inside the step's timer."""
    device = trainer.device
    dp, drank = data_rank(trainer.mesh)
    stream = batch_iterator(ds, trainer_args, dp)
    if ds.balanced_shuffler and dp > 1:
        stream = (shuffle_hstu_batch(b, dp) for b in stream)
    it = PrefetchIterator(stream, depth=int(os.environ.get("REXTPU_PREFETCH_DEPTH", "2")))
    profiler = StepProfiler(trainer_args, device)
    bucketing = AdaptiveBucketing(trainer.sparse_tables.values()) \
        if trainer.sparse_tables and trainer.mesh is not None else None
    try:
        next(it)
        state = trainer.init(torch.Generator(device=device).manual_seed(trainer_args.seed))
        dropout_gen = torch.Generator(device=device).manual_seed(trainer_args.seed + drank)
        peak = device_peak_tflops(device)
        timer = StepTimer(device=device)
        print_rank_0(f"start {what}: {trainer_args.max_train_iters} iters, device={device}"
                     + ("" if trainer.mesh is None else f", mesh {trainer.mesh.shape}"))
        losses = []
        nan_reported = False
        t_start = time.perf_counter()
        for i, batch in enumerate(watched_iter(it, timeout=trainer_args.watchdog_timeout_s)):
            if i >= trainer_args.max_train_iters:
                break
            profiler.before(i)
            timer.start()
            if cache is not None:
                cache.prefetch(state.sparse["item"], np.asarray(batch.features["item"].values))
            state, metrics = trainer.train_step(state, shard_hstu_batch(batch, dp, drank),
                                                dropout_gen)
            dt = timer.stop()
            loss = float(metrics["loss"])
            losses.append(loss)
            ovf = int(metrics["emb_overflow"])
            if ovf:
                print_rank_0(
                    f"[a2a-overflow] iter {i + 1}: {ovf} unique ids past their owner "
                    "bucket cap (trained on transient init this step)")
            if bucketing is not None:
                bucketing.observe(ovf)
            if loss != loss and not nan_reported:
                nan_reported = True
                nan_tripwire(i, state, batch)
            profiler.after(i)
            if (i + 1) % trainer_args.log_interval == 0:
                log_step(i, losses, dt, batch, ds, net, trainer_args, peak)
            if (trainer_args.ckpt_save_interval
                    and (i + 1) % trainer_args.ckpt_save_interval == 0):
                save_checkpoint(f"{trainer_args.ckpt_dir}/iter_{i + 1:07d}", state,
                                state.sparse, trainer.mesh)
            if trainer_args.eval_interval and (i + 1) % trainer_args.eval_interval == 0:
                evaluate(state)
    finally:
        it.close()
    total = time.perf_counter() - t_start
    print_rank_0(f"done: {total:.1f}s, final loss {losses[-1]:.5f}")
    evaluate(state)
    return state, profiler.last


# the profile of the last main()'s `TrainerArgs.profile` window, and its item
# table's cache (`DynamicEmbeddingArgs.caching`) or None, for tools
LAST_PROFILE = None
LAST_CACHE = None


def main(argv=None):
    global LAST_PROFILE, LAST_CACHE
    device, trainer_args = read_args(argv, "pretrain_gr_ranking")
    ds = gin_config.make("DatasetArgs")
    net = gin_config.make("NetworkArgs")
    opt = gin_config.make("OptimizerArgs")
    demb = gin_config.make("DynamicEmbeddingArgs")
    tpa = gin_config.make("TensorModelParallelArgs")
    rank_args = gin_config.make("RankingArgs")

    device, mesh = build_mesh(device, tpa.tensor_model_parallel_size)
    hstu_cfg = build_hstu_config(net, tpa.tensor_model_parallel_size,
                                 sequence_parallel=tpa.sequence_parallel)
    task_cfg = RankingConfig(
        embedding_configs=static_tables(ds, net, demb),
        prediction_head_arch=tuple(rank_args.prediction_head_arch),
        prediction_head_act_type=rank_args.prediction_head_act_type,
        prediction_head_bias=rank_args.prediction_head_bias,
        num_tasks=rank_args.num_tasks,
    )
    sparse = build_sparse_tables(ds, net, demb, device, mesh)
    trainer = GRTrainer(
        RankingGR(hstu_cfg, task_cfg, device=device, mesh=mesh),
        make_optimizer(opt.learning_rate, opt.optimizer_str, opt.adam_beta1,
                       opt.adam_beta2, opt.adam_eps, opt.weight_decay),
        sparse, device=device, mesh=mesh,
    )
    LAST_CACHE = build_cache(demb, sparse, device, mesh)
    state, LAST_PROFILE = train(
        trainer, ds, net, trainer_args,
        lambda st: run_eval(trainer, st, ds, trainer_args, rank_args,
                            iters=trainer_args.eval_iters),
        "training", cache=LAST_CACHE)
    return state


# last run_eval result (per-task AUC ndarray), for tools that drive main()
LAST_EVAL_AUC = None
EVAL_AUC_HISTORY = []


def eval_batches(ds, trainer_args, iters):
    """Holdout batches for file-backed datasets; synthetic ones only for
    dataset_name == "random"."""
    nc_eval = ds.eval_max_num_candidates or ds.max_num_candidates
    if ds.dataset_name == "random":
        for j in range(iters or 8):
            yield random_hstu_batch(
                seed=99991 + j,
                batch_size=ds.batch_size,
                max_history_len=ds.max_history_len,
                item_vocab=ds.item_vocab_size,
                action_vocab=ds.action_vocab_size,
                max_num_candidates=nc_eval,
                num_tasks=ds.num_tasks,
            )
        return
    sd = make_sequence_dataset(ds, max_num_candidates=nc_eval)
    # eval_iters bounds file datasets too (0 = the whole holdout)
    it = sd.batches(ds.batch_size, train=False, seed=0, shuffle=False)
    yield from (itertools.islice(it, iters) if iters else it)


def run_eval(trainer: GRTrainer, state: GRTrainState, ds, trainer_args, rank_args,
             iters=8):
    """AUC over the eval batches (each data rank evaluates its block of each;
    the histograms are summed over the data axis)."""
    num_tasks = rank_args.num_tasks
    auc = AUCState.init(num_tasks, device=trainer.device)
    dp, drank = data_rank(trainer.mesh)
    nb = 0
    for batch in eval_batches(ds, trainer_args, iters):
        _, aux = trainer.eval_step(state, shard_hstu_batch(batch, dp, drank))
        labels01 = decode_bits(aux["labels"], num_tasks)
        auc = auc_update(auc, aux["logits"], labels01, aux["valid"])
        nb += 1
    vals = auc_compute(sum_over(auc, trainer.data_group)).cpu().numpy()
    global LAST_EVAL_AUC
    LAST_EVAL_AUC = vals
    EVAL_AUC_HISTORY.append(vals)
    print_rank_0(f"eval ({nb} batches) AUC: " + ", ".join(f"{v:.4f}" for v in vals))
    return vals


if __name__ == "__main__":
    main()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
