"""gin-configurable argument dataclasses for the training entry points
(counterpart of recsys_examples_tpu/training/gin_args.py, field for field, so
every file under configs/ binds the same values in both packages).

Two fields select nothing in the port: `NetworkArgs.kernel_backend` is read
and validated, but a CUDA device always runs the CUDA kernels and the CPU
their plain versions; `NetworkArgs.dtype` picks bfloat16 or float32.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from recsys_examples_torch.utils.gin_config import configurable


@configurable
@dataclasses.dataclass(frozen=True)
class TrainerArgs:
    max_train_iters: int = 100
    eval_interval: int = 0            # 0 = eval at end only
    log_interval: int = 10
    ckpt_save_interval: int = 0
    ckpt_dir: str = "./checkpoints"
    seed: int = 1234
    profile: bool = False
    profile_step_start: int = 10
    profile_step_end: int = 12
    watchdog_timeout_s: float = 300.0
    eval_iters: int = 8               # eval batches per run_eval


@configurable
@dataclasses.dataclass(frozen=True)
class DatasetArgs:
    dataset_name: str = "random"      # random | movielens-1m | movielens-20m | kuairand
    dataset_path: str = ""
    batch_size: int = 32              # per data-parallel shard
    max_history_len: int = 1024
    max_num_candidates: int = 0
    # eval-time candidate count; 0 = same as max_num_candidates. Set to 1
    # with a larger train candidate window (the reference trains ml-20m
    # with max_num_candidates=20) so eval scores ONLY the true holdout and
    # never re-scores train-labeled candidates.
    eval_max_num_candidates: int = 0
    item_vocab_size: int = 1_000_000
    action_vocab_size: int = 0
    contextual_feature_names: Tuple[str, ...] = ()
    shuffle: bool = True
    balanced_shuffler: bool = False
    num_tasks: int = 1


@configurable
@dataclasses.dataclass(frozen=True)
class NetworkArgs:
    hidden_size: int = 256
    num_layers: int = 4
    num_attention_heads: int = 4
    kv_channels: int = 64
    hidden_dropout: float = 0.1
    kernel_backend: str = "pallas"    # pallas | jnp: validated, selects nothing
    dtype: str = "bfloat16"
    target_group_size: int = 1
    max_attn_len: int = 0
    position_num_buckets: int = 8192
    use_time_encoding: bool = False
    recompute_layer: bool = False
    scaling_seqlen: int = -1


@configurable
@dataclasses.dataclass(frozen=True)
class OptimizerArgs:
    optimizer_str: str = "adam"
    learning_rate: float = 1e-3
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-8
    weight_decay: float = 0.0


@configurable
@dataclasses.dataclass(frozen=True)
class DynamicEmbeddingArgs:
    """Dynamic (hash) table config for the item/user tables."""
    use_dynamic_embedding: bool = True
    capacity: int = 1 << 20
    bucket_capacity: int = 128
    optimizer: str = "rowwise_adagrad"
    learning_rate: float = 0.01
    # L2 on looked-up rows (reference: EXACT_ROWWISE_ADAGRAD weight_decay,
    # batched_dynamicemb_tables.py:491) — the dense adamw decay never
    # touches the hash tables, so sparse memorization needs its own knob
    weight_decay: float = 0.0
    score_strategy: str = "timestamp"   # timestamp | step | lfu
    admission_threshold: int = 0
    caching: bool = False


@configurable
@dataclasses.dataclass(frozen=True)
class TensorModelParallelArgs:
    tensor_model_parallel_size: int = 1
    # Megatron-SP analogue: shard the token dim of layernorm/elementwise
    # regions over the "model" axis (reference: hstu_config.py:206-208 —
    # SP only meaningful when tp > 1)
    sequence_parallel: bool = False


@configurable
@dataclasses.dataclass(frozen=True)
class RankingArgs:
    prediction_head_arch: Tuple[int, ...] = (512, 1)
    prediction_head_act_type: str = "relu"
    prediction_head_bias: bool = True
    num_tasks: int = 1
    eval_metrics: Tuple[str, ...] = ("AUC",)


@configurable
@dataclasses.dataclass(frozen=True)
class RetrievalArgs:
    temperature: float = 0.05
    num_negatives: int = -1
    eval_metrics: Tuple[str, ...] = ("HR@10", "NDCG@10", "MRR")
