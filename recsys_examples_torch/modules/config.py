"""Model configuration (counterpart of recsys_examples_tpu/modules/config.py).

The dtype is a torch dtype. The kernel choice needs no field: a kernel
wrapper launches its CUDA kernel for CUDA tensors and runs its plain PyTorch
version for CPU tensors. Fields of unported features (the ranking eval
metrics, table sharding) and the TPU-only ones (the Pallas block sizes, the
block-aligned layout) are not carried over.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class PositionEncodingConfig:
    num_position_buckets: int = 8192
    num_time_buckets: int = 2048
    use_time_encoding: bool = False


@dataclasses.dataclass(frozen=True)
class HSTUConfig:
    hidden_size: int = 1024
    num_layers: int = 8
    num_attention_heads: int = 4
    kv_channels: int = 256          # per-head attention/linear dim
    layernorm_epsilon: float = 1e-5
    learnable_input_layernorm: bool = True
    learnable_output_layernorm: bool = False
    residual: bool = True
    add_uvqk_bias: bool = True
    scaling_seqlen: int = -1
    dtype: torch.dtype = torch.bfloat16
    # training
    hidden_dropout: float = 0.0
    is_causal: bool = True
    target_group_size: int = 1
    max_attn_len: int = 0
    # trainable T5-style relative attention bias (dense rab + drab: K4)
    use_relative_attention_bias: bool = False
    relative_bias_num_buckets: int = 128
    relative_bias_max_distance: int = 1024
    position_encoding_config: Optional[PositionEncodingConfig] = None
    tensor_model_parallel_size: int = 1   # > 1: heads split over the mesh's "model" axis
    sequence_parallel: bool = False       # with TP > 1: tokens split over "model" too
    item_embedding_dim: int = 0        # > 0 enables the item MLP
    contextual_embedding_dim: int = 0  # > 0 enables the contextual MLP
    disable_contextual_mask: bool = False
    recompute_layer: bool = False      # torch.utils.checkpoint each layer (dropout replayed)


@dataclasses.dataclass(frozen=True)
class EmbeddingConfig:
    """A static (data-parallel) embedding table."""
    feature_names: Tuple[str, ...]
    table_name: str
    vocab_size: int
    dim: int


@dataclasses.dataclass(frozen=True)
class RankingConfig:
    embedding_configs: Tuple[EmbeddingConfig, ...]
    prediction_head_arch: Tuple[int, ...] = (512, 10)
    prediction_head_act_type: str = "relu"
    prediction_head_bias: bool = True
    num_tasks: int = 1


@dataclasses.dataclass(frozen=True)
class RetrievalConfig:
    embedding_configs: Tuple[EmbeddingConfig, ...]
    temperature: float = 0.05
    l2_norm_eps: float = 1e-6
    num_negatives: int = -1  # -1 => all in-batch
    eval_metrics: Tuple[str, ...] = ("HR@10", "NDCG@10", "MRR")
