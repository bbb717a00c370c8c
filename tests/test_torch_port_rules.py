"""Rules of the PyTorch port: it imports no JAX, flax or JAX-package code,
and its entry points default to CUDA without falling back to the CPU."""
import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "recsys_examples_tpu")
# the training entries' slice and the modules after it: torch, numpy and
# the standard library only (the card's machine has no pandas; aiohttp is
# imported inside the functions that serve)
ENTRY_SLICE = (
    "utils/gin_config.py", "training/gin_args.py", "utils/logger.py", "utils/watchdog.py",
    "utils/perf.py", "modules/metrics.py", "utils/native.py", "data/sequence_dataset.py",
    "data/batch_shuffler.py", "training/checkpoint.py", "modules/hstu_block.py",
    "training/pretrain_gr_ranking.py", "modules/config.py", "modules/losses.py",
    "models/retrieval_gr.py", "training/pretrain_gr_retrieval.py",
    "dynamicemb/hybrid_storage.py", "dynamicemb/tiered_storage.py", "dynamicemb/planner.py",
    "dynamicemb/pooled.py", "dynamicemb/exportable_tables.py",
    "dynamicemb/sharded_collection.py", "inference/kvcache.py", "ops/head_dims.py",
    "parallel/mesh.py", "parallel/collective_ops.py", "training/trainer.py",
    "modules/hstu_layer.py", "models/ranking_gr.py", "convert.py",
    "inference/export.py", "modules/sid_eval_metrics.py", "data/sid_sequence_dataset.py",
    "training/pretrain_sid_gr.py", "inference/sid_serving/continuous.py",
    "inference/sid_serving/http.py", "models/qwen3.py", "inference/sid_serving/qwen3_runtime.py",
    "inference/sid_serving/engine.py", "utils/observability.py", "ops/jagged.py",
    "ops/hstu_attention_ref.py", "jagged/jagged_tensor.py", "tools/__init__.py",
    "tools/kernel_parity.py", "tools/convergence_synthetic.py",
    "tools/convergence_retrieval.py", "tools/convergence_sid.py", "tools/build_sid_mapping.py",
    "tools/serving_soak.py", "tools/http_loadgen.py",
)


def _port_files():
    pkg = ROOT / "recsys_examples_torch"
    files = sorted(p for p in pkg.rglob("*.py")
                   if "_build" not in p.relative_to(pkg).parts)   # build output
    return files + [ROOT / "chip_smoke.py", ROOT / "paged_study.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_imports_no_jax():
    files = _port_files()
    assert len(files) > 10 and (ROOT / "chip_smoke.py").exists()
    bad = [
        f"{p.relative_to(ROOT)}: {name}"
        for p in files for name in _imports(p)
        if name.split(".")[0] in FORBIDDEN
    ]
    assert not bad, bad


def test_entry_points_default_to_cuda():
    from recsys_examples_torch.dynamicemb.exportable_tables import (
        InferenceTableState,
    )
    from recsys_examples_torch.inference.inference_ranking_gr import (
        InferenceDenseModule,
        InferenceRankingGR,
    )
    from recsys_examples_torch.inference.kvcache import (
        KVCacheConfig,
        create_kvcache,
    )
    from recsys_examples_torch.modules.config import HSTUConfig
    from recsys_examples_torch.utils.device import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    kv_cfg = KVCacheConfig(num_layers=1, num_heads=1, head_dim=8,
                           num_pages=4, max_users=2, max_pages_per_user=2)
    cfg = HSTUConfig(hidden_size=8, num_layers=1, num_attention_heads=1,
                     kv_channels=8, dtype=torch.float32)
    table = InferenceTableState(torch.zeros(2, 2, dtype=torch.int64),
                                torch.zeros(4, 8))
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        create_kvcache(kv_cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceRankingGR(cfg, kv_cfg, InferenceDenseModule(cfg, (4, 1)),
                           table)
    assert resolve_device("cpu").type == "cpu"
    assert create_kvcache(kv_cfg, device="cpu").k_pages.device.type == "cpu"


def test_train_entry_points_default_to_cuda():
    from recsys_examples_torch.data.hstu_batch import random_hstu_batch
    from recsys_examples_torch.models.ranking_gr import RankingGR
    from recsys_examples_torch.modules.config import (
        EmbeddingConfig, HSTUConfig, RankingConfig)
    from recsys_examples_torch.ops import hstu_attention as ha
    from recsys_examples_torch.training.train_state import make_optimizer
    from recsys_examples_torch.training.trainer import GRTrainer

    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    cfg = HSTUConfig(hidden_size=8, num_layers=1, num_attention_heads=1,
                     kv_channels=8, dtype=torch.float32)
    task = RankingConfig((EmbeddingConfig(("item",), "item", 10, 8),),
                         prediction_head_arch=(4, 1), num_tasks=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        GRTrainer(RankingGR(cfg, task), make_optimizer())
    trainer = GRTrainer(RankingGR(cfg, task), make_optimizer(), device="cpu")
    state = trainer.init(torch.Generator().manual_seed(0))
    batch = random_hstu_batch(0, 2, 5, 10)
    state, metrics = trainer.train_step(state, batch)
    assert metrics["loss"].device.type == "cpu" and state.step == 1
    assert all(p.device.type == "cpu" for p in state.model.parameters())

    # the attention entry runs its plain versions on CPU tensors, and the
    # kernel wrappers refuse them rather than fall back
    x = torch.randn(4, 1, 32, requires_grad=True)
    so = torch.tensor([0, 4])
    before = (ha.hstu_attn_fwd_cuda.launches, ha.hstu_attn_bwd_dq_cuda.launches,
              ha.hstu_attn_bwd_dkv_cuda.launches)
    ha.hstu_attn_varlen(x, x, x, so, 4, alpha=0.1).sum().backward()
    assert before == (ha.hstu_attn_fwd_cuda.launches, ha.hstu_attn_bwd_dq_cuda.launches,
                      ha.hstu_attn_bwd_dkv_cuda.launches)
    opts = ha.AttnOptions(max_seqlen=4, alpha=0.1, scaling_seqlen=4)
    with pytest.raises(ValueError, match="CUDA"):
        ha.hstu_attn_fwd_cuda(x.detach().bfloat16(), x.detach().bfloat16(),
                              x.detach().bfloat16(), so.int(), None, None, opts)
    rab = torch.zeros(1, 1, 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        ha.hstu_attn_rab_fwd_cuda(x.detach().bfloat16(), x.detach().bfloat16(),
                                  x.detach().bfloat16(), rab, so.int(), None, None, opts)
    assert ha.hstu_attn_rab_fwd_cuda.launches == 0


def test_dynamic_tables_default_to_cuda_and_refuse_a_mesh():
    """The dynamic tables live on the card unless the caller says "cpu"; a
    trainer and its tables share one device. (Row sharding over a mesh is
    held in tests/test_torch_sharded_dynamicemb.py.)"""
    from recsys_examples_torch.dynamicemb.batched_table import DynamicEmbeddingTable
    from recsys_examples_torch.dynamicemb.dynamicemb_config import DynamicEmbTableOptions
    from recsys_examples_torch.dynamicemb.hashtable import create_table_state
    from recsys_examples_torch.dynamicemb.optimizer import SparseOptimizerArgs
    from recsys_examples_torch.dynamicemb.sharded_collection import ShardedDynamicEmbedding
    from recsys_examples_torch.models.ranking_gr import RankingGR
    from recsys_examples_torch.modules.config import (
        EmbeddingConfig, HSTUConfig, RankingConfig)
    from recsys_examples_torch.training.train_state import make_optimizer
    from recsys_examples_torch.training.trainer import GRTrainer

    table = DynamicEmbeddingTable(
        DynamicEmbTableOptions(embedding_dim=8, max_capacity=64, bucket_capacity=8),
        SparseOptimizerArgs(optimizer="sgd"))
    on_cpu = ShardedDynamicEmbedding(table, mesh=None, device="cpu")
    state = on_cpu.init_state()
    assert state.table.keys.device.type == state.step.device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedDynamicEmbedding(table)
    with pytest.raises(RuntimeError, match="CUDA"):
        table.init_state()
    with pytest.raises(RuntimeError, match="CUDA"):
        create_table_state(64, 8, 8)
    cfg = HSTUConfig(hidden_size=8, num_layers=1, num_attention_heads=1,
                     kv_channels=8, dtype=torch.float32)
    task = RankingConfig((EmbeddingConfig(("action",), "action", 10, 8),),
                         prediction_head_arch=(4, 1), num_tasks=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        GRTrainer(RankingGR(cfg, task), make_optimizer(), {"item": on_cpu})


def test_sid_gr_entry_points_default_to_cuda():
    """SID-GR serving lives on the card unless the caller says "cpu"; the
    beam-decode attention and the two int8 wrappers run their plain versions
    on CPU tensors and refuse to launch a kernel on them."""
    import numpy as np

    from recsys_examples_torch.data.sid_batch import random_sid_batch
    from recsys_examples_torch.inference.sid_serving.engine import (
        GRServingEngine, ServingConfig)
    from recsys_examples_torch.inference.sid_serving.item_constraints import TrieConstraint
    from recsys_examples_torch.models.beam_search import init_beam
    from recsys_examples_torch.models.sid_gr import SIDGRConfig, SIDGRModel
    from recsys_examples_torch.ops import hstu_attention as ha
    from recsys_examples_torch.ops import paged_hstu_attention as pa
    from recsys_examples_torch.ops.beam_decode_attention import beam_decode_attn

    cfg = SIDGRConfig(num_hierarchies=2, codebook_size=8, hidden_size=8, num_layers=1,
                      num_heads=1, head_dim=8, ffn_hidden=8, beam_width=2)
    model = SIDGRModel(cfg, device="cpu").init_weights(torch.Generator().manual_seed(0))
    assert all(p.device.type == "cpu" for p in model.parameters())
    counters = (beam_decode_attn, pa.paged_hstu_delta_attention_int8, ha.hstu_attn_fwd_int8_cuda)
    before = [c.launches for c in counters]
    engine = GRServingEngine(model, ServingConfig(beam_width=2, ctx_buckets=(4,),
                                                  batch_buckets=(1,)))
    paths, scores = engine.generate([np.array([1, 2, 3, 4])])
    assert paths.shape == (1, 2, 2) and np.isfinite(scores).all()
    paths, _ = model.generate_beam_decode(random_sid_batch(0, 2, 3, 2, 8))   # numpy batch
    assert paths.device.type == "cpu"
    assert [c.launches for c in counters] == before

    x8 = torch.zeros(4, 1, 32, dtype=torch.int8)
    opts = ha.AttnOptions(max_seqlen=4, alpha=0.1, scaling_seqlen=4)
    with pytest.raises(ValueError, match="CUDA"):
        ha.hstu_attn_fwd_int8_cuda(x8, x8, x8, torch.tensor([0, 4]).int(), None, None, opts, 1.0)
    pages = torch.zeros(2, 4, 1, 32, dtype=torch.int8)
    qn = torch.zeros(1, 2, 1, 32, dtype=torch.bfloat16)
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_hstu_delta_attention_int8(
            qn, pages, pages, torch.ones(2, 4, 1), torch.ones(2, 4, 1), i32([0, 1]),
            i32(3), qn, qn, i32(2), None, 0.1, 8.0)
    assert [c.launches for c in counters] == before
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        SIDGRModel(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        TrieConstraint(np.array([[0, 1]]), 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_beam(2, 3, 2)
    assert init_beam(2, 3, 2, device="cpu").scores.device.type == "cpu"
    # the quantize helpers take no device: they run where their tensors lie
    assert pa.quantize_kv_pages(pages.float(), pages.float())[2].device.type == "cpu"


def _imports_inside_functions(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    return {node.module if isinstance(node, ast.ImportFrom) else a.name
            for fn in ast.walk(tree) if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
            for node in ast.walk(fn) if isinstance(node, (ast.Import, ast.ImportFrom))
            for a in (node.names if isinstance(node, ast.Import) else [None])}


def test_entry_slice_imports_torch_numpy_and_stdlib_only():
    """aiohttp is allowed inside a function only (the HTTP fronts import it
    where they serve)."""
    import sys

    allowed = {"torch", "numpy", "recsys_examples_torch", "__future__"}
    for rel in ENTRY_SLICE:
        path = ROOT / "recsys_examples_torch" / rel
        lazy = _imports_inside_functions(path)
        for name in _imports(path):
            top = name.split(".")[0]
            assert top in allowed or top in sys.stdlib_module_names or (
                top == "aiohttp" and name in lazy), f"{rel}: {name}"


@pytest.mark.parametrize("entry", ["pretrain_gr_ranking", "pretrain_gr_retrieval",
                                   "pretrain_sid_gr"])
def test_training_mains_default_to_cuda(entry, tmp_path):
    """`main` without `--device cpu` raises on a machine without a card,
    before it reads a file or builds a model."""
    import importlib

    from recsys_examples_torch.utils import gin_config

    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    main = importlib.import_module(f"recsys_examples_torch.training.{entry}").main
    cfg = tmp_path / "none.gin"
    cfg.write_text("TrainerArgs.max_train_iters = 1\n")
    gin_config.clear_config()
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--gin-config-file", str(cfg)])
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--gin-config-file", str(cfg), "--device", "cuda:0"])
    assert not gin_config._BINDINGS        # raised before parsing the file


def test_qwen3_serving_defaults_to_cuda():
    """The Qwen3 model lives on the card unless the caller says "cpu"; its
    decode step runs the beam attention's plain version on CPU tensors and
    launches no kernel there."""
    import numpy as np

    from recsys_examples_torch.inference.sid_serving.qwen3_runtime import qwen3_generate_beam
    from recsys_examples_torch.models.qwen3 import Qwen3Config, Qwen3Model
    from recsys_examples_torch.ops.beam_decode_attention import beam_decode_attn

    cfg = Qwen3Config.tiny(vocab_size=16)
    model = Qwen3Model(cfg, device="cpu").init_weights(torch.Generator().manual_seed(0))
    before = beam_decode_attn.launches
    paths, _ = qwen3_generate_beam(model, np.ones((1, 4)), np.array([4]), 3, 2)
    assert paths.device.type == "cpu" and beam_decode_attn.launches == before
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        Qwen3Model(cfg)


@pytest.mark.parametrize("tool,argv", [
    ("kernel_parity", []), ("serving_soak", []), ("http_loadgen", ["--inprocess", "sid"]),
    ("convergence_synthetic", []), ("convergence_retrieval", []), ("convergence_sid", []),
    ("build_sid_mapping", None)])
def test_tools_default_to_cuda(tool, argv):
    """Every port tool's `--device` defaults to cuda, and raises without a
    card before it writes a file (build_sid_mapping's device work is its
    co-occurrence embedding)."""
    import importlib

    import numpy as np

    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    mod = importlib.import_module(f"recsys_examples_torch.tools.{tool}")
    with pytest.raises(RuntimeError, match="CUDA"):
        if argv is None:
            mod.cooccurrence_embeddings(np.zeros(2, np.int64), np.array([0, 2]), 2)
        else:
            mod.main(argv)
