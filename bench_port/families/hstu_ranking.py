"""The HSTU ranking model family: its weights, its traffic (a pool of
batches), the program under test (`GRTrainer.train_step` of
`recsys_examples_torch` with two dynamic tables), the work of a step, and
the readings the comparison takes from the program and from the plain
reference.

The program's modules are imported inside the functions that build it."""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from bench_port.reference import hstu_ranking_ref as ref

ZETA_TERMS = 1 << 23


# ------------------------------------------------------------------ weights
def param_spec(cfg: dict):
    """(name, shape, init) of every dense parameter, under the program's
    names. Weights N(0, 1/fan_in); biases N(0, 0.02^2); LayerNorm scales
    N(1, 0.1^2); static tables N(0, 1/vocab); the position table uniform
    in [0, 2/sqrt(P))."""
    D, L, E = cfg["hidden_size"], cfg["num_layers"], cfg["embedding_dim"]
    HD = cfg["num_attention_heads"] * cfg["kv_channels"]
    P = cfg["num_position_buckets"]
    w = lambda fan_in: ("normal", fan_in ** -0.5)
    b = ("normal", 0.02)
    spec = [(f"embeddings.{n}_weight", (v, E), ("normal", v ** -0.5))
            for n, v in cfg["static_tables"].items()]
    for mlp in ("item_mlp", "contextual_mlp"):
        pre = f"hstu_block.preprocessor.{mlp}.layers"
        spec += [(f"{pre}.0.weight", (D, E), w(E)), (f"{pre}.0.bias", (D,), b),
                 (f"{pre}.1.weight", (D, D), w(D)), (f"{pre}.1.bias", (D,), b)]
    spec.append(("hstu_block.preprocessor.positional_encoder.position_embeddings", (P, D),
                 ("uniform", 0.0, 2.0 / P ** 0.5)))
    for i in range(L):
        pre = f"hstu_block.layers.{i}"
        spec += [(f"{pre}.uvqk_kernel", (D, 4, HD), w(D)), (f"{pre}.uvqk_bias", (4, HD), b),
                 (f"{pre}.input_layernorm.scale", (D,), ("normal", 0.1, 1.0)),
                 (f"{pre}.input_layernorm.bias", (D,), b),
                 (f"{pre}.linear_proj.weight", (D, HD), w(HD))]
    sizes = [D, *cfg["prediction_head_arch"]]
    for i, (a, o) in enumerate(zip(sizes[:-1], sizes[1:])):
        spec += [(f"head.layers.{i}.weight", (o, a), w(a)), (f"head.layers.{i}.bias", (o,), b)]
    return spec


# ------------------------------------------------------------------ traffic
def folded_zipf_pmf(a: float, cap: int) -> np.ndarray:
    """P(L = l), l = 1..cap, of L = (X - 1) mod cap + 1 for X ~ Zipf(a): the
    history-length law of the reference's synthetic batches. The mass past
    the summed terms is spread evenly over the residues."""
    k = np.arange(1, ZETA_TERMS + 1, dtype=np.float64)
    w = k ** -a
    # zeta(a) by the summed terms plus the Euler-Maclaurin tail
    n = float(ZETA_TERMS)
    zeta = w.sum() + n ** (1 - a) / (a - 1) - 0.5 * n ** -a
    pmf = np.bincount((np.arange(ZETA_TERMS) % cap), weights=w, minlength=cap) / zeta
    return pmf + (1.0 - pmf.sum()) / cap


def pool_lengths(wl: dict) -> np.ndarray:
    """The pool's history lengths: the length law's quantiles at
    (i + 1/2) / n for every slot of the pool. Every seed gets this same set
    and deals it out in its own order."""
    n = wl["pool_batches"] * wl["batch_size"]
    cdf = np.cumsum(folded_zipf_pmf(wl["history_zipf_a"], wl["max_history"]))
    u = (np.arange(n) + 0.5) / n
    return (np.searchsorted(cdf, u) + 1).astype(np.int64)


def make_pool(wl: dict, cfg: dict, seed: int) -> List[dict]:
    """`pool_batches` host batches: the pool's lengths dealt out by the
    seed; item and user ids Zipf(id_zipf_a) folded over the dynamic tables'
    vocabulary; the small features and the labels uniform."""
    rng = np.random.default_rng(seed)
    lengths = rng.permutation(pool_lengths(wl)).reshape(wl["pool_batches"], wl["batch_size"])
    zipf = lambda n, vocab: (rng.zipf(wl["id_zipf_a"], size=n).astype(np.int64) - 1) % vocab
    out = []
    for hist in lengths:
        T, B = int(hist.sum()), len(hist)
        b = {"hist": hist, "max_items": wl["max_history"],
             "labels": rng.integers(0, 1 << cfg["num_tasks"], size=T)}
        for n in ("item", *cfg["contextual_features"]):
            rows = T if n == "item" else B
            if n in cfg["dynamic_tables"]:
                b[n] = zipf(rows, cfg["dynamic_tables"][n]["vocab"])
            else:
                b[n] = rng.integers(0, cfg["static_tables"][n], size=rows)
        b["action"] = rng.integers(0, cfg["static_tables"]["action"], size=T)
        out.append(b)
    return out


def half_batch(b: dict, cfg: dict) -> dict:
    """The batch's first half of users, for a planted fault: the rest of the
    batch left out, the mean taken over what remains."""
    n = len(b["hist"]) // 2
    T = int(b["hist"][:n].sum())
    out = dict(b, hist=b["hist"][:n])
    out.update({k: b[k][:T] for k in ("item", "action", "labels")})
    out.update({k: b[k][:n] for k in cfg["contextual_features"]})
    return out


def tokens(b: dict, cfg: dict) -> int:
    """Post-preprocess tokens of a batch: contextual + 2 x history."""
    return int(len(cfg["contextual_features"]) * len(b["hist"]) + 2 * b["hist"].sum())


# ------------------------------------------------------------------ work
def hstu_flops_exact(seqlens, num_contextuals, num_candidates, hidden_size, num_heads,
                     head_dim, num_layers, *, has_bwd=True, is_causal=True, residual=True):
    """The reference's `cal_hstu_flops_single_rank` (the port's
    `utils/perf.py::hstu_flops_exact`, frozen): attention with contextual
    rows attending everywhere, causal history, candidates to contextual and
    history only, backward x3.5; the uvqk and output GEMMs, backward x3;
    the u * attn product and the residual add."""
    S = np.asarray(seqlens, np.float64)
    C = np.broadcast_to(np.asarray(num_contextuals, np.float64), S.shape)
    Nc = np.broadcast_to(np.asarray(num_candidates, np.float64), S.shape)
    Nh = S - C - Nc
    D, H, dh = float(hidden_size), float(num_heads), float(head_dim)
    attn = 4.0 * H * S * (C + Nh) * dh
    if is_causal:
        attn -= 2.0 * H * Nh * Nh * dh
    attn += 4.0 * H * Nc * dh
    if has_bwd:
        attn *= 3.5
    gemm = 2.0 * S * 4.0 * H * dh * D + 2.0 * S * H * dh * D
    if has_bwd:
        gemm *= 3.0
    other = S * H * dh
    if has_bwd:
        other *= 2.0
    if residual:
        other += S * H * D
    return float((attn + gemm + other).sum() * num_layers)


def mask_pairs(n: int, c: int) -> int:
    """Valid (query, key) pairs of one user's mask: the c contextual rows see
    all n tokens, every other row itself and the rows before it."""
    h = n - c
    return c * n + h * c + h * (h + 1) // 2


def attention_work(seqlens, c: int, H: int, dh: int) -> Dict[str, tuple]:
    """(bytes, FLOPs) of K1, K2 and K3 on this batch (the port's smoke
    script's `jagged_attention_work`, frozen): bf16 operands read once and
    outputs written once (K1: q, k, v, out; K2: q, k, v, dO, dq; K3: q, k,
    v, dO, dk, dv), and 2, 3 and 4 products of 2 H dh FLOPs per valid pair."""
    pairs = sum(mask_pairs(int(n), c) for n in seqlens)
    tile = int(sum(seqlens)) * H * dh * 2
    per_pair = 2 * H * dh
    return {"fwd": (4 * tile, 2 * per_pair * pairs),
            "dq": (5 * tile, 3 * per_pair * pairs),
            "dkv": (6 * tile, 4 * per_pair * pairs)}


def step_work(b: dict, cfg: dict, peaks: dict) -> Dict[str, float]:
    """A step's model FLOPs (the reference's accounting) and the least time
    K1-K3 could take over its layers."""
    c = len(cfg["contextual_features"])
    seqlens = c + 2 * np.asarray(b["hist"], np.int64)
    H, dh, L = cfg["num_attention_heads"], cfg["kv_channels"], cfg["num_layers"]
    flops = hstu_flops_exact(seqlens, c, 0, cfg["hidden_size"], H, dh, L)
    bound = sum(max(nb / peaks["hbm_bytes_per_s"], fl / peaks["bf16_flops"])
                for nb, fl in attention_work(seqlens, c, H, dh).values())
    return {"model_flops": flops, "attn_bound_s": L * bound}


# ------------------------------------------------------------------ program
class Program:
    """`GRTrainer` over the port's RankingGR with the configuration's dynamic
    tables, started from the harness's weights and empty tables."""

    DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor], device):
        from recsys_examples_torch.dynamicemb.batched_table import DynamicEmbeddingTable
        from recsys_examples_torch.dynamicemb.dynamicemb_config import DynamicEmbTableOptions
        from recsys_examples_torch.dynamicemb.optimizer import SparseOptimizerArgs
        from recsys_examples_torch.dynamicemb.sharded_collection import ShardedDynamicEmbedding
        from recsys_examples_torch.models.ranking_gr import RankingGR
        from recsys_examples_torch.modules.config import (
            EmbeddingConfig, HSTUConfig, PositionEncodingConfig, RankingConfig)
        from recsys_examples_torch.training.train_state import make_optimizer
        from recsys_examples_torch.training.trainer import GRTrainer, GRTrainState

        self.cfg, self.device = cfg, torch.device(device)
        E = cfg["embedding_dim"]
        hcfg = HSTUConfig(
            hidden_size=cfg["hidden_size"], num_layers=cfg["num_layers"],
            num_attention_heads=cfg["num_attention_heads"], kv_channels=cfg["kv_channels"],
            layernorm_epsilon=cfg["layernorm_epsilon"], hidden_dropout=cfg["hidden_dropout"],
            dtype=self.DTYPES[cfg["dtype"]], target_group_size=1, recompute_layer=False,
            position_encoding_config=PositionEncodingConfig(
                num_position_buckets=cfg["num_position_buckets"]),
            item_embedding_dim=E, contextual_embedding_dim=E)
        task = RankingConfig(
            embedding_configs=tuple(EmbeddingConfig((n,), n, v, E)
                                    for n, v in cfg["static_tables"].items()),
            prediction_head_arch=tuple(cfg["prediction_head_arch"]),
            num_tasks=cfg["num_tasks"])
        model = RankingGR(hcfg, task, device=self.device)
        model.load_state_dict(weights, strict=True)
        self.sparse = {}
        for n, t in cfg["dynamic_tables"].items():
            self.sparse[n] = ShardedDynamicEmbedding(DynamicEmbeddingTable(
                DynamicEmbTableOptions(embedding_dim=E, max_capacity=cfg["dynamic_table_rows"],
                                       bucket_capacity=t["bucket_capacity"]),
                SparseOptimizerArgs(optimizer=t["optimizer"], learning_rate=t["lr"],
                                    eps=t["eps"])),
                mesh=None, device=self.device)
        opt = cfg["dense_optimizer"]
        self.trainer = GRTrainer(
            model, make_optimizer(opt["lr"], opt["name"], opt["beta1"], opt["beta2"],
                                  opt["eps"]),
            self.sparse, device=self.device)
        self.state = GRTrainState(model=model, optimizer=self.trainer.tx(model.parameters()),
                                  sparse={n: s.init_state() for n, s in self.sparse.items()})

    def stage(self, b: dict):
        """A host batch as the program's HSTUBatch on the device."""
        from recsys_examples_torch.data.hstu_batch import HSTUBatch, JaggedIds

        B = len(b["hist"])
        item_max = int(b["max_items"])

        def jag(values, lengths):
            lengths = np.asarray(lengths, np.int32)
            offs = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
            return JaggedIds(values=np.asarray(values, np.int64), lengths=lengths,
                             offsets=offs, max_len=max(len(values) // B, 1))

        ctx = self.cfg["contextual_features"]
        feats = {"item": jag(b["item"], b["hist"]), "action": jag(b["action"], b["hist"])}
        feats.update({n: jag(b[n], np.ones(B)) for n in ctx})
        return HSTUBatch(
            features=feats, batch_size=B,
            feature_to_max_seqlen={"item": item_max, "action": item_max,
                                   **{n: 1 for n in ctx}},
            item_feature_name="item", action_feature_name="action",
            contextual_feature_names=tuple(ctx), max_num_candidates=0,
            labels=np.asarray(b["labels"], np.int64),
            label_lengths=np.asarray(b["hist"], np.int32)).to(self.device)

    def step(self, batch) -> Dict[str, torch.Tensor]:
        """One train step, the timed call. The metrics stay on the device."""
        self.state, m = self.trainer.train_step(self.state, batch)
        return m

    # -------------------------------------------------- readings
    def first_grads(self) -> Dict[str, torch.Tensor]:
        """Each leaf's gradient at the first step, as its optimizer got it:
        a dense leaf's from Adam's first moment over (1 - beta1); a rowwise
        Adagrad table's row norms, sqrt(dim x accumulator) (its accumulators
        start at 0), in the order of their keys."""
        from recsys_examples_torch.dynamicemb.dynamicemb_config import EMPTY_KEY

        b1 = self.cfg["dense_optimizer"]["beta1"]
        opt = self.state.optimizer
        out = {n: opt.state[p]["exp_avg"] / (1 - b1)
               for n, p in self.state.model.named_parameters()}
        E = self.cfg["embedding_dim"]
        for n, s in self.state.sparse.items():
            keys = s.table.keys.reshape(-1)
            held = keys != EMPTY_KEY
            acc = s.table.opt[held][:, 0][torch.argsort(keys[held])]
            out[f"table.{n}"] = torch.sqrt(E * acc)
        return out

    def change_norms(self, p0: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """Each leaf's change from the start: the dense params against `p0`,
        each table's stored rows against their first-touch rows."""
        from recsys_examples_torch.dynamicemb.dynamicemb_config import EMPTY_KEY

        out = {n: float((p.detach() - p0[n]).norm())
               for n, p in self.state.model.named_parameters()}
        for n, s in self.state.sparse.items():
            keys = s.table.keys.reshape(-1)
            held = keys != EMPTY_KEY
            rows = s.table.values[held]
            out[f"table.{n}"] = float((rows - ref.initial_rows(keys[held], rows.shape[1])).norm())
        return out

    def tables_overflowed(self) -> int:
        return sum(int(s.table.overflowed.sum()) + int(s.table.evicted.sum())
                   for s in self.state.sparse.values())

    def hooks(self):
        """(object, method names) whose calls the traced run times: phases A
        and C of every dynamic table."""
        return [(t, ("forward", "backward")) for t in self.sparse.values()]


def reference_readings(cfg: dict, weights, batches: List[dict], lowp: bool = False) -> dict:
    return ref.run_steps(cfg, weights, batches, lowp=lowp)
