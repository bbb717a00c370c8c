"""End-to-end ranking convergence on a planted-structure synthetic dataset
(the port's copy of tools/convergence_synthetic.py).

A ratings file with known learnable structure -> `preprocess_movielens` ->
the port's `pretrain_gr_ranking` entry -> holdout AUC, beside the
generator's Bayes AUC and a history-conditional oracle's AUC (the
achievable bound under the eval protocol):

  items belong to K latent clusters; each user has a preference vector
  over clusters; rating ~ Bernoulli(sigmoid(pref . cluster)) -> 1..5.

Usage: python -m recsys_examples_torch.tools.convergence_synthetic
           [--iters 2000] [--device cuda]
Prints one JSON line with the final holdout AUC.
"""
import argparse
import json
import os
import tempfile

import numpy as np

from recsys_examples_torch.utils.device import resolve_device


def gen_ratings(path, n_users=2000, n_items=2000, k=16, seed=0,
                min_len=20, max_len=120, task="pref"):
    rng = np.random.default_rng(seed)
    item_cluster = rng.integers(0, k, n_items)
    if task == "item_bias":
        # diagnostic: like-ness depends on the ITEM only — learnable from
        # the candidate embedding alone (pipeline sanity check)
        user_pref = np.tile(
            np.linspace(-2.0, 2.0, k)[None, :], (n_users, 1)
        )
    else:
        user_pref = rng.normal(0, 1.5, (n_users, k))
    rows = []
    p_all = []
    for u in range(n_users):
        n = int(rng.integers(min_len, max_len))
        items = rng.integers(0, n_items, n)
        logits = user_pref[u, item_cluster[items]]
        p = 1.0 / (1.0 + np.exp(-logits))
        like = rng.random(n) < p
        rating = np.where(like, rng.choice([4, 5], n), rng.choice([1, 2, 3], n))
        ts = np.arange(n)
        p_all.append((p, like))
        for i in range(n):
            rows.append(f"{u}::{items[i]}::{rating[i]}::{ts[i]}")
    with open(path, "w") as f:
        f.write("\n".join(rows))
    # Bayes AUC of the generator (upper bound for an oracle that KNOWS
    # each user's true preference vector)
    ps = np.concatenate([p for p, _ in p_all])
    ys = np.concatenate([y for _, y in p_all])
    return float(_auc(ps, ys)), item_cluster


def _auc(ps, ys):
    ps = np.asarray(ps, float)
    ys = np.asarray(ys, bool)
    order = np.argsort(ps)
    ranks = np.empty_like(order, float)
    ranks[order] = np.arange(len(ps))
    return (ranks[ys].mean() - (ys.sum() - 1) / 2) / max((~ys).sum(), 1)


def holdout_oracle_auc(npz_path, item_cluster, k=16, smooth=4.0):
    """History-conditional oracle: the ACHIEVABLE bound for any model that
    sees only the user's history (the generator Bayes bound assumes the
    true preference vector, which no amount of training can recover from
    a finite history). Knows the true item clusters; estimates each
    user's per-cluster like-rate from the train prefix with Beta
    smoothing toward the global rate, then scores the held-out last item.
    Matches the eval protocol exactly (leave-one-out, label = rating>=4)."""
    d = np.load(npz_path)
    items, actions, offs = d["item_ids"], d["action_ids"], d["offsets"]
    like = actions >= 4
    # global like-rate over train prefixes only
    num = den = 0
    for u in range(len(offs) - 1):
        s, e = offs[u], offs[u + 1]
        num += like[s:e - 1].sum()
        den += max(e - 1 - s, 0)
    g = num / max(den, 1)
    ps, ys = [], []
    for u in range(len(offs) - 1):
        s, e = offs[u], offs[u + 1]
        if e - s < 2:
            continue
        c = item_cluster[items[s:e]]
        hl = like[s:e - 1].astype(float)
        cnum = np.bincount(c[:-1], weights=hl, minlength=k) + smooth * g
        cden = np.bincount(c[:-1], minlength=k) + smooth
        ps.append((cnum / cden)[c[-1]])
        ys.append(like[e - 1])
    return float(_auc(ps, ys))


def write_gin(path, args, npz, dtype):
    with open(path, "w") as f:
        f.write("\n".join([
            f"TrainerArgs.max_train_iters = {args.iters}",
            f"TrainerArgs.log_interval = {args.log_every}",
            f"TrainerArgs.eval_iters = {args.eval_iters}",  # 0 = full holdout
            f"TrainerArgs.eval_interval = {args.eval_every or max(args.iters // 8, 1)}",
            'DatasetArgs.dataset_name = "synthetic-movielens"',
            f'DatasetArgs.dataset_path = "{npz}"',
            "DatasetArgs.batch_size = 64",
            "DatasetArgs.max_history_len = 128",
            # train on the last candidates of each user's train split, score
            # only the holdout
            f"DatasetArgs.max_num_candidates = {args.candidates}",
            "DatasetArgs.eval_max_num_candidates = 1",
            "DatasetArgs.item_vocab_size = 2000",
            "DatasetArgs.action_vocab_size = 6",
            f"NetworkArgs.hidden_size = {args.hidden}",
            f"NetworkArgs.num_layers = {args.layers}",
            f"NetworkArgs.num_attention_heads = {args.heads}",
            f"NetworkArgs.kv_channels = {args.hidden // args.heads}",
            f"NetworkArgs.hidden_dropout = {args.dropout}",
            f'NetworkArgs.dtype = "{dtype}"',
            "NetworkArgs.position_num_buckets = 256",
            f"OptimizerArgs.learning_rate = {args.lr}",
            f"OptimizerArgs.weight_decay = {args.weight_decay}",
            # weight decay only acts through adamw
            f'OptimizerArgs.optimizer_str = "{"adamw" if args.weight_decay else "adam"}"',
            "DynamicEmbeddingArgs.capacity = 8192",
            "DynamicEmbeddingArgs.bucket_capacity = 32",
            'DynamicEmbeddingArgs.optimizer = "rowwise_adagrad"',
            f"DynamicEmbeddingArgs.learning_rate = {args.demb_lr}",
            f"DynamicEmbeddingArgs.weight_decay = {args.sparse_wd}",
            "RankingArgs.prediction_head_arch = [64, 1]",
            "RankingArgs.num_tasks = 1",
        ]))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--dtype", default=None,
                    help="bfloat16|float32 (bfloat16 on cuda, float32 on cpu)")
    ap.add_argument("--lr", type=float, default=0.001)
    ap.add_argument("--task", default="pref", choices=["pref", "item_bias"])
    ap.add_argument("--users", type=int, default=2000)
    ap.add_argument("--candidates", type=int, default=8,
                    help="train-time candidate window (eval always 1)")
    ap.add_argument("--weight-decay", type=float, default=0.0)
    ap.add_argument("--demb-lr", type=float, default=0.01,
                    help="sparse-table rowwise_adagrad lr")
    ap.add_argument("--sparse-wd", type=float, default=0.0,
                    help="L2 weight decay on looked-up table rows")
    ap.add_argument("--dropout", type=float, default=0.1)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--heads", type=int, default=2)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--eval-every", type=int, default=0,
                    help="eval cadence in iters (0 = iters // 8)")
    ap.add_argument("--eval-iters", type=int, default=0,
                    help="eval batches per eval (0 = the full holdout)")
    ap.add_argument("--log-every", type=int, default=100)
    ap.add_argument("--reuse", action="store_true",
                    help="reuse the ratings and seq.npz already in --workdir")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from recsys_examples_torch.data.sequence_dataset import preprocess_movielens
    from recsys_examples_torch.training import pretrain_gr_ranking
    from recsys_examples_torch.utils import gin_config

    wd = args.workdir or tempfile.mkdtemp(prefix="convergence_")
    os.makedirs(wd, exist_ok=True)
    ratings = os.path.join(wd, "ratings.dat")
    npz = os.path.join(wd, "seq.npz")
    meta = os.path.join(wd, "meta.npz")
    if args.reuse and os.path.exists(npz) and os.path.exists(meta):
        m = np.load(meta)
        bayes_auc = float(m["bayes_auc"])
        oracle_auc = float(m["oracle_auc"])
    else:
        bayes_auc, item_cluster = gen_ratings(ratings, n_users=args.users, task=args.task)
        preprocess_movielens(ratings, npz, min_seq_len=10)
        oracle_auc = holdout_oracle_auc(npz, item_cluster)
        np.savez(meta, bayes_auc=bayes_auc, item_cluster=item_cluster,
                 oracle_auc=oracle_auc)

    dtype = args.dtype or ("bfloat16" if dev.type == "cuda" else "float32")
    cfg = os.path.join(wd, "conv.gin")
    write_gin(cfg, args, npz, dtype)
    gin_config.clear_config()
    pretrain_gr_ranking.EVAL_AUC_HISTORY.clear()
    pretrain_gr_ranking.main(["--gin-config-file", cfg, "--device", str(dev)])
    hist = [float(v[0]) for v in pretrain_gr_ranking.EVAL_AUC_HISTORY]
    auc = pretrain_gr_ranking.LAST_EVAL_AUC
    out = {
        "bench": "convergence_synthetic_ranking",
        "task": args.task,
        "iters": args.iters,
        "holdout_auc": None if auc is None else round(float(auc[0]), 4),
        "best_holdout_auc": round(max(hist), 4) if hist else None,
        "auc_history": [round(v, 4) for v in hist],
        "bayes_auc_upper_bound": round(bayes_auc, 4),
        # the achievable bound: a history-conditional oracle that knows the
        # true item clusters
        "holdout_oracle_auc": round(oracle_auc, 4),
        "backend": dev.type,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
