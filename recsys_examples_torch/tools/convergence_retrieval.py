"""Retrieval convergence on a planted sequential-structure dataset (the
port's copy of tools/convergence_retrieval.py).

Each event draws a cluster from softmax(user_pref), then an item uniform
inside it, so the held-out next item is predictable from the history's
cluster mix. Trains the port's `pretrain_gr_retrieval` entry (in-batch
sampled softmax), evals the holdout's rank among in-batch targets, and
prints the model's HR@10 / NDCG@10 / MRR beside a history oracle that
knows the true clusters and the random baseline (k / corpus size).

Usage: python -m recsys_examples_torch.tools.convergence_retrieval
           [--iters 2000] [--users N] [--device cuda]
"""
import argparse
import json
import os
import tempfile

import numpy as np

from recsys_examples_torch.utils.device import resolve_device


def gen_ratings(path, n_users=4000, n_items=2000, k=16, seed=0,
                min_len=20, max_len=120, sharpness=2.0):
    """Ratings file where the item SEQUENCE carries the signal: items
    are drawn cluster-first from softmax(sharpness * user_pref)."""
    rng = np.random.default_rng(seed)
    item_cluster = rng.integers(0, k, n_items)
    # items per cluster for uniform within-cluster draws
    by_cluster = [np.where(item_cluster == c)[0] for c in range(k)]
    user_pref = rng.normal(0, 1.0, (n_users, k))
    rows = []
    for u in range(n_users):
        logits = sharpness * user_pref[u]
        p = np.exp(logits - logits.max())
        p /= p.sum()
        n = int(rng.integers(min_len, max_len))
        cs = rng.choice(k, size=n, p=p)
        items = np.array([rng.choice(by_cluster[c]) for c in cs])
        rating = rng.choice([4, 5], n)  # rating irrelevant to retrieval
        for i in range(n):
            rows.append(f"{u}::{items[i]}::{rating[i]}::{i}")
    with open(path, "w") as f:
        f.write("\n".join(rows))
    return item_cluster


def oracle_metrics(npz_path, item_cluster, batch_size, k=16, smooth=1.0,
                   ks=(10,)):
    """History-oracle HR@k/NDCG@k/MRR under the EXACT eval protocol
    (in-batch corpus of holdout targets, sequential non-shuffled user
    batches): score each target by the user's smoothed per-cluster event
    rate estimated from the train prefix. Ties (same cluster) are broken
    pessimistically-at-random via tiny noise."""
    d = np.load(npz_path)
    items, offs = d["item_ids"], d["offsets"]
    n_users = len(offs) - 1
    rng = np.random.default_rng(0)
    hits = {kk: 0 for kk in ks}
    ndcg = {kk: 0.0 for kk in ks}
    mrr = 0.0
    cnt = 0
    for b0 in range(0, n_users - batch_size + 1, batch_size):
        uids = np.arange(b0, b0 + batch_size)
        targets = np.array([items[offs[u + 1] - 1] for u in uids])
        tclusters = item_cluster[targets]
        for bi, u in enumerate(uids):
            s, e = offs[u], offs[u + 1]
            hist_c = item_cluster[items[s:e - 1]]
            rate = (np.bincount(hist_c, minlength=k) + smooth)
            rate = rate / rate.sum()
            scores = rate[tclusters] + rng.random(batch_size) * 1e-9
            own = scores[bi]
            # exclude same-item duplicates (mirrors run_eval's same_item)
            other = (targets != targets[bi])
            rank = 1 + int((scores > own)[other].sum())
            for kk in ks:
                if rank <= kk:
                    hits[kk] += 1
                    ndcg[kk] += 1.0 / np.log2(rank + 1)
            mrr += 1.0 / rank
            cnt += 1
    out = {}
    for kk in ks:
        out[f"HR@{kk}"] = hits[kk] / cnt
        out[f"NDCG@{kk}"] = ndcg[kk] / cnt
    out["MRR"] = mrr / cnt
    return out


def write_gin(path, args, npz, batch, dtype):
    with open(path, "w") as f:
        f.write("\n".join([
            f"TrainerArgs.max_train_iters = {args.iters}",
            f"TrainerArgs.log_interval = {args.log_every}",
            "TrainerArgs.eval_iters = 0",   # the full holdout every eval
            f"TrainerArgs.eval_interval = {args.eval_every or max(args.iters // 8, 1)}",
            'DatasetArgs.dataset_name = "synthetic-movielens"',
            f'DatasetArgs.dataset_path = "{npz}"',
            f"DatasetArgs.batch_size = {batch}",
            "DatasetArgs.max_history_len = 128",
            "DatasetArgs.max_num_candidates = 1",
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
            "DynamicEmbeddingArgs.capacity = 8192",
            "DynamicEmbeddingArgs.bucket_capacity = 32",
            'DynamicEmbeddingArgs.optimizer = "rowwise_adagrad"',
            f"DynamicEmbeddingArgs.learning_rate = {args.demb_lr}",
            f"DynamicEmbeddingArgs.weight_decay = {args.sparse_wd}",
            f"RetrievalArgs.temperature = {args.temperature}",
        ]))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--users", type=int, default=4000)
    ap.add_argument("--lr", type=float, default=0.001)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--log-every", type=int, default=200)
    ap.add_argument("--demb-lr", type=float, default=0.01)
    ap.add_argument("--sparse-wd", type=float, default=0.0,
                    help="L2 decay on looked-up table rows")
    ap.add_argument("--dropout", type=float, default=0.1)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--heads", type=int, default=2)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--temperature", type=float, default=0.05)
    ap.add_argument("--eval-every", type=int, default=0,
                    help="eval cadence (0 = iters // 8)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from recsys_examples_torch.data.sequence_dataset import preprocess_movielens
    from recsys_examples_torch.training import pretrain_gr_retrieval
    from recsys_examples_torch.utils import gin_config

    wd = args.workdir or tempfile.mkdtemp(prefix="conv_retrieval_")
    os.makedirs(wd, exist_ok=True)
    ratings = os.path.join(wd, "ratings.dat")
    npz = os.path.join(wd, "seq.npz")
    item_cluster = gen_ratings(ratings, n_users=args.users)
    preprocess_movielens(ratings, npz, min_seq_len=10)
    batch = 64
    oracle = oracle_metrics(npz, item_cluster, batch)

    dtype = "bfloat16" if dev.type == "cuda" else "float32"
    cfg = os.path.join(wd, "conv.gin")
    write_gin(cfg, args, npz, batch, dtype)
    gin_config.clear_config()
    pretrain_gr_retrieval.EVAL_HISTORY.clear()
    pretrain_gr_retrieval.main(["--gin-config-file", cfg, "--device", str(dev)])
    hist = pretrain_gr_retrieval.EVAL_HISTORY
    best_hr = max((h.get("HR@10", 0.0) for h in hist), default=None)
    out = {
        "bench": "convergence_synthetic_retrieval",
        "iters": args.iters,
        "final": pretrain_gr_retrieval.LAST_EVAL,
        "best_hr10": None if best_hr is None else round(best_hr, 4),
        "oracle": {k: round(v, 4) for k, v in oracle.items()},
        "random_baseline_hr10": round(10 / batch, 4),
        "backend": dev.type,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
