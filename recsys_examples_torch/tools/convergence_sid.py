"""Planted-structure SID-GR convergence with an oracle bound (the port's
copy of tools/convergence_sid.py).

Each item i has S designated successors succ[i]; the next item is uniform
over succ[prev] with probability p_signal, else uniform over the catalog.
This first-order Markov source has a Bayes-optimal top-k recall
    recall@k* = p_signal * min(k, S)/S + (1 - p_signal) * k'/N
(k' the remaining slots). The tool trains the port's file-mode pipeline
(sequence npz -> RQ SID mapping from co-occurrence -> `pretrain_sid_gr`)
and prints its eval metrics beside that bound and the random one.

Usage: python -m recsys_examples_torch.tools.convergence_sid [--iters 1500]
           [--items 400] [--device cuda] ...
Prints one JSON line with metrics, oracle bounds and the gap.
"""
import argparse
import json
import os
import tempfile

import numpy as np

from recsys_examples_torch.utils.device import resolve_device


def generate(items, users, seq_len, succ_k, p_signal, seed):
    rng = np.random.default_rng(seed)
    succ = np.stack(
        [rng.choice(items, size=succ_k, replace=False) for _ in range(items)]
    )  # [items, S]
    flat, offsets = [], [0]
    for _u in range(users):
        seq = [int(rng.integers(items))]
        for _ in range(seq_len - 1):
            if rng.random() < p_signal:
                seq.append(int(succ[seq[-1], rng.integers(succ_k)]))
            else:
                seq.append(int(rng.integers(items)))
        flat.extend(seq)
        offsets.append(len(flat))
    return (
        np.asarray(flat, np.int64),
        np.asarray(offsets, np.int64),
        succ,
    )


def oracle_recall(k, S, p, N):
    """Bayes-optimal top-k recall: list succ[prev] first, then fill.
    The uniform-noise component hits iff the true next item (uniform over
    the catalog) lands among the k listed items."""
    return p * min(k, S) / S + (1 - p) * min(k, N) / N


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--items", type=int, default=400)
    p.add_argument("--users", type=int, default=3000)
    p.add_argument("--seq-len", type=int, default=24)
    p.add_argument("--succ-k", type=int, default=4)
    p.add_argument("--p-signal", type=float, default=0.8)
    p.add_argument("--iters", type=int, default=1500)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--codebook-size", type=int, default=32)
    p.add_argument("--hierarchies", type=int, default=3)
    p.add_argument("--beam", type=int, default=16)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--eval-iters", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--workdir", default=None)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    from recsys_examples_torch.data.sid_sequence_dataset import build_rq_sid_mapping
    from recsys_examples_torch.tools.build_sid_mapping import cooccurrence_embeddings
    from recsys_examples_torch.training import pretrain_sid_gr
    from recsys_examples_torch.utils import gin_config

    wd = args.workdir or tempfile.mkdtemp(prefix="sid_conv_")
    os.makedirs(wd, exist_ok=True)
    flat, offsets, succ = generate(args.items, args.users, args.seq_len, args.succ_k,
                                   args.p_signal, args.seed)
    seq_path = os.path.join(wd, "seq.npz")
    np.savez(seq_path, flat_items=flat, offsets=offsets,
             user_ids=np.arange(len(offsets) - 1, dtype=np.int64),
             num_items=np.int64(args.items))
    # the SID mapping from co-occurrence, so the hierarchy reflects the
    # planted transitions rather than random ids
    emb = cooccurrence_embeddings(flat, offsets, args.items, dim=32, seed=args.seed,
                                  device=dev)
    mapping = build_rq_sid_mapping(emb, [args.codebook_size] * args.hierarchies,
                                   iters=15, seed=args.seed)
    uniq = len({tuple(r) for r in mapping})
    map_path = os.path.join(wd, "map.npy")
    np.save(map_path, mapping)

    gin = os.path.join(wd, "cfg.gin")
    with open(gin, "w") as f:
        f.write(
            f'SIDDatasetArgs.dataset_name = "file"\n'
            f'SIDDatasetArgs.sequence_path = "{seq_path}"\n'
            f'SIDDatasetArgs.sid_mapping_path = "{map_path}"\n'
            f"SIDTrainerArgs.max_train_iters = {args.iters}\n"
            f"SIDTrainerArgs.batch_size = {args.batch_size}\n"
            f"SIDTrainerArgs.max_history_items = {args.seq_len}\n"
            f"SIDTrainerArgs.eval_iters = {args.eval_iters}\n"
            f"SIDTrainerArgs.learning_rate = {args.lr}\n"
            f"SIDTrainerArgs.log_interval = 100\n"
            f"SIDNetworkArgs.num_hierarchies = {args.hierarchies}\n"
            f"SIDNetworkArgs.codebook_size = {args.codebook_size}\n"
            f"SIDNetworkArgs.hidden_size = {args.hidden}\n"
            f"SIDNetworkArgs.num_layers = {args.layers}\n"
            f"SIDNetworkArgs.num_heads = 4\n"
            f"SIDNetworkArgs.head_dim = {max(args.hidden // 4, 16)}\n"
            f"SIDNetworkArgs.ffn_hidden = {args.hidden * 4}\n"
            f"SIDNetworkArgs.beam_width = {args.beam}\n"
        )
    gin_config.clear_config()
    try:
        pretrain_sid_gr.main(["--gin-config-file", gin, "--device", str(dev)])
    finally:
        gin_config.clear_config()
    metrics = dict(pretrain_sid_gr.LAST_EVAL)

    oracles = {f"recall@{k}": oracle_recall(k, args.succ_k, args.p_signal, args.items)
               for k in (1, 5, 10)}
    randoms = {f"recall@{k}": k / args.items for k in (1, 5, 10)}
    out = {
        "harness": "sid_planted_markov",
        "items": args.items,
        "p_signal": args.p_signal,
        "succ_k": args.succ_k,
        "unique_sid_tuples": uniq,
        "metrics": {k: round(float(v), 4) for k, v in metrics.items()},
        "oracle": {k: round(v, 4) for k, v in oracles.items()},
        "random": {k: round(v, 4) for k, v in randoms.items()},
        "workdir": wd,
        "backend": dev.type,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
