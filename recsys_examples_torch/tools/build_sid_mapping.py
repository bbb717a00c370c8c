"""Build a PID -> SID mapping file by residual k-means quantization (the
port's copy of tools/build_sid_mapping.py).

Item embeddings come from a .npy [num_items, D] file, or from a
preprocessed sequence npz through item co-occurrence and a randomized SVD
(--from-sequences): items that appear in similar contexts land near each
other, so the RQ hierarchy captures item structure. The co-occurrence
counts and the products with them run on `--device` in fp64 (the counts
are exact integers); the small QR and SVD run in numpy.

Usage:
  python -m recsys_examples_torch.tools.build_sid_mapping --embeddings items.npy --out map.npy
  python -m recsys_examples_torch.tools.build_sid_mapping --from-sequences seq.npz \
      --out map.npy --codebook-sizes 256,256,256,256 [--device cuda]
"""
import argparse

import numpy as np
import torch

from recsys_examples_torch.data.sid_sequence_dataset import (
    build_rq_sid_mapping,
    load_sequences,
)
from recsys_examples_torch.utils.device import resolve_device


def cooccurrence_embeddings(
    flat_items: np.ndarray,
    offsets: np.ndarray,
    num_items: int,
    dim: int = 64,
    window: int = 3,
    seed: int = 0,
    device="cuda",
) -> np.ndarray:
    """Item embeddings from windowed co-occurrence and a randomized SVD."""
    dev = resolve_device(device)
    rows, cols = [], []
    for u in range(len(offsets) - 1):
        seq = flat_items[offsets[u]:offsets[u + 1]]
        for i in range(len(seq)):
            for j in range(i + 1, min(i + 1 + window, len(seq))):
                rows.append(seq[i])
                cols.append(seq[j])
    C = torch.zeros((num_items, num_items), dtype=torch.float64, device=dev)
    idx = (torch.as_tensor(np.asarray(rows, np.int64), device=dev),
           torch.as_tensor(np.asarray(cols, np.int64), device=dev))
    C.index_put_(idx, torch.ones(len(rows), dtype=torch.float64, device=dev),
                 accumulate=True)
    # a log damping keeps hubs from dominating
    C = torch.log1p(C + C.T)
    rng = np.random.default_rng(seed)
    # randomized range finder: C @ G -> QR -> small SVD
    G = rng.normal(size=(num_items, min(dim + 8, num_items)))
    Q, _ = np.linalg.qr((C @ torch.as_tensor(G, device=dev)).cpu().numpy())
    B = (torch.as_tensor(Q.T.copy(), device=dev) @ C).cpu().numpy()
    _, s, vt = np.linalg.svd(B, full_matrices=False)
    emb = (C @ torch.as_tensor(vt[:dim].T.copy(), device=dev)).cpu().numpy()
    return (emb / np.maximum(s[:dim], 1e-6)).astype(np.float32)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--embeddings", help=".npy [num_items, D]")
    p.add_argument("--from-sequences", help="preprocessed sequence .npz")
    p.add_argument("--out", required=True)
    p.add_argument("--codebook-sizes", default="256,256,256,256")
    p.add_argument("--iters", type=int, default=25)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--svd-dim", type=int, default=64)
    args = p.parse_args(argv)
    sizes = [int(s) for s in args.codebook_sizes.split(",")]
    if args.embeddings:
        emb = np.load(args.embeddings)
    elif args.from_sequences:
        flat, offs, _users, n_items = load_sequences(args.from_sequences)
        emb = cooccurrence_embeddings(flat, offs, n_items, dim=args.svd_dim,
                                      seed=args.seed, device=args.device)
    else:
        p.error("need --embeddings or --from-sequences")
    mapping = build_rq_sid_mapping(emb, sizes, iters=args.iters, seed=args.seed)
    np.save(args.out, mapping)
    uniq = len({tuple(r) for r in mapping})
    print(f"wrote {args.out}: [{mapping.shape[0]}, {mapping.shape[1]}] "
          f"unique_tuples={uniq}/{mapping.shape[0]}")
    return mapping


if __name__ == "__main__":
    main()
