"""Plain PyTorch reference of the HSTU ranking train step (float32, no
kernels, no hash table, no batching tricks), written from the model's
description and independent of the program under test.

One step, for a batch of B users with h_b history items each:
  - lookups: `item` and `user_id` rows of two dynamic tables (a row is made
    on first touch from its key, see `initial_rows`), `action`, `user_age`
    and `item_category_l1` rows of three static tables;
  - preprocessing: each user's item and action embeddings interleaved
    (2 h_b tokens) through the item MLP, the three contextual embeddings
    through the contextual MLP and put first (n_b = 3 + 2 h_b tokens); the
    whole times sqrt(D) plus a position embedding (row min(i, min(n_b,
    P - 1)) minus 1/sqrt(P));
  - L HSTU layers: LayerNorm (scale, bias); u, v, q, k = SiLU(x W_c + b_c);
    attention per user A = (SiLU(alpha q k^T) / N_max * M) v with alpha =
    1/sqrt(d_h), N_max = 2 * max_items + 3, and M the mask in which the 3
    contextual rows see every token and each other row sees itself and what
    precedes it; y = LayerNorm(A) * u (no params); x += y W_o^T;
  - postprocessing: each user's item tokens (even history positions), L2
    normalised (sqrt(sum + 1e-12));
  - head: MLP (ReLU between layers) to one logit per task; the loss is the
    binary cross-entropy of each task's bit of the label, averaged over
    rows and tasks;
  - update: Adam (bias-corrected, eps outside the root) on the dense
    params, rowwise Adagrad on each dynamic table's touched rows (acc +=
    mean g^2; w -= lr g / (sqrt(acc) + eps)).
The attention runs user by user under activation checkpointing, so a long
user's [H, n, n] scores live only while its own gradient is made."""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench_port.reference.lowp import rounding

_MASK32 = 0xFFFFFFFF


def _u64(c: int) -> int:
    return c - (1 << 64) if c >= (1 << 63) else c


def _lsr(k: torch.Tensor, s: int) -> torch.Tensor:
    return (k >> s) & ((1 << (64 - s)) - 1)


def _splitmix64(k: torch.Tensor) -> torch.Tensor:
    k = (k ^ _lsr(k, 30)) * _u64(0xBF58476D1CE4E5B9)
    k = (k ^ _lsr(k, 27)) * _u64(0x94D049BB133111EB)
    return k ^ _lsr(k, 31)


def initial_rows(keys: torch.Tensor, dim: int) -> torch.Tensor:
    """A dynamic table row on first touch: uniform in +-1/sqrt(dim), from
    32 bits of splitmix64(key * 0x9E3779B97F4A7C15 + column + 1) per value
    (the tables' documented key-seeded initializer)."""
    k = keys.to(torch.int64)[:, None]
    col = torch.arange(dim, dtype=torch.int64, device=keys.device)[None, :]
    bits = _splitmix64(k * _u64(0x9E3779B97F4A7C15) + col + 1) & _MASK32
    u = bits.to(torch.float32) * (1.0 / 4294967296.0)
    hi = 1.0 / dim ** 0.5
    return -hi + 2.0 * hi * u


def _layer_norm(x, scale, bias, eps):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    y = (x - mean) / torch.sqrt(var + eps)
    return y if scale is None else y * scale + bias


def _mlp(x, p, prefix, n, q: Callable):
    for i in range(n):
        x = q(x) @ q(p[f"{prefix}.layers.{i}.weight"]).T + p[f"{prefix}.layers.{i}.bias"]
        if i < n - 1:
            x = torch.relu(x)
    return x


class _Batch:
    """A host batch's index arrays on the device."""

    def __init__(self, b: dict, n_ctx: int, device):
        hist = np.asarray(b["hist"], np.int64)
        B = len(hist)
        lens = n_ctx + 2 * hist
        offs = np.concatenate([[0], np.cumsum(lens)])
        hoffs = np.concatenate([[0], np.cumsum(2 * hist)])
        # the packed sequence [user 0: ctx, history | user 1: ...] as rows
        # of cat([contextual (B * n_ctx), history (2 T)])
        src = np.empty(int(offs[-1]), np.int64)
        for i in range(B):
            src[offs[i]:offs[i] + n_ctx] = i * n_ctx + np.arange(n_ctx)
            src[offs[i] + n_ctx:offs[i + 1]] = B * n_ctx + np.arange(hoffs[i], hoffs[i + 1])
        pos = np.concatenate([np.arange(n) for n in lens])
        high = np.repeat(lens, lens)
        # the item token rows (even history positions) of every user
        item_rows = np.concatenate([offs[i] + n_ctx + 2 * np.arange(hist[i])
                                    for i in range(B)])
        t = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)
        self.B, self.lens, self.offs = B, lens.tolist(), offs.tolist()
        self.src, self.pos, self.high, self.item_rows = t(src), t(pos), t(high), t(item_rows)
        self.ids = {k: t(b[k]) for k in b if k not in ("hist", "labels", "max_items")}
        self.labels = t(b["labels"])
        self.max_seqlen = 2 * int(b["max_items"]) + n_ctx


def _attention(q, k, v, n_ctx, alpha, scale, qz):
    """One user's SiLU attention: q, k, v [n, H, d] -> [n, H, d]."""
    n = q.shape[0]
    i = torch.arange(n, device=q.device)
    mask = ((i[None, :] <= i[:, None]) | (i[:, None] < n_ctx)).to(q.dtype)
    s = torch.einsum("ihd,jhd->hij", qz(q), qz(k)) * alpha
    p = F.silu(s) * scale * mask
    return torch.einsum("hij,jhd->ihd", qz(p), qz(v))


def forward(cfg: dict, p: Dict[str, torch.Tensor], rows: Dict[str, torch.Tensor],
            inv: Dict[str, torch.Tensor], bt: _Batch, lowp: bool = False) -> torch.Tensor:
    """The mean loss of one batch. `rows[name]`: the unique rows a dynamic
    table serves this batch; `inv[name]`: each token's row among them."""
    q = rounding(lowp)
    D, L = cfg["hidden_size"], cfg["num_layers"]
    H, dh = cfg["num_attention_heads"], cfg["kv_channels"]
    P, eps = cfg["num_position_buckets"], cfg["layernorm_epsilon"]
    ctx_names = cfg["contextual_features"]
    n_ctx = len(ctx_names)

    def emb(name):
        if name in rows:
            return rows[name][inv[name]]
        table = p[f"embeddings.{name}_weight"]
        return table[bt.ids[name].clamp(0, table.shape[0] - 1)]

    item, action = emb("item"), emb("action")
    seq = torch.stack([item, action], 1).reshape(-1, item.shape[1])
    seq = _mlp(seq, p, "hstu_block.preprocessor.item_mlp", 2, q)
    ctx = torch.stack([emb(n) for n in ctx_names], 1).reshape(-1, item.shape[1])
    ctx = _mlp(ctx, p, "hstu_block.preprocessor.contextual_mlp", 2, q)
    x = torch.cat([ctx, seq])[bt.src]
    pe = p["hstu_block.preprocessor.positional_encoder.position_embeddings"]
    idx = torch.minimum(bt.pos, bt.high.clamp(max=P - 1))
    x = x * D ** 0.5 + (pe[idx] - P ** -0.5)

    alpha, scale = dh ** -0.5, 1.0 / bt.max_seqlen
    for li in range(L):
        pre = f"hstu_block.layers.{li}"
        normed = _layer_norm(x, p[f"{pre}.input_layernorm.scale"],
                             p[f"{pre}.input_layernorm.bias"], eps)
        W, bias = p[f"{pre}.uvqk_kernel"], p[f"{pre}.uvqk_bias"]
        u, v, qq, kk = (F.silu(q(normed) @ q(W[:, c]) + bias[c]) for c in range(4))
        outs = []
        for b in range(bt.B):
            s0, s1 = bt.offs[b], bt.offs[b + 1]
            sh = lambda t: t[s0:s1].reshape(s1 - s0, H, dh)
            outs.append(checkpoint(_attention, sh(qq), sh(kk), sh(v), n_ctx, alpha, scale, q,
                                   use_reentrant=False).reshape(s1 - s0, H * dh))
        attn = torch.cat(outs)
        y = _layer_norm(attn, None, None, eps) * u
        x = x + q(y) @ q(p[f"{pre}.linear_proj.weight"]).T

    h = x[bt.item_rows]
    h = h / torch.sqrt((h * h).sum(-1, keepdim=True) + 1e-12)
    logits = _mlp(h, p, "head", len(cfg["prediction_head_arch"]), q)
    nt = cfg["num_tasks"]
    bits = ((bt.labels[:, None] >> torch.arange(nt, device=h.device)) & 1).float()
    per = F.binary_cross_entropy_with_logits(logits, bits, reduction="none")
    return per.sum() / (logits.shape[0] * nt)


def run_steps(cfg: dict, weights: Dict[str, torch.Tensor], batches: List[dict],
              lowp: bool = False) -> dict:
    """Train from `weights` on `batches`, one step each. Returns the loss of
    every step, every leaf's gradient at the first step (a dynamic table's
    as the norms of its rows, in key order), and the norm of every leaf's
    change after the last (dense leaves by their names, the dynamic tables
    as "table.<name>")."""
    dev = next(iter(weights.values())).device
    opt, sparse = cfg["dense_optimizer"], cfg["dynamic_tables"]
    dim = cfg["embedding_dim"]
    n_ctx = len(cfg["contextual_features"])
    params = {k: w.detach().float().clone().requires_grad_() for k, w in weights.items()}
    p0 = {k: w.detach().float().clone() for k, w in weights.items()}
    m = {k: torch.zeros_like(w) for k, w in p0.items()}
    v = {k: torch.zeros_like(w) for k, w in p0.items()}
    # every key the steps touch, with its first-touch row
    keys = {n: torch.unique(torch.as_tensor(np.concatenate([np.asarray(b[n]) for b in batches]),
                                            dtype=torch.int64, device=dev)) for n in sparse}
    tab = {n: initial_rows(k, dim) for n, k in keys.items()}
    tab0 = {n: t.clone() for n, t in tab.items()}
    acc = {n: torch.zeros(k.shape[0], device=dev) for n, k in keys.items()}

    losses, grads = [], {}
    for step, hb in enumerate(batches, start=1):
        bt = _Batch(hb, n_ctx, dev)
        uniq, rows, inv = {}, {}, {}
        for n in sparse:
            ids = bt.ids[n]
            u_ids, inv[n] = torch.unique(ids, return_inverse=True)
            uniq[n] = torch.searchsorted(keys[n], u_ids)
            rows[n] = tab[n][uniq[n]].clone().requires_grad_()
        loss = forward(cfg, params, rows, inv, bt, lowp)
        loss.backward()
        losses.append(float(loss.detach()))
        if step == 1:
            grads = {k: w.grad.detach().clone() for k, w in params.items()}
            grads.update({f"table.{n}": rows[n].grad.norm(dim=1) for n in sparse})
        with torch.no_grad():
            b1, b2, lr, e = opt["beta1"], opt["beta2"], opt["lr"], opt["eps"]
            for k, w in params.items():
                g = w.grad
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                mhat = m[k] / (1 - b1 ** step)
                vhat = v[k] / (1 - b2 ** step)
                w.sub_(lr * mhat / (vhat.sqrt() + e))
                w.grad = None
            for n, args in sparse.items():
                g = rows[n].grad
                a = acc[n][uniq[n]] + (g * g).mean(1)
                acc[n][uniq[n]] = a
                tab[n][uniq[n]] = rows[n] - args["lr"] * g / (a.sqrt()[:, None] + args["eps"])
        del loss, rows
    with torch.no_grad():
        change = {k: float((w - p0[k]).norm()) for k, w in params.items()}
        change.update({f"table.{n}": float((tab[n] - tab0[n]).norm()) for n in sparse})
    return {"losses": losses, "grads": grads, "change_norms": change}
