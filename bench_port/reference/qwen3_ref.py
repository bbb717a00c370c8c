"""Plain PyTorch reference of Qwen3 (float32, no kernels, no cache layout,
no batching), written from the published architecture and independent of
the program under test.

A layer: x += o(attn(q_norm(q(rms(x))), k_norm(k(rms(x))), v(rms(x))))
then x += down(silu(gate(rms(x))) * up(rms(x))); RMSNorm is x / sqrt(mean
x^2 + eps) times its weight, applied per head for q_norm and k_norm; RoPE
rotates the two halves of each head (theta from the config) after the
norm; query head h reads kv head h // (H / Hkv); attention is causal with
scale 1/sqrt(d_h). The tied head multiplies the final RMSNorm's output by
the embedding table.

Per request: `prefill` runs the context once and keeps its keys and values;
`extend` runs rows of tokens that follow the context (beams), each row
attending to the context and causally to itself."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from bench_port.reference.lowp import rounding


class Qwen3Reference:
    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor], lowp: bool = False):
        self.p = {k: w.detach().float() for k, w in weights.items()}
        self.L = cfg["num_hidden_layers"]
        self.H, self.Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
        self.dh, self.eps = cfg["head_dim"], cfg["rms_norm_eps"]
        self.theta = float(cfg["rope_theta"])
        self.q = rounding(lowp)

    def _rms(self, x, w):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps) * w

    def _mm(self, x, name):
        return self.q(x) @ self.q(self.p[name]).T

    def _rope(self, x, pos):
        """x [..., P, heads, dh], pos [P] or [R, P]."""
        half = self.dh // 2
        freq = self.theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
        ang = pos.float()[..., None] * freq
        c, s = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1)

    def _qkv(self, li, x, pos):
        pre = f"layers.{li}"
        h = self._rms(x, self.p[f"{pre}.input_layernorm"])
        shape = x.shape[:-1]
        q = self._mm(h, f"{pre}.self_attn.q_proj.weight").reshape(*shape, self.H, self.dh)
        k = self._mm(h, f"{pre}.self_attn.k_proj.weight").reshape(*shape, self.Hkv, self.dh)
        v = self._mm(h, f"{pre}.self_attn.v_proj.weight").reshape(*shape, self.Hkv, self.dh)
        q = self._rope(self._rms(q, self.p[f"{pre}.self_attn.q_norm"]), pos)
        k = self._rope(self._rms(k, self.p[f"{pre}.self_attn.k_norm"]), pos)
        return h, q, k, v

    def _attend(self, q, k, v, mask):
        """q [R, P, H, d], k/v [R, K, Hkv, d], mask [R|1, P, K] -> [R, P, H*d]."""
        G = self.H // self.Hkv
        k, v = k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)
        s = torch.einsum("rphd,rkhd->rhpk", self.q(q), self.q(k)) * self.dh ** -0.5
        s = s.masked_fill(~mask[:, None], float("-inf"))
        a = torch.softmax(s, -1)
        o = torch.einsum("rhpk,rkhd->rphd", self.q(a), self.q(v))
        return o.reshape(*o.shape[:2], -1)

    def _finish(self, li, x, o):
        pre = f"layers.{li}"
        x = x + self._mm(o, f"{pre}.self_attn.o_proj.weight")
        h = self._rms(x, self.p[f"{pre}.post_attention_layernorm"])
        g = self._mm(h, f"{pre}.mlp.gate_proj.weight")
        u = self._mm(h, f"{pre}.mlp.up_proj.weight")
        return x + self._mm(torch.nn.functional.silu(g) * u, f"{pre}.mlp.down_proj.weight")

    def logits(self, x):
        return self._mm(self._rms(x, self.p["norm"]), "embed_tokens.weight")

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, List]:
        """tokens [n] -> (the last position's logits [V], per layer (k, v)
        [n, Hkv, d])."""
        n = tokens.shape[0]
        x = self.p["embed_tokens.weight"][tokens][None]
        pos = torch.arange(n, device=tokens.device)
        mask = (pos[None, :] <= pos[:, None])[None]
        kv = []
        for li in range(self.L):
            _, q, k, v = self._qkv(li, x, pos)
            kv.append((k[0], v[0]))
            x = self._finish(li, x, self._attend(q, k, v, mask))
        return self.logits(x[0, -1]), kv

    @torch.no_grad()
    def extend(self, kv: List, toks: torch.Tensor, last_only: bool) -> torch.Tensor:
        """toks [R, h] following the context of `kv` -> logits [R, h, V] (or
        [R, V] at the last position)."""
        R, h = toks.shape
        n = kv[0][0].shape[0]
        x = self.p["embed_tokens.weight"][toks]
        pos = n + torch.arange(h, device=toks.device)
        i = torch.arange(h, device=toks.device)
        mask = torch.cat([torch.ones(h, n, dtype=torch.bool, device=toks.device),
                          i[None, :] <= i[:, None]], 1)[None]
        for li in range(self.L):
            _, q, k, v = self._qkv(li, x, pos)
            kc = torch.cat([kv[li][0][None].expand(R, -1, -1, -1), k], 1)
            vc = torch.cat([kv[li][1][None].expand(R, -1, -1, -1), v], 1)
            x = self._finish(li, x, self._attend(q, kc, vc, mask))
        return self.logits(x[:, -1] if last_only else x)

    @torch.no_grad()
    def path_scores(self, last: torch.Tensor, kv: List, paths: torch.Tensor) -> torch.Tensor:
        """Teacher-forced sum of log-probabilities of each path [k, S] after
        a prefilled context (its last logits and kv): [k]."""
        lp = torch.log_softmax(last, -1)[paths[:, 0]]
        if paths.shape[1] > 1:
            logp = torch.log_softmax(self.extend(kv, paths[:, :-1], False), -1)
            lp = lp + logp.gather(2, paths[:, 1:, None])[..., 0].sum(1)
        return lp

    @torch.no_grad()
    def beam_search(self, last: torch.Tensor, kv: List, steps: int, width: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Beam search of `steps` tokens at `width`: the first step takes the
        top `width` tokens, each later one the top `width` of all (beam,
        token) extensions by summed log-probability. Returns (paths [width,
        steps], scores [width]), best first."""
        scores, tok = torch.topk(torch.log_softmax(last, -1), width)
        paths = tok[:, None]
        V = last.shape[0]
        for _ in range(1, steps):
            logp = torch.log_softmax(self.extend(kv, paths, True), -1)
            scores, idx = torch.topk((scores[:, None] + logp).reshape(-1), width)
            paths = torch.cat([paths[idx // V], (idx % V)[:, None]], 1)
        return paths, scores


def check(cfg: dict, weights, requests: List[dict], steps: int, width: int
          ) -> Dict[str, float]:
    """The numbers compared over `requests` (each: context tokens, the
    returned paths and scores): the widest gap between a returned score and
    the reference's teacher-forced score of the same path, and the widest
    gap by which the returned k-th best path's reference score lies under
    the reference's own beam search's k-th best. With no request to
    compare, both are NaN, which fails."""
    if not requests:
        return {"score_gap": float("nan"), "rank_gap": float("nan")}
    ref = Qwen3Reference(cfg, weights)
    dev = ref.p["norm"].device
    score_gaps, rank_gaps = [], []
    for r in requests:
        tokens = torch.as_tensor(r["context"], dtype=torch.int64, device=dev)
        paths = torch.as_tensor(r["paths"], dtype=torch.int64, device=dev)
        got = torch.as_tensor(r["scores"], dtype=torch.float32, device=dev)
        last, kv = ref.prefill(tokens)
        want = ref.path_scores(last, kv, paths)
        score_gaps.append((got - want).abs().max())
        _, best = ref.beam_search(last, kv, steps, width)
        mine = torch.sort(want, descending=True).values
        rank_gaps.append((best[:paths.shape[0]] - mine).max().clamp(min=0))
    # torch's max keeps a NaN, where Python's max would drop it
    return {"score_gap": float(torch.stack(score_gaps).max()),
            "rank_gap": float(torch.stack(rank_gaps).max())}
