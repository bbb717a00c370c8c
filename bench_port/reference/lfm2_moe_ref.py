"""Plain PyTorch reference of LFM2-MoE (float32, no kernels, no cache layout,
no batching), written from the published architecture (HF `transformers`'
`Lfm2Moe*` classes) and independent of the program under test.

A layer: h = x + op(rms(x, operator_norm)), then h + ffn(rms(h, ffn_norm));
RMSNorm is x / sqrt(mean x^2 + eps) times its weight. op is one of:
  - "conv": B, C, u = chunk3(in_proj(x)); z = B u; y_t = C_t (w_0 z_{t-2} +
    w_1 z_{t-1} + w_2 z_t) (conv_L_cache 3: a depthwise causal kernel,
    zeros before position 0); out_proj(y).
  - "full_attention": Qwen3's (`qwen3_ref.py`, whose helpers this file
    takes): q/k RMSNorm per head, RoPE by halves, causal GQA at scale
    1/sqrt(d_h), out_proj.
ffn is a dense SwiGLU, w2(silu(w1 x) w3 x), in the first num_dense_layers
layers, and a sparse MoE in the rest: s = sigmoid(gate(x)) over the experts;
the experts are the top k of s + expert_bias; their weights are s there,
divided by (their sum + 1e-6), times routed_scaling_factor; out = sum of
weight_e w2_e(silu(w1_e x) w3_e x). The final RMSNorm comes before the tied
head.

Departures, none of them in the mathematics:
  - At 23.8 B parameters an fp32 copy of the weights does not fit the card,
    so the weights stay in the type they are given (bf16) and each matrix,
    or each selected expert, is upcast to fp32 where it is used. The values
    are bf16 already, so the products are those of an fp32 copy.
  - `extend` runs a conv layer over the context's last L-1 z rows followed
    by the rows' own: with a kernel of L positions no earlier row reaches
    them.
  - The weights use the program's names (`layers.i.feed_forward.w13` stacks
    each expert's w1 and w3 rows; `norm` is HF's `embedding_norm`).

Per request: `prefill` runs the context once and keeps, per layer, its keys
and values or its z rows; `extend` runs rows of tokens that follow the
context (beams), each row attending to the context and causally to
itself."""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from bench_port.reference import qwen3_ref
from bench_port.reference.lowp import rounding


class Lfm2MoeReference(qwen3_ref.Qwen3Reference):
    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor], lowp: bool = False):
        self.p = {k: w.detach() for k, w in weights.items()}
        self.L = cfg["num_hidden_layers"]
        self.H, self.Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
        self.dh, self.eps = cfg["head_dim"], cfg["norm_eps"]
        self.theta = float(cfg["rope_parameters"]["rope_theta"])
        self.kinds = cfg["layer_types"]
        self.dense, self.Lc = cfg["num_dense_layers"], cfg["conv_L_cache"]
        self.k, self.norm_topk = cfg["num_experts_per_tok"], cfg["norm_topk_prob"]
        self.scaling, self.use_bias = cfg["routed_scaling_factor"], cfg["use_expert_bias"]
        self.q = rounding(lowp)

    def _w(self, name: str) -> torch.Tensor:
        return self.p[name].float()

    def _mm(self, x, name):
        return self.q(x) @ self.q(self._w(name)).T

    def _conv(self, li, h, z_prev):
        """h [R, P, D] normed, z_prev [R, L-1, D] (the z rows before) ->
        (out [R, P, D], z [R, P, D])."""
        pre = f"layers.{li}.conv"
        b, c, u = self._mm(h, f"{pre}.in_proj.weight").chunk(3, -1)
        z = b * u
        zz = torch.cat([z_prev, z], 1)
        w = self._w(f"{pre}.conv.weight")[:, 0]                  # [D, L]
        P = h.shape[1]
        y = sum(zz[:, j:j + P] * w[:, j] for j in range(self.Lc))
        return self._mm(c * y, f"{pre}.out_proj.weight"), z

    def _attn(self, li, h, pos, kv_ctx, mask):
        """h [R, P, D] normed -> (out, k, v); kv_ctx the context's (k, v)
        [n, Hkv, d] before the rows' own, or None."""
        pre = f"layers.{li}.self_attn"
        shape = h.shape[:-1]
        q = self._mm(h, f"{pre}.q_proj.weight").reshape(*shape, self.H, self.dh)
        k = self._mm(h, f"{pre}.k_proj.weight").reshape(*shape, self.Hkv, self.dh)
        v = self._mm(h, f"{pre}.v_proj.weight").reshape(*shape, self.Hkv, self.dh)
        q = self._rope(self._rms(q, self._w(f"{pre}.q_norm")), pos)
        k = self._rope(self._rms(k, self._w(f"{pre}.k_norm")), pos)
        kc, vc = k, v
        if kv_ctx is not None:
            R = h.shape[0]
            kc = torch.cat([kv_ctx[0][None].expand(R, -1, -1, -1), k], 1)
            vc = torch.cat([kv_ctx[1][None].expand(R, -1, -1, -1), v], 1)
        out = self._attend(q, kc, vc, mask)
        return self._mm(out, f"{pre}.o_proj.weight"), k, v

    def route(self, li, x):
        """x [T, D] -> (weights [T, k], experts [T, k]) of layer li."""
        pre = f"layers.{li}.feed_forward"
        s = torch.sigmoid(self._mm(x, f"{pre}.gate.weight"))
        pick = s + self._w(f"{pre}.expert_bias") if self.use_bias else s
        sel = torch.topk(pick, self.k, dim=-1).indices
        w = s.gather(1, sel)
        if self.norm_topk:
            w = w / (w.sum(-1, keepdim=True) + 1e-6)
        return w * self.scaling, sel

    def moe(self, li, h):
        """The sparse MoE of layer li over h [..., D] (normed)."""
        pre = f"layers.{li}.feed_forward"
        x = h.reshape(-1, h.shape[-1])
        w, sel = self.route(li, x)
        out = torch.zeros_like(x)
        for e in torch.unique(sel).tolist():
            rows, slot = (sel == e).nonzero(as_tuple=True)
            g, u = (self.q(x[rows]) @ self.q(self.p[f"{pre}.w13"][e].float()).T).chunk(2, -1)
            y = self.q(F.silu(g) * u) @ self.q(self.p[f"{pre}.w2"][e].float()).T
            out.index_add_(0, rows, w[rows, slot, None] * y)
        return out.reshape(h.shape)

    def _ffn(self, li, x):
        pre = f"layers.{li}"
        h = self._rms(x, self._w(f"{pre}.ffn_norm"))
        if li < self.dense:
            f = f"{pre}.feed_forward"
            act = F.silu(self._mm(h, f"{f}.w1.weight")) * self._mm(h, f"{f}.w3.weight")
            return x + self._mm(act, f"{f}.w2.weight")
        return x + self.moe(li, h)

    def logits(self, x):
        return self._mm(self._rms(x, self._w("norm")), "embed_tokens.weight")

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor):
        """tokens [n] -> (the last position's logits [V], per layer its
        context state: (k, v) [n, Hkv, d] or (z,) [n, D])."""
        n = tokens.shape[0]
        x = self._w("embed_tokens.weight")[tokens][None]
        pos = torch.arange(n, device=tokens.device)
        mask = (pos[None, :] <= pos[:, None])[None]
        state = []
        for li in range(self.L):
            h = self._rms(x, self._w(f"layers.{li}.operator_norm"))
            if self.kinds[li] == "full_attention":
                o, k, v = self._attn(li, h, pos, None, mask)
                state.append((k[0], v[0]))
            else:
                o, z = self._conv(li, h, x.new_zeros(1, self.Lc - 1, x.shape[-1]))
                state.append((z[0],))
            x = self._ffn(li, x + o)
        return self.logits(x[0, -1]), state

    @torch.no_grad()
    def extend(self, state: List, toks: torch.Tensor, last_only: bool) -> torch.Tensor:
        """toks [R, h] following the context of `state` -> logits [R, h, V]
        (or [R, V] at the last position)."""
        R, h = toks.shape
        n = next(s[0].shape[0] for s in state)
        dev = toks.device
        x = self._w("embed_tokens.weight")[toks]
        pos = n + torch.arange(h, device=dev)
        i = torch.arange(h, device=dev)
        mask = torch.cat([torch.ones(h, n, dtype=torch.bool, device=dev),
                          i[None, :] <= i[:, None]], 1)[None]
        for li in range(self.L):
            hn = self._rms(x, self._w(f"layers.{li}.operator_norm"))
            if self.kinds[li] == "full_attention":
                o, _, _ = self._attn(li, hn, pos, state[li], mask)
            else:
                z = state[li][0]
                z_prev = F.pad(z, (0, 0, max(self.Lc - 1 - n, 0), 0))[-(self.Lc - 1):]
                o, _ = self._conv(li, hn, z_prev[None].expand(R, -1, -1))
            x = self._ffn(li, x + o)
        return self.logits(x[:, -1] if last_only else x)


# the name by which the harness's tools find a serving family's reference
# class (`tools/calibrate.py`: `fam.ref.Qwen3Reference`)
Qwen3Reference = Lfm2MoeReference


def check(cfg: dict, weights, requests: List[dict], steps: int, width: int
          ) -> Dict[str, float]:
    """`qwen3_ref.check`'s numbers with this reference: the widest gap
    between a returned score and the reference's teacher-forced score of
    the same path, and the widest gap by which the returned k-th best
    path's reference score lies under the reference's own beam search's
    k-th best. With no request to compare, both are NaN, which fails."""
    if not requests:
        return {"score_gap": float("nan"), "rank_gap": float("nan")}
    ref = Lfm2MoeReference(cfg, weights)
    dev = ref.p["norm"].device
    score_gaps, rank_gaps = [], []
    for r in requests:
        tokens = torch.as_tensor(r["context"], dtype=torch.int64, device=dev)
        paths = torch.as_tensor(r["paths"], dtype=torch.int64, device=dev)
        got = torch.as_tensor(r["scores"], dtype=torch.float32, device=dev)
        last, state = ref.prefill(tokens)
        want = ref.path_scores(last, state, paths)
        score_gaps.append((got - want).abs().max())
        _, best = ref.beam_search(last, state, steps, width)
        mine = torch.sort(want, descending=True).values
        rank_gaps.append((best[:paths.shape[0]] - mine).max().clamp(min=0))
    return {"score_gap": float(torch.stack(score_gaps).max()),
            "rank_gap": float(torch.stack(rank_gaps).max())}
