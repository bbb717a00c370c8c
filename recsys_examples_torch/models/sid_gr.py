"""SID-GR: hierarchical semantic-ID generative recommender (counterpart of
recsys_examples_tpu/models/sid_gr.py).

Per-hierarchy codebook embeddings, a BOS token before the candidate, a
causal decoder, per-hierarchy (or shared) LM heads and a CE loss on the
candidate SID tokens; `generate` (the no-KV baseline that re-runs the prefix
for every hierarchy, the oracle of the cached path) and
`generate_beam_decode` (one prefill, then H - 1 steps through the fused
beam-decode attention, kernel K7 on the card) for inference; and the
stepwise `beam_prefill` / `beam_step` / `beam_finalize` split with a
narrowing beam width and KV compaction.

The decoder runs on padded dense [B, N, D]. Training sequence per sample:
  [history SIDs ..., BOS, candidate SIDs[0..H-2]]
with CE supervision at the positions predicting candidate SIDs[0..H-1].

Submodules keep flax's names (`codebook_i`, `bos_token`, `decoder`,
`lm_head_i`), so `convert.dense_state_dict` carries a flax param tree
across. The model lives on the card unless the caller passes a device.
Integer state is int64 here (int32 in the JAX package); updates that JAX
writes as `x.at[...].set(...)` are in-place writes on tensors the method
made itself, never on its inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from recsys_examples_torch.data.sid_batch import SIDBatch
from recsys_examples_torch.models.beam_search import (
    BeamState,
    decode_paths,
    first_expand,
    init_beam,
    propagate,
    top_k_stable,
)
from recsys_examples_torch.modules.transformer import (
    BeamAttnInputs,
    TransformerStack,
    dense,
    init_dense,
    make_padded_causal_mask,
)
from recsys_examples_torch.ops.jagged import jagged_to_padded_dense, row_to_batch
from recsys_examples_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class SIDGRConfig:
    num_hierarchies: int = 4
    codebook_size: int = 256
    hidden_size: int = 256
    num_layers: int = 4
    num_heads: int = 4
    head_dim: int = 64
    ffn_hidden: int = 1024
    dropout: float = 0.0
    share_lm_head: bool = False
    share_codebook: bool = False
    dtype: torch.dtype = torch.float32
    beam_width: int = 32


class Codebook(nn.Module):
    """flax `nn.Embed`: one `embedding` [codebook_size, hidden] param."""

    def __init__(self, size: int, hidden: int, device=None):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(size, hidden, device=device))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids]


class SIDGRModel(nn.Module):
    def __init__(self, config: SIDGRConfig, device="cuda"):
        super().__init__()
        cfg = self.config = config
        dev = resolve_device(device)
        self.n_books = 1 if cfg.share_codebook else cfg.num_hierarchies
        for i in range(self.n_books):
            setattr(self, f"codebook_{i}",
                    Codebook(cfg.codebook_size, cfg.hidden_size, dev))
        self.bos_token = nn.Parameter(torch.zeros(cfg.hidden_size, device=dev))
        self.decoder = TransformerStack(
            cfg.hidden_size, cfg.num_layers, cfg.num_heads, cfg.head_dim,
            cfg.ffn_hidden, cfg.dropout, cfg.dtype, dev)
        self.n_lm_heads = 1 if cfg.share_lm_head else cfg.num_hierarchies
        for i in range(self.n_lm_heads):
            setattr(self, f"lm_head_{i}",
                    nn.Linear(cfg.hidden_size, cfg.codebook_size, device=dev))

    @property
    def device(self) -> torch.device:
        return self.bos_token.device

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "SIDGRModel":
        """Random params with flax's init rules, drawn from `generator` (on
        its device): codebooks normal(1 / sqrt(hidden)), BOS normal(0.02),
        Dense lecun normal with zero bias."""
        cfg = self.config
        normal = lambda p, std: p.copy_(std * torch.randn(
            p.shape, generator=generator, device=generator.device))
        for i in range(self.n_books):
            normal(self._book(i).embedding, cfg.hidden_size ** -0.5)
        normal(self.bos_token, 0.02)
        for m in self.decoder.modules():
            if hasattr(m, "init_weights"):
                m.init_weights(generator)
        for i in range(self.n_lm_heads):
            init_dense(self._head(i), generator)
        return self

    # ------------------------------------------------------------ embed
    def _book(self, h: int) -> Codebook:
        return getattr(self, f"codebook_{0 if self.config.share_codebook else h}")

    def _head(self, h: int) -> nn.Linear:
        return getattr(self, f"lm_head_{0 if self.config.share_lm_head else h}")

    def _embed(self, h: int, tokens: torch.Tensor) -> torch.Tensor:
        return self._book(h)(tokens).to(self.config.dtype)

    def _log_probs(self, h: int, hidden: torch.Tensor) -> torch.Tensor:
        """The LM head and log-softmax of hierarchy h, both fp32."""
        logits = dense(self._head(h), hidden.float(), torch.float32)
        return torch.log_softmax(logits, dim=-1)

    def _embed_history(self, batch: SIDBatch) -> torch.Tensor:
        """[cap, D]; a token at position p of its sequence belongs to
        hierarchy p % H. Rows past the last offset belong to no sequence:
        `row_to_batch` sends them to the last one, and no caller reads them."""
        cfg = self.config
        sids = batch.history_sids
        if cfg.share_codebook:
            return self._embed(0, sids)
        cap = sids.shape[0]
        b = row_to_batch(batch.history_offsets, cap)
        pos = torch.arange(cap, device=sids.device) - batch.history_offsets[b]
        books = torch.stack([self._book(i).embedding for i in range(self.n_books)])
        return books[pos % cfg.num_hierarchies, sids].to(cfg.dtype)

    def _history_with_bos(self, batch: SIDBatch, N: int):
        """Padded dense [B, N, D] history with BOS written at each sample's
        length, and the lengths [B]."""
        base = jagged_to_padded_dense(
            self._embed_history(batch), batch.history_offsets, N)
        lens = batch.history_lengths
        bidx = torch.arange(batch.batch_size, device=lens.device)
        base[bidx, lens] = self.bos_token.to(self.config.dtype)
        return base, lens, bidx

    def _build_train_sequence(self, batch: SIDBatch):
        """Padded dense input [B, N, D], total lengths, history lengths.

        Per sample: history tokens, then BOS, then candidate[0..H-2]. The
        position predicting candidate[h] is len_hist + h (the BOS position
        predicts candidate[0])."""
        H = self.config.num_hierarchies
        N = batch.max_history_tokens + H   # + BOS + H-1 candidate tokens
        dense_in, lens, bidx = self._history_with_bos(batch, N)
        for h in range(H - 1):
            dense_in[bidx, lens + 1 + h] = self._embed(h, batch.candidate_sids[:, h])
        return dense_in, lens + H, lens

    # ------------------------------------------------------------ forward
    def forward(self, batch: SIDBatch, train: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        batch = batch.to(self.device)
        H = self.config.num_hierarchies
        dense_in, total_lens, hist_lens = self._build_train_sequence(batch)
        mask = make_padded_causal_mask(total_lens, dense_in.shape[1])
        hidden = self.decoder(dense_in, mask=mask, train=train, generator=generator)
        bidx = torch.arange(batch.batch_size, device=hidden.device)
        per_h_loss = []
        for h in range(H):
            # BOS at hist_lens predicts candidate[0]
            logp = self._log_probs(h, hidden[bidx, hist_lens + h])
            nll = -torch.gather(logp, 1, batch.candidate_sids[:, h][:, None])[:, 0]
            per_h_loss.append(nll.mean())
        per_h_loss = torch.stack(per_h_loss)
        loss = per_h_loss.sum() / H
        return loss, {"loss": loss, "per_hierarchy_loss": per_h_loss}

    # ------------------------------------------------------------ generate
    @torch.no_grad()
    def generate(self, batch: SIDBatch, beam_width: Optional[int] = None):
        """No-KV baseline beam generation: re-runs the full prefix for every
        hierarchy. Returns (paths [B, W, H], scores [B, W])."""
        batch = batch.to(self.device)
        cfg = self.config
        W = beam_width or cfg.beam_width
        H, B = cfg.num_hierarchies, batch.batch_size
        base, lens, bidx = self._history_with_bos(
            batch, batch.max_history_tokens + H)

        # hierarchy 0: single context
        mask = make_padded_causal_mask(lens + 1, base.shape[1])
        hidden = self.decoder(base, mask=mask, train=False)
        state = first_expand(init_beam(B, W, H, self.device),
                             self._log_probs(0, hidden[bidx, lens]))

        # hierarchies 1..H-1: re-run the prefix per beam
        lens_bw = lens.repeat_interleave(W)
        bw = torch.arange(B * W, device=self.device)
        for h in range(1, H):
            paths = decode_paths(state)                    # [B, W, H], first h valid
            seq = base.repeat_interleave(W, dim=0)         # [B*W, N, D]
            for hh in range(h):
                seq[bw, lens_bw + 1 + hh] = self._embed(hh, paths[:, :, hh].reshape(B * W))
            mask = make_padded_causal_mask(lens_bw + 1 + h, seq.shape[1])
            hidden = self.decoder(seq, mask=mask, train=False)
            logp = self._log_probs(h, hidden[bw, lens_bw + h])
            state = propagate(state, logp.reshape(B, W, cfg.codebook_size))
        return decode_paths(state), state.scores

    def _prefill(self, batch: SIDBatch, W: int, logits_processor=None):
        """One causal pass over [history, BOS] keeping the per-layer context
        KV, and the hierarchy-0 expansion. Returns (state, ctx_kv, ctx_lens)."""
        H, B = self.config.num_hierarchies, batch.batch_size
        N0 = batch.max_history_tokens + 1
        base, lens, bidx = self._history_with_bos(batch, N0)
        mask = make_padded_causal_mask(lens + 1, N0)
        hidden, ctx_kv = self.decoder(base, mask=mask, train=False, return_kv=True)
        logp0 = self._log_probs(0, hidden[bidx, lens])
        if logits_processor is not None:
            # the processor contract is (step, logp [B, W, V], paths
            # [B, W, step]); at prefill there is one implicit beam, no prefix
            no_prefix = torch.zeros((B, 1, 0), dtype=torch.int64, device=self.device)
            logp0 = logits_processor(0, logp0[:, None, :], no_prefix)[:, 0]
        state = first_expand(init_beam(B, W, H, self.device), logp0)
        return state, ctx_kv, lens + 1    # history + BOS

    @torch.no_grad()
    def generate_beam_decode(self, batch: SIDBatch, beam_width: Optional[int] = None,
                             attn_backend: str = "auto"):
        """KV-cached beam decode: one prefill over [history, BOS], then H - 1
        steps through the fused beam-decode attention. The context KV is read
        once per batch (never repeated over beams) and the per-beam KV is
        never reordered: each step passes ancestry indices instead.
        `attn_backend`: "auto" (kernel K7 on the card) or "plain".

        Returns (paths [B, W, H], scores [B, W])."""
        batch = batch.to(self.device)
        cfg = self.config
        W = beam_width or cfg.beam_width
        H, B, L = cfg.num_hierarchies, batch.batch_size, cfg.num_layers
        state, ctx_kv, ctx_lens = self._prefill(batch, W)

        # per-layer decode-side KV store (never reordered); A[:, n, w] is the
        # beam slot holding step-n KV on current beam w's path
        kv_shape = (B, H - 1, W, cfg.num_heads, cfg.head_dim)
        beam_k = [torch.zeros(kv_shape, dtype=cfg.dtype, device=self.device)
                  for _ in range(L)]
        beam_v = [torch.zeros_like(beam_k[0]) for _ in range(L)]
        A = torch.zeros((B, H - 1, W), dtype=torch.int64, device=self.device)
        ident = torch.arange(W, device=self.device).expand(B, W)

        for h in range(1, H):
            if h > 1:   # re-root ancestry through this step's parents
                par = state.parents[:, h - 1, :]
                A[:, : h - 1] = torch.gather(
                    A[:, : h - 1], 2, par[:, None, :].expand(B, h - 1, W))
            x = self._embed(h - 1, state.tokens[:, h - 1, :])      # [B, W, D]
            beam_inputs = [
                BeamAttnInputs(
                    k_ctx=ctx_kv[li][0], v_ctx=ctx_kv[li][1], ctx_lens=ctx_lens,
                    k_beam=beam_k[li][:, : h - 1] if h > 1 else None,
                    v_beam=beam_v[li][:, : h - 1] if h > 1 else None,
                    ancestry=A[:, : h - 1] if h > 1 else None,
                    backend=attn_backend)
                for li in range(L)
            ]
            hidden, new_kv = self.decoder(x, train=False, beam_attn=beam_inputs)
            for li in range(L):
                beam_k[li][:, h - 1] = new_kv[li][0]
                beam_v[li][:, h - 1] = new_kv[li][1]
            A[:, h - 1] = ident   # the step-(h-1) KV lives at its own beam slot
            state = propagate(state, self._log_probs(h, hidden))
        return decode_paths(state), state.scores

    # -------------------------------------------------- stepwise decode
    @torch.no_grad()
    def beam_prefill(self, batch: SIDBatch, beam_width: Optional[int] = None,
                     width_pad: Optional[int] = None, logits_processor=None):
        """Prefill + hierarchy-0 expansion at `beam_width`, padded to
        `width_pad` slots (extra beams get -inf scores) so pooled decode
        state has one static width.

        Returns a carry dict:
          scores [B, Wm], tokens [B, H, Wm], parents [B, H, Wm],
          ctx_k/ctx_v [L, B, N0, nH, dh], ctx_lens [B],
          beam_k/beam_v [L, B, H-1, Wm, nH, dh], anc [B, H-1, Wm],
          kv_parents [B, Wm].
        """
        batch = batch.to(self.device)
        cfg = self.config
        W = beam_width or cfg.beam_width
        Wm = width_pad or W
        if Wm < W:
            raise ValueError(f"width_pad {Wm} is below the beam width {W}")
        H, B, L = cfg.num_hierarchies, batch.batch_size, cfg.num_layers
        state, ctx_kv, ctx_lens = self._prefill(batch, W, logits_processor)

        def pad_w(x, value=0):
            return nn.functional.pad(x, (0, Wm - W), value=value)

        kv_shape = (L, B, H - 1, Wm, cfg.num_heads, cfg.head_dim)
        return {
            "scores": pad_w(state.scores, -torch.inf),
            "tokens": pad_w(state.tokens),
            "parents": pad_w(state.parents),
            "ctx_k": torch.stack([kv[0] for kv in ctx_kv]),
            "ctx_v": torch.stack([kv[1] for kv in ctx_kv]),
            "ctx_lens": ctx_lens,
            "beam_k": torch.zeros(kv_shape, dtype=cfg.dtype, device=self.device),
            "beam_v": torch.zeros(kv_shape, dtype=cfg.dtype, device=self.device),
            "anc": torch.zeros((B, H - 1, Wm), dtype=torch.int64, device=self.device),
            # parent map for the NEXT step's ancestry re-root. Differs from
            # `parents` (the search tree used by decode_paths) after a KV
            # compaction, which moves survivor w's KV to slot w.
            "kv_parents": pad_w(state.parents[:, 0]),
        }

    @torch.no_grad()
    def beam_step(self, carry, h: int, width_in: int, width_out: int,
                  attn_backend: str = "auto", logits_processor=None):
        """One hierarchy step h (1..H-1) at beam width `width_in`, narrowing
        to `width_out` survivors (the width schedule must be non-increasing).
        On a width change the beam KV is compacted to survivor order, so
        later steps run square at the new width. Carry tensors keep their
        padded Wm slots; dead slots hold -inf scores. Returns a new carry:
        the input's tensors are not written."""
        if width_out > width_in:
            raise ValueError("the beam width schedule must be non-increasing")
        cfg = self.config
        H, L, W = cfg.num_hierarchies, cfg.num_layers, width_in
        B = carry["scores"].shape[0]
        dev = carry["scores"].device
        out = dict(carry)
        for name in ("scores", "tokens", "parents", "anc", "beam_k", "beam_v",
                     "kv_parents"):
            out[name] = carry[name].clone()
        # views of the new carry's first W slots, written in place below
        scores = out["scores"][:, :W]
        tokens, parents = out["tokens"][:, :, :W], out["parents"][:, :, :W]
        A = out["anc"][:, :, :W]
        beam_k, beam_v = out["beam_k"][:, :, :, :W], out["beam_v"][:, :, :, :W]
        ident = torch.arange(W, device=dev)

        if h > 1:
            par = carry["kv_parents"][:, :W]
            A[:, : h - 1] = torch.gather(
                A[:, : h - 1], 2, par[:, None, :].expand(B, h - 1, W))
        x = self._embed(h - 1, tokens[:, h - 1, :])
        beam_inputs = [
            BeamAttnInputs(
                k_ctx=carry["ctx_k"][li], v_ctx=carry["ctx_v"][li],
                ctx_lens=carry["ctx_lens"],
                k_beam=beam_k[li][:, : h - 1] if h > 1 else None,
                v_beam=beam_v[li][:, : h - 1] if h > 1 else None,
                ancestry=A[:, : h - 1] if h > 1 else None,
                backend=attn_backend)
            for li in range(L)
        ]
        hidden, new_kv = self.decoder(x, train=False, beam_attn=beam_inputs)
        for li in range(L):
            beam_k[li, :, h - 1] = new_kv[li][0]
            beam_v[li, :, h - 1] = new_kv[li][1]
        A[:, h - 1] = ident
        logp = self._log_probs(h, hidden)
        if logits_processor is not None:
            # decode each live beam's h-token prefix through the search tree
            # for prefix-conditioned processors (constraint tries). The walk
            # runs over all Wm slots: after a narrowing step a parent index
            # names a slot of the wider step before it
            prefix = decode_paths(BeamState(
                out["scores"], out["tokens"], out["parents"], step=h))[:, :W, :h]
            logp = logits_processor(h, logp, prefix)
        # propagate with the top width_out over (W x C)
        C = logp.shape[-1]
        total = scores[:, :, None] + logp
        top_scores, top_idx = top_k_stable(total.reshape(B, W * C), width_out)
        pad = (0, W - width_out)
        parent = nn.functional.pad(top_idx // C, pad)
        tokens[:, h, :] = nn.functional.pad(top_idx % C, pad)
        parents[:, h, :] = parent
        scores.copy_(nn.functional.pad(top_scores, pad, value=-torch.inf))
        kv_parents = parent

        if width_out < W:
            # compact the beam KV to survivor order: re-root the ancestry
            # through the surviving parents, gather the KV, reset the
            # ancestry to the identity. `parents` (the search tree) is
            # untouched; kv_parents becomes the identity instead.
            A2 = torch.gather(A, 2, parent[:, None, :].expand(B, H - 1, W))
            idx = A2[None, :, :, :, None, None].expand(beam_k.shape)
            beam_k.copy_(torch.gather(beam_k, 3, idx))
            beam_v.copy_(torch.gather(beam_v, 3, idx))
            A.copy_(ident.expand(B, H - 1, W))
            kv_parents = ident.expand(B, W)
        out["kv_parents"][:, :W] = kv_parents
        return out

    def beam_finalize(self, carry, final_width: int):
        """Walk the ancestry to decode full paths. Returns (paths [B, W, H],
        scores [B, W]) at the final width. The walk runs over all Wm slots
        (a parent index may name a slot beyond the final width when the
        schedule narrowed); the JAX package walks the first W only, which
        agrees whenever every parent on a surviving path is below W."""
        W = final_width
        state = BeamState(carry["scores"], carry["tokens"], carry["parents"],
                          step=self.config.num_hierarchies)
        return decode_paths(state)[:, :W], state.scores[:, :W]
