"""End-to-end HSTU ranking inference with a user-keyed KV cache (counterpart
of recsys_examples_tpu/inference/inference_ranking_gr.py):
  kv lookup -> allocate -> strip cached tokens -> embedding lookup for the
  new tokens -> dense forward over cached + new KV -> append new KV ->
  candidate scores.

Works on the padded dense per-user layout [B, S, ...]. PyTorch runs eagerly,
so there is no per-bucket compiled step.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from recsys_examples_torch.dynamicemb.exportable_tables import (
    InferenceTableState,
    inference_lookup,
)
from recsys_examples_torch.inference.hstu_inference import (
    HSTUBlockInference,
    strip_cached_tokens,
)
from recsys_examples_torch.inference.kvcache import (
    KVCacheConfig,
    allocate_kvcache,
    append_kvcache,
    create_kvcache,
    gather_kvcache,
    lookup_kvcache,
)
from recsys_examples_torch.modules.config import HSTUConfig
from recsys_examples_torch.modules.mlp import MLP
from recsys_examples_torch.utils.device import resolve_device


class InferenceDenseModule(nn.Module):
    """HSTU inference block + prediction head (`hstu_block`, `head`, as the
    flax tree names them)."""

    def __init__(self, config: HSTUConfig, head_arch: Sequence[int] = (512, 1),
                 device=None):
        super().__init__()
        self.config = config
        self.hstu_block = HSTUBlockInference(config, device)
        self.head = MLP(config.hidden_size, head_arch, dtype=config.dtype,
                        device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "InferenceDenseModule":
        """Random weights from a seeded generator: matrices ~ N(0, 1/fan_in),
        layer-norm scales 1, biases 0."""
        for name, p in self.named_parameters():
            if p.dim() == 1 or name.endswith("uvqk_bias"):
                p.fill_(1.0 if name.endswith("scale") else 0.0)
                continue
            fan_in = p.shape[0] if name.endswith("uvqk_kernel") else p.shape[1]
            w = torch.randn(p.shape, generator=generator, device="cpu")
            p.copy_(w * fan_in ** -0.5)
        return self

    def forward(
        self, x, cached_k, cached_v, cached_len, new_lens, num_targets,
        scaling_seqlen, paged=None,
    ):
        out, ks, vs = self.hstu_block(
            x, cached_k, cached_v, cached_len, new_lens, num_targets,
            scaling_seqlen, paged=paged,
        )
        # L2 normalize in fp32, then the head
        v32 = out.float()
        norm = torch.sqrt((v32 * v32).sum(-1, keepdim=True) + 1e-12)
        logits = self.head((v32 / norm).to(self.config.dtype))
        return logits.float(), ks, vs


class InferenceRankingGR:
    """Stateful wrapper: dense module + frozen item table + KV cache, all on
    one device (CUDA unless the caller passes `device="cpu"`)."""

    def __init__(
        self,
        config: HSTUConfig,
        kv_config: KVCacheConfig,
        dense: InferenceDenseModule,
        item_table: InferenceTableState,
        device: Union[str, torch.device, None] = "cuda",
    ):
        self.device = resolve_device(device)
        self.config = config
        self.kv_config = kv_config
        self.module = dense.to(self.device).eval()
        self.item_table = InferenceTableState(
            keys=item_table.keys.to(self.device),
            values=item_table.values.to(self.device),
        )
        self.kv_state = None

    def init_cache(self):
        self.kv_state = create_kvcache(self.kv_config, self.device)

    def _tensor(self, x, dtype):
        return None if x is None else torch.as_tensor(
            x, dtype=dtype, device=self.device
        )

    @torch.no_grad()
    def forward_with_kvcache(
        self,
        user_ids,               # [B] int64
        item_ids,               # [B, S_full] full sequences (hist + cand)
        lengths,                # [B]
        num_candidates,         # [B] or None
        max_new: int,
        use_paged_kernel: Optional[bool] = None,
    ):
        """Returns (logits [B, max_new, num_tasks] fp32, new_lens [B]).

        The paged path (default) reads cached K/V straight from the page
        pool: through the CUDA kernel on the card, through its plain version
        on the CPU. `use_paged_kernel=False` takes the dense gather path.
        """
        if use_paged_kernel is None:
            use_paged_kernel = True
        cfg = self.kv_config
        user_ids = self._tensor(user_ids, torch.int64)
        item_ids = self._tensor(item_ids, torch.int64)
        lengths = self._tensor(lengths, torch.int32)
        num_candidates = self._tensor(num_candidates, torch.int32)
        kv = self.kv_state
        B = user_ids.shape[0]

        slots, cached = lookup_kvcache(kv, user_ids)
        # only history can be cached; candidates always recompute
        hist_len = lengths - (num_candidates if num_candidates is not None else 0)
        cached = torch.minimum(cached, hist_len)
        kv, slots = allocate_kvcache(kv, cfg, user_ids, hist_len)
        new_ids, new_lens = strip_cached_tokens(
            item_ids[..., None], lengths, cached, max_new
        )
        emb = inference_lookup(self.item_table, new_ids.reshape(-1))
        emb = emb.reshape(B, max_new, -1).to(self.config.dtype)
        scaling = (
            self.config.scaling_seqlen
            if self.config.scaling_seqlen > 0 else cfg.max_cached_len
        )
        live = slots >= 0
        sl = slots.clamp_min(0)
        if use_paged_kernel:
            page_table = torch.where(live[:, None], kv.user_pages[sl], -1)
            clen = torch.minimum(torch.where(live, kv.user_len[sl], 0), cached)
            logits, ks, vs = self.module(
                emb, None, None, clen.to(torch.int32), new_lens,
                num_candidates, scaling,
                paged=(kv.k_pages, kv.v_pages, page_table.contiguous()),
            )
        else:
            ck, cv, clen = gather_kvcache(kv, cfg, slots, cfg.max_cached_len)
            clen = torch.minimum(clen, cached)
            logits, ks, vs = self.module(
                emb, ck, cv, clen.to(torch.int32), new_lens, num_candidates,
                scaling,
            )
        # append only the non-candidate new tokens to the cache
        keep = (new_lens - (
            num_candidates if num_candidates is not None else 0
        )).clamp_min(0)
        self.kv_state = append_kvcache(kv, cfg, slots, ks, vs, keep)
        return logits, new_lens
