"""Dynamic embedding table: train/eval lookup, admission, scores, sparse
backward (counterpart of recsys_examples_tpu/dynamicemb/batched_table.py).

Train forward: unique keys -> (admission filter) -> init misses ->
insert_and_evict -> gather rows -> embeddings. Backward: the caller reduces
token grads to the unique rows; the sparse optimizer updates them.

The state's tensors are updated in place and every method returns the state
object it was given (see `hashtable.py`); nothing records autograd history.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from recsys_examples_torch.dynamicemb.dynamicemb_config import (
    EMPTY_KEY,
    DynamicEmbScoreStrategy,
    DynamicEmbTableOptions,
)
from recsys_examples_torch.dynamicemb.hashtable import (
    HashTableState,
    add_scores,
    create_table_state,
    insert_and_evict,
    lookup,
    owns_slot,
    update_scores,
)
from recsys_examples_torch.dynamicemb.initializer import initialize_embeddings
from recsys_examples_torch.dynamicemb.optimizer import (
    SparseOptimizerArgs,
    initial_opt_row,
    opt_dim_for,
    sparse_update,
    value_dim_for,
)


@dataclasses.dataclass
class DynamicEmbTableState:
    table: HashTableState
    counter: Optional[HashTableState]  # admission frequency counter
    step: torch.Tensor                 # [1] int64 monotonic score clock


class DynamicEmbeddingTable:
    """Static config + ops for one dynamic table shard."""

    def __init__(
        self,
        options: DynamicEmbTableOptions,
        opt_args: SparseOptimizerArgs,
        world_size: int = 1,
    ):
        self.options = options
        self.opt_args = opt_args
        self.dim = options.embedding_dim
        self.opt_dim = opt_dim_for(opt_args.optimizer, self.dim)
        # total floats per row (memory accounting)
        self.value_dim = value_dim_for(opt_args.optimizer, self.dim)
        self.capacity = options.sharded_capacity(world_size)

    # ------------------------------------------------------------ state
    def init_state(self, device="cuda") -> DynamicEmbTableState:
        """An empty table on `device` (CUDA unless the caller says "cpu")."""
        opts = self.options
        table = create_table_state(
            self.capacity, opts.bucket_capacity, self.dim, opts.value_dtype,
            opt_dim=self.opt_dim, device=device)
        counter = None
        if opts.admission_threshold > 0:
            # counter table: scores hold frequencies, 1-wide dummy values
            counter = create_table_state(
                self.capacity, opts.bucket_capacity, 1, torch.float32, device=device)
        return DynamicEmbTableState(
            table=table, counter=counter,
            step=torch.zeros((1,), dtype=torch.int64, device=table.keys.device))

    # ------------------------------------------------------------ scores
    def _scores(self, state: DynamicEmbTableState, n: int) -> torch.Tensor:
        strat = self.options.score_strategy
        if strat in (DynamicEmbScoreStrategy.TIMESTAMP, DynamicEmbScoreStrategy.STEP):
            return (state.step + 1).expand(n)
        if strat == DynamicEmbScoreStrategy.LFU:
            # counts accumulate via add_scores after insert; seed at 0
            return torch.zeros((n,), dtype=torch.int64, device=state.step.device)
        raise ValueError("CUSTOM scores must be passed explicitly")

    # ------------------------------------------------------------ forward
    @torch.no_grad()
    def forward_train(
        self,
        state: DynamicEmbTableState,
        unique_keys: torch.Tensor,        # [u] int64, EMPTY_KEY padded
        custom_scores: Optional[torch.Tensor] = None,
        frequencies: Optional[torch.Tensor] = None,  # [u] per-batch counts
    ) -> Tuple[DynamicEmbTableState, torch.Tensor, torch.Tensor]:
        """Returns (state, slots [u], unique_embeddings [u, dim]).

        Misses are initialized and inserted (evicting if needed); keys
        failing admission, and keys stored and evicted again within this
        call (their slot is stale), get transient init embeddings and are
        NOT stored.
        """
        opts = self.options
        u = unique_keys.shape[0]
        dev = unique_keys.device
        active = unique_keys != EMPTY_KEY
        scores = (custom_scores.to(torch.int64) if custom_scores is not None
                  else self._scores(state, u))
        freq = (frequencies.to(torch.int64) if frequencies is not None
                else torch.ones((u,), dtype=torch.int64, device=dev))

        # admission: bump counters for missed keys; admit if freq >= thresh
        insert_keys = unique_keys
        if state.counter is not None:
            _, found = lookup(state.table, unique_keys)
            miss_keys = torch.where(found, EMPTY_KEY, unique_keys)
            counter, cslots, _ = insert_and_evict(
                state.counter, miss_keys, torch.zeros_like(scores), None,
                rounds=opts.insert_rounds)
            add_scores(counter, cslots, freq)
            counts = counter.scores.view(-1)[cslots.clamp(0, counter.capacity - 1)]
            admitted = found | ((cslots >= 0) & (counts >= opts.admission_threshold))
            insert_keys = torch.where(admitted, unique_keys, EMPTY_KEY)

        init_emb = initialize_embeddings(
            unique_keys, self.dim, opts.initializer_args, opts.value_dtype)
        init_opt = initial_opt_row(
            self.opt_args.optimizer, u, self.dim, self.opt_args, opts.value_dtype, dev)
        # only misses insert new rows; hits refresh scores
        table, slots, _ = insert_and_evict(
            state.table, insert_keys, scores, init_emb, init_opt,
            update_existing_values=False, rounds=opts.insert_rounds)
        if opts.score_strategy == DynamicEmbScoreStrategy.LFU:
            add_scores(table, slots, freq)

        emb = table.values[slots.clamp(0, table.capacity - 1)]
        emb = torch.where(owns_slot(table, unique_keys, slots)[:, None], emb, init_emb)
        emb = torch.where(active[:, None], emb, emb.new_zeros(()))
        state.step += 1
        return state, slots, emb

    @torch.no_grad()
    def forward_eval(self, state: DynamicEmbTableState,
                     unique_keys: torch.Tensor) -> torch.Tensor:
        """Eval lookup: missing keys get the eval initializer (zeros by
        default), nothing is inserted."""
        slots, found = lookup(state.table, unique_keys)
        emb = state.table.values[slots.clamp(0, state.table.capacity - 1)]
        miss_emb = initialize_embeddings(
            unique_keys, self.dim, self.options.eval_initializer_args,
            self.options.value_dtype)
        emb = torch.where(found[:, None], emb, miss_emb)
        return torch.where((unique_keys != EMPTY_KEY)[:, None], emb, emb.new_zeros(()))

    # ------------------------------------------------------------ backward
    @torch.no_grad()
    def backward(
        self,
        state: DynamicEmbTableState,
        slots: torch.Tensor,
        grads: torch.Tensor,   # [u, dim]
        step: Optional[torch.Tensor] = None,
        keys: Optional[torch.Tensor] = None,   # [u] the keys of `slots`
    ) -> DynamicEmbTableState:
        """The valid slots must address distinct rows. With `keys`, lanes
        whose slot is stale (see `forward_train`) are skipped, which makes
        them so."""
        if keys is not None:
            slots = torch.where(owns_slot(state.table, keys, slots), slots, -1)
        sparse_update(state.table, slots, grads, self.opt_args,
                      step if step is not None else state.step[0])
        return state

    # ------------------------------------------------------------ scores API
    @torch.no_grad()
    def get_score(self, state: DynamicEmbTableState, keys: torch.Tensor) -> torch.Tensor:
        """Per-key scores (-1 for missing)."""
        slots, found = lookup(state.table, keys)
        sc = state.table.scores.view(-1)[slots.clamp(0, state.table.capacity - 1)]
        return torch.where(found, sc, -1)

    @torch.no_grad()
    def set_score(self, state: DynamicEmbTableState, keys: torch.Tensor,
                  scores: torch.Tensor) -> DynamicEmbTableState:
        """Overwrite scores of present keys."""
        slots, _ = lookup(state.table, keys)
        update_scores(state.table, slots, scores)
        return state

    # ------------------------------------------------------------ bulk ops
    @torch.no_grad()
    def fill(
        self,
        state: DynamicEmbTableState,
        keys: torch.Tensor,
        values: torch.Tensor,
        scores: Optional[torch.Tensor] = None,
    ) -> DynamicEmbTableState:
        """Bulk insert (checkpoint load). Callers may pass duplicate keys:
        only the LAST occurrence of each key is kept (dict semantics), the
        earlier ones are masked to EMPTY_KEY."""
        u = keys.shape[0]
        keys = keys.to(torch.int64)
        ks, order = torch.sort(keys, stable=True)
        is_last = torch.ones((u,), dtype=torch.bool, device=keys.device)
        is_last[:-1] = ks[:-1] != ks[1:]
        keep = torch.empty_like(is_last)
        keep[order] = is_last
        keys = torch.where(keep, keys, EMPTY_KEY)
        if scores is None:
            scores = (state.step + 1).expand(u)
        init_opt = initial_opt_row(
            self.opt_args.optimizer, u, self.dim, self.opt_args,
            self.options.value_dtype, keys.device)
        insert_and_evict(
            state.table, keys, scores, values.to(self.options.value_dtype), init_opt,
            update_existing_values=True, rounds=self.options.insert_rounds)
        return state

    @torch.no_grad()
    def expand(self, state: DynamicEmbTableState, factor: int = 2
               ) -> Tuple["DynamicEmbeddingTable", DynamicEmbTableState]:
        """Grow the table by `factor` and rehash all live entries into a new
        state (one batched pass); the old state is left as it was."""
        new_table = DynamicEmbeddingTable(
            dataclasses.replace(self.options, max_capacity=self.capacity * factor),
            self.opt_args)
        old = state.table
        new_state = new_table.init_state(old.keys.device)
        nt, _, _ = insert_and_evict(
            new_state.table, old.keys.reshape(-1), old.scores.reshape(-1),
            old.values, old.opt, update_existing_values=True,
            rounds=self.options.insert_rounds)
        nt.inserted, nt.evicted, nt.overflowed = (
            old.inserted.clone(), old.evicted.clone(), old.overflowed.clone())
        new_state.step = state.step.clone()
        return new_table, new_state
