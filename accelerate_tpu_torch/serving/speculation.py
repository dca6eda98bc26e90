"""Speculative decoding: more than one token a slot per decode step.

Port of ``accelerate_tpu/serving/speculation.py``: ``SpecConfig`` (:47),
``NGramProposer`` (:95-155, host-only, copied) and ``DraftModelProposer``
(:157-390). A proposer guesses ``k`` tokens a slot; the engine scores the
pending token and every guess in one target pass at ``(max_slots, k + 1)``
(the verify step) and commits the longest prefix the target agrees with.
The verify pass samples the target at every position with the draws plain
decode would use, so the emitted stream is the plain engine's at any
temperature; a bad proposer only lowers ``accept_rate``.

* :class:`NGramProposer`: prompt lookup. It scans the slot's own prompt
  and output for the latest earlier occurrence of its trailing n-gram and
  proposes what followed. Host work only.
* :class:`DraftModelProposer`: a small draft ``CausalLM`` with its own
  per-layer pools of the engine's ``num_blocks`` and ``block_size``, so one
  block id addresses both caches and the engine's tables serve both. It
  runs ``k`` greedy steps a round; its step (ingest up to two tokens, or
  one) is one ``utils/cuda_graph.StepProgram`` at ``(max_slots, 2)`` built
  once, where the reference traces two shapes. Draft KV of rejected
  positions is overwritten by the next round's position-addressed writes.

The draft model's parameters live in the module, so the reference's
``draft_params`` has no counterpart.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..models.generation import init_cache
from ..ops.attention import PagedKVState
from ..utils.cuda_graph import StepProgram

__all__ = ["SpecConfig", "NGramProposer", "DraftModelProposer"]


def _bucket(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length() if n > 1 else 1


@dataclass(eq=False)
class SpecConfig:
    """Speculation knobs for :class:`~.engine.ServingEngine`.

    ``k`` is the draft length of a verify round (``k = 0`` turns
    speculation off: the plain decode step runs). ``method``: ``"ngram"``
    (prompt lookup) or ``"draft_model"`` (needs ``draft_model``, a
    ``CausalLM`` with the target's vocabulary, on the target's device).
    ``eq=False`` on purpose: configs hash by identity, and the engine keeps
    one warm proposer per config instance, so toggling builds nothing
    new."""

    k: int = 4
    method: str = "ngram"
    # n-gram proposer: longest and shortest trailing n-gram searched for
    max_ngram: int = 3
    min_ngram: int = 1
    draft_model: Any = None

    def __post_init__(self):
        if self.k < 0:
            raise ValueError("k must be >= 0 (0 disables speculation)")
        if self.method not in ("ngram", "draft_model"):
            raise ValueError(f"method must be 'ngram' or 'draft_model', got {self.method!r}")
        if self.method == "draft_model" and self.k > 0 and self.draft_model is None:
            raise ValueError("method='draft_model' requires draft_model")
        if not 1 <= self.min_ngram <= self.max_ngram:
            raise ValueError("need 1 <= min_ngram <= max_ngram")


class NGramProposer:
    """Draft-free prompt-lookup speculation. ``propose`` looks, for each
    slot, for the latest earlier occurrence of its trailing n-gram (longest
    ``n`` first, down to ``min_ngram``) in its prompt and output, the
    pending token included, and proposes up to ``k`` tokens that followed
    it."""

    def __init__(self, cfg: SpecConfig):
        self.cfg = cfg
        self.misses = 0  # lookups that found no n-gram

    def lookup(self, context: list[int], k: int) -> list[int]:
        """The proposed continuation of ``context`` (possibly empty)."""
        if k <= 0 or len(context) < self.cfg.min_ngram + 1:
            return []
        arr = np.asarray(context, dtype=np.int64)
        for n in range(min(self.cfg.max_ngram, len(arr) - 1), self.cfg.min_ngram - 1, -1):
            pattern = arr[-n:]
            # windows end before the last position, so a follow token exists
            windows = np.lib.stride_tricks.sliding_window_view(arr[:-1], n)
            hits = np.flatnonzero((windows == pattern).all(axis=1))
            if hits.size:
                start = int(hits[-1]) + n  # the latest occurrence wins
                follow = arr[start:start + k]
                if follow.size:
                    return [int(t) for t in follow]
        self.misses += 1
        return []

    def propose(self, slots) -> dict[int, list[int]]:
        return {slot.index: self.lookup(slot.request.prompt + slot.generated,
                                        min(self.cfg.k, slot.lookahead))
                for slot in slots}

    # stateless: the engine's hooks are no-ops (the interface is the draft
    # proposer's, which keeps per-slot cache state)
    def prefill_slot(self, slot) -> None:
        pass

    def commit(self, slot) -> None:
        pass

    def release(self, slot_index: int) -> None:
        pass

    def cow(self, donor: int, private: int) -> None:
        pass

    def trace_counts(self) -> dict:
        return {}


class DraftModelProposer:
    """A small draft ``CausalLM`` proposing greedily through its own paged
    pools, addressed by the engine's block tables (``tables``: the engine's
    device table buffer, which the draft step reads in place).

    Per slot, between rounds, the draft has written KV for ``draft_len``
    positions with ``slot.cache_len - 1 <= draft_len <= slot.cache_len``:
    the whole prompt at admission (:meth:`prefill_slot`), then each round
    ingests the one or two committed tokens it has not seen (two only
    after a round that accepted everything) and rolls ``k - 1`` greedy
    steps forward. A slot that fell further behind (speculation toggled
    off while it ran) is caught up by one bucketed prefill of the gap."""

    def __init__(self, cfg: SpecConfig, *, target_config, num_blocks: int, block_size: int,
                 max_slots: int, tables: torch.Tensor):
        self.cfg = cfg
        self.model = cfg.draft_model
        dcfg = self.model.config
        if dcfg.vocab_size != target_config.vocab_size:
            raise ValueError(
                f"draft vocab ({dcfg.vocab_size}) must match the target's "
                f"({target_config.vocab_size}): proposals are target ids")
        if dcfg.max_seq_len < target_config.max_seq_len:
            raise ValueError(
                f"draft max_seq_len ({dcfg.max_seq_len}) must cover the target's "
                f"({target_config.max_seq_len})")
        self.device = self.model.embed.weight.device
        if self.device != tables.device:
            raise ValueError(f"the draft model is on {self.device}, the engine on "
                             f"{tables.device}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.max_slots = max_slots
        self._tables = tables
        self.cache = init_cache(self.model, num_blocks=num_blocks, block_size=block_size)
        # tokens of draft KV written a slot, and the slot's cache_len at the
        # latest propose (commit derives the new draft_len from it)
        self._draft_len = np.zeros(max_slots, np.int64)
        self._base = np.zeros(max_slots, np.int64)
        self._prefill_buckets: set[int] = set()
        self._step_in = {
            "tokens": torch.zeros((max_slots, 2), dtype=torch.long, device=self.device),
            "cache_lens": torch.zeros(max_slots, dtype=torch.long, device=self.device),
            "lengths": torch.zeros(max_slots, dtype=torch.long, device=self.device),
        }
        self._step_program = None

    def _state(self, table, cache_len, lengths) -> PagedKVState:
        return PagedKVState(block_table=table, cache_len=cache_len, lengths=lengths,
                            num_blocks=self.num_blocks, block_size=self.block_size)

    def _step_forward(self) -> torch.Tensor:
        """One draft step over the static buffers: the greedy token after
        each slot's last valid position, (max_slots,). A row of length 0
        writes only the garbage block, and its output is ignored."""
        buf = self._step_in
        logits = self.model(buf["tokens"], decode=True, cache=self.cache,
                            paged=self._state(self._tables, buf["cache_lens"], buf["lengths"]))
        last = (buf["lengths"] - 1).clamp_min(0)
        rows = logits.gather(1, last[:, None, None].expand(-1, 1, logits.shape[-1]))[:, 0]
        return torch.argmax(rows, dim=-1)

    def _prefill(self, slot, tokens: list[int], start: int) -> None:
        """Write ``tokens`` at positions ``start``... of the slot's draft KV
        by one eager call at the power-of-two bucket of their count."""
        n = len(tokens)
        bucket = _bucket(n)
        self._prefill_buckets.add(bucket)
        ids = torch.zeros((1, bucket), dtype=torch.long)
        ids[0, :n] = torch.as_tensor(tokens)
        table = torch.zeros((1, self._tables.shape[1]), dtype=torch.long)
        table[0, :len(slot.blocks)] = torch.as_tensor(slot.blocks)
        dev = self.device
        self.model(ids.to(dev), decode=True, cache=self.cache,
                   paged=self._state(table.to(dev), torch.full((1,), start, device=dev),
                                     torch.full((1,), n, device=dev)))

    # ------------------------------------------------------------------ #
    # engine hooks
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def prefill_slot(self, slot) -> None:
        """Prefill the slot's whole prompt into the draft pools. Cached
        prefix blocks are written again on purpose: their draft rows may
        predate this proposer, and the same content harms no holder."""
        self._prefill(slot, slot.request.prompt, 0)
        self._draft_len[slot.index] = len(slot.request.prompt)

    @torch.no_grad()
    def propose(self, slots) -> dict[int, list[int]]:
        """``k`` greedy draft tokens a slot (fewer where its lookahead is
        clamped): one ingest step, then ``k - 1`` one-token steps, each a
        replay of the draft step whose input token is the previous step's
        output, copied on the device; the host reads the drafts once."""
        B, k = self.max_slots, self.cfg.k
        if self._step_program is None:  # built while every row is empty
            self._step_program = StepProgram(self._step_forward, self.device)
        budget = {s.index: min(k, s.lookahead) for s in slots}
        ingest = np.zeros((B, 2), np.int64)
        lens = np.zeros(B, np.int64)
        clens = np.zeros(B, np.int64)
        for slot in slots:
            full = slot.request.prompt + slot.generated
            dl = int(self._draft_len[slot.index])
            if slot.cache_len + 1 - dl > 2:  # the slot ran on without us
                self._prefill(slot, full[dl:slot.cache_len], dl)
                self._draft_len[slot.index] = dl = slot.cache_len
            lag = slot.cache_len + 1 - dl  # 1, or 2 after a full accept
            if not 1 <= lag <= 2:
                raise RuntimeError(f"draft cache of slot {slot.index} lags by {lag}")
            ingest[slot.index, :lag] = full[dl:dl + lag]
            lens[slot.index] = lag
            clens[slot.index] = dl
            self._base[slot.index] = slot.cache_len
        buf = self._step_in
        buf["tokens"].copy_(torch.from_numpy(ingest))
        buf["lengths"].copy_(torch.from_numpy(lens))
        buf["cache_lens"].copy_(torch.from_numpy(clens))
        outs = [self._step_program().clone()]
        base = np.asarray(self._base)
        for r in range(1, k):
            live = np.zeros(B, np.int64)
            for slot in slots:
                live[slot.index] = budget[slot.index] > r
            if not live.any():
                break
            # a slot whose budget is spent stops: its writes would run past
            # the reserved blocks
            buf["tokens"][:, 0].copy_(outs[-1])
            buf["lengths"].copy_(torch.from_numpy(live))
            buf["cache_lens"].copy_(torch.from_numpy(base + r))
            outs.append(self._step_program().clone())
        tok = torch.stack(outs, dim=1).cpu().numpy()
        return {s.index: [int(t) for t in tok[s.index, :budget[s.index]]]
                for s in slots if budget[s.index] > 0}

    def commit(self, slot) -> None:
        """After the engine committed a round (``slot.cache_len`` already
        advanced): the draft's valid prefix is what it wrote that the
        commit confirmed."""
        self._draft_len[slot.index] = min(slot.cache_len, int(self._base[slot.index]) + self.cfg.k)

    def release(self, slot_index: int) -> None:
        self._draft_len[slot_index] = 0

    def cow(self, donor: int, private: int) -> None:
        """Mirror the engine's copy-on-write into the draft pools, in place
        (the draft step's graph reads them where they are)."""
        for pool in (self.cache.key, self.cache.value):
            pool[:, private].copy_(pool[:, donor])

    def trace_counts(self) -> dict:
        return {"draft_prefill": len(self._prefill_buckets),
                "draft_step": int(self._step_program is not None)}
