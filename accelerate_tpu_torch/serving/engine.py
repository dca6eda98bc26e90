"""The step-level serving engine: continuous batching over a paged KV cache.

Port of ``accelerate_tpu/serving/engine.py:ServingEngine`` (:93):
``add_request`` (:511), ``step`` (:605-692), ``_cow_block`` (:783),
``_prefill_slot`` (:816-880), ``_decode_step`` (:1493), ``_spec_step``
(:1523-1611), ``_note_token``, ``_finish`` (:1625), ``_shed`` (:1680),
the observability plane (``_tele``, ``_gauge_fields`` :1714,
``_sample_gauges``, ``_emit_slo``), the runtime toggles
``set_observability`` (:2036), ``set_prefix_cache`` (:2064) and
``set_speculation`` (:2086), ``stream``, ``generate`` (:700), ``result``,
``shed_reason``, ``trace_counts`` (:578), ``summary`` (:2204),
``kv_bytes_per_token`` and the injectable clock. ``step`` retires finished
slots, admits and prefills queued requests into the empty seats, then runs
one decode (or speculative) step over the whole slot batch.

Three kinds of program do the device work, as in the reference:

* one decode step at the fixed ``(max_slots, 1)`` shape, built once: on a
  CUDA device the model's decode forward and its paged KV writes are
  captured as one CUDA graph over static buffers (tokens, block tables,
  cache lengths, valid lengths), and every step copies the host values
  into those buffers and replays it; sampling runs after the replay, on
  the graph's logits, with the engine's generator. On the CPU the same
  step runs eager. Request churn is data in the buffers, so it never
  rebuilds the step;
* with speculation on, one verify step at ``(max_slots, k + 1)`` a width,
  built once, over the same table and length buffers (and, for a draft
  model, its own step over the same table buffer);
* prefill, eager, one call per request at the power-of-two bucket of the
  part of its prompt not in the prefix cache, written at that offset.

Every graph reads the KV pools and the table buffer where they are, so a
copy-on-write copies a block inside every layer's pools in place and a
table change is copied into the one buffer before the next replay.

``trace_counts()`` counts builds: ``decode`` is 1 after the first decode
step and stays there; ``verify`` is one a width used; ``prefill`` is the
number of distinct buckets; a draft proposer adds ``draft_prefill`` and
``draft_step``.

The reference's options for paths not ported yet raise
NotImplementedError naming ROADMAP.md's queue A9; none is ignored. The
model's parameters live in the module, so the reference's ``params``
argument has no counterpart.
"""

from __future__ import annotations

import collections
import hashlib
import time
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from ..models.generation import init_cache
from ..ops.attention import PagedKVState
from ..utils.cuda_graph import StepProgram
from .block_pool import BlockPool, PrefixCache
from .sampling import SlotSampling, sample_tokens
from .scheduler import ContinuousScheduler, Request, Slot
from .slo import SLOConfig, SloTracker
from .spans import SpanLog, write_chrome_trace
from .speculation import DraftModelProposer, NGramProposer, SpecConfig
from .telemetry import ServeStats


@dataclass(frozen=True)
class TokenEvent:
    """One generated token, as ``step``/``stream`` report it."""

    request_id: str
    token: int
    done: bool


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length() if n > 1 else 1


def _not_ported(option: str) -> NotImplementedError:
    return NotImplementedError(
        f"ServingEngine({option}) is not ported yet (ROADMAP.md, queue A9)")


class ServingEngine:
    """Continuous-batching serving over a paged KV cache, on the model's
    device.

    ``num_blocks`` defaults to a pool that holds ``max_slots`` full
    ``max_seq_len`` sequences plus the garbage block; a request needs
    ``ceil((prompt_len + max_new_tokens) / block_size)`` blocks while in
    flight. ``now`` is injectable for exact latency tests.
    ``max_queue``/``max_queue_delay_s`` bound the queue (sheds are counted
    and have a reason); ``max_retained_results`` bounds the finished
    generations kept for :meth:`result`.

    ``prefix_cache``: share the KV of cached prompt prefixes between
    requests (``model_fingerprint`` scopes the keys; by default a hash of
    the model's config). ``spec_decode``: a :class:`SpecConfig`.
    Observability: ``telemetry`` (a :class:`~..telemetry.StepTelemetry`)
    receives ``serve``, ``span`` and ``shed`` records, a ``serve_gauge``
    record every ``gauge_interval`` steps (0: none) and, with ``slo`` (an
    :class:`SLOConfig`), ``slo`` records on its cadence. All three can be
    toggled on a warm engine without building anything.
    """

    def __init__(self, model, *, max_slots: int = 4, block_size: int = 16,
                 num_blocks: Optional[int] = None, top_k: Optional[int] = None,
                 top_p: Optional[float] = None, telemetry: Any = None, seed: int = 0,
                 now: Callable[[], float] = time.monotonic,
                 max_queue: Optional[int] = None, max_queue_delay_s: Optional[float] = None,
                 slo: Optional[SLOConfig] = None, gauge_interval: int = 1,
                 span_history: int = 512, max_retained_results: Optional[int] = 4096,
                 adapters=None, prefix_cache: bool = False,
                 model_fingerprint: Optional[str] = None,
                 spec_decode: Optional[SpecConfig] = None,
                 prefill_chunk_tokens: Optional[int] = None, preemption: bool = False,
                 kv_dtype: str = "bf16", role: str = "colocated", transfer_plane=None):
        refused = [
            ("adapters=...", adapters is not None),
            ("prefill_chunk_tokens=...", prefill_chunk_tokens is not None),
            ("preemption=True", preemption), (f"role={role!r}", role != "colocated"),
            ("transfer_plane=...", transfer_plane is not None),
            ("kv_dtype='int8'", kv_dtype == "int8"),
        ]
        for option, asked in refused:
            if asked:
                raise _not_ported(option)
        if kv_dtype != "bf16":  # the reference's name for the native compute dtype
            raise ValueError(f"kv_dtype must be 'bf16' (native) or 'int8', got {kv_dtype!r}")
        if max_retained_results is not None and max_retained_results < 1:
            raise ValueError("max_retained_results must be >= 1 (or None)")
        if gauge_interval < 0:
            raise ValueError("gauge_interval must be >= 0 (0 disables)")
        self.model = model
        self.device = model.embed.weight.device
        self.max_slots = max_slots
        self.block_size = block_size
        self.top_k, self.top_p = top_k, top_p
        cfg = model.config
        self._max_table = -(-cfg.max_seq_len // block_size)
        if num_blocks is None:
            num_blocks = max_slots * self._max_table + 1
        self.num_blocks = num_blocks
        self.pool = BlockPool(num_blocks, block_size)
        self._model_fingerprint = model_fingerprint or hashlib.sha256(
            repr(cfg).encode()).hexdigest()[:16]
        self.prefix_cache: Optional[PrefixCache] = (
            PrefixCache(self.pool, fingerprint=self._model_fingerprint) if prefix_cache else None)
        self.scheduler = ContinuousScheduler(max_slots, self.pool, now=now, max_queue=max_queue,
                                             max_queue_delay_s=max_queue_delay_s,
                                             prefix_cache=self.prefix_cache,
                                             max_table_blocks=self._max_table)
        self.sampling = SlotSampling(max_slots, self.device)
        self.stats = ServeStats()
        self.span_log = SpanLog(maxlen=span_history)
        self.slo_tracker = SloTracker(slo) if slo is not None else None
        self.gauge_interval = gauge_interval
        self.max_retained_results = max_retained_results
        self._telemetry = telemetry
        self._now = now
        self._steps = 0
        self._generator = torch.Generator(self.device).manual_seed(seed)
        self._tables = np.zeros((max_slots, self._max_table), np.int64)
        self._tables_stale = True  # the device copy lags the host tables
        self._results: dict[str, list[int]] = {}
        self._result_order: collections.deque = collections.deque()
        self._shed_reasons: dict[str, str] = {}
        self._shed_order: collections.deque = collections.deque()
        self._prefill_buckets: set[int] = set()
        self._decode_builds = 0
        self.cache = init_cache(model, num_blocks=num_blocks, block_size=block_size)
        # bytes of KV per cached token across every layer's pools
        self.kv_bytes_per_token = self.cache.nbytes / (num_blocks * block_size)
        # the decode and verify steps' static inputs: the graphs read these
        # tensors, so each step copies into them and never rebinds them
        self._decode_in = {
            "tokens": torch.zeros((max_slots, 1), dtype=torch.long, device=self.device),
            "tables": torch.zeros((max_slots, self._max_table), dtype=torch.long,
                                  device=self.device),
            "cache_lens": torch.zeros(max_slots, dtype=torch.long, device=self.device),
            "lengths": torch.zeros(max_slots, dtype=torch.long, device=self.device),
        }
        self._decode_program: Optional[StepProgram] = None
        # speculation: verify programs and their token buffers by width,
        # warm proposers by config instance
        self._verify: dict[int, tuple[torch.Tensor, StepProgram]] = {}
        self._proposers: dict[int, Any] = {}
        self._spec: Optional[SpecConfig] = None
        self._proposer: Any = None
        self._spec_proposed_total = 0
        self._spec_accepted_total = 0
        self._spec_rounds_total = 0
        if spec_decode is not None:
            self.set_speculation(spec_decode)

    # ------------------------------------------------------------------ #
    # request API
    # ------------------------------------------------------------------ #
    def add_request(self, prompt, max_new_tokens: int = 32, temperature: float = 0.0,
                    eos_token_id: Optional[int] = None, request_id: str = "",
                    adapter: Optional[str] = None, priority: int = 0) -> str:
        """Enqueue one request (a sequence of token ids); returns its id. A
        later :meth:`step` admits it as soon as a seat and its whole block
        reservation are free."""
        if adapter is not None:
            raise _not_ported("adapters: add_request(adapter=...)")
        if priority != 0:
            raise _not_ported("priorities and preemption: add_request(priority=...)")
        req = Request(prompt=[int(t) for t in np.asarray(prompt).reshape(-1)],
                      max_new_tokens=max_new_tokens, temperature=temperature,
                      eos_token_id=eos_token_id, request_id=request_id)
        rid = self.scheduler.submit(req)
        self.span_log.on_submit(rid, req.submit_time, len(req.prompt))
        if req.shed_reason is not None:  # tail-dropped at the queue bound
            self._shed(req)
        return rid

    @property
    def has_work(self) -> bool:
        return self.scheduler.has_work

    def trace_counts(self) -> dict:
        """Builds of the device programs: ``decode`` (a capture on the card,
        the one construction of the eager step on the CPU) stays at 1 after
        warmup, ``verify`` at one a width; ``prefill`` counts distinct
        buckets, <= log2(max_seq_len) + 1; a draft proposer's
        ``draft_prefill`` and ``draft_step`` are merged in."""
        out = {"prefill": len(self._prefill_buckets), "decode": self._decode_builds,
               "verify": len(self._verify)}
        for proposer in self._proposers.values():
            for name, count in proposer.trace_counts().items():
                out[name] = out.get(name, 0) + count
        return out

    def result(self, request_id: str) -> Optional[list[int]]:
        """Generated tokens of a completed request; None while it runs, if
        it was shed, or after it aged out of ``max_retained_results``."""
        return self._results.get(request_id)

    def shed_reason(self, request_id: str) -> Optional[str]:
        """Why a request was shed (None if it was not, or if its entry aged
        out of the bounded shed history)."""
        return self._shed_reasons.get(request_id)

    # ------------------------------------------------------------------ #
    # the step loop
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def step(self) -> list[TokenEvent]:
        """One iteration: shed queue heads past their deadline, retire
        finished slots (their blocks free at once), admit and prefill queued
        requests into the empty seats, then one decode step over the whole
        slot batch, speculative where a slot was admitted with lookahead and
        a proposer is set. Returns the tokens made in this iteration."""
        had_work = self.has_work
        events: list[TokenEvent] = []
        for req in self.scheduler.shed_expired():
            self._shed(req)
        for slot in self.scheduler.slots:
            if slot.busy and slot.done:
                self._finish(slot)
        for slot in self.scheduler.admit():
            self.span_log.on_admit(slot.request.request_id, slot.admit_time)
            self._prefill_slot(slot, events)
        active = [s for s in self.scheduler.slots if s.busy and not s.done]
        if active:
            if self._proposer is not None and any(s.lookahead > 0 for s in active):
                self._spec_step(active, events)
            else:
                self._decode_step(active, events)
        self._steps += 1
        if self.gauge_interval and self._steps % self.gauge_interval == 0:
            self._sample_gauges()
        if self.slo_tracker is not None and (
                (self.slo_tracker.config.interval_steps
                 and self._steps % self.slo_tracker.config.interval_steps == 0)
                # the drain edge: the last record holds the final attainment
                or (had_work and not self.scheduler.has_work)):
            self._emit_slo()
        return events

    def stream(self) -> Iterator[TokenEvent]:
        """Drive :meth:`step` until all submitted work completes, yielding
        token events as they come."""
        while self.scheduler.has_work:
            yield from self.step()

    def generate(self, input_ids, max_new_tokens: int = 32, temperature: float = 0.0,
                 eos_token_id: Optional[int] = None) -> torch.Tensor:
        """The fixed-batch ``generate`` API on the engine: every row is a
        request, and the outputs come back as one (B, prompt_len +
        max_new_tokens) tensor on the model's device, rows finished by EOS
        padded with EOS as ``models.generation.generate`` freezes them."""
        if isinstance(input_ids, torch.Tensor):
            input_ids = input_ids.cpu()
        ids = np.asarray(input_ids)
        req_ids = [self.add_request(row, max_new_tokens=max_new_tokens,
                                    temperature=temperature, eos_token_id=eos_token_id)
                   for row in ids]
        for _ in self.stream():
            pass
        rows = []
        for rid, prompt in zip(req_ids, ids):
            if rid not in self._results:
                reason = self._shed_reasons.get(rid)
                raise RuntimeError(
                    f"generate() lost request {rid}: "
                    + (f"shed ({reason})" if reason else "result evicted by max_retained_results")
                    + "; raise max_queue/max_retained_results or batch less")
            gen = list(self._results[rid])
            pad = eos_token_id if eos_token_id is not None else (gen[-1] if gen else 0)
            gen += [pad] * (max_new_tokens - len(gen))
            rows.append(np.concatenate([prompt, np.asarray(gen, ids.dtype)]))
        return torch.as_tensor(np.stack(rows), device=self.device)

    # ------------------------------------------------------------------ #
    # device work
    # ------------------------------------------------------------------ #
    def _state(self, table, cache_len, lengths) -> PagedKVState:
        return PagedKVState(block_table=table, cache_len=cache_len, lengths=lengths,
                            num_blocks=self.num_blocks, block_size=self.block_size)

    def _cow_block(self, slot: Slot, tindex: int) -> None:
        """Copy-on-write table position ``tindex`` of ``slot``: a private
        block (the spare reserved at admission first), the donor's rows
        copied into it in every layer's K and V pools in place (and in the
        draft's pools), the table entry swapped and the shared reference
        dropped. The donor and every other holder's view of it stay as they
        were; the copy stays out of the content index (its tail is written
        again at another width)."""
        donor = slot.blocks[tindex]
        if slot.cow_spare is not None:
            private, slot.cow_spare = slot.cow_spare, None
        else:
            private = self.pool.allocate(1)[0]
        for pool in (self.cache.key, self.cache.value):
            pool[:, private].copy_(pool[:, donor])
        if self._proposer is not None:
            self._proposer.cow(donor, private)
        slot.blocks[tindex] = private
        self.pool.free([donor])
        slot.shared.discard(tindex)
        slot.cow_indices.add(tindex)
        self._tables[slot.index, tindex] = private
        self._tables_stale = True
        if self.prefix_cache is not None:
            self.prefix_cache.cow_copies_total += 1

    def _prefill_slot(self, slot: Slot, events: list[TokenEvent]) -> None:
        """Prefill the part of the prompt not in the prefix cache (at least
        its last token, whose logits give the first sample), written at
        cache position ``cached`` and read back with the cached prefix."""
        req = slot.request
        prompt_len = len(req.prompt)
        cached = slot.cached_tokens
        self.span_log.on_prefill(req.request_id, self._now(), cached_prefix_tokens=cached)
        if cached and self.prefix_cache is not None:
            self.prefix_cache.tokens_saved_total += cached
        # a shared block the tail writes into is copied first; with
        # block-aligned hits that is only a full-prompt hit's last block
        for t in range(cached // self.block_size, (prompt_len - 1) // self.block_size + 1):
            if t in slot.shared:
                self._cow_block(slot, t)
        tail_len = prompt_len - cached
        bucket = _next_pow2(tail_len)
        self._prefill_buckets.add(bucket)
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :tail_len] = req.prompt[cached:]
        table = np.zeros((1, self._max_table), np.int64)
        table[0, :len(slot.blocks)] = slot.blocks
        dev = self.device
        state = self._state(torch.from_numpy(table).to(dev),
                            torch.full((1,), cached, dtype=torch.long, device=dev),
                            torch.full((1,), tail_len, dtype=torch.long, device=dev))
        logits = self.model(torch.from_numpy(ids).to(dev), decode=True, paged=state,
                            cache=self.cache)
        # the last valid row of the padded bucket, not the padded tail
        last = logits[:, tail_len - 1]
        temp = torch.full((1,), req.temperature, dtype=torch.float32, device=dev)
        token = int(sample_tokens(last, self._generator, temp, self.top_k, self.top_p)[0])
        slot.cache_len = prompt_len
        slot.pending = token
        slot.generated = [token]
        # index every full prompt block written now; shared positions are
        # canonical already, copies stay out
        if self.prefix_cache is not None:
            self.prefix_cache.publish(req.prompt, None, slot.blocks,
                                      skip_indices=slot.shared | slot.cow_indices,
                                      keys=req.prefix_keys)
        slot.first_token_time = self._now()
        self.span_log.on_first_token(req.request_id, slot.first_token_time)
        self._tables[slot.index] = table[0]
        self._tables_stale = True
        if self._proposer is not None and slot.lookahead > 0:
            self._proposer.prefill_slot(slot)
        self.sampling.set_slot(slot.index, req.temperature)
        self._note_token(slot, token, events)

    def _decode_forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """The model over the static buffers: (max_slots, width, V) logits."""
        buf = self._decode_in
        return self.model(tokens, decode=True, cache=self.cache,
                          paged=self._state(buf["tables"], buf["cache_lens"], buf["lengths"]))

    def _build(self, fn: Callable[[], torch.Tensor]) -> StepProgram:
        """Build a step over the static buffers with every row's length at
        0, so the capture's warm-up call writes only to the garbage block
        (the buffers may hold the last step's values)."""
        self._decode_in["lengths"].zero_()
        return StepProgram(fn, self.device)

    def _load_inputs(self, cache_lens: np.ndarray, lengths: np.ndarray) -> None:
        buf = self._decode_in
        buf["cache_lens"].copy_(torch.from_numpy(cache_lens))
        buf["lengths"].copy_(torch.from_numpy(lengths))
        self._sync_tables()

    def _sync_tables(self) -> None:
        if self._tables_stale:
            self._decode_in["tables"].copy_(torch.from_numpy(self._tables))
            self._tables_stale = False

    @torch.no_grad()
    def _decode_logits(self, tokens: np.ndarray, cache_lens: np.ndarray,
                       lengths: np.ndarray, eager: bool = False) -> torch.Tensor:
        """Copy one step's host values into the static buffers and run the
        decode step: by replay of the built program, or, with ``eager``, by
        calling the step itself (for holding the two against each other).
        The program is built at the first call (:meth:`_build`)."""
        if self._decode_program is None:
            buf = self._decode_in
            self._decode_program = self._build(
                lambda: self._decode_forward(buf["tokens"])[:, -1])
            self._decode_builds += 1
        self._decode_in["tokens"].copy_(torch.from_numpy(tokens))
        self._load_inputs(cache_lens, lengths)
        return self._decode_program.fn() if eager else self._decode_program()

    def _decode_step(self, active: list[Slot], events: list[TokenEvent]) -> None:
        tokens = np.zeros((self.max_slots, 1), np.int64)
        cache_lens = np.zeros(self.max_slots, np.int64)
        lengths = np.zeros(self.max_slots, np.int64)
        for slot in active:
            # the pending token lands at cache_len: a shared block there is
            # copied first
            t = slot.cache_len // self.block_size
            if t in slot.shared:
                self._cow_block(slot, t)
            tokens[slot.index, 0] = slot.pending
            cache_lens[slot.index] = slot.cache_len
            lengths[slot.index] = 1
        logits = self._decode_logits(tokens, cache_lens, lengths)
        out = sample_tokens(logits, self._generator, self.sampling.temperatures(),
                            self.top_k, self.top_p).cpu().numpy()
        for slot in active:
            token = int(out[slot.index])
            slot.cache_len += 1  # the fed token was written this step
            slot.pending = token
            slot.generated.append(token)
            self._note_token(slot, token, events)

    def _verify_logits(self, tokens: np.ndarray, cache_lens: np.ndarray,
                       lengths: np.ndarray) -> torch.Tensor:
        """The verify step at ``tokens``' width: its program (built at the
        width's first use, with the buffers' rows empty) replayed over the
        decode step's table and length buffers; (max_slots, width, V)."""
        width = tokens.shape[1]
        if width not in self._verify:
            buf = torch.zeros((self.max_slots, width), dtype=torch.long, device=self.device)
            self._verify[width] = (buf, self._build(lambda: self._decode_forward(buf)))
        buf, program = self._verify[width]
        buf.copy_(torch.from_numpy(tokens))
        self._load_inputs(cache_lens, lengths)
        return program()

    def _spec_step(self, active: list[Slot], events: list[TokenEvent]) -> None:
        """One speculative iteration: propose up to k tokens a slot, verify
        the pending token and the drafts in one pass at ``(max_slots, k +
        1)``, commit the longest prefix the target agrees with on the host.
        The drafts' KV was written by the verify pass, so committing moves
        the cursor; a rejected draft's write is overwritten by the next
        round's. A shared block in the speculative write span is copied
        before any write.

        Column j of the verify pass samples with the j-th noise draw plain
        decode would make from the generator's state (all ``width`` draws
        are taken, then the state is put back to just after the ones the
        round emitted), so the stream is plain decode's at any
        temperature."""
        k = self._spec.k
        width = k + 1
        for slot in active:
            hi = min((slot.cache_len + slot.lookahead) // self.block_size, len(slot.blocks) - 1)
            for t in range(slot.cache_len // self.block_size, hi + 1):
                if t in slot.shared:
                    self._cow_block(slot, t)
        self._sync_tables()  # the draft step reads the table buffer
        drafts = self._proposer.propose([s for s in active if s.lookahead > 0])
        if not any(drafts.values()):
            # nothing proposed: plain decode gives the same tokens cheaper
            # and makes one draw, as a verify round emitting one token does
            self._decode_step(active, events)
            self._spec_rounds_total += 1
            return
        tokens = np.zeros((self.max_slots, width), np.int64)
        cache_lens = np.zeros(self.max_slots, np.int64)
        lengths = np.zeros(self.max_slots, np.int64)
        n_drafted = {}
        for slot in active:
            d = drafts.get(slot.index, [])[:min(k, slot.lookahead)]
            n_drafted[slot.index] = len(d)
            tokens[slot.index, 0] = slot.pending
            tokens[slot.index, 1:1 + len(d)] = d
            cache_lens[slot.index] = slot.cache_len
            lengths[slot.index] = 1 + len(d)
        logits = self._verify_logits(tokens, cache_lens, lengths)
        temps = self.sampling.temperatures()
        states = []
        outs = []
        for j in range(width):
            states.append(self._generator.get_state())
            outs.append(sample_tokens(logits[:, j], self._generator, temps, self.top_k,
                                      self.top_p))
        states.append(self._generator.get_state())
        out = torch.stack(outs, dim=1).cpu().numpy()
        max_emitted = 1
        for slot in active:
            n = n_drafted[slot.index]
            drafted = tokens[slot.index, 1:1 + n]
            slot.cache_len += 1  # the pending token's write is always valid
            emitted = 0
            for j in range(n + 1):
                token = int(out[slot.index, j])
                accepted = j < n and token == int(drafted[j])
                slot.pending = token
                slot.generated.append(token)
                emitted += 1
                if accepted:
                    slot.spec_accepted += 1
                    self._spec_accepted_total += 1
                self._note_token(slot, token, events)
                if slot.done or not accepted:
                    break
                slot.cache_len += 1  # the verify pass wrote the matched draft
            slot.spec_proposed += n
            self._spec_proposed_total += n
            max_emitted = max(max_emitted, emitted)
            self._proposer.commit(slot)
        self._spec_rounds_total += 1
        self._generator.set_state(states[max_emitted])

    # ------------------------------------------------------------------ #
    # host bookkeeping
    # ------------------------------------------------------------------ #
    def _note_token(self, slot: Slot, token: int, events: list[TokenEvent]) -> None:
        req = slot.request
        done = (len(slot.generated) >= req.max_new_tokens
                or (req.eos_token_id is not None and token == req.eos_token_id))
        if done:
            slot.done = True
            slot.finish_time = self._now()
        events.append(TokenEvent(req.request_id, token, done))

    def _finish(self, slot: Slot) -> None:
        req = slot.request
        n_new = len(slot.generated)
        decode_s = slot.finish_time - slot.first_token_time
        record = {
            "request_id": req.request_id,
            "adapter_id": None,
            "prompt_tokens": len(req.prompt),
            "cached_prefix_tokens": slot.cached_tokens,
            "new_tokens": n_new,
            "queue_s": slot.admit_time - req.submit_time,
            "ttft_s": slot.first_token_time - req.submit_time,
            "e2e_s": slot.finish_time - req.submit_time,
            "decode_tokens_per_s": (n_new - 1) / decode_s if n_new > 1 and decode_s > 0 else None,
            # None: nothing was ever proposed for the request
            "spec_proposed": slot.spec_proposed,
            "spec_accepted": slot.spec_accepted,
            "accept_rate": (slot.spec_accepted / slot.spec_proposed
                            if slot.spec_proposed else None),
            # the reference's preemption and chunked-prefill fields, which
            # stay 0 while those paths are refused
            "preempted_count": 0,
            "prefill_chunks": 0,
        }
        self.stats.add(record)
        self._tele("record_serve", **record)
        span = self.span_log.on_finish(req.request_id, slot.finish_time, n_new,
                                       accept_rate=record["accept_rate"])
        if span is not None:
            self._tele("record_span", **span.to_record())
        if self.slo_tracker is not None:
            self.slo_tracker.observe(slot.finish_time, record["ttft_s"], record["e2e_s"])
        self._results[req.request_id] = list(slot.generated)
        self._result_order.append(req.request_id)
        if self.max_retained_results is not None:
            while len(self._result_order) > self.max_retained_results:
                self._results.pop(self._result_order.popleft(), None)
        self.sampling.clear_slot(slot.index)
        self._tables[slot.index] = 0
        self._tables_stale = True
        if self._proposer is not None:
            self._proposer.release(slot.index)
        self.scheduler.release(slot)

    def _shed(self, req: Request) -> None:
        """A refused or expired request: close its span as shed, keep the
        reason (bounded history) and emit the ``shed`` and ``span``
        records."""
        now = self._now()
        reason = req.shed_reason or "unknown"
        self.stats.add_shed(reason)
        self._shed_reasons[req.request_id] = reason
        self._shed_order.append(req.request_id)
        bound = self.span_log.closed.maxlen or 512
        while len(self._shed_order) > bound:
            self._shed_reasons.pop(self._shed_order.popleft(), None)
        span = self.span_log.on_shed(req.request_id, now, reason)
        self._tele("record_shed", request_id=req.request_id, adapter_id=None, reason=reason,
                   queue_s=now - req.submit_time, prompt_tokens=len(req.prompt),
                   max_new_tokens=req.max_new_tokens)
        if span is not None:
            self._tele("record_span", **span.to_record())

    # ------------------------------------------------------------------ #
    # observability
    # ------------------------------------------------------------------ #
    def _tele(self, method: str, **fields) -> None:
        """Emit through the attached telemetry if it has the method."""
        if self._telemetry is None:
            return
        fn = getattr(self._telemetry, method, None)
        if fn is not None:
            fn(**fields)

    def _gauge_fields(self) -> dict:
        """The live engine sampled into ``serve_gauge`` records: host reads
        only, no device sync. The keys are the reference's for a colocated
        engine; those of the planes not ported yet (adapters, preemption and
        swap, chunked prefill) read 0."""
        now = self._now()
        sched = self.scheduler
        # one clock, FIFO queue: ages are sorted, so the p95 reads off the
        # index
        n_queued = len(sched.queue)
        if n_queued:
            rank = 0.95 * (n_queued - 1)
            lo = int(rank)
            hi = min(lo + 1, n_queued - 1)
            a_lo = now - sched.queue[n_queued - 1 - lo].submit_time
            a_hi = now - sched.queue[n_queued - 1 - hi].submit_time
            queue_age_p95 = a_lo + (a_hi - a_lo) * (rank - lo)
        else:
            queue_age_p95 = 0.0
        pool = self.pool.stats()
        active = [s for s in sched.slots if s.busy]
        prefix = self.prefix_cache
        proposed = self._spec_proposed_total
        return {
            "engine_steps": self._steps,
            "queue_depth": n_queued,
            "queue_age_p95_s": queue_age_p95,
            "slots_active": len(active),
            "slot_occupancy": len(active) / self.max_slots,
            "pool_blocks_free": pool["free"],
            "pool_blocks_allocated": pool["allocated"],
            "pool_blocks_cached": pool["cached"],
            "pool_utilization": pool["utilization"],
            "shared_blocks": pool["shared"],
            "prefix_cache_hit_rate": prefix.hit_rate if prefix is not None else 0.0,
            "cow_copies_total": prefix.cow_copies_total if prefix is not None else 0,
            "prefill_tokens_saved_total": prefix.tokens_saved_total if prefix is not None else 0,
            "tokens_in_flight": sum(s.cache_len for s in active),
            "admission_blocked_no_free_slot_total": sched.blocked_reasons["no_free_slot"],
            "admission_blocked_pool_exhausted_total": sched.blocked_reasons["pool_exhausted"],
            "admission_blocked_adapter_not_resident_total": 0,
            "adapters_resident": 0,
            "shed_queue_full_total": sched.shed_counts["queue_full"],
            "shed_queue_deadline_total": sched.shed_counts["queue_deadline"],
            "spec_rounds": self._spec_rounds_total,
            "spec_tokens_proposed": proposed,
            "spec_tokens_accepted": self._spec_accepted_total,
            "spec_accept_rate": self._spec_accepted_total / proposed if proposed else 0.0,
            "swapped_blocks": 0,
            "swapped_requests": 0,
            "swap_bytes_held": 0,
            "preempts_total": 0,
            "preempts_priority_total": 0,
            "preempts_pool_total": 0,
            "preempts_growth_total": 0,
            "resumes_total": 0,
            "prefill_chunks_total": 0,
            "kv_bytes_per_token": self.kv_bytes_per_token,
        }

    def _sample_gauges(self) -> None:
        self._tele("record_serve_gauge", **self._gauge_fields())
        self._tele("sample_memory")  # throttled by the collector's clock

    def _emit_slo(self) -> None:
        self._tele("record_slo", **self.slo_tracker.snapshot(self._now()))

    # ------------------------------------------------------------------ #
    # runtime toggles on a warm engine
    # ------------------------------------------------------------------ #
    def set_observability(self, *, telemetry: Any = None, gauge_interval: int = 1,
                          slo: Any = None, spans: bool = True) -> None:
        """Attach or detach the observability plane at runtime: the same
        programs serve both, so an on/off comparison measures only the host
        work of spans, gauges and the SLO. ``slo`` takes an
        :class:`SLOConfig` or an existing :class:`SloTracker` (pass the
        tracker to keep accumulating across toggles)."""
        if gauge_interval < 0:
            raise ValueError("gauge_interval must be >= 0 (0 disables)")
        self._telemetry = telemetry
        self.gauge_interval = gauge_interval
        if slo is None or isinstance(slo, SloTracker):
            self.slo_tracker = slo
        else:
            self.slo_tracker = SloTracker(slo)
        self.span_log.enabled = spans

    def set_prefix_cache(self, enabled: bool, model_fingerprint: Optional[str] = None) -> None:
        """Toggle prefix caching at runtime: host policy only, so cold and
        warm run the same programs. Turning it off clears the content index
        (cached blocks return to the free list; blocks shared in flight
        keep their references and drain as usual)."""
        if enabled:
            if model_fingerprint is not None:
                self._model_fingerprint = model_fingerprint
            if self.prefix_cache is None:
                self.prefix_cache = PrefixCache(self.pool, fingerprint=self._model_fingerprint)
        else:
            self.pool.clear_cache()
            self.prefix_cache = None
        self.scheduler.prefix_cache = self.prefix_cache

    def set_speculation(self, spec: Optional[SpecConfig]) -> None:
        """Toggle speculative decoding at runtime. ``None`` (or ``k = 0``)
        turns it off: the next step is plain decode. Turning it on affects
        only requests admitted from then on (they get the k-token
        reservation); seated ones finish plainly. Proposers are kept per
        config instance and verify programs per width, so an
        off-on-off-on sequence builds nothing new."""
        if spec is None or spec.k == 0:
            self._spec = spec
            self._proposer = None
            self.scheduler.lookahead_tokens = 0
            return
        proposer = self._proposers.get(id(spec))
        if proposer is None:
            if spec.method == "draft_model":
                proposer = DraftModelProposer(
                    spec, target_config=self.model.config, num_blocks=self.num_blocks,
                    block_size=self.block_size, max_slots=self.max_slots,
                    tables=self._decode_in["tables"])
            else:
                proposer = NGramProposer(spec)
            self._proposers[id(spec)] = proposer
        self._spec = spec
        self._proposer = proposer
        self.scheduler.lookahead_tokens = spec.k

    # ------------------------------------------------------------------ #
    # planes not ported yet
    # ------------------------------------------------------------------ #
    def start_http(self, *args, **kwargs):
        raise _not_ported("the HTTP plane: start_http")

    def health(self):
        raise _not_ported("the HTTP plane: health")

    def drain(self):
        raise _not_ported("the HTTP plane: drain")

    def prefix_digest(self, *args, **kwargs):
        raise _not_ported("the HTTP plane: prefix_digest")

    def capture_programs(self, *args, **kwargs):
        raise _not_ported("capture_programs")

    def audit_programs(self, *args, **kwargs):
        raise _not_ported("audit_programs")

    # ------------------------------------------------------------------ #
    # reports
    # ------------------------------------------------------------------ #
    def export_trace(self, path: str) -> str:
        """The last ``span_history`` closed spans and the open ones as
        Chrome-trace JSON; returns ``path``."""
        return write_chrome_trace(path, list(self.span_log.closed) + self.span_log.open_spans)

    def summary(self) -> dict:
        """The :class:`ServeStats` percentile block with the pool's
        occupancy, the build counts, the gauges and the span counts, plus
        the SLO snapshot, the prefix cache's hits and the speculation
        totals where those are on (or, for speculation, have run)."""
        out = {
            **self.stats.summary(),
            "pool": self.pool.stats(),
            "traces": self.trace_counts(),
            "gauges": self._gauge_fields(),
            "spans": self.span_log.summary(),
        }
        if self.slo_tracker is not None:
            out["slo"] = self.slo_tracker.snapshot(self._now())
        if self.prefix_cache is not None:
            out["prefix_cache"] = self.prefix_cache.stats()
        if self._proposer is not None or self._spec_rounds_total:
            proposed = self._spec_proposed_total
            out["speculation"] = {
                "enabled": self._proposer is not None,
                "method": self._spec.method if self._spec else None,
                "k": self._spec.k if self._spec else 0,
                "rounds": self._spec_rounds_total,
                "proposed": proposed,
                "accepted": self._spec_accepted_total,
                "accept_rate": self._spec_accepted_total / proposed if proposed else 0.0,
            }
        return out
