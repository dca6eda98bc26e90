"""The step-level serving engine: continuous batching over a paged KV cache.

Port of the core of ``accelerate_tpu/serving/engine.py:ServingEngine``
(:93): ``add_request`` (:511), ``step`` (:605-692), ``_prefill_slot``
(:816), ``_decode_step`` (:1493), ``_note_token``, ``_finish`` (:1625),
``_shed`` (:1680), ``stream``, ``generate`` (:700), ``result``,
``shed_reason``, ``trace_counts`` (:578), ``summary`` (:2204),
``kv_bytes_per_token`` and the injectable clock. ``step`` retires finished
slots, admits and prefills queued requests into the empty seats, then runs
one decode step over the whole slot batch.

Two kinds of program do the device work, as in the reference:

* one decode step at the fixed ``(max_slots, 1)`` shape, built once: on a
  CUDA device the model's decode forward and its paged KV writes are
  captured as one CUDA graph over static buffers (tokens, block tables,
  cache lengths, valid lengths), and every step copies the host values
  into those buffers and replays it; sampling runs after the replay, on
  the graph's logits, with the engine's generator. On the CPU the same
  step runs eager. Request churn is data in the buffers, so it never
  rebuilds the step;
* prefill, eager, one call per request at the power-of-two bucket of its
  prompt length (at most log2(max_seq_len) + 1 buckets).

``trace_counts()`` counts builds: ``decode`` is 1 after the first decode
step and stays there; ``prefill`` is the number of distinct buckets.

The reference's options for paths not ported yet raise
NotImplementedError naming ROADMAP.md's queue A9; none is ignored. The
reference's gauges, SLO tracker, telemetry records and HTTP plane are not
ported yet either (same queue). The model's parameters live in the module,
so the reference's ``params`` argument has no counterpart.
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from ..models.generation import init_cache
from ..ops.attention import PagedKVState
from ..utils.cuda_graph import StepProgram
from .block_pool import BlockPool
from .sampling import SlotSampling, sample_tokens
from .scheduler import ContinuousScheduler, Request, Slot
from .spans import SpanLog, write_chrome_trace
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
    """

    def __init__(self, model, *, max_slots: int = 4, block_size: int = 16,
                 num_blocks: Optional[int] = None, top_k: Optional[int] = None,
                 top_p: Optional[float] = None, seed: int = 0,
                 now: Callable[[], float] = time.monotonic,
                 max_queue: Optional[int] = None, max_queue_delay_s: Optional[float] = None,
                 span_history: int = 512, max_retained_results: Optional[int] = 4096,
                 kv_dtype: str = "bf16", telemetry=None, slo=None, adapters=None,
                 prefix_cache: bool = False, spec_decode=None,
                 prefill_chunk_tokens: Optional[int] = None, preemption: bool = False,
                 role: str = "colocated", transfer_plane=None):
        refused = [
            ("telemetry=...", telemetry is not None), ("slo=...", slo is not None),
            ("adapters=...", adapters is not None), ("prefix_cache=True", prefix_cache),
            ("spec_decode=...", spec_decode is not None),
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
        self.scheduler = ContinuousScheduler(max_slots, self.pool, now=now, max_queue=max_queue,
                                             max_queue_delay_s=max_queue_delay_s)
        self.sampling = SlotSampling(max_slots, self.device)
        self.stats = ServeStats()
        self.span_log = SpanLog(maxlen=span_history)
        self.max_retained_results = max_retained_results
        self._now = now
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
        # the decode step's static inputs: the graph reads these tensors,
        # so each step copies into them and never rebinds them
        self._decode_in = {
            "tokens": torch.zeros((max_slots, 1), dtype=torch.long, device=self.device),
            "tables": torch.zeros((max_slots, self._max_table), dtype=torch.long,
                                  device=self.device),
            "cache_lens": torch.zeros(max_slots, dtype=torch.long, device=self.device),
            "lengths": torch.zeros(max_slots, dtype=torch.long, device=self.device),
        }
        self._decode_program: Optional[StepProgram] = None

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
        warmup; ``prefill`` counts distinct buckets, <= log2(max_seq_len)
        + 1."""
        return {"prefill": len(self._prefill_buckets), "decode": self._decode_builds}

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
        slot batch. Returns the tokens made in this iteration."""
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
            self._decode_step(active, events)
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
    def _prefill_slot(self, slot: Slot, events: list[TokenEvent]) -> None:
        req = slot.request
        prompt_len = len(req.prompt)
        self.span_log.on_prefill(req.request_id, self._now())
        bucket = _next_pow2(prompt_len)
        self._prefill_buckets.add(bucket)
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :prompt_len] = req.prompt
        table = np.zeros((1, self._max_table), np.int64)
        table[0, :len(slot.blocks)] = slot.blocks
        dev = self.device
        state = PagedKVState(
            block_table=torch.from_numpy(table).to(dev),
            cache_len=torch.zeros(1, dtype=torch.long, device=dev),
            lengths=torch.full((1,), prompt_len, dtype=torch.long, device=dev),
            num_blocks=self.num_blocks, block_size=self.block_size)
        logits = self.model(torch.from_numpy(ids).to(dev), decode=True, paged=state,
                            cache=self.cache)
        # the last valid row of the padded bucket, not the padded tail
        last = logits[:, prompt_len - 1]
        temp = torch.full((1,), req.temperature, dtype=torch.float32, device=dev)
        token = int(sample_tokens(last, self._generator, temp, self.top_k, self.top_p)[0])
        slot.cache_len = prompt_len
        slot.pending = token
        slot.generated = [token]
        slot.first_token_time = self._now()
        self.span_log.on_first_token(req.request_id, slot.first_token_time)
        self._tables[slot.index] = table[0]
        self._tables_stale = True
        self.sampling.set_slot(slot.index, req.temperature)
        self._note_token(slot, token, events)

    def _decode_forward(self) -> torch.Tensor:
        """The decode step over the static buffers: (max_slots, V) logits."""
        buf = self._decode_in
        state = PagedKVState(block_table=buf["tables"], cache_len=buf["cache_lens"],
                             lengths=buf["lengths"], num_blocks=self.num_blocks,
                             block_size=self.block_size)
        return self.model(buf["tokens"], decode=True, paged=state, cache=self.cache)[:, -1]

    @torch.no_grad()
    def _decode_logits(self, tokens: np.ndarray, cache_lens: np.ndarray,
                       lengths: np.ndarray, eager: bool = False) -> torch.Tensor:
        """Copy one step's host values into the static buffers and run the
        decode step: by replay of the built program, or, with ``eager``, by
        calling the step itself (for holding the two against each other).
        The program is built at the first call, while the buffers still say
        every slot is empty, so the capture's warm-up call writes only to the
        garbage block."""
        if self._decode_program is None:
            self._decode_program = StepProgram(self._decode_forward, self.device)
            self._decode_builds += 1
        buf = self._decode_in
        buf["tokens"].copy_(torch.from_numpy(tokens))
        buf["cache_lens"].copy_(torch.from_numpy(cache_lens))
        buf["lengths"].copy_(torch.from_numpy(lengths))
        if self._tables_stale:
            buf["tables"].copy_(torch.from_numpy(self._tables))
            self._tables_stale = False
        return self._decode_program.fn() if eager else self._decode_program()

    def _decode_step(self, active: list[Slot], events: list[TokenEvent]) -> None:
        tokens = np.zeros((self.max_slots, 1), np.int64)
        cache_lens = np.zeros(self.max_slots, np.int64)
        lengths = np.zeros(self.max_slots, np.int64)
        for slot in active:
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
        self.stats.add({
            "request_id": req.request_id,
            "prompt_tokens": len(req.prompt),
            "new_tokens": n_new,
            "queue_s": slot.admit_time - req.submit_time,
            "ttft_s": slot.first_token_time - req.submit_time,
            "e2e_s": slot.finish_time - req.submit_time,
            "decode_tokens_per_s": (n_new - 1) / decode_s if n_new > 1 and decode_s > 0 else None,
        })
        self.span_log.on_finish(req.request_id, slot.finish_time, n_new)
        self._results[req.request_id] = list(slot.generated)
        self._result_order.append(req.request_id)
        if self.max_retained_results is not None:
            while len(self._result_order) > self.max_retained_results:
                self._results.pop(self._result_order.popleft(), None)
        self.sampling.clear_slot(slot.index)
        self._tables[slot.index] = 0
        self._tables_stale = True
        self.scheduler.release(slot)

    def _shed(self, req: Request) -> None:
        """A refused or expired request: close its span as shed and keep
        the reason (bounded history)."""
        now = self._now()
        reason = req.shed_reason or "unknown"
        self.stats.add_shed(reason)
        self._shed_reasons[req.request_id] = reason
        self._shed_order.append(req.request_id)
        bound = self.span_log.closed.maxlen or 512
        while len(self._shed_order) > bound:
            self._shed_reasons.pop(self._shed_order.popleft(), None)
        self.span_log.on_shed(req.request_id, now, reason)

    def export_trace(self, path: str) -> str:
        """The last ``span_history`` closed spans and the open ones as
        Chrome-trace JSON; returns ``path``."""
        return write_chrome_trace(path, list(self.span_log.closed) + self.span_log.open_spans)

    def summary(self) -> dict:
        """The :class:`ServeStats` percentile block with the pool's
        occupancy, the build counts and the span counts."""
        return {
            **self.stats.summary(),
            "pool": self.pool.stats(),
            "traces": self.trace_counts(),
            "spans": self.span_log.summary(),
        }
