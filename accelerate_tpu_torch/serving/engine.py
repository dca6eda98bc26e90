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
``kv_bytes_per_token`` (:326-328) and the injectable clock, and the
capacity levers (:149-330): chunked prefill (``prefill_chunk_tokens``;
``_begin_chunked``, ``_chunked_prefill_step``, ``_prefill_chunk``
:882-1013, and the growth path ``_ensure_blocks``/``_grow_active``/
``_grow_or_preempt`` :1015-1071), preemption with KV swap and priorities
(``preemption``, ``add_request(priority=)``; the swap programs
:1075-1137 and ``_preempt``/``_try_resume``/``_resume``/``_maybe_preempt``
:1139-1290) and int8 paged KV (``kv_dtype="int8"``), with the buffer
census's owners (:1808-1830), and prefill/decode disaggregation
(``role``, ``transfer_plane``, ``set_role`` :563-576; the hand-off
``_handoff_slot``, ``pop_manifests``, ``acquire``, ``_seat_manifests``,
``_try_seat_manifest`` and ``transfer_gauges`` :1291-1491) with the
router's hooks (``drain``, ``undrain``, ``draining``, ``health`` and
``prefix_digest`` :2127-2162), and multi-tenant adapters (``adapters=``,
``add_request(adapter=)``, the per-slot rows ``_slot_adapter`` :269-271,
pinned from seating to finish, preemption or hand-off, :640-643,
:846-853, :893-894, :1181-1185, :1241-1243, :1345-1349, :1383, :1426).
``step`` sheds expired queue entries,
retires finished slots, resumes swapped requests, seats acquired
manifests, admits (preempting for the head where it may), prefills or
feeds chunks (a prefill-role engine then hands each finished prefill
off), then runs one decode (or speculative) step over the whole slot batch
(:620-692).

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
  part of its prompt not in the prefix cache, written at that offset (with
  chunked prefill, one call a chunk, at the chunk's offset and bucket).

With an :class:`~..adapters.AdapterRegistry` attached, every program
adds each row's adapter delta: prefill reads the request's stack row, and
the decode and verify steps read a static slot-id buffer (one stack row a
slot, 0 the identity) that each step fills from the host mirror, over the
registry's resident stacks and scales. A load or an eviction writes rows of
those tensors in place, never rebinding them, so the captured graph reads
the new tenant: adapter churn builds nothing.

Every graph reads the KV pools (and, for int8, their scale arrays) and the
table buffer where they are, so these are allocated once before any
capture: a copy-on-write copies a block inside every layer's pools and
scale arrays in place, a swap-in ``index_copy_``s the saved images into
them, and a table change is copied into the one buffer before the next
replay.

A preempted request's blocks are gathered (every pool and scale array, at
the power-of-two width of its block count, padded with the garbage block)
and copied to host memory before its block ids go back to the pool; the
copy is synchronous, so nothing written to those blocks later can reach
the saved image. A resume allocates fresh blocks and scatters the images
into them, so the request continues from its own KV, not from a new
prefill, and draws nothing from the engine's generator. A hand-off leaves
through the same gather (only the blocks the prompt wrote) and arrives
through the same scatter (only the blocks the decode side's content index
lacks), so it adds no program of its own: its widths count under
``swap_out`` and ``swap_in``.

``trace_counts()`` counts builds: ``decode`` is 1 after the first decode
step and stays there; ``verify`` is one a width used; ``prefill`` is the
number of distinct buckets; ``swap_out`` and ``swap_in`` one a width used;
a draft proposer adds ``draft_prefill`` and ``draft_step``.

A model that ``Accelerator.prepare`` sharded under a ``ParallelismPlugin``
(its parameters DTensors) is served as the reference's engine serves
sharded params: every rank of the mesh runs the same engine on the same
requests and makes the same decisions (block tables, admission, sampling
from one seed over logits gathered whole). Every model call runs inside
the model's sharded context (``models.generation._forward``): the fsdp
shards gathered as each layer runs, the products split over tp, the decode
and verify graphs capturing those collectives. Under tp each rank's pools
hold its kv heads (``models.transformer._tp_heads``) while the blocks and
the int8 scale arrays are whole; a preemption swaps the rank's heads, a
hand-off's manifest carries every kv head (gathered over tp on the way out,
cut to the rank's heads on the way in, so a tp engine and an unsharded one
hand off both ways), and every byte count (``kv_bytes_per_token``, swap
bytes, manifests, the transfer gauges) is the whole model's, as the
reference's ``nbytes`` of a global array is. A registry's adapter stacks
hold the rank's share (``AdapterRegistry.split_tp``).

The reference's options for paths not ported yet (the HTTP plane and
program capture) raise NotImplementedError naming ROADMAP.md's queue item,
A10; none is ignored. The model's parameters live in the module,
so the reference's ``params`` argument has no counterpart.
"""

from __future__ import annotations

import collections
import hashlib
import time
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from ..adapters.runtime import LoraState
from ..models import generation
from ..models.generation import init_cache
from ..ops.attention import PagedKVState
from ..utils.cuda_graph import StepProgram
from .block_pool import BlockPool, PrefixCache, prefix_keys
from .sampling import SlotSampling, sample_tokens
from .scheduler import ContinuousScheduler, Request, Slot
from .slo import SLOConfig, SloTracker
from .spans import SpanLog, write_chrome_trace
from .speculation import DraftModelProposer, NGramProposer, SpecConfig
from .telemetry import ServeStats
from .transfer import TransferManifest


@dataclass(frozen=True)
class TokenEvent:
    """One generated token, as ``step``/``stream`` report it."""

    request_id: str
    token: int
    done: bool


def _tp_split(model) -> tuple:
    """Where the model's parameters are split over tp (above 1): its
    ``TensorParallel`` group and each tp rank's kv heads ``[lo, hi)`` (equal
    shares, or overlapping ones where the query heads do not group evenly,
    ``models.transformer._tp_heads``); else (None, ())."""
    from ..models.transformer import _tp_heads
    from ..parallel import runtime as _shard

    if not _shard.is_sharded_module(model):
        return None, ()
    tp = _shard.module_layout(model).tp
    if tp.size == 1:
        return None, ()
    hd = model.config.head_dim
    rows = [_tp_heads(model.config, _shard.TensorParallel(None, tp.size, r)).kv_rows
            for r in range(tp.size)]
    return tp, tuple((r.start // hd, r.stop // hd) for r in rows)


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length() if n > 1 else 1


_ROLES = ("colocated", "prefill", "decode")


def _not_ported(option: str, queue: str) -> NotImplementedError:
    return NotImplementedError(
        f"ServingEngine({option}) is not ported yet (ROADMAP.md, queue {queue})")


@dataclass
class _SwappedRequest:
    """A preempted request parked on the host: the slot's scheduler state
    and its blocks' contents (``data``: one host tensor a cache tensor, in
    ``PagedKVCache.tensors()`` order, axis 1 the block's table position).
    Its device block ids went back to the pool at swap-out."""

    request: Request
    generated: list[int]
    pending: int
    cache_len: int
    n_blocks: int
    data: list
    chunks: int
    preempted_count: int
    admit_time: float
    first_token_time: float
    cached_tokens: int
    swap_bytes: int
    preempt_time: float


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
    ``prefill_chunk_tokens``: a per-step budget of prompt tokens; prompts
    are ingested in chunks between decode steps, shortest remaining first.
    ``preemption``: under pool or seat pressure swap a seated request's KV
    to host memory instead of shedding the queue (a request of higher
    ``priority`` may displace a lower one); with chunked prefill it also
    lets admission reserve one chunk instead of the whole footprint.
    ``kv_dtype``: ``"bf16"`` keeps the pools in the model's compute dtype,
    ``"int8"`` stores per-token int8 codes and fp32 scales.
    ``adapters``: an :class:`~..adapters.AdapterRegistry` on the model's
    device; a request naming an adapter (``add_request(adapter=)``) is
    seated once the adapter is resident and pins it until it finishes, is
    preempted or is handed off.
    ``role``: ``"prefill"`` ingests prompts only and hands each finished
    chain off as a :class:`~.transfer.TransferManifest` (through
    ``transfer_plane``'s ``stage``, if given); ``"decode"`` takes work only
    through :meth:`acquire`; ``"colocated"`` (the default) runs none of the
    hand-off code.
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
        if role not in _ROLES:
            raise ValueError(f"role must be 'colocated', 'prefill' or 'decode', got {role!r}")
        if prefill_chunk_tokens is not None and prefill_chunk_tokens < 1:
            raise ValueError("prefill_chunk_tokens must be >= 1 (or None)")
        # "bf16" is the reference's name for the model's native compute dtype
        if kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_dtype must be 'bf16' (native) or 'int8', got {kv_dtype!r}")
        if max_retained_results is not None and max_retained_results < 1:
            raise ValueError("max_retained_results must be >= 1 (or None)")
        if gauge_interval < 0:
            raise ValueError("gauge_interval must be >= 0 (0 disables)")
        self.model = model
        self.device = generation._device(model)
        # the model's calls, inside its sharded context when it has one
        self._forward = generation._forward(model)
        self._tp, self._kv_spans = _tp_split(model)
        if adapters is not None and adapters.device != self.device:
            raise ValueError(f"the adapter registry is on {adapters.device} but the model is on "
                             f"{self.device}")
        if adapters is not None and self._tp is not None:
            from ..models.transformer import tp_adapter_slices

            adapters.split_tp(tp_adapter_slices(model.config, self._tp))
        self.adapters = adapters
        self._role = role
        self._plane = transfer_plane
        self._outbox: list[TransferManifest] = []
        self._inbox: list[TransferManifest] = []
        self._transfer_stats = {"manifests_out": 0, "manifests_in": 0, "blocks_moved": 0,
                                "blocks_deduped": 0, "bytes_moved": 0, "seat_deferred": 0}
        self.max_slots = max_slots
        self.block_size = block_size
        self.top_k, self.top_p = top_k, top_p
        self.prefill_chunk_tokens = prefill_chunk_tokens
        self.preemption = preemption
        self._kv_state_dtype = "int8" if kv_dtype == "int8" else "native"
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
                                             adapter_ready=(adapters.resident if adapters is not None
                                                            else None),
                                             prefix_cache=self.prefix_cache,
                                             max_table_blocks=self._max_table)
        # chunk-aware admission only with preemption, the escape when growth
        # cannot allocate; without it admission keeps the full reservation
        self.scheduler.chunk_tokens = prefill_chunk_tokens
        self.scheduler.chunked_reserve = prefill_chunk_tokens is not None and preemption
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
        # each slot's adapter stack row (0: the base model), copied into the
        # decode step's slot-id buffer before each replay
        self._slot_adapter = np.zeros(max_slots, np.int64)
        self._results: dict[str, list[int]] = {}
        self._result_order: collections.deque = collections.deque()
        self._shed_reasons: dict[str, str] = {}
        self._shed_order: collections.deque = collections.deque()
        self._prefill_buckets: set[int] = set()
        self._decode_builds = 0
        # padded prefill tokens issued so far (the bucket of every prefill and
        # chunk call): a step's delta is its prefill work, which the soak
        # harness's work-weighted clock charges
        self.prefill_bucket_tokens_total = 0
        self.cache = init_cache(model, num_blocks=num_blocks, block_size=block_size,
                                kv_dtype=self._kv_state_dtype)
        # bytes of KV per cached token across every layer's pools (and the
        # int8 scale arrays), the whole model's under tp
        self.kv_bytes_per_token = self._whole_nbytes(self.cache.tensors()) / (
            num_blocks * block_size)
        # preemption: the swap programs' widths built so far, the requests
        # parked on the host, and the counts the gauges export
        self._swap_widths: dict[str, set[int]] = {"swap_out": set(), "swap_in": set()}
        self._swapped_reqs: list[_SwappedRequest] = []
        self._preempt_counts: dict[str, int] = {"priority": 0, "pool": 0, "growth": 0}
        self._resumes_total = 0
        self._swap_bytes_held = 0
        self._prefill_chunks_total = 0
        # the decode and verify steps' static inputs: the graphs read these
        # tensors, so each step copies into them and never rebinds them
        self._decode_in = {
            "tokens": torch.zeros((max_slots, 1), dtype=torch.long, device=self.device),
            "tables": torch.zeros((max_slots, self._max_table), dtype=torch.long,
                                  device=self.device),
            "cache_lens": torch.zeros(max_slots, dtype=torch.long, device=self.device),
            "lengths": torch.zeros(max_slots, dtype=torch.long, device=self.device),
            "slot_ids": torch.zeros(max_slots, dtype=torch.long, device=self.device),
        }
        self._decode_program: Optional[StepProgram] = None
        self._census_views: Optional[list] = None
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
        self._register_census_owners()

    # ------------------------------------------------------------------ #
    # request API
    # ------------------------------------------------------------------ #
    def add_request(self, prompt, max_new_tokens: int = 32, temperature: float = 0.0,
                    eos_token_id: Optional[int] = None, request_id: str = "",
                    adapter: Optional[str] = None, priority: int = 0) -> str:
        """Enqueue one request (a sequence of token ids); returns its id. A
        later :meth:`step` admits it as soon as a seat and its block
        reservation are free. ``priority`` orders admission (higher first,
        FIFO within a priority) and, with ``preemption=True``, lets the head
        displace a seated request of strictly lower priority. ``adapter``
        names a tenant of the engine's registry: the request is seated once
        that adapter is resident."""
        if adapter is not None and self.adapters is None:
            raise ValueError(f"request names adapter {adapter!r} but the engine was built "
                             "without an AdapterRegistry (pass adapters=...)")
        req = Request(prompt=[int(t) for t in np.asarray(prompt).reshape(-1)],
                      max_new_tokens=max_new_tokens, temperature=temperature,
                      eos_token_id=eos_token_id, request_id=request_id, adapter=adapter,
                      priority=priority)
        rid = self.scheduler.submit(req)
        self.span_log.on_submit(rid, req.submit_time, len(req.prompt), adapter_id=adapter)
        if req.shed_reason is not None:  # tail-dropped at the queue bound
            self._shed(req)
        return rid

    @property
    def has_work(self) -> bool:
        # a swapped-out request holds neither seat nor queue entry, but is
        # the engine's until it finishes, as is an acquired manifest not
        # seated yet
        return self.scheduler.has_work or bool(self._swapped_reqs) or bool(self._inbox)

    @property
    def role(self) -> str:
        return self._role

    def set_role(self, role: str) -> None:
        """Switch the disaggregation role of a warm engine. A role is host
        policy over the same programs, so an engine can be primed colocated
        (every prefill bucket and the decode step) and then join a pool."""
        if role not in _ROLES:
            raise ValueError(f"role must be 'colocated', 'prefill' or 'decode', got {role!r}")
        self._role = role

    def trace_counts(self) -> dict:
        """Builds of the device programs: ``decode`` (a capture on the card,
        the one construction of the eager step on the CPU) stays at 1 after
        warmup, ``verify`` at one a width; ``prefill`` counts distinct
        buckets, <= log2(max_seq_len) + 1; ``swap_out`` and ``swap_in``
        count the swap programs' widths; a draft proposer's
        ``draft_prefill`` and ``draft_step`` are merged in."""
        out = {"prefill": len(self._prefill_buckets), "decode": self._decode_builds,
               "verify": len(self._verify), "swap_out": len(self._swap_widths["swap_out"]),
               "swap_in": len(self._swap_widths["swap_in"])}
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
        """One iteration: shed queued requests past their deadline, retire
        finished slots (their blocks free at once), resume swapped requests
        onto free capacity, admit queued requests into the empty seats
        (preempting one seated request for the head where allowed), prefill
        them or spend the step's chunk budget, then one decode step over
        the slots past their prefill, speculative where a slot was admitted
        with lookahead and a proposer is set. Returns the tokens made in
        this iteration."""
        had_work = self.has_work
        events: list[TokenEvent] = []
        for req in self.scheduler.shed_expired():
            self._shed(req)
        for slot in self.scheduler.slots:
            if slot.busy and slot.done:
                self._finish(slot)
        if self.preemption:
            self._try_resume()
        if self._inbox:
            self._seat_manifests()
        blocked_before = dict(self.scheduler.blocked_reasons)
        admitted = self.scheduler.admit()
        if self.preemption and self._maybe_preempt(blocked_before,
                                                   exclude={s.index for s in admitted}):
            # the freed seat and blocks fund the queue head this step
            admitted += self.scheduler.admit()
        for slot in admitted:
            self._pin_adapter(slot)
            self.span_log.on_admit(slot.request.request_id, slot.admit_time)
            if self.prefill_chunk_tokens is None:
                self._prefill_slot(slot, events)
            else:
                self._begin_chunked(slot)
        if self.prefill_chunk_tokens is not None:
            self._chunked_prefill_step(events)
        if self._role == "prefill":
            # prompt ingestion only: a seat whose prefill completed hands its
            # chain off instead of decoding (one done at its first token
            # finishes here)
            for slot in self.scheduler.slots:
                if slot.busy and not slot.done and not slot.mid_prefill:
                    self._handoff_slot(slot)
        # seats still ingesting their prompt are not in the decode batch
        # (their row has length 0 this step)
        active = [s for s in self.scheduler.slots if s.busy and not s.done and not s.mid_prefill]
        if active and self.scheduler.chunked_reserve:
            active = self._grow_active(active)
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
        """Drive :meth:`step` until all submitted work completes, swapped-out
        requests included, yielding token events as they come."""
        while self.has_work:
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
                            num_blocks=self.num_blocks, block_size=self.block_size,
                            kv_dtype=self._kv_state_dtype)

    def _cow_block(self, slot: Slot, tindex: int) -> None:
        """Copy-on-write table position ``tindex`` of ``slot``: a private
        block (the spare reserved at admission first), the donor's rows
        copied into it in every layer's K and V pools and int8 scale arrays
        in place (and in the draft's pools), the table entry swapped and the
        shared reference dropped. The donor and every other holder's view of
        it stay as they were; the copy stays out of the content index (its
        tail is written again at another width)."""
        donor = slot.blocks[tindex]
        if slot.cow_spare is not None:
            private, slot.cow_spare = slot.cow_spare, None
        else:
            private = self.pool.allocate(1)[0]
        for pool in self.cache.tensors():
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
        table, last = self._prefill_call(slot, cached, tail_len)
        token = self._sample_first(last, req)
        slot.cache_len = prompt_len
        slot.pending = token
        slot.generated = [token]
        # index every full prompt block written now; shared positions are
        # canonical already, copies stay out
        if self.prefix_cache is not None:
            self.prefix_cache.publish(req.prompt, req.adapter, slot.blocks,
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

    def _prefill_call(self, slot: Slot, start: int, n: int) -> tuple[np.ndarray, torch.Tensor]:
        """One prefill call of the slot's prompt tokens [start, start + n)
        at its power-of-two bucket, written at cache position ``start`` and
        read back with what the table holds before it. Returns the (1,
        max_table) table it used and the logits of the last valid row."""
        req = slot.request
        bucket = _next_pow2(n)
        self._prefill_buckets.add(bucket)
        self.prefill_bucket_tokens_total += bucket
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :n] = req.prompt[start:start + n]
        table = np.zeros((1, self._max_table), np.int64)
        table[0, :len(slot.blocks)] = slot.blocks
        dev = self.device
        state = self._state(torch.from_numpy(table).to(dev),
                            torch.full((1,), start, dtype=torch.long, device=dev),
                            torch.full((1,), n, dtype=torch.long, device=dev))
        row = torch.full((1,), int(self._slot_adapter[slot.index]), dtype=torch.long, device=dev)
        logits = self._forward(torch.from_numpy(ids).to(dev), self.cache, paged=state,
                               lora=self._lora(row))
        # the last valid row of the padded bucket, not the padded tail
        return table, logits[:, n - 1]

    def _lora(self, slot_ids: torch.Tensor) -> Optional[LoraState]:
        """The registry's resident stacks and scales read through
        ``slot_ids`` (None without a registry)."""
        if self.adapters is None:
            return None
        return LoraState(self.adapters.stacks(), slot_ids, self.adapters.scales(),
                         presplit=self.adapters.tp_slices is not None)

    def _pin_adapter(self, slot: Slot) -> None:
        """Pin the seated request's adapter (an eviction is refused while a
        request decodes under it) and point the slot's row of the host
        mirror at its stack row (admission, resume, an acquired hand-off)."""
        if self.adapters is not None:
            self.adapters.acquire(slot.request.adapter)
            self._slot_adapter[slot.index] = self.adapters.slot_of(slot.request.adapter)

    def _drop_adapter(self, slot: Slot) -> None:
        """The slot's row back to the identity and the request's pin
        released (finish, preemption, hand-off)."""
        self._slot_adapter[slot.index] = 0
        if self.adapters is not None:
            self.adapters.release(slot.request.adapter)

    def _sample_first(self, last: torch.Tensor, req: Request) -> int:
        temp = torch.full((1,), req.temperature, dtype=torch.float32, device=self.device)
        return int(sample_tokens(last, self._generator, temp, self.top_k, self.top_p)[0])

    # ------------------------------------------------------------------ #
    # chunked prefill
    # ------------------------------------------------------------------ #
    def _begin_chunked(self, slot: Slot) -> None:
        """Seat a request for chunked ingestion: stamp the prefill edge and
        leave ``cache_len`` at the cached prefix, so the slot is
        ``mid_prefill`` and :meth:`_chunked_prefill_step` feeds it."""
        req = slot.request
        cached = slot.cached_tokens
        self.span_log.on_prefill(req.request_id, self._now(), cached_prefix_tokens=cached)
        if cached and self.prefix_cache is not None:
            self.prefix_cache.tokens_saved_total += cached
        slot.cache_len = cached

    def _chunked_prefill_step(self, events: list[TokenEvent]) -> None:
        """Spend this step's prompt-token budget over the seats still in
        prefill, shortest remaining prompt first (then admission order,
        then slot index), so a short prompt behind a long one clears in its
        first step. A chunk whose blocks cannot be funded waits; with
        preemption, at most one seat a step is swapped out to fund it (the
        least progressed, often the waiting seat itself)."""
        budget = self.prefill_chunk_tokens
        pref = [s for s in self.scheduler.slots if s.busy and s.mid_prefill]
        if not pref:
            return
        pref.sort(key=lambda s: (len(s.request.prompt) - s.cache_len, s.admit_time, s.index))
        preempted = False
        for slot in pref:
            if budget <= 0:
                break
            if not slot.busy or not slot.mid_prefill:
                continue  # swapped out by this step's earlier preemption
            chunk = min(len(slot.request.prompt) - slot.cache_len, budget)
            if self._prefill_chunk(slot, chunk, events):
                budget -= chunk
                continue
            # every seat mid-prefill with the pool exhausted would wedge:
            # park the least progressed seat so the others can finish
            if self.preemption and not preempted:
                preempted = True
                victim = self.scheduler.preempt_candidate()
                if victim is None and not slot.resumed:
                    victim = slot
                if victim is not None:
                    self._preempt(victim, "growth")
                    if victim is not slot and self._prefill_chunk(slot, chunk, events):
                        budget -= chunk

    def _prefill_chunk(self, slot: Slot, chunk_len: int, events: list[TokenEvent]) -> bool:
        """One prefill call of ``chunk_len`` prompt tokens at the slot's
        cache offset (the bucketed prefill at an offset). The final chunk
        also funds the first decode write and any lookahead, and samples the
        request's first token; earlier chunks draw nothing from the
        generator. Returns False if the chunk's blocks cannot be funded."""
        req = slot.request
        prompt_len = len(req.prompt)
        start = slot.cache_len
        final = start + chunk_len == prompt_len
        if not self._ensure_blocks(slot, start + chunk_len + ((1 + slot.lookahead) if final
                                                               else 0)):
            return False
        for t in range(start // self.block_size, (start + chunk_len - 1) // self.block_size + 1):
            if t in slot.shared:
                self._cow_block(slot, t)
        table, last = self._prefill_call(slot, start, chunk_len)
        slot.cache_len = start + chunk_len
        slot.chunks += 1
        self._prefill_chunks_total += 1
        self._tables[slot.index] = table[0]
        self._tables_stale = True
        if final:
            token = self._sample_first(last, req)
            slot.pending = token
            slot.generated.append(token)
            if self.prefix_cache is not None and slot.chunks == 1:
                # one chunk is the unchunked bucket, so its blocks are
                # canonical; blocks written chunk by chunk stay out
                self.prefix_cache.publish(req.prompt, req.adapter, slot.blocks,
                                          skip_indices=slot.shared | slot.cow_indices,
                                          keys=req.prefix_keys)
            slot.first_token_time = self._now()
            self.span_log.on_first_token(req.request_id, slot.first_token_time,
                                         chunks=slot.chunks)
            if self._proposer is not None and slot.lookahead > 0:
                self._proposer.prefill_slot(slot)
            self.sampling.set_slot(slot.index, req.temperature)
            self._note_token(slot, token, events)
        return True

    def _ensure_blocks(self, slot: Slot, tokens: int) -> bool:
        """Grow the slot's table to cover ``tokens`` cache positions; False
        if the pool cannot fund it now."""
        need = self.pool.blocks_for_tokens(tokens) - len(slot.blocks)
        if need <= 0:
            return True
        if not self.pool.can_allocate(need):
            return False
        slot.blocks.extend(self.pool.allocate(need))
        self._tables[slot.index, :len(slot.blocks)] = slot.blocks
        self._tables_stale = True
        return True

    def _grow_active(self, active: list[Slot]) -> list[Slot]:
        """Under chunk-aware reservations decode itself can reach the pool's
        end: fund every active slot's next write (and lookahead) before the
        batch runs, preempting where needed."""
        eligible = [slot for slot in active if slot.busy and self._grow_or_preempt(slot)]
        # a later seat's growth may have swapped out one already vetted
        return [s for s in eligible if s.busy]

    def _grow_or_preempt(self, slot: Slot) -> bool:
        tokens = slot.cache_len + 1 + slot.lookahead
        if self._ensure_blocks(slot, tokens):
            return True
        # the victim order prefers seats not resumed (perhaps this one); a
        # resumed other seat is the last resort, against a wedged pool
        victim = self.scheduler.preempt_candidate()
        if victim is None and not slot.resumed:
            victim = slot
        if victim is None:
            others = [s for s in self.scheduler.slots if s.busy and not s.done and s is not slot]
            victim = min(others, key=lambda s: (s.request.priority, s.cache_len), default=None)
        if victim is None:
            return False  # the sole seat cannot grow: it waits this step
        self._preempt(victim, "growth")
        if victim is slot:
            return False
        return self._ensure_blocks(slot, tokens)

    # ------------------------------------------------------------------ #
    # preemption with KV swap
    # ------------------------------------------------------------------ #
    def _swap_index(self, blocks: list[int], kind: str) -> torch.Tensor:
        """``blocks`` padded with 0 (the garbage block) to the power-of-two
        width of their count, on the device; the swap program of that width
        is counted as built at its first use."""
        width = _next_pow2(len(blocks))
        self._swap_widths[kind].add(width)
        idx = np.zeros(width, np.int64)
        idx[:len(blocks)] = blocks
        return torch.from_numpy(idx).to(self.device)

    def _swap_out_blocks(self, blocks: list[int], whole: bool = False
                         ) -> tuple[list[torch.Tensor], int]:
        """The contents of ``blocks`` in every pool and scale array, copied
        to host memory (pinned on a CUDA device) before this returns:
        returns the host tensors (axis 1 the table position) and the whole
        model's bytes of them. Under tp a rank's images hold its kv heads;
        with ``whole`` (a hand-off) every kv head, gathered over tp."""
        n = len(blocks)
        idx = self._swap_index(blocks, "swap_out")
        pin = self.device.type == "cuda"
        data = []
        for t in self.cache.tensors():
            gathered = t.index_select(1, idx)[:, :n]
            if whole:
                gathered = self._whole_heads(gathered)
            host = torch.empty(gathered.shape, dtype=t.dtype, pin_memory=pin)
            host.copy_(gathered)  # synchronous: the ids are recycled next
            data.append(host)
        return data, self._whole_nbytes(data)

    # ------------------------------------------------------------------ #
    # the kv heads of a model split over tp
    # ------------------------------------------------------------------ #
    def _whole_nbytes(self, tensors) -> int:
        """Bytes of pool-shaped tensors (pools and their images, kv heads on
        axis 3) counted at every kv head of the model, as the reference
        counts a global array; scale arrays as they are."""
        heads = self.model.config.num_kv_heads
        return sum(t.nbytes // t.shape[3] * heads if t.dim() == 5 else t.nbytes
                   for t in tensors)

    def _whole_heads(self, t: torch.Tensor) -> torch.Tensor:
        """A pool image of this tp rank's kv heads as one of every kv head:
        each head written by the first rank that holds it and the rest
        zeros, summed over tp. Scale arrays are whole already."""
        if self._tp is None or t.dim() != 5:
            return t
        lo, hi = self._kv_spans[self._tp.rank]
        out = torch.zeros((*t.shape[:3], self.model.config.num_kv_heads, t.shape[4]),
                          dtype=t.dtype, device=t.device)
        first = max(lo, max((h for _, h in self._kv_spans[:self._tp.rank]), default=0))
        if first < hi:
            out[:, :, :, first:hi] = t[:, :, :, first - lo:]
        import torch.distributed as dist

        dist.all_reduce(out, group=self._tp.group)
        return out

    def _local_heads(self, t: torch.Tensor) -> torch.Tensor:
        """This tp rank's kv heads of a whole pool image (a manifest's)."""
        if self._tp is None or t.dim() != 5:
            return t
        lo, hi = self._kv_spans[self._tp.rank]
        return t[:, :, :, lo:hi]

    def _restore_blocks(self, blocks: list[int], data: list[torch.Tensor]) -> None:
        """Scatter saved images into ``blocks`` in place (table position i
        from image i); the padded rows write zeros to the garbage block."""
        n = len(blocks)
        idx = self._swap_index(blocks, "swap_in")
        for t, d in zip(self.cache.tensors(), data):
            src = torch.zeros((t.shape[0], idx.numel(), *t.shape[2:]), dtype=t.dtype,
                              device=self.device)
            src[:, :n].copy_(d)
            t.index_copy_(1, idx, src)

    def _preempt(self, slot: Slot, reason: str) -> None:
        """Swap ``slot`` out to host memory: copy its blocks' contents
        (shared ones too, so the resume does not depend on the cached chain
        surviving), park the request and the images, release the seat. The
        span stays open (state "preempted"); the queue and first-token
        stamps keep their values."""
        req = slot.request
        data, nbytes = self._swap_out_blocks(slot.blocks)
        entry = _SwappedRequest(
            request=req, generated=list(slot.generated), pending=slot.pending,
            cache_len=slot.cache_len, n_blocks=len(slot.blocks), data=data, chunks=slot.chunks,
            preempted_count=slot.preempted_count + 1, admit_time=slot.admit_time,
            first_token_time=slot.first_token_time, cached_tokens=slot.cached_tokens,
            swap_bytes=nbytes, preempt_time=self._now())
        self._swapped_reqs.append(entry)
        self._swap_bytes_held += nbytes
        self._preempt_counts[reason] = self._preempt_counts.get(reason, 0) + 1
        self.pool.swap_out(slot.blocks)
        slot.blocks = []  # released by swap_out: release() must not free them again
        self.span_log.on_preempt(req.request_id, entry.preempt_time)
        self._tele("record_preempt", request_id=req.request_id, reason=reason,
                   blocks=entry.n_blocks, swap_bytes=nbytes, cache_len=entry.cache_len,
                   priority=req.priority)
        self.sampling.clear_slot(slot.index)
        self._tables[slot.index] = 0
        self._tables_stale = True
        self._drop_adapter(slot)
        if self._proposer is not None:
            self._proposer.release(slot.index)
        self.scheduler.release(slot)  # frees the copy spare and clears the seat

    def _try_resume(self) -> None:
        """Seat swapped requests again, oldest first, while a free slot and
        their blocks are there. A resume never preempts. Without chunk-aware
        reservations the request's whole footprint is funded again, so it
        cannot run out of blocks in flight."""
        free_slots = [s for s in self.scheduler.slots if not s.busy]
        while self._swapped_reqs and free_slots:
            entry = self._swapped_reqs[0]
            req = entry.request
            if self.adapters is not None and not self.adapters.resident(req.adapter):
                break  # oldest first: no resume overtakes a tenant not loaded
            n = entry.n_blocks
            if self.scheduler.chunked_reserve:
                total = n
            else:
                total = max(n, self.pool.blocks_for_tokens(len(req.prompt) + req.max_new_tokens))
            if not self.pool.can_allocate(total):
                break
            self._swapped_reqs.pop(0)
            self._resume(free_slots.pop(0), entry, total - n)

    def _resume(self, slot: Slot, entry: _SwappedRequest, extra: int) -> None:
        req = entry.request
        blocks = self.pool.swap_in(entry.n_blocks)
        self._restore_blocks(blocks, entry.data)
        if extra > 0:
            blocks = blocks + self.pool.allocate(extra)
        slot.clear()
        slot.request = req
        slot.blocks = blocks
        slot.cache_len = entry.cache_len
        slot.generated = list(entry.generated)
        slot.pending = entry.pending
        slot.chunks = entry.chunks
        slot.preempted_count = entry.preempted_count
        slot.resumed = True
        slot.cached_tokens = entry.cached_tokens
        slot.admit_time = entry.admit_time
        slot.first_token_time = entry.first_token_time
        # restored images sit in block ids the content index does not know
        slot.cow_indices = set(range(len(blocks)))
        slot.lookahead = 0  # the draft's KV was not saved
        self._pin_adapter(slot)
        self.sampling.set_slot(slot.index, req.temperature)
        self._tables[slot.index] = 0
        self._tables[slot.index, :len(blocks)] = blocks
        self._tables_stale = True
        self._swap_bytes_held -= entry.swap_bytes
        self._resumes_total += 1
        self.span_log.on_resume(req.request_id, self._now())

    def _maybe_preempt(self, blocked_before: dict, exclude=()) -> bool:
        """At most one preemption a step to fund the queue head, and only
        when this step's admission blocked: any seat of strictly lower
        priority than the head, or, with a queue deadline and the head past
        half of it, a seat of equal priority when the pool blocked it."""
        sched = self.scheduler
        if not sched.queue:
            return False
        br = sched.blocked_reasons
        seat_blocked = br["no_free_slot"] > blocked_before["no_free_slot"]
        pool_blocked = br["pool_exhausted"] > blocked_before["pool_exhausted"]
        if not (seat_blocked or pool_blocked):
            return False
        head = sched.queue[0]
        victim = sched.preempt_candidate(max_priority=head.priority - 1, exclude=exclude)
        if victim is not None:
            self._preempt(victim, "priority")
            return True
        if (pool_blocked and sched.max_queue_delay_s is not None
                and self._now() - head.submit_time > 0.5 * sched.max_queue_delay_s):
            victim = sched.preempt_candidate(max_priority=head.priority, exclude=exclude)
            if victim is not None:
                self._preempt(victim, "pool")
                return True
        return False

    # ------------------------------------------------------------------ #
    # prefill/decode disaggregation
    # ------------------------------------------------------------------ #
    def _handoff_slot(self, slot: Slot) -> None:
        """Package a just-prefilled seat as a :class:`TransferManifest` and
        release it. The blocks the prompt wrote leave through the swap
        path's gather (int8 scale arrays with them), so the payload holds
        the bits a colocated engine would decode from; the chain keys make
        it content-addressed for the decode side's dedup. The seat and its
        blocks free at once: a prefill replica's pool funds ingestion only."""
        req = slot.request
        used = -(-slot.cache_len // self.block_size)
        data, nbytes = self._swap_out_blocks(slot.blocks[:used], whole=True)
        keys = req.prefix_keys
        if keys is None:
            # admission computes keys only with the prefix cache on; the
            # manifest needs them as its address regardless
            keys = prefix_keys(self._model_fingerprint, req.adapter, req.prompt, self.block_size)
        manifest = TransferManifest(
            request_id=req.request_id, prompt=tuple(req.prompt),
            max_new_tokens=req.max_new_tokens, temperature=req.temperature,
            eos_token_id=req.eos_token_id, adapter=req.adapter, priority=req.priority,
            keys=tuple(keys), fingerprint=self._model_fingerprint, block_size=self.block_size,
            n_blocks=used, cache_len=slot.cache_len, data=data, nbytes=nbytes,
            first_token=slot.pending, submit_time=req.submit_time, admit_time=slot.admit_time,
            first_token_time=slot.first_token_time, cached_tokens=slot.cached_tokens,
            prefill_chunks=slot.chunks)
        if self._plane is not None:
            manifest = self._plane.stage(manifest)
        self._outbox.append(manifest)
        self._transfer_stats["manifests_out"] += 1
        # this replica's part of the request ends at the hand-off (the
        # decode replica opens its own span)
        self.span_log.on_finish(req.request_id, self._now(), len(slot.generated),
                                accept_rate=None)
        self.sampling.clear_slot(slot.index)
        self._tables[slot.index] = 0
        self._tables_stale = True
        self._drop_adapter(slot)
        if self._proposer is not None:
            self._proposer.release(slot.index)
        self.scheduler.release(slot)

    def pop_manifests(self) -> list[TransferManifest]:
        """Take the prefill outbox (the router's transfer pump)."""
        out, self._outbox = self._outbox, []
        return out

    def acquire(self, manifest: TransferManifest) -> dict:
        """Accept a hand-off: seat the request now if a free slot and its
        blocks are there, else park it in the inbox (seated at a later
        :meth:`step`, before admission). Returns ``{"seated": bool}`` and,
        when seated, the dedup split: ``reused_blocks`` found in the local
        content index, ``moved_blocks`` restored from the manifest and their
        ``moved_bytes``."""
        res = self._try_seat_manifest(manifest)
        if res is None:
            self._inbox.append(manifest)
            self._transfer_stats["seat_deferred"] += 1
            return {"seated": False}
        return res

    def _seat_manifests(self) -> None:
        while self._inbox:
            if self._try_seat_manifest(self._inbox[0]) is None:
                break  # FIFO: nothing overtakes a large chain
            self._inbox.pop(0)

    def _try_seat_manifest(self, m: TransferManifest) -> Optional[dict]:
        free = [s for s in self.scheduler.slots if not s.busy]
        if not free:
            return None
        if self.adapters is not None and not self.adapters.resident(m.adapter):
            return None
        used = m.n_blocks
        full = m.cache_len // self.block_size  # the blocks with chain keys
        total = min(max(used, self.pool.blocks_for_tokens(len(m.prompt) + m.max_new_tokens)),
                    self._max_table)
        # warm-prefix dedup: chain blocks already in the content index are
        # acquired (refcounted) instead of moved; the keys address the
        # contents, so only the tail is scattered in
        hits = self.pool.lookup(list(m.keys)[:full])
        reused = len(hits)
        if hits:
            self.pool.acquire(hits)
        if not self.pool.can_allocate(total - reused):
            if hits:
                self.pool.free(hits)
            return None
        new = self.pool.allocate(total - reused)
        tail = used - reused
        moved_bytes = m.bytes_per_block() * tail
        if tail:
            self._restore_blocks(new[:tail],
                                 [self._local_heads(d[:, reused:used]) for d in m.data])
        # index the restored full prompt blocks: the next manifest of this
        # chain dedups against them (a decode pool never prefills, so this
        # is its whole warm set)
        published: set = set()
        if self.prefix_cache is not None:
            for i in range(reused, full):
                self.pool.publish(new[i - reused], m.keys[i])
                published.add(i)
        req = Request(prompt=list(m.prompt), max_new_tokens=m.max_new_tokens,
                      temperature=m.temperature, eos_token_id=m.eos_token_id,
                      request_id=m.request_id, adapter=m.adapter, priority=m.priority)
        req.submit_time = m.submit_time
        req.prefix_keys = list(m.keys)
        slot = free[0]
        slot.clear()
        slot.request = req
        slot.blocks = list(hits) + new
        slot.cache_len = m.cache_len
        slot.generated = [m.first_token]
        slot.pending = m.first_token
        slot.chunks = m.prefill_chunks
        slot.cached_tokens = m.cached_tokens
        slot.admit_time = m.admit_time
        slot.first_token_time = m.first_token_time
        # every position decode must copy before writing: the acquired hits
        # and the blocks just published (the first write, at cache_len, lies
        # past all of them)
        slot.shared = set(range(reused)) | published
        self._pin_adapter(slot)
        self.sampling.set_slot(slot.index, req.temperature)
        self._tables[slot.index] = 0
        self._tables[slot.index, :len(slot.blocks)] = slot.blocks
        self._tables_stale = True
        # replay the request's life on this replica's span log with the
        # manifest's stamps, so queue and TTFT accounting stay whole
        self.span_log.on_submit(req.request_id, m.submit_time, len(m.prompt), adapter_id=m.adapter)
        self.span_log.on_admit(req.request_id, m.admit_time)
        self.span_log.on_prefill(req.request_id, m.first_token_time,
                                 cached_prefix_tokens=m.cached_tokens)
        self.span_log.on_first_token(req.request_id, m.first_token_time)
        if m.eos_token_id is not None and m.first_token == m.eos_token_id:
            slot.done = True  # the prefill side keeps these; defensive
            slot.finish_time = self._now()
        if m.max_new_tokens <= 1:
            slot.done = True
            slot.finish_time = self._now()
        stats = self._transfer_stats
        stats["manifests_in"] += 1
        stats["blocks_deduped"] += reused
        stats["blocks_moved"] += tail
        stats["bytes_moved"] += moved_bytes
        return {"seated": True, "reused_blocks": reused, "moved_blocks": tail,
                "moved_bytes": moved_bytes}

    def transfer_gauges(self) -> dict:
        """Cumulative hand-off accounting, both directions."""
        return dict(self._transfer_stats, transfer_inbox_depth=len(self._inbox),
                    transfer_outbox_depth=len(self._outbox))

    def _decode_forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """The model over the static buffers: (max_slots, width, V) logits."""
        buf = self._decode_in
        return self._forward(tokens, self.cache,
                             paged=self._state(buf["tables"], buf["cache_lens"], buf["lengths"]),
                             lora=self._lora(buf["slot_ids"]))

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
        if self.adapters is not None:
            buf["slot_ids"].copy_(torch.from_numpy(self._slot_adapter))
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
            "adapter_id": req.adapter,
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
            "preempted_count": slot.preempted_count,
            "prefill_chunks": slot.chunks,
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
        self._drop_adapter(slot)
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
        self._tele("record_shed", request_id=req.request_id, adapter_id=req.adapter, reason=reason,
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
        only, no device sync. The keys are the reference's. A prefill or
        decode engine adds its role
        and :meth:`transfer_gauges`; a colocated one's keys stay as they
        were."""
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
        fields = {
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
            "admission_blocked_adapter_not_resident_total":
                sched.blocked_reasons["adapter_not_resident"],
            "adapters_resident": (len(self.adapters.resident_names())
                                  if self.adapters is not None else 0),
            "shed_queue_full_total": sched.shed_counts["queue_full"],
            "shed_queue_deadline_total": sched.shed_counts["queue_deadline"],
            "spec_rounds": self._spec_rounds_total,
            "spec_tokens_proposed": proposed,
            "spec_tokens_accepted": self._spec_accepted_total,
            "spec_accept_rate": self._spec_accepted_total / proposed if proposed else 0.0,
            "swapped_blocks": pool["swapped"],
            "swapped_requests": len(self._swapped_reqs),
            "swap_bytes_held": self._swap_bytes_held,
            "preempts_total": sum(self._preempt_counts.values()),
            "preempts_priority_total": self._preempt_counts["priority"],
            "preempts_pool_total": self._preempt_counts["pool"],
            "preempts_growth_total": self._preempt_counts["growth"],
            "resumes_total": self._resumes_total,
            "prefill_chunks_total": self._prefill_chunks_total,
            "kv_bytes_per_token": self.kv_bytes_per_token,
        }
        if self._role != "colocated":
            fields["role"] = self._role
            fields.update(self.transfer_gauges())
        return fields

    def _sample_gauges(self) -> None:
        self._tele("record_serve_gauge", **self._gauge_fields())
        self._tele("sample_memory")  # throttled by the collector's clock

    def _emit_slo(self) -> None:
        self._tele("record_slo", **self.slo_tracker.snapshot(self._now()))

    def _census_kv(self):
        """The KV cache as the census counts it: its pools and scale arrays;
        under tp each pool as a DTensor view of every kv head over the
        rank's storage, so the census (which counts a DTensor at its whole
        size) reads the whole model's bytes and the device's are the
        rank's. The views are made once: the pools are never rebound."""
        if self._tp is None:
            return self.cache
        if self._census_views is None:
            from torch.distributed.tensor import DTensor, Replicate, Shard

            from ..utils.constants import MESH_AXIS_TENSOR

            mesh = next(p.device_mesh for p in self.model.parameters()
                        if hasattr(p, "device_mesh"))
            placements = [Shard(3) if name == MESH_AXIS_TENSOR else Replicate()
                          for name in mesh.mesh_dim_names]
            heads = self.model.config.num_kv_heads
            views = []
            for t in self.cache.tensors():
                if t.dim() == 5:
                    shape = (*t.shape[:3], heads, t.shape[4])
                    t = DTensor.from_local(t, mesh, placements, run_check=False, shape=shape,
                                           stride=torch.empty(shape, device="meta").stride())
                views.append(t)
            self._census_views = views
        return self._census_views

    def _register_census_owners(self) -> None:
        """Point the telemetry's buffer census (if it has one) at the
        engine's parameters, its KV cache (pools and int8 scale arrays) and
        a draft model's pools and parameters. The providers read the live
        attributes at sample time."""
        census = getattr(self._telemetry, "census", None)
        if census is None:
            return
        census.set_owner("params", lambda: self.model)
        census.set_owner("kv_cache", self._census_kv)
        census.set_owner("adapter_stack", lambda: (
            (self.adapters.stacks(), self.adapters.scales())
            if self.adapters is not None else None))
        census.set_owner("draft_pool", lambda: (
            (getattr(self._proposer, "cache", None), getattr(self._proposer, "model", None))
            if self._proposer is not None else None))

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
        self._register_census_owners()

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
    # the router's hooks
    # ------------------------------------------------------------------ #
    def drain(self) -> list:
        """Enter drain mode: admission stops (:meth:`health` reads
        ``draining``, new submits shed with reason ``"draining"``), seated
        requests decode to the end, and the unadmitted queue is harvested
        and returned for the caller (a router) to place elsewhere."""
        self.scheduler.draining = True
        return self.scheduler.harvest_queue()

    def undrain(self) -> None:
        """Leave drain mode: admission resumes."""
        self.scheduler.draining = False

    @property
    def draining(self) -> bool:
        return self.scheduler.draining

    def health(self) -> dict:
        """The ``/healthz`` body: ``ok`` stays true while draining (the
        process is healthy, it takes no traffic); routers key rotation and
        ejection off ``state``."""
        return {"ok": True, "state": "draining" if self.scheduler.draining else "serving"}

    def prefix_digest(self, max_entries: int = 512) -> dict:
        """The ``/debug/prefix`` body: a bounded digest of the cached chain
        keys for the router's overlap scoring. The keys are fingerprint-
        and adapter-scoped rolling hashes, so no raw token shows and none
        matches across tenants."""
        digest = self.pool.cached_chain_digest(max_entries)
        digest["fingerprint"] = self._model_fingerprint
        digest["enabled"] = self.prefix_cache is not None
        return digest

    # ------------------------------------------------------------------ #
    # planes not ported yet
    # ------------------------------------------------------------------ #
    def start_http(self, *args, **kwargs):
        raise _not_ported("the HTTP plane: start_http", "A10")

    def capture_programs(self, *args, **kwargs):
        raise _not_ported("capture_programs", "A10")

    def audit_programs(self, *args, **kwargs):
        raise _not_ported("audit_programs", "A10")

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
