"""Block-granular KV hand-off between prefill and decode replicas.

Port of ``accelerate_tpu/serving/transfer.py``: ``TransferManifest`` (:47),
``_TransferRecord`` (:92) and ``TransferPlane`` (:104-237).

Prefill/decode disaggregation (Mooncake, DistServe) splits a fleet into two
pools: prefill replicas ingest prompts and publish each finished KV chain
as a :class:`TransferManifest`; decode replicas ``acquire()`` one and seat
the request straight into the decode batch. The manifest is the
content-addressed chain: the rolling key of every full prompt block, and
each block's contents in every cache tensor as the swap path copies them
to host memory (int8 scale arrays included). A decode replica that holds
a prefix block already (its content index) takes it by reference, so only
the tail moves.

:class:`TransferPlane` moves the payload and keeps the books:

* ``inprocess``: the manifests' host tensors pass by reference between
  engines of one process (the CPU tests; the ``disagg_soak`` arms on the
  virtual clock);
* ``host_buffer``: :meth:`TransferPlane.stage` copies each tensor into a
  fresh contiguous host tensor, so the payload owns its memory apart from
  the prefill engine's (what a cross-process transport would register);
  the decode side's copy to the card is the engine's scatter-restore.

Both backends keep the same books: bytes moved, blocks moved and deduped,
milliseconds a transfer, stalls and drops (``kind="transfer"`` records
through an attached telemetry).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

_BACKENDS = ("inprocess", "host_buffer")


@dataclass
class TransferManifest:
    """One finished prefill packaged for hand-off: the request's identity
    and sampling options, the chain key of every full prompt block (the
    dedup currency), the blocks' contents (``data``: one host tensor a
    cache tensor, in ``PagedKVCache.tensors()`` order, axis 1 the block's
    table position, pools and int8 scale arrays alike) and the clock stamps
    that keep TTFT and e2e accounting whole across the hop."""

    request_id: str
    prompt: tuple
    max_new_tokens: int
    temperature: float
    eos_token_id: Optional[int]
    adapter: Optional[str]
    priority: int
    keys: tuple
    fingerprint: str
    block_size: int
    # the chain: n_blocks blocks covering cache_len written tokens
    n_blocks: int
    cache_len: int
    data: list
    nbytes: int
    # decode continues from the token the prefill side sampled
    first_token: int
    submit_time: float
    admit_time: float
    first_token_time: float
    cached_tokens: int
    prefill_chunks: int
    src: str = ""

    def bytes_per_block(self) -> int:
        return self.nbytes // self.n_blocks if self.n_blocks else 0


@dataclass
class _TransferRecord:
    """An in-flight entry of the router's ledger."""

    manifest: TransferManifest
    started_at: float
    state: str = "pending"  # pending | stalled | delivered | dropped
    dst: str = ""
    done_at: float = 0.0
    moved_blocks: int = 0
    deduped_blocks: int = 0
    moved_bytes: int = 0
    attempts: int = 0


class TransferPlane:
    """Moves manifest payloads and keeps the books. Placement is the
    router's; the plane holds the byte-movement contract, cumulative
    counters, a bounded window of per-transfer milliseconds and the
    ``kind="transfer"`` records."""

    def __init__(self, backend: str = "inprocess", *, telemetry: Any = None,
                 now: Callable[[], float] = time.monotonic, max_samples: int = 4096):
        if backend not in _BACKENDS:
            raise ValueError(f"backend must be one of {_BACKENDS}, got {backend!r}")
        self.backend = backend
        self._telemetry = telemetry
        self._now = now
        self.transfers_total = 0
        self.bytes_moved_total = 0
        self.blocks_moved_total = 0
        self.blocks_deduped_total = 0
        self.stalls_total = 0
        self.stall_seconds_total = 0.0
        self.drops_total = 0
        self._ms_samples: list[float] = []
        self._max_samples = max_samples

    # ------------------------------------------------------------------ #
    # byte movement
    # ------------------------------------------------------------------ #
    def stage(self, manifest: TransferManifest) -> TransferManifest:
        """Ready a manifest's payload for the wire: ``inprocess`` passes the
        host tensors by reference; ``host_buffer`` copies each into a fresh
        contiguous host tensor that owns its memory."""
        if self.backend == "inprocess":
            return manifest
        manifest.data = [d.clone(memory_format=torch.contiguous_format) for d in manifest.data]
        return manifest

    def record_delivery(self, manifest: TransferManifest, *, src: str, dst: str,
                        moved_blocks: int, deduped_blocks: int, moved_bytes: int,
                        ms: float) -> None:
        self.transfers_total += 1
        self.bytes_moved_total += moved_bytes
        self.blocks_moved_total += moved_blocks
        self.blocks_deduped_total += deduped_blocks
        self._ms_samples.append(ms)
        if len(self._ms_samples) > self._max_samples:
            del self._ms_samples[: len(self._ms_samples) - self._max_samples]
        self._tele("record_transfer", request_id=manifest.request_id, src=src, dst=dst,
                   bytes=moved_bytes, blocks_moved=moved_blocks,
                   blocks_deduped=deduped_blocks, transfer_ms=ms)

    def record_stall(self, secs: float, replica: Optional[str] = None) -> None:
        self.stalls_total += 1
        self.stall_seconds_total += secs
        self._tele("record_transfer_stall", secs=secs, replica=replica or "")

    def record_drop(self, manifest: TransferManifest, reason: str) -> None:
        self.drops_total += 1
        self._tele("record_transfer_drop", request_id=manifest.request_id, reason=reason)

    def _tele(self, method: str, **fields) -> None:
        if self._telemetry is None:
            return
        fn = getattr(self._telemetry, method, None)
        if fn is not None:
            fn(**fields)

    # ------------------------------------------------------------------ #
    # the books
    # ------------------------------------------------------------------ #
    @property
    def dedup_ratio(self) -> float:
        handled = self.blocks_moved_total + self.blocks_deduped_total
        return self.blocks_deduped_total / handled if handled else 0.0

    def summary(self) -> dict:
        samples = sorted(self._ms_samples)

        def pct(p: float) -> float:
            if not samples:
                return 0.0
            rank = p * (len(samples) - 1)
            lo = int(rank)
            hi = min(lo + 1, len(samples) - 1)
            return samples[lo] + (samples[hi] - samples[lo]) * (rank - lo)

        return {
            "backend": self.backend,
            "transfers_total": self.transfers_total,
            "bytes_moved_total": self.bytes_moved_total,
            "blocks_moved_total": self.blocks_moved_total,
            "blocks_deduped_total": self.blocks_deduped_total,
            "dedup_ratio": self.dedup_ratio,
            "transfer_ms_p50": pct(0.50),
            "transfer_ms_p95": pct(0.95),
            "stalls_total": self.stalls_total,
            "stall_seconds_total": self.stall_seconds_total,
            "drops_total": self.drops_total,
        }
