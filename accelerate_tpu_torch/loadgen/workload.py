"""Replayable workload model for the soak harness.

Host-only copy of ``accelerate_tpu/loadgen/workload.py``. One seed pins
everything: cohort prefixes, prompt bodies, output budgets, adapter
names and the arrival times. Two calls of :func:`build_trace` with the same
``(workload, phases, seed)`` return equal traces, and the same traces as
the reference's (numpy's ``default_rng`` draws in the same order), so a
soak can be replayed and compared across the packages.

The shape follows templated production traffic:

* cohorts: ``num_cohorts`` block-aligned system prompts; a
  ``cohort_fraction`` of requests opens with one, so a prefix cache sees
  reuse under load;
* a long tail: prompt-body and output lengths are Pareto-tailed around a
  median;
* long-prompt bursts: a ``long_prompt_fraction`` of requests carries a
  body of ``long_prompt_tokens``, the traffic chunked prefill is for;
* tenants: an ``adapter_fraction`` of requests names one of ``adapters``.

Arrivals are open loop: inter-arrival gaps come from the phase's arrival
process (Poisson or a uniform metronome), independent of completions, so
a slow engine shows as arrival lag and queueing, never as stretched gaps.
"""


from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Sequence

import numpy as np

from .phases import Phase, phase_bounds


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    """Knobs of the request-population model (see module docstring).

    ``max_total_tokens`` clamps ``len(prompt) + max_new_tokens`` so every
    generated request is admissible on the target engine (the scheduler
    rejects requests beyond ``(num_blocks - 1) * block_size``).
    """

    vocab_size: int = 256
    num_cohorts: int = 4
    prefix_tokens: int = 16           # templated cohort prefix length
    cohort_fraction: float = 0.5      # share of requests opening with one
    prompt_tokens_min: int = 2
    prompt_tokens_median: int = 6     # body length (excl. cohort prefix)
    prompt_tokens_max: int = 48
    output_tokens_min: int = 2
    output_tokens_median: int = 6
    output_tokens_max: int = 32
    tail_alpha: float = 2.0           # Pareto tail index (smaller = fatter)
    adapters: tuple = ()              # tenant names to mix in
    adapter_fraction: float = 0.0     # share of requests naming a tenant
    # long-prompt burst: this share of requests carries a GIANT
    # body of ``long_prompt_tokens`` (default: prompt_tokens_max) drawn
    # deterministically instead of from the Pareto tail — the traffic
    # that makes unchunked prefill hold every short request's TTFT
    # hostage, and the A/B axis the chunked-prefill soak runs on
    long_prompt_fraction: float = 0.0
    long_prompt_tokens: Optional[int] = None
    max_total_tokens: Optional[int] = None

    def __post_init__(self):
        if self.vocab_size < 2:
            raise ValueError("vocab_size must be >= 2")
        if self.num_cohorts < 0 or self.prefix_tokens < 0:
            raise ValueError("num_cohorts/prefix_tokens must be >= 0")
        for frac in (self.cohort_fraction, self.adapter_fraction,
                     self.long_prompt_fraction):
            if not (0.0 <= frac <= 1.0):
                raise ValueError("fractions must be in [0, 1]")
        if (
            self.long_prompt_tokens is not None
            and self.long_prompt_tokens < self.prompt_tokens_min
        ):
            raise ValueError(
                "long_prompt_tokens must be >= prompt_tokens_min"
            )
        if self.adapter_fraction > 0 and not self.adapters:
            raise ValueError("adapter_fraction > 0 needs adapter names")
        if self.prompt_tokens_min < 1 or self.output_tokens_min < 1:
            raise ValueError("minimum lengths must be >= 1")
        if self.tail_alpha <= 0:
            raise ValueError("tail_alpha must be > 0")


@dataclasses.dataclass(frozen=True)
class SoakRequest:
    """One scheduled request of the trace (hashable, comparable — the
    determinism test compares whole traces with ``==``)."""

    index: int
    arrival_s: float       # scheduled arrival, relative to run start
    phase: str
    cohort: int            # -1 = no templated prefix
    prompt: tuple          # token ids
    max_new_tokens: int
    adapter: Optional[str] = None


def _tail_len(rng, lo: int, median: int, hi: int, alpha: float) -> int:
    """Pareto-tailed length: median-ish body, occasional near-``hi``
    outlier — the long-tail mix that makes run-to-completion batching
    (and any latency percentile) interesting."""
    draw = lo + (median - lo) * (1.0 + float(rng.pareto(alpha)))
    return int(min(hi, max(lo, round(draw))))


def build_trace(
    workload: WorkloadConfig,
    phases: Sequence[Phase],
    seed: int = 0,
) -> list[SoakRequest]:
    """The full request trace for one soak run, arrivals included.

    One ``default_rng(seed)`` drives everything in a fixed draw order,
    so the trace is a pure function of ``(workload, phases, seed)``.
    """
    rng = np.random.default_rng(seed)
    cohorts = [
        tuple(
            int(t)
            for t in rng.integers(1, workload.vocab_size, workload.prefix_tokens)
        )
        for _ in range(workload.num_cohorts)
    ]
    trace: list[SoakRequest] = []
    t = 0.0
    for phase, start_s, end_s in phase_bounds(phases):
        t = max(t, start_s)
        if phase.rate_rps <= 0:
            t = end_s
            continue
        while True:
            if phase.process == "poisson":
                gap = float(rng.exponential(1.0 / phase.rate_rps))
            else:  # "uniform": deterministic metronome
                gap = 1.0 / phase.rate_rps
            if t + gap >= end_s:
                t = end_s
                break
            t += gap
            trace.append(_draw_request(rng, workload, cohorts, len(trace), t, phase))
    return trace


def _draw_request(rng, workload, cohorts, index, arrival_s, phase):
    cohort = -1
    prefix: tuple = ()
    if cohorts and float(rng.random()) < workload.cohort_fraction:
        cohort = int(rng.integers(len(cohorts)))
        prefix = cohorts[cohort]
    # burst giants draw their coin only when the knob is on, so traces
    # generated before the knob existed replay bit-identically
    if (
        workload.long_prompt_fraction > 0.0
        and float(rng.random()) < workload.long_prompt_fraction
    ):
        body_len = (
            workload.long_prompt_tokens
            if workload.long_prompt_tokens is not None
            else workload.prompt_tokens_max
        )
    else:
        body_len = _tail_len(
            rng, workload.prompt_tokens_min, workload.prompt_tokens_median,
            workload.prompt_tokens_max, workload.tail_alpha,
        )
    body = tuple(int(t) for t in rng.integers(1, workload.vocab_size, body_len))
    max_new = _tail_len(
        rng, workload.output_tokens_min, workload.output_tokens_median,
        workload.output_tokens_max, workload.tail_alpha,
    )
    adapter = None
    if workload.adapters and float(rng.random()) < workload.adapter_fraction:
        adapter = workload.adapters[int(rng.integers(len(workload.adapters)))]
    prompt = prefix + body
    if workload.max_total_tokens is not None:
        budget = workload.max_total_tokens
        if len(prompt) + max_new > budget:
            keep = max(1, budget - max_new)
            prompt = prompt[:keep]
            max_new = max(1, min(max_new, budget - len(prompt)))
    return SoakRequest(
        index=index,
        arrival_s=round(arrival_s, 9),
        phase=phase.name,
        cohort=cohort,
        prompt=prompt,
        max_new_tokens=max_new,
        adapter=adapter,
    )


def trace_fingerprint(trace: Sequence[SoakRequest]) -> str:
    """Order-sensitive sha256 over every field of every request — the
    value the soak report embeds so a re-run can prove (or disprove)
    that it replayed the identical traffic."""
    # the reference's seed bytes, so equal traces give the reference's hash
    h = hashlib.sha256(b"accelerate_tpu.loadgen.trace\x00")
    for r in trace:
        h.update(
            repr((r.index, r.arrival_s, r.phase, r.cohort, r.prompt,
                  r.max_new_tokens, r.adapter)).encode()
        )
    return h.hexdigest()
