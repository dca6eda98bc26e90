"""Autoregressive generation with the dense decode cache.

Port of ``accelerate_tpu/models/generation.py``: ``_filter_logits`` (:23),
``_sample_logits`` (:44), ``init_cache`` (:52), ``generate`` (:63),
``_prompt_chunks`` (:127) and ``make_generate_fn`` (:139). ``generate`` is
a Python loop in place of ``lax.scan``. ``make_generate_fn`` prefills in
power-of-two chunks and runs its decode step as one CUDA graph per batch
size (``utils/cuda_graph.StepProgram``) where the reference jits it.

Sampling draws from an explicit ``torch.Generator`` on the model's device,
by Gumbel-max over the filtered logits: no ``torch.multinomial``, whose
device assert a row of -inf or NaN would fire. Random streams therefore
differ from the reference's ``jax.random``; greedy decoding (temperature 0)
is the reference's argmax exactly. The model's parameters live in the
module, so the reference's ``params`` argument has no counterpart.

A model that ``Accelerator.prepare`` sharded under a ``ParallelismPlugin``
(its parameters DTensors) decodes as the reference's ``generate`` on
sharded params does: every rank of the mesh takes the same whole prompt
and returns the same tokens. Each forward runs inside the model's sharded
context (``parallel.runtime.module_forward``): a layer's fsdp shards are
gathered as it runs, the products stay split over tp, and each tp rank's
cache holds only the kv heads its query heads read
(``models.transformer._tp_heads``). No tp-split weight is gathered: the tp
group carries the activations' sums and one gather of the logits a step.
The paged pools of ``init_cache`` (the serving engine's) split the same way.

``generate`` and ``make_generate_fn`` run ``GPT2LM`` as they run
``CausalLM``: its ``wpe`` position under decode is the dense cache's index,
so the captured decode step reads it on the card. ``init_cache`` also makes
``Seq2SeqLM``'s decode state (``source_len``: the decoder's self-attention
cache and the cross-attention's keys and values), which its own greedy
``generate`` steps.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.attention import PagedKVCache
from ..parallel import runtime as _shard
from ..utils.cuda_graph import StepProgram
from .seq2seq import Seq2SeqCache, Seq2SeqLM
from .transformer import CausalLM, DecodeCache, _dtype, _tp_heads


def _filter_logits(logits: torch.Tensor, top_k: Optional[int],
                   top_p: Optional[float]) -> torch.Tensor:
    """(B, V) fp32 logits -> the same, with everything outside the top-k /
    nucleus set at -inf. Shared with the serving sampler."""
    if top_k is not None and top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if top_p is not None and top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # the smallest set with cumulative probability >= top_p; the cutoff
        # is the logit of the last token inside it
        include = cum - probs < top_p
        cutoff = torch.where(include, sorted_logits, float("inf")).min(
            dim=-1, keepdim=True).values
        logits = torch.where(logits < cutoff, float("-inf"), logits)
    return logits


def _gumbel_argmax(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """(B, V) fp32 logits -> (B,) draws from softmax(logits): argmax of the
    logits plus Gumbel noise, one noise row per row of the batch. The
    uniform draw is kept off 0, so the noise is finite and a -inf logit is
    never drawn."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _sample_logits(logits: torch.Tensor, generator: torch.Generator, temperature: float,
                   top_k: Optional[int], top_p: Optional[float]) -> torch.Tensor:
    """(B, V) logits -> (B,) token ids."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = _filter_logits(logits.float() / temperature, top_k, top_p)
    return _gumbel_argmax(logits, generator)


def _device(model: CausalLM) -> torch.device:
    return _shard.to_local(next(model.parameters())).device


def _forward(model: CausalLM):
    """``step(ids, cache, **kw) -> logits``: the model's decode forward
    (``kw``: the paged state and adapters), inside its sharded context
    when its parameters are DTensors."""
    if not _shard.is_sharded_module(model):
        return lambda ids, cache, **kw: model(ids, decode=True, cache=cache, **kw)

    def step(ids, cache, **kw):
        with _shard.module_forward(model) as params:
            return torch.func.functional_call(model, params, (ids,),
                                              {"decode": True, "cache": cache, **kw})

    return step


def _cache_kv_heads(model: CausalLM) -> int:
    """The kv heads a decode cache of ``model`` holds: this tp rank's share
    of a model sharded over tp, else all."""
    cfg = model.config
    if _shard.is_sharded_module(model):
        tp = _shard.module_layout(model).tp
        if tp.size > 1:
            return _tp_heads(cfg, tp).kv_heads
    return cfg.num_kv_heads


def init_cache(model: CausalLM, batch_size: int = 1, *, num_blocks: Optional[int] = None,
               block_size: Optional[int] = None, kv_dtype: str = "native",
               source_len: Optional[int] = None):
    """A zeroed cache on the model's device, in its compute dtype: the dense
    decode cache for ``batch_size`` rows of ``max_seq_len``, or, given
    ``num_blocks`` and ``block_size``, the paged block pools (int8 codes and
    their fp32 scale arrays with ``kv_dtype="int8"``). Under tp either holds
    this rank's kv heads only (:func:`_cache_kv_heads`); the paged pools'
    blocks, and the int8 scale arrays, are whole on every rank. For a
    ``Seq2SeqLM``, its ``Seq2SeqCache`` over sources of ``source_len``."""
    cfg = model.config
    if isinstance(model, Seq2SeqLM):
        if source_len is None:
            raise ValueError("a Seq2SeqLM's cache needs the source length: source_len=")
        return Seq2SeqCache.zeros(cfg, batch_size, source_len, _device(model),
                                  _cache_kv_heads(model))
    if num_blocks is None:
        return DecodeCache.zeros(cfg, batch_size, _device(model), _cache_kv_heads(model))
    return PagedKVCache.zeros(cfg.num_layers, num_blocks, block_size, _cache_kv_heads(model),
                              cfg.head_dim, _dtype(cfg), _device(model), kv_dtype=kv_dtype)


def _check_length(model: CausalLM, prompt_len: int, max_new_tokens: int) -> None:
    if prompt_len + max_new_tokens > model.config.max_seq_len:
        raise ValueError(
            f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens}) "
            f"exceeds max_seq_len ({model.config.max_seq_len})"
        )


def _continue(first, step, max_new_tokens, eos_token_id, sample):
    """The decode loop shared by both entry points: ``first`` sampled from
    the prompt's last logits, then ``max_new_tokens - 1`` calls of
    ``step(token) -> logits``; after an EOS a row repeats EOS. Returns
    (B, max_new_tokens) ids, with no host sync."""
    done = (first == eos_token_id if eos_token_id is not None
            else torch.zeros_like(first, dtype=torch.bool))
    tokens, token = [first], first
    for _ in range(max_new_tokens - 1):
        nxt = sample(step(token))
        if eos_token_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_token_id), nxt)
            done = done | (nxt == eos_token_id)
        tokens.append(nxt)
        token = nxt
    return torch.stack(tokens, dim=1)


@torch.no_grad()
def generate(model: CausalLM, input_ids, max_new_tokens: int = 32, temperature: float = 0.0,
             top_k: Optional[int] = None, top_p: Optional[float] = None,
             eos_token_id: Optional[int] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Generate continuations; returns (B, prompt_len + max_new_tokens) ids
    on the model's device. The prompt must fit ``config.max_seq_len -
    max_new_tokens``. After an EOS a row is padded with EOS. ``generator``
    (on the model's device; a fresh one seeded 0 if None) is drawn from
    only when ``temperature > 0``."""
    device = _device(model)
    ids = torch.as_tensor(input_ids, device=device).long()
    B, prompt_len = ids.shape
    _check_length(model, prompt_len, max_new_tokens)
    generator = generator if generator is not None else torch.Generator(device).manual_seed(0)
    cache = init_cache(model, B)

    forward = _forward(model)

    def sample(logits):
        return _sample_logits(logits, generator, temperature, top_k, top_p)

    first = sample(forward(ids, cache)[:, -1])
    new = _continue(first, lambda tok: forward(tok[:, None], cache)[:, -1],
                    max_new_tokens, eos_token_id, sample)
    return torch.cat([ids, new], dim=1)


def _prompt_chunks(prompt_len: int) -> list[int]:
    """Descending power-of-two decomposition of a prompt length (13 ->
    [8, 4, 1]): the chunk widths every prompt can be prefilled with."""
    chunks, width = [], 1 << (max(prompt_len, 1).bit_length() - 1)
    while prompt_len:
        if width <= prompt_len:
            chunks.append(width)
            prompt_len -= width
        width >>= 1
    return chunks


def make_generate_fn(model: CausalLM, max_new_tokens: int = 32, temperature: float = 0.0,
                     top_k: Optional[int] = None, top_p: Optional[float] = None,
                     eos_token_id: Optional[int] = None):
    """A generate closure that builds its programs once:
    ``fn(input_ids, generator=None) -> ids``.

    Prefill runs the prompt as descending power-of-two chunks at their true
    cache offsets (13 tokens -> 8, 4, 1; exact, not padded), so across any
    mix of prompt lengths at most ``log2(max_seq_len)`` chunk widths occur
    per batch size. The decode step is built once per batch size over a
    cache kept for that size and emptied in place on every call: on the
    card one CUDA graph, replayed for every token, with sampling after the
    replay. ``fn.trace_counts()`` gives ``{"prefill": distinct (batch,
    width) chunks, "decode": decode programs built}``, the reference's
    trace counters; ``fn.decode_programs`` maps a batch size to its
    (cache, token buffer, program), for inspection.
    """
    traces = {"prefill": 0, "decode": 0}
    chunk_shapes: set[tuple[int, int]] = set()
    programs: dict[int, tuple] = {}
    device = _device(model)
    forward = _forward(model)

    def decode_program(batch: int):
        if batch not in programs:
            cache = init_cache(model, batch)
            token = torch.zeros((batch, 1), dtype=torch.long, device=device)
            with torch.no_grad():
                # the capture's warm-up call writes at index 0 of a cache
                # every call resets first
                program = StepProgram(lambda: forward(token, cache)[:, -1], device)
            traces["decode"] += 1
            programs[batch] = (cache, token, program)
        return programs[batch]

    @torch.no_grad()
    def fn(input_ids, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        ids = torch.as_tensor(input_ids, device=device).long()
        B, prompt_len = ids.shape
        _check_length(model, prompt_len, max_new_tokens)
        if generator is None:
            generator = torch.Generator(device).manual_seed(0)
        cache, token_buf, program = decode_program(B)
        cache.reset()
        offset = 0
        for width in _prompt_chunks(prompt_len):
            if (B, width) not in chunk_shapes:
                chunk_shapes.add((B, width))
                traces["prefill"] += 1
            last = forward(ids[:, offset:offset + width], cache)[:, -1]
            offset += width

        def sample(logits):
            return _sample_logits(logits, generator, temperature, top_k, top_p)

        def step(token):
            token_buf.copy_(token[:, None])
            return program()

        new = _continue(sample(last), step, max_new_tokens, eos_token_id, sample)
        return torch.cat([ids, new], dim=1)

    fn.trace_counts = lambda: dict(traces)
    fn.decode_programs = programs
    return fn
