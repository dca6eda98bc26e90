"""The encoder-decoder LM (T5/BART family).

Port of ``accelerate_tpu/models/seq2seq.py``: a shared embedding, a
bidirectional encoder of ``transformer.Block``s with its own final norm, and
a causal decoder of ``DecoderBlock``s (self-attention, cross-attention to
the encoder's memory, MLP, each pre-norm), a final norm and a tied (or
separate) head. Parameters are fp32 and named after the reference's tree
(``encoder.layers.<i>.attn.q_proj.weight``, ``decoder.layers.<i>.
cross_attn.k_proj.weight``, ``encoder_norm.weight``, ...).

Attention dispatch follows the reference's: the encoder's self-attention is
non-causal and takes the flash kernels where ``dot_product_attention``'s auto
dispatch picks them, with no source mask; a source ``attention_mask`` reaches
it as a dense (B, 1, 1, S_src) key mask, so that call takes the plain path
(the reference's ``encode`` :183-192; only ``SequenceClassifier`` lowers a
mask to lengths). The decoder is forced causal whatever the config says
(a non-causal decoder would see the targets it predicts through teacher
forcing), and its cross-attention always takes the plain path (reference
:93-99): its pattern is rectangular and masked by the source padding.

Greedy ``generate`` encodes the source once and steps the decoder with a
``Seq2SeqCache``: the decoder layers' dense self-attention cache and each
layer's cross-attention keys and values, computed from the memory at the
first step and read from the cache after (the reference's ``cross_filled``).
Inside a sharded step the layers run on the gathered weights, and under tp
the projections split as in ``transformer.Attention`` (q and o_proj by
heads, k and v whole with each rank taking its heads' rows, for the
cross-attention too).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..ops.attention import xla_attention
from ..parallel import runtime as _shard
from ..parallel.sharding import LeafAxes
from .config import TransformerConfig
from .transformer import (
    MLP,
    Attention,
    Block,
    Dense,
    DecodeCache,
    RMSNorm,
    _Rows,
    _check_config,
    _dtype,
    _embed_tokens,
    _expand_kv,
    _layer_stack,
    _logical_axes,
    _model_device,
    _model_generator,
    _proj,
    _tp_heads,
)


@dataclass
class Seq2SeqCache:
    """The decoder's decode state: ``self_cache`` (the dense cache of its
    self-attention over ``max_seq_len`` target positions), and ``cross_key``
    / ``cross_value``, (decoder layers, B, S_src, kv heads, head_dim) in the
    compute dtype, which the first decode step fills from the memory
    (``cross_filled``) and every later one reads."""

    self_cache: DecodeCache
    cross_key: torch.Tensor
    cross_value: torch.Tensor
    cross_filled: bool = False

    @classmethod
    def zeros(cls, config: TransformerConfig, batch_size: int, source_len: int, device,
              kv_heads: Optional[int] = None) -> "Seq2SeqCache":
        layers = config.num_decoder_layers or config.num_layers
        heads = config.num_kv_heads if kv_heads is None else kv_heads
        self_cache = DecodeCache.zeros(dataclasses.replace(config, num_layers=layers,
                                                           layer_windows=None),
                                       batch_size, device, heads)
        shape = (layers, batch_size, source_len, heads, config.head_dim)
        dt = _dtype(config)
        return cls(self_cache, torch.zeros(shape, dtype=dt, device=device),
                   torch.zeros(shape, dtype=dt, device=device))


class CrossAttention(nn.Module):
    """Decoder-to-encoder attention: q from ``x``, k and v from ``memory``,
    no rope (each stream carries its own positions); always the plain path,
    masked by the source padding."""

    def __init__(self, config: TransformerConfig, device=None, generator=None):
        super().__init__()
        cfg = self.config = config
        e = cfg.hidden_size
        q_dim, kv_dim = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
        kw = dict(device=device, generator=generator)
        self.q_proj = _proj(cfg, e, q_dim, False, **kw)
        self.k_proj = _proj(cfg, e, kv_dim, False, **kw)
        self.v_proj = _proj(cfg, e, kv_dim, False, **kw)
        self.o_proj = _proj(cfg, q_dim, e, False, **kw)

    def forward(self, x, memory, memory_mask=None, cross=None):
        """``memory_mask``: (B, S_src) source padding, 1 = real token.
        ``cross``: (key, value, filled) of this layer's decode cache: the
        keys and values are read from it when ``filled``, else computed and
        written there."""
        cfg = self.config
        b, s = x.shape[:2]
        sm = memory.shape[1]
        heads, kv_heads = cfg.num_heads, cfg.num_kv_heads
        k_proj, v_proj = self.k_proj, self.v_proj
        tp = _shard.tp_state()
        split = None
        if tp is not None:  # this rank's heads, as transformer.Attention splits them
            split = _tp_heads(cfg, tp)
            if split.gather_q:
                raise NotImplementedError("cross-attention under a tp size that cuts a head")
            heads, kv_heads = split.heads, split.kv_heads
            k_proj, v_proj = _Rows(self.k_proj, split.kv_rows), _Rows(self.v_proj, split.kv_rows)
            x, memory = tp.copy(x), tp.copy(memory)

        def compute_kv():
            k = k_proj(memory).reshape(b, sm, kv_heads, cfg.head_dim)
            v = v_proj(memory).reshape(b, sm, kv_heads, cfg.head_dim)
            return k, v

        if cross is None:
            k, v = compute_kv()
        else:
            key, value, filled = cross
            if not filled:
                k, v = compute_kv()
                key.copy_(k.to(key.dtype))
                value.copy_(v.to(value.dtype))
            k, v = key, value
        q = self.q_proj(x).reshape(b, s, heads, cfg.head_dim)
        mask = None if memory_mask is None else memory_mask[:, None, None, :].bool()
        kv_map = None if split is None else split.kv_map
        out = xla_attention(q, _expand_kv(k, kv_map), _expand_kv(v, kv_map), mask=mask)
        y = self.o_proj(out.reshape(b, s, heads * cfg.head_dim))
        return y if tp is None else tp.reduce(y)


class DecoderBlock(nn.Module):
    """Self-attention (causal; cached under decode), cross-attention and the
    MLP, pre-norm."""

    def __init__(self, config: TransformerConfig, device=None, generator=None):
        super().__init__()
        e = config.hidden_size
        self.self_attn_norm = RMSNorm(config, e, device)
        self.self_attn = Attention(config, device, generator)
        self.cross_attn_norm = RMSNorm(config, e, device)
        self.cross_attn = CrossAttention(config, device, generator)
        self.mlp_norm = RMSNorm(config, e, device)
        self.mlp = MLP(config, device, generator)

    def forward(self, x, positions, memory, memory_mask=None, kv=None, cross=None, lora=None):
        """``lora``: the layer stack's slot, always None (the model takes no
        adapters)."""
        h = x + self.self_attn(self.self_attn_norm(x), positions, kv=kv)
        h = h + self.cross_attn(self.cross_attn_norm(h), memory, memory_mask, cross=cross)
        return h + self.mlp(self.mlp_norm(h))


class _Stack(nn.Module):
    """A block stack (the reference's ``_Encoder`` / ``_Decoder``): its
    parameters are named ``<encoder|decoder>.layers.<i>.``."""

    def __init__(self, blocks):
        super().__init__()
        self.layers = nn.ModuleList(blocks)


class Seq2SeqLM(nn.Module):
    """Encoder-decoder LM: ``forward(input_ids, decoder_input_ids,
    attention_mask=None) -> logits`` over the decoder positions (teacher
    forcing), in the compute dtype. ``encode`` and ``decode_logits`` are
    separate so that generation encodes the source once. Parameters are
    made on ``device`` (CUDA unless the caller passes ``device="cpu"``;
    raises without a CUDA device) from ``generator`` (a fresh one seeded 0
    when none is given)."""

    def __init__(self, config: TransformerConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_config(config)
        self.config = config
        device = _model_device(device)
        generator = _model_generator(device, generator)
        e = config.hidden_size
        self.embed = nn.Embedding(config.vocab_size, e, device=device)
        if not self.embed.weight.is_meta:
            with torch.no_grad():
                self.embed.weight.normal_(0.0, 0.02, generator=generator)
        enc_cfg = dataclasses.replace(config, causal=False)
        # causal whatever the config says: a non-causal decoder would see
        # the targets it predicts
        dec_cfg = dataclasses.replace(config, causal=True)
        self.encoder = _Stack(Block(enc_cfg, device, generator)
                              for _ in range(config.num_layers))
        self.encoder_norm = RMSNorm(config, e, device)
        self.decoder = _Stack(DecoderBlock(dec_cfg, device, generator)
                              for _ in range(config.num_decoder_layers or config.num_layers))
        self.final_norm = RMSNorm(config, e, device)
        if not config.tie_embeddings:
            self.lm_head = Dense(e, config.vocab_size, False, _dtype(config), device, generator)

    # ------------------------------------------------------------------ #
    def encode(self, input_ids, attention_mask=None):
        """Source -> memory (the encoder's normed output); run once per
        generation. ``attention_mask`` (B, S_src), 1 = real token, reaches
        the encoder's attention as a dense key mask."""
        b, s = input_ids.shape
        positions = torch.arange(s, device=input_ids.device)[None, :].expand(b, s)
        mask = None if attention_mask is None else attention_mask[:, None, None, :].bool()
        x = _embed_tokens(self, input_ids, _dtype(self.config))
        x = _layer_stack(self, x, positions, mask, layers=self.encoder.layers,
                         prefix="encoder.layers.")
        return self.encoder_norm(x)

    def decode_logits(self, decoder_input_ids, memory, attention_mask=None, decode=False,
                      cache: Optional[Seq2SeqCache] = None):
        """The decoder over (possibly incremental) target tokens. Under
        ``decode=True`` the tokens sit at the cache's index + i, the
        self-attention writes into ``cache.self_cache`` and the
        cross-attention reads (or, at the first step, fills) the cross
        keys and values."""
        cfg = self.config
        b, s = decoder_input_ids.shape
        ar = torch.arange(s, device=decoder_input_ids.device)
        x = _embed_tokens(self, decoder_input_ids, _dtype(cfg))
        if decode:
            if not isinstance(cache, Seq2SeqCache):
                raise ValueError("decode=True needs a cache: models.generation.init_cache")
            sc = cache.self_cache
            positions = (sc.index + ar)[None, :].expand(b, s)
            gather = _shard.layer_gather()
            for i, layer in enumerate(self.decoder.layers):
                kw = {"kv": (sc.key[i], sc.value[i], None, None, None),
                      "cross": (cache.cross_key[i], cache.cross_value[i], cache.cross_filled)}
                if gather is None:
                    x = layer(x, positions, memory, attention_mask, **kw)
                else:
                    weights = gather(f"decoder.layers.{i}.", dict(layer.named_parameters()))
                    x = torch.func.functional_call(layer, weights,
                                                   (x, positions, memory, attention_mask), kw)
            sc.index += s
            cache.cross_filled = True
        else:
            if cache is not None:
                raise ValueError("a cache is read only with decode=True")
            positions = ar[None, :].expand(b, s)
            x = _layer_stack(self, x, positions, memory, attention_mask,
                             layers=self.decoder.layers, prefix="decoder.layers.")
        x = self.final_norm(x)
        tp = _shard.tp_state()
        if tp is not None:  # vocab-split logits, gathered over tp for the loss
            x = tp.copy(x)
        dt = _dtype(cfg)
        if cfg.tie_embeddings:
            logits = x.to(dt) @ self.embed.weight.to(dt).t()
        else:
            logits = self.lm_head(x)
        return logits if tp is None else tp.gather(logits, -1)

    def forward(self, input_ids, decoder_input_ids, attention_mask=None):
        memory = self.encode(input_ids, attention_mask)
        return self.decode_logits(decoder_input_ids, memory, attention_mask)

    def logical_axes(self) -> dict[str, LeafAxes]:
        """Every parameter's logical axes in the reference's layout (the
        transformer's rules over the encoder's and the decoder's stacks)."""
        return _logical_axes(self)

    # ------------------------------------------------------------------ #
    @staticmethod
    def loss_fn(model: "Seq2SeqLM"):
        """Teacher-forced cross-entropy closure for
        ``Accelerator.unified_step``. Batch keys: ``input_ids``,
        ``decoder_input_ids``, ``labels``, optional ``attention_mask``
        (source padding) and ``decoder_loss_mask``."""

        def fn(params, batch):
            logits = torch.func.functional_call(
                model, params,
                (batch["input_ids"], batch["decoder_input_ids"], batch.get("attention_mask")))
            logp = torch.log_softmax(logits.float(), dim=-1)
            nll = -logp.gather(-1, batch["labels"].long()[..., None])[..., 0]
            mask = batch.get("decoder_loss_mask")
            if mask is not None:
                mask = mask.float()
                return (nll * mask).sum() / mask.sum().clamp_min(1.0)
            return nll.mean()

        def loss_weight(batch):  # the terms the mean runs over, across processes
            mask = batch.get("decoder_loss_mask")
            return float(batch["labels"].numel()) if mask is None else mask.float().sum()

        fn.loss_weight = loss_weight
        return fn

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 32, bos_token_id: int = 0,
                 eos_token_id: Optional[int] = None, attention_mask=None) -> torch.Tensor:
        """Greedy decode with the caches (the decoder's self-attention and
        the cross-attention's keys and values, computed once): returns (B,
        1 + max_new_tokens) ids on the model's device, BOS first; after an
        EOS a row repeats EOS."""
        from .generation import init_cache

        device = self.embed.weight.device
        ids = torch.as_tensor(input_ids, device=device).long()
        B = ids.shape[0]
        if max_new_tokens + 1 > self.config.max_seq_len:
            raise ValueError(
                f"max_new_tokens ({max_new_tokens}) + bos exceeds the decoder cache length "
                f"(max_seq_len={self.config.max_seq_len})")
        bos = torch.full((B, 1), bos_token_id, dtype=torch.long, device=device)
        if max_new_tokens <= 0:
            return bos
        if attention_mask is not None:
            attention_mask = torch.as_tensor(attention_mask, device=device)
        memory = self.encode(ids, attention_mask)
        cache = init_cache(self, B, source_len=ids.shape[1])
        tok, done, out = bos[:, 0], torch.zeros(B, dtype=torch.bool, device=device), [bos]
        for _ in range(max_new_tokens):
            logits = self.decode_logits(tok[:, None], memory, attention_mask, decode=True,
                                        cache=cache)
            nxt = torch.argmax(logits[:, -1], dim=-1)
            if eos_token_id is not None:
                nxt = torch.where(done, torch.full_like(nxt, eos_token_id), nxt)
                done = done | (nxt == eos_token_id)
            out.append(nxt[:, None])
            tok = nxt
        return torch.cat(out, dim=1)

