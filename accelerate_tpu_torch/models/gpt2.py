"""GPT-2, the classic architecture whose hub checkpoints load with matching
logits.

Port of ``accelerate_tpu/models/gpt2.py``: learned absolute positions
(``wpe``) in place of rope, LayerNorm with bias, biased projections with the
query, key and value as one fused ``c_attn`` product, the tanh GELU MLP of
width ``intermediate_size``, pre-LN blocks, a final ``ln_f`` and the tied
head. Parameters are fp32 and named after the reference's tree
(``layers.<i>.attn.c_attn.weight`` for ``layers/attn/c_attn/kernel``), each
projection a ``Dense`` whose weight is (out, in) as in ``transformer.py``.

Training attention is ``dot_product_attention(causal=True,
implementation=config.attention_impl)`` (the flash kernels on the card at a
length they take). Decoding writes each layer's k/v into the dense
``DecodeCache`` at its index and attends over the cache on the plain path,
as the reference does; the model-level position of ``wpe`` under decode is
the cache's index (the reference's ``pos_index``), so a captured decode
step reads it on the card. The loss is ``CausalLM``'s.

Inside a sharded step the layer loop gathers each layer's fsdp-split
weights as it runs (``transformer._layer_stack``). Under tp the reference's
rules split ``c_attn``'s and ``c_fc``'s output columns and ``c_proj``'s
input rows evenly over tp (GSPMD runs the split whatever heads it cuts);
here each rank computes its columns of the fused q/k/v, gathers the whole
(``gather_summed``: the backward sums the ranks' partial gradients), attends
over the heads its rows of the attention's ``c_proj`` input touch and keeps
those rows, and the row-split products are summed over tp before their
bias is added once. The embedding and the tied head are split over the
vocab as in ``CausalLM``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention, xla_attention
from ..parallel import runtime as _shard
from ..parallel.sharding import LeafAxes, constrain_activations
from .config import TransformerConfig
from .transformer import (
    CausalLM,
    DecodeCache,
    _check_config,
    _dtype,
    _embed_tokens,
    _layer_stack,
    _model_device,
    _model_generator,
    checkpoint_name,
)


class GPT2Dense(nn.Linear):
    """A biased projection with fp32 parameters that computes in the compute
    dtype, initialised N(0, 0.02) with a zero bias (the reference's
    ``_dense``)."""

    def __init__(self, in_features, out_features, compute_dtype, device, generator):
        super().__init__(in_features, out_features, bias=True, device=device)
        self.compute_dtype = compute_dtype
        if self.weight.is_meta:
            return
        with torch.no_grad():
            self.weight.normal_(0.0, 0.02, generator=generator)
            self.bias.zero_()

    def forward(self, x, tp_rows: bool = False):
        """``tp_rows``: the weight is this tp rank's share of the input rows
        (a row-split product), so the partial products are summed over tp
        and the bias, whole on every rank, is added once after the sum."""
        dt = self.compute_dtype
        tp = _shard.tp_state() if tp_rows else None
        if tp is None:
            return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))
        return tp.reduce(F.linear(x.to(dt), self.weight.to(dt))) + self.bias.to(dt)


class GPT2LayerNorm(nn.LayerNorm):
    """LayerNorm with fp32 scale and bias, computed as flax's ``LayerNorm``
    does (mean and variance in fp32 for a low-precision input), returned in
    the compute dtype."""

    def __init__(self, config: TransformerConfig, device=None):
        super().__init__(config.hidden_size, eps=config.rms_norm_eps, device=device)
        self.compute_dtype = _dtype(config)

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf.square().mean(dim=-1, keepdim=True) - mean.square()).clamp_min(0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(self.compute_dtype)


class GPT2Attention(nn.Module):
    """Causal self-attention with the fused ``c_attn`` (q, k and v columns
    side by side) and the output ``c_proj``."""

    def __init__(self, config: TransformerConfig, device=None, generator=None):
        super().__init__()
        self.config = config
        h, dt = config.hidden_size, _dtype(config)
        self.c_attn = GPT2Dense(h, 3 * h, dt, device, generator)
        self.c_proj = GPT2Dense(h, h, dt, device, generator)

    def forward(self, x, positions, mask=None, kv=None):
        """``kv``: this layer's dense decode cache slices (key, value) of
        (B, max_seq_len, heads, head_dim), written at ``positions``."""
        cfg = self.config
        b, s = x.shape[:2]
        hd, heads = cfg.head_dim, cfg.num_heads
        tp = _shard.tp_state()
        if tp is not None:
            x = tp.copy(x)
        qkv = self.c_attn(x)
        cols = None
        if tp is not None:
            # the whole fused q/k/v (each rank computed its columns), and this
            # rank's columns of the attention output, c_proj's input rows
            qkv = tp.gather_summed(qkv, -1)
            share = cfg.hidden_size // tp.size
            cols = (tp.rank * share, (tp.rank + 1) * share)
        q, k, v = qkv.split(cfg.hidden_size, dim=-1)
        h0, h1 = (0, heads) if cols is None else (cols[0] // hd, -(-cols[1] // hd))
        # each a contiguous (B, S, heads, D) copy: the kernels read that layout
        q, k, v = (t.reshape(b, s, heads, hd)[:, :, h0:h1].contiguous() for t in (q, k, v))
        if kv is not None:
            key, value = kv
            write = positions[0]  # the dense cache's positions are alike in every row
            key.index_copy_(1, write, k.to(key.dtype))
            value.index_copy_(1, write, v.to(value.dtype))
            keep = (torch.arange(key.shape[1], device=x.device)[None, None, None, :]
                    <= write[None, None, :, None])
            out = xla_attention(q, key, value, mask=keep)
        else:
            out = dot_product_attention(q, k, v, mask=mask, causal=True,
                                        implementation=cfg.attention_impl)
            out = checkpoint_name(out, "attn_out", cfg)
        out = out.reshape(b, s, (h1 - h0) * hd)
        if cols is not None:  # back to this rank's columns
            out = out[..., cols[0] - h0 * hd:cols[1] - h0 * hd]
        return self.c_proj(out, tp_rows=True)


class GPT2MLP(nn.Module):
    """``c_fc`` -> tanh GELU (HF ``gelu_new``) -> ``c_proj``."""

    def __init__(self, config: TransformerConfig, device=None, generator=None):
        super().__init__()
        h, f, dt = config.hidden_size, config.intermediate_size, _dtype(config)
        self.c_fc = GPT2Dense(h, f, dt, device, generator)
        self.c_proj = GPT2Dense(f, h, dt, device, generator)

    def forward(self, x):
        tp = _shard.tp_state()
        if tp is not None:
            x = tp.copy(x)
        y = F.gelu(self.c_fc(x), approximate="tanh")
        return self.c_proj(y, tp_rows=True)


class GPT2Block(nn.Module):
    """Pre-LN block: x + attn(ln_1(x)), then + mlp(ln_2(.)). Called by
    ``transformer._layer_stack`` as ``block(x, positions, mask, lora=None)``."""

    def __init__(self, config: TransformerConfig, device=None, generator=None):
        super().__init__()
        self.ln_1 = GPT2LayerNorm(config, device)
        self.attn = GPT2Attention(config, device, generator)
        self.ln_2 = GPT2LayerNorm(config, device)
        self.mlp = GPT2MLP(config, device, generator)

    def forward(self, x, positions, mask=None, kv=None, lora=None):
        """``lora``: the layer stack's slot, always None (GPT-2 takes no
        adapters: the reference's target the Llama family's projections)."""
        h = x + self.attn(self.ln_1(x), positions, mask, kv=kv)
        return h + self.mlp(self.ln_2(h))


class GPT2LM(nn.Module):
    """``wte + wpe -> L x GPT2Block -> ln_f -> tied head``.

    ``forward(input_ids, positions=None, mask=None, decode=False,
    cache=None) -> logits`` in the compute dtype: the call of ``CausalLM``
    (``mask``: a (B, 1, S, S) or (B, 1, 1, S) bool mask, which takes the
    plain path). Under ``decode=True`` with a ``DecodeCache`` the tokens sit
    at the cache's index + i, for ``wpe`` and for the cache, and the index
    advances. Parameters are made on ``device`` (CUDA unless the caller
    passes ``device="cpu"``; raises without a CUDA device) from
    ``generator`` (a fresh one seeded 0 when none is given); on the meta
    device nothing is drawn.
    """

    def __init__(self, config: TransformerConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_config(config)
        self.config = config
        device = _model_device(device)
        generator = _model_generator(device, generator)
        h = config.hidden_size
        self.wte = nn.Embedding(config.vocab_size, h, device=device)
        self.wpe = nn.Embedding(config.max_seq_len, h, device=device)
        if not self.wte.weight.is_meta:
            with torch.no_grad():
                self.wte.weight.normal_(0.0, 0.02, generator=generator)
                self.wpe.weight.normal_(0.0, 0.01, generator=generator)
        self.layers = nn.ModuleList(
            GPT2Block(config, device, generator) for _ in range(config.num_layers))
        self.ln_f = GPT2LayerNorm(config, device)

    def forward(self, input_ids, positions=None, mask=None, decode=False, cache=None):
        cfg = self.config
        dt = _dtype(cfg)
        b, s = input_ids.shape
        ar = torch.arange(s, device=input_ids.device)
        if decode:
            if not isinstance(cache, DecodeCache):
                raise ValueError("decode=True needs a cache: models.generation.init_cache")
            positions = (cache.index + ar)[None, :].expand(b, s)
        elif cache is not None:
            raise ValueError("a cache is read only with decode=True")
        elif positions is None:
            positions = ar[None, :].expand(b, s)
        x = _embed_tokens(self, input_ids, dt, self.wte) + F.embedding(positions,
                                                                         self.wpe.weight.to(dt))
        x = constrain_activations(x)
        if decode:
            gather = _shard.layer_gather()
            for i, layer in enumerate(self.layers):
                kw = {"kv": (cache.key[i], cache.value[i])}
                if gather is None:
                    x = layer(x, positions, **kw)
                else:
                    weights = gather(f"layers.{i}.", dict(layer.named_parameters()))
                    x = torch.func.functional_call(layer, weights, (x, positions), kw)
            cache.index += s
        else:
            x = _layer_stack(self, x, positions, mask)
        x = self.ln_f(x)
        tp = _shard.tp_state()
        if tp is not None:  # vocab-split logits, gathered over tp for the loss
            x = tp.copy(x)
        logits = x.to(dt) @ self.wte.weight.to(dt).t()  # GPT-2's head is always tied
        return logits if tp is None else tp.gather(logits, -1)

    def logical_axes(self) -> dict[str, LeafAxes]:
        """Every parameter's logical axes as the reference declares them
        (``accelerate_tpu/models/gpt2.py`` ``_dense``, ``_layer_norm``, the
        embeddings), over the reference's shapes (a layer's leaf stacked to
        ``(layers, ...)``, a kernel ``(in, out)``)."""
        kernels = {"attn.c_attn": (("embed", "heads"), "heads"),
                   "attn.c_proj": (("heads", "embed"), "embed"),
                   "mlp.c_fc": (("embed", "mlp"), "mlp"),
                   "mlp.c_proj": (("mlp", "embed"), "embed")}
        out = {}
        for name, p in self.named_parameters():
            shape = tuple(p.shape)
            stacked = name.startswith("layers.")
            local = name.split(".", 2)[2] if stacked else name
            module, _, leaf = local.rpartition(".")
            if module in kernels:
                axes, bias_axis = kernels[module]
                if leaf == "weight":
                    logical, ref, dims = axes, (shape[1], shape[0]), (1, 0)
                else:
                    logical, ref, dims = (bias_axis,), shape, (0,)
            elif module.startswith("ln_"):
                logical, ref, dims = ("norm",), shape, (0,)
            elif local == "wte.weight":
                logical, ref, dims = (("vocab", "zero"), "embed"), shape, (0, 1)
            elif local == "wpe.weight":
                logical, ref, dims = (None, "embed"), shape, (0, 1)
            else:
                raise KeyError(f"no logical axes for parameter {name!r}")
            if stacked:
                logical = ("layers",) + tuple(logical)
                ref, dims = (self.config.num_layers,) + tuple(ref), tuple(d + 1 for d in dims)
            out[name] = LeafAxes(tuple(logical), tuple(ref), dims)
        return out

    # next-token cross-entropy is architecture-agnostic (the reference's too)
    loss_fn = staticmethod(CausalLM.loss_fn)

