"""The Llama-family transformer: the causal LM and the encoder classifier.

Port of ``accelerate_tpu/models/transformer.py`` (``RMSNorm`` :47,
``rope`` :113 with ``_scale_rope_freqs`` :80 in ``ops/rope.py``,
``Attention`` :246, ``MLP`` :491, ``MoE`` :530,
``Block`` :671, ``_REMAT_POLICIES`` :758, ``_apply_layer_stack`` :803,
``CausalLM`` :861 with
``loss_fn`` :938, ``SequenceClassifier`` :961 with ``loss_fn`` :1067) as
``nn.Module``s, with the decode paths of ``Attention`` (:346-470): the
dense decode cache (``DecodeCache``, written in place at its index) and
the paged KV cache (``ops/attention.PagedKVCache`` through block tables).
The reference keeps either cache as flax cache variables made on first
call; here it is an explicit object passed to ``CausalLM.forward``.
Parameters are fp32 and named after the reference's module tree
(``layers.<i>.attn.q_proj.weight`` for ``layers/attn/q_proj/kernel``);
``utils/weights.params_from_jax`` carries a flax tree over. Each projection computes in ``config.dtype``, casting
its inputs and weights as flax's ``Dense(dtype=...)`` does. The layer
stack is a ``ModuleList`` run in a loop (the reference's ``nn.scan``).
``fused_kernels=True`` runs each layer's RMSNorm -> q/k/v -> rope as the
fused prologue kernel (``ops/fused.py``) where its shape gate allows, with
the same parameters (the reference's :271-319 and :701-710), except
under ``fp8``. ``fp8=True`` runs the attention and MLP projections through
``Fp8Dense`` (the reference's ``_make_proj`` :148-180), and
``convert_model`` turns a built model's projections into them; the
lm_head stays a plain ``Dense``. ``num_experts > 0`` puts the Mixtral-style
``MoE`` block in place of the MLP.

``remat`` maps the reference's policies onto ``torch.utils.checkpoint``
around each layer: ``"full"`` saves only the layer's inputs; the others are
selective-checkpoint policies that also keep the outputs of the products
(``"dots"``: ``mm``/``addmm``/``bmm``/``_scaled_mm``; ``"dots_ragged"``:
those and ``_grouped_mm``; ``"dots_with_no_batch_dims"``: no ``bmm``) or
the named tensors (``"save_attn"``, ``"save_mlp"``): the products
computed under :func:`named_products` and the tensors tagged by
:func:`checkpoint_name`. The recompute replays the layer in order and
skips only the ops whose outputs were kept, so, unlike XLA's remat, it
also reruns the ops that produced a tagged tensor (the o_proj product
before ``attn_res``), and the flash forward (a kernel launch the
dispatcher does not see; its lse is needed) runs again under every
policy, as the reference's Pallas forward does.

``CausalLM.forward(..., lora=LoraState)`` adds the adapters' low-rank
deltas (``adapters/runtime.py``) to the targeted projections' outputs, as
the reference's ``_lora_delta_fn`` (:219-241) does in ``Attention``
(:253-256, :330-341, :476-478), ``MLP`` (:497-524) and ``Block``
(:677-729): dropout falls on the delta's input, an adapter on q/k/v takes
the unfused chain under ``fused_kernels`` (the fused prologue never
materialises the projections; :283-289), an o_proj-only adapter keeps it,
and MoE blocks take attention adapters only. Under remat each layer's
adapter tensors go into the checkpointed call as inputs, beside its
parameters.

Sharding (``parallel/``): each model declares its parameters' logical axes
in the reference's layout (``logical_axes()``, from the reference's
``nn.with_partitioning`` calls), which ``parallel.sharding`` maps to mesh
axes. Inside a sharded step (``parallel.runtime.sharded_forward``) the
layer loop gathers each layer's fsdp-split weights as it runs, and under tp
the attention runs on the local heads (q and o_proj split, k and v whole of
which each rank takes its heads' rows), the MLP on its columns and rows, the
embedding and the lm_head on the local vocab, with Megatron's pair of
collectives; ``tp_partial_leaves`` names the leaves whose gradients are
partial over tp. Decoding, LoRA and MoE under tp raise. Under sp with
``attention_impl="ring"`` the causal LM takes its rank's contiguous chunk
of the sequence after the embedding (``parallel.sharding.
constrain_activations``), with the chunk's global positions for rope, and
attention runs the ring over sp (``ops/ring_attention.py``); its loss
builds the targets and the mask from the whole row before it takes the
chunk (the reference shifts over the whole row, :945-952), so each token
counts once across chunk boundaries. Under ep the MoE block runs
``ops/moe.moe_ragged_ep`` on its shard of the expert stacks (``"auto"``
and ``"ragged"``), or gathers the stacks for ``"dense"`` and, with the
tokens, for ``"capacity"``, whose capacity is the global batch's.

Not ported yet, and rejected when asked for (ROADMAP.md): the GPT-2
architecture, the Gemma/Gemma-2 switches, and ``fused_kernels=True`` on the
classifier.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..adapters.runtime import LayerLora, LoraState
from ..logging import get_logger
from ..ops import fused as fused_ops
from ..ops import moe as moe_ops
from ..ops.attention import (
    PagedKVCache,
    PagedKVState,
    dot_product_attention,
    flash_self_attention_eligible,
    paged_attention,
    paged_update,
    xla_attention,
)
from ..ops.fp8 import fp8_matmul
from ..ops.rope import rope_inv_freqs
from ..parallel import runtime as _shard
from ..parallel.sharding import LeafAxes, constrain_activations, sequence_chunk_bounds
from ..state import resolve_device
from .config import TransformerConfig

# flax's truncated_normal divides by the std of a unit normal cut at +-2
_TRUNC_STD = 0.87962566103423978


def _dtype(config: TransformerConfig) -> torch.dtype:
    return getattr(torch, config.dtype)


def _unsupported(cfg: TransformerConfig) -> Optional[str]:
    if cfg.arch != "llama":
        return f"arch={cfg.arch!r} (queue A8)"
    gemma = [name for name, on in (
        ("norm_offset", cfg.norm_offset), ("embed_scale", cfg.embed_scale),
        ("mlp_activation", cfg.mlp_activation != "silu"), ("post_norms", cfg.post_norms),
        ("attn_softcap", cfg.attn_softcap is not None),
        ("final_softcap", cfg.final_softcap is not None),
        ("query_pre_attn_scalar", cfg.query_pre_attn_scalar is not None),
        ("layer_windows", cfg.layer_windows is not None),
    ) if on]
    if gemma:
        return f"the Gemma/Gemma-2 switches {gemma} (queue A8)"
    return None


def _check_config(cfg: TransformerConfig) -> None:
    why = _unsupported(cfg)
    if why is not None:
        raise NotImplementedError(f"not ported yet: {why}; see ROADMAP.md")
    if cfg.remat is not None and cfg.remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {cfg.remat!r}; use one of "
                         f"{sorted(REMAT_POLICIES)}")
    if cfg.num_experts > 0 and cfg.moe_dispatch not in ("auto", "ragged", "capacity", "dense"):
        raise ValueError(f"unknown moe_dispatch {cfg.moe_dispatch!r}; use 'auto', 'ragged', "
                         "'capacity' or 'dense'")


# ---------------------------------------------------------------------- #
# remat: the reference's policies as selective-checkpoint policies
# ---------------------------------------------------------------------- #
@torch.library.custom_op("accelerate_tpu_torch::checkpoint_name", mutates_args=())
def _checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    return x.clone()  # a custom op's output may not alias its input


@_checkpoint_name.register_fake
def _(x, name):
    return torch.empty_like(x)


_checkpoint_name.register_autograd(lambda ctx, grad: (grad, None))

# the tensors each named policy keeps (the reference's save_only_these_names)
_SAVED_NAMES = {
    "save_attn": ("attn_out",),
    "save_mlp": ("attn_out", "attn_res", "mlp_gate_out", "mlp_up_out"),
}
_scope = threading.local()  # the name of the products being computed, if any


def checkpoint_name(x: torch.Tensor, name: str, cfg: TransformerConfig) -> torch.Tensor:
    """``jax.ad_checkpoint.checkpoint_name``: tags ``x`` so that a remat
    policy naming it keeps it. The tag is an identity op (a copy of x) that
    runs only under a policy that keeps ``name`` and while autograd records;
    elsewhere x passes through untouched."""
    if name in _SAVED_NAMES.get(cfg.remat, ()) and torch.is_grad_enabled():
        return _checkpoint_name(x, name)
    return x


@contextlib.contextmanager
def named_products(name: str):
    """The products computed inside are the tensor ``name``: a policy that
    keeps ``name`` keeps their outputs, so the recompute skips them (a tag
    on their result would keep it, but the recompute, which replays the
    layer in order, would still rerun the products)."""
    outer = getattr(_scope, "name", None)
    _scope.name = name
    try:
        yield
    finally:
        _scope.name = outer


def _save_policy(ops=(), names=()):
    """A selective-checkpoint policy that keeps the outputs of ``ops`` (aten
    overload packets), and of the products and tags named in ``names``."""

    def policy(ctx, func, *args, **kwargs):
        packet = func.overloadpacket
        if packet in ops or (packet in _DOTS and getattr(_scope, "name", None) in names):
            return CheckpointPolicy.MUST_SAVE
        if func is torch.ops.accelerate_tpu_torch.checkpoint_name.default and args[1] in names:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return policy


_aten = torch.ops.aten
_NO_BATCH_DOTS = (_aten.mm, _aten.addmm, _aten._scaled_mm)
_DOTS = _NO_BATCH_DOTS + (_aten.bmm,)
REMAT_POLICIES = {
    "full": None,
    "dots": _save_policy(_DOTS),
    "dots_ragged": _save_policy(_DOTS + (_aten._grouped_mm,)),
    "dots_with_no_batch_dims": _save_policy(_NO_BATCH_DOTS),
    "save_attn": _save_policy(names=_SAVED_NAMES["save_attn"]),
    "save_mlp": _save_policy(names=_SAVED_NAMES["save_mlp"]),
}


def _remat(layer, remat: str, *args, lora: Optional[LayerLora] = None, gather=None):
    """``layer(*args, lora=lora)`` under torch.utils.checkpoint with the
    policy. The layer's parameters as they are now (inside
    ``unified_step``'s ``functional_call``, the compute-dtype copies) and
    its adapter tensors go in as inputs, so the recompute in the backward,
    which runs after that call has put the fp32 masters back, replays the
    same ops on the same tensors, and the adapters' gradients flow. Under a
    sharded step ``gather`` turns the layer's local shards into its whole
    weights inside the checkpointed call, so the recompute gathers them
    again."""
    policy = REMAT_POLICIES[remat]
    kw = {} if policy is None else {
        "context_fn": functools.partial(create_selective_checkpoint_contexts, policy)}
    params = dict(layer.named_parameters())
    names = list(params)
    lora_tensors = [] if lora is None else lora.tensors()
    n_lora = len(lora_tensors)

    def run(*tensors):
        weights = dict(zip(names, tensors[:len(names)]))
        if gather is not None:  # the recompute gathers again
            weights = gather(weights)
        rest = tensors[len(names):]
        layer_lora = None if lora is None else lora.with_tensors(rest[:n_lora])
        return torch.func.functional_call(layer, weights, rest[n_lora:], {"lora": layer_lora})

    return checkpoint(run, *params.values(), *lora_tensors, *args, use_reentrant=False, **kw)


_QKV = ("q_proj", "k_proj", "v_proj")
_ATTN_TARGETS = _QKV + ("o_proj",)
_MLP_TARGETS = ("gate_proj", "up_proj", "down_proj")


def _add_delta(y: torch.Tensor, lora: Optional[LayerLora], x: torch.Tensor,
               target: str) -> torch.Tensor:
    """``y`` (projection ``target``'s output on ``x``) plus its adapter
    delta, if the layer's adapters target it."""
    delta = None if lora is None else lora.delta(x, target)
    return y if delta is None else y + delta


class Dense(nn.Linear):
    """``nn.Linear`` with fp32 parameters that computes in ``compute_dtype``
    (flax ``Dense(dtype=..., param_dtype=float32)``), initialised
    lecun-normal like the reference."""

    def __init__(self, in_features, out_features, bias, compute_dtype, device, generator):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.compute_dtype = compute_dtype
        if self.weight.is_meta:  # shapes only: no draw
            return
        std = in_features ** -0.5 / _TRUNC_STD
        with torch.no_grad():
            nn.init.trunc_normal_(
                self.weight, std=std, a=-2 * std, b=2 * std, generator=generator
            )
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Fp8Dense(Dense):
    """``Dense`` (the same parameters, names and init) whose product runs
    through ``ops/fp8.fp8_matmul``: fp32 out, bias added, cast to
    ``compute_dtype``, as the reference's ``ops/fp8.py:Fp8Dense`` (:218)."""

    def forward(self, x):
        dt = self.compute_dtype
        if self.bias is None:  # the product rounds straight to the compute dtype
            return fp8_matmul(x, self.weight.t(), out_dtype=dt)
        return (fp8_matmul(x, self.weight.t()) + self.bias.to(torch.float32)).to(dt)


def _proj(cfg: TransformerConfig, in_features, out_features, bias, device, generator):
    """The projection factory (the reference's ``_make_proj``): ``Dense``,
    or ``Fp8Dense`` when ``cfg.fp8``; the same parameters either way."""
    cls = Fp8Dense if cfg.fp8 else Dense
    return cls(in_features, out_features, bias, _dtype(cfg), device, generator)


def convert_model(model: nn.Module) -> nn.Module:
    """Turn ``model``'s projections into :class:`Fp8Dense`, in place, and
    set its config's ``fp8`` flag (the reference's ``ops/fp8.py:
    convert_model`` :194, the ``te.convert_model`` entry). Works on a
    module whose dataclass ``config`` has an ``fp8`` field (``CausalLM``
    and ``SequenceClassifier``): every ``Dense`` inside its attention and
    MLP blocks changes class, with its parameters' names and values as they
    were, so checkpoints interchange; the lm_head, router and classifier
    heads stay. Other modules are returned unchanged with a warning: they
    use ``Fp8Dense`` in their definition."""
    cfg = getattr(model, "config", None)
    if cfg is None or not dataclasses.is_dataclass(cfg) or not hasattr(cfg, "fp8"):
        get_logger(__name__).warning(
            f"cannot auto-convert {type(model).__name__} to fp8 (no config.fp8 field); use "
            "accelerate_tpu_torch.models.transformer.Fp8Dense in its definition")
        return model
    if cfg.fp8:
        return model
    new_cfg = dataclasses.replace(cfg, fp8=True)
    for module in model.modules():
        if getattr(module, "config", None) is cfg:
            module.config = new_cfg
        if isinstance(module, (Attention, MLP)):
            for proj in module.children():
                if type(proj) is Dense:
                    proj.__class__ = Fp8Dense
    return model


class RMSNorm(nn.Module):
    def __init__(self, config: TransformerConfig, dim: int, device=None):
        super().__init__()
        self.eps = config.rms_norm_eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x):
        xf = x.float()
        y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + self.eps)
        return (y * self.weight).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         scaling: Optional[dict] = None) -> torch.Tensor:
    """Rotary position embedding (rotate-half), x: (B, S, H, D),
    positions: (B, S); computed in fp32, returned in x's dtype."""
    freqs = rope_inv_freqs(x.shape[-1], theta, scaling, x.device)
    angles = positions[:, :, None, None].float() * freqs  # (B, S, 1, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


@dataclass
class DecodeCache:
    """The dense decode cache of every layer (the reference's
    ``cached_key``/``cached_value``/``cache_index``): one stacked tensor a
    side, (num_layers, B, max_seq_len, kv_heads, head_dim) in the compute
    dtype, and the write index as a 0-d int64 tensor on the same device, so
    that a captured decode step reads and advances it on the card."""

    key: torch.Tensor
    value: torch.Tensor
    index: torch.Tensor

    @classmethod
    def zeros(cls, config: TransformerConfig, batch_size: int, device) -> "DecodeCache":
        shape = (config.num_layers, batch_size, config.max_seq_len, config.num_kv_heads,
                 config.head_dim)
        dt = _dtype(config)
        return cls(torch.zeros(shape, dtype=dt, device=device),
                   torch.zeros(shape, dtype=dt, device=device),
                   torch.zeros((), dtype=torch.long, device=device))

    def reset(self) -> None:
        """Back to empty, in place (a captured step keeps its tensors)."""
        self.key.zero_()
        self.value.zero_()
        self.index.zero_()


def _decode_attention(q, k, v, positions, kv, window):
    """The decode branch of ``Attention``: write this call's k/v into the
    layer's cache, then attend over the whole cache with the band anchored
    at global positions. ``kv`` is (key, value, paged, key_scale,
    value_scale) of one layer: the block pools, the call's
    ``PagedKVState`` and, for int8 pools, their scale arrays (else None;
    ``accelerate_tpu/models/transformer.py:354-438``), or the dense cache's
    (B, max_seq_len, Hkv, D) slices and three Nones."""
    key, value, paged, key_scale, value_scale = kv
    if paged is not None:
        paged_update(key, value, k, v, paged, key_scale, value_scale)
        return paged_attention(q, key, value, paged, window=window, key_scale=key_scale,
                               value_scale=value_scale)
    write = positions[0]  # the dense cache's positions are the same in every row
    key.index_copy_(1, write, k.to(key.dtype))
    value.index_copy_(1, write, v.to(value.dtype))
    cols = torch.arange(key.shape[1], device=q.device)[None, None, None, :]
    rows = write[None, None, :, None]
    keep = cols <= rows  # positions not yet written are masked
    if window is not None:
        keep = keep & (cols > rows - window)
    return xla_attention(q, key, value, mask=keep)


def _tp_refusals(kv=None, lora=None) -> None:
    if kv is not None:
        raise NotImplementedError("decoding with tensor-parallel weights is not ported yet "
                                  "(the serving engine runs one card's whole model): ROADMAP.md, "
                                  "queue A7 part 4 (its remainder)")
    if lora is not None:
        raise NotImplementedError("LoRA adapters under tensor parallelism are not ported yet "
                                  "(train adapters with a plugin whose tp_size is 1): "
                                  "ROADMAP.md, queue A7 part 4 (its remainder)")


def _tp_heads(cfg: TransformerConfig, tp) -> tuple[int, int, slice]:
    """This tp rank's query heads, kv heads and the kv rows (of k_proj's
    and v_proj's ``(kv_heads * head_dim, in)`` weights) its query heads
    read."""
    if cfg.num_heads % tp.size or cfg.vocab_size % tp.size:
        raise NotImplementedError(
            f"tp_size {tp.size} must divide num_heads {cfg.num_heads} and vocab_size "
            f"{cfg.vocab_size}: the port splits heads and the vocab evenly")
    heads = cfg.num_heads // tp.size
    group = cfg.num_heads // cfg.num_kv_heads
    if heads % group == 0:
        kv_heads = heads // group
    elif group % heads == 0:
        kv_heads = 1
    else:
        raise NotImplementedError(f"{heads} local query heads straddle kv groups of {group}: "
                                  f"tp_size {tp.size} does not fit {cfg.num_heads}/"
                                  f"{cfg.num_kv_heads} heads")
    lo = (tp.rank * heads) // group
    return heads, kv_heads, slice(lo * cfg.head_dim, (lo + kv_heads) * cfg.head_dim)


class _Rows:
    """A projection restricted to some of its output rows: its own forward
    (``Dense`` or ``Fp8Dense``) on the sliced weight and bias."""

    def __init__(self, proj: nn.Module, rows: slice):
        self.proj = proj
        self.weight = proj.weight[rows]
        self.bias = None if proj.bias is None else proj.bias[rows]

    def __call__(self, x):
        params = {"weight": self.weight}
        if self.bias is not None:
            params["bias"] = self.bias
        return torch.func.functional_call(self.proj, params, (x,))


def tp_partial_leaves(config: TransformerConfig) -> frozenset:
    """The name suffixes of a layer's parameters that each tp rank uses in
    part, so that their gradients are partial sums over tp: k_proj and
    v_proj (whole on tp, each rank reading its kv rows), and the attention
    norm when the fused prologue applies it after the tp split."""
    names = {"attn.k_proj.weight", "attn.v_proj.weight", "attn.k_proj.bias",
             "attn.v_proj.bias"}
    if config.fused_kernels:
        names.add("attn_norm.weight")
    return frozenset(names)


class Attention(nn.Module):
    def __init__(self, config: TransformerConfig, device=None, generator=None):
        super().__init__()
        cfg = self.config = config
        dt, e = _dtype(cfg), cfg.hidden_size
        q_dim = cfg.num_heads * cfg.head_dim
        kv_dim = cfg.num_kv_heads * cfg.head_dim
        kw = dict(device=device, generator=generator)
        self.q_proj = _proj(cfg, e, q_dim, cfg.qkv_bias, **kw)
        self.k_proj = _proj(cfg, e, kv_dim, cfg.qkv_bias, **kw)
        self.v_proj = _proj(cfg, e, kv_dim, cfg.qkv_bias, **kw)
        self.o_proj = _proj(cfg, q_dim, e, False, **kw)

    def forward(self, x, positions, mask=None, kv_lengths=None, pre_norm_scale=None, kv=None,
                lora: Optional[LayerLora] = None):
        """``mask``: a (B, 1, 1, S) bool key mask (True = attend);
        ``kv_lengths``: (B,) int32 right-padding lengths; both go to
        ``dot_product_attention``, which routes a mask to the plain path and
        lengths to either. ``pre_norm_scale``: the Block handed over the raw
        residual stream and its norm scale (``fused_kernels``). The fused
        prologue runs when its shape gate allows and not under decode, as in
        the reference (not under fp8, whose projections the kernel does not
        compute); otherwise the norm is applied here and the unfused chain
        follows. ``kv``: this layer's decode cache (see
        ``_decode_attention``). ``lora``: this layer's attention adapters;
        one on q, k or v takes the unfused chain."""
        cfg = self.config
        b, s = x.shape[:2]
        dt = _dtype(cfg)
        heads, kv_heads = cfg.num_heads, cfg.num_kv_heads
        k_proj, v_proj = self.k_proj, self.v_proj
        tp = _shard.tp_state()
        if tp is not None:
            # the local heads: q and o_proj arrive split, k/v whole, of which
            # this rank takes its q heads' kv rows
            _tp_refusals(kv=kv, lora=lora)
            heads, kv_heads, rows = _tp_heads(cfg, tp)
            k_proj, v_proj = _Rows(self.k_proj, rows), _Rows(self.v_proj, rows)
            x = tp.copy(x)
        lora_on_qkv = lora is not None and any(t in lora.pairs for t in _QKV)
        fused = (pre_norm_scale is not None and kv is None and not cfg.fp8 and not lora_on_qkv
                 and fused_ops.prologue_supported(heads, kv_heads, cfg.head_dim,
                                                  b, s, x.shape[-1], device=x.device, dtype=dt))
        if fused:
            q, k, v = fused_ops.fused_qkv_prologue(
                x, pre_norm_scale, self.q_proj.weight, k_proj.weight, v_proj.weight,
                self.q_proj.bias, k_proj.bias, v_proj.bias, positions,
                eps=cfg.rms_norm_eps, norm_offset=cfg.norm_offset, num_heads=heads,
                num_kv_heads=kv_heads, head_dim=cfg.head_dim, theta=cfg.rope_theta,
                scaling=cfg.rope_scaling, dtype=dt,
            )
        else:
            if pre_norm_scale is not None:
                x = fused_ops.rms_norm_reference(x, pre_norm_scale, eps=cfg.rms_norm_eps,
                                                 norm_offset=cfg.norm_offset)
            q = _add_delta(self.q_proj(x), lora, x, "q_proj")
            k = _add_delta(k_proj(x), lora, x, "k_proj")
            v = _add_delta(v_proj(x), lora, x, "v_proj")
            q = q.reshape(b, s, heads, cfg.head_dim)
            k = k.reshape(b, s, kv_heads, cfg.head_dim)
            v = v.reshape(b, s, kv_heads, cfg.head_dim)
            q = rope(q, positions, cfg.rope_theta, cfg.rope_scaling)
            k = rope(k, positions, cfg.rope_theta, cfg.rope_scaling)
        if kv is not None:
            out = _decode_attention(q, k, v, positions, kv, cfg.sliding_window)
        else:
            out = dot_product_attention(
                q, k, v, mask=mask, causal=cfg.causal, kv_lengths=kv_lengths,
                implementation=cfg.attention_impl, window=cfg.sliding_window,
            )
            out = checkpoint_name(out, "attn_out", cfg)
        out = out.reshape(b, s, heads * cfg.head_dim)
        y = _add_delta(self.o_proj(out), lora, out, "o_proj")
        return y if tp is None else tp.reduce(y)


class MLP(nn.Module):
    """SwiGLU feed-forward (Llama family)."""

    def __init__(self, config: TransformerConfig, device=None, generator=None):
        super().__init__()
        self.config = config
        e, f = config.hidden_size, config.intermediate_size
        kw = dict(device=device, generator=generator)
        self.gate_proj = _proj(config, e, f, False, **kw)
        self.up_proj = _proj(config, e, f, False, **kw)
        self.down_proj = _proj(config, f, e, False, **kw)

    def forward(self, x, lora: Optional[LayerLora] = None):
        tp = _shard.tp_state()
        if tp is not None:  # gate/up split by columns, down by rows
            _tp_refusals(lora=lora)
            x = tp.copy(x)
        with named_products("mlp_gate_out"):
            gate = self.gate_proj(x)
        gate = _add_delta(gate, lora, x, "gate_proj")
        with named_products("mlp_up_out"):
            up = self.up_proj(x)
        up = _add_delta(up, lora, x, "up_proj")
        mid = F.silu(gate) * up
        y = _add_delta(self.down_proj(mid), lora, mid, "down_proj")
        return y if tp is None else tp.reduce(y)


def _top_k(probs: torch.Tensor, k: int):
    """The k largest values and their indices, the lower index first among
    equal values (``lax.top_k``'s order; ``torch.topk`` promises none)."""
    values, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


class MoE(nn.Module):
    """Mixtral-style sparse MoE: an fp32 router (top-k of its softmax,
    renormalised) and SwiGLU experts whose fp32 stacks (``gate_proj``,
    ``up_proj`` (E, h, f) and ``down_proj`` (E, f, h), lecun-normal) are cast
    to the compute dtype at the call. ``config.moe_dispatch``: ``"auto"``
    (``"ragged"`` on one device), ``"ragged"`` (grouped products, exact),
    ``"capacity"`` (static buffers, overflow dropped) or ``"dense"`` (every
    expert on every token, the O(E) oracle). The load-balancing loss of the
    last call is kept in ``aux_loss`` (the reference sows it as
    ``intermediates/moe_aux_loss``); the model's loss does not add it."""

    def __init__(self, config: TransformerConfig, device=None, generator=None):
        super().__init__()
        self.config = config
        E, h, f = config.num_experts, config.hidden_size, config.intermediate_size
        self.router = Dense(h, E, False, torch.float32, device, generator)

        def stack(*shape):
            # flax's lecun_normal on (E, in, out): fan_in = E * in
            std = (shape[0] * shape[1]) ** -0.5 / _TRUNC_STD
            w = torch.empty(shape, device=device)
            if not w.is_meta:
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
            return nn.Parameter(w)

        self.gate_proj = stack(E, h, f)
        self.up_proj = stack(E, h, f)
        self.down_proj = stack(E, f, h)
        self.aux_loss = None

    def forward(self, x):
        if _shard.tp_state() is not None:
            raise NotImplementedError("MoE experts under tensor parallelism are not ported yet: "
                                      "ROADMAP.md, queue A7 part 4 (its remainder; expert "
                                      "parallelism runs with tp_size 1)")
        cfg = self.config
        dt = _dtype(cfg)
        E, K = cfg.num_experts, cfg.num_experts_per_tok
        b, s, h = x.shape
        logits = self.router(x.float())  # (B, S, E) fp32
        weights, sel = _top_k(torch.softmax(logits, dim=-1), K)
        weights = weights / weights.sum(dim=-1, keepdim=True)
        w_gate, w_up, w_down = (w.to(dt) for w in (self.gate_proj, self.up_proj, self.down_proj))
        xc = x.to(dt)
        # "auto" is the grouped products: exact on one device, the
        # shard-capacity schedule under ep (reference :588-604)
        dispatch = "ragged" if cfg.moe_dispatch == "auto" else cfg.moe_dispatch
        ep = _shard.ep_state()
        sharded = ep is not None and w_gate.shape[0] != E  # this rank's shard of the stacks
        if ep is not None and dispatch == "ragged":
            sp = _shard.sp_state()
            split = (b, sp.size, s) if sp is not None and _shard.sequence_split() else None
            out = moe_ops.moe_ragged_ep(
                xc.reshape(b * s, h), sel.reshape(b * s, K), weights.reshape(b * s, K),
                w_gate, w_up, w_down, capacity_factor=cfg.moe_capacity_factor,
                experts_sharded=sharded, tokens=_shard.token_state(), seq_split=split)
            self.aux_loss = moe_ops.load_balancing_loss(logits, sel, E)
            return out.reshape(b, s, h).to(x.dtype)
        if sharded:  # the capacity and dense dispatches run every expert
            w_gate, w_up, w_down = (moe_ops.gather_experts(w) for w in (w_gate, w_up, w_down))
        if dispatch == "capacity" and ep is not None:
            # the reference's capacity is the global batch's: the tokens of
            # every token rank go through it, and this rank keeps its rows
            out = self._global_capacity(xc.reshape(b * s, h), sel.reshape(b * s, K),
                                        weights.reshape(b * s, K), w_gate, w_up, w_down)
            self.aux_loss = moe_ops.load_balancing_loss(logits, sel, E)
            return out.reshape(b, s, h).to(x.dtype)
        if dispatch == "ragged":
            out = moe_ops.moe_ragged(xc.reshape(b * s, h), sel.reshape(b * s, K),
                                     weights.reshape(b * s, K), w_gate, w_up, w_down)
        elif dispatch == "capacity":
            def experts_fn(buf):  # (E, C, h) -> (E, C, h)
                hidden = F.silu(torch.einsum("ech,ehf->ecf", buf, w_gate)) * torch.einsum(
                    "ech,ehf->ecf", buf, w_up)
                return torch.einsum("ecf,efh->ech", hidden, w_down)

            out = moe_ops.moe_dispatch_combine(
                xc.reshape(b * s, h), sel.reshape(b * s, K), weights.reshape(b * s, K),
                experts_fn, E, capacity_factor=cfg.moe_capacity_factor)
        else:  # "dense": combine weights as (B, S, E), zero for unselected experts
            combine = torch.zeros_like(logits).scatter_add(-1, sel, weights)
            hidden = F.silu(torch.einsum("bsh,ehf->ebsf", xc, w_gate)) * torch.einsum(
                "bsh,ehf->ebsf", xc, w_up)
            expert_out = torch.einsum("ebsf,efh->ebsh", hidden, w_down)
            out = torch.einsum("ebsh,bse->bsh", expert_out, combine.to(dt))
        self.aux_loss = moe_ops.load_balancing_loss(logits, sel, E)
        return out.reshape(b, s, h).to(x.dtype)

    def _global_capacity(self, x, sel, weights, w_gate, w_up, w_down):
        """The capacity dispatch over every token rank's tokens (gathered in
        the global batch's order), this rank's rows of the result."""
        cfg = self.config
        tokens = _shard.token_state()
        n, T = tokens.size, x.shape[0]
        if _shard.sequence_split() and _shard.sp_state() is not None:
            raise NotImplementedError(
                "moe_dispatch='capacity' under ep with the sequence split over sp: use "
                "'auto'/'ragged' (the shard-capacity schedule), or 'dense'")
        xs = moe_ops._GatherRows.apply(x, tokens.group, n) if n > 1 else x
        sels = moe_ops._gather_plain(sel, tokens.group, n) if n > 1 else sel
        ws = moe_ops._GatherRows.apply(weights, tokens.group, n) if n > 1 else weights

        def experts_fn(buf):  # (E, C, h) -> (E, C, h)
            hidden = F.silu(torch.einsum("ech,ehf->ecf", buf, w_gate)) * torch.einsum(
                "ech,ehf->ecf", buf, w_up)
            return torch.einsum("ecf,efh->ech", hidden, w_down)

        out = moe_ops.moe_dispatch_combine(xs, sels, ws, experts_fn, cfg.num_experts,
                                           capacity_factor=cfg.moe_capacity_factor)
        return out.narrow(0, tokens.rank * T, T) if n > 1 else out


class Block(nn.Module):
    def __init__(self, config: TransformerConfig, device=None, generator=None):
        super().__init__()
        self.config = config
        self.fused_kernels = config.fused_kernels
        e = config.hidden_size
        self.attn_norm = RMSNorm(config, e, device)
        self.attn = Attention(config, device, generator)
        self.mlp_norm = RMSNorm(config, e, device)
        if config.num_experts > 0:
            self.moe = MoE(config, device, generator)
        else:
            self.mlp = MLP(config, device, generator)

    def forward(self, x, positions, mask=None, kv_lengths=None, kv=None,
                lora: Optional[LayerLora] = None):
        attn_lora = None if lora is None else lora.only(_ATTN_TARGETS)
        if self.fused_kernels:
            # the fused prologue normalises inside its kernel: hand Attention
            # the raw residual stream and the norm's scale
            attn_out = self.attn(x, positions, mask, kv_lengths,
                                 pre_norm_scale=self.attn_norm.weight, kv=kv, lora=attn_lora)
        else:
            attn_out = self.attn(self.attn_norm(x), positions, mask, kv_lengths, kv=kv,
                                 lora=attn_lora)
        h = checkpoint_name(x + attn_out, "attn_res", self.config)
        if self.config.num_experts > 0:
            # MoE blocks take attention adapters only: the experts are the
            # specialisation there
            return h + self.moe(self.mlp_norm(h))
        mlp_lora = None if lora is None else lora.only(_MLP_TARGETS)
        return h + self.mlp(self.mlp_norm(h), lora=mlp_lora)


def _layer_stack(model: nn.Module, x, positions, mask=None, kv_lengths=None,
                 lora: Optional[LoraState] = None):
    """x through ``model.layers`` (the reference's ``_apply_layer_stack``),
    each layer under ``torch.utils.checkpoint`` with ``config.remat``'s
    policy while autograd records, with layer i's slice of ``lora``. Inside
    a sharded step (``parallel.runtime.sharded_forward``) each layer's
    parameters are gathered just before it runs."""
    remat = model.config.remat
    gather_all = _shard.layer_gather()
    for i, layer in enumerate(model.layers):
        layer_lora = None if lora is None else lora.layer(i)
        gather = None if gather_all is None else functools.partial(gather_all, f"layers.{i}.")
        if remat is not None and torch.is_grad_enabled():
            x = _remat(layer, remat, x, positions, mask, kv_lengths, lora=layer_lora,
                       gather=gather)
        elif gather is not None:  # the layer's whole weights live while it runs
            x = torch.func.functional_call(layer, gather(dict(layer.named_parameters())),
                                           (x, positions, mask, kv_lengths), {"lora": layer_lora})
        else:
            x = layer(x, positions, mask, kv_lengths, lora=layer_lora)
    return x


def _model_device(device) -> torch.device:
    """``device``; else the device of an enclosing ``torch.device`` context
    other than the CPU (``big_modeling.init_empty_weights``' meta device,
    ``init_on_device``); else CUDA, raising without it."""
    if device is not None:
        return torch.device(device)
    default = torch.get_default_device()
    return default if default.type != "cpu" else resolve_device(cpu=False)


def _model_generator(device: torch.device, generator: Optional[torch.Generator]):
    """``generator``, else a fresh one on ``device`` seeded 0; none on the
    meta device, where nothing is drawn."""
    if generator is None and device.type != "meta":
        generator = torch.Generator(device).manual_seed(0)
    return generator


def _embed_and_layers(model: nn.Module, config: TransformerConfig, device, generator):
    """The embedding, the Block stack and the final norm that the causal LM
    and the classifier share, made on ``device`` from ``generator``. On the
    meta device nothing is allocated and nothing drawn."""
    e = config.hidden_size
    model.embed = nn.Embedding(config.vocab_size, e, device=device)
    if not model.embed.weight.is_meta:
        with torch.no_grad():
            model.embed.weight.normal_(0.0, 0.02, generator=generator)
    model.layers = nn.ModuleList(
        Block(config, device, generator) for _ in range(config.num_layers)
    )
    model.final_norm = RMSNorm(config, e, device)


def _embed_tokens(model: nn.Module, input_ids: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """The embedding lookup; under tp a lookup into this rank's vocab rows,
    summed over tp."""
    tp = _shard.tp_state()
    weight = model.embed.weight.to(dt)
    if tp is None:
        return F.embedding(input_ids, weight)
    return tp.vocab_embedding(input_ids, weight)


def _logical_axes(model: nn.Module) -> dict[str, LeafAxes]:
    """Each parameter's logical axes as the reference declares them
    (``nn.with_partitioning`` in ``accelerate_tpu/models/transformer.py``
    :68, :156-159, :198-208, :565, :575, :751, :915, :1047, :1060) over the
    reference's shape: a layer's leaf stacked to ``(layers, ...)`` with a
    Dense kernel ``(in, out)``, so the port's ``(out, in)`` weight reads
    the reference's dims (2, 1). A Dense bias the reference leaves
    unannotated takes ``(None,)``, which the rules treat as the reference
    treats an empty spec."""
    cfg = model.config
    layers = cfg.num_layers
    kernels = {  # a Dense kernel's logical axes, (in, out)
        "attn.q_proj": ("embed", "heads"), "attn.k_proj": ("embed", "kv"),
        "attn.v_proj": ("embed", "kv"), "attn.o_proj": ("heads", "embed"),
        "mlp.gate_proj": ("embed", "mlp"), "mlp.up_proj": ("embed", "mlp"),
        "mlp.down_proj": ("mlp", "embed"), "moe.router": ("embed", None),
        "lm_head": ("embed", "vocab"), "pooler": ("embed", None),
        "classifier": ("embed", None),
    }
    biases = {"attn.q_proj": ("heads",), "attn.k_proj": ("kv",), "attn.v_proj": ("kv",)}
    stacks = {"moe.gate_proj": ("expert", "embed", "mlp"),
              "moe.up_proj": ("expert", "embed", "mlp"),
              "moe.down_proj": ("expert", "mlp", "embed")}
    out = {}
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        stacked = name.startswith("layers.")
        local = name.split(".", 2)[2] if stacked else name
        module, _, leaf = local.rpartition(".")
        if local in stacks:
            logical, ref, dims = stacks[local], shape, tuple(range(len(shape)))
        elif leaf == "weight" and module in kernels:
            logical, ref, dims = kernels[module], (shape[1], shape[0]), (1, 0)
        elif leaf == "bias":
            logical, ref, dims = biases.get(module, (None,)), shape, (0,)
        elif local.endswith("norm.weight"):
            logical, ref, dims = ("norm",), shape, (0,)
        elif local == "embed.weight":
            logical, ref, dims = (("vocab", "zero"), "embed"), shape, (0, 1)
        else:
            raise KeyError(f"no logical axes for parameter {name!r}")
        if stacked:
            logical, ref = ("layers",) + tuple(logical), (layers,) + tuple(ref)
            dims = tuple(d + 1 for d in dims)
        out[name] = LeafAxes(tuple(logical), tuple(ref), dims)
    return out


def next_token_targets(ids: torch.Tensor, mask: Optional[torch.Tensor] = None):
    """``(targets, weights)`` over every position of the whole rows: the
    next token of each position and its weight in the loss (``loss_mask``
    of the next position, or 1; 0 at the last position, which has no
    next token). The reference shifts the whole row (``ids[:, 1:]``
    against ``logits[:, :-1]``); taking a chunk of these keeps every
    target across chunk boundaries."""
    targets = torch.cat([ids[:, 1:], ids[:, -1:]], dim=1)
    w = torch.ones_like(ids, dtype=torch.float32) if mask is None else mask.float()
    weights = torch.cat([w[:, 1:], torch.zeros_like(w[:, :1])], dim=1)
    return targets, weights


def _target_share(length: int, ring: bool):
    """Under sp, the positions of the whole rows whose targets this rank's
    loss counts: its sequence chunk where the model splits the sequence
    (ring attention on a length sp tiles, ``CausalLM._sequence_chunk``),
    else its share of a near-even split (every sp rank then computes the
    whole sequence); None without sp."""
    sp = _shard.sp_state()
    if sp is None:
        return None
    bounds = sequence_chunk_bounds(length, sp.size, sp.rank) if ring else None
    if bounds is None:
        bounds = (length * sp.rank // sp.size, length * (sp.rank + 1) // sp.size)
    return bounds


def next_token_count(batch, ring: bool = False) -> torch.Tensor | float:
    """The terms a next-token loss averages over in ``batch``: the target
    tokens under ``loss_mask``, or every target token without one; under
    sp, those of this rank's share of the positions (``ring``: the model
    runs ring attention). The ``loss_weight`` of ``CausalLM.loss_fn`` and
    ``adapters.lora_loss_fn``, read by ``Accelerator`` to give the global
    batch's loss across processes."""
    mask = batch.get("loss_mask")
    ids = batch["input_ids"]
    share = _target_share(ids.shape[1], ring)
    if share is not None:
        _, weights = next_token_targets(ids, mask)
        return weights[:, share[0]:share[1]].sum()
    if mask is not None:
        return mask[:, 1:].float().sum()
    return float(ids.shape[0] * (ids.shape[1] - 1))


def next_token_loss(logits: torch.Tensor, batch, ring: bool = False) -> torch.Tensor:
    """The masked mean next-token cross-entropy of ``logits`` against
    ``batch["input_ids"]`` (the reference's ``CausalLM.loss_fn`` :938);
    under sp over this rank's share of the positions, its targets and mask
    taken from the whole rows (the logits hold only the chunk where the
    model split the sequence)."""
    ids = batch["input_ids"]
    mask = batch.get("loss_mask")
    share = _target_share(ids.shape[1], ring)
    if share is not None:
        targets, weights = next_token_targets(ids, mask)
        lo, hi = share
        if logits.shape[1] == ids.shape[1]:
            logits = logits[:, lo:hi]
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, targets[:, lo:hi, None])[..., 0]
        w = weights[:, lo:hi]
        return (nll * w).sum() / w.sum().clamp_min(1.0)
    targets = ids[:, 1:]
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    if mask is not None:
        mask = mask[:, 1:].float()
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()


class CausalLM(nn.Module):
    """The language model: embed -> L x Block -> norm -> lm_head.

    ``forward(input_ids, positions=None) -> logits`` in
    ``config.dtype``. ``forward(ids, decode=True, cache=DecodeCache)``
    writes into the dense decode cache at its index and advances it;
    ``forward(ids, decode=True, paged=PagedKVState, cache=PagedKVCache)``
    writes through the block tables. Under decode ``positions`` is
    ignored: token i sits at the cache's index + i, or cache_len + i of its
    slot, as in the reference. ``lora``: a :class:`~..adapters.LoraState`
    whose stacks, per batch row slot ids and scales add the adapters'
    deltas (training and serving alike). Parameters are made on ``device``
    (CUDA unless the caller passes ``device="cpu"``, or builds inside a
    ``torch.device`` context other than the CPU; raises without a CUDA
    device) from ``generator`` (a fresh one seeded 0 when none is given).
    On ``device="meta"`` (``big_modeling.init_empty_weights``) the model is
    shapes only: no generator, no draw, no byte allocated.
    """

    def __init__(self, config: TransformerConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_config(config)
        self.config = config
        device = _model_device(device)
        generator = _model_generator(device, generator)
        _embed_and_layers(self, config, device, generator)
        if not config.tie_embeddings:
            self.lm_head = Dense(config.hidden_size, config.vocab_size, False, _dtype(config),
                                 device, generator)

    def forward(self, input_ids, positions=None, decode=False,
                paged: Optional[PagedKVState] = None, cache=None,
                lora: Optional[LoraState] = None):
        cfg = self.config
        dt = _dtype(cfg)
        if decode and _shard.tp_state() is not None:
            _tp_refusals(kv=True)
        x = _embed_tokens(self, input_ids, dt)
        if decode:
            x = self._decode_layers(x, paged, cache, lora)
        elif paged is not None or cache is not None:
            raise ValueError("a paged state or a cache is read only with decode=True")
        else:
            if positions is None:
                positions = torch.arange(input_ids.shape[1], device=input_ids.device)
                positions = positions[None, :].expand(input_ids.shape)
            if _shard.sp_state() is not None:
                x, positions = self._sequence_chunk(x, positions)
            x = _layer_stack(self, x, positions, lora=lora)
        x = self.final_norm(x)
        tp = _shard.tp_state()
        if tp is not None:  # vocab-split logits, gathered over tp for the loss
            x = tp.copy(x)
        if cfg.tie_embeddings:
            logits = x.to(dt) @ self.embed.weight.to(dt).t()
        else:
            logits = self.lm_head(x)
        return logits if tp is None else tp.gather(logits, -1)

    def logical_axes(self) -> dict[str, LeafAxes]:
        """Every parameter's logical axes in the reference's layout, for
        ``parallel.sharding.infer_param_shardings``."""
        return _logical_axes(self)

    def _sequence_chunk(self, x, positions):
        """Under sp: this rank's chunk of the sequence and its global
        positions, where ring attention runs and sp tiles the length; the
        whole sequence otherwise (every sp rank then computes it, and the
        loss counts each rank's share of the targets)."""
        chunk = constrain_activations(x) if self.config.attention_impl == "ring" else x
        split = chunk is not x
        _shard.set_sequence_split(split)
        if split:
            positions = constrain_activations(positions)
        return chunk, positions

    def _decode_layers(self, x, paged, cache, lora=None):
        b, s = x.shape[:2]
        ar = torch.arange(s, device=x.device)
        if paged is not None:
            if not isinstance(cache, PagedKVCache):
                raise ValueError("paged decode needs the block pools: cache=PagedKVCache")
            if cache.kv_dtype != paged.kv_dtype:
                raise ValueError(f"the pools are {cache.kv_dtype!r} but the paged state says "
                                 f"{paged.kv_dtype!r}")
            positions = paged.cache_len[:, None].long() + ar[None, :]
        else:
            if not isinstance(cache, DecodeCache):
                raise ValueError("decode=True needs a cache: models.generation.init_cache")
            positions = (cache.index + ar)[None, :].expand(b, s)
        for i, layer in enumerate(self.layers):
            if paged is not None:
                key, value, key_scale, value_scale = cache.layer(i)
                kv = (key, value, paged, key_scale, value_scale)
            else:
                kv = (cache.key[i], cache.value[i], None, None, None)
            x = layer(x, positions, kv=kv, lora=None if lora is None else lora.layer(i))
        if paged is None:
            cache.index += s
        return x

    @staticmethod
    def loss_fn(model: "CausalLM"):
        """Next-token cross-entropy closure for ``Accelerator.unified_step``:
        ``loss_fn(params, batch)`` with ``params`` a name -> tensor dict of
        the model's parameters and ``batch`` {input_ids, [loss_mask]}."""

        ring = model.config.attention_impl == "ring"

        def fn(params, batch):
            logits = torch.func.functional_call(model, params, (batch["input_ids"],))
            return next_token_loss(logits, batch, ring)

        # read by the step's telemetry: whether the model runs the fused prologue
        fn.fused_kernels = bool(model.config.fused_kernels)
        # read by the step across processes: the loss is the global batch's
        fn.loss_weight = functools.partial(next_token_count, ring=ring)
        return fn


class SequenceClassifier(nn.Module):
    """The encoder classifier, the BERT-family fine-tune target (the
    reference's ``examples/nlp_example.py``): embed -> L x Block (run with
    ``config.causal=False``) -> norm -> masked mean-pool -> tanh ``pooler``
    -> fp32 ``classifier``.

    ``forward(input_ids, attention_mask=None) -> (B, num_labels)`` fp32
    logits, ``attention_mask`` 1 for a real token and 0 for padding.

    The mask is routed as the reference routes it: where the flash kernels
    run (``attention_impl="flash"``, or auto-dispatch choosing them) it is
    taken as right padding and lowered to per-row lengths, ``kv_lengths``;
    every other path applies the exact (B, 1, 1, S) key mask, right for
    any 0/1 pattern. On the flash path a row whose mask is not a prefix
    (left padding, holes) is set to NaN after the layers, so a wrong mask
    fails loudly; such masks need ``attention_impl="xla"``.

    Parameters are made on ``device`` (CUDA unless the caller passes
    ``device="cpu"``) from ``generator`` (a fresh one seeded 0 if none).
    """

    def __init__(self, config: TransformerConfig, num_labels: int = 2, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_config(config)
        if config.fused_kernels:
            raise NotImplementedError("not ported yet: fused_kernels=True on the classifier "
                                      "(the fused BERT path, queue A5); see ROADMAP.md")
        self.config = config
        self.num_labels = num_labels
        device = _model_device(device)
        generator = _model_generator(device, generator)
        _embed_and_layers(self, config, device, generator)
        e = config.hidden_size
        self.pooler = Dense(e, e, True, _dtype(config), device, generator)
        # logits in fp32: the softmax cross-entropy is where precision matters
        self.classifier = Dense(e, num_labels, True, torch.float32, device, generator)

    def forward(self, input_ids, attention_mask=None):
        cfg = self.config
        b, s = input_ids.shape
        positions = torch.arange(s, device=input_ids.device)[None, :].expand(b, s)
        mask4d = kv_lengths = is_prefix = None
        if attention_mask is not None:
            keep = attention_mask > 0
            use_flash = cfg.attention_impl == "flash" or (
                cfg.attention_impl is None
                and flash_self_attention_eligible(s, input_ids.device))
            if use_flash:
                # the flash wrapper takes a contiguous (B,) int32 tensor
                kv_lengths = keep.sum(dim=-1, dtype=torch.int32).contiguous()
                is_prefix = (keep[:, 1:] <= keep[:, :-1]).all(dim=-1)
            else:
                mask4d = keep[:, None, None, :]
        x = _embed_tokens(self, input_ids, _dtype(cfg))
        x = _layer_stack(self, x, positions, mask4d, kv_lengths)
        if is_prefix is not None:
            x = torch.where(is_prefix[:, None, None], x, torch.full_like(x, float("nan")))
        x = self.final_norm(x)
        if attention_mask is None:
            pooled = x.mean(dim=1)
        else:
            w = attention_mask[:, :, None].to(x.dtype)
            pooled = (x * w).sum(dim=1) / w.sum(dim=1).clamp_min(1.0)
        return self.classifier(torch.tanh(self.pooler(pooled)))

    def logical_axes(self) -> dict[str, LeafAxes]:
        """Every parameter's logical axes in the reference's layout."""
        return _logical_axes(self)

    @staticmethod
    def loss_fn(model: "SequenceClassifier"):
        """Cross-entropy closure for ``Accelerator.unified_step``:
        ``loss_fn(params, batch)`` with batch keys ``{input_ids, labels,
        [attention_mask]}``; the mean softmax cross-entropy of the fp32
        logits against the integer labels."""

        def fn(params, batch):
            logits = torch.func.functional_call(
                model, params, (batch["input_ids"], batch.get("attention_mask")))
            return F.cross_entropy(logits.float(), batch["labels"].long())

        # the terms the mean runs over, for the global batch across processes
        fn.loss_weight = lambda batch: float(len(batch["labels"]))
        return fn
