"""The port's remat policies, on the CPU in fp32.

* Every policy gives the gradients of the step without remat, bit for bit:
  the recompute runs the same ops on the same inputs.
* Each policy keeps what it says and no more: the selective-checkpoint
  cache holds exactly the outputs of the products (``"dots"``: every
  ``mm`` and ``bmm``; ``"dots_with_no_batch_dims"``: no ``bmm``) or the
  named tensors (``"save_attn"``, ``"save_mlp"``), and the backward reruns
  exactly the forward products that were not kept (``"full"`` keeps only
  the layer's inputs, so it reruns them all but the last, where the
  recompute stops early).
* ``"save_mlp"``'s gradients against the reference's under the same
  policy: 2e-5 of the largest reference magnitude.
* The flash forward runs as often a step under each policy as the
  reference's Pallas forward appears in the jaxpr of its remat'd gradient:
  once a layer without remat and twice with any policy (its lse is not a
  saved tensor in either package), dq and dk/dv once a layer.
"""

import collections

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import flax.linen as nn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import accelerate_tpu_torch as port  # noqa: E402
from accelerate_tpu.models.config import TransformerConfig as JaxConfig  # noqa: E402
from accelerate_tpu.models.transformer import CausalLM as JaxCausalLM  # noqa: E402
from accelerate_tpu_torch.models import transformer  # noqa: E402
from accelerate_tpu_torch.ops import flash_attention as fa  # noqa: E402

TOL = 2e-5
POLICIES = ("full", "dots", "dots_ragged", "dots_with_no_batch_dims", "save_attn", "save_mlp")
MODEL = dict(vocab_size=256, hidden_size=64, intermediate_size=160, num_layers=2, num_heads=4,
             num_kv_heads=2, max_seq_len=64)
# per layer of MODEL (7 projections, plain attention's two bmm): the outputs
# each policy's cache keeps, and the forward products the backward reruns
KEPT = {"dots": {"mm": 7, "bmm": 2}, "dots_ragged": {"mm": 7, "bmm": 2},
        "dots_with_no_batch_dims": {"mm": 7}, "save_attn": {"checkpoint_name": 1},
        "save_mlp": {"checkpoint_name": 2, "mm": 2}}
RERUN = {None: {"mm": 0, "bmm": 0}, "full": {"mm": 6, "bmm": 2}, "dots": {"mm": 0, "bmm": 0},
         "dots_ragged": {"mm": 0, "bmm": 0}, "dots_with_no_batch_dims": {"mm": 0, "bmm": 2},
         "save_attn": {"mm": 6, "bmm": 2}, "save_mlp": {"mm": 4, "bmm": 2}}


def _grads(kw, seed=0):
    model = port.CausalLM(port.TransformerConfig(**kw), device="cpu",
                          generator=torch.Generator().manual_seed(seed))
    params = dict(model.named_parameters())
    ids = torch.from_numpy(np.random.default_rng(seed).integers(0, kw["vocab_size"], (2, 16)))
    loss = port.CausalLM.loss_fn(model)(params, {"input_ids": ids})
    return loss, params


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("family", ["llama", "moe"])
def test_policy_grads_equal_no_remat_bitwise(policy, family):
    kw = dict(MODEL, **({"num_experts": 4} if family == "moe" else {}))
    loss, params = _grads(kw)
    want = torch.autograd.grad(loss, list(params.values()))
    loss_r, params_r = _grads(dict(kw, remat=policy))
    got = torch.autograd.grad(loss_r, list(params_r.values()))
    assert torch.equal(loss_r, loss)
    for name, g, w in zip(params, got, want):
        assert torch.equal(g, w), name


class _CountProducts(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy", (None,) + POLICIES)
def test_policy_keeps_what_it_says(policy, monkeypatch):
    contexts = []
    make = transformer.create_selective_checkpoint_contexts

    def recording(policy_fn, *args, **kwargs):
        contexts.append(make(policy_fn, *args, **kwargs))
        return contexts[-1]

    monkeypatch.setattr(transformer, "create_selective_checkpoint_contexts", recording)
    loss, params = _grads(MODEL)
    with _CountProducts() as base:
        torch.autograd.grad(loss, list(params.values()))
    loss, params = _grads(dict(MODEL, remat=policy))
    layers = MODEL["num_layers"]
    if policy in KEPT:
        assert len(contexts) == layers
        for caching, _ in contexts:
            kept = collections.Counter(
                key.overloadpacket.__name__ if hasattr(key, "overloadpacket") else str(key)
                for key, entries in caching.storage.items()
                for value in entries.values() if value is not torch.utils.checkpoint._RECOMPUTE)
            assert dict(kept) == KEPT[policy]
    else:
        assert not contexts  # no remat, or "full": the layer's inputs alone
    with _CountProducts() as run:
        torch.autograd.grad(loss, list(params.values()))
    rerun = {op: run.counts[op] - base.counts[op] for op in ("mm", "bmm")}
    assert rerun == {op: n * layers for op, n in RERUN[policy].items()}


def test_policy_sets_name_their_ops():
    ctx = torch.utils.checkpoint.SelectiveCheckpointContext(is_recompute=False)
    save = torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    grouped, bmm = torch.ops.aten._grouped_mm.default, torch.ops.aten.bmm.default
    scaled = torch.ops.aten._scaled_mm.default
    assert transformer.REMAT_POLICIES["dots_ragged"](ctx, grouped) == save
    assert transformer.REMAT_POLICIES["dots"](ctx, grouped) != save
    assert transformer.REMAT_POLICIES["dots"](ctx, scaled) == save
    assert transformer.REMAT_POLICIES["dots_with_no_batch_dims"](ctx, bmm) != save
    with pytest.raises(ValueError, match="unknown remat policy"):
        port.CausalLM(port.TransformerConfig(**dict(MODEL, remat="offload")), device="cpu")


def test_save_mlp_grads_match_jax():
    kw = dict(MODEL, remat="save_mlp")
    jmodel = JaxCausalLM(JaxConfig(**kw))
    params = jax.tree.map(np.asarray, nn.unbox(jmodel.init_params(jax.random.PRNGKey(0),
                                                                   seq_len=16)))
    ids = np.random.default_rng(1).integers(0, kw["vocab_size"], (2, 16)).astype(np.int32)
    jloss, jgrads = jax.value_and_grad(JaxCausalLM.loss_fn(jmodel))(
        params, {"input_ids": jnp.asarray(ids)})
    model = port.CausalLM(port.TransformerConfig(**kw), device="cpu")
    model.load_state_dict(port.params_from_jax(params, model.config), strict=True)
    tparams = dict(model.named_parameters())
    loss = port.CausalLM.loss_fn(model)(tparams, {"input_ids": torch.from_numpy(ids).long()})
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=TOL)
    grads = torch.autograd.grad(loss, list(tparams.values()))
    want = port.params_from_jax(jax.tree.map(np.asarray, jgrads), model.config)
    for name, g in zip(tparams, grads):
        scale = float(want[name].abs().max()) + 1e-12
        np.testing.assert_allclose(g.numpy() / scale, want[name].numpy() / scale, atol=TOL,
                                   err_msg=name)


def _reference_pallas_calls(remat):
    """The reference's Pallas calls in the jaxpr of its gradient (traced,
    not run), unrolled layers: forward (O and lse), dq, dk/dv."""
    kw = dict(MODEL, hidden_size=32, intermediate_size=64, attention_impl="flash",
              remat=remat, scan_layers=False)
    params = nn.unbox(JaxCausalLM(JaxConfig(**dict(kw, attention_impl="xla"))).init_params(
        jax.random.PRNGKey(0), seq_len=32))
    jaxpr = jax.make_jaxpr(jax.grad(JaxCausalLM.loss_fn(JaxCausalLM(JaxConfig(**kw)))))(
        params, {"input_ids": jnp.zeros((2, 32), jnp.int32)}).jaxpr
    counts = collections.Counter()

    def walk(jp):
        for eqn in jp.eqns:
            if eqn.primitive.name == "pallas_call":
                shapes = [a.shape for a in eqn.params["out_avals"]]
                kind = ("dq" if len(shapes) == 1 else
                        "dkv" if shapes[0] == shapes[1] else "fwd")
                counts[kind] += 1
            for value in eqn.params.values():
                for sub in value if isinstance(value, (list, tuple)) else (value,):
                    inner = getattr(sub, "jaxpr", sub)
                    if hasattr(inner, "eqns"):
                        walk(inner)

    walk(jaxpr)
    return dict(counts)


@pytest.mark.parametrize("policy", (None,) + POLICIES)
def test_flash_forward_calls_equal_reference_pallas_calls(policy, monkeypatch):
    counts = collections.Counter()
    for kind in ("fwd", "dq", "dkv"):
        plain = getattr(fa, f"flash_{'fwd' if kind == 'fwd' else 'bwd_' + kind}_reference")

        def counted(*args, _plain=plain, _kind=kind, **kwargs):
            counts[_kind] += 1
            return _plain(*args, **kwargs)

        monkeypatch.setattr(fa, plain.__name__, counted)
    loss, params = _grads(dict(MODEL, hidden_size=32, intermediate_size=64,
                               attention_impl="flash", remat=policy))
    torch.autograd.grad(loss, list(params.values()))
    layers = MODEL["num_layers"]
    want = {"fwd": layers * (1 if policy is None else 2), "dq": layers, "dkv": layers}
    assert dict(counts) == want
    assert _reference_pallas_calls(policy) == want


@pytest.mark.parametrize("policy", POLICIES)
def test_bf16_unified_steps_under_each_policy_equal_no_remat(policy):
    """Inside ``unified_step`` the layers see bf16 copies of the fp32
    masters (``functional_call``), and the recompute runs after that call
    has put the masters back: it must replay the same ops on the same
    copies. Two bf16 steps with clip 1.0 give the params of the steps
    without remat, bit for bit."""
    ids = np.random.default_rng(3).integers(0, MODEL["vocab_size"], (4, 16))
    dataset = [{"input_ids": row} for row in ids]
    finals = []
    for remat in (None, policy):
        port.AcceleratorState._reset_state(reset_partial_state=True)
        port.GradientState._reset_state()
        acc = port.Accelerator(mixed_precision="bf16", cpu=True)
        model = port.CausalLM(port.TransformerConfig(**dict(MODEL, remat=remat,
                                                            dtype="bfloat16")),
                              device="cpu", generator=torch.Generator().manual_seed(0))
        model, opt, loader = acc.prepare(model, port.adamw(1e-3),
                                         port.DataLoader(dataset, batch_size=2))
        step = acc.unified_step(port.CausalLM.loss_fn(model), opt, max_grad_norm=1.0)
        carry = acc.init_carry(model, opt)
        for batch in loader:
            carry, _ = step(carry, batch)
        finals.append({k: p.detach().clone() for k, p in carry["params"].items()})
    port.AcceleratorState._reset_state(reset_partial_state=True)
    port.GradientState._reset_state()
    assert [k for k in finals[0] if not torch.equal(finals[0][k], finals[1][k])] == []
