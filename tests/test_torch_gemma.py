"""The Gemma and Gemma-2 switches of the port's ``CausalLM`` against the JAX
reference's, on the CPU.

* Each switch alone on the tiny model (vocab 128, width 64, MLP 96, 3
  layers of 4 query and 2 kv heads of 16), then Gemma's trio and the whole
  Gemma-2 set, with the reference's weights nudged off their init (so the
  zero-initialised offset norms and the biases of the layout matter) and
  carried by ``params_from_jax``: logits, the next-token loss and every
  gradient within ``TOL`` of the reference's, relative to the largest value
  of each tensor. The caps are small (scores and logits of the tiny model
  sit in tanh's bend there) so that each switch moves the numbers.
* ``xla_attention``, ``paged_attention`` and ``dot_product_attention``
  with a softcap and a per-layer window (a 0-d tensor, the reference's
  traced one) against the reference's, and the dispatch's refusals.
* The serving engine over the tiny Gemma-2 (paged attention with the
  softcap, the per-layer windows and the post norms): tokens and trace
  counts against the reference's engine.
* The plain flash versions at head_dim 256 (Gemma's) against the Pallas
  kernels in interpret mode, two cases at S 256.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import flax.linen as nn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import accelerate_tpu.ops.attention as jax_attn  # noqa: E402
import accelerate_tpu.serving as jax_serving  # noqa: E402
from accelerate_tpu.models import CausalLM as JaxCausalLM  # noqa: E402
from accelerate_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from accelerate_tpu.ops import flash_attention as jfa  # noqa: E402

import accelerate_tpu_torch as port  # noqa: E402
from accelerate_tpu_torch import serving  # noqa: E402
from accelerate_tpu_torch.models.transformer import layer_windows  # noqa: E402
from accelerate_tpu_torch.ops import attention as attn  # noqa: E402
from accelerate_tpu_torch.ops import flash_attention as tfa  # noqa: E402

TOL = 2e-5
FLASH_TOL = 1e-5  # the flash parity file's: fp32 both sides, online against one-pass
BASE = dict(vocab_size=128, hidden_size=64, intermediate_size=96, num_layers=3, num_heads=4,
            num_kv_heads=2, head_dim=16, max_seq_len=64, rope_theta=10000.0,
            tie_embeddings=True, attention_impl="xla")
GEMMA = dict(norm_offset=True, embed_scale=True, mlp_activation="gelu_tanh")
GEMMA2 = dict(GEMMA, post_norms=True, attn_softcap=2.0, final_softcap=3.0,
              query_pre_attn_scalar=24.0, layer_windows=(4, None, 6))
SWITCHES = {
    "norm_offset": dict(norm_offset=True),
    "embed_scale": dict(embed_scale=True),
    "gelu_tanh": dict(mlp_activation="gelu_tanh"),
    "post_norms": dict(post_norms=True),
    "attn_softcap": dict(attn_softcap=2.0),
    "final_softcap": dict(final_softcap=3.0),
    "query_pre_attn_scalar": dict(query_pre_attn_scalar=24.0),
    "layer_windows": dict(layer_windows=(4, None, 6)),
    "gemma": GEMMA,
    "gemma2": GEMMA2,
}
SEQ = 12


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for the module: beside the suite's other workers,
    torch's threads oversubscribe the cores (the copy task read 75.7 s at
    8 threads beside five busy workers, 13.2 s alone at 1)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _reference(kw, seed=0, embed=2.0, other=0.1):
    """The reference's model and its params, every leaf nudged by ``other``
    of a normal draw and the embedding by ``embed`` (2.0: scores and logits
    reach the caps; for decoding, whose greedy tokens must not be ties in
    the caps' flat tails, 0 and 0.3 keep the tied head from copying the
    last token)."""
    model = JaxCausalLM(JaxConfig(**BASE, **kw))
    params = nn.unbox(model.init_params(jax.random.PRNGKey(seed), seq_len=SEQ))
    flat = jax.tree_util.tree_flatten_with_path(params)
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), len(flat[0]))
    leaves = []
    for (path, x), k in zip(flat[0], keys):
        scale = embed if "embed" in jax.tree_util.keystr(path) else other
        leaves.append(x + scale * jax.random.normal(k, x.shape))
    return model, jax.tree.unflatten(flat[1], leaves)


def _port(params, kw):
    cfg = port.TransformerConfig(**BASE, **kw)
    model = port.CausalLM(cfg, device="cpu")
    model.load_state_dict(port.params_from_jax(params, cfg), strict=True)
    return model


@pytest.mark.parametrize("case", list(SWITCHES))
def test_switch_matches_the_reference(case):
    kw = SWITCHES[case]
    jm, params = _reference(kw)
    ids = np.random.default_rng(0).integers(0, BASE["vocab_size"], (2, SEQ)).astype(np.int32)
    jids = jnp.asarray(ids)

    def loss_and_logits(p):  # the reference's loss_fn, keeping its logits
        logits = jm.apply({"params": p}, jids)
        logp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32), axis=-1)
        return -jnp.take_along_axis(logp, jids[:, 1:, None], axis=-1).mean(), logits

    (want_loss, want_logits), want_grads = jax.value_and_grad(loss_and_logits,
                                                              has_aux=True)(params)
    want_logits = np.asarray(want_logits)
    model = _port(params, kw)
    tparams = dict(model.named_parameters())
    tids = torch.from_numpy(ids).long()
    logits = torch.func.functional_call(model, tparams, (tids,))
    assert _rel(logits.detach().numpy(), want_logits) <= TOL
    loss = port.CausalLM.loss_fn(model)(tparams, {"input_ids": tids})
    assert abs(loss.item() - float(want_loss)) <= TOL * abs(float(want_loss))
    grads = dict(zip(tparams, torch.autograd.grad(loss, list(tparams.values()))))
    want = port.params_from_jax(jax.tree.map(np.asarray, want_grads), model.config)
    assert set(grads) == set(want)
    for name, g in grads.items():
        assert _rel(g.numpy(), want[name].numpy()) <= TOL, name
    if "post_norms" not in kw:  # the switch is live: without it the logits move
        with torch.no_grad():
            assert _rel(_port(params, {})(tids).numpy(), want_logits) > 1e-3


def test_norm_offset_initialises_to_identity():
    model = port.CausalLM(port.TransformerConfig(**BASE, norm_offset=True), device="cpu")
    norm = model.layers[0].attn_norm
    assert torch.equal(norm.weight, torch.zeros(BASE["hidden_size"]))
    x = torch.randn(2, 3, BASE["hidden_size"])
    plain = port.CausalLM(port.TransformerConfig(**BASE), device="cpu").layers[0].attn_norm
    torch.testing.assert_close(norm(x), plain(x), rtol=0, atol=0)


def _qkv(b=2, s=10, skv=10, h=4, hkv=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d)).astype(np.float32) * 3,
            rng.standard_normal((b, skv, hkv, d)).astype(np.float32) * 3,
            rng.standard_normal((b, skv, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("window", [None, 4], ids=["full", "window4"])
def test_softcap_and_per_layer_window_attention_match_the_reference(window):
    q, k, v = _qkv()
    mask = np.ones((2, 1, 1, 10), bool)
    mask[1, ..., 7:] = False
    kw = dict(scale=24.0 ** -0.5, causal=True, softcap=2.0)
    jwin = None if window is None else jnp.asarray(window, jnp.int32)  # traced-like
    twin = None if window is None else torch.tensor(window)
    want = jax_attn.xla_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                  mask=jnp.asarray(mask), window=jwin, **kw)
    got = attn.xla_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                             mask=torch.from_numpy(mask), window=twin, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    # auto dispatch takes the plain path with either; so does an explicit "xla"
    for impl in (None, "xla"):
        out = attn.dot_product_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                         window=twin, implementation=impl, **kw)
        ref = jax_attn.dot_product_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                             window=jwin, implementation=impl, **kw)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)
    # the paged path: the same rows written through a block table
    bs, nb = 4, 8
    table = np.asarray([[3, 1, 5], [2, 6, 4]], np.int32)
    arrays = dict(block_table=table, cache_len=np.zeros(2, np.int32),
                  lengths=np.full(2, 10, np.int32))
    jstate = jax_attn.PagedKVState(**{n: jnp.asarray(a) for n, a in arrays.items()},
                                   num_blocks=nb, block_size=bs)
    pools = np.zeros((nb, bs, 2, 16), np.float32)
    jk, jv = jax_attn.paged_update(jnp.asarray(pools), jnp.asarray(pools), jnp.asarray(k),
                                   jnp.asarray(v), jstate)
    want = jax_attn.paged_attention(jnp.asarray(q), jk, jv, jstate, scale=kw["scale"],
                                    softcap=2.0, window=jwin)
    state = attn.PagedKVState(**{n: torch.as_tensor(a) for n, a in arrays.items()},
                              num_blocks=nb, block_size=bs)
    pk, pv = torch.zeros(pools.shape), torch.zeros(pools.shape)
    attn.paged_update(pk, pv, torch.from_numpy(k), torch.from_numpy(v), state)
    got = attn.paged_attention(torch.from_numpy(q), pk, pv, state, scale=kw["scale"],
                               softcap=2.0, window=twin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_flash_and_ring_refuse_softcap_and_per_layer_windows():
    q, k, v = (torch.from_numpy(x) for x in _qkv())
    jq, jk, jv = (jnp.asarray(x.numpy()) for x in (q, k, v))
    for impl in ("flash", "ring"):
        for kw, jkw in ((dict(softcap=2.0), dict(softcap=2.0)),
                        (dict(window=torch.tensor(4)), dict(window=jnp.asarray(4)))):
            with pytest.raises(ValueError, match="soft-capping"):
                attn.dot_product_attention(q, k, v, causal=True, implementation=impl, **kw)
            with pytest.raises(ValueError, match="soft-capping"):
                jax_attn.dot_product_attention(jq, jk, jv, causal=True, implementation=impl,
                                               **jkw)


def test_layer_windows_are_tensors_with_the_full_sentinel():
    cfg = port.TransformerConfig(**BASE, layer_windows=(4, None, 6))
    ws = layer_windows(cfg, "cpu")
    assert [int(w) for w in ws] == [4, 1 << 30, 6] and all(w.dim() == 0 for w in ws)
    assert layer_windows(port.TransformerConfig(**BASE), "cpu") is None


def test_engine_over_gemma2_matches_the_reference():
    """Five requests through two slots: the tiny Gemma-2 under the paged
    decode (softcap, per-layer windows, post norms), tokens and trace counts
    against the reference's engine."""
    jm, params = _reference(GEMMA2, seed=3, embed=0.0, other=0.3)
    model = _port(params, GEMMA2)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, BASE["vocab_size"], n).tolist() for n in (3, 9, 5, 12, 1)]
    results = {}
    for name, engine in (("reference", jax_serving.ServingEngine(jm, params, max_slots=2,
                                                                 block_size=4, num_blocks=16)),
                         ("port", serving.ServingEngine(model, max_slots=2, block_size=4,
                                                        num_blocks=16))):
        for i, p in enumerate(prompts):
            engine.add_request(p, max_new_tokens=6, temperature=0.0, request_id=f"r{i}")
        while engine.has_work:
            engine.step()
        results[name] = ([engine.result(f"r{i}") for i in range(len(prompts))],
                         engine.trace_counts())
    assert results["port"][0] == results["reference"][0]
    assert len({t for r in results["port"][0] for t in r}) > 8  # not a copy of one token
    assert results["port"][1]["decode"] == results["reference"][1]["decode"] == 1
    assert results["port"][1]["prefill"] == results["reference"][1]["prefill"]


@pytest.mark.parametrize("case", [dict(causal=True, lens=None), dict(causal=False,
                                                                   lens=[256, 100])],
                         ids=["causal_gqa", "noncausal_lengths"])
def test_plain_flash_at_head_dim_256_matches_pallas_interpret(case):
    """The port's plain flash versions at Gemma's head_dim against the
    reference's Pallas kernels in interpret mode (the card holds the
    kernels against these plain versions)."""
    rng = np.random.default_rng(7)
    B, S, H, Hkv, D = 2, 256, 2, 1, 256
    q, k, v, dout = (rng.standard_normal(shape).astype(np.float32) for shape in
                     ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D), (B, S, H, D)))
    causal, lens = case["causal"], case["lens"]
    lengths = None if lens is None else jnp.asarray(lens, jnp.int32)

    def loss(q, k, v):
        out = jfa.flash_attention(q, k, v, causal=causal, kv_lengths=lengths,
                                  block_q=128, block_k=128)
        return jnp.sum(out * dout), out

    with jfa.kernel_interpret_mode():
        grads, want = jax.grad(loss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    tl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    out = tfa.flash_attention(tq, tk, tv, causal=causal, kv_lengths=tl)
    (out * torch.from_numpy(dout)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=FLASH_TOL,
                               rtol=FLASH_TOL)
    for name, got, g in zip("qkv", (tq.grad, tk.grad, tv.grad), grads):
        g = np.asarray(g)
        scale = np.abs(g).max() + 1e-12
        np.testing.assert_allclose(got.numpy() / scale, g / scale, atol=FLASH_TOL,
                                   err_msg=f"d{name}")


def test_wmma_tiles_fit_every_head_dim_up_to_256():
    """Every head_dim that is a multiple of 16 up to 256 fits all four
    wmma-design kernels' shared tiles in the 227 KB a block may opt into
    (``wmma_smem_bytes`` is the launcher's carve on the host; the card holds
    it against the C one, ``flash_wmma_smem``), with the shorter tiles above
    128; and the wrapper's limit is 256."""
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for d in range(16, 257, 16):
            worst = max(tfa.wmma_smem_bytes(k, dtype, d) for k in ("fwd", "dq", "dkv", "fused"))
            assert worst <= tfa.MAX_DYNAMIC_SMEM, (dtype, d, worst)
    assert tfa.wmma_tiles(torch.bfloat16, 128) == (64, 64)
    assert tfa.wmma_tiles(torch.bfloat16, 256) == (32, 32)
    assert tfa.wmma_tiles(torch.float32, 256) == (16, 32)
    assert tfa._MAX_HEAD_DIM == 256
