"""The port's decode cache and generation against the JAX reference, fp32 on the CPU.

The reference's tiny model (``TransformerConfig.tiny(max_seq_len=64)``, as
``tests/test_serving.py`` builds it) and its params, carried over with
``params_from_jax``, go through ``accelerate_tpu.models.generation`` and
``accelerate_tpu_torch.models.generation`` on the same prompts, made with
numpy from a seed. Greedy token ids must be identical; prefill and decode
logits agree within 2e-5 (fp32 on both sides, summed in another order).
``_filter_logits`` must give the reference's result exactly.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import flax.linen as nn  # noqa: E402
import torch  # noqa: E402

from accelerate_tpu.models import CausalLM as JaxCausalLM  # noqa: E402
from accelerate_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from accelerate_tpu.models import generation as jax_gen  # noqa: E402
from accelerate_tpu_torch import CausalLM, TransformerConfig, params_from_jax  # noqa: E402
from accelerate_tpu_torch.models import generation as gen  # noqa: E402

LOGITS_TOL = 2e-5
VARIANTS = {
    "tiny": dict(max_seq_len=64),
    "gqa_window": dict(max_seq_len=64, num_kv_heads=2, sliding_window=8),
}


@functools.lru_cache(maxsize=None)
def _pair(name):
    kw = VARIANTS[name]
    cfg = JaxConfig.tiny(**kw)
    model = JaxCausalLM(cfg)
    params = nn.unbox(model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    port_cfg = TransformerConfig.tiny(**kw)
    port = CausalLM(port_cfg, device="cpu")
    port.load_state_dict(params_from_jax(params, port_cfg), strict=True)
    return model, params, port


@pytest.fixture(scope="module")
def tiny_pair():
    return _pair("tiny")


def _prompts(batch, length, seed=0, vocab=1024):
    return np.random.default_rng(seed).integers(0, vocab, (batch, length)).astype(np.int32)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_and_decode_logits_match_reference(variant):
    model, params, port = _pair(variant)
    ids = _prompts(2, 13)
    cache = jax_gen.init_cache(model.init, jax.random.PRNGKey(0),
                               jnp.zeros((2, 1), jnp.int32), decode=True)
    want, mutated = model.apply({"params": params, "cache": cache}, jnp.asarray(ids),
                                decode=True, mutable=["cache"])
    nxt = jnp.argmax(want[:, -1], axis=-1)[:, None]
    want2, _ = model.apply({"params": params, "cache": mutated["cache"]}, nxt, decode=True,
                           mutable=["cache"])
    port_cache = gen.init_cache(port, 2)
    with torch.no_grad():
        got = port(torch.as_tensor(ids).long(), decode=True, cache=port_cache)
        got2 = port(torch.tensor(np.asarray(nxt)).long(), decode=True, cache=port_cache)
    assert int(port_cache.index) == 14
    for g, w in ((got, want), (got2, want2)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=LOGITS_TOL, rtol=LOGITS_TOL)


@pytest.mark.parametrize("variant,batch,length,new", [
    ("tiny", 2, 13, 6), ("tiny", 1, 3, 9), ("gqa_window", 3, 32, 4)])
def test_generate_greedy_tokens_match_reference(variant, batch, length, new):
    model, params, port = _pair(variant)
    ids = _prompts(batch, length, seed=length)
    want = np.asarray(jax_gen.generate(model, params, jnp.asarray(ids), max_new_tokens=new))
    got = gen.generate(port, torch.as_tensor(ids), max_new_tokens=new)
    assert got.device == torch.device("cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_eos_freezing_matches_reference(tiny_pair):
    """EOS is a token greedy decoding emits mid-generation in row 0: after
    it, that row repeats EOS in both packages while the others go on."""
    model, params, port = tiny_pair
    ids = _prompts(3, 7, seed=4)
    free = gen.generate(port, torch.as_tensor(ids), max_new_tokens=8).numpy()
    eos = int(free[0, 7 + 2])
    want = np.asarray(jax_gen.generate(model, params, jnp.asarray(ids), max_new_tokens=8,
                                       eos_token_id=eos))
    got = gen.generate(port, torch.as_tensor(ids), max_new_tokens=8, eos_token_id=eos).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0, 7 + 2:] == eos).all() and not (free[0, 7 + 2:] == eos).all()


def test_make_generate_fn_bucketed_prefill_matches_reference(tiny_pair):
    """Prompts of several lengths through one closure: power-of-two
    prefill chunks, tokens identical to the reference's closure, and the
    same program counts."""
    model, params, port = tiny_pair
    want_fn = jax_gen.make_generate_fn(model, max_new_tokens=5)
    got_fn = gen.make_generate_fn(port, max_new_tokens=5)
    for batch, length in ((2, 13), (2, 7), (1, 13), (2, 16)):
        ids = _prompts(batch, length, seed=batch * 100 + length)
        want = np.asarray(want_fn(params, jnp.asarray(ids)))
        got = got_fn(torch.as_tensor(ids)).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, gen.generate(port, torch.as_tensor(ids), max_new_tokens=5).numpy())
    assert got_fn.trace_counts() == want_fn.trace_counts() == {"prefill": 8, "decode": 2}


def test_prompt_chunks_are_the_reference_decomposition():
    for n in (1, 2, 3, 13, 64, 127):
        assert gen._prompt_chunks(n) == jax_gen._prompt_chunks(n)
        assert sum(gen._prompt_chunks(n)) == n


@pytest.mark.parametrize("top_k,top_p", [(5, None), (1, None), (None, 0.9), (None, 0.3),
                                         (20, 0.5), (None, 1.0)])
def test_filter_logits_matches_reference(top_k, top_p):
    logits = (np.random.default_rng(7).standard_normal((4, 64)) * 3).astype(np.float32)
    want = np.asarray(jax_gen._filter_logits(jnp.asarray(logits), top_k, top_p))
    got = gen._filter_logits(torch.as_tensor(logits), top_k, top_p).numpy()
    np.testing.assert_array_equal(got, want)


def test_sampled_generation_stays_in_the_top_k_support(tiny_pair):
    """At temperature > 0 with top-k 3 every new token is one of the 3
    largest logits of its step (read back by re-running the prefix)."""
    _, _, port = tiny_pair
    ids = torch.as_tensor(_prompts(2, 5, seed=11))
    out = gen.generate(port, ids, max_new_tokens=4, temperature=1.5, top_k=3,
                       generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        logits = port(out[:, :-1])
    for t in range(5, out.shape[1]):
        top3 = torch.topk(logits[:, t - 1], 3).indices
        assert all(int(out[b, t]) in top3[b].tolist() for b in range(2))
