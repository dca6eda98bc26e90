"""Ring attention on the port over gloo, against the reference.

Mirrors ``tests/test_ring_attention.py``: the forward, causal and not, and
the gradients at sp 4 (one world-4 launch; each rank holds its contiguous
chunk of the sequence and returns its chunk of the output), against the
reference's dense ``xla_attention`` and its own ring on its sp mesh; the
fallback at sp 1; and the 32k-token proof point, slow as in the
reference, at sp 4 with the dense path made to raise. The port's ring
refuses masks and windows as the reference's does.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from accelerate_tpu.ops.attention import xla_attention  # noqa: E402
from accelerate_tpu.ops.ring_attention import ring_attention  # noqa: E402
from accelerate_tpu.parallel.mesh import build_mesh as jax_build_mesh  # noqa: E402
from accelerate_tpu.utils.dataclasses import ParallelismPlugin as JaxPlugin  # noqa: E402

from accelerate_tpu_torch.launchers import debug_launcher  # noqa: E402
from accelerate_tpu_torch.test_utils.scripts import pipeline_workers  # noqa: E402


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("ring")
    debug_launcher(pipeline_workers.ring_worker, (str(out),), num_processes=4)
    return [torch.load(os.path.join(out, f"ring_{r}.pt")) for r in range(4)]


def _qkv(S=64, B=4, H=4, Hkv=2, D=16, seed=0):
    rng = np.random.default_rng(seed)
    return (jnp.asarray(rng.normal(size=(B, S, H, D)), jnp.float32),
            jnp.asarray(rng.normal(size=(B, S, Hkv, D)), jnp.float32),
            jnp.asarray(rng.normal(size=(B, S, Hkv, D)), jnp.float32))


def _whole(records, key, index=None):
    """The ranks' sequence chunks, in sp order, put back together."""
    parts = sorted(records, key=lambda r: r["sp"])
    return np.concatenate([(r[key] if index is None else r[key][index]).detach().numpy()
                           for r in parts], axis=1)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_matches_reference(records, causal):
    q, k, v = _qkv()
    ref = xla_attention(q, k, v, causal=causal)
    mesh = jax_build_mesh(JaxPlugin(dp_size=2, sp_size=4, fsdp_size=1))
    sharding = NamedSharding(mesh, P("dp", "sp", None, None))
    qs, ks, vs = (jax.device_put(x, sharding) for x in (q, k, v))
    theirs = jax.jit(lambda q, k, v: ring_attention(q, k, v, causal=causal, mesh=mesh))(qs, ks, vs)
    got = _whole(records, f"out_{causal}")
    np.testing.assert_allclose(got, np.asarray(ref), atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(theirs), atol=2e-5)


def test_ring_gradients_match(records):
    q, k, v = _qkv(S=32, B=2)
    g = jax.grad(lambda q, k, v: jnp.sum(xla_attention(q, k, v, causal=True) ** 2),
                 argnums=(0, 1, 2))(q, k, v)
    for i, want in enumerate(g):
        np.testing.assert_allclose(_whole(records, "grads", i), np.asarray(want), atol=5e-5)


def test_ring_falls_back_without_sp(records):
    q, k, v = _qkv(S=32, B=2)
    ref = xla_attention(q, k, v, causal=True)
    for rec in records:
        np.testing.assert_allclose(rec["fallback"].numpy(), np.asarray(ref), atol=1e-5)


def test_ring_refuses_masks_and_windows(records):
    for rec in records:
        assert "no custom mask" in rec["refused"]["mask"]
        assert "sliding windows" in rec["refused"]["window"]


@pytest.mark.slow
def test_ring_32k_sp8_no_dense_fallback(tmp_path):
    """The long-context proof point at the port's world 4: S=32768 over an
    sp-4 ring with the dense path made to raise; a row-subset oracle checks
    sampled query rows."""
    S, B, H, D = 32768, 1, 1, 8
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(B, S, H, D)).astype(np.float32) for _ in range(3))
    np.savez(os.path.join(tmp_path, "long.npz"), q=q, k=k, v=v)
    debug_launcher(pipeline_workers.ring_long_worker, (str(tmp_path), S), num_processes=4)
    recs = [torch.load(os.path.join(tmp_path, f"long_{r}.pt")) for r in range(4)]
    out = _whole(recs, "out")
    scale = D ** -0.5
    for i in np.sort(rng.choice(S, 16, replace=False)):
        logits = (q[0, i, 0] @ k[0, :i + 1, 0].T) * scale
        w = np.exp(logits - logits.max())
        w /= w.sum()
        np.testing.assert_allclose(out[0, i, 0], w @ v[0, :i + 1, 0], rtol=2e-4, atol=2e-5)
