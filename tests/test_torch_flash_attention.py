"""The port's flash attention (its plain versions, on the CPU) against the
JAX reference's Pallas kernels run in interpret mode.

The same numpy inputs go through ``accelerate_tpu.ops.flash_attention``
(interpret mode, 16 x 16 blocks so that several blocks and the block skips
run) and ``accelerate_tpu_torch.ops.flash_attention``: O, lse, and dq/dk/dv
through the port's ``autograd.Function``. On a CUDA tensor the same
wrappers launch the hand-written kernels; chip_smoke.py holds those
against these plain versions on the card. The single-pass backward (B4)
runs with both packages' ``FUSED_BWD`` switched on: the reference's
``_bwd_fused`` against the port's ``flash_bwd_fused`` plain version.

Tolerance: fp32 on both sides; online softmax over blocks against the
plain version's one-pass softmax, and different summation orders: 1e-5
absolute + 1e-5 relative on O and lse; gradients divided by the largest
reference magnitude, then 1e-5 absolute.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from accelerate_tpu.ops import flash_attention as jfa  # noqa: E402
from accelerate_tpu_torch.ops import flash_attention as tfa  # noqa: E402

TOL = 1e-5
BLOCK = 16
NEG_INF = -1e30

CASES = {
    "causal_gqa": dict(),
    "noncausal_gqa": dict(causal=False),
    "causal_mha": dict(Hkv=4),
    "window": dict(window=20),
    "kv_lengths_with_zero": dict(causal=False, lens=[0, 37]),
    "kv_lengths_causal": dict(lens=[48, 5]),
    "q_shorter_than_kv": dict(S=16, Skv=48),
    "q_longer_than_kv": dict(S=48, Skv=32),
    # the edges of the card's 128-row tiles: one full tile and a ragged 16
    # (the reference's block must divide S, so 144 and not 129), and a
    # window whose band crosses row 128
    "s144_ragged_tile": dict(B=1, S=144, H=2, Hkv=1),
    "window_across_128_rows": dict(B=1, S=144, H=2, Hkv=1, window=40),
    # four query heads a kv head under a window, as the card's dq case
    # with 64-row kv tiles has it
    "gqa4_window": dict(B=1, S=80, H=8, Hkv=2, window=36),
}


def _inputs(B=2, S=48, Skv=None, H=4, Hkv=2, D=32, seed=0):
    Skv = S if Skv is None else Skv
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32)
    dout = rng.normal(size=(B, S, H, D)).astype(np.float32)
    return q, k, v, dout


def _jax_reference(q, k, v, dout, causal, lens, window):
    """O, lse (B, H, S) and (dq, dk, dv) from the Pallas kernels (the
    single-pass backward when ``jfa.FUSED_BWD`` is True)."""
    lengths = None if lens is None else jnp.asarray(lens, jnp.int32)
    scale = q.shape[-1] ** -0.5
    qt, kt, vt = (jnp.swapaxes(jnp.asarray(x), 1, 2) for x in (q, k, v))

    def loss(q, k, v):
        out = jfa.flash_attention(q, k, v, causal=causal, kv_lengths=lengths,
                                  window=window, block_q=BLOCK, block_k=BLOCK)
        return jnp.sum(out * dout), out

    with jfa.kernel_interpret_mode():
        _, lse = jfa._fwd(qt, kt, vt, lengths, scale, causal, BLOCK, BLOCK, window)
        grads, out = jax.grad(loss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
        )
    return np.asarray(out), np.asarray(lse[..., 0]), [np.asarray(g) for g in grads]


def _port(q, k, v, dout, causal, lens, window):
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    lengths = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    out = tfa.flash_attention(tq, tk, tv, causal=causal, kv_lengths=lengths, window=window)
    (out * torch.from_numpy(dout)).sum().backward()
    _, lse = tfa.flash_fwd(tq.detach(), tk.detach(), tv.detach(), q.shape[-1] ** -0.5,
                           causal, lengths, window)
    return out.detach().numpy(), lse.numpy(), [t.grad.numpy() for t in (tq, tk, tv)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_flash_matches_pallas_interpret(case):
    kw = dict(CASES[case])
    causal, lens, window = kw.pop("causal", True), kw.pop("lens", None), kw.pop("window", None)
    inputs = _inputs(**kw)
    want_o, want_lse, want_grads = _jax_reference(*inputs, causal, lens, window)
    got_o, got_lse, got_grads = _port(*inputs, causal, lens, window)
    np.testing.assert_allclose(got_o, want_o, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got_lse, want_lse, atol=TOL, rtol=TOL)
    for name, got, want in zip("qkv", got_grads, want_grads):
        scale = np.abs(want).max() + 1e-12
        np.testing.assert_allclose(got / scale, want / scale, atol=TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_single_pass_backward_matches_pallas_interpret(case):
    """B4: both packages' FUSED_BWD switched on; dq, dk, dv."""
    kw = dict(CASES[case])
    causal, lens, window = kw.pop("causal", True), kw.pop("lens", None), kw.pop("window", None)
    inputs = _inputs(**kw)
    old = jfa.FUSED_BWD, tfa.FUSED_BWD
    jfa.FUSED_BWD = tfa.FUSED_BWD = True
    try:
        _, _, want_grads = _jax_reference(*inputs, causal, lens, window)
        before = [w.launches for w in tfa.KERNEL_WRAPPERS]
        _, _, got_grads = _port(*inputs, causal, lens, window)
        assert [w.launches for w in tfa.KERNEL_WRAPPERS] == before  # the CPU takes the plain path
    finally:
        jfa.FUSED_BWD, tfa.FUSED_BWD = old
    for name, got, want in zip("qkv", got_grads, want_grads):
        scale = np.abs(want).max() + 1e-12
        np.testing.assert_allclose(got / scale, want / scale, atol=TOL, err_msg=f"d{name}")


def test_single_pass_plain_version_matches_the_two_pass_one():
    """flash_bwd_fused_reference gives what dq + dk/dv give, with the same
    rounding points, in bf16 too."""
    q, k, v, dout = (torch.from_numpy(x) for x in _inputs(S=40, Skv=48))
    lens = torch.tensor([48, 21], dtype=torch.int32)
    for dtype in (torch.float32, torch.bfloat16):
        q_, k_, v_, do_ = (x.to(dtype) for x in (q, k, v, dout))
        args = (32 ** -0.5, True, lens, 30)
        out, lse = tfa.flash_fwd(q_, k_, v_, *args)
        delta = tfa.attention_delta(out, do_)
        dq, dk, dv = tfa.flash_bwd_fused(q_, k_, v_, do_, lse, delta, *args)
        assert torch.equal(dq, tfa.flash_bwd_dq(q_, k_, v_, do_, lse, delta, *args))
        want_dk, want_dv = tfa.flash_bwd_dkv(q_, k_, v_, do_, lse, delta, *args)
        assert torch.equal(dk, want_dk) and torch.equal(dv, want_dv)
        assert dq.dtype == dk.dtype == dv.dtype == dtype


def test_fully_masked_rows_zero_output_and_grads():
    """q longer than kv, causal: the first S - Skv rows see no key. They
    return 0 with lse = NEG_INF and get zero dq; the plain softmax path
    would give the mean of v there instead."""
    q, k, v, dout = _inputs(S=48, Skv=32)
    out, lse, (dq, _, _) = _port(q, k, v, dout, True, None, None)
    masked = 48 - 32
    assert np.all(out[:, :masked] == 0.0)
    assert np.all(lse[:, :, :masked] == np.float32(NEG_INF))
    assert np.all(dq[:, :masked] == 0.0)
    assert np.all(np.isfinite(dq)) and np.abs(dq[:, masked:]).max() > 0


def test_wrappers_count_no_launch_on_cpu():
    """On CPU tensors the wrappers take the plain versions: no launch, in
    the total or in any design's count, for the forward, dq, dk/dv and the
    single pass alike."""
    assert [w.__name__ for w in tfa.KERNEL_WRAPPERS] == [
        "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_fused"]
    assert all(set(w.by_design) == {"wgmma", "wmma"} for w in tfa.KERNEL_WRAPPERS)
    before = [(w.launches, dict(w.by_design)) for w in tfa.KERNEL_WRAPPERS]
    _port(*_inputs(B=1, S=16), True, None, None)
    q, k, v, dout = (torch.from_numpy(x) for x in _inputs(B=1, S=16))
    lse = torch.zeros(1, 4, 16)
    tfa.flash_bwd_fused(q, k, v, dout, lse, lse, 0.25)
    assert [(w.launches, dict(w.by_design)) for w in tfa.KERNEL_WRAPPERS] == before


@pytest.mark.parametrize("dtype,head_dim,design", [
    (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 64, "wgmma"),
    (torch.float16, 128, "wgmma"),
    (torch.float16, 64, "wgmma"),
    (torch.float32, 128, "wmma"),
    (torch.float32, 64, "wmma"),
    (torch.bfloat16, 16, "wmma"),
    (torch.bfloat16, 32, "wmma"),
    (torch.bfloat16, 48, "wmma"),
    (torch.float16, 80, "wmma"),
    (torch.bfloat16, 96, "wmma"),
    (torch.float16, 112, "wmma"),
])
def test_kernel_design_is_a_function_of_dtype_and_head_dim(dtype, head_dim, design):
    """All four flash kernels (forward, dq, dk/dv and the single pass) take
    the wgmma design for 16-bit types at head_dim 64 or 128 and the wmma
    design otherwise, by one rule decided before any launch: the design
    depends on nothing but the dtype and head_dim (chip_smoke.py holds the C
    launcher's per-kernel rule, ``flash_design``, to this, and reads each
    wrapper's ``by_design`` counts against it)."""
    assert tfa.kernel_design(dtype, head_dim) == design
    for wrapper in tfa.KERNEL_WRAPPERS:
        assert design in wrapper.by_design


def test_rejects_bad_arguments():
    q = torch.zeros(1, 16, 2, 16)
    with pytest.raises(ValueError, match="causal"):
        tfa.flash_attention(q, q, q, causal=False, window=4)
    with pytest.raises(ValueError, match="positive"):
        tfa.flash_attention(q, q, q, window=0)
    with pytest.raises(ValueError, match="kv_lengths"):
        tfa.flash_attention(q, q, q, kv_lengths=torch.tensor([1, 2]))


def _nan_inputs(causal):
    """Three batch entries: in the first, one query row (the last, which
    sees every key) is all NaN; in the second, one element of key 0 is NaN,
    so every row of its kv head's query heads has one NaN score beside
    finite ones; the third sees no key (``kv_lengths`` 0). Each NaN reaches
    the same elements of every output however the keys are tiled."""
    q, k, v, dout = _inputs(B=3, S=48, H=4, Hkv=2)
    q[0, -1, 0] = np.nan
    k[1, 0, 0, 3] = np.nan
    return (q, k, v, dout), causal, [48, 48, 0], None


@pytest.mark.parametrize("fused_bwd", [False, True], ids=["two_pass", "single_pass"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
def test_nan_rows_match_pallas_interpret(causal, fused_bwd):
    """A row whose every score is NaN gives NaN, as the reference's
    ``jnp.maximum`` row max does (not the zeros of a fully masked row); a
    row with some NaN scores gives NaN; a fully masked row gives O = 0, lse
    = NEG_INF and zero gradients. The NaN masks of O, lse, dq, dk and dv
    equal the reference's exactly, and the finite elements agree within
    TOL."""
    inputs, causal, lens, window = _nan_inputs(causal)
    old = jfa.FUSED_BWD, tfa.FUSED_BWD
    jfa.FUSED_BWD = tfa.FUSED_BWD = fused_bwd
    try:
        want_o, want_lse, want_grads = _jax_reference(*inputs, causal, lens, window)
        got_o, got_lse, got_grads = _port(*inputs, causal, lens, window)
    finally:
        jfa.FUSED_BWD, tfa.FUSED_BWD = old
    assert np.isnan(want_o[0, -1, 0]).all() and np.isfinite(want_o[0, :-1]).all()
    assert np.isnan(want_o[1, :, :2]).all() and np.isfinite(want_o[1, :, 2:]).all()
    assert (want_o[2] == 0).all() and (want_lse[2] == np.float32(NEG_INF)).all()
    pairs = [("o", got_o, want_o), ("lse", got_lse, want_lse)]
    pairs += [(f"d{n}", g, w) for n, g, w in zip("qkv", got_grads, want_grads)]
    for name, got, want in pairs:
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=name)
        finite = ~np.isnan(want)
        scale = np.abs(want[finite]).max() + 1e-12 if name.startswith("d") else 1.0
        np.testing.assert_allclose(got[finite] / scale, want[finite] / scale, atol=TOL,
                                   rtol=TOL, err_msg=name)
    assert (got_grads[0][2] == 0).all() and (got_grads[1][2] == 0).all()
