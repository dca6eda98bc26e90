"""The model zoo under sharding, on the port at world 4 over gloo, against
the port's world 1 and the reference's rules.

One world-4 launch of ``zoo_workers.zoo_worker`` runs both mirrors:

* ``tests/test_models.py::test_gpt2_sharded_training_decreases_loss``:
  the tiny ``GPT2LM`` (the reference test's widths) at fsdp 2 x tp 2
  (``min_weight_size=1024``; the reference's test runs dp 2 x fsdp 2 x
  tp 2 on 8 virtual devices, and the port's earlier slices hold dp at world
  4), ten AdamW steps on one batch, as there: the loss falls, and losses and params are world 1's
  within ``TOL``;
* ``tests/test_seq2seq.py::test_sharded_training_compiles``: the tiny
  ``Seq2SeqLM`` at dp 1 x fsdp 2 x tp 2 (``min_weight_size=16``), two
  steps with a right-padded source mask: finite, world 1's within ``TOL``,
  and a kernel split over tp.

Each model's placements are also held leaf by leaf against the reference's
``infer_param_shardings`` on a JAX mesh of 4 devices, with no process
group.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import flax.linen as nn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from accelerate_tpu.models import GPT2LM as JaxGPT2  # noqa: E402
from accelerate_tpu.models import Seq2SeqLM as JaxSeq2Seq  # noqa: E402
from accelerate_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from accelerate_tpu.parallel import sharding as jax_sharding  # noqa: E402
from accelerate_tpu.parallel.mesh import build_mesh as jax_build_mesh  # noqa: E402
from accelerate_tpu.utils.dataclasses import ParallelismPlugin as JaxPlugin  # noqa: E402

import accelerate_tpu_torch as port  # noqa: E402
from accelerate_tpu_torch.launchers import debug_launcher  # noqa: E402
from accelerate_tpu_torch.models import GPT2LM, Seq2SeqLM  # noqa: E402
from accelerate_tpu_torch.parallel import sharding  # noqa: E402
from accelerate_tpu_torch.test_utils.scripts import zoo_workers  # noqa: E402

TOL = 2e-5  # losses (relative) and params (absolute), fp32, against world 1
GPT2 = dict(arch="gpt2", vocab_size=512, hidden_size=64, intermediate_size=256, num_layers=2,
            num_heads=4, max_seq_len=64, rms_norm_eps=1e-5, tie_embeddings=True)
S2S = dict(vocab_size=64, hidden_size=64, intermediate_size=128, num_layers=2,
           num_decoder_layers=2, num_heads=4, max_seq_len=32, tie_embeddings=True)
GPT2_PLUGIN = dict(dp_size=1, fsdp_size=2, tp_size=2, min_weight_size=1024)
S2S_PLUGIN = dict(dp_size=1, fsdp_size=2, tp_size=2, min_weight_size=16)
CASES = [dict(name="gpt2", model="gpt2", config=GPT2, init="gpt2_init.pt", rows=8, lr=1e-3,
              plugin=GPT2_PLUGIN),
         dict(name="seq2seq", model="seq2seq", config=S2S, init="seq2seq_init.pt", rows=8,
              lr=1e-3, plugin=S2S_PLUGIN)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for the module: beside the suite's other workers,
    torch's threads oversubscribe the cores (the copy task read 75.7 s at
    8 threads beside five busy workers, 13.2 s alone at 1)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(out):
    rng = np.random.default_rng(0)
    src = rng.integers(1, 64, (16, 8)).astype(np.int64)
    mask = np.ones((16, 8), np.int64)
    mask[1::2, 5:] = 0  # every other row right-padded
    np.savez(out / "inputs.npz",
             gpt2_input_ids=np.tile(rng.integers(0, 512, (8, 32)), (10, 1)).astype(np.int64),
             seq2seq_input_ids=src, seq2seq_labels=src, seq2seq_attention_mask=mask,
             seq2seq_decoder_input_ids=np.concatenate(
                 [np.zeros((16, 1), np.int64), src[:, :-1]], axis=1))
    torch.save(GPT2LM(port.TransformerConfig(**GPT2), device="cpu",
                      generator=torch.Generator().manual_seed(1)).state_dict(),
               out / "gpt2_init.pt")
    torch.save(Seq2SeqLM(port.TransformerConfig(**S2S), device="cpu",
                         generator=torch.Generator().manual_seed(2)).state_dict(),
               out / "seq2seq_init.pt")


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("zoo")
    _inputs(out)
    debug_launcher(zoo_workers.zoo_worker, (str(out), CASES), num_processes=4)
    sharded = {c["name"]: torch.load(out / f"{c['name']}.pt") for c in CASES}
    port.AcceleratorState._reset_state(reset_partial_state=True)
    port.GradientState._reset_state()
    for case in CASES:
        zoo_workers.zoo_case(str(out), {**case, "name": case["name"] + "_w1", "plugin": None})
    single = {c["name"]: torch.load(out / f"{c['name']}_w1.pt") for c in CASES}
    port.AcceleratorState._reset_state(reset_partial_state=True)
    return sharded, single


def _agrees(sharded, single):
    np.testing.assert_allclose(sharded["losses"], single["losses"], rtol=TOL)
    assert set(sharded["params"]) == set(single["params"])
    for name, t in single["params"].items():
        np.testing.assert_allclose(sharded["params"][name].numpy(), t.numpy(), atol=TOL,
                                   err_msg=name)


def test_gpt2_sharded_training_decreases_loss(records):
    sharded, single = records[0]["gpt2"], records[1]["gpt2"]
    losses = sharded["losses"]
    assert len(losses) == 10 and all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    _agrees(sharded, single)
    assert sharded["specs"]["layers.0.attn.c_attn.weight"] == ("tp", "fsdp")


def test_seq2seq_sharded_training(records):
    sharded, single = records[0]["seq2seq"], records[1]["seq2seq"]
    assert len(sharded["losses"]) == 2 and all(np.isfinite(sharded["losses"]))
    _agrees(sharded, single)
    assert any(spec is not None and "tp" in spec for spec in sharded["specs"].values())


def _placements(jax_model, variables, model, kwargs):
    """(the port's specs, the reference's in the port's layout) a param."""
    mesh = jax_build_mesh(JaxPlugin(**kwargs), devices=jax.devices()[:4])
    raw = jax_sharding.unbox_params(variables)["params"]
    logical = jax_sharding.get_logical_specs(variables)["params"]
    ref = jax_sharding.infer_param_shardings(raw, mesh, JaxPlugin(**kwargs),
                                             logical_specs=logical)
    shapes = {k: tuple(v.shape) for k, v in model.named_parameters()}
    ours = sharding.infer_param_shardings(shapes, dict(mesh.shape),
                                          port.ParallelismPlugin(**kwargs),
                                          sharding.get_logical_specs(model))
    axes = model.logical_axes()
    norm = lambda e: (e[0] if len(e) == 1 else tuple(e)) if isinstance(e, (list, tuple)) else e  # noqa
    for name in shapes:
        # the reference's path: a stack's layer index dropped, the leaf renamed
        parts = name.split(".")
        mods = [p for i, p in enumerate(parts[:-1]) if not (p.isdigit() and parts[i - 1] == "layers")]
        leaf = parts[-1]
        if leaf == "weight":
            last = mods[-1]
            leaf = ("scale" if last.endswith("norm") or last.startswith("ln_") else
                    "embedding" if last in ("embed", "wte", "wpe") else "kernel")
        node = ref
        for p in mods + [leaf]:
            node = node[p]
        want = axes[name].to_port(tuple(norm(e) for e in node.spec), name)
        assert tuple(norm(e) for e in ours[name]) == tuple(norm(e) for e in want), name


@pytest.mark.parametrize("kwargs", [GPT2_PLUGIN, dict(dp_size=2, tp_size=2),
                                    dict(dp_size=1, fsdp_size=4, min_weight_size=8)],
                         ids=["fsdp2_tp2", "dp2_tp2", "fsdp4_min8"])
def test_gpt2_placements_match_the_reference(kwargs):
    variables = JaxGPT2(JaxConfig(**GPT2)).init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 8), jnp.int32))
    _placements(JaxGPT2, variables, GPT2LM(port.TransformerConfig(**GPT2), device="meta"),
                kwargs)


@pytest.mark.parametrize("kwargs", [S2S_PLUGIN, dict(dp_size=2, tp_size=2)],
                         ids=["fsdp2_tp2", "dp2_tp2"])
def test_seq2seq_placements_match_the_reference(kwargs):
    zeros = jnp.zeros((1, 8), jnp.int32)
    variables = JaxSeq2Seq(JaxConfig(**S2S)).init(jax.random.PRNGKey(0), zeros, zeros)
    _placements(JaxSeq2Seq, variables, Seq2SeqLM(port.TransformerConfig(**S2S), device="meta"),
                kwargs)
