"""Rules the PyTorch port keeps, checked without JAX.

* Every module of ``accelerate_tpu_torch`` (its examples included),
  ``chip_smoke.py`` and the tools (``tools/port_copies.py``,
  ``flash_mutants.py``, ``flash_variants.py``, ``path_bisect.py``) import
  in a process where ``jax``, ``accelerate_tpu`` and ``safetensors``
  cannot be imported, and no import statement in them names one (the
  card's machine has neither JAX nor ``safetensors``).
* Entry points default to CUDA and raise without it; they never fall
  back to the CPU unless asked (``cpu=True``).
* What is not ported yet raises NotImplementedError instead of taking
  another path silently.
* Dispatch to the flash kernels follows the reference's shape predicate,
  with a CUDA device in place of the TPU backend.
* Every kernel wrapper takes its plain version on CPU tensors without
  counting a launch, and refuses what its kernel does not take.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

import accelerate_tpu_torch as port
from accelerate_tpu_torch.ops import attention
from accelerate_tpu_torch.ops import flash_attention as fa
from accelerate_tpu_torch.ops import fused

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def reset_port_singletons():
    yield
    port.AcceleratorState._reset_state(reset_partial_state=True)
    port.GradientState._reset_state()


def _run_blocked(code: str) -> subprocess.CompletedProcess:
    """Run ``code`` in a fresh interpreter where importing jax, flax, optax,
    accelerate_tpu, safetensors or ml_dtypes fails."""
    prelude = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "flax", "optax", "accelerate_tpu", "safetensors",
                     "ml_dtypes"):
            sys.modules[name] = None
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-c", prelude + code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_every_module_and_chip_smoke_import_without_jax():
    code = textwrap.dedent("""
        import importlib, pkgutil
        import accelerate_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            accelerate_tpu_torch.__path__, "accelerate_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        sys.path.insert(0, "tools")  # where the tools import their shared helper from
        for script in ("chip_smoke.py", "tools/port_copies.py", "tools/flash_mutants.py",
                       "tools/flash_variants.py", "tools/path_bisect.py"):
            spec = importlib.util.spec_from_file_location("script", script)
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        leaked = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "flax", "optax", "safetensors")
                  and sys.modules[m] is not None]
        assert not leaked, leaked
        print(len(names), "modules")
    """)
    result = _run_blocked(code)
    assert result.returncode == 0, result.stderr
    assert int(result.stdout.split()[0]) >= 25  # checkpointing and the examples among them


FORBIDDEN_IMPORTS = ("jax", "jaxlib", "flax", "optax", "accelerate_tpu", "safetensors")


def test_no_import_statement_names_jax_the_reference_or_safetensors():
    """Also imports inside functions, which importing a module does not run."""
    import ast

    files = sorted((REPO / "accelerate_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", *sorted((REPO / "tools").glob("*.py"))]
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(REPO)}:{node.lineno} {n}" for n in names
                    if n.split(".")[0] in FORBIDDEN_IMPORTS]
    assert len(files) > 25 and not bad, bad


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    result = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                            text=True, timeout=300)
    assert result.returncode != 0
    assert '"ok"' not in result.stdout


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.Accelerator()
    acc = port.Accelerator(cpu=True)
    assert acc.device == torch.device("cpu")
    cfg = port.TransformerConfig.tiny(num_layers=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.CausalLM(cfg)
    model = port.CausalLM(cfg, device="cpu")
    assert {p.device for p in model.parameters()} == {torch.device("cpu")}


@pytest.mark.parametrize("field,value", [
    ("arch", "gpt2"),
    ("attention_impl", "ring"),
    # the Gemma / Gemma-2 switches
    ("norm_offset", True),
    ("embed_scale", True),
    ("mlp_activation", "gelu_tanh"),
    ("post_norms", True),
    ("attn_softcap", 50.0),
    ("final_softcap", 30.0),
    ("query_pre_attn_scalar", 24.0),
    ("layer_windows", (8, None)),
])
def test_unported_model_features_raise(field, value):
    cfg = port.TransformerConfig.tiny(**{field: value})
    queue = "A7" if field == "attention_impl" else "A8"
    with pytest.raises(NotImplementedError, match=f"queue {queue}.*ROADMAP"):
        port.CausalLM(cfg, device="cpu")


@pytest.mark.parametrize("field,value", [
    ("fp8", True),
    ("num_experts", 4),
    ("remat", "full"),
    ("remat", "dots"),
    ("remat", "dots_ragged"),
    ("remat", "dots_with_no_batch_dims"),
    ("remat", "save_attn"),
    ("remat", "save_mlp"),
])
def test_ported_model_features_build_and_train(field, value):
    """fp8 projections, MoE and every remat policy were refused before the
    single-card variants slice; they build and give finite gradients."""
    model = port.CausalLM(port.TransformerConfig.tiny(num_layers=1, **{field: value}),
                          device="cpu")
    params = dict(model.named_parameters())
    ids = torch.randint(0, 1024, (2, 16), generator=torch.Generator().manual_seed(0))
    loss = port.CausalLM.loss_fn(model)(params, {"input_ids": ids})
    grads = torch.autograd.grad(loss, list(params.values()))
    assert all(torch.isfinite(g).all() for g in grads)


def test_expert_parallel_raises_naming_a7():
    from accelerate_tpu_torch.ops import moe

    with pytest.raises(NotImplementedError, match="queue A7"):
        moe.moe_ragged_ep()


def test_moe_and_fp8_modules_follow_the_model_device():
    """The MoE block's router and stacks and every Fp8Dense sit where the
    model was built (the meta device here, which no default would give), and
    the new modules take no device of their own."""
    from accelerate_tpu_torch.models.transformer import Fp8Dense

    cfg = port.TransformerConfig.tiny(num_layers=1, num_experts=4, fp8=True)
    meta = port.CausalLM(cfg, device="meta", generator=torch.Generator())
    assert {p.device.type for p in meta.parameters()} == {"meta"}
    assert type(meta.layers[0].attn.q_proj) is Fp8Dense
    assert meta.layers[0].moe.gate_proj.shape == (4, cfg.hidden_size, cfg.intermediate_size)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.CausalLM(cfg)


def test_moe_fp8_and_remat_modules_import_without_jax():
    code = textwrap.dedent("""
        import importlib
        for name in ("accelerate_tpu_torch.ops.moe", "accelerate_tpu_torch.ops.fp8",
                     "accelerate_tpu_torch.models.transformer"):
            importlib.import_module(name)
        print("ok")
    """)
    result = _run_blocked(code)
    assert result.returncode == 0 and result.stdout.strip() == "ok", result.stderr


def test_decode_path_raises():
    """The decode paths are ported: what raises now is a decode call without
    its cache, a cache without decode, and the int8 paged KV (queue A9)."""
    from accelerate_tpu_torch.models.generation import init_cache

    model = port.CausalLM(port.TransformerConfig.tiny(num_layers=1), device="cpu")
    ids = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="needs a cache"):
        model(ids, decode=True)
    with pytest.raises(ValueError, match="decode=True"):
        model(ids, cache=init_cache(model, 1))
    with pytest.raises(NotImplementedError, match="ROADMAP.md, queue A9"):
        attention.PagedKVState(torch.zeros(1, 2), torch.zeros(1), torch.ones(1), num_blocks=4,
                               block_size=2, kv_dtype="int8")
    assert model(ids, decode=True, cache=init_cache(model, 1)).shape == (1, 4, 1024)


def test_serving_modules_import_without_jax():
    code = textwrap.dedent("""
        import importlib
        for name in ("accelerate_tpu_torch.models.generation", "accelerate_tpu_torch.serving",
                     "accelerate_tpu_torch.serving.engine", "accelerate_tpu_torch.serving.sampling",
                     "accelerate_tpu_torch.serving.block_pool",
                     "accelerate_tpu_torch.serving.scheduler", "accelerate_tpu_torch.serving.spans",
                     "accelerate_tpu_torch.serving.telemetry",
                     "accelerate_tpu_torch.serving.slo", "accelerate_tpu_torch.serving.speculation",
                     "accelerate_tpu_torch.telemetry", "accelerate_tpu_torch.telemetry.sinks",
                     "accelerate_tpu_torch.telemetry.collector",
                     "accelerate_tpu_torch.utils.cuda_graph"):
            importlib.import_module(name)
        print("ok")
    """)
    result = _run_blocked(code)
    assert result.returncode == 0 and result.stdout.strip() == "ok", result.stderr


def test_serving_and_generation_follow_the_model_device():
    """No serving entry point takes a device of its own or defaults to the
    CPU: the caches, the decode step's buffers, the sampler and the outputs
    sit where the model's parameters are (here a model built on the meta
    device, which no default would give)."""
    from accelerate_tpu_torch.models import generation
    from accelerate_tpu_torch.serving import ServingEngine

    cfg = port.TransformerConfig.tiny(num_layers=1, max_seq_len=32)
    meta = port.CausalLM(cfg, device="meta", generator=torch.Generator())
    assert generation.init_cache(meta, 2).key.device.type == "meta"
    assert generation.init_cache(meta, num_blocks=5, block_size=8).value.device.type == "meta"
    with pytest.raises(RuntimeError, match="META"):  # the engine's generator is the model's
        ServingEngine(meta)
    model = port.CausalLM(cfg, device="cpu")
    engine = ServingEngine(model, max_slots=2, block_size=8)
    tensors = [engine.cache.key, engine.cache.value, *engine._decode_in.values(),
               engine.sampling.temperatures()]
    assert {t.device for t in tensors} == {torch.device("cpu")}
    assert engine._generator.device == torch.device("cpu")
    ids = torch.randint(0, cfg.vocab_size, (2, 5), generator=torch.Generator().manual_seed(0))
    assert engine.generate(ids, max_new_tokens=3).device == torch.device("cpu")
    assert generation.generate(model, ids, max_new_tokens=3).device == torch.device("cpu")
    fn = generation.make_generate_fn(model, max_new_tokens=3)
    assert fn(ids).device == torch.device("cpu")


def test_unported_accelerator_and_model_paths_raise():
    assert port.Accelerator(mixed_precision="fp8", cpu=True).state.mixed_precision_policy.fp8
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port.Accelerator(cpu=True, parallelism_plugin=object())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port.SequenceClassifier(port.TransformerConfig.tiny(causal=False, fused_kernels=True),
                                device="cpu")


def test_sequence_classifier_builds_and_runs_on_the_cpu():
    """The classifier is ported: bert_base's layout at a tiny width builds
    on the CPU, and a padded batch gives finite fp32 logits and loss."""
    cfg = port.TransformerConfig.bert_base(vocab_size=64, hidden_size=32,
                                           intermediate_size=64, num_layers=1, num_heads=2)
    assert cfg.causal is False and cfg.head_dim == 16
    model = port.SequenceClassifier(cfg, num_labels=3, device="cpu")
    ids = torch.randint(0, 64, (2, 8), generator=torch.Generator().manual_seed(0))
    mask = torch.tensor([[1] * 8, [1] * 5 + [0] * 3])
    logits = model(ids, mask)
    assert logits.shape == (2, 3) and logits.dtype == torch.float32
    loss = port.SequenceClassifier.loss_fn(model)(
        dict(model.named_parameters()),
        {"input_ids": ids, "attention_mask": mask, "labels": torch.tensor([0, 2])})
    assert torch.isfinite(logits).all() and torch.isfinite(loss)


def test_prepare_wraps_a_schedule_frozen_while_accumulating():
    acc = port.Accelerator(gradient_accumulation_steps=2, cpu=True)
    sched = acc.prepare(lambda step: 0.1 * (step + 1))
    assert isinstance(sched, port.AcceleratedScheduler)
    acc.gradient_state.sync_gradients = False  # an accumulating call
    sched.step()
    assert sched.get_lr() == [0.1]
    acc.gradient_state.sync_gradients = True
    sched.step()
    assert sched.get_lr() == [pytest.approx(0.2)]
    assert sched.get_last_lr() == [pytest.approx(0.1)]


def test_flash_eligibility_is_the_reference_shape_predicate():
    cuda = torch.device("cuda")
    assert attention.flash_self_attention_eligible(2048, cuda)
    assert attention.flash_self_attention_eligible(256, cuda)
    assert not attention.flash_self_attention_eligible(128, cuda)  # S < 256
    assert not attention.flash_self_attention_eligible(320, cuda)  # S % 128 != 0
    assert not attention.flash_self_attention_eligible(2048, torch.device("cpu"))


def test_auto_dispatch_on_cpu_takes_the_plain_path():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 256, 4, 16, generator=g)
    k = torch.randn(1, 256, 2, 16, generator=g)
    before = [w.launches for w in fa.KERNEL_WRAPPERS]
    out = attention.dot_product_attention(q, k, k, causal=True)
    torch.testing.assert_close(out, attention.xla_attention(q, k, k, causal=True))
    assert [w.launches for w in fa.KERNEL_WRAPPERS] == before
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        attention.dot_product_attention(q, k, k, implementation="ring")


def test_build_target_changes_when_a_header_changes(tmp_path, monkeypatch):
    """The library's name hashes the .cu and every csrc/*.cuh, so an edited
    header is rebuilt and never loads a stale library."""
    import shutil

    from accelerate_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build._target("flash_attention")
    assert before == _build._target("flash_attention")  # stable
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// an edit\n")
    after = _build._target("flash_attention")
    assert after != before and after.parent == before.parent
    (csrc / "extra.cuh").write_text("// a new header\n")
    assert _build._target("flash_attention") != after


def test_kernel_wrappers_refuse_what_the_kernel_does_not_take():
    """The argument checks run before any launch, so they are testable
    without a card: a CPU tensor in the kernel check is refused."""
    q = torch.zeros(1, 16, 2, 24)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        fa._check_inputs(q, q, q, None, None, True)


def _tiny_prologue_args(rows=16, hidden=64, heads=4, kv_heads=2, d=16):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, rows, hidden, generator=g)
    ws = [torch.randn(n * d, hidden, generator=g) * 0.1 for n in (heads, kv_heads, kv_heads)]
    cos, sin = fused._rope_tables(torch.arange(rows)[None], fused.rope_inv_freqs(d, 1e4, None))
    statics = dict(eps=1e-6, norm_offset=False, num_heads=heads, num_kv_heads=kv_heads,
                   head_dim=d, dtype=torch.float32)
    return (x, torch.ones(hidden), *ws, None, None, None, cos, sin), statics


def test_fused_wrappers_count_no_launch_on_cpu():
    args, statics = _tiny_prologue_args()
    before = [w.launches for w in (*fused.KERNEL_WRAPPERS, *fa.KERNEL_WRAPPERS)]
    q, k, v = fused.qkv_prologue(*args, **statics)
    assert q.shape == (1, 16, 4, 16) and k.shape == v.shape == (1, 16, 2, 16)
    leaves = [torch.ones(3, 5), torch.ones(()), torch.ones(7)]
    row = fused.epilogue_scalars(0.9, 0.999, 1, -1e-3, True, "cpu")
    fused.adamw_epilogue(leaves, [t.clone() for t in leaves], [t * 0 for t in leaves],
                         [t * 0 for t in leaves], row, b1=0.9, b2=0.999, eps=1e-8,
                         eps_root=0.0, weight_decay=1e-4)
    qa = torch.randn(1, 16, 2, 16)
    out, lse = fa.flash_fwd(qa, qa, qa, 0.25)
    fa.flash_bwd_fused(qa, qa, qa, qa, lse, fa.attention_delta(out, qa), 0.25)
    assert [w.launches for w in (*fused.KERNEL_WRAPPERS, *fa.KERNEL_WRAPPERS)] == before


def test_fused_kernel_checks_refuse_what_the_kernels_do_not_take():
    args, statics = _tiny_prologue_args()
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        fused._check_prologue(args[0], args[1], args[2:5], args[5:8], *args[8:],
                              4, 2, 16, torch.float32)
    leaves = [(torch.ones(3),) * 4]
    with pytest.raises(ValueError, match="row"):
        fused._check_epilogue(leaves, torch.zeros(1, 8))
    # the CUDA shape gate: the kernel's column tile is whole heads, a
    # multiple of 64 and at most 512; hidden a multiple of 64; even head_dim
    cuda = torch.device("cuda")
    assert fused.prologue_supported(32, 8, 128, 2, 2048, 4096, device=cuda)
    assert fused.prologue_supported(14, 2, 128, 1, 64, 4096, device=cuda)  # a 256 tile
    assert not fused.prologue_supported(4, 2, 40, 1, 64, 256, device=cuda)  # 80-column tile
    assert not fused.prologue_supported(4, 2, 15, 1, 64, 256, device=cuda)  # odd head_dim
    assert not fused.prologue_supported(4, 2, 64, 1, 64, 96, device=cuda)  # hidden 96
    assert not fused.prologue_supported(4, 2, 64, 1, 64, 256, device=cuda,
                                        dtype=torch.float64)
    assert fused.prologue_supported(4, 2, 40, 1, 64, 256, device="cpu")  # no kernel limits


@pytest.mark.parametrize("dtype,heads,kv_heads,head_dim,hidden,design", [
    (torch.bfloat16, 32, 8, 128, 4096, "wgmma"),  # llama3_8b
    (torch.float16, 32, 8, 128, 4096, "wgmma"),
    (torch.bfloat16, 8, 2, 64, 512, "wgmma"),
    (torch.bfloat16, 8, 1, 128, 320, "wgmma"),  # E not a multiple of the ring's 4 x 64
    (torch.bfloat16, 14, 2, 128, 1024, "wgmma"),
    (torch.float32, 32, 8, 128, 4096, "wmma"),  # the scalar fp32 path
    (torch.bfloat16, 8, 2, 96, 512, "wmma"),
    (torch.float16, 8, 2, 32, 512, "wmma"),
    (torch.bfloat16, 4, 2, 64, 96, "wmma"),  # hidden not a multiple of 64
])
def test_prologue_kernel_design_rule(dtype, heads, kv_heads, head_dim, hidden, design):
    """The prologue takes the wgmma design for 16-bit types at head_dim 64 or
    128 with hidden a multiple of 64, and the wmma design otherwise, decided
    before any launch from these inputs alone (chip_smoke.py holds the C
    launcher's ``prologue_design`` to this, and reads the wrapper's
    ``by_design`` counts against it)."""
    assert fused.prologue_kernel_design(dtype, heads, kv_heads, head_dim, hidden) == design
    assert design in fused.qkv_prologue.by_design


@pytest.mark.parametrize("heads,kv_heads,head_dim,tile", [
    (32, 8, 128, 256), (8, 1, 128, 128), (14, 2, 128, 256), (8, 2, 64, 128),
    (4, 1, 64, 64), (6, 3, 64, 192), (32, 8, 64, 256), (12, 6, 64, 192),
])
def test_prologue_wgmma_tile_is_whole_heads_dividing_both_spans(heads, kv_heads, head_dim,
                                                               tile):
    """The wgmma design's column tile: the widest whole number of heads <= 256
    that divides the q span and the k/v span, a multiple of 64 at head_dim 64
    and 128 (one wgmma width or three)."""
    got = fused._col_block(heads, kv_heads, head_dim, limit=256)
    assert got == tile
    assert got % head_dim == 0 and got % 64 == 0
    assert (heads * head_dim) % got == 0 and (kv_heads * head_dim) % got == 0
