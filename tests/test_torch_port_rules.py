"""Rules the PyTorch port keeps, checked without JAX.

* Every module of ``accelerate_tpu_torch`` (its examples, ``fault_tolerance``
  and ``checkpoint_async.writer`` included), ``chip_smoke.py`` and the tools
  (``tools/port_copies.py``, ``flash_mutants.py``, ``flash_variants.py``,
  ``path_bisect.py``, ``fp8_mutants.py``, ``ckpt_mutants.py``) import
  in a process where ``jax``, ``accelerate_tpu``, ``safetensors`` and
  ``transformers`` cannot be imported, and no import statement in them
  names one (the card's machine has none of them).
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
    accelerate_tpu, safetensors, ml_dtypes or transformers fails."""
    prelude = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "flax", "optax", "accelerate_tpu", "safetensors",
                     "ml_dtypes", "transformers"):
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
        # the async checkpoint slice's modules are among them, and the
        # pipeline and ring attention (queue A7 parts 3 and 4)
        for name in ("accelerate_tpu_torch.fault_tolerance",
                     "accelerate_tpu_torch.checkpoint_async.writer",
                     "accelerate_tpu_torch.parallel.pipeline",
                     "accelerate_tpu_torch.ops.ring_attention"):
            assert name in names, name
        sys.path.insert(0, "tools")  # where the tools import their shared helper from
        for script in ("chip_smoke.py", "tools/port_copies.py", "tools/flash_mutants.py",
                       "tools/flash_variants.py", "tools/path_bisect.py",
                       "tools/fp8_mutants.py", "tools/ckpt_mutants.py"):
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
    assert int(result.stdout.split()[0]) >= 35  # checkpointing and the examples among them


FORBIDDEN_IMPORTS = ("jax", "jaxlib", "flax", "optax", "accelerate_tpu", "safetensors",
                     "transformers")


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
    if field == "attention_impl":
        # ring attention is ported (queue A7 part 4): the model builds and,
        # with no sp above 1, attends over the whole sequence; what the
        # reference refuses with it, a sliding window, raises as there
        model = port.CausalLM(cfg, device="cpu")
        assert model(torch.zeros(1, 8, dtype=torch.long)).shape == (1, 8, cfg.vocab_size)
        with pytest.raises(ValueError, match="ring attention"):
            port.TransformerConfig.tiny(attention_impl="ring", sliding_window=4)
        return
    with pytest.raises(NotImplementedError, match="queue A8.*ROADMAP"):
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
    """Expert parallelism is ported (queue A7 part 4: ``moe_ragged_ep``);
    what part 4 leaves raises naming it: MoE experts, decoding and LoRA
    under tensor parallelism (no process group needed to refuse)."""
    from accelerate_tpu_torch.adapters import LoraConfig, build_lora_state, init_adapter
    from accelerate_tpu_torch.ops import moe
    from accelerate_tpu_torch.parallel import runtime

    assert moe.ragged_ep_supported() and callable(moe.moe_ragged_ep)
    cfg = port.TransformerConfig.tiny(num_layers=1, num_experts=4)
    model = port.CausalLM(cfg, device="cpu")
    ids = torch.zeros(1, 8, dtype=torch.long)
    tp = runtime.TensorParallel(None, 2, 0)
    with runtime.sharded_forward(tp=tp):
        with pytest.raises(NotImplementedError, match="queue A7 part 4"):
            model.layers[0].moe(torch.zeros(1, 8, cfg.hidden_size))
        with pytest.raises(NotImplementedError, match="queue A7 part 4"):
            model(ids, decode=True)
    dense = port.CausalLM(port.TransformerConfig.tiny(num_layers=1), device="cpu")
    lcfg = LoraConfig(rank=2, target_modules=("q_proj",))
    lora = build_lora_state(init_adapter(torch.Generator().manual_seed(0), dense.config, lcfg),
                            lcfg, 1)
    x = torch.zeros(1, 8, dense.config.hidden_size)
    positions = torch.arange(8)[None, :]
    with runtime.sharded_forward(tp=tp):
        with pytest.raises(NotImplementedError, match="queue A7 part 4"):
            dense.layers[0].attn(x, positions, lora=lora.layer(0))


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
    its cache, a cache without decode, an unknown paged KV dtype and int8
    pools read through a native state (the int8 paged KV is ported)."""
    from accelerate_tpu_torch.models.generation import init_cache

    model = port.CausalLM(port.TransformerConfig.tiny(num_layers=1), device="cpu")
    ids = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="needs a cache"):
        model(ids, decode=True)
    with pytest.raises(ValueError, match="decode=True"):
        model(ids, cache=init_cache(model, 1))
    with pytest.raises(ValueError, match="kv_dtype"):
        attention.PagedKVState(torch.zeros(1, 2), torch.zeros(1), torch.ones(1), num_blocks=4,
                               block_size=2, kv_dtype="fp8")
    pools = init_cache(model, num_blocks=4, block_size=2, kv_dtype="int8")
    native = attention.PagedKVState(torch.zeros(1, 2, dtype=torch.long), torch.zeros(1),
                                    torch.ones(1), num_blocks=4, block_size=2)
    with pytest.raises(ValueError, match="pools are 'int8'"):
        model(ids[:, :1], decode=True, paged=native, cache=pools)
    assert model(ids, decode=True, cache=init_cache(model, 1)).shape == (1, 4, 1024)


def test_accumulation_raw_loop_and_telemetry_modules_import_without_jax():
    """The gradient-accumulation and raw-loop slice's modules and its five
    examples, each imported on its own with jax blocked."""
    code = textwrap.dedent("""
        import importlib
        for name in ("accelerate_tpu_torch.utils.memory", "accelerate_tpu_torch.utils.environment",
                     "accelerate_tpu_torch.telemetry.recompile",
                     "accelerate_tpu_torch.telemetry.config",
                     "accelerate_tpu_torch.telemetry.collector",
                     "accelerate_tpu_torch.examples.gradient_accumulation",
                     "accelerate_tpu_torch.examples.automatic_gradient_accumulation",
                     "accelerate_tpu_torch.examples.memory",
                     "accelerate_tpu_torch.examples.early_stopping",
                     "accelerate_tpu_torch.examples.cross_validation"):
            importlib.import_module(name)
        print("ok")
    """)
    result = _run_blocked(code)
    assert result.returncode == 0 and result.stdout.strip() == "ok", result.stderr


def test_diagnostics_modules_import_without_jax():
    """The diagnostics slice's modules, each imported on its own with jax
    blocked, and the diagnose command run through ``python -m``."""
    code = textwrap.dedent("""
        import importlib, subprocess, sys, tempfile
        for name in ("accelerate_tpu_torch.diagnostics",
                     "accelerate_tpu_torch.diagnostics.config",
                     "accelerate_tpu_torch.diagnostics.goodput",
                     "accelerate_tpu_torch.diagnostics.anomaly",
                     "accelerate_tpu_torch.diagnostics.flight_recorder",
                     "accelerate_tpu_torch.diagnostics.capture",
                     "accelerate_tpu_torch.diagnostics.manager",
                     "accelerate_tpu_torch.diagnostics.diagnose",
                     "accelerate_tpu_torch.telemetry.heartbeat",
                     "accelerate_tpu_torch.utils.profiling",
                     "accelerate_tpu_torch.compilation.overlap",
                     "accelerate_tpu_torch.commands.accelerate_cli",
                     "accelerate_tpu_torch.commands.diagnose"):
            importlib.import_module(name)
        print("ok")
    """)
    result = _run_blocked(code)
    assert result.returncode == 0 and result.stdout.strip() == "ok", result.stderr


def test_no_refusal_names_queue_item_2b():
    """Diagnostics, the heartbeat and ``Accelerator.profile`` are ported:
    no message in the port names queue A item 2b any more, and the
    Accelerator takes ``diagnostics=`` and ``profile_kwargs=``."""
    texts = [p.read_text() for p in (REPO / "accelerate_tpu_torch").rglob("*.py")]
    assert not [t for t in texts if "item 2b" in t]
    acc = port.Accelerator(cpu=True, diagnostics=True, profile_kwargs=port.ProfileKwargs())
    assert acc.telemetry.enabled and acc.profile_handler is not None
    with acc.profile() as handle:
        assert handle is None  # no directory configured: a no-op
    acc.end_training()


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
                     "accelerate_tpu_torch.utils.cuda_graph", "accelerate_tpu_torch.loadgen",
                     "accelerate_tpu_torch.loadgen.harness", "accelerate_tpu_torch.loadgen.chaos",
                     "accelerate_tpu_torch.loadgen.workload", "accelerate_tpu_torch.loadgen.report",
                     "accelerate_tpu_torch.loadgen.phases",
                     "accelerate_tpu_torch.test_utils.fault_injection",
                     "accelerate_tpu_torch.profiling.census"):
            importlib.import_module(name)
        print("ok")
    """)
    result = _run_blocked(code)
    assert result.returncode == 0 and result.stdout.strip() == "ok", result.stderr


def test_fleet_modules_import_and_run_without_jax():
    """The router package and the transfer plane, each imported on its own
    with jax blocked; then a disaggregated fleet (one prefill and one decode
    replica of a CPU model, ``host_buffer`` plane) drains a request there."""
    code = textwrap.dedent("""
        import importlib
        for name in ("accelerate_tpu_torch.router", "accelerate_tpu_torch.router.policies",
                     "accelerate_tpu_torch.router.replica", "accelerate_tpu_torch.router.router",
                     "accelerate_tpu_torch.serving.transfer"):
            importlib.import_module(name)
        import accelerate_tpu_torch as port
        from accelerate_tpu_torch.router import FleetRouter, InProcessReplica
        from accelerate_tpu_torch.serving import ServingEngine, TransferPlane
        model = port.CausalLM(port.TransformerConfig.tiny(num_layers=1, max_seq_len=32),
                              device="cpu")
        plane = TransferPlane("host_buffer")
        fleet = FleetRouter([InProcessReplica(role[0], ServingEngine(
            model, max_slots=1, block_size=8, role=role, transfer_plane=plane))
            for role in ("prefill", "decode")], placement="disagg", transfer_plane=plane)
        rid = fleet.add_request(list(range(1, 12)), max_new_tokens=3)
        while fleet.has_work:
            fleet.step()
        assert len(fleet.result(rid)) == 3 and plane.transfers_total == 1
        print("ok")
    """)
    result = _run_blocked(code)
    assert result.returncode == 0 and result.stdout.strip() == "ok", result.stderr


def test_lora_modules_import_and_run_without_jax():
    """``adapters``, ``utils.quantization``, ``tracking`` and
    ``memory_utils``, each imported on its own with jax blocked; then a
    QLoRA step over an int8 base, an engine serving a tenant from the
    registry, a committed adapter dir read back, and a JSONL tracker, all
    there."""
    code = textwrap.dedent("""
        import importlib, json, os, tempfile, warnings
        for name in ("accelerate_tpu_torch.adapters", "accelerate_tpu_torch.adapters.lora",
                     "accelerate_tpu_torch.adapters.registry",
                     "accelerate_tpu_torch.adapters.runtime",
                     "accelerate_tpu_torch.adapters.checkpoint",
                     "accelerate_tpu_torch.utils.quantization", "accelerate_tpu_torch.tracking"):
            importlib.import_module(name)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            importlib.import_module("accelerate_tpu_torch.memory_utils")
        import torch
        import accelerate_tpu_torch as port
        from accelerate_tpu_torch import adapters
        from accelerate_tpu_torch.serving import ServingEngine
        from accelerate_tpu_torch.tracking import JSONLTracker
        from accelerate_tpu_torch.utils.quantization import QuantizationConfig, quantize_params
        cfg = port.TransformerConfig.tiny(num_layers=1, max_seq_len=32)
        model = port.CausalLM(cfg, device="cpu").requires_grad_(False)
        lcfg = adapters.LoraConfig(rank=2)
        acc = port.Accelerator(cpu=True)
        qbase = quantize_params(model, QuantizationConfig(load_in_8bit=True, min_weight_size=256))
        adapter = acc.prepare(adapters.init_adapter(torch.Generator().manual_seed(0), cfg, lcfg))
        opt = acc.prepare(port.adamw(1e-2))
        step = acc.unified_step(adapters.lora_loss_fn(model, qbase, lcfg), opt)
        carry, metrics = step(acc.init_carry(adapter, opt),
                              {"input_ids": torch.randint(0, cfg.vocab_size, (2, 8))})
        adapters.assert_adapter_only(carry["params"], lcfg)
        registry = adapters.AdapterRegistry(cfg, capacity=1, max_rank=2, device="cpu")
        registry.load("t", carry["params"], lcfg)
        engine = ServingEngine(model, max_slots=1, block_size=8, adapters=registry)
        rid = engine.add_request([1, 2, 3], max_new_tokens=2, adapter="t")
        while engine.has_work:
            engine.step()
        base = tempfile.mkdtemp()
        loaded, _ = adapters.load_adapter(adapters.save_adapter(base, "t", carry["params"], lcfg))
        tracker = JSONLTracker("run", logging_dir=base)
        tracker.log({"loss": metrics["loss"]}, step=1)
        tracker.finish()
        line = json.loads(open(os.path.join(base, "run", "metrics.jsonl")).read())
        assert len(engine.result(rid)) == 2 and set(loaded) == {"q_proj", "v_proj"}
        assert line["loss"] == float(metrics["loss"])
        print("ok")
    """)
    result = _run_blocked(code)
    assert result.returncode == 0 and result.stdout.strip() == "ok", result.stderr


def test_lora_slice_refusals_name_their_queue_items(tmp_path):
    """What the lora slice left: ``load_and_quantize_model`` and the PEFT
    helpers are ported since the big-model slice and work (a native
    checkpoint quantized on load, an adapter through PEFT's names and back);
    a load onto a mesh works since the sharding slice (its checks here, the
    load itself in ``test_torch_big_modeling.py``); the tracker bridge (A10)
    still raises, matched by name; the helpers' forms across several
    processes (A4) work since the processes-and-data slice."""
    from accelerate_tpu_torch import adapters, big_modeling, tracking
    from accelerate_tpu_torch.checkpointing import save_model_weights
    from accelerate_tpu_torch.state import PartialState
    from accelerate_tpu_torch.utils import quantization

    cfg = port.TransformerConfig.tiny(num_layers=1)
    save_model_weights(port.CausalLM(cfg, device="cpu"), str(tmp_path))
    qparams = quantization.load_and_quantize_model(
        big_modeling.init_empty_weights(port.CausalLM, cfg), str(tmp_path),
        quantization.QuantizationConfig(load_in_8bit=True, min_weight_size=256), device="cpu")
    assert quantization.is_quantized(qparams["layers.0.attn.q_proj.weight"])
    lcfg = adapters.LoraConfig(rank=2, target_modules=("q_proj",))
    adapter = adapters.init_adapter(torch.Generator().manual_seed(0), cfg, lcfg)
    back = adapters.peft_to_adapter(adapters.adapter_to_peft(adapter, lcfg, cfg), lcfg, cfg)
    assert torch.equal(back["q_proj"]["lora_a"], adapter["q_proj"]["lora_a"])
    # a load onto a mesh is ported since the sharding slice: a mesh that is
    # not a DeviceMesh is refused by name, and plugin= without a mesh
    with pytest.raises(TypeError, match="DeviceMesh"):
        big_modeling.load_checkpoint_and_dispatch({}, str(tmp_path), mesh=object())
    with pytest.raises(ValueError, match="pass mesh="):
        big_modeling.load_checkpoint_and_dispatch({}, str(tmp_path), logical_specs={})
    with pytest.raises(NotImplementedError, match="queue A10"):
        tracking.telemetry_bridge([])
    # the A4 forms are ported: an adapter saved by two processes (here two
    # threads, process 1 waiting for process 0's commit) and the barrier at
    # world 2 (two processes over gloo)
    import threading

    from accelerate_tpu_torch.launchers import debug_launcher
    from accelerate_tpu_torch.test_utils.scripts.multiprocess_worker import barrier_worker

    base = str(tmp_path / "adapters")
    other = threading.Thread(target=adapters.save_adapter,
                             args=(base, "t", adapter, lcfg), kwargs=dict(process_index=1,
                                                                          world=2))
    other.start()
    path = adapters.save_adapter(base, "t", adapter, lcfg, process_index=0, world=2)
    other.join()
    loaded, _ = adapters.load_adapter(path)
    assert torch.equal(loaded["q_proj"]["lora_a"], adapter["q_proj"]["lora_a"])
    debug_launcher(barrier_worker, num_processes=2)
    assert not PartialState._shared_state  # the launch made no state in this process


def test_launch_modules_import_and_run_without_jax():
    """``launchers``, ``local_sgd`` and ``test_utils.scripts.*`` imported on
    their own with jax blocked; then two processes over gloo run the
    collectives worker and the whole assertion script, and LocalSGD's
    one-process forms run, all in that process."""
    code = textwrap.dedent("""
        import importlib
        for name in ("accelerate_tpu_torch.launchers", "accelerate_tpu_torch.local_sgd",
                     "accelerate_tpu_torch.test_utils.training",
                     "accelerate_tpu_torch.test_utils.scripts.multiprocess_worker",
                     "accelerate_tpu_torch.test_utils.scripts.test_script",
                     "accelerate_tpu_torch.utils.tqdm", "accelerate_tpu_torch.utils.versions"):
            importlib.import_module(name)
        import torch
        from accelerate_tpu_torch.launchers import debug_launcher
        from accelerate_tpu_torch.local_sgd import average_replicas, replicate_params
        from accelerate_tpu_torch.test_utils.scripts import multiprocess_worker, test_script
        if __name__ == "__main__":
            debug_launcher(multiprocess_worker.collective_worker, num_processes=2)
            debug_launcher(test_script.run_all_checks, num_processes=2)
            reps = replicate_params({"w": torch.arange(3.0)}, 4)
            assert reps["w"].shape == (4, 3)
            assert torch.equal(average_replicas(reps)["w"], torch.arange(3.0))
            leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "optax")
                      and sys.modules[m] is not None]
            assert not leaked, leaked
            print("ok")
    """)
    result = _run_blocked(code)
    assert result.returncode == 0 and result.stdout.strip().endswith("ok"), result.stderr[-3000:]


def test_refusals_left_by_the_launch_slice_name_their_queue_items():
    """What part 1 of queue A4 left: a sharded state's per-process shards
    are ported since the sharding slice (part 2); pipelines (part 3) and
    sequence and expert parallelism (part 4) since the slice after it, so
    no axis refuses and ``pipeline_check`` runs (it needs an even world
    above 1: the world-2 and world-4 launches of ``test_torch_launchers.py``
    run it; at world 1 it says it skipped); a plugin whose degrees do not
    cover the world still raises, with no group left up; the elastic
    supervisor waits for A4's last part."""
    from accelerate_tpu_torch.parallel import mesh as mesh_mod
    from accelerate_tpu_torch.state import group_is_up
    from accelerate_tpu_torch.test_utils.scripts.test_script import pipeline_check

    assert mesh_mod.UNPORTED_AXES == {}
    mesh_mod.check_ported({"dp": 1, "pp": 2, "fsdp": 1, "ep": 2, "sp": 2, "tp": 1})
    pipeline_check(port.Accelerator(cpu=True))
    for kwargs in (dict(pp_size=2), dict(sp_size=2), dict(ep_size=2)):
        port.AcceleratorState._reset_state(reset_partial_state=True)
        with pytest.raises(ValueError, match="device count"):
            port.Accelerator(cpu=True, parallelism_plugin=port.ParallelismPlugin(
                dp_size=1, num_micro_batches=2, **kwargs))
        assert not group_is_up() and not port.AcceleratorState._shared_state
    import accelerate_tpu_torch.fault_tolerance as ft

    assert "queue A4" in ft.__doc__ and "elastic" in ft.__doc__


def test_parallel_and_compat_import_without_jax():
    """``parallel/`` (mesh, sharding rules, the step's collectives) and
    ``utils/compat.py``, each imported on its own with jax blocked; the
    rules place the tiny model's leaves there with no process group."""
    code = textwrap.dedent("""
        import importlib
        for name in ("accelerate_tpu_torch.parallel", "accelerate_tpu_torch.parallel.mesh",
                     "accelerate_tpu_torch.parallel.sharding",
                     "accelerate_tpu_torch.parallel.runtime",
                     "accelerate_tpu_torch.utils.compat"):
            importlib.import_module(name)
        import accelerate_tpu_torch as port
        from accelerate_tpu_torch.parallel.sharding import (get_logical_specs,
                                                            infer_param_shardings)
        from accelerate_tpu_torch.utils.compat import DeepSpeedPlugin
        model = port.CausalLM(port.TransformerConfig.tiny(), device="meta")
        params = {k: tuple(v.shape) for k, v in model.named_parameters()}
        specs = infer_param_shardings(params, {"fsdp": 2, "tp": 2},
                                      port.ParallelismPlugin(dp_size=1, fsdp_size=2, tp_size=2),
                                      get_logical_specs(model))
        assert specs["embed.weight"] == (("tp", "fsdp"), None), specs["embed.weight"]
        assert DeepSpeedPlugin(zero_stage=3).fsdp_size == -1
        print("ok")
    """)
    result = _run_blocked(code)
    assert result.returncode == 0, result.stderr[-3000:]
    assert result.stdout.strip().endswith("ok")


def test_big_model_modules_import_and_run_without_jax():
    """``big_modeling``, ``utils.offload``, ``utils.hf_interop`` and the
    example, each imported on its own with jax, safetensors and transformers
    blocked; then a model written natively and in HF's layout by the port's
    own codec, loaded from its meta model over the host and disk tiers, its
    logits the written model's bit for bit, quantized on load, and the
    example run on the CPU, all there."""
    code = textwrap.dedent("""
        import importlib, tempfile, os
        for name in ("accelerate_tpu_torch.big_modeling", "accelerate_tpu_torch.utils.offload",
                     "accelerate_tpu_torch.utils.hf_interop",
                     "accelerate_tpu_torch.examples.big_model_inference"):
            importlib.import_module(name)
        import torch
        import accelerate_tpu_torch as port
        from accelerate_tpu_torch.checkpointing import save_model_weights
        from accelerate_tpu_torch.examples import big_model_inference
        from accelerate_tpu_torch.utils import hf_interop, quantization
        cfg = port.TransformerConfig.tiny(num_layers=2, max_seq_len=32)
        model = port.CausalLM(cfg, device="cpu")
        base = tempfile.mkdtemp()
        save_model_weights(model, os.path.join(base, "native"), max_shard_size="500KB")
        hf_interop.save_hf_checkpoint(model, cfg, os.path.join(base, "hf"), max_shard_size="500KB")
        ids = torch.randint(0, cfg.vocab_size, (1, 8))
        for fmt in ("native", "hf"):
            meta = port.init_empty_weights(port.CausalLM, cfg)
            tree = port.load_checkpoint_and_dispatch(meta, os.path.join(base, fmt),
                                                     max_memory={"cpu": 1 << 20},
                                                     offload_dir=os.path.join(base, fmt + "_off"))
            assert {type(v).__name__ for v in tree.values()} == {"Tensor", "OffloadedLeaf"}
            live = port.materialize_offloaded(tree, "cpu")
            with torch.no_grad():
                assert torch.equal(torch.func.functional_call(meta, live, (ids,)), model(ids))
        qparams = quantization.load_and_quantize_model(
            port.init_empty_weights(port.CausalLM, cfg), os.path.join(base, "hf"),
            quantization.QuantizationConfig(load_in_4bit=True, min_weight_size=256), device="cpu")
        assert quantization.is_quantized(qparams["layers.1.mlp.down_proj.weight"])
        out = big_model_inference.main(["--cpu", "--max_memory_mb", "1", "--workdir",
                                        os.path.join(base, "example")])
        assert out["resident"] == out["tiered"] and out["tiers"] == ["cpu", "disk"]
        print("ok")
    """)
    result = _run_blocked(code)
    assert result.returncode == 0 and result.stdout.strip().splitlines()[-1] == "ok", \
        result.stderr


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


def test_unported_accelerator_and_model_paths_raise(tmp_path):
    from accelerate_tpu_torch import dist_checkpoint
    from accelerate_tpu_torch.checkpoint_async import commit as commit_mod

    assert port.Accelerator(mixed_precision="fp8", cpu=True).state.mixed_precision_policy.fp8
    # sharding (queue A7 part 2), pipelines (part 3) and sequence and expert
    # parallelism (part 4) are ported: a plugin of every axis at 1 builds a
    # mesh of one, and one above 1 needs that many processes (the gloo
    # tests at world 4); a mesh across slices raises naming part 5
    from accelerate_tpu_torch.parallel import mesh as mesh_mod

    for kwargs in (dict(pp_size=1), dict(sp_size=1), dict(ep_size=1)):
        port.AcceleratorState._reset_state(reset_partial_state=True)
        acc = port.Accelerator(cpu=True, parallelism_plugin=port.ParallelismPlugin(
            dp_size=1, **kwargs))
        assert acc.mesh is not None
        acc.state.partial_state.destroy_process_group()
    assert "part 5" in mesh_mod.build_mesh.__code__.co_consts.__repr__()
    port.AcceleratorState._reset_state(reset_partial_state=True)
    # diagnostics is ported: the item 2b refusal is gone
    assert port.Accelerator(cpu=True, diagnostics=True).telemetry.diagnostics is not None
    # a load onto another topology is ported (queue A4, part 1): a world-2
    # checkpoint refuses without allow_reshape, with the reference's error
    acc = port.Accelerator(cpu=True)
    params = {"w": torch.arange(4.0)}
    work = commit_mod.work_dir_for(str(tmp_path / "w2"))
    dist_checkpoint.save_sharded_tree(params, work, process_index=0)
    dist_checkpoint.save_sharded_tree(params, work, process_index=1)
    commit_mod.mark_done(work, 1)
    out = commit_mod.commit(work, str(tmp_path / "w2"), 0, 2, topology={"world_size": 2,
                                                                         "num_devices": 2})
    with pytest.raises(ValueError, match="allow_reshape=True"):
        acc.load_state(out, params={"w": torch.zeros(4)})
    got = acc.load_state(out, params={"w": torch.zeros(4)}, allow_reshape=True)
    assert torch.equal(got["w"], params["w"])
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
    # ring attention is ported (queue A7 part 4): with no sp above 1 it is
    # the plain path over the whole sequence, and refuses a window
    ring = attention.dot_product_attention(q, k, k, causal=True, implementation="ring")
    torch.testing.assert_close(ring, attention.xla_attention(q, k, k, causal=True))
    with pytest.raises(ValueError, match="sliding windows"):
        attention.dot_product_attention(q, k, k, causal=True, implementation="ring", window=8)


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


def test_serving_refusals_that_remain_name_their_queue_items():
    """The HTTP plane and program capture are A10. Adapters are ported: the
    engine takes a registry and ``add_request(adapter=)``, the soak harness
    loads its tenants into the registry and the adapter-churn fault evicts
    them; disaggregation, the transfer plane and the router's hooks are
    ported too: a role is validated, the hooks answer."""
    from accelerate_tpu_torch.adapters import AdapterRegistry
    from accelerate_tpu_torch.loadgen import ChaosAdapter, SoakConfig, SoakHarness, WorkloadConfig
    from accelerate_tpu_torch.serving import ServingEngine
    from accelerate_tpu_torch.test_utils.fault_injection import FaultInjector, FaultSpec

    model = port.CausalLM(port.TransformerConfig.tiny(num_layers=1, max_seq_len=32),
                          device="cpu")
    registry = AdapterRegistry(model.config, capacity=2, max_rank=4, device="cpu")
    assert ServingEngine(model, adapters=registry).adapters is registry
    with pytest.raises(ValueError, match="role"):
        ServingEngine(model, role="verifier")
    assert ServingEngine(model, role="decode", transfer_plane=object()).role == "decode"
    engine = ServingEngine(model, max_slots=1, block_size=8)
    with pytest.raises(ValueError, match="AdapterRegistry"):
        engine.add_request([1, 2], adapter="tenant")
    for method in ("start_http", "capture_programs", "audit_programs"):
        with pytest.raises(NotImplementedError, match="queue A10"):
            getattr(engine, method)()
    assert engine.health() == {"ok": True, "state": "serving"}
    assert engine.prefix_digest()["entries"] == [] and engine.drain() == []
    assert engine.health()["state"] == "draining"
    engine.undrain()
    engine = ServingEngine(model, max_slots=1, block_size=8, adapters=registry)
    harness = SoakHarness(engine, SoakConfig(workload=WorkloadConfig(adapters=("t",),
                                                                     adapter_fraction=0.5)))
    harness._load_tenants()
    assert registry.resident_names() == ["t"] and registry.load_total == 1
    chaos = ChaosAdapter(engine, FaultInjector([], rank=0, generation=0), lambda: 0.0)
    chaos._on_adapter_churn(FaultSpec.parse("adapter_churn@0"))
    # the wave of three evicts the tenant and its own first member, then
    # its last two: four evictions, nothing resident
    assert registry.resident_names() == [] and registry.evict_total == 4


def test_capacity_levers_run_on_the_model_device():
    """The options the soak slice lifted run, with their buffers where the
    model's parameters are: chunked prefill, preemption with priorities and
    the int8 pools (codes and scale arrays) on a model built on the CPU."""
    from accelerate_tpu_torch.serving import ServingEngine

    model = port.CausalLM(port.TransformerConfig.tiny(num_layers=1, max_seq_len=32),
                          device="cpu")
    engine = ServingEngine(model, max_slots=2, block_size=4, num_blocks=9,
                           prefill_chunk_tokens=4, preemption=True, kv_dtype="int8")
    assert {t.device for t in engine.cache.tensors()} == {torch.device("cpu")}
    assert [t.dtype for t in engine.cache.tensors()] == [torch.int8] * 2 + [torch.float32] * 2
    low = engine.add_request(list(range(1, 12)), max_new_tokens=6)
    engine.step()
    high = engine.add_request(list(range(3, 14)), max_new_tokens=6, priority=3)
    while engine.has_work:
        engine.step()
    assert len(engine.result(low)) == len(engine.result(high)) == 6
    assert engine._prefill_chunks_total > 2 and engine.trace_counts()["decode"] == 1
    assert engine.pool.stats()["allocated"] == 0 and engine.pool.num_swapped == 0
