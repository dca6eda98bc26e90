"""The port's tree helpers and collectives against the JAX reference's, on
the CPU.

Mirrors the 17 tests of ``tests/test_operations.py`` on both packages, each
package's function on the same inputs with the same answer (the reference's
sharded-array gather becomes a gather of a whole tensor: the port's process
holds whole tensors; its ``is_jax_version`` is the port's
``is_torch_version``). One launch over gloo at world 3 then checks every
multi-process form (``operations_worker``): ``gather_object`` of objects of
unequal sizes, ``pad_across_processes`` of unequal lengths (at the end and
at the front) before a ``gather``, ``reduce`` ``"sum"`` and ``"mean"`` with
a scale, ``broadcast`` from process 0 and from the last,
``broadcast_object_list`` in place, ``split_between_processes`` with
padding, the barrier, ``synchronize_rng_states``, the debug-mode checker,
and ``save_adapter`` by every process.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import accelerate_tpu as jax_pkg  # noqa: E402
from accelerate_tpu import utils as jops  # noqa: E402

import accelerate_tpu_torch as port  # noqa: E402
from accelerate_tpu_torch.utils import operations as pops  # noqa: E402


def _reset():
    port.AcceleratorState._reset_state(reset_partial_state=True)
    port.GradientState._reset_state()
    jax_pkg.state.AcceleratorState._reset_state(reset_partial_state=True)
    jax_pkg.state.GradientState._reset_state()


@pytest.fixture(autouse=True)
def reset_singletons():
    _reset()
    yield
    _reset()


def test_recursively_apply_nested():
    for ops, ones, zeros in ((jops, jnp.ones, jnp.zeros), (pops, torch.ones, torch.zeros)):
        data = {"a": ones(3), "b": [zeros(2), "keep"], "c": (1, ones(1))}
        out = ops.recursively_apply(lambda x: x + 1, data)
        assert float(out["a"][0]) == 2.0
        assert out["b"][1] == "keep"
        assert out["c"][0] == 1


def test_send_to_device():
    batch = {"x": np.ones((4, 2), dtype=np.float32), "y": np.zeros(4)}
    jout = jops.send_to_device(batch, jax.devices()[0])
    pout = pops.send_to_device(batch, torch.device("cpu"))
    assert isinstance(jout["x"], jax.Array) and isinstance(pout["x"], torch.Tensor)
    assert pout["x"].device == torch.device("cpu")
    for k in batch:
        np.testing.assert_array_equal(pout[k].numpy(), np.asarray(jout[k]))


def test_send_to_device_skip_keys():
    batch = {"x": np.ones(2), "meta": np.zeros(2)}
    assert isinstance(jops.send_to_device(batch, jax.devices()[0], skip_keys=["meta"])["meta"],
                      np.ndarray)
    out = pops.send_to_device(batch, torch.device("cpu"), skip_keys=["meta"])
    assert isinstance(out["meta"], np.ndarray) and isinstance(out["x"], torch.Tensor)


def test_data_structure_roundtrip():
    jempty = jops.initialize_tensors(jops.get_data_structure(
        {"a": jnp.ones((2, 3)), "b": [jnp.zeros(5, dtype=jnp.int32)]}))
    pempty = pops.initialize_tensors(pops.get_data_structure(
        {"a": torch.ones(2, 3), "b": [torch.zeros(5, dtype=torch.int32)]}))
    assert jempty["a"].shape == tuple(pempty["a"].shape) == (2, 3)
    assert jempty["b"][0].dtype == jnp.int32 and pempty["b"][0].dtype == torch.int32
    assert not pempty["a"].any()
    # a numpy skeleton initializes as the reference's would
    np_empty = pops.initialize_tensors(pops.get_data_structure({"n": np.ones(4, np.float16)}))
    assert np_empty["n"].dtype == torch.float16


def test_find_batch_size():
    assert jops.find_batch_size({"x": jnp.ones((7, 2))}) == 7
    assert pops.find_batch_size({"x": torch.ones(7, 2)}) == 7
    assert jops.find_batch_size({"x": 3}) is None and pops.find_batch_size({"x": 3}) is None


def test_slice_concat():
    jmerged = jops.concatenate([jops.slice_tensors({"x": jnp.arange(10)}, slice(0, 4))] * 2)
    psliced = pops.slice_tensors({"x": torch.arange(10)}, slice(0, 4))
    pmerged = pops.concatenate([psliced, psliced])
    assert psliced["x"].shape == (4,) and pmerged["x"].shape == (8,)
    np.testing.assert_array_equal(pmerged["x"].numpy(), np.asarray(jmerged["x"]))
    assert pops.find_device(pmerged) == torch.device("cpu")


def test_convert_to_fp32():
    jout = jops.convert_to_fp32({"a": jnp.ones(2, dtype=jnp.bfloat16),
                                 "b": jnp.ones(2, dtype=jnp.int32)})
    pout = pops.convert_to_fp32({"a": torch.ones(2, dtype=torch.bfloat16),
                                 "b": torch.ones(2, dtype=torch.int32)})
    assert jout["a"].dtype == jnp.float32 and pout["a"].dtype == torch.float32
    assert jout["b"].dtype == jnp.int32 and pout["b"].dtype == torch.int32


def test_gather_single_process_sharded_array():
    """One process: the reference's gather of a sharded array returns the
    whole array; the port's process holds it whole, and gets it back."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    full = np.arange(16.0).reshape(8, 2)
    x = jax.device_put(jnp.asarray(full), NamedSharding(jax_pkg.AcceleratorState().mesh,
                                                         P("dp", None)))
    np.testing.assert_allclose(np.asarray(jops.gather(x)), full)
    got = pops.gather(torch.from_numpy(full))
    assert got.shape == (8, 2)
    np.testing.assert_array_equal(got.numpy(), full)


def test_gather_object_single():
    assert jops.gather_object({"k": 1}) == pops.gather_object({"k": 1}) == [{"k": 1}]


def test_broadcast_single():
    jout = jops.broadcast({"a": jnp.ones(3)})
    pout = pops.broadcast({"a": torch.ones(3)})
    np.testing.assert_allclose(pout["a"].numpy(), np.asarray(jout["a"]))


def test_broadcast_object_list_single():
    assert jops.broadcast_object_list(["a", 1]) == pops.broadcast_object_list(["a", 1]) == ["a", 1]


def test_reduce_single():
    """One process: the sum is the tensor, and the mean too (the reference
    divides by the world size only across processes), times ``scale``."""
    for reduction in ("sum", "mean"):
        jout = jops.reduce(jnp.arange(3.0), reduction, scale=2.0)
        pout = pops.reduce(torch.arange(3.0), reduction, scale=2.0)
        np.testing.assert_array_equal(pout.numpy(), np.asarray(jout))
    with pytest.raises(ValueError):
        pops.reduce(torch.ones(1), "max")


def test_pad_input_tensors():
    x = np.arange(10.0).reshape(5, 2)
    jout = jops.pad_input_tensors({"x": jnp.asarray(x)}, batch_size=5, num_processes=4)
    pout = pops.pad_input_tensors({"x": torch.from_numpy(x)}, batch_size=5, num_processes=4)
    assert pout["x"].shape == (8, 2)
    np.testing.assert_array_equal(pout["x"].numpy(), np.asarray(jout["x"]))
    np.testing.assert_array_equal(pout["x"][5:].numpy(), np.tile(x[4:5], (3, 1)))


def test_pad_across_processes_single_noop():
    x = torch.ones(3, 2)
    assert pops.pad_across_processes(x) is x
    y = jnp.ones((3, 2))
    assert jops.pad_across_processes(y) is y


def test_tqdm_wrapper_main_process_only():
    from accelerate_tpu.utils.tqdm import tqdm as jax_tqdm
    from accelerate_tpu_torch.utils.tqdm import tqdm

    assert list(tqdm(range(3), main_process_only=True)) == list(
        jax_tqdm(range(3), main_process_only=True)) == [0, 1, 2]
    assert not port.state.PartialState._shared_state  # the wrapper made no state


def test_compare_versions():
    from accelerate_tpu.utils.versions import compare_versions as jax_compare
    from accelerate_tpu_torch.utils.versions import compare_versions, is_torch_version

    for cmp in (jax_compare, compare_versions):
        assert cmp("numpy", ">=", "1.0")
        assert not cmp("numpy", "<", "1.0")
        with pytest.raises(ValueError):
            cmp("numpy", "~=", "1.0")
    assert is_torch_version(">", "0.1")


def test_join_uneven_inputs_overrides_even_batches():
    class DS:
        def __len__(self):
            return 20  # not divisible by the global batch

        def __getitem__(self, i):
            return {"x": np.ones((2,), np.float32) * i}

    jacc = jax_pkg.Accelerator()
    acc = port.Accelerator(cpu=True)
    for a, loader in ((jacc, jax_pkg.DataLoader(DS(), batch_size=8)),
                      (acc, port.DataLoader(DS(), batch_size=8))):
        dl = a.prepare_data_loader(loader)
        assert dl.batch_sampler.even_batches is True
        with a.join_uneven_inputs([None], even_batches=False):
            assert dl.batch_sampler.even_batches is False
        assert dl.batch_sampler.even_batches is True
    # the override reaches the next epoch: the tail is padded, not wrapped
    dl = acc._dataloaders[-1]
    with acc.join_uneven_inputs([None], even_batches=False):
        last = list(dl)[-1]
        assert dl.remainder == 4
    np.testing.assert_array_equal(last["x"][:, 0].numpy(), [16, 17, 18, 19, 19, 19, 19, 19])


def test_every_multi_process_form(tmp_path):
    from accelerate_tpu_torch.launchers import debug_launcher
    from accelerate_tpu_torch.test_utils.scripts.multiprocess_worker import operations_worker

    debug_launcher(operations_worker, (str(tmp_path),), num_processes=3)
