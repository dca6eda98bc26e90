"""Launchers: start a training function from a notebook or a test.

Port of ``accelerate_tpu/launchers.py`` (``notebook_launcher`` :36-60,
``debug_launcher`` :63-117). ``debug_launcher`` spawns N processes on this
host, wires them through a ``torch.distributed`` gloo group on the CPU
(a free localhost port is the rendezvous) and runs the function in each:
real multi-process collectives anywhere, the reference's debug-launcher
pattern.

Where the reference sends ``notebook_launcher(num_processes > 1)`` to the
CPU debug launcher whenever the backend is not a TPU (:52-53), the port
does so only when the caller runs on the CPU (``cpu=True``): no path moves
a run off the card unless the caller asks for the CPU. The mapping:

* ``num_processes`` None or 1: the function runs in this process, on
  whatever device it asks for (the reference's TPU branch: one process);
* ``num_processes > 1`` with ``cpu=True``: ``debug_launcher``, gloo on the
  CPU;
* ``num_processes > 1`` without ``cpu=True``: a ValueError. One process a
  card over NCCL is the ``launch`` command's (ROADMAP.md, queue A10), not
  this launcher's.

The hang guard: every worker's group takes ``timeout`` seconds as its
``DistributedInitKwargs.initialization_timeout``, which bounds the
rendezvous and every gloo collective, so a rank that never reaches a
collective makes the others raise; the parent also gives up on a worker
that has not exited JOIN_TIMEOUT_S seconds after the start, ends them all
and raises. Workers that all died on signals are launched once more (the
reference's rule for a transport flake, :100-109); an exception, an
exit code or a hang never retries.
"""

from __future__ import annotations

import os
import socket
import time
from datetime import timedelta
from typing import Any, Callable, Optional

from .logging import get_logger
from .utils.constants import ENV_PREFIX

logger = get_logger(__name__)

JOIN_TIMEOUT_S = 600.0  # the parent's backstop for a worker that never exits


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def notebook_launcher(function: Callable, args: tuple = (), num_processes: Optional[int] = None,
                      mixed_precision: str = "no", use_port: str = "29500", cpu: bool = False,
                      **kwargs) -> Any:
    """Run a training function from a notebook (reference :36): in this
    process, or, with ``num_processes > 1`` and ``cpu=True``, in
    ``num_processes`` CPU processes over gloo (the module docstring)."""
    if num_processes and num_processes > 1:
        if not cpu:
            raise ValueError(
                f"notebook_launcher(num_processes={num_processes}) runs CPU processes over gloo "
                "and moves nothing off the card unasked: pass cpu=True. One process a card "
                "over NCCL is the launch command's (ROADMAP.md, queue A10).")
        return debug_launcher(function, args, num_processes=num_processes, **kwargs)
    if mixed_precision != "no":
        os.environ[ENV_PREFIX + "MIXED_PRECISION"] = mixed_precision
    return function(*args)


def debug_launcher(function: Callable, args: tuple = (), num_processes: int = 2,
                   timeout: float = 60.0) -> None:
    """Spawn ``num_processes`` CPU processes with a localhost rendezvous and
    run ``function(*args)`` in each (reference :63). ``function`` must be
    importable by its qualified name (a module-level function). Raises
    RuntimeError naming the ranks that failed, with their exit codes (None:
    still running at JOIN_TIMEOUT_S)."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    for attempt in range(2):
        port = _free_port()
        procs = [ctx.Process(target=_debug_worker,
                             args=(function, args, rank, num_processes, port, timeout))
                 for rank in range(num_processes)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        failed = [(rank, p.exitcode) for rank, p in enumerate(procs) if p.exitcode != 0]
        for p in procs:  # no straggler keeps the port or a core
            if p.is_alive():
                p.terminate()
                p.join(30)
            if p.is_alive():
                p.kill()
                p.join()
        if not failed:
            return
        only_signals = all(code is not None and code < 0 for _, code in failed)
        if attempt == 0 and only_signals:
            logger.warning(f"debug_launcher workers died on signals {failed}; "
                           "launching once more")
            continue
        raise RuntimeError(f"debug_launcher workers failed (rank, exit code): {failed}")


def _debug_worker(function: Callable, args: tuple, rank: int, world: int, port: int,
                  timeout: float) -> None:
    os.environ[ENV_PREFIX + "NUM_PROCESSES"] = str(world)
    os.environ[ENV_PREFIX + "PROCESS_ID"] = str(rank)
    os.environ[ENV_PREFIX + "LOCAL_PROCESS_INDEX"] = str(rank)
    os.environ[ENV_PREFIX + "COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
    from .state import PartialState
    from .utils.dataclasses import DistributedInitKwargs

    state = PartialState(cpu=True, init_kwargs=DistributedInitKwargs(
        initialization_timeout=timedelta(seconds=timeout)))
    try:
        function(*args)
    finally:
        state.destroy_process_group()
