"""Test utilities: deterministic fault injection (``fault_injection.py``),
the toy models and data of the tests (``training.py``), the examples'
drift check (``examples.py``'s ``compare_against_test``), and the worker
functions the multi-process tests run under ``launchers.debug_launcher``
(``scripts/``). Everything here imports torch and the port, never JAX, so a
spawned child resolves it by name."""
