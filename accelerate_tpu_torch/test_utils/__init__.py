"""Test utilities: deterministic fault injection (``fault_injection.py``)."""
