"""Evidence from profile captures (``overlap.py``).

Port of the part of ``accelerate_tpu/compilation/`` that the diagnostics
manager reads; the rest waits for ROADMAP.md, queue A10.
"""
