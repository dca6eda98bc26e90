"""Checkpoint commit protocol (``commit.py``). The reference's background
writer (``accelerate_tpu/checkpoint_async/writer.py``) is not ported yet
(ROADMAP.md, queue A6)."""
