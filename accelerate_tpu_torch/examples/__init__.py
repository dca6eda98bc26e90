"""The reference's examples in PyTorch: ``nlp_example.py`` (the BERT
fine-tune) and ``checkpointing.py`` (the same with save_state and
resume). Run them by path or with ``python -m``."""
