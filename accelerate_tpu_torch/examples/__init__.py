"""The reference's examples in PyTorch, under its file names: the BERT
fine-tune (``nlp_example.py``) and its complete form
(``complete_nlp_example.py``), the CV pair (``cv_example.py``,
``complete_cv_example.py``), ``seq2seq_example.py``,
``big_model_inference.py``, the by-feature scripts (checkpointing, tracking,
gradient accumulation and its automatic form, early stopping, memory,
cross-validation, local SGD, metrics across processes, profiling, FSDP
with peak-memory tracking, schedule-free AdamW) and ``inference/``
(streaming serving, distributed batch inference). Each runs on CUDA
unless given ``--cpu``; run them by path or with ``python -m``."""
