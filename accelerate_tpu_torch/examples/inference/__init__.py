"""The reference's inference examples in PyTorch: ``streaming_serve.py``
(continuous batching over a paged KV cache) and ``distributed.py`` (batch
inference split across processes)."""
