"""A tqdm that renders on the main process only.

Port of ``accelerate_tpu/utils/tqdm.py``: every process of a multi-process
run would otherwise interleave its progress bar with the others'.
"""

from __future__ import annotations

import importlib.util


def tqdm(*args, main_process_only: bool = True, **kwargs):
    """``tqdm.auto.tqdm``, disabled off the main process unless
    ``main_process_only`` is False."""
    if importlib.util.find_spec("tqdm") is None:
        raise ImportError("accelerate_tpu_torch's tqdm wrapper requires tqdm to be installed")
    from tqdm.auto import tqdm as _tqdm

    if main_process_only:
        from ..state import current_process_index

        kwargs["disable"] = kwargs.get("disable", False) or current_process_index() != 0
    return _tqdm(*args, **kwargs)
