"""Memory attribution: the buffer census (``profiling/census.py``)."""

from .census import BufferCensus

__all__ = ["BufferCensus"]
