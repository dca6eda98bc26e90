"""Worker functions and the assertion script the multi-process tests run
under ``launchers.debug_launcher``."""
