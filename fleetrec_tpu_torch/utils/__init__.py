"""Timing and profiling helpers (utils/timing.py, utils/prof.py)."""
