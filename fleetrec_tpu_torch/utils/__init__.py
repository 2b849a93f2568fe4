"""Timing helpers (utils/timing.py)."""
