"""Checkpoints and monitoring."""
from .checkpoint import load_state, save_state
from .monitor import SolveTrace, profile

__all__ = ["load_state", "save_state", "SolveTrace", "profile"]
