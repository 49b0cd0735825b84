"""Parallel training of the port: ``SPMDTrainer`` on one device."""
from .spmd import SPMDTrainer

__all__ = ["SPMDTrainer"]
