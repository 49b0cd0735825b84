"""Optimizers of the port: the reference's SGD, Adam and AdamW rules, the
multi-tensor apply and the learning-rate schedulers."""
from . import lr_scheduler
from .lr_scheduler import (CosineScheduler, FactorScheduler, LRScheduler,
                           MultiFactorScheduler, PolyScheduler)
from .optimizer import SGD, Adam, AdamW, Optimizer, create, register

__all__ = ["Optimizer", "SGD", "Adam", "AdamW", "create", "register",
           "lr_scheduler", "LRScheduler", "FactorScheduler",
           "MultiFactorScheduler", "PolyScheduler", "CosineScheduler"]
