"""Optimizers of the port: the reference's fifteen update rules, the
multi-tensor apply and the learning-rate schedulers."""
from . import lr_scheduler
from .lr_scheduler import (CosineScheduler, FactorScheduler, LRScheduler,
                           MultiFactorScheduler, PolyScheduler)
from .optimizer import (DCASGD, FTML, LAMB, LARS, NAG, SGD, SGLD, AdaDelta,
                        AdaGrad, Adam, AdamW, Ftrl, Nadam, Optimizer,
                        RMSProp, Signum, create, register)

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdamW", "Nadam", "LAMB",
           "LARS", "RMSProp", "AdaGrad", "AdaDelta", "Ftrl", "FTML",
           "Signum", "DCASGD", "SGLD", "create", "register",
           "lr_scheduler", "LRScheduler", "FactorScheduler",
           "MultiFactorScheduler", "PolyScheduler", "CosineScheduler"]
