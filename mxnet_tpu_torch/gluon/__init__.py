"""Gluon surface of the port: losses and the imperative ``Trainer``."""
from . import loss
from .trainer import Trainer

__all__ = ["loss", "Trainer"]
