"""Gluon surface of the port: losses, the imperative ``Trainer``, the
layers of ``gluon.nn`` and the model zoo's ResNet family."""
from . import loss, model_zoo, nn
from .block import HybridBlock
from .trainer import Trainer

__all__ = ["loss", "nn", "model_zoo", "HybridBlock", "Trainer"]
