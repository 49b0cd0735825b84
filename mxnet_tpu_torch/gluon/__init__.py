"""Gluon surface of the port: the parameter layer (``Parameter``,
``Constant``, ``ParameterDict``), ``Block``/``HybridBlock``, losses, the
imperative ``Trainer``, ``utils``, the layers of ``gluon.nn`` and the
model zoo's ResNet family."""
from . import loss, model_zoo, nn, utils
from .block import Block, HybridBlock, SymbolBlock
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from .trainer import Trainer

__all__ = ["loss", "nn", "model_zoo", "utils", "Block", "HybridBlock",
           "SymbolBlock", "Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError", "Trainer"]
