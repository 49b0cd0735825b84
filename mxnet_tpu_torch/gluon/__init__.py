"""Gluon surface of the port: the parameter layer (``Parameter``,
``Constant``, ``ParameterDict``), ``Block``/``HybridBlock``, losses, the
imperative ``Trainer``, ``utils``, the layers of ``gluon.nn`` and the
model zoo's ResNet family, ``gluon.data`` and ``gluon.rnn``."""
from . import loss, model_zoo, nn, rnn, utils
from .block import Block, HybridBlock, SymbolBlock
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from .trainer import Trainer
from . import data

__all__ = ["data", "loss", "nn", "rnn", "model_zoo", "utils", "Block",
           "HybridBlock", "SymbolBlock", "Parameter", "Constant",
           "ParameterDict", "DeferredInitializationError", "Trainer"]
