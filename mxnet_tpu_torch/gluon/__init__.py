"""Gluon surface of the port: the parameter layer (``Parameter``,
``Constant``, ``ParameterDict``), ``Block``/``HybridBlock``, losses, the
imperative ``Trainer``, ``utils``, the layers of ``gluon.nn`` and the
model zoo (all seven families), ``gluon.data``, ``gluon.rnn`` and
``gluon.contrib`` (the contrib layers and cells, the ``Estimator``)."""
from . import loss, model_zoo, nn, rnn, utils
from .block import Block, HybridBlock, SymbolBlock
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from .trainer import Trainer
from . import data
from . import contrib

__all__ = ["data", "contrib", "loss", "nn", "rnn", "model_zoo", "utils",
           "Block", "HybridBlock", "SymbolBlock", "Parameter", "Constant",
           "ParameterDict", "DeferredInitializationError", "Trainer"]
