"""``Predictor``: inference on an exported model, the reference's answer
to MXNet's ``c_predict_api``.

Port of ``mxnet_tpu/predictor.py``.  An exported ``-symbol.json`` and
``.params`` pair loads into a ``SymbolBlock`` on ``ctx`` (default the
current context, ``gpu(0)``; raises without CUDA) whose forward, at the
bound input shapes, is one ``_GraphProgram``: on the card the first
``run()`` is eager, the second captures a CUDA graph, and each run
after replays it (one replay a run); on the CPU each run is the forward.

    pred = Predictor("model-symbol.json", "model-0000.params",
                     {"data": (1, 3, 224, 224)})
    out = pred.forward(data=batch)[0]

Where the reference serializes the jitted forward as StableHLO
(``export_compiled``/``load_compiled``, ``jax.export``), which has no
CUDA counterpart, the port writes one self-contained file, the graph's
JSON, the input shapes and the weights in the ``.params`` container,
which ``load_compiled`` turns back into the same replayed forward
without the model's Python code.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np
import torch

from .base import MXNetError

__all__ = ["Predictor"]

# the self-contained file's own entries (beside arg:/aux: weights)
_SYMBOL_KEY = "__symbol_json__"
_INPUTS_KEY = "__input_shapes__"


def _text_array(text):
    from .ndarray import NDArray

    return NDArray(torch.frombuffer(bytearray(text.encode()),
                                    dtype=torch.uint8))


def _array_text(arr):
    return bytes(arr.asnumpy().astype(np.uint8)).decode()


class Predictor:
    """An exported pair loaded for inference: ``set_input``/``run``/
    ``get_output`` (MXNet's ``MXPredSetInput``/``Forward``/
    ``GetOutput``) and ``forward(**inputs)``."""

    def __init__(self, symbol_file: str, param_file: Optional[str],
                 input_shapes: Dict[str, tuple], ctx=None,
                 dtype="float32"):
        from . import symbol as sym_mod
        from .model import load_params_file

        ctx = self._resolve(ctx)
        sym = sym_mod.load(symbol_file)
        params = load_params_file(param_file, ctx=ctx) \
            if param_file is not None else ({}, {})
        self._setup(sym, params, input_shapes, ctx, dtype)

    @staticmethod
    def _resolve(ctx):
        from .context import current_context

        ctx = ctx if ctx is not None else current_context()
        ctx.torch_device()
        return ctx

    def _setup(self, sym, params, input_shapes, ctx, dtype):
        from .gluon.block import SymbolBlock

        self._ctx = ctx
        self._device = ctx.torch_device()
        self._sym = sym
        self._input_names = list(input_shapes.keys())
        self._input_shapes = {k: tuple(v) for k, v in input_shapes.items()}
        self._dtype = dtype
        self._arg_params, self._aux_params = params
        self._net = SymbolBlock(sym, self._input_names)
        self._net._load(self._arg_params, self._aux_params, ctx)
        self._inputs: Dict[str, torch.Tensor] = {}
        self._outputs: List = []
        self._prog = None
        self._static = None

    # -- the reference's API (MXPredSetInput / Forward / GetOutput) ---- #
    def set_input(self, name: str, data) -> None:
        from .ndarray import NDArray, array

        if name not in self._input_names:
            raise KeyError(f"unknown input {name!r}; have "
                           f"{self._input_names}")
        arr = data if isinstance(data, NDArray) else \
            array(np.asarray(data), ctx=self._ctx)
        if arr.shape != self._input_shapes[name]:
            raise MXNetError(f"input {name!r}: shape {arr.shape}, bound "
                             f"{self._input_shapes[name]}")
        self._inputs[name] = arr._data

    def _program(self):
        """The forward at the bound shapes as one ``_GraphProgram`` over
        static inputs (made at the first run, in its inputs' dtypes)."""
        from .gluon.block import _GraphProgram, _no_hybrid

        net = self._net
        self._static = [torch.empty_like(self._inputs[n].to(self._device))
                        for n in self._input_names]

        def fn():
            with _no_hybrid():
                out = net._run_nd(self._static, {}, False, False)
            return list(out) if isinstance(out, (list, tuple)) else [out]

        pool = torch.cuda.graph_pool_handle() \
            if self._device.type == "cuda" else None
        return _GraphProgram(fn, self._device, pool, self._static)

    def run(self) -> None:
        from . import autograd
        from .ndarray import NDArray

        missing = [n for n in self._input_names if n not in self._inputs]
        if missing:
            raise ValueError(f"inputs not set: {missing}")
        if self._prog is None:
            self._prog = self._program()
        for s, n in zip(self._static, self._input_names):
            s.copy_(self._inputs[n])
        with autograd.pause(train_mode=False):
            outs = self._prog()
        self._outputs = [NDArray(o) for o in outs]

    def get_output(self, index: int = 0):
        return self._outputs[index]

    @property
    def num_outputs(self) -> int:
        return len(self._outputs)

    @property
    def replays(self) -> int:
        """The CUDA-graph replays so far (0 on the CPU)."""
        return self._prog.replays if self._prog is not None else 0

    def forward(self, **inputs):
        for name, data in inputs.items():
            self.set_input(name, data)
        self.run()
        return list(self._outputs)

    # -- one self-contained file (the reference's StableHLO artifact) -- #
    def export_compiled(self, path: str) -> None:
        """Write the graph's JSON, the bound input shapes and the weights
        into one file (the ``.params`` container) that ``load_compiled``
        runs without the model's Python code."""
        from .ndarray import serialization

        payload = {f"arg:{k}": v for k, v in self._arg_params.items()}
        payload.update({f"aux:{k}": v for k, v in self._aux_params.items()})
        payload[_SYMBOL_KEY] = _text_array(self._sym.tojson())
        payload[_INPUTS_KEY] = _text_array(json.dumps(
            {"names": self._input_names,
             "shapes": [list(self._input_shapes[n])
                        for n in self._input_names],
             "dtype": str(self._dtype)}))
        serialization.save(path, payload)

    @staticmethod
    def load_compiled(path: str, ctx=None):
        """A callable running ``export_compiled``'s file: it takes the
        inputs positionally (numpy arrays or NDArrays) and returns the
        outputs (NDArrays) of the replayed forward."""
        from .model import load_params_file
        from .symbol import load_json

        ctx = Predictor._resolve(ctx)
        args, auxs = load_params_file(path, ctx=ctx)
        sym = load_json(_array_text(args.pop(_SYMBOL_KEY)))
        spec = json.loads(_array_text(args.pop(_INPUTS_KEY)))
        pred = Predictor.__new__(Predictor)
        pred._setup(sym, (args, auxs),
                    dict(zip(spec["names"], map(tuple, spec["shapes"]))),
                    ctx, spec["dtype"])

        def run(*xs):
            return pred.forward(**dict(zip(pred._input_names, xs)))

        run.predictor = pred
        return run
