"""``Module``: a Symbol bound through one ``Executor``.

Port of ``mxnet_tpu/module/module.py`` (reference
``python/mxnet/module/module.py``): ``bind`` allocates through
``simple_bind`` (the parameters' shapes deduced from the data's),
``init_params``, ``init_optimizer`` (``rescale_grad`` 1/batch by
default; ``kvstore`` accepted and unused), ``forward``/``backward``, and
``update`` over every parameter at once through the optimizer's
``multi_update``, as the reference's does.  ``context=None`` is the
current context (``gpu(0)`` unless a ``with mx.cpu():`` scope says
otherwise) and raises without CUDA.
"""
from __future__ import annotations

import logging

from .. import initializer as init_mod
from .. import optimizer as opt_mod
from ..base import MXNetError
from ..model import load_checkpoint, save_checkpoint
from ..symbol.symbol import Executor, _context, infer_args
from .base_module import BaseModule


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging, context=None,
                 work_load_list=None, fixed_param_names=None,
                 state_names=None):
        super().__init__(logger=logger)
        if isinstance(context, (list, tuple)):
            if len(context) != 1:
                raise MXNetError("Module: the port runs one card; pass one "
                                 "context")
            context = context[0]
        self._context = _context(context)
        self._symbol = symbol
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._fixed_param_names = set(fixed_param_names or [])
        self._param_names = [n for n in symbol.list_arguments()
                             if n not in self._data_names
                             and n not in self._label_names]
        self._exec = None
        self._optimizer = None
        self._opt_states = {}
        self._data_shapes = None
        self._label_shapes = None

    @property
    def symbol(self):
        return self._symbol

    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return [(n, o.shape) for n, o in zip(self.output_names,
                                             self._exec.outputs)]

    # ------------------------------------------------------------------ #
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write", **kwargs):
        from .. import ndarray as nd

        if self.binded and not force_rebind:
            return
        self._data_shapes = [_as_desc(d) for d in data_shapes]
        self._label_shapes = [_as_desc(d) for d in (label_shapes or [])]
        shapes = {d[0]: tuple(d[1]) for d in self._data_shapes}
        shapes.update({d[0]: tuple(d[1]) for d in self._label_shapes})
        reqs = {}
        for n in self._symbol.list_arguments():
            if n in self._data_names:
                reqs[n] = "write" if inputs_need_grad else "null"
            elif n in self._label_names or n in self._fixed_param_names:
                reqs[n] = "null"
            else:
                reqs[n] = grad_req if for_training else "null"
        if shared_module is not None and shared_module._exec is not None:
            # bucketing: the default bucket's parameter arrays, shared
            all_shapes = infer_args(self._symbol, **shapes)
            args = {}
            for n in self._symbol.list_arguments():
                shared = shared_module._exec.arg_dict.get(n)
                if n in self._param_names and shared is not None:
                    args[n] = shared
                else:
                    args[n] = nd.zeros(all_shapes[n], ctx=self._context)
            self._exec = Executor(self._symbol, self._context, args, None,
                                  reqs)
        else:
            self._exec = self._symbol.simple_bind(ctx=self._context,
                                                  grad_req=reqs, **shapes)
        self.binded = True
        self.for_training = for_training

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, **kwargs):
        """Each parameter from ``arg_params`` (copied onto the module's
        device, in its dtype) or, if missing there, from ``initializer``
        (default ``Uniform(0.01)``)."""
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise MXNetError("init_params: call bind first")
        initializer = initializer or init_mod.Uniform(0.01)
        dev = self._context.torch_device()
        for n in self._param_names:
            arr = self._exec.arg_dict[n]
            if arg_params is not None and n in arg_params:
                src = arg_params[n]
                src = src._data if hasattr(src, "_data") else \
                    _host_tensor(src)
                arr._rebind(src.detach().to(dev, copy=True))
            else:
                if arg_params is not None and not allow_missing:
                    raise MXNetError(f"init_params: missing {n}")
                initializer(init_mod.InitDesc(n), arr)
        self.params_initialized = True

    def get_params(self):
        arg = {n: self._exec.arg_dict[n].copy() for n in self._param_names}
        return arg, {}

    def set_params(self, arg_params, aux_params=None, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(arg_params=arg_params, aux_params=aux_params,
                         allow_missing=allow_missing, force_init=force_init)

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """The optimizer (a name is created with ``optimizer_params``;
        ``rescale_grad`` defaults to 1/batch, the gradients being sums
        over the batch).  ``kvstore`` is accepted and unused."""
        if self.optimizer_initialized and not force_init:
            return
        if isinstance(optimizer, str):
            params = dict(optimizer_params)
            if "rescale_grad" not in params and self._data_shapes:
                batch = self._data_shapes[0][1][0]
                if batch:
                    params["rescale_grad"] = 1.0 / batch
            optimizer = opt_mod.create(optimizer, **params)
        self._optimizer = optimizer
        self._optimizer.param_idx2name = dict(enumerate(self._param_names))
        self._opt_states = {}
        self.optimizer_initialized = True

    # ------------------------------------------------------------------ #
    def forward(self, data_batch, is_train=None):
        if is_train is None:
            is_train = self.for_training
        feed = dict(zip(self._data_names, data_batch.data))
        if self._label_names and data_batch.label is not None:
            feed.update(zip(self._label_names, data_batch.label))
        self._exec.forward(is_train=is_train, **feed)

    def backward(self, out_grads=None):
        self._exec.backward(out_grads)

    def update(self):
        """Every parameter with a gradient through one
        ``Optimizer.multi_update``."""
        if self._optimizer is None:
            raise MXNetError("update: init_optimizer first")
        idxs, ws, gs, ss = [], [], [], []
        for i, n in enumerate(self._param_names):
            w = self._exec.arg_dict[n]
            g = w.grad
            if g is None:
                continue
            if i not in self._opt_states:
                self._opt_states[i] = \
                    self._optimizer.create_state_multi_precision(i, w._data)
            idxs.append(i)
            ws.append(w)
            gs.append(g)
            ss.append(self._opt_states[i])
        if not idxs:
            return
        new_states = self._optimizer.multi_update(idxs, ws, gs, ss)
        for i, ns in zip(idxs, new_states):
            self._opt_states[i] = ns

    def get_outputs(self, merge_multi_context=True):
        return list(self._exec.outputs)

    def get_input_grads(self, merge_multi_context=True):
        return [self._exec.arg_dict[n].grad for n in self._data_names]

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.get_outputs())

    # ------------------------------------------------------------------ #
    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        arg, aux = self.get_params()
        save_checkpoint(prefix, epoch, self._symbol, arg, aux)

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module over ``prefix-symbol.json`` whose ``init_params``
        takes ``prefix-%04d.params`` (read onto its context)."""
        ctx = kwargs.get("context")
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0]
        sym, arg, aux = load_checkpoint(prefix, epoch, ctx=_context(ctx))
        mod = Module(sym, **kwargs)
        _orig_init = mod.init_params

        def init_with_loaded(initializer=None, arg_params=None,
                             aux_params=None, **kw):
            _orig_init(initializer=initializer,
                       arg_params=arg_params or arg,
                       aux_params=aux_params or aux, **kw)
        mod.init_params = init_with_loaded
        return mod


def _host_tensor(a):
    import numpy as np
    import torch

    return torch.from_numpy(np.array(a, order="C"))


def _as_desc(d):
    """A ``DataDesc`` or a ``(name, shape)`` pair as ``(name, shape)``."""
    if hasattr(d, "name"):
        return (d.name, tuple(d.shape))
    return (d[0], tuple(d[1]))
