"""``BaseModule``: the ``fit``/``score``/``predict`` epoch loops.

Port of ``mxnet_tpu/module/base_module.py`` (reference
``python/mxnet/module/base_module.py``): ``fit`` binds, initializes the
parameters and the optimizer, then runs ``forward_backward``,
``update``, ``update_metric`` and the batch-end callbacks a batch, the
epoch-end callbacks (``callback.do_checkpoint``) and an evaluation an
epoch.
"""
from __future__ import annotations

import logging
import time

from .. import metric as metric_mod
from ..base import MXNetError
from ..model import BatchEndParam


def _as_metric(m):
    if isinstance(m, metric_mod.EvalMetric):
        return m
    return metric_mod.create(m)


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


class BaseModule:
    """A module: subclasses implement ``bind``, ``init_params``,
    ``init_optimizer``, ``forward``, ``backward``, ``update``,
    ``get_outputs``, ``update_metric`` and ``get_params``."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.params_initialized = False
        self.optimizer_initialized = False

    # -- the abstract surface ----------------------------------------- #
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             **kwargs):
        raise NotImplementedError

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, **kwargs):
        raise NotImplementedError

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError

    def get_params(self):
        raise NotImplementedError

    # -- composite operations ----------------------------------------- #
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, reset=True, epoch=0):
        """Evaluate on a data iterator; ``[(name, value)]``."""
        if not self.binded or not self.params_initialized:
            raise MXNetError("score: module not bound/initialized")
        eval_metric = _as_metric(eval_metric)
        eval_metric.reset()
        if reset:
            eval_data.reset()
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch >= num_batch:
                break
            self.forward(batch, is_train=False)
            self.update_metric(eval_metric, batch.label)
            if batch_end_callback is not None:
                bp = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                   eval_metric=eval_metric, locals=locals())
                for cb in _as_list(batch_end_callback):
                    cb(bp)
        return eval_metric.get_name_value()

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True):
        """The forward over a data iterator, the outputs concatenated
        (a batch's padding dropped)."""
        from .. import ndarray as nd

        if reset:
            eval_data.reset()
        outputs = []
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch >= num_batch:
                break
            self.forward(batch, is_train=False)
            outs = self.get_outputs()
            if batch.pad:
                outs = [o[:o.shape[0] - batch.pad] for o in outs]
            outputs.append(outs)
        if not outputs:
            return []
        if merge_batches:
            n_out = len(outputs[0])
            merged = [nd.concat(*[b[i] for b in outputs], dim=0)
                      for i in range(n_out)]
            return merged[0] if n_out == 1 else merged
        return outputs

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, initializer=None, arg_params=None,
            aux_params=None, allow_missing=False, force_rebind=False,
            force_init=False, begin_epoch=0, num_epoch=None,
            validation_metric=None):
        """MXNet 1.x's training loop (reference ``BaseModule.fit``)."""
        if num_epoch is None:
            raise MXNetError("fit: num_epoch is required")
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        eval_metric = _as_metric(eval_metric)
        if validation_metric is None:
            validation_metric = eval_metric

        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            train_data.reset()
            for nbatch, data_batch in enumerate(train_data):
                self.forward_backward(data_batch)
                self.update()
                self.update_metric(eval_metric, data_batch.label)
                if batch_end_callback is not None:
                    bp = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                       eval_metric=eval_metric,
                                       locals=locals())
                    for cb in _as_list(batch_end_callback):
                        cb(bp)
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - tic)
            if epoch_end_callback is not None:
                arg_p, aux_p = self.get_params()
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, self.symbol, arg_p, aux_p)
            if eval_data is not None:
                res = self.score(eval_data, validation_metric,
                                 batch_end_callback=None, epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f",
                                     epoch, name, val)
                if eval_end_callback is not None:
                    bp = BatchEndParam(epoch=epoch, nbatch=0,
                                       eval_metric=validation_metric,
                                       locals=locals())
                    for cb in _as_list(eval_end_callback):
                        cb(bp)
