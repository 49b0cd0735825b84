"""``Estimator``, port of
``mxnet_tpu/gluon/contrib/estimator/estimator.py``:
``est.fit(train_data, val_data, epochs, event_handlers)``, the fit loop
with its event handlers, and ``evaluate``.

The default context is the current one (``gpu(0)``; the estimator
raises without CUDA unless given or run under ``mx.cpu()``).  Each epoch
reads its batches through ``DevicePrefetchIter`` on the card (a ring of
batches whose copies overlap the steps), unless the loader places its
batches itself.  With ``fused_step=True`` and a hybridized net each
batch is one ``Trainer.fused_step``: forward, loss, backward and the
optimizer's apply as one CUDA-graph replay.  The metric handlers read
each batch's predictions and loss to the host, as the reference's do
(``metric.host_reads()`` counts them).
"""
from __future__ import annotations

import logging

from ....base import MXNetError
from ... import Trainer
from ... import loss as loss_mod
from .event_handler import (TrainBegin, TrainEnd, EpochBegin, EpochEnd,
                            BatchBegin, BatchEnd, StoppingHandler,
                            MetricHandler, LoggingHandler, ValidationHandler)


class Estimator:
    def __init__(self, net, loss, metrics=None, initializer=None,
                 trainer=None, context=None, device_prefetch=None,
                 fused_step=False):
        from .... import initializer as init_mod
        from ....context import current_context
        self.net = net
        if not isinstance(loss, loss_mod.Loss):
            raise MXNetError("loss must be a gluon Loss")
        self.loss = loss
        metrics = metrics or []
        self.train_metrics = metrics if isinstance(metrics, list) \
            else [metrics]
        self.context = context or current_context()
        self.context.torch_device()     # raises where there is no card
        self._device_prefetch = device_prefetch
        # with a hybridized net, fit() runs each batch through
        # Trainer.fused_step: one captured program in place of the
        # record/backward/step phases (MXNET_FUSED_STEP=0 runs those)
        self._fused_step = bool(fused_step)
        if not self._net_initialized():
            self.net.initialize(initializer or init_mod.Xavier(),
                                ctx=self.context)
        self.trainer = trainer or Trainer(net.collect_params(), "adam",
                                          {"learning_rate": 1e-3})
        self.val_metrics = [type(m)() for m in self.train_metrics]
        self.logger = logging.getLogger("estimator")

    def _net_initialized(self):
        for p in self.net.collect_params().values():
            if p._data is None and p._deferred_init is None:
                return False
        return True

    # ------------------------------------------------------------------ #
    def _prefetched(self, data):
        """One epoch's iterator over ``data``, through the device-prefetch
        ring when the estimator's context is the card: batch ``k+1``'s
        host load and copy overlap step ``k``.  ``iter(data)`` itself on
        the CPU, when the loader places its batches
        (``DataLoader(device=...)``), or under
        ``MXNET_DEVICE_PREFETCH=0``."""
        from ...data.dataloader import (DevicePrefetchIter,
                                        _resolve_device_prefetch)
        ctx = self.context
        if ctx is None or getattr(ctx, "device_type", "cpu").startswith("cpu"):
            return iter(data)
        if getattr(data, "_device", None) is not None:
            return iter(data)  # loader already device-aware
        depth = _resolve_device_prefetch(self._device_prefetch)
        if depth <= 0:
            return iter(data)
        return DevicePrefetchIter(iter(data), ctx, depth)

    def evaluate(self, val_data, batch_axis=0):
        for m in self.val_metrics:
            m.reset()
        for batch in self._prefetched(val_data):
            data, label = self._unpack(batch)
            pred = self.net(data)
            loss = self.loss(pred, label)
            for m in self.val_metrics:
                if getattr(m, "name", "").startswith("loss"):
                    m.update(0, loss)
                else:
                    m.update(label, pred)
        return [(m.name, m.get()[1]) for m in self.val_metrics]

    @staticmethod
    def _unpack(batch):
        if isinstance(batch, (list, tuple)) and len(batch) >= 2:
            return batch[0], batch[1]
        if hasattr(batch, "data"):
            return batch.data[0], batch.label[0]
        raise MXNetError("cannot unpack batch")

    def _sorted(self, handlers, kind):
        hs = [h for h in handlers if isinstance(h, kind)]
        return sorted(hs, key=lambda h: getattr(h, "priority", 0))

    def fit(self, train_data, val_data=None, epochs=None, event_handlers=None,
            batches=None, batch_axis=0):
        from .... import autograd
        if epochs is None and batches is None:
            raise MXNetError("fit: give epochs or batches")
        handlers = list(event_handlers or [])
        stopper = StoppingHandler(epochs, batches)
        handlers.append(stopper)
        if not any(isinstance(h, MetricHandler) for h in handlers):
            handlers.append(MetricHandler(self.train_metrics))
        if val_data is not None and not any(
                isinstance(h, ValidationHandler) for h in handlers):
            handlers.append(ValidationHandler(val_data, self.evaluate))
        if not any(isinstance(h, LoggingHandler) for h in handlers):
            handlers.append(LoggingHandler(metrics=self.train_metrics))

        use_fused = (self._fused_step
                     and getattr(self.net, "_active", False)
                     and hasattr(self.trainer, "fused_step"))

        def _fused_loss(x, y):
            pred = self.net(x)
            return self.loss(pred, y), pred

        train_begin = self._sorted(handlers, TrainBegin)
        epoch_begin = self._sorted(handlers, EpochBegin)
        batch_begin = self._sorted(handlers, BatchBegin)
        batch_end = self._sorted(handlers, BatchEnd)
        epoch_end = self._sorted(handlers, EpochEnd)
        train_end = self._sorted(handlers, TrainEnd)

        for h in train_begin:
            h.train_begin(self)
        while not stopper.stop_training:
            for h in epoch_begin:
                h.epoch_begin(self)
            for batch in self._prefetched(train_data):
                data, label = self._unpack(batch)
                for h in batch_begin:
                    h.batch_begin(self, batch=batch)
                if use_fused:
                    loss, pred = self.trainer.fused_step(
                        _fused_loss, data, label,
                        batch_size=data.shape[batch_axis])
                else:
                    with autograd.record():
                        pred = self.net(data)
                        loss = self.loss(pred, label)
                    loss.backward()
                    self.trainer.step(data.shape[batch_axis])
                for h in batch_end:
                    h.batch_end(self, batch=batch, pred=pred, label=label,
                                loss=loss)
                if stopper.stop_training:
                    break
            for h in epoch_end:
                h.epoch_end(self)
            if hasattr(train_data, "reset"):
                train_data.reset()
            for h in [x for x in handlers
                      if getattr(x, "stop_training", False)]:
                stopper.stop_training = True
        for h in train_end:
            h.train_end(self)
        return self
