"""``mx.callback``: the training loop's callbacks.

Port of ``mxnet_tpu/callback.py`` (reference ``python/mxnet/callback.py``):
``Speedometer`` (samples/s every ``frequent`` batches: it reads the host
clock and the metric only then, so it adds no wait for the card to the
other batches), ``do_checkpoint`` (an epoch-end callback writing
``model.save_checkpoint``'s files), ``log_train_metric``,
``ProgressBar`` and ``LogValidationMetricsCallback``.
"""
from __future__ import annotations

import logging
import math
import time

__all__ = ["Speedometer", "do_checkpoint", "log_train_metric",
           "ProgressBar", "module_checkpoint", "LogValidationMetricsCallback"]


class Speedometer:
    """Log samples/s (and the metric, reset after if ``auto_reset``)
    every ``frequent`` batches."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.init = False
        self.tic = 0
        self.last_count = 0
        self.auto_reset = auto_reset

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count

        if self.init:
            if count % self.frequent == 0:
                speed = self.frequent * self.batch_size / (
                    time.time() - self.tic)
                msg = "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec"
                args = [param.epoch, count, speed]
                if param.eval_metric is not None:
                    name_value = param.eval_metric.get_name_value()
                    if self.auto_reset:
                        param.eval_metric.reset()
                    for name, value in name_value:
                        msg += "\t%s=%f"
                        args += [name, value]
                logging.info(msg, *args)
                self.tic = time.time()
        else:
            self.init = True
            self.tic = time.time()


def do_checkpoint(prefix, period=1):
    """An epoch-end callback writing ``prefix-symbol.json`` and
    ``prefix-%04d.params`` (epoch + 1) every ``period`` epochs."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            from .model import save_checkpoint
            save_checkpoint(prefix, iter_no + 1, sym, arg or {}, aux or {})
    return _callback


module_checkpoint = do_checkpoint


def log_train_metric(period, auto_reset=False):
    """A batch-end callback logging the metric every ``period`` batches."""
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            for name, value in param.eval_metric.get_name_value():
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()
    return _callback


class ProgressBar:
    """A text progress bar over ``total`` batches."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = math.ceil(100.0 * count / float(self.total))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        logging.info("[%s] %s%s\r", prog_bar, percents, "%")


class LogValidationMetricsCallback:
    def __call__(self, param):
        if param.eval_metric is None:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Epoch[%d] Validation-%s=%f",
                         param.epoch, name, value)
