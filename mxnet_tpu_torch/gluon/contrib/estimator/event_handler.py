"""Event handlers of the ``Estimator``, port of
``mxnet_tpu/gluon/contrib/estimator/event_handler.py``: the six event
mixins (train, epoch and batch, each begin and end) and the stock
handlers.  A handler's ``priority`` orders it among those of one event
(lower first; 0 when it has none).  ``AtomicCheckpointHandler`` saves
through the port's ``checkpoint.CheckpointManager``: the parameters,
the optimizer's states, the RNG state and the (epoch, batch) cursor in
``extra``; with ``resume=True`` it restores the newest verifiable
checkpoint at train begin, in place, and its counters go on from the
cursor.  A checkpoint the reference wrote resumes too (its RNG subtree
is skipped with a ``RuntimeWarning``).  The data stream is the caller's
to resume: ``DataLoader.iter_from(batches_done)`` starts an epoch at the
cursor."""
from __future__ import annotations

import logging
import os
import time

import numpy as onp

from ....base import MXNetError


class TrainBegin:
    def train_begin(self, estimator, *args, **kwargs):
        pass


class TrainEnd:
    def train_end(self, estimator, *args, **kwargs):
        pass


class EpochBegin:
    def epoch_begin(self, estimator, *args, **kwargs):
        pass


class EpochEnd:
    def epoch_end(self, estimator, *args, **kwargs):
        pass


class BatchBegin:
    def batch_begin(self, estimator, *args, **kwargs):
        pass


class BatchEnd:
    def batch_end(self, estimator, *args, **kwargs):
        pass


class StoppingHandler(TrainBegin, BatchEnd, EpochEnd):
    """Stop on max_epoch/max_batch (reference ``StoppingHandler``)."""

    def __init__(self, max_epoch=None, max_batch=None):
        self.max_epoch = max_epoch
        self.max_batch = max_batch
        self.current_batch = 0
        self.current_epoch = 0
        self.stop_training = False

    def train_begin(self, estimator, *args, **kwargs):
        self.current_batch = 0
        self.current_epoch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.max_batch and self.current_batch >= self.max_batch:
            self.stop_training = True

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.max_epoch and self.current_epoch >= self.max_epoch:
            self.stop_training = True


class MetricHandler(EpochBegin, BatchEnd):
    """Reset train metrics at epoch begin, update at batch end."""

    def __init__(self, metrics):
        self.metrics = metrics

    def epoch_begin(self, estimator, *args, **kwargs):
        for m in self.metrics:
            m.reset()

    def batch_end(self, estimator, *args, **kwargs):
        pred = kwargs.get("pred")
        label = kwargs.get("label")
        loss = kwargs.get("loss")
        for m in self.metrics:
            if getattr(m, "name", "").startswith("loss") and loss is not None:
                m.update(0, loss)
            elif pred is not None and label is not None:
                m.update(label, pred)


class ValidationHandler(TrainBegin, BatchEnd, EpochEnd):
    """Run validation every ``epoch_period`` epochs (reference
    ``ValidationHandler``)."""

    def __init__(self, val_data, eval_fn, epoch_period=1, batch_period=None,
                 priority=-1000):
        self.val_data = val_data
        self.eval_fn = eval_fn
        self.epoch_period = epoch_period
        self.batch_period = batch_period
        self.current_batch = 0
        self.current_epoch = 0
        self.priority = priority

    def train_begin(self, estimator, *args, **kwargs):
        self.current_batch = 0
        self.current_epoch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.batch_period and self.current_batch % self.batch_period == 0:
            self.eval_fn(self.val_data)

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.epoch_period and self.current_epoch % self.epoch_period == 0:
            self.eval_fn(self.val_data)


class LoggingHandler(TrainBegin, TrainEnd, EpochBegin, EpochEnd, BatchEnd):
    """Periodic metric logging (reference ``LoggingHandler``)."""

    def __init__(self, log_interval="epoch", metrics=None, priority=1000):
        if log_interval != "epoch" and not isinstance(log_interval, int):
            raise MXNetError("log_interval must be 'epoch' or int")
        self.log_interval = log_interval
        self.metrics = metrics or []
        self.batch_index = 0
        self.current_epoch = 0
        self.priority = priority
        self.logger = logging.getLogger("estimator")

    def train_begin(self, estimator, *args, **kwargs):
        self.train_start = time.time()
        self.logger.info("Training begin")

    def train_end(self, estimator, *args, **kwargs):
        self.logger.info("Training done in %.3fs",
                         time.time() - self.train_start)

    def epoch_begin(self, estimator, *args, **kwargs):
        self.epoch_start = time.time()
        self.batch_index = 0

    def epoch_end(self, estimator, *args, **kwargs):
        msgs = [f"{m.name}: {m.get()[1]:.4f}" for m in self.metrics]
        self.logger.info("Epoch[%d] time %.3fs %s", self.current_epoch,
                         time.time() - self.epoch_start, " ".join(msgs))
        self.current_epoch += 1

    def batch_end(self, estimator, *args, **kwargs):
        self.batch_index += 1
        if isinstance(self.log_interval, int) and \
                self.batch_index % self.log_interval == 0:
            msgs = [f"{m.name}: {m.get()[1]:.4f}" for m in self.metrics]
            self.logger.info("Epoch[%d] Batch[%d] %s", self.current_epoch,
                             self.batch_index, " ".join(msgs))


class CheckpointHandler(TrainBegin, BatchEnd, EpochEnd):
    """Save params (+trainer states) per epoch; keep best by monitored
    metric (reference ``CheckpointHandler``)."""

    def __init__(self, model_dir, model_prefix="model", monitor=None,
                 verbose=0, save_best=False, mode="auto", epoch_period=1,
                 batch_period=None, max_checkpoints=5,
                 resume_from_checkpoint=False):
        self.model_dir = model_dir
        self.model_prefix = model_prefix
        self.monitor = monitor
        self.save_best = save_best
        self.epoch_period = epoch_period
        self.batch_period = batch_period
        self.max_checkpoints = max_checkpoints
        self.current_epoch = 0
        self.current_batch = 0
        self.saved = []
        if mode == "auto" and monitor is not None:
            mode = "max" if "acc" in getattr(monitor, "name", "") else "min"
        self.mode = mode
        self.best = -onp.inf if mode == "max" else onp.inf

    def train_begin(self, estimator, *args, **kwargs):
        os.makedirs(self.model_dir, exist_ok=True)

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.batch_period and self.current_batch % self.batch_period == 0:
            self._save(estimator, f"batch{self.current_batch}")

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.epoch_period and self.current_epoch % self.epoch_period == 0:
            self._save(estimator, f"epoch{self.current_epoch}")
        if self.save_best and self.monitor is not None:
            _, val = self.monitor.get()
            better = val > self.best if self.mode == "max" else val < self.best
            if better:
                self.best = val
                estimator.net.save_parameters(os.path.join(
                    self.model_dir, f"{self.model_prefix}-best.params"))

    def _save(self, estimator, tag):
        path = os.path.join(self.model_dir,
                            f"{self.model_prefix}-{tag}.params")
        estimator.net.save_parameters(path)
        self.saved.append(path)
        while len(self.saved) > self.max_checkpoints:
            old = self.saved.pop(0)
            if os.path.isfile(old):
                os.remove(old)


class AtomicCheckpointHandler(TrainBegin, BatchEnd, EpochEnd, TrainEnd):
    """Periodic atomic checkpoints + auto-resume, wired to
    ``mx.checkpoint`` — the preemption-safe successor of
    :class:`CheckpointHandler`'s epoch-boundary ``.params`` pattern.

    Every save is commit-or-invisible (temp dir + fsync + rename, CRC
    manifest) and captures the FULL training state — params, optimizer
    states/schedule counters, loss-scaler, RNG root key — plus the
    (epoch, batch) cursor as checkpoint ``extra``.  With
    ``resume=True`` (default), ``fit()`` restores the newest verifiable
    checkpoint at train begin (corrupt/incomplete ones are skipped with
    a ``checkpoint_corrupt`` event) and the handler's own counters pick
    up from the restored cursor; ``resumed_step`` reports what was
    loaded (None = fresh start).  Saves are step-indexed by the global
    batch count.
    """

    def __init__(self, directory, every_n_batches=None, every_n_epochs=1,
                 max_to_keep=5, async_save=True, resume=True,
                 priority=9000):
        if not directory:
            raise MXNetError("AtomicCheckpointHandler: directory required")
        self.directory = directory
        self.every_n_batches = every_n_batches
        self.every_n_epochs = every_n_epochs
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self.resume = resume
        # run after the stock metric/logging handlers so a save sees
        # the batch fully applied
        self.priority = priority
        self.resumed_step = None
        self.current_batch = 0
        self.current_epoch = 0
        self._mgr = None

    def train_begin(self, estimator, *args, **kwargs):
        from .... import checkpoint as ckpt

        self._mgr = ckpt.CheckpointManager(
            self.directory, max_to_keep=self.max_to_keep,
            async_save=self.async_save)
        self.resumed_step = None
        self.current_batch = 0
        self.current_epoch = 0
        if not self.resume:
            return
        res = self._mgr.restore(estimator.net, estimator.trainer,
                                return_extra=True)
        if res is None:
            return
        step, extra = res
        self.resumed_step = step
        self.current_batch = int((extra or {}).get("batch", step))
        self.current_epoch = int((extra or {}).get("epoch", 0))

    def _save(self, estimator):
        self._mgr.save(self.current_batch, estimator.net,
                       estimator.trainer,
                       extra={"batch": self.current_batch,
                              "epoch": self.current_epoch})

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.every_n_batches and \
                self.current_batch % self.every_n_batches == 0:
            self._save(estimator)

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.every_n_epochs and \
                self.current_epoch % self.every_n_epochs == 0:
            self._save(estimator)

    def train_end(self, estimator, *args, **kwargs):
        if self._mgr is not None:
            self._mgr.wait_until_finished()
            self._mgr.close()
            self._mgr = None


class EarlyStoppingHandler(TrainBegin, EpochEnd, TrainEnd):
    """Stop when the monitored metric stalls (reference
    ``EarlyStoppingHandler``)."""

    def __init__(self, monitor, min_delta=0, patience=0, mode="auto",
                 baseline=None):
        self.monitor = monitor
        self.min_delta = min_delta
        self.patience = patience
        self.baseline = baseline
        if mode == "auto":
            mode = "max" if "acc" in getattr(monitor, "name", "") else "min"
        self.mode = mode
        self.wait = 0
        self.stopped_epoch = 0
        self.current_epoch = 0
        self.stop_training = False
        self.best = -onp.inf if self.mode == "max" else onp.inf

    def epoch_end(self, estimator, *args, **kwargs):
        _, val = self.monitor.get()
        improved = (val - self.min_delta > self.best) if self.mode == "max" \
            else (val + self.min_delta < self.best)
        if self.baseline is not None and not improved:
            improved = (val > self.baseline) if self.mode == "max" \
                else (val < self.baseline)
        if improved:
            self.best = val
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped_epoch = self.current_epoch
                self.stop_training = True
        self.current_epoch += 1

    def train_end(self, estimator, *args, **kwargs):
        if self.stopped_epoch > 0:
            logging.getLogger("estimator").info(
                "Early stopping at epoch %d", self.stopped_epoch)
