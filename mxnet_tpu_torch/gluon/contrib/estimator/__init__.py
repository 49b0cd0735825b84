"""The ``Estimator`` fit loop and its event handlers
(``mxnet_tpu/gluon/contrib/estimator``)."""
from .estimator import Estimator
from .event_handler import (TrainBegin, TrainEnd, EpochBegin, EpochEnd,
                            BatchBegin, BatchEnd, StoppingHandler,
                            MetricHandler, ValidationHandler, LoggingHandler,
                            CheckpointHandler, AtomicCheckpointHandler,
                            EarlyStoppingHandler)
