"""``mx.engine`` — execution-engine controls, port of
``mxnet_tpu/engine.py``.

There is no user-visible dependency engine: PyTorch queues each op on the
card's current stream and returns.  The reference's control surface keeps
its meaning:

- ``set_bulk_size`` / ``bulk``: accepted and recorded; a CUDA graph (the
  fused step, a hybridized block) is the port's bulking, so the value is
  advisory, as in the reference.
- NaiveEngine: ``MXNET_ENGINE_TYPE=NaiveEngine`` (``base.
  is_naive_engine``) makes every ``mx.nd`` op synchronize the card after
  it runs (``ops.registry.invoke``), for bisecting asynchronous faults;
  never while a CUDA graph is being captured, where a synchronize would
  break the capture.
- ``wait_all``: ``torch.cuda.synchronize()`` (``WaitForAll``).
"""
from __future__ import annotations

import contextlib
import os

from .base import is_naive_engine

__all__ = ["set_bulk_size", "bulk", "engine_type", "is_naive_engine",
           "wait_all"]

_bulk_size = int(os.environ.get("MXNET_EXEC_BULK_EXEC_MAX_NODE_TRAIN", "15"))


def engine_type() -> str:
    """'NaiveEngine' (synchronous) or 'ThreadedEnginePerDevice' (the
    asynchronous default: PyTorch's stream queue)."""
    return "NaiveEngine" if is_naive_engine() else "ThreadedEnginePerDevice"


def set_bulk_size(size: int) -> int:
    """Reference ``mx.engine.set_bulk_size``: returns the previous value
    (advisory, see the module docstring)."""
    global _bulk_size
    prev = _bulk_size
    _bulk_size = int(size)
    return prev


@contextlib.contextmanager
def bulk(size: int):
    """``with mx.engine.bulk(16):`` — the reference's bulking scope."""
    prev = set_bulk_size(size)
    try:
        yield
    finally:
        set_bulk_size(prev)


def wait_all():
    """Block until all queued work on the card is complete."""
    from .ndarray import waitall
    waitall()


def naive_sync(tensors):
    """Under NaiveEngine, wait for the card after an op whose outputs
    include a CUDA tensor, unless the current stream is capturing a CUDA
    graph.  A no-op otherwise."""
    if not is_naive_engine():
        return
    import torch

    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            if not torch.cuda.is_current_stream_capturing():
                torch.cuda.synchronize(t.device)
            return
