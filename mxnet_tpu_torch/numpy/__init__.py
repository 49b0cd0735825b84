"""``mx.np`` package (reference ``python/mxnet/numpy/``): the NumPy
interface of the port, on torch tensors (``multiarray``), with
``extensions``, ``linalg`` and ``random``."""
from .multiarray import *  # noqa: F401,F403
from .multiarray import (ndarray, array, _coerce_arr, _run)  # noqa: F401
from .extensions import *  # noqa: F401,F403
from . import linalg  # noqa: F401
from . import random  # noqa: F401
