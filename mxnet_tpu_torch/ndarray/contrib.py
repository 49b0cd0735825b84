"""``mx.nd.contrib``: the reference's contrib-op namespace, friendly names
over the registered ``_contrib_*`` ops (counterpart of
``mxnet_tpu/ndarray/contrib.py``, the same eleven names)."""
from __future__ import annotations

from . import (BilinearResize2D, ROIAlign, all_finite, boolean_mask, box_nms,
               multi_all_finite)
from . import _contrib_dequantize as dequantize
from . import (_contrib_interleaved_matmul_selfatt_qk as
               interleaved_matmul_selfatt_qk)
from . import (_contrib_interleaved_matmul_selfatt_valatt as
               interleaved_matmul_selfatt_valatt)
from . import _contrib_quantize_v2 as quantize_v2
from . import _contrib_requantize as requantize

__all__ = ["boolean_mask", "quantize_v2", "dequantize", "requantize",
           "interleaved_matmul_selfatt_qk",
           "interleaved_matmul_selfatt_valatt", "BilinearResize2D",
           "ROIAlign", "box_nms", "all_finite", "multi_all_finite"]
