"""Dynamic loss scaler, port of ``mxnet_tpu/amp/loss_scaler.py``
(reference ``contrib/amp/loss_scaler.py``: "x2 every 2000 steps, /2 on
an overflow detected by multi_all_finite")."""
from __future__ import annotations


class LossScaler:
    def __init__(self, init_scale=2.0 ** 16, scale_factor=2.0,
                 scale_window=2000):
        self.loss_scale = float(init_scale)
        self._scale_factor = scale_factor
        self._scale_window = scale_window
        self._unskipped = 0

    def has_overflow(self, params):
        """True if any parameter gradient is non-finite: one
        ``multi_all_finite`` over every gradient and one host read."""
        from .. import ndarray as nd
        grads = [p._data._grad_buffer() for p in params
                 if p.grad_req != "null" and p._data is not None
                 and p._data._grad is not None]
        if not grads:
            return False
        ok = nd.multi_all_finite(grads, num_arrays=len(grads))
        return float(ok.asnumpy()[0]) == 0.0

    def update_scale(self, overflow: bool):
        if overflow:
            self.loss_scale = max(self.loss_scale / self._scale_factor, 1.0)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self._scale_window:
                self.loss_scale *= self._scale_factor
                self._unskipped = 0
