"""``mx.contrib`` (reference ``python/mxnet/contrib/``): the
post-training quantization driver, and ``amp`` under the reference's
path ``mx.contrib.amp``."""
from . import quantization  # noqa: F401
from .. import amp  # noqa: F401
