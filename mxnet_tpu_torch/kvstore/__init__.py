"""KVStore on one process: ``mx.kv.create(name)``.

Port of ``mxnet_tpu/kvstore/`` (reference ``python/mxnet/kvstore/``):
``init``/``push``/``pull``/``pushpull``/``broadcast``/
``row_sparse_pull`` over arrays keyed by int or str, ``set_updater``,
``set_optimizer`` (the optimizer runs inside the store at push time, as
on the reference's parameter server), optimizer-state save and load, and
``set_gradient_compression`` (2-bit and 1-bit with an error-feedback
residual a key).

The port runs one process on one card: a push sums the list of values
it is given, and ``dist_sync``/``dist_async`` run with one worker (rank
0 of 1), as the reference's do without ``jax.distributed``.  The
parameter server (``kvstore_server``) and stores of more than one worker
are not ported.
"""
from .kvstore import KVStore, create

__all__ = ["KVStore", "create"]
