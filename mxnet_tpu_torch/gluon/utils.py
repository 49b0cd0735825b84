"""Gluon utilities (port of ``mxnet_tpu/gluon/utils.py``):
``split_data``, ``split_and_load`` (one context: the port runs one
card), ``clip_global_norm``, ``check_sha1``, ``shape_is_known`` and
``download``, which only finds a file already on disk.
"""
from __future__ import annotations

import hashlib
import math
import os

from ..base import MXNetError
from ..ndarray.ndarray import NDArray, array
from ..ops.extended import global_norm_sq

__all__ = ["split_data", "split_and_load", "clip_global_norm",
           "check_sha1", "download", "shape_is_known"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``num_slice`` slices of ``data`` along ``batch_axis``; with
    ``even_split=False`` the first ``size % num_slice`` take one more."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise MXNetError(
            f"data with shape {data.shape} cannot be evenly split into "
            f"{num_slice} slices along axis {batch_axis}; set "
            "even_split=False")
    step, rest = divmod(size, num_slice)
    bounds, lo = [], 0
    for i in range(num_slice):
        hi = lo + step + (1 if i < rest else 0)
        bounds.append((lo, hi))
        lo = hi
    return [data.slice_axis(batch_axis, lo, hi) for lo, hi in bounds]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """The batch on the one context of ``ctx_list`` (reference
    ``split_and_load``); several contexts raise: the port runs one
    card."""
    if len(ctx_list) != 1:
        raise MXNetError(f"split_and_load over {len(ctx_list)} contexts: "
                         "the port runs one card; pass one context")
    if not isinstance(data, NDArray):
        data = array(data, ctx=ctx_list[0])
    return [data.as_in_context(ctx_list[0])]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Rescale ``arrays`` so their global L2 norm is at most
    ``max_norm``; returns the norm before (reference
    ``clip_global_norm``)."""
    if not arrays:
        raise MXNetError("clip_global_norm: empty array list")
    total = global_norm_sq([a._data for a in arrays])
    norm = math.sqrt(float(total))      # the one read back to the host
    if check_isfinite and not math.isfinite(norm):
        raise MXNetError(f"global norm is not finite ({norm}); gradients "
                         "diverged or contain nan")
    scale = max_norm / (norm + 1e-8)
    if scale < 1.0:
        for a in arrays:
            a *= scale
    return norm


def check_sha1(filename, sha1_hash):
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            sha1.update(chunk)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):
    """The file of ``url`` if it is already at ``path`` (or a file of the
    URL's name in that directory) with the right hash; anything else
    raises: this package makes no network request."""
    fname = url.split("/")[-1]
    if path:
        fname = os.path.join(path, fname) if os.path.isdir(path) else path
    if os.path.isfile(fname) and not overwrite and \
            (sha1_hash is None or check_sha1(fname, sha1_hash)):
        return fname
    raise MXNetError(f"download({url!r}): no network access; place the "
                     f"file at {fname!r}")


def shape_is_known(shape):
    if shape is None:
        return False
    return all(isinstance(d, int) and d > 0 for d in shape)
