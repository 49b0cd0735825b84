"""The ``mx.np`` / ``mx.np.linalg`` / ``mx.npx`` surface as a table of
calls on seeded NumPy inputs, shared by ``tests/test_torch_numpy.py``
(the port against the JAX package on the CPU) and ``chip_smoke.py``
phase 28.2 (the port on the card against the port on the CPU).  It
imports neither package: a case names its function by path and marks
the arguments that become arrays (``A``).

A case is ``(label, path, args, kwargs, cmp)``: ``path`` like
``"np.add"``, ``"np.linalg.svd"`` or ``"npx.relu"``; ``cmp`` says how
two results are compared: ``"close"`` (values to the tolerance, dtypes
equal), ``"sorted"`` (the values sorted), ``"recon"`` (a factorisation,
checked by reconstruction), ``"partition"`` (the partition property),
``"shape"`` (shape and dtype only).  ``size`` scales the arrays: 1 for
the CPU tests (24-element matrices), 8 on the card (a few thousand
elements).
"""
import math

import numpy as onp


class A:
    """An argument that becomes an array of the package under test."""

    def __init__(self, value):
        self.value = onp.asarray(value)


class Fn:
    """A per-package callable: ``Fn("sum")`` is ``jnp.sum`` for the JAX
    package and ``torch.sum`` for the port."""

    def __init__(self, name):
        self.name = name


def inputs(size=1, seed=0):
    rs = onp.random.RandomState(seed)
    r, c = 4 * size, 6 * size
    f = lambda *s: rs.standard_normal(s).astype(onp.float32)  # noqa: E731
    d = {}
    d["x"] = f(r, c)
    d["y"] = f(r, c)
    d["p"] = rs.uniform(0.5, 2.0, (r, c)).astype(onp.float32)
    # near 1: a product of every element stays finite at any size
    d["q"] = rs.uniform(0.95, 1.05, (r, c)).astype(onp.float32)
    d["u"] = rs.uniform(-0.9, 0.9, (r, c)).astype(onp.float32)
    d["g"] = rs.uniform(1.1, 3.0, (r, c)).astype(onp.float32)
    d["i"] = rs.randint(-5, 5, (r, c)).astype(onp.int32)
    d["j"] = rs.randint(1, 7, (r, c)).astype(onp.int32)
    d["b"] = rs.rand(r, c) > 0.5
    d["b2"] = rs.rand(r, c) > 0.5
    d["v"] = f(c)
    d["w"] = rs.uniform(0.5, 2.0, c).astype(onp.float32)
    d["sv"] = onp.sort(rs.choice(onp.arange(100 * size), c,
                                 replace=False)).astype(onp.float32)
    d["d"] = onp.arange(r * c, dtype=onp.float32)[rs.permutation(r * c)] \
        .reshape(r, c)          # distinct values (sorts, partitions)
    n = 4 * size
    m = rs.standard_normal((n, n)).astype(onp.float32)
    d["m"] = (m + n * onp.eye(n, dtype=onp.float32)).astype(onp.float32)
    d["spd"] = (m @ m.T + n * onp.eye(n, dtype=onp.float32)) \
        .astype(onp.float32)
    d["rect"] = f(n + 2, n)
    d["rhs"] = f(n, 2)
    d["x3"] = f(2, r, c)
    d["v3a"] = f(r, 3)
    d["v3b"] = f(r, 3)
    d["small"] = rs.randint(0, 6, 5 * size).astype(onp.int32)
    d["idx"] = rs.randint(0, c, (r, 2)).astype(onp.int32)
    d["nanx"] = d["x"].copy()
    d["nanx"][0, 1] = onp.nan
    d["nanx"][2, 3] = onp.nan
    d["poly"] = onp.asarray([1.0, -3.0, 2.0], dtype=onp.float32)
    return d


_UNARY_F = ["negative", "positive", "abs", "absolute", "fabs", "sign",
            "exp", "expm1", "exp2", "sqrt_p", "cbrt", "square",
            "reciprocal_p", "sin", "cos", "tan", "arcsin_u", "arccos_u",
            "arctan", "sinh", "cosh", "tanh", "arcsinh", "arccosh_g",
            "arctanh_u", "degrees", "radians", "rint", "fix", "floor",
            "ceil", "trunc", "round", "around", "isnan", "isinf",
            "isfinite", "isposinf", "isneginf", "conj", "real", "imag",
            "angle", "sinc", "i0", "nan_to_num", "log_p", "log2_p",
            "log10_p", "log1p_p", "deg2rad", "rad2deg", "signbit",
            "expm1x", "acos_u", "acosh_g", "asin_u", "asinh", "atan",
            "atanh_u", "conjugate", "spacing", "isreal", "iscomplex"]
_UNARY_I = ["negative", "abs", "sign", "square", "invert", "bitwise_not",
            "bitwise_invert", "floor", "rint", "sqrt_j", "sin",
            "logical_not"]
_BINARY_F = ["add", "subtract", "multiply", "divide", "true_divide",
             "floor_divide", "mod", "remainder", "fmod", "power_py",
             "float_power_py", "maximum", "minimum", "fmax", "fmin",
             "hypot", "arctan2", "logaddexp", "logaddexp2", "copysign",
             "nextafter", "equal", "not_equal", "less", "less_equal",
             "greater", "greater_equal", "atan2", "pow_py", "heaviside"]
_BINARY_I = ["add", "subtract", "multiply", "floor_divide", "mod",
             "remainder", "power_j", "maximum", "minimum", "equal",
             "bitwise_and", "bitwise_or", "bitwise_xor", "left_shift_j",
             "right_shift_j", "gcd", "lcm", "bitwise_left_shift_j",
             "bitwise_right_shift_j", "divide", "true_divide"]
_BINARY_B = ["logical_and", "logical_or", "logical_xor", "add",
             "multiply"]


def _split(name, default):
    """``"sqrt_p"`` -> ("sqrt", "p"): the input a name's case reads."""
    base, sep, arg = name.rpartition("_")
    if sep and arg in ("p", "u", "g", "j", "py"):
        return base, arg
    return name, default


def cases(size=1, seed=0):
    d = inputs(size, seed)
    x, y, v = A(d["x"]), A(d["y"]), A(d["v"])
    i, j, b = A(d["i"]), A(d["j"]), A(d["b"])
    out = []

    def add(label, path, *args, cmp="close", **kw):
        out.append((label, path, args, kw, cmp))

    for n in _UNARY_F:
        base, arg = _split(n, "x")
        add(f"{base}[f32]", f"np.{base}", A(d[arg]))
    for n in _UNARY_I:
        base, arg = _split(n, "i")
        add(f"{base}[int32]", f"np.{base}", A(d[arg]))
    add("isnan[nan]", "np.isnan", A(d["nanx"]))
    add("nan_to_num[nan]", "np.nan_to_num", A(d["nanx"]))
    add("abs[bool]", "np.abs", b)
    for n in _BINARY_F:
        base, arg = _split(n, "y")
        if arg == "py":
            add(f"{base}[f32,py]", f"np.{base}", A(d["p"]), 2.5)
        else:
            add(f"{base}[f32]", f"np.{base}", x, A(d[arg]))
    add("add[f32,scalar]", "np.add", x, 3)
    add("multiply[int32,float]", "np.multiply", i, 2.5)
    add("add[int32,f32]", "np.add", i, x)
    add("ldexp[f32]", "np.ldexp", x, A(d["j"]))
    for n in _BINARY_I:
        base, arg = _split(n, "i")
        rhs = A(d["j"]) if arg == "j" or base in (
            "floor_divide", "mod", "remainder", "divide", "true_divide",
            "gcd", "lcm") else i
        add(f"{base}[int32]", f"np.{base}", i, rhs)
    for n in _BINARY_B:
        add(f"{n}[bool]", f"np.{n}", b, A(d["b2"]))

    # reductions
    for n in ("sum", "prod", "mean", "nansum", "nanprod", "nanmean",
              "max", "min", "amax", "amin", "nanmax", "nanmin", "ptp",
              "std", "var", "argmax", "argmin", "cumsum", "cumprod",
              "median", "all", "any", "count_nonzero", "nanstd",
              "nanvar", "nanargmax", "nanargmin", "nancumsum",
              "nancumprod"):
        src = A(d["q"]) if n in ("prod", "nanprod", "cumprod",
                                 "nancumprod") else x
        add(f"{n}[f32]", f"np.{n}", src)
        if n not in ("count_nonzero",):
            add(f"{n}[f32,axis]", f"np.{n}", src, axis=1)
    for n in ("nansum", "nanmean", "nanmax", "nanmin", "nanstd", "nanvar",
              "nanargmax", "nanargmin", "nancumsum"):
        add(f"{n}[nan]", f"np.{n}", A(d["nanx"]))
    add("sum[f32,keepdims]", "np.sum", x, axis=(0, 1), keepdims=True)
    add("sum[int32]", "np.sum", i)
    add("sum[bool]", "np.sum", b)
    add("prod[int32]", "np.prod", A(d["j"][:2, :3]))
    add("mean[int32]", "np.mean", i, axis=0)
    add("max[int32]", "np.max", i, axis=1)
    add("cumsum[int32]", "np.cumsum", i, axis=0)
    add("argmax[int32]", "np.argmax", i)
    add("std[ddof]", "np.std", x, axis=0, ddof=1)
    add("median[int32]", "np.median", i)
    add("quantile", "np.quantile", x, 0.3, axis=1)
    add("percentile", "np.percentile", x, 75.0)
    add("nanpercentile", "np.nanpercentile", A(d["nanx"]), 40.0, axis=0)
    add("average", "np.average", x, axis=1, weights=A(d["w"]))
    add("average[none]", "np.average", x)
    add("all[bool]", "np.all", b, axis=0)
    add("any[bool]", "np.any", b, axis=1)
    add("count_nonzero[int32]", "np.count_nonzero", i, axis=0)

    # creation
    add("zeros", "np.zeros", (3, 4))
    add("ones[int32]", "np.ones", (2, 3), dtype="int32")
    add("full", "np.full", (2, 3), 7)
    add("full[float]", "np.full", (2, 3), 1.5)
    add("empty", "np.empty", (2, 2))
    add("zeros_like", "np.zeros_like", x)
    add("ones_like", "np.ones_like", i)
    add("full_like", "np.full_like", x, 2.0)
    add("empty_like", "np.empty_like", x)
    add("arange", "np.arange", 10)
    add("arange[float]", "np.arange", 0.5, 4.0, 0.5)
    add("linspace", "np.linspace", 0.0, 1.0, 7)
    add("linspace[noend]", "np.linspace", -2.0, 3.0, 6, endpoint=False)
    add("logspace", "np.logspace", 0.0, 2.0, 5)
    add("eye", "np.eye", 4, 5, 1)
    add("identity", "np.identity", 3)
    add("tri", "np.tri", 4, 5, 0)
    add("tril", "np.tril", x, -1)
    add("triu", "np.triu", x, 1)
    add("array", "np.array", d["x"])
    add("array[int64]", "np.array", d["i"].astype(onp.int64))
    add("asarray", "np.asarray", d["x"])
    add("meshgrid", "np.meshgrid", A(d["v"][:3]), A(d["w"][:4]))
    add("meshgrid[ij]", "np.meshgrid", A(d["v"][:3]), A(d["w"][:4]),
        indexing="ij")
    add("indices", "np.indices", (2, 3))
    add("geomspace", "np.geomspace", 1.0, 1000.0, 4)
    add("blackman", "np.blackman", 8)
    add("hamming", "np.hamming", 8)
    add("hanning", "np.hanning", 8)
    add("diag_indices", "np.diag_indices", 3)
    add("tril_indices", "np.tril_indices", 4)
    add("triu_indices", "np.triu_indices", 4, 1)
    add("diag_indices_from", "np.diag_indices_from", A(d["m"]))
    add("tril_indices_from", "np.tril_indices_from", A(d["m"]))
    add("triu_indices_from", "np.triu_indices_from", A(d["m"]), 1)
    add("mask_indices", "np.mask_indices", 4, "triu")

    # manipulation
    r, c = d["x"].shape
    add("reshape", "np.reshape", x, (c, r))
    add("transpose", "np.transpose", A(d["x3"]))
    add("transpose[axes]", "np.transpose", A(d["x3"]), (1, 0, 2))
    add("swapaxes", "np.swapaxes", A(d["x3"]), 0, 2)
    add("moveaxis", "np.moveaxis", A(d["x3"]), 0, -1)
    add("rollaxis", "np.rollaxis", A(d["x3"]), 2)
    add("expand_dims", "np.expand_dims", x, 1)
    add("squeeze", "np.squeeze", A(d["x"][:1]))
    add("ravel", "np.ravel", x)
    add("atleast_1d", "np.atleast_1d", A(onp.float32(3.0)))
    add("atleast_2d", "np.atleast_2d", v)
    add("atleast_3d", "np.atleast_3d", x)
    add("broadcast_to", "np.broadcast_to", v, (3, c))
    add("broadcast_arrays", "np.broadcast_arrays", v, A(d["x"][:, :1]))
    add("concatenate", "np.concatenate", [x, y], axis=0)
    add("concatenate[none]", "np.concatenate", [x, y], axis=None)
    add("concat", "np.concat", [x, y], axis=1)
    add("stack", "np.stack", [x, y], axis=1)
    add("vstack", "np.vstack", [x, y])
    add("hstack", "np.hstack", [x, y])
    add("dstack", "np.dstack", [x, y])
    add("column_stack", "np.column_stack", [v, A(d["w"])])
    add("row_stack", "np.row_stack", [x, y])
    add("split", "np.split", x, 2, axis=0)
    add("split[indices]", "np.split", x, [1, 3], axis=1)
    add("array_split", "np.array_split", x, 4, axis=1)
    add("hsplit", "np.hsplit", x, 2)
    add("vsplit", "np.vsplit", x, 2)
    add("dsplit", "np.dsplit", A(d["x3"].reshape(2, r, c // 2, 2)), 1)
    add("tile", "np.tile", v, (2, 2))
    add("repeat", "np.repeat", x, 2, axis=1)
    add("repeat[none]", "np.repeat", v, 3)
    add("roll", "np.roll", x, 2, axis=1)
    add("roll[none]", "np.roll", x, 3)
    add("flip", "np.flip", x, 0)
    add("flip[none]", "np.flip", x)
    add("fliplr", "np.fliplr", x)
    add("flipud", "np.flipud", x)
    add("rot90", "np.rot90", x, 1)
    add("pad", "np.pad", x, ((1, 2), (0, 1)))
    add("pad[edge]", "np.pad", x, 2, mode="edge")
    add("pad[reflect]", "np.pad", x, ((1, 1), (2, 2)), mode="reflect")
    add("delete", "np.delete", v, [1, 3])
    add("delete[axis]", "np.delete", x, 1, axis=1)
    add("insert", "np.insert", v, 2, 9.0)
    add("insert[neg]", "np.insert", v, -1, A(d["w"][:2]))
    add("insert[axis]", "np.insert", x, 1, A(d["x"][:, 0]), axis=1)
    add("insert[seq]", "np.insert", v, onp.asarray([1, 3]), A(d["w"][:2]))
    add("append", "np.append", v, A(d["w"]))
    add("append[axis]", "np.append", x, y, axis=0)
    add("where", "np.where", b, x, y)
    add("where[1]", "np.where", b)
    add("clip", "np.clip", x, -0.5, 0.5)
    add("diag", "np.diag", x, 1)
    add("diag[vec]", "np.diag", v)
    add("diagflat", "np.diagflat", A(d["v"][:3]))
    add("diagonal", "np.diagonal", x, 1)
    add("trace", "np.trace", x)
    add("trace[int32]", "np.trace", i)
    add("resize", "np.resize", v, (3, 5))
    add("copy", "np.copy", x)
    add("take", "np.take", x, A(d["idx"]))
    add("take[axis]", "np.take", x, A(d["idx"][:, 0]), axis=1)
    add("take_along_axis", "np.take_along_axis", x, A(d["idx"]), 1)
    add("put_along_axis", "np.put_along_axis", x, A(d["idx"][:, :1]),
        A(onp.float32(9.0)), 1)
    add("searchsorted", "np.searchsorted", A(d["sv"]), A(d["sv"] + 0.5))
    add("searchsorted[right]", "np.searchsorted", A(d["sv"]),
        A(d["sv"]), side="right")
    add("sort", "np.sort", x)
    add("sort[axis0]", "np.sort", x, axis=0)
    add("argsort", "np.argsort", A(d["d"]))
    add("lexsort", "np.lexsort", [A(d["i"][0]), A(d["j"][0])])
    add("unique", "np.unique", A(d["small"]))
    add("unique[all]", "np.unique", A(d["small"]), return_index=True,
        return_counts=True)
    add("nonzero", "np.nonzero", i)
    add("flatnonzero", "np.flatnonzero", i)
    add("argwhere", "np.argwhere", i)
    add("extract", "np.extract", b, x)
    add("compress", "np.compress", A(d["b"][:, 0]), x, axis=0)
    add("select", "np.select", [b, A(d["b2"])], [x, y], 0.0)
    add("choose", "np.choose", A(onp.abs(d["i"]) % 2), [x, y])
    add("fill_diagonal", "np.fill_diagonal", A(d["m"]), 5.0)
    add("partition", "np.partition", A(d["d"]), 2, cmp="partition")
    add("argpartition", "np.argpartition", A(d["d"]), 3, cmp="partition")
    add("matrix_transpose", "np.matrix_transpose", A(d["x3"]))
    add("permute_dims", "np.permute_dims", A(d["x3"]), (2, 0, 1))
    add("apply_along_axis", "np.apply_along_axis",
        lambda t: t * 2.0 + 1.0, 1, x)
    add("apply_along_axis[reduce]", "np.apply_along_axis",
        lambda t: (t * t).sum(), 0, x)
    add("apply_over_axes", "np.apply_over_axes", Fn("sum"), A(d["x3"]),
        [0, 2])
    add("ix_", "np.ix_", A(onp.asarray([0, 2])), A(onp.asarray([1, 3, 4])))
    add("block", "np.block", [[A(d["m"]), A(d["m"])], [A(d["m"]),
                                                       A(d["m"])]])
    add("put", "np.put", A(d["v"].copy()), A(onp.asarray([0, 2])),
        A(onp.asarray([9.0, 8.0], onp.float32)))
    add("unravel_index", "np.unravel_index", A(onp.asarray([1, 7, 11])),
        (3, 4))
    add("ravel_multi_index", "np.ravel_multi_index",
        [A(onp.asarray([1, 2])), A(onp.asarray([3, 0]))], (3, 4))

    # set operations and their kin
    s1, s2 = A(d["small"]), A(onp.asarray([1, 2, 9], onp.int32))
    for n in ("isin", "in1d", "intersect1d", "union1d", "setdiff1d",
              "setxor1d"):
        add(n, f"np.{n}", s1, s2)
    for n in ("unique_values", "unique_counts", "unique_inverse",
              "unique_all"):
        add(n, f"np.{n}", s1)

    # linear algebra (top level)
    add("dot", "np.dot", x, A(d["x"].T))
    add("dot[vec]", "np.dot", x, v)
    add("dot[int32]", "np.dot", i, A(d["i"].T))
    add("matmul", "np.matmul", x, A(d["y"].T))
    add("matmul[batch]", "np.matmul", A(d["x3"]),
        A(onp.swapaxes(d["x3"], 1, 2)))
    add("inner", "np.inner", x, y)
    add("outer", "np.outer", v, A(d["w"]))
    add("tensordot", "np.tensordot", A(d["x3"]), x, axes=([1, 2], [0, 1]))
    add("einsum", "np.einsum", "ij,kj->ik", x, y)
    add("kron", "np.kron", A(d["m"][:2, :2]), A(d["m"][:3, :3]))
    add("cross", "np.cross", A(d["v3a"]), A(d["v3b"]))
    add("vdot", "np.vdot", x, y)
    add("vecdot", "np.vecdot", x, y)
    add("interp", "np.interp", A(d["sv"] + 0.25), A(d["sv"]),
        A(d["w"]))
    add("diff", "np.diff", x)
    add("diff[axis]", "np.diff", x, 2, axis=0)
    add("ediff1d", "np.ediff1d", v)
    add("gradient", "np.gradient", v)
    add("gradient[2d]", "np.gradient", x)
    add("convolve", "np.convolve", v, A(d["w"][:3]))
    add("convolve[same]", "np.convolve", v, A(d["w"][:3]), mode="same")
    add("correlate", "np.correlate", v, A(d["w"][:3]))
    add("correlate[full]", "np.correlate", v, A(d["w"][:3]), mode="full")
    add("histogram", "np.histogram", x, bins=5)
    add("histogram2d", "np.histogram2d", v, A(d["w"]), bins=3)
    add("histogram_bin_edges", "np.histogram_bin_edges", x, bins=6)
    add("bincount", "np.bincount", A(d["small"]))
    add("bincount[weights]", "np.bincount", A(d["small"]),
        weights=A(d["p"].reshape(-1)[:d["small"].size]))
    add("digitize", "np.digitize", x, A(onp.asarray([-1.0, 0.0, 1.0],
                                                    onp.float32)))
    add("isclose", "np.isclose", x, A(d["x"] + 1e-7))
    add("allclose", "np.allclose", x, A(d["x"] + 1e-7))
    add("array_equal", "np.array_equal", x, x)
    add("array_equiv", "np.array_equiv", v, A(onp.tile(d["v"], (2, 1))))
    add("corrcoef", "np.corrcoef", x)
    add("cov", "np.cov", x)
    add("trapz", "np.trapz", x)
    add("trapezoid", "np.trapezoid", v)
    add("polyval", "np.polyval", A(d["poly"]), v)
    add("poly", "np.poly", A(onp.asarray([1.0, 2.0], onp.float32)))
    add("roots", "np.roots", A(d["poly"]), cmp="sorted")
    add("polyadd", "np.polyadd", A(d["poly"]), A(d["poly"][:2]))
    add("polysub", "np.polysub", A(d["poly"]), A(d["poly"][:2]))
    add("polymul", "np.polymul", A(d["poly"]), A(d["poly"][:2]))
    add("polyder", "np.polyder", A(d["poly"]))
    add("polyint", "np.polyint", A(d["poly"]))
    add("vander", "np.vander", A(d["w"][:4]))
    add("unwrap", "np.unwrap", A(onp.cumsum(onp.abs(d["v"]) * 3)
                                 .astype(onp.float32)))
    add("sort_complex", "np.sort_complex", A(d["d"][0]))
    add("trim_zeros", "np.trim_zeros", A(onp.asarray([0, 0, 1.5, 2, 0],
                                                     onp.float32)))
    add("divmod", "np.divmod", x, A(d["p"]))
    add("modf", "np.modf", x)
    add("frexp", "np.frexp", A(d["p"] * 10))
    add("bitwise_count", "np.bitwise_count", A(onp.abs(d["i"])))
    add("astype", "np.astype", x, "int32")

    # introspection (host values)
    add("shape", "np.shape", x)
    add("ndim", "np.ndim", x)
    add("size", "np.size", x)
    add("result_type", "np.result_type", i, x)
    add("result_type[scalar]", "np.result_type", x, 2)
    add("can_cast", "np.can_cast", onp.int32, onp.float32)
    add("promote_types", "np.promote_types", onp.int8, onp.float32)
    add("broadcast_shapes", "np.broadcast_shapes", (4, 1), (1, 6))
    add("issubdtype", "np.issubdtype", onp.float32, onp.floating)
    add("isdtype", "np.isdtype", onp.dtype(onp.float32), "real floating")
    add("isscalar", "np.isscalar", 3.0)
    add("iterable", "np.iterable", [1, 2])
    add("isrealobj", "np.isrealobj", x)
    add("iscomplexobj", "np.iscomplexobj", x)
    add("may_share_memory", "np.may_share_memory", x, y)
    add("shares_memory", "np.shares_memory", x, y)
    add("share_memory", "np.share_memory", x, y)
    add("finfo", "np.finfo", onp.float32)
    add("iinfo", "np.iinfo", onp.int32)

    # np.linalg
    m, spd, rect = A(d["m"]), A(d["spd"]), A(d["rect"])
    la = "np.linalg."
    add("linalg.norm", la + "norm", x)
    add("linalg.norm[axis]", la + "norm", x, axis=1)
    add("linalg.norm[ord]", la + "norm", m, ord=1)
    add("linalg.svd", la + "svd", rect, cmp="recon")
    add("linalg.svd[vals]", la + "svd", rect, compute_uv=False)
    add("linalg.cholesky", la + "cholesky", spd)
    add("linalg.qr", la + "qr", rect, cmp="recon")
    add("linalg.inv", la + "inv", m)
    add("linalg.pinv", la + "pinv", rect)
    add("linalg.det", la + "det", m)
    add("linalg.slogdet", la + "slogdet", m)
    add("linalg.solve", la + "solve", m, A(d["rhs"]))
    add("linalg.lstsq", la + "lstsq", rect, A(d["rect"][:, :2]),
        cmp="recon")
    add("linalg.eig", la + "eig", spd, cmp="recon")
    add("linalg.eigh", la + "eigh", spd, cmp="recon")
    add("linalg.eigvals", la + "eigvals", spd, cmp="sorted")
    add("linalg.eigvalsh", la + "eigvalsh", spd)
    add("linalg.matrix_rank", la + "matrix_rank", rect)
    add("linalg.matrix_power", la + "matrix_power", m, 3)
    add("linalg.multi_dot", la + "multi_dot", [m, m, m])
    add("linalg.tensorinv", la + "tensorinv",
        A(d["spd"].reshape(d["spd"].shape[0], 2, -1)), ind=1)
    add("linalg.tensorsolve", la + "tensorsolve", m, A(d["rhs"][:, 0]))
    add("linalg.cond", la + "cond", m)
    add("linalg.cross", la + "cross", A(d["v3a"]), A(d["v3b"]))
    add("linalg.diagonal", la + "diagonal", A(d["x3"]))
    add("linalg.matmul", la + "matmul", m, spd)
    add("linalg.outer", la + "outer", v, A(d["w"]))
    add("linalg.trace", la + "trace", A(d["x3"]))
    add("linalg.tensordot", la + "tensordot", m, spd, axes=1)
    add("linalg.vecdot", la + "vecdot", x, y)
    add("linalg.svdvals", la + "svdvals", rect)
    add("linalg.matrix_norm", la + "matrix_norm", m)
    add("linalg.vector_norm", la + "vector_norm", x, ord=3)
    add("linalg.matrix_transpose", la + "matrix_transpose", A(d["x3"]))

    # npx
    out.extend(npx_cases(d))
    return out


def npx_cases(d):
    x = A(d["x"])
    r, c = d["x"].shape
    rs = onp.random.RandomState(7)
    f = lambda *s: rs.standard_normal(s).astype(onp.float32)  # noqa: E731
    out = []

    def add(label, path, *args, cmp="close", **kw):
        out.append((label, path, args, kw, cmp))

    gam, bet = A(d["w"]), A(d["v"])
    add("npx.relu", "npx.relu", x)
    add("npx.sigmoid", "npx.sigmoid", x)
    add("npx.gelu", "npx.gelu", x)
    add("npx.leaky_relu", "npx.leaky_relu", x, 0.1)
    add("npx.activation", "npx.activation", x, act_type="tanh")
    add("npx.softmax", "npx.softmax", x)
    add("npx.log_softmax", "npx.log_softmax", x, axis=0)
    add("npx.masked_softmax", "npx.masked_softmax", x, A(d["b"]))
    add("npx.masked_log_softmax", "npx.masked_log_softmax", x,
        A(d["b"] | onp.eye(r, c, dtype=bool)))
    add("npx.fully_connected", "npx.fully_connected", x, A(f(5, c)),
        A(f(5)), num_hidden=5)
    add("npx.convolution", "npx.convolution", A(f(2, 3, 8, 8)),
        A(f(4, 3, 3, 3)), A(f(4)), kernel=(3, 3), num_filter=4, pad=(1, 1))
    add("npx.pooling", "npx.pooling", A(f(2, 3, 8, 8)), kernel=(2, 2),
        stride=(2, 2))
    add("npx.batch_norm", "npx.batch_norm", A(f(2, c, 5)), gam, bet,
        A(onp.zeros(c, onp.float32)), A(onp.ones(c, onp.float32)),
        use_global_stats=True)
    add("npx.layer_norm", "npx.layer_norm", x, gam, bet)
    add("npx.group_norm", "npx.group_norm", A(f(2, c, 5)), gam, bet,
        num_groups=2)
    add("npx.instance_norm", "npx.instance_norm", A(f(2, c, 5)), gam, bet)
    add("npx.rms_norm", "npx.rms_norm", x, gam)
    add("npx.dropout[predict]", "npx.dropout", x, p=0.3, mode="always",
        cmp="shape")
    add("npx.embedding", "npx.embedding", A(d["small"]), A(f(8, 4)))
    add("npx.one_hot", "npx.one_hot", A(d["small"]), 8)
    add("npx.pick", "npx.pick", x, A(d["idx"][:, 0]), axis=1)
    add("npx.topk", "npx.topk", A(d["d"]), k=2)
    add("npx.topk[value]", "npx.topk", A(d["d"]), k=3, ret_typ="value")
    add("npx.reshape_like", "npx.reshape_like", x, A(d["x"].T))
    add("npx.arange_like", "npx.arange_like", x, 1.0, 0.5)
    add("npx.gamma", "npx.gamma", A(d["p"]))
    add("npx.erf", "npx.erf", x)
    add("npx.erfinv", "npx.erfinv", A(d["u"]))
    add("npx.batch_dot", "npx.batch_dot", A(d["x3"]),
        A(onp.swapaxes(d["x3"], 1, 2)))
    add("npx.broadcast_like", "npx.broadcast_like", A(d["v"][None]), x)
    add("npx.sequence_mask", "npx.sequence_mask", A(f(5, 3, 2)),
        A(onp.asarray([2, 5, 1], onp.float32)), use_sequence_length=True)
    add("npx.smooth_l1", "npx.smooth_l1", x, 1.0)
    add("npx.gather_nd", "npx.gather_nd", x,
        A(onp.asarray([[0, 1, 2], [1, 0, 3]], onp.int32)))
    add("npx.scatter_nd", "npx.scatter_nd", A(onp.asarray(
        [1.0, 2.0, 3.0], onp.float32)), A(onp.asarray(
            [[0, 1, 2], [1, 0, 3]], onp.int32)), (3, 4))
    add("npx.slice", "npx.slice", x, (1, 0), (3, 4))
    add("npx.slice_axis", "npx.slice_axis", x, 1, 1, 4)
    add("npx.stop_gradient", "npx.stop_gradient", x)
    add("npx.index_update", "npx.index_update", x,
        (A(onp.asarray([0, 2])), A(onp.asarray([1, 3]))),
        A(onp.asarray([9.0, 8.0], onp.float32)))
    add("npx.index_add", "npx.index_add", x,
        (A(onp.asarray([0, 0])), A(onp.asarray([1, 1]))),
        A(onp.asarray([9.0, 8.0], onp.float32)))
    return out


def _resolve(pkg, path):
    obj = pkg
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def convert(arg, make, fn_of):
    """``arg`` with every ``A`` made an array by ``make`` and every
    ``Fn`` resolved by ``fn_of``."""
    if isinstance(arg, A):
        return make(arg.value)
    if isinstance(arg, Fn):
        return fn_of(arg.name)
    if isinstance(arg, list):
        return [convert(a, make, fn_of) for a in arg]
    if isinstance(arg, tuple):
        return tuple(convert(a, make, fn_of) for a in arg)
    return arg


def call(pkg, case, make, fn_of):
    label, path, args, kw, cmp = case
    fn = _resolve(pkg, path)
    return fn(*convert(args, make, fn_of),
              **{k: convert(v, make, fn_of) for k, v in kw.items()})


def flatten(out, host):
    """A call's result as a list of ``(kind, value, dtype name, shape)``:
    arrays through ``host`` (to NumPy, with their dtype's name); numbers,
    booleans, dtypes and tuples of ints as themselves."""
    if isinstance(out, (list, tuple)) and not (
            isinstance(out, tuple) and all(isinstance(o, int)
                                           for o in out)):
        return [item for o in out for item in flatten(o, host)]
    arr = host(out)
    if arr is not None:
        return [("array",) + arr]
    if isinstance(out, (bool, int, float, onp.bool_, onp.number)):
        return [("scalar", float(out), type(out).__name__, ())]
    if isinstance(out, onp.dtype) or isinstance(out, type):
        return [("dtype", str(onp.dtype(out)), "", ())]
    if isinstance(out, tuple):
        return [("tuple", tuple(out), "", ())]
    return [("object", repr(type(out).__name__), "", ())]


def _sorted(a):
    a = onp.asarray(a).reshape(-1)
    if onp.iscomplexobj(a):
        return a[onp.lexsort((a.imag, a.real))]
    return onp.sort(a)


def recon_error(path, args, outs):
    """Largest error of a factorisation ``outs`` (NumPy arrays) of the
    case's NumPy arguments ``args``, relative to the input's largest
    magnitude."""
    a = onp.asarray(args[0], onp.float64)
    scale = max(float(onp.abs(a).max()), 1e-30)
    name = path.rsplit(".", 1)[1]
    if name == "svd":
        u, s, vh = outs
        return float(onp.abs((u * s) @ vh - a).max()) / scale
    if name == "qr":
        q, r = outs
        return float(onp.abs(q @ r - a).max()) / scale
    if name in ("eig", "eigh"):
        w, v = outs
        return float(onp.abs(a @ v - v * w).max()) / scale
    if name == "lstsq":
        x = outs[0]
        b = onp.asarray(args[1], onp.float64)
        # the normal equations of a full-rank least-squares solution
        return float(onp.abs(a.T @ (a @ x - b)).max()) / (scale * scale)
    raise KeyError(path)


def partition_ok(path, arg, out, kth):
    """The partition property of ``out`` (values, or indices into
    ``arg``) along the last axis, at ``kth``."""
    vals = onp.take_along_axis(arg, out.astype(onp.int64), -1) \
        if path.endswith("argpartition") else out
    piv = vals[..., kth:kth + 1]
    return bool((vals[..., :kth] <= piv).all() and
                (vals[..., kth + 1:] >= piv).all() and
                (onp.sort(vals, -1) == onp.sort(arg, -1)).all())


def numpy_args(case):
    """The case's positional arguments with arrays as NumPy."""
    return convert(case[2], lambda v: v, lambda n: None)


def compare(case, ref, got, tol):
    """``(ok, worst error, message)`` of two ``flatten``ed results under
    the case's ``cmp``; arrays of integers and booleans must be equal,
    floats within ``tol`` of the reference's largest magnitude."""
    label, path, args, kw, cmp = case
    if cmp == "recon":
        a_np = numpy_args(case)
        errs = []
        for items in (ref, got):
            outs = [onp.asarray(it[1], onp.float64) if not onp.iscomplexobj(
                it[1]) else onp.asarray(it[1], onp.complex128)
                for it in items if it[0] == "array"]
            errs.append(recon_error(path, a_np, outs))
        dts = [[it[2] for it in items] for items in (ref, got)]
        ok = errs[1] <= max(tol, 4 * errs[0]) and dts[0] == dts[1]
        return ok, errs[1], f"recon error {errs[1]:.3g} (ref {errs[0]:.3g})" \
            f", dtypes {dts[1]} vs {dts[0]}"
    if len(ref) != len(got):
        return False, None, f"{len(got)} outputs vs {len(ref)}"
    worst = 0.0
    for (k1, v1, d1, s1), (k2, v2, d2, s2) in zip(ref, got):
        if k1 != k2:
            return False, None, f"kind {k2} vs {k1}"
        if k1 in ("dtype", "tuple", "object"):
            if v1 != v2:
                return False, None, f"{v2!r} vs {v1!r}"
            continue
        if k1 == "scalar":
            if abs(v1 - v2) > tol * max(abs(v1), 1.0) and not (
                    v1 != v1 and v2 != v2):
                return False, None, f"{v2} vs {v1}"
            continue
        if tuple(s1) != tuple(s2):
            return False, None, f"shape {tuple(s2)} vs {tuple(s1)}"
        if d1 != d2:
            return False, None, f"dtype {d2} vs {d1}"
        if cmp == "shape":
            continue
        a, b = onp.asarray(v1), onp.asarray(v2)
        if cmp == "partition":
            kth = args[1]
            src = onp.asarray(args[0].value)
            if not (partition_ok(path, src, b.reshape(s2), kth) and
                    partition_ok(path, src, a.reshape(s1), kth)):
                return False, None, "partition property"
            continue
        if cmp == "sorted":
            a, b = _sorted(a), _sorted(b)
        if a.dtype.kind in "biu":
            if not onp.array_equal(a.reshape(-1), b.reshape(-1)):
                return False, None, "integer values differ"
            continue
        a = a.astype(onp.complex128 if a.dtype.kind == "c" else onp.float64)
        b = b.astype(a.dtype)
        if a.size == 0:
            continue
        nan_a, nan_b = onp.isnan(a), onp.isnan(b)
        if not onp.array_equal(nan_a, nan_b):
            return False, None, "NaN positions differ"
        fin = ~nan_a
        if not fin.any():
            continue
        inf_a = onp.isinf(a) & fin
        if not onp.array_equal(a[inf_a], b[inf_a]):
            return False, None, "infinities differ"
        fin &= ~inf_a
        if not fin.any():
            continue
        scale = max(float(onp.abs(a[fin]).max()), 1e-30)
        err = float(onp.abs(a[fin] - b[fin]).max()) / scale
        worst = max(worst, err)
        if err > tol:
            return False, err, f"error {err:.3g} of the largest magnitude"
    return True, worst, ""


def moments_ok(a, mean, var, lo=-math.inf, hi=math.inf):
    """``(ok, message)``: draws ``a`` finite, inside ``[lo, hi]``, their
    mean and variance within 6 standard errors of ``mean`` and ``var``
    (the variance's from the sample's fourth moment)."""
    a = onp.asarray(a, onp.float64).reshape(-1)
    if not onp.isfinite(a).all():
        return False, "not finite"
    if not ((a >= lo).all() and (a <= hi).all()):
        return False, f"outside [{lo}, {hi}]: {a.min()} .. {a.max()}"
    se = math.sqrt(var / a.size)
    if abs(a.mean() - mean) > 6 * se:
        return False, f"mean {a.mean()} vs {mean} (se {se})"
    if var > 0:
        m4 = ((a - a.mean()) ** 4).mean()
        se_v = math.sqrt(max(m4 - var * var, 1e-12) / a.size)
        if abs(a.var() - var) > 6 * se_v:
            return False, f"variance {a.var()} vs {var} (se {se_v})"
    return True, ""


def random_cases(N):
    """``mx.np.random``'s draws with their moments: ``(name, draw(r),
    mean, variance, low, high, dtype)``, ``r`` the package's
    ``np.random``."""
    return [

    ("uniform", lambda r: r.uniform(-1.0, 3.0, size=N), 1.0, 16 / 12,
     -1.0, 3.0, "float32"),
    ("normal", lambda r: r.normal(1.0, 2.0, size=N), 1.0, 4.0,
     -math.inf, math.inf, "float32"),
    ("standard_normal", lambda r: r.standard_normal(size=N), 0.0, 1.0,
     -math.inf, math.inf, "float32"),
    ("randn", lambda r: r.randn(N), 0.0, 1.0, -math.inf, math.inf,
     "float32"),
    ("rand", lambda r: r.rand(N), 0.5, 1 / 12, 0.0, 1.0, "float32"),
    ("randint", lambda r: r.randint(2, 9, size=N), 5.0, (49 - 1) / 12,
     2, 8, "int32"),
    ("gamma", lambda r: r.gamma(2.5, 2.0, size=N), 5.0, 10.0, 0.0,
     math.inf, "float32"),
    ("beta", lambda r: r.beta(2.0, 3.0, size=N), 0.4, 0.04, 0.0, 1.0,
     "float32"),
    ("exponential", lambda r: r.exponential(2.0, size=N), 2.0, 4.0, 0.0,
     math.inf, "float32"),
    ("poisson", lambda r: r.poisson(3.5, size=N), 3.5, 3.5, 0, math.inf,
     "int32"),
    ("binomial", lambda r: r.binomial(10, 0.3, size=N), 3.0, 2.1, 0, 10,
     "float32"),
    ("lognormal", lambda r: r.lognormal(0.0, 0.5, size=N),
     math.exp(0.125), (math.exp(0.25) - 1) * math.exp(0.25), 0.0,
     math.inf, "float32"),
    ("laplace", lambda r: r.laplace(1.0, 2.0, size=N), 1.0, 8.0,
     -math.inf, math.inf, "float32"),
    ("gumbel", lambda r: r.gumbel(0.5, 2.0, size=N),
     0.5 + 2.0 * 0.5772156649, math.pi ** 2 / 6 * 4, -math.inf, math.inf,
     "float32"),
    ("logistic", lambda r: r.logistic(1.0, 0.5, size=N), 1.0,
     math.pi ** 2 / 3 * 0.25, -math.inf, math.inf, "float32"),
    ("chisquare", lambda r: r.chisquare(4.0, size=N), 4.0, 8.0, 0.0,
     math.inf, "float32"),
    ("pareto", lambda r: r.pareto(5.0, size=N), 0.25, 5 / (16 * 3), 0.0,
     math.inf, "float32"),
    ("power", lambda r: r.power(3.0, size=N), 0.75, 3 / 80, 0.0, 1.0,
     "float32"),
    ("rayleigh", lambda r: r.rayleigh(2.0, size=N), 2.0 * math.sqrt(
        math.pi / 2), (4 - math.pi) / 2 * 4, 0.0, math.inf, "float32"),
    ("weibull", lambda r: r.weibull(2.0, size=N), math.sqrt(math.pi) / 2,
     1 - math.pi / 4, 0.0, math.inf, "float32"),
    ("geometric", lambda r: r.geometric(0.25, size=N), 4.0, 12.0, 1,
     math.inf, "int32"),
    ("negative_binomial", lambda r: r.negative_binomial(3, 0.5, size=N),
     3.0, 6.0, 0, math.inf, "int32"),
    ("f", lambda r: r.f(5.0, 10.0, size=N), 1.25, 2 * 100 * 13 / (
        5 * 64 * 6), 0.0, math.inf, "float32"),
    ]
