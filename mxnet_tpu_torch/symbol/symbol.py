"""Symbol: the symbolic graph.

Port of ``mxnet_tpu/symbol/symbol.py``.  A node names an op of the one
registry that serves ``mx.nd`` (``ops/registry.py``), so executing a
graph walks it through ``registry.invoke``: autograd, the profiler and
NaiveEngine hooks, amp's casts and the port's kernels (K1-K3 through
``flash_attention`` nodes, K6 through ``Convolution`` nodes) apply as
they do in imperative code.

- ``Symbol`` (output heads over the node DAG), ``Variable``/``var``,
  ``Group``, composition ``net(data=other)``, arithmetic, indexing,
  ``get_internals``, ``list_arguments``/``list_outputs``/
  ``list_auxiliary_states``, ``list_attr``/``attr_dict``.
- ``infer_shape``, ``infer_shape_partial``, ``infer_type``: the graph run
  on ``meta`` tensors (shapes and dtypes, no data), where the reference
  runs ``jax.eval_shape``; ``infer_args`` deduces the parameters' shapes
  from the data's by the reference's per-op rules.
- ``tojson``/``save``/``load``/``load_json`` in the reference's JSON
  (``nodes``, ``arg_nodes``, ``node_row_ptr``, ``heads``, ``attrs``),
  attribute values that JSON cannot hold written as their ``repr``, so
  each package loads the other's files.
- ``bind``/``simple_bind`` -> ``Executor`` (``forward``, ``backward``,
  ``copy_params_from``, ``grad_req``) on a context: ``ctx=None`` is the
  current context, ``gpu(0)`` unless a ``with mx.cpu():`` scope says
  otherwise, and raises without CUDA.
- ``capture``: while active on a thread, every ``invoke`` records one
  node (``HybridBlock.export`` obtains its graph so).  Values are keyed
  by the identity of their tensor, where the reference keys them by the
  ``id`` of the JAX array.

As in the reference, the auxiliary states are functional: a BatchNorm's
running statistics are arguments (``arg:`` entries of an exported
``.params`` file) and ``list_auxiliary_states()`` is empty.
"""
from __future__ import annotations

import inspect
import json
import threading
from collections import OrderedDict

import numpy as np
import torch

from ..base import MXNetError
from ..ops import registry as _registry

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "Executor", "capture", "current_capture"]

_JSON_TYPES = (str, int, float, bool, type(None))


def _jsonable(v):
    if isinstance(v, _JSON_TYPES):
        return True
    if isinstance(v, (list, tuple)):
        return all(_jsonable(x) for x in v)
    if isinstance(v, dict):
        return all(isinstance(k, str) and _jsonable(x) for k, x in v.items())
    return False


class _Node:
    """One graph node; ``op is None`` is a variable (the "null" op)."""

    __slots__ = ("op", "name", "inputs", "attrs", "num_outputs")

    def __init__(self, op, name, inputs=(), attrs=None, num_outputs=None):
        self.op = op
        self.name = name
        self.inputs = list(inputs)  # [(node, out_idx)]
        self.attrs = dict(attrs or {})
        self.num_outputs = num_outputs  # known after a run if not before

    def __repr__(self):
        return f"<Node {self.op or 'var'} {self.name}>"


_name_lock = threading.Lock()
_name_counter: dict = {}


def _auto_name(hint):
    with _name_lock:
        n = _name_counter.get(hint, 0)
        _name_counter[hint] = n + 1
    return f"{hint}{n}"


def _topo(heads):
    """The nodes reaching ``heads``, in topological order."""
    order, seen = [], set()

    def visit(node):
        if id(node) in seen:
            return
        seen.add(id(node))
        for inp, _ in node.inputs:
            visit(inp)
        order.append(node)

    for node, _ in heads:
        visit(node)
    return order


class Symbol:
    """A set of output heads over the node DAG."""

    def __init__(self, heads):
        self._heads = list(heads)

    # -- construction ------------------------------------------------- #
    @property
    def name(self):
        return self._heads[0][0].name

    def __repr__(self):
        return f"<Symbol {' '.join(n.name for n, _ in self._heads)}>"

    def __iter__(self):
        for head in self._heads:
            yield Symbol([head])

    def __getitem__(self, i):
        if isinstance(i, str):
            names = self.list_outputs()
            if i not in names:
                raise MXNetError(f"no output named {i}")
            i = names.index(i)
        if isinstance(i, int):
            if i >= len(self._heads):
                raise MXNetError("output index out of range")
            return Symbol([self._heads[i]])
        raise MXNetError("Symbol index must be int or str")

    def __len__(self):
        return len(self._heads)

    @property
    def num_outputs(self):
        return len(self._heads)

    # -- introspection ------------------------------------------------ #
    def list_arguments(self):
        return [n.name for n in _topo(self._heads) if n.op is None]

    def list_inputs(self):
        return self.list_arguments()

    def list_outputs(self):
        out = []
        for node, idx in self._heads:
            out.append(f"{node.name}_output{idx}"
                       if (node.num_outputs or 1) > 1
                       else f"{node.name}_output" if node.op else node.name)
        return out

    def list_auxiliary_states(self):
        return []  # functional auxiliary state, as in the reference

    def get_internals(self):
        return Symbol([(node, 0) for node in _topo(self._heads)])

    def attr(self, key):
        return self._heads[0][0].attrs.get(key)

    def list_attr(self, recursive=False):
        """The ``__key__`` user attributes of the head node (of every
        node with ``recursive``, as ``name_key``), reference
        ``Symbol.list_attr``."""
        out = {}
        nodes = _topo(self._heads) if recursive else [self._heads[0][0]]
        for node in nodes:
            for k, v in node.attrs.items():
                if k.startswith("__") and k.endswith("__"):
                    key = k[2:-2]
                    out[f"{node.name}_{key}" if recursive else key] = v
        return out

    def attr_dict(self):
        """``{node name: its user attributes}`` (reference ``attr_dict``)."""
        out = {}
        for node in _topo(self._heads):
            attrs = {k[2:-2]: v for k, v in node.attrs.items()
                     if k.startswith("__") and k.endswith("__")}
            if attrs:
                out[node.name] = attrs
        return out

    # -- composition -------------------------------------------------- #
    def __call__(self, *args, **kwargs):
        """Substitute variables: ``net(data=other_sym)``."""
        if args:
            for a, nm in zip(args, self.list_arguments()):
                kwargs.setdefault(nm, a)
        for k, v in kwargs.items():
            if not isinstance(v, Symbol):
                raise MXNetError(f"composition arg {k} must be a Symbol")
        mapping = {}

        def clone(node):
            """-> (replacement node, forced output index or None)."""
            if id(node) in mapping:
                return mapping[id(node)]
            if node.op is None and node.name in kwargs:
                # a substituted variable takes the replacement head's node
                # and output index (it may select one of several outputs)
                ent = kwargs[node.name]._heads[0]
                mapping[id(node)] = ent
                return ent
            inputs = []
            for i, idx in node.inputs:
                r, ridx = clone(i)
                inputs.append((r, ridx if ridx is not None else idx))
            new = _Node(node.op, node.name, inputs, node.attrs,
                        node.num_outputs)
            mapping[id(node)] = (new, None)
            return new, None

        heads = []
        for n, i in self._heads:
            r, ridx = clone(n)
            heads.append((r, ridx if ridx is not None else i))
        return Symbol(heads)

    # -- serialization ------------------------------------------------ #
    def tojson(self, remove_amp_cast=True):
        nodes = _topo(self._heads)
        nid = {id(n): i for i, n in enumerate(nodes)}
        jnodes = []
        for n in nodes:
            jnodes.append({
                "op": "null" if n.op is None else n.op,
                "name": n.name,
                "attrs": {k: v if _jsonable(v) else repr(v)
                          for k, v in n.attrs.items()},
                "inputs": [[nid[id(i)], idx, 0] for i, idx in n.inputs],
                **({"num_outputs": n.num_outputs}
                   if n.num_outputs and n.num_outputs > 1 else {}),
            })
        graph = {
            "nodes": jnodes,
            "arg_nodes": [i for i, n in enumerate(nodes) if n.op is None],
            "node_row_ptr": list(range(len(nodes) + 1)),
            "heads": [[nid[id(n)], idx, 0] for n, idx in self._heads],
            "attrs": {"mxnet_version": ["str", "mxnet_tpu_torch-0.1"]},
        }
        return json.dumps(graph, indent=2)

    def save(self, fname, remove_amp_cast=True):
        with open(fname, "w") as f:
            f.write(self.tojson(remove_amp_cast=remove_amp_cast))

    # -- shape and type inference ------------------------------------- #
    def infer_shape(self, *args, **kwargs):
        return self._infer(*args, **kwargs)

    def infer_shape_partial(self, *args, **kwargs):
        try:
            return self._infer(*args, **kwargs)
        except Exception:
            return None, None, None

    def infer_type(self, *args, **kwargs):
        arg_names = self.list_arguments()
        dtypes = dict(zip(arg_names, args))
        dtypes.update(kwargs)
        types = {nm: _np_dtype(_torch_dtype(dtypes.get(nm, "float32")))
                 for nm in arg_names}
        outs = _abstract_eval(self._heads,
                              {nm: ((1,), types[nm]) for nm in arg_names})
        return ([types[nm] for nm in arg_names],
                [_np_dtype(o.dtype) for o in outs], [])

    def _infer(self, *args, **kwargs):
        arg_names = self.list_arguments()
        shapes = dict(zip(arg_names, args))
        shapes.update(kwargs)
        missing = [nm for nm in arg_names if shapes.get(nm) is None]
        if missing:
            raise MXNetError(f"infer_shape: missing shapes for {missing}")
        outs = _abstract_eval(
            self._heads,
            {nm: (tuple(shapes[nm]), np.float32) for nm in arg_names})
        return ([tuple(shapes[nm]) for nm in arg_names],
                [tuple(o.shape) for o in outs], [])

    # -- execution ---------------------------------------------------- #
    def eval(self, ctx=None, **kwargs):
        """Run the graph on ``name=array`` bindings; a list of NDArrays."""
        return _execute(self._heads, kwargs, ctx)

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, **kwargs):
        return Executor(self, ctx, args, args_grad, grad_req)

    def simple_bind(self, ctx=None, grad_req="write", **shapes):
        """Allocate every argument (f32 zeros on ``ctx``) and bind; the
        parameters' shapes are deduced from the data's (``infer_args``)."""
        from ..ndarray import zeros

        ctx = _context(ctx)
        arg_names = self.list_arguments()
        all_shapes = shapes if all(nm in shapes for nm in arg_names) \
            else infer_args(self, **shapes)
        args = {nm: zeros(all_shapes[nm], ctx=ctx) for nm in arg_names}
        return Executor(self, ctx, args, None, grad_req)

    # -- operators ---------------------------------------------------- #
    def _binary(self, other, opname, swap=False):
        if isinstance(other, Symbol):
            a, b = (other, self) if swap else (self, other)
            return _invoke_builder(opname, [a, b], {})
        # a scalar becomes full_like (the graph stays shape-polymorphic)
        const = _invoke_builder("full_like", [self], {"fill_value": other})
        a, b = (const, self) if swap else (self, const)
        return _invoke_builder(opname, [a, b], {})

    def __add__(self, o):
        return self._binary(o, "broadcast_add")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary(o, "broadcast_sub")

    def __rsub__(self, o):
        return self._binary(o, "broadcast_sub", swap=True)

    def __mul__(self, o):
        return self._binary(o, "broadcast_mul")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary(o, "broadcast_div")

    def __rtruediv__(self, o):
        return self._binary(o, "broadcast_div", swap=True)

    def __pow__(self, o):
        return self._binary(o, "broadcast_power")

    def __neg__(self):
        return _invoke_builder("negative", [self], {})

    # -- the NDArray methods the reference mirrors --------------------- #
    def reshape(self, shape):
        return _invoke_builder("reshape", [self], {"shape": tuple(shape)})

    def transpose(self, axes=None):
        return _invoke_builder("transpose", [self],
                               {"axes": tuple(axes)} if axes else {})

    def astype(self, dtype):
        return _invoke_builder("cast", [self], {"dtype": str(dtype)})

    def sum(self, axis=None, keepdims=False):
        return _invoke_builder("sum", [self],
                               {"axis": axis, "keepdims": keepdims})

    def mean(self, axis=None, keepdims=False):
        return _invoke_builder("mean", [self],
                               {"axis": axis, "keepdims": keepdims})


def Variable(name, shape=None, dtype=None, **kwargs):
    attrs = {}
    if shape is not None:
        attrs["__shape__"] = tuple(shape)
    if dtype is not None:
        attrs["__dtype__"] = str(dtype)
    return Symbol([(_Node(None, name, attrs=attrs), 0)])


var = Variable


def Group(symbols):
    heads = []
    for s in symbols:
        heads.extend(s._heads)
    return Symbol(heads)


def load_json(s: str) -> Symbol:
    graph = json.loads(s)
    nodes = []
    for jn in graph["nodes"]:
        op = None if jn["op"] == "null" else jn["op"]
        nodes.append(_Node(op, jn["name"],
                           [(nodes[i], idx) for i, idx, _ in jn["inputs"]],
                           jn.get("attrs", {}), jn.get("num_outputs")))
    return Symbol([(nodes[i], idx) for i, idx, _ in graph["heads"]])


def load(fname: str) -> Symbol:
    with open(fname) as f:
        return load_json(f.read())


# --------------------------------------------------------------------- #
# graph walking
# --------------------------------------------------------------------- #

def _context(ctx):
    """``ctx``, or the current context (``gpu(0)`` by default); its
    device is resolved here, so a missing card raises at once."""
    from ..context import current_context

    ctx = ctx if ctx is not None else current_context()
    ctx.torch_device()
    return ctx


def _node_attrs(node):
    """A node's op parameters: user ``__key__`` attributes left out, JSON
    lists back to tuples."""
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in node.attrs.items() if not k.startswith("__")}


def _outputs(node, res):
    outs = list(res) if isinstance(res, (list, tuple)) else [res]
    node.num_outputs = len(outs)
    return outs


def _execute(heads, feed, ctx=None):
    """Run the graph through ``invoke`` (autograd-aware) on ``feed``:
    ``name -> NDArray`` (or anything ``nd.array`` takes, placed on
    ``ctx``) for every variable."""
    from ..ndarray import NDArray, array

    memo = {}
    for node in _topo(heads):
        if node.op is None:
            if node.name not in feed:
                raise MXNetError(f"unbound variable {node.name}")
            val = feed[node.name]
            if not isinstance(val, NDArray):
                val = array(val, ctx=ctx)
            memo[id(node)] = [val]
        else:
            ins = [memo[id(i)][idx] for i, idx in node.inputs]
            opref = _registry.get_op(node.op)
            memo[id(node)] = _outputs(
                node, _registry.invoke(opref, ins, _node_attrs(node)))
    return [memo[id(node)][idx] for node, idx in heads]


def _np_dtype(dt):
    """A torch dtype as numpy's (bfloat16, which numpy lacks, by its
    name)."""
    return "bfloat16" if dt == torch.bfloat16 else \
        torch.empty((), dtype=dt).numpy().dtype


def _torch_dtype(dt):
    from ..base import torch_dtype

    return torch_dtype(dt if isinstance(dt, str) else str(np.dtype(dt)))


def _meta_run(node, ins):
    """One node's implementation on meta tensors: the shapes and dtypes
    of its outputs, no data and no device.  Deliberately not through
    ``invoke``: no profiler, engine or capture hook sees it."""
    opref = _registry.get_op(node.op)
    with torch.no_grad():
        return _outputs(node, opref.fn(*ins, **_node_attrs(node)))


def _abstract_eval(heads, structs):
    """The graph on ``meta`` tensors (the reference's ``jax.eval_shape``
    pass): ``structs`` maps each variable to ``(shape, dtype)``."""
    memo = {}
    for node in _topo(heads):
        if node.op is None:
            shape, dt = structs[node.name]
            memo[id(node)] = [torch.empty(tuple(shape), device="meta",
                                          dtype=_torch_dtype(dt))]
        else:
            memo[id(node)] = _meta_run(
                node, [memo[id(i)][idx] for i, idx in node.inputs])
    return [memo[id(n)][i] for n, i in heads]


# --------------------------------------------------------------------- #
# the parameters' shapes from the data's (the reference's InferShape
# pass with its per-op rules), each node's outputs from a meta run
# --------------------------------------------------------------------- #

def _rule_fc(in_shapes, attrs):
    d = in_shapes[0]
    nh = int(attrs.get("num_hidden", 0))
    in_units = int(np.prod(d[1:])) if attrs.get("flatten", True) else d[-1]
    out = {1: (nh, in_units)}
    if len(in_shapes) > 2:
        out[2] = (nh,)
    return out


def _rule_conv(in_shapes, attrs):
    """The weight (num_filter, C / num_group) + kernel, C at the layout's
    channel axis (the reference's rule reads axis 1 whatever the layout,
    and so deduces a wrong weight for an NHWC convolution)."""
    d = in_shapes[0]
    layout = attrs.get("layout") or "NC"
    nf = int(attrs.get("num_filter", 0))
    kernel = tuple(attrs.get("kernel", ()))
    ng = int(attrs.get("num_group", 1))
    out = {1: (nf, d[layout.index("C")] // ng) + kernel}
    if len(in_shapes) > 2:
        out[2] = (nf,)
    return out


def _rule_channel(in_shapes, attrs):
    c = in_shapes[0][int(attrs.get("axis", 1))]
    return {i: (c,) for i in range(1, len(in_shapes))}


def _rule_lastdim(in_shapes, attrs):
    c = in_shapes[0][-1]
    return {i: (c,) for i in range(1, len(in_shapes))}


def _rule_embedding(in_shapes, attrs):
    return {1: (int(attrs["input_dim"]), int(attrs["output_dim"]))}


_PARAM_SHAPE_RULES = {
    "FullyConnected": _rule_fc,
    "Convolution": _rule_conv,
    "_BatchNormStats": _rule_channel,
    "InstanceNorm": lambda s, a: {i: (s[0][1],) for i in range(1, len(s))},
    "GroupNorm": lambda s, a: {i: (s[0][1],) for i in range(1, len(s))},
    "LayerNorm": _rule_lastdim,
    "RMSNorm": _rule_lastdim,
    "Embedding": _rule_embedding,
}


def infer_args(symbol, dtype="float32", **known_shapes):
    """Every argument's shape from the data's and label's (and the
    variables' ``shape=``): an OrderedDict over ``list_arguments()``."""
    known = {k: tuple(v) for k, v in known_shapes.items()}
    shapes = {}   # id(node) -> [output shapes]
    arg_shapes = OrderedDict()
    for node in _topo(symbol._heads):
        if node.op is None:
            shp = known.get(node.name) or node.attrs.get("__shape__")
            shp = tuple(shp) if shp is not None else None
            shapes[id(node)] = [shp]
            arg_shapes[node.name] = shp
            continue
        in_shapes, unknown = [], []
        for pos, (inp, idx) in enumerate(node.inputs):
            s = shapes[id(inp)][idx]
            in_shapes.append(s)
            if s is None:
                unknown.append(pos)
        if unknown:
            rule = _PARAM_SHAPE_RULES.get(node.op)
            if rule is None or in_shapes[0] is None:
                raise MXNetError(
                    f"infer_args: cannot deduce shapes of inputs {unknown} "
                    f"of op {node.op} ({node.name}); provide them explicitly")
            deduced = rule(in_shapes, node.attrs)
            for pos in unknown:
                if pos not in deduced:
                    raise MXNetError(
                        f"infer_args: op {node.op} rule left input {pos} "
                        f"unknown")
                in_shapes[pos] = deduced[pos]
                var_node = node.inputs[pos][0]
                shapes[id(var_node)] = [in_shapes[pos]]
                if var_node.op is None:
                    arg_shapes[var_node.name] = in_shapes[pos]
        metas = [torch.empty(s, device="meta", dtype=_torch_dtype(dtype))
                 for s in in_shapes]
        shapes[id(node)] = [tuple(o.shape) for o in _meta_run(node, metas)]
    missing = [k for k, v in arg_shapes.items() if v is None]
    if missing:
        raise MXNetError(f"infer_args: unresolved arguments {missing}")
    return arg_shapes


# --------------------------------------------------------------------- #
# Executor (the reference's GraphExecutor): bound arguments, forward,
# backward
# --------------------------------------------------------------------- #

class Executor:
    """A graph bound to arrays on ``ctx`` (default the current context,
    ``gpu(0)`` unless a ``with mx.cpu():`` scope says otherwise; raises
    without CUDA).  Arrays given as NDArrays are bound as they are (a
    Module's buckets share them); others are copied onto ``ctx``."""

    def __init__(self, symbol, ctx=None, args=None, args_grad=None,
                 grad_req="write"):
        from ..ndarray import NDArray, array

        self._symbol = symbol
        self._ctx = _context(ctx)
        arg_names = symbol.list_arguments()
        if isinstance(args, (list, tuple)):
            args = dict(zip(arg_names, args))
        self.arg_dict = OrderedDict()
        for nm in arg_names:
            if args is None or nm not in args:
                raise MXNetError(f"bind: missing argument {nm}")
            v = args[nm]
            self.arg_dict[nm] = v if isinstance(v, NDArray) \
                else array(v, ctx=self._ctx)
        if isinstance(grad_req, str):
            grad_req = {nm: grad_req for nm in arg_names}
        self._grad_req = grad_req
        if isinstance(args_grad, (list, tuple)):
            args_grad = dict(zip(arg_names, args_grad))
        self._args_grad = args_grad
        for nm, arr in self.arg_dict.items():
            req = grad_req.get(nm, "null")
            if req != "null":
                arr.attach_grad(req)
        self.aux_dict = OrderedDict()
        self.outputs = []

    @property
    def grad_dict(self):
        return OrderedDict((nm, arr.grad) for nm, arr in self.arg_dict.items()
                           if self._grad_req.get(nm, "null") != "null")

    @property
    def grad_arrays(self):
        return [self.arg_dict[nm].grad
                if self._grad_req.get(nm, "null") != "null" else None
                for nm in self._symbol.list_arguments()]

    @property
    def arg_arrays(self):
        return list(self.arg_dict.values())

    def _placed(self, v):
        """``v`` as an NDArray on the executor's device."""
        from ..ndarray import NDArray, array

        if isinstance(v, NDArray):
            dev = self._ctx.torch_device()
            return v if v._data.device == dev else NDArray(v._data.to(dev))
        return array(v, ctx=self._ctx)

    def forward(self, is_train=False, **kwargs):
        from .. import autograd

        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError(f"forward: unknown argument {k}")
            self.arg_dict[k]._rebind(self._placed(v)._data)
        needs_grad = any(r != "null" for r in self._grad_req.values())
        scope = autograd.record() if is_train and needs_grad else \
            autograd.pause(train_mode=is_train)
        with scope:
            self.outputs = _execute(self._symbol._heads, self.arg_dict)
        return self.outputs

    def backward(self, out_grads=None):
        from .. import autograd

        if not self.outputs:
            raise MXNetError("backward before forward")
        if out_grads is not None and not isinstance(out_grads,
                                                    (list, tuple)):
            out_grads = [out_grads]
        autograd.backward(self.outputs, out_grads)
        if self._args_grad:
            for nm, dst in self._args_grad.items():
                g = self.arg_dict[nm].grad
                if g is not None:
                    dst._rebind(g._data)

    def copy_params_from(self, arg_params, aux_params=None):
        for nm, v in arg_params.items():
            if nm in self.arg_dict:
                self.arg_dict[nm]._rebind(self._placed(v)._data)


# --------------------------------------------------------------------- #
# op builders (mx.sym.FullyConnected(...) and the rest)
# --------------------------------------------------------------------- #

# ops whose output count is known when the graph is built
_MULTI_OUTPUT = {
    "split": lambda attrs: int(attrs.get("num_outputs", 1)),
    "_BatchNormStats": lambda attrs: 5,  # out, new_mm, new_mv, mean, var
    "topk": lambda attrs: 2 if attrs.get("ret_typ") == "both" else 1,
}


def _invoke_builder(opname, sym_args, attrs, name=None):
    from ..name import current_attrs, current_name_manager

    opref = _registry.get_op(opname)
    inputs = []
    for s in sym_args:
        if s is None:
            continue
        if not isinstance(s, Symbol):
            raise MXNetError(
                f"{opname}: symbol op inputs must be Symbols, got {type(s)}")
        if len(s._heads) != 1:
            raise MXNetError(f"{opname}: grouped symbol cannot be an input")
        inputs.append(s._heads[0])
    attrs = {k: v for k, v in attrs.items() if v is not None or k == "axis"}
    n_out = _MULTI_OUTPUT.get(opref.name, lambda a: 1)(attrs)
    hint = opname.lower().strip("_")
    nm = current_name_manager()
    node_name = nm.get(name, hint) if nm is not None else \
        (name or _auto_name(hint))
    # user attributes ride along as __key__ (never reach the op)
    user_attrs = {f"__{k}__": v for k, v in current_attrs().items()}
    node = _Node(opref.name, node_name, inputs, {**attrs, **user_attrs},
                 num_outputs=n_out if n_out > 1 else None)
    return Symbol([(node, i) for i in range(n_out)])


def _make_builder(opname):
    opref = _registry.get_op(opname)
    try:
        sig = inspect.signature(opref.fn)
        arr_names = [p.name for p in sig.parameters.values()
                     if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    except (ValueError, TypeError):
        arr_names = []

    def builder(*args, name=None, **kwargs):
        if opref.variadic:
            arrays = list(args[0]) if len(args) == 1 and isinstance(
                args[0], (list, tuple)) else list(args)
            return _invoke_builder(opname, arrays, kwargs, name)
        arrays = list(args)
        # tensor inputs passed by keyword (bias=..., gamma=...)
        for nm in arr_names[len(arrays):]:
            arrays.append(kwargs.pop(nm, None))
        while arrays and arrays[-1] is None:
            arrays.pop()
        return _invoke_builder(opname, arrays, kwargs, name)

    builder.__name__ = opname
    builder.__doc__ = f"Symbolic {opname} (shared registry op)."
    return builder


# --------------------------------------------------------------------- #
# capture: imperative invokes recorded as graph nodes (the export path)
# --------------------------------------------------------------------- #

def _tensor_of(a):
    return a._data if hasattr(a, "_data") else a


class _Capture:
    def __init__(self):
        self.value_to_entry = {}  # id(tensor) -> (node, out_idx)
        self.keepalive = []       # the keyed tensors: ids stay unique
        self.const_values = {}    # constant variable's name -> tensor

    def lookup(self, arr):
        return self.value_to_entry.get(id(arr))

    def _key(self, data, entry):
        self.value_to_entry[id(data)] = entry
        self.keepalive.append(data)

    def mark_variable(self, name, ndarray, shape=None, dtype=None):
        node = _Node(None, name, attrs={})
        if shape is not None:
            node.attrs["__shape__"] = tuple(shape)
        self._key(_tensor_of(ndarray), (node, 0))
        return node

    def record(self, opref, array_args, kwargs, outs):
        attrs = {k: v for k, v in kwargs.items() if _jsonable(v)}
        if len(attrs) != len(kwargs):
            bad = set(kwargs) - set(attrs)
            raise MXNetError(
                f"capture: op {opref.name} has non-serializable attrs {bad}")
        inputs = []
        for a in array_args:
            data = _tensor_of(a)
            ent = self.lookup(data)
            if ent is None:
                # an input no captured op made (a constant made inside the
                # forward): a variable whose value export saves
                node = _Node(None, _auto_name("_const"), attrs={})
                ent = (node, 0)
                self._key(data, ent)
                self.const_values[node.name] = data
            inputs.append(ent)
        node = _Node(opref.name, _auto_name(opref.name.lower().strip("_")),
                     inputs, attrs, num_outputs=len(outs))
        for i, o in enumerate(outs):
            self._key(_tensor_of(o), (node, i))
        return node

    def symbol_for(self, outputs):
        heads = []
        for o in outputs:
            ent = self.lookup(_tensor_of(o))
            if ent is None:
                raise MXNetError("capture: output was not produced by a "
                                 "captured op")
            heads.append(ent)
        return Symbol(heads)


class capture:
    """``with capture() as cap:`` every registry invoke on this thread
    records a node (the reference's tape-as-graph, ``RecordOp``)."""

    _tls = threading.local()
    _lock = threading.Lock()

    def __enter__(self):
        self._prev = getattr(capture._tls, "value", None)
        capture._tls.value = _Capture()
        with capture._lock:
            _registry._captures += 1
        return capture._tls.value

    def __exit__(self, *a):
        capture._tls.value = self._prev
        with capture._lock:
            _registry._captures -= 1


def current_capture():
    return getattr(capture._tls, "value", None)
