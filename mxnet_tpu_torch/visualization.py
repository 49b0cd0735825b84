"""``mx.viz``: network visualization.

Port of ``mxnet_tpu/visualization.py`` (reference
``python/mxnet/visualization.py``): ``print_summary`` (a table of a
Symbol's nodes; with ``shape``, the parameters' element counts from
``infer_args``) and ``plot_network`` (a graphviz digraph; it raises
when the ``graphviz`` package is missing, as the reference's does).

One difference: a parameter read by several nodes (a language model's
head tied to its token table) counts once, at its first reader, so the
total equals the element count of the block's ``collect_params()``;
the reference adds it once for every node that reads it.
"""
from __future__ import annotations

from .base import MXNetError

__all__ = ["print_summary", "plot_network"]


def print_summary(symbol, shape=None, line_length=120, positions=None):
    """Print a row for each node of ``symbol``; with ``shape`` (the
    inputs' shapes by name) each row counts the parameters the node
    reads first.  Returns the total."""
    from .symbol.symbol import Symbol, _topo, infer_args

    if not isinstance(symbol, Symbol):
        raise MXNetError("print_summary expects a Symbol")
    positions = positions or [0.44, 0.64, 0.74, 1.0]
    positions = [int(line_length * p) for p in positions]
    arg_shapes = infer_args(symbol, **shape) if shape is not None else {}

    def row(fields):
        line = ""
        for field, pos in zip(fields, positions):
            line = (line + str(field))[:pos].ljust(pos)
        print(line)

    print("=" * line_length)
    row(["Layer (type)", "Output Shape", "Param #", "Previous Layer"])
    print("=" * line_length)
    total = 0
    counted = set()
    for node in _topo(symbol._heads):
        if node.op is None:
            row([f"{node.name} (null)", arg_shapes.get(node.name, ""), 0,
                 ""])
            continue
        n_params = 0
        prevs = []
        for inp, _ in node.inputs:
            prevs.append(inp.name)
            if inp.op is None and inp.name in arg_shapes \
                    and not _is_data_name(inp.name) \
                    and inp.name not in counted:
                counted.add(inp.name)
                n = 1
                for d in arg_shapes[inp.name]:
                    n *= d
                n_params += n
        total += n_params
        row([f"{node.name} ({node.op})", "", n_params, ",".join(prevs[:3])])
    print("=" * line_length)
    print(f"Total params: {total}")
    print("=" * line_length)
    return total


def _is_data_name(name):
    return name in ("data", "softmax_label", "label") or \
        name.startswith("data")


def plot_network(symbol, title="plot", save_format="pdf", shape=None,
                 node_attrs=None, hide_weights=True):
    """A graphviz ``Digraph`` of ``symbol``; needs the ``graphviz``
    package and raises ``MXNetError`` without it."""
    try:
        from graphviz import Digraph
    except ImportError as e:
        raise MXNetError(
            "plot_network requires the graphviz package (not installed in "
            "this environment); use print_summary or symbol.tojson") from e
    from .symbol.symbol import Symbol, _topo

    if not isinstance(symbol, Symbol):
        raise MXNetError("plot_network expects a Symbol")
    dot = Digraph(name=title, format=save_format)
    nodes = _topo(symbol._heads)
    for node in nodes:
        if node.op is None:
            if hide_weights and not _is_data_name(node.name):
                continue
            dot.node(node.name, node.name, shape="oval",
                     **(node_attrs or {}))
        else:
            dot.node(node.name, f"{node.name}\n{node.op}", shape="box",
                     **(node_attrs or {}))
    present = {n.name for n in nodes
               if n.op is not None or not hide_weights
               or _is_data_name(n.name)}
    for node in nodes:
        if node.op is None:
            continue
        for inp, _ in node.inputs:
            if inp.name in present:
                dot.edge(inp.name, node.name)
    return dot
