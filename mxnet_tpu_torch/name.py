"""``mx.name``: the symbols' naming scopes and ``mx.AttrScope``.

Port of ``mxnet_tpu/name.py``: ``NameManager`` and ``Prefix`` (reference
``python/mxnet/name.py``) name the nodes a builder makes without a
``name``; ``AttrScope`` (``python/mxnet/attribute.py``) attaches its
attributes to every node made inside it, as ``__key__`` attributes that
never reach the op.
"""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix", "AttrScope", "current_name_manager",
           "current_attrs"]


class NameManager:
    """Names unnamed symbols; ``with NameManager():`` scopes it."""

    _tls = threading.local()

    def __init__(self):
        self._counter = {}
        self._old = None

    def get(self, name, hint):
        if name:
            return name
        n = self._counter.get(hint, 0)
        self._counter[hint] = n + 1
        return f"{hint}{n}"

    def __enter__(self):
        self._old = getattr(NameManager._tls, "value", None)
        NameManager._tls.value = self
        return self

    def __exit__(self, *a):
        NameManager._tls.value = self._old


class Prefix(NameManager):
    """Prepends ``prefix`` to every name it makes."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return name if name else self._prefix + super().get(None, hint)


def current_name_manager():
    return getattr(NameManager._tls, "value", None)


class AttrScope:
    """``with mx.AttrScope(ctx_group="dev1"):`` every symbol made inside
    carries the attributes (values as strings); nested scopes merge."""

    _tls = threading.local()

    def __init__(self, **attrs):
        self._attrs = {k: str(v) for k, v in attrs.items()}
        self._old = None

    def get(self, attrs=None):
        out = dict(self._attrs)
        if attrs:
            out.update(attrs)
        return out

    def __enter__(self):
        self._old = getattr(AttrScope._tls, "value", None)
        if self._old is not None:
            merged = dict(self._old._attrs)
            merged.update(self._attrs)
            self._attrs = merged
        AttrScope._tls.value = self
        return self

    def __exit__(self, *a):
        AttrScope._tls.value = self._old


def current_attrs():
    scope = getattr(AttrScope._tls, "value", None)
    return dict(scope._attrs) if scope is not None else {}
