"""The state layout and program operands of the paged slot-pool
programs (``serve.engine.PoolPrograms``): the port's counterpart of
``mxnet_tpu/serve/schema.py``.

* ``SLOT_STATE`` — the per-slot columns that ride beside the K/V page
  pools, with their dtype and per-slot element count.
  ``pool_state_init`` allocates them from here and
  ``pool_state_bytes``/``admit_scratch_bytes`` price a slot at
  :func:`slot_state_bytes`, so the price and the allocation cannot
  drift apart.  The reference keeps a two-word PRNG key per slot; the
  port keeps the request's ``seed`` (its sampler hashes (seed,
  position, token)), and its integer columns are int64, torch's index
  type.
* ``PROGRAMS`` — each unit of work's operands in order.  The programs
  of the port update the state in place (the reference's donated
  buffers and packed meta rows have no counterpart here).

This module imports nothing, so a tool can load it by file path.
"""
from __future__ import annotations

__all__ = ["SLOT_STATE", "KV_PAGE_INT8", "PROGRAMS", "state_operands",
           "slot_state_bytes", "kv_page_int8_bytes", "operands"]

# (name, dtype, elements a slot), in state order.  ``dl`` is the
# wall-clock retirement deadline (server-epoch seconds, +inf = none);
# ``spec`` the slot's speculation-depth cap (0: never speculate).
SLOT_STATE = (
    ("pos",    "int64",   1),   # next write index
    ("tok",    "int64",   1),   # last sampled token
    ("active", "bool",    1),   # slot live?
    ("stop",   "int64",   1),   # retire position
    ("seed",   "int64",   1),   # the request's sampling seed
    ("dl",     "float32", 1),   # per-slot deadline
    ("spec",   "int64",   1),   # speculation-depth cap
)

# the int8 page representation (``kv_dtype="int8"``): one-byte codes
# and one f32 scale a (layer, page, KV head), for each of K and V
KV_PAGE_INT8 = {"codes": "int8", "scales": "float32"}

# each unit of work's operands: ``PoolPrograms``' method arguments after
# the state (``kp``, ``vp`` and the SLOT_STATE columns), which every
# unit updates in place, in order (a test holds the methods to these).
# ``now`` is the clock the step and the verify retire deadlines against,
# written before each call into a static one-element f32 operand, as
# the page table ``rows`` is into ``pt``; ``dls``/``dl`` the admitted
# slots' deadlines.
PROGRAMS = {
    "step": ("rows", "now"),
    "verify": ("rows", "drafts", "nd", "k", "now"),
    "admit": ("prompts", "true_len", "slots", "stop_pos", "seeds", "pages",
              "spec", "zpages", "dls"),
    "admit_hit": ("slots", "true_len", "last_tok", "stop_pos", "seeds",
                  "src", "dst", "spec", "zpages", "dls"),
    "chunk": ("toks", "ptrow", "off", "nlast", "final", "slot", "true_len",
              "stop_pos", "seed", "spec", "zrow", "dl"),
}

_ITEMSIZE = {"bool": 1, "int8": 1, "uint8": 1, "int16": 2, "int32": 4,
             "uint32": 4, "float32": 4, "int64": 8, "float64": 8}


def state_operands():
    """The state every program updates: the K/V page pools, then the
    per-slot columns in order."""
    return ("kp", "vp") + tuple(n for n, _, _ in SLOT_STATE)


def operands(name):
    """The state unit ``name`` updates, then its other operands."""
    try:
        return state_operands() + PROGRAMS[name]
    except KeyError:
        raise ValueError(f"no serve program named {name!r} (declared: "
                         f"{', '.join(PROGRAMS)})") from None


def slot_state_bytes():
    """Device bytes of ONE slot's columns — the constant
    ``pool_state_bytes``/``admit_scratch_bytes`` scale."""
    return sum(_ITEMSIZE[dtype] * n for _, dtype, n in SLOT_STATE)


def kv_page_int8_bytes(nl, kv, page, d):
    """Device bytes of ONE int8 page across all layers, K and V pools
    together: ``page * d`` codes plus one scale per (layer, KV head)."""
    return 2 * nl * kv * (page * d * _ITEMSIZE[KV_PAGE_INT8["codes"]]
                          + _ITEMSIZE[KV_PAGE_INT8["scales"]])
