"""Fused decode step: every transformer layer of one decode token in ONE
kernel launch (kernel K5).

Port of ``mxnet_tpu/ops/decode_fused.py``.  The chunk layout, the gate's
shape rules, the schedule and the packers are copies of the reference's
pure-Python parts (this package imports nothing of ``mxnet_tpu``); the
packers take the port's own model blocks.  The packed stream is the
reference's six-tuple::

    wstream (NCtot, U, CW)  bf16, or int8 codes with weights="int8"
    bstream (NCtot, CW)     per-chunk bias (bf16; f32 with int8)
    norms   (NL, 4, U) f32  [ln1 gamma, ln1 beta, ln2 gamma, ln2 beta]
                            (Llama: [rms1 gamma, 0, rms2 gamma, 0])
    bias2   (NL, U) f32     the fc2 / down bias, added after the F-sum
    sstream (NCtot, CW) f32 per-chunk int8 scales ((1, 1) zeros native)
    s2      (NL, U) f32     fc2 / down per-output scales (ones native)

Each layer's chunks run in the order of ``_schedule``: the "col" spans
(qkv, proj, fc1 | gate, up) are W^T column chunks, the last span (fc2 |
down) holds W column chunks contracted over their CW lanes.

- ``decode_step_plain``: the plain PyTorch version.  It walks the same
  spans with the reference kernel's roundings (below) and writes the new
  K/V column into the caches in place.
- ``decode_step``: the wrapper.  A CUDA tensor launches the hand-written
  kernel ``csrc/decode_fused.cu`` (one cooperative launch for all
  layers; ``decode_step.launches`` counts launches) or raises; a CPU
  tensor takes the plain version.

Roundings (reference ``_make_kernel``): native projections sum in f32,
cast, then add the bias in the compute dtype; int8 projections compute
``acc·s + b`` in f32, then cast; fc2/down sum over all of F in f32,
apply the per-output scale, add the f32 bias, cast, then add the
residual.  Norms run in f32 with one eps for both norms of a layer.
Attention: f32 scores times 1/sqrt(D), positions past ``pos`` masked,
f32 softmax, probabilities cast before an f32 p·V, output cast.  Llama
rotates q and the new k by ``pos·inv_freq`` in f32 before the cache
write.

The gate differs from the reference's in one clause only: the reference
also requires the whole K/V cache of a layer (double-buffered) plus the
stream block to fit a 12 MB TPU VMEM budget.  On the card the caches
stay in device memory, so that budget measures nothing the kernel uses;
the port checks the card kernel's own limits instead (head dim ≤ 128 and
even, and ``_gate_bytes`` of shared memory within one block's 227 KB,
which ``layout`` fits the kernel into; the launch itself raises if the
cooperative grid cannot be co-resident).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import _build
from ..base import MXNetError
from .nn import activation

__all__ = ["fused_decode_supported", "pack_gpt_weights",
           "pack_llama_weights", "decode_step", "decode_step_plain",
           "stacked_decode_supported", "layout", "plan"]

_WARPS = 8                  # csrc/decode_fused.cu kWarps (256 threads)
_G_MAX = 8                  # query heads of a KV group in one p.V pass
_ROW_SLABS = 4              # F slabs of the fc2 / down span, at least
_MIN_CHUNK = 16             # attention: positions a chunk, at least
_COL_SLABS = 2              # K slabs of each column span
# shared memory one H100 block may use, less 1 KB for the kernel's static
# reduction buffer
_SMEM_MAX = 232448 - 1024
# dynamic shared memory that leaves room for two blocks a SM (228 KB a SM,
# 1 KB reserved and 1 KB static a block)
_SMEM_PAIR = 233472 // 2 - 2048
_ROPE_ROWS: dict = {}       # (device, D, base or None) -> (D,) f32 on it
_GRIDS: dict = {}           # (device, int8, shared bytes) -> cooperative grid


def _pick_cw(u: int, f: int, kvd: int | None = None) -> int:
    """Chunk width (reference ``_pick_cw``): must tile U (and so the 3U
    qkv span), F and, for GQA, the KV-projection width; bounded by the
    reference's ``2 * u * cw * 2 <= 8 MiB`` stream-block check, kept so
    both sides pack the same layout."""
    for cw in (1536, 1280, 1024, 896, 768, 640, 512, 384, 256, 128, 64,
               32):
        if u % cw or f % cw:
            continue
        if kvd is not None and kvd % cw:
            continue
        if 2 * u * cw * 2 <= 8 * 1024 * 1024:
            return cw
    return 0


def _family_of(cfg):
    return "llama" if getattr(cfg, "num_kv_heads", None) is not None \
        and hasattr(cfg, "rope_base") else "gpt"


def _geometry(cfg):
    u, f, h = cfg.units, cfg.hidden_size, cfg.num_heads
    kv = getattr(cfg, "num_kv_heads", None) or h
    return u, f, h, kv


def _col_tile(cw, quant):
    """Output columns of a column-span item (csrc ``col_tile``): 8 lanes
    of 16-byte loads, a 128-byte run of a chunk row (64 bf16 or 128 int8
    weights), at most the chunk width."""
    return min(8 * (16 if quant else 8), cw)


def _gate_bytes(batch, u, h, kv, total, cw):
    """The shared memory the gate holds against one block's 227 KB: the
    column phases' input rows and (64, 32) tiles of row-lane partials a
    batch row, one KV head's query group with its scores over ``total``
    positions and p.V partials, one chunk of the FFN activation a batch
    row.  This is the first kernel's layout, kept as the gate's rule so its
    answers do not move with the kernel: ``layout`` fits the kernel into
    every case the rule admits."""
    d, g = u // h, h // kv
    col = 4 * batch * u + 4 * 64 * batch * 32
    attn = 4 * (g * total + g * d + max(256, g * d))
    row = 4 * batch * cw
    return max(col, attn, row)


@functools.lru_cache(maxsize=None)
def layout(batch, u, f, h, kv, total, cw, llama=False):
    """The shared memory of one K5 block (csrc ``col_smem``, ``attn_work``,
    ``phase_row``), for either stream, as a dict:

    - ``stage``: the column phases stage their prelude rows (the norm's
      gamma and LayerNorm's beta, two rows of U words, B rows of U bf16)
      beside the normalized input rows and the warps' partial tiles;
    - ``s_row``: the F slabs of the fc2/down span, whose largest slab of
      the FFN activation (and of up for Llama) and its bias and scale
      rows a block holds;
    - ``gm``, ``pv_rows``: attention's query heads a p.V pass and the rows
      its warps' partials are summed through, beside the scores of up to
      ``total`` positions of the group's heads;
    - ``smem``: the dynamic bytes, the largest phase's.

    The budget is the bytes that leave two blocks a SM where the least
    layout (no staging, a slab a chunk, one head a pass through one row)
    fits them, else one block's; within it the layout stages where it
    can and takes the fewest F slabs (at least 4), then the most heads a
    pass and rows.  The least layout needs no more than ``_gate_bytes``
    counts (or 61,440 bytes, for the fc2/down slab), so every case the
    gate admits fits."""
    d, g = u // h, h // kv
    n_row = f // cw
    parts = 2 if llama else 1
    col = 4 * (batch * u + _WARPS * batch * _col_tile(cw, True))
    staged = 4 * ((1 if llama else 2) * u + 2 * u + batch * u // 2)

    def row(s):
        return 4 * -(-n_row // s) * cw * parts * (batch + 2)

    def attn(rows, gm):
        return 4 * (g * total + max((g + 2) * d, rows * gm * d))

    least = max(col, row(n_row), attn(1, 1))
    budget = _SMEM_PAIR if least <= _SMEM_PAIR else _SMEM_MAX
    s_row = next(s for s in range(min(n_row, _ROW_SLABS), n_row + 1)
                 if row(s) <= budget or s == n_row)
    gm, rows = next(((m, r) for m in range(min(g, _G_MAX), 0, -1)
                     for r in (_WARPS, 4, 2, 1) if attn(r, m) <= budget),
                    (1, 1))
    stage = col + staged <= budget
    return dict(stage=stage, s_row=s_row, gm=gm, pv_rows=rows,
                smem=max(col + (staged if stage else 0), row(s_row),
                         attn(rows, gm)))


def _smem_bytes(batch, u, f, h, kv, total, cw, llama=False):
    """Dynamic shared memory of one K5 block (``layout``)."""
    return layout(batch, u, f, h, kv, total, cw, llama)["smem"]


def plan(L, grid, pos):
    """The work plan of one K5 launch on a grid of ``grid`` blocks, with
    ``layout``'s entries:

    - ``s_qkv``, ``s_proj``, ``s_ffn``: the K slabs of the column spans
      (qkv, proj, fc1 | gate+up), two each (one below 32 rows).  Slab
      counts that fill the grid's blocks were not faster on balance, and
      every slab is a partial each consumer sums; the count also sets
      the summation order, to which the Llama-7B fused stream's
      teacher-forced check over near-tied bf16 logits is sensitive
      (ROADMAP.md §3);
    - ``s_row`` (``layout``), ``g_row``: the fc2/down span's F slabs (of
      whole chunks) and groups of output rows, one item a block;
    - ``nc``, ``lc``: the attention's position chunks of ``lc``
      positions covering 0..pos, as many as give each (batch row, KV head)
      its share of the grid (one item a block) but at least 16 positions a
      chunk.  A second item for some blocks would double their path, so
      the items stop short of the grid (240 of 264 at GPT-2 small, B=4);
    - ``keep``: a block holds the scores of all its items (at most
      ``T`` positions of the group's heads) across the barrier between
      the two passes; where it cannot (more (batch row, KV head) pairs
      than blocks, late in the cache), the second pass computes each
      item's scores again.
    """
    lay = layout(L.B, L.U, L.F, L.H, L.KV, L.T, L.cw, L.llama)
    slabs = max(1, min(_COL_SLABS, L.U // 16))
    s_row = lay["s_row"]
    bkv = L.B * L.KV
    nc = 1 if bkv >= grid else max(1, min(grid // bkv,
                                          -(-(pos + 1) // _MIN_CHUNK)))
    lc = -(-(pos + 1) // nc)
    nc = -(-(pos + 1) // lc)
    slots = -(-(bkv * nc) // grid)
    return dict(s_qkv=slabs, s_proj=slabs, s_ffn=slabs, s_row=s_row,
                g_row=max(1, min(L.U, grid // s_row)), nc=nc, lc=lc,
                keep=slots * lc <= L.T, gm=lay["gm"],
                pv_rows=lay["pv_rows"], stage=lay["stage"],
                smem=lay["smem"])


def _is_bf16(dtype):
    return dtype == torch.bfloat16 or str(dtype) in ("bfloat16",
                                                      "torch.bfloat16")


def fused_decode_supported(cfg, batch, total, dtype) -> bool:
    """Fused decode gate: batch ≤ 4, bf16, chunk-tileable dims (the
    reference's shape and dtype rules), and the card kernel's own limits
    in place of the reference's TPU VMEM budget (module docstring)."""
    u, f, h, kv = _geometry(cfg)
    if not 1 <= batch <= 4 or not _is_bf16(dtype):
        return False
    if u % h or h % kv:
        return False
    d = u // h
    cw = _pick_cw(u, f, kv * d if kv != h else None)
    if cw == 0:
        return False
    if d > 128 or d % 2:
        return False
    return _gate_bytes(batch, u, h, kv, total, cw) <= _SMEM_MAX


def _norm_eps(blk):
    norms = (blk.rms1, blk.rms2) if hasattr(blk, "rms1") \
        else (blk.ln1, blk.ln2)
    return tuple(float(n.eps) for n in norms)


def stacked_decode_supported(model) -> bool:
    """Whether the reference's stacked-layer decode would take this
    model: a recognized block family, one norm eps pair and (GPT) one FFN
    activation across layers, and layers of one geometry.  The port runs
    one eager layer loop for both "stacked" and "unrolled"; this keeps
    ``decode_mode``'s answer the reference's."""
    blocks = getattr(model, "blocks", None)
    if not blocks:
        return False
    try:
        if len({_norm_eps(b) for b in blocks}) != 1:
            return False
        if not hasattr(blocks[0], "rms1") and \
                len({b.ffn.fc1.act_type for b in blocks}) != 1:
            return False
        shapes = [[(tuple(p.shape), p.dtype) for p in b.parameters()]
                  for b in blocks]
    except AttributeError:
        return False
    return all(s == shapes[0] for s in shapes[1:])


def _schedule(cfg):
    """Chunk schedule: list of (phase_name, n_chunks) in stream order."""
    u, f, h, kv = _geometry(cfg)
    d = u // h
    kvd = kv * d
    if _family_of(cfg) == "llama":
        cw = _pick_cw(u, f, kvd if kv != h else None)
        spans = [("qkv", (u + 2 * kvd) // cw), ("proj", u // cw),
                 ("gate", f // cw), ("up", f // cw), ("down", f // cw)]
    else:
        cw = _pick_cw(u, f)
        spans = [("qkv", 3 * u // cw), ("proj", u // cw),
                 ("fc1", f // cw), ("fc2", f // cw)]
    return cw, spans


def _span_offsets(spans):
    lo, off = {}, 0
    for name, n in spans:
        lo[name] = (off, off + n)
        off += n
    return lo, off


def _quant_rows(w):
    """Per-output-channel symmetric int8: w (out, in) -> (codes (out,
    in) int8, f32 scales (out,))."""
    w32 = w.float()
    s = torch.clamp(w32.abs().amax(dim=1) / 127.0, min=1e-8)
    return torch.round(w32 / s[:, None]).to(torch.int8), s


def _bias_of(lyr, n, dtype, device):
    if getattr(lyr, "bias", None) is not None:
        return lyr.bias.detach()
    return torch.zeros((n,), dtype=dtype, device=device)


@torch.no_grad()
def _pack(layer_mats, norm_rows, cw, dtype, quant):
    """Shared packer (reference ``_pack``): ``layer_mats`` yields per
    layer a list of (W (out, in), bias (out,), mode) with mode ``"col"``
    (W^T column chunks, per-chunk scales) or ``"row"`` (W column chunks
    contracted over lanes; the output scales go to ``s2``)."""
    w_chunks, b_chunks, s_chunks, norms, bias2, s2 = [], [], [], [], [], []
    for mats, nrm in zip(layer_mats, norm_rows):
        dev = nrm.device
        tail_bias = tail_scale = None
        for (w, b, mode) in mats:
            w = w.detach()
            wq, s = _quant_rows(w) if quant else (w, None)
            if mode == "col":
                for c in range(wq.shape[0] // cw):
                    w_chunks.append(wq[c * cw:(c + 1) * cw, :].t())
                    b_chunks.append(b[c * cw:(c + 1) * cw])
                    if quant:
                        s_chunks.append(s[c * cw:(c + 1) * cw])
            else:
                for c in range(wq.shape[1] // cw):
                    w_chunks.append(wq[:, c * cw:(c + 1) * cw])
                    b_chunks.append(torch.zeros((cw,), dtype=dtype,
                                                device=dev))
                    if quant:
                        s_chunks.append(torch.ones((cw,), device=dev))
                tail_bias, tail_scale = b, s
        n_out = nrm.shape[1]
        bias2.append((tail_bias if tail_bias is not None else
                      torch.zeros((n_out,), dtype=dtype, device=dev)
                      ).float())
        s2.append(tail_scale if tail_scale is not None and quant
                  else torch.ones((n_out,), device=dev))
        norms.append(nrm)
    wstream = torch.stack(w_chunks)
    if not quant:
        wstream = wstream.to(dtype)
    bstream = torch.stack(b_chunks)
    if quant:
        bstream = bstream.float()
        sstream = torch.stack(s_chunks)
    else:
        sstream = torch.zeros((1, 1), device=wstream.device)
    return (wstream, bstream, torch.stack(norms), torch.stack(bias2),
            sstream, torch.stack(s2))


def pack_gpt_weights(blocks, dtype, quant=False):
    """Every GPT block's projections in the stream layout: Wqkv^T /
    Wproj^T / Wfc1^T column chunks + Wfc2 lane-contraction chunks, each
    (U, CW).  Returns the six-tuple of the module docstring."""
    u = blocks[0].ln1.gamma.shape[0]
    f = blocks[0].ffn.fc1.weight.shape[0]
    cw = _pick_cw(u, f)
    dev = blocks[0].ln1.gamma.device

    def mats():
        for blk in blocks:
            yield [(blk.attn.qkv.weight,
                    _bias_of(blk.attn.qkv, 3 * u, dtype, dev), "col"),
                   (blk.attn.proj.weight,
                    _bias_of(blk.attn.proj, u, dtype, dev), "col"),
                   (blk.ffn.fc1.weight,
                    _bias_of(blk.ffn.fc1, f, dtype, dev), "col"),
                   (blk.ffn.fc2.weight,
                    _bias_of(blk.ffn.fc2, u, dtype, dev), "row")]

    def nrms():
        for blk in blocks:
            yield torch.stack([blk.ln1.gamma.detach().float(),
                               blk.ln1.beta.detach().float(),
                               blk.ln2.gamma.detach().float(),
                               blk.ln2.beta.detach().float()])

    return _pack(mats(), nrms(), cw, dtype, quant)


def pack_llama_weights(blocks, cfg, dtype, quant=False):
    """Llama stream: q/k/v/o^T + gate^T/up^T column chunks and down
    lane-contraction chunks; norms rows [rms1 gamma, 0, rms2 gamma, 0]."""
    u, f = cfg.units, cfg.hidden_size
    d = u // cfg.num_heads
    kvd = cfg.num_kv_heads * d
    cw = _pick_cw(u, f, kvd if cfg.num_kv_heads != cfg.num_heads
                  else None)
    dev = blocks[0].rms1.gamma.device

    def mats():
        for blk in blocks:
            a, m = blk.attn, blk.mlp
            yield [(a.q_proj.weight, _bias_of(a.q_proj, u, dtype, dev),
                    "col"),
                   (a.k_proj.weight, _bias_of(a.k_proj, kvd, dtype, dev),
                    "col"),
                   (a.v_proj.weight, _bias_of(a.v_proj, kvd, dtype, dev),
                    "col"),
                   (a.o_proj.weight, _bias_of(a.o_proj, u, dtype, dev),
                    "col"),
                   (m.gate.weight, _bias_of(m.gate, f, dtype, dev), "col"),
                   (m.up.weight, _bias_of(m.up, f, dtype, dev), "col"),
                   (m.down.weight, _bias_of(m.down, u, dtype, dev), "row")]

    def nrms():
        z = torch.zeros((u,), device=dev)
        for blk in blocks:
            yield torch.stack([blk.rms1.gamma.detach().float(), z,
                               blk.rms2.gamma.detach().float(), z])

    return _pack(mats(), nrms(), cw, dtype, quant)


def _rope_inv(cfg, D):
    """inv_freq[d // 2] per lane, f32 (D,), computed in numpy as the
    reference's ``decode_step`` computes it."""
    base = float(getattr(cfg, "rope_base", 10000.0))
    inv_freq = 1.0 / (base ** (
        np.arange(0, D // 2, dtype=np.float32) * 2.0 / D))
    return np.repeat(inv_freq.astype(np.float32), 2)


def _rope_pairs(x32, pos, inv_lane):
    """Rotate interleaved (even, odd) pairs of f32 ``x32`` (..., D) by
    ``pos * inv_lane`` in f32 (the reference's ``_rope_lanewise``)."""
    theta = torch.tensor(float(pos), dtype=torch.float32,
                         device=x32.device) * inv_lane[0::2]
    c, s = torch.cos(theta), torch.sin(theta)
    x1, x2 = x32[..., 0::2], x32[..., 1::2]
    return torch.stack([x1 * c - x2 * s, x1 * s + x2 * c],
                       dim=-1).reshape(x32.shape)


class _Layout:
    """Shapes of one fused step, read from its operands and ``cfg``."""

    def __init__(self, x, packed, kh, cfg):
        wstream, _, norms, _, _, _ = packed
        self.NL = norms.shape[0]
        self.B, self.U = x.shape
        self.F = cfg.hidden_size
        self.H = cfg.num_heads
        self.KV = getattr(cfg, "num_kv_heads", None) or self.H
        self.D = self.U // self.H
        self.T = kh.shape[3]
        self.llama = _family_of(cfg) == "llama"
        self.cw, spans = _schedule(cfg)
        self.lo, self.NC = _span_offsets(spans)
        self.QS = 3 * self.U if not self.llama else \
            self.U + 2 * self.KV * self.D
        self.quant = wstream.dtype == torch.int8


def decode_step_plain(pos, x, packed, kh, vh, cfg, act, eps):
    """Plain PyTorch version of K5: ``x`` (B, U) after the embeddings
    through every layer at position ``pos``; writes each layer's new K/V
    column into ``kh``/``vh`` (NL, B, KV, T, D) in place.  Returns
    ``(x, kh, vh)``."""
    wstream, bstream, norms, bias2, sstream, s2 = packed
    L = _Layout(x, packed, kh, cfg)
    B, U, H, KV, D = L.B, L.U, L.H, L.KV, L.D
    G = H // KV
    pos = int(pos)
    dt = x.dtype
    scale = 1.0 / (D ** 0.5)
    inv = torch.from_numpy(_rope_inv(cfg, D)).to(x.device) \
        if L.llama else None

    def span(layer, name):
        a, b = L.lo[name]
        a, b = layer * L.NC + a, layer * L.NC + b
        # (n, U, CW) chunks -> (U, n * CW): column c*CW + j is chunk c's j
        w = wstream[a:b].permute(1, 0, 2).reshape(U, -1).float()
        return a, b, w

    def col(layer, name, lhs):
        a, b, w = span(layer, name)
        part = torch.matmul(lhs.float(), w)
        bias = bstream[a:b].reshape(-1)
        if L.quant:
            return (part * sstream[a:b].reshape(-1) + bias).to(dt)
        return part.to(dt) + bias

    def norm(val, layer, grow, brow):
        v32 = val.float()
        g = norms[layer, grow]
        if L.llama:
            ms = (v32 * v32).mean(-1, keepdim=True)
            return (v32 * torch.rsqrt(ms + eps) * g).to(dt)
        mean = v32.mean(-1, keepdim=True)
        var = ((v32 - mean) ** 2).mean(-1, keepdim=True)
        return ((v32 - mean) * torch.rsqrt(var + eps) * g +
                norms[layer, brow]).to(dt)

    for layer in range(L.NL):
        qkv = col(layer, "qkv", norm(x, layer, 0, 1))
        q = qkv[:, :U].reshape(B, H, D)
        kvd = KV * D
        k = qkv[:, U:U + kvd].reshape(B, KV, D)
        v = qkv[:, U + kvd:U + 2 * kvd].reshape(B, KV, D)
        if L.llama:
            q = _rope_pairs(q.float(), pos, inv).to(dt)
            k = _rope_pairs(k.float(), pos, inv).to(dt)
        kh[layer, :, :, pos] = k
        vh[layer, :, :, pos] = v
        kc = kh[layer, :, :, :pos + 1].float()            # (B, KV, t, D)
        vc = vh[layer, :, :, :pos + 1].float()
        s = torch.matmul(q.reshape(B, KV, G, D).float(),
                         kc.transpose(-1, -2)) * scale    # (B, KV, G, t)
        p = torch.softmax(s, dim=-1).to(dt)
        o = torch.matmul(p.float(), vc).to(dt).reshape(B, U)
        x2 = x + col(layer, "proj", o)
        xn2 = norm(x2, layer, 2, 3)
        if L.llama:
            g = col(layer, "gate", xn2)
            h = g * torch.sigmoid(g) * col(layer, "up", xn2)
            row = "down"
        else:
            h = col(layer, "fc1", xn2)
            if act is not None:
                h = activation(h, act)
            row = "fc2"
        _, _, w2 = span(layer, row)                 # (U, F): W2 itself
        acc = torch.matmul(h.float(), w2.t())
        if L.quant:
            acc = acc * s2[layer]
        x = x2 + (acc + bias2[layer]).to(dt)
    return x, kh, vh


def _check(x, packed, kh, vh, cfg, act):
    wstream, bstream, norms, bias2, sstream, s2 = packed
    if x.dim() != 2 or kh.dim() != 5 or kh.shape != vh.shape:
        raise MXNetError(f"decode_step: x {tuple(x.shape)} must be (B, U) "
                         f"and kh/vh (NL, B, KV, T, D), got "
                         f"{tuple(kh.shape)} / {tuple(vh.shape)}")
    L = _Layout(x, packed, kh, cfg)
    if L.cw == 0 or L.U % L.H or L.H % L.KV:
        raise MXNetError("decode_step: dims do not tile into chunks")
    if tuple(kh.shape) != (L.NL, L.B, L.KV, L.T, L.D):
        raise MXNetError(f"decode_step: caches {tuple(kh.shape)} do not "
                         f"match (NL, B, KV, T, D) = "
                         f"{(L.NL, L.B, L.KV, L.T, L.D)}")
    if tuple(wstream.shape) != (L.NL * L.NC, L.U, L.cw):
        raise MXNetError(f"decode_step: wstream {tuple(wstream.shape)} "
                         f"is not the packed (NCtot, U, CW) = "
                         f"{(L.NL * L.NC, L.U, L.cw)}")
    if act not in (None, "gelu", "relu"):
        raise MXNetError(f"decode_step: unsupported activation {act}")
    for name, t in (("kh", kh), ("vh", vh), *zip(
            ("wstream", "bstream", "norms", "bias2", "sstream", "s2"),
            packed)):
        if t.device != x.device:
            raise MXNetError(f"decode_step: {name} on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise MXNetError(f"decode_step: {name} must be contiguous")
    return L


def _launcher():
    lib = _build.load("decode_fused")
    fn = lib.decode_fused_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # 15 device pointers, 29 ints, eps, scale, the shared memory
        # bytes and the stream
        fn.argtypes = [p] * 15 + [i] * 29 + [f, f, i, p]
        fn.restype = ctypes.c_int
        g = lib.decode_fused_grid
        g.argtypes = [i, i, p]
        g.restype = ctypes.c_int
    return lib, fn


def _grid(lib, device, quant, smem):
    """The cooperative grid of the kernel, asked of the CUDA runtime (the
    shared memory attribute, the occupancy) once per (device, stream
    type, shared memory bytes)."""
    key = (device, quant, smem)
    grid = _GRIDS.get(key)
    if grid is None:
        n = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = lib.decode_fused_grid(int(quant), smem, ctypes.addressof(n))
        _build.check(lib, err, "decode_fused")
        grid = _GRIDS[key] = n.value
    return grid


def _launch(pos, x, packed, kh, vh, cfg, L, act, eps):
    wstream, bstream, norms, bias2, sstream, s2 = packed
    if x.dtype != torch.bfloat16 or kh.dtype != torch.bfloat16 or \
            vh.dtype != torch.bfloat16:
        raise MXNetError(f"decode_step: the kernel takes bf16 x and caches, "
                         f"got {x.dtype}, {kh.dtype}")
    if not L.quant and (wstream.dtype != torch.bfloat16 or
                        bstream.dtype != torch.bfloat16):
        raise MXNetError("decode_step: a native stream must be bf16")
    if L.quant and (bstream.dtype != torch.float32 or
                    sstream.dtype != torch.float32):
        raise MXNetError("decode_step: an int8 stream takes f32 biases "
                         "and scales")
    if L.D > 128 or L.D % 2 or not 1 <= L.B <= 4:
        raise MXNetError(f"decode_step: the kernel takes B <= 4 and an "
                         f"even head dim <= 128, got B={L.B} D={L.D}")
    if not 0 <= int(pos) < L.T:
        raise MXNetError(f"decode_step: pos {pos} outside the cache "
                         f"({L.T} positions)")
    smem = _smem_bytes(L.B, L.U, L.F, L.H, L.KV, L.T, L.cw, L.llama)
    if smem > _SMEM_MAX:
        raise MXNetError(f"decode_step: {smem} bytes of shared memory a "
                         f"block exceed the card's {_SMEM_MAX}")
    lib, fn = _launcher()
    grid = _grid(lib, x.device, L.quant, smem)
    pl = plan(L, grid, int(pos))
    G = L.H // L.KV
    items = L.B * L.KV * pl["nc"]
    spans = L.lo
    ffn_w = (2 if L.llama else 1) * L.F
    # scratch, one buffer, each part 256-byte aligned: the residual x2
    # (bf16), the column / row partials, the chunks' p.V partials and
    # their max and sum (f32)
    sizes = [2 * L.B * L.U,
             4 * L.B * max(pl["s_qkv"] * L.QS, pl["s_ffn"] * ffn_w),
             4 * L.B * L.U * max(pl["s_proj"], pl["s_row"]),
             4 * pl["nc"] * L.B * L.U, 4 * items * G * 2]
    offs, tot = [], 0
    for n in sizes:
        offs.append(tot)
        tot += -(-n // 256) * 256
    scratch = torch.empty((tot,), dtype=torch.uint8, device=x.device)
    base = scratch.data_ptr()
    out = x.clone()
    key = (x.device, L.D, float(cfg.rope_base) if L.llama else None)
    rope = _ROPE_ROWS.get(key)
    if rope is None:
        rope = _ROPE_ROWS[key] = torch.from_numpy(
            _rope_inv(cfg, L.D) if L.llama else
            np.zeros((L.D,), np.float32)).to(x.device)
    with torch.cuda.device(x.device):
        err = fn(out.data_ptr(), wstream.data_ptr(), bstream.data_ptr(),
                 sstream.data_ptr(), norms.data_ptr(), bias2.data_ptr(),
                 s2.data_ptr(), rope.data_ptr(), kh.data_ptr(),
                 vh.data_ptr(), *(base + o for o in offs),
                 int(pos), int(L.quant), L.NL, L.B, L.U, L.F, L.H, L.KV,
                 L.D, L.T, L.cw, L.NC, spans["proj"][0],
                 spans["gate" if L.llama else "fc1"][0],
                 spans["down" if L.llama else "fc2"][0], int(L.llama),
                 {None: 0, "gelu": 1, "relu": 2}[act], pl["s_qkv"],
                 pl["s_proj"], pl["s_ffn"], pl["s_row"], pl["g_row"],
                 pl["nc"], pl["lc"], int(pl["keep"]), pl["gm"],
                 pl["pv_rows"], int(pl["stage"]), grid, float(eps),
                 float(1.0 / (L.D ** 0.5)), smem,
                 torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "decode_fused")
    decode_step.grid = grid
    decode_step.last_plan = pl
    return out


def decode_step(pos, x, packed, kh, vh, cfg, act, eps):
    """One fused decode step over every layer (both families).

    ``pos``: the position (int); ``x`` (B, U): the hidden state after the
    embeddings; ``packed``: the family packer's six-tuple (int8 read from
    the stream's dtype); ``kh``/``vh``: (NL, B, KV, T, D) caches, updated
    in place at ``pos``; ``act``: the GPT FFN activation (None, "gelu" or
    "relu"); ``eps``: the norms' epsilon.  Returns ``(x, kh, vh)``.  A
    CUDA tensor launches K5 (one launch for all layers); a CPU tensor
    takes ``decode_step_plain``."""
    L = _check(x, packed, kh, vh, cfg, act)
    if x.device.type == "cpu":
        return decode_step_plain(pos, x, packed, kh, vh, cfg, act, eps)
    if x.device.type != "cuda":
        raise MXNetError(f"decode_step: unsupported device {x.device}")
    out = _launch(pos, x, packed, kh, vh, cfg, L, act, eps)
    decode_step.launches += 1
    return out, kh, vh


decode_step.launches = 0
decode_step.grid = 0
decode_step.last_plan = None
