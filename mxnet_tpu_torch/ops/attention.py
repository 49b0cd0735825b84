"""Attention: the flash-attention forward (kernel K1), the plain path,
the dropout position hash and rotary embeddings.

Port of ``mxnet_tpu/ops/attention.py`` (forward only).  Shapes follow
(batch, heads, seq, head_dim) throughout, as in the reference.

- ``flash_fwd``: on a CUDA tensor, the hand-written kernel
  ``csrc/flash_fwd.cu`` (port of ``_pallas_fwd``); on a CPU tensor its
  plain version ``flash_fwd_plain``.  Returns ``(out, lse)``.
- ``flash_attention``: the op.  Up to ``Lq·Lk <= 512²`` scores it takes
  ``_plain_attn`` (the reference's threshold); longer sequences take K1.
  The reference's measured crossover table (``_PATH_TABLE``) came from a
  TPU and does not carry over: on the card the flash kernel is the
  counterpart of both its blockwise scan and its Pallas forward.  A dense
  bias (anything but a ``(B|1,1,1,Lk)`` key mask) is not a kernel input
  and stays on the plain path at every length.  ``training=True`` (the
  backward kernels K2/K3) belongs to the training slice and raises.

Dropout determinism: the keep mask is the reference's pure position hash
of ``(seed, batch·head, q_pos, k_pos)``, computed here bit for bit, so
the port and the reference drop the same probabilities.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from ..base import MXNetError

__all__ = ["flash_attention", "flash_fwd", "flash_fwd_plain", "rope"]

_NEG_INF = -1e30
_PLAIN_ATTN_MAX_SCORES = 512 * 512
_M32 = 0xFFFFFFFF


# --------------------------------------------------------------------------- #
# dropout keep-mask: the reference's position hash, in int64 with wraparound
# --------------------------------------------------------------------------- #

def _u32(x, device=None):
    return torch.as_tensor(x, dtype=torch.int64, device=device) & _M32


def _mul32(a, c: int):
    """``a * c mod 2**32`` for ``a`` in [0, 2**32): split so that no
    int64 product overflows."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash_bits(seed, bh, qpos, kpos):
    """murmur3-style avalanche over (seed, batch·head, q, k) -> uint32
    values held in int64; ``bh``/``qpos``/``kpos`` broadcast."""
    dev = next((t.device for t in (seed, bh, qpos, kpos)
                if isinstance(t, torch.Tensor)), None)
    h = _u32(seed, dev) ^ _mul32(_u32(bh, dev), 0x9E3779B1)
    h = h ^ _mul32(_u32(qpos, dev), 0x85EBCA77)
    h = h ^ _mul32(_u32(kpos, dev), 0xC2B2AE3D)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    return h


def _keep_threshold(rate: float) -> int:
    # drop iff bits < rate * 2^32
    return min(int(rate * 4294967296.0), 4294967295)


def _keep(seed, bh, qpos, kpos, rate):
    return _hash_bits(seed, bh, qpos, kpos) >= _keep_threshold(rate)


def _positions(B, H, Lq, Lk, device):
    bh = torch.arange(B * H, device=device).reshape(B, H, 1, 1)
    qpos = torch.arange(Lq, device=device).reshape(Lq, 1)
    kpos = torch.arange(Lk, device=device).reshape(1, Lk)
    return bh, qpos, kpos


# --------------------------------------------------------------------------- #
# K1: flash forward
# --------------------------------------------------------------------------- #

def flash_fwd_plain(q, k, v, scale, causal, kmask=None, seed=0,
                    dropout=0.0):
    """Plain PyTorch version of K1 with the kernel's semantics (f32
    scores, key mask then causal mask at -1e30, masked-probability guard,
    ``l`` clamped to 1e-30, dropout after the row sum).  ``kmask`` is the
    ``(Nb, 1, Lk)`` f32 key mask (Nb = 1 or B).  Returns ``(out, lse)``;
    the full score matrix is materialized, which is fine at test sizes."""
    B, H, Lq, _ = q.shape
    Lk = k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if kmask is not None:
        s = s + kmask.float().reshape(kmask.shape[0], 1, 1, Lk)
    bh, qpos, kpos = _positions(B, H, Lq, Lk, q.device)
    if causal:
        s = torch.where(qpos >= kpos, s, torch.full_like(s, _NEG_INF))
    m = torch.clamp(s.amax(-1, keepdim=True), min=_NEG_INF)
    p = torch.exp(s - m)
    p = torch.where(s <= _NEG_INF * 0.5, torch.zeros_like(p), p)
    lc = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    if dropout > 0.0:
        keep = _keep(seed, bh, qpos, kpos, dropout)
        p = torch.where(keep, p * (1.0 / (1.0 - dropout)),
                        torch.zeros_like(p))
    out = torch.matmul(p, v.float()) / lc
    return out.to(q.dtype), (m + torch.log(lc))[..., 0]


def _check_fwd(q, k, v, kmask):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise MXNetError("flash_fwd: q/k/v must be (B, H, L, D)")
    B, H, _, D = q.shape
    if k.shape[:2] != (B, H) or v.shape != k.shape or k.shape[3] != D:
        raise MXNetError(f"flash_fwd: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} disagree")
    if q.dtype not in (torch.bfloat16, torch.float32) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise MXNetError("flash_fwd: q/k/v must share one dtype, bf16 or "
                         f"f32 (got {q.dtype}, {k.dtype}, {v.dtype})")
    if kmask is not None:
        if kmask.dtype != torch.float32 or kmask.dim() != 3 or \
                kmask.shape[1] != 1 or kmask.shape[2] != k.shape[2] or \
                kmask.shape[0] not in (1, B):
            raise MXNetError(f"flash_fwd: kmask must be f32 (1|B, 1, Lk), "
                             f"got {kmask.dtype} {tuple(kmask.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("kmask", kmask)):
        if t is None:
            continue
        if t.device != q.device:
            raise MXNetError(f"flash_fwd: {name} on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise MXNetError(f"flash_fwd: {name} must be contiguous")


def _launcher():
    """The library of the kernel and its typed C entry point."""
    lib = _build.load("flash_fwd")
    fn = lib.flash_fwd_launch
    if fn.argtypes is None:
        p, i, f, u = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_uint)
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, f, i, u, u,
                       f, i, p]
        fn.restype = ctypes.c_int
    return lib, fn


def flash_fwd(q, k, v, scale, causal, kmask=None, seed=0, dropout=0.0):
    """K1: flash-attention forward over (B, H, L, D) q and (B, H, Lk, D)
    k/v.  Returns ``(out, lse)``: out in q's dtype, lse (B, H, L) f32.
    CUDA tensors launch ``csrc/flash_fwd.cu`` (``flash_fwd.launches``
    counts launches); CPU tensors take ``flash_fwd_plain``."""
    _check_fwd(q, k, v, kmask)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, scale, causal, kmask, seed,
                               dropout)
    if q.device.type != "cuda":
        raise MXNetError(f"flash_fwd: unsupported device {q.device}")
    B, H, L, D = q.shape
    Lk = k.shape[2]
    if D > 128 or D % 8:
        raise MXNetError(f"flash_fwd: head dim {D} must be a multiple of 8 "
                         "and at most 128")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    if B * H * L == 0:
        return out, lse
    rate = float(dropout)
    lib, fn = _launcher()
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if kmask is None else kmask.data_ptr(),
                 out.data_ptr(), lse.data_ptr(),
                 int(q.dtype == torch.bfloat16), B, H, L, Lk, D,
                 1 if kmask is None else kmask.shape[0], float(scale),
                 int(bool(causal)), int(seed) & _M32,
                 _keep_threshold(rate) if rate > 0.0 else 0,
                 1.0 / (1.0 - rate) if rate > 0.0 else 1.0,
                 int(rate > 0.0),
                 torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash_fwd")
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


# --------------------------------------------------------------------------- #
# the op
# --------------------------------------------------------------------------- #

def _is_kmask(bias) -> bool:
    """Additive bias of layout (B|1, 1, 1, Lk) — a key padding mask."""
    return bias is not None and bias.dim() == 4 and \
        bias.shape[1] == 1 and bias.shape[2] == 1


def _plain_attn(q, k, v, bias, scale, causal, dropout=0.0, seed=0):
    """Materialized-scores attention, the reference's short-sequence
    path: f32 scores, softmax in f32, probabilities cast to v's dtype
    before the product."""
    B, H, Lq, _ = q.shape
    Lk = k.shape[2]
    # scores: exact products summed in f64, rounded once to f32, so
    # they do not depend on the padded length either
    s = torch.matmul(q.double(), k.double().transpose(-1, -2)).float() \
        * scale
    if bias is not None:
        s = s + bias.float()
    bh, qpos, kpos = _positions(B, H, Lq, Lk, q.device)
    if causal:
        s = torch.where(qpos >= kpos, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    if dropout > 0.0:
        keep = _keep(seed, bh, qpos, kpos, dropout)
        p = torch.where(keep, p, torch.zeros_like(p)) / (1.0 - dropout)
    # the reference's einsum sums in f32 and rounds once to v's dtype;
    # summing the products in f64 before that rounding makes the result
    # independent of the padded key length and of the library's split
    return torch.matmul(p.to(v.dtype).double(), v.double()).to(v.dtype)


def flash_attention(q, k, v, bias=None, *, scale: Optional[float] = None,
                    causal: bool = False, dropout: float = 0.0,
                    training: Optional[bool] = None):
    """Attention over (B, H, L, D) tensors for inference.  ``bias`` is an
    optional additive score bias broadcastable to (B, H, Lq, Lk).
    ``dropout`` applies only when training, and training is the next
    slice of the port: ``training=True`` raises."""
    if training:
        raise MXNetError("flash_attention(training=True) needs the "
                         "backward kernels K2/K3, which come with the "
                         "training slice of mxnet_tpu_torch")
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    Lq, Lk = q.shape[2], k.shape[2]
    if Lq * Lk <= _PLAIN_ATTN_MAX_SCORES or not (
            bias is None or (_is_kmask(bias) and bias.shape[3] == Lk)):
        return _plain_attn(q, k, v, bias, float(scale), bool(causal))
    kmask = None
    if bias is not None:
        kmask = bias.float().reshape(bias.shape[0], 1, Lk).contiguous()
    out, _ = flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                       float(scale), bool(causal), kmask)
    return out


# --------------------------------------------------------------------------- #
# rotary position embeddings (RoPE)
# --------------------------------------------------------------------------- #

def rope(x, *, base=10000.0, position_offset=0):
    """Rotary position embeddings on (B, H, L, D) q/k tensors: rotates
    consecutive (even, odd) feature pairs by ``pos / base^(2i/D)``.
    ``position_offset`` is a scalar or a (B,) vector of per-row depths."""
    B, H, L, D = x.shape
    half = D // 2
    inv_freq = 1.0 / (base ** (
        torch.arange(0, half, dtype=torch.float32, device=x.device)
        * 2.0 / D))
    off = torch.as_tensor(position_offset, dtype=torch.float32,
                          device=x.device)
    pos = torch.arange(L, dtype=torch.float32, device=x.device) + \
        off[..., None]                              # (L,) | (B, L)
    angles = pos[..., None] * inv_freq              # (L,h) | (B,L,h)
    cos = torch.cos(angles).unsqueeze(-3)           # (1,L,h) | (B,1,L,h)
    sin = torch.sin(angles).unsqueeze(-3)
    x32 = x.float()
    x1 = x32[..., 0::2]
    x2 = x32[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    return torch.stack([r1, r2], dim=-1).reshape(B, H, L, D).to(x.dtype)
