"""Attention: the flash-attention forward (kernel K1) and backward
(kernels K2 and K3) behind a ``torch.autograd.Function``, the plain path,
the dropout position hash and rotary embeddings.

Port of ``mxnet_tpu/ops/attention.py``.  Shapes follow (batch, heads,
seq, head_dim) throughout, as in the reference.

- ``flash_fwd``: on a CUDA tensor, the hand-written kernel
  ``csrc/flash_fwd.cu`` (port of ``_pallas_fwd``); on a CPU tensor its
  plain version ``flash_fwd_plain``.  Returns ``(out, lse)``.
- ``flash_bwd_dq`` (K2, port of ``_pallas_bwd_dq``) and
  ``flash_bwd_dkv`` (K3, port of ``_pallas_bwd_dkv``): the kernels of
  ``csrc/flash_bwd.cu`` on CUDA tensors, ``flash_bwd_dq_plain`` and
  ``flash_bwd_dkv_plain`` on CPU tensors.  f32 outputs.
- ``flash_attention``: the op.  Up to ``Lq·Lk <= 512²`` scores it takes
  ``_plain_attn`` (the reference's threshold), differentiated by
  autograd; longer sequences take ``_FlashAttention`` (K1 forward, K2/K3
  backward, the reference's ``_flash`` custom VJP).  The reference's
  measured crossover table (``_PATH_TABLE``) came from a TPU and does not
  carry over: on the card the flash kernels are the counterpart of both
  its blockwise scan and its Pallas kernels, in inference and in
  training.  A dense bias (anything but a ``(B|1,1,1,Lk)`` key mask) is
  not a kernel input and stays on the plain path at every length.

Dropout determinism: the keep mask is the reference's pure position hash
of ``(seed, batch·head, q_pos, k_pos)``, computed here bit for bit, so
the port and the reference drop the same probabilities.  The seed is a
device word, a one-element int64 tensor holding a uint32 (the reference's
``seed_ref`` operand): the kernels read its low 32 bits on the card, so
a CUDA graph that captured them drops what the word holds at each
replay.  ``flash_attention`` takes it from ``random.attention_seed``,
which under a program's traced key derives it on the device; the
wrappers and plain versions also take a Python int, which the wrappers
fill into a word.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from .. import random as _random
from ..base import MXNetError

__all__ = ["flash_attention", "flash_fwd", "flash_fwd_plain",
           "flash_bwd_dq", "flash_bwd_dq_plain", "flash_bwd_dkv",
           "flash_bwd_dkv_plain", "rope"]

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


def _wide(x):
    """``x`` in the plain versions' arithmetic: f32, or f64 for f64
    inputs (so ``gradcheck`` can hold the backward in f64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


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
    s = torch.matmul(_wide(q), _wide(k).transpose(-1, -2)) * scale
    if kmask is not None:
        s = s + _wide(kmask).reshape(kmask.shape[0], 1, 1, Lk)
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
    out = torch.matmul(p, _wide(v)) / lc
    return out.to(q.dtype), (m + torch.log(lc))[..., 0]


def _check_fwd(q, k, v, kmask, what="flash_fwd"):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise MXNetError(f"{what}: q/k/v must be (B, H, L, D)")
    B, H, _, D = q.shape
    if k.shape[:2] != (B, H) or v.shape != k.shape or k.shape[3] != D:
        raise MXNetError(f"{what}: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} disagree")
    if q.dtype not in (torch.bfloat16, torch.float32, torch.float64) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise MXNetError(f"{what}: q/k/v must share one dtype, bf16 or "
                         f"f32 (or f64 on the CPU; got {q.dtype}, "
                         f"{k.dtype}, {v.dtype})")
    if kmask is not None:
        if kmask.dtype != _wide(q).dtype or kmask.dim() != 3 or \
                kmask.shape[1] != 1 or kmask.shape[2] != k.shape[2] or \
                kmask.shape[0] not in (1, B):
            raise MXNetError(f"{what}: kmask must be {_wide(q).dtype} "
                             f"(1|B, 1, Lk), got {kmask.dtype} "
                             f"{tuple(kmask.shape)}")
    _check_placed(what, q, k=k, v=v, kmask=kmask)


def _check_placed(what, q, **tensors):
    for name, t in (("q", q), *tensors.items()):
        if t is None:
            continue
        if t.device != q.device:
            raise MXNetError(f"{what}: {name} on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise MXNetError(f"{what}: {name} must be contiguous")


def _on_card(what, q):
    """True for a CUDA tensor, False for a CPU one; raises otherwise or
    for a dtype or head dim the kernels do not take (f64 runs only on the
    CPU, through the plain versions)."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda" or q.dtype == torch.float64:
        raise MXNetError(f"{what}: unsupported {q.dtype} on {q.device}")
    D = q.shape[3]
    if D > 128 or D % 8:
        raise MXNetError(f"{what}: head dim {D} must be a multiple of 8 "
                         "and at most 128")
    return True


def _seed_word(seed, device, rate):
    """The dropout seed as the kernels read it: a one-element int64 word
    on ``device`` (a Python int is filled into one); None without
    dropout."""
    if rate <= 0.0:
        return None
    if not isinstance(seed, torch.Tensor):
        return torch.full((1,), int(seed) & _M32, dtype=torch.int64,
                          device=device)
    if seed.dtype != torch.int64 or seed.numel() != 1 or \
            seed.device != torch.device(device):
        raise MXNetError(f"dropout seed must be a one-element int64 word "
                         f"on {device}, got {seed.dtype} "
                         f"{tuple(seed.shape)} on {seed.device}")
    return seed


def _entry(lib_name, fn_name, n_ptrs):
    """The library ``lib_name`` and its typed C entry point ``fn_name``:
    ``n_ptrs`` device pointers, then the shared scalar tail (is_bf16, B,
    H, L, Lk, D, nb_mask, scale, causal, the seed word's pointer,
    thresh, inv_keep, dropout, stream)."""
    lib = _build.load(lib_name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        p, i, f, u = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_uint)
        fn.argtypes = [p] * n_ptrs + [i, i, i, i, i, i, i, f, i, p, u, f,
                                      i, p]
        fn.restype = ctypes.c_int
    return lib, fn


def _scalar_tail(q, k, kmask, scale, causal, seed_word, dropout):
    """The kernels' shared scalar arguments, in the C entry points'
    order; dropout takes the seed word (``_seed_word``), the reference's
    keep threshold and 1/(1-rate)."""
    B, H, L, D = q.shape
    rate = float(dropout)
    return (int(q.dtype == torch.bfloat16), B, H, L, k.shape[2], D,
            1 if kmask is None else kmask.shape[0], float(scale),
            int(bool(causal)), _ptr(seed_word),
            _keep_threshold(rate) if rate > 0.0 else 0,
            1.0 / (1.0 - rate) if rate > 0.0 else 1.0, int(rate > 0.0),
            torch.cuda.current_stream(q.device).cuda_stream)


def _ptr(t):
    return None if t is None else t.data_ptr()


def flash_fwd(q, k, v, scale, causal, kmask=None, seed=0, dropout=0.0):
    """K1: flash-attention forward over (B, H, L, D) q and (B, H, Lk, D)
    k/v.  Returns ``(out, lse)``: out in q's dtype, lse (B, H, L) f32.
    ``seed`` is the dropout seed: a one-element int64 word on q's device
    or a Python int.  CUDA tensors launch ``csrc/flash_fwd.cu``
    (``flash_fwd.launches`` counts launches); CPU tensors take
    ``flash_fwd_plain``."""
    _check_fwd(q, k, v, kmask)
    word = _seed_word(seed, q.device, dropout)
    if not _on_card("flash_fwd", q):
        return flash_fwd_plain(q, k, v, scale, causal, kmask, word,
                               dropout)
    B, H, L, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    if B * H * L == 0:
        return out, lse
    lib, fn = _entry("flash_fwd", "flash_fwd_launch", 6)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kmask),
                 out.data_ptr(), lse.data_ptr(),
                 *_scalar_tail(q, k, kmask, scale, causal, word, dropout))
    _build.check(lib, err, "flash_fwd")
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


# --------------------------------------------------------------------------- #
# K2 / K3: flash backward (flash-attention-2, recompute from lse)
# --------------------------------------------------------------------------- #

def _bwd_probs(q, k, v, g, lse, delta, scale, causal, kmask, seed,
               dropout):
    """The backward's recomputed tiles, materialized: ``p`` (undropped),
    ``ds = p * (dp - delta)`` and the dropout keep mask (or None), with
    the reference kernels' semantics (f32 scores, key mask then causal
    mask at -1e30, the masked-probability guard, dp dropped and scaled
    by 1/(1-rate))."""
    B, H, Lq, _ = q.shape
    Lk = k.shape[2]
    s = torch.matmul(_wide(q), _wide(k).transpose(-1, -2)) * scale
    if kmask is not None:
        s = s + _wide(kmask).reshape(kmask.shape[0], 1, 1, Lk)
    bh, qpos, kpos = _positions(B, H, Lq, Lk, q.device)
    if causal:
        s = torch.where(qpos >= kpos, s, torch.full_like(s, _NEG_INF))
    p = torch.exp(s - lse[..., None])
    p = torch.where(s <= _NEG_INF * 0.5, torch.zeros_like(p), p)
    dp = torch.matmul(_wide(g), _wide(v).transpose(-1, -2))
    keep = None
    if dropout > 0.0:
        keep = _keep(seed, bh, qpos, kpos, dropout)
        dp = torch.where(keep, dp, torch.zeros_like(dp)) * \
            (1.0 / (1.0 - dropout))
    return p, p * (dp - delta[..., None]), keep


def flash_bwd_dq_plain(q, k, v, g, lse, delta, scale, causal, kmask=None,
                       seed=0, dropout=0.0):
    """Plain PyTorch version of K2: ``dq = scale * ds @ k``, f32 (f64
    for f64 inputs, as in every plain version here)."""
    _, ds, _ = _bwd_probs(q, k, v, g, lse, delta, scale, causal, kmask,
                          seed, dropout)
    return scale * torch.matmul(ds, _wide(k))


def flash_bwd_dkv_plain(q, k, v, g, lse, delta, scale, causal, kmask=None,
                        seed=0, dropout=0.0, need_dbias=False):
    """Plain PyTorch version of K3: ``(dk, dv, dbias)`` with ``dk = scale
    * ds^T @ q``, ``dv = p_drop^T @ g`` (f32) and, with ``need_dbias``,
    ``dbias = sum_q ds`` as (B, H, Lk) f32 (else None)."""
    p, ds, keep = _bwd_probs(q, k, v, g, lse, delta, scale, causal, kmask,
                             seed, dropout)
    if keep is not None:
        p = torch.where(keep, p, torch.zeros_like(p)) * \
            (1.0 / (1.0 - dropout))
    dv = torch.matmul(p.transpose(-1, -2), _wide(g))
    dk = scale * torch.matmul(ds.transpose(-1, -2), _wide(q))
    return dk, dv, (ds.sum(2) if need_dbias else None)


def _check_bwd(what, q, k, v, g, lse, delta, kmask):
    _check_fwd(q, k, v, kmask, what)
    if g.shape != q.shape or g.dtype != q.dtype:
        raise MXNetError(f"{what}: g {g.dtype} {tuple(g.shape)} must match "
                         f"q {q.dtype} {tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != _wide(q).dtype or t.shape != q.shape[:3]:
            raise MXNetError(f"{what}: {name} must be {_wide(q).dtype} "
                             f"{tuple(q.shape[:3])}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    _check_placed(what, q, g=g, lse=lse, delta=delta)


def flash_bwd_dq(q, k, v, g, lse, delta, scale, causal, kmask=None, seed=0,
                 dropout=0.0):
    """K2: dq of flash attention from the forward's ``lse`` and ``delta
    = rowsum(out * g)`` (both (B, H, L) f32).  Returns dq (B, H, L, D)
    f32.  CUDA tensors launch ``csrc/flash_bwd.cu`` (``flash_bwd_dq.
    launches`` counts launches); CPU tensors take ``flash_bwd_dq_plain``."""
    _check_bwd("flash_bwd_dq", q, k, v, g, lse, delta, kmask)
    word = _seed_word(seed, q.device, dropout)
    if not _on_card("flash_bwd_dq", q):
        return flash_bwd_dq_plain(q, k, v, g, lse, delta, scale, causal,
                                  kmask, word, dropout)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    if dq.numel() == 0:
        return dq
    lib, fn = _entry("flash_bwd", "flash_bwd_dq_launch", 8)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), _ptr(kmask),
                 dq.data_ptr(),
                 *_scalar_tail(q, k, kmask, scale, causal, word, dropout))
    _build.check(lib, err, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, g, lse, delta, scale, causal, kmask=None,
                  seed=0, dropout=0.0, need_dbias=False):
    """K3: dk, dv and (with ``need_dbias``) the key-mask gradient of
    flash attention.  Returns ``(dk, dv, dbias)``: dk/dv (B, H, Lk, D)
    f32, dbias (B, H, Lk) f32 or None.  CUDA tensors launch
    ``csrc/flash_bwd.cu`` (``flash_bwd_dkv.launches`` counts launches);
    CPU tensors take ``flash_bwd_dkv_plain``."""
    _check_bwd("flash_bwd_dkv", q, k, v, g, lse, delta, kmask)
    word = _seed_word(seed, q.device, dropout)
    if not _on_card("flash_bwd_dkv", q):
        return flash_bwd_dkv_plain(q, k, v, g, lse, delta, scale, causal,
                                   kmask, word, dropout, need_dbias)
    B, H, _, _ = q.shape
    Lk = k.shape[2]
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    dbias = torch.empty((B, H, Lk), dtype=torch.float32,
                        device=q.device) if need_dbias else None
    if dk.numel() == 0:
        return dk, dv, dbias
    lib, fn = _entry("flash_bwd", "flash_bwd_dkv_launch", 10)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), _ptr(kmask),
                 dk.data_ptr(), dv.data_ptr(), _ptr(dbias),
                 *_scalar_tail(q, k, kmask, scale, causal, word, dropout))
    _build.check(lib, err, "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv, dbias


flash_bwd_dkv.launches = 0


class _FlashAttention(torch.autograd.Function):
    """The reference's ``_flash`` custom VJP on the kernel path: forward
    K1 (saving q, k, v, the key mask, out and lse), backward ``delta =
    rowsum(out * g)`` in f32, then K2 and K3.  ``bias`` is a
    ``(B|1, 1, 1, Lk)`` key mask or None; its gradient is K3's dbias
    summed over heads (and over batch for a broadcast mask), returned
    only when the mask needs one."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, causal, seed, dropout):
        kmask = None if bias is None else bias.to(_wide(q).dtype).reshape(
            bias.shape[0], 1, bias.shape[3]).contiguous()
        # the seed word is saved, so the backward of a replay reads the
        # word that replay's forward read
        seed = _seed_word(seed, q.device, dropout)
        out, lse = flash_fwd(q, k, v, scale, causal, kmask, seed, dropout)
        ctx.save_for_backward(q, k, v, kmask, out, lse, seed)
        ctx.args = (scale, causal, dropout)
        ctx.bias_like = None if bias is None else (bias.shape, bias.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kmask, out, lse, seed = ctx.saved_tensors
        scale, causal, dropout = ctx.args
        need_q, need_k, need_v, need_bias = ctx.needs_input_grad[:4]
        g = g.to(q.dtype).contiguous()
        # delta_i = sum_d o_i * do_i (row-wise), the standard flash backward
        delta = (_wide(out) * _wide(g)).sum(-1)
        dq = dk = dv = dbias = None
        if need_q:
            dq = flash_bwd_dq(q, k, v, g, lse, delta, scale, causal, kmask,
                              seed, dropout).to(q.dtype)
        if need_k or need_v or need_bias:
            dk, dv, db = flash_bwd_dkv(q, k, v, g, lse, delta, scale,
                                       causal, kmask, seed, dropout,
                                       need_dbias=need_bias)
            dk, dv = dk.to(k.dtype), dv.to(v.dtype)
            if need_bias:
                shape, dtype = ctx.bias_like
                db = db.sum(1)                          # (B, Lk): heads
                if shape[0] == 1:
                    db = db.sum(0, keepdim=True)
                dbias = db.reshape(shape).to(dtype)
        return dq, dk, dv, dbias, None, None, None, None


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
    before the product.  Autograd differentiates it, so its backward
    runs the same f64 products (cheap at the lengths it serves)."""
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
    """Attention over (B, H, L, D) tensors, differentiable in q, k, v and
    ``bias``.  ``bias`` is an optional additive score bias broadcastable
    to (B, H, Lq, Lk).  ``dropout`` applies only with ``training=True``
    (None, as outside the reference's ``autograd.record``, is
    inference); its seed is ``random.attention_seed``'s device word, as
    the reference draws ``jax.random.bits(next_key())``: under a
    program's traced key a word derived on the device, else a draw of the
    host generator."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    rate = float(dropout) if training else 0.0
    seed = _random.attention_seed(q.device) if rate > 0.0 else 0
    Lq, Lk = q.shape[2], k.shape[2]
    if Lq * Lk <= _PLAIN_ATTN_MAX_SCORES or not (
            bias is None or (_is_kmask(bias) and bias.shape[3] == Lk)):
        return _plain_attn(q, k, v, bias, float(scale), bool(causal),
                           dropout=rate, seed=seed)
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), bias, float(scale),
                                 bool(causal), seed, rate)


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
