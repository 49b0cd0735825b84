"""KV-cache incremental decoding for the GPT and Llama families.

Port of ``mxnet_tpu/models/decoding.py``.  ``decode_mode`` returns the
string the reference's would ("fused", "stacked" or "unrolled", with the
same errors); what runs:

- "stacked" and "unrolled": PyTorch runs eagerly, so the reference's
  ``lax.scan`` over stacked layer weights and its unrolled per-layer step
  are one Python loop over the layers here (``_DecodeEngine.paged_step``),
  with the same math in the same order;
- "fused" (``fused="on"``): every layer of a step in ONE launch of kernel
  K5 (``ops.decode_fused.decode_step``) against a dense ``(NL, B, KV, T,
  D)`` cache and one shared position, as in the reference's
  ``fused_token``; the embeddings, ``ln_f``, the LM head and sampling stay
  outside the kernel.  The packed stream is cached on the model.

The rest of the engine:

- batched prefill (``_DecodeEngine.prefill``): one causal forward over a
  right-padded ``(B, P)`` prompt block through the ``flash_attention`` op
  (Llama: RoPE at offset 0, KV heads repeated over their query groups),
  logits gathered at each row's own last token, LM head native;
  ``prefill="scan"`` instead runs every prompt position through the step,
  teacher-forced;
- the per-token step against a PAGED K/V pool ``(NL, NPAGES + 1, KV, page,
  D)`` read through per-row page tables.  Index ``NPAGES`` is a trash
  page: the reference's one-past-the-end sentinel gathers zeros and drops
  scatters (``mode="fill"/"drop"``), which PyTorch cannot express without
  an out-of-range index (a device assert on CUDA).  Here every write
  lands somewhere legal, and the trash page is zeroed before each gather,
  so sentinel entries read zeros and writes through them vanish.  Llama
  rotates q and k at each row's own position; grouped-query scores run
  against the KV heads with no repeat;
- ``weights="int8"``: every decode projection and the LM head run
  ``q8_matvec`` (kernel K4) on per-output-channel int8 codes; the output
  is cast to the compute dtype and only then activated, as in the
  reference.  With ``fused="on"`` the layer stream is int8 codes inside K5
  and only the head runs K4;
- sampling: greedy is argmax.  Sampled draws cannot reproduce JAX's
  PRNG bits; they use Gumbel-max noise from a counter-based hash of
  ``(seed, position, token id)`` — no global RNG — so a served request
  reproduces ``kv_generate(seed=...)`` at batch 1, and both prefill modes
  draw alike.

``kv_generate`` runs the unfused step against a pool with one page per
row.

int8 K/V pages (the serving pool's ``kv_dtype="int8"``): a pool is a
``(codes, scales)`` pair, int8 codes ``(NL, NPAGES + 1, KV, page, D)``
and one f32 scale per (layer, page, KV head) ``(NL, NPAGES + 1, KV)``.
A step or chunk gathers the layer's pages dequantized to the compute
dtype, lands its own exact new columns in that dense view and attends,
then rewrites the touched pages through an f32 dequantization
(``_kv_step_rmw``, ``_kv_chunk_rmw``, ``_kv_verify_rmw``), each page's
old scale the new one's floor, as the reference does.
``pool_verify_paged`` scores a block of drafted tokens per slot
(speculative decoding).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..base import MXNetError
from ..ops.attention import _hash_bits, flash_attention, rope
from ..ops.decode_fused import (_quant_rows, decode_step,
                                fused_decode_supported, pack_gpt_weights,
                                pack_llama_weights, stacked_decode_supported)
from ..ops.nn import activation, embedding, fully_connected
from ..ops.q8_matvec import q8_matvec

__all__ = ["kv_generate", "decode_mode", "decode_step_program"]

_NEG_INF = -1e30
_GPT_PROJ = {"qkv": lambda b: b.attn.qkv, "proj": lambda b: b.attn.proj,
             "fc1": lambda b: b.ffn.fc1, "fc2": lambda b: b.ffn.fc2}
_LLAMA_PROJ = {"q": lambda b: b.attn.q_proj, "k": lambda b: b.attn.k_proj,
               "v": lambda b: b.attn.v_proj, "o": lambda b: b.attn.o_proj,
               "gate": lambda b: b.mlp.gate, "up": lambda b: b.mlp.up,
               "down": lambda b: b.mlp.down}


def _is_llama(model):
    return hasattr(model.blocks[0], "rms1")


def _head_weight(model):
    """The LM head (V, U): Llama's untied ``head``, GPT's tied ``wte``."""
    head = getattr(model, "head", None)
    return (head if head is not None else model.wte).weight


def _quantize_rows(w):
    """Per-output-channel symmetric int8: w (out, in) -> (codes (in, out)
    int8, pre-transposed for the kernel; f32 scales (out,))."""
    wq, s = _quant_rows(w)
    return wq.t().contiguous(), s


def _quantize_head(w, bias=None):
    """Head quantization with the vocab padded to a multiple of 128
    (codes 0, scale 1.0 in the padding; the caller slices the logits back
    to the true vocab).  Returns (codes, scales, f32 bias or None)."""
    wq, s = _quantize_rows(w)
    pad = (-wq.shape[1]) % 128
    if pad:
        wq = torch.nn.functional.pad(wq, (0, pad))
        s = torch.nn.functional.pad(s, (0, pad), value=1.0)
        if bias is not None:
            bias = torch.nn.functional.pad(bias.float(), (0, pad))
    return wq.contiguous(), s, None if bias is None else bias.float()


def _cached(model, attr, params, build, tag=None):
    """``build()`` cached on the model under ``attr``, rebuilt when any of
    ``params`` changed (its storage or its in-place version counter) or
    ``tag`` differs."""
    key = (tag,) + tuple((p.data_ptr(), p._version) for p in params)
    cache = model.__dict__.get(attr)
    if cache is not None and cache[0] == key:
        return cache[1]
    model.__dict__.pop(attr, None)          # free the stale value first
    with torch.no_grad():
        val = build()
    model.__dict__[attr] = (key, val)
    return val


def _q8_weights(model):
    """int8 codes for every decode projection and the LM head."""
    proj = _LLAMA_PROJ if _is_llama(model) else _GPT_PROJ

    def build():
        layers = []
        for blk in model.blocks:
            ent = {}
            for kind, get in proj.items():
                lyr = get(blk)
                wq, s = _quantize_rows(lyr.weight)
                b = None if lyr.bias is None else lyr.bias.float()
                ent[kind] = (wq, s, b)
            layers.append(ent)
        return {"layers": layers, "head": _quantize_head(_head_weight(model))}

    return _cached(model, "_q8_cache", list(model.parameters()), build)


def _q8_head(model):
    """int8 codes of the LM head alone (the fused int8 step's head)."""
    w = _head_weight(model)
    return _cached(model, "_q8_head_cache", [w],
                   lambda: _quantize_head(w))


def _fused_pack(model, quant):
    """K5's packed stream of ``model`` (six-tuple), cached on the model."""
    if _is_llama(model):
        def build():
            return pack_llama_weights(model.blocks, model._cfg, model.dtype,
                                      quant)
    else:
        def build():
            return pack_gpt_weights(model.blocks, model.dtype, quant)
    return _cached(model, "_fused_pack_cache",
                   [p for blk in model.blocks for p in blk.parameters()],
                   build, tag=bool(quant))


# the int8 page pair's dtypes: codes, and one scale a (layer, page, head)
_KV_CODE_DTYPE = torch.int8
_KV_SCALE_DTYPE = torch.float32


def _kv_dequant(codes, scales, dtype):
    """int8 page codes -> ``dtype`` values: ``codes * scale``, the f32
    scale of each (page, head) broadcast over the trailing ``(page, D)``
    axes.  Zero codes and a zero scale (the trash page) give zeros."""
    return (codes.to(_KV_SCALE_DTYPE) * scales[..., None, None]).to(dtype)


def _kv_requant(vals, floor_scales):
    """Symmetric int8 quantization of ``vals`` over its trailing ``(page,
    D)`` axes: scale ``max(max(amax / 127, floor), 1e-8)``, codes
    ``round(v / scale)`` (half to even).  ``floor_scales`` (the page's
    old scales, or ``0.0`` for fresh pages) keeps a rewrite lossless for
    columns it does not touch: when the range does not grow, every old
    code maps to itself.  Both quotients are true divisions by a tensor
    (a CUDA division by a Python number multiplies by its reciprocal)."""
    v32 = vals.to(_KV_SCALE_DTYPE)
    amax = v32.abs().amax(dim=(-2, -1))
    s = amax / torch.full_like(amax, 127.0)
    if torch.is_tensor(floor_scales):
        s = torch.maximum(s, floor_scales)
    else:
        s = torch.clamp(s, min=float(floor_scales))
    s = torch.clamp(s, min=1e-8)
    codes = torch.round(v32 / s[..., None, None]).to(_KV_CODE_DTYPE)
    return codes, s


def _zero_trash(pool):
    """Zero the trash page of an int8 pool, codes and scales, so that
    sentinel entries gather zeros (the reference's ``mode="fill"``)."""
    codes, scales = pool
    codes[:, -1].zero_()
    scales[:, -1].zero_()


def _kv_step_rmw(pool, pg, iB, offs, newcol):
    """The step's requantizing page rewrite, in place: gather each row's
    frontier page ``pg[b]`` (codes and scale), dequantize to f32, land
    row ``b``'s new column ``newcol[b]`` (NL, KV, D) at page offset
    ``offs[b]``, requantize with the old scale as floor and scatter
    codes and scales back.  Sentinel rows gather zeros and write the
    trash page.  Returns the pool."""
    codes, scales = pool
    _zero_trash(pool)
    old_s = scales[:, pg]                               # (NL, B, KV)
    vals = _kv_dequant(codes[:, pg], old_s, torch.float32)
    vals[:, iB, :, offs, :] = newcol.to(torch.float32)  # (B, NL, KV, D)
    q, s = _kv_requant(vals, old_s)
    codes[:, pg] = q
    scales[:, pg] = s
    return pool


def _window(win, lead, ntp, page):
    """(NL, *lead, NTP, KV, page, D) pages -> (NL, *lead, KV, NTP * page
    + 1, D) columns, the last one a drop slot for out-of-window writes."""
    nl, kv, d = win.shape[0], win.shape[-3], win.shape[-1]
    n = len(lead)
    flat = win.movedim(n + 2, n + 1).reshape((nl,) + lead +
                                             (kv, ntp * page, d))
    return torch.nn.functional.pad(flat, (0, 0, 0, 1))


def _unwindow(flat, lead, ntp, page):
    nl, kv, d = flat.shape[0], flat.shape[-3], flat.shape[-1]
    n = len(lead)
    return flat[..., :ntp * page, :].reshape(
        (nl,) + lead + (kv, ntp, page, d)).movedim(n + 1, n + 2)


def _kv_chunk_rmw(pool, wpgs, loc, new_cd, page, ntp):
    """The chunk's requantizing page-window rewrite, in place: the
    chunk's columns touch at most ``ntp`` consecutive pages ``wpgs``
    (NTP,) of one row; gather them, dequantize, land ``new_cd`` (NL, KV,
    C, D) at window offsets ``loc`` (C,) (``ntp * page``: dropped),
    requantize each page with its old scale as floor, scatter back."""
    codes, scales = pool
    _zero_trash(pool)
    old_s = scales[:, wpgs]                             # (NL, NTP, KV)
    win = _kv_dequant(codes[:, wpgs], old_s, torch.float32)
    flat = _window(win, (), ntp, page)                  # (NL, KV, W+1, D)
    flat[:, :, loc, :] = new_cd.to(torch.float32)
    q, s = _kv_requant(_unwindow(flat, (), ntp, page), old_s)
    codes[:, wpgs] = q
    scales[:, wpgs] = s
    return pool


def _kv_verify_rmw(pool, wpgs, iB, loc, new_bd, page, ntp):
    """``_kv_chunk_rmw`` batched over slots, in place: slot ``b``'s
    block lands in its window pages ``wpgs[b]`` at offsets ``loc[b]``;
    ``new_bd`` is (B, C, NL, KV, D).  As in the reference, every column
    of the block is quantized before acceptance is known, so a rejected
    draft can ratchet its page's scale (PARITY.md)."""
    codes, scales = pool
    _zero_trash(pool)
    old_s = scales[:, wpgs]                             # (NL, B, NTP, KV)
    win = _kv_dequant(codes[:, wpgs], old_s, torch.float32)
    B = wpgs.shape[0]
    flat = _window(win, (B,), ntp, page)                # (NL, B, KV, W+1, D)
    flat[:, iB[:, None], :, loc, :] = new_bd.to(torch.float32)
    q, s = _kv_requant(_unwindow(flat, (B,), ntp, page), old_s)
    codes[:, wpgs] = q
    scales[:, wpgs] = s
    return pool


def _check_args(prefill, weights, fused, stacked):
    """The reference's argument validation (ValueError on a bad value)."""
    if prefill not in ("batched", "scan"):
        raise ValueError(f"prefill must be 'batched' or 'scan', "
                         f"got {prefill!r}")
    if weights not in ("native", "int8"):
        raise ValueError(f"weights must be 'native' or 'int8', "
                         f"got {weights!r}")
    if fused not in ("auto", "on", "off"):
        raise ValueError(f"fused must be 'auto', 'on' or 'off', "
                         f"got {fused!r}")
    if stacked not in ("auto", "on", "off"):
        raise ValueError(f"stacked must be 'auto', 'on' or 'off', "
                         f"got {stacked!r}")


def _check_weights(weights):
    if weights not in ("native", "int8"):
        raise MXNetError(f"weights must be 'native' or 'int8', "
                         f"got {weights!r}")


def decode_mode(model, batch=1, total=32, weights="native", fused="auto",
                stacked="auto"):
    """The per-token step ``kv_generate`` runs: ``"fused"`` |
    ``"stacked"`` | ``"unrolled"``, as the reference decides it.

    ``fused="on"`` requires K5 (raises ``MXNetError`` when its gate —
    batch ≤ 4, bf16, tileable dims, the card kernel's limits — rejects
    the config, or with ``stacked="on"``); ``"auto"``/``"off"`` never
    select it.  ``stacked="on"`` requires a stackable layer stack;
    ``MXNET_STACKED_DECODE=0`` disables "stacked" (and conflicts with
    ``stacked="on"``).  The port runs one eager layer loop for both
    "stacked" and "unrolled"."""
    _check_args("batched", weights, fused, stacked)
    if fused == "on":
        if stacked == "on":
            raise MXNetError("stacked='on' conflicts with fused='on' — the "
                             "fused kernel replaces the layer loop entirely")
        ok = fused_decode_supported(model._cfg, batch, total, model.dtype)
        if ok and not _is_llama(model):
            ok = model.blocks[0].ffn.fc1.act_type in (None, "gelu", "relu")
        if not ok:
            raise MXNetError(
                "fused='on' but the fused decode kernel does not support "
                "this model/batch/dtype (see ops/decode_fused.py "
                "fused_decode_supported)")
        return "fused"
    env_on = os.environ.get("MXNET_STACKED_DECODE", "1") != "0"
    if stacked == "on":
        if not env_on:
            raise MXNetError("stacked='on' but MXNET_STACKED_DECODE=0 "
                             "disables the stacked decode path")
        if not stacked_decode_supported(model):
            raise MXNetError(
                "stacked='on' but this model's layer stack cannot be "
                "stacked (non-uniform geometry/eps/activation or an "
                "unrecognized block family — see ops/decode_fused.py "
                "stacked_decode_supported)")
        return "stacked"
    if stacked == "auto" and env_on and stacked_decode_supported(model):
        return "stacked"
    return "unrolled"


class _DecodeEngine:
    """Prepared weights plus the prefill and per-token step bodies for one
    model, one weight mode and one sampler setting.  Batch-size free: the
    serving pool of every size shares one engine.  ``fused`` prepares
    K5's packed stream (and, for int8, only the head's codes)."""

    def __init__(self, model, temperature=0.0, top_k=0, weights="native",
                 fused=False):
        _check_weights(weights)
        cfg = model._cfg
        self.model, self.cfg = model, cfg
        self.temperature, self.top_k = float(temperature), int(top_k)
        self.is_llama = _is_llama(model)
        self.NL = len(model.blocks)
        self.H = cfg.num_heads
        self.KV = cfg.num_kv_heads if self.is_llama else self.H
        self.U = cfg.units
        self.D = self.U // self.H
        self.vocab = cfg.vocab_size
        self.scale = 1.0 / (self.D ** 0.5)
        self.rope_base = float(getattr(cfg, "rope_base", 10000.0))
        self.cdtype = model.dtype
        self.device = model.device
        blk = model.blocks[0]
        self.act_t = None if self.is_llama else blk.ffn.fc1.act_type
        norms = (blk.rms1, blk.rms2) if self.is_llama else (blk.ln1, blk.ln2)
        self.norm_eps = tuple(float(n.eps) for n in norms)
        self.proj = _LLAMA_PROJ if self.is_llama else _GPT_PROJ
        self.q8 = self.packed = None
        if fused:
            self.packed = _fused_pack(model, weights == "int8")
            if weights == "int8":
                self.q8 = {"head": _q8_head(model)}
        elif weights == "int8":
            self.q8 = _q8_weights(model)

    # -- layers ---------------------------------------------------------- #
    def _lin(self, x, i, kind, act_type=None):
        """One decode projection: ``q8_matvec`` -> cast -> activation in
        int8 mode, the model's own dense math otherwise."""
        if self.q8 is not None:
            y = q8_matvec(x, *self.q8["layers"][i][kind]).to(self.cdtype)
        else:
            lyr = self.proj[kind](self.model.blocks[i])
            y = fully_connected(x, lyr.weight, lyr.bias)
        return activation(y, act_type) if act_type else y

    def head_logits(self, xl, q8=True):
        """ln_f output (B, U) -> f32 logits (B, V).  The prefill passes
        ``q8=False``: its head is always native, as in the reference."""
        if q8 and self.q8 is not None:
            return q8_matvec(xl.contiguous(), *self.q8["head"])[:, :self.vocab]
        return torch.matmul(xl, _head_weight(self.model).t()).float()

    def embed(self, tok, pos):
        x = embedding(tok, self.model.wte.weight)
        if not self.is_llama:
            x = x + embedding(pos, self.model.wpe.weight)
        return x

    # -- prefill --------------------------------------------------------- #
    @torch.no_grad()
    def prefill(self, prompts, last_index=None):
        """One causal forward over ``prompts`` (B, P) int64.  Returns
        (f32 logits (B, V) at each row's ``last_index`` — default P - 1 —,
        K and V of every layer as (NL, B, KV, P, D))."""
        m = self.model
        B, P = prompts.shape
        U, H, KV, D = self.U, self.H, self.KV, self.D
        pos = torch.arange(P, device=prompts.device)
        x = embedding(prompts, m.wte.weight)
        if not self.is_llama:
            x = x + embedding(pos, m.wpe.weight)[None]
        ks, vs = [], []
        for blk in m.blocks:
            if self.is_llama:
                h = blk.rms1(x)
                a = blk.attn
                q, k, v = (lyr(h).reshape(B, P, n, D).permute(0, 2, 1, 3)
                           for lyr, n in ((a.q_proj, H), (a.k_proj, KV),
                                          (a.v_proj, KV)))
                q = rope(q, base=self.rope_base)
                k = rope(k, base=self.rope_base)
            else:
                h = blk.ln1(x)
                qkv = blk.attn.qkv(h)                          # (B, P, 3U)
                q, k, v = (qkv[..., j * U:(j + 1) * U].reshape(B, P, H, D)
                           .permute(0, 2, 1, 3) for j in range(3))
            ks.append(k)
            vs.append(v)
            if KV != H:       # each KV head serves a group of query heads
                k = k.repeat_interleave(H // KV, dim=1)
                v = v.repeat_interleave(H // KV, dim=1)
            o = flash_attention(q, k, v, None, scale=self.scale,
                                causal=True)
            o = o.permute(0, 2, 1, 3).reshape(B, P, U)
            if self.is_llama:
                x = x + blk.attn.o_proj(o)
                x = x + blk.mlp(blk.rms2(x))
            else:
                x = x + blk.attn.proj(o)
                # the FFN's own projections: no dropout while serving
                x = x + blk.ffn.fc2(blk.ffn.fc1(blk.ln2(x)))
        if last_index is None:
            x_last = x[:, -1]
        else:
            li = torch.as_tensor(last_index, device=x.device).long()
            x_last = x[torch.arange(B, device=x.device), li]
        logits = self.head_logits(m.ln_f(x_last), q8=False)
        return logits, torch.stack(ks), torch.stack(vs)

    # -- the per-token steps --------------------------------------------- #
    def _attend(self, q, kc, vc, live):
        """Grouped-query attention of q (B, H, D) against the KV-head
        caches (B, KV, T, D); ``live`` (B, 1, 1, T) masks later positions.
        p·V: the reference sums in f32 and rounds once.  Here the exact
        bf16/f32 products are summed in f64 before that one rounding, so
        the result does not depend on the cache horizon T or on how the
        library splits the sum: a served row and the same row of
        kv_generate round alike."""
        B, H, D = q.shape
        qg = q.reshape(B, self.KV, H // self.KV, D)
        s = torch.matmul(qg.float(), kc.float().transpose(-1, -2)) * \
            self.scale                                      # (B, KV, G, T)
        s = torch.where(live, s, torch.full_like(s, _NEG_INF))
        p = torch.softmax(s, dim=-1).to(self.cdtype)
        o = torch.matmul(p.double(), vc.double()).to(self.cdtype)
        return o.reshape(B, H * D)

    def _mlp(self, blk, i, x, o):
        """The rest of a layer after attention: output projection and
        residual, norm, MLP and residual (``x``, ``o`` (N, U))."""
        if self.is_llama:
            x = x + self._lin(o, i, "o")
            h2 = blk.rms2(x)
            if self.q8 is not None:
                # SwiGLU decomposed, as the reference's int8 arm
                g = self._lin(h2, i, "gate")
                return x + self._lin(g * torch.sigmoid(g) *
                                     self._lin(h2, i, "up"), i, "down")
            return x + blk.mlp(h2)
        x = x + self._lin(o, i, "proj")
        h2 = blk.ln2(x)
        return x + self._lin(self._lin(h2, i, "fc1", self.act_t), i, "fc2")

    def _qkv(self, blk, i, x, pos, n):
        """q (N, H, n, D), k and v (N, KV, n, D) of the rows ``x`` (N * n,
        U): ``n`` consecutive positions a row from ``pos`` (a host int
        or (N,)), Llama's rotated."""
        U, H, KV, D = self.U, self.H, self.KV, self.D
        N = x.shape[0] // n
        if self.is_llama:
            h = blk.rms1(x)
            q, k, v = (self._lin(h, i, kind).reshape(N, n, nh, D)
                       .transpose(1, 2)
                       for kind, nh in (("q", H), ("k", KV), ("v", KV)))
            q = rope(q, base=self.rope_base, position_offset=pos)
            k = rope(k, base=self.rope_base, position_offset=pos)
            return q, k, v
        qkv = self._lin(blk.ln1(x), i, "qkv")                  # (N n, 3U)
        return tuple(qkv[:, j * U:(j + 1) * U].reshape(N, n, H, D)
                     .transpose(1, 2) for j in range(3))

    def _view(self, pool, i, pt):
        """Layer ``i``'s pages through the table ``pt`` (B, P) as dense
        (B, KV, P * page, D) views in the compute dtype (an int8 pool
        dequantized), the trash page zeroed first."""
        if isinstance(pool, tuple):
            codes, scales = pool
            codes[i, -1].zero_()
            scales[i, -1].zero_()
            g = _kv_dequant(codes[i][pt], scales[i][pt], self.cdtype)
        else:
            pool[i, -1].zero_()
            g = pool[i][pt]
        B, P, KV, page, D = g.shape
        return g.permute(0, 2, 1, 3, 4).reshape(B, KV, P * page, D)

    @torch.no_grad()
    def paged_step(self, tok, pos, kp, vp, pt, page):
        """Token ``tok`` (B,) at per-row position ``pos`` (B,) -> f32
        logits (B, V).  Writes the new K/V columns into the pools ``kp``,
        ``vp`` (NL, NPAGES + 1, KV, page, D) in place through the page
        table ``pt`` (B, MAXP) int64, whose entries equal to NPAGES are
        the trash page.  An int8 pool (a ``(codes, scales)`` pair) is
        read dequantized to the compute dtype with the step's exact new
        column landed in the view; its frontier pages are requantized
        after the last layer (``_kv_step_rmw``), as in the reference."""
        m = self.model
        B = tok.shape[0]
        quant = isinstance(kp, tuple)
        maxp = pt.shape[1]
        T = maxp * page
        iB = torch.arange(B, device=tok.device)
        pg = pt[iB, torch.clamp(pos // page, max=maxp - 1)]
        off = pos % page
        vpos = torch.clamp(pos, max=T - 1)
        live = torch.arange(T, device=tok.device)[None, None, None, :] <= \
            pos[:, None, None, None]                        # (B, 1, 1, T)
        x = self.embed(tok, pos)
        cols = ([], [])
        for i, blk in enumerate(m.blocks):
            q, k, v = (t[:, :, 0] for t in self._qkv(blk, i, x, pos, 1))
            views = []
            for pool, new, col in ((kp, k, cols[0]), (vp, v, cols[1])):
                if quant:
                    view = self._view(pool, i, pt)
                    view[iB, :, vpos] = new     # the exact column
                    col.append(new)
                else:
                    pool[i][pg, :, off] = new   # the new column first ...
                    view = self._view(pool, i, pt)  # ... trash zeroed
                views.append(view)
            x = self._mlp(blk, i, x, self._attend(q, views[0], views[1],
                                                  live))
        if quant:
            for pool, col in ((kp, cols[0]), (vp, cols[1])):
                _kv_step_rmw(pool, pg, iB, off, torch.stack(col, 1))
        return self.head_logits(m.ln_f(x))

    def _block(self, toks, pos, kp, vp, pt, page, nlast=None):
        """The pass a chunk and a verify share: a block ``toks`` (B, C) a
        row at absolute positions ``pos[b] .. pos[b] + C - 1`` through
        the page-table rows ``pt`` (B, MAXP).  Per layer each row's pages
        are gathered into a dense (KV, T, D) view, the block's K/V lands
        in it before attention (a column at or past ``T`` in a drop
        column past the view, never clamped onto a live one), and one
        mask ``t <= pos[b] + j`` covers the cached prefix and the block's
        own causality.  The block's columns go to the pages through the
        rows (past ``T`` or the reserved pages: the trash page): written
        per layer in a native pool; requantized after the last layer in
        an int8 pool, a chunk's columns past ``nlast`` left out (they
        would raise their page's scale).  Returns the hidden states (B C,
        U) before ``ln_f``."""
        m = self.model
        B, C = toks.shape
        U, H, KV, D = self.U, self.H, self.KV, self.D
        G = H // KV
        quant = isinstance(kp, tuple)
        trash = (kp[0] if quant else kp).shape[1] - 1
        maxp = pt.shape[1]
        T = maxp * page
        dev = toks.device
        iB = torch.arange(B, device=dev)
        cpos = pos[:, None] + torch.arange(C, device=dev)   # (B, C)
        inside = cpos < T
        wpos = torch.where(inside, cpos, torch.full_like(cpos, T))
        # one trash page more a row: the view's drop columns
        ptx = torch.cat([pt, torch.full((B, 1), trash, dtype=pt.dtype,
                                        device=dev)], 1)
        x = embedding(toks.reshape(-1), m.wte.weight)       # (B C, U)
        if not self.is_llama:
            # columns past the table read its last row: never attended
            wp = m.wpe.weight
            x = x + embedding(torch.clamp(cpos, max=wp.shape[0] - 1)
                              .reshape(-1), wp)
        live = torch.arange(T, device=dev)[None, None] <= cpos[:, :, None]
        pgs = torch.where(inside, pt[iB[:, None],
                                     torch.clamp(cpos // page, max=maxp - 1)],
                          torch.full_like(cpos, trash))
        offs = cpos % page
        cols = ([], [])
        for i, blk in enumerate(m.blocks):
            q, k, v = self._qkv(blk, i, x, pos, C)          # (B, n, C, D)
            views = []
            for pool, new, col in ((kp, k, cols[0]), (vp, v, cols[1])):
                new = new.transpose(1, 2)                   # (B, C, KV, D)
                view = self._view(pool, i, ptx)
                view[iB[:, None], :, wpos] = new
                views.append(view[:, :, :T])
                if quant:
                    col.append(new)
                else:
                    pool[i][pgs, :, offs] = new
            qg = q.reshape(B, KV, G, C, D)
            s = torch.matmul(qg.float(), views[0].float()[:, :, None]
                             .transpose(-1, -2)) * self.scale  # (B,KV,G,C,T)
            s = torch.where(live[:, None, None], s,
                            torch.full_like(s, _NEG_INF))
            p = torch.softmax(s, dim=-1).to(self.cdtype)
            # p.V summed in f64 and rounded once, as in ``_attend``
            o = torch.matmul(p.double(), views[1].double()[:, :, None]) \
                .to(self.cdtype)
            o = o.permute(0, 3, 1, 2, 4).reshape(B * C, U)
            x = self._mlp(blk, i, x, o)
        if quant:
            ntp = (C + page - 2) // page + 1
            p0 = pos // page
            widx = p0[:, None] + torch.arange(ntp, device=dev)
            wpgs = torch.where(
                widx < maxp, pt[iB[:, None], torch.clamp(widx, max=maxp - 1)],
                torch.full_like(widx, trash))               # (B, NTP)
            keep = inside if nlast is None else \
                inside & (torch.arange(C, device=dev) <= nlast)[None]
            loc = torch.where(keep, cpos - p0[:, None] * page,
                              torch.full_like(cpos, ntp * page))
            for pool, col in ((kp, cols[0]), (vp, cols[1])):
                new = torch.stack(col, 2)                   # (B, C, NL, KV, D)
                if nlast is None:
                    _kv_verify_rmw(pool, wpgs, iB, loc, new, page, ntp)
                else:
                    _kv_chunk_rmw(pool, wpgs[0], loc[0],
                                  new[0].permute(1, 2, 0, 3), page, ntp)
        return x

    @torch.no_grad()
    def chunk_tokens(self, toks, off, nlast, ptrow, kp, vp, page):
        """One chunk of one sequence's prefill against the paged pool
        (chunked prefill, and the prefix cache's suffix fill): ``toks``
        (C,) int64 at absolute positions ``off .. off + C - 1`` of the
        slot whose page-table row is ``ptrow`` (MAXP,) int64, through
        ``_block``.  Returns the f32 logits (1, V) at ``off + nlast``,
        from the native head, as the batched prefill's.  ``off`` and
        ``nlast`` are host ints.  In int8 every projection runs
        ``q8_matvec`` on the (C, U) rows; Llama's SwiGLU is then
        decomposed, as in ``paged_step``."""
        pos = torch.full((1,), off, dtype=torch.int64, device=toks.device)
        x = self._block(toks[None], pos, kp, vp, ptrow[None], page, nlast)
        return self.head_logits(self.model.ln_f(x[nlast:nlast + 1]),
                                q8=False)

    @torch.no_grad()
    def pool_verify_paged(self, toks, pos, kp, vp, pt, page):
        """Draft-and-verify scoring against the paged pool (speculative
        decoding): slot ``b``'s block ``toks[b]`` (C,) holds its last
        emitted token (column 0, not yet attended) and C - 1 drafts, at
        positions ``pos[b] .. pos[b] + C - 1``; ONE pass over all layers
        (``_block``) gives the f32 logits (B, C, V) of every column from
        the step's own head (K4 in int8), so ``argmax`` of column j is the
        token the plain step would emit after position ``pos[b] + j``.
        The block's K/V stays in the pages: a rejected tail lies past the
        slot's advanced position, masked and later overwritten."""
        B, C = toks.shape
        x = self._block(toks, pos, kp, vp, pt, page)
        return self.head_logits(self.model.ln_f(x)).reshape(B, C, -1)

    @torch.no_grad()
    def fused_step(self, tok, t, kc, vc):
        """Token ``tok`` (B,) at the shared position ``t`` -> f32 logits
        (B, V): the embeddings, then every layer in one K5 launch against
        the dense caches ``kc``/``vc`` (NL, B, KV, T, D) (new column
        written in place), then ``ln_f`` and the head (K4 with int8)."""
        pos = torch.full((tok.shape[0],), int(t), dtype=torch.int64,
                         device=tok.device)
        x = self.embed(tok, pos).contiguous()
        x, _, _ = decode_step(int(t), x, self.packed, kc, vc, self.cfg,
                              self.act_t, self.norm_eps[0])
        return self.head_logits(self.model.ln_f(x))

    # -- sampling -------------------------------------------------------- #
    def _sample_logits(self, logits):
        """Temperature / top-k preparation shared by the offline and the
        served sampler; ``None`` means greedy."""
        if self.temperature == 0.0:
            return None
        lg = logits / max(self.temperature, 1e-6)
        if self.top_k and self.top_k < lg.shape[-1]:
            kth = torch.topk(lg, self.top_k, dim=-1).values[:, -1]
            lg = torch.where(lg < kth[:, None],
                             torch.full_like(lg, float("-inf")), lg)
        return lg

    def sample(self, logits, seeds, pos):
        """Next token per row: argmax when greedy, else Gumbel-max with
        noise keyed on (seed[b], pos[b], token id) only — the draw of one
        row never depends on its batch neighbours."""
        lg = self._sample_logits(logits)
        if lg is None:
            return torch.argmax(logits, dim=-1)
        V = lg.shape[-1]
        bits = _hash_bits(seeds[:, None], pos[:, None],
                          torch.arange(V, device=lg.device)[None], 0x5EED)
        u = (bits.double() + 0.5) / 4294967296.0
        gumbel = -torch.log(-torch.log(u))
        return torch.argmax(lg.double() + gumbel, dim=-1)


def kv_generate(model, prompt_tokens, max_new_tokens=32, temperature=1.0,
                top_k=0, seed=0, prefill="batched", weights="native",
                fused="auto", stacked="auto"):
    """Continue a (B, P) prompt by ``max_new_tokens`` tokens; returns the
    (B, P + max_new_tokens) int32 numpy array.  Greedy when
    ``temperature == 0``; otherwise seeded sampling (``top_k > 0``
    restricts it), deterministic given ``seed``.

    ``prefill``: ``"batched"`` (one causal forward fills the cache) or
    ``"scan"`` (every prompt position through the step, teacher-forced).
    ``weights="int8"`` streams the decode projections and the head as
    int8.  ``fused="on"`` runs each step's layers in one K5 launch
    (``decode_mode`` raises where its gate refuses); ``"auto"``/``"off"``
    never select it.  ``stacked`` is accepted with the reference's values
    and checks; "stacked" and "unrolled" run the same eager layer loop
    here.  Hidden states of the fused step can differ from the unfused
    step by about one bf16 ulp (the fc2/down sum is rounded once, after
    the bias)."""
    _check_args(prefill, weights, fused, stacked)
    prompt = np.asarray(prompt_tokens, dtype=np.int64)
    if prompt.ndim == 1:
        prompt = prompt[None]
    B, P = prompt.shape
    if max_new_tokens <= 0:
        return prompt.astype(np.int32)
    total = P + max_new_tokens
    if total > model._cfg.max_length:
        raise ValueError(f"prompt+new = {total} exceeds max_length "
                         f"{model._cfg.max_length}")
    mode = decode_mode(model, B, total, weights, fused, stacked)
    eng = _DecodeEngine(model, temperature, top_k, weights,
                        fused=mode == "fused")
    dev = eng.device
    prompts = torch.as_tensor(prompt, device=dev)
    seeds = torch.full((B,), int(seed), dtype=torch.int64, device=dev)
    if mode == "fused":
        shape = (eng.NL, B, eng.KV, total, eng.D)
        kc = torch.zeros(shape, dtype=eng.cdtype, device=dev)
        vc = torch.zeros(shape, dtype=eng.cdtype, device=dev)
        cache = (kc, vc)

        def step(tok, t):
            return eng.fused_step(tok, t, kc, vc)
    else:
        # one page of ``total`` positions per row, plus the trash page
        shape = (eng.NL, B + 1, eng.KV, total, eng.D)
        kp = torch.zeros(shape, dtype=eng.cdtype, device=dev)
        vp = torch.zeros(shape, dtype=eng.cdtype, device=dev)
        cache = (kp[:, :B], vp[:, :B])
        pt = torch.arange(B, device=dev)[:, None]

        def step(tok, t):
            pos = torch.full((B,), t, dtype=torch.int64, device=dev)
            return eng.paged_step(tok, pos, kp, vp, pt, total)

    def draw(logits, t):
        return eng.sample(logits, seeds, torch.full(
            (B,), t, dtype=torch.int64, device=dev))

    out = []
    if prefill == "batched":
        logits, knew, vnew = eng.prefill(prompts)
        cache[0][:, :, :, :P] = knew
        cache[1][:, :, :, :P] = vnew
        tok = draw(logits, P - 1)
        out.append(tok)
        for t in range(P, total - 1):
            tok = draw(step(tok, t), t)
            out.append(tok)
    else:
        tok = prompts[:, 0]
        for t in range(total - 1):
            cur = prompts[:, t] if t < P else tok
            tok = draw(step(cur, t), t)
            if t >= P - 1:
                out.append(tok)
    new = torch.stack(out, dim=1).cpu().numpy()
    return np.concatenate([prompt, new], axis=1).astype(np.int32)


class _StepProgram:
    """One decode step of ``kv_generate``'s engine as a program:
    ``step(tok, pos, ck, cv, seed) -> (next_tok, ck, cv)``.  The
    arguments are copied into the program's static operands (the caches
    only when they are not the program's own, ``example_args``'); the
    step runs ``program``, a ``gluon.block._GraphProgram`` watched by the
    telemetry capture watch (site ``models.decode_step``), and writes the
    new K/V column into the caches in place."""

    def __init__(self, program, tok, pos, seed, ck, cv):
        self.program = program
        self._tok, self._pos, self._seed = tok, pos, seed
        self.ck, self.cv = ck, cv

    def __call__(self, tok, pos, ck, cv, seed):
        B = self._tok.shape[0]
        self._tok.copy_(torch.as_tensor(tok).reshape(B))
        self._pos.copy_(torch.as_tensor(pos).expand(B))
        self._seed.fill_(int(seed))
        for mine, given in ((self.ck, ck), (self.cv, cv)):
            if given is not mine:
                mine.copy_(given)
        nxt = self.program()[0]
        return nxt, self.ck, self.cv


def decode_step_program(model, batch=1, total=32, temperature=0.0,
                        top_k=0, weights="native", fused="auto",
                        stacked="auto", seed=0):
    """ONE decode step as a ``(fn, example_args)`` pair (reference
    ``decode_step_program``): ``fn(tok (B,), pos, ck, cv, seed)`` ->
    ``(next_tok (B,), ck, cv)`` for a token at position ``pos`` against
    ``total``-position caches ``ck``/``cv`` (NL, B, KV, total, D), the
    step ``kv_generate`` runs a token (``_DecodeEngine.paged_step`` and
    its sampler).  ``fn.program`` is the ``gluon.block._GraphProgram``
    (captured at its second call on the card); its kernel nodes
    (``fn.program.kernel_nodes()``) are the per-step unit the
    reference's op counts measure in HLO ops.  K5's step takes its
    position as a host integer, so ``fused="on"`` is not one program
    here and raises."""
    from .. import telemetry
    from ..gluon.block import _GraphProgram

    mode = decode_mode(model, batch, total, weights, fused, stacked)
    if mode == "fused":
        raise MXNetError("decode_step_program: the fused step (K5) takes "
                         "its position as a host integer, so it is no "
                         "program with the position as an operand; use "
                         "fused='off'")
    eng = _DecodeEngine(model, temperature, top_k, weights)
    dev, B = eng.device, int(batch)
    # one page of ``total`` positions a row, plus the trash page
    shape = (eng.NL, B + 1, eng.KV, total, eng.D)
    kp = torch.zeros(shape, dtype=eng.cdtype, device=dev)
    vp = torch.zeros(shape, dtype=eng.cdtype, device=dev)
    pt = torch.arange(B, device=dev)[:, None]
    tok = torch.zeros((B,), dtype=torch.int64, device=dev)
    pos = torch.zeros((B,), dtype=torch.int64, device=dev)
    seeds = torch.zeros((B,), dtype=torch.int64, device=dev)

    def fn():
        return [eng.sample(eng.paged_step(tok, pos, kp, vp, pt, total),
                           seeds, pos)]

    item = torch.empty((), dtype=eng.cdtype).element_size()
    prog = telemetry.instrument_program(
        _GraphProgram(fn, dev, None, [tok, pos, seeds]),
        "models.decode_step", key=(B, total, weights, mode),
        fields={"mode": mode, "batch": B,
                "cache_bytes": 2 * eng.NL * B * eng.KV * total * eng.D *
                item})
    step = _StepProgram(prog, tok, pos, seeds, kp[:, :B], vp[:, :B])
    args = (torch.zeros((B,), dtype=torch.int64, device=dev),
            max(total - 2, 0), step.ck, step.cv, int(seed))
    return step, args
