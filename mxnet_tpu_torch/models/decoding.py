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

__all__ = ["kv_generate", "decode_mode"]

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

    @torch.no_grad()
    def paged_step(self, tok, pos, kp, vp, pt, page):
        """Token ``tok`` (B,) at per-row position ``pos`` (B,) -> f32
        logits (B, V).  Writes the new K/V columns into the pools ``kp``,
        ``vp`` (NL, NPAGES + 1, KV, page, D) in place through the page
        table ``pt`` (B, MAXP) int64, whose entries equal to NPAGES are
        the trash page."""
        m = self.model
        B = tok.shape[0]
        U, H, KV, D = self.U, self.H, self.KV, self.D
        trash = kp.shape[1] - 1
        maxp = pt.shape[1]
        T = maxp * page
        iB = torch.arange(B, device=tok.device)
        pg = pt[iB, torch.clamp(pos // page, max=maxp - 1)]
        off = pos % page
        live = torch.arange(T, device=tok.device)[None, None, None, :] <= \
            pos[:, None, None, None]                        # (B, 1, 1, T)
        x = self.embed(tok, pos)
        for i, blk in enumerate(m.blocks):
            if self.is_llama:
                h = blk.rms1(x)
                q = self._lin(h, i, "q").reshape(B, H, 1, D)
                k = self._lin(h, i, "k").reshape(B, KV, 1, D)
                v = self._lin(h, i, "v").reshape(B, KV, D)
                q = rope(q, base=self.rope_base, position_offset=pos)[:, :, 0]
                k = rope(k, base=self.rope_base, position_offset=pos)[:, :, 0]
            else:
                h = blk.ln1(x)
                qkv = self._lin(h, i, "qkv")                   # (B, 3U)
                q, k, v = (qkv[:, j * U:(j + 1) * U].reshape(B, H, D)
                           for j in range(3))
            views = []
            for pool, new in ((kp[i], k), (vp[i], v)):
                pool[pg, :, off] = new          # the new column first ...
                pool[trash].zero_()             # ... sentinel writes vanish
                views.append(pool[pt].permute(0, 2, 1, 3, 4)
                             .reshape(B, KV, T, D))
            o = self._attend(q, views[0], views[1], live)
            if self.is_llama:
                x = x + self._lin(o, i, "o")
                h2 = blk.rms2(x)
                if self.q8 is not None:
                    # SwiGLU decomposed, as the reference's int8 arm
                    g = self._lin(h2, i, "gate")
                    x = x + self._lin(g * torch.sigmoid(g) *
                                      self._lin(h2, i, "up"), i, "down")
                else:
                    x = x + blk.mlp(h2)
            else:
                x = x + self._lin(o, i, "proj")
                h2 = blk.ln2(x)
                x = x + self._lin(self._lin(h2, i, "fc1", self.act_t), i,
                                  "fc2")
        return self.head_logits(m.ln_f(x))

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
