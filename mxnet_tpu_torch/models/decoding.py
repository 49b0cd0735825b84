"""KV-cache incremental decoding for GPT models.

Port of the stacked decode mode of ``mxnet_tpu/models/decoding.py``.
PyTorch runs eagerly, so the reference's ``lax.scan`` over stacked layer
weights becomes a Python loop over the layers, with the same math in the
same order:

- batched prefill (``_DecodeEngine.prefill``): one causal forward over a
  right-padded ``(B, P)`` prompt block through the ``flash_attention``
  op, logits gathered at each row's own last token, LM head native;
- the per-token step (``_DecodeEngine.paged_step``) against a PAGED K/V
  pool ``(NL, NPAGES + 1, H, page, D)`` read through per-row page tables.
  Index ``NPAGES`` is a trash page: the reference's one-past-the-end
  sentinel gathers zeros and drops scatters (``mode="fill"/"drop"``),
  which PyTorch cannot express without an out-of-range index (a device
  assert on CUDA).  Here every write lands somewhere legal, and the
  trash page is zeroed before each gather, so sentinel entries read
  zeros and writes through them vanish;
- ``weights="int8"``: every decode projection and the LM head run
  ``q8_matvec`` (kernel K4) on per-output-channel int8 codes; the output
  is cast to the compute dtype and only then activated, as in the
  reference;
- sampling: greedy is argmax.  Sampled draws cannot reproduce JAX's
  PRNG bits; they use Gumbel-max noise from a counter-based hash of
  ``(seed, position, token id)`` — no global RNG — so a served request
  reproduces ``kv_generate(seed=...)`` at batch 1.

``kv_generate`` runs the same step against a pool with one page per row.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from ..ops.attention import _hash_bits, flash_attention
from ..ops.nn import activation, embedding, fully_connected
from ..ops.q8_matvec import q8_matvec

__all__ = ["kv_generate"]

_NEG_INF = -1e30
_PROJ = {"qkv": lambda b: b.attn.qkv, "proj": lambda b: b.attn.proj,
         "fc1": lambda b: b.ffn.fc1, "fc2": lambda b: b.ffn.fc2}


def _quantize_rows(w):
    """Per-output-channel symmetric int8: w (out, in) -> (codes (in, out)
    int8, pre-transposed for the kernel; f32 scales (out,))."""
    w32 = w.float()
    s = torch.clamp(w32.abs().amax(dim=1) / 127.0, min=1e-8)
    wq = torch.round(w32 / s[:, None]).to(torch.int8)
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


def _q8_weights(model):
    """int8 codes for every decode projection and the tied head, cached
    on the model and rebuilt when any source parameter changed (its
    storage or its in-place version counter)."""
    srcs = [p for p in model.parameters()]
    key = tuple((p.data_ptr(), p._version) for p in srcs)
    cache = model.__dict__.get("_q8_cache")
    if cache is not None and cache[0] == key:
        return cache[1]
    with torch.no_grad():
        layers = []
        for blk in model.blocks:
            ent = {}
            for kind, get in _PROJ.items():
                lyr = get(blk)
                wq, s = _quantize_rows(lyr.weight)
                b = None if lyr.bias is None else lyr.bias.float()
                ent[kind] = (wq, s, b)
            layers.append(ent)
        val = {"layers": layers, "head": _quantize_head(model.wte.weight)}
    model.__dict__["_q8_cache"] = (key, val)
    return val


def _check_weights(weights):
    if weights not in ("native", "int8"):
        raise MXNetError(f"weights must be 'native' or 'int8', "
                         f"got {weights!r}")


class _DecodeEngine:
    """Prepared weights plus the prefill and per-token step bodies for one
    model, one weight mode and one sampler setting.  Batch-size free: the
    serving pool of every size shares one engine."""

    def __init__(self, model, temperature=0.0, top_k=0, weights="native"):
        _check_weights(weights)
        cfg = model._cfg
        self.model = model
        self.temperature, self.top_k = float(temperature), int(top_k)
        self.NL = len(model.blocks)
        self.H = cfg.num_heads
        self.U = cfg.units
        self.D = self.U // self.H
        self.vocab = cfg.vocab_size
        self.scale = 1.0 / (self.D ** 0.5)
        self.cdtype = model.dtype
        self.device = model.device
        self.act_t = model.blocks[0].ffn.fc1.act_type
        self.q8 = _q8_weights(model) if weights == "int8" else None

    # -- layers ---------------------------------------------------------- #
    def _lin(self, x, i, kind, act_type=None):
        """One decode projection: ``q8_matvec`` -> cast -> activation in
        int8 mode, the model's own dense math otherwise."""
        if self.q8 is not None:
            y = q8_matvec(x, *self.q8["layers"][i][kind]).to(self.cdtype)
        else:
            lyr = _PROJ[kind](self.model.blocks[i])
            y = fully_connected(x, lyr.weight, lyr.bias)
        return activation(y, act_type) if act_type else y

    def head_logits(self, xl, q8=True):
        """ln_f output (B, U) -> f32 logits (B, V).  The prefill passes
        ``q8=False``: its head is always native, as in the reference."""
        if q8 and self.q8 is not None:
            return q8_matvec(xl.contiguous(), *self.q8["head"])[:, :self.vocab]
        return torch.matmul(xl, self.model.wte.weight.t()).float()

    # -- prefill --------------------------------------------------------- #
    @torch.no_grad()
    def prefill(self, prompts, last_index=None):
        """One causal forward over ``prompts`` (B, P) int64.  Returns
        (f32 logits (B, V) at each row's ``last_index`` — default P - 1 —,
        K and V of every layer as (NL, B, H, P, D))."""
        m = self.model
        B, P = prompts.shape
        U, H, D = self.U, self.H, self.D
        pos = torch.arange(P, device=prompts.device)
        x = embedding(prompts, m.wte.weight) + \
            embedding(pos, m.wpe.weight)[None]
        ks, vs = [], []
        for blk in m.blocks:
            h = blk.ln1(x)
            qkv = blk.attn.qkv(h)                              # (B, P, 3U)
            q, k, v = (qkv[..., j * U:(j + 1) * U].reshape(B, P, H, D)
                       .permute(0, 2, 1, 3) for j in range(3))
            ks.append(k)
            vs.append(v)
            o = flash_attention(q, k, v, None, scale=self.scale,
                                causal=True)
            x = x + blk.attn.proj(o.permute(0, 2, 1, 3).reshape(B, P, U))
            # the FFN's own projections: no dropout while serving
            x = x + blk.ffn.fc2(blk.ffn.fc1(blk.ln2(x)))
        if last_index is None:
            x_last = x[:, -1]
        else:
            li = torch.as_tensor(last_index, device=x.device).long()
            x_last = x[torch.arange(B, device=x.device), li]
        logits = self.head_logits(m.ln_f(x_last), q8=False)
        return logits, torch.stack(ks), torch.stack(vs)

    # -- the per-token step ---------------------------------------------- #
    @torch.no_grad()
    def paged_step(self, tok, pos, kp, vp, pt, page):
        """Token ``tok`` (B,) at per-row position ``pos`` (B,) -> f32
        logits (B, V).  Writes the new K/V columns into the pools ``kp``,
        ``vp`` (NL, NPAGES + 1, H, page, D) in place through the page
        table ``pt`` (B, MAXP) int64, whose entries equal to NPAGES are
        the trash page."""
        m = self.model
        B = tok.shape[0]
        U, H, D = self.U, self.H, self.D
        trash = kp.shape[1] - 1
        maxp = pt.shape[1]
        T = maxp * page
        iB = torch.arange(B, device=tok.device)
        pg = pt[iB, torch.clamp(pos // page, max=maxp - 1)]
        off = pos % page
        live = torch.arange(T, device=tok.device)[None, None, None, :] <= \
            pos[:, None, None, None]                        # (B, 1, 1, T)
        x = embedding(tok, m.wte.weight) + embedding(pos, m.wpe.weight)
        for i, blk in enumerate(m.blocks):
            h = blk.ln1(x)
            qkv = self._lin(h, i, "qkv")                       # (B, 3U)
            q, k, v = (qkv[:, j * U:(j + 1) * U].reshape(B, H, D)
                       for j in range(3))
            views = []
            for pool, new in ((kp[i], k), (vp[i], v)):
                pool[pg, :, off] = new          # the new column first ...
                pool[trash].zero_()             # ... sentinel writes vanish
                views.append(pool[pt].permute(0, 2, 1, 3, 4)
                             .reshape(B, H, T, D))
            kc, vc = views
            s = torch.matmul(q.float()[:, :, None, :],
                             kc.float().transpose(-1, -2)) * self.scale
            s = torch.where(live, s, torch.full_like(s, _NEG_INF))
            p = torch.softmax(s, dim=-1).to(self.cdtype)
            # p·V: the reference sums in f32 and rounds once.  Here the
            # exact bf16/f32 products are summed in f64 before that one
            # rounding, so the result does not depend on the cache
            # horizon T or on how the library splits the sum: a served
            # row and the same row of kv_generate round alike
            o = torch.matmul(p.double(), vc.double()).to(self.cdtype)
            o = o.reshape(B, U)
            x = x + self._lin(o, i, "proj")
            h2 = blk.ln2(x)
            x = x + self._lin(self._lin(h2, i, "fc1", self.act_t), i, "fc2")
        return self.head_logits(m.ln_f(x))

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
                top_k=0, seed=0, weights="native"):
    """Continue a (B, P) prompt by ``max_new_tokens`` tokens; returns the
    (B, P + max_new_tokens) int32 numpy array.  Greedy when
    ``temperature == 0``; otherwise seeded sampling (``top_k > 0``
    restricts it), deterministic given ``seed``.  ``weights="int8"``
    streams the decode projections and the head as int8 through K4."""
    _check_weights(weights)
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
    eng = _DecodeEngine(model, temperature, top_k, weights)
    dev = eng.device
    prompts = torch.as_tensor(prompt, device=dev)
    logits, knew, vnew = eng.prefill(prompts)
    # one page of ``total`` positions per row, plus the trash page
    shape = (eng.NL, B + 1, eng.H, total, eng.D)
    kp = torch.zeros(shape, dtype=eng.cdtype, device=dev)
    vp = torch.zeros(shape, dtype=eng.cdtype, device=dev)
    kp[:, :B, :, :P] = knew
    vp[:, :B, :, :P] = vnew
    pt = torch.arange(B, device=dev)[:, None]
    seeds = torch.full((B,), int(seed), dtype=torch.int64, device=dev)
    pos = torch.full((B,), P - 1, dtype=torch.int64, device=dev)
    tok = eng.sample(logits, seeds, pos)
    out = [tok]
    for _ in range(max_new_tokens - 1):
        pos = pos + 1
        tok = eng.sample(eng.paged_step(tok, pos, kp, vp, pt, total),
                         seeds, pos)
        out.append(tok)
    new = torch.stack(out, dim=1).cpu().numpy()
    return np.concatenate([prompt, new], axis=1).astype(np.int32)
