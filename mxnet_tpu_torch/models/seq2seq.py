"""Transformer seq2seq: the full encoder-decoder of Vaswani et al. 2017
(the reference serves it as GluonNLP's ``nlp.model.transformer``).

Port of ``mxnet_tpu/models/seq2seq.py``.  ``Trainer.fused_step`` trains
Gluon ``Parameter``s, so the model is built from Gluon blocks as the
reference's is: ``gluon.nn`` ``Dense``/``LayerNorm``/``Embedding``/
``Dropout`` under the reference's prefixes, so ``collect_params()``
gives its names (``transformerseq2seq0_enc_layer0_attn_qkv_weight``) and
``models.seq2seq_from_mxnet_tpu`` carries its weights by name.

``_SelfAttention``, ``_PositionwiseFFN`` and ``_EncoderCell`` hold the
same layers as ``models/transformer.py``'s ``MultiHeadAttention``,
``PositionwiseFFN`` and ``TransformerEncoderCell`` (the ``nn.Module``s
of GPT, BERT and Llama) in Gluon ``Parameter``s: the attention is one
function of both (``transformer.self_attention`` over ``attend``); the
FFN's and the pre-norm cell's few lines are written in both, so a change
to one is made to the other.  Every attention goes through
``ops.attention.flash_attention``: past 512² scores K1
forward and K2/K3 backward, with the ``(B, 1, 1, Ls)`` additive source
mask as their key mask.  Layers are pre-norm; dropout (outputs,
embeddings and attention probabilities) applies in training mode.

``greedy_decode`` keeps the reference's semantics: the encoder without a
mask, the decoder re-run over the growing prefix, finished rows pinned
to ``eos``, stopping when every row has finished.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass

import numpy as np
import torch

from ..base import MXNetError
from ..gluon.block import HybridBlock
from ..gluon.nn import Dense, Dropout, Embedding, LayerNorm
from ..ops.nn import fully_connected
from .transformer import attend, self_attention

__all__ = ["CrossAttention", "Seq2SeqEncoder", "Seq2SeqDecoderCell",
           "Seq2SeqDecoder", "TransformerSeq2Seq", "Seq2SeqConfig",
           "transformer_big"]


class _SelfAttention(HybridBlock):
    """The reference's ``transformer.MultiHeadAttention``: fused QKV,
    causal or key-masked (the port's ``transformer.MultiHeadAttention``
    in Gluon blocks)."""

    def __init__(self, units, num_heads, dropout=0.0, causal=False,
                 use_bias=True, dtype="float32", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if units % num_heads:
            raise MXNetError(f"units {units} not divisible by "
                             f"num_heads {num_heads}")
        self._units, self._heads, self._causal = units, num_heads, causal
        self._attn_dropout = dropout
        with self.name_scope():
            self.qkv = Dense(3 * units, flatten=False, use_bias=use_bias,
                             in_units=units, dtype=dtype, prefix="qkv_")
            self.proj = Dense(units, flatten=False, use_bias=use_bias,
                              in_units=units, dtype=dtype, prefix="out_")
            self.drop = Dropout(dropout) if dropout else None

    def forward(self, x, mask=None):
        out = self_attention(x, self.qkv, self.proj, self._heads, mask,
                             self._causal, self._attn_dropout,
                             self._is_training())
        return self.drop(out) if self.drop is not None else out


class CrossAttention(HybridBlock):
    """Decoder-to-encoder attention: queries from x, keys and values from
    ``memory`` (``kv`` packed as (B, Lk, 2, H, D), as the reference's)."""

    def __init__(self, units, num_heads, dropout=0.0, use_bias=True,
                 dtype="float32", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if units % num_heads:
            raise MXNetError(f"units {units} % heads {num_heads} != 0")
        self._units = units
        self._heads = num_heads
        self._attn_dropout = dropout
        with self.name_scope():
            self.q = Dense(units, flatten=False, use_bias=use_bias,
                           in_units=units, dtype=dtype, prefix="q_")
            self.kv = Dense(2 * units, flatten=False, use_bias=use_bias,
                            in_units=units, dtype=dtype, prefix="kv_")
            self.proj = Dense(units, flatten=False, use_bias=use_bias,
                              in_units=units, dtype=dtype, prefix="out_")
            self.drop = Dropout(dropout) if dropout else None

    def forward(self, x, memory, mem_mask=None):
        B, Lq, U = x.shape
        Lk = memory.shape[1]
        H, D = self._heads, self._units // self._heads
        q = self.q(x).reshape(B, Lq, H, D).transpose(1, 2)
        kv = self.kv(memory).reshape(B, Lk, 2, H, D).permute(2, 0, 3, 1, 4)
        out = attend(q, kv[0], kv[1], mem_mask, False, self._attn_dropout,
                     self._is_training())
        out = self.proj(out)
        return self.drop(out) if self.drop is not None else out


class _PositionwiseFFN(HybridBlock):
    """units -> hidden (GELU) -> units, the reference's
    ``transformer.PositionwiseFFN`` (mirrors the port's
    ``transformer.PositionwiseFFN``)."""

    def __init__(self, units, hidden_size, dropout=0.0, activation="gelu",
                 dtype="float32", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.fc1 = Dense(hidden_size, flatten=False, in_units=units,
                             activation=activation, dtype=dtype,
                             prefix="fc1_")
            self.fc2 = Dense(units, flatten=False, in_units=hidden_size,
                             dtype=dtype, prefix="fc2_")
            self.drop = Dropout(dropout) if dropout else None

    def forward(self, x):
        out = self.fc2(self.fc1(x))
        return self.drop(out) if self.drop is not None else out


class _EncoderCell(HybridBlock):
    """Pre-norm encoder layer, the reference's
    ``transformer.TransformerEncoderCell`` (mirrors the port's
    ``transformer._TransformerCell.forward``)."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 dtype="float32", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.ln1 = LayerNorm(in_channels=units, prefix="ln1_")
            self.attn = _SelfAttention(units, num_heads, dropout,
                                       dtype=dtype, prefix="attn_")
            self.ln2 = LayerNorm(in_channels=units, prefix="ln2_")
            self.ffn = _PositionwiseFFN(units, hidden_size, dropout,
                                        dtype=dtype, prefix="ffn_")

    def forward(self, x, mask=None):
        x = x + self.attn(self.ln1(x), mask)
        return x + self.ffn(self.ln2(x))


class Seq2SeqDecoderCell(HybridBlock):
    """Pre-norm decoder layer: causal self-attention, cross-attention,
    FFN."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 dtype="float32", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.ln1 = LayerNorm(in_channels=units, prefix="ln1_")
            self.self_attn = _SelfAttention(units, num_heads, dropout,
                                            causal=True, dtype=dtype,
                                            prefix="self_")
            self.ln2 = LayerNorm(in_channels=units, prefix="ln2_")
            self.cross_attn = CrossAttention(units, num_heads, dropout,
                                             dtype=dtype, prefix="cross_")
            self.ln3 = LayerNorm(in_channels=units, prefix="ln3_")
            self.ffn = _PositionwiseFFN(units, hidden_size, dropout,
                                        dtype=dtype, prefix="ffn_")

    def forward(self, x, memory, mem_mask=None):
        x = x + self.self_attn(self.ln1(x))
        x = x + self.cross_attn(self.ln2(x), memory, mem_mask)
        return x + self.ffn(self.ln3(x))


class _EmbeddingStack(HybridBlock):
    """word(tokens) * sqrt(units) + pos(arange(L)), then dropout:
    ``max_length`` must cover the longest source or target."""

    def __init__(self, vocab_size, units, max_length, dropout, dtype,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._units = units
        self._max_length = max_length
        with self.name_scope():
            self.word = Embedding(vocab_size, units, dtype=dtype,
                                  prefix="word_")
            self.pos = Embedding(max_length, units, dtype=dtype,
                                 prefix="pos_")
            self.drop = Dropout(dropout) if dropout else None

    def forward(self, tokens):
        B, L = tokens.shape
        if L > self._max_length:
            raise MXNetError(f"sequence of {L} tokens is longer than "
                             f"max_length {self._max_length}")
        pos = torch.arange(L, device=tokens.device).reshape(1, L)
        x = self.word(tokens) * (self._units ** 0.5) + self.pos(pos)
        return self.drop(x) if self.drop is not None else x


class Seq2SeqEncoder(HybridBlock):
    def __init__(self, vocab_size, units, hidden_size, num_heads, num_layers,
                 max_length=512, dropout=0.0, dtype="float32", prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.embed = _EmbeddingStack(vocab_size, units, max_length,
                                         dropout, dtype, prefix="emb_")
            self.layers = []
            for i in range(num_layers):
                cell = _EncoderCell(units, hidden_size, num_heads, dropout,
                                    dtype=dtype, prefix=f"layer{i}_")
                self.register_child(cell, f"layer{i}")
                self.layers.append(cell)
            self.ln = LayerNorm(in_channels=units, prefix="ln_")

    def forward(self, src_tokens, src_mask=None):
        x = self.embed(src_tokens)
        for cell in self.layers:
            x = cell(x, src_mask)
        return self.ln(x)


class Seq2SeqDecoder(HybridBlock):
    def __init__(self, vocab_size, units, hidden_size, num_heads, num_layers,
                 max_length=512, dropout=0.0, dtype="float32", prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.embed = _EmbeddingStack(vocab_size, units, max_length,
                                         dropout, dtype, prefix="emb_")
            self.layers = []
            for i in range(num_layers):
                cell = Seq2SeqDecoderCell(units, hidden_size, num_heads,
                                          dropout, dtype=dtype,
                                          prefix=f"layer{i}_")
                self.register_child(cell, f"layer{i}")
                self.layers.append(cell)
            self.ln = LayerNorm(in_channels=units, prefix="ln_")

    def forward(self, tgt_tokens, memory, mem_mask=None):
        x = self.embed(tgt_tokens)
        for cell in self.layers:
            x = cell(x, memory, mem_mask)
        return self.ln(x)


class TransformerSeq2Seq(HybridBlock):
    """The encoder-decoder with a tied or free output projection.

    ``forward(src, tgt, src_mask=None)`` gives (B, L_tgt, vocab) logits
    (teacher forcing); ``src_mask`` is an additive (B, 1, 1, L_src) key
    mask (a large negative value at padding).  ``greedy_decode(src,
    max_len, bos, eos)`` runs inference."""

    def __init__(self, vocab_size, units=512, hidden_size=2048, num_heads=8,
                 num_enc_layers=6, num_dec_layers=6, max_length=512,
                 dropout=0.1, tie_embeddings=True, dtype="float32",
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._tie = tie_embeddings
        with self.name_scope():
            self.encoder = Seq2SeqEncoder(vocab_size, units, hidden_size,
                                          num_heads, num_enc_layers,
                                          max_length, dropout, dtype,
                                          prefix="enc_")
            self.decoder = Seq2SeqDecoder(vocab_size, units, hidden_size,
                                          num_heads, num_dec_layers,
                                          max_length, dropout, dtype,
                                          prefix="dec_")
            if not tie_embeddings:
                self.out_proj = Dense(vocab_size, flatten=False,
                                      in_units=units, use_bias=False,
                                      dtype=dtype, prefix="outproj_")

    def _project(self, x):
        if self._tie:
            return fully_connected(
                x, self.decoder.embed.word._parameters["weight"], None)
        return self.out_proj(x)

    def forward(self, src_tokens, tgt_tokens, src_mask=None):
        memory = self.encoder(src_tokens, src_mask)
        return self._project(self.decoder(tgt_tokens, memory, src_mask))

    def greedy_decode(self, src_tokens, max_len=32, bos=1, eos=2):
        """Host-driven greedy decoding: (B, <= max_len) int32 numpy
        tokens starting with ``bos``.  Runs as inference (no dropout, no
        gradient), as a call outside ``autograd.record()``."""
        from ..ndarray.ndarray import NDArray

        dev = self.decoder.embed.word._parameters["weight"].device
        src = src_tokens._data if isinstance(src_tokens, NDArray) \
            else torch.as_tensor(src_tokens)
        src = NDArray(src.to(dev))
        B = src.shape[0]
        memory = self.encoder(src)
        out = np.full((B, 1), bos, dtype=np.int32)
        finished = np.zeros(B, dtype=bool)
        for _ in range(max_len - 1):
            tgt = NDArray(torch.from_numpy(out).to(memory._data.device))
            logits = self._logits_nd(tgt, memory)
            nxt = logits.cpu().numpy().argmax(-1).astype(np.int32)
            nxt = np.where(finished, eos, nxt)
            out = np.concatenate([out, nxt[:, None]], axis=1)
            finished |= (nxt == eos)
            if finished.all():
                break
        return out

    def _logits_nd(self, tgt, memory):
        """The last position's logits, (B, vocab) f32: the decoder over
        the whole prefix as a call made with NDArrays (inference outside
        ``autograd.record()``), the projection of its last row only (the
        reference projects every row and keeps the last)."""
        with torch.no_grad():
            dec = self.decoder(tgt, memory)
            return self._project(dec._data[:, -1]).float()


@dataclass
class Seq2SeqConfig:
    """``TransformerSeq2Seq``'s arguments."""

    vocab_size: int = 37000
    units: int = 512
    hidden_size: int = 2048
    num_heads: int = 8
    num_enc_layers: int = 6
    num_dec_layers: int = 6
    max_length: int = 512
    dropout: float = 0.1
    tie_embeddings: bool = True
    dtype: str = "float32"

    def make(self, **kw):
        return TransformerSeq2Seq(**asdict(self), **kw)


def transformer_big(**overrides):
    """Vaswani et al. 2017, Table 3 "big" on WMT14 En-De (a shared BPE
    vocabulary of 37,000 tokens, section 5.1): ``(model, config)``."""
    cfg = Seq2SeqConfig(**{**dict(units=1024, hidden_size=4096,
                                  num_heads=16, dropout=0.3), **overrides})
    return cfg.make(), cfg
