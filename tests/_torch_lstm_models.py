"""A word-level LSTM language model written as a user writes it with
``mx.gluon``: GluonNLP's ``StandardRNN`` (``gluonnlp/model/
language_model.py``) as ``standard_lstm_lm_650`` configures it, the
recipe of GluonNLP's ``word_language_model.py`` (Zaremba et al. 2014's
"medium" widths).  JAX-free, written once against either package
(``mx`` is ``mxnet_tpu`` or ``mxnet_tpu_torch``): the tier-1 tests
drive it on the CPU at small widths and ``chip_smoke.py`` drives it on
the card at the published ones.

- ``standard_lstm_lm(mx, vocab_size, ...)``: an ``Embedding`` and
  ``Dropout``, a ``gluon.rnn.LSTM`` of ``num_layers`` (layout TNC, its
  inter-layer dropout), dropout on the LSTM's output, and a ``Dense``
  decoder that shares the embedding's weight (``params=``, tied).
  ``net(tokens, state)`` on (T, N) int32 tokens and the LSTM's
  ``[h, c]`` gives ``(logits (T, N, V), new_state)``.
- ``lm_loss(mx, net)``: ``SoftmaxCrossEntropyLoss`` over the flattened
  logits; ``loss(tokens, targets, h, c)`` gives ``(per-word loss, new h,
  new c)``, the state detached by the caller between batches.
"""

# gluonnlp.model.standard_lstm_lm_650 on WikiText-2
WIKITEXT2_VOCAB = 33278
LM650 = dict(embed_size=650, hidden_size=650, num_layers=2, dropout=0.5)


def standard_lstm_lm(mx, vocab_size, embed_size=650, hidden_size=650,
                     num_layers=2, dropout=0.5, tie_weights=True):
    gluon = mx.gluon
    nn = gluon.nn

    class StandardRNN(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.embedding = nn.HybridSequential()
                with self.embedding.name_scope():
                    self.embedding.add(nn.Embedding(vocab_size, embed_size))
                    if dropout:
                        self.embedding.add(nn.Dropout(dropout))
                self.encoder = gluon.rnn.LSTM(
                    hidden_size, num_layers, dropout=dropout,
                    input_size=embed_size)
                self.decoder = nn.HybridSequential()
                with self.decoder.name_scope():
                    shared = self.embedding[0].params if tie_weights \
                        else None
                    self.decoder.add(nn.Dense(vocab_size, flatten=False,
                                              in_units=hidden_size,
                                              params=shared))

        def begin_state(self, batch_size, **kw):
            return self.encoder.begin_state(batch_size, **kw)

        def hybrid_forward(self, F, tokens, h, c):
            encoded = self.embedding(tokens)
            encoded, state = self.encoder(encoded, [h, c])
            if dropout:
                encoded = F.Dropout(encoded, p=dropout)
            return self.decoder(encoded), state[0], state[1]

    return StandardRNN()


def lm_loss(mx, net):
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def loss(tokens, targets, h, c):
        logits, h, c = net(tokens, h, c)
        V = logits.shape[-1]
        return ce(logits.reshape((-1, V)), targets.reshape((-1,))), h, c

    return loss
