"""Models written as a user writes them in MXNet's own idiom, with
``hybrid_forward(F, ...)`` over ``F = mx.nd``, built from one body
against either package (``mxnet_tpu`` or ``mxnet_tpu_torch``, passed as
``pkg``): the tier-1 tests run the same user code in both, and
``chip_smoke.py`` drives the port's on the card.

- ``gpt(pkg, ...)``: a GPT-2 whose token and position tables are
  ``gluon.nn.Embedding``s, with ``gluon.nn.LayerNorm``, an attention
  block of ``F.FullyConnected(flatten=False)``, ``F.reshape``,
  ``F.transpose``, ``F.split`` and causal ``F.flash_attention`` (with
  attention dropout), an MLP of ``gluon.nn.Dense`` and ``gluon.nn.GELU``
  (tanh form), and an LM head tied to the token table by
  ``F.FullyConnected(no_bias=True)``.
- ``bottleneck_stage(pkg, ...)``: ResNet-50 v1's stage conv2_x (three
  bottlenecks, the first with the projection) from ``F.Convolution``,
  ``F.BatchNorm`` and ``F.Activation``, channels-last;
  ``stage_from_zoo`` copies a stage of ``gluon.nn.Conv2D``/``BatchNorm``
  (the model zoo's ``BottleneckV1``) into it.
"""


def gpt(pkg, vocab, units, layers, heads, max_len, dropout=0.0,
        hidden=None):
    """A GPT-2 of the given widths; ``net(tokens, positions)`` gives the
    (B, T, vocab) logits."""
    gluon = pkg.gluon
    nn = gluon.nn
    hidden = hidden or 4 * units

    class Attention(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.qkv_weight = self.params.get(
                    "qkv_weight", shape=(3 * units, units))
                self.qkv_bias = self.params.get(
                    "qkv_bias", shape=(3 * units,), init="zeros")
                self.proj_weight = self.params.get(
                    "proj_weight", shape=(units, units))
                self.proj_bias = self.params.get(
                    "proj_bias", shape=(units,), init="zeros")

        def hybrid_forward(self, F, x, qkv_weight, qkv_bias, proj_weight,
                           proj_bias):
            B, T, _ = x.shape
            qkv = F.FullyConnected(x, qkv_weight, qkv_bias,
                                   num_hidden=3 * units, flatten=False)
            qkv = F.transpose(F.reshape(qkv, shape=(B, T, 3, heads,
                                                    units // heads)),
                              axes=(2, 0, 3, 1, 4))
            q, k, v = F.split(qkv, num_outputs=3, axis=0, squeeze_axis=True)
            o = F.flash_attention(q, k, v, causal=True, dropout=dropout)
            o = F.reshape(F.transpose(o, axes=(0, 2, 1, 3)),
                          shape=(B, T, units))
            return F.FullyConnected(o, proj_weight, proj_bias,
                                    num_hidden=units, flatten=False)

    class Layer(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.ln1 = nn.LayerNorm(in_channels=units)
                self.attn = Attention()
                self.ln2 = nn.LayerNorm(in_channels=units)
                self.fc1 = nn.Dense(hidden, flatten=False, in_units=units)
                self.gelu = nn.GELU(approximation="tanh")
                self.fc2 = nn.Dense(units, flatten=False, in_units=hidden)
                self.drop = nn.Dropout(dropout)

        def hybrid_forward(self, F, x):
            x = x + self.drop(self.attn(self.ln1(x)))
            return x + self.drop(self.fc2(self.gelu(self.fc1(self.ln2(x)))))

    class TiedHead(gluon.HybridBlock):
        """The LM head: the token table's weight, shared through its
        ``params``."""

        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.weight = self.params.get("weight",
                                              shape=(vocab, units))

        def hybrid_forward(self, F, x, weight):
            return F.FullyConnected(x, weight, num_hidden=vocab,
                                    no_bias=True, flatten=False)

    class GPT(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.tok = nn.Embedding(vocab, units)
                self.pos = nn.Embedding(max_len, units)
                self.drop = nn.Dropout(dropout)
                self.layers = nn.HybridSequential()
                for _ in range(layers):
                    self.layers.add(Layer())
                self.ln_f = nn.LayerNorm(in_channels=units)
                self.head = TiedHead(params=self.tok.params)

        def hybrid_forward(self, F, tokens, positions):
            x = self.drop(self.tok(tokens) + self.pos(positions))
            return self.head(self.ln_f(self.layers(x)))

    return GPT()


# the bottleneck's layers in the model zoo's BottleneckV1 (``body`` and
# ``downsample`` children) and here (parameters of the block itself)
_ZOO = {"body.0": "conv1", "body.1": "bn1", "body.3": "conv2",
        "body.4": "bn2", "body.6": "conv3", "body.7": "bn3",
        "downsample.0": "ds_conv", "downsample.1": "ds_bn"}


def bottleneck_stage(pkg, channels=256, in_channels=64, blocks=3):
    """ResNet-50 v1's stage conv2_x (stride 1) as ``hybrid_forward``
    bottlenecks, NHWC: 1x1 (with bias), 3x3, 1x1 (with bias), each
    followed by BatchNorm over the last axis, the projection (1x1, no
    bias, BatchNorm) on the first block, ReLU after the sum."""
    gluon = pkg.gluon
    mid = channels // 4

    class Bottleneck(gluon.HybridBlock):
        def __init__(self, cin, project, **kw):
            super().__init__(**kw)
            self._project = project
            convs = [("conv1", mid, cin, 1, True),
                     ("conv2", mid, mid, 3, False),
                     ("conv3", channels, mid, 1, True)]
            if project:
                convs.append(("ds_conv", channels, cin, 1, False))
            with self.name_scope():
                for name, co, ci, k, bias in convs:
                    setattr(self, f"{name}_weight", self.params.get(
                        f"{name}_weight", shape=(co, ci, k, k)))
                    if bias:
                        setattr(self, f"{name}_bias", self.params.get(
                            f"{name}_bias", shape=(co,), init="zeros"))
                    bn = "ds_bn" if name == "ds_conv" else \
                        "bn" + name[-1]
                    for part, init in (("gamma", "ones"), ("beta", "zeros"),
                                       ("running_mean", "zeros"),
                                       ("running_var", "ones")):
                        frozen = part.startswith("running")
                        setattr(self, f"{bn}_{part}", self.params.get(
                            f"{bn}_{part}", shape=(co,), init=init,
                            grad_req="null" if frozen else "write",
                            differentiable=not frozen))

        @staticmethod
        def _conv(F, x, p, name, k):
            w = p[f"{name}_weight"]
            b = p.get(f"{name}_bias")
            return F.Convolution(x, w, b, kernel=(k, k), pad=(k // 2,) * 2,
                                 num_filter=w.shape[0], no_bias=b is None,
                                 layout="NHWC")

        @staticmethod
        def _bn(F, x, p, name):
            return F.BatchNorm(x, p[f"{name}_gamma"], p[f"{name}_beta"],
                               p[f"{name}_running_mean"],
                               p[f"{name}_running_var"], fix_gamma=False,
                               axis=-1)

        def hybrid_forward(self, F, x, **p):
            y = F.Activation(self._bn(F, self._conv(F, x, p, "conv1", 1),
                                      p, "bn1"), act_type="relu")
            y = F.Activation(self._bn(F, self._conv(F, y, p, "conv2", 3),
                                      p, "bn2"), act_type="relu")
            y = self._bn(F, self._conv(F, y, p, "conv3", 1), p, "bn3")
            if self._project:
                x = self._bn(F, self._conv(F, x, p, "ds_conv", 1), p,
                             "ds_bn")
            return F.Activation(y + x, act_type="relu")

    stage = gluon.nn.HybridSequential()
    for i in range(blocks):
        stage.add(Bottleneck(in_channels if i == 0 else channels, i == 0))
    return stage


def zoo_stage(pkg, channels=256, in_channels=64, blocks=3, **kw):
    """The same stage from the model zoo's ``BottleneckV1`` (``gluon.nn.
    Conv2D``/``BatchNorm``), NHWC."""
    resnet = pkg.gluon.model_zoo.vision.resnet
    stage = pkg.gluon.nn.HybridSequential()
    for i in range(blocks):
        stage.add(resnet.BottleneckV1(
            channels, 1, downsample=i == 0,
            in_channels=in_channels if i == 0 else channels, layout="NHWC",
            **kw))
    return stage


def stage_from_zoo(hybrid, zoo):
    """Copy the zoo stage's parameters into the hybrid one (the zoo's
    ``0.body.1.gamma`` is the hybrid's ``0.bn1_gamma``); returns ``{zoo
    structural name: hybrid structural name}``."""
    dst = hybrid._collect_params_with_prefix()
    names = {}
    for name, p in zoo._collect_params_with_prefix().items():
        block, child, idx, part = name.split(".")
        names[name] = f"{block}.{_ZOO[f'{child}.{idx}']}_{part}"
        dst[names[name]].set_data(p.data())
    return names
