"""Detection models written as a user writes them with ``mx.gluon`` and
``hybrid_forward(F, ...)`` over ``F = mx.nd``: SSD on a model-zoo ResNet
v1 and a Faster R-CNN region-proposal head.  JAX-free: the tier-1 tests
drive them on the CPU at small sizes and ``chip_smoke.py`` drives them
on the card at full width.

- ``ssd(mx, base, ...)``: GluonCV's ``ssd_512_resnet50_v1_voc``
  (``gluoncv/model_zoo/ssd/presets.py``) over ``base``, a channels-last
  model-zoo ResNet v1: features after stage 3 and stage 4, four extra
  stages of ``filters`` (a 1x1 convolution to max(128, f/2) channels,
  then a 3x3 stride-2 pad-1 one to f, each with BatchNorm and ReLU), and
  per map a 3x3 class head (A * (classes + 1)) and box head (A * 4) and
  one ``MultiBoxPrior``.  ``net(x)`` on NHWC ``x`` gives the class
  scores (N, anchors, classes + 1), the box offsets (N, anchors * 4) and
  the anchors (1, anchors, 4).
- ``ssd_loss(mx, net)``: ``MultiBoxTarget`` (``overlap_threshold=0.5``),
  ``SoftmaxCrossEntropyLoss`` over the classes and ``smooth_l1`` on the
  masked offsets; ``loss(x, label)`` on NCHW f32 images (cast to
  ``dtype``, the net's) gives ``(loss, class loss, loc_target, loc_mask,
  cls_target)``, all per sample.
- ``ssd_detect(mx, net, ...)``: the softmax and ``MultiBoxDetection``;
  ``detect(x)`` gives ``(rows, class probabilities, box offsets,
  anchors)``.
- ``rpn(mx, anchors)``: the RPN head (a 3x3 convolution of 512 and ReLU,
  then 1x1 convolutions to 2A scores and 4A deltas); ``head(x)`` on an
  NCHW feature gives ``(cls_prob, bbox_pred)``, the score pairs through a
  softmax as ``Proposal`` reads them.
"""

# GluonCV's ssd_512_resnet50_v1_voc
SSD512_SCALES = (51.2, 102.4, 189.4, 276.4, 363.52, 450.6, 492.0)
SSD512_SIZES = tuple((SSD512_SCALES[i] / 512,
                      (SSD512_SCALES[i] * SSD512_SCALES[i + 1]) ** 0.5 / 512)
                     for i in range(6))
SSD512_RATIOS = ((1, 2, 0.5),) + ((1, 2, 0.5, 3, 1.0 / 3),) * 3 + \
    ((1, 2, 0.5),) * 2
SSD512_STEPS = tuple(s / 512 for s in (16, 32, 64, 128, 256, 512))
SSD512_FILTERS = (512, 512, 256, 256)
VOC_CLASSES = 20


def anchors_per_position(sizes, ratios):
    return [len(s) + len(r) - 1 for s, r in zip(sizes, ratios)]


def ssd(mx, base, classes=VOC_CLASSES, filters=SSD512_FILTERS,
        sizes=SSD512_SIZES, ratios=SSD512_RATIOS, steps=SSD512_STEPS):
    gluon = mx.gluon
    nn = gluon.nn
    per = anchors_per_position(sizes, ratios)

    class SSD(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.stage3 = nn.HybridSequential(prefix="")
                for i in range(7):
                    self.stage3.add(base.features[i])
                self.stage4 = base.features[7]
                self.extras = nn.HybridSequential(prefix="")
                for f in filters:
                    blk = nn.HybridSequential(prefix="")
                    blk.add(nn.Conv2D(max(128, f // 2), 1, use_bias=False,
                                      layout="NHWC"),
                            nn.BatchNorm(axis=-1), nn.Activation("relu"),
                            nn.Conv2D(f, 3, strides=2, padding=1,
                                      use_bias=False, layout="NHWC"),
                            nn.BatchNorm(axis=-1), nn.Activation("relu"))
                    self.extras.add(blk)
                self.cls_heads = nn.HybridSequential(prefix="")
                self.loc_heads = nn.HybridSequential(prefix="")
                for a in per:
                    self.cls_heads.add(nn.Conv2D(
                        a * (classes + 1), 3, padding=1, layout="NHWC",
                        weight_initializer=mx.init.Normal(0.001)))
                    self.loc_heads.add(nn.Conv2D(
                        a * 4, 3, padding=1, layout="NHWC",
                        weight_initializer=mx.init.Normal(0.001)))

        def hybrid_forward(self, F, x):
            feats = [self.stage3(x)]
            feats.append(self.stage4(feats[0]))
            for blk in self.extras:
                feats.append(blk(feats[-1]))
            n = x.shape[0]
            cls, loc, anchors = [], [], []
            for i, f in enumerate(feats):
                cls.append(F.reshape(self.cls_heads[i](f),
                                     shape=(n, -1, classes + 1)))
                loc.append(F.reshape(self.loc_heads[i](f), shape=(n, -1)))
                anchors.append(F.MultiBoxPrior(
                    F.transpose(f, axes=(0, 3, 1, 2)), sizes=sizes[i],
                    ratios=ratios[i], steps=(steps[i], steps[i])))
            return (F.concat(*cls, dim=1), F.concat(*loc, dim=1),
                    F.concat(*anchors, dim=1))

    return SSD()


def ssd_loss(mx, net, dtype="float32"):
    gluon = mx.gluon

    class SSDLoss(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.net = net
            self.ce = gluon.loss.SoftmaxCrossEntropyLoss()

        def hybrid_forward(self, F, x, label):
            x = F.transpose(x, axes=(0, 2, 3, 1)).astype(dtype)
            cls, loc, anchors = self.net(x)
            loc_t, mask, cls_t = F.MultiBoxTarget(
                anchors, label, F.transpose(cls, axes=(0, 2, 1)),
                overlap_threshold=0.5)
            cls_loss = self.ce(cls.astype("float32"), cls_t)
            loc_loss = F.mean(F.smooth_l1(loc.astype("float32") * mask -
                                          loc_t, scalar=1.0), axis=1)
            return cls_loss + loc_loss, cls_loss, loc_t, mask, cls_t

    return SSDLoss()


def ssd_detect(mx, net, dtype="float32", threshold=0.01, nms_threshold=0.45,
               nms_topk=400):
    gluon = mx.gluon

    class SSDDetect(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.net = net

        def hybrid_forward(self, F, x):
            x = F.transpose(x, axes=(0, 2, 3, 1)).astype(dtype)
            cls, loc, anchors = self.net(x)
            prob = F.transpose(F.softmax(cls.astype("float32"), axis=-1),
                               axes=(0, 2, 1))
            loc = loc.astype("float32")
            rows = F.MultiBoxDetection(prob, loc, anchors,
                                       threshold=threshold,
                                       nms_threshold=nms_threshold,
                                       nms_topk=nms_topk)
            return rows, prob, loc, anchors

    return SSDDetect()


def rpn(mx, anchors):
    gluon = mx.gluon
    nn = gluon.nn

    class RPN(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.conv = nn.Conv2D(512, 3, padding=1, activation="relu",
                                      weight_initializer=mx.init.Normal(0.01))
                self.score = nn.Conv2D(2 * anchors, 1,
                                       weight_initializer=mx.init.Normal(0.01))
                self.delta = nn.Conv2D(4 * anchors, 1,
                                       weight_initializer=mx.init.Normal(0.01))

        def hybrid_forward(self, F, x):
            h = self.conv(x)
            s = self.score(h)
            n, _, hh, ww = s.shape
            prob = F.softmax(F.reshape(s, shape=(n, 2, anchors * hh, ww)),
                             axis=1)
            return F.reshape(prob, shape=(n, 2 * anchors, hh, ww)), \
                self.delta(h)

    return RPN()
