#!/usr/bin/env python3
"""Time one checkout's ResNet-50 training step on one card, so that two
checkouts can be compared run against run.

    python3 resnet_ab.py [--root DIR] [--tag NAME] [--forwards LIST]

imports ``mxnet_tpu_torch`` from DIR (default: beside this file) and the
phases of this file's own ``chip_smoke.py``, so both checkouts are
measured by the same code, then prints one JSON line:

- ``spmd``: ``chip_smoke.train_resnet(True)``, ResNet-50 v1 NHWC bf16 at
  128 x 224 x 224 through ``parallel.SPMDTrainer`` with K6, 20 SGD
  steps: ms a step (steps 2-20), images/s, peak memory, launches;
- ``gluon``: where the checkout has the Gluon parameter layer,
  ``chip_smoke.gluon_resnet``, the same net and batch through
  ``gluon.Trainer`` and NDArrays (its gates included), its weights
  drawn after ``mx.random.seed(0)``.

``--forwards tensor,hybrid,...`` prints instead one ``forwards`` row a
arm, all in this process: the same net and batch, 20 eager steps of
``record``, ``backward``, ``gluon.Trainer.step`` (``MXNET_FUSED_CONV_BWD
=1``), ms a step over steps 2-20 and the host ms to enqueue one; under
``tensor`` the layers run as they are, under ``hybrid`` every layer
marked ``_capture_runs = "hybrid_forward"`` (``Dense``, ``Conv2D``,
``BatchNorm``, the ResNet blocks, ...) runs its ``hybrid_forward`` over
``mx.nd`` instead of its tensor ``forward``; ``same_bits`` says whether
every arm's losses and weights equal the first arm's.

Run it once per checkout, in separate processes, in the order parent,
change, change, parent (host clocks spread between processes).
"""
import argparse
import contextlib
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def _forwards(kind):
    """Inside, with ``kind == "hybrid"``, every class marked
    ``_capture_runs = "hybrid_forward"`` runs ``HybridBlock.forward``."""
    import mxnet_tpu_torch.gluon.model_zoo.vision  # noqa: F401
    import mxnet_tpu_torch.gluon.rnn  # noqa: F401
    from mxnet_tpu_torch.gluon import block

    if kind not in ("tensor", "hybrid"):
        sys.exit(f"resnet_ab.py: --forwards takes tensor or hybrid, not "
                 f"{kind}")
    patched, todo = {}, [block.Block]
    while todo:
        cls = todo.pop()
        todo += cls.__subclasses__()
        if kind == "hybrid" and \
                cls.__dict__.get("_capture_runs") == "hybrid_forward":
            patched[cls] = cls.__dict__["forward"]
            cls.forward = block.HybridBlock.forward
    try:
        yield sorted(c.__name__ for c in patched)
    finally:
        for cls, fwd in patched.items():
            cls.forward = fwd


FORWARD_STEPS = 20


def forward_arm(cs, mx, kind):
    """``--forwards``' arm ``kind``: phase 16's eager ResNet-50 step."""
    import time

    import torch
    from mxnet_tpu_torch import autograd, gluon

    os.environ["MXNET_FUSED_CONV_BWD"] = "1"
    with _forwards(kind) as classes:
        mx.random.seed(0)
        net = cs._gluon_resnet50(mx)
        data, label = cs._resnet_batch()
        x, y = mx.nd.NDArray(data), mx.nd.NDArray(label)
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                dict(cs.RESNET_OPT))
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        host = []

        def step():
            t = time.perf_counter()
            with autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            trainer.step(cs.RESNET_B)
            out = loss._data.detach().float().mean()
            host.append(time.perf_counter() - t)
            return out

        losses = [step()]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses += [step() for _ in range(FORWARD_STEPS - 1)]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    rest = FORWARD_STEPS - 1
    weights = [p.data()._data.clone() for p in net.collect_params().values()]
    del net, trainer, x, y
    torch.cuda.empty_cache()
    return dict(forward=kind, classes=classes,
                ms_per_step=(t2 - t1) / rest * 1e3,
                host_ms_per_step=sum(host[1:]) / rest * 1e3,
                losses=[float(v) for v in losses]), weights


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--tag", default="")
    ap.add_argument("--forwards", default="",
                    help="comma-separated Gluon arms: tensor or hybrid")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("resnet_ab.py: CUDA is not available")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    cs = _chip_smoke()
    import mxnet_tpu_torch
    from mxnet_tpu_torch import _build, gluon

    if not mxnet_tpu_torch.__file__.startswith(root):
        sys.exit(f"resnet_ab.py: imported {mxnet_tpu_torch.__file__}, "
                 f"not the checkout at {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    _build.build()
    out = dict(tag=args.tag, root=root, card=cs.card_line())
    if args.forwards:
        rows, first = [], None
        for kind in args.forwards.split(","):
            row, weights = forward_arm(cs, mxnet_tpu_torch, kind)
            if first is None:
                first = (row["losses"], weights)
            row["same_bits"] = row["losses"] == first[0] and all(
                torch.equal(a, b) for a, b in zip(weights, first[1]))
            rows.append(row)
            del weights
        out["forwards"] = rows
        print(json.dumps(out, default=str))
        return
    spmd, *held = cs.train_resnet(True)
    del held
    torch.cuda.empty_cache()
    out["spmd"] = spmd
    if hasattr(gluon, "Parameter"):
        # the same initial weights for every checkout and run
        mxnet_tpu_torch.random.seed(0)
        out["gluon"] = cs.gluon_resnet(spmd)
    print(json.dumps(out, default=str))


if __name__ == "__main__":
    main()
