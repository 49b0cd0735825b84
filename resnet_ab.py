#!/usr/bin/env python3
"""Time one checkout's ResNet-50 training step on one card, so that two
checkouts can be compared run against run.

    python3 resnet_ab.py [--root DIR] [--tag NAME]

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

Run it once per checkout, in separate processes, in the order parent,
change, change, parent (host clocks spread between processes).
"""
import argparse
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--tag", default="")
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
    spmd, *held = cs.train_resnet(True)
    del held
    torch.cuda.empty_cache()
    out = dict(tag=args.tag, root=root, card=cs.card_line(), spmd=spmd)
    if hasattr(gluon, "Parameter"):
        # the same initial weights for every checkout and run
        mxnet_tpu_torch.random.seed(0)
        out["gluon"] = cs.gluon_resnet(spmd)
    print(json.dumps(out, default=str))


if __name__ == "__main__":
    main()
