#!/usr/bin/env python3
"""Time one checkout's runtime-compiled kernel launcher (``mx.rtc``, kernel
K7) on one card, so that two checkouts can be compared run against run.

    python3 rtc_ab.py [--root DIR] [--tag NAME]

imports ``mxnet_tpu_torch`` and the user kernels of
``tests/_torch_rtc_sources.py`` from DIR (default: beside this file), and
the timers and phases of this file's own ``chip_smoke.py``, so both
checkouts are measured by the same code, then prints one JSON line:

- ``launch_us``, ``torch_launch_us``, ``host_floor_us``,
  ``launch_parts`` and ``plan_parts`` from ``chip_smoke.rtc_launch_costs``:
  host microseconds a ``CudaKernel.launch`` of ``addmul`` at 256 values,
  one ``torch.add`` of the same function, a bare ``cuLaunchKernel`` from
  Python, the parent commit's launch path by parts and, where the
  checkout has launch plans, the plan path by parts;
- ``cases``: ``gelu_fwd`` and ``gelu_bwd`` in bf16 and f32 at 8192 x 3072
  from ``chip_smoke.rtc_gelu_cases``, each by both of ``chip_smoke``'s
  timers beside ``F.gelu`` / ``aten.gelu_backward``;
- ``graph``: ``chip_smoke.rtc_graph_replay``, or the error it raised.

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
        sys.exit("rtc_ab.py: CUDA is not available")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    cs = _chip_smoke()
    cs.HERE = root                  # the user kernels come from DIR too
    import mxnet_tpu_torch
    from mxnet_tpu_torch import rtc

    if not mxnet_tpu_torch.__file__.startswith(root):
        sys.exit(f"rtc_ab.py: imported {mxnet_tpu_torch.__file__}, "
                 f"not from {root}")
    S = cs._rtc_sources()
    mod = rtc.CudaModule(S.SOURCE, exports=S.EXPORTS)
    out = dict(tag=args.tag, root=root, card=cs.card_line(),
               **cs.rtc_launch_costs(mod))
    gen = torch.Generator(device="cuda").manual_seed(16)
    out["cases"] = cs.rtc_gelu_cases(mod, gen)
    try:
        out["graph"] = cs.rtc_graph_replay(mod)
    except Exception as e:      # the parent may not record; say how
        out["graph"] = dict(error=f"{type(e).__name__}: {e}")
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
