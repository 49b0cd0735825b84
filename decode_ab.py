#!/usr/bin/env python3
"""Time one checkout of the PyTorch port's int8 serving path on one card,
so that two checkouts can be compared run against run.

    python3 decode_ab.py [--root DIR] [--tag NAME] [--serve-runs N]

imports ``mxnet_tpu_torch`` from DIR (default: beside this file) and the
timers and serving run of this file's own ``chip_smoke.py``, so both
checkouts are measured by the same code, then prints one JSON line:

- ``host_us``: host microseconds a ``q8_matvec`` call (kernel K4) at each
  of GPT-2 small's five decode shapes with 8 rows: the median of five
  runs of 200 calls enqueued with no synchronisation between them (fewer
  than the launch queue holds, so the host does not wait for the card);
- ``k4``: per shape and for the 8-row serving step (49 launches), K4 and
  the library call ``x @ wt.to(bf16)`` by both of ``chip_smoke``'s
  timers: ``cuda_ms`` (the calls run as the host enqueues them) and
  ``cuda_ms_queued`` (queued behind a spin kernel, the host out of the
  way);
- ``serve``: tokens/s and wall seconds of ``chip_smoke.serve`` (GPT-2
  small bf16, int8 pools of 4 and 8, six prompts, 32 new tokens each),
  ``--serve-runs`` times after one untimed run.

Run it once per checkout, in separate processes, in the order parent,
change, change, parent.
"""
import argparse
import importlib.util
import json
import os
import sys
import time

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
    ap.add_argument("--serve-runs", type=int, default=3)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("decode_ab.py: CUDA is not available")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    cs = _chip_smoke()
    import mxnet_tpu_torch
    from mxnet_tpu_torch.models import gpt2_small
    from mxnet_tpu_torch.ops.q8_matvec import q8_matvec

    if not mxnet_tpu_torch.__file__.startswith(root):
        sys.exit(f"decode_ab.py: imported {mxnet_tpu_torch.__file__}, "
                 f"not from {root}")
    model, cfg = gpt2_small(dtype=torch.bfloat16)
    model.initialize(0.02, seed=0)
    U, F = cfg.units, cfg.hidden_size
    Vp = -(-cfg.vocab_size // 128) * 128
    layers = cfg.num_layers
    shapes = [("qkv", U, 3 * U, True, layers), ("proj", U, U, True, layers),
              ("fc1", U, F, True, layers), ("fc2", F, U, True, layers),
              ("head", U, Vp, False, 1)]
    gen = torch.Generator(device="cuda").manual_seed(4)
    out = dict(tag=args.tag, root=root, card=cs.card_line(), host_us={},
               k4={}, serve=[])
    step = dict(ms=0.0, queued_ms=0.0, library_ms=0.0,
                library_queued_ms=0.0)
    for name, K, O, has_bias, calls in shapes:
        copies = max(2, -(-120_000_000 // (K * O)))
        wts = [torch.randint(-127, 128, (K, O), generator=gen,
                             device="cuda", dtype=torch.int8)
               for _ in range(copies)]
        x = torch.randn((8, K), generator=gen, device="cuda").bfloat16()
        s = torch.rand((O,), generator=gen, device="cuda") + 0.5
        b = torch.randn((O,), generator=gen, device="cuda") \
            if has_bias else None
        n = len(wts)

        def k4(i):
            return q8_matvec(x, wts[i % n], s, b)

        def lib(i):
            return x @ wts[i % n].to(torch.bfloat16)

        hosts = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(200):
                k4(i)
            hosts.append((time.perf_counter() - t0) / 200 * 1e6)
        torch.cuda.synchronize()
        host = sorted(hosts)[2]
        row = dict(ms=cs.cuda_ms(k4, 50), queued_ms=cs.cuda_ms_queued(k4, 50),
                   library_ms=cs.cuda_ms(lib, 10),
                   library_queued_ms=cs.cuda_ms_queued(lib, 10))
        out["host_us"][name] = host
        out["k4"][name] = row
        for k in step:
            step[k] += calls * row[k]
        del wts
    out["k4"]["step"] = step
    cs.serve(model, cfg, counted=False)             # untimed
    for _ in range(args.serve_runs):
        prompts, toks, run = cs.serve(model, cfg, counted=True)
        out["serve"].append(dict(
            tokens_per_s=len(prompts) * cs.NEW_TOKENS / run["wall_s"],
            wall_s=run["wall_s"], steps=run["counters"]["step_dispatches"],
            q8_matvec=run["launches"]["q8_matvec"]))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
