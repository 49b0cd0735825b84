#!/usr/bin/env python3
"""Time the host side of ``chip_smoke.py`` phase 21's data path on the
card's machine: how fast the DataLoader assembles batches, alone.

    python3 loader_ab.py

writes phase 21's record file (1,536 raw 256 x 256 x 3 images) to a
temporary directory, then, with PyTorch's intra-op threads left as they
are and then set to 1:

- ``one_thread_ms_per_image``: one sample through phase 21's training
  transform (unpack, ``RandomCropAug(224)``, ``HorizontalFlipAug``,
  ``CastAug``, ``ColorNormalizeAug``) on this thread, 128 samples;
- ``loader_ms_per_batch_w4`` / ``_w8``: an epoch of phase 21's loader
  (pinned staging, the ring on the card) at 4 and 8 worker threads,
  with no training step, ms a batch.

Prints the card line and one JSON object, and writes it to
``chiprun_out/loader_ab.json``.  Needs a card (the loader's ring is on
it).
"""
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("loader_ab: CUDA is not available")
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.data import RecordFileDataset

    print(f"{cs.card_line()}; {os.cpu_count()} cpus, torch threads "
          f"{torch.get_num_threads()}", flush=True)
    out = {}
    with tempfile.TemporaryDirectory() as d:
        rec, _ = cs.write_records(d)
        sample = cs._raw_transform(mx, cs._augs(mx, True))
        ds = RecordFileDataset(rec)
        for threads in (torch.get_num_threads(), 1):
            torch.set_num_threads(threads)
            for i in range(8):
                sample(ds[i])
            t0 = time.perf_counter()
            for i in range(cs.RESNET_B):
                sample(ds[i])
            out[f"one_thread_ms_per_image_torch{threads}"] = \
                (time.perf_counter() - t0) / cs.RESNET_B * 1e3
            for nw in (4, 8):
                loader = cs.data_loader(mx, rec, True, 3, mx.gpu(),
                                        num_workers=nw)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                n = sum(1 for _ in loader)
                torch.cuda.synchronize()
                out[f"loader_ms_per_batch_w{nw}_torch{threads}"] = \
                    (time.perf_counter() - t0) / n * 1e3
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "loader_ab.json"),
              "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
