#!/usr/bin/env python3
"""Device memory of a served run whose pool grows, with the outgrown
pool freed at the growth (what ``DecodeServer`` does) and kept alive
(its programs, step graph and state held to the server's end), on one
card.

    python3 serve_grow_ab.py [--pairs N]

Serves ``chip_smoke.py`` phase 12b's requests (Llama-7B at full width
and depth, bf16, int8 weights, pools of 4 and 8 slots: the pool grows
once) on the server's own thread, in the order kept, freed, freed, kept
(``--pairs`` such pairs of pairs, default 1), all in one process.  For
each run it prints the peak allocated above the memory allocated just
before (``max_memory_allocated``), what the server still holds once its
requests are done and before it closes, tokens/s and each request's
first token (equal in both arms).
"""
import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=1)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch
    import chip_smoke as cs
    from mxnet_tpu_torch import _build
    from mxnet_tpu_torch.models import llama_7b
    from mxnet_tpu_torch.serve import DecodeServer

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    print("card:", cs.card_line(), flush=True)
    _build.build()
    model, cfg = llama_7b(dtype=torch.bfloat16)
    model.initialize(0.02, seed=0)
    grow = DecodeServer._maybe_grow

    def kept(srv):
        srv.__dict__.setdefault("_kept", []).append((srv._progs,
                                                     srv._state))
        grow(srv)

    kw = dict(pool_sizes=(4, 8), max_total_len=cs.L7_TOTAL,
              prefill_buckets=cs.L7_BUCKETS, page_size=16)
    # one untimed run first: the int8 codes, cuBLAS and the kernels
    cs.serve_run(model, cs.llama_scenario(cfg.vocab_size), "warm",
                 threaded=True, **kw)
    for arm in ("kept", "freed", "freed", "kept") * args.pairs:
        run = None                  # the last run's server and its pools
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        DecodeServer._maybe_grow = kept if arm == "kept" else grow
        try:
            _, toks, run = cs.serve_run(
                model, cs.llama_scenario(cfg.vocab_size), arm,
                threaded=True, keep=True, **kw)
        finally:
            DecodeServer._maybe_grow = grow
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - base
        run["server"].close(drain=False)
        peak = torch.cuda.max_memory_allocated() - base
        print(f"serve_grow_ab {arm}: peak above the base {peak} B, held "
              f"after the run {held} B (base {base} B); tokens/s "
              f"{run['tokens_per_s']:.2f}; pool grows "
              f"{run['counters']['pool_grows']}; first tokens "
              f"{[t[0] for t in toks]}", flush=True)


if __name__ == "__main__":
    main()
