#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one
NVIDIA H100.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (each fails the run by raising; there is no CPU path):

1. the card's name and power limit (``nvidia-smi``), torch and CUDA
   versions;
2. build every kernel from ``mxnet_tpu_torch/csrc`` (one ``nvcc`` per
   source, all at once) and print the build seconds and ptxas reports;
3. K4 (``q8_matvec``) against its plain version in bf16 at the five
   GPT-2-small decode shapes with 8 rows, with kernel, plain, library
   (``x @ wt.to(bf16)``) and bound times;
4. K1 (flash forward) against its plain version in bf16 at the shape
   the serving prefill and the training step give it (8 rows, 12 heads,
   1024 tokens, head dim 64, causal), and once more with a key mask and
   dropout, with kernel, plain, library (``scaled_dot_product_attention``)
   and bound times;
5. K2 and K3 (flash backward: dq; dk, dv, dbias) against their plain
   versions in bf16 at the training shape, and at 2 x 12 x 640 with a
   key mask, dbias and dropout 0.1, with kernel, plain and bound times,
   and K1+K2+K3 forward and backward beside ``scaled_dot_product_attention``
   forward and backward (the library's backward alone is K2's and K3's
   library time);
6. serving: GPT-2 small at full width in bf16 (seeded random weights)
   through ``DecodeServer(weights="int8", pool_sizes=(4, 8))`` — six
   ragged greedy requests, the 700-token one arriving after the others
   were admitted, so its wave runs K1 (a 1024 bucket); every decode
   step runs K4 49 times — held against the port's own batch-1
   ``kv_generate`` (first tokens equal, whole-stream agreement >= 0.9),
   then once more under ``torch.profiler`` for the device time by
   kernel, then the same weights in float32 in one wave, held the same
   way;
7. training, the second slice's path: GPT-2 small at full width in
   bf16 with dropout 0.1, 8 x 1024 tokens, ``parallel.SPMDTrainer`` with
   AdamW (multi-precision), one ``step`` then ``run_steps`` over 19 more
   of the same batch; every layer runs K1 forward and K2/K3 backward, so
   each launches exactly 12 times a step; the losses must be finite,
   start near ln(vocab) and fall; tokens/s, ms per step and peak memory;
   then two more steps under ``torch.profiler``, device time by kernel
   and by group (attention kernels, GEMMs, the rest);
8. one f32 AdamW step of a 2-layer GPT-2-width model at 1 x 1024 on the
   card (kernels) held against the same step on the CPU (plain
   versions), loss and updated weights;
9. BERT-base as ``bench.py`` trains it (seq 128, batch 64, bf16, AdamW
   1e-4; its attention takes the plain path, no kernel): five steps,
   finite and falling losses, tokens/s;
10. K5 (the fused decode step, ``ops.decode_fused.decode_step``) against
   its plain version in bf16, native and int8 streams, at four shapes:
   GPT-2 small (12 layers, B=4, T=768) at position 700 and at position
   0, Llama-7B widths (2 layers, B=1, T=64) and its grouped-query variant
   (8 KV heads, 2 layers, B=2); the output and the written K/V column
   within 6 bf16 steps of their magnitude, the rest of the caches bit for
   bit; K5 ms a token beside its byte bound, the plain version's ms and
   the port's unfused step's (no single PyTorch call computes K5's
   function, so the unfused step is its yardstick);
11. the third slice's path: GPT-2 small through ``kv_generate(fused=
   "on")``, 4 x 640-token prompts and 128 new tokens, greedy, native and
   int8: K5 launched 127 times a run, K1 12 times, K4 (the int8 head) 127
   times; tokens/s beside ``fused="off"``; agreement with the unfused
   step teacher-forced (the unfused step fed the fused stream's tokens
   must predict its next token >= 0.9 of the time); one ``prefill=
   "scan"`` run (1 x 64 + 64, K5 launched 127 times); one profiled fused
   step (K5, and no GEMM or attention kernel between the embedding and
   ``ln_f``);
12. Llama-7B at full depth (32 layers, bf16), 1 x 32 + 32 tokens, native
   and int8: K5 launched 31 times each, tokens/s fused and unfused,
   teacher-forced agreement >= 0.9;
13. K6 (the fused 1x1-convolution backward, ``ops.conv_fused.
   conv1x1_bwd_pair``) against its plain version at the nine stride-1 1x1
   shapes of ResNet-50 at batch 128 in bf16 and one in f32: dx within 2
   bf16 steps (f32: 1e-5) of its magnitude, dW within 1e-3 (f32: 1e-5) of
   its magnitude and bit for bit across two launches; K6 ms beside its
   bound, the plain version's ms, cuDNN's backward
   (``aten.convolution_backward``, one call for dx and dW: the library
   time) and cuBLAS's two products;
14. the fourth slice's path: ResNet-50 v1 (``get_resnet(1, 50,
   classes=1000, layout="NHWC")``, Xavier, ``cast("bfloat16")``) trained
   by ``parallel.SPMDTrainer`` with SGD (lr 0.1, momentum 0.9, wd 1e-4)
   on one synthetic batch of 128 x 3 x 224 x 224, 20 steps, with
   ``MXNET_FUSED_CONV_BWD=1``: K6 launched exactly 30 times a step, losses
   finite, the first within 1.0 of ln(1000), falling; ms a step, images/s
   and peak memory; then one profiled step, device time split among K6,
   cuDNN convolutions, GEMMs, BatchNorm, the optimizer and the rest; then
   the same 20 steps with the switch off (cuDNN's backward, no K6);
15. one SGD step of a small bottleneck ResNet (f32, TF32 off) on the card
   (K6) held against the same step on the CPU (its plain version);
16. one ``{"kernels": [...]}`` line, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.

It exits nonzero without CUDA, and when the package is not beside it.
A copy of the results goes to ``chiprun_out/chip_smoke.json``.
"""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BF16_OPS_PER_S = 989e12            # dense bf16 tensor-core peak
F32_OPS_PER_S = 67e12              # f32 on the CUDA cores (no tensor cores)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warm=3):
    """Mean device milliseconds of ``fn(i)`` over ``iters`` calls, timed
    with CUDA events after ``warm`` untimed calls."""
    import torch

    for i in range(warm):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, nops, ops_per_s=BF16_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# --------------------------------------------------------------------------- #
# phase 3: K4
# --------------------------------------------------------------------------- #

def check_k4(cfg):
    import torch
    from mxnet_tpu_torch.ops.q8_matvec import q8_matvec, q8_matvec_plain

    U, F, V = cfg.units, cfg.hidden_size, cfg.vocab_size
    Vp = -(-V // 128) * 128
    S = 8
    # (name, K, O, has_bias, calls per decode step)
    shapes = [("qkv", U, 3 * U, True, cfg.num_layers),
              ("proj", U, U, True, cfg.num_layers),
              ("fc1", U, F, True, cfg.num_layers),
              ("fc2", F, U, True, cfg.num_layers),
              ("head", U, Vp, False, 1)]
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows, step = [], dict(ms=0.0, plain_ms=0.0, library_ms=0.0,
                          bound_ms=0.0, bytes=0, ops=0)
    max_err = 0.0
    for name, K, O, has_bias, calls in shapes:
        # enough weight copies to exceed the 50 MB L2: each timed launch
        # streams its codes from device memory, as a decode step does
        copies = max(2, -(-120_000_000 // (K * O)))
        wts = [torch.randint(-127, 128, (K, O), generator=gen,
                             device="cuda", dtype=torch.int8)
               for _ in range(copies)]
        x = torch.randn((S, K), generator=gen, device="cuda").bfloat16()
        s = (torch.rand((O,), generator=gen, device="cuda") + 0.5) * \
            (2.0 / (127.0 * K ** 0.5))
        b = torch.randn((O,), generator=gen, device="cuda") \
            if has_bias else None
        got = q8_matvec(x, wts[0], s, b)
        ref = q8_matvec_plain(x, wts[0], s, b)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        tol = 1e-4 * max(1.0, ref.abs().max().item())
        if not torch.isfinite(got).all() or err > tol:
            fail(f"K4 {name} (S={S}, K={K}, O={O}): max_abs_err {err} > "
                 f"{tol}")
        max_err = max(max_err, err)
        n = len(wts)
        ms = cuda_ms(lambda i: q8_matvec(x, wts[i % n], s, b), 50)
        plain = cuda_ms(lambda i: q8_matvec_plain(x, wts[i % n], s, b), 10)
        lib = cuda_ms(lambda i: x @ wts[i % n].to(torch.bfloat16), 10)
        nbytes = S * K * 2 + K * O + 4 * O * (2 if has_bias else 1) + \
            4 * S * O
        nops = 2 * S * K * O
        bms, by = bound_ms(nbytes, nops)
        rows.append(dict(shape=name, S=S, K=K, O=O, max_abs_err=err,
                         tol=tol, ms=ms, plain_ms=plain, library_ms=lib,
                         bound_ms=bms, bound_by=by))
        print(f"K4 {name:5s} S={S} K={K:5d} O={O:6d}: max_abs_err={err:.3e}"
              f" (tol {tol:.3e}) kernel_ms={ms:.5f} plain_ms={plain:.5f} "
              f"library_ms={lib:.5f} bound_ms={bms:.5f} ({by})", flush=True)
        step["ms"] += calls * ms
        step["plain_ms"] += calls * plain
        step["library_ms"] += calls * lib
        step["bytes"] += calls * nbytes
        step["ops"] += calls * nops
        del wts
    step["bound_ms"], step["bound_by"] = bound_ms(step["bytes"],
                                                  step["ops"])
    print(f"K4 per decode step ({4 * cfg.num_layers + 1} launches, S={S}): "
          f"kernel_ms={step['ms']:.5f} plain_ms={step['plain_ms']:.5f} "
          f"library_ms={step['library_ms']:.5f} bound_ms="
          f"{step['bound_ms']:.5f} ({step['bytes']} bytes)", flush=True)
    return dict(max_abs_err=max_err, shapes=rows, **step)


# --------------------------------------------------------------------------- #
# phase 4: K1
# --------------------------------------------------------------------------- #

def check_k1(cfg, B):
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.attention import flash_fwd, flash_fwd_plain

    H = cfg.num_heads
    D = cfg.units // H
    gen = torch.Generator(device="cuda").manual_seed(5)
    results = []
    cases = [("prefill_causal", B, 1024, 1024, True, False, 0.0),
             ("kmask_dropout", 2, 384, 384, False, True, 0.1)]
    for name, b, L, Lk, causal, masked, rate in cases:
        q, k, v = (torch.randn((b, H, n, D), generator=gen, device="cuda")
                   .bfloat16() for n in (L, Lk, Lk))
        km = None
        if masked:
            km = torch.zeros((b, 1, Lk), device="cuda")
            km[0, 0, Lk - 50:] = -1e30
            km[1, 0, Lk - 7:] = -1e30
        scale = D ** -0.5
        out, lse = flash_fwd(q, k, v, scale, causal, km, 1234, rate)
        ro, rl = flash_fwd_plain(q, k, v, scale, causal, km, 1234, rate)
        torch.cuda.synchronize()
        err = (out.float() - ro.float()).abs().max().item()
        lerr = (lse - rl).abs().max().item()
        if not torch.isfinite(out.float()).all() or err > 2e-2 or \
                lerr > 1e-3:
            fail(f"K1 {name}: out max_abs_err {err} (tol 2e-2), lse "
                 f"max_abs_err {lerr} (tol 1e-3)")
        ms = cuda_ms(lambda i: flash_fwd(q, k, v, scale, causal, km, 1234,
                                         rate), 20)
        plain = cuda_ms(lambda i: flash_fwd_plain(q, k, v, scale, causal,
                                                  km, 1234, rate), 5)
        mask4 = None if km is None else km.reshape(b, 1, 1, Lk).bfloat16()
        lib = cuda_ms(lambda i: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask4, dropout_p=rate, is_causal=causal),
            20)
        pairs = sum(min(qp + 1, Lk) for qp in range(L)) if causal \
            else L * Lk
        nbytes = 2 * b * H * D * (2 * L + 2 * Lk) + 4 * b * H * L + \
            (0 if km is None else 4 * b * Lk)
        nops = 4 * b * H * D * pairs
        bms, by = bound_ms(nbytes, nops)
        print(f"K1 {name} B={b} H={H} L={L} Lk={Lk} D={D} causal={causal} "
              f"mask={masked} dropout={rate}: out max_abs_err={err:.3e} "
              f"(tol 2e-2) lse max_abs_err={lerr:.3e} (tol 1e-3) "
              f"kernel_ms={ms:.5f} plain_ms={plain:.5f} library_ms="
              f"{lib:.5f} bound_ms={bms:.5f} ({by})", flush=True)
        results.append(dict(case=name, B=b, H=H, L=L, Lk=Lk, D=D,
                            max_abs_err=err, lse_err=lerr, ms=ms,
                            plain_ms=plain, library_ms=lib, bound_ms=bms,
                            bound_by=by))
    return results


# --------------------------------------------------------------------------- #
# phase 5: K2 / K3
# --------------------------------------------------------------------------- #

def _causal_pairs(L, Lk, causal):
    return sum(min(qp + 1, Lk) for qp in range(L)) if causal else L * Lk


def check_k23(cfg, B):
    """K2 and K3 against their plain versions (f32 outputs: tolerance
    2e-3 of each output's magnitude, as the two sum the same products in
    other orders), their times and bounds, and K1+K2+K3 forward and
    backward beside the library's attention."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import attention as pa

    H = cfg.num_heads
    D = cfg.units // H
    gen = torch.Generator(device="cuda").manual_seed(7)
    results = []
    cases = [("train_causal", B, 1024, 1024, True, False, 0.0),
             ("ragged_kmask_dropout", 2, 640, 640, False, True, 0.1)]
    for name, b, L, Lk, causal, masked, rate in cases:
        q, k, v = (torch.randn((b, H, n, D), generator=gen, device="cuda")
                   .bfloat16() for n in (L, Lk, Lk))
        g = torch.randn((b, H, L, D), generator=gen,
                        device="cuda").bfloat16()
        km = None
        if masked:
            km = torch.zeros((b, 1, Lk), device="cuda")
            km[0, 0, Lk - 50:] = -1e30
            km[1, 0, Lk - 7:] = -1e30
        scale = D ** -0.5
        out, lse = pa.flash_fwd(q, k, v, scale, causal, km, 1234, rate)
        delta = (out.float() * g.float()).sum(-1)
        args = (q, k, v, g, lse, delta, scale, causal, km, 1234, rate)
        dq = pa.flash_bwd_dq(*args)
        dk, dv, db = pa.flash_bwd_dkv(*args, need_dbias=masked)
        rdq = pa.flash_bwd_dq_plain(*args)
        rdk, rdv, rdb = pa.flash_bwd_dkv_plain(*args, need_dbias=masked)
        torch.cuda.synchronize()
        errs = {}
        for what, got, ref in (("dq", dq, rdq), ("dk", dk, rdk),
                               ("dv", dv, rdv), ("dbias", db, rdb)):
            if ref is None:
                continue
            err = (got - ref).abs().max().item()
            tol = 2e-3 * max(1.0, ref.abs().max().item())
            if not torch.isfinite(got).all() or err > tol:
                fail(f"K2/K3 {name} {what}: max_abs_err {err} > {tol}")
            errs[what] = (err, tol)
        pairs = b * H * _causal_pairs(L, Lk, causal)
        in_bytes = 2 * b * H * D * (2 * L + 2 * Lk) + 8 * b * H * L + \
            (0 if km is None else 4 * b * Lk)
        k2_bms, k2_by = bound_ms(in_bytes + 4 * b * H * L * D,
                                 6 * D * pairs)
        k3_bms, k3_by = bound_ms(in_bytes + 8 * b * H * Lk * D +
                                 (4 * b * H * Lk if masked else 0),
                                 8 * D * pairs)
        k2_ms = cuda_ms(lambda i: pa.flash_bwd_dq(*args), 20)
        k3_ms = cuda_ms(lambda i: pa.flash_bwd_dkv(*args,
                                                   need_dbias=masked), 20)
        k2_plain = cuda_ms(lambda i: pa.flash_bwd_dq_plain(*args), 5)
        k3_plain = cuda_ms(lambda i: pa.flash_bwd_dkv_plain(
            *args, need_dbias=masked), 5)
        # forward + backward: K1+K2+K3 through the autograd Function, and
        # the library's attention through autograd; the library's
        # backward alone (its dq, dk, dv) is K2's and K3's yardstick
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        bias = None if km is None else km.reshape(b, 1, 1, Lk)
        mask4 = None if km is None else bias.bfloat16()

        def ours(i):
            o = pa._FlashAttention.apply(*leaves, bias, scale, causal, 1234,
                                         rate)
            torch.autograd.grad(o, leaves, g)

        def sdpa(i):
            o = F.scaled_dot_product_attention(
                *leaves, attn_mask=mask4, dropout_p=rate, is_causal=causal)
            torch.autograd.grad(o, leaves, g)

        o_lib = F.scaled_dot_product_attention(
            *leaves, attn_mask=mask4, dropout_p=rate, is_causal=causal)
        fb_ms = cuda_ms(ours, 10)
        lib_fb_ms = cuda_ms(sdpa, 10)
        lib_bwd_ms = cuda_ms(lambda i: torch.autograd.grad(
            o_lib, leaves, g, retain_graph=True), 10)
        del o_lib
        row = dict(case=name, B=b, H=H, L=L, Lk=Lk, D=D, causal=causal,
                   mask=masked, dropout=rate,
                   max_abs_err={w: e for w, (e, _) in errs.items()},
                   tol={w: t for w, (_, t) in errs.items()},
                   k2=dict(ms=k2_ms, plain_ms=k2_plain, bound_ms=k2_bms,
                           bound_by=k2_by, library_ms=lib_bwd_ms),
                   k3=dict(ms=k3_ms, plain_ms=k3_plain, bound_ms=k3_bms,
                           bound_by=k3_by, library_ms=lib_bwd_ms),
                   fwd_bwd_ms=fb_ms, library_fwd_bwd_ms=lib_fb_ms)
        print(f"K2/K3 {name} B={b} H={H} L={L} Lk={Lk} D={D} causal="
              f"{causal} mask={masked} dropout={rate}: max_abs_err "
              + " ".join(f"{w}={e:.3e} (tol {t:.3e})"
                         for w, (e, t) in errs.items()), flush=True)
        print(f"K2 {name}: kernel_ms={k2_ms:.5f} plain_ms={k2_plain:.5f} "
              f"bound_ms={k2_bms:.5f} ({k2_by}); K3 {name}: kernel_ms="
              f"{k3_ms:.5f} plain_ms={k3_plain:.5f} bound_ms={k3_bms:.5f} "
              f"({k3_by}); library backward (dq, dk, dv) ms="
              f"{lib_bwd_ms:.5f}", flush=True)
        print(f"attention fwd+bwd {name}: K1+K2+K3 ms={fb_ms:.5f} "
              f"scaled_dot_product_attention ms={lib_fb_ms:.5f}",
              flush=True)
        results.append(row)
    return results


# --------------------------------------------------------------------------- #
# phase 6: serving
# --------------------------------------------------------------------------- #

PROMPT_LENS = (7, 100, 700, 33, 250, 512)
NEW_TOKENS = 32


def serve(model, cfg, counted=True):
    """Serve the six prompts; returns the streams, counts and timings.
    With ``counted`` (the main path) the kernels' launch counts are set
    to 0 just before the requests and read just after, and the 700-token
    prompt arrives after the others were admitted (a second wave, mid
    run); otherwise all six go in one wave."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.ops.attention import flash_fwd
    from mxnet_tpu_torch.ops.q8_matvec import q8_matvec
    from mxnet_tpu_torch.serve import DecodeServer

    rs = np.random.RandomState(6)
    prompts = [rs.randint(0, cfg.vocab_size, (n,)) for n in PROMPT_LENS]
    late = PROMPT_LENS.index(max(PROMPT_LENS)) if counted else None
    srv = DecodeServer(model, weights="int8", pool_sizes=(4, 8),
                       autostart=True)
    try:
        # warm-up: a first request so the timed run does not hold the
        # allocator's and cuBLAS's first-call set-up
        srv.submit(prompts[0][:5], max_new_tokens=3).tokens(300)
        srv.reset_counters()
        q8_matvec.launches = 0
        flash_fwd.launches = 0
        t0 = time.perf_counter()
        streams = [None if i == late else
                   srv.submit(p, max_new_tokens=NEW_TOKENS)
                   for i, p in enumerate(prompts)]
        if late is not None:
            first = next(s for s in streams if s is not None)
            while not first.times:        # the first wave is admitted
                time.sleep(0.001)
            streams[late] = srv.submit(prompts[late],
                                       max_new_tokens=NEW_TOKENS)
        toks = [s.tokens(600) for s in streams]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"q8_matvec": q8_matvec.launches,
                    "flash_fwd": flash_fwd.launches}
        counters = dict(srv.counters)
        ttft = [s.ttft for s in streams]
    finally:
        srv.close(drain=False)
    return prompts, toks, dict(launches=launches, counters=counters,
                               wall_s=wall, ttft_s=ttft)


def check_streams(model, cfg, prompts, toks, what):
    """Each stream has its full budget and valid tokens, its first token
    equals the port's batch-1 ``kv_generate`` (greedy, int8) and the
    whole-stream agreement is at least 0.9."""
    from mxnet_tpu_torch.models import kv_generate

    agree = 0
    first_ok = True
    for i, (p, tk) in enumerate(zip(prompts, toks)):
        if len(tk) != NEW_TOKENS:
            fail(f"{what}: request {i} emitted {len(tk)} of {NEW_TOKENS}")
        if not all(0 <= x < cfg.vocab_size for x in tk):
            fail(f"{what}: request {i} emitted a token outside the vocab")
        ref = list(kv_generate(model, p[None], NEW_TOKENS, temperature=0.0,
                               weights="int8")[0, p.size:])
        same = sum(int(a == b) for a, b in zip(tk, ref))
        agree += same
        first_ok &= tk[0] == ref[0]
        print(f"{what}: request {i} (len {p.size}): first token served "
              f"{tk[0]} reference {ref[0]}; stream agreement "
              f"{same}/{NEW_TOKENS}", flush=True)
    rate = agree / (NEW_TOKENS * len(prompts))
    print(f"{what}: whole-stream agreement with kv_generate = {rate:.4f}",
          flush=True)
    if not first_ok:
        fail(f"{what}: a served first token differs from kv_generate's")
    if rate < 0.9:
        fail(f"{what}: stream agreement {rate:.4f} < 0.9")
    return rate


def check_serving(model, cfg):
    prompts, toks, run = serve(model, cfg)
    steps = run["counters"]["step_dispatches"]
    per_step = 4 * cfg.num_layers + 1
    launches = run["launches"]
    print(f"serve: {len(prompts)} requests, prompt lens {PROMPT_LENS}, "
          f"{NEW_TOKENS} new tokens each; counters {run['counters']}; "
          f"launches {launches}", flush=True)
    if launches["q8_matvec"] != per_step * steps:
        fail(f"K4 launched {launches['q8_matvec']} times over {steps} "
             f"decode steps, expected {per_step} per step")
    if launches["flash_fwd"] <= 0:
        fail("K1 was never launched on the serving path")
    ttft = run["ttft_s"]
    gen_tokens = len(prompts) * NEW_TOKENS
    run["tokens_per_s"] = gen_tokens / run["wall_s"]
    print(f"serve: tokens/s={run['tokens_per_s']:.2f} wall_s="
          f"{run['wall_s']:.4f} ttft_s mean={sum(ttft) / len(ttft):.4f} "
          f"max={max(ttft):.4f} steps={steps} admits="
          f"{run['counters']['admit_dispatches']}", flush=True)
    run["agreement"] = check_streams(model, cfg, prompts, toks, "serve")
    return run


def _profiled(fn):
    """Run ``fn()`` under ``torch.profiler``; returns the device time by
    kernel name (us), the busy sum and the window (us).  The profiler's
    host overhead makes the window slower than an unprofiled run, so
    only its shares are read, never its rate."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        by_name[ev.key] = by_name.get(ev.key, 0.0) + us
    return by_name, sum(by_name.values()), wall_us


def report_profile(what, by_name, busy, wall_us, top=8):
    if busy <= 0:
        print(f"{what}: the profiler recorded no device time (not "
              "measured)", flush=True)
        return dict(device_us=None)
    print(f"{what}: device busy {busy / wall_us:.4f} of the profiled "
          f"window ({busy:.0f} of {wall_us:.0f} us)", flush=True)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    for name, us in ranked:
        print(f"{what}: {us / busy:.4f} {us:.0f} us {name[:90]}",
              flush=True)
    return dict(device_us=busy, window_us=wall_us,
                top=[dict(name=n, us=u) for n, u in ranked])


def profile_serving(model, cfg):
    """Where the serving run's device time goes: the same six requests
    once more (one wave) under ``torch.profiler``, kernel time summed by
    name."""
    return report_profile("profile", *_profiled(
        lambda: serve(model, cfg, counted=False)))


def check_serving_f32(cfg):
    """The same weights in float32, all six prompts in ONE wave (so the
    short prompts ride the 1024 bucket through K1 while their batch-1
    references take the plain path): bf16 rounding no longer decides
    near-tied greedy steps, so this pins the scheduler and the paged
    pool on the card."""
    import torch
    from mxnet_tpu_torch.models import gpt2_small

    model, _ = gpt2_small(dtype=torch.float32)
    model.initialize(0.02, seed=0)
    prompts, toks, _ = serve(model, cfg, counted=False)
    return check_streams(model, cfg, prompts, toks, "serve_f32")


# --------------------------------------------------------------------------- #
# phase 7: training (the second slice's path)
# --------------------------------------------------------------------------- #

TRAIN_B, TRAIN_T, TRAIN_STEPS = 8, 1024, 20


def check_training(cfg):
    """GPT-2 small, bf16, dropout 0.1, AdamW (multi-precision) on one
    repeated batch: ``step`` once, then ``run_steps`` over the rest.  The
    launch counts are set to 0 just before and read just after."""
    import math

    import numpy as np
    import torch
    from mxnet_tpu_torch import gluon, parallel, random
    from mxnet_tpu_torch.models import gpt2_small
    from mxnet_tpu_torch.ops import attention as pa

    random.seed(0)
    model, _ = gpt2_small(dtype=torch.bfloat16, dropout=0.1)
    model.initialize(0.02, seed=0)
    rs = np.random.RandomState(8)
    data = torch.as_tensor(rs.randint(0, cfg.vocab_size,
                                      (TRAIN_B, TRAIN_T)), device="cuda")
    label = torch.as_tensor(rs.randint(0, cfg.vocab_size,
                                       (TRAIN_B, TRAIN_T)), device="cuda")
    trainer = parallel.SPMDTrainer(
        model, gluon.loss.SoftmaxCrossEntropyLoss(), "adamw",
        {"learning_rate": 1e-4, "wd": 0.01, "multi_precision": True})
    rest = TRAIN_STEPS - 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in (pa.flash_fwd, pa.flash_bwd_dq, pa.flash_bwd_dkv):
        fn.launches = 0
    t0 = time.perf_counter()
    first = trainer.step(data, label)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    more = trainer.run_steps(data[None].expand(rest, -1, -1),
                             label[None].expand(rest, -1, -1))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {"flash_fwd": pa.flash_fwd.launches,
                "flash_bwd_dq": pa.flash_bwd_dq.launches,
                "flash_bwd_dkv": pa.flash_bwd_dkv.launches}
    peak = torch.cuda.max_memory_allocated()
    losses = [float(first)] + [float(x) for x in more.float().cpu()]
    step_ms = (t2 - t1) / rest * 1e3
    tok_s = rest * TRAIN_B * TRAIN_T / (t2 - t1)
    print(f"train: gpt2_small bf16 dropout 0.1, B={TRAIN_B} T={TRAIN_T}, "
          f"{TRAIN_STEPS} steps; losses {[round(x, 4) for x in losses]}",
          flush=True)
    print(f"train: tokens/s={tok_s:.2f} ms/step={step_ms:.3f} (steps 2-"
          f"{TRAIN_STEPS}; first step {(t1 - t0) * 1e3:.3f} ms) "
          f"max_memory_allocated={peak} launches {launches}", flush=True)
    expect = cfg.num_layers * TRAIN_STEPS
    for name, n in launches.items():
        if n != expect:
            fail(f"training launched {name} {n} times, expected "
                 f"{cfg.num_layers} per step x {TRAIN_STEPS} = {expect}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"training losses not finite: {losses}")
    if abs(losses[0] - math.log(cfg.vocab_size)) > 0.5:
        fail(f"first loss {losses[0]} is not within 0.5 of ln(vocab) "
             f"{math.log(cfg.vocab_size)}")
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        fail(f"training loss did not fall: {losses}")
    # where a step's device time goes: two more steps, profiled, with the
    # kernel time grouped into attention (K1/K2/K3), GEMMs and the rest
    by_name, busy, wall_us = _profiled(lambda: trainer.run_steps(
        data[None].expand(2, -1, -1), label[None].expand(2, -1, -1)))
    prof = report_profile("train profile", by_name, busy, wall_us, top=10)
    groups = {"attention kernels": ("flash_",),
              "GEMMs": ("gemm", "gemv", "xmma", "cutlass", "nvjet",
                        "sm90_")}
    shares = {g: sum(us for n, us in by_name.items()
                     if any(k in n for k in keys))
              for g, keys in groups.items()}
    shares["other"] = busy - sum(shares.values())
    if busy > 0:
        print("train profile: by group " + ", ".join(
            f"{g} {us / busy:.4f} ({us / 2e3:.3f} ms/step)"
            for g, us in shares.items()), flush=True)
    prof["groups_us"] = shares
    del trainer, model
    torch.cuda.empty_cache()
    return dict(losses=losses, tokens_per_s=tok_s, ms_per_step=step_ms,
                first_step_ms=(t1 - t0) * 1e3, max_memory_allocated=peak,
                launches=launches, profile=prof)


# --------------------------------------------------------------------------- #
# phase 8: one training step on the card against the CPU
# --------------------------------------------------------------------------- #

CPU_LR = 1e-4


def check_training_vs_cpu():
    """A 2-layer GPT-2-width model (768 units, 12 heads, vocab 50257),
    f32, dropout 0, one AdamW step at 1 x 1024 on the card (K1/K2/K3) and
    on the CPU (their plain versions) from the same weights.  Loss: 1e-4
    relative.  Weights: Adam's first step moves each weight by about
    ``lr`` times the sign of its gradient, so a weight whose gradient is
    near zero may move differently on the two sides (by at most about
    2 lr); every weight must agree within 2.5 lr, and at most 1% of them
    by more than lr / 100."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import gluon, parallel
    from mxnet_tpu_torch.models import gpt2_small

    cpu, _ = gpt2_small(device="cpu", num_layers=2, dtype=torch.float32)
    cpu.initialize(0.02, seed=3)
    card, _ = gpt2_small(num_layers=2, dtype=torch.float32)
    card.load_state_dict(cpu.state_dict())
    rs = np.random.RandomState(9)
    data = rs.randint(0, 50257, (1, TRAIN_T))
    label = rs.randint(0, 50257, (1, TRAIN_T))
    losses = []
    for model in (card, cpu):
        trainer = parallel.SPMDTrainer(
            model, gluon.loss.SoftmaxCrossEntropyLoss(), "adamw",
            {"learning_rate": CPU_LR, "wd": 0.01})
        losses.append(float(trainer.step(data, label)))
    rel = abs(losses[0] - losses[1]) / abs(losses[1])
    worst, n_far, n_all = 0.0, 0, 0
    for a, b in zip(card.parameters(), cpu.parameters()):
        d = (a.detach().cpu() - b.detach()).abs()
        worst = max(worst, d.max().item())
        n_far += int((d > CPU_LR / 100).sum())
        n_all += d.numel()
    share = n_far / n_all
    print(f"train vs cpu: 2-layer f32 step, loss card {losses[0]:.6f} cpu "
          f"{losses[1]:.6f} (rel {rel:.3e}, tol 1e-4); weights max_abs_diff "
          f"{worst:.3e} (tol {2.5 * CPU_LR:.1e}), share beyond lr/100 "
          f"{share:.3e} (tol 1e-2)", flush=True)
    if rel > 1e-4 or worst > 2.5 * CPU_LR or share > 1e-2:
        fail("the card's training step disagrees with the CPU's")
    del card
    torch.cuda.empty_cache()
    return dict(loss_card=losses[0], loss_cpu=losses[1], loss_rel=rel,
                weight_max_abs_diff=worst, share_beyond_lr_100=share)


# --------------------------------------------------------------------------- #
# phase 9: BERT-base, bench.py's configuration (no kernel)
# --------------------------------------------------------------------------- #

def check_bert():
    import math

    import numpy as np
    import torch
    from torch import nn
    from mxnet_tpu_torch import gluon, parallel
    from mxnet_tpu_torch.models import bert_base
    from mxnet_tpu_torch.ops import attention as pa

    B, T, steps = 64, 128, 5
    bert, cfg = bert_base(use_pooler=False, use_mlm=True, vocab_size=30528,
                          max_length=T, dtype=torch.bfloat16)
    bert.initialize(0.02, seed=0)

    class MLMHeadOnly(nn.Module):
        def __init__(self):
            super().__init__()
            self.bert = bert

        def forward(self, tokens):
            return self.bert(tokens)[-1]

    rs = np.random.RandomState(0)
    data = torch.as_tensor(rs.randint(0, cfg.vocab_size, (B, T)),
                           device="cuda")
    label = torch.as_tensor(rs.randint(0, cfg.vocab_size, (B, T)),
                            device="cuda")
    trainer = parallel.SPMDTrainer(MLMHeadOnly(),
                                   gluon.loss.SoftmaxCrossEntropyLoss(),
                                   "adamw", {"learning_rate": 1e-4})
    for fn in (pa.flash_fwd, pa.flash_bwd_dq, pa.flash_bwd_dkv):
        fn.launches = 0
    first = trainer.step(data, label)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    more = trainer.run_steps(data[None].expand(steps - 1, -1, -1),
                             label[None].expand(steps - 1, -1, -1))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    losses = [float(first)] + [float(x) for x in more.float().cpu()]
    kernels = pa.flash_fwd.launches + pa.flash_bwd_dq.launches + \
        pa.flash_bwd_dkv.launches
    tok_s = (steps - 1) * B * T / dt
    print(f"bert: bert_base bf16 (vocab {cfg.vocab_size}), B={B} T={T}, "
          f"{steps} steps; losses {[round(x, 4) for x in losses]}; "
          f"tokens/s={tok_s:.2f} ms/step={dt / (steps - 1) * 1e3:.3f} "
          f"(steps 2-{steps}); attention kernel launches {kernels} (seq "
          f"{T} takes the plain path, as in the reference)", flush=True)
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        fail(f"BERT losses not finite and falling: {losses}")
    del trainer, bert
    torch.cuda.empty_cache()
    return dict(losses=losses, tokens_per_s=tok_s,
                ms_per_step=dt / (steps - 1) * 1e3, kernel_launches=kernels)


# --------------------------------------------------------------------------- #
# phase 10: K5, the fused decode step, against its plain version
# --------------------------------------------------------------------------- #

# tolerance: bf16 steps (ulps) at the output's largest magnitude.  K5 and
# its plain version sum every projection in other orders and round each
# to bf16, and each of up to 12 layers adds its residual in bf16, so a
# one-step difference can compound; the largest measured on an H100 was
# 4.0 steps (GPT-2 small, 12 layers, native, position 0)
K5_STEPS = 6


def _bf16_step(t):
    """One bf16 step (ulp) at the largest magnitude of ``t``."""
    import math

    m = t.float().abs().max().item()
    return 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 2.0 ** -133


def _k5_bound(pack, cfg, B, pos):
    """K5's least time for one token: the packed stream, the K/V rows at
    positions <= pos, the new column and x in and out, over the memory
    rate; or its operations over the bf16 peak, whichever is larger."""
    NL = pack[2].shape[0]
    H, U = cfg.num_heads, cfg.units
    KV = getattr(cfg, "num_kv_heads", None) or H
    D = U // H
    nbytes = sum(t.numel() * t.element_size() for t in pack) + \
        2 * NL * B * KV * (pos + 1) * D * 2 + 2 * B * U * 2
    nops = 2 * B * pack[0].numel() + 4 * NL * B * H * D * (pos + 1)
    return bound_ms(nbytes, nops)


def check_k5(models):
    """K5 against ``decode_step_plain`` at the four shapes, native and
    int8, with its time, bound, plain time and the unfused step's."""
    import torch
    from mxnet_tpu_torch.models.decoding import _DecodeEngine, _fused_pack
    from mxnet_tpu_torch.ops.decode_fused import (decode_step,
                                                  decode_step_plain)

    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = []
    for name, key, B, T, pos in (("gpt2_small", "gpt2", 4, 768, 700),
                                 ("llama7b_2l", "llama", 1, 64, 40),
                                 ("llama7b_gqa8_2l", "gqa", 2, 64, 40),
                                 ("gpt2_small_pos0", "gpt2", 4, 768, 0)):
        model = models[key]
        cfg = model._cfg
        for weights in ("native", "int8"):
            eng = _DecodeEngine(model, 0.0, 0, weights, fused=True)
            pack = _fused_pack(model, weights == "int8")
            NL, KV, D = eng.NL, eng.KV, eng.D
            act, eps = eng.act_t, eng.norm_eps[0]
            tok = torch.randint(0, cfg.vocab_size, (B,), generator=gen,
                                device="cuda")
            posv = torch.full((B,), pos, dtype=torch.int64, device="cuda")
            x = eng.embed(tok, posv).contiguous()
            kh, vh = ((torch.randn((NL, B, KV, T, D), generator=gen,
                                   device="cuda") * 0.5).bfloat16()
                      for _ in range(2))
            kk, vk = kh.clone(), vh.clone()
            got = decode_step(pos, x, pack, kk, vk, cfg, act, eps)[0]
            ref, kr, vr = decode_step_plain(pos, x, pack, kh.clone(),
                                            vh.clone(), cfg, act, eps)
            torch.cuda.synchronize()
            errs = {}
            for what, a, b in (("x", got, ref),
                               ("k", kk[:, :, :, pos], kr[:, :, :, pos]),
                               ("v", vk[:, :, :, pos], vr[:, :, :, pos])):
                err = (a.float() - b.float()).abs().max().item()
                steps = err / _bf16_step(b)
                if not torch.isfinite(a.float()).all() or steps > K5_STEPS:
                    fail(f"K5 {name} {weights} {what}: max_abs_err {err} "
                         f"= {steps} bf16 steps > {K5_STEPS}")
                errs[what] = (err, steps)
            rest = torch.ones(T, dtype=torch.bool, device="cuda")
            rest[pos] = False
            if not (torch.equal(kk[:, :, :, rest], kh[:, :, :, rest]) and
                    torch.equal(vk[:, :, :, rest], vh[:, :, :, rest])):
                fail(f"K5 {name} {weights}: cache entries other than "
                     f"position {pos} changed")
            ms = cuda_ms(lambda i: decode_step(pos, x, pack, kk, vk, cfg,
                                               act, eps), 20)
            plain = cuda_ms(lambda i: decode_step_plain(
                pos, x, pack, kr, vr, cfg, act, eps), 3, warm=2)
            fused_step = cuda_ms(lambda i: eng.fused_step(tok, pos, kk, vk),
                                 20)
            ueng = _DecodeEngine(model, 0.0, 0, weights)
            kp, vp = (torch.zeros((NL, B + 1, KV, T, D), device="cuda",
                                  dtype=torch.bfloat16) for _ in range(2))
            pt = torch.arange(B, device="cuda")[:, None]
            unfused = cuda_ms(lambda i: ueng.paged_step(tok, posv, kp, vp,
                                                        pt, T), 5)
            bms, by = _k5_bound(pack, cfg, B, pos)
            row = dict(shape=name, weights=weights, layers=NL, B=B, T=T,
                       pos=pos, KV=KV, grid=decode_step.grid,
                       max_abs_err=max(e for e, _ in errs.values()),
                       bf16_steps={w: st for w, (_, st) in errs.items()},
                       ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                       fused_step_ms=fused_step, unfused_step_ms=unfused)
            rows.append(row)
            print(f"K5 {name} {weights} NL={NL} B={B} T={T} pos={pos} "
                  f"KV={KV} grid={decode_step.grid}: max_abs_err " +
                  " ".join(f"{w}={e:.3e} ({st:.2f} steps)"
                           for w, (e, st) in errs.items()) +
                  f" (tol {K5_STEPS} bf16 steps); kernel_ms={ms:.5f} "
                  f"bound_ms={bms:.5f} ({by}) plain_ms={plain:.5f} "
                  f"fused_step_ms={fused_step:.5f} unfused_step_ms="
                  f"{unfused:.5f}", flush=True)
            del ueng, kp, vp
    return rows


# --------------------------------------------------------------------------- #
# phases 11-12: kv_generate(fused="on"), GPT-2 small and Llama-7B
# --------------------------------------------------------------------------- #

def teacher_forced(model, prompts, stream, weights):
    """Share of the fused stream's new tokens that the unfused step
    predicts when fed the stream's own earlier tokens (greedy): the
    prefill's argmax against the first new token, then one unfused step
    per position.  A single flip does not cascade here, as it does in a
    whole-stream comparison."""
    import torch
    from mxnet_tpu_torch.models.decoding import _DecodeEngine

    eng = _DecodeEngine(model, 0.0, 0, weights)
    B, P = prompts.shape
    total = stream.shape[1]
    s = torch.as_tensor(stream, device="cuda").long()
    logits, knew, vnew = eng.prefill(s[:, :P])
    shape = (eng.NL, B + 1, eng.KV, total, eng.D)
    kp, vp = (torch.zeros(shape, dtype=eng.cdtype, device="cuda")
              for _ in range(2))
    kp[:, :B, :, :P] = knew
    vp[:, :B, :, :P] = vnew
    pt = torch.arange(B, device="cuda")[:, None]
    preds = [logits.argmax(-1)]
    for t in range(P, total - 1):
        posv = torch.full((B,), t, dtype=torch.int64, device="cuda")
        preds.append(eng.paged_step(s[:, t], posv, kp, vp, pt,
                                    total).argmax(-1))
    return (torch.stack(preds, 1) == s[:, P:]).float().mean().item()


def _reset_counts():
    from mxnet_tpu_torch.ops.attention import flash_fwd
    from mxnet_tpu_torch.ops.decode_fused import decode_step
    from mxnet_tpu_torch.ops.q8_matvec import q8_matvec

    for fn in (decode_step, flash_fwd, q8_matvec):
        fn.launches = 0


def _counts():
    from mxnet_tpu_torch.ops.attention import flash_fwd
    from mxnet_tpu_torch.ops.decode_fused import decode_step
    from mxnet_tpu_torch.ops.q8_matvec import q8_matvec

    return {"decode_fused": decode_step.launches,
            "flash_fwd": flash_fwd.launches,
            "q8_matvec": q8_matvec.launches}


def fused_run(what, model, prompts, new, weights, prefill, expect):
    """One counted ``kv_generate(fused="on")`` run (counts set to 0 just
    before, read just after) and the same request with ``fused="off"``;
    checks the launch counts, the tokens and the teacher-forced
    agreement.  ``expect``: the required launches by kernel name."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.models import kv_generate

    B, P = prompts.shape
    kw = dict(temperature=0.0, weights=weights, prefill=prefill)
    # warm-up: pack, cuBLAS and allocator set-up stay off the clock
    kv_generate(model, prompts[:, :8], 2, fused="on", **kw)
    kv_generate(model, prompts[:, :8], 2, fused="off", **kw)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    out = kv_generate(model, prompts, new, fused="on", **kw)
    torch.cuda.synchronize()
    t_fused = time.perf_counter() - t0
    launches = _counts()
    t0 = time.perf_counter()
    ref = kv_generate(model, prompts, new, fused="off", **kw)
    torch.cuda.synchronize()
    t_unfused = time.perf_counter() - t0
    for k, n in expect.items():
        if launches[k] != n:
            fail(f"{what}: {k} launched {launches[k]} times, expected {n}")
    vocab = model._cfg.vocab_size
    if out.shape != (B, P + new) or not ((0 <= out) & (out < vocab)).all():
        fail(f"{what}: output {out.shape} or tokens outside the vocab")
    if not np.array_equal(out[:, :P], prompts):
        fail(f"{what}: the prompt was not kept")
    tf = teacher_forced(model, prompts, out, weights)
    whole = float((out[:, P:] == ref[:, P:]).mean())
    row = dict(weights=weights, prefill=prefill, B=B, P=P, new=new,
               launches=launches, tokens_per_s=B * new / t_fused,
               unfused_tokens_per_s=B * new / t_unfused,
               ms_per_token=t_fused / (new - 1) * 1e3,
               unfused_ms_per_token=t_unfused / (new - 1) * 1e3,
               teacher_forced=tf, whole_stream_agreement=whole)
    print(f"{what}: {weights} prefill={prefill} B={B} P={P} new={new} "
          f"launches {launches}; tokens/s fused={row['tokens_per_s']:.2f} "
          f"unfused={row['unfused_tokens_per_s']:.2f}; ms/token fused="
          f"{row['ms_per_token']:.4f} unfused="
          f"{row['unfused_ms_per_token']:.4f}; teacher-forced agreement="
          f"{tf:.4f} (bar 0.9); whole-stream agreement={whole:.4f}",
          flush=True)
    if tf < 0.9:
        fail(f"{what}: teacher-forced agreement {tf:.4f} < 0.9")
    return row


def check_fused_gpt2(model, cfg):
    import numpy as np

    rs = np.random.RandomState(12)
    prompts = rs.randint(0, cfg.vocab_size, (4, 640))
    L = cfg.num_layers
    runs = {}
    for weights in ("native", "int8"):
        runs[weights] = fused_run(
            "fused gpt2_small", model, prompts, 128, weights, "batched",
            {"decode_fused": 127, "flash_fwd": L,
             "q8_matvec": 127 if weights == "int8" else 0})
    runs["scan"] = fused_run(
        "fused gpt2_small", model, rs.randint(0, cfg.vocab_size, (1, 64)),
        64, "native", "scan", {"decode_fused": 127, "flash_fwd": 0})
    return runs


def profile_fused(model):
    """One fused GPT-2-small step from the embedding to ``ln_f`` under
    ``torch.profiler``: K5 must be there, and no GEMM or attention
    kernel."""
    import torch
    from mxnet_tpu_torch.models.decoding import _DecodeEngine
    from mxnet_tpu_torch.ops.decode_fused import decode_step

    eng = _DecodeEngine(model, 0.0, 0, "native", fused=True)
    B, T, pos = 4, 768, 700
    kc, vc = (torch.zeros((eng.NL, B, eng.KV, T, eng.D), device="cuda",
                          dtype=torch.bfloat16) for _ in range(2))
    tok = torch.zeros((B,), dtype=torch.int64, device="cuda")
    posv = torch.full((B,), pos, dtype=torch.int64, device="cuda")

    def layers():
        x = eng.embed(tok, posv).contiguous()
        x = decode_step(pos, x, eng.packed, kc, vc, model._cfg, eng.act_t,
                        eng.norm_eps[0])[0]
        return model.ln_f(x)

    layers()
    torch.cuda.synchronize()
    by_name, busy, wall_us = _profiled(layers)
    prof = report_profile("fused profile", by_name, busy, wall_us)
    if busy <= 0:
        fail("fused profile: the profiler recorded no device time")
    if not any("decode_fused_kernel" in n for n in by_name):
        fail(f"fused profile: no K5 kernel among {sorted(by_name)}")
    bad = [n for n in by_name if any(
        k in n.lower() for k in ("gemm", "gemv", "xmma", "cutlass", "nvjet",
                                 "flash", "fmha", "attention"))]
    if bad:
        fail(f"fused profile: library GEMM/attention kernels inside the "
             f"layer stack: {bad}")
    prof["kernels"] = sorted(by_name)
    return prof


def check_llama7b():
    import numpy as np
    import torch
    from mxnet_tpu_torch.models import llama_7b

    t0 = time.perf_counter()
    model, cfg = llama_7b(dtype=torch.bfloat16)
    model.initialize(0.02, seed=0)
    torch.cuda.synchronize()
    print(f"llama_7b: {sum(p.numel() for p in model.parameters())} "
          f"parameters, bf16, seeded Normal(0.02), built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    prompts = np.random.RandomState(13).randint(0, cfg.vocab_size, (1, 32))
    runs = {}
    for weights in ("native", "int8"):
        runs[weights] = fused_run(
            "fused llama_7b", model, prompts, 32, weights, "batched",
            {"decode_fused": 31, "flash_fwd": 0,
             "q8_matvec": 31 if weights == "int8" else 0})
    # K5 alone at full depth (32 layers, B=1, position 40), int8 first:
    # the model's pack cache holds the stream the last run built
    from mxnet_tpu_torch.models.decoding import _DecodeEngine
    from mxnet_tpu_torch.ops.decode_fused import decode_step

    for weights in ("int8", "native"):
        eng = _DecodeEngine(model, 0.0, 0, weights, fused=True)
        kc, vc = (torch.zeros((eng.NL, 1, eng.KV, 64, eng.D), device="cuda",
                              dtype=torch.bfloat16) for _ in range(2))
        posv = torch.full((1,), 40, dtype=torch.int64, device="cuda")
        x = eng.embed(torch.zeros((1,), dtype=torch.int64, device="cuda"),
                      posv).contiguous()
        ms = cuda_ms(lambda i: decode_step(40, x, eng.packed, kc, vc, cfg,
                                           None, eng.norm_eps[0]), 10)
        bms, by = _k5_bound(eng.packed, cfg, 1, 40)
        runs[weights]["k5_full_depth"] = dict(ms=ms, bound_ms=bms,
                                              bound_by=by)
        print(f"K5 llama_7b {weights} NL=32 B=1 pos=40: kernel_ms={ms:.5f} "
              f"bound_ms={bms:.5f} ({by})", flush=True)
        del eng, kc, vc
    runs["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    print(f"llama_7b: max_memory_allocated="
          f"{runs['max_memory_allocated']}", flush=True)
    del model
    torch.cuda.empty_cache()
    return runs


# --------------------------------------------------------------------------- #
# phase 13: K6, the fused 1x1-convolution backward, against its plain version
# --------------------------------------------------------------------------- #

RESNET_B = 128
# ResNet-50 v1's stride-1 1x1 convolutions at batch 128: (spatial, Ci, Co,
# launches a step).  Stage 1: the first block's conv1 (64 -> 64), the
# other conv1s (256 -> 64), every conv3 and the downsample (64 -> 256);
# stages 2-4: the conv3s and the conv1s of the blocks after the first
# (those carry v1's stride 2).
K6_SHAPES = [(56, 64, 64, 1), (56, 64, 256, 4), (56, 256, 64, 2),
             (28, 128, 512, 4), (28, 512, 128, 3), (14, 256, 1024, 6),
             (14, 1024, 256, 5), (7, 512, 2048, 3), (7, 2048, 512, 2)]
K6_PER_STEP = sum(n for *_, n in K6_SHAPES)
K6_DX_STEPS = 2                 # dx tolerance in bf16 steps (f32: 1e-5)
K6_DW_REL = {"bfloat16": 1e-3, "float32": 1e-5}


def _k6_case(s, ci, co, dtype, gen):
    """One shape: errors, determinism, kernel / plain / library times and
    the bound."""
    import torch
    from mxnet_tpu_torch.ops import conv_fused as cf

    dt = getattr(torch, dtype)
    p = RESNET_B * s * s
    x = torch.randn((p, ci), generator=gen, device="cuda").to(dt)
    w = (torch.randn((co, ci), generator=gen, device="cuda") *
         ci ** -0.5).to(dt)
    dy = torch.randn((p, co), generator=gen, device="cuda").to(dt)
    dx, dw = cf.conv1x1_bwd_pair(dy, x, w)
    dx2, dw2 = cf.conv1x1_bwd_pair(dy, x, w)
    rdx, rdw = cf.conv1x1_bwd_pair_plain(dy, x, w)
    torch.cuda.synchronize()
    dx_err = (dx.float() - rdx.float()).abs().max().item()
    dw_err = (dw - rdw).abs().max().item()
    dw_rel = dw_err / max(rdw.abs().max().item(), 1e-30)
    if dtype == "bfloat16":
        dx_steps = dx_err / _bf16_step(rdx)
        dx_ok = dx_steps <= K6_DX_STEPS
    else:
        dx_steps = None
        dx_ok = dx_err <= 1e-5 * rdx.abs().max().item()
    what = f"K6 {s}x{s} {ci}->{co} {dtype}"
    if not (torch.isfinite(dx.float()).all() and torch.isfinite(dw).all()):
        fail(f"{what}: non-finite output")
    if not dx_ok or dw_rel > K6_DW_REL[dtype]:
        fail(f"{what}: dx max_abs_err {dx_err} ({dx_steps} bf16 steps), dW "
             f"relative error {dw_rel} > {K6_DW_REL[dtype]}")
    if not (torch.equal(dw, dw2) and torch.equal(dx, dx2)):
        fail(f"{what}: two launches differ")
    ms = cuda_ms(lambda i: cf.conv1x1_bwd_pair(dy, x, w), 10)
    plain = cuda_ms(lambda i: cf.conv1x1_bwd_pair_plain(dy, x, w), 3)
    n = RESNET_B
    # cuDNN on the same tensors, as NCHW views of channels-last memory
    dy4 = dy.view(n, s, s, co).permute(0, 3, 1, 2)
    x4 = x.view(n, s, s, ci).permute(0, 3, 1, 2)
    w4 = w.view(co, ci, 1, 1).contiguous(memory_format=torch.channels_last)
    lib = cuda_ms(lambda i: torch.ops.aten.convolution_backward(
        dy4, x4, w4, None, [1, 1], [0, 0], [1, 1], False, [0, 0], 1,
        [True, True, False]), 10)
    cublas = cuda_ms(lambda i: (dy @ w, dy.t() @ x), 10)
    el = dy.element_size()
    nbytes = el * (p * co + 2 * p * ci) + co * ci * (el + 4)
    nops = 4 * p * ci * co
    rate = BF16_OPS_PER_S if dtype == "bfloat16" else F32_OPS_PER_S
    bms, by = bound_ms(nbytes, nops, rate)
    print(f"{what} P={p}: dx max_abs_err={dx_err:.3e}"
          + (f" ({dx_steps:.2f} bf16 steps)" if dx_steps is not None else "")
          + f" dW rel_err={dw_rel:.3e} plan={cf.plan(p, ci, co)} "
          f"kernel_ms={ms:.5f} bound_ms={bms:.5f} ({by}) plain_ms="
          f"{plain:.5f} cudnn_ms={lib:.5f} cublas_pair_ms={cublas:.5f}",
          flush=True)
    return dict(s=s, ci=ci, co=co, P=p, dtype=dtype, dx_max_abs_err=dx_err,
                dx_bf16_steps=dx_steps, dw_rel_err=dw_rel,
                max_abs_err=max(dx_err, dw_err), ms=ms, plain_ms=plain,
                library_ms=lib, cublas_ms=cublas, bound_ms=bms, bound_by=by,
                bytes=nbytes, ops=nops, plan=cf.plan(p, ci, co))


def check_k6():
    """K6 at every stride-1 1x1 shape of ResNet-50's step (bf16) and at
    stage 4's expand shape in f32; the per-step totals weight each shape
    by its launches a step."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(14)
    rows = []
    step = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, cublas_ms=0.0,
                bytes=0, ops=0)
    for s, ci, co, n in K6_SHAPES:
        row = _k6_case(s, ci, co, "bfloat16", gen)
        row["launches_per_step"] = n
        rows.append(row)
        for k in step:
            step[k] += n * row[k]
        torch.cuda.empty_cache()
    step["bound_ms"], step["bound_by"] = bound_ms(step["bytes"],
                                                  step["ops"])
    step["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    f32 = _k6_case(7, 512, 2048, "float32", gen)
    print(f"K6 per ResNet-50 step ({K6_PER_STEP} launches, bf16): "
          f"kernel_ms={step['ms']:.5f} bound_ms={step['bound_ms']:.5f} "
          f"({step['bound_by']}) plain_ms={step['plain_ms']:.5f} cudnn_ms="
          f"{step['library_ms']:.5f} cublas_pair_ms={step['cublas_ms']:.5f}",
          flush=True)
    torch.cuda.empty_cache()
    return dict(shapes=rows, f32=f32, **step)


# --------------------------------------------------------------------------- #
# phase 14: ResNet-50 v1 training, the fourth slice's path
# --------------------------------------------------------------------------- #

RESNET_STEPS = 20
RESNET_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}


def _resnet50():
    import torch
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_resnet

    net = get_resnet(1, 50, classes=1000, layout="NHWC")
    net.initialize(initializer.Xavier(rnd_type="uniform", factor_type="avg",
                                      magnitude=3), seed=0)
    net.cast("bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(15)
    data = torch.rand((RESNET_B, 3, 224, 224), generator=gen,
                      device="cuda").bfloat16()
    label = torch.randint(0, 1000, (RESNET_B,), generator=gen,
                          device="cuda")
    return net, data, label


def _resnet_profile(trainer, net, data, label):
    """One profiled step: device time of K6, cuDNN's convolutions, the
    GEMMs (the fused route's 1x1 forward and the classifier), BatchNorm
    (its forward, ranged by hooks here, and its backward node), the
    optimizer's updates (ranged around ``Optimizer.apply``) and the
    rest."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from mxnet_tpu_torch.gluon.nn import BatchNorm

    hooks = []
    for m in net.modules():
        if isinstance(m, BatchNorm):
            def pre(mod, args):
                mod._range = record_function("batch_norm")
                mod._range.__enter__()

            def post(mod, args, out):
                mod._range.__exit__(None, None, None)

            hooks += [m.register_forward_pre_hook(pre),
                      m.register_forward_hook(post)]
    opt = trainer.optimizer
    plain_apply = opt.apply

    def apply(*a, **k):
        with record_function("optimizer"):
            return plain_apply(*a, **k)

    opt.apply = apply
    try:
        trainer.step(data, label)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.step(data, label)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        del opt.apply
        for h in hooks:
            h.remove()
    # kernel time by name; then each kernel's time charged to the range
    # (BatchNorm, optimizer) its launching op sits in, if any.  A range's
    # own device-side row (its span, idle gaps included) is skipped.
    ranges = {"batch_norm": 0.0, "optimizer": 0.0}
    kernels = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.key not in ranges:
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = ev.self_cuda_time_total
            kernels[ev.key] = kernels.get(ev.key, 0.0) + us

    def range_of(ev):
        while ev is not None:
            if ev.name in ranges:
                return ev.name
            if "_BatchNormStatsBackward" in ev.name:
                return "batch_norm"
            ev = ev.cpu_parent
        return None

    for ev in prof.events():
        if ev.device_type != DeviceType.CPU or not ev.kernels:
            continue
        name = range_of(ev)
        if name is not None:
            ranges[name] += sum(k.duration for k in ev.kernels
                                if k.name not in ranges)
    busy = sum(kernels.values())
    prof_row = report_profile("resnet profile", kernels, busy, wall_us,
                              top=25)
    conv_keys = ("cudnn", "conv", "fprop", "dgrad", "wgrad", "implicit",
                 "nchwtonhwc", "nhwctonchw")
    gemm_keys = ("gemm", "gemv", "nvjet", "cutlass", "xmma")
    groups = {"K6": 0.0, "cuDNN convolutions": 0.0, "GEMMs": 0.0}
    for name, us in kernels.items():
        low = name.lower()
        if "conv1x1_bwd" in low or "sum_partials" in low:
            groups["K6"] += us
        elif any(k in low for k in conv_keys):
            groups["cuDNN convolutions"] += us
        elif any(k in low for k in gemm_keys):
            groups["GEMMs"] += us
    groups["BatchNorm"] = ranges["batch_norm"]
    groups["optimizer"] = ranges["optimizer"]
    groups["other"] = busy - sum(groups.values())
    if busy > 0:
        print("resnet profile: by group " + ", ".join(
            f"{g} {us / busy:.4f} ({us / 1e3:.3f} ms)"
            for g, us in groups.items())
            + (" (BatchNorm and optimizer ranges recorded no device time: "
               "not measured)" if not (ranges["batch_norm"] and
                                       ranges["optimizer"]) else ""),
            flush=True)
    prof_row["groups_us"] = groups
    return prof_row


def train_resnet(fused):
    """ResNet-50 v1 bf16 NHWC, 20 SGD steps on one repeated batch through
    ``SPMDTrainer`` with ``MXNET_FUSED_CONV_BWD`` on or off.  The launch
    counts are set to 0 just before the steps and read just after.
    Returns the numbers and the trainer, net and batch."""
    import torch
    from mxnet_tpu_torch import gluon, parallel
    from mxnet_tpu_torch.ops import conv_fused as cf

    os.environ["MXNET_FUSED_CONV_BWD"] = "1" if fused else "0"
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()   # what earlier phases still hold
    net, data, label = _resnet50()
    trainer = parallel.SPMDTrainer(
        net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd", dict(RESNET_OPT))
    rest = RESNET_STEPS - 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    cf.conv1x1_bwd_pair.launches = 0
    t0 = time.perf_counter()
    first = trainer.step(data, label)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    more = trainer.run_steps(data[None].expand(rest, -1, -1, -1, -1),
                             label[None].expand(rest, -1))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(_counts(), conv1x1_bwd=cf.conv1x1_bwd_pair.launches)
    row = dict(losses=[float(first)] + [float(v) for v in
                                        more.float().cpu()],
               ms_per_step=(t2 - t1) / rest * 1e3,
               images_per_s=rest * RESNET_B / (t2 - t1),
               first_step_ms=(t1 - t0) * 1e3,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               allocated_at_start=start, launches=launches)
    arm = "fused" if fused else "unfused"
    print(f"resnet {arm}: resnet50_v1 NHWC bf16, B={RESNET_B} 224x224, "
          f"{RESNET_STEPS} SGD steps; losses "
          f"{[round(v, 4) for v in row['losses']]}", flush=True)
    print(f"resnet {arm}: images/s={row['images_per_s']:.2f} ms/step="
          f"{row['ms_per_step']:.3f} (steps 2-{RESNET_STEPS}; first step "
          f"{row['first_step_ms']:.3f} ms) max_memory_allocated="
          f"{row['max_memory_allocated']} ({row['max_memory_allocated'] - start}"
          f" above the phase's start) launches {launches}", flush=True)
    return row, (trainer, net, data, label)


def check_resnet(fused):
    """``train_resnet`` and its checks: with ``fused`` K6 ran exactly 30
    times a step, without it never, and no other kernel ran; the losses
    are finite, the first within 1.0 of ln(1000), and they fall."""
    import math

    import torch

    row, held = train_resnet(fused)
    arm = "fused" if fused else "unfused"
    launches, losses = row["launches"], row["losses"]
    expect = K6_PER_STEP * RESNET_STEPS if fused else 0
    if launches["conv1x1_bwd"] != expect:
        fail(f"resnet {arm}: K6 launched {launches['conv1x1_bwd']} times, "
             f"expected {expect}")
    if any(n for k, n in launches.items() if k != "conv1x1_bwd"):
        fail(f"resnet {arm}: other kernels launched: {launches}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"resnet {arm}: losses not finite: {losses}")
    if abs(losses[0] - math.log(1000)) > 1.0:
        fail(f"resnet {arm}: first loss {losses[0]} is not within 1.0 of "
             f"ln(1000)")
    if not losses[-1] < losses[0]:
        fail(f"resnet {arm}: loss did not fall: {losses}")
    if fused:
        row["profile"] = _resnet_profile(*held)
    del held
    torch.cuda.empty_cache()
    return row


# --------------------------------------------------------------------------- #
# phase 15: a small ResNet's f32 step on the card against the CPU
# --------------------------------------------------------------------------- #

def check_resnet_vs_cpu():
    """``ResNetV1(BottleneckV1, [1, 1, 1, 1], [16, 32, 64, 128, 256],
    classes=10, thumbnail=True, layout="NHWC")``, f32, TF32 off for cuDNN
    and cuBLAS, batch 8 at 32x32, one SGD step with K6 on the card (6
    launches) and its plain version on the CPU, from the same weights.
    Tolerance 1e-4 (loss relative; weights and running statistics
    absolute): both sides sum in f32 in other orders, and one step moves
    a weight by lr (0.1) times its gradient."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import gluon, initializer, parallel
    from mxnet_tpu_torch.gluon.model_zoo.vision import (BottleneckV1,
                                                        ResNetV1)
    from mxnet_tpu_torch.ops import conv_fused as cf

    os.environ["MXNET_FUSED_CONV_BWD"] = "1"
    kw = dict(classes=10, thumbnail=True, layout="NHWC")
    spec = ([1, 1, 1, 1], [16, 32, 64, 128, 256])
    cpu = ResNetV1(BottleneckV1, *spec, device="cpu", **kw)
    cpu.initialize(initializer.Xavier(magnitude=3), seed=3)
    card = ResNetV1(BottleneckV1, *spec, **kw)
    card.load_state_dict(cpu.state_dict())
    rs = np.random.RandomState(16)
    data = rs.rand(8, 3, 32, 32).astype(np.float32)
    label = rs.randint(0, 10, (8,))
    losses = []
    cf.conv1x1_bwd_pair.launches = 0
    for model in (card, cpu):
        trainer = parallel.SPMDTrainer(
            model, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
            dict(RESNET_OPT))
        losses.append(float(trainer.step(data, label)))
    launches = cf.conv1x1_bwd_pair.launches
    rel = abs(losses[0] - losses[1]) / abs(losses[1])
    worst = max((a.detach().cpu() - b.detach()).abs().max().item()
                for a, b in zip(card.parameters(), cpu.parameters()))
    print(f"resnet vs cpu: small bottleneck v1 f32 step, loss card "
          f"{losses[0]:.6f} cpu {losses[1]:.6f} (rel {rel:.3e}, tol 1e-4); "
          f"weights and running statistics max_abs_diff {worst:.3e} (tol "
          f"1e-4); K6 launches {launches} (expected 6)", flush=True)
    if launches != 6:
        fail(f"resnet vs cpu: K6 launched {launches} times, expected 6")
    if rel > 1e-4 or worst > 1e-4:
        fail("the card's ResNet step disagrees with the CPU's")
    del card
    torch.cuda.empty_cache()
    return dict(loss_card=losses[0], loss_cpu=losses[1], loss_rel=rel,
                max_abs_diff=worst, launches=launches)


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available: this smoke test runs only on the card")
    if not os.path.isdir(os.path.join(HERE, "mxnet_tpu_torch")):
        fail("mxnet_tpu_torch/ is not beside chip_smoke.py")
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 GEMMs sum in f32 and round once, as XLA's do in the reference
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    from mxnet_tpu_torch import _build
    from mxnet_tpu_torch.models import gpt2_small

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    secs = _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s ({secs})", flush=True)
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    model, cfg = gpt2_small(dtype=torch.bfloat16)
    model.initialize(0.02, seed=0)
    print(f"model: gpt2_small bf16, {sum(p.numel() for p in model.parameters())}"
          " parameters, seeded Normal(0.02)", flush=True)

    k4 = check_k4(cfg)
    k1 = check_k1(cfg, B=8)
    k23 = check_k23(cfg, B=8)
    srv = check_serving(model, cfg)
    srv["profile"] = profile_serving(model, cfg)
    del model
    torch.cuda.empty_cache()
    srv["agreement_f32"] = check_serving_f32(cfg)
    torch.cuda.empty_cache()
    train = check_training(cfg)
    train["vs_cpu"] = check_training_vs_cpu()
    bert = check_bert()

    from mxnet_tpu_torch.models import llama_7b

    gpt2, _ = gpt2_small(dtype=torch.bfloat16)
    gpt2.initialize(0.02, seed=0)
    llama2 = llama_7b(dtype=torch.bfloat16, num_layers=2)[0]
    gqa2 = llama_7b(dtype=torch.bfloat16, num_layers=2, num_kv_heads=8)[0]
    for m in (llama2, gqa2):
        m.initialize(0.02, seed=1)
    k5 = check_k5({"gpt2": gpt2, "llama": llama2, "gqa": gqa2})
    del llama2, gqa2
    torch.cuda.empty_cache()
    fused = check_fused_gpt2(gpt2, cfg)
    fused["profile"] = profile_fused(gpt2)
    del gpt2
    torch.cuda.empty_cache()
    fused["llama_7b"] = check_llama7b()

    k6 = check_k6()
    vision = dict(fused=check_resnet(True), unfused=check_resnet(False),
                  vs_cpu=check_resnet_vs_cpu())

    def backward_row(name, key, outputs, replaces):
        main = k23[0][key]
        return dict(name=name, route="cuda",
                    source="mxnet_tpu_torch/csrc/flash_bwd.cu",
                    replaces=replaces, launches=train["launches"][name],
                    max_abs_err=max(e for r in k23
                                    for w, e in r["max_abs_err"].items()
                                    if w in outputs),
                    ms=main["ms"], plain_ms=main["plain_ms"],
                    bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                    library_ms=main["library_ms"])

    kernels = [
        dict(name="q8_matvec", route="cuda",
             source="mxnet_tpu_torch/csrc/q8_matvec.cu",
             replaces="mxnet_tpu/ops/q8_matvec.py:74",
             launches=srv["launches"]["q8_matvec"],
             max_abs_err=k4["max_abs_err"], ms=k4["ms"],
             plain_ms=k4["plain_ms"], bound_ms=k4["bound_ms"],
             bound_by=k4["bound_by"], library_ms=k4["library_ms"]),
        dict(name="flash_fwd", route="cuda",
             source="mxnet_tpu_torch/csrc/flash_fwd.cu",
             replaces="mxnet_tpu/ops/attention.py:226",
             launches=train["launches"]["flash_fwd"],
             max_abs_err=max(r["max_abs_err"] for r in k1), ms=k1[0]["ms"],
             plain_ms=k1[0]["plain_ms"], bound_ms=k1[0]["bound_ms"],
             bound_by=k1[0]["bound_by"], library_ms=k1[0]["library_ms"]),
        backward_row("flash_bwd_dq", "k2", ("dq",),
                     "mxnet_tpu/ops/attention.py:369"),
        backward_row("flash_bwd_dkv", "k3", ("dk", "dv", "dbias"),
                     "mxnet_tpu/ops/attention.py:479"),
        # K5: times at the GPT-2-small main-path shape (B=4, pos 700),
        # native stream; no single PyTorch call computes its function, so
        # library_ms is null and the unfused step stands beside it
        dict(name="decode_fused", route="cuda",
             source="mxnet_tpu_torch/csrc/decode_fused.cu",
             replaces="mxnet_tpu/ops/decode_fused.py:605",
             launches=fused["native"]["launches"]["decode_fused"],
             max_abs_err=max(r["max_abs_err"] for r in k5), ms=k5[0]["ms"],
             plain_ms=k5[0]["plain_ms"], bound_ms=k5[0]["bound_ms"],
             bound_by=k5[0]["bound_by"], library_ms=None,
             unfused_step_ms=k5[0]["unfused_step_ms"]),
        # K6: per ResNet-50 step (30 launches at nine shapes, bf16); the
        # library call is cuDNN's backward (dx and dW in one call)
        dict(name="conv1x1_bwd", route="cuda",
             source="mxnet_tpu_torch/csrc/conv1x1_bwd.cu",
             replaces="mxnet_tpu/ops/conv_fused.py:134",
             launches=vision["fused"]["launches"]["conv1x1_bwd"],
             max_abs_err=k6["max_abs_err"], ms=k6["ms"],
             plain_ms=k6["plain_ms"], bound_ms=k6["bound_ms"],
             bound_by=k6["bound_by"], library_ms=k6["library_ms"],
             cublas_ms=k6["cublas_ms"]),
    ]
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"),
              "w") as fh:
        json.dump(dict(card=card, build_s=secs, k4=k4, k1=k1, k23=k23,
                       serve=srv, train=train, bert=bert, k5=k5,
                       fused=fused, k6=k6, vision=vision, kernels=kernels),
                  fh, indent=1, default=str)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
