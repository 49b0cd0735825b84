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
10. one ``{"kernels": [...]}`` line, the card line, and as the last line
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


def bound_ms(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / BF16_OPS_PER_S * 1e3
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
    ]
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"),
              "w") as fh:
        json.dump(dict(card=card, build_s=secs, k4=k4, k1=k1, k23=k23,
                       serve=srv, train=train, bert=bert, kernels=kernels),
                  fh, indent=1, default=str)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
