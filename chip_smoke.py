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
4. K1 (flash forward) against its plain version in bf16 at the prefill
   shape the serving run gives it (8 rows, 12 heads, 1024 tokens, head
   dim 64, causal), and once more with a key mask and dropout, with
   kernel, plain, library (``scaled_dot_product_attention``) and bound
   times;
5. serving: GPT-2 small at full width in bf16 (seeded random weights)
   through ``DecodeServer(weights="int8", pool_sizes=(4, 8))`` — six
   ragged greedy requests, the 700-token one arriving after the others
   were admitted, so its wave runs K1 (a 1024 bucket); every decode
   step runs K4 49 times — held against the port's own batch-1
   ``kv_generate`` (first tokens equal, whole-stream agreement >= 0.9),
   then once more under ``torch.profiler`` for the device time by
   kernel, then the same weights in float32 in one wave, held the same
   way;
6. one ``{"kernels": [...]}`` line, the card line, and as the last line
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
# phase 5: serving
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


def profile_serving(model, cfg):
    """Where the serving run's device time goes: the same six requests
    once more (one wave) under ``torch.profiler``, kernel time summed by
    name.  The profiler's host overhead makes this run slower than the
    timed one, so only its shares are read, never its rate."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve(model, cfg, counted=False)
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
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    if busy <= 0:
        print("profile: the profiler recorded no device time (not measured)",
              flush=True)
        return dict(device_us=None)
    print(f"profile: device busy {busy / wall_us:.4f} of the profiled "
          f"window ({busy:.0f} of {wall_us:.0f} us)", flush=True)
    for name, us in top:
        print(f"profile: {us / busy:.4f} {us:.0f} us {name[:90]}",
              flush=True)
    return dict(device_us=busy, window_us=wall_us,
                top=[dict(name=n, us=u) for n, u in top])


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
    srv = check_serving(model, cfg)
    srv["profile"] = profile_serving(model, cfg)
    del model
    torch.cuda.empty_cache()
    srv["agreement_f32"] = check_serving_f32(cfg)

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
             launches=srv["launches"]["flash_fwd"],
             max_abs_err=max(r["max_abs_err"] for r in k1), ms=k1[0]["ms"],
             plain_ms=k1[0]["plain_ms"], bound_ms=k1[0]["bound_ms"],
             bound_by=k1[0]["bound_by"], library_ms=k1[0]["library_ms"]),
    ]
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"),
              "w") as fh:
        json.dump(dict(card=card, build_s=secs, k4=k4, k1=k1, serve=srv,
                       kernels=kernels), fh, indent=1, default=str)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
