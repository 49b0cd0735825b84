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
3. K4 (``q8_matvec``): first its design tag and ptxas registers and
   spills; then against its plain version in bf16 at the five
   GPT-2-small decode shapes with the server's two pools (8 and 4 rows)
   and at Llama-7B's shapes with 1 row (4096 x 4096, 4096 x 11008,
   11008 x 4096, the 4096 x 32000 head), two launches bit for bit, with
   kernel, plain, library (``x @ wt.to(bf16)``) and bound times; per
   decode step for each pool; kernel and library by two timers,
   ``cuda_ms`` (the calls as the host enqueues them, the figure of every
   phase) and ``cuda_ms_queued`` (behind a spin kernel: the device's
   share of it);
4. K1 (flash forward) against its plain version in bf16 at the shape
   the serving prefill and the training step give it (8 rows, 12 heads,
   1024 tokens, head dim 64, causal), once more with a key mask and
   dropout, and at the training shape with dropout 0.1, the seed a
   device word, with kernel, plain, library
   (``scaled_dot_product_attention``) and bound times; two launches
   must agree bit for bit; first the design tag of the bf16 tensor-core
   kernel and its registers and spills from this run's ptxas report;
5. K2 and K3 (flash backward: dq; dk, dv, dbias) against their plain
   versions in bf16 at the training shape, and at 2 x 12 x 640 with a
   key mask, dbias and dropout 0.1, and at the training shape with
   dropout 0.1, with kernel, plain and bound times, and K1+K2+K3 forward
   and backward beside ``scaled_dot_product_attention`` forward and
   backward (the library's backward alone is K2's and K3's library
   time); two launches must agree bit for bit; first K2's and K3's
   design tags, registers and spills, as for K1; then (5b) the keep
   masks of K1, K2 and K3 at 8 x 12 x 1024 x 64, causal, dropout 0.1,
   read back through one-hot operands, equal to the plain version's
   for the same seed word bit for bit, and the three kernels inside a
   captured program whose traced key gives the seed: a replay with the
   eager call's key repeats it bit for bit, another key drops others;
6. serving: GPT-2 small at full width in bf16 (seeded random weights)
   through ``DecodeServer(weights="int8", pool_sizes=(4, 8))`` — six
   ragged greedy requests, the 700-token one arriving after the others
   were admitted, so its wave runs K1 (a 1024 bucket); every decode
   step runs K4 49 times — held against the port's own batch-1
   ``kv_generate`` (first tokens equal, whole-stream agreement >= 0.9),
   then once more under ``torch.profiler`` for the device time by
   kernel, then the same weights in float32 in one wave, held the same
   way;
7. training, the second slice's path, through the captured step of
   the twelfth slice: GPT-2 small at full width in bf16 with dropout
   0.1, 8 x 1024 tokens, ``parallel.SPMDTrainer`` with AdamW
   (multi-precision), one ``step`` then ``run_steps`` over 19 more of
   the same batch (eager calls, a capture, replays); every layer runs
   K1 forward and K2/K3 backward, so each launches exactly 12 times a
   step (a replay's launches counted by what its capture recorded); the
   losses must be finite, start within 0.5 of ln(vocab) and fall;
   tokens/s, ms per step and peak memory; the captured arm (one write,
   5 bare replays) beside the eager arm (the program's own function, 5
   steps): ms a step, tokens/s, host µs a replay call, capture seconds,
   ``step_hlo_op_count``, peak memory above each arm's start, the busy
   share of one profiled replay; then two more steps under
   ``torch.profiler``, device time by kernel and by group (attention
   kernels, GEMMs, the rest); (7.2) from the same weights and keys,
   three eager steps against three replays, losses and weights bit for
   bit; (7.3) with lr 0, replays on one batch give different losses at
   dropout 0.1 and equal ones at dropout 0 (2-layer, f32);
8. one f32 AdamW step of a 2-layer GPT-2-width model at 1 x 1024 on the
   card (kernels) held against the same step on the CPU (plain
   versions), loss and updated weights;
9. BERT-base as ``bench.py`` trains it (seq 128, batch 64, bf16, AdamW
   1e-4; its attention takes the plain path, no kernel) through the
   captured step: five steps, finite and falling losses, tokens/s, and
   the captured and eager arms as in phase 7;
10. K5 (the fused decode step, ``ops.decode_fused.decode_step``): first
   its design tag and registers; then against its plain version in bf16,
   native and int8 streams, at four shapes: GPT-2 small (12 layers, B=4,
   T=768) at position 700 and at position 0, Llama-7B widths (2 layers,
   B=1, T=64) and its grouped-query variant (8 KV heads, 2 layers, B=2);
   the output and the written K/V column within 6 bf16 steps of their
   magnitude, the rest of the caches bit for bit, a second launch bit
   for bit; K5 ms a token (by both timers) beside its byte bound, the
   plain version's ms
   and the port's unfused step's (no single PyTorch call computes K5's
   function, so the unfused step is its yardstick);
11. the third slice's path: GPT-2 small through ``kv_generate(fused=
   "on")``, 4 x 640-token prompts and 128 new tokens, greedy, native and
   int8: K5 launched 127 times a run, K1 12 times, K4 (the int8 head) 127
   times; tokens/s beside ``fused="off"``; agreement with the unfused
   step teacher-forced (the unfused step fed the fused stream's tokens
   must predict its next token >= 0.9 of the time); one ``prefill=
   "scan"`` run (1 x 64 + 64, K5 launched 127 times); three profiled
   fused steps (K5, and no GEMM or attention kernel between the embedding and
   ``ln_f``);
12. Llama-7B at full depth (32 layers, bf16), 1 x 32 + 32 tokens, native
   and int8: K5 launched 31 times each, tokens/s fused and unfused,
   teacher-forced agreement >= 0.9 (and, beside it, the agreement over
   the positions whose unfused top-2 logit margin is ``TIE_STEPS`` bf16
   steps or more, which rounding order cannot flip); K5 alone at full
   depth; a fused
   token split by CUDA events into the embedding, K5, ln_f + the head
   (K4 with int8) and the argmax, beside the run's ms a token;
13. K6 (the fused 1x1-convolution backward, ``ops.conv_fused.
   conv1x1_bwd_pair``) against its plain version at the nine stride-1 1x1
   shapes of ResNet-50 at batch 128 in bf16 and one in f32: dx within 2
   bf16 steps (f32: 1e-5) of its magnitude, dW within 1e-3 (f32: 1e-5) of
   its magnitude, dx and dW bit for bit across two launches; first the
   bf16 kernel's design tag, registers and spills; K6 ms beside its
   bound, the plain version's ms, cuDNN's backward
   (``aten.convolution_backward``, one call for dx and dW: the library
   time) and cuBLAS's two products;
14. the fourth slice's path: ResNet-50 v1 (``get_resnet(1, 50,
   classes=1000, layout="NHWC")``, Xavier, ``cast("bfloat16")``) trained
   by ``parallel.SPMDTrainer`` with SGD (lr 0.1, momentum 0.9, wd 1e-4)
   on one synthetic batch of 128 x 3 x 224 x 224, 20 steps, with
   ``MXNET_FUSED_CONV_BWD=1`` through the captured step: K6 launched
   exactly 30 times a step, losses finite, the first within 1.0 of
   ln(1000), falling, and the run equal bit for bit to the same steps
   of a fresh net through a plain loop with the reference's update
   written in the script (``reference_sgd``); ms a step, images/s and
   peak memory; the captured and eager arms as in phase 7; then one
   profiled step, device time split among K6, cuDNN convolutions, GEMMs,
   BatchNorm, the optimizer and the rest; then the same 20 steps with
   the switch off (cuDNN's backward, no K6), and its arms;
15. one SGD step of a small bottleneck ResNet (f32, TF32 off) on the card
   (K6) held against the same step on the CPU (its plain version);
16. the tenth slice, the Gluon parameter layer, on ``mx.gpu(0)``: the
   reference's headline loop (``Dense(128, activation="relu")``,
   ``Dense(10)``, ``in_units`` deferred to 784, ``mx.init.Xavier()``,
   ``hybridize()``, ``gluon.Trainer(net.collect_params(), "adam")``,
   batch 64, 10 steps: losses finite and falling, every parameter on the
   card); ResNet-50 v1 (``get_model("resnet50_v1", classes=1000,
   layout="NHWC")``, ``initialize(ctx=mx.gpu(0))``, ``cast("bfloat16")``,
   ``hybridize()``) through ``gluon.Trainer(net.collect_params(),
   "sgd")`` on phase 14's batch as NDArrays, 20 steps of ``record``,
   ``backward``, ``step``: K6 launched exactly 30 times a step and no other
   kernel, losses finite, the first within 1.0 of ln(1000), falling; ms a
   step and images/s beside phase 14's ``SPMDTrainer`` arm (their
   difference is the Gluon layer's host cost), peak memory; then
   ``save_parameters``, ``load_parameters(ctx=mx.gpu(0))`` into a fresh
   net and an inference forward on both, equal bit for bit, the running
   statistics unmoved; and one f32 SGD step of a small bottleneck ResNet
   with deferred BatchNorms through the Gluon loop on the card against
   the CPU, its weights carried by ``save_parameters``: loss and every
   updated parameter within 1e-5 of the array's largest magnitude, every
   gradient within 1e-4 (cuDNN's f32 weight gradients reach 2e-5);
17. the fifth slice: K7 (``rtc.CudaModule``) compiles the user kernels of
   ``tests/_torch_rtc_sources.py`` with NVRTC (cold, then from the CUBIN
   cache); each (``gelu_fwd``/``gelu_bwd`` in bf16 and f32,
   ``softmax_rows`` with 96 KB of dynamic shared memory, ``addmul``) is
   held against its plain version at 8192 x 3072, element by element
   (within 1e-6 of the output's largest magnitude, plus for bf16 one bf16
   step of the element's own magnitude) and timed
   beside its bound, its plain version and the PyTorch call of the same
   function (kernel and library by both timers, ``cuda_ms`` and
   ``cuda_ms_queued``); 227 KB+ of shared memory is refused; K7's host
   microseconds a launch against a ``torch.add``, beside the host floor (a
   bare ``cuLaunchKernel`` from Python) and split into parts (the
   ``rtc launch parts:`` lines: the parent commit's path through its plain
   functions, and the launch plan's path); one ``gelu_fwd`` launch
   recorded into a CUDA graph, whose replay must equal the eager launch
   bit for bit; then the imperative path at GPT-2
   small's MLP width, bf16 on ``mx.gpu(0)``: ``mx.nd.dot`` + bias, the
   ``rtc_gelu`` custom op (one NVRTC kernel forward, one backward),
   ``mx.nd.dot`` + bias, mean squared error under ``autograd.record()``,
   ``backward()``, SGD by in-place ``NDArray`` updates, 10 steps of 8192
   rows: ``rtc`` launched exactly 20 times, losses finite and falling, ms
   a step, rows/s, peak memory, no step's buffers left for the cyclic
   collector, three profiled steps by group; and one f32
   step at 256 rows on the card against the CPU;
18. the eleventh slice, the fused train step and ``hybridize()`` as CUDA
   graphs: (1) one ResNet-50 1x1 convolution's forward and backward (K6)
   and one ``rtc_gelu`` forward and backward (K7) captured and replayed,
   each replay equal to the eager call bit for bit, the graphs' kernel
   nodes by name; (2) phase 16's ResNet-50 through
   ``trainer.fused_step(loss_fn, data, label)`` for 20 steps: exactly 30
   K6 nodes in the step graph, one capture, no phase-by-phase step,
   losses finite, the first within 1.0 of ln(1000), falling; ms a step
   and images/s beside phases 14 and 16, capture seconds, host
   microseconds a call, peak memory and its rise, the busy share of one
   profiled replay; (3) phase 16's small bottleneck ResNet in f32: three
   fused steps (eager, capture and replay, replay) against three phase by
   phase, loss within 1e-6 relative, parameters and running statistics
   within 1e-5; (4) six fused steps under ``CosineScheduler(6,
   base_lr=0.1, warmup_steps=2)`` against six phase by phase with one
   capture, then ``set_learning_rate(0.0)`` freezing the next replay;
   (5) the headline MLP with ``update_interval=4``, two windows of 4 x 16
   rows against two steps of 64; (6) the MLP block of phase 17 as a
   Gluon ``HybridBlock`` through ``gluon.Trainer`` phase by phase and
   through ``fused_step``, one ``gelu_fwd`` and one ``gelu_bwd`` node in
   the step graph, ms a step of both beside phase 17's; (7) ResNet-50
   inference at B=128, hybridized (a graph replay) against imperative,
   within 2 bf16 steps, ms a forward both ways; (8) ``MXNET_FUSED_STEP=0``
   equal to the phase-by-phase step bit for bit; (9) a block with
   attention dropout (K1-K3 at 8 x 1024 x 768) and ``gluon.nn.Dropout``
   through ``fused_step``, 10 Adam steps: K1, K2, K3 once a step, one
   capture, losses finite and falling, with lr 0 two replays different;
   hybridized, replays in training mode different, in inference mode
   within 2 bf16 steps of the imperative forward;
19. the thirteenth slice, the optimizers and the trainer's states:
   (1) GPT-2 small bf16 (12 layers, 768 units, 1024 context, dropout 0.1,
   8 x 1024 tokens) through ``SPMDTrainer`` with LAMB (multi-precision,
   lr 1e-3, wd 0.01): one ``step``, ``run_steps`` over 19 more; K1, K2,
   K3 exactly 12 times a step; losses finite, the first within 0.5 of
   ln(vocab), falling; ms a step beside phase 7's AdamW and the
   optimizer's device ms in one profiled eager step; three eager steps
   against three replays bit for bit; (2) phase 16's ResNet-50 (bf16,
   multi-precision) through ``gluon.Trainer(..., "lars")`` and
   ``fused_step`` with ``MXNET_FUSED_CONV_BWD=1``: 30 K6 nodes in the
   step graph, one capture; 10 steps, ``save_states`` +
   ``save_parameters``, 10 more; a fresh net and trainer loading both
   and running the last 10 equal the run bit for bit, and so does the
   original trainer after ``load_states`` with the step-10 weights put
   back (no new capture); losses finite, the first within 1.0 of
   ln(1000); (3) phase 18.6's MLP block through ``gluon.Trainer`` with
   each of the fifteen optimizers, with and without multi-precision:
   three ``fused_step`` calls (eager, capture and replay, replay)
   against three phase-by-phase steps bit for bit (SGLD phase by phase
   only), a states file written after step 2 giving step 3 bit for bit
   in a fresh trainer, ms a fused step and the optimizer's device share
   of one profiled step; (4) phases 16 and 18.2 (bf16 SGD without
   masters, the reference's Gluon-path typing) held bit for bit, losses
   and every parameter, against a plain loop with the reference's
   update written here (``reference_gluon_sgd``);
20. one ``{"kernels": [...]}`` line, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.

It exits nonzero without CUDA, and when the package is not beside it.
A copy of the results goes to ``chiprun_out/chip_smoke.json``.
"""
import functools
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
    with CUDA events after ``warm`` untimed calls.  The calls run as the
    host enqueues them, so a call whose host side is slower than its
    kernels (a decode matvec) is timed by the host."""
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


def cuda_ms_queued(fn, iters, warm=3, reps=3):
    """Device milliseconds of one ``fn(i)`` with the host out of the way:
    the median over ``reps`` runs of the mean over ``iters`` calls, timed
    with CUDA events after ``warm`` untimed calls, each run enqueued while
    a spin kernel holds the stream (for 1.5x the host's enqueue time plus
    1 ms, at most 0.2 s), so the calls' kernels run back to back; the
    median keeps a run the host stalled longer than the spin out.  Beside
    ``cuda_ms`` it says how much of a call's time is its kernels'."""
    import torch

    for i in range(warm):
        fn(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(0)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        # at most ~2 GHz
        torch.cuda._sleep(int(min(0.2, 1.5 * host_s * iters + 1e-3) * 2e9))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            fn(i)
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return sorted(runs)[len(runs) // 2]


def bound_ms(nbytes, nops, ops_per_s=BF16_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def design_tag(lib_name, fn_name):
    """The design string a kernel library reports for itself."""
    import ctypes
    from mxnet_tpu_torch import _build

    fn = getattr(_build.load(lib_name), fn_name)
    fn.restype = ctypes.c_char_p
    return fn().decode()


def ptxas_report(lib_name, kernel, key=None):
    """Registers and spill bytes of each instantiation of ``kernel`` in
    the ptxas report of this run's build of ``csrc/<lib_name>.cu``, by
    its template argument (the padded head dim of the attention kernels,
    K6's column tile), or by ``key(mangled name)`` where given."""
    import re
    from mxnet_tpu_torch import _build

    rows, cur = {}, None
    for line in _build.build_log.get(lib_name, "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            cur = None
            if kernel in name:
                dp = re.search(r"ILi(\d+)E", name)
                k = key(name) if key else dp.group(1) if dp else name
                cur = rows.setdefault(k, {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return rows


def report_design(what, lib_name, design_fn, kernel, key=None):
    tag = design_tag(lib_name, design_fn)
    regs = ptxas_report(lib_name, kernel, key)
    print(f"{what} design: {tag}", flush=True)
    print(f"{what} ptxas {kernel}: " + ("; ".join(
        f"<{dp}> {r.get('registers')} registers, spill stores "
        f"{r.get('spill_stores')} B, loads {r.get('spill_loads')} B"
        for dp, r in sorted(regs.items())) or "not built in this run"),
        flush=True)
    return dict(design=tag, ptxas=regs)


# --------------------------------------------------------------------------- #
# phase 3: K4
# --------------------------------------------------------------------------- #

def _k4_key(name):
    """K4's ptxas row: row bucket, x dtype, 16-byte or byte loads, the
    tensor-core or the FMA path."""
    import re

    m = re.search(r"ILi(\d+)E(.+?)Lb([01])ELb([01])E", name)
    if not m:
        return name
    return (f"R={m.group(1)},{'bf16' if 'bfloat16' in m.group(2) else 'f32'}"
            f",{'vec' if m.group(3) == '1' else 'bytes'}"
            f",{'mma' if m.group(4) == '1' else 'fma'}")


def _k4_case(name, S, K, O, has_bias, gen):
    """One K4 shape: error against the plain version, two launches bit
    for bit, kernel / plain / library times (kernel and library also with
    the host out of the way, ``cuda_ms_queued``) and the bound."""
    import torch
    from mxnet_tpu_torch.ops.q8_matvec import q8_matvec, q8_matvec_plain

    # enough weight copies to exceed the 50 MB L2: each timed launch
    # streams its codes from device memory, as a decode step does
    copies = max(2, -(-120_000_000 // (K * O)))
    wts = [torch.randint(-127, 128, (K, O), generator=gen, device="cuda",
                         dtype=torch.int8) for _ in range(copies)]
    x = torch.randn((S, K), generator=gen, device="cuda").bfloat16()
    s = (torch.rand((O,), generator=gen, device="cuda") + 0.5) * \
        (2.0 / (127.0 * K ** 0.5))
    b = torch.randn((O,), generator=gen, device="cuda") if has_bias else None
    got = q8_matvec(x, wts[0], s, b)
    again = q8_matvec(x, wts[0], s, b)
    ref = q8_matvec_plain(x, wts[0], s, b)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    tol = 1e-4 * max(1.0, ref.abs().max().item())
    if not torch.isfinite(got).all() or err > tol:
        fail(f"K4 {name} (S={S}, K={K}, O={O}): max_abs_err {err} > {tol}")
    if not torch.equal(got, again):
        fail(f"K4 {name} (S={S}, K={K}, O={O}): two launches differ")
    n = len(wts)
    ms = cuda_ms(lambda i: q8_matvec(x, wts[i % n], s, b), 50)
    queued = cuda_ms_queued(lambda i: q8_matvec(x, wts[i % n], s, b), 50)
    plain = cuda_ms(lambda i: q8_matvec_plain(x, wts[i % n], s, b), 10)
    lib = cuda_ms(lambda i: x @ wts[i % n].to(torch.bfloat16), 10)
    lib_queued = cuda_ms_queued(lambda i: x @ wts[i % n].to(torch.bfloat16),
                                10)
    nbytes = S * K * 2 + K * O + 4 * O * (2 if has_bias else 1) + 4 * S * O
    nops = 2 * S * K * O
    bms, by = bound_ms(nbytes, nops)
    rows, blocks, slices = q8_matvec.last_plan
    print(f"K4 {name:5s} S={S} K={K:5d} O={O:6d} plan rows={rows} blocks="
          f"{blocks} slices={slices}: max_abs_err={err:.3e} (tol "
          f"{tol:.3e}) bitwise repeat ok kernel_ms={ms:.5f} queued_ms="
          f"{queued:.5f} plain_ms={plain:.5f} library_ms={lib:.5f} "
          f"library_queued_ms={lib_queued:.5f} bound_ms={bms:.5f} ({by}) "
          f"kernel/bound={ms / bms:.2f} kernel/library={ms / lib:.3f} "
          f"queued: kernel/library={queued / lib_queued:.3f}", flush=True)
    del wts
    return dict(shape=name, S=S, K=K, O=O, max_abs_err=err, tol=tol, ms=ms,
                queued_ms=queued, plain_ms=plain, library_ms=lib,
                library_queued_ms=lib_queued, bound_ms=bms, bound_by=by,
                bytes=nbytes, ops=nops, plan=[rows, blocks, slices])


def check_k4(cfg):
    """K4 at GPT-2 small's five decode shapes with the server's two pools
    (8 and 4 rows), summed per decode step; then at Llama-7B's shapes at
    one row (the unfused int8 stream's seven projections and the fused
    run's head).  Every shape: error, bitwise repeat, times, bound."""
    import torch

    design = report_design("K4", "q8_matvec", "q8_matvec_design",
                           "q8_matvec_kernel", key=_k4_key)
    U, F, V = cfg.units, cfg.hidden_size, cfg.vocab_size
    Vp = -(-V // 128) * 128
    # (name, K, O, has_bias, calls per decode step)
    shapes = [("qkv", U, 3 * U, True, cfg.num_layers),
              ("proj", U, U, True, cfg.num_layers),
              ("fc1", U, F, True, cfg.num_layers),
              ("fc2", F, U, True, cfg.num_layers),
              ("head", U, Vp, False, 1)]
    gen = torch.Generator(device="cuda").manual_seed(4)
    out = dict(design=design, steps={}, shapes=[])
    for S in (8, 4):
        step = dict(ms=0.0, queued_ms=0.0, plain_ms=0.0, library_ms=0.0,
                    library_queued_ms=0.0, bytes=0, ops=0)
        for name, K, O, has_bias, calls in shapes:
            row = _k4_case(name, S, K, O, has_bias, gen)
            out["shapes"].append(row)
            for k in step:
                step[k] += calls * row[k]
        step["bound_ms"], step["bound_by"] = bound_ms(step["bytes"],
                                                      step["ops"])
        print(f"K4 per decode step ({4 * cfg.num_layers + 1} launches, "
              f"S={S}): kernel_ms={step['ms']:.5f} queued_ms="
              f"{step['queued_ms']:.5f} plain_ms={step['plain_ms']:.5f} "
              f"library_ms={step['library_ms']:.5f} library_queued_ms="
              f"{step['library_queued_ms']:.5f} bound_ms="
              f"{step['bound_ms']:.5f} ({step['bytes']} bytes)", flush=True)
        out["steps"][S] = step
    for name, K, O in (("l7b_qkvo", 4096, 4096), ("l7b_gate_up", 4096, 11008),
                       ("l7b_down", 11008, 4096), ("l7b_head", 4096, 32000)):
        out["shapes"].append(_k4_case(name, 1, K, O, False, gen))
        torch.cuda.empty_cache()
    for timer, k, lk in (("cuda_ms", "ms", "library_ms"),
                         ("cuda_ms_queued", "queued_ms",
                          "library_queued_ms")):
        slower = [f"{r['shape']} S={r['S']}" for r in out["shapes"]
                  if r[k] > r[lk]]
        print(f"K4 shapes slower than x @ wt.to(bf16) ({timer}): "
              f"{slower or 'none'}", flush=True)
    out["max_abs_err"] = max(r["max_abs_err"] for r in out["shapes"])
    # the kernels line reads the 8-row pool's decode step
    out.update({k: out["steps"][8][k] for k in
                ("ms", "queued_ms", "plain_ms", "library_ms",
                 "library_queued_ms", "bound_ms", "bound_by")})
    return out


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
    # the dropout seed as the kernels read it: a device word
    word = torch.full((1,), 1234, dtype=torch.int64, device="cuda")
    cases = [("prefill_causal", B, 1024, 1024, True, False, 0.0),
             ("kmask_dropout", 2, 384, 384, False, True, 0.1),
             ("train_causal_dropout", B, 1024, 1024, True, False, 0.1)]
    for name, b, L, Lk, causal, masked, rate in cases:
        q, k, v = (torch.randn((b, H, n, D), generator=gen, device="cuda")
                   .bfloat16() for n in (L, Lk, Lk))
        km = None
        if masked:
            km = torch.zeros((b, 1, Lk), device="cuda")
            km[0, 0, Lk - 50:] = -1e30
            km[1, 0, Lk - 7:] = -1e30
        scale = D ** -0.5
        out, lse = flash_fwd(q, k, v, scale, causal, km, word, rate)
        ro, rl = flash_fwd_plain(q, k, v, scale, causal, km, word, rate)
        torch.cuda.synchronize()
        err = (out.float() - ro.float()).abs().max().item()
        lerr = (lse - rl).abs().max().item()
        if not torch.isfinite(out.float()).all() or err > 2e-2 or \
                lerr > 1e-3:
            fail(f"K1 {name}: out max_abs_err {err} (tol 2e-2), lse "
                 f"max_abs_err {lerr} (tol 1e-3)")
        # no atomics: a second launch repeats out and lse bit for bit
        out2, lse2 = flash_fwd(q, k, v, scale, causal, km, word, rate)
        if not (torch.equal(out, out2) and torch.equal(lse, lse2)):
            fail(f"K1 {name}: two launches differ")
        ms = cuda_ms(lambda i: flash_fwd(q, k, v, scale, causal, km, word,
                                         rate), 20)
        plain = cuda_ms(lambda i: flash_fwd_plain(q, k, v, scale, causal,
                                                  km, word, rate), 5)
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
    print("K1 two launches equal bit for bit in every case", flush=True)
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
    word = torch.full((1,), 1234, dtype=torch.int64, device="cuda")
    cases = [("train_causal", B, 1024, 1024, True, False, 0.0),
             ("ragged_kmask_dropout", 2, 640, 640, False, True, 0.1),
             ("train_causal_dropout", B, 1024, 1024, True, False, 0.1)]
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
        out, lse = pa.flash_fwd(q, k, v, scale, causal, km, word, rate)
        delta = (out.float() * g.float()).sum(-1)
        args = (q, k, v, g, lse, delta, scale, causal, km, word, rate)
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
        # no atomics: second launches repeat dq, dk, dv, dbias bit for bit
        again = (pa.flash_bwd_dq(*args),
                 *pa.flash_bwd_dkv(*args, need_dbias=masked))
        for what, x, y in zip(("dq", "dk", "dv", "dbias"),
                              (dq, dk, dv, db), again):
            if x is not None and not torch.equal(x, y):
                fail(f"K2/K3 {name} {what}: two launches differ")
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
            o = pa._FlashAttention.apply(*leaves, bias, scale, causal, word,
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
              f"scaled_dot_product_attention ms={lib_fb_ms:.5f}; two "
              f"launches equal bit for bit", flush=True)
        results.append(row)
    return results


# --------------------------------------------------------------------------- #
# phase 5b: K1-K3's dropout seed as a device word
# --------------------------------------------------------------------------- #

SEED_RATE = 0.1


def _onehot_window(B, H, L, D, w, rows):
    """(B, H, L, D) bf16 zeros with a one at (w*D + d, d) for d < D (the
    window ``w`` of ``rows``, one row a column)."""
    import torch

    t = torch.zeros((B, H, L, D), dtype=torch.bfloat16, device="cuda")
    r = torch.arange(D, device="cuda")
    t[:, :, w * D + r, r] = 1.0
    return t


def check_seed_masks(cfg, B):
    """K1, K2 and K3 read their dropout seed from a device word.  At
    GPT-2's training shape (B x 12 heads x 1024 x 64, causal, dropout
    0.1) each kernel's keep mask is read back through one-hot operands
    (q = 0, so every allowed probability is 1/(q+1)): K1's out with v a
    one-hot window of keys, K2's dq with k one, K3's dv with do a one-hot
    window of query rows; each must equal the plain version's mask
    (``attention._keep`` of the same word, causal) bit for bit.  Then
    the three kernels run inside a ``_GraphProgram`` whose traced key
    gives ``flash_attention`` its seed on the device: a replay with the
    eager call's key repeats it bit for bit, a replay with another key
    drops other entries."""
    import torch
    from mxnet_tpu_torch.gluon.block import _GraphProgram
    from mxnet_tpu_torch.ops import attention as pa

    H = cfg.num_heads
    D = cfg.units // H
    L = 1024
    word = torch.full((1,), 98765, dtype=torch.int64, device="cuda")
    scale = D ** -0.5
    zero = torch.zeros((B, H, L, D), dtype=torch.bfloat16, device="cuda")
    ones = torch.ones_like(zero)
    _, lse = pa.flash_fwd(zero, zero, zero, scale, True, None, word,
                          SEED_RATE)
    delta = torch.zeros_like(lse)
    bh, qpos, kpos = pa._positions(B, H, L, D, "cuda")
    bad = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    kept = 0
    for w in range(L // D):
        win = _onehot_window(B, H, L, D, w, L)
        keys = kpos + w * D                              # (1, D)
        ref = pa._keep(word, bh, qpos, keys, SEED_RATE) & (qpos >= keys)
        out, _ = pa.flash_fwd(zero, zero, win, scale, True, None, word,
                              SEED_RATE)
        bad["flash_fwd"] += int(((out != 0) != ref).sum())
        dq = pa.flash_bwd_dq(zero, win, ones, ones, lse, delta, scale, True,
                             None, word, SEED_RATE)
        bad["flash_bwd_dq"] += int(((dq != 0) != ref).sum())
        # dv[k, d] = p_drop[w*D + d, k]: the mask of query rows w*D + d
        _, dv, _ = pa.flash_bwd_dkv(zero, zero, ones, win, lse, delta,
                                    scale, True, None, word, SEED_RATE)
        rows = qpos[w * D:(w + 1) * D].reshape(1, D)        # (1, D)
        allk = torch.arange(L, device="cuda").reshape(L, 1)
        ref_t = pa._keep(word, bh, rows, allk, SEED_RATE) & (rows >= allk)
        bad["flash_bwd_dkv"] += int(((dv != 0) != ref_t).sum())
        kept += int(ref.sum())
    allowed = B * H * L * (L + 1) // 2
    print(f"seed word: K1/K2/K3 keep masks at B={B} H={H} L={L} D={D} "
          f"causal dropout {SEED_RATE} against the plain version's, "
          f"entries that differ {bad} (kept {kept} of {allowed} allowed, "
          f"{kept / allowed:.5f})", flush=True)
    if any(bad.values()):
        fail(f"seed word: the kernels' keep masks differ from the plain "
             f"version's: {bad}")
    del zero, ones, lse
    # the seed from a traced key, inside a captured program
    gen = torch.Generator(device="cuda").manual_seed(31)
    q, k, v, g = (torch.randn((B, H, L, D), generator=gen, device="cuda")
                  .bfloat16() for _ in range(4))
    leaves = [x.requires_grad_() for x in (q, k, v)]
    key = torch.zeros(1, dtype=torch.int32, device="cuda")

    def fn():
        o = pa.flash_attention(*leaves, causal=True, dropout=SEED_RATE,
                               training=True)
        return [o.detach(), *torch.autograd.grad(o, leaves, g)]

    prog = _GraphProgram(fn, "cuda", None, [], key=key)
    launches0 = {n: getattr(pa, n).launches for n in bad}
    key.fill_(7)
    eager = prog()                          # eager
    key.fill_(7)
    same = prog()                           # capture, replay
    key.fill_(8)
    other = prog()                          # replay, another key
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(eager, same))
    differ = [not torch.equal(a, b) for a, b in zip(same, other)]
    print(f"seed word: flash_attention dropout {SEED_RATE} in a captured "
          f"program: replay with the eager call's key equal bit for bit "
          f"{equal}; replay with another key differs (out, dq, dk, dv) "
          f"{differ}; launches a replay {prog.launches}", flush=True)
    if not equal or not all(differ):
        fail("seed word: a replay did not follow its traced key")
    if any(prog.launches.get(n) != 1 for n in bad):
        fail(f"seed word: the captured program launches {prog.launches}, "
             "expected one launch of each of K1, K2, K3")
    for n in bad:
        getattr(pa, n).launches = launches0[n]
    return dict(bad_entries=bad, kept=kept, allowed=allowed,
                replay_equal=equal, other_key_differs=differ)


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
EAGER_STEPS = 5             # the eager arm, beside the captured one


def _graph_launches(trainer, counts):
    """The kernels a run launched: the wrappers' counts (eager calls and
    captures) less what the captures recorded (they run nothing) plus
    what the replays ran."""
    out = dict(counts)
    for k, n in trainer.captured_launches.items():
        out[k] = out.get(k, 0) - n
    for k, n in trainer.replayed_launches.items():
        out[k] = out.get(k, 0) + n
    return out


def _attention_counts():
    from mxnet_tpu_torch.ops import attention as pa

    return {n: getattr(pa, n).launches
            for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}


def _reset_attention_counts():
    from mxnet_tpu_torch.ops import attention as pa

    for fn in (pa.flash_fwd, pa.flash_bwd_dq, pa.flash_bwd_dkv):
        fn.launches = 0


def _pool_of_a_capture(trainer, prog):
    """The step program captured once more, into a graph pool of its own
    that is never replayed (a capture records and runs nothing), from
    the base the eager arm is measured from: the device memory the pool
    reserves and the peak allocated above the base across the capture.
    The capture counts as one in the trainer's ``captured_launches``."""
    import torch
    from mxnet_tpu_torch.gluon.block import _no_collection

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    reserved = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    g = torch.cuda.CUDAGraph()
    for gen in prog.generators:
        g.register_generator_state(gen)
    with _no_collection(), torch.cuda.graph(g):
        outs = prog.run(capturing=True)
    torch.cuda.synchronize()
    pool = torch.cuda.memory_reserved() - reserved
    peak = torch.cuda.max_memory_allocated() - base
    trainer._count(prog, trainer.captured_launches, 1)
    del g, outs
    torch.cuda.empty_cache()
    return pool, peak


def spmd_arms(trainer, data, label, what, steps=EAGER_STEPS):
    """The captured arm and the eager arm of an ``SPMDTrainer`` whose
    step graph exists, ``steps`` steps each on one batch: the captured
    arm is one write and ``steps`` bare replays (host us a replay call,
    ms a step by the host clock after a sync); the eager arm is the same
    program's own function called outside the graph (``prog.run()``)
    step by step.  Memory, from one base (after the trainer's states
    exist): the eager arm's peak allocated above it, against the pool a
    capture of the step reserves and the peak allocated across that
    capture (``_pool_of_a_capture``); the pool must stay below twice the
    eager peak.  The step graph's kernel nodes (``step_hlo_op_count``),
    capture seconds and the busy share of one profiled replay."""
    import torch

    # within the stage the step graph was captured with
    steps = min(steps, max(p.stage for p in trainer._programs.values()))
    d, l = data[None].expand(steps, *data.shape), \
        label[None].expand(steps, *label.shape)
    nodes = trainer.step_hlo_op_count(data, label)
    prog = trainer._prepare(d, l, None)
    torch.cuda.synchronize()
    host = []
    t0 = time.perf_counter()
    for _ in range(steps):
        h0 = time.perf_counter()
        prog.graph.replay()
        host.append(time.perf_counter() - h0)
    torch.cuda.synchronize()
    captured_ms = (time.perf_counter() - t0) / steps * 1e3
    prog.replays += steps
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        trainer._prepare(data[None], label[None], None).run()
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) / steps * 1e3
    eager_peak = torch.cuda.max_memory_allocated() - base
    pool, capture_peak = _pool_of_a_capture(trainer, prog)
    trainer._prepare(data[None], label[None], None)
    by_name, busy, wall_us = _profiled(prog.graph.replay)
    row = dict(captured_ms_per_step=captured_ms, eager_ms_per_step=eager_ms,
               host_us_a_replay=sorted(host)[len(host) // 2] * 1e6,
               capture_s=prog.capture_s, step_hlo_op_count=nodes,
               eager_peak_above_base=eager_peak,
               capture_pool_reserved=pool,
               capture_peak_above_base=capture_peak,
               pool_over_eager_peak=pool / eager_peak,
               replay_busy=busy / wall_us if busy > 0 else None,
               replay_window_us=wall_us)
    print(f"{what}: captured {captured_ms:.3f} ms/step (one write, "
          f"{steps} replays; host {row['host_us_a_replay']:.1f} us a "
          f"replay call, median) beside eager {eager_ms:.3f} ms/step "
          f"(the program's own function outside the graph); capture "
          f"{prog.capture_s:.3f} s; step_hlo_op_count {nodes} kernel "
          f"nodes; memory above one base: eager peak {eager_peak}, a "
          f"capture's pool {pool} reserved ({pool / eager_peak:.4f}x the "
          f"eager peak) and {capture_peak} peak allocated across it; one "
          f"replay under torch.profiler: device busy "
          + (f"{row['replay_busy']:.4f} of {wall_us:.0f} us"
             if busy > 0 else "not measured (no device time recorded)"),
          flush=True)
    if not pool < 2 * eager_peak:
        fail(f"{what}: the graph pool ({pool}) is not below twice the "
             f"eager step's peak ({eager_peak})")
    return row


def check_training(cfg):
    """GPT-2 small, bf16, dropout 0.1, AdamW (multi-precision) on one
    repeated batch through the captured step: ``step`` once (the eager
    call of a one-batch program), then ``run_steps`` over the rest (its
    own program: eager, capture and replay, then bare replays).  The
    launch counts are set to 0 just before and read just after; a
    replay's launches count by what its capture recorded."""
    import math

    import numpy as np
    import torch
    from mxnet_tpu_torch import gluon, parallel, random
    from mxnet_tpu_torch.models import gpt2_small

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
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _reset_attention_counts()
    t0 = time.perf_counter()
    first = trainer.step(data, label)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    more = trainer.run_steps(data[None].expand(rest, -1, -1),
                             label[None].expand(rest, -1, -1))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = _graph_launches(trainer, _attention_counts())
    peak = torch.cuda.max_memory_allocated()
    losses = [float(first)] + [float(x) for x in more.float().cpu()]
    step_ms = (t2 - t1) / rest * 1e3
    tok_s = rest * TRAIN_B * TRAIN_T / (t2 - t1)
    print(f"train: gpt2_small bf16 dropout 0.1, B={TRAIN_B} T={TRAIN_T}, "
          f"{TRAIN_STEPS} steps through the captured step; losses "
          f"{[round(x, 4) for x in losses]}", flush=True)
    print(f"train: tokens/s={tok_s:.2f} ms/step={step_ms:.3f} (steps 2-"
          f"{TRAIN_STEPS}: one eager call, one capture, replays; first "
          f"step {(t1 - t0) * 1e3:.3f} ms) max_memory_allocated={peak} "
          f"({peak - start} above the phase's start) launches {launches} "
          f"(a replay's {trainer.captured_launches})", flush=True)
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
    arms = spmd_arms(trainer, data, label, "train arms")
    arms["captured_tokens_per_s"] = TRAIN_B * TRAIN_T / \
        arms["captured_ms_per_step"] * 1e3
    arms["eager_tokens_per_s"] = TRAIN_B * TRAIN_T / \
        arms["eager_ms_per_step"] * 1e3
    print(f"train arms: tokens/s captured "
          f"{arms['captured_tokens_per_s']:.2f}, eager "
          f"{arms['eager_tokens_per_s']:.2f}", flush=True)
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
                launches=launches, arms=arms, profile=prof)


ADAMW_OPT = {"learning_rate": 1e-4, "wd": 0.01, "multi_precision": True}


def _gpt2_trainer(dropout, seed, num_layers=None, dtype="bfloat16",
                  optimizer="adamw", opt=ADAMW_OPT):
    import torch
    from mxnet_tpu_torch import gluon, parallel
    from mxnet_tpu_torch.models import gpt2_small

    kw = {} if num_layers is None else {"num_layers": num_layers}
    model, _ = gpt2_small(dtype=getattr(torch, dtype), dropout=dropout,
                          **kw)
    model.initialize(0.02, seed=seed)
    return model, parallel.SPMDTrainer(
        model, gluon.loss.SoftmaxCrossEntropyLoss(), optimizer, dict(opt))


def _bf16_steps_apart(a, b):
    """How many bf16 steps of ``b``'s magnitude ``a`` is from ``b``."""
    import torch

    step = torch.finfo(torch.bfloat16).eps * max(
        b.float().abs().max().item(), 1e-30)
    return (a.float() - b.float()).abs().max().item() / step


def check_captured_vs_eager(cfg):
    """7.2: GPT-2 small bf16 at dropout 0.1 from the same weights and the
    same keys (``random.seed``), three steps of the eager program
    function against three bare replays of the captured step (its graph
    made first by ``step_hlo_op_count``: a restored warm-up, then the
    capture): equal losses and weights bit for bit.  7.3: with lr 0, two
    replays on one batch give different losses at dropout 0.1 (fresh
    masks) and equal losses at dropout 0: 2-layer models in f32, whose
    loss resolves what one bf16 step of a bf16 loss (0.0625 at 11)
    hides."""
    import torch

    row = eager_vs_replays("captured vs eager", cfg, "adamw", ADAMW_OPT)
    data, label = _tokens_7_2(cfg)
    rows = {}
    for rate in (0.1, 0.0):
        _, tr = _gpt2_trainer(rate, 1, num_layers=2, dtype="float32")
        tr.set_learning_rate(0.0)
        rows[rate] = tr.run_steps(data[None].expand(4, -1, -1),
                                  label[None].expand(4, -1, -1)).cpu()
        del tr
    fresh, still = rows[0.1], rows[0.0]
    print(f"fresh masks: lr 0, one batch, 2-layer f32 (steps 2-4 are "
          f"replays): dropout 0.1 losses {fresh.tolist()}; dropout 0 "
          f"{still.tolist()}", flush=True)
    if fresh[2] == fresh[3] or not (still[1] == still[2] == still[3]):
        fail("fresh masks: replays at dropout 0.1 must differ and at "
             "dropout 0 must not")
    torch.cuda.empty_cache()
    return dict(row, fresh_dropout=fresh.tolist(),
                fresh_no_dropout=still.tolist())


def _tokens_7_2(cfg):
    import numpy as np
    import torch

    rs = np.random.RandomState(10)
    return tuple(torch.as_tensor(rs.randint(0, cfg.vocab_size,
                                            (TRAIN_B, TRAIN_T)),
                                 device="cuda") for _ in range(2))


def eager_vs_replays(what, cfg, optimizer, opt):
    """GPT-2 small bf16 at dropout 0.1 through ``SPMDTrainer`` with
    ``optimizer`` from the same weights and the same keys
    (``random.seed``): three steps of the eager program function against
    three bare replays of the captured step (its graph made first by
    ``step_hlo_op_count``: a restored warm-up, then the capture); the
    losses and the weights must be equal bit for bit."""
    import torch
    from mxnet_tpu_torch import random

    data, label = _tokens_7_2(cfg)
    arms = {}
    for arm in ("eager", "captured"):
        model, trainer = _gpt2_trainer(0.1, 1, optimizer=optimizer, opt=opt)
        random.seed(11)
        if arm == "eager":
            losses = [trainer._prepare(data[None], label[None], None)
                      .run()[0][0].clone() for _ in range(3)]
        else:
            trainer.step_hlo_op_count(data, label)
            losses = [trainer.step(data, label) for _ in range(3)]
        torch.cuda.synchronize()
        arms[arm] = (torch.stack(losses).float().cpu(),
                     [p.detach().clone() for p in model.parameters()],
                     trainer)
        del model
    (le, we, _), (lc, wc, tc) = arms["eager"], arms["captured"]
    loss_equal = torch.equal(le, lc)
    diffs = [(i, _bf16_steps_apart(a, b)) for i, (a, b) in
             enumerate(zip(wc, we)) if not torch.equal(a, b)]
    worst = max((d for _, d in diffs), default=0.0)
    print(f"{what}: 3 steps at dropout 0.1 ({optimizer}), losses eager "
          f"{le.tolist()} captured {lc.tolist()} (equal bit for bit "
          f"{loss_equal}); weights differing {len(diffs)} of {len(we)} "
          f"(largest {worst:.3f} bf16 steps of the weight's magnitude)",
          flush=True)
    if not loss_equal or diffs:
        fail(f"{what}: the captured step departs from the eager one (loss "
             f"equal {loss_equal}, weights {diffs[:8]})")
    del arms, we, wc, tc
    torch.cuda.empty_cache()
    return dict(losses_eager=le.tolist(), losses_captured=lc.tolist(),
                weights_differing=len(diffs), worst_bf16_steps=worst)


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
    _reset_attention_counts()
    first = trainer.step(data, label)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    more = trainer.run_steps(data[None].expand(steps - 1, -1, -1),
                             label[None].expand(steps - 1, -1, -1))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    losses = [float(first)] + [float(x) for x in more.float().cpu()]
    kernels = sum(_graph_launches(trainer, _attention_counts()).values())
    tok_s = (steps - 1) * B * T / dt
    print(f"bert: bert_base bf16 (vocab {cfg.vocab_size}), B={B} T={T}, "
          f"{steps} steps; losses {[round(x, 4) for x in losses]}; "
          f"tokens/s={tok_s:.2f} ms/step={dt / (steps - 1) * 1e3:.3f} "
          f"(steps 2-{steps}); attention kernel launches {kernels} (seq "
          f"{T} takes the plain path, as in the reference)", flush=True)
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        fail(f"BERT losses not finite and falling: {losses}")
    arms = spmd_arms(trainer, data, label, "bert arms")
    del trainer, bert
    torch.cuda.empty_cache()
    return dict(losses=losses, tokens_per_s=tok_s,
                ms_per_step=dt / (steps - 1) * 1e3, kernel_launches=kernels,
                arms=arms)


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

    design = report_design("K5", "decode_fused", "decode_fused_design",
                           "decode_fused_kernel")
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
            # a second launch on the same inputs: x and the written column
            # bit for bit
            k2, v2 = kh.clone(), vh.clone()
            again = decode_step(pos, x, pack, k2, v2, cfg, act, eps)[0]
            torch.cuda.synchronize()
            if not (torch.equal(got, again) and
                    torch.equal(k2[:, :, :, pos], kk[:, :, :, pos]) and
                    torch.equal(v2[:, :, :, pos], vk[:, :, :, pos])):
                fail(f"K5 {name} {weights}: two launches differ")
            del k2, v2
            ms = cuda_ms(lambda i: decode_step(pos, x, pack, kk, vk, cfg,
                                               act, eps), 20)
            queued = cuda_ms_queued(lambda i: decode_step(
                pos, x, pack, kk, vk, cfg, act, eps), 20)
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
                       plan=decode_step.last_plan,
                       max_abs_err=max(e for e, _ in errs.values()),
                       bf16_steps={w: st for w, (_, st) in errs.items()},
                       ms=ms, queued_ms=queued, plain_ms=plain,
                       bound_ms=bms, bound_by=by,
                       fused_step_ms=fused_step, unfused_step_ms=unfused)
            rows.append(row)
            print(f"K5 {name} {weights} NL={NL} B={B} T={T} pos={pos} "
                  f"KV={KV} grid={decode_step.grid} plan="
                  f"{decode_step.last_plan}: bitwise repeat ok, max_abs_err " +
                  " ".join(f"{w}={e:.3e} ({st:.2f} steps)"
                           for w, (e, st) in errs.items()) +
                  f" (tol {K5_STEPS} bf16 steps); kernel_ms={ms:.5f} "
                  f"queued_ms={queued:.5f} "
                  f"bound_ms={bms:.5f} ({by}) plain_ms={plain:.5f} "
                  f"fused_step_ms={fused_step:.5f} unfused_step_ms="
                  f"{unfused:.5f}", flush=True)
            del ueng, kp, vp
    return rows, design


# --------------------------------------------------------------------------- #
# phases 11-12: kv_generate(fused="on"), GPT-2 small and Llama-7B
# --------------------------------------------------------------------------- #

TIE_STEPS = 2      # a top-2 logit margin below this many bf16 steps: a tie


def teacher_forced(model, prompts, stream, weights, clear=None):
    """Share of the fused stream's new tokens that the unfused step
    predicts when fed the stream's own earlier tokens (greedy): the
    prefill's argmax against the first new token, then one unfused step
    per position.  A single flip does not cascade here, as it does in a
    whole-stream comparison.  Where ``clear`` (a dict) is given, it gets
    the same share over the positions whose unfused top-2 logit margin is
    at least ``TIE_STEPS`` bf16 steps of the top logit (``agreement``)
    and their count (``positions``): rounding order alone cannot flip
    those."""
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
    steps = [logits]
    for t in range(P, total - 1):
        posv = torch.full((B,), t, dtype=torch.int64, device="cuda")
        steps.append(eng.paged_step(s[:, t], posv, kp, vp, pt, total))
    lg = torch.stack(steps, 1).float()                   # (B, new, V)
    same = lg.argmax(-1) == s[:, P:]
    if clear is not None:
        top = lg.topk(2, dim=-1).values
        wide = (top[..., 0] - top[..., 1]) >= \
            TIE_STEPS * 2.0 ** -8 * top[..., 0].abs()
        clear["positions"] = int(wide.sum().item())
        clear["agreement"] = (same[wide].float().mean().item()
                              if clear["positions"] else None)
    return same.float().mean().item()


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
    clear = {}
    tf = teacher_forced(model, prompts, out, weights, clear)
    whole = float((out[:, P:] == ref[:, P:]).mean())
    row = dict(weights=weights, prefill=prefill, B=B, P=P, new=new,
               launches=launches, tokens_per_s=B * new / t_fused,
               unfused_tokens_per_s=B * new / t_unfused,
               ms_per_token=t_fused / (new - 1) * 1e3,
               unfused_ms_per_token=t_unfused / (new - 1) * 1e3,
               teacher_forced=tf, whole_stream_agreement=whole,
               teacher_forced_clear=clear)
    print(f"{what}: {weights} prefill={prefill} B={B} P={P} new={new} "
          f"launches {launches}; tokens/s fused={row['tokens_per_s']:.2f} "
          f"unfused={row['unfused_tokens_per_s']:.2f}; ms/token fused="
          f"{row['ms_per_token']:.4f} unfused="
          f"{row['unfused_ms_per_token']:.4f}; teacher-forced agreement="
          f"{tf:.4f} (bar 0.9), over the {clear['positions']} positions "
          f"with a top-2 margin of {TIE_STEPS}+ bf16 steps="
          f"{clear['agreement']}; whole-stream agreement={whole:.4f}",
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


# aten ops that reach a library GEMM or attention kernel
LIBRARY_OPS = ("mm", "addmm", "bmm", "baddbmm", "matmul", "linear", "mv",
               "addmv", "dot", "_scaled_dot_product", "scaled_dot_product",
               "_flash_attention", "_efficient_attention", "_cudnn_attention")


def _aten_ops(fn):
    """Run ``fn()`` and return the names of the aten ops it dispatched
    (without their overload)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = set()

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.add(func.__name__.split(".")[0])
            return func(*args, **(kwargs or {}))

    with Record():
        fn()
    return seen


def profile_fused(model, tries=3):
    """Three fused GPT-2-small steps from the embedding to ``ln_f``.  The
    checks rest on what the host sees, which no tracer can lose: K5's
    wrapper launched once a step, no attention wrapper ran, and no aten
    op of the stack reaches a library GEMM or attention kernel
    (``LIBRARY_OPS``).  Then the same steps under ``torch.profiler`` for
    the device's share by kernel; the tracer can miss kernels of its
    window (once K5 alone, once every kernel), so the window is taken up
    to ``tries`` times until it holds K5, and its kernel names must hold
    no library GEMM or attention kernel."""
    import torch
    from mxnet_tpu_torch.models.decoding import _DecodeEngine
    from mxnet_tpu_torch.ops import attention as pa
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
    k5 = decode_step.launches
    flash = (pa.flash_fwd.launches, pa.flash_bwd_dq.launches,
             pa.flash_bwd_dkv.launches)
    ops = _aten_ops(lambda: [layers() for _ in range(3)])
    torch.cuda.synchronize()
    if decode_step.launches - k5 != 3:
        fail(f"fused profile: K5 launched {decode_step.launches - k5} "
             "times in three steps, expected 3")
    if (pa.flash_fwd.launches, pa.flash_bwd_dq.launches,
            pa.flash_bwd_dkv.launches) != flash:
        fail("fused profile: an attention kernel ran inside the layer "
             "stack")
    lib_ops = sorted(o for o in ops if o in LIBRARY_OPS)
    if lib_ops:
        fail(f"fused profile: library GEMM/attention ops inside the layer "
             f"stack: {lib_ops}")
    print(f"fused profile: three steps launched K5 3 times and the aten "
          f"ops {sorted(ops)}", flush=True)
    for attempt in range(1, tries + 1):
        by_name, busy, wall_us = _profiled(
            lambda: [layers() for _ in range(3)])
        bad = [n for n in by_name if any(
            k in n.lower() for k in ("gemm", "gemv", "xmma", "cutlass",
                                     "nvjet", "flash", "fmha",
                                     "attention"))]
        if bad:
            fail(f"fused profile: library GEMM/attention kernels inside "
                 f"the layer stack: {bad}")
        if any("decode_fused_kernel" in n for n in by_name):
            break
        print(f"fused profile: window {attempt} of {tries} holds no K5 "
              f"kernel (the tracer recorded {sorted(by_name)})", flush=True)
    else:
        by_name, busy = {}, 0.0
    prof = report_profile("fused profile", by_name, busy, wall_us)
    prof.update(kernels=sorted(by_name), aten_ops=sorted(ops),
                windows=attempt)
    return prof


def split_fused_token(model, weights, ms_per_token, steps=10):
    """Where a fused Llama-7B token's time goes: CUDA events around the
    embedding, K5, ln_f + the head (K4 with int8) and the argmax of
    ``steps`` greedy steps at position 40 (device ms each), beside the
    ``kv_generate`` run's host-clock ms a token; the difference is host
    time between the launches."""
    import torch
    from mxnet_tpu_torch.models.decoding import _DecodeEngine
    from mxnet_tpu_torch.ops.decode_fused import decode_step

    cfg = model._cfg
    eng = _DecodeEngine(model, 0.0, 0, weights, fused=True)
    kc, vc = (torch.zeros((eng.NL, 1, eng.KV, 64, eng.D), device="cuda",
                          dtype=torch.bfloat16) for _ in range(2))
    tok = torch.zeros((1,), dtype=torch.int64, device="cuda")
    posv = torch.full((1,), 40, dtype=torch.int64, device="cuda")
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(5)]
          for _ in range(steps)]
    for i in range(steps + 2):
        e = ev[i - 2] if i >= 2 else None          # two untimed steps
        if e:
            e[0].record()
        x = eng.embed(tok, posv).contiguous()
        if e:
            e[1].record()
        x = decode_step(40, x, eng.packed, kc, vc, cfg, None,
                        eng.norm_eps[0])[0]
        if e:
            e[2].record()
        logits = eng.head_logits(model.ln_f(x))
        if e:
            e[3].record()
        tok = logits.argmax(-1)
        if e:
            e[4].record()
    torch.cuda.synchronize()
    parts = {k: sum(e[j].elapsed_time(e[j + 1]) for e in ev) / steps
             for j, k in enumerate(("embed", "k5", "head", "argmax"))}
    device = sum(parts.values())
    out = dict(parts, device_ms=device, ms_per_token=ms_per_token,
               host_ms=ms_per_token - device)
    print(f"llama_7b {weights} token split (device ms, {steps} steps at "
          f"pos 40): " + " ".join(f"{k}={v:.4f}" for k, v in parts.items())
          + f"; device {device:.4f} of {ms_per_token:.4f} ms a token "
          f"(kv_generate, host clock): {ms_per_token - device:.4f} ms "
          f"outside the kernels", flush=True)
    del eng, kc, vc
    return out


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
    for weights in ("native", "int8"):
        runs[weights]["split"] = split_fused_token(
            model, weights, runs[weights]["ms_per_token"])
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
          + f" dW rel_err={dw_rel:.3e} plan={cf.plan(p, ci, co, dt)} "
          f"kernel_ms={ms:.5f} bound_ms={bms:.5f} ({by}) plain_ms="
          f"{plain:.5f} cudnn_ms={lib:.5f} cublas_pair_ms={cublas:.5f}",
          flush=True)
    return dict(s=s, ci=ci, co=co, P=p, dtype=dtype, dx_max_abs_err=dx_err,
                dx_bf16_steps=dx_steps, dw_rel_err=dw_rel,
                max_abs_err=max(dx_err, dw_err), ms=ms, plain_ms=plain,
                library_ms=lib, cublas_ms=cublas, bound_ms=bms, bound_by=by,
                bytes=nbytes, ops=nops, plan=cf.plan(p, ci, co, dt))


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
    return (net, *_resnet_batch())


def _resnet_batch():
    """Phase 14's synthetic batch: 128 x 3 x 224 x 224 bf16 in [0, 1)
    and 128 labels, seeded, made on the card."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(15)
    data = torch.rand((RESNET_B, 3, 224, 224), generator=gen,
                      device="cuda").bfloat16()
    label = torch.randint(0, 1000, (RESNET_B,), generator=gen,
                          device="cuda")
    return data, label


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
    ``SPMDTrainer``'s captured step with ``MXNET_FUSED_CONV_BWD`` on or
    off, then its captured and eager arms (``spmd_arms``).  The launch
    counts are set to 0 just before the steps and read just after (a
    replay's launches count by what its capture recorded).  Returns the
    numbers and the trainer, net and batch."""
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
    launches = _graph_launches(trainer, dict(
        _counts(), conv1x1_bwd=cf.conv1x1_bwd_pair.launches))
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
    after = [p.detach().clone() for p in net.parameters()]
    row["arms"] = spmd_arms(trainer, data, label, f"resnet {arm} arms")
    return row, (trainer, net, data, label), after


def _as_bf16(x):
    """The Python number ``x`` rounded to bf16."""
    import torch

    return float(torch.tensor(x).bfloat16())


def reference_sgd(p, g, m, lr, momentum, wd):
    """One bf16 parameter's SGD update without a master copy, in place,
    written apart from the port's optimizer: the reference's jitted
    ``SPMDTrainer`` step (``mxnet_tpu/parallel/spmd.py`` ``step_fn``'s
    bf16 branch and ``SGD._update_rule``: ``g += wd * w; mom = mom *
    momentum - lr * g; w += mom``, the new weight and momentum rounded
    to bf16) as XLA compiles it on the CPU: lr f32, wd and momentum
    turned into bf16 first (JAX's weak types), ``wd * w`` rounded to
    bf16, the rest in f32.  ``tests/test_torch_spmd.py`` holds it to the
    reference's trainer on the CPU, ulp for ulp."""
    g = g.float() + (p * _as_bf16(wd)).float()
    mom = m.float() * _as_bf16(momentum) - g * lr
    p.copy_(p.float() + mom)
    m.copy_(mom)


def reference_gluon_sgd(p, g, m, lr, momentum, wd, rescale):
    """One bf16 parameter's SGD update without a master copy on the
    reference's Gluon path (``gluon.Trainer.step`` and ``fused_step``:
    ``Optimizer._apply_one``'s bf16 branch and ``SGD._update_rule``), in
    place, written apart from the port's optimizer: ``lr``, ``wd`` and
    the rescale are traced f32 operands there, so ``g * rescale`` is
    bf16 (the rescale rounded to bf16) and ``g + wd * w`` f32; the
    momentum is a Python number, rounded to bf16 where it meets the bf16
    momentum state.  As XLA compiles it on the CPU, a bf16 product read
    by an f32 operation is computed in f32.  ``tests/
    test_torch_trainer_states.py`` holds it to the reference's
    ``gluon.Trainer`` on the CPU, ulp for ulp."""
    import torch

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=p.device)

    g = g.float() * _as_bf16(rescale) + f32(wd) * p.float()
    mom = m.float() * _as_bf16(momentum) - f32(lr) * g
    p.copy_(p.float() + mom)
    m.copy_(mom)


def _witness_sgd():
    """20 SGD steps (``RESNET_OPT``) of a fresh ResNet-50 of phase 14's
    seed on its batch, independent of the port's optimizer and trainer:
    the net's forward in training mode, the mean loss,
    ``torch.autograd.grad``, then ``reference_sgd``.  Returns the losses
    and the net's parameters after the steps."""
    import torch
    from mxnet_tpu_torch import gluon

    net, data, label = _resnet50()
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    lr, momentum, wd = (RESNET_OPT[k] for k in
                        ("learning_rate", "momentum", "wd"))
    losses, params = [], None
    for _ in range(RESNET_STEPS):
        net.train()
        loss = loss_fn(net(data), label).mean()
        if params is None:
            # BatchNorm's gamma and beta exist from the first input on
            params = [p for p in net.parameters() if p.requires_grad]
            moms = [torch.zeros_like(p) for p in params]
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        losses.append(float(loss))
        with torch.no_grad():
            for p, g, m in zip(params, grads, moms):
                g = torch.zeros_like(p) if g is None else g.to(p.dtype)
                reference_sgd(p, g, m, lr * getattr(p, "lr_mult", 1.0),
                              momentum, wd * getattr(p, "wd_mult", 1.0))
    return losses, list(net.parameters())


def _resnet_witness(after, losses, arm):
    """The captured run of ``train_resnet`` held against ``_witness_sgd``:
    losses and every parameter (running statistics too) bit for bit.
    Made last: a new net moves the storage generation, which drops every
    trainer's programs."""
    import torch

    plain, params = _witness_sgd()
    differ = sum(not torch.equal(a, b) for a, b in zip(after, params))
    print(f"resnet {arm}: the same {RESNET_STEPS} steps from a fresh net "
          f"through a plain loop and the reference's SGD update written in "
          f"this script: losses equal bit for bit {plain == losses}, "
          f"parameters differing {differ} of {len(params)}", flush=True)
    if plain != losses or differ:
        fail(f"resnet {arm}: the trainer's run departs from the plain "
             f"update's (plain losses {plain}, {differ} parameters differ)")
    del params
    torch.cuda.empty_cache()
    return dict(plain_losses_equal=True, plain_parameters_differing=differ)


def _witness_gluon_sgd(init_state, fused, steps):
    """``steps`` SGD steps (``RESNET_OPT``) of a fresh ResNet-50 of phase
    16's making on phase 14's batch, its initial weights drawn from the
    generator state ``init_state`` (the generator is put back after),
    through a plain loop with ``reference_gluon_sgd``, independent of the
    port's optimizer and trainer: the gradients as ``gluon.Trainer.step``
    gets them (``record``, ``backward``) or, with ``fused``, as
    ``fused_step``'s program takes them (the deferred shapes by one
    inference forward, then ``torch.autograd.grad`` of the summed loss
    under ``trace_scope``).  Returns the losses and every parameter."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, random
    from mxnet_tpu_torch.gluon.block import _no_hybrid, trace_scope

    gen = random.generator("cuda")
    keep = gen.get_state()
    gen.set_state(init_state)
    try:
        net = _gluon_resnet50(mx)
        data, label = _resnet_batch()
        x, y = mx.nd.NDArray(data), mx.nd.NDArray(label)
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        if fused:
            with autograd.pause(train_mode=False), _no_hybrid():
                loss_fn(net(x), y)
        lr, momentum, wd = (RESNET_OPT[k] for k in
                            ("learning_rate", "momentum", "wd"))
        losses, params, moms = [], None, None
        for _ in range(steps):
            if fused:
                with trace_scope(True):
                    loss = loss_fn(net(x), y)._data
                train = [p for p in net.collect_params().values()
                         if p.grad_req != "null"]
                grads = torch.autograd.grad(
                    loss.sum(), [p.data()._data for p in train],
                    allow_unused=True)
            else:
                with autograd.record():
                    loss = loss_fn(net(x), y)
                loss.backward()
                loss = loss._data
                train = [p for p in net.collect_params().values()
                         if p.grad_req != "null"]
                grads = [p.grad()._data for p in train]
            losses.append(float(loss.detach().float().mean()))
            if params is None:
                params = train
                moms = [torch.zeros_like(p.data()._data) for p in params]
            with torch.no_grad():
                for p, g, m in zip(params, grads, moms):
                    w = p.data()._data
                    g = torch.zeros_like(w) if g is None else g
                    reference_gluon_sgd(w, g, m, lr * p.lr_mult, momentum,
                                        wd * p.wd_mult, 1.0 / RESNET_B)
        out = [p.data()._data.clone() for p in
               net.collect_params().values()]
    finally:
        gen.set_state(keep)
    del net
    torch.cuda.empty_cache()
    return losses, out


def _gluon_witness(what, init_state, fused, losses, after):
    """Phase 16's or 18.2's run held against ``_witness_gluon_sgd``: the
    losses and every parameter (running statistics too) bit for bit."""
    import torch

    plain, params = _witness_gluon_sgd(init_state, fused, len(losses))
    differ = sum(not torch.equal(a, b) for a, b in zip(after, params))
    print(f"{what}: the same {len(losses)} steps from a fresh net through "
          f"a plain loop with the reference's Gluon-path SGD written in "
          f"this script (reference_gluon_sgd): losses equal bit for bit "
          f"{plain == losses}, parameters differing {differ} of "
          f"{len(params)}; plain losses {[round(v, 4) for v in plain]}",
          flush=True)
    if plain != losses or differ:
        fail(f"{what}: the trainer's run departs from the plain loop's")
    return dict(plain_losses_equal=True, plain_parameters_differing=differ,
                plain_losses=plain)


def check_resnet(fused):
    """``train_resnet`` and its checks: with ``fused`` K6 ran exactly 30
    times a step, without it never, and no other kernel ran; the losses
    are finite, the first within 1.0 of ln(1000), and they fall; the
    captured run equals a plain loop with the reference's update written
    in this script bit for bit (``_resnet_witness``)."""
    import math

    import torch

    row, held, after = train_resnet(fused)
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
    row.update(_resnet_witness(after, losses, arm))
    del after
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
    card = ResNetV1(BottleneckV1, *spec, device="cuda", **kw)
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


# --------------------------------------------------------------------------- #
# phase 16: the Gluon parameter layer, the tenth slice
# --------------------------------------------------------------------------- #

GLUON_STEPS = 10            # the headline loop
GLUON_RESNET_STEPS = 20     # ResNet-50 through gluon.Trainer
GLUON_TOL = 1e-5            # f32 card vs CPU, of each array's largest value
# cuDNN's f32 weight gradients of the 3x3 convolutions (TF32 off; its
# algorithm varies from run to run) differ from the CPU's by 1.0-2.0e-5
# of their largest value at 8 x 32 x 32, further from the float64 step
# than the CPU's f32 (``gluon_vs_cpu`` prints both): gradients are held
# to phase 15's 1e-4 instead
GLUON_GRAD_TOL = 1e-4
# biases of the bottleneck's 1x1 convolutions: a BatchNorm follows, so
# their gradient is zero in exact arithmetic and summation noise in f32;
# held to GLUON_TOL of the net's largest gradient (parameter) instead
GLUON_NOISE = ("body.0.bias", "body.6.bias")


def gluon_headline():
    """The reference's headline loop on ``mx.gpu()``: ``Dense(128,
    activation="relu")``, ``Dense(10)`` with ``in_units`` deferred (784),
    ``mx.init.Xavier()``, ``hybridize()``, ``gluon.Trainer(
    net.collect_params(), "adam")``, batch 64, 10 steps; losses finite and
    falling, every parameter on the card."""
    import math

    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon

    mx.random.seed(0)
    rs = np.random.RandomState(21)
    x = mx.nd.array(rs.rand(64, 784), ctx=mx.gpu())
    y = mx.nd.array(rs.randint(0, 10, 64), ctx=mx.gpu())
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(128, activation="relu"), gluon.nn.Dense(10))
    net.initialize(mx.init.Xavier(), ctx=mx.gpu())
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "adam")
    losses = []
    for _ in range(GLUON_STEPS):
        with autograd.record():
            loss = gluon.loss.SoftmaxCrossEntropyLoss()(net(x), y)
        loss.backward()
        trainer.step(64)
        losses.append(loss.mean())
    losses = [float(v.asscalar()) for v in losses]
    shapes = [p.shape for p in net.collect_params().values()]
    on_card = all(p.data()._data.is_cuda and p.grad()._data.is_cuda
                  for p in net.collect_params().values())
    print(f"gluon headline: Dense(128, relu) + Dense(10), 784 deferred, "
          f"batch 64, adam, {GLUON_STEPS} steps on {mx.gpu()}; losses "
          f"{[round(v, 4) for v in losses]}; parameters {shapes}, on the "
          f"card: {on_card}", flush=True)
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        fail(f"gluon headline: losses not finite and falling: {losses}")
    if not on_card or shapes[0] != (128, 784):
        fail(f"gluon headline: parameters {shapes}, on the card {on_card}")
    return dict(losses=losses, shapes=shapes)


def _gluon_resnet50(mx):
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model

    net = get_model("resnet50_v1", classes=1000, layout="NHWC")
    net.initialize(mx.init.Xavier(rnd_type="uniform", factor_type="avg",
                                  magnitude=3), ctx=mx.gpu(0))
    net.cast("bfloat16")
    net.hybridize()
    return net


def gluon_resnet(spmd_row):
    """ResNet-50 v1 at full width through the Gluon loop on
    ``mx.gpu(0)``: phase 14's batch as NDArrays, ``gluon.Trainer(
    net.collect_params(), "sgd", RESNET_OPT)``, 20 steps of ``record``,
    ``backward``, ``step(128)`` with ``MXNET_FUSED_CONV_BWD=1``: K6
    launched exactly 30 times a step and no other kernel; losses finite,
    the first within 1.0 of ln(1000), falling; ms a step beside phase
    14's ``SPMDTrainer`` arm of this run.  Then ``save_parameters``,
    ``load_parameters(ctx=mx.gpu(0))`` into a fresh net and an inference
    forward on both: equal bit for bit, running statistics unmoved."""
    import math

    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, random
    from mxnet_tpu_torch.ops import conv_fused as cf

    os.environ["MXNET_FUSED_CONV_BWD"] = "1"
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    init_state = random.generator("cuda").get_state()
    net = _gluon_resnet50(mx)
    data, label = _resnet_batch()
    x, y = mx.nd.NDArray(data), mx.nd.NDArray(label)
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(RESNET_OPT))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

    def step():
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(RESNET_B)
        return loss._data.detach().float().mean()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    cf.conv1x1_bwd_pair.launches = 0
    t0 = time.perf_counter()
    losses = [step()]                       # the deferred shapes, too
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    losses += [step() for _ in range(GLUON_RESNET_STEPS - 1)]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(_counts(), conv1x1_bwd=cf.conv1x1_bwd_pair.launches)
    losses = [float(v) for v in losses]
    rest = GLUON_RESNET_STEPS - 1
    row = dict(losses=losses, ms_per_step=(t2 - t1) / rest * 1e3,
               images_per_s=rest * RESNET_B / (t2 - t1),
               first_step_ms=(t1 - t0) * 1e3,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               allocated_at_start=start, launches=launches,
               spmd_ms_per_step=spmd_row["ms_per_step"],
               spmd_images_per_s=spmd_row["images_per_s"])
    row["host_cost_ms"] = row["ms_per_step"] - row["spmd_ms_per_step"]
    print(f"gluon resnet: resnet50_v1 NHWC bf16 through gluon.Trainer, "
          f"B={RESNET_B} 224x224, {GLUON_RESNET_STEPS} SGD steps; losses "
          f"{[round(v, 4) for v in losses]}", flush=True)
    print(f"gluon resnet: images/s={row['images_per_s']:.2f} ms/step="
          f"{row['ms_per_step']:.3f} (steps 2-{GLUON_RESNET_STEPS}; first "
          f"step {row['first_step_ms']:.3f} ms) beside SPMDTrainer "
          f"{row['spmd_ms_per_step']:.3f} ms/step "
          f"({row['spmd_images_per_s']:.2f} images/s, phase 14): the Gluon "
          f"layer's host cost {row['host_cost_ms']:.3f} ms a step; "
          f"max_memory_allocated={row['max_memory_allocated']} "
          f"({row['max_memory_allocated'] - start} above the phase's start) "
          f"launches {launches}", flush=True)
    row.update(_gluon_witness(
        "gluon resnet", init_state, False, losses,
        [p.data()._data.clone() for p in net.collect_params().values()]))
    expect = K6_PER_STEP * GLUON_RESNET_STEPS
    if launches["conv1x1_bwd"] != expect:
        fail(f"gluon resnet: K6 launched {launches['conv1x1_bwd']} times, "
             f"expected {expect}")
    if any(n for k, n in launches.items() if k != "conv1x1_bwd"):
        fail(f"gluon resnet: other kernels launched: {launches}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"gluon resnet: losses not finite: {losses}")
    if abs(losses[0] - math.log(1000)) > 1.0:
        fail(f"gluon resnet: first loss {losses[0]} is not within 1.0 of "
             "ln(1000)")
    if not losses[-1] < losses[0]:
        fail(f"gluon resnet: loss did not fall: {losses}")
    # save, load into a fresh net on the card, infer on both
    path = os.path.join(HERE, "build", "gluon_resnet50.params")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    net.save_parameters(path)
    twin = _gluon_resnet50(mx)
    twin.load_parameters(path, ctx=mx.gpu(0))
    os.remove(path)

    def stats(m):
        return [p.data()._data.clone() for k, p in
                m._collect_params_with_prefix().items() if "running" in k]

    before = stats(net)
    out = [m(x)._data for m in (net, twin)]
    moved = any(not torch.equal(a, b) for a, b in zip(before, stats(net)))
    same_params = all(torch.equal(p.data()._data, q.data()._data)
                      for p, q in zip(net.collect_params().values(),
                                      twin.collect_params().values()))
    row["round_trip_equal"] = bool(torch.equal(out[0], out[1]))
    print(f"gluon resnet: save_parameters -> load_parameters(ctx=gpu(0)): "
          f"parameters equal {same_params}, inference logits equal bit for "
          f"bit {row['round_trip_equal']}, running statistics moved by the "
          f"inference forward {moved}", flush=True)
    if not (same_params and row["round_trip_equal"]) or moved:
        fail("gluon resnet: the save/load round trip or the inference "
             "forward is wrong")
    del net, twin, trainer, out, before
    torch.cuda.empty_cache()
    return row


def _gluon_small(mx, ctx):
    from mxnet_tpu_torch.gluon.model_zoo.vision import (BottleneckV1,
                                                        ResNetV1)
    with ctx:
        return ResNetV1(BottleneckV1, [1, 1, 1, 1], [16, 32, 64, 128, 256],
                        classes=10, thumbnail=True, layout="NHWC")


def gluon_vs_cpu():
    """One f32 SGD step of a small bottleneck ResNet built with deferred
    BatchNorms, through the Gluon loop, on the card (K6, TF32 off) and on
    the CPU, its weights carried by ``save_parameters``: the loss and
    every updated parameter (running statistics included) within 1e-5 of
    the array's largest magnitude, every gradient by structural name
    within ``GLUON_GRAD_TOL``."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.ops import conv_fused as cf

    os.environ["MXNET_FUSED_CONV_BWD"] = "1"
    rs = np.random.RandomState(17)
    xa = rs.rand(8, 3, 32, 32).astype(np.float32)
    ya = rs.randint(0, 10, 8).astype(np.float32)
    mx.random.seed(3)
    cpu = _gluon_small(mx, mx.cpu())
    cpu.initialize(mx.init.Xavier(magnitude=3), ctx=mx.cpu())
    cpu(mx.nd.array(xa, ctx=mx.cpu()))      # the deferred shapes
    path = os.path.join(HERE, "build", "gluon_small.params")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    cpu.save_parameters(path)
    card = _gluon_small(mx, mx.gpu(0))
    card.load_parameters(path, ctx=mx.gpu(0))
    cpu64 = _gluon_small(mx, mx.cpu())      # the yardstick of both
    cpu64.load_parameters(path, ctx=mx.cpu())
    cpu64.cast("float64")
    os.remove(path)
    res = {}
    cf.conv1x1_bwd_pair.launches = 0
    for name, net, ctx in (("card", card, mx.gpu(0)), ("cpu", cpu, mx.cpu()),
                           ("cpu64", cpu64, mx.cpu())):
        dt = "float64" if name == "cpu64" else "float32"
        x, y = (mx.nd.array(a, ctx=ctx, dtype=dt) for a in (xa, ya))
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                dict(RESNET_OPT))
        with autograd.record():
            loss = gluon.loss.SoftmaxCrossEntropyLoss()(net(x), y)
        loss.backward()
        params = net._collect_params_with_prefix()
        grads = {k: p.grad().asnumpy() for k, p in params.items()
                 if p.grad_req != "null"}
        trainer.step(8)
        res[name] = dict(loss=loss.asnumpy(), grads=grads,
                         after={k: p.data().asnumpy()
                                for k, p in params.items()})
    launches = cf.conv1x1_bwd_pair.launches

    def worst(what, side="card", ref_side="cpu"):
        """The three largest errors, each over its array's largest
        magnitude, with the arrays' structural names."""
        got, ref = res[side][what], res[ref_side][what]
        net_scale = max(float(np.abs(a).max()) for a in ref.values())
        errs = []
        for k, r in ref.items():
            scale = net_scale if k.endswith(GLUON_NOISE) else \
                max(float(np.abs(r).max()), 1e-30)
            errs.append((float(np.abs(got[k] - r).max()) / scale, k))
        return sorted(errs, reverse=True)[:3]

    grads, after = worst("grads"), worst("after")
    vs64 = {side: worst("grads", side, "cpu64")[0] for side in ("card", "cpu")}
    row = dict(loss_card=res["card"]["loss"].tolist(),
               loss_cpu=res["cpu"]["loss"].tolist(),
               loss_rel=float(np.abs(res["card"]["loss"] - res["cpu"]["loss"])
                              .max() / np.abs(res["cpu"]["loss"]).max()),
               grad_rel=grads[0][0], param_rel=after[0][0],
               worst_grads=grads, worst_params=after,
               grads_vs_float64=vs64, launches=launches)
    print(f"gluon vs cpu: small bottleneck v1, deferred BatchNorm, f32 SGD "
          f"step through gluon.Trainer: loss {row['loss_rel']:.3e}, "
          f"updated parameters {row['param_rel']:.3e} (tol {GLUON_TOL}), "
          f"gradients {row['grad_rel']:.3e} (tol {GLUON_GRAD_TOL}) of each "
          f"array's largest magnitude; K6 launches {launches} (expected "
          f"6); worst "
          f"gradients {[(f'{e:.3e}', k) for e, k in grads]}, parameters "
          f"{[(f'{e:.3e}', k) for e, k in after]}; worst gradient against "
          f"the CPU's float64 step: card {vs64['card'][0]:.3e} "
          f"({vs64['card'][1]}), CPU f32 {vs64['cpu'][0]:.3e} "
          f"({vs64['cpu'][1]})", flush=True)
    if launches != 6:
        fail(f"gluon vs cpu: K6 launched {launches} times, expected 6")
    if max(row["loss_rel"], row["param_rel"]) > GLUON_TOL or \
            row["grad_rel"] > GLUON_GRAD_TOL:
        fail("the card's Gluon step disagrees with the CPU's")
    return row


def check_gluon(spmd_row):
    return dict(headline=gluon_headline(), resnet=gluon_resnet(spmd_row),
                vs_cpu=gluon_vs_cpu())


# --------------------------------------------------------------------------- #
# phase 17: K7 (rtc.CudaModule) and the imperative core, the fifth slice
# --------------------------------------------------------------------------- #

# GPT-2 small's MLP width at 8 x 1024 tokens
MLP_ROWS, MLP_UNITS, MLP_HIDDEN = 8 * 1024, 768, 3072
MLP_STEPS, MLP_LR = 10, 10.0
# operations a value, for the bound (f32 math on the CUDA cores, tanh and
# exp counted as one): gelu 9, its derivative 16, softmax 5, addmul 2
RTC_OPS = {"gelu_fwd": 9, "gelu_bwd": 16, "softmax_rows": 5, "addmul": 2}


@functools.lru_cache(maxsize=None)
def _rtc_sources():
    """The user kernels and their plain versions (``tests/
    _torch_rtc_sources.py``, plain strings and functions, no imports),
    loaded from its path once; ``tests/`` stays off ``sys.path``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_torch_rtc_sources",
        os.path.join(HERE, "tests", "_torch_rtc_sources.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rtc_case(name, k, args, grid, outs, plain, library, nbytes, n,
              shared_mem=0):
    """One user kernel at the path's shape: its error against the plain
    version, element by element in units of ``err_units``'s tolerance (1e-6
    of the output's largest magnitude, plus for bf16 one bf16 step of the
    element's own magnitude; at most 1 passes), and kernel / plain /
    library / bound times; kernel and library also by ``cuda_ms_queued``
    (the device's share, the host out of the way)."""
    import mxnet_tpu_torch as mx
    import torch

    nd = [mx.nd.from_torch(a) if isinstance(a, torch.Tensor) else a
          for a in args]

    def launch(i=0):
        k.launch(nd, mx.gpu(0), grid, (256, 1, 1), shared_mem=shared_mem)

    launch()
    ref = plain()
    torch.cuda.synchronize()
    out = outs()
    err = (out.float() - ref.float()).abs().max().item()
    units = _rtc_sources().err_units(out, ref)
    if not torch.isfinite(out.float()).all() or units > 1:
        fail(f"rtc {name}: max_abs_err {err}, {units:.3f} of the tolerance "
             "at the worst element")
    ms = cuda_ms(launch, 20)
    queued = cuda_ms_queued(launch, 20)
    plain_ms = cuda_ms(lambda i: plain(), 10)
    lib = cuda_ms(lambda i: library(), 20)
    lib_queued = cuda_ms_queued(lambda i: library(), 20)
    bms, by = bound_ms(nbytes, RTC_OPS[name.split("<")[0]] * n,
                       F32_OPS_PER_S)
    print(f"rtc {name} n={n}: max_abs_err={err:.3e} ({units:.3f} of the "
          f"tolerance at the worst element) "
          f"kernel_ms={ms:.5f} queued_ms={queued:.5f} bound_ms={bms:.5f} "
          f"({by}) plain_ms={plain_ms:.5f} library_ms={lib:.5f} "
          f"library_queued_ms={lib_queued:.5f}", flush=True)
    return dict(name=name, n=n, max_abs_err=err, err_units=units, ms=ms,
                queued_ms=queued, plain_ms=plain_ms, library_ms=lib,
                library_queued_ms=lib_queued, bound_ms=bms, bound_by=by,
                bytes=nbytes)


def host_us(fn, iters=200, reps=5):
    """Host microseconds of one ``fn()``: the median of ``reps`` runs of
    ``iters`` calls enqueued with no synchronisation between them (fewer
    than the launch queue holds, so the host does not wait for the
    card)."""
    import torch

    fn()
    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        runs.append((time.perf_counter() - t0) / iters * 1e6)
    torch.cuda.synchronize()
    return sorted(runs)[reps // 2]


def rtc_gelu_cases(mod, gen):
    """``gelu_fwd`` and ``gelu_bwd`` in bf16 and f32 at the MLP path's
    8192 x 3072 through ``_rtc_case``; the library calls are
    ``F.gelu(approximate="tanh")`` and ``aten.gelu_backward``."""
    import torch
    import torch.nn.functional as F

    S = _rtc_sources()
    n = MLP_ROWS * MLP_HIDDEN
    cases = []
    for dt in (torch.bfloat16, torch.float32):
        ct = S.CTYPES[str(dt)]
        x = torch.randn(n, generator=gen, device="cuda").to(dt)
        dy = torch.randn(n, generator=gen, device="cuda").to(dt)
        y, dx = torch.empty_like(x), torch.empty_like(x)
        grid = S.elementwise_grid(n, x.element_size())
        el = x.element_size()
        fwd, bwd = (mod.get_kernel(f"{name}<{ct}>",
                                   S.SIGNATURES[name].format(T=ct))
                    for name in ("gelu_fwd", "gelu_bwd"))
        cases.append(_rtc_case(
            f"gelu_fwd<{ct}>", fwd, [x, y, n], grid, lambda: y,
            lambda: S.gelu_fwd_plain(x),
            lambda: F.gelu(x, approximate="tanh"), 2 * n * el, n))
        cases.append(_rtc_case(
            f"gelu_bwd<{ct}>", bwd, [x, dy, dx, n], grid, lambda: dx,
            lambda: S.gelu_bwd_plain(x, dy),
            lambda: torch.ops.aten.gelu_backward(dy, x, approximate="tanh"),
            3 * n * el, n))
        del x, dy, y, dx
    return cases


def check_rtc():
    """NVRTC compile of the user-kernel module, cold (the cache entry
    removed first) and cached; each user kernel against its plain version
    and timed beside its bound, its plain version and the PyTorch call of
    the same function (a yardstick only: ``F.gelu(approximate="tanh")``,
    its backward ``aten.gelu_backward``, ``torch.softmax``, ``torch.add(y,
    x, alpha=2)``), kernel and library also by ``cuda_ms_queued``; the
    refusal of shared memory past 227 KB; K7's own cost
    (``rtc_launch_costs``: host microseconds a ``launch`` of a tiny
    ``addmul``, its parts, the host floor and one ``torch.add``); and one
    launch recorded into a CUDA graph and replayed bit for bit
    (``rtc_graph_replay``)."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import rtc

    S = _rtc_sources()
    key = rtc.cache_key(S.SOURCE, (), S.EXPORTS)
    for suffix in (".cubin", ".json"):
        (rtc.BUILD_DIR / f"{key}{suffix}").unlink(missing_ok=True)
    t0 = time.perf_counter()
    mod = rtc.CudaModule(S.SOURCE, exports=S.EXPORTS)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = rtc.CudaModule(S.SOURCE, exports=S.EXPORTS)
    cached = time.perf_counter() - t0
    if mod.cached or not again.cached:
        fail("rtc: the CUBIN cache did not behave (cold compile expected, "
             "then a cached one)")
    lib_path = rtc._libs["nvrtc"][0]._name
    print(f"rtc: NVRTC {lib_path} compiled the user-kernel module "
          f"({len(S.SOURCE)} bytes, {len(S.EXPORTS)} exports, {rtc.ARCH}) "
          f"in {mod.compile_seconds:.3f} s ({cold:.3f} s with the load); "
          f"from the cache in {cached:.4f} s", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(16)
    n = MLP_ROWS * MLP_HIDDEN
    cases = rtc_gelu_cases(mod, gen)

    def kernel(name):
        return name, mod.get_kernel(name, S.SIGNATURES[name])

    rows, cols, rpb = MLP_ROWS, MLP_HIDDEN, S.SOFTMAX_ROWS_PER_BLOCK
    xs = torch.randn(rows, cols, generator=gen,
                     device="cuda").to(torch.bfloat16)
    ys = torch.empty_like(xs)
    name, k = kernel("softmax_rows")
    cases.append(_rtc_case(
        name, k, [xs, ys, rows, cols, rpb], (-(-rows // rpb), 1, 1),
        lambda: ys, lambda: S.softmax_rows_plain(xs),
        lambda: torch.softmax(xs, -1), 2 * rows * cols * 2, rows * cols,
        shared_mem=rpb * cols * 4))
    try:
        k.launch([mx.nd.from_torch(xs), mx.nd.from_torch(ys), rows, cols,
                  19], mx.gpu(0), (-(-rows // 19), 1, 1), (256, 1, 1),
                 shared_mem=19 * cols * 4)
    except mx.MXNetError as e:
        print(f"rtc softmax_rows: {19 * cols * 4} bytes of shared memory "
              f"refused before launching ({e})", flush=True)
    else:
        fail("rtc: a launch past 227 KB of shared memory was not refused")
    del xs, ys
    a = torch.randn(n, generator=gen, device="cuda")
    b = torch.randn(n, generator=gen, device="cuda")
    o = torch.empty_like(a)
    name, k = kernel("addmul")
    cases.append(_rtc_case(
        name, k, [a, b, o, n], S.elementwise_grid(n, 4),
        lambda: o, lambda: S.addmul_plain(a, b),
        lambda: torch.add(b, a, alpha=2.0), 3 * n * 4, n))
    del a, b, o
    torch.cuda.empty_cache()
    costs = rtc_launch_costs(mod)
    graph = rtc_graph_replay(mod)
    if not graph["bitwise_equal"] or graph["captured_launches"] != 1 \
            or graph["replay_launches"] != 0:
        fail(f"rtc graph: {graph}")
    return dict(compile_s=mod.compile_seconds, compile_and_load_s=cold,
                cached_s=cached, nvrtc=lib_path, cases=cases, graph=graph,
                **costs)


def rtc_launch_costs(mod):
    """K7's own cost, in host microseconds (``host_us``) at a size where
    the card idles (``addmul``, 256 values, one block): a
    ``CudaKernel.launch``; one ``torch.add`` of the same function (the
    library column); the host floor, a bare ``cuLaunchKernel`` of the same
    function from Python with its ``void*`` array packed once (the bound
    column); the parent commit's launch path split into the parts it runs
    each time, timed through the plain functions it calls
    (``check_launch``, ``pack_args``, the ``torch.cuda.device`` guard,
    ``torch.cuda.current_stream(i).cuda_stream``, the ``cuLaunchKernel``
    call as it makes it); and, where the package has launch plans, the
    plan path's parts (the plan lookup, ``LaunchPlan.pack``, the current
    card, the raw stream, the ``rtc_launch`` call of ``csrc/
    rtc_launch.cu``)."""
    import ctypes

    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import rtc

    S = _rtc_sources()
    k = mod.get_kernel("addmul", S.SIGNATURES["addmul"])
    n = 256
    gen = torch.Generator(device="cuda").manual_seed(9)
    a = torch.randn(n, generator=gen, device="cuda")
    b = torch.randn(n, generator=gen, device="cuda")
    o = torch.empty_like(a)
    args = [mx.nd.from_torch(t) for t in (a, b, o)] + [n]
    ctx, grid, block = mx.gpu(0), (1, 1, 1), (256, 1, 1)
    k.launch(args, ctx, grid, block)
    torch.cuda.synchronize()
    if not torch.equal(o, S.addmul_plain(a, b)):
        fail("rtc addmul at 256 values differs from its plain version")
    launch_us = host_us(lambda: k.launch(args, ctx, grid, block))
    torch_us = host_us(lambda: torch.add(b, a, alpha=2.0, out=o))
    lib, fn, specs = rtc._cuda(), k._function(0), k._specs
    holders, params = rtc.pack_args(specs, args)
    stream = torch.cuda.current_stream(0).cuda_stream

    def guard():
        with torch.cuda.device(0):
            pass

    def parent_call():
        rtc._cu_check(lib, lib.cuLaunchKernel(
            fn, *grid, *block, 0, ctypes.c_void_p(stream), params, None),
            f"cuLaunchKernel({k.name})")

    parts = dict(
        check_launch=host_us(
            lambda: rtc.check_launch(specs, args, ctx, grid, block, 0)),
        pack_args=host_us(lambda: rtc.pack_args(specs, args)),
        device_guard=host_us(guard),
        stream_lookup=host_us(
            lambda: torch.cuda.current_stream(0).cuda_stream),
        cuLaunchKernel=host_us(parent_call))
    floor_us = host_us(lambda: lib.cuLaunchKernel(
        fn, *grid, *block, 0, stream, params, None))
    print("rtc launch parts: parent path " + ", ".join(
        f"{p} {us:.3f}" for p, us in parts.items()) +
        f" us (sum {sum(parts.values()):.3f})", flush=True)
    plan_parts = None
    if hasattr(rtc, "LaunchPlan"):
        raw, cur = torch._C._cuda_getCurrentRawStream, torch._C._cuda_getDevice
        if raw(0) != stream:
            fail("rtc: the raw current stream is not torch.cuda."
                 "current_stream(0).cuda_stream")
        key = (ctx, grid, block, 0)
        plan = k._plans[key]
        record = plan.pack(args)[1]
        plan_parts = dict(
            plan_lookup=host_us(lambda: k._plans[key]),
            pack=host_us(lambda: plan.pack(args)),
            current_card=host_us(cur),
            raw_stream=host_us(lambda: raw(0)),
            rtc_launch=host_us(lambda: plan.call(record, stream)))
        print("rtc launch parts: plan path " + ", ".join(
            f"{p} {us:.3f}" for p, us in plan_parts.items()) +
            f" us (sum {sum(plan_parts.values()):.3f})", flush=True)
    torch.cuda.synchronize()
    print(f"rtc launch overhead: {launch_us:.3f} us of host time a "
          f"CudaKernel.launch (addmul, 256 values) against {torch_us:.3f} "
          f"us a torch.add; host floor {floor_us:.3f} us (a bare "
          f"cuLaunchKernel from Python, arguments packed once)", flush=True)
    del holders
    return dict(launch_us=launch_us, torch_launch_us=torch_us,
                host_floor_us=floor_us, launch_parts=parts,
                plan_parts=plan_parts)


def rtc_graph_replay(mod):
    """One ``gelu_fwd<__nv_bfloat16>`` launch at the path's 8192 x 3072
    recorded into a CUDA graph (``torch.cuda.graph``) after an eager
    launch of the same signature: the replay's output against the eager
    launch's, bit for bit; the capture counts as one launch, the replay
    as none."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.block import _no_collection

    S = _rtc_sources()
    ct = "__nv_bfloat16"
    k = mod.get_kernel(f"gelu_fwd<{ct}>",
                       S.SIGNATURES["gelu_fwd"].format(T=ct))
    n = MLP_ROWS * MLP_HIDDEN
    gen = torch.Generator(device="cuda").manual_seed(17)
    x = torch.randn(n, generator=gen, device="cuda").bfloat16()
    eager, replayed = torch.empty_like(x), torch.empty_like(x)
    grid, block = S.elementwise_grid(n, 2), (S.THREADS, 1, 1)

    def launch(out):
        k.launch([mx.nd.from_torch(x), mx.nd.from_torch(out), n],
                 mx.gpu(0), grid, block)

    launch(eager)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    before = k.launches
    with _no_collection(), torch.cuda.graph(g):
        launch(replayed)
    captured = k.launches - before
    replayed.fill_(float("nan"))
    g.replay()
    torch.cuda.synchronize()
    res = dict(captured_launches=captured,
               replay_launches=k.launches - before - captured,
               bitwise_equal=bool(torch.equal(eager.view(torch.int16),
                                              replayed.view(torch.int16))))
    print(f"rtc graph: gelu_fwd<{ct}> n={n} recorded into a CUDA graph "
          f"({res['captured_launches']} launch counted at capture, "
          f"{res['replay_launches']} at replay); replay equals the eager "
          f"launch bit for bit: {res['bitwise_equal']}", flush=True)
    del g, x, eager, replayed
    torch.cuda.empty_cache()
    return res


def _mlp_data(rows, dtype, ctx):
    """The MLP block's arrays from a seeded numpy Normal(0.02) (x, w1,
    w2; zero biases) and a fixed random target (a per-column mean plus
    0.1 noise), made on ``ctx`` in ``dtype``."""
    import numpy as np
    import mxnet_tpu_torch as mx

    rs = np.random.RandomState(5)
    arrs = dict(x=rs.normal(0, 0.02, (rows, MLP_UNITS)),
                w1=rs.normal(0, 0.02, (MLP_UNITS, MLP_HIDDEN)),
                b1=np.zeros(MLP_HIDDEN),
                w2=rs.normal(0, 0.02, (MLP_HIDDEN, MLP_UNITS)),
                b2=np.zeros(MLP_UNITS))
    arrs["t"] = rs.normal(0, 1, (1, MLP_UNITS)) + \
        0.1 * rs.normal(0, 1, (rows, MLP_UNITS))
    return {k: mx.nd.array(v, ctx=ctx, dtype=dtype) for k, v in arrs.items()}


def _mlp_step(mx, p):
    """One step of the slice's path: forward under ``autograd.record()``,
    ``backward``, SGD through in-place ``NDArray`` updates."""
    with mx.autograd.record():
        h = mx.nd.dot(p["x"], p["w1"]) + p["b1"]
        a = mx.nd.Custom(h, op_type="rtc_gelu")
        y = mx.nd.dot(a, p["w2"]) + p["b2"]
        loss = mx.nd.mean(mx.nd.square(y - p["t"]))
    loss.backward()
    for k in ("w1", "b1", "w2", "b2"):
        p[k] -= MLP_LR * p[k].grad
    return loss


def check_imperative_mlp(op):
    """The fifth slice's path at GPT-2 small's MLP width, bf16 on
    ``mx.gpu(0)``: 10 steps, ``rtc`` launched exactly twice a step (the
    custom op's ``gelu_fwd`` and ``gelu_bwd``); losses finite and falling;
    ms a step, rows/s and peak memory above the phase's start; the steps
    leave nothing for the cyclic collector (it frees less than one ``h``
    afterwards); then three profiled steps, device time a step split into
    GEMMs, the rtc kernels and the rest."""
    import gc
    import math

    import torch
    import mxnet_tpu_torch as mx

    p = _mlp_data(MLP_ROWS, "bfloat16", mx.gpu(0))
    for k in ("w1", "b1", "w2", "b2"):
        p[k].attach_grad()
    for name in ("gelu_fwd", "gelu_bwd"):     # compiled before the run
        op.kernel(name, "__nv_bfloat16")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    for k in op.kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    losses = [_mlp_step(mx, p)]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    losses += [_mlp_step(mx, p) for _ in range(MLP_STEPS - 1)]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = op.launches()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v.asnumpy()[0]) for v in losses]
    held = torch.cuda.memory_allocated()
    gc.collect()
    cyclic = held - torch.cuda.memory_allocated()
    step_ms = (t2 - t1) / (MLP_STEPS - 1) * 1e3
    rows_s = MLP_ROWS * (MLP_STEPS - 1) / (t2 - t1)
    print(f"mlp: imperative MLP block {MLP_ROWS} x {MLP_UNITS} -> "
          f"{MLP_HIDDEN} -> {MLP_UNITS} bf16 on mx.gpu(0), GELU as the "
          f"rtc_gelu custom op, SGD lr {MLP_LR}, {MLP_STEPS} steps; losses "
          f"{[round(v, 6) for v in losses]}", flush=True)
    print(f"mlp: ms/step={step_ms:.3f} rows/s={rows_s:.1f} (steps 2-"
          f"{MLP_STEPS}; first step {(t1 - t0) * 1e3:.3f} ms) "
          f"max_memory_allocated={peak} ({peak - start} above the phase's "
          f"start) rtc launches {launches} (expected {2 * MLP_STEPS}); "
          f"the cyclic collector then freed {cyclic} bytes", flush=True)
    if cyclic >= MLP_ROWS * MLP_HIDDEN * 2:
        fail(f"mlp: {cyclic} bytes of the steps' buffers waited for the "
             "cyclic collector")
    if launches != 2 * MLP_STEPS:
        fail(f"mlp: rtc launched {launches} times, expected "
             f"{2 * MLP_STEPS}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"mlp: losses not finite: {losses}")
    if not (losses[-1] < losses[0] and
            all(b <= a for a, b in zip(losses, losses[1:]))):
        fail(f"mlp: losses did not fall: {losses}")
    n_prof = 3
    by_name, busy, wall_us = _profiled(
        lambda: [_mlp_step(mx, p) for _ in range(n_prof)])
    prof = report_profile("mlp profile", by_name, busy, wall_us, top=10)
    groups = {"rtc kernels": ("gelu_",),
              "GEMMs": ("gemm", "gemv", "xmma", "cutlass", "nvjet",
                        "sm90_")}
    shares = {g: sum(us for n, us in by_name.items()
                     if any(k in n for k in keys))
              for g, keys in groups.items()}
    shares["other"] = busy - sum(shares.values())
    if busy > 0:
        print("mlp profile: by group " + ", ".join(
            f"{g} {us / busy:.4f} ({us / n_prof / 1e3:.3f} ms/step)"
            for g, us in shares.items()), flush=True)
    prof["groups_us"] = shares
    del p
    torch.cuda.empty_cache()
    return dict(losses=losses, ms_per_step=step_ms, rows_per_s=rows_s,
                first_step_ms=(t1 - t0) * 1e3, max_memory_allocated=peak,
                memory_above_start=peak - start, cyclic_bytes=cyclic,
                launches=launches,
                profile=prof)


def check_imperative_vs_cpu():
    """One f32 step of the same path at 256 rows (TF32 off) on the card
    (the rtc kernels, f32 instantiations) and on the CPU (the custom op's
    plain branch), from the same arrays: loss within 1e-5 relative,
    updated weights within 1e-5 of their magnitude."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx

    rows = 256
    res = {}
    for ctx in (mx.gpu(0), mx.cpu()):
        p = _mlp_data(rows, "float32", ctx)
        for k in ("w1", "b1", "w2", "b2"):
            p[k].attach_grad()
        loss = _mlp_step(mx, p)
        res[ctx.device_type] = (float(loss.asnumpy()[0]),
                                {k: p[k].asnumpy() for k in
                                 ("w1", "b1", "w2", "b2")})
    (lg, wg), (lc, wc) = res["gpu"], res["cpu"]
    rel = abs(lg - lc) / abs(lc)
    worst = max(float(np.abs(wg[k] - wc[k]).max() /
                      max(np.abs(wc[k]).max(), 1.0)) for k in wg)
    print(f"mlp vs cpu: f32 step at {rows} rows, loss card {lg:.7f} cpu "
          f"{lc:.7f} (rel {rel:.3e}, tol 1e-5); weights max diff "
          f"{worst:.3e} of magnitude (tol 1e-5)", flush=True)
    if rel > 1e-5 or worst > 1e-5:
        fail("mlp vs cpu: the card's f32 step disagrees with the CPU's")
    torch.cuda.empty_cache()
    return dict(loss_card=lg, loss_cpu=lc, loss_rel=rel, weights_rel=worst)


# --------------------------------------------------------------------------- #
# phase 18: the fused train step and hybridize() as CUDA graphs, the eleventh
# slice
# --------------------------------------------------------------------------- #

FUSED_STEPS = 20            # ResNet-50 through Trainer.fused_step
HOST_PARTS = 9              # timings of each part of a fused call
FUSED_MLP_STEPS = 10        # the MLP block through both arms
FUSED_TOL = 1e-5            # f32 fused against phase by phase, of the
                            # array's largest magnitude
FUSED_LOSS_TOL = 1e-6       # relative


# kernel-node names of the path's kernels in a graph dump (K6's bf16 and
# f32 kernels, not its partial-sum kernel; K7's two GELU kernels)
GRAPH_KERNELS = {"conv1x1_bwd": r"conv1x1_bwd(_mma)?_kernel",
                 "gelu_fwd": r"gelu_fwd", "gelu_bwd": r"gelu_bwd"}


def _graph_nodes(prog, names):
    """The kernel nodes of a captured ``_GraphProgram``'s graph
    (``prog.kernel_nodes()``, from ``CUDAGraph.debug_dump``): ``{name:
    count}`` of the nodes whose kernel name matches
    ``GRAPH_KERNELS[name]`` for each of ``names``, and ``{kernel: count}``
    of all."""
    import re

    every = prog.kernel_nodes()
    if not every:
        fail("graph dump: no kernel node found")
    return {n: sum(c for k, c in every.items()
                   if re.search(GRAPH_KERNELS[n], k))
            for n in names}, every


def _print_nodes(what, every, top=12):
    ranked = sorted(every.items(), key=lambda kv: -kv[1])
    print(f"{what}: {sum(every.values())} kernel nodes, "
          f"{len(every)} kernels: " + ", ".join(
              f"{n} x{c}" for n, c in ranked[:top]), flush=True)


def fused_capture_checks(op):
    """18.1: one ResNet-50 1x1 convolution's forward and backward (K6 in
    the backward) and one ``rtc_gelu`` custom op's forward and backward
    (K7's ``gelu_fwd`` and ``gelu_bwd``), each as a ``_GraphProgram``:
    call 1 eager, call 2 captured and replayed, call 3 replayed; both
    replays equal the eager call bit for bit, and the graphs' kernel
    nodes by name."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.block import _GraphProgram
    from mxnet_tpu_torch.ops.conv_fused import conv1x1_nhwc

    gen = torch.Generator(device="cuda").manual_seed(23)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    x = rand(RESNET_B, 56, 56, 64).requires_grad_()
    w = (rand(256, 64, 1, 1) * 0.1).requires_grad_()
    dy = rand(RESNET_B, 56, 56, 256)

    def k6():
        y = conv1x1_nhwc(x, w)
        return [y, *torch.autograd.grad(y, (x, w), dy)]

    h = rand(MLP_ROWS, MLP_HIDDEN).requires_grad_()
    dh = rand(MLP_ROWS, MLP_HIDDEN)

    def k7():
        with mx.autograd.record():
            a = mx.nd.Custom(mx.nd.NDArray(h), op_type="rtc_gelu")
        return [a._data, *torch.autograd.grad(a._data, (h,), dh)]

    op.kernel("gelu_fwd", "__nv_bfloat16")
    op.kernel("gelu_bwd", "__nv_bfloat16")
    res = {}
    _GraphProgram.debug = True
    try:
        for name, fn, kernels, expect in (
                ("K6", k6, ("conv1x1_bwd",), {"conv1x1_bwd": 1}),
                ("K7", k7, ("gelu_fwd", "gelu_bwd"),
                 {"gelu_fwd": 1, "gelu_bwd": 1})):
            prog = _GraphProgram(fn, "cuda", None, [])
            eager = [t.clone() for t in prog()]
            first = prog()
            again = prog()
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) and torch.equal(a, c)
                       for a, b, c in zip(eager, first, again))
            counts, every = _graph_nodes(prog, kernels)
            _print_nodes(f"fused capture {name}", every)
            print(f"fused capture {name}: replays equal the eager call bit "
                  f"for bit: {same}; kernel nodes {counts} (expected "
                  f"{expect}); launches a replay {prog.launches}; capture "
                  f"{prog.capture_s:.3f} s", flush=True)
            if not same:
                fail(f"fused capture {name}: a replay differs from the "
                     "eager call")
            if counts != expect:
                fail(f"fused capture {name}: kernel nodes {counts}, "
                     f"expected {expect}")
            res[name] = dict(bitwise_equal=same, nodes=counts,
                             launches_a_replay=prog.launches,
                             capture_s=prog.capture_s)
            del prog, eager, first, again
    finally:
        _GraphProgram.debug = False
    del x, w, dy, h, dh
    torch.cuda.empty_cache()
    return res


def _apply_program(trainer):
    """The apply program of the trainer's one fused step."""
    (fs,) = trainer._fused_steps.values()
    progs = [p for k, p in fs._programs.items() if k[0] == "apply"]
    return fs, progs[0]


def fused_resnet(spmd_row, gluon_row):
    """18.2: ResNet-50 v1 (phase 16's net: ``get_model``, ``initialize(
    ctx=mx.gpu(0))``, ``cast("bfloat16")``, ``hybridize()``) through
    ``trainer.fused_step(loss_fn, data, label)`` with SGD (lr 0.1,
    momentum 0.9, wd 1e-4) on phase 14's batch, 20 steps with
    ``MXNET_FUSED_CONV_BWD=1``: the step graph holds exactly 30 K6 nodes;
    ``legacy_steps`` 0 and ``compiles`` 1 after step 2 and after step 20;
    losses finite, the first within 1.0 of ln(1000), falling.  ms a step
    (steps 3-20) beside phases 14 and 16 of this run, the capture's
    seconds, the host microseconds of a call, peak memory and its rise,
    and the device's busy share of one profiled replay."""
    import math

    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, random
    from mxnet_tpu_torch.gluon import fused_step as fsm
    from mxnet_tpu_torch.gluon.block import _GraphProgram
    from mxnet_tpu_torch.ops import conv_fused as cf

    os.environ["MXNET_FUSED_CONV_BWD"] = "1"
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    init_state = random.generator("cuda").get_state()
    net = _gluon_resnet50(mx)
    data, label = _resnet_batch()
    x, y = mx.nd.NDArray(data), mx.nd.NDArray(label)
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(RESNET_OPT))
    loss_l = gluon.loss.SoftmaxCrossEntropyLoss()

    def loss_fn(x, y):
        return loss_l(net(x), y)

    def step():
        return trainer.fused_step(loss_fn, x, y)._data.float().mean()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fsm.reset_step_counters()
    _reset_counts()
    cf.conv1x1_bwd_pair.launches = 0
    _GraphProgram.debug = True
    try:
        t0 = time.perf_counter()
        losses = [step()]                   # eager: deferred shapes, states
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses.append(step())               # capture, then replay
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    finally:
        _GraphProgram.debug = False
    compiles_2 = fsm.step_counters["compiles"]
    host = []
    for _ in range(FUSED_STEPS - 2):
        h0 = time.perf_counter()
        losses.append(step())
        host.append(time.perf_counter() - h0)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    after = [p.data()._data.clone() for p in net.collect_params().values()]
    counters = dict(fsm.step_counters)
    fs, prog = _apply_program(trainer)
    host_launches = cf.conv1x1_bwd_pair.launches
    # executed: the eager call's 30 and each replay's; the counter also
    # saw the capture, which runs nothing
    k6_runs = host_launches - prog.launches.get("conv1x1_bwd", 0) + \
        fs.launches().get("conv1x1_bwd", 0)
    peak = torch.cuda.max_memory_allocated()
    counts, every = _graph_nodes(prog, ("conv1x1_bwd",))
    _print_nodes("fused resnet graph", every)
    losses = [float(v) for v in losses]
    timed = FUSED_STEPS - 2
    row = dict(losses=losses, ms_per_step=(t3 - t2) / timed * 1e3,
               images_per_s=timed * RESNET_B / (t3 - t2),
               warmup_step_ms=(t1 - t0) * 1e3,
               capture_and_replay_ms=(t2 - t1) * 1e3,
               capture_s=prog.capture_s,
               host_us_in_flight=sorted(host)[len(host) // 2] * 1e6,
               max_memory_allocated=peak, allocated_at_start=start,
               memory_above_start=peak - start,
               gluon_max_memory_above_start=(
                   gluon_row["max_memory_allocated"] -
                   gluon_row["allocated_at_start"]) if gluon_row else None,
               step_counters=counters, compiles_after_step_2=compiles_2,
               k6_nodes=counts["conv1x1_bwd"],
               launches_a_replay=prog.launches,
               launches=dict(conv1x1_bwd=k6_runs),
               gluon_ms_per_step=gluon_row["ms_per_step"] if gluon_row
               else None,
               spmd_ms_per_step=spmd_row["ms_per_step"] if spmd_row
               else None)
    print(f"fused resnet: resnet50_v1 NHWC bf16 through "
          f"Trainer.fused_step, B={RESNET_B} 224x224, {FUSED_STEPS} SGD "
          f"steps; losses {[round(v, 4) for v in losses]}", flush=True)
    beside = ""
    if gluon_row and spmd_row:
        beside = (f" beside gluon.Trainer {row['gluon_ms_per_step']:.3f} "
                  f"(phase 16) and SPMDTrainer {row['spmd_ms_per_step']:.3f}"
                  f" ms/step (phase 14)")
    print(f"fused resnet: images/s={row['images_per_s']:.2f} ms/step="
          f"{row['ms_per_step']:.3f} (steps 3-{FUSED_STEPS}){beside}; "
          f"eager step {row['warmup_step_ms']:.3f} ms, capture+replay "
          f"{row['capture_and_replay_ms']:.3f} ms (capture "
          f"{row['capture_s']:.3f} s); host {row['host_us_in_flight']:.1f} "
          f"us a fused_step call of the timed loop (median of steps 3-"
          f"{FUSED_STEPS}); "
          f"max_memory_allocated={peak} "
          f"({row['memory_above_start']} above the phase's start; phase "
          f"16's gluon.Trainer arm {row['gluon_max_memory_above_start']})",
          flush=True)
    print(f"fused resnet: step_counters {counters} (compiles after step 2: "
          f"{compiles_2}); K6 nodes in the step graph {counts} (expected "
          f"{K6_PER_STEP}); launches a replay {prog.launches}; K6 ran "
          f"{k6_runs} times", flush=True)
    if counts["conv1x1_bwd"] != K6_PER_STEP:
        fail(f"fused resnet: {counts['conv1x1_bwd']} K6 nodes in the step "
             f"graph, expected {K6_PER_STEP}")
    if counters["legacy_steps"] or compiles_2 != 1 or \
            counters["compiles"] != 1 or \
            counters["apply_dispatches"] != FUSED_STEPS:
        fail(f"fused resnet: step counters {counters}, compiles after step "
             f"2: {compiles_2}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"fused resnet: losses not finite: {losses}")
    if abs(losses[0] - math.log(1000)) > 1.0:
        fail(f"fused resnet: first loss {losses[0]} is not within 1.0 of "
             "ln(1000)")
    # where the host's time of a call goes (more training steps, after
    # the checks), each part timed alone HOST_PARTS times: after a
    # synchronisation, and while the previous replay runs
    from mxnet_tpu_torch.optimizer.optimizer import _write

    torch.cuda.synchronize()
    hyper = fs._hyper.tolist()
    parts = {k: [] for k in ("call", "replay", "call_in_flight",
                             "replay_in_flight", "write_in_flight")}

    def timed(key, fn, behind):
        torch.cuda.synchronize()
        if behind:
            prog.graph.replay()
        h0 = time.perf_counter()
        fn()
        parts[key].append(time.perf_counter() - h0)

    for _ in range(HOST_PARTS):
        timed("call", lambda: trainer.fused_step(loss_fn, x, y), False)
        timed("replay", prog.graph.replay, False)
        timed("call_in_flight", lambda: trainer.fused_step(loss_fn, x, y),
              True)
        timed("replay_in_flight", prog.graph.replay, True)
        timed("write_in_flight", lambda: _write(fs._hyper, hyper), True)
    torch.cuda.synchronize()
    med = {k: sorted(v)[len(v) // 2] * 1e6 for k, v in parts.items()}
    row["host_us"] = med["call"]
    row["host_replay_us"] = med["replay"]
    row["host_parts_us"] = med
    print(f"fused resnet: host us, medians of {HOST_PARTS}: after a "
          f"synchronisation a fused_step call {med['call']:.1f}, its "
          f"graph's replay alone {med['replay']:.1f} "
          f"({sum(every.values())} kernel nodes); behind a running replay "
          f"a fused_step call {med['call_in_flight']:.1f}, the replay alone "
          f"{med['replay_in_flight']:.1f}, the hyperparameter write alone "
          f"{med['write_in_flight']:.1f}; a timed step's call (steps "
          f"3-{FUSED_STEPS}, with the loss's mean) "
          f"{row['host_us_in_flight']:.1f}", flush=True)
    by_name, busy, wall_us = _profiled(step)
    row["profile"] = report_profile("fused resnet profile", by_name, busy,
                                    wall_us, top=10)
    trainer._fused_steps.clear()
    del fs, prog, trainer, net, x, y, data, label
    torch.cuda.empty_cache()
    # last: a new net moves the storage generation, which drops every
    # fused step's programs
    row.update(_gluon_witness("fused resnet", init_state, True, losses,
                              after))
    del after
    if not losses[-1] < losses[0]:
        fail(f"fused resnet: loss did not fall: {losses}")
    return row


def _small_pair(mx, n=2):
    """``n`` copies on the card of phase 16's small bottleneck ResNet
    (f32), one set of Xavier weights made on the CPU and carried by
    ``save_parameters``, and phase 16's batch."""
    import numpy as np

    rs = np.random.RandomState(17)
    xa = rs.rand(8, 3, 32, 32).astype(np.float32)
    ya = rs.randint(0, 10, 8).astype(np.float32)
    mx.random.seed(3)
    cpu = _gluon_small(mx, mx.cpu())
    cpu.initialize(mx.init.Xavier(magnitude=3), ctx=mx.cpu())
    cpu(mx.nd.array(xa, ctx=mx.cpu()))
    path = os.path.join(HERE, "build", "fused_small.params")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    cpu.save_parameters(path)
    nets = []
    for _ in range(n):
        net = _gluon_small(mx, mx.gpu(0))
        net.load_parameters(path, ctx=mx.gpu(0))
        nets.append(net)
    os.remove(path)
    x, y = (mx.nd.array(a, ctx=mx.gpu(0)) for a in (xa, ya))
    return nets, x, y


def _worst(a_net, b_net, trained_only=False):
    """The largest difference of two nets' parameters over each array's
    largest magnitude, with its structural name."""
    import torch

    a = a_net._collect_params_with_prefix()
    b = b_net._collect_params_with_prefix()
    errs = []
    for k, p in a.items():
        if trained_only and p.grad_req == "null":
            continue
        u, v = p.data()._data.float(), b[k].data()._data.float()
        scale = max(float(v.abs().max()), 1e-30)
        errs.append((float((u - v).abs().max()) / scale, k))
    return max(errs)


def _phase_step(mx, trainer, loss_fn, x, y):
    with mx.autograd.record():
        loss = loss_fn(x, y)
    loss.backward()
    trainer.step(x.shape[0])
    return loss


def fused_small_checks():
    """18.3, 18.4 and 18.8 on phase 16's small bottleneck ResNet in f32
    (TF32 off, cuDNN deterministic, K6 on both sides).  18.3: three
    fused steps (eager, capture and replay, replay) against three
    phase-by-phase steps from the same weights: losses within 1e-6
    relative, every parameter (running statistics included) within 1e-5
    of its largest magnitude.  18.4: six fused steps under
    ``CosineScheduler(max_update=6, base_lr=0.1, warmup_steps=2)`` against
    six phase-by-phase steps under the same schedule, within 1e-5, one
    capture; then on a trainer without a schedule, ``set_learning_rate(
    0.0)`` freezes the next replay's update (SGD without momentum), with
    no capture.  18.8: ``MXNET_FUSED_STEP=0``: one step through
    ``fused_step`` equals the phase-by-phase step bit for bit,
    ``legacy_steps`` 1."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon import fused_step as fsm
    from mxnet_tpu_torch.optimizer import CosineScheduler

    os.environ["MXNET_FUSED_CONV_BWD"] = "1"
    torch.backends.cudnn.deterministic = True
    loss_l = gluon.loss.SoftmaxCrossEntropyLoss()

    def lf(net):
        return lambda a, b: loss_l(net(a), b)

    res = {}
    try:
        # 18.3
        (fused, phased), x, y = _small_pair(mx)
        tf = gluon.Trainer(fused.collect_params(), "sgd", dict(RESNET_OPT))
        tp = gluon.Trainer(phased.collect_params(), "sgd", dict(RESNET_OPT))
        fsm.reset_step_counters()
        lf_f, lf_p = lf(fused), lf(phased)
        lossf = [tf.fused_step(lf_f, x, y).asnumpy() for _ in range(3)]
        lossp = [_phase_step(mx, tp, lf_p, x, y).asnumpy()
                 for _ in range(3)]
        loss_rel = max(float(np.abs(a - b).max() / np.abs(b).max())
                       for a, b in zip(lossf, lossp))
        err, where = _worst(fused, phased)
        counters = dict(fsm.step_counters)
        res["f32"] = dict(loss_rel=loss_rel, param_rel=err, worst=where,
                          step_counters=counters)
        print(f"fused f32: small bottleneck v1, 3 fused steps (eager, "
              f"capture+replay, replay) against 3 phase-by-phase: losses "
              f"{loss_rel:.3e} relative (tol {FUSED_LOSS_TOL}), parameters "
              f"and running statistics {err:.3e} of the largest magnitude "
              f"(tol {FUSED_TOL}, worst {where}); step_counters {counters}",
              flush=True)
        if loss_rel > FUSED_LOSS_TOL or err > FUSED_TOL or \
                counters["compiles"] != 1 or counters["legacy_steps"]:
            fail("fused f32: the fused steps disagree with the phase-by-"
                 "phase steps")
        del tf, tp, fused, phased

        # 18.4
        (fused, phased), x, y = _small_pair(mx)
        opt = dict(momentum=0.9, wd=1e-4)
        tf = gluon.Trainer(fused.collect_params(), "sgd", dict(
            opt, lr_scheduler=CosineScheduler(6, base_lr=0.1,
                                              warmup_steps=2)))
        tp = gluon.Trainer(phased.collect_params(), "sgd", dict(
            opt, lr_scheduler=CosineScheduler(6, base_lr=0.1,
                                              warmup_steps=2)))
        lf_f, lf_p = lf(fused), lf(phased)
        fsm.reset_step_counters()
        lrs = []
        for _ in range(6):
            lrs.append(tf.learning_rate)
            tf.fused_step(lf_f, x, y)
            _phase_step(mx, tp, lf_p, x, y)
        err, where = _worst(fused, phased)
        counters = dict(fsm.step_counters)
        # a fixed-rate trainer: lr 0 freezes the next replay's update
        (frozen,), x2, y2 = _small_pair(mx, 1)
        tz = gluon.Trainer(frozen.collect_params(), "sgd",
                           {"learning_rate": 0.1})
        lf_z = lf(frozen)
        for _ in range(3):
            tz.fused_step(lf_z, x2, y2)
        before = {k: p.data()._data.clone() for k, p in
                  frozen._collect_params_with_prefix().items()
                  if p.grad_req != "null"}
        compiles = fsm.step_counters["compiles"]
        tz.set_learning_rate(0.0)
        tz.fused_step(lf_z, x2, y2)
        still = all(torch.equal(before[k], p.data()._data) for k, p in
                    frozen._collect_params_with_prefix().items()
                    if k in before)
        recaptured = fsm.step_counters["compiles"] - compiles
        res["schedule"] = dict(param_rel=err, worst=where,
                               step_counters=counters, lrs=lrs,
                               frozen_by_lr_0=still, recaptures=recaptured)
        print(f"fused schedule: CosineScheduler(6, base_lr=0.1, "
              f"warmup_steps=2), lrs {[round(v, 6) for v in lrs]}: 6 fused "
              f"steps against 6 phase-by-phase {err:.3e} of the largest "
              f"magnitude (tol {FUSED_TOL}, worst {where}); step_counters "
              f"{counters}; set_learning_rate(0.0) froze the next replay: "
              f"{still}, captures it added: {recaptured}", flush=True)
        if err > FUSED_TOL or counters["compiles"] != 1 or not still or \
                recaptured:
            fail("fused schedule: the scheduled fused steps disagree or "
                 "captured again")
        del tf, tp, tz, fused, phased, frozen

        # 18.8
        (fused, phased), x, y = _small_pair(mx)
        tf = gluon.Trainer(fused.collect_params(), "sgd", dict(RESNET_OPT))
        tp = gluon.Trainer(phased.collect_params(), "sgd", dict(RESNET_OPT))
        fsm.reset_step_counters()
        os.environ["MXNET_FUSED_STEP"] = "0"
        try:
            tf.fused_step(lf(fused), x, y)
        finally:
            del os.environ["MXNET_FUSED_STEP"]
        _phase_step(mx, tp, lf(phased), x, y)
        err, where = _worst(fused, phased)
        counters = dict(fsm.step_counters)
        res["hatch"] = dict(param_rel=err, step_counters=counters)
        print(f"fused hatch: MXNET_FUSED_STEP=0, one step through "
              f"fused_step against one phase-by-phase: largest difference "
              f"{err:.3e} (bit for bit: {err == 0.0}); step_counters "
              f"{counters}", flush=True)
        if err != 0.0 or counters["legacy_steps"] != 1 or \
                counters["dispatches"]:
            fail("fused hatch: MXNET_FUSED_STEP=0 is not the phase-by-"
                 "phase step")
        del tf, tp, fused, phased
    finally:
        torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()
    return res


def fused_accumulation():
    """18.5: the headline MLP (784 -> 128 -> 10, f32) with
    ``Trainer(update_interval=4)``: 2 windows of 4 x 16 rows through
    ``fused_step`` against 2 phase-by-phase steps of 64 rows, parameters
    within 1e-5 of their largest magnitude; ``apply_dispatches`` 2,
    ``micro_dispatches`` 6.  SGD with momentum, not the headline's Adam:
    Adam divides each element by its own gradient scale, so the window's
    other summation order moves the elements whose gradient is near zero
    by ~1e-5 of the largest weight (1.04e-5 on the CPU), which would be
    measured here instead of the accumulation."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon import fused_step as fsm

    rs = np.random.RandomState(21)
    xa = rs.rand(64, 784).astype(np.float32)
    ya = rs.randint(0, 10, 64).astype(np.float32)
    x, y = (mx.nd.array(a, ctx=mx.gpu(0)) for a in (xa, ya))
    nets = []
    for _ in range(2):
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Dense(128, activation="relu", in_units=784),
                gluon.nn.Dense(10, in_units=128))
        net.initialize(mx.init.Xavier(), ctx=mx.gpu(0), seed=4)
        nets.append(net)
    loss_l = gluon.loss.SoftmaxCrossEntropyLoss()
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    tf = gluon.Trainer(nets[0].collect_params(), "sgd", dict(opt),
                       update_interval=4)
    tp = gluon.Trainer(nets[1].collect_params(), "sgd", dict(opt))

    def lf(a, b):
        return loss_l(nets[0](a), b)

    fsm.reset_step_counters()
    for _ in range(2):
        for j in range(4):
            tf.fused_step(lf, x[j * 16:(j + 1) * 16],
                          y[j * 16:(j + 1) * 16])
        _phase_step(mx, tp, lambda a, b: loss_l(nets[1](a), b), x, y)
    err, where = _worst(nets[0], nets[1])
    counters = dict(fsm.step_counters)
    print(f"fused accumulation: headline MLP, SGD, update_interval=4, 2 "
          f"windows of 4 x 16 rows against 2 steps of 64: {err:.3e} of "
          f"the largest magnitude (tol {FUSED_TOL}, worst {where}); "
          f"step_counters {counters}", flush=True)
    if err > FUSED_TOL or counters["apply_dispatches"] != 2 or \
            counters["micro_dispatches"] != 6:
        fail("fused accumulation: the accumulated window disagrees")
    return dict(param_rel=err, worst=where, step_counters=counters)


def _mlp_block(mx):
    """The MLP block as a Gluon ``HybridBlock`` on ``mx.gpu(0)``: ``w1``,
    ``b1``, ``w2``, ``b2`` are ``Parameter``s holding ``_mlp_data``'s
    arrays (bf16); ``mx.nd.dot`` + bias, the ``rtc_gelu`` custom op,
    ``mx.nd.dot`` + bias.  Returns the block and (x, target)."""
    from mxnet_tpu_torch import gluon

    p = _mlp_data(MLP_ROWS, "bfloat16", mx.gpu(0))

    class MLPBlock(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                for k in ("w1", "b1", "w2", "b2"):
                    setattr(self, k, self.params.get(
                        k, shape=p[k].shape, dtype="bfloat16"))

        def forward(self, x):
            nd = mx.nd
            h = nd.dot(nd.NDArray(x), self.w1.data()) + self.b1.data()
            a = nd.Custom(h, op_type="rtc_gelu")
            return (nd.dot(a, self.w2.data()) + self.b2.data())._data

    net = MLPBlock()
    net.initialize(ctx=mx.gpu(0))
    for k in ("w1", "b1", "w2", "b2"):
        getattr(net, k).set_data(p[k])
    return net, p["x"], p["t"]


def fused_mlp(op, eager_row):
    """18.6: the MLP block through ``gluon.Trainer`` (SGD, lr
    ``MLP_LR`` on the mean squared error, batch size 1) phase by phase
    and through ``fused_step``, 10 steps each, bf16: the fused step graph
    holds exactly one ``gelu_fwd`` and one ``gelu_bwd`` node; losses
    finite and falling; ms a step and rows/s of both arms beside phase
    17's eager ms, and peak memory."""
    import math

    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon import fused_step as fsm
    from mxnet_tpu_torch.gluon.block import _GraphProgram

    def mse(net):
        return lambda a, b: mx.nd.mean(mx.nd.square(net(a) - b))

    row = {}
    for arm in ("phase", "fused"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        net, x, t = _mlp_block(mx)
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": MLP_LR})
        lf = mse(net)
        if arm == "fused":
            def step():
                return trainer.fused_step(lf, x, t, batch_size=1)
        else:
            def step():
                return _mlp_phase(mx, trainer, lf, x, t)
        fsm.reset_step_counters()
        for k in op.kernels.values():
            k.launches = 0
        _GraphProgram.debug = arm == "fused"
        try:
            t0 = time.perf_counter()
            losses = [step(), step()]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        finally:
            _GraphProgram.debug = False
        losses += [step() for _ in range(FUSED_MLP_STEPS - 2)]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        losses = [float(v.asnumpy().reshape(-1)[0]) for v in losses]
        timed = FUSED_MLP_STEPS - 2
        r = dict(losses=losses, ms_per_step=(t2 - t1) / timed * 1e3,
                 rows_per_s=MLP_ROWS * timed / (t2 - t1),
                 first_two_ms=(t1 - t0) * 1e3,
                 max_memory_allocated=torch.cuda.max_memory_allocated(),
                 memory_above_start=torch.cuda.max_memory_allocated() -
                 start, rtc_host_launches=op.launches(),
                 step_counters=dict(fsm.step_counters))
        if arm == "fused":
            fs, prog = _apply_program(trainer)
            counts, every = _graph_nodes(prog, ("gelu_fwd", "gelu_bwd"))
            _print_nodes("fused mlp graph", every)
            r.update(nodes=counts, launches_a_replay=prog.launches,
                     capture_s=prog.capture_s,
                     launches=op.launches() -
                     prog.launches.get("rtc", 0) +
                     fs.launches().get("rtc", 0))
            trainer._fused_steps.clear()
            del fs, prog
        else:
            r["launches"] = op.launches()
        print(f"fused mlp {arm}: MLP block {MLP_ROWS} x {MLP_UNITS} -> "
              f"{MLP_HIDDEN} -> {MLP_UNITS} bf16 as a HybridBlock, "
              f"gluon.Trainer sgd lr {MLP_LR}, {FUSED_MLP_STEPS} steps; "
              f"losses {[round(v, 6) for v in losses]}; ms/step="
              f"{r['ms_per_step']:.3f} rows/s={r['rows_per_s']:.1f} (steps "
              f"3-{FUSED_MLP_STEPS}) max_memory_allocated="
              f"{r['max_memory_allocated']} ({r['memory_above_start']} "
              f"above the arm's start); rtc launches {r['launches']}; "
              f"step_counters {r['step_counters']}" +
              (f"; graph nodes {r['nodes']}, capture {r['capture_s']:.3f} "
               f"s" if arm == "fused" else ""), flush=True)
        if not all(math.isfinite(v) for v in losses) or \
                not losses[-1] < losses[0]:
            fail(f"fused mlp {arm}: losses not finite and falling: "
                 f"{losses}")
        row[arm] = r
        del net, trainer, x, t
    if row["fused"]["nodes"] != {"gelu_fwd": 1, "gelu_bwd": 1}:
        fail(f"fused mlp: graph nodes {row['fused']['nodes']}, expected one "
             "gelu_fwd and one gelu_bwd")
    counters = row["fused"]["step_counters"]
    if counters["legacy_steps"] or counters["compiles"] != 1:
        fail(f"fused mlp: step counters {counters}")
    row["eager_ms_per_step"] = eager_row["ms_per_step"] if eager_row \
        else None
    print(f"fused mlp: ms/step fused {row['fused']['ms_per_step']:.3f}, "
          f"phase by phase {row['phase']['ms_per_step']:.3f}, phase 17's "
          f"eager NDArray loop {row['eager_ms_per_step']}", flush=True)
    torch.cuda.empty_cache()
    return row


def _mlp_phase(mx, trainer, lf, x, t):
    with mx.autograd.record():
        loss = lf(x, t)
    loss.backward()
    trainer.step(1)
    return loss


def fused_hybridize():
    """18.7: ResNet-50 inference at B=128 bf16, the hybridized forward
    (a graph replay) against the same net's imperative forward: each
    output within 2 bf16 steps of its largest magnitude (and whether bit
    for bit); ms a forward both ways."""
    import math

    import torch
    import mxnet_tpu_torch as mx

    net = _gluon_resnet50(mx)
    data, _ = _resnet_batch()
    x = mx.nd.NDArray(data)
    net.hybridize(False)
    ref = net(x)._data.clone()
    imp_ms = cuda_ms(lambda i: net(x), 5)
    net.hybridize()
    outs = [net(x)._data.clone() for _ in range(3)]   # eager, capture, replay
    hyb_ms = cuda_ms(lambda i: net(x), 5)
    top = float(ref.float().abs().max())
    tol = 2 * 2.0 ** (math.floor(math.log2(top)) - 7)
    errs = [float((o.float() - ref.float()).abs().max()) for o in outs]
    bitwise = all(torch.equal(o, ref) for o in outs[1:])
    op = net._cached_op
    row = dict(max_abs_err=max(errs[1:]), tol=tol, bitwise_equal=bitwise,
               ms_hybridized=hyb_ms, ms_imperative=imp_ms,
               builds=op.builds,
               captured=[p.graph is not None
                         for p in op._programs.values()])
    print(f"fused hybridize: resnet50_v1 inference B={RESNET_B} bf16, graph "
          f"replay against the imperative forward: max_abs_err "
          f"{row['max_abs_err']:.3e} (tol {tol:.3e}, 2 bf16 steps of "
          f"{top:.4f}), bit for bit {bitwise}; ms a forward hybridized "
          f"{hyb_ms:.3f}, imperative {imp_ms:.3f}; programs {op.builds}, "
          f"captured {row['captured']}", flush=True)
    if row["max_abs_err"] > tol or not all(row["captured"]):
        fail("fused hybridize: the replayed forward disagrees or was not "
             "captured")
    del net, op, outs, ref, x, data
    torch.cuda.empty_cache()
    return row


DROP_B, DROP_T, DROP_U, DROP_H = 8, 1024, 768, 12   # GPT-2 small's block
FUSED_DROP_STEPS = 10
ATTN_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def _attn_drop_block(mx):
    """A Gluon ``HybridBlock`` of GPT-2 small's attention width: qkv
    projection, causal ``flash_attention`` at dropout 0.1 (K1 forward,
    K2/K3 backward at T = 1024), output projection and
    ``gluon.nn.Dropout(0.1)``; Xavier, bf16, on ``mx.gpu(0)``."""
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.ops.attention import flash_attention

    U, H = DROP_U, DROP_H

    class AttnDrop(nn.HybridBlock):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.qkv = nn.Dense(3 * U, flatten=False, in_units=U)
                self.proj = nn.Dense(U, flatten=False, in_units=U)
                self.drop = nn.Dropout(0.1)

        def forward(self, x):
            B, L, _ = x.shape
            qkv = self.qkv(x).reshape(B, L, 3, H, U // H).permute(
                2, 0, 3, 1, 4)
            o = flash_attention(qkv[0], qkv[1], qkv[2], causal=True,
                                dropout=0.1, training=self._is_training())
            return self.drop(self.proj(o.permute(0, 2, 1, 3).reshape(
                B, L, U)))

    with mx.gpu(0):
        net = AttnDrop()
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0), seed=6)
    net.cast("bfloat16")
    return net


def fused_dropout():
    """18.9: ``Trainer.fused_step`` and ``hybridize()`` over a block with
    attention dropout and ``gluon.nn.Dropout`` (``_attn_drop_block``),
    8 x 1024 tokens, L2 loss to a seeded target, Adam (lr 1e-3), 10
    fused steps: K1, K2 and K3 launched exactly once a step (replays
    counted by what the capture recorded), one capture, losses finite
    and falling; then with lr 0 two replays on one batch give different
    losses (fresh masks); then the hybridized forward in training mode
    (``autograd.train_mode()``): its replays differ from each other,
    and in inference mode a replay equals the imperative forward within
    2 bf16 steps."""
    import math

    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon import fused_step as fsm
    from mxnet_tpu_torch.ops import attention as pa

    mx.random.seed(7)
    net = _attn_drop_block(mx)
    gen = torch.Generator(device="cuda").manual_seed(19)
    data = torch.randn((DROP_B, DROP_T, DROP_U), generator=gen,
                       device="cuda").bfloat16()
    target = (0.1 * torch.randn((DROP_B, DROP_T, DROP_U), generator=gen,
                                device="cuda")).bfloat16()
    x, y = mx.nd.NDArray(data), mx.nd.NDArray(target)
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 1e-3})
    loss_l = gluon.loss.L2Loss()

    def loss_fn(a, b):
        return loss_l(net(a), b)

    torch.cuda.synchronize()
    fsm.reset_step_counters()
    _reset_attention_counts()
    losses = [trainer.fused_step(loss_fn, x, y)._data.float().mean()
              for _ in range(FUSED_DROP_STEPS)]
    torch.cuda.synchronize()
    losses = [float(v) for v in losses]
    fs, prog = _apply_program(trainer)
    host = _attention_counts()
    replayed = fs.launches()
    launches = {n: host[n] - prog.launches.get(n, 0) + replayed.get(n, 0)
                for n in ATTN_KERNELS}
    counters = dict(fsm.step_counters)
    trainer.set_learning_rate(0.0)
    fresh = [float(trainer.fused_step(loss_fn, x, y)._data.float().mean())
             for _ in range(2)]
    print(f"fused dropout: attention + gluon.nn.Dropout block (B="
          f"{DROP_B} T={DROP_T} U={DROP_U}, bf16, dropout 0.1) through "
          f"Trainer.fused_step, {FUSED_DROP_STEPS} Adam steps; losses "
          f"{[round(v, 6) for v in losses]}; launches {launches} "
          f"(a replay's {prog.launches}); step_counters {counters}; lr 0, "
          f"two replays on one batch: losses {fresh}", flush=True)
    for n in ATTN_KERNELS:
        if launches[n] != FUSED_DROP_STEPS:
            fail(f"fused dropout: {n} launched {launches[n]} times, "
                 f"expected {FUSED_DROP_STEPS}")
    if counters["compiles"] != 1 or counters["legacy_steps"]:
        fail(f"fused dropout: step counters {counters}")
    if not all(math.isfinite(v) for v in losses) or \
            not sum(losses[-3:]) < sum(losses[:3]):
        fail(f"fused dropout: losses not finite and falling: {losses}")
    if fresh[0] == fresh[1]:
        fail("fused dropout: two replays drew the same masks")
    trainer._fused_steps.clear()
    # hybridize(): replays in training mode draw fresh masks; in inference
    # mode a replay is the imperative forward
    net.hybridize(False)
    ref = net(x)._data.clone()
    net.hybridize()
    with autograd.train_mode():
        train_outs = [net(x)._data.clone() for _ in range(3)]
    outs = [net(x)._data.clone() for _ in range(3)]
    top = float(ref.float().abs().max())
    tol = 2 * 2.0 ** (math.floor(math.log2(top)) - 7)
    err = max(float((o.float() - ref.float()).abs().max()) for o in outs)
    differ = not torch.equal(train_outs[1], train_outs[2])
    progs = net._cached_op._programs.values()
    captured = [p.graph is not None for p in progs]
    print(f"fused dropout: hybridized, training mode: replays differ "
          f"{differ}; inference mode: max_abs_err {err:.3e} against the "
          f"imperative forward (tol {tol:.3e}, 2 bf16 steps of "
          f"{top:.4f}); programs captured {captured}", flush=True)
    if not differ or err > tol or not all(captured):
        fail("fused dropout: the hybridized forward's replays do not draw "
             "fresh masks in training mode or disagree in inference mode")
    row = dict(losses=losses, launches=launches,
               launches_a_replay=prog.launches, step_counters=counters,
               fresh_losses=fresh, hybridized_replays_differ=differ,
               hybridized_max_abs_err=err, hybridized_tol=tol)
    del fs, prog, trainer, net, x, y, data, target, ref, outs, train_outs
    torch.cuda.empty_cache()
    for fn in (pa.flash_fwd, pa.flash_bwd_dq, pa.flash_bwd_dkv):
        fn.launches = 0
    return row


def check_fused(op, spmd_row, gluon_row, eager_row):
    """Phase 18: its nine parts (18.8 runs with 18.3 and 18.4, on the
    same small net)."""
    return dict(capture=fused_capture_checks(op),
                resnet=fused_resnet(spmd_row, gluon_row),
                small=fused_small_checks(),
                accumulation=fused_accumulation(),
                mlp=fused_mlp(op, eager_row),
                hybridize=fused_hybridize(),
                dropout=fused_dropout())


# --------------------------------------------------------------------------- #
# phase 19: the optimizers and the trainer's states, the thirteenth slice
# --------------------------------------------------------------------------- #

LAMB_OPT = {"learning_rate": 1e-3, "wd": 0.01, "multi_precision": True}
LARS_OPT = {"learning_rate": 1.0, "momentum": 0.9, "wd": 1e-4,
            "multi_precision": True}
LARS_STEPS = 10             # each of the three runs of 19.2
ALL_OPT_STEPS = 3           # 19.3: eager, capture + replay, replay
ALL_OPT_TIMED = 10          # 19.3: replays timed a fused step
ALL_OPT_LR = {"sgd": 10.0, "nag": 10.0, "signum": 1e-3, "dcasgd": 10.0,
              "adam": 1e-3, "adamw": 1e-3, "nadam": 1e-3, "lamb": 1e-2,
              "lars": 10.0, "rmsprop": 1e-3, "adagrad": 1e-2,
              "adadelta": 1.0, "ftrl": 0.1, "ftml": 1e-3, "sgld": 1e-4}


def _ranged_optimizer(opt, fn):
    """``fn()`` under ``torch.profiler`` with ``opt.fused_step_apply`` in
    a range: (the range's device us, the window's device us).  ``fn``
    must run the apply eagerly: a graph replay has no host range."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    plain = opt.fused_step_apply

    def ranged(*a, **k):
        with record_function("optimizer"):
            return plain(*a, **k)

    opt.fused_step_apply = ranged
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        del opt.fused_step_apply
    busy = 0.0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.key != "optimizer":
            us = getattr(ev, "self_device_time_total", None)
            busy += ev.self_cuda_time_total if us is None else us
    ranged_us = 0.0
    for ev in prof.events():
        if ev.device_type != DeviceType.CPU or not ev.kernels:
            continue
        up = ev
        while up is not None and up.name != "optimizer":
            up = up.cpu_parent
        if up is not None:
            ranged_us += sum(k.duration for k in ev.kernels
                             if k.name != "optimizer")
    return ranged_us, busy


def lamb_gpt2(cfg, adamw_row):
    """19.1: GPT-2 small bf16 (12 layers, 768 units, 1024 context) at
    dropout 0.1 through ``SPMDTrainer`` with LAMB (multi-precision, lr
    1e-3, wd 0.01): one ``step``, then ``run_steps`` over 19 more of one
    batch; K1, K2, K3 exactly 12 times a step; losses finite, the first
    within 0.5 of ln(vocab), falling; ms a step beside phase 7's AdamW;
    the optimizer's device ms in one profiled eager step; three eager
    steps against three replays bit for bit (phase 7.2's check)."""
    import math

    import numpy as np
    import torch
    from mxnet_tpu_torch import gluon, parallel, random
    from mxnet_tpu_torch.models import gpt2_small

    random.seed(0)
    model, _ = gpt2_small(dtype=torch.bfloat16, dropout=0.1)
    model.initialize(0.02, seed=0)
    rs = np.random.RandomState(8)
    data = torch.as_tensor(rs.randint(0, cfg.vocab_size,
                                      (TRAIN_B, TRAIN_T)), device="cuda")
    label = torch.as_tensor(rs.randint(0, cfg.vocab_size,
                                       (TRAIN_B, TRAIN_T)), device="cuda")
    trainer = parallel.SPMDTrainer(
        model, gluon.loss.SoftmaxCrossEntropyLoss(), "lamb", dict(LAMB_OPT))
    rest = TRAIN_STEPS - 1
    torch.cuda.synchronize()
    _reset_attention_counts()
    first = trainer.step(data, label)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    more = trainer.run_steps(data[None].expand(rest, -1, -1),
                             label[None].expand(rest, -1, -1))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = _graph_launches(trainer, _attention_counts())
    losses = [float(first)] + [float(x) for x in more.float().cpu()]
    step_ms = (t2 - t1) / rest * 1e3
    arms = spmd_arms(trainer, data, label, "lamb gpt2 arms")
    opt_us, busy = _ranged_optimizer(trainer.optimizer, lambda: trainer
                                     ._prepare(data[None], label[None],
                                               None).run())
    row = dict(losses=losses, ms_per_step=step_ms,
               tokens_per_s=rest * TRAIN_B * TRAIN_T / (t2 - t1),
               launches=launches, optimizer_device_us=opt_us,
               eager_step_device_us=busy, arms=arms,
               adamw_ms_per_step=adamw_row["ms_per_step"],
               adamw_captured_ms_per_step=adamw_row["arms"][
                   "captured_ms_per_step"])
    print(f"lamb gpt2: gpt2_small bf16 dropout 0.1, B={TRAIN_B} "
          f"T={TRAIN_T}, SPMDTrainer lamb {LAMB_OPT}, {TRAIN_STEPS} steps; "
          f"losses {[round(x, 4) for x in losses]}", flush=True)
    print(f"lamb gpt2: ms/step={step_ms:.3f} tokens/s="
          f"{row['tokens_per_s']:.2f} (steps 2-{TRAIN_STEPS}: one eager "
          f"call, one capture, replays) beside phase 7's AdamW "
          f"{adamw_row['ms_per_step']:.3f}; captured arm "
          f"{arms['captured_ms_per_step']:.3f} ms/step beside phase 7's "
          f"{row['adamw_captured_ms_per_step']:.3f}; "
          f"launches {launches}; one eager step profiled: optimizer "
          + (f"{opt_us / 1e3:.3f} ms of {busy / 1e3:.3f} ms device time "
             f"({opt_us / busy:.4f})" if busy > 0 and opt_us > 0 else
             "not measured (the profiler recorded no device time in its "
             "range)") + f"; {card_line()}", flush=True)
    expect = cfg.num_layers * TRAIN_STEPS
    for name, n in launches.items():
        if n != expect:
            fail(f"lamb gpt2: {name} launched {n} times, expected {expect}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"lamb gpt2: losses not finite: {losses}")
    if abs(losses[0] - math.log(cfg.vocab_size)) > 0.5:
        fail(f"lamb gpt2: first loss {losses[0]} is not within 0.5 of "
             f"ln(vocab)")
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        fail(f"lamb gpt2: loss did not fall: {losses}")
    del trainer, model, more
    torch.cuda.empty_cache()
    row["captured_vs_eager"] = eager_vs_replays(
        "lamb gpt2 captured vs eager", cfg, "lamb", dict(LAMB_OPT))
    return row


def _lars_resnet(mx, state=None):
    """Phase 16's ResNet-50 with a ``gluon.Trainer`` over LARS; with
    ``state`` (a parameters file and a states file) loaded from it."""
    from mxnet_tpu_torch import gluon

    net = _gluon_resnet50(mx)
    if state is not None:
        net.load_parameters(state[0], ctx=mx.gpu(0))
    trainer = gluon.Trainer(net.collect_params(), "lars", dict(LARS_OPT))
    if state is not None:
        trainer.load_states(state[1])
    loss_l = gluon.loss.SoftmaxCrossEntropyLoss()

    def loss_fn(x, y):
        return loss_l(net(x), y)
    return net, trainer, loss_fn


def lars_resnet():
    """19.2: ResNet-50 (phase 16's net, bf16, multi-precision) through
    ``gluon.Trainer(..., "lars")`` and ``fused_step`` with
    ``MXNET_FUSED_CONV_BWD=1``: 30 K6 nodes in the step graph and one
    capture; 10 steps, ``save_states`` + ``save_parameters``, 10 more; a
    fresh net and trainer that load both and run the last 10 equal the
    run bit for bit (losses and every parameter); ``load_states`` into
    the original trainer (its graph captured) with the step-10 weights
    copied back in place, then 10 replays: equal again, no new capture;
    losses finite, the first within 1.0 of ln(1000)."""
    import math

    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import fused_step as fsm
    from mxnet_tpu_torch.gluon.block import _GraphProgram
    from mxnet_tpu_torch.ops import conv_fused as cf

    os.environ["MXNET_FUSED_CONV_BWD"] = "1"
    data, label = _resnet_batch()
    x, y = mx.nd.NDArray(data), mx.nd.NDArray(label)
    net, trainer, loss_fn = _lars_resnet(mx)

    def run(tr, lf, n):
        out = [tr.fused_step(lf, x, y)._data.float().mean()
               for _ in range(n)]
        torch.cuda.synchronize()
        return [float(v) for v in out]

    def params(m):
        return [p.data()._data.clone() for p in m.collect_params().values()]

    fsm.reset_step_counters()
    cf.conv1x1_bwd_pair.launches = 0
    _GraphProgram.debug = True
    try:
        losses = run(trainer, loss_fn, 2)       # eager; capture + replay
    finally:
        _GraphProgram.debug = False
    losses += run(trainer, loss_fn, LARS_STEPS - 2)
    fs, prog = _apply_program(trainer)
    counts, _ = _graph_nodes(prog, ("conv1x1_bwd",))
    path = os.path.join(HERE, "build", "lars_resnet50")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    files = (path + ".params", path + ".states")
    net.save_parameters(files[0])
    trainer.save_states(files[1])
    at_10 = params(net)
    t0 = time.perf_counter()
    tail = run(trainer, loss_fn, LARS_STEPS)
    ms = (time.perf_counter() - t0) / LARS_STEPS * 1e3
    end = params(net)
    k6 = cf.conv1x1_bwd_pair.launches - prog.launches.get(
        "conv1x1_bwd", 0) + fs.launches().get("conv1x1_bwd", 0)
    compiles = fsm.step_counters["compiles"]
    # the original trainer, its graph captured, loaded back
    trainer.load_states(files[1])
    with torch.no_grad():
        for p, w in zip(net.collect_params().values(), at_10):
            p.data()._data.copy_(w)
    again = run(trainer, loss_fn, LARS_STEPS)
    again_equal = again == tail and all(
        torch.equal(a, b) for a, b in zip(params(net), end))
    reload_compiles = fsm.step_counters["compiles"]
    # a fresh net and trainer from the files (last: a new net moves the
    # storage generation, which drops the original's programs)
    twin, ttr, tlf = _lars_resnet(mx, files)
    resumed = run(ttr, tlf, LARS_STEPS)
    twin_equal = resumed == tail and all(
        torch.equal(a, b) for a, b in zip(params(twin), end))
    del twin, ttr, tlf
    torch.cuda.empty_cache()
    counters = dict(fsm.step_counters)
    for f in files:
        os.remove(f)
    curve = losses + tail
    row = dict(losses=curve, resumed=resumed, reloaded=again,
               ms_per_step=ms, k6_nodes=counts["conv1x1_bwd"],
               launches=dict(conv1x1_bwd=k6), step_counters=counters,
               compiles_before_reload=compiles,
               compiles_after_reload=reload_compiles, twin_equal=twin_equal,
               reload_equal=again_equal)
    print(f"lars resnet: resnet50_v1 NHWC bf16 multi-precision, "
          f"Trainer.fused_step lars {LARS_OPT}, B={RESNET_B}; losses "
          f"{[round(v, 4) for v in curve]}; ms/step={ms:.3f} (steps 11-20, "
          f"replays); K6 nodes in the step graph {counts} (expected "
          f"{K6_PER_STEP}), K6 ran {k6} times; {card_line()}", flush=True)
    print(f"lars resnet: resumed from save_states + save_parameters in a "
          f"fresh net and trainer: losses {[round(v, 4) for v in resumed]},"
          f" equal to steps 11-20 bit for bit (losses and every parameter) "
          f"{twin_equal}; load_states into the captured trainer with the "
          f"step-10 weights: equal {again_equal}; step_counters {counters} "
          f"(compiles {compiles} before the reload, {reload_compiles} "
          f"after it)", flush=True)
    if counts["conv1x1_bwd"] != K6_PER_STEP:
        fail(f"lars resnet: {counts['conv1x1_bwd']} K6 nodes in the step "
             f"graph, expected {K6_PER_STEP}")
    if compiles != 1 or reload_compiles != 1 or \
            counters["legacy_steps"] or counters["compiles"] != 2:
        # one capture of the original's step, one of the fresh trainer's
        fail(f"lars resnet: step counters {counters}, compiles before the "
             f"reload {compiles}")
    if not (twin_equal and again_equal):
        fail("lars resnet: a resumed run departs from the uninterrupted one")
    if not all(math.isfinite(v) for v in curve):
        fail(f"lars resnet: losses not finite: {curve}")
    if abs(curve[0] - math.log(1000)) > 1.0:
        fail(f"lars resnet: first loss {curve[0]} is not within 1.0 of "
             "ln(1000)")
    del net, trainer, fs, prog, at_10, end
    torch.cuda.empty_cache()
    return row


def _tensors_of(trainer):
    out = [p.data()._data for p in trainer._params]
    for s in trainer._states:
        stack = [s]
        while stack:
            x = stack.pop(0)
            if isinstance(x, tuple):
                stack = list(x) + stack
            elif x is not None:
                out.append(x)
    return out


def all_optimizers(op):
    """19.3: phase 18.6's MLP block (bf16, K7's ``gelu_fwd``/``gelu_bwd``)
    through ``gluon.Trainer`` with each of the fifteen optimizers, with
    and without multi-precision: three ``fused_step`` calls (eager,
    capture and replay, replay) against three phase-by-phase steps,
    losses, weights and states bit for bit (SGLD runs phase by phase
    only: its noise keeps it off the fused path); a states file written
    after step 2 and loaded into a fresh trainer (its net given the
    step-2 weights) gives step 3 bit for bit; K7 twice a step; ms a
    fused step (replays) and the optimizer's device share of one eager
    step of the fused program, profiled."""
    import math

    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon import fused_step as fsm
    from mxnet_tpu_torch.optimizer.optimizer import _REGISTRY

    def mse(net):
        return lambda a, b: mx.nd.mean(mx.nd.square(net(a) - b))

    def build(name, mp):
        net, x, t = _mlp_block(mx)
        tr = gluon.Trainer(net.collect_params(), name,
                           {"learning_rate": ALL_OPT_LR[name],
                            "multi_precision": mp})
        return net, tr, mse(net), x, t

    path = os.path.join(HERE, "build", "all_optimizers.states")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rows, launches, failed = {}, 0, []
    for name in sorted(set(_REGISTRY)):
        for mp in (False, True):
            key = f"{name}{' mp' if mp else ''}"
            fused_arm = _REGISTRY[name]._fusable
            for k in op.kernels.values():
                k.launches = 0
            net, tr, lf, x, t = build(name, mp)
            phase = []
            for step in range(ALL_OPT_STEPS):
                if step == ALL_OPT_STEPS - 1:
                    tr.save_states(path)
                    at_2 = [p.data()._data.clone() for p in tr._params]
                    mx.random.seed(5)       # SGLD's step-3 noise, twice
                phase.append(float(_mlp_phase(mx, tr, lf, x, t)
                                   .asnumpy().reshape(-1)[0]))
            phase_end = [a.clone() for a in _tensors_of(tr)]
            launches += op.launches()
            ok_launch = op.launches() == 2 * ALL_OPT_STEPS
            # step 3 again from the file, in a fresh trainer
            net2, tr2, lf2, _, _ = build(name, mp)
            for p, w in zip(tr2._params, at_2):
                p.set_data(mx.nd.NDArray(w.clone()))
            tr2.load_states(path)
            mx.random.seed(5)
            _mlp_phase(mx, tr2, lf2, x, t)
            resumed = all(torch.equal(a, b) for a, b in
                          zip(_tensors_of(tr2), phase_end))
            del net2, tr2
            row = dict(phase_losses=phase, resumed_equal=resumed,
                       launches_ok=ok_launch)
            if fused_arm:
                for k in op.kernels.values():
                    k.launches = 0
                netf, trf, lff, xf, tf = build(name, mp)
                fsm.reset_step_counters()
                fused = [float(trf.fused_step(lff, xf, tf, batch_size=1)
                               .asnumpy().reshape(-1)[0])
                         for _ in range(ALL_OPT_STEPS)]
                fs, prog = _apply_program(trf)
                worst = 0.0
                same = fused == phase
                for a, b in zip(_tensors_of(trf), phase_end):
                    if not torch.equal(a, b):
                        same = False
                        worst = max(worst, _bf16_steps_apart(a, b))
                runs = op.launches() - prog.launches.get("rtc", 0) + \
                    fs.launches().get("rtc", 0)
                launches += runs
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(ALL_OPT_TIMED):
                    prog.graph.replay()
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) / ALL_OPT_TIMED * 1e3
                prog.replays += ALL_OPT_TIMED
                launches += ALL_OPT_TIMED * prog.launches.get("rtc", 0)
                opt_us, busy = _ranged_optimizer(trf.optimizer, prog.run)
                row.update(fused_losses=fused, equal=same,
                           worst_bf16_steps=worst, ms_per_fused_step=ms,
                           optimizer_device_us=opt_us,
                           step_device_us=busy,
                           optimizer_share=opt_us / busy if busy else None,
                           compiles=fsm.step_counters["compiles"],
                           legacy_steps=fsm.step_counters["legacy_steps"])
                ok_launch = ok_launch and runs == 2 * ALL_OPT_STEPS
                row["launches_ok"] = ok_launch
                trf._fused_steps.clear()
                del netf, trf, fs, prog
            rows[key] = row
            print(f"all optimizers: {key}: phase-by-phase losses "
                  f"{[round(v, 6) for v in phase]}; resumed from its "
                  f"states file at step 3 equal bit for bit {resumed}"
                  + (f"; fused (eager, capture + replay, replay) equal bit "
                     f"for bit {row['equal']} (largest "
                     f"{row['worst_bf16_steps']:.3f} bf16 steps); "
                     f"{row['ms_per_fused_step']:.3f} ms a fused step; "
                     f"optimizer "
                     + (f"{row['optimizer_device_us'] / 1e3:.3f} ms of "
                        f"{row['step_device_us'] / 1e3:.3f} ms device time "
                        f"a step ({row['optimizer_share']:.4f})"
                        if row["optimizer_share"] else "not measured")
                     if fused_arm else "; phase by phase only")
                  + f"; K7 2 a step {ok_launch}", flush=True)
            bad = not (resumed and ok_launch) or \
                not all(math.isfinite(v) for v in phase)
            if fused_arm:
                bad = bad or not row["equal"] or row["compiles"] != 1 or \
                    row["legacy_steps"]
            if bad:
                failed.append(key)
            del net, tr
            torch.cuda.empty_cache()
    os.remove(path)
    print(f"all optimizers: {card_line()}", flush=True)
    if failed:
        fail(f"all optimizers: {failed} failed their checks")
    return dict(rows=rows, launches=launches)


def check_optimizers(cfg, op, adamw_row):
    """Phase 19: its three new parts (19.4 runs inside phases 16 and
    18.2)."""
    return dict(lamb_gpt2=lamb_gpt2(cfg, adamw_row),
                lars_resnet=lars_resnet(), all=all_optimizers(op))


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
    k1_design = report_design("K1", "flash_fwd", "flash_fwd_design",
                              "flash_fwd_mma_kernel")
    k1 = check_k1(cfg, B=8)
    k2_design = report_design("K2", "flash_bwd", "flash_bwd_dq_design",
                              "flash_bwd_dq_mma_kernel")
    k3_design = report_design("K3", "flash_bwd", "flash_bwd_dkv_design",
                              "flash_bwd_dkv_mma_kernel")
    k23 = check_k23(cfg, B=8)
    seed_word = check_seed_masks(cfg, B=8)
    srv = check_serving(model, cfg)
    srv["profile"] = profile_serving(model, cfg)
    del model
    torch.cuda.empty_cache()
    srv["agreement_f32"] = check_serving_f32(cfg)
    torch.cuda.empty_cache()
    train = check_training(cfg)
    train["captured_vs_eager"] = check_captured_vs_eager(cfg)
    train["vs_cpu"] = check_training_vs_cpu()
    bert = check_bert()

    from mxnet_tpu_torch.models import llama_7b

    gpt2, _ = gpt2_small(dtype=torch.bfloat16)
    gpt2.initialize(0.02, seed=0)
    llama2 = llama_7b(dtype=torch.bfloat16, num_layers=2)[0]
    gqa2 = llama_7b(dtype=torch.bfloat16, num_layers=2, num_kv_heads=8)[0]
    for m in (llama2, gqa2):
        m.initialize(0.02, seed=1)
    k5, k5_design = check_k5({"gpt2": gpt2, "llama": llama2, "gqa": gqa2})
    del llama2, gqa2
    torch.cuda.empty_cache()
    fused = check_fused_gpt2(gpt2, cfg)
    fused["profile"] = profile_fused(gpt2)
    del gpt2
    torch.cuda.empty_cache()
    fused["llama_7b"] = check_llama7b()

    k6_design = report_design("K6", "conv1x1_bwd", "conv1x1_bwd_design",
                              "conv1x1_bwd_mma_kernel")
    k6 = check_k6()
    vision = dict(fused=check_resnet(True), unfused=check_resnet(False),
                  vs_cpu=check_resnet_vs_cpu())
    gluon = check_gluon(vision["fused"])

    import mxnet_tpu_torch as mx

    rtc = check_rtc()
    gelu_op = _rtc_sources().RtcGelu(mx, op_type="rtc_gelu").register()
    mlp = check_imperative_mlp(gelu_op)
    mlp["vs_cpu"] = check_imperative_vs_cpu()
    fused_train = check_fused(gelu_op, vision["fused"], gluon["resnet"], mlp)
    opt19 = check_optimizers(cfg, gelu_op, train)
    gelu = next(c for c in rtc["cases"]
                if c["name"] == "gelu_fwd<__nv_bfloat16>")

    def backward_row(name, key, outputs, replaces):
        main = k23[0][key]
        return dict(name=name, route="cuda",
                    source="mxnet_tpu_torch/csrc/flash_bwd.cu",
                    replaces=replaces,
                    launches=train["launches"][name] +
                    opt19["lamb_gpt2"]["launches"][name],
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
             bound_by=k4["bound_by"], library_ms=k4["library_ms"],
             queued_ms=k4["queued_ms"],
             library_queued_ms=k4["library_queued_ms"],
             design=k4["design"]["design"]),
        dict(name="flash_fwd", route="cuda",
             source="mxnet_tpu_torch/csrc/flash_fwd.cu",
             replaces="mxnet_tpu/ops/attention.py:226",
             launches=train["launches"]["flash_fwd"] +
             opt19["lamb_gpt2"]["launches"]["flash_fwd"],
             max_abs_err=max(r["max_abs_err"] for r in k1), ms=k1[0]["ms"],
             plain_ms=k1[0]["plain_ms"], bound_ms=k1[0]["bound_ms"],
             bound_by=k1[0]["bound_by"], library_ms=k1[0]["library_ms"],
             design=k1_design["design"]),
        dict(backward_row("flash_bwd_dq", "k2", ("dq",),
                          "mxnet_tpu/ops/attention.py:369"),
             design=k2_design["design"]),
        dict(backward_row("flash_bwd_dkv", "k3", ("dk", "dv", "dbias"),
                          "mxnet_tpu/ops/attention.py:479"),
             design=k3_design["design"]),
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
             queued_ms=k5[0]["queued_ms"],
             unfused_step_ms=k5[0]["unfused_step_ms"],
             design=k5_design["design"]),
        # K6: per ResNet-50 step (30 launches at nine shapes, bf16); the
        # library call is cuDNN's backward (dx and dW in one call); its
        # launches are those of the four ResNet-50 arms (SPMDTrainer,
        # phase 14, gluon.Trainer, phase 16, Trainer.fused_step, phase
        # 18, and LARS through fused_step, phase 19.2; replays count by
        # the graph's launches)
        dict(name="conv1x1_bwd", route="cuda",
             source="mxnet_tpu_torch/csrc/conv1x1_bwd.cu",
             replaces="mxnet_tpu/ops/conv_fused.py:134",
             launches=vision["fused"]["launches"]["conv1x1_bwd"] +
             gluon["resnet"]["launches"]["conv1x1_bwd"] +
             fused_train["resnet"]["launches"]["conv1x1_bwd"] +
             opt19["lars_resnet"]["launches"]["conv1x1_bwd"],
             max_abs_err=k6["max_abs_err"], ms=k6["ms"],
             plain_ms=k6["plain_ms"], bound_ms=k6["bound_ms"],
             bound_by=k6["bound_by"], library_ms=k6["library_ms"],
             cublas_ms=k6["cublas_ms"], design=k6_design["design"]),
        # K7: the runtime-compiled kernels' launcher; its launches on the
        # MLP paths (gelu_fwd and gelu_bwd, 2 a step: phase 17's NDArray
        # loop, phase 18's Gluon block phase by phase and fused, and
        # phase 19.3's fifteen optimizers; replays count by the graph's
        # launches), its times those of
        # gelu_fwd<__nv_bfloat16> at the path's 8192 x 3072, the library
        # call F.gelu(approximate="tanh"); its host half: us a launch,
        # the host floor and a torch.add (rtc_launch_costs)
        dict(name="rtc", route="cuda", source="tests/_torch_rtc_sources.py",
             launcher="mxnet_tpu_torch/rtc.py",
             kernel="gelu_fwd<__nv_bfloat16>",
             replaces="mxnet_tpu/rtc.py:29",
             launches=mlp["launches"] + fused_train["mlp"]["phase"][
                 "launches"] + fused_train["mlp"]["fused"]["launches"] +
             opt19["all"]["launches"],
             max_abs_err=gelu["max_abs_err"], ms=gelu["ms"],
             plain_ms=gelu["plain_ms"], bound_ms=gelu["bound_ms"],
             bound_by=gelu["bound_by"], library_ms=gelu["library_ms"],
             queued_ms=gelu["queued_ms"],
             library_queued_ms=gelu["library_queued_ms"],
             host_us=rtc["launch_us"], host_floor_us=rtc["host_floor_us"],
             torch_launch_us=rtc["torch_launch_us"]),
    ]
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"),
              "w") as fh:
        json.dump(dict(card=card, build_s=secs, k4=k4, k1=k1, k23=k23,
                       k1_design=k1_design, k2_design=k2_design,
                       k3_design=k3_design, k6_design=k6_design,
                       k5_design=k5_design,
                       seed_word=seed_word,
                       serve=srv, train=train, bert=bert, k5=k5,
                       fused=fused, k6=k6, vision=vision, gluon=gluon,
                       rtc=rtc,
                       mlp=mlp, fused_train=fused_train, optimizers=opt19,
                       kernels=kernels),
                  fh, indent=1, default=str)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
