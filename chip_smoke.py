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
   11008 x 4096, the 4096 x 32000 head) and with the chunked prefill's
   1024 rows (the three projection shapes; per chunk layer) and with a
   verify's 40 rows (the projections and the head; per verify), two
   launches bit for bit, with kernel, plain, library (``x @
   wt.to(bf16)``) and bound times; per decode step for each pool;
   kernel and library by two timers,
   ``cuda_ms`` (the calls as the host enqueues them, the figure of every
   phase) and ``cuda_ms_queued`` (behind a spin kernel: the device's
   share of it);
4. K1 (flash forward) against its plain version in bf16 at the shape
   the serving prefill and the training step give it (8 rows, 12 heads,
   1024 tokens, head dim 64, causal), once more with a key mask and
   dropout, at Llama-7B's admission shape (4 x 32 heads x 1024, head
   dim 128, causal), and at the training shape with dropout 0.1, the seed a
   device word, and at phase 23.2's cross-attention (8 x 16 heads, 768
   queries over 1024 keys, ragged key mask, dropout 0 and 0.3), with
   kernel, plain, library
   (``scaled_dot_product_attention``) and bound times; two launches
   must agree bit for bit; first the design tag of the bf16 tensor-core
   kernel and its registers and spills from this run's ptxas report;
5. K2 and K3 (flash backward: dq; dk, dv, dbias) against their plain
   versions in bf16 at the training shape, and at 2 x 12 x 640 with a
   key mask, dbias and dropout 0.1, and at the training shape with
   dropout 0.1, and at phase 23.2's cross-attention (as in 4), with
   kernel, plain and bound times, and K1+K2+K3 forward
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
   through ``DecodeServer(weights="int8", pool_sizes=(4, 8))`` on its
   own thread — six ragged greedy requests, the 700-token one arriving
   after the others were admitted, so its wave runs K1 (a 1024 bucket);
   every decode step is one CUDA-graph replay that runs K4 49 times (a
   replay counted by what its capture recorded) — held against the
   port's own batch-1 ``kv_generate`` (first tokens equal, whole-stream
   agreement >= 0.9); then two arms of the same requests pump-driven,
   the captured step and the eager step (the program's own function):
   streams equal token for token, tokens/s, ms a step, host us a step
   call, capture seconds, kernel nodes by name, the busy share of one
   profiled replay; then once more under ``torch.profiler`` for the
   device time by kernel; then (6c) where a bf16 stream parts from its
   batch-1 twin: request 1's prompt through ``kv_generate`` at batch 1, 4
   and 8, int8 and native, the first differing token and, teacher-forced,
   the first layer and output whose row 0 differs; then the same weights
   in float32 in one wave, held as the bf16 run;
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
   steps or more, a near-tie filter); K5 alone at full
   depth; a fused
   token split by CUDA events into the embedding, K5, ln_f + the head
   (K4 with int8) and the argmax, beside the run's ms a token;
12b. the fourteenth slice: Llama-7B at full width and ``L7_SERVED_LAYERS``
   of its 32 layers (bf16; cut from the full depth to keep the script
   inside its time limit; seeded as phase 12's) through
   ``DecodeServer(weights="int8",
   pool_sizes=(4, 8), max_total_len=2048, prefill_buckets=16...1024)``,
   page 16, greedy, 32 new tokens a request, on its own thread: prompts
   of 7, 100 and 700 tokens (the 700 late: the pool grows), one of 1800
   (two chunks), and a 512-token system prompt ``Sys``: ``Sys`` + 40,
   then ``Sys`` + 25 (a partial hit, its suffix chunked), then ``Sys``
   (a full hit with a copy-on-write page) and ``Sys`` + 1 (a full hit);
   K4 exactly 225 times a step and 224 a chunk, K1 at least once, each
   pool size's step captured once and no capture failed;
   ``chunk_dispatches >= 3``, ``prefix_hits >= 3``, ``cow_copies >= 1``,
   the full hits at zero admit and chunk dispatches; tokens/s, TTFT by
   kind, peak memory, pool bytes; then the same requests pump-driven
   (its waves do not follow thread timing), the same counters, and every
   stream teacher-forced against the port's int8 step fed as the server
   fed it >= 0.9: the prompt computed as served (a miss by its
   admission wave's batched prefill, a chunked prompt by its chunks, a
   hit by its producer's wave prefill, then its suffix or its step),
   each step on the rows of the server's step that made the token (4 or
   8), over the server's 2048-position horizon; printed beside it, every stream against the ``kv_generate``
   prefill with one-row and 8-row steps and against the served prompt
   with one-row steps, over the positions with a top-2 margin of
   ``TIE_STEPS``+ bf16 steps too, and the largest logit gap between the
   one-row and 8-row ``kv_generate`` references (phase 12c's bar); the
   captured and eager arms as in phase 6; then the same requests on a 4-layer full-width Llama in
   f32, agreement 1.0 and every first token equal (phases 6 and 12b, and
   ``serve_grow_ab.py``, serve with ``spec=False``: they count steps and
   K4's launches a step);
12c. the fifteenth slice: the same Llama-7B through ``DecodeServer(
   kv_dtype="int8")`` with speculation at its defaults (depth 4, k
   buckets 1, 2, 4), phase 12b's pools, horizon, buckets and requests
   and two repetitive prompts (a 32-token pattern repeated to 256 and to
   1024 tokens, 64 new each), on its own thread: an int8 page of
   4,202,496 B and the pool (pages + 1) of them; draft ledgers balanced
   per server and over the streams; verifies >= 1; K4 225 times a step
   and a verify, 224 a
   chunk, K1 at least once; every program called twice captured once,
   none failed; every stream teacher-forced against a batch-1 int8-KV
   reference of its kind (a one-slot ``PoolPrograms(kv_dtype="int8")``
   and its plain step), >= 0.9 over the positions with a top-2 margin of
   ``TIE_STEPS``+ bf16 steps, the raw figure beside it; then on the
   largest pool, every slot live: a captured verify equal to its eager
   function bit for bit (tokens, advance, slot vectors, codes and
   scales), its column 0 against the plain step within phase 12b's
   largest batch-1 against 8-row reference gap, emitted tokens its own
   argmax prefix, the written pages within half a code step + one bf16
   step of a native pool's; ms a replay of each k bucket and of the step,
   capture seconds, kernel nodes; tokens/s beside phase 12b's, tokens a
   dispatch, accept rate, TTFT by kind, pool bytes of both, peak memory;
   then the two repetitive prompts again with a drafter that proposes
   their batch-1 int8-KV reference's continuation (random weights
   continue neither the pattern nor themselves, so the n-gram drafter's
   proposals seldom come and do not land): drafts accepted on both;
   then phase 12b's 4-layer f32 Llama pump-driven: spec on (drafts: the
   spec-off streams' own continuations) equal to spec off token for
   token, and int8 KV with spec >= 0.9 teacher-forced against native KV
   over the clear positions of the streams (each stream's raw figure and
   the margins where it parts beside it);
12d. the sixteenth slice: the same Llama-7B (int8 weights, pools 4 and
   8, horizon 2048, page 16, spec off unless said) through the server's
   fault tolerance and telemetry: (1) phase 12b's requests pump-driven
   under a fake clock (one second a pump), undisturbed and with a 12 s
   deadline on the 100-token miss: it retires mid-decode, reason
   ``deadline_exceeded``, a prefix of its undisturbed run, the other
   streams equal token for token, the same steps, K4 225 a step and 224
   a chunk, one capture a pool size; (2) the same with the late 700-token
   miss cancelled from another thread: the others equal, a new request
   takes the freed slot and agrees >= 0.9 teacher-forced with its batch-1
   reference; (4) two replays of the captured 8-slot step at two clocks
   straddling slot 0's deadline retire it at the second only; (6) ms a
   bare replay of that step with deadlines on every slot and without
   (turns none, set, set, none), whole step calls too, kernel nodes,
   beside phase 12b's; (3) ``step_timeout=2.0`` on its own thread from
   cold with no watchdog event, then ``serve.step:delay:3:5``: one
   ``watchdog_fired`` within the timeout and one poll, every stream
   raising an ``MXNetError`` naming ``step_timeout``; (5) a budget of the
   4-slot pool and a 4-row admission's scratch refuses the growth to 8
   (requested against available bytes) while four streams finish equal
   to an unbudgeted 4-slot server's, ``pool_bytes`` the state tensors'
   bytes, the allocator's live bytes at least that; speculation on, one
   ``compile`` event a capture (kernel nodes in each), one TTFT
   observation a request, the counters in ``render_prometheus()``; after
   Llama-7B is freed, GPT-2 small with ``MXNET_SERVE_SYNC=1`` serves 7-,
   100- and 700-token prompts through ``kv_generate`` on the card, its
   streams and K1/K4 launches equal to three batch-1 calls';
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
20. the seventeenth slice, the reference's ``ops/nn.py`` ops as ``mx.nd``
   ops and ``hybrid_forward`` blocks: (1) every op that ``ops/nn.py`` and
   ``ops/attention.py`` register, at the tier-1 cases
   (``tests/_torch_nn_cases.py``), f32, card against CPU, outputs and
   input gradients (count per op family), and the host us of an
   ``mx.nd`` op beside its torch call; (2) the user's ``hybrid_forward``
   GPT-2 small (``tests/_torch_hybrid_models.gpt``: ``gluon.nn.
   Embedding``, ``LayerNorm``, ``F.FullyConnected``, ``F.flash_attention``
   with dropout 0.1, ``gluon.nn.GELU``, a tied head), bf16, 8 x 1024,
   AdamW multi-precision through ``gluon.Trainer``: 3 steps phase by
   phase, then 20 ``fused_step`` calls; K1, K2, K3 exactly 12 a step in
   both arms, one capture, losses finite, the first within 0.5 of
   ln(vocab), falling, every gradient nonzero after step 1; ms a step
   of both beside phase 7's; at 2 layers and dropout 0, three fused
   steps equal three phase-by-phase steps bit for bit; (3) the same
   model in f32 at 2 layers, 1 x 1024: loss and every gradient against
   the CPU (phase 16's bounds); (4) ResNet-50's conv2_x as
   ``hybrid_forward`` bottlenecks of ``F.Convolution``, ``F.BatchNorm``
   and ``F.Activation``, NHWC bf16 128 x 56 x 56 x 64 with
   ``MXNET_FUSED_CONV_BWD=1``: K6 exactly 7 a backward, output and every
   gradient equal bit for bit to the model zoo's stage;
21. the eighteenth slice, Gluon data and ``mx.io``: (1) an indexed
   RecordIO file of 1,536 raw 256 x 256 x 3 uint8 images from a seed
   (labels in [0, 1000)), about 300 MB in a temporary directory, read
   back through the port byte for byte; (2) phase 16's ResNet-50 (NHWC,
   bf16, SGD with momentum and multi-precision, ``MXNET_FUSED_CONV_BWD=1``)
   through ``gluon.Trainer.fused_step`` for one epoch of 12 steps fed by
   ``DataLoader(RecordFileDataset(rec).transform(...), batch_size=128,
   sampler=RandomSampler(1536, seed=21), last_batch="discard",
   num_workers=4, pin_memory=True, device=mx.gpu(), device_prefetch=2)``,
   each sample ``RandomCropAug(224)``, ``HorizontalFlipAug(0.5)``,
   ``CastAug``, ``ColorNormalizeAug`` (ImageNet's mean and std) on the
   host, the batch NHWC f32 cast to bf16 in the step: 30 K6 nodes in the
   step graph, one capture while the ring runs, losses finite, the first
   within 1.0 of ln(1000); (3) with centre crops, the ring's batches on
   the card equal the same loader's with ``device=mx.cpu()`` and
   ``num_workers=0`` bit for bit, and three fused steps fed from the ring
   equal three fed the same batches copied synchronously, losses and
   weights; (4) not gated: ms a step fed by the loader (steps 3-12)
   beside one resident batch, the loader alone in ms a batch,
   ``data_prefetch_stalls_total`` and the stall seconds, the device's
   busy share over fed steps (profiled), the ring's pinned and device
   bytes; (5) ``NDArrayIter`` over host arrays in
   ``PrefetchingIter(device=mx.gpu())``: batches on ``cuda:0`` bit for
   bit, ``pad`` and ``roll_over``, across a ``reset()``; (6) a worker past
   ``timeout`` raises naming the batch, ``MXNET_FAULT_INJECT`` at
   ``data.next`` raises through the ring, a loader closed midway leaves
   no live thread and drops its ledger entry, ``iter_from(3)`` after
   ``set_epoch(1)`` gives the rest of the epoch bit for bit, and
   ``mx.image.imdecode`` raises the reference's error where neither cv2
   nor PIL is installed (the backends found are printed);
22. the nineteenth slice, the detection and sampling ops, ``mx.nd.image``,
   ``mx.nd.contrib`` and the int8 quantization ops, with greedy NMS as
   one launch of ``csrc/box_nms.cu``: (1) GluonCV's
   ``ssd_512_resnet50_v1_voc`` (``tests/_torch_ssd_models.py``: ResNet-50
   v1 NHWC bf16, four extra stages, 6,132 anchors) trained from a
   256-image detection RecordIO file through ``image.ImageDetIter`` and
   8 ``Trainer.fused_step`` calls of 32 x 512 x 512 (SGD with momentum,
   multi-precision, ``MXNET_FUSED_CONV_BWD=1``), anchors, targets and
   loss inside the step: one capture, 34 K6 nodes, losses finite, the
   first class loss within 1.0 of ln 21, the step's targets equal to
   ``MultiBoxTarget`` run eagerly bit for bit and on the CPU; (2) its
   hybridized detection (softmax, ``MultiBoxDetection(threshold=0.01,
   nms_threshold=0.45, nms_topk=400)``) as one replay with the kernel a
   node of the graph, its rows equal to the plain ``box_nms`` on the same
   inputs bit for bit, again at ``nms_topk=-1``; ms a call, the kernel's
   ms, its bound; (3) Faster R-CNN's proposal head at 600 x 1000 (C4
   feature (1, 1024, 38, 63), RPN with A = 9, ``Proposal`` 6000 -> 0.7 ->
   300), ``ROIAlign`` 14 x 14 and ``ROIPooling`` 7 x 7 at 1/16: ROIs
   equal to the CPU's bit for bit in order, pooled outputs and data
   gradients within 1e-5 of the CPU's, peak memory printed; (4) the
   rest at full size card against CPU (spatial transformer, deformable
   convolution at G = 1 and 4, FlowNetC's correlation, fft/ifft, every
   ``mx.nd.image`` op on 32 x 512 x 512 x 3 uint8, the int8 products
   exactly);
23. the twentieth slice, sequence models: (1) Transformer-big on WMT14
   En-De widths (Vaswani et al. 2017 "big": 1024 units, FFN 4096, 16
   heads, 6 + 6 layers, a shared 37,000-token vocabulary, tied output,
   dropout 0.3, bf16 with f32 masters, Xavier from a seed) through
   ``Trainer.fused_step`` with Adam (0.9, 0.98, 1e-9) at the paper's
   warm-up rate set every step: 64 pairs of 16-128 tokens padded to 128,
   12 calls (one capture), the first loss a target token near ln 37000,
   K1-K3 launched 0 times (every product at most 512² scores); then 2 +
   2 layers at dropout 0, fused steps bit for bit with phase-by-phase
   ones; (2) the same model at 8 pairs of 640-1024 / 512-768 tokens
   padded to 1024 / 768: every attention through K1-K3, exactly 18 each
   a step, eager and replayed (the cross-attention's 768 x 1024 key-
   masked shape held in phases 4-5); (3) at 2 + 2 layers in f32 one
   step against the CPU and ``greedy_decode`` of 16 sources (16-64
   tokens, ``max_len`` 64) token for token, the 6 + 6 model's decode
   speed; (4) GluonNLP's ``standard_lstm_lm_650`` (``tests/
   _torch_lstm_models.py``: WikiText-2's 33,278 words, 650, 2 x LSTM
   650, dropout 0.5, tied) at 20 x 35: the recipe's eager loop (SGD lr
   20, ``clip_global_norm`` 0.25) and ``fused_step`` with
   ``clip_gradient`` 0.25, first losses near ln 33278, fused steps bit
   for bit with phase-by-phase ones at dropout 0, a 1-layer step against
   the CPU; (5) the ``linalg`` and ``legacy`` ops card against CPU at
   64 x 256² matrices, ResNet-50's first convolution and 8,192 x 37,000
   logits;
24. the twenty-first slice, the op corpus: (1) phase 14's ResNet-50
   (bf16, f32 master copies, ``MXNET_FUSED_CONV_BWD=1``) trained 10 steps
   as MXNet 1.x user code, ``record``/``backward`` then
   ``mx.nd.multi_mp_sgd_mom_update`` over the parameters in chunks of 4:
   K6 exactly 30 times a step and no other kernel, the first loss near
   ln 1000, three steps bit for bit with the per-parameter
   ``mx.nd.mp_sgd_mom_update`` loop; ms a step beside phase 18's
   ``fused_step`` arm; (2) every ``_random_*``/``sample_*`` op at 2**24
   f32 draws: moments within 6 standard errors, KS or chi-square at p >=
   1e-6, one seed the same draws, uniform and randint equal to the CPU's
   bit for bit; ``sample_multinomial(get_prob=True)`` at GPT-2's 50,257
   tokens (8 rows x 4,096 draws) beside ``torch.multinomial``; a
   hybridized reparameterization drawing ``mx.nd.random.normal``, fresh
   per key and equal under one; (3) every op of ``ops/extended.py``,
   ``ops/optimizer_ops.py`` and ``ops/samplers.py`` at the tier-1 cases
   card against CPU within 1e-5; ``multi_adamw_update`` and
   ``multi_lamb_update`` over GPT-2 small's parameters in f32;
   ``preloaded_multi_sgd_mom_update`` replayed in a CUDA graph after its
   ``lrs`` change, equal to the eager call;
25. the twenty-second slice, the training run's services: (1) the
   user's ``hybrid_forward`` GPT-2 small (12 layers, 768, 12 heads,
   50,257 tokens, 8 x 1024) in f32 under ``amp.init("float16")``, AdamW
   through ``amp.init_trainer``, ``amp.scale_loss`` around an eager
   ``record``/``backward``, every attention through K1-K3's fp16
   instantiation (12 each a step), in child processes: two uninterrupted
   8-step runs bit for bit with each other, one of them saving through
   ``CheckpointManager(async_save=True, max_to_keep=2)`` every 4 steps; a
   run killed by ``MXNET_FAULT_INJECT=checkpoint.save:kill:2`` inside its
   second save, and a run that restores the newest verifiable step (4),
   reports and sweeps the dead save's temp directory
   (``checkpoint_corrupt``) and runs to step 8: its losses, loss scale,
   skipped steps and every weight equal the uninterrupted run's bit for
   bit; (2) the same model in bf16 with f32 masters, dropout 0.1,
   ``Trainer(update_interval=2)`` through ``fused_step``: saved at
   micro-batch 5 (mid-window), run on, restored in place (ring, weights,
   states and generators written, no new program or capture) and
   replayed bit for bit; a bf16 weight read from the manifest's file
   with numpy equals the live one; (3) logistic regression at LIBSVM
   avazu-app's 1,000,000 features on seeded CSR batches of 8,192 rows x
   24 nonzeros: ``sparse.dot(x, w) + b``, ``SigmoidBinaryCrossEntropyLoss``
   and SGD through ``gluon.Trainer``, 10 steps, card against CPU within
   1e-5; ``sparse.dot`` against the dense product at 1,024 x 65,536; the
   tier-1 csr/row_sparse cases card against CPU; (4) ``mx.profiler``
   over three 25.1 steps (``flash_attention`` 36 times,
   ``FullyConnected`` 75) and its device table listing K1-K3's fp16
   kernels; a ``MXNET_ENGINE_TYPE=NaiveEngine`` child's step 1 equal to
   the threaded run's bit for bit; K1-K3's fp16 instantiations are also
   held against their plain versions in phases 4 and 5 (GPT-2's shape,
   dropout 0 and 0.1), two launches bit for bit, beside
   ``scaled_dot_product_attention`` in fp16; the phase's seconds and the
   whole script's;
26. the twenty-third slice, vision breadth: (1) one member of each
   model-zoo family at its published widths and input (``alexnet``,
   ``vgg16_bn``, ``squeezenet1.1``, ``densenet121``, ``mobilenet1.0``,
   ``mobilenetv2_1.0`` at 224², ``inceptionv3`` at 299², 1000 classes):
   (a) in f32 at batch 2 with TF32 off, built on the CPU and carried to
   the card by ``models.convert``, the predict-mode logits and the
   weights after one SGD step recorded with ``train_mode=False`` card
   against CPU within 1e-4 of the largest magnitude; (b) in bf16 with f32
   masters at batch 64, hybridized, 4 SGD-momentum steps through
   ``Trainer.fused_step``: ms a step (3-4), images/s, peak bytes, one
   capture, the replay's kernel nodes, the first loss within 3 of ln
   1000, every loss finite, and for the MobileNets the grouped
   convolutions' share of a replay's device time; (2) ResNet-50 v1 NHWC
   bf16 at 128 x 224² fitted by ``gluon.contrib.estimator.Estimator(...,
   fused_step=True)`` with ``MXNET_FUSED_CONV_BWD=1`` (K6 30 a step):
   ``Accuracy`` and ``Loss``, a ``ValidationHandler`` over 2 batches, an
   ``AtomicCheckpointHandler`` every 4 batches (``build/phase26/``), one
   epoch of 12 seeded-image batches through a ``DataLoader``; a second
   estimator resumes from the batch-8 checkpoint and its batches 9-12
   (loss, predictions, weights, cursor) equal the uninterrupted run's
   bit for bit; ms a batch beside phase 18's fused step and the metric
   handlers' host reads a batch; (3) ``Conv2DLSTMCell`` unrolled 10
   steps at Moving MNIST's ConvLSTM shape (16 x 16 x 16 patches, 64
   hidden, 5 x 5) card against CPU within 1e-4, ``PixelShuffle2D`` card
   equal to CPU, ``SyncBatchNorm`` equal to ``BatchNorm`` bit for bit,
   an ``Orthogonal`` (1024, 1024) with ``W Wᵀ`` within 1e-5 of scale² I;
   the phase's seconds and the script's;
27. the twenty-fourth slice, the symbolic surface (``build/phase27/``):
   (1) ResNet-50 v1 NHWC f32 from the model zoo, exported by
   ``HybridBlock.export``, read back by ``mx.sym.load``,
   ``mx.sym.SoftmaxOutput`` appended, fitted by ``mx.mod.Module.fit`` for
   one epoch of 12 seeded 128 x 224² batches from an ``mx.io.NDArrayIter``
   (SGD with momentum 0.9, ``MXNET_FUSED_CONV_BWD=1``,
   ``mx.callback.Speedometer(128, 4)``, ``mx.callback.do_checkpoint``):
   K6 exactly 30 launches a batch and no other kernel of the port, the
   first loss within 1 of ln 1000, every loss finite, the first 3
   batches bit for bit with the same steps run eagerly on the source
   block, ``Module.load`` restoring the checkpoint bit for bit, ms a
   batch beside phase 18's, Speedometer's lines, and K6's f32 kernel
   timed at the nine shapes; (2) the user's ``hybrid_forward`` GPT-2
   small bf16 at 8 x 1024 exported and read back by
   ``SymbolBlock.imports``: its predict-mode logits bit for bit with the
   source block's (K1 12 a forward), and so an ``Executor`` from
   ``simple_bind``, a ``Predictor`` (eager, capture, replay) and its
   self-contained file, and ``amp.convert_model`` of the f32 export;
   ``viz.print_summary``'s total equal to ``collect_params()``'s
   elements; 3 AdamW ``fused_step``s of the imported block, hybridized
   (one capture, K1-K3 12 each a step), bit for bit with the source
   block's; (3) ``mx.mod.BucketingModule`` over sequence lengths 35 and
   70 of a 2-layer LSTM LM at ``standard_lstm_lm_650``'s widths built
   with ``mx.sym.RNN``: the buckets share their weights, the losses are
   finite, ms a step a bucket; (4) the phase's seconds and the
   script's;
28. one ``{"kernels": [...]}`` line, the card line, and as the last line
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
T_START = time.perf_counter()
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BF16_OPS_PER_S = 989e12            # dense bf16 tensor-core peak
F32_OPS_PER_S = 67e12              # f32 on the CUDA cores (no tensor cores)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def _stamp(what):
    """The script's seconds so far, after ``what``."""
    print(f"chip_smoke: {what} done at {time.perf_counter() - T_START:.2f} "
          f"s", flush=True)


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
    # the chunked prefill's projections (phase 12b): 1024 rows each
    chunk = dict(ms=0.0, queued_ms=0.0, plain_ms=0.0, library_ms=0.0,
                 library_queued_ms=0.0, bytes=0, ops=0)
    for name, K, O, calls in (("l7b_qkvo", 4096, 4096, 4),
                              ("l7b_gate_up", 4096, 11008, 2),
                              ("l7b_down", 11008, 4096, 1)):
        row = _k4_case(name, 1024, K, O, False, gen)
        out["shapes"].append(row)
        for k in chunk:
            chunk[k] += calls * row[k]
        torch.cuda.empty_cache()
    chunk["bound_ms"], chunk["bound_by"] = bound_ms(chunk["bytes"],
                                                    chunk["ops"])
    print(f"K4 per Llama-7B chunk layer (7 launches, 1024 rows): kernel_ms="
          f"{chunk['ms']:.5f} queued_ms={chunk['queued_ms']:.5f} plain_ms="
          f"{chunk['plain_ms']:.5f} library_ms={chunk['library_ms']:.5f} "
          f"library_queued_ms={chunk['library_queued_ms']:.5f} bound_ms="
          f"{chunk['bound_ms']:.5f} ({chunk['bound_by']})", flush=True)
    out["chunk_layer"] = chunk
    # a verify dispatch of phase 12c at its largest bucket: 8 slots x (1
    # + 4 drafts) = 40 rows through every projection of the 32 layers and
    # the head
    verify = dict(ms=0.0, queued_ms=0.0, plain_ms=0.0, library_ms=0.0,
                  library_queued_ms=0.0, bytes=0, ops=0)
    for name, K, O, calls in (("l7b_qkvo", 4096, 4096, 4 * 32),
                              ("l7b_gate_up", 4096, 11008, 2 * 32),
                              ("l7b_down", 11008, 4096, 32),
                              ("l7b_head", 4096, 32000, 1)):
        row = _k4_case(name, 40, K, O, False, gen)
        out["shapes"].append(row)
        for k in verify:
            verify[k] += calls * row[k]
        torch.cuda.empty_cache()
    verify["bound_ms"], verify["bound_by"] = bound_ms(verify["bytes"],
                                                      verify["ops"])
    print(f"K4 per Llama-7B verify (225 launches, 40 rows): kernel_ms="
          f"{verify['ms']:.5f} queued_ms={verify['queued_ms']:.5f} plain_ms="
          f"{verify['plain_ms']:.5f} library_ms={verify['library_ms']:.5f} "
          f"library_queued_ms={verify['library_queued_ms']:.5f} bound_ms="
          f"{verify['bound_ms']:.5f} ({verify['bound_by']})", flush=True)
    out["verify"] = verify
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

def _kmask(b, Lk):
    """A (b, 1, Lk) f32 key mask: row i masks its last 50 * i + 7 keys
    (rows 0 and 1 as the first slices' cases: the last 50 and 7)."""
    import torch

    km = torch.zeros((b, 1, Lk), device="cuda")
    for i in range(b):
        km[i, 0, Lk - (50 if i == 0 else 7 if i == 1 else 50 * i + 7):] = \
            -1e30
    return km


def check_k1(cfg, B):
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.attention import flash_fwd, flash_fwd_plain

    H0 = cfg.num_heads
    D0 = cfg.units // H0
    gen = torch.Generator(device="cuda").manual_seed(5)
    results = []
    # the dropout seed as the kernels read it: a device word
    word = torch.full((1,), 1234, dtype=torch.int64, device="cuda")
    cases = [("prefill_causal", B, H0, D0, 1024, 1024, True, False, 0.0),
             ("kmask_dropout", 2, H0, D0, 384, 384, False, True, 0.1),
             ("train_causal_dropout", B, H0, D0, 1024, 1024, True, False,
              0.1),
             # Llama-7B's first admission wave in phase 12b: 3 prompts
             # (7, 100, 552 tokens) in the A=4 bucket at P=1024
             ("llama7b_prefill_causal", 4, 32, 128, 1024, 1024, True,
              False, 0.0)] + [
             # phase 23.2's cross-attention (Transformer-big, 16 heads):
             # 768 target queries over 1024 padded source keys
             (f"cross_kmask_dropout{r}", *S2S_CROSS, False, True, r)
             for r in (0.0, S2S_BIG["dropout"])] + [
             # phase 25.1's amp float16 step: the fp16 instantiation at
             # GPT-2 small's training shape
             (f"fp16_train_causal{r}", B, H0, D0, 1024, 1024, True, False,
              r) for r in (0.0, 0.1)]
    for name, b, H, D, L, Lk, causal, masked, rate in cases:
        dt = torch.float16 if name.startswith("fp16") else torch.bfloat16
        # one rounding of the output: bf16's 2^-8, fp16's 2^-11
        tol = 2e-3 if dt == torch.float16 else 2e-2
        q, k, v = (torch.randn((b, H, n, D), generator=gen, device="cuda")
                   .to(dt) for n in (L, Lk, Lk))
        km = _kmask(b, Lk) if masked else None
        scale = D ** -0.5
        out, lse = flash_fwd(q, k, v, scale, causal, km, word, rate)
        ro, rl = flash_fwd_plain(q, k, v, scale, causal, km, word, rate)
        torch.cuda.synchronize()
        err = (out.float() - ro.float()).abs().max().item()
        lerr = (lse - rl).abs().max().item()
        if out.dtype != dt or not torch.isfinite(out.float()).all() or \
                err > tol or lerr > 1e-3:
            fail(f"K1 {name}: out max_abs_err {err} (tol {tol}), lse "
                 f"max_abs_err {lerr} (tol 1e-3)")
        # no atomics: a second launch repeats out and lse bit for bit
        out2, lse2 = flash_fwd(q, k, v, scale, causal, km, word, rate)
        if not (torch.equal(out, out2) and torch.equal(lse, lse2)):
            fail(f"K1 {name}: two launches differ")
        ms = cuda_ms(lambda i: flash_fwd(q, k, v, scale, causal, km, word,
                                         rate), 20)
        plain = cuda_ms(lambda i: flash_fwd_plain(q, k, v, scale, causal,
                                                  km, word, rate), 5)
        mask4 = None if km is None else km.reshape(b, 1, 1, Lk).to(dt)
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
              f"mask={masked} dropout={rate} {str(dt)[6:]}: out "
              f"max_abs_err={err:.3e} (tol {tol}) lse "
              f"max_abs_err={lerr:.3e} (tol 1e-3) "
              f"kernel_ms={ms:.5f} plain_ms={plain:.5f} library_ms="
              f"{lib:.5f} bound_ms={bms:.5f} ({by})", flush=True)
        results.append(dict(case=name, B=b, H=H, L=L, Lk=Lk, D=D,
                            dtype=str(dt)[6:],
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
    cases = [("train_causal", B, H, D, 1024, 1024, True, False, 0.0),
             ("ragged_kmask_dropout", 2, H, D, 640, 640, False, True, 0.1),
             ("train_causal_dropout", B, H, D, 1024, 1024, True, False,
              0.1)] + [
             # phase 23.2's cross-attention, as in check_k1
             (f"cross_kmask_dropout{r}", *S2S_CROSS, False, True, r)
             for r in (0.0, S2S_BIG["dropout"])] + [
             # phase 25.1's amp float16 step, as in check_k1
             (f"fp16_train_causal{r}", B, H, D, 1024, 1024, True, False, r)
             for r in (0.0, 0.1)]
    for name, b, H, D, L, Lk, causal, masked, rate in cases:
        dt = torch.float16 if name.startswith("fp16") else torch.bfloat16
        q, k, v = (torch.randn((b, H, n, D), generator=gen, device="cuda")
                   .to(dt) for n in (L, Lk, Lk))
        g = torch.randn((b, H, L, D), generator=gen,
                        device="cuda").to(dt)
        km = _kmask(b, Lk) if masked else None
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
        mask4 = None if km is None else bias.to(dt)

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
                   mask=masked, dropout=rate, dtype=str(dt)[6:],
                   max_abs_err={w: e for w, (e, _) in errs.items()},
                   tol={w: t for w, (_, t) in errs.items()},
                   k2=dict(ms=k2_ms, plain_ms=k2_plain, bound_ms=k2_bms,
                           bound_by=k2_by, library_ms=lib_bwd_ms),
                   k3=dict(ms=k3_ms, plain_ms=k3_plain, bound_ms=k3_bms,
                           bound_by=k3_by, library_ms=lib_bwd_ms),
                   fwd_bwd_ms=fb_ms, library_fwd_bwd_ms=lib_fb_ms)
        print(f"K2/K3 {name} B={b} H={H} L={L} Lk={Lk} D={D} causal="
              f"{causal} mask={masked} dropout={rate} {str(dt)[6:]}: "
              "max_abs_err "
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
ARM_STEPS = 20              # bare step calls of each arm


def _wait_thread(pred, what, timeout=600.0):
    """Wait for ``pred()`` while the server's own thread serves."""
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout:
            fail(f"{what}: timed out waiting for the server")
        time.sleep(0.001)


def _wait_pump(srv, what):
    """``wait(pred)`` for a pump-driven server: pump until ``pred()``."""
    def wait(pred):
        while not pred():
            if not srv.pump():
                fail(f"{what}: the server went idle before the wait ended")
    return wait


def _step_totals(srv):
    """Over every program ``srv`` served so far (each pool size's step and
    verify programs): what the replays launched less what the captures
    added to the kernels' counters (a capture runs nothing), by
    kernel."""
    out = {}
    for r in srv.program_records():
        for k, n in r["launches"].items():
            out[k] = out.get(k, 0) + n * r["replays"]
        for k, n in r["recorded"].items():
            out[k] = out.get(k, 0) - n
    return out


def _served_launches(srv, counts, before):
    """The kernels a serving run launched: the wrappers' counts (eager
    calls, captures) corrected by ``_step_totals`` over the run;
    ``before`` is ``_step_totals`` at the run's start."""
    after = _step_totals(srv)
    return {k: n + after.get(k, 0) - before.get(k, 0)
            for k, n in counts.items()}


def serve_run(model, scenario, what, threaded, counted=False, warm=1,
              keep=False, spec=False, setup=None, **kw):
    """One run of ``scenario(srv, wait)`` (it submits the requests and
    returns ``(prompts, streams, info)``) through ``DecodeServer(model,
    weights="int8", spec=spec, **kw)``, its own thread serving
    (``threaded``) or pump-driven.  Speculation is off unless asked for
    (``spec=None``: the server's default, on): the phases that count
    steps and K4's launches a step measure the plain step.  ``warm``
    warm-up requests first (allocator, cuBLAS and the captures of the
    pools they fill stay off the clock).  With
    ``counted`` the kernels' counts are set to 0 just before the
    requests and read just after, replays counted by what their capture
    recorded.  ``setup(srv)`` runs on the new server before anything is
    submitted (a fake clock, a pump wrapper).  Returns the
    prompts, tokens and a dict of counts and timings (``server`` too,
    open, with ``keep``)."""
    import torch
    from mxnet_tpu_torch.ops.attention import flash_fwd
    from mxnet_tpu_torch.ops.q8_matvec import q8_matvec
    from mxnet_tpu_torch.serve import DecodeServer

    srv = DecodeServer(model, weights="int8", autostart=threaded, spec=spec,
                       **kw)
    if setup is not None:
        setup(srv)
    wait = (lambda pred: _wait_thread(pred, what)) if threaded \
        else _wait_pump(srv, what)
    try:
        warm_up = [srv.submit([0] * 5, max_new_tokens=3)
                   for _ in range(warm)]
        wait(lambda: all(s.done for s in warm_up))
        srv.reset_counters()
        torch.cuda.synchronize()
        before = _step_totals(srv)
        if counted:
            q8_matvec.launches = 0
            flash_fwd.launches = 0
        t0 = time.perf_counter()
        prompts, streams, info = scenario(srv, wait)
        wait(lambda: all(s.done for s in streams))
        toks = [s.tokens(1) for s in streams]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run = dict(info, counters=dict(srv.counters), wall_s=wall,
                   ttft_s=[s.ttft for s in streams], stats=srv.stats(),
                   request_ids=[s.request_id for s in streams],
                   step_records=srv.step_records(),
                   program_records=srv.program_records(),
                   ledgers=[(s.draft_accepted, s.draft_rejected)
                            for s in streams],
                   admissions=[s.admission for s in streams],
                   last_token_s=[s.times[-1] if s.times else None
                                 for s in streams],
                   server_label=srv.telemetry_label,
                   tokens_per_s=sum(map(len, toks)) / wall)
        if counted:
            run["launches"] = _served_launches(
                srv, {"q8_matvec": q8_matvec.launches,
                      "flash_fwd": flash_fwd.launches}, before)
        run["steps"] = run["counters"]["step_dispatches"]
        run["ms_per_step"] = wall / max(run["steps"], 1) * 1e3
        if keep:
            run["server"] = srv
    finally:
        if not keep:
            srv.close(drain=False)
    return prompts, toks, run


def gpt2_scenario(cfg, late=True):
    """Phase 6's six ragged requests; with ``late`` the 700-token one
    arrives after the first wave was admitted (a second wave, mid run)."""
    import numpy as np

    rs = np.random.RandomState(6)
    prompts = [rs.randint(0, cfg.vocab_size, (n,)) for n in PROMPT_LENS]
    last = PROMPT_LENS.index(max(PROMPT_LENS)) if late else None

    def scenario(srv, wait):
        streams = [None if i == last else
                   srv.submit(p, max_new_tokens=NEW_TOKENS)
                   for i, p in enumerate(prompts)]
        if last is not None:
            first = next(s for s in streams if s is not None)
            wait(lambda: bool(first.times))
            streams[last] = srv.submit(prompts[last],
                                       max_new_tokens=NEW_TOKENS)
        return prompts, streams, {}
    return scenario


def check_launches(run, what, per_step, per_chunk):
    """K4 exactly ``per_step`` times a decode step and ``per_chunk`` a
    chunk; K1 at least once; every pool size's step captured once, no
    capture failed."""
    for r in run["step_records"]:
        if r["captures"] != 1 or r["capture_failures"]:
            fail(f"{what}: the {r['S']}-slot pool's step was captured "
                 f"{r['captures']} times, {r['capture_failures']} captures "
                 "failed (want one capture a pool size)")
    steps, chunks = run["steps"], run["counters"]["chunk_dispatches"]
    launches = run["launches"]
    want = per_step * steps + per_chunk * chunks
    if launches["q8_matvec"] != want:
        fail(f"{what}: K4 launched {launches['q8_matvec']} times over "
             f"{steps} decode steps and {chunks} chunks, expected {want} "
             f"({per_step} a step, {per_chunk} a chunk)")
    if launches["flash_fwd"] <= 0:
        fail(f"{what}: K1 was never launched on the serving path")


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
    prompts, toks, run = serve_run(model, gpt2_scenario(cfg), "serve",
                                   threaded=True, counted=True,
                                   pool_sizes=(4, 8))
    print(f"serve: {len(prompts)} requests, prompt lens {PROMPT_LENS}, "
          f"{NEW_TOKENS} new tokens each; counters {run['counters']}; "
          f"launches {run['launches']} (replays counted by their "
          f"capture)", flush=True)
    check_launches(run, "serve", 4 * cfg.num_layers + 1, 4 * cfg.num_layers)
    ttft = run["ttft_s"]
    print(f"serve: tokens/s={run['tokens_per_s']:.2f} wall_s="
          f"{run['wall_s']:.4f} ttft_s mean={sum(ttft) / len(ttft):.4f} "
          f"max={max(ttft):.4f} steps={run['steps']} admits="
          f"{run['counters']['admit_dispatches']}", flush=True)
    run["agreement"] = check_streams(model, cfg, prompts, toks, "serve")
    run["arms"] = serving_arms(model, gpt2_scenario(cfg), "serve",
                               pool_sizes=(4, 8))
    return run


def step_arms(srv, what, steps=ARM_STEPS):
    """The captured and the eager arm of the largest pool's step, on an
    idle pool (every lane masked, an all-trash table: the same work as a
    live step), ``steps`` calls each, ms a step by the host clock after
    a sync: bare replays of the step graph (``graph.replay``) beside the
    step program's own function (``run``), with the median host us a
    call of each; then whole ``PoolPrograms.step`` calls (the table's
    copy, the replay, the readback's copies out of the graph), whose
    host time includes waiting for the table copy two steps back when
    the host runs ahead.  Capture seconds, the graph's kernel nodes by
    name (one more capture, kept for ``debug_dump``), the busy share of
    one profiled replay."""
    import numpy as np
    import torch

    progs = srv._progs
    prog = progs.step_program
    if prog is None or prog.graph is None:
        fail(f"{what}: the pool of {progs.S} slots has no captured step")
    trash = np.full((progs.S, progs.maxp), progs.sentinel, np.int64)
    progs.step(srv._state, trash)

    def arm(call):
        host = []
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            h0 = time.perf_counter()
            call()
            host.append(time.perf_counter() - h0)
        torch.cuda.synchronize()
        return ((time.perf_counter() - t0) / steps * 1e3,
                sorted(host)[len(host) // 2] * 1e6)

    captured_ms, captured_host = arm(prog.graph.replay)
    prog.replays += steps + 1
    eager_ms, eager_host = arm(prog.run)
    call_ms, call_host = arm(lambda: progs.step(srv._state, trash))
    nodes = prog.kernel_nodes()
    by_name, busy, wall_us = _profiled(prog.graph.replay)
    profile = report_profile(f"{what} replay profile", by_name, busy,
                             wall_us, top=6)
    row = dict(S=progs.S, captured_ms_per_step=captured_ms, profile=profile,
               captured_host_us=captured_host, eager_ms_per_step=eager_ms,
               eager_host_us=eager_host, step_call_ms=call_ms,
               step_call_host_us=call_host, capture_s=prog.capture_s,
               kernel_nodes=sum(nodes.values()), nodes_by_name=nodes,
               replay_busy=busy / wall_us if busy > 0 else None,
               replay_window_us=wall_us)
    top = sorted(nodes.items(), key=lambda kv: -kv[1])[:6]
    print(f"{what} step arms (S={progs.S}): captured {captured_ms:.3f} "
          f"ms/step (bare replays, host {captured_host:.1f} us a replay "
          f"call) beside eager {eager_ms:.3f} ms/step (the program's own "
          f"function, host {eager_host:.1f} us a call); whole step calls "
          f"{call_ms:.3f} ms/step, host {call_host:.1f} us a call; capture "
          f"{prog.capture_s:.3f} s; {row['kernel_nodes']} kernel nodes, by "
          "name " + "; ".join(f"{n[:48]} x{c}" for n, c in top)
          + "; one replay under torch.profiler: device busy "
          + (f"{row['replay_busy']:.4f} of {wall_us:.0f} us"
             if busy > 0 else "not measured (no device time recorded)"),
          flush=True)
    return row


def serving_arms(model, scenario, what, **kw):
    """The same requests served twice pump-driven (so both runs dispatch
    the same waves at the same steps), after a warm-up that fills the
    largest pool (so its step is captured before the clock starts):
    steps as graph replays, then as the step program's own function; the
    streams must be equal token for token.  Tokens/s and ms a step of
    both; then ``step_arms`` on the captured run's server."""
    from mxnet_tpu_torch.gluon.block import _GraphProgram

    runs = {}
    call = _GraphProgram.__call__
    for arm in ("captured", "eager"):
        if arm == "eager":      # every step runs its program's function
            _GraphProgram.__call__ = _GraphProgram.run
        try:
            _, toks, run = serve_run(model, scenario, f"{what} {arm}",
                                     threaded=False,
                                     warm=max(kw["pool_sizes"]),
                                     keep=arm == "captured", **kw)
        finally:
            _GraphProgram.__call__ = call
        runs[arm] = (toks, run)
    (ctoks, crun), (etoks, erun) = runs["captured"], runs["eager"]
    srv = crun.pop("server")
    try:
        if ctoks != etoks:
            bad = [i for i, (a, b) in enumerate(zip(ctoks, etoks)) if a != b]
            fail(f"{what}: captured and eager streams differ (requests "
                 f"{bad})")
        if crun["counters"] != erun["counters"]:
            fail(f"{what}: the arms dispatched differently: "
                 f"{crun['counters']} vs {erun['counters']}")
        row = step_arms(srv, what)
    finally:
        srv.close(drain=False)
    row.update(captured_tokens_per_s=crun["tokens_per_s"],
               eager_tokens_per_s=erun["tokens_per_s"],
               captured_run_ms_per_step=crun["ms_per_step"],
               eager_run_ms_per_step=erun["ms_per_step"],
               steps=crun["steps"], streams_equal=True)
    print(f"{what} arms: the same requests pump-driven, {crun['steps']} "
          f"steps each: captured {crun['tokens_per_s']:.2f} tokens/s "
          f"({crun['ms_per_step']:.3f} ms a step of the run) beside eager "
          f"{erun['tokens_per_s']:.2f} tokens/s ({erun['ms_per_step']:.3f});"
          f" streams equal token for token", flush=True)
    return row


# substrings of the library GEMM kernels' names (cuBLAS, cuBLASLt, CUTLASS)
GEMM_KEYS = ("gemm", "gemv", "xmma", "cutlass", "nvjet", "sm90_")


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
        lambda: serve_run(model, gpt2_scenario(cfg, late=False), "profile",
                          threaded=True, pool_sizes=(4, 8))))


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
    prompts, toks, _ = serve_run(model, gpt2_scenario(cfg, late=False),
                                 "serve_f32", threaded=True,
                                 pool_sizes=(4, 8))
    return check_streams(model, cfg, prompts, toks, "serve_f32")


def trace_drift(model, cfg):
    """Where a pooled bf16 stream leaves its batch-1 twin: request 1's
    prompt (100 tokens) through ``kv_generate`` at batch 1 and
    replicated at batch 4 and 8, int8 and native weights: the first new
    token where row 0 differs from batch 1.  Then the batch-1 stream
    teacher-forced through the prefill and the unfused step at batch 1
    and at batch B (and at the server's admission shape: 8 rows padded
    to the 128 bucket, the step at 8 rows), row 0 compared bit for bit:
    the first layer's K/V of the prefill, or the first projection output
    (``_DecodeEngine._lin``) of a step, that differs; the head's logits
    apart."""
    import numpy as np
    from mxnet_tpu_torch.models import kv_generate

    p = np.random.RandomState(6).randint(0, cfg.vocab_size,
                                         (PROMPT_LENS[1],))
    P = p.size
    out = {}
    for weights in ("int8", "native"):
        one = kv_generate(model, p[None], NEW_TOKENS, temperature=0.0,
                          weights=weights)[0]
        for B, pad in ((4, None), (8, None), (8, 128)):
            first_tok = rows_same = None
            if pad is None:
                many = kv_generate(model, np.repeat(p[None], B, 0),
                                   NEW_TOKENS, temperature=0.0,
                                   weights=weights)
                diff = np.nonzero(many[0, P:] != one[P:])[0]
                first_tok = int(diff[0]) if diff.size else None
                rows_same = bool((many == many[:1]).all())
            where = _first_parting(model, one, P, B, weights, pad)
            key = f"{weights} B={B}" + (f" P={pad}" if pad else "")
            out[key] = dict(first_differing_token=first_tok,
                            rows_equal=rows_same, **where)
            print(f"drift: {key}: first new token where row 0 differs "
                  f"from batch 1: "
                  + ("not run (the server's shape)" if pad else
                     f"{first_tok} (of {NEW_TOKENS}), rows equal each "
                     f"other: {rows_same}")
                  + f"; teacher-forced, the hidden states first part at "
                  f"{where['hidden']}, the head's logits first at "
                  f"{where['logits']}", flush=True)
    return out


def _first_parting(model, stream, P, B, weights, pad=None):
    """The batch-1 ``stream`` teacher-forced at batch 1 and at batch B
    (replicated; the prefill right-padded to ``pad`` if given): the
    first place row 0's hidden states differ bit for bit (a prefill
    layer's K/V, or a step's projection output) and the first place the
    head's logits do."""
    import torch
    from mxnet_tpu_torch.models.decoding import _DecodeEngine

    total = stream.size
    s = torch.as_tensor(stream, device="cuda").long()
    logs = {}
    for b in (1, B):
        eng = _DecodeEngine(model, 0.0, 0, weights)
        log = logs[b] = []
        lin = eng._lin

        def traced(x, i, kind, act_type=None, lin=lin, log=log):
            y = lin(x, i, kind, act_type)
            log.append(("hidden", f"layer {i} {kind}", y[0].clone()))
            return y

        eng._lin = traced
        toks = s[None].expand(b, -1)
        width = P if (pad is None or b == 1) else pad
        prompts = torch.zeros((b, width), dtype=torch.int64, device="cuda")
        prompts[:, :P] = toks[:, :P]
        last = torch.full((b,), P - 1, dtype=torch.int64, device="cuda")
        logits, knew, vnew = eng.prefill(prompts, last_index=last)
        for i in range(eng.NL):
            log.append(("hidden", f"layer {i} K", knew[i, 0, :, :P].clone()))
            log.append(("hidden", f"layer {i} V", vnew[i, 0, :, :P].clone()))
        log.append(("logits", "", logits[0].clone()))
        shape = (eng.NL, b + 1, eng.KV, total, eng.D)
        kp, vp = (torch.zeros(shape, dtype=eng.cdtype, device="cuda")
                  for _ in range(2))
        kp[:, :b, :, :P] = knew[:, :, :, :P]
        vp[:, :b, :, :P] = vnew[:, :, :, :P]
        pt = torch.arange(b, device="cuda")[:, None]
        for t in range(P, total - 1):
            log.append(("step", t, None))
            posv = torch.full((b,), t, dtype=torch.int64, device="cuda")
            lg = eng.paged_step(toks[:, t].contiguous(), posv, kp, vp, pt,
                                total)
            log.append(("logits", "", lg[0].clone()))
    found = {"hidden": "nowhere (bit for bit)",
             "logits": "nowhere (bit for bit)"}
    phase = "the prefill"
    for x, y in zip(logs[1], logs[B]):
        if x[0] == "step":
            phase = f"the step at position {x[1]}"
        elif found[x[0]].startswith("nowhere") and \
                not torch.equal(x[2], y[2]):
            found[x[0]] = f"{phase}, {x[1]}".rstrip(", ")
    return found


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
    prof = _grouped_profile("train", lambda: trainer.run_steps(
        data[None].expand(2, -1, -1), label[None].expand(2, -1, -1)), 2,
        top=10)
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


def teacher_forced(model, prompts, stream, weights, clear=None,
                   first=False, fill=None, keep=None, horizon=None,
                   widths=None):
    """Share of the fused stream's new tokens that the unfused step
    predicts when fed the stream's own earlier tokens (greedy): the
    prefill's argmax against the first new token, then one unfused step
    per position.  A single flip does not cascade here, as it does in a
    whole-stream comparison.  Where ``clear`` (a dict) is given, it gets
    the same share over the positions whose unfused top-2 logit margin is
    at least ``TIE_STEPS`` bf16 steps of the top logit (``agreement``)
    and their count (``positions``), and ``first_margin``, the first
    position's top-2 margin in bf16 steps of the top logit, per row.
    That is a near-tie filter, not a bound on rounding: at 32 layers a
    batch-1 and an 8-row reference differ by about 10 such steps.  With
    ``first`` it also returns
    whether every first new token equals the reference's.  ``fill(eng,
    s, kp, vp, pt)`` (default: the batched prefill) fills the rows' cache
    below ``P`` (one page of ``horizon`` positions a row, default the
    stream's length, then the trash page: each step attends over the
    whole page) and returns the logits of the first new token.  A
    ``keep`` list gets the (B, new, V) f32 logits.  ``widths`` (default
    B each) gives each step's rows (``_rows_step``: identical rows)."""
    import torch
    from mxnet_tpu_torch.models.decoding import _DecodeEngine

    eng = _DecodeEngine(model, 0.0, 0, weights)
    B, P = prompts.shape
    total = stream.shape[1]
    page = horizon or total
    s = torch.as_tensor(stream, device="cuda").long()
    shape = (eng.NL, B + 1, eng.KV, page, eng.D)
    kp, vp = (torch.zeros(shape, dtype=eng.cdtype, device="cuda")
              for _ in range(2))
    pt = torch.arange(B, device="cuda")[:, None]
    if fill is None:
        logits, knew, vnew = eng.prefill(s[:, :P])
        kp[:, :B, :, :P] = knew
        vp[:, :B, :, :P] = vnew
    else:
        logits = fill(eng, s[:, :P], kp, vp, pt)
    steps = [logits]
    for t in range(P, total - 1):
        w = B if widths is None else widths[t - P]
        steps.append(_rows_step(eng, s[:, t], t, kp, vp, pt, page, w))
    lg = torch.stack(steps, 1).float()                   # (B, new, V)
    if keep is not None:
        keep.append(lg)
    same = lg.argmax(-1) == s[:, P:]
    if clear is not None:
        top = lg.topk(2, dim=-1).values
        wide = (top[..., 0] - top[..., 1]) >= \
            TIE_STEPS * 2.0 ** -8 * top[..., 0].abs()
        clear["positions"] = int(wide.sum().item())
        clear["agreement"] = (same[wide].float().mean().item()
                              if clear["positions"] else None)
        clear["first_margin"] = ((top[:, 0, 0] - top[:, 0, 1]) /
                                 (2.0 ** -8 * top[:, 0, 0].abs())).tolist()
    rate = same.float().mean().item()
    if first:       # and whether every first new token is the prefill's
        return rate, bool(same[:, 0].all().item())
    return rate


def _rows_step(eng, tok, t, kp, vp, pt, page, w):
    """One step at position ``t`` of identical rows, computed on the
    first ``w`` of them (K4's row plan follows ``w``); the others get row
    0's new K/V column and its logits.  Returns (B, V) logits."""
    import torch

    B = tok.shape[0]
    posv = torch.full((w,), t, dtype=torch.int64, device="cuda")
    logits = eng.paged_step(tok[:w], posv, kp, vp, pt[:w], page)
    if w < B:
        kp[:, w:B, :, t] = kp[:, :1, :, t]
        vp[:, w:B, :, t] = vp[:, :1, :, t]
        logits = logits[:1].expand(B, -1)
    return logits


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


def check_llama7b(model, cfg):
    import numpy as np
    import torch

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
    # K5's packed stream goes; the unfused int8 codes stay for phase 12b
    for attr in ("_fused_pack_cache", "_q8_head_cache"):
        model.__dict__.pop(attr, None)
    torch.cuda.empty_cache()
    return runs


# --------------------------------------------------------------------------- #
# phase 12b: Llama-7B served, the fourteenth slice's path
# --------------------------------------------------------------------------- #

L7_BUCKETS = tuple(2 ** i for i in range(4, 11))     # 16 ... 1024
L7_TOTAL = 2048
L7_SERVED_LAYERS = 8        # phases 12b-12d: Llama-7B's width, 8 layers
L7_SYS = 512                # the shared system prompt


def llama_scenario(vocab, extra=(), deadline=None):
    """Ragged prompts of 7, 100 and 700 tokens (the 700 arriving after
    the first wave was admitted, so the pool grows 4 -> 8 and its
    admission rides the 1024 bucket through K1), one of 1800 (past the
    largest bucket: it chunks in over two dispatches), and a 512-token
    system prompt ``Sys``: first ``Sys`` + 40 tokens (its 34 full pages
    registered); once its first token has arrived, ``Sys`` + 25 other
    tokens (a partial hit: the suffix chunks in); once that one's first
    token has arrived, ``Sys`` exactly (a full hit, one copy-on-write
    page) and ``Sys`` + 1 token (a full hit, no copy).  ``extra``
    ((kind, prompt, new tokens), ...) arrive with the 700.  ``info``
    holds each request's kind and budget and the dispatch counters just
    before and just after the two full hits were admitted.  ``deadline``
    ``(i, seconds)`` gives request ``i`` that deadline at ``submit``."""
    import numpy as np

    rs = np.random.RandomState(14)
    draw = lambda n: rs.randint(0, vocab, (n,))          # noqa: E731
    sys_p = draw(L7_SYS)
    first = [("miss", draw(7)), ("miss", draw(100)), ("chunked", draw(1800)),
             ("miss", np.concatenate([sys_p, draw(40)]))]
    late = ("miss", draw(700))
    partial = ("partial hit", np.concatenate([sys_p, draw(25)]))
    full = [("full hit", sys_p.copy()),
            ("full hit", np.concatenate([sys_p, draw(1)]))]

    def scenario(srv, wait):
        kinds, prompts, streams, news = [], [], [], []

        def submit(kind, p, new=NEW_TOKENS):
            dl = deadline[1] if deadline is not None and \
                deadline[0] == len(streams) else None
            kinds.append(kind)
            prompts.append(p)
            news.append(new)
            streams.append(srv.submit(p, max_new_tokens=new, deadline=dl))

        for kind, p in first:
            submit(kind, p)
        wait(lambda: bool(streams[0].times))
        submit(*late)
        for e in extra:
            submit(*e)
        wait(lambda: bool(streams[3].times))
        submit(*partial)
        wait(lambda: all(s.times for s in streams))
        before = dict(srv.counters)
        for kind, p in full:
            submit(kind, p)
        wait(lambda: all(s.times for s in streams))
        after = dict(srv.counters)
        shared = [L7_SYS if k == "partial hit" else 0 for k in kinds]
        return prompts, streams, dict(kinds=kinds, shared=shared,
                                      producer=3, before_full=before,
                                      after_full=after, news=news)
    return scenario


def _chunks(eng, s, off, kp, vp, pt, buckets):
    """Row 0's prompt ``s[0]`` from position ``off`` through
    ``chunk_tokens`` over the server's chunks (the largest bucket until
    the rest fits one); returns the logits (1, V) of its last token."""
    import torch

    L, page = s.shape[1], kp.shape[3]
    while True:
        rem = L - off
        final = rem <= buckets[-1]
        C = next(b for b in buckets if b >= rem) if final else buckets[-1]
        n = rem if final else C
        toks = torch.zeros((C,), dtype=torch.int64, device="cuda")
        toks[:n] = s[0, off:off + n]
        lg = eng.chunk_tokens(toks, off, n - 1, pt[0], kp, vp, page)
        if final:
            return lg
        off += n


def _fill_as_served(kind, shared, buckets, pad):
    """A batch-1 ``teacher_forced`` fill that computes the prompt as the
    server does for a request of ``kind``: ``miss`` one batched prefill
    right-padded to its wave's bucket ``pad``; ``chunked``
    ``chunk_tokens`` over the server's chunks; ``partial hit`` the
    batched prefill of the ``shared`` cached tokens padded to their
    producer's bucket ``pad``, then the suffix in chunks; ``full hit``
    that prefill of all but the last token, then one step at ``L - 1``.
    (The reference's int8 chunk projects its K/V through K4 and a hit's
    first token comes from the step, where ``kv_generate`` runs a native
    prefill; and the bucket decides whether attention takes K1.)"""
    import torch

    def fill(eng, s, kp, vp, pt):
        L = s.shape[1]
        page = kp.shape[3]          # one page of ``total`` positions

        def prefill(n):
            toks = torch.zeros((1, max(n, pad)), dtype=torch.int64,
                               device="cuda")
            toks[:, :n] = s[:, :n]
            last = torch.full((1,), n - 1, dtype=torch.int64, device="cuda")
            logits, knew, vnew = eng.prefill(toks, last_index=last)
            kp[:, :1, :, :n] = knew[:, :, :, :n]
            vp[:, :1, :, :n] = vnew[:, :, :, :n]
            return logits

        def chunks(off):
            return _chunks(eng, s, off, kp, vp, pt, buckets)

        if kind == "miss":
            return prefill(L)
        if kind == "chunked":
            return chunks(0)
        if kind == "partial hit":
            prefill(shared)
            return chunks(shared)
        prefill(L - 1)
        posv = torch.full((1,), L - 1, dtype=torch.int64, device="cuda")
        return eng.paged_step(s[:, L - 1], posv, kp, vp, pt, page)
    return fill


L7_WIDTH = 8                # the grown pool's rows (K4's 8-row plan)


def _wave_prefill(eng, run, prompts, j):
    """Request ``j``'s admission wave prefilled as
    ``DecodeServer._dispatch_admit`` builds it: the wave's prompts in
    their rows of one ``(a_bucket, p_bucket)`` batch, the idle rows
    zeros read at column 0.  Returns request ``j``'s row: its logits
    (1, V) and K, V (NL, 1, KV, p_bucket, D)."""
    import numpy as np
    import torch

    adm = run["admissions"]
    a = adm[j]
    rows = {adm[k]["row"]: prompts[k] for k in range(len(prompts))
            if adm[k]["mode"] == "admit" and adm[k]["wave"] == a["wave"]}
    if sorted(rows) != list(range(len(rows))):
        fail(f"request {j}: its admission wave's rows {sorted(rows)} are "
             "not all among the run's requests")
    toks = np.zeros((a["a_bucket"], a["p_bucket"]), np.int64)
    true_len = np.ones((a["a_bucket"],), np.int64)
    for r, p in rows.items():
        toks[r, :p.size] = p
        true_len[r] = p.size
    logits, knew, vnew = eng.prefill(
        torch.as_tensor(toks, device="cuda"),
        last_index=torch.as_tensor(true_len - 1, device="cuda"))
    r = a["row"]
    return logits[r:r + 1], knew[:, r:r + 1], vnew[:, r:r + 1]


def _fill_as_admitted(run, prompts, i, buckets, width=None):
    """A ``teacher_forced`` fill of identical rows that computes request
    ``i``'s prompt as the server did for its kind: a ``miss`` by its
    admission wave's batched prefill (``_wave_prefill``), a ``chunked``
    prompt by ``chunk_tokens`` over the server's chunks, a ``partial
    hit`` by its producer's wave prefill below the shared length, then
    the suffix in chunks, a ``full hit`` by that prefill below ``L - 1``,
    then one step at ``L - 1`` on ``width`` rows (default all)."""
    kind, shared = run["kinds"][i], run["shared"][i]

    def fill(eng, s, kp, vp, pt):
        B, L = s.shape
        page = kp.shape[3]          # one page of the horizon a row

        def put(j, n):
            logits, knew, vnew = _wave_prefill(eng, run, prompts, j)
            kp[:, :B, :, :n] = knew[:, :, :, :n]
            vp[:, :B, :, :n] = vnew[:, :, :, :n]
            return logits.expand(B, -1)

        def chunks(off):
            # row 0 through the chunks, the other rows its copy
            lg = _chunks(eng, s, off, kp, vp, pt, buckets)
            kp[:, 1:B] = kp[:, :1]
            vp[:, 1:B] = vp[:, :1]
            return lg.expand(B, -1)

        if kind == "miss":
            return put(i, L)
        if kind == "chunked":
            return chunks(0)
        if kind == "partial hit":
            put(run["producer"], shared)
            return chunks(shared)
        put(run["producer"], L - 1)
        return _rows_step(eng, s[:, L - 1], L - 1, kp, vp, pt, page,
                          width or B)
    return fill


def _step_widths_recorder():
    """``(log, setup)``: ``setup(srv)`` makes every step dispatch of the
    server append its pool width and the request ids of the slots it
    steps to ``log``."""
    log = []

    def setup(srv):
        step = srv._dispatch_step

        def recorded():
            log.append((len(srv._slots),
                        {r.stream.request_id
                         for k, r in enumerate(srv._slots)
                         if r is not None and k not in srv._chunk_slots}))
            step()
        srv._dispatch_step = recorded
    return log, setup


def _stream_widths(log, run):
    """For each request of ``run``, the pool widths of the step
    dispatches that stepped it, in order (its tokens after the first, a
    hit's first too)."""
    return [[S for S, live in log if rid in live]
            for rid in run["request_ids"]]


def llama_served_checks(model, cfg, prompts, toks, run, what, bar):
    """Counters, full hits at zero prefill dispatches, every stream's
    budget and vocab; with a ``bar`` (None: those alone) teacher-forced
    agreement of at least ``bar`` over every stream (with ``bar`` 1.0,
    every first token equal too) against the port's int8 step fed as the
    server fed it: the prompt computed as served (``_fill_as_admitted``:
    its admission wave's batched prefill, its chunks, a hit's producer),
    each step on as many rows as the server's step that produced the
    token (``run["step_widths"]``, ``_step_widths_recorder``), over the
    server's horizon ``L7_TOTAL``.  Printed beside it, each stream against three
    more references, the stream's length their horizon: ``batch1``, the
    ``kv_generate`` prefill and one-row steps; ``wide``, the same at
    ``L7_WIDTH`` rows; ``prompt``, the served prompt and one-row steps.
    They split what moves a stream off the batch-1 reference between
    the prompt's computation and the steps' width; the largest logit gap
    between ``batch1`` and ``wide`` (in bf16 steps of the top logit) is
    phase 12c's bar.  Each also over the positions with a top-2 margin
    of ``TIE_STEPS``+ bf16 steps."""
    import numpy as np

    c = run["counters"]
    b, a = run["before_full"], run["after_full"]
    if c["chunk_dispatches"] < 3 or c["prefix_hits"] < 3 or \
            c["cow_copies"] < 1:
        fail(f"{what}: counters {c}: want chunk_dispatches >= 3, "
             "prefix_hits >= 3, cow_copies >= 1")
    full = {k: a[k] - b[k] for k in ("admit_dispatches", "chunk_dispatches",
                                     "prefix_hits", "cow_copies")}
    if full["admit_dispatches"] or full["chunk_dispatches"] or \
            full["prefix_hits"] != 2 or full["cow_copies"] != 1:
        fail(f"{what}: the two full hits dispatched {full}: want 0 admit "
             "and 0 chunk dispatches, 2 hits, 1 copy")
    for i, tk in enumerate(toks):
        if len(tk) != NEW_TOKENS or not all(0 <= x < cfg.vocab_size
                                            for x in tk):
            fail(f"{what}: request {i} emitted {len(tk)} of {NEW_TOKENS} "
                 "or a token outside the vocab")
    out = dict(full_hits=full)
    if bar is None:
        return out
    refs = ("batch1", "wide", "prompt", "served")
    sums = {k: [0.0, 0.0, 0] for k in refs}     # agreement, clear, positions
    firsts = dict.fromkeys(refs, True)
    gaps = []
    for i, (p, tk) in enumerate(zip(prompts, toks)):
        stream = np.concatenate([p, np.asarray(tk)])[None]
        # a hit's first token comes from a step too
        hit = int(run["kinds"][i] == "full hit")
        ws = run["step_widths"][i][:NEW_TOKENS - 1 + hit]
        if len(ws) < NEW_TOKENS - 1 + hit:
            fail(f"{what}: request {i} was stepped {len(ws)} times")
        got, lg = {}, {}
        for ref, rows, f, hz, sw in (
                ("batch1", 1, None, None, None),
                ("wide", L7_WIDTH, None, None, None),
                ("prompt", 1, _fill_as_admitted(run, prompts, i, L7_BUCKETS),
                 None, None),
                ("served", max(ws), _fill_as_admitted(
                    run, prompts, i, L7_BUCKETS, ws[0] if hit else None),
                 L7_TOTAL, ws[hit:])):
            clear, keep = {}, []
            rate, first = teacher_forced(
                model, np.repeat(p[None], rows, 0),
                np.repeat(stream, rows, 0), "int8", clear, first=True,
                fill=f, keep=keep, horizon=hz, widths=sw)
            got[ref] = (rate, first, clear)
            lg[ref] = keep[0][0]
            sums[ref][0] += rate * NEW_TOKENS
            if clear["positions"]:
                sums[ref][1] += clear["agreement"] * clear["positions"]
                sums[ref][2] += clear["positions"]
            firsts[ref] &= first
        top = lg["batch1"].topk(1, dim=-1).values[:, 0].abs()
        gaps.append(((lg["wide"] - lg["batch1"]).abs().max(-1).values /
                     (2.0 ** -8 * top)).max().item())
        del lg
        adm = run["admissions"][i]
        print(f"{what}: request {i} ({run['kinds'][i]}, prompt {p.size}, "
              f"admission {adm}, steps by pool width "
              f"{ {S: ws.count(S) for S in sorted(set(ws))} }): ttft "
              f"{run['ttft_s'][i]:.4f} s; "
              "teacher-forced agreement, first token equal, over the "
              f"positions with a top-2 margin of {TIE_STEPS}+ bf16 steps: "
              + "; ".join(f"{ref} {r:.4f}, {f1}, {cl['agreement']} of "
                          f"{cl['positions']}"
                          for ref, (r, f1, cl) in got.items())
              + f"; largest logit gap between batch1 and wide {gaps[-1]:.3f}"
              " bf16 steps", flush=True)
    n = NEW_TOKENS * len(prompts)
    rates = {k: v[0] / n for k, v in sums.items()}
    clears = {k: (v[1] / v[2] if v[2] else None) for k, v in sums.items()}
    print(f"{what}: teacher-forced agreement over every stream, gated "
          f"against the step fed as served (the prompt as the server "
          f"computed it, each step on the rows of the server's, horizon "
          f"{L7_TOTAL}): "
          f"{rates['served']:.4f} (bar {bar}), first tokens equal "
          f"{firsts['served']}; against the served prompt with one-row "
          f"steps {rates['prompt']:.4f}; against the kv_generate prefill "
          f"with one-row steps {rates['batch1']:.4f}, with {L7_WIDTH}-row "
          f"steps {rates['wide']:.4f}; over the positions with a top-2 "
          f"margin of {TIE_STEPS}+ bf16 steps {clears}; largest logit gap "
          f"between batch1 and wide {max(gaps):.3f} bf16 steps", flush=True)
    if rates["served"] < bar:
        fail(f"{what}: teacher-forced agreement {rates['served']:.4f} < "
             f"{bar} against the step fed as served")
    if bar >= 1.0 and not firsts["served"]:
        fail(f"{what}: a served first token differs from its reference")
    out.update(teacher_forced_gated=rates["served"], teacher_forced=rates,
               teacher_forced_clear=clears, first_tokens_equal=firsts,
               wide_gap_max=gaps)
    return out


def _ttft_by_kind(run):
    out = {}
    for kind, t in zip(run["kinds"], run["ttft_s"]):
        out.setdefault(kind, []).append(t)
    return out


def check_llama_served(model, cfg):
    """Phase 12b: Llama-7B (bf16, int8 weights, full width,
    ``L7_SERVED_LAYERS`` layers)
    through ``DecodeServer(pool_sizes=(4, 8), max_total_len=2048,
    prefill_buckets=16...1024)``, page 16, greedy, 32 new tokens a
    request: the counted threaded run (tokens/s, TTFT, launches and
    counters gated), then the same requests pump-driven, their counters
    and their teacher-forced agreement gated at 0.9 (a pump-driven run's
    waves do not follow thread timing), then the captured and eager
    arms; then a 4-layer full-width Llama in f32, the same requests,
    held to agreement 1.0."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    kw = dict(pool_sizes=(4, 8), max_total_len=L7_TOTAL,
              prefill_buckets=L7_BUCKETS, page_size=16)
    scenario = llama_scenario(cfg.vocab_size)
    prompts, toks, run = serve_run(model, scenario, "llama_7b served",
                                   threaded=True, counted=True, **kw)
    # the served run's peak (the checks below build their own caches)
    run["peak_memory"] = torch.cuda.max_memory_allocated()
    NL = cfg.num_layers
    print(f"llama_7b served: {len(prompts)} requests ({run['kinds']}), "
          f"prompt lens {[p.size for p in prompts]}; counters "
          f"{run['counters']}; launches {run['launches']} (replays counted "
          "by their capture)", flush=True)
    check_launches(run, "llama_7b served", 7 * NL + 1, 7 * NL)
    run.update(llama_served_checks(model, cfg, prompts, toks, run,
                                   "llama_7b served", None))
    log, setup = _step_widths_recorder()
    pprompts, ptoks, prun = serve_run(model, scenario,
                                      "llama_7b served pump-driven",
                                      threaded=False, setup=setup, **kw)
    prun["step_widths"] = _stream_widths(log, prun)
    run["pump"] = llama_served_checks(model, cfg, pprompts, ptoks, prun,
                                      "llama_7b served pump-driven", 0.9)
    run["pump"]["counters"] = prun["counters"]
    run["wide_gap_max"] = run["pump"]["wide_gap_max"]     # phase 12c's bar
    ttft = _ttft_by_kind(run)
    run["ttft_by_kind"] = ttft
    run["pool_bytes"] = run["stats"]["pool_bytes"]
    print(f"llama_7b served: tokens/s={run['tokens_per_s']:.2f} wall_s="
          f"{run['wall_s']:.4f} steps={run['steps']} ms a step of the run="
          f"{run['ms_per_step']:.3f}; ttft_s by kind "
          + "; ".join(f"{k} {', '.join(f'{t:.4f}' for t in v)}"
                      for k, v in ttft.items())
          + f"; peak memory of the served run {run['peak_memory']}; pool "
          f"bytes {run['pool_bytes']}", flush=True)
    run["arms"] = serving_arms(model, scenario, "llama_7b served", **kw)
    return run


def check_llama_served_f32():
    """The same requests on a 4-layer full-width Llama in float32: the
    served streams against the step fed as served, teacher-forced
    agreement 1.0 and every first token equal."""
    import torch
    from mxnet_tpu_torch.models import llama_7b

    model, cfg = llama_7b(dtype=torch.float32, num_layers=4)
    model.initialize(0.02, seed=0)
    log, setup = _step_widths_recorder()
    prompts, toks, run = serve_run(
        model, llama_scenario(cfg.vocab_size), "llama f32 served",
        threaded=True, setup=setup, pool_sizes=(4, 8),
        max_total_len=L7_TOTAL, prefill_buckets=L7_BUCKETS, page_size=16)
    run["step_widths"] = _stream_widths(log, run)
    out = llama_served_checks(model, cfg, prompts, toks, run,
                              "llama f32 served", 1.0)
    del model
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------- #
# phase 12c: Llama-7B on int8 KV pages with speculation, the fifteenth
# slice's path
# --------------------------------------------------------------------------- #

SPEC_NEW = 64               # new tokens of each repetitive prompt
# one int8 page (16 positions of 32 KV heads of 128), K and V, a layer
L7_PAGE_INT8 = 2 * L7_SERVED_LAYERS * 32 * (16 * 128 + 4)


def spec_extra(vocab):
    """Phase 12c's two repetitive prompts: a 32-token pattern repeated to
    256 tokens, another to 1024, 64 new tokens each."""
    import numpy as np

    rs = np.random.RandomState(15)
    return [("repeat", np.tile(rs.randint(0, vocab, (32,)), n // 32),
             SPEC_NEW) for n in (256, 1024)]


def _arrays(v):
    return v if isinstance(v, tuple) else (v,)


def _snapshot(state):
    return {n: tuple(a.clone() for a in _arrays(v))
            for n, v in state.items()}


def _restore(state, snap):
    for n, v in state.items():
        for a, b in zip(_arrays(v), snap[n]):
            a.copy_(b)


def int8_reference(model, p, kind, pad, new, tokens=None):
    """The batch-1 reference of a stream on a one-slot ``PoolPrograms(
    kv_dtype="int8")`` driven by its plain step (``_DecodeEngine.
    paged_step``), speculation off: fed ``tokens`` (teacher-forced) or,
    without them, its own greedy tokens.  The prompt enters as the
    server computed it for its kind: a miss (or a repetitive prompt) one
    prefill at its wave's bucket ``pad``, quantized into the pages the
    server reserves; a chunked prompt its chunks; a hit the producer's
    pages of the shared ``L7_SYS`` tokens (their prefill at the
    producer's bucket ``pad``), then the suffix's chunks (partial) or the
    step at ``L - 1`` (full).  Returns the f32 logits (new, V) and the
    ``new`` tokens fed (or chosen)."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.models.decoding import _DecodeEngine
    from mxnet_tpu_torch.serve.engine import PoolPrograms, pool_state_init

    eng = _DecodeEngine(model, 0.0, 0, "int8")
    progs = PoolPrograms(eng, 1, L7_TOTAL, 16, kv_dtype="int8")
    state = pool_state_init(progs)
    page, dev = progs.page, eng.device
    L = p.size
    s = torch.zeros((L + new,), dtype=torch.int64, device=dev)
    s[:L] = torch.as_tensor(p, device=dev)
    if tokens is not None:
        s[L:] = torch.as_tensor(np.asarray(tokens), device=dev)
    reserved = progs.pages_for(L + new)
    row = torch.full((progs.maxp,), progs.sentinel, dtype=torch.int64,
                     device=dev)
    row[:reserved] = torch.arange(reserved, device=dev)

    def prefill(n, k):
        P = max(n, pad)
        npb = -(-P // page)
        prompts = torch.zeros((1, P), dtype=torch.int64, device=dev)
        prompts[0, :n] = s[:n]
        tl = torch.full((1,), n, dtype=torch.int64, device=dev)
        pages = torch.full((1, npb), progs.sentinel, dtype=torch.int64,
                           device=dev)
        pages[0, :min(npb, k)] = row[:min(npb, k)]
        progs.admit(state, prompts, tl, [0], tl, torch.zeros_like(tl),
                    pages)
        return eng.prefill(prompts, last_index=tl - 1)[0]

    def chunks(off):
        while True:
            rem = L - off
            final = rem <= L7_BUCKETS[-1]
            C = next(b for b in L7_BUCKETS if b >= rem) if final \
                else L7_BUCKETS[-1]
            n = rem if final else C
            toks = torch.zeros((C,), dtype=torch.int64, device=dev)
            toks[:n] = s[off:off + n]
            lg = eng.chunk_tokens(toks, off, n - 1, row, state["kp"],
                                  state["vp"], page)
            if final:
                return lg
            off += n

    def step(t):
        posv = torch.full((1,), t, dtype=torch.int64, device=dev)
        return eng.paged_step(s[t:t + 1], posv, state["kp"], state["vp"],
                              row[None], page)

    if kind in ("miss", "repeat"):
        logits = prefill(L, reserved)
    elif kind == "chunked":
        logits = chunks(0)
    else:
        prefill(L7_SYS, L7_SYS // page)
        logits = chunks(L7_SYS) if kind == "partial hit" else step(L - 1)
    steps = [logits]
    for t in range(L, L + new):
        if tokens is None:
            s[t] = steps[-1][0].argmax()
        if t < L + new - 1:
            steps.append(step(t))
    return torch.cat(steps).float(), s[L:]


def teacher_forced_int8(model, p, tokens, kind, pad, new):
    """One served stream teacher-forced against its batch-1 int8-KV
    reference (``int8_reference``).  Returns (agreement, the agreement
    over the positions with a top-2 margin of ``TIE_STEPS``+ bf16 steps,
    their count)."""
    lg, fed = int8_reference(model, p, kind, pad, new, tokens)
    same = lg.argmax(-1) == fed
    top = lg.topk(2, dim=-1).values
    wide = (top[:, 0] - top[:, 1]) >= TIE_STEPS * 2.0 ** -8 * \
        top[:, 0].abs()
    n = int(wide.sum().item())
    return (same.float().mean().item(),
            same[wide].float().mean().item() if n else None, n)


def stream_drafter(streams):
    """A ``serve.Drafter`` that proposes, for a slot whose history (prompt
    and routed tokens) is a prefix of one of ``streams`` (1-D int
    arrays), that stream's next tokens, and nothing otherwise."""
    import numpy as np
    from mxnet_tpu_torch.serve import Drafter

    class StreamDrafter(Drafter):
        def propose(self, history, k):
            h = np.asarray(history)
            for s in streams:
                if h.size < s.size and np.array_equal(s[:h.size], h):
                    return [int(t) for t in s[h.size:h.size + k]]
            return []

    return StreamDrafter()


def spec_accept_run(model, cfg, card):
    """Phase 12c's two repetitive prompts served again in one wave,
    pump-driven, int8 KV pages and speculation on, with a drafter that
    proposes each prompt's batch-1 int8-KV reference continuation
    (``int8_reference`` at the wave's bucket, greedy): drafts accepted on
    both, the ledgers balanced; tokens a dispatch, the accept rate and
    each stream's agreement with its reference."""
    import numpy as np

    what = "llama_7b spec accept"
    extra = spec_extra(cfg.vocab_size)
    pad = next(b for b in L7_BUCKETS if b >= max(p.size for _, p, _ in
                                                 extra))
    refs = [np.concatenate([p, int8_reference(model, p, "repeat", pad,
                                              new)[1].cpu().numpy()])
            for _, p, new in extra]

    def scenario(srv, wait):
        return ([p for _, p, _ in extra],
                [srv.submit(p, max_new_tokens=new) for _, p, new in extra],
                {})

    prompts, toks, run = serve_run(
        model, scenario, what, threaded=False, spec=None,
        drafter=stream_drafter(refs), pool_sizes=(4, 8),
        max_total_len=L7_TOTAL, prefill_buckets=L7_BUCKETS, page_size=16,
        kv_dtype="int8")
    c = run["counters"]
    agree = [float(np.mean(np.asarray(t) == r[p.size:]))
             for p, t, r in zip(prompts, toks, refs)]
    total = sum(map(len, toks))
    tpd = total / (total - c["draft_accepted"])
    print(f"{what}: the repetitive prompts with the reference's "
          f"continuation as drafts: counters {c}; drafts accepted, rejected "
          f"by stream {run['ledgers']}; {tpd:.3f} tokens a dispatch (total "
          f"/ (total - accepted)); accept rate "
          f"{run['stats']['draft_accept_rate']:.4f}; streams equal to their "
          f"reference at {[round(a, 4) for a in agree]} of positions; "
          f"tokens/s {run['tokens_per_s']:.2f} [{card}]", flush=True)
    if c["draft_accepted"] + c["draft_rejected"] != c["draft_proposed"] or \
            any(a < 1 for a, _ in run["ledgers"]):
        fail(f"{what}: drafts accepted by stream {run['ledgers']} (want >= 1 "
             f"each), ledger {c}")
    return dict(counters=c, ledgers=run["ledgers"], agreement=agree,
                tokens_per_dispatch=tpd,
                accept_rate=run["stats"]["draft_accept_rate"],
                tokens_per_s=run["tokens_per_s"])


def spec_program_checks(srv, what, card, gap_bar):
    """On the served run's largest pool (idle, its state kept), every
    slot made live at its own depth over its own pages (their contents
    the run's): (1) the greedy chain of drafts for k = 4, each slot's
    broken at its own column, through the captured verify program and
    through its own function from one snapshot: tokens, ``adv``, every
    slot vector and the pools' codes and scales bit for bit; (2) the
    verify's column 0 against the plain step from that snapshot, in bf16
    steps of the step's top logit, within ``gap_bar`` (phase 12b's
    largest batch-1 against 8-row reference gap), and every emitted
    token the verify's own argmax prefix; (3) one plain step on the int8
    pool and on a native pool holding its dequantized pages: every
    column of the written pages within half a code step of its page's
    scale plus one bf16 step of the value; (4) ms a replay of each k
    bucket's verify beside the step's, capture seconds, kernel nodes."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.models.decoding import _kv_dequant

    progs, state = srv._progs, srv._state
    e, S, page = progs.eng, progs.S, progs.page
    dev, V = e.device, e.vocab
    rs = np.random.RandomState(16)
    pos = progs.Tp // 7 + np.arange(S) * (progs.Tp // 2 // S)
    rows = np.arange(S * progs.maxp).reshape(S, progs.maxp)
    k = max(srv.spec_sizes)
    nd = np.full((S,), k)
    with torch.no_grad():
        state["pos"].copy_(torch.as_tensor(pos))
        state["tok"].copy_(torch.as_tensor(rs.randint(0, V, (S,))))
        state["active"].fill_(True)
        state["stop"].copy_(torch.as_tensor(pos + progs.Tp // 8))
        state["spec"].fill_(k)
    torch.cuda.synchronize()
    base = _snapshot(state)
    pt = torch.as_tensor(rows, device=dev)
    posd = torch.as_tensor(pos, device=dev)

    def plain_verify(d):
        _restore(state, base)
        toks = torch.cat([state["tok"][:, None],
                          torch.as_tensor(d, device=dev)], 1)
        return e.pool_verify_paged(toks, posd, state["kp"], state["vp"], pt,
                                   page)

    # the model's own greedy chain, then slot s breaks it at column s % 5
    d = rs.randint(0, V, (S, k))
    for j in range(k):
        d[:, j] = plain_verify(d).argmax(-1)[:, j].cpu().numpy()
    for i in range(S):
        if i % (k + 1) < k:
            d[i, i % (k + 1)] = (d[i, i % (k + 1)] + 1) % V
    logits = plain_verify(d)
    # every bucket's verify (and the step) captured before the arms
    def captured(p):
        return p is not None and p.graph.calls >= 2

    for kk in srv.spec_sizes:
        while not captured(progs._verifies.get(kk)):
            _restore(state, base)
            progs.verify(state, rows, d[:, :kk], np.full((S,), kk), kk)
    while not captured(progs._step):
        _restore(state, base)
        progs.step(state, rows)
    prog = progs._verifies[k]
    _restore(state, base)
    got = [t.clone() for t in progs.verify(state, rows, d, nd, k)]
    torch.cuda.synchronize()
    after = _snapshot(state)
    _restore(state, base)
    eager = prog.graph.run()
    torch.cuda.synchronize()
    for name, a, b in zip(("out", "adv", "done"), got, eager):
        if not torch.equal(a, b):
            fail(f"{what}: captured and eager verify differ in {name}")
    for n, v in state.items():
        for a, b in zip(_arrays(v), after[n]):
            if not torch.equal(a, b):
                fail(f"{what}: captured and eager verify leave {n} "
                     "different")
    del after, eager
    torch.cuda.empty_cache()
    out, adv = got[0], got[1]
    if not torch.equal(out, logits.argmax(-1)):
        fail(f"{what}: the verify's tokens are not its logits' argmax")
    for i in range(S):
        n = int(adv[i])
        want = min((i % (k + 1)) + 1, k + 1)
        if n != want or not torch.equal(
                out[i, :n - 1].cpu(), torch.as_tensor(d[i, :n - 1])):
            fail(f"{what}: slot {i} advanced {n} (want {want}) or emitted "
                 "tokens that are not its drafts' accepted prefix")
    _restore(state, base)
    step = e.paged_step(state["tok"], posd, state["kp"], state["vp"], pt,
                        page)
    unit = 2.0 ** -8 * step.float().max(-1).values.abs()
    gap = ((logits[:, 0] - step).abs().max(-1).values / unit).tolist()
    print(f"{what}: captured verify (S={S}, k={k}) equals its eager "
          f"function bit for bit (tokens, adv {adv.tolist()}, slot vectors, "
          f"codes and scales); column 0 against the plain step, bf16 steps "
          f"of the top logit by slot: {[round(g, 3) for g in gap]} (bar "
          f"{gap_bar:.3f}, phase 12b's largest batch-1 against 8-row "
          f"reference gap) [{card}]", flush=True)
    if max(gap) > gap_bar:
        fail(f"{what}: verify column 0 is {max(gap):.3f} bf16 steps from "
             f"the plain step, past {gap_bar:.3f}")
    # (3) the representation: the same step on the int8 pool and on a
    # native pool of its dequantized pages
    _restore(state, base)
    native = [_kv_dequant(*state[n], e.cdtype) for n in ("kp", "vp")]
    e.paged_step(state["tok"], posd, native[0], native[1], pt, page)
    _restore(state, base)
    e.paged_step(state["tok"], posd, state["kp"], state["vp"], pt, page)
    pg = pt[torch.arange(S, device=dev), posd // page]
    worst = 0.0
    for name, ref in zip(("kp", "vp"), native):
        codes, scales = state[name]
        deq = _kv_dequant(codes[:, pg], scales[:, pg], torch.float32)
        want = ref[:, pg].float()
        ulp = 2.0 ** (torch.floor(torch.log2(want.abs().clamp(
            min=2.0 ** -126))) - 7)
        tol = scales[:, pg][..., None, None] / 2 + ulp
        worst = max(worst, ((deq - want).abs() / tol).max().item())
    del native
    torch.cuda.empty_cache()
    print(f"{what}: every column of the written pages against a native "
          f"pool's: the largest error is {worst:.4f} of half a code step + "
          f"one bf16 step (bar 1) [{card}]", flush=True)
    if worst > 1.0:
        fail(f"{what}: a column of a written page is {worst:.4f} times half "
             "a code step + one bf16 step from the native pool's")
    # (4) replays, capture seconds, kernel nodes
    rows_out = {}
    for key, p in [("step", progs._step)] + [
            (f"verify k={kk}", progs._verifies[kk])
            for kk in sorted(progs._verifies)]:
        g = p.graph
        _restore(state, base)
        ms = cuda_ms(lambda i: g.graph.replay(), 10)
        nodes = g.kernel_nodes()
        rows_out[key] = dict(ms=ms, capture_s=g.capture_s,
                             kernel_nodes=sum(nodes.values()),
                             launches=dict(g.launches))
        print(f"{what}: S={S} {key}: {ms:.3f} ms a replay, capture "
              f"{g.capture_s:.3f} s, {sum(nodes.values())} kernel nodes, "
              f"K4 {g.launches.get('q8_matvec')} a replay [{card}]",
              flush=True)
    _restore(state, base)
    return dict(gap=gap, gap_bar=gap_bar, adv=adv.tolist(),
                representation=worst, replays=rows_out)


def check_llama_spec(model, cfg, base):
    """Phase 12c: Llama-7B (bf16, int8 weights, full width,
    ``L7_SERVED_LAYERS`` layers)
    through ``DecodeServer(kv_dtype="int8")`` with speculation at its
    defaults (depth 4, buckets 1, 2, 4), phase 12b's pools, horizon and
    buckets, phase 12b's requests and two repetitive ones, on its own
    thread, counted: the gates of the issue (page price, draft ledgers,
    launches a step, verify and chunk, one capture per program that ran
    twice, streams teacher-forced against a batch-1 int8-KV reference),
    then ``spec_program_checks`` on its largest pool.  ``base`` is phase
    12b's run."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.serve.schema import slot_state_bytes

    card = card_line()
    what = "llama_7b spec"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kw = dict(pool_sizes=(4, 8), max_total_len=L7_TOTAL,
              prefill_buckets=L7_BUCKETS, page_size=16, kv_dtype="int8")
    scenario = llama_scenario(cfg.vocab_size, spec_extra(cfg.vocab_size))
    prompts, toks, run = serve_run(model, scenario, what, threaded=True,
                                   counted=True, keep=True, spec=None, **kw)
    run["peak_memory"] = torch.cuda.max_memory_allocated()
    # kept open, idle, for spec_program_checks (a close releases the
    # pool); its thread finds no work meanwhile
    srv = run.pop("server")
    NL = cfg.num_layers
    c, st = run["counters"], run["stats"]
    print(f"{what}: {len(prompts)} requests ({run['kinds']}), prompt lens "
          f"{[p.size for p in prompts]}; counters {c}; launches "
          f"{run['launches']} (replays counted by their capture) [{card}]",
          flush=True)
    # the pages (trash page included) and each slot's state columns
    slot_bytes = st["num_slots"] * slot_state_bytes()
    if st["page_bytes"] != L7_PAGE_INT8 or st["pool_bytes"] != \
            (st["pages_total"] + 1) * L7_PAGE_INT8 + slot_bytes:
        fail(f"{what}: page_bytes {st['page_bytes']} (want {L7_PAGE_INT8})"
             f", pool_bytes {st['pool_bytes']} for {st['pages_total']} + 1 "
             f"pages and {slot_bytes} B of slot state")
    acc, rej = c["draft_accepted"], c["draft_rejected"]
    sacc = sum(a for a, _ in run["ledgers"])
    srej = sum(r for _, r in run["ledgers"])
    if acc + rej != c["draft_proposed"] or (sacc, srej) != (acc, rej):
        fail(f"{what}: draft ledgers do not balance: server {acc} + {rej} "
             f"of {c['draft_proposed']}, streams {sacc} + {srej}")
    if c["verify_dispatches"] < 1:
        fail(f"{what}: no verify dispatch")
    for r in run["program_records"]:
        if r["captures"] != int(r["calls"] >= 2) or r["capture_failures"]:
            fail(f"{what}: program S={r['S']} k={r['k']} called "
                 f"{r['calls']} times was captured {r['captures']} times, "
                 f"{r['capture_failures']} captures failed")
    steps, verifies = run["steps"], c["verify_dispatches"]
    chunks = c["chunk_dispatches"]
    want = (7 * NL + 1) * (steps + verifies) + 7 * NL * chunks
    if run["launches"]["q8_matvec"] != want:
        fail(f"{what}: K4 launched {run['launches']['q8_matvec']} times over "
             f"{steps} steps, {verifies} verifies and {chunks} chunks, "
             f"expected {want} ({7 * NL + 1} a step and a verify, {7 * NL} "
             "a chunk)")
    if run["launches"]["flash_fwd"] <= 0:
        fail(f"{what}: K1 was never launched")
    # the streams against the batch-1 int8-KV reference of their kind
    clear = raw = n_clear = 0.0
    rates = []
    for i, (p, tk) in enumerate(zip(prompts, toks)):
        new = run["news"][i]
        if len(tk) != new or not all(0 <= x < cfg.vocab_size for x in tk):
            fail(f"{what}: request {i} emitted {len(tk)} of {new} or a "
                 "token outside the vocab")
        kind = run["kinds"][i]
        adm = run["admissions"][i]
        pad = (adm if adm["mode"] == "admit" else
               run["admissions"][run["producer"]]).get("p_bucket", 0)
        tf, tfc, nc = teacher_forced_int8(model, p, tk, kind, pad, new)
        raw += tf * new
        if nc:
            clear += tfc * nc
            n_clear += nc
        rates.append((tf, tfc, nc))
        a, r = run["ledgers"][i]
        print(f"{what}: request {i} ({kind}, prompt {p.size}, {new} new): "
              f"ttft {run['ttft_s'][i]:.4f} s; drafts accepted {a}, "
              f"rejected {r}; against the batch-1 int8-KV reference: "
              f"teacher-forced {tf:.4f}, over the {nc} positions with a "
              f"top-2 margin of {TIE_STEPS}+ bf16 steps {tfc}", flush=True)
    total = sum(run["news"])
    gate = clear / n_clear if n_clear else None
    print(f"{what}: teacher-forced agreement against the batch-1 int8-KV "
          f"reference over the {n_clear:.0f} positions with a top-2 margin "
          f"of {TIE_STEPS}+ bf16 steps {gate} (bar 0.9); raw {raw / total:.4f}"
          f" [{card}]", flush=True)
    if gate is None or gate < 0.9:
        fail(f"{what}: teacher-forced agreement {gate} < 0.9 over the "
             "clear positions")
    tpd = total / (total - acc)
    ttft = _ttft_by_kind(run)
    b = base
    row = dict(counters=c, launches=run["launches"], wall_s=run["wall_s"],
               tokens_per_s=run["tokens_per_s"], ttft_by_kind=ttft,
               tokens_per_dispatch=tpd,
               accept_rate=st["draft_accept_rate"],
               pool_bytes=st["pool_bytes"],
               page_bytes=st["page_bytes"], peak_memory=run["peak_memory"],
               teacher_forced_clear=gate, teacher_forced=raw / total,
               streams=rates, program_records=run["program_records"])
    print(f"{what}: tokens/s {run['tokens_per_s']:.2f} beside phase 12b's "
          f"{b['tokens_per_s']:.2f} (spec off, native KV; 12b's requests "
          f"alone); {tpd:.3f} tokens a dispatch (total / (total - "
          f"accepted); {total} tokens, {steps} steps + {verifies} "
          f"verifies); accept rate "
          f"{st['draft_accept_rate']:.4f}; ttft_s by kind "
          + "; ".join(f"{kd} {', '.join(f'{t:.4f}' for t in v)}"
                      for kd, v in ttft.items())
          + f"; pool bytes {st['pool_bytes']} against 12b's "
          f"{b['pool_bytes']} ({st['pool_bytes'] / b['pool_bytes']:.4f}); "
          f"page bytes {st['page_bytes']}; peak memory of the served run "
          f"{run['peak_memory']} (12b {b['peak_memory']}) [{card}]",
          flush=True)
    try:
        row["programs"] = spec_program_checks(
            srv, what, card, max(b["wide_gap_max"]))
    finally:
        srv.close(drain=False)
    del srv
    torch.cuda.empty_cache()
    row["accept"] = spec_accept_run(model, cfg, card)
    return row


def check_llama_spec_f32():
    """Phase 12c's requests on phase 12b's 4-layer full-width Llama in
    float32, pump-driven (the same waves in every arm): spec on equals
    spec off token for token (native KV), its drafts each spec-off
    stream's own continuation (``stream_drafter``), so that they land;
    with int8 KV and spec on (the same drafter), the streams
    teacher-forced against the batch-1 native-KV path of their kind
    agree >= 0.9 over the positions with a top-2 margin of ``TIE_STEPS``+
    bf16 steps (PARITY.md's pin; on these near-flat random logits the
    quantization flips near ties, so each stream's raw figure and the
    margins where it parts are printed beside it)."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.models import llama_7b

    card = card_line()
    model, cfg = llama_7b(dtype=torch.float32, num_layers=4)
    model.initialize(0.02, seed=0)
    scen = llama_scenario(cfg.vocab_size, spec_extra(cfg.vocab_size))
    kw = dict(pool_sizes=(4, 8), max_total_len=L7_TOTAL,
              prefill_buckets=L7_BUCKETS, page_size=16, threaded=False)
    prompts, off, _ = serve_run(model, scen, "llama f32 spec off", **kw)
    # drafts that land: each spec-off stream's own continuation
    kw["drafter"] = stream_drafter([np.concatenate([p, np.asarray(t)])
                                    for p, t in zip(prompts, off)])
    prompts, on, orun = serve_run(model, scen, "llama f32 spec", spec=None,
                                  **kw)
    if on != off:
        bad = [i for i, (a, b) in enumerate(zip(on, off)) if a != b]
        fail(f"llama f32 spec: spec-on streams differ from spec-off ones "
             f"(requests {bad})")
    _, q8, qrun = serve_run(model, scen, "llama f32 int8 spec", spec=None,
                            kv_dtype="int8", **kw)
    rates, clear_n, clear_sum = [], 0, 0.0
    for i, (p, tk) in enumerate(zip(prompts, q8)):
        kind = qrun["kinds"][i]
        adm = qrun["admissions"][i]
        pad = (adm if adm["mode"] == "admit" else
               qrun["admissions"][qrun["producer"]]).get("p_bucket", 0)
        stream = np.concatenate([p, np.asarray(tk)])[None]
        clear, keep = {}, []
        rate = teacher_forced(
            model, p[None], stream, "int8", clear, keep=keep,
            fill=_fill_as_served("miss" if kind == "repeat" else kind,
                                 qrun["shared"][i], L7_BUCKETS, pad))
        lg = keep[0][0]
        top = lg.topk(2, dim=-1).values
        margin = (top[:, 0] - top[:, 1]) / (2.0 ** -8 * top[:, 0].abs())
        flips = (lg.argmax(-1).cpu().numpy() != np.asarray(tk)).nonzero()[0]
        rates.append((rate, clear["agreement"], clear["positions"],
                      [round(margin[t].item(), 2) for t in flips]))
        if clear["positions"]:
            clear_n += clear["positions"]
            clear_sum += clear["agreement"] * clear["positions"]
    if orun["counters"]["draft_accepted"] < 1:
        fail("llama f32 spec: no draft was accepted")
    gate = clear_sum / clear_n if clear_n else None
    print(f"llama f32 spec: spec on equals spec off token for token over "
          f"{len(on)} streams ({orun['counters']['verify_dispatches']} "
          f"verifies, {orun['counters']['draft_accepted']} drafts of "
          f"{orun['counters']['draft_proposed']} accepted: the drafter "
          f"proposes the spec-off streams); int8 KV with spec, "
          f"teacher-forced against the native-KV path of each kind, by "
          f"stream (agreement, over the positions with a top-2 margin of "
          f"{TIE_STEPS}+ bf16 steps, their count, the margins in bf16 steps "
          f"where it parts): "
          f"{[(round(r, 4), c, n, m) for r, c, n, m in rates]}; over the "
          f"clear positions of every stream {gate} (bar 0.9) "
          f"[{card}]", flush=True)
    if gate is None or gate < 0.9:
        fail(f"llama f32 int8 spec: agreement {gate} < 0.9 with the "
             "native-KV reference over the clear positions")
    del model
    torch.cuda.empty_cache()
    return dict(spec_equal=True, int8_teacher_forced=rates,
                int8_teacher_forced_clear=gate,
                verifies=orun["counters"]["verify_dispatches"])


# --------------------------------------------------------------------------- #
# phase 12d: deadlines, cancellation, the watchdog, the HBM budget, sync mode
# and telemetry in DecodeServer, the sixteenth slice's path
# --------------------------------------------------------------------------- #

L7_DL_REQ = 1               # the request given a deadline: the 100-token miss
L7_DEADLINE = 12.0          # its deadline, fake seconds (one a pump)
L7_CANCEL_REQ = 4           # the request cancelled: the late 700-token miss
WATCH_TIMEOUT = 2.0         # the watchdog run's step_timeout
WATCH_POLL = 0.05           # the watchdog's poll (serve/server.py)
WEDGE_S = 5.0               # the injected delay of one step dispatch


def _ticking(srv):
    """``serve_run`` setup: a fake clock at the server's epoch that moves
    one second a pump (pump-driven runs), so that a deadline falls at the
    same step in every run."""
    clk = [srv._epoch]
    srv._clock = lambda: clk[0]
    real = srv.pump

    def pump():
        worked = real()
        clk[0] += 1.0
        return worked
    srv.pump = pump


def _server_events(kind, label):
    from mxnet_tpu_torch import telemetry

    return [e for e in telemetry.events(kind) if e.get("server") == label]


def _state_bytes(state):
    return sum(t.nbytes for v in state.values() for t in _arrays(v))


def cancel_scenario(vocab, new_prompt):
    """Phase 12b's requests; once all have a first token, request
    ``L7_CANCEL_REQ`` is cancelled from another thread, and after the
    cancel took effect a new request (``new_prompt``, a miss) is
    submitted: it takes the freed slot."""
    import threading

    base = llama_scenario(vocab)

    def scenario(srv, wait):
        prompts, streams, info = base(srv, wait)
        target = streams[L7_CANCEL_REQ]
        if target.done:
            fail("llama_7b cancel: the request to cancel finished first")
        slot = next(i for i, r in enumerate(srv._slots)
                    if r is not None and r.stream is target)
        th = threading.Thread(target=target.cancel)
        th.start()
        th.join()
        wait(lambda: target.done)
        free = [i for i, r in enumerate(srv._slots) if r is None]
        new = srv.submit(new_prompt, max_new_tokens=NEW_TOKENS)
        wait(lambda: bool(new.times))
        new_slot = next((i for i, r in enumerate(srv._slots)
                         if r is not None and r.stream is new), None)
        info.update(cancel_slot=slot, free_at_submit=free, new_slot=new_slot,
                    cancelled=target.cancelled,
                    kinds=info["kinds"] + ["miss"])
        return prompts + [new_prompt], streams + [new], info
    return scenario


def llama_deadline_cancel(model, cfg):
    """12d (1) and (2): phase 12b's requests pump-driven under a fake
    clock, undisturbed, with a deadline on one request, and with one
    cancelled from another thread; the deadline run's server is kept for
    (4) and (6)."""
    import numpy as np

    card = card_line()
    kw = dict(pool_sizes=(4, 8), max_total_len=L7_TOTAL,
              prefill_buckets=L7_BUCKETS, page_size=16, threaded=False,
              setup=_ticking)
    vocab = cfg.vocab_size
    NL = cfg.num_layers
    _, base, brun = serve_run(model, llama_scenario(vocab),
                              "llama_7b undisturbed", **kw)
    what = "llama_7b deadline"
    prompts, got, run = serve_run(
        model, llama_scenario(vocab, deadline=(L7_DL_REQ, L7_DEADLINE)),
        what, counted=True, keep=True, **kw)
    srv = run.pop("server")
    d = L7_DL_REQ
    check_launches(run, what, 7 * NL + 1, 7 * NL)
    others = [i for i in range(len(base)) if i != d and got[i] != base[i]]
    if others:
        fail(f"{what}: co-resident streams {others} differ from the "
             "undisturbed run")
    if not 0 < len(got[d]) < NEW_TOKENS or got[d] != base[d][:len(got[d])]:
        fail(f"{what}: the deadlined stream has {len(got[d])} tokens, not a "
             "proper prefix of its undisturbed run")
    label = run["server_label"]
    reasons = [e["reason"] for e in _server_events("serve_request", label)]
    dl_events = _server_events("deadline_exceeded", label)
    if reasons.count("deadline_exceeded") != 1 or len(dl_events) != 1 or \
            dl_events[0]["tokens"] != len(got[d]):
        fail(f"{what}: retire reasons {reasons}, deadline events "
             f"{dl_events}: want one deadline_exceeded with "
             f"{len(got[d])} tokens")
    # the steps no lane needed any more: those after every other stream's
    # last token, had the deadlined one been the last to finish
    last = brun["last_token_s"]
    saved_max = NEW_TOKENS - len(got[d])
    d_last = last[d] == max(last)
    saved = brun["steps"] - run["steps"]
    if saved < 0 or saved > saved_max or (not d_last and saved):
        fail(f"{what}: {run['steps']} steps against the undisturbed "
             f"{brun['steps']} (the deadlined stream finished "
             f"{'last' if d_last else 'before another'})")
    print(f"{what}: request {d} (prompt {prompts[d].size}) with a "
          f"{L7_DEADLINE} s deadline (fake clock, one second a pump) "
          f"retired after {len(got[d])} of {NEW_TOKENS} tokens, reason "
          f"deadline_exceeded, a prefix of its undisturbed run; the other "
          f"{len(base) - 1} streams equal the undisturbed run token for "
          f"token; steps {run['steps']} against {brun['steps']} undisturbed"
          f"; counters {run['counters']}; launches {run['launches']}; "
          f"captures by pool size "
          f"{[(r['S'], r['captures'], r['capture_failures']) for r in run['step_records']]}"
          f" [{card}]", flush=True)
    rs = np.random.RandomState(161)
    new_prompt = rs.randint(0, vocab, (60,))
    what = "llama_7b cancel"
    _, ctoks, crun = serve_run(model, cancel_scenario(vocab, new_prompt),
                               what, counted=True, **kw)
    c = L7_CANCEL_REQ
    others = [i for i in range(len(base)) if i != c and ctoks[i] != base[i]]
    if others:
        fail(f"{what}: streams {others} differ from the undisturbed run")
    if not crun["cancelled"] or not 0 < len(ctoks[c]) < NEW_TOKENS or \
            ctoks[c] != base[c][:len(ctoks[c])]:
        fail(f"{what}: the cancelled stream ({len(ctoks[c])} tokens) is not "
             "a sealed proper prefix of its undisturbed run")
    if crun["free_at_submit"] == [crun["cancel_slot"]] and \
            crun["new_slot"] != crun["cancel_slot"]:
        fail(f"{what}: the new request took slot {crun['new_slot']}, not "
             f"the freed slot {crun['cancel_slot']}")
    clear = {}
    stream = np.concatenate([new_prompt, np.asarray(ctoks[-1])])[None]
    tf, first = teacher_forced(model, new_prompt[None], stream, "int8",
                               clear, first=True)
    print(f"{what}: request {c} cancelled from another thread after "
          f"{len(ctoks[c])} tokens (a prefix of its undisturbed run); the "
          f"other {len(base) - 1} streams equal the undisturbed run; slots "
          f"free when the new request came {crun['free_at_submit']}, the "
          f"cancelled slot {crun['cancel_slot']}, the new request's slot "
          f"{crun['new_slot']}; its stream against the batch-1 kv_generate "
          f"prefill: teacher-forced {tf:.4f} (bar 0.9), first token equal "
          f"{first}, over the {clear['positions']} positions with a top-2 "
          f"margin of {TIE_STEPS}+ bf16 steps {clear['agreement']}; "
          f"launches {crun['launches']} [{card}]", flush=True)
    if tf < 0.9:
        fail(f"{what}: the new request's stream agrees {tf:.4f} < 0.9 with "
             "its batch-1 reference")
    return srv, dict(
        deadline=dict(tokens=len(got[d]), steps=run["steps"],
                      undisturbed_steps=brun["steps"],
                      counters=run["counters"], launches=run["launches"],
                      step_records=run["step_records"]),
        cancel=dict(tokens=len(ctoks[c]), new_slot=crun["new_slot"],
                    cancel_slot=crun["cancel_slot"],
                    free_at_submit=crun["free_at_submit"],
                    teacher_forced=tf, launches=crun["launches"],
                    counters=crun["counters"]),
        launches={k: run["launches"][k] + crun["launches"][k]
                  for k in run["launches"]})


def llama_clock_operand(srv):
    """12d (4): the captured step of the kept server's largest pool, every
    lane live on an all-trash table, slot 0's deadline at ``t``: a replay
    at ``now = t - 0.5`` retires nothing, the next at ``now = t`` retires
    slot 0 alone."""
    import numpy as np
    import torch

    progs, state = srv._progs, srv._state
    prog = progs.step_program
    if prog is None or prog.graph is None:
        fail("llama_7b clock: the largest pool's step is not captured")
    trash = np.full((progs.S, progs.maxp), progs.sentinel, np.int64)
    t = 100.0
    state["active"].fill_(True)
    state["stop"].fill_(L7_TOTAL)
    state["pos"].fill_(0)
    state["dl"].fill_(float("inf"))
    state["dl"][0] = t
    r0 = prog.replays
    d1 = progs.step(state, trash, t - 0.5)[2].cpu().tolist()
    d2 = progs.step(state, trash, t)[2].cpu().tolist()
    torch.cuda.synchronize()
    if any(d1) or d2 != [True] + [False] * (progs.S - 1) or \
            prog.replays != r0 + 2:
        fail(f"llama_7b clock: done flags {d1} then {d2} over "
             f"{prog.replays - r0} replays: want none, then slot 0 alone, "
             "over two replays")
    print(f"llama_7b clock: two replays of the captured {progs.S}-slot step "
          f"at now = {t - 0.5} and {t} (slot 0's deadline {t}): done {d1} "
          f"then {d2}", flush=True)
    return dict(done_first=d1, done_second=d2)


def llama_deadline_timing(srv, base_arms):
    """12d (6): ms a replay of the captured step of the largest pool on an
    idle all-trash table (phase 12b's measure), every slot's deadline set
    (finite) against none (+inf), in turns inf, set, set, inf; whole
    ``PoolPrograms.step`` calls too (their clock and table copies); the
    graph's kernel nodes beside phase 12b's."""
    import numpy as np
    import torch

    card = card_line()
    progs, state = srv._progs, srv._state
    prog = progs.step_program
    trash = np.full((progs.S, progs.maxp), progs.sentinel, np.int64)
    state["active"].fill_(False)

    def arm(call, steps=ARM_STEPS):
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            call()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / steps * 1e3

    out = {"none": [], "set": [], "call_none": [], "call_set": []}
    for key in ("none", "set", "set", "none"):
        state["dl"].fill_(float("inf") if key == "none" else 1e6)
        out[key].append(arm(prog.graph.replay))
        out["call_" + key].append(
            arm(lambda: progs.step(state, trash, 10.0)))
    prog.replays += 4 * (ARM_STEPS + 1)
    nodes = sum(prog.kernel_nodes().values())
    ms = {k: sum(v) / len(v) for k, v in out.items()}
    print(f"llama_7b deadline timing (S={progs.S}, idle lanes, bare replays "
          f"of the captured step): deadlines set on every slot "
          f"{[round(x, 3) for x in out['set']]} ms/step, none "
          f"{[round(x, 3) for x in out['none']]} ms/step (turns none, set, "
          f"set, none); whole step calls (clock and table copies) set "
          f"{[round(x, 3) for x in out['call_set']]}, none "
          f"{[round(x, 3) for x in out['call_none']]}; phase 12b's captured "
          f"step {base_arms['captured_ms_per_step']:.3f} ms/step in this "
          f"process; kernel nodes {nodes} beside phase 12b's "
          f"{base_arms['kernel_nodes']} [{card}]", flush=True)
    return dict(ms_per_step=ms, runs=out, kernel_nodes=nodes,
                base_ms_per_step=base_arms["captured_ms_per_step"],
                base_kernel_nodes=base_arms["kernel_nodes"])


def llama_watchdog(model, cfg):
    """12d (3): a threaded server with ``step_timeout=2.0`` serves phase
    12b's requests from cold (first calls, captures, a pool growth) with
    no watchdog event; then ``MXNET_FAULT_INJECT=serve.step:delay:3:5``
    wedges a step dispatch under four live streams: the watchdog fires
    once within the timeout and one poll of the wedge, and every stream
    raises an ``MXNetError`` naming ``step_timeout``."""
    import numpy as np
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.base import MXNetError

    card = card_line()
    what = "llama_7b watchdog"
    _, _, run = serve_run(model, llama_scenario(cfg.vocab_size), what,
                          threaded=True, warm=0, keep=True,
                          step_timeout=WATCH_TIMEOUT, pool_sizes=(4, 8),
                          max_total_len=L7_TOTAL, prefill_buckets=L7_BUCKETS,
                          page_size=16)
    srv = run.pop("server")
    label = srv.telemetry_label
    try:
        if _server_events("watchdog_fired", label) or srv._fatal is not None:
            fail(f"{what}: the watchdog fired while serving from cold "
                 f"({srv._fatal})")
        rs = np.random.RandomState(162)
        streams = [srv.submit(rs.randint(0, cfg.vocab_size, (n,)),
                              max_new_tokens=2 * NEW_TOKENS)
                   for n in (7, 100, 300, 40)]
        _wait_thread(lambda: all(s.times for s in streams), what)
        telemetry.reset_faults()
        os.environ["MXNET_FAULT_INJECT"] = f"serve.step:delay:3:{WEDGE_S}"
        errors = []
        try:
            for s in streams:
                try:
                    s.tokens(60)
                except MXNetError as e:
                    errors.append(str(e))
        finally:
            del os.environ["MXNET_FAULT_INJECT"]
        fired = _server_events("watchdog_fired", label)
        inj = [e for e in telemetry.events("fault_injected")
               if e.get("site") == "serve.step"]
        if len(errors) != len(streams) or \
                not all("step_timeout" in e for e in errors):
            fail(f"{what}: {len(errors)} of {len(streams)} streams failed "
                 f"naming step_timeout: {errors[:1]}")
        if len(fired) != 1 or not inj:
            fail(f"{what}: watchdog_fired emitted {len(fired)} times, "
                 f"{len(inj)} injected delays")
        latency = fired[0]["ts"] - inj[-1]["ts"]
        print(f"{what}: served phase 12b's {len(run['kinds'])} requests from "
              f"cold with step_timeout={WATCH_TIMEOUT} and no watchdog event "
              f"(captures {[(r['S'], r['k'], r['captures']) for r in run['program_records']]}, "
              f"pool grows {run['counters']['pool_grows']}); then a "
              f"{WEDGE_S} s delay injected at serve.step: watchdog_fired "
              f"once, {latency:.3f} s after the delay began (limit "
              f"{WATCH_TIMEOUT} + one poll {WATCH_POLL}); all "
              f"{len(streams)} streams raised: {errors[0][:120]}... "
              f"[{card}]", flush=True)
        if latency > WATCH_TIMEOUT + WATCH_POLL + 0.05:
            fail(f"{what}: the watchdog fired {latency:.3f} s after the "
                 f"wedge began, past {WATCH_TIMEOUT} s + one poll")
    finally:
        srv.close(drain=False)
        telemetry.reset_faults()
    return dict(latency_s=latency, errors=len(errors),
                pool_grows=run["counters"]["pool_grows"])


def llama_budget(model, cfg):
    """12d (5), the budget: four misses on ``pool_sizes=(4, 8)`` with a
    budget of the 4-slot pool plus a 4-row admission's scratch; a fifth
    request asks the pool to grow, which the budget refuses with an error
    naming requested against available bytes; it is cancelled and the
    four streams finish equal to the same requests on a 4-slot server
    without a budget.  ``stats()["pool_bytes"]`` equals the state's
    tensors' bytes, and the allocator's live bytes are at least that."""
    import numpy as np
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.models.decoding import _DecodeEngine
    from mxnet_tpu_torch.serve import (PoolPrograms, admit_scratch_bytes,
                                       pool_state_bytes)

    card = card_line()
    what = "llama_7b budget"
    rs = np.random.RandomState(163)
    prompts = [rs.randint(0, cfg.vocab_size, (n,)) for n in (7, 100, 700, 300)]
    kw = dict(max_total_len=L7_TOTAL, prefill_buckets=L7_BUCKETS,
              page_size=16, threaded=False)

    def plain(srv, wait):
        return prompts, [srv.submit(p, max_new_tokens=NEW_TOKENS)
                         for p in prompts], {}

    _, ref, _ = serve_run(model, plain, f"{what} reference", pool_sizes=(4,),
                          **kw)
    progs = PoolPrograms(_DecodeEngine(model, 0.0, 0, "int8"), 4, L7_TOTAL, 16)
    budget = pool_state_bytes(progs) + admit_scratch_bytes(progs, 4)
    growth = pool_state_bytes(progs, 8) + pool_state_bytes(progs)
    del progs
    refusal = {}

    def scenario(srv, wait):
        streams = [srv.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
        wait(lambda: all(s.times for s in streams))
        extra = srv.submit(prompts[0], max_new_tokens=8)
        try:
            srv.pump()
        except MXNetError as e:
            refusal["msg"] = str(e)
        extra.cancel()
        st = srv.stats()
        refusal.update(pool_bytes=st["pool_bytes"],
                       state_bytes=_state_bytes(srv._state),
                       live=telemetry.live_device_bytes().get("cuda:0", 0),
                       num_slots=st["num_slots"])
        return prompts, streams, {}

    _, got, run = serve_run(model, scenario, what, pool_sizes=(4, 8),
                            hbm_budget=budget, **kw)
    msg = refusal.get("msg", "")
    if "pool growth 4 -> 8" not in msg or "requests" not in msg or \
            "remains" not in msg:
        fail(f"{what}: the growth under a {budget} B budget (the growth "
             f"prices {growth} B) was not refused as expected: {msg!r}")
    if got != ref:
        fail(f"{what}: the 4-slot streams differ from the same requests "
             "without a budget")
    if refusal["pool_bytes"] != refusal["state_bytes"] or \
            refusal["live"] < refusal["pool_bytes"] or \
            refusal["num_slots"] != 4:
        fail(f"{what}: pool_bytes {refusal['pool_bytes']}, state tensors "
             f"{refusal['state_bytes']}, live {refusal['live']}, slots "
             f"{refusal['num_slots']}")
    print(f"{what}: budget {budget} B (the 4-slot pool and a 4-row "
          f"admission's scratch), the growth to 8 prices {growth} B: "
          f"refused: {msg[:160]}...; the four streams equal the same "
          f"requests without a budget; pool_bytes {refusal['pool_bytes']} = "
          f"the state tensors' bytes, allocator live bytes "
          f"{refusal['live']} [{card}]", flush=True)
    return dict(budget=budget, growth_bytes=growth, refusal=msg,
                pool_bytes=refusal["pool_bytes"], live_bytes=refusal["live"])


def gpt2_sync():
    """12d (5), sync mode: GPT-2 small (bf16, int8 weights, seeded
    Normal(0.02)) with ``MXNET_SERVE_SYNC=1`` serves three requests (7,
    100 and 700 prompt tokens, 32 new) through ``kv_generate`` on the
    card, counted; the streams and the K1 and K4 launches equal three
    batch-1 ``kv_generate`` calls'."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.models import gpt2_small, kv_generate
    from mxnet_tpu_torch.serve import DecodeServer

    card = card_line()
    what = "gpt2 sync"
    model, cfg = gpt2_small(dtype=torch.bfloat16)
    model.initialize(0.02, seed=0)
    rs = np.random.RandomState(164)
    prompts = [rs.randint(0, cfg.vocab_size, (n,)) for n in (7, 100, 700)]
    os.environ["MXNET_SERVE_SYNC"] = "1"
    try:
        srv = DecodeServer(model, weights="int8", autostart=False)
    finally:
        del os.environ["MXNET_SERVE_SYNC"]
    try:
        if not srv.sync_mode or srv.sync_reason != "MXNET_SERVE_SYNC=1":
            fail(f"{what}: sync_mode {srv.sync_mode}, reason "
                 f"{srv.sync_reason!r}")
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        streams = [srv.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
        while srv.pump():
            pass
        toks = [s.tokens(1) for s in streams]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        served = _counts()
        c, st = dict(srv.counters), srv.stats()
    finally:
        srv.close()
    _reset_counts()
    t0 = time.perf_counter()
    refs = [list(kv_generate(model, p[None], NEW_TOKENS, temperature=0.0,
                             weights="int8")[0, p.size:]) for p in prompts]
    torch.cuda.synchronize()
    ref_wall = time.perf_counter() - t0
    want = _counts()
    if toks != refs:
        fail(f"{what}: served streams differ from batch-1 kv_generate")
    if served != want or served["flash_fwd"] < 1 or served["q8_matvec"] < 1:
        fail(f"{what}: launches {served} against kv_generate's {want} "
             "(K1 and K4 both wanted)")
    if c["sync_requests"] != 3 or c["step_dispatches"] or st["pool_bytes"]:
        fail(f"{what}: counters {c}, pool_bytes {st['pool_bytes']}")
    print(f"{what}: MXNET_SERVE_SYNC=1 served {len(prompts)} requests "
          f"(prompts {[p.size for p in prompts]}) through kv_generate in "
          f"{wall:.3f} s ({sum(map(len, toks)) / wall:.2f} tokens/s) beside "
          f"the three batch-1 calls' {ref_wall:.3f} s "
          f"({sum(map(len, refs)) / ref_wall:.2f} tokens/s); "
          f"launches {served}, equal to three batch-1 kv_generate calls'; "
          f"streams equal; counters {c} [{card}]", flush=True)
    del model
    torch.cuda.empty_cache()
    return dict(launches=served, tokens_per_s=sum(map(len, toks)) / wall,
                kv_generate_tokens_per_s=sum(map(len, refs)) / ref_wall,
                counters=c)


class _EveryPumpDrafter:
    """Proposes the history's last token ``k`` times: every slot with a
    token drafts, so every pump after the first verifies and the verify
    programs are captured (random weights seldom let the n-gram drafter
    propose)."""

    def propose(self, history, k):
        return [int(history[-1])] * k


def llama_telemetry(model, cfg):
    """12d (5), telemetry: phase 12c's two repetitive prompts and two
    misses through a speculating server on its own thread, drafting every
    pump (``_EveryPumpDrafter``): one ``compile`` event per capture
    (steps and verifies), equal to ``program_records()``'s captures, each
    with its kernel nodes; one ``serve_ttft_seconds`` observation per
    served request; the server's counters in ``render_prometheus()``."""
    import numpy as np
    from mxnet_tpu_torch import telemetry

    card = card_line()
    what = "llama_7b telemetry"
    rs = np.random.RandomState(165)
    extra = spec_extra(cfg.vocab_size)
    prompts = [p for _, p, _ in extra] + \
        [rs.randint(0, cfg.vocab_size, (n,)) for n in (7, 100)]
    news = [n for _, _, n in extra] + [NEW_TOKENS] * 2

    def scenario(srv, wait):
        return prompts, [srv.submit(p, max_new_tokens=n)
                         for p, n in zip(prompts, news)], {}

    _, _, run = serve_run(model, scenario, what, threaded=True, keep=True,
                          spec=None, drafter=_EveryPumpDrafter(),
                          pool_sizes=(4, 8), max_total_len=L7_TOTAL,
                          prefill_buckets=L7_BUCKETS, page_size=16)
    srv = run.pop("server")
    label = srv.telemetry_label
    try:
        records = srv.program_records()
        comp = _server_events("compile", label)
        captures = sum(r["captures"] for r in records)
        sites = sorted({e["site"] for e in comp})
        ttft = telemetry.histogram("serve_ttft_seconds", server=label).count
        text = telemetry.render_prometheus()
        c = dict(srv.counters)
        lines = [f'serve_{k}_total{{server="{label}"}} {c[k]}'
                 for k in ("step_dispatches", "verify_dispatches",
                           "admit_dispatches")]
        served = 1 + len(prompts)           # the warm-up request too
        if len(comp) != captures or "serve.verify" not in sites or \
                not all(e["kernel_nodes"] for e in comp):
            fail(f"{what}: {len(comp)} compile events (sites {sites}, nodes "
                 f"{[e['kernel_nodes'] for e in comp]}) for {captures} "
                 "captures")
        if ttft != served or not all(ln in text for ln in lines):
            fail(f"{what}: ttft observations {ttft} for {served} requests, "
                 f"Prometheus lines present {[ln in text for ln in lines]}")
    finally:
        srv.close(drain=False)
    print(f"{what}: {len(comp)} compile events = {captures} captures "
          f"(site, key, capture s, kernel nodes, s to count them: "
          f"{[(e['site'], e['key'], round(e['seconds'], 3), e['kernel_nodes'], round(e['count_s'], 3)) for e in comp]}); "
          f"serve_ttft_seconds observed {ttft} times for {served} requests; "
          f"render_prometheus carries {lines}; counters {c} [{card}]",
          flush=True)
    return dict(compile_events=len(comp), captures=captures, ttft=ttft,
                compile=[(e["site"], e["seconds"], e["kernel_nodes"],
                          e["count_s"]) for e in comp])


def check_llama_faults(model, cfg, served):
    """Phase 12d on phase 12b's Llama-7B: (1) deadline, (2) cancellation,
    (4) the clock operand, (6) timing, (3) the watchdog, (5) the budget,
    sync mode (GPT-2 small) and telemetry.  ``served`` is phase 12b's
    run."""
    import torch
    from mxnet_tpu_torch import telemetry

    telemetry.clear_events()
    torch.cuda.empty_cache()
    srv, out = llama_deadline_cancel(model, cfg)
    try:
        out["clock"] = llama_clock_operand(srv)
        out["timing"] = llama_deadline_timing(srv, served["arms"])
    finally:
        srv.close(drain=False)
    torch.cuda.empty_cache()
    out["watchdog"] = llama_watchdog(model, cfg)
    torch.cuda.empty_cache()
    out["budget"] = llama_budget(model, cfg)
    torch.cuda.empty_cache()
    out["telemetry"] = llama_telemetry(model, cfg)
    torch.cuda.empty_cache()
    return out


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


def _witness_sgd(steps=RESNET_STEPS):
    """``steps`` SGD steps (``RESNET_OPT``) of a fresh ResNet-50 of phase
    14's seed on its batch, independent of the port's optimizer and
    trainer: the net's forward in training mode, the mean loss,
    ``torch.autograd.grad``, then ``reference_sgd``.  Returns the losses
    and the net's parameters after the steps."""
    import torch
    from mxnet_tpu_torch import gluon

    net, data, label = _resnet50()
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    lr, momentum, wd = (RESNET_OPT[k] for k in
                        ("learning_rate", "momentum", "wd"))
    losses, params = [], None
    for _ in range(steps):
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
    prof = _grouped_profile(
        "mlp", lambda: [_mlp_step(mx, p) for _ in range(n_prof)], n_prof,
        top=10, groups={"rtc kernels": ("gelu_",), "GEMMs": GEMM_KEYS})
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


# --------------------------------------------------------------------------- #
# phase 20: the reference's ops/nn.py ops as mx.nd ops and hybrid_forward
# blocks, the seventeenth slice
# --------------------------------------------------------------------------- #

OP_TOL = 1e-5               # 20.1: card vs CPU, relative and absolute
OP_CTC_TOL = 2e-5           # CTCLoss: a log-space sum over every step
OP_WGRAD_TOL = 1e-4         # cuDNN's f32 weight gradients (phase 16), of
#                             the array's largest magnitude
OP_FAMILIES = {
    "activation": ("Activation", "LeakyReLU", "log_sigmoid", "hard_sigmoid",
                   "mish"),
    "softmax": ("softmax", "log_softmax", "softmin", "SoftmaxActivation",
                "_sparse_softmax_ce"),
    "dense/conv/pool": ("FullyConnected", "Convolution", "Deconvolution",
                        "Pooling"),
    "norm": ("_BatchNormStats", "LayerNorm", "InstanceNorm", "GroupNorm",
             "RMSNorm"),
    "embedding/loss": ("Embedding", "SoftmaxOutput", "CTCLoss", "MakeLoss"),
    "attention": ("flash_attention", "rope",
                  "_contrib_interleaved_matmul_selfatt_qk",
                  "_contrib_interleaved_matmul_selfatt_valatt"),
    "resize": ("UpSampling", "_contrib_BilinearResize2D"),
    "detection": ("_contrib_ROIAlign", "ROIPooling", "_contrib_box_nms",
                  "GridGenerator", "BilinearSampler", "_contrib_MultiBoxPrior",
                  "_contrib_MultiBoxTarget", "_contrib_MultiBoxDetection",
                  "fft", "ifft", "_contrib_Proposal",
                  "_contrib_DeformableConvolution", "Correlation"),
}
HF_V, HF_U, HF_H, HF_T, HF_B = 50257, 768, 12, 1024, 8   # GPT-2 small
HF_STEPS = 3                # 20.2: phase-by-phase steps
HF_FUSED = 20               # 20.2: fused_step calls after them
HF_BITS = 3                 # 20.2: fused against phase by phase, 2 layers
STAGE_B, STAGE_HW = 128, 56     # 20.4: ResNet-50's conv2_x at batch 128
STAGE_K6 = 7                # its stride-1 1x1 convolutions


def _tests_path():
    """``tests/`` on the path: the op cases and the user's models that
    the CPU tests run too (neither imports the JAX package)."""
    path = os.path.join(HERE, "tests")
    if path not in sys.path:
        sys.path.insert(0, path)


def _op_run(mx, name, arrays, kwargs, ctx, heads=None):
    """``mx.nd.<name>`` on ``ctx`` under ``record()``: outputs, then with
    ``heads`` the float inputs' gradients."""
    import numpy as np

    nds = [mx.nd.array(a, ctx=ctx, dtype=str(a.dtype)) for a in arrays]
    wants = [a.dtype == np.float32 for a in arrays]
    for x, w in zip(nds, wants):
        if w:
            x.attach_grad()
    with mx.autograd.record():
        outs = getattr(mx.nd, name)(*nds, **kwargs)
    outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
    if heads is not None:
        mx.autograd.backward(outs, [mx.nd.array(h, ctx=ctx) for h in heads])
    grads = [x.grad.asnumpy() if w else None for x, w in zip(nds, wants)]
    return [o.asnumpy() for o in outs], grads


def op_sweep():
    """20.1: every op that ``ops/nn.py`` and ``ops/attention.py``
    register, at the tier-1 cases (``tests/_torch_nn_cases.py``), f32,
    on the card and on the CPU with the same head gradients: outputs and
    input gradients within ``OP_TOL`` (``OP_CTC_TOL`` for CTCLoss), a
    convolution's weight gradient within ``OP_WGRAD_TOL`` of its largest
    magnitude.  ``_DropoutImpl`` draws from each device's generator, so
    it is left out.  Then the host cost of an ``mx.nd`` op beside the
    torch call it makes."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import attention as pattn
    from mxnet_tpu_torch.ops import nn as pnn
    from mxnet_tpu_torch.ops.registry import OPS

    _tests_path()
    from _torch_nn_cases import CASES, _input

    ported = {n for n, o in OPS.items()
              if o.fn.__module__ in (pnn.__name__, pattn.__name__)}
    counts = {f: 0 for f in OP_FAMILIES}
    worst, bad = {}, []
    for cid, name, specs, kwargs in CASES:
        rs = np.random.RandomState(sum(map(ord, cid)))
        arrays = [_input(rs, s) for s in specs]
        outs, _ = _op_run(mx, name, arrays, kwargs, mx.cpu())
        heads = [rs.standard_normal(o.shape).astype(np.float32)
                 for o in outs] if OPS[name].differentiable else None
        c_out, c_grad = _op_run(mx, name, arrays, kwargs, mx.cpu(), heads)
        g_out, g_grad = _op_run(mx, name, arrays, kwargs, mx.gpu(0), heads)
        if heads is None:
            c_grad = g_grad = []
        tol = OP_CTC_TOL if name == "CTCLoss" else OP_TOL
        err = 0.0
        for i, (g, c) in enumerate(zip(g_out + g_grad, c_out + c_grad)):
            if c is None:
                continue
            wgrad = name in ("Convolution", "Deconvolution") and \
                i - len(c_out) == 1
            if wgrad:
                scale = max(float(np.abs(c).max()), 1e-30)
                e = float(np.abs(g - c).max()) / scale
                ok = e <= OP_WGRAD_TOL
            else:
                e = float(np.abs(g - c).max()) if c.size else 0.0
                ok = np.allclose(g, c, rtol=tol, atol=tol)
            err = max(err, e)
            if not ok:
                bad.append((cid, i, e))
        worst[cid] = err
        family = next(f for f, names in OP_FAMILIES.items() if name in names)
        counts[family] += 1
    missing = ported - {c[1] for c in CASES} - {"_DropoutImpl"}
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:5]
    print(f"op sweep: {len(CASES)} cases of {len(ported)} ops (ops/nn.py, "
          f"ops/attention.py) card vs CPU, f32, TF32 off: by family "
          f"{counts}; worst {[(k, f'{v:.2e}') for k, v in top]} (tol "
          f"{OP_TOL}, CTCLoss {OP_CTC_TOL}, convolution weight gradients "
          f"{OP_WGRAD_TOL} of the largest); _DropoutImpl left out (each "
          f"device's generator)", flush=True)
    if bad or missing:
        fail(f"op sweep: disagreeing {bad[:5]}, without a case {missing}")
    # the host cost of the mx.nd layer: an op through invoke() and the
    # NDArray wrap, beside the torch call it makes
    a = mx.nd.array(np.ones((64, 64), np.float32), ctx=mx.gpu(0))
    w = mx.nd.array(np.ones((64, 64), np.float32), ctx=mx.gpu(0))
    t, wt = a._data, w._data
    host = dict(
        Activation=host_us(lambda: mx.nd.Activation(a, act_type="relu")),
        relu=host_us(lambda: torch.relu(t)),
        FullyConnected=host_us(lambda: mx.nd.FullyConnected(
            a, w, num_hidden=64, no_bias=True)),
        matmul=host_us(lambda: torch.matmul(t, wt.t())))
    print(f"op sweep: host us a call (median of 5 x 200, {card_line()}): "
          f"mx.nd.Activation {host['Activation']:.2f} beside torch.relu "
          f"{host['relu']:.2f}; mx.nd.FullyConnected "
          f"{host['FullyConnected']:.2f} beside torch.matmul "
          f"{host['matmul']:.2f}", flush=True)
    return dict(cases=len(CASES), ops=len(ported), families=counts,
                worst=dict(top), host_us=host)


def _hf_gpt(mx, layers, dropout, dtype, ctx, seed):
    """The user's GPT (``tests/_torch_hybrid_models.gpt``) at GPT-2
    small's widths, Normal(0.02) from ``seed``, in ``dtype``."""
    _tests_path()
    from _torch_hybrid_models import gpt

    with ctx:
        net = gpt(mx, vocab=HF_V, units=HF_U, layers=layers, heads=HF_H,
                  max_len=HF_T, dropout=dropout)
    net.initialize(mx.init.Normal(0.02), ctx=ctx, seed=seed)
    if dtype != "float32":
        net.cast(dtype)
    return net


def _hf_batch(mx, B, ctx, seed=8):
    import numpy as np

    rs = np.random.RandomState(seed)
    tok = mx.nd.array(rs.randint(0, HF_V, (B, HF_T)), ctx=ctx,
                      dtype="int32")
    pos = mx.nd.array(np.tile(np.arange(HF_T), (B, 1)), ctx=ctx,
                      dtype="int32")
    lab = mx.nd.array(rs.randint(0, HF_V, (B, HF_T)), ctx=ctx,
                      dtype="int32")
    return tok, pos, lab


def hf_gpt2(cfg, train_row):
    """20.2: the user's GPT-2 small (12 layers, bf16, dropout 0.1,
    ``gluon.Trainer(..., "adamw")`` multi-precision) on one batch of
    8 x 1024: ``HF_STEPS`` steps phase by phase (``record``,
    ``backward``, ``step``), then ``HF_FUSED`` ``fused_step`` calls (eager,
    capture and replay, replays).  K1, K2, K3 exactly 12 a step in both
    arms (a replay's by what its capture recorded), one capture, losses
    finite, the first within 0.5 of ln(vocab), falling, every gradient
    nonzero after the first step; ms a step of both arms beside phase
    7's ``SPMDTrainer``.  Then at 2 layers and dropout 0, ``HF_BITS``
    fused steps against as many phase-by-phase ones, bit for bit."""
    import math

    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon import fused_step as fsm

    gpu = mx.gpu(0)
    mx.random.seed(0)
    net = _hf_gpt(mx, cfg.num_layers, 0.1, "bfloat16", gpu, seed=0)
    tok, pos, lab = _hf_batch(mx, HF_B, gpu)
    loss_l = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "adamw", dict(ADAMW_OPT))
    params = [p for p in net.collect_params().values()
              if p.grad_req != "null"]

    def loss_fn(t, p, y):
        return loss_l(net(t, p), y)

    losses, phase_counts, times, zero = [], [], [], []
    for i in range(HF_STEPS):
        _reset_attention_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with autograd.record():
            loss = loss_fn(tok, pos, lab)
        loss.backward()
        if i == 0:
            zero = [p.name for p in params
                    if not bool((p.grad()._data != 0).any())]
        trainer.step(HF_B)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss._data.detach().float().mean()))
        phase_counts.append(_attention_counts())
    # a live graph keeps its leaves' AccumulateGrad nodes, made on the
    # default stream; the fused step's capture on its side stream would
    # meet them and fail (PyTorch's stream-mismatch rule)
    del loss
    fsm.reset_step_counters()
    _reset_attention_counts()
    fused = []
    for i in range(HF_FUSED):
        if i == 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        fused.append(trainer.fused_step(loss_fn, tok, pos, lab)._data
                     .float().mean())
    torch.cuda.synchronize()
    fused_ms = (time.perf_counter() - t0) / (HF_FUSED - 2) * 1e3
    losses += [float(v) for v in fused]
    fs, prog = _apply_program(trainer)
    launches = _fused_attention_launches(trainer)
    counters = dict(fsm.step_counters)
    phase_ms = sum(times[1:]) / (HF_STEPS - 1) * 1e3
    L = cfg.num_layers
    print(f"hybrid gpt2: the user's hybrid_forward GPT-2 small (12 layers, "
          f"bf16, dropout 0.1, F.flash_attention, tied head by "
          f"F.FullyConnected) B={HF_B} T={HF_T}, AdamW multi-precision: "
          f"{HF_STEPS} phase-by-phase steps then {HF_FUSED} fused_step "
          f"calls; losses {[round(v, 4) for v in losses]}; launches a "
          f"phase-by-phase step {phase_counts}, fused {launches} (a "
          f"replay's {prog.launches}); step_counters {counters}; "
          f"parameters with a zero gradient after step 1: {zero}",
          flush=True)
    print(f"hybrid gpt2: ms a step, phase by phase {phase_ms:.3f} (steps "
          f"2-{HF_STEPS}), fused {fused_ms:.3f} (replays 3-{HF_FUSED}); "
          f"phase 7's SPMDTrainer GPT-2 in this process "
          f"{train_row['ms_per_step']:.3f} (captured arm "
          f"{train_row['arms']['captured_ms_per_step']:.3f}); "
          f"{card_line()}", flush=True)
    for c in phase_counts:
        if any(c[n] != L for n in ATTN_KERNELS):
            fail(f"hybrid gpt2: a phase-by-phase step launched {c}, "
                 f"expected {L} each")
    if any(prog.launches.get(n) != L or launches[n] != L * HF_FUSED
           for n in ATTN_KERNELS):
        fail(f"hybrid gpt2: fused launches {launches} (a replay's "
             f"{prog.launches}), expected {L} a step")
    if counters["compiles"] != 1 or counters["legacy_steps"]:
        fail(f"hybrid gpt2: step counters {counters}")
    if not all(math.isfinite(v) for v in losses) or \
            abs(losses[0] - math.log(HF_V)) > 0.5 or \
            not sum(losses[-3:]) < sum(losses[:3]):
        fail(f"hybrid gpt2: losses not finite, first not within 0.5 of "
             f"ln(vocab), or not falling: {losses}")
    if zero:
        fail(f"hybrid gpt2: zero gradients after the first step: {zero}")
    row = dict(losses=losses, phase_launches=phase_counts,
               fused_launches=launches, launches_a_replay=prog.launches,
               step_counters=counters, phase_ms_per_step=phase_ms,
               fused_ms_per_step=fused_ms,
               spmd_ms_per_step=train_row["ms_per_step"],
               launches={n: sum(c[n] for c in phase_counts) + launches[n]
                         for n in ATTN_KERNELS})
    del fs, prog, trainer, net, params, fused
    torch.cuda.empty_cache()
    row["bits"] = hf_bits(mx)
    for n in ATTN_KERNELS:
        row["launches"][n] += row["bits"]["launches"][n]
    return row


def _fused_attention_launches(trainer):
    """K1-K3's launches since the counts were set to 0, through the
    trainer's fused step: the eager calls by the counts, each replay by
    what its capture recorded."""
    fs, prog = _apply_program(trainer)
    host = _attention_counts()
    replayed = fs.launches()
    return {n: host[n] - prog.launches.get(n, 0) + replayed.get(n, 0)
            for n in ATTN_KERNELS}


def hf_bits(mx):
    """20.2, last: two copies of the user's GPT at full width, 2 layers,
    dropout 0, bf16, from one seed; ``HF_BITS`` ``fused_step`` calls on
    one (eager, capture and replay, replay) against as many
    phase-by-phase steps on the other: the losses and every parameter
    bit for bit."""
    import torch
    from mxnet_tpu_torch import autograd, gluon

    gpu = mx.gpu(0)
    nets = [_hf_gpt(mx, 2, 0.0, "bfloat16", gpu, seed=5) for _ in range(2)]
    tok, pos, lab = _hf_batch(mx, HF_B, gpu, seed=10)
    loss_l = gluon.loss.SoftmaxCrossEntropyLoss()
    trainers = [gluon.Trainer(n.collect_params(), "adamw", dict(ADAMW_OPT))
                for n in nets]
    fused, phase = [], []

    def loss_fn(t, p, y):       # one function: one step program
        return loss_l(nets[0](t, p), y)

    _reset_attention_counts()
    for _ in range(HF_BITS):
        fused.append(trainers[0].fused_step(loss_fn, tok, pos, lab)
                     ._data.clone())
    launches = _fused_attention_launches(trainers[0])
    _reset_attention_counts()
    for _ in range(HF_BITS):
        with autograd.record():
            loss = loss_l(nets[1](tok, pos), lab)
        loss.backward()
        trainers[1].step(HF_B)
        phase.append(loss._data.clone())
    launches = {n: c + _attention_counts()[n] for n, c in launches.items()}
    same_loss = all(torch.equal(a, b) for a, b in zip(fused, phase))
    pa, pb = (n._collect_params_with_prefix() for n in nets)
    differ = [k for k in pa if not torch.equal(pa[k].data()._data,
                                               pb[k].data()._data)]
    print(f"hybrid gpt2 bits: 2 layers, full width, dropout 0, bf16: "
          f"{HF_BITS} fused steps against {HF_BITS} phase by phase: losses "
          f"equal {same_loss}, parameters that differ {differ} of "
          f"{len(pa)}; launches {launches}", flush=True)
    if not same_loss or differ:
        fail("hybrid gpt2 bits: the fused steps differ from the phase-by-"
             "phase steps")
    del nets, trainers, fused, phase
    torch.cuda.empty_cache()
    return dict(steps=HF_BITS, losses_equal=same_loss, params=len(pa),
                params_differing=differ, launches=launches)


def hf_vs_cpu():
    """20.3: the user's GPT in f32 at 2 layers, full width, dropout 0,
    1 x 1024, on the card (K1-K3, TF32 off) and on the CPU (their plain
    versions) from the same weights: the loss within ``GLUON_TOL``
    relative and every gradient within ``GLUON_GRAD_TOL`` of its array's
    largest magnitude (phase 16's bounds)."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon

    cpu_net = _hf_gpt(mx, 2, 0.0, "float32", mx.cpu(), seed=9)
    card_net = _hf_gpt(mx, 2, 0.0, "float32", mx.gpu(0), seed=1)
    src = cpu_net._collect_params_with_prefix()
    for k, p in card_net._collect_params_with_prefix().items():
        p.set_data(src[k].data())
    loss_l = gluon.loss.SoftmaxCrossEntropyLoss()
    res = {}
    for name, net, ctx in (("card", card_net, mx.gpu(0)),
                           ("cpu", cpu_net, mx.cpu())):
        tok, pos, lab = _hf_batch(mx, 1, ctx, seed=12)
        _reset_attention_counts()
        t0 = time.perf_counter()
        with autograd.record():
            loss = loss_l(net(tok, pos), lab)
        loss.backward()
        grads = {k: p.grad().asnumpy() for k, p in
                 net._collect_params_with_prefix().items()}
        res[name] = dict(loss=loss.asnumpy(), grads=grads,
                         s=time.perf_counter() - t0,
                         launches=_attention_counts())
    c, g = res["cpu"], res["card"]
    loss_rel = float(np.abs(g["loss"] - c["loss"]).max() /
                     np.abs(c["loss"]).max())
    errs = sorted(((float(np.abs(g["grads"][k] - v).max()) /
                    max(float(np.abs(v).max()), 1e-30), k)
                   for k, v in c["grads"].items()), reverse=True)
    print(f"hybrid gpt2 vs cpu: 2 layers, f32, dropout 0, 1 x {HF_T}: loss "
          f"card {g['loss'].item():.6f} cpu {c['loss'].item():.6f} (rel "
          f"{loss_rel:.3e}, tol {GLUON_TOL}); worst gradients "
          f"{[(f'{e:.3e}', k) for e, k in errs[:3]]} of each array's "
          f"largest magnitude (tol {GLUON_GRAD_TOL}); {len(errs)} "
          f"gradients; seconds card {g['s']:.2f}, cpu {c['s']:.2f}; "
          f"launches on the card {g['launches']}", flush=True)
    if loss_rel > GLUON_TOL or errs[0][0] > GLUON_GRAD_TOL:
        fail("hybrid gpt2 vs cpu: the card disagrees with the CPU")
    return dict(loss_card=g["loss"].item(), loss_cpu=c["loss"].item(),
                loss_rel=loss_rel, grad_rel=errs[0][0],
                worst=errs[:3], launches=g["launches"])


def hf_stage():
    """20.4: ResNet-50's stage conv2_x as the user's ``hybrid_forward``
    bottlenecks (``F.Convolution``, ``F.BatchNorm``, ``F.Activation``;
    ``tests/_torch_hybrid_models.bottleneck_stage``) against the same
    stage of the model zoo's ``BottleneckV1`` (``gluon.nn.Conv2D``/
    ``BatchNorm``) with the same weights, NHWC bf16, 128 x 56 x 56 x 64,
    ``MXNET_FUSED_CONV_BWD=1``, under ``record()``: K6 exactly
    ``STAGE_K6`` times a backward, the output, the input's gradient and
    every parameter's gradient equal bit for bit.  The flag is restored
    after the stage."""
    prev = os.environ.get("MXNET_FUSED_CONV_BWD")
    os.environ["MXNET_FUSED_CONV_BWD"] = "1"
    try:
        return _hf_stage()
    finally:
        if prev is None:
            del os.environ["MXNET_FUSED_CONV_BWD"]
        else:
            os.environ["MXNET_FUSED_CONV_BWD"] = prev


def _hf_stage():
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.ops import conv_fused as cf

    _tests_path()
    from _torch_hybrid_models import (bottleneck_stage, stage_from_zoo,
                                      zoo_stage)

    gpu = mx.gpu(0)
    gen = torch.Generator(device="cuda").manual_seed(23)
    x = torch.randn((STAGE_B, STAGE_HW, STAGE_HW, 64), generator=gen,
                    device="cuda")
    with gpu:
        zoo, hyb = zoo_stage(mx), bottleneck_stage(mx)
    zoo.initialize(mx.init.Xavier(magnitude=2), ctx=gpu, seed=4)
    hyb.initialize(ctx=gpu)
    zoo(mx.nd.NDArray(x))                   # the deferred shapes
    zoo.cast("bfloat16")
    hyb.cast("bfloat16")
    names = stage_from_zoo(hyb, zoo)
    xb = x.bfloat16()
    head = torch.randn(xb.shape[:-1] + (256,), generator=gen,
                       device="cuda").bfloat16()
    res, k6 = {}, []
    for what, net in (("hybrid", hyb), ("zoo", zoo)):
        # the first call is compared (the zoo's BatchNorm then commits its
        # running mean, the shift of the next call's statistics); the
        # second is timed
        for rep in range(2):
            a = mx.nd.NDArray(xb.clone())
            a.attach_grad()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with autograd.record():
                out = net(a)
            cf.conv1x1_bwd_pair.launches = 0
            out.backward(mx.nd.NDArray(head))
            torch.cuda.synchronize()
            k6.append(cf.conv1x1_bwd_pair.launches)
            if rep == 0:
                res[what] = dict(
                    out=out._data.clone(), dx=a.grad._data.clone(),
                    grads={k: p.grad()._data.clone() for k, p in
                           net._collect_params_with_prefix().items()
                           if p.grad_req != "null"})
        res[what]["ms"] = (time.perf_counter() - t0) * 1e3
    h, z = res["hybrid"], res["zoo"]
    differ = [k for k, g in z["grads"].items()
              if not torch.equal(h["grads"][names[k]], g)]
    same = torch.equal(h["out"], z["out"]) and torch.equal(h["dx"], z["dx"])
    print(f"hybrid stage: ResNet-50 conv2_x as hybrid_forward bottlenecks "
          f"(F.Convolution, F.BatchNorm, F.Activation), NHWC bf16 "
          f"{STAGE_B}x{STAGE_HW}x{STAGE_HW}x64, MXNET_FUSED_CONV_BWD=1: K6 "
          f"a backward, hybrid then zoo, two each, {k6} (expected "
          f"{STAGE_K6}); output and input gradient equal to the zoo "
          f"stage's {same}; parameter gradients that differ {differ} of "
          f"{len(z['grads'])}; ms forward + backward hybrid "
          f"{h['ms']:.3f}, zoo {z['ms']:.3f}; {card_line()}", flush=True)
    if any(n != STAGE_K6 for n in k6):
        fail(f"hybrid stage: K6 launched {k6} times a backward (hybrid "
             f"then zoo, two each), expected {STAGE_K6}")
    if not same or differ:
        fail("hybrid stage: the hybrid_forward stage differs from the zoo "
             "stage")
    row = dict(k6=k6, launches=sum(k6), equal=same, grads=len(z["grads"]),
               hybrid_ms=h["ms"], zoo_ms=z["ms"])
    del zoo, hyb, res, x, xb, head, out, a
    torch.cuda.empty_cache()
    return row


def check_hybrid(cfg, train_row):
    """Phase 20: the op sweep, the user's GPT-2 (bf16 arms, then f32
    against the CPU) and the ResNet stage."""
    import torch

    t0 = time.perf_counter()
    row = dict(ops=op_sweep(), gpt=hf_gpt2(cfg, train_row),
               vs_cpu=hf_vs_cpu(), stage=hf_stage())
    torch.cuda.synchronize()
    # K1-K3 over 20.2 and 20.3, K6 over 20.4
    row["launches"] = {n: row["gpt"]["launches"][n] +
                       row["vs_cpu"]["launches"][n] for n in ATTN_KERNELS}
    row["launches"]["conv1x1_bwd"] = row["stage"]["launches"]
    row["seconds"] = time.perf_counter() - t0
    print(f"phase 20: {row['seconds']:.2f} s", flush=True)
    return row


# --------------------------------------------------------------------------- #
# phase 21: Gluon data and mx.io feeding ResNet-50, the eighteenth slice
# --------------------------------------------------------------------------- #

DATA_RECORDS = 1536          # 12 batches of 128
DATA_SIDE = 256              # raw HWC uint8 records, cropped to 224
DATA_CROP = 224
DATA_STEPS = DATA_RECORDS // RESNET_B
DATA_WORKERS = 4
DATA_MEAN = [123.68, 116.28, 103.53]
DATA_STD = [58.395, 57.12, 57.375]


def _record_image(rs):
    return rs.randint(0, 256, (DATA_SIDE, DATA_SIDE, 3), dtype="uint8")


def write_records(d):
    """21.1: an indexed RecordIO file of ``n`` raw 256x256x3 uint8 images
    from a seed, each with an ``IRHeader`` label in [0, 1000), written and
    read back through the port, byte for byte."""
    import numpy as np
    from mxnet_tpu_torch import recordio as rio

    n = DATA_RECORDS
    rec = os.path.join(d, "train.rec")
    t0 = time.perf_counter()
    rs = np.random.RandomState(21)
    w = rio.MXIndexedRecordIO(rec[:-4] + ".idx", rec, "w")
    for i in range(n):
        w.write_idx(i, rio.pack(rio.IRHeader(0, float(rs.randint(1000)), i,
                                             0), _record_image(rs).tobytes()))
    w.close()
    t1 = time.perf_counter()
    rs = np.random.RandomState(21)
    r = rio.MXIndexedRecordIO(rec[:-4] + ".idx", rec, "r")
    bad = 0
    for i in range(n):
        label = float(rs.randint(1000))
        h, payload = rio.unpack(r.read_idx(i))
        if payload != _record_image(rs).tobytes() or h.label != label or \
                h.id != i:
            bad += 1
    r.close()
    t2 = time.perf_counter()
    size = os.path.getsize(rec)
    print(f"data records: {n} raw {DATA_SIDE}x{DATA_SIDE}x3 uint8 records, "
          f"{size} bytes, written in {t1 - t0:.3f} s, read back through "
          f"the port in {t2 - t1:.3f} s; {bad} differ", flush=True)
    if bad or len(r.keys) != n:
        fail(f"data records: {bad} of {n} records read back differ")
    return rec, dict(records=n, bytes=size, write_s=t1 - t0,
                     read_s=t2 - t1)


def _raw_transform(mx, augs):
    """The sample: the record's raw HWC bytes as a host NDArray, through
    ``augs`` (``mx.image`` augmenters), with its label."""
    import numpy as np
    from mxnet_tpu_torch import recordio as rio

    def unpack_raw_then_augment(record):
        header, payload = rio.unpack(record)
        img = mx.nd.array(np.frombuffer(payload, np.uint8).reshape(
            DATA_SIDE, DATA_SIDE, 3), dtype="uint8", ctx=mx.cpu())
        for a in augs:
            img = a(img)
        return img, header.label
    return unpack_raw_then_augment


def _augs(mx, train):
    crop = (mx.image.RandomCropAug((DATA_CROP, DATA_CROP)),
            mx.image.HorizontalFlipAug(0.5)) if train else \
        (mx.image.CenterCropAug((DATA_CROP, DATA_CROP)),)
    return list(crop) + [mx.image.CastAug(),
                         mx.image.ColorNormalizeAug(DATA_MEAN, DATA_STD)]


def data_loader(mx, rec, train, seed, device, num_workers=DATA_WORKERS,
                batch_size=None, take=None):
    """Phase 21's loader: ``RecordFileDataset(rec).transform(...)``, a
    seeded ``RandomSampler``, ``last_batch="discard"``, pinned staging and
    the device ring of depth 2."""
    from mxnet_tpu_torch.gluon.data import (DataLoader, RandomSampler,
                                            RecordFileDataset)

    ds = RecordFileDataset(rec)
    if take is not None:
        ds = ds.take(take)
    ds = ds.transform(_raw_transform(mx, _augs(mx, train)))
    return DataLoader(ds, batch_size=batch_size or RESNET_B,
                      sampler=RandomSampler(len(ds), seed=seed),
                      last_batch="discard", num_workers=num_workers,
                      pin_memory=True, device=device, device_prefetch=2)


def _data_loss(net, loss_l):
    """The step's loss: NHWC f32 batches to the net's NCHW contract (a
    view; the net runs channels-last), cast to bf16 in the step."""
    def loss_fn(x, y):
        return loss_l(net(x.transpose(0, 3, 1, 2).astype("bfloat16")), y)
    return loss_fn


def _ring_counters():
    from mxnet_tpu_torch.gluon.data import dataloader as dl

    tele = dl._ring_tele()
    return tele["stalls"].value, tele["stall_s"].sum


def data_fed_resnet(rec):
    """21.2 and 21.4: phase 16's ResNet-50 (NHWC, bf16, SGD with momentum
    and multi-precision, ``MXNET_FUSED_CONV_BWD=1``) through
    ``gluon.Trainer.fused_step`` for one epoch of 12 steps fed by the
    loader (4 worker threads, pinned staging, the ring on the card): 30
    K6 nodes in the step graph, one capture, no phase-by-phase step,
    losses finite, the first within 1.0 of ln(1000).  Then, not gated: ms
    a step over steps 3-12 beside the same step fed one resident batch,
    the same over a second fed epoch (the graph captured, the ring
    started empty) with its stalls, host ms a batch of the loader alone,
    the ring's stalls, the device's busy share over fed steps (another
    epoch, profiled), the ring's pinned and device bytes."""
    import math

    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon import fused_step as fsm
    from mxnet_tpu_torch.gluon.block import _GraphProgram
    from mxnet_tpu_torch.ops import conv_fused as cf

    os.environ["MXNET_FUSED_CONV_BWD"] = "1"
    net = _gluon_resnet50(mx)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            dict(RESNET_OPT, multi_precision=True))
    loss_fn = _data_loss(net, gluon.loss.SoftmaxCrossEntropyLoss())
    loader = data_loader(mx, rec, True, 21, mx.gpu())

    def step(x, y):
        return trainer.fused_step(loss_fn, x, y)._data.float().mean()

    torch.cuda.synchronize()
    fsm.reset_step_counters()
    cf.conv1x1_bwd_pair.launches = 0
    stalls0, stall_s0 = _ring_counters()
    losses, shapes = [], None
    _GraphProgram.debug = True
    try:
        t0 = time.perf_counter()
        it = iter(loader)
        for k, (x, y) in enumerate(it):
            if k == 2:
                _GraphProgram.debug = False
                torch.cuda.synchronize()
                t2 = time.perf_counter()
            shapes = shapes or (x.shape, str(x.dtype), x.context,
                                y.shape, str(y.dtype))
            losses.append(step(x, y))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    finally:
        _GraphProgram.debug = False
    counters = dict(fsm.step_counters)
    fs, prog = _apply_program(trainer)
    host_launches = cf.conv1x1_bwd_pair.launches
    k6_runs = host_launches - prog.launches.get("conv1x1_bwd", 0) + \
        fs.launches().get("conv1x1_bwd", 0)
    stalls1, stall_s1 = _ring_counters()
    pinned, device = it.pinned_bytes, it.device_bytes
    counts, every = _graph_nodes(prog, ("conv1x1_bwd",))
    _print_nodes("data resnet graph", every)
    losses = [float(v) for v in losses]
    fed_ms = (t3 - t2) / (DATA_STEPS - 2) * 1e3
    # the same step fed one resident batch (the last one, kept on the card)
    x, y = x.copy(), y.copy()
    for _ in range(2):
        step(x, y)
    torch.cuda.synchronize()
    r0 = time.perf_counter()
    for _ in range(DATA_STEPS - 2):
        step(x, y)
    torch.cuda.synchronize()
    resident_ms = (time.perf_counter() - r0) / (DATA_STEPS - 2) * 1e3
    # a second fed epoch, the graph captured: the steady state, timed from
    # the epoch's start (the ring and the workers start empty)
    loader.set_epoch(1)
    e_stalls0, e_stall_s0 = _ring_counters()
    torch.cuda.synchronize()
    e0 = time.perf_counter()
    waits, ei = [], iter(loader)
    for k in range(DATA_STEPS):
        if k == 2:
            torch.cuda.synchronize()
            e2 = time.perf_counter()
        w0 = time.perf_counter()
        xb, yb = next(ei)
        waits.append(time.perf_counter() - w0)
        step(xb, yb)
    torch.cuda.synchronize()
    e3 = time.perf_counter()
    del ei
    e_stalls1, e_stall_s1 = _ring_counters()
    steady_ms = (e3 - e2) / (DATA_STEPS - 2) * 1e3
    epoch_ms = (e3 - e0) / DATA_STEPS * 1e3
    # the loader alone: an epoch of batches on the card, no step
    loader.set_epoch(3)
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    n = 0
    for xb, yb in loader:
        n += 1
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - h0) / n * 1e3
    # the device's busy share over fed steps 3-12 of another epoch
    loader.set_epoch(2)
    it2 = iter(loader)
    for _ in range(2):
        step(*next(it2))

    def fed_rest():
        for xb, yb in it2:
            step(xb, yb)

    by_name, busy, wall_us = _profiled(fed_rest)
    prof = report_profile("data resnet fed steps 3-12", by_name, busy,
                          wall_us)
    row = dict(losses=losses, fed_ms_per_step=fed_ms,
               resident_ms_per_step=resident_ms,
               fed_images_per_s=RESNET_B / fed_ms * 1e3,
               loader_alone_ms_per_batch=host_ms,
               stalls=stalls1 - stalls0, stall_s=stall_s1 - stall_s0,
               second_epoch=dict(ms_per_step=steady_ms,
                                 ms_per_step_over_epoch=epoch_ms,
                                 next_ms=[w * 1e3 for w in waits],
                                 stalls=e_stalls1 - e_stalls0,
                                 stall_s=e_stall_s1 - e_stall_s0),
               busy_share=busy / wall_us if busy > 0 else None,
               profile=prof, pinned_bytes=pinned, device_bytes=device,
               step_counters=counters, k6_nodes=counts["conv1x1_bwd"],
               launches_a_replay=prog.launches,
               launches=dict(conv1x1_bwd=k6_runs),
               epoch_s=t3 - t0, batch=[str(s) for s in shapes])
    print(f"data resnet: resnet50_v1 NHWC bf16 through Trainer.fused_step "
          f"fed by DataLoader(RecordFileDataset(rec).transform(...), "
          f"batch_size={RESNET_B}, num_workers={DATA_WORKERS}, "
          f"pin_memory=True, device=mx.gpu(), device_prefetch=2), one epoch "
          f"of {len(losses)} steps; batch {shapes}; losses "
          f"{[round(v, 4) for v in losses]}", flush=True)
    print(f"data resnet: fed {fed_ms:.3f} ms/step (steps 3-{DATA_STEPS}, "
          f"{row['fed_images_per_s']:.2f} images/s) beside {resident_ms:.3f}"
          f" ms/step fed one resident batch; the loader alone "
          f"{host_ms:.3f} ms a batch (an epoch, batches on the card, no "
          f"step); data_prefetch_stalls_total +{row['stalls']}, "
          f"data_prefetch_stall_seconds +{row['stall_s']:.4f} s over the "
          f"fed epoch; ring pinned {pinned} B, device {device} B; epoch "
          f"{row['epoch_s']:.3f} s", flush=True)
    print(f"data resnet: a second fed epoch (captured, the ring started "
          f"empty): {steady_ms:.3f} ms/step over steps 3-{DATA_STEPS}, "
          f"{epoch_ms:.3f} ms/step over the whole epoch; host ms in "
          f"next() a step {[round(w * 1e3, 2) for w in waits]}; stalls "
          f"+{e_stalls1 - e_stalls0}, stall seconds "
          f"+{e_stall_s1 - e_stall_s0:.4f}", flush=True)
    print(f"data resnet: step_counters {counters}; K6 nodes {counts} "
          f"(expected {K6_PER_STEP}); launches a replay {prog.launches}; K6 "
          f"ran {k6_runs} times", flush=True)
    if counts["conv1x1_bwd"] != K6_PER_STEP:
        fail(f"data resnet: {counts['conv1x1_bwd']} K6 nodes in the step "
             f"graph, expected {K6_PER_STEP}")
    if counters["legacy_steps"] or counters["compiles"] != 1 or \
            counters["apply_dispatches"] != DATA_STEPS or \
            len(losses) != DATA_STEPS:
        fail(f"data resnet: expected {DATA_STEPS} fused steps with one "
             f"capture and no phase-by-phase step, got {counters}")
    if not all(math.isfinite(v) for v in losses) or \
            abs(losses[0] - math.log(1000)) > 1.0:
        fail(f"data resnet: losses {losses} (first must be within 1.0 of "
             f"ln(1000) = {math.log(1000):.4f})")
    if shapes[0] != (RESNET_B, DATA_CROP, DATA_CROP, 3) or \
            shapes[2] != mx.gpu(0):
        fail(f"data resnet: batches arrived as {shapes}")
    del it, it2, trainer, net, loss_fn, prog, fs
    torch.cuda.empty_cache()
    return row


def _fresh_resnet_steps(mx, init_state, batches):
    """A fresh ResNet-50 (weights drawn from generator state
    ``init_state``) through ``fused_step`` on ``batches()``; returns the
    losses and every parameter, on the host."""
    import torch
    from mxnet_tpu_torch import gluon, random

    gen = random.generator("cuda")
    keep = gen.get_state()
    # deferred layers draw their weights at the first step: the state is
    # put back after the run
    gen.set_state(init_state)
    try:
        net = _gluon_resnet50(mx)
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                dict(RESNET_OPT, multi_precision=True))
        loss_fn = _data_loss(net, gluon.loss.SoftmaxCrossEntropyLoss())
        losses = []
        for x, y in batches():
            losses.append(trainer.fused_step(loss_fn, x, y)._data.float()
                          .cpu())
        params = [p.data()._data.float().cpu()
                  for p in net.collect_params().values()]
    finally:
        gen.set_state(keep)
    del trainer, net
    torch.cuda.empty_cache()
    return losses, params


def data_bits(rec):
    """21.3, deterministic augmentation (centre crop, no flip): the ring's
    batches on the card equal the same loader's with ``device=mx.cpu()``
    and ``num_workers=0`` bit for bit, over an epoch; three fused steps
    (eager, capture and replay, replay) fed from the ring equal three fed
    the same batches copied synchronously, losses and every weight bit
    for bit, from the same initial weights."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import random

    cpu_loader = data_loader(mx, rec, False, 5, mx.cpu(), num_workers=0)
    card_loader = data_loader(mx, rec, False, 5, mx.gpu())
    t0 = time.perf_counter()
    host = [(x.asnumpy(), y.asnumpy()) for x, y in cpu_loader]
    t1 = time.perf_counter()
    differ = 0
    for (hx, hy), (x, y) in zip(host, card_loader):
        if x.context != mx.gpu(0) or not (
                (x.asnumpy() == hx).all() and (y.asnumpy() == hy).all()):
            differ += 1
    t2 = time.perf_counter()
    print(f"data bits: {len(host)} batches of the ring on the card against "
          f"the same loader with device=mx.cpu(), num_workers=0: {differ} "
          f"differ (cpu loader {t1 - t0:.3f} s, ring {t2 - t1:.3f} s)",
          flush=True)
    if differ or len(host) != DATA_STEPS:
        fail(f"data bits: {differ} of {len(host)} ring batches differ from "
             "the CPU loader's")
    os.environ["MXNET_FUSED_CONV_BWD"] = "1"
    init_state = random.generator("cuda").get_state()

    def from_ring():
        card_loader.set_epoch(0)            # the epoch ``host`` holds
        for k, b in enumerate(card_loader):
            if k == 3:
                break
            yield b

    def copied():
        for hx, hy in host[:3]:
            yield (mx.nd.array(hx, ctx=mx.gpu()),
                   mx.nd.array(hy, ctx=mx.gpu()))

    la, pa = _fresh_resnet_steps(mx, init_state, from_ring)
    lb, pb = _fresh_resnet_steps(mx, init_state, copied)
    same_loss = all(torch.equal(a, b) for a, b in zip(la, lb))
    same_w = sum(not torch.equal(a, b) for a, b in zip(pa, pb))
    print(f"data bits: 3 fused steps fed from the ring against 3 fed the "
          f"same batches copied synchronously: losses "
          f"{[round(float(v.mean()), 5) for v in la]} vs "
          f"{[round(float(v.mean()), 5) for v in lb]}, equal {same_loss}; "
          f"{same_w} of {len(pa)} parameters differ", flush=True)
    if not same_loss or same_w:
        fail("data bits: the ring-fed fused steps differ from the "
             "synchronously fed ones")
    return dict(batches=len(host), differ=differ, cpu_loader_s=t1 - t0,
                ring_s=t2 - t1, steps_equal=True)


def data_io():
    """21.5: ``NDArrayIter`` over host arrays wrapped in
    ``PrefetchingIter(device=mx.gpu())``: every batch's data and label on
    ``cuda:0`` and equal to the host iterator's bit for bit, with
    ``last_batch_handle`` ``pad`` and ``roll_over``, across a ``reset()``."""
    import numpy as np
    import mxnet_tpu_torch as mx

    rs = np.random.RandomState(5)
    data = rs.rand(1000, 3, 32, 32).astype("float32")
    label = rs.randint(0, 10, 1000).astype("float32")
    out = {}
    for handle in ("pad", "roll_over"):
        with mx.cpu():
            ref = mx.io.NDArrayIter(data, label, batch_size=RESNET_B,
                                    last_batch_handle=handle)
            inner = mx.io.NDArrayIter(data, label, batch_size=RESNET_B,
                                      last_batch_handle=handle)
        p = mx.io.PrefetchingIter(inner, device=mx.gpu())
        n = bad = 0
        for _ in range(2):
            for a, b in zip(ref, p):
                n += 1
                on = all(t.context == mx.gpu(0) for t in b.data + b.label)
                if not on or a.pad != b.pad or not all(
                        (u.asnumpy() == v.asnumpy()).all()
                        for u, v in zip(a.data + a.label,
                                        b.data + b.label)):
                    bad += 1
            ref.reset()
            p.reset()
        out[handle] = dict(batches=n, bad=bad)
    print(f"data io: NDArrayIter(1000 x 3 x 32 x 32, batch {RESNET_B}) in "
          f"PrefetchingIter(device=mx.gpu()), two epochs around a reset: "
          f"{out}", flush=True)
    if any(v["bad"] or not v["batches"] for v in out.values()):
        fail(f"data io: PrefetchingIter batches wrong: {out}")
    return out


def data_faults(rec):
    """21.6 on the card: a worker past ``timeout`` raises naming the
    batch; ``MXNET_FAULT_INJECT`` at ``data.next`` raises through the
    ring; a loader closed midway leaves no live loader thread and drops
    its ledger entry; ``iter_from(3)`` after ``set_epoch(1)`` gives the
    uninterrupted epoch's remaining batches bit for bit (centre crops, so
    the worker threads draw nothing); ``imdecode`` raises the
    reference's error where no decoder is installed (else a PNG round
    trip)."""
    import threading

    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.gluon.data import DataLoader, SimpleDataset
    from mxnet_tpu_torch.telemetry.memory import ACCOUNTANT

    out = {}

    class Slow(SimpleDataset):
        def __getitem__(self, idx):
            time.sleep(1.0)
            return super().__getitem__(idx)

    try:
        next(iter(DataLoader(Slow([np.zeros(4, "float32")] * 8),
                             batch_size=2, num_workers=1, timeout=0.2,
                             device=mx.gpu())))
        fail("data faults: a worker past its timeout did not raise")
    except MXNetError as e:
        out["timeout"] = str(e)[:80]
        if "batch 0" not in str(e):
            fail(f"data faults: the timeout error does not name the batch: "
                 f"{e}")
    os.environ["MXNET_FAULT_INJECT"] = "data.next:raise:3"
    telemetry.reset_faults()
    got = 0
    try:
        for _ in data_loader(mx, rec, False, 1, mx.gpu(), batch_size=16,
                             take=128):
            got += 1
        fail("data faults: the injected data.next fault did not raise")
    except MXNetError as e:
        out["fault"] = str(e)[:80]
        if "injected fault at data.next" not in str(e):
            raise
    finally:
        del os.environ["MXNET_FAULT_INJECT"]
        telemetry.reset_faults()
    out["fault_batches_before"] = got
    it = iter(data_loader(mx, rec, True, 2, mx.gpu()))
    next(it)
    next(it)
    key, inner = it._mem_key, it._source
    held = ACCOUNTANT.bytes("data.prefetch_ring", key)
    it.close()
    for t in list(inner._executor._threads):
        t.join(timeout=30)

    def loader_threads():
        return [t.name for t in threading.enumerate()
                if t.name.startswith(("mx-data-worker",
                                      "mx-device-prefetch"))]

    deadline = time.time() + 30
    while loader_threads() and time.time() < deadline:
        time.sleep(0.01)
    live = loader_threads()
    dropped = ACCOUNTANT.bytes("data.prefetch_ring", key)
    out["close"] = dict(held=held, after=dropped, live=live)
    if live or dropped or not held:
        fail(f"data faults: closed midway: ledger {held} -> {dropped} B, "
             f"live threads {live}")
    def epoch(start):
        loader = data_loader(mx, rec, False, 7, mx.gpu(), batch_size=32,
                             take=256)
        loader.set_epoch(1)
        batches = loader if start == 0 else loader.iter_from(start)
        return [(x.asnumpy(), y.asnumpy()) for x, y in batches]

    whole, rest = epoch(0), epoch(3)
    differ = sum(not ((a[0] == b[0]).all() and (a[1] == b[1]).all())
                 for a, b in zip(whole[3:], rest))
    out["iter_from"] = dict(epoch=len(whole), resumed=len(rest),
                            differ=differ)
    if len(rest) != len(whole) - 3 or differ:
        fail(f"data faults: iter_from(3) gave {len(rest)} batches, {differ} "
             f"differing from the uninterrupted epoch's {len(whole) - 3}")
    backends = mx.image.backends()
    out["backends"] = backends
    if not backends:
        try:
            mx.image.imdecode(b"\xff\xd8\xff\xe0" + bytes(64))
            fail("data faults: imdecode without a decoder did not raise")
        except MXNetError as e:
            out["imdecode"] = str(e)
            if str(e) != "imdecode needs cv2 or PIL":
                fail(f"data faults: imdecode raised {e!r}")
    else:
        img = np.arange(48, dtype="uint8").reshape(4, 4, 3)
        same_img = (mx.image.imdecode(mx.image.imencode(
            img, img_fmt=".png")).asnumpy() == img).all()
        out["imdecode"] = f"round trip equal {bool(same_img)}"
        if not same_img:
            fail("data faults: imdecode round trip differs")
    print(f"data faults: {out}", flush=True)
    return out


def check_data():
    """Phase 21: the record file, ResNet-50 fed by the loader, the bit
    checks, mx.io and the faults."""
    import tempfile

    import torch

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        rec, records = write_records(d)
        row = dict(records=records, resnet=data_fed_resnet(rec),
                   bits=data_bits(rec), io=data_io())
        faults = data_faults(rec)
    row["faults"] = faults
    torch.cuda.synchronize()
    row["launches"] = row["resnet"]["launches"]["conv1x1_bwd"]
    row["seconds"] = time.perf_counter() - t0
    print(f"phase 21: {row['seconds']:.2f} s", flush=True)
    return row


# --------------------------------------------------------------------------- #
# phase 22: the detection and sampling ops, mx.nd.image, mx.nd.contrib and the
# int8 quantization ops, with greedy NMS as one CUDA launch, the nineteenth
# slice
# --------------------------------------------------------------------------- #

SSD_B, SSD_SIDE, SSD_CLASSES = 32, 512, 20   # ssd_512_resnet50_v1_voc
SSD_RECORDS = 256                            # 8 batches
SSD_STEPS = SSD_RECORDS // SSD_B
SSD_OBJECTS = 20                             # 1-20 boxes an image, padded
SSD_ANCHORS = 6132
SSD_K6 = 30 + 4      # ResNet-50's stride-1 1x1s and the extras' four
SSD_OPT = {"learning_rate": 0.001, "momentum": 0.9, "wd": 5e-4,
           "multi_precision": True}
RCNN_H, RCNN_W = 600, 1000                   # Ren et al. 2015, example/rcnn
RCNN_PROPOSAL = dict(scales=(8, 16, 32), ratios=(0.5, 1, 2),
                     feature_stride=16, rpn_pre_nms_top_n=6000,
                     rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16)
RCNN_CPU_CHANNELS = 256     # the CPU repeats the pooling on these channels
IOU_OPS = 15                # f32 operations of one IoU and its test
H100_F32_FLOPS = 67e12      # H100 SXM CUDA-core f32 peak, data sheet
H100_BYTES_S = 3.35e12
GRAPH_KERNELS["box_nms"] = r"box_nms_kernel"


def _ssd_models():
    _tests_path()
    import _torch_ssd_models as sm
    return sm


def _ssd_image(rs, boxes):
    """A 512x512x3 uint8 image from a seed: a smooth background and each
    box filled with its class's colour."""
    import numpy as np

    low = rs.randint(0, 256, (8, 8, 3)).astype(np.float32)
    img = np.kron(low, np.ones((64, 64, 1), np.float32))
    for c, x1, y1, x2, y2 in boxes:
        img[int(y1 * SSD_SIDE):int(y2 * SSD_SIDE),
            int(x1 * SSD_SIDE):int(x2 * SSD_SIDE)] = \
            (37 * c) % 256, (91 * c) % 256, (53 * c) % 256
    return img.astype(np.uint8)


def ssd_records(d):
    """22.0: an indexed detection RecordIO file of ``SSD_RECORDS`` JPEG
    images, 512x512, each with 1-20 boxes of the 20 VOC classes in the
    reference's label layout ([2, 5, cls, x1, y1, x2, y2, ...])."""
    import numpy as np
    from mxnet_tpu_torch import recordio as rio

    rec = os.path.join(d, "voc.rec")
    rs = np.random.RandomState(22)
    t0 = time.perf_counter()
    w = rio.MXIndexedRecordIO(rec[:-4] + ".idx", rec, "w")
    objects = 0
    for i in range(SSD_RECORDS):
        n = rs.randint(1, SSD_OBJECTS + 1)
        xy = rs.uniform(0.0, 0.7, (n, 2))
        wh = rs.uniform(0.05, 0.3, (n, 2))
        boxes = np.concatenate([rs.randint(0, SSD_CLASSES, (n, 1)), xy,
                                np.minimum(xy + wh, 1.0)], 1)
        label = np.concatenate([[2, 5], boxes.reshape(-1)]).astype(
            np.float32)
        w.write_idx(i, rio.pack_img(rio.IRHeader(0, label, i, 0),
                                    _ssd_image(rs, boxes), quality=90))
        objects += n
    w.close()
    size = os.path.getsize(rec)
    print(f"ssd records: {SSD_RECORDS} JPEG {SSD_SIDE}x{SSD_SIDE} images, "
          f"{objects} boxes, {size} bytes, written in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    return rec, dict(records=SSD_RECORDS, objects=objects, bytes=size)


def ssd_batches(mx, rec):
    """The epoch's batches through ``mx.image.ImageDetIter`` (decode,
    force-resize, mean and std), on the card; labels padded to
    ``SSD_OBJECTS`` rows so that every step has one shape."""
    import torch

    t0 = time.perf_counter()
    with mx.gpu(0):
        it = mx.image.ImageDetIter(SSD_B, (3, SSD_SIDE, SSD_SIDE),
                                   path_imgrec=rec, mean=True, std=True)
    out = []
    for batch in it:
        x, y = batch.data[0], batch.label[0]
        full = torch.full((SSD_B, SSD_OBJECTS, 5), -1.0, device="cuda")
        full[:, :y.shape[1]] = y._data
        out.append((x, mx.nd.NDArray(full)))
    torch.cuda.synchronize()
    print(f"ssd data: ImageDetIter {len(out)} batches of {SSD_B} in "
          f"{time.perf_counter() - t0:.3f} s; data {tuple(out[0][0].shape)} "
          f"{out[0][0].dtype} on {out[0][0].context}, labels padded to "
          f"{tuple(out[0][1].shape)}", flush=True)
    return out


def _ssd_anchors(sm, device):
    """SSD-512's anchors made eagerly, map by map (32 ... 1)."""
    import torch
    from mxnet_tpu_torch.ops import nn as pnn

    maps = [SSD_SIDE // 16 >> i for i in range(6)]
    return torch.cat([pnn.MultiBoxPrior(
        torch.empty((1, 1, m, m), device=device), sizes=s, ratios=r,
        steps=(st, st)) for m, s, r, st in zip(
            maps, sm.SSD512_SIZES, sm.SSD512_RATIOS, sm.SSD512_STEPS)], 1)


def ssd_train(batches):
    """22.1: SSD-512 on ResNet-50 v1 (GluonCV's ssd_512_resnet50_v1_voc,
    NHWC, bf16), 8 ``Trainer.fused_step`` calls of 32 images, anchors,
    targets and loss inside the captured step, ``MXNET_FUSED_CONV_BWD=1``:
    one capture, ``SSD_K6`` K6 nodes, 6,132 anchors, losses finite, the
    first class loss within 1.0 of ln 21; the targets of the last replay
    equal ``MultiBoxTarget`` run eagerly on its batch bit for bit, and on
    the CPU (cls_target and loc_mask exact, loc_target within 1e-5).
    Printed: ms a step over steps 3-8."""
    import math

    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon import fused_step as fsm
    from mxnet_tpu_torch.gluon.block import _GraphProgram
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    from mxnet_tpu_torch.ops import conv_fused as cf
    from mxnet_tpu_torch.ops import nn as pnn

    sm = _ssd_models()
    os.environ["MXNET_FUSED_CONV_BWD"] = "1"
    net = sm.ssd(mx, get_model("resnet50_v1", classes=1000, layout="NHWC"))
    net.initialize(mx.init.Xavier(rnd_type="uniform", factor_type="avg",
                                  magnitude=3), ctx=mx.gpu(0))
    net.cast("bfloat16")
    loss_blk = sm.ssd_loss(mx, net, "bfloat16")
    trainer = gluon.Trainer(net.collect_params(), "sgd", SSD_OPT)

    def loss_fn(x, y):
        return loss_blk(x, y)

    fsm.reset_step_counters()
    cf.conv1x1_bwd_pair.launches = 0
    losses, cls_losses, stamps = [], [], []
    _GraphProgram.debug = True
    try:
        for k, (x, y) in enumerate(batches):
            if k == 1:
                _GraphProgram.debug = False
            if k == 2:
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())
            out = trainer.fused_step(loss_fn, x, y)
            losses.append(out[0]._data.float().mean())
            cls_losses.append(out[1]._data.float().mean())
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    finally:
        _GraphProgram.debug = False
    counters = dict(fsm.step_counters)
    fs, prog = _apply_program(trainer)
    k6_runs = cf.conv1x1_bwd_pair.launches - prog.launches.get(
        "conv1x1_bwd", 0) + fs.launches().get("conv1x1_bwd", 0)
    counts, every = _graph_nodes(prog, ("conv1x1_bwd",))
    _print_nodes("ssd train graph", every)
    ms = (stamps[1] - stamps[0]) / (len(batches) - 2) * 1e3
    losses = [float(v) for v in losses]
    cls_losses = [float(v) for v in cls_losses]
    # the last replay's targets against MultiBoxTarget run eagerly
    loc_t, mask, cls_t = (o._data for o in out[2:5])
    anchors = _ssd_anchors(sm, "cuda")
    eager = pnn.MultiBoxTarget(anchors, y._data, None,
                               overlap_threshold=0.5)
    in_graph = all(torch.equal(a, b) for a, b in zip((loc_t, mask, cls_t),
                                                     eager))
    cpu = pnn.MultiBoxTarget(anchors.cpu(), y._data.cpu(), None,
                             overlap_threshold=0.5)
    loc_err = float((loc_t.cpu() - cpu[0]).abs().max())
    cpu_exact = torch.equal(mask.cpu(), cpu[1]) and \
        torch.equal(cls_t.cpu(), cpu[2])
    positives = int((cls_t > 0).sum())
    row = dict(losses=losses, cls_losses=cls_losses, ms_per_step=ms,
               images_per_s=SSD_B / ms * 1e3, anchors=anchors.shape[1],
               step_counters=counters, k6_nodes=counts["conv1x1_bwd"],
               launches_a_replay=prog.launches,
               launches=dict(conv1x1_bwd=k6_runs),
               targets_in_graph_equal=in_graph,
               targets_cpu_exact=cpu_exact, loc_target_cpu_err=loc_err,
               positives=positives)
    print(f"ssd train: ssd_512_resnet50_v1_voc NHWC bf16, batch {SSD_B} of "
          f"{SSD_SIDE}x{SSD_SIDE}, {anchors.shape[1]} anchors, "
          f"Trainer.fused_step x{len(losses)}; losses "
          f"{[round(v, 4) for v in losses]}; class losses "
          f"{[round(v, 4) for v in cls_losses]} (ln 21 = "
          f"{math.log(21):.4f}); {ms:.3f} ms a step over steps 3-"
          f"{len(losses)} ({row['images_per_s']:.2f} images/s, "
          f"{card_line()})", flush=True)
    print(f"ssd train: step_counters {counters}; K6 nodes {counts} "
          f"(expected {SSD_K6}); launches a replay {prog.launches}; K6 ran "
          f"{k6_runs} times; targets of the last replay == eager "
          f"MultiBoxTarget: {in_graph}; vs the CPU: cls_target/loc_mask "
          f"exact {cpu_exact}, loc_target max err {loc_err:.3e}; "
          f"{positives} positive anchors", flush=True)
    if anchors.shape[1] != SSD_ANCHORS:
        fail(f"ssd train: {anchors.shape[1]} anchors, expected "
             f"{SSD_ANCHORS}")
    if counts["conv1x1_bwd"] != SSD_K6:
        fail(f"ssd train: {counts['conv1x1_bwd']} K6 nodes in the step "
             f"graph, expected {SSD_K6}")
    if counters["legacy_steps"] or counters["compiles"] != 1 or \
            counters["apply_dispatches"] != len(batches):
        fail(f"ssd train: expected {len(batches)} fused steps with one "
             f"capture, got {counters}")
    if not all(math.isfinite(v) for v in losses + cls_losses) or \
            abs(cls_losses[0] - math.log(21)) > 1.0:
        fail(f"ssd train: losses {losses}, class losses {cls_losses} (the "
             f"first within 1.0 of ln 21)")
    if not in_graph or not cpu_exact or loc_err > 1e-5:
        fail("ssd train: the step's targets disagree with MultiBoxTarget "
             "run eagerly or on the CPU")
    del prog, fs, trainer, loss_blk, loss_fn
    return net, row


def _nms_bound(rows, keep_lim, out):
    """The least time of greedy NMS over ``rows`` (R, n, 6) on an H100:
    the rows read and the scores written once, against the IoUs this
    data needs (each kept row among the first ``keep_lim`` tests every
    later row), ``IOU_OPS`` f32 operations each."""
    import torch
    from mxnet_tpu_torch.ops import box_nms as bn

    r, n = rows.shape[:2]
    order = bn.score_order(out[..., 1])
    ranked = out[..., 1].gather(1, order)
    pos = torch.arange(n, device=rows.device)
    live = (ranked != -1) & (pos < keep_lim)
    ious = float(((n - 1 - pos) * live).sum())
    nbytes = r * n * (6 + 1) * 4
    t_ops, t_bytes = ious * IOU_OPS / H100_F32_FLOPS, nbytes / H100_BYTES_S
    return max(t_ops, t_bytes) * 1e3, \
        ("operations" if t_ops > t_bytes else "bytes"), ious


def _plain_nms(rows, keep_lim, thresh, ids=True):
    """``box_nms``'s result on ``rows`` through the plain version."""
    from mxnet_tpu_torch.ops import box_nms as bn

    s = rows[..., 1]
    new = bn.nms_scores_plain(s, rows[..., 2:6],
                              rows[..., 0] if ids else None,
                              bn.score_order(s), keep_lim, thresh, 0.0)
    out = rows.clone()
    out[..., 1] = new
    return out


def ssd_detection(net, batches):
    """22.2: the trained net's ``hybridize()`` forward, softmax and
    ``MultiBoxDetection(threshold=0.01, nms_threshold=0.45,
    nms_topk=400)`` as one replayed forward with the box_nms kernel a node
    of its graph; its rows equal the plain box_nms on the same inputs on
    the card bit for bit, and again at nms_topk=-1 (all 6,132).  Printed:
    ms a detection call, the kernel's ms alone, its bound."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.block import _GraphProgram
    from mxnet_tpu_torch.ops import box_nms as bn
    from mxnet_tpu_torch.ops import nn as pnn

    sm = _ssd_models()
    detect = sm.ssd_detect(mx, net, "bfloat16", threshold=0.01,
                           nms_threshold=0.45, nms_topk=400)
    detect.hybridize()
    x = batches[0][0]
    bn.nms_scores.launches = 0
    _GraphProgram.debug = True
    try:
        outs = [[o._data.clone() for o in detect(x)] for _ in range(3)]
    finally:
        _GraphProgram.debug = False
    op = detect._cached_op
    prog = next(p for p in op._programs.values() if p.graph is not None)
    # the eager call's launch and the replays' (the capture records one)
    launches = bn.nms_scores.launches - prog.launches.get("box_nms", 0) + \
        prog.replays * prog.launches.get("box_nms", 0)
    counts, every = _graph_nodes(prog, ("box_nms",))
    _print_nodes("ssd detect graph", every)
    rows, prob, loc, anchors = outs[2]
    pre = pnn.multibox_rows(prob, loc, anchors, threshold=0.01)
    plain = _plain_nms(pre, 400, 0.45)
    bits = torch.equal(rows, plain) and torch.equal(outs[1][0], rows)
    everything = pnn.box_nms(pre, overlap_thresh=0.45, topk=-1,
                             coord_start=2, score_index=1, id_index=0)
    plain_all = _plain_nms(pre, SSD_ANCHORS, 0.45)
    bits_all = torch.equal(everything, plain_all)
    det_ms = cuda_ms(lambda i: detect(x), 5)
    s, b, ids = pre[..., 1], pre[..., 2:6], pre[..., 0]
    order = bn.score_order(s)

    def kernel(keep):
        return lambda i: bn.nms_scores(s, b, ids, order, keep, 0.45, 0.0)

    k_ms = cuda_ms(kernel(400), 20)
    k_all_ms = cuda_ms(kernel(SSD_ANCHORS), 5)
    p_ms = cuda_ms(lambda i: bn.nms_scores_plain(s, b, ids, order, 400,
                                                 0.45, 0.0), 1, warm=1)
    bound, by, ious = _nms_bound(pre, 400, rows)
    bound_all, by_all, ious_all = _nms_bound(pre, SSD_ANCHORS, everything)
    kept = int((rows[..., 1] != -1).sum())
    row = dict(graph_box_nms_nodes=counts["box_nms"], bit_equal=bits,
               bit_equal_all=bits_all, det_ms=det_ms, ms=k_ms,
               ms_all=k_all_ms, plain_ms=p_ms, bound_ms=bound, bound_by=by,
               ious=ious, bound_ms_all=bound_all, bound_by_all=by_all,
               ious_all=ious_all, kept=kept, launches=launches,
               max_abs_err=float((rows - plain).abs().max()))
    print(f"ssd detect: hybridized forward + softmax + MultiBoxDetection("
          f"threshold=0.01, nms_threshold=0.45, nms_topk=400) at batch "
          f"{SSD_B}: {det_ms:.3f} ms a call (replay, {card_line()}); "
          f"box_nms nodes in the graph {counts['box_nms']}; {kept} rows "
          f"kept; rows == plain box_nms on the card: {bits}; at "
          f"nms_topk=-1: {bits_all}", flush=True)
    print(f"ssd detect: box_nms kernel {k_ms:.4f} ms (keep_lim 400) and "
          f"{k_all_ms:.4f} ms (all {SSD_ANCHORS}) for {SSD_B} rows; plain "
          f"{p_ms:.3f} ms (keep_lim 400); bound {bound:.6f} ms ({by}, "
          f"{ious:.0f} IoUs) and {bound_all:.6f} ms ({by_all}, "
          f"{ious_all:.0f} IoUs)", flush=True)
    if counts["box_nms"] < 1 or not bits or not bits_all:
        fail("ssd detect: the box_nms kernel is not in the graph or its "
             "rows differ from the plain version's")
    del detect, op, prog, outs
    return row


def _peak(fn):
    """``fn()``'s result and its peak device bytes above the bytes
    allocated before it."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def _roi_run(mx, name, feat, rois, head, ctx, kw):
    x = mx.nd.array(feat, ctx=ctx)
    r = mx.nd.array(rois, ctx=ctx)
    x.attach_grad()
    with mx.autograd.record():
        out = getattr(mx.nd, name)(x, r, **kw)
    out.backward(mx.nd.array(head, ctx=ctx))
    return out.asnumpy(), x.grad.asnumpy()


def rcnn_proposals():
    """22.3: Faster R-CNN's proposal head at the published settings: one
    600x1000 image, ResNet-50's C4 feature (1, 1024, 38, 63), the RPN head
    (A = 9), ``Proposal`` (6000 before NMS at 0.7, 300 after), then
    ``ROIAlign`` (14x14, 1/16, sample_ratio 2) and ``ROIPooling`` (7x7,
    1/16) on its ROIs: the ROIs equal the same code on the CPU bit for bit
    in order, pooled outputs and data gradients within 1e-5 of the CPU's
    (f32, TF32 off; the CPU pools the first ``RCNN_CPU_CHANNELS`` of the
    1024 channels, each channel's result its own, to keep the script's
    time); peak memory of each op printed."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    from mxnet_tpu_torch.ops import box_nms as bn
    from mxnet_tpu_torch.ops import nn as pnn

    sm = _ssd_models()
    base = get_model("resnet50_v1", classes=1000)
    c4 = gluon.nn.HybridSequential(prefix="")
    for i in range(7):
        c4.add(base.features[i])
    head = sm.rpn(mx, 9)
    c4.initialize(mx.init.Xavier(magnitude=2), ctx=mx.gpu(0))
    head.initialize(ctx=mx.gpu(0))
    rs = np.random.RandomState(23)
    img = mx.nd.array(rs.standard_normal((1, 3, RCNN_H, RCNN_W)).astype(
        np.float32), ctx=mx.gpu(0))
    feat = c4(img)
    cls_prob, bbox_pred = head(feat)
    info = mx.nd.array(np.array([[RCNN_H, RCNN_W, 1.0]], np.float32),
                       ctx=mx.gpu(0))
    if list(feat.shape) != [1, 1024, 38, 63]:
        fail(f"rcnn: C4 feature {list(feat.shape)}, expected [1, 1024, 38, "
             f"63]")
    bn.nms_scores.launches = 0
    (rois, scores), prop_peak = _peak(lambda: mx.nd.Proposal(
        cls_prob, bbox_pred, info, output_score=True, **RCNN_PROPOSAL))
    launches = bn.nms_scores.launches
    with mx.cpu():
        c_rois, c_scores = mx.nd.Proposal(
            mx.nd.array(cls_prob.asnumpy()), mx.nd.array(bbox_pred.asnumpy()),
            mx.nd.array(info.asnumpy()), output_score=True, **RCNN_PROPOSAL)
    g_rois = rois.asnumpy()
    rois_equal = np.array_equal(g_rois, c_rois.asnumpy()) and \
        np.array_equal(scores.asnumpy(), c_scores.asnumpy())
    prop_ms = cuda_ms(lambda i: mx.nd.Proposal(cls_prob, bbox_pred, info,
                                               **RCNN_PROPOSAL), 5)
    # the NMS of that call alone, at 6,000 rows
    kw = {k: RCNN_PROPOSAL[k] for k in ("rpn_pre_nms_top_n", "rpn_min_size",
                                         "scales", "ratios",
                                         "feature_stride")}
    pre_rows = pnn.proposal_rows(cls_prob._data, bbox_pred._data, info._data,
                                 **kw)
    s, b = pre_rows[..., 1], pre_rows[..., 2:6]
    order = bn.score_order(s)
    k_ms = cuda_ms(lambda i: bn.nms_scores(s, b, None, order, s.shape[1],
                                           0.7, 0.0), 5)
    k_out = pre_rows.clone()
    k_out[..., 1] = bn.nms_scores(s, b, None, order, s.shape[1], 0.7, 0.0)
    p_ms = cuda_ms(lambda i: bn.nms_scores_plain(s, b, None, order,
                                                 s.shape[1], 0.7, 0.0), 1,
                   warm=0)
    bound, by, ious = _nms_bound(pre_rows, s.shape[1], k_out)
    f = feat.asnumpy()
    row = dict(feature=list(f.shape), rois=list(g_rois.shape),
               rois_equal_cpu=rois_equal, proposal_ms=prop_ms,
               proposal_peak_bytes=prop_peak, nms_ms=k_ms, nms_plain_ms=p_ms,
               nms_bound_ms=bound, nms_bound_by=by, nms_ious=ious,
               launches=launches)
    pooled = {}
    for name, kw in (("ROIAlign", dict(pooled_size=(14, 14),
                                       spatial_scale=1 / 16,
                                       sample_ratio=2)),
                     ("ROIPooling", dict(pooled_size=(7, 7),
                                         spatial_scale=1 / 16))):
        ph, pw = kw["pooled_size"]
        grad_head = rs.standard_normal((g_rois.shape[0], f.shape[1], ph,
                                        pw)).astype(np.float32)
        (g_out, g_grad), peak = _peak(lambda: _roi_run(
            mx, name, f, g_rois, grad_head, mx.gpu(0), kw))
        x = mx.nd.array(f, ctx=mx.gpu(0))
        r = mx.nd.array(g_rois, ctx=mx.gpu(0))
        fwd_ms = cuda_ms(lambda i: getattr(mx.nd, name)(x, r, **kw), 3)
        t0 = time.perf_counter()
        k = RCNN_CPU_CHANNELS
        c_out, c_grad = _roi_run(mx, name, f[:, :k], g_rois,
                                 grad_head[:, :k], mx.cpu(), kw)
        cpu_s = time.perf_counter() - t0
        g_out, g_grad = g_out[:, :k], g_grad[:, :k]
        ok = np.allclose(g_out, c_out, rtol=OP_TOL, atol=OP_TOL) and \
            np.allclose(g_grad, c_grad, rtol=OP_TOL, atol=OP_TOL)
        pooled[name] = dict(ok=ok, out_err=float(np.abs(g_out - c_out).max()),
                            grad_err=float(np.abs(g_grad - c_grad).max()),
                            peak_bytes=peak, fwd_ms=fwd_ms, cpu_s=cpu_s,
                            shape=list(g_out.shape))
    row["pooled"] = pooled
    print(f"rcnn: C4 feature {list(f.shape)}, Proposal(scales=(8, 16, 32), "
          f"ratios=(0.5, 1, 2), 6000 -> NMS 0.7 -> 300, min size 16) "
          f"{prop_ms:.3f} ms a call, peak {prop_peak} B above its inputs "
          f"({card_line()}); ROIs {list(g_rois.shape)} == the CPU's bit for "
          f"bit in order: {rois_equal}; its NMS at 6000 rows: kernel "
          f"{k_ms:.4f} ms, plain {p_ms:.3f} ms, bound {bound:.6f} ms ({by}, "
          f"{ious:.0f} IoUs)", flush=True)
    for name, p in pooled.items():
        print(f"rcnn: {name} {p['shape']}: forward {p['fwd_ms']:.3f} ms, "
              f"forward+backward peak {p['peak_bytes']} B; card vs CPU "
              f"out err {p['out_err']:.3e}, data grad err "
              f"{p['grad_err']:.3e} (tol {OP_TOL}, the first "
              f"{RCNN_CPU_CHANNELS} channels); the CPU took {p['cpu_s']:.2f} "
              f"s", flush=True)
    if not rois_equal or not all(p["ok"] for p in pooled.values()):
        fail("rcnn: the ROIs or the pooled outputs disagree with the CPU")
    return row


SWEEP_FAMILIES = ("spatial transformer", "deformable", "correlation", "fft",
                  "image", "quantization")
# values that are long sums (by index into outputs + input gradients): the
# deformable convolution's gradients (a GEMM over 8,192 rows or 4,608
# columns; the bias's over 8,192 positions), the correlation's (441
# displacements of 256 channels), the sampler's grid gradient (64
# channels, times (w - 1) / 2), fft/ifft (1,024 terms, cuFFT against
# pocketfft): the card sums them in another order (split-K, atomics, its
# own FFT), so each is held to OP_WGRAD_TOL of its largest magnitude, as
# phase 20.1 holds a convolution's weight gradient
SWEEP_SUMMED = {"DeformableConvolution": (1, 2, 3, 4), "Correlation": (1, 2),
                "BilinearSampler": (2,), "fft": (0,), "ifft": (0,)}


def _sweep_cases(np):
    rs = np.random.RandomState(24)
    n = np.float32
    theta = (np.eye(2, 3)[None] + rs.uniform(-0.1, 0.1, (32, 2, 3))).astype(n)
    cases = [
        ("spatial transformer", "GridGenerator",
         [theta.reshape(32, 6)], dict(transform_type="affine",
                                      target_shape=(64, 64))),
    ]
    grid = np.concatenate([
        np.stack(np.meshgrid(np.linspace(-1, 1, 64), np.linspace(-1, 1, 64))
                 )[None]] * 32) + rs.uniform(-0.05, 0.05, (32, 2, 64, 64))
    cases.append(("spatial transformer", "BilinearSampler",
                  [rs.standard_normal((32, 64, 64, 64)).astype(n),
                   grid.astype(n)], {}))
    for g in (1, 4):
        cases.append(("deformable", "DeformableConvolution",
                      [rs.standard_normal((8, 512, 32, 32)).astype(n),
                       (rs.standard_normal((8, 2 * g * 9, 32, 32)) *
                        2).astype(n),
                       (rs.standard_normal((512, 512, 3, 3)) * 0.02).astype(n),
                       rs.standard_normal(512).astype(n)],
                      dict(kernel=(3, 3), pad=(1, 1), num_filter=512,
                           num_deformable_group=g)))
    cases.append(("correlation", "Correlation",
                  [rs.standard_normal((4, 256, 48, 64)).astype(n),
                   rs.standard_normal((4, 256, 48, 64)).astype(n)],
                  dict(pad_size=20, kernel_size=1, max_displacement=20,
                       stride1=1, stride2=2)))
    cases.append(("fft", "fft", [rs.standard_normal((64, 1024)).astype(n)],
                  {}))
    cases.append(("fft", "ifft", [rs.standard_normal((64, 2048)).astype(n)],
                  {}))
    return cases


def _image_sweep(mx, np, bad, errs):
    """Every ``mx.nd.image`` op on a 32x512x512x3 uint8 batch, card vs CPU:
    the deterministic ones equal (f32 within ``OP_TOL``, a resized uint8
    within one step where the sums round across an integer), the random
    ones by their rules and, from the same seed, equal."""
    imgs = np.random.RandomState(25).randint(0, 256, (32, 512, 512, 3)) \
        .astype(np.uint8)

    def run(ctx, short, data, kw, seed=None):
        with ctx:
            if seed is not None:
                mx.random.seed(seed)
            x = mx.nd.array(data, ctx=ctx, dtype=str(data.dtype))
            return getattr(mx.nd.image, short)(x, **kw).asnumpy()

    tensor = run(mx.cpu(), "to_tensor", imgs, {})
    cases = [("to_tensor", imgs, {}),
             ("normalize", tensor, dict(mean=(0.485, 0.456, 0.406),
                                        std=(0.229, 0.224, 0.225))),
             ("resize", imgs, dict(size=(300, 300), interp=1)),
             ("resize", imgs, dict(size=(300, 300), interp=0)),
             ("resize", imgs[:4], dict(size=(700, 600), interp=1)),
             ("resize", imgs[:4].astype(np.float32), dict(size=(300, 300))),
             ("crop", imgs, dict(x=10, y=20, width=300, height=200)),
             ("flip_left_right", imgs, {}), ("flip_top_bottom", imgs, {})]
    resize_off = 0
    for short, data, kw in cases:
        g, c = run(mx.gpu(0), short, data, kw), run(mx.cpu(), short, data, kw)
        if g.dtype == np.uint8:
            d = np.abs(g.astype(int) - c.astype(int))
            resize_off += int((d > 0).sum())
            ok, e = bool((d <= 1).all()), float(d.max())
        else:
            ok = np.allclose(g, c, rtol=OP_TOL, atol=OP_TOL)
            e = float(np.abs(g - c).max())
        key = f"image.{short}" + (f"{kw['size']}/{kw.get('interp', 1)}/"
                                  f"{data.dtype}" if short == "resize"
                                  else "")
        errs[key] = e
        if not ok:
            bad.append((f"image.{short}", e))
    for short, axis in (("random_flip_left_right", 2),
                        ("random_flip_top_bottom", 1)):
        g = run(mx.gpu(0), short, imgs, {}, seed=5)
        c = run(mx.cpu(), short, imgs, {}, seed=5)
        same = (g == imgs).all(axis=(1, 2, 3))
        flip = (g == np.flip(imgs, axis)).all(axis=(1, 2, 3))
        if not ((same | flip).all() and np.array_equal(g, c)):
            bad.append((f"image.{short}", "rules"))
    for short in ("random_brightness", "random_contrast",
                  "random_saturation"):
        g = run(mx.gpu(0), short, imgs, dict(min_factor=0.7,
                                             max_factor=1.3), seed=6)
        c = run(mx.cpu(), short, imgs, dict(min_factor=0.7,
                                            max_factor=1.3), seed=6)
        with mx.cpu():
            mx.random.seed(6)
            f = 0.7 + 0.6 * mx.random.key_uniform(32).numpy()
        ok = np.allclose(g, c, rtol=OP_TOL, atol=1e-3) and \
            ((f >= 0.7) & (f <= 1.3)).all()
        errs[f"image.{short}"] = float(np.abs(g - c).max())
        if not ok:
            bad.append((f"image.{short}", errs[f"image.{short}"]))
    return len(cases) + 5, resize_off


def _quant_sweep(mx, np, bad):
    rs = np.random.RandomState(26)
    a = rs.randint(-127, 128, (4096, 768)).astype(np.int8)
    b = rs.randint(-127, 128, (768, 3072)).astype(np.int8)
    x = rs.randint(-127, 128, (32, 256, 14, 14)).astype(np.int8)
    w = rs.randint(-127, 128, (256, 256, 3, 3)).astype(np.int8)
    out = {}
    for name, arrays, kw in (("quantized_matmul_int8", (a, b), {}),
                             ("quantized_conv_int8", (x, w),
                              dict(pad=(1, 1)))):
        res = []
        for ctx in (mx.gpu(0), mx.cpu()):
            nds = [mx.nd.array(v, ctx=ctx, dtype="int8") for v in arrays]
            res.append(getattr(mx.nd, name)(*nds, **kw).asnumpy())
        exact = res[0].dtype == np.int32 and np.array_equal(*res)
        out[name] = dict(exact=exact, largest=int(np.abs(res[1]).max()))
        if not exact:
            bad.append((name, "not exact"))
    g_ms = cuda_ms(lambda i: mx.nd.quantized_matmul_int8(
        mx.nd.array(a, ctx=mx.gpu(0), dtype="int8"),
        mx.nd.array(b, ctx=mx.gpu(0), dtype="int8")), 3)
    out["matmul_ms"] = g_ms
    return out


def detection_sweep():
    """22.4: the rest of the slice at full size, card vs CPU in f32,
    outputs and every float input's gradient within ``OP_TOL`` (the long
    sums of ``SWEEP_SUMMED`` within ``OP_WGRAD_TOL`` of their largest
    magnitude), counted by family;
    every ``mx.nd.image`` op on a 32x512x512x3 uint8 batch; the int8
    products exactly equal to the CPU's int32."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops.registry import OPS

    counts = {f: 0 for f in SWEEP_FAMILIES}
    bad, errs = [], {}
    for family, name, arrays, kw in _sweep_cases(np):
        differentiable = OPS[getattr(mx.nd, name)._op.name].differentiable
        rs = np.random.RandomState(len(errs))
        outs, _ = _op_run(mx, name, arrays, kw, mx.cpu())
        heads = [rs.standard_normal(o.shape).astype(np.float32)
                 for o in outs] if differentiable else None
        c_out, c_grad = _op_run(mx, name, arrays, kw, mx.cpu(), heads)
        g_out, g_grad = _op_run(mx, name, arrays, kw, mx.gpu(0), heads)
        if heads is None:
            c_grad = g_grad = []
        err = 0.0
        for i, (g, c) in enumerate(zip(g_out + g_grad, c_out + c_grad)):
            if c is None:
                continue
            if i in SWEEP_SUMMED.get(name, ()):
                e = float(np.abs(g - c).max()) / max(float(np.abs(c).max()),
                                                     1e-30)
                ok = e <= OP_WGRAD_TOL
            else:
                e = float(np.abs(g - c).max())
                ok = np.allclose(g, c, rtol=OP_TOL, atol=OP_TOL)
            err = max(err, e)
            if not ok:
                bad.append((name, i, e))
        key = f"{name}{kw.get('num_deformable_group', '')}"
        errs[key] = err
        counts[family] += 1
    n_img, resize_off = _image_sweep(mx, np, bad, errs)
    counts["image"] += n_img
    quant = _quant_sweep(mx, np, bad)
    counts["quantization"] += 2
    row = dict(families=counts, errors=errs, quant=quant,
               resized_uint8_off_by_one=resize_off, bad=bad)
    print(f"detection sweep: card vs CPU, f32, TF32 off: by family "
          f"{counts}; max errors (of the largest magnitude for the long "
          f"sums) "
          f"{ {k: f'{v:.2e}' for k, v in errs.items()} } (tol {OP_TOL}, "
          f"long sums {OP_WGRAD_TOL} of the largest; "
          f"uint8 resizes within 1, {resize_off} pixels off by one); int8 "
          f"products {quant}", flush=True)
    if bad:
        fail(f"detection sweep: disagreeing {bad[:6]}")
    return row


def check_detection():
    """Phase 22: SSD-512 trained and run, Faster R-CNN's proposals and
    region pooling, and the sweep of the slice's other ops."""
    import tempfile

    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import box_nms as bn

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        rec, records = ssd_records(d)
        batches = ssd_batches(mx, rec)
    net, train = ssd_train(batches)
    detect = ssd_detection(net, batches)
    del net, batches
    torch.cuda.empty_cache()
    rcnn = rcnn_proposals()
    launches = detect["launches"] + rcnn["launches"]
    torch.cuda.empty_cache()
    sweep = detection_sweep()
    torch.cuda.synchronize()
    row = dict(records=records, train=train, detect=detect, rcnn=rcnn,
               sweep=sweep, launches=dict(box_nms=launches,
                                          conv1x1_bwd=train["launches"][
                                              "conv1x1_bwd"]),
               seconds=time.perf_counter() - t0)
    print(f"phase 22: box_nms launched {launches} times on the path (the "
          f"detection call's eager run and its replays, the Proposal "
          f"call); {row['seconds']:.2f} s", flush=True)
    if launches < 1:
        fail("phase 22: the box_nms kernel was never launched on the path")
    return row


# --------------------------------------------------------------------------- #
# phase 23: sequence models, the twentieth slice: Transformer-big on WMT14
# En-De widths, GluonNLP's standard_lstm_lm_650, the linalg and legacy ops
# --------------------------------------------------------------------------- #

# Vaswani et al. 2017, Table 3 "big" (WMT14 En-De, a shared BPE vocabulary
# of 37,000 tokens, section 5.1); bf16 weights with f32 masters
S2S_BIG = dict(vocab_size=37000, units=1024, hidden_size=4096, num_heads=16,
               num_enc_layers=6, num_dec_layers=6, max_length=1024,
               dropout=0.3, tie_embeddings=True)
S2S_ADAM = {"learning_rate": 0.0, "beta1": 0.9, "beta2": 0.98,
            "epsilon": 1e-9, "multi_precision": True}
S2S_WARMUP = 4000            # the paper's warm-up steps (section 5.3)
S2S_STEPS = 12               # eager, capture, 10 replays
# (pairs, source lengths, target lengths, padded source, padded target)
S2S_SHORT = (64, (16, 128), (16, 128), 128, 128)
S2S_LONG = (8, (640, 1024), (512, 768), 1024, 768)
# 23.2's cross-attention as K1-K3 see it: (B, H, D, Lq, Lk)
S2S_CROSS = (8, 16, 64, 768, 1024)
# the first loss's distance from ln(37000) allowed: Xavier on the tied
# (37000, 1024) embedding gives weights of variance 2 / 38024 = 5.26e-5;
# the decoder's final LayerNorm gives unit-variance features, so a logit
# has variance 1024 x 5.26e-5 = 0.054 and the expected loss is ln(37000) +
# 0.054 / 2 = 10.546; 0.2 leaves room for the batch's spread
S2S_LOSS_BOUND = 0.2
S2S_BITS = 3                 # fused against phase by phase, 2 + 2 layers
S2S_DECODE = (16, (16, 64), 64)   # sources, their lengths, max_len
LM_V = 33278                 # WikiText-2's vocabulary
LM_B, LM_T = 20, 35          # batch, bptt
LM_LR, LM_CLIP = 20.0, 0.25  # word_language_model.py's SGD and clip
LM_STEPS = 20                # the recipe arm (eager, as the reference's)
LM_FUSED = 12                # the fused arm: eager, capture, 10 replays
LM_BITS = 3
# Xavier on the tied (33278, 650) embedding: weight variance 2 / 33928 =
# 5.9e-5; the LSTM's output is tanh-bounded and small at the start
# (|h| rms ~0.1 or less), so a logit has variance at most ~650 x 5.9e-5 x
# 0.01 = 3.8e-4 and the loss is ln(33278) = 10.41 within ~0.01; 0.1
LM_LOSS_BOUND = 0.1
LM_E = LM_H = 650            # embedding and LSTM widths
LINALG_B, LINALG_N = 64, 256
SWEEP_IMG = (32, 3, 224, 224)      # ResNet-50's first convolution's input
SWEEP_CE = (8192, 37000)           # 23.1's target tokens x vocabulary


def _s2s_kernels():
    """K1 (and K2, K3) launches a step when every attention takes the
    kernels: encoder self, decoder self and cross, one each a layer."""
    return S2S_BIG["num_enc_layers"] + 2 * S2S_BIG["num_dec_layers"]


def _grouped_profile(what, fn, steps, top=6, groups=None):
    """``fn()`` (``steps`` steps) under ``torch.profiler``: the top
    kernels and the device time by group of kernel names (by default
    K1-K3, library GEMMs, the rest), ms a step each."""
    by_name, busy, wall_us = _profiled(fn)
    prof = report_profile(f"{what} profile", by_name, busy, wall_us, top=top)
    groups = groups or {"attention kernels": ("flash_",), "GEMMs": GEMM_KEYS}
    shares = {g: sum(us for n, us in by_name.items()
                     if any(k in n for k in keys))
              for g, keys in groups.items()}
    shares["other"] = busy - sum(shares.values())
    if busy > 0:
        print(f"{what} profile: by group " + ", ".join(
            f"{g} {us / busy:.4f} ({us / steps / 1e3:.3f} ms/step)"
            for g, us in shares.items()), flush=True)
    prof["groups_us"] = shares
    return prof


def _noam(step, units=1024, warmup=S2S_WARMUP):
    """The paper's learning rate at ``step`` (1-based)."""
    return units ** -0.5 * min(step ** -0.5, step * warmup ** -1.5)


def s2s_batch(mx, ctx, shape, vocab, seed):
    """Source and target token streams drawn with numpy from ``seed``:
    lengths from their ranges, tokens 3..vocab-1, padding 0; the
    teacher-forced input (``bos`` = 1, then the target shifted), the
    labels, per-token weights (0 at padding) and the (B, 1, 1, Ls)
    additive source mask."""
    import numpy as np

    B, (s0, s1), (t0, t1), Ls, Lt = shape
    rs = np.random.RandomState(seed)
    sl = rs.randint(s0, s1 + 1, B)
    tl = rs.randint(t0, t1 + 1, B)
    src = rs.randint(3, vocab, (B, Ls))
    src[np.arange(Ls)[None] >= sl[:, None]] = 0
    tgt = rs.randint(3, vocab, (B, Lt))
    tgt[np.arange(Lt)[None] >= tl[:, None]] = 0
    tgt_in = np.concatenate([np.ones((B, 1), np.int64), tgt[:, :-1]], 1)
    w = (np.arange(Lt)[None] < tl[:, None]).astype(np.float32)
    mask = np.where(np.arange(Ls)[None] >= sl[:, None], -1e30, 0.0) \
        .astype(np.float32).reshape(B, 1, 1, Ls)
    arr = functools.partial(mx.nd.array, ctx=ctx)
    return dict(src=arr(src, dtype="int32"), tgt_in=arr(tgt_in, dtype="int32"),
                tgt_out=arr(tgt, dtype="int32"), w=arr(w[..., None]),
                mask=arr(mask), tokens=int(tl.sum()), Lt=Lt, B=B)


def _s2s_net(mx, ctx, seed, dtype="bfloat16", **over):
    from mxnet_tpu_torch.models import Seq2SeqConfig

    with ctx:
        net = Seq2SeqConfig(**{**S2S_BIG, **over}, dtype=dtype).make()
    net.initialize(mx.init.Xavier(), ctx=ctx, seed=seed)
    return net


def _s2s_loss(mx, net):
    loss_l = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def loss_fn(src, tgt_in, tgt_out, w, mask):
        return loss_l(net(src, tgt_in, mask), tgt_out, w)
    return loss_fn


def _token_loss(per_sample, batch):
    """The per-sample losses (each a mean over the padded target) as the
    mean over the batch's real target tokens."""
    return float(per_sample.detach().float().sum()) * batch["Lt"] / \
        batch["tokens"]


def s2s_run(mx, net, shape, what, seed, kernels_per_step):
    """``S2S_STEPS`` ``Trainer.fused_step`` calls of ``net`` on one batch
    of ``shape``: Adam (beta2 0.98, eps 1e-9) multi-precision, the
    paper's warm-up/inverse-square-root rate written through
    ``set_learning_rate`` before every call (a device operand: one
    capture).  K1-K3 counted from 0: after the eager call and by what
    the replay's capture recorded, each gated at ``kernels_per_step``."""
    import math

    import torch
    from mxnet_tpu_torch.gluon import fused_step as fsm

    gpu = mx.gpu(0)
    batch = s2s_batch(mx, gpu, shape, S2S_BIG["vocab_size"], seed)
    trainer = mx.gluon.Trainer(net.collect_params(), "adam", dict(S2S_ADAM))
    loss_fn = _s2s_loss(mx, net)
    args = [batch[k] for k in ("src", "tgt_in", "tgt_out", "w", "mask")]
    fsm.reset_step_counters()
    _reset_attention_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, eager_counts, t0 = [], None, None
    for i in range(S2S_STEPS):
        if i == 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        trainer.set_learning_rate(_noam(i + 1))
        out = trainer.fused_step(loss_fn, *args, batch_size=batch["B"])
        losses.append(out._data)
        if i == 0:
            torch.cuda.synchronize()
            eager_counts = _attention_counts()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / (S2S_STEPS - 2) * 1e3
    peak = torch.cuda.max_memory_allocated()
    losses = [_token_loss(v, batch) for v in losses]
    fs, prog = _apply_program(trainer)
    launches = _fused_attention_launches(trainer)
    counters = dict(fsm.step_counters)
    tok_s = batch["tokens"] / ms * 1e3
    print(f"seq2seq {what}: Transformer-big 6 + 6 bf16, dropout 0.3, tied, "
          f"B={batch['B']} Ls={shape[3]} Lt={shape[4]} ({batch['tokens']} "
          f"target tokens), Adam multi-precision with the warm-up rate "
          f"({_noam(1):.3e} .. {_noam(S2S_STEPS):.3e}): {S2S_STEPS} "
          f"fused_step calls, losses a target token "
          f"{[round(v, 4) for v in losses]} (ln 37000 = "
          f"{math.log(37000):.4f}); K1/K2/K3 the eager step {eager_counts}, "
          f"a replay {prog.launches}, all {launches} (expected "
          f"{kernels_per_step} a step); step_counters {counters}", flush=True)
    print(f"seq2seq {what}: {ms:.3f} ms a step (replays 3-{S2S_STEPS}), "
          f"{tok_s:.1f} trained target tokens/s, peak {peak} B allocated; "
          f"{card_line()}", flush=True)
    if counters["compiles"] != 1 or counters["legacy_steps"]:
        fail(f"seq2seq {what}: step counters {counters}, expected one "
             "capture")
    if not all(math.isfinite(v) for v in losses):
        fail(f"seq2seq {what}: a loss is not finite: {losses}")
    if any(eager_counts[n] != kernels_per_step or
           prog.launches.get(n, 0) != kernels_per_step or
           launches[n] != kernels_per_step * S2S_STEPS
           for n in ATTN_KERNELS):
        fail(f"seq2seq {what}: K1/K2/K3 launched {eager_counts} in the "
             f"eager step and {prog.launches} a replay; expected "
             f"{kernels_per_step} each")
    # where a step's device time goes: two more replays, profiled (after
    # the gates, which count the 12 steps above)
    prof = _grouped_profile(f"seq2seq {what}", lambda: [
        trainer.fused_step(loss_fn, *args, batch_size=batch["B"])
        for _ in range(2)], 2)
    # the kernels line counts the profiled replays' launches too
    row = dict(B=batch["B"], Ls=shape[3], Lt=shape[4],
               tokens=batch["tokens"], losses=losses, ms_per_step=ms,
               tokens_per_s=tok_s, peak_bytes=peak,
               eager_launches=eager_counts, replay_launches=prog.launches,
               gated_launches=launches,
               launches=_fused_attention_launches(trainer),
               step_counters=counters, profile=prof)
    del fs, prog, trainer, out
    torch.cuda.empty_cache()
    return row


def s2s_bits(mx):
    """23.1, bit check: two Transformer-big-width models at 2 + 2 layers,
    dropout 0, bf16, from one seed; ``S2S_BITS`` ``fused_step`` calls on
    one (eager, capture and replay, replay) against as many phase-by-
    phase steps on the other, the same rate each step: the losses and
    every parameter bit for bit."""
    import torch

    gpu = mx.gpu(0)
    nets = [_s2s_net(mx, gpu, 11, num_enc_layers=2, num_dec_layers=2,
                     dropout=0.0) for _ in range(2)]
    batch = s2s_batch(mx, gpu, S2S_SHORT, S2S_BIG["vocab_size"], 12)
    args = [batch[k] for k in ("src", "tgt_in", "tgt_out", "w", "mask")]
    trainers = [mx.gluon.Trainer(n.collect_params(), "adam", dict(S2S_ADAM))
                for n in nets]
    loss_fn = _s2s_loss(mx, nets[0])
    loss_b = _s2s_loss(mx, nets[1])
    fused, phase = [], []
    for i in range(S2S_BITS):
        trainers[0].set_learning_rate(_noam(i + 1))
        fused.append(trainers[0].fused_step(loss_fn, *args,
                                            batch_size=batch["B"])
                     ._data.clone())
    for i in range(S2S_BITS):
        trainers[1].set_learning_rate(_noam(i + 1))
        with mx.autograd.record():
            loss = loss_b(*args)
        loss.backward()
        trainers[1].step(batch["B"])
        phase.append(loss._data.clone())
    del loss
    same = all(torch.equal(a, b) for a, b in zip(fused, phase))
    pa, pb = (n._collect_params_with_prefix() for n in nets)
    differ = [k for k in pa if not torch.equal(pa[k].data()._data,
                                               pb[k].data()._data)]
    print(f"seq2seq bits: 2 + 2 layers at Transformer-big width, dropout 0, "
          f"bf16, B={batch['B']} x {S2S_SHORT[3]}: {S2S_BITS} fused steps "
          f"against {S2S_BITS} "
          f"phase by phase: losses equal {same}, parameters that differ "
          f"{differ[:4]} ({len(differ)} of {len(pa)})", flush=True)
    if not same or differ:
        fail("seq2seq bits: the fused steps differ from the phase-by-phase "
             "steps")
    del nets, trainers, fused, phase
    torch.cuda.empty_cache()
    return dict(steps=S2S_BITS, losses_equal=same, params=len(pa),
                params_differing=differ)


def _decode_sources(mx, ctx, seed=21):
    import numpy as np

    n, (l0, l1), _ = S2S_DECODE
    rs = np.random.RandomState(seed)
    lens = rs.randint(l0, l1 + 1, n)
    src = rs.randint(3, S2S_BIG["vocab_size"], (n, l1))
    src[np.arange(l1)[None] >= lens[:, None]] = 0
    return mx.nd.array(src, ctx=ctx, dtype="int32")


def s2s_decode(mx, net, ctx, what):
    """``greedy_decode`` of the 16 sources at ``max_len`` 64: the tokens,
    the seconds, and ms a generated token."""
    import torch

    src = _decode_sources(mx, ctx)
    if ctx.device_type == "gpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ctx:
        toks = net.greedy_decode(src, max_len=S2S_DECODE[2], bos=1, eos=2)
    if ctx.device_type == "gpu":
        torch.cuda.synchronize()
    s = time.perf_counter() - t0
    gen = toks.shape[0] * (toks.shape[1] - 1)
    print(f"seq2seq decode {what}: {toks.shape[0]} sources, max_len "
          f"{S2S_DECODE[2]}: {toks.shape[1] - 1} steps, {s:.3f} s, "
          f"{s / gen * 1e3:.4f} ms a generated token "
          f"({gen / s:.1f} tokens/s)", flush=True)
    return toks, dict(seconds=s, generated=gen, ms_per_token=s / gen * 1e3,
                      tokens_per_s=gen / s)


def s2s_vs_cpu(mx):
    """23.3: Transformer-big widths at 2 + 2 layers in f32, dropout 0, the
    same weights on the card (TF32 off) and the CPU: one step (4 pairs of
    48 / 40 tokens with a source mask): the loss within 1e-4 relative
    (phase 8), every gradient within ``GLUON_GRAD_TOL`` of its array's
    largest magnitude (phase 20.3), the card's loss, gradients and
    weights finite, and after one Adam step at most 1% of the weights
    more than lr / 100 apart (phase 8's share).  The weights' largest
    difference is printed beside Adam's step bound, not gated: one step
    moves an element by at most lr, so two finite runs are always within
    2 lr.  Then ``greedy_decode`` of the 16 sources, tokens equal."""
    import numpy as np

    over = dict(num_enc_layers=2, num_dec_layers=2, dropout=0.0)
    cpu_net = _s2s_net(mx, mx.cpu(), 13, dtype="float32", **over)
    card_net = _s2s_net(mx, mx.gpu(0), 14, dtype="float32", **over)
    src = cpu_net._collect_params_with_prefix()
    for k, p in card_net._collect_params_with_prefix().items():
        p.set_data(src[k].data())
    res = {}
    for name, net, ctx in (("card", card_net, mx.gpu(0)),
                           ("cpu", cpu_net, mx.cpu())):
        batch = s2s_batch(mx, ctx, (4, (20, 48), (10, 40), 48, 40),
                          S2S_BIG["vocab_size"], 15)
        args = [batch[k] for k in ("src", "tgt_in", "tgt_out", "w", "mask")]
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": CPU_LR, "beta1": 0.9,
                                    "beta2": 0.98, "epsilon": 1e-9})
        t0 = time.perf_counter()
        with mx.autograd.record():
            loss = _s2s_loss(mx, net)(*args)
        loss.backward()
        params = net._collect_params_with_prefix()
        grads = {k: p.grad().asnumpy() for k, p in params.items()}
        trainer.step(batch["B"])
        res[name] = dict(loss=_token_loss(loss._data, batch), grads=grads,
                         w={k: p.data().asnumpy() for k, p in params.items()},
                         s=time.perf_counter() - t0)
    c, g = res["cpu"], res["card"]
    loss_rel = abs(g["loss"] - c["loss"]) / abs(c["loss"])
    errs = sorted(((float(np.abs(g["grads"][k] - v).max()) /
                    max(float(np.abs(v).max()), 1e-30), k)
                   for k, v in c["grads"].items()), reverse=True)
    worst, n_far, n_all = 0.0, 0, 0
    for k, v in c["w"].items():
        d = np.abs(g["w"][k] - v)
        worst = max(worst, float(d.max()))
        n_far += int((d > CPU_LR / 100).sum())
        n_all += d.size
    share = n_far / n_all
    finite = bool(np.isfinite(g["loss"])) and all(
        np.isfinite(v).all() for d in (g["grads"], g["w"])
        for v in d.values())
    print(f"seq2seq vs cpu: 2 + 2 layers f32 at Transformer-big width: loss "
          f"card {g['loss']:.6f} cpu {c['loss']:.6f} (rel {loss_rel:.3e}, "
          f"tol 1e-4); worst gradients "
          f"{[(f'{e:.3e}', k) for e, k in errs[:3]]} of each array's largest "
          f"magnitude (tol {GLUON_GRAD_TOL}); card finite {finite}; after "
          f"one Adam step weights max_abs_diff {worst:.3e} (Adam's bound "
          f"{2 * CPU_LR:.1e}, not a gate), share beyond lr/100 {share:.3e} "
          f"(tol 1e-2); seconds card {g['s']:.2f}, cpu {c['s']:.2f}",
          flush=True)
    if not finite or loss_rel > 1e-4 or errs[0][0] > GLUON_GRAD_TOL or \
            share > 1e-2:
        fail("seq2seq vs cpu: the card's step disagrees with the CPU's")
    card_toks, card_dec = s2s_decode(mx, card_net, mx.gpu(0), "f32 card")
    cpu_toks, cpu_dec = s2s_decode(mx, cpu_net, mx.cpu(), "f32 cpu")
    same = np.array_equal(card_toks, cpu_toks)
    print(f"seq2seq decode: f32 tokens card == cpu: {same} "
          f"({card_toks.shape})", flush=True)
    if not same:
        fail("seq2seq decode: the card's greedy tokens differ from the "
             "CPU's")
    return dict(loss_card=g["loss"], loss_cpu=c["loss"], loss_rel=loss_rel,
                grad_rel=errs[0][0], worst=errs[:3],
                weight_max_abs_diff=worst, share_beyond_lr_100=share,
                decode_card=card_dec, decode_cpu=cpu_dec,
                decode_tokens_equal=same)


def check_seq2seq():
    """23.1-23.3: Transformer-big on WMT14 En-De widths."""
    import math

    import torch
    import mxnet_tpu_torch as mx

    t0 = time.perf_counter()
    mx.random.seed(0)
    net = _s2s_net(mx, mx.gpu(0), 0)
    n_params = sum(p.data()._data.numel()
                   for p in net.collect_params().values())
    print(f"seq2seq: Transformer-big (WMT14 En-De), {n_params} parameters, "
          f"bf16, Xavier from seed 0, built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    short = s2s_run(mx, net, S2S_SHORT, "23.1", 1, 0)
    print("seq2seq 23.1: K1/K2/K3 launched 0 times: every attention "
          "product is at most 128 x 128 <= 512^2 scores, so "
          "ops/attention.py's flash_attention takes _plain_attn there, "
          "as the reference does", flush=True)
    first = short["losses"][0]
    if abs(first - math.log(S2S_BIG["vocab_size"])) > S2S_LOSS_BOUND:
        fail(f"seq2seq 23.1: first loss {first} is not within "
             f"{S2S_LOSS_BOUND} of ln 37000")
    long = s2s_run(mx, net, S2S_LONG, "23.2", 2, _s2s_kernels())
    bf16_toks, bf16_dec = s2s_decode(mx, net, mx.gpu(0), "bf16 6 + 6")
    del net
    torch.cuda.empty_cache()
    bits = s2s_bits(mx)
    vs_cpu = s2s_vs_cpu(mx)
    torch.cuda.empty_cache()
    return dict(parameters=n_params, short=short, long=long, bits=bits,
                vs_cpu=vs_cpu, decode_bf16=bf16_dec,
                launches={n: long["launches"][n] for n in ATTN_KERNELS},
                seconds=time.perf_counter() - t0)


def _lm_net(mx, ctx, seed, layers=2, dropout=0.5):
    _tests_path()
    from _torch_lstm_models import standard_lstm_lm

    with ctx:
        net = standard_lstm_lm(mx, LM_V, LM_E, LM_H, layers, dropout)
    net.initialize(mx.init.Xavier(), ctx=ctx, seed=seed)
    return net


def _lm_stream(mx, ctx, steps, seed=31):
    """A token stream drawn with numpy, cut into ``steps`` (T, N) batches
    and their next-token targets, the reference's ``batchify`` layout."""
    import numpy as np

    data = np.random.RandomState(seed).randint(0, LM_V,
                                               (steps * LM_T + 1, LM_B))
    return [(mx.nd.array(data[i * LM_T:(i + 1) * LM_T], ctx=ctx,
                         dtype="int32"),
             mx.nd.array(data[i * LM_T + 1:(i + 1) * LM_T + 1], ctx=ctx,
                         dtype="int32")) for i in range(steps)]


def lm_recipe(mx):
    """23.4, the recipe arm: ``word_language_model.py``'s loop, eager as
    the reference's (``clip_global_norm`` reads the norm back): the
    per-word loss over X.size, ``backward``, ``allreduce_grads``,
    ``clip_global_norm(grads, 0.25)``, ``update(1)``, SGD lr 20; the
    hidden state carried and detached between batches."""
    import math

    import torch

    gpu = mx.gpu(0)
    net = _lm_net(mx, gpu, 0)
    loss = _lm_fused_loss(mx, net)
    params = [p for p in net.collect_params().values()
              if p.grad_req != "null"]
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": LM_LR})
    h, c = net.begin_state(LM_B, ctx=gpu)
    losses, norms, t0 = [], [], None
    for i, (x, y) in enumerate(_lm_stream(mx, gpu, LM_STEPS)):
        if i == 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        h, c = h.detach(), c.detach()
        with mx.autograd.record():
            L, h, c = loss(x, y, h, c)
            L = L / (LM_T * LM_B)
        L.backward()
        trainer.allreduce_grads()
        norms.append(mx.gluon.utils.clip_global_norm(
            [p.grad() for p in params], LM_CLIP))
        trainer.update(1)
        losses.append(float(L._data.detach().sum()))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / (LM_STEPS - 2) * 1e3
    print(f"lstm lm recipe: standard_lstm_lm_650 (WikiText-2 vocabulary "
          f"{LM_V}, {LM_E} / 2 x LSTM {LM_H}, dropout 0.5, tied) f32, "
          f"{LM_B} x "
          f"bptt {LM_T}, SGD lr {LM_LR}, clip_global_norm {LM_CLIP}: "
          f"{LM_STEPS} eager steps, losses a word "
          f"{[round(v, 4) for v in losses]} (ln {LM_V} = "
          f"{math.log(LM_V):.4f}), global norms before clipping "
          f"{[round(v, 3) for v in norms[:4]]}...; {ms:.3f} ms a step "
          f"(steps 3-{LM_STEPS}), {LM_B * LM_T / ms * 1e3:.1f} words/s; "
          f"{card_line()}", flush=True)
    if not all(math.isfinite(v) for v in losses) or \
            abs(losses[0] - math.log(LM_V)) > LM_LOSS_BOUND:
        fail(f"lstm lm recipe: losses not finite or the first not within "
             f"{LM_LOSS_BOUND} of ln {LM_V}: {losses}")
    del net, trainer, params
    torch.cuda.empty_cache()
    return dict(losses=losses, norms=norms, ms_per_step=ms,
                words_per_s=LM_B * LM_T / ms * 1e3)


def _lm_fused_loss(mx, net):
    """The user's per-word loss of ``net`` (``lm_loss``): ``(loss, h,
    c)``."""
    _tests_path()
    from _torch_lstm_models import lm_loss

    return lm_loss(mx, net)


def lm_fused(mx):
    """23.4, the fused arm: the same model through ``Trainer.fused_step``
    with the optimizer's elementwise ``clip_gradient=0.25`` instead of
    the global norm, one replay a step, the carried state a static
    input (the step's new state is its output)."""
    import math

    import torch
    from mxnet_tpu_torch.gluon import fused_step as fsm

    gpu = mx.gpu(0)
    net = _lm_net(mx, gpu, 0)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": LM_LR,
                                "clip_gradient": LM_CLIP})
    loss_fn = _lm_fused_loss(mx, net)
    h, c = net.begin_state(LM_B, ctx=gpu)
    fsm.reset_step_counters()
    losses, t0 = [], None
    for i, (x, y) in enumerate(_lm_stream(mx, gpu, LM_FUSED)):
        if i == 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        L, h, c = trainer.fused_step(loss_fn, x, y, h, c,
                                     batch_size=LM_B * LM_T)
        losses.append(L._data)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / (LM_FUSED - 2) * 1e3
    losses = [float(v.mean()) for v in losses]
    counters = dict(fsm.step_counters)
    print(f"lstm lm fused: the same model through fused_step, "
          f"clip_gradient {LM_CLIP}: {LM_FUSED} calls, losses a word "
          f"{[round(v, 4) for v in losses]}; {ms:.3f} ms a step (replays "
          f"3-{LM_FUSED}), {LM_B * LM_T / ms * 1e3:.1f} words/s; "
          f"step_counters {counters}", flush=True)
    if counters["compiles"] != 1 or counters["legacy_steps"] or \
            not all(math.isfinite(v) for v in losses) or \
            abs(losses[0] - math.log(LM_V)) > LM_LOSS_BOUND:
        fail(f"lstm lm fused: counters {counters} or losses {losses}")
    state = [h, c]
    batches = _lm_stream(mx, gpu, 2, seed=34)

    def two_replays():
        for x, y in batches:
            _, state[0], state[1] = trainer.fused_step(
                loss_fn, x, y, *state, batch_size=LM_B * LM_T)
    prof = _grouped_profile("lstm lm fused", two_replays, 2)
    del net, trainer
    torch.cuda.empty_cache()
    return dict(losses=losses, ms_per_step=ms, step_counters=counters,
                words_per_s=LM_B * LM_T / ms * 1e3, profile=prof)


def lm_bits(mx):
    """23.4, bit check: two copies at full width, dropout 0, from one
    seed; ``LM_BITS`` fused steps (eager, capture and replay, replay)
    against as many phase-by-phase ones (``record``, ``backward``,
    ``step``, the same elementwise clip), the state carried in each:
    losses, states and every parameter bit for bit."""
    import torch

    gpu = mx.gpu(0)
    nets = [_lm_net(mx, gpu, 3, dropout=0.0) for _ in range(2)]
    opt = {"learning_rate": LM_LR, "clip_gradient": LM_CLIP}
    trainers = [mx.gluon.Trainer(n.collect_params(), "sgd", dict(opt))
                for n in nets]
    fused_fn = _lm_fused_loss(mx, nets[0])
    phase_fn = _lm_fused_loss(mx, nets[1])
    batches = _lm_stream(mx, gpu, LM_BITS, seed=32)
    res = []
    for k in range(2):
        h, c = nets[k].begin_state(LM_B, ctx=gpu)
        out = []
        for x, y in batches:
            if k == 0:
                L, h, c = trainers[0].fused_step(fused_fn, x, y, h, c,
                                                 batch_size=LM_B * LM_T)
            else:
                with mx.autograd.record():
                    L, h, c = phase_fn(x, y, h.detach(), c.detach())
                L.backward()
                trainers[1].step(LM_B * LM_T)
            out.append((L._data.clone(), h._data.clone(), c._data.clone()))
        res.append(out)
    del L
    same = all(torch.equal(a, b) for ra, rb in zip(*res)
               for a, b in zip(ra, rb))
    pa, pb = (n._collect_params_with_prefix() for n in nets)
    differ = [k for k in pa if not torch.equal(pa[k].data()._data,
                                               pb[k].data()._data)]
    print(f"lstm lm bits: full width, dropout 0: {LM_BITS} fused steps "
          f"against {LM_BITS} phase by phase: losses and states equal "
          f"{same}, parameters that differ {differ} of {len(pa)}",
          flush=True)
    if not same or differ:
        fail("lstm lm bits: the fused steps differ from the phase-by-phase "
             "steps")
    del nets, trainers
    torch.cuda.empty_cache()
    return dict(steps=LM_BITS, equal=same, params_differing=differ)


def lm_vs_cpu(mx):
    """23.4: a 1-layer copy at full width, f32, dropout 0, on the card
    (TF32 off) and the CPU from the same weights: the per-word loss
    within 1e-5 relative and every gradient within 1e-5 of its array's
    largest magnitude."""
    import numpy as np

    cpu_net = _lm_net(mx, mx.cpu(), 4, layers=1, dropout=0.0)
    card_net = _lm_net(mx, mx.gpu(0), 5, layers=1, dropout=0.0)
    src = cpu_net._collect_params_with_prefix()
    for k, p in card_net._collect_params_with_prefix().items():
        p.set_data(src[k].data())
    res = {}
    for name, net, ctx in (("card", card_net, mx.gpu(0)),
                           ("cpu", cpu_net, mx.cpu())):
        (x, y), = _lm_stream(mx, ctx, 1, seed=33)
        h, c = net.begin_state(LM_B, ctx=ctx)
        with mx.autograd.record():
            L, h, c = _lm_fused_loss(mx, net)(x, y, h, c)
        L.backward()
        res[name] = dict(loss=L.asnumpy(), grads={
            k: p.grad().asnumpy()
            for k, p in net._collect_params_with_prefix().items()})
    c, g = res["cpu"], res["card"]
    loss_rel = float(np.abs(g["loss"] - c["loss"]).max() /
                     np.abs(c["loss"]).max())
    errs = sorted(((float(np.abs(g["grads"][k] - v).max()) /
                    max(float(np.abs(v).max()), 1e-30), k)
                   for k, v in c["grads"].items()), reverse=True)
    print(f"lstm lm vs cpu: 1 layer f32 at full width: per-word losses rel "
          f"{loss_rel:.3e} (tol {GLUON_TOL}); worst gradients "
          f"{[(f'{e:.3e}', k) for e, k in errs[:3]]} of each array's "
          f"largest magnitude (tol {GLUON_TOL})", flush=True)
    if loss_rel > GLUON_TOL or errs[0][0] > GLUON_TOL:
        fail("lstm lm vs cpu: the card disagrees with the CPU")
    return dict(loss_rel=loss_rel, grad_rel=errs[0][0], worst=errs[:3])


def check_lstm_lm():
    """23.4: GluonNLP's standard_lstm_lm_650."""
    import mxnet_tpu_torch as mx

    t0 = time.perf_counter()
    mx.random.seed(0)
    row = dict(recipe=lm_recipe(mx), fused=lm_fused(mx), bits=lm_bits(mx),
               vs_cpu=lm_vs_cpu(mx))
    row["seconds"] = time.perf_counter() - t0
    return row


def _spd_batch(np, rs, b, n):
    """``b`` SPD matrices I + 0.1 A A^T / n (eigenvalues in [1, 1.4]), so
    det stays in f32's range at n = 256."""
    a = rs.standard_normal((b, n, n))
    return (np.eye(n) + 0.1 * a @ a.swapaxes(-1, -2) / n).astype(np.float32)


def seq_ops_sweep():
    """23.5: the linalg and legacy ops, card against CPU in f32 at the
    sizes users run them: 64 SPD 256 x 256 matrices (potri, inverse,
    det, slogdet, sumlogdiag), syevd and gelqf held by reconstruction and
    their invariants, gemm and trmm at 64 x 256²; im2col/col2im at
    ResNet-50's first convolution (32 x 3 x 224², 7 x 7, stride 2, pad
    3), softmax_cross_entropy at 8,192 x 37,000.  Each output is a long
    sum on one side or both, so each is held to ``OP_WGRAD_TOL`` of its
    largest magnitude (phase 20.1's rule); the gathers (im2col, the
    diagonal) to ``OP_TOL``."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx

    rs = np.random.RandomState(41)
    b, n = LINALG_B, LINALG_N
    M = _spd_batch(np, rs, b, n)
    L = np.linalg.cholesky(M.astype(np.float64)).astype(np.float32)
    A = rs.standard_normal((b, n, n)).astype(np.float32)
    B_ = rs.standard_normal((b, n, n)).astype(np.float32)
    C = rs.standard_normal((b, n, n)).astype(np.float32)
    img = rs.standard_normal(SWEEP_IMG).astype(np.float32)
    logits = rs.standard_normal(SWEEP_CE).astype(np.float32)
    labels = rs.randint(0, SWEEP_CE[1], SWEEP_CE[0]).astype(np.float32)
    conv = dict(kernel=(7, 7), stride=(2, 2), pad=(3, 3))
    cases = [("linalg_potri", [L], {}, "sum"),
             ("linalg_inverse", [M], {}, "sum"),
             ("linalg_det", [M], {}, "sum"),
             ("linalg_slogdet", [M], {}, "sum"),
             ("linalg_sumlogdiag", [L], {}, "sum"),
             ("linalg_gemm", [A, B_, C], dict(alpha=0.5, beta=2.0), "sum"),
             ("linalg_trmm", [A, B_], dict(alpha=1.5), "sum"),
             ("linalg_extractdiag", [A], {}, "gather"),
             ("im2col", [img], conv, "gather"),
             ("softmax_cross_entropy", [logits, labels], {}, "sum")]
    bad, errs, times = [], {}, {}
    for name, arrays, kw, kind in cases:
        res = []
        for ctx in (mx.gpu(0), mx.cpu()):
            with ctx:
                nds = [mx.nd.array(a) for a in arrays]
                outs = getattr(mx.nd, name)(*nds, **kw)
                outs = outs if isinstance(outs, list) else [outs]
                res.append([o.asnumpy() for o in outs])
                if ctx.device_type == "gpu":
                    times[name] = cuda_ms(
                        lambda i: getattr(mx.nd, name)(*nds, **kw), 5)
        err = 0.0
        for g, c in zip(*res):
            if kind == "sum":
                e = float(np.abs(g - c).max()) / max(float(np.abs(c).max()),
                                                     1e-30)
                ok = e <= OP_WGRAD_TOL
            else:
                e = float(np.abs(g - c).max())
                ok = np.allclose(g, c, rtol=OP_TOL, atol=OP_TOL)
            err = max(err, e)
            if not ok or not np.isfinite(g).all():
                bad.append((name, e))
        errs[name] = err
    # col2im of the card's patch matrix, back to the image's shape
    cols = None
    res = []
    for ctx in (mx.gpu(0), mx.cpu()):
        with ctx:
            cols = mx.nd.im2col(mx.nd.array(img), **conv)
            res.append(mx.nd.col2im(cols, output_size=SWEEP_IMG[2:],
                                    **conv).asnumpy())
    e = float(np.abs(res[0] - res[1]).max()) / float(np.abs(res[1]).max())
    errs["col2im"] = e
    if e > OP_WGRAD_TOL:
        bad.append(("col2im", e))
    # syevd and gelqf: their signs are the solvers' own (ROADMAP §3), so
    # they are held by reconstruction and invariants on the card
    with mx.gpu(0):
        U, w = (o.asnumpy().astype(np.float64)
                for o in mx.nd.linalg_syevd(mx.nd.array(M)))
        Q, Lq = (o.asnumpy().astype(np.float64)
                 for o in mx.nd.linalg_gelqf(mx.nd.array(A)))
        times["linalg_syevd"] = cuda_ms(
            lambda i: mx.nd.linalg_syevd(mx.nd.array(M)), 2, warm=1)
        times["linalg_gelqf"] = cuda_ms(
            lambda i: mx.nd.linalg_gelqf(mx.nd.array(A)), 2, warm=1)
    eye = np.eye(n)
    w_cpu = np.linalg.eigvalsh(M.astype(np.float64))
    rec = {"syevd": np.abs(U.swapaxes(-1, -2) @ (w[..., :, None] * U) -
                           M).max() / np.abs(M).max(),
           "syevd_orth": np.abs(U @ U.swapaxes(-1, -2) - eye).max(),
           "syevd_values": np.abs(w - w_cpu).max() / np.abs(w_cpu).max(),
           "gelqf": np.abs(Lq @ Q - A).max() / np.abs(A).max(),
           "gelqf_orth": np.abs(Q @ Q.swapaxes(-1, -2) - eye).max(),
           "gelqf_lower": np.abs(np.triu(Lq, 1)).max()}
    for k, v in rec.items():
        errs[k] = float(v)
        if v > OP_WGRAD_TOL:
            bad.append((k, float(v)))
    print(f"seq ops sweep: card vs CPU, f32, TF32 off: max errors (of the "
          f"largest magnitude for the long sums) "
          f"{ {k: f'{v:.2e}' for k, v in errs.items()} } (tol {OP_TOL}, "
          f"long sums {OP_WGRAD_TOL}); card ms "
          f"{ {k: round(v, 4) for k, v in times.items()} }; {card_line()}",
          flush=True)
    if bad:
        fail(f"seq ops sweep: disagreeing {bad[:6]}")
    del cols
    torch.cuda.empty_cache()
    return dict(errors=errs, ms=times)


def check_sequence():
    """Phase 23: the sequence slice."""
    t0 = time.perf_counter()
    row = dict(seq2seq=check_seq2seq(), lstm_lm=check_lstm_lm(),
               ops=seq_ops_sweep())
    row["seconds"] = time.perf_counter() - t0
    row["launches"] = row["seq2seq"]["launches"]
    print(f"phase 23: K1/K2/K3 launched {row['launches']} times on the path "
          f"(23.2's {S2S_STEPS} gated and 2 profiled steps, "
          f"{_s2s_kernels()} each a step); {row['seconds']:.2f} s",
          flush=True)
    return row


# --------------------------------------------------------------------------- #
# phase 24: the op corpus, the twenty-first slice: mx.random's user API with
# mx.nd.random, ops/samplers.py, ops/optimizer_ops.py and ops/extended.py,
# driven by ResNet-50 trained with MXNet 1.x's aggregated
# multi_mp_sgd_mom_update loop and by the samplers at GPT-2's vocabulary
# --------------------------------------------------------------------------- #

CORPUS_STEPS = 10            # 24.1: aggregated-update steps
CORPUS_BITS = 3              # 24.1: steps held to the per-parameter loop
CORPUS_AGG = 4               # MXNet's default aggregation size
CORPUS_DRAWS = 1 << 24       # 24.2: f32 draws an op
MULTI_V = 50257              # 24.2: GPT-2's vocabulary
MULTI_ROWS = 8
MULTI_N = 4096               # draws a row
MULTI_TOP = 64               # the chi-square's tokens a row
VAE_SHAPE = (128, 512)
CORPUS_TOL = 1e-5            # 24.3: card vs CPU, relative and absolute
CORPUS_TIMED = 10            # 24.3: timed calls of the fused updates


def agg_resnet(steps, aggregated, snap_at=None):
    """ResNet-50 (``train_resnet``'s model, batch and constants: bf16,
    NHWC, phase 14's seeded batch, ``RESNET_OPT``) trained as MXNet 1.x
    user code with ``MXNET_FUSED_CONV_BWD=1``: ``autograd.record()``, the
    softmax cross-entropy, ``backward()``, then with ``aggregated``
    ``mx.nd.multi_mp_sgd_mom_update`` over the trainable parameters in
    chunks of ``CORPUS_AGG`` (f32 master copies and momenta, ``rescale_grad
    = 1 / B``), else ``mx.nd.mp_sgd_mom_update`` a parameter; the new
    weights are written back with ``set_data``.  With ``aggregated`` the
    last step's update runs under ``torch.profiler`` (its device time)
    and the timed window is steps 2..``steps - 1``.  Returns the row
    (losses, ms a step, the update's ms a step by CUDA events around the
    update loop, its device ms, kernel launches) and the parameters after
    step ``snap_at`` (module order)."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.ops import conv_fused as cf

    os.environ["MXNET_FUSED_CONV_BWD"] = "1"
    net, data, label = _resnet50()
    x, y = mx.nd.NDArray(data), mx.nd.NDArray(label)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    lr, momentum, wd = (RESNET_OPT[k] for k in
                        ("learning_rate", "momentum", "wd"))
    params = moms = w32 = None

    def update():
        if not aggregated:
            for j, p in enumerate(params):
                w, moms[j], w32[j] = mx.nd.mp_sgd_mom_update(
                    p.data(), p.grad(), moms[j], w32[j], lr=lr * p.lr_mult,
                    momentum=momentum, wd=wd * p.wd_mult,
                    rescale_grad=1.0 / RESNET_B)
                p.set_data(w)
            return
        for i in range(0, len(params), CORPUS_AGG):
            chunk = range(i, min(i + CORPUS_AGG, len(params)))
            args = []
            for j in chunk:
                args += [params[j].data(), params[j].grad(), moms[j], w32[j]]
            outs = mx.nd.multi_mp_sgd_mom_update(
                *args, lrs=[lr * params[j].lr_mult for j in chunk],
                wds=[wd * params[j].wd_mult for j in chunk],
                momentum=momentum, rescale_grad=1.0 / RESNET_B,
                num_weights=len(chunk))
            for k, j in enumerate(chunk):
                params[j].set_data(outs[3 * k])
                moms[j], w32[j] = outs[3 * k + 1], outs[3 * k + 2]

    losses, events, snap, device_us = [], [], None, None
    torch.cuda.synchronize()
    _reset_counts()
    cf.conv1x1_bwd_pair.launches = 0
    t1 = t2 = None
    for step in range(steps):
        profiled = aggregated and step == steps - 1
        if step == 1 or profiled:
            torch.cuda.synchronize()
            if step == 1:
                t1 = time.perf_counter()
            else:
                t2 = time.perf_counter()
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        if params is None:          # BatchNorm's gamma and beta now exist
            params = [p for p in net.collect_params().values()
                      if p.grad_req != "null"]
            moms = [mx.nd.zeros(p.shape, ctx=mx.gpu(0)) for p in params]
            w32 = [p.data().astype("float32") for p in params]
        if profiled:
            torch.cuda.synchronize()
            device_us = _profiled(update)[1]
        else:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            update()
            ev[1].record()
            events.append(ev)
        losses.append(loss._data.detach().float().mean())
        if snap_at == step + 1:
            snap = [p.detach().clone() for p in net.parameters()]
    torch.cuda.synchronize()
    t2 = t2 or time.perf_counter()
    timed = (steps - 2) if aggregated else (steps - 1)
    launches = dict(_counts(), conv1x1_bwd=cf.conv1x1_bwd_pair.launches)
    update_ms = [a.elapsed_time(b) for a, b in events[1:]]
    row = dict(losses=[float(v) for v in losses], launches=launches,
               ms_per_step=(t2 - t1) / timed * 1e3 if timed > 0 else None,
               images_per_s=timed * RESNET_B / (t2 - t1) if timed > 0
               else None,
               update_ms_per_step=sum(update_ms) / len(update_ms)
               if update_ms else None,
               update_device_ms=device_us / 1e3 if device_us else None,
               parameters=len(params), chunks=-(-len(params) // CORPUS_AGG))
    del net, params, moms, w32, x, y, data, label, loss
    torch.cuda.empty_cache()
    return row, snap


def corpus_resnet(fused_row):
    """24.1: 10 steps of ``agg_resnet`` (aggregated): K6 exactly 30
    times a step and no other kernel; losses finite, the first within 1.0
    of ln(1000); three steps of the per-parameter ``mp_sgd_mom_update``
    loop from a fresh net equal the aggregated run's first three bit for
    bit (losses and every parameter).  ms a step, images/s and the
    update's ms beside phase 18's ``fused_step`` ResNet-50 arm; the
    weights' largest difference after three steps from
    ``_resnet_witness``'s plain loop (its update has no master copy: not a
    gate)."""
    import math

    import torch

    row, snap = agg_resnet(CORPUS_STEPS, True, snap_at=CORPUS_BITS)
    losses, launches = row["losses"], row["launches"]
    expect = K6_PER_STEP * CORPUS_STEPS
    print(f"corpus resnet: resnet50_v1 NHWC bf16 as MXNet 1.x user code, "
          f"B={RESNET_B}, {CORPUS_STEPS} steps of record/backward then "
          f"mx.nd.multi_mp_sgd_mom_update over {row['parameters']} "
          f"parameters in {row['chunks']} chunks of {CORPUS_AGG}; losses "
          f"{[round(v, 4) for v in losses]}", flush=True)
    dev = row["update_device_ms"]
    print(f"corpus resnet: ms/step={row['ms_per_step']:.3f} images/s="
          f"{row['images_per_s']:.2f} (steps 2-{CORPUS_STEPS - 1}), the "
          f"update {row['update_ms_per_step']:.3f} ms a step (CUDA events "
          f"around the update loop, steps 2-{CORPUS_STEPS - 1}), its device "
          f"time " + (f"{dev:.3f} ms" if dev else "not measured (the "
                      "profiler saw no device time)")
          + f" (step {CORPUS_STEPS} profiled), beside phase 18's "
          f"Trainer.fused_step arm "
          f"{fused_row['ms_per_step']:.3f} ms/step "
          f"({fused_row['images_per_s']:.2f} images/s); launches "
          f"{launches}; {card_line()}", flush=True)
    if launches["conv1x1_bwd"] != expect:
        fail(f"corpus resnet: K6 launched {launches['conv1x1_bwd']} times, "
             f"expected {expect}")
    if any(n for k, n in launches.items() if k != "conv1x1_bwd"):
        fail(f"corpus resnet: other kernels launched: {launches}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"corpus resnet: losses not finite: {losses}")
    if abs(losses[0] - math.log(1000)) > 1.0:
        fail(f"corpus resnet: first loss {losses[0]} is not within 1.0 of "
             "ln(1000)")
    single, snap1 = agg_resnet(CORPUS_BITS, False, snap_at=CORPUS_BITS)
    differ = sum(not torch.equal(a, b) for a, b in zip(snap, snap1))
    same_losses = single["losses"] == losses[:CORPUS_BITS]
    print(f"corpus resnet: {CORPUS_BITS} steps of the per-parameter "
          f"mx.nd.mp_sgd_mom_update loop from a fresh net: losses equal bit "
          f"for bit {same_losses}, parameters differing {differ} of "
          f"{len(snap)}", flush=True)
    if differ or not same_losses:
        fail("corpus resnet: the aggregated update departs from the "
             "per-parameter loop")
    del snap1
    torch.cuda.empty_cache()
    plain_losses, plain = _witness_sgd(CORPUS_BITS)
    gap = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(snap, plain))
    print(f"corpus resnet: after {CORPUS_BITS} steps, the weights' largest "
          f"difference from _resnet_witness's plain loop (reference_sgd, no "
          f"master copy, the mean loss's gradient) is {gap!r}: zero "
          f"{gap == 0.0} (not a gate); plain losses "
          f"{[round(v, 4) for v in plain_losses]}", flush=True)
    del snap, plain
    torch.cuda.empty_cache()
    row.update(bits_equal=True, witness_max_abs_diff=gap,
               fused_step_ms_per_step=fused_row["ms_per_step"])
    return row


def _draw(mx, name, arrays, kwargs, n, ctx):
    with ctx:
        args = [mx.nd.array(a) for a in arrays]
        return getattr(mx.nd, name)(*args, shape=(n,), **kwargs)._data


def corpus_draws():
    """24.2 (the samplers): every ``_random_*`` and ``sample_*`` op of
    ``tests/_torch_draws.py`` at 2**24 f32 draws on the card: each row's
    mean and variance within 6 standard errors and its KS or chi-square
    statistic at p >= 1e-6 (``check_draws``, on the card); the same
    seed the same draws; the card's uniform and randint equal the CPU's
    bit for bit."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import random

    _tests_path()
    from _torch_draws import DRAW_CASES, check_draws

    rows, bad = {}, []
    for cid, name, arrays, kwargs, specs in DRAW_CASES:
        n = CORPUS_DRAWS // len(specs)
        random.seed(24)
        x = _draw(mx, name, arrays, kwargs, n, mx.gpu(0))
        random.seed(24)
        again = _draw(mx, name, arrays, kwargs, n, mx.gpu(0))
        same = bool(torch.equal(x, again))
        del again
        ms = cuda_ms(lambda i: _draw(mx, name, arrays, kwargs, n,
                                     mx.gpu(0)), 3, warm=1)
        try:
            res = check_draws(x, specs)
            ok = True
        except AssertionError as e:
            res, ok = [str(e)], False
        row = dict(op=name, draws=n * len(specs), ms=ms, reproducible=same,
                   rows=res, ok=ok)
        if name in ("_random_uniform", "_random_randint"):
            random.seed(24)
            cpu = _draw(mx, name, arrays, kwargs, n, mx.cpu())
            row["equals_cpu"] = bool(torch.equal(x.cpu(), cpu))
            ok = ok and row["equals_cpu"]
        rows[cid] = row
        print(f"corpus draws: {cid} ({name}) {n * len(specs)} draws "
              f"{ms:.3f} ms; same seed same draws {same}"
              + (f"; equal to the CPU's bit for bit {row['equals_cpu']}"
                 if "equals_cpu" in row else "") + "; "
              + "; ".join(f"{r['dist']}: mean {r['mean_z']:+.2f} se, var "
                          f"{r['var_z']:+.2f} se, stat {r['stat']:.6g} p "
                          f"{r['p']:.3g}" if isinstance(r, dict) else r
                          for r in res), flush=True)
        if not (ok and same):
            bad.append(cid)
        del x
    torch.cuda.empty_cache()
    if bad:
        fail(f"corpus draws: {bad} failed their gates")
    return rows


def corpus_multinomial():
    """24.2 (GPT-2's vocabulary): ``sample_multinomial(get_prob=True)``
    over 8 rows of seeded softmax probabilities at 50,257 tokens, 4,096
    draws a row: the log-probabilities equal ``log p[drawn]`` bit for
    bit; a chi-square over each row's 64 most likely tokens (the rest
    pooled) at p >= 1e-6; ms beside ``torch.multinomial``'s."""
    import numpy as np
    import torch
    from scipy import stats
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import random
    from mxnet_tpu_torch.ops.registry import OPS

    rs = np.random.RandomState(24)
    logits = torch.as_tensor(rs.standard_normal((MULTI_ROWS, MULTI_V))
                             .astype(np.float32) * 2.0,
                             device=mx.gpu(0).torch_device())
    p = torch.softmax(logits, -1)
    data = mx.nd.NDArray(p)
    op = OPS["sample_multinomial"].wrapper
    random.seed(25)
    idx, logp = op(data, shape=(MULTI_N,), get_prob=True)
    i = idx._data.long()
    exact = bool(torch.equal(logp._data, torch.log(torch.gather(p, 1, i))))
    stat, dof = 0.0, 0
    for r in range(MULTI_ROWS):
        top = torch.topk(p[r], MULTI_TOP).indices
        counts = torch.bincount(i[r], minlength=MULTI_V)
        obs = counts[top].double()
        exp = p[r, top].double() * MULTI_N
        obs = torch.cat([obs, (MULTI_N - obs.sum()).reshape(1)])
        exp = torch.cat([exp, (MULTI_N - exp.sum()).reshape(1)])
        stat += float(((obs - exp) ** 2 / exp).sum())
        dof += MULTI_TOP
    pval = float(stats.chi2.sf(stat, dof))
    def ours(k=0):
        return op(data, shape=(MULTI_N,), get_prob=True)

    def lib(k=0):
        return torch.multinomial(p, MULTI_N, replacement=True)

    ms, lib_ms = cuda_ms(ours, 5), cuda_ms(lib, 5)
    dev_us, lib_dev_us = _profiled(ours)[1], _profiled(lib)[1]
    row = dict(logp_exact=exact, chi2=stat, dof=dof, p=pval, ms=ms,
               torch_multinomial_ms=lib_ms, device_us=dev_us,
               torch_multinomial_device_us=lib_dev_us)
    print(f"corpus multinomial: sample_multinomial(get_prob=True), "
          f"{MULTI_ROWS} rows x {MULTI_V} tokens, {MULTI_N} draws a row: "
          f"log-probabilities equal log p[drawn] bit for bit {exact}; "
          f"chi-square over the {MULTI_TOP} most likely tokens a row "
          f"{stat:.2f} on {dof} dof, p {pval:.3g}; {ms:.3f} ms a call "
          f"(device {dev_us / 1e3:.3f} ms, profiler) beside "
          f"torch.multinomial {lib_ms:.3f} ms (device "
          f"{lib_dev_us / 1e3:.3f}); {card_line()}", flush=True)
    if not exact or pval < 1e-6:
        fail("corpus multinomial: the draws or their log-probabilities are "
             "wrong")
    return row


def corpus_hybrid():
    """24.2 (a traced draw): a ``hybridize()``d VAE reparameterization,
    ``mu + exp(logvar / 2) * mx.nd.random.normal(shape=mu.shape)`` at
    128 x 512 on the card: its program is captured; the eager first call,
    the capture's replay and two more replays, under keys k1, k2, k1, k2
    (``random.seed`` rewinds the key stream): one key, the same numbers
    (the eager call equals a replay under its key), the next key,
    others."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, random

    class Reparam(gluon.HybridBlock):
        def hybrid_forward(self, F, mu, logvar):
            return mu + F.exp(logvar * 0.5) * F.random.normal(
                shape=mu.shape)

    net = Reparam()
    net.hybridize()
    rs = np.random.RandomState(40)
    mu = mx.nd.array(rs.standard_normal(VAE_SHAPE), ctx=mx.gpu(0))
    logvar = mx.nd.array(rs.standard_normal(VAE_SHAPE) * 0.1, ctx=mx.gpu(0))
    random.seed(40)
    out = [net(mu, logvar)._data.clone() for _ in range(2)]
    random.seed(40)
    out += [net(mu, logvar)._data.clone() for _ in range(2)]
    prog = next(iter(net._cached_op._programs.values()))
    captured = prog is not None and prog.graph is not None
    row = dict(captured=captured, draws=prog.draws if prog else None,
               eager_equals_replay=bool(torch.equal(out[0], out[2])),
               replays_equal_under_one_key=bool(torch.equal(out[1],
                                                            out[3])),
               fresh=not bool(torch.equal(out[0], out[1])))
    print(f"corpus hybrid: hybridized reparameterization "
          f"{VAE_SHAPE[0]}x{VAE_SHAPE[1]} with mx.nd.random.normal: "
          f"captured {captured} ({row['draws']} keyed draw), eager call "
          f"equals the replay under its key {row['eager_equals_replay']}, "
          f"replays under one key equal {row['replays_equal_under_one_key']}"
          f", the next key draws other numbers {row['fresh']}", flush=True)
    if not (captured and row["eager_equals_replay"] and row["fresh"] and
            row["replays_equal_under_one_key"]):
        fail("corpus hybrid: the traced draw is not fresh per key or not "
             "equal under one key")
    return row


def corpus_sweep():
    """24.3 (the op sweep): every op that ``ops/extended.py``,
    ``ops/optimizer_ops.py`` and ``ops/samplers.py`` register, at the
    tier-1 cases (``tests/_torch_corpus_cases.py``), on the card and on
    the CPU with the same head gradients: outputs and input gradients
    within ``CORPUS_TOL`` (the exact class exactly, the draws by shape
    and dtype)."""
    import numpy as np
    from mxnet_tpu_torch.ops import extended, optimizer_ops, samplers
    from mxnet_tpu_torch.ops.registry import OPS

    _tests_path()
    from _torch_corpus_cases import (DRAWS, NO_GRAD, assert_same,
                                     make_inputs, module_cases, op_class,
                                     port)

    mods = {m.__name__ for m in (extended, optimizer_ops, samplers)}
    names = sorted(n for n, o in OPS.items() if o.fn.__module__ in mods)
    cases = module_cases(names, OPS)
    worst, bad = {}, []
    for cid, name, specs, kwargs in cases:
        arrays = make_inputs(specs)
        seed = None if cid in NO_GRAD else sum(map(ord, cid))
        c_out, c_grad = port(name, arrays, kwargs, seed)
        g_out, g_grad = port(name, arrays, kwargs, seed, device="cuda")
        cls = op_class(name)
        try:
            assert_same(name, g_out, c_out,
                        cls if cls in ("draw", "exact") else "reduction")
            for g, c in zip(g_grad, c_grad):
                np.testing.assert_allclose(g, c, rtol=CORPUS_TOL,
                                           atol=CORPUS_TOL)
        except AssertionError as e:
            bad.append((cid, str(e).splitlines()[:3]))
        if cls != "draw":
            with np.errstate(invalid="ignore"):
                worst[cid] = max([float(np.nanmax(np.abs(
                    g.astype(np.float64) - c.astype(np.float64))))
                    if c.size and np.isfinite(c).any() else 0.0
                    for g, c in zip(g_out + g_grad, c_out + c_grad)]
                    or [0.0])
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:5]
    print(f"corpus sweep: {len(cases)} cases of {len(names)} ops "
          f"(extended, optimizer_ops, samplers; {len(DRAWS)} draws by shape "
          f"and dtype) card vs CPU, f32, TF32 off: worst "
          f"{[(k, f'{v:.2e}') for k, v in top]} (tol {CORPUS_TOL})",
          flush=True)
    if bad or len(names) != 148:
        fail(f"corpus sweep: {len(names)} ops, disagreeing {bad[:5]}")
    return dict(cases=len(cases), ops=len(names), worst=dict(top))


def corpus_fused_updates(opt19):
    """24.3 (the fused updates): ``multi_adamw_update`` and
    ``multi_lamb_update`` over GPT-2 small's parameters in f32 (one call
    over every tensor), ms a call beside phase 19's fused LAMB apply
    (19.1, GPT-2 small bf16 with master copies) and its fused AdamW and
    LAMB applies on the MLP (19.3); then ``preloaded_multi_sgd_mom_update``
    captured in a CUDA graph and replayed after its ``lrs`` change in
    place, against the eager call, bit for bit."""
    import torch
    from mxnet_tpu_torch.models import gpt2_small
    from mxnet_tpu_torch.ops.registry import OPS

    model, _ = gpt2_small(dtype=torch.float32)
    model.initialize(0.02, seed=0)
    ws = [p.detach() for p in model.parameters()]
    n = sum(w.numel() for w in ws)
    gen = torch.Generator(device="cuda").manual_seed(24)
    gs = [torch.randn(w.shape, generator=gen, device="cuda") * 1e-2
          for w in ws]
    ms_ = [torch.zeros_like(w) for w in ws]
    vs = [torch.zeros_like(w) for w in ws]
    args = [t for group in zip(ws, gs, ms_, vs) for t in group]
    k = len(ws)
    adamw = OPS["multi_adamw_update"].fn
    lamb = OPS["multi_lamb_update"].fn
    def run_adamw(i=0):
        return adamw(*args, lrs=[1e-4] * k, etas=[1.0] * k, wds=[0.01] * k,
                     step_count=i + 1)

    def run_lamb(i=0):
        return lamb(*args, learning_rates=[1e-3] * k, wds=[0.01] * k,
                    step_count=i + 1)

    with torch.no_grad():
        adamw_ms = cuda_ms(run_adamw, CORPUS_TIMED)
        lamb_ms = cuda_ms(run_lamb, CORPUS_TIMED)
        adamw_dev = _profiled(run_adamw)[1] / 1e3
        lamb_dev = _profiled(run_lamb)[1] / 1e3
    lamb19 = opt19["lamb_gpt2"]["optimizer_device_us"]
    mlp19 = {key: r.get("optimizer_device_us") for key, r in
             opt19["all"]["rows"].items()
             if key.startswith(("adamw", "lamb"))}
    print(f"corpus fused updates: GPT-2 small f32, {k} tensors, {n} "
          f"parameters, one call each: multi_adamw_update {adamw_ms:.3f} ms "
          f"(device {adamw_dev:.3f} ms, profiler), multi_lamb_update "
          f"{lamb_ms:.3f} ms (device {lamb_dev:.3f}) a call, beside phase "
          f"19.1's fused LAMB apply on GPT-2 small bf16 (master copies) "
          + (f"{lamb19 / 1e3:.3f} ms" if lamb19 else "not measured")
          + f" and 19.3's fused applies on the MLP (us) {mlp19}; "
          f"{card_line()}", flush=True)
    del model, ws, gs, ms_, vs, args
    torch.cuda.empty_cache()
    # the preloaded update in a graph, its lrs changed in place
    rs = torch.Generator(device="cuda").manual_seed(25)
    shapes = [(1024, 768), (768,), (3072, 768), (3,)]
    flat = []
    for s in shapes:
        flat += [torch.randn(s, generator=rs, device="cuda"),
                 torch.randn(s, generator=rs, device="cuda"),
                 torch.randn(s, generator=rs, device="cuda") * 0.1]
    lrs = torch.full((len(shapes),), 0.1, device="cuda")
    wds = torch.full((len(shapes),), 1e-4, device="cuda")
    fn = OPS["preloaded_multi_sgd_mom_update"].fn
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*flat, lrs, wds, momentum=0.9, rescale_grad=0.5)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = fn(*flat, lrs, wds, momentum=0.9, rescale_grad=0.5)
    lrs.copy_(torch.linspace(0.01, 0.3, len(shapes), device="cuda"))
    graph.replay()
    eager = fn(*flat, lrs, wds, momentum=0.9, rescale_grad=0.5)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(outs, eager))
    print(f"corpus fused updates: preloaded_multi_sgd_mom_update captured "
          f"in a CUDA graph, replayed after its lrs changed in place: equal "
          f"to the eager call bit for bit {same}", flush=True)
    if not same:
        fail("corpus fused updates: the replayed preloaded update departs "
             "from the eager call")
    return dict(parameters=n, tensors=k, multi_adamw_ms=adamw_ms,
                multi_lamb_ms=lamb_ms, multi_adamw_device_ms=adamw_dev,
                multi_lamb_device_ms=lamb_dev,
                lamb19_optimizer_device_us=lamb19,
                mlp19_optimizer_device_us=mlp19, preloaded_replay_equal=same)


def check_corpus(fused_row, opt19):
    """Phase 24: the aggregated-update ResNet-50, the samplers at
    realistic size, the op sweep and the fused updates."""
    import torch

    t0 = time.perf_counter()
    row = dict(resnet=corpus_resnet(fused_row))
    torch.cuda.empty_cache()
    row["draws"] = corpus_draws()
    row["multinomial"] = corpus_multinomial()
    row["hybrid"] = corpus_hybrid()
    row["sweep"] = corpus_sweep()
    row["fused_updates"] = corpus_fused_updates(opt19)
    row["seconds"] = time.perf_counter() - t0
    row["launches"] = row["resnet"]["launches"]
    print(f"phase 24: {row['seconds']:.2f} s", flush=True)
    return row


# --------------------------------------------------------------------------- #
# phase 25: the training run's services, the twenty-second slice:
# mx.checkpoint, mx.amp (K1-K3 in fp16), mx.profiler and mx.engine,
# mx.nd.sparse
# --------------------------------------------------------------------------- #

P25_STEPS = 8               # 25.1: steps of the fp16 run
P25_EVERY = 4               # 25.1: a checkpoint every 4 steps
P25_KILL = "checkpoint.save:kill:2"   # 25.1: dies inside its second save
P25_PROFILED = (2, 3, 4)    # 25.4: the steps profiled in 25.1's run A
P25_MICRO = 9               # 25.2: micro-batches (update_interval 2)
P25_SAVE_AT = 5             # 25.2: the save, mid-window
AVAZU_FEATURES = 1_000_000  # 25.3: LIBSVM's avazu-app width
AVAZU_ROWS, AVAZU_NNZ, AVAZU_STEPS = 8192, 24, 10
FC_CALLS_A_STEP = 2 * 12 + 1   # F.FullyConnected a GPT-2 step: qkv, proj, head


def _p25_dir(name):
    import shutil

    d = os.path.join(HERE, "build", "phase25", name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    return d


def _digest(net):
    """sha256 over every parameter's bytes, in ``collect_params`` order:
    two runs equal bit for bit have equal digests."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for p in net.collect_params().values():
        t = p.data()._data.detach().contiguous().view(-1)
        h.update(t.view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _p25_batch(mx, ctx, s):
    """The (tokens, positions, labels) of step ``s``, seeded by it."""
    import numpy as np

    rs = np.random.RandomState(1000 + s)
    tok = mx.nd.array(rs.randint(0, HF_V, (HF_B, HF_T)), ctx=ctx,
                      dtype="int32")
    pos = mx.nd.array(np.tile(np.arange(HF_T), (HF_B, 1)), ctx=ctx,
                      dtype="int32")
    lab = mx.nd.array(rs.randint(0, HF_V, (HF_B, HF_T)), ctx=ctx,
                      dtype="int32")
    return tok, pos, lab


def p25_child(cfg):
    """One run of 25.1 in a process of its own (``amp.init`` patches
    ``mx.nd`` for the whole process): the user's GPT-2 small in f32 under
    ``amp.init("float16")``, AdamW through ``amp.init_trainer``,
    ``amp.scale_loss`` around an eager ``record``/``backward``; with
    ``cfg["ckdir"]`` a ``CheckpointManager(async_save=True,
    max_to_keep=2)`` saving every ``P25_EVERY`` steps (and, with
    ``cfg["resume"]``, restoring first).  Prints one ``P25 {...}`` line:
    the losses, skipped steps, loss scale, parameter digests, K1-K3's
    launches a step, the saves and, for the profiled steps, the profiler's
    tables."""
    import torch

    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = \
        False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp, autograd, gluon, profiler, telemetry

    gpu = mx.gpu(0)
    mx.random.seed(0)
    net = _hf_gpt(mx, 12, 0.0, "float32", gpu, seed=0)
    amp.init("float16")
    trainer = gluon.Trainer(net.collect_params(), "adamw", dict(ADAMW_OPT))
    amp.init_trainer(trainer)
    scaler = trainer._amp_loss_scaler
    loss_l = gluon.loss.SoftmaxCrossEntropyLoss()
    out = dict(start=0, corrupt=[], restore_s=None, snapshot_s=[],
               profile=None, digest1=None, loss1=None)
    telemetry.clear_events()
    mgr = None
    if cfg.get("ckdir"):
        mgr = mx.checkpoint.CheckpointManager(cfg["ckdir"], max_to_keep=2,
                                              async_save=True)
        if cfg.get("resume"):
            t0 = time.perf_counter()
            out["start"] = mgr.restore(net, trainer) or 0
            out["restore_s"] = time.perf_counter() - t0
            out["corrupt"] = [e["why"] for e in
                              telemetry.events(kind="checkpoint_corrupt")]
    profiled = cfg.get("profile") or ()
    if profiled:
        profiler.set_config(filename=os.path.join(
            HERE, "chiprun_out", "p25_profile.json"), aggregate_stats=True)
        profiler.dumps(reset=True)
    _reset_attention_counts()
    losses, skips, counts, step_ms = [], [], [], []
    for s in range(out["start"] + 1, cfg["steps"] + 1):
        tok, pos, lab = _p25_batch(mx, gpu, s)
        if profiled and s == profiled[0]:
            torch.cuda.synchronize()
            profiler.start()
        torch.cuda.synchronize()
        t_step = time.perf_counter()
        before_scale = scaler.loss_scale
        c0 = _attention_counts()
        with autograd.record():
            loss = loss_l(net(tok, pos).astype("float32"), lab)
            with amp.scale_loss(loss, trainer) as scaled:
                pass
        scaled.backward()
        trainer.step(HF_B)
        losses.append(float(loss._data.mean()))      # waits for the step
        step_ms.append((time.perf_counter() - t_step) * 1e3)
        skips.append(scaler.loss_scale < before_scale)
        c1 = _attention_counts()
        counts.append({n: c1[n] - c0[n] for n in ATTN_KERNELS})
        if profiled and s == profiled[-1]:
            torch.cuda.synchronize()
            profiler.stop()
            out["profile"] = dict(
                table=profiler.dumps(),
                device_names=sorted({n for n, _ in
                                     profiler.device_events()}),
                by_name=profiler.device_dumps(by="name", limit=12),
                by_category=profiler.device_dumps(by="category"))
        if s == 1 and cfg.get("digest1"):
            out["digest1"], out["loss1"] = _digest(net), losses[-1]
        if mgr is not None and s % P25_EVERY == 0:
            t0 = time.perf_counter()
            mgr.save(s, net, trainer)
            out["snapshot_s"].append(time.perf_counter() - t0)
    if mgr is not None:
        mgr.wait_until_finished()
        mgr.close()
    torch.cuda.synchronize()
    out.update(losses=losses, skips=skips, step_ms=step_ms,
               loss_scale=scaler.loss_scale, digest=_digest(net),
               counts=counts, engine=mx.engine.engine_type(),
               saved=[dict(step=e["step"], bytes=e["bytes"],
                           write_s=e["write_s"], snapshot_s=e["snapshot_s"])
                      for e in telemetry.events(kind="checkpoint_saved")])
    print("P25 " + json.dumps(out), flush=True)


def _p25_spawn(cfg, **env):
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--p25-child",
         json.dumps(cfg)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(os.environ, **env))


def _p25_result(proc, what, expect_rc=0, timeout=900):
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode != expect_rc:
        fail(f"25.1 {what}: exit {proc.returncode} (expected {expect_rc})"
             f"\n{err[-3000:]}")
    lines = [ln for ln in out.splitlines() if ln.startswith("P25 ")]
    if expect_rc != 0:
        return None
    if not lines:
        fail(f"25.1 {what}: no result line\n{err[-3000:]}")
    return json.loads(lines[-1][4:])


def amp_kill_resume():
    """25.1 and 25.4's children.  Run A (no checkpoint; profiled steps
    2-4; its digest after step 1), run B (checkpoints at 4 and 8), the
    killed run (``MXNET_FAULT_INJECT=checkpoint.save:kill:2``: SIGKILLed
    inside its second save, step 8) and the NaiveEngine run (step 1)
    share the card at once; then the resumed run restores the newest
    verifiable step of the killed run's directory and runs to step 8.
    Gates: A and B equal bit for bit (losses, loss scale, skipped steps,
    every weight); the killed run leaves step 4 committed and step 8 an
    uncommitted temp directory; the resumed run restores step 4, reports
    that temp directory (``checkpoint_corrupt``) and sweeps it, and its
    losses (steps 5-8), loss scale, skipped steps and every weight equal
    A's bit for bit; every step launches K1-K3 exactly 12 times each, in
    fp16."""
    base = dict(steps=P25_STEPS)
    ck_b, ck_k = _p25_dir("amp_b"), _p25_dir("amp_killed")
    t0 = time.perf_counter()
    procs = dict(
        a=_p25_spawn(dict(base, profile=list(P25_PROFILED), digest1=True)),
        b=_p25_spawn(dict(base, ckdir=ck_b)),
        killed=_p25_spawn(dict(base, ckdir=ck_k),
                          MXNET_FAULT_INJECT=P25_KILL),
        naive=_p25_spawn(dict(steps=1, digest1=True),
                         MXNET_ENGINE_TYPE="NaiveEngine"))
    res = {k: _p25_result(p, k, expect_rc=-9 if k == "killed" else 0)
           for k, p in procs.items()}
    left = sorted(os.listdir(ck_k))
    if "step_00000004" not in left or "step_00000008" in left or not any(
            n.startswith(".tmp-step_00000008") for n in left):
        fail(f"25.1 killed run: directory holds {left}; expected step 4 "
             "committed and step 8 an uncommitted temp directory")
    res["resumed"] = _p25_result(_p25_spawn(dict(base, ckdir=ck_k,
                                                 resume=True)), "resumed")
    wall = time.perf_counter() - t0
    a, b, r = res["a"], res["b"], res["resumed"]
    keys = ("losses", "loss_scale", "skips", "digest")
    if any(a[k] != b[k] for k in keys):
        fail(f"25.1 two uninterrupted runs differ: A {[a[k] for k in keys]}"
             f" B {[b[k] for k in keys]}")
    if r["start"] != 4 or not any("uncommitted .tmp-step_00000008" in w
                                  for w in r["corrupt"]):
        fail(f"25.1 resumed run: restored step {r['start']} (expected 4), "
             f"corrupt events {r['corrupt']}")
    if any(n.startswith(".tmp-") for n in os.listdir(ck_k)):
        fail(f"25.1 resumed run left {os.listdir(ck_k)}")
    if r["losses"] != a["losses"][4:] or r["skips"] != a["skips"][4:] or \
            r["loss_scale"] != a["loss_scale"] or r["digest"] != a["digest"]:
        fail(f"25.1 killed and resumed differs from uninterrupted: losses "
             f"{r['losses']} vs {a['losses'][4:]}, skipped steps "
             f"{r['skips']} vs {a['skips'][4:]}, loss scale "
             f"{r['loss_scale']} vs {a['loss_scale']}, digests equal "
             f"{r['digest'] == a['digest']}")
    for what, run in (("A", a), ("B", b), ("resumed", r)):
        bad = [c for c in run["counts"] if any(c[n] != 12
                                              for n in ATTN_KERNELS)]
        if bad:
            fail(f"25.1 run {what}: K1-K3 launches a step {bad}, expected "
                 "12 each")
    saves = b["saved"]
    print(f"25.1 amp fp16 GPT-2 small (12 layers, 768, 12 heads, 50,257 "
          f"tokens, 8 x 1024), AdamW, loss scaler from 2^16: losses "
          f"{[round(v, 5) for v in a['losses']]}; skipped steps "
          f"{[i + 1 for i, k in enumerate(a['skips']) if k]}, final loss "
          f"scale {a['loss_scale']}; run A = run "
          f"B bit for bit; killed inside the save of step 8, resumed from "
          f"step 4 (restore {r['restore_s']:.3f} s, corrupt events "
          f"{r['corrupt']}), steps 5-{P25_STEPS} = A's bit for bit (losses, "
          f"skips, "
          f"loss scale, weights); K1-K3 12 each a step in fp16; ms a step "
          f"of the resumed run (alone on the card) "
          f"{[round(x, 3) for x in r['step_ms']]}", flush=True)
    print(f"25.1 checkpoints: snapshot s {[round(x, 4) for x in b['snapshot_s']]}"
          f" (save() returns), written {[(s['step'], s['bytes'], round(s['write_s'], 3)) for s in saves]}"
          f" (step, bytes, write s); children {wall:.2f} s wall; "
          f"{card_line()}", flush=True)
    launches = {n: sum(c[n] for run in (a, b, r, res["naive"])
                       for c in run["counts"]) for n in ATTN_KERNELS}
    return dict(runs=res, launches=launches, wall_s=wall)


def _fused_launches_all(fs):
    """K1-K3's launches through a fused step with several programs since
    the counts were set to 0: the eager calls by the counts, each replay
    by what its capture recorded (the captures themselves run nothing)."""
    host = _attention_counts()
    captured = {n: sum(p.launches.get(n, 0) for p in fs._programs.values())
                for n in ATTN_KERNELS}
    replayed = fs.launches()
    return {n: host[n] - captured[n] + replayed.get(n, 0)
            for n in ATTN_KERNELS}


def _manifest_bf16_leaf(d):
    """(name, uint16 bits) of the first bf16 parameter a step directory's
    manifest lists, read with numpy alone."""
    import numpy as np

    man = json.load(open(os.path.join(d, "MANIFEST.json")))
    tree = {k: v for (_, k), v in man["tree"]["@dict"]}
    for (_, name), node in tree["params"]["@dict"]:
        meta = man["arrays"][node["@arr"]]
        if meta["dtype"] == "bfloat16":
            return name, np.load(os.path.join(d, meta["file"]))
    fail(f"25.2: no bf16 parameter in {d}")


def captured_mid_window():
    """25.2: the user's GPT-2 small in bf16 with f32 masters, dropout 0.1,
    ``Trainer(update_interval=2)`` through ``fused_step`` (K1-K3 bf16 in
    the replays): saved at micro-batch 5 (mid-window), run on to 9,
    restored in place and replayed from 6.  Gates: no program made and no
    graph captured after the restore; the ring, weights and states written
    in place (the ring's addresses kept); the losses and weights of the
    replay from the save point equal the first run's bit for bit; a bf16
    weight read back from the manifest's file with numpy equals the
    restored one."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon import fused_step as fsm

    gpu = mx.gpu(0)
    mx.random.seed(1)
    net = _hf_gpt(mx, 12, 0.1, "bfloat16", gpu, seed=1)
    loss_l = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "adamw", dict(ADAMW_OPT),
                            update_interval=2)

    def loss_fn(t, p, y):
        return loss_l(net(t, p), y)

    batches = [_p25_batch(mx, gpu, 100 + s)
               for s in range(1, P25_MICRO + 1)]

    def call(s):
        return float(trainer.fused_step(loss_fn, *batches[s - 1])._data
                     .float().mean())

    fsm.reset_step_counters()
    _reset_attention_counts()
    first = [call(s) for s in range(1, P25_SAVE_AT + 1)]
    if trainer._window_pos != 1:
        fail(f"25.2: window position {trainer._window_pos} at the save")
    d = _p25_dir("captured")
    mgr = mx.checkpoint.CheckpointManager(d, async_save=True)
    t0 = time.perf_counter()
    mgr.save(P25_SAVE_AT, net, trainer)
    snap_s = time.perf_counter() - t0
    mgr.wait_until_finished()
    after = [call(s) for s in range(P25_SAVE_AT + 1, P25_MICRO + 1)]
    dig = _digest(net)
    (fs,) = trainer._fused_steps.values()
    graphs = {k[0]: id(p.graph) for k, p in fs._programs.items()}
    compiles = fsm.step_counters["compiles"]
    ring = [a.data_ptr() for a in fs._accum]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = mgr.restore(net, trainer)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    mgr.close()
    name, bits = _manifest_bf16_leaf(os.path.join(d, "step_%08d"
                                                  % P25_SAVE_AT))
    live = net._collect_params_with_prefix()[name].data()._data
    same_bits = live.dtype == torch.bfloat16 and np.array_equal(
        live.view(torch.int16).cpu().numpy().view(np.uint16), bits)
    if step != P25_SAVE_AT or trainer._window_pos != 1 or \
            [a.data_ptr() for a in fs._accum] != ring or not same_bits:
        fail(f"25.2: restore gave step {step}, window {trainer._window_pos}"
             f", ring kept {[a.data_ptr() for a in fs._accum] == ring}, "
             f"bf16 {name} from the manifest equal {same_bits}")
    again, call_ms = [], []
    for s in range(P25_SAVE_AT + 1, P25_MICRO + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again.append(call(s))                      # reads the loss back
        call_ms.append((time.perf_counter() - t0) * 1e3)
    dig2 = _digest(net)
    now = {k[0]: id(p.graph) for k, p in fs._programs.items()}
    counters = dict(fsm.step_counters)
    launches = _fused_launches_all(fs)
    if counters["compiles"] != compiles or now != graphs or \
            any(p.graph is None for p in fs._programs.values()):
        fail(f"25.2: a program or capture after the restore: compiles "
             f"{compiles} -> {counters['compiles']}, graphs {graphs} -> "
             f"{now}")
    if again != after or dig2 != dig:
        fail(f"25.2: replay after the restore {again} vs {after}, weights "
             f"equal {dig2 == dig}")
    print(f"25.2 captured GPT-2 small bf16 (f32 masters, dropout 0.1, "
          f"update_interval 2): losses {[round(v, 5) for v in first + after]}"
          f"; saved at micro-batch {P25_SAVE_AT} (snapshot {snap_s:.3f} s), "
          f"restored in place ({restore_s:.3f} s; ring, weights, states and "
          f"generators written, no new program or capture: compiles "
          f"{counters['compiles']}, one graph each of {sorted(graphs)}"
          f"), micro-batches {P25_SAVE_AT + 1}-{P25_MICRO} replayed bit for "
          f"bit; bf16 {name} from the manifest = live; launches {launches}; "
          f"ms a replayed call after the restore (apply, micro, apply, "
          f"micro) {[round(x, 3) for x in call_ms]}", flush=True)
    row = dict(losses=first + after, replay=again, call_ms=call_ms,
               snapshot_s=snap_s,
               restore_s=restore_s, counters=counters, launches=launches)
    del fs, trainer, net, batches
    torch.cuda.empty_cache()
    return row


def _avazu_batch(mx, ctx, s):
    """A seeded CSR batch at avazu-app's width: ``AVAZU_ROWS`` rows of
    ``AVAZU_NNZ`` distinct binary features (value 1, ascending columns)
    and 0/1 click labels."""
    import numpy as np
    from mxnet_tpu_torch.ndarray import sparse

    rs = np.random.RandomState(500 + s)
    cols = np.sort(rs.randint(0, AVAZU_FEATURES - AVAZU_NNZ,
                              (AVAZU_ROWS, AVAZU_NNZ)), axis=1) + \
        np.arange(AVAZU_NNZ)
    indptr = np.arange(AVAZU_ROWS + 1) * AVAZU_NNZ
    with ctx:
        x = sparse.csr_matrix((np.ones(cols.size, np.float32), cols.ravel(),
                               indptr), shape=(AVAZU_ROWS, AVAZU_FEATURES))
        y = mx.nd.array(rs.randint(0, 2, AVAZU_ROWS).astype(np.float32))
    return x, y


def _avazu_train(mx, ctx):
    """Logistic regression at avazu-app's width: ``sparse.dot(x, w) + b``,
    ``SigmoidBinaryCrossEntropyLoss``, SGD through ``gluon.Trainer``."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.ndarray import sparse

    w = gluon.Parameter("avazu_w", shape=(AVAZU_FEATURES, 1))
    b = gluon.Parameter("avazu_b", shape=(1,))
    w.initialize(ctx=ctx)
    b.initialize(ctx=ctx)
    w.set_data(np.random.RandomState(4).normal(
        0, 0.01, (AVAZU_FEATURES, 1)).astype(np.float32))
    b.set_data(np.zeros(1, np.float32))
    trainer = gluon.Trainer([w, b], "sgd", {"learning_rate": 0.5})
    loss_l = gluon.loss.SigmoidBinaryCrossEntropyLoss()
    losses, times = [], []
    for s in range(AVAZU_STEPS):
        x, y = _avazu_batch(mx, ctx, s)
        if ctx.device_type == "gpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with autograd.record():
            L = loss_l(sparse.dot(x, w.data()) + b.data(), y)
        L.backward()
        trainer.step(AVAZU_ROWS)
        losses.append(float(L.mean().asscalar()))
        times.append(time.perf_counter() - t0)
    return losses, w.data().asnumpy(), b.data().asnumpy(), times


def _sparse_sweep(mx):
    """The csr/row_sparse cases of the tier-1 tests on the card against
    the CPU: components of the unions, retain and storage casts exactly,
    the dots and their gradients within 1e-5."""
    import numpy as np
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.ndarray import sparse

    def case(ctx):
        rs = np.random.RandomState(9)
        out = {}
        with ctx:
            da = rs.rand(64, 48).astype(np.float32)
            da[da < 0.7] = 0
            db = rs.rand(64, 48).astype(np.float32)
            db[db < 0.7] = 0
            a = sparse.csr_matrix(da)
            bb = sparse.csr_matrix(db)
            ra = sparse.row_sparse_array((rs.rand(5, 8).astype(np.float32),
                                          [1, 3, 7, 20, 40]), shape=(48, 8))
            rb = sparse.row_sparse_array((rs.rand(3, 8).astype(np.float32),
                                          [3, 9, 40]), shape=(48, 8))
            rhs = mx.nd.array(rs.randn(48, 8).astype(np.float32))
            rhs_t = mx.nd.array(rs.randn(64, 8).astype(np.float32))
        for op in ("add", "subtract", "multiply"):
            for tag, x, y in (("csr", a, bb), ("rs", ra, rb)):
                r = getattr(sparse, op)(x, y)
                out[f"{op}_{tag}"] = [r.data.asnumpy(), r.indices.asnumpy()]
        out["retain"] = [sparse.retain(ra, [3, 40]).data.asnumpy()]
        out["cast"] = [mx.nd.cast_storage(a, "default").asnumpy(),
                       mx.nd.cast_storage(a.tostype("default"),
                                          "row_sparse").indices.asnumpy()]
        for tag, lhs, r, kw in (("csr", a, rhs_t, dict(transpose_a=True)),
                                ("csr_n", a, rhs, {}),
                                ("rs", ra, rhs[:8], {}),
                                ("rs_t", ra, mx.nd.array(
                                    rs.randn(48, 4).astype(np.float32),
                                    ctx=ctx), dict(transpose_a=True))):
            r.attach_grad()
            with autograd.record():
                y = sparse.dot(lhs, r, **kw)
                L = (y * y).sum()
            L.backward()
            out[f"dot_{tag}"] = [y.asnumpy(), r.grad.asnumpy()]
        return out

    cpu, gpu = case(mx.cpu()), case(mx.gpu(0))
    worst = 0.0
    for k in cpu:
        for c, g in zip(cpu[k], gpu[k]):
            if c.shape != g.shape:
                fail(f"25.3 sweep {k}: shapes {g.shape} vs {c.shape}")
            if k.startswith("dot"):
                err = float(np.abs(c - g).max()) if c.size else 0.0
                worst = max(worst, err)
                if err > 1e-5 * max(1.0, float(np.abs(c).max())):
                    fail(f"25.3 sweep {k}: max_abs_err {err}")
            elif not np.array_equal(c, g):
                fail(f"25.3 sweep {k}: card differs from the CPU")
    return dict(cases=len(cpu), dot_max_abs_err=worst)


def sparse_avazu():
    """25.3: logistic regression over avazu-app's 1,000,000 features on
    ``AVAZU_ROWS``-row CSR batches (``AVAZU_NNZ`` nonzeros a row), 10 SGD
    steps on the card and on the CPU: losses and weights within 1e-5;
    ``sparse.dot`` against the dense product of the same matrix at 1,024
    x 65,536 within 1e-5 (times beside ``torch.sparse.mm``); the tier-1
    sparse cases card against CPU."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ndarray import sparse

    g_loss, g_w, g_b, g_t = _avazu_train(mx, mx.gpu(0))
    c_loss, c_w, c_b, _ = _avazu_train(mx, mx.cpu())
    l_err = max(abs(a - b) for a, b in zip(g_loss, c_loss))
    w_err = float(max(np.abs(g_w - c_w).max(), np.abs(g_b - c_b).max()))
    if not all(np.isfinite(g_loss)) or l_err > 1e-5 or w_err > 1e-5 or \
            not g_loss[-1] < g_loss[0]:
        fail(f"25.3 avazu LR: card losses {g_loss} vs CPU {c_loss} "
             f"(max diff {l_err}), weights max diff {w_err}")
    # the dot against the dense product at 1,024 x 65,536
    rs = np.random.RandomState(6)
    R, C, N = 1024, 65536, 64
    cols = np.sort(rs.randint(0, C - AVAZU_NNZ, (R, AVAZU_NNZ)), axis=1) + \
        np.arange(AVAZU_NNZ)
    with mx.gpu(0):
        x = sparse.csr_matrix((rs.rand(cols.size).astype(np.float32),
                               cols.ravel(), np.arange(R + 1) * AVAZU_NNZ),
                              shape=(R, C))
        rhs = mx.nd.array(rs.randn(C, N).astype(np.float32))
    dense = x.tostype("default")._data
    got = sparse.dot(x, rhs)._data
    want = dense @ rhs._data
    d_err = (got - want).abs().max().item()
    if d_err > 1e-5 * max(1.0, want.abs().max().item()):
        fail(f"25.3 sparse.dot vs dense at {R} x {C}: max_abs_err {d_err}")
    lib = torch.sparse_csr_tensor(x._csr_indptr, x._csr_indices,
                                  x._csr_data, size=(R, C))
    dot_ms = cuda_ms(lambda i: sparse.dot(x, rhs), 20)
    dense_ms = cuda_ms(lambda i: dense @ rhs._data, 20)
    lib_ms = cuda_ms(lambda i: torch.sparse.mm(lib, rhs._data), 20)
    sweep = _sparse_sweep(mx)
    print(f"25.3 sparse LR, avazu-app width ({AVAZU_FEATURES} features, "
          f"{AVAZU_ROWS} rows x {AVAZU_NNZ} nonzeros a batch), "
          f"{AVAZU_STEPS} SGD steps: card losses "
          f"{[round(v, 6) for v in g_loss]}, max diff from the CPU's "
          f"{l_err:.3e}, weights {w_err:.3e} (tol 1e-5); ms a step "
          f"{sum(g_t[1:]) / (len(g_t) - 1) * 1e3:.3f}; sparse.dot at {R} x "
          f"{C} x {N}: max_abs_err {d_err:.3e} vs the dense product, ms "
          f"{dot_ms:.5f} (dense matmul {dense_ms:.5f}, torch.sparse.mm "
          f"{lib_ms:.5f}); {sweep['cases']} tier-1 cases card = CPU "
          f"(dots within {sweep['dot_max_abs_err']:.3e}); {card_line()}",
          flush=True)
    del x, rhs, dense, lib
    torch.cuda.empty_cache()
    return dict(losses=g_loss, cpu_losses=c_loss, loss_err=l_err,
                weight_err=w_err, step_ms=sum(g_t[1:]) / (len(g_t) - 1) * 1e3,
                dot_err=d_err, dot_ms=dot_ms, dense_ms=dense_ms,
                torch_sparse_ms=lib_ms, sweep=sweep)


def profiler_engine(amp_row):
    """25.4, from 25.1's children: ``profiler.dumps()`` over run A's steps
    2-4 counts ``flash_attention`` 36 times and ``FullyConnected`` as the
    model calls it (qkv and proj in each of 12 layers and the head: 25 a
    step); ``device_dumps``/``device_events`` list K1-K3's fp16
    kernels; the NaiveEngine run's step-1 loss and weights equal run A's
    bit for bit."""
    import re

    a, naive = amp_row["runs"]["a"], amp_row["runs"]["naive"]
    prof = a["profile"]
    calls = {}
    for line in prof["table"].splitlines()[2:]:
        m = re.match(r"^(\S+)\s+(\d+)\s", line)
        if m:
            calls[m.group(1)] = int(m.group(2))
    n = len(P25_PROFILED)
    if calls.get("flash_attention") != 12 * n or \
            calls.get("FullyConnected") != FC_CALLS_A_STEP * n:
        fail(f"25.4 profiler: flash_attention {calls.get('flash_attention')}"
             f" (expected {12 * n}), FullyConnected "
             f"{calls.get('FullyConnected')} (expected {FC_CALLS_A_STEP * n})")
    names = prof["device_names"]
    missing = [k for k in ("flash_fwd_mma_kernel<__half",
                           "flash_bwd_dq_mma_kernel<__half",
                           "flash_bwd_dkv_mma_kernel<__half")
               if not any(k in x for x in names)]
    if missing:
        fail(f"25.4 device_dumps: no {missing} among {len(names)} kernels")
    if naive["engine"] != "NaiveEngine" or naive["loss1"] != a["loss1"] or \
            naive["digest1"] != a["digest1"]:
        fail(f"25.4 NaiveEngine step 1: loss {naive['loss1']} vs "
             f"{a['loss1']}, weights equal {naive['digest1'] == a['digest1']}")
    print(f"25.4 profiler over steps {P25_PROFILED}: flash_attention "
          f"{calls['flash_attention']}, FullyConnected "
          f"{calls['FullyConnected']}; device kernels by name:\n"
          f"{prof['by_name']}\nby category:\n{prof['by_category']}\n"
          f"25.4 NaiveEngine step 1 = threaded bit for bit (loss "
          f"{naive['loss1']})", flush=True)
    return dict(calls=calls, device_kernels=len(names))


def check_runtime():
    """Phase 25: 25.1-25.4, with the phase's seconds."""
    import gc

    import torch

    # 25.1's children share the card: hand back what earlier phases cached
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    amp_row = amp_kill_resume()
    captured = captured_mid_window()
    sp = sparse_avazu()
    prof = profiler_engine(amp_row)
    secs = time.perf_counter() - t0
    print(f"phase 25: {secs:.2f} s", flush=True)
    launches = {n: amp_row["launches"][n] + captured["launches"][n]
                for n in ATTN_KERNELS}
    return dict(amp=amp_row, captured=captured, sparse=sp, profiler=prof,
                seconds=secs, launches=launches,
                fp16_launches=amp_row["launches"])


# --------------------------------------------------------------------------- #
# phase 26: vision breadth (the model zoo's other families at published
# widths, the Estimator over ResNet-50 through K6, the contrib layers)
# --------------------------------------------------------------------------- #

# 26.1: one member of each family, at its published input side
ZOO = (("alexnet", 224), ("vgg16_bn", 224), ("squeezenet1.1", 224),
       ("densenet121", 224), ("inceptionv3", 299), ("mobilenet1.0", 224),
       ("mobilenetv2_1.0", 224))
ZOO_CPU_B = 2               # 26.1(a): f32, card against CPU
ZOO_TOL = 1e-4              # 26.1(a): of the largest magnitude
ZOO_B = 64                  # 26.1(b): bf16 with f32 masters, fused
ZOO_STEPS = 4
ZOO_OPT = {"learning_rate": 0.01, "momentum": 0.9, "multi_precision": True}
# the first loss's distance from ln 1000: Xavier-initialized VGG-16-BN
# starts with wider logits (8.908 on the CPU in f32 at batch 4, 9.116 on
# the card at batch 64); the others start within 0.35 of 6.908
ZOO_LOSS0_TOL = 3.0
# cuDNN's and PyTorch's grouped and depthwise convolution kernels, by name
GROUPED_KERNELS = r"(?i)depthwise|grouped|group_conv|dgrad2d_grouped"
# 26.2: ResNet-50 v1 NHWC bf16 fitted by the Estimator
EST_BATCHES = 12            # one epoch of 128-image batches
EST_EVERY = 4               # an atomic checkpoint every 4 batches
EST_RESUME = 8              # the resumed run starts from this checkpoint
EST_VAL = 2                 # validation batches
EST_OPT = dict(RESNET_OPT, multi_precision=False)
EST_WORKERS = 4
# 26.3: ConvLSTM at Moving MNIST's shape (Shi et al. 2015: 64 x 64
# frames as 16 x 16 x 16 patches, 64 hidden channels, 5 x 5 kernels)
CONVLSTM = dict(batch=16, steps=10, channels=16, side=16, hidden=64,
                kernel=5)
CONTRIB_TOL = 1e-4          # 26.3: ConvLSTM card against CPU
ORTH_N = 1024
ORTH_TOL = 1e-5             # 26.3: W Wᵀ against scale² I


def zoo_vs_cpu(name, side):
    """26.1(a): the member in f32 at batch 2 (TF32 off), built and
    initialized on the CPU, its weights carried to the card by
    ``models.convert``: the predict-mode logits, then the weights after
    one SGD step (lr 0.1) recorded with ``train_mode=False`` (BatchNorm
    on its running statistics, no dropout), card against CPU within
    ``ZOO_TOL`` of the largest magnitude.  A batch-statistics step is
    not held: at batch 2 its f32 one-pass variance (the reference's
    formula) leaves VGG-16-BN's first weights 2.4e-3 of the largest
    magnitude from a float64 step on the CPU alone."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    from mxnet_tpu_torch.models import arrays_from_port, load_mxnet_tpu_arrays

    rs = np.random.RandomState(26)
    x = rs.standard_normal((ZOO_CPU_B, 3, side, side)).astype(np.float32)
    y = rs.randint(0, 1000, ZOO_CPU_B).astype(np.float32)
    t0 = time.perf_counter()
    with mx.cpu():
        cpu = get_model(name, classes=1000)
        cpu.initialize(mx.init.Xavier(), ctx=mx.cpu(), seed=0)
        want = cpu(mx.nd.array(x)).asnumpy()
    card = get_model(name, classes=1000)
    load_mxnet_tpu_arrays(card, arrays_from_port(cpu, prefix=card.prefix))
    got = card(mx.nd.array(x, ctx=mx.gpu(0))).asnumpy()
    logit_err = float(np.abs(got - want).max() / np.abs(want).max())

    def step(net, ctx):
        tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.1})
        loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        with ctx:
            xs, ys = mx.nd.array(x), mx.nd.array(y)
            with mx.autograd.record(train_mode=False):
                L = loss(net(xs), ys)
            L.backward()
            tr.step(ZOO_CPU_B)
        return arrays_from_port(net)

    a, b = step(cpu, mx.cpu()), step(card, mx.gpu(0))
    torch.cuda.synchronize()
    scale = max(float(np.abs(v).max()) for v in a.values())
    worst = max(a, key=lambda k: float(np.abs(a[k] - b[k]).max()))
    weight_err = float(np.abs(a[worst] - b[worst]).max()) / scale
    row = dict(logit_err=logit_err, weight_err=weight_err,
               worst=worst, seconds=time.perf_counter() - t0)
    print(f"26.1 {name} f32 vs cpu: batch {ZOO_CPU_B} at {side}x{side}, "
          f"logits {logit_err:.3e} and weights after one predict-mode SGD "
          f"step {weight_err:.3e} of the largest magnitude (worst {worst}; tol "
          f"{ZOO_TOL}); {row['seconds']:.2f} s", flush=True)
    if not (logit_err <= ZOO_TOL and weight_err <= ZOO_TOL):
        fail(f"26.1 {name}: card against CPU {logit_err} / {weight_err} "
             f"> {ZOO_TOL}")
    del cpu, card
    return row


def zoo_train(name, side):
    """26.1(b): the member in bf16 with f32 masters at batch 64,
    hybridized, ``Trainer.fused_step`` with SGD (momentum 0.9),
    ``ZOO_STEPS`` steps: ms a step over the replays from step 3, images/s, peak bytes, captures (1 after the
    first capture), the replay's kernel nodes; the first loss within
    ``ZOO_LOSS0_TOL`` of ln 1000 and every loss finite; for the
    MobileNets the grouped convolutions' share of a replay's device
    time."""
    import math
    import re

    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon import fused_step as fsm
    from mxnet_tpu_torch.gluon.block import _GraphProgram
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model

    gen = torch.Generator(device="cuda").manual_seed(26)
    data = torch.rand((ZOO_B, 3, side, side), generator=gen,
                      device="cuda").bfloat16()
    label = torch.randint(0, 1000, (ZOO_B,), generator=gen, device="cuda")
    x, y = mx.nd.NDArray(data), mx.nd.NDArray(label)
    net = get_model(name, classes=1000)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0), seed=0)
    net.cast("bfloat16")
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(ZOO_OPT))
    loss_l = gluon.loss.SoftmaxCrossEntropyLoss()

    def loss_fn(x, y):
        return loss_l(net(x), y)

    def step():
        return trainer.fused_step(loss_fn, x, y)._data.float().mean()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fsm.reset_step_counters()
    _GraphProgram.debug = True
    try:
        t0 = time.perf_counter()
        losses = [step()]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    finally:
        _GraphProgram.debug = False
    captures_2 = fsm.step_counters["compiles"]
    for _ in range(ZOO_STEPS - 2):
        losses.append(step())
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    counters = dict(fsm.step_counters)
    peak = torch.cuda.max_memory_allocated()
    (fs,) = trainer._fused_steps.values()
    prog = next(p for k, p in fs._programs.items() if k[0] == "apply")
    every = prog.kernel_nodes()
    losses = [float(v) for v in losses]
    timed = ZOO_STEPS - 2
    row = dict(losses=losses, ms_per_step=(t3 - t2) / timed * 1e3,
               images_per_s=timed * ZOO_B / (t3 - t2),
               eager_step_ms=(t1 - t0) * 1e3,
               capture_and_replay_ms=(t2 - t1) * 1e3,
               capture_s=prog.capture_s, max_memory_allocated=peak,
               memory_above_start=peak - base, captures=counters["compiles"],
               captures_after_step_2=captures_2,
               kernel_nodes=sum(every.values()),
               parameters=sum(int(p.data()._data.numel())
                              for p in net.collect_params().values()))
    if name.startswith("mobilenet"):
        by_name, busy, wall_us = _profiled(step)
        grouped = sum(us for k, us in by_name.items()
                      if re.search(GROUPED_KERNELS, k))
        row["profile"] = report_profile(f"26.1 {name} profile", by_name,
                                        busy, wall_us, top=6)
        row["grouped_share"] = grouped / busy if busy > 0 else None
        row["grouped_kernels"] = sorted(
            {k[:80] for k in by_name if re.search(GROUPED_KERNELS, k)})
        print(f"26.1 {name}: grouped convolutions "
              f"{row['grouped_share']} of a replay's device time "
              f"({grouped:.0f} us; kernels {row['grouped_kernels'][:4]})",
              flush=True)
    print(f"26.1 {name} bf16: B={ZOO_B} {side}x{side}, "
          f"{row['parameters']} parameters, SGD momentum 0.9 with f32 "
          f"masters through Trainer.fused_step; losses "
          f"{[round(v, 4) for v in losses]}; ms/step={row['ms_per_step']:.3f}"
          f" (steps 3-{ZOO_STEPS}) images/s={row['images_per_s']:.2f}; "
          f"eager step {row['eager_step_ms']:.1f} ms, capture+replay "
          f"{row['capture_and_replay_ms']:.1f} ms (capture "
          f"{row['capture_s']} s); max_memory_allocated={peak} "
          f"({row['memory_above_start']} above the start); captures "
          f"{row['captures']} (after step 2: {captures_2}); "
          f"{row['kernel_nodes']} kernel nodes a replay", flush=True)
    if counters["legacy_steps"] or captures_2 != 1 or \
            counters["compiles"] != 1:
        fail(f"26.1 {name}: step counters {counters}, captures after step "
             f"2: {captures_2}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"26.1 {name}: losses not finite: {losses}")
    if abs(losses[0] - math.log(1000)) > ZOO_LOSS0_TOL:
        fail(f"26.1 {name}: first loss {losses[0]} is not within "
             f"{ZOO_LOSS0_TOL} of ln(1000)")
    trainer._fused_steps.clear()
    del fs, prog, trainer, net, x, y, data, label
    torch.cuda.empty_cache()
    return row


def check_zoo():
    """26.1: each family's member, (a) then (b)."""
    rows = {}
    for name, side in ZOO:
        rows[name] = dict(vs_cpu=zoo_vs_cpu(name, side),
                          train=zoo_train(name, side))
    return rows


def _images_dataset(mx, n, seed):
    """``n`` seeded random 3 x 224 x 224 f32 images in [0, 1) and their
    labels, each made from its own seed when it is read (ImageNet is not
    in the repository)."""
    import numpy as np

    class Images(mx.gluon.data.Dataset):
        def __len__(self):
            return n

        def __getitem__(self, i):
            rs = np.random.default_rng((seed, i))
            return (rs.random((3, 224, 224), dtype=np.float32),
                    np.float32(rs.integers(0, 1000)))

    return Images()


class _From:
    """One epoch of ``loader`` from batch ``done`` on: the data cursor a
    resumed run starts at (``DataLoader.iter_from``)."""

    def __init__(self, loader, done):
        self.loader, self.done = loader, done

    def __iter__(self):
        return self.loader.iter_from(self.done)


def _est_net(mx):
    """ResNet-50 v1 NHWC in bf16, hybridized, behind a block that casts
    the f32 images to bf16 at its input (inside the captured step)."""
    import torch

    class Bf16Input(mx.gluon.HybridBlock):
        def __init__(self, net):
            super().__init__(prefix="")
            self.net = net

        def forward(self, x):
            return self.net(x.to(torch.bfloat16))

    net = Bf16Input(_gluon_resnet50(mx))
    net.hybridize()
    return net


def _est_run(mx, directory, data, val, resume):
    """One ``Estimator.fit`` of ResNet-50 through K6 with the atomic
    handler; returns the estimator, the handler and what each batch's
    end saw: its loss and predictions (copied to the host), the time and
    the metric module's host reads."""
    import torch
    from mxnet_tpu_torch import gluon, metric
    from mxnet_tpu_torch.gluon.block import _GraphProgram
    from mxnet_tpu_torch.gluon.contrib import estimator as E
    from mxnet_tpu_torch.ops import conv_fused as cf

    net = _est_net(mx)
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(EST_OPT))
    est = E.Estimator(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                      metrics=[metric.Accuracy(), metric.Loss()],
                      trainer=trainer, fused_step=True)
    atomic = E.AtomicCheckpointHandler(directory, every_n_batches=EST_EVERY,
                                       every_n_epochs=None, resume=resume)
    seen = []

    class Watch(E.BatchEnd):
        priority = 10000        # after the checkpoint handler's save

        def batch_end(self, est, *a, **k):
            seen.append(dict(t=time.perf_counter(),
                             reads=metric.host_reads(),
                             loss=k["loss"].asnumpy(),
                             pred=k["pred"].asnumpy()))

    cf.conv1x1_bwd_pair.launches = 0
    _GraphProgram.debug = True
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r0 = metric.host_reads()
    try:
        est.fit(data, val_data=val, epochs=1,
                event_handlers=[atomic, Watch()])
    finally:
        _GraphProgram.debug = False
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    (fs,) = trainer._fused_steps.values()
    prog = next(p for k, p in fs._programs.items() if k[0] == "apply")
    k6 = cf.conv1x1_bwd_pair.launches - prog.launches.get("conv1x1_bwd", 0) \
        + fs.launches().get("conv1x1_bwd", 0)
    counts, every = _graph_nodes(prog, ("conv1x1_bwd",))
    return dict(est=est, atomic=atomic, seen=seen, seconds=secs,
                reads_start=r0, k6=k6, k6_nodes=counts["conv1x1_bwd"],
                kernel_nodes=sum(every.values()), fs=fs)


def estimator_resnet(fused_row):
    """26.2: ResNet-50 v1 NHWC bf16 at 128 x 224², hybridized, fitted by
    ``Estimator(..., fused_step=True)`` with ``MXNET_FUSED_CONV_BWD=1``:
    ``Accuracy`` and ``Loss``, a ``ValidationHandler`` over 2 batches, an
    ``AtomicCheckpointHandler`` every 4 batches, one epoch of 12 batches
    from seeded images through a ``DataLoader``.  Then a second estimator
    with ``resume=True`` starts from the batch-8 checkpoint (the data
    from ``iter_from(8)``): its batches 9-12 equal the uninterrupted
    run's bit for bit (each batch's loss and predictions, so its metric
    values; the weights and running statistics; the cursor).  K6 runs 30
    times a step in both.  ms a batch (3-12) beside phase 18's fused
    step, and the metric handlers' host reads a batch."""
    import shutil

    import numpy as np
    import torch
    import mxnet_tpu_torch as mx

    os.environ["MXNET_FUSED_CONV_BWD"] = "1"
    root = os.path.join(HERE, "build", "phase26")
    shutil.rmtree(root, ignore_errors=True)
    full_dir = os.path.join(root, "full")
    resume_dir = os.path.join(root, "resume")
    loader = mx.gluon.data.DataLoader(
        _images_dataset(mx, EST_BATCHES * RESNET_B, 26),
        batch_size=RESNET_B, shuffle=False, num_workers=EST_WORKERS)
    val = mx.gluon.data.DataLoader(
        _images_dataset(mx, EST_VAL * RESNET_B, 27), batch_size=RESNET_B,
        shuffle=False, num_workers=EST_WORKERS)
    mx.random.seed(26)
    full = _est_run(mx, full_dir, loader, val, resume=False)
    after = {k: p.data()._data.clone() for k, p in
             full["est"].net._collect_params_with_prefix().items()}
    seen = full["seen"]
    times = [b["t"] for b in seen]
    ms = [(b - a) * 1e3 for a, b in zip(times[:-1], times[1:])]
    saves = {EST_EVERY * i for i in range(1, EST_BATCHES // EST_EVERY + 1)}
    # batch i+1's interval ends at its batch_end (i 0-based in ms)
    timed = ms[1:]                       # batches 3..12
    unsaved = [m for i, m in enumerate(ms, start=2) if i >= 3 and
               i not in saves]
    reads = [b["reads"] for b in seen]
    per_batch_reads = sorted({b - a for a, b in zip(reads[:-1], reads[1:])})
    steps = [os.path.basename(p) for p in sorted(os.listdir(full_dir))
             if p.startswith("step_")]
    os.makedirs(resume_dir)
    for s in steps:
        if int(s.split("_")[1]) <= EST_RESUME:
            shutil.copytree(os.path.join(full_dir, s),
                            os.path.join(resume_dir, s))
    hf = full["atomic"]
    cursor_full = (hf.current_batch, hf.current_epoch)
    k6_full, nodes_full = full["k6"], full["k6_nodes"]
    full_s = full["seconds"]
    full["est"].trainer._fused_steps.clear()
    del full
    torch.cuda.empty_cache()
    mx.random.seed(0)                # other weights than the run's start
    res = _est_run(mx, resume_dir, _From(loader, EST_RESUME), val,
                   resume=True)
    hr = res["atomic"]
    cursor_res = (hr.current_batch, hr.current_epoch)
    rest = seen[EST_RESUME:]
    same_batches = len(res["seen"]) == len(rest) and all(
        np.array_equal(a["loss"], b["loss"]) and
        np.array_equal(a["pred"], b["pred"])
        for a, b in zip(res["seen"], rest))
    now = res["est"].net._collect_params_with_prefix()
    differ = [k for k, t in after.items()
              if not torch.equal(now[k].data()._data, t)]
    metrics_res = [m.get() for m in res["est"].train_metrics]
    row = dict(batches=EST_BATCHES, seconds=full_s,
               resumed_seconds=res["seconds"],
               ms_per_batch=sum(timed) / len(timed),
               ms_per_batch_unsaved=sum(unsaved) / max(1, len(unsaved)),
               ms_batches=ms, saves=sorted(saves), steps_saved=steps,
               host_reads_a_batch=per_batch_reads,
               fused_ms_per_step=fused_row["ms_per_step"] if fused_row
               else None,
               cursor=cursor_full, resumed_cursor=cursor_res,
               resumed_step=hr.resumed_step,
               resumed_metrics=metrics_res,
               batches_equal=same_batches, weights_differ=differ,
               k6_full=k6_full, k6_resumed=res["k6"],
               k6_nodes=[nodes_full, res["k6_nodes"]],
               kernel_nodes=res["kernel_nodes"],
               launches=dict(conv1x1_bwd=k6_full + res["k6"]))
    print(f"26.2 estimator resnet: resnet50_v1 NHWC bf16, B={RESNET_B} "
          f"224x224, {EST_BATCHES} batches through Estimator(fused_step="
          f"True) with Accuracy, Loss, a ValidationHandler over {EST_VAL} "
          f"batches and an AtomicCheckpointHandler every {EST_EVERY}; "
          f"{full_s:.2f} s; ms a batch {row['ms_per_batch']:.3f} (batches "
          f"3-{EST_BATCHES}), {row['ms_per_batch_unsaved']:.3f} without "
          f"a save, beside phase 18's fused step "
          f"{row['fused_ms_per_step']} ms; host reads a batch by the "
          f"metric handlers {per_batch_reads}; checkpoints {steps}",
          flush=True)
    print(f"26.2 estimator resnet: ms each batch "
          f"{[round(m, 2) for m in ms]}", flush=True)
    print(f"26.2 estimator resume: from step {hr.resumed_step}, batches "
          f"{EST_RESUME + 1}-{EST_BATCHES} equal the uninterrupted run's "
          f"bit for bit (loss, predictions): {same_batches}; weights and "
          f"statistics differing: {len(differ)} of {len(after)}; cursor "
          f"{cursor_res} against {cursor_full}; metrics {metrics_res}; "
          f"K6 {k6_full} + {res['k6']} launches ({K6_PER_STEP} a step: "
          f"{K6_PER_STEP * EST_BATCHES} + "
          f"{K6_PER_STEP * (EST_BATCHES - EST_RESUME)}), graph nodes "
          f"{row['k6_nodes']}; {res['seconds']:.2f} s", flush=True)
    if hr.resumed_step != EST_RESUME or not same_batches or differ or \
            cursor_res != cursor_full or cursor_full != (EST_BATCHES, 1):
        fail(f"26.2 estimator resume: step {hr.resumed_step}, batches "
             f"equal {same_batches}, {len(differ)} arrays differ (first "
             f"{differ[:3]}), cursor {cursor_res} vs {cursor_full}")
    if k6_full != K6_PER_STEP * EST_BATCHES or \
            res["k6"] != K6_PER_STEP * (EST_BATCHES - EST_RESUME) or \
            row["k6_nodes"] != [K6_PER_STEP, K6_PER_STEP]:
        fail(f"26.2 estimator: K6 launches {k6_full} + {res['k6']}, "
             f"nodes {row['k6_nodes']}")
    losses = [float(b["loss"].mean()) for b in seen]
    if not all(np.isfinite(losses)):
        fail(f"26.2 estimator: losses not finite: {losses}")
    row["losses"] = losses
    res["est"].trainer._fused_steps.clear()
    del res
    torch.cuda.empty_cache()
    return row


def contrib_layers():
    """26.3: ``Conv2DLSTMCell`` unrolled 10 steps at Moving MNIST's
    ConvLSTM shape in f32, card against CPU within ``CONTRIB_TOL``;
    ``PixelShuffle2D`` card equal to CPU; ``SyncBatchNorm`` on one card
    equal to ``BatchNorm`` bit for bit (forward and gradients); an
    ``Orthogonal`` (1024, 1024) on the card with ``W Wᵀ`` within
    ``ORTH_TOL`` of scale² I."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.contrib import nn as cnn
    from mxnet_tpu_torch.gluon.contrib import rnn as crnn
    from mxnet_tpu_torch.models import arrays_from_port, load_mxnet_tpu_arrays

    c = CONVLSTM
    rs = np.random.RandomState(263)
    x = rs.standard_normal((c["batch"], c["steps"], c["channels"],
                            c["side"], c["side"])).astype(np.float32)

    def cell():
        return crnn.Conv2DLSTMCell(
            (c["channels"], c["side"], c["side"]), c["hidden"],
            i2h_kernel=c["kernel"], h2h_kernel=c["kernel"],
            i2h_pad=c["kernel"] // 2, prefix="convlstm_")

    with mx.cpu():
        cpu = cell()
        cpu.initialize(mx.init.Xavier(), ctx=mx.cpu(), seed=0)
        want, wstates = cpu.unroll(c["steps"], mx.nd.array(x), layout="NTC",
                                   merge_outputs=True)
    card = cell()
    load_mxnet_tpu_arrays(card, arrays_from_port(cpu, prefix="convlstm_"))
    xc = mx.nd.array(x, ctx=mx.gpu(0))
    got, gstates = card.unroll(c["steps"], xc, layout="NTC",
                               merge_outputs=True)
    lstm_err = max(float(np.abs(a.asnumpy() - b.asnumpy()).max())
                   for a, b in zip([got] + gstates, [want] + wstates))
    lstm_ms = cuda_ms(lambda i: card.unroll(c["steps"], xc, layout="NTC",
                                            merge_outputs=True), 5, warm=1)
    y = rs.standard_normal((16, 64, 32, 32)).astype(np.float32)
    with mx.cpu():
        ps_cpu = cnn.PixelShuffle2D(2)(mx.nd.array(y)).asnumpy()
    ps_card = cnn.PixelShuffle2D(2)(mx.nd.array(y, ctx=mx.gpu(0))).asnumpy()
    ps_equal = bool(np.array_equal(ps_card, ps_cpu))
    z = rs.standard_normal((32, 64, 28, 28)).astype(np.float32)
    head = rs.standard_normal(z.shape).astype(np.float32)
    outs = []
    for cls in (mx.gluon.nn.BatchNorm, cnn.SyncBatchNorm):
        bn = cls(in_channels=64) if cls is cnn.SyncBatchNorm else \
            cls(axis=1, in_channels=64)
        bn.initialize(ctx=mx.gpu(0))
        xs = mx.nd.array(z, ctx=mx.gpu(0))
        xs.attach_grad()
        with mx.autograd.record():
            o = bn(xs)
        o.backward(mx.nd.array(head, ctx=mx.gpu(0)))
        outs.append([o.asnumpy(), xs.grad.asnumpy(),
                     bn.gamma.grad().asnumpy(), bn.beta.grad().asnumpy(),
                     bn.running_mean.data().asnumpy(),
                     bn.running_var.data().asnumpy()])
    sync_equal = all(np.array_equal(a, b) for a, b in zip(*outs))
    w = mx.nd.zeros((ORTH_N, ORTH_N), ctx=mx.gpu(0))
    scale = 1.414
    mx.init.Orthogonal(scale=scale)("orth_weight", w)
    wt = w._data.double()
    orth_err = float((wt @ wt.T - scale ** 2 * torch.eye(
        ORTH_N, dtype=torch.float64, device=wt.device)).abs().max())
    row = dict(convlstm_err=lstm_err, convlstm_ms=lstm_ms,
               pixel_shuffle_equal=ps_equal, sync_bn_equal=sync_equal,
               orthogonal_err=orth_err)
    print(f"26.3 contrib: Conv2DLSTMCell {c['steps']} steps at "
          f"{c['batch']} x {c['channels']} x {c['side']}² (hidden "
          f"{c['hidden']}, {c['kernel']}x{c['kernel']}) card vs cpu "
          f"{lstm_err:.3e} (tol {CONTRIB_TOL}), {lstm_ms:.3f} ms an "
          f"unroll; PixelShuffle2D card == cpu {ps_equal}; SyncBatchNorm "
          f"== BatchNorm bit for bit {sync_equal}; Orthogonal "
          f"({ORTH_N}, {ORTH_N}) |W Wᵀ - {scale}² I| {orth_err:.3e} (tol "
          f"{ORTH_TOL})", flush=True)
    if not (lstm_err <= CONTRIB_TOL and ps_equal and sync_equal and
            orth_err <= ORTH_TOL):
        fail(f"26.3 contrib: {row}")
    return row


def check_vision_breadth(fused_row):
    """Phase 26: 26.1-26.3, with the phase's seconds."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    zoo = check_zoo()
    t1 = time.perf_counter()
    est = estimator_resnet(fused_row)
    t2 = time.perf_counter()
    contrib = contrib_layers()
    secs = time.perf_counter() - t0
    print(f"phase 26: {secs:.2f} s (26.1 {t1 - t0:.2f}, 26.2 "
          f"{t2 - t1:.2f}, 26.3 {time.perf_counter() - t2:.2f}); the "
          f"script so far {time.perf_counter() - T_START:.2f} s", flush=True)
    return dict(zoo=zoo, estimator=est, contrib=contrib, seconds=secs,
                launches=est["launches"])


# --------------------------------------------------------------------------- #
# phase 27: the symbolic surface, the twenty-fourth slice: mx.sym, export
# and imports, mx.mod.Module and BucketingModule, mx.model, mx.callback,
# the Predictor
# --------------------------------------------------------------------------- #

SYM_DIR = os.path.join(HERE, "build", "phase27")   # git-ignored
SYM_B, SYM_SIDE = 128, 224  # 27.1: ResNet-50 v1 NHWC, f32, 128 x 224^2
SYM_BATCHES = 12            # one epoch of Module.fit
SYM_BITS = 3                # batches held bit for bit against eager steps
SYM_FREQ = 4                # Speedometer(128, 4)
SYM_OPT = {"learning_rate": 0.1, "momentum": 0.9}
SYM_GPT_STEPS = 3           # 27.2: AdamW fused steps, imported and source
LM_SYM_V, LM_SYM_H, LM_SYM_L, LM_SYM_N = 33278, 650, 2, 20
LM_SYM_BUCKETS = (35, 70)   # 27.3: the default bucket is the longest
LM_SYM_STEPS = 3            # steps a bucket, the buckets in turn
LM_SYM_OPT = {"learning_rate": 1.0}


def _sym_dir():
    os.makedirs(SYM_DIR, exist_ok=True)
    return SYM_DIR


def _port_counts():
    from mxnet_tpu_torch.gluon.block import _launch_counts

    return _launch_counts()


def _count_delta(before):
    return {k: v - before[k] for k, v in _port_counts().items()
            if v != before[k]}


class _LogLines:
    """The log records of a block (Speedometer's lines)."""

    def __init__(self):
        import logging

        self.lines = []
        self._logging = logging
        self._handler = logging.Handler()
        self._handler.emit = lambda r: self.lines.append(r.getMessage())

    def __enter__(self):
        root = self._logging.getLogger()
        self._level = root.level
        root.setLevel(self._logging.INFO)
        root.addHandler(self._handler)
        return self

    def __exit__(self, *a):
        root = self._logging.getLogger()
        root.removeHandler(self._handler)
        root.setLevel(self._level)


def sym_resnet(fused_row):
    """27.1: MXNet 1.x's symbolic training script.  ResNet-50 v1 NHWC
    f32 from the model zoo, exported by ``HybridBlock.export``, read back
    by ``mx.sym.load``, ``SoftmaxOutput`` appended, fitted by
    ``mx.mod.Module`` for one epoch of ``SYM_BATCHES`` seeded batches
    (``mx.io.NDArrayIter``, SGD with momentum, ``rescale_grad`` 1/128,
    ``MXNET_FUSED_CONV_BWD=1``, ``Speedometer`` and ``do_checkpoint``).
    K6 exactly 30 launches a batch and no other kernel of the port; the
    first loss near ln 1000, every loss finite; the first ``SYM_BITS``
    batches bit for bit with the same steps run eagerly on the source
    block (predict-mode forward, as the exported graph's BatchNorms run,
    ``SoftmaxOutput``, ``backward``, ``multi_update``); ``Module.load``
    restores the checkpoint bit for bit.  cuDNN runs its deterministic
    algorithms here: with its defaults two runs of the same f32 step part
    by rounding (some weight-gradient algorithms sum with atomics), and
    the arms could not be held bit for bit."""
    import math

    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, initializer
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_resnet

    gpu = mx.gpu(0)
    d = _sym_dir()
    old_env = os.environ.get("MXNET_FUSED_CONV_BWD")
    os.environ["MXNET_FUSED_CONV_BWD"] = "1"
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    mx.random.seed(0)
    with gpu:
        net = get_resnet(1, 50, classes=1000, layout="NHWC")
    net.initialize(initializer.Xavier(rnd_type="uniform", factor_type="avg",
                                      magnitude=3), ctx=gpu, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(27)
    n = SYM_B * SYM_BATCHES
    data = mx.nd.NDArray(torch.rand((n, 3, SYM_SIDE, SYM_SIDE),
                                    generator=gen, device="cuda"))
    label = mx.nd.NDArray(torch.randint(0, 1000, (n,), generator=gen,
                                        device="cuda").float())
    net(data[:SYM_B])           # the input signature export reads
    prefix = os.path.join(d, "resnet50_v1")
    t0 = time.perf_counter()
    net.export(prefix)
    export_s = time.perf_counter() - t0
    sym = mx.sym.load(prefix + "-symbol.json")
    graph = mx.sym.SoftmaxOutput(sym, mx.sym.var("softmax_label"),
                                 name="softmax")
    args0, _ = mx.model.load_params(prefix, 0, ctx=gpu)
    ops = {}
    for node in json.loads(graph.tojson())["nodes"]:
        ops[node["op"]] = ops.get(node["op"], 0) + 1

    it = mx.io.NDArrayIter(data, label, batch_size=SYM_B)
    mod = mx.mod.Module(graph, context=gpu)
    outs, losses, marks, k6, snap = [], [], [], [], {}
    before = _port_counts()

    def on_batch(param):
        # the metric's host read has waited for the batch
        marks.append(time.perf_counter())
        k6.append(_port_counts()["conv1x1_bwd"])
        prob = mod.get_outputs()[0]._data
        lab = mod._exec.arg_dict["softmax_label"]._data.long()
        losses.append(float(-prob.detach().gather(1, lab[:, None]).log()
                            .mean()))
        if param.nbatch < SYM_BITS:
            outs.append(prob.clone())
        if param.nbatch == SYM_BITS - 1:
            snap.update({nm: mod._exec.arg_dict[nm]._data.detach().clone()
                         for nm in mod._param_names})

    ck = os.path.join(d, "resnet50_module")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _LogLines() as log:
        mod.fit(it, num_epoch=1, optimizer="sgd",
                optimizer_params=tuple(SYM_OPT.items()),
                arg_params=args0,
                batch_end_callback=[on_batch,
                                    mx.callback.Speedometer(SYM_B, SYM_FREQ)],
                epoch_end_callback=mx.callback.do_checkpoint(ck))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = _count_delta(before)
    per_batch = [b - a for a, b in zip([before["conv1x1_bwd"]] + k6, k6)]
    ms_batch = (marks[-1] - marks[SYM_BITS]) / (len(marks) - 1 - SYM_BITS) \
        * 1e3
    speed = [ln for ln in log.lines if "samples/sec" in ln]

    # the same first batches, eagerly on the source block
    opt = mx.optimizer.create("sgd", rescale_grad=1.0 / SYM_B, **SYM_OPT)
    byname = net.collect_params()
    names = mod._param_names
    states = [opt.create_state_multi_precision(i, byname[nm].data()._data)
              for i, nm in enumerate(names)]
    eager_equal = []
    for b in range(SYM_BITS):
        x = data[b * SYM_B:(b + 1) * SYM_B]
        y = label[b * SYM_B:(b + 1) * SYM_B]
        with autograd.record(train_mode=False):
            prob = mx.nd.SoftmaxOutput(net(x), y)
        prob.backward()
        eager_equal.append(bool(torch.equal(prob._data, outs[b])))
        grads = [byname[nm].grad() if byname[nm].grad_req != "null"
                 else mx.nd.NDArray(torch.zeros_like(byname[nm].data()._data))
                 for nm in names]
        opt.multi_update(list(range(len(names))),
                         [byname[nm].data() for nm in names], grads, states)
    diff = [nm for nm in names
            if not torch.equal(byname[nm].data()._data, snap[nm])]
    worst = max(((byname[nm].data()._data - snap[nm]).abs().max().item(), nm)
                for nm in names)

    loaded = mx.mod.Module.load(ck, 1, context=gpu)
    loaded.bind(it.provide_data, it.provide_label, for_training=False)
    loaded.init_params()
    restored = [nm for nm in names
                if torch.equal(loaded._exec.arg_dict[nm]._data,
                               mod._exec.arg_dict[nm]._data)]
    files = sorted(f for f in os.listdir(d) if f.startswith("resnet50"))
    print(f"27.1 export: resnet50_v1 NHWC f32 exported in {export_s:.2f} s "
          f"({len(json.loads(graph.tojson())['nodes'])} nodes with "
          f"SoftmaxOutput: {dict(sorted(ops.items()))}); files {files}",
          flush=True)
    print(f"27.1 module: Module.fit over {SYM_BATCHES} batches of {SYM_B} x "
          f"{SYM_SIDE}^2 f32 (SGD {SYM_OPT}, rescale_grad 1/{SYM_B}, "
          f"MXNET_FUSED_CONV_BWD=1): losses {[round(v, 4) for v in losses]}; "
          f"ms a batch {ms_batch:.3f} (batches {SYM_BITS + 2}-{SYM_BATCHES}, "
          f"host clock at the batch-end callback, after the metric's host "
          f"read) beside phase 18's Trainer.fused_step "
          f"{fused_row['ms_per_step']:.3f} and gluon.Trainer "
          f"{fused_row['gluon_ms_per_step']:.3f} (phase 16; both bf16); "
          f"cuDNN deterministic; fit "
          f"{fit_s:.2f} s; launches {launches}, K6 a batch {per_batch}; "
          f"Speedometer: {speed}; {card_line()}", flush=True)
    print(f"27.1 bits: the first {SYM_BITS} batches run eagerly on the "
          f"source block: outputs equal bit for bit {eager_equal}; weights "
          f"after them differing {len(diff)} of {len(names)} (largest "
          f"{worst[0]:.3e} at {worst[1]}); Module.load({os.path.basename(ck)}"
          f", 1) restored {len(restored)} of {len(names)} bit for bit",
          flush=True)
    if old_env is None:
        os.environ.pop("MXNET_FUSED_CONV_BWD", None)
    else:
        os.environ["MXNET_FUSED_CONV_BWD"] = old_env
    torch.backends.cudnn.deterministic = deterministic
    if any(k != "conv1x1_bwd" for k in launches) or \
            any(c != K6_PER_STEP for c in per_batch) or \
            len(per_batch) != SYM_BATCHES:
        fail(f"27.1: launches {launches}, K6 a batch {per_batch}: expected "
             f"K6 alone, {K6_PER_STEP} a batch")
    if not all(math.isfinite(v) for v in losses) or \
            abs(losses[0] - math.log(1000)) > 1.0:
        fail(f"27.1: losses not finite or the first not within 1.0 of "
             f"ln 1000: {losses}")
    if not all(eager_equal) or diff:
        fail(f"27.1: eager steps part from the Module's: outputs "
             f"{eager_equal}, weights {diff[:5]} (largest {worst})")
    if len(restored) != len(names):
        fail(f"27.1: Module.load restored {len(restored)} of {len(names)}")
    if len(speed) != (SYM_BATCHES - 1) // SYM_FREQ:
        fail(f"27.1: Speedometer logged {speed}")
    row = dict(losses=losses, ms_per_batch=ms_batch, fit_s=fit_s,
               export_s=export_s, launches=launches, k6_per_batch=per_batch,
               speedometer=speed, eager_equal=eager_equal,
               weights_differing=len(diff), restored=len(restored),
               params=len(names), ops=ops)
    del mod, loaded, net, data, label, it, snap, outs, states, opt
    torch.cuda.empty_cache()
    row["k6_f32"] = sym_k6_f32()
    return row


def sym_k6_f32():
    """K6's f32 kernel (the CUDA-core one, which 27.1's f32 path runs)
    at the nine ResNet-50 shapes, per step of 30 launches."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(14)
    step = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0, ops=0)
    err = 0.0
    for s, ci, co, n in K6_SHAPES:
        row = _k6_case(s, ci, co, "float32", gen)
        err = max(err, row["max_abs_err"])
        for k in step:
            step[k] += n * row[k]
        torch.cuda.empty_cache()
    step["bound_ms"], step["bound_by"] = bound_ms(step["bytes"], step["ops"],
                                                  F32_OPS_PER_S)
    step["max_abs_err"] = err
    print(f"27.1 K6 f32 per ResNet-50 step ({K6_PER_STEP} launches): "
          f"kernel_ms={step['ms']:.5f} bound_ms={step['bound_ms']:.5f} "
          f"({step['bound_by']}) plain_ms={step['plain_ms']:.5f} cudnn_ms="
          f"{step['library_ms']:.5f}; {card_line()}", flush=True)
    return step


def sym_gpt(cfg):
    """27.2: the user's ``hybrid_forward`` GPT-2 small, exported and
    imported.  The f32 net is exported, then cast to bf16 and exported
    again; ``SymbolBlock.imports(ctx=mx.gpu())`` of the bf16 pair gives
    the source block's predict-mode logits bit for bit with K1 12
    launches a forward, and so do ``simple_bind`` + an ``Executor``
    forward, a ``Predictor`` (eager, capture, a replay) and its
    self-contained file, and ``amp.convert_model`` of the f32 pair to
    bf16; ``viz.print_summary`` counts ``collect_params()``'s elements.
    Then the imported block, hybridized, takes ``SYM_GPT_STEPS`` AdamW
    ``fused_step``s (one capture, K1-K3 12 each a step), bit for bit with
    the source block's from the same weights."""
    import contextlib
    import io
    import math

    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon import fused_step as fsm

    gpu = mx.gpu(0)
    d = _sym_dir()
    L = cfg.num_layers
    mx.random.seed(0)
    net = _hf_gpt(mx, L, 0.0, "float32", gpu, seed=0)
    tok, pos, lab = _hf_batch(mx, HF_B, gpu)
    net(tok, pos)
    p32 = os.path.join(d, "gpt2_f32")
    net.export(p32)
    net.cast("bfloat16")
    ref = net(tok, pos)._data.clone()
    p16 = os.path.join(d, "gpt2")
    t0 = time.perf_counter()
    sym = net.export(p16)
    export_s = time.perf_counter() - t0
    blk = gluon.SymbolBlock.imports(p16 + "-symbol.json", ["data0", "data1"],
                                    p16 + "-0000.params", ctx=gpu)
    _reset_attention_counts()
    before = _port_counts()
    got = blk(tok, pos)._data.clone()
    fwd_launches = _count_delta(before)
    imported_equal = bool(torch.equal(got, ref))

    ex = sym.simple_bind(ctx=gpu, grad_req="null", data0=tuple(tok.shape),
                         data1=tuple(pos.shape))
    args16, aux16 = mx.model.load_params(p16, 0, ctx=gpu)
    ex.copy_params_from(args16, aux16)
    exec_equal = bool(torch.equal(
        ex.forward(is_train=False, data0=tok, data1=pos)[0]._data, ref))
    del ex
    shapes = {"data0": tuple(tok.shape), "data1": tuple(pos.shape)}
    pred = mx.predictor.Predictor(p16 + "-symbol.json", p16 + "-0000.params",
                                  shapes, ctx=gpu)
    pred_equal = [bool(torch.equal(pred.forward(data0=tok, data1=pos)[0]
                                   ._data, ref)) for _ in range(3)]
    replays = pred.replays
    artifact = os.path.join(d, "gpt2.predictor")
    pred.export_compiled(artifact)
    del pred
    run = mx.predictor.Predictor.load_compiled(artifact, ctx=gpu)
    file_equal = [bool(torch.equal(run(tok, pos)[0]._data, ref))
                  for _ in range(2)]
    del run
    torch.cuda.empty_cache()
    with contextlib.redirect_stdout(io.StringIO()) as table:
        total = mx.viz.print_summary(sym, shape=shapes)
    elements = sum(p.data().size for p in net.collect_params().values())
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "phase27_summary.txt"),
              "w") as fh:
        fh.write(table.getvalue())
    s32, a32, x32 = mx.model.load_checkpoint(p32, 0, ctx=gpu)
    s16, a16, x16 = mx.amp.convert_model(s32, a32, x32,
                                         target_dtype="bfloat16")
    conv = gluon.SymbolBlock(s16, ["data0", "data1"], params=a16)
    convert_equal = bool(torch.equal(conv(tok, pos)._data, ref))
    del conv, a32, x32, a16, x16
    torch.cuda.empty_cache()

    # training: the imported block and the source block, from the same
    # weights, the same AdamW fused steps
    loss_l = gluon.loss.SoftmaxCrossEntropyLoss()
    runs = {}
    for what, block in (("imported", blk), ("source", net)):
        block.hybridize()
        trainer = gluon.Trainer(block.collect_params(), "adamw",
                                dict(ADAMW_OPT))
        fsm.reset_step_counters()
        _reset_attention_counts()
        losses = []

        def loss_fn(t, p, y, block=block):
            return loss_l(block(t, p), y)

        step_ms = []
        for _ in range(SYM_GPT_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(trainer.fused_step(loss_fn, tok, pos, lab)
                          ._data.float().mean())
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        runs[what] = dict(
            losses=[float(v) for v in losses], step_ms=step_ms,
            launches=_fused_attention_launches(trainer),
            compiles=fsm.step_counters["compiles"],
            weights={nm: p.data()._data for nm, p in
                     block.collect_params().items()})
        del trainer
    imp, src = runs["imported"], runs["source"]
    w_diff = [nm for nm in src["weights"]
              if not torch.equal(src["weights"][nm], imp["weights"][nm])]
    print(f"27.2 export: the user's hybrid_forward GPT-2 small ({L} layers, "
          f"bf16, dropout 0) at {HF_B} x {HF_T}, {len(sym.get_internals())}"
          f" nodes, exported in {export_s:.2f} s; SymbolBlock.imports "
          f"logits equal the source block's bit for bit {imported_equal}, "
          f"launches a forward {fwd_launches}; simple_bind + Executor "
          f"{exec_equal}; Predictor {pred_equal} ({replays} replays), its "
          f"self-contained file {file_equal}; amp.convert_model of the f32 "
          f"pair {convert_equal}; print_summary total {total} beside "
          f"collect_params {elements} elements", flush=True)
    print(f"27.2 train: {SYM_GPT_STEPS} AdamW fused steps (eager, capture "
          f"and replay, replay), imported losses {imp['losses']} (ms each "
          f"{[round(v, 3) for v in imp['step_ms']]}, launches "
          f"{imp['launches']}, captures {imp['compiles']}), source "
          f"{src['losses']} (ms each {[round(v, 3) for v in src['step_ms']]}"
          f", launches {src['launches']}); weights differing {len(w_diff)} "
          f"of {len(src['weights'])}; {card_line()}", flush=True)
    if fwd_launches != {"flash_fwd": L}:
        fail(f"27.2: an imported forward launched {fwd_launches}, expected "
             f"K1 {L} alone")
    if not (imported_equal and exec_equal and all(pred_equal) and
            all(file_equal) and convert_equal) or replays != 2:
        fail(f"27.2: logits part from the source block's: imports "
             f"{imported_equal}, Executor {exec_equal}, Predictor "
             f"{pred_equal} ({replays} replays), file {file_equal}, "
             f"convert_model {convert_equal}")
    if total != elements:
        fail(f"27.2: print_summary counted {total}, collect_params holds "
             f"{elements}")
    for what, r in runs.items():
        if r["compiles"] != 1 or any(
                r["launches"][k] != L * SYM_GPT_STEPS for k in ATTN_KERNELS):
            fail(f"27.2 {what}: captures {r['compiles']}, launches "
                 f"{r['launches']}, expected 1 and {L} a step")
        if not all(math.isfinite(v) for v in r["losses"]):
            fail(f"27.2 {what}: losses {r['losses']}")
    if imp["losses"] != src["losses"] or w_diff:
        fail(f"27.2: the imported block's steps part from the source's: "
             f"losses {imp['losses']} vs {src['losses']}, weights "
             f"{w_diff[:5]}")
    launches = {k: imp["launches"][k] + src["launches"][k]
                for k in ATTN_KERNELS}
    launches["flash_fwd"] += fwd_launches.get("flash_fwd", 0)
    row = dict(export_s=export_s, imported_equal=imported_equal,
               forward_launches=fwd_launches, executor_equal=exec_equal,
               predictor_equal=pred_equal, predictor_replays=replays,
               file_equal=file_equal, convert_equal=convert_equal,
               summary_total=total, elements=elements,
               imported=dict(losses=imp["losses"], step_ms=imp["step_ms"],
                             launches=imp["launches"]),
               source=dict(losses=src["losses"], step_ms=src["step_ms"],
                           launches=src["launches"]),
               weights_differing=len(w_diff), launches=launches)
    del runs, imp, src, blk, net, sym
    torch.cuda.empty_cache()
    return row


def _lm_sym(mx, seq_len):
    """``sym_gen`` of the reference's form: an LSTM language model at
    ``standard_lstm_lm_650``'s widths over ``mx.sym.RNN`` (no dropout: a
    graph has no dropout op of the reference's registry)."""
    s = mx.sym
    V, H, L, N = LM_SYM_V, LM_SYM_H, LM_SYM_L, LM_SYM_N
    embed = s.Embedding(s.var("data"), s.var("embed_weight", shape=(V, H)),
                        input_dim=V, output_dim=H, name="embed")
    weights = []
    for layer in range(L):
        for part, shape in (("i2h_weight", (4 * H, H)),
                            ("h2h_weight", (4 * H, H)),
                            ("i2h_bias", (4 * H,)), ("h2h_bias", (4 * H,))):
            weights.append(s.var(f"lstm_l{layer}_{part}", shape=shape))
    rnn = s.RNN(s.transpose(embed, axes=(1, 0, 2)),
                s.var("lstm_h0", shape=(L, N, H)),
                s.var("lstm_c0", shape=(L, N, H)), *weights, mode="lstm",
                num_layers=L, name="lstm")
    pred = s.FullyConnected(s.transpose(rnn, axes=(1, 0, 2)),
                            s.var("decoder_weight"), s.var("decoder_bias"),
                            num_hidden=V, flatten=False, name="decoder")
    out = s.SoftmaxOutput(s.reshape(pred, shape=(-1, V)),
                          s.reshape(s.var("softmax_label"), shape=(-1,)),
                          name="softmax")
    return out, ("data",), ("softmax_label",)


def sym_buckets():
    """27.3: ``BucketingModule`` over sequence lengths 35 and 70 of a
    2-layer LSTM LM at 650 units and 33,278 words (``mx.sym.RNN``, the
    registry's alias of ``fused_rnn``); no kernel of the port.  The
    buckets share one set of weights (a step in one is seen by the
    other); the loss is finite; ms a step in each bucket."""
    import math

    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.io import DataBatch

    gpu = mx.gpu(0)
    mx.random.seed(0)
    N, H, L = LM_SYM_N, LM_SYM_H, LM_SYM_L
    top = max(LM_SYM_BUCKETS)
    bm = mx.mod.BucketingModule(lambda k: _lm_sym(mx, k),
                                default_bucket_key=top, context=gpu,
                                fixed_param_names=["lstm_h0", "lstm_c0"])
    bm.bind([("data", (N, top))], [("softmax_label", (N, top))])
    zeros = np.zeros((L, N, H), np.float32)
    bm.init_params(initializer=mx.init.Uniform(0.1),
                   arg_params={"lstm_h0": zeros, "lstm_c0": zeros},
                   allow_missing=True)
    bm.init_optimizer(optimizer="sgd",
                      optimizer_params=tuple(LM_SYM_OPT.items()))
    rs = np.random.RandomState(35)
    before = _port_counts()
    losses = {k: [] for k in LM_SYM_BUCKETS}
    times = {k: [] for k in LM_SYM_BUCKETS}
    seen = []
    for i in range(LM_SYM_STEPS * len(LM_SYM_BUCKETS)):
        key = LM_SYM_BUCKETS[i % len(LM_SYM_BUCKETS)]
        x = mx.nd.array(rs.randint(0, LM_SYM_V, (N, key)), ctx=gpu,
                        dtype="float32")
        y = mx.nd.array(rs.randint(0, LM_SYM_V, (N, key)), ctx=gpu,
                        dtype="float32")
        batch = DataBatch(data=[x], label=[y], bucket_key=key,
                          provide_data=[("data", (N, key))],
                          provide_label=[("softmax_label", (N, key))])
        other = [m for k, m in bm._buckets.items() if k != key]
        w_before = bm._buckets[top]._exec.arg_dict["decoder_weight"] \
            ._data.clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bm.forward(batch, is_train=True)
        bm.backward()
        bm.update()
        prob = bm.get_outputs()[0]._data
        losses[key].append(float(-prob.detach().gather(
            1, y._data.reshape(-1, 1).long()).log().mean()))
        times[key].append(time.perf_counter() - t0)
        if other:
            # the other bucket's array is this bucket's, moved by the step
            w = other[0]._exec.arg_dict["decoder_weight"]
            seen.append(bool(
                w is bm._curr_module._exec.arg_dict["decoder_weight"]
                and not torch.equal(w._data, w_before)))
    launches = _count_delta(before)
    ms = {k: sum(v[1:]) / max(1, len(v) - 1) * 1e3 for k, v in times.items()}
    print(f"27.3 buckets: BucketingModule, {L}-layer LSTM LM ({H} units, "
          f"{LM_SYM_V} words, mx.sym.RNN) at {N} x {LM_SYM_BUCKETS}, SGD "
          f"{LM_SYM_OPT}: losses {dict((k, [round(v, 4) for v in l]) for k, l in losses.items())}; "
          f"ms a step {dict((k, round(v, 3)) for k, v in ms.items())} (all "
          f"but each bucket's first); a step seen by the other bucket "
          f"{seen}; launches {launches}; {card_line()}", flush=True)
    flat = [v for l in losses.values() for v in l]
    if not all(math.isfinite(v) for v in flat):
        fail(f"27.3: losses {losses}")
    if not seen or not all(seen):
        fail(f"27.3: the buckets do not share their weights: {seen}")
    if launches:
        fail(f"27.3: launched {launches}: the path reaches no kernel")
    del bm
    torch.cuda.empty_cache()
    return dict(losses=losses, ms_per_step=ms, shared=seen)


def check_symbolic(cfg, fused_row):
    """Phase 27: 27.1-27.3, with the phase's seconds (27.4)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    resnet = sym_resnet(fused_row)
    t1 = time.perf_counter()
    gpt = sym_gpt(cfg)
    t2 = time.perf_counter()
    buckets = sym_buckets()
    secs = time.perf_counter() - t0
    print(f"phase 27: {secs:.2f} s (27.1 {t1 - t0:.2f}, 27.2 {t2 - t1:.2f}, "
          f"27.3 {time.perf_counter() - t2:.2f}); the script so far "
          f"{time.perf_counter() - T_START:.2f} s", flush=True)
    launches = dict(gpt["launches"])
    launches["conv1x1_bwd"] = resnet["launches"].get("conv1x1_bwd", 0)
    return dict(resnet=resnet, gpt=gpt, buckets=buckets, seconds=secs,
                launches=launches)


# --------------------------------------------------------------------------- #
# phase 28: the NumPy interface, the twenty-fifth slice: mx.np, mx.npx,
# mx.util, mx.runtime, the trace parser behind device_dumps(by="tf_op"),
# the training side's telemetry and contrib.quantization's quantize_net
# --------------------------------------------------------------------------- #

NP_STEPS = 6                # 28.1: SGD steps of each arm
NP_SIZE = 8                 # 28.2: the case table's scale (32 x 48 arrays)
NP_TOL, NP_LINALG_TOL, NP_NPX_TOL = 1e-6, 1e-4, 1e-5
NP_DRAWS = 20000            # 28.2: draws a distribution
TELE_CALLS = 6              # 28.3: fused_step calls, update_interval 2
TELE_PROFILE_TRIES = 3      # 28.3: windows tried until one holds K1-K3
Q_B, Q_BATCHES = 16, 4      # 28.4: calibration batches of 16 at 224^2
Q_ACC_B = 2                 # 28.4: images the accumulators are held on
Q_ENTROPY_B = 4             # 28.4: images of the entropy-mode batch
# 28.4: the quantized logits' largest error, relative to the f32 logits'
# largest magnitude, that the naive-mode int8 ResNet-50 may show (53
# convolutions and the Dense layer, per-channel int8 weights, per-tensor
# int8 activations calibrated on 4 x 16 images): 0.0153 measured on an
# NVIDIA H100 80GB HBM3 (700 W), the limit about three times that
Q_REL_ERR = 0.05


def _np_case_module():
    _tests_path()
    import _torch_np_cases
    return _torch_np_cases


def _np_host(out):
    import torch
    import mxnet_tpu_torch as mx

    if isinstance(out, mx.nd.NDArray):
        t = out._data.detach()
        a = t.float().cpu().numpy() if t.dtype == torch.bfloat16 \
            else t.cpu().numpy()
        return a, str(out.dtype).replace("torch.", ""), tuple(out.shape)
    return None


def np_resnet(gluon_row):
    """28.1: an ``mx.np`` training script.  ``npx.set_np()``, ResNet-50 v1
    NHWC bf16 from ``get_resnet(1, 50, classes=1000, layout="NHWC")``,
    hybridized, a batch of 128 x 224^2 as ``mx.np`` arrays from a seeded
    NumPy generator, ``gluon.Trainer`` (SGD, momentum 0.9), ``NP_STEPS``
    steps of ``record``/``backward``/``step(128)`` with
    ``MXNET_FUSED_CONV_BWD=1``, the accuracy ``mx.np.mean(mx.np.argmax(
    out, axis=1) == y)``.  K6 exactly 30 launches a step and no other
    kernel; every output, loss and gradient an ``mx.np.ndarray``; losses
    and every weight bit for bit with the same steps from the same
    weights fed ``mx.nd`` arrays without ``set_np`` (cuDNN deterministic
    in both arms).  ms a step beside phase 16's eager step."""
    import math

    import numpy as onp
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_resnet
    from mxnet_tpu_torch.ops import conv_fused as cf

    os.environ["MXNET_FUSED_CONV_BWD"] = "1"
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    gpu = mx.gpu(0)
    mx.random.seed(0)
    net = get_resnet(1, 50, classes=1000, layout="NHWC")
    net.initialize(mx.init.Xavier(rnd_type="uniform", factor_type="avg",
                                  magnitude=3), ctx=gpu)
    net.cast("bfloat16")
    net.hybridize()
    rs = onp.random.RandomState(28)
    data = rs.standard_normal((RESNET_B, 224, 224, 3)).astype(onp.float32)
    label = rs.randint(0, 1000, RESNET_B).astype(onp.int32)
    mx.npx.set_np()
    x = mx.np.array(data, dtype="bfloat16", ctx=gpu)
    y = mx.np.array(label, ctx=gpu)
    net(x)                                  # the deferred shapes
    params = net.collect_params()
    init = {k: p._data._data.detach().clone() for k, p in params.items()}
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

    def arm(xs, ys, np_mode):
        (mx.npx.set_np if np_mode else mx.npx.reset_np)()
        with torch.no_grad():
            for k, p in params.items():
                p._data._data.copy_(init[k])
        trainer = gluon.Trainer(params, "sgd", dict(RESNET_OPT))
        trainable = [p for p in params.values() if p.grad_req != "null"]
        losses, step_ms, acc_us, classes, accs = [], [], [], set(), []
        torch.cuda.synchronize()
        before = _port_counts()
        cf.conv1x1_bwd_pair.launches = 0
        for _ in range(NP_STEPS):
            t0 = time.perf_counter()
            with autograd.record():
                out = net(xs)
                loss = loss_fn(out, ys)
            loss.backward()
            trainer.step(RESNET_B)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if np_mode:
                t0 = time.perf_counter()
                acc = mx.np.mean(mx.np.argmax(out, axis=1) == ys)
                acc_us.append((time.perf_counter() - t0) * 1e6)
                accs.append(float(acc))
                classes |= {type(out).__name__, type(loss).__name__,
                            type(acc).__name__}
                classes |= {type(p.grad()).__name__ for p in trainable}
            losses.append(float(loss._data.float().mean()))
        launches = _count_delta(before)
        launches["conv1x1_bwd"] = cf.conv1x1_bwd_pair.launches
        weights = [p._data._data.detach().clone() for p in params.values()]
        parts = {}
        if np_mode:
            # the accuracy's host us at steady state, and its three ops
            am = mx.np.argmax(out, axis=1)
            eq = am == ys
            parts = dict(
                all=host_us(lambda: mx.np.mean(mx.np.argmax(
                    out, axis=1) == ys), iters=50),
                argmax=host_us(lambda: mx.np.argmax(out, axis=1), iters=50),
                equal=host_us(lambda: am == ys, iters=50),
                mean=host_us(lambda: mx.np.mean(eq), iters=50))
        del trainer
        return dict(losses=losses, step_ms=step_ms, acc_us=acc_us,
                    accs=accs, classes=sorted(classes), launches=launches,
                    weights=weights, acc_parts=parts)

    try:
        a = arm(x, y, True)
        b = arm(x.as_nd_ndarray(), y.as_nd_ndarray(), False)
    finally:
        mx.npx.reset_np()
        torch.backends.cudnn.deterministic = deterministic
    equal = [bool(torch.equal(u, v)) for u, v in zip(a["weights"],
                                                     b["weights"])]
    ms = sum(a["step_ms"][1:]) / (NP_STEPS - 1)
    ms_nd = sum(b["step_ms"][1:]) / (NP_STEPS - 1)
    acc_us = sorted(a["acc_us"][1:])[(NP_STEPS - 1) // 2]
    print(f"28.1 np resnet: resnet50_v1 NHWC bf16 under npx.set_np(), "
          f"B={RESNET_B} 224x224 mx.np arrays, {NP_STEPS} SGD steps; losses "
          f"{a['losses']}; classes {a['classes']}; accuracy "
          f"{a['accs']} ({acc_us:.1f} host us in the loop, median; at "
          f"steady state {a['acc_parts']}); launches {a['launches']}",
          flush=True)
    print(f"28.1 np resnet: ms/step {ms:.3f} (steps 2-{NP_STEPS}, cuDNN "
          f"deterministic) beside the mx.nd arm {ms_nd:.3f} and phase 16's "
          f"eager gluon step {gluon_row['ms_per_step']:.3f}; mx.nd arm "
          f"losses equal bit for bit {a['losses'] == b['losses']}, weights "
          f"equal {sum(equal)} of {len(equal)}; {card_line()}", flush=True)
    expect = K6_PER_STEP * NP_STEPS
    for what, r in (("np", a), ("nd", b)):
        other = {k: n for k, n in r["launches"].items()
                 if k != "conv1x1_bwd" and n}
        if r["launches"]["conv1x1_bwd"] != expect or other:
            fail(f"28.1 {what} arm: launches {r['launches']}, expected K6 "
                 f"{expect} alone")
        if not all(math.isfinite(v) for v in r["losses"]):
            fail(f"28.1 {what} arm: losses {r['losses']}")
    if a["classes"] != ["ndarray"]:
        fail(f"28.1: outputs, losses and gradients of classes "
             f"{a['classes']}, expected mx.np.ndarray alone")
    if a["losses"] != b["losses"] or not all(equal):
        fail(f"28.1: the mx.np steps part from the mx.nd steps: losses "
             f"{a['losses']} vs {b['losses']}, weights equal "
             f"{sum(equal)} of {len(equal)}")
    if abs(a["losses"][0] - math.log(1000)) > 1.0:
        fail(f"28.1: first loss {a['losses'][0]} not within 1.0 of ln 1000")
    row = dict(losses=a["losses"], nd_losses=b["losses"], ms_per_step=ms,
               nd_ms_per_step=ms_nd, gluon_ms_per_step=gluon_row[
                   "ms_per_step"], accuracy_host_us=acc_us,
               accuracy=a["accs"], classes=a["classes"],
               launches=a["launches"], nd_launches=b["launches"],
               weights_equal=sum(equal), weights=len(equal))
    del a, b, net, init, x, y
    torch.cuda.empty_cache()
    return row


def _np_run(mod, case, ctx):
    import torch
    import mxnet_tpu_torch as mx

    with ctx:
        return mod.flatten(mod.call(
            mx, case, lambda v: mx.np.array(v, ctx=ctx),
            lambda n: getattr(torch, n)), _np_host)


def _npx_extras(mx, ctx):
    """The ``npx`` names the case table leaves out, on ``ctx``: control
    flow, the fused RNN, SSD's detection (``box_nms``), save/load and the
    switches; NumPy results to hold the card against the CPU."""
    import numpy as onp

    rs = onp.random.RandomState(5)
    out = {}
    with ctx:
        arr = lambda v: mx.np.array(v, ctx=ctx)  # noqa: E731
        data = arr(rs.standard_normal((6, 32)).astype(onp.float32))
        outs, st = mx.npx.foreach(lambda xx, s: (xx * 2 + s[0], [s[0] + xx]),
                                  data, [arr(onp.zeros(32, onp.float32))])
        out["foreach"] = [outs.asnumpy(), st[0].asnumpy()]
        out["while_loop"] = [v.asnumpy() for v in mx.npx.while_loop(
            lambda vs: vs[0] < 100.0, lambda vs: [vs[0] * 3, vs[1] + 1],
            [arr(onp.asarray(1.0, onp.float32)), data], max_iterations=8)]
        out["cond"] = [v.asnumpy() for v in mx.npx.cond(
            arr(onp.asarray(True)), lambda vs: [vs[0] + 1],
            lambda vs: [vs[0] - 1], [data])]
        cls = rs.rand(2, 4, 64).astype(onp.float32)
        cls /= cls.sum(1, keepdims=True)
        anchors = onp.sort(rs.rand(1, 64, 4).astype(onp.float32), axis=-1)
        out["multibox_detection"] = [mx.npx.multibox_detection(
            arr(cls), arr((rs.randn(2, 256) * 0.1).astype(onp.float32)),
            arr(anchors)).asnumpy()]
        H, I = 16, 8
        w = lambda *s: arr((rs.standard_normal(s) * 0.1)  # noqa: E731
                           .astype(onp.float32))
        out["rnn"] = [v.asnumpy() for v in mx.npx.rnn(
            w(5, 3, I), arr(onp.zeros((1, 3, H), onp.float32)),
            arr(onp.zeros((1, 3, H), onp.float32)), w(4 * H, I),
            w(4 * H, H), w(4 * H), w(4 * H), mode="lstm")]
        path = os.path.join(HERE, "build", f"npx_{ctx.device_type}.nd")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        mx.npx.save(path, {"d": data})
        back = mx.npx.load(path)["d"]
        os.remove(path)
        out["save_load"] = [back.asnumpy()]
        mx.npx.seed(3)
        x = arr(onp.arange(40, dtype=onp.float32))
        out["shuffle"] = [mx.npx.shuffle(x).asnumpy()]
        mx.npx.seed(3)
        out["multinomial"] = [mx.npx.multinomial(
            arr(onp.asarray([0.2, 0.3, 0.5], onp.float32)),
            shape=(64,)).asnumpy().sum(-1)]
        mx.npx.waitall()
        mx.npx.set_np()
        ok = mx.npx.is_np_array() and mx.npx.is_np_shape()
        mx.npx.reset_np()
        out["switches"] = [onp.asarray([ok, mx.npx.is_np_array(),
                                        mx.npx.num_gpus() >= 0])]
    return out


def np_surface():
    """28.2: every function of ``mx.np``, ``mx.np.linalg`` and ``mx.npx``
    (``tests/_torch_np_cases.py`` at ``NP_SIZE``: arrays of 32 x 48, plus
    the ``npx`` names the table leaves out) on ``cuda:0`` and on the CPU:
    dtypes and shapes equal, integers and booleans exact, floats within
    ``NP_TOL`` of the largest magnitude (``np.linalg`` ``NP_LINALG_TOL``,
    factorisations by reconstruction; ``npx`` ``NP_NPX_TOL``: cuDNN's
    convolutions and the norms sum in their own order).  ``mx.np.random``'s
    draws by support and moments on the card, the integer draws equal on
    the card and the CPU from one seed.  Host us of ``mx.np.add`` beside
    ``torch.add``."""
    import numpy as onp
    import torch
    import mxnet_tpu_torch as mx

    mod = _np_case_module()
    gpu, cpu = mx.gpu(0), mx.cpu()
    worst = {"np": 0.0, "linalg": 0.0, "npx": 0.0}
    bad, names = [], set()
    t0 = time.perf_counter()
    for case in mod.cases(NP_SIZE):
        kind = "linalg" if ".linalg." in case[1] else (
            "npx" if case[1].startswith("npx.") else "np")
        tol = {"np": NP_TOL, "linalg": NP_LINALG_TOL, "npx": NP_NPX_TOL}[kind]
        try:
            ref = _np_run(mod, case, cpu)
            got = _np_run(mod, case, gpu)
            ok, err, msg = mod.compare(case, ref, got, tol)
        except Exception as e:      # reported with the case, then failed
            ok, err, msg = False, None, f"{type(e).__name__}: {e}"
        names.add(case[1])
        if err is not None:
            worst[kind] = max(worst[kind], err)
        if not ok:
            bad.append((case[0], msg))
    extras_cpu = _npx_extras(mx, cpu)
    extras_gpu = _npx_extras(mx, gpu)
    for k in extras_cpu:
        names.add(f"npx.{k}")
        for a, b in zip(extras_cpu[k], extras_gpu[k]):
            a, b = onp.asarray(a), onp.asarray(b)
            scale = max(float(onp.abs(a).max()), 1e-30) if a.size else 1.0
            if a.shape != b.shape or a.dtype != b.dtype or (
                    a.size and float(onp.abs(a.astype(onp.float64) -
                                             b.astype(onp.float64)).max())
                    > NP_NPX_TOL * scale):
                bad.append((f"npx.{k}", f"card {b.shape} {b.dtype} vs CPU "
                            f"{a.shape} {a.dtype}"))
    cases_s = time.perf_counter() - t0
    # mx.np.random on the card: moments; integer draws card = CPU
    rbad = []
    for name, draw, mean, var, lo, hi, dtype in mod.random_cases(NP_DRAWS):
        mx.np.random.seed(11)
        with gpu:
            out = draw(mx.np.random)
        ok, msg = mod.moments_ok(out.asnumpy(), mean, var, lo, hi)
        if not ok or str(out.dtype) != dtype or out.shape != (NP_DRAWS,) \
                or out._data.device.type != "cuda":
            rbad.append((name, msg, str(out.dtype)))
        names.add(f"np.random.{name}")
    ints = {}
    for ctx in (cpu, gpu):
        mx.np.random.seed(5)
        with ctx:
            r = mx.np.random
            x = mx.np.array(onp.arange(64, dtype=onp.float32), ctx=ctx)
            r.shuffle(x)
            ints[ctx.device_type] = [
                r.randint(0, 1000, size=(4096,)).asnumpy(),
                r.choice(50, size=(4096,)).asnumpy(),
                r.choice(100, size=(40,), replace=False).asnumpy(),
                r.permutation(4096).asnumpy(), x.asnumpy()]
    ints_equal = all(onp.array_equal(a, b) for a, b in
                     zip(ints["cpu"], ints["gpu"]))
    names |= {"np.random.shuffle", "np.random.choice",
              "np.random.permutation", "np.random.multivariate_normal",
              "np.random.multinomial", "np.random.seed"}
    with gpu:
        mv = mx.np.random.multivariate_normal(
            mx.np.array([1.0, -1.0]), mx.np.array([[2.0, 0.5], [0.5, 1.0]]),
            size=(NP_DRAWS,)).asnumpy()
        mn = mx.np.random.multinomial(10, mx.np.array([0.2, 0.3, 0.5]),
                                      size=(NP_DRAWS,)).asnumpy()
    if float(onp.abs(onp.cov(mv.T) - [[2.0, 0.5], [0.5, 1.0]]).max()) > 0.08 \
            or not (mn.sum(1) == 10).all():
        rbad.append(("multivariate_normal/multinomial", "moments", ""))
    a = mx.np.array(onp.ones((64, 64), onp.float32), ctx=gpu)
    ta = a._data
    np_add_us = host_us(lambda: mx.np.add(a, a))
    torch_add_us = host_us(lambda: torch.add(ta, ta))
    n_np = len([n for n in names if n.startswith("np.") and
                not n.startswith(("np.linalg.", "np.random."))])
    n_la = len([n for n in names if n.startswith("np.linalg.")])
    n_npx = len([n for n in names if n.startswith("npx.")])
    n_rand = len([n for n in names if n.startswith("np.random.")])
    print(f"28.2 np surface: {len(names)} names run on cuda:0 and the CPU "
          f"({n_np} mx.np, {n_la} np.linalg, {n_npx} npx, {n_rand} "
          f"np.random) in {cases_s:.2f} s; worst error of the largest "
          f"magnitude: np {worst['np']:.3g} (tol {NP_TOL}), linalg "
          f"{worst['linalg']:.3g} (tol {NP_LINALG_TOL}), npx "
          f"{worst['npx']:.3g} (tol {NP_NPX_TOL}); integer draws equal on "
          f"the card and the CPU {ints_equal}; host us mx.np.add "
          f"{np_add_us:.2f} beside torch.add {torch_add_us:.2f}; "
          f"{card_line()}", flush=True)
    if bad or rbad or not ints_equal:
        fail(f"28.2: {len(bad)} cases disagree {bad[:8]}; draws {rbad[:5]};"
             f" integer draws equal {ints_equal}")
    return dict(names=len(names), np_names=n_np, linalg_names=n_la,
                npx_names=n_npx, random_names=n_rand, worst=worst,
                seconds=cases_s, np_add_us=np_add_us,
                torch_add_us=torch_add_us, ints_equal=ints_equal)


def _fs_tele():
    from mxnet_tpu_torch import telemetry as t

    return {"micro": t.histogram("fused_step_seconds", phase="micro").count,
            "apply": t.histogram("fused_step_seconds", phase="apply").count,
            "d_micro": t.counter("fused_step_dispatches_total",
                                 phase="micro").value,
            "d_apply": t.counter("fused_step_dispatches_total",
                                 phase="apply").value,
            "d_legacy": t.counter("fused_step_dispatches_total",
                                  phase="legacy").value,
            "cached_op": t.counter("compiles_total",
                                   site="gluon.cached_op").value,
            "fused": t.counter("compiles_total",
                               site="gluon.fused_step").value}


def _programs_launches(before, progs):
    """K1-K3's launches since ``before`` (``_attention_counts``) through
    ``progs``: the eager calls by the counts, each replay by what its
    capture recorded (the captures' own launches taken out)."""
    now = _attention_counts()
    return {n: now[n] - before[n]
            - sum(p.recorded.get(n, 0) for p in progs)
            + sum(p.launches.get(n, 0) * p.replays for p in progs)
            for n in ATTN_KERNELS}


def _kernel_of(name):
    for k, pat in (("flash_fwd", "flash_fwd"), ("flash_bwd_dq",
                                                "flash_bwd_dq"),
                   ("flash_bwd_dkv", "flash_bwd_dkv")):
        if pat in name:
            return k
    return None


def train_telemetry(cfg):
    """28.3: the training side's telemetry and the trace parser over the
    user's ``hybrid_forward`` GPT-2 small (12 layers, 768 wide, 12 heads,
    50,257 tokens, bf16, dropout 0) at 8 x 1024, hybridized: two
    predict-mode forwards (the program's eager call, its capture and
    replay: ``compiles_total{site="gluon.cached_op"}`` +1), then
    ``TELE_CALLS`` AdamW ``Trainer.fused_step`` calls at
    ``update_interval=2`` (3 micro, 3 apply: three AdamW steps).  The
    ledger's ``train.params`` and ``train.opt_states`` equal the
    parameters' and the states' bytes, ``train.grad_accum`` the ring's;
    the histograms and counters count as the reference's; a profiled
    window of two replays (micro, apply) and one phase-by-phase step
    (``MXNET_FUSED_STEP=0``) gives ``device_dumps()`` (``by="tf_op"``)
    with 12 K1 and 24 K2 + K3 under ``flash_attention`` and the micro
    replay's kernels under ``mx:fused_step:micro`` (up to
    ``TELE_PROFILE_TRIES`` windows, the attempt printed beside the gate
    and kept in the row), and ``by="name"`` keeps K1-K3's names;
    ``profile_fn`` over the replayed step; ``hlo_op_count`` of a fresh
    capture of the micro program's function equals the compile event's
    kernel nodes; ``reconcile()`` while the trainer is accounted covers
    its bytes with no negative delta; ``release_accounting()`` takes the
    ``train.*`` bytes to 0 and ``reconcile()`` shows no leak."""
    import math

    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, profiler, telemetry
    from mxnet_tpu_torch import profiler_trace as pt
    from mxnet_tpu_torch.gluon import fused_step as fsm
    from mxnet_tpu_torch.telemetry.memory import ACCOUNTANT, nbytes_of

    gpu = mx.gpu(0)
    L = cfg.num_layers
    mx.random.seed(0)
    net = _hf_gpt(mx, L, 0.0, "bfloat16", gpu, seed=0)
    tok, pos, lab = _hf_batch(mx, HF_B, gpu)
    net.hybridize()
    tele0 = _fs_tele()
    att0 = _attention_counts()
    net(tok, pos)
    net(tok, pos)
    fwd_progs = [p for p in net._cached_op._programs.values()
                 if p is not None]
    cached_compiles = _fs_tele()["cached_op"] - tele0["cached_op"]
    fwd_events = [e for e in telemetry.events("compile")
                  if e.get("site") == "gluon.cached_op"]
    loss_l = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "adamw", dict(ADAMW_OPT),
                            update_interval=2)

    def loss_fn(t, p, y):
        return loss_l(net(t, p), y)

    fsm.reset_step_counters()
    losses, call_ms = [], []
    for _ in range(TELE_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(trainer.fused_step(loss_fn, tok, pos, lab)
                            ._data.float().mean()))
        torch.cuda.synchronize()
        call_ms.append((time.perf_counter() - t0) * 1e3)
    d = {k: v - tele0[k] for k, v in _fs_tele().items()}
    (fs,) = trainer._fused_steps.values()
    progs = {k[0]: p for k, p in fs._programs.items()}
    label = trainer._mem_label
    params = list(net.collect_params().values())
    p_bytes = sum(p._data._data.nbytes for p in params)
    s_bytes = nbytes_of([s for s, made in zip(trainer._states,
                                              trainer._states_created)
                         if made])
    ring_key = fs._accum_key
    ledger = {"train.params": ACCOUNTANT.bytes("train.params", key=label),
              "train.opt_states": ACCOUNTANT.bytes("train.opt_states",
                                                   key=label),
              "train.grad_accum": ACCOUNTANT.bytes("train.grad_accum",
                                                   key=ring_key)}
    gauge = telemetry.gauge("device_bytes", subsystem="train.params",
                            device="cuda:0").value
    ring_bytes = nbytes_of(fs._accum)
    print(f"28.3 telemetry: user's GPT-2 small ({L} layers, bf16, dropout 0)"
          f" at {HF_B} x {HF_T}, hybridized, {TELE_CALLS} AdamW fused_step "
          f"calls at update_interval 2: losses {losses}, ms each "
          f"{[round(v, 3) for v in call_ms]}; fused_step_seconds micro "
          f"+{d['micro']} apply +{d['apply']}, dispatches micro "
          f"+{d['d_micro']} apply +{d['d_apply']} legacy +{d['d_legacy']}; "
          f"compiles_total gluon.cached_op +{cached_compiles} (kernel nodes "
          f"{[e.get('kernel_nodes') for e in fwd_events[-1:]]}), "
          f"gluon.fused_step +{d['fused']}; ledger {ledger} beside "
          f"parameters {p_bytes}, AdamW states {s_bytes}, ring "
          f"{ring_bytes} (device_bytes gauge {gauge})", flush=True)
    if d["micro"] != 3 or d["apply"] != 3 or d["d_micro"] != 3 or \
            d["d_apply"] != 3 or d["d_legacy"] != 0 or d["fused"] != 2:
        fail(f"28.3: fused step instruments {d}, expected 3 micro, 3 apply,"
             " 0 legacy, 2 compiles")
    if cached_compiles != 1 or len(fwd_progs) != 1:
        fail(f"28.3: the forward program compiled {cached_compiles} times "
             f"({len(fwd_progs)} programs), expected 1")
    if ledger != {"train.params": p_bytes, "train.opt_states": s_bytes,
                  "train.grad_accum": ring_bytes} or gauge < p_bytes:
        fail(f"28.3: ledger {ledger}, expected params {p_bytes}, states "
             f"{s_bytes}, ring {ring_bytes} (gauge {gauge})")
    if not all(math.isfinite(v) for v in losses):
        fail(f"28.3: losses {losses}")

    # the profiled window: two replays (micro, apply) and one step
    # phase by phase (the window's first micro-batch)
    profiler.set_config(aggregate_stats=True)
    found = None
    for attempt in range(TELE_PROFILE_TRIES):
        torch.cuda.synchronize()
        profiler.start()
        trainer.fused_step(loss_fn, tok, pos, lab)      # micro replay
        trainer.fused_step(loss_fn, tok, pos, lab)      # apply replay
        os.environ["MXNET_FUSED_STEP"] = "0"
        try:
            before = _attention_counts()
            trainer.fused_step(loss_fn, tok, pos, lab)  # phase by phase
            eager = {n: v - before[n]
                     for n, v in _attention_counts().items()}
        finally:
            os.environ.pop("MXNET_FUSED_STEP")
        torch.cuda.synchronize()
        profiler.stop()
        recs = profiler.device_records()
        flash = {}
        for r in recs:
            k = _kernel_of(r["name"])
            if k is not None:
                flash.setdefault(r["tf_op"], {}).setdefault(k, 0)
                flash[r["tf_op"]][k] += 1
        under = flash.get("flash_attention", {})
        # the graph's kernel nodes (its memset and copy nodes, and the
        # annotation's input copies and output clones, are not kernels)
        micro = [r for r in recs if r["tf_op"] == "mx:fused_step:micro"
                 and not r["name"].startswith(("Memcpy", "Memset"))]
        found = dict(attempt=attempt + 1, eager=eager, flash=flash,
                     micro_kernels=len(micro), records=len(recs))
        if under.get("flash_fwd") == L and under.get(
                "flash_bwd_dq", 0) + under.get("flash_bwd_dkv", 0) == 2 * L:
            break
        print(f"28.3 profile attempt {attempt + 1} of {TELE_PROFILE_TRIES}:"
              f" kernels by tf_op {flash} short of the launches {eager}",
              flush=True)
        # the trainer is mid-window now; finish it
        trainer.fused_step(loss_fn, tok, pos, lab)
    by_tf_op = profiler.device_dumps(limit=12)
    by_source = profiler.device_dumps(by="source", limit=8)
    by_name = profiler.device_dumps(by="name", limit=8)
    by_name_all = profiler.device_dumps(by="name", limit=1000)
    by_category = profiler.device_dumps(by="category")
    micro_nodes = sum(progs["micro"].kernel_nodes().values())
    print(f"28.3 profile (attempt {found['attempt']} of "
          f"{TELE_PROFILE_TRIES}): {found['records']} "
          f"device records; flash kernels by tf_op {found['flash']} (the "
          f"phase-by-phase step launched {found['eager']}); "
          f"mx:fused_step:micro holds {found['micro_kernels']} kernels "
          f"beside the micro graph's {micro_nodes} kernel nodes (not gated:"
          f" PERF.md section 7)\nby tf_op:\n{by_tf_op}\n"
          f"by source:\n{by_source}\nby name:\n{by_name}\nby category:\n"
          f"{by_category}", flush=True)
    under = found["flash"].get("flash_attention", {})
    replayed = found["flash"].get("mx:fused_step:micro", {})
    if under.get("flash_fwd") != L or under.get("flash_bwd_dq", 0) + \
            under.get("flash_bwd_dkv", 0) != 2 * L:
        fail(f"28.3 device_dumps (attempt {found['attempt']} of "
             f"{TELE_PROFILE_TRIES}): flash_attention holds {under}, "
             f"expected K1 {L} and K2 + K3 {2 * L} of the step's "
             f"{found['eager']}")
    missing = [k for k in ("flash_fwd_mma_kernel<", "flash_bwd_dq_mma_kernel<",
                           "flash_bwd_dkv_mma_kernel<")
               if k not in by_name_all]
    if missing:
        fail(f"28.3 device_dumps(by='name') cuts the kernel names {missing}")
    if not replayed or set(found["flash"]) - {
            "flash_attention", "mx:fused_step:micro",
            "mx:fused_step:apply"}:
        fail(f"28.3 device_dumps: the replays' flash kernels by tf_op "
             f"{found['flash']}")
    if "_torch_hybrid_models.py:" not in by_source:
        fail("28.3 device_dumps(by='source') names no line of the model "
             "file")
    # profile_fn over the replayed step, hlo_op_count of the program
    rows = pt.aggregate(pt.profile_fn(
        lambda: trainer.fused_step(loss_fn, tok, pos, lab), iters=2),
        by="tf_op")
    # a fresh capture of the micro program's function (its warm-up call
    # adds one more gradient into the ring: nothing reads it after)
    launches = _programs_launches(att0, fwd_progs + list(
        fs._programs.values()))
    hlo = pt.hlo_op_count(progs["micro"].fn)
    ev = [e for e in telemetry.events("compile")
          if e.get("site") == "gluon.fused_step" and
          e.get("phase") == "micro"]
    watch_nodes = ev[-1]["kernel_nodes"] if ev else None
    print(f"28.3 profile_fn over the replayed step (per call):\n"
          f"{pt.format_table(rows, limit=6)}\n28.3 hlo_op_count(micro "
          f"step function, a fresh capture) {hlo}, the compile watch's "
          f"kernel_nodes {watch_nodes}", flush=True)
    if not rows or hlo != watch_nodes:
        fail(f"28.3: profile_fn rows {len(rows)}, hlo_op_count {hlo}, "
             f"watch {watch_nodes}")
    held = telemetry.memory.reconcile().get("cuda:0", {})
    trainer.release_accounting()
    after = {s: ACCOUNTANT.bytes(s, key=label) for s in (
        "train.params", "train.opt_states")}
    after["train.grad_accum"] = ACCOUNTANT.bytes("train.grad_accum",
                                                 key=ring_key)
    rec = telemetry.memory.reconcile().get("cuda:0", {})
    print(f"28.3 reconcile while the trainer is accounted {held}; "
          f"release_accounting: ledger {after}; reconcile {rec}; "
          f"launches K1-K3 {launches}", flush=True)
    if held.get("delta", -1) < 0 or not held.get("coverage") or \
            held.get("accounted", 0) < sum(ledger.values()):
        fail(f"28.3: reconcile with train.* accounted {held}, ledger "
             f"{ledger}")
    if any(after.values()) or rec.get("delta", -1) < 0:
        fail(f"28.3: after release_accounting {after}, reconcile {rec}")
    row = dict(losses=losses, call_ms=call_ms, instruments=d,
               cached_op_compiles=cached_compiles, ledger=ledger,
               param_bytes=p_bytes, state_bytes=s_bytes,
               ring_bytes=ring_bytes, profile=found,
               profile_attempts=found["attempt"], hlo_op_count=hlo,
               watch_nodes=watch_nodes, launches=launches,
               reconcile_held=held, released=after, reconcile=rec,
               profile_fn=rows[:6], by_tf_op=by_tf_op)
    del trainer, fs, progs, net, fwd_progs
    torch.cuda.empty_cache()
    return row


def _quantized(net, cls):
    out = []

    def walk(b):
        for c in b._children.values():
            if isinstance(c, cls):
                out.append(c)
            walk(c)
    walk(net)
    return out


def quantize_resnet():
    """28.4: ``quantize_net`` on ResNet-50 v1 NCHW f32 from the zoo,
    seeded weights, naive calibration on ``Q_BATCHES`` seeded batches of
    ``Q_B`` at 224^2: all 53 convolutions and the Dense layer replaced;
    every ``QuantizedConv2D``'s int32 accumulator on the card equals the
    CPU's product of the same int8 operands exactly (a batch of
    ``Q_ACC_B``); the quantized logits within ``Q_REL_ERR`` of the f32
    logits' largest magnitude; entropy mode on one batch; ms a quantized
    forward beside the f32 forward."""
    import math

    import numpy as onp
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.contrib import quantization as q
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_resnet
    from mxnet_tpu_torch.ops.quantization import (quantize_v2,
                                                  quantized_conv_int8)

    gpu = mx.gpu(0)

    def fresh():
        mx.random.seed(28)
        n = get_resnet(1, 50, classes=1000)
        n.initialize(mx.init.Xavier(magnitude=2), ctx=gpu)
        return n

    rs = onp.random.RandomState(30)
    xs = [mx.nd.array(rs.standard_normal((Q_B, 3, 224, 224))
                      .astype(onp.float32), ctx=gpu)
          for _ in range(Q_BATCHES)]
    net = fresh()
    f32 = net(xs[0])._data.clone()
    f32_ms = cuda_ms(lambda i: net(xs[0]), 5, warm=1)
    t0 = time.perf_counter()
    q.quantize_net(net, calib_data=xs, calib_mode="naive",
                   num_calib_batches=Q_BATCHES)
    calib_s = time.perf_counter() - t0
    convs = _quantized(net, q.QuantizedConv2D)
    dense = _quantized(net, q.QuantizedDense)
    left = [c for c in _quantized(net, (mx.gluon.nn.Conv2D,
                                        mx.gluon.nn.Dense))]
    got = net(xs[0])._data
    rel = float((got - f32).abs().max() / f32.abs().max())
    top1 = float((got.argmax(1) == f32.argmax(1)).float().mean())
    q_ms = cuda_ms(lambda i: net(xs[0]), 5, warm=1)
    # the accumulators: each layer's input read by a pre-hook, quantized as
    # the layer does, its int8 product on the card against the CPU's
    acc_equal = []

    def check(layer, args):
        x = args[0]._data if isinstance(args[0], mx.nd.NDArray) else args[0]
        qx = quantize_v2(x, min_calib_range=-layer._x_amax,
                         max_calib_range=layer._x_amax)[0]
        kw = dict(stride=layer._stride, pad=layer._pad,
                  dilate=layer._dilate, num_group=layer._groups)
        card = quantized_conv_int8(qx, layer._qweight._data, **kw)
        host = quantized_conv_int8(qx.cpu(), layer._qweight._data.cpu(),
                                   **kw)
        acc_equal.append(bool(torch.equal(card.cpu(), host)))

    hooks = [c.register_forward_pre_hook(check) for c in convs]
    try:
        net(mx.nd.array(xs[0]._data[:Q_ACC_B], ctx=gpu))
    finally:
        for h in hooks:
            h.detach()
    del net
    torch.cuda.empty_cache()
    ent = fresh()
    t0 = time.perf_counter()
    q.quantize_net(ent, calib_data=[mx.nd.array(xs[0]._data[:Q_ENTROPY_B],
                                                ctx=gpu)],
                   calib_mode="entropy")
    ent_s = time.perf_counter() - t0
    ent_out = ent(xs[0])._data
    ent_rel = float((ent_out - f32).abs().max() / f32.abs().max())
    print(f"28.4 quantize_net: resnet50_v1 NCHW f32, naive calibration on "
          f"{Q_BATCHES} x {Q_B} at 224^2 in {calib_s:.2f} s: {len(convs)} "
          f"QuantizedConv2D, {len(dense)} QuantizedDense, {len(left)} "
          f"layers left; int32 accumulators equal on the card and the CPU "
          f"{sum(acc_equal)} of {len(acc_equal)} (batch of {Q_ACC_B}); "
          f"logits' largest error {rel:.4f} of the f32 logits' largest "
          f"magnitude (limit {Q_REL_ERR}), top-1 agreement {top1:.4f}; "
          f"entropy mode on {Q_ENTROPY_B} images in {ent_s:.2f} s, error "
          f"{ent_rel:.4f}; ms a forward of {Q_B}: quantized {q_ms:.3f} "
          f"beside f32 {f32_ms:.3f}; {card_line()}", flush=True)
    if len(convs) != 53 or len(dense) != 1 or left:
        fail(f"28.4: {len(convs)} convolutions and {len(dense)} Dense "
             f"replaced, {len(left)} left")
    if not all(acc_equal):
        fail(f"28.4: accumulators equal {sum(acc_equal)} of "
             f"{len(acc_equal)}")
    if not (rel <= Q_REL_ERR and torch.isfinite(got).all() and
            math.isfinite(ent_rel)):
        fail(f"28.4: quantized logits' error {rel} (limit {Q_REL_ERR}), "
             f"entropy {ent_rel}")
    row = dict(convs=len(convs), dense=len(dense), acc_equal=sum(acc_equal),
               rel_err=rel, top1=top1, entropy_rel_err=ent_rel,
               calib_s=calib_s, entropy_s=ent_s, q_ms=q_ms, f32_ms=f32_ms)
    del ent, xs, f32, got, ent_out
    torch.cuda.empty_cache()
    return row


def runtime_util():
    """28.5: ``Features()`` shows CUDA and CUDNN on, ``get_gpu_count()``
    is 1, ``get_gpu_memory(0)`` is ``torch.cuda.mem_get_info``'s pair
    (no allocation between the two reads)."""
    import torch
    import mxnet_tpu_torch as mx

    feats = mx.runtime.Features()
    count = mx.util.get_gpu_count()
    torch.cuda.synchronize()
    free, total = mx.util.get_gpu_memory(0)
    free2, total2 = torch.cuda.mem_get_info(0)
    print(f"28.5 runtime: {feats}; get_gpu_count {count}; get_gpu_memory "
          f"(free {free}, total {total}) beside mem_get_info (free {free2},"
          f" total {total2})", flush=True)
    if not (feats.is_enabled("CUDA") and feats.is_enabled("CUDNN")) or \
            count != 1 or total != total2 or abs(free - free2) > 2 ** 21:
        fail("28.5: runtime features or util's card helpers are wrong")
    return dict(features=repr(feats), gpu_count=count, free=free,
                total=total)


def check_numpy_interface(cfg, gluon_row):
    """Phase 28: 28.1-28.5, with the phase's seconds."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    row = dict(resnet=np_resnet(gluon_row))
    t1 = time.perf_counter()
    row["surface"] = np_surface()
    t2 = time.perf_counter()
    row["telemetry"] = train_telemetry(cfg)
    t3 = time.perf_counter()
    row["quantize"] = quantize_resnet()
    t4 = time.perf_counter()
    row["runtime"] = runtime_util()
    row["seconds"] = time.perf_counter() - t0
    row["launches"] = dict(row["telemetry"]["launches"], conv1x1_bwd=row[
        "resnet"]["launches"]["conv1x1_bwd"])
    print(f"phase 28: {row['seconds']:.2f} s (28.1 {t1 - t0:.2f}, 28.2 "
          f"{t2 - t1:.2f}, 28.3 {t3 - t2:.2f}, 28.4 {t4 - t3:.2f}); the "
          f"script so far {time.perf_counter() - T_START:.2f} s", flush=True)
    return row


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
    srv["drift"] = trace_drift(model, cfg)
    del model
    torch.cuda.empty_cache()
    srv["agreement_f32"] = check_serving_f32(cfg)
    torch.cuda.empty_cache()
    train = check_training(cfg)
    train["captured_vs_eager"] = check_captured_vs_eager(cfg)
    train["vs_cpu"] = check_training_vs_cpu()
    bert = check_bert()
    _stamp("phases 1-7 (kernels, serving, training)")

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
    _stamp("phases 8-11 (fused decode)")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    llama, lcfg = llama_7b(dtype=torch.bfloat16)
    llama.initialize(0.02, seed=0)
    torch.cuda.synchronize()
    print(f"llama_7b: {sum(p.numel() for p in llama.parameters())} "
          f"parameters, bf16, seeded Normal(0.02), built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    fused["llama_7b"] = check_llama7b(llama, lcfg)
    # 12b-12d at Llama-7B's width and L7_SERVED_LAYERS of its layers
    del llama
    torch.cuda.empty_cache()
    llama, lcfg = llama_7b(dtype=torch.bfloat16,
                           num_layers=L7_SERVED_LAYERS)
    llama.initialize(0.02, seed=0)
    print(f"llama_7b served model: {lcfg.num_layers} layers at full width, "
          f"{sum(p.numel() for p in llama.parameters())} parameters",
          flush=True)
    served = check_llama_served(llama, lcfg)
    served["spec"] = check_llama_spec(llama, lcfg, served)
    served["faults"] = check_llama_faults(llama, lcfg, served)
    del llama
    torch.cuda.empty_cache()
    served["faults"]["sync"] = gpt2_sync()
    served["f32"] = check_llama_served_f32()
    served["spec_f32"] = check_llama_spec_f32()
    _stamp("phase 12 (Llama-7B)")

    k6_design = report_design("K6", "conv1x1_bwd", "conv1x1_bwd_design",
                              "conv1x1_bwd_mma_kernel")
    k6 = check_k6()
    vision = dict(fused=check_resnet(True), unfused=check_resnet(False),
                  vs_cpu=check_resnet_vs_cpu())
    gluon = check_gluon(vision["fused"])
    _stamp("phases 13-16 (vision, Gluon)")

    import mxnet_tpu_torch as mx

    rtc = check_rtc()
    gelu_op = _rtc_sources().RtcGelu(mx, op_type="rtc_gelu").register()
    mlp = check_imperative_mlp(gelu_op)
    mlp["vs_cpu"] = check_imperative_vs_cpu()
    fused_train = check_fused(gelu_op, vision["fused"], gluon["resnet"], mlp)
    _stamp("phases 17-18 (rtc, MLP, fused steps)")
    opt19 = check_optimizers(cfg, gelu_op, train)
    _stamp("phase 19 (optimizers)")
    hybrid = check_hybrid(cfg, train)
    data = check_data()
    det = check_detection()
    seq = check_sequence()
    corpus = check_corpus(fused_train["resnet"], opt19)
    runtime = check_runtime()
    vision26 = check_vision_breadth(fused_train["resnet"])
    sym27 = check_symbolic(cfg, fused_train["resnet"])
    np28 = check_numpy_interface(cfg, gluon["resnet"])

    # the kernels line, the card's line and the result
    gelu = next(c for c in rtc["cases"]
                if c["name"] == "gelu_fwd<__nv_bfloat16>")

    # the fp16 instantiation of K1-K3 (phase 25.1's path) at GPT-2
    # small's training shape, dropout 0; its launches those of 25.1's
    # children (runs A, B, resumed, NaiveEngine; the killed run's are not
    # reported)
    k1_fp16 = next(r for r in k1 if r["dtype"] == "float16")
    k23_fp16 = next(r for r in k23 if r["dtype"] == "float16")

    def fp16_row(name, row):
        return dict(launches=runtime["fp16_launches"][name], ms=row["ms"],
                    plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                    bound_by=row["bound_by"], library_ms=row["library_ms"],
                    max_abs_err=row.get("max_abs_err"))

    def backward_row(name, key, outputs, replaces):
        main = k23[0][key]
        return dict(name=name, route="cuda",
                    source="mxnet_tpu_torch/csrc/flash_bwd.cu",
                    replaces=replaces,
                    launches=train["launches"][name] +
                    opt19["lamb_gpt2"]["launches"][name] +
                    hybrid["launches"][name] + seq["launches"][name] +
                    runtime["launches"][name] + sym27["launches"][name] +
                    np28["launches"][name],
                    max_abs_err=max(e for r in k23
                                    for w, e in r["max_abs_err"].items()
                                    if w in outputs),
                    ms=main["ms"], plain_ms=main["plain_ms"],
                    bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                    library_ms=main["library_ms"],
                    fp16=dict(fp16_row(name, k23_fp16[key]),
                              max_abs_err=max(
                                  e for w, e in
                                  k23_fp16["max_abs_err"].items()
                                  if w in outputs)))

    kernels = [
        dict(name="q8_matvec", route="cuda",
             source="mxnet_tpu_torch/csrc/q8_matvec.cu",
             replaces="mxnet_tpu/ops/q8_matvec.py:74",
             launches=srv["launches"]["q8_matvec"] +
             served["launches"]["q8_matvec"] +
             served["spec"]["launches"]["q8_matvec"] +
             served["faults"]["launches"]["q8_matvec"] +
             served["faults"]["sync"]["launches"]["q8_matvec"],
             max_abs_err=k4["max_abs_err"], ms=k4["ms"],
             plain_ms=k4["plain_ms"], bound_ms=k4["bound_ms"],
             bound_by=k4["bound_by"], library_ms=k4["library_ms"],
             queued_ms=k4["queued_ms"],
             library_queued_ms=k4["library_queued_ms"],
             verify_ms=k4["verify"]["ms"],
             verify_library_ms=k4["verify"]["library_ms"],
             verify_bound_ms=k4["verify"]["bound_ms"],
             design=k4["design"]["design"]),
        dict(name="flash_fwd", route="cuda",
             source="mxnet_tpu_torch/csrc/flash_fwd.cu",
             replaces="mxnet_tpu/ops/attention.py:226",
             launches=train["launches"]["flash_fwd"] +
             opt19["lamb_gpt2"]["launches"]["flash_fwd"] +
             hybrid["launches"]["flash_fwd"] + seq["launches"]["flash_fwd"] +
             srv["launches"]["flash_fwd"] + served["launches"]["flash_fwd"] +
             served["spec"]["launches"]["flash_fwd"] +
             served["faults"]["launches"]["flash_fwd"] +
             served["faults"]["sync"]["launches"]["flash_fwd"] +
             runtime["launches"]["flash_fwd"] +
             sym27["launches"]["flash_fwd"] + np28["launches"]["flash_fwd"],
             max_abs_err=max(r["max_abs_err"] for r in k1), ms=k1[0]["ms"],
             plain_ms=k1[0]["plain_ms"], bound_ms=k1[0]["bound_ms"],
             bound_by=k1[0]["bound_by"], library_ms=k1[0]["library_ms"],
             fp16=fp16_row("flash_fwd", k1_fp16),
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
        # the graph's launches), of phase 20.4's hybrid_forward stage, of
        # phase 21's loader-fed epoch, of phase 22's SSD, of phase 24.1's
        # aggregated-update loop, of phase 26.2's two Estimator fits and of
        # phase 27.1's Module.fit (f32)
        dict(name="conv1x1_bwd", route="cuda",
             source="mxnet_tpu_torch/csrc/conv1x1_bwd.cu",
             replaces="mxnet_tpu/ops/conv_fused.py:134",
             launches=vision["fused"]["launches"]["conv1x1_bwd"] +
             gluon["resnet"]["launches"]["conv1x1_bwd"] +
             fused_train["resnet"]["launches"]["conv1x1_bwd"] +
             opt19["lars_resnet"]["launches"]["conv1x1_bwd"] +
             hybrid["launches"]["conv1x1_bwd"] + data["launches"] +
             det["launches"]["conv1x1_bwd"] +
             corpus["launches"]["conv1x1_bwd"] +
             vision26["launches"]["conv1x1_bwd"] +
             sym27["launches"]["conv1x1_bwd"] +
             np28["launches"]["conv1x1_bwd"],
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
        # box_nms: the port's own kernel, with no Pallas counterpart (it
        # replaces the reference's lax.fori_loop); its launches those of
        # phase 22.2's replayed SSD detection and 22.3's Proposal; its
        # times at SSD-512's 32 x 6,132 rows and nms_topk 400 (the
        # Faster R-CNN row of 6,000 beside them); no PyTorch call computes
        # greedy NMS, so library_ms is null
        dict(name="box_nms", route="cuda",
             source="mxnet_tpu_torch/csrc/box_nms.cu",
             replaces="mxnet_tpu/ops/nn.py:883",
             launches=det["launches"]["box_nms"],
             max_abs_err=det["detect"]["max_abs_err"],
             ms=det["detect"]["ms"], plain_ms=det["detect"]["plain_ms"],
             bound_ms=det["detect"]["bound_ms"],
             bound_by=det["detect"]["bound_by"], library_ms=None,
             all_rows_ms=det["detect"]["ms_all"],
             all_rows_bound_ms=det["detect"]["bound_ms_all"],
             rpn_ms=det["rcnn"]["nms_ms"],
             rpn_plain_ms=det["rcnn"]["nms_plain_ms"],
             rpn_bound_ms=det["rcnn"]["nms_bound_ms"]),
    ]
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"),
              "w") as fh:
        json.dump(dict(card=card, build_s=secs, k4=k4, k1=k1, k23=k23,
                       k1_design=k1_design, k2_design=k2_design,
                       k3_design=k3_design, k6_design=k6_design,
                       k5_design=k5_design,
                       seed_word=seed_word,
                       serve=srv, llama_served=served, train=train,
                       bert=bert, k5=k5,
                       fused=fused, k6=k6, vision=vision, gluon=gluon,
                       rtc=rtc,
                       mlp=mlp, fused_train=fused_train, optimizers=opt19,
                       hybrid=hybrid, data=data, detection=det,
                       sequence=seq, corpus=corpus, runtime=runtime,
                       vision_breadth=vision26, symbolic=sym27,
                       numpy_interface=np28,
                       kernels=kernels),
                  fh, indent=1, default=str)
    print(f"chip_smoke: {time.perf_counter() - T_START:.2f} s in all",
          flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--p25-child":
        p25_child(json.loads(sys.argv[2]))
    else:
        main()
