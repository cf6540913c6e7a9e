#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises (non-zero exit):

1. ``build``   — build every CUDA kernel from ``mxnet_tpu_torch/ops/kernels/
   csrc`` with nvcc for sm_90a (seconds, ptxas report, card name + limit).
2. ``kernel``  — each kernel against its plain PyTorch version on the card
   at the main paths' shapes, then timed (CUDA events, median) beside the
   plain version, one PyTorch library call where there is one, and the
   card's bound: the flash-attention forward (bf16 on wgmma + TMA, f32 on
   register tiles + cp.async: each instantiation's registers, shared memory
   and spills from ptxas, HGMMA / UTMALDG counts from its SASS, the tile
   edges, both types timed at the serve and train shapes with device times
   beside), the flash-attention backward (dQ and dK/dV kernels, the same
   two designs and report, both types timed at the train shape with device
   times beside SDPA autograd's; both also at the train phase's batch 32
   in bf16), the fused sgd_mom / adam updates (the device-lr entry points
   bit for bit the scalar ones and their plain versions), and the
   convolution weight gradient (conv_wgrad: bf16 on wgmma + TMA after a
   repack, f32 on register tiles + cp.async, a simt body for odd bf16
   shapes, and the reduction kernel; the same instantiation report, each
   case's route, the ResNet shapes held to the wgmma and f32 routes) at
   ResNet-50's seven 3x3 shapes and the reference oracle's odd cases,
   beside cuDNN's wgrad, with device times; and the LSTM step (lstm_step:
   f32 on register tiles + cp.async, bf16 on wgmma + TMA, a simt body for
   odd bf16 layouts; the same instantiation report, each case's route, the
   scan's main-path shapes held to the f32 and wgmma bodies) at the LSTM
   LM's shape, the bucketing run's (32, 512) and odd ones, on the views the
   RNN op passes, beside cuBLAS + PyTorch's fused LSTM cell and, for a
   whole layer, cuDNN's LSTM.
3. ``serve``   — the continuous-batching generate path at full width (the
   GQA decoder LM of ``bench.py``: d 2048, 16 heads, 4 kv heads, ffn 8192,
   vocab 10000, bench.py's own 4 layers (not cut), seeded random weights,
   f32; ``mxnet_tpu_torch/tools/lm.py``): six
   prompts through ``DecodeScheduler`` with four slots, so admissions
   happen mid-flight. Checks every stream, the kernel's launch count, and
   first-token logits against the port's plain path on the CPU.
3b. ``serve_paged`` — the same LM behind ``SERVE_PAGED``'s traffic (8
   slots over 288 blocks of 16 positions, five prompts behind one
   1000-token system prompt, three unshared, 32 new tokens each):
   (1) the serve phase's prompts again with the decode step captured as
   one CUDA graph: the streams equal the eager ones bit for bit, 24 flash
   launches, 2 warm-up steps, 1 capture, a replay a later step; (2) the
   traffic through eight arms (paged and unpaged, f32 and int8 KV, eager
   and captured): every stream 32 tokens, captured streams equal eager
   ones, paged arms with the prefix hits, tokens saved and forks that
   follow from the prompts, an admission that waited on blocks, the pool
   free at the end and no flash launch, unpaged arms a flash launch a
   prompt and layer, int8 ``kv_bytes`` exact; 8 captured paged steps
   from copies of one pair of slabs equal 8 eager ones bit for bit;
   (3) teacher-forced, the first sharer and a forking joiner: paged
   against unpaged within SERVE_ATOL, the argmax equal wherever the
   unpaged margin exceeds PAGED_MARGIN; int8 (captured) against f32 within
   INT8_KV_TOL, the argmax in the f32 top 5. Prints each arm's decode ms a
   step, TTFT, tokens/s, peak blocks and memory, and the prefill ms the
   prefix hits saved.
3c. ``serve_spec`` — the same LM behind ``SERVE_SPEC``'s traffic
   (SERVE_PAGED's eight prompts and pool, 64 new tokens, k = 4 drafts):
   (1) ``quantized_matmul`` on the card against its CPU path at the LM's
   shapes (M 8 and 40): the int8-activation path bit for bit, dequant on
   load within QMM_F32_RTOL / one bf16 ulp; the int8 product's time at M
   = 8 beside its bound and the f32 product; (2) twelve arms: vanilla
   captured (unpaged f32, paged f32, paged int8 KV), ``quant_weights``
   int8 and fp8 (captured, unpaged), speculative greedy (int8 draft
   unpaged eager and captured, self draft captured, int8 draft paged f32
   and paged int8 KV captured) and sampled (paged, captured, temperature
   0.8, twice): every stream 64 tokens, exact flash launches (a prompt and
   layer unpaged, none paged or in a verify), exact int8 products (a
   forward of the int8 draft a draft step; of the int8 model a prefill
   and a step), the captured path (draft step and verify: 2 warm-ups, 1
   capture, replays), every block free, more tokens than
   sequence-iterations; greedy spec streams equal the vanilla ones of
   their layout but where the vanilla top-2 margin <= PAGED_MARGIN
   (printed), captured = eager, the sampled runs equal, the self draft
   accepting >= SPEC_SELF_ACCEPT; (3) teacher-forced: the verify fed the
   vanilla streams as windows within SERVE_ATOL of the decode logits (f32
   and int8 KV, unpaged and paged), and the quantized weights within
   QUANT_WEIGHTS_TOL of f32, argmax in the f32 top 5. Prints tokens/s
   against vanilla, ms a token, accept rates, tokens a sequence-iteration
   and peak memory. Also the ``quantize`` / ``dequantize`` ops (uint8,
   int8, fp8) on the card against the CPU, bit for bit.
3d. ``serve_trace`` — telemetry on the serve path: the serve phase's
   traffic (6 prompts of 100-2000 tokens, 4 slots, 32 new tokens,
   greedy, the decode step captured) five times, all prompts queued
   before the first admission: spans off, spans on, inside a profiler
   window (``mxnet_tpu_torch.profiler``: host spans and ``torch.profiler``
   CPU + CUDA events in one dump), spans off and on again. Gates: the same
   tokens and captured path (2 warm-ups, 1 capture, replays) in every
   run; the dump's spans (one ``serving.queued``, ``serving.dispatch`` and
   ``decode.prefill`` a request, one ``decode.step`` a scheduler step,
   each stream's trace id on its queued span and in the ``trace_ids`` of
   the 31 steps it shared); the dump's flash-forward kernel events as many
   as the launch counter rose; the registry's exposition parses and
   ``kv_bytes``, ``decode_tokens_total``, ``decode_spec_accept_rate``,
   ``decode_tokens_per_step`` read the scheduler's stats; a stream past
   its deadline writes one flight bundle. Prints each run's decode ms a
   step, the spans' cost a step beside its prediction, and (not gated)
   the train phase's run and ResNet-50's epoch under the profiler, each
   kernel's events beside its launch counter.
3e. ``serve_fixed`` — the fixed-shape serving stack
   (``mxnet_tpu_torch/tools/serve_fixed.py``): (1) the serve phase's LM
   with its SoftmaxOutput head through ``predict.Predictor`` at (1, 512),
   reshaped to (4, 512) and (1, 2048) on the same weight tensors, each
   bind one CUDA graph (2 warm-ups, 1 capture, a replay a forward): the
   replays equal the eager forward (MXNET_CUDA_GRAPH=0) bit for bit,
   exactly 4 flash launches a kernel-running forward, the card within
   SERVE_ATOL of the port's CPU Predictor (argmax equal past
   PAGED_MARGIN); (2) ResNet-50 (1000 classes, 3 x 224 x 224, f32)
   behind ``InferenceServer`` (buckets 1-32, 5 ms window, 2 replicas on
   the card, zero-copy pinned staging, every bucket bound at start): one
   replica's binds beside the other's serving; 8 clients sending 96
   requests of 1-4 images through the ``rr`` and ``least_loaded``
   routers (every request answered, occupancy > 1, binds <= 6 x 2, each
   result within RESNET_PREDICT_TOL of the request alone through a
   Predictor on the card, two of the CPU's), a burst under a 1 ms
   deadline (some ``deadline_exceeded``, the queue drains) and an int8
   weight arm (RESNET_INT8_TOL of f32); requests/s, p50 / p99 latency and
   peak memory with the graphs' pools; (3) the LM behind
   ``InferenceServer(..., decode=GenerateConfig(...))`` with 2 replicas,
   the decode step captured, the serve phase's six prompts: its
   ``predict()`` refused (not batch-major), every stream the serve
   phase's (a near-tie allowed), exactly 24 flash launches, each
   replica's captured path, every slot free, ``generate()`` =
   ``submit_stream()``; then the flash forward at the Predictor's shapes
   against its plain version, timed beside SDPA and its bound.
3f. ``serve_http`` — the HTTP / SSE front door
   (``mxnet_tpu_torch.serving.frontend``, ``tools/serve_http.py``) over
   loopback: (1) ResNet-50 (serve_fixed's, one replica, buckets 1-32, 5
   ms window, zero-copy) behind ``HttpFrontend``: ``/healthz`` 200 and
   ``/readyz`` 503 ``warming`` while the ladder is held cold, 200 once
   warm; 8 closed-loop keep-alive clients sending 96 requests of 1-4
   images in the b64 form (every answer 200 with its ``x-request-id``,
   each result within RESNET_PREDICT_TOL of the request alone through a
   Predictor on the card), the same traffic in-process through
   ``srv.submit`` (requests/s, p50 / p99 of both and the HTTP hop's
   share), one request in the JSON and the b64 form bit for bit; (2)
   admission on a one-bucket (32) ladder with a 400 ms window and 4
   requests parked in it: a batch-class POST 429 ``shed`` with
   Retry-After >= 1, an interactive one 200, two HTTP requests parked
   at ``max_inflight`` 2 and a third 503 ``overloaded``, the counters
   up by exactly 3 admitted and 2 refused, ``/metrics`` parsed; (3) the
   serve phase's LM behind the server with 2 decode replicas, the
   decode step captured: the six prompts as concurrent SSE streams
   (each the serve phase's, a near-tie allowed; indices 0..31, ``done``
   with 32 tokens) beside a client that leaves after 4 tokens (its
   stream cancelled, every slot free), a ``"stream": false`` request
   equal to its stream, a traced request (``x-trace-id`` echoed, its
   span tree at ``/debug/requests/<id>``), the six in-process (TTFT and
   inter-token ms of both), each replica's captured path, exact flash
   launches (a prompt admitted and layer, plus the fixed path's
   warm-up forwards); (4) SIGTERM with two streams open: both finish
   with 32 tokens, ``/readyz`` 503 ``draining`` (or closed), a new POST
   503 ``shutting_down`` (or refused), the previous handler restored.
4. ``train``   — the same LM trained as bench.py trains it: first 2 SGD
   steps at 1 x 256 through ``simple_bind`` -> ``forward``/``backward``
   -> ``optimizer.Updater``, f32, no TF32, on the card and on the port's
   CPU path from the same weights (losses and parameters must agree); the
   same 2 steps in bf16 through the fused step (``simple_bind(...,
   compute_dtype="bfloat16")`` -> ``make_train_step`` with the SGD
   ``pure_rule``), card against CPU: the loss within TRAIN_BF16_LOSS and
   the parameters within TRAIN_BF16_SPREAD times the CPU's bf16-to-f32
   distance, while the same step with the card in f32 (the control) must
   fail the loss gate; then the run: Xavier-initialized 5
   SGD-momentum + 3 Adam steps at 32 x 2048 (bench.py's batch), bf16,
   each optimizer's step one CUDA graph (two warm-up calls, a capture,
   replays), with exact launch counts of every kernel (flash forward,
   backward dQ and dK/dV, all in bf16; both updates' device-lr entries),
   10 more timed
   Adam steps; then the whole run again with the step eager, which must
   land on the same parameters bit for bit.
5. ``resnet``  — ResNet-50 (bench.py's headline model, full width, 1000
   classes, 3 x 224 x 224, no TF32; ``mxnet_tpu_torch/tools/
   resnet.py``) trained through ``Module.fit``: first 2 batches of 2 in
   f32 on the card and on the port's CPU path from the same Xavier
   weights (updates, aux states and metrics must agree), then one epoch
   of 8 seeded batches of 32 in bf16 (bench.py's compute type) through
   the captured fused ``fit_step``, with exact launch counts (conv_wgrad
   partial (all bf16), reduce and repack, sgd_mom), finite cross-entropy,
   step
   times, images/s and peak memory; then the epoch again with the fused
   step eager (``MXNET_CUDA_GRAPH=0``): parameters and aux states equal
   bit for bit.
5a. ``image_zoo`` — the models of MXNet's example/image-classification
   (``mxnet_tpu_torch/tools/image_zoo.py``): (1) the new core ops
   (``tools/op_cases.py``'s table at full shapes) on the card against
   their CPU path: indexing, ordering with ties, rounding, Cast, the
   logical ops and the moves bit for bit, the rest within ZOO_OP_RTOL,
   every gradient within
   ZOO_GRAD_RTOL; (2) conv_wgrad at every eligible 3x3 shape of the seven
   models at full width, batch 32 (stems of 3 channels at 299, odd sizes
   with pad 0), bf16 and f32, against its plain version, each shape's
   route (f32 / wgmma / simt; both bf16 bodies must be reached) and, timed,
   beside cuDNN's wgrad and its bound; (3) Inception-BN (1000 classes, 3 x
   224 x 224, bf16, batch 32, 8 batches) through the captured fused
   ``fit_step``, exact launches (conv_wgrad 31 a step, all on the wgmma
   route: 248 + 248, repack 496; sgd_mom a parameter a batch), then eager,
   bit for bit; (4) each of the seven models (alexnet, vgg16, googlenet,
   inception-bn, inception-v3, inception-resnet-v2, resnext-50) at its
   published input, f32, 2 batches of 2, card vs CPU at IMAGE_ZOO_GATE x
   its own f32-vs-f64 distance on the CPU (the largest over 3 seeds),
   widened by how much farther the card's library convolutions alone lie
   from f64 (IMAGE_ZOO_WITNESS), Dropout at p = 0 through the JSON, with
   exact conv_wgrad launches (none for resnext's grouped 3x3). Prints each
   part's seconds.
5b. ``ssd`` — MXNet's SSD (``tools/ssd.py``; ``ssd-vgg16``, 20 classes,
   300 x 300, 1,756 anchors): (1) the nine contrib ops (``ctc_loss``,
   ``fft`` / ``ifft``, ``count_sketch``, the MultiBox ops, ``Proposal``,
   ``Correlation``) card vs CPU at full shapes, class targets and masks
   bit for bit, the rest within ZOO_OP_RTOL (count_sketch's atomic sums
   too); (2) 2 batches of 2 in f32 card vs CPU (``ssd_tol``: 1.5 x the
   CPU's f32-vs-f64 distance over 3 seeds x SSD_WITNESS), then the
   matching on the check's boxes (class targets and masks equal but at
   an IoU within SSD_IOU_MARGIN of 0.5 or two ground truths within
   SSD_TIE_MARGIN); (3) conv_wgrad at ssd's 20 3x3 shapes at batch 32,
   bf16 and f32, against its plain version in f64; (4) batch 32, bf16, 8
   batches through the captured ``fit_step``: conv_wgrad 24 a step, 17 on
   the wgmma route (two repacks each) and 7 on the simt body (conv1_1,
   the four class heads of 84 filters, conv8_2 and conv9_2: stride 2 on
   odd sizes), ``sgd_mom_update_lr`` 54 a step; its eager twin and its
   ``DevicePrefetchIter`` twin bit for bit (the twin with the same
   launches); (5) the detection symbol
   through ``Predictor`` at batch 1 and 8 with the trained weights:
   replays = eager bit for bit, card vs CPU within SSD_DECODE_ATOL, keep
   masks equal but after a near tie. Prints step ms, images/s, peak
   memory, conv_wgrad ms a step by route, detect p50 and each part's
   seconds.
6. ``lstm``    — the fused 2-layer LSTM LM (the repo's widest LSTM record:
   vocab 10000, embed = hidden = 512, seq 35, f32, no TF32;
   ``mxnet_tpu_torch/tools/lstm_lm.py``) trained through ``Module.fit``:
   first 2 batches of 8 on the card and on the port's CPU path from the same
   Xavier weights (each parameter's update and the perplexity must agree),
   then one epoch of 8 seeded batches of 128 through the captured fused
   ``fit_step`` and ``Module.score`` over the same batches, with exact
   ``lstm_step`` launch counts in each (2 layers x 35 steps x 8), finite
   perplexity, step times, tokens/s and peak memory; then the epoch again
   with the step eager, equal bit for bit; before it, a line naming what
   holds the card's memory.
6a. ``zoo``   — the rest of training (``tools/zoo.py``): the lstm
   phase's LM under every optimizer of the reference's registry (SGD,
   NAG, ccSGD, DCASGD, Adam, AdaGrad, RMSProp plain and centered,
   AdaDelta, Ftrl, SGLD, Test): (1) 2 batches of 8, card against the CPU
   at the lstm gates for each, SGLD held to its definition instead (one
   update at g = 0 adds N(0, lr) over the embedding's 5.12 M elements,
   mean and variance within 5 sigma, seeds repeat and differ); (2) 8
   batches of 128 through ``Module.fit`` each: NAG, RMSProp x 2,
   AdaGrad, AdaDelta and ccSGD (momentum 0.9) through the captured fused
   step, each against its eager twin bit for bit; Ftrl, SGLD, DCASGD and
   Test through the Updater ("has no pure rule"); every fit exactly 560
   ``lstm_step`` launches, ccSGD's ``sgd_mom_update_lr`` 4 parameters x
   8; (3) the LM as a ``SequentialModule`` (embedding + fused LSTM, then
   FC + SoftmaxOutput with ``take_labels``) against the single Module at
   the lstm gates, its 8 batches of 128 (``sgd_mom_update`` 32), and a
   ``PythonLossModule`` head against the CPU; (4) ``Monitor(2)`` on 4
   batches of 8: every internal output and argument on batches 1 and 3,
   none on 2 and 4, card = CPU within MONITOR_RTOL, the fused step off
   for "monitor install", lstm_step 420; (5) ``FeedForward``: fit 2
   batches, predict and score against the CPU, save / load / predict bit
   for bit; (6) Orthogonal, MSRAPrelu, Bilinear, Mixed, Load, ``clip``,
   ``sign``, ``moveaxis``, ``onehot_encode`` bit for bit, ``norm`` within
   NORM_RTOL, F1 / MAE / MSE / RMSE equal. Prints each optimizer's
   captured and eager step ms and peak memory beside the card.
6b. ``seq``   — the sequence ops, the schedulers and the sampling ops:
   the LSTM LM's body (vocab 10000, embed = hidden = 512, 2 fused layers,
   seq 35, f32) under a classifier head (``RNN`` output ->
   ``SequenceMask`` -> ``SequenceLast``, both with lengths, ->
   ``FullyConnected(10)`` -> ``SoftmaxOutput``; lengths seeded in 1..35;
   ``tools/seq_classify.py``) through ``Module.fit`` with SGD momentum
   0.9 under ``FactorScheduler(step=2, factor=0.5)``: (a) 2 batches of 8,
   card against the CPU, at the lstm phase's gates; (b) 8 batches of 128
   through the captured fused ``fit_step``: exactly 560 ``lstm_step``
   launches, each step's lr (read from the step's own buffer) the
   schedule's, and the run eager on the same parameters bit for bit;
   (c) ``_arange``, ``_eye``, ``_full``, ``zeros_like`` and the sequence
   ops bit for bit against the CPU; (d) ``_random_uniform`` / ``normal``
   / ``gamma`` / ``exponential`` at 2^20 elements: mean and variance
   within 5 sigma, a seed repeating, two seeds differing.
7. ``kernel`` rtc — ``mx.rtc``: the JAX package's rtc test kernels (axpy,
   inc, relu, axpy in bf16) as CUDA C compiled by NVRTC, each against its
   mode="torch" twin; the source cache; a syntax error and a refused
   launch raising; the ``rtc_softmax`` forward and backward kernels
   (``mxnet_tpu_torch/tools/rtc_softmax.py``; the backward's vector and
   scalar sources) against their twins at the LSTM LM's (4480, 10000) and
   odd shapes, each case's backward route named, timed beside the twins,
   ``torch.softmax`` and ``torch.scatter_add``, with the NVRTC compile ms.
8. ``custom``  — the LSTM LM of phase 6 with a Custom ``rtc_softmax`` head
   (forward and backward rtc kernels) through ``Module.fit``: (a) card
   vs the port's CPU path (2 batches of 8), (b) the rtc head vs the
   built-in ``SoftmaxOutput`` head on the card (2 batches of 128), both
   at the lstm phase's gates; (c) 8 batches of 128 through the captured
   fused ``fit_step`` (the rtc kernels inside the graph) and
   ``Module.score`` with exact launch counts (rtc fwd 8 + 8, bwd 8 + 0,
   lstm_step 560 + 560), finite perplexity, step times, tokens/s and peak
   memory; then the 8 batches again with the step eager, equal bit for
   bit.
9. ``bucketing`` — the same LSTM LM as MXNet's ``lstm_bucketing.py``
   trains it (``mxnet_tpu_torch/tools/lstm_bucketing.py``: buckets
   10..60, batch 32, dropout 0.5 between the layers, SGD lr 0.01 / wd
   1e-5 / momentum 0.9, a seeded Markov corpus) through
   ``BucketingModule``: (1) card vs the port's CPU path at p = 0 (the two
   devices' generators draw different masks), 2 batches of 8 in bucket
   10 and 2 in 60, at the lstm phase's gates; (2) one epoch (>= 24
   batches, every bucket twice or more) with ``do_checkpoint`` and
   ``module_checkpoint(save_optimizer_states=True)`` at its end, then
   ``score``, with exact launches (lstm_step 2 x the epoch's summed
   bucket lengths, f32 only; sgd_mom_update 4 x batches), eager step ms
   by bucket, tokens/s and peak memory; (3) a fresh BucketingModule from
   the checkpoint and its optimizer states against the uninterrupted
   one, 4 batches after the same seed: bit for bit; (4) dropout on the
   card: eval at p = 0.5 equals p = 0 bit for bit, seeds repeat and
   differ, a 2^20-element mask keeps 0.5 +- 5 sigma, each kept entry
   x / (1 - p) exactly; (5) ``Module.fit`` at seq 35 with dropout through
   the captured step against its eager twin, bit for bit, and two more
   replays on one batch, which must differ.
9a. ``kvstore`` — communication in one process (``tools/dist_lstm.py``'s
   ``DIST_LSTM``: the lstm phase's LM, batch 128, 8 batches, SGD lr 0.1
   momentum 0.9, f32): the one-context unfused fit (``MXNET_FUSED_FIT=0``),
   then ``Module.fit`` over ``context=[card, card]`` (64 rows each) with
   kvstore "device" and then "local": each batch's update within
   LSTM_UPDATE of one context's and the perplexity within LSTM_PPL, the
   two contexts' parameters equal bit for bit after every batch, launches
   exact (lstm_step 2 x 70 a batch, the scalar sgd_mom_update once a
   parameter a batch, the device-lr entry never), the kvstore counters up
   by exactly what was pushed and pulled, one
   ``model.update_params_on_kvstore`` span a batch. Prints both runs' step
   ms against one context's.
9b. ``dist`` — across processes, against 9a's reference: ``dist_sync``
   over NCCL at world size 1 in this process (bit for bit the reference);
   the closed forms (``tools/dist_sync_kvstore.py``: 2 servers and 2
   workers on the card, keys (4, 4) and (1200, 1200), 3 sync rounds and an
   async one; ``tools/dist_collective.py``: 2 gloo ranks), every pull
   exact; then the LM over two gloo ranks on the card (one card refuses
   NCCL to two ranks) and through a parameter server on the host with two
   workers on the card, each rank half of every batch, at 9a's gates, both
   ranks' parameters bit for bit, each rank's launches exact. Every group
   starts at once (``tools/dist_run.py``: servers on port 0, ranks at a
   ``file://`` rendezvous); each LM group fits alone once its ranks are
   set up. A child that fails or outlives DIST_CHILD_S fails the phase.
   Prints step ms of both paths and each path's update (push and pull) ms
   and bytes a step.
10. ``engine`` (``mxnet_tpu_torch/tools/engine_phase.py``) — the engine
   on the card: ``engine.get()`` must be the native ``ThreadedEngine``
   (built from ``mxnet_tpu_torch/native/engine.cc``) and the
   happens-before sanitizer is on for the whole phase with no report at
   its end. (1) ResNet-50 ``Module.fit`` at the resnet phase's size (224,
   batch 32, bf16, 8 batches) three ways — the captured fused step as
   today, under ``MXNET_ENGINE_CAPTURE=1`` (replays = batches - warm-up)
   and under ``MXNET_ENGINE_FUSE=1`` as well (fused runs = batches -
   warm-up, each a replay of ONE CUDA graph of the batch's copy and the
   step) — the three equal bit for bit, each with exact ``conv_wgrad`` and
   ``sgd_mom_update`` launches; (2) the LM (serve_fixed's width, T = 512)
   behind ``InferenceServer`` eager, with ``capture=True`` and with
   ``fuse=True``: the same responses bit for bit, exact flash launches, a
   forced ladder swap mid-run that invalidates the sequences and a
   recapture after it; (3) the decode scheduler under
   ``MXNET_ENGINE_CAPTURE=1`` (captured step): the uncaptured run's tokens
   and ``decode_step_r0`` replaying; (4) the program cache's warm restart,
   two processes on one ``MXNET_PROGCACHE_DIR``: the first serves the LM,
   retunes (the tuner adds a rung) and saves; the second adopts the tuned
   ladder, disk-loads every bucket (``disk_load_count() == len(ladder)``,
   no fresh trace in the compile witness), answers bit for bit as the
   first and launches the flash kernel from the loaded programs; a
   truncated entry falls back (``progcache_fallbacks`` 1) with the same
   outputs.
11. ``kernels`` — one line per the port's kernel table.

Then the card's ``nvidia-smi`` name/power-limit line and, last, the
``{"ok": true, "device": ...}`` line. Exits non-zero without a CUDA card.
"""
import contextlib
import faulthandler
import functools
import gc
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time

import numpy as np

from mxnet_tpu_torch.tools.lm import LM, SERVE, SERVE_PAGED, SERVE_SPEC, \
    SEED, TRAIN, cuda_graph, expected_prefix_counts, forced_arms, \
    forced_unpaged, forced_verify, forced_verify_paged, lm_arg_params, \
    lm_feed, lm_param_shapes, lm_predict_symbol, lm_train_executor, \
    lm_train_setup, lm_train_step, lm_update, lm_updater, nvidia_smi, \
    paged_prompts, serve_prompts
from mxnet_tpu_torch.tools.lstm_lm import LSTM_LM, STEP_SHAPES, STEP_TOL, \
    lstm_setup, lstm_steps
from mxnet_tpu_torch.tools.lstm_lm import fit_args as lstm_fit_args
from mxnet_tpu_torch.tools import lstm_bucketing as lb
from mxnet_tpu_torch.tools.lstm_bucketing import BUCKETING
from mxnet_tpu_torch.tools.resnet import RESNET, change_err, fit_args, \
    resnet_setup, wgrad_convs
from mxnet_tpu_torch.tools.serve_fixed import SERVE_FIXED
from mxnet_tpu_torch.tools.serve_http import SERVE_HTTP
from mxnet_tpu_torch.tools.seq_classify import RANDOM_OPS, SEQ, lr_sequence, \
    moments, seq_setup
from mxnet_tpu_torch.tools.seq_classify import fit_args as seq_fit_args
from mxnet_tpu_torch.tools import zoo
from mxnet_tpu_torch.tools.dist_lstm import DIST_LSTM
from mxnet_tpu_torch.tools.dist_lstm import fit_args as dp_fit_args
from mxnet_tpu_torch.tools.image_zoo import IMAGE_ZOO, dead_shifts, \
    image_cfg, wgrad_shapes, zoo_setup, zoo_symbol
from mxnet_tpu_torch.tools.op_cases import CONTRIB_OPS, exact_output, \
    op_cases
from mxnet_tpu_torch.tools.ssd import SSD, matching_excused, \
    nms_explained, ssd_data, ssd_setup, ssd_symbol, ssd_targets
from mxnet_tpu_torch.tools.ssd import fit_args as ssd_fit_args
from mxnet_tpu_torch.tools.zoo import ZOO
from mxnet_tpu_torch.tools.engine_phase import ENGINE, lm_requests, \
    lm_server, request_sizes, serve_in_turn, swap_ladder

H100 = {"bf16_flops": 989e12, "f32_flops": 67e12, "int8_ops": 1979e12,
        "bytes_per_s": 3.35e12}
CSRC = "mxnet_tpu_torch/ops/kernels/csrc/"
FA_SRC = CSRC + "flash_attention_fwd.cu"
FA_REPLACES = "mxnet_tpu/ops/pallas/flash_attention.py:259"
# the forward's instantiations: __global__ name -> the type it runs
FA_KERNELS = {"flash_fwd_wgmma_kernel": "bfloat16",
              "flash_fwd_f32_kernel": "float32"}
# SASS opcodes a bf16 instantiation must contain: wgmma and TMA loads
FA_BF16_OPCODES = ("HGMMA", "UTMALDG")
FA_BWD_SRC = CSRC + "flash_attention_bwd.cu"
FA_BWD_REPLACES = "mxnet_tpu/ops/pallas/flash_attention.py:618"
# the backward's instantiations: a dQ and a dK/dV kernel per type
FA_BWD_KERNELS = {"flash_bwd_dq_wgmma_kernel": "bfloat16",
                  "flash_bwd_dkv_wgmma_kernel": "bfloat16",
                  "flash_bwd_dq_f32_kernel": "float32",
                  "flash_bwd_dkv_f32_kernel": "float32"}
# flops per visible (query, key) pair, head and head-dim element of one
# backward: the bound's (q.k, dO.v and the three products), and what the
# two kernels do (S and dP again in the dQ kernel; in bf16 also the lo
# parts of P and dS)
FA_BWD_WORK = {"bound": 10, "float32": 14, "bfloat16": 20}
UPDATE_SRC = CSRC + "fused_update.cu"
UPDATE_REPLACES = {"sgd_mom_update": "mxnet_tpu/ops/pallas/fused_update.py:31",
                   "adam_update": "mxnet_tpu/ops/pallas/fused_update.py:60"}
WGRAD_SRC = CSRC + "conv_wgrad.cu"
WGRAD_REPLACES = "mxnet_tpu/ops/pallas/conv_bwd.py:89"
# conv_wgrad's templated partial kernels (on bn, the columns of K a block)
# and the type each runs; the simt and reduce kernels are not templated
WGRAD_KERNELS = {"conv_wgrad_wgmma_kernel": "bfloat16",
                 "conv_wgrad_f32_kernel": "float32",
                 "conv_wgrad_f32tap_kernel": "float32"}
LSTM_SRC = CSRC + "lstm_step.cu"
LSTM_REPLACES = "mxnet_tpu/ops/pallas/lstm.py:35"
# lstm_step's templated bodies: __global__ name -> (the type it runs, its
# instantiations' template arguments); the simt body is reported only
LSTM_KERNELS = {"lstm_f32_kernel": ("float32", (64, 16)),
                "lstm_wgmma_kernel": ("bfloat16", (8,))}
LSTM_SIMT = "lstm_simt_kernel"
# the (N, H) the scan runs at in the lstm phases, and lstm_step's kernel vs
# plain (atol, rtol): both with their reasons in tools/lstm_lm.py
LSTM_MAIN, LSTM_TOL = STEP_SHAPES, STEP_TOL
# (atol, rtol); bf16 outputs differ by an ulp of |O| (rtol), while atol
# stays below |O| ~ sqrt(e / T) of the long rows
TOL = {"float32": (2e-4, 2e-4), "bfloat16": (2e-3, 2e-2)}
# flash backward (atol, rtol) per gradient. f32: dQ as the forward; dK/dV
# sum G * Tq (up to 8192) products per element in another order than the
# plain einsum, so atol 5e-4. bf16: one bf16 ulp of the result (rtol), and
# an atol far below the typical |dQ| / |dK| / |dV| the phase prints.
BWD_TOL = {"float32": {"dq": (2e-4, 2e-4), "dk": (5e-4, 2e-4),
                       "dv": (5e-4, 2e-4)},
           "bfloat16": {"dq": (2e-3, 2e-2), "dk": (5e-3, 2e-2),
                        "dv": (5e-3, 2e-2)}}
# fused updates (atol, rtol): the kernel may contract a*b+c into one FMA
# where the plain version rounds twice: a last-bit difference of f32, an
# ulp of bf16
UPDATE_TOL = {"float32": (1e-6, 1e-5), "bfloat16": (1e-2, 2e-2)}
# train phase, card vs the port's CPU path after 2 SGD steps at 1 x 256:
# losses within 1e-4 relative; parameters within 1e-5 absolute — f32
# gradients whose sums run in other orders (cuBLAS vs the CPU's GEMM, the
# flash kernels vs the plain einsums) differ in the last bits, scaled by
# lr 0.05 and momentum into the weights
TRAIN_LOSS_RTOL = 1e-4
TRAIN_PARAM_ATOL = 1e-5
# train phase, the bf16 fused step at the same size, card vs the port's
# CPU path in bf16: the two round to bf16 at the same places but from sums
# in other orders, so a value near a rounding point lands an ulp apart,
# as the CPU's bf16 lands from its f32. The losses and the parameters must
# lie within TRAIN_BF16_SPREAD times the CPU's own bf16-to-f32 distance
# (tools/train_bf16_spread.py measures both distances on the CPU). A card
# that computed the step in f32 would lie that distance from the CPU's
# bf16, 1x, and the parameters' distance is an ulp of the largest weights
# either way, so it cannot tell the two apart; the losses can: the sound
# card reads 0.30x (PERF.md), the f32 control 1.0x. So the losses are
# held to TRAIN_BF16_LOSS times the distance, between the two, and the
# phase runs the control through the same comparison: it must fail
TRAIN_BF16_SPREAD = 1.5
TRAIN_BF16_LOSS = 0.6
# conv_wgrad, kernel vs plain: max |error| / max |plain dW|. Both sum the
# same f32 products (bf16 operands widen exactly) over L = N*OH*OW, up to
# 100,352 terms, in other orders: a few f32 ulps of the largest sums
WGRAD_RTOL = 2e-5
# the terms of ResNet-50's largest wgrad sum (L = 32 * 56 * 56), for which
# WGRAD_RTOL holds; a longer sum's f32 rounding grows as the square root
# of its terms (wgrad_rtol)
WGRAD_RTOL_TERMS = 32 * 56 * 56


def wgrad_rtol(terms):
    """conv_wgrad's gate (of max |dW|) for sums of ``terms`` products:
    WGRAD_RTOL up to ResNet-50's longest sum, then growing as
    sqrt(terms)."""
    return WGRAD_RTOL * max(1.0, math.sqrt(terms / WGRAD_RTOL_TERMS))


# (input H, C = K, stride) of ResNet-50's 3x3 convolutions -> how many of
# each one step runs (3 + 1 + 3 + 1 + 5 + 1 + 2 = 16)
RESNET_WGRAD = {(56, 64, 1): 3, (56, 128, 2): 1, (28, 128, 1): 3,
                (28, 256, 2): 1, (14, 256, 1): 5, (14, 512, 2): 1,
                (7, 512, 1): 2}
# resnet phase, card vs the port's CPU path (ResNet-50, 2 batches of 2).
# A randomly initialized ResNet-50 at batch 2 is chaotic under rounding:
# a ReLU input within rounding of 0 takes the other branch, and batch
# norm's backward spreads that element over its channel, so the first
# update already differs by percents between any two f32 orders of
# summation, and the second starts from those different weights
# (tools/resnet_spread.py measures f32 against f64 on the CPU). So the
# gates are: after batch 1, each parameter's update within RESNET_UPDATE
# of the CPU's (L2 norm of the difference over the norm of the update), each
# aux state's change within RESNET_AUX, the cross-entropy within
# RESNET_CE[0] (relative) and the accuracy equal; after batch 2 the
# cross-entropy within RESNET_CE[1]. The batch-2 updates are printed.
RESNET_UPDATE = 0.15
RESNET_AUX = 2e-3
RESNET_CE = (1e-4, 1e-2)
# the 35-step scan through the kernel vs the plain scan, f32: the step's
# last-bit differences carried through 35 recurrences
LSTM_SCAN_TOL = (1e-4, 1e-4)
# (N, H) of lstm_step: the LSTM LM's batch 128 and its check's batch 8 at
# H 512, the bucketing run's batch 32, bench_lstm.py's default (32, 256),
# and two shapes the reference's use_for refuses (H not a multiple of 128,
# N not of 8); 200 is lstm-lm's default width
LSTM_CASES = ((128, 512), (8, 512), (32, 512), (32, 256), (4, 8), (3, 200))
# the bucketing phase's step: (batch, hidden), f32, in the scan's layout
BUCKET_STEP = (BUCKETING["batch"], BUCKETING["hidden"])
# lstm phase, card vs the port's CPU path (the LSTM LM, 2 batches of 8):
# after each batch, each parameter's update within LSTM_UPDATE (L2 norm of
# the difference over the norm of the CPU's update) and the perplexity
# within LSTM_PPL (relative). The LSTM has no ReLU ties: f32 against f64 on
# the CPU (tools/lstm_spread.py) moves the updates by at most 6.5e-6 and
# the perplexity by 7e-9, so the gates leave 15x and 100x of room for two
# f32 orders of summation while a wrong kernel moves updates by order 1
LSTM_UPDATE = 1e-4
LSTM_PPL = 1e-6
# zoo phase: Monitor's statistics (norm / sqrt(size) of each array) card
# against the CPU, relative; nd.norm card against the CPU, relative (f32
# sums in another order: ~sqrt(n) ulps of 6e-8 at 36k elements)
MONITOR_RTOL = 1e-5
NORM_RTOL = 1e-5
# zoo phase, card vs CPU: a run whose f32-against-f64 perplexity spread
# after a batch of the check (``python3 -m mxnet_tpu_torch.tools.
# lstm_spread zoo``, on the card machine's CPU) exceeds LSTM_PPL / 1.5 is
# gated at 1.5 x that spread (Ftrl: its |z| > lamda1 threshold keeps few,
# small weights, whose relative rounding it magnifies)
ZOO_PPL_SPREAD = {"ftrl": 1.5975279102102806e-06}


# image_zoo phase, card vs the port's CPU path (each of the seven models,
# 2 batches of 2, f32, Dropout at p = 0): the resnet check's gates, each
# at IMAGE_ZOO_GATE x that model's f32-vs-f64 distance on the CPU, the
# largest over 3 seeds (IMAGE_ZOO_SPREAD: ``python3 -m
# mxnet_tpu_torch.tools.image_zoo_spread`` on the card machine's CPU),
# after batch 1 (the worst update but for the dead shifts, the worst aux
# change) and after batches 1 and 2 (the cross-entropy), each widened by
# the model's IMAGE_ZOO_WITNESS where it exceeds 1: how much farther from
# f64 the library's f32 convolutions lie on the card (cuDNN) than on the
# CPU over the model's own convolution calls, the largest of the forward,
# dX and dW ratios, measured without the port (``image_zoo_spread
# --witness`` on the card; PERF.md). The cross-entropy's gate is
# at least IMAGE_ZOO_CE_FLOOR, about 3.5 ulps of an f32 cross-entropy near
# 6.9 (the metric's own resolution)
IMAGE_ZOO_GATE = 1.5
IMAGE_ZOO_CE_FLOOR = 4 * 2.0 ** -24
IMAGE_ZOO_SPREAD = {
    "alexnet": {
        "update": 0.0028486414124155477, "aux": 0.0,
        "ce": (1.6991735654704696e-08, 2.726250164201693e-07)},
    "vgg16": {
        "update": 0.006246602466928887, "aux": 0.0,
        "ce": (4.8042826349639246e-08, 2.4580626732362034e-08)},
    "googlenet": {
        "update": 0.005885466620669831, "aux": 0.0,
        "ce": (2.9544754333265565e-08, 2.2610283014236122e-08)},
    "inception-bn": {
        "update": 0.0261327235789029, "aux": 7.0687396111397956e-06,
        "ce": (1.6380520238286315e-07, 0.0022391260737797355)},
    "inception-v3": {
        "update": 0.04373015704367453, "aux": 2.2265085954758954e-05,
        "ce": (2.368150675539085e-07, 0.006171068180415605)},
    "inception-resnet-v2": {
        "update": 0.0378220780103155, "aux": 2.998110723984614e-05,
        "ce": (2.2702663294135004e-07, 0.0030121412090460507)},
    "resnext-50": {
        "update": 0.026753049803989855, "aux": 3.2321451530391084e-05,
        "ce": (1.9806044397669357e-06, 0.0023749777448621966)},
}
IMAGE_ZOO_WITNESS = {
    "alexnet": 3.0042834677273413,
    "vgg16": 3.9855396169971042,
    "googlenet": 1.9502664257960076,
    "inception-bn": 2.1509733070923875,
    "inception-v3": 2.4920103244088487,
    "inception-resnet-v2": 1.9104542027056515,
    "resnext-50": 1.2957730866515609,
}
# ssd phase, the card-vs-CPU check of ssd-vgg16 (f32, 2 batches of 2 at
# 300 x 300): IMAGE_ZOO_GATE x its f32-vs-f64 distance on the card
# machine's CPU, the largest over 3 seeds (``image_zoo_spread
# ssd-vgg16``), x SSD_WITNESS where it exceeds 1 (``image_zoo_spread
# --witness ssd-vgg16`` on the card: the library's f32 convolutions
# alone); the cross-entropy's and the smooth L1's at least
# IMAGE_ZOO_CE_FLOOR
SSD_SPREAD = {"update": 0.0031823994279595647,
              "ce": (8.923697830972527e-10, 1.8999707874949643e-10),
              "smooth_l1": (7.144703715672134e-08, 1.6545086389912105e-07)}
SSD_WITNESS = 3.268515427240454
# matching and NMS are discontinuous: a class target or mask may differ
# only at an anchor whose best IoU lies within SSD_IOU_MARGIN of the
# overlap threshold or whose two best ground truths lie within
# SSD_TIE_MARGIN; a keep mask only after a choice among scores within
# SSD_SCORE_MARGIN or at an IoU within SSD_IOU_MARGIN of nms_threshold;
# the decoded boxes and scores within SSD_DECODE_ATOL
SSD_IOU_MARGIN = 1e-5
SSD_TIE_MARGIN = 1e-6
SSD_SCORE_MARGIN = 1e-6
SSD_DECODE_ATOL = 1e-5
# image_zoo phase, the new ops on the card against their CPU path: a
# "close" op's outputs (libm, sums in another order) within ZOO_OP_RTOL
# of the largest output; every gradient (scatter-adds, sums) within
# ZOO_GRAD_RTOL of its largest entry
ZOO_OP_RTOL = 1e-5
ZOO_GRAD_RTOL = 1e-5


def zoo_ppl_tol(run):
    return max(LSTM_PPL, 1.5 * ZOO_PPL_SPREAD.get(run, 0.0))
RTC_SRC = "mxnet_tpu_torch/tools/rtc_softmax.py"
RTC_REPLACES = "mxnet_tpu/rtc.py:77"
# serve and serve_paged phases: the served logits against the plain path
# on the CPU (first tokens), and the paged programs against the unpaged
# ones teacher-forced (f32 on the card): within SERVE_ATOL; the argmax
# equal wherever the unpaged top-2 margin exceeds PAGED_MARGIN (the
# unpaged prefill runs the flash kernel, the paged one an einsum, so a
# near-tie may flip)
SERVE_ATOL = 1e-3
PAGED_MARGIN = 2e-3
# serve_paged, int8 KV teacher-forced against f32 (captured, paged and
# unpaged): the argmax in the f32 top 5 at every step and every logit
# within INT8_KV_TOL = 1.5 x the f32-to-int8 distance that
# tools/kv_int8_spread.py measures on the CPU at this width (PERF.md: on
# the H100 host's 8 cores, torch 2.11.0+cu128)
INT8_KV_SPREAD = 0.004024982452392578
INT8_KV_TOL = 1.5 * INT8_KV_SPREAD
# serve_spec: each greedy speculative stream equals the vanilla stream of
# its KV layout and type, token for token, but that the first difference
# may fall where the vanilla run's top-2 margin is at most PAGED_MARGIN
# (the verify sums in another order than the decode step); the verify fed
# a vanilla stream as windows gives its decode logits within SERVE_ATOL;
# the self draft accepts at least SPEC_SELF_ACCEPT of its drafts (the
# reference's test's bound); the int8 draft's accept rate is printed
# beside SPEC_INT8_ACCEPT_PREDICTED, the prediction in PERF.md
SPEC_SELF_ACCEPT = 0.8
SPEC_INT8_ACCEPT_PREDICTED = 0.65
# serve_spec, quant_weights arms teacher-forced against f32 (captured):
# the argmax in the f32 top 5 at every step and every logit within
# QUANT_WEIGHTS_TOL = 1.5 x the arm's f32 distance that
# tools/quant_weights_spread.py measures on the CPU at this width (PERF.md:
# on the H100 host's 8 cores)
QUANT_WEIGHTS_SPREAD = {"int8": 0.10994094610214233,
                        "fp8": 0.2456832230091095}
QUANT_WEIGHTS_TOL = {k: 1.5 * v for k, v in QUANT_WEIGHTS_SPREAD.items()}
# serve_fixed, ResNet-50 behind InferenceServer: each request's outputs
# (softmax probabilities) within RESNET_PREDICT_TOL of the same request
# alone through a Predictor on the card (and, for two, on the CPU), = 1.5 x
# the f32-to-f64 distance tools/resnet_predict_spread.py measures over the
# same requests: the larger of its run on the CPU (2.84e-10, the H100
# host's 8 cores) and on the card (4.29e-10: the card's f32 convolutions
# sit farther from f64 than the CPU's); the int8 arm within
# RESNET_INT8_TOL = 1.5 x that tool's int8-to-f32 distance (the same on
# both), the same top-1 wherever the f32 margin exceeds 2 x
# RESNET_INT8_TOL (PERF.md)
RESNET_PREDICT_SPREAD_CPU = 2.844717174495248e-10
RESNET_PREDICT_SPREAD = max(RESNET_PREDICT_SPREAD_CPU, 4.2879703585595175e-10)
RESNET_PREDICT_TOL = 1.5 * RESNET_PREDICT_SPREAD
RESNET_INT8_SPREAD = 2.5051413103938103e-06
RESNET_INT8_TOL = 1.5 * RESNET_INT8_SPREAD
# quantized_matmul on the card against its CPU path on the same operands:
# the int8-activation path bit for bit (int32 sums are exact); dequant on
# load within QMM_F32_RTOL of the largest |output| (f32) or one bf16 ulp
# of it (bf16)
QMM_F32_RTOL = 1e-5
# mx.rtc test kernels (the JAX package's tests' axpy, inc and relu, and axpy
# in bf16) in CUDA C: the kernel body of each and its mode="torch" twin.
# Each body runs with ``N`` (the element count) and ``i`` (the thread's
# element) defined; see rtc_elementwise_src
RTC_ELEMENTWISE = {
    "axpy": (("x", "y"), "out[i] = x[i] * 2.0f + y[i];",
             "def fn(x, y):\n    return x * 2.0 + y\n", "float32"),
    "inc": (("x",), "out[i] = x[i] + 1.0f;",
            "def fn(x):\n    return x + 1.0\n", "float32"),
    "relu": (("x",), "out[i] = fmaxf(x[i], 0.0f);",
             "def fn(x):\n    return torch.clamp(x, min=0.0)\n", "float32"),
    "axpy_bf16": (("x", "y"), "out[i] = __float2bfloat16("
                  "__bfloat162float(x[i]) * 2.0f + __bfloat162float(y[i]));",
                  "def fn(x, y):\n"
                  "    return (x.float() * 2.0 + y.float()).to(torch.bfloat16)"
                  "\n", "bfloat16")}
# the shapes each test kernel runs at: the JAX tests' (8, 16), and one of
# many blocks
RTC_ELEMENTWISE_SHAPES = ((8, 16), (1024, 1000))
# test kernels vs their twins (rtol): f32 the same one-rounding arithmetic
# (x * 2 is exact), so within 1e-6 relative; bf16 within one bf16 ulp,
# which is at most 2^-7 of |x|
RTC_TOL = {"float32": 1e-6, "bfloat16": 2.0 ** -7}
# rtc_softmax kernels vs their twins on probabilities and gradients in
# [-1, 1]: a sum of up to 10000 exps in another order differs by a few f32
# ulps of the sum, so each value within 1e-6 absolute and, since most of
# the LM's probabilities are near 1e-6 themselves, within 1e-5 relative
# (above a 1e-9 floor); and each row of probabilities sums to 1 within 1e-5
# (summed in f64). The backward copies p and subtracts 1 in f32 on both
# sides, so it agrees exactly
RTC_SOFTMAX_ATOL = 1e-6
RTC_SOFTMAX_RTOL = 1e-5
RTC_SOFTMAX_FLOOR = 1e-9
RTC_SOFTMAX_ROW_SUM = 1e-5
# (rows, classes) of rtc_softmax: the LSTM LM's 128 x 35 rows over its
# 10000 classes, a narrower head, one row, and a row narrower than a warp
RTC_SOFTMAX_CASES = ((4480, 10000), (128, 1000), (1, 10000), (3, 7))
# the backward's route (rtc_softmax.bwd_plan) these cases must take: the
# LM's head the vector source, a row of 7 the scalar one
RTC_BWD_ROUTES = {(4480, 10000): "vector", (3, 7): "scalar"}


# serve_trace: the trace events that stand for the flash forward's
# launches (category, part of the kernel's name)
FA_EVENT = ("kernel", "flash_fwd_")
# the train and resnet runs under the profiler: launch counter -> parts of
# the names of the kernels it launches
TRAIN_EVENTS = {"flash_attention_fwd": ("flash_fwd_",),
                "flash_attention_bwd_dq": ("flash_bwd_dq_",),
                "flash_attention_bwd_dkv": ("flash_bwd_dkv_",),
                "sgd_mom_update": ("sgd_mom_kernel",),
                "adam_update": ("adam_kernel",)}
RESNET_EVENTS = {"conv_wgrad_partial": ("conv_wgrad_wgmma_kernel",
                                        "conv_wgrad_f32_kernel",
                                        "conv_wgrad_f32tap_kernel",
                                        "conv_wgrad_simt_kernel"),
                 "conv_wgrad_reduce": ("conv_wgrad_reduce_kernel",),
                 "conv_wgrad_repack": ("conv_wgrad_repack_kernel",),
                 "sgd_mom_update": ("sgd_mom_kernel",)}
# spans-on overhead a captured decode step, predicted before the first
# chip run (PERF.md): about four spans a step at a few microseconds each
SPAN_OVERHEAD_PREDICTED_US = 50
# the whole script's watchdog (s): its time limit is 1200 s
WATCHDOG_S = 1100
#: the dist phase's limit on each group of worker processes (start-up,
#: CUDA context, 8 batches at full width): past it the phase fails
DIST_CHILD_S = 150
# a sample line of the Prometheus text format (name, labels, value, and an
# optional OpenMetrics exemplar)
PROM_SAMPLE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*="([^"\\\n]|'
    r'\\[\\"n])*",?)*\})?) (NaN|[-+]?[0-9.e+-]+|[-+]Inf)'
    r'( # \{trace_id="[^"]*"\} [-+0-9.e]+ [0-9.e+]+)?$')


def flash_cases():
    """Cases (b, h, hkv, tq, tk, d, causal, dtype, layout) of both flash
    kernels (layouts: see :func:`_randn`): the serve and train shapes (T up
    to 2048 at batch 1, and the training shape at batch 4), each as
    (B, T, H, D)-storage views like those ``MultiHeadAttention`` passes;
    MHA; tq < tk; head_dim 64. Then the edges of the forward's tiles (128
    query rows; 128 bf16 or 64 f32 keys): lengths of 1, 63, 65, 129 and
    2047, a ragged causal tq < tk, head_dim 64 at a length no multiple of
    128, B * H = 64, and rows whose T stride is no multiple of 16 bytes
    (the forward wrapper copies them). Last, the train phase's own case
    (:func:`train_main_case`, bf16 at batch 32)."""
    cases = []
    for dtype in ("float32", "bfloat16"):
        cases += [(1, 16, 4, t, t, 128, True, dtype, True)
                  for t in (128, 512, 1000, 2048)]
        cases += [(1, 16, 4, 2048, 2048, 128, True, dtype, False),
                  (4, 16, 4, 2048, 2048, 128, True, dtype, False),
                  (1, 16, 16, 512, 512, 128, False, dtype, True),
                  (1, 16, 4, 300, 1000, 128, True, dtype, True),
                  (2, 8, 2, 777, 777, 64, True, dtype, True)]
        cases += [(1, 16, 4, t, t, 128, True, dtype, True)
                  for t in (1, 63, 65, 129, 2047)]
        cases += [(2, 16, 4, 129, 515, 128, True, dtype, False),
                  (1, 16, 4, 1000, 1000, 64, True, dtype, False),
                  (4, 16, 4, 256, 256, 128, True, dtype, True),
                  (1, 16, 4, 300, 300, 128, True, dtype, "padded")]
    return cases + [train_main_case()]


def train_main_case():
    """The flash case of the train phase's main path: its batch and
    length, the LM's heads, its type, the (B, T, H, D) views."""
    return (TRAIN["batch"], LM["heads"], LM["kv_heads"], TRAIN["seq"],
            TRAIN["seq"], LM["d_model"] // LM["heads"], True, TRAIN["dtype"],
            False)


def emit(obj):
    print(json.dumps(obj), flush=True)


# --- bounds and timing -------------------------------------------------------
def attention_bound(b, h, hkv, tq, tk, d, causal, dtype):
    """Least time (ms) for one forward on the card, and what bounds it:
    4*D flops per visible (query, key) pair and head (QK^T and PV, the
    causal count exact), and q/k/v read plus o written once each."""
    flops = 4 * b * h * d * visible_pairs(tq, tk, causal)
    item = 4 if dtype == "float32" else 2
    nbytes = item * (2 * b * h * tq * d + 2 * b * hkv * tk * d)
    peak = H100["f32_flops"] if dtype == "float32" else H100["bf16_flops"]
    t_ops, t_bytes = flops / peak, nbytes / H100["bytes_per_s"]
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def visible_pairs(tq, tk, causal):
    """(query, key) pairs a causal (offset tk - tq) or full mask keeps."""
    if not causal:
        return tq * tk
    return int(np.minimum(tk, np.arange(tq) + (tk - tq) + 1).sum())


def attention_bwd_bound(b, h, hkv, tq, tk, d, causal, dtype, per_pair=10):
    """Least time (ms) for one flash backward, and what bounds it: 10*D
    flops per visible pair and head (q.k recomputed, dO.v, and the
    products into dQ, dK, dV), and q/k/v/o/dO read, dQ/dK/dV written
    once, plus the f32 lse read. ``per_pair`` = 14 or 20 gives the least
    time of the work the kernels do (``FA_BWD_WORK``)."""
    flops = per_pair * b * h * d * visible_pairs(tq, tk, causal)
    item = 4 if dtype == "float32" else 2
    nbytes = item * (4 * b * h * tq * d + 4 * b * hkv * tk * d) \
        + 4 * b * h * tq
    peak = H100["f32_flops"] if dtype == "float32" else H100["bf16_flops"]
    t_ops, t_bytes = flops / peak, nbytes / H100["bytes_per_s"]
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def update_bound(kind, elements, item=4):
    """Least time (ms) for one update pass over ``elements``: each reads
    w, g and the state(s) once and writes w and the state(s) once."""
    per = {"sgd_mom_update": 5, "adam_update": 7}[kind] * item
    return elements * per / H100["bytes_per_s"] * 1e3, "bytes"


def wgrad_bound(n, h, c, k, ksz, stride, dtype, pad=None):
    """Least time (ms) for one dW of a (ksz, stride, pad) conv on square
    images (pad None: SAME, (ksz - 1) // 2): 2 flops per (output position,
    c, k, tap), and x and dy read plus dW (f32) written once."""
    if pad is None:
        pad = (ksz - 1) // 2
    oh = (h + 2 * pad - ksz) // stride + 1
    flops = 2 * n * oh * oh * c * k * ksz * ksz
    item = 4 if dtype == "float32" else 2
    nbytes = item * (n * h * h * c + n * oh * oh * k) + 4 * ksz * ksz * c * k
    peak = H100["f32_flops"] if dtype == "float32" else H100["bf16_flops"]
    t_ops, t_bytes = flops / peak, nbytes / H100["bytes_per_s"]
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def lstm_step_bound(n, h, dtype):
    """Least time (ms) for one LSTM step, and what bounds it: 2 flops per
    (row, gate row, k) of h . Wh^T, and ib, h, c, Wh read plus h', c'
    written once."""
    flops = 2 * n * 4 * h * h
    item = 4 if dtype == "float32" else 2
    nbytes = item * (n * 4 * h + 2 * n * h + 4 * h * h + 2 * n * h)
    peak = H100["f32_flops"] if dtype == "float32" else H100["bf16_flops"]
    t_ops, t_bytes = flops / peak, nbytes / H100["bytes_per_s"]
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def lstm_layer_bound(t, n, i, h):
    """Least time (ms) for one f32 LSTM layer over t steps: the input
    projection and the t recurrent products, x, the weights and biases
    and h0 / c0 read and the outputs and final states written once."""
    flops = 2 * t * n * 4 * h * (i + h)
    nbytes = 4 * (t * n * i + 4 * h * (i + h) + 8 * h + 2 * n * h
                  + t * n * h + 2 * n * h)
    t_ops, t_bytes = (flops / H100["f32_flops"],
                      nbytes / H100["bytes_per_s"])
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def rtc_softmax_bound(rows, cols):
    """Least time (ms) of one rtc_softmax forward (or backward) at (rows,
    cols) f32: the logits (probabilities) read and the probabilities
    (gradients) written once; the backward's labels add rows * 4 bytes."""
    return 2 * 4 * rows * cols / H100["bytes_per_s"] * 1e3, "bytes"


def rtc_elementwise_src(body, n):
    """A test kernel's CUDA body over ``n`` elements: one thread each."""
    return ("const int N = %d;\n"
            "const int i = blockIdx.x * blockDim.x + threadIdx.x;\n"
            "if (i < N) { %s }\n" % (n, body))


def time_ms(torch, fn, reps=30, warmup=3):
    """Median of ``reps`` single-call CUDA-event timings."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _device_events(torch, fn, reps, warmup, calls=None):
    """The CUDA events of a ``torch.profiler`` trace of ``reps`` calls of
    ``fn()``, after ``warmup`` untraced ones. A trace that shows no device
    time, or (``calls``: {name part: launches a call}) fewer or more
    launches of a kernel than ``fn`` makes, lost events: it is taken
    again, five times at most. Each trace opens and closes with a short
    spin kernel, left out of the events: traces of whole runs of this
    script have lost one launch a trace, five traces in a row, where
    traces of the same phase alone lost none."""
    prof_mod = torch.profiler
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _attempt in range(5):
        with prof_mod.profile(activities=[prof_mod.ProfilerActivity.CPU,
                                          prof_mod.ProfilerActivity.CUDA]) \
                as p:
            torch.cuda._sleep(1000)
            for _ in range(reps):
                fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        events = [e for e in p.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "spin_kernel" not in e.key]
        seen = {part: sum(e.count for e in events if part in e.key)
                for part in (calls or {})}
        if sum(e.self_device_time_total for e in events) > 0 and \
                all(seen[part] == n * reps for part, n in (calls or
                                                           {}).items()):
            return events
    raise RuntimeError("the profiler saw no device time, or lost launches "
                       "(%s of %s a call)" % (seen, calls))


def device_ms(torch, fn, reps=20, warmup=3):
    """Device time (ms) of one ``fn()`` call: the summed time of every
    kernel it launches, from a ``torch.profiler`` trace of ``reps`` calls.
    Unlike :func:`time_ms` it leaves out the gaps while the host enqueues,
    which dominate a call whose kernels take microseconds."""
    events = _device_events(torch, fn, reps, warmup)
    return sum(e.self_device_time_total for e in events) / reps / 1e3


def device_ms_by(torch, fn, by, reps=20, warmup=3, calls=None):
    """:func:`device_ms` of one ``fn()`` call, and {label: ms} of the
    kernels whose names hold ``by[label]``; ``calls`` as for
    :func:`_device_events`."""
    events = _device_events(torch, fn, reps, warmup, calls)
    return (sum(e.self_device_time_total for e in events) / reps / 1e3, {
        label: sum(e.self_device_time_total for e in events
                   if part in e.key) / reps / 1e3
        for label, part in by.items()})


def loop_ms(torch, fn, calls=20, reps=10, warmup=2):
    """Median CUDA-event time (ms) of one ``fn()`` call, from runs of
    ``calls`` calls back to back: for kernels longer than the host's
    enqueue the queue stays full, so the host's time per call drops out."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def graph_ms(torch, fn, calls=35, reps=20):
    """Median CUDA-event time (ms) of one ``fn()`` call, from replays of a
    CUDA graph of ``calls`` calls (a scan's 35 steps): the host's enqueue
    stays out of the timed region, the device's gaps between kernels stay
    in."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return time_ms(torch, graph.replay, reps) / calls


def _times(torch, fns, reps=20):
    """{name: device ms} of each (name, fn), and {name: CUDA-event ms}
    of single calls, the host's enqueue included."""
    return ({k: device_ms(torch, f, reps) for k, f in fns},
            {k: time_ms(torch, f, reps) for k, f in fns})


# --- phases ------------------------------------------------------------------
def phase_build():
    from mxnet_tpu_torch.ops.kernels import _build

    t0 = time.time()
    paths = _build.build_all()
    emit({"phase": "build", "seconds": time.time() - t0,
          "libraries": {k: os.path.relpath(v) for k, v in paths.items()},
          "nvcc": _build.nvcc(),
          "ptxas": {k: [ln for ln in v.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for k, v in _build.build_log.items()},
          "gpu": nvidia_smi()})


# the layouts of _randn, by name
LAYOUTS = {True: "bhtd", False: "bthd view",
           "padded": "bhtd view, rows padded to D + 1"}


def _randn(torch, b, heads, t, d, dtype, gen, layout=True):
    """A seeded (b, heads, t, d) tensor. ``layout`` True: contiguous;
    False: (B, T, H, D) storage seen through ``transpose(1, 2)``, the
    strided views prefill and ``MultiHeadAttention`` pass; "padded":
    (b, heads, t, d + 1) storage cut to d, whose T stride is no multiple
    of 16 bytes."""
    dt = getattr(torch, dtype)
    if layout == "padded":
        return torch.randn(b, heads, t, d + 1, generator=gen,
                           device="cuda").to(dt)[..., :d]
    if layout:
        return torch.randn(b, heads, t, d, generator=gen, device="cuda").to(dt)
    return torch.randn(b, t, heads, d, generator=gen,
                       device="cuda").to(dt).transpose(1, 2)


def _qkv(torch, b, h, hkv, tq, tk, d, dtype, gen, layout=True):
    """Seeded q/k/v in ``layout`` (see _randn)."""
    return (_randn(torch, b, h, tq, d, dtype, gen, layout),
            _randn(torch, b, hkv, tk, d, dtype, gen, layout),
            _randn(torch, b, hkv, tk, d, dtype, gen, layout))


def ptxas_report(log, names):
    """{"<name><D>": {"registers", "smem_static", "stack", "spill_stores",
    "spill_loads"}} of each instantiation of the ``__global__`` functions
    ``names`` (templated on one int), parsed from ``nvcc -Xptxas -v``
    output."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            cur = kernel_label(m.group(1), names)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out.setdefault(cur, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            out.setdefault(cur, {}).update(
                registers=int(m.group(1)),
                smem_static=int(smem.group(1)) if smem else 0)
    return out


def kernel_label(mangled, names):
    """``name<D>`` (``name<A,B>`` for several int template arguments) for
    a mangled instantiation of one of ``names``, else None."""
    for name in names:
        m = re.search(name + r"I((?:Li\d+E)+)E", mangled)
        if m:
            return "%s<%s>" % (name, ",".join(
                re.findall(r"Li(\d+)E", m.group(1))))
    return None


def sass_counts(lib, names, opcodes):
    """{"<name><D>": {opcode: count}} in the SASS of library ``lib``
    (``cuobjdump -sass``, from PATH or ``$CUDA_HOME/bin``)."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    return sass_opcode_counts(sass, names, opcodes)


def sass_opcode_counts(sass, names, opcodes):
    """The counting of :func:`sass_counts` over cuobjdump's text."""
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            cur = kernel_label(m.group(1), names)
            if cur is not None:
                out[cur] = dict.fromkeys(opcodes, 0)
            continue
        if cur is not None:
            for op in opcodes:
                if re.search(r"\b%s\b" % op, line):
                    out[cur][op] += 1
    return out


def wgmma_serialized(log, names):
    """{"<name><D>": count} of ptxas's C7515 / C7520 notes ("wgmma ...
    serialized") naming each instantiation of ``names`` in ``log``."""
    out = {}
    for line in log.splitlines():
        if "wgmma" not in line or not re.search(r"C75(15|20)", line):
            continue
        m = re.search(r"'(_Z\w+)'", line)
        label = kernel_label(m.group(1), names) if m else None
        if label is not None:
            out[label] = out.get(label, 0) + 1
    return out


def instantiation_report(log, sass, kernels, head_dims, smem_of):
    """Each instantiation of ``kernels`` ({__global__ name: dtype}) at each
    head dim: its registers, shared memory (static from the ptxas ``log``,
    dynamic from ``smem_of(name, dtype, d)``), spills, ptxas's wgmma
    serialization notes and its HGMMA / UTMALDG counts (``sass``, from
    :func:`sass_opcode_counts`). Fails when an instantiation is missing
    from the log, a bf16 one lacks wgmma or TMA loads, or an f32 one
    spills."""
    names = tuple(kernels)
    ptxas = ptxas_report(log, names)
    serial = wgmma_serialized(log, names)
    report = {}
    for name, dtype in kernels.items():
        for d in head_dims:
            label = "%s<%s>" % (name, d)
            row = dict(ptxas.get(label, {}), dtype=dtype,
                       smem_dynamic=smem_of(name, dtype, d),
                       sass=sass.get(label, {}),
                       wgmma_serialized=serial.get(label, 0))
            if "registers" not in row:
                raise RuntimeError("no ptxas report for %s" % label)
            if dtype == "bfloat16" and not all(
                    row["sass"].get(op, 0) > 0 for op in FA_BF16_OPCODES):
                raise RuntimeError("%s lacks %s in its SASS: %s"
                                   % (label, FA_BF16_OPCODES, row["sass"]))
            if dtype == "float32" and (row["spill_stores"]
                                       or row["spill_loads"]):
                raise RuntimeError("%s spills: %s" % (label, row))
            report[label] = row
    return report


def flash_report(lib, kernels, smem_of):
    """:func:`instantiation_report` of library ``lib``'s build log and
    SASS (``cuobjdump``)."""
    from mxnet_tpu_torch.ops.kernels import _build
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa

    sass = sass_counts(_build.lib_path(lib), tuple(kernels), FA_BF16_OPCODES)
    return instantiation_report(_build.log_of(lib), sass, kernels,
                                fa.HEAD_DIMS, smem_of)


def flash_fwd_report(torch):
    """The forward's instantiations (:func:`instantiation_report`)."""
    import ctypes

    from mxnet_tpu_torch.ops.kernels import _build
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa

    smem = _build.kernel(fa._NAME, "mxtt_flash_attention_fwd_smem",
                         [ctypes.c_int, ctypes.c_int])
    return flash_report(fa._NAME, FA_KERNELS, lambda name, dtype, d:
                        smem(fa._DTYPE_CODE[getattr(torch, dtype)], d))


def flash_bwd_report(torch):
    """The backward's instantiations, dQ and dK/dV per type
    (:func:`instantiation_report`)."""
    import ctypes

    from mxnet_tpu_torch.ops.kernels import _build
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa

    smem = _build.kernel(fa._BWD_NAME, "mxtt_flash_attention_bwd_smem",
                         [ctypes.c_int] * 3)
    return flash_report(fa._BWD_NAME, FA_BWD_KERNELS,
                        lambda name, dtype, d: smem(
                            0 if "_dq_" in name else 1,
                            fa._DTYPE_CODE[getattr(torch, dtype)], d))


def phase_kernel(torch):
    """Flash forward: its instantiations' build and SASS report; kernel vs
    plain on the card, without the lse (the serve path's call) and with it
    (the train path's); then timings of both types at the serve and the
    train shape, in the (B, T, H, D) views those paths pass."""
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa

    instantiations = flash_fwd_report(torch)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results, worst, main_err = [], {}, None
    for case in flash_cases():
        b, h, hkv, tq, tk, d, causal, dtype, layout = case
        q, k, v = _qkv(torch, b, h, hkv, tq, tk, d, dtype, gen, layout)
        copied = any(fa.tensor_map_plan(t)[1] for t in (q, k, v))
        if copied != (layout == "padded"):
            raise RuntimeError("layout %s: the wrapper would%s copy"
                               % (LAYOUTS[layout], "" if copied else " not"))
        got = fa.flash_attention(q, k, v, causal=causal)
        o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
        want, want_lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                                  return_lse=True)
        torch.cuda.synchronize()
        errs = []
        atol, rtol = TOL[dtype]
        for g, w in ((got, want), (o, want), (lse, want_lse)):
            torch.testing.assert_close(g.float(), w.float(),
                                       atol=atol, rtol=rtol)
            errs.append(float((g.float() - w.float()).abs().max()))
        results.append({"shape": [b, h, hkv, tq, tk, d], "causal": causal,
                        "dtype": dtype, "layout": LAYOUTS[layout],
                        "copied": copied, "atol": atol, "rtol": rtol,
                        "max_abs_err": {"o": errs[0], "o_with_lse": errs[1],
                                        "lse": errs[2]}})
        worst[dtype] = max([worst.get(dtype, 0.0)] + errs)
        if case == train_main_case():
            main_err = results[-1]["max_abs_err"]
        del q, k, v, got, o, lse, want, want_lse
        torch.cuda.empty_cache()

    timings = {}
    # serve, train at batch 4 (the rows of earlier PRs), and the train
    # phase's own batch in its type (bf16)
    for where, b, dtypes in (("serve", 1, ("float32", "bfloat16")),
                             ("train", 4, ("float32", "bfloat16")),
                             ("train_main", TRAIN["batch"],
                              (TRAIN["dtype"],))):
        timings[where] = {}
        for dtype in dtypes:
            h, hkv, t, d = 16, 4, 2048, 128
            q, k, v = _qkv(torch, b, h, hkv, t, t, d, dtype, gen, False)
            bound_ms, bound_by = attention_bound(b, h, hkv, t, t, d, True,
                                                 dtype)
            kernel = functools.partial(fa.flash_attention, q, k, v,
                                       causal=True)
            library = _sdpa(torch, q, k, v)
            timings[where][dtype] = {
                "shape": [b, h, hkv, t, t, d], "causal": True,
                "layout": LAYOUTS[False],
                "ms": time_ms(torch, kernel),
                "plain_ms": time_ms(torch, lambda: fa.flash_attention_plain(
                    q, k, v, causal=True), reps=10),
                "library_ms": time_ms(torch, library),
                # the kernels alone, without the host's enqueue
                "device_ms": device_ms(torch, kernel),
                "library_device_ms": device_ms(torch, library),
                "bound_ms": bound_ms, "bound_by": bound_by}
            del q, k, v
            torch.cuda.empty_cache()
    timings["train_main"][TRAIN["dtype"]]["main_path_max_abs_err"] = main_err
    emit({"phase": "kernel", "kernel": "flash_attention_fwd",
          "instantiations": instantiations, "cases": results,
          "max_abs_err": worst, "timings": timings})
    return worst, timings


def _sdpa(torch, q, k, v):
    """The library yardstick: one scaled_dot_product_attention call (GQA
    native from torch 2.5; before that the kv heads are repeated up front,
    outside the timed call). Timed only; the port never calls it."""
    F = torch.nn.functional
    major, minor = (int(x) for x in torch.__version__.split(".")[:2])
    if (major, minor) >= (2, 5):
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)
    g = q.shape[1] // k.shape[1]
    kr, vr = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    return lambda: F.scaled_dot_product_attention(q, kr, vr, is_causal=True)


def _sdpa_bwd(torch, q, k, v, do):
    """The library yardstick of the backward: autograd through one
    :func:`_sdpa` call, the graph kept between calls. Timed only; the
    port never calls it."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = _sdpa(torch, *leaves)()
    return lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)


def bwd_timing(torch, shape, dtype, kernel, plain, library,
               timers=(time_ms, device_ms, device_ms_by)):
    """One timing row of the backward at ``shape`` (b, h, hkv, t, d,
    causal): single calls of the kernel pair (``kernel``), of the plain
    version and of the library yardstick (CUDA events, the host's enqueue
    included), the device times of the whole call (the torch pass for D
    included; the dQ and dK/dV kernels apart) and of the library's, beside
    the bound. ``work`` holds the least time of the work the kernels do
    (``FA_BWD_WORK``): this phase's line shows it, the kernels line not."""
    single, device, device_by = timers
    b, h, hkv, t, d, causal = shape
    bound_ms, bound_by = attention_bwd_bound(b, h, hkv, t, t, d, causal,
                                             dtype)
    work_ms, _ = attention_bwd_bound(b, h, hkv, t, t, d, causal, dtype,
                                     FA_BWD_WORK[dtype])
    dev, parts = device_by(torch, kernel, {"dq": "flash_bwd_dq",
                                           "dkv": "flash_bwd_dkv"})
    return {"shape": [b, h, hkv, t, t, d], "causal": causal,
            "layout": LAYOUTS[False],
            "ms": single(torch, kernel, reps=10),
            "plain_ms": single(torch, plain, reps=10),
            "library_ms": single(torch, library, reps=10),
            "device_ms": dev, "device_ms_by_kernel": parts,
            "library_device_ms": device(torch, library),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "work": {"flops_per_pair": {"bound": FA_BWD_WORK["bound"] * d,
                                        "kernels": FA_BWD_WORK[dtype] * d},
                     "ms": work_ms}}


def phase_kernel_bwd(torch):
    """Flash backward: its instantiations' build and SASS report; kernels
    vs plain on the card (same q/k/v/o/lse/dO into both), then timings at
    the training shape in the training layout. The train phase's case
    heads the kernels line's row: its errors go with its timing."""
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa

    instantiations = flash_bwd_report(torch)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    results, worst, main_err = [], {}, None
    for case in flash_cases():
        b, h, hkv, tq, tk, d, causal, dtype, layout = case
        q, k, v = _qkv(torch, b, h, hkv, tq, tk, d, dtype, gen, layout)
        o, lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                          return_lse=True)
        # dO in q's layout, as autograd hands it back through the views
        do = _randn(torch, b, h, tq, d, dtype, gen, layout)
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
        want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
        torch.cuda.synchronize()
        errs, typical = {}, {}
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            atol, rtol = BWD_TOL[dtype][name]
            torch.testing.assert_close(g.float(), w.float(), atol=atol,
                                       rtol=rtol, msg=lambda m, n=name: (
                                           "%s: %s" % (n, m)))
            errs[name] = float((g.float() - w.float()).abs().max())
            typical[name] = float(w.float().abs().median())
        results.append({"shape": [b, h, hkv, tq, tk, d], "causal": causal,
                        "dtype": dtype, "layout": LAYOUTS[layout],
                        "tol": BWD_TOL[dtype], "max_abs_err": errs,
                        "median_abs": typical})
        worst[dtype] = max([worst.get(dtype, 0.0)] + list(errs.values()))
        if case == train_main_case():
            main_err = errs
        del q, k, v, o, lse, do, got, want
        torch.cuda.empty_cache()

    lse_cases = _lse_cotangent_checks(torch, fa, gen)

    timings = {}
    h, hkv, t, d = 16, 4, 2048, 128
    # batch 4 in both types (the rows of earlier PRs), and the train
    # phase's own batch in its type under "train_main"
    for key, b, dtype in ((("float32", 4, "float32"), ("bfloat16", 4,
                                                       "bfloat16"),
                           ("train_main", TRAIN["batch"], TRAIN["dtype"]))):
        q, k, v = _qkv(torch, b, h, hkv, t, t, d, dtype, gen, False)
        o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
        do = _randn(torch, b, h, t, d, dtype, gen, False)
        timings[key] = bwd_timing(
            torch, (b, h, hkv, t, d, True), dtype,
            lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, True),
            lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, do, True),
            _sdpa_bwd(torch, q, k, v, do))
        del q, k, v, o, lse, do
        torch.cuda.empty_cache()
    timings["train_main"]["main_path_max_abs_err"] = main_err
    emit({"phase": "kernel", "kernel": "flash_attention_bwd",
          "instantiations": instantiations, "cases": results,
          "lse_cotangent": lse_cases, "max_abs_err": worst,
          "timings": timings})
    return worst, timings


def _lse_cotangent_checks(torch, fa, gen):
    """The logsumexp's cotangent (``FlashAttentionLse``, the reference's
    ``_flash_with_lse``): for one GQA causal case in each type, both
    backward kernels with a nonzero g_lse folded into D against the plain
    backward with the same g_lse (BWD_TOL); a zero g_lse equal to none
    bit for bit on the kernels; the autograd function's gradients against
    the plain backward's."""
    out = []
    for dtype in ("bfloat16", "float32"):
        b, h, hkv, tq, tk, d, causal = 2, 8, 2, 256, 256, 128, True
        q, k, v = _qkv(torch, b, h, hkv, tq, tk, d, dtype, gen, True)
        o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
        do = _randn(torch, b, h, tq, d, dtype, gen, True)
        g_lse = torch.randn(b, h, tq, generator=gen, device="cuda")
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal,
                                     g_lse=g_lse)
        want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal,
                                            g_lse=g_lse)
        errs = {}
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            atol, rtol = BWD_TOL[dtype][name]
            torch.testing.assert_close(g.float(), w.float(), atol=atol,
                                       rtol=rtol, msg=lambda m, n=name: (
                                           "lse cotangent %s: %s" % (n, m)))
            errs[name] = float((g.float() - w.float()).abs().max())
        none = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
        zero = fa.flash_attention_bwd(q, k, v, o, lse, do, causal,
                                      g_lse=torch.zeros_like(g_lse))
        if not all(torch.equal(a, z) for a, z in zip(none, zero)):
            raise RuntimeError("flash backward %s: a zero lse cotangent "
                               "changed the gradients" % dtype)
        if all(torch.equal(a, g) for a, g in zip(none, got)):
            raise RuntimeError("flash backward %s: the lse cotangent did "
                               "not reach the kernels" % dtype)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out_a, lse_a = fa.FlashAttentionLse.apply(*leaves, causal, None)
        torch.autograd.backward([out_a, lse_a], [do, g_lse])
        auto = {}
        for name, leaf, w in zip(("dq", "dk", "dv"), leaves, want):
            atol, rtol = BWD_TOL[dtype][name]
            torch.testing.assert_close(leaf.grad.float(), w.float(),
                                       atol=atol, rtol=rtol)
            auto[name] = float((leaf.grad.float() - w.float()).abs().max())
        out.append({"shape": [b, h, hkv, tq, tk, d], "causal": causal,
                    "dtype": dtype, "tol": BWD_TOL[dtype],
                    "max_abs_err": errs, "autograd_max_abs_err": auto,
                    "zero_cotangent_bit_for_bit": True})
        del q, k, v, o, lse, do, g_lse, got, want, none, zero, leaves
        torch.cuda.empty_cache()
    return out


def phase_kernel_update(torch):
    """Fused updates: kernel vs plain on the card (clip and rescale on and
    off, the LM's two largest shapes, a ragged length, f32 and bf16), then
    one timed pass over all of the LM's parameters (f32)."""
    from mxnet_tpu_torch.ops.kernels import fused_update as fu

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    hyper = {"sgd_mom_update": dict(lr=0.05, momentum=0.9, wd=1e-4),
             "adam_update": dict(lr=1e-3, beta1=0.9, beta2=0.999,
                                 epsilon=1e-8, wd=1e-4)}
    plain = {"sgd_mom_update": fu.sgd_mom_update_plain,
             "adam_update": fu.adam_update_plain}
    kernel = {"sgd_mom_update": fu.sgd_mom_update,
              "adam_update": fu.adam_update}
    n_state = {"sgd_mom_update": 1, "adam_update": 2}

    def buffers(kind, shape, dtype):
        dt = getattr(torch, dtype)
        w, g = (torch.randn(shape, generator=gen, device="cuda").to(dt)
                for _ in range(2))
        states = [torch.randn(shape, generator=gen, device="cuda").to(dt)
                  for _ in range(n_state[kind])]
        if kind == "adam_update":
            # a running mean of g * g, kept off zero so lr * m / sqrt(v)
            # stays at the scale of real steps
            states[1] = states[1].abs() + 0.01
        return [w, g] + states

    cases = []
    for shape, dtype in (((8192, 2048), "float32"), ((10000, 2048),
                                                     "float32"),
                         ((1001,), "float32"), ((8192, 2048), "bfloat16"),
                         ((1001,), "bfloat16")):
        for rescale, clip in ((1.0, -1.0), (0.5, 0.3)):
            cases.append((shape, dtype, rescale, clip))
    lr_kernel = {"sgd_mom_update": fu.sgd_mom_update_lr,
                 "adam_update": fu.adam_update_lr}
    lr_plain = {"sgd_mom_update": fu.sgd_mom_update_lr_plain,
                "adam_update": fu.adam_update_lr_plain}

    def lr_args(kind, index=2):
        """The device-lr entry's form of ``hyper[kind]``: lr and wd at
        ``index`` of two f32 arrays on the card, the rest as before."""
        h = dict(hyper[kind])
        lr_arr = torch.tensor([0.5, 0.25, h.pop("lr"), 0.125],
                              device="cuda")
        wd_arr = torch.tensor([1.0, 0.5, h.pop("wd"), 0.0], device="cuda")
        return (lr_arr, wd_arr, index), h

    results, worst = [], {k: 0.0 for k in kernel}
    device_lr = []
    for kind in kernel:
        for shape, dtype, rescale, clip in cases:
            bufs = buffers(kind, shape, dtype)
            got = [t.clone() for t in bufs]
            want = [t.clone() for t in bufs]
            kernel[kind](*got, rescale_grad=rescale, clip_gradient=clip,
                         **hyper[kind])
            plain[kind](*want, rescale_grad=rescale, clip_gradient=clip,
                        **hyper[kind])
            # the device-lr entry point: bit for bit the scalar kernel's,
            # and its plain version bit for bit the scalar plain one's
            lr, rest = lr_args(kind)
            got_lr = [t.clone() for t in bufs]
            want_lr = [t.clone() for t in bufs]
            lr_kernel[kind](*got_lr, *lr, rescale_grad=rescale,
                            clip_gradient=clip, **rest)
            lr_plain[kind](*want_lr, *lr, rescale_grad=rescale,
                           clip_gradient=clip, **rest)
            torch.cuda.synchronize()
            same = (all(torch.equal(a, b) for a, b in zip(got_lr, got)),
                    all(torch.equal(a, b) for a, b in zip(want_lr, want)))
            if not all(same):
                raise RuntimeError(
                    "%s device-lr entry at %s %s: kernel equals the scalar "
                    "one %s, plain equals the scalar plain %s"
                    % (kind, shape, dtype, same[0], same[1]))
            device_lr.append({"kernel": kind + "_lr", "shape": list(shape),
                              "dtype": dtype, "rescale_grad": rescale,
                              "clip_gradient": clip,
                              "equals_scalar_kernel": True,
                              "plain_equals_scalar_plain": True})
            atol, rtol = UPDATE_TOL[dtype]
            errs = []
            for i, (g, w) in enumerate(zip(got, want)):
                if i == 1:
                    continue  # the gradient is an input only
                torch.testing.assert_close(g.float(), w.float(), atol=atol,
                                           rtol=rtol)
                errs.append(float((g.float() - w.float()).abs().max()))
            results.append({"kernel": kind, "shape": list(shape),
                            "dtype": dtype, "rescale_grad": rescale,
                            "clip_gradient": clip, "atol": atol,
                            "rtol": rtol, "max_abs_err": errs})
            worst[kind] = max([worst[kind]] + errs)

    shapes = list(lm_param_shapes(LM).values())
    elements = int(sum(np.prod(s) for s in shapes))
    timings = {}
    for kind in kernel:
        params = [buffers(kind, s, "float32") for s in shapes]
        for p in params:
            if kind == "adam_update":
                p[3].zero_()
        bound_ms, bound_by = update_bound(kind, elements)
        lr, rest = lr_args(kind)
        timings[kind] = {
            "parameters": len(shapes), "elements": elements,
            "dtype": "float32",
            "ms": time_ms(torch, lambda: [kernel[kind](*p, **hyper[kind])
                                          for p in params], reps=10),
            "device_lr_ms": time_ms(torch, lambda: [lr_kernel[kind](
                *p, *lr, **rest) for p in params], reps=10),
            "plain_ms": time_ms(torch, lambda: [plain[kind](
                *p, **hyper[kind]) for p in params], reps=10),
            "library_ms": None,
            "library_note": "no single PyTorch call has MXNet's update "
                            "convention (torch.optim's momentum and Adam "
                            "differ)",
            "bound_ms": bound_ms, "bound_by": bound_by}
        del params
        torch.cuda.empty_cache()
    emit({"phase": "kernel", "kernel": "fused_update", "cases": results,
          "device_lr_cases": device_lr, "max_abs_err": worst,
          "timings": timings})
    return worst, timings


def wgrad_cases():
    """Cases (n, h, c, k, ksz, stride, dtype) of conv_wgrad: ResNet-50's
    seven 3x3 shapes at batch 32, and tests/test_consistency.py:370-374's
    odd cases (odd size, stride 2, 1x1, C 4 to 16), in f32 and bf16."""
    odd = [(2, 8, 8, 16, 3, 1), (2, 9, 8, 16, 3, 1), (2, 8, 8, 16, 3, 2),
           (1, 5, 4, 8, 1, 1), (4, 7, 16, 32, 3, 1)]
    return [case + (dtype,) for dtype in ("float32", "bfloat16")
            for case in [(32, h, c, c, 3, s) for h, c, s in RESNET_WGRAD]
            + odd]


def wgrad_report(torch):
    """conv_wgrad's instantiations (:func:`instantiation_report`): the
    wgmma and the two f32 partial kernels at bn = 64 and 128 (the simt,
    repack and reduce kernels are not templated)."""
    import ctypes

    from mxnet_tpu_torch.ops.kernels import _build
    from mxnet_tpu_torch.ops.kernels import conv_wgrad as cw

    smem = _build.kernel(cw._NAME, "mxtt_conv_wgrad_smem",
                         [ctypes.c_int, ctypes.c_int])
    sass = sass_counts(_build.lib_path(cw._NAME), tuple(WGRAD_KERNELS),
                       FA_BF16_OPCODES)
    return instantiation_report(
        _build.log_of(cw._NAME), sass, WGRAD_KERNELS, cw.BLOCK_COLS,
        lambda name, dtype, bn: smem(0 if dtype == "float32" else 1, bn))


def wgrad_route_check(plans, report):
    """Fails unless every ResNet-50 bf16 shape (``plans``: [(case, Plan)])
    takes the wgmma route into an instantiation whose SASS holds HGMMA and
    UTMALDG (``report`` of :func:`wgrad_report`), and every f32 one the
    f32 route; returns {case: route}."""
    routes = {}
    for case, p in plans:
        dtype = case[-1]
        want = "wgmma" if dtype == "bfloat16" else "f32"
        if p.route != want:
            raise RuntimeError("conv_wgrad %s takes the %s route, want %s"
                               % (case, p.route, want))
        label = "%s<%d>" % (p.kernel, p.bn)
        row = report.get(label)
        if row is None:
            raise RuntimeError("conv_wgrad %s: no report for %s"
                               % (case, label))
        if want == "wgmma" and not all(
                row["sass"].get(op, 0) > 0 for op in FA_BF16_OPCODES):
            raise RuntimeError("conv_wgrad %s runs %s, which lacks %s: %s"
                               % (case, label, FA_BF16_OPCODES, row["sass"]))
        routes[case] = label
    return routes


def wgrad_timing(torch, case, p, fn, plain, library,
                 timers=(time_ms, device_ms, device_ms_by)):
    """One timing row of conv_wgrad at ``case`` (n, h, c, k, ksz, stride,
    dtype) with plan ``p``: single calls of the wrapper (``fn``: the
    repack, partial and reduce kernels), of the plain version and of the
    library yardstick (CUDA events, the host's enqueue included), and the
    device times of the call (split into the partial kernel, the reduce
    kernel, the wgmma route's two repacks of the NCHW views, and the rest)
    and of the library's, beside the bound."""
    single, device, device_by = timers
    n, h, c, k, ksz, stride, dtype = case
    bound_ms, bound_by = wgrad_bound(n, h, c, k, ksz, stride, dtype)
    repacks = 2 if p.route == "wgmma" else 0
    dev, parts = device_by(
        torch, fn, {"partial": p.kernel, "reduce": "conv_wgrad_reduce",
                    "repack": "conv_wgrad_repack"},
        calls={p.kernel: 1, "conv_wgrad_reduce": 1,
               "conv_wgrad_repack": repacks})
    parts["other"] = dev - parts["partial"] - parts["reduce"] - \
        parts["repack"]
    return {"shape": [n, h, c, k, ksz, stride],
            "per_step": RESNET_WGRAD[(h, c, stride)],
            "route": p.route, "kernel": p.kernel, "bn": p.bn, "box": p.box,
            "splits": p.splits,
            "ms": single(torch, fn), "device_ms": dev,
            "device_ms_by_kernel": parts,
            "plain_ms": single(torch, plain),
            "library_ms": single(torch, library),
            "library_device_ms": device(torch, library),
            "bound_ms": bound_ms, "bound_by": bound_by}


# the keys of a wgrad_timing row that a step sums
WGRAD_STEP_KEYS = ("ms", "device_ms", "plain_ms", "library_ms",
                   "library_device_ms", "bound_ms")


def wgrad_step(rows):
    """Each of ``WGRAD_STEP_KEYS`` summed over a ResNet-50 step: each
    shape's row times its ``per_step``; the device split likewise."""
    step = {key: sum(t[key] * t["per_step"] for t in rows)
            for key in WGRAD_STEP_KEYS}
    step["device_ms_by_kernel"] = {
        part: sum(t["device_ms_by_kernel"][part] * t["per_step"]
                  for t in rows)
        for part in ("partial", "reduce", "repack", "other")}
    return step


def phase_kernel_wgrad(torch):
    """conv_wgrad: its instantiations' build and SASS report; kernel vs
    plain on the card, on the NCHW tensors' NHWC views the Convolution op
    passes (f32 through ``wgrad``, bf16 through the reference's
    ``conv_wgrad``), each case's route named; the ResNet-50 shapes must
    take the wgmma (bf16) and f32 routes; then each ResNet-50 shape timed
    beside the plain version and cuDNN's wgrad, with device times."""
    from mxnet_tpu_torch.ops.kernels import conv_wgrad as cw

    instantiations = wgrad_report(torch)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    results, worst, timings = [], {}, {"float32": [], "bfloat16": []}
    resnet_plans = []
    for case in wgrad_cases():
        n, h, c, k, ksz, stride, dtype = case
        pad = (ksz - 1) // 2
        oh = cw.out_size(h, ksz, stride, pad)
        dt = getattr(torch, dtype)
        x = torch.randn(n, c, h, h, generator=gen, device="cuda").to(dt)
        dy = torch.randn(n, k, oh, oh, generator=gen, device="cuda").to(dt)
        xv, dv = x.permute(0, 2, 3, 1), dy.permute(0, 2, 3, 1)
        p = cw.plan_of(xv, dv, ksz, stride, pad)
        fn = cw.wgrad if dtype == "float32" else cw.conv_wgrad
        got = fn(xv, dv, ksz, stride, pad)
        again = fn(xv, dv, ksz, stride, pad)
        want = cw.conv_wgrad_plain(xv, dv, ksz, stride, pad)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        if not rel <= WGRAD_RTOL:
            raise RuntimeError("conv_wgrad %s (%s route): error %g of max "
                               "|dW| (tol %g)" % (case, p.route, rel,
                                                  WGRAD_RTOL))
        if not torch.equal(got, again):
            raise RuntimeError("conv_wgrad %s (%s route): two calls differ"
                               % (case, p.route))
        results.append({"shape": [n, h, c, k, ksz, stride], "dtype": dtype,
                        "layout": "nchw view", "route": p.route,
                        "kernel": p.kernel, "bn": p.bn, "box": p.box,
                        "splits": p.splits,
                        "max_abs_err": err, "err_of_max": rel})
        worst[dtype] = max(worst.get(dtype, 0.0), err)
        if (h, c, stride) in RESNET_WGRAD and n == 32:
            resnet_plans.append((case, p))
            timings[dtype].append(wgrad_timing(
                torch, case, p, lambda: fn(xv, dv, ksz, stride, pad),
                lambda: cw.conv_wgrad_plain(xv, dv, ksz, stride, pad),
                lambda: torch.nn.grad.conv2d_weight(
                    x, (k, c, ksz, ksz), dy, stride=stride, padding=pad)))
        del x, dy, xv, dv, got, again, want
    routes = wgrad_route_check(resnet_plans, instantiations)
    step = {dtype: wgrad_step(ts) for dtype, ts in timings.items()}
    emit({"phase": "kernel", "kernel": "conv_wgrad",
          "instantiations": instantiations,
          "resnet_instantiations": {"%s/%s" % (c[-1], c[:-1]): label
                                    for c, label in routes.items()},
          "cases": results, "tol_of_max": WGRAD_RTOL, "max_abs_err": worst,
          "timings": timings, "per_step": step})
    return worst, timings, step


# the layouts of _lstm_inputs, by name
LSTM_LAYOUTS = {
    "views": "blob view at an odd offset, broadcast state",
    "contiguous": "blob view at an odd offset, contiguous state",
    "scan": "blob view at the LM's offset 4H*I, contiguous state"}


def _lstm_inputs(torch, n, h, dtype, gen, layout="views"):
    """Seeded lstm_step inputs as the fused RNN op hands them over: ``wh``
    a (4H, H) view into a parameter blob, at an odd element offset (in
    bf16 not 16-byte aligned) or, in the ``"scan"`` layout, at the LM's
    first layer's 4H * I (I = H); ``h`` / ``c`` broadcast views (stride 0
    along the hidden and the batch axis) in the ``"views"`` layout, their
    contiguous copies in ``"contiguous"``, and full (N, H) rows in
    ``"scan"`` (ys[t - 1] and the c buffer of the scan)."""
    dt = getattr(torch, dtype)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    ib = randn(n, 4 * h).to(dt)
    off = 4 * h * h if layout == "scan" else 3
    blob = (randn(off + 4 * h * h + 5) / math.sqrt(h)).to(dt)
    wh = blob[off:off + 4 * h * h].view(4 * h, h)
    if layout == "scan":
        return ib, (0.5 * randn(n, h)).to(dt), randn(n, h).to(dt), wh
    hs = (0.5 * randn(n, 1)).to(dt).expand(n, h)
    cs = randn(1, h).to(dt).expand(n, h)
    if layout == "contiguous":
        hs, cs = hs.contiguous(), cs.contiguous()
    return ib, hs, cs, wh


def _fused_lstm_cell(torch, ib, h, c, wh):
    """The step's library yardstick: cuBLAS's h . Wh^T, then PyTorch's
    fused LSTM pointwise kernel (CUDA only). No single PyTorch call
    computes the step. Timed only; the port never calls it."""
    cell = torch.ops.aten._thnn_fused_lstm_cell
    return lambda: cell(ib, torch.mm(h, wh.t()), c)


def lstm_label(p):
    """The instantiation label (:func:`kernel_label`) of lstm_step plan
    ``p``."""
    tile = p.tile if isinstance(p.tile, tuple) else (p.tile,)
    return "%s<%s>" % (p.kernel, ",".join(str(t) for t in tile))


def lstm_instantiations(log, sass, smem_of):
    """lstm_step's instantiations: the f32 and wgmma bodies through
    :func:`instantiation_report` (which fails on f32 spills and on a wgmma
    body without HGMMA or UTMALDG), and the simt body's registers and
    spills from the ptxas ``log``."""
    report = {}
    for name, (dtype, tiles) in LSTM_KERNELS.items():
        report.update(instantiation_report(log, sass, {name: dtype}, tiles,
                                           smem_of))
    for label, row in ptxas_report(log, (LSTM_SIMT,)).items():
        report[label] = dict(row, dtype="bfloat16",
                             sass=sass.get(label, {}))
    return report


def lstm_report(torch):
    """:func:`lstm_instantiations` of the built library's log and SASS."""
    import ctypes

    from mxnet_tpu_torch.ops.kernels import _build
    from mxnet_tpu_torch.ops.kernels import lstm as kl

    smem = _build.kernel(kl._NAME, "mxtt_lstm_step_smem", [ctypes.c_int] * 2)
    sass = sass_counts(_build.lib_path(kl._NAME),
                       tuple(LSTM_KERNELS) + (LSTM_SIMT,), FA_BF16_OPCODES)
    return lstm_instantiations(
        _build.log_of(kl._NAME), sass, lambda name, dtype, tile: smem(
            kl.ROUTE_CODE["f32" if dtype == "float32" else "wgmma"], tile))


def lstm_route_check(plans, report, main=LSTM_MAIN):
    """Fails unless each main-path shape (``main``) in the scan's layout
    (``plans``: [((n, h), dtype, layout, Plan)]) takes the f32 tile body
    with 16-byte copies of h and Wh (f32) or the wgmma body (bf16), into an
    instantiation of ``report`` (:func:`lstm_report`) whose SASS holds
    HGMMA and UTMALDG and whose build has no C7515 / C7520 note (bf16);
    returns {"dtype/[n, h]/layout": label} of every plan."""
    routes = {}
    for (n, h), dtype, layout, p in plans:
        label = lstm_label(p)
        routes["%s/%s/%s" % (dtype, [n, h], layout)] = label
        if (n, h) not in main or layout != "scan":
            continue
        what = "lstm_step %s %s in the scan's layout" % (dtype, (n, h))
        want = "f32" if dtype == "float32" else "wgmma"
        if p.route != want:
            raise RuntimeError("%s takes the %s route, want %s"
                               % (what, p.route, want))
        if want == "f32" and not (p.vec_h and p.vec_w):
            raise RuntimeError("%s copies h / Wh 4 bytes a time (vec %s, "
                               "%s)" % (what, p.vec_h, p.vec_w))
        row = report.get(label)
        if row is None:
            raise RuntimeError("%s: no report for %s" % (what, label))
        if want == "wgmma":
            if not all(row["sass"].get(op, 0) > 0 for op in FA_BF16_OPCODES):
                raise RuntimeError("%s runs %s, which lacks %s: %s"
                                   % (what, label, FA_BF16_OPCODES,
                                      row["sass"]))
            if row["wgmma_serialized"]:
                raise RuntimeError("%s runs %s, whose wgmma ptxas "
                                   "serializes (C7515 / C7520)"
                                   % (what, label))
    return routes


def lstm_timing(torch, n, h, dtype, p, fns,
                timers=(graph_ms, device_ms, time_ms)):
    """One timing row of lstm_step at (n, h) in ``dtype`` with plan ``p``:
    each (name, fn) of ``fns`` (the kernel's "ms", the plain version's and
    the library yardstick's) timed over graph replays of 35 calls, by the
    profiler's device time and by single-call CUDA events, beside the
    bound."""
    replay, device, single = timers
    bound_ms, bound_by = lstm_step_bound(n, h, dtype)
    return dict({k: replay(torch, f) for k, f in fns},
                shape=[n, h], layout=LSTM_LAYOUTS["scan"], route=p.route,
                kernel=lstm_label(p),
                device_ms={k: device(torch, f, reps=20) for k, f in fns},
                event_ms={k: single(torch, f, reps=20) for k, f in fns},
                bound_ms=bound_ms, bound_by=bound_by)


def phase_kernel_lstm(torch):
    """lstm_step: its instantiations' build and SASS report; kernel vs
    plain on the card at LSTM_CASES, f32 and bf16, in each of LSTM_LAYOUTS,
    each case's route named; the scan's main-path shapes must take the f32
    tile body and the wgmma body; the 35-step fused scan vs the plain scan;
    then the step timed at (128, 512) in the scan's layout beside the plain
    version and cuBLAS + the fused LSTM cell in both types, and one whole
    layer (input projection + 35 steps) beside cuDNN's LSTM. A step's
    ``ms``, ``plain_ms`` and ``library_ms`` are CUDA-event medians over
    graph replays of 35 calls (:func:`graph_ms`), with the profiler's
    device times under ``device_ms``; the layer's are the profiler's
    device times. Single-call CUDA-event times, the host's enqueue
    included, are under ``event_ms``."""
    from mxnet_tpu_torch.ops import rnn_fused as rf
    from mxnet_tpu_torch.ops.kernels import lstm as kl

    instantiations = lstm_report(torch)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    results, worst, plans = [], {}, []
    for dtype in ("float32", "bfloat16"):
        atol, rtol = LSTM_TOL[dtype]
        for n, h in LSTM_CASES:
            for layout in LSTM_LAYOUTS:
                ib, hs, cs, wh = _lstm_inputs(torch, n, h, dtype, gen,
                                              layout)
                p = kl.plan_of(hs, wh)
                got = kl.lstm_step(ib, hs, cs, wh)
                want = kl.lstm_step_plain(ib, hs, cs, wh)
                torch.cuda.synchronize()
                errs = []
                for name, g, w in zip(("h", "c"), got, want):
                    torch.testing.assert_close(
                        g.float(), w.float(), atol=atol, rtol=rtol,
                        msg=lambda m, k=name: "lstm_step %s %s: %s" % (
                            (n, h, dtype, layout, p.route), k, m))
                    errs.append(float((g.float() - w.float()).abs().max()))
                results.append({"shape": [n, h], "dtype": dtype,
                                "layout": LSTM_LAYOUTS[layout],
                                "route": p.route, "kernel": lstm_label(p),
                                "vec": [p.vec_h, p.vec_w],
                                "atol": atol, "rtol": rtol,
                                "max_abs_err": {"h": errs[0],
                                                "c": errs[1]}})
                plans.append(((n, h), dtype, layout, p))
                worst[dtype] = max([worst.get(dtype, 0.0)] + errs)
    routes = lstm_route_check(plans, instantiations,
                              main=LSTM_MAIN + (BUCKET_STEP,))

    # the 35-step scan at the LM's shape: kernel scan vs plain scan, f32
    cfg = LSTM_LM
    t, n, h = cfg["seq"], cfg["batch"], cfg["hidden"]
    _, h0, c0, wh = _lstm_inputs(torch, n, h, "float32", gen)
    ib = torch.randn(t, n, 4 * h, generator=gen, device="cuda")
    with torch.no_grad():
        got = rf.LSTMScan.apply(ib, h0, c0, wh)
        want = rf._lstm_scan_plain(ib, h0, c0, wh, h)
    torch.cuda.synchronize()
    scan_err = {}
    for name, g, w in zip(("ys", "h", "c"), got, want):
        torch.testing.assert_close(g, w, atol=LSTM_SCAN_TOL[0],
                                   rtol=LSTM_SCAN_TOL[1])
        scan_err[name] = float((g - w).abs().max())
    del ib, got, want

    timings = {}
    # the LM's (128, 512) in both types; the bucketing run's (32, 512), f32
    for key, (tn, dtype) in (("float32", (n, "float32")),
                             ("bfloat16", (n, "bfloat16")),
                             ("bucketing_float32", (BUCKET_STEP[0],
                                                    "float32"))):
        ib, hs, cs, wh = _lstm_inputs(torch, tn, h, dtype, gen, "scan")
        h_out, c_out = torch.empty_like(hs), torch.empty_like(cs)
        timings[key] = lstm_timing(
            torch, tn, h, dtype, kl.plan_of(hs, wh),
            (("ms", lambda: kl.lstm_step(ib, hs, cs, wh, h_out, c_out)),
             ("plain_ms", lambda: kl.lstm_step_plain(ib, hs, cs, wh)),
             ("library_ms", _fused_lstm_cell(torch, ib, hs, cs, wh))))

    # one whole layer at the LM's shape, f32: the port's scan (input
    # projection + 35 kernel steps) vs the plain scan vs cuDNN's LSTM with
    # the same weights (gate order i, f, g, o in both)
    i = cfg["embed"]
    x = torch.randn(t, n, i, generator=gen, device="cuda")
    wi = torch.randn(4 * h, i, generator=gen, device="cuda") / math.sqrt(i)
    wh = torch.randn(4 * h, h, generator=gen, device="cuda") / math.sqrt(h)
    bi, bh = (0.1 * torch.randn(4 * h, generator=gen, device="cuda")
              for _ in range(2))
    h0, c0 = (torch.zeros(n, h, device="cuda") for _ in range(2))
    cudnn = torch.nn.LSTM(i, h).cuda()
    with torch.no_grad():
        for name, w in (("weight_ih_l0", wi), ("weight_hh_l0", wh),
                        ("bias_ih_l0", bi), ("bias_hh_l0", bh)):
            getattr(cudnn, name).copy_(w)
        port = lambda: rf._lstm_scan(x, h0, c0, wi, wh, bi, bh)
        plain = lambda: rf._lstm_scan_plain(
            torch.matmul(x, wi.t()) + (bi + bh), h0, c0, wh, h)
        library = lambda: cudnn(x, (h0[None], c0[None]))
        ys = port()[0]
        ys_lib = library()[0]
        torch.cuda.synchronize()
        torch.testing.assert_close(ys, ys_lib, atol=LSTM_SCAN_TOL[0],
                                   rtol=LSTM_SCAN_TOL[1])
        bound_ms, bound_by = lstm_layer_bound(t, n, i, h)
        dev, event = _times(torch, (("ms", port), ("plain_ms", plain),
                                    ("library_ms", library)), reps=10)
        layer = dict(dev, shape=[t, n, i, h], dtype="float32",
                     max_abs_err_vs_cudnn=float((ys - ys_lib).abs().max()),
                     event_ms=event,
                     library="torch.nn.LSTM (cuDNN, no TF32)",
                     bound_ms=bound_ms, bound_by=bound_by)
    emit({"phase": "kernel", "kernel": "lstm_step",
          "instantiations": instantiations, "routes": routes,
          "cases": results,
          "max_abs_err": worst, "scan_max_abs_err": scan_err,
          "scan_tol": LSTM_SCAN_TOL, "timings": timings, "layer": layer})
    return worst, timings, layer


def rtc_bwd_route_check(rows, cols, bp):
    """``bp`` (rtc_softmax's BwdPlan at (rows, cols)) if it takes the
    route RTC_BWD_ROUTES names for that shape, else a failure."""
    want = RTC_BWD_ROUTES.get((rows, cols), bp.route)
    if bp.route != want:
        raise RuntimeError("rtc_softmax bwd %s takes the %s route, want %s"
                           % ((rows, cols), bp.route, want))
    return bp


def rtc_timing(torch, rows, cols, pairs, timers=(loop_ms, device_ms)):
    """One timing row of an rtc_softmax kernel at (rows, cols): each
    (name, fn) of ``pairs`` timed over runs of back-to-back calls (CUDA
    events, median) and by the profiler's device time, beside the
    bound."""
    loop, device = timers
    bound_ms, bound_by = rtc_softmax_bound(rows, cols)
    return dict({k: loop(torch, f) for k, f in pairs},
                device_ms={k: device(torch, f, reps=10) for k, f in pairs},
                shape=[rows, cols], bound_ms=bound_ms, bound_by=bound_by)


def phase_kernel_rtc(torch):
    """mx.rtc on the card: the JAX tests' kernels (axpy, inc, relu; axpy in
    bf16) as CUDA C, each against its mode="torch" twin; the source cache
    (a second create is the same object, a second push compiles nothing);
    a syntax error raising NVRTC's log and a refused launch raising; then
    the rtc_softmax kernels against their twins at RTC_SOFTMAX_CASES, and
    at (4480, 10000) timed (CUDA events over back-to-back calls, median, and
    the profiler's device time) beside the twins and torch.softmax."""
    from mxnet_tpu_torch import nd, rtc
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.ops.kernels import rtc_driver
    from mxnet_tpu_torch.tools import rtc_softmax as rs

    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    tests, compile_ms = [], {}
    for name, (ins, body, twin_src, dtype) in RTC_ELEMENTWISE.items():
        dt = getattr(torch, dtype)
        for shape in RTC_ELEMENTWISE_SHAPES:
            n = int(np.prod(shape))
            src = rtc_elementwise_src(body, n)
            kern = rtc.create(name, list(ins), ["out"], src)
            twin = rtc.create(name, list(ins), ["out"], twin_src,
                              mode="torch")
            xs = [nd.NDArray(randn(*shape, dtype=dt)) for _ in ins]
            got = nd.NDArray(torch.zeros(shape, dtype=dt, device="cuda"))
            want = nd.NDArray(torch.zeros(shape, dtype=dt, device="cuda"))
            block = 256
            kern.push(xs, [got], grid_dims=(-(-n // block),),
                      block_dims=(block,))
            twin.push(xs, [want])
            torch.cuda.synchronize()
            torch.testing.assert_close(
                got._data.float(), want._data.float(), rtol=RTC_TOL[dtype],
                atol=0.0, msg=lambda m, k=(name, shape): "rtc %s %s: %s"
                % (k[0], k[1], m))
            tests.append({"kernel": name, "shape": list(shape),
                          "dtype": dtype, "rtol": RTC_TOL[dtype],
                          "max_abs_err": float((got._data.float()
                                                - want._data.float())
                                               .abs().max())})
            compile_ms["%s %s" % (name, list(shape))] = list(
                kern.compile_ms.values())

    # the cache: the same source is the same object, compiled once
    name, (ins, body, _, _) = "inc", RTC_ELEMENTWISE["inc"]
    src = rtc_elementwise_src(body, 128)
    first = rtc.create(name, list(ins), ["out"], src)
    before = rtc_driver.compiles
    again = rtc.create(name, list(ins), ["out"], src)
    x = nd.NDArray(randn(8, 16))
    out = nd.NDArray(torch.zeros(8, 16, device="cuda"))
    again.push([x], [out], grid_dims=(1,), block_dims=(128,))
    torch.cuda.synchronize()
    if again is not first or rtc_driver.compiles != before \
            or len(first.compile_ms) != 1:
        raise RuntimeError("rtc cache: a second create or push compiled "
                           "again (%d compiles before, %d after)"
                           % (before, rtc_driver.compiles))

    # a syntax error raises NVRTC's log; a launch the card refuses raises
    bad = rtc.create("bad_syntax", ["x"], ["out"], "out[0] = x[0] +;")
    try:
        bad.push([x], [out], grid_dims=(1,), block_dims=(1,))
    except MXNetError as e:
        syntax_error = str(e).splitlines()
    else:
        raise RuntimeError("rtc: a syntax error compiled")
    if not any("bad_syntax.cu(" in ln and "error" in ln
               for ln in syntax_error):
        raise RuntimeError("rtc: the compile error lacks NVRTC's log: %s"
                           % syntax_error)
    try:
        first.push([x], [out], grid_dims=(1,), block_dims=(2048,))
    except MXNetError as e:
        refused = str(e)
    else:
        raise RuntimeError("rtc: a launch of 2048 threads a block ran")
    torch.cuda.synchronize()

    # rtc_softmax: kernels vs twins at each case
    cases, worst = [], 0.0
    for rows, cols in RTC_SOFTMAX_CASES:
        kern, twin = rs.kernels(cols), rs.twins()
        x = nd.NDArray(3.0 * randn(rows, cols))
        label = nd.NDArray(torch.randint(0, cols, (rows,), generator=gen,
                                         device="cuda").float())
        prob, prob_t, grad, grad_t = (
            nd.NDArray(torch.zeros(rows, cols, device="cuda"))
            for _ in range(4))
        block, per = rs.launch_dims(cols)
        kern["fwd"].push([x], [prob], grid_dims=(rows,), block_dims=(block,))
        twin["fwd"].push([x], [prob_t])
        bp = rtc_bwd_route_check(rows, cols, rs.bwd_plan(
            cols, prob._data.data_ptr(), grad._data.data_ptr()))
        rs.push("bwd", [prob, label], [grad])
        twin["bwd"].push([prob, label], [grad_t])
        # the scalar source as well where the vector one ran
        pairs = [("fwd", prob, prob_t), ("bwd", grad, grad_t)]
        if bp.route == "vector":
            scalar = nd.NDArray(torch.zeros(rows, cols, device="cuda"))
            kern["bwd"].push([prob, label], [scalar], grid_dims=(rows,),
                             block_dims=(block,))
            pairs.append(("bwd_scalar", scalar, grad_t))
        torch.cuda.synchronize()
        errs, rel_errs = {}, {}
        for what, g, w in pairs:
            for atol, rtol in ((RTC_SOFTMAX_ATOL, 0.0),
                               (RTC_SOFTMAX_FLOOR, RTC_SOFTMAX_RTOL)):
                torch.testing.assert_close(
                    g._data, w._data, atol=atol, rtol=rtol,
                    msg=lambda m, k=(what, rows, cols): "rtc_softmax %s %s: "
                    "%s" % (k[0], k[1:], m))
            diff = (g._data - w._data).abs()
            errs[what] = float(diff.max())
            rel_errs[what] = float((diff / (w._data.abs()
                                            + RTC_SOFTMAX_FLOOR)).max())
        row_sum = float((prob._data.double().sum(1) - 1.0).abs().max())
        if not row_sum <= RTC_SOFTMAX_ROW_SUM:
            raise RuntimeError("rtc_softmax %s: a row of probabilities sums "
                               "to 1 within %g, not %g"
                               % ((rows, cols), row_sum, RTC_SOFTMAX_ROW_SUM))
        cases.append({"shape": [rows, cols], "block": block,
                      "per_thread": per, "bwd_route": bp.route,
                      "bwd_block": bp.block, "bwd_per_thread": bp.per,
                      "max_abs_err": errs,
                      "max_rel_err": rel_errs, "max_row_sum_err": row_sum,
                      "compile_ms": {k: list(v.compile_ms.values())
                                     for k, v in kern.items()}})
        worst = max([worst] + list(errs.values()))

    # timing at the LM's shape
    rows, cols = RTC_SOFTMAX_CASES[0]
    kern, twin = rs.kernels(cols), rs.twins()
    block, _ = rs.launch_dims(cols)
    x = nd.NDArray(3.0 * randn(rows, cols))
    label = nd.NDArray(torch.randint(0, cols, (rows,), generator=gen,
                                     device="cuda").float())
    prob, out = (nd.NDArray(torch.zeros(rows, cols, device="cuda"))
                 for _ in range(2))
    kern["fwd"].push([x], [prob], grid_dims=(rows,), block_dims=(block,))
    # the backward's library yardstick: one out-of-place scatter_add of -1
    # at each row's label is p - onehot(label); held against the kernel
    idx = label._data.long()[:, None]
    minus_one = torch.full((rows, 1), -1.0, device="cuda")
    bp = rtc_bwd_route_check(rows, cols, rs.bwd_plan(
        cols, prob._data.data_ptr(), out._data.data_ptr()))
    rs.push("bwd", [prob, label], [out])
    torch.testing.assert_close(torch.scatter_add(prob._data, 1, idx,
                                                 minus_one),
                               out._data, atol=0.0, rtol=0.0)
    fns = {"fwd": (("ms", lambda: kern["fwd"].push(
                        [x], [out], grid_dims=(rows,), block_dims=(block,))),
                   ("plain_ms", lambda: twin["fwd"].push([x], [out])),
                   ("library_ms", lambda: torch.softmax(x._data, dim=1))),
           "bwd": (("ms", lambda: rs.push("bwd", [prob, label], [out])),
                   ("scalar_ms", lambda: kern["bwd"].push(
                       [prob, label], [out], grid_dims=(rows,),
                       block_dims=(block,))),
                   ("plain_ms", lambda: twin["bwd"].push([prob, label],
                                                          [out])),
                   ("library_ms", lambda: torch.scatter_add(
                       prob._data, 1, idx, minus_one)))}
    timings = {kind: rtc_timing(torch, rows, cols, pairs)
               for kind, pairs in fns.items()}
    timings["fwd"].update(block=block, library="torch.softmax(x, dim=1)",
                          compile_ms=list(kern["fwd"].compile_ms.values()))
    timings["bwd"].update(
        bwd_route=bp.route, block=bp.block, per_thread=bp.per,
        scalar_block=block,
        compile_ms={k: list(kern[k].compile_ms.values())
                    for k in ("bwd", "bwd_vec")})
    timings["bwd"]["library"] = ("torch.scatter_add(p, 1, label[:, None], "
                                 "-1), out of place")
    emit({"phase": "kernel", "kernel": "rtc", "nvrtc": list(
        rtc_driver.nvrtc_version()), "options": rtc_driver.compile_options(),
          "tests": tests, "test_compile_ms": compile_ms,
          "cache": {"same_object": True, "compiles": rtc_driver.compiles},
          "syntax_error": syntax_error[:4], "refused_launch": refused,
          "softmax_cases": cases, "max_abs_err": worst,
          "softmax_tol": {"atol": RTC_SOFTMAX_ATOL, "rtol": RTC_SOFTMAX_RTOL,
                          "floor": RTC_SOFTMAX_FLOOR,
                          "row_sum": RTC_SOFTMAX_ROW_SUM},
          "timings": timings})
    return worst, timings


def _serve_streams(gen, model, cfg, conf, prompts, temperature=0.0,
                   seed=SEED, traces=None, together=False, **knobs):
    """Serve ``prompts`` through a ``DecodeScheduler`` at ``conf``'s slots,
    context, buckets and new tokens (``knobs``: paged, kv_dtype, capture,
    block_tokens, num_blocks, quant_weights, spec, spec_tokens,
    spec_draft), every stream consumed by its own thread; stream i samples
    at ``temperature`` from seed ``seed + i`` (0: greedy), with trace
    context ``traces[i]`` (None: none); ``together`` queues every prompt
    before the scheduler admits the first, so the steps do not depend on
    how the submitting thread and the scheduler interleave. Checks each
    stream ran to ``max_tokens``; returns its records (tokens and arrival
    times), the scheduler's stats before it stopped, the flash launches
    and the int8 products, the wall seconds and the card's peak
    memory. The scheduler (and a quantized copy of the weights it made)
    is gone when it returns."""
    import torch

    from mxnet_tpu_torch.ops.kernels import flash_attention as fa
    from mxnet_tpu_torch.ops.matrix import int8_product

    knobs = dict(dict(paged=False, kv_dtype="f32", capture=False,
                      quant_weights="", spec=False), **knobs)
    config = gen.GenerateConfig(
        num_heads=cfg["heads"], num_kv_heads=cfg["kv_heads"],
        slots=conf["slots"], max_context=conf["max_context"],
        prefill_buckets=conf["prefill_buckets"],
        max_new_tokens=conf["max_new_tokens"], eos_id=None, **knobs)
    on_card = model.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        _reset_peak(torch)
    sched = gen.DecodeScheduler(model, config)
    sched.start()
    records, threads = [], []
    try:
        fa.flash_attention.launches = 0
        int8_product.launches = 0
        t0 = time.monotonic()
        with (sched._cond if together else contextlib.nullcontext()):
            streams = [sched.submit(p, temperature=temperature,
                                    seed=seed + i,
                                    trace=traces[i] if traces else None)
                       for i, p in enumerate(prompts)]
        for s in streams:
            rec = {"stream": s, "times": [], "tokens": []}
            records.append(rec)

            def consume(rec=rec):
                for tok in rec["stream"]:
                    rec["times"].append(time.monotonic())
                    rec["tokens"].append(tok)

            th = threading.Thread(target=consume, daemon=True)
            th.start()
            threads.append(th)
        for th in threads:
            th.join(timeout=600)
        wall = time.monotonic() - t0
        launches = fa.flash_attention.launches
        int8_products = int8_product.launches
        stats = sched.stats()
    finally:
        sched.stop()
        del sched
    want = conf["max_new_tokens"]
    for rec, th in zip(records, threads):
        s = rec["stream"]
        if th.is_alive() or s.finish_reason != "max_tokens" \
                or len(rec["tokens"]) != want:
            raise RuntimeError("stream of %d prompt tokens ended %r with %d "
                               "tokens" % (s.prompt_len, s.finish_reason,
                                           len(rec["tokens"])))
    gaps = [b - a for rec in records
            for a, b in zip(rec["times"], rec["times"][1:])]
    total = sum(len(rec["tokens"]) for rec in records)
    # a stream's decode ms a token, first token to last (speculative
    # tokens arrive in bursts, so the median gap says nothing there)
    per_token = [(rec["times"][-1] - rec["times"][0]) * 1e3
                 / (len(rec["times"]) - 1) for rec in records
                 if len(rec["times"]) > 1]
    return {"records": records, "stats": stats, "launches": launches,
            "int8_products": int8_products,
            "ms_per_token": float(np.median(per_token)),
            "wall_s": wall, "tokens": [rec["tokens"] for rec in records],
            "ttft_ms": [(rec["times"][0] - rec["stream"].submitted) * 1e3
                        for rec in records],
            "decode_ms_per_step": float(np.median(gaps)) * 1e3,
            "tokens_per_s": total / wall, **_peak(torch, on_card)}


def phase_serve(cfg=LM, serve=SERVE, device=None, ref_device="cpu",
                seed=SEED):
    """The generate path end to end. ``device`` None = the card (the
    port's default); the reference prefill runs on ``ref_device``, where
    flash_attention takes its plain version. Returns the flash launches
    and the streams' tokens."""
    from mxnet_tpu_torch.serving import generate as gen

    params = lm_arg_params(cfg, seed)
    spec = gen.DecodeSpec(num_heads=cfg["heads"],
                          num_kv_heads=cfg["kv_heads"])
    model = gen.DecodeModel.from_arg_params(params, spec, device=device)
    prompts = serve_prompts(cfg, serve, seed)
    run = _serve_streams(gen, model, cfg, serve, prompts)
    records, launches = run["records"], run["launches"]
    expected = len(prompts) * cfg["layers"]
    if launches != expected:
        raise RuntimeError("flash kernel ran %d times in the serve phase, "
                           "want %d" % (launches, expected))

    # first-token logits: the served program vs the port's plain path on
    # the reference device, same numpy weights
    ref_model = gen.DecodeModel.from_arg_params(params, spec,
                                                device=ref_device)
    ref_progs = gen.DecodePrograms(ref_model, 1, serve["max_context"],
                                   serve["prefill_buckets"])
    progs = gen.DecodePrograms(model, 1, serve["max_context"],
                               serve["prefill_buckets"])
    checks = []
    for n in serve["check_lens"]:
        i = serve["prompt_lens"].index(n)
        got = progs.prefill(prompts[i])[0].float().cpu()
        ref = ref_progs.prefill(prompts[i])[0].float().cpu()
        err = float((got - ref).abs().max())
        tok_ref = int(ref.argmax())
        if err > 1e-3 or records[i]["tokens"][0] != tok_ref:
            raise RuntimeError(
                "prompt %d: first-token logits differ by %g from the plain "
                "path (token %d vs %d)" % (n, err, records[i]["tokens"][0],
                                           tok_ref))
        checks.append({"prompt_len": n, "max_abs_err": err,
                       "token": tok_ref})
    result = {"phase": "serve", "requests": len(prompts),
              "prompt_lens": list(serve["prompt_lens"]),
              "ttft_ms": run["ttft_ms"],
              "decode_ms_per_step": run["decode_ms_per_step"],
              "tokens_per_s": run["tokens_per_s"], "wall_s": run["wall_s"],
              "steps": run["stats"]["steps"], "flash_launches": launches,
              "first_token_check": checks}
    emit(result)
    return launches, run["tokens"]


def _require_decode_capture(what, stats, on_card):
    """On the card a captured run must have taken the captured path: two
    warm-up steps, one capture, a replay for every later step. On the CPU
    the step runs eagerly (there is no CUDA graph to take)."""
    if not on_card:
        if stats["decode_path"] != "eager":
            raise RuntimeError("%s: decode path %r on the CPU"
                               % (what, stats["decode_path"]))
        return
    want = {"decode_path": "captured", "warmup_calls": 2, "captures": 1,
            "replays": stats["steps"] - 2}
    got = {k: stats[k] for k in want}
    if got != want:
        raise RuntimeError("%s did not take the captured decode path: %s, "
                           "want %s" % (what, got, want))


def _waited_on_blocks(records):
    """Whether some stream's first token came after an earlier-submitted
    stream's last: its admission waited for a retirement."""
    last = [rec["times"][-1] for rec in records]
    return any(rec["times"][0] > min(last[:i])
               for i, rec in enumerate(records) if i)


def _teacher_forced_gate(what, got, ref, atol, top=None, margin=None):
    """Per step: max |got - ref| within ``atol``; and the argmax of got
    either in ref's top ``top``, or equal to ref's wherever ref's top-2
    margin exceeds ``margin``. Returns the worst difference."""
    worst = float(np.abs(got - ref).max())
    order = np.argsort(-ref, axis=-1)
    am = got.argmax(-1)
    if top is not None:
        bad = [i for i in range(len(ref)) if am[i] not in order[i, :top]]
    else:
        gap = ref[np.arange(len(ref)), order[:, 0]] \
            - ref[np.arange(len(ref)), order[:, 1]]
        bad = [i for i in range(len(ref))
               if gap[i] > margin and am[i] != order[i, 0]]
    if worst > atol or bad:
        raise RuntimeError("%s: logits within %g of the reference arm "
                           "(limit %g), argmax off at steps %s"
                           % (what, worst, atol, bad))
    return worst


def _prefill_saved(torch, gen, model, paged, prompts):
    """Paged prefill ms (CUDA events around the call, median of 3) of each
    joiner's whole prompt (cold) and of its suffix after the shared prefix
    (warm), on the card."""
    progs = gen.PagedDecodePrograms(
        model, paged["slots"], paged["max_context"],
        paged["prefill_buckets"], paged["block_tokens"],
        paged["num_blocks"])
    rows = []
    for share in (True, False):
        cache = gen.PagedKVCacheManager(progs, prefix_share=share)
        first = cache.try_admit("first", prompts[0],
                                paged["max_new_tokens"])
        progs.paged_prefill(cache.k_slab, cache.v_slab, first.table,
                            first.ctx_len, first.suffix, first.fork_src,
                            first.fork_dst)
        for i in range(1, len(paged["suffix_lens"])):
            plan = cache.try_admit(i, prompts[i], paged["max_new_tokens"])
            ms = time_ms(torch, lambda: progs.paged_prefill(
                cache.k_slab, cache.v_slab, plan.table, plan.ctx_len,
                plan.suffix, plan.fork_src, plan.fork_dst), reps=3, warmup=1)
            if share:
                rows.append({"prompt_len": len(prompts[i]),
                             "suffix": len(plan.suffix), "warm_ms": ms})
            else:
                rows[i - 1]["cold_ms"] = ms
            cache.free(plan.slot)
    for r in rows:
        r["saved_ms"] = r["cold_ms"] - r["warm_ms"]
    return rows


def phase_serve_paged(cfg=LM, serve=SERVE, paged=SERVE_PAGED, device=None,
                      seed=SEED, eager_tokens=None, int8_tol=None):
    """Paged KV with prefix sharing, int8 KV and the captured decode step
    at full width (phase 3b of the docstring). ``eager_tokens``: the serve
    phase's streams (None: served eagerly here first). ``int8_tol``: the
    int8 drift gate (None: INT8_KV_TOL). Returns the flash launches."""
    import torch

    from mxnet_tpu_torch.serving import generate as gen

    int8_tol = INT8_KV_TOL if int8_tol is None else int8_tol
    params = lm_arg_params(cfg, seed)
    spec = gen.DecodeSpec(num_heads=cfg["heads"],
                          num_kv_heads=cfg["kv_heads"])
    model = gen.DecodeModel.from_arg_params(params, spec, device=device)
    on_card = model.device.type == "cuda"
    flash = 0
    result = {"phase": "serve_paged"}

    # 1. unpaged, f32, captured, on the serve phase's prompts
    prompts = serve_prompts(cfg, serve, seed)
    if eager_tokens is None:
        eager_tokens = _serve_streams(gen, model, cfg, serve,
                                      prompts)["tokens"]
    run = _serve_streams(gen, model, cfg, serve, prompts, capture=True)
    want = len(prompts) * cfg["layers"]
    if run["launches"] != want:
        raise RuntimeError("flash kernel ran %d times in the captured "
                           "unpaged run, want %d" % (run["launches"], want))
    if run["tokens"] != eager_tokens:
        raise RuntimeError("the captured unpaged streams differ from the "
                           "eager serve phase's")
    _require_decode_capture("the captured unpaged run", run["stats"],
                            on_card)
    flash += run["launches"]
    result["unpaged_capture"] = {
        k: run["stats"][k] for k in ("steps", "decode_path", "warmup_calls",
                                     "captures", "replays")}
    result["unpaged_capture"].update(
        flash_launches=run["launches"], equal_to_eager=True,
        decode_ms_per_step=run["decode_ms_per_step"])

    # 2. paged traffic through every arm; the paged ones gated
    prompts = paged_prompts(cfg, paged, seed)
    hits, saved, forks = expected_prefix_counts(prompts,
                                                paged["block_tokens"])
    T = paged["block_tokens"]
    arms, tokens = {}, {}
    for kv in ("f32", "int8"):
        for is_paged in (True, False):
            for capture in (False, True):
                name = "%s_%s_%s" % ("paged" if is_paged else "unpaged", kv,
                                     "captured" if capture else "eager")
                knobs = dict(kv_dtype=kv, capture=capture)
                if is_paged:
                    knobs.update(paged=True, block_tokens=T,
                                 num_blocks=paged["num_blocks"])
                run = _serve_streams(gen, model, cfg, paged, prompts,
                                     **knobs)
                st = run["stats"]
                want = 0 if is_paged else len(prompts) * cfg["layers"]
                if run["launches"] != want:
                    raise RuntimeError(
                        "%s: flash kernel ran %d times, want %d (the paged "
                        "prefill attends through an einsum)"
                        % (name, run["launches"], want))
                flash += run["launches"]
                if capture:
                    _require_decode_capture(name, st, on_card)
                row = {"decode_ms_per_step": run["decode_ms_per_step"],
                       "tokens_per_s": run["tokens_per_s"],
                       "ttft_ms": run["ttft_ms"], "wall_s": run["wall_s"],
                       "steps": st["steps"], "kv_bytes": st["kv_bytes"],
                       "flash_launches": run["launches"],
                       "max_memory_allocated": run.get(
                           "max_memory_allocated")}
                if is_paged:
                    got = (st["prefix_hits"], st["prefix_tokens_saved"],
                           st["cow_forks"])
                    if got != (hits, saved, forks):
                        raise RuntimeError(
                            "%s: prefix hits, tokens saved, forks %s; the "
                            "prompts give %s" % (name, got,
                                                 (hits, saved, forks)))
                    if not _waited_on_blocks(run["records"]):
                        raise RuntimeError("%s: no admission waited on "
                                           "blocks" % name)
                    if st["blocks_free"] != st["blocks_total"]:
                        raise RuntimeError("%s: %d of %d blocks free at the "
                                           "end" % (name, st["blocks_free"],
                                                    st["blocks_total"]))
                    row.update(blocks_peak=st["blocks_peak"],
                               blocks_total=st["blocks_total"])
                if kv == "int8":
                    # values 1 byte, scales 4, from the shapes alone
                    rows, cols = ((paged["num_blocks"] + 1, T) if is_paged
                                  else (paged["slots"],
                                        paged["max_context"]))
                    positions = cfg["layers"] * rows * cols
                    head = cfg["kv_heads"] * cfg["d_model"] // cfg["heads"]
                    want = 2 * positions * head + 2 * 4 * positions
                    if st["kv_bytes"] != want:
                        raise RuntimeError("%s: kv_bytes %d, want %d"
                                           % (name, st["kv_bytes"], want))
                arms[name] = row
                tokens[name] = run["tokens"]
    for kv in ("f32", "int8"):
        for kind in ("paged", "unpaged"):
            a, b = ("%s_%s_eager" % (kind, kv), "%s_%s_captured" % (kind, kv))
            if tokens[a] != tokens[b]:
                raise RuntimeError("%s: the captured streams differ from the "
                                   "eager ones" % b)
    result.update(arms=arms, prefix_hits=hits, prefix_tokens_saved=saved,
                  cow_forks=forks)

    # 3. teacher-forced: paged against unpaged (f32, eager), then int8
    # (captured) against f32 on both
    ref = forced_arms(gen, model, paged, prompts)
    forced = [toks for _, toks in ref["unpaged"]]
    checks = {"paged_vs_unpaged": [], "int8_unpaged": [], "int8_paged": []}
    for i, ((u, _), p) in enumerate(zip(ref["unpaged"], ref["paged"])):
        checks["paged_vs_unpaged"].append(_teacher_forced_gate(
            "paged vs unpaged, prompt %d" % paged["forced"][i], p, u,
            SERVE_ATOL, margin=PAGED_MARGIN))
    if not ref["plans"][1].forked or ref["plans"][1].ctx_len != \
            paged["system_len"]:
        raise RuntimeError("the teacher-forced joiner did not share and "
                           "fork: %s" % ref["plans"][1])

    # the direct check: 8 captured steps of the paged program from copies
    # of one pair of slabs against 8 eager ones, bit for bit. They replay
    # the last 8 teacher-forced steps (rows rewound by 8 positions, fed
    # the same tokens), so every write lands inside a reservation
    progs_e = ref["programs"][1]
    progs_c = gen.PagedDecodePrograms(
        model, paged["slots"], paged["max_context"],
        paged["prefill_buckets"], T, paged["num_blocks"], capture=True)
    cache = ref["cache"]
    lengths, tables = cache.step_arrays()
    n_direct = min(8, len(forced[0]))
    outs = []
    for progs in (progs_e, progs_c):
        k, v = cache.k_slab.clone(), cache.v_slab.clone()
        lens = lengths.astype(np.int64)
        logits = []
        for step in range(n_direct):
            toks = np.zeros(paged["slots"], np.int64)
            rows = np.zeros(paged["slots"], np.int64)
            for j, plan in enumerate(ref["plans"]):
                toks[plan.slot] = forced[j][len(forced[j]) - n_direct + step]
                rows[plan.slot] = lens[plan.slot] - n_direct + step
            logits.append(progs.decode(k, v, tables, rows, toks).clone())
        outs.append((torch.stack(logits), k, v))
    same = all(torch.equal(a, b) for a, b in zip(*outs))
    if not same:
        raise RuntimeError("%d captured paged decode steps differ from the "
                           "eager ones" % n_direct)
    st = progs_c.capture_stats()
    _require_decode_capture("the direct paged check", dict(
        st, decode_path=st["path"], steps=n_direct), on_card)
    result["direct_paged_capture"] = dict(st, steps=n_direct,
                                          bit_for_bit=same)
    del outs, progs_c, progs_e, cache

    i8 = forced_arms(gen, model, paged, prompts, kv_dtype="int8",
                     capture=True, forced=forced)
    for i, idx in enumerate(paged["forced"]):
        checks["int8_unpaged"].append(_teacher_forced_gate(
            "int8 unpaged, prompt %d" % idx, i8["unpaged"][i][0],
            ref["unpaged"][i][0], int8_tol, top=5))
        checks["int8_paged"].append(_teacher_forced_gate(
            "int8 paged, prompt %d" % idx, i8["paged"][i],
            ref["paged"][i], int8_tol, top=5))
    for progs in i8["programs"]:
        if on_card:
            st = progs.capture_stats()
            if st["path"] != "captured" or st["captures"] < 1:
                raise RuntimeError("the int8 teacher-forced run did not "
                                   "capture: %s" % st)
    result["teacher_forced"] = dict(
        checks, atol={"paged_vs_unpaged": SERVE_ATOL, "int8": int8_tol},
        margin=PAGED_MARGIN, steps=paged["max_new_tokens"])
    del i8, ref
    if on_card:
        result["prefill_saved"] = _prefill_saved(torch, gen, model, paged,
                                                 prompts)
        result["gpu"] = nvidia_smi()
    emit(result)
    return flash


def qmm_shapes(cfg):
    """(K, N, products a forward) of the LM's weight products: q and o, k
    and v, ffn up, ffn down, the head."""
    d, f, v, n = cfg["d_model"], cfg["ffn"], cfg["vocab"], cfg["layers"]
    dkv = d // cfg["heads"] * cfg["kv_heads"]
    return ((d, d, 2 * n), (d, dkv, 2 * n), (d, f, n), (f, d, n), (d, v, 1))


def int8_product_bound(m, k, n):
    """Least ms of an (m, K) x (K, n) int8 product with int32 results: its
    bytes (int8 operands read once, the int32 result written once) over
    the memory rate, or its operations over the int8 peak."""
    moved = m * k + k * n + 4 * m * n
    return max(moved / H100["bytes_per_s"],
               2.0 * m * k * n / H100["int8_ops"]) * 1e3


def _qmm_check(torch, cfg, device, seed):
    """quantized_matmul on ``device`` against its CPU path on the same
    operands at ``cfg``'s shapes, M = slots and slots x (k + 1), the
    weights quantized on ``device``. Returns, by weight type and
    strategy, the cases and the largest difference with its limit."""
    from mxnet_tpu_torch import quant
    from mxnet_tpu_torch.ops.matrix import quantized_matmul

    gen = torch.Generator().manual_seed(seed)
    cases = {}
    for K, N, _ in qmm_shapes(cfg):
        w = torch.randn(N, K, generator=gen) / K ** 0.5
        for wd in ("int8", "fp8_e4m3"):
            q, sc = quant.quantize_weight(w.to(device), wd, 0)
            q_cpu, sc_cpu = q.cpu(), sc.cpu()
            q_ref, sc_ref = quant.quantize_weight(w, wd, 0)
            if not (torch.equal(sc_cpu, sc_ref) and torch.equal(
                    q_cpu.view(torch.uint8), q_ref.view(torch.uint8))):
                raise RuntimeError("quantize_weight %s (%d, %d): the card's "
                                   "values or scales differ from the CPU's"
                                   % (wd, N, K))
            for m in (SERVE_SPEC["slots"],
                      SERVE_SPEC["slots"] * (SERVE_SPEC["spec_tokens"] + 1)):
                x = torch.randn(m, K, generator=gen)
                for act in (("int8", "float32", "bf16") if wd == "int8"
                            else ("float32", "bf16")):
                    got = quantized_matmul(x.to(device), q, sc, act).cpu()
                    want = quantized_matmul(x, q_cpu, sc_cpu, act)
                    err = float((got - want).abs().max())
                    top = float(want.abs().max())
                    if act == "int8":
                        limit, ok = 0.0, torch.equal(got, want)
                    elif act == "float32":
                        limit = QMM_F32_RTOL * top
                        ok = err <= limit
                    else:
                        limit = 2.0 ** (math.floor(math.log2(top)) - 7)
                        ok = err <= limit
                    if not ok:
                        raise RuntimeError(
                            "quantized_matmul %s %s (%d, %d) x (%d, %d): the "
                            "card differs from the CPU by %g (limit %g)"
                            % (wd, act, m, K, N, K, err, limit))
                    key = "%s/%s" % (wd, act)
                    row = cases.setdefault(key, {"cases": 0,
                                                 "max_abs_err": 0.0,
                                                 "worst_limit": limit})
                    row["cases"] += 1
                    if err >= row["max_abs_err"]:
                        row.update(max_abs_err=err, worst_limit=limit)
    return cases


def _quantize_ops_check(torch, device, seed):
    """The ``quantize`` / ``dequantize`` ops on ``device`` against the CPU
    on the same inputs, bit for bit: uint8 over a calibration range
    (ranges drawn from ``seed``, each with inputs at every k + 0.5 of its
    scaled grid, where a scale one ulp off rounds to the other neighbour,
    and the example lo -1.3079847, hi 0.087778695, x -0.98778015, which
    must give 59), int8 and fp8-e4m3 per tensor and per channel; then each
    dequantized back. Returns the cases checked by type."""
    from mxnet_tpu_torch.ops import registry as reg

    def run(name, arrays, attrs, dev):
        op = reg.get_op(name)
        outs, _ = op.impl(op.parse_attrs(dict(attrs)),
                          tuple(a.to(dev) for a in arrays), (),
                          reg.OpContext())
        return [o.cpu() for o in outs]

    def same(a, b):
        if a.dtype == torch.float8_e4m3fn:
            a, b = a.view(torch.uint8), b.view(torch.uint8)
        return a.dtype == b.dtype and torch.equal(a, b)

    gen = torch.Generator().manual_seed(seed)
    cases = [({"out_type": "uint8"}, torch.tensor([-0.98778015]),
              torch.tensor([-1.3079847]), torch.tensor([0.087778695]))]
    for _ in range(16):
        lo = -3 * torch.rand(1, generator=gen)
        hi = 3 * torch.rand(1, generator=gen)
        scale = 255.0 / (hi - lo).double()
        x = ((torch.arange(255, dtype=torch.float64) + 0.5) / scale
             + lo.double()).float()
        cases.append(({"out_type": "uint8"}, x, lo, hi))
    w = torch.randn(64, 96, generator=gen)
    one = torch.zeros(1)
    for out_type in ("int8", "fp8_e4m3"):
        for axis in (None, 0):
            cases.append(({"out_type": out_type, "axis": axis}, w, one, one))
    counts = {}
    for attrs, x, lo, hi in cases:
        got = run("quantize", (x, lo, hi), attrs, device)
        want = run("quantize", (x, lo, hi), attrs, "cpu")
        back = run("dequantize", want, {}, device)
        back_want = run("dequantize", want, {}, "cpu")
        if not all(same(a, b) for a, b in zip(got + back, want + back_want)):
            raise RuntimeError("quantize / dequantize %s: the card differs "
                               "from the CPU" % attrs)
        counts[attrs["out_type"]] = counts.get(attrs["out_type"], 0) + 1
    if run("quantize", cases[0][1:], cases[0][0], device)[0].tolist() != [59]:
        raise RuntimeError("uint8 quantize of the example gives %s, want 59"
                           % run("quantize", cases[0][1:], cases[0][0],
                                 device)[0].tolist())
    return {"cases": counts, "bit_for_bit": True}


def _qmm_timing(torch, cfg):
    """The int8 product at M = slots (padded to INT_MM_PAD_ROWS on the
    card) at each LM shape, beside its bound, the whole int8 path and the
    f32 product it replaces (CUDA events). Sums over one decode step's
    products."""
    from mxnet_tpu_torch.ops import matrix

    m = SERVE_SPEC["slots"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for K, N, count in qmm_shapes(cfg):
        xq = torch.randint(-127, 128, (m, K), dtype=torch.int8,
                           device="cuda", generator=gen)
        w = torch.randint(-127, 128, (N, K), dtype=torch.int8,
                          device="cuda", generator=gen)
        x = torch.randn(m, K, device="cuda", generator=gen)
        wf = torch.randn(N, K, device="cuda", generator=gen)
        sc = torch.rand(N, device="cuda", generator=gen)
        rows.append({
            "K": K, "N": N, "per_step": count,
            "int8_product_ms": time_ms(
                torch, lambda: matrix.int8_product(xq, w)),
            "bound_ms": int8_product_bound(m, K, N),
            "quantized_matmul_int8_ms": time_ms(
                torch, lambda: matrix.quantized_matmul(x, w, sc, "int8")),
            "f32_product_ms": time_ms(torch, lambda: x @ wf.t())})
    step = {k: sum(r[k] * r["per_step"] for r in rows)
            for k in ("int8_product_ms", "bound_ms",
                      "quantized_matmul_int8_ms", "f32_product_ms")}
    return {"M": m, "padded_to": matrix.INT_MM_PAD_ROWS, "shapes": rows,
            "decode_step": step,
            "library": "torch._int_mm (cuBLASLt int8, int32 results)"}


def _spec_vs_vanilla(gen, model, conf, prompts, got, want, kv_dtype,
                     what="the speculative stream"):
    """Streams ``got`` against ``want`` (vanilla, same KV layout and
    type): equal, or the first difference at a position where the vanilla
    logits' top-2 margin (teacher-forced, unpaged, ``kv_dtype``) is at
    most PAGED_MARGIN. Returns those positions."""
    near_ties = []
    progs = None
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        pos = next(m for m, (a, b) in enumerate(zip(g, w)) if a != b)
        if progs is None:
            progs = gen.DecodePrograms(model, conf["slots"],
                                       conf["max_context"],
                                       conf["prefill_buckets"],
                                       kv_dtype=kv_dtype)
        logits, _ = forced_unpaged(progs, prompts[i], pos, w[:pos])
        top = np.sort(logits[pos])[::-1]
        margin = float(top[0] - top[1])
        if margin > PAGED_MARGIN:
            raise RuntimeError(
                "prompt %d: %s leaves the vanilla one at token %d, where "
                "the vanilla top-2 margin is %g (> %g)"
                % (i, what, pos, margin, PAGED_MARGIN))
        near_ties.append({"prompt": i, "position": pos, "margin": margin})
    return near_ties


def _require_spec_capture(what, stats, k, on_card):
    """A captured spec run took the captured path: the draft step (k calls
    an iteration) and the verify (one) each 2 warm-ups, 1 capture and a
    replay for every later call."""
    if not on_card:
        if stats["decode_path"] != "eager" or stats["verify_path"] != "eager":
            raise RuntimeError("%s: decode / verify path %r / %r on the CPU"
                               % (what, stats["decode_path"],
                                  stats["verify_path"]))
        return
    steps = stats["steps"]
    want = {"decode_path": "captured", "warmup_calls": 2, "captures": 1,
            "replays": k * steps - 2, "verify_path": "captured",
            "verify_warmup_calls": 2, "verify_captures": 1,
            "verify_replays": steps - 2}
    got = {key: stats[key] for key in want}
    if got != want:
        raise RuntimeError("%s did not take the captured path: %s, want %s"
                           % (what, got, want))


def phase_serve_spec(cfg=LM, conf=SERVE_SPEC, device=None, seed=SEED,
                     quant_tol=None, self_accept=None):
    """Speculative decoding and int8 / fp8 weights at full width: SERVE_SPEC's
    traffic through vanilla, quantized-weight and speculative arms, with
    the gates of the docstring's phase 3c. ``quant_tol``: the
    quant_weights gates (None: QUANT_WEIGHTS_TOL); ``self_accept``: the
    self draft's least accept rate (None: SPEC_SELF_ACCEPT). Returns the
    flash launches."""
    import torch

    from mxnet_tpu_torch import quant
    from mxnet_tpu_torch.serving import generate as gen

    t0 = time.monotonic()
    quant_tol = QUANT_WEIGHTS_TOL if quant_tol is None else quant_tol
    self_accept = SPEC_SELF_ACCEPT if self_accept is None else self_accept
    params = lm_arg_params(cfg, seed)
    spec = gen.DecodeSpec(num_heads=cfg["heads"],
                          num_kv_heads=cfg["kv_heads"])
    model = gen.DecodeModel.from_arg_params(params, spec, device=device)
    on_card = model.device.type == "cuda"
    prompts = paged_prompts(cfg, conf, seed)
    k = conf["spec_tokens"]
    W = k + 1
    per_forward = sum(c for _, _, c in qmm_shapes(cfg))
    paged_knobs = dict(paged=True, block_tokens=conf["block_tokens"],
                       num_blocks=conf["num_blocks"])
    result = {"phase": "serve_spec", "prompts": [len(p) for p in prompts],
              "spec_tokens": k, "max_new_tokens": conf["max_new_tokens"]}
    if on_card:
        result["gpu"] = nvidia_smi()

    # 1. the product and the quantize ops: card against CPU, and the int8
    # product's time
    result["quantized_matmul"] = _qmm_check(torch, cfg, model.device, seed)
    result["quantize_ops"] = _quantize_ops_check(torch, model.device, seed)
    if on_card:
        result["int8_product"] = _qmm_timing(torch, cfg)

    # 2. the arms
    arms = [
        ("vanilla_unpaged_f32", dict(capture=True)),
        ("vanilla_paged_f32", dict(capture=True, **paged_knobs)),
        ("vanilla_paged_int8", dict(capture=True, kv_dtype="int8",
                                    **paged_knobs)),
        ("quant_int8_unpaged_f32", dict(capture=True, quant_weights="int8")),
        ("quant_fp8_unpaged_f32", dict(capture=True, quant_weights="fp8")),
        ("spec_int8_unpaged_f32_eager", dict(spec=True)),
        ("spec_int8_unpaged_f32_captured", dict(spec=True, capture=True)),
        ("spec_self_unpaged_f32_captured", dict(spec=True, capture=True,
                                                spec_draft="self")),
        ("spec_int8_paged_f32_captured", dict(spec=True, capture=True,
                                              **paged_knobs)),
        ("spec_int8_paged_int8_captured", dict(spec=True, capture=True,
                                               kv_dtype="int8",
                                               **paged_knobs)),
        ("sampled_int8_paged_f32_captured", dict(
            spec=True, capture=True, temperature=conf["temperature"],
            **paged_knobs)),
        ("sampled_int8_paged_f32_captured_again", dict(
            spec=True, capture=True, temperature=conf["temperature"],
            **paged_knobs))]
    rows, tokens, flash = {}, {}, 0
    for name, knobs in arms:
        knobs = dict(knobs)
        if knobs.get("spec"):
            knobs.update(spec_tokens=k, spec_draft=knobs.get("spec_draft",
                                                             "int8"))
        run = _serve_streams(gen, model, cfg, conf, prompts, seed=seed,
                             **knobs)
        st = run["stats"]
        is_paged = knobs.get("paged", False)
        want = 0 if is_paged else len(prompts) * cfg["layers"]
        if run["launches"] != want:
            raise RuntimeError("%s: flash kernel ran %d times, want %d (a "
                               "prompt and layer unpaged, none paged, none "
                               "in a verify)" % (name, run["launches"], want))
        flash += run["launches"]
        # the int8 products the path must make: a forward of the int8
        # draft per draft step, of the int8 model per prefill and step
        if knobs.get("spec") and knobs["spec_draft"] == "int8":
            want = per_forward * k * st["steps"]
        elif knobs.get("quant_weights") == "int8":
            want = per_forward * (len(prompts) + st["steps"])
        else:
            want = 0
        if run["int8_products"] != want:
            raise RuntimeError("%s: %d int8 products, want %d"
                               % (name, run["int8_products"], want))
        if knobs.get("capture"):
            if knobs.get("spec"):
                _require_spec_capture(name, st, k, on_card)
            else:
                _require_decode_capture(name, st, on_card)
        if is_paged and st["blocks_free"] != st["blocks_total"]:
            raise RuntimeError("%s: %d of %d blocks free at the end"
                               % (name, st["blocks_free"],
                                  st["blocks_total"]))
        if knobs.get("spec") and not st["step_tokens"] > st["seq_steps"]:
            raise RuntimeError("%s: %d tokens in %d sequence-iterations"
                               % (name, st["step_tokens"], st["seq_steps"]))
        rows[name] = {
            "tokens_per_s": run["tokens_per_s"],
            "ms_per_token": run["ms_per_token"],
            "ttft_ms": float(np.median(run["ttft_ms"])),
            "wall_s": run["wall_s"], "steps": st["steps"],
            "accept_rate": st["decode_spec_accept_rate"],
            "tokens_per_seq_step": st["decode_tokens_per_step"],
            "drafted": st["drafted_tokens"],
            "accepted": st["accepted_tokens"],
            "int8_products": run["int8_products"],
            "flash_launches": run["launches"],
            "max_memory_allocated": run.get("max_memory_allocated")}
        tokens[name] = run["tokens"]
    for name, row in rows.items():
        # against vanilla captured of the same KV layout and type
        parts = name.split("_")
        kind = "paged" if "paged" in parts else "unpaged"
        ref = "vanilla_%s_%s" % (kind, parts[parts.index(kind) + 1])
        row["tokens_per_s_vs_vanilla"] = (row["tokens_per_s"]
                                          / rows[ref]["tokens_per_s"])
    result["arms"] = rows

    # 3. streams: greedy spec = vanilla; captured = eager; sampled twice
    near_ties = {}
    for name, ref, kv in (
            ("spec_int8_unpaged_f32_eager", "vanilla_unpaged_f32", "float32"),
            ("spec_int8_unpaged_f32_captured", "vanilla_unpaged_f32",
             "float32"),
            ("spec_self_unpaged_f32_captured", "vanilla_unpaged_f32",
             "float32"),
            ("spec_int8_paged_f32_captured", "vanilla_paged_f32", "float32"),
            ("spec_int8_paged_int8_captured", "vanilla_paged_int8", "int8")):
        near_ties[name] = _spec_vs_vanilla(gen, model, conf, prompts,
                                           tokens[name], tokens[ref], kv)
        for tie in near_ties[name]:
            print("serve_spec: %s leaves %s at prompt %d token %d, vanilla "
                  "top-2 margin %g" % (name, ref, tie["prompt"],
                                       tie["position"], tie["margin"]),
                  flush=True)
    if tokens["spec_int8_unpaged_f32_captured"] != \
            tokens["spec_int8_unpaged_f32_eager"]:
        raise RuntimeError("the captured spec streams differ from the eager "
                           "ones")
    if tokens["sampled_int8_paged_f32_captured"] != \
            tokens["sampled_int8_paged_f32_captured_again"]:
        raise RuntimeError("two sampled spec runs from one seed differ")
    rate = rows["spec_self_unpaged_f32_captured"]["accept_rate"]
    if rate < self_accept:
        raise RuntimeError("the self draft accepted %g of its drafts (want "
                           ">= %g)" % (rate, self_accept))
    result.update(near_ties=near_ties, captured_equals_eager=True,
                  sampled_repeats=True,
                  int8_accept_rate={
                      "measured": rows["spec_int8_unpaged_f32_captured"][
                          "accept_rate"],
                      "predicted": SPEC_INT8_ACCEPT_PREDICTED})

    # 4. teacher-forced: the verify fed vanilla streams as windows against
    # the decode logits; the quantized weights against f32
    steps = conf["max_new_tokens"] - 1
    verify_err, forced = {}, None
    for kv in ("float32", "int8"):
        ref = forced_arms(gen, model, conf, prompts, kv_dtype=kv,
                          capture=True, forced=forced)
        if forced is None:
            forced = [toks for _, toks in ref["unpaged"]]
            f32_ref = ref["unpaged"]
        unpaged, progs = ref["programs"]
        unpaged.enable_verify(W)
        progs.enable_verify(W)
        cache = gen.PagedKVCacheManager(progs)
        errs = {"unpaged": [], "paged": []}
        for i, idx in enumerate(conf["forced"]):
            got = forced_verify(unpaged, prompts[idx], forced[i], W)
            errs["unpaged"].append(float(np.abs(
                got - ref["unpaged"][i][0][1:]).max()))
            got, _ = forced_verify_paged(progs, cache, prompts[idx],
                                         conf["max_new_tokens"], forced[i], W)
            errs["paged"].append(float(np.abs(
                got - ref["paged"][i][1:]).max()))
        worst = max(max(v) for v in errs.values())
        if worst > SERVE_ATOL:
            raise RuntimeError("%s KV: the verify fed the vanilla stream "
                               "differs from the decode logits by %g (limit "
                               "%g): %s" % (kv, worst, SERVE_ATOL, errs))
        if on_card:
            for p in (unpaged, progs):
                st = p.capture_stats()["verify"]
                if st["path"] != "captured" or not st["captures"] \
                        or not st["replays"]:
                    raise RuntimeError("the teacher-forced verify did not "
                                       "capture: %s" % st)
        verify_err[kv] = errs
        del ref, unpaged, progs, cache
    quant_err = {}
    for arm, weight in (("int8", "int8"), ("fp8", "fp8_e4m3")):
        qm = quant.quantize_decode_model(
            model, quant.QuantConfig(weight_dtype=weight, act_dtype="int8"))
        progs = gen.DecodePrograms(qm, conf["slots"], conf["max_context"],
                                   conf["prefill_buckets"], capture=True)
        quant_err[arm] = [_teacher_forced_gate(
            "quant_weights %s, prompt %d" % (arm, idx),
            forced_unpaged(progs, prompts[idx], steps, forced[i])[0],
            f32_ref[i][0], quant_tol[arm], top=5)
            for i, idx in enumerate(conf["forced"])]
        del qm, progs
    result["teacher_forced"] = {
        "verify_vs_decode": verify_err, "verify_atol": SERVE_ATOL,
        "quant_weights": quant_err, "quant_tol": quant_tol,
        "steps": steps, "window": W}
    result["seconds"] = time.monotonic() - t0
    emit(result)
    return flash


def parse_exposition(text):
    """{sample name with labels: value} of a Prometheus text exposition;
    raises on a line that is neither a HELP / TYPE comment nor a sample,
    or a sample before its family's TYPE."""
    samples, typed = {}, set()
    for line in text.splitlines():
        if line.startswith(("# HELP ", "# TYPE ")):
            if line.startswith("# TYPE "):
                typed.add(line.split()[2])
            continue
        m = PROM_SAMPLE.match(line)
        if m is None:
            raise RuntimeError("exposition line %r is not Prometheus text"
                               % line)
        name = m.group(1)
        family = re.sub(r"(_bucket|_sum|_count)$", "", name.split("{")[0])
        if family not in typed and name.split("{")[0] not in typed:
            raise RuntimeError("exposition sample %r has no TYPE line"
                               % name)
        samples[name] = float(m.group(5))
    return samples


def _profiled(run, path):
    """``run()`` inside a profiler window (``profiler_set_state("run")``
    ... ``dump_profile()`` to ``path``); returns its result and the dump's
    events."""
    from mxnet_tpu_torch import profiler

    profiler.profiler_set_config(filename=path)
    profiler.profiler_set_state("run")
    try:
        out = run()
    finally:
        profiler.profiler_set_state("stop")
    with open(profiler.dump_profile()) as f:
        events = json.load(f)["traceEvents"]
    return out, events


def _event_counts(events, parts, cat):
    """{name: events of category ``cat`` whose name holds one of
    ``parts[name]``}."""
    return {k: sum(1 for e in events if e.get("cat") == cat and any(
        p in e.get("name", "") for p in ps)) for k, ps in parts.items()}


def _host_spans(events, domain, name):
    return [e for e in events if e.get("cat") == domain
            and e.get("name") == name and e.get("ph") == "X"]


def _deadline_bundle(gen, model, cfg, serve, prompt, work):
    """A stream whose deadline passes before it is served (timeout 0,
    beside one served stream of 2 tokens), with ``MXNET_FLIGHT_DIR`` a
    fresh directory: it must fail with ``deadline_exceeded`` and leave
    exactly one ``deadline_miss`` bundle naming its trace."""
    from mxnet_tpu_torch.serving import ServingError
    from mxnet_tpu_torch.telemetry import context as tctx

    flight_dir = os.path.join(work, "flight")
    was = os.environ.get("MXNET_FLIGHT_DIR")
    os.environ["MXNET_FLIGHT_DIR"] = flight_dir
    try:
        config = gen.GenerateConfig(
            num_heads=cfg["heads"], num_kv_heads=cfg["kv_heads"],
            slots=serve["slots"], max_context=serve["max_context"],
            prefill_buckets=serve["prefill_buckets"], max_new_tokens=2,
            eos_id=None, paged=False, kv_dtype="f32", capture=False,
            quant_weights="", spec=False)
        sched = gen.DecodeScheduler(model, config)
        sched.start()
        trace = tctx.mint(request_id="deadline")
        try:
            served = sched.submit(prompt)
            late = sched.submit(prompt, timeout_ms=0.0, trace=trace)
            served_tokens = served.tokens(timeout=600)
            try:
                late.tokens(timeout=600)
                code = None
            except ServingError as e:
                code = e.code
        finally:
            sched.stop()
    finally:
        if was is None:
            os.environ.pop("MXNET_FLIGHT_DIR", None)
        else:
            os.environ["MXNET_FLIGHT_DIR"] = was
    files = sorted(os.listdir(flight_dir)) if os.path.isdir(flight_dir) \
        else []
    bundle = {}
    if len(files) == 1:
        with open(os.path.join(flight_dir, files[0])) as f:
            bundle = json.load(f)
    if code != "deadline_exceeded" or len(served_tokens) != 2 or \
            len(files) != 1 or bundle.get("trigger") != "deadline_miss" or \
            bundle.get("trace_id") != trace.trace_id:
        raise RuntimeError(
            "serve_trace: the late stream ended %r and left bundles %s "
            "(trigger %r, trace %s), want deadline_exceeded and one "
            "deadline_miss bundle of trace %s"
            % (code, files, bundle.get("trigger"), bundle.get("trace_id"),
               trace.trace_id))
    return {"code": code, "bundles": files, "trigger": bundle["trigger"],
            "victim_spans": (bundle.get("victim") or {}).get("n_spans")}


def _span_cost_us(telemetry, calls=20000):
    """Host µs of one span (enter and exit, two arguments) with its domain
    on, and with it off (the shared no-op), each the median of 5 runs of
    ``calls``; the recorded events are dropped."""
    def per_call(on):
        times = []
        for _ in range(5):
            if on:
                telemetry.enable_spans("serving")
            t0 = time.perf_counter()
            for _ in range(calls):
                with telemetry.span("cost", domain="serving", rows=4,
                                    spec=0):
                    pass
            times.append((time.perf_counter() - t0) / calls * 1e6)
            telemetry.disable_spans()
            telemetry.reset()
        return float(np.median(times))

    return {"on": per_call(True), "off": per_call(False)}


def _profiled_launches(torch, run, counters, parts, work, name, on_card):
    """``run()`` under the profiler: each counter's launches beside the
    kernel events of its kernels in the dump (printed, not gated)."""
    _fresh(torch, on_card)
    _zero(counters)
    _, events = _profiled(run, os.path.join(work, name + ".json"))
    launches = _count(counters)
    seen = _event_counts(events, parts, "kernel")
    return {k: {"launches": launches[k], "events": seen[k]}
            for k in parts}


def phase_serve_trace(cfg=LM, serve=SERVE, device=None, seed=SEED,
                      kernel_event=FA_EVENT, train=TRAIN, resnet=RESNET):
    """The traced serve path at full width: ``serve``'s traffic through
    the unpaged scheduler with the decode step captured, five times:
    spans off, spans on, inside a profiler window (``profiler_set_state``
    / ``dump_profile``), spans off and on again. Gates: (1) the same tokens in
    every run; (2) the same captured path (warm-ups, one capture, a replay
    a later step) in every run; (3) the dump parses and holds one
    ``decode.prefill`` and one ``serving.queued`` span a request and one
    ``decode.step`` a scheduler step, each stream's trace id on its queued
    span and in the ``trace_ids`` of every step it shared; (4) the dump's
    ``kernel_event`` events (category, part of the name: the flash
    forward's CUDA kernels on the card) as many as the flash launch
    counter rose in the window; (5) the registry's exposition parses as
    Prometheus text and ``kv_bytes``, ``decode_tokens_total`` (its rise),
    ``decode_spec_accept_rate`` and ``decode_tokens_per_step`` read the
    scheduler's stats; (6) a stream that misses its deadline writes one
    flight bundle. Prints the step ms of each run and the spans' cost a
    step; then (not gated) the train phase's run (``train``) and
    ResNet-50's epoch (``resnet``) under the profiler, each kernel's
    events beside its launch counter. Returns the flash launches."""
    import tempfile

    import torch

    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.serving import generate as gen
    from mxnet_tpu_torch.telemetry import context as tctx

    t0 = time.monotonic()
    params = lm_arg_params(cfg, seed)
    spec = gen.DecodeSpec(num_heads=cfg["heads"],
                          num_kv_heads=cfg["kv_heads"])
    model = gen.DecodeModel.from_arg_params(params, spec, device=device)
    on_card = model.device.type == "cuda"
    prompts = serve_prompts(cfg, serve, seed)
    n = len(prompts)
    result = {"phase": "serve_trace", "requests": n,
              "prompt_lens": [len(p) for p in prompts],
              "max_new_tokens": serve["max_new_tokens"]}
    if on_card:
        result["gpu"] = nvidia_smi()
    work = tempfile.mkdtemp(prefix="serve_trace_")
    tokens_total = telemetry.registry.counter("decode_tokens_total")
    try:
        def serve_run(traces=None):
            return _serve_streams(gen, model, cfg, serve, prompts,
                                  capture=True, traces=traces,
                                  together=True)

        def spans_run():
            telemetry.enable_spans("all")
            try:
                run = serve_run([tctx.mint() for _ in prompts])
            finally:
                telemetry.disable_spans()
            recorded = telemetry.drain_events()
            run["step_spans_ms"] = [e[4] / 1e6 for e in recorded
                                    if e[1] == "decode.step"
                                    and e[2] == "serving"]
            run["events"] = len(recorded)
            return run

        # 1. spans off and on, the profiled window, off and on again
        runs = {"off": serve_run(), "spans": spans_run()}
        traces = [tctx.mint(request_id="serve%d" % i) for i in range(n)]
        before = tokens_total.value
        runs["profiled"], events = _profiled(
            lambda: serve_run(traces), os.path.join(work, "serve.json"))
        rose = tokens_total.value - before
        samples = parse_exposition(telemetry.registry.exposition())
        runs["off_again"] = serve_run()
        runs["spans_again"] = spans_run()
        traced = runs["profiled"]
        failures = []

        # gates 1-2: tokens and the captured path
        for name, run in runs.items():
            if run["tokens"] != runs["off"]["tokens"]:
                failures.append("the %s run's tokens differ from the "
                                "spans-off run's" % name)
            _require_decode_capture("serve_trace " + name, run["stats"],
                                    on_card)
        paths = {name: {k: run["stats"][k] for k in (
            "steps", "warmup_calls", "captures", "replays")}
            for name, run in runs.items()}
        if len({tuple(p.values()) for p in paths.values()}) != 1:
            failures.append("the runs took other paths: %s" % paths)

        # gate 3: the host spans
        steps = traced["stats"]["steps"]
        counts = {k: len(_host_spans(events, "serving", k)) for k in (
            "serving.queued", "serving.dispatch", "decode.prefill",
            "decode.step")}
        want = {"serving.queued": n, "serving.dispatch": n,
                "decode.prefill": n, "decode.step": steps}
        if counts != want:
            failures.append("the dump holds spans %s, want %s"
                            % (counts, want))
        queued = [e["args"]["trace_id"] for e in
                  _host_spans(events, "serving", "serving.queued")]
        shared = {}
        for e in _host_spans(events, "serving", "decode.step"):
            for tid in e.get("args", {}).get("trace_ids", ()):
                shared[tid] = shared.get(tid, 0) + 1
        for i, tr in enumerate(traces):
            rode = len(traced["tokens"][i]) - 1
            if queued.count(tr.trace_id) != 1 or \
                    shared.get(tr.trace_id) != rode:
                failures.append(
                    "stream %d's trace is on %d queued spans and %s steps, "
                    "want 1 and %d" % (i, queued.count(tr.trace_id),
                                       shared.get(tr.trace_id), rode))

        # gate 4: the kernel's device events against its launch counter
        cat, part = kernel_event
        seen = _event_counts(events, {"flash": (part,)}, cat)["flash"]
        if seen != traced["launches"] or seen == 0:
            failures.append("the dump holds %d %s events of %r, the flash "
                            "counter rose by %d" % (seen, cat, part,
                                                    traced["launches"]))

        # gate 5: the gauges against stats()
        st = traced["stats"]
        gauges = {"kv_bytes": samples.get("kv_bytes"),
                  "decode_tokens_total": rose,
                  "decode_spec_accept_rate": samples.get(
                      "decode_spec_accept_rate"),
                  "decode_tokens_per_step": samples.get(
                      "decode_tokens_per_step")}
        stated = {"kv_bytes": st["kv_bytes"],
                  "decode_tokens_total": sum(len(t) for t in
                                             traced["tokens"]),
                  "decode_spec_accept_rate": st["decode_spec_accept_rate"],
                  "decode_tokens_per_step": st["decode_tokens_per_step"]}
        if gauges != stated:
            failures.append("gauges %s, stats %s" % (gauges, stated))

        # gate 6: a deadline miss writes one flight bundle
        deadline = _deadline_bundle(gen, model, cfg, serve,
                                    min(prompts, key=len), work)
        if failures:
            raise RuntimeError("serve_trace: " + "; ".join(failures))

        step_ms = {name: run["decode_ms_per_step"]
                   for name, run in runs.items()}
        off_ms = (step_ms["off"] + step_ms["off_again"]) / 2
        on_ms = (step_ms["spans"] + step_ms["spans_again"]) / 2
        span_ms = [e["dur"] / 1e3 for e in
                   _host_spans(events, "serving", "decode.step")]
        result.update({
            "tokens_equal": True, "paths": paths, "spans": counts,
            "trace_ids_fan_out": True,
            "flash_events": seen, "flash_launches": traced["launches"],
            "kernel_event": list(kernel_event),
            "dump_events": len(events),
            "gauges": gauges,
            "deadline": deadline,
            "step_ms": step_ms,
            "span_overhead_us": (on_ms - off_ms) * 1e3,
            "profiled_overhead_us": (step_ms["profiled"] - off_ms) * 1e3,
            "span_overhead_predicted_us": SPAN_OVERHEAD_PREDICTED_US,
            "decode_step_span_ms_median": {
                "profiled": float(np.median(span_ms)),
                "spans": float(np.median(runs["spans"]["step_spans_ms"])),
                "spans_again": float(np.median(
                    runs["spans_again"]["step_spans_ms"]))},
            "off_spread_us": abs(step_ms["off"] - step_ms["off_again"])
            * 1e3,
            "events_per_step": runs["spans"]["events"]
            / runs["spans"]["stats"]["steps"],
            "span_host_us": _span_cost_us(telemetry)})
        del model

        # the train and resnet runs under the profiler (printed only)
        counters = _counters()
        profiled = {"train": _profiled_launches(
            torch, lambda: _train_run(torch, cfg, train, device, seed, True,
                                      on_card, counters),
            counters, TRAIN_EVENTS, work, "train", on_card)}
        rcounters = _resnet_counters()

        def resnet_epoch():
            mod, it, init = resnet_setup(resnet, resnet["batch"],
                                         resnet["batches"], device, seed,
                                         compute_dtype=resnet["dtype"])
            mod.fit(it, **fit_args(resnet, init))
            if on_card:
                torch.cuda.synchronize()

        profiled["resnet"] = _profiled_launches(
            torch, resnet_epoch, rcounters, RESNET_EVENTS, work, "resnet",
            on_card)
        result["profiled_runs"] = profiled
    finally:
        shutil.rmtree(work, ignore_errors=True)
    result["seconds"] = time.monotonic() - t0
    emit(result)
    return sum(run["launches"] for run in runs.values())


def _note(msg):
    """A progress line of the serve_fixed phase on stderr (the phase's
    result is one line on stdout at its end)."""
    print("serve_fixed: %s" % msg, file=sys.stderr, flush=True)


def _lm_feed(cfg, bt, seed):
    """Seeded token ids at (B, T) and a zero label (the head's label, an
    input neither package infers through its Reshape)."""
    ids = np.random.RandomState(seed).randint(0, cfg["vocab"], bt)
    return {"data": ids.astype(np.float32),
            "softmax_label": np.zeros(bt, np.float32)}


def _lm_shapes(bt):
    return {"data": tuple(bt), "softmax_label": tuple(bt)}


def _forward_calls(preds):
    """Forwards that ran kernels: warm-ups, replays and eager calls (a
    capture runs none)."""
    return sum(p.warmup_calls + p.replays + p.eager_calls for p in preds)


def _require_predictor_capture(what, p, on_card):
    """A predictor bound on the card took the captured path: two warm-ups,
    one capture, a replay a forward; on the CPU it ran eagerly."""
    st = p.capture_stats()
    if not on_card:
        if st["path"] != "eager" or st["captures"]:
            raise RuntimeError("%s: path %s on the CPU" % (what, st))
        return st
    if (st["path"], st["warmup_calls"], st["captures"],
            st["eager_calls"]) != ("captured", 2, 1, 0) or not st["replays"]:
        raise RuntimeError("%s did not take the captured path: %s"
                           % (what, st))
    return st


def _flash_at(torch, b, t, cfg, gen):
    """The flash forward at a Predictor shape (f32, causal, the (B, T, H,
    D) views MultiHeadAttention passes): kernel against plain, then timed
    beside the plain version, SDPA and its bound."""
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa

    h, hkv, d = cfg["heads"], cfg["kv_heads"], cfg["d_model"] // cfg["heads"]
    q, k, v = _qkv(torch, b, h, hkv, t, t, d, "float32", gen, False)
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention_plain(q, k, v, causal=True)
    atol, rtol = TOL["float32"]
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)
    err = float((got - want).abs().max())
    kernel = functools.partial(fa.flash_attention, q, k, v, causal=True)
    library = _sdpa(torch, q, k, v)
    bound_ms, bound_by = attention_bound(b, h, hkv, t, t, d, True,
                                         "float32")
    out = {"shape": [b, h, hkv, t, t, d], "dtype": "float32",
           "causal": True, "layout": LAYOUTS[False], "max_abs_err": err,
           "ms": time_ms(torch, kernel),
           "device_ms": device_ms(torch, kernel),
           "plain_ms": time_ms(torch, lambda: fa.flash_attention_plain(
               q, k, v, causal=True), reps=10),
           "library_ms": time_ms(torch, library),
           "library_device_ms": device_ms(torch, library),
           "bound_ms": bound_ms, "bound_by": bound_by}
    del q, k, v, got, want
    torch.cuda.empty_cache()
    return out


def _lm_predictor_part(torch, cfg, fixed, device, ref_device, seed,
                       on_card):
    """(1) bench.py's LM with its SoftmaxOutput head through
    ``predict.Predictor``: bound at the first of ``fixed["lm_shapes"]``,
    reshaped to the others (the same weight tensors); each forward's
    outputs, the flash launches (the LM's layers a kernel-running
    forward), the captured path and, with the forward eager
    (MXNET_CUDA_GRAPH=0, reshapes of the same weights), the same outputs
    bit for bit; the card against the port's CPU Predictor at the first
    shape (SERVE_ATOL, the argmax where the CPU's top-2 margin exceeds
    PAGED_MARGIN)."""
    from mxnet_tpu_torch import predict
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa

    params = lm_arg_params(cfg, seed)
    sym = lm_predict_symbol(cfg).tojson()
    shapes = [tuple(bt) for bt in fixed["lm_shapes"]]
    feeds = [_lm_feed(cfg, bt, seed + 20 + i) for i, bt in enumerate(shapes)]
    fa.flash_attention.launches = 0
    c0 = predict.compile_count()
    base = predict.Predictor(sym, params, _lm_shapes(shapes[0]),
                             device=device)
    _note("LM bound at %s" % (shapes[0],))
    preds = [base] + [base.reshape(_lm_shapes(bt)) for bt in shapes[1:]]
    shared = all(q._arg_params[n]._data.data_ptr()
                 == base._arg_params[n]._data.data_ptr()
                 for q in preds for n in base._arg_params)
    if not shared:
        raise RuntimeError("serve_fixed: a reshape copied the LM's weights")
    outs, ms = [], {}
    for bt, p, f in zip(shapes, preds, feeds):
        o = p.forward(**f)[0]
        want = (bt[0] * bt[1], cfg["vocab"])
        if tuple(o.shape) != want:
            raise RuntimeError("serve_fixed: the LM at %s gave %s, want %s"
                               % (bt, o.shape, want))
        outs.append(o._data.cpu().numpy())
        if on_card:
            ms["%dx%d" % bt] = time_ms(torch, lambda: p.forward(**f), reps=5,
                                       warmup=1)
    with cuda_graph(False):
        eager = [base.reshape(_lm_shapes(bt)) for bt in shapes]
    eager_ms = {}
    for bt, e, f, o in zip(shapes, eager, feeds, outs):
        got = e.forward(**f)[0]._data.cpu().numpy()
        if not np.array_equal(got, o):
            raise RuntimeError(
                "serve_fixed: the LM's captured forward at %s differs from "
                "the eager one by %g" % (bt, float(np.abs(got - o).max())))
        if on_card:
            eager_ms["%dx%d" % bt] = time_ms(torch, lambda: e.forward(**f),
                                             reps=5, warmup=1)
    launches = fa.flash_attention.launches
    binds = predict.compile_count() - c0
    paths = [_require_predictor_capture("the LM Predictor at %s" % (bt,), p,
                                        on_card)
             for bt, p in zip(shapes, preds)]
    want = cfg["layers"] * _forward_calls(preds + eager)
    if launches != want:
        raise RuntimeError("serve_fixed: the LM Predictors launched the "
                           "flash kernel %d times, want %d (%d layers a "
                           "kernel-running forward)" % (launches, want,
                                                        cfg["layers"]))
    if binds != 2 * len(shapes):
        raise RuntimeError("serve_fixed: %d binds for %d Predictors"
                           % (binds, 2 * len(shapes)))
    # the card against the port's CPU path at the first shape
    ref = predict.Predictor(sym, params, _lm_shapes(shapes[0]),
                            device=ref_device)
    want_out = ref.forward(**feeds[0])[0].asnumpy()
    err = float(np.abs(outs[0] - want_out).max())
    top = np.sort(want_out, axis=-1)
    margin = top[:, -1] - top[:, -2]
    flips = int(((outs[0].argmax(-1) != want_out.argmax(-1))
                 & (margin > PAGED_MARGIN)).sum())
    if err > SERVE_ATOL or flips:
        raise RuntimeError("serve_fixed: the LM Predictor on the card lies "
                           "%g from the CPU's (> %g), or its argmax differs "
                           "at %d positions past the margin" %
                           (err, SERVE_ATOL, flips))
    del preds, eager, base, ref
    return {"shapes": [list(bt) for bt in shapes],
            "output_shapes": [list(o.shape) for o in outs],
            "weights_shared": True, "binds": binds,
            "captured_vs_eager": {"bit_for_bit": True},
            "paths": paths, "flash_launches": launches,
            "card_vs_cpu": {"shape": list(shapes[0]), "max_abs_err": err,
                            "atol": SERVE_ATOL,
                            "positions_within_margin": int(
                                (margin <= PAGED_MARGIN).sum())},
            "forward_ms_captured": ms, "forward_ms_eager": eager_ms}


def _resnet_server(resnet, fixed, params, device, router, warm=True,
                   quant=""):
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.tools.resnet import resnet_symbol

    cfg = serving.ServingConfig(
        buckets=fixed["buckets"], max_delay_ms=fixed["max_delay_ms"],
        replicas=fixed["replicas"], router=router, zero_copy=True,
        warm=warm, timeout_ms=fixed["timeout_ms"], queue_depth=256,
        quant_weights=quant)
    return serving.InferenceServer(
        resnet_symbol(resnet), params, {"data": tuple(resnet["image"])},
        config=cfg, devices=[device] * fixed["replicas"])


def _fixed_traffic(srv, images, clients, wait_s):
    """``clients`` threads, client c sending requests c, c + clients, ...
    one after another; returns (results, latencies ms, wall s, errors)."""
    n = len(images)
    results, lats, errors = [None] * n, [None] * n, []

    def client(c):
        for i in range(c, n, clients):
            try:
                req = srv.submit(data=images[i])
                results[i] = req.get(wait_s)[0]
                lats[i] = req.latency_ms
            except Exception as e:  # noqa: BLE001 — gated below
                errors.append((i, repr(e)))

    t0 = time.monotonic()
    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(max(0.0, t0 + wait_s - time.monotonic()))
    if any(t.is_alive() for t in threads):
        errors.append((None, "clients still waiting after %g s" % wait_s))
    return results, lats, time.monotonic() - t0, errors


def _arm_report(srv, lats, wall, n, torch, on_card):
    m = dict(srv.metrics.get_name_value())
    return {"requests": n, "requests_per_s": n / wall, "wall_s": wall,
            "latency_ms_p50": float(np.percentile(lats, 50)),
            "latency_ms_p99": float(np.percentile(lats, 99)),
            "mean_batch_occupancy": m["mean_batch_occupancy"],
            "padding_efficiency": m["padding_efficiency"],
            "batches": m["batches"],
            "replica_dispatches": srv.replica_dispatch_counts(),
            **_peak_reserved(torch, on_card)}


def _peak_reserved(torch, on_card):
    """Peak bytes allocated and reserved since the last reset: a graph's
    private pool is reserved memory, so the reserved peak counts every
    bucket's graph."""
    if not on_card:
        return {}
    return {"max_memory_allocated": torch.cuda.max_memory_allocated(),
            "max_memory_reserved": torch.cuda.max_memory_reserved()}


def _concurrent_bind_and_serve(srv, x, want, wait_s):
    """Replica 1 binds its ladder (a capture a bucket) on one thread while
    replica 0's bucket-1 executor serves ``x`` on another, each result
    copied to the host: no capture error, every result ``want`` bit for
    bit, and forwards that ran while the binds did."""
    rep0, rep1 = srv._replicas[0], srv._replicas[1]
    exe = rep0.cache.get(1)
    errors, served, window = [], [], {}
    binding = threading.Event()

    def bind():
        try:
            window["start"] = time.monotonic()
            binding.set()
            rep1.cache.warm()
        except Exception as e:  # noqa: BLE001 — gated below
            errors.append(("bind", repr(e)))
        finally:
            window["end"] = time.monotonic()
            binding.set()

    def serve():
        binding.wait(wait_s)
        try:
            while "end" not in window:
                t = time.monotonic()
                got = exe.forward(data=x)[0]._data.cpu().numpy()
                served.append((t, np.array_equal(got, want)))
        except Exception as e:  # noqa: BLE001 — gated below
            errors.append(("serve", repr(e)))

    threads = [threading.Thread(target=f, daemon=True) for f in (bind, serve)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(wait_s)
    during = [ok for t, ok in served
              if window.get("start", 0) <= t <= window.get("end", 0)]
    if errors or any(t.is_alive() for t in threads) or not during \
            or not all(ok for _, ok in served):
        raise RuntimeError("serve_fixed: replica 1's binds beside replica "
                           "0's serving: errors %s, %d forwards during the "
                           "binds, all equal %s" % (
                               errors, len(during),
                               all(ok for _, ok in served)))
    return {"forwards_during_binds": len(during),
            "bind_s": window["end"] - window["start"],
            "replica1_binds": rep1.cache.stats()["compiles"]}


def _resnet_part(torch, resnet, fixed, device, ref_device, seed, on_card,
                 predict_tol, int8_tol):
    """(2) bench.py's ResNet-50 behind ``InferenceServer``: ``fixed``'s
    ladder, window and two replicas on one card, zero-copy, every bucket
    bound at start; its traffic through a round-robin and a least-loaded
    arm (every request answered, occupancy > 1, binds within buckets x
    replicas, each result within ``predict_tol`` of the request alone
    through a Predictor on the card, two within it of the CPU's), the
    binds of one replica beside the other's serving, a burst under a
    1 ms deadline (some fail ``deadline_exceeded``, the queue drains), and
    an int8-weight arm (within ``int8_tol`` of the f32 results, the same
    top-1 wherever the f32 margin exceeds 2 x ``int8_tol``)."""
    from mxnet_tpu_torch import predict, serving
    from mxnet_tpu_torch.tools.resnet import resnet_params, resnet_symbol
    from mxnet_tpu_torch.tools.serve_fixed import request_images, \
        request_sizes

    params = resnet_params(resnet, seed)
    sizes = request_sizes(fixed, seed)
    images = request_images(resnet, sizes, seed)
    wait_s = fixed["timeout_ms"] / 1e3
    sym = resnet_symbol(resnet).tojson()
    budget = len(fixed["buckets"]) * fixed["replicas"]
    # each request alone through a Predictor on the card, at its own batch
    alone = {}
    for r in sorted(set(sizes)):
        alone[r] = predict.Predictor(sym, params,
                                     {"data": (r,) + tuple(resnet["image"])},
                                     device=device)
    want = [alone[x.shape[0]].forward(data=x)[0]._data.cpu().numpy()
            for x in images]
    arms, results = {}, {}
    for router in ("rr", "least_loaded"):
        _fresh(torch, on_card)
        c0 = predict.compile_count()
        srv = _resnet_server(resnet, fixed, params, device, router,
                             warm=router != "rr")
        _note("%s server bound" % router)
        extra = {}
        try:
            if router == "rr":
                one = sizes.index(1)
                extra["concurrent_binds"] = _concurrent_bind_and_serve(
                    srv, images[one], want[one], wait_s)
                srv.warm()
            if not srv._started:
                srv.start()
            if not srv.ready():
                raise RuntimeError("serve_fixed: the server is not ready "
                                   "after warm")
            _note("%s traffic" % router)
            got, lats, wall, errors = _fixed_traffic(
                srv, images, fixed["clients"], wait_s)
            report = _arm_report(srv, [x for x in lats if x is not None],
                                 wall, len(images), torch, on_card)
            _note("%s traffic done in %.3f s" % (router, wall))
            if router == "least_loaded":
                extra["burst"] = _deadline_burst(srv, images, fixed, wait_s)
        finally:
            srv.stop()
        binds = predict.compile_count() - c0
        missing = [i for i, g in enumerate(got) if g is None]
        if errors or missing:
            raise RuntimeError("serve_fixed %s: %d requests unanswered: %s"
                               % (router, len(missing), errors[:3]))
        if not report["mean_batch_occupancy"] > 1.0:
            raise RuntimeError("serve_fixed %s: mean occupancy %g, want > 1"
                               % (router, report["mean_batch_occupancy"]))
        if binds > budget:
            raise RuntimeError("serve_fixed %s: %d binds, want <= %d"
                               % (router, binds, budget))
        errs = [float(np.abs(g - w).max()) for g, w in zip(got, want)]
        if max(errs) > predict_tol:
            raise RuntimeError(
                "serve_fixed %s: request %d lies %g from its forward alone "
                "on the card (> %g)" % (router, int(np.argmax(errs)),
                                        max(errs), predict_tol))
        arms[router] = dict(report, binds=binds,
                            max_abs_err_vs_alone=max(errs), **extra)
        results[router] = got
        del srv
    # two requests, the card against the CPU
    cpu_errs = []
    for i in range(fixed["cpu_checks"]):
        ref = predict.Predictor(sym, params, {"data": images[i].shape},
                                device=ref_device)
        cpu = ref.forward(data=images[i])[0].asnumpy()
        cpu_errs.append(float(np.abs(results["rr"][i] - cpu).max()))
    if max(cpu_errs) > predict_tol:
        raise RuntimeError("serve_fixed: a request lies %g from the CPU's "
                           "Predictor (> %g)" % (max(cpu_errs), predict_tol))
    # int8 weights
    _fresh(torch, on_card)
    srv = _resnet_server(resnet, fixed, params, device, "least_loaded",
                         quant="int8")
    try:
        srv.start()
        got, lats, wall, errors = _fixed_traffic(srv, images,
                                                 fixed["clients"], wait_s)
        report = _arm_report(srv, [x for x in lats if x is not None], wall,
                             len(images), torch, on_card)
    finally:
        srv.stop()
    if errors or any(g is None for g in got):
        raise RuntimeError("serve_fixed int8: unanswered requests: %s"
                           % errors[:3])
    f32 = results["rr"]
    errs = [float(np.abs(g - w).max()) for g, w in zip(got, f32)]
    flips = 0
    for g, w in zip(got, f32):
        top = np.sort(w, axis=-1)
        flips += int(((g.argmax(-1) != w.argmax(-1))
                      & (top[:, -1] - top[:, -2] > 2 * int8_tol)).sum())
    if max(errs) > int8_tol or flips:
        raise RuntimeError("serve_fixed int8: outputs %g from f32 (> %g), "
                           "or %d top-1 flips past the margin"
                           % (max(errs), int8_tol, flips))
    arms["int8"] = dict(report, max_abs_err_vs_f32=max(errs),
                        top1_margin=2 * int8_tol)
    del srv, alone
    return {"images": list(resnet["image"]), "classes": resnet["classes"],
            "requests": len(images), "images_total": int(sum(sizes)),
            "buckets": list(fixed["buckets"]),
            "replicas": fixed["replicas"], "bind_budget": budget,
            "predict_tol": predict_tol, "int8_tol": int8_tol,
            "cpu_checks_max_abs_err": cpu_errs, "arms": arms}


def _deadline_burst(srv, images, fixed, wait_s):
    """``fixed["burst"]`` one-image requests at ``burst_timeout_ms``, sent
    back to back: some fail ``deadline_exceeded`` (at submit, reject-early,
    or in the queue); then a request without a deadline is answered and
    the queue is empty."""
    codes, reqs = {}, []
    x = images[0][:1]
    for _ in range(fixed["burst"]):
        try:
            reqs.append(srv.submit(data=x,
                                   timeout_ms=fixed["burst_timeout_ms"]))
        except Exception as e:  # noqa: BLE001 — counted by code
            code = getattr(e, "code", repr(e))
            codes[code] = codes.get(code, 0) + 1
    for r in reqs:
        try:
            r.get(wait_s)
            codes["ok"] = codes.get("ok", 0) + 1
        except Exception as e:  # noqa: BLE001 — counted by code
            code = getattr(e, "code", repr(e))
            codes[code] = codes.get(code, 0) + 1
    after = srv.submit(data=x, timeout_ms=0).get(wait_s)
    depth = srv._former.depth()
    if not codes.get("deadline_exceeded") or depth or after[0].shape[0] != 1 \
            or set(codes) - {"ok", "deadline_exceeded"}:
        raise RuntimeError("serve_fixed burst: codes %s, queue depth %d "
                           "after" % (codes, depth))
    return {"burst": fixed["burst"],
            "timeout_ms": fixed["burst_timeout_ms"], "codes": codes,
            "queue_depth_after": depth}


def _generate_part(torch, cfg, serve, fixed, device, seed, on_card,
                   serve_tokens):
    """(3) The LM behind ``InferenceServer(..., decode=GenerateConfig(...))``
    with ``fixed["replicas"]`` replicas, the decode step captured,
    ``serve``'s traffic: the fixed path refuses the LM's (B*T, V) output
    (batch-major); every stream ``max_new_tokens`` long, equal to the serve
    phase's (``serve_tokens``) but that a first difference may fall where
    that run's top-2 margin is <= PAGED_MARGIN; exactly a flash launch a
    prompt and layer; each replica the captured path; every slot free at
    the end; and ``generate()`` the tokens of ``submit_stream()``. The
    fixed path's binds and refused forward launch the flash kernel too:
    the LM's layers a kernel-running forward."""
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa
    from mxnet_tpu_torch.serving import generate as gen

    params = lm_arg_params(cfg, seed)
    prompts = serve_prompts(cfg, serve, seed)
    t = fixed["decode_example_len"]
    decode = serving.GenerateConfig(
        num_heads=cfg["heads"], num_kv_heads=cfg["kv_heads"],
        slots=serve["slots"], max_context=serve["max_context"],
        prefill_buckets=serve["prefill_buckets"],
        max_new_tokens=serve["max_new_tokens"], eos_id=None, capture=True)
    config = serving.ServingConfig(buckets=(1,), max_delay_ms=1.0,
                                   replicas=fixed["replicas"],
                                   timeout_ms=fixed["timeout_ms"])
    wait_s = fixed["timeout_ms"] / 1e3
    _fresh(torch, on_card)
    l0 = fa.flash_attention.launches
    srv = serving.InferenceServer(
        lm_predict_symbol(cfg), params, _lm_shapes((t,)), config=config,
        decode=decode, devices=[device] * fixed["replicas"])
    bases = [rep.cache._base for rep in srv._replicas]
    try:
        srv.start()
        f = _lm_feed(cfg, (1, t), seed + 30)
        try:
            srv.submit(**f).get(wait_s)
            refused = None
        except serving.ServingError as e:
            refused = e
        if refused is None or "batch-major" not in str(refused):
            raise RuntimeError("serve_fixed: the LM's predict() was not "
                               "refused as not batch-major: %r" % refused)
        fixed_launches = fa.flash_attention.launches - l0
        t0 = time.monotonic()
        streams = [srv.submit_stream(p) for p in prompts]
        tokens = [s.tokens(wait_s) for s in streams]
        wall = time.monotonic() - t0
        launches = fa.flash_attention.launches - l0 - fixed_launches
        stats = srv.decode_stats()
        busy = [c.active_slots() for c in srv._decode.caches]
        again = srv.generate(prompts[0], timeout_ms=fixed["timeout_ms"])
        model = srv._decode.model
        memory = _peak_reserved(torch, on_card)
    finally:
        srv.stop()
    want_len = serve["max_new_tokens"]
    if any(len(x) != want_len for x in tokens):
        raise RuntimeError("serve_fixed generate: stream lengths %s, want "
                           "%d" % ([len(x) for x in tokens], want_len))
    near = _spec_vs_vanilla(gen, model, serve, prompts, tokens, serve_tokens,
                            "float32", what="the served stream")
    want = len(prompts) * cfg["layers"]
    want_fixed = cfg["layers"] * _forward_calls(bases)
    if launches != want or fixed_launches != want_fixed:
        raise RuntimeError("serve_fixed generate: %d flash launches in the "
                           "traffic, want %d; %d in the fixed path, want %d"
                           % (launches, want, fixed_launches, want_fixed))
    reps = stats["replica"]
    for i, st in enumerate(reps):
        if not on_card:
            ok = st["path"] == "eager"
        else:
            ok = (st["path"], st["warmup_calls"], st["captures"],
                  st["replays"]) == ("captured", 2, 1, st["steps"] - 2)
        if not ok:
            raise RuntimeError("serve_fixed generate: replica %d did not take "
                               "the %s decode path: %s" % (
                                   i, "captured" if on_card else "eager", st))
    if any(busy):
        raise RuntimeError("serve_fixed generate: slots still taken: %s"
                           % busy)
    if again != tokens[0]:
        raise RuntimeError("serve_fixed generate: generate() gave %s, the "
                           "stream %s" % (again[:8], tokens[0][:8]))
    total = sum(len(x) for x in tokens)
    return {"prompts": len(prompts), "replicas": fixed["replicas"],
            "flash_launches": launches,
            "fixed_path_flash_launches": fixed_launches,
            "steps": stats["steps"],
            "replica_paths": reps, "near_ties": near,
            "equal_to_serve": sum(a == b for a, b in zip(tokens,
                                                          serve_tokens)),
            "tokens_per_s": total / wall, "wall_s": wall,
            "refused_predict": str(refused), **memory}


def phase_serve_fixed(cfg=LM, serve=SERVE, fixed=SERVE_FIXED, resnet=RESNET,
                      device=None, ref_device="cpu", seed=SEED,
                      serve_tokens=None, predict_tol=RESNET_PREDICT_TOL,
                      int8_tol=RESNET_INT8_TOL):
    """The fixed-shape serving stack at full width on one card: (1) the LM
    Predictor (:func:`_lm_predictor_part`), (2) ResNet-50 behind
    ``InferenceServer`` (:func:`_resnet_part`), (3) the LM's ``generate()``
    through the same server class (:func:`_generate_part`); then the flash
    forward at the Predictor's shapes against its plain version, timed.
    ``device`` None = the card. Returns the flash launches of the phase's
    main path."""
    import torch

    from mxnet_tpu_torch.ops.kernels import flash_attention as fa
    from mxnet_tpu_torch.serving import generate as gen

    on_card = device is None or torch.device(device).type == "cuda"
    if serve_tokens is None:
        spec = gen.DecodeSpec(num_heads=cfg["heads"],
                              num_kv_heads=cfg["kv_heads"])
        serve_tokens = _serve_streams(
            gen, gen.DecodeModel.from_arg_params(lm_arg_params(cfg, seed),
                                                 spec, device=device),
            cfg, serve, serve_prompts(cfg, serve, seed))["tokens"]
    fa.flash_attention.launches = 0
    lm = _lm_predictor_part(torch, cfg, fixed, device, ref_device, seed,
                            on_card)
    lm_launches = fa.flash_attention.launches
    _note("LM Predictor done")
    res = _resnet_part(torch, resnet, fixed, device, ref_device, seed,
                       on_card, predict_tol, int8_tol)
    if fa.flash_attention.launches != lm_launches:
        raise RuntimeError("serve_fixed: ResNet-50 launched the flash kernel")
    _note("ResNet-50 server done")
    generate = _generate_part(torch, cfg, serve, fixed, device, seed,
                              on_card, serve_tokens)
    launches = fa.flash_attention.launches
    _note("generate done")
    timings = {}
    if on_card:
        gen_t = torch.Generator(device="cuda").manual_seed(seed)
        for bt in fixed["lm_shapes"]:
            timings["%dx%d" % tuple(bt)] = _flash_at(torch, bt[0], bt[1],
                                                     cfg, gen_t)
    result = {"phase": "serve_fixed", "lm_predictor": lm, "resnet": res,
              "generate": generate, "flash_launches": launches,
              "flash_at_predictor_shapes": timings}
    emit(result)
    return launches, timings


TRACEPARENT = "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01"


def _http_note(msg):
    print("serve_http: %s" % msg, file=sys.stderr, flush=True)


def _http_get(port, path, timeout):
    """(status, payload) of one GET on a fresh connection; (None, the
    error's name) when the socket refuses it."""
    from mxnet_tpu_torch.tools import serve_http as sh

    conn = sh.connect(port, timeout)
    try:
        st, _, payload, _ = sh.request(conn, "GET", path)
        return st, payload
    except OSError as e:
        return None, type(e).__name__
    finally:
        conn.close()


def _http_post(port, path, body, headers, timeout):
    """(status, headers, payload) of one POST on a fresh connection;
    (None, {}, the error's name) when the socket refuses it."""
    from mxnet_tpu_torch.tools import serve_http as sh

    conn = sh.connect(port, timeout)
    try:
        st, hdrs, payload, _ = sh.request(conn, "POST", path, body, headers)
        return st, hdrs, payload
    except OSError as e:
        return None, {}, type(e).__name__
    finally:
        conn.close()


def _closed_loop(send, n, clients, wait_s):
    """``clients`` threads, client c running ``send(i, state)`` for i = c,
    c + clients, ... one after another (``state``: the client's own dict,
    where a client keeps its connection); returns (results, client-side
    latency ms of each, wall s, errors)."""
    results, lats, errors = [None] * n, [None] * n, []

    def client(c):
        state = {}
        try:
            for i in range(c, n, clients):
                t0 = time.monotonic()
                try:
                    results[i] = send(i, state)
                except Exception as e:  # noqa: BLE001 — gated by caller
                    errors.append((i, repr(e)))
                lats[i] = (time.monotonic() - t0) * 1e3
        finally:
            if "conn" in state:
                state["conn"].close()

    t0 = time.monotonic()
    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(max(0.0, t0 + wait_s - time.monotonic()))
    if any(t.is_alive() for t in threads):
        errors.append((None, "clients still waiting after %g s" % wait_s))
    return results, lats, time.monotonic() - t0, errors


def _host_median(fn, reps=20):
    """Median host seconds of one ``fn()`` call."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _latency_report(lats, wall):
    return {"requests": len(lats), "requests_per_s": len(lats) / wall,
            "wall_s": wall,
            "latency_ms_p50": float(np.percentile(lats, 50)),
            "latency_ms_p99": float(np.percentile(lats, 99))}


def _http_predict_part(torch, resnet, http, device, seed, on_card,
                       predict_tol):
    """(1) ResNet-50 behind ``InferenceServer`` behind ``HttpFrontend``:
    readiness while the ladder is held cold, then warm; ``http``'s
    closed-loop keep-alive clients in the b64 form (every request 200 with
    its ``x-request-id`` echoed, each result within ``predict_tol`` of the
    request alone through a Predictor on ``device``); the same traffic
    in-process through ``srv.submit``; one request alone in the JSON and
    the b64 form, bit for bit."""
    from mxnet_tpu_torch import predict, serving
    from mxnet_tpu_torch.serving.frontend import FrontendConfig, \
        HttpFrontend, routes
    from mxnet_tpu_torch.tools import serve_http as sh
    from mxnet_tpu_torch.tools.resnet import resnet_params, resnet_symbol
    from mxnet_tpu_torch.tools.serve_fixed import request_images, \
        request_sizes

    params = resnet_params(resnet, seed)
    sizes = request_sizes(http, seed)
    images = request_images(resnet, sizes, seed)
    wait_s = http["timeout_ms"] / 1e3
    sym = resnet_symbol(resnet)
    alone = {r: predict.Predictor(sym.tojson(), params,
                                  {"data": (r,) + tuple(resnet["image"])},
                                  device=device)
             for r in sorted(set(sizes))}
    want = [alone[x.shape[0]].forward(data=x)[0]._data.cpu().numpy()
            for x in images]
    del alone
    _fresh(torch, on_card)
    srv = serving.InferenceServer(
        sym, params, {"data": tuple(resnet["image"])},
        config=serving.ServingConfig(
            buckets=http["buckets"], max_delay_ms=http["max_delay_ms"],
            replicas=http["replicas"], zero_copy=True,
            timeout_ms=http["timeout_ms"], queue_depth=256),
        devices=[device] * http["replicas"])
    fe = HttpFrontend(srv, FrontendConfig(host="127.0.0.1", port=0))
    # hold the ladder cold until /readyz has been read once
    cold = threading.Event()
    real_warm = srv.warm

    def held_warm():
        cold.wait(wait_s)
        real_warm()

    srv.warm = held_warm
    failures = []
    try:
        fe.start(wait_ready=False)
        port = fe.port
        health = _http_get(port, "/healthz", wait_s)
        warming = _http_get(port, "/readyz", wait_s)
        cold.set()
        t0 = time.monotonic()
        while _http_get(port, "/readyz", wait_s)[0] != 200:
            if time.monotonic() - t0 > wait_s:
                raise RuntimeError("serve_http: /readyz not 200 within %g s"
                                   % wait_s)
            time.sleep(0.01)
        warm_s = time.monotonic() - t0
        if health != (200, {"status": "ok"}) or \
                warming != (503, {"status": "warming"}):
            failures.append("before the warm-up /healthz gave %s and "
                            "/readyz %s" % (health, warming))
        _http_note("ResNet-50 ladder warm in %.3f s" % warm_s)
        # each body serialized before the clock starts: the clients share
        # this process (and its interpreter lock) with the server
        bodies = [json.dumps({"inputs": {"data": sh.b64_array(x)},
                              "encoding": "b64"}).encode() for x in images]

        def send(i, state):
            if "conn" not in state:
                state["conn"] = sh.connect(port, wait_s)
            st, hdrs, payload, _ = sh.request(
                state["conn"], "POST", "/v1/predict", bodies[i],
                {"x-request-id": "http-%d" % i})
            return st, hdrs.get("x-request-id"), payload

        got, lats, wall, errors = _closed_loop(send, len(images),
                                               http["clients"], wait_s)
        over_http = _latency_report(lats, wall)
        _http_note("HTTP traffic done in %.3f s" % wall)

        def send_inproc(i, state):
            return srv.submit(data=images[i]).get(wait_s)[0]

        inproc, in_lats, in_wall, in_errors = _closed_loop(
            send_inproc, len(images), http["clients"], wait_s)
        in_process = _latency_report(in_lats, in_wall)
        # one request alone in both forms
        one = sizes.index(1)
        x = images[one]
        forms = {}
        for form, body in (("json", {"inputs": {"data": x.tolist()}}),
                           ("b64", {"inputs": {"data": sh.b64_array(x)},
                                    "encoding": "b64"})):
            t_enc = time.monotonic()
            raw = json.dumps(body).encode()
            enc_s = time.monotonic() - t_enc
            conn = sh.connect(port, wait_s)
            try:
                st, _, payload, secs = sh.request(conn, "POST",
                                                  "/v1/predict", raw)
            finally:
                conn.close()
            out = payload["outputs"][0] if st == 200 else None
            forms[form] = (st, np.asarray(out, np.float32) if form == "json"
                           else sh.from_b64(out), secs, enc_s, len(raw))
        # the server's host work a b64 body of one image, alone: the JSON
        # parse and the base64 decode the handler runs under the
        # interpreter lock
        raw = bodies[one]
        parsed = routes.parse_json_body(raw)
        decode_ms = {
            "json_loads": 1e3 * _host_median(
                lambda: routes.parse_json_body(raw)),
            "b64_decode": 1e3 * _host_median(
                lambda: routes.parse_predict_inputs(parsed))}
    finally:
        fe.stop()
    bad = [(i, g[0] if g else None) for i, g in enumerate(got)
           if g is None or g[0] != 200 or g[1] != "http-%d" % i]
    if errors or in_errors or bad:
        failures.append("%d HTTP requests failed or lost their id (%s), "
                        "errors %s / %s" % (len(bad), bad[:3], errors[:3],
                                            in_errors[:3]))
        raise RuntimeError("serve_http predict: " + "; ".join(failures))
    outs = [sh.from_b64(g[2]["outputs"][0]) for g in got]
    errs = [float(np.abs(o - w).max()) for o, w in zip(outs, want)]
    in_errs = [float(np.abs(o - w).max()) for o, w in zip(inproc, want)]
    if max(errs + in_errs) > predict_tol:
        failures.append("a result lies %g from its request alone (> %g)"
                        % (max(errs + in_errs), predict_tol))
    if forms["json"][0] != 200 or forms["b64"][0] != 200 or \
            not np.array_equal(forms["json"][1], forms["b64"][1]):
        failures.append("the JSON and b64 forms of one request differ")
    if failures:
        raise RuntimeError("serve_http predict: " + "; ".join(failures))
    p50, in_p50 = over_http["latency_ms_p50"], in_process["latency_ms_p50"]
    return {"requests": len(images), "images_total": int(sum(sizes)),
            "buckets": list(http["buckets"]), "replicas": http["replicas"],
            "clients": http["clients"], "warm_s": warm_s,
            "readyz_before_warm": warming[1], "over_http": over_http,
            "in_process": in_process,
            "http_hop_share_p50": (p50 - in_p50) / p50,
            "max_abs_err_vs_alone": max(errs),
            "in_process_max_abs_err_vs_alone": max(in_errs),
            "predict_tol": predict_tol,
            "host_decode_ms_one_image": decode_ms,
            "json_vs_b64": {"bit_for_bit": True, "image_bytes": int(x.nbytes),
                            **{"%s_%s" % (f, k): v for f in forms for k, v in
                               (("exchange_ms", forms[f][2] * 1e3),
                                ("client_encode_ms", forms[f][3] * 1e3),
                                ("body_bytes", forms[f][4]))}}}


def _http_admission_part(torch, resnet, http, device, seed, on_card):
    """(2) Admission made deterministic: ``http["admission"]``'s one-bucket
    ladder and long window with requests parked in it: a batch-class POST
    shed with 429 and Retry-After >= 1, an interactive one answered, then
    ``max_inflight`` HTTP requests parked and one more refused with 503
    ``overloaded``; the counters rise by exactly the admitted and refused;
    /metrics parses."""
    from mxnet_tpu_torch import serving, telemetry
    from mxnet_tpu_torch.serving.frontend import FrontendConfig, \
        HttpFrontend
    from mxnet_tpu_torch.tools import serve_http as sh
    from mxnet_tpu_torch.tools.resnet import resnet_params, resnet_symbol

    adm = http["admission"]
    wait_s = http["timeout_ms"] / 1e3
    x = np.random.RandomState(seed + 40).uniform(
        -1, 1, (1,) + tuple(resnet["image"])).astype(np.float32)
    body = {"inputs": {"data": sh.b64_array(x)}}
    _fresh(torch, on_card)
    srv = serving.InferenceServer(
        resnet_symbol(resnet), resnet_params(resnet, seed),
        {"data": tuple(resnet["image"])},
        config=serving.ServingConfig(
            buckets=adm["buckets"], max_delay_ms=adm["max_delay_ms"],
            queue_depth=adm["queue_depth"], replicas=1, zero_copy=True,
            timeout_ms=http["timeout_ms"]),
        devices=[device])
    fe = HttpFrontend(srv, FrontendConfig(
        host="127.0.0.1", port=0, max_inflight=adm["max_inflight"],
        shed_pct=adm["shed_pct"]))

    def counts():
        m = dict(telemetry.registry.get_name_value())
        return m.get("http_requests_total", 0), m.get("http_shed_total", 0)

    try:
        fe.start(wait_ready=True, ready_timeout_s=wait_s)
        port = fe.port
        before = counts()
        parked = [srv.submit(data=x) for _ in range(adm["parked"])]
        shed = _http_post(port, "/v1/predict", body,
                          {"x-priority": "batch"}, wait_s)
        interactive = _http_post(port, "/v1/predict", body, {}, wait_s)
        for r in parked:
            r.get(wait_s)
        held = {}
        threads = [threading.Thread(
            target=lambda k=k: held.__setitem__(k, _http_post(
                port, "/v1/predict", body, {}, wait_s)), daemon=True)
            for k in range(adm["max_inflight"])]
        for t in threads:
            t.start()
        t0 = time.monotonic()
        while fe.admission.inflight() < adm["max_inflight"]:
            if time.monotonic() - t0 > wait_s:
                raise RuntimeError("serve_http admission: %d requests never "
                                   "in flight" % adm["max_inflight"])
            time.sleep(0.001)
        over = _http_post(port, "/v1/predict", body, {}, wait_s)
        for t in threads:
            t.join(wait_s)
        after = counts()
        st, text = _http_get(port, "/metrics", wait_s)
    finally:
        fe.stop()
    samples = parse_exposition(text.decode("utf-8"))
    admitted = 1 + adm["max_inflight"]
    refused = 2
    failures = []
    if shed[0] != 429 or shed[2]["error"]["code"] != "shed" or \
            int(shed[1].get("retry-after", 0)) < 1:
        failures.append("the batch-class POST gave %s %s" % shed[:2])
    if interactive[0] != 200:
        failures.append("the interactive POST gave %s" % interactive[0])
    if over[0] != 503 or over[2]["error"]["code"] != "overloaded" or \
            int(over[1].get("retry-after", 0)) < 1:
        failures.append("the POST past max_inflight gave %s %s" % over[:2])
    if any(held.get(k, (None,))[0] != 200
           for k in range(adm["max_inflight"])):
        failures.append("the parked HTTP requests gave %s" % held)
    if (after[0] - before[0], after[1] - before[1]) != (admitted, refused):
        failures.append("http_requests_total / http_shed_total rose by %s, "
                        "want %s" % ((after[0] - before[0],
                                      after[1] - before[1]),
                                     (admitted, refused)))
    if st != 200 or "http_requests_total" not in samples:
        failures.append("/metrics gave %s without http_requests_total" % st)
    if failures:
        raise RuntimeError("serve_http admission: " + "; ".join(failures))
    return {"shed": {"status": shed[0], "code": shed[2]["error"]["code"],
                     "retry_after_s": int(shed[1]["retry-after"])},
            "overloaded": {"status": over[0],
                           "code": over[2]["error"]["code"],
                           "retry_after_s": int(over[1]["retry-after"])},
            "admitted": admitted, "refused": refused,
            "metrics_samples": len(samples), **{k: adm[k] for k in (
                "buckets", "max_delay_ms", "queue_depth", "shed_pct",
                "parked", "max_inflight")}}


def _sse_checks(what, events, n):
    """The SSE framing gates of one stream: indices 0..n-1 and a last
    ``done`` event with ``tokens: n``; returns its tokens."""
    toks = [d["token"] for e, d in events if e == "token"]
    idx = [d["index"] for e, d in events if e == "token"]
    if idx != list(range(n)) or not events or events[-1][0] != "done" or \
            events[-1][1].get("tokens") != n:
        raise RuntimeError("serve_http %s: indices %s..., last event %s"
                           % (what, idx[:3], events[-1] if events else None))
    return toks


def _stream_timing(times, events):
    """(TTFT ms, median inter-token ms) of one stream from its events'
    arrival seconds."""
    tt = [t for t, (e, _) in zip(times, events) if e == "token"]
    gaps = [(b - a) * 1e3 for a, b in zip(tt, tt[1:])]
    return tt[0] * 1e3, float(np.median(gaps))


def _http_generate_part(torch, cfg, serve, http, device, seed, on_card,
                        serve_tokens):
    """(3) The serve phase's LM behind the server with ``decode=...``
    (``http["decode_replicas"]`` replicas, the decode step captured)
    behind ``HttpFrontend``: the serve phase's prompts as concurrent SSE
    streams beside a client that leaves after ``disconnect_after`` tokens;
    a ``"stream": false`` request; a traced request; the same prompts
    in-process; then (4) the SIGTERM drain with ``drain_streams`` streams
    open. Gates in the docstring of phase 3f; returns the record and the
    flash launches of the part."""
    from mxnet_tpu_torch import serving, telemetry
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa
    from mxnet_tpu_torch.serving import generate as gen
    from mxnet_tpu_torch.serving.frontend import FrontendConfig, \
        HttpFrontend
    from mxnet_tpu_torch.tools import serve_http as sh

    params = lm_arg_params(cfg, seed)
    prompts = serve_prompts(cfg, serve, seed)
    n_new = serve["max_new_tokens"]
    t = http["decode_example_len"]
    wait_s = http["timeout_ms"] / 1e3
    reps = http["decode_replicas"]
    decode = serving.GenerateConfig(
        num_heads=cfg["heads"], num_kv_heads=cfg["kv_heads"],
        slots=serve["slots"], max_context=serve["max_context"],
        prefill_buckets=serve["prefill_buckets"], max_new_tokens=n_new,
        eos_id=None, capture=True)
    _fresh(torch, on_card)
    l0 = fa.flash_attention.launches
    srv = serving.InferenceServer(
        lm_predict_symbol(cfg), params, _lm_shapes((t,)),
        config=serving.ServingConfig(buckets=(1,), max_delay_ms=1.0,
                                     replicas=reps,
                                     timeout_ms=http["timeout_ms"]),
        decode=decode, devices=[device] * reps)
    bases = [rep.cache._base for rep in srv._replicas]
    streams = {}
    real_submit = srv.submit_stream

    def keep(*a, **kw):
        s = real_submit(*a, **kw)
        streams[kw.get("request_id")] = s
        return s

    srv.submit_stream = keep
    fe = HttpFrontend(srv, FrontendConfig(host="127.0.0.1", port=0))
    prev = signal.getsignal(signal.SIGTERM)
    failures = []
    try:
        fe.start(wait_ready=True, ready_timeout_s=wait_s)
        port = fe.port
        # (a) the six streams and a client that leaves
        results = {}

        def run(key, body, **kw):
            results[key] = sh.sse(port, body, timeout=wait_s, **kw)

        short = min(range(len(prompts)), key=lambda i: len(prompts[i]))
        jobs = [(("sse", i), {"prompt": p}, {"headers": {
            "x-request-id": "sse-%d" % i}}) for i, p in enumerate(prompts)]
        jobs.append((("gone",), {"prompt": prompts[short],
                                 "max_new_tokens": http["disconnect_tokens"]},
                     {"headers": {"x-request-id": "gone"},
                      "stop_after": http["disconnect_after"]}))
        threads = [threading.Thread(target=run, args=j[:2], kwargs=j[2],
                                    daemon=True) for j in jobs]
        t0 = time.monotonic()
        for th in threads:
            th.start()
        for th in threads:
            th.join(wait_s)
        sse_wall = time.monotonic() - t0
        if any(th.is_alive() for th in threads):
            raise RuntimeError("serve_http generate: a stream still open "
                               "after %g s" % wait_s)
        tokens, timing = [], []
        for i in range(len(prompts)):
            st, hdrs, events, times = results[("sse", i)]
            if st != 200 or hdrs.get("x-request-id") != "sse-%d" % i:
                raise RuntimeError("serve_http generate: stream %d gave %s"
                                   % (i, st))
            tokens.append(_sse_checks("stream %d" % i, events, n_new))
            timing.append(_stream_timing(times, events))
        deadline = time.monotonic() + wait_s
        gone = streams["gone"]
        while not gone.done or srv.decode_stats()["active"]:
            if time.monotonic() > deadline:
                raise RuntimeError("serve_http generate: the left stream "
                                   "still decoding: %s" % srv.decode_stats())
            time.sleep(0.005)
        gone_tokens = len(gone._tokens)
        busy = [c.active_slots() for c in srv._decode.caches]
        if gone.finish_reason != "cancelled" or \
                gone_tokens >= http["disconnect_tokens"] or any(busy):
            failures.append("the left stream ended %r after %d tokens; "
                            "slots taken %s" % (gone.finish_reason,
                                                gone_tokens, busy))
        # (b) "stream": false
        st, _, body = _http_post(port, "/v1/generate",
                                 {"prompt": prompts[0], "stream": False},
                                 {}, wait_s)
        if st != 200 or body["tokens"] != tokens[0]:
            failures.append("the stream-false request gave %s %s"
                            % (st, str(body)[:120]))
        # (c) a traced request: its trace id echoed, its span tree served
        telemetry.enable_spans("serving")
        try:
            st, hdrs, events, _ = sh.sse(
                port, {"prompt": prompts[0]}, timeout=wait_s,
                headers={"traceparent": TRACEPARENT,
                         "x-request-id": "traced"})
            tree, t1 = (None, None), time.monotonic()
            while tree[0] != 200 and time.monotonic() - t1 < wait_s:
                tree = _http_get(port, "/debug/requests/traced", wait_s)
                time.sleep(0.01)
        finally:
            telemetry.disable_spans()
        trace_id = TRACEPARENT.split("-")[1]
        names = set()

        def walk(spans):
            for s in spans:
                names.add(s["name"])
                walk(s.get("children") or [])

        if tree[0] == 200:
            walk(tree[1]["spans"])
        if st != 200 or hdrs.get("x-trace-id") != trace_id or \
                _sse_checks("traced", events, n_new) != tokens[0] or \
                tree[0] != 200 or tree[1]["trace_id"] != trace_id or \
                not {"serving.queued", "decode.step"} <= names:
            failures.append("the traced request: %s, x-trace-id %s, tree %s "
                            "with spans %s" % (st, hdrs.get("x-trace-id"),
                                               tree[0], sorted(names)))
        # (d) the same prompts in-process
        recs = [{"times": [], "tokens": []} for _ in prompts]

        def consume(i):
            t_send = time.monotonic()
            for tok in srv.submit_stream(prompts[i]):
                recs[i]["times"].append(time.monotonic() - t_send)
                recs[i]["tokens"].append(tok)

        threads = [threading.Thread(target=consume, args=(i,), daemon=True)
                   for i in range(len(prompts))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(wait_s)
        in_timing = [(r["times"][0] * 1e3, float(np.median(
            np.diff(r["times"]) * 1e3))) for r in recs]
        stats = srv.decode_stats()
        model = srv._decode.model
        # (4) SIGTERM drain with streams open
        fe.install_signal_handlers()
        first = threading.Event()
        drained = {}

        def drain_client(k):
            drained[k] = sh.sse(port, {"prompt": prompts[k]},
                                timeout=wait_s,
                                on_event=lambda ev: first.set())

        threads = [threading.Thread(target=drain_client, args=(k,),
                                    daemon=True)
                   for k in range(http["drain_streams"])]
        for th in threads:
            th.start()
        if not first.wait(wait_s):
            raise RuntimeError("serve_http drain: no token before SIGTERM")
        signal.raise_signal(signal.SIGTERM)
        t1 = time.monotonic()
        ready = _http_get(port, "/readyz", wait_s)
        while ready[0] == 200 and time.monotonic() - t1 < wait_s:
            time.sleep(0.001)
            ready = _http_get(port, "/readyz", wait_s)
        refused = _http_post(port, "/v1/generate", {"prompt": prompts[0]},
                             {}, wait_s)
        for th in threads:
            th.join(wait_s)
        stopped = fe._stopped.wait(wait_s)
    finally:
        signal.signal(signal.SIGTERM, prev)
        fe.stop()
    launches = fa.flash_attention.launches - l0
    if not stopped or any(th.is_alive() for th in threads):
        failures.append("the drain did not finish within %g s" % wait_s)
    for k in range(http["drain_streams"]):
        st, _, events, _ = drained.get(k, (None, None, [], []))
        if st != 200:
            failures.append("drain stream %d gave %s" % (k, st))
        else:
            _sse_checks("drain stream %d" % k, events, n_new)
    if not (ready == (503, {"status": "draining"}) or ready[0] is None):
        failures.append("/readyz during the drain gave %s" % (ready,))
    if not ((refused[0] == 503 and refused[2]["error"]["code"]
             == "shutting_down") or refused[0] is None):
        failures.append("a POST during the drain gave %s" % (refused[:1],))
    # flash launches: the LM's layers a prompt admitted, plus the fixed
    # path's forwards of the ladder's warm-up
    admitted = len(prompts) + 1 + 1 + 1 + len(prompts) \
        + http["drain_streams"]
    want = cfg["layers"] * (admitted + _forward_calls(bases))
    if launches != want:
        failures.append("%d flash launches, want %d = %d layers x (%d "
                        "prompts admitted + %d fixed-path forwards)"
                        % (launches, want, cfg["layers"], admitted,
                           _forward_calls(bases)))
    for i, rs in enumerate(stats["replica"]):
        ok = rs["path"] == "eager" if not on_card else (
            (rs["path"], rs["warmup_calls"], rs["captures"],
             rs["replays"]) == ("captured", 2, 1, rs["steps"] - 2))
        if not ok:
            failures.append("replica %d did not take the %s decode path: "
                            "%s" % (i, "captured" if on_card else "eager",
                                    rs))
    if failures:
        raise RuntimeError("serve_http generate: " + "; ".join(failures))
    near = _spec_vs_vanilla(gen, model, serve, prompts, tokens, serve_tokens,
                            "float32", what="the SSE stream")
    in_near = _spec_vs_vanilla(gen, model, serve, prompts,
                               [r["tokens"] for r in recs], serve_tokens,
                               "float32", what="the in-process stream")
    return {"prompts": len(prompts), "replicas": reps,
            "sse": {"ttft_ms": [x[0] for x in timing],
                    "inter_token_ms": [x[1] for x in timing],
                    "wall_s": sse_wall},
            "in_process": {"ttft_ms": [x[0] for x in in_timing],
                           "inter_token_ms": [x[1] for x in in_timing]},
            "near_ties": near, "in_process_near_ties": in_near,
            "equal_to_serve": sum(a == b for a, b in zip(tokens,
                                                          serve_tokens)),
            "disconnect": {"after_tokens": http["disconnect_after"],
                           "server_tokens": gone_tokens,
                           "finish_reason": gone.finish_reason},
            "drain": {"streams": http["drain_streams"],
                      "readyz": ready[1] if ready[0] else "closed",
                      "new_post": refused[0] or "refused"},
            "replica_paths": stats["replica"],
            "flash_launches": launches,
            "flash_arithmetic": "%d layers x (%d SSE + 1 left + 1 stream-"
                                "false + 1 traced + %d in-process + %d "
                                "drain prompts + %d fixed-path forwards)"
                                % (cfg["layers"], len(prompts), len(prompts),
                                   http["drain_streams"],
                                   _forward_calls(bases))}, launches


def phase_serve_http(cfg=LM, serve=SERVE, http=SERVE_HTTP, resnet=RESNET,
                     device=None, seed=SEED, serve_tokens=None,
                     predict_tol=RESNET_PREDICT_TOL):
    """The HTTP / SSE front door at full width on one card over loopback:
    (1) ResNet-50 predict (:func:`_http_predict_part`), (2) admission
    (:func:`_http_admission_part`), (3) generate over SSE and (4) the
    SIGTERM drain (:func:`_http_generate_part`). ``device`` None = the
    card. Returns the flash launches of the phase."""
    import torch

    from mxnet_tpu_torch.ops.kernels import flash_attention as fa
    from mxnet_tpu_torch.serving import generate as gen

    on_card = device is None or torch.device(device).type == "cuda"
    if serve_tokens is None:
        spec = gen.DecodeSpec(num_heads=cfg["heads"],
                              num_kv_heads=cfg["kv_heads"])
        serve_tokens = _serve_streams(
            gen, gen.DecodeModel.from_arg_params(lm_arg_params(cfg, seed),
                                                 spec, device=device),
            cfg, serve, serve_prompts(cfg, serve, seed))["tokens"]
    fa.flash_attention.launches = 0
    predict_part = _http_predict_part(torch, resnet, http, device, seed,
                                      on_card, predict_tol)
    _http_note("predict done")
    admission = _http_admission_part(torch, resnet, http, device, seed,
                                     on_card)
    _http_note("admission done")
    if fa.flash_attention.launches:
        raise RuntimeError("serve_http: ResNet-50 launched the flash kernel")
    generate, launches = _http_generate_part(torch, cfg, serve, http, device,
                                             seed, on_card, serve_tokens)
    _http_note("generate and drain done")
    if fa.flash_attention.launches != launches or not launches:
        raise RuntimeError("serve_http: launched the flash kernel %d times"
                           % fa.flash_attention.launches)
    result = {"phase": "serve_http", "predict": predict_part,
              "admission": admission, "generate": generate,
              "flash_launches": launches}
    emit(result)
    return launches


def _counters():
    """The train phase's counters: name -> wrappers whose launches sum
    under it (the fused updates' scalar and device-lr entry points are one
    kernel each)."""
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa
    from mxnet_tpu_torch.ops.kernels import fused_update as fu

    return {"flash_attention_fwd": (fa.flash_attention,),
            "flash_attention_bwd_dq": (fa.flash_attention_bwd_dq,),
            "flash_attention_bwd_dkv": (fa.flash_attention_bwd_dkv,),
            "sgd_mom_update": (fu.sgd_mom_update, fu.sgd_mom_update_lr),
            "adam_update": (fu.adam_update, fu.adam_update_lr)}


def _count(counters):
    return {k: sum(c.launches for c in cs) for k, cs in counters.items()}


def _types(counters):
    """name -> {type: launches} of the counters that count by type."""
    out = {}
    for k, cs in counters.items():
        for c in cs:
            for key, n in c.launches_by_dtype.items():
                out.setdefault(k, {})[key] = out.get(k, {}).get(key, 0) + n
    return out


def _require_types(phase, types, launches, dtype, names):
    """Each of ``names`` launched only its ``dtype`` instantiation: a step
    that quietly ran another type would hide the kernels of its own."""
    want = {k: {dtype: launches[k]} for k in names if launches[k]}
    got = {k: types.get(k, {}) for k in names if launches[k] or k in types}
    if got != want:
        raise RuntimeError("%s phase launched by type %s, want %s"
                           % (phase, got, want))


def _zero(counters):
    from mxnet_tpu_torch.ops.kernels import _launches

    for cs in counters.values():
        for c in cs:
            _launches.reset(c)


def _train_steps(torch, exe, names, updater, steps, sync):
    """``steps`` forward/backward/update rounds; (losses, seconds each)."""
    losses, secs = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        exe.forward(is_train=True)
        exe.backward()
        lm_update(exe, names, updater)
        loss = float(exe.outputs[0].asnumpy())
        if sync:
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(loss)
    return losses, secs


def _fused_steps(torch, run, steps, sync):
    """``steps`` calls of a fused step's ``run`` (:func:`lm_train_step`);
    (losses, seconds each). The loss is read after the step, from the
    step's own copy."""
    losses, secs = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        outs = run()
        loss = float(outs[0])
        if sync:
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(loss)
    return losses, secs


def _peak(torch, on_card):
    """Peak bytes allocated since the last reset (a captured graph's pool
    counts: its blocks stay allocated) and reserved now."""
    if not on_card:
        return {}
    return {"max_memory_allocated": torch.cuda.max_memory_allocated(),
            "memory_reserved": torch.cuda.memory_reserved()}


def _fresh(torch, on_card):
    """Drop what an earlier run left and reset the peak."""
    gc.collect()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _equal_params(got, want):
    """(bit for bit?, worst |difference|, its name, how many differ) of two
    name -> host array dicts."""
    diff = {n: float(np.abs(got[n].astype(np.float64) - want[n]).max())
            for n in want}
    worst = max(diff, key=diff.get)
    return (all(np.array_equal(got[n], want[n]) for n in want),
            diff[worst], worst, sum(d > 0 for d in diff.values()))


def _train_check_bf16(torch, cfg, train, params, device, ref_device, f32):
    """The bf16 fused step at the check's size, card against the port's
    CPU path, after ``check_steps`` SGD steps: the losses within
    TRAIN_BF16_LOSS and the parameters within TRAIN_BF16_SPREAD times the
    CPU's own bf16-to-f32 distance (``f32``: the f32 check's CPU losses and
    parameters). The control, the same step with the card in f32 through
    the same comparison, must fail the loss gate, or the gate could not
    tell a bf16 step from an f32 one."""
    cb, cs = train["check_batch"], train["check_seq"]

    def run(dev, dtype):
        exe, names = lm_train_executor(cfg, cb, cs, dev, dtype)
        exe.copy_params_from(params)
        lm_feed(exe, cfg, SEED + 3)
        step, _ = lm_train_step(exe, names, lm_updater("sgd", train, names))
        losses, _ = _fused_steps(torch, step, train["check_steps"], False)
        return losses, {n: exe.arg_dict[n].asnumpy() for n in names}

    ref_l, ref_p = run(ref_device, "bfloat16")
    f32_l, f32_p = f32
    loss_spread = max(abs(a - b) for a, b in zip(ref_l, f32_l))
    param_spread = max(float(np.abs(ref_p[n] - f32_p[n]).max())
                       for n in ref_p)

    def reading(dtype):
        got_l, got_p = run(device, dtype)
        loss_err = max(abs(a - b) for a, b in zip(got_l, ref_l))
        param_err = max(float(np.abs(got_p[n] - ref_p[n]).max())
                        for n in ref_p)
        return {"losses": got_l, "loss_abs_err": loss_err,
                "param_max_abs_err": param_err,
                "loss_x_spread": loss_err / loss_spread if loss_spread
                else None,
                "param_x_spread": param_err / param_spread if param_spread
                else None,
                "passes": bool(loss_err <= TRAIN_BF16_LOSS * loss_spread
                               and param_err
                               <= TRAIN_BF16_SPREAD * param_spread)}

    got, control = reading("bfloat16"), reading(None)
    if not got["passes"]:
        raise RuntimeError(
            "train bf16 check: losses %s vs %s (|err| %g, gate %g x the CPU's "
            "bf16-to-f32 %g), parameters max abs err %g (gate %g x %g)"
            % (got["losses"], ref_l, got["loss_abs_err"], TRAIN_BF16_LOSS,
               loss_spread, got["param_max_abs_err"], TRAIN_BF16_SPREAD,
               param_spread))
    if control["passes"]:
        raise RuntimeError(
            "train bf16 check: the f32 control passes the gate too (loss "
            "|err| %g, parameters %g): it cannot tell bf16 from f32"
            % (control["loss_abs_err"], control["param_max_abs_err"]))
    return dict(got, batch=cb, seq=cs, sgd_steps=train["check_steps"],
                ref_losses=ref_l, cpu_bf16_to_f32_loss=loss_spread,
                cpu_bf16_to_f32_param=param_spread, f32_control=control,
                gate={"loss": TRAIN_BF16_LOSS, "param": TRAIN_BF16_SPREAD,
                      "of": "the CPU's bf16-to-f32 distance"})


def _train_run(torch, cfg, train, device, seed, capture, on_card, counters):
    """The run: bench.py's bf16 LM step through ``make_train_step``
    (``capture`` or eager), 5 SGD-momentum then 3 Adam steps from Xavier
    weights, then ``timed_steps`` more Adam steps for the step time.
    Returns (losses, parameters on the host, launches of the 8 steps,
    seconds of the timed steps, stats of the steps, executor facts)."""
    b, t = train["batch"], train["seq"]
    exe, names = lm_train_setup(cfg, train, device, seed)
    losses, stats = [], {}
    _zero(counters)
    for kind, steps in (("sgd", train["sgd_steps"]),
                        ("adam", train["adam_steps"])):
        if kind == "adam":
            del run, step   # the SGD step's graph and its pool
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()
        with cuda_graph(capture):
            run, step = lm_train_step(exe, names,
                                      lm_updater(kind, train, names))
        losses += _fused_steps(torch, run, steps, on_card)[0]
        stats[kind] = step.stats()
    launches = _count(counters), _types(counters)
    params = {n: exe.arg_dict[n].asnumpy() for n in names}
    _, secs = _fused_steps(torch, run, train["timed_steps"], on_card)
    stats["adam"] = step.stats()
    facts = {"parameters": len(names),
             "elements": int(sum(exe.arg_dict[n].size for n in names)),
             "batch": b, "seq": t}
    del exe, run, step
    return losses, params, launches, secs, stats, facts


def _require_captured(phase, stats, on_card):
    """On the card every step of the phase's run must have taken the
    captured path: warm-up, one capture, replays."""
    if not on_card:
        return
    for st in stats:
        if st["path"] != "captured" or st["captures"] != 1 or \
                st["replays"] < 1:
            raise RuntimeError("%s phase did not take the captured path: %s"
                               % (phase, st))


def phase_train(cfg=LM, train=TRAIN, device=None, ref_device="cpu",
                seed=SEED):
    """The training path end to end. ``device`` None = the card; the
    card-vs-reference checks run the same weights on ``ref_device``, where
    every wrapper takes its plain version."""
    import torch

    # 1. card vs the port's CPU path: same weights, same batch, 2 SGD steps
    # through forward / backward / Updater, f32
    params = lm_arg_params(cfg, seed)
    cb, cs = train["check_batch"], train["check_seq"]
    runs = []
    for dev in (device, ref_device):
        exe, names = lm_train_executor(cfg, cb, cs, dev)
        exe.copy_params_from(params)
        lm_feed(exe, cfg, seed + 3)
        losses, _ = _train_steps(torch, exe, names,
                                 lm_updater("sgd", train, names),
                                 train["check_steps"], sync=False)
        runs.append((losses, {n: exe.arg_dict[n].asnumpy() for n in names}))
        del exe
    (got_l, got_p), (ref_l, ref_p) = runs
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(got_l, ref_l))
    param_err = max(float(np.abs(got_p[n] - ref_p[n]).max()) for n in ref_p)
    if not loss_err <= TRAIN_LOSS_RTOL or not param_err <= TRAIN_PARAM_ATOL:
        raise RuntimeError(
            "train check: losses %s vs %s (rel err %g, tol %g), parameters "
            "max abs err %g (tol %g)" % (got_l, ref_l, loss_err,
                                         TRAIN_LOSS_RTOL, param_err,
                                         TRAIN_PARAM_ATOL))
    # 2. the same in bf16 through the fused step, held to the CPU's own
    # bf16-to-f32 distance
    check_bf16 = _train_check_bf16(torch, cfg, train, params, device,
                                   ref_device, (ref_l, ref_p))
    del params, runs, got_p, ref_p

    # 3. the run: bf16, captured on the card, exact launches
    on_card = device is None or torch.device(device).type == "cuda"
    counters = _counters()
    _fresh(torch, on_card)
    losses, got, (launches, types), secs, stats, facts = _train_run(
        torch, cfg, train, device, seed, True, on_card, counters)
    memory = _peak(torch, on_card)
    steps = train["sgd_steps"] + train["adam_steps"]
    want = {"flash_attention_fwd": cfg["layers"] * steps,
            "flash_attention_bwd_dq": cfg["layers"] * steps,
            "flash_attention_bwd_dkv": cfg["layers"] * steps,
            "sgd_mom_update": facts["parameters"] * train["sgd_steps"],
            "adam_update": facts["parameters"] * train["adam_steps"]}
    if launches != want:
        raise RuntimeError("train phase launched %s, want %s"
                           % (launches, want))
    _require_types("train", types, launches, train["dtype"],
                   [k for k in want if k.startswith("flash")])
    if not all(np.isfinite(losses)):
        raise RuntimeError("train phase: non-finite loss in %s" % losses)
    _require_captured("train", stats.values(), on_card)

    # 4. the same run eagerly: the captured steps must land on the same
    # parameters, bit for bit
    _fresh(torch, on_card)
    e_losses, e_got, _, e_secs, e_stats, _ = _train_run(
        torch, cfg, train, device, seed, False, on_card, counters)
    e_memory = _peak(torch, on_card)
    same, worst, worst_name, differ = _equal_params(got, e_got)
    if not same or e_losses != losses:
        raise RuntimeError(
            "train phase: the captured steps land %g from the eager ones "
            "(%s, %d parameters differ; losses %s vs %s)"
            % (worst, worst_name, differ, losses, e_losses))
    del got, e_got
    step_s, eager_s = float(np.median(secs)), float(np.median(e_secs))
    b, t = facts["batch"], facts["seq"]
    result = {"phase": "train", "batch": b, "seq": t,
              "dtype": train["dtype"], "path": "captured", "steps": stats,
              "parameters": facts["parameters"],
              "elements": facts["elements"],
              "check": {"batch": cb, "seq": cs, "sgd_steps":
                        train["check_steps"], "losses": got_l,
                        "ref_losses": ref_l, "loss_rel_err": loss_err,
                        "param_max_abs_err": param_err,
                        "loss_rtol": TRAIN_LOSS_RTOL,
                        "param_atol": TRAIN_PARAM_ATOL},
              "check_bf16": check_bf16, "losses": losses,
              "timed_step_ms": [x * 1e3 for x in secs],
              "median_step_ms": step_s * 1e3,
              "tokens_per_s": b * t / step_s,
              "eager": {"timed_step_ms": [x * 1e3 for x in e_secs],
                        "median_step_ms": eager_s * 1e3,
                        "tokens_per_s": b * t / eager_s,
                        "steps": e_stats, **e_memory},
              "captured_vs_eager": {"bit_for_bit": same,
                                    "losses_equal": True},
              "launches": launches, "launches_by_type": types, **memory}
    emit(result)
    return launches


def _resnet_counters():
    from mxnet_tpu_torch.ops.kernels import conv_wgrad as cw
    from mxnet_tpu_torch.ops.kernels import fused_update as fu

    return {"conv_wgrad_partial": (cw.conv_wgrad_partial,),
            "conv_wgrad_reduce": (cw.conv_wgrad_reduce,),
            "conv_wgrad_repack": (cw.repack,),
            "sgd_mom_update": (fu.sgd_mom_update, fu.sgd_mom_update_lr)}


def resnet_wgrad_launches(per_step, steps, repacks=False):
    """conv_wgrad's launches over ``steps`` steps of a model with
    ``per_step`` 3x3 convolutions: every call launches one partial kernel
    (whatever its route) and one reduce kernel; with ``repacks`` (bf16 on
    the card, where every ResNet-50 shape takes the wgmma route) the repack
    kernel once for x and once for dy (NCHW views, never the wgmma
    operand's form)."""
    return {"conv_wgrad_partial": per_step * steps,
            "conv_wgrad_reduce": per_step * steps,
            "conv_wgrad_repack": 2 * per_step * steps if repacks else 0}


def _fit_timed(torch, mod, it, kwargs, on_card, also=None):
    """``mod.fit(it, **kwargs)`` with a synchronized time and the metric
    after each batch (then ``also(param)``, outside the time): (ms from
    each batch's end to the next's, the first batch's ms, the metrics)."""
    times, metrics = [], []

    def record(param):
        if on_card:
            torch.cuda.synchronize()
        times.append(time.perf_counter())
        metrics.append({k: float(v) for k, v in
                        param.eval_metric.get_name_value()})
        if also is not None:
            also(param)

    t0 = time.perf_counter()
    mod.fit(it, batch_end_callback=record, **kwargs)
    return ([(b - a) * 1e3 for a, b in zip(times, times[1:])],
            (times[0] - t0) * 1e3, metrics)


def _steady_ms(step_ms, on_card):
    """The step times of replays: on the card the first CAPTURE_WARMUP
    batch-to-batch times hold the second warm-up call and the capture."""
    from mxnet_tpu_torch.executor import CAPTURE_WARMUP

    steady = step_ms[CAPTURE_WARMUP:] if on_card else step_ms
    return float(np.median(steady or step_ms))


def _eager_twin(torch, setup, kwargs, on_card, want, what):
    """The run of a captured ``Module.fit`` again with the fused step
    eager (``MXNET_CUDA_GRAPH=0``) from the same set-up: its parameters
    and aux states must equal ``want`` (the captured run's) bit for bit.
    Returns the eager run's record."""
    _fresh(torch, on_card)
    with cuda_graph(False):
        mod, it, init = setup()
        step_ms, first_ms, _ = _fit_timed(torch, mod, it, kwargs(init),
                                          on_card)
        stats = mod.fit_step_stats()
        got = _host_state(mod)
    memory = _peak(torch, on_card)
    del mod
    same_args = _equal_params(got[0], want[0])
    same_aux = _equal_params(got[1], want[1]) if want[1] else (True, 0.0,
                                                               None, 0)
    if not (same_args[0] and same_aux[0]):
        raise RuntimeError(
            "%s: the captured steps land %g (%s) / aux %g (%s) from the "
            "eager ones" % (what, same_args[1], same_args[2], same_aux[1],
                            same_aux[2]))
    return {"path": stats["path"], "steps": stats,
            "step_ms": step_ms, "first_batch_ms": first_ms,
            "median_step_ms": float(np.median(step_ms)), **memory}


def _host_state(mod):
    """Copies of a module's parameters and aux states, by name."""
    args, aux = mod.get_params()
    return ({n: np.array(a.asnumpy()) for n, a in args.items()},
            {n: np.array(a.asnumpy()) for n, a in aux.items()})


def _fit_recorded(mod, it, init, kwargs):
    """``mod.fit(it, **kwargs)`` (one epoch) from ``init`` (binding and
    initializing first if the set-up has not); returns the parameters and
    aux states before the first step and after each batch, and the metric
    after each batch."""
    if not mod.binded:
        mod.bind(it.provide_data, it.provide_label)
    mod.init_params(init)
    states, metrics = [_host_state(mod)], []

    def record(param):
        states.append(_host_state(mod))
        metrics.append({k: float(v) for k, v in
                        param.eval_metric.get_name_value()})

    mod.fit(it, batch_end_callback=record, **kwargs)
    return states, metrics


def _change_errs(before, after, ref_before, ref_after):
    """name -> tools/resnet.py change_err of each array's change."""
    return {n: change_err(after[n] - before[n].astype(np.float64),
                          ref_after[n] - ref_before[n].astype(np.float64))
            for n in ref_after}


def _fit_check(setup, kwargs, device, ref_device, tol, what,
               counters=None, exact_zero=()):
    """One ``Module.fit`` epoch of ``setup(dev)`` (module, iterator,
    initializer) on ``device`` and on ``ref_device`` from the same
    weights and batches (``kwargs(init)`` its fit arguments). Gates, as the
    resnet check's: after batch 1 each parameter's update within
    ``tol["update"]`` of the reference's (L2 of the difference over the
    L2 of the update), each aux state's change within ``tol["aux"]``, the
    accuracy equal; the cross-entropy after batch b within
    ``tol["ce"][b - 1]`` (relative). The parameters of ``exact_zero``
    (zero gradient in exact arithmetic, ``image_zoo.dead_shifts``) are
    left out of the update gate; their largest difference of change is
    recorded. ``counters`` are counted over the device's fit alone: their
    launches are returned beside the record."""
    runs, launches = [], None
    for dev in (device, ref_device):
        mod, it, init = setup(dev)
        if counters is not None and not runs:
            _zero(counters)
        runs.append(_fit_recorded(mod, it, init, kwargs(init)))
        if counters is not None and len(runs) == 1:
            launches = _count(counters)
        del mod
    (got_s, got_m), (ref_s, ref_m) = runs
    init_err = max(float(np.abs(got_s[0][0][n] - ref_s[0][0][n]).max())
                   for n in ref_s[0][0])
    steps = len(ref_m)
    upd = [{n: e for n, e in _change_errs(
        got_s[0][0], got_s[b][0], ref_s[0][0], ref_s[b][0]).items()
        if n not in exact_zero} for b in range(1, steps + 1)]
    aux = [_change_errs(got_s[0][1], got_s[b][1], ref_s[0][1], ref_s[b][1])
           for b in range(1, steps + 1)]
    ce = [abs(g["cross-entropy"] - r["cross-entropy"]) / r["cross-entropy"]
          for g, r in zip(got_m, ref_m)]
    failures = []
    if init_err != 0.0:
        failures.append("initial weights differ by %g" % init_err)
    worst_upd = max(upd[0], key=upd[0].get)
    if not upd[0][worst_upd] <= tol["update"]:
        failures.append("batch-1 update of %s off by %g (tol %g)"
                        % (worst_upd, upd[0][worst_upd], tol["update"]))
    if aux[0]:
        worst_aux = max(aux[0], key=aux[0].get)
        if not aux[0][worst_aux] <= tol["aux"]:
            failures.append("batch-1 change of %s off by %g (tol %g)"
                            % (worst_aux, aux[0][worst_aux], tol["aux"]))
    if got_m[0]["accuracy"] != ref_m[0]["accuracy"]:
        failures.append("batch-1 accuracy %s vs %s" % (
            got_m[0]["accuracy"], ref_m[0]["accuracy"]))
    for b, (err, t) in enumerate(zip(ce, tol["ce"])):
        if not err <= t:
            failures.append("batch-%d cross-entropy off by %g (tol %g)"
                            % (b + 1, err, t))
    if failures:
        raise RuntimeError("%s: %s" % (what, "; ".join(failures)))
    wgrad_names = [n for n in upd[0] if ref_s[0][0][n].ndim == 4
                   and ref_s[0][0][n].shape[-2:] == (3, 3)]
    record = {"batches": steps,
              "metrics": got_m, "ref_metrics": ref_m, "ce_rel_err": ce,
              "update_err": [{"worst": max(u.values()),
                              "worst_name": max(u, key=u.get),
                              "median": float(np.median(list(u.values()))),
                              "worst_3x3_weight": max(
                                  [u[n] for n in wgrad_names] or [0.0])}
                             for u in upd],
              "aux_err": [{"worst": max(a.values()),
                           "median": float(np.median(list(a.values())))}
                          if a else {} for a in aux],
              "tol": tol}
    if exact_zero:
        record["exact_zero"] = {
            "parameters": len(exact_zero),
            "max_abs_change_diff": max(float(np.abs(
                (got_s[-1][0][n] - got_s[0][0][n])
                - (ref_s[-1][0][n] - ref_s[0][0][n])).max())
                for n in exact_zero)}
    return record if counters is None else (record, launches)


def phase_resnet(cfg=RESNET, device=None, ref_device="cpu", seed=SEED):
    """ResNet-50 through ``Module.fit``. ``device`` None = the card; the
    card-vs-reference check runs the same weights and batches on
    ``ref_device``, where every wrapper takes its plain version."""
    import torch

    # 1. card vs the port's CPU path: same init, same 2 batches of 2
    check = _fit_check(
        lambda dev: resnet_setup(cfg, cfg["check_batch"], cfg["check_steps"],
                                 dev, seed),
        lambda init: fit_args(cfg, init), device, ref_device,
        {"update": RESNET_UPDATE, "aux": RESNET_AUX, "ce": RESNET_CE},
        "resnet check")

    check = dict(check, batch=cfg["check_batch"])

    # 2. the run: one epoch of `batches` batches of `batch`, in bench.py's
    # compute type, through the captured fused step
    on_card = device is None or torch.device(device).type == "cuda"
    run, launches = _captured_fit(
        torch, lambda: resnet_setup(cfg, cfg["batch"], cfg["batches"],
                                    device, seed, compute_dtype=cfg["dtype"]),
        lambda init: fit_args(cfg, init), cfg, on_card, "resnet")
    emit(dict({"phase": "resnet", "depth": cfg["depth"],
               "classes": cfg["classes"], "image": list(cfg["image"])},
              **run, check=check))
    return launches


def wgrad_routes(sym, image, batch, dtype):
    """{route: conv_wgrad calls a step} of ``sym`` on ``batch`` images of
    ``image`` in ``dtype`` (``conv_wgrad.plan``'s route of each shape)."""
    from mxnet_tpu_torch.ops.kernels import conv_wgrad as cw

    out = {}
    for (n, h, w, c, k, stride, pad), count in wgrad_shapes(
            sym, image, batch).items():
        route = cw.plan(n, h, w, c, k, 3, stride, pad, dtype).route
        out[route] = out.get(route, 0) + count
    return out


def _route_counters():
    from mxnet_tpu_torch.ops.kernels import conv_wgrad as cw

    return {route: (c,) for route, c in cw.partial_by_route.items()}


def _captured_fit(torch, setup, kwargs, cfg, on_card, phase,
                  measure="cross-entropy", twin=None):
    """One epoch of ``Module.fit`` of ``setup()`` through the captured
    fused step, then its eager twin (bit for bit, :func:`_eager_twin`).
    Gates: exact launches (every conv_wgrad call of each step, all of
    ``cfg["dtype"]``, on the card on each call's route of ``plan``, with
    two repacks a call on the wgmma route; one ``sgd_mom_update`` a
    parameter and batch), a finite ``measure`` after every batch, the
    captured path taken on the card. ``twin(state, launches)``, run
    last, returns a further record (another run held to this one's
    parameters and launches). Returns
    the run's record and its launches."""
    mod, it, init = setup()
    counters, routes = _resnet_counters(), _route_counters()
    _fresh(torch, on_card)
    _zero(counters)
    _zero(routes)
    step_ms, first_ms, metrics = _fit_timed(torch, mod, it, kwargs(init),
                                            on_card)
    launches, types = _count(counters), _types(counters)
    by_route = _count(routes)
    by_entry = {c.__name__: c.launches
                for c in counters["sgd_mom_update"]}
    memory = _peak(torch, on_card)
    stats = mod.fit_step_stats()
    steps = cfg["batches"]
    state = _host_state(mod)
    args, aux = state
    n_params = len(args)
    per_step = wgrad_convs(mod.symbol)
    per_route = wgrad_routes(mod.symbol, cfg["image"], cfg["batch"],
                             cfg["dtype"])
    want = dict(resnet_wgrad_launches(per_step, steps),
                conv_wgrad_repack=2 * per_route.get("wgmma", 0) * steps
                if on_card and cfg["dtype"] == "bfloat16" else 0,
                sgd_mom_update=n_params * steps)
    if launches != want:
        raise RuntimeError("%s phase launched %s, want %s"
                           % (phase, launches, want))
    want_routes = {r: per_route.get(r, 0) * steps if on_card else 0
                   for r in by_route}
    if by_route != want_routes:
        raise RuntimeError("%s phase launched conv_wgrad by route %s, want "
                           "%s" % (phase, by_route, want_routes))
    # the captured step reads lr / wd on the card: the device-lr entry
    want_entry = {"sgd_mom_update": 0,
                  "sgd_mom_update_lr": n_params * steps}
    if on_card and by_entry != want_entry:
        raise RuntimeError("%s phase launched the update by entry %s, want "
                           "%s" % (phase, by_entry, want_entry))
    _require_types(phase, types, launches, cfg["dtype"],
                   ["conv_wgrad_partial"])
    ce_run = [m[measure] for m in metrics]
    if len(metrics) != steps or not all(np.isfinite(ce_run)):
        raise RuntimeError("%s phase: %d batches, %s %s"
                           % (phase, len(metrics), measure, ce_run))
    _require_captured(phase, [stats], on_card)
    del mod
    eager = _eager_twin(torch, setup, kwargs, on_card, state,
                        "%s phase" % phase)
    extra = {"twin": twin(state, launches)} if twin is not None else {}
    median_ms = _steady_ms(step_ms, on_card)
    return {**extra, "batch": cfg["batch"], "batches": steps,
            "dtype": cfg["dtype"], "path": stats["path"], "steps": stats,
            "parameters": n_params,
            "elements": int(sum(a.size for a in args.values())),
            "aux_states": len(aux),
            "wgrad_convs_per_step": per_step,
            "metrics": metrics, "first_batch_ms": first_ms,
            "step_ms": step_ms, "median_step_ms": median_ms,
            "images_per_s": cfg["batch"] / median_ms * 1e3,
            "eager": dict(eager, images_per_s=cfg["batch"]
                          / eager["median_step_ms"] * 1e3),
            "captured_vs_eager": {"bit_for_bit": True},
            "launches": launches, "launches_by_type": types,
            "conv_wgrad_by_route": by_route,
            "conv_wgrad_routes_per_step": per_route,
            "sgd_mom_update_by_entry": by_entry, **memory}, launches


def _prefetch_twin(torch, setup, kwargs, on_card, want, want_launches,
                   what, ctx=None):
    """The captured run of ``setup()`` again, fed through
    ``DevicePrefetchIter`` (pinned staging, its copy stream, the slot
    events) over the same ``NDArrayIter``: the parameters must equal
    ``want`` (the run fed directly) bit for bit and the kernels launch
    ``want_launches``, through the captured path on the card. Returns its
    step times."""
    from mxnet_tpu_torch import io

    _fresh(torch, on_card)
    mod, it, init = setup()
    counters = _resnet_counters()
    _zero(counters)
    pre = io.DevicePrefetchIter(it, ctx=ctx)
    try:
        step_ms, first_ms, _ = _fit_timed(torch, mod, pre, kwargs(init),
                                          on_card)
        stats = mod.fit_step_stats()
        got = _host_state(mod)
    finally:
        pre.close()
    del mod
    launches = _count(counters)
    if launches != want_launches:
        raise RuntimeError("%s: fed through DevicePrefetchIter, launched %s, "
                           "want %s" % (what, launches, want_launches))
    _require_captured(what, [stats], on_card)
    same = _equal_params(got[0], want[0])
    if not same[0]:
        raise RuntimeError(
            "%s: fed through DevicePrefetchIter, %d parameters land off the "
            "NDArrayIter run's, the worst %s by %g" % (what, same[3],
                                                       same[2], same[1]))
    return {"iterator": "DevicePrefetchIter(depth 2)", "path": stats["path"],
            "steps": stats, "step_ms": step_ms, "first_batch_ms": first_ms,
            "median_step_ms": _steady_ms(step_ms, on_card),
            "launches": launches, "bit_for_bit_with_ndarray_iter": True}


# --- image_zoo ---------------------------------------------------------------
def _run_op(torch, op, arrays, aux_arrays, attrs, diff, cot_seed, device):
    """One registry op on ``device`` (training mode): its outputs, its
    aux updates and, for ``diff``, the vector-Jacobian product of the
    first output at a seeded cotangent; all as host arrays (f32 for
    bfloat16)."""
    from mxnet_tpu_torch.ops import registry as treg

    top = treg.get_op(op)
    parsed = top.parse_attrs(dict(attrs))
    xs = [torch.tensor(a, device=device) for a in arrays]
    for i in diff:
        xs[i].requires_grad_()
    aux = tuple(torch.tensor(a, device=device) for a in aux_arrays)
    outs, aux_up = top.impl(parsed, tuple(xs), aux,
                            treg.OpContext(True, torch.device(device)))

    def host(t):
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()

    grads = []
    if diff:
        cot = np.random.RandomState(cot_seed).randn(*outs[0].shape)
        grads = [host(g) for g in torch.autograd.grad(
            outs[0], [xs[i] for i in diff],
            torch.tensor(cot, dtype=outs[0].dtype, device=device))]
    return [host(o) for o in outs] + [host(a) for a in aux_up], grads


def _zoo_ops_check(torch, device, ref_device, seed, contrib=False):
    """Each case of ``tools/op_cases.py`` at full shapes on ``device``
    against ``ref_device``, the core ops' or (``contrib``) the
    nine contrib ops': an ``exact`` output bit for bit (indexing,
    ordering with ties, rounding, Cast, the logical ops, the pads, crops
    and moves, MultiBoxTarget's mask and class targets), any other within
    ZOO_OP_RTOL of the reference's largest output (libm and summation
    order differ; a keep mask or class that differs moves a
    MultiBoxDetection or Proposal row by far more); every gradient within
    ZOO_GRAD_RTOL of its largest entry (scatter-adds, count_sketch's
    atomic index_add and sums in another order). Returns {case: max
    |error|} of outputs and gradients."""
    errs, failures = {}, []
    cases = sorted((k, c) for k, c in op_cases(big=True).items()
                   if (c.op in CONTRIB_OPS) == contrib)
    for k, (name, case) in enumerate(cases):
        op, makers, attrs, diff, exact, aux = case
        kind = "exact" if exact is True else "close" if not exact \
            else "exact outputs %s" % (list(exact),)
        rng = np.random.RandomState(seed + k)
        arrays = [m(rng) for m in makers]
        aux_arrays = [m(rng) for m in aux]
        # the cotangent's own seed: one equal to the inputs' would draw
        # the data again, and a norm's gradient at a cotangent along its
        # input is all cancellation
        cot_seed = rng.randint(1 << 30)
        got, got_g = _run_op(torch, op, arrays, aux_arrays, attrs, diff,
                             cot_seed, device)
        want, want_g = _run_op(torch, op, arrays, aux_arrays, attrs, diff,
                               cot_seed, ref_device)
        out_err = grad_err = 0.0
        for i, (g, w) in enumerate(zip(got, want)):
            if g.shape != w.shape:
                failures.append("%s: shape %s vs %s" % (name, g.shape,
                                                        w.shape))
                continue
            bitwise = exact_output(case, i)
            if bitwise and not np.array_equal(g, w, equal_nan=True):
                failures.append("%s: output %d not bit for bit" % (name, i))
            fin = np.isfinite(w)
            err = float(np.abs(g - w)[fin].max()) if fin.any() else 0.0
            out_err = max(out_err, err)
            if not np.array_equal(np.isfinite(g), fin):
                failures.append("%s: finite at other places" % name)
            elif not bitwise and not err <= ZOO_OP_RTOL * float(
                    np.abs(w[fin]).max()):
                failures.append("%s: off by %g of max %g" % (
                    name, err, float(np.abs(w[fin]).max())))
        for g, w in zip(got_g, want_g):
            err = float(np.abs(g - w).max())
            grad_err = max(grad_err, err)
            if not err <= ZOO_GRAD_RTOL * max(float(np.abs(w).max()), 1e-30):
                failures.append("%s: gradient off by %g of max %g" % (
                    name, err, float(np.abs(w).max())))
        errs[name] = {"kind": kind, "max_abs_err": out_err,
                      "grad_max_abs_err": grad_err}
    if failures:
        raise RuntimeError("image_zoo ops: " + "; ".join(failures))
    return errs


def zoo_tol(name, spread=None, witness=None):
    """The image_zoo check's gates for model ``name``: IMAGE_ZOO_GATE x its
    CPU f32-vs-f64 distances (``spread``, default IMAGE_ZOO_SPREAD) x the
    larger of 1 and its witness ratio (``witness``, default
    IMAGE_ZOO_WITNESS), the cross-entropy's at least IMAGE_ZOO_CE_FLOOR."""
    s = (spread or IMAGE_ZOO_SPREAD)[name]
    scale = IMAGE_ZOO_GATE * max(1.0, (witness or IMAGE_ZOO_WITNESS)[name])
    return {"update": scale * s["update"], "aux": scale * s["aux"],
            "ce": tuple(max(scale * c, IMAGE_ZOO_CE_FLOOR)
                        for c in s["ce"])}


def zoo_wgrad_shapes(cfg):
    """{(n, h, w, c, k, stride, pad): {model: calls a step}} of every
    conv_wgrad call of one full-width step of each of ``cfg["check"]``'s
    models at ``cfg["wgrad_batch"]``."""
    shapes = {}
    for name, side in cfg["check"].items():
        for key, count in wgrad_shapes(zoo_symbol(name, cfg["classes"]),
                                       (3, side, side),
                                       cfg["wgrad_batch"]).items():
            shapes.setdefault(key, {})[name] = count
    return shapes


def _zoo_wgrad(torch, cfg, device, on_card, seed, shapes=None):
    """conv_wgrad at every shape of :func:`zoo_wgrad_shapes`, bf16 and f32,
    on the NHWC views of NCHW tensors as the Convolution op passes them:
    against its plain version in f64 (``wgrad_rtol`` of max |dW|: the
    kernel's own f32 rounding over up to 1.6 M terms), two calls equal,
    each case's route named; on the card each timed beside the plain
    version and cuDNN's wgrad (CUDA events), with its bound. Fails unless
    the bf16 shapes reach both the wgmma and the simt bodies and the f32
    ones the f32 body. ``shapes``: another table of that form (ssd's).
    Returns (rows, worst error by type)."""
    from mxnet_tpu_torch.ops.kernels import conv_wgrad as cw

    gen = torch.Generator(device=device).manual_seed(seed + 29)
    rows, worst, routes = [], {}, {}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for (n, h, w, c, k, stride, pad), models in sorted(
                (shapes or zoo_wgrad_shapes(cfg)).items()):
            oh, ow = cw.out_size(h, 3, stride, pad), cw.out_size(w, 3, stride,
                                                                pad)
            x = torch.randn(n, c, h, w, generator=gen, device=device).to(dt)
            dy = torch.randn(n, k, oh, ow, generator=gen,
                             device=device).to(dt)
            xv, dv = x.permute(0, 2, 3, 1), dy.permute(0, 2, 3, 1)
            p = cw.plan_of(xv, dv, 3, stride, pad)
            fn = cw.wgrad if dtype == "float32" else cw.conv_wgrad
            got = fn(xv, dv, 3, stride, pad)
            again = fn(xv, dv, 3, stride, pad)
            want = cw.conv_wgrad_plain(xv.double(), dv.double(), 3, stride,
                                       pad)
            err = float((got.double() - want).abs().max())
            rel = err / float(want.abs().max())
            case = [n, h, w, c, k, stride, pad]
            tol = wgrad_rtol(n * oh * ow)
            if not rel <= tol:
                raise RuntimeError("conv_wgrad %s %s (%s route): error %g of "
                                   "max |dW| (tol %g)" % (dtype, case,
                                                          p.route, rel, tol))
            if not torch.equal(got, again):
                raise RuntimeError("conv_wgrad %s %s (%s route): two calls "
                                   "differ" % (dtype, case, p.route))
            row = {"shape": case, "dtype": dtype, "per_step": models,
                   "route": p.route, "kernel": p.kernel, "bn": p.bn,
                   "splits": p.splits, "max_abs_err": err,
                   "err_of_max": rel, "tol_of_max": tol}
            if on_card:
                bound_ms, bound_by = wgrad_bound(n, h, c, k, 3, stride,
                                                 dtype, pad)
                row.update(
                    ms=time_ms(torch, lambda: fn(xv, dv, 3, stride, pad),
                               reps=10),
                    plain_ms=time_ms(torch, lambda: cw.conv_wgrad_plain(
                        xv, dv, 3, stride, pad), reps=5, warmup=1),
                    library_ms=time_ms(torch, lambda: torch.nn.grad.
                                       conv2d_weight(x, (k, c, 3, 3), dy,
                                                     stride=stride,
                                                     padding=pad), reps=10),
                    bound_ms=bound_ms, bound_by=bound_by)
            rows.append(row)
            routes.setdefault(dtype, set()).add(p.route)
            worst[dtype] = max(worst.get(dtype, 0.0), err)
            del x, dy, xv, dv, got, again, want
    if routes != {"bfloat16": {"wgmma", "simt"}, "float32": {"f32"}}:
        raise RuntimeError("the conv_wgrad shape table took the routes %s"
                           % routes)
    return rows, worst


def wgrad_step_of(rows, model, dtype):
    """Each timing of ``rows`` (:func:`_zoo_wgrad`) summed over one step
    of ``model`` in ``dtype``: a shape's row times its calls a step."""
    mine = [r for r in rows if r["dtype"] == dtype and model in
            r["per_step"]]
    return {key: sum(r[key] * r["per_step"][model] for r in mine)
            for key in ("ms", "plain_ms", "library_ms", "bound_ms")
            if all(key in r for r in mine)}


def phase_image_zoo(cfg=IMAGE_ZOO, device=None, ref_device="cpu", seed=SEED,
                    spread=None, witness=None):
    """The image-classification zoo (``tools/image_zoo.py``): the new ops
    card vs CPU; conv_wgrad at every eligible 3x3 shape of the seven
    models; Inception-BN trained at full width, bf16, through the captured
    fit step and its eager twin; each of the seven models card vs CPU.
    ``device`` None = the card; ``spread`` and ``witness`` the checks'
    yardsticks (:func:`zoo_tol`)."""
    import torch

    t0 = time.perf_counter()
    on_card = device is None or torch.device(device).type == "cuda"
    dev = "cuda" if device is None else device
    seconds = {}
    ops = _zoo_ops_check(torch, dev, ref_device, seed)
    seconds["ops"] = time.perf_counter() - t0

    t1 = time.perf_counter()
    rows, wgrad_worst = _zoo_wgrad(torch, cfg, dev, on_card, seed)
    seconds["conv_wgrad"] = time.perf_counter() - t1

    # the main run: every conv_wgrad call takes the wgmma route in bf16
    # (the launch arithmetic counts two repacks a call)
    main = cfg["main"]
    from mxnet_tpu_torch.ops.kernels import conv_wgrad as cw

    main_shapes = wgrad_shapes(zoo_symbol(main["model"], main["classes"]),
                               main["image"], main["batch"])
    off = [s for s in main_shapes if cw.plan(*s[:4], s[4], 3, s[5], s[6],
                                             "bfloat16").route != "wgmma"]
    if off:
        raise RuntimeError("image_zoo: %s shapes %s do not take the wgmma "
                           "route" % (main["model"], off))
    t1 = time.perf_counter()
    _fresh(torch, on_card)
    run, launches = _captured_fit(
        torch, lambda: zoo_setup(main["model"], main, main["batch"],
                                 main["batches"], device, seed,
                                 compute_dtype=main["dtype"]),
        lambda init: fit_args(main, init), main, on_card, "image_zoo")
    seconds["main"] = time.perf_counter() - t1

    t1 = time.perf_counter()
    checks, check_launches = {}, {}
    for name, side in cfg["check"].items():
        mcfg = image_cfg(cfg, side)
        sym = zoo_symbol(name, cfg["classes"])
        _fresh(torch, on_card)
        checks[name], got = _fit_check(
            lambda d, _n=name, _c=mcfg: zoo_setup(
                _n, _c, cfg["check_batch"], cfg["check_steps"], d, seed),
            lambda init, _c=mcfg: fit_args(_c, init), device, ref_device,
            zoo_tol(name, spread, witness), "image_zoo check of %s" % name,
            counters=_resnet_counters(), exact_zero=dead_shifts(sym))
        calls = wgrad_convs(sym) * cfg["check_steps"]
        if (got["conv_wgrad_partial"], got["conv_wgrad_reduce"]) != \
                (calls, calls):
            raise RuntimeError("image_zoo check of %s launched conv_wgrad "
                               "%s, want %d + %d" % (name, got, calls,
                                                     calls))
        check_launches[name] = got
    seconds["check"] = time.perf_counter() - t1
    seconds["phase"] = time.perf_counter() - t0
    emit({"phase": "image_zoo", "model": main["model"],
          "classes": main["classes"], "image": list(main["image"]), **run,
          "wgrad_step": {dtype: wgrad_step_of(rows, main["model"], dtype)
                         for dtype in ("bfloat16", "float32")},
          "checks": checks, "check_launches": check_launches,
          "ops": ops, "wgrad_shapes": rows,
          "wgrad_max_abs_err": wgrad_worst, "seconds": seconds})
    check_sum = {k: sum(c[k] for c in check_launches.values())
                 for k in ("conv_wgrad_partial", "conv_wgrad_reduce")}
    return {"main": launches, "check": check_sum, "wgrad": rows,
            "wgrad_max_abs_err": wgrad_worst}


# --- ssd ---------------------------------------------------------------------
def ssd_tol(spread=None, witness=None):
    """The ssd check's gates: IMAGE_ZOO_GATE x its CPU f32-vs-f64
    distances (``spread``, default SSD_SPREAD) x the larger of 1 and its
    witness ratio (``witness``, default SSD_WITNESS); the cross-entropy's
    and the smooth L1's at least IMAGE_ZOO_CE_FLOOR."""
    s = spread or SSD_SPREAD
    scale = IMAGE_ZOO_GATE * max(1.0, SSD_WITNESS if witness is None
                                 else witness)
    return {"update": scale * s["update"],
            "ce": tuple(max(scale * c, IMAGE_ZOO_CE_FLOOR)
                        for c in s["ce"]),
            "smooth_l1": tuple(max(scale * c, IMAGE_ZOO_CE_FLOOR)
                               for c in s["smooth_l1"])}


def _ssd_matching(cfg, device, ref_device, seed):
    """MultiBoxTarget on the check's labels with the model's anchors, on
    ``device`` and on ``ref_device``: the class targets and the mask
    equal but at the anchors a rounding may flip
    (``ssd.matching_excused``: a best IoU within SSD_IOU_MARGIN of the
    threshold, two ground truths within SSD_TIE_MARGIN); the location
    targets of the anchors positive on both within SSD_DECODE_ATOL."""
    _, labels = ssd_data(cfg, cfg["check_batch"], cfg["check_steps"],
                         seed + 1)
    got = ssd_targets(cfg, labels, device)
    want = ssd_targets(cfg, labels, ref_device)
    anchors, b = want[0], labels.shape[0]
    excused = matching_excused(anchors, labels, cfg["overlap_threshold"],
                               SSD_IOU_MARGIN, SSD_TIE_MARGIN)
    mask_g, mask_w = (m.reshape(b, -1, 4)[..., 0] for m in (got[2], want[2]))
    differ = (got[3] != want[3]) | (mask_g != mask_w)
    if (differ & ~excused).any():
        raise RuntimeError("ssd matching: %d anchors' targets differ between "
                           "the devices outside the excused ones"
                           % int((differ & ~excused).sum()))
    both = np.repeat(((mask_g > 0) & (mask_w > 0))[..., None], 4,
                     axis=-1).reshape(b, -1)
    loc_err = float(np.abs(got[1] - want[1])[both].max()) if both.any() \
        else 0.0
    if not loc_err <= SSD_DECODE_ATOL:
        raise RuntimeError("ssd matching: location targets differ by %g"
                           % loc_err)
    return {"anchors": int(anchors.shape[1]),
            "anchor_max_abs_err": float(np.abs(got[0] - anchors).max()),
            "positive": int((mask_w > 0).sum()),
            "excused": int(excused.sum()), "differ": int(differ.sum()),
            "loc_target_max_abs_err": loc_err}


def _ssd_check(cfg, device, ref_device, tol, seed):
    """ssd-vgg16 card vs CPU: one ``Module.fit`` epoch (``check_steps``
    batches of ``check_batch``, f32) on ``device`` and on ``ref_device``
    from the same weights and batches. Gates: each parameter's batch-1
    update within ``tol["update"]`` of the reference's; the multibox
    metric's cross-entropy and smooth L1 after each batch within
    ``tol["ce"]`` / ``tol["smooth_l1"]`` (relative); every conv_wgrad call
    launched (f32 route on the card); the matching
    (:func:`_ssd_matching`)."""
    import torch

    counters, routes = _resnet_counters(), _route_counters()
    runs = []
    for dev in (device, ref_device):
        mod, it, init = ssd_setup(cfg, cfg["check_batch"],
                                  cfg["check_steps"], dev, seed)
        if not runs:
            _zero(counters)
            _zero(routes)
        runs.append(_fit_recorded(mod, it, init, ssd_fit_args(cfg, init)))
        if len(runs) == 1:
            launches, by_route = _count(counters), _count(routes)
        calls = wgrad_convs(mod.symbol) * cfg["check_steps"]
        del mod
    (got_s, got_m), (ref_s, ref_m) = runs
    on_card = device is None or torch.device(device).type == "cuda"
    failures = []
    if (launches["conv_wgrad_partial"], launches["conv_wgrad_reduce"]) != \
            (calls, calls) or (on_card and by_route["f32"] != calls):
        failures.append("conv_wgrad launched %s (by route %s), want %d + %d"
                        % (launches, by_route, calls, calls))
    init_err = max(float(np.abs(got_s[0][0][n] - ref_s[0][0][n]).max())
                   for n in ref_s[0][0])
    if init_err != 0.0:
        failures.append("initial weights differ by %g" % init_err)
    upd = [_change_errs(got_s[0][0], got_s[b][0], ref_s[0][0], ref_s[b][0])
           for b in range(1, len(ref_m) + 1)]
    worst = max(upd[0], key=upd[0].get)
    if not upd[0][worst] <= tol["update"]:
        failures.append("batch-1 update of %s off by %g (tol %g)"
                        % (worst, upd[0][worst], tol["update"]))
    rel = {k: [abs(g[k] - r[k]) / r[k] for g, r in zip(got_m, ref_m)]
           for k in ("cross-entropy", "smooth_l1")}
    for k, key in (("cross-entropy", "ce"), ("smooth_l1", "smooth_l1")):
        for b, (err, t) in enumerate(zip(rel[k], tol[key])):
            if not err <= t:
                failures.append("batch-%d %s off by %g (tol %g)"
                                % (b + 1, k, err, t))
    if failures:
        raise RuntimeError("ssd check: " + "; ".join(failures))
    matching = _ssd_matching(cfg, device, ref_device, seed)
    return {"batch": cfg["check_batch"], "batches": len(ref_m),
            "metrics": got_m, "ref_metrics": ref_m,
            "ce_rel_err": rel["cross-entropy"],
            "smooth_l1_rel_err": rel["smooth_l1"],
            "update_err": [{"worst": max(u.values()),
                            "worst_name": max(u, key=u.get),
                            "median": float(np.median(list(u.values())))}
                           for u in upd],
            "tol": tol, "conv_wgrad": launches,
            "conv_wgrad_by_route": by_route, "matching": matching}


def _ssd_detect_gates(got, want, cls_prob, cfg):
    """One batch of MultiBoxDetection rows on the card (``got``) against
    the CPU's (``want``, from ``cls_prob``): scores and boxes of every
    anchor within SSD_DECODE_ATOL; each image's keep mask equal, or
    different only after a near-degenerate greedy choice
    (``ssd.nms_explained``); the class of an anchor kept on both equal,
    or the CPU's two best classes within SSD_SCORE_MARGIN. Returns the
    record."""
    decode = float(np.abs(got[..., 1:] - want[..., 1:]).max())
    if not decode <= SSD_DECODE_ATOL:
        raise RuntimeError("ssd detect: scores / boxes differ by %g"
                           % decode)
    excused, kept = 0, 0
    for i in range(want.shape[0]):
        keep_g, keep_w = got[i, :, 0] >= 0, want[i, :, 0] >= 0
        kept += int(keep_w.sum())
        ok, n, first = nms_explained(
            want[i, :, 2:], want[i, :, 1], want[i, :, 1] > 0.01, keep_g,
            keep_w, cfg["nms_threshold"], SSD_SCORE_MARGIN, SSD_IOU_MARGIN)
        if not ok:
            raise RuntimeError("ssd detect: image %d keeps %d anchors "
                               "differently, the first at score %.9g, with "
                               "no near tie above it" % (i, n, first))
        excused += n
        both = keep_g & keep_w
        flips = np.flatnonzero(both & (got[i, :, 0] != want[i, :, 0]))
        if flips.size:
            top = np.sort(cls_prob[i, 1:, flips], axis=0)
            if not ((top[-1] - top[-2]) < SSD_SCORE_MARGIN).all():
                raise RuntimeError("ssd detect: image %d: %d kept anchors "
                                   "change class" % (i, flips.size))
            excused += int(flips.size)
    return {"decode_max_abs_err": decode, "kept": kept,
            "excused": excused}


def _ssd_detect(torch, cfg, params, device, ref_device, seed, on_card):
    """The detection symbol (softmax, MultiBoxDetection; its class
    probabilities as a second output) through ``predict.Predictor`` with
    the run's trained weights, at each of ``cfg["detect_batches"]``: each
    bind the captured path, its replays equal the eager forward
    (MXNET_CUDA_GRAPH=0) bit for bit, the card against the CPU's
    Predictor under :func:`_ssd_detect_gates`; on the card the forward's
    ms (p50 of 20)."""
    from mxnet_tpu_torch import predict
    from mxnet_tpu_torch import symbol as msym

    det = ssd_symbol(cfg, "detect")
    group = msym.Group([det, det.get_internals()["cls_prob_output"]])
    sym = group.tojson()
    out = {}
    for b in cfg["detect_batches"]:
        shape = {"data": (b,) + tuple(cfg["image"])}
        x = np.random.RandomState(seed + 40 + b).uniform(
            -1, 1, shape["data"]).astype(np.float32)
        p = predict.Predictor(sym, params, shape, device=device)
        runs = [[o._data.cpu().numpy() for o in p.forward(data=x)]
                for _ in range(4)]
        with cuda_graph(False):
            e = p.reshape(shape)
        eager = [o._data.cpu().numpy() for o in e.forward(data=x)]
        for r in runs[2:]:
            if not all(np.array_equal(a, w) for a, w in zip(r, eager)):
                raise RuntimeError("ssd detect at batch %d: a replay differs "
                                   "from the eager forward" % b)
        path = _require_predictor_capture("ssd detect at batch %d" % b, p,
                                          on_card)
        ref = predict.Predictor(sym, params, shape, device=ref_device)
        want, want_prob = (o.asnumpy() for o in ref.forward(data=x))
        got = runs[-1][0]
        if got.shape != (b, want.shape[1], 6):
            raise RuntimeError("ssd detect at batch %d gave %s" % (b,
                                                                   got.shape))
        rec = dict(_ssd_detect_gates(got, want, want_prob, cfg),
                   path=path, replays_equal_eager=True)
        if on_card:
            rec["forward_ms_p50"] = time_ms(
                torch, lambda: p.forward(data=x), reps=20)
            rec["eager_forward_ms_p50"] = time_ms(
                torch, lambda: e.forward(data=x), reps=5, warmup=1)
        out[str(b)] = rec
        del p, e, ref
    return out


def wgrad_route_step(rows, dtype):
    """ms, plain_ms, library_ms and bound_ms of one step's conv_wgrad
    calls (``rows``: :func:`_zoo_wgrad` over ssd's shapes) in ``dtype``,
    by route."""
    out = {}
    for r in rows:
        if r["dtype"] != dtype or "ms" not in r:
            continue
        calls = sum(r["per_step"].values())
        acc = out.setdefault(r["route"], {"calls": 0})
        acc["calls"] += calls
        for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
            acc[key] = acc.get(key, 0.0) + r[key] * calls
    return out


def phase_ssd(cfg=SSD, device=None, ref_device="cpu", seed=SEED,
              spread=None, witness=None):
    """SSD (``tools/ssd.py``): the nine contrib ops card vs CPU
    (``tools/op_cases.py`` at full shapes); ssd-vgg16 card
    vs CPU (:func:`_ssd_check`, gates :func:`ssd_tol` of ``spread`` and
    ``witness``); conv_wgrad at ssd's 3x3 shapes, bf16 and f32, against
    its plain version in f64; the run at full width, bf16, through the
    captured fit step with exact launches (conv_wgrad by route and type,
    the repacks, ``sgd_mom_update_lr``), its eager twin and its
    DevicePrefetchIter twin bit for bit (the latter with the same
    launches); the detection symbol through
    ``Predictor``. ``device`` None = the card."""
    import torch

    t0 = time.perf_counter()
    on_card = device is None or torch.device(device).type == "cuda"
    dev = "cuda" if device is None else device
    seconds = {}
    ops = _zoo_ops_check(torch, dev, ref_device, seed, contrib=True)
    seconds["ops"] = time.perf_counter() - t0

    t1 = time.perf_counter()
    _fresh(torch, on_card)
    check = _ssd_check(dict(cfg, dtype="float32"), device, ref_device,
                       ssd_tol(spread, witness), seed)
    seconds["check"] = time.perf_counter() - t1

    t1 = time.perf_counter()
    sym = ssd_symbol(cfg)
    shapes = {key: {cfg["model"]: n} for key, n in wgrad_shapes(
        sym, cfg["image"], cfg["batch"]).items()}
    rows, wgrad_worst = _zoo_wgrad(torch, cfg, dev, on_card, seed,
                                   shapes=shapes)
    seconds["conv_wgrad"] = time.perf_counter() - t1

    t1 = time.perf_counter()
    _fresh(torch, on_card)

    def setup():
        return ssd_setup(cfg, cfg["batch"], cfg["batches"], device, seed,
                         compute_dtype=cfg["dtype"])

    def kwargs(init):
        return ssd_fit_args(cfg, init)

    trained = {}

    def twin(state, launches):
        trained["args"] = state[0]
        return _prefetch_twin(torch, setup, kwargs, on_card, state, launches,
                              "ssd phase", ctx=None if on_card else dev)

    run, launches = _captured_fit(torch, setup, kwargs, cfg, on_card, "ssd",
                                  measure="smooth_l1", twin=twin)
    prefetch = run.pop("twin")
    seconds["run"] = time.perf_counter() - t1

    t1 = time.perf_counter()
    _fresh(torch, on_card)
    params = {"arg:" + n: v for n, v in trained["args"].items()}
    detect = _ssd_detect(torch, cfg, params, device, ref_device, seed,
                         on_card)
    seconds["detect"] = time.perf_counter() - t1
    seconds["phase"] = time.perf_counter() - t0
    emit({"phase": "ssd", "model": cfg["model"], "classes": cfg["classes"],
          "image": list(cfg["image"]), "anchors": check["matching"][
              "anchors"], **run, "prefetch": prefetch,
          "wgrad_step_by_route": {dtype: wgrad_route_step(rows, dtype)
                                  for dtype in ("bfloat16", "float32")},
          "check": check, "detect": detect, "ops": ops,
          "wgrad_shapes": rows, "wgrad_max_abs_err": wgrad_worst,
          "seconds": seconds})
    return {"main": launches, "check": check["conv_wgrad"], "wgrad": rows,
            "wgrad_max_abs_err": wgrad_worst, "ops": ops}


def _reset_peak(torch):
    """Collect the modules an earlier check left in reference cycles (a
    fit's BatchEndParam holds its locals), then reset the card's peak
    memory; returns the bytes still allocated, the run's starting point."""
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def memory_holders(torch, top=8):
    """What holds the card's memory: the ``top`` largest active blocks of
    ``torch.cuda.memory_snapshot()``, the live CUDA tensors found by
    ``gc`` grouped by shape and type, largest first, each with the types
    of the objects that refer to it (a dict's owners named through it),
    and the allocated bytes that no live tensor holds (PyTorch's cuBLAS
    workspaces, one a stream that ran a product, are such bytes). It
    reads and frees nothing."""
    gc.collect()
    blocks = sorted((b["size"] for seg in torch.cuda.memory_snapshot()
                     for b in seg["blocks"]
                     if b["state"] == "active_allocated"), reverse=True)
    groups = {}
    for obj in gc.get_objects():
        if issubclass(type(obj), torch.Tensor) and obj.is_cuda:
            key = "%s %s" % (tuple(obj.shape), str(obj.dtype)[6:])
            g = groups.setdefault(key, [0, 0, []])
            g[0] += obj.untyped_storage().nbytes()
            g[1] += 1
            if len(g[2]) < 2:
                g[2].append(obj)
    mine = {id(groups)} | {id(g) for g in groups.values()} | {
        id(g[2]) for g in groups.values()}

    def owners(obj, depth):
        names = []
        for r in gc.get_referrers(obj):
            if id(r) in mine or type(r).__name__ == "frame":
                continue
            if isinstance(r, dict) and depth:
                names += ["%s.__dict__" % o for o in owners(r, depth - 1)]
            else:
                names.append(type(r).__name__)
        return names

    largest = sorted(groups.items(), key=lambda kv: -kv[1][0])[:top]
    tensors = [{"tensor": key, "bytes": nbytes, "count": count,
                "referrers": sorted(set(sum((owners(t, 1) for t in ts),
                                           [])))}
               for key, (nbytes, count, ts) in largest]
    allocated = torch.cuda.memory_allocated()
    live = sum(g[0] for g in groups.values())
    return {"allocated": allocated,
            "largest_blocks": blocks[:top],
            "live_cuda_tensor_bytes": live,
            "largest_tensors": tensors,
            "untracked_bytes": allocated - live}


def _lstm_check(what, cfg, cs, setups, fit_args=lstm_fit_args,
                ppl_tol=LSTM_PPL):
    """Fit the LSTM LM of each of the two ``setups`` (each returns a fresh
    (module, iterator, initializer)) for its ``cs`` batches with
    ``fit_args(cfg, init)``, and hold the first run against the second:
    after each batch, each parameter's update within LSTM_UPDATE and the
    perplexity within ``ppl_tol`` (LSTM_PPL); the initial weights equal.
    Raises naming ``what``; returns the record."""
    runs = []
    for setup in setups:
        mod, it, init = setup()
        batch = it.batch_size
        runs.append(_fit_recorded(mod, it, init, fit_args(cfg, init)))
        del mod
    (got_s, got_m), (ref_s, ref_m) = runs
    init_err = max(float(np.abs(got_s[0][0][n] - ref_s[0][0][n]).max())
                   for n in ref_s[0][0])
    upd = [_change_errs(got_s[0][0], got_s[b][0], ref_s[0][0], ref_s[b][0])
           for b in range(1, cs + 1)]
    ppl = [abs(g["Perplexity"] - r["Perplexity"]) / r["Perplexity"]
           for g, r in zip(got_m, ref_m)]
    failures = []
    if init_err != 0.0:
        failures.append("initial weights differ by %g" % init_err)
    for b, (u, p) in enumerate(zip(upd, ppl)):
        worst = max(u, key=u.get)
        if not u[worst] <= LSTM_UPDATE:
            failures.append("batch-%d update of %s off by %g (tol %g)"
                            % (b + 1, worst, u[worst], LSTM_UPDATE))
        if not p <= ppl_tol:
            failures.append("batch-%d perplexity off by %g (tol %g)"
                            % (b + 1, p, ppl_tol))
    if len(got_m) != cs or len(ref_m) != cs:
        failures.append("%d / %d batches recorded, want %d"
                        % (len(got_m), len(ref_m), cs))
    if failures:
        raise RuntimeError(what + ": " + "; ".join(failures))
    return {"batch": batch, "batches": cs, "metrics": got_m,
            "ref_metrics": ref_m, "perplexity_rel_err": ppl,
            "update_err": upd,
            "tol": {"update": LSTM_UPDATE, "perplexity": ppl_tol}}


def phase_lstm(cfg=LSTM_LM, device=None, ref_device="cpu", seed=SEED):
    """The LSTM LM through ``Module.fit`` and ``Module.score``. ``device``
    None = the card; the card-vs-reference check runs the same weights and
    batches on ``ref_device``, where lstm_step takes its plain version."""
    import torch
    from mxnet_tpu_torch import metric
    from mxnet_tpu_torch.ops.kernels import lstm as kl

    # 1. card vs the port's CPU path: same init, same 2 batches of 8
    cb, cs = cfg["check_batch"], cfg["check_steps"]
    check = _lstm_check(
        "lstm check", cfg, cs,
        [lambda dev=dev: lstm_setup(cfg, cb, cs, dev, seed)
         for dev in (device, ref_device)])

    # 2. the run: one epoch of `batches` batches of `batch` through the
    # captured fused step, then score
    on_card = device is None or torch.device(device).type == "cuda"

    def setup():
        return lstm_setup(cfg, cfg["batch"], cfg["batches"], device, seed)

    mod, it, init = setup()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    sync()
    if on_card:
        emit({"phase": "lstm_memory", "when": "before the peak reset",
              **memory_holders(torch)})
    start_memory = _reset_peak(torch) if on_card else None
    kl.lstm_step.launches = 0
    step_ms, first_ms, metrics = _fit_timed(
        torch, mod, it, lstm_fit_args(cfg, init), on_card)
    fit_launches = kl.lstm_step.launches
    stats = mod.fit_step_stats()
    state = _host_state(mod)
    kl.lstm_step.launches = 0
    t1 = time.perf_counter()
    score = dict(mod.score(it, metric.Perplexity(ignore_label=None)))
    sync()
    score_s = time.perf_counter() - t1
    score_launches = kl.lstm_step.launches
    memory = _peak(torch, on_card)
    steps = cfg["batches"]
    want = lstm_steps(cfg, steps)
    if fit_launches != want or score_launches != want:
        raise RuntimeError("lstm phase launched lstm_step %d times in fit "
                           "and %d in score, want %d each"
                           % (fit_launches, score_launches, want))
    ppl_run = [m["Perplexity"] for m in metrics]
    if len(metrics) != steps or not all(np.isfinite(ppl_run)) \
            or not np.isfinite(score["Perplexity"]):
        raise RuntimeError("lstm phase: %d batches, perplexity %s, score %s"
                           % (len(metrics), ppl_run, score))
    _require_captured("lstm", [stats], on_card)
    args = state[0]
    del mod
    eager = _eager_twin(torch, setup, lambda i: lstm_fit_args(cfg, i),
                        on_card, state, "lstm phase")
    median_ms = _steady_ms(step_ms, on_card)
    tokens = cfg["batch"] * cfg["seq"]
    result = {"phase": "lstm", "vocab": cfg["vocab"], "embed": cfg["embed"],
              "hidden": cfg["hidden"], "layers": cfg["layers"],
              "seq": cfg["seq"], "batch": cfg["batch"], "batches": steps,
              "dtype": "float32", "path": stats["path"], "steps": stats,
              "parameters": len(args),
              "elements": int(sum(a.size for a in args.values())),
              "check": check, "metrics": metrics,
              "score": score, "score_ms_per_batch": score_s * 1e3 / steps,
              "first_batch_ms": first_ms,
              "step_ms": step_ms, "median_step_ms": median_ms,
              "tokens_per_s": tokens / median_ms * 1e3,
              "eager": dict(eager, tokens_per_s=tokens
                            / eager["median_step_ms"] * 1e3),
              "captured_vs_eager": {"bit_for_bit": True},
              "launches": {"fit": fit_launches, "score": score_launches},
              **memory}
    if on_card:
        result["start_memory_allocated"] = start_memory
    emit(result)
    return {"fit": fit_launches, "score": score_launches}


def _check_summary(check, optimizer):
    """The part of an :func:`_lstm_check` record a zoo line keeps."""
    return {"optimizer": optimizer, "batch": check["batch"],
            "batches": check["batches"], "tol": check["tol"],
            "perplexity_rel_err": check["perplexity_rel_err"],
            "update_err_worst": [max(u.values()) for u in
                                 check["update_err"]],
            "metrics": check["metrics"]}


def _sgld_definition(cfg, device, seed):
    """SGLD on ``device`` held to its definition: one update at g = 0 and
    wd = 0 of a (vocab, embed) weight of zeros adds N(0, lr): mean and
    variance within 5 sigma; one seed twice the same, two seeds
    different."""
    from mxnet_tpu_torch import nd, optimizer
    from mxnet_tpu_torch import random as mrand

    lr, shape = cfg["sgld_lr"], (cfg["vocab"], cfg["embed"])

    def step(s):
        mrand.seed(s)
        w = nd.zeros(shape, ctx=device)
        optimizer.get_updater(optimizer.create("sgld", learning_rate=lr))(
            0, nd.zeros(shape, ctx=device), w)
        return w.asnumpy().astype(np.float64)

    a, b, c = step(seed), step(seed), step(seed + 1)
    mean, var, s_mean, s_var = zoo.sgld_moments(a.size, lr)
    z_mean, z_var = (a.mean() - mean) / s_mean, (a.var() - var) / s_var
    if abs(z_mean) > 5 or abs(z_var) > 5 or not np.array_equal(a, b) \
            or np.array_equal(a, c):
        raise RuntimeError(
            "zoo phase: SGLD's noise has mean %g (z %g), variance %g (z %g, "
            "want lr %g), seed repeats %s, seeds differ %s"
            % (a.mean(), z_mean, a.var(), z_var, lr, np.array_equal(a, b),
               not np.array_equal(a, c)))
    return {"elements": int(a.size), "lr": lr, "mean": float(a.mean()),
            "z_mean": float(z_mean), "variance": float(a.var()),
            "z_variance": float(z_var)}


def _zoo_counters():
    from mxnet_tpu_torch.ops.kernels import fused_update as fu
    from mxnet_tpu_torch.ops.kernels import lstm as kl

    return {"lstm_step": (kl.lstm_step,),
            "sgd_mom_update": (fu.sgd_mom_update,),
            "sgd_mom_update_lr": (fu.sgd_mom_update_lr,)}


def _launched(counters, before):
    now = _count(counters)
    return {k: now[k] - before[k] for k in now}


def _zoo_fit(torch, setup, kwargs, on_card, counters, want, what):
    """One ``Module.fit`` of ``setup()``'s module with ``kwargs`` (one
    epoch), its launches held to ``want`` exactly and every batch's
    perplexity finite; (record, host state)."""
    _fresh(torch, on_card)
    mod, it, init = setup()
    before = _count(counters)
    step_ms, first_ms, metrics = _fit_timed(torch, mod, it, kwargs(init),
                                            on_card)
    launches = _launched(counters, before)
    stats = mod.fit_step_stats() if hasattr(mod, "fit_step_stats") else {
        "path": "unfused", "reason": type(mod).__name__}
    state = _host_state(mod)
    memory = _peak(torch, on_card)
    del mod
    ppl = [m["Perplexity"] for m in metrics]
    if launches != want:
        raise RuntimeError("zoo phase: %s launched %s, want %s"
                           % (what, launches, want))
    if not metrics or not all(np.isfinite(ppl)):
        raise RuntimeError("zoo phase: %s perplexity %s" % (what, ppl))
    return {"path": stats["path"], "steps": stats, "metrics": metrics,
            "step_ms": step_ms, "first_batch_ms": first_ms,
            "launches": launches, **memory}, state


def _monitored_fit(cfg, device, seed, counters):
    """``Module.fit`` of ``monitor_batches`` batches at ``check_batch``
    with a ``Monitor(monitor_interval)`` (the default norm statistic):
    (each batch's ``toc`` reports, the fused step's stats, launches, the
    names a monitored batch must report)."""
    from mxnet_tpu_torch import Monitor

    mod, it, init = lstm_setup(cfg, cfg["check_batch"],
                               cfg["monitor_batches"], device, seed)
    mon = Monitor(cfg["monitor_interval"])
    reports, toc = [], mon.toc

    def recorded():
        out = toc()
        reports.append(out)
        return out

    mon.toc = recorded
    before = _count(counters)
    mod.fit(it, monitor=mon, **zoo.fit_args(cfg, init, "sgd"))
    names = (mod.symbol.get_internals().list_outputs()
             + mod.symbol.list_arguments())
    return reports, mod.fit_step_stats(), _launched(counters, before), names


def _monitor_checks(cfg, device, ref_device, seed, counters):
    """(4) Monitor: every matching internal output and argument reported
    on each monitored batch and none on the others, card = CPU within
    MONITOR_RTOL, the fused step off for "monitor install", and the
    monitored forwards' extra lstm_step launches exact."""
    got, stats, launches, names = _monitored_fit(cfg, device, seed,
                                                 counters)
    ref, _, _, _ = _monitored_fit(cfg, ref_device, seed, counters)
    batches, interval = cfg["monitor_batches"], cfg["monitor_interval"]
    monitored = [k for k in range(batches) if k % interval == 0]
    failures = []
    if stats.get("reason") != "monitor install":
        failures.append("the fused step's reason is %s" % stats)
    for k, (g, r) in enumerate(zip(got, ref)):
        if k not in monitored:
            if g:
                failures.append("batch %d (inactive) reported %d stats"
                                % (k, len(g)))
            continue
        if [x[1] for x in g] != names or [x[0] for x in g] != [k + 1] * len(
                names):
            failures.append("batch %d reported %s, want step %d and %s"
                            % (k, [x[:2] for x in g], k + 1, names))
            continue
        gv = np.array([float(x[2]) for x in g])
        rv = np.array([float(x[2]) for x in r])
        if not np.allclose(gv, rv, rtol=MONITOR_RTOL, atol=0.0):
            bad = int(np.argmax(np.abs(gv - rv) / np.maximum(np.abs(rv),
                                                             1e-30)))
            failures.append("batch %d: %s = %r on the card, %r on the CPU"
                            % (k, names[bad], gv[bad], rv[bad]))
    want = lstm_steps(cfg, batches + len(monitored))
    if len(got) != batches or launches["lstm_step"] != want:
        failures.append("%d reports, %d lstm_step launches (want %d, %d)"
                        % (len(got), launches["lstm_step"], batches, want))
    if failures:
        raise RuntimeError("zoo phase monitor: " + "; ".join(failures))
    return {"interval": interval, "batches": batches,
            "monitored_batches": monitored, "stats_a_batch": len(names),
            "steps": stats, "launches": launches,
            "stats": {n: float(x[2]) for n, x in zip(names, got[0])},
            "rtol": MONITOR_RTOL}


def _feedforward_checks(torch, cfg, device, ref_device, seed):
    """(5) FeedForward: fit ``feedforward_batches`` batches, predict and
    score, card against the CPU; then save, load and predict again on the
    card, bit for bit."""
    import tempfile

    from mxnet_tpu_torch import FeedForward, initializer, io, metric
    from mxnet_tpu_torch.tools.lstm_lm import lstm_data, lstm_symbol

    batch = cfg["check_batch"]
    x, y = lstm_data(cfg, batch, cfg["feedforward_batches"], seed + 1)
    _, params = zoo.optimizer_run("sgd")

    def labelled():
        # the labels' shape must be bound: the symbol reshapes them
        return io.NDArrayIter(x, y, batch_size=batch)

    out = {}
    for dev in (device, ref_device):
        ff = FeedForward(lstm_symbol(cfg), ctx=dev, num_epoch=1,
                         initializer=initializer.Xavier(
                             rng=np.random.RandomState(seed)),
                         numpy_batch_size=batch, **params)
        ff.fit(x, y, eval_metric=metric.Perplexity(ignore_label=None))
        out[dev] = (ff, ff.predict(labelled()),
                    ff.score(x, y, eval_metric=metric.Perplexity(
                        ignore_label=None)))
    (ff, pred, score), (_, ref_pred, ref_score) = out[device], out[
        ref_device]
    pred_err = change_err(pred, ref_pred)
    score_err = abs(score - ref_score) / ref_score
    work = tempfile.mkdtemp(prefix="zoo-feedforward-")
    try:
        ff.save(os.path.join(work, "ff"), 1)
        loaded = FeedForward.load(os.path.join(work, "ff"), 1, ctx=device,
                                  numpy_batch_size=batch)
        again = loaded.predict(labelled())
        files = sorted(os.listdir(work))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    failures = []
    if not pred_err <= LSTM_UPDATE or not score_err <= LSTM_PPL:
        failures.append("predict %g from the CPU's (tol %g), score %g (tol "
                        "%g)" % (pred_err, LSTM_UPDATE, score_err, LSTM_PPL))
    if not np.array_equal(again, pred):
        failures.append("predict after save / load differs by %g"
                        % float(np.abs(again - pred).max()))
    if failures:
        raise RuntimeError("zoo phase FeedForward: " + "; ".join(failures))
    return {"batches": cfg["feedforward_batches"], "batch": batch,
            "predict_shape": list(pred.shape), "predict_rel_err": pred_err,
            "score": score, "score_rel_err": score_err,
            "save_load_predict_bit_for_bit": True, "files": files}


def _zoo_small_parts(device, ref_device, seed):
    """(6) The new initializers, ops and metrics on ``device`` against
    ``ref_device``: initializers, clip, sign, moveaxis and onehot_encode
    bit for bit; norm within NORM_RTOL (its sums in another order); F1,
    MAE, MSE and RMSE equal."""
    from mxnet_tpu_torch import initializer, metric, nd
    from mxnet_tpu_torch.initializer import InitDesc

    rng = np.random.RandomState(seed + 60)
    x = rng.uniform(-2, 2, (64, 33, 17)).astype(np.float32)
    ids = rng.randint(0, 40, 300).astype(np.float32)
    saved = {"arg:w_weight": nd.array(x[:8, :5, 0], ctx="cpu")}
    inits = {
        "Orthogonal": (lambda: initializer.Orthogonal(
            rng=np.random.RandomState(seed)), "fc_weight", (64, 48)),
        "Orthogonal_normal": (lambda: initializer.Orthogonal(
            rand_type="normal", rng=np.random.RandomState(seed)),
            "fc_weight", (32, 3, 4, 4)),
        "MSRAPrelu": (lambda: initializer.MSRAPrelu(
            rng=np.random.RandomState(seed)), "conv_weight", (16, 8, 3, 3)),
        "Bilinear": (lambda: initializer.Bilinear(), "up_weight",
                     (4, 1, 8, 8)),
        "Mixed": (lambda: initializer.Mixed(
            [".*bias", ".*"], [initializer.Constant(0.5),
                               initializer.Uniform(
                                   rng=np.random.RandomState(seed))]),
            "fc_weight", (20, 10)),
        "Load": (lambda: initializer.Load(saved), "w_weight", (8, 5)),
    }
    out, failures = {}, []
    for name, (make, pname, shape) in inits.items():
        got, want = (nd.zeros(shape, ctx=d) for d in (device, ref_device))
        make()(InitDesc(pname), got)
        make()(InitDesc(pname), want)
        if not np.array_equal(got.asnumpy(), want.asnumpy()):
            failures.append("initializer %s" % name)
        out[name] = list(shape)
    ops = {
        "clip": lambda d: nd.clip(nd.array(x, ctx=d), a_min=-0.5,
                                  a_max=0.75),
        "sign": lambda d: nd.sign(nd.array(x, ctx=d)),
        "moveaxis": lambda d: nd.moveaxis(nd.array(x, ctx=d), 0, 2),
        "onehot_encode": lambda d: nd.onehot_encode(
            nd.array(ids, ctx=d), nd.zeros((300, 40), ctx=d)),
    }
    for name, fn in ops.items():
        if not np.array_equal(fn(device).asnumpy(), fn(ref_device).asnumpy()):
            failures.append("op %s" % name)
        out[name] = "bit for bit"
    norms = {}
    for axis in (None, 1, (0, 2)):
        for ord_ in (1, 2):
            got = nd.norm(nd.array(x, ctx=device), ord=ord_,
                          axis=axis).asnumpy()
            want = nd.norm(nd.array(x, ctx=ref_device), ord=ord_,
                           axis=axis).asnumpy()
            err = float(np.max(np.abs(got - want) / np.abs(want)))
            norms["ord%d axis %s" % (ord_, axis)] = err
            if not err <= NORM_RTOL:
                failures.append("norm ord %d axis %s off by %g"
                                % (ord_, axis, err))
    out["norm_rel_err"] = norms
    pred2 = rng.uniform(0, 1, (50, 2)).astype(np.float32)
    lab2 = rng.randint(0, 2, 50).astype(np.float32)
    reg = rng.uniform(-1, 1, (50, 1)).astype(np.float32)
    lab_reg = rng.uniform(-1, 1, 50).astype(np.float32)
    metrics = {}
    for name, (lab, pred) in (("f1", (lab2, pred2)), ("mae", (lab_reg, reg)),
                              ("mse", (lab_reg, reg)),
                              ("rmse", (lab_reg, reg))):
        vals = []
        for d in (device, ref_device):
            m = metric.create(name)
            m.update([nd.array(lab, ctx=d)], [nd.array(pred, ctx=d)])
            vals.append(float(m.get()[1]))
        if vals[0] != vals[1]:
            failures.append("metric %s %r against %r" % (name, *vals))
        metrics[name] = vals[0]
    out["metrics"] = metrics
    if failures:
        raise RuntimeError("zoo phase small parts differ on the card: "
                           + ", ".join(failures))
    return out


def phase_zoo(cfg=ZOO, device=None, ref_device="cpu", seed=SEED):
    """The rest of training on the card (``tools/zoo.py``): the LSTM LM
    under every optimizer of the reference's registry. (1) Card against
    ``ref_device`` (2 batches of ``check_batch``) at the lstm gates for
    every optimizer but SGLD, which is held to its definition instead; (2)
    the full-width run, ``batches`` batches of ``batch`` through
    ``Module.fit``: the pure-rule optimizers through the captured fused
    step, each against its eager twin bit for bit, the others through the
    Updater ("has no pure rule"), each fit exactly 560 ``lstm_step``
    launches and ccSGD's ``sgd_mom_update_lr`` launches the parameters x
    batches; (3) ``SequentialModule`` (body + head) equal to the single
    Module, its run, and the ``PythonLossModule`` head against the CPU;
    (4) ``Monitor``; (5) ``FeedForward``; (6) the initializers, ops and
    metrics. ``device`` None = the card. Returns the launches of (2)-(5)."""
    import torch
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch import optimizer as mopt
    from mxnet_tpu_torch.executor import CAPTURE_WARMUP
    from mxnet_tpu_torch.tools.lstm_lm import lstm_symbol

    on_card = device is None or torch.device(device).type == "cuda"
    card = nvidia_smi() if on_card else None
    cb, cs = cfg["check_batch"], cfg["check_steps"]

    def module_setup(dev, batch, batches):
        return lambda: lstm_setup(cfg, batch, batches, dev, seed)

    def chain_setup(dev, batch, batches, loss=False):
        def setup():
            mod = zoo.chain(cfg, dev, loss=loss)
            it = zoo.zoo_iter(cfg, batch, batches, seed + 1)
            init = initializer.Xavier(rng=np.random.RandomState(seed))
            mod.bind(it.provide_data, it.provide_label)
            mod.init_params(init)
            return mod, it, init
        return setup

    # 1. card vs the port's CPU path, each optimizer
    t0 = time.perf_counter()
    checks = {}
    for run, name, params in zoo.OPTIMIZERS:
        if run == "sgld":
            continue
        check = _lstm_check(
            "zoo check %s" % run, cfg, cs,
            [module_setup(dev, cb, cs) for dev in (device, ref_device)],
            fit_args=lambda c, i, run=run: zoo.fit_args(c, i, run),
            ppl_tol=zoo_ppl_tol(run))
        checks[run] = _check_summary(check, dict(params, name=name))
    checks["sgld"] = {"optimizer": dict(zoo.optimizer_run("sgld")[1],
                                        name="sgld"),
                      "definition": _sgld_definition(cfg, device, seed)}
    check_s = time.perf_counter() - t0

    # 2. the full-width runs: the main path from here to (5)
    counters = _zoo_counters()
    _zero(counters)
    t1 = time.perf_counter()
    steps, per_fit = cfg["batches"], lstm_steps(cfg, cfg["batches"])
    n_params = len(lstm_symbol(cfg).list_arguments()) - 2  # data, label
    runs = {}
    for run in zoo.CAPTURED + zoo.UPDATER:
        name, params = zoo.optimizer_run(run)
        setup = module_setup(device, cfg["batch"], steps)

        def kwargs(init, run=run):
            return zoo.fit_args(cfg, init, run)

        want = {"lstm_step": per_fit, "sgd_mom_update": 0,
                "sgd_mom_update_lr": n_params * steps if run == "ccsgd"
                else 0}
        rec, state = _zoo_fit(torch, setup, kwargs, on_card, counters, want,
                              run)
        rec["optimizer"] = dict(params, name=name)
        st = rec["steps"]
        if run in zoo.CAPTURED:
            if st["path"] == "unfused":
                raise RuntimeError("zoo phase: %s has a pure rule but took "
                                   "the Updater path (%s)" % (run, st))
            _require_captured("zoo %s" % run, [st], on_card)
            before = _count(counters)
            eager = _eager_twin(torch, setup, kwargs, on_card, state,
                                "zoo %s" % run)
            eager["launches"] = _launched(counters, before)
            if eager["launches"] != want:
                raise RuntimeError("zoo phase: %s's eager twin launched %s, "
                                   "want %s" % (run, eager["launches"],
                                                want))
            rec["eager"] = eager
            rec["captured_vs_eager"] = {"bit_for_bit": True}
            rec["median_step_ms"] = _steady_ms(rec["step_ms"], on_card)
        else:
            reason = "%s has no pure rule" % type(mopt.create(name)).__name__
            if st != {"path": "unfused", "reason": reason}:
                raise RuntimeError("zoo phase: %s took %s, want the "
                                   "Updater path for %r" % (run, st, reason))
            rec["median_step_ms"] = float(np.median(rec["step_ms"]))
        runs[run] = rec
        emit({"phase": "zoo_step", "optimizer": run, "path": st["path"],
              "median_step_ms": rec["median_step_ms"],
              "eager_median_step_ms": rec.get("eager", {}).get(
                  "median_step_ms"),
              "max_memory_allocated": rec.get("max_memory_allocated"),
              "card": card})
    run_s = time.perf_counter() - t1

    # 3. SequentialModule: the chain against the single Module, its run,
    # the PythonLossModule head against the CPU
    chain_check = _lstm_check(
        "zoo SequentialModule vs Module", cfg, cs,
        [chain_setup(device, cb, cs), module_setup(device, cb, cs)],
        fit_args=lambda c, i: zoo.fit_args(c, i, "sgd", batch=cb))
    chain_run, _ = _zoo_fit(
        torch, chain_setup(device, cfg["batch"], steps),
        lambda i: zoo.fit_args(cfg, i, "sgd", batch=cfg["batch"]),
        on_card, counters, {"lstm_step": per_fit,
                            "sgd_mom_update": n_params * steps,
                            "sgd_mom_update_lr": 0}, "the SequentialModule")
    chain_run["median_step_ms"] = float(np.median(chain_run["step_ms"]))
    loss_check = _lstm_check(
        "zoo PythonLossModule chain", cfg, cs,
        [chain_setup(dev, cb, cs, loss=True) for dev in (device,
                                                          ref_device)],
        fit_args=lambda c, i: zoo.fit_args(c, i, "sgd", batch=cb,
                                           metric=zoo.logit_perplexity()))

    # 4. Monitor; 5. FeedForward
    monitor = _monitor_checks(cfg, device, ref_device, seed, counters)
    feedforward = _feedforward_checks(torch, cfg, device, ref_device, seed)
    launches = _count(counters)
    # 6. the small parts
    small = _zoo_small_parts(device, ref_device, seed)
    if not launches["lstm_step"] or not launches["sgd_mom_update_lr"]:
        raise RuntimeError("zoo phase launched %s" % launches)
    result = {"phase": "zoo", "vocab": cfg["vocab"], "embed": cfg["embed"],
              "hidden": cfg["hidden"], "layers": cfg["layers"],
              "seq": cfg["seq"], "batch": cfg["batch"], "batches": steps,
              "dtype": "float32", "capture_warmup": CAPTURE_WARMUP,
              "checks": checks, "check_s": check_s, "runs": runs,
              "run_s": run_s,
              "sequential": {"vs_module": _check_summary(chain_check,
                                                         "sgd"),
                             "run": chain_run,
                             "python_loss_vs_cpu": _check_summary(
                                 loss_check, "sgd")},
              "monitor": monitor, "feedforward": feedforward,
              "small_parts": small, "launches": launches}
    emit(result)
    return launches


def _seq_deterministic(torch, device, ref_device, seed):
    """(c) The deterministic ops on ``device`` against ``ref_device``, bit
    for bit: ``_arange`` (with ``repeat``), ``_eye``, ``_full``,
    ``zeros_like`` and the three sequence ops with lengths on seeded
    (T, B, C) data."""
    from mxnet_tpu_torch import nd

    rng = np.random.RandomState(seed + 50)
    x = rng.uniform(-1, 1, (35, 16, 64)).astype(np.float32)
    lens = rng.randint(0, 36, 16).astype(np.float32)
    cases = {
        "_arange": lambda ctx: nd._arange(start=-3, stop=7, step=0.25,
                                          repeat=3, ctx=ctx),
        "_eye": lambda ctx: nd._eye(N=300, M=200, k=-7, ctx=ctx),
        "_full": lambda ctx: nd._full(shape=(64, 1000), value=0.1, ctx=ctx),
        "zeros_like": lambda ctx: nd.zeros_like(nd.array(x, ctx=ctx)),
    }
    for op in ("SequenceReverse", "SequenceMask", "SequenceLast"):
        cases[op] = lambda ctx, op=op: getattr(nd, op)(
            nd.array(x, ctx=ctx), nd.array(lens, ctx=ctx),
            use_sequence_length=True)
    out = {}
    for name, make in cases.items():
        got, want = make(device).asnumpy(), make(ref_device).asnumpy()
        if got.shape != want.shape or not np.array_equal(got, want):
            raise RuntimeError("seq phase: %s on the card differs from the "
                               "CPU's" % name)
        out[name] = list(got.shape)
    return out


def _seq_random(torch, cfg, device, seed):
    """(d) Each sampling op at ``random_elements`` elements on ``device``:
    mean and variance within 5 sigma of its distribution's, one seed
    drawing twice the same values, two seeds different ones."""
    from mxnet_tpu_torch import nd, random

    n = cfg["random_elements"]
    out = {}
    for name, attrs in RANDOM_OPS:
        def draw(s):
            random.seed(s)
            return getattr(nd, name)(shape=(n,), ctx=device,
                                     **attrs).asnumpy()

        a, b, c = draw(seed), draw(seed), draw(seed + 1)
        mean, var, m4 = moments(name, attrs)
        d = a.astype(np.float64)
        z_mean = (d.mean() - mean) / np.sqrt(var / n)
        z_var = (d.var() - var) / np.sqrt((m4 - var * var) / n)
        if abs(z_mean) > 5 or abs(z_var) > 5 or not np.array_equal(a, b) \
                or np.array_equal(a, c) or a.dtype != np.float32:
            raise RuntimeError(
                "seq phase: %s drew mean %g (z %g), variance %g (z %g), "
                "seed repeats %s, seeds differ %s" % (
                    name, d.mean(), z_mean, d.var(), z_var,
                    np.array_equal(a, b), not np.array_equal(a, c)))
        out[name] = {"mean": float(d.mean()), "want_mean": mean,
                     "z_mean": float(z_mean), "variance": float(d.var()),
                     "want_variance": var, "z_variance": float(z_var)}
    return out


def phase_seq(cfg=SEQ, device=None, ref_device="cpu", seed=SEED):
    """The sequence ops, the schedulers and the sampling ops on the card:
    the sequence classifier of ``tools/seq_classify.py`` (the LSTM LM's
    body under SequenceMask -> SequenceLast -> FullyConnected ->
    SoftmaxOutput) through ``Module.fit`` with SGD momentum under
    ``FactorScheduler``: (a) card against ``ref_device`` at the lstm
    phase's gates; (b) ``batches`` batches through the captured fused
    ``fit_step`` with exact ``lstm_step`` launches, each step's lr (read
    from the step's own buffer) the schedule's, and the same run eager
    landing on the same parameters bit for bit; (c) the deterministic ops
    bit for bit against the CPU; (d) the sampling ops' moments and seeds.
    ``device`` None = the card. Returns the fit's lstm_step launches."""
    import torch
    from mxnet_tpu_torch.ops.kernels import lstm as kl

    on_card = device is None or torch.device(device).type == "cuda"
    cb, cs = cfg["check_batch"], cfg["check_steps"]
    check = _lstm_check(
        "seq check", cfg, cs,
        [lambda dev=dev: seq_setup(cfg, cb, cs, dev, seed)
         for dev in (device, ref_device)], fit_args=seq_fit_args)

    def setup():
        return seq_setup(cfg, cfg["batch"], cfg["batches"], device, seed)

    _fresh(torch, on_card)
    mod, it, init = setup()
    lrs = []

    def read_lr(param):
        # the lr the step's graph reads: its own buffer, copied in from
        # the value the schedule gave this step
        lrs.append(float(mod._fused_fit["step"]._extra[0][0]))

    kl.lstm_step.launches = 0
    step_ms, first_ms, metrics = _fit_timed(
        torch, mod, it, seq_fit_args(cfg, init), on_card, also=read_lr)
    launches = kl.lstm_step.launches
    stats = mod.fit_step_stats()
    state = _host_state(mod)
    memory = _peak(torch, on_card)
    del mod
    steps = cfg["batches"]
    want_lrs = [float(np.float32(x)) for x in lr_sequence(cfg, steps)]
    failures = []
    if launches != lstm_steps(cfg, steps):
        failures.append("launched lstm_step %d times, want %d" % (
            launches, lstm_steps(cfg, steps)))
    if lrs != want_lrs:
        failures.append("the steps read lr %s, the schedule gives %s"
                        % (lrs, want_lrs))
    ppl = [m["Perplexity"] for m in metrics]
    if len(metrics) != steps or not all(np.isfinite(ppl)):
        failures.append("%d batches, perplexity %s" % (len(metrics), ppl))
    if failures:
        raise RuntimeError("seq phase: " + "; ".join(failures))
    _require_captured("seq", [stats], on_card)
    eager = _eager_twin(torch, setup, lambda i: seq_fit_args(cfg, i),
                        on_card, state, "seq phase")
    deterministic = _seq_deterministic(torch, device, ref_device, seed)
    sampled = _seq_random(torch, cfg, device, seed)
    median_ms = _steady_ms(step_ms, on_card)
    result = {"phase": "seq", "vocab": cfg["vocab"], "embed": cfg["embed"],
              "hidden": cfg["hidden"], "layers": cfg["layers"],
              "seq": cfg["seq"], "classes": cfg["classes"],
              "batch": cfg["batch"], "batches": steps, "dtype": "float32",
              "path": stats["path"], "steps": stats, "check": check,
              "metrics": metrics, "lr": lrs, "first_batch_ms": first_ms,
              "step_ms": step_ms, "median_step_ms": median_ms,
              "sequences_per_s": cfg["batch"] / median_ms * 1e3,
              "eager": eager, "captured_vs_eager": {"bit_for_bit": True},
              "launches": {"fit": launches},
              "deterministic_bit_for_bit": deterministic,
              "random": sampled, **memory}
    emit(result)
    return launches


def phase_custom(cfg=LSTM_LM, device=None, ref_device="cpu", seed=SEED):
    """The LSTM LM with its SoftmaxOutput head replaced by the Custom
    ``rtc_softmax`` head (forward and backward rtc kernels) through
    ``Module.fit`` and ``Module.score``: (a) card against the port's CPU
    path (the twins) at the lstm check's size; (b) the rtc head against the
    built-in SoftmaxOutput head on ``device``, same weights and batches, at
    the run's batch; (c) the run, with exact launch counts of both rtc
    kernels and lstm_step. ``device`` None = the card."""
    import torch
    from mxnet_tpu_torch import metric
    from mxnet_tpu_torch.ops.kernels import lstm as kl
    from mxnet_tpu_torch.tools import rtc_softmax as rs

    cb, cs = cfg["check_batch"], cfg["check_steps"]
    b = cfg["batch"]

    def rtc_setup(dev, batch, batches):
        return lambda: lstm_setup(cfg, batch, batches, dev, seed,
                                  symbol=rs.lstm_rtc_symbol(cfg))

    # (a) card vs the port's CPU path: same init, same 2 batches of 8
    check_cpu = _lstm_check("custom check (a), card vs CPU", cfg, cs,
                            [rtc_setup(device, cb, cs),
                             rtc_setup(ref_device, cb, cs)])
    # (b) the rtc head vs SoftmaxOutput on the card: 2 batches of 128
    check_head = _lstm_check(
        "custom check (b), rtc head vs SoftmaxOutput", cfg, cs,
        [rtc_setup(device, b, cs),
         lambda: lstm_setup(cfg, b, cs, device, seed)])

    # (c) the run: one epoch of `batches` batches of `batch` through the
    # captured fused step, then score
    on_card = device is None or torch.device(device).type == "cuda"
    setup = rtc_setup(device, b, cfg["batches"])
    mod, it, init = setup()
    kern = rs.kernels(cfg["vocab"])
    bwd = [kern[k] for k in ("bwd", "bwd_vec") if k in kern]
    counters = [kern["fwd"], kl.lstm_step] + bwd

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def counts():
        """Launches by kernel; "bwd" sums the backward's two sources."""
        return {"fwd": kern["fwd"].launches,
                "bwd": sum(c.launches for c in bwd),
                "lstm_step": kl.lstm_step.launches}

    sync()
    start_memory = _reset_peak(torch) if on_card else None
    for c in counters:
        c.launches = 0
    step_ms, first_ms, metrics = _fit_timed(
        torch, mod, it, lstm_fit_args(cfg, init), on_card)
    fit_launches = counts()
    fit_vector = kern["bwd_vec"].launches if "bwd_vec" in kern else 0
    stats = mod.fit_step_stats()
    state = _host_state(mod)
    for c in counters:
        c.launches = 0
    t1 = time.perf_counter()
    score = dict(mod.score(it, metric.Perplexity(ignore_label=None)))
    sync()
    score_s = time.perf_counter() - t1
    score_launches = counts()
    memory = _peak(torch, on_card)
    steps = cfg["batches"]
    want_fit = {"fwd": steps, "bwd": steps,
                "lstm_step": lstm_steps(cfg, steps)}
    want_score = dict(want_fit, bwd=0)
    if fit_launches != want_fit or score_launches != want_score:
        raise RuntimeError("custom phase launched %s in fit and %s in "
                           "score, want %s and %s"
                           % (fit_launches, score_launches, want_fit,
                              want_score))
    if on_card and "bwd_vec" in kern and fit_vector != steps:
        raise RuntimeError("custom phase: %d of %d backward launches took "
                           "the vector source" % (fit_vector, steps))
    ppl_run = [m["Perplexity"] for m in metrics]
    if len(metrics) != steps or not all(np.isfinite(ppl_run)) \
            or not np.isfinite(score["Perplexity"]):
        raise RuntimeError("custom phase: %d batches, perplexity %s, score "
                           "%s" % (len(metrics), ppl_run, score))
    _require_captured("custom", [stats], on_card)
    del mod
    eager = _eager_twin(torch, setup, lambda i: lstm_fit_args(cfg, i),
                        on_card, state, "custom phase")
    median_ms = _steady_ms(step_ms, on_card)
    tokens = b * cfg["seq"]
    result = {"phase": "custom", "head": "Custom(op_type=rtc_softmax)",
              "vocab": cfg["vocab"], "embed": cfg["embed"],
              "hidden": cfg["hidden"], "layers": cfg["layers"],
              "seq": cfg["seq"], "batch": b, "batches": steps,
              "dtype": "float32", "path": stats["path"], "steps": stats,
              "check_vs_cpu": check_cpu,
              "check_vs_softmax_output": check_head, "metrics": metrics,
              "score": score, "score_ms_per_batch": score_s * 1e3 / steps,
              "first_batch_ms": first_ms,
              "step_ms": step_ms, "median_step_ms": median_ms,
              "tokens_per_s": tokens / median_ms * 1e3,
              "eager": dict(eager, tokens_per_s=tokens
                            / eager["median_step_ms"] * 1e3),
              "captured_vs_eager": {"bit_for_bit": True},
              "launches": {"fit": fit_launches, "score": score_launches},
              "bwd_vector_launches": fit_vector, **memory}
    if on_card:
        result["start_memory_allocated"] = start_memory
    emit(result)
    return {"fit": fit_launches, "score": score_launches}


def _bucket_fit(torch, mod, it, kwargs, on_card):
    """``mod.fit(it, **kwargs)`` with a synchronized time and the bucket
    and metric after each batch: (ms from each batch's end to the next's,
    the first batch's ms, bucket keys, metrics)."""
    times, keys, metrics = [], [], []

    def record(param):
        if on_card:
            torch.cuda.synchronize()
        times.append(time.perf_counter())
        keys.append(param.locals["data_batch"].bucket_key)
        metrics.append({k: float(v) for k, v in
                        param.eval_metric.get_name_value()})

    t0 = time.perf_counter()
    mod.fit(it, batch_end_callback=record, **kwargs)
    return ([(b - a) * 1e3 for a, b in zip(times, times[1:])],
            (times[0] - t0) * 1e3, keys, metrics)


def _by_bucket(step_ms, keys, batch):
    """Per bucket: the median eager step ms over its batches after its
    first (which binds the bucket's executor), and the tokens (padded)
    a second over the same batches."""
    seen, ms = set([keys[0]]), {}
    for key, t in zip(keys[1:], step_ms):
        if key in seen:
            ms.setdefault(key, []).append(t)
        seen.add(key)
    out = {str(k): {"median_ms": float(np.median(v)), "batches": len(v)}
           for k, v in sorted(ms.items())}
    tokens = sum(batch * k * len(v) for k, v in ms.items())
    total = sum(sum(v) for v in ms.values())
    return out, (tokens / total * 1e3 if total else None)


def _bucket_dropout_checks(torch, cfg, mod, batch, device, seed):
    """On ``device``: the LM's eval output at p = cfg["dropout"] equals the
    p = 0 output bit for bit on the same weights and batch; two training
    forwards after the same seed are equal and after another seed differ;
    the Dropout op over cfg["mask_elements"] elements keeps a share within
    5 sigma of 1 - p, each kept entry exactly x / (1 - p)."""
    from mxnet_tpu_torch import ndarray as nd
    from mxnet_tpu_torch import random as mrand
    from mxnet_tpu_torch.module import Module

    p = cfg["dropout"]
    args, aux = mod.get_params()
    key = batch.bucket_key
    outs = {}
    for drop in (p, 0.0):
        m = Module(lb.lm_symbol(cfg, key, drop), context=device)
        m.bind(batch.provide_data, batch.provide_label)
        m.init_params(arg_params=args, aux_params=aux)
        m.forward(batch, is_train=False)
        outs[drop] = m.get_outputs()[0].asnumpy()
        if drop:
            train = []
            for s in (seed, seed, seed + 1):
                mrand.seed(s)
                m.forward(batch, is_train=True)
                train.append(m.get_outputs()[0].asnumpy())
        del m
    failures = []
    if not np.array_equal(outs[p], outs[0.0]):
        failures.append("eval output at p = %g differs from p = 0" % p)
    if not np.array_equal(train[0], train[1]):
        failures.append("two training forwards after one seed differ")
    if np.array_equal(train[0], train[2]):
        failures.append("training forwards after two seeds are equal")
    n = cfg["mask_elements"]
    x = nd.array(np.random.RandomState(seed).uniform(
        0.5, 2.0, n).astype(np.float32), ctx=device)
    y = nd.Dropout(x, p=p, mode="always")
    kept = y._data != 0
    share = float(kept.float().mean())
    sigma = math.sqrt(p * (1 - p) / n)
    exact = bool(torch.equal(y._data[kept], (x._data / (1 - p))[kept]))
    if not abs(share - (1 - p)) <= 5 * sigma:
        failures.append("Dropout kept %.6f of %d, want %g +- %g"
                        % (share, n, 1 - p, 5 * sigma))
    if not exact:
        failures.append("a kept entry differs from x / (1 - p)")
    if failures:
        raise RuntimeError("bucketing dropout: " + "; ".join(failures))
    return {"eval_equals_p0": True, "same_seed_equal": True,
            "other_seed_differs": True, "bucket": key,
            "mask": {"elements": n, "kept_share": share,
                     "want": 1 - p, "five_sigma": 5 * sigma,
                     "kept_exact": exact}}


def _bucket_capture(torch, cfg, device, seed, on_card):
    """The LM at seq cfg["capture_seq"] with dropout through ``Module.fit``
    for cfg["capture_batches"] batches of cfg["batch"]: the fused step
    (captured on the card) against the same run eager, bit for bit; then
    two more steps on one batch from the same parameters, whose outputs
    must differ (the masks are drawn anew at each replay)."""
    from mxnet_tpu_torch import random as mrand
    from mxnet_tpu_torch.ops.kernels import fused_update as fu
    from mxnet_tpu_torch.ops.kernels import lstm as kl

    lcfg = dict(LSTM_LM, seq=cfg["capture_seq"], vocab=cfg["vocab"],
                embed=cfg["embed"], hidden=cfg["hidden"],
                layers=cfg["layers"])
    steps = cfg["capture_batches"]
    sym = lb.lm_symbol(cfg, lcfg["seq"], cfg["dropout"])

    def setup():
        made = lstm_setup(lcfg, cfg["batch"], steps, device, seed, symbol=sym)
        mrand.seed(seed + 5)
        return made

    mod, it, init = setup()
    counters = {"lstm_step": (kl.lstm_step,),
                "sgd_mom_update_lr": (fu.sgd_mom_update_lr,)}
    _zero(counters)
    step_ms, first_ms, metrics = _fit_timed(
        torch, mod, it, lb.fit_args(cfg, init), on_card)
    launches = _count(counters)
    stats = mod.fit_step_stats()
    state = _host_state(mod)
    _require_captured("bucketing capture", [stats], on_card)
    want = {"lstm_step": lstm_steps(lcfg, steps),
            "sgd_mom_update_lr": len(state[0]) * steps}
    if launches["lstm_step"] != want["lstm_step"] or (
            on_card and launches != want):
        raise RuntimeError("bucketing capture launched %s, want %s"
                           % (launches, want))
    # two steps on one batch from the same parameters: fresh masks
    it.reset()
    batch = next(iter(it))
    args, aux = mod.get_params()
    outs = []
    for _ in range(2):
        mod.set_params(args, aux)
        mod.fit_step(batch)
        outs.append(mod.get_outputs()[0].asnumpy())
    after = mod.fit_step_stats()
    if on_card and (after["captures"] != 1
                    or after["replays"] != stats["replays"] + 2):
        raise RuntimeError("bucketing capture: the two extra steps were not "
                           "replays of the one graph: %s" % after)
    if np.array_equal(outs[0], outs[1]):
        raise RuntimeError("bucketing capture: two steps on one batch give "
                           "the same output (the masks repeat)")
    del mod
    eager = _eager_twin(torch, setup, lambda i: lb.fit_args(cfg, i),
                        on_card, state, "bucketing capture")
    return {"seq": lcfg["seq"], "batch": cfg["batch"], "batches": steps,
            "dropout": cfg["dropout"], "path": stats["path"],
            "steps": stats, "after_two_more": after, "metrics": metrics,
            "step_ms": step_ms, "median_step_ms": _steady_ms(step_ms,
                                                             on_card),
            "first_batch_ms": first_ms, "launches": launches,
            "captured_vs_eager": {"bit_for_bit": True},
            "replays_differ": True, "eager": eager}


def phase_bucketing(cfg=BUCKETING, device=None, ref_device="cpu",
                    seed=SEED):
    """The bucketed LSTM LM through ``BucketingModule`` (``tools/
    lstm_bucketing.py``): (1) card vs the port's CPU path at p = 0,
    cfg["check_batch"] a batch over the buckets cfg["check_keys"]; (2) the
    run: one epoch of ``BucketSentenceIter`` at p = cfg["dropout"] with
    ``do_checkpoint`` and ``module_checkpoint(save_optimizer_states=True)``
    at its end, then ``score``, with exact lstm_step (f32) and sgd_mom_update
    launches; (3) the resume: a fresh BucketingModule from the checkpoint
    and its states and the uninterrupted module, each after the same seed,
    over batches of the buckets cfg["resume_keys"], bit for bit; (4)
    dropout on ``device`` (:func:`_bucket_dropout_checks`); (5) dropout in the
    captured step (:func:`_bucket_capture`). ``device`` None = the card."""
    import shutil
    import tempfile

    import torch
    from mxnet_tpu_torch import callback, metric, model
    from mxnet_tpu_torch import random as mrand
    from mxnet_tpu_torch.ops.kernels import fused_update as fu
    from mxnet_tpu_torch.ops.kernels import lstm as kl

    on_card = device is None or torch.device(device).type == "cuda"
    top = max(cfg["buckets"])

    # 1. card vs the port's CPU path, no dropout: the generators differ
    cb, keys = cfg["check_batch"], cfg["check_keys"]

    def check_setup(dev):
        def setup():
            mod, init = lb.bucketing_module(cfg, dev, 0.0, cb, seed)
            return mod, lb.pick_batches(lb.bucket_iter(cfg, cb, seed + 1),
                                        keys), init
        return setup

    check = _lstm_check("bucketing check, card vs CPU at p = 0", cfg,
                        len(keys), [check_setup(device),
                                    check_setup(ref_device)],
                        fit_args=lb.fit_args)
    check["buckets"] = list(keys)

    # 2. the run
    def sync():
        if on_card:
            torch.cuda.synchronize()

    work = tempfile.mkdtemp(prefix="bucketing-")
    try:
        batch = cfg["batch"]
        mod, init = lb.bucketing_module(cfg, device, cfg["dropout"], batch,
                                        seed)
        it = lb.bucket_iter(cfg, batch, seed + 1)
        master = lb.master_module(mod)
        ckpt, params_ck = os.path.join(work, "ck"), os.path.join(work, "lm")
        counters = {"lstm_step": (kl.lstm_step,),
                    "sgd_mom_update": (fu.sgd_mom_update,)}
        mrand.seed(seed)
        sync()
        start_memory = _reset_peak(torch) if on_card else None
        _zero(counters)
        step_ms, first_ms, fit_keys, metrics = _bucket_fit(
            torch, mod, it, dict(lb.fit_args(cfg, init), epoch_end_callback=[
                callback.do_checkpoint(params_ck),
                callback.module_checkpoint(master, ckpt,
                                           save_optimizer_states=True)]),
            on_card)
        fit_launches = _count(counters)
        fit_types = _types(counters)
        live = _host_state(mod)
        _zero(counters)
        score_keys = []
        t1 = time.perf_counter()
        score = dict(mod.score(
            it, metric.Perplexity(ignore_label=cfg["invalid_label"]),
            batch_end_callback=lambda p: score_keys.append(
                p.locals["eval_batch"].bucket_key)))
        sync()
        score_s = time.perf_counter() - t1
        score_launches = _count(counters)
        memory = _peak(torch, on_card)
        n_params = len(live[0])
        want_fit = {"lstm_step": lb.lstm_steps(cfg, fit_keys),
                    "sgd_mom_update": n_params * len(fit_keys)}
        want_score = {"lstm_step": lb.lstm_steps(cfg, score_keys),
                      "sgd_mom_update": 0}
        failures = []
        if fit_launches != want_fit or score_launches != want_score:
            failures.append("launched %s in fit and %s in score, want %s "
                            "and %s" % (fit_launches, score_launches,
                                        want_fit, want_score))
        if set(fit_types.get("lstm_step", {})) != {"float32"}:
            failures.append("lstm_step ran %s, want float32 only"
                            % fit_types.get("lstm_step"))
        per = {k: fit_keys.count(k) for k in cfg["buckets"]}
        if len(fit_keys) < 24 or min(per.values()) < 2:
            failures.append("the epoch ran %d batches, by bucket %s: want "
                            ">= 24 and every bucket twice" % (len(fit_keys),
                                                              per))
        ppl = [m["Perplexity"] for m in metrics]
        if not all(np.isfinite(ppl)) or not np.isfinite(score["Perplexity"]):
            failures.append("perplexity %s, score %s" % (ppl, score))
        # the checkpoints hold the stepped parameters
        for prefix in (ckpt, params_ck):
            _, ck_args, _ = model.load_checkpoint(prefix, 1)
            if not _equal_params({n: a.asnumpy() for n, a in
                                  ck_args.items()}, live[0])[0]:
                failures.append("%s-0001.params differs from the module's "
                                "parameters" % os.path.basename(prefix))
        if failures:
            raise RuntimeError("bucketing phase: " + "; ".join(failures))

        # 3. the resume, bit for bit
        more = lb.pick_batches(lb.bucket_iter(cfg, batch, seed + 2),
                               cfg["resume_keys"])
        mrand.seed(seed + 3)
        for b in more.batches:
            mod.fit_step(b)
        want = _host_state(mod)
        _, ck_args, ck_aux = model.load_checkpoint(ckpt, 1)
        resumed, _ = lb.bucketing_module(cfg, device, cfg["dropout"], batch,
                                         seed + 9)
        resumed.set_params(ck_args, ck_aux)
        resumed.init_optimizer(optimizer="sgd",
                               optimizer_params=lb.optimizer_params(cfg))
        lb.master_module(resumed).load_optimizer_states(ckpt + "-0001.states")
        mrand.seed(seed + 3)
        for b in more.batches:
            resumed.fit_step(b)
        got = _host_state(resumed)
        same = _equal_params(got[0], want[0])
        if not same[0]:
            raise RuntimeError("bucketing resume: %d parameters differ, the "
                               "worst %s by %g" % (same[3], same[2],
                                                   same[1]))
        resume = {"batches": [b.bucket_key for b in more.batches],
                  "bit_for_bit": True,
                  "files": sorted(os.listdir(work))}
        del resumed

        # 4. dropout on the card
        dropout = _bucket_dropout_checks(torch, cfg, mod, more.batches[0],
                                         device, seed)
        del mod, master
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # 5. dropout in the captured step
    _fresh(torch, on_card)
    capture = _bucket_capture(torch, cfg, device, seed, on_card)

    by_bucket, tokens_per_s = _by_bucket(step_ms, fit_keys, batch)
    result = {"phase": "bucketing", "vocab": cfg["vocab"],
              "embed": cfg["embed"], "hidden": cfg["hidden"],
              "layers": cfg["layers"], "dropout": cfg["dropout"],
              "buckets": list(cfg["buckets"]), "batch": batch,
              "dtype": "float32", "path": "eager (BucketingModule)",
              "check": check, "bucket_sequence": fit_keys,
              "batches": len(fit_keys), "metrics": metrics,
              "score": score, "score_ms_per_batch":
                  score_s * 1e3 / max(len(score_keys), 1),
              "first_batch_ms": first_ms, "step_ms": step_ms,
              "step_ms_by_bucket": by_bucket,
              "tokens_per_s": tokens_per_s,
              "launches": {"fit": fit_launches, "score": score_launches,
                           "capture": capture["launches"]},
              "resume": resume, "dropout_checks": dropout,
              "capture": capture, **memory}
    if on_card:
        result["start_memory_allocated"] = start_memory
    emit(result)
    return {"lstm_step": fit_launches["lstm_step"]
            + score_launches["lstm_step"],
            "sgd_mom_update": fit_launches["sgd_mom_update"],
            "sgd_mom_update_lr": capture["launches"]["sgd_mom_update_lr"],
            "capture_lstm_step": capture["launches"]["lstm_step"]}


# --- communication: the kvstore and dist phases ----------------------------
def _kv_counters():
    """The communication phases' counters (the scalar and device-lr entries
    of sgd_mom_update apart: the kvstore's updater runs the scalar one)."""
    from mxnet_tpu_torch.ops.kernels import fused_update as fu
    from mxnet_tpu_torch.ops.kernels import lstm as kl

    return {"lstm_step": (kl.lstm_step,),
            "sgd_mom_update": (fu.sgd_mom_update,),
            "sgd_mom_update_lr": (fu.sgd_mom_update_lr,)}


def _kv_registry():
    from mxnet_tpu_torch import telemetry

    return {n: v for n, v in telemetry.registry.get_name_value()
            if n.startswith("kvstore_")}


@contextlib.contextmanager
def _env(**kv):
    """Environment variables set inside the block, as they were after."""
    was = {k: os.environ.get(k) for k in kv}
    os.environ.update({k: str(v) for k, v in kv.items()})
    try:
        yield
    finally:
        for k, v in was.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _dp_fit(torch, mod, it, kwargs, on_card, also=None):
    """``mod.fit(it, **kwargs)`` recording, after each batch, the host
    parameters and the metric (then ``also(mod)``), outside the step
    times: (states before and after each batch, metrics, step ms of each
    batch after the first, the first batch's ms)."""
    states, metrics, marks = [_host_state(mod)[0]], [], []
    t0 = time.perf_counter()

    def record(param):
        if on_card:
            torch.cuda.synchronize()
        end = time.perf_counter()
        metrics.append({k: float(v) for k, v in
                        param.eval_metric.get_name_value()})
        states.append(_host_state(mod)[0])
        if also is not None:
            also(mod)
        marks.append((end, time.perf_counter()))

    mod.fit(it, batch_end_callback=record, **kwargs)
    steps = [(b[0] - a[1]) * 1e3 for a, b in zip(marks, marks[1:])]
    return states, metrics, steps, (marks[0][0] - t0) * 1e3


def _dp_gates(what, states, ppl, ref, cs):
    """Each batch's update within LSTM_UPDATE of the reference's and its
    perplexity within LSTM_PPL; raises naming ``what``; the record."""
    failures = []
    init_err = max(float(np.abs(states[0][n] - ref["states"][0][n]).max())
                   for n in ref["states"][0])
    if init_err != 0.0:
        failures.append("initial weights differ by %g" % init_err)
    upd = [_change_errs(states[0], states[b], ref["states"][0],
                        ref["states"][b]) for b in range(1, cs + 1)]
    ppl_err = [abs(g - r) / r for g, r in zip(ppl, ref["perplexity"])]
    for b, (u, p) in enumerate(zip(upd, ppl_err)):
        worst = max(u, key=u.get)
        if not u[worst] <= LSTM_UPDATE:
            failures.append("batch-%d update of %s off by %g (tol %g)"
                            % (b + 1, worst, u[worst], LSTM_UPDATE))
        if not p <= LSTM_PPL:
            failures.append("batch-%d perplexity off by %g (tol %g)"
                            % (b + 1, p, LSTM_PPL))
    if len(states) != cs + 1 or len(ppl) != cs:
        failures.append("%d states / %d perplexities recorded, want %d"
                        % (len(states) - 1, len(ppl), cs))
    if failures:
        raise RuntimeError(what + ": " + "; ".join(failures))
    return {"update_err_worst": max(max(u.values()) for u in upd),
            "perplexity_rel_err": ppl_err,
            "tol": {"update": LSTM_UPDATE, "perplexity": LSTM_PPL}}


def kv_launches(cfg, contexts, batches, n_params):
    """Launches of a data-parallel fit: lstm_step once a layer and step in
    every executor's forward; the kvstore's updater the scalar
    sgd_mom_update once a parameter a batch; the device-lr entry never."""
    return {"lstm_step": contexts * lstm_steps(cfg, batches),
            "sgd_mom_update": n_params * batches, "sgd_mom_update_lr": 0}


def phase_kvstore(cfg=DIST_LSTM, device=None, seed=SEED):
    """The LSTM LM through ``Module.fit`` over two contexts on one device
    (64 rows each), with kvstore "device" and then "local", against the
    one-context unfused fit on the same batches. Returns the launches and
    the reference run (for the dist phase)."""
    import torch
    from mxnet_tpu_torch import metric, telemetry
    from mxnet_tpu_torch.context import resolve_device

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    counters = _kv_counters()
    batch, nb = cfg["batch"], cfg["batches"]

    def kwargs(init):
        return dp_fit_args(cfg, init, metric.Perplexity(ignore_label=None))

    parts_s = {}
    t0 = time.perf_counter()
    # 1. the reference: one context, unfused
    _fresh(torch, on_card)
    with _env(MXNET_FUSED_FIT="0"):
        mod, it, init = lstm_setup(cfg, batch, nb, dev, seed)
        states, metrics, ref_ms, _ = _dp_fit(torch, mod, it, kwargs(init),
                                             on_card)
    ref_path = mod.fit_step_stats()
    n_params = len(states[0])
    param_bytes = int(sum(a.nbytes for a in states[0].values()))
    del mod
    ref = {"states": states, "metrics": metrics,
           "perplexity": [m["Perplexity"] for m in metrics]}
    if ref_path != {"path": "unfused", "reason": "MXNET_FUSED_FIT=0"}:
        raise RuntimeError("kvstore phase: the reference ran %s" % ref_path)
    parts_s["reference"] = time.perf_counter() - t0

    # 2. two contexts through each kvstore
    runs, launches = {}, {}
    for kind in ("device", "local"):
        t0 = time.perf_counter()
        _fresh(torch, on_card)
        mod, it, init = lstm_setup(cfg, batch, nb, [dev, dev], seed)
        _zero(counters)
        kv0 = _kv_registry()
        telemetry.enable_spans("executor")
        telemetry.drain_events()
        unequal = []

        def contexts_equal(m, unequal=unequal):
            execs = m._exec_group.execs
            for n in m._exec_group.param_names:
                if not torch.equal(execs[0].arg_dict[n]._data,
                                   execs[1].arg_dict[n]._data):
                    unequal.append(n)

        try:
            states, metrics, step_ms, first_ms = _dp_fit(
                torch, mod, it, kwargs(init), on_card, also=contexts_equal)
        finally:
            spans = [e for e in telemetry.drain_events()
                     if e[1] == "model.update_params_on_kvstore"]
            telemetry.disable_spans()
        got = _count(counters)
        kv1 = _kv_registry()
        rise = {k: kv1[k] - kv0.get(k, 0) for k in kv1}
        stats = mod.fit_step_stats()
        memory = _peak(torch, on_card)
        del mod
        want = kv_launches(cfg, 2, nb, n_params)
        want_kv = {"kvstore_push_total": n_params * nb,
                   "kvstore_push_bytes_total": param_bytes * nb,
                   "kvstore_pull_total": n_params * (nb + 1),
                   "kvstore_pull_bytes_total": 2 * param_bytes * (nb + 1),
                   "kvstore_barrier_total": 0}
        failures = []
        if got != want:
            failures.append("launched %s, want %s" % (got, want))
        if rise != want_kv:
            failures.append("kvstore counters rose %s, want %s"
                            % (rise, want_kv))
        if len(spans) != nb:
            failures.append("%d model.update_params_on_kvstore spans, want "
                            "%d" % (len(spans), nb))
        if unequal:
            failures.append("the contexts' parameters differ after a batch "
                            "(%s)" % sorted(set(unequal)))
        if stats != {"path": "unfused", "reason": "a kvstore"}:
            failures.append("fit_step took %s" % stats)
        if failures:
            raise RuntimeError("kvstore phase (%s): %s"
                               % (kind, "; ".join(failures)))
        t1 = time.perf_counter()
        gates = _dp_gates("kvstore phase (%s)" % kind, states,
                          [m["Perplexity"] for m in metrics], ref, nb)
        parts_s[kind] = t1 - t0
        parts_s[kind + "_gates"] = time.perf_counter() - t1
        launches[kind] = got
        runs[kind] = dict(gates, step_ms=step_ms, first_batch_ms=first_ms,
                          median_step_ms=float(np.median(step_ms)),
                          counters=rise, launches=got,
                          contexts_equal_every_batch=True, path=stats,
                          **memory)
    tokens = batch * cfg["seq"]
    one_ms = float(np.median(ref_ms))
    result = {"phase": "kvstore", "vocab": cfg["vocab"],
              "embed": cfg["embed"], "hidden": cfg["hidden"],
              "layers": cfg["layers"], "seq": cfg["seq"], "batch": batch,
              "batches": nb, "contexts": [str(dev), str(dev)],
              "rows_per_context": batch // 2, "dtype": "float32",
              "parameters": n_params, "parameter_bytes": param_bytes,
              "one_context": {"step_ms": ref_ms, "median_step_ms": one_ms,
                              "tokens_per_s": tokens / one_ms * 1e3,
                              "path": ref_path},
              "two_contexts": {k: dict(r, tokens_per_s=tokens
                                       / r["median_step_ms"] * 1e3)
                               for k, r in runs.items()},
              "two_vs_one_step": {k: r["median_step_ms"] / one_ms
                                  for k, r in runs.items()},
              "parts_s": parts_s,
              "card": nvidia_smi() if on_card else None}
    emit(result)
    total = {k: sum(launches[r][k] for r in launches)
             for k in launches["device"]}
    return {"launches": total, "reference": ref, "n_params": n_params,
            "param_bytes": param_bytes}


def _timeline(group, res):
    """Seconds from the first worker's start to: the workers' main (the
    imports), their first batch (set-up, the group's rendezvous) and the
    end of their fits, and the fits' own seconds; from the workers' JSON
    wall-clock stamps."""
    t0 = min(group.spawned_at.values())
    out = {k: max(r[k] for r in res) - t0
           for k in ("main_at", "ready_at", "fit_done_at", "done_at")
           if all(k in r for r in res)}
    if "ready_at" in out:
        out["fit"] = out["fit_done_at"] - out["ready_at"]
    return out


def _dist_worker_cmd(out, cfg, device, on_card, seed, *extra):
    from mxnet_tpu_torch.tools.dist_run import module_cmd

    args = ["--out", out, "--cfg", json.dumps(cfg), "--seed", seed,
            "--states"]
    if not on_card:
        args += ["--device", "cpu", "--count-plain"]
    elif device is not None:
        args += ["--device", str(device)]
    return module_cmd("mxnet_tpu_torch.tools.dist_lstm", *(args
                                                           + list(extra)))


def _lstm_group(cfg, device, on_card, ps, work, timeout_s, seed):
    """Start the LSTM LM over ``cfg["ranks"]`` worker processes (the
    collective store over gloo, or with ``ps`` through one parameter
    server on the host); the ranks set up and wait for the go file.
    Returns (group, its directory, go file, server command)."""
    from mxnet_tpu_torch.tools.dist_run import Group

    out = os.path.join(work, "ps" if ps else "collective")
    os.makedirs(out)
    go = os.path.join(out, "go")
    cmd = _dist_worker_cmd(out, cfg, device, on_card, seed, "--go", go,
                           *(() if ps else ("--backend", "gloo")))
    g = Group(out)
    if ps:
        g.start_servers(cmd, 1, cfg["ranks"], timeout_s, wait=False)
    else:
        g.start_workers(cmd, cfg["ranks"])
    return g, out, go, cmd


def _lstm_group_run(g, out, go, cfg, ps, timeout_s):
    """Wait until every rank is set up, say go and wait for the fits;
    (worker results, timeline, wall s of the fits)."""
    from mxnet_tpu_torch.tools.dist_run import last_json

    n = cfg["ranks"]
    g.wait_files([os.path.join(out, "ready%d" % r) for r in range(n)],
                 timeout_s)
    t0 = time.perf_counter()
    open(go, "w").close()
    outs = g.wait(timeout_s)
    wall = time.perf_counter() - t0
    if ps:
        g.wait_servers(30)
    res = [last_json(outs[r]) for r in range(n)]
    return res, _timeline(g, res), wall


def _lstm_group_gates(cfg, n_params, ps, ref, out, res, timeline, wall):
    """The LSTM LM run ``res`` (rank 0's states and every rank's
    probabilities in ``out``) against the one-process fit ``ref``: the
    lstm gates, the ranks equal bit for bit, the launches; the record and
    the launches summed over the ranks."""
    from mxnet_tpu_torch.tools import dist_lstm as dl

    n, nb = cfg["ranks"], cfg["batches"]
    t1 = time.perf_counter()
    states = [dict(np.load(os.path.join(out, "state%d.npz" % b)))
              for b in range(nb + 1)]
    finals = [dict(np.load(os.path.join(out, "final%d.npz" % r)))
              for r in range(n)]
    ppl = dl.combined_perplexity([np.load(os.path.join(out, "probs%d.npy"
                                                       % r))
                                  for r in range(n)])
    what = "dist phase (%s)" % ("parameter server" if ps else
                                "collective dist_sync")
    same = [_equal_params(finals[r], finals[0]) for r in range(1, n)]
    failures = []
    if not all(s[0] for s in same):
        failures.append("the ranks' final parameters differ: %s" % same)
    if not _equal_params(states[-1], finals[0])[0]:
        failures.append("rank 0's last state is not its final one")
    want = kv_launches(cfg, 1, nb, 0 if ps else n_params)
    for r in res:
        if r["launches"] != want:
            failures.append("rank %d launched %s, want %s"
                            % (r["rank"], r["launches"], want))
        if r["store"] != ("PSKVStore" if ps else "KVStore") \
                or r["workers"] != n or r["batches"] != nb:
            failures.append("rank %d ran %s" % (r["rank"], r))
    if failures:
        raise RuntimeError(what + ": " + "; ".join(failures))
    gates = _dp_gates(what, states, ppl, ref, nb)
    timeline["gates_s"] = time.perf_counter() - t1
    steps = [s for r in res for s in r["step_ms"]]
    rec = dict(gates, ranks=n, fit_wall_s=wall, timeline_s=timeline,
               backend=res[0]["backend"], store=res[0]["store"],
               device=res[0]["device"], rows_per_rank=res[0]["batch"],
               ranks_equal_bit_for_bit=True,
               median_step_ms=float(np.median(steps)),
               step_ms_by_rank=[r["step_ms"] for r in res],
               launches_by_rank=[r["launches"] for r in res],
               counters_by_rank=[r["kvstore_counters"] for r in res])
    # the update's share of a step: push (the all-reduce, or the RPC
    # queued) and pull (a copy, or the server's round trip)
    c = res[0]["kvstore_counters"]
    rec.update(update_on_kvstore_ms_per_step=[r["update_on_kvstore_ms"]
                                              for r in res],
               pull_ms_per_step=[r["pull_ms"] for r in res],
               push_bytes_per_step=c["kvstore_push_bytes_total"] / nb,
               pull_bytes_per_step=c["kvstore_pull_bytes_total"] / (nb + 1))
    return rec, {k: sum(r["launches"][k] for r in res) for k in want}


def _closed_forms_start(device, on_card, work, timeout_s):
    """Start the nightly checks' counterparts on ``device``: the parameter
    server's (2 servers, 2 workers, keys (4, 4) and (1200, 1200), 3 sync
    rounds and an async one) and the collective group's (2 ranks over
    gloo), side by side. Returns the two groups."""
    from mxnet_tpu_torch.tools.dist_run import Group, module_cmd

    dev = ["--device", "cpu"] if not on_card else (
        ["--device", str(device)] if device is not None else [])
    ps_cmd = module_cmd("mxnet_tpu_torch.tools.dist_sync_kvstore", *dev)
    coll_cmd = module_cmd("mxnet_tpu_torch.tools.dist_collective", *dev,
                          "--backend", "gloo")
    groups = [Group(os.path.join(work, "closed_ps")),
              Group(os.path.join(work, "closed_collective"))]
    groups[1].start_workers(coll_cmd, 2)
    groups[0].start_servers(ps_cmd, 2, 2, timeout_s)
    groups[0].start_workers(ps_cmd, 2)
    return groups


def _closed_forms_wait(groups, on_card, timeout_s):
    """Every pull of both closed-form groups exact; the record."""
    from mxnet_tpu_torch.tools.dist_run import last_json

    outs = [g.wait(timeout_s) for g in groups]
    groups[0].wait_servers(30)
    res = [[last_json(o[r]) for r in (0, 1)] for o in outs]
    timelines = [_timeline(g, r) for g, r in zip(groups, res)]
    want_dev = "cuda" if on_card else "cpu"
    for r in res[0] + res[1]:
        if not r.get("ok") or r["exact_checks"] != 8 \
                or not r["device"].startswith(want_dev):
            raise RuntimeError("dist phase closed forms: %s" % r)
    return {"parameter_server": {"servers": 2, "workers": 2,
                                 "exact_checks": [r["exact_checks"]
                                                  for r in res[0]],
                                 "counters": res[0][0]["counters"]},
            "collective": {"ranks": 2, "backend": res[1][0]["backend"],
                           "allgather": res[1][0]["allgather"],
                           "exact_checks": [r["exact_checks"]
                                            for r in res[1]]},
            "device": res[0][0]["device"],
            "timeline_s": {"parameter_server": timelines[0],
                           "collective": timelines[1]}}


def _world1(torch, cfg, dev, on_card, seed, work, ref, n_params):
    """``dist_sync`` over NCCL (gloo on the host) at world size 1 in this
    process: the store's all-reduce of one rank changes nothing, so the
    run equals the one-process reference bit for bit."""
    from mxnet_tpu_torch import metric
    from mxnet_tpu_torch.parallel import dist

    nb = cfg["batches"]
    counters = _kv_counters()
    backend = "nccl" if on_card else "gloo"
    dist.init("file://" + os.path.join(work, "rendezvous"), 1, 0,
              backend=backend, device=dev)
    try:
        _fresh(torch, on_card)
        mod, it, init = lstm_setup(cfg, cfg["batch"], nb, dev, seed)
        _zero(counters)
        states, _, step_ms, _ = _dp_fit(
            torch, mod, it, dict(dp_fit_args(
                cfg, init, metric.Perplexity(ignore_label=None)),
                kvstore="dist_sync"), on_card)
        launched = _count(counters)
        kind = mod._kvstore.type
        workers = mod._kvstore.num_workers
        del mod
        used = dist.backend()
    finally:
        dist.shutdown()
    want = kv_launches(cfg, 1, nb, n_params)
    same = [_equal_params(s, r)[0] for s, r in zip(states, ref["states"])]
    if launched != want or not all(same) or len(states) != nb + 1 \
            or (kind, workers, used) != ("dist_sync", 1, backend):
        raise RuntimeError(
            "dist phase (%s, world 1): launched %s (want %s), %s over %d "
            "worker(s) by %s, batches equal to the reference %s"
            % (backend, launched, want, kind, workers, used, same))
    return {"backend": used, "bit_for_bit": True, "step_ms": step_ms,
            "launches": launched}, launched


def phase_dist(cfg=DIST_LSTM, device=None, seed=SEED, kv=None,
               timeout_s=DIST_CHILD_S):
    """The dist_* stores against the kvstore phase's one-process reference
    (``kv``): (a0) ``dist_sync`` over NCCL at world size 1 in this
    process, bit for bit; (a) the collective store over two gloo ranks on
    the card, each its half of every batch; (b) ``dist_sync`` through a
    parameter server on the host with two workers on the card; (c) the
    closed forms. The processes of (a), (b)'s server and (c) start
    together; (a) and (b) fit each alone once their ranks are set up (the
    go file), so their step times are their own. Returns the launches."""
    import tempfile

    import torch
    from mxnet_tpu_torch.context import resolve_device

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    ref, n_params = kv["reference"], kv["n_params"]
    work = tempfile.mkdtemp(prefix="mxtt_dist_")
    groups, parts, t00 = [], {}, time.perf_counter()
    try:
        coll = _lstm_group(cfg, device, on_card, False, work, timeout_s,
                           seed)
        pss = _lstm_group(cfg, device, on_card, True, work, timeout_s, seed)
        groups += [coll[0], pss[0]]
        closed = _closed_forms_start(device, on_card, work, timeout_s)
        groups += closed
        t0 = time.perf_counter()
        parts["world1"], launches = _world1(torch, cfg, dev, on_card, seed,
                                            work, ref, n_params)
        parts["world1"]["wall_s"] = time.perf_counter() - t0
        parts["closed_forms"] = _closed_forms_wait(closed, on_card,
                                                   timeout_s)
        parts["closed_forms"]["done_s"] = time.perf_counter() - t00
        runs = {}
        for name, (g, out, go, cmd), ps in (
                ("collective", coll, False),
                ("parameter_server", pss, True)):
            runs[name] = _lstm_group_run(g, out, go, cfg, ps, timeout_s)
            if name == "collective":
                # its gates on the host while the server's ranks set up
                pss[0].servers_bound(timeout_s)
                pss[0].start_workers(pss[3], cfg["ranks"])
            parts[name], got = _lstm_group_gates(
                cfg, n_params, ps, ref, out, *runs[name])
            parts[name]["done_s"] = time.perf_counter() - t00
            launches = {k: launches[k] + got[k] for k in launches}
    finally:
        for g in groups:
            g.stop()
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "dist", "batch": cfg["batch"], "batches": cfg["batches"],
          "ranks": cfg["ranks"], "dtype": "float32", **parts,
          "seconds": time.perf_counter() - t00,
          "card": nvidia_smi() if on_card else None})
    return launches

def phase_host():
    """One line, no gate: what the card machine offers a JPEG decoder (the
    input plane's first question): ``jpeglib.h``, ``libjpeg.so*`` and
    CUDA's ``libnvjpeg.so*``, each with the paths found."""
    import glob

    def found(patterns):
        return sorted({p for pat in patterns for p in glob.glob(pat)})

    emit({"phase": "host",
          "jpeglib_h": found(["/usr/include/jpeglib.h",
                              "/usr/include/*/jpeglib.h",
                              "/usr/local/include/jpeglib.h"]),
          "libjpeg": found(["/usr/lib/libjpeg.so*", "/usr/lib/*/libjpeg.so*",
                            "/usr/lib64/libjpeg.so*",
                            "/usr/local/lib/libjpeg.so*"]),
          "libnvjpeg": found(["/usr/local/cuda/lib64/libnvjpeg.so*"])})


def _engine_note(msg):
    """A progress line of the engine phase on stderr."""
    print("engine: %s" % msg, file=sys.stderr, flush=True)


def _nominal_counts(sizes, ladder):
    """{nominal bucket: requests} of requests of ``sizes`` rows against
    ``ladder`` (the smallest rung holding each)."""
    out = {}
    for n in sizes:
        b = next(b for b in sorted(ladder) if b >= n)
        out[b] = out.get(b, 0) + 1
    return out


def _engine_fit(torch, cfg, device, seed, on_card, env):
    """ResNet-50 ``Module.fit`` (one epoch of ``cfg``) under ``env``: its
    parameters and aux states, launches, step path and seconds."""
    from mxnet_tpu_torch import engine

    _fresh(torch, on_card)
    fused0 = engine.fused_stats()
    with _env(**env):
        mod, it, init = resnet_setup(cfg, cfg["batch"], cfg["batches"],
                                     device, seed,
                                     compute_dtype=cfg["dtype"])
        counters = _resnet_counters()
        _zero(counters)
        t0 = time.time()
        step_ms, first_ms, _metrics = _fit_timed(
            torch, mod, it, fit_args(cfg, init), on_card)
        state = _host_state(mod)
        secs = time.time() - t0
        launches = _count(counters)
        stats = mod.fit_step_stats()
        stats["step_ms"], stats["first_batch_ms"] = step_ms, first_ms
    fused = {k: v - fused0[k] for k, v in engine.fused_stats().items()}
    sym = mod.symbol
    del mod, it
    return state, launches, stats, fused, secs, sym


def _engine_fits(torch, cfg, device, seed, on_card):
    """ResNet-50's three ``fit`` modes (the captured fused step; engine
    capture; capture and fuse): equal bit for bit, exact launches, the
    engine's replays and fused runs."""
    from mxnet_tpu_torch import engine

    warm = engine.capture_warmup()
    steps = cfg["batches"]
    runs = {}
    for mode, env in (("today", {}),
                      ("capture", {"MXNET_ENGINE_CAPTURE": "1"}),
                      ("fuse", {"MXNET_ENGINE_CAPTURE": "1",
                                "MXNET_ENGINE_FUSE": "1"})):
        runs[mode] = _engine_fit(torch, cfg, device, seed, on_card, env)
        _engine_note("resnet fit %s in %.1f s" % (mode, runs[mode][4]))
    (args, aux), _l, _s, _f, _t, sym = runs["today"]
    per_step = wgrad_convs(sym)
    per_route = wgrad_routes(sym, cfg["image"], cfg["batch"], cfg["dtype"])
    want = dict(resnet_wgrad_launches(per_step, steps),
                conv_wgrad_repack=2 * per_route.get("wgmma", 0) * steps
                if on_card and cfg["dtype"] == "bfloat16" else 0,
                sgd_mom_update=len(args) * steps)
    out = {}
    for mode, ((a, x), launches, stats, fused, secs, _sym) in runs.items():
        if launches != want:
            raise RuntimeError("engine phase: resnet fit (%s) launched %s, "
                               "want %s" % (mode, launches, want))
        for what, got, ref in (("parameters", a, args), ("aux states", x,
                                                          aux)):
            same, worst, name, n = _equal_params(got, ref)
            if not same:
                raise RuntimeError(
                    "engine phase: resnet fit (%s) %s differ from today's "
                    "by %g (%s, %d arrays)" % (mode, what, worst, name, n))
        eng = stats.get("engine")
        if mode == "today" and eng is not None:
            raise RuntimeError("engine phase: resnet fit rode the engine's "
                               "capture with it off: %s" % eng)
        if mode == "capture" and (eng is None or eng["replays"]
                                  != steps - warm or eng["bails"]
                                  or eng["fused_runs"]):
            raise RuntimeError("engine phase: resnet fit under capture: %s, "
                               "want %d replays" % (eng, steps - warm))
        if mode == "fuse" and (
                eng is None or eng["fused_runs"] != steps - warm
                or eng["fuse_bails"] or eng["replays"]
                or fused["runs"] != steps - warm
                or fused["captures"] != (1 if on_card else 0)):
            raise RuntimeError("engine phase: resnet fit under fuse: %s %s, "
                               "want %d fused runs" % (eng, fused,
                                                       steps - warm))
        if mode != "capture":
            _require_captured("engine", [stats], on_card and mode == "today")
        out[mode] = {"seconds": secs, "engine": eng, "fused": fused,
                     "step_path": stats.get("path"),
                     "step_ms": stats["step_ms"],
                     "median_step_ms": float(np.median(stats["step_ms"]))
                     if stats["step_ms"] else None,
                     "first_batch_ms": stats["first_batch_ms"]}
    return {"batch": cfg["batch"], "batches": steps, "dtype": cfg["dtype"],
            "warmup": warm, "launches_each": want, "bit_for_bit": True,
            "modes": out}, {k: 3 * v for k, v in want.items()}


def _engine_server(torch, cfg, eng, device, seed, on_card):
    """The LM behind ``InferenceServer`` eager, captured and fused: the
    same responses bit for bit, exact flash launches, a forced ladder swap
    that invalidates the sequences and a recapture after it."""
    from mxnet_tpu_torch import engine
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa

    params = lm_arg_params(cfg, seed)
    seq = eng["serve_seq"]
    reqs = lm_requests(cfg, seq, request_sizes(eng), seed + 40)
    cut = eng["swap_after"]
    arms, ref, launches = {}, None, 0
    for arm, cap, fuse in (("eager", False, False), ("capture", True, False),
                           ("fuse", True, True)):
        fa.flash_attention.launches = 0
        t0 = time.time()
        srv = lm_server(cfg, seq, params, eng["buckets"], device,
                        capture=cap, fuse=fuse, adaptive=True)
        preds = {}

        def collect():
            for p in list(srv._replicas[0].cache._execs.values()):
                preds[id(p)] = p

        collect()
        with srv:
            outs = serve_in_turn(srv, reqs[:cut])
            before = srv.capture_stats()[0]
            old = list(srv._replicas[0].captures.values())
            collect()
            swap_ladder(srv, eng["swap_ladder"])
            collect()
            outs += serve_in_turn(srv, reqs[cut:])
            after = srv.capture_stats()[0]
            collect()
        got = fa.flash_attention.launches
        launches += got
        fused_runs = sum(st["fused_program_runs"]
                         for st in list(before.values())
                         + list(after.values()))
        forwards = _forward_calls(preds.values())
        want = cfg["layers"] * (forwards + fused_runs)
        if got != want:
            raise RuntimeError(
                "engine phase: the %s server launched the flash kernel %d "
                "times, want %d (%d predictor forwards, %d fused runs)"
                % (arm, got, want, forwards, fused_runs))
        if ref is None:
            ref = outs
        else:
            for i, (o, r) in enumerate(zip(outs, ref)):
                if not np.array_equal(o, r):
                    raise RuntimeError(
                        "engine phase: the %s server's response %d differs "
                        "from the eager one by %g"
                        % (arm, i, float(np.abs(o - r).max())))
        rec = {"seconds": time.time() - t0, "flash_launches": got,
               "predictor_forwards": forwards, "fused_runs": fused_runs,
               "before_swap": before, "after_swap": after}
        if cap:
            key = "fused_runs" if fuse else "replays"
            warm = engine.capture_warmup()
            sizes = request_sizes(eng)
            # each nominal bucket's sequence warms up, then runs the rest
            want_before = {b: max(0, n - warm) for b, n in _nominal_counts(
                sizes[:cut], eng["buckets"]).items()}
            want_after = {b: max(0, n - warm) for b, n in _nominal_counts(
                sizes[cut:], eng["swap_ladder"]).items()}
            got_before = {b: st[key] for b, st in before.items()}
            got_after = {b: st[key] for b, st in after.items()}
            stale = [cs.name for cs in old if cs._invalid_reason is None]
            bails = sum(st["fuse_bails"] + st["bails"]
                        for st in list(before.values())
                        + list(after.values()))
            if got_before != want_before or got_after != want_after \
                    or stale or bails or (fuse and not on_card and any(
                        st["fused_replays"] for st in after.values())) \
                    or (fuse and on_card and any(
                        st["fused_replays"] != st["fused_runs"]
                        for st in after.values())):
                raise RuntimeError(
                    "engine phase: the %s server's sequences: %s before the "
                    "swap (want %s), %s after (want %s), not invalidated %s,"
                    " bails %d" % (arm, got_before, want_before, got_after,
                                   want_after, stale, bails))
        arms[arm] = rec
        del srv, preds
        _fresh(torch, on_card)
    return {"seq": seq, "buckets": list(eng["buckets"]),
            "swap_ladder": list(eng["swap_ladder"]),
            "requests": len(reqs), "bit_for_bit": True,
            "arms": arms}, launches


def _engine_decode(torch, cfg, serve, eng, device, seed, on_card):
    """The decode scheduler eager and under ``MXNET_ENGINE_CAPTURE=1``
    (the captured step inside ``decode_step_r0``): the same tokens, the
    sequence replaying, exact flash launches (one a prompt and layer)."""
    from mxnet_tpu_torch import engine
    from mxnet_tpu_torch.serving import generate as gen

    params = lm_arg_params(cfg, seed)
    spec = gen.DecodeSpec(num_heads=cfg["heads"],
                          num_kv_heads=cfg["kv_heads"])
    model = gen.DecodeModel.from_arg_params(params, spec, device=device)
    prompts = serve_prompts(cfg, serve, seed)[:eng["decode_prompts"]]
    conf = dict(serve, max_new_tokens=eng["decode_new_tokens"])
    plain = _serve_streams(gen, model, cfg, conf, prompts, together=True)
    with _env(MXNET_ENGINE_CAPTURE="1"):
        cap = _serve_streams(gen, model, cfg, conf, prompts, together=True,
                             capture=True)
    if plain["tokens"] != cap["tokens"]:
        raise RuntimeError("engine phase: the decode under engine capture "
                           "gave %s, eager %s" % (cap["tokens"],
                                                  plain["tokens"]))
    if "engine_capture" in plain["stats"]:
        raise RuntimeError("engine phase: the eager decode rode a captured "
                           "sequence")
    seqs = cap["stats"].get("engine_capture") or [None]
    st = seqs[0]
    steps = cap["stats"]["steps"]
    warm = engine.capture_warmup()
    if st is None or st["name"] != "decode_step_r0" or \
            st["replays"] != steps - warm or st["bails"]:
        raise RuntimeError("engine phase: decode_step_r0 %s, want %d "
                           "replays" % (st, steps - warm))
    _require_decode_capture("engine phase decode", cap["stats"], on_card)
    want = len(prompts) * cfg["layers"]
    for r in (plain, cap):
        if r["launches"] != want:
            raise RuntimeError("engine phase: the decode launched the flash "
                               "kernel %d times, want %d"
                               % (r["launches"], want))
    del model
    _fresh(torch, on_card)
    return {"prompts": [len(p) for p in prompts],
            "new_tokens": eng["decode_new_tokens"], "steps": steps,
            "tokens_equal": True, "decode_step_r0": st,
            "ms_per_token": {"eager": plain["ms_per_token"],
                             "capture": cap["ms_per_token"]}}, \
        plain["launches"] + cap["launches"]


def _engine_restart(cfg, eng, device, on_card, timeout_s=600):
    """The program cache's warm restart: two processes in turn on one
    temporary ``MXNET_PROGCACHE_DIR`` (removed after)."""
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="mxtt-restart-")
    env = dict(os.environ, MXNET_PROGCACHE_DIR=os.path.join(work, "cache"),
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    for k in ("MXNET_PROGCACHE", "MXNET_ENGINE_CAPTURE", "MXNET_ENGINE_FUSE"):
        env.pop(k, None)
    conf = json.dumps({"lm": cfg, "engine": {
        k: list(v) if isinstance(v, tuple) else v for k, v in eng.items()}})
    dev = "cuda" if on_card else str(device)
    recs, outs = {}, {}
    try:
        for role in ("first", "second"):
            out = os.path.join(work, role + ".json")
            t0 = time.time()
            proc = subprocess.run(
                [sys.executable, "-m", "mxnet_tpu_torch.tools.engine_phase",
                 "restart", role, out, "--device", dev, "--config", conf],
                cwd=root, env=env, timeout=timeout_s,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                raise RuntimeError("engine phase: the %s restart process "
                                   "failed (%d):\n%s" % (
                                       role, proc.returncode,
                                       proc.stdout[-4000:]))
            with open(out) as f:
                recs[role] = json.load(f)
            recs[role]["seconds"] = time.time() - t0
            recs[role]["log_tail"] = proc.stdout[-3000:]
            outs[role] = recs[role].pop("digests")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    first, second = recs["first"], recs["second"]
    ladder = first["ladder"]
    problems = []
    if sorted(ladder) == sorted(eng["restart_buckets"]):
        problems.append("the first process's retune kept %s" % ladder)
    if second["ladder_at_start"] != ladder:
        problems.append("the second started at %s, not the tuned %s"
                        % (second["ladder_at_start"], ladder))
    if second["disk_loads"] != len(ladder) or second["binds"]:
        problems.append("the second disk-loaded %d programs and built %d "
                        "(ladder %s)" % (second["disk_loads"],
                                         second["binds"], ladder))
    if second["compiles"] or second["witness_disk_loads"] != len(ladder):
        problems.append("the witness saw %d fresh traces and %d disk loads"
                        % (second["compiles"],
                           second["witness_disk_loads"]))
    if {first["engine"], second["engine"]} != {"NativeEngine"}:
        problems.append("engines %s / %s" % (first["engine"],
                                             second["engine"]))
    if on_card and second["flash_launches"] <= 0:
        problems.append("the loaded programs launched no flash kernel")
    if outs["first"] != outs["second"] or \
            len(outs["first"]) != len(eng["restart_sizes"]):
        problems.append("the second process's outputs differ from the "
                        "first's (sha256 of each)")
    tr = second["truncated"]
    if tr["fallbacks"] != 1 or tr["source"] != "compile" \
            or not tr["same_outputs"]:
        problems.append("the truncated entry: %s" % tr)
    if problems:
        raise RuntimeError("engine phase: warm restart: %s\nfirst: %s\n"
                           "second: %s" % ("; ".join(problems), first,
                                           second))
    return {"ladder": ladder, "first": first, "second": second,
            "outputs_equal": True, "cold_ready_s": first["ready_s"],
            "warm_ready_s": second["ready_s"],
            "cold_process_s": first["seconds"],
            "warm_process_s": second["seconds"]}, \
        first["flash_launches"] + second["flash_launches"]


def phase_engine(cfg=LM, resnet=RESNET, eng=ENGINE, serve=SERVE,
                 device=None, seed=SEED):
    """The engine on the card (see the module's docstring, phase 10).
    Returns its launches by kernel."""
    import torch

    from mxnet_tpu_torch import engine

    on_card = device is None or torch.device(device).type == "cuda"
    t0 = time.time()
    native = engine.get()
    if type(native).__name__ != "NativeEngine" or \
            native.engine_type != "ThreadedEngine":
        raise RuntimeError("engine phase: engine.get() is %s (%s), not the "
                           "native ThreadedEngine" % (
                               type(native).__name__,
                               getattr(native, "engine_type", "?")))
    engine.sanitizer_enable(True)
    try:
        fits, fit_launches = _engine_fits(torch, resnet, device, seed,
                                          on_card)
        server, srv_launches = _engine_server(torch, cfg, eng, device, seed,
                                              on_card)
        _engine_note("server arms done")
        decode, dec_launches = _engine_decode(torch, cfg, serve, eng, device,
                                              seed, on_card)
        _engine_note("decode done")
        restart, restart_launches = _engine_restart(cfg, eng, device,
                                                    on_card)
        reports = engine.sanitizer_reports()
    finally:
        engine.sanitizer_enable(False)
    if reports:
        raise RuntimeError("engine phase: the sanitizer reported %d race(s): "
                           "%s" % (len(reports), [
                               {k: r[k] for k in ("rule", "op", "site",
                                                  "other_op", "other_site")}
                               for r in reports[:4]]))
    emit({"phase": "engine", "engine": "NativeEngine",
          "workers_env": os.environ.get("MXNET_CPU_WORKER_NTHREADS", ""),
          "sanitizer_reports": 0, "resnet": fits, "server": server,
          "decode": decode, "restart": restart,
          "seconds": time.time() - t0})
    return dict(fit_launches, flash_attention_fwd=srv_launches
                + dec_launches, flash_attention_fwd_restart=restart_launches)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    # a run that outlives WATCHDOG_S prints every thread's stack and
    # exits non-zero, before the caller's limit cuts it silently
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    # the reference products run in full f32: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_host()
    phase_build()
    worst, timings = phase_kernel(torch)
    bwd_worst, bwd_timings = phase_kernel_bwd(torch)
    upd_worst, upd_timings = phase_kernel_update(torch)
    wgrad_worst, wgrad_timings, wgrad_step = phase_kernel_wgrad(torch)
    lstm_worst, lstm_timings, lstm_layer = phase_kernel_lstm(torch)
    rtc_worst, rtc_timings = phase_kernel_rtc(torch)
    serve_launches, serve_tokens = phase_serve()
    paged_launches = phase_serve_paged(eager_tokens=serve_tokens)
    spec_launches = phase_serve_spec()
    trace_launches = phase_serve_trace()
    fixed_launches, fixed_timings = phase_serve_fixed(
        serve_tokens=serve_tokens)
    http_launches = phase_serve_http(serve_tokens=serve_tokens)
    train = phase_train()
    resnet = phase_resnet()
    image_zoo = phase_image_zoo()
    ssd = phase_ssd()
    lstm = phase_lstm()
    zoo_launches = phase_zoo()
    seq_launches = phase_seq()
    custom = phase_custom()
    bucketing = phase_bucketing()
    kvstore = phase_kvstore()
    dist_launched = phase_dist(kv=kvstore)
    engine_launched = phase_engine()
    kv_launched = kvstore["launches"]
    t = timings["serve"]["float32"]
    rows = [{
        "name": "flash_attention_fwd", "route": "cuda", "source": FA_SRC,
        "replaces": FA_REPLACES,
        "launches": serve_launches + paged_launches + spec_launches
        + trace_launches + fixed_launches + http_launches
        + train["flash_attention_fwd"]
        + engine_launched["flash_attention_fwd"]
        + engine_launched["flash_attention_fwd_restart"],
        "launches_by_phase": {"serve": serve_launches,
                              "serve_paged": paged_launches,
                              "serve_spec": spec_launches,
                              "serve_trace": trace_launches,
                              "serve_fixed": fixed_launches,
                              "serve_http": http_launches,
                              "train": train["flash_attention_fwd"],
                              "engine": engine_launched[
                                  "flash_attention_fwd"],
                              "engine_restart": engine_launched[
                                  "flash_attention_fwd_restart"]},
        "max_abs_err": max(worst.values()), "max_err": worst,
        "dtype": "float32", "shape": t["shape"], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "bfloat16": timings["serve"]["bfloat16"], "train": timings["train"],
        "bfloat16_main": timings["train_main"][TRAIN["dtype"]],
        "predictor_shapes": fixed_timings}]
    # the backward runs on the main path only in the train phase: its
    # type and batch head the row
    t = {k: v for k, v in bwd_timings["train_main"].items() if k != "work"}
    rows.append({
        "name": "flash_attention_bwd", "route": "cuda", "source": FA_BWD_SRC,
        "replaces": FA_BWD_REPLACES,
        "launches": train["flash_attention_bwd_dq"]
        + train["flash_attention_bwd_dkv"],
        "launches_by_kernel": {"dq": train["flash_attention_bwd_dq"],
                               "dkv": train["flash_attention_bwd_dkv"]},
        "max_abs_err": max(bwd_worst.values()), "max_err": bwd_worst,
        "dtype": TRAIN["dtype"], **t,
        "float32": {k: v for k, v in bwd_timings["float32"].items()
                    if k != "work"},
        "bfloat16_batch4": {k: v for k, v in bwd_timings["bfloat16"].items()
                            if k != "work"}})
    for kind in ("sgd_mom_update", "adam_update"):
        t = upd_timings[kind]
        by_phase = {"train": train[kind]}
        if kind in resnet:
            by_phase["resnet"] = resnet[kind]
            by_phase["engine"] = engine_launched[kind]
            by_phase["image_zoo"] = image_zoo["main"][kind]
            by_phase["ssd"] = ssd["main"][kind]
        if kind in bucketing:
            # the Updater's scalar entry, and the captured step's lr entry
            by_phase["bucketing"] = bucketing[kind]
            by_phase["bucketing_capture"] = bucketing[kind + "_lr"]
        if kind in zoo_launches:
            # ccSGD's captured runs (lr entry) and the SequentialModule's
            # Updater (scalar entry)
            by_phase["zoo"] = zoo_launches[kind] + zoo_launches[kind + "_lr"]
        if kind in kv_launched:
            # the kvstore's updater: the scalar entry (the lr entry 0)
            by_phase["kvstore"] = kv_launched[kind] + kv_launched[
                kind + "_lr"]
            by_phase["dist"] = dist_launched[kind] + dist_launched[
                kind + "_lr"]
        rows.append({
            "name": kind, "route": "cuda", "source": UPDATE_SRC,
            "replaces": UPDATE_REPLACES[kind],
            "launches": sum(by_phase.values()),
            "launches_by_phase": by_phase,
            "max_abs_err": upd_worst[kind], "dtype": "float32",
            "shape": "%d LM parameters, %d elements" % (t["parameters"],
                                                        t["elements"]),
            "ms": t["device_lr_ms"], "plain_ms": t["plain_ms"],
            "scalar_entry_ms": t["ms"],
            "main_path_entry": kind + "_lr (lr / wd read on the card)",
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "library_note": t["library_note"]})
    # the resnet phase's type heads the row
    t = wgrad_step[RESNET["dtype"]]
    wgrad_parts = ("conv_wgrad_partial", "conv_wgrad_reduce",
                   "conv_wgrad_repack")
    wgrad_by_phase = {
        "resnet": sum(resnet[k] for k in wgrad_parts),
        "image_zoo": sum(image_zoo["main"][k] for k in wgrad_parts),
        "image_zoo_check": sum(image_zoo["check"].values()),
        "ssd": sum(ssd["main"][k] for k in wgrad_parts),
        "ssd_check": sum(ssd["check"][k] for k in wgrad_parts),
        "engine": sum(engine_launched[k] for k in wgrad_parts)}
    rows.append({
        "name": "conv_wgrad", "route": "cuda", "source": WGRAD_SRC,
        "replaces": WGRAD_REPLACES,
        "launches": sum(wgrad_by_phase.values()),
        "launches_by_phase": wgrad_by_phase,
        "launches_by_kernel": {
            part: resnet["conv_wgrad_" + part]
            + image_zoo["main"]["conv_wgrad_" + part]
            + image_zoo["check"].get("conv_wgrad_" + part, 0)
            + ssd["main"]["conv_wgrad_" + part]
            + ssd["check"]["conv_wgrad_" + part]
            + engine_launched["conv_wgrad_" + part]
            for part in ("partial", "reduce", "repack")},
        "max_abs_err": max(wgrad_worst.values()), "max_err": wgrad_worst,
        "dtype": RESNET["dtype"],
        "shape": "the 16 3x3 convolutions of one ResNet-50 step at batch 32",
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": ("operations" if all(
            x["bound_by"] == "operations"
            for x in wgrad_timings[RESNET["dtype"]]) else "bytes"),
        "library_ms": t["library_ms"],
        "device_ms": t["device_ms"],
        "library_device_ms": t["library_device_ms"],
        "library": "torch.nn.grad.conv2d_weight (cuDNN wgrad, no TF32)",
        "float32": wgrad_step["float32"],
        "per_shape": wgrad_timings,
        "image_zoo_max_err": image_zoo["wgrad_max_abs_err"],
        "image_zoo_shapes": image_zoo["wgrad"],
        "ssd_max_err": ssd["wgrad_max_abs_err"], "ssd_shapes": ssd["wgrad"]})
    t = lstm_timings["float32"]
    rows.append({
        "name": "lstm_step", "route": "cuda", "source": LSTM_SRC,
        "replaces": LSTM_REPLACES,
        "launches": lstm["fit"] + lstm["score"] + zoo_launches["lstm_step"]
        + seq_launches + bucketing["lstm_step"]
        + bucketing["capture_lstm_step"] + kv_launched["lstm_step"]
        + dist_launched["lstm_step"],
        "launches_by_phase": {"lstm_fit": lstm["fit"],
                              "lstm_score": lstm["score"],
                              "zoo": zoo_launches["lstm_step"],
                              "seq": seq_launches,
                              "bucketing": bucketing["lstm_step"],
                              "bucketing_capture":
                                  bucketing["capture_lstm_step"],
                              "kvstore": kv_launched["lstm_step"],
                              "dist": dist_launched["lstm_step"]},
        "max_abs_err": max(lstm_worst.values()), "max_err": lstm_worst,
        "dtype": "float32", "shape": "one step at (N, H) = (128, 512)",
        "kernel": t["kernel"], "layout": t["layout"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "library": "torch.mm(h, wh.t()) + aten._thnn_fused_lstm_cell (no "
                   "single PyTorch call computes the step)",
        "bfloat16": lstm_timings["bfloat16"],
        "bucketing_float32": lstm_timings["bucketing_float32"],
        "layer": lstm_layer})
    for kind in ("fwd", "bwd"):
        t = rtc_timings[kind]
        rows.append(dict(t, **{
            "name": "rtc_softmax_" + kind, "route": "cuda",
            "source": RTC_SRC, "replaces": RTC_REPLACES,
            "compiler": "NVRTC at run time (mxnet_tpu_torch/rtc.py, "
                        "ops/kernels/rtc_driver.py)",
            "launches": custom["fit"][kind] + custom["score"][kind],
            "launches_by_phase": {"custom_fit": custom["fit"][kind],
                                  "custom_score": custom["score"][kind]},
            "max_abs_err": rtc_worst, "dtype": "float32"}))
    emit({"kernels": rows})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
