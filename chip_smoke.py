#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--profile]

Run from the root of a checkout, on a machine with a CUDA card, ``nvcc``
and PyTorch built for CUDA.  It:

1. prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions and the TF32 flags, and turns TF32 off for the whole run;
2. builds every CUDA kernel of the package from ``mxnet_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel), prints the build time and each
   kernel's registers and spills from ``-Xptxas -v`` (a spill in an
   attention kernel, the 16-bit Hopper ones or the float32 three-TF32
   ones, forward or backward, fails the run), the blocks an SM and shared
   memory a block of the attention kernels (bf16, f16 and f32), and the
   count of ``HMMA`` TF32 instructions in each float32 kernel's SASS
   (``cuobjdump -sass``; none in one fails the run);
3. kernel phase: holds each kernel against its plain PyTorch version on the
   card and times kernel, plain version and the memory-bandwidth bound with
   CUDA events (L2 flushed between launches): the epilogue forward at the
   shapes the serving path gives it (bucket 8) and the training path gives
   it (batch 32), and the epilogue backward at the training shapes, each
   kernel also with an NHWC, a bfloat16, a ragged and an unaligned case,
   and in float16 at the float16 paths' shapes (the forward at bucket 8's
   and batch 128's, the backward at batch 32's), within 1 ulp;
4. serving phase: builds ResNet-50 v1 (224x224x3, 1000 classes, float32,
   random weights from ``--seed``) on ``mx.gpu(0)``, serves it through
   ``serve.InferenceServer`` with buckets (1, 2, 4, 8), submits the
   requests in bursts of 1, 2, 3, 5 and 8, and checks every result
   against a direct batch-1 forward, zero dispatch errors, no quarantine,
   zero steady-state recompiles and 16 kernel launches per dispatch.  Each
   bucket runs as a CUDA graph (``AotModel.compile_all`` captures them on
   the dispatcher thread), the launches credited per replay; it checks
   that every bucket was captured and that the bucket-8 graph gives the
   bits of its body run eagerly, and prints the bucket-8 call graphed
   beside eager and each capture's seconds.  Then the hybridized forward
   (``hybrid_forward_phase``): ResNet-50 v1 as ``bench.py:bench_inference``
   builds it, batch 32, ``hybridize()``: 13 calls through ``_CachedGraph``
   (one capture reported), 16 epilogue launches a call, every output the
   bits of the same net's eager forward, two calls never the same tensor;
   ms graphed beside eager, capture seconds and peak memory;
5. training phase: ResNet-50 v1 at full width (Xavier weights from
   ``--seed``) trained on ``mx.gpu(0)`` through ``autograd.record``,
   ``backward`` and ``gluon.Trainer`` (SGD, lr 0.1, momentum 0.9, wd 1e-4,
   softmax cross entropy) on one fixed batch of 32 synthetic images fed by
   ``io.NDArrayIter``: 3 warm-up and 10 timed steps.  It checks that every
   loss is finite and the lowest of the last five is 10% below the first,
   that each step launches the forward and the backward epilogue kernel 16
   times each, that the moving statistics moved, and that one step on the
   card matches the same step on the CPU (batch 2, same weights, the plain
   versions there);
6. BERT kernel phase: holds the flash-attention forward and the LayerNorm
   forward against their plain versions (BERT-base's shapes and masks,
   causal, segments, kv_lens of 0 and past Tk, ragged T, Tq != Tk, D = 128,
   T = 2048, float32, and the edges of the bf16 kernel's tile ring: Tk of
   1, 63 and 129, kv_lens on tile edges and 0, causal with Tq != Tk, D 128
   at T 1024, D 80; LayerNorm also at 1, 9 and 1057 rows, C 2048 and C
   1001, and float16 x with float16 and with float32 affine at BERT's
   (12288, 768) and the MLM head's (1824, 768), forward and backward,
   within 1e-5 plus one float16 ulp; attention in float16 at BERT's
   shape, at T 2048 D 128 causal and
   with segments, ragged T and kv_lens on tile edges, and D 160, 192 and
   256 in float32, bfloat16 and float16 with the masks and ragged T, and
   at BERT-base's width as 4 heads of 192 and 3 of 256: ``WIDE_CASES``,
   for the backward and the (B, T, H, D) entries too), times them beside
   their bounds and the one PyTorch
   call that computes the same function (scaled_dot_product_attention,
   layer_norm; yardsticks the port never calls), and times the kernel and
   the composed attention side by side at S = 64 and 128;
7. BERT phase (``MXNET_FUSED_LAYERNORM=1``): BERT-base (12 layers, 768
   units, 12 heads, the full 30522-word MLM decoder on 76 masked positions
   a row) built as ``bench.py`` builds it, Xavier weights from ``--seed``,
   cast to bfloat16, batch 24 x 512 with ``bench.py``'s valid lengths,
   through ``Block.__call__``: 3 warm-up and 10 timed forwards.  It checks
   12 (B, T, H, D) attention launches (none of the (B, H, T, D) kernel)
   and 26 LayerNorm launches a forward, finite outputs, the
   bf16 sequence output against the same net's float32 forward, and a
   float32 forward on the card against the same forward on the CPU (batch
   2, S 128, pooler and decoder), and prints one forward on the default
   (composed) LayerNorm route beside it;
7b. array phase (``array_phase``): (a) every op that ``ops/elemwise.py``,
   ``ops/matrix.py`` and ``ops/random_ops.py`` register, once on the card
   through ``mx.nd`` against the same call with ``ctx=mx.cpu()`` (the case
   table checked against the registry; exact for integer, index, shape,
   comparison and ordering results, ``ARRAY_*`` tolerances for floats, the
   samplers' shape, dtype, device and support), printed as ``array ops on
   the card: N of N``; (b) BERT-base's masked-LM evaluation on the bf16
   logits of phase 7 (``topk`` k 5, ``pick`` of the labels,
   ``broadcast_equal`` top-1/top-5 hits, ``one_hot`` to 30522, ``argsort``
   over the vocabulary), the same logits through the port on the CPU to
   the same bits, ties included; ``dot`` at (12288, 768) x (768, 3072) in
   float32 and bf16, with and without ``transpose_b``; ``take`` of the
   word embedding by the batch's ids; ``Reshape`` by (0, 0, -4, 12, -1);
   ``exp``, ``erf``, ``rsqrt`` and ``clip`` on the FFN activation;
   ``gather_nd``/``scatter_nd`` at the masked positions; the samplers at
   full size (25.6 M normal draws, 10**7 of each other distribution,
   ``multinomial`` over 30522 classes, ``shuffle`` of 50,000 rows) with
   their mean and variance within 5 standard errors, reseeding to the
   same bits, and a hybridized block drawing ``F.random.normal`` anew on
   each graph replay; (c) the device ms of each full-width case beside the
   plain torch call the op wraps (CUDA events, median of 30) and the host
   µs of a ``mx.nd`` dispatch of a one-element op (median of 1000), eager
   and under ``amp.init``; no hand-written kernel launches on this path;
8. BERT backward kernel phase: holds the flash-attention backward and the
   LayerNorm backward against their plain versions (the same cases as the
   forwards, T = 4096, and the edges of the attention backward's tile
   ring: Tk of 1, 63, 65 and 129, kv_lens on a tile edge and 0, causal
   with Tq != Tk, D 128 at T 1024, D 80), checks that a second run gives
   the same bits and that dk and dv are 0 past each row's valid length,
   and times them beside their bounds and the backward of the same
   PyTorch calls;
9. BSHD phase (``attention_bshd_cases``): holds the (B, T, H, D)
   flash-attention forward and backward against their plain versions,
   at BERT-base's shape and valid lengths with q, k and v as strided views
   of one (B, T, 3 H D) projection output and the backward writing into
   views of one such gradient, at (1, 2048, 16, 128) causal, (2, 1024, 8,
   128) float32, D 80 (padded), Tk 65 and 129, and kv_lens 0 and on tile
   edges: the backward twice to the same bits, exact zeros past the valid
   lengths; times both beside their bounds and scaled_dot_product_attention
   on the same strided views; then the attention sublayer at BERT's shape
   (projection output in, (B, L, E) out, forward and backward) through the
   (B, T, H, D) kernels and through the (B, H, T, D) op on transposed
   views, side by side (the data of the layer's choice); then the public
   ops under autograd (``nd.flash_attention_bshd`` and
   ``nd.flash_attention`` on transposed views, at BERT's shape and at T
   2048, D 128, causal, in bf16 and in float16, and at D 192 and 256 at
   BERT-base's width), each variant's launches counted from 0, the two
   ops' outputs and gradients held to each other;
10. BERT training phase (``MXNET_FUSED_LAYERNORM=1``): BERT-base as in 7,
   bf16, trained through ``autograd.record``, ``backward`` and
   ``gluon.Trainer`` (Adam, lr 1e-4, bf16 state, as bench.py's config-5
   step) on the masked-LM loss of 24 x 512 tokens with random labels: 3
   warm-up and 10 timed steps.  It checks 12 (B, T, H, D) attention and 26
   LayerNorm launches a step, forward and backward each (none of the (B,
   H, T, D) attention kernels), finite losses that fall,
   a finite gradient for every parameter after the first step (non-zero
   for every one the batch reaches), and one f32 step on the card against
   the same step on the CPU (batch 2, S 128, same weights), with the
   CPU's own 1-thread-vs-N-thread floor printed beside it;
10b. mixed-precision phase (``bert_amp_phase``): BERT-base's MLM
   step under ``contrib.amp``: float32 Xavier weights, ``amp.init``,
   ``Adam(learning_rate=1e-4)``, ``amp.init_trainer`` and
   ``amp.scale_loss`` around ``backward``, as GluonNLP's fp16 pretraining
   runs it, at 24 x 512: 13 steps under ``amp.init("float16")`` (the step
   ms the median of the last 10; the loss scale after each step and the
   steps skipped for overflow printed), then 3 under ``"bfloat16"``.  It
   checks 12 + 12 (B, T, H, D) attention launches a step in the target
   dtype (a spy reads the dtype the entry gets) and 26 + 26 float32
   LayerNorm launches, finite and falling losses over the steps taken,
   float32 weights and Adam state, and one step of a 2-layer BERT on the
   card against the same step on the CPU (``AMP_PARITY_*``, the CPU's
   1-thread floor printed beside it).  Then the wide head dims
   (``wide_encoder_phase``): BERT-base's network with 4 heads of 192 and
   3 of 256, bf16, 24 x 512, one forward and one Adam step each, every
   launch count checked and the loss finite;
10c. float16 phase (``float16_phases``): models cast whole with
   ``net.cast("float16")`` (BatchNorm keeps float32 parameters), under
   ``cudnn.deterministic``: a narrow ResNetV1's eval logits and two
   ``DataParallelStep`` SGD steps (``multi_precision``) on the card
   against the CPU, then ResNet-50 v1 built as ``bench.py``'s
   ``bench_inference`` builds it: the batch-128 eval forward hybridized
   (one CUDA graph, 16 float16 epilogue launches a call, the eager
   forward's bits), the same net served by a float16 ``AotModel`` (64
   float32 requests in bursts, cast into the float16 batch by the
   server, 16 launches a dispatch, every bucket dispatched and graphed,
   p50/p99), and its ``DataParallelStep`` at batch 32 as
   ``_build_train_step(dtype="float16")`` builds it with
   ``multi_precision`` (graphed against eager to the same bits, 16 + 16
   launches a step, float32 masters whose float16 rounding the weights
   are); then a 2-layer BERT's logits and two Adam steps on the card
   against the CPU, and BERT-base as ``_build_bert_step(dtype=
   "float16")`` builds it: the MLM forward hybridized (12 attention and 26
   LayerNorm launches a forward) and its ``DataParallelStep`` with
   ``Adam(multi_precision=True)`` graphed against eager (12 + 12 and
   26 + 26 a step).  A spy checks that no plain version got a CUDA operand
   and that only float16 operands reached the kernels' wrappers;
10d. float32 BERT-base phase (``f32_bert_phase``, TF32 off): BERT-base
   as ``_build_bert_step(dtype="float32")`` builds it at 24 x 512, its
   hybridized MLM forward (12 float32 attention and 26 LayerNorm launches
   a forward) and its ``DataParallelStep`` Adam step (lr 1e-4, 12 + 12
   and 26 + 26 a step), each graphed against eager, the loss falling;
   ``--profile`` adds the float32 attention kernels' share of each one's
   device time;
11. data-parallel phase (``dp_phases``; it joins a one-rank NCCL group
   with ``mx.parallel.initialize()``, the only group one card allows, and
   leaves it at the end): one f32 ``parallel.DataParallelStep`` of a
   2-layer BERT (BERT-base's widths) on the card against the same step on
   the CPU (batch 2, S 128, the BERT training tolerances, the CPU's
   1-thread floor printed beside them); then BERT-base built as
   ``bench.py:_build_bert_step`` builds it (Xavier weights and deferred
   shapes on the host, bf16, ``reset_ctx`` onto the card) trained through
   ``DataParallelStep`` (Adam, lr 1e-4, the masked-LM loss) at 24 x 512: 3
   warm-up and 10 timed steps without a mesh, then the same from the same
   weights on the NCCL mesh with ``shard_optimizer=True``, which must give
   the same bits; 12 (B, T, H, D) attention and 26 LayerNorm launches a
   step each way in both, falling losses; every ``DataParallelStep`` runs
   as one CUDA graph a key, the launches credited per replay
   (``graphed_vs_eager``: for BERT without a mesh, BERT with ZeRO on the
   NCCL mesh, ResNet-50 and the LSTM LM in both dtypes, 4 calls through
   the graph under a rate that changes every step against 4 calls of the
   same body run eagerly from the same weights, the same bits, then the
   step ms each way, the capture's seconds and peak memory with the graph
   pool); then ResNet-50 v1 at batch 32 as
   ``bench.py`` builds it (SGD with ``rescale_grad = 1/32``) through
   ``DataParallelStep``, and from the same weights through
   ``Trainer(kvstore="nccl")``, 16 forward and 16 backward epilogue
   launches a step each.  It prints step ms, tokens or images/s, peak
   memory and the optimizer state's bytes beside the Trainer-driven steps
   of the same run, and, under ``--profile``, the device time of the NCCL
   kernels a step;
12. LSTM LM phase (``lstm_lm_phase``, after the group is left): one f32
   ``DataParallelStep`` of a narrow 2-layer LSTM LM on the card (cuDNN's
   LSTM, TF32 off) against the same step on the CPU (torch's native
   cells), updates within a relative L2 error of 1e-3; then
   ``BASELINE.json`` config 4 built as ``bench.py:bench_lstm_lm`` builds it
   (``Embedding(10000, 650)``, a 2-layer NTC LSTM of 650, ``Dense(10000)``,
   softmax cross entropy, SGD lr 1.0 with ``rescale_grad = 1/32``; Xavier
   weights on the host, ``cast`` for bf16, ``reset_ctx`` onto the card)
   trained through ``DataParallelStep`` at 32 x 35 tokens in float32 and
   bfloat16 (cuDNN's LSTM both, ``ops/rnn.py:backend``): 6 warm-up and 20
   timed steps each, the step ms, tokens/s and samples/s printed, the
   float32 cross entropy of the logits falling in both and the float32
   step losses falling, and the device and host time of cuDNN's weight
   compaction a call;
   then the word-LM example's model (tied, dropout 0.2, SGD lr 20 with
   ``clip_gradient`` 0.25, its default sizes) on its synthetic corpus
   through ``LanguageModelDataset`` for 60 steps, its loss falling, and
   its dropout inside the captured step: two replays from the same weights
   draw different masks, the same ``mx.random.seed`` draws them again.
   ``--profile`` adds the step's device busy and idle share and the RNN
   kernels that ran, which must be cuDNN's where ``backend`` says cuDNN
   and torch's native cells' where it says native;
12b. layers phase (``nn_layers_phase``, run on the one-rank NCCL group of
   phase 11 before it is left): every op that the layers slice added to
   ``ops/nn.py`` and the pooling cases it opened (average, sum and lp
   pooling, the ``full`` convention, pads above half the kernel, integer
   max), at the zoo's feature-map shapes, on the card against the same
   op on the port's CPU, forward and backward within ``NN_RTOL``
   (``SoftmaxOutput``'s own backward at (128, 1000) with ``ignore_label``
   under each normalization, ``Deconvolution`` through ``conv_transpose``
   and, with ``adj`` at the stride, composed; ``SyncBatchNorm`` with its
   statistics all-reduced on the NCCL group), each op's device ms beside
   the plain torch call that computes the same thing; no hand-written
   kernel launches on this path;
12c. vision zoo phase (``vision_zoo_phase``, under the ``_PlainOnCard``
   spy): one hybridized batch-2 eval forward of ResNet-50 v2, VGG-16 with
   BatchNorm, AlexNet, SqueezeNet 1.1, DenseNet-121, Inception v3 (299 x
   299), MobileNet 1.0 and MobileNet v2 1.0 at full width on the card
   against the CPU (``ZOO_PARITY_RTOL``); the reference's published
   inference configurations (Inception v3 at batch 128, VGG-16 at batch
   32, ResNet-152 v1 at batch 128 with 50 epilogue launches a forward)
   hybridized, eager against graphed, images/s, capture seconds and peak
   memory; Inception v3 trained at batch 128 through ``DataParallelStep``
   with ``train_imagenet.py``'s SGD for 13 steps graphed against eager,
   the loss falling; one ResNet-50 v2 SGD step at batch 2 on the card
   against the CPU.  ``--profile`` adds the top device operations of the
   batch-128 forwards and of the Inception step;
12d. rest-of-training phase (``training_rest_phase``, on the same NCCL
   group, TF32 off): BERT-base as ``bench.py:_build_bert_step`` builds it
   (bf16, 24 x 512, ``MXNET_FUSED_LAYERNORM=1``) through
   ``DataParallelStep`` with ``AdamW(learning_rate=1e-4, wd=0.01)``: one
   f32 2-layer step on the card against the CPU, 13 steps without a mesh
   and 13 with ZeRO on the one-rank mesh (the same bits, the loss falling,
   Adam's 12 + 12 attention and 26 + 26 LayerNorm launches a step), the
   step graphed against eager (the same bits); ResNet-50 v1 (with a
   softmax) through ``Estimator.fit`` with ``Trainer(..., "nadam")``, 2
   epochs of 4 batches of 32 synthetic images from a ``DataLoader`` with 2
   worker processes (``RandomFlipLeftRight``, ``ToTensor``,
   ``Normalize``), Accuracy, TopKAccuracy(5), CrossEntropy,
   ``CheckpointHandler`` and ``EarlyStoppingHandler``: the loss falling,
   16 + 16 epilogue launches a step, the step's ms and the loop's wait on
   the loader, the last checkpoint read back; each of the 13 new rules'
   ``Trainer.step`` over ResNet-50 v1's parameters against the CPU (SGLD
   by the moments of its noise); each new loss forward and backward at
   (32, 1000) (CTC at T 100, N 32, C 28, L 20) and each new metric on the
   card against the CPU;
12e. symbolic phase (``symbolic_phase``, TF32 off): ``train_imagenet.py
   --network resnet50 --benchmark 1`` through ``Module.fit`` (the graph of
   ``example/image_classification/symbols.py`` written against the port's
   ``mx.sym`` as ``resnet_symbol``; batch 64 of synthetic 224 x 224 images
   from ``--seed``, 1000 classes, SGD lr 0.1, momentum 0.9, wd 1e-4,
   ``Speedometer`` and ``do_checkpoint`` into a temporary directory, one
   epoch of 6 batches): the median step after 2 and images/s, the
   checkpoint read back by ``load_checkpoint`` to the module's bits and
   resumed by ``Module.load`` for 2 batches, one batch-4 step on the card
   against the CPU; BERT-base as one Symbol graph (``bert_symbol``: the
   q/k/v projection split into (B, T, H, D) views for
   ``flash_attention_bshd``, ``MXNET_FUSED_LAYERNORM=1``) trained through
   ``Module`` with Adam at 24 x 512 for 4 steps in float32 and after
   ``amp.convert_model(..., "bfloat16")`` from the same weights: 12 + 12
   attention (float32, then bfloat16) and 26 + 26 float32 LayerNorm
   launches a step, falling losses, ``SymbolBlock.imports`` of the float32
   checkpoint giving the Module's forward bits, and a 2-layer version on
   the card against the CPU; ``example/rnn/bucketing_lm``'s graph at the
   LSTM LM's width through ``BucketingModule`` over the buckets 8, 12, 16
   and 24 (2 batches each, the parameters shared, the perplexity);
   BERT-base's float32-weight ``DataParallelStep`` under
   ``amp.init("bfloat16")``, graphed against eager to the same bits;
12f. compiled training phase (``compiled_training_phase``, TF32 off): each
   path 5 steps through CUDA graphs and 5 eagerly from the same weights
   (``hybridize(False)`` inside ``cuda_graph.disabled()``), the same bits
   for every loss and every weight and state after them, the launches a
   step after the first (twice that in the first: its warm-up), and no
   graph built after the first step: BERT-base bf16 as
   ``bench.py:_build_bert_step`` builds it (24 x 512, Adam lr 1e-4)
   hybridized through ``record()``, ``backward()`` and ``Trainer.step``
   (the block's forward/backward pair and the update's graph; 12 + 12
   (B, T, H, D) attention and 26 + 26 LayerNorm launches a step), with
   the 'write' hooks' copies into the stable gradient buffers timed, and
   one hybridized f32 step at batch 2 against the CPU; ResNet-50 v1 at
   batch 32 (SGD lr 0.1, momentum 0.9, wd 1e-4, ``cudnn.deterministic``)
   in the same loop (16 + 16 epilogue launches a step, the running
   statistics the eager run's bits), one hybridized step at batch 2
   against the CPU; first, on an MLP, the recorded-call cases graphed
   against eager to the bits (``ct_recorded_cases``: two calls of one key
   with a backward each, in either order; ``create_graph``; dropout
   replays, each gradient its own mask); the symbolic BERT-base after
   ``amp.convert_model(..., "bfloat16")`` and ``train_imagenet.py``'s
   ResNet-50 (batch 32) through ``Module.fit`` on the captured Executor,
   the 2-layer symbolic BERT's graphed step against the CPU.  Prints
   step ms graphed and eager, the warm-up and capture seconds, peak
   memory, the launches a step, the graphs built, and under
   ``--profile`` each way's device busy ms and idle share;
13. prints one JSON line describing each kernel, then as its last line
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero without the ``ok``
line.  Without a CUDA device, or without the package beside it, it exits
non-zero before printing anything on standard output.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

# ResNet-50's BN -> add -> ReLU epilogues, NCHW: (channels and spatial
# size, launches per forward or backward) for stages 1-4
STAGES = [((256, 56, 56), 3), ((512, 28, 28), 4), ((1024, 14, 14), 6),
          ((2048, 7, 7), 3)]
SERVE_BATCH = 8                     # the largest serving bucket
TRAIN_BATCH = 32
IMAGE_SIZE = 224                    # ResNet-50 v1 at full width
SERVE_SHAPES = [((SERVE_BATCH,) + chw, n) for chw, n in STAGES]
TRAIN_SHAPES = [((TRAIN_BATCH,) + chw, n) for chw, n in STAGES]
# the cases of each kernel beyond the path's own shapes:
# (name, shape, channel axis, dtype name, element offset)
EXTRA_CASES = [("nhwc", (8, 28, 28, 512), 3, "float32", 0),
               ("bf16", (8, 256, 56, 56), 1, "bfloat16", 0),
               ("ragged", (3, 7, 13, 11), 1, "float32", 0),
               ("unaligned", (2, 64, 7, 7), 1, "float32", 1)]
WARMUP_STEPS = 3
TIMED_STEPS = 10
# The loss must fall: the lowest of the last five steps at least 10% below
# the first step's.  Not the last step alone: at lr 0.1, eight times the
# linear-scaling rate for batch 32, the loss on the fixed batch oscillates
# from step to step, and the trajectory differs between runs (max-pool's
# backward and cuDNN's weight gradients sum in a run-dependent order).  One
# of four runs on an H100 ended at 7.89 against a first loss of 7.85 after
# reaching 5.05 two steps before (PERF.md).
LOSS_WINDOW = 5
LOSS_DROP = 0.9
# One training step on the card against the same step on the CPU (batch 2,
# same weights).  The loss is held to rel 1e-4.  The updates w1 - w0 are
# held only to a relative L2 error of 5e-2 over all 267 parameters (the
# moving statistics included) and 1e-1 for any one parameter: at batch 2
# from Xavier weights the step's gradients are ill-conditioned sums, so
# that the order of summation alone moves them by about 1e-2 (measured on
# the CPU, one thread against eight: 1.2e-2 over all parameters and 2.1e-2
# for the worst, a BatchNorm beta).  The script measures that floor in
# every run and prints it beside the card's error.  A wrong kernel moves
# gradients by far more: the card with its kernels agreed with the card
# with the plain versions to 2.7e-6 (``chip_diag.py parity``; PERF.md).
PARITY_BATCH = 2
PARITY_LOSS_RTOL = 1e-4
PARITY_UPDATE_REL_L2 = 5e-2
PARITY_PARAM_REL_L2 = 1e-1
# bench.py's train step: SGD with momentum and weight decay
SGD_PARAMS = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
BUCKETS = (1, 2, 4, 8)
BURSTS = (1, 2, 3, 5, 8)
N_REQUESTS = 64
TIMED_ITERS = 30
WARMUP_ITERS = 5
L2_FLUSH_BYTES = 128 << 20          # more than twice the H100's 50 MB L2
SPIN_CYCLES = 100_000_000           # about 50 ms at the H100's clock


# BERT-base as bench.py's config-5 step builds it (bench.py
# _build_bert_step): vocabulary, batch, sequence, masked positions a row
BERT_VOCAB = 30522
BERT_BATCH = 24
BERT_SEQ = 512
BERT_PRED = int(BERT_SEQ * 0.15)        # 76
BERT_HEADS = 12
BERT_UNITS = 768
BERT_LAYERS = 12
BERT_WARMUP = 3
BERT_TIMED = 10
# kernel launches a BERT-base forward makes: one attention per layer; a
# LayerNorm after the embeddings, two per layer and one in the MLM head
BERT_ATTN_PER_FWD = BERT_LAYERS
BERT_LN_PER_FWD = 2 * BERT_LAYERS + 2
# the bf16 forward against the same weights' f32 forward on the card: bf16
# keeps 8 bits of mantissa through 12 layers, so a relative L2 error of a
# few 1e-3 is expected; a wrong kernel gives O(1)
BERT_BF16_REL_L2 = 5e-2
# a f32 forward on the card against the CPU (batch 2, S 128, 77 valid keys
# in row 2, 19 masked positions a row): the same arithmetic summed in
# another order, through 12 layers
BERT_PARITY_REL_L2 = 1e-4
BERT_PARITY_SEQ = 128
BERT_PARITY_LENS = (128, 77)
BERT_PARITY_PRED = 19
# Kernel-vs-plain tolerances.  Attention, f32: o within 2e-5 and lse within
# 1e-5 (absolute; fp32 sums in another order).  bf16: o within 2e-2 of the
# largest |plain value| (P is rounded to bf16 against the running row max
# in the kernel and the final row max in the plain version); lse within
# 1e-5 absolute, as in f32 (the scores and sums are fp32 on both sides).
# LayerNorm, f32: within 1e-5 absolute; bf16: within 1e-5 plus one bf16 ulp
# of the larger value (fp32 values that agree within 1e-5, their statistics
# summed in another order, each rounded once: near 0 a bf16 ulp is far
# below 1e-5, so an ulp count alone would not do); mu and rstd within 1e-5
# relative.  float16 as bf16, with one float16 ulp.
ATTN_F32_O, ATTN_F32_LSE, ATTN_BF16_REL = 2e-5, 1e-5, 2e-2
# float16 keeps three more bits of mantissa than bf16, so its roundings
# (the same points) move o an eighth as far: 2e-2 / 4 leaves a factor of 2
ATTN_F16_REL = 5e-3
LN_F32_ABS, LN_STAT_REL = 1e-5, 1e-5
BF16_PEAK_OPS = 989e12                  # H100 SXM tensor cores, dense (bf16
                                        # and fp16 alike)
# float32 on the tensor cores: 495 TFLOP/s of TF32, dense, three TF32
# products for each float32 product (the float32 kernels' split)
TF32_PEAK_OPS = 495e12
# The backward kernels against their plain versions.  Attention: dq, dk and
# dv within 1e-5 of the largest |plain value| in f32 (three TF32 products
# for each float32 product, each tile's sums started from 0 on the tensor
# cores and added in fp32; 3.3e-6 to 6.5e-6 measured, 6.1e-6 at T 1024)
# and 1e-2 in bf16 (p and ds are rounded to bf16
# before their products on both sides, from fp32 values summed in another
# order, so a rounding can fall either way: an ulp is 2**-8 of a value;
# 3.3e-3 measured).  LayerNorm: dx as the forward's y; dgamma and dbeta
# within rel 1e-5 of their largest entry (fp32 sums over up to 12288 rows
# in another order; 6e-7 measured).  Both kernels must give the same bits
# on a second run (no atomics).
ATTN_BWD_F32_REL, ATTN_BWD_BF16_REL, LN_SUM_REL = 1e-5, 1e-2, 1e-5
# float16: a quarter of bf16's tolerance (its ulp is an eighth)
ATTN_BWD_F16_REL = 2.5e-3
# dq and dk with one key a row (0 in exact arithmetic): within this
# fraction of the largest |dv|
ATTN_BWD_ONE_KEY_REL = 1e-5
# BERT-base training, bench.py's config-5 step: Adam, lr 1e-4, no
# multi_precision (the bf16 weights and their bf16 Adam state updated in
# bf16), the masked-LM loss averaged over the 1,824 masked rows
BERT_LR = 1e-4
BERT_TRAIN_WARMUP = 3
BERT_TRAIN_TIMED = 10
# the one parameter bench.py's batch (no token types) never reaches: its
# gradient stays 0, and step(ignore_stale_grad=True) leaves it alone, as the
# JAX step's zero gradient leaves it unchanged
BERT_UNREACHED = ("type_embed.weight",)
# The loss must fall: the lowest of the last five steps at least 0.5 below
# the first.  On one fixed batch with random labels it fell from 10.35 to
# 8.95 in 13 steps on an H100 (PERF.md): a third of that fall.
BERT_LOSS_FALL = 0.5
# One f32 Adam step on the card against the CPU (batch 2, S 128, the same
# weights): the loss within rel 1e-5; the updates w1 - w0 within a relative
# L2 error of 1e-3 over all parameters and 1e-2 for any one.  One Adam step
# moves a weight by about lr * g / (|g| + 3e-7), so only gradients near 0,
# whose sign the order of summation decides, move the updates at all.
# Measured on an H100 (PERF.md): the card 2.7e-5 over all parameters
# and 7.6e-4 for the worst (an FFN LayerNorm beta), against a floor (the
# CPU on 1 thread against 8) of 2.1e-5 and 3.5e-4; the script measures the
# floor in every run and prints it beside the card's error.  A wrong
# gradient moves the updates by O(1).
BERT_TRAIN_PARITY_LOSS_RTOL = 1e-5
BERT_TRAIN_PARITY_UPDATE_REL_L2 = 1e-3
BERT_TRAIN_PARITY_PARAM_REL_L2 = 1e-2
# kernel launches a training step makes: each forward launch has its
# backward
BERT_ATTN_PER_STEP = BERT_ATTN_PER_FWD
BERT_LN_PER_STEP = BERT_LN_PER_FWD


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line():
    """``name, power.limit`` of the card as nvidia-smi prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def memory_bytes_per_s(name):
    """Published device-memory rate of the card (NVIDIA data sheets)."""
    if "PCIe" in name:
        return 2.0e12
    if "NVL" in name:
        return 3.9e12
    if "H200" in name:
        return 4.8e12
    return 3.35e12                    # H100 SXM (HBM3)


def fp32_ops_per_s(name):
    """Published fp32 rate outside the tensor cores."""
    return 51e12 if "PCIe" in name else 67e12


def time_cuda(torch, fn, flush):
    """Median device milliseconds of ``fn()`` over TIMED_ITERS launches,
    each between its own CUDA events and preceded by an L2 flush.  The flush
    READS a buffer larger than L2, so the kernel finds clean lines (a
    zero-fill would leave dirty lines whose write-back the kernel would
    pay).  A spin kernel holds the card while the host enqueues every
    launch, so the events time the device work and not the host's launch
    overhead."""
    for _ in range(WARMUP_ITERS):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_ITERS)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_ITERS)]
    torch.cuda._sleep(SPIN_CYCLES)
    for s, e in zip(starts, ends):
        flush.sum()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def host_us(torch, fn):
    """Host microseconds per call of ``fn()`` (launch overhead: wrapper
    checks, allocation, the launch itself), with the card kept busy."""
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    t0 = time.perf_counter()
    for _ in range(TIMED_ITERS):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / TIMED_ITERS * 1e6


def _prod(shape):
    n = 1
    for d in shape:
        n *= d
    return n


def _operands(torch, gen, shape, axis, dtype, offset):
    """x, r, ct in ``dtype`` (offset by ``offset`` elements from an aligned
    start) and fp32 per-channel scale/shift on the card."""
    dev = torch.device("cuda", 0)
    n = _prod(shape)

    def rand():
        v = torch.randn(n + offset, device=dev, generator=gen)
        return v.to(dtype)[offset:].view(shape)
    c = shape[axis]
    x, r, ct = rand(), rand(), rand()
    s = torch.rand(c, device=dev, generator=gen) + 0.5
    t = torch.randn(c, device=dev, generator=gen) * 0.1
    return n, c, x, r, ct, s, t


def _elementwise_err(torch, what, got, want):
    """max |got - want|; f32 must agree within 1e-6 of the largest |want|
    (the kernels round each operation as the plain versions do), bf16 and
    f16 within 1 ulp (the same fp32 value rounded once)."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          "%s: kernel gave %s %s" % (what, tuple(got.shape), got.dtype))
    err = (got.float() - want.float()).abs().max().item()
    if got.dtype == torch.float32:
        tol = 1e-6 * want.abs().max().item()
        check(err <= tol, "%s: max|kernel-plain| %.3g > %.3g" % (what, err,
                                                                tol))
    else:
        ulps = (got.view(torch.int16).int()
                - want.view(torch.int16).int()).abs().max().item()
        check(ulps <= 1, "%s: kernel is %d %s ulps from plain"
              % (what, ulps, str(got.dtype).replace("torch.", "")))
    return err


def kernel_phase(torch, fused_norm, card, flush):
    """Each kernel against its plain version, with timings and bounds:
    the forward at the serving and training shapes, the backward at the
    training shapes, both with the extra cases.  Launches made here are
    comparisons, not the main path: the paths reset the counts."""
    gen = torch.Generator(device="cuda").manual_seed(1234)
    # bring the card to its working clocks first: the first case timed on
    # an idle card read twice its later time in two of three runs
    for _ in range(300):
        flush.sum()
    torch.cuda.synchronize()
    bw = memory_bytes_per_s(card)
    peak = fp32_ops_per_s(card)
    fwd, fwd_plain = (fused_norm.fused_bn_add_relu_epilogue,
                      fused_norm.fused_bn_add_relu_epilogue_plain)
    bwd, bwd_plain = (fused_norm.fused_bn_add_relu_epilogue_bwd,
                      fused_norm.fused_bn_add_relu_epilogue_bwd_plain)
    extras = [(kind, shape, axis, getattr(torch, dt), off, None, 0)
              for kind, shape, axis, dt, off in EXTRA_CASES]
    fwd_cases = [("nchw", shape, 1, torch.float32, 0, "serve", n)
                 for shape, n in SERVE_SHAPES]
    fwd_cases += [("nchw", shape, 1, torch.float32, 0, "train", n)
                  for shape, n in TRAIN_SHAPES]
    bwd_cases = [("nchw", shape, 1, torch.float32, 0, "train", n)
                 for shape, n in TRAIN_SHAPES]
    # float16: the forward at bucket 8's and the batch-128
    # forward's shapes, the backward at the batch-32 step's
    fwd_cases += [("nchw", shape, 1, torch.float16, 0, path, n)
                  for path, shapes in (("serve_f16", SERVE_SHAPES),
                                       ("infer_f16", INFER_F16_SHAPES))
                  for shape, n in shapes]
    bwd_cases += [("nchw", shape, 1, torch.float16, 0, "train_f16", n)
                  for shape, n in TRAIN_SHAPES]
    # ResNet-152 v1's batch-128 forward (the vision zoo phase)
    fwd_cases += [("nchw", shape, 1, torch.float32, 0, "infer152", n)
                  for shape, n in INFER152_SHAPES]
    rows = {"fwd": [], "bwd": []}
    for direction, cases in (("fwd", fwd_cases + extras),
                             ("bwd", bwd_cases + extras)):
        for kind, shape, axis, dtype, offset, path, per_pass in cases:
            n, c, x, r, ct, s, t = _operands(torch, gen, shape, axis, dtype,
                                             offset)
            what = "%s %s %s %s" % (direction, kind, shape, dtype)
            with torch.inference_mode():
                if direction == "fwd":
                    def k_fn():
                        return fwd(x, s, t, r, axis)

                    def p_fn():
                        return fwd_plain(x, s, t, r, axis)
                    err = _elementwise_err(torch, what, k_fn(), p_fn())
                    rel_sums = None
                    nbytes = 3 * n * x.element_size() + 2 * c * 4
                    ops = 4 * n
                else:
                    y = fwd_plain(x, s, t, r, axis)

                    def k_fn():
                        return bwd(x, s, y, ct, axis)

                    def p_fn():
                        return bwd_plain(x, s, y, ct, axis)
                    got, again, want = k_fn(), k_fn(), p_fn()
                    torch.cuda.synchronize()
                    check(all(torch.equal(a, b) for a, b in zip(got, again)),
                          "%s: two runs differ" % what)
                    err = max(_elementwise_err(torch, what + " dx", got[0],
                                               want[0]),
                              _elementwise_err(torch, what + " dr", got[1],
                                               want[1]))
                    rel_sums = 0.0
                    for name, a, b in (("dscale", got[2], want[2]),
                                       ("dshift", got[3], want[3])):
                        check(a.dtype == torch.float32 and a.shape == (c,),
                              "%s %s: %s %s" % (what, name, a.dtype,
                                                tuple(a.shape)))
                        e = (a - b).abs().max().item()
                        rel = e / max(b.abs().max().item(), 1e-30)
                        # only the order of the channel sums differs
                        check(rel <= 1e-5, "%s %s: rel err %.3g > 1e-5"
                              % (what, name, rel))
                        err = max(err, e)
                        rel_sums = max(rel_sums, rel)
                    nbytes = 5 * n * x.element_size() + 3 * c * 4
                    ops = 5 * n
                ms, plain_ms = (time_cuda(torch, k_fn, flush),
                                time_cuda(torch, p_fn, flush))
                k_host, p_host = host_us(torch, k_fn), host_us(torch, p_fn)
            bound_ms = max(nbytes / bw, ops / peak) * 1e3
            row = {"case": kind, "path": path, "shape": list(shape),
                   "dtype": str(dtype).replace("torch.", ""),
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bytes": nbytes,
                   "launches_per_pass": per_pass, "host_us": k_host,
                   "plain_host_us": p_host}
            if rel_sums is not None:
                row["max_rel_err_sums"] = rel_sums
            rows[direction].append(row)
            print("kernel %s %-9s %-5s %-20s %-8s err %.3g  kernel %.4f ms  "
                  "plain %.4f ms  bound %.4f ms  host/call kernel %.1f us "
                  "plain %.1f us  (%s)"
                  % (direction, kind, path or "-", shape, row["dtype"], err,
                     ms, plain_ms, bound_ms, k_host, p_host, card))
    return rows


def covered_ms(spans):
    """The time, in ms, that the (start, end) spans in microseconds cover
    together: where spans overlap, the time counts once."""
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


def profile_calls(torch, fn, label, calls=5):
    """torch.profiler over ``calls`` calls of ``fn`` (each ending in a
    host sync): the wall time per call, the device's busy time per call
    (the time that some kernel, copy or memset is on the device: the union
    of their spans in the trace, so a kernel launched as a programmatic
    dependent, whose span starts while the one before it still runs, is
    not counted twice), the spans' sum beside it, and the kernels that
    take the time (each its spans summed): the first 16 under ``top``,
    names cut to 90 characters, and all of them under ``kernels``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    avgs = prof.key_averages()
    key = "self_device_time_total" if hasattr(avgs[0], "self_device_time_total") \
        else "self_cuda_time_total"
    device = [a for a in avgs if getattr(a, key) > 0
              and getattr(a, "device_type", None) is not None
              and "CUDA" in str(a.device_type)]
    sum_ms = sum(getattr(a, key) for a in device) / 1e3 / calls
    busy_ms = covered_ms(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if "CUDA" in str(getattr(e, "device_type", None))) / calls
    every = [(a.key, getattr(a, key) / 1e3 / calls, a.count // calls)
             for a in sorted(device, key=lambda a: -getattr(a, key))]
    return {"label": label, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_span_sum_ms": sum_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "top": [(n[:90], ms, k) for n, ms, k in every[:16]],
            "kernels": every}


def serving_phase(torch, mx, fused_norm, seed, n_requests, profile=False):
    """ResNet-50 v1 served through InferenceServer; returns the numbers."""
    import numpy as onp
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1

    mx.random.seed(seed)
    net = resnet50_v1()
    net.initialize(ctx=mx.gpu(0))
    rng = onp.random.RandomState(seed)
    inputs = rng.uniform(-1, 1, (n_requests, 3, 224, 224)).astype("float32")
    return serve_requests(torch, mx, fused_norm, net, inputs, "resnet50_v1",
                          1e-4, profile=profile)


def serve_requests(torch, mx, fused_norm, net, inputs, name, tol,
                   profile=False, dtype="float32"):
    """``net`` (on the card) served through ``InferenceServer`` by
    ``AotModel.from_block(net, inputs.shape[1:], dtype=dtype)``: the
    requests ``inputs`` submitted in bursts as the clients send them (the
    server casts each row into the ``dtype`` batch), every result against
    a batch-1 forward of the same net within ``tol`` of its largest
    |logit|, zero dispatch errors, no quarantine, zero steady-state
    recompiles, 16 launches a dispatch, every bucket dispatched and
    captured and the bucket-8 graph the bits of its body run eagerly;
    returns the numbers."""
    import numpy as onp
    from mxnet_tpu_torch import serve, telemetry
    model = serve.AotModel.from_block(net, inputs.shape[1:], dtype=dtype,
                                      name=name)
    srv = serve.InferenceServer(
        model, config=serve.ServeConfig(buckets=BUCKETS, max_queue=64))
    n_requests = len(inputs)
    t0 = time.perf_counter()
    srv.start()
    start_s = time.perf_counter() - t0
    check(srv.state() == serve.READY, "server not READY after start")
    errors0 = telemetry.counter("serve.dispatch_errors")
    dispatch0 = {b: telemetry.counter("serve.dispatches.b%d" % b)
                 for b in BUCKETS}
    handles = []
    try:
        # the main path: counts from 0 just before, read just after
        fused_norm.LAUNCHES = 0
        i = burst = 0
        while i < n_requests:
            size = min(BURSTS[burst % len(BURSTS)], n_requests - i)
            group = [srv.submit(inputs[j]) for j in range(i, i + size)]
            for h in group:
                h.outcome(timeout=30.0)
            handles += group
            i += size
            burst += 1
        launches = fused_norm.LAUNCHES
        dispatches = {b: telemetry.counter("serve.dispatches.b%d" % b)
                      - dispatch0[b] for b in BUCKETS}
        outs = [h.outcome(timeout=0) for h in handles]
        check(all(o is not None and o[0] == "result" for o in outs),
              "not every request resolved to a result: %r"
              % sorted({(o or ("pending",))[0] for o in outs}))
        check(telemetry.counter("serve.dispatch_errors") == errors0,
              "dispatch errors during serving")
        check(srv.stats()["quarantined"] == [], "a bucket was quarantined")
        check(srv.steady_state_recompiles() == {},
              "steady-state recompiles: %r" % srv.steady_state_recompiles())
        n_dispatch = sum(dispatches.values())
        check(all(dispatches[b] > 0 for b in BUCKETS),
              "not every bucket dispatched: %r" % dispatches)
        check(launches == 16 * n_dispatch,
              "%d kernel launches for %d dispatches (want 16 each)"
              % (launches, n_dispatch))
        first = [round(h.latency_ms(), 3) for h in handles[:6]]
        lat = sorted(h.latency_ms() for h in handles)
        # the model call per bucket, host batch (in the model's dtype, as
        # the server assembles it) in, host logits out
        batches = inputs[:max(BUCKETS)].astype(dtype)
        call_ms = {}
        for b in BUCKETS:
            times = []
            for _ in range(12):
                t = time.perf_counter()
                srv._model.run(b, batches[:b]).cpu()
                times.append(time.perf_counter() - t)
            call_ms[b] = statistics.median(times[2:]) * 1e3
        b8_ms = call_ms[8]
        model = srv._model
        check(model.buckets == sorted(BUCKETS)
              and all(g.graphed for g in model._graphs.values()),
              "not every bucket was captured: %r" % model._graphs)
        x8 = torch.as_tensor(batches[:8])
        eager8 = model._graphs[8].run_eager([x8])[0]
        check(torch.equal(model.run(8, batches[:8]), eager8),
              "the bucket-8 graph and its body run eagerly differ")
        times = []
        for _ in range(12):
            t = time.perf_counter()
            model._graphs[8].run_eager([x8])[0].cpu()
            times.append(time.perf_counter() - t)
        b8_eager_ms = statistics.median(times[2:]) * 1e3
        capture_s = {b: g.capture_s for b, g in sorted(model._graphs.items())}
        profiles = [profile_calls(
            torch, lambda b=b: srv._model.run(b, batches[:b]).cpu(),
            "serving bucket %d" % b) for b in (1, 8)] if profile else []
    finally:
        srv.close()
    # every result against a direct batch-1 forward of the same net
    worst = 0.0
    with torch.inference_mode(), mx.autograd.predict_mode():
        for j, o in enumerate(outs):
            ref = net(mx.nd.array(inputs[j:j + 1], ctx=mx.gpu(0),
                                  dtype=dtype)).astype("float32").asnumpy()[0]
            got = onp.asarray(o[1], "float32")
            check(got.shape == (1000,) and onp.isfinite(got).all(),
                  "%s request %d: bad logits" % (name, j))
            rel = float(onp.abs(got - ref).max() / onp.abs(ref).max())
            worst = max(worst, rel)
    check(worst <= tol, "%s: served logits differ from batch-1 forward: rel "
          "%.3g > %g" % (name, worst, tol))
    return {"start_s": start_s, "launches": launches,
            "dispatches": dispatches, "p50_ms": float(onp.percentile(lat, 50)),
            "p99_ms": float(onp.percentile(lat, 99)),
            "bucket8_ms": b8_ms, "bucket8_images_per_s": 8e3 / b8_ms,
            "bucket8_eager_ms": b8_eager_ms, "capture_s": capture_s,
            "call_ms": call_ms, "first_latencies_ms": first,
            "profiles": profiles,
            "max_rel_err": worst, "requests": len(handles)}


def print_profiles(profiles, card):
    for p in profiles:
        print("profile %s: wall %.3f ms/call, device busy %.3f ms/call "
              "(spans summed %.3f), idle share %.3f (%s)"
              % (p["label"], p["wall_ms"], p["device_busy_ms"],
                 p["device_span_sum_ms"], p["device_idle_share"], card))
        for name, ms, n in p["top"]:
            print("  %-90s %8.3f ms/call  %4d launches/call" % (name, ms, n))


def _param_arrays(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _one_step(mx, net, x, y, batch):
    """One record/backward/Trainer.step on fresh SGD state; the loss."""
    from mxnet_tpu_torch import gluon
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(SGD_PARAMS))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(batch)
    return loss.asnumpy()


def _update_errors(w0, w1, w1_ref):
    """Relative L2 error of the updates ``w1 - w0`` against
    ``w1_ref - w0``: over all parameters together, and each parameter's
    own (worst first)."""
    import numpy as onp
    per_param, err2, ref2 = [], 0.0, 0.0
    for k, w in w0.items():
        du_ref = (w1_ref[k] - w).astype("float64")
        diff = (w1[k] - w).astype("float64") - du_ref
        ref = float(onp.linalg.norm(du_ref))
        err2 += float(onp.sum(diff * diff))
        ref2 += ref * ref
        if ref == 0.0:
            check(onp.array_equal(w1[k], w), "parity: %s moved on one side "
                  "only" % k)
            continue
        per_param.append((float(onp.linalg.norm(diff)) / ref, k))
    per_param.sort(reverse=True)
    return (err2 / ref2) ** 0.5, per_param


def card_vs_cpu_step(torch, mx, net, w0, data, label, make_net=None,
                     floor=True):
    """The same SGD step from the same weights on the card and on the CPU
    (the plain versions there), and, as the floor of what summation order
    alone does, the CPU step again on one thread (unless not ``floor``:
    None then).  ``make_net()`` builds the CPU's net (default ResNet-50
    v1).  Returns the loss rel error and the update errors of the card and
    of the floor."""
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.gluon.utils import load_jax_params
    b = PARITY_BATCH
    gpu_loss = _one_step(mx, net, mx.nd.array(data[:b], ctx=mx.gpu(0)),
                         mx.nd.array(label[:b], ctx=mx.gpu(0)), b)
    w1_gpu = _param_arrays(net)
    cpu_net = (make_net or resnet50_v1)()
    cpu_net.initialize(ctx=mx.cpu())
    with mx.autograd.predict_mode():
        cpu_net(mx.nd.zeros((1,) + tuple(data.shape[1:]), ctx=mx.cpu()))

    def cpu_step():
        load_jax_params(cpu_net, w0)
        loss = _one_step(mx, cpu_net, mx.nd.array(data[:b], ctx=mx.cpu()),
                         mx.nd.array(label[:b], ctx=mx.cpu()), b)
        return loss, _param_arrays(cpu_net)
    cpu_loss, w1_cpu = cpu_step()
    floor_errors = None
    if floor:
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        _, w1_cpu1 = cpu_step()
        torch.set_num_threads(threads)
        floor_errors = _update_errors(w0, w1_cpu1, w1_cpu)
    import numpy as onp
    loss_rel = float(onp.abs(gpu_loss - cpu_loss).max()
                     / onp.abs(cpu_loss).max())
    return (loss_rel, _update_errors(w0, w1_gpu, w1_cpu), floor_errors)


def training_phase(torch, mx, fused_norm, seed, card, profile=False):
    """ResNet-50 v1 training on the card through the Gluon entry points;
    returns the numbers.  The card-vs-CPU step runs first, from the
    initial weights, which the net then gets back for the main path."""
    import numpy as onp
    from mxnet_tpu_torch import gluon, io
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1

    mx.random.seed(seed)
    net = resnet50_v1()
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    with mx.autograd.predict_mode():
        net(mx.nd.zeros((1, 3, IMAGE_SIZE, IMAGE_SIZE), ctx=mx.gpu(0)))
    rng = onp.random.RandomState(seed)
    data = rng.uniform(-1, 1, (TRAIN_BATCH, 3, IMAGE_SIZE, IMAGE_SIZE)) \
        .astype("float32")
    label = rng.randint(0, 1000, TRAIN_BATCH).astype("float32")
    w0 = _param_arrays(net)
    t0 = time.perf_counter()
    loss_rel, (update_rel, per_param), (floor_rel, floor_param) = \
        card_vs_cpu_step(torch, mx, net, w0, data, label)
    parity_s = time.perf_counter() - t0
    print("training: card vs CPU, one step at batch %d: loss rel err %.3g, "
          "update rel L2 err %.3g over all parameters; worst parameters %s"
          % (PARITY_BATCH, loss_rel, update_rel,
             ", ".join("%s %.3g" % (k, e) for e, k in per_param[:4])))
    print("training: floor, CPU on 1 thread vs CPU on %d: update rel L2 err "
          "%.3g over all parameters; worst parameters %s"
          % (torch.get_num_threads(), floor_rel,
             ", ".join("%s %.3g" % (k, e) for e, k in floor_param[:4])))
    check(loss_rel <= PARITY_LOSS_RTOL, "card vs CPU loss rel err %.3g > %g"
          % (loss_rel, PARITY_LOSS_RTOL))
    check(update_rel <= PARITY_UPDATE_REL_L2,
          "card vs CPU update: rel L2 err %.3g > %g"
          % (update_rel, PARITY_UPDATE_REL_L2))
    check(per_param[0][0] <= PARITY_PARAM_REL_L2,
          "card vs CPU update of %s: rel L2 err %.3g > %g"
          % (per_param[0][1], per_param[0][0], PARITY_PARAM_REL_L2))
    for k, p in net._collect_params_with_prefix().items():
        p.set_data(w0[k])

    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(SGD_PARAMS))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    it = io.NDArrayIter(data, label, batch_size=TRAIN_BATCH)
    bn = net._collect_params_with_prefix()["features.1.running_mean"]
    mean0 = bn.data().asnumpy()

    def step():
        try:
            batch = it.next()
        except StopIteration:
            it.reset()
            batch = it.next()
        with mx.autograd.record():
            loss = loss_fn(net(batch.data[0]), batch.label[0])
        loss.backward()
        trainer.step(TRAIN_BATCH)
        return float(loss.mean().asscalar())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts from 0 just before, read just after
    fused_norm.LAUNCHES = 0
    fused_norm.BWD_LAUNCHES = 0
    losses, times = [], []
    for _ in range(WARMUP_STEPS + TIMED_STEPS):
        t = time.perf_counter()
        losses.append(step())
        times.append(time.perf_counter() - t)
    launches = (fused_norm.LAUNCHES, fused_norm.BWD_LAUNCHES)
    peak_bytes = torch.cuda.max_memory_allocated()
    n_steps = WARMUP_STEPS + TIMED_STEPS
    check(all(onp.isfinite(losses)), "non-finite loss: %r" % losses)
    check(min(losses[-LOSS_WINDOW:]) < LOSS_DROP * losses[0],
          "loss did not fall: %r" % losses)
    check(launches == (16 * n_steps, 16 * n_steps),
          "%d forward and %d backward kernel launches in %d steps (want 16 "
          "each a step)" % (launches[0], launches[1], n_steps))
    check(not onp.array_equal(bn.data().asnumpy(), mean0),
          "moving statistics did not change")
    check(all(p.data().astorch().grad_fn is None
              for p in net.collect_params().values()),
          "a parameter keeps a graph after the step")
    step_ms = statistics.median(times[WARMUP_STEPS:]) * 1e3
    profiles = [profile_calls(torch, step, "training step", calls=3)] \
        if profile else []
    return {"losses": losses, "step_ms": step_ms,
            "images_per_s": TRAIN_BATCH * 1e3 / step_ms,
            "step_ms_all": [t * 1e3 for t in times],
            "fwd_launches": launches[0], "bwd_launches": launches[1],
            "steps": n_steps, "peak_bytes": peak_bytes,
            "parity_loss_rel": loss_rel, "parity_update_rel_l2": update_rel,
            "parity_worst_params": per_param[:4],
            "parity_floor_rel_l2": floor_rel,
            "parity_floor_worst": floor_param[:4], "parity_s": parity_s,
            "profiles": profiles}


def bert_inputs(seed):
    """bench.py's config-5 inputs from ``RandomState(seed)``: token ids,
    wikipedia-style valid lengths (the first quarter of the rows full, the
    rest drawn from [seq // 3, seq]) and sorted masked positions within
    the shortest valid length."""
    import numpy as onp
    batch, seq, n_pred = BERT_BATCH, BERT_SEQ, BERT_PRED
    rs = onp.random.RandomState(seed)
    tokens = rs.randint(0, BERT_VOCAB, (batch, seq)).astype("float32")
    lens = rs.randint(seq // 3, seq + 1, (batch,))
    lens[: max(1, batch // 4)] = seq
    pos = onp.stack([rs.choice(int(lens.min()), n_pred, replace=False)
                     for _ in range(batch)])
    return tokens, lens.astype("int32"), onp.sort(pos, 1).astype("int32")


def _rel_l2(got, want):
    import numpy as onp
    got = onp.asarray(got, "float64")
    want = onp.asarray(want, "float64")
    return float(onp.linalg.norm(got - want) / onp.linalg.norm(want))


def _visible_pairs(torch, attention, B, Tq, Tk, causal, lens, qs, ks):
    """How many (query, key) pairs of one head the masks leave visible."""
    mask = attention._visible(B, Tq, Tk, torch.device("cuda", 0), causal,
                              lens, qs, ks)
    if mask is None:
        return B * Tq * Tk
    return int(mask.expand(B, 1, Tq, Tk).sum().item())


# (case, B, H, Tq, Tk, D, dtype, causal, kv_lens, segments); kv_lens
# "bench" is bench.py's draw for batch 24
ATTN_CASES = [
    ("bert", 24, 12, 512, 512, 64, "bfloat16", False, "bench", False),
    ("b32_s128", 32, 12, 128, 128, 64, "bfloat16", False, None, False),
    ("f32", 2, 12, 128, 128, 64, "float32", False, None, False),
    # BERT-base's float32 layer (the float32 BERT phase's shape)
    ("f32_bert", 24, 12, 512, 512, 64, "float32", False, "bench", False),
    ("causal", 2, 12, 512, 512, 64, "bfloat16", True, None, False),
    ("segments", 2, 12, 256, 256, 64, "bfloat16", False, None, True),
    ("lens_0_and_past_tk", 2, 12, 256, 256, 64, "bfloat16", False,
     (0, 1000), False),
    ("ragged_t200", 2, 12, 200, 200, 64, "bfloat16", False, None, False),
    ("tq_ne_tk", 2, 12, 128, 384, 64, "bfloat16", False, (300, 384), False),
    ("d128", 2, 12, 256, 256, 128, "bfloat16", False, None, False),
    ("t2048", 1, 12, 2048, 2048, 64, "bfloat16", False, None, False),
    # the edges of the bf16 kernel's tile ring, as the backward's below
    ("tk1", 2, 3, 64, 1, 64, "bfloat16", False, None, False),
    ("tk63", 2, 3, 100, 63, 64, "bfloat16", False, None, False),
    ("tk129_lens_128", 2, 3, 130, 129, 64, "bfloat16", False, (128, 129),
     False),
    ("lens_on_tile_edges", 3, 4, 256, 256, 64, "bfloat16", False,
     (64, 128, 0), False),
    ("causal_tq_lt_tk", 2, 3, 96, 200, 64, "bfloat16", True, None, False),
    ("causal_tq_gt_tk_lens", 2, 3, 200, 96, 64, "bfloat16", True, (96, 50),
     False),
    ("d128_t1024", 1, 12, 1024, 1024, 128, "bfloat16", False, None, False),
    ("d80", 2, 3, 256, 256, 80, "bfloat16", False, (256, 100), False),
] + [
    # float16 on the Hopper kernels; D 160 (padded to 192), 192 and 256 in
    # every dtype (WIDE_CASES): the Hopper kernels for the 16-bit types, the
    # scalar ones for float32
    ("f16_bert", 24, 12, 512, 512, 64, "float16", False, "bench", False),
    ("f16_t2048_d128_causal", 1, 16, 2048, 2048, 128, "float16", True, None,
     False),
    ("f16_segments_ragged", 2, 12, 200, 200, 64, "float16", False, None,
     True),
    ("f16_lens_on_tile_edges", 3, 4, 256, 256, 128, "float16", False,
     (64, 128, 0), False),
]
# The wide head dims at BERT-base's width (768 units as 4 heads of 192 and
# 3 of 256: the attention layer's work and bytes are BERT-base's), bf16 as
# the wide encoders run them, then each D in each dtype with the masks and
# ragged T; the same cases for both entries and both directions
WIDE_CASES = [
    ("d192_bert", 24, 4, 512, 512, 192, "bfloat16", False, "bench", False),
    ("d256_bert", 24, 3, 512, 512, 256, "bfloat16", False, "bench", False),
] + [
    ("d%d_%s" % (D, dt), 2, 3, Tq, Tk, D, dt, causal, lens, seg)
    for dt in ("float32", "bfloat16", "float16")
    for D, Tq, Tk, causal, lens, seg in (
        (160, 200, 200, False, (200, 77), False),
        (192, 130, 129, True, None, True),
        (256, 100, 190, False, (0, 129), False))
]
ATTN_CASES += WIDE_CASES


def _o_rel_tol(torch, dtype):
    """The forward's tolerance on o for a 16-bit dtype, relative to the
    largest |plain value|."""
    return ATTN_F16_REL if dtype == torch.float16 else ATTN_BF16_REL


def _bwd_rel_tol(torch, dtype):
    """The backward's tolerance on dq, dk and dv, relative to the largest
    |plain value|."""
    return {torch.float32: ATTN_BWD_F32_REL,
            torch.float16: ATTN_BWD_F16_REL}.get(dtype, ATTN_BWD_BF16_REL)


def _peak_ops(torch, dtype, card):
    """The card's peak rate for operands of ``dtype``: the tensor cores'
    for bf16 and fp16, and for float32 a third of their TF32 rate (three
    TF32 products a float32 product, as the float32 kernels run them;
    ``_ffma_bound_ms`` gives the bound on fp32 FMAs beside it)."""
    if dtype in (torch.bfloat16, torch.float16):
        return BF16_PEAK_OPS
    return TF32_PEAK_OPS / 3


def _ffma_note(ms):
    return "" if ms is None else " ffma bound %.4f" % ms


def _ffma_bound_ms(torch, dtype, card, nbytes, ops):
    """For float32 operands, the bound with the operations on fp32 FMAs
    outside the tensor cores (67 TFLOP/s): the larger of the bytes over the
    memory rate and the operations over that rate; None otherwise."""
    if dtype != torch.float32:
        return None
    return max(nbytes / memory_bytes_per_s(card),
               ops / fp32_ops_per_s(card)) * 1e3


def _bf16_ulp(torch, a, b, bits=8):
    """One bf16 ulp of max(|a|, |b|), elementwise: 2**(e - 8) for a value
    m * 2**e with 0.5 <= m < 1 (``bits`` 11: a float16 ulp)."""
    _, e = torch.frexp(torch.maximum(a.float().abs(), b.float().abs()))
    return torch.ldexp(torch.ones_like(e, dtype=torch.float32), e - bits)


def _half_ulp(torch, a, b):
    """One ulp of max(|a|, |b|) in a's dtype, bf16 or f16; None for
    float32."""
    bits = {torch.bfloat16: 8, torch.float16: 11}.get(a.dtype)
    return None if bits is None else _bf16_ulp(torch, a, b, bits)


# (case, N, C, x dtype, gamma/beta dtype)
LN_CASES = [
    ("bert", BERT_BATCH * BERT_SEQ, BERT_UNITS, "bfloat16", "bfloat16"),
    ("bert_decoder", BERT_BATCH * BERT_PRED, BERT_UNITS, "bfloat16",
     "bfloat16"),
    ("f32", BERT_BATCH * BERT_SEQ, BERT_UNITS, "float32", "float32"),
    # the AMP step's float32 LayerNorm on the MLM head's masked rows (its
    # other 25 launches a step are the case "f32")
    ("f32_decoder", BERT_BATCH * BERT_PRED, BERT_UNITS, "float32",
     "float32"),
    ("bf16_x_f32_affine", BERT_BATCH * BERT_SEQ, BERT_UNITS, "bfloat16",
     "float32"),
    ("ragged", 37, 1000, "float32", "float32"),
    # the backward's grid: one row, one row past a block of eight (two
    # blocks), one past eight rows on each of 132 SMs; 64 values a lane
    # (the shared-memory sums); C not a multiple of 8 (one element a load)
    ("n1", 1, BERT_UNITS, "bfloat16", "bfloat16"),
    ("n9", 9, BERT_UNITS, "bfloat16", "bfloat16"),
    ("n1057", 1057, BERT_UNITS, "bfloat16", "bfloat16"),
    ("c2048", 4096, 2048, "bfloat16", "bfloat16"),
    ("unaligned_c1001", 64, 1001, "bfloat16", "bfloat16"),
    # float16: BERT-base cast whole (f16 x and affine, the
    # float16 path's 25 + 1 launches a forward), and f16 x with an f32
    # affine (y and the cotangent float32)
    ("f16", BERT_BATCH * BERT_SEQ, BERT_UNITS, "float16", "float16"),
    ("f16_decoder", BERT_BATCH * BERT_PRED, BERT_UNITS, "float16",
     "float16"),
    ("f16_x_f32_affine", BERT_BATCH * BERT_SEQ, BERT_UNITS, "float16",
     "float32"),
    ("f16_x_f32_affine_decoder", BERT_BATCH * BERT_PRED, BERT_UNITS,
     "float16", "float32"),
]


# (case, B, H, Tq, Tk, D, dtype, causal, kv_lens, segments) of the
# backward kernels; T 2048 is the domain of the TPU's _dqkv_fused_kernel,
# T 4096 of its _dq_kernel + _dkv_kernel, the rest of _dqkv_single_kernel.
# The cases from "tk1" on are the edges of the kernels' tile ring: fewer
# tiles than stages, a ragged last tile, kv_lens on a tile edge and 0,
# causal with Tq != Tk, D 128 at T 1024, and D 80 (padded to 128).
ATTN_BWD_CASES = [
    ("bert", 24, 12, 512, 512, 64, "bfloat16", False, "bench", False),
    ("f32", 2, 12, 128, 128, 64, "float32", False, None, False),
    ("f32_d128_causal_lens", 2, 4, 256, 200, 128, "float32", True, (0, 150),
     False),
    ("f32_bert", 24, 12, 512, 512, 64, "float32", False, "bench", False),
    ("causal", 2, 12, 512, 512, 64, "bfloat16", True, None, False),
    ("segments", 2, 12, 256, 256, 64, "bfloat16", False, None, True),
    ("lens_0_and_past_tk", 2, 12, 256, 256, 64, "bfloat16", False,
     (0, 1000), False),
    ("ragged_t200", 2, 12, 200, 200, 64, "bfloat16", False, None, False),
    ("tq_ne_tk", 2, 12, 128, 384, 64, "bfloat16", False, (300, 384), False),
    ("d128", 2, 12, 256, 256, 128, "bfloat16", False, None, False),
    ("t2048", 1, 12, 2048, 2048, 64, "bfloat16", False, None, False),
    ("t4096", 1, 12, 4096, 4096, 64, "bfloat16", False, None, False),
    ("tk1", 2, 3, 64, 1, 64, "bfloat16", False, None, False),
    ("tk63", 2, 3, 100, 63, 64, "bfloat16", False, None, False),
    ("tk65_lens_64_0", 2, 3, 100, 65, 64, "bfloat16", False, (64, 0), False),
    ("tk129_lens_128", 2, 3, 130, 129, 64, "bfloat16", False, (128, 129),
     False),
    ("lens_on_tile_edges", 3, 4, 256, 256, 64, "bfloat16", False,
     (64, 128, 0), False),
    ("causal_tq_lt_tk", 2, 3, 96, 200, 64, "bfloat16", True, None, False),
    ("causal_tq_gt_tk_lens", 2, 3, 200, 96, 64, "bfloat16", True, (96, 50),
     False),
    ("d128_t1024", 1, 12, 1024, 1024, 128, "bfloat16", False, None, False),
    ("d80", 2, 3, 256, 256, 80, "bfloat16", False, (256, 100), False),
    ("f16_bert", 24, 12, 512, 512, 64, "float16", False, "bench", False),
    ("f16_t2048_d128_causal", 1, 16, 2048, 2048, 128, "float16", True, None,
     False),
    ("f16_segments_ragged", 2, 12, 200, 200, 64, "float16", False, None,
     True),
    ("f16_tk65_lens_64_0", 2, 3, 100, 65, 128, "float16", False, (64, 0),
     False),
] + WIDE_CASES
# the Hopper attention kernels, which must not spill registers: the
# 16-bit wgmma kernels and the float32 three-TF32 mma.sync ones
HOPPER_KERNELS = ("flash_fwd_hopper", "flash_bwd_q_hopper",
                  "flash_bwd_kv_hopper")
TF32_KERNELS = ("flash_fwd_tf32", "flash_bwd_q_tf32", "flash_bwd_kv_tf32")


def tf32_sass_check(kernels):
    """The float32 attention kernels' SASS (``cuobjdump -sass`` of the
    built library) holds tensor-core TF32 products (``HMMA.1688.F32.TF32``)
    in every instantiation: {kernel: count of HMMA TF32 instructions}.
    Fails the run where a float32 kernel has none."""
    import re
    import shutil
    tool = os.path.join(os.path.dirname(kernels.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump") or tool
    sass = subprocess.run([tool, "-sass", kernels.library_path(
        "flash_attention")], capture_output=True, text=True, check=True).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        name = kernels._kernel_name(part.split(None, 1)[0])
        if name.startswith(TF32_KERNELS):
            counts[name] = len(re.findall(r"HMMA\.\S*TF32", part))
    check(len(counts) == 12, "cuobjdump found %d float32 attention kernels "
          "(%s), want 12 (3 kernels x 4 head dims)" % (len(counts),
                                                       sorted(counts)))
    for name, n in sorted(counts.items()):
        check(n > 0, "%s: no HMMA TF32 instruction in its SASS" % name)
    return counts


def hopper_occupancy(torch, attention):
    """Blocks an SM and shared memory a block of the attention forward
    and backward kernels (the wgmma ones for bf16 and f16, the three-TF32
    ones for f32, D 64 to 256), as the CUDA runtime reports them for the
    built kernels."""
    import ctypes
    fwd = attention._kernel_fn("fwd_occupancy")
    bwd = attention._kernel_fn("bwd_occupancy")
    for dt, code in (("bf16", 1), ("f16", 2), ("f32", 0)):
        kind = "tf32" if code == 0 else "hopper"
        for D in (64, 128, 192, 256):
            out = (ctypes.c_int * 4)()
            rc = fwd(D, code, out)
            check(rc == 0, "flash_attention_fwd occupancy query failed: "
                  "CUDA error %d" % rc)
            print("flash_fwd_%s %s D %d: %d blocks an SM, %d bytes of "
                  "shared memory a block" % (kind, dt, D, out[0], out[1]))
            rc = bwd(D, code, out)
            check(rc == 0, "flash_attention_bwd occupancy query failed: "
                  "CUDA error %d" % rc)
            print("flash_bwd_q_%s %s D %d: %d blocks an SM, %d bytes of "
                  "shared memory a block; flash_bwd_kv_%s %s D %d: %d "
                  "blocks an SM, %d bytes" % (kind, dt, D, out[0], out[1],
                                              kind, dt, D, out[2], out[3]))


def attention_cases(torch, attention, card, flush, seed):
    """The flash-attention kernel against its plain version, timed beside
    its bound and scaled_dot_product_attention."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    dev = torch.device("cuda", 0)
    bw = memory_bytes_per_s(card)
    _, bench_lens, _ = bert_inputs(seed)
    rows = []
    for case in ATTN_CASES:
        name, B, H, Tq, Tk, D, dt, causal, lens, seg = case
        dtype = getattr(torch, dt)
        q, k, v, _, kw = _attention_operands(torch, gen, case, bench_lens)
        what = "attention %s %s" % (name, (B, H, Tq, Tk, D))
        with torch.inference_mode():
            def k_fn():
                return attention.flash_attention_fwd(q, k, v, **kw)

            def p_fn():
                return attention._flash_attention_plain(q, k, v, **kw)
            (o, lse), (po, plse) = k_fn(), p_fn()
            torch.cuda.synchronize()
            check(o.shape == po.shape and o.dtype == po.dtype
                  and lse.dtype == torch.float32,
                  "%s: kernel gave %s %s" % (what, tuple(o.shape), o.dtype))
            check(bool(torch.isfinite(o).all()), "%s: non-finite o" % what)
            err = (o.float() - po.float()).abs().max().item()
            lse_err = (lse - plse).abs().max().item()
            if dtype == torch.float32:
                check(err <= ATTN_F32_O and lse_err <= ATTN_F32_LSE,
                      "%s: max|o err| %.3g, max|lse err| %.3g" % (what, err,
                                                                 lse_err))
            else:
                o_rel = err / max(po.float().abs().max().item(), 1e-30)
                check(o_rel <= _o_rel_tol(torch, dtype)
                      and lse_err <= ATTN_F32_LSE,
                      "%s: o rel err %.3g, max|lse err| %.3g"
                      % (what, o_rel, lse_err))
            if lens is not None and lens != "bench":
                for b, n in enumerate(lens):
                    check(n != 0 or not (o[b].any() or lse[b].any()),
                          "%s: a row with no visible key is not 0" % what)
            # the library's yardstick: the same masks as one boolean mask
            mask = attention._visible(B, Tq, Tk, dev, causal,
                                      kw.get("kv_lens"), kw.get("q_segments"),
                                      kw.get("kv_segments"))

            def l_fn():
                return F.scaled_dot_product_attention(q, k, v,
                                                      attn_mask=mask)
            ms = time_cuda(torch, k_fn, flush)
            plain_ms = time_cuda(torch, p_fn, flush)
            library_ms = time_cuda(torch, l_fn, flush)
            host = host_us(torch, k_fn)
        pairs = _visible_pairs(torch, attention, B, Tq, Tk, causal,
                               kw.get("kv_lens"), kw.get("q_segments"),
                               kw.get("kv_segments"))
        ops = 4.0 * H * D * pairs
        if lens is None:
            keys = B * Tk
        else:
            keys = int(torch.clamp(kw["kv_lens"], 0, Tk).sum().item())
        nbytes = (2 * B * Tq + 2 * keys) * H * D * q.element_size() \
            + B * H * Tq * 4
        peak = _peak_ops(torch, dtype, card)
        bound_ms = max(nbytes / bw, ops / peak) * 1e3
        row = {"case": name, "shape": [B, H, Tq, Tk, D], "dtype": dt,
               "causal": causal, "kv_lens": None if lens is None else
               ("bench" if lens == "bench" else list(lens)),
               "segments": seg, "max_abs_err": err, "lse_max_abs_err": lse_err,
               "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound_ms,
               "ffma_bound_ms": _ffma_bound_ms(torch, dtype, card, nbytes,
                                               ops),
               "bound_by": "bytes" if nbytes / bw > ops / peak
               else "operations", "visible_pairs": pairs * H,
               "tflops": ops / ms / 1e9, "host_us": host,
               "dispatch": attention.attention_dispatch(Tq, Tk, D, dtype,
                                                        census=False)
               ["kernel"]}
        rows.append(row)
        print("kernel attention %-18s %-26s %-8s err %.3g lse err %.3g  "
              "kernel %.4f ms (%.1f TFLOP/s)  plain %.4f ms  sdpa %.4f ms  "
              "bound %.4f ms (%s)%s  host/call %.1f us  (%s)"
              % (name, (B, H, Tq, Tk, D), dt, err, lse_err, ms, row["tflops"],
                 plain_ms, library_ms, bound_ms, row["bound_by"],
                 _ffma_note(row["ffma_bound_ms"]), host, card))
        del q, k, v, o, lse, po, plse, mask
        torch.cuda.empty_cache()
    return rows


def short_seq_side_by_side(torch, attention, card, flush, seed):
    """The kernel and the composed attention at S = 64 and 128 (BERT-base
    heads, batch 24, bf16): the data for re-deriving the dispatcher's
    128-key threshold on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 8)
    out = []
    for S in (64, 128):
        q, k, v = (torch.randn((BERT_BATCH, BERT_HEADS, S, 64), device="cuda",
                               generator=gen).to(torch.bfloat16)
                   for _ in range(3))
        with torch.inference_mode():
            kern = time_cuda(torch, lambda: attention.flash_attention_fwd(
                q, k, v), flush)
            comp = time_cuda(torch, lambda: attention._composed_attention(
                q, k, v), flush)
        out.append({"seq": S, "kernel_ms": kern, "composed_ms": comp})
        print("attention S=%d (24, 12, %d, 64) bf16: kernel %.4f ms, "
              "composed %.4f ms (dispatch takes %s)  (%s)"
              % (S, S, kern, comp, attention.attention_dispatch(
                  S, S, 64, census=False)["kernel"], card))
    return out


def layernorm_cases(torch, layernorm, card, flush, seed):
    """The LayerNorm kernel against its plain version, timed beside its
    bound and torch.nn.functional.layer_norm."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(seed + 9)
    bw = memory_bytes_per_s(card)
    eps = 1e-12
    rows = []
    for case, N, C, xdt, gdt in LN_CASES:
        x = (torch.randn((N, C), device="cuda", generator=gen) * 2 + 0.5) \
            .to(getattr(torch, xdt))
        g = (torch.rand(C, device="cuda", generator=gen) + 0.5) \
            .to(getattr(torch, gdt))
        b = (torch.rand(C, device="cuda", generator=gen) - 0.5) \
            .to(getattr(torch, gdt))
        gl, bl = g.to(x.dtype), b.to(x.dtype)
        what = "layernorm %s (%d, %d)" % (case, N, C)
        with torch.inference_mode():
            def k_fn():
                return layernorm.layer_norm_fwd(x, g, b, eps)

            def p_fn():
                return layernorm._layer_norm_fwd_plain(x, g, b, eps)

            def l_fn():
                return F.layer_norm(x, (C,), gl, bl, eps)
            (y, mu, rstd), (py, pmu, prstd) = k_fn(), p_fn()
            torch.cuda.synchronize()
            check(y.dtype == py.dtype and y.shape == py.shape,
                  "%s: kernel gave %s" % (what, y.dtype))
            err = (y.float() - py.float()).abs().max().item()
            excess = (y.float() - py.float()).abs() - LN_F32_ABS
            if _half_ulp(torch, y, py) is not None:
                excess = excess - _half_ulp(torch, y, py)
            check(excess.max().item() <= 0, "%s: max|err| %.3g beyond the "
                  "tolerance" % (what, err))
            stat = max(((mu - pmu).abs() / pmu.abs().clamp_min(1e-3))
                       .max().item(),
                       ((rstd - prstd).abs() / prstd.abs()).max().item())
            check(stat <= LN_STAT_REL, "%s: mu/rstd rel err %.3g"
                  % (what, stat))
            ms = time_cuda(torch, k_fn, flush)
            plain_ms = time_cuda(torch, p_fn, flush)
            library_ms = time_cuda(torch, l_fn, flush)
            host = host_us(torch, k_fn)
        nbytes = N * C * (x.element_size() + y.element_size()) \
            + 2 * C * g.element_size() + 8 * N
        ops = 8.0 * N * C
        bound_ms = max(nbytes / bw, ops / fp32_ops_per_s(card)) * 1e3
        row = {"case": case, "shape": [N, C], "dtype": xdt,
               "affine_dtype": gdt, "max_abs_err": err,
               "stat_max_rel_err": stat, "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound_ms,
               "bound_by": "bytes" if nbytes / bw > ops / fp32_ops_per_s(card)
               else "operations", "host_us": host}
        rows.append(row)
        print("kernel layernorm %-17s %-13s %-8s/%-8s err %.3g  kernel %.4f "
              "ms  plain %.4f ms  F.layer_norm %.4f ms  bound %.4f ms  "
              "host/call %.1f us  (%s)"
              % (case, (N, C), xdt, gdt, err, ms, plain_ms, library_ms,
                 bound_ms, host, card))
    return rows


def _attention_operands(torch, gen, case, bench_lens):
    """q, k, v, the cotangent and the mask keywords of one case."""
    _, B, H, Tq, Tk, D, dt, causal, lens, seg = case
    dev = torch.device("cuda", 0)
    dtype = getattr(torch, dt)
    q, k, v, do = (torch.randn((B, H, T, D), device=dev, generator=gen)
                   .to(dtype) for T in (Tq, Tk, Tk, Tq))
    kw = {"causal": causal}
    if lens is not None:
        kw["kv_lens"] = torch.tensor(bench_lens if lens == "bench" else lens,
                                     device=dev, dtype=torch.int32)
    if seg:
        kw["q_segments"] = torch.randint(0, 4, (B, Tq), device=dev,
                                         generator=gen).sort(1).values
        kw["kv_segments"] = torch.randint(0, 4, (B, Tk), device=dev,
                                          generator=gen).sort(1).values
    return q, k, v, do, kw


def attention_bwd_cases(torch, attention, card, flush, seed):
    """The flash-attention backward kernels against their plain version,
    timed beside their bound and the backward of
    scaled_dot_product_attention with the same boolean mask."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(seed + 10)
    dev = torch.device("cuda", 0)
    bw = memory_bytes_per_s(card)
    _, bench_lens, _ = bert_inputs(seed)
    rows = []
    for case in ATTN_BWD_CASES:
        name, B, H, Tq, Tk, D, dt, causal, lens, seg = case
        q, k, v, do, kw = _attention_operands(torch, gen, case, bench_lens)
        what = "attention bwd %s %s" % (name, (B, H, Tq, Tk, D))
        with torch.no_grad():
            o, lse = attention.flash_attention_fwd(q, k, v, **kw)
            o = o.contiguous()

            def k_fn():
                return attention.flash_attention_bwd(q, k, v, o, lse, do,
                                                     **kw)

            def p_fn():
                return attention._flash_attention_bwd_plain(q, k, v, o, lse,
                                                            do, **kw)
            got, again, want = k_fn(), k_fn(), p_fn()
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  "%s: two runs differ" % what)
            rel_tol = _bwd_rel_tol(torch, q.dtype)
            err = rel = 0.0
            for gname, a, b in zip(("dq", "dk", "dv"), got, want):
                check(a.shape == b.shape and a.dtype == b.dtype,
                      "%s %s: kernel gave %s %s" % (what, gname,
                                                    tuple(a.shape), a.dtype))
                check(bool(torch.isfinite(a).all()),
                      "%s %s: non-finite" % (what, gname))
                e = (a.float() - b.float()).abs().max().item()
                ref = b.float().abs().max().item()
                if Tk == 1 and gname != "dv":
                    # one key a row: p = 1 and dp = delta, so dq and dk are
                    # 0 in exact arithmetic and both sides give the
                    # rounding of dp - delta; held to that scale, a
                    # fraction of the largest |dv|
                    ref = want[2].float().abs().max().item() \
                        * ATTN_BWD_ONE_KEY_REL / rel_tol
                r = e / max(ref, 1e-30)
                check(r <= rel_tol, "%s %s: max err %.3g of the largest "
                      "|plain| > %g" % (what, gname, r, rel_tol))
                err, rel = max(err, e), max(rel, r)
            if lens is not None:
                valid = kw["kv_lens"].tolist()
                for b, n in enumerate(valid):
                    check(not got[1][b, :, n:].any()
                          and not got[2][b, :, n:].any(),
                          "%s: dk/dv of keys past the valid length are not "
                          "0" % what)
                    if n == 0:
                        check(not got[0][b].any(), "%s: dq of rows that "
                              "see no key is not 0" % what)
            ms = time_cuda(torch, k_fn, flush)
            plain_ms = time_cuda(torch, p_fn, flush)
            host = host_us(torch, k_fn)
            del got, again, want
        mask = attention._visible(B, Tq, Tk, dev, causal, kw.get("kv_lens"),
                                  kw.get("q_segments"),
                                  kw.get("kv_segments"))
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)

        def l_fn():
            return torch.autograd.grad(out, (qg, kg, vg), do,
                                       retain_graph=True)
        library_ms = time_cuda(torch, l_fn, flush)
        del out, qg, kg, vg
        pairs = _visible_pairs(torch, attention, B, Tq, Tk, causal,
                               kw.get("kv_lens"), kw.get("q_segments"),
                               kw.get("kv_segments"))
        # five products (s, dp, dv, dq, dk) over the visible pairs
        ops = 10.0 * H * D * pairs
        keys = B * Tk if lens is None else \
            int(torch.clamp(kw["kv_lens"], 0, Tk).sum().item())
        # q, o, do read and dq written; k, v read and dk, dv written up to
        # the valid lengths; lse read
        nbytes = (4 * B * Tq + 4 * keys) * H * D * q.element_size() \
            + B * H * Tq * 4
        peak = _peak_ops(torch, q.dtype, card)
        bound_ms = max(nbytes / bw, ops / peak) * 1e3
        row = {"case": name, "shape": [B, H, Tq, Tk, D], "dtype": dt,
               "causal": causal, "kv_lens": None if lens is None else
               ("bench" if lens == "bench" else list(lens)),
               "segments": seg, "max_abs_err": err, "max_rel_err": rel,
               "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound_ms,
               "ffma_bound_ms": _ffma_bound_ms(torch, q.dtype, card, nbytes,
                                               ops),
               "bound_by": "bytes" if nbytes / bw > ops / peak
               else "operations", "visible_pairs": pairs * H,
               "tflops": ops / ms / 1e9, "host_us": host}
        rows.append(row)
        print("kernel attention bwd %-20s %-26s %-8s err %.3g (rel %.3g)  "
              "kernel %.4f ms (%.1f TFLOP/s)  plain %.4f ms  sdpa bwd %.4f "
              "ms  bound %.4f ms (%s)%s  host/call %.1f us  (%s)"
              % (name, (B, H, Tq, Tk, D), dt, err, rel, ms, row["tflops"],
                 plain_ms, library_ms, bound_ms, row["bound_by"],
                 _ffma_note(row["ffma_bound_ms"]), host, card))
        del q, k, v, do, o, lse, mask
        torch.cuda.empty_cache()
    return rows


def layernorm_bwd_cases(torch, layernorm, card, flush, seed):
    """The LayerNorm backward kernel against its plain version, timed
    beside its bound and the backward of torch.nn.functional.layer_norm."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    bw = memory_bytes_per_s(card)
    eps = 1e-12
    rows = []
    for case, N, C, xdt, gdt in LN_CASES:
        x = (torch.randn((N, C), device="cuda", generator=gen) * 2 + 0.5) \
            .to(getattr(torch, xdt))
        g = (torch.rand(C, device="cuda", generator=gen) + 0.5) \
            .to(getattr(torch, gdt))
        b = (torch.rand(C, device="cuda", generator=gen) - 0.5) \
            .to(getattr(torch, gdt))
        what = "layernorm bwd %s (%d, %d)" % (case, N, C)
        with torch.no_grad():
            y, mu, rstd = layernorm.layer_norm_fwd(x, g, b, eps)
            ct = torch.randn((N, C), device="cuda", generator=gen) \
                .to(y.dtype)

            def k_fn():
                return layernorm.layer_norm_bwd(x, g, mu, rstd, ct)

            def p_fn():
                return layernorm._layer_norm_bwd_plain(x, g, mu, rstd, ct)
            got, again, want = k_fn(), k_fn(), p_fn()
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  "%s: two runs differ" % what)
            check(all(a.dtype == b.dtype and a.shape == b.shape
                      for a, b in zip(got, want)),
                  "%s: kernel gave %s" % (what, [a.dtype for a in got]))
            dx, pdx = got[0].float(), want[0].float()
            err = (dx - pdx).abs().max().item()
            excess = (dx - pdx).abs() - LN_F32_ABS
            if _half_ulp(torch, got[0], want[0]) is not None:
                excess = excess - _half_ulp(torch, got[0], want[0])
            check(excess.max().item() <= 0, "%s: dx max|err| %.3g beyond "
                  "the tolerance" % (what, err))
            sums = max(((a - b).abs().max() / b.abs().max()).item()
                       for a, b in zip(got[1:], want[1:]))
            check(sums <= LN_SUM_REL, "%s: dgamma/dbeta rel err %.3g"
                  % (what, sums))
            ms = time_cuda(torch, k_fn, flush)
            plain_ms = time_cuda(torch, p_fn, flush)
            host = host_us(torch, k_fn)
        xg = x.detach().requires_grad_()
        gl = g.to(x.dtype).requires_grad_()
        bl = b.to(x.dtype).requires_grad_()
        out = F.layer_norm(xg, (C,), gl, bl, eps)
        ctl = ct.to(out.dtype)

        def l_fn():
            return torch.autograd.grad(out, (xg, gl, bl), ctl,
                                       retain_graph=True)
        library_ms = time_cuda(torch, l_fn, flush)
        del out
        # x and ct read, dx written, mu/rstd and gamma read, dgamma and
        # dbeta written
        nbytes = N * C * (2 * x.element_size() + ct.element_size()) \
            + 8 * N + C * (g.element_size() + 8)
        ops = 10.0 * N * C
        bound_ms = max(nbytes / bw, ops / fp32_ops_per_s(card)) * 1e3
        row = {"case": case, "shape": [N, C], "dtype": xdt,
               "affine_dtype": gdt, "max_abs_err": err,
               "sums_max_rel_err": sums, "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound_ms,
               "bound_by": "bytes" if nbytes / bw > ops / fp32_ops_per_s(card)
               else "operations", "host_us": host}
        rows.append(row)
        print("kernel layernorm bwd %-17s %-13s %-8s/%-8s err %.3g sums rel "
              "%.3g  kernel %.4f ms  plain %.4f ms  F.layer_norm bwd %.4f ms"
              "  bound %.4f ms  host/call %.1f us  (%s)"
              % (case, (N, C), xdt, gdt, err, sums, ms, plain_ms, library_ms,
                 bound_ms, host, card))
    return rows


# (case, B, Tq, Tk, H, D, dtype, causal, kv_lens, packed) of the (B, T,
# H, D) kernels: "packed" q, k and v are the column blocks of one (B, T, 3
# H D) buffer (a fused projection's output), the backward writing into
# views of one such gradient; the others are contiguous (B, T, H, D)
ATTN_BSHD_CASES = [
    ("bert", 24, 512, 512, 12, 64, "bfloat16", False, "bench", True),
    ("t2048_d128_causal", 1, 2048, 2048, 16, 128, "bfloat16", True, None,
     False),
    ("f32_t1024_d128", 2, 1024, 1024, 8, 128, "float32", False, None, False),
    # BERT-base's float32 layer, q, k and v views of the projection
    ("f32_bert", 24, 512, 512, 12, 64, "float32", False, "bench", True),
    ("d80", 2, 256, 256, 12, 80, "bfloat16", False, (256, 100), False),
    ("tk65_lens_64_0", 2, 100, 65, 3, 64, "bfloat16", False, (64, 0), False),
    ("tk129_lens_128", 2, 130, 129, 3, 64, "bfloat16", False, (128, 129),
     False),
    ("lens_on_tile_edges", 3, 256, 256, 4, 64, "bfloat16", False,
     (64, 128, 0), True),
    # float16 (the AMP path's layer: q, k and v views of the projection);
    # the wide head dims at BERT-base's width and with the masks
    ("f16_bert", 24, 512, 512, 12, 64, "float16", False, "bench", True),
    ("f16_t2048_d128_causal", 1, 2048, 2048, 16, 128, "float16", True, None,
     False),
    ("d192_bert", 24, 512, 512, 4, 192, "bfloat16", False, "bench", True),
    ("d256_bert", 24, 512, 512, 3, 256, "bfloat16", False, "bench", True),
    ("d160_f16_lens", 2, 200, 200, 3, 160, "float16", False, (200, 77),
     True),
    ("d192_f32_causal", 2, 130, 129, 3, 192, "float32", True, None, False),
    ("d256_f16_lens_0", 2, 100, 190, 3, 256, "float16", False, (0, 129),
     False),
    ("d256_f32_causal", 2, 256, 256, 2, 256, "float32", True, (256, 100),
     True),
]


# the public ops' second case: (B, T, H, D, causal, kv_lens), where the
# transformer's note places the (B, T, H, D) entry
PUBLIC_OP_LONG = (1, 2048, 16, 128, True, None)


def _bshd_operands(torch, attention, gen, case, bench_lens):
    """q, k, v, the cotangent and the mask keywords of one BSHD case, and
    the (B, T, 3 H D) buffer whose views q, k and v are (None unless
    packed)."""
    _, B, Tq, Tk, H, D, dt, causal, lens, packed = case
    dev = torch.device("cuda", 0)
    dtype = getattr(torch, dt)
    buf = None
    check(not packed or Tq == Tk, "a packed case is self-attention")
    if packed:
        buf = torch.randn((B, Tq, 3 * H * D), device=dev,
                          generator=gen).to(dtype)
        q, k, v = attention._qkv_heads(buf, H)
    else:
        q, k, v = (torch.randn((B, T, H, D), device=dev, generator=gen)
                   .to(dtype) for T in (Tq, Tk, Tk))
    do = torch.randn((B, Tq, H, D), device=dev, generator=gen).to(dtype)
    kw = {"causal": causal}
    if lens is not None:
        kw["kv_lens"] = torch.tensor(bench_lens if lens == "bench" else lens,
                                     device=dev, dtype=torch.int32)
    return q, k, v, do, kw, buf


def _bwd_errors(torch, what, got, want, dtype):
    """max |got - want| and its ratio to the largest |plain value| over dq,
    dk and dv, checked against the backward's tolerance."""
    rel_tol = _bwd_rel_tol(torch, dtype)
    err = rel = 0.0
    for gname, a, b in zip(("dq", "dk", "dv"), got, want):
        check(a.shape == b.shape and a.dtype == b.dtype,
              "%s %s: kernel gave %s %s" % (what, gname, tuple(a.shape),
                                            a.dtype))
        check(bool(torch.isfinite(a).all()), "%s %s: non-finite"
              % (what, gname))
        e = (a.float() - b.float()).abs().max().item()
        r = e / max(b.float().abs().max().item(), 1e-30)
        check(r <= rel_tol, "%s %s: max err %.3g of the largest |plain| > %g"
              % (what, gname, r, rel_tol))
        err, rel = max(err, e), max(rel, r)
    return err, rel


def attention_bshd_cases(torch, attention, card, flush, seed):
    """The (B, T, H, D) flash-attention forward and backward kernels
    against their plain versions, timed beside their bounds and
    scaled_dot_product_attention (forward and backward) on the same
    strided views with the same boolean mask."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(seed + 12)
    dev = torch.device("cuda", 0)
    bw = memory_bytes_per_s(card)
    _, bench_lens, _ = bert_inputs(seed)
    rows = []
    for case in ATTN_BSHD_CASES:
        name, B, Tq, Tk, H, D, dt, causal, lens, packed = case
        dtype = getattr(torch, dt)
        q, k, v, do, kw, buf = _bshd_operands(torch, attention, gen, case,
                                              bench_lens)
        what = "attention bshd %s %s" % (name, (B, Tq, Tk, H, D))
        with torch.no_grad():
            def f_fn():
                return attention.flash_attention_bshd_fwd(q, k, v, **kw)

            def fp_fn():
                return attention._flash_attention_bshd_plain(q, k, v, **kw)
            (o, lse), (po, plse) = f_fn(), fp_fn()
            torch.cuda.synchronize()
            check(o.shape == po.shape and o.dtype == po.dtype
                  and lse.shape == (B, H, Tq) and lse.dtype == torch.float32,
                  "%s: kernel gave %s %s" % (what, tuple(o.shape), o.dtype))
            check(bool(torch.isfinite(o).all()), "%s: non-finite o" % what)
            err = (o.float() - po.float()).abs().max().item()
            lse_err = (lse - plse).abs().max().item()
            if dtype == torch.float32:
                check(err <= ATTN_F32_O and lse_err <= ATTN_F32_LSE,
                      "%s: max|o err| %.3g, max|lse err| %.3g" % (what, err,
                                                                 lse_err))
            else:
                # the scores are fp32 from bf16 inputs on both sides, so
                # lse is held as in f32
                o_rel = err / max(po.float().abs().max().item(), 1e-30)
                check(o_rel <= _o_rel_tol(torch, dtype)
                      and lse_err <= ATTN_F32_LSE,
                      "%s: o rel err %.3g, max|lse err| %.3g" % (what, o_rel,
                                                                lse_err))
            del po, plse
            grad = None if buf is None else torch.empty_like(buf)
            out = None if buf is None else attention._qkv_heads(grad, H)

            def b_fn():
                return attention.flash_attention_bshd_bwd(q, k, v, o, lse,
                                                          do, out=out, **kw)

            def bp_fn():
                return attention._flash_attention_bshd_bwd_plain(
                    q, k, v, o, lse, do, **kw)
            got = [t.clone() for t in b_fn()]
            again, want = b_fn(), bp_fn()
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  "%s: two backward runs differ" % what)
            bwd_err, bwd_rel = _bwd_errors(torch, what + " bwd", got, want,
                                           dtype)
            if lens is not None:
                for b, n in enumerate(kw["kv_lens"].tolist()):
                    check(not got[1][b, n:].any() and not got[2][b, n:].any(),
                          "%s: dk/dv of keys past the valid length are not "
                          "0" % what)
                    if n == 0:
                        check(not o[b].any() and not got[0][b].any(),
                              "%s: a row that sees no key is not 0" % what)
            del got, again, want
            ms, plain_ms = time_cuda(torch, f_fn, flush), \
                time_cuda(torch, fp_fn, flush)
            bwd_ms, bwd_plain_ms = time_cuda(torch, b_fn, flush), \
                time_cuda(torch, bp_fn, flush)
            host = host_us(torch, f_fn)
        # the library's yardstick on the same strided views, transposed to
        # (B, H, T, D) without a copy
        mask = attention._visible(B, Tq, Tk, dev, causal, kw.get("kv_lens"),
                                  None, None)
        qg, kg, vg = (t.detach().transpose(1, 2).requires_grad_()
                      for t in (q, k, v))
        with torch.no_grad():
            library_ms = time_cuda(torch, lambda: F.scaled_dot_product_attention(
                qg, kg, vg, attn_mask=mask), flush)
        lout = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
        dot = do.transpose(1, 2)
        bwd_library_ms = time_cuda(torch, lambda: torch.autograd.grad(
            lout, (qg, kg, vg), dot, retain_graph=True), flush)
        del lout, qg, kg, vg, mask
        pairs = _visible_pairs(torch, attention, B, Tq, Tk, causal,
                               kw.get("kv_lens"), None, None)
        keys = B * Tk if lens is None else \
            int(torch.clamp(kw["kv_lens"], 0, Tk).sum().item())
        size = q.element_size()
        peak = _peak_ops(torch, dtype, card)
        # the (B, H, T, D) rows' counts: forward q, k, v read and o written
        # (k and v up to the valid lengths) and lse written, two products;
        # backward q, o, do, dq and k, v, dk, dv and lse, five products
        f_bytes = (2 * B * Tq + 2 * keys) * H * D * size + B * H * Tq * 4
        b_bytes = (4 * B * Tq + 4 * keys) * H * D * size + B * H * Tq * 4
        f_ops, b_ops = 4.0 * H * D * pairs, 10.0 * H * D * pairs
        row = {"case": name, "shape": [B, Tq, Tk, H, D], "dtype": dt,
               "causal": causal, "kv_lens": None if lens is None else
               ("bench" if lens == "bench" else list(lens)),
               "strided_views": packed, "max_abs_err": err,
               "lse_max_abs_err": lse_err, "bwd_max_abs_err": bwd_err,
               "bwd_max_rel_err": bwd_rel, "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms,
               "bound_ms": max(f_bytes / bw, f_ops / peak) * 1e3,
               "bound_by": "bytes" if f_bytes / bw > f_ops / peak
               else "operations", "tflops": f_ops / ms / 1e9,
               "bwd_ms": bwd_ms, "bwd_plain_ms": bwd_plain_ms,
               "bwd_library_ms": bwd_library_ms,
               "bwd_bound_ms": max(b_bytes / bw, b_ops / peak) * 1e3,
               "ffma_bound_ms": _ffma_bound_ms(torch, dtype, card, f_bytes,
                                               f_ops),
               "bwd_ffma_bound_ms": _ffma_bound_ms(torch, dtype, card,
                                                   b_bytes, b_ops),
               "bwd_bound_by": "bytes" if b_bytes / bw > b_ops / peak
               else "operations", "bwd_tflops": b_ops / bwd_ms / 1e9,
               "visible_pairs": pairs * H, "host_us": host}
        rows.append(row)
        print("kernel attention bshd %-18s %-24s %-8s fwd err %.3g (lse "
              "%.3g) kernel %.4f ms (%.1f TFLOP/s) plain %.4f sdpa %.4f "
              "bound %.4f (%s)%s; bwd err %.3g (rel %.3g) kernel %.4f ms "
              "(%.1f TFLOP/s) plain %.4f sdpa bwd %.4f bound %.4f (%s)%s; "
              "host/call %.1f us  (%s)"
              % (name, (B, Tq, Tk, H, D), dt, err, lse_err, ms, row["tflops"],
                 plain_ms, library_ms, row["bound_ms"], row["bound_by"],
                 _ffma_note(row["ffma_bound_ms"]), bwd_err, bwd_rel, bwd_ms,
                 row["bwd_tflops"], bwd_plain_ms, bwd_library_ms,
                 row["bwd_bound_ms"], row["bwd_bound_by"],
                 _ffma_note(row["bwd_ffma_bound_ms"]), host, card))
        del q, k, v, do, o, lse, buf, grad, out
        torch.cuda.empty_cache()
    return rows


def sublayer_side_by_side(torch, attention, card, flush, seed):
    """The attention sublayer at BERT-base's shape both ways, in turns in
    one run: the fused (B, L, 3E) projection output in, (B, L, E) out,
    forward and backward.  ``bshd``: the (B, T, H, D) kernels on its
    column blocks, the gradient written into one (B, L, 3E) tensor (what
    MultiHeadAttention runs); ``bhtd``: the (B, H, T, D) op on transposed
    views, with the copies it makes them contiguous with and the
    transposes back.  The two must give the same gradient."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 13)
    dev = torch.device("cuda", 0)
    B, L, H, E = BERT_BATCH, BERT_SEQ, BERT_HEADS, BERT_UNITS
    D = E // H
    _, bench_lens, _ = bert_inputs(seed)
    lens = torch.tensor(bench_lens, device=dev, dtype=torch.int32)
    qkv = torch.randn((B, L, 3 * E), device=dev, generator=gen) \
        .to(torch.bfloat16).requires_grad_()
    do = torch.randn((B, L, E), device=dev, generator=gen).to(torch.bfloat16)

    def bshd_fwd():
        return attention.self_attention_bshd(qkv, H, False, lens)

    def bhtd_fwd():
        q, k, v = (t.reshape(B, L, H, D).transpose(1, 2)
                   for t in qkv.split(E, dim=-1))
        return attention.flash_attention(q, k, v, False, None, lens) \
            .transpose(1, 2).reshape(B, L, E)

    def both(fwd):
        return lambda: torch.autograd.grad(fwd(), qkv, do)[0]
    a, b = both(bshd_fwd)(), both(bhtd_fwd)()
    torch.cuda.synchronize()
    check(torch.equal(a, b), "attention sublayer: the (B, T, H, D) and (B, "
          "H, T, D) routes give different gradients (max diff %.3g)"
          % (a.float() - b.float()).abs().max().item())
    del a, b
    times = {"bshd": [], "bhtd": [], "bshd_fwd": [], "bhtd_fwd": []}
    for way in ("bshd", "bhtd", "bhtd", "bshd"):
        fwd = bshd_fwd if way == "bshd" else bhtd_fwd
        times[way].append(time_cuda(torch, both(fwd), flush))
        with torch.no_grad():
            times[way + "_fwd"].append(time_cuda(torch, fwd, flush))
    out = {k: statistics.mean(v) for k, v in times.items()}
    out["runs"] = times
    print("attention sublayer %s bf16, bench lengths, forward and "
          "backward: (B, T, H, D) route %.4f ms, (B, H, T, D) route with "
          "transposes %.4f ms; forward alone %.4f and %.4f ms  (%s)"
          % ((B, L, E), out["bshd"], out["bhtd"], out["bshd_fwd"],
             out["bhtd_fwd"], card))
    del qkv, do
    torch.cuda.empty_cache()
    return out


# the public ops' cases by variant: (B, T, H, D, causal, kv_lens, dtype);
# "bench" is bench.py's valid lengths
PUBLIC_OP_CASES = {
    "bf16": [(BERT_BATCH, BERT_SEQ, BERT_HEADS, BERT_UNITS // BERT_HEADS,
              False, "bench", "bfloat16"), PUBLIC_OP_LONG + ("bfloat16",)],
    "f16": [(BERT_BATCH, BERT_SEQ, BERT_HEADS, BERT_UNITS // BERT_HEADS,
             False, "bench", "float16"), PUBLIC_OP_LONG + ("float16",)],
    "d192": [(BERT_BATCH, BERT_SEQ, 4, 192, False, "bench", "bfloat16")],
    "d256": [(BERT_BATCH, BERT_SEQ, 3, 256, False, "bench", "bfloat16")],
    # float32 on the three-TF32 kernels: BERT-base's layer and the
    # (2, 1024, 8, 128) case
    "f32": [(BERT_BATCH, BERT_SEQ, BERT_HEADS, BERT_UNITS // BERT_HEADS,
             False, "bench", "float32"), (2, 1024, 8, 128, False, None,
                                          "float32")],
}


def public_op_phase(torch, mx, attention, seed, card):
    """The public attention ops through the user's entry points under
    ``autograd.record``: ``nd.flash_attention_bshd`` on (B, T, H, D)
    arrays and ``nd.flash_attention`` on the same arrays transposed,
    forward and backward, for each variant of ``PUBLIC_OP_CASES``: bf16 at
    BERT-base's shape and valid lengths and at (1, 2048, 16, 128) causal,
    the same in float16, D 192 and 256 at BERT-base's width, and float32
    at BERT-base's shape and at (2, 1024, 8, 128).  The
    counts start from 0 just before each variant and are read just after;
    each op launches its own kernels once a case each way, and the two
    ops' outputs and gradients agree.  Returns the launches by variant,
    and the bf16 variant's at the top level."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 14)
    dev = torch.device("cuda", 0)
    gpu = mx.gpu(0)
    _, bench_lens, _ = bert_inputs(seed)
    by_variant = {}
    for variant, cases in PUBLIC_OP_CASES.items():
        attention.LAUNCHES = attention.BWD_LAUNCHES = 0
        attention.BSHD_LAUNCHES = attention.BSHD_BWD_LAUNCHES = 0
        for B, T, H, D, causal, lens, dt in cases:
            dtype = getattr(torch, dt)
            what = "public attention ops %s %s" % ((B, T, H, D), dt)
            q, k, v, do = (torch.randn((B, T, H, D), device=dev,
                                       generator=gen).to(dtype)
                           for _ in range(4))
            vl = None if lens is None else mx.nd.array(
                bench_lens if lens == "bench" else lens, ctx=gpu,
                dtype="int32")
            results = []
            for op, layout in ((mx.nd.flash_attention_bshd, lambda t: t),
                               (mx.nd.flash_attention,
                                lambda t: t.transpose(1, 2))):
                args = [mx.nd.array(layout(t).clone(), ctx=gpu)
                        for t in (q, k, v)]
                for a in args:
                    a.attach_grad()
                with mx.autograd.record():
                    out = op(*args, causal=causal, kv_lens=vl)
                out.backward(mx.nd.array(layout(do), ctx=gpu))
                results.append([layout(t.astorch()) for t in
                                [out] + [a.grad for a in args]])
            torch.cuda.synchronize()
            for name, a, b in zip(("o", "dq", "dk", "dv"), *results):
                check(a.dtype == dtype, "%s: %s is %s" % (what, name,
                                                          a.dtype))
                check(bool(torch.isfinite(a).all()), "%s: non-finite %s"
                      % (what, name))
                err = (a.float() - b.float()).abs().max().item()
                check(err <= _bwd_rel_tol(torch, dtype)
                      * b.float().abs().max().item(),
                      "%s %s: the two ops differ by %.3g" % (what, name, err))
            del q, k, v, do, results
        launches = {"bshd_fwd": attention.BSHD_LAUNCHES,
                    "bshd_bwd": attention.BSHD_BWD_LAUNCHES,
                    "bhtd_fwd": attention.LAUNCHES,
                    "bhtd_bwd": attention.BWD_LAUNCHES}
        check(set(launches.values()) == {len(cases)}, "public attention ops "
              "%s: launches %s, want %d of each" % (variant, launches,
                                                    len(cases)))
        print("public attention ops under autograd, %s, %d cases: launches "
              "%s  (%s)" % (variant, len(cases), launches, card))
        by_variant[variant] = launches
        torch.cuda.empty_cache()
    out = dict(by_variant["bf16"])
    out["by_variant"] = by_variant
    return out


def _bert(mx, use_pooler):
    from mxnet_tpu_torch.gluon.model_zoo import bert_base
    return bert_base(vocab_size=BERT_VOCAB, max_length=BERT_SEQ,
                     dropout=0.0, use_pooler=use_pooler, use_decoder=True)


def bert_card_vs_cpu(torch, mx, seed):
    """BERT-base in f32 with pooler and decoder, batch 2, S 128: one
    forward on the card (the kernels) and on the CPU (the plain
    versions), the same weights on both.  Returns each output's relative
    L2 error."""
    import numpy as onp
    from mxnet_tpu_torch.gluon.utils import load_jax_params
    mx.random.seed(seed)
    rs = onp.random.RandomState(seed + 1)
    S = BERT_PARITY_SEQ
    tokens = rs.randint(0, BERT_VOCAB, (2, S)).astype("float32")
    lens = onp.array(BERT_PARITY_LENS, "int32")
    pos = onp.sort(onp.stack([rs.choice(min(BERT_PARITY_LENS),
                                        BERT_PARITY_PRED, replace=False)
                              for _ in range(2)]), 1).astype("int32")

    def run(net, ctx):
        return [o.asnumpy() for o in net(
            mx.nd.array(tokens, ctx=ctx), None, None,
            mx.nd.array(lens, ctx=ctx, dtype="int32"),
            mx.nd.array(pos, ctx=ctx, dtype="int32"))]
    gnet = _bert(mx, use_pooler=True)
    gnet.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    card = run(gnet, mx.gpu(0))
    cnet = _bert(mx, use_pooler=True)
    cnet.initialize(ctx=mx.cpu())
    load_jax_params(cnet, _param_arrays(gnet))
    with mx.cpu():
        cpu = run(cnet, mx.cpu())
    del gnet, cnet
    names = ("sequence", "pooled", "logits")
    for name, c, h in zip(names, card, cpu):
        check(c.shape == h.shape and onp.isfinite(c).all(),
              "BERT card vs CPU: bad %s output %s" % (name, c.shape))
    return {name: _rel_l2(c, h) for name, c, h in zip(names, card, cpu)}


def bert_phase(torch, mx, attention, layernorm, seed, card, profile=False):
    """BERT-base forward on the card through the Gluon entry point, bf16,
    batch 24 x 512, with the fused LayerNorm route; returns the numbers."""
    import numpy as onp
    os.environ["MXNET_FUSED_LAYERNORM"] = "1"
    t0 = time.perf_counter()
    parity = bert_card_vs_cpu(torch, mx, seed)
    parity_s = time.perf_counter() - t0
    print("bert: card vs CPU, f32 forward at batch 2, S %d, valid lengths "
          "%s, %d masked positions a row: rel L2 err %s"
          % (BERT_PARITY_SEQ, BERT_PARITY_LENS, BERT_PARITY_PRED,
             ", ".join("%s %.3g" % kv for kv in parity.items())))
    for name, err in parity.items():
        check(err <= BERT_PARITY_REL_L2, "BERT card vs CPU %s: rel L2 err "
              "%.3g > %g" % (name, err, BERT_PARITY_REL_L2))
    torch.cuda.empty_cache()

    tokens, lens, pos = bert_inputs(seed)
    mx.random.seed(seed)
    net = _bert(mx, use_pooler=False)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    gpu = mx.gpu(0)
    x = mx.nd.array(tokens, ctx=gpu)
    vl = mx.nd.array(lens, ctx=gpu, dtype="int32")
    mp = mx.nd.array(pos, ctx=gpu, dtype="int32")

    def forward():
        return net(x, None, None, vl, mp)
    seq32, _ = forward()                 # f32: also settles deferred shapes
    seq32 = seq32.asnumpy()
    net.cast("bfloat16")

    def step():
        seq, logits = forward()
        torch.cuda.synchronize()
        return seq, logits
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts from 0 just before, read just after
    attention.LAUNCHES = attention.BSHD_LAUNCHES = 0
    layernorm.LAUNCHES = 0
    times = []
    for _ in range(BERT_WARMUP + BERT_TIMED):
        t = time.perf_counter()
        seq, logits = step()
        times.append(time.perf_counter() - t)
    launches = (attention.BSHD_LAUNCHES, layernorm.LAUNCHES)
    bhtd_launches = attention.LAUNCHES
    peak_bytes = torch.cuda.max_memory_allocated()
    n_fwd = BERT_WARMUP + BERT_TIMED
    check(launches == (BERT_ATTN_PER_FWD * n_fwd, BERT_LN_PER_FWD * n_fwd)
          and bhtd_launches == 0,
          "%d (B, T, H, D) attention, %d (B, H, T, D) attention and %d "
          "LayerNorm launches in %d forwards (want %d, 0 and %d a forward)"
          % (launches[0], bhtd_launches, launches[1], n_fwd,
             BERT_ATTN_PER_FWD, BERT_LN_PER_FWD))
    seq16 = seq.astype("float32").asnumpy()
    logits16 = logits.astype("float32").asnumpy()
    check(seq16.shape == (BERT_BATCH, BERT_SEQ, BERT_UNITS)
          and logits16.shape == (BERT_BATCH, BERT_PRED, BERT_VOCAB),
          "BERT outputs %s %s" % (seq16.shape, logits16.shape))
    check(onp.isfinite(seq16).all() and onp.isfinite(logits16).all(),
          "BERT bf16 forward: non-finite output")
    bf16_rel = _rel_l2(seq16, seq32)
    check(bf16_rel <= BERT_BF16_REL_L2, "BERT bf16 vs f32 sequence output: "
          "rel L2 err %.3g > %g" % (bf16_rel, BERT_BF16_REL_L2))
    fwd_ms = statistics.median(times[BERT_WARMUP:]) * 1e3
    profiles = [profile_calls(torch, step, "BERT-base forward", calls=3)] \
        if profile else []

    # the default route (composed LayerNorm), for comparison
    del os.environ["MXNET_FUSED_LAYERNORM"]
    ln0 = layernorm.LAUNCHES
    default_times = []
    for _ in range(BERT_WARMUP + 2):
        t = time.perf_counter()
        step()
        default_times.append(time.perf_counter() - t)
    check(layernorm.LAUNCHES == ln0, "the default route launched the "
          "LayerNorm kernel")
    default_ms = statistics.median(default_times[BERT_WARMUP:]) * 1e3
    n_tokens = BERT_BATCH * BERT_SEQ
    return {"forward_ms": fwd_ms, "forward_ms_all": [t * 1e3 for t in times],
            "tokens_per_s": n_tokens * 1e3 / fwd_ms,
            "valid_tokens_per_s": float(lens.sum()) * 1e3 / fwd_ms,
            "peak_bytes": peak_bytes, "attention_launches": launches[0],
            "bhtd_attention_launches": bhtd_launches,
            "layernorm_launches": launches[1], "forwards": n_fwd,
            "bf16_vs_f32_rel_l2": bf16_rel, "parity_rel_l2": parity,
            "parity_s": parity_s, "default_route_forward_ms": default_ms,
            "valid_tokens": int(lens.sum()), "profiles": profiles,
            "logits": logits}


def _mlm_step(mx, net, trainer, ce, x, vl, mp, labels):
    """One masked-LM training step through the Gluon entry points, as
    bench.py's config-5 step computes it: softmax cross entropy over the
    masked positions' logits, its mean over their rows, backward, one Adam
    update (the one parameter the batch never reaches is skipped).
    Returns the per-row losses and their mean, the loss the step
    differentiates, as NDArrays on the step's device."""
    with mx.autograd.record():
        _, logits = net(x, None, None, vl, mp)
        rows = ce(logits.reshape(-1, BERT_VOCAB), labels.reshape(-1))
        loss = rows.mean()
    loss.backward()
    trainer.step(1, ignore_stale_grad=True)
    return rows, loss


def _adam(mx, net):
    from mxnet_tpu_torch import gluon
    return gluon.Trainer(net.collect_params(), "adam",
                         {"learning_rate": BERT_LR})


def bert_train_card_vs_cpu(torch, mx, seed, hybridize=False, floor=True):
    """One f32 training step of BERT-base at batch 2, S 128 from the same
    weights on the card (the kernels; the net hybridized, its step
    graphed, with ``hybridize``) and on the CPU (the plain versions), and,
    as the floor of what summation order alone does, the CPU step again
    on one thread (unless not ``floor``: None then).  Returns the loss rel
    error and the update errors of the card and of the floor."""
    import numpy as onp
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.utils import load_jax_params
    rs = onp.random.RandomState(seed + 3)
    S = BERT_PARITY_SEQ
    tokens = rs.randint(0, BERT_VOCAB, (2, S)).astype("float32")
    lens = onp.array(BERT_PARITY_LENS, "int32")
    pos = onp.sort(onp.stack([rs.choice(min(BERT_PARITY_LENS),
                                        BERT_PARITY_PRED, replace=False)
                              for _ in range(2)]), 1).astype("int32")
    labels = rs.randint(0, BERT_VOCAB, (2, BERT_PARITY_PRED)) \
        .astype("float32")
    ce = gluon.loss.SoftmaxCrossEntropyLoss()

    def step(net, ctx):
        _, loss = _mlm_step(mx, net, _adam(mx, net), ce,
                         mx.nd.array(tokens, ctx=ctx),
                         mx.nd.array(lens, ctx=ctx, dtype="int32"),
                         mx.nd.array(pos, ctx=ctx, dtype="int32"),
                         mx.nd.array(labels, ctx=ctx))
        return loss.asnumpy(), _param_arrays(net)
    mx.random.seed(seed)
    gnet = _bert(mx, use_pooler=False)
    gnet.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    with mx.autograd.predict_mode():
        gnet(mx.nd.array(tokens, ctx=mx.gpu(0)))
    w0 = _param_arrays(gnet)
    gnet.hybridize(hybridize)
    gpu_loss, w1_gpu = step(gnet, mx.gpu(0))
    del gnet
    cnet = _bert(mx, use_pooler=False)
    cnet.initialize(ctx=mx.cpu())

    def cpu_step():
        load_jax_params(cnet, w0)
        return step(cnet, mx.cpu())
    floor_errors = None
    with mx.cpu():
        cpu_loss, w1_cpu = cpu_step()
        if floor:
            threads = torch.get_num_threads()
            torch.set_num_threads(1)
            _, w1_cpu1 = cpu_step()
            torch.set_num_threads(threads)
            floor_errors = _update_errors(w0, w1_cpu1, w1_cpu)
    loss_rel = float(abs(gpu_loss - cpu_loss) / abs(cpu_loss))
    return (loss_rel, _update_errors(w0, w1_gpu, w1_cpu), floor_errors)


def bert_training_phase(torch, mx, attention, layernorm, seed, card,
                        profile=False):
    """BERT-base masked-LM pretraining on the card through
    ``autograd.record``, ``backward`` and ``gluon.Trainer`` (Adam), bf16,
    batch 24 x 512, with the fused LayerNorm route; returns the numbers.
    The card-vs-CPU step runs first."""
    import numpy as onp
    from mxnet_tpu_torch import gluon
    os.environ["MXNET_FUSED_LAYERNORM"] = "1"
    t0 = time.perf_counter()
    loss_rel, (update_rel, per_param), (floor_rel, floor_param) = \
        bert_train_card_vs_cpu(torch, mx, seed)
    parity_s = time.perf_counter() - t0
    print("bert training: card vs CPU, one f32 Adam step at batch 2, S %d: "
          "loss rel err %.3g, update rel L2 err %.3g over all parameters; "
          "worst parameters %s" % (BERT_PARITY_SEQ, loss_rel, update_rel,
                                   ", ".join("%s %.3g" % (k, e)
                                             for e, k in per_param[:4])))
    print("bert training: floor, CPU on 1 thread vs CPU on %d: update rel "
          "L2 err %.3g over all parameters; worst parameters %s"
          % (torch.get_num_threads(), floor_rel,
             ", ".join("%s %.3g" % (k, e) for e, k in floor_param[:4])))
    check(loss_rel <= BERT_TRAIN_PARITY_LOSS_RTOL,
          "BERT card vs CPU loss rel err %.3g > %g"
          % (loss_rel, BERT_TRAIN_PARITY_LOSS_RTOL))
    check(update_rel <= BERT_TRAIN_PARITY_UPDATE_REL_L2,
          "BERT card vs CPU update: rel L2 err %.3g > %g"
          % (update_rel, BERT_TRAIN_PARITY_UPDATE_REL_L2))
    check(per_param[0][0] <= BERT_TRAIN_PARITY_PARAM_REL_L2,
          "BERT card vs CPU update of %s: rel L2 err %.3g > %g"
          % (per_param[0][1], per_param[0][0],
             BERT_TRAIN_PARITY_PARAM_REL_L2))
    torch.cuda.empty_cache()

    tokens, lens, pos = bert_inputs(seed)
    labels = onp.random.RandomState(seed + 2).randint(
        0, BERT_VOCAB, (BERT_BATCH, BERT_PRED)).astype("float32")
    gpu = mx.gpu(0)
    x = mx.nd.array(tokens, ctx=gpu)
    vl = mx.nd.array(lens, ctx=gpu, dtype="int32")
    mp = mx.nd.array(pos, ctx=gpu, dtype="int32")
    y = mx.nd.array(labels, ctx=gpu)
    mx.random.seed(seed)
    net = _bert(mx, use_pooler=False)
    net.initialize(mx.init.Xavier(), ctx=gpu)
    with mx.autograd.predict_mode():
        net(x, None, None, vl, mp)          # settles the deferred shapes
    net.cast("bfloat16")
    trainer = _adam(mx, net)
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    params = net._collect_params_with_prefix()

    def step():
        # the step's own loss is the bf16 mean; the fp32 mean of the bf16
        # row losses reports it with more digits
        rows, _ = _mlm_step(mx, net, trainer, ce, x, vl, mp, y)
        return float(rows.astype("float32").mean().asscalar())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts from 0 just before, read just after
    attention.LAUNCHES = attention.BWD_LAUNCHES = 0
    attention.BSHD_LAUNCHES = attention.BSHD_BWD_LAUNCHES = 0
    layernorm.LAUNCHES = layernorm.BWD_LAUNCHES = 0
    losses, times = [], []
    grads_checked = False
    for _ in range(BERT_TRAIN_WARMUP + BERT_TRAIN_TIMED):
        t = time.perf_counter()
        losses.append(step())
        times.append(time.perf_counter() - t)
        if not grads_checked:
            # after one step: every gradient finite, every one the batch
            # reaches non-zero, the unreached one 0; weights and gradients
            # stay bf16 and no weight keeps a graph
            for k, p in params.items():
                w, g = p.data().astorch(), p.grad().astorch()
                check(w.dtype == g.dtype == torch.bfloat16,
                      "%s: weight %s, gradient %s" % (k, w.dtype, g.dtype))
                check(w.grad_fn is None, "%s keeps a graph" % k)
                check(bool(torch.isfinite(g).all()),
                      "%s: non-finite gradient" % k)
                check(bool(g.any()) == (k not in BERT_UNREACHED),
                      "%s: gradient %s 0" % (k, "is" if k not in
                                              BERT_UNREACHED else "is not"))
            grads_checked = True
    launches = (attention.BSHD_LAUNCHES, attention.BSHD_BWD_LAUNCHES,
                layernorm.LAUNCHES, layernorm.BWD_LAUNCHES)
    bhtd_launches = (attention.LAUNCHES, attention.BWD_LAUNCHES)
    peak_bytes = torch.cuda.max_memory_allocated()
    n_steps = BERT_TRAIN_WARMUP + BERT_TRAIN_TIMED
    want = (BERT_ATTN_PER_STEP * n_steps,) * 2 + \
        (BERT_LN_PER_STEP * n_steps,) * 2
    check(launches == want and bhtd_launches == (0, 0),
          "launches in %d steps: (B, T, H, D) attention fwd %d bwd %d, "
          "LayerNorm fwd %d bwd %d (want %d, %d, %d and %d a step), (B, H, "
          "T, D) attention fwd %d bwd %d (want 0)"
          % ((n_steps,) + launches + (BERT_ATTN_PER_STEP,
                                      BERT_ATTN_PER_STEP, BERT_LN_PER_STEP,
                                      BERT_LN_PER_STEP) + bhtd_launches))
    check(all(onp.isfinite(losses)), "non-finite loss: %r" % losses)
    check(min(losses[-LOSS_WINDOW:]) < losses[0] - BERT_LOSS_FALL,
          "loss did not fall by %g: %r" % (BERT_LOSS_FALL, losses))
    states = trainer._updater.states
    check(all(s.astorch().dtype == torch.bfloat16
              for st in states.values() for s in st),
          "Adam state is not bf16")
    step_ms = statistics.median(times[BERT_TRAIN_WARMUP:]) * 1e3
    profiles = [profile_calls(torch, step, "BERT-base training step",
                              calls=3)] if profile else []
    del os.environ["MXNET_FUSED_LAYERNORM"]
    n_tokens = BERT_BATCH * BERT_SEQ
    return {"losses": losses, "step_ms": step_ms,
            "step_ms_all": [t * 1e3 for t in times],
            "tokens_per_s": n_tokens * 1e3 / step_ms,
            "valid_tokens_per_s": float(lens.sum()) * 1e3 / step_ms,
            "valid_tokens": int(lens.sum()), "peak_bytes": peak_bytes,
            "attention_launches": launches[0],
            "attention_bwd_launches": launches[1],
            "bhtd_attention_launches": bhtd_launches,
            "layernorm_launches": launches[2],
            "layernorm_bwd_launches": launches[3], "steps": n_steps,
            "parity_loss_rel": loss_rel, "parity_update_rel_l2": update_rel,
            "parity_worst_params": per_param[:4],
            "parity_floor_rel_l2": floor_rel,
            "parity_floor_worst": floor_param[:4], "parity_s": parity_s,
            "profiles": profiles}


# ---------------------------------------------------------------------------
# mixed precision: contrib.amp on BERT-base's pretraining step
# ---------------------------------------------------------------------------

# BERT-base's MLM step under amp.init(dtype) through gluon.Trainer, as
# GluonNLP's fp16 pretraining runs it: float32 Xavier weights, Adam lr 1e-4
# with float32 state, amp.init_trainer and amp.scale_loss around backward.
# float16: 13 steps, the step ms the median of the last 10; bfloat16: 3.
AMP_STEPS = {"float16": 13, "bfloat16": 3}
AMP_TIMED = 10
# Under float16 a step whose gradients overflow is skipped and the scale
# halved (the loss itself, the float32 mean of the float16 row losses, does
# not overflow).  The losses of the steps taken must fall: the lowest of the
# last AMP_LOSS_WINDOW taken below the first taken by AMP_LOSS_FALL (bf16
# BERT-base fell 1.4 in 13 steps, PERF.md); with bfloat16's 3 steps, the
# last below the first.
AMP_LOSS_WINDOW = 3
AMP_LOSS_FALL = 0.25
# One AMP step of a 2-layer BERT (BERT-base widths, batch 2, S 128) on the
# card against the same step of the port on the CPU, from the same float32
# weights, at a loss scale of 2**10 on both sides (so that the float16
# step is taken whatever the first scale would do): the loss, the float32
# mean of the 16-bit row losses, within 2 ulps of the 16-bit type, relative
# 2e-3 (1.6e-2 for bf16); the gradients, the float32 buffers of the scaled
# loss's backward, within a relative L2 error of AMP_PARITY_GRAD_REL_L2
# over all parameters and AMP_PARITY_PARAM_REL_L2 for any one.  Each side
# rounds every 16-bit op's output once (torch's CPU and CUDA kernels both
# sum in fp32), so they differ by the order of summation, which moves a
# rounding by an ulp (2**-11 relative in float16, 2**-8 in bf16) here and
# there, through 2 layers and a 30522-word decoder: measured on an H100,
# 6.6e-4 (float16) and 5.3e-3 (bf16) over all parameters, 9.8e-4 and
# 7.6e-3 for the worst (PERF.md).  The script prints the CPU's own
# floor (1 thread against N) beside the card's error.
AMP_PARITY_LAYERS = 2
AMP_PARITY_SCALE = 2.0 ** 10
AMP_PARITY_LOSS_RTOL = {"float16": 2e-3, "bfloat16": 1.6e-2}
AMP_PARITY_GRAD_REL_L2 = {"float16": 5e-3, "bfloat16": 3e-2}
AMP_PARITY_PARAM_REL_L2 = {"float16": 2e-2, "bfloat16": 6e-2}


def _grad_arrays(net):
    return {k: p.grad().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _grad_errors(g, g_ref):
    """Relative L2 error of the gradients ``g`` against ``g_ref``: over all
    parameters together, and each parameter's own (worst first; a
    parameter whose reference gradient is 0 must be 0)."""
    import numpy as onp
    per_param, err2, ref2 = [], 0.0, 0.0
    for k, r in g_ref.items():
        diff = g[k].astype("float64") - r.astype("float64")
        ref = float(onp.linalg.norm(r.astype("float64")))
        err2 += float(onp.sum(diff * diff))
        ref2 += ref * ref
        if ref == 0.0:
            check(not g[k].any(), "parity: %s has a gradient on one side "
                  "only" % k)
            continue
        per_param.append((float(onp.linalg.norm(diff)) / ref, k))
    per_param.sort(reverse=True)
    return (err2 / ref2) ** 0.5, per_param


def _amp_step(mx, net, trainer, ce, x, vl, mp, labels):
    """One masked-LM step under AMP through the Gluon entry points, as
    GluonNLP's mixed-precision pretraining takes it: the loss as in
    ``_mlm_step``, ``amp.scale_loss`` around ``backward``, then
    ``trainer.step`` (which skips the update on an overflow).  Returns the
    mean loss (an NDArray in the logits' dtype) and whether the step was
    skipped."""
    from mxnet_tpu_torch.contrib import amp
    with mx.autograd.record():
        _, logits = net(x, None, None, vl, mp)
        loss = ce(logits.reshape(-1, BERT_VOCAB), labels.reshape(-1)).mean()
        with amp.scale_loss(loss, trainer) as scaled:
            scaled.backward()
    trainer.step(1, ignore_stale_grad=True)
    return loss, trainer._amp_loss_scaler._has_overflow


def amp_card_vs_cpu(torch, mx, seed, dtype):
    """One AMP step of a 2-layer BERT (BERT-base widths) at batch 2, S 128
    from the same float32 weights on the card and on the CPU, and on the
    CPU again on one thread: the loss rel error and the gradient errors of
    the card and of the floor."""
    import numpy as onp
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.contrib import amp
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTModel
    from mxnet_tpu_torch.gluon.utils import load_jax_params
    rs = onp.random.RandomState(seed + 6)
    S = BERT_PARITY_SEQ
    tokens = rs.randint(0, BERT_VOCAB, (2, S)).astype("float32")
    lens = onp.array(BERT_PARITY_LENS, "int32")
    pos = onp.sort(onp.stack([rs.choice(min(BERT_PARITY_LENS),
                                        BERT_PARITY_PRED, replace=False)
                              for _ in range(2)]), 1).astype("int32")
    labels = rs.randint(0, BERT_VOCAB, (2, BERT_PARITY_PRED)) \
        .astype("float32")
    ce = gluon.loss.SoftmaxCrossEntropyLoss()

    def build(ctx):
        net = BERTModel(vocab_size=BERT_VOCAB, units=BERT_UNITS,
                        hidden_size=4 * BERT_UNITS,
                        num_layers=AMP_PARITY_LAYERS, num_heads=BERT_HEADS,
                        max_length=BERT_SEQ, dropout=0.0, use_pooler=False,
                        use_decoder=True)
        net.initialize(mx.init.Xavier(), ctx=ctx)
        with mx.autograd.predict_mode():
            net(mx.nd.array(tokens, ctx=ctx))
        return net

    def step(net, ctx):
        trainer = _adam(mx, net)
        amp.init_trainer(trainer)
        trainer._amp_loss_scaler.loss_scale = AMP_PARITY_SCALE \
            if dtype == "float16" else 1.0
        loss, skipped = _amp_step(
            mx, net, trainer, ce, mx.nd.array(tokens, ctx=ctx),
            mx.nd.array(lens, ctx=ctx, dtype="int32"),
            mx.nd.array(pos, ctx=ctx, dtype="int32"),
            mx.nd.array(labels, ctx=ctx))
        check(not skipped, "AMP parity step (%s) overflowed" % dtype)
        return float(loss.astype("float32").asnumpy()), _grad_arrays(net)
    mx.random.seed(seed)
    gnet = build(mx.gpu(0))
    w0 = _param_arrays(gnet)
    gpu_loss, g_gpu = step(gnet, mx.gpu(0))
    del gnet
    with mx.cpu():
        cnet = build(mx.cpu())

        def cpu_step():
            load_jax_params(cnet, w0)
            return step(cnet, mx.cpu())
        cpu_loss, g_cpu = cpu_step()
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        _, g_cpu1 = cpu_step()
        torch.set_num_threads(threads)
    return (abs(gpu_loss - cpu_loss) / abs(cpu_loss),
            _grad_errors(g_gpu, g_cpu), _grad_errors(g_cpu1, g_cpu))


def _dtype_spy(module, name, seen, arg=0):
    """Wrap ``module.name`` so that each call records the dtype of its
    argument ``arg`` in ``seen``; returns the original to put back."""
    orig = getattr(module, name)

    def spy(*args, **kwargs):
        seen.add(str(args[arg].dtype).replace("torch.", ""))
        return orig(*args, **kwargs)
    setattr(module, name, spy)
    return orig


def bert_amp_phase(torch, mx, attention, layernorm, seed, card, dtype,
                   profile=False):
    """BERT-base masked-LM pretraining under ``amp.init(dtype)`` on the
    card through ``autograd.record``, ``amp.scale_loss``, ``backward`` and
    ``gluon.Trainer`` (Adam on the float32 weights, ``amp.init_trainer``),
    batch 24 x 512, the fused LayerNorm route; the card-vs-CPU step runs
    first.  Returns the numbers; AMP is off again after it."""
    import numpy as onp
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.contrib import amp
    os.environ["MXNET_FUSED_LAYERNORM"] = "1"
    amp.init(dtype)
    try:
        t0 = time.perf_counter()
        loss_rel, (grad_rel, per_param), (floor_rel, floor_param) = \
            amp_card_vs_cpu(torch, mx, seed, dtype)
        parity_s = time.perf_counter() - t0
        print("bert amp %s: card vs CPU, one AMP step of a %d-layer BERT at "
              "batch 2, S %d: loss rel err %.3g, gradient rel L2 err %.3g "
              "over all parameters; worst parameters %s"
              % (dtype, AMP_PARITY_LAYERS, BERT_PARITY_SEQ, loss_rel,
                 grad_rel, ", ".join("%s %.3g" % (k, e)
                                     for e, k in per_param[:4])))
        print("bert amp %s: floor, CPU on 1 thread vs CPU on %d: gradient "
              "rel L2 err %.3g over all parameters; worst parameters %s"
              % (dtype, torch.get_num_threads(), floor_rel,
                 ", ".join("%s %.3g" % (k, e) for e, k in floor_param[:4])))
        check(loss_rel <= AMP_PARITY_LOSS_RTOL[dtype],
              "AMP %s card vs CPU loss rel err %.3g > %g"
              % (dtype, loss_rel, AMP_PARITY_LOSS_RTOL[dtype]))
        check(grad_rel <= AMP_PARITY_GRAD_REL_L2[dtype],
              "AMP %s card vs CPU gradients: rel L2 err %.3g > %g"
              % (dtype, grad_rel, AMP_PARITY_GRAD_REL_L2[dtype]))
        check(per_param[0][0] <= AMP_PARITY_PARAM_REL_L2[dtype],
              "AMP %s card vs CPU gradient of %s: rel L2 err %.3g > %g"
              % (dtype, per_param[0][1], per_param[0][0],
                 AMP_PARITY_PARAM_REL_L2[dtype]))
        torch.cuda.empty_cache()

        tokens, lens, pos = bert_inputs(seed)
        labels = onp.random.RandomState(seed + 2).randint(
            0, BERT_VOCAB, (BERT_BATCH, BERT_PRED)).astype("float32")
        gpu = mx.gpu(0)
        x = mx.nd.array(tokens, ctx=gpu)
        vl = mx.nd.array(lens, ctx=gpu, dtype="int32")
        mp = mx.nd.array(pos, ctx=gpu, dtype="int32")
        y = mx.nd.array(labels, ctx=gpu)
        mx.random.seed(seed)
        net = _bert(mx, use_pooler=False)
        net.initialize(mx.init.Xavier(), ctx=gpu)
        with mx.autograd.predict_mode():
            net(x, None, None, vl, mp)          # settles the deferred shapes
        trainer = _adam(mx, net)
        amp.init_trainer(trainer)
        ce = gluon.loss.SoftmaxCrossEntropyLoss()
        n_steps = AMP_STEPS[dtype]
        # the dtypes that reach the attention and LayerNorm kernels' entries
        seen_attn, seen_ln = set(), set()
        spied = (_dtype_spy(attention, "flash_attention_bshd_fwd",
                            seen_attn),
                 _dtype_spy(layernorm, "layer_norm_fwd", seen_ln))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the main path: counts from 0 just before, read just after
        _reset_counts(attention, layernorm)
        losses, scales, skipped, times, per_step = [], [], [], [], []
        try:
            for _ in range(n_steps):
                before = _bert_counts(attention, layernorm)[0]
                t = time.perf_counter()
                loss, skip = _amp_step(mx, net, trainer, ce, x, vl, mp, y)
                losses.append(float(loss.astype("float32").asscalar()))
                times.append(time.perf_counter() - t)
                scales.append(trainer._amp_loss_scaler.loss_scale)
                skipped.append(bool(skip))
                after = _bert_counts(attention, layernorm)[0]
                per_step.append(tuple(a - b for a, b in zip(after, before)))
        finally:
            attention.flash_attention_bshd_fwd, layernorm.layer_norm_fwd = \
                spied
        launches, bhtd_launches = _bert_counts(attention, layernorm)
        peak_bytes = torch.cuda.max_memory_allocated()
        want = (BERT_ATTN_PER_STEP, BERT_ATTN_PER_STEP, BERT_LN_PER_STEP,
                BERT_LN_PER_STEP)
        check(all(c == want for c in per_step) and bhtd_launches == (0, 0),
              "AMP %s launches a step: (B, T, H, D) attention fwd, bwd, "
              "LayerNorm fwd, bwd %s (want %s each step), (B, H, T, D) "
              "attention %s (want 0)" % (dtype, per_step, want,
                                         bhtd_launches))
        check(seen_attn == {dtype} and seen_ln == {"float32"},
              "AMP %s: the attention kernel took %s, LayerNorm %s (want %s "
              "and float32)" % (dtype, sorted(seen_attn), sorted(seen_ln),
                                dtype))
        taken = [l for l, sk in zip(losses, skipped) if not sk]
        check(len(taken) >= 2 and all(onp.isfinite(taken)),
              "AMP %s: losses of the steps taken %r (skipped %r)"
              % (dtype, taken, skipped))
        if dtype == "float16":
            check(min(taken[-AMP_LOSS_WINDOW:]) < taken[0] - AMP_LOSS_FALL,
                  "AMP float16: loss did not fall by %g: %r"
                  % (AMP_LOSS_FALL, taken))
        else:
            check(taken[-1] < taken[0], "AMP bfloat16: loss did not fall: "
                  "%r" % taken)
        params = net._collect_params_with_prefix()
        check(all(p.data().astorch().dtype == torch.float32
                  for p in params.values())
              and all(s.astorch().dtype == torch.float32
                      for st in trainer._updater.states.values()
                      for s in st),
              "AMP %s: weights or Adam state not float32" % dtype)
        timed = times[-AMP_TIMED:]
        step_ms = statistics.median(timed) * 1e3

        def one_step():
            loss, _ = _amp_step(mx, net, trainer, ce, x, vl, mp, y)
            return float(loss.astype("float32").asscalar())
        profiles = [profile_calls(torch, one_step, "BERT-base AMP %s "
                                  "training step" % dtype, calls=3)] \
            if profile else []
    finally:
        amp.disable()
        del os.environ["MXNET_FUSED_LAYERNORM"]
    n_tokens = BERT_BATCH * BERT_SEQ
    return {"dtype": dtype, "losses": losses, "loss_scales": scales,
            "skipped": skipped, "steps": n_steps, "step_ms": step_ms,
            "timed_steps": len(timed),
            "step_ms_all": [t * 1e3 for t in times],
            "tokens_per_s": n_tokens * 1e3 / step_ms,
            "valid_tokens_per_s": float(lens.sum()) * 1e3 / step_ms,
            "peak_bytes": peak_bytes, "attention_launches": launches[0],
            "attention_bwd_launches": launches[1],
            "layernorm_launches": launches[2],
            "layernorm_bwd_launches": launches[3],
            "attention_dtypes": sorted(seen_attn),
            "layernorm_dtypes": sorted(seen_ln),
            "parity_loss_rel": loss_rel, "parity_grad_rel_l2": grad_rel,
            "parity_worst_params": per_param[:4],
            "parity_floor_rel_l2": floor_rel,
            "parity_floor_worst": floor_param[:4], "parity_s": parity_s,
            "profiles": profiles}


def print_amp(r, card):
    print("bert amp %s: BERT-base MLM step under amp.init(%r), batch %d x "
          "%d, Adam lr %g on float32 weights, %d steps, losses %s, loss "
          "scale after each step %s, skipped for overflow %s"
          % (r["dtype"], r["dtype"], BERT_BATCH, BERT_SEQ, BERT_LR,
             r["steps"], [round(v, 4) for v in r["losses"]],
             r["loss_scales"], [i for i, sk in enumerate(r["skipped"])
                                if sk]))
    print("bert amp %s: step %.3f ms (median of the last %d) = %.0f tokens/s "
          "(%.0f valid tokens/s), peak device memory %.2f GiB, launches "
          "(B, T, H, D) attention fwd %d bwd %d (%s), LayerNorm fwd %d bwd "
          "%d (%s), card vs CPU check %.1f s (%s)"
          % (r["dtype"], r["step_ms"], r["timed_steps"], r["tokens_per_s"],
             r["valid_tokens_per_s"], r["peak_bytes"] / 2 ** 30,
             r["attention_launches"], r["attention_bwd_launches"],
             "/".join(r["attention_dtypes"]), r["layernorm_launches"],
             r["layernorm_bwd_launches"], "/".join(r["layernorm_dtypes"]),
             r["parity_s"], card))
    print("bert amp %s: step ms %s" % (r["dtype"], [round(v, 3) for v in
                                                   r["step_ms_all"]]))
    print_profiles(r["profiles"], card)


# BERT encoders at BERT-base's width with the wide head dims: 768 units as 4
# heads of 192 or 3 of 256 (the attention layer's work and bytes are
# BERT-base's), 3072 hidden, 12 layers, bf16, 24 x 512, Adam lr 1e-4
WIDE_HEADS = {192: 4, 256: 3}


def wide_encoder_phase(torch, mx, attention, layernorm, seed, card):
    """For D 192 and 256: BERT-base's network with ``WIDE_HEADS[D]`` heads
    in bf16 at 24 x 512, one forward, then one Adam step through
    ``autograd.record``, ``backward`` and ``gluon.Trainer``; the launches
    of each counted from 0 and checked, the outputs and the loss finite.
    Returns the numbers by D."""
    import numpy as onp
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTModel
    os.environ["MXNET_FUSED_LAYERNORM"] = "1"
    tokens, lens, pos = bert_inputs(seed)
    labels = onp.random.RandomState(seed + 2).randint(
        0, BERT_VOCAB, (BERT_BATCH, BERT_PRED)).astype("float32")
    gpu = mx.gpu(0)
    x = mx.nd.array(tokens, ctx=gpu)
    vl = mx.nd.array(lens, ctx=gpu, dtype="int32")
    mp = mx.nd.array(pos, ctx=gpu, dtype="int32")
    y = mx.nd.array(labels, ctx=gpu)
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    out = {}
    for D, heads in WIDE_HEADS.items():
        mx.random.seed(seed)
        net = BERTModel(vocab_size=BERT_VOCAB, units=BERT_UNITS,
                        hidden_size=4 * BERT_UNITS, num_layers=BERT_LAYERS,
                        num_heads=heads, max_length=BERT_SEQ, dropout=0.0,
                        use_pooler=False, use_decoder=True)
        net.initialize(mx.init.Xavier(), ctx=gpu)
        with mx.autograd.predict_mode():
            net(x, None, None, vl, mp)
        net.cast("bfloat16")
        trainer = _adam(mx, net)
        torch.cuda.synchronize()
        _reset_counts(attention, layernorm)
        t = time.perf_counter()
        seq, logits = net(x, None, None, vl, mp)
        finite = bool(torch.isfinite(seq.astorch()).all()) and \
            bool(torch.isfinite(logits.astorch()).all())
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t) * 1e3
        fwd_counts = _bert_counts(attention, layernorm)
        check(finite and seq.shape == (BERT_BATCH, BERT_SEQ, BERT_UNITS),
              "D %d encoder: forward gave %s, finite %s" % (D, seq.shape,
                                                            finite))
        check(fwd_counts == ((BERT_ATTN_PER_FWD, 0, BERT_LN_PER_FWD, 0),
                             (0, 0)),
              "D %d encoder forward: launches %s" % (D, fwd_counts))
        _reset_counts(attention, layernorm)
        t = time.perf_counter()
        rows, _ = _mlm_step(mx, net, trainer, ce, x, vl, mp, y)
        loss = float(rows.astype("float32").mean().asscalar())
        step_ms = (time.perf_counter() - t) * 1e3
        step_counts = _bert_counts(attention, layernorm)
        check(onp.isfinite(loss), "D %d encoder: loss %r" % (D, loss))
        check(step_counts == ((BERT_ATTN_PER_STEP, BERT_ATTN_PER_STEP,
                               BERT_LN_PER_STEP, BERT_LN_PER_STEP), (0, 0)),
              "D %d encoder step: launches %s" % (D, step_counts))
        out[D] = {"heads": heads, "forward_ms": fwd_ms, "step_ms": step_ms,
                  "loss": loss, "forward_launches": fwd_counts[0],
                  "step_launches": step_counts[0]}
        print("wide heads: BERT encoder at 768 units, %d heads of D %d, "
              "bf16, 24 x 512: one forward %.3f ms (attention launches %d, "
              "LayerNorm %d), one Adam step %.3f ms, loss %.4f (launches "
              "(B, T, H, D) attention fwd %d bwd %d, LayerNorm fwd %d bwd %d;"
              " one call each, first-call costs included)  (%s)"
              % ((heads, D, fwd_ms, fwd_counts[0][0], fwd_counts[0][2],
                  step_ms, loss) + step_counts[0] + (card,)))
        del net, trainer, seq, logits, rows
        torch.cuda.empty_cache()
    del os.environ["MXNET_FUSED_LAYERNORM"]
    return out


# ---------------------------------------------------------------------------
# data-parallel training: DataParallelStep and Trainer(kvstore="nccl")
# ---------------------------------------------------------------------------

# One f32 DataParallelStep of BERT at DP_PARITY_LAYERS layers on the card
# against the same step on the CPU (batch 2, S 128, the same weights), held
# to the BERT training phase's tolerances (BERT_TRAIN_PARITY_*), with the
# CPU's 1-thread floor printed beside them.
DP_PARITY_LAYERS = 2
# ResNet-50 through DataParallelStep as bench.py builds it: SGD with
# rescale_grad = 1 / batch on top of the step's mean loss, an effective
# rate of 0.1 / 32, so the loss is only held to fall (the lowest of the
# last five steps below the first)
DP_RESNET_SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
                 "rescale_grad": 1.0 / TRAIN_BATCH}

# BASELINE.json config 4, the LSTM LM, as bench.py:bench_lstm_lm builds it:
# Embedding(10000, 650), a 2-layer NTC LSTM of 650, Dense(10000), softmax
# cross entropy, SGD lr 1.0 with rescale_grad = 1/32, batch 32 x bptt 35,
# 6 warm-up and 20 timed steps, float32 and bfloat16
LM_VOCAB, LM_HIDDEN, LM_LAYERS = 10000, 650, 2
LM_BATCH, LM_BPTT = 32, 35
LM_WARMUP, LM_TIMED = 6, 20
# The loss must fall.  At bench.py's rate (1/32 a step) 26 steps move the
# loss by about 1e-3, below one bf16 ulp of the loss (0.0625 at 9.2), and
# most bf16 weight updates round away (bf16 has no master weights here, as
# in the JAX package), so the fall is read on the cross entropy of the
# model's logits taken in float32, before the first step and after the
# last, for both dtypes; the float32 step losses must fall too.
# One f32 step of a narrow 2-layer LM on the card (cuDNN's LSTM, TF32 off)
# against the CPU (torch's native cells), from the same weights: the loss
# within rel 1e-5, the updates w1 - w0 within a relative L2 error of 1e-3
# over all parameters and 1e-2 for any one (the BERT step's tolerances);
# the CPU's 1-thread-vs-N floor is printed beside them.
LM_PARITY = {"vocab": 1000, "hidden": 128, "layers": 2, "batch": 8,
             "bptt": 35}
LM_PARITY_LOSS_RTOL = 1e-5
LM_PARITY_UPDATE_REL_L2 = 1e-3
LM_PARITY_PARAM_REL_L2 = 1e-2
# The word-LM example's model (example/rnn/word_lm/train.py) at its
# defaults: embedding = hidden 200, 2 layers, dropout 0.2, tied weights,
# SGD lr 20 with clip_gradient 0.25, batch 32 x bptt 35, on its synthetic
# corpus (30000 tokens over 200 words); the mean loss of the last 10 of
# WORD_LM_STEPS steps must be below that of the first 10.  At that rate the
# loss sits near ln(vocab) for about 100 steps, falling by about 0.02, then
# drops; past about 130 steps some seeds diverge, in the JAX package's
# example too (``--synthetic --tied --seed 2``: perplexity 181 in epoch 3,
# 2.7e6 in epoch 4, on the CPU).  So the phase takes 60 steps, where each
# of seeds 0-2 fell by 0.02 on the CPU and none diverged.
WORD_LM = {"embed": 200, "hidden": 200, "layers": 2, "dropout": 0.2,
           "lr": 20.0, "clip": 0.25, "batch": 32, "bptt": 35}
WORD_LM_STEPS = 60
WORD_LM_WINDOW = 10


def _mlm_loss(gluon):
    class MLMLoss(gluon.loss.Loss):
        """bench.py's MLMLoss: softmax cross entropy over the masked
        positions' logits, one value a masked row."""

        def __init__(self):
            super().__init__(weight=None, batch_axis=0)
            self._ce = gluon.loss.SoftmaxCrossEntropyLoss()

        def hybrid_forward(self, F, outputs, lab):
            _, logits = outputs
            return self._ce(logits.reshape(-1, BERT_VOCAB), lab.reshape(-1))
    return MLMLoss()


def _nccl_device_ms(torch, fn, calls=3):
    """torch.profiler over ``calls`` calls of ``fn``: the device time a
    call of the kernels and copies whose names say NCCL, and their
    names."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
    avgs = prof.key_averages()
    key = "self_device_time_total" if hasattr(
        avgs[0], "self_device_time_total") else "self_cuda_time_total"
    nccl = [a for a in avgs if "nccl" in a.key.lower()
            and getattr(a, key) > 0]
    return (sum(getattr(a, key) for a in nccl) / 1e3 / calls,
            sorted({a.key[:60] for a in nccl}))


def dp_bert_card_vs_cpu(torch, mx, seed, make_opt=None):
    """One f32 DataParallelStep (no mesh) of BERT at DP_PARITY_LAYERS
    layers, batch 2, S 128, from the same weights on the card and on the
    CPU, and the CPU again on one thread: the loss rel error and the update
    errors of the card and of the floor.  ``make_opt()`` builds the
    optimizer (default Adam at ``BERT_LR``)."""
    import numpy as onp
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTModel
    from mxnet_tpu_torch.gluon.utils import load_jax_params
    rs = onp.random.RandomState(seed + 5)
    S = BERT_PARITY_SEQ
    tokens = rs.randint(0, BERT_VOCAB, (2, S)).astype("float32")
    lens = onp.array(BERT_PARITY_LENS, "int32")
    pos = onp.sort(onp.stack([rs.choice(min(BERT_PARITY_LENS),
                                        BERT_PARITY_PRED, replace=False)
                              for _ in range(2)]), 1).astype("int32")
    labels = rs.randint(0, BERT_VOCAB, (2, BERT_PARITY_PRED)) \
        .astype("float32")

    def build(ctx):
        net = BERTModel(vocab_size=BERT_VOCAB, units=BERT_UNITS,
                        hidden_size=4 * BERT_UNITS,
                        num_layers=DP_PARITY_LAYERS, num_heads=BERT_HEADS,
                        max_length=BERT_SEQ, dropout=0.0, use_pooler=False,
                        use_decoder=True)
        net.initialize(mx.init.Xavier(), ctx=ctx)
        with mx.autograd.predict_mode():
            net(mx.nd.array(tokens, ctx=ctx))
        return net

    def step(net, ctx):
        opt = make_opt() if make_opt is not None \
            else mx.optimizer.Adam(learning_rate=BERT_LR)
        dp = mx.parallel.DataParallelStep(net, _mlm_loss(gluon), opt)
        loss = dp((mx.nd.array(tokens, ctx=ctx), None, None,
                   mx.nd.array(lens, ctx=ctx, dtype="int32"),
                   mx.nd.array(pos, ctx=ctx, dtype="int32")),
                  mx.nd.array(labels, ctx=ctx))
        return float(loss.asnumpy()), _param_arrays(net)
    mx.random.seed(seed)
    gnet = build(mx.gpu(0))
    w0 = _param_arrays(gnet)
    gpu_loss, w1_gpu = step(gnet, mx.gpu(0))
    del gnet
    with mx.cpu():
        cnet = build(mx.cpu())

        def cpu_step():
            load_jax_params(cnet, w0)
            return step(cnet, mx.cpu())
        cpu_loss, w1_cpu = cpu_step()
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        _, w1_cpu1 = cpu_step()
        torch.set_num_threads(threads)
    return (abs(gpu_loss - cpu_loss) / abs(cpu_loss),
            _update_errors(w0, w1_gpu, w1_cpu),
            _update_errors(w0, w1_cpu1, w1_cpu))


def _reset_counts(attention, layernorm):
    attention.LAUNCHES = attention.BWD_LAUNCHES = 0
    attention.BSHD_LAUNCHES = attention.BSHD_BWD_LAUNCHES = 0
    layernorm.LAUNCHES = layernorm.BWD_LAUNCHES = 0


def _bert_counts(attention, layernorm):
    return ((attention.BSHD_LAUNCHES, attention.BSHD_BWD_LAUNCHES,
             layernorm.LAUNCHES, layernorm.BWD_LAUNCHES),
            (attention.LAUNCHES, attention.BWD_LAUNCHES))


def _bench_bert_bf16(mx, seed, tokens):
    """BERT-base as bench.py's ``_build_bert_step`` builds it: Xavier
    weights from ``seed`` and the deferred shapes settled on the host,
    cast to bf16, then ``reset_ctx`` onto the card."""
    mx.random.seed(seed)
    net = _bert(mx, use_pooler=False)
    with mx.cpu():
        net.initialize(mx.init.Xavier())
        with mx.autograd.predict_mode():   # deferred shapes, on the host
            net(mx.nd.array(tokens[:1, :8]), None, None,
                mx.nd.array([8], dtype="int32"),
                mx.nd.array([[0, 1]], dtype="int32"))
    net.cast("bfloat16")
    net.collect_params().reset_ctx(mx.gpu(0))
    return net


def dp_bert_phase(torch, mx, attention, layernorm, seed, card, mesh,
                  profile=False):
    """BERT-base pretraining through ``parallel.DataParallelStep``, built as
    bench.py's ``_build_bert_step`` builds it (Xavier weights on the host,
    deferred shapes settled there, cast to bf16, ``reset_ctx`` onto the
    card; Adam, lr 1e-4, the masked-LM loss), at 24 x 512: 3 warm-up and
    10 timed steps without a mesh, then the same steps from the same
    weights (set again) and a fresh Adam on the one-rank NCCL ``mesh``
    with ``shard_optimizer=True``, which must give the same bits.  The
    card-vs-CPU step runs first."""
    import numpy as onp
    from mxnet_tpu_torch import gluon
    os.environ["MXNET_FUSED_LAYERNORM"] = "1"
    t0 = time.perf_counter()
    loss_rel, (update_rel, per_param), (floor_rel, floor_param) = \
        dp_bert_card_vs_cpu(torch, mx, seed)
    parity_s = time.perf_counter() - t0
    print("dp bert: card vs CPU, one f32 DataParallelStep of a %d-layer "
          "BERT at batch 2, S %d: loss rel err %.3g, update rel L2 err %.3g "
          "over all parameters (floor, CPU on 1 thread vs %d: %.3g); worst "
          "parameters %s" % (DP_PARITY_LAYERS, BERT_PARITY_SEQ, loss_rel,
                             update_rel, torch.get_num_threads(), floor_rel,
                             ", ".join("%s %.3g" % (k, e)
                                       for e, k in per_param[:4])))
    check(loss_rel <= BERT_TRAIN_PARITY_LOSS_RTOL,
          "DP BERT card vs CPU loss rel err %.3g > %g"
          % (loss_rel, BERT_TRAIN_PARITY_LOSS_RTOL))
    check(update_rel <= BERT_TRAIN_PARITY_UPDATE_REL_L2,
          "DP BERT card vs CPU update: rel L2 err %.3g > %g"
          % (update_rel, BERT_TRAIN_PARITY_UPDATE_REL_L2))
    check(per_param[0][0] <= BERT_TRAIN_PARITY_PARAM_REL_L2,
          "DP BERT card vs CPU update of %s: rel L2 err %.3g > %g"
          % (per_param[0][1], per_param[0][0],
             BERT_TRAIN_PARITY_PARAM_REL_L2))

    tokens, lens, pos = bert_inputs(seed)
    labels = onp.random.RandomState(seed + 2).randint(
        0, BERT_VOCAB, (BERT_BATCH, BERT_PRED)).astype("float32")
    gpu = mx.gpu(0)
    x = mx.nd.array(tokens, ctx=gpu)
    vl = mx.nd.array(lens, ctx=gpu, dtype="int32")
    mp = mx.nd.array(pos, ctx=gpu, dtype="int32")
    y = mx.nd.array(labels, ctx=gpu)

    def train(net, mesh, shard):
        step = mx.parallel.DataParallelStep(
            net, _mlm_loss(gluon), mx.optimizer.Adam(learning_rate=BERT_LR),
            mesh=mesh, shard_optimizer=shard)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the main path: counts from 0 just before, read just after
        _reset_counts(attention, layernorm)
        losses, times = [], []
        for _ in range(BERT_TRAIN_WARMUP + BERT_TRAIN_TIMED):
            t = time.perf_counter()
            losses.append(step((x, None, None, vl, mp), y).astorch())
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        counts = _bert_counts(attention, layernorm)
        run = {"losses": [float(v.float()) for v in losses],
               "loss_bits": torch.stack(losses),
               "step_ms": statistics.median(times[BERT_TRAIN_WARMUP:]) * 1e3,
               "step_ms_all": [t * 1e3 for t in times],
               "peak_bytes": torch.cuda.max_memory_allocated(),
               "state_bytes": step.optimizer_state_bytes(per_chip=True),
               "state_bytes_total": step.optimizer_state_bytes(
                   per_chip=False),
               "launches": counts[0], "bhtd_launches": counts[1],
               "weights": [p.data().astorch().clone() for _, p in
                           sorted(net.collect_params().items())]}
        n_steps = len(losses)
        want = (BERT_ATTN_PER_STEP * n_steps,) * 2 + \
            (BERT_LN_PER_STEP * n_steps,) * 2
        check(counts[0] == want and counts[1] == (0, 0),
              "DP BERT launches in %d steps: (B, T, H, D) attention fwd %d "
              "bwd %d, LayerNorm fwd %d bwd %d (want %d, %d, %d and %d a "
              "step), (B, H, T, D) attention fwd %d bwd %d (want 0)"
              % ((n_steps,) + counts[0] + (BERT_ATTN_PER_STEP,
                                           BERT_ATTN_PER_STEP,
                                           BERT_LN_PER_STEP,
                                           BERT_LN_PER_STEP) + counts[1]))
        check(all(onp.isfinite(run["losses"])),
              "non-finite DP loss: %r" % run["losses"])
        check(all(w.dtype == torch.bfloat16 for w in run["weights"]),
              "a weight left bf16")
        if profile:
            def one():
                return step((x, None, None, vl, mp), y) \
                    .astype("float32").asscalar()
            run["profile"] = profile_calls(
                torch, one, "BERT-base DataParallelStep (%s)" % (
                    "one-rank NCCL mesh, ZeRO" if shard else "no mesh"),
                calls=3)
            run["nccl_ms"], run["nccl_kernels"] = _nccl_device_ms(torch, one)
        return run

    net = _bench_bert_bf16(mx, seed, tokens)
    w0 = [p.data().astorch().clone()
          for _, p in sorted(net.collect_params().items())]
    plain = train(net, None, False)
    for (_, p), w in zip(sorted(net.collect_params().items()), w0):
        p.set_data(w)                   # the ZeRO run starts where it did
    del w0
    torch.cuda.empty_cache()
    zero = train(net, mesh, True)
    torch.cuda.empty_cache()
    check(torch.equal(plain["loss_bits"], zero["loss_bits"])
          and all(torch.equal(a, b) for a, b in zip(plain["weights"],
                                                    zero["weights"])),
          "the one-rank NCCL ZeRO step and the step without a mesh differ")

    def counts(reset=False):
        if reset:
            _reset_counts(attention, layernorm)
        return _bert_counts(attention, layernorm)[0]
    graphs = [graphed_vs_eager(
        torch, mx, net, lambda m=m, shard=shard:
        mx.parallel.DataParallelStep(
            net, _mlm_loss(gluon), _scheduled(mx, mx.optimizer.Adam, BERT_LR),
            mesh=m, shard_optimizer=shard),
        (x, None, None, vl, mp), y, seed, what, counts=counts,
        per_step=(BERT_ATTN_PER_STEP,) * 2 + (BERT_LN_PER_STEP,) * 2,
        profile_as="bert" if profile else None)
        for m, shard, what in (
            (None, False, "BERT-base DataParallelStep, no mesh"),
            (mesh, True, "BERT-base DataParallelStep, one-rank NCCL mesh, "
                         "ZeRO"))]
    del net
    torch.cuda.empty_cache()
    for run in (plain, zero):
        losses = run["losses"]
        check(min(losses[-LOSS_WINDOW:]) < losses[0] - BERT_LOSS_FALL,
              "DP loss did not fall by %g: %r" % (BERT_LOSS_FALL, losses))
        del run["weights"], run["loss_bits"]
    del os.environ["MXNET_FUSED_LAYERNORM"]
    n_tokens = BERT_BATCH * BERT_SEQ
    for run in (plain, zero):
        run["tokens_per_s"] = n_tokens * 1e3 / run["step_ms"]
    return {"plain": plain, "zero": zero, "steps": len(plain["losses"]),
            "graphs": graphs,
            "parity_loss_rel": loss_rel, "parity_update_rel_l2": update_rel,
            "parity_worst_params": per_param[:4],
            "parity_floor_rel_l2": floor_rel,
            "parity_floor_worst": floor_param[:4], "parity_s": parity_s}


def dp_resnet_phase(torch, mx, fused_norm, seed, card, profile=False):
    """ResNet-50 v1 at batch 32 through ``parallel.DataParallelStep``, as
    bench.py builds it (Xavier weights and deferred shapes on the host,
    ``reset_ctx`` onto the card, SGD with ``rescale_grad = 1/32``, no
    mesh): 3 warm-up and 10 timed steps; then the same net, from the same
    weights, through ``Trainer(kvstore="nccl")`` on the one-rank NCCL
    group with the training phase's SGD, as many steps, and, as its
    reference, through a Trainer with no store from the same weights on
    the same batch.  Both Trainers run under ``cudnn.deterministic``
    (cuDNN's default backward-filter algorithms sum in an order that
    varies from run to run, and at this rate the trajectory follows such
    differences) and are held to the same bits: the first step's update
    (relative L2 error 0), every loss and the last weights.
    Each counts 16 forward and 16 backward epilogue launches a step."""
    import numpy as onp
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    gpu = mx.gpu(0)
    mx.random.seed(seed)
    net = resnet50_v1()
    with mx.cpu():
        net.initialize(mx.init.Xavier())
        with mx.autograd.predict_mode():
            net(mx.nd.zeros((1, 3, IMAGE_SIZE, IMAGE_SIZE)))
    net.collect_params().reset_ctx(gpu)
    rs = onp.random.RandomState(seed)
    x = mx.nd.array(rs.uniform(size=(TRAIN_BATCH, 3, IMAGE_SIZE,
                                     IMAGE_SIZE)).astype("float32"), ctx=gpu)
    y = mx.nd.array(rs.randint(0, 1000, (TRAIN_BATCH,)).astype("float32"),
                    ctx=gpu)
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    params = net._collect_params_with_prefix()
    w0 = {k: p.data().astorch().clone() for k, p in params.items()}
    step = mx.parallel.DataParallelStep(
        net, ce, mx.optimizer.SGD(**DP_RESNET_SGD), mesh=None)

    def run(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the main path: counts from 0 just before, read just after
        fused_norm.LAUNCHES = fused_norm.BWD_LAUNCHES = 0
        losses, times = [], []
        for _ in range(WARMUP_STEPS + TIMED_STEPS):
            t = time.perf_counter()
            losses.append(fn())
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        n = len(losses)
        launches = (fused_norm.LAUNCHES, fused_norm.BWD_LAUNCHES)
        losses = [float(v) for v in losses]
        check(launches == (16 * n, 16 * n),
              "%d forward and %d backward epilogue launches in %d steps "
              "(want 16 each a step)" % (launches + (n,)))
        check(all(onp.isfinite(losses)), "non-finite loss: %r" % losses)
        step_ms = statistics.median(times[WARMUP_STEPS:]) * 1e3
        return {"losses": losses, "step_ms": step_ms,
                "step_ms_all": [t * 1e3 for t in times],
                "images_per_s": TRAIN_BATCH * 1e3 / step_ms,
                "peak_bytes": torch.cuda.max_memory_allocated(),
                "fwd_launches": launches[0], "bwd_launches": launches[1],
                "steps": n}
    dp = run(lambda: step(x, y).astorch())
    check(min(dp["losses"][-LOSS_WINDOW:]) < dp["losses"][0],
          "DP ResNet loss did not fall: %r" % dp["losses"])
    dp["state_bytes"] = step.optimizer_state_bytes(per_chip=True)
    if profile:
        dp["profile"] = profile_calls(torch, lambda: step(x, y).asscalar(),
                                      "ResNet-50 DataParallelStep", calls=3)
    del step
    torch.cuda.empty_cache()

    sgd = dict(DP_RESNET_SGD)
    lr = sgd.pop("learning_rate")
    graphed = graphed_vs_eager(
        torch, mx, net, lambda: mx.parallel.DataParallelStep(
            net, ce, _scheduled(mx, mx.optimizer.SGD, lr, **sgd), mesh=None),
        x, y, seed, "ResNet-50 DataParallelStep, SGD momentum",
        counts=_epilogue_counts(fused_norm), per_step=(16, 16),
        profile_as="resnet_step" if profile else None, deterministic=True)

    def trainer_run(store):
        """The Trainer on ``store`` from ``w0``: run()'s numbers, the
        weights after the first step and after the last."""
        for k, p in params.items():
            p.set_data(w0[k])
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                dict(SGD_PARAMS), kvstore=store)
        first = {}

        def trainer_step():
            with mx.autograd.record():
                loss = ce(net(x), y)
            loss.backward()
            trainer.step(TRAIN_BATCH)
            if not first:
                first.update((k, p.data().astorch().clone())
                             for k, p in params.items())
            return loss.mean().astorch()
        out = run(trainer_step)
        last = {k: p.data().astorch().clone() for k, p in params.items()}
        return out, trainer, first, last

    was_deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        kv, trainer, kv_first, kv_last = trainer_run("nccl")
        check(trainer._kvstore.type == "nccl"
              and trainer._kvstore.num_workers == 1,
              "the Trainer's store is not the one-rank NCCL store")
        ref, trainer, ref_first, ref_last = trainer_run(None)
        check(trainer._kvstore is None, "the reference Trainer has a store")
    finally:
        torch.backends.cudnn.deterministic = was_deterministic
    err2 = sum(float(((kv_first[k] - ref_first[k]).double() ** 2).sum())
               for k in w0)
    ref2 = sum(float(((ref_first[k] - w0[k]).double() ** 2).sum())
               for k in w0)
    kv["first_update_rel_l2"] = (err2 / ref2) ** 0.5
    check(kv["first_update_rel_l2"] == 0.0,
          "Trainer(kvstore='nccl') vs no store, first step: update rel L2 "
          "err %.3g, want the same bits" % kv["first_update_rel_l2"])
    check(kv["losses"] == ref["losses"],
          "Trainer(kvstore='nccl') vs no store: losses %r and %r"
          % (kv["losses"], ref["losses"]))
    check(all(torch.equal(kv_last[k], ref_last[k]) for k in w0),
          "Trainer(kvstore='nccl') vs no store: the last weights differ")
    check(min(kv["losses"][-LOSS_WINDOW:]) < kv["losses"][0],
          "Trainer(kvstore='nccl') loss did not fall: %r" % kv["losses"])
    return {"dp": dp, "trainer_nccl": kv, "trainer_plain": ref,
            "graphs": [graphed]}


def dp_phases(torch, mx, attention, layernorm, fused_norm, seed, card,
              btrain, train, profile):
    """The data-parallel phases on the joined one-rank NCCL group, their
    lines printed; returns their numbers."""
    mesh = mx.parallel.device_mesh()
    check((mesh.size, mesh.backend) == (1, "nccl"),
          "the process group is %r, not one NCCL rank" % (mesh,))
    print("dp: joined a %s group of %d rank(s)" % (mesh.backend, mesh.size))
    dpb = dp_bert_phase(torch, mx, attention, layernorm, seed, card, mesh,
                        profile=profile)
    for name, what in (("plain", "no mesh"),
                       ("zero", "one-rank NCCL mesh, shard_optimizer=True")):
        r = dpb[name]
        print("dp bert: DataParallelStep, %s: BERT-base bf16 MLM at %d x %d, "
              "Adam lr %g, %d steps, losses %s" % (
                  what, BERT_BATCH, BERT_SEQ, BERT_LR, dpb["steps"],
                  [round(v, 4) for v in r["losses"]]))
        print("dp bert: %s: step %.3f ms (median of %d) = %.0f tokens/s, "
              "peak device memory %.2f GiB, optimizer state %d bytes a rank "
              "(%d in all), launches (B, T, H, D) attention fwd %d bwd %d, "
              "LayerNorm fwd %d bwd %d; the Trainer-driven step above %.3f "
              "ms (%s)" % (name, r["step_ms"], BERT_TRAIN_TIMED,
                           r["tokens_per_s"], r["peak_bytes"] / 2 ** 30,
                           r["state_bytes"], r["state_bytes_total"],
                           *r["launches"], btrain["step_ms"], card))
        print("dp bert: %s: step ms %s" % (
            name, [round(v, 3) for v in r["step_ms_all"]]))
        if "profile" in r:
            print_profiles([r["profile"]], card)
            print("dp bert: %s: NCCL device time %.3f ms a step (%s) (%s)"
                  % (name, r["nccl_ms"], ", ".join(r["nccl_kernels"])
                     or "no NCCL kernel in the trace", card))
    print("dp bert: the one-rank NCCL ZeRO steps and the steps without a "
          "mesh gave the same bits (losses and weights)")
    for r in dpb["graphs"]:
        print_graphed(r, card)
    torch.cuda.empty_cache()
    dpr = dp_resnet_phase(torch, mx, fused_norm, seed, card,
                          profile=profile)
    for name, what in (("dp", "DataParallelStep, no mesh, bench.py's SGD"),
                       ("trainer_nccl", "Trainer(kvstore='nccl'), one rank, "
                        "the training phase's SGD, cudnn.deterministic"),
                       ("trainer_plain", "Trainer with no store, the same "
                        "SGD, cudnn.deterministic")):
        r = dpr[name]
        print("dp resnet: %s: ResNet-50 v1 batch %d, %d steps, losses %s"
              % (what, TRAIN_BATCH, r["steps"],
                 [round(v, 4) for v in r["losses"]]))
        print("dp resnet: %s: step %.3f ms (median of %d) = %.1f images/s, "
              "peak device memory %.2f GiB, epilogue launches fwd %d bwd %d; "
              "the Trainer-driven step above %.3f ms (%s)"
              % (name, r["step_ms"], TIMED_STEPS, r["images_per_s"],
                 r["peak_bytes"] / 2 ** 30, r["fwd_launches"],
                 r["bwd_launches"], train["step_ms"], card))
        if "profile" in r:
            print_profiles([r["profile"]], card)
    print("dp resnet: Trainer(kvstore='nccl') and the Trainer with no store "
          "from the same weights: the same bits (first update rel L2 err "
          "%g, every loss, the last weights)"
          % dpr["trainer_nccl"]["first_update_rel_l2"])
    print("dp resnet: optimizer state %d bytes" % dpr["dp"]["state_bytes"])
    for r in dpr["graphs"]:
        print_graphed(r, card)
    return dpb, dpr


def _lm_net(mx, vocab, hidden, layers, seed, dtype="float32", ctx=None):
    """bench.py's LSTM LM: Xavier weights and deferred shapes on the host,
    ``cast`` for bf16, then ``reset_ctx`` onto ``ctx`` (the card)."""
    from mxnet_tpu_torch.gluon.model_zoo.lm import LSTMLM
    mx.random.seed(seed)
    net = LSTMLM(vocab, hidden, layers)
    with mx.cpu():
        net.initialize(mx.init.Xavier())
        net(mx.nd.zeros((1, 2)))
    if dtype != "float32":
        net.cast(dtype)
    net.collect_params().reset_ctx(ctx or mx.gpu(0))
    return net


def _lm_step(mx, net, batch):
    """bench.py's step: softmax cross entropy, SGD lr 1.0 with
    ``rescale_grad = 1 / batch``, no mesh."""
    from mxnet_tpu_torch import gluon
    return mx.parallel.DataParallelStep(
        net, gluon.loss.SoftmaxCrossEntropyLoss(),
        mx.optimizer.SGD(learning_rate=1.0, rescale_grad=1.0 / batch),
        mesh=None)


def lstm_lm_card_vs_cpu(torch, mx, seed):
    """One f32 DataParallelStep of a narrow LSTM LM (LM_PARITY) from the
    same weights on the card and on the CPU, and the CPU again on one
    thread: the loss rel error and the update errors of the card and of
    the floor."""
    import numpy as onp
    from mxnet_tpu_torch.gluon.utils import load_jax_params
    c = LM_PARITY
    rs = onp.random.RandomState(seed + 7)
    x = rs.randint(0, c["vocab"], (c["batch"], c["bptt"])).astype("float32")
    y = rs.randint(0, c["vocab"], (c["batch"], c["bptt"])).astype("float32")

    def step(net, ctx):
        loss = _lm_step(mx, net, c["batch"])(mx.nd.array(x, ctx=ctx),
                                             mx.nd.array(y, ctx=ctx))
        return float(loss.asnumpy()), _param_arrays(net)
    gnet = _lm_net(mx, c["vocab"], c["hidden"], c["layers"], seed)
    w0 = _param_arrays(gnet)
    gpu_loss, w1_gpu = step(gnet, mx.gpu(0))
    with mx.cpu():
        cnet = _lm_net(mx, c["vocab"], c["hidden"], c["layers"], seed,
                       ctx=mx.cpu())

        def cpu_step():
            load_jax_params(cnet, w0)
            return step(cnet, mx.cpu())
        cpu_loss, w1_cpu = cpu_step()
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        _, w1_cpu1 = cpu_step()
        torch.set_num_threads(threads)
    return (abs(gpu_loss - cpu_loss) / abs(cpu_loss),
            _update_errors(w0, w1_gpu, w1_cpu),
            _update_errors(w0, w1_cpu1, w1_cpu))


def cudnn_compaction(torch, net, flush):
    """One compaction of the LSTM's weights into cuDNN's buffer
    (``torch._cudnn_rnn_flatten_weight``: what cuDNN's RNN does on every
    call when, as here, the weights are not views of its buffer): device
    ms (L2 flushed, the host held off by a spin kernel), host µs a call,
    and the bytes it copies."""
    lstm = net.lstm
    ws = []
    for p in lstm._cell_prefixes():
        ws += [getattr(lstm, p + k).data().astorch().detach()
               for k in ("i2h_weight", "h2h_weight", "i2h_bias",
                         "h2h_bias")]
    from torch.backends.cudnn import rnn as cudnn_rnn
    mode = cudnn_rnn.get_cudnn_mode("LSTM")

    def flatten():
        return torch._cudnn_rnn_flatten_weight(
            ws, 4, LM_HIDDEN, mode, LM_HIDDEN, 0, LM_LAYERS, False, False)
    return (time_cuda(torch, flatten, flush), host_us(torch, flatten),
            sum(w.numel() * w.element_size() for w in ws))


def _rnn_kernels(prof, backend):
    """The device kernels of a profile whose names say RNN, LSTM or GRU,
    checked against ``backend``: cuDNN's (their names carry cuDNN's types)
    or torch's native cells' (``lstm_cell_forward`` and the like), and
    none of the other."""
    found = [(n, ms, k) for n, ms, k in prof["kernels"]
             if any(w in n.lower() for w in ("rnn", "lstm", "gru"))]
    cudnn = [n for n, _, _ in found if "cudnn" in n.lower()]
    native = [n for n, _, _ in found if "_cell_" in n.lower()]
    check(found, "%s: no RNN kernel in the profile" % prof["label"])
    check(bool(cudnn) == (backend == "cudnn")
          and bool(native) == (backend == "native"),
          "%s: backend %s, but the RNN kernels that ran are %s"
          % (prof["label"], backend, [n[:80] for n, _, _ in found]))
    return found


def _synthetic_corpus(path, n_tokens=30000, vocab=200, seed=0):
    """The word-LM example's synthetic corpus
    (``example/rnn/word_lm/train.py:_synthetic_corpus``): a Zipf-ish
    random walk over ``vocab`` words with sentence ends, so that a model
    can learn it."""
    import numpy as onp
    rs = onp.random.RandomState(seed)
    words = ["w%d" % i for i in range(vocab)]
    toks, state = [], 0
    for _ in range(n_tokens):
        state = (state * 31 + rs.randint(0, 7)) % vocab
        toks.append(words[state])
        if rs.rand() < 0.05:
            toks.append(".")
    with open(path, "w") as f:
        f.write(" ".join(toks))


def word_lm_phase(torch, mx, seed):
    """The word-LM example's model trained through DataParallelStep on the
    card for WORD_LM_STEPS steps of its synthetic corpus; the losses."""
    import tempfile
    import numpy as onp
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.contrib.data.text import LanguageModelDataset
    from mxnet_tpu_torch.gluon.model_zoo.lm import RNNModel, SeqCELoss
    c = WORD_LM
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "corpus.txt")
        _synthetic_corpus(path, seed=seed)
        data = LanguageModelDataset(path, seq_len=c["bptt"])
    vocab = len(data.vocabulary)
    mx.random.seed(seed)
    net = RNNModel(vocab, c["embed"], c["hidden"], c["layers"],
                   dropout=c["dropout"], tied=True)
    with mx.cpu():
        net.initialize(mx.init.Xavier())
        net(mx.nd.zeros((c["batch"], c["bptt"])))
    net.collect_params().reset_ctx(mx.gpu(0))
    step = mx.parallel.DataParallelStep(
        net, SeqCELoss(vocab), mx.optimizer.SGD(
            learning_rate=c["lr"], clip_gradient=c["clip"]), mesh=None)
    losses = []
    while len(losses) < WORD_LM_STEPS:
        with mx.cpu():
            loader = gluon.data.DataLoader(data, batch_size=c["batch"],
                                           shuffle=True,
                                           last_batch="discard")
            batches = list(loader)
        for d, l in batches[:WORD_LM_STEPS - len(losses)]:
            losses.append(step(d.as_in_context(mx.gpu(0)),
                               l.as_in_context(mx.gpu(0))).astorch())
    losses = [float(v) for v in losses]
    check(all(onp.isfinite(losses)), "word LM: non-finite loss %r" % losses)
    first, last = (statistics.mean(losses[:WORD_LM_WINDOW]),
                   statistics.mean(losses[-WORD_LM_WINDOW:]))
    check(last < first, "word LM: the loss did not fall: %r" % losses)
    drop = dropout_replays(torch, mx, net, step, d.as_in_context(mx.gpu(0)),
                           l.as_in_context(mx.gpu(0)), seed)
    return {"losses": losses, "vocab": vocab, "samples": len(data),
            "first_mean": first, "last_mean": last, "dropout": drop}


def lstm_lm_phase(torch, mx, seed, card, profile=False):
    """Config 4's LSTM LM through DataParallelStep on the card, float32 and
    bfloat16, after the narrow card-vs-CPU step; then the word-LM model.
    Returns the numbers."""
    import numpy as onp
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.ops import rnn as rnn_ops
    t0 = time.perf_counter()
    loss_rel, (update_rel, per_param), (floor_rel, _) = \
        lstm_lm_card_vs_cpu(torch, mx, seed)
    parity = {"loss_rel": loss_rel, "update_rel_l2": update_rel,
              "worst": per_param[:3], "floor_rel_l2": floor_rel,
              "seconds": time.perf_counter() - t0}
    check(loss_rel <= LM_PARITY_LOSS_RTOL,
          "LSTM LM card vs CPU loss rel err %.3g > %g"
          % (loss_rel, LM_PARITY_LOSS_RTOL))
    check(update_rel <= LM_PARITY_UPDATE_REL_L2,
          "LSTM LM card vs CPU update rel L2 err %.3g > %g"
          % (update_rel, LM_PARITY_UPDATE_REL_L2))
    check(per_param[0][0] <= LM_PARITY_PARAM_REL_L2,
          "LSTM LM card vs CPU update of %s: rel L2 err %.3g > %g"
          % (per_param[0][1], per_param[0][0], LM_PARITY_PARAM_REL_L2))

    rs = onp.random.RandomState(seed)
    gpu = mx.gpu(0)
    x = mx.nd.array(rs.randint(0, LM_VOCAB, (LM_BATCH, LM_BPTT))
                    .astype("float32"), ctx=gpu)
    y = mx.nd.array(rs.randint(0, LM_VOCAB, (LM_BATCH, LM_BPTT))
                    .astype("float32"), ctx=gpu)
    ce = gluon.loss.SoftmaxCrossEntropyLoss()

    def f32_ce(net):
        with mx.autograd.predict_mode():
            logits = net(x).astype("float32")
            return float(ce(logits, y).mean().asnumpy())
    out = {"parity": parity}
    for dtype in ("float32", "bfloat16"):
        net = _lm_net(mx, LM_VOCAB, LM_HIDDEN, LM_LAYERS, seed, dtype)
        # the LSTM's input is the embedding's output: its dtype and device
        backend = rnn_ops.backend(net.embed.weight.data().astorch())
        r = {"backend": backend, "ce_before": f32_ce(net)}
        if backend == "cudnn":
            flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
            r["compaction_ms"], r["compaction_host_us"], \
                r["compaction_bytes"] = cudnn_compaction(torch, net, flush)
            del flush
        step = _lm_step(mx, net, LM_BATCH)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for _ in range(LM_WARMUP + LM_TIMED):
            t = time.perf_counter()
            losses.append(step(x, y).astorch())
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        r["peak_bytes"] = torch.cuda.max_memory_allocated()
        r["losses"] = [float(v.float()) for v in losses]
        r["ce_after"] = f32_ce(net)
        check(all(onp.isfinite(r["losses"])),
              "LSTM LM %s: non-finite loss %r" % (dtype, r["losses"]))
        check(r["ce_after"] < r["ce_before"],
              "LSTM LM %s: the float32 cross entropy of the logits did not "
              "fall: %.7g -> %.7g" % (dtype, r["ce_before"], r["ce_after"]))
        if dtype == "float32":
            check(r["losses"][-1] < r["losses"][0],
                  "LSTM LM float32: the loss did not fall: %r" % r["losses"])
        r["step_ms"] = statistics.median(times[LM_WARMUP:]) * 1e3
        r["step_ms_all"] = [t * 1e3 for t in times]
        r["tokens_per_s"] = LM_BATCH * LM_BPTT * 1e3 / r["step_ms"]
        r["samples_per_s"] = LM_BATCH * 1e3 / r["step_ms"]
        if profile:
            r["profile"] = profile_calls(
                torch, lambda: step(x, y).astype("float32").asnumpy(),
                "LSTM LM %s DataParallelStep" % dtype, calls=3)
            r["rnn_kernels"] = _rnn_kernels(r["profile"], backend)
        del step
        torch.cuda.empty_cache()
        r["graphs"] = graphed_vs_eager(
            torch, mx, net, lambda: mx.parallel.DataParallelStep(
                net, gluon.loss.SoftmaxCrossEntropyLoss(),
                _scheduled(mx, mx.optimizer.SGD, 1.0,
                           rescale_grad=1.0 / LM_BATCH), mesh=None),
            x, y, seed, "LSTM LM config 4 %s DataParallelStep, SGD" % dtype)
        out[dtype] = r
        del net
        torch.cuda.empty_cache()
    out["word_lm"] = word_lm_phase(torch, mx, seed)
    return out


# Captured execution (CUDA graphs).  Each DataParallelStep path runs
# GRAPH_STEPS calls through its graph (the first warms up and captures, the
# rest replay) under a FactorScheduler that changes the rate every step,
# and the same calls from the same weights, seed and fresh optimizer
# through the same body run eagerly (``DataParallelStep._run_eagerly``):
# the same bits, losses and every weight and state the nets carry (the
# graph replays the kernels the eager body launches, on the same
# addresses' values).  Then GRAPH_TIMED calls each way, timed.
GRAPH_STEPS = 4
GRAPH_TIMED = 10
GRAPH_LR_FACTOR = 0.9
# the hybridized ResNet-50 forward, as bench.py:bench_inference builds it
HYBRID_BATCH = 32
HYBRID_CALLS = 13
# names in a replay's profile that show the hand kernels ran inside it
PROFILE_KERNELS = {
    "bert": ("flash_fwd_hopper", "flash_bwd_", "ln_bwd"),
    "bert_f32": ("flash_fwd_tf32", "flash_bwd_q_tf32", "flash_bwd_kv_tf32",
                 "ln_bwd"),
    "bert_f32_forward": ("flash_fwd_tf32", "ln_fwd"),
    "resnet_step": ("epi_fwd_kernel", "epi_bwd_"),
    "resnet_forward": ("epi_fwd_kernel",),
    "zoo_step": ()}


def _scheduled(mx, opt_cls, lr, **kw):
    """``opt_cls`` with a rate that changes every step."""
    return opt_cls(learning_rate=lr, lr_scheduler=mx.lr_scheduler
                   .FactorScheduler(step=1, factor=GRAPH_LR_FACTOR,
                                    base_lr=lr), **kw)


def _kernel_names_check(prof, what):
    names = [n for n, _, _ in prof["kernels"]]
    missing = [k for k in PROFILE_KERNELS[what]
               if not any(k in n for n in names)]
    check(not missing, "%s: no %s kernel in a replay's profile"
          % (prof["label"], missing))
    return [n[:60] for n in names if any(k in n for k in
                                         PROFILE_KERNELS[what])]


def graphed_vs_eager(torch, mx, net, make_step, data, label, seed, what,
                     counts=None, per_step=None, profile_as=None,
                     deterministic=False, after=None, timed=GRAPH_TIMED,
                     exact=True):
    """``make_step()`` (a fresh DataParallelStep) through its CUDA graph
    and through the same body eagerly, from the same weights and seed:
    GRAPH_STEPS calls each held to the same bits (only reported where
    ``exact`` is False: a dropout's masks come from another draw of the
    generator in a replay than in the eager call), then ``timed`` calls
    each timed.  ``counts()`` reads the path's launch counters (reset to 0
    by ``counts(reset=True)``), ``per_step`` is what each step must add.
    ``deterministic`` runs both under ``cudnn.deterministic`` (cuDNN's
    default backward-filter algorithms accumulate in an order that varies
    from run to run, eager or not).  ``after(step)``, where given, is
    called with each run's step after its calls.  The net's weights are
    left as they were."""
    params = sorted(net.collect_params().items())
    w0 = [p.data().astorch().detach().clone() for _, p in params]
    was_deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic or was_deterministic

    def run(eager):
        for (_, p), w in zip(params, w0):
            p.set_data(w)
        mx.random.seed(seed)
        step = make_step()
        call = step._run_eagerly if eager else step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if counts is not None:
            counts(reset=True)
        t = time.perf_counter()
        losses = [call(data, label).astorch() for _ in range(GRAPH_STEPS)]
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t
        rates = [step._opt.learning_rate]
        weights = [p.data().astorch().detach().clone() for _, p in params]
        times, later = [], []
        for _ in range(timed):
            t = time.perf_counter()
            later.append(call(data, label).astorch())
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        n = GRAPH_STEPS + timed
        r = {"losses": losses, "weights": weights,
             "losses_all": [float(v.float()) for v in losses + later],
             "step_ms": statistics.median(times) * 1e3,
             "peak_bytes": torch.cuda.max_memory_allocated(),
             "first_calls_s": first_s, "rate_last": rates[-1],
             "graphed": [e.graphed for e, _ in step._cache.values()],
             "capture_s": [e.capture_s for e, _ in step._cache.values()]}
        if counts is not None:
            got = counts()
            check(got == tuple(c * n for c in per_step),
                  "%s (%s): launches %r in %d steps, want %r a step"
                  % (what, "eager" if eager else "graphed", got, n,
                     per_step))
            r["launches"] = got
        if profile_as and not eager:
            def one():
                return step(data, label).astype("float32").asscalar()
            r["profile"] = profile_calls(torch, one, "%s, graphed" % what,
                                         calls=3)
            r["profile_kernels"] = _kernel_names_check(r["profile"],
                                                       profile_as)
        if after is not None:
            after(step)
        del step
        return r

    g = run(False)
    torch.cuda.empty_cache()
    e = run(True)
    torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = was_deterministic
    for (_, p), w in zip(params, w0):
        p.set_data(w)
    check(g["graphed"] == [True] and e["graphed"] == [False],
          "%s: graphs captured %r (graphed run), %r (eager run)"
          % (what, g["graphed"], e["graphed"]))
    same = all(torch.equal(a, b) for a, b in zip(g["losses"], e["losses"])) \
        and all(torch.equal(a, b) for a, b in zip(g["weights"], e["weights"]))
    worst = max(float((a.float() - b.float()).norm() / b.float().norm())
                for a, b in zip(g["weights"], e["weights"]))
    check(same or not exact, "%s: %d steps through the graph and through "
          "the same body eagerly differ (worst weight rel L2 %.3g; losses %r "
          "vs %r)" % (what, GRAPH_STEPS, worst,
                      [float(v.float()) for v in g["losses"]],
                      [float(v.float()) for v in e["losses"]]))
    losses = [float(v.float()) for v in g["losses"]]
    check(all(onp_isfinite(v) for v in losses), "%s: non-finite loss %r"
          % (what, losses))
    out = {"what": what, "losses": losses, "same_bits": same,
           "graphed_ms": g["step_ms"], "eager_ms": e["step_ms"],
           "capture_s": g["capture_s"][0],
           "graphed_peak_bytes": g["peak_bytes"],
           "eager_peak_bytes": e["peak_bytes"], "rate_last": g["rate_last"],
           "launches": g.get("launches"), "deterministic": deterministic,
           "losses_all": g["losses_all"],
           "eager_losses_all": e["losses_all"], "worst_rel_l2": worst}
    if "profile" in g:
        out["profile"] = g["profile"]
        out["profile_kernels"] = g["profile_kernels"]
    return out


def onp_isfinite(v):
    return v == v and abs(v) != float("inf")


def print_graphed(r, card):
    print("graphs: %s: %d steps through the CUDA graph (1 warm-up and "
          "capture, %d replays) and through the same body eagerly, rate x%g "
          "a step (last %.4g)%s: same bits %s, losses %s; step %.3f ms "
          "graphed, %.3f ms eager (median of %d each); capture %s s; peak "
          "device memory %.2f GiB graphed (graph pool included), %.2f GiB "
          "eager; launches %s (%s)"
          % (r["what"], GRAPH_STEPS, GRAPH_STEPS - 1, GRAPH_LR_FACTOR,
             r["rate_last"], ", cudnn.deterministic" if r["deterministic"]
             else "", r["same_bits"],
             [round(v, 5) for v in r["losses"]], r["graphed_ms"],
             r["eager_ms"], GRAPH_TIMED, r["capture_s"] and
             round(r["capture_s"], 3),
             r["graphed_peak_bytes"] / 2 ** 30,
             r["eager_peak_bytes"] / 2 ** 30, r["launches"], card))
    if "profile" in r:
        print_profiles([r["profile"]], card)
        print("graphs: %s: the hand kernels in one replay's trace: %s"
              % (r["what"], sorted(set(r["profile_kernels"]))))


def hybridized_calls(torch, mx, net, call, n, counts, what, profile=False):
    """The forward ``call()`` (a tensor out) ``n`` times eagerly, then
    ``n`` times after ``net.hybridize()`` through ``_CachedGraph`` (the
    first warms up and captures), in predict mode, ``counts(reset=True)``
    just before the graphed calls and ``counts()`` read just after.
    Checks one capture reported for one key, every output the bits of the
    first eager one, two replays never the same tensor; returns the ms
    each way (median after 3 calls), the capture's seconds, peak memory,
    the launches, the last output and, under ``profile``, a profile of 3
    graphed calls (each synchronised, the output left on the card)."""
    from mxnet_tpu_torch import telemetry

    def timed():
        times, outs = [], []
        for _ in range(n):
            t = time.perf_counter()
            outs.append(call())
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return outs, times
    with mx.autograd.predict_mode():
        eager_outs, eager_t = timed()
        net.hybridize()
        compiles0 = telemetry.compile_counts().get("CachedOp_" + net.name, 0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts(reset=True)
        graph_outs, graph_t = timed()
        launches = counts()
        peak = torch.cuda.max_memory_allocated()
        compiles = telemetry.compile_counts()["CachedOp_" + net.name] \
            - compiles0
        entries = list(net._cached_graph._cache.values())
        prof = profile_calls(torch, lambda: (call(), torch.cuda.synchronize()),
                             "%s, graphed" % what, calls=3) \
            if profile else None
    check(len(entries) == 1 and entries[0][0][0].graphed,
          "%s was not captured: %r" % (what, entries))
    check(compiles == 1, "%s: %d captures reported for one key"
          % (what, compiles))
    check(all(torch.equal(o, eager_outs[0]) for o in eager_outs + graph_outs),
          "%s: the graphed outputs differ from the eager forward's" % what)
    check(graph_outs[1].data_ptr() != graph_outs[2].data_ptr(),
          "%s: two replays returned the same tensor" % what)
    out = {"graphed_ms": statistics.median(graph_t[3:]) * 1e3,
           "eager_ms": statistics.median(eager_t[3:]) * 1e3,
           "capture_s": entries[0][0][0].capture_s, "peak_bytes": peak,
           "launches": launches, "calls": n, "last": graph_outs[-1]}
    if prof is not None:
        out["profile"] = prof
    return out


def _hand_kernel_launches(attention, layernorm, fused_norm):
    """Every hand kernel's (forward, backward) launches since the counts
    were last set to 0."""
    return {"fused_norm": (fused_norm.LAUNCHES, fused_norm.BWD_LAUNCHES),
            "attention": (attention.LAUNCHES, attention.BWD_LAUNCHES),
            "attention_bshd": (attention.BSHD_LAUNCHES,
                               attention.BSHD_BWD_LAUNCHES),
            "layernorm": (layernorm.LAUNCHES, layernorm.BWD_LAUNCHES)}


def _counter_of(name):
    """The ``_hand_kernel_launches`` key and the (forward, backward) index
    that count the kernel of the kernels line's entry ``name``."""
    kernel = ("fused_norm" if name.startswith("fused_bn")
              else "layernorm" if name.startswith("layer_norm")
              else "attention_bshd" if name.startswith("flash_attention_bshd")
              else "attention")
    return kernel, int("_bwd" in name)


def _epilogue_counts(fused_norm):
    def counts(reset=False):
        if reset:
            fused_norm.LAUNCHES = fused_norm.BWD_LAUNCHES = 0
        return (fused_norm.LAUNCHES, fused_norm.BWD_LAUNCHES)
    return counts


def hybrid_forward_phase(torch, mx, fused_norm, seed, card, profile=False):
    """ResNet-50 v1 as bench.py:bench_inference builds it (Xavier weights
    and deferred shapes on the host, ``reset_ctx`` onto the card,
    ``hybridize()``), its eval-mode forward at batch 32: HYBRID_CALLS
    calls through ``_CachedGraph`` (``hybridized_calls``) with 16
    epilogue launches a call; eager beside graphed, timed."""
    import numpy as onp
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    gpu = mx.gpu(0)
    mx.random.seed(seed)
    net = resnet50_v1()
    with mx.cpu():
        net.initialize(mx.init.Xavier())
        with mx.autograd.predict_mode():
            net(mx.nd.zeros((1, 3, IMAGE_SIZE, IMAGE_SIZE)))
    net.collect_params().reset_ctx(gpu)
    rs = onp.random.RandomState(seed)
    x = mx.nd.array(rs.uniform(size=(HYBRID_BATCH, 3, IMAGE_SIZE,
                                     IMAGE_SIZE)).astype("float32"), ctx=gpu)
    out = hybridized_calls(torch, mx, net, lambda: net(x).astorch(),
                           HYBRID_CALLS, _epilogue_counts(fused_norm),
                           "hybridized ResNet-50 forward", profile=profile)
    out["launches"] = out["launches"][0]
    check(out["launches"] == 16 * HYBRID_CALLS,
          "%d epilogue launches in %d hybridized forwards (want 16 each)"
          % (out["launches"], HYBRID_CALLS))
    if "profile" in out:
        out["profile_kernels"] = _kernel_names_check(out["profile"],
                                                     "resnet_forward")
    del net, out["last"]
    torch.cuda.empty_cache()
    return out


def dropout_replays(torch, mx, net, step, data, label, seed):
    """Dropout inside a captured step: from the same weights, two replays
    draw different masks (different losses), and after the same
    ``mx.random.seed`` a replay draws the first masks again (the same
    bits)."""
    params = sorted(net.collect_params().items())
    w0 = [p.data().astorch().detach().clone() for _, p in params]

    def once(reseed):
        for (_, p), w in zip(params, w0):
            p.set_data(w)
        if reseed:
            mx.random.seed(seed)
        loss = step(data, label).astorch()
        return loss, [p.data().astorch().detach().clone() for _, p in params]
    first, w_first = once(True)
    second, _ = once(False)
    again, w_again = once(True)
    check(all(e.graphed for e, _ in step._cache.values()),
          "the word-LM step is not a graph")
    check(not torch.equal(first, second),
          "two replays drew the same dropout masks (loss %r)"
          % float(first))
    check(torch.equal(first, again)
          and all(torch.equal(a, b) for a, b in zip(w_first, w_again)),
          "the same mx.random.seed did not give the same masks again")
    return {"losses": [float(first), float(second), float(again)]}


def print_lstm_lm(lm, card):
    p = lm["parity"]
    print("lstm lm: card vs CPU, one f32 DataParallelStep of a %d-layer LSTM "
          "LM (vocab %d, hidden %d, batch %d x %d; cuDNN on the card, "
          "torch's native cells on the CPU, TF32 off): loss rel err %.3g, "
          "update rel L2 err %.3g over all parameters (floor, CPU on 1 "
          "thread vs N: %.3g); worst parameters %s (%.1f s)"
          % (LM_PARITY["layers"], LM_PARITY["vocab"], LM_PARITY["hidden"],
             LM_PARITY["batch"], LM_PARITY["bptt"], p["loss_rel"],
             p["update_rel_l2"], p["floor_rel_l2"],
             ", ".join("%s %.3g" % (k, e) for e, k in p["worst"]),
             p["seconds"]))
    for dtype in ("float32", "bfloat16"):
        r = lm[dtype]
        print("lstm lm: config 4 %s (Embedding(%d, %d), %d-layer NTC LSTM, "
              "Dense(%d), SGD lr 1.0 rescale 1/%d) through "
              "DataParallelStep at %d x %d, RNN backend %s: step %.3f ms "
              "(median of %d after %d warm-up) = %.1f tokens/s = %.2f "
              "samples/s, peak device memory %.2f GiB (%s)"
              % (dtype, LM_VOCAB, LM_HIDDEN, LM_LAYERS, LM_VOCAB, LM_BATCH,
                 LM_BATCH, LM_BPTT, r["backend"], r["step_ms"], LM_TIMED,
                 LM_WARMUP, r["tokens_per_s"], r["samples_per_s"],
                 r["peak_bytes"] / 2 ** 30, card))
        print("lstm lm: %s: loss first %.6g last %.6g; float32 cross "
              "entropy of the logits before %.7g after %.7g; step ms %s"
              % (dtype, r["losses"][0], r["losses"][-1], r["ce_before"],
                 r["ce_after"], [round(v, 3) for v in r["step_ms_all"]]))
        if "compaction_ms" in r:
            print("lstm lm: %s: cuDNN weight compaction (the layer's %d "
                  "tensors copied into cuDNN's buffer, %.1f MB, on every "
                  "call): device %.4f ms, host %.1f us a call (%s)"
                  % (dtype, 4 * LM_LAYERS, r["compaction_bytes"] / 1e6,
                     r["compaction_ms"], r["compaction_host_us"], card))
        if "profile" in r:
            print_profiles([r["profile"]], card)
            print("lstm lm: %s: RNN kernels that ran (expected backend %s): "
                  "%s" % (dtype, r["backend"], "; ".join(
                      "%s %.3f ms/call x%d" % k for k in r["rnn_kernels"])))
        print_graphed(r["graphs"], card)
    w = lm["word_lm"]
    print("lstm lm: word-LM example model (tied, dropout %g, SGD lr %g, "
          "clip %g, embed = hidden %d, %d layers, batch %d x %d, vocab %d, "
          "%d samples): %d steps, mean loss of the first %d %.4f, of the "
          "last %d %.4f; losses %s"
          % (WORD_LM["dropout"], WORD_LM["lr"], WORD_LM["clip"],
             WORD_LM["hidden"], WORD_LM["layers"], WORD_LM["batch"],
             WORD_LM["bptt"], w["vocab"], w["samples"], len(w["losses"]),
             WORD_LM_WINDOW, w["first_mean"], WORD_LM_WINDOW, w["last_mean"],
             [round(v, 3) for v in w["losses"]]))
    print("graphs: word-LM model, dropout %g, through its captured step: "
          "from the same weights, losses after mx.random.seed, one replay "
          "later and after the same seed again %s: masks advance across "
          "replays and restart with the seed" % (WORD_LM["dropout"],
                                                 w["dropout"]["losses"]))


# --- the array surface (ops/elemwise.py, ops/matrix.py, ops/random_ops.py,
# nd.random, nd.linalg) ------------------------------------------------------
# Phase (a), the sweep: every op those three modules register runs once on
# the card through mx.nd and once with ctx=mx.cpu() on the same inputs.
# Integer, index, shape, comparison, sort and top-k results must be the
# same bits; float results within ARRAY_F32_RTOL (relative, ARRAY_F32_ATOL
# absolute near 0: CUDA's exp/log/erf and the CPU's differ by an ulp or
# two), ARRAY_LINALG_RTOL for the products and the solvers (TF32 off; sums
# in another order, LAPACK against cuSOLVER), and one ulp of their type
# for bfloat16 and float16 (2**-7 and 2**-10 relative) plus ARRAY_F32_ATOL
# (near 0 the CPU's vectorised erf, an approximation within about 1.5e-7,
# and CUDA's differ by more than a 16-bit ulp of the value).  A sampler's
# draws differ by device: its shape, dtype and device are checked, and its
# values lie in the distribution's support.
ARRAY_F32_RTOL, ARRAY_F32_ATOL = 1e-5, 1e-6
ARRAY_LINALG_RTOL = 1e-4
ARRAY_ULP = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}
ARRAY_MODULES = ("mxnet_tpu_torch.ops.elemwise", "mxnet_tpu_torch.ops.matrix",
                 "mxnet_tpu_torch.ops.random_ops", "torch")
ARRAY_EXACT = ("topk", "sort", "argsort", "one_hot", "take", "pick",
               "gather_nd", "gather_positions", "_contrib_gather_positions",
               "shape_array", "size_array", "Reshape", "reshape", "slice",
               "slice_axis", "slice_like", "transpose", "swapaxes",
               "SwapAxis", "expand_dims", "squeeze", "repeat", "tile",
               "reverse", "flip", "Pad", "pad", "diag", "tril",
               "depth_to_space", "space_to_depth", "concat", "Concat",
               "stack", "histogram", "_unravel_index", "unravel_index",
               "linalg_extractdiag", "linalg_makediag", "zeros_like",
               "ones_like", "Cast", "cast", "amp_cast")
ARRAY_LINALG = ("dot", "batch_dot", "linalg_gemm", "linalg_gemm2",
                "linalg_potrf", "linalg_potri", "linalg_trmm", "linalg_trsm",
                "linalg_sumlogdiag", "linalg_syrk", "linalg_gelqf",
                "linalg_inverse", "linalg_det", "linalg_slogdet")


def array_sweep_inputs(seed):
    """The sweep's numpy inputs, from ``RandomState(seed)``."""
    import numpy as onp
    rs = onp.random.RandomState(seed + 21)
    sgn = onp.where(rs.uniform(size=(3, 4, 5)) < 0.5, -1.0, 1.0)
    x = (sgn * rs.uniform(0.2, 2.0, (3, 4, 5))).astype("float32")
    y = rs.uniform(-2, 2, (3, 4, 5)).astype("float32")
    spd = rs.uniform(-1, 1, (2, 4, 4))
    spd = (spd @ spd.transpose(0, 2, 1) + 4 * onp.eye(4)).astype("float32")
    ties = onp.array([[1, 3, 3, 0, 3, 1, 2, 2, 0, 1],
                      [5, 5, 5, 5, 4, 4, 6, 6, 0, 5]], "float32")
    f = lambda *s: rs.uniform(-1, 1, s).astype("float32")
    return {
        "x": x, "y": y, "yb": f(1, 4, 1),
        "eq": onp.where(rs.uniform(size=x.shape) < 0.3, x, y)
        .astype("float32"),
        "zeros": onp.where(rs.uniform(size=x.shape) < 0.3, 0, x)
        .astype("float32"),
        "cond": (rs.uniform(size=x.shape) < 0.5).astype("float32"),
        "pos": rs.uniform(0.1, 3.0, (3, 4, 5)).astype("float32"),
        "unit": rs.uniform(-0.9, 0.9, (3, 4, 5)).astype("float32"),
        "ge1": rs.uniform(1.1, 3.0, (3, 4, 5)).astype("float32"),
        "ynz": (sgn * rs.uniform(0.5, 2.0, (3, 4, 5))).astype("float32"),
        "exps": rs.randint(-3, 4, (3, 4, 5)).astype("float32"),
        "i": rs.randint(-5, 6, (3, 4, 5)).astype("int32"),
        "ipos": rs.randint(1, 4, (3, 4, 5)).astype("int32"),
        "m45": f(4, 5), "m53": f(5, 3), "m35": f(3, 5), "t234": f(2, 3, 4),
        "t245": f(2, 4, 5), "m43": f(2, 4, 3), "m34": f(2, 3, 4),
        "m44": f(2, 4, 4), "spd": spd,
        "low": onp.tril(rs.uniform(0.5, 1.5, (2, 4, 4))).astype("float32"),
        "img": f(2, 3, 4, 5), "sq1": f(3, 1, 5, 1),
        "d2s": onp.arange(48, dtype="float32").reshape(1, 8, 2, 3),
        "s2d": onp.arange(48, dtype="float32").reshape(1, 2, 4, 6),
        "idx": onp.array([[0, 2.7], [4, 9], [-1, -6]], "float32"),
        "pick_idx": onp.array([0, 4, 7], "float32"),
        "gnd": onp.array([[0, 2, 1, -1, 2], [3, 0, 1, 2, 1]], "float32"),
        "snd_data": f(5), "gpos_data": f(2, 6, 3),
        "gpos": onp.array([[0, 5, 9], [2, -1, 3]], "float32"),
        "ties": ties, "shape_like": onp.zeros((2, 3, 4), "float32"),
        "hist": onp.concatenate([rs.uniform(-2, 2, 98), [2.0, -2.0]])
        .astype("float32"),
        "ravel": onp.array([[0, 1, 2], [3, 0, 4]], "float32"),
        "flat": onp.array([0, 7, 13, 19], "float32"),
        "probs": onp.array([[0.1, 0.6, 0.0, 0.3], [0.25] * 4], "float32"),
        "lo": onp.array([0.0, -2.0], "float32"),
        "hi": onp.array([1.0, 2.0], "float32"),
    }


def array_sweep_cases():
    """(op, input names (or (name, dtype)), attrs): at least one case for
    every op of ``ARRAY_MODULES``."""
    cases = []

    def add(op, arrays, **attrs):
        cases.append((op, tuple(arrays), attrs))
    for op in ("abs", "sign", "rint", "ceil", "floor", "trunc", "fix",
               "square", "cbrt", "rcbrt", "exp", "expm1", "sin", "cos",
               "arctan", "sinh", "cosh", "tanh", "arcsinh", "degrees",
               "radians", "reciprocal", "negative", "erf", "sigmoid", "relu",
               "softsign", "identity", "_copy", "stop_gradient_identity",
               "BlockGrad_inner", "BlockGrad", "stop_gradient",
               "hard_sigmoid", "logical_not"):
        add(op, ["x"])
    for op in ("sqrt", "rsqrt", "log", "log10", "log2", "log1p", "gamma",
               "gammaln"):
        add(op, ["pos"])
    for op in ("arcsin", "arccos", "arctanh", "erfinv", "tan"):
        add(op, ["unit"])
    add("arccosh", ["ge1"])
    for op in ("exp", "erf", "rsqrt", "tanh"):
        add(op, [("pos", "bfloat16")])
        add(op, [("pos", "float16")])
    for op in ("abs", "square", "sign", "rint"):
        add(op, [("i", "int32")])
    add("clip", ["x"], a_min=-0.5, a_max=1.0)
    add("make_loss", ["x"], grad_scale=0.3)
    add("smooth_l1", ["x"], scalar=1.5)
    for op in ("elemwise_add", "elemwise_sub", "elemwise_mul", "elemwise_div",
               "maximum", "minimum", "hypot", "arctan2"):
        add(op, ["x", "y"])
    for op in ("broadcast_add", "broadcast_sub", "broadcast_mul",
               "broadcast_div", "broadcast_maximum", "broadcast_minimum",
               "broadcast_hypot", "broadcast_plus", "broadcast_minus", "_add",
               "_plus", "_sub", "_minus", "_mul", "_div"):
        add(op, ["x", "yb"])
    for op in ("mod", "broadcast_mod", "_mod"):
        add(op, ["x", "ynz"])
        add(op, [("i", "int32"), ("ipos", "int32")])
    for op in ("power", "broadcast_power", "_power", "pow"):
        add(op, ["pos", "y"])
    add("ldexp", ["x", "exps"])
    for op in ("broadcast_equal", "broadcast_not_equal", "broadcast_greater",
               "broadcast_greater_equal", "broadcast_lesser",
               "broadcast_lesser_equal", "equal", "not_equal", "greater",
               "greater_equal", "lesser", "lesser_equal"):
        add(op, ["x", "eq"])
    for op in ("broadcast_logical_and", "broadcast_logical_or",
               "broadcast_logical_xor", "logical_and", "logical_or",
               "logical_xor"):
        add(op, ["zeros", "cond"])
    for op, src, s in (("_plus_scalar", "x", 1.5), ("_minus_scalar", "x", 1.5),
                       ("_rminus_scalar", "x", 1.5), ("_mul_scalar", "x", 1.5),
                       ("_div_scalar", "x", 1.5), ("_rdiv_scalar", "x", 1.5),
                       ("_mod_scalar", "x", -0.7), ("_rmod_scalar", "ynz", 2.5),
                       ("_power_scalar", "pos", 2.5),
                       ("_rpower_scalar", "x", 1.5),
                       ("_maximum_scalar", "x", 0.3),
                       ("_minimum_scalar", "x", 0.3),
                       ("_hypot_scalar", "x", 1.5),
                       ("_equal_scalar", "exps", 1.0),
                       ("_not_equal_scalar", "exps", 1.0),
                       ("_greater_scalar", "x", 0.3),
                       ("_greater_equal_scalar", "exps", 1.0),
                       ("_lesser_scalar", "x", 0.3),
                       ("_lesser_equal_scalar", "exps", 1.0)):
        add(op, [src], scalar=s)
    add("_mod_scalar", [("i", "int32")], scalar=3)
    add("where", ["cond", "x", "y"])
    add("dot", ["m45", "m53"])
    add("dot", ["m35", "m45"], transpose_b=True)
    add("dot", ["t234", "m45"])
    add("dot", [("m45", "bfloat16"), ("m53", "bfloat16")])
    add("batch_dot", ["t234", "t245"])
    add("transpose", ["x"], axes=(1, 0, 2))
    add("swapaxes", ["x"], dim1=0, dim2=2)
    add("SwapAxis", ["x"], dim1=1, dim2=2)
    add("expand_dims", ["x"], axis=1)
    add("squeeze", ["sq1"])
    add("Reshape", ["x"], shape=(0, -4, 2, -1, -2))
    add("reshape", ["x"], shape=(-3, 0))
    add("slice", ["x"], begin=(None, 3, 1), end=(None, 0, None),
        step=(1, -1, 2))
    add("slice_axis", ["x"], axis=2, begin=-2, end=None)
    add("slice_like", ["x", "shape_like"], axes=(0, 2))
    add("take", ["m45", "idx"])
    add("take", ["x", "idx"], axis=2, mode="wrap")
    add("pick", ["m35", "pick_idx"])
    add("one_hot", ["idx"], depth=5)
    add("gather_nd", ["x", "gnd"])
    add("gather_positions", ["gpos_data", "gpos"])
    add("_contrib_gather_positions", ["gpos_data", "gpos"])
    add("scatter_nd", ["snd_data", "gnd"], shape=(3, 4))
    add("repeat", ["t234"], repeats=2, axis=1)
    add("tile", ["t234"], reps=(2, 1, 3))
    add("reverse", ["x"], axis=(0, 2))
    add("flip", ["x"], axis=1)
    add("Pad", ["img"], mode="reflect", pad_width=(0, 0, 0, 0, 1, 2, 2, 1))
    add("pad", ["img"], mode="edge", pad_width=(0, 0, 0, 0, 3, 3, 4, 4))
    add("Pad", ["img"], mode="constant", pad_width=(0, 0, 1, 0, 0, 3, 1, 1),
        constant_value=1.5)
    add("Cast", ["x"], dtype="int32")
    add("cast", ["x"], dtype="bfloat16")
    add("amp_cast", ["x"], dtype="float16")
    add("shape_array", ["x"])
    add("size_array", ["img"])
    add("zeros_like", ["x"])
    add("ones_like", [("i", "int32")])
    add("diag", ["m45"], k=-1)
    add("tril", ["x"], k=1)
    add("concat", ["x", "y"], dim=2)
    add("Concat", ["x", "y"])
    add("stack", ["x", "y"], axis=1)
    for src in ("ties", ("ties", "bfloat16")):
        add("topk", [src], k=3, ret_typ="both")
        add("topk", [src], k=2, is_ascend=True)
        add("topk", [src], k=2, ret_typ="mask")
        add("sort", [src], is_ascend=False)
        add("argsort", [src])
        add("argsort", [src], is_ascend=False)
    add("depth_to_space", ["d2s"], block_size=2)
    add("space_to_depth", ["s2d"], block_size=2)
    add("histogram", ["hist"], bin_cnt=5)
    add("histogram", ["hist"], bin_cnt=7, range=(-1.0, 1.5))
    add("linalg_gemm", ["m43", "m43", "m44"], transpose_b=True, alpha=0.5,
        beta=-2.0)
    add("linalg_gemm2", ["m43", "m43"], transpose_a=True)
    add("linalg_potrf", ["spd"])
    add("linalg_potri", ["low"])
    add("linalg_trmm", ["low", "m34"], rightside=True, transpose=True)
    add("linalg_trsm", ["low", "m43"], transpose=True, alpha=1.5)
    add("linalg_trsm", ["low", "m34"], rightside=True)
    add("linalg_sumlogdiag", ["spd"])
    add("linalg_syrk", ["m43"], transpose=True, alpha=0.5)
    add("linalg_gelqf", ["m35"])
    add("linalg_extractdiag", ["m44"], offset=1)
    add("linalg_makediag", ["m34"], offset=-1)
    add("linalg_inverse", ["spd"])
    add("linalg_det", ["spd"])
    add("linalg_slogdet", ["m44"])
    add("_ravel_multi_index", ["ravel"], shape=(4, 5))
    add("ravel_multi_index", [("ravel", "int32")], shape=(4, 5))
    add("_unravel_index", ["flat"], shape=(4, 5))
    add("unravel_index", [("flat", "int32")], shape=(2, 2, 5))
    # the samplers: (lower, upper) bounds of the support ride along
    for op in ("_random_uniform", "random_uniform", "uniform"):
        add(op, [], low=-1.0, high=2.0, shape=(64,), support=(-1.0, 2.0))
    for op in ("_random_normal", "random_normal", "normal"):
        add(op, [], loc=1.0, scale=2.0, shape=(64,), support=None)
    for op in ("_random_gamma", "random_gamma"):
        add(op, [], alpha=2.0, beta=0.5, shape=(64,), support=(0.0, None))
    for op in ("_random_exponential", "random_exponential"):
        add(op, [], lam=2.0, shape=(64,), support=(0.0, None))
    for op in ("_random_poisson", "random_poisson", "_random_negative_binomial",
               "random_negative_binomial",
               "_random_generalized_negative_binomial",
               "random_generalized_negative_binomial"):
        add(op, [], shape=(64,), support=(0.0, None))
    for op in ("_random_randint", "random_randint", "randint"):
        add(op, [], low=-3, high=7, shape=(64,), support=(-3, 6))
    for op in ("_sample_multinomial", "sample_multinomial", "multinomial"):
        add(op, ["probs"], shape=(16,), support=(0, 3))
    for op in ("shuffle", "_shuffle"):
        add(op, ["x"], support=None)
    for op in ("_sample_uniform", "sample_uniform"):
        add(op, ["lo", "hi"], shape=(32,), support=(-2.0, 2.0))
    for op in ("_sample_normal", "sample_normal"):
        add(op, ["lo", "hi"], shape=(32,), support=None)
    for op in ("_sample_gamma", "sample_gamma"):
        add(op, ["hi", "hi"], shape=(32,), support=(0.0, None))
    return cases


def array_surface_ops(mx):
    """The registered names of ``ARRAY_MODULES``."""
    from mxnet_tpu_torch.ops.registry import get_op, list_ops
    return [n for n in list_ops()
            if getattr(get_op(n).fn, "__module__", "") in ARRAY_MODULES]


def _arrays_on(mx, inputs, names, ctx):
    out = []
    for a in names:
        name, dt = (a, None) if isinstance(a, str) else a
        out.append(mx.nd.array(inputs[name], ctx=ctx, dtype=dt))
    return out


def _as_list(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _host(torch, o):
    """A float64 numpy copy of an output (integers exact)."""
    import numpy as onp
    t = o.astorch().detach().cpu()
    if t.is_floating_point():
        return t.double().numpy()
    return t.numpy().astype(onp.int64)


def array_sweep(torch, mx, seed):
    """Phase (a): every op of the array surface on the card against the
    same call on the CPU.  Returns the number of cases and of ops."""
    import numpy as onp
    inputs = array_sweep_inputs(seed)
    cases = array_sweep_cases()
    names = array_surface_ops(mx)
    covered = {c[0] for c in cases}
    missing = [n for n in names if n not in covered]
    check(not missing, "array ops without a sweep case: %s" % missing)
    gpu, cpu = mx.gpu(0), mx.cpu()
    dev = gpu.torch_device
    bad = []

    def expect(cond, msg):
        if not cond:
            bad.append(msg)
        return cond
    for op, arrays, attrs in cases:
        attrs = dict(attrs)
        sampler = "support" in attrs
        support = attrs.pop("support", None)
        fn = getattr(mx.nd, op)
        what = "array op %s %s %s" % (op, arrays, attrs)
        if sampler and not arrays:
            g = _as_list(fn(ctx=gpu, **attrs))
            c = _as_list(fn(ctx=cpu, **attrs))
        else:
            g = _as_list(fn(*_arrays_on(mx, inputs, arrays, gpu), **attrs))
            with mx.cpu():
                c = _as_list(fn(*_arrays_on(mx, inputs, arrays, cpu),
                                **attrs))
        if not expect(len(g) == len(c), "%s: %d outputs on the card, %d on "
                      "the CPU" % (what, len(g), len(c))):
            continue
        for go, co in zip(g, c):
            gt, ct = go.astorch(), co.astorch()
            if not (expect(gt.device == dev and ct.device.type == "cpu",
                           "%s: output on %s" % (what, gt.device))
                    and expect(gt.dtype == ct.dtype and gt.shape == ct.shape,
                               "%s: card %s %s, CPU %s %s"
                               % (what, gt.dtype, tuple(gt.shape), ct.dtype,
                                  tuple(ct.shape)))):
                continue
            gv, cv = _host(torch, go), _host(torch, co)
            if sampler:
                expect(onp.isfinite(gv).all(), "%s: non-finite draw" % what)
                if support is not None:
                    lo, hi = support
                    expect((lo is None or gv.min() >= lo)
                           and (hi is None or gv.max() <= hi),
                           "%s: a draw outside %s" % (what, support))
                if op in ("shuffle", "_shuffle"):
                    expect(onp.array_equal(onp.sort(gv.reshape(-1)),
                                           onp.sort(cv.reshape(-1))),
                           "%s: not a permutation" % what)
                continue
            dt = str(gt.dtype).replace("torch.", "")
            if not gt.is_floating_point() or op in ARRAY_EXACT:
                expect(onp.array_equal(gv, cv, equal_nan=True),
                       "%s: card and CPU differ (exact)" % what)
            elif dt in ARRAY_ULP:
                big = onp.maximum(abs(gv), abs(cv))
                err = abs(gv - cv)
                expect((err <= ARRAY_ULP[dt] * big + ARRAY_F32_ATOL).all(),
                       "%s: %s max err %.3g beyond an ulp" % (what, dt,
                                                              err.max()))
            else:
                rtol = ARRAY_LINALG_RTOL if op in ARRAY_LINALG \
                    else ARRAY_F32_RTOL
                expect(onp.allclose(gv, cv, rtol=rtol, atol=ARRAY_F32_ATOL,
                                    equal_nan=True),
                       "%s: card and CPU differ beyond rtol %g: max %.3g"
                       % (what, rtol, abs(gv - cv).max()))
    check(not bad, "%d of %d array cases failed:\n  %s"
          % (len(bad), len(cases), "\n  ".join(bad)))
    return {"cases": len(cases), "ops": len(names), "covered":
            len([n for n in names if n in covered])}


# Phase (b): full width.  BERT-base's masked-LM evaluation on the bf16
# logits bert_phase produced (24 x 76 x 30522), the products, gathers and
# activations at BERT-base's shapes, and the samplers at sizes their users
# draw.  The samplers' mean and variance must lie within ARRAY_SE standard
# errors of the distribution's: the mean's standard error is
# sqrt(var / n), the variance's sqrt((mu4 - var**2) / n), mu4 the fourth
# central moment: uniform(a, b): mean (a+b)/2, var (b-a)²/12, mu4
# (b-a)⁴/80; normal(m, s): m, s², 3s⁴; gamma(a, b): ab, ab², 3a(a+2)b⁴;
# exponential(l): 1/l, 1/l², 9/l⁴; Poisson(l): l, l, l(1+3l); the failures
# before the k-th success at rate p (negative binomial, and the
# generalized one with k = 1/alpha, p = k/(k+mu)): k(1-p)/p, k(1-p)/p²,
# (3 + 6/k + p²/(k(1-p))) var²; randint(lo, hi), n = hi - lo values:
# (lo+hi-1)/2, (n²-1)/12, (n²-1)(3n²-7)/240; a category drawn from p_k:
# sum k p_k and the central moments of that sum, computed from p.
ARRAY_SE = 5.0
ARRAY_NORMAL_DRAWS = 25_557_032        # ResNet-50 v1's parameter count
ARRAY_DRAWS = 10 ** 7
ARRAY_SHUFFLE_ROWS = 50_000
ARRAY_DISPATCH_CALLS = 1000


def _moments_ok(torch, v, mean, var, mu4, what):
    v = v.double().reshape(-1)
    n = v.numel()
    m = v.mean().item()
    s2 = v.var(unbiased=False).item()
    se_m = (var / n) ** 0.5
    se_v = ((mu4 - var * var) / n) ** 0.5
    check(abs(m - mean) <= ARRAY_SE * se_m and abs(s2 - var)
          <= ARRAY_SE * se_v,
          "%s: mean %.6g (want %.6g +- %.3g), var %.6g (want %.6g +- %.3g)"
          % (what, m, mean, ARRAY_SE * se_m, s2, var, ARRAY_SE * se_v))
    return {"n": n, "mean": m, "var": s2, "mean_z": (m - mean) / se_m,
            "var_z": (s2 - var) / se_v}


def _nb_moments(k, p):
    var = k * (1 - p) / p ** 2
    return k * (1 - p) / p, var, (3 + 6 / k + p * p / (k * (1 - p))) * var ** 2


def array_samplers(torch, mx, seed):
    """The samplers at full size on the card, each draw's moments against
    the distribution's."""
    gpu = mx.gpu(0)
    dev = gpu.torch_device
    out = {}
    mx.random.seed(seed)
    z = mx.nd.random.normal(0.0, 1.0, shape=(ARRAY_NORMAL_DRAWS,), ctx=gpu)
    out["normal_25.6M"] = _moments_ok(torch, z.astorch(), 0.0, 1.0, 3.0,
                                      "normal")
    del z
    n = ARRAY_DRAWS
    lo_hi = 9 - (-3)
    for name, draw, mom in (
            ("uniform", lambda: mx.nd.random.uniform(-1.0, 3.0, shape=(n,),
                                                     ctx=gpu),
             (1.0, 16 / 12, 256 / 80)),
            ("gamma", lambda: mx.nd.random.gamma(2.5, 1.5, shape=(n,),
                                                 ctx=gpu),
             (3.75, 2.5 * 2.25, 3 * 2.5 * 4.5 * 1.5 ** 4)),
            ("exponential", lambda: mx.nd.random.exponential(2.0, shape=(n,),
                                                             ctx=gpu),
             (0.5, 0.25, 9 / 16)),
            ("poisson", lambda: mx.nd.random.poisson(4.0, shape=(n,),
                                                     ctx=gpu),
             (4.0, 4.0, 4.0 * 13)),
            ("negative_binomial", lambda: mx.nd.random.negative_binomial(
                3, 0.4, shape=(n,), ctx=gpu), _nb_moments(3, 0.4)),
            ("generalized_negative_binomial",
             lambda: mx.nd.random.generalized_negative_binomial(
                 2.0, 0.5, shape=(n,), ctx=gpu), _nb_moments(2.0, 0.5)),
            ("randint", lambda: mx.nd.random.randint(-3, 9, shape=(n,),
                                                     ctx=gpu),
             (2.5, (lo_hi ** 2 - 1) / 12,
              (lo_hi ** 2 - 1) * (3 * lo_hi ** 2 - 7) / 240))):
        v = draw()
        check(v.astorch().device == dev, "%s drew off the card" % name)
        out[name] = _moments_ok(torch, v.astorch(), *mom, what=name)
    # the per-parameter samplers: 10 parameters, 10**6 draws each
    import numpy as onp
    a = onp.linspace(0.5, 5.0, 10).astype("float32")
    b = onp.linspace(0.2, 2.0, 10).astype("float32")
    pa, pb = mx.nd.array(a, ctx=gpu), mx.nd.array(b, ctx=gpu)
    per = n // 10
    for name, draw, mom in (
            ("sample_uniform", lambda: mx.nd.sample_uniform(pa - 3.0, pa + pb,
                                                            shape=(per,)),
             lambda p, q: ((2 * p - 3 + q) / 2, (q + 3) ** 2 / 12,
                           (q + 3) ** 4 / 80)),
            ("sample_normal", lambda: mx.nd.sample_normal(pa, pb,
                                                          shape=(per,)),
             lambda p, q: (p, q * q, 3 * q ** 4)),
            ("sample_gamma", lambda: mx.nd.sample_gamma(pa, pb, shape=(per,)),
             lambda p, q: (p * q, p * q * q, 3 * p * (p + 2) * q ** 4))):
        v = draw().astorch()
        rows = [_moments_ok(torch, v[i], *mom(float(a[i]), float(b[i])),
                            what="%s row %d" % (name, i)) for i in range(10)]
        out[name] = {"n": v.numel(), "max_abs_mean_z":
                     max(abs(r["mean_z"]) for r in rows),
                     "max_abs_var_z": max(abs(r["var_z"]) for r in rows)}
    # a category over BERT's vocabulary (Zipf-like weights)
    k = torch.arange(BERT_VOCAB, device=dev, dtype=torch.float64)
    p = 1.0 / (k + 10.0)
    p = p / p.sum()
    mean = (k * p).sum().item()
    var = ((k - mean) ** 2 * p).sum().item()
    mu4 = ((k - mean) ** 4 * p).sum().item()
    probs = mx.nd.array(p.float(), ctx=gpu)
    draws = mx.nd.random.multinomial(probs, shape=(n,))
    check(str(draws.dtype) == "int32" and draws.shape == (n,),
          "multinomial: %s %s" % (draws.dtype, draws.shape))
    out["multinomial_30522"] = _moments_ok(torch, draws.astorch(), mean, var,
                                           mu4, "multinomial")
    # shuffle of 50,000 rows: a permutation of the rows, and the new
    # position of a row uncorrelated with its old one (the correlation of
    # a random permutation has standard error 1/sqrt(n - 1))
    rows = ARRAY_SHUFFLE_ROWS
    x = mx.nd.array(onp.arange(rows * 2, dtype="float32").reshape(rows, 2),
                    ctx=gpu)
    s = mx.nd.random.shuffle(x).astorch()
    old = s[:, 0].double() / 2
    check(bool((s[:, 1] == s[:, 0] + 1).all()) and torch.equal(
        torch.sort(old).values, torch.arange(rows, device=dev,
                                             dtype=torch.float64)),
          "shuffle: not a permutation of the rows")
    new = torch.arange(rows, device=dev, dtype=torch.float64)
    rho = torch.corrcoef(torch.stack([old, new]))[0, 1].item()
    check(abs(rho) <= ARRAY_SE / (rows - 1) ** 0.5,
          "shuffle: position correlation %.3g" % rho)
    out["shuffle_50000"] = {"rows": rows, "position_corr": rho}
    # reseeding repeats the bits; two seeds differ
    def draws3(s):
        mx.random.seed(s)
        return [mx.nd.random.normal(shape=(1000,), ctx=gpu).astorch().cpu(),
                mx.nd.random.poisson(3.0, shape=(1000,), ctx=gpu).astorch()
                .cpu(),
                mx.nd.random.shuffle(mx.nd.arange(100, ctx=gpu)).astorch()
                .cpu()]
    r1, r2, r3 = draws3(seed + 5), draws3(seed + 5), draws3(seed + 6)
    check(all(torch.equal(u, w) for u, w in zip(r1, r2)),
          "mx.random.seed: the same seed drew other numbers")
    check(not torch.equal(r1[0], r3[0]), "two seeds drew the same numbers")
    return out


def _random_block(mx):
    """A HybridBlock that adds ``F.random.normal`` noise (its class made
    here: this module imports the package only inside its phases)."""
    class Noisy(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return x + F.random.normal(shape=x.shape, ctx=x.context)
    return Noisy(prefix="noisy_")


def hybrid_random_replays(torch, mx, seed):
    """A hybridized block drawing ``F.random.normal`` replays its graph
    (captured once) with new numbers each call, and the same numbers after
    the same ``mx.random.seed``."""
    from mxnet_tpu_torch import telemetry
    net = _random_block(mx)
    net.hybridize()
    x = mx.nd.zeros((4, 1024), ctx=mx.gpu(0))
    name = "CachedOp_%s" % net.name
    before = telemetry.compile_counts().get(name, 0)
    calls = [net(x).astorch().clone() for _ in range(4)]

    def two(s):
        mx.random.seed(s)
        return [net(x).astorch().clone() for _ in range(2)]
    first, again = two(seed), two(seed)
    check(telemetry.compile_counts().get(name, 0) - before == 1,
          "the random block was not captured once")
    check(all(not torch.equal(calls[i], calls[j]) for i in range(4)
              for j in range(i)), "a replay repeated its draws")
    check(all(torch.equal(a, b) for a, b in zip(first, again))
          and not torch.equal(first[0], first[1]),
          "reseeding did not repeat the replays")
    z = calls[1].double()
    return {"replays": 8, "mean": z.mean().item(), "std": z.std().item()}


def _mlm_eval(mx, logits, labels):
    """The masked-LM evaluation ops on ``logits`` (B, P, V) and ``labels``
    (B, P): top-5 values and indices, the labels' logits, top-1 and top-5
    hits, the labels one-hot, and the vocabulary's order."""
    vals, idx = mx.nd.topk(logits, k=5, ret_typ="both")
    picked = mx.nd.pick(logits, labels)
    hit1 = mx.nd.broadcast_equal(idx.slice_axis(axis=2, begin=0, end=1)
                                 .squeeze(axis=2), labels)
    hit5 = mx.nd.broadcast_equal(idx, labels.expand_dims(2)).sum(axis=2)
    oh = mx.nd.one_hot(labels, depth=BERT_VOCAB)
    order = mx.nd.argsort(logits, axis=-1)
    return {"top5_values": vals, "top5_indices": idx, "picked": picked,
            "top1_hits": hit1, "top5_hits": hit5, "one_hot": oh,
            "argsort": order}


def _bits(torch, o):
    t = o.astorch().detach().cpu()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def array_full_width(torch, mx, logits, seed, card, flush):
    """Phase (b) and the device times of (c)."""
    import numpy as onp
    gpu = mx.gpu(0)
    dev = gpu.torch_device
    rows = []

    def timed(case, nd_fn, plain_fn, library_fn=None):
        ms = time_cuda(torch, nd_fn, flush)
        plain_ms = time_cuda(torch, plain_fn, flush)
        lib_ms = time_cuda(torch, library_fn, flush) if library_fn else None
        rows.append({"case": case, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms})
        print("array %-34s mx.nd %.4f ms  plain torch %.4f ms%s  (%s)"
              % (case, ms, plain_ms, "" if lib_ms is None else
                 "  library %.4f ms" % lib_ms, card))

    # BERT-base masked-LM evaluation, card against the CPU, same logits
    rs = onp.random.RandomState(seed + 31)
    labels_np = rs.randint(0, BERT_VOCAB, (BERT_BATCH, BERT_PRED))
    labels = mx.nd.array(labels_np, ctx=gpu, dtype="int32")
    check(logits.shape == (BERT_BATCH, BERT_PRED, BERT_VOCAB)
          and str(logits.dtype) == "torch.bfloat16",
          "MLM logits %s %s" % (logits.shape, logits.dtype))
    t0 = time.perf_counter()
    got = _mlm_eval(mx, logits, labels)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    host_logits = logits.as_in_context(mx.cpu())
    t0 = time.perf_counter()
    with mx.cpu():
        want = _mlm_eval(mx, host_logits,
                         mx.nd.array(labels_np, ctx=mx.cpu(), dtype="int32"))
    cpu_s = time.perf_counter() - t0
    for k in got:
        g, w = _bits(torch, got[k]), _bits(torch, want[k])
        check(g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w),
              "MLM eval %s: the card and the CPU differ" % k)
    ties = int((torch.sort(host_logits.astorch().float(), dim=-1,
                           descending=True).values[..., :6].diff(dim=-1)
                == 0).any(dim=-1).sum())
    acc1 = got["top1_hits"].astorch().float().mean().item()
    acc5 = got["top5_hits"].astorch().float().mean().item()
    print("array: BERT-base MLM eval on the bf16 logits (%d, %d, %d): top-5, "
          "pick, hits, one_hot, argsort: the card's indices and values the "
          "CPU's bits (%d rows with a tie among their 6 largest); top-1 "
          "accuracy %.5f, top-5 %.5f against random labels; card %.2f s, "
          "CPU %.2f s with the first call"
          % (BERT_BATCH, BERT_PRED, BERT_VOCAB, ties, acc1, acc5, card_s,
             cpu_s))
    del want, host_logits
    lt = logits.astorch()
    lab64 = labels.astorch().long()
    timed("topk_k5_both_bert_logits",
          lambda: mx.nd.topk(logits, k=5, ret_typ="both"),
          lambda: torch.sort(lt, dim=-1, descending=True, stable=True),
          lambda: torch.topk(lt, 5, dim=-1))
    timed("pick_labels", lambda: mx.nd.pick(logits, labels),
          lambda: torch.take_along_dim(lt, lab64.unsqueeze(-1), dim=-1))
    timed("one_hot_30522", lambda: mx.nd.one_hot(labels, depth=BERT_VOCAB),
          lambda: torch.zeros(lab64.shape + (BERT_VOCAB,), device=dev)
          .scatter_(-1, lab64.unsqueeze(-1), 1.0),
          lambda: torch.nn.functional.one_hot(lab64, BERT_VOCAB))
    timed("argsort_vocab", lambda: mx.nd.argsort(logits, axis=-1),
          lambda: torch.argsort(lt, dim=-1, stable=True))
    del got
    torch.cuda.empty_cache()

    # dot at BERT-base's FFN shapes, float32 and bf16 (TF32 off)
    g = torch.Generator(device=dev).manual_seed(seed + 32)
    n_tok = BERT_BATCH * BERT_SEQ
    ffn = 4 * BERT_UNITS
    a32 = torch.randn(n_tok, BERT_UNITS, device=dev, generator=g)
    b32 = torch.randn(BERT_UNITS, ffn, device=dev, generator=g)
    bt32 = b32.t().contiguous()
    ref = None
    for dt in ("float32", "bfloat16"):
        tdt = getattr(torch, dt)
        A = mx.nd.array(a32.to(tdt), ctx=gpu)
        B = mx.nd.array(b32.to(tdt), ctx=gpu)
        Bt = mx.nd.array(bt32.to(tdt), ctx=gpu)
        out = mx.nd.dot(A, B).astorch()
        out_t = mx.nd.dot(A, Bt, transpose_b=True).astorch()
        if ref is None:
            ref = (a32.double() @ b32.double()).float()
        err = ((out.float() - ref).norm() / ref.norm()).item()
        err_t = ((out_t.float() - ref).norm() / ref.norm()).item()
        tol = 1e-6 if dt == "float32" else 1e-2
        check(err <= tol and err_t <= tol, "dot %s: rel L2 err %.3g, "
              "transpose_b %.3g" % (dt, err, err_t))
        print("array: dot (%d, %d) . (%d, %d) %s: rel L2 err against float64 "
              "%.3g, transpose_b %.3g" % (n_tok, BERT_UNITS, BERT_UNITS, ffn,
                                          dt, err, err_t))
        At, Btt, Btt_t = A.astorch(), B.astorch(), Bt.astorch()
        timed("dot_%s" % dt, lambda: mx.nd.dot(A, B),
              lambda: torch.matmul(At, Btt))
        timed("dot_%s_transpose_b" % dt,
              lambda: mx.nd.dot(A, Bt, transpose_b=True),
              lambda: torch.matmul(At, Btt_t.t()))
        del A, B, Bt, out, out_t
    del a32, b32, bt32, ref
    torch.cuda.empty_cache()

    # take of the word embedding by the batch's ids
    tokens, _, pos = bert_inputs(seed)
    emb = torch.randn(BERT_VOCAB, BERT_UNITS, device=dev, generator=g)
    E = mx.nd.array(emb, ctx=gpu)
    ids = mx.nd.array(tokens, ctx=gpu)
    rows_ = mx.nd.take(E, ids)
    ids64 = ids.astorch().long()
    check(rows_.shape == (BERT_BATCH, BERT_SEQ, BERT_UNITS) and torch.equal(
        rows_.astorch(), torch.nn.functional.embedding(ids64, emb)),
        "take of the embedding differs from its rows")
    timed("take_embedding", lambda: mx.nd.take(E, ids),
          lambda: torch.index_select(emb, 0, ids64.reshape(-1)),
          lambda: torch.nn.functional.embedding(ids64, emb))
    del E, rows_, emb
    # Reshape of the sequence output into heads
    seq = mx.nd.array(torch.randn(BERT_BATCH, BERT_SEQ, BERT_UNITS,
                                  device=dev, generator=g), ctx=gpu)
    heads = mx.nd.Reshape(seq, shape=(0, 0, -4, BERT_HEADS, -1))
    check(heads.shape == (BERT_BATCH, BERT_SEQ, BERT_HEADS,
                          BERT_UNITS // BERT_HEADS)
          and heads.astorch().data_ptr() == seq.astorch().data_ptr(),
          "Reshape (0, 0, -4, 12, -1) gave %s" % (heads.shape,))
    st = seq.astorch()
    timed("reshape_0_0_m4_12_m1",
          lambda: mx.nd.Reshape(seq, shape=(0, 0, -4, BERT_HEADS, -1)),
          lambda: st.reshape(BERT_BATCH, BERT_SEQ, BERT_HEADS, -1))
    # gather_nd / scatter_nd at the masked positions
    bidx = onp.repeat(onp.arange(BERT_BATCH), BERT_PRED)
    ind = mx.nd.array(onp.stack([bidx, pos.reshape(-1)]), ctx=gpu,
                      dtype="int32")
    picked = mx.nd.gather_nd(seq, ind)
    check(torch.equal(picked.astorch(), mx.nd.gather_positions(
        seq, mx.nd.array(pos, ctx=gpu, dtype="int32")).astorch()
        .reshape(-1, BERT_UNITS)), "gather_nd differs from the positions'")
    back = mx.nd.scatter_nd(picked, ind, shape=(BERT_BATCH, BERT_SEQ,
                                                BERT_UNITS))
    check(torch.equal(mx.nd.gather_nd(back, ind).astorch(),
                      picked.astorch()), "scatter_nd lost the rows")
    it = tuple(ind.astorch().long())
    pt = picked.astorch()
    timed("gather_nd_masked_positions", lambda: mx.nd.gather_nd(seq, ind),
          lambda: st[it])
    timed("scatter_nd_masked_positions",
          lambda: mx.nd.scatter_nd(picked, ind, shape=(BERT_BATCH, BERT_SEQ,
                                                       BERT_UNITS)),
          lambda: torch.zeros_like(st).index_put_(it, pt, accumulate=True))
    del seq, heads, picked, back
    # the FFN activation's elementwise ops, float32 and bf16
    act32 = torch.randn(BERT_BATCH, BERT_SEQ, ffn, device=dev, generator=g)
    for dt in ("float32", "bfloat16"):
        h = mx.nd.array(act32.to(getattr(torch, dt)), ctx=gpu)
        ht = h.astorch()
        ha = ht.abs() + 0.5
        habs = mx.nd.array(ha, ctx=gpu)
        host = mx.nd.array(ht[0].cpu(), ctx=mx.cpu())
        host_abs = mx.nd.array(ha[0].cpu(), ctx=mx.cpu())
        for op, fn, plain, src, hsrc in (
                ("exp", lambda: mx.nd.exp(h), lambda: torch.exp(ht), h, host),
                ("erf", lambda: mx.nd.erf(h), lambda: torch.erf(ht), h, host),
                ("rsqrt", lambda: mx.nd.rsqrt(habs),
                 lambda: torch.rsqrt(ha), habs, host_abs),
                ("clip", lambda: mx.nd.clip(h, a_min=-1.0, a_max=1.0),
                 lambda: torch.clamp(ht, -1.0, 1.0), h, host)):
            out = getattr(mx.nd, op)(src, **({"a_min": -1.0, "a_max": 1.0}
                                            if op == "clip" else {}))
            with mx.cpu():
                ref = getattr(mx.nd, op)(hsrc, **({"a_min": -1.0,
                                                   "a_max": 1.0}
                                                  if op == "clip" else {}))
            gv = out.astorch()[0].float().cpu()
            rv = ref.astorch().float()
            big = torch.maximum(gv.abs(), rv.abs())
            tol = (ARRAY_ULP[dt] if dt in ARRAY_ULP else ARRAY_F32_RTOL) \
                * big + ARRAY_F32_ATOL
            excess = ((gv - rv).abs() - tol).max().item()
            check(out.dtype == ref.dtype and excess <= 0,
                  "%s %s at (24, 512, 3072): the card and the CPU differ "
                  "(max |err| %.3g)" % (op, dt, (gv - rv).abs().max().item()))
            timed("%s_ffn_%s" % (op, dt), fn, plain)
        del h, habs, host, host_abs, ha
    del act32
    torch.cuda.empty_cache()
    return rows


def dispatch_host_us(torch, mx):
    """Host microseconds a ``mx.nd`` call of a one-element op on the card
    takes (the median of ARRAY_DISPATCH_CALLS calls, the card kept busy),
    eager and under ``amp.init("float16")`` (a float32-list op, whose
    input the policy casts, and a widest-type op)."""
    from mxnet_tpu_torch.contrib import amp
    one = mx.nd.array([1.5], ctx=mx.gpu(0))
    half = one.astype("float16")

    def median_us(fn):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        times = []
        for _ in range(ARRAY_DISPATCH_CALLS):
            t = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t)
        torch.cuda.synchronize()
        return statistics.median(times) * 1e6
    out = {"exp_eager": median_us(lambda: mx.nd.exp(one)),
           "broadcast_add_eager": median_us(lambda: mx.nd.broadcast_add(
               one, one)),
           "plain_torch_exp": median_us(lambda: torch.exp(one.astorch()))}
    amp.init(target_dtype="float16")
    try:
        check(str(mx.nd.exp(half).dtype) == "float32",
              "amp: exp of float16 is not float32")
        out["exp_amp_f16_input"] = median_us(lambda: mx.nd.exp(half))
        out["broadcast_add_amp"] = median_us(
            lambda: mx.nd.broadcast_add(half, one))
    finally:
        amp.disable()
    return out


def array_phase(torch, mx, logits, seed, card):
    """The array surface on the card: (a) the sweep, (b) full width, (c)
    device ms and host µs a dispatch.  ``logits``: bert_phase's last bf16
    MLM logits."""
    t0 = time.perf_counter()
    sweep = array_sweep(torch, mx, seed)
    print("array ops on the card: %d of %d (%d cases, each against the same "
          "call on the CPU)" % (sweep["covered"], sweep["ops"],
                                sweep["cases"]))
    sweep_s = time.perf_counter() - t0
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=mx.gpu(0).torch_device)
    rows = array_full_width(torch, mx, logits, seed, card, flush)
    del flush
    torch.cuda.empty_cache()
    samplers = array_samplers(torch, mx, seed)
    for k, v in samplers.items():
        print("array sampler %-30s %s" % (k, ", ".join(
            "%s %s" % (a, ("%.4g" % b) if isinstance(b, float) else b)
            for a, b in v.items())))
    replays = hybrid_random_replays(torch, mx, seed)
    print("array: hybridized F.random.normal block: %d calls, one capture, "
          "each replay new draws, reseeding repeats them; a replay's mean "
          "%.4g std %.4g" % (replays["replays"], replays["mean"],
                             replays["std"]))
    host = dispatch_host_us(torch, mx)
    print("array: host us a mx.nd dispatch of a one-element op on the card "
          "(median of %d): %s  (%s)" % (ARRAY_DISPATCH_CALLS, ", ".join(
              "%s %.2f" % kv for kv in host.items()), card))
    torch.cuda.empty_cache()
    return {"sweep": sweep, "sweep_s": sweep_s, "full_width": rows,
            "samplers": samplers, "replays": replays, "dispatch_us": host}


# float16 models: ResNet-50 v1 and BERT-base cast whole with
# net.cast("float16"), as bench.py's bench_inference, _build_train_step and
# _build_bert_step cast them.  BatchNorm keeps float32 parameters; every
# other parameter, the data and the activations are float16, so the
# epilogue and LayerNorm kernels run their float16 instantiations.
F16_INFER_BATCH = 128               # the reference's fp16 inference batch
F16_CALLS = 8                       # hybridized forwards each way
INFER_F16_SHAPES = [((F16_INFER_BATCH,) + chw, n) for chw, n in STAGES]
# Card against CPU in float16, a narrow ResNetV1 (one bottleneck a stage,
# widths 8..128, 10 classes) at 32 x 32 and a 2-layer BERT at BERT-base's
# widths (batch 2, S 128): logits within 1e-2 of the largest |logit| (a
# float16 ulp or two of a value: the card's reductions and GEMMs sum in
# another order before each rounding); two steps, each side from the same
# weights: the losses within rel 1e-2.  After each step what each leaf
# holds (its float32 master, or the float32 BatchNorm weight) is compared
# as an update from the start (``_leaf_update_errors``: 0 the same update,
# 1 none, 2 the opposite sign, about 0.5 a second step left out).  SGD:
# the worst leaf within F16_SGD_LEAF_REL.  Two float16 steps on two
# devices differ about as much as a float16 step and a float32 one
# (BatchNorm's gradients cancel over the batch, so a rounding of dy moves
# them by percents): over seeds 0-2 on an H100 the worst leaf read 3.3e-3,
# 5.0e-2 and 8.8e-2 after the first step and 6.1e-2, 0.24 and 0.24 after
# the second, the CPU's float16 step against its float32 step 0.29, 0.13
# and 0.10, then 0.68, 0.33 and 0.28 (printed beside it); so this check
# catches a step left out, a leaf left unmoved or of the wrong sign, not
# a step in another precision (the spy on the kernels' dtypes and the
# parameter dtypes check that).  Adam moves each weight by about lr
# whatever its gradient, so one leaf's update is no measure (one gradient
# near 0 that rounds to the other sign moves one of LayerNorm's 768
# gammas by 2 lr): each leaf's first moment, the gradient's running mean,
# within F16_ADAM_MOMENT_REL (read 1.1e-3 to 1.5e-3 over seeds 0-2), and
# the update over all leaves within F16_ADAM_UPDATE_REL_L2 (read 1.1e-2
# to 2.1e-2).
F16_NARROW = ([1, 1, 1, 1], [8, 16, 32, 64, 128])
F16_PARITY_BATCH = 16
F16_PARITY_STEPS = 2
F16_LOGIT_REL, F16_LOSS_RTOL, F16_SGD_LEAF_REL = 1e-2, 1e-2, 0.4
F16_ADAM_MOMENT_REL, F16_ADAM_UPDATE_REL_L2 = 1e-2, 0.2
F16_SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
           "multi_precision": True}


def _f16_arrays(net):
    return {k: p.data().astype("float32").asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _step_state(step, net, leaf):
    """Structural name -> a float32 host copy of each trainable weight's
    optimizer state: ``leaf`` 0 its float32 master under multi_precision
    (else the weight itself), 1 the state leaf after the master."""
    names = {id(p): k for k, p in net._collect_params_with_prefix().items()}
    out = {}
    for slot, i in enumerate(step._trainable):
        mp = step._mp_slots[slot]
        v = step._opt_states[slot][leaf + mp - 1] if leaf or mp \
            else step._params[i].data().astorch()
        out[names[id(step._params[i])]] = \
            v.detach().float().cpu().numpy().copy()
    return out


def _leaf_update_errors(got, want, before):
    """Per leaf, the L2 error of the update, ||got - want||, over the larger
    of the reference update's L2 norm ||want - before|| and the whole
    step's RMS update over as many elements: 0 for the same update, 1 for
    none, 2 for one of the opposite sign.  A leaf that barely moves (a
    stem beta whose gradient cancels over the batch) is held to the
    step's scale, not to its own."""
    import numpy as onp
    sq = {k: float(((w - before[k]).astype("float64") ** 2).sum())
          for k, w in want.items()}
    mean_sq = sum(sq.values()) / sum(w.size for w in want.values())
    return {k: float(onp.linalg.norm((got[k] - w).astype("float64")))
            / max(sq[k], mean_sq * w.size) ** 0.5
            for k, w in want.items()}


def _update_rel_l2(got, want, before):
    """The relative L2 error of the update over all leaves together."""
    num = sum(float(((got[k] - want[k]).astype("float64") ** 2).sum())
              for k in want)
    den = sum(float(((want[k] - before[k]).astype("float64") ** 2).sum())
              for k in want)
    return (num / den) ** 0.5


def _worst(errs):
    k = max(errs, key=errs.get)
    return k, errs[k]


def _drop_key_bias(arrays):
    """The key third of each fused qkv bias left out: its gradient is 0 in
    exact arithmetic (softmax is unchanged by a constant added along the
    keys), so what is there is rounding noise."""
    import numpy as onp
    out = dict(arrays)
    for k, v in arrays.items():
        if k.endswith("attention.qkv.bias"):
            e = v.shape[0] // 3
            out[k] = onp.concatenate([v[:e], v[2 * e:]])
    return out


def _check_f16_dtypes(mx, net, what):
    """After ``cast("float16")``: float32 for the four parameters of every
    BatchNorm (and BatchNormAddReLU), float16 for every other."""
    bn = set()

    def visit(block):
        if isinstance(block, mx.gluon.nn.BatchNorm):
            bn.update(id(p) for _, p in block.params.items())
        for child in block._children.values():
            visit(child)
    visit(net)
    wrong = [k for k, p in net._collect_params_with_prefix().items()
             if str(p.data().dtype) != ("float32" if id(p) in bn
                                        else "float16")]
    check(not wrong, "%s: parameters of the wrong dtype after "
          "cast('float16'): %s" % (what, wrong[:6]))
    return len(bn)


def _masters_check(torch, step, net, what):
    """Every float16 weight has a float32 master in the step's state, of
    which it is the float16 rounding; float32 weights have none."""
    params = sorted(net.collect_params().items())
    n_half = 0
    for slot, i in enumerate(step._trainable):
        w = params[i][1].data().astorch()
        check(step._mp_slots[slot] == (w.dtype == torch.float16),
              "%s: %s multi_precision %s for a %s weight"
              % (what, params[i][0], step._mp_slots[slot], w.dtype))
        if step._mp_slots[slot]:
            master = step._opt_states[slot][0]
            check(master.dtype == torch.float32
                  and torch.equal(master.half(), w),
                  "%s: %s is not its float32 master rounded"
                  % (what, params[i][0]))
            n_half += 1
    check(n_half > 0, "%s: no float16 weight" % what)
    return n_half


class _PlainOnCard:
    """Counts calls of the four plain versions with a CUDA operand (a
    float16 operand on the card must launch a kernel or raise, never
    reach a plain version) and the dtypes that reach the kernels'
    wrappers, while active."""

    def __init__(self, fused_norm, layernorm):
        self.modules = ((fused_norm, ("fused_bn_add_relu_epilogue_plain",
                                      "fused_bn_add_relu_epilogue_bwd_plain",
                                      "_fwd_kernel",
                                      "fused_bn_add_relu_epilogue_bwd")),
                        (layernorm, ("_layer_norm_fwd_plain",
                                     "_layer_norm_bwd_plain",
                                     "layer_norm_fwd", "layer_norm_bwd")))
        self.plain_on_card = 0
        self.kernel_dtypes = set()
        self._orig = []

    def __enter__(self):
        for module, names in self.modules:
            for name in names:
                orig = getattr(module, name)
                self._orig.append((module, name, orig))
                setattr(module, name, self._spy(name, orig))
        return self

    def _spy(self, name, orig):
        def spy(*args, **kwargs):
            if args[0].device.type == "cuda":
                if "plain" in name:
                    self.plain_on_card += 1
                else:
                    self.kernel_dtypes.add(str(args[0].dtype)
                                           .replace("torch.", ""))
            return orig(*args, **kwargs)
        return spy

    def __exit__(self, *exc):
        for module, name, orig in self._orig:
            setattr(module, name, orig)


def _narrow_resnet(mx, ctx):
    """The narrow ResNetV1, Xavier weights and deferred shapes settled on
    the host, then on ``ctx``."""
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tresnet
    net = tresnet.ResNetV1(tresnet.BottleneckV1, *F16_NARROW, classes=10)
    with mx.cpu():
        net.initialize(mx.init.Xavier())
        with mx.autograd.predict_mode():
            net(mx.nd.zeros((1, 3, 32, 32)))
    net.collect_params().reset_ctx(ctx)
    return net


def f16_resnet_card_vs_cpu(torch, mx, seed):
    """The narrow ResNetV1 cast to float16 on the card and on the CPU from
    the same weights: eval logits at batch 4 and two DataParallelStep SGD
    steps with multi_precision at batch F16_PARITY_BATCH; the CPU's
    float32 step beside it as the floor of what float16 rounding moves.
    Returns the logits' error, the losses' and, after each step, the worst
    leaf's update error and the update error over all leaves."""
    import numpy as onp
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.utils import load_jax_params
    rs = onp.random.RandomState(seed + 21)
    x = rs.uniform(-1, 1, (F16_PARITY_BATCH, 3, 32, 32)).astype("float32")
    y = rs.randint(0, 10, F16_PARITY_BATCH).astype("float32")
    mx.random.seed(seed)
    gnet = _narrow_resnet(mx, mx.gpu(0))
    w32 = _param_arrays(gnet)
    gnet.cast("float16")
    w16 = _f16_arrays(gnet)

    def run(net, ctx, dtype):
        with mx.autograd.predict_mode():
            logits = net(mx.nd.array(x[:4], ctx=ctx).astype(dtype)) \
                .astype("float32").asnumpy()
        sgd = dict(F16_SGD, rescale_grad=1.0 / F16_PARITY_BATCH)
        step = mx.parallel.DataParallelStep(
            net, gluon.loss.SoftmaxCrossEntropyLoss(),
            mx.optimizer.SGD(**sgd), mesh=None)
        losses, trained = [], []
        for _ in range(F16_PARITY_STEPS):
            losses.append(float(step(mx.nd.array(x, ctx=ctx).astype(dtype),
                                     mx.nd.array(y, ctx=ctx))
                                .astype("float32").asnumpy()))
            trained.append(_step_state(step, net, 0))
        return logits, losses, trained
    card = run(gnet, mx.gpu(0), "float16")
    del gnet
    with mx.cpu():
        cnet = _narrow_resnet(mx, mx.cpu())
        load_jax_params(cnet, w32)
        f32 = run(cnet, mx.cpu(), "float32")
        load_jax_params(cnet, w32)
        cnet.cast("float16")
        cpu = run(cnet, mx.cpu(), "float16")
    w0 = {k: w16[k] for k in cpu[2][0]}
    logit_rel = float(onp.abs(card[0] - cpu[0]).max()
                      / onp.abs(cpu[0]).max())
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card[1], cpu[1]))
    return {"logit_rel": logit_rel, "loss_rel": loss_rel,
            "worst_leaf": [_worst(_leaf_update_errors(g, c, w0))
                           for g, c in zip(card[2], cpu[2])],
            "update_rel_l2": [_update_rel_l2(g, c, w0)
                              for g, c in zip(card[2], cpu[2])],
            "floor_worst_leaf": [_worst(_leaf_update_errors(c, f, w0))
                                 for c, f in zip(cpu[2], f32[2])],
            "floor_update_rel_l2": [_update_rel_l2(c, f, w0)
                                    for c, f in zip(cpu[2], f32[2])],
            "losses_card": card[1], "losses_cpu": cpu[1]}


def f16_resnet_phase(torch, mx, fused_norm, seed, card, profile=False):
    """ResNet-50 v1 in float16: built as bench.py's bench_inference and
    _build_train_step build it (Xavier weights and deferred shapes on the
    host, ``cast("float16")``, ``reset_ctx`` onto the card); (a) its eval
    forward at batch 128, hybridized and replayed as a CUDA graph, against
    the same forward eagerly; the same net served through
    ``InferenceServer`` by a float16 ``AotModel`` (64 requests in bursts of
    1-8, buckets 1, 2, 4 and 8 graphed); (b) trained through
    ``DataParallelStep`` (SGD with ``rescale_grad = 1/32`` and
    ``multi_precision``, batch 32, float16 data), graphed against eager.
    The narrow card-vs-CPU check runs first.  Everything under
    ``cudnn.deterministic``; 16 epilogue launches a forward, 16 + 16 a
    step."""
    import numpy as onp
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.model_zoo import vision
    t0 = time.perf_counter()
    par = f16_resnet_card_vs_cpu(torch, mx, seed)
    parity_s = time.perf_counter() - t0
    print("f16 resnet: card vs CPU, narrow ResNetV1 in float16: eval logits "
          "rel err %.3g; %d DataParallelStep SGD steps at batch %d: losses "
          "%s (card) %s (CPU), loss rel err %.3g; after each step the worst "
          "leaf's update error %s, over all leaves %s (floor, the CPU's "
          "float16 step vs its float32 step: worst leaf %s, all leaves %s)"
          % (par["logit_rel"], F16_PARITY_STEPS, F16_PARITY_BATCH,
             [round(v, 5) for v in par["losses_card"]],
             [round(v, 5) for v in par["losses_cpu"]], par["loss_rel"],
             ["%s %.3g" % w for w in par["worst_leaf"]],
             ["%.3g" % v for v in par["update_rel_l2"]],
             ["%s %.3g" % w for w in par["floor_worst_leaf"]],
             ["%.3g" % v for v in par["floor_update_rel_l2"]]))
    check(par["logit_rel"] <= F16_LOGIT_REL, "f16 ResNet card vs CPU "
          "logits: rel err %.3g > %g" % (par["logit_rel"], F16_LOGIT_REL))
    check(par["loss_rel"] <= F16_LOSS_RTOL, "f16 ResNet card vs CPU loss "
          "rel err %.3g > %g" % (par["loss_rel"], F16_LOSS_RTOL))
    for i, (leaf, err) in enumerate(par["worst_leaf"]):
        check(err <= F16_SGD_LEAF_REL, "f16 ResNet card vs CPU, step %d: "
              "%s's update error %.3g > %g" % (i + 1, leaf, err,
                                               F16_SGD_LEAF_REL))
    torch.cuda.empty_cache()

    gpu = mx.gpu(0)
    mx.random.seed(seed)
    net = vision.get_model("resnet50_v1", classes=1000)
    with mx.cpu():
        net.initialize(mx.init.Xavier())
        with mx.autograd.predict_mode():
            net(mx.nd.zeros((1, 3, IMAGE_SIZE, IMAGE_SIZE)))
    net.cast("float16")
    net.collect_params().reset_ctx(gpu)
    check(_check_f16_dtypes(mx, net, "ResNet-50 v1") == 4 * 53,
          "ResNet-50 v1: not 53 BatchNorms")
    rs = onp.random.RandomState(seed)
    x = mx.nd.array(rs.uniform(size=(F16_INFER_BATCH, 3, IMAGE_SIZE,
                                     IMAGE_SIZE)).astype("float32"),
                    ctx=gpu).astype("float16")
    was_deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {"parity": par, "parity_s": parity_s}
    try:
        # (a) the batch-128 eval forward: eager, then hybridized
        inf = hybridized_calls(
            torch, mx, net, lambda: net(x).astorch(), F16_CALLS,
            _epilogue_counts(fused_norm), "ResNet-50 v1 float16 forward, "
            "batch %d" % F16_INFER_BATCH, profile=profile)
        logits = inf.pop("last")
        check(logits.dtype == torch.float16
              and tuple(logits.shape) == (F16_INFER_BATCH, 1000)
              and bool(torch.isfinite(logits).all()),
              "f16 ResNet forward: %s %s, finite %s"
              % (logits.dtype, tuple(logits.shape),
                 bool(torch.isfinite(logits).all())))
        inf["launches"] = inf["launches"][0]
        check(inf["launches"] == 16 * F16_CALLS, "%d epilogue launches in "
              "%d float16 forwards (want 16 each)" % (inf["launches"],
                                                      F16_CALLS))
        inf["images_per_s"] = F16_INFER_BATCH * 1e3 / inf["graphed_ms"]
        if "profile" in inf:
            inf["profile_kernels"] = _kernel_names_check(inf["profile"],
                                                         "resnet_forward")
        out["infer"] = inf
        del logits
        torch.cuda.empty_cache()

        # serving: the same net behind a float16 AotModel; its clients
        # send float32 images, as the float32 phase's do, cast into the
        # float16 batch as the server assembles it
        images = onp.random.RandomState(seed + 3).uniform(
            -1, 1, (N_REQUESTS, 3, IMAGE_SIZE, IMAGE_SIZE)).astype("float32")
        out["serve"] = serve_requests(torch, mx, fused_norm, net, images,
                                      "resnet50_v1_f16", F16_LOGIT_REL,
                                      dtype="float16")
        net.hybridize(False)
        torch.cuda.empty_cache()

        # (b) training through DataParallelStep, bench.py's SGD with
        # multi_precision, float16 data
        xt = mx.nd.array(rs.uniform(size=(TRAIN_BATCH, 3, IMAGE_SIZE,
                                          IMAGE_SIZE)).astype("float32"),
                         ctx=gpu).astype("float16")
        yt = mx.nd.array(rs.randint(0, 1000, (TRAIN_BATCH,))
                         .astype("float32"), ctx=gpu)
        ce = gluon.loss.SoftmaxCrossEntropyLoss()
        sgd = dict(DP_RESNET_SGD, multi_precision=True)
        lr = sgd.pop("learning_rate")
        masters = []
        out["train"] = graphed_vs_eager(
            torch, mx, net, lambda: mx.parallel.DataParallelStep(
                net, ce, _scheduled(mx, mx.optimizer.SGD, lr, **sgd),
                mesh=None),
            xt, yt, seed, "ResNet-50 v1 float16 DataParallelStep, SGD "
            "multi_precision", counts=_epilogue_counts(fused_norm),
            per_step=(16, 16),
            profile_as="resnet_step" if profile else None,
            deterministic=True,
            after=lambda step: masters.append(_masters_check(
                torch, step, net, "f16 ResNet step")))
        out["train"]["masters"] = masters[0]
        out["train"]["images_per_s"] = \
            TRAIN_BATCH * 1e3 / out["train"]["graphed_ms"]
    finally:
        torch.backends.cudnn.deterministic = was_deterministic
    del net
    torch.cuda.empty_cache()
    return out


def f16_bert_card_vs_cpu(torch, mx, seed):
    """A 2-layer BERT at BERT-base's widths cast to float16, on the card
    and on the CPU from the same weights: the MLM logits at batch 2, S 128,
    and two DataParallelStep Adam steps with multi_precision.  Returns the
    logits' error, the losses' and the worst weight's excess over its
    tolerance (<= 0 passes)."""
    import numpy as onp
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTModel
    from mxnet_tpu_torch.gluon.utils import load_jax_params
    rs = onp.random.RandomState(seed + 23)
    S = BERT_PARITY_SEQ
    tokens = rs.randint(0, BERT_VOCAB, (2, S)).astype("float32")
    lens = onp.array(BERT_PARITY_LENS, "int32")
    pos = onp.sort(onp.stack([rs.choice(min(BERT_PARITY_LENS),
                                        BERT_PARITY_PRED, replace=False)
                              for _ in range(2)]), 1).astype("int32")
    labels = rs.randint(0, BERT_VOCAB, (2, BERT_PARITY_PRED)) \
        .astype("float32")

    def build(ctx):
        net = BERTModel(vocab_size=BERT_VOCAB, units=BERT_UNITS,
                        hidden_size=4 * BERT_UNITS,
                        num_layers=DP_PARITY_LAYERS, num_heads=BERT_HEADS,
                        max_length=BERT_SEQ, dropout=0.0, use_pooler=False,
                        use_decoder=True)
        with mx.cpu():          # weights and deferred shapes on the host
            net.initialize(mx.init.Xavier())
            with mx.autograd.predict_mode():
                net(mx.nd.array(tokens[:1, :8]))
        net.cast("float16")
        net.collect_params().reset_ctx(ctx)
        return net

    def run(net, ctx):
        args = (mx.nd.array(tokens, ctx=ctx), None, None,
                mx.nd.array(lens, ctx=ctx, dtype="int32"),
                mx.nd.array(pos, ctx=ctx, dtype="int32"))
        with mx.autograd.predict_mode():
            logits = net(*args)[1].astype("float32").asnumpy()
        step = mx.parallel.DataParallelStep(
            net, _mlm_loss(gluon),
            mx.optimizer.Adam(learning_rate=BERT_LR, multi_precision=True))
        losses, trained, moments = [], [], []
        for _ in range(F16_PARITY_STEPS):
            losses.append(float(step(args, mx.nd.array(labels, ctx=ctx))
                                .astype("float32").asnumpy()))
            trained.append(_drop_key_bias(_step_state(step, net, 0)))
            moments.append(_drop_key_bias(_step_state(step, net, 1)))
        return logits, losses, trained, moments
    mx.random.seed(seed)
    gnet = build(mx.gpu(0))
    w0 = {k: p.data().asnumpy()
          for k, p in gnet._collect_params_with_prefix().items()}
    card = run(gnet, mx.gpu(0))
    del gnet
    with mx.cpu():
        cnet = build(mx.cpu())
        load_jax_params(cnet, w0)
        cpu = run(cnet, mx.cpu())
    check(onp.isfinite(card[0]).all() and all(onp.isfinite(card[1])),
          "f16 BERT on the card: non-finite logits or loss")
    w16 = _drop_key_bias({k: v.astype("float32") for k, v in w0.items()})
    zero = {k: onp.zeros_like(v) for k, v in w16.items()}
    return {"logit_rel": float(onp.abs(card[0] - cpu[0]).max()
                               / onp.abs(cpu[0]).max()),
            "loss_rel": max(abs(a - b) / abs(b)
                            for a, b in zip(card[1], cpu[1])),
            "worst_moment": [_worst(_leaf_update_errors(g, c, zero))
                             for g, c in zip(card[3], cpu[3])],
            "update_rel_l2": [_update_rel_l2(g, c, w16)
                              for g, c in zip(card[2], cpu[2])],
            "worst_leaf": [_worst(_leaf_update_errors(g, c, w16))
                           for g, c in zip(card[2], cpu[2])],
            "losses_card": card[1], "losses_cpu": cpu[1]}


def _bench_bert(mx, seed, dtype):
    """BERT-base as bench.py's ``_build_bert_step(dtype=...)`` builds it:
    Xavier weights from ``seed`` and deferred shapes settled on the host,
    ``cast(dtype)`` unless float32, ``reset_ctx`` onto the card; with
    bench.py's config-5 inputs there ((x, valid lengths, masked positions),
    and random labels)."""
    import numpy as onp
    tokens, lens, pos = bert_inputs(seed)
    labels = onp.random.RandomState(seed + 2).randint(
        0, BERT_VOCAB, (BERT_BATCH, BERT_PRED)).astype("float32")
    gpu = mx.gpu(0)
    inputs = (mx.nd.array(tokens, ctx=gpu),
              mx.nd.array(lens, ctx=gpu, dtype="int32"),
              mx.nd.array(pos, ctx=gpu, dtype="int32"))
    mx.random.seed(seed)
    net = _bert(mx, use_pooler=False)
    with mx.cpu():
        net.initialize(mx.init.Xavier())
        with mx.autograd.predict_mode():   # deferred shapes, on the host
            net(mx.nd.array(tokens[:1, :8]), None, None,
                mx.nd.array([8], dtype="int32"),
                mx.nd.array([[0, 1]], dtype="int32"))
    if dtype != "float32":
        net.cast(dtype)
    net.collect_params().reset_ctx(gpu)
    return net, inputs, mx.nd.array(labels, ctx=gpu)


def f16_bert_phase(torch, mx, attention, layernorm, seed, card,
                   profile=False):
    """BERT-base in float16 as bench.py's ``_build_bert_step(dtype=
    "float16")`` builds it (Xavier weights and deferred shapes on the host,
    ``cast("float16")``, ``reset_ctx`` onto the card), the fused LayerNorm
    route: its forward (the MLM logits) at 24 x 512 hybridized and replayed
    as a CUDA graph against the same forward eagerly, 12 (B, T, H, D)
    attention and 26 LayerNorm launches a forward; then its
    ``DataParallelStep`` (Adam, lr 1e-4, ``multi_precision``) graphed
    against eager, 12 + 12 attention and 26 + 26 LayerNorm launches a
    step.  The 2-layer card-vs-CPU check runs first."""
    from mxnet_tpu_torch import gluon
    os.environ["MXNET_FUSED_LAYERNORM"] = "1"
    t0 = time.perf_counter()
    par = f16_bert_card_vs_cpu(torch, mx, seed)
    parity_s = time.perf_counter() - t0
    print("f16 bert: card vs CPU, a %d-layer BERT in float16 at batch 2, S "
          "%d: logits rel err %.3g; %d DataParallelStep Adam steps: losses "
          "%s (card) %s (CPU), loss rel err %.3g; after each step the "
          "worst leaf's first-moment error %s, the update error over all "
          "leaves %s (the worst leaf's update error, not held: %s)"
          % (DP_PARITY_LAYERS, BERT_PARITY_SEQ, par["logit_rel"],
             F16_PARITY_STEPS, [round(v, 5) for v in par["losses_card"]],
             [round(v, 5) for v in par["losses_cpu"]], par["loss_rel"],
             ["%s %.3g" % w for w in par["worst_moment"]],
             ["%.3g" % v for v in par["update_rel_l2"]],
             ["%s %.3g" % w for w in par["worst_leaf"]]))
    check(par["logit_rel"] <= F16_LOGIT_REL, "f16 BERT card vs CPU logits: "
          "rel err %.3g > %g" % (par["logit_rel"], F16_LOGIT_REL))
    check(par["loss_rel"] <= F16_LOSS_RTOL, "f16 BERT card vs CPU loss rel "
          "err %.3g > %g" % (par["loss_rel"], F16_LOSS_RTOL))
    for i, ((leaf, err), upd) in enumerate(zip(par["worst_moment"],
                                               par["update_rel_l2"])):
        check(err <= F16_ADAM_MOMENT_REL, "f16 BERT card vs CPU, step %d: "
              "%s's first moment off by %.3g > %g"
              % (i + 1, leaf, err, F16_ADAM_MOMENT_REL))
        check(upd <= F16_ADAM_UPDATE_REL_L2, "f16 BERT card vs CPU, step "
              "%d: update rel L2 err %.3g > %g"
              % (i + 1, upd, F16_ADAM_UPDATE_REL_L2))
    torch.cuda.empty_cache()

    net, (x, vl, mp), y = _bench_bert(mx, seed, "float16")
    _check_f16_dtypes(mx, net, "BERT-base")
    out = {"parity": par, "parity_s": parity_s}

    def counts(reset=False):
        if reset:
            _reset_counts(attention, layernorm)
        return _bert_counts(attention, layernorm)
    fwd = hybridized_calls(
        torch, mx, net, lambda: net(x, None, None, vl, mp)[1].astorch(),
        F16_CALLS, counts, "BERT-base float16 forward", profile=profile)
    logits = fwd.pop("last")
    check(logits.dtype == torch.float16
          and tuple(logits.shape) == (BERT_BATCH, BERT_PRED, BERT_VOCAB)
          and bool(torch.isfinite(logits).all()),
          "f16 BERT forward: %s %s" % (logits.dtype, tuple(logits.shape)))
    n = F16_CALLS
    fwd["launches"], bhtd = fwd["launches"]
    check(fwd["launches"] == (BERT_ATTN_PER_FWD * n, 0, BERT_LN_PER_FWD * n,
                              0) and bhtd == (0, 0),
          "f16 BERT forward launches in %d calls: (B, T, H, D) attention fwd "
          "%d bwd %d, LayerNorm fwd %d bwd %d (want %d and %d a forward), "
          "(B, H, T, D) %r" % ((n,) + fwd["launches"]
                               + (BERT_ATTN_PER_FWD, BERT_LN_PER_FWD, bhtd)))
    fwd["tokens_per_s"] = BERT_BATCH * BERT_SEQ * 1e3 / fwd["graphed_ms"]
    out["forward"] = fwd
    del logits
    net.hybridize(False)
    torch.cuda.empty_cache()

    masters = []
    out["step"] = graphed_vs_eager(
        torch, mx, net, lambda: mx.parallel.DataParallelStep(
            net, _mlm_loss(gluon),
            _scheduled(mx, mx.optimizer.Adam, BERT_LR, multi_precision=True),
            mesh=None),
        (x, None, None, vl, mp), y, seed,
        "BERT-base float16 DataParallelStep, Adam multi_precision",
        counts=lambda reset=False: counts(reset)[0],
        per_step=(BERT_ATTN_PER_STEP,) * 2 + (BERT_LN_PER_STEP,) * 2,
        profile_as="bert" if profile else None,
        after=lambda step: masters.append(_masters_check(
            torch, step, net, "f16 BERT step")))
    out["step"]["masters"] = masters[0]
    out["step"]["tokens_per_s"] = \
        BERT_BATCH * BERT_SEQ * 1e3 / out["step"]["graphed_ms"]
    del net
    del os.environ["MXNET_FUSED_LAYERNORM"]
    torch.cuda.empty_cache()
    return out


def float16_phases(torch, mx, fused_norm, attention, layernorm, seed, card,
                   profile):
    """The float16 paths, their lines printed; returns their numbers and
    the checks that no float16 operand reached a plain version on the
    card."""
    with _PlainOnCard(fused_norm, layernorm) as spy:
        res = f16_resnet_phase(torch, mx, fused_norm, seed, card,
                               profile=profile)
        bert = f16_bert_phase(torch, mx, attention, layernorm, seed, card,
                              profile=profile)
    check(spy.plain_on_card == 0, "%d calls of a plain version with a CUDA "
          "operand on the float16 paths" % spy.plain_on_card)
    check(spy.kernel_dtypes == {"float16"}, "the kernels' wrappers got "
          "%s on the float16 paths, want float16 alone"
          % sorted(spy.kernel_dtypes))
    inf, srv, tr = res["infer"], res["serve"], res["train"]
    print("f16 resnet: ResNet-50 v1 float16 eval forward at batch %d "
          "(hybridize, _CachedGraph): %d calls, epilogue launches %d, the "
          "eager forward's bits; %.3f ms a call graphed = %.1f images/s, "
          "%.3f ms eager; capture %.3f s; peak device memory %.2f GiB (%s)"
          % (F16_INFER_BATCH, inf["calls"], inf["launches"],
             inf["graphed_ms"], inf["images_per_s"], inf["eager_ms"],
             inf["capture_s"], inf["peak_bytes"] / 2 ** 30, card))
    if "profile" in inf:
        print_profiles([inf["profile"]], card)
    print("f16 serving: %d requests through a float16 AotModel, start %.2f "
          "s, dispatches per bucket %s, kernel launches %d, max rel err vs "
          "batch-1 %.3g; request latency p50 %.3f ms p99 %.3f ms; bucket-8 "
          "call %.3f ms = %.1f images/s; captures %s s (%s)"
          % (srv["requests"], srv["start_s"], srv["dispatches"],
             srv["launches"], srv["max_rel_err"], srv["p50_ms"],
             srv["p99_ms"], srv["bucket8_ms"], srv["bucket8_images_per_s"],
             {b: round(v, 3) for b, v in srv["capture_s"].items()}, card))
    print_graphed(tr, card)
    print("f16 resnet: training %.1f images/s graphed; %d float16 weights "
          "with float32 masters in the captured step (%s)"
          % (tr["images_per_s"], tr["masters"], card))
    fwd, st = bert["forward"], bert["step"]
    print("f16 bert: BERT-base float16 forward (MLM logits), %d x %d, "
          "hybridized: %d calls, launches (B, T, H, D) attention %d, "
          "LayerNorm %d; %.3f ms graphed = %.0f tokens/s, %.3f ms eager; "
          "capture %.3f s; peak device memory %.2f GiB (%s)"
          % (BERT_BATCH, BERT_SEQ, fwd["calls"], fwd["launches"][0],
             fwd["launches"][2], fwd["graphed_ms"], fwd["tokens_per_s"],
             fwd["eager_ms"], fwd["capture_s"], fwd["peak_bytes"] / 2 ** 30,
             card))
    if "profile" in fwd:
        print_profiles([fwd["profile"]], card)
    print_graphed(st, card)
    print("f16 bert: step %.0f tokens/s graphed; %d float16 weights with "
          "float32 masters in the captured step (%s)"
          % (st["tokens_per_s"], st["masters"], card))
    print("f16: plain versions called with a CUDA operand: %d; dtypes at "
          "the kernels' wrappers: %s" % (spy.plain_on_card,
                                         sorted(spy.kernel_dtypes)))
    return res, bert


# the float32 BERT-base path (f32_bert_phase): hybridized forwards each way
F32_BERT_CALLS = 13


def _attention_share(prof):
    """The device ms a call of the attention kernels in a profile, and
    their share of the device's busy time."""
    ms = sum(t for name, t, _ in prof["kernels"] if "flash_" in name)
    return {"attention_ms": ms, "busy_ms": prof["device_busy_ms"],
            "share": ms / prof["device_busy_ms"]}


def f32_bert_phase(torch, mx, attention, layernorm, seed, card,
                   profile=False):
    """BERT-base in float32 as bench.py's ``_build_bert_step(dtype=
    "float32")`` builds it (Xavier weights and deferred shapes on the host,
    ``reset_ctx`` onto the card), the fused LayerNorm route, TF32 off, at 24
    x 512 with bench.py's valid lengths and 76 masked positions a row: its
    MLM forward hybridized and replayed as a CUDA graph against the same
    forward eagerly, 12 (B, T, H, D) attention and 26 LayerNorm launches a
    forward; then its ``DataParallelStep`` without a mesh (Adam, lr 1e-4,
    float32 weights and state) graphed against eager, 12 + 12 attention and
    26 + 26 LayerNorm launches a step, the loss falling by BERT_LOSS_FALL
    over the graphed run's steps.  Under ``profile``, the share of the
    forward's and the step's device time that the float32 attention
    kernels take."""
    from mxnet_tpu_torch import gluon
    check(not (torch.backends.cuda.matmul.allow_tf32
               or torch.backends.cudnn.allow_tf32),
          "the float32 BERT phase runs with TF32 off")
    os.environ["MXNET_FUSED_LAYERNORM"] = "1"
    net, (x, vl, mp), y = _bench_bert(mx, seed, "float32")

    def counts(reset=False):
        if reset:
            _reset_counts(attention, layernorm)
        return _bert_counts(attention, layernorm)
    fwd = hybridized_calls(
        torch, mx, net, lambda: net(x, None, None, vl, mp)[1].astorch(),
        F32_BERT_CALLS, counts, "BERT-base float32 forward", profile=profile)
    logits = fwd.pop("last")
    check(logits.dtype == torch.float32
          and tuple(logits.shape) == (BERT_BATCH, BERT_PRED, BERT_VOCAB)
          and bool(torch.isfinite(logits).all()),
          "f32 BERT forward: %s %s" % (logits.dtype, tuple(logits.shape)))
    n = F32_BERT_CALLS
    fwd["launches"], bhtd = fwd["launches"]
    check(fwd["launches"] == (BERT_ATTN_PER_FWD * n, 0, BERT_LN_PER_FWD * n,
                              0) and bhtd == (0, 0),
          "f32 BERT forward launches in %d calls: (B, T, H, D) attention fwd "
          "%d bwd %d, LayerNorm fwd %d bwd %d (want %d and %d a forward), "
          "(B, H, T, D) %r" % ((n,) + fwd["launches"]
                               + (BERT_ATTN_PER_FWD, BERT_LN_PER_FWD, bhtd)))
    fwd["tokens_per_s"] = BERT_BATCH * BERT_SEQ * 1e3 / fwd["graphed_ms"]
    if "profile" in fwd:
        fwd["profile_kernels"] = _kernel_names_check(fwd["profile"],
                                                     "bert_f32_forward")
        fwd["attention"] = _attention_share(fwd["profile"])
    del logits
    net.hybridize(False)
    torch.cuda.empty_cache()

    step = graphed_vs_eager(
        torch, mx, net, lambda: mx.parallel.DataParallelStep(
            net, _mlm_loss(gluon),
            mx.optimizer.Adam(learning_rate=BERT_LR), mesh=None),
        (x, None, None, vl, mp), y, seed,
        "BERT-base float32 DataParallelStep, Adam",
        counts=lambda reset=False: counts(reset)[0],
        per_step=(BERT_ATTN_PER_STEP,) * 2 + (BERT_LN_PER_STEP,) * 2,
        profile_as="bert_f32" if profile else None)
    losses = step["losses_all"]
    check(min(losses[-LOSS_WINDOW:]) < losses[0] - BERT_LOSS_FALL,
          "f32 BERT step: loss did not fall by %g: %r"
          % (BERT_LOSS_FALL, losses))
    step["tokens_per_s"] = BERT_BATCH * BERT_SEQ * 1e3 / step["graphed_ms"]
    if "profile" in step:
        step["attention"] = _attention_share(step["profile"])
    del net
    del os.environ["MXNET_FUSED_LAYERNORM"]
    torch.cuda.empty_cache()
    return {"forward": fwd, "step": step}


def print_f32_bert(r, card):
    fwd, st = r["forward"], r["step"]
    print("f32 bert: BERT-base float32 forward (MLM logits), %d x %d, "
          "hybridized: %d calls, launches (B, T, H, D) attention %d, "
          "LayerNorm %d; %.3f ms graphed = %.0f tokens/s, %.3f ms eager; "
          "capture %s s; peak device memory %.2f GiB (%s)"
          % (BERT_BATCH, BERT_SEQ, fwd["calls"], fwd["launches"][0],
             fwd["launches"][2], fwd["graphed_ms"], fwd["tokens_per_s"],
             fwd["eager_ms"], fwd["capture_s"] and round(fwd["capture_s"], 3),
             fwd["peak_bytes"] / 2 ** 30, card))
    print("f32 bert: %s: %d steps through the CUDA graph and through the "
          "same body eagerly, Adam lr %g: same bits %s, losses %s; step "
          "%.3f ms graphed = %.0f tokens/s, %.3f ms eager (median of %d "
          "each); capture %s s; peak device memory %.2f GiB graphed, %.2f "
          "GiB eager; launches (B, T, H, D) attention fwd %d bwd %d, "
          "LayerNorm fwd %d bwd %d (%s)"
          % (st["what"], GRAPH_STEPS + GRAPH_TIMED, BERT_LR, st["same_bits"],
             [round(v, 4) for v in st["losses_all"]], st["graphed_ms"],
             st["tokens_per_s"], st["eager_ms"], GRAPH_TIMED,
             st["capture_s"] and round(st["capture_s"], 3),
             st["graphed_peak_bytes"] / 2 ** 30,
             st["eager_peak_bytes"] / 2 ** 30, *st["launches"], card))
    for what, p in (("forward", fwd), ("step", st)):
        if "profile" not in p:
            continue
        print_profiles([p["profile"]], card)
        a = p["attention"]
        print("f32 bert: the float32 attention kernels take %.3f ms of the "
              "%s's %.3f ms of device time (share %.3f) (%s)"
              % (a["attention_ms"], what, a["busy_ms"], a["share"], card))


# ---------------------------------------------------------------------------
# The layers, ops and blocks of ``ops/nn.py`` and ``gluon.nn`` on the card
# (``nn_layers_phase``): each op on card tensors against the same op on the
# port's CPU, forward and (where differentiable) backward of a seeded
# cotangent, max |card - CPU| within NN_RTOL of the CPU's largest magnitude
# (float32, TF32 off: cuDNN and the CPU sum windows, channels and rows in
# other orders; exact for integer outputs); then the op's device ms beside
# the plain torch call that computes the same thing, where there is one.
# Shapes are the zoo's: Inception v3's 35 x 35 maps for pooling,
# SqueezeNet's 111 x 111 for its ceil pooling, ResNet's first stage for the
# norms, LRN and the transposed convolutions, a 1000-class batch of 128 for
# the output ops.
NN_RTOL = 1e-4
NN_POOL = (32, 192, 35, 35)
NN_MAP = (32, 64, 56, 56)
NN_LOGITS = (128, 1000)
NN_SEQ = (64, 32, 768)


def nn_layer_cases(torch):
    """(name, op, inputs, attrs, indices of the inputs to differentiate,
    the plain torch call or None), inputs on the host from a seeded
    generator."""
    import torch.nn.functional as F
    g = torch.Generator().manual_seed(4321)

    def u(shape, lo=-1.0, hi=1.0):
        return torch.rand(shape, generator=g) * (hi - lo) + lo

    def labels(n, k, ignore=None):
        lab = torch.randint(0, k, (n,), generator=g).float()
        if ignore is not None:
            lab[::4] = ignore
        return lab
    x_pool, x_map, logits = u(NN_POOL), u(NN_MAP), u(NN_LOGITS, -3, 3)
    gamma, beta = u((64,), 0.5, 1.5), u((64,), -0.2, 0.2)
    lab, lab_ign = labels(128, 1000), labels(128, 1000, ignore=-1.0)
    w_t = u((64, 32, 3, 3), -0.1, 0.1)
    cases = [
        ("Pooling", "avg 3x3 s1 p1", [x_pool],
         dict(kernel=(3, 3), stride=(1, 1), pad=(1, 1), pool_type="avg",
              count_include_pad=True), (0,),
         lambda x: F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)),
        ("Pooling", "max 3x3 s2 full", [u((32, 64, 111, 111))],
         dict(kernel=(3, 3), stride=(2, 2), pool_type="max",
              pooling_convention="full"), (0,),
         lambda x: F.max_pool2d(x, 3, 2, ceil_mode=True)),
        ("Pooling", "avg 3x3 s2 p1 full, pad not counted", [x_pool],
         dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
              pooling_convention="full", count_include_pad=False), (0,),
         None),
        ("Pooling", "avg 3x3 s2 p2 full, pad above half", [x_pool],
         dict(kernel=(3, 3), stride=(2, 2), pad=(2, 2), pool_type="avg",
              pooling_convention="full"), (0,), None),
        ("Pooling", "max 2x2 s2 p2, pad above half", [x_pool],
         dict(kernel=(2, 2), stride=(2, 2), pad=(2, 2), pool_type="max"),
         (0,), None),
        ("Pooling", "sum 2x2 s2", [x_pool],
         dict(kernel=(2, 2), stride=(2, 2), pool_type="sum"), (0,), None),
        ("Pooling", "lp p=2 3x3 s2", [x_pool],
         dict(kernel=(3, 3), stride=(2, 2), pool_type="lp", p_value=2),
         (0,), lambda x: F.lp_pool2d(x, 2, 3, 2)),
        ("Pooling", "max int32 3x3 s2 p1 full",
         [torch.randint(-1000, 1000, NN_POOL, generator=g,
                        dtype=torch.int32)],
         dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max",
              pooling_convention="full"), (), None),
        ("Pooling_v1", "global sum", [x_pool],
         dict(global_pool=True, pool_type="sum"), (0,),
         lambda x: x.mean((2, 3), keepdim=True)),
        ("Deconvolution", "3x3 s2 p1 adj1 (conv_transpose)",
         [x_map, w_t, u((32,))],
         dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), adj=(1, 1),
              num_filter=32, no_bias=False), (0, 1, 2),
         lambda x, w, b: F.conv_transpose2d(x, w, b, 2, 1, 1)),
        ("Deconvolution", "3x3 s2 p1 adj2 (adj >= stride, composed)",
         [x_map, w_t],
         dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), adj=(2, 2),
              num_filter=32), (0, 1), None),
        ("UpSampling", "nearest x2", [x_map],
         dict(scale=2, sample_type="nearest"), (0,),
         lambda x: F.interpolate(x, scale_factor=2, mode="nearest")),
        ("UpSampling", "bilinear x2", [x_map],
         dict(scale=2, sample_type="bilinear"), (0,),
         lambda x: F.interpolate(x, scale_factor=2, mode="bilinear",
                                 align_corners=False)),
        ("GroupNorm", "8 groups", [x_map, gamma, beta],
         dict(num_groups=8, eps=1e-5), (0, 1, 2),
         lambda x, a, b: F.group_norm(x, 8, a, b, 1e-5)),
        ("InstanceNorm", "", [x_map, gamma, beta], dict(eps=1e-3), (0, 1, 2),
         lambda x, a, b: F.instance_norm(x, weight=a, bias=b, eps=1e-3)),
        ("LRN", "nsize 5", [x_map],
         dict(nsize=5, alpha=1e-4, beta=0.75, knorm=2.0), (0,),
         lambda x: F.local_response_norm(x, 5, 1e-4, 0.75, 2.0)),
        ("BatchNorm_v1", "training", [x_map, gamma, beta,
                                      torch.zeros(64), torch.ones(64)],
         dict(eps=1e-3, fix_gamma=False, training=True), (0, 1, 2),
         lambda x, a, b, m, v: F.batch_norm(x, None, None, a, b, True, 0.1,
                                            1e-3)),
        # on the card inside cross_rank_batch_stats of the NCCL group
        ("SyncBatchNorm", "one-rank NCCL group",
         [x_map, gamma, beta, torch.zeros(64), torch.ones(64)],
         dict(eps=1e-3, fix_gamma=False, training=True), (0, 1, 2),
         lambda x, a, b, m, v: F.batch_norm(x, None, None, a, b, True, 0.1,
                                            1e-3)),
        ("Convolution_v1", "3x3 p1", [x_map, u((64, 64, 3, 3), -0.1, 0.1)],
         dict(kernel=(3, 3), pad=(1, 1), num_filter=64, no_bias=True),
         (0, 1), lambda x, w: F.conv2d(x, w, None, 1, 1)),
        ("log_softmax", "", [logits], {}, (0,),
         lambda x: F.log_softmax(x, -1)),
        ("softmin", "", [logits], {}, (0,), lambda x: F.softmin(x, -1)),
        ("SoftmaxActivation", "channel", [x_map], dict(mode="channel"),
         (0,), lambda x: torch.softmax(x, 1)),
        ("SoftmaxActivation", "instance", [logits], {}, (0,),
         lambda x: torch.softmax(x, -1)),
        ("SoftmaxOutput", "normalization null", [logits, lab], {}, (0,),
         lambda x, y: torch.softmax(x, -1)),
        ("SVMOutput", "L2", [logits, lab], dict(margin=1.0), (0,), None),
        ("SVMOutput", "L1", [logits, lab], dict(use_linear=True), (0,),
         None),
        ("IdentityAttachKLSparseReg", "", [u(NN_LOGITS, 0.0, 1.0),
                                           u((1000,), 0.1, 0.9)],
         dict(sparseness_target=0.1, penalty=1e-3, momentum=0.9), (0,),
         None),
        ("softmax_cross_entropy", "", [logits, lab], {}, (0,),
         lambda x, y: F.cross_entropy(x, y.long(), reduction="sum")),
        ("LinearRegressionOutput", "", [logits, logits], {}, (0,), None),
        ("MAERegressionOutput", "", [logits, logits], {}, (0,), None),
        ("LogisticRegressionOutput", "", [logits, logits], {}, (0,),
         lambda x, y: torch.sigmoid(x)),
        ("SequenceMask", "axis 0", [u(NN_SEQ), torch.randint(
            0, 65, (32,), generator=g).float()],
         dict(use_sequence_length=True, value=-1.0), (0,), None),
        ("SequenceReverse", "", [u(NN_SEQ), torch.randint(
            0, 65, (32,), generator=g).float()],
         dict(use_sequence_length=True), (0,), None),
        ("SliceChannel", "3 parts", [x_pool], dict(num_outputs=3), (0,),
         lambda x: torch.split(x, x.shape[1] // 3, 1)),
    ]
    # SoftmaxOutput's custom backward with ignore_label and each
    # normalization
    for norm in ("null", "batch", "valid"):
        cases.append(("SoftmaxOutput", "ignore_label -1, %s" % norm,
                      [logits, lab_ign],
                      dict(use_ignore=True, ignore_label=-1.0,
                           normalization=norm, grad_scale=2.0), (0,), None))
    cases.append(("SoftmaxOutput", "smooth_alpha 0.1, valid",
                  [logits, lab_ign],
                  dict(use_ignore=True, normalization="valid",
                       smooth_alpha=0.1), (0,), None))
    return cases


def _nn_rel_err(torch, got, want, what):
    """max |got - want| over the largest |want| (exact for integers), NaN
    where both are NaN."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          "%s: card %s %s, CPU %s %s" % (what, tuple(got.shape), got.dtype,
                                         tuple(want.shape), want.dtype))
    got = got.detach().cpu()
    if not want.is_floating_point():
        check(torch.equal(got, want), "%s: integer results differ" % what)
        return 0.0
    nan = torch.isnan(want)
    check(torch.equal(torch.isnan(got), nan), "%s: NaN in other places"
          % what)
    g, w = got[~nan].double(), want[~nan].double()
    finite = torch.isfinite(w)
    check(torch.equal(g[~finite], w[~finite]), "%s: infinities differ"
          % what)
    err = float((g[finite] - w[finite]).abs().max()) if finite.any() else 0.0
    rel = err / max(float(w[finite].abs().max()), 1e-30)
    check(rel <= NN_RTOL, "%s: card vs CPU rel err %.3g > %g"
          % (what, rel, NN_RTOL))
    return rel


def nn_layers_phase(torch, mx, seed, card, group):
    """Every case of ``nn_layer_cases`` on the card against the port's CPU,
    forward and backward, and the card's device ms beside the plain torch
    call's; ``SyncBatchNorm`` on the card inside ``cross_rank_batch_stats``
    of ``group`` (the one-rank NCCL group), its statistics all-reduced
    there (the all-reduces counted), against the CPU's local BatchNorm."""
    import torch.distributed as dist
    from mxnet_tpu_torch.ops.nn import cross_rank_batch_stats
    from mxnet_tpu_torch.ops.registry import get_op
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    gen = torch.Generator().manual_seed(seed + 77)
    reduces = [0]
    all_reduce = dist.all_reduce

    def counted(*args, **kwargs):
        reduces[0] += 1
        return all_reduce(*args, **kwargs)
    rows = []
    for name, label, inputs, kw, diff, plain in nn_layer_cases(torch):
        fn = get_op(name).fn
        what = "%s %s %s" % (name, label, tuple(inputs[0].shape))
        on_card = [t.cuda() for t in inputs]
        leaves = {}
        for side, ins in (("cpu", inputs), ("card", on_card)):
            ins = [t.clone().requires_grad_(i in diff) for i, t in
                   enumerate(ins)]
            if side == "card" and name == "SyncBatchNorm":
                dist.all_reduce = counted
                try:
                    with cross_rank_batch_stats(group, 1):
                        out = fn(*ins, **kw)
                finally:
                    dist.all_reduce = all_reduce
            else:
                out = fn(*ins, **kw)
            outs = list(out) if isinstance(out, (tuple, list)) else [out]
            leaves[side] = (ins, outs)
        (c_in, c_out), (g_in, g_out) = leaves["cpu"], leaves["card"]
        fwd = max(_nn_rel_err(torch, a, b.detach(), what + " out %d" % i)
                  for i, (a, b) in enumerate(zip(g_out, c_out)))
        bwd = None
        if diff:
            keep = [i for i, o in enumerate(c_out) if o.requires_grad]
            cts = [torch.randn(c_out[i].shape, generator=gen) for i in keep]
            if name == "SyncBatchNorm":
                dist.all_reduce = counted
            try:
                g_grads = torch.autograd.grad(
                    [g_out[i] for i in keep], [g_in[i] for i in diff],
                    [c.cuda() for c in cts])
            finally:
                dist.all_reduce = all_reduce
            c_grads = torch.autograd.grad(
                [c_out[i] for i in keep], [c_in[i] for i in diff], cts)
            bwd = max(_nn_rel_err(torch, a, b, what + " grad %d" % i)
                      for i, a, b in zip(diff, g_grads, c_grads))
        ins = [t.detach() for t in g_in]
        with torch.no_grad():
            if name == "SyncBatchNorm":
                with cross_rank_batch_stats(group, 1):
                    ms = time_cuda(torch, lambda: fn(*ins, **kw), flush)
            else:
                ms = time_cuda(torch, lambda: fn(*ins, **kw), flush)
            plain_ms = time_cuda(torch, lambda: plain(*ins), flush) \
                if plain is not None else None
        rows.append({"op": name, "case": label,
                     "shape": list(inputs[0].shape), "fwd_rel_err": fwd,
                     "bwd_rel_err": bwd, "ms": ms, "plain_ms": plain_ms})
        print("nn %-26s %-40s %-20s fwd err %.3g  bwd err %s  card %.4f ms"
              "  plain torch %s  (%s)"
              % (name, label, tuple(inputs[0].shape), fwd,
                 "-" if bwd is None else "%.3g" % bwd, ms,
                 "-" if plain_ms is None else "%.4f ms" % plain_ms, card))
        del leaves, c_in, c_out, g_in, g_out, on_card, ins
    check(reduces[0] >= 2, "SyncBatchNorm: %d all-reduces on the NCCL group "
          "(want the forward's and the backward's)" % reduces[0])
    names = {r["op"] for r in rows}
    del flush
    torch.cuda.empty_cache()
    return {"rows": rows, "ops": sorted(names), "sync_all_reduces":
            reduces[0]}


# ---------------------------------------------------------------------------
# The vision model zoo on the card (``vision_zoo_phase``), float32 with TF32
# off:
# (a) every family at full width, one hybridized eval forward at batch 2
#     on the card against the same net's forward on the CPU from the same
#     weights (Xavier, random BatchNorm statistics and affine), the logits
#     within ZOO_PARITY_RTOL of the CPU's largest;
# (b) the reference's published single-card inference configurations
#     (``BASELINE.md``, from MXNet's ``docs/faq/perf.md``): Inception v3 at
#     batch 128 (299 x 299), VGG-16 at batch 32 and ResNet-152 v1 at batch
#     128, each as ``bench.py:bench_inference`` builds a net (Xavier and
#     deferred shapes on the host, ``reset_ctx`` onto the card,
#     ``hybridize()``), ZOO_CALLS eager then graphed calls
#     (``hybridized_calls``), ResNet-152 v1 with its 50 epilogue launches a
#     forward;
# (c) Inception v3 trained at batch 128 through ``DataParallelStep`` with
#     ``train_imagenet.py``'s SGD (lr 0.1, momentum 0.9, wd 1e-4),
#     ZOO_TRAIN_STEPS steps graphed against as many eager (its dropout draws
#     other masks in a replay, so the two runs are not held to the same
#     bits), the loss falling as the ResNet phase's must; and one SGD step
#     of the dropout-free ResNet-50 v2 at batch 2 on the card against the
#     CPU, held as the ResNet-50 v1 step is (``card_vs_cpu_step``).
ZOO_PARITY = ("resnet50_v2", "vgg16_bn", "alexnet", "squeezenet1.1",
              "densenet121", "inceptionv3", "mobilenet1.0",
              "mobilenetv2_1.0")
ZOO_PARITY_RTOL = PARITY_LOSS_RTOL
ZOO_INFER = (("inceptionv3", 128, 299), ("vgg16", 32, 224),
             ("resnet152_v1", 128, 224))
ZOO_CALLS = 8
ZOO_TRAIN = ("inceptionv3", 128, 299)
ZOO_TRAIN_STEPS = 13
ZOO_STEP_PARITY = "resnet50_v2"
# ResNet-152 v1: one BN -> add -> ReLU epilogue a bottleneck, at batch 128
RESNET152_UNITS = (3, 8, 36, 3)
RESNET152_EPILOGUES = sum(RESNET152_UNITS)
INFER152_SHAPES = [((128,) + chw, n) for (chw, _), n
                   in zip(STAGES, RESNET152_UNITS)]


def _image_size(name):
    return 299 if name.startswith("inception") else 224


def _host_net(mx, name, seed, size, **kwargs):
    """``name`` from ``vision.get_model`` with Xavier weights from
    ``seed`` and its deferred shapes settled on the host."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    mx.random.seed(seed)
    net = vision.get_model(name, **kwargs)
    with mx.cpu():
        net.initialize(mx.init.Xavier())
        with mx.autograd.predict_mode():
            net(mx.nd.zeros((1, 3, size, size)))
    return net


def zoo_card_vs_cpu(torch, mx, fused_norm, seed):
    """(a): each family's eval logits at batch 2, hybridized on the card
    (the second call, a replay) against the CPU; no epilogue launch."""
    import numpy as onp
    out = {}
    for i, name in enumerate(ZOO_PARITY):
        size = _image_size(name)
        net = _host_net(mx, name, seed + i, size)
        rs = onp.random.RandomState(seed + i)
        for k, p in net._collect_params_with_prefix().items():
            if k.endswith(("running_mean", "beta")):
                p.set_data(rs.uniform(-0.2, 0.2, p.shape).astype("float32"))
            elif k.endswith(("running_var", "gamma")):
                p.set_data(rs.uniform(0.5, 1.5, p.shape).astype("float32"))
        x = rs.uniform(-1, 1, (PARITY_BATCH, 3, size, size)).astype("float32")
        t0 = time.perf_counter()
        with mx.cpu(), mx.autograd.predict_mode():
            want = net(mx.nd.array(x)).asnumpy()
        cpu_s = time.perf_counter() - t0
        net.collect_params().reset_ctx(mx.gpu(0))
        net.hybridize()
        fused_norm.LAUNCHES = 0
        xg = mx.nd.array(x, ctx=mx.gpu(0))
        with mx.autograd.predict_mode():
            net(xg)
            got = net(xg).asnumpy()
        graphed = [e[0].graphed for e, _ in net._cached_graph._cache.values()]
        err = float(onp.abs(got - want).max() / onp.abs(want).max())
        out[name] = {"rel_err": err, "graphed": graphed, "cpu_s": cpu_s,
                     "launches": fused_norm.LAUNCHES}
        print("zoo: %s at batch %d, %dx%d, card (hybridized, a replay) vs "
              "CPU eval logits: max rel err %.3g (CPU forward %.2f s)"
              % (name, PARITY_BATCH, size, size, err, cpu_s))
        check(onp.isfinite(got).all() and err <= ZOO_PARITY_RTOL,
              "zoo %s: card vs CPU logits rel err %.3g > %g"
              % (name, err, ZOO_PARITY_RTOL))
        check(graphed == [True], "zoo %s: not captured (%r)" % (name, graphed))
        check(fused_norm.LAUNCHES == 0, "zoo %s: %d epilogue launches"
              % (name, fused_norm.LAUNCHES))
        del net
        torch.cuda.empty_cache()
    return out


def zoo_inference(torch, mx, fused_norm, seed, profile=False):
    """(b): each of ZOO_INFER hybridized, eager and graphed, its images/s,
    capture seconds and peak memory; ResNet-152 v1's epilogue launches
    counted (50 a forward), the others' 0."""
    import numpy as onp
    out = {}
    for name, batch, size in ZOO_INFER:
        net = _host_net(mx, name, seed, size)
        net.collect_params().reset_ctx(mx.gpu(0))
        rs = onp.random.RandomState(seed)
        x = mx.nd.array(rs.uniform(size=(batch, 3, size, size))
                        .astype("float32"), ctx=mx.gpu(0))
        what = "%s forward, batch %d, %dx%d" % (name, batch, size, size)
        r = hybridized_calls(torch, mx, net, lambda: net(x).astorch(),
                             ZOO_CALLS, _epilogue_counts(fused_norm), what,
                             profile=profile)
        logits = r.pop("last")
        check(tuple(logits.shape) == (batch, 1000)
              and bool(torch.isfinite(logits).all()),
              "%s: logits %s, finite %s" % (what, tuple(logits.shape),
                                           bool(torch.isfinite(logits).all())))
        want = RESNET152_EPILOGUES * ZOO_CALLS if name == "resnet152_v1" \
            else 0
        r["launches"] = r["launches"][0]
        check(r["launches"] == want, "%s: %d epilogue launches in %d graphed "
              "calls (want %d)" % (what, r["launches"], ZOO_CALLS, want))
        r.update(batch=batch, size=size,
                 images_per_s=batch * 1e3 / r["graphed_ms"],
                 eager_images_per_s=batch * 1e3 / r["eager_ms"])
        out[name] = r
        del net, x, logits
        torch.cuda.empty_cache()
    return out


def zoo_training(torch, mx, fused_norm, seed, profile=False):
    """(c): Inception v3's DataParallelStep at batch 128, graphed against
    eager; then ResNet-50 v2's step at batch 2 on the card against the
    CPU."""
    import numpy as onp
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.model_zoo import vision
    name, batch, size = ZOO_TRAIN
    net = _host_net(mx, name, seed, size)
    net.collect_params().reset_ctx(mx.gpu(0))
    rs = onp.random.RandomState(seed)
    x = mx.nd.array(rs.uniform(-1, 1, (batch, 3, size, size))
                    .astype("float32"), ctx=mx.gpu(0))
    y = mx.nd.array(rs.randint(0, 1000, (batch,)).astype("float32"),
                    ctx=mx.gpu(0))
    sgd = {"momentum": 0.9, "wd": 1e-4}
    step = graphed_vs_eager(
        torch, mx, net, lambda: mx.parallel.DataParallelStep(
            net, gluon.loss.SoftmaxCrossEntropyLoss(),
            _scheduled(mx, mx.optimizer.SGD, 0.1, **sgd), mesh=None),
        x, y, seed, "Inception v3 DataParallelStep, batch %d, SGD" % batch,
        counts=_epilogue_counts(fused_norm), per_step=(0, 0),
        profile_as="zoo_step" if profile else None,
        timed=ZOO_TRAIN_STEPS - GRAPH_STEPS, exact=False)
    losses = step["losses_all"]
    check(len(losses) == ZOO_TRAIN_STEPS
          and all(onp.isfinite(losses)), "Inception steps: %r" % losses)
    check(min(losses[-LOSS_WINDOW:]) < LOSS_DROP * losses[0],
          "Inception v3: the loss did not fall: %r" % losses)
    step.update(batch=batch, steps=len(losses),
                images_per_s=batch * 1e3 / step["graphed_ms"],
                eager_images_per_s=batch * 1e3 / step["eager_ms"])
    del net, x, y
    torch.cuda.empty_cache()

    # the dropout-free family's step, card against CPU
    net = _host_net(mx, ZOO_STEP_PARITY, seed, IMAGE_SIZE)
    net.collect_params().reset_ctx(mx.gpu(0))
    w0 = _param_arrays(net)
    data = rs.uniform(-1, 1, (PARITY_BATCH, 3, IMAGE_SIZE, IMAGE_SIZE)) \
        .astype("float32")
    label = rs.randint(0, 1000, PARITY_BATCH).astype("float32")
    t0 = time.perf_counter()
    loss_rel, (update_rel, per_param), (floor_rel, floor_param) = \
        card_vs_cpu_step(torch, mx, net, w0, data, label,
                         make_net=getattr(vision, ZOO_STEP_PARITY))
    parity = {"loss_rel": loss_rel, "update_rel_l2": update_rel,
              "worst": per_param[:4], "floor_rel_l2": floor_rel,
              "floor_worst": floor_param[:4],
              "s": time.perf_counter() - t0}
    check(loss_rel <= PARITY_LOSS_RTOL, "%s card vs CPU loss rel err %.3g > "
          "%g" % (ZOO_STEP_PARITY, loss_rel, PARITY_LOSS_RTOL))
    check(update_rel <= PARITY_UPDATE_REL_L2, "%s card vs CPU update: rel L2 "
          "err %.3g > %g" % (ZOO_STEP_PARITY, update_rel,
                             PARITY_UPDATE_REL_L2))
    check(per_param[0][0] <= PARITY_PARAM_REL_L2, "%s card vs CPU update of "
          "%s: rel L2 err %.3g > %g" % (ZOO_STEP_PARITY, per_param[0][1],
                                        per_param[0][0],
                                        PARITY_PARAM_REL_L2))
    del net
    torch.cuda.empty_cache()
    return step, parity


def vision_zoo_phase(torch, mx, fused_norm, layernorm, seed, card,
                     profile=False):
    """(a), (b) and (c) under ``_PlainOnCard`` (no plain version may get a
    CUDA operand; only float32 reaches the kernels' wrappers); prints
    their lines and returns their numbers."""
    with _PlainOnCard(fused_norm, layernorm) as spy:
        parity = zoo_card_vs_cpu(torch, mx, fused_norm, seed)
        infer = zoo_inference(torch, mx, fused_norm, seed, profile=profile)
        train, step_parity = zoo_training(torch, mx, fused_norm, seed,
                                          profile=profile)
    check(spy.plain_on_card == 0, "%d calls of a plain version with a CUDA "
          "operand on the vision zoo paths" % spy.plain_on_card)
    check(spy.kernel_dtypes == {"float32"}, "the kernels' wrappers got %s "
          "on the vision zoo paths, want float32 alone"
          % sorted(spy.kernel_dtypes))
    for name, r in infer.items():
        print("zoo: %s eval forward at batch %d, %dx%d (hybridize, "
              "_CachedGraph): %d calls, epilogue launches %d, the eager "
              "forward's bits; %.3f ms a call graphed = %.1f images/s, %.3f "
              "ms eager = %.1f images/s; capture %.3f s; peak device memory "
              "%.2f GiB (%s)"
              % (name, r["batch"], r["size"], r["size"], r["calls"],
                 r["launches"], r["graphed_ms"], r["images_per_s"],
                 r["eager_ms"], r["eager_images_per_s"], r["capture_s"],
                 r["peak_bytes"] / 2 ** 30, card))
        if "profile" in r:
            print_profiles([r["profile"]], card)
    print("zoo: %s: %d steps through the CUDA graph and %d through the same "
          "body eagerly from the same weights and seed, rate x%g a step; "
          "losses graphed %s, eager %s (same bits: %s); step %.3f ms graphed "
          "= %.1f images/s, %.3f ms eager = %.1f images/s (median of %d "
          "each); capture %.3f s; peak device memory %.2f GiB graphed, %.2f "
          "GiB eager (%s)"
          % (train["what"], train["steps"], train["steps"], GRAPH_LR_FACTOR,
             [round(v, 4) for v in train["losses_all"]],
             [round(v, 4) for v in train["eager_losses_all"]],
             train["same_bits"], train["graphed_ms"], train["images_per_s"],
             train["eager_ms"], train["eager_images_per_s"],
             ZOO_TRAIN_STEPS - GRAPH_STEPS, train["capture_s"],
             train["graphed_peak_bytes"] / 2 ** 30,
             train["eager_peak_bytes"] / 2 ** 30, card))
    if "profile" in train:
        print_profiles([train["profile"]], card)
    p = step_parity
    print("zoo: %s card vs CPU, one SGD step at batch %d: loss rel err %.3g, "
          "update rel L2 err %.3g over all parameters; worst parameters %s; "
          "floor (CPU on 1 thread vs N) %.3g, worst %s (%.1f s)"
          % (ZOO_STEP_PARITY, PARITY_BATCH, p["loss_rel"], p["update_rel_l2"],
             ", ".join("%s %.3g" % (k, e) for e, k in p["worst"]),
             p["floor_rel_l2"],
             ", ".join("%s %.3g" % (k, e) for e, k in p["floor_worst"]),
             p["s"]))
    print("zoo: plain versions called with a CUDA operand: %d; dtypes at the "
          "kernels' wrappers: %s" % (spy.plain_on_card,
                                     sorted(spy.kernel_dtypes)))
    return {"parity": parity, "infer": infer, "train": train,
            "step_parity": step_parity}


# ---------------------------------------------------------------------------
# the rest of training: AdamW in BERT-base's DataParallelStep,
# ResNet-50 v1 through Estimator.fit fed by DataLoader workers, and every
# new optimizer rule, loss and metric on the card against the CPU
# ---------------------------------------------------------------------------

ADAMW_PARAMS = {"learning_rate": BERT_LR, "wd": 0.01}
EST_BATCH = TRAIN_BATCH
EST_BATCHES = 4                     # an epoch
EST_EPOCHS = 2
EST_WORKERS = 2
EST_MEAN, EST_STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
EST_NADAM = {"learning_rate": 1e-3}
# each new rule's options on the card; one Trainer.step over ResNet-50
# v1's parameters from the same weights and gradients as on the CPU
RULES = [("signum", {"learning_rate": 0.01, "momentum": 0.9, "wd_lh": 1e-4}),
         ("ftml", {"learning_rate": 0.01, "wd": 1e-4}),
         ("lbsgd", {"learning_rate": 0.1, "momentum": 0.9,
                    "warmup_epochs": 1, "updates_per_epoch": 2,
                    "batch_scale": 4}),
         ("dcasgd", {"learning_rate": 0.1, "momentum": 0.9}),
         ("sgld", {"learning_rate": 1e-4}),
         ("adamw", {"learning_rate": 1e-3, "wd": 0.01}),
         ("adagrad", {"learning_rate": 0.01, "wd": 1e-4}),
         ("rmsprop", {"learning_rate": 1e-3, "centered": True,
                      "clip_weights": 1.0}),
         ("adadelta", {"wd": 1e-4}),
         ("ftrl", {"learning_rate": 0.1}),
         ("adamax", {"wd": 1e-4}),
         ("nadam", {"learning_rate": 1e-3}),
         ("test", {})]
RULE_UPDATE_REL_L2 = 1e-5           # card vs CPU, over all parameters
SGLD_SE = 5.0                       # the noise's mean within 5 s.e.
SGLD_STD_RTOL = 1e-3
LOSS_ROWS, LOSS_CLASSES = 32, 1000
CTC_T, CTC_N, CTC_C, CTC_L = 100, 32, 28, 20
LOSS_RTOL = 1e-5                    # card vs CPU, loss values
LOSS_GRAD_REL_L2 = 1e-5             # card vs CPU, input gradients
# CTC's gradient runs back through 100 log-sum-exp steps, each an exp and
# a log that round otherwise on the card (1.02e-5 in a card run)
CTC_GRAD_REL_L2 = 1e-4


def adamw_bert_phase(torch, mx, attention, layernorm, seed, card, mesh):
    """BERT-base pretraining through ``DataParallelStep`` with
    ``AdamW(learning_rate=1e-4, wd=0.01)``, built as bench.py's
    ``_build_bert_step`` (bf16, 24 x 512, ``MXNET_FUSED_LAYERNORM=1``):
    one f32 step of a 2-layer BERT on the card against the CPU; 13 steps
    without a mesh and 13 from the same weights on the one-rank NCCL mesh
    with ``shard_optimizer=True`` (ZeRO), the same bits, the loss falling
    and Adam's launches a step; then the step through its CUDA graph
    against the same body eagerly, the same bits, under a schedule."""
    import numpy as onp
    from mxnet_tpu_torch import gluon
    os.environ["MXNET_FUSED_LAYERNORM"] = "1"
    loss_rel, (update_rel, per_param), (floor_rel, _) = dp_bert_card_vs_cpu(
        torch, mx, seed, make_opt=lambda: mx.optimizer.AdamW(**ADAMW_PARAMS))
    print("adamw bert: card vs CPU, one f32 AdamW DataParallelStep of a "
          "%d-layer BERT at batch 2, S %d: loss rel err %.3g, update rel L2 "
          "err %.3g (floor, CPU on 1 thread: %.3g); worst parameters %s"
          % (DP_PARITY_LAYERS, BERT_PARITY_SEQ, loss_rel, update_rel,
             floor_rel, ", ".join("%s %.3g" % (k, e)
                                  for e, k in per_param[:4])))
    check(loss_rel <= BERT_TRAIN_PARITY_LOSS_RTOL,
          "AdamW BERT card vs CPU loss rel err %.3g > %g"
          % (loss_rel, BERT_TRAIN_PARITY_LOSS_RTOL))
    check(update_rel <= BERT_TRAIN_PARITY_UPDATE_REL_L2,
          "AdamW BERT card vs CPU update: rel L2 err %.3g > %g"
          % (update_rel, BERT_TRAIN_PARITY_UPDATE_REL_L2))
    check(per_param[0][0] <= BERT_TRAIN_PARITY_PARAM_REL_L2,
          "AdamW BERT card vs CPU update of %s: rel L2 err %.3g > %g"
          % (per_param[0][1], per_param[0][0],
             BERT_TRAIN_PARITY_PARAM_REL_L2))
    tokens, lens, pos = bert_inputs(seed)
    labels = onp.random.RandomState(seed + 2).randint(
        0, BERT_VOCAB, (BERT_BATCH, BERT_PRED)).astype("float32")
    gpu = mx.gpu(0)
    data = (mx.nd.array(tokens, ctx=gpu), None, None,
            mx.nd.array(lens, ctx=gpu, dtype="int32"),
            mx.nd.array(pos, ctx=gpu, dtype="int32"))
    y = mx.nd.array(labels, ctx=gpu)
    net = _bench_bert_bf16(mx, seed, tokens)
    params = sorted(net.collect_params().items())
    w0 = [p.data().astorch().clone() for _, p in params]
    per_step = (BERT_ATTN_PER_STEP,) * 2 + (BERT_LN_PER_STEP,) * 2
    runs = {}
    for name, m, shard in (("plain", None, False), ("zero", mesh, True)):
        for (_, p), w in zip(params, w0):
            p.set_data(w)
        step = mx.parallel.DataParallelStep(
            net, _mlm_loss(gluon), mx.optimizer.AdamW(**ADAMW_PARAMS),
            mesh=m, shard_optimizer=shard)
        torch.cuda.synchronize()
        # the main path: counts from 0 just before, read just after
        _reset_counts(attention, layernorm)
        losses, times = [], []
        for _ in range(BERT_TRAIN_WARMUP + BERT_TRAIN_TIMED):
            t = time.perf_counter()
            losses.append(step(data, y).astorch())
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        n = len(losses)
        counts = _bert_counts(attention, layernorm)
        check(counts[0] == tuple(c * n for c in per_step)
              and counts[1] == (0, 0),
              "AdamW DP BERT (%s): launches %r, (B, H, T, D) %r in %d steps,"
              " want %r a step" % (name, counts[0], counts[1], n, per_step))
        runs[name] = {
            "losses": [float(v.float()) for v in losses],
            "loss_bits": torch.stack(losses),
            "weights": [p.data().astorch().clone() for _, p in params],
            "step_ms": statistics.median(times[BERT_TRAIN_WARMUP:]) * 1e3,
            "launches": counts[0], "steps": n,
            "state_bytes": step.optimizer_state_bytes(per_chip=True)}
        del step
        torch.cuda.empty_cache()
    plain, zero = runs["plain"], runs["zero"]
    check(torch.equal(plain["loss_bits"], zero["loss_bits"])
          and all(torch.equal(a, b) for a, b in zip(plain["weights"],
                                                    zero["weights"])),
          "AdamW: the one-rank NCCL ZeRO steps and the steps without a "
          "mesh differ")
    for run in (plain, zero):
        losses = run["losses"]
        check(all(onp.isfinite(losses)), "AdamW DP loss %r" % losses)
        check(min(losses[-LOSS_WINDOW:]) < losses[0] - BERT_LOSS_FALL,
              "AdamW DP loss did not fall by %g: %r"
              % (BERT_LOSS_FALL, losses))
        del run["weights"], run["loss_bits"]
    for (_, p), w in zip(params, w0):
        p.set_data(w)
    del w0

    def counts(reset=False):
        if reset:
            _reset_counts(attention, layernorm)
        return _bert_counts(attention, layernorm)[0]
    graph = graphed_vs_eager(
        torch, mx, net, lambda: mx.parallel.DataParallelStep(
            net, _mlm_loss(gluon), _scheduled(
                mx, mx.optimizer.AdamW, BERT_LR, wd=ADAMW_PARAMS["wd"])),
        data, y, seed, "BERT-base AdamW DataParallelStep, no mesh",
        counts=counts, per_step=per_step)
    del net
    torch.cuda.empty_cache()
    del os.environ["MXNET_FUSED_LAYERNORM"]
    return {"plain": plain, "zero": zero, "graph": graph,
            "parity_loss_rel": loss_rel, "parity_update_rel_l2": update_rel,
            "parity_floor_rel_l2": floor_rel,
            "launches": tuple(a + b for a, b in zip(plain["launches"],
                                                    zero["launches"]))}


def _synthetic_images(seed, n):
    import numpy as onp
    rs = onp.random.RandomState(seed + 16)
    return (rs.randint(0, 256, (n, IMAGE_SIZE, IMAGE_SIZE, 3))
            .astype("uint8"), rs.randint(0, 1000, n).astype("float32"))


def estimator_phase(torch, mx, fused_norm, seed, card):
    """ResNet-50 v1 (config 2's model, a softmax on its logits so that
    the CrossEntropy metric reads probabilities, the loss their negative
    log) trained by ``Estimator.fit`` for 2 epochs of 4 batches of 32 with
    ``Trainer(..., "nadam")``, fed by a ``DataLoader`` with 2 worker
    processes over an ``ArrayDataset`` of synthetic uint8 224 x 224
    images whose first element goes through ``Compose([
    RandomFlipLeftRight(), ToTensor(), Normalize(...)])``; Accuracy,
    TopKAccuracy(5) and CrossEntropy, ``CheckpointHandler`` into a
    temporary directory and ``EarlyStoppingHandler``.  Checks that the
    loss falls, 16 + 16 epilogue launches a step, and that the last
    checkpoint's parameters and states read back."""
    import tempfile

    import numpy as onp
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.contrib import estimator as est_mod
    from mxnet_tpu_torch.gluon.data.vision import transforms as T
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1

    class _ProbNLL(gluon.loss.Loss):
        """``-log(p[label])`` of the softmax's probabilities, a value a
        sample."""

        def __init__(self):
            super().__init__(weight=None, batch_axis=0)
            self._ce = gluon.loss.SoftmaxCrossEntropyLoss(from_logits=True)

        def hybrid_forward(self, F, p, label):
            return self._ce(F.log(p + 1e-12), label)

    class _Clock(est_mod.EpochBegin, est_mod.BatchBegin, est_mod.BatchEnd):
        """The loop's wait for each batch (from the end of the previous
        step, or of the epoch's start, to the batch's start) and each
        step's time, the card synchronized at its end; each step's mean
        loss."""
        priority = 0

        def __init__(self):
            self.waits, self.steps, self.losses = [], [], []
            self._mark = None

        def epoch_begin(self, estimator, *args, **kwargs):
            torch.cuda.synchronize()
            self._mark = time.perf_counter()

        def batch_begin(self, estimator, *args, **kwargs):
            now = time.perf_counter()
            self.waits.append(now - self._mark)
            self._mark = now

        def batch_end(self, estimator, *args, **kwargs):
            self.losses.append(float(kwargs["loss"][0].mean().asscalar()))
            torch.cuda.synchronize()
            now = time.perf_counter()
            self.steps.append(now - self._mark)
            self._mark = now

    n = EST_BATCH * EST_BATCHES
    images, labels = _synthetic_images(seed, n)
    mx.random.seed(seed)
    net = gluon.nn.HybridSequential(prefix="est_")
    with net.name_scope():
        net.add(resnet50_v1(), gluon.nn.HybridLambda(
            lambda F, x: F.softmax(x)))
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    with mx.autograd.predict_mode():
        net(mx.nd.zeros((1, 3, IMAGE_SIZE, IMAGE_SIZE), ctx=mx.gpu(0)))
    dataset = gluon.data.ArrayDataset(images, labels).transform_first(
        T.Compose([T.RandomFlipLeftRight(), T.ToTensor(),
                   T.Normalize(EST_MEAN, EST_STD)]))
    loader = gluon.data.DataLoader(dataset, batch_size=EST_BATCH,
                                   shuffle=True, num_workers=EST_WORKERS)
    check(loader._pool is not None, "the DataLoader fell back to threads")
    acc, top5 = mx.metric.Accuracy(), mx.metric.TopKAccuracy(5)
    ce = mx.metric.CrossEntropy()
    trainer = gluon.Trainer(net.collect_params(), "nadam", dict(EST_NADAM))
    est = est_mod.Estimator(net, loss=_ProbNLL(), metrics=[acc, top5, ce],
                            trainer=trainer, context=mx.gpu(0))
    clock = _Clock()
    tmp = tempfile.mkdtemp(prefix="est-ckpt-")
    ckpt = est_mod.CheckpointHandler(tmp, model_prefix="resnet50",
                                     max_checkpoints=2)
    early = est_mod.EarlyStoppingHandler(monitor=ce, patience=EST_EPOCHS)
    try:
        # the main path: counts from 0 just before, read just after
        fused_norm.LAUNCHES = fused_norm.BWD_LAUNCHES = 0
        t0 = time.perf_counter()
        est.fit(loader, epochs=EST_EPOCHS,
                event_handlers=[ckpt, early, clock])
        fit_s = time.perf_counter() - t0
        launches = (fused_norm.LAUNCHES, fused_norm.BWD_LAUNCHES)
        loader.close()
        steps = len(clock.steps)
        check(steps == EST_EPOCHS * EST_BATCHES and not early.stop_training,
              "Estimator.fit ran %d steps, early stop %s"
              % (steps, early.stop_training))
        check(launches == (16 * steps, 16 * steps),
              "Estimator: epilogue launches %r in %d steps, want 16 and 16 "
              "a step" % (launches, steps))
        losses = clock.losses
        first = sum(losses[:EST_BATCHES]) / EST_BATCHES
        second = sum(losses[EST_BATCHES:]) / EST_BATCHES
        check(all(onp.isfinite(losses)) and second < first,
              "Estimator: the second epoch's mean loss %.4f is not below the "
              "first's %.4f: %r" % (second, first, losses))
        metrics = {m.get()[0]: m.get()[1] for m in (acc, top5, ce)}
        check(all(onp.isfinite(v) for v in metrics.values()),
              "Estimator metrics %r" % metrics)
        # the last checkpoint reads back: parameters and trainer states
        last = os.path.join(tmp, "resnet50-epoch%dbatch%d"
                            % (EST_EPOCHS, steps))
        files = sorted(os.listdir(tmp))
        check(files == sorted(
            os.path.basename(c)[:-len(".params")] + e
            for c in ckpt.saved_checkpoints for e in (".params", ".states")),
            "checkpoint files %r" % files)
        back = gluon.nn.HybridSequential(prefix="est_")
        with back.name_scope():
            back.add(resnet50_v1(), gluon.nn.HybridLambda(
                lambda F, x: F.softmax(x)))
        back.load_parameters(last + ".params", ctx=mx.gpu(0))
        want = sorted(net.collect_params().items())
        got = sorted(back.collect_params().items())
        check(len(got) == len(want) and all(
            torch.equal(a.data().astorch(), b.data().astorch())
            for (_, a), (_, b) in zip(got, want)),
            "the checkpoint's parameters differ from the net's")
        tr2 = gluon.Trainer(back.collect_params(), "nadam", dict(EST_NADAM))
        tr2.load_states(last + ".states")
        check(tr2.optimizer.num_update == trainer.optimizer.num_update
              == steps and tr2.optimizer.m_schedule
              == trainer.optimizer.m_schedule,
              "the checkpoint's states: num_update %d m_schedule %r"
              % (tr2.optimizer.num_update, tr2.optimizer.m_schedule))
        ckpt_bytes = sum(os.path.getsize(os.path.join(tmp, f))
                         for f in files)
    finally:
        loader.close()
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    del net, back, est, trainer, tr2
    torch.cuda.empty_cache()
    return {"losses": losses, "steps": steps, "fit_s": fit_s,
            "step_ms": statistics.median(clock.steps) * 1e3,
            "step_ms_all": [t * 1e3 for t in clock.steps],
            "wait_ms": [t * 1e3 for t in clock.waits],
            "wait_first_ms": clock.waits[0] * 1e3,
            "wait_later_ms": statistics.median(clock.waits[1:]) * 1e3,
            "wait_total_s": sum(clock.waits),
            "launches": launches, "metrics": metrics,
            "checkpoint_files": files, "checkpoint_bytes": ckpt_bytes}


def rules_card_vs_cpu(torch, mx, seed):
    """Each new optimizer rule: one ``Trainer.step`` over ResNet-50 v1's
    parameters on the card, against the same step on the CPU from the same
    weights and gradients (the update's rel L2 error over all parameters);
    SGLD by the mean and spread of its noise on the card."""
    import numpy as onp
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.gluon.utils import load_jax_params
    nets = {}
    for side, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
        mx.random.seed(seed)
        with ctx:
            net = resnet50_v1()
            net.initialize(mx.init.Xavier(), ctx=ctx)
            with mx.autograd.predict_mode():
                net(mx.nd.zeros((1, 3, IMAGE_SIZE, IMAGE_SIZE), ctx=ctx))
        nets[side] = net
    w0 = _param_arrays(nets["card"])
    rs = onp.random.RandomState(seed + 7)
    trained = [k for k, p in nets["card"]._collect_params_with_prefix()
               .items() if p.grad_req != "null"]
    grads = {k: (rs.standard_normal(w0[k].shape) * 1e-2).astype("float32")
             for k in trained}

    def step(side, name, kw):
        net = nets[side]
        if side == "card":
            for k, p in net._collect_params_with_prefix().items():
                p.set_data(w0[k])
        else:
            load_jax_params(net, w0)
        items = net._collect_params_with_prefix()
        for k in trained:
            p = items[k]
            p.grad().astorch().copy_(torch.from_numpy(grads[k]))
            p.data()._fresh_grad = True
        trainer = gluon.Trainer(net.collect_params(), name, dict(kw))
        trainer.step(TRAIN_BATCH)
        if side == "card":
            torch.cuda.synchronize()
        return _param_arrays(net)

    rows = []
    for name, kw in RULES:
        t = time.perf_counter()
        w1_gpu = step("card", name, kw)
        gpu_s = time.perf_counter() - t
        if name == "sgld":
            lr = kw["learning_rate"]
            noise = onp.concatenate([
                (w1_gpu[k] - (w0[k] - lr / 2 * grads[k] / TRAIN_BATCH))
                .ravel().astype("float64") for k in trained])
            mean_se = abs(noise.mean()) / (lr / noise.size) ** 0.5
            std_rel = abs(noise.std() / lr ** 0.5 - 1)
            rows.append({"rule": name, "noise_mean_se": mean_se,
                         "noise_std_rel_err": std_rel, "draws": noise.size,
                         "card_s": gpu_s})
            check(mean_se <= SGLD_SE and std_rel <= SGLD_STD_RTOL,
                  "SGLD noise on the card: mean %.3g s.e., std rel err %.3g"
                  % (mean_se, std_rel))
            continue
        with mx.cpu():
            w1_cpu = step("cpu", name, kw)
        rel, per_param = _update_errors(w0, w1_gpu, w1_cpu)
        rows.append({"rule": name, "update_rel_l2": rel,
                     "worst": per_param[:2], "card_s": gpu_s})
        check(rel <= RULE_UPDATE_REL_L2,
              "%s: the card's update against the CPU's: rel L2 %.3g > %g "
              "(worst %s)" % (name, rel, RULE_UPDATE_REL_L2, per_param[:2]))
    del nets
    torch.cuda.empty_cache()
    return rows


def _loss_cases(gluon, rs):
    """(name, loss, inputs as numpy, the positions to differentiate, the
    other positional arguments) at (32, 1000), CTC at T 100, N 32, C 28, L
    20 with labels of 10 to 20 (repeats among them) padded with 0."""
    import numpy as onp
    shape = (LOSS_ROWS, LOSS_CLASSES)

    def f(a):
        return onp.asarray(a, "float32")
    logits = f(rs.standard_normal(shape) * 2)
    binary = f(rs.randint(0, 2, shape))
    signed = binary * 2 - 1
    target = f(rs.dirichlet(onp.ones(LOSS_CLASSES), LOSS_ROWS))
    sw = f(rs.uniform(0.5, 1.5, (LOSS_ROWS, 1)))
    counts = f(rs.poisson(2.0, shape))
    lab = onp.zeros((CTC_N, CTC_L), "float32")
    for i, n in enumerate(rs.randint(10, CTC_L + 1, CTC_N)):
        lab[i, :n] = rs.randint(1, CTC_C, n)
    lab[0, :4] = 3                        # a run of one label
    ctc_pred = f(rs.standard_normal((CTC_N, CTC_T, CTC_C)))
    L = gluon.loss
    return [
        ("SigmoidBCELoss", L.SigmoidBCELoss(), [logits, binary], (0,),
         (sw,)),
        ("KLDivLoss", L.KLDivLoss(from_logits=False), [logits, target], (0,),
         ()),
        ("HuberLoss", L.HuberLoss(rho=1), [logits, f(logits[::-1])], (0,),
         (sw,)),
        ("HingeLoss", L.HingeLoss(), [logits, signed], (0,), ()),
        ("SquaredHingeLoss", L.SquaredHingeLoss(), [logits, signed], (0,),
         ()),
        ("LogisticLoss", L.LogisticLoss(), [logits, signed], (0,), (sw,)),
        ("TripletLoss", L.TripletLoss(margin=0.5),
         [logits, f(logits[::-1]), f(rs.standard_normal(shape))], (0, 1, 2),
         ()),
        ("PoissonNLLLoss", L.PoissonNLLLoss(), [f(logits * 0.3), counts],
         (0,), ()),
        ("CosineEmbeddingLoss", L.CosineEmbeddingLoss(margin=0.2),
         [logits, f(rs.standard_normal(shape)),
          f(signed[:, 0])], (0, 1), ()),
        ("CTCLoss", L.CTCLoss(), [ctc_pred, lab], (0,), ()),
    ]


def losses_card_vs_cpu(torch, mx, seed):
    """Each new loss, forward and backward on the card against the CPU on
    the same inputs: the values' largest error relative to their largest
    magnitude, and each input gradient's rel L2 error; the card's ms for
    a forward and backward."""
    import numpy as onp
    from mxnet_tpu_torch import gluon
    rows = []
    for name, loss, inputs, diff, extra in _loss_cases(
            gluon, onp.random.RandomState(seed + 9)):
        out = {}
        for side, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
            with ctx:
                arrs = [mx.nd.array(a, ctx=ctx) for a in inputs]
                more = [mx.nd.array(a, ctx=ctx) for a in extra]
                for i in diff:
                    arrs[i].attach_grad()

                def fwd_bwd():
                    with mx.autograd.record():
                        value = loss(*arrs, *more)
                    value.backward()
                    return value
                value = fwd_bwd()
                out[side] = (value.asnumpy(),
                             [arrs[i].grad.asnumpy() for i in diff])
                if side == "card":
                    fwd_bwd()
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    fwd_bwd()
                    torch.cuda.synchronize()
                    card_ms = (time.perf_counter() - t) * 1e3
        (gv, gg), (cv, cg) = out["card"], out["cpu"]
        val_err = float(onp.abs(gv - cv).max() / onp.abs(cv).max())
        grad_err = max(float(onp.linalg.norm(a - b) / onp.linalg.norm(b))
                       for a, b in zip(gg, cg))
        rows.append({"loss": name, "value_rel_err": val_err,
                     "grad_rel_l2": grad_err, "card_ms": card_ms,
                     "shape": list(inputs[0].shape)})
        grad_limit = CTC_GRAD_REL_L2 if name == "CTCLoss" \
            else LOSS_GRAD_REL_L2
        check(onp.isfinite(gv).all() and val_err <= LOSS_RTOL
              and grad_err <= grad_limit,
              "%s on the card against the CPU: value rel err %.3g (limit "
              "%g), gradient rel L2 %.3g (limit %g)"
              % (name, val_err, LOSS_RTOL, grad_err, grad_limit))
    return rows


def metrics_card_vs_cpu(mx, seed):
    """Each new metric over arrays on the card against the same arrays on
    the CPU: the same readings (the math is the host's on both)."""
    import numpy as onp
    rs = onp.random.RandomState(seed + 11)
    probs = rs.dirichlet(onp.ones(LOSS_CLASSES), LOSS_ROWS).astype("float32")
    classes = rs.randint(0, LOSS_CLASSES, LOSS_ROWS).astype("float32")
    binp = rs.dirichlet(onp.ones(2), LOSS_ROWS).astype("float32")
    binl = rs.randint(0, 2, LOSS_ROWS).astype("float32")
    reg = rs.standard_normal((LOSS_ROWS, 8)).astype("float32")
    reg2 = rs.standard_normal((LOSS_ROWS, 8)).astype("float32")
    m = mx.metric
    cases = [("mae", m.MAE, reg, reg2), ("mse", m.MSE, reg, reg2),
             ("rmse", m.RMSE, reg, reg2), ("f1", m.F1, binl, binp),
             ("f1_micro", lambda: m.F1(average="micro"), binl, binp),
             ("mcc", m.MCC, binl, binp),
             ("mcc_micro", lambda: m.MCC(average="micro"), binl, binp),
             ("perplexity", lambda: m.Perplexity(ignore_label=None),
              classes, probs),
             ("pearsonr", m.PearsonCorrelation, reg, reg2),
             ("nll_loss", m.NegativeLogLikelihood, classes, probs),
             ("torch", m.Torch, classes, probs),
             ("caffe", m.Caffe, classes, probs),
             ("custom", lambda: m.CustomMetric(
                 lambda l, p: float((p.argmax(1) == l).mean())), classes,
              probs),
             ("np", lambda: m.np(lambda l, p: float(onp.abs(l - p).mean())),
              reg, reg2),
             ("alias_pearsonr", lambda: m.create("pearsonr"), reg, reg2)]
    rows = []
    for name, make, label, pred in cases:
        readings = []
        for ctx in (mx.gpu(0), mx.cpu()):
            metric = make()
            for k in range(2):
                metric.update([mx.nd.array(label, ctx=ctx)],
                              [mx.nd.array(pred * (k + 1), ctx=ctx)])
            readings.append((metric.get(), metric.get_global()))
        rows.append({"metric": name, "value": readings[0][0][1]})
        check(readings[0] == readings[1] and all(
            onp.isfinite(r[1]) for r in readings[0]),
            "metric %s on the card %r, on the CPU %r"
            % (name, readings[0], readings[1]))
    return rows


def training_rest_phase(torch, mx, attention, layernorm, fused_norm, seed,
                        card, mesh):
    """The rest of training on the card: AdamW in BERT-base's
    DataParallelStep (graphed, eager, ZeRO on the one-rank NCCL
    ``mesh``), ResNet-50 v1 through ``Estimator.fit`` fed by DataLoader
    workers, and every new rule, loss and metric against the CPU.  Each
    path's hand-kernel counts from 0 just before it, read just after."""
    out = {}
    t = time.perf_counter()
    out["adamw"] = adamw_bert_phase(torch, mx, attention, layernorm, seed,
                                    card, mesh)
    out["adamw_s"] = time.perf_counter() - t
    _print_adamw(out["adamw"], card)
    _reset_counts(attention, layernorm)
    t = time.perf_counter()
    out["estimator"] = estimator_phase(torch, mx, fused_norm, seed, card)
    out["estimator_s"] = time.perf_counter() - t
    _print_estimator(out["estimator"], card)
    est_other = _hand_kernel_launches(attention, layernorm, fused_norm)
    est_other.pop("fused_norm")
    check(all(v == (0, 0) for v in est_other.values()),
          "the Estimator's ResNet launched an attention or LayerNorm kernel:"
          " %r" % est_other)
    _reset_counts(attention, layernorm)
    fused_norm.LAUNCHES = fused_norm.BWD_LAUNCHES = 0
    t = time.perf_counter()
    out["rules"] = rules_card_vs_cpu(torch, mx, seed)
    out["losses"] = losses_card_vs_cpu(torch, mx, seed)
    out["metrics"] = metrics_card_vs_cpu(mx, seed)
    out["sweeps_s"] = time.perf_counter() - t
    _print_sweeps(out, card)
    out["sweep_launches"] = _hand_kernel_launches(attention, layernorm,
                                                  fused_norm)
    print("training rest: seconds adamw %.1f, estimator %.1f, sweeps %.1f; "
          "sweep launches %s" % (out["adamw_s"], out["estimator_s"],
                                 out["sweeps_s"], out["sweep_launches"]))
    # one eval forward of the rules' ResNet-50 settles its shapes: 16
    # epilogue launches; nothing else of the sweeps runs a hand kernel
    want = {k: (0, 0) for k in out["sweep_launches"]}
    want["fused_norm"] = (16, 0)
    check(out["sweep_launches"] == want,
          "the rule, loss and metric sweeps launched %r, want %r"
          % (out["sweep_launches"], want))
    return out


def _print_adamw(a, card):
    for name, what in (("plain", "no mesh"),
                       ("zero", "one-rank NCCL mesh, shard_optimizer=True")):
        run = a[name]
        print("adamw bert: DataParallelStep, %s: BERT-base bf16 MLM at %d x "
              "%d, AdamW lr %g wd %g, %d steps, losses %s; step %.3f ms "
              "(median of %d), optimizer state %d bytes a rank, launches "
              "(B, T, H, D) attention fwd %d bwd %d, LayerNorm fwd %d bwd %d"
              " (%s)" % (what, BERT_BATCH, BERT_SEQ, ADAMW_PARAMS[
                  "learning_rate"], ADAMW_PARAMS["wd"], run["steps"],
                  [round(v, 4) for v in run["losses"]], run["step_ms"],
                  BERT_TRAIN_TIMED, run["state_bytes"], *run["launches"],
                  card))
    print("adamw bert: launches a step (B, T, H, D) attention fwd %d bwd %d,"
          " LayerNorm fwd %d bwd %d, as Adam's; the ZeRO steps gave the "
          "bits of the steps without a mesh" % (
              (BERT_ATTN_PER_STEP,) * 2 + (BERT_LN_PER_STEP,) * 2))
    print_graphed(a["graph"], card)


def _print_estimator(e, card):
    print("estimator: ResNet-50 v1 + softmax through Estimator.fit, %d "
          "epochs of %d batches of %d from DataLoader(num_workers=%d) over "
          "RandomFlipLeftRight, ToTensor, Normalize; Trainer nadam lr %g; "
          "losses %s; metrics %s; step %.3f ms (median of %d; %s); the loop "
          "waited on the loader %.3f ms for the first batch (the workers' "
          "start) and %.3f ms (median) for each later one, %.3f s in all; "
          "fit %.2f s; epilogue launches fwd %d bwd %d; checkpoint %s read "
          "back, %d bytes (%s)"
          % (EST_EPOCHS, EST_BATCHES, EST_BATCH, EST_WORKERS,
             EST_NADAM["learning_rate"], [round(v, 4) for v in e["losses"]],
             {k: round(v, 4) for k, v in e["metrics"].items()}, e["step_ms"],
             e["steps"], [round(v, 1) for v in e["step_ms_all"]],
             e["wait_first_ms"], e["wait_later_ms"], e["wait_total_s"],
             e["fit_s"], e["launches"][0], e["launches"][1],
             e["checkpoint_files"], e["checkpoint_bytes"], card))


def _print_sweeps(r, card):
    for row in r["rules"]:
        if row["rule"] == "sgld":
            print("rules: sgld on the card: noise mean %.3g s.e., std rel "
                  "err %.3g over %d draws (%s)"
                  % (row["noise_mean_se"], row["noise_std_rel_err"],
                     row["draws"], card))
        else:
            print("rules: %s: one Trainer.step over ResNet-50 v1's "
                  "parameters, card vs CPU update rel L2 %.3g (limit %g), "
                  "worst %s; card step %.3f s (%s)"
                  % (row["rule"], row["update_rel_l2"], RULE_UPDATE_REL_L2,
                     ", ".join("%s %.3g" % (k, v) for v, k in row["worst"]),
                     row["card_s"], card))
    for row in r["losses"]:
        print("losses: %s at %s: card vs CPU value rel err %.3g, gradient "
              "rel L2 %.3g; forward and backward %.3f ms on the card (%s)"
              % (row["loss"], row["shape"], row["value_rel_err"],
                 row["grad_rel_l2"], row["card_ms"], card))
    print("metrics: %d metrics over card arrays gave the CPU's readings: %s"
          % (len(r["metrics"]), ", ".join(
              "%s %.4g" % (m["metric"], m["value"]) for m in r["metrics"])))


# ---------------------------------------------------------------------------
# the Symbolic API and Module: the graphs, written against either
# package's ``mx.sym`` (the tests build them in both and compare the JSON)
# ---------------------------------------------------------------------------

def _conv_bn_relu(sym, data, num_filter, kernel, stride, pad, name,
                  relu=True):
    net = sym.Convolution(data, kernel=kernel, num_filter=num_filter,
                          stride=stride, pad=pad, no_bias=True,
                          name=name + "_conv")
    net = sym.BatchNorm(net, fix_gamma=False, eps=2e-5, momentum=0.9,
                        name=name + "_bn")
    if relu:
        net = sym.Activation(net, act_type="relu", name=name + "_relu")
    return net


def resnet_symbol(sym, depth=50, num_classes=1000):
    """``example/image_classification/symbols.py:get_resnet(depth,
    num_classes)`` for 224 x 224 images, the graph behind
    ``train_imagenet.py``: ResNet v1 with bottlenecks from depth 50,
    BatchNorm and Activation (no fused op)."""
    cfg = {18: (False, [2, 2, 2, 2], [64, 64, 128, 256, 512]),
           50: (True, [3, 4, 6, 3], [64, 256, 512, 1024, 2048])}
    bottle_neck, units, filters = cfg[depth]
    body = _conv_bn_relu(sym, sym.var("data"), filters[0], (7, 7), (2, 2),
                         (3, 3), "stem")
    body = sym.Pooling(body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                       pool_type="max", name="stem_pool")
    for stage, n_units in enumerate(units):
        for unit in range(n_units):
            stride = (1, 1) if stage == 0 or unit > 0 else (2, 2)
            dim_match = unit > 0 or (stage == 0 and filters[0] == filters[1])
            name = "stage%d_unit%d" % (stage + 1, unit + 1)
            nf = filters[stage + 1]
            if bottle_neck:
                b = _conv_bn_relu(sym, body, nf // 4, (1, 1), (1, 1),
                                  (0, 0), name + "_c1")
                b = _conv_bn_relu(sym, b, nf // 4, (3, 3), stride, (1, 1),
                                  name + "_c2")
                b = _conv_bn_relu(sym, b, nf, (1, 1), (1, 1), (0, 0),
                                  name + "_c3", relu=False)
            else:
                b = _conv_bn_relu(sym, body, nf, (3, 3), stride, (1, 1),
                                  name + "_c1")
                b = _conv_bn_relu(sym, b, nf, (3, 3), (1, 1), (1, 1),
                                  name + "_c2", relu=False)
            short = body if dim_match else _conv_bn_relu(
                sym, body, nf, (1, 1), stride, (0, 0), name + "_sc",
                relu=False)
            body = sym.Activation(b + short, act_type="relu",
                                  name=name + "_out")
    body = sym.Pooling(body, global_pool=True, pool_type="avg",
                       kernel=(7, 7), name="global_pool")
    body = sym.Flatten(body)
    body = sym.FullyConnected(body, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(body, name="softmax")


# the symbolic BERT encoder's inputs, in Module's data_names order
SYM_BERT_DATA = ("data", "position_ids", "masked_positions")


def bert_symbol(sym, layers, units, heads, hidden, vocab, max_len=512,
                eps=1e-12):
    """A BERT encoder with the masked-LM head as one Symbol graph: word
    and position embeddings, LayerNorm; each layer one ``FullyConnected``
    q/k/v projection (``flatten=False``) split into three (B, T, H, D)
    views, ``flash_attention_bshd``, the output projection, the residual
    add and LayerNorm, then the GELU feed-forward, add and LayerNorm; the
    head picks the masked rows (``take`` of the flattened (B T, units)
    output at ``masked_positions``), then dense, GELU, LayerNorm, the
    vocabulary logits and ``SoftmaxOutput``.  2 + 2 layers LayerNorms and
    ``layers`` attentions a forward."""
    d = units // heads
    x = sym.Embedding(sym.var("data"), input_dim=vocab, output_dim=units,
                      name="word_embed") \
        + sym.Embedding(sym.var("position_ids"), input_dim=max_len,
                        output_dim=units, name="pos_embed")
    x = sym.LayerNorm(x, eps=eps, name="embed_ln")
    for i in range(layers):
        p = "layer%d_" % i
        qkv = sym.FullyConnected(x, num_hidden=3 * units, flatten=False,
                                 name=p + "qkv")
        qkv = sym.SliceChannel(qkv, num_outputs=3, axis=-1, name=p + "split")
        q, k, v = (sym.Reshape(qkv[j], shape=(0, 0, heads, d),
                               name=p + "heads%d" % j) for j in range(3))
        a = sym.contrib.flash_attention_bshd(q, k, v, name=p + "attention")
        a = sym.FullyConnected(sym.Reshape(a, shape=(0, 0, units),
                                           name=p + "merge"),
                               num_hidden=units, flatten=False,
                               name=p + "proj")
        x = sym.LayerNorm(x + a, eps=eps, name=p + "ln1")
        h = sym.FullyConnected(x, num_hidden=hidden, flatten=False,
                               name=p + "ffn1")
        h = sym.Activation(h, act_type="gelu", name=p + "gelu")
        h = sym.FullyConnected(h, num_hidden=units, flatten=False,
                               name=p + "ffn2")
        x = sym.LayerNorm(x + h, eps=eps, name=p + "ln2")
    x = sym.take(sym.Reshape(x, shape=(-1, units), name="rows"),
                 sym.var("masked_positions"), name="masked_rows")
    x = sym.Activation(sym.FullyConnected(x, num_hidden=units,
                                          name="mlm_dense"),
                       act_type="gelu", name="mlm_gelu")
    x = sym.LayerNorm(x, eps=eps, name="mlm_ln")
    x = sym.FullyConnected(x, num_hidden=vocab, name="mlm_decoder")
    return sym.SoftmaxOutput(x, name="softmax")


def bucketing_lm_sym_gen(mx, vocab, embed, hidden, batch_size):
    """``example/rnn/bucketing_lm/train.py:sym_gen_factory`` against the
    package ``mx``: one bucket's graph a sequence length, the embedding, a
    fused 1-layer LSTM over one flat parameter vector, the vocabulary
    logits and ``SoftmaxOutput``."""
    n_par = 4 * hidden * (embed + hidden) + 8 * hidden

    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        emb = mx.sym.Embedding(data, input_dim=vocab, output_dim=embed,
                               name="embed")
        par = mx.sym.Variable("lstm_parameters", shape=(n_par,),
                              init=mx.init.Uniform(0.1))
        h0 = mx.sym.Variable("lstm_init_h", shape=(1, batch_size, hidden),
                             lr_mult=0.0, init=mx.init.Zero())
        c0 = mx.sym.Variable("lstm_init_c", shape=(1, batch_size, hidden),
                             lr_mult=0.0, init=mx.init.Zero())
        tnc = mx.sym.SwapAxis(emb, dim1=0, dim2=1)
        rnn = mx.sym.RNN(tnc, par, h0, state_cell=c0, state_size=hidden,
                         num_layers=1, mode="lstm", name="lstm")
        ntc = mx.sym.SwapAxis(rnn, dim1=0, dim2=1)
        pred = mx.sym.Reshape(ntc, shape=(-1, hidden))
        fc = mx.sym.FullyConnected(pred, num_hidden=vocab, name="fc")
        sm = mx.sym.SoftmaxOutput(fc, mx.sym.Reshape(label, shape=(-1,)),
                                  name="softmax")
        return sm, ("data",), ("softmax_label",)
    return sym_gen


# train_imagenet.py --benchmark 1: batch 64 of 3 x 224 x 224 synthetic
# images, 1000 classes, one epoch of 6 batches, SGD with the script's
# optimizer_params; the median step is taken after the first 2
SYM_RN_BATCH = 64
SYM_RN_BATCHES = 6
SYM_RN_SKIP = 2
SYM_RN_RESUME_BATCHES = 2
SYM_RN_SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
              "rescale_grad": 1.0 / SYM_RN_BATCH}
# one step at batch 4 on the card against the same step on the CPU, held as
# the Gluon training phase holds its batch-2 step (PARITY_*: the step's
# gradients are ill-conditioned sums at so small a batch)
SYM_RN_PARITY_BATCH = 4
# the symbolic BERT-base: 4 Adam steps on one batch (the loss must fall),
# the step ms the median of the last 3; the head's rows averaged
# (rescale_grad = 1 / rows, as bench.py's MLM loss takes their mean)
SYM_BERT_STEPS = 4
SYM_BERT_ADAM = {"learning_rate": BERT_LR,
                 "rescale_grad": 1.0 / (BERT_BATCH * BERT_PRED)}
# a 2-layer BERT-base-wide encoder at batch 2 x 128 (19 masked rows a
# row) on the card against the CPU: the logits' probabilities within
# BERT_PARITY_REL_L2 (as the Gluon forward's check), the gradients within a
# relative L2 error of 1e-5 over all parameters.  On an H100 at 700 W
# (``chip_diag.py symgrad``, seeds 0-2) the sound kernels read 8.28e-7 to
# 8.43e-7; the float32 attention kernels with one TF32 product in place
# of three read 4.59e-5 to 4.62e-5 (their probabilities 8.5e-6, inside
# BERT_PARITY_REL_L2), and cuBLAS's products in TF32 5.22e-4.
SYM_PARITY_LAYERS, SYM_PARITY_BATCH = 2, 2
SYM_PARITY_GRAD_REL_L2 = 1e-5
# bucketing_lm's graph at the LSTM LM phase's width (config 4: 10000
# words, 650 units, batch 32), one LSTM layer as the example has it
SYM_LM_BUCKETS = (8, 12, 16, 24)
SYM_LM_BATCHES = 2


def _sym_synthetic_iter(mx, shape, classes, batches, seed, ctx):
    """``train_imagenet.py``'s ``SyntheticDataIter``: one random batch
    made from ``seed`` on ``ctx``, served ``batches`` times an epoch."""
    import numpy as onp

    class SyntheticDataIter(mx.io.DataIter):
        def __init__(self):
            super().__init__(batch_size=shape[0])
            rs = onp.random.RandomState(seed)
            self.data = mx.nd.array(rs.uniform(-1, 1, shape)
                                    .astype("float32"), ctx=ctx)
            self.label = mx.nd.array(rs.randint(0, classes, (shape[0],))
                                     .astype("float32"), ctx=ctx)
            self.cur_iter = 0
            self.provide_data = [mx.io.DataDesc("data", shape)]
            self.provide_label = [mx.io.DataDesc("softmax_label",
                                                 (shape[0],))]

        def next(self):
            self.cur_iter += 1
            if self.cur_iter > batches:
                raise StopIteration
            return mx.io.DataBatch(data=[self.data], label=[self.label],
                                   pad=0, provide_data=self.provide_data,
                                   provide_label=self.provide_label)

        def reset(self):
            self.cur_iter = 0
    return SyntheticDataIter()


def _softmax_ce(torch, probs, label):
    """The mean cross entropy of ``SoftmaxOutput``'s probabilities at the
    labels."""
    p = probs.float().gather(1, label.long().view(-1, 1))
    return float(-torch.log(p.clamp_min(1e-30)).mean())


def _host_params(mod):
    arg, aux = mod.get_params()
    return ({k: v.astorch().detach().cpu().clone() for k, v in arg.items()},
            {k: v.astorch().detach().cpu().clone() for k, v in aux.items()})


def _as_nd(mx, tensors, ctx):
    return {k: mx.nd.array(v.numpy(), ctx=ctx) for k, v in tensors.items()}


def _module_step(torch, mx, sym, args, aux, batch, ctx, data_names,
                 optimizer, params):
    """One ``forward_backward`` and ``update`` of a Module over ``sym`` on
    ``ctx`` from host weights: (probabilities, updated weights and
    auxiliary states on the host, gradients on the host)."""
    mod = mx.mod.Module(sym, data_names=data_names,
                        label_names=("softmax_label",), context=ctx)
    data, label = batch
    mod.bind(data_shapes=[(n, tuple(a.shape)) for n, a in zip(data_names,
                                                               data)],
             label_shapes=[("softmax_label", tuple(label.shape))])
    mod.init_params(arg_params=_as_nd(mx, args, ctx),
                    aux_params=_as_nd(mx, aux, ctx))
    mod.init_optimizer(optimizer=optimizer, optimizer_params=params)
    b = mx.io.DataBatch([mx.nd.array(d.numpy(), ctx=ctx) for d in data],
                        [mx.nd.array(label.numpy(), ctx=ctx)])
    mod.forward_backward(b)
    probs = mod.get_outputs()[0].astorch().detach().cpu().clone()
    grads = {n: g.astorch().detach().cpu().clone()
             for n, g in mod._exec.grad_dict.items() if g is not None}
    mod.update()
    if ctx.device_type == "gpu":
        torch.cuda.synchronize()
    arg, aux2 = _host_params(mod)
    return probs, dict(arg, **aux2), grads


def sym_resnet_phase(torch, mx, attention, layernorm, fused_norm, seed, card,
                     profile=False):
    """``train_imagenet.py --network resnet50 --benchmark 1`` through the
    port's ``Module.fit``: the graph of ``resnet_symbol`` (BatchNorm and
    Activation, as the example has it: no hand kernel), Xavier weights
    from ``seed``, batch 64 of synthetic images on the card, SGD, a
    ``Speedometer`` and ``do_checkpoint`` into a temporary directory, one
    epoch of 6 batches; the checkpoint read back with ``load_checkpoint``
    (the module's bits) and resumed with ``Module.load`` for 2 batches;
    one step at batch 4 on the card against the CPU.  Every hand kernel's
    counts are set to 0 before the fit and read after it (all 0)."""
    import tempfile
    import numpy as onp
    gpu = mx.gpu(0)
    net = resnet_symbol(mx.sym, 50, 1000)
    shape = (SYM_RN_BATCH, 3, 224, 224)
    it = _sym_synthetic_iter(mx, shape, 1000, SYM_RN_BATCHES, seed, gpu)
    mx.random.seed(seed)
    mod = mx.mod.Module(net, context=gpu)
    speedo = mx.callback.Speedometer(SYM_RN_BATCH, 2)
    stamps, outputs = [], []

    def timer(param):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        outputs.append(mod.get_outputs()[0].astorch())
    _reset_counts(attention, layernorm)
    fused_norm.LAUNCHES = fused_norm.BWD_LAUNCHES = 0
    tmp = tempfile.TemporaryDirectory()
    prefix = os.path.join(tmp.name, "resnet50")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=1, optimizer="sgd", optimizer_params=SYM_RN_SGD,
            initializer=mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                       magnitude=2),
            batch_end_callback=[speedo, timer],
            epoch_end_callback=mx.callback.do_checkpoint(prefix),
            eval_metric=["acc"])
    fit_s = time.perf_counter() - t0
    losses = [_softmax_ce(torch, o, it.label.astorch()) for o in outputs]
    del outputs
    steps = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    step_ms = statistics.median(steps[SYM_RN_SKIP:]) * 1e3
    launches = _hand_kernel_launches(attention, layernorm, fused_norm)
    check(all(v == (0, 0) for v in launches.values()),
          "symbolic ResNet-50 launched a hand-written kernel: %r (its graph "
          "has none)" % launches)
    check(len(losses) == SYM_RN_BATCHES
          and all(onp_isfinite(v) for v in losses),
          "symbolic ResNet-50 losses %r" % losses)
    # the checkpoint reads back to the module's bits and resumes
    files = sorted(os.listdir(tmp.name))
    check(files == ["resnet50-0001.params", "resnet50-symbol.json"],
          "do_checkpoint wrote %r" % files)
    sym2, arg2, aux2 = mx.model.load_checkpoint(prefix, 1)
    arg, aux = mod.get_params()
    same = sym2.tojson() == net.tojson() and all(
        torch.equal(arg2[k].astorch().to(v.astorch().device), v.astorch())
        for k, v in arg.items()) and all(
        torch.equal(aux2[k].astorch().to(v.astorch().device), v.astorch())
        for k, v in aux.items())
    check(same, "load_checkpoint did not give the module's graph and bits")
    batch = next(iter(it))
    mod.forward(batch, is_train=False)
    want = mod.get_outputs()[0].astorch().clone()
    resumed = mx.mod.Module.load(prefix, 1, context=gpu)
    resumed.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    resumed.init_params()
    resumed.forward(batch, is_train=False)
    check(torch.equal(resumed.get_outputs()[0].astorch(), want),
          "Module.load's forward differs from the saving module's")
    it2 = _sym_synthetic_iter(mx, shape, 1000, SYM_RN_RESUME_BATCHES, seed,
                              gpu)
    resumed.fit(it2, begin_epoch=1, num_epoch=2, optimizer="sgd",
                optimizer_params=SYM_RN_SGD, eval_metric="acc")
    resumed.forward(batch, is_train=False)
    resume_loss = _softmax_ce(torch, resumed.get_outputs()[0].astorch(),
                              it.label.astorch())
    check(onp_isfinite(resume_loss), "resumed loss %r" % resume_loss)
    host_args, host_aux = _host_params(mod)
    tmp.cleanup()
    prof = None
    if profile:
        def one():
            mod.forward_backward(batch)
            mod.update()
            torch.cuda.synchronize()
        prof = profile_calls(torch, one, "symbolic ResNet-50 Module step, "
                             "batch %d, eager" % SYM_RN_BATCH, calls=3)
    peak = torch.cuda.max_memory_allocated()
    del mod, resumed, it, it2, batch, want
    torch.cuda.empty_cache()
    # one step at batch 4, card against CPU, from the trained weights
    rs = onp.random.RandomState(seed + 7)
    x = torch.from_numpy(rs.uniform(-1, 1, (SYM_RN_PARITY_BATCH, 3, 224, 224))
                         .astype("float32"))
    y = torch.from_numpy(rs.randint(0, 1000, (SYM_RN_PARITY_BATCH,))
                         .astype("float32"))
    t0 = time.perf_counter()
    before = dict(host_args, **host_aux)
    sgd = dict(SYM_RN_SGD, rescale_grad=1.0 / SYM_RN_PARITY_BATCH)
    p_gpu, w_gpu, _ = _module_step(torch, mx, net, host_args, host_aux,
                                   ([x], y), gpu, ("data",), "sgd", sgd)
    with mx.cpu():
        p_cpu, w_cpu, _ = _module_step(torch, mx, net, host_args, host_aux,
                                       ([x], y), mx.cpu(), ("data",), "sgd",
                                       sgd)
    loss_gpu, loss_cpu = _softmax_ce(torch, p_gpu, y), _softmax_ce(torch,
                                                                  p_cpu, y)
    upd, per_param = _update_errors(*({k: v.numpy() for k, v in w.items()}
                                      for w in (before, w_gpu, w_cpu)))
    worst = per_param[0]
    check(abs(loss_gpu - loss_cpu) <= PARITY_LOSS_RTOL * abs(loss_cpu)
          and upd <= PARITY_UPDATE_REL_L2 and worst[0] <= PARITY_PARAM_REL_L2,
          "symbolic ResNet-50 step at batch %d, card vs CPU: loss %.7g vs "
          "%.7g, updates rel L2 %.3g (limit %g), worst %s %.3g (limit %g)"
          % (SYM_RN_PARITY_BATCH, loss_gpu, loss_cpu, upd,
             PARITY_UPDATE_REL_L2, worst[1], worst[0], PARITY_PARAM_REL_L2))
    return {"step_ms": step_ms, "images_per_s": SYM_RN_BATCH * 1e3 / step_ms,
            "step_ms_all": [v * 1e3 for v in steps], "losses": losses,
            "speedometer": speedo.speed, "fit_s": fit_s,
            "peak_bytes": peak, "resume_loss": resume_loss,
            "launches": launches,
            "parity": {"loss": (loss_gpu, loss_cpu), "update_rel_l2": upd,
                       "worst": worst, "s": time.perf_counter() - t0},
            "profile": prof}


def _sym_bert_batch(torch, seed, batch, seq, n_pred):
    """bench.py's config-5 token ids at ``batch`` x ``seq`` with
    ``n_pred`` sorted masked positions a row, as the symbolic graph takes
    them: ``(data, position_ids, masked_positions)`` (the last as rows of
    the flattened (batch seq, units) output) and the labels."""
    import numpy as onp
    rs = onp.random.RandomState(seed)
    tokens = rs.randint(0, BERT_VOCAB, (batch, seq)).astype("float32")
    pos = onp.sort(onp.stack([rs.choice(seq, n_pred, replace=False)
                              for _ in range(batch)]), 1)
    rows = (pos + seq * onp.arange(batch)[:, None]).reshape(-1)
    labels = rs.randint(0, BERT_VOCAB, (batch * n_pred,)).astype("float32")
    host = [torch.from_numpy(tokens),
            torch.from_numpy(onp.tile(onp.arange(seq, dtype="float32"),
                                      (batch, 1))),
            torch.from_numpy(rows.astype("float32"))]
    return host, torch.from_numpy(labels)


def _sym_bert_module(mx, sym, data, label, ctx):
    mod = mx.mod.Module(sym, data_names=SYM_BERT_DATA,
                        label_names=("softmax_label",), context=ctx)
    mod.bind(data_shapes=[(n, tuple(d.shape)) for n, d in zip(SYM_BERT_DATA,
                                                               data)],
             label_shapes=[("softmax_label", tuple(label.shape))])
    return mod


def sym_bert_train(torch, mx, attention, layernorm, sym, args, data, label,
                   what, want_attn_dtype, profile=False):
    """``SYM_BERT_STEPS`` Adam steps of the symbolic BERT ``sym`` through
    ``Module`` on the card from the host weights ``args``: the step ms,
    the launches a step of the attention and LayerNorm kernels (12 + 12
    and 26 + 26 required in each step after the first, which captures the
    Executor's pair: twice that there, the warm-up and the replay) and the
    losses (falling); a spy checks the dtypes the kernels' wrappers get
    (attention ``want_attn_dtype``, LayerNorm float32)."""
    gpu = mx.gpu(0)
    mod = _sym_bert_module(mx, sym, data, label, gpu)
    mod.init_params(arg_params=_as_nd(mx, args, gpu))
    mod.init_optimizer(optimizer="adam", optimizer_params=SYM_BERT_ADAM)
    batch = mx.io.DataBatch([mx.nd.array(d.numpy(), ctx=gpu) for d in data],
                            [mx.nd.array(label.numpy(), ctx=gpu)])
    seen_attn, seen_ln = set(), set()
    orig_a = _dtype_spy(attention, "flash_attention_bshd_fwd", seen_attn)
    orig_l = _dtype_spy(layernorm, "layer_norm_fwd", seen_ln)
    try:
        _reset_counts(attention, layernorm)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        for i in range(SYM_BERT_STEPS):
            if i == 1:
                first = _bert_counts(attention, layernorm)
                _reset_counts(attention, layernorm)
            t = time.perf_counter()
            mod.forward_backward(batch)
            mod.update()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            losses.append(_softmax_ce(torch, mod.get_outputs()[0].astorch(),
                                      batch.label[0].astorch()))
        counts = _bert_counts(attention, layernorm)
    finally:
        attention.flash_attention_bshd_fwd = orig_a
        layernorm.layer_norm_fwd = orig_l
    n = SYM_BERT_STEPS - 1
    per = (BERT_ATTN_PER_STEP,) * 2 + (BERT_LN_PER_STEP,) * 2
    want = tuple(v * n for v in per)
    check(counts == (want, (0, 0))
          and first == (tuple(2 * v for v in per), (0, 0)),
          "%s: launches %r in the %d steps after the first, %r in the "
          "first, want %r a step (twice that in the first) and no (B, H, "
          "T, D) ones" % (what, counts, n, first, per))
    counts = (tuple(a + b for a, b in zip(first[0], counts[0])), counts[1])
    check(seen_attn == {want_attn_dtype} and seen_ln == {"float32"},
          "%s: attention got %s, LayerNorm %s" % (what, seen_attn, seen_ln))
    check(all(onp_isfinite(v) for v in losses) and losses[-1] < losses[0],
          "%s: losses %r do not fall" % (what, losses))
    prof = None
    if profile:
        def one():
            mod.forward_backward(batch)
            mod.update()
            torch.cuda.synchronize()
        prof = profile_calls(torch, one, what + ", eager", calls=2)
    return mod, batch, {
        "step_ms": statistics.median(times[1:]) * 1e3,
        "step_ms_all": [v * 1e3 for v in times], "losses": losses,
        "launches_per_step": per, "launches": counts[0],
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "profile": prof}


def sym_bert_card_vs_cpu(torch, mx, seed):
    """A 2-layer encoder of the symbolic BERT graph at BERT-base's widths,
    batch 2 x 128, one forward and backward on the card against the CPU
    from the same Xavier weights: the probabilities within
    BERT_PARITY_REL_L2, the gradients within SYM_PARITY_GRAD_REL_L2."""
    sym = bert_symbol(mx.sym, SYM_PARITY_LAYERS, BERT_UNITS, BERT_HEADS,
                      4 * BERT_UNITS, BERT_VOCAB)
    data, label = _sym_bert_batch(torch, seed + 3, SYM_PARITY_BATCH,
                                  BERT_PARITY_SEQ, BERT_PARITY_PRED)
    with mx.cpu():
        mod = _sym_bert_module(mx, sym, data, label, mx.cpu())
        mx.random.seed(seed)
        mod.init_params(mx.init.Xavier())
        args = _host_params(mod)[0]
        del mod
        p_cpu, _, g_cpu = _module_step(torch, mx, sym, args, {},
                                       (data, label), mx.cpu(), SYM_BERT_DATA,
                                       "adam", SYM_BERT_ADAM)
    p_gpu, _, g_gpu = _module_step(torch, mx, sym, args, {}, (data, label),
                                   mx.gpu(0), SYM_BERT_DATA, "adam",
                                   SYM_BERT_ADAM)
    out = _rel_l2(p_gpu.numpy(), p_cpu.numpy())
    grads = _grad_errors(*({k: g[k].numpy() for k in args}
                           for g in (g_gpu, g_cpu)))[0]
    check(out <= BERT_PARITY_REL_L2 and grads <= SYM_PARITY_GRAD_REL_L2,
          "symbolic 2-layer BERT card vs CPU: probabilities rel L2 %.3g "
          "(limit %g), gradients %.3g (limit %g)"
          % (out, BERT_PARITY_REL_L2, grads, SYM_PARITY_GRAD_REL_L2))
    return {"probs_rel_l2": out, "grads_rel_l2": grads}


def sym_bert_phase(torch, mx, attention, layernorm, seed, card,
                   profile=False):
    """BERT-base as one Symbol graph (``bert_symbol``: 12 layers, 768
    units, 12 heads, 3072 hidden, 30522 words, 24 x 512, 76 masked rows a
    row; ``MXNET_FUSED_LAYERNORM=1``) trained through ``Module`` with Adam:
    in float32 (the float32 attention and LayerNorm kernels), then after
    ``amp.convert_model(..., target_dtype="bfloat16")`` from the same
    weights (attention in bfloat16, LayerNorm in float32).  The float32
    module's checkpoint through ``SymbolBlock.imports`` gives its forward
    output with the same bits; a 2-layer version is held against the
    CPU."""
    from mxnet_tpu_torch.contrib import amp
    import tempfile
    os.environ["MXNET_FUSED_LAYERNORM"] = "1"
    gpu = mx.gpu(0)
    parity = sym_bert_card_vs_cpu(torch, mx, seed)
    sym = bert_symbol(mx.sym, BERT_LAYERS, BERT_UNITS, BERT_HEADS,
                      4 * BERT_UNITS, BERT_VOCAB)
    data, label = _sym_bert_batch(torch, seed, BERT_BATCH, BERT_SEQ,
                                  BERT_PRED)
    init = _sym_bert_module(mx, sym, data, label, gpu)
    mx.random.seed(seed)
    init.init_params(mx.init.Xavier())
    args = _host_params(init)[0]
    del init
    torch.cuda.empty_cache()
    mod, batch, f32 = sym_bert_train(
        torch, mx, attention, layernorm, sym, args, data, label,
        "symbolic BERT-base float32 Module step", "float32", profile)
    # the checkpoint through SymbolBlock.imports: the module's bits
    tmp = tempfile.TemporaryDirectory()
    prefix = os.path.join(tmp.name, "bert")
    mod.save_checkpoint(prefix, 1)
    mod.forward(batch, is_train=False)
    want = mod.get_outputs()[0].astorch().clone()
    del mod
    torch.cuda.empty_cache()
    block = mx.gluon.SymbolBlock.imports(
        prefix + "-symbol.json", list(SYM_BERT_DATA) + ["softmax_label"],
        prefix + "-0001.params", ctx=gpu)
    with torch.no_grad():
        got = block(*(batch.data + batch.label)).astorch()
    check(torch.equal(got, want), "SymbolBlock.imports' forward differs "
          "from the Module's (max |diff| %.3g)"
          % float((got - want).abs().max()))
    tmp.cleanup()
    del block, got, want
    torch.cuda.empty_cache()
    conv, cargs, _ = amp.convert_model(sym, _as_nd(mx, args, mx.cpu()), {},
                                       target_dtype="bfloat16")
    mod, _, bf16 = sym_bert_train(
        torch, mx, attention, layernorm, conv,
        {k: v.astorch() for k, v in cargs.items()}, data, label,
        "symbolic BERT-base after amp.convert_model(bfloat16) Module step",
        "bfloat16", profile)
    del mod
    del os.environ["MXNET_FUSED_LAYERNORM"]
    torch.cuda.empty_cache()
    return {"f32": f32, "bf16": bf16, "parity": parity,
            "symbol_block_same_bits": True}


def sym_bucketing_phase(torch, mx, attention, layernorm, fused_norm, seed,
                        card, profile=False):
    """``example/rnn/bucketing_lm``'s graph (``bucketing_lm_sym_gen``) at
    the LSTM LM phase's width through ``BucketingModule`` on the card: the
    buckets 8, 12, 16 and 24 (the default), 2 batches each of the
    example's order-2 sentences, SGD as the example's; the perplexity, the
    step ms a bucket, every bucket's Executor holding the default bucket's
    parameter NDArrays (one tensor each), no hand-written kernel on the
    path (cuDNN's LSTM)."""
    import numpy as onp
    gpu = mx.gpu(0)
    vocab, hidden, batch = LM_VOCAB, LM_HIDDEN, LM_BATCH
    gen = bucketing_lm_sym_gen(mx, vocab, hidden, hidden, batch)
    default = max(SYM_LM_BUCKETS)
    mx.random.seed(seed)
    bm = mx.mod.BucketingModule(gen, default_bucket_key=default, context=gpu)
    bm.bind(data_shapes=[("data", (batch, default))],
            label_shapes=[("softmax_label", (batch, default))])
    bm.init_params(mx.init.Xavier())
    bm.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.5, "momentum": 0.9,
        "rescale_grad": 1.0 / (batch * 4)})
    metric = mx.metric.Perplexity(ignore_label=0)
    rs = onp.random.RandomState(seed)
    _reset_counts(attention, layernorm)
    fused_norm.LAUNCHES = fused_norm.BWD_LAUNCHES = 0
    step_ms = {}
    for b in SYM_LM_BUCKETS:
        times = []
        for _ in range(SYM_LM_BATCHES):
            rows = onp.zeros((batch, b), "float32")
            rows[:, :2] = rs.randint(1, vocab, (batch, 2))
            for j in range(2, b):
                rows[:, j] = (rows[:, j - 1] + rows[:, j - 2]) \
                    % (vocab - 1) + 1
            lab = onp.concatenate([rows[:, 1:], onp.zeros((batch, 1),
                                                          "float32")], 1)
            db = mx.io.DataBatch(
                [mx.nd.array(rows, ctx=gpu)], [mx.nd.array(lab, ctx=gpu)],
                bucket_key=b,
                provide_data=[mx.io.DataDesc("data", (batch, b))],
                provide_label=[mx.io.DataDesc("softmax_label", (batch, b))])
            t = time.perf_counter()
            bm.forward(db, is_train=True)
            bm.backward()
            bm.update()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            bm.update_metric(metric, db.label)
        step_ms[b] = times[-1] * 1e3
    launches = _hand_kernel_launches(attention, layernorm, fused_norm)
    check(all(v == (0, 0) for v in launches.values()),
          "bucketing LM launched a hand-written kernel: %r" % launches)
    mods = bm._buckets
    base = mods[default]._exec.arg_dict
    names = mods[default]._param_names
    shared = sorted(mods) == sorted(SYM_LM_BUCKETS) and all(
        mods[b]._exec.arg_dict[n] is base[n]
        and mods[b]._exec.arg_dict[n].astorch().data_ptr()
        == base[n].astorch().data_ptr() for b in mods for n in names)
    check(shared, "BucketingModule's buckets do not share the default "
          "bucket's parameter tensors")
    ppl = metric.get()[1]
    check(onp_isfinite(ppl), "bucketing LM perplexity %r" % ppl)
    prof = None
    if profile:
        def one():
            bm.forward(db, is_train=True)
            bm.backward()
            bm.update()
            torch.cuda.synchronize()
        prof = profile_calls(torch, one, "bucketing LM step, bucket %d, eager"
                             % SYM_LM_BUCKETS[-1], calls=3)
    del bm
    torch.cuda.empty_cache()
    return {"perplexity": ppl, "step_ms": step_ms, "shared": shared,
            "params": len(names), "launches": launches, "profile": prof}


def amp_dp_bert_phase(torch, mx, attention, layernorm, seed, card):
    """BERT-base's float32-weight ``DataParallelStep`` (Adam, lr 1e-4)
    under ``amp.init("bfloat16")`` at 24 x 512, graphed against eager from
    the same weights (``graphed_vs_eager``: the same bits), 12 + 12
    bfloat16 attention and 26 + 26 float32 LayerNorm launches a step."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.contrib import amp
    os.environ["MXNET_FUSED_LAYERNORM"] = "1"
    net, (x, vl, mp), y = _bench_bert(mx, seed, "float32")
    seen_attn, seen_ln = set(), set()
    orig_a = _dtype_spy(attention, "flash_attention_bshd_fwd", seen_attn)
    orig_l = _dtype_spy(layernorm, "layer_norm_fwd", seen_ln)

    def counts(reset=False):
        if reset:
            _reset_counts(attention, layernorm)
        return _bert_counts(attention, layernorm)[0]
    amp.init("bfloat16")
    try:
        r = graphed_vs_eager(
            torch, mx, net, lambda: mx.parallel.DataParallelStep(
                net, _mlm_loss(gluon),
                mx.optimizer.Adam(learning_rate=BERT_LR), mesh=None),
            (x, None, None, vl, mp), y, seed,
            "BERT-base float32 weights under amp.init(bfloat16), "
            "DataParallelStep, Adam", counts=counts,
            per_step=(BERT_ATTN_PER_STEP,) * 2 + (BERT_LN_PER_STEP,) * 2)
    finally:
        amp.disable()
        attention.flash_attention_bshd_fwd = orig_a
        layernorm.layer_norm_fwd = orig_l
    check(seen_attn == {"bfloat16"} and seen_ln == {"float32"},
          "AMP DataParallelStep: attention got %s, LayerNorm %s"
          % (seen_attn, seen_ln))
    check(all(p.data().astorch().dtype == torch.float32
              for p in net.collect_params().values()),
          "AMP DataParallelStep left a weight in another dtype")
    del net
    del os.environ["MXNET_FUSED_LAYERNORM"]
    torch.cuda.empty_cache()
    return r


def symbolic_phase(torch, mx, attention, layernorm, fused_norm, seed, card,
                   profile=False):
    """The Symbolic API and Module on the card: the four paths
    above, each with the hand kernels' counters from 0 just before it and
    read just after; returns their numbers and the seconds of each."""
    t = time.perf_counter()
    clock = {}
    rn = sym_resnet_phase(torch, mx, attention, layernorm, fused_norm, seed,
                          card, profile)
    clock["resnet50_fit"] = time.perf_counter() - t
    t = time.perf_counter()
    bert = sym_bert_phase(torch, mx, attention, layernorm, seed, card,
                          profile)
    clock["bert"] = time.perf_counter() - t
    t = time.perf_counter()
    lm = sym_bucketing_phase(torch, mx, attention, layernorm, fused_norm,
                             seed, card, profile)
    clock["bucketing"] = time.perf_counter() - t
    t = time.perf_counter()
    ampdp = amp_dp_bert_phase(torch, mx, attention, layernorm, seed, card)
    clock["amp_dp"] = time.perf_counter() - t
    return {"resnet": rn, "bert": bert, "lm": lm, "amp_dp": ampdp,
            "seconds": clock}


def print_symbolic(r, card):
    rn, b, lm = r["resnet"], r["bert"], r["lm"]
    print("symbolic: train_imagenet.py ResNet-50 through Module.fit, batch "
          "%d, %d batches: step %.3f ms (median after %d) = %.1f images/s; "
          "Speedometer %.1f samples/s; losses %s; fit %.1f s; peak device "
          "memory %.2f GiB (%s)"
          % (SYM_RN_BATCH, SYM_RN_BATCHES, rn["step_ms"], SYM_RN_SKIP,
             rn["images_per_s"], rn["speedometer"] or 0.0,
             [round(v, 4) for v in rn["losses"]], rn["fit_s"],
             rn["peak_bytes"] / 2 ** 30, card))
    print("symbolic: ResNet-50 step ms %s; checkpoint read back with the "
          "module's bits, Module.load resumed 2 batches (loss %.4f); batch-%d "
          "step card vs CPU: loss %.7g vs %.7g, updates rel L2 %.3g (limit "
          "%g), worst %s %.3g (limit %g)"
          % ([round(v, 3) for v in rn["step_ms_all"]], rn["resume_loss"],
             SYM_RN_PARITY_BATCH, rn["parity"]["loss"][0],
             rn["parity"]["loss"][1], rn["parity"]["update_rel_l2"],
             PARITY_UPDATE_REL_L2, rn["parity"]["worst"][1],
             rn["parity"]["worst"][0], PARITY_PARAM_REL_L2))
    for key, label in (("f32", "float32"),
                       ("bf16", "after amp.convert_model(bfloat16)")):
        s = b[key]
        print("symbolic: BERT-base Module %s, %d x %d, Adam: step %.3f ms "
              "(median of the last %d) = %.0f tokens/s; launches a step "
              "(B, T, H, D) attention fwd %d bwd %d, LayerNorm fwd %d bwd "
              "%d; losses %s; peak device memory %.2f GiB (%s)"
              % (label, BERT_BATCH, BERT_SEQ, s["step_ms"],
                 SYM_BERT_STEPS - 1, BERT_BATCH * BERT_SEQ * 1e3
                 / s["step_ms"], *s["launches_per_step"],
                 [round(v, 4) for v in s["losses"]],
                 s["peak_bytes"] / 2 ** 30, card))
    print("symbolic: SymbolBlock.imports of the float32 checkpoint gives the "
          "Module's forward output with the same bits; 2-layer encoder at 2 x "
          "%d card vs CPU: probabilities rel L2 %.3g (limit %g), gradients "
          "%.3g (limit %g)" % (BERT_PARITY_SEQ, b["parity"]["probs_rel_l2"],
                               BERT_PARITY_REL_L2,
                               b["parity"]["grads_rel_l2"],
                               SYM_PARITY_GRAD_REL_L2))
    print("symbolic: bucketing LM (%d words, %d units, batch %d) through "
          "BucketingModule, buckets %s, %d batches each: perplexity %.2f; "
          "last step ms by bucket %s; %d parameters shared by every bucket: "
          "%s; hand kernel launches %s (%s)"
          % (LM_VOCAB, LM_HIDDEN, LM_BATCH, list(SYM_LM_BUCKETS),
             SYM_LM_BATCHES, lm["perplexity"],
             {k: round(v, 3) for k, v in lm["step_ms"].items()}, lm["params"],
             lm["shared"], lm["launches"], card))
    print_graphed(r["amp_dp"], card)
    for p in (rn["profile"], b["f32"]["profile"], b["bf16"]["profile"],
              lm["profile"]):
        if p is not None:
            print_profiles([p], card)
            print("symbolic: %s: device idle share %.3f (wall %.3f ms, "
                  "device busy %.3f ms) (%s)"
                  % (p["label"], p["device_idle_share"], p["wall_ms"],
                     p["device_busy_ms"], card))
    print("symbolic: phase seconds %s" % ", ".join(
        "%s %.1f" % kv for kv in r["seconds"].items()))


# ---------------------------------------------------------------------------
# compiled training: the Gluon loop (hybridize, record, backward,
# Trainer.step) and Module.fit, each as CUDA graphs and eagerly
# ---------------------------------------------------------------------------

# Steps each way; the first builds the graphs (its warm-up runs every
# kernel once more), the rest replay them.
CT_STEPS = 5
# the graphs each path's first step builds: the block's forward/backward
# pair and the Trainer's update, or the Executor's pair (Module.update
# stays per weight, as in the JAX package)
CT_BUILDS = {"bert": 2, "resnet": 2, "sym_bert": 1, "sym_resnet": 1}
# steps' worth of gradient copies timed between two events
CT_COPY_BURST = 10


class _OneBatchIter:
    """One batch served ``n`` times an epoch, for ``Module.fit``."""

    def __init__(self, mx, names, data, label, n):
        self.batch = mx.io.DataBatch(data=data, label=label, pad=0)
        self.provide_data = [mx.io.DataDesc(k, tuple(d.shape))
                             for k, d in zip(names, data)]
        self.provide_label = [mx.io.DataDesc("softmax_label",
                                             tuple(label[0].shape))]
        self.batch_size = data[0].shape[0]
        self._n, self._i = n, 0

    def __iter__(self):
        return self

    def __next__(self):
        if self._i >= self._n:
            raise StopIteration
        self._i += 1
        return self.batch

    next = __next__

    def reset(self):
        self._i = 0


def _ct_counts(attention, layernorm, fused_norm, reset=False):
    if reset:
        _reset_counts(attention, layernorm)
        fused_norm.LAUNCHES = fused_norm.BWD_LAUNCHES = 0
    return _hand_kernel_launches(attention, layernorm, fused_norm)


def _ct_run(torch, kernels, steps, graphed):
    """``steps`` (a function running CT_STEPS steps, calling its argument
    after each) through the graphs or inside ``cuda_graph.disabled()``:
    each step's ms (synced), the loss each step returns, the launches of
    the first step and of the others (counts from 0 just before each), the
    graphs the first step built and those built after it, and the peak
    device memory."""
    import contextlib
    from mxnet_tpu_torch import cuda_graph, telemetry
    rec = {"ms": [], "losses": []}
    state = {"t": None}
    before = telemetry.compile_counts()

    def mark(loss):
        torch.cuda.synchronize()
        now = time.perf_counter()
        rec["ms"].append((now - state["t"]) * 1e3)
        rec["losses"].append(loss)
        if len(rec["ms"]) == 1:
            rec["first"] = kernels()
            rec["built"] = telemetry.compile_deltas(before)
            state["after"] = telemetry.compile_counts()
            kernels(reset=True)
        state["t"] = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels(reset=True)
    state["t"] = time.perf_counter()
    with (contextlib.nullcontext() if graphed else cuda_graph.disabled()):
        steps(mark)
    rec["rest"] = kernels()
    rec["total"] = {k: tuple(a + b for a, b in zip(v, rec["first"][k]))
                    for k, v in rec["rest"].items()}
    rec["rebuilt"] = telemetry.compile_deltas(state["after"])
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    rec["step_ms"] = statistics.median(rec["ms"][1:])
    n = len(rec["ms"]) - 1
    rec["per_step"] = {k: (f // n, b // n) for k, (f, b) in
                       rec["rest"].items()}
    return rec


def _ct_compare(torch, what, graphed, eager, want, state_g, state_e):
    """The hard checks of one path: the same bits for every loss and every
    tensor of the state after the steps, the launches a step, and no graph
    built after the first step."""
    check(len(graphed["losses"]) == len(eager["losses"]) == CT_STEPS
          and all(torch.equal(a, b) for a, b in zip(graphed["losses"],
                                                    eager["losses"])),
          "%s: graphed losses %s, eager %s" % (
              what, [float(v.float().mean()) for v in graphed["losses"]],
              [float(v.float().mean()) for v in eager["losses"]]))
    differ = sorted(k for k in state_g if not torch.equal(state_g[k],
                                                          state_e[k]))
    check(not differ, "%s: graphed and eager differ after %d steps in %s"
          % (what, CT_STEPS, differ[:8]))
    for run, name in ((graphed, "graphed"), (eager, "eager")):
        got = {k: v for k, v in run["per_step"].items() if any(v)}
        check(got == want and all(
            f % (CT_STEPS - 1) == 0 and b % (CT_STEPS - 1) == 0
            for f, b in run["rest"].values()),
            "%s, %s: launches in %d steps after the first %r, want %r a "
            "step" % (what, name, CT_STEPS - 1, run["rest"], want))
    first = {k: v for k, v in graphed["first"].items() if any(v)}
    check(first == {k: (2 * f, 2 * b) for k, (f, b) in want.items()},
          "%s: the building step launched %r (want twice %r: the warm-up "
          "and the replay)" % (what, first, want))
    check(not graphed["rebuilt"], "%s: graphs built after the first step: "
          "%r" % (what, graphed["rebuilt"]))
    check(not eager["built"] and not eager["rebuilt"],
          "%s: the eager run built graphs %r" % (what, eager["built"]))


def _ct_capture_s(entries):
    """Seconds of the warm-ups and captures of graphs and pairs."""
    return sum((getattr(e, "warmup_s", None) or 0.0)
               + (e.capture_s or 0.0) for e in entries)


def _ct_gluon_graphs(net, trainer):
    out = []
    for rec, _ in net._cached_graph._cache.values():
        out += getattr(rec, "pairs", [rec])
    out += [c for c, _ in trainer._fused._cache.values()]
    return out


def ct_bert(torch, mx, attention, layernorm, fused_norm, seed, card,
            profile):
    """BERT-base bf16 as ``bench.py:_build_bert_step`` builds it (24 x
    512, its valid lengths, 76 masked positions a row, fused LayerNorm),
    Adam at lr 1e-4 through ``gluon.Trainer``, the net hybridized and run
    inside ``record()``/``backward()``/``step()``, then from the same
    weights with ``hybridize(False)`` inside ``cuda_graph.disabled()``;
    and one f32 step of the hybridized net at batch 2 against the CPU."""
    import numpy as onp
    from mxnet_tpu_torch import gluon
    os.environ["MXNET_FUSED_LAYERNORM"] = "1"
    loss_rel, (update_rel, per_param), _ = bert_train_card_vs_cpu(
        torch, mx, seed, hybridize=True, floor=False)
    check(loss_rel <= BERT_TRAIN_PARITY_LOSS_RTOL
          and update_rel <= BERT_TRAIN_PARITY_UPDATE_REL_L2
          and per_param[0][0] <= BERT_TRAIN_PARITY_PARAM_REL_L2,
          "graphed BERT-base f32 step card vs CPU: loss rel %.3g (limit "
          "%g), update rel L2 %.3g (limit %g), worst %s %.3g (limit %g)"
          % (loss_rel, BERT_TRAIN_PARITY_LOSS_RTOL, update_rel,
             BERT_TRAIN_PARITY_UPDATE_REL_L2, per_param[0][1],
             per_param[0][0], BERT_TRAIN_PARITY_PARAM_REL_L2))
    torch.cuda.empty_cache()
    tokens, lens, pos = bert_inputs(seed)
    labels = onp.random.RandomState(seed + 2).randint(
        0, BERT_VOCAB, (BERT_BATCH, BERT_PRED)).astype("float32")
    gpu = mx.gpu(0)
    x = mx.nd.array(tokens, ctx=gpu)
    vl = mx.nd.array(lens, ctx=gpu, dtype="int32")
    mp = mx.nd.array(pos, ctx=gpu, dtype="int32")
    y = mx.nd.array(labels, ctx=gpu)
    net = _bench_bert_bf16(mx, seed, tokens)
    params = net._collect_params_with_prefix()
    w0 = {k: p.data().astorch().detach().clone() for k, p in params.items()}
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    kernels = lambda reset=False: _ct_counts(attention, layernorm,  # noqa
                                             fused_norm, reset)
    runs = {}
    for graphed in (True, False):
        with torch.no_grad():
            for k, p in params.items():
                p.data().astorch().copy_(w0[k])
        net.hybridize(graphed)
        trainer = _adam(mx, net)

        def step():
            return _mlm_step(mx, net, trainer, ce, x, vl, mp, y)[1].astorch()

        def steps(mark):
            for _ in range(CT_STEPS):
                mark(step().detach().clone())
        run = _ct_run(torch, kernels, steps, graphed)
        run["state"] = {k: p.data().astorch().detach().clone()
                        for k, p in params.items()}
        if graphed:
            graphs = _ct_gluon_graphs(net, trainer)
            check(all(g.graphed for g in graphs), "BERT: a graph was not "
                  "captured")
            run["capture_s"] = _ct_capture_s(graphs)
            run["graphs"] = len(graphs)
        if profile:
            run["profile"] = profile_calls(
                torch, step, "compiled training: BERT-base bf16 Trainer "
                "step, %s" % ("graphed" if graphed else "eager"), calls=3)
        runs["graphed" if graphed else "eager"] = run
        del trainer
        torch.cuda.empty_cache()
    g, e = runs["graphed"], runs["eager"]
    check(sum(g["built"].values()) == CT_BUILDS["bert"] == g["graphs"],
          "BERT: the first step built %r" % g["built"])
    _ct_compare(torch, "compiled BERT-base", g, e,
                {"attention_bshd": (BERT_ATTN_PER_STEP, BERT_ATTN_PER_STEP),
                 "layernorm": (BERT_LN_PER_STEP, BERT_LN_PER_STEP)},
                g.pop("state"), e.pop("state"))
    # what the stable gradient buffers cost: the 'write' hooks copy each
    # gradient into its buffer (autograd._move_grad), one copy_ a
    # parameter, timed on the device (CT_COPY_BURST steps' copies between
    # two events, enqueued while a spin kernel holds the card: a step's
    # copies take the host about 3 ms, more than time_cuda's spin covers
    # over its 30 timed launches) and on the host
    bufs = [p.grad().astorch() for p in params.values()
            if p.grad_req != "null"]
    srcs = [b.clone() for b in bufs]

    def copies():
        for b, src in zip(bufs, srcs):
            b.copy_(src)
    copies()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(CT_COPY_BURST):
        copies()
    end.record()
    torch.cuda.synchronize()
    nbytes = sum(b.numel() * b.element_size() for b in bufs)
    grad_copy = {"device_ms": start.elapsed_time(end) / CT_COPY_BURST,
                 "host_us": host_us(torch, copies), "bytes": nbytes,
                 "tensors": len(bufs),
                 "bound_ms": 2 * nbytes / memory_bytes_per_s(card) * 1e3}
    del net, w0, bufs, srcs
    del os.environ["MXNET_FUSED_LAYERNORM"]
    torch.cuda.empty_cache()
    return {"graphed": g, "eager": e, "grad_copy": grad_copy,
            "parity": {"loss_rel": loss_rel, "update_rel_l2": update_rel,
                       "worst": per_param[0]}}


def ct_resnet(torch, mx, attention, layernorm, fused_norm, seed, profile):
    """ResNet-50 v1 at batch 32, SGD (lr 0.1, momentum 0.9, wd 1e-4) in the
    same loop, graphed and eager, under ``cudnn.deterministic``: the same
    bits for the losses, the weights and the running statistics; and one
    step of the hybridized net at batch 2 against the CPU."""
    import numpy as onp
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    gpu = mx.gpu(0)
    mx.random.seed(seed)
    net = resnet50_v1()
    net.initialize(mx.init.Xavier(), ctx=gpu)
    with mx.autograd.predict_mode():
        net(mx.nd.zeros((1, 3, IMAGE_SIZE, IMAGE_SIZE), ctx=gpu))
    rng = onp.random.RandomState(seed)
    data = rng.uniform(-1, 1, (TRAIN_BATCH, 3, IMAGE_SIZE, IMAGE_SIZE)) \
        .astype("float32")
    label = rng.randint(0, 1000, TRAIN_BATCH).astype("float32")
    host0 = _param_arrays(net)
    net.hybridize()
    loss_rel, (update_rel, per_param), _ = card_vs_cpu_step(
        torch, mx, net, host0, data, label, floor=False)
    check(loss_rel <= PARITY_LOSS_RTOL and update_rel <= PARITY_UPDATE_REL_L2
          and per_param[0][0] <= PARITY_PARAM_REL_L2,
          "graphed ResNet-50 step card vs CPU: loss rel %.3g (limit %g), "
          "update rel L2 %.3g (limit %g), worst %s %.3g (limit %g)"
          % (loss_rel, PARITY_LOSS_RTOL, update_rel, PARITY_UPDATE_REL_L2,
             per_param[0][1], per_param[0][0], PARITY_PARAM_REL_L2))
    params = net._collect_params_with_prefix()
    x = mx.nd.array(data, ctx=gpu)
    y = mx.nd.array(label, ctx=gpu)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    kernels = lambda reset=False: _ct_counts(attention, layernorm,  # noqa
                                             fused_norm, reset)
    runs = {}
    for graphed in (True, False):
        for k, p in params.items():
            p.set_data(host0[k])
        net.hybridize(graphed)
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                dict(SGD_PARAMS))

        def step():
            with mx.autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            trainer.step(TRAIN_BATCH)
            return loss.astorch()

        def steps(mark):
            for _ in range(CT_STEPS):
                mark(step().detach().clone())
        run = _ct_run(torch, kernels, steps, graphed)
        run["state"] = {k: p.data().astorch().detach().clone()
                        for k, p in params.items()}
        if graphed:
            graphs = _ct_gluon_graphs(net, trainer)
            check(all(g.graphed for g in graphs), "ResNet-50: a graph was "
                  "not captured")
            run["capture_s"] = _ct_capture_s(graphs)
            run["graphs"] = len(graphs)
        if profile:
            run["profile"] = profile_calls(
                torch, step, "compiled training: ResNet-50 v1 batch %d "
                "Trainer step, %s" % (TRAIN_BATCH, "graphed" if graphed
                                      else "eager"), calls=3)
        runs["graphed" if graphed else "eager"] = run
        del trainer
    g, e = runs["graphed"], runs["eager"]
    check(sum(g["built"].values()) == CT_BUILDS["resnet"] == g["graphs"],
          "ResNet-50: the first step built %r" % g["built"])
    moved = [k for k in params if k.endswith("running_mean")
             and not torch.equal(g["state"][k].cpu(),
                                 torch.from_numpy(host0[k]))]
    check(moved, "ResNet-50: the running statistics did not move")
    _ct_compare(torch, "compiled ResNet-50", g, e,
                {"fused_norm": (16, 16)}, g.pop("state"), e.pop("state"))
    torch.backends.cudnn.deterministic = det
    del net
    torch.cuda.empty_cache()
    return {"graphed": g, "eager": e,
            "parity": {"loss_rel": loss_rel, "update_rel_l2": update_rel,
                       "worst": per_param[0]}}


def _ct_module_runs(torch, mx, kernels, make_mod, names, data, label,
                    optimizer, params, what, profile):
    """``Module.fit`` over one batch served CT_STEPS times, graphed and
    eager, each from a module that ``make_mod()`` builds and initializes
    from the same weights: the runs, with each module's parameters and
    auxiliary states after the fit as ``state``."""
    runs = {}
    for graphed in (True, False):
        mod = make_mod()
        it = _OneBatchIter(mx, names, data, label, CT_STEPS)

        def steps(mark):
            mod.fit(it, num_epoch=1, optimizer=optimizer,
                    optimizer_params=params, eval_metric="acc",
                    batch_end_callback=lambda _: mark(
                        mod.get_outputs()[0].astorch().clone()))
        run = _ct_run(torch, kernels, steps, graphed)
        arg, aux = mod.get_params()
        run["state"] = {k: v.astorch().detach().clone()
                        for k, v in list(arg.items()) + list(aux.items())}
        if graphed:
            graphs = [e for _, e in mod._exec._graphs.values()]
            check(all(e.graphed for e in graphs), "%s: a graph was not "
                  "captured" % what)
            run["capture_s"] = _ct_capture_s(graphs)
            run["graphs"] = len(graphs)
        if profile:
            def one():
                mod.forward_backward(it.batch)
                mod.update()
            run["profile"] = profile_calls(
                torch, one, "compiled training: %s Module step, %s"
                % (what, "graphed" if graphed else "eager"), calls=3)
        runs["graphed" if graphed else "eager"] = run
        del mod
        torch.cuda.empty_cache()
    return runs


def ct_symbolic(torch, mx, attention, layernorm, fused_norm, seed, profile):
    """The symbolic BERT-base of ``sym_bert_phase`` after
    ``amp.convert_model(..., "bfloat16")`` and ``train_imagenet.py``'s
    ResNet-50 (batch 32, under ``cudnn.deterministic``), each through
    ``Module.fit`` on the captured Executor and inside
    ``cuda_graph.disabled()``, from the same weights; the 2-layer
    symbolic BERT's graphed step against the CPU."""
    from mxnet_tpu_torch.contrib import amp
    os.environ["MXNET_FUSED_LAYERNORM"] = "1"
    gpu = mx.gpu(0)
    kernels = lambda reset=False: _ct_counts(attention, layernorm,  # noqa
                                             fused_norm, reset)
    parity = sym_bert_card_vs_cpu(torch, mx, seed)
    sym = bert_symbol(mx.sym, BERT_LAYERS, BERT_UNITS, BERT_HEADS,
                      4 * BERT_UNITS, BERT_VOCAB)
    data, label = _sym_bert_batch(torch, seed, BERT_BATCH, BERT_SEQ,
                                  BERT_PRED)
    init = _sym_bert_module(mx, sym, data, label, gpu)
    mx.random.seed(seed)
    init.init_params(mx.init.Xavier())
    args = _host_params(init)[0]
    del init
    conv, cargs, _ = amp.convert_model(sym, _as_nd(mx, args, mx.cpu()), {},
                                       target_dtype="bfloat16")
    cargs = {k: v.astorch() for k, v in cargs.items()}
    del args
    torch.cuda.empty_cache()

    def make_bert():
        mod = _sym_bert_module(mx, conv, data, label, gpu)
        mod.init_params(arg_params=_as_nd(mx, cargs, gpu))
        return mod
    bert = _ct_module_runs(
        torch, mx, kernels, make_bert, SYM_BERT_DATA,
        [mx.nd.array(d.numpy(), ctx=gpu) for d in data],
        [mx.nd.array(label.numpy(), ctx=gpu)], "adam", SYM_BERT_ADAM,
        "symbolic BERT-base bf16", profile)
    g, e = bert["graphed"], bert["eager"]
    check(sum(g["built"].values()) == CT_BUILDS["sym_bert"] == g["graphs"],
          "symbolic BERT: the first step built %r" % g["built"])
    _ct_compare(torch, "compiled symbolic BERT-base", g, e,
                {"attention_bshd": (BERT_ATTN_PER_STEP, BERT_ATTN_PER_STEP),
                 "layernorm": (BERT_LN_PER_STEP, BERT_LN_PER_STEP)},
                g.pop("state"), e.pop("state"))
    del conv, cargs
    del os.environ["MXNET_FUSED_LAYERNORM"]
    torch.cuda.empty_cache()

    import numpy as onp
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    net = resnet_symbol(mx.sym, 50, 1000)
    shape = (TRAIN_BATCH, 3, IMAGE_SIZE, IMAGE_SIZE)
    rs = onp.random.RandomState(seed)
    x = mx.nd.array(rs.uniform(-1, 1, shape).astype("float32"), ctx=gpu)
    y = mx.nd.array(rs.randint(0, 1000, (TRAIN_BATCH,)).astype("float32"),
                    ctx=gpu)
    init = mx.mod.Module(net, context=gpu)
    init.bind(data_shapes=[("data", shape)],
              label_shapes=[("softmax_label", (TRAIN_BATCH,))])
    mx.random.seed(seed)
    init.init_params(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                    magnitude=2))
    arg0, aux0 = _host_params(init)
    del init

    def make_resnet():
        mod = mx.mod.Module(net, context=gpu)
        mod.bind(data_shapes=[("data", shape)],
                 label_shapes=[("softmax_label", (TRAIN_BATCH,))])
        mod.init_params(arg_params=_as_nd(mx, arg0, gpu),
                        aux_params=_as_nd(mx, aux0, gpu))
        return mod
    resnet = _ct_module_runs(
        torch, mx, kernels, make_resnet, ("data",), [x], [y], "sgd",
        SYM_RN_SGD, "symbolic ResNet-50 (train_imagenet.py)", profile)
    g, e = resnet["graphed"], resnet["eager"]
    check(sum(g["built"].values()) == CT_BUILDS["sym_resnet"]
          == g["graphs"],
          "symbolic ResNet-50: the first step built %r" % g["built"])
    moved = [k for k in aux0 if k.endswith("moving_mean")
             and not torch.equal(g["state"][k].cpu(), aux0[k])]
    check(moved, "symbolic ResNet-50: the moving statistics did not move")
    _ct_compare(torch, "compiled symbolic ResNet-50", g, e, {},
                g.pop("state"), e.pop("state"))
    torch.backends.cudnn.deterministic = det
    torch.cuda.empty_cache()
    return {"bert": bert, "resnet": resnet, "parity": parity}


# the recorded-call cases on the card: an MLP of CT_PAIR_LAYERS dense
# layers of CT_PAIR_WIDTH units and a BatchNorm, batch CT_PAIR_BATCH
CT_PAIR_BATCH, CT_PAIR_WIDTH, CT_PAIR_LAYERS, CT_PAIR_STEPS = 256, 2048, 3, 4
# the create_graph case's second derivatives, graphed against eager
CT_SECOND_REL_L2 = 1e-5


def ct_recorded_cases(torch, mx, seed):
    """The three cases of a recorded call of ``gluon/block.py`` on the
    card, each graphed and eagerly (``hybridize(False)`` inside
    ``cuda_graph.disabled()``) from the same weights, to the same bits:

    * two calls of one key in one ``record()`` with a ``backward()`` each
      (``grad_req`` ``'add'``, SGD with momentum, CT_PAIR_STEPS steps),
      in the order of the calls in even steps and in the other order in
      odd ones: the second call takes a second pair, whose forward saves
      its activations in a pool of its own, out of reach of the first
      pair's backward;
    * ``autograd.grad(..., create_graph=True)`` of an input, then the
      backward of the gradient's square (the eager rerun of the body): the
      gradient the same bits, the second derivatives of the input and the
      parameters within CT_SECOND_REL_L2 relative L2 of eager's (summed
      in another order);
    * dropout in train mode on an input that ``attach_grad``: two replays
      draw two masks, and each gradient is its own forward's mask."""
    import contextlib
    import numpy as onp
    from mxnet_tpu_torch import cuda_graph, gluon
    nn = gluon.nn
    gpu = mx.gpu(0)
    B, W = CT_PAIR_BATCH, CT_PAIR_WIDTH
    rs = onp.random.RandomState(seed + 7)
    batches = [(mx.nd.array(rs.uniform(-1, 1, (B, W)).astype("float32"),
                            ctx=gpu),
                mx.nd.array(rs.randint(0, 10, B).astype("float32"),
                            ctx=gpu)) for _ in range(2 * CT_PAIR_STEPS)]
    mx.random.seed(seed)
    net = nn.HybridSequential(prefix="ctpair_")
    with net.name_scope():
        for _ in range(CT_PAIR_LAYERS):
            net.add(nn.Dense(W, activation="relu", in_units=W))
        net.add(nn.BatchNorm(in_channels=W), nn.Dense(10, in_units=W))
    net.initialize(mx.init.Xavier(), ctx=gpu)
    params = net._collect_params_with_prefix()
    w0 = {k: p.data().astorch().detach().clone() for k, p in params.items()}
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    out = {}

    def two_calls(graphed):
        with torch.no_grad():
            for k, p in params.items():
                p.data().astorch().copy_(w0[k])
        net.hybridize(graphed)
        net.collect_params().setattr("grad_req", "add")
        net.collect_params().zero_grad()
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                dict(SGD_PARAMS))
        losses = []
        for s in range(CT_PAIR_STEPS):
            (x1, y1), (x2, y2) = batches[2 * s], batches[2 * s + 1]
            with mx.autograd.record():
                l1 = ce(net(x1), y1)
                l2 = ce(net(x2), y2)
            for loss in ((l1, l2) if s % 2 == 0 else (l2, l1)):
                loss.backward()
            trainer.step(2 * B)
            net.collect_params().zero_grad()
            losses += [l1.astorch().detach().clone(),
                       l2.astorch().detach().clone()]
        state = {k: p.data().astorch().detach().clone()
                 for k, p in params.items()}
        pairs = [p for rec, _ in net._cached_graph._cache.values()
                 for p in getattr(rec, "pairs", [])] if graphed else []
        net.collect_params().setattr("grad_req", "write")
        return losses, state, pairs

    def second(graphed):
        with torch.no_grad():
            for k, p in params.items():
                p.data().astorch().copy_(w0[k])
        net.hybridize(graphed)
        x = batches[0][0].copy()
        x.attach_grad()
        with mx.autograd.record():
            y = net(x)
            gx = mx.autograd.grad((y * y).sum(), [x], create_graph=True)[0]
            z = (gx * gx).sum()
        z.backward()
        return [gx.astorch().detach().clone(), x.grad.astorch().clone()] \
            + [p.grad().astorch().clone() for p in params.values()
               if p.grad_req != "null"]

    runs = {}
    for graphed in (True, False):
        with (contextlib.nullcontext() if graphed
              else cuda_graph.disabled()):
            runs[graphed] = (two_calls(graphed), second(graphed))
    (gl, gs, pairs), gsec = runs[True]
    (el, es, _), esec = runs[False]
    check(len(pairs) == 2 and all(p.graphed and not p.busy for p in pairs),
          "two calls of one key: %d pairs, graphed %s"
          % (len(pairs), [p.graphed for p in pairs]))
    check(all(torch.equal(a, b) for a, b in zip(gl, el)),
          "two calls of one key: graphed losses %s, eager %s"
          % ([float(v.mean()) for v in gl], [float(v.mean()) for v in el]))
    differ = sorted(k for k in gs if not torch.equal(gs[k], es[k]))
    check(not differ, "two calls of one key, a backward each: graphed and "
          "eager differ after %d steps in %s" % (CT_PAIR_STEPS, differ))
    out["two_calls"] = {"pairs": len(pairs), "steps": CT_PAIR_STEPS,
                        "first_loss": float(gl[0].mean()),
                        "last_loss": float(gl[-1].mean())}
    # the first derivative is the same arithmetic; the second sums the
    # paths through the rerun and through the head gradient in another
    # order than eager autograd
    rel = [float((a.double() - b.double()).norm() / b.double().norm())
           for a, b in zip(gsec, esec)]
    check(torch.equal(gsec[0], esec[0]) and max(rel) <= CT_SECOND_REL_L2,
          "create_graph: the graphed call's first derivative the eager "
          "bits %s, second derivatives rel L2 %s (limit %g)"
          % (torch.equal(gsec[0], esec[0]), rel, CT_SECOND_REL_L2))
    out["create_graph"] = {"rel_l2": max(rel), "tensors": len(gsec)}
    del net, params, w0, runs
    drop = nn.Dropout(0.5, prefix="ctdrop_")
    drop.hybridize()
    x0 = mx.nd.array(rs.uniform(1, 2, (B, W)).astype("float32"), ctx=gpu)
    masks = []
    for _ in range(3):
        x = x0.copy()
        x.attach_grad()
        with mx.autograd.record():
            y = drop(x)
        y.backward()
        yt, g = y.astorch(), x.grad.astorch()
        check(torch.equal(g, (yt != 0).float() * 2.0)
              and torch.allclose(yt, x0.astorch() * g, rtol=1e-6),
              "dropout: a replay's gradient is not its own forward's mask")
        masks.append(yt != 0)
    (rec, _), = drop._cached_graph._cache.values()
    check(rec.pairs[0].graphed and len(rec.pairs) == 1,
          "dropout: the call was not one captured pair")
    share = [float(m.float().mean()) for m in masks]
    check(not torch.equal(masks[0], masks[1])
          and not torch.equal(masks[1], masks[2])
          and all(0.45 < v < 0.55 for v in share),
          "dropout: replays drew the same mask, or kept shares %s" % share)
    out["dropout"] = {"kept_share": share}
    torch.cuda.empty_cache()
    return out


def compiled_training_phase(torch, mx, attention, layernorm, fused_norm,
                            seed, card, profile=False):
    """The recorded-call cases (``ct_recorded_cases``), then the three
    compiled training paths, each graphed and eager in the same run:
    BERT-base bf16 and ResNet-50 v1 through hybridize, record, backward
    and ``Trainer.step``, and the symbolic BERT-base (after
    ``amp.convert_model``) and ResNet-50 through ``Module.fit``.  Prints
    each path's lines as it ends."""
    r = {"recorded": ct_recorded_cases(torch, mx, seed)}
    c = r["recorded"]
    print("compiled training: recorded-call cases on the card (MLP of %d "
          "x %d dense layers and a BatchNorm, batch %d), graphed against "
          "eager to the bits: two calls of one key with a backward each, "
          "in either order, %d steps through %d pairs (loss %.4f -> %.4f); "
          "create_graph second derivatives (%d tensors, rel L2 %.3g); "
          "dropout replays kept %s of a (%d, %d) input, each gradient its "
          "own mask" % (CT_PAIR_LAYERS, CT_PAIR_WIDTH, CT_PAIR_BATCH,
                        c["two_calls"]["steps"], c["two_calls"]["pairs"],
                        c["two_calls"]["first_loss"],
                        c["two_calls"]["last_loss"],
                        c["create_graph"]["tensors"],
                        c["create_graph"]["rel_l2"],
                        [round(v, 4) for v in c["dropout"]["kept_share"]],
                        CT_PAIR_BATCH, CT_PAIR_WIDTH))
    r["bert"] = ct_bert(torch, mx, attention, layernorm, fused_norm, seed,
                        card, profile)
    _print_ct("BERT-base bf16, hybridize + record + Trainer.step (Adam), "
              "%d x %d" % (BERT_BATCH, BERT_SEQ), r["bert"], card,
              "BERT-base f32 batch 2 x %d" % BERT_PARITY_SEQ)
    r["resnet"] = ct_resnet(torch, mx, attention, layernorm, fused_norm,
                            seed, profile)
    _print_ct("ResNet-50 v1, hybridize + record + Trainer.step (SGD), batch "
              "%d" % TRAIN_BATCH, r["resnet"], card,
              "ResNet-50 v1 batch %d" % PARITY_BATCH)
    r["symbolic"] = sym = ct_symbolic(torch, mx, attention, layernorm,
                                      fused_norm, seed, profile)
    _print_ct("symbolic BERT-base after amp.convert_model(bfloat16), "
              "Module.fit (Adam), %d x %d" % (BERT_BATCH, BERT_SEQ),
              sym["bert"], card)
    _print_ct("symbolic ResNet-50 (train_imagenet.py), Module.fit (SGD), "
              "batch %d" % TRAIN_BATCH, sym["resnet"], card)
    print("compiled training: graphed 2-layer symbolic BERT step, card vs "
          "CPU: probabilities rel L2 %.3g, gradients rel L2 %.3g"
          % (sym["parity"]["probs_rel_l2"], sym["parity"]["grads_rel_l2"]))
    return r


def _print_ct(what, p, card, parity_what=None):
    g, e = p["graphed"], p["eager"]
    print("compiled training: %s: step %.3f ms graphed, %.3f ms eager "
          "(median of %d after the first); first step %.3f ms graphed "
          "(warm-up and capture %.3f s), %.3f ms eager; peak %.2f GiB "
          "graphed, %.2f GiB eager; graphs built %d in the first step, %d "
          "after; the same bits (%s)"
          % (what, g["step_ms"], e["step_ms"], CT_STEPS - 1, g["ms"][0],
             g["capture_s"], e["ms"][0], g["peak_bytes"] / 2 ** 30,
             e["peak_bytes"] / 2 ** 30, sum(g["built"].values()),
             sum(g["rebuilt"].values()), card))
    print("compiled training: %s: step ms graphed %s, eager %s"
          % (what, [round(v, 3) for v in g["ms"]],
             [round(v, 3) for v in e["ms"]]))
    print("compiled training: %s: launches a step after the first %s; in "
          "the first step %s"
          % (what, {k: v for k, v in g["per_step"].items() if any(v)},
             {k: v for k, v in g["first"].items() if any(v)}))
    for run in (g, e):
        if "profile" in run:
            prof = run["profile"]
            print("compiled training: %s: device busy %.3f ms a step, idle "
                  "share %.3f, wall %.3f ms (%s)"
                  % (prof["label"], prof["device_busy_ms"],
                     prof["device_idle_share"], prof["wall_ms"], card))
    if "grad_copy" in p:
        c = p["grad_copy"]
        print("compiled training: %s: the 'write' hooks' copies into the "
              "stable gradient buffers: %d tensors, %.1f MB, %.4f ms of "
              "device time a step (bound %.4f ms), %.1f us of host time "
              "(%s)" % (what, c["tensors"], c["bytes"] / 1e6,
                        c["device_ms"], c["bound_ms"], c["host_us"], card))
    if parity_what:
        q = p["parity"]
        print("compiled training: graphed %s step, card vs CPU: loss rel "
              "%.3g, update rel L2 %.3g, worst %s %.3g"
              % (parity_what, q["loss_rel"], q["update_rel_l2"],
                 q["worst"][1], q["worst"][0]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace bucket-1 and bucket-8 model calls, "
                         "the hybridized forward, ResNet training steps, "
                         "BERT forwards, BERT training steps, the AMP "
                         "steps (float16 and bfloat16), the "
                         "data-parallel steps (graphed), the LSTM LM "
                         "steps, the vision zoo's batch-128 forwards and "
                         "its Inception v3 step with torch.profiler and "
                         "print where the "
                         "device time goes and which hand kernels ran "
                         "inside the replays")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.ops import attention, fused_norm, layernorm

    card = card_line()
    print("card: %s" % card)
    print("torch %s, CUDA %s, %d device(s)" % (
        torch.__version__, torch.version.cuda, torch.cuda.device_count()))
    print("TF32 before: cudnn.allow_tf32=%s cuda.matmul.allow_tf32=%s" % (
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("TF32 set off for the whole run")

    t0 = time.perf_counter()
    kernels.build(kernels.SOURCES)
    build_s = time.perf_counter() - t0
    for name in kernels.SOURCES:
        kernels.load(name)
        for r in kernels.ptxas_report(kernels.build_log(name)):
            print("ptxas %s: %s: %s registers, spill %d/%d bytes "
                  "(stores/loads)" % (name, r["kernel"], r["registers"],
                                      r["spill_stores"], r["spill_loads"]))
            check(not (r["kernel"].startswith(HOPPER_KERNELS + TF32_KERNELS)
                       and r["spill_stores"] + r["spill_loads"]),
                  "%s spills registers" % r["kernel"])
    print("kernels built in %.2f s: %s" % (build_s, ", ".join(kernels.SOURCES)))
    hopper_occupancy(torch, attention)
    print("sass: HMMA TF32 instructions of the float32 attention kernels: %s"
          % json.dumps(tf32_sass_check(kernels)))

    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    clock = [("build", time.perf_counter() - t0)]
    t_phase = time.perf_counter()

    def mark(name):
        nonlocal t_phase
        now = time.perf_counter()
        clock.append((name, now - t_phase))
        t_phase = now
    rows = kernel_phase(torch, fused_norm, card, flush)
    attn_rows = attention_cases(torch, attention, card, flush, args.seed)
    side_by_side = short_seq_side_by_side(torch, attention, card, flush,
                                          args.seed)
    ln_rows = layernorm_cases(torch, layernorm, card, flush, args.seed)
    attn_bwd_rows = attention_bwd_cases(torch, attention, card, flush,
                                        args.seed)
    ln_bwd_rows = layernorm_bwd_cases(torch, layernorm, card, flush,
                                      args.seed)
    bshd_rows = attention_bshd_cases(torch, attention, card, flush,
                                     args.seed)
    sublayer = sublayer_side_by_side(torch, attention, card, flush,
                                     args.seed)
    del flush
    torch.cuda.empty_cache()
    public = public_op_phase(torch, mx, attention, args.seed, card)
    mark("kernels")

    res = serving_phase(torch, mx, fused_norm, args.seed, N_REQUESTS,
                        profile=args.profile)
    print("serving: %d requests, start %.2f s, dispatches per bucket %s, "
          "kernel launches %d, max rel err vs batch-1 %.3g"
          % (res["requests"], res["start_s"], res["dispatches"],
             res["launches"], res["max_rel_err"]))
    print("serving: request latency p50 %.3f ms p99 %.3f ms; bucket-8 model "
          "call %.3f ms = %.1f images/s (%s)"
          % (res["p50_ms"], res["p99_ms"], res["bucket8_ms"],
             res["bucket8_images_per_s"], card))
    print("serving: model call ms per bucket %s; first latencies ms %s"
          % ({b: round(v, 3) for b, v in res["call_ms"].items()},
             res["first_latencies_ms"]))
    print("graphs: serving: one CUDA graph a bucket, captured largest "
          "first from one pool in %s s; bucket-8 call %.3f ms graphed, %.3f "
          "ms with the same body run eagerly (host batch in, host logits "
          "out) (%s)" % ({b: round(v, 3) for b, v in res["capture_s"].items()},
                         res["bucket8_ms"], res["bucket8_eager_ms"], card))
    print_profiles(res["profiles"], card)
    for p in res["profiles"]:
        print("graphs: %s: the hand kernels in one replay's trace: %s"
              % (p["label"], sorted(set(_kernel_names_check(
                  p, "resnet_forward")))))
    hyb = hybrid_forward_phase(torch, mx, fused_norm, args.seed, card,
                               profile=args.profile)
    print("graphs: hybridized ResNet-50 v1 forward at batch %d "
          "(_CachedGraph): %d calls, epilogue launches %d, the eager "
          "forward's bits; %.3f ms a call graphed, %.3f ms eager (median); "
          "capture %.3f s; peak device memory %.2f GiB (%s)"
          % (HYBRID_BATCH, hyb["calls"], hyb["launches"], hyb["graphed_ms"],
             hyb["eager_ms"], hyb["capture_s"], hyb["peak_bytes"] / 2 ** 30,
             card))
    if "profile" in hyb:
        print_profiles([hyb["profile"]], card)
        print("graphs: hybridized forward: the hand kernels in one replay's "
              "trace: %s" % sorted(set(hyb["profile_kernels"])))

    mark("serving")
    train = training_phase(torch, mx, fused_norm, args.seed, card,
                           profile=args.profile)
    print("training: ResNet-50 v1 batch %d, %d steps, losses %s"
          % (TRAIN_BATCH, train["steps"],
             [round(v, 4) for v in train["losses"]]))
    print("training: step %.3f ms (median of %d) = %.1f images/s, peak "
          "device memory %.2f GiB, epilogue launches fwd %d bwd %d, card vs "
          "CPU check %.1f s (%s)"
          % (train["step_ms"], TIMED_STEPS, train["images_per_s"],
             train["peak_bytes"] / 2 ** 30, train["fwd_launches"],
             train["bwd_launches"], train["parity_s"], card))
    print("training: step ms %s" % [round(v, 3) for v in train["step_ms_all"]])
    print_profiles(train["profiles"], card)

    mark("training")
    bert = bert_phase(torch, mx, attention, layernorm, args.seed, card,
                      profile=args.profile)
    print("bert: BERT-base bf16 forward, batch %d x %d (%d valid tokens), "
          "%d forwards: %.3f ms median of %d = %.0f tokens/s (%.0f valid "
          "tokens/s), peak device memory %.2f GiB, launches (B, T, H, D) "
          "attention %d LayerNorm %d, bf16 vs f32 sequence output rel L2 "
          "%.3g (%s)"
          % (BERT_BATCH, BERT_SEQ, bert["valid_tokens"], bert["forwards"],
             bert["forward_ms"], BERT_TIMED, bert["tokens_per_s"],
             bert["valid_tokens_per_s"], bert["peak_bytes"] / 2 ** 30,
             bert["attention_launches"], bert["layernorm_launches"],
             bert["bf16_vs_f32_rel_l2"], card))
    print("bert: forward ms %s" % [round(v, 3)
                                   for v in bert["forward_ms_all"]])
    print("bert: default route (composed LayerNorm, MXNET_FUSED_LAYERNORM "
          "unset): forward %.3f ms  (%s)" % (bert["default_route_forward_ms"],
                                            card))
    print_profiles(bert["profiles"], card)
    torch.cuda.empty_cache()
    mark("bert")

    # the array surface on the MLM logits of the BERT path: counts from 0
    # just before, read just after; no TPU kernel of the repo lies on it
    _reset_counts(attention, layernorm)
    fused_norm.LAUNCHES = fused_norm.BWD_LAUNCHES = 0
    arr = array_phase(torch, mx, bert.pop("logits"), args.seed, card)
    arr_launches = {
        "fused_norm": (fused_norm.LAUNCHES, fused_norm.BWD_LAUNCHES),
        "attention": (attention.LAUNCHES, attention.BWD_LAUNCHES),
        "attention_bshd": (attention.BSHD_LAUNCHES,
                           attention.BSHD_BWD_LAUNCHES),
        "layernorm": (layernorm.LAUNCHES, layernorm.BWD_LAUNCHES)}
    print("array: hand-written kernel launches on the path (forward, "
          "backward): %s; sweep %.1f s" % (arr_launches, arr["sweep_s"]))
    check(all(v == (0, 0) for v in arr_launches.values()),
          "the array surface launched a hand-written kernel")
    mark("array")
    btrain = bert_training_phase(torch, mx, attention, layernorm, args.seed,
                                 card, profile=args.profile)
    print("bert training: BERT-base bf16 MLM step, batch %d x %d (%d valid "
          "tokens), Adam lr %g, %d steps, losses %s"
          % (BERT_BATCH, BERT_SEQ, btrain["valid_tokens"], BERT_LR,
             btrain["steps"], [round(v, 4) for v in btrain["losses"]]))
    print("bert training: step %.3f ms (median of %d) = %.0f tokens/s (%.0f "
          "valid tokens/s), peak device memory %.2f GiB, launches (B, T, H, "
          "D) attention fwd %d bwd %d, LayerNorm fwd %d bwd %d, card vs CPU "
          "check %.1f s (%s)" % (btrain["step_ms"], BERT_TRAIN_TIMED,
                    btrain["tokens_per_s"], btrain["valid_tokens_per_s"],
                    btrain["peak_bytes"] / 2 ** 30,
                    btrain["attention_launches"],
                    btrain["attention_bwd_launches"],
                    btrain["layernorm_launches"],
                    btrain["layernorm_bwd_launches"], btrain["parity_s"],
                    card))
    print("bert training: step ms %s" % [round(v, 3)
                                         for v in btrain["step_ms_all"]])
    print_profiles(btrain["profiles"], card)
    torch.cuda.empty_cache()

    # mixed precision: BERT-base's step under amp.init, float16 then
    # bfloat16; then the wide head dims' encoders
    mark("bert training")
    amp16 = bert_amp_phase(torch, mx, attention, layernorm, args.seed, card,
                           "float16", profile=args.profile)
    print_amp(amp16, card)
    torch.cuda.empty_cache()
    amp_bf16 = bert_amp_phase(torch, mx, attention, layernorm, args.seed,
                              card, "bfloat16", profile=args.profile)
    print_amp(amp_bf16, card)
    torch.cuda.empty_cache()
    mark("amp")
    wide = wide_encoder_phase(torch, mx, attention, layernorm, args.seed,
                              card)
    mark("wide heads")
    # float16 models cast whole (ResNet-50 served, inferred at batch 128
    # and trained; BERT-base's forward and step): each path's counts from
    # 0 just before it, read just after
    f16res, f16bert = float16_phases(torch, mx, fused_norm, attention,
                                     layernorm, args.seed, card,
                                     args.profile)
    mark("float16")
    # BERT-base in float32 on the three-TF32 attention kernels: counts from
    # 0 just before each of its paths, read just after
    f32bert = f32_bert_phase(torch, mx, attention, layernorm, args.seed,
                             card, profile=args.profile)
    print_f32_bert(f32bert, card)
    mark("float32 bert")

    # data-parallel training: one rank, NCCL (the card has no peer here)
    import torch.distributed as dist
    mx.parallel.initialize()
    try:
        dpb, dpr = dp_phases(torch, mx, attention, layernorm, fused_norm,
                             args.seed, card, btrain, train, args.profile)
        mark("data parallel")
        # the ops of the layers slice (SyncBatchNorm on this group): counts
        # from 0 just before, read just after; no TPU kernel lies on them
        _reset_counts(attention, layernorm)
        fused_norm.LAUNCHES = fused_norm.BWD_LAUNCHES = 0
        nnl = nn_layers_phase(torch, mx, args.seed, card, dist.group.WORLD)
        nn_launches = _hand_kernel_launches(attention, layernorm, fused_norm)
        mark("nn layers")
        # the rest of training: AdamW's BERT step (ZeRO on this group), the
        # Estimator's ResNet-50 fed by DataLoader workers, the new rules,
        # losses and metrics; each path's counts from 0 just before it
        rest = training_rest_phase(torch, mx, attention, layernorm,
                                   fused_norm, args.seed, card,
                                   mx.parallel.device_mesh())
    finally:
        dist.destroy_process_group()
    print("nn: %d cases of %d ops on the card against the CPU, forward and "
          "backward, within rel %g; SyncBatchNorm's all-reduces on the NCCL "
          "group %d; hand-written kernel launches on the path (forward, "
          "backward): %s" % (len(nnl["rows"]), len(nnl["ops"]), NN_RTOL,
                             nnl["sync_all_reduces"], nn_launches))
    check(all(v == (0, 0) for v in nn_launches.values()),
          "the layers' ops launched a hand-written kernel")
    mark("training rest")
    # the LSTM LM path: counts from 0 just before, read just after; no TPU
    # kernel of the repo lies on it (its recurrence is cuDNN's)
    _reset_counts(attention, layernorm)
    fused_norm.LAUNCHES = fused_norm.BWD_LAUNCHES = 0
    lm = lstm_lm_phase(torch, mx, args.seed, card, profile=args.profile)
    lm_launches = _hand_kernel_launches(attention, layernorm, fused_norm)
    print_lstm_lm(lm, card)
    print("lstm lm: hand-written kernel launches on the path (forward, "
          "backward): %s" % lm_launches)
    print("graphs: every path above ran captured; no module of the port "
          "is kept eager by a rule (cuDNN's LSTM, its weight compaction "
          "included, captures from the graph's pool)")
    mark("lstm lm")
    # the vision zoo: each of its paths counts the epilogue's launches from
    # 0 just before it and reads them just after (ResNet-152 v1: 50 a
    # forward; the other families and the Inception step: none); the
    # attention and LayerNorm kernels lie on none of them
    _reset_counts(attention, layernorm)
    zoo = vision_zoo_phase(torch, mx, fused_norm, layernorm, args.seed, card,
                           profile=args.profile)
    zoo_other = _hand_kernel_launches(attention, layernorm, fused_norm)
    zoo_other.pop("fused_norm")
    check(all(v == (0, 0) for v in zoo_other.values()),
          "the vision zoo launched an attention or LayerNorm kernel: %s"
          % zoo_other)
    mark("vision zoo")
    # the Symbolic API and Module: each path's counts from 0 just before
    # it, read just after
    symb = symbolic_phase(torch, mx, attention, layernorm, fused_norm,
                          args.seed, card, profile=args.profile)
    print_symbolic(symb, card)
    mark("symbolic")
    # compiled training: each path's counts from 0 just before each of its
    # runs, read just after
    ct = compiled_training_phase(torch, mx, attention, layernorm, fused_norm,
                                 args.seed, card, profile=args.profile)
    mark("compiled training")
    print("phase seconds: %s" % ", ".join("%s %.1f" % c for c in clock))
    ct_paths = {"compiled_bert": ct["bert"],
                "compiled_resnet50": ct["resnet"],
                "compiled_sym_bert_bf16": ct["symbolic"]["bert"]}

    def ct_launches(kernel, way):
        """Each compiled path's launches of ``kernel`` (forward ``way`` 0,
        backward 1) over its graphed run and its eager run."""
        out = {}
        for path, r in ct_paths.items():
            for run in ("graphed", "eager"):
                n = r[run]["total"][kernel][way]
                if n:
                    out["%s_%s" % (path, run)] = n
        return out
    sym_f32 = symb["bert"]["f32"]["launches"]
    sym_bf16 = symb["bert"]["bf16"]["launches"]
    amp_dp = symb["amp_dp"]["launches"]


    def per_pass(direction, path, key):
        return sum(r[key] * r["launches_per_pass"] for r in rows[direction]
                   if r["path"] == path)

    def numbers(direction, path):
        return {k: per_pass(direction, path, k)
                for k in ("ms", "plain_ms", "bound_ms")}

    no_library = "no single PyTorch call computes it"
    fwd_entry = dict(
        name="fused_bn_add_relu_epilogue", route="cuda",
        source="mxnet_tpu_torch/csrc/fused_norm.cu",
        replaces="mxnet_tpu/ops/pallas_fused_norm.py:45",
        launches=train["fwd_launches"],
        max_abs_err=max(r["max_abs_err"] for r in rows["fwd"]
                        if r["dtype"] != "float16"),
        bound_by="bytes", library_ms=None,
        launches_by_path={"serving": res["launches"],
                          "hybrid_forward": hyb["launches"],
                          "training": train["fwd_launches"],
                          "dp_resnet": dpr["dp"]["fwd_launches"],
                          "dp_resnet_trainer_nccl":
                          dpr["trainer_nccl"]["fwd_launches"],
                          "lstm_lm": lm_launches["fused_norm"][0],
                          "nn_layers": nn_launches["fused_norm"][0],
                          "resnet152_inference":
                          zoo["infer"]["resnet152_v1"]["launches"],
                          "vision_zoo": sum(r["launches"] for r in
                                            zoo["infer"].values())
                          + sum(r["launches"]
                                for r in zoo["parity"].values())
                          + zoo["train"]["launches"][0],
                          "estimator_resnet50":
                          rest["estimator"]["launches"][0],
                          "training_rest_sweeps":
                          rest["sweep_launches"]["fused_norm"][0],
                          **ct_launches("fused_norm", 0)},
        serving=numbers("fwd", "serve"),
        resnet152_inference=numbers("fwd", "infer152"),
        per="ms/plain_ms/bound_ms: one batch-32 ResNet-50 training step (16 "
            "launches at the train shapes below); serving: one bucket-8 "
            "forward; resnet152_inference: one batch-128 ResNet-152 v1 "
            "forward (50 launches at the infer152 shapes); launches: the "
            "training path's %d steps; library: %s"
            % (train["steps"], no_library),
        shapes=rows["fwd"], **numbers("fwd", "train"))
    bwd_entry = dict(
        name="fused_bn_add_relu_epilogue_bwd", route="cuda",
        source="mxnet_tpu_torch/csrc/fused_norm.cu",
        replaces="mxnet_tpu/ops/pallas_fused_norm.py:52",
        launches=train["bwd_launches"],
        max_abs_err=max(r["max_abs_err"] for r in rows["bwd"]
                        if r["dtype"] != "float16"),
        max_rel_err_sums=max(r["max_rel_err_sums"] for r in rows["bwd"]
                             if r["dtype"] != "float16"),
        bound_by="bytes", library_ms=None,
        launches_by_path={"training": train["bwd_launches"],
                          "dp_resnet": dpr["dp"]["bwd_launches"],
                          "dp_resnet_trainer_nccl":
                          dpr["trainer_nccl"]["bwd_launches"],
                          "lstm_lm": lm_launches["fused_norm"][1],
                          "estimator_resnet50":
                          rest["estimator"]["launches"][1],
                          **ct_launches("fused_norm", 1)},
        per="ms/plain_ms/bound_ms: one batch-32 ResNet-50 training step (16 "
            "launches at the train shapes below); launches: the training "
            "path's %d steps; library: %s" % (train["steps"], no_library),
        shapes=rows["bwd"], **numbers("bwd", "train"))

    def per_forward(rows_, weights, key):
        return sum(r[key] * weights.get(r["case"], 0) for r in rows_)

    def variant_of(row):
        """The kernel variant a case runs: bf16, f16 and f32 at D <= 128,
        and D 192 (from 129) and 256 (from 193) in every dtype."""
        D = row["shape"][4]
        if D > 192:
            return "d256"
        if D > 128:
            return "d192"
        return {"float16": "f16", "float32": "f32"}.get(row["dtype"], "bf16")

    # a BERT-base forward: 25 LayerNorm launches on 24 x 512 rows and one
    # on the 24 x 76 masked rows
    ln_w = {"bert": BERT_LN_PER_FWD - 1, "bert_decoder": 1}
    ln_entry = dict(
        name="layer_norm_fwd", route="cuda",
        source="mxnet_tpu_torch/csrc/layernorm.cu",
        replaces="mxnet_tpu/ops/pallas_layernorm.py:34",
        launches=bert["layernorm_launches"],
        launches_by_path={"bert_forward": bert["layernorm_launches"],
                          "bert_training": btrain["layernorm_launches"],
                          "bert_amp_f16": amp16["layernorm_launches"],
                          "bert_amp_bf16": amp_bf16["layernorm_launches"],
                          "dp_bert": dpb["plain"]["launches"][2],
                          "dp_bert_zero_nccl": dpb["zero"]["launches"][2],
                          "dp_bert_adamw":
                          rest["adamw"]["plain"]["launches"][2],
                          "dp_bert_adamw_zero_nccl":
                          rest["adamw"]["zero"]["launches"][2],
                          "dp_bert_adamw_graphed_vs_eager":
                          rest["adamw"]["graph"]["launches"][2],
                          "lstm_lm": lm_launches["layernorm"][0],
                          "sym_bert_f32": sym_f32[2],
                          "sym_bert_bf16": sym_bf16[2],
                          "dp_bert_amp_bf16": amp_dp[2],
                          **ct_launches("layernorm", 0)},
        max_abs_err=max(r["max_abs_err"] for r in ln_rows
                        if r["dtype"] != "float16"),
        bound_by="bytes",
        per="ms/plain_ms/bound_ms/library_ms: one BERT-base bf16 forward "
            "(25 launches at the case 'bert', one at 'bert_decoder'); "
            "launches: the BERT path's %d forwards; library: "
            "torch.nn.functional.layer_norm" % bert["forwards"],
        shapes=ln_rows,
        **{k: per_forward(ln_rows, ln_w, k)
           for k in ("ms", "plain_ms", "bound_ms", "library_ms")})
    ln_bwd_entry = dict(
        name="layer_norm_bwd", route="cuda",
        source="mxnet_tpu_torch/csrc/layernorm.cu",
        replaces="mxnet_tpu/ops/pallas_layernorm.py:47",
        launches=btrain["layernorm_bwd_launches"],
        launches_by_path={"bert_training": btrain["layernorm_bwd_launches"],
                          "bert_amp_f16": amp16["layernorm_bwd_launches"],
                          "bert_amp_bf16":
                          amp_bf16["layernorm_bwd_launches"],
                          "dp_bert": dpb["plain"]["launches"][3],
                          "dp_bert_zero_nccl": dpb["zero"]["launches"][3],
                          "dp_bert_adamw":
                          rest["adamw"]["plain"]["launches"][3],
                          "dp_bert_adamw_zero_nccl":
                          rest["adamw"]["zero"]["launches"][3],
                          "dp_bert_adamw_graphed_vs_eager":
                          rest["adamw"]["graph"]["launches"][3],
                          "lstm_lm": lm_launches["layernorm"][1],
                          "sym_bert_f32": sym_f32[3],
                          "sym_bert_bf16": sym_bf16[3],
                          "dp_bert_amp_bf16": amp_dp[3],
                          **ct_launches("layernorm", 1)},
        max_abs_err=max(r["max_abs_err"] for r in ln_bwd_rows
                        if r["dtype"] != "float16"),
        sums_max_rel_err=max(r["sums_max_rel_err"] for r in ln_bwd_rows
                             if r["dtype"] != "float16"),
        bound_by="bytes",
        per="ms/plain_ms/bound_ms/library_ms: one BERT-base bf16 training "
            "step (25 launches at the case 'bert', one at 'bert_decoder'); "
            "launches: the BERT training path's %d steps; library: the "
            "backward of torch.nn.functional.layer_norm" % btrain["steps"],
        shapes=ln_bwd_rows,
        **{k: per_forward(ln_bwd_rows, ln_w, k)
           for k in ("ms", "plain_ms", "bound_ms", "library_ms")})

    def attention_entries(variant, case, bhtd_paths, bshd_paths, per,
                          extra):
        """The four entries of one attention kernel variant, named with
        ``_<variant>`` (no suffix for bf16 at D <= 128): the
        (B, H, T, D) forward and backward and the (B, T, H, D) pair, each
        timed as 12 launches at ``case``.  ``bhtd_paths`` and
        ``bshd_paths`` map each path beside the public op to its
        (forward, backward) launches, None where a path runs one way only;
        a (B, H, T, D) entry's launches are the public op's, a
        (B, T, H, D) entry's those of its first path that way.  ``per``
        and ``extra`` hold each entry's note and further keys."""
        suffix = "" if variant == "bf16" else "_" + variant
        pub = public["by_variant"][variant]
        w = {case: BERT_ATTN_PER_FWD}
        a_rows = [r for r in attn_rows if variant_of(r) == variant]
        b_rows = [r for r in attn_bwd_rows if variant_of(r) == variant]
        s_rows = [r for r in bshd_rows if variant_of(r) == variant]

        def case_of(rows_):
            return [r for r in rows_ if r["case"] == case][0]

        def timed(rows_, prefix=""):
            # float32 also gives the bound on fp32 FMAs beside the
            # three-TF32 one
            keys = ("ms", "plain_ms", "bound_ms", "library_ms") + \
                (("ffma_bound_ms",) if variant == "f32" else ())
            return {k: per_forward(rows_, w, prefix + k) for k in keys}

        def by_path(paths, way, public_op):
            out = {k: v[way] for k, v in paths.items() if v[way] is not None}
            out["public_op"] = public_op
            return out
        bshd_fwd = by_path(bshd_paths, 0, pub["bshd_fwd"])
        bshd_bwd = by_path(bshd_paths, 1, pub["bshd_bwd"])
        bwd_replaces = ["mxnet_tpu/ops/pallas_attention.py:773",
                        "mxnet_tpu/ops/pallas_attention.py:732",
                        "mxnet_tpu/ops/pallas_attention.py:866"]
        common = dict(route="cuda",
                      source="mxnet_tpu_torch/csrc/flash_attention.cu")
        return [
            dict(name="flash_attention_fwd" + suffix,
                 replaces="mxnet_tpu/ops/pallas_attention.py:313",
                 also_replaces="mxnet_tpu/ops/pallas_attention.py:219",
                 launches=pub["bhtd_fwd"],
                 launches_by_path=by_path(bhtd_paths, 0, pub["bhtd_fwd"]),
                 max_abs_err=max(r["max_abs_err"] for r in a_rows),
                 bound_by=case_of(a_rows)["bound_by"],
                 per=per["fwd"], shapes=a_rows, **common,
                 **extra.get("fwd", {}), **timed(a_rows)),
            dict(name="flash_attention_bwd" + suffix,
                 replaces="mxnet_tpu/ops/pallas_attention.py:827",
                 also_replaces=bwd_replaces,
                 launches=pub["bhtd_bwd"],
                 launches_by_path=by_path(bhtd_paths, 1, pub["bhtd_bwd"]),
                 max_abs_err=max(r["max_abs_err"] for r in b_rows),
                 max_rel_err=max(r["max_rel_err"] for r in b_rows),
                 bound_by=case_of(b_rows)["bound_by"],
                 per=per["bwd"], shapes=b_rows, **common,
                 **timed(b_rows)),
            dict(name="flash_attention_bshd_fwd" + suffix,
                 replaces="mxnet_tpu/ops/pallas_attention.py:566",
                 launches=next(iter(bshd_fwd.values())),
                 launches_by_path=bshd_fwd,
                 max_abs_err=max(r["max_abs_err"] for r in s_rows),
                 bound_by=case_of(s_rows)["bound_by"],
                 per=per["bshd_fwd"], shapes=s_rows, **common,
                 **extra.get("bshd_fwd", {}), **timed(s_rows)),
            dict(name="flash_attention_bshd_bwd" + suffix,
                 replaces="mxnet_tpu/ops/pallas_attention.py:1136",
                 launches=next(iter(bshd_bwd.values())),
                 launches_by_path=bshd_bwd,
                 max_abs_err=max(r["bwd_max_abs_err"] for r in s_rows),
                 max_rel_err=max(r["bwd_max_rel_err"] for r in s_rows),
                 bound_by=case_of(s_rows)["bwd_bound_by"],
                 per=per["bshd_bwd"], shapes=s_rows, **common,
                 **timed(s_rows, "bwd_")),
        ]

    # bf16 at D <= 128: 12 launches a BERT-base layer stack at the case
    # "bert"
    attention_list = attention_entries(
        "bf16", "bert",
        bhtd_paths={"bert_forward": (bert["bhtd_attention_launches"], None),
                    "bert_training": btrain["bhtd_attention_launches"],
                    "lstm_lm": lm_launches["attention"]},
        bshd_paths={"bert_forward": (bert["attention_launches"], None),
                    "bert_training": (btrain["attention_launches"],
                                      btrain["attention_bwd_launches"]),
                    "bert_amp_bf16": (amp_bf16["attention_launches"],
                                      amp_bf16["attention_bwd_launches"]),
                    "dp_bert": tuple(dpb["plain"]["launches"][:2]),
                    "dp_bert_zero_nccl": tuple(dpb["zero"]["launches"][:2]),
                    "dp_bert_adamw":
                    tuple(rest["adamw"]["plain"]["launches"][:2]),
                    "dp_bert_adamw_zero_nccl":
                    tuple(rest["adamw"]["zero"]["launches"][:2]),
                    "dp_bert_adamw_graphed_vs_eager":
                    tuple(rest["adamw"]["graph"]["launches"][:2]),
                    "lstm_lm": lm_launches["attention_bshd"],
                    "sym_bert_bf16": tuple(sym_bf16[:2]),
                    "dp_bert_amp_bf16": tuple(amp_dp[:2]),
                    **{k: (v, ct_launches("attention_bshd", 1)[k])
                       for k, v in ct_launches("attention_bshd",
                                               0).items()}},
        per={"fwd": "ms/plain_ms/bound_ms/library_ms: 12 launches at the "
                    "case 'bert' (what a BERT-base bf16 forward at 24 x 512 "
                    "would take through this entry; the BERT path runs the "
                    "(B, T, H, D) entry); launches: the public op path "
                    "(nd.flash_attention under autograd); library: "
                    "scaled_dot_product_attention with the same boolean "
                    "mask",
             "bwd": "ms/plain_ms/bound_ms/library_ms: 12 launches at the "
                    "case 'bert' (what a BERT-base bf16 training step at "
                    "24 x 512 would take through this entry); launches: the "
                    "public op path (nd.flash_attention under autograd); "
                    "library: the backward of scaled_dot_product_attention "
                    "with the same boolean mask",
             "bshd_fwd": "ms/plain_ms/bound_ms/library_ms: one BERT-base "
                         "bf16 forward at 24 x 512 (12 launches at the case "
                         "'bert', q, k and v strided views of the projection "
                         "output); launches: the BERT path's %d forwards; "
                         "library: scaled_dot_product_attention on the same "
                         "views with the same boolean mask" % bert["forwards"],
             "bshd_bwd": "ms/plain_ms/bound_ms/library_ms: one BERT-base "
                         "bf16 training step at 24 x 512 (12 launches at the "
                         "case 'bert', the gradient written into one "
                         "(B, T, 3 H D) tensor); launches: the BERT training "
                         "path's %d steps; library: the backward of "
                         "scaled_dot_product_attention on the same views"
                         % btrain["steps"]},
        extra={"fwd": {"short_seq_vs_composed": side_by_side},
               "bshd_fwd": {"sublayer_vs_bhtd": sublayer}})
    # the other variants: float16, float32 (the three-TF32 kernels), and D
    # 192 and 256 (bf16 at BERT-base's width; every dtype in the cases),
    # each timed as 12 launches at its BERT-width case, its launches from
    # the path that runs it
    for variant, case, path_note, bshd_paths in (
            ("f16", "f16_bert", "the AMP float16 BERT-base step's",
             {"bert_amp_f16": (amp16["attention_launches"],
                               amp16["attention_bwd_launches"]),
              "f16_bert_forward": (f16bert["forward"]["launches"][0],
                                   None),
              "f16_bert_step": tuple(f16bert["step"]["launches"][:2])}),
            ("f32", "f32_bert", "the float32 BERT-base forward's and step's",
             {"f32_bert_forward": (f32bert["forward"]["launches"][0], None),
              "f32_bert_step": tuple(f32bert["step"]["launches"][:2]),
              "sym_bert_f32": tuple(sym_f32[:2])}),
            ("d192", "d192_bert", "the D 192 encoder's forward and step",
             {"wide_encoder_d192": (wide[192]["forward_launches"][0]
                                    + wide[192]["step_launches"][0],
                                    wide[192]["step_launches"][1])}),
            ("d256", "d256_bert", "the D 256 encoder's forward and step",
             {"wide_encoder_d256": (wide[256]["forward_launches"][0]
                                    + wide[256]["step_launches"][0],
                                    wide[256]["step_launches"][1])})):
        note = ("ms/plain_ms/bound_ms/library_ms: 12 launches at the case "
                "'%s' (BERT-base's layer at 24 x 512); launches: " % case)
        public_note = note + "the public op path (nd.flash_attention)"
        attention_list += attention_entries(
            variant, case, {}, bshd_paths,
            per={"fwd": public_note, "bwd": public_note,
                 "bshd_fwd": note + path_note, "bshd_bwd": note + path_note},
            extra={})
    # the float16 instantiations: the epilogue forward timed as
    # one batch-128 forward, its backward as one batch-32 step, LayerNorm
    # as one BERT-base float16 forward or step (25 launches at "f16", one
    # at "f16_decoder")
    inf16, srv16, tr16 = f16res["infer"], f16res["serve"], f16res["train"]
    f16_fwd_rows = [r for r in rows["fwd"] if r["dtype"] == "float16"]
    f16_bwd_rows = [r for r in rows["bwd"] if r["dtype"] == "float16"]
    f16_entries = [
        dict(name="fused_bn_add_relu_epilogue_f16", route="cuda",
             source="mxnet_tpu_torch/csrc/fused_norm.cu",
             replaces="mxnet_tpu/ops/pallas_fused_norm.py:45",
             launches=inf16["launches"],
             launches_by_path={"f16_inference": inf16["launches"],
                               "f16_serving": srv16["launches"],
                               "f16_training": tr16["launches"][0]},
             max_abs_err=max(r["max_abs_err"] for r in f16_fwd_rows),
             bound_by="bytes", library_ms=None,
             serving=numbers("fwd", "serve_f16"),
             per="ms/plain_ms/bound_ms: one ResNet-50 v1 float16 forward at "
                 "batch %d (16 launches at the infer_f16 shapes); serving: "
                 "one bucket-8 forward; launches: the batch-%d forward's %d "
                 "graphed calls; library: %s"
                 % (F16_INFER_BATCH, F16_INFER_BATCH, inf16["calls"],
                    no_library),
             shapes=f16_fwd_rows, **numbers("fwd", "infer_f16")),
        dict(name="fused_bn_add_relu_epilogue_bwd_f16", route="cuda",
             source="mxnet_tpu_torch/csrc/fused_norm.cu",
             replaces="mxnet_tpu/ops/pallas_fused_norm.py:52",
             launches=tr16["launches"][1],
             launches_by_path={"f16_training": tr16["launches"][1]},
             max_abs_err=max(r["max_abs_err"] for r in f16_bwd_rows),
             max_rel_err_sums=max(r["max_rel_err_sums"]
                                  for r in f16_bwd_rows),
             bound_by="bytes", library_ms=None,
             per="ms/plain_ms/bound_ms: one batch-32 ResNet-50 v1 float16 "
                 "training step (16 launches at the train_f16 shapes); "
                 "launches: the float16 DataParallelStep's %d graphed "
                 "steps; library: %s" % (GRAPH_STEPS + GRAPH_TIMED,
                                         no_library),
             shapes=f16_bwd_rows, **numbers("bwd", "train_f16"))]
    ln16_w = {"f16": BERT_LN_PER_FWD - 1, "f16_decoder": 1}
    for name, ln_rows_, way, replaces, lib in (
            ("layer_norm_fwd_f16", ln_rows, 2, 34, "layer_norm"),
            ("layer_norm_bwd_f16", ln_bwd_rows, 3, 47,
             "the backward of layer_norm")):
        f16_ln = [r for r in ln_rows_ if r["dtype"] == "float16"]
        by_path = {"f16_bert_step": f16bert["step"]["launches"][way]}
        if way == 2:
            by_path["f16_bert_forward"] = f16bert["forward"]["launches"][2]
        entry = dict(
            name=name, route="cuda",
            source="mxnet_tpu_torch/csrc/layernorm.cu",
            replaces="mxnet_tpu/ops/pallas_layernorm.py:%d" % replaces,
            launches=by_path.get("f16_bert_forward",
                                 by_path["f16_bert_step"]),
            launches_by_path=by_path,
            max_abs_err=max(r["max_abs_err"] for r in f16_ln),
            bound_by="bytes",
            per="ms/plain_ms/bound_ms/library_ms: one BERT-base float16 %s "
                "(25 launches at the case 'f16', one at 'f16_decoder'); "
                "launches: the float16 BERT %s; library: "
                "torch.nn.functional.%s in float16"
                % ("forward" if way == 2 else "training step",
                   "forward's %d graphed calls" % f16bert["forward"]["calls"]
                   if way == 2 else "step's %d graphed steps"
                   % (GRAPH_STEPS + GRAPH_TIMED), lib),
            shapes=f16_ln,
            **{k: per_forward(f16_ln, ln16_w, k)
               for k in ("ms", "plain_ms", "bound_ms", "library_ms")})
        if way == 3:
            entry["sums_max_rel_err"] = max(r["sums_max_rel_err"]
                                            for r in f16_ln)
        f16_entries.append(entry)
    entries = [fwd_entry, bwd_entry, ln_entry, ln_bwd_entry] \
        + f16_entries + attention_list
    for e in entries:
        check(e["launches"] > 0, "%s: launched no time on its path"
              % e["name"])
        e["launches_by_path"]["array_surface"] = 0   # checked above
        e["launches_by_path"].setdefault("nn_layers", 0)   # checked above
        e["launches_by_path"].setdefault("vision_zoo", 0)   # checked above
        # the rule, loss and metric sweeps: checked in their phase
        e["launches_by_path"].setdefault("training_rest_sweeps", 0)
        e["launches_by_path"].setdefault("estimator_resnet50", 0)
        # the symbolic ResNet-50 and the bucketing LM: this kernel's count
        # from each path's run (each checked 0 there for every kernel, so
        # the counters that the dtypes share give each variant's)
        kernel, way = _counter_of(e["name"])
        for path, key in (("sym_resnet50", "resnet"),
                          ("sym_bucketing_lm", "lm")):
            e["launches_by_path"][path] = \
                symb[key]["launches"][kernel][way]
    print("attention sublayer, the layer's choice: (B, T, H, D) %.4f ms "
          "against (B, H, T, D) with transposes %.4f ms forward and "
          "backward  (%s)" % (sublayer["bshd"], sublayer["bhtd"], card))
    print(card)                       # as nvidia-smi prints it
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
