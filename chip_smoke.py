#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

Run from the root of a checkout::

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits nonzero):

1. device  -- require CUDA; print the card's name and power limit.
2. build   -- build every hand-written kernel from ``mxnet_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together; a library that an
   earlier run left in ``_build/`` is removed first); print each flash
   instantiation's registers, spill bytes (``-Xptxas -v``) and dynamic
   shared memory, and ptxas's performance warnings; a spill in the bf16
   flash forward or in an fp32 flash kernel fails the phase, and so do an
   fp32 kernel's local-memory stack frame and an fp32 instantiation (K1,
   K2, K3) without TF32 tensor-core instructions (``HMMA...TF32`` in
   ``cuobjdump -sass`` of the built libraries).
3. kernels -- hold each kernel against its plain PyTorch version on the card
   at the main paths' shapes (and ragged/causal edge cases, each in fp32
   and bf16), and time the kernel, the plain version and the PyTorch
   library call (by CUDA events around back-to-back calls; the kernel and
   the library call also by device time from a profiler trace): K1 (flash
   forward), then K2 and K3 (flash backward: dQ, and dK/dV); each must
   also repeat bitwise; then the LSE-cotangent rule once against autograd
   through the plain forward, and, in fp32 and bf16, K2 and K3 on one
   score past the fp32 range with a finite LSE (P = 0 there, as in the
   reference) and K1 on one score of -inf past the range.  All three run
   on the tensor cores: in bf16 K1 on wgmma with TMA loads, K2 and K3 on
   mma.sync; in fp32 all three on mma.sync as three TF32 products a
   product (the 3xTF32 split, which the build phase checks in the SASS).
   Every fp32 bound counts its operations three times at the TF32 peak.
   K1's, K2's and K3's bf16 times at the training shape are printed as
   multiples of the SDPA forward and backward, K1's fp32 time at the
   serving shape as a multiple of SDPA's fp32 forward, and K2's and K3's
   fp32 times as multiples of SDPA's fp32 backward.
4. slice   -- the serving path: BERT-base (12 x 768 x 12, fp32, T = 512,
   seeded random weights) behind Servable -> ModelHost.deploy -> Batcher ->
   ServeServer/serve_forever, answering 32 PREDICT requests from 8
   ServeClient threads; every answer is checked against an in-process
   forward through the plain attention composition, and the flash kernel's
   launch count against 12 x dispatched micro-batches (warm-up included).
5. bf16    -- the same model cast to bfloat16, one 8 x 512 forward through
   the kernel; its deviation from the fp32 answer is printed for the record.
6. train   -- the training path: BERT-base with the MLM decoder (vocab
   30522, T = 512, dropout 0, ``initializer.Normal(0.02)`` from a seed)
   under ``parallel.TrainStep`` (SGD, lr 1e-3, momentum 0.9, mean MLM
   cross-entropy in fp32), as ``bench.py --bert`` runs it.  (a) fp32,
   batch 2, one step: every gradient and updated parameter against the same
   step through the composition.  (b) bf16, batch 16: 2 warm and 10 timed
   steps on one batch; every loss finite, the last below the first, each
   within 1e-2 relative of the composition's trajectory, and K1, K2 and K3
   launched 12 times a step; tokens/s, TFLOP/s and MFU by the bench's
   formula, and a profiler breakdown of one step.
7. user_kernels -- K4, the user-kernel facility (``mxnet_tpu_torch/
   tpu_kernel.py``): the seven bodies of ``USER_KERNELS`` (CUDA C++ source
   strings, templates over float and __nv_bfloat16, moving 16 bytes a load
   and a store on a grid of a few blocks an SM) built with one ``nvcc``
   each, all started together, and run at BERT-base's FFN activation
   (16 * 512, 3072) in fp32 and bf16 through ``Kernel.launch``, through
   ``nd.<name>`` after ``tpu_kernel.register`` and, for square and scale3,
   forward and backward under ``autograd.record()``; each held against its
   plain version (fp32 within 1e-6, bf16 by ``compare``'s bf16 rule);
   re-registration launches the new body, the non-differentiable op gives
   no gradient, a CPU launch without ``plain`` raises; times of kernel,
   plain version and one PyTorch call (by CUDA events, and the kernel's
   and the library call's also by device time), and the byte bound.  Then
   every body against its plain version at a ragged size (8191, 3071), an
   odd 1-D length and on a view one element past a 16-byte boundary (the
   scalar loop), and ``double`` once more on the facility's default grid
   (one thread an entry), timed beside its explicit grid.
8. imperative -- BERT-base with the MLM decoder (as in ``train``) driven
   only through the front end: ``nd.array(..., ctx=mx.gpu(0))``,
   ``autograd.record()``, ``net(...)``, the loss block, ``.mean()``,
   ``backward()`` and the parameters' ``.grad``.  (a) fp32, batch 2: every
   gradient against ``functionalize`` + torch autograd on the same batch
   and parameters (max|d| <= 1e-5 * max|ref| per tensor), and a second
   ``backward()`` that overwrites rather than adds.  (b) bf16, batch 16:
   2 warm and 5 timed passes, the loss finite, K1, K2 and K3 launched 12
   times a pass; ms per pass beside ``train``'s ms per step.
9. resnet -- ``resnet50_v1`` at full width (1000 classes, 224 x 224,
   ``initializer.Xavier`` from the seed; convolutions, batch norm and
   pooling on PyTorch's library kernels, none of K1-K4).  (a) fp32, batch
   2, with ``torch.backends.cudnn.allow_tf32`` set True, so that only the
   convolution op's own scope keeps TF32 off: one ``TrainStep`` step on
   the card against the same step on a CPU copy (loss within 1e-4
   relative, each parameter's change within 0.1 of the CPU's in L2 norm,
   beside the CPU fp32 step's own distance from an fp64 step; the running
   statistics unchanged on both), a predict-mode forward's logits within
   2e-3 x max|CPU|, and ``autograd.record()`` + ``backward()`` on
   NDArrays: gradients within 1e-5 x max|ref| of the functionalize path's
   (both with ``cudnn.deterministic``), running statistics written as a
   training forward writes them on the CPU.  (b) The bench's configuration (``bench.py run_bench``): bf16,
   batch 256, SGD lr 0.1, momentum 0.9, the fp32 log-softmax loss, 2 warm
   and 10 timed steps on one batch; every loss finite, the first within
   2e-2 relative of the fp32 loss of the same parameters and batch, no
   launch of K1-K4; images/s, step ms, TFLOP/s and MFU by the bench's
   formula (3 x 3.87 GFLOP an image), peak memory, and a profiler
   breakdown of one step with its device idle share.
10. eager -- the Gluon eager training loop (``gluon.Trainer``, the
   optimizers, ``metric``), no kernel of its own.  (a) ``resnet18_v1``
   (1000 classes, 224 x 224, ``Xavier`` from the seed) as ``bench.py
   --eager`` runs it: fp32, batch 64, ``record()``/``backward()``,
   ``Trainer.step`` (SGD lr 0.1, momentum 0.9, the fused multi-tensor
   apply), ``metric.Accuracy``, the host batch copied to the card every
   step; one ``Trainer.step`` held against one ``TrainStep`` step from the
   same parameters and batch under ``cudnn.deterministic`` (loss and every
   trainable parameter within 1e-6 relative, L2), then 3 warm and 10
   timed steps: images/s, step ms (and again with the batch already on
   the card), peak memory, one traced step's idle share and kernel
   groups, and the optimizer apply's kernels, device time and wall time;
   no launch of K1-K4.  (b) BERT-base with the MLM decoder (bf16,
   batch 16) through ``record()``/``backward()`` and ``Trainer.step(1)``
   (SGD lr 1e-3, momentum 0.9): 2 warm and 5 timed steps, each loss within
   1e-2 relative of ``TrainStep``'s trajectory from the same start, K1,
   K2 and K3 launched 12 times a step (counted under ``eager``), ms per
   step beside ``train``'s and one traced step's idle share.  (c) SGD
   (plain; momentum with wd and ``clip_gradient``), NAG, Adam, AdamW and
   LAMB, each in fp32 and in bf16 with ``multi_precision``, fused and with
   ``aggregate_num=0``: one step on the card against the same step on the
   CPU (fp32 within 1e-6 + 1e-5 |ref|; bf16 weights by ``compare``'s bf16
   rule against the CPU's float32 master).
11. amp -- ``mx.amp``, the dtype policy at the registered-op dispatch.
   (a) BERT-base with the MLM decoder (batch 16, T = 512, dropout 0) with
   fp32 parameters under ``amp.init()`` (bf16), through ``record()``/
   ``backward()``, ``amp.init_trainer``, ``amp.scale_loss`` and
   ``Trainer.step(1)``: 2 warm and 5 timed steps, each loss within 1e-2
   relative of the same steps with attention on the composition, the first
   within 1e-2 of the fp32 loss, K1, K2 and K3 launched 12 times a step
   (counted under ``amp``) and in bf16 (the traced step's kernel names),
   every parameter still float32; ms a step, tokens/s, MFU, one traced
   step's idle share, the casts' device time (``aten::_to_copy``) and the
   kernel groups.  (b) ``bench.py --eager``'s ``resnet18_v1`` (batch 64,
   batch on the card) in fp32 and under ``amp.init()``: 4 steps each from
   the same parameters, the AMP losses within 1e-2 of fp32's, 10 timed
   steps each (images/s); every convolution's inputs bf16 and every batch
   norm's fp32 during one traced AMP step.  (c) The same net under
   ``amp.init(target_dtype="float16")`` with the dynamic ``LossScaler``: a
   step whose gradient is forced to inf leaves every weight and momentum
   bitwise unchanged and halves the scale; the next step updates.  (b) and
   (c) launch none of K1-K4.
12. data -- the input pipeline (``io.DevicePrefetcher``, ``gluon.data``,
   ``recordio``, ``mx.random``, ``image.ImageDetIter``), no kernel of its
   own, none of K1-K4 launched (the counts are set to 0 at the start of
   (a) and of (e) and read at the end of (d) and of (e): the ``data`` and
   ``det`` paths).  First the allocator hazard of the prefetcher's side stream: 8
   prefetched 64 MB batches, each read by a reduction queued behind ~25
   ms of matmuls and then dropped, must each read back their own values.
   (a) The eager ``resnet18_v1`` step of ``eager`` fed ``bench.py
   --eager``'s stream (one seeded host batch, copied every step) with and
   without the prefetcher: 4 steps each way from the same parameters
   under ``cudnn.deterministic`` with bitwise equal per-image losses, then
   3 warm and 10 timed steps each way: images/s, step ms, the data-wait
   total and share against the reference's 5 % gate, one traced step's
   idle share.  (b) ``SyntheticImageDataset`` (224 x 224 x 3 uint8, 100
   class prototypes) with ``ToTensor`` and ``Normalize`` through a
   ``DataLoader`` (batch 64, shuffled, spawned workers, ``pin_memory``)
   and a prefetcher into the same step: the loader's images/s alone, the
   loop's images/s, step ms and data-wait share, a worker's time by part;
   every batch that reached the card bitwise equal to the in-process
   loader's under the same numpy seed.  (c) 512 seeded raw records (0 to
   150,528 bytes, one holding the magic) through the native RecordIO
   writer and ``MXIndexedRecordIO`` in a shuffled order, bitwise, and
   the pure-Python writer and reader against them; MB/s.  (d) 10^6 draws
   on the card of each ``_random_*`` row of ``tests/test_random.py``'s
   moment table within its tolerances, bitwise repeatable under one seed,
   the uniform draws through its chi-square test; the time of 10^6
   uniform and normal draws.  (e) The SSD-300 input: ``ImageDetIter`` over
   an indexed .rec of 128 seeded 375 x 500 PNG images with 1-8 boxes each
   (no JPEG decode on the card's machine), ``CreateDetAugmenter``'s chain
   (``rand_crop=0.5, rand_pad=0.5, rand_mirror=True, mean=True,
   std=True``), batches of 32 with labels padded to 8, through the
   prefetcher to the card: images/s, every batch bitwise equal to the
   same iterator's CPU batches; then ``_image_random_hue``, the rotation
   (``GridGenerator`` + ``BilinearSampler``) and ``BilinearSampler`` on a
   (32, 3, 300, 300) batch on the card within 1e-5 of the CPU's.
13. ssd -- SSD-300 training (BASELINE config 4; ``ssd_300_vgg16_voc``,
   20 classes, ``Xavier`` from the seed, fp32 with the convolutions' TF32
   off), no kernel of its own, none of K1-K4 launched (the counts are set
   to 0 at its start and read at its end: the ``ssd`` path).  The 128
   records of (e) through ``ImageDetIter`` (the same augmenters, batch 32,
   labels padded to 8) and ``io.DevicePrefetcher``, trained by the
   reference's loop (``examples/train_ssd.py``: ``record()``, the net,
   ``net.targets`` (``MultiBoxTarget``), ``SSDMultiBoxLoss``,
   ``backward()``, ``gluon.Trainer.step``; SGD lr 0.1, momentum 0.9).
   Checks: 8,732 anchors within 1e-6 of the CPU's ``MultiBoxPrior``;
   ``MultiBoxTarget`` (negative mining ratio 3) on the first batch on the
   card and the CPU, class targets and masks exactly equal, box targets
   within 1e-5 x max|CPU|; ``MultiBoxDetection`` (``nms_topk`` 400) on
   one set of class probabilities, the same rows with the same class
   ids, scores and boxes within 1e-5; one fp32 step at batch 2 on the card
   against a CPU copy (the loss within 1e-4 relative, each parameter's
   change within 0.1 in L2, as the resnet phase holds its step); every
   loss finite, the last of 10 steps on one repeated batch below the
   first.  Printed: images/s fed by the prefetcher (one epoch) and with
   the batch on the card, the step split (forward + loss,
   ``MultiBoxTarget``, backward, ``Trainer.step``) by CUDA events,
   TFLOP/s and fp32 MFU (3 x the convolutions' forward FLOP counted from
   their shapes), one traced step's idle share and kernels, the peak
   memory, ``net.detect``'s ms and ``VOC07MApMetric`` over the fed
   batches, the phase's seconds.
14. lm -- BASELINE config 3, ``examples/word_lm.py``'s LSTM language
   model (``Embedding`` -> ``rnn.LSTM`` -> ``Dropout`` -> ``Dense`` -> the
   tied decoder; upstream MXNet's medium PTB widths: vocabulary 10,000,
   embedding and hidden 650, 2 layers, dropout 0.5; bptt 35, batch 20;
   word_lm.py's offline 40,000-token corpus, 57 steps), no kernel of its
   own: the fused ``RNN`` op on PyTorch's RNN, cuDNN's on the card, none
   of K1-K4 launched (the counts are set to 0 at its start and read at its
   end: the ``lm`` path).  (a) The fp32 op (2-layer LSTM) forward and
   backward on the card against the CPU with ``cudnn.allow_tf32`` True:
   outputs and states within 1e-4 x max|CPU|, each gradient within 1e-4
   relative in L2; (b) the same for one bidirectional GRU layer with
   ``sequence_length`` (one length 0, one 35); (c) one step at dropout 0
   against a CPU copy: the loss within 1e-4 relative, each parameter's
   update within 1e-4 relative in L2 and applied within float32's
   rounding; (d) one epoch at dropout 0.5 through ``gluon.Trainer`` (SGD
   lr 1.0, ``clip_gradient`` 0.25, the states detached between steps):
   every loss finite, the last 10 steps' mean below the first 10's; (e)
   a traced step runs ``aten::_cudnn_rnn`` and cuDNN's RNN kernels.
   Printed: words/s, the step split by CUDA events, TFLOP/s and fp32 MFU,
   the idle share and top kernels of a traced step, the peak memory, the
   op's forward and forward + backward ms, the phase's seconds.
15. zoo -- vgg16, alexnet, densenet121, squeezenet1.1, mobilenet1.0,
   mobilenetv2_1.0 (224 px) and inceptionv3 (299 px), 1000 classes,
   ``Xavier`` from the seed, fp32; no kernel of their own, none of K1-K4
   launched (the ``zoo`` path).  Each: a predict-mode forward at batch 2
   on the card within 1e-4 x max|CPU| of a CPU copy (``cudnn.allow_tf32``
   True), then 5 SGD steps (lr 0.01, momentum 0.9) through
   ``gluon.Trainer`` on one repeated batch of 32, every loss finite and the
   last below the first; images/s of the last 3 steps, the peak memory.
16. dist -- data-parallel training across processes, no kernel of its own
   (the exchange is NCCL's or gloo's collectives; K1-K3 run in
   BERT-base and are counted under ``dist``).  Each part is started by
   the port's launcher, ``python -m mxnet_tpu_torch.tools.launch``, as a
   subprocess with a time limit, and its ranks print one record each.
   (a) ``-n 1``, NCCL on ``cuda:0``: BERT-base with the MLM decoder at the
   bench's configuration (bf16, batch 16, T = 512, dropout 0) takes 3
   steps through ``Trainer(kvstore="ici")`` (``allreduce_grads`` timed by
   CUDA events, then ``update``) and 3 through ``Trainer(kvstore=None)``
   from the same parameters and batch: the first step's gradients come
   out of the exchange bitwise unchanged (the sum over one rank is the
   identity, so the buckets' flatten and split keep every bit), the
   losses and the weights are bitwise equal, K1, K2 and K3 launch 12
   times a step; printed: the bucket plan (count and bytes, solo keys)
   and the exchange's ms a step; then 2-bit and int8 compression of one
   4 MB bucket, two pushes, on the card against the CPU: codes, scales,
   packed words and residuals bitwise equal.  (b) ``-n 2`` with both
   ranks on ``cuda:0`` over gloo (NCCL refuses two ranks on one card):
   BERT-base fp32 (K1-K3 in 3xTF32), the global batch of 16 as two halves
   of 8, 2 steps through ``Trainer(kvstore="ici")`` (its exchange timed
   by CUDA events), then 2 through the dp ``TrainStep`` from a fresh
   copy; the weights bitwise equal across
   the ranks (sha256 of every parameter), and on rank 0 each tensor within
   1e-4 x max|ref| of one process's run on the whole batch.  (c) Part (b)
   on NCCL over ``cuda:0`` and ``cuda:1`` where the machine has two cards;
   with one card the phase prints that (c) did not run.
17. ps -- the dist_async parameter server, no kernel of its own (the
   servers apply SGD on the host; K1-K3 run in BERT-base on the workers
   and are counted under ``ps``).  Each part is started by
   ``python -m mxnet_tpu_torch.tools.launch -n N -s S`` as a subprocess
   with a time limit; the worker's loop is
   ``examples/train_dist_async.py``'s (``kv.init`` of every parameter,
   ``kv.set_optimizer``, a pull, then per step forward, backward and a
   ``kv.push(i, grad)`` / ``kv.pull(i, out=weight)`` a parameter), on
   BERT-base with the MLM decoder (fp32, K1-K3 in 3xTF32, batch 8 a
   worker, T = 512, dropout 0).  (a) ``-n 1 -s 1``: 3 steps with the
   server's SGD (momentum 0.9), then the same 3 from the same weights
   and batches with a local updater on the card: step 1's loss bitwise
   equal, every weight within 1e-4 x max|ref|; printed: the push and
   pull ms a step (host clock) and each leg's wire bytes a step.  (c)
   One more server step under ``profiler.set_config(profile_all=True,
   device_trace_dir=...)``: the torch.profiler chrome trace names K1-K3's
   kernels, and ``profiler.dumps()`` telemetry's ``kv.client.PUSH`` and
   ``kv.client.PULL`` spans.  (b) ``-n 2 -s 2``, both ranks on ``cuda:0``
   on their own data, plain SGD (lr 0.1): 2 steps each, then on rank 0
   every weight is w0 - 0.1 (S_0 + S_1) within 1e-5 x max|w0| (max|w|
   for a tensor that starts at 0), S_r the float64 sum of rank r's pushed
   gradients, while the control w0 - 0.1 S_0 fails on most tensors (the
   word embedding and the decoder are split across both servers).  (d)
   The ten ops ``ops/nn.py`` gained (``AdaptiveAvgPooling2D``,
   ``BilinearResize2D`` shrinking and enlarging, ``UpSampling``,
   ``softmin``, ``SoftmaxOutput``, ``RMSNorm`` and the three
   ``*RegressionOutput``) on the card against the CPU, output and
   gradient within 1e-5 x max(1, |ref|).
18. resume -- supervised training: ``checkpoint`` (on
   ``torch.distributed.checkpoint``), ``health`` and the launcher's
   supervisor, no kernel of their own (K1-K3 run in BERT-base and are
   counted under ``resume``).  (a) In this process, BERT-base with the MLM
   decoder at the bench's configuration (bf16, batch 16, T = 512): 3
   ``TrainStep`` steps, ``save``, a fresh step's ``restore`` and 3 more
   steps equal 6 uninterrupted steps bitwise, parameters and momenta;
   ``CheckpointManager(max_to_keep=2)`` over 3 saves keeps the last 2; a
   save killed by an armed ``checkpoint.commit:crash`` leaves the previous
   checkpoint restorable and bitwise intact; printed: the save and restore
   seconds and GB/s.  (b) ``chip_smoke.py --resume-worker`` (BERT-base
   fp32, batch 8, T = 128, 2 epochs of 4 batches, each batch a function of
   the seed, the epoch and the batch) under ``python -m
   mxnet_tpu_torch.tools.launch``: the uninterrupted ``-n 1`` run; ``-n 2
   --restart on-failure --max-restarts 2 --fault
   worker.step:crash:after=5`` (both ranks restarted, resumed from epoch
   0's checkpoint); ``-n 1`` with ``worker.step:delay:delay=60,after=5``
   under ``MX_STEP_TIMEOUT`` (the watchdog's exit 86, named by the
   supervisor) and under ``--hang-timeout`` (the stale rank killed and
   restarted).  (c) ``-n 1 --elastic --resize-file F --drain-timeout 60``,
   F set to 2 once rank 0's checkpoint directory appears: rank 0 drains
   at an epoch boundary and resumes, rank 1 joins under generation 1.  The
   five jobs run at once; each exits 0 with every rank's final parameters
   within rtol 1e-5 / atol 1e-6 of the uninterrupted run's (the largest
   difference and whether they are bitwise printed), and every worker
   process launched each of K1-K3 12 times a step it ran, replays
   included.  Printed: the restart-to-first-step latency of each
   restarted process, the drain's time and which interleaving happened.

The last lines of standard output are the ``nvidia-smi`` name and power
limit, one JSON object ``{"kernels": [...]}`` and, last,
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or mxnet_tpu.
"""
from __future__ import annotations

import gc
import json
import os
import re
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

SEED = 20261017
BUCKETS = (1, 2, 4, 8)
SEQ_LEN = 512
N_REQUESTS = 32
N_CLIENTS = 8
SLICE_TOL = 2e-3
TRAIN_BATCH = 16
TRAIN_LR, TRAIN_MOMENTUM = 1e-3, 0.9
TRAIN_WARM, TRAIN_TIMED = 2, 10
VOCAB = 30522

# Data-sheet peaks (dense) of the card this script was measured on, by the
# name torch reports: HBM bytes/s, fp32 FLOP/s on CUDA cores, bf16 and TF32
# FLOP/s on tensor cores.  Add a row before running on another card.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm": 3.35e12, "fp32": 67e12, "bf16": 989e12,
                              "tf32": 495e12},
}


def log(*args):
    print(*args, flush=True)


def emit(line):
    """Write one whole line of a process that shares its standard output
    with others (a launcher's ranks): one write call, so that two ranks'
    lines never interleave, even unbuffered (``PYTHONUNBUFFERED``, where
    ``print`` writes the text and the newline apart)."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    if name not in PEAKS:
        raise RuntimeError("chip_smoke: no data-sheet peaks for %r; add its "
                           "row to PEAKS" % name)
    peaks = PEAKS[name]
    # float32 products in full fp32: the comparisons below need it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device: %s | torch %s cuda %s | %s" % (
        name, torch.__version__, torch.version.cuda, smi))
    log("device: peaks %s" % json.dumps(peaks))
    return smi, name, peaks


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

def phase_build():
    from mxnet_tpu_torch.ops import _kernels
    for lib in _kernels.LIBRARIES:
        # build anew from the sources, so that nvcc's report below exists
        # on a second run in the same checkout too
        lib.library_path().unlink(missing_ok=True)
    t0 = time.perf_counter()
    secs = _kernels.build_all()
    log("build: %s in %.2f s wall" % (json.dumps(secs),
                                      time.perf_counter() - t0))
    tf32_mma = tf32_mma_counts()
    faults = []
    for r in flash_instantiations():
        if r["kernel"].endswith("_tf32_kernel"):
            r["tf32_mma"] = tf32_mma.get((r["kernel"], r["d"]), 0)
            if not r["tf32_mma"]:
                faults.append("no TF32 tensor-core instruction in %s" % r)
        log("build: flash instantiation %s" % json.dumps(r))
        if (r["kernel"] == "flash_fwd_bf16_kernel" or
                r["kernel"].endswith("_tf32_kernel")) and (
                r["spill_store_bytes"] or r["spill_load_bytes"]):
            faults.append("ptxas spilled registers in %s" % r)
        if r["kernel"].endswith("_tf32_kernel") and r["stack_bytes"]:
            # accumulators indexed by a loop ptxas did not unroll
            faults.append("a local-memory stack frame in %s" % r)
    for lib in (_kernels.FLASH_FWD, _kernels.FLASH_BWD):
        for line in lib.build_log.splitlines():
            if "Performance Loss" in line or "setmaxnreg" in line:
                log("build: %s: ptxas: %s" % (lib.name, line.strip()))
    if faults:
        raise RuntimeError("build: " + "; ".join(faults))


_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_SPILLS = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                     r"(\d+) bytes spill loads")
_KERNEL = re.compile(r"(flash_(?:fwd|bwd_dq|bwd_dkv)(?:_bf16|_tf32)?_kernel)I"
                     r"(f|13__nv_bfloat16)?Li(\d+)E")
_SASS_FUNCTION = re.compile(r"Function : (\S+)")
_SASS_TF32_MMA = re.compile(r"\bHMMA\.\S*TF32")


def tf32_mma_counts():
    """{(kernel, D): TF32 HMMA instructions} of the fp32 flash
    instantiations (K1, K2, K3), from ``cuobjdump -sass`` of the built
    libraries; raises when ``cuobjdump`` is missing or fails."""
    from mxnet_tpu_torch.ops import _kernels
    tool = os.path.join(os.path.dirname(_kernels.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        raise RuntimeError("cuobjdump not found beside nvcc (%s)" % tool)
    sass = "".join(subprocess.run(
        [tool, "-sass", str(lib.library_path())], capture_output=True,
        text=True, timeout=300, check=True).stdout
        for lib in (_kernels.FLASH_FWD, _kernels.FLASH_BWD))
    counts, cur = {}, None
    for line in sass.splitlines():
        m = _SASS_FUNCTION.search(line)
        if m:
            k = _KERNEL.search(m.group(1))
            tf32 = k is not None and k.group(1).endswith("_tf32_kernel")
            cur = (k.group(1), int(k.group(3))) if tf32 else None
            if cur is not None:
                counts[cur] = 0
        elif cur is not None and _SASS_TF32_MMA.search(line):
            counts[cur] += 1
    if len(counts) != 6:
        raise RuntimeError("expected the SASS of 6 fp32 flash "
                           "instantiations (K1, K2, K3 x D 64, 128), found "
                           "%s" % counts)
    return counts


def flash_instantiations():
    """Each flash kernel instantiation's registers, spill bytes and stack
    (``nvcc -Xptxas -v`` in the libraries' build logs) and the dynamic
    shared memory its launch asks for (the libraries'
    ``mx_flash_*_smem``)."""
    from mxnet_tpu_torch.ops import _kernels
    out = []
    for lib in (_kernels.FLASH_FWD, _kernels.FLASH_BWD):
        cur = None
        for line in lib.build_log.splitlines():
            m = _ENTRY.search(line)
            if m:
                k = _KERNEL.search(m.group(1))
                cur = None if k is None else {
                    "kernel": k.group(1),
                    "dtype": "float32" if k.group(2) == "f" or
                             k.group(1).endswith("_tf32_kernel")
                             else "bfloat16",
                    "d": int(k.group(3))}
                if cur is not None:
                    out.append(cur)
                continue
            if cur is None:
                continue
            m = _SPILLS.search(line)
            if m:
                cur.update(stack_bytes=int(m.group(1)),
                           spill_store_bytes=int(m.group(2)),
                           spill_load_bytes=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
                st = re.search(r"(\d+) bytes smem", line)
                cur["static_smem_bytes"] = int(st.group(1)) if st else 0
    for r in out:
        code = 0 if r["dtype"] == "float32" else 1
        if r["kernel"].startswith("flash_fwd"):
            smem = _kernels.FLASH_FWD.load().mx_flash_fwd_smem(r["d"], code)
        else:
            smem = _kernels.FLASH_BWD.load().mx_flash_bwd_smem(
                int("dkv" in r["kernel"]), r["d"], code)
        r["dynamic_smem_bytes"] = smem
    if len(out) != 12:
        raise RuntimeError("expected 12 flash instantiations in the build "
                           "logs (K1, K2, K3 x fp32, bf16 x D 64, 128), "
                           "found %s" % out)
    return out


# ---------------------------------------------------------------------------
# 3. kernels vs plain
# ---------------------------------------------------------------------------

def time_ms(fn, iters=20, warmup=3):
    """Mean device milliseconds per call, by CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20, warmup=3):
    """Mean device milliseconds per call from a torch.profiler trace of
    ``iters`` back-to-back calls after ``warmup``: the summed time of what
    the calls ran on the card, without the gaps that the CUDA events of
    :func:`time_ms` also count when the host launches slower than the card
    runs.  A trace that holds no device activity at all (the profiler
    now and then returns one empty, several in a row) is taken again,
    four times at most; then the CUDA events' time stands in, and a line
    says so."""
    from torch.autograd import DeviceType
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(iters):
            fn()

    prof, _ = profiled(calls, tries=5)
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    if us > 0:
        return us / 1e3 / iters
    log("device_ms: five profiler traces held no device activity; the "
        "CUDA events' time stands in")
    return time_ms(fn, iters, 0)


def profiled(fn, tries=3):
    """(trace, wall ms) of ``fn()`` run under torch.profiler and
    synchronised, taken again (``tries`` traces at most) while the trace
    holds no device activity, as the profiler now and then returns one
    empty; a line says so when the last is empty too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        if any(e.device_type == DeviceType.CUDA for e in prof.events()):
            return prof, wall_ms
    log("profiled: %d traces held no device activity (not measured)"
        % tries)
    return prof, wall_ms


def _share(part, total):
    """part / total, or None (not measured) for an empty trace."""
    return part / total if total else None


def compare(got, want, tol):
    """(max |got - want| over finite entries, ok) with the rule
    |got - want| <= tol + tol * |want| + u * |want|; equal infinities
    agree.  ``u`` is 0 for a float32 ``got`` and bf16's unit roundoff 2^-8
    for a bfloat16 one: a bf16 output is the fp32 result rounded once to
    bf16, which moves it by at most half a bf16 ulp of |want|, and that is
    at most 2^-8 * |want|.  The fp32 reference is not rounded, and near
    |O| = 2 (a causal row that sees one key returns that key's value row)
    the rounding alone is up to 0.0078, above tol."""
    u = torch.finfo(got.dtype).eps / 2 if got.dtype == torch.bfloat16 \
        else 0.0
    got, want = got.float(), want.float()
    same_inf = torch.isinf(got) & torch.isinf(want) & \
        (torch.sign(got) == torch.sign(want))
    err = (got - want).abs().masked_fill(same_inf, 0.0)
    ok = bool(((err <= tol + (tol + u) * want.abs()) | same_inf).all())
    finite = err[torch.isfinite(err)]
    return (float(finite.max()) if finite.numel() else 0.0), ok


def flash_work(B, H, Tq, Tk, D, causal, itemsize):
    """(operations, bytes) one flash-forward call needs on these shapes:
    2 FLOP per multiply-add in QK^T and PV over the visible (q, k) pairs;
    Q, K, V read once, O and the fp32 LSE written once."""
    if causal:
        pairs = sum(min(i + 1, Tk) for i in range(Tq))
    else:
        pairs = Tq * Tk
    ops = 4 * B * H * pairs * D
    nbytes = B * H * ((2 * Tq + 2 * Tk) * D * itemsize + Tq * 4)
    return ops, nbytes


def bound_ms(ops, nbytes, flops_peak, hbm_peak):
    t_ops, t_bytes = ops / flops_peak * 1e3, nbytes / hbm_peak * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def flash_bound(ops, nbytes, dtype, peaks):
    """The bound fields of a flash kernel's record: bf16 operations at the
    bf16 tensor-core peak; fp32 operations counted three times at the TF32
    peak (the 3xTF32 split that fp32 accuracy needs on the tensor cores,
    one yardstick for every fp32 row), with the bound on CUDA cores beside
    it.  Bytes at the HBM peak in both."""
    if dtype == torch.bfloat16:
        b_ms, b_by = bound_ms(ops, nbytes, peaks["bf16"], peaks["hbm"])
        return {"bound_ms": b_ms, "bound_by": b_by,
                "bound_peak": "bf16 %g FLOP/s" % peaks["bf16"]}
    b_ms, b_by = bound_ms(3 * ops, nbytes, peaks["tf32"], peaks["hbm"])
    return {"bound_ms": b_ms, "bound_by": b_by,
            "bound_peak": "3 x tf32 %g FLOP/s" % peaks["tf32"],
            "cuda_core_bound_ms": bound_ms(ops, nbytes, peaks["fp32"],
                                           peaks["hbm"])[0]}


KERNEL_CASES = [
    # name, B, H, Tq, Tk, D, dtype, causal, timed
    ("bert-base", 8, 12, 512, 512, 64, torch.float32, False, True),
    ("bert-base", 8, 12, 512, 512, 64, torch.bfloat16, False, True),
    ("bert-train", 16, 12, 512, 512, 64, torch.bfloat16, False, True),
    ("ragged-causal", 2, 3, 200, 200, 128, torch.float32, True, False),
    ("ragged-causal", 2, 3, 200, 200, 128, torch.bfloat16, True, False),
    ("top-left-causal", 2, 3, 64, 128, 64, torch.float32, True, False),
    ("top-left-causal", 2, 3, 64, 128, 64, torch.bfloat16, True, False),
    ("ragged-cross", 2, 3, 77, 333, 64, torch.float32, False, False),
    ("ragged-cross", 2, 3, 77, 333, 64, torch.bfloat16, False, False),
    ("causal", 8, 12, 512, 512, 64, torch.float32, True, False),
    ("causal", 8, 12, 512, 512, 64, torch.bfloat16, True, False),
    ("d128", 2, 8, 512, 512, 128, torch.float32, False, False),
    ("d128", 2, 8, 512, 512, 128, torch.bfloat16, False, False),
    ("no-keys", 2, 3, 70, 0, 64, torch.float32, False, False),
    ("no-keys", 2, 3, 70, 0, 64, torch.bfloat16, False, False),
]


def phase_kernels(peaks):
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import attention as att
    results = {}
    for (name, B, H, Tq, Tk, D, dtype, causal, timed) in KERNEL_CASES:
        g = torch.Generator(device="cuda").manual_seed(SEED)
        q, k, v = (torch.randn((B, H, T, D), generator=g, device="cuda")
                   .to(dtype) for T in (Tq, Tk, Tk))
        scale = 1.0 / D ** 0.5
        o, lse = att.flash_attention_with_lse(q, k, v, scale, causal)
        o2, lse2 = att.flash_attention_with_lse(q, k, v, scale, causal)
        torch.cuda.synchronize()
        same = torch.equal(o, o2) and torch.equal(lse, lse2)
        # bf16 is held against the plain version run in fp32 on the same
        # bf16 inputs; fp32 against the plain version itself
        o_ref, lse_ref = att.flash_attention_plain(
            q.float(), k.float(), v.float(), scale, causal)
        tol = 1e-4 if dtype == torch.float32 else 2e-3
        err_o, ok_o = compare(o, o_ref, tol)
        err_l, ok_l = compare(lse, lse_ref, tol)
        tag = "%s B=%d H=%d Tq=%d Tk=%d D=%d %s causal=%s" % (
            name, B, H, Tq, Tk, D, str(dtype).replace("torch.", ""), causal)
        log("kernels: %s | max|dO| %.3g max|dLSE| %.3g (tol %g), repeat "
            "bitwise %s %s" % (tag, err_o, err_l, tol, same,
                               "ok" if ok_o and ok_l and same else "FAIL"))
        if not (ok_o and ok_l and same and torch.isfinite(o.float()).all()):
            raise RuntimeError("flash_fwd disagrees with its plain version "
                               "or does not repeat: " + tag)
        if not timed:
            continue
        itemsize = torch.finfo(dtype).bits // 8
        ops, nbytes = flash_work(B, H, Tq, Tk, D, causal, itemsize)
        run = lambda: att.flash_attention_with_lse(  # noqa: E731
            q, k, v, scale, causal)
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=causal, scale=scale)
        rec = {
            "kernel_ms": time_ms(run),
            "plain_ms": time_ms(lambda: att.flash_attention_plain(
                q, k, v, scale, causal)),
            "library_ms": time_ms(sdpa),
            "device_ms": device_ms(run), "library_device_ms": device_ms(sdpa),
            "gflop": ops / 1e9, "mbytes": nbytes / 1e6,
            "max_abs_err": max(err_o, err_l)}
        rec.update(flash_bound(ops, nbytes, dtype, peaks))
        add_ratios(rec, ops)
        log("kernels: timing %s %s" % (tag, json.dumps(rec)))
        results[(name, dtype)] = rec
    return results


def add_ratios(rec, ops):
    """The rate and the kernel's time over the library call's and over the
    bound, by CUDA events (``x_``) and by device time (``device_x_``)."""
    rec["tflops"] = ops / rec["kernel_ms"] / 1e9
    rec["x_library"] = rec["kernel_ms"] / rec["library_ms"]
    rec["x_bound"] = rec["kernel_ms"] / rec["bound_ms"]
    rec["device_x_library"] = rec["device_ms"] / rec["library_device_ms"]
    rec["device_x_bound"] = rec["device_ms"] / rec["bound_ms"]


def bwd_work(kernel, B, H, Tq, Tk, D, causal, itemsize):
    """(operations, bytes) one backward-kernel call needs on these shapes,
    over the visible (q, k) pairs: K2 (``flash_bwd_dq``) 6*D FLOP a pair
    (S, dP, dQ), K3 (``flash_bwd_dkv``) 8*D (S, dP, dV, dK).  Both read Q,
    K, V, O, dO and the fp32 LSE once; K2 writes dQ, K3 dK and dV."""
    if causal:
        pairs = sum(min(i + 1, Tk) for i in range(Tq))
    else:
        pairs = Tq * Tk
    per_pair, out_rows = {"flash_bwd_dq": (6, Tq),
                          "flash_bwd_dkv": (8, 2 * Tk)}[kernel]
    ops = per_pair * D * B * H * pairs
    nbytes = B * H * ((3 * Tq + 2 * Tk + out_rows) * D * itemsize + Tq * 4)
    return ops, nbytes


BWD_CASES = [
    # name, B, H, Tq, Tk, D, dtype, causal, timed
    ("bert-train", 16, 12, 512, 512, 64, torch.float32, False, True),
    ("bert-train", 16, 12, 512, 512, 64, torch.bfloat16, False, True),
    ("causal-d128", 2, 2, 512, 512, 128, torch.float32, True, False),
    ("causal-d128", 2, 2, 512, 512, 128, torch.bfloat16, True, False),
    ("ragged-causal", 2, 2, 200, 200, 128, torch.float32, True, False),
    ("ragged-causal", 2, 2, 200, 200, 128, torch.bfloat16, True, False),
    ("top-left-causal", 2, 2, 64, 128, 64, torch.float32, True, False),
    ("top-left-causal", 2, 2, 64, 128, 64, torch.bfloat16, True, False),
    ("ragged-cross", 2, 2, 77, 333, 64, torch.float32, False, False),
    ("ragged-cross", 2, 2, 77, 333, 64, torch.bfloat16, False, False),
]


def phase_bwd_kernels(peaks):
    """K2 and K3 (on the tensor cores: bf16, and fp32 as 3xTF32) against
    their plain versions on the O and LSE of K1, two launches bitwise
    equal; timings for the timed cases, with the backward of
    scaled_dot_product_attention (dQ, dK and dV in one call) as the library
    yardstick of both."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import attention as att
    results = {}
    for (name, B, H, Tq, Tk, D, dtype, causal, timed) in BWD_CASES:
        g = torch.Generator(device="cuda").manual_seed(SEED + 1)
        q, k, v = (torch.randn((B, H, T, D), generator=g, device="cuda")
                   .to(dtype) for T in (Tq, Tk, Tk))
        do = torch.randn((B, H, Tq, D), generator=g, device="cuda").to(dtype)
        scale = 1.0 / D ** 0.5
        o, lse = att.flash_attention_with_lse(q, k, v, scale, causal)
        args = (q, k, v, o, lse, do, scale, causal)
        got = {"flash_bwd_dq": (att._flash_bwd_dq_cuda(*args),),
               "flash_bwd_dkv": att._flash_bwd_dkv_cuda(*args)}
        again = {"flash_bwd_dq": (att._flash_bwd_dq_cuda(*args),),
                 "flash_bwd_dkv": att._flash_bwd_dkv_cuda(*args)}
        torch.cuda.synchronize()
        # bf16 is held against the plain versions run in fp32 on the same
        # bf16 inputs; fp32 against the plain versions themselves
        f32 = [t.float() if t.dtype == torch.bfloat16 else t
               for t in (q, k, v, o, lse, do)]
        want = {"flash_bwd_dq": (att.flash_bwd_dq_plain(*f32, scale, causal),),
                "flash_bwd_dkv": att.flash_bwd_dkv_plain(*f32, scale,
                                                         causal)}
        tol = 1e-4 if dtype == torch.float32 else 2e-3
        tag = "%s B=%d H=%d Tq=%d Tk=%d D=%d %s causal=%s" % (
            name, B, H, Tq, Tk, D, str(dtype).replace("torch.", ""), causal)
        for kern in ("flash_bwd_dq", "flash_bwd_dkv"):
            errs = [compare(a, b, tol) for a, b in zip(got[kern],
                                                       want[kern])]
            same = all(torch.equal(a, b) for a, b in zip(got[kern],
                                                         again[kern]))
            finite = all(bool(torch.isfinite(a.float()).all())
                         for a in got[kern])
            ok = all(e[1] for e in errs) and same and finite
            log("kernels: %s %s | max|d| %s (tol %g), repeat bitwise %s %s"
                % (kern, tag, ["%.3g" % e[0] for e in errs], tol, same,
                   "ok" if ok else "FAIL"))
            if not ok:
                raise RuntimeError("%s disagrees with its plain version or "
                                   "does not repeat: %s" % (kern, tag))
            if not timed:
                continue
            itemsize = torch.finfo(dtype).bits // 8
            ops, nbytes = bwd_work(kern, B, H, Tq, Tk, D, causal, itemsize)
            if kern == "flash_bwd_dq":
                run = lambda: att._flash_bwd_dq_cuda(*args)  # noqa: E731
                plain = lambda: att.flash_bwd_dq_plain(*args)  # noqa: E731
            else:
                run = lambda: att._flash_bwd_dkv_cuda(*args)  # noqa: E731
                plain = lambda: att.flash_bwd_dkv_plain(*args)  # noqa: E731
            rec = {"kernel_ms": time_ms(run), "plain_ms": time_ms(plain),
                   "device_ms": device_ms(run), "gflop": ops / 1e9,
                   "mbytes": nbytes / 1e6, "ops": ops,
                   "max_abs_err": max(e[0] for e in errs)}
            rec.update(flash_bound(ops, nbytes, dtype, peaks))
            results[(kern, dtype)] = rec
        if timed:
            qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
            out = F.scaled_dot_product_attention(qg, kg, vg,
                                                 is_causal=causal,
                                                 scale=scale)
            sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
                out, (qg, kg, vg), do, retain_graph=True)
            lib_ms, lib_dev_ms = time_ms(sdpa_bwd), device_ms(sdpa_bwd)
            del out, qg, kg, vg, sdpa_bwd
            for kern in ("flash_bwd_dq", "flash_bwd_dkv"):
                rec = results[(kern, dtype)]
                rec.update(library_ms=lib_ms, library_device_ms=lib_dev_ms)
                add_ratios(rec, rec.pop("ops"))
                log("kernels: timing %s %s %s" % (kern, tag,
                                                  json.dumps(rec)))
    check_lse_rule()
    check_nonfinite_scores()
    return results


def log_library_ratios(fwd, bwd):
    """K1, K2 and K3 in bf16 at the training shape against one PyTorch call
    in the same run: the forward, and the whole backward (dQ, dK and dV),
    of scaled_dot_product_attention; then K1 in fp32 at the serving shape
    against SDPA's fp32 forward, and K2 and K3 in fp32 against SDPA's fp32
    backward, as the pair that call replaces and each alone."""
    recs = [("K1", fwd[("bert-train", torch.bfloat16)], "forward"),
            ("K2", bwd[("flash_bwd_dq", torch.bfloat16)],
             "backward, dQ+dK+dV"),
            ("K3", bwd[("flash_bwd_dkv", torch.bfloat16)],
             "backward, dQ+dK+dV")]
    for how, key in (("CUDA events", ""), ("device time", "device_")):
        ms = "kernel_ms" if not key else "device_ms"
        log("kernels: bf16 B=16 H=12 T=512 D=64, by %s: %s" % (how, "; ".join(
            "%s %.4f ms = %.2fx the SDPA %s (%.4f ms), %.2fx its bound"
            % (name, rec[ms], rec[key + "x_library"], what,
               rec["library_" + key + "ms"], rec[key + "x_bound"])
            for name, rec, what in recs)))
    k1 = fwd[("bert-base", torch.float32)]
    for how, key in (("CUDA events", ""), ("device time", "device_")):
        ms = "kernel_ms" if not key else "device_ms"
        log("kernels: fp32 B=8 H=12 T=512 D=64, by %s: K1 %.4f ms = %.2fx "
            "the SDPA fp32 forward (%.4f ms), %.2fx its bound (3 x tf32) "
            "%.4f ms" % (how, k1[ms], k1[key + "x_library"],
                         k1["library_" + key + "ms"], k1[key + "x_bound"],
                         k1["bound_ms"]))
    dq, dkv = bwd[("flash_bwd_dq", torch.float32)], \
        bwd[("flash_bwd_dkv", torch.float32)]
    for how, key in (("CUDA events", ""), ("device time", "device_")):
        ms = "kernel_ms" if not key else "device_ms"
        lib = dq["library_" + key + "ms"]
        log("kernels: fp32 B=16 H=12 T=512 D=64, by %s: K2 + K3 %.4f + %.4f "
            "= %.4f ms = %.2fx the SDPA fp32 backward, dQ+dK+dV (%.4f ms); "
            "K2 %.2fx, K3 %.2fx; bounds (3 x tf32) K2 %.4f, K3 %.4f ms"
            % (how, dq[ms], dkv[ms], dq[ms] + dkv[ms],
               (dq[ms] + dkv[ms]) / lib, lib, dq[ms] / lib, dkv[ms] / lib,
               dq["bound_ms"], dkv["bound_ms"]))


def check_lse_rule():
    """The LSE-cotangent rule of flash_attention_with_lse (K1 with v := k,
    then K2 and K3 with v and O zeroed) against autograd through the plain
    forward, once, causal fp32, with both cotangents used."""
    from mxnet_tpu_torch.ops import attention as att
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    B, H, T, D = 2, 2, 200, 64
    q, k, v, go = (torch.randn((B, H, T, D), generator=g, device="cuda")
                   for _ in range(4))
    gl = torch.randn((B, H, T), generator=g, device="cuda")
    grads = []
    for fn in (att.flash_attention_with_lse, att.flash_attention_plain):
        xs = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out, lse = fn(*xs, 0.125, True)
        grads.append(torch.autograd.grad(
            (out * go).sum() + (lse * gl).sum(), xs))
    errs = [compare(a, b, 1e-4) for a, b in zip(*grads)]
    ok = all(e[1] for e in errs)
    log("kernels: LSE-cotangent rule vs autograd through the plain forward "
        "(causal fp32 B=%d H=%d T=%d D=%d) | max|dQ|,|dK|,|dV| %s %s"
        % (B, H, T, D, ["%.3g" % e[0] for e in errs], "ok" if ok
           else "FAIL"))
    if not ok:
        raise RuntimeError("the flash_attention_with_lse VJP rule disagrees "
                           "with autograd through the plain forward")


def isolate_pair(q, k, r, j0):
    """Edit q and k (B, H, T, D; tensors or numpy arrays) in place so that
    query r sees key j0 alone (its score on every other key is -1e4 scale)
    and key j0 is seen by query r alone (the same for every other query),
    through columns 1 and 2; column 0 is cleared for :func:`overflow_pair`."""
    q[..., :3] = 0.0
    k[..., :3] = 0.0
    q[..., 1] = 1.0
    q[:, :, r, 1] = 0.0
    k[:, :, j0, 1] = -1e4
    q[:, :, r, 2] = 1e4
    k[..., 2] = -1.0
    k[:, :, j0, 2] = 0.0


def overflow_pair(q, k, r, j0, sign=1.0):
    """q[r, 0] = 1e20 and k[j0, 0] = sign * 1e20, where column 0 of every
    other row is 0: the score of query r on key j0 becomes sign * inf
    (1e40 is past the fp32 range), and every other score stays as it
    was."""
    q[:, :, r, 0] = 1e20
    k[:, :, j0, 0] = sign * 1e20


def check_nonfinite_scores():
    """Each kernel where one score leaves the fp32 range, in fp32 (at 1e-4)
    and bf16 (under the bf16 rule), against its plain version; every
    output must be finite.  K2 and K3: P = 0 where a score overflows on a
    finite LSE, as in the reference and the plain versions (their
    ``isfinite`` guard on S).  Query r and key j0 see only each other
    (:func:`isolate_pair`), the forward gives O and a finite LSE, and then
    :func:`overflow_pair` pushes their score alone to +inf; exp(+inf)
    would make dQ row r and dK and dV row j0 inf or NaN.  K1: the score of
    query r on key j0 alone is -inf on otherwise random inputs (a +inf
    score gives NaN in the plain version too); the guards must give it P
    = 0 and leave the row's max and sum to the other keys."""
    from mxnet_tpu_torch.ops import attention as att
    B, H, T, r, j0 = 2, 2, 200, 150, 37
    for dtype in (torch.float32, torch.bfloat16):
        tol = 1e-4 if dtype == torch.float32 else 2e-3
        name = str(dtype).replace("torch.", "")
        for D, causal in ((64, True), (128, False)):
            g = torch.Generator(device="cuda").manual_seed(SEED + 3)
            q, k, v, do = (torch.randn((B, H, T, D), generator=g,
                                       device="cuda") for _ in range(4))
            isolate_pair(q, k, r, j0)
            q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
            scale = 1.0 / D ** 0.5
            o, lse = att.flash_attention_with_lse(q, k, v, scale, causal)
            overflow_pair(q, k, r, j0)
            s = (q[:, :, r].float() * k[:, :, j0].float()).sum(-1)
            if not (bool(torch.isinf(s).all()) and
                    bool(torch.isfinite(lse).all())):
                raise RuntimeError("check_nonfinite_scores: the inputs do "
                                   "not give one infinite score on a "
                                   "finite LSE")
            args = (q, k, v, o, lse, do, scale, causal)
            f32 = [t.float() for t in args[:6]]
            got = (att._flash_bwd_dq_cuda(*args),) + \
                att._flash_bwd_dkv_cuda(*args)
            want = (att.flash_bwd_dq_plain(*f32, scale, causal),) + \
                att.flash_bwd_dkv_plain(*f32, scale, causal)
            _check_finite_and_close(
                "K2, K3: a score past the fp32 range on a finite LSE (%s "
                "B=%d H=%d T=%d D=%d causal=%s) | max|dQ|,|dK|,|dV|"
                % (name, B, H, T, D, causal), got, want, tol)

            q, k, v = (torch.randn((B, H, T, D), generator=g, device="cuda")
                       for _ in range(3))
            q[..., 0] = 0.0
            k[..., 0] = 0.0
            overflow_pair(q, k, r, j0, sign=-1.0)
            q, k, v = (t.to(dtype) for t in (q, k, v))
            s = (q[:, :, r].float() * k[:, :, j0].float()).sum(-1)
            if not bool((s == -float("inf")).all()):
                raise RuntimeError("check_nonfinite_scores: the inputs do "
                                   "not give one score of -inf")
            got = att.flash_attention_with_lse(q, k, v, scale, causal)
            want = att.flash_attention_plain(q.float(), k.float(),
                                             v.float(), scale, causal)
            _check_finite_and_close(
                "K1: a score of -inf past the fp32 range (%s B=%d H=%d T=%d "
                "D=%d causal=%s) | max|O|,|LSE|"
                % (name, B, H, T, D, causal), got, want, tol)


def _check_finite_and_close(what, got, want, tol):
    """Log and require: every output of ``got`` finite, the plain versions'
    ``want`` finite, and each within ``compare``'s rule at ``tol``."""
    errs = [compare(a, b, tol) for a, b in zip(got, want)]
    bad = [int((~torch.isfinite(a.float())).sum()) for a in got]
    ok = all(e[1] for e in errs) and not any(bad) and all(
        bool(torch.isfinite(b.float()).all()) for b in want)
    log("kernels: %s %s (tol %g), non-finite entries %s %s"
        % (what, ["%.3g" % e[0] for e in errs], tol, bad,
           "ok" if ok else "FAIL"))
    if not ok:
        raise RuntimeError("a kernel is not finite or disagrees with its "
                           "plain version where a score leaves the fp32 "
                           "range: " + what)


# ---------------------------------------------------------------------------
# 4. the slice: BERT-base served over the wire
# ---------------------------------------------------------------------------

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def make_requests():
    rng = np.random.RandomState(SEED)
    tokens = rng.randint(0, 30522, size=(N_REQUESTS, 1, SEQ_LEN)) \
        .astype(np.int32)
    types = np.zeros((N_REQUESTS, 1, SEQ_LEN), np.int32)
    for i, cut in enumerate(rng.randint(1, SEQ_LEN, size=N_REQUESTS)):
        types[i, 0, cut:] = 1       # segment A, then segment B
    return tokens, types


def run_burst(port, tokens, types):
    """N_REQUESTS PREDICTs from N_CLIENTS closed-loop ServeClient threads
    (one outstanding request each), each on a connection opened (by a
    HEALTH call) before the burst starts, as a client pool keeps them;
    returns (answers, latencies in s, wall seconds of the burst)."""
    from mxnet_tpu_torch.serve import ServeClient
    answers = [None] * N_REQUESTS
    latency = [None] * N_REQUESTS
    errors = []
    barrier = threading.Barrier(N_CLIENTS + 1)

    def client(c):
        try:
            with ServeClient(["127.0.0.1:%d" % port], timeout=120) as cli:
                cli.health()
                barrier.wait(60)
                for i in range(c, N_REQUESTS, N_CLIENTS):
                    t0 = time.perf_counter()
                    answers[i] = cli.predict([tokens[i], types[i]])
                    latency[i] = time.perf_counter() - t0
        except Exception as e:    # reported and failed below
            errors.append("client %d: %r" % (c, e))

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(N_CLIENTS)]
    for t in threads:
        t.start()
    barrier.wait(60)
    t0 = time.perf_counter()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    if errors or any(a is None for a in answers):
        raise RuntimeError("PREDICT failed: %s" % errors)
    return answers, latency, wall


def device_busy_ms(prof):
    """Milliseconds in which at least one device activity (kernel or copy)
    ran, from a torch.profiler trace: the union of their intervals."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e3


def phase_slice():
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon.model_zoo.bert import bert_12_768_12
    from mxnet_tpu_torch.ops import _kernels
    from mxnet_tpu_torch.ops.attention import attention_impl_scope
    from mxnet_tpu_torch.serve import (BucketTable, ModelHost, Servable,
                                       ServeClient, ServeServer,
                                       serve_forever)
    net = bert_12_768_12(use_decoder=False, dropout=0.0)
    net.initialize(initializer.Normal(0.02), seed=SEED)
    n_layers = len(net.encoder.transformer_cells)
    tokens, types = make_requests()
    sv = Servable(net, name="bert_12_768_12", version=1,
                  buckets=BucketTable(BUCKETS))
    host = ModelHost()
    state = ServeServer(host, max_batch=max(BUCKETS), max_delay_us=2000,
                        queue_cap=256)
    port = _free_port()
    stop = threading.Event()
    ready = threading.Event()

    # --- the serving main path, counted ---
    _kernels.reset_launches()
    t_deploy = time.perf_counter()
    host.deploy(sv, example=[tokens[0], types[0]])
    t_deploy = time.perf_counter() - t_deploy
    server = threading.Thread(
        target=serve_forever, name="chip-smoke-serve",
        kwargs=dict(port=port, state=state, stop_event=stop,
                    bind="127.0.0.1", ready_event=ready))
    server.start()
    try:
        if not ready.wait(30):
            raise RuntimeError("serve_forever did not come up")
        answers, latency, t_burst = run_burst(port, tokens, types)
        launches = _kernels.launch_counts()
        served = sv.batches
        burst_stats = state.batcher.stats()
        micro_batches = len(BUCKETS) + served
        # --- end of the counted main path ---
        _, latency2, t_burst2 = run_burst(port, tokens, types)
        log("slice: repeat burst latency ms by request: %s"
            % json.dumps((np.array(latency2) * 1e3).tolist()))
        idle = traced_burst(port, tokens, types, sv)
        with ServeClient(["127.0.0.1:%d" % port], timeout=60) as cli:
            health = cli.health()
            cli.stop()
    finally:
        stop.set()
        server.join(30)
    if server.is_alive():
        raise RuntimeError("serve_forever did not exit after STOP")

    log("slice: deploy+warm %.3f s; batcher after the measured burst %s; "
        "health at the end %s" % (t_deploy, json.dumps(burst_stats),
                                         json.dumps(health)))
    want = n_layers * micro_batches
    log("slice: flash_fwd launches %d, %d layers x %d micro-batches "
        "(%d warm + %d served) = %d" % (launches["flash_fwd"], n_layers,
                                        micro_batches, len(BUCKETS),
                                        served, want))
    if launches != {"flash_fwd": want, "flash_bwd_dq": 0,
                    "flash_bwd_dkv": 0}:
        raise RuntimeError("serving launched %s, expected flash_fwd %d and "
                           "no backward kernel" % (launches, want))
    if health.get("status") != "serving":
        raise RuntimeError("HEALTH says %r" % (health,))

    # every answer against the plain composition, in process
    worst = 0.0
    with torch.inference_mode(), attention_impl_scope("xla"):
        for lo in range(0, N_REQUESTS, max(BUCKETS)):
            hi = lo + max(BUCKETS)
            ref = net(torch.from_numpy(tokens[lo:hi, 0]).cuda(),
                      torch.from_numpy(types[lo:hi, 0]).cuda())
            ref = [r.float().cpu().numpy() for r in ref]
            for i in range(lo, hi):
                version, outs = answers[i]
                if version != 1 or len(outs) != 3:
                    raise RuntimeError("request %d: version %r, %d outputs"
                                       % (i, version, len(outs)))
                for o, r in zip(outs, ref):
                    r = r[i - lo:i - lo + 1]
                    if o.shape != r.shape or not np.isfinite(o).all():
                        raise RuntimeError("request %d: output %s vs %s"
                                           % (i, o.shape, r.shape))
                    err = float(np.abs(o - r).max())
                    worst = max(worst, err)
                    if not np.allclose(o, r, atol=SLICE_TOL, rtol=SLICE_TOL):
                        raise RuntimeError(
                            "request %d disagrees with the composition by "
                            "%.3g" % (i, err))
    lat = np.array(latency) * 1e3
    log("slice: latency ms by request (client c sends c, c+8, c+16, c+24 "
        "in turn): %s" % json.dumps(lat.tolist()))
    rec = {"requests": N_REQUESTS, "clients": N_CLIENTS,
           "requests_per_s": N_REQUESTS / t_burst,
           "p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)),
           "served_batches": served,
           "max_abs_err_vs_composition": worst,
           "warm_s": sv.warm_seconds}
    lat2 = np.array(latency2) * 1e3
    rec.update({"repeat_requests_per_s": N_REQUESTS / t_burst2,
                "repeat_p50_ms": float(np.percentile(lat2, 50)),
                "repeat_p99_ms": float(np.percentile(lat2, 99))})
    rec.update(idle)
    log("slice: %s" % json.dumps(rec))
    return net, sv, answers, launches


def traced_burst(port, tokens, types, sv):
    """The same burst again under torch.profiler, after the measured one:
    the device's busy and idle share of the burst's wall time (the trace
    costs host time, so its wall time is reported, not compared).  The
    flash kernels the trace saw are counted against 12 x the burst's
    micro-batches, to show the trace caught the serving thread's work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    batches0 = sv.batches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, wall = run_burst(port, tokens, types)
        torch.cuda.synchronize()
    busy = device_busy_ms(prof)
    flash = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
                and "flash_fwd_" in e.name)
    rec = {"traced_wall_ms": wall * 1e3, "device_busy_ms": busy,
           "device_idle_share": 1.0 - busy / (wall * 1e3),
           "traced_batches": sv.batches - batches0,
           "traced_flash_kernels": flash}
    log("slice: traced burst %s" % json.dumps(rec))
    return rec


def phase_breakdown(sv, tokens, types):
    """One bucket-8 micro-batch: its device time by CUDA events, and its
    device time by kernel from a torch.profiler trace."""
    bucket = max(BUCKETS)
    xs = [tokens[:bucket, 0], types[:bucket, 0]]
    ms = time_ms(lambda: sv.dispatch(bucket, xs, warming=True), iters=10)
    prof, _ = profiled(lambda: sv.dispatch(bucket, xs, warming=True))
    log("breakdown: bucket-%d forward %.3f ms (CUDA events)" % (bucket, ms))
    log_kernel_breakdown("breakdown", prof)
    return ms


def log_kernel_breakdown(label, prof, top=10):
    """Device time by kernel name from a torch.profiler trace, largest
    first; returns (traced device ms, busy ms, {name: (ms, calls)})."""
    from torch.autograd import DeviceType
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    total = sum(us for us, _ in by_name.values())
    busy = device_busy_ms(prof)
    log("%s: traced device time %.3f ms, busy %.3f ms, over %d kernels"
        % (label, total / 1e3, busy, len(by_name)))
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0]
                                )[:top]:
        log("%s: %8.3f ms %5.1f%% x%-4d %s"
            % (label, us / 1e3, 100.0 * us / total, n, name[:90]))
    return total / 1e3, busy, {k: (us / 1e3, n)
                               for k, (us, n) in by_name.items()}


# ---------------------------------------------------------------------------
# 5. bf16 in process
# ---------------------------------------------------------------------------

def phase_bf16(net, answers, tokens, types):
    from mxnet_tpu_torch.ops import _kernels
    n = max(BUCKETS)
    net.cast("bfloat16")
    before = _kernels.launch_counts()["flash_fwd"]
    with torch.inference_mode():
        outs = net(torch.from_numpy(tokens[:n, 0]).cuda(),
                   torch.from_numpy(types[:n, 0]).cuda())
    if _kernels.launch_counts()["flash_fwd"] - before != len(
            net.encoder.transformer_cells):
        raise RuntimeError("the bf16 forward did not run the flash kernel "
                           "once per layer")
    devs = []
    for j, o in enumerate(outs):
        o = o.float().cpu().numpy()
        if not np.isfinite(o).all():
            raise RuntimeError("bf16 output %d is not finite" % j)
        ref = np.concatenate([answers[i][1][j] for i in range(n)])
        devs.append(float(np.abs(o - ref).max()))
    log("bf16: max |bf16 - fp32| (seq_out, pooled, nsp) = %s" % devs)
    return devs


# ---------------------------------------------------------------------------
# 6. the training path: BERT-base MLM pretraining steps
# ---------------------------------------------------------------------------

def train_batch_host(batch):
    """Token ids, segment ids (all 0, as the bench) and MLM labels, from
    the seed, as numpy arrays."""
    rng = np.random.RandomState(SEED + batch)
    tok = rng.randint(0, VOCAB, size=(batch, SEQ_LEN)).astype(np.int64)
    lab = rng.randint(0, VOCAB, size=(batch, SEQ_LEN)).astype(np.int64)
    return tok, np.zeros_like(tok), lab


def train_batch(batch):
    """:func:`train_batch_host` as CUDA tensors."""
    return [torch.from_numpy(a).cuda() for a in train_batch_host(batch)]


def functional_grads(pure_fn, params, loss_fn, *batch):
    """The loss and every parameter's gradient (zeros where unused) by
    torch autograd through ``functionalize``'s pure function, as
    ``TrainStep`` computes them; ``batch`` is the inputs, then the
    label."""
    leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
    loss = loss_fn(pure_fn(leaves, *batch[:-1], training=True), batch[-1])
    gs = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(leaves.items(), gs)}
    return float(loss.detach()), grads


def train_fp32_parity(net, loss_fn, n_layers):
    """(a) One fp32 step at batch 2: the loss, every gradient and every
    updated parameter through the kernels against the same step through
    the composition (attention_impl_scope('xla')); then one traced forward
    and backward through the kernels: its device time and the attention
    kernels' part of it."""
    from mxnet_tpu_torch.gluon.block import functionalize
    from mxnet_tpu_torch.ops import _kernels
    from mxnet_tpu_torch.ops.attention import attention_impl_scope
    from mxnet_tpu_torch.parallel import TrainStep
    tok, seg, lab = train_batch(2)
    pure_fn, params = functionalize(net)

    def loss_and_grads():
        return functional_grads(pure_fn, params, loss_fn, tok, seg, lab)

    before = _kernels.launch_counts()
    loss_k, grads_k = loss_and_grads()
    after = _kernels.launch_counts()
    ran = {k: after[k] - before[k] for k in after}
    if ran != {k: n_layers for k in ran}:
        raise RuntimeError("the fp32 step launched %s, expected %d of each "
                           "kernel" % (ran, n_layers))
    with attention_impl_scope("xla"):
        loss_x, grads_x = loss_and_grads()
    updated = []
    for impl in (None, "xla"):
        with attention_impl_scope(impl):
            step = TrainStep(net, loss_fn, learning_rate=TRAIN_LR,
                             momentum=TRAIN_MOMENTUM)
            step(tok, seg, lab)
        updated.append(step.params)
    worst = {}
    for what, got, want in (("grad", grads_k, grads_x),
                            ("param", updated[0], updated[1])):
        for n in want:
            err = float((got[n] - want[n]).abs().max())
            ref = float(want[n].abs().max())
            if not err <= 2e-3 * ref + 1e-6:
                raise RuntimeError("fp32 step: %s of %s differs by %.3g "
                                   "(max|ref| %.3g)" % (what, n, err, ref))
            worst[what] = max(worst.get(what, 0.0), err / (ref + 1e-30))
    rel = abs(loss_k - loss_x) / abs(loss_x)
    log("train: fp32 batch-2 step, kernels vs composition: loss %.7f vs "
        "%.7f (rel %.3g, tol 1e-4); worst max|d|/max|ref| over %d tensors: "
        "grads %.3g, updated params %.3g (tol 2e-3 + 1e-6 abs)"
        % (loss_k, loss_x, rel, len(grads_x), worst["grad"], worst["param"]))
    if not rel <= 1e-4:
        raise RuntimeError("fp32 step: loss %.7f vs composition %.7f"
                           % (loss_k, loss_x))
    torch.cuda.synchronize()
    prof, _ = profiled(loss_and_grads)
    total, busy, by_name = log_kernel_breakdown("train-fp32", prof, top=6)
    attn = attention_ms(by_name)
    log("train: fp32 batch-2 forward+backward through the kernels %s"
        % json.dumps({"traced_device_ms": total, "device_busy_ms": busy,
                      "attention_kernels_ms": attn,
                      "attention_share_of_device_time":
                          _share(sum(attn.values()), total)}))


def attention_ms(by_name):
    """Device ms of K1, K2 and K3 in a breakdown of
    :func:`log_kernel_breakdown`, by kernel name prefix (fp32 and bf16
    instantiations alike)."""
    return {k: sum(ms for n, (ms, _) in by_name.items() if k + "_" in n)
            for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}


def phase_train(peaks):
    """The training main path; returns its kernel launch counts."""
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.bert import bert_12_768_12
    from mxnet_tpu_torch.ops import _kernels
    from mxnet_tpu_torch.ops.attention import attention_impl_scope
    from mxnet_tpu_torch.parallel import TrainStep
    ce = SoftmaxCrossEntropyLoss()

    def loss_fn(outputs, labels):
        """The bench's loss: mean MLM cross-entropy in fp32 over B*T."""
        return ce(outputs[-1].float(), labels).mean()

    net = bert_12_768_12(vocab_size=VOCAB, max_length=SEQ_LEN, dropout=0.0,
                         use_classifier=False)
    net.initialize(initializer.Normal(0.02), seed=SEED)
    n_layers = len(net.encoder.transformer_cells)
    units = net._units
    n_params = sum(p.numel() for p in net.parameters())
    train_fp32_parity(net, loss_fn, n_layers)

    # (b) bf16, batch 16: the composition's trajectory first, then the
    # counted main path from the same parameters and batch
    net.cast("bfloat16")
    batch = train_batch(TRAIN_BATCH)
    n_steps = TRAIN_WARM + TRAIN_TIMED
    with attention_impl_scope("xla"):
        ref = TrainStep(net, loss_fn, learning_rate=TRAIN_LR,
                        momentum=TRAIN_MOMENTUM)
        ref_losses = [float(ref(*batch)) for _ in range(n_steps)]
    del ref
    torch.cuda.empty_cache()

    # --- the training main path, counted ---
    _kernels.reset_launches()
    step = TrainStep(net, loss_fn, learning_rate=TRAIN_LR,
                     momentum=TRAIN_MOMENTUM)
    losses = [step(*batch) for _ in range(TRAIN_WARM)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step(*batch) for _ in range(TRAIN_TIMED)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _kernels.launch_counts()
    # --- end of the counted main path ---

    losses = [float(x) for x in losses]
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    log("train: bf16 batch-%d losses %s" % (TRAIN_BATCH, json.dumps(losses)))
    log("train: composition's losses %s" % json.dumps(ref_losses))
    log("train: relative gap by step %s (tol 1e-2)" % json.dumps(gaps))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError("bf16 training: losses %s are not finite or do "
                           "not fall" % losses)
    if max(gaps) > 1e-2:
        raise RuntimeError("bf16 training: loss trajectory %.3g from the "
                           "composition's" % max(gaps))
    want = n_layers * n_steps
    log("train: launches %s over %d steps (want %d of each = %d layers x "
        "%d steps)" % (json.dumps(launches), n_steps, want, n_layers,
                       n_steps))
    if launches != {k: want for k in launches}:
        raise RuntimeError("training launched %s, expected %d of each "
                           "kernel" % (launches, want))

    tokens_per_s = TRAIN_BATCH * SEQ_LEN * TRAIN_TIMED / dt
    # the bench's formula: 6 N (dense matmuls) + 12 L s d (attention)
    flops_per_token = 6.0 * n_params + 12.0 * n_layers * SEQ_LEN * units
    tflops = tokens_per_s * flops_per_token / 1e12
    rec = {"batch": TRAIN_BATCH, "seq": SEQ_LEN, "dtype": "bfloat16",
           "n_params": n_params, "step_ms": dt / TRAIN_TIMED * 1e3,
           "tokens_per_s": tokens_per_s, "tflops": tflops,
           "mfu": tflops * 1e12 / peaks["bf16"],
           "peak_tflops": peaks["bf16"] / 1e12,
           "max_rel_gap_vs_composition": max(gaps),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}

    # one more step under the profiler: device time by kernel, idle share
    prof, wall_ms = profiled(lambda: step(*batch))
    total, busy, by_name = log_kernel_breakdown("train", prof, top=14)
    attn = attention_ms(by_name)
    rec.update({"traced_step_wall_ms": wall_ms, "device_busy_ms": busy,
                "traced_device_ms": total,
                "device_idle_share": 1.0 - busy / wall_ms,
                "attention_kernels_ms": attn,
                "attention_kernels_share": {k: _share(ms, total)
                                            for k, ms in attn.items()},
                "attention_share_of_device_time":
                    _share(sum(attn.values()), total)})
    log("train: %s" % json.dumps(rec))
    return launches, rec["step_ms"]


# ---------------------------------------------------------------------------
# 7. user kernels (K4): the bodies of tests/test_tpu_kernel.py in CUDA C++
# ---------------------------------------------------------------------------

FFN_SHAPE = (TRAIN_BATCH * SEQ_LEN, 3072)     # BERT-base's FFN activation
USER_KERNEL_SOURCE = ("chip_smoke.py (CUDA source string) via "
                      "mxnet_tpu_torch/tpu_kernel.py")
IMPERATIVE_WARM, IMPERATIVE_TIMED = 2, 5

_HELPERS = r"""
// float32 arithmetic for float and __nv_bfloat16 elements, each product
// and sum rounded on its own (__fmul_rn, __fadd_rn: no contraction into
// an FMA), as the plain PyTorch versions round them
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

// Memory moves in 16-byte vectors: V = 8 bf16 or 4 float values a uint4,
// a pointer on a 16-byte boundary (checked at run time, every pointer of
// the call, so a misaligned view takes the scalar loop for the whole call)
template <typename T> struct Vec {
  static constexpr int V = 16 / sizeof(T);
  uint4 u;
  __device__ __forceinline__ T& operator[](int e) {
    return reinterpret_cast<T*>(&u)[e];
  }
};
__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}
"""

_UNARY_SIGNATURE = "const T* x, T* o, long long n"


def _unary_body(entry, expr):
    """An elementwise body o[i] = expr of v = x[i] in float: a grid-stride
    loop over 16-byte vectors of the output, then a scalar loop over the
    tail (the whole output when a pointer is misaligned).  Correct under
    any grid."""
    return _HELPERS + r"""
template <typename T>
__global__ void %s(const T* x, T* o, long long n) {
  constexpr int V = Vec<T>::V;
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long head = 0;  // entries the vector loop covers
  if (aligned16(x) && aligned16(o)) {
    const long long nv = n / V;
#pragma unroll 4
    for (long long i = tid; i < nv; i += stride) {
      Vec<T> a, b;
      a.u = reinterpret_cast<const uint4*>(x)[i];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float v = to_f(a[e]);
        b[e] = from_f<T>(%s);
      }
      reinterpret_cast<uint4*>(o)[i] = b.u;
    }
    head = nv * V;
  }
  for (long long i = head + tid; i < n; i += stride) {
    const float v = to_f(x[i]);
    o[i] = from_f<T>(%s);
  }
}
""" % (entry, expr, expr)


_AXPY = _HELPERS + r"""
template <typename T>
__device__ __forceinline__ T axpy1(T a, T x, T y) {
  return from_f<T>(__fadd_rn(__fmul_rn(to_f(a), to_f(x)), to_f(y)));
}

// o = a * x + y: 16-byte vectors, then the scalar tail
template <typename T>
__global__ void axpy(const T* a, const T* x, const T* y, T* o, long long n) {
  constexpr int V = Vec<T>::V;
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long head = 0;
  if (aligned16(a) && aligned16(x) && aligned16(y) && aligned16(o)) {
    const long long nv = n / V;
#pragma unroll 2
    for (long long i = tid; i < nv; i += stride) {
      Vec<T> va, vx, vy, vo;
      va.u = reinterpret_cast<const uint4*>(a)[i];
      vx.u = reinterpret_cast<const uint4*>(x)[i];
      vy.u = reinterpret_cast<const uint4*>(y)[i];
#pragma unroll
      for (int e = 0; e < V; ++e) vo[e] = axpy1(va[e], vx[e], vy[e]);
      reinterpret_cast<uint4*>(o)[i] = vo.u;
    }
    head = nv * V;
  }
  for (long long i = head + tid; i < n; i += stride)
    o[i] = axpy1(a[i], x[i], y[i]);
}
"""

_RELU_BLOCKED = _HELPERS + r"""
__device__ __forceinline__ float relu1(float v) { return v > 0.0f ? v : 0.0f; }

// one block per row (rows past the grid taken in turn), its threads
// striding over the row in 16-byte vectors when every row starts on a
// 16-byte boundary, then over the row's scalar tail
template <typename T>
__global__ void relu_blocked(const T* x, T* o, long long rows,
                             long long cols) {
  constexpr int V = Vec<T>::V;
  const bool vec = aligned16(x) && aligned16(o) &&
                   (cols * (long long)sizeof(T)) % 16 == 0;
  const long long head = vec ? cols / V * V : 0;
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const T* xr = x + r * cols;
    T* orow = o + r * cols;
    for (long long c = threadIdx.x; c < head / V; c += blockDim.x) {
      Vec<T> a, b;
      a.u = reinterpret_cast<const uint4*>(xr)[c];
#pragma unroll
      for (int e = 0; e < V; ++e) b[e] = from_f<T>(relu1(to_f(a[e])));
      reinterpret_cast<uint4*>(orow)[c] = b.u;
    }
    for (long long c = head + threadIdx.x; c < cols; c += blockDim.x)
      orow[c] = from_f<T>(relu1(to_f(xr[c])));
  }
}
"""


def _per_sm_grid(shape):
    """Eight blocks of 256 threads an SM of the launch's card (a full SM
    of threads): a grid-stride body covers any size with it.  Runs on the
    launch device (``tpu_kernel`` calls a callable grid there)."""
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    return (8 * props.multi_processor_count,)


def _numel(*tensors):
    """The scalar ``n`` of a grid-stride body: the output's entries."""
    return (tensors[-1].numel(),)


def _rows_cols(x, o):
    return (o.shape[0], o.numel() // o.shape[0])


def mul_body(mult):
    """The re-registered body: ``x * mult``, with ``mult`` in the source
    (a new value is a new source, hence a new library)."""
    return dict(source=_unary_body("mul_kernel", "__fmul_rn(v, (float)%r)"
                                   % float(mult)),
                entry="mul_kernel", signature=_UNARY_SIGNATURE,
                grid=_per_sm_grid, block=(256,), scalars=_numel,
                plain=lambda x: x * mult,
                library=lambda x: torch.mul(x, mult))


# The seven bodies of tests/test_tpu_kernel.py (one copy, shared with
# tests/test_torch_tpu_kernel.py).  Each: its CUDA source, entry and
# signature (a template over T in float and __nv_bfloat16), its launch
# dimensions (a few blocks an SM for the grid-stride bodies, a block a row
# for relu_blocked), the scalar rule, the plain PyTorch version, the grad
# of the registered ones, and one PyTorch call computing the same function
# (timed only).  Every body moves 16 bytes a load and a store.
USER_KERNELS = {
    "axpy": dict(source=_AXPY, entry="axpy",
                 signature="const T* a, const T* x, const T* y, T* o, "
                           "long long n",
                 grid=_per_sm_grid, block=(256,), scalars=_numel,
                 plain=lambda a, x, y: a * x + y,
                 library=lambda a, x, y: torch.addcmul(y, a, x)),
    "double": dict(source=_unary_body("double_it", "__fmul_rn(v, 2.0f)"),
                   entry="double_it", signature=_UNARY_SIGNATURE,
                   grid=_per_sm_grid, block=(256,), scalars=_numel,
                   plain=lambda x: x * 2.0,
                   library=lambda x: torch.mul(x, 2.0)),
    "relu_blocked": dict(source=_RELU_BLOCKED, entry="relu_blocked",
                         signature="const T* x, T* o, long long rows, "
                                   "long long cols",
                         grid=lambda shape: (shape[0],), block=(256,),
                         scalars=_rows_cols,
                         plain=lambda x: torch.where(x > 0, x,
                                                     torch.zeros_like(x)),
                         library=torch.relu),
    "square": dict(source=_unary_body("square_kernel", "__fmul_rn(v, v)"),
                   entry="square_kernel", signature=_UNARY_SIGNATURE,
                   grid=_per_sm_grid, block=(256,), scalars=_numel,
                   plain=lambda x: x * x,
                   grad=lambda cts, x: (cts[0] * 2.0 * x,),
                   library=torch.square),
    "scale3": dict(source=_unary_body("scale3_kernel", "__fmul_rn(v, 3.0f)"),
                   entry="scale3_kernel", signature=_UNARY_SIGNATURE,
                   grid=_per_sm_grid, block=(256,), scalars=_numel,
                   plain=lambda x: x * 3.0,
                   grad=lambda cts, x: (cts[0] * 3.0,),
                   library=lambda x: torch.mul(x, 3.0)),
    "mul": mul_body(2.0),
    "sign": dict(source=_unary_body("sign_kernel", "v > 0.0f ? 1.0f : 0.0f"),
                 entry="sign_kernel", signature=_UNARY_SIGNATURE,
                 grid=_per_sm_grid, block=(256,), scalars=_numel,
                 plain=lambda x: (x > 0).to(x.dtype),
                 library=lambda x: torch.heaviside(
                     x, torch.zeros((), dtype=x.dtype, device=x.device))),
}
_KERNEL_ARGS = ("source", "entry", "signature", "grid", "block", "scalars")


def kernel_args(body):
    """The ``tpu_kernel.Kernel`` / ``kernel`` / ``register`` keyword
    arguments of a body of :data:`USER_KERNELS`, built for float32 and
    bfloat16."""
    out = {k: body[k] for k in _KERNEL_ARGS if k in body}
    out["dtypes"] = ("float32", "bfloat16")
    return out


def register_body(name, body=None, op_name=None):
    """Register body ``name`` as the op ``nd.<op_name or name>``, with its
    grad if it has one; returns its Kernel."""
    from mxnet_tpu_torch import tpu_kernel
    body = USER_KERNELS[name] if body is None else body
    return tpu_kernel.register(
        op_name or name, out_shape_fn=lambda *avals: avals[-1],
        grad=body.get("grad"), **kernel_args(body))(body["plain"])


def expect_raises(exc_type, fn, what):
    """Call ``fn``, which must raise ``exc_type``; returns the message."""
    try:
        fn()
    except exc_type as e:
        return str(e)
    raise RuntimeError("%s did not raise %s" % (what, exc_type.__name__))


def user_kernel_inputs(name, dtype, gen):
    """The body's input tensors at FFN_SHAPE on the card."""
    n_in = 3 if name == "axpy" else 1
    return [torch.randn(FFN_SHAPE, generator=gen, device="cuda").to(dtype)
            for _ in range(n_in)]


def phase_user_kernels(peaks):
    """K4 at BERT-base's FFN activation; returns per body its main-path
    launches and its fp32 and bf16 records."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, nd, tpu_kernel
    from mxnet_tpu_torch.ops import _kernels
    kernels = {name: register_body(name) for name in USER_KERNELS}
    mul5 = mul_body(5.0)
    t0 = time.perf_counter()
    _kernels.build_all([k.library for k in kernels.values()])
    wall = time.perf_counter() - t0
    log("user_kernels: nvcc build seconds %s, %.2f s wall for %d libraries "
        "started together" % (json.dumps(
            {n: k.library.build_seconds for n, k in kernels.items()}), wall,
            len(kernels)))
    for n, k in kernels.items():
        for line in k.library.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log("user_kernels: build: %s: %s" % (n, line.strip()))

    checks, outs_by = [], {}
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    inputs = {(n, dt): user_kernel_inputs(n, dt, g)
              for dt in (torch.float32, torch.bfloat16)
              for n in USER_KERNELS}

    # --- the user-kernel main path, counted ---
    _kernels.reset_launches()
    for (name, dt), xs in inputs.items():
        k = kernels[name]
        args = [nd.NDArray(x) for x in xs]
        via_launch = k.launch(args, out_shape=FFN_SHAPE).data
        via_op = getattr(nd, name)(*args).data
        outs_by[(name, dt)] = [("launch", via_launch), ("nd", via_op)]
        if "grad" in USER_KERNELS[name]:
            x = nd.NDArray(xs[0].clone())
            x.attach_grad()
            head = torch.randn(FFN_SHAPE, generator=g, device="cuda").to(dt)
            with autograd.record():
                y = getattr(nd, name)(x)
            y.backward(nd.NDArray(head))
            outs_by[(name, dt)] += [("record", y.data.detach()),
                                    ("grad", (head, x.grad.data))]
        if name == "sign":
            x = nd.NDArray(xs[0].clone())
            x.attach_grad()
            with autograd.record():
                y = nd.sign(x)
            checks.append(("sign under record() carries no gradient (%s)"
                           % str(dt).replace("torch.", ""),
                           not y.data.requires_grad and
                           y.data.grad_fn is None))
    x = nd.NDArray(inputs[("mul", torch.float32)][0])
    k_mul5 = register_body("mul", mul5)        # same name, new body
    re_out = nd.mul(x).data
    launches = {n: k.library.launches[k.counter]
                for n, k in kernels.items()}
    launches["mul"] += k_mul5.library.launches[k_mul5.counter]
    counted = _kernels.launch_counts()
    # --- end of the counted main path ---

    log("user_kernels: launches on the main path %s; launch_counts() "
        "reports %s" % (json.dumps(launches), json.dumps(
            {k: v for k, v in counted.items() if k.startswith("tpu_")})))
    for name, k in kernels.items():
        # per dtype: launch, nd.<name>, and record() for the grad bodies
        # and the sign check; then the re-registered mul once
        per_dtype = 2 + ("grad" in USER_KERNELS[name]) + (name == "sign")
        want = 2 * per_dtype + (name == "mul")
        if launches[name] != want:
            raise RuntimeError("user kernel %s launched %d times on the "
                               "main path, expected %d"
                               % (name, launches[name], want))
    checks.append(("re-registered mul launches the new body (x * 5, "
                   "library %s -> %s, build %.2f s at first launch)"
                   % (kernels["mul"].library.library_path().name,
                      k_mul5.library.library_path().name,
                      k_mul5.library.build_seconds or 0.0),
                   torch.equal(re_out, x.data * 5.0)
                   and k_mul5.library.library_path()
                   != kernels["mul"].library.library_path()))
    cpu_k = tpu_kernel.Kernel(**dict(kernel_args(USER_KERNELS["double"]),
                                     name="double_no_plain"))
    msg = expect_raises(mx.MXNetError, lambda: cpu_k.launch(
        [nd.ones((4, 4), ctx=mx.cpu())], out_shape=(4, 4)),
        "a CPU launch without plain=")
    checks.append(("a CPU launch without plain= raises (%s)" % msg, True))
    for what, ok in checks:
        log("user_kernels: %s %s" % (what, "ok" if ok else "FAIL"))
        if not ok:
            raise RuntimeError("user_kernels: " + what)

    results = {}
    for (name, dt), xs in inputs.items():
        body = USER_KERNELS[name]
        f32 = [x.float() for x in xs]
        want = body["plain"](*f32)
        tol = 1e-6 if dt == torch.float32 else 2e-3
        errs = []
        for path, got in outs_by[(name, dt)]:
            if path == "grad":
                head, got = got
                want_g = body["grad"]((head.float(),), *f32)[0]
                errs.append((path,) + compare(got, want_g, tol))
            else:
                errs.append((path,) + compare(got, want, tol))
        same = all(torch.equal(outs_by[(name, dt)][0][1], o)
                   for p, o in outs_by[(name, dt)][1:] if p != "grad")
        ok = all(e[2] for e in errs) and same
        tag = "%s %s %s" % (name, str(dt).replace("torch.", ""),
                            "x".join(map(str, FFN_SHAPE)))
        log("user_kernels: %s | max|d| vs plain %s (tol %g), launch/nd/"
            "record outputs bitwise equal %s %s"
            % (tag, {p: "%.3g" % e for p, e, _ in errs}, tol, same,
               "ok" if ok else "FAIL"))
        if not ok:
            raise RuntimeError("user kernel disagrees with its plain "
                               "version: " + tag)
        structs = [(FFN_SHAPE, dt)]
        k = kernels[name]
        itemsize = torch.finfo(dt).bits // 8
        n = int(np.prod(FFN_SHAPE))
        nbytes = (len(xs) + 1) * n * itemsize
        ops = (2 if name == "axpy" else 1) * n
        b_ms, b_by = bound_ms(ops, nbytes, peaks["fp32"], peaks["hbm"])
        run = lambda: k.run(xs, structs)  # noqa: E731
        library = lambda: body["library"](*xs)  # noqa: E731
        rec = {"kernel_ms": time_ms(run),
               "plain_ms": time_ms(lambda: body["plain"](*xs)),
               "library_ms": time_ms(library),
               "device_ms": device_ms(run),
               "library_device_ms": device_ms(library),
               "bound_ms": b_ms, "bound_by": b_by, "mbytes": nbytes / 1e6,
               "max_abs_err": max(e for _, e, _ in errs)}
        rec["gb_per_s"] = nbytes / rec["kernel_ms"] / 1e6
        rec["device_x_library"] = rec["device_ms"] / rec["library_device_ms"]
        rec["device_x_bound"] = rec["device_ms"] / rec["bound_ms"]
        log("user_kernels: timing %s %s" % (tag, json.dumps(rec)))
        results[(name, dt)] = rec
    check_user_kernel_edges(kernels, g)
    for dt in (torch.float32, torch.bfloat16):
        results[("double:default_grid", dt)] = time_default_grid(
            kernels["double"], inputs[("double", dt)], results[("double", dt)])
    del inputs, outs_by
    return launches, results


RAGGED_SHAPE = (FFN_SHAPE[0] - 1, FFN_SHAPE[1] - 1)    # (8191, 3071)
ODD_LENGTH = 1_000_003


def _edge_cases(name, dtype, gen):
    """(label, inputs, output shape) that the bodies' 16-byte loops must
    not get wrong: a ragged 2-D size, an odd 1-D length, and views that
    start one element past a 16-byte boundary (``x.view(-1)[1:]``; for
    relu_blocked, a block a row, as rows of the row length)."""
    n_in = 3 if name == "axpy" else 1
    out = [(label, [torch.randn(shape, generator=gen, device="cuda")
                    .to(dtype) for _ in range(n_in)], shape)
           for label, shape in (("ragged", RAGGED_SHAPE),
                                ("odd-1d", (ODD_LENGTH,)))]
    views = [torch.randn(FFN_SHAPE, generator=gen, device="cuda").to(dtype)
             .view(-1)[1:] for _ in range(n_in)]
    if name == "relu_blocked":
        rows, cols = FFN_SHAPE[0] - 1, FFN_SHAPE[1]
        views = [v[:rows * cols].view(rows, cols) for v in views]
    out.append(("misaligned", views, tuple(views[0].shape)))
    return out


def check_user_kernel_edges(kernels, gen):
    """Each body against its plain version at the edge cases of
    :func:`_edge_cases`, in fp32 (1e-6) and bf16 (``compare``'s bf16
    rule)."""
    for name, k in kernels.items():
        body = USER_KERNELS[name]
        for dt in (torch.float32, torch.bfloat16):
            tol = 1e-6 if dt == torch.float32 else 2e-3
            for label, xs, shape in _edge_cases(name, dt, gen):
                if label == "misaligned" and xs[0].data_ptr() % 16 == 0:
                    raise RuntimeError("the misaligned view is aligned")
                got = k.run(xs, [(shape, dt)])[0]
                want = body["plain"](*[x.float() for x in xs])
                err, ok = compare(got, want, tol)
                log("user_kernels: %s %s %s %s (address %% 16 = %d) | max|d| "
                    "vs plain %.3g (tol %g) %s"
                    % (name, str(dt).replace("torch.", ""), label,
                       "x".join(map(str, shape)), xs[0].data_ptr() % 16,
                       err, tol, "ok" if ok else "FAIL"))
                if not ok:
                    raise RuntimeError("user kernel %s disagrees with its "
                                       "plain version at %s" % (name, label))


def time_default_grid(k, xs, rec):
    """The grid-agnostic ``double`` body launched on the facility's default
    grid (one thread an entry, ``grid=None``) against its plain version,
    and its times beside those of the explicit grid (``rec``): the cost of
    the default on a vectorised body."""
    from mxnet_tpu_torch import tpu_kernel
    body = USER_KERNELS["double"]
    dt = xs[0].dtype
    k_def = tpu_kernel.Kernel(**dict(kernel_args(body), grid=None,
                                     name="double_default_grid"))
    got = k_def.run(xs, [(FFN_SHAPE, dt)])[0]
    err, ok = compare(got, body["plain"](*[x.float() for x in xs]),
                      1e-6 if dt == torch.float32 else 2e-3)
    run = lambda: k_def.run(xs, [(FFN_SHAPE, dt)])  # noqa: E731
    out = dict(rec, kernel_ms=time_ms(run), device_ms=device_ms(run),
               max_abs_err=err)
    out["gb_per_s"] = out["mbytes"] / out["kernel_ms"]
    out["device_x_library"] = out["device_ms"] / out["library_device_ms"]
    out["device_x_bound"] = out["device_ms"] / out["bound_ms"]
    tag = "double %s %s" % (str(dt).replace("torch.", ""),
                            "x".join(map(str, FFN_SHAPE)))
    log("user_kernels: default grid (%d blocks of 256) %s | max|d| vs plain "
        "%.3g %s; device %.4f ms against %.4f ms on the explicit grid "
        "(%.4f ms for the library call) %s"
        % (-(-int(np.prod(FFN_SHAPE)) // 256), tag, err, "ok" if ok
           else "FAIL", out["device_ms"], rec["device_ms"],
           rec["library_device_ms"], json.dumps(out)))
    if not ok:
        raise RuntimeError("the default-grid launch disagrees with the plain "
                           "version: " + tag)
    return out


# ---------------------------------------------------------------------------
# 8. the imperative front end at full width: BERT-base through nd/autograd
# ---------------------------------------------------------------------------

def phase_imperative(train_step_ms):
    """BERT-base with the MLM decoder through ``nd``, ``autograd.record()``
    and ``backward()``; returns the kernel launches of the bf16 main path."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, initializer, nd
    from mxnet_tpu_torch.gluon.block import functionalize
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.bert import bert_12_768_12
    from mxnet_tpu_torch.ops import _kernels
    ce = SoftmaxCrossEntropyLoss()

    def loss_fn(outputs, labels):
        """The train phase's loss on tensors, for the reference path."""
        return ce(outputs[-1].float(), labels).mean()

    net = bert_12_768_12(vocab_size=VOCAB, max_length=SEQ_LEN, dropout=0.0,
                         use_classifier=False)
    net.initialize(initializer.Normal(0.02), seed=SEED)
    n_layers = len(net.encoder.transformer_cells)

    def imperative_pass(tok, seg, lab):
        with autograd.record():
            loss = ce(net(tok, seg)[-1].astype("float32"), lab).mean()
        loss.backward()
        return loss

    def grads():
        return {n: torch.zeros_like(p) if p.grad is None
                else p.grad.detach().clone()
                for n, p in net.named_parameters()}

    # (a) fp32, batch 2: against the functionalize path, and 'write'
    host = train_batch_host(2)
    tok, seg, lab = (nd.array(a, ctx=mx.gpu(0)) for a in host)
    loss_i = float(imperative_pass(tok, seg, lab).asscalar())
    first = grads()
    loss_i2 = float(imperative_pass(tok, seg, lab).asscalar())
    second = grads()
    pure_fn, params = functionalize(net)
    loss_f, ref = functional_grads(pure_fn, params, loss_fn,
                                   *(torch.from_numpy(a).cuda()
                                     for a in host))
    worst, worst_again, bitwise = 0.0, 0.0, True
    for n, want in ref.items():
        top = float(want.abs().max())
        err = float((first[n] - want).abs().max())
        again = float((second[n] - first[n]).abs().max())
        bitwise = bitwise and torch.equal(second[n], first[n])
        if not err <= 1e-5 * top:
            raise RuntimeError("imperative fp32 gradient of %s differs from "
                               "the functionalize path by %.3g (max|ref| "
                               "%.3g)" % (n, err, top))
        if not again <= 1e-6 * float(first[n].abs().max()):
            raise RuntimeError("a second backward() changed the gradient of "
                               "%s by %.3g: 'write' must overwrite"
                               % (n, again))
        worst = max(worst, err / (top + 1e-30))
        worst_again = max(worst_again, again)
    log("imperative: fp32 batch-2 loss %.7f (again %.7f) vs the functionalize"
        " path %.7f; worst max|d|/max|ref| over %d gradients %.3g (tol "
        "1e-5); second backward() overwrote: max|d| %.3g, bitwise equal %s"
        % (loss_i, loss_i2, loss_f, len(ref), worst, worst_again, bitwise))
    if not abs(loss_i - loss_f) <= 1e-5 * abs(loss_f):
        raise RuntimeError("imperative fp32 loss %.7f vs %.7f"
                           % (loss_i, loss_f))
    del first, second, ref, params, pure_fn
    for p in net.parameters():
        p.grad = None

    # (b) bf16, batch 16: the imperative main path, counted
    net.cast("bfloat16")
    tok, seg, lab = (nd.array(a, ctx=mx.gpu(0))
                     for a in train_batch_host(TRAIN_BATCH))
    torch.cuda.synchronize()
    _kernels.reset_launches()
    losses = [imperative_pass(tok, seg, lab) for _ in range(IMPERATIVE_WARM)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [imperative_pass(tok, seg, lab)
               for _ in range(IMPERATIVE_TIMED)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = _kernels.launch_counts()
    # --- end of the counted main path ---
    launches = {k: counts[k] for k in ("flash_fwd", "flash_bwd_dq",
                                       "flash_bwd_dkv")}
    losses = [float(x.asscalar()) for x in losses]
    n_pass = IMPERATIVE_WARM + IMPERATIVE_TIMED
    rec = {"batch": TRAIN_BATCH, "seq": SEQ_LEN, "dtype": "bfloat16",
           "passes": n_pass, "ms_per_pass": dt / IMPERATIVE_TIMED * 1e3,
           "train_step_ms": train_step_ms, "losses": losses,
           "launches": launches}
    log("imperative: %s" % json.dumps(rec))
    if not all(np.isfinite(losses)):
        raise RuntimeError("imperative bf16 losses %s are not all finite"
                           % losses)
    if launches != {k: n_layers * n_pass for k in launches}:
        raise RuntimeError("the imperative passes launched %s, expected %d "
                           "of each kernel (%d layers x %d passes)"
                           % (launches, n_layers * n_pass, n_layers, n_pass))
    del net
    return launches


# ---------------------------------------------------------------------------
# 9. the ResNet-50 training path: convolutions, batch norm and pooling
# ---------------------------------------------------------------------------

RESNET_CLASSES, RESNET_IMAGE = 1000, 224
RESNET_BATCH, RESNET_CHECK_BATCH = 256, 2
RESNET_LR, RESNET_MOMENTUM = 0.1, 0.9
RESNET_WARM, RESNET_TIMED = 2, 10
RESNET_GFLOP = 3.87     # bench.py's forward GFLOP per 224 x 224 image
RESNET_STATS = ("running_mean", "running_var")
# substrings of the kernel names in a step's trace, by what they do
RESNET_KERNEL_GROUPS = {
    "batch_norm": ("batch_norm", "batchnorm", "bn_fw", "bn_bw"),
    "layout": ("nchwtonhwc", "nhwctonchw", "transpose"),
    "convolution": ("conv", "xmma", "wgrad", "dgrad", "fprop", "cudnn",
                    "implicit", "gemm", "sm90"),
    "pooling": ("pool",),
}


def resnet_batch_host(batch):
    """Images (N(0, 1), as the bench) and labels from the seed."""
    rng = np.random.RandomState(SEED + 9 + batch)
    x = rng.randn(batch, 3, RESNET_IMAGE, RESNET_IMAGE).astype(np.float32)
    return x, rng.randint(0, RESNET_CLASSES, batch).astype(np.int64)


def resnet_loss(logits, labels):
    """The bench's loss: mean cross-entropy of the fp32 log-softmax."""
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    return SoftmaxCrossEntropyLoss()(logits.float(), labels).mean()


def _worst(got, want, scale, floor):
    """max over tensors of max|got - want| / (scale * max|want| + floor),
    and the tensor that reaches it (the check passes at <= 1)."""
    worst, at = 0.0, None
    for n, w in want.items():
        err = float((got[n].double() - w.double()).abs().max())
        ratio = err / (scale * float(w.abs().max()) + floor)
        if not ratio <= worst:
            worst, at = ratio, n
    return worst, at


def _worst_l2(got, want, floor):
    """max over tensors of ||got - want|| / (||want|| + floor) (L2 norms),
    and the tensor that reaches it."""
    worst, at = 0.0, None
    for n, w in want.items():
        w = w.double()
        ratio = float((got[n].double() - w).norm()) / (float(w.norm())
                                                      + floor)
        if not ratio <= worst:
            worst, at = ratio, n
    return worst, at


def resnet_fp32_checks(net):
    """fp32 at batch 2, with ``torch.backends.cudnn.allow_tf32`` True, so
    only the convolution op's own scope keeps cuDNN off TF32.

    (a) One ``TrainStep`` step on the card against the same step on a CPU
    copy: the loss within 1e-4 relative; each parameter's change within
    0.1 of the CPU's change in L2 norm (plus 1e-6 of the whole update's
    norm: a conv bias ahead of a training-mode BatchNorm moves by rounding
    alone); the running statistics
    bitwise unchanged on both.  A per-entry rule cannot hold here: this
    net at its initialisation amplifies rounding ~1000x through the
    training-mode BatchNorms, the forward drifts ~1e-4 by the last stage
    in fp32, and ReLU masks of entries near 0 flip, so fp32 on the CPU
    itself misses fp64 by up to ~17 % in the largest entry of a last-stage
    weight's gradient and by ~2-3 % in L2, where TF32-rounded
    convolutions miss it by ~64-83 % in L2 (``tests/test_torch_resnet.py``
    run as a script prints these).  The CPU's fp32 step is also held
    against an fp64 step here, and both distances are printed.  (b) A predict-mode forward's logits within 2e-3 x max|CPU|.
    (c) ``autograd.record()`` + ``backward()`` on NDArrays against the
    functionalize path on the card, both with ``cudnn.deterministic``
    (the amplification makes run-to-run atomics in the weight gradients
    visible): every gradient within 1e-5 x its max|ref| plus 1e-6 x the
    net's largest gradient (a conv bias ahead of a training-mode
    BatchNorm has a gradient of zero but for rounding), and the running
    statistics the pass writes within 2e-3 x max|CPU| of those a training
    forward writes on the CPU copy."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch.gluon.block import functionalize
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.parallel import TrainStep
    x, y = resnet_batch_host(RESNET_CHECK_BATCH)
    p0 = {n: p.detach().cpu().clone() for n, p in net.named_parameters()}
    cpu_net = resnet50_v1(classes=RESNET_CLASSES).load_dict(p0,
                                                            device="cpu")
    cpu64 = resnet50_v1(classes=RESNET_CLASSES).load_dict(
        p0, device="cpu").cast("float64")
    stats = [n for n in p0 if n.endswith(RESNET_STATS)]
    torch.backends.cudnn.allow_tf32 = True
    try:
        # (a) one TrainStep step: card, CPU, and CPU in fp64
        after, losses = {}, {}
        for key, model, dev, xs in (("card", net, "cuda", x),
                                    ("cpu", cpu_net, "cpu", x),
                                    ("cpu64", cpu64, "cpu",
                                     x.astype(np.float64))):
            step = TrainStep(model, resnet_loss, device=dev,
                             learning_rate=RESNET_LR,
                             momentum=RESNET_MOMENTUM)
            losses[key] = float(step(xs, y))
            after[key] = {n: v.detach().cpu() for n, v in step.params.items()}
            del step
        del cpu64
        for key in after:
            moved = [n for n in stats
                     if not torch.equal(after[key][n].to(p0[n].dtype),
                                        p0[n])]
            if moved:
                raise RuntimeError("resnet fp32: TrainStep (%s) changed the "
                                   "running statistics %s" % (key, moved[:3]))
        change = {k: {n: after[k][n].double() - p0[n].double() for n in p0}
                  for k in after}
        # the floor: 1e-6 of the whole update's norm (a conv bias ahead of
        # a training-mode BatchNorm moves by rounding alone)
        floor = 1e-6 * float(torch.stack(
            [d.norm() for d in change["cpu"].values()]).norm())
        step_worst, step_at = _worst_l2(change["card"], change["cpu"], floor)
        cpu_vs_64, cpu_vs_64_at = _worst_l2(change["cpu"], change["cpu64"],
                                            floor)
        card_vs_64, _ = _worst_l2(change["card"], change["cpu64"], floor)
        rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
        # (b) predict mode
        xg = torch.from_numpy(x).cuda()
        with torch.no_grad():
            logits = net(xg).cpu()
            logits_cpu = cpu_net(torch.from_numpy(x))
        logit_err = float((logits - logits_cpu).abs().max())
        logit_top = float(logits_cpu.abs().max())
        # (c) the imperative pass against the functionalize path
        torch.backends.cudnn.deterministic = True
        pure_fn, params = functionalize(net)
        loss_f, ref = functional_grads(pure_fn, params, resnet_loss, xg,
                                       torch.from_numpy(y).cuda())
        ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        with autograd.record():
            loss_i = ce(net(nd.array(x, ctx=mx.gpu(0))),
                        nd.array(y, ctx=mx.gpu(0))).mean()
        loss_i.backward()
        got = {n: p.grad for n, p in net.named_parameters()
               if p.requires_grad}
        want = {n: ref[n] for n in got}
        top = max(float(g.abs().max()) for g in want.values())
        grad_worst, grad_at = _worst(got, want, 1e-5, 1e-6 * top)
        bitwise = all(torch.equal(got[n], want[n]) for n in want)
        with mx.cpu(), autograd.train_mode():
            cpu_net(nd.array(x))
        cpu_params = dict(cpu_net.named_parameters())
        card_params = dict(net.named_parameters())
        stats_worst, stats_at = _worst(
            {n: card_params[n].detach().cpu() for n in stats},
            {n: cpu_params[n].detach() for n in stats}, 2e-3, 1e-9)
        n_written = sum(not torch.equal(card_params[n].detach().cpu(), p0[n])
                        for n in stats)
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = False
    rec = {"batch": RESNET_CHECK_BATCH, "cudnn_allow_tf32": True,
           "loss_card": losses["card"], "loss_cpu": losses["cpu"],
           "loss_cpu64": losses["cpu64"], "loss_rel": rel,
           "step_change_worst_rel_l2": step_worst,
           "step_change_worst_at": step_at,
           "cpu_fp32_vs_fp64_worst_rel_l2": cpu_vs_64,
           "cpu_fp32_vs_fp64_worst_at": cpu_vs_64_at,
           "card_vs_fp64_worst_rel_l2": card_vs_64,
           "predict_logits_max_abs_err": logit_err,
           "predict_logits_max_abs": logit_top,
           "imperative_loss": float(loss_i.asscalar()),
           "functionalize_loss": loss_f,
           "imperative_grad_worst_ratio": grad_worst,
           "imperative_grad_worst_at": grad_at,
           "imperative_grads": len(got), "imperative_grads_bitwise": bitwise,
           "stats_written": n_written, "stats": len(stats),
           "stats_worst_ratio": stats_worst, "stats_worst_at": stats_at}
    log("resnet: fp32 checks %s" % json.dumps(rec))
    faults = []
    if not rel <= 1e-4:
        faults.append("TrainStep loss %.7f on the card vs %.7f on the CPU"
                      % (losses["card"], losses["cpu"]))
    if not step_worst <= 0.1:
        faults.append("TrainStep change of %s off the CPU's by %.3g in L2 "
                      "(tol 0.1)" % (step_at, step_worst))
    if not logit_err <= 2e-3 * logit_top:
        faults.append("predict logits off the CPU's by %.3g (max|ref| %.3g)"
                      % (logit_err, logit_top))
    if not abs(rec["imperative_loss"] - loss_f) <= 1e-5 * abs(loss_f):
        faults.append("imperative loss %.7f vs functionalize %.7f"
                      % (rec["imperative_loss"], loss_f))
    if not grad_worst <= 1.0:
        faults.append("imperative gradient of %s off the functionalize "
                      "path's by %.3g x the limit" % (grad_at, grad_worst))
    if n_written != len(stats) or not stats_worst <= 1.0:
        faults.append("imperative pass wrote %d of %d running statistics, "
                      "worst %s at %.3g x the limit"
                      % (n_written, len(stats), stats_at, stats_worst))
    if faults:
        raise RuntimeError("resnet fp32: " + "; ".join(faults))
    for p in net.parameters():
        p.grad = None
    return rec


def resnet_kernel_groups(by_name, groups=None):
    """Device ms of a traced step by ``groups`` (default
    :data:`RESNET_KERNEL_GROUPS`; a kernel counts in the first group one
    of whose substrings its lower-cased name holds; the rest under
    ``other``)."""
    groups = RESNET_KERNEL_GROUPS if groups is None else groups
    out = {g: 0.0 for g in list(groups) + ["other"]}
    for name, (ms, _) in by_name.items():
        low = name.lower()
        group = next((g for g, keys in groups.items()
                      if any(k in low for k in keys)), "other")
        out[group] += ms
    return out


def phase_resnet(peaks):
    """``resnet50_v1`` (1000 classes, 224 x 224, ``Xavier`` from the seed):
    the fp32 checks of :func:`resnet_fp32_checks`, then the bench's
    configuration (bf16, batch 256, SGD lr 0.1, momentum 0.9, 2 warm and
    10 timed steps on one batch, as ``bench.py run_bench``); returns the
    kernel launches of that main path (none of K1-K4 is on it)."""
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon.block import functionalize
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.ops import _kernels
    from mxnet_tpu_torch.parallel import TrainStep
    net = resnet50_v1(classes=RESNET_CLASSES)
    net.initialize(initializer.Xavier(), seed=SEED)
    n_params = sum(p.numel() for p in net.parameters())
    checks = resnet_fp32_checks(net)

    # the fp32 loss of the same parameters and batch on the card
    x_host, y_host = resnet_batch_host(RESNET_BATCH)
    x = torch.from_numpy(x_host).cuda().bfloat16()
    y = torch.from_numpy(y_host).cuda()
    del x_host
    pure_fn, params = functionalize(net)
    with torch.no_grad():
        loss32 = float(resnet_loss(pure_fn(params, x.float(), training=True),
                                   y))
    del pure_fn, params
    net.cast("bfloat16")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # --- the ResNet-50 main path, counted ---
    _kernels.reset_launches()
    step = TrainStep(net, resnet_loss, learning_rate=RESNET_LR,
                     momentum=RESNET_MOMENTUM)
    losses = [step(x, y) for _ in range(RESNET_WARM)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step(x, y) for _ in range(RESNET_TIMED)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _kernels.launch_counts()
    # --- end of the counted main path ---

    losses = [float(v) for v in losses]
    gap = abs(losses[0] - loss32) / abs(loss32)
    log("resnet: bf16 batch-%d losses %s; fp32 loss of the same parameters "
        "and batch %.6f, first bf16 loss off it by %.3g relative (tol 2e-2)"
        % (RESNET_BATCH, json.dumps(losses), loss32, gap))
    if not all(np.isfinite(losses)):
        raise RuntimeError("resnet bf16: losses %s are not all finite"
                           % losses)
    if not gap <= 2e-2:
        raise RuntimeError("resnet bf16: first loss %.6f vs fp32 %.6f"
                           % (losses[0], loss32))
    if any(launches.values()):
        raise RuntimeError("resnet: the path launched %s; none of K1-K4 is "
                           "on it" % launches)
    images_per_s = RESNET_BATCH * RESNET_TIMED / dt
    # the bench's formula: forward + backward = 3 x 3.87 GFLOP an image
    tflops = images_per_s * 3 * RESNET_GFLOP * 1e9 / 1e12
    rec = {"batch": RESNET_BATCH, "image": RESNET_IMAGE, "dtype": "bfloat16",
           "n_params": n_params, "step_ms": dt / RESNET_TIMED * 1e3,
           "images_per_s": images_per_s, "tflops": tflops,
           "mfu": tflops * 1e12 / peaks["bf16"],
           "peak_tflops": peaks["bf16"] / 1e12,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "fp32_loss": loss32, "first_loss_rel_gap": gap}

    # one more step under the profiler: device time by kernel, idle share
    prof, wall_ms = profiled(lambda: step(x, y))
    total, busy, by_name = log_kernel_breakdown("resnet", prof, top=14)
    groups = resnet_kernel_groups(by_name)
    rec.update({"traced_step_wall_ms": wall_ms, "device_busy_ms": busy,
                "traced_device_ms": total,
                "device_idle_share": 1.0 - busy / wall_ms,
                "kernel_names": len(by_name), "device_ms_by_group": groups,
                "share_by_group": {g: _share(ms, total)
                                   for g, ms in groups.items()},
                "fp32_checks": checks})
    log("resnet: %s" % json.dumps(rec))
    del step, net, x, y
    return launches


# ---------------------------------------------------------------------------
# 10. the Gluon eager training path: Parameter, Trainer, the optimizers
# ---------------------------------------------------------------------------

EAGER_BATCH, EAGER_WARM, EAGER_TIMED = 64, 3, 10
EAGER_LR, EAGER_MOMENTUM = 0.1, 0.9
EAGER_BERT_WARM, EAGER_BERT_TIMED = 2, 5
# (name, optimizer parameters) of the on-card optimizer checks
EAGER_OPTIMIZERS = [
    ("sgd", {"learning_rate": 0.1}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
             "clip_gradient": 0.5}),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}),
    ("adam", {"learning_rate": 1e-3, "wd": 1e-4}),
    ("adamw", {"learning_rate": 1e-3, "wd": 1e-2}),
    ("lamb", {"learning_rate": 1e-3, "wd": 1e-2}),
]
# BERT-base-like leaves: a projection, a bias, a conv filter bank
EAGER_OPT_SHAPES = [(768, 768), (3072,), (64, 3, 7, 7)]


def eager_resnet(peaks):
    """(a) ``resnet18_v1`` (1000 classes, 224 x 224, ``Xavier`` from the
    seed) as ``bench.py --eager`` runs it: fp32, batch 64, ``gluon.Trainer``
    (SGD lr 0.1, momentum 0.9), ``SoftmaxCrossEntropyLoss`` and
    ``metric.Accuracy``, each step copying its host batch to the card.
    First one ``Trainer.step`` against one ``TrainStep`` step from the same
    parameters and batch under ``cudnn.deterministic``: the batch-mean
    loss within 1e-6 relative and every trainable parameter within 1e-6
    relative in L2 (BatchNorm's running statistics left out: only the
    eager loop writes them).  Then 3 warm and 10 timed steps; returns the
    record and the kernel launches of the timed path (none of K1-K4)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, initializer, nd
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet18_v1
    from mxnet_tpu_torch.ops import _kernels
    from mxnet_tpu_torch.parallel import TrainStep
    net = resnet18_v1(classes=RESNET_CLASSES)
    net.initialize(initializer.Xavier(), seed=SEED)
    net.hybridize()
    params = net.collect_params()
    trainer = gluon.Trainer(params, "sgd", {"learning_rate": EAGER_LR,
                                            "momentum": EAGER_MOMENTUM})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    metric = mx.metric.Accuracy()
    x_np, y_np = resnet_batch_host(EAGER_BATCH)
    y_np = y_np.astype(np.float32)              # the bench's label dtype

    def step(xb=None, yb=None):
        if xb is None:          # the bench's stream: a host batch a step
            xb = nd.array(x_np, ctx=mx.gpu(0))
            yb = nd.array(y_np, ctx=mx.gpu(0))
        with autograd.record():
            out = net(xb)
            loss = loss_fn(out, yb)
        loss.backward()
        trainer.step(EAGER_BATCH)
        metric.update([yb], [out])
        return loss

    # the Trainer step against a TrainStep step, same start and batch
    torch.backends.cudnn.deterministic = True
    try:
        ref = TrainStep(net, resnet_loss, learning_rate=EAGER_LR,
                        momentum=EAGER_MOMENTUM)
        ref_loss = float(ref(torch.from_numpy(x_np).cuda(),
                             torch.from_numpy(y_np).cuda().long()))
        loss = float(step().mean().asscalar())
    finally:
        torch.backends.cudnn.deterministic = False
    worst, worst_at, bitwise, n_checked = 0.0, None, True, 0
    for name, p in params.items():
        if p.grad_req == "null":
            continue
        got, want = p.data().data.detach(), ref.params[name]
        n_checked += 1
        bitwise = bitwise and torch.equal(got, want)
        rel = float((got.double() - want.double()).norm()) / \
            (float(want.double().norm()) + 1e-30)
        if not rel <= worst:
            worst, worst_at = rel, name
    del ref
    check = {"loss_trainer": loss, "loss_train_step": ref_loss,
             "loss_rel": abs(loss - ref_loss) / abs(ref_loss),
             "params_checked": n_checked, "worst_rel_l2": worst,
             "worst_at": worst_at, "bitwise": bitwise}
    log("eager: resnet18 Trainer step vs TrainStep step %s (tol 1e-6)"
        % json.dumps(check))
    if not check["loss_rel"] <= 1e-6 or not worst <= 1e-6:
        raise RuntimeError("eager: the Trainer step is off TrainStep's: %s"
                           % check)

    # --- the eager ResNet-18 main path, counted ---
    _kernels.reset_launches()
    losses = [step() for _ in range(EAGER_WARM)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses += [step() for _ in range(EAGER_TIMED)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _kernels.launch_counts()
    # --- end of the counted main path ---
    losses = [float(v.mean().asscalar()) for v in losses]
    if not all(np.isfinite(losses)):
        raise RuntimeError("eager resnet18: losses %s are not all finite"
                           % losses)
    if any(launches.values()):
        raise RuntimeError("eager resnet18: the path launched %s; none of "
                           "K1-K4 is on it" % launches)
    name, acc = metric.get()
    rec = {"batch": EAGER_BATCH, "image": RESNET_IMAGE, "dtype": "float32",
           "images_per_s": EAGER_BATCH * EAGER_TIMED / dt,
           "step_ms": dt / EAGER_TIMED * 1e3, "losses": losses,
           "metric": [name, acc],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    # the same steps with the batch already on the card: what the
    # synchronous host copy costs the step
    xb, yb = nd.array(x_np, ctx=mx.gpu(0)), nd.array(y_np, ctx=mx.gpu(0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(EAGER_TIMED):
        step(xb, yb)
    torch.cuda.synchronize()
    rec["resident_batch_step_ms"] = \
        (time.perf_counter() - t0) / EAGER_TIMED * 1e3

    # one traced step (idle share, kernel groups), then the optimizer's
    # apply alone: its kernels and device time
    prof, wall_ms = profiled(step)
    total, busy, by_name = log_kernel_breakdown("eager", prof, top=12)
    groups = resnet_kernel_groups(by_name)
    with autograd.record():
        loss = loss_fn(net(nd.array(x_np, ctx=mx.gpu(0))),
                       nd.array(y_np, ctx=mx.gpu(0)))
    loss.backward()
    torch.cuda.synchronize()
    prof, apply_wall_ms = profiled(lambda: trainer.step(EAGER_BATCH),
                                   tries=1)
    apply_total, _, apply_names = log_kernel_breakdown("eager: apply", prof,
                                                       top=4)
    apply_host = []                 # the apply alone, untraced
    for _ in range(5):
        t0 = time.perf_counter()
        trainer.step(EAGER_BATCH)
        torch.cuda.synchronize()
        apply_host.append((time.perf_counter() - t0) * 1e3)
    rec.update({"traced_step_wall_ms": wall_ms, "device_busy_ms": busy,
                "traced_device_ms": total,
                "device_idle_share": 1.0 - busy / wall_ms,
                "device_ms_by_group": groups,
                "share_by_group": {g: _share(ms, total)
                                   for g, ms in groups.items()},
                "optimizer_apply": {
                    "trainable_params": n_checked,
                    "device_kernels": sum(n for _, n in
                                          apply_names.values()),
                    "device_ms": apply_total, "traced_wall_ms": apply_wall_ms,
                    "wall_ms": sorted(apply_host)[2]},
                "step_check": check})
    log("eager: resnet18 %s" % json.dumps(rec))
    del trainer, net, params
    return rec, launches


def eager_bert(train_step_ms):
    """(b) BERT-base with the MLM decoder (as the train phase: bf16, batch
    16, T = 512, dropout 0) trained through ``nd``/``autograd.record()``/
    ``backward()`` and ``gluon.Trainer.step(1)`` (SGD lr 1e-3, momentum
    0.9; the loss is the batch mean): 2 warm and 5 timed steps, each loss
    within 1e-2 relative of ``TrainStep``'s trajectory from the same
    parameters and batch, K1, K2 and K3 launched 12 times a step; ms per
    step beside ``TrainStep``'s, and one traced step's device idle
    share."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, initializer, nd
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.bert import bert_12_768_12
    from mxnet_tpu_torch.ops import _kernels
    from mxnet_tpu_torch.parallel import TrainStep
    ce = SoftmaxCrossEntropyLoss()
    net = bert_12_768_12(vocab_size=VOCAB, max_length=SEQ_LEN, dropout=0.0,
                         use_classifier=False)
    net.initialize(initializer.Normal(0.02), seed=SEED)
    net.cast("bfloat16")
    n_layers = len(net.encoder.transformer_cells)
    host = train_batch_host(TRAIN_BATCH)
    n_steps = EAGER_BERT_WARM + EAGER_BERT_TIMED
    ref = TrainStep(net, lambda out, lab: ce(out[-1].float(), lab).mean(),
                    learning_rate=TRAIN_LR, momentum=TRAIN_MOMENTUM)
    ref_losses = [float(ref(*host)) for _ in range(n_steps)]
    del ref
    torch.cuda.empty_cache()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": TRAIN_LR,
                             "momentum": TRAIN_MOMENTUM})
    tok, seg, lab = (nd.array(a, ctx=mx.gpu(0)) for a in host)

    def step():
        with autograd.record():
            loss = ce(net(tok, seg)[-1].astype("float32"), lab).mean()
        loss.backward()
        trainer.step(1)
        return loss

    # --- the eager BERT main path, counted ---
    torch.cuda.synchronize()
    _kernels.reset_launches()
    losses = [step() for _ in range(EAGER_BERT_WARM)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step() for _ in range(EAGER_BERT_TIMED)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = _kernels.launch_counts()
    # --- end of the counted main path ---
    launches = {k: counts[k] for k in ("flash_fwd", "flash_bwd_dq",
                                       "flash_bwd_dkv")}
    losses = [float(v.asscalar()) for v in losses]
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    prof, wall_ms = profiled(step)
    busy = device_busy_ms(prof)
    rec = {"batch": TRAIN_BATCH, "seq": SEQ_LEN, "dtype": "bfloat16",
           "steps": n_steps, "step_ms": dt / EAGER_BERT_TIMED * 1e3,
           "train_step_ms": train_step_ms, "losses": losses,
           "train_step_losses": ref_losses, "max_rel_gap": max(gaps),
           "launches": launches, "traced_step_wall_ms": wall_ms,
           "device_busy_ms": busy, "device_idle_share": 1.0 - busy / wall_ms}
    log("eager: bert %s" % json.dumps(rec))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError("eager bert: losses %s are not finite or do not "
                           "fall" % losses)
    if max(gaps) > 1e-2:
        raise RuntimeError("eager bert: loss trajectory %.3g from "
                           "TrainStep's" % max(gaps))
    if launches != {k: n_layers * n_steps for k in launches}:
        raise RuntimeError("eager bert: launched %s, expected %d of each "
                           "kernel (%d layers x %d steps)"
                           % (launches, n_layers * n_steps, n_layers,
                              n_steps))
    del trainer, net
    return rec, launches


def eager_optimizers():
    """(c) Each optimizer of :data:`EAGER_OPTIMIZERS`, in fp32 and in bf16
    with ``multi_precision``, fused (the default ``aggregate_num``) and one
    parameter at a time (``aggregate_num=0``): one ``Updater`` step from one
    numpy state (weights, gradients, every state buffer set to |N(0,
    0.01)|) on the card and on the CPU.  fp32 weights, states and masters
    within 1e-6 + 1e-5 * |CPU|; a bf16 weight against the CPU's float32
    master by :func:`compare`'s bf16 rule at 1e-5."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd, optimizer
    rng = np.random.RandomState(SEED + 10)
    host_w = [rng.randn(*s).astype(np.float32) * 0.1
              for s in EAGER_OPT_SHAPES]
    host_g = [rng.randn(*s).astype(np.float32) for s in EAGER_OPT_SHAPES]
    host_s = [np.abs(rng.randn(*s)).astype(np.float32) * 0.01
              for s in EAGER_OPT_SHAPES]

    def host(tensors):
        return [t.data.detach().float().cpu() for t in tensors]

    def run(ctx, name, kw, dtype, aggregate):
        opt = optimizer.create(name, rescale_grad=1.0 / 64,
                               multi_precision=dtype == "bfloat16",
                               **dict(kw, **({} if aggregate
                                             else {"aggregate_num": 0})))
        upd = optimizer.get_updater(opt)
        ws = [nd.array(w, ctx=ctx, dtype=dtype) for w in host_w]
        gs = [nd.array(g, ctx=ctx, dtype=dtype) for g in host_g]
        inner, masters = [], []
        for i, w in enumerate(ws):
            state = opt.create_state_multi_precision(i, w)
            mp = opt._is_mp_state(w, state)
            for leaf in _state_leaves(state[0] if mp else state):
                leaf[:] = host_s[i]
                inner.append(leaf)
            if mp:
                masters.append(state[1])
            upd.states[i] = state
        upd(list(range(len(ws))), gs, ws)
        torch.cuda.synchronize()
        return host(ws), host(inner), host(masters)

    rows = []
    for name, kw in EAGER_OPTIMIZERS:
        for dtype in ("float32", "bfloat16"):
            for aggregate in (True, False):
                card = run(mx.gpu(0), name, kw, dtype, aggregate)
                cpu = run(mx.cpu(), name, kw, dtype, aggregate)
                exact = card[1] + card[2] + \
                    (card[0] if dtype == "float32" else [])
                want = cpu[1] + cpu[2] + (cpu[0] if dtype == "float32"
                                          else [])
                worst, ok = 0.0, len(exact) == len(want)
                for a, b in zip(exact, want):
                    err = (a - b).abs()
                    worst = max(worst, float(err.max()))
                    ok = ok and bool((err <= 1e-6 + 1e-5 * b.abs()).all())
                if dtype == "bfloat16":
                    for a, m in zip(card[0], cpu[2]):
                        err, good = compare(a.bfloat16(), m, 1e-5)
                        worst = max(worst, err)
                        ok = ok and good
                row = {"optimizer": name, "params": kw, "dtype": dtype,
                       "fused": aggregate, "max_abs_err": worst, "ok": ok}
                rows.append(row)
                log("eager: optimizer %s" % json.dumps(row))
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise RuntimeError("eager: optimizers off their CPU step: %s" % bad)
    return rows


def _state_leaves(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [a for s in state for a in _state_leaves(s)]
    return [state]


def phase_eager(peaks, train_step_ms):
    """The Gluon eager training path: (a) :func:`eager_resnet`, (b)
    :func:`eager_bert`, (c) :func:`eager_optimizers`; returns the kernel
    launches of the eager main paths (a) and (b)."""
    resnet, resnet_launches = eager_resnet(peaks)
    gc.collect()
    torch.cuda.empty_cache()
    bert, bert_launches = eager_bert(train_step_ms)
    gc.collect()
    torch.cuda.empty_cache()
    eager_optimizers()
    launches = dict(resnet_launches)
    for k, n in bert_launches.items():
        launches[k] = launches.get(k, 0) + n
    return launches


# ---------------------------------------------------------------------------
# 11. AMP: the dtype policy at the registered-op dispatch
# ---------------------------------------------------------------------------

AMP_RESNET_STEPS = 4            # steps held to fp32's; then EAGER_TIMED
AMP_FP16_SCALE = 1024.0         # the first loss scale of part (c)
# substrings of the kernel names in an AMP BERT step's trace
AMP_KERNEL_GROUPS = {
    "flash": ("flash_",),
    "gemm": ("gemm", "cutlass", "xmma", "sm90"),
    "cast_copy": ("copy",),
    "softmax_norm_reduce": ("softmax", "norm", "reduce"),
    "elementwise": ("elementwise",),
}


def cast_device_ms(prof):
    """Device ms and calls of the dtype casts in a trace: the kernels that
    ``aten::_to_copy`` (``Tensor.to(dtype)``, the AMP cast, and the loss's
    ``float()``) launched."""
    for e in prof.key_averages():
        if e.key == "aten::_to_copy":
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = e.cuda_time_total
            return us / 1e3, e.count
    return 0.0, 0


_TRACED_FLASH = re.compile(r"flash_(?:fwd|bwd_dq|bwd_dkv)(?:_bf16|_tf32)?"
                           r"_kernel")


def flash_kernel_calls(by_name):
    """Calls of each flash kernel in a breakdown, by instantiation name
    (``_bf16`` / ``_tf32``)."""
    out = {}
    for name, (_, n) in by_name.items():
        m = _TRACED_FLASH.search(name)
        if m:
            out[m.group(0)] = out.get(m.group(0), 0) + n
    return out


def amp_bert(peaks, train_step_ms):
    """(a) BERT-base with the MLM decoder (the train phase's configuration:
    batch 16, T = 512, dropout 0) with **fp32 parameters under
    ``amp.init()``** (bf16), trained through ``record()``/``backward()``,
    ``amp.init_trainer``, ``amp.scale_loss`` and ``Trainer.step(1)`` (SGD
    lr 1e-3, momentum 0.9): 2 warm and 5 timed steps; each loss within
    1e-2 relative of the same step with attention on the composition, the
    first within 1e-2 of the fp32 loss of the same parameters and batch,
    K1, K2 and K3 in bf16 launched 12 times a step, every parameter still
    float32.  ms a step, tokens/s, MFU, one traced step's idle share, the
    casts' device time and the top kernel groups."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp, autograd, gluon, initializer, nd
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.bert import bert_12_768_12
    from mxnet_tpu_torch.ops import _kernels
    from mxnet_tpu_torch.ops.attention import attention_impl_scope
    ce = SoftmaxCrossEntropyLoss()
    tok, seg, lab = (nd.array(a, ctx=mx.gpu(0))
                     for a in train_batch_host(TRAIN_BATCH))
    n_steps = EAGER_BERT_WARM + EAGER_BERT_TIMED

    def build():
        net = bert_12_768_12(vocab_size=VOCAB, max_length=SEQ_LEN,
                             dropout=0.0, use_classifier=False)
        net.initialize(initializer.Normal(0.02), seed=SEED)
        return net

    def loop(net):
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": TRAIN_LR,
                                 "momentum": TRAIN_MOMENTUM})
        amp.init_trainer(trainer)

        def step():
            with autograd.record():
                loss = ce(net(tok, seg)[-1].astype("float32"), lab).mean()
                with amp.scale_loss(loss, trainer) as scaled:
                    pass
            scaled.backward()
            trainer.step(1)
            return loss
        return step

    net = build()
    n_layers = len(net.encoder.transformer_cells)
    n_params = sum(p.numel() for p in net.parameters())
    fp32_loss = float(ce(net(tok, seg)[-1], lab).mean().asscalar())
    amp.init()
    try:
        with attention_impl_scope("xla"):
            step = loop(net)
            ref_losses = [float(step().asscalar()) for _ in range(n_steps)]
        del net, step
        gc.collect()
        torch.cuda.empty_cache()
        net = build()
        step = loop(net)

        # --- the AMP BERT main path, counted ---
        torch.cuda.synchronize()
        _kernels.reset_launches()
        losses = [step() for _ in range(EAGER_BERT_WARM)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [step() for _ in range(EAGER_BERT_TIMED)]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = _kernels.launch_counts()
        # --- end of the counted main path ---
        prof, wall_ms = profiled(step)
    finally:
        amp.turn_off()
    launches = {k: counts[k] for k in ("flash_fwd", "flash_bwd_dq",
                                       "flash_bwd_dkv")}
    losses = [float(v.asscalar()) for v in losses]
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    total, busy, by_name = log_kernel_breakdown("amp: bert", prof, top=12)
    flash_calls = flash_kernel_calls(by_name)
    cast_ms, cast_calls = cast_device_ms(prof)
    groups = resnet_kernel_groups(by_name, AMP_KERNEL_GROUPS)
    dtypes = sorted({str(p.dtype) for p in net.parameters()})
    tokens_per_s = TRAIN_BATCH * SEQ_LEN * EAGER_BERT_TIMED / dt
    flops_per_token = 6.0 * n_params + 12.0 * n_layers * SEQ_LEN * \
        net._units
    tflops = tokens_per_s * flops_per_token / 1e12
    rec = {"batch": TRAIN_BATCH, "seq": SEQ_LEN,
           "params": "float32", "amp": "bfloat16", "steps": n_steps,
           "step_ms": dt / EAGER_BERT_TIMED * 1e3,
           "train_step_ms": train_step_ms, "tokens_per_s": tokens_per_s,
           "tflops": tflops, "mfu": tflops * 1e12 / peaks["bf16"],
           "losses": losses, "composition_losses": ref_losses,
           "max_rel_gap": max(gaps), "fp32_first_loss": fp32_loss,
           "first_loss_rel_gap_vs_fp32": abs(losses[0] - fp32_loss) /
           abs(fp32_loss), "launches": launches,
           "traced_flash_calls": flash_calls, "param_dtypes": dtypes,
           "traced_step_wall_ms": wall_ms, "traced_device_ms": total,
           "device_busy_ms": busy, "device_idle_share": 1.0 - busy / wall_ms,
           "cast_device_ms": cast_ms, "cast_calls": cast_calls,
           "cast_share_of_device_time": _share(cast_ms, total),
           "device_ms_by_group": groups,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log("amp: bert %s" % json.dumps(rec))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError("amp bert: losses %s are not finite or do not "
                           "fall" % losses)
    if max(gaps) > 1e-2 or rec["first_loss_rel_gap_vs_fp32"] > 1e-2:
        raise RuntimeError("amp bert: losses %s off the composition's %s "
                           "or the fp32 loss %.6g" % (losses, ref_losses,
                                                      fp32_loss))
    if launches != {k: n_layers * n_steps for k in launches}:
        raise RuntimeError("amp bert: launched %s, expected %d of each "
                           "kernel" % (launches, n_layers * n_steps))
    want = {k + "_bf16_kernel": n_layers for k in launches}
    if flash_calls != want:
        raise RuntimeError("amp bert: the traced step ran the flash "
                           "kernels %s, expected the bf16 ones %s"
                           % (flash_calls, want))
    if dtypes != ["torch.float32"]:
        raise RuntimeError("amp bert: the master weights are %s" % dtypes)
    del net, step
    return rec, counts


def amp_resnet18():
    """``resnet18_v1`` as ``eager_resnet18`` builds it, with the loss
    scaled by ``amp.scale_loss``: ``(net, trainer, step)``, ``step(xb, yb,
    poison=False)`` one ``record()``/``backward()``/``Trainer.step``
    returning the batch-mean loss; ``poison`` sets the first weight's
    gradient to inf before the update."""
    from mxnet_tpu_torch import amp, autograd, gluon, initializer
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet18_v1
    net = resnet18_v1(classes=RESNET_CLASSES)
    net.initialize(initializer.Xavier(), seed=SEED)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": EAGER_LR,
                             "momentum": EAGER_MOMENTUM})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

    def step(xb, yb, poison=False):
        with autograd.record():
            loss = loss_fn(net(xb), yb).mean()
            with amp.scale_loss(loss, trainer) as scaled:
                pass
        scaled.backward()
        if poison:
            trainer._params[0].grad().data.fill_(float("inf"))
        trainer.step(1)
        return loss

    return net, trainer, step


def _dtype_spy():
    """Record the input dtypes of every ``Convolution`` and every
    BatchNorm normalisation run while the returned context is open."""
    import contextlib
    from mxnet_tpu_torch.ops import nn as nn_ops, registry
    seen = {"conv": set(), "batch_norm": set()}
    conv = registry.get_op("Convolution")

    @contextlib.contextmanager
    def spy():
        real_conv, real_bn = conv.fn, nn_ops.batch_norm_out

        def conv_fn(data, weight, *a, **kw):
            seen["conv"].add((str(data.dtype), str(weight.dtype)))
            return real_conv(data, weight, *a, **kw)

        def bn_fn(data, *a, **kw):
            seen["batch_norm"].add(str(data.dtype))
            return real_bn(data, *a, **kw)

        conv.fn, nn_ops.batch_norm_out = conv_fn, bn_fn
        try:
            yield seen
        finally:
            conv.fn, nn_ops.batch_norm_out = real_conv, real_bn
    return spy()


def amp_resnet():
    """(b) ``bench.py --eager``'s ``resnet18_v1`` (batch 64, the batch on
    the card) in fp32 and under ``amp.init()`` (bf16), each from the same
    seeded parameters: 4 steps each, the batch-mean losses within 1e-2
    relative of fp32's, then 10 timed steps each (images/s); the input
    dtypes of every convolution (bf16) and batch norm (fp32) during one
    traced AMP step, its idle share and casts.  (c) The same net under
    ``amp.init(target_dtype="float16")`` with the dynamic ``LossScaler``
    (first scale 1024): a clean step, a step whose first gradient is set
    to inf (every weight and momentum bitwise unchanged, the scale halved),
    and a clean step that updates (the running statistics, which every
    training forward writes, are not among the checked tensors).  Returns
    the records; none of K1-K4 is launched."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp, nd
    from mxnet_tpu_torch.ops import _kernels
    x_np, y_np = resnet_batch_host(EAGER_BATCH)
    xb = nd.array(x_np, ctx=mx.gpu(0))
    yb = nd.array(y_np.astype(np.float32), ctx=mx.gpu(0))
    _kernels.reset_launches()
    runs = {}
    for policy in (None, "bfloat16"):
        if policy:
            amp.init(policy)
        try:
            net, trainer, step = amp_resnet18()
            losses = [float(step(xb, yb).asscalar())
                      for _ in range(AMP_RESNET_STEPS)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(EAGER_TIMED):
                step(xb, yb)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            rec = {"losses": losses, "step_ms": dt / EAGER_TIMED * 1e3,
                   "images_per_s": EAGER_BATCH * EAGER_TIMED / dt}
            if policy:
                with _dtype_spy() as seen:
                    prof, wall_ms = profiled(lambda: step(xb, yb))
                total, busy, by_name = log_kernel_breakdown(
                    "amp: resnet18", prof, top=8)
                cast_ms, cast_calls = cast_device_ms(prof)
                rec.update({
                    "conv_input_dtypes": sorted(seen["conv"]),
                    "batch_norm_input_dtypes": sorted(seen["batch_norm"]),
                    "traced_step_wall_ms": wall_ms, "device_busy_ms": busy,
                    "device_idle_share": 1.0 - busy / wall_ms,
                    "cast_device_ms": cast_ms, "cast_calls": cast_calls,
                    "device_ms_by_group": resnet_kernel_groups(by_name),
                    "param_dtypes": sorted({str(p.dtype)
                                            for p in net.parameters()})})
        finally:
            amp.turn_off()
        runs[policy or "float32"] = rec
        del net, trainer, step
        gc.collect()
        torch.cuda.empty_cache()
    amp_rec, fp32_rec = runs["bfloat16"], runs["float32"]
    gaps = [abs(a - b) / abs(b) for a, b in zip(amp_rec["losses"],
                                                fp32_rec["losses"])]
    amp_rec["max_rel_gap_vs_fp32"] = max(gaps)
    amp_rec["fp32_step_ms"] = fp32_rec["step_ms"]
    amp_rec["fp32_images_per_s"] = fp32_rec["images_per_s"]
    amp_rec["fp32_losses"] = fp32_rec["losses"]
    log("amp: resnet18 bf16 %s" % json.dumps(amp_rec))
    if max(gaps) > 1e-2 or not all(np.isfinite(amp_rec["losses"])):
        raise RuntimeError("amp resnet18: losses %s off fp32's %s"
                           % (amp_rec["losses"], fp32_rec["losses"]))
    if amp_rec["conv_input_dtypes"] != [("torch.bfloat16",
                                         "torch.bfloat16")] or \
            amp_rec["batch_norm_input_dtypes"] != ["torch.float32"] or \
            amp_rec["param_dtypes"] != ["torch.float32"]:
        raise RuntimeError("amp resnet18: convolutions ran on %s, batch "
                           "norms on %s, parameters are %s"
                           % (amp_rec["conv_input_dtypes"],
                              amp_rec["batch_norm_input_dtypes"],
                              amp_rec["param_dtypes"]))

    # (c) float16 with the dynamic loss scaler, a gradient forced to inf
    amp.init(target_dtype="float16")
    try:
        net, trainer, step = amp_resnet18()
        amp.init_trainer(trainer)
        scaler = trainer._amp_loss_scaler
        scaler.loss_scale = AMP_FP16_SCALE

        trainable = [p for p in trainer._params if p.grad_req != "null"]

        def snapshot():
            # the weights and momenta; the running statistics are written
            # by every training forward, a skipped step's too, as in the
            # reference
            states = trainer._updaters[0].states
            return [p.data().data.clone() for p in trainable] + \
                [s.data.clone() for s in states.values() if s is not None]

        clean = float(step(xb, yb).asscalar())
        scale_clean = scaler.loss_scale
        before = snapshot()
        poisoned = float(step(xb, yb, poison=True).asscalar())
        after = snapshot()
        scale_poisoned = scaler.loss_scale
        nxt = float(step(xb, yb).asscalar())
        moved = snapshot()
    finally:
        amp.turn_off()
    n_weights = len(trainable)
    fp16 = {"scale_first": AMP_FP16_SCALE, "scale_after_clean": scale_clean,
            "scale_after_inf": scale_poisoned,
            "scale_after_next": scaler.loss_scale,
            "losses": [clean, poisoned, nxt],
            "tensors_checked": len(before),
            "skipped_step_bitwise": len(before) == len(after) and all(
                torch.equal(a, b) for a, b in zip(before, after)),
            "next_step_updated": not all(
                torch.equal(a, b) for a, b in zip(after[:n_weights],
                                                  moved[:n_weights]))}
    log("amp: resnet18 float16 loss scaler %s" % json.dumps(fp16))
    if not (scale_clean == AMP_FP16_SCALE and
            scale_poisoned == AMP_FP16_SCALE / 2 and
            fp16["skipped_step_bitwise"] and fp16["next_step_updated"] and
            len(before) == 2 * n_weights):
        raise RuntimeError("amp resnet18 float16: %s" % fp16)
    del net, trainer, step
    launches = _kernels.launch_counts()
    if any(launches.values()):
        raise RuntimeError("amp resnet18: the path launched %s; none of "
                           "K1-K4 is on it" % launches)
    return amp_rec, fp16


def phase_amp(peaks, train_step_ms):
    """``mx.amp`` at full width: (a) :func:`amp_bert`, (b) and (c)
    :func:`amp_resnet`; returns the kernel launches of (a)'s main path."""
    bert, launches = amp_bert(peaks, train_step_ms)
    gc.collect()
    torch.cuda.empty_cache()
    amp_resnet()
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# 12. the input pipeline: the prefetcher, the loader, RecordIO, mx.random
# ---------------------------------------------------------------------------

DATA_PARITY_STEPS = 4
DATA_GATE_PCT = 5.0     # the reference's gate on the data-wait share
LOADER_STEPS = 10       # timed loader-fed steps, after one warm step
LOADER_SAMPLES = EAGER_BATCH * (LOADER_STEPS + 1)   # one epoch, discarded
LOADER_CLASSES = 100    # class prototypes (the reference builds 1000)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
RECORDS = 512
RECORD_MAX = RESNET_IMAGE * RESNET_IMAGE * 3    # one 224 x 224 x 3 image
RECORD_MAGIC = (0xced7230a).to_bytes(4, "little")
RANDOM_N = 1_000_000
# the _random_* rows of tests/test_random.py's MOMENTS table: (op,
# params, mean, variance); its _npi_* rows wait for the numpy front end
RANDOM_MOMENTS = [
    ("_random_uniform", {"low": -1.0, "high": 3.0}, 1.0, 16.0 / 12.0),
    ("_random_normal", {"loc": 2.0, "scale": 3.0}, 2.0, 9.0),
    ("_random_gamma", {"alpha": 4.0, "beta": 0.5}, 2.0, 1.0),
    ("_random_exponential", {"lam": 2.0}, 0.5, 0.25),
    ("_random_poisson", {"lam": 6.0}, 6.0, 6.0),
    ("_random_negative_binomial", {"k": 5, "p": 0.5}, 5.0, 10.0),
    ("_random_generalized_negative_binomial", {"mu": 4.0, "alpha": 0.25},
     4.0, 4.0 + 0.25 * 16.0),
    ("_random_logistic", {"loc": 1.0, "scale": 0.5}, 1.0,
     np.pi ** 2 * 0.25 / 3.0),
    ("_random_gumbel", {"loc": 0.0, "scale": 1.0}, np.euler_gamma,
     np.pi ** 2 / 6.0),
    ("_random_rayleigh", {"scale": 2.0}, 2.0 * np.sqrt(np.pi / 2.0),
     (4.0 - np.pi) / 2.0 * 4.0),
    ("_random_weibull", {"a": 1.0}, 1.0, 1.0),
    ("_random_pareto", {"a": 5.0}, 0.25, 5.0 / 48.0),
]


def eager_resnet18():
    """A fresh ``resnet18_v1`` eager loop as ``eager_resnet`` builds it
    (``Xavier`` from the seed, SGD 0.1 / 0.9, softmax cross-entropy,
    ``metric.Accuracy``): ``(net, step)`` with ``step(xb, yb)`` one
    ``record()``/``backward()``/``Trainer.step`` on NDArrays on the card,
    returning the per-image losses."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, initializer
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet18_v1
    net = resnet18_v1(classes=RESNET_CLASSES)
    net.initialize(initializer.Xavier(), seed=SEED)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": EAGER_LR,
                             "momentum": EAGER_MOMENTUM})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    metric = mx.metric.Accuracy()

    def step(xb, yb):
        with autograd.record():
            out = net(xb)
            loss = loss_fn(out, yb)
        loss.backward()
        trainer.step(EAGER_BATCH)
        metric.update([yb], [out])
        return loss

    return net, step


def _on_card(batch):
    """A prefetched ``(x, y)`` (tensors or NDArrays) as NDArrays."""
    from mxnet_tpu_torch.ndarray import NDArray
    return [b if isinstance(b, NDArray) else NDArray(b) for b in batch]


def check_prefetch_streams():
    """The allocator hazard of a side-stream copy: each prefetched batch
    (64 MB, filled with its index) is read by a reduction queued behind
    ~25 ms of matmuls on the consumer's stream and then dropped, while the
    producer allocates and copies the next batches on its own stream.
    Without ``record_stream`` at the handoff the allocator may give a
    dropped batch's memory to a later copy before the reduction ran; every
    batch must read back its own index."""
    from mxnet_tpu_torch.io import DevicePrefetcher
    shape, n = (4096, 4096), 8
    a = torch.randn(shape, device="cuda") / 64.0

    def source():
        for i in range(n):
            yield (np.full(shape, float(i), np.float32),)

    seen = []
    with DevicePrefetcher(source(), depth=2) as pf:
        for (xb,) in pf:
            for _ in range(10):
                a = torch.tanh(a @ a)
            seen.append(torch.stack([xb.min(), xb.max()]))
            del xb
    torch.cuda.synchronize()
    got = [tuple(float(v) for v in s) for s in seen]
    want = [(float(i), float(i)) for i in range(n)]
    log("data: prefetch streams: batches read back %s (want %s)"
        % (got, want))
    if got != want:
        raise RuntimeError("data: a prefetched batch was overwritten before "
                           "its consumer read it: %s" % got)


def data_prefetch():
    """(a) The eager ResNet-18 step fed with and without the prefetcher,
    from ``bench.py --eager``'s stream (the same seeded host batch each
    step).  First the parity run: 4 steps each way from the same seeded
    parameters under ``cudnn.deterministic``, the per-image losses bitwise
    equal.  Then 3 warm and 10 timed steps each way: images/s, step ms,
    the data-wait total and share (the synchronous copies with the
    prefetcher off, the handoffs with it on) against the reference's 5 %
    gate, and one traced step's device idle share."""
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.io import DevicePrefetcher
    import mxnet_tpu_torch as mx
    x_np, y_np = resnet_batch_host(EAGER_BATCH)
    y_np = y_np.astype(np.float32)              # the bench's label dtype
    n_batches = EAGER_WARM + EAGER_TIMED + 3    # 3 more for the trace
    check_prefetch_streams()

    torch.backends.cudnn.deterministic = True
    try:
        trajectories = {}
        for way in ("off", "on"):
            net, step = eager_resnet18()
            if way == "off":
                losses = [step(nd.array(x_np, ctx=mx.gpu(0)),
                               nd.array(y_np, ctx=mx.gpu(0)))
                          for _ in range(DATA_PARITY_STEPS)]
            else:
                with DevicePrefetcher([(x_np, y_np)] *
                                      DATA_PARITY_STEPS) as pf:
                    losses = [step(*_on_card(b)) for b in pf]
            trajectories[way] = [l.data.detach().clone() for l in losses]
            del net, step
    finally:
        torch.backends.cudnn.deterministic = False
    bitwise = len(trajectories["on"]) == DATA_PARITY_STEPS and all(
        torch.equal(a, b) for a, b in zip(trajectories["off"],
                                          trajectories["on"]))
    means = {w: [float(l.mean()) for l in t]
             for w, t in trajectories.items()}
    log("data: prefetch parity %s" % json.dumps(
        {"steps": DATA_PARITY_STEPS, "bitwise": bitwise,
         "mean_losses": means}))
    if not bitwise:
        raise RuntimeError("data: the prefetched loss trajectory differs "
                           "from the synchronous one: %s" % means)

    recs = {}
    for way in ("off", "on"):
        gc.collect()
        torch.cuda.empty_cache()
        net, step = eager_resnet18()
        wait = [0.0]
        if way == "off":
            def fetch():
                t0 = time.perf_counter()
                batch = (nd.array(x_np, ctx=mx.gpu(0)),
                         nd.array(y_np, ctx=mx.gpu(0)))
                wait[0] += time.perf_counter() - t0
                return batch
            pf = None
        else:
            pf = DevicePrefetcher([(x_np, y_np)] * n_batches)

            def fetch():
                return _on_card(next(pf))
        losses = [step(*fetch()) for _ in range(EAGER_WARM)]
        torch.cuda.synchronize()
        wait[0] = 0.0
        w0 = pf.data_wait()[0] if pf is not None else 0.0
        t0 = time.perf_counter()
        losses += [step(*fetch()) for _ in range(EAGER_TIMED)]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        waited = pf.data_wait()[0] - w0 if pf is not None else wait[0]
        prof, wall_ms = profiled(lambda: step(*fetch()))
        busy = device_busy_ms(prof)
        if pf is not None:
            pf.close()
        losses = [float(l.mean()) for l in losses]
        if not all(np.isfinite(losses)):
            raise RuntimeError("data: prefetch %s: losses %s are not finite"
                               % (way, losses))
        share = 100.0 * waited / dt
        recs[way] = {"prefetch": way == "on", "batch": EAGER_BATCH,
                     "images_per_s": EAGER_BATCH * EAGER_TIMED / dt,
                     "step_ms": dt / EAGER_TIMED * 1e3,
                     "data_wait_total_ms": waited * 1e3,
                     "data_wait_share_pct": share,
                     "gate_pct": DATA_GATE_PCT,
                     "within_gate": share < DATA_GATE_PCT,
                     "traced_step_wall_ms": wall_ms, "device_busy_ms": busy,
                     "device_idle_share": 1.0 - busy / wall_ms}
        log("data: prefetch %s %s" % (way, json.dumps(recs[way])))
        del net, step
    return recs


def loader_breakdown(ds):
    """Where a loader batch's host time goes, each part measured in this
    process: one sample's read and transform (``ds[i]``, a worker's work,
    64 of them a batch), pickling one batch's numpy arrays (the worker's
    reply) and unpickling it, and assembling it into pinned NDArrays (the
    parent's work).  What the loader's time a batch holds beyond these is
    the reply's way through the pool's pipe and the workers' waits."""
    import pickle
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.data.dataloader import _to_nd_tree
    with mx.cpu():                  # as in a worker
        ds[0]
        t0 = time.perf_counter()
        samples = [ds[i] for i in range(16)]
        sample_ms = (time.perf_counter() - t0) / 16 * 1e3
    x = np.stack([s[0].asnumpy() for s in samples] * (EAGER_BATCH // 16))
    y = np.asarray([s[1] for s in samples] * (EAGER_BATCH // 16))
    t0 = time.perf_counter()
    blob = pickle.dumps([x, y], protocol=pickle.HIGHEST_PROTOCOL)
    t1 = time.perf_counter()
    pickle.loads(blob)
    t2 = time.perf_counter()
    assemble = []
    for _ in range(3):
        t3 = time.perf_counter()
        _to_nd_tree([x, y], True)
        assemble.append((time.perf_counter() - t3) * 1e3)
    return {"sample_ms": sample_ms, "batch_mb": len(blob) / 1e6,
            "pickle_ms": (t1 - t0) * 1e3, "unpickle_ms": (t2 - t1) * 1e3,
            "assemble_pinned_ms": sorted(assemble)[1]}


def pool_replies(pool, workers):
    """What the worker pool's pipe costs a batch: the time to get back
    one batch-sized float32 array that a worker fills with ``np.full``
    (its pages touched, as a real batch's are; pickled there, through the
    pipe, unpickled here), one at a time, and the rate of such replies
    with every worker replying at once."""
    args = ((EAGER_BATCH, 3, RESNET_IMAGE, RESNET_IMAGE), 1.0, np.float32)
    pool.apply_async(np.full, args).get()
    t0 = time.perf_counter()
    for _ in range(4):
        pool.apply_async(np.full, args).get()
    one_ms = (time.perf_counter() - t0) / 4 * 1e3
    t0 = time.perf_counter()
    pending = [pool.apply_async(np.full, args) for _ in range(2 * workers)]
    for r in pending:
        r.get()
    return {"reply_ms": one_ms, "replies_per_s":
            2 * workers / (time.perf_counter() - t0)}


def data_loader():
    """(b) ``SyntheticImageDataset`` (224 x 224 x 3 uint8, seeded, with
    :data:`LOADER_CLASSES` prototypes) through ``transform_first(Compose(
    [ToTensor(), Normalize(ImageNet mean, std)]))`` and a ``DataLoader``
    (batch 64, shuffled, last batch discarded, spawned worker processes,
    ``pin_memory``) into a ``DevicePrefetcher`` into the eager ResNet-18
    step: the loader's images/s alone, then one warm and 10 timed steps:
    images/s, step ms, the data-wait share.  Afterwards every batch that
    reached the card is held bitwise to the same loader's with
    ``num_workers=0`` under the same numpy seed."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.data import DataLoader
    from mxnet_tpu_torch.gluon.data.vision import (SyntheticImageDataset,
                                                   transforms)
    from mxnet_tpu_torch.io import DevicePrefetcher
    workers = min(8, os.cpu_count() or 1)
    t0 = time.perf_counter()
    ds = SyntheticImageDataset(
        num_samples=LOADER_SAMPLES, shape=(RESNET_IMAGE, RESNET_IMAGE, 3),
        num_classes=LOADER_CLASSES, seed=SEED, dtype="uint8")
    build_s = time.perf_counter() - t0
    ds = ds.transform_first(transforms.Compose([
        transforms.ToTensor(),
        transforms.Normalize(IMAGENET_MEAN, IMAGENET_STD)]))

    def loader(n_workers):
        return DataLoader(ds, batch_size=EAGER_BATCH, shuffle=True,
                          last_batch="discard", num_workers=n_workers,
                          pin_memory=n_workers > 0)

    card = loader(workers)
    try:
        np.random.seed(SEED + 30)
        it = iter(card)
        first = next(it)            # the pool spawns here
        pinned = all(b.data.is_pinned() for b in first)
        t0 = time.perf_counter()
        n_alone = sum(1 for _ in it)
        alone_s = time.perf_counter() - t0
        replies = pool_replies(card._get_mp_pool(), workers)
        net, step = eager_resnet18()
        seen = []
        np.random.seed(SEED + 31)
        with DevicePrefetcher(card) as pf:
            xb, yb = _on_card(next(pf))
            seen.append((xb.data.clone(), yb.data.clone()))
            step(xb, yb)
            torch.cuda.synchronize()
            w0 = pf.data_wait()[0]
            t0 = time.perf_counter()
            losses = []
            for batch in pf:
                xb, yb = _on_card(batch)
                seen.append((xb.data.clone(), yb.data.clone()))
                losses.append(step(xb, yb))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            waited = pf.data_wait()[0] - w0
    finally:
        card._shutdown_pool()
    del net, step
    losses = [float(l.mean()) for l in losses]
    # the check, after the timed window: the same seed, in process
    np.random.seed(SEED + 31)
    with mx.cpu():
        want = [(x.data, y.data) for x, y in loader(0)]
    equal = len(want) == len(seen) == LOADER_STEPS + 1 and all(
        torch.equal(gx.cpu(), wx) and torch.equal(gy.cpu(), wy)
        for (gx, gy), (wx, wy) in zip(seen, want))
    rec = {"workers": workers, "samples": LOADER_SAMPLES,
           "classes": LOADER_CLASSES, "dataset_build_s": build_s,
           "pinned": pinned,
           "loader_images_per_s": n_alone * EAGER_BATCH / alone_s,
           "loader_ms_per_batch": alone_s / n_alone * 1e3,
           "loop_images_per_s": len(losses) * EAGER_BATCH / dt,
           "step_ms": dt / len(losses) * 1e3,
           "data_wait_total_ms": waited * 1e3,
           "data_wait_share_pct": 100.0 * waited / dt,
           "within_gate": 100.0 * waited / dt < DATA_GATE_PCT,
           "batches_bitwise_equal": equal, "losses": losses,
           "breakdown": dict(loader_breakdown(ds), **replies)}
    log("data: loader %s" % json.dumps(rec))
    if not equal:
        raise RuntimeError("data: the batches the card got differ from the "
                           "in-process loader's")
    if not pinned or not all(np.isfinite(losses)):
        raise RuntimeError("data: loader batches not pinned (%s) or losses "
                           "not finite (%s)" % (pinned, losses))
    return rec


def data_recordio():
    """(c) 512 seeded raw records of 0 to 150,528 bytes (one holding the
    magic, so it is written as chunks) written by the native writer that
    the port builds into ``_build/``, read back through
    ``MXIndexedRecordIO`` in a shuffled key order and checked bitwise;
    then the pure-Python writer must write the same bytes and the
    pure-Python reader read the same records.  Write and read MB/s (the
    reads hit the page cache)."""
    import shutil
    from mxnet_tpu_torch import recordio
    from mxnet_tpu_torch._native import BUILD_DIR
    if recordio._get_lib() is None:
        raise RuntimeError("data: the native RecordIO library did not build")
    rng = np.random.RandomState(SEED + 40)
    payloads = [rng.bytes(int(n))
                for n in rng.randint(0, RECORD_MAX + 1, RECORDS)]
    k = int(rng.randint(RECORDS))
    payloads[k] = payloads[k][:100] + RECORD_MAGIC + payloads[k][100:]
    total_mb = sum(len(p) for p in payloads) / 1e6
    order = [int(i) for i in rng.permutation(RECORDS)]
    root = BUILD_DIR / "data_recordio"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)

    def write(name):
        w = recordio.MXIndexedRecordIO(str(root / (name + ".idx")),
                                       str(root / (name + ".rec")), "w")
        t0 = time.perf_counter()
        for i, p in enumerate(payloads):
            w.write_idx(i, p)
        w.close()
        return time.perf_counter() - t0

    def read(name):
        r = recordio.MXIndexedRecordIO(str(root / (name + ".idx")),
                                       str(root / (name + ".rec")), "r")
        t0 = time.perf_counter()
        got = [r.read_idx(i) for i in order]
        dt = time.perf_counter() - t0
        r.close()
        return got, dt

    try:
        native_w = write("native")
        native_got, native_r = read("native")
        saved = recordio._LIB, recordio._LIB_TRIED
        recordio._LIB, recordio._LIB_TRIED = None, True
        try:
            python_w = write("python")
            python_got, python_r = read("native")
        finally:
            recordio._LIB, recordio._LIB_TRIED = saved
        same_file = (root / "native.rec").read_bytes() == \
            (root / "python.rec").read_bytes()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    want = [payloads[i] for i in order]
    rec = {"records": RECORDS, "mb": total_mb, "magic_record": k,
           "native_bitwise": native_got == want,
           "python_reader_bitwise": python_got == want,
           "python_writer_same_bytes": same_file,
           "native_write_mb_per_s": total_mb / native_w,
           "native_read_mb_per_s": total_mb / native_r,
           "python_write_mb_per_s": total_mb / python_w,
           "python_read_mb_per_s": total_mb / python_r}
    log("data: recordio %s" % json.dumps(rec))
    if not (rec["native_bitwise"] and rec["python_reader_bitwise"]
            and same_file):
        raise RuntimeError("data: RecordIO did not read back bitwise: %s"
                           % rec)
    return rec


def data_random():
    """(d) ``mx.random`` on the card: 10^6 draws of each ``_random_*`` row
    of the reference's moment table, whose mean must fall within 5
    standard errors + 1e-3 and variance within 15 % + 5e-3
    (``tests/test_random.py``'s tolerances); the uniform draws also pass
    its chi-square test; seeding twice with one seed gives bitwise the
    same draws of every row on the card; the time of 10^6 uniform and
    normal draws (CUDA events)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ndarray.ndarray import invoke
    gpu = mx.gpu(0)
    rows, bad = [], []
    for op, params, mean, var in RANDOM_MOMENTS:
        mx.random.seed(7)
        x = invoke(op, shape=(RANDOM_N,), ctx=gpu, **params).data
        mx.random.seed(7)
        again = invoke(op, shape=(RANDOM_N,), ctx=gpu, **params).data
        xd = x.double()
        m, v = float(xd.mean()), float(xd.var(unbiased=False))
        ok = bool(torch.isfinite(xd).all()) and x.is_cuda and \
            abs(m - mean) < 5 * np.sqrt(var / RANDOM_N) + 1e-3 and \
            abs(v - var) < 0.15 * var + 5e-3 and torch.equal(x, again)
        rows.append({"op": op, "mean": m, "want_mean": mean, "var": v,
                     "want_var": var, "repeat_bitwise": torch.equal(x, again),
                     "ok": ok})
        if not ok:
            bad.append(rows[-1])
    mx.random.seed(7)
    u = invoke("_random_uniform", shape=(RANDOM_N,), ctx=gpu).data
    counts = torch.histc(u.float(), bins=20, min=0.0, max=1.0).double()
    expect = RANDOM_N / 20.0
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    times = {name: time_ms(lambda: invoke(op, shape=(RANDOM_N,), ctx=gpu))
             for name, op in (("uniform_ms", "_random_uniform"),
                              ("normal_ms", "_random_normal"))}
    rec = {"n": RANDOM_N, "rows": rows, "uniform_chi2": chi2,
           "chi2_limit": 43.8, **times}
    log("data: random %s" % json.dumps(rec))
    if bad or not chi2 < 43.8:
        raise RuntimeError("data: mx.random on the card: %s, chi2 %.2f"
                           % (bad, chi2))
    return rec


DET_SHAPE = (3, 300, 300)        # SSD-300's input
DET_BATCH, DET_BATCHES = 32, 4
DET_MAX_OBJECTS = 8
DET_SOURCE = (375, 500)         # a VOC-sized source image (h, w)
DET_OPS_TOL = 1e-5


def det_records(root):
    """An indexed .rec of DET_BATCH x DET_BATCHES seeded 375 x 500 PNG
    images (8 x 8 blocks of random colour, so the encode is quick) with 1
    to 8 objects each, packed as ``tools/im2rec.py --pack-label`` packs
    them; returns its path."""
    from mxnet_tpu_torch import recordio
    rng = np.random.RandomState(SEED + 50)
    h, w = DET_SOURCE
    writer = recordio.MXIndexedRecordIO(str(root / "det.idx"),
                                        str(root / "det.rec"), "w")
    for i in range(DET_BATCH * DET_BATCHES):
        small = rng.randint(0, 256, (h // 8 + 1, w // 8 + 1, 3))
        img = np.kron(small, np.ones((8, 8, 1)))[:h, :w].astype(np.uint8)
        k = int(rng.randint(1, DET_MAX_OBJECTS + 1))
        x1, y1 = rng.uniform(0, 0.7, k), rng.uniform(0, 0.7, k)
        bw, bh = rng.uniform(0.05, 0.3, k), rng.uniform(0.05, 0.3, k)
        objs = np.stack([rng.randint(0, 20, k), x1, y1, x1 + bw, y1 + bh],
                        axis=1)
        flat = np.concatenate([[2.0, 5.0], objs.ravel()]).astype(np.float32)
        writer.write_idx(i, recordio.pack_img(
            recordio.IRHeader(0, flat, i, 0), img, img_fmt=".png"))
    writer.close()
    return str(root / "det.rec")


def det_ops():
    """``RandomHue`` (``_image_random_hue`` at a fixed factor, NHWC),
    ``Rotate`` (``GridGenerator`` + ``BilinearSampler`` of 32 rotations)
    and ``BilinearSampler`` on a random grid, on a (32, 3, 300, 300) batch
    of pixel values in [0, 255) on the card against the port's CPU result:
    max|card - CPU| <= 1e-5 x max|CPU| (float32 rounds a value near 255
    by up to 1.5e-5, so the bound scales with the batch, not with each
    entry, many of which a sample near the zero padding makes small);
    with the card's and the CPU's ms."""
    from mxnet_tpu_torch.gluon.data.vision.transforms import rotation_theta
    from mxnet_tpu_torch.ops.registry import dispatch
    rng = np.random.RandomState(SEED + 51)
    n, (c, h, w) = DET_BATCH, DET_SHAPE
    x = torch.from_numpy(rng.uniform(0, 255, (n, c, h, w))
                         .astype(np.float32))
    theta = torch.from_numpy(np.concatenate(
        [rotation_theta(d, h, w) for d in rng.uniform(-30, 30, n)]))
    grid = torch.from_numpy(rng.uniform(-1.1, 1.1, (n, 2, h, w))
                            .astype(np.float32))
    cases = {
        "random_hue": (lambda x, t, g: dispatch(
            "_image_random_hue", x.permute(0, 2, 3, 1).contiguous(),
            min_factor=0.3, max_factor=0.3)),
        "rotate": (lambda x, t, g: dispatch(
            "BilinearSampler", x, dispatch("GridGenerator", t,
                                           transform_type="affine",
                                           target_shape=(h, w)))),
        "bilinear_sampler": (lambda x, t, g: dispatch("BilinearSampler",
                                                      x, g)),
    }
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = {}
    try:
        card = [a.cuda() for a in (x, theta, grid)]
        for name, fn in cases.items():
            want = fn(x, theta, grid)
            got = fn(*card)
            err = float((got.cpu() - want).abs().max())
            ok = err <= DET_OPS_TOL * float(want.abs().max())
            t0 = time.perf_counter()
            fn(x, theta, grid)
            cpu_ms = (time.perf_counter() - t0) * 1e3
            rows[name] = {"shape": list(got.shape), "max_abs_err": err,
                          "ok": ok, "ms": time_ms(lambda: fn(*card),
                                                  iters=10),
                          "cpu_ms": cpu_ms}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    log("data: det ops on (%d, %d, %d, %d) %s"
        % (n, c, h, w, json.dumps(rows)))
    bad = [k for k, r in rows.items() if not r["ok"]]
    if bad:
        raise RuntimeError("data: %s on the card off the CPU's" % bad)
    return rows


def data_det():
    """(e) The SSD-300 input: ``ImageDetIter`` over :func:`det_records`
    with ``CreateDetAugmenter``'s chain (``rand_crop=0.5, rand_pad=0.5,
    rand_mirror=True, mean=True, std=True``), batches of 32 with labels
    padded with -1 to 8 objects, 8 decode threads, through
    ``io.DevicePrefetcher`` to the card: images/s; every batch that
    reached the card bitwise equal to the same iterator's in-process CPU
    batches.  PNG, not JPEG: the card's libjpeg is not the one the CPU
    tests hold; the JPEG decode stays a CPU test.  Then :func:`det_ops`."""
    import shutil
    from mxnet_tpu_torch._native import BUILD_DIR
    from mxnet_tpu_torch.image import ImageDetIter
    from mxnet_tpu_torch.io import DevicePrefetcher
    root = BUILD_DIR / "data_det"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        t0 = time.perf_counter()
        rec = det_records(root)
        write_s = time.perf_counter() - t0

        def det_iter():
            return ImageDetIter(rec, DET_SHAPE, DET_BATCH, shuffle=True,
                                rand_crop=0.5, rand_pad=0.5,
                                rand_mirror=True, mean=True, std=True,
                                seed=SEED, preprocess_threads=8)

        it = det_iter()
        seen = []
        t0 = time.perf_counter()
        with DevicePrefetcher(it, transform=lambda b: (b.data[0],
                                                       b.label[0])) as pf:
            for batch in pf:
                seen.append(tuple(b.data.clone() for b in _on_card(batch)))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        want = [(b.data[0].data, b.label[0].data) for b in det_iter()]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    equal = len(seen) == len(want) == DET_BATCHES and all(
        torch.equal(gx.cpu(), wx) and torch.equal(gy.cpu(), wy)
        for (gx, gy), (wx, wy) in zip(seen, want))
    labels = torch.cat([y for _, y in want])
    rec = {"batch": DET_BATCH, "batches": len(seen),
           "data_shape": list(DET_SHAPE), "label_shape":
               list(seen[0][1].shape) if seen else None,
           "write_s": write_s, "images_per_s": DET_BATCH * len(seen) / dt,
           "padded_label_rows": int((labels[..., 0] < 0).sum()),
           "on_card": all(x.is_cuda for x, _ in seen),
           "batches_bitwise_equal": equal}
    log("data: det %s" % json.dumps(rec))
    if not equal or not rec["on_card"] or rec["label_shape"] != \
            [DET_BATCH, DET_MAX_OBJECTS, 5]:
        raise RuntimeError("data: the detection batches on the card differ "
                           "from the CPU's or have the wrong shape: %s"
                           % rec)
    rec["ops"] = det_ops()
    return rec


def phase_data():
    """The input pipeline: (a) :func:`data_prefetch`, (b)
    :func:`data_loader`, (c) :func:`data_recordio`, (d)
    :func:`data_random`, then (e) the detection path, :func:`data_det`.
    The launch counts are set to 0 at the start of (a) and of (e) and read
    at the end of (d) and of (e): neither path launches any of K1-K4.
    Returns the two paths' launches."""
    from mxnet_tpu_torch.ops import _kernels
    _kernels.reset_launches()
    data_prefetch()
    gc.collect()
    torch.cuda.empty_cache()
    data_loader()
    gc.collect()
    torch.cuda.empty_cache()
    data_recordio()
    data_random()
    launches = _kernels.launch_counts()
    _kernels.reset_launches()
    data_det()
    det_launches = _kernels.launch_counts()
    if any(launches.values()) or any(det_launches.values()):
        raise RuntimeError("data: the data path launched %s, the detection "
                           "path %s; none of K1-K4 is on them"
                           % (launches, det_launches))
    return launches, det_launches


# ---------------------------------------------------------------------------
# 13. ssd
# ---------------------------------------------------------------------------

SSD_CLASSES = 20
SSD_ANCHORS = 8732
SSD_MAPS = (38, 19, 10, 5, 3, 1)      # SSD-300's feature maps (edge)
SSD_LR, SSD_MOMENTUM = 0.1, 0.9       # Trainer.step(32) rescales by 1/32
SSD_WARM, SSD_TIMED = 2, 10
SSD_CHECK_BATCH = 2
SSD_NMS_TOPK = 400
SSD_TARGET_TOL = 1e-5
SSD_DETECT_TOL = 1e-5


def ssd_conv_gflop(net, shape):
    """Forward GFLOP an image of ``net``'s convolutions at input ``shape``
    (C, H, W), counted from their output shapes in one forward of a
    single image: 2 x out channels x out pixels x (in channels / groups)
    x kernel area."""
    from mxnet_tpu_torch.gluon.nn.conv_layers import _Conv
    flop = [0]

    def count(m, _, out):
        w = m._parameters["weight"]
        flop[0] += 2 * out.shape[1] * out.shape[2] * out.shape[3] \
            * w[0].numel()

    hooks = [m.register_forward_hook(count) for m in net.modules()
             if isinstance(m, _Conv)]
    try:
        with torch.no_grad():
            net(torch.zeros((1,) + tuple(shape), device="cuda"))
    finally:
        for h in hooks:
            h.remove()
    return flop[0] / 1e9


def ssd_loop(net):
    """The reference's SSD step (``examples/train_ssd.py``):
    ``record()`` -> ``net(x)`` -> ``net.targets`` -> ``SSDMultiBoxLoss``
    -> ``backward()`` -> ``Trainer.step(batch)`` (SGD, SSD_LR,
    momentum 0.9).  Returns ``step(x, y, events=None)``, giving the loss;
    given six CUDA events it records the first before the forward and the
    others after the forward, ``targets``, the loss, ``backward`` and
    ``Trainer.step``."""
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon.model_zoo.ssd import SSDMultiBoxLoss
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": SSD_LR,
                             "momentum": SSD_MOMENTUM})
    loss_fn = SSDMultiBoxLoss()

    def mark(events, i):
        if events is not None:
            events[i].record()

    def step(x, y, events=None):
        mark(events, 0)
        with autograd.record():
            anchors, cls_preds, box_preds = net(x)
            mark(events, 1)
            loc_t, loc_m, cls_t = net.targets(anchors, cls_preds, y)
            mark(events, 2)
            loss = loss_fn(cls_preds, box_preds, cls_t, loc_t, loc_m)
            mark(events, 3)
        loss.backward()
        mark(events, 4)
        trainer.step(x.shape[0])
        mark(events, 5)
        return loss

    return step


def ssd_cpu_anchors(net):
    """The port's CPU ``MultiBoxPrior`` over SSD-300's six maps."""
    from mxnet_tpu_torch.ops.registry import dispatch
    return torch.cat([dispatch("MultiBoxPrior", torch.zeros(1, 1, e, e),
                               sizes=s, ratios=r, clip=False)
                      for e, s, r in zip(SSD_MAPS, net._sizes,
                                         net._ratios)], dim=1)


def ssd_op_checks(net, x, y):
    """On the first fed batch: the anchors (8,732, within 1e-6 of the CPU
    ``MultiBoxPrior``), ``MultiBoxTarget`` (negative mining ratio 3) and
    ``MultiBoxDetection`` (``nms_topk`` 400, on one set of class
    probabilities) on the card against the CPU on the same inputs:
    class targets, masks, kept rows and their class ids exactly equal;
    box targets within 1e-5 x max|CPU|, scores and boxes within 1e-5."""
    from mxnet_tpu_torch.ops.registry import dispatch
    with torch.no_grad():
        anchors, cls_preds, box_preds = (o.data for o in net(x))
    anchors_cpu = ssd_cpu_anchors(net)
    anchor_err = float((anchors.cpu() - anchors_cpu).abs().max())
    labels = y.data
    pred_t = cls_preds.transpose(1, 2)
    card = dispatch("MultiBoxTarget", anchors, labels, pred_t,
                    negative_mining_ratio=3.0)
    cpu = dispatch("MultiBoxTarget", anchors.cpu(), labels.cpu(),
                   pred_t.cpu(), negative_mining_ratio=3.0)
    loc_err = float((card[0].cpu() - cpu[0]).abs().max())
    loc_top = float(cpu[0].abs().max())
    prob = torch.softmax(cls_preds.cpu(), dim=-1).transpose(1, 2) \
        .contiguous()
    det_card = dispatch("MultiBoxDetection", prob.cuda(), box_preds,
                        anchors, nms_threshold=0.45, threshold=0.01,
                        nms_topk=SSD_NMS_TOPK).cpu()
    det_cpu = dispatch("MultiBoxDetection", prob, box_preds.cpu(),
                       anchors.cpu(), nms_threshold=0.45, threshold=0.01,
                       nms_topk=SSD_NMS_TOPK)
    kept_card, kept_cpu = det_card[..., 0] >= 0, det_cpu[..., 0] >= 0
    same_rows = torch.equal(kept_card, kept_cpu) and torch.equal(
        det_card[..., 0], det_cpu[..., 0])
    det_err = float((det_card - det_cpu).abs().max())
    rec = {"anchors": list(anchors.shape), "anchor_max_abs_err": anchor_err,
           "cls_target_equal": torch.equal(card[2].cpu(), cpu[2]),
           "loc_mask_equal": torch.equal(card[1].cpu(), cpu[1]),
           "loc_target_max_abs_err": loc_err, "loc_target_max_abs": loc_top,
           "positives": int((cpu[2] > 0).sum()),
           "ignored": int((cpu[2] < 0).sum()),
           "padded_label_rows": int((labels[..., 0] < 0).sum()),
           "detections_kept": int(kept_cpu.sum()),
           "detection_rows_equal": same_rows,
           "detection_max_abs_err": det_err}
    log("ssd: op checks %s" % json.dumps(rec))
    faults = []
    if tuple(anchors.shape) != (1, SSD_ANCHORS, 4) or not anchor_err <= 1e-6:
        faults.append("anchors %s off the CPU's by %.3g"
                      % (tuple(anchors.shape), anchor_err))
    if not (rec["cls_target_equal"] and rec["loc_mask_equal"]
            and loc_err <= SSD_TARGET_TOL * loc_top):
        faults.append("MultiBoxTarget on the card differs from the CPU's")
    if not same_rows or not det_err <= SSD_DETECT_TOL:
        faults.append("MultiBoxDetection on the card differs from the "
                      "CPU's (rows equal %s, max|d| %.3g)"
                      % (same_rows, det_err))
    if faults:
        raise RuntimeError("ssd: " + "; ".join(faults))
    return rec


def ssd_fp32_step(net, x, y):
    """One step of :func:`ssd_loop` at batch 2 from the same parameters on
    the card and on a CPU copy, as ``resnet_fp32_checks`` holds a step:
    the loss within 1e-4 relative, each parameter's change within 0.1 of
    the CPU's in L2 norm (plus 1e-6 of the whole update's norm)."""
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.gluon.model_zoo.ssd import ssd_300_vgg16_voc
    p0 = {n: p.detach().cpu().clone() for n, p in net.named_parameters()}
    xb = x.data[:SSD_CHECK_BATCH].cpu()
    yb = y.data[:SSD_CHECK_BATCH].cpu()
    losses, change = {}, {}
    for key, dev in (("card", "cuda"), ("cpu", "cpu")):
        model = ssd_300_vgg16_voc(classes=SSD_CLASSES).load_dict(
            p0, device=dev)
        step = ssd_loop(model)
        losses[key] = float(step(nd.NDArray(xb.to(dev)),
                                 nd.NDArray(yb.to(dev))).asscalar())
        change[key] = {n: p.detach().cpu().double() - p0[n].double()
                       for n, p in model.named_parameters()}
        del model, step
    floor = 1e-6 * float(torch.stack(
        [d.norm() for d in change["cpu"].values()]).norm())
    worst, at = _worst_l2(change["card"], change["cpu"], floor)
    rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    rec = {"batch": SSD_CHECK_BATCH, "loss_card": losses["card"],
           "loss_cpu": losses["cpu"], "loss_rel": rel,
           "step_change_worst_rel_l2": worst, "step_change_worst_at": at}
    log("ssd: fp32 step %s" % json.dumps(rec))
    if not rel <= 1e-4 or not worst <= 0.1:
        raise RuntimeError("ssd: the fp32 step on the card is off the "
                           "CPU's: %s" % rec)
    return rec


def phase_ssd(peaks, smi):
    """SSD-300 training (BASELINE config 4) on the card, no kernel of its
    own: ``ssd_300_vgg16_voc(classes=20)`` from ``Xavier`` at the seed in
    fp32 (convolutions with TF32 off), fed :func:`det_records` by
    ``ImageDetIter`` (``data_det``'s augmenters, batch 32, 8 objects a
    label) through ``io.DevicePrefetcher``, trained by the reference's
    loop (:func:`ssd_loop`).  First the checks of :func:`ssd_op_checks`
    and :func:`ssd_fp32_step`; then 2 warm steps on the first batch, one
    fed epoch (images/s), 10 timed steps on the first batch resident on
    the card (images/s; the step split into forward + loss,
    ``MultiBoxTarget``, backward and ``Trainer.step`` by CUDA events; the
    last loss below the first); a traced step's idle share and kernels,
    the peak memory; ``net.detect(..., nms_topk=400)`` (ms) and
    ``VOC07MApMetric`` over the fed batches.  The launch counts are set
    to 0 at the start and read at the end: none of K1-K4 is on the path.
    Returns the launches."""
    import shutil
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch._native import BUILD_DIR
    from mxnet_tpu_torch.gluon.model_zoo.ssd import ssd_300_vgg16_voc
    from mxnet_tpu_torch.image import ImageDetIter
    from mxnet_tpu_torch.io import DevicePrefetcher
    from mxnet_tpu_torch.metric import VOC07MApMetric
    from mxnet_tpu_torch.ops import _kernels
    t_phase = time.perf_counter()
    _kernels.reset_launches()
    root = BUILD_DIR / "ssd"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        rec_path = det_records(root)

        def det_iter():
            return ImageDetIter(rec_path, DET_SHAPE, DET_BATCH,
                                shuffle=True, rand_crop=0.5, rand_pad=0.5,
                                rand_mirror=True, mean=True, std=True,
                                seed=SEED, preprocess_threads=8)

        first = next(det_iter())
        x0 = first.data[0].as_in_context(mx.gpu(0))
        y0 = first.label[0].as_in_context(mx.gpu(0))
        net = ssd_300_vgg16_voc(classes=SSD_CLASSES)
        net.initialize(initializer.Xavier(), seed=SEED)
        ssd_op_checks(net, x0, y0)      # its first call sizes the net
        ssd_fp32_step(net, x0, y0)
        gflop = ssd_conv_gflop(net, DET_SHAPE)
        step = ssd_loop(net)
        losses = [float(step(x0, y0).asscalar()) for _ in range(SSD_WARM)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # one fed epoch through the prefetcher
        fed, fed_losses = [], []
        t0 = time.perf_counter()
        with DevicePrefetcher(det_iter(), transform=lambda b: (
                b.data[0], b.label[0])) as pf:
            for batch in pf:
                xb, yb = _on_card(batch)
                fed_losses.append(step(xb, yb).data.detach())
                fed.append((xb, yb))
            torch.cuda.synchronize()
            fed_s = time.perf_counter() - t0
            wait_s = pf.data_wait()[0]
        # the resident batch, timed and split
        marks = [[torch.cuda.Event(enable_timing=True) for _ in range(6)]
                 for _ in range(SSD_TIMED)]
        t0 = time.perf_counter()
        timed = [step(x0, y0, events=ev) for ev in marks]
        torch.cuda.synchronize()
        resident_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        losses += [float(l.asscalar()) for l in timed]
        fed_losses = [float(l) for l in fed_losses]
        parts = np.array([[ev[i].elapsed_time(ev[i + 1]) for i in range(5)]
                          for ev in marks]).mean(axis=0)
        prof, wall_ms = profiled(lambda: step(x0, y0))
        busy = device_busy_ms(prof)
        log_kernel_breakdown("ssd", prof, top=8)
        # inference: detect and VOC07 mAP over the fed batches
        with torch.no_grad():
            outs = net(x0)
        detect_ms = time_ms(lambda: net.detect(*outs,
                                               nms_topk=SSD_NMS_TOPK),
                            iters=5, warmup=1)
        metric = VOC07MApMetric()
        with torch.no_grad():
            for xb, yb in fed:
                metric.update([yb], [net.detect(*net(xb),
                                                nms_topk=SSD_NMS_TOPK)])
        map_name, map_value = metric.get()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = _kernels.launch_counts()
    n_fed = DET_BATCH * len(fed)
    step_ms = resident_s / SSD_TIMED * 1e3
    flop_step = 3 * gflop * 1e9 * DET_BATCH
    rec = {"model": "ssd_300_vgg16_voc", "classes": SSD_CLASSES,
           "batch": DET_BATCH, "dtype": "float32", "lr": SSD_LR,
           "momentum": SSD_MOMENTUM, "forward_gflop_per_image": gflop,
           "fed_batches": len(fed),
           "fed_images_per_s": n_fed / fed_s,
           "fed_data_wait_share_pct": 100.0 * wait_s / fed_s,
           "resident_images_per_s": DET_BATCH * SSD_TIMED / resident_s,
           "resident_step_ms": step_ms,
           "split_ms": {"forward": parts[0], "multibox_target": parts[1],
                        "loss": parts[2], "forward_plus_loss":
                            parts[0] + parts[2], "backward": parts[3],
                        "trainer_step": parts[4]},
           "tflops": flop_step / (step_ms / 1e3) / 1e12,
           "mfu_fp32": flop_step / (step_ms / 1e3) / peaks["fp32"],
           "traced_step_wall_ms": wall_ms, "device_busy_ms": busy,
           "device_idle_share": 1.0 - busy / wall_ms,
           "peak_memory_gb": peak_gb, "detect_ms": detect_ms,
           "map_name": map_name, "map": map_value,
           "losses_resident": losses, "losses_fed": fed_losses,
           "launches": launches,
           "phase_s": time.perf_counter() - t_phase, "card": smi}
    log("ssd: %s" % json.dumps(rec))
    faults = []
    if not all(np.isfinite(losses + fed_losses)):
        faults.append("a loss is not finite")
    if not losses[-1] < losses[0]:
        faults.append("the loss on the repeated batch did not fall: %s"
                      % losses)
    if any(launches.values()):
        faults.append("launched %s; none of K1-K4 is on the path"
                      % launches)
    if faults:
        raise RuntimeError("ssd: " + "; ".join(faults))
    return launches


# ---------------------------------------------------------------------------
# 14. lm
# ---------------------------------------------------------------------------

LM_VOCAB = 10000        # PTB's vocabulary
LM_EMBED = LM_HIDDEN = 650
LM_LAYERS = 2
LM_DROPOUT = 0.5
LM_BPTT, LM_BATCH = 35, 20      # examples/word_lm.py's defaults
LM_LR, LM_CLIP = 1.0, 0.25
LM_CORPUS = 40_000


def lm_corpus(vocab_size, n=LM_CORPUS):
    """``examples/word_lm.py``'s offline corpus (seed 0): Zipf tokens in
    which every odd token is a function of the one before it."""
    rng = np.random.RandomState(0)
    base = rng.zipf(1.5, n).clip(1, vocab_size - 1)
    ids = np.where(np.arange(n) % 2 == 1, (base * 7 + 3) % vocab_size, base)
    return ids.astype(np.int32)


def lm_batchify(ids, batch_size):
    """(T_total, N): the stream cut into ``batch_size`` columns."""
    nb = len(ids) // batch_size
    return ids[:nb * batch_size].reshape(batch_size, nb).T


def word_lm_model(vocab, embed, hidden, layers, dropout):
    """``examples/word_lm.py``'s ``RNNModel`` on the port: ``Embedding``
    -> ``Dropout`` -> ``rnn.LSTM`` -> ``Dropout`` -> ``Dense(flatten=False)``
    -> the tied decoder ``dot(out, embedding.weight, transpose_b=True)``;
    ``model(x, state)`` gives ``(logits (T, N, vocab), state)``."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon import nn, rnn
    from mxnet_tpu_torch.ops.registry import dispatch

    class RNNModel(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.embedding = nn.Embedding(vocab, embed)
            self.lstm = rnn.LSTM(hidden, num_layers=layers, dropout=dropout,
                                 input_size=embed)
            self.drop = nn.Dropout(dropout)
            self.proj = nn.Dense(embed, in_units=hidden, flatten=False)

        def forward(self, x, state):
            emb = self.drop(self.embedding(x))
            out, state = self.lstm(emb, state)
            out = self.proj(self.drop(out))
            w = self.embedding._parameters["weight"]
            logits = dispatch("dot", out.reshape(-1, w.shape[1]), w,
                              transpose_b=True)
            return logits.reshape(x.shape[0], x.shape[1], -1), state

    return RNNModel()


LM_EPOCH_STEPS = (LM_CORPUS // LM_BATCH - 1) // LM_BPTT     # 57
LM_TOL = 1e-4
LM_OP_TIMED = 20
#: cuDNN's recurrent kernels by name; PyTorch's own CUDA RNN kernels live
#: in at::native and do not count
_CUDNN_RNN_KERNEL = re.compile(r"rnn|lstm|gru|persist", re.I)


def lm_forward_flop_per_token(vocab, embed, hidden, layers):
    """Forward FLOP a token of :func:`word_lm_model`, from its shapes:
    2 x 4H x (I + H) a layer for the LSTM's products, the projection and
    the tied decoder."""
    lstm = sum(2 * 4 * hidden * ((embed if i == 0 else hidden) + hidden)
               for i in range(layers))
    return lstm + 2 * hidden * embed + 2 * embed * vocab


def lm_op_check(label, mode, layers, bidirectional, lengths=None):
    """The fp32 ``RNN`` op forward and backward at the LM's widths (T 35, N
    20, 650 in and 650 hidden) on the card against the port's CPU path on
    the same inputs, with ``torch.backends.cudnn.allow_tf32`` set True, so
    that only the op's own scope keeps TF32 off: the outputs and final
    states within 1e-4 x max|CPU|; each gradient (data, each weight and
    bias of the flat vector, both initial states) within 1e-4 relative in
    L2.  Then the op's forward and forward + backward ms on the card."""
    from mxnet_tpu_torch.ops.rnn import rnn, rnn_param_size, unpack_params
    dirs = 2 if bidirectional else 1
    gen = torch.Generator().manual_seed(SEED)
    size = rnn_param_size(layers, LM_EMBED, LM_HIDDEN, mode, bidirectional)
    bound = 1.0 / LM_HIDDEN ** 0.5     # torch.nn.LSTM's initial range
    shape_h = (layers * dirs, LM_BATCH, LM_HIDDEN)
    ins = [torch.randn(LM_BPTT, LM_BATCH, LM_EMBED, generator=gen),
           (torch.rand(size, generator=gen) * 2 - 1) * bound,
           torch.randn(shape_h, generator=gen) * 0.5,
           torch.randn(shape_h, generator=gen) * 0.5]
    cots = [torch.randn(LM_BPTT, LM_BATCH, dirs * LM_HIDDEN, generator=gen),
            torch.randn(shape_h, generator=gen),
            torch.randn(shape_h, generator=gen)]
    kw = dict(state_size=LM_HIDDEN, num_layers=layers, mode=mode,
              bidirectional=bidirectional,
              use_sequence_length=lengths is not None)
    res = {}
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for dev in ("cuda", "cpu"):
            ts = [t.to(dev).requires_grad_() for t in ins]
            seq = None if lengths is None else lengths.to(dev)
            outs = rnn(*ts, seq, **kw)
            grads = torch.autograd.grad(outs, ts, [c.to(dev) for c in cots])
            res[dev] = ([o.detach().cpu() for o in outs],
                        [g.cpu() for g in grads])
        xs = [t.cuda() for t in ins]
        seq = None if lengths is None else lengths.cuda()
        fwd_ms = time_ms(lambda: rnn(*xs, seq, **kw), iters=LM_OP_TIMED)
        leaves = [t.requires_grad_() for t in xs]
        cuda_cots = [c.cuda() for c in cots]
        both_ms = time_ms(lambda: torch.autograd.grad(
            rnn(*leaves, seq, **kw), leaves, cuda_cots), iters=LM_OP_TIMED)
    finally:
        torch.backends.cudnn.allow_tf32 = old
    (card_out, card_g), (cpu_out, cpu_g) = res["cuda"], res["cpu"]
    out_worst = max(float((a - b).abs().max()) / float(b.abs().max())
                    for a, b in zip(card_out, cpu_out))

    def split(g):
        named = {"data": g[0], "state": g[2], "state_cell": g[3]}
        pieces = unpack_params(g[1], layers, dirs, LM_EMBED, LM_HIDDEN, mode)
        for i, piece in enumerate(pieces):
            for kind, t in zip(("i2h_weight", "h2h_weight", "i2h_bias",
                                "h2h_bias"), piece):
                named["%s%d_%s" % ("lr"[i % dirs], i // dirs, kind)] = t
        return named
    grad_worst, grad_at = _worst_l2(split(card_g), split(cpu_g), 0.0)
    rec = {"check": label, "mode": mode, "layers": layers,
           "bidirectional": bidirectional, "T": LM_BPTT, "N": LM_BATCH,
           "input": LM_EMBED, "hidden": LM_HIDDEN,
           "lengths": None if lengths is None else lengths.tolist(),
           "output_worst_rel_max": out_worst,
           "grad_worst_rel_l2": grad_worst, "grad_worst_at": grad_at,
           "forward_ms": fwd_ms, "forward_backward_ms": both_ms}
    log("lm: op check %s" % json.dumps(rec))
    if not out_worst <= LM_TOL or not grad_worst <= LM_TOL:
        raise RuntimeError("lm: the %s RNN op on the card is off the CPU's: "
                           "%s" % (label, rec))
    return rec


def lm_loop(model):
    """``examples/word_lm.py``'s step: the states detached, ``record()`` ->
    ``model(x, state)`` -> ``SoftmaxCrossEntropyLoss`` -> ``backward()``
    -> ``Trainer.step(batch x bptt)`` (SGD, lr 1.0, ``clip_gradient``
    0.25).  Returns ``step(x, y, state, events=None, before_update=None)``
    giving (the loss's mean as a device tensor, the new state); given four
    CUDA events it records them before the forward, after the loss, after
    ``backward`` and after ``Trainer.step``; ``before_update()`` runs
    between ``backward`` and ``Trainer.step``."""
    from mxnet_tpu_torch import autograd, gluon
    trainer = gluon.Trainer(model.collect_params(), "sgd",
                            {"learning_rate": LM_LR,
                             "clip_gradient": LM_CLIP})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

    def step(x, y, state, events=None, before_update=None):
        state = [s.detach() for s in state]
        if events is not None:
            events[0].record()
        with autograd.record():
            logits, state = model(x, state)
            loss = loss_fn(logits, y)
        if events is not None:
            events[1].record()
        loss.backward()
        if events is not None:
            events[2].record()
        if before_update is not None:
            before_update()
        trainer.step(LM_BATCH * LM_BPTT)
        if events is not None:
            events[3].record()
        return loss.data.detach().mean(), state

    return step


def lm_batches(data, dev):
    """The epoch's (x, y) batches as NDArrays on ``dev``: x the token ids
    (int32), y the next tokens (float32), as ``word_lm.py`` feeds them."""
    from mxnet_tpu_torch import nd
    out = []
    for i in range(LM_EPOCH_STEPS):
        s = i * LM_BPTT
        x = torch.from_numpy(data[s:s + LM_BPTT].copy())
        y = torch.from_numpy(data[s + 1:s + 1 + LM_BPTT].astype(np.float32))
        out.append((nd.NDArray(x.to(dev)), nd.NDArray(y.to(dev))))
    return out


def lm_fp32_step(p0, batch):
    """(c): one step of :func:`lm_loop` at dropout 0 from the same
    parameters on the card and on a CPU copy: the loss within 1e-4
    relative, and each parameter's change within 1e-4 relative in L2.  The
    change is SGD's update, -lr x clip(gradient / (batch x bptt), 0.25),
    taken from the gradient before ``Trainer.step`` writes it (in float64
    from the float32 gradient), and on each device the parameter after the
    step must equal the parameter plus that update within float32's
    rounding of the sum.  The difference of the float32 parameters after
    and before is printed beside it with its rounding floor (one ulp of
    the parameter over the update's size): the update is small against
    the parameter, so that difference carries the parameter's rounding."""
    from mxnet_tpu_torch import nd
    losses, update, diff, applied, floor = {}, {}, {}, {}, {}
    for key, dev in (("card", "cuda"), ("cpu", "cpu")):
        model = word_lm_model(LM_VOCAB, LM_EMBED, LM_HIDDEN, LM_LAYERS, 0.0)
        model.load_dict(p0, device=dev)
        step = lm_loop(model)
        x, y = (nd.NDArray(a.data.to(dev)) for a in batch)
        state = [torch.zeros(LM_LAYERS, LM_BATCH, LM_HIDDEN, device=dev)
                 for _ in range(2)]
        grads = {}

        def keep_grads():
            for n, p in model.named_parameters():
                grads[n] = p.grad.detach().cpu().double()
        losses[key] = float(step(x, y, state, before_update=keep_grads)[0])
        update[key] = {n: -LM_LR * (g / (LM_BATCH * LM_BPTT)).clamp(
            -LM_CLIP, LM_CLIP) for n, g in grads.items()}
        diff[key] = {n: p.detach().cpu().double() - p0[n].double()
                     for n, p in model.named_parameters()}
        eps = torch.finfo(torch.float32).eps
        applied[key] = max(
            float((diff[key][n] - update[key][n]).abs().max()) /
            (eps * float((p0[n].double().abs() + update[key][n].abs())
                         .max())) for n in p0)
        floor[key] = max(
            float(eps * p0[n].double().abs().norm() /
                  update[key][n].norm().clamp_min(1e-30)) for n in p0)
        del model, step
    worst, at = _worst_l2(update["card"], update["cpu"], 0.0)
    diff_worst, diff_at = _worst_l2(diff["card"], diff["cpu"], 0.0)
    rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    rec = {"loss_card": losses["card"], "loss_cpu": losses["cpu"],
           "loss_rel": rel, "update_worst_rel_l2": worst,
           "update_worst_at": at,
           "applied_worst_over_fp32_rounding": max(applied.values()),
           "param_difference_worst_rel_l2": diff_worst,
           "param_difference_worst_at": diff_at,
           "param_difference_rounding_floor_worst": floor["cpu"]}
    log("lm: fp32 step at dropout 0 %s" % json.dumps(rec))
    if not rel <= LM_TOL or not worst <= LM_TOL or \
            not max(applied.values()) <= 1.0:
        raise RuntimeError("lm: the fp32 step on the card is off the "
                           "CPU's: %s" % rec)
    return rec


def lm_cudnn_kernels(prof):
    """The cuDNN RNN ops and kernels of a traced step: the ``aten`` ops
    PyTorch's cuDNN RNN dispatches to, and the device kernels whose names
    are cuDNN's recurrent ones (PyTorch's non-cuDNN CUDA RNN kernels, in
    ``at::native``, excluded)."""
    from torch.autograd import DeviceType
    ops = sorted({e.name for e in prof.events()
                  if e.device_type != DeviceType.CUDA
                  and e.name.startswith("aten::_cudnn_rnn")})
    kernels = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and \
                _CUDNN_RNN_KERNEL.search(e.name) and \
                "at::native" not in e.name:
            kernels[e.name] = kernels.get(e.name, 0) + 1
    return ops, kernels


def phase_lm(peaks, smi):
    """BASELINE config 3, the LSTM language model of ``examples/word_lm.py``
    on the card, no kernel of its own: the fused ``RNN`` op on PyTorch's
    RNN, which is cuDNN's.  Upstream MXNet's medium PTB widths (vocabulary
    10,000, embedding and hidden 650, 2 layers, dropout 0.5), bptt 35 and
    batch 20, on word_lm.py's offline corpus (:func:`lm_corpus`, 40,000
    tokens: 57 steps an epoch).  Checks: (a) :func:`lm_op_check` for the
    2-layer LSTM; (b) the same for one bidirectional GRU layer with
    ``sequence_length``, one length 0 and one T; (c)
    :func:`lm_fp32_step`; (d) one epoch at dropout 0.5 (masks from a
    seeded generator on the card), every loss finite and the mean of the
    last 10 below that of the first 10; (e) none of K1-K4 launched (the
    counts are set to 0 at the start and read at the end: the ``lm``
    path), and a traced step holds ``aten::_cudnn_rnn`` and cuDNN's RNN
    kernels.  Printed: words/s over the epoch, the step split (forward +
    loss, backward, ``Trainer.step``) by CUDA events, TFLOP/s and fp32 MFU
    (3 x the forward FLOP of :func:`lm_forward_flop_per_token`), the
    traced step's idle share and top kernels, the peak memory, the
    phase's seconds.  Returns the launches."""
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.ops import _kernels
    t_phase = time.perf_counter()
    _kernels.reset_launches()
    checks = [lm_op_check("lstm", "lstm", LM_LAYERS, False)]
    lengths = torch.randint(1, LM_BPTT + 1, (LM_BATCH,),
                            generator=torch.Generator().manual_seed(SEED))
    lengths[0], lengths[1] = 0, LM_BPTT
    checks.append(lm_op_check("gru_bidirectional_lengths", "gru", 1, True,
                              lengths))
    data = lm_batchify(lm_corpus(LM_VOCAB), LM_BATCH)
    batches = lm_batches(data, "cuda")
    model = word_lm_model(LM_VOCAB, LM_EMBED, LM_HIDDEN, LM_LAYERS,
                          LM_DROPOUT)
    model.initialize(initializer.Xavier(), seed=SEED)
    p0 = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
    n_params = sum(p.numel() for p in p0.values())
    fp32_step = lm_fp32_step(p0, batches[0])
    nn.set_dropout_generator(
        model, torch.Generator(device="cuda").manual_seed(SEED))
    step = lm_loop(model)
    state = model.lstm.begin_state(LM_BATCH, ctx=batches[0][0].context)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
             for _ in range(LM_EPOCH_STEPS)]
    losses = []
    t0 = time.perf_counter()
    for (x, y), ev in zip(batches, marks):
        loss, state = step(x, y, state, events=ev)
        losses.append(loss)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(l) for l in losses]
    warm = 2
    parts = np.array([[ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
                      for ev in marks[warm:]]).mean(axis=0)
    steady_ms = float(np.mean([ev[0].elapsed_time(ev[3])
                               for ev in marks[warm:]]))
    x0, y0 = batches[0]
    prof, wall_ms = profiled(lambda: step(x0, y0, state))
    busy = device_busy_ms(prof)
    log_kernel_breakdown("lm", prof, top=10)
    rnn_ops, rnn_kernels = lm_cudnn_kernels(prof)
    launches = _kernels.launch_counts()
    tokens = LM_BPTT * LM_BATCH
    flop_step = 3 * lm_forward_flop_per_token(
        LM_VOCAB, LM_EMBED, LM_HIDDEN, LM_LAYERS) * tokens
    first10, last10 = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    rec = {"model": "word_lm RNNModel (tied LSTM)", "vocab": LM_VOCAB,
           "embed": LM_EMBED, "hidden": LM_HIDDEN, "layers": LM_LAYERS,
           "dropout": LM_DROPOUT, "bptt": LM_BPTT, "batch": LM_BATCH,
           "parameters": n_params, "steps": LM_EPOCH_STEPS,
           "dtype": "float32", "lr": LM_LR, "clip_gradient": LM_CLIP,
           "epoch_s": epoch_s,
           "words_per_s": LM_EPOCH_STEPS * tokens / epoch_s,
           "steady_step_ms": steady_ms,
           "steady_words_per_s": tokens / (steady_ms / 1e3),
           "split_ms": {"forward_plus_loss": parts[0],
                        "backward": parts[1], "trainer_step": parts[2]},
           "flop_per_step": flop_step,
           "tflops": flop_step / (steady_ms / 1e3) / 1e12,
           "mfu_fp32": flop_step / (steady_ms / 1e3) / peaks["fp32"],
           "traced_step_wall_ms": wall_ms, "device_busy_ms": busy,
           "device_idle_share": 1.0 - busy / wall_ms,
           "peak_memory_gb": peak_gb, "cudnn_rnn_ops": rnn_ops,
           "cudnn_rnn_kernels": rnn_kernels,
           "loss_first10_mean": first10, "loss_last10_mean": last10,
           "perplexity_epoch": float(np.exp(np.mean(losses))),
           "losses": losses, "op_checks": checks, "fp32_step": fp32_step,
           "launches": launches,
           "phase_s": time.perf_counter() - t_phase, "card": smi}
    log("lm: %s" % json.dumps(rec))
    faults = []
    if not all(np.isfinite(losses)):
        faults.append("a loss is not finite")
    if not last10 < first10:
        faults.append("the mean loss of the last 10 steps (%.4f) is not "
                      "below the first 10's (%.4f)" % (last10, first10))
    if "aten::_cudnn_rnn" not in rnn_ops or not rnn_kernels:
        faults.append("the traced step ran no cuDNN RNN (ops %s, kernels "
                      "%s)" % (rnn_ops, sorted(rnn_kernels)))
    if any(launches.values()):
        faults.append("launched %s; none of K1-K4 is on the path"
                      % launches)
    if faults:
        raise RuntimeError("lm: " + "; ".join(faults))
    return launches


# ---------------------------------------------------------------------------
# 15. zoo
# ---------------------------------------------------------------------------

ZOO_MODELS = [("vgg16", 224), ("alexnet", 224), ("densenet121", 224),
              ("squeezenet1.1", 224), ("mobilenet1.0", 224),
              ("mobilenetv2_1.0", 224), ("inceptionv3", 299)]
ZOO_CHECK_BATCH = 2
ZOO_BATCH = 32
ZOO_STEPS, ZOO_TIMED = 5, 3
ZOO_LR, ZOO_MOMENTUM = 0.01, 0.9
ZOO_TOL = 1e-4


def zoo_model(name, hw):
    """(a) and (b) for one model of the vision zoo, at 1000 classes from
    ``Xavier`` at the seed: a predict-mode fp32 forward at batch 2 on the
    card against a CPU copy of the same parameters, with
    ``torch.backends.cudnn.allow_tf32`` True, within 1e-4 x max|CPU|; then
    5 SGD steps (lr 0.01, momentum 0.9) through ``gluon.Trainer`` on one
    repeated fp32 batch of 32 (``record()``, the net,
    ``SoftmaxCrossEntropyLoss``, ``backward()``, ``Trainer.step(32)``;
    dropout masks from a seeded generator on the card): every loss finite
    and the last below the first; images/s of the last 3 steps and the
    peak memory."""
    from mxnet_tpu_torch import autograd, gluon, initializer, nd
    from mxnet_tpu_torch.gluon.model_zoo import vision
    gen = torch.Generator().manual_seed(SEED)
    x2 = torch.randn(ZOO_CHECK_BATCH, 3, hw, hw, generator=gen)
    net = vision.get_model(name, classes=1000)
    net.initialize(initializer.Xavier(), seed=SEED)
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            card = net(x2.cuda()).cpu()         # also sizes the net
            params = {n: p.detach().cpu() for n, p in
                      net.named_parameters()}
            cpu = vision.get_model(name, classes=1000).load_dict(
                params, device="cpu")(x2)
    finally:
        torch.backends.cudnn.allow_tf32 = old
    err = float((card - cpu).abs().max())
    top = float(cpu.abs().max())
    del params
    gluon.nn.set_dropout_generator(
        net, torch.Generator(device="cuda").manual_seed(SEED))
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": ZOO_LR,
                             "momentum": ZOO_MOMENTUM})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    x = nd.NDArray(torch.randn(ZOO_BATCH, 3, hw, hw, generator=gen).cuda())
    y = nd.NDArray(torch.randint(0, 1000, (ZOO_BATCH,), generator=gen)
                   .float().cuda())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, t_timed = [], None
    for i in range(ZOO_STEPS):
        if i == ZOO_STEPS - ZOO_TIMED:
            torch.cuda.synchronize()
            t_timed = time.perf_counter()
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(ZOO_BATCH)
        losses.append(loss.data.detach().mean())
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - t_timed
    losses = [float(l) for l in losses]
    rec = {"model": name, "image": hw, "classes": 1000,
           "parameters": sum(p.numel() for p in net.parameters()),
           "check_batch": ZOO_CHECK_BATCH, "forward_max_abs_err": err,
           "forward_max_abs_cpu": top, "batch": ZOO_BATCH,
           "losses": losses,
           "images_per_s": ZOO_BATCH * ZOO_TIMED / timed_s,
           "step_ms": timed_s / ZOO_TIMED * 1e3,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    log("zoo: %s" % json.dumps(rec))
    faults = []
    if not err <= ZOO_TOL * top:
        faults.append("the forward on the card is off the CPU's by %.3g "
                      "(max|CPU| %.3g)" % (err, top))
    if not all(np.isfinite(losses)):
        faults.append("a loss is not finite: %s" % losses)
    if not losses[-1] < losses[0]:
        faults.append("the loss did not fall: %s" % losses)
    if faults:
        raise RuntimeError("zoo: %s: %s" % (name, "; ".join(faults)))
    return rec


def phase_zoo(smi):
    """The rest of the vision zoo on the card, no kernel of its own
    (convolutions, depthwise and grouped, batch norm and pooling on
    cuDNN): :func:`zoo_model` for vgg16, alexnet, densenet121,
    squeezenet1.1, mobilenet1.0, mobilenetv2_1.0 (224 px) and inceptionv3
    (299 px).  The launch counts are set to 0 at the start and read at the
    end (the ``zoo`` path): none of K1-K4 may launch.  Returns the
    launches."""
    from mxnet_tpu_torch.ops import _kernels
    t_phase = time.perf_counter()
    _kernels.reset_launches()
    recs = []
    for name, hw in ZOO_MODELS:
        recs.append(zoo_model(name, hw))
        gc.collect()
        torch.cuda.empty_cache()
    launches = _kernels.launch_counts()
    log("zoo: %s" % json.dumps({
        "models": [r["model"] for r in recs], "launches": launches,
        "phase_s": time.perf_counter() - t_phase, "card": smi}))
    if any(launches.values()):
        raise RuntimeError("zoo: launched %s; none of K1-K4 is on the path"
                           % launches)
    return launches


# ---------------------------------------------------------------------------
# 16. data-parallel training across processes
# ---------------------------------------------------------------------------

DIST_STEPS_A = 3                # steps with the store, then without it
DIST_STEPS_B = 2                # Trainer steps, then dp TrainStep steps
DIST_TIMEOUT = 300              # seconds a part's launcher may take
DIST_TOL = 1e-4                 # the port's fp32 rule, x max|ref|
DIST_CODEC_N = 1 << 20          # one 4 MB float32 bucket
_FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def dist_bert(dev, dtype):
    """BERT-base with the MLM decoder, as the train phase builds it, on
    ``dev`` in ``dtype``."""
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon.model_zoo.bert import bert_12_768_12
    net = bert_12_768_12(vocab_size=VOCAB, max_length=SEQ_LEN, dropout=0.0,
                         use_classifier=False)
    net.initialize(initializer.Normal(0.02), device=dev, seed=SEED)
    if dtype != "float32":
        net.cast(dtype)
    return net


def dist_mlm_loss(cast):
    """The bench's loss, the mean MLM cross-entropy, on NDArrays (with the
    logits cast to fp32 when ``cast``) or tensors."""
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    ce = SoftmaxCrossEntropyLoss()
    if cast:
        return lambda out, lab: ce(out[-1].astype("float32"), lab).mean()
    return lambda out, lab: ce(out[-1], lab).mean()


def _weights(net):
    return {n: p.detach() for n, p in net.named_parameters()}


def dist_fwd_bwd(net, loss_fn, batch):
    from mxnet_tpu_torch import autograd
    with autograd.record():
        loss = loss_fn(net(*batch[:-1]), batch[-1])
    loss.backward()
    return loss.data.detach().clone()


def dist_exchange(trainer):
    """``trainer.allreduce_grads()`` between two CUDA events; returns
    them."""
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    trainer.allreduce_grads()
    e1.record()
    return e0, e1


def dist_codecs(dev):
    """2-bit and int8 compression of one 4 MB bucket, two pushes with the
    residual carried, on the card and on the CPU: codes, scales, packed
    words and residuals bitwise equal (and the packed words equal to the
    host pack of the wire codec)."""
    from mxnet_tpu_torch.kvstore.gradient_compression import \
        GradientCompression
    from mxnet_tpu_torch.kvstore.wire_codec import pack_2bit
    rng = np.random.RandomState(SEED)
    xs = [torch.from_numpy(rng.randn(DIST_CODEC_N).astype(np.float32) * s)
          for s in (0.3, 0.2)]
    checked = {}
    for mode in ("2bit", "int8"):
        gpu, cpu = (GradientCompression(mode, threshold=0.5)
                    for _ in range(2))
        for i, x in enumerate(xs):
            got = gpu.compress_device("b", x.to(dev))
            want = cpu.compress_device("b", x)
            pairs = list(zip(got, want)) + [(gpu._residuals["b"],
                                             cpu._residuals["b"])]
            if mode == "2bit":
                levels = cpu.decompress_device(want, DIST_CODEC_N)
                host = torch.from_numpy(pack_2bit(levels.numpy(), 0.5))
                pairs.append((got[0], host))
            for g, w in pairs:
                if not torch.equal(g.cpu(), w):
                    raise RuntimeError("dist: %s compression push %d differs "
                                       "on the card from the CPU" % (mode, i))
        checked[mode] = [str(t.dtype).replace("torch.", "") for t in got]
    return checked


def dist_part_a(dev):
    """(a) One rank, NCCL on the card: BERT-base bf16 at the bench's batch
    through ``Trainer(kvstore="ici")`` (the counted ``dist`` path), then
    ``Trainer(kvstore=None)`` and ``Trainer(kvstore="ici")`` under
    ``MX_EXCHANGE_OVERLAP=1``, on the same inputs and parameters.  The
    losses and weights of all three are bitwise equal, and so are the
    exchanged gradients of the first step; the overlapped run launched
    exchange units during backward (before its step) from the second
    step on."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, nd
    from mxnet_tpu_torch.kvstore.bucketing import bucket_bytes
    from mxnet_tpu_torch.ops import _kernels
    loss_fn = dist_mlm_loss(cast=True)
    ctx = mx.Context.from_torch(dev)
    batch = [nd.array(a, ctx=ctx) for a in train_batch_host(TRAIN_BATCH)]

    def make(kv):
        net = dist_bert(dev, "bfloat16")
        return net, gluon.Trainer(net.collect_params(), "sgd",
                                  {"learning_rate": TRAIN_LR,
                                   "momentum": TRAIN_MOMENTUM}, kvstore=kv)

    net, kv_trainer = make("ici")
    # --- the dist main path (a), counted: the store's Trainer alone ---
    torch.cuda.synchronize()
    _kernels.reset_launches()
    losses, events = [], []
    for s in range(DIST_STEPS_A):
        losses.append(dist_fwd_bwd(net, loss_fn, batch))
        if s == 0:
            before = [p.grad().data.clone() for p in kv_trainer._params]
        events.append(dist_exchange(kv_trainer))
        if s == 0:
            moved = [i for i, (p, g) in enumerate(zip(kv_trainer._params,
                                                      before))
                     if not torch.equal(p.grad().data, g)]
            del before
            if moved:
                raise RuntimeError("dist (a): the exchange at world size 1 "
                                   "changed %d gradients (first: %s)"
                                   % (len(moved),
                                      kv_trainer._params[moved[0]].name))
        kv_trainer.update(1)
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    # --- end of the counted main path ---
    n_layers = len(net.encoder.transformer_cells)
    want = n_layers * DIST_STEPS_A
    if any(counts[k] != want for k in _FLASH):
        raise RuntimeError("dist (a): launched %s, expected %d of each of %s"
                           % (counts, want, _FLASH))
    weights = _weights(net)
    # the controls: no store; the store with the overlapped exchange
    ctl_net, ctl = make(None)
    ctl_losses = []
    for _ in range(DIST_STEPS_A):
        ctl_losses.append(dist_fwd_bwd(ctl_net, loss_fn, batch))
        ctl.step(1)
    ctl_weights = _weights(ctl_net)
    del ctl_net, ctl
    os.environ["MX_EXCHANGE_OVERLAP"] = "1"
    try:
        ov_net, ov = make("ici")
        ov_losses, ov_launched, ov_events = [], [], []
        for _ in range(DIST_STEPS_A):
            ov_losses.append(dist_fwd_bwd(ov_net, loss_fn, batch))
            sess = ov._exchange_session
            ov_launched.append(0 if sess is None else len(sess._launched))
            ov_events.append(dist_exchange(ov))
            ov.update(1)
        torch.cuda.synchronize()
    finally:
        del os.environ["MX_EXCHANGE_OVERLAP"]
    if not (ov._overlap and ov_launched[0] == 0 and all(ov_launched[1:])):
        raise RuntimeError("dist (a): the overlapped exchange launched %s "
                           "units before each step" % ov_launched)
    for what, other, other_w in (("without the store", ctl_losses,
                                  ctl_weights),
                                 ("overlapped", ov_losses, _weights(ov_net))):
        if not all(torch.equal(a, b) for a, b in zip(losses, other)):
            raise RuntimeError("dist (a): losses with the store %s, %s %s"
                               % ([float(v) for v in losses], what,
                                  [float(v) for v in other]))
        apart = [n for n in weights if not torch.equal(weights[n],
                                                       other_w[n])]
        if apart:
            raise RuntimeError("dist (a): %d weights differ with the store "
                               "and %s (first: %s)" % (len(apart), what,
                                                        apart[0]))
    kv = kv_trainer._kvstore
    grads = [p.grad() for p in kv_trainer._params]
    buckets, solo = kv._bucket_plans(list(range(len(grads))), grads)
    item = grads[0].data.element_size()
    rec = {"part": "a", "backend": dist.get_backend(),
           "world": dist.get_world_size(), "store": kv.type,
           "losses": [float(v) for v in losses],
           "bucket_cap_bytes": bucket_bytes(), "buckets": len(buckets),
           "bucket_bytes": sum(b.total for b in buckets) * item,
           "solo_keys": len(solo),
           "solo_bytes": sum(grads[p].size for p in solo) * item,
           "keys": len(grads),
           "exchange_ms": [a.elapsed_time(b) for a, b in events],
           "overlap_units_before_step": ov_launched,
           "overlap_drain_ms": [a.elapsed_time(b) for a, b in ov_events],
           "launches": counts, "codecs": dist_codecs(dev)}
    return rec


def _digest(tensors):
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _worst_rel(got, want):
    return max(float((got[n] - want[n]).abs().max())
               / (float(want[n].abs().max()) + 1e-30) for n in want)


def dist_part_b(dev):
    """(b) and (c) Two ranks: BERT-base fp32, the global batch of 16 as
    two halves of 8, two steps through ``Trainer(kvstore="ici")`` and two
    through the dp ``TrainStep``; the weights bitwise equal across the
    ranks, and on rank 0 within 1e-4 x max|ref| of one process's run on
    the whole batch."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, nd
    from mxnet_tpu_torch.ops import _kernels
    from mxnet_tpu_torch.parallel import TrainStep, make_mesh
    rank, world = dist.get_rank(), dist.get_world_size()
    loss_fn = dist_mlm_loss(cast=False)
    host = train_batch_host(TRAIN_BATCH)
    half = TRAIN_BATCH // world
    mine = [a[rank * half:(rank + 1) * half] for a in host]
    opt_args = {"learning_rate": TRAIN_LR, "momentum": TRAIN_MOMENTUM}

    def trainer_run(local, kvstore, batch_size):
        net = dist_bert(dev, "float32")
        trainer = gluon.Trainer(net.collect_params(), "sgd", opt_args,
                                kvstore=kvstore)
        batch = [nd.array(a, ctx=mx.Context.from_torch(dev))
                 for a in local]
        losses, events = [], []
        for _ in range(DIST_STEPS_B):
            losses.append(float(dist_fwd_bwd(net, loss_fn, batch)))
            events.append(dist_exchange(trainer))
            trainer.update(batch_size)
        torch.cuda.synchronize()
        return (losses, _weights(net),
                [a.elapsed_time(b) for a, b in events],
                len(net.encoder.transformer_cells))

    def step_run(local, mesh):
        step = TrainStep(dist_bert(dev, "float32"), loss_fn, mesh=mesh,
                         device=dev, **opt_args)
        losses = [float(step(*local)) for _ in range(DIST_STEPS_B)]
        return losses, step.params

    torch.cuda.synchronize()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    tr_losses, tr_params, tr_exchange, n_layers = trainer_run(mine, "ici",
                                                              world)
    st_losses, st_params = step_run(mine, make_mesh())
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _kernels.launch_counts()
    want = n_layers * 2 * DIST_STEPS_B
    if any(counts[k] != want for k in _FLASH):
        raise RuntimeError("dist (b): launched %s, expected %d of each of %s"
                           % (counts, want, _FLASH))
    digests = [None] * world
    dist.all_gather_object(digests, [_digest(tr_params.values()),
                                     _digest(st_params.values())])
    if any(d != digests[0] for d in digests):
        raise RuntimeError("dist (b): the weights differ across the ranks")
    rec = {"part": "b", "backend": dist.get_backend(), "world": world,
           "rank": rank, "device": str(dev), "trainer_losses": tr_losses,
           "trainer_exchange_ms": tr_exchange,
           "trainstep_losses": st_losses, "dp_seconds": secs,
           "launches": counts}
    if rank == 0:
        ref_losses, ref_params, _, _ = trainer_run(host, None, 1)
        rec["trainer_worst"] = _worst_rel(tr_params, ref_params)
        del ref_params
        ref_losses2, ref_step = step_run(host, None)
        rec["trainstep_worst"] = _worst_rel(st_params, ref_step)
        rec["ref_trainer_losses"], rec["ref_trainstep_losses"] = \
            ref_losses, ref_losses2
        if not (rec["trainer_worst"] <= DIST_TOL and
                rec["trainstep_worst"] <= DIST_TOL):
            raise RuntimeError("dist (b): the two-rank weights are %.3g "
                               "(Trainer) and %.3g (TrainStep) x max|ref| "
                               "from one process's, tolerance %g"
                               % (rec["trainer_worst"],
                                  rec["trainstep_worst"], DIST_TOL))
    dist.barrier()
    return rec


def dist_worker(part):
    """One rank of a ``phase_dist`` part, started by the port's launcher:
    joins the process group (NCCL for (a) and (c), gloo on the card's
    tensors for (b)), runs the part and prints its record."""
    from mxnet_tpu_torch.parallel import init_process_group
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = init_process_group(backend={"a": None, "b": "gloo",
                                      "c": "nccl"}[part])
    try:
        rec = dist_part_a(dev) if part == "a" else dist_part_b(dev)
        emit("dist-worker: " + json.dumps(rec))
    finally:
        dist.destroy_process_group()


def dist_launch(n, part):
    """Run part ``part`` as ``n`` ranks through the port's launcher, bounded
    by :data:`DIST_TIMEOUT`; raises unless it exits 0 with a record from
    every rank.  Returns (records, seconds)."""
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n",
           str(n), "--launcher", "local", "--", sys.executable,
           os.path.join(root, "chip_smoke.py"), "--dist-worker", part]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                       timeout=DIST_TIMEOUT)
    secs = time.perf_counter() - t0
    recs = [json.loads(line[len("dist-worker: "):])
            for line in r.stdout.splitlines()
            if line.startswith("dist-worker: ")]
    if r.returncode != 0 or len(recs) != n:
        raise RuntimeError("dist (%s): the launcher exited %d with %d of %d "
                           "records:\n%s\n%s" % (part, r.returncode,
                                                 len(recs), n,
                                                 r.stdout[-4000:],
                                                 r.stderr[-4000:]))
    return recs, secs


def phase_dist(smi):
    """Data-parallel training across processes, no kernel of its own (the
    exchange is NCCL's or gloo's collectives; K1-K3 run in BERT-base): each
    part launched by ``python -m mxnet_tpu_torch.tools.launch`` as a
    subprocess with a time limit.  (a) ``-n 1`` on NCCL, (b) ``-n 2`` over
    gloo with both ranks on ``cuda:0``, (c) ``-n 2`` on NCCL over
    ``cuda:0`` and ``cuda:1`` where the machine has two cards.  Returns
    every kernel's launches in the counted runs (the ``dist`` path), summed
    over the parts' ranks."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    (a,), secs_a = dist_launch(1, "a")
    log("dist: (a) %s" % json.dumps(dict(a, seconds=secs_a)))
    b, secs_b = dist_launch(2, "b")
    for rec in b:
        log("dist: (b) %s" % json.dumps(dict(rec, seconds=secs_b)))
    parts = [a] + b
    if torch.cuda.device_count() >= 2:
        c, secs_c = dist_launch(2, "c")
        for rec in c:
            log("dist: (c) %s" % json.dumps(dict(rec, seconds=secs_c)))
        parts += c
    else:
        log("dist: (c) not run: NCCL across two ranks needs two cards, and "
            "this machine has %d" % torch.cuda.device_count())
    launches = {}
    for p in parts:
        for k, v in p["launches"].items():
            launches[k] = launches.get(k, 0) + v
    log("dist: %s" % json.dumps({"launches": launches,
                                 "phase_s": time.perf_counter() - t_phase,
                                 "card": smi}))
    return launches


# ---------------------------------------------------------------------------
# 17. the dist_async parameter server
# ---------------------------------------------------------------------------

PS_BATCH = 8                    # a worker's batch (T = SEQ_LEN)
PS_STEPS_A = 3                  # server steps, then as many local ones
PS_STEPS_B = 2                  # each rank's steps in part (b)
PS_LR_B = 0.1                   # part (b)'s plain SGD
PS_TOL_A = 1e-4                 # the port's fp32 rule, x max|ref|
PS_TOL_B = 1e-5                 # x max|w0| (max|w| for a zero-init tensor)
PS_OPS_TOL = 1e-5               # R1's ops, card against CPU, x max(1, |ref|)
PS_TIMEOUT = 300                # seconds a part's launcher may take


def train_dist_async(argv=None):
    """The port's copy of ``examples/train_dist_async.py``: each worker
    streams its own batches of a linear regression and the server applies
    every push the moment it arrives (server-side SGD), so workers never
    wait for each other.  Run (one server, two workers)::

        python -m mxnet_tpu_torch.tools.launch -n 2 -s 1 --launcher local \\
            -- python chip_smoke.py --train-dist-async [--steps 50] \\
            [--device cpu]

    Prints ``rank R FINAL loss L (workers=N)`` at the end."""
    import argparse
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, kvstore, nd, optimizer
    p = argparse.ArgumentParser(description=train_dist_async.__doc__)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--device", default="gpu", choices=["gpu", "cpu"])
    args = p.parse_args(argv)
    ctx = mx.cpu() if args.device == "cpu" else mx.gpu(0)
    with ctx:
        kv = kvstore.create("dist_async")
        rank, nworkers = kv.rank, kv.num_workers
        mx.random.seed(rank)                  # workers see different data
        # a tiny regression net; its weights live on the server
        net = gluon.nn.Dense(1, in_units=8)
        net.initialize(mx.init.Xavier(), device=ctx, seed=rank)
        params = list(net.collect_params().values())
        for i, param in enumerate(params):
            kv.init(i, param.data())
        kv.set_optimizer(optimizer.SGD(learning_rate=args.lr))
        for i, param in enumerate(params):    # start from the server's
            kv.pull(i, out=param.data())
        rng = np.random.RandomState(100 + rank)
        w_true = np.arange(8, dtype=np.float32).reshape(8, 1) / 8.0
        for step in range(args.steps):
            X = nd.array(rng.randn(args.batch_size, 8).astype(np.float32))
            y = nd.array(X.asnumpy() @ w_true)
            with autograd.record():
                loss = ((net(X) - y) ** 2).mean()
            loss.backward()
            for i, param in enumerate(params):
                kv.push(i, param.grad())      # applied on the server now
                kv.pull(i, out=param.data())  # whatever is current
            if step % 10 == 0:
                emit("rank %d step %d loss %.4f"
                     % (rank, step, float(loss.asnumpy())))
        kv._barrier()
        emit("rank %d FINAL loss %.4f (workers=%d)"
             % (rank, float(loss.asnumpy()), nworkers))
        kv.close()


def ps_batch_host(step, rank):
    """One worker's batch of step ``step`` as numpy arrays: token ids,
    segment ids (0) and MLM labels, different for each rank."""
    rng = np.random.RandomState(SEED + 1000 + 10 * step + rank)
    tok = rng.randint(0, VOCAB, size=(PS_BATCH, SEQ_LEN)).astype(np.int64)
    lab = rng.randint(0, VOCAB, size=(PS_BATCH, SEQ_LEN)).astype(np.int64)
    return tok, np.zeros_like(tok), lab


def ps_model(dev):
    """BERT-base with the MLM decoder at its published widths, fp32,
    dropout 0, from the seed; and its gluon Parameters in key order."""
    net = dist_bert(dev, "float32")
    return net, list(net.collect_params().values())


def ps_step(net, params, loss_fn, batch, kv, timing=None):
    """One step of ``examples/train_dist_async.py``'s loop: forward,
    backward, then for each parameter ``kv.push(i, grad)`` and
    ``kv.pull(i, out=weight)``.  ``timing`` (a dict) gains the host-clock
    seconds of the pushes and of the pulls and each leg's wire bytes.
    Returns the loss."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.engine import engine
    loss = dist_fwd_bwd(net, loss_fn, batch)
    pulled = telemetry.registry.counter("kvstore.pull_wire_bytes")
    push_s = pull_s = 0.0
    push_b = pull_b = 0
    for i, p in enumerate(params):
        w0, t0 = engine.wire_bytes, time.perf_counter()
        kv.push(i, p.grad())
        w1, t1 = engine.wire_bytes, time.perf_counter()
        r0 = pulled.value
        kv.pull(i, out=p.data())
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        push_s, pull_s = push_s + t1 - t0, pull_s + t2 - t1
        push_b, pull_b = push_b + w1 - w0, pull_b + pulled.value - r0
    if timing is not None:
        for k, v in (("push_ms", push_s * 1e3), ("pull_ms", pull_s * 1e3),
                     ("push_wire_bytes", push_b),
                     ("pull_wire_bytes", pull_b)):
            timing.setdefault(k, []).append(v)
    return loss


def ps_device_batch(host, dev):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd
    return [nd.array(a, ctx=mx.Context.from_torch(dev)) for a in host]


def ps_profiled_step(net, params, loss_fn, batch, kv, trace_dir):
    """(c) One more server step under the profiler with a device trace:
    the chrome trace must name K1-K3's kernels and ``profiler.dumps()``
    the client's PUSH and PULL spans."""
    from mxnet_tpu_torch import profiler
    profiler.set_config(profile_all=True, device_trace_dir=trace_dir)
    profiler.set_state("run")
    try:
        ps_step(net, params, loss_fn, batch, kv)
    finally:
        profiler.set_state("stop")
    with open(profiler.device_trace_path()) as f:
        names = {ev.get("name", "") for ev in json.load(f)["traceEvents"]}
    flash = sorted({m.group(0) for m in map(_TRACED_FLASH.search, names)
                    if m})
    table = profiler.dumps()
    spans = [s for s in ("kv.client.PUSH", "kv.client.PULL") if s in table]
    profiler.set_config(profile_all=False, device_trace_dir=None)
    profiler.reset()
    if len(flash) != 3 or len(spans) != 2:
        raise RuntimeError("ps (c): the trace names %s (want K1-K3's three "
                           "kernels) and profiler.dumps() has %s (want "
                           "kv.client.PUSH and kv.client.PULL)"
                           % (flash, spans))
    return flash, spans


def ps_part_a(dev, trace_dir):
    """(a) One worker, one server: 3 steps with the server's SGD (momentum
    0.9), one profiled step (c), then 3 steps from the same weights and
    batches with a local updater of the same SGD on the card.  Step 1's
    loss bitwise equal, every weight after step 3 within 1e-4 x max|ref|
    of the local run's."""
    from mxnet_tpu_torch import kvstore, optimizer
    from mxnet_tpu_torch.ops import _kernels
    loss_fn = dist_mlm_loss(cast=False)
    net, params = ps_model(dev)
    kv = kvstore.create("dist_async")
    if kv.type != "dist_async":
        raise RuntimeError("ps (a): the store is %r" % kv.type)
    for i, p in enumerate(params):
        kv.init(i, p.data())
    kv.set_optimizer(optimizer.SGD(learning_rate=TRAIN_LR,
                                   momentum=TRAIN_MOMENTUM))
    for i, p in enumerate(params):
        kv.pull(i, out=p.data())
    w0 = [p.data().data.detach().clone() for p in params]
    batches = [ps_device_batch(ps_batch_host(s, 0), dev)
               for s in range(PS_STEPS_A + 1)]
    timing = {}
    torch.cuda.synchronize()
    _kernels.reset_launches()
    # --- the ps main path, counted ---
    losses = [ps_step(net, params, loss_fn, batches[s], kv, timing)
              for s in range(PS_STEPS_A)]
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    # --- end of the counted main path ---
    want = len(net.encoder.transformer_cells) * PS_STEPS_A
    if any(counts[k] != want for k in _FLASH):
        raise RuntimeError("ps (a): launched %s, expected %d of each of %s"
                           % (counts, want, _FLASH))
    w_ps = [p.data().data.detach().clone() for p in params]
    t_c = time.perf_counter()
    flash, spans = ps_profiled_step(net, params, loss_fn,
                                    batches[PS_STEPS_A], kv, trace_dir)
    secs_c = time.perf_counter() - t_c
    # the control: the same steps with a local updater on the card
    with torch.no_grad():
        for p, w in zip(params, w0):
            p.data().data.copy_(w)
    upd = optimizer.get_updater(optimizer.SGD(learning_rate=TRAIN_LR,
                                              momentum=TRAIN_MOMENTUM))
    ref_losses = []
    for s in range(PS_STEPS_A):
        ref_losses.append(dist_fwd_bwd(net, loss_fn, batches[s]))
        for i, p in enumerate(params):
            upd(i, p.grad(), p.data())
    torch.cuda.synchronize()
    if not torch.equal(losses[0], ref_losses[0]):
        raise RuntimeError("ps (a): step 1's loss %r through the server, "
                           "%r with the local updater"
                           % (float(losses[0]), float(ref_losses[0])))
    worst = max(float((a - p.data().data.detach()).abs().max())
                / (float(p.data().data.detach().abs().max()) + 1e-30)
                for a, p in zip(w_ps, params))
    if not worst <= PS_TOL_A:
        raise RuntimeError("ps (a): the server's weights are %.3g x "
                           "max|ref| from the local updater's, tolerance %g"
                           % (worst, PS_TOL_A))
    kv.close()
    return {"part": "a", "servers": len(kv._addrs), "keys": len(params),
            "entries": sum(p.data().size for p in params),
            "losses": [float(v) for v in losses],
            "ref_losses": [float(v) for v in ref_losses],
            "weights_worst": worst, **timing, "launches": counts,
            "profiled_kernels": flash, "profiled_spans": spans,
            "profiled_step_s": secs_c}


def ps_part_b(dev, tmp):
    """(b) Two workers on ``cuda:0``, two servers, plain SGD (lr 0.1): each
    rank takes 2 steps on its own data and keeps the float64 sum S_r of
    the gradients it pushed.  After the barrier rank 0 pulls every weight:
    w = w0 - 0.1 (S_0 + S_1) on every tensor, and the control
    w0 - 0.1 S_0 fails on most of them."""
    from mxnet_tpu_torch import kvstore, optimizer
    from mxnet_tpu_torch.ops import _kernels
    loss_fn = dist_mlm_loss(cast=False)
    net, params = ps_model(dev)
    kv = kvstore.create("dist_async")
    rank = kv.rank
    for i, p in enumerate(params):
        kv.init(i, p.data())
    kv.set_optimizer(optimizer.SGD(learning_rate=PS_LR_B))   # + a barrier
    for i, p in enumerate(params):
        kv.pull(i, out=p.data())
    w0 = [p.data().data.detach().clone() for p in params] \
        if rank == 0 else None
    sums = [torch.zeros(p.data().shape, dtype=torch.float64, device=dev)
            for p in params]
    timing = {}
    torch.cuda.synchronize()
    _kernels.reset_launches()
    for s in range(PS_STEPS_B):
        batch = ps_device_batch(ps_batch_host(s, rank), dev)
        loss = dist_fwd_bwd(net, loss_fn, batch)
        for i, p in enumerate(params):
            sums[i] += p.grad().data.detach().double()
        # the pushes and pulls of this step (gradients read before them)
        for i, p in enumerate(params):
            kv.push(i, p.grad())
            kv.pull(i, out=p.data())
        timing.setdefault("losses", []).append(float(loss))
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    if rank == 1:
        torch.save([s.cpu() for s in sums], os.path.join(tmp, "S_1.pt"))
    kv._barrier()
    rec = {"part": "b", "rank": rank, "servers": len(kv._addrs),
           "launches": counts, **timing}
    if rank == 0:
        from mxnet_tpu_torch import nd
        s1 = torch.load(os.path.join(tmp, "S_1.pt"))
        worst, control_fail, split = 0.0, 0, 0
        for i, p in enumerate(params):
            got = torch.empty_like(p.data().data)
            kv.pull(i, out=nd.NDArray(got))
            split += kv._shard_plan(got.numel()) is not None
            base = w0[i].double()
            scale = float(base.abs().max()) or \
                float(got.abs().max()) or 1.0     # 1.0: a tensor left at 0
            both = base - PS_LR_B * (sums[i] + s1[i].to(dev))
            alone = base - PS_LR_B * sums[i]
            err = float((got.double() - both).abs().max()) / scale
            worst = max(worst, err)
            if float((got.double() - alone).abs().max()) > PS_TOL_B * scale:
                control_fail += 1
        rec.update({"keys": len(params), "split_keys": split,
                    "residual_worst": worst,
                    "control_failing_keys": control_fail})
        if not worst <= PS_TOL_B:
            raise RuntimeError("ps (b): w0 - lr (S_0 + S_1) misses by %.3g "
                               "x max|w0|, tolerance %g" % (worst, PS_TOL_B))
        if not control_fail > len(params) // 2:
            raise RuntimeError("ps (b): the control w0 - lr S_0 fails on "
                               "only %d of %d tensors" % (control_fail,
                                                          len(params)))
    kv.close()
    return rec


def ps_worker(part, tmp):
    """One worker of a ``phase_ps`` part, started by the port's launcher
    beside the servers: the part on the card, its record printed."""
    if not torch.cuda.is_available():
        raise SystemExit("ps-worker: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    rec = ps_part_a(dev, tmp) if part == "a" else ps_part_b(dev, tmp)
    emit("ps-worker: " + json.dumps(rec))


def ps_launch(n, s, part, tmp):
    """Run part ``part`` as ``n`` workers beside ``s`` servers through the
    port's launcher, bounded by :data:`PS_TIMEOUT`; raises unless it exits
    0 with a record from every worker.  Returns (records, seconds)."""
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n",
           str(n), "-s", str(s), "--launcher", "local", "--",
           sys.executable, os.path.join(root, "chip_smoke.py"),
           "--ps-worker", part, tmp]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                       timeout=PS_TIMEOUT)
    secs = time.perf_counter() - t0
    recs = [json.loads(line[len("ps-worker: "):])
            for line in r.stdout.splitlines()
            if line.startswith("ps-worker: ")]
    if r.returncode != 0 or len(recs) != n:
        raise RuntimeError("ps (%s): the launcher exited %d with %d of %d "
                           "records:\n%s\n%s" % (part, r.returncode,
                                                 len(recs), n,
                                                 r.stdout[-4000:],
                                                 r.stderr[-4000:]))
    return recs, secs


#: R1's ops, each with its inputs (numpy, from the seed) and parameters
def ps_op_cases():
    rng = np.random.RandomState(SEED)
    x16 = rng.randn(4, 8, 16, 16).astype(np.float32)
    x8 = rng.randn(4, 8, 8, 8).astype(np.float32)
    gamma = rng.randn(8).astype(np.float32)
    return [("AdaptiveAvgPooling2D", [x16], {"output_size": 4}),
            ("BilinearResize2D", [x16], {"height": 8, "width": 8}),
            ("BilinearResize2D", [x8], {"height": 5, "width": 13}),
            ("UpSampling", [x8], {"scale": 2, "sample_type": "nearest"}),
            ("UpSampling", [x8], {"scale": 2, "sample_type": "bilinear"}),
            ("softmin", [x8], {"axis": 1}),
            ("SoftmaxOutput", [x8, x8], {"multi_output": True}),
            ("RMSNorm", [x8, gamma], {}),
            ("LinearRegressionOutput", [x8, x8], {}),
            ("MAERegressionOutput", [x8, x8], {}),
            ("LogisticRegressionOutput", [x8, x8], {})]


def ps_ops():
    """(d) R1's ten ops on the card against the CPU, each output and the
    gradient of ``sum(out * cot)`` w.r.t. the first input."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, nd
    out = {}
    for name, inputs, params in ps_op_cases():
        res = []
        for ctx in (mx.gpu(0), mx.cpu()):
            arrs = [nd.array(a, ctx=ctx) for a in inputs]
            arrs[0].attach_grad()
            with autograd.record():
                y = getattr(nd, name)(*arrs, **params)
                cot = nd.array(np.random.RandomState(SEED + 7).randn(
                    *y.shape).astype(np.float32), ctx=ctx)
                head = (y * cot).sum()
            head.backward()
            res.append((y.asnumpy(), arrs[0].grad.asnumpy()))
        (gy, gg), (cy, cg) = res
        err = max(float(np.abs(gy - cy).max()) / max(1.0, float(
            np.abs(cy).max())), float(np.abs(gg - cg).max()) / max(
                1.0, float(np.abs(cg).max())))
        key = "%s%s" % (name, "" if name not in out else
                        ":" + str(sorted(params.items())))
        out[key] = err
        if not err <= PS_OPS_TOL:
            raise RuntimeError("ps (d): %s %s differs on the card from the "
                               "CPU by %.3g x max(1, |ref|)"
                               % (name, params, err))
    return out


def phase_ps(smi):
    """The dist_async parameter server, no kernel of its own (the servers
    run SGD on the host; K1-K3 run in BERT-base on the workers): each part
    started by ``python -m mxnet_tpu_torch.tools.launch -s ...`` as a
    subprocess with a time limit.  (a) and (c) ``-n 1 -s 1``; (b) ``-n 2
    -s 2``; (d) the ten ops of ``ops/nn.py`` this slice registered.
    Returns every kernel's launches in the counted runs (the ``ps``
    path)."""
    import tempfile
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-ps-") as tmp:
        (a,), secs_a = ps_launch(1, 1, "a", tmp)
        log("ps: (a) %s" % json.dumps(dict(a, seconds=secs_a)))
        b, secs_b = ps_launch(2, 2, "b", tmp)
        for rec in b:
            log("ps: (b) %s" % json.dumps(dict(rec, seconds=secs_b)))
    t_d = time.perf_counter()
    ops = ps_ops()
    secs_d = time.perf_counter() - t_d
    log("ps: (d) %s" % json.dumps({"ops_worst": ops, "seconds": secs_d}))
    launches = {}
    for p in [a] + b:
        for k, v in p["launches"].items():
            launches[k] = launches.get(k, 0) + v
    log("ps: %s" % json.dumps({"launches": launches,
                               "phase_s": time.perf_counter() - t_phase,
                               "card": smi}))
    return launches


# ---------------------------------------------------------------------------
# 18. supervised training: checkpoints, crashes, hangs and resizes
# ---------------------------------------------------------------------------

#: the worker's model and batch: BERT-base with the MLM decoder at its
#: published widths, batch 8, T = 128 (parts (b) and (c)); the CPU tests'
#: BERT (2 layers, 64 units, 2 heads), batch 4, T = 16.  (layers, units,
#: heads, vocabulary, batch, T)
RESUME_SIZES = {"base": (12, 768, 12, VOCAB, 8, 128),
                "tiny": (2, 64, 2, 97, 4, 16)}
RESUME_EPOCHS, RESUME_BATCHES = 2, 4
RESUME_RTOL, RESUME_ATOL = 1e-5, 1e-6   # the reference's own acceptance
RESUME_STEP_TIMEOUT = "5"               # MX_STEP_TIMEOUT of the watchdog run
RESUME_HANG_TIMEOUT = "15"              # --hang-timeout of the heartbeat run
RESUME_TIMEOUT = 300                    # seconds a launcher job may take
RESUME_FAULT_AT = 5                     # worker.step calls before the fault


def resume_bert(size, seq_len, dev, dtype):
    """The worker's BERT with the MLM decoder (dropout 0), from the seed,
    on ``dev`` in ``dtype``."""
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon.model_zoo.bert import get_bert
    layers, units, heads, vocab = RESUME_SIZES[size][:4]
    net = get_bert(layers, units, heads, vocab_size=vocab,
                   max_length=seq_len, dropout=0.0, use_classifier=False)
    net.initialize(initializer.Normal(0.02), device=dev, seed=SEED)
    if dtype != "float32":
        net.cast(dtype)
    return net


def resume_loss(out, lab):
    """The bench's loss on tensors: the mean MLM cross-entropy of the
    logits in fp32."""
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    return SoftmaxCrossEntropyLoss()(out[-1].float(), lab).mean()


def resume_batch_host(epoch, nbatch, batch, seq_len, vocab):
    """Batch ``nbatch`` of epoch ``epoch``: a function of (seed, epoch,
    batch) alone, so a resumed rank replays it exactly."""
    rng = np.random.RandomState(SEED + 100_003 * epoch + nbatch)
    tok = rng.randint(0, vocab, size=(batch, seq_len)).astype(np.int64)
    lab = rng.randint(0, vocab, size=(batch, seq_len)).astype(np.int64)
    return tok, np.zeros_like(tok), lab


def process_start_wall():
    """This process's start on the wall clock, from ``/proc`` (Linux):
    boot time plus the process's start in clock ticks."""
    with open("/proc/stat") as f:
        btime = next(int(line.split()[1]) for line in f
                     if line.startswith("btime"))
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return btime + int(fields[19]) / os.sysconf("SC_CLK_TCK")


def _state_bytes(state):
    return sum(t.numel() * t.element_size()
               for part in state.values() for t in part.values())


def resume_worker(argv=None):
    """A supervised training worker: the supervision contract of the
    reference's ``Module.fit`` around the port's ``TrainStep``, with the
    per-rank setup of its ``tools/chaos_fit.py``.  Every rank trains on its
    own (no process group) from the seed, into ``<ckpt-dir>/rank<r>``
    (``MX_PROCESS_ID``):

    * it resumes from the rank's latest checkpoint
      (``checkpoint.resume_or_init``, parameters and momenta), at the epoch
      after it;
    * ``health.StepGuard.from_env()`` (``MX_STEP_TIMEOUT``,
      ``MX_HEARTBEAT_FILE``) guards every batch, and the ``worker.step``
      fault site fires at each batch's start;
    * each epoch ends with ``StepGuard.epoch_end`` and
      ``CheckpointManager.save(epoch, ...)``;
    * under ``MX_ELASTIC`` a SIGTERM sets a flag, and the loop drains at
      the next epoch boundary: it synchronises the card, saves, and exits
      0;
    * any death but ``SystemExit(0)`` leaves ``telemetry.dump_crash`` in
      ``MX_CRASH_DIR``.

    With ``--out`` it appends one JSON event a line to
    ``<out>.rank<r>.log`` (start, each batch's start, each step with the
    kernels' launch counts, each save, the drain) and at the end writes
    the parameters to ``<out>.rank<r>.npz``; it prints one line
    ``RESUME_DONE {...}``.  Run it under the launcher::

        python -m mxnet_tpu_torch.tools.launch -n 2 --restart on-failure \\
            --fault 'worker.step:crash:after=5' -- python chip_smoke.py \\
            --resume-worker --ckpt-dir DIR --out DIR/run [--device cpu \\
            --size tiny]
    """
    import argparse
    import signal
    # imported here, so that the restore time below is the load's alone
    import torch.distributed.checkpoint  # noqa: F401
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import fault, health, telemetry
    from mxnet_tpu_torch.base import get_env
    from mxnet_tpu_torch.checkpoint import resume_or_init
    from mxnet_tpu_torch.ops import _kernels
    from mxnet_tpu_torch.parallel import TrainStep
    p = argparse.ArgumentParser(description=resume_worker.__doc__)
    p.add_argument("--ckpt-dir", required=True,
                   help="checkpoint root; each rank uses <dir>/rank<r>")
    p.add_argument("--out", default=None,
                   help="write <out>.rank<r>.log and <out>.rank<r>.npz")
    p.add_argument("--epochs", type=int, default=RESUME_EPOCHS)
    p.add_argument("--batches", type=int, default=RESUME_BATCHES)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--device", default="gpu", choices=["gpu", "cpu"])
    p.add_argument("--size", default="base", choices=sorted(RESUME_SIZES))
    args = p.parse_args(argv)
    rank = int(os.environ.get("MX_PROCESS_ID", "0"))
    if get_env("MX_NAN_POLICY", ""):
        raise SystemExit("resume-worker: MX_NAN_POLICY needs the gradients "
                         "between backward and the update, which TrainStep "
                         "applies inside its step")
    if args.device == "gpu":
        if not torch.cuda.is_available():
            raise SystemExit("resume-worker: CUDA is not available")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        ctx = mx.gpu(0)
    else:
        dev, ctx = torch.device("cpu"), mx.cpu()
    events = open("%s.rank%d.log" % (args.out, rank), "a") \
        if args.out else None

    def record(**ev):
        if events is not None:
            ev.update(pid=os.getpid(), t=time.time())
            events.write(json.dumps(ev) + "\n")
            events.flush()

    drain = None
    if get_env("MX_ELASTIC", 0, int):
        drain = threading.Event()
        signal.signal(signal.SIGTERM, lambda signum, frame: drain.set())
    vocab, batch, seq_len = RESUME_SIZES[args.size][3:]
    with ctx:
        step = TrainStep(resume_bert(args.size, seq_len, dev, args.dtype),
                         resume_loss, device=dev, learning_rate=TRAIN_LR,
                         momentum=TRAIN_MOMENTUM)
        t0 = time.perf_counter()
        state, start, mgr = resume_or_init(
            os.path.join(args.ckpt_dir, "rank%d" % rank),
            lambda: {"params": step.params, "opt_state": step.opt_state})
        record(event="start", process_start=process_start_wall(),
               start_epoch=start, restore_s=time.perf_counter() - t0,
               generation=os.environ.get("MX_ELASTIC_EPOCH"))
        guard = health.StepGuard.from_env()
        _kernels.reset_launches()
        steps = 0
        try:
            for epoch in range(start, args.epochs):
                for nbatch in range(args.batches):
                    guard.batch_start()
                    record(event="batch", epoch=epoch, batch=nbatch)
                    fault.fire("worker.step")
                    loss = float(step(*resume_batch_host(
                        epoch, nbatch, batch, seq_len, vocab)))
                    steps += 1
                    guard.batch_end(epoch, nbatch)
                    record(event="step", epoch=epoch, batch=nbatch,
                           loss=loss, launches=_kernels.launch_counts())
                guard.epoch_end(epoch)
                draining = drain is not None and drain.is_set()
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                mgr.save(epoch, state)
                record(event="saved", epoch=epoch,
                       save_s=time.perf_counter() - t0,
                       bytes=_state_bytes(state))
                if draining:
                    record(event="drain", epoch=epoch)
                    raise SystemExit(0)
        except BaseException as e:
            # an elastic drain's SystemExit(0) is a clean quiesce, not a
            # death
            if not (isinstance(e, SystemExit) and not e.code):
                telemetry.dump_crash("resume-worker: %r" % (e,))
            raise
        finally:
            guard.close()
    if args.out:
        np.savez("%s.rank%d.npz" % (args.out, rank),
                 **{n: t.detach().float().cpu().numpy()
                    for n, t in step.params.items()})
    record(event="done", steps=steps)
    emit("RESUME_DONE " + json.dumps({
        "rank": rank, "pid": os.getpid(), "start_epoch": start,
        "steps": steps, "launches": _kernels.launch_counts(),
        "generation": os.environ.get("MX_ELASTIC_EPOCH")}))


def resume_part_a(dev, tmp, smi):
    """(a) In one process, BERT-base bf16 at the bench's configuration
    (batch 16, T = 512): 3 steps, ``TrainStep.save``, a fresh step's
    ``restore`` and 3 more steps equal 6 uninterrupted steps bitwise
    (parameters and momenta); ``CheckpointManager(max_to_keep=2)`` over 3
    saves keeps the last 2; an armed ``checkpoint.commit:crash`` leaves the
    previous checkpoint restorable and bitwise intact.  Returns its record
    with the kernels' launches."""
    # imported here, so that the first save's time below is the save's
    import torch.distributed.checkpoint  # noqa: F401
    from mxnet_tpu_torch import fault
    from mxnet_tpu_torch.checkpoint import CheckpointManager, saved_specs
    from mxnet_tpu_torch.ops import _kernels
    from mxnet_tpu_torch.parallel import TrainStep
    batches = [resume_batch_host(0, i, TRAIN_BATCH, SEQ_LEN, VOCAB)
               for i in range(6)]

    def new_step():
        return TrainStep(dist_bert(dev, "bfloat16"), resume_loss, device=dev,
                         learning_rate=TRAIN_LR, momentum=TRAIN_MOMENTUM)

    def state_of(s):
        return {"params": s.params, "opt_state": s.opt_state}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def same(x, y):
        return all(torch.equal(x[k][n], y[k][n]) for k in x for n in x[k])

    path = os.path.join(tmp, "a", "step3")
    torch.cuda.synchronize()
    _kernels.reset_launches()
    a = new_step()
    for i in range(3):
        a(*batches[i])
    save_s = timed(lambda: a.save(path))
    nbytes = _state_bytes(state_of(a))
    for i in range(3, 6):
        a(*batches[i])
    b = new_step()
    for part in state_of(b).values():      # every tensor must be restored
        for t in part.values():
            t.fill_(0.5)
    restore_s = timed(lambda: b.restore(path))
    at3 = {k: {n: t.clone() for n, t in v.items()}
           for k, v in state_of(b).items()}
    for i in range(3, 6):
        b(*batches[i])
    torch.cuda.synchronize()
    launches = _kernels.launch_counts()
    layers = RESUME_SIZES["base"][0]
    if any(launches[k] != layers * 9 for k in _FLASH):
        raise RuntimeError("resume (a): launched %s in 9 steps, expected %d "
                           "of each of %s" % (launches, layers * 9, _FLASH))
    bitwise = same(state_of(a), state_of(b))
    if not bitwise:
        raise RuntimeError("resume (a): 3 steps, save, restore and 3 steps "
                           "differ from 6 uninterrupted steps")
    specs = saved_specs(path)
    if specs is None or specs["mesh_axes"] != {"dp": 1} or \
            specs["leaf_specs"] != [[]] * (2 * len(a.params)):
        raise RuntimeError("resume (a): sidecar %s" % (specs,))
    mgr = CheckpointManager(os.path.join(tmp, "a", "mgr"), max_to_keep=2)
    mgr_s = [timed(lambda s=s: mgr.save(s, state_of(b))) for s in range(3)]
    if mgr.all_steps() != [1, 2]:
        raise RuntimeError("resume (a): max_to_keep=2 over 3 saves kept %s"
                           % mgr.all_steps())
    fault.inject("checkpoint.commit", action="crash")
    try:
        a.save(path)                     # a holds step 6: the kill
        raise RuntimeError("resume (a): checkpoint.commit:crash did not "
                           "fire")
    except SystemExit:
        pass
    finally:
        fault.clear()
    debris = os.path.exists(path + ".saving-tmp")
    crash_restore_s = timed(lambda: b.restore(path))
    intact = same(at3, state_of(b))
    if not (debris and intact):
        raise RuntimeError("resume (a): after a kill in the commit the "
                           "previous checkpoint is %s (debris %s)"
                           % ("intact" if intact else "changed", debris))
    gb = nbytes / 1e9
    rec = {"part": "a", "state_bytes": nbytes, "save_s": save_s,
           "save_GBps": gb / save_s, "restore_s": restore_s,
           "restore_GBps": gb / restore_s, "manager_save_s": mgr_s,
           "kept_steps": mgr.all_steps(), "bitwise": bitwise,
           "commit_crash_intact": intact,
           "commit_crash_restore_s": crash_restore_s,
           "launches": launches, "card": smi}
    del a, b, at3
    return rec


def resume_job(tmp, tag, n, launcher_args=(), env=None,
               worker_args=()):
    """Start ``python -m mxnet_tpu_torch.tools.launch -n n`` over
    ``chip_smoke.py --resume-worker`` into ``tmp/<tag>``, its output into
    files; returns the job (a dict)."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(tmp, tag)
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n",
           str(n), "--launcher", "local", *launcher_args, "--",
           sys.executable, os.path.join(root, "chip_smoke.py"),
           "--resume-worker", "--ckpt-dir", out, "--out", out,
           *worker_args]
    full_env = dict(os.environ, MX_CRASH_DIR=os.path.join(tmp, tag + ".crash"),
                    **(env or {}))
    full_env.pop("MX_FAULT_INJECT", None)
    stdout = open(out + ".stdout", "w")
    stderr = open(out + ".stderr", "w")
    # a session of its own: resume_stop ends the launcher and its workers
    proc = subprocess.Popen(cmd, cwd=root, env=full_env, stdout=stdout,
                            stderr=stderr, text=True, start_new_session=True)
    return {"tag": tag, "out": out, "proc": proc, "files": (stdout, stderr),
            "t0": time.perf_counter()}


def resume_stop(job):
    """Kill a job's launcher and every process it started, if running."""
    import signal
    if job["proc"].poll() is None:
        os.killpg(job["proc"].pid, signal.SIGKILL)
        job["proc"].wait()


def resume_wait(job, timeout=RESUME_TIMEOUT):
    """Wait for a job (killing it past ``timeout``): raises unless it exits
    0; returns its stdout, stderr, events by pid and seconds."""
    proc = job["proc"]
    try:
        proc.wait(timeout=max(1.0, timeout - (time.perf_counter()
                                              - job["t0"])))
    except subprocess.TimeoutExpired:
        resume_stop(job)
    secs = time.perf_counter() - job["t0"]
    for f in job["files"]:
        f.close()
    with open(job["out"] + ".stdout") as f:
        out = f.read()
    with open(job["out"] + ".stderr") as f:
        err = f.read()
    if proc.returncode != 0:
        raise RuntimeError("resume (%s): the launcher exited %s after %.1f "
                           "s:\n%s\n%s" % (job["tag"], proc.returncode, secs,
                                           out[-3000:], err[-5000:]))
    return dict(job, stdout=out, stderr=err, seconds=secs,
                events=resume_events(job["out"]))


def resume_events(out):
    """Every worker process's events, by rank and pid in start order."""
    by_proc = {}
    for path in sorted(os.listdir(os.path.dirname(out))):
        name = os.path.basename(out) + ".rank"
        if path.startswith(name) and path.endswith(".log"):
            rank = int(path[len(name):-4])
            with open(os.path.join(os.path.dirname(out), path)) as f:
                for line in f:
                    ev = json.loads(line)
                    by_proc.setdefault((rank, ev["pid"]), []).append(ev)
    return sorted(by_proc.items(), key=lambda kv: kv[1][0]["t"])


def resume_kernel_counts(job, per_step):
    """Each worker process's K1-K3 launches: ``per_step`` a step of each,
    times the steps it ran (its last step event's counts); returns their
    sum and the steps."""
    total, steps = dict.fromkeys(_FLASH, 0), 0
    for (rank, pid), evs in job["events"]:
        ran = [e for e in evs if e["event"] == "step"]
        counts = ran[-1]["launches"] if ran else dict.fromkeys(_FLASH, 0)
        for k in _FLASH:
            if counts.get(k, 0) != per_step * len(ran):
                raise RuntimeError(
                    "resume (%s): rank %d pid %d ran %d steps and launched "
                    "%s %d times, expected %d" % (
                        job["tag"], rank, pid, len(ran), k,
                        counts.get(k, 0), per_step * len(ran)))
            total[k] += counts.get(k, 0)
        steps += len(ran)
    return total, steps


def resume_compare(job, want, ranks):
    """Each rank's final parameters against the reference run's: the
    largest absolute difference, whether bitwise; raises past rtol 1e-5 /
    atol 1e-6."""
    worst, bitwise = 0.0, True
    for rank in ranks:
        got = np.load("%s.rank%d.npz" % (job["out"], rank))
        if set(got.files) != set(want.files):
            raise RuntimeError("resume (%s): rank %d's parameter names "
                               "differ" % (job["tag"], rank))
        for k in want.files:
            d = np.abs(got[k] - want[k])
            worst = max(worst, float(d.max()))
            bitwise = bitwise and np.array_equal(got[k], want[k])
            if not np.all(d <= RESUME_ATOL + RESUME_RTOL * np.abs(want[k])):
                raise RuntimeError(
                    "resume (%s): rank %d %s differs from the uninterrupted "
                    "run by %.3g" % (job["tag"], rank, k, float(d.max())))
    return {"max_abs_diff": worst, "bitwise": bitwise}


def resume_restarts(job):
    """Restart-to-first-step latency of each restarted process: from its
    predecessor's last batch start (the fault fired right after it) to the
    process's start, on to the end of its restore (imports, the model, the
    checkpoint) and to its first completed step."""
    last, out = {}, []
    for (rank, pid), evs in job["events"]:
        start = evs[0]
        first = next((e for e in evs if e["event"] == "step"), None)
        if rank in last and first is not None:
            dead = last[rank]
            out.append({"rank": rank, "start_epoch": start["start_epoch"],
                        "death_to_start_s": start["process_start"] - dead,
                        "start_to_restored_s":
                            start["t"] - start["process_start"],
                        "start_to_first_step_s":
                            first["t"] - start["process_start"],
                        "restart_to_first_step_s": first["t"] - dead,
                        "restore_s": start["restore_s"]})
        batches = [e for e in evs if e["event"] == "batch"]
        last[rank] = batches[-1]["t"] if batches else evs[-1]["t"]
    return out


def resume_done(job, n, generation=None):
    """The RESUME_DONE records of the workers of ``generation`` (None: not
    elastic); raises unless there are ``n``."""
    done = [json.loads(line[len("RESUME_DONE "):])
            for line in job["stdout"].splitlines()
            if line.startswith("RESUME_DONE ")]
    done = [d for d in done if d["generation"] == generation]
    if len(done) != n:
        raise RuntimeError("resume (%s): %d RESUME_DONE lines, expected %d:"
                           "\n%s" % (job["tag"], len(done), n,
                                     job["stdout"][-2000:]))
    return done


def resume_expect(job, *needles):
    for needle in needles:
        if needle not in job["stderr"]:
            raise RuntimeError("resume (%s): %r not in the launcher's "
                               "stderr:\n%s" % (job["tag"], needle,
                                                job["stderr"][-4000:]))


def resume_elastic(tmp, worker_args=(), grow=(1, 2), timeout=RESUME_TIMEOUT):
    """(c) ``--elastic --resize-file F --drain-timeout 60`` with ``grow[0]``
    workers, F set to ``grow[1]`` once rank 0's checkpoint directory
    appears.  Returns the job, the interleaving and the drain's times."""
    job = resume_job(tmp, "elastic", grow[0], [
        "--elastic", "--resize-file", os.path.join(tmp, "elastic.resize"),
        "--drain-timeout", "60"], worker_args=worker_args)
    ckpt0 = os.path.join(job["out"], "rank0")
    deadline = time.perf_counter() + timeout
    while not os.path.isdir(ckpt0) and job["proc"].poll() is None and \
            time.perf_counter() < deadline:
        time.sleep(0.02)
    t_resize = time.time()
    with open(os.path.join(tmp, "elastic.resize.tmp"), "w") as f:
        f.write(str(grow[1]))
    os.replace(os.path.join(tmp, "elastic.resize.tmp"),
               os.path.join(tmp, "elastic.resize"))
    try:
        job = resume_wait(job, timeout)
    finally:
        resume_stop(job)
    resume_expect(job, "elastic resize")
    gen0 = [evs for (rank, _pid), evs in job["events"]
            if rank == 0 and evs[0].get("generation") == "0"]
    drained = [e for evs in gen0 for e in evs if e["event"] == "drain"]
    finished = any(e["event"] == "done" for evs in gen0 for e in evs)
    if drained:
        where = "drain at epoch %d" % drained[0]["epoch"]
        drain_s = drained[0]["t"] - t_resize
    elif finished:
        where, drain_s = "after the fit ended", None
    else:
        where, drain_s = "before the first epoch ended (no drain)", None
    gen1 = [evs for (_rank, _pid), evs in job["events"]
            if evs[0].get("generation") == "1"]
    first = min((e["t"] for evs in gen1 for e in evs
                 if e["event"] == "step"), default=None)
    return job, {"interleaving": where, "resize_to_drained_s": drain_s,
                 "resize_to_first_step_s":
                     None if first is None else first - t_resize}


def resume_part_b(tmp, worker_args=(), per_step=RESUME_SIZES["base"][0],
                  grow=(1, 2)):
    """(b) and (c) Under the port's launcher, all five jobs at once: the
    reference ``-n 1``; the crash run ``-n 2 --restart on-failure
    --max-restarts 2 --fault worker.step:crash:after=5``; the watchdog run
    ``-n 1 --restart on-failure`` with ``worker.step:delay:delay=60,after=5``
    and ``MX_STEP_TIMEOUT``; the heartbeat run, the same delay with
    ``--hang-timeout`` and no watchdog; and (c), ``-n 1 --elastic`` grown
    to 2 (``grow``).  Each ends at exit 0 with every rank's final
    parameters within rtol 1e-5 / atol 1e-6 of the reference run's, and
    every worker process launched each of K1-K3 ``per_step`` times a step
    (BERT-base's 12 layers on the card; none on the CPU).  Returns the
    records."""
    delay = "worker.step:delay:delay=60,after=%d" % RESUME_FAULT_AT
    restart = ["--restart", "on-failure", "--max-restarts", "2"]
    jobs = [resume_job(tmp, "ref", 1, worker_args=worker_args),
            resume_job(tmp, "crash", 2, restart + [
                "--fault", "worker.step:crash:after=%d" % RESUME_FAULT_AT],
                worker_args=worker_args),
            resume_job(tmp, "watchdog", 1, restart + ["--fault", delay],
                       env={"MX_STEP_TIMEOUT": RESUME_STEP_TIMEOUT},
                       worker_args=worker_args),
            resume_job(tmp, "heartbeat", 1, restart + [
                "--fault", delay, "--hang-timeout", RESUME_HANG_TIMEOUT],
                worker_args=worker_args)]
    try:
        elastic, elastic_rec = resume_elastic(tmp, worker_args, grow)
        ref, crash, watchdog, heartbeat = [resume_wait(j) for j in jobs]
    finally:
        for j in jobs:
            resume_stop(j)
    resume_done(ref, 1)
    resume_expect(crash, "rank 0 failed (exit", "rank 1 failed (exit",
                  "restart 1/")
    resume_expect(watchdog, "watchdog: no training-step progress",
                  "exit 86", "MX_STEP_TIMEOUT watchdog", "restart 1/")
    resume_expect(heartbeat, "heartbeat stale", "restart 1/")
    want = np.load(ref["out"] + ".rank0.npz")
    recs = {}
    for job, n in [(ref, 1), (crash, 2), (watchdog, 1), (heartbeat, 1),
                   (elastic, grow[1])]:
        done = resume_done(job, n, "1" if job is elastic else None)
        launches, steps = resume_kernel_counts(job, per_step)
        rec = {"seconds": job["seconds"], "steps": steps,
               "launches": launches,
               "start_epochs": [d["start_epoch"] for d in sorted(
                   done, key=lambda d: d["rank"])],
               "crash_dumps": sorted(os.listdir(job["out"] + ".crash"))
               if os.path.isdir(job["out"] + ".crash") else []}
        if job is elastic:
            rec.update(elastic_rec)
        else:
            rec["restarts"] = resume_restarts(job)
        if job is not ref:
            rec.update(resume_compare(job, want, range(n)))
        recs[job["tag"]] = rec
    for tag in ("crash", "watchdog", "heartbeat"):
        if recs[tag]["start_epochs"] != [1] * (2 if tag == "crash" else 1):
            raise RuntimeError("resume (%s): the restarted ranks began at "
                               "epochs %s, not after epoch 0's checkpoint"
                               % (tag, recs[tag]["start_epochs"]))
    return recs


def phase_resume(smi):
    """Supervised training: ``checkpoint``, ``health``, ``TrainStep.save``
    / ``restore`` and the launcher's supervisor, no kernel of their own
    (K1-K3 run in BERT-base and are counted under ``resume``).  (a) in this
    process; (b) and (c) ``chip_smoke.py --resume-worker`` under ``python
    -m mxnet_tpu_torch.tools.launch``, the five jobs at once, BERT-base
    fp32, batch 8, T = 128, 2 epochs of 4 batches.  Returns every kernel's
    launches in the counted runs (the ``resume`` path)."""
    import tempfile
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-resume-") as tmp:
        t0 = time.perf_counter()
        a = resume_part_a(dev, tmp, smi)
        a["seconds"] = time.perf_counter() - t0
        log("resume: (a) %s" % json.dumps(a))
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        recs = resume_part_b(tmp)
        secs_b = time.perf_counter() - t0
    for tag, rec in recs.items():
        log("resume: (%s) %s %s" % ("c" if tag == "elastic" else "b", tag,
                                    json.dumps(rec)))
    launches = dict(a["launches"])
    for rec in recs.values():
        for k, v in rec["launches"].items():
            launches[k] = launches.get(k, 0) + v
    log("resume: %s" % json.dumps({"launches": launches,
                                   "jobs_s": secs_b,
                                   "phase_s": time.perf_counter() - t_phase,
                                   "card": smi}))
    return launches


def kernel_row(name, source, replaces, launches, fp32, bf16, extra=None):
    """One entry of the kernels line: the fp32 figures under the contract's
    keys, the bf16 ones under ``bf16_``, and those of ``extra`` (another
    shape) under its own prefix; ``bound_by`` is the fp32 case's."""
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": sum(launches.values()),
           "launches_by_path": launches, "bound_by": fp32["bound_by"]}
    for prefix, rec in [("", fp32), ("bf16_", bf16)] + sorted(
            (extra or {}).items()):
        row.update({prefix + "max_abs_err": rec["max_abs_err"],
                    prefix + "ms": rec["kernel_ms"],
                    prefix + "plain_ms": rec["plain_ms"],
                    prefix + "bound_ms": rec["bound_ms"],
                    prefix + "library_ms": rec["library_ms"]})
        if "device_ms" in rec:
            row.update({prefix + "device_ms": rec["device_ms"],
                        prefix + "library_device_ms":
                            rec["library_device_ms"]})
    return row


def main():
    t_script = time.perf_counter()
    smi, name, peaks = phase_device()
    phase_build()
    fwd = phase_kernels(peaks)
    bwd = phase_bwd_kernels(peaks)
    log_library_ratios(fwd, bwd)
    net, sv, answers, serve_launches = phase_slice()
    tokens, types = make_requests()
    phase_breakdown(sv, tokens, types)
    phase_bf16(net, answers, tokens, types)
    del net, sv, answers
    gc.collect()
    torch.cuda.empty_cache()
    train_launches, train_step_ms = phase_train(peaks)
    gc.collect()
    torch.cuda.empty_cache()
    user_launches, user = phase_user_kernels(peaks)
    gc.collect()
    torch.cuda.empty_cache()
    imperative_launches = phase_imperative(train_step_ms)
    gc.collect()
    torch.cuda.empty_cache()
    resnet_launches = phase_resnet(peaks)
    gc.collect()
    torch.cuda.empty_cache()
    eager_launches = phase_eager(peaks, train_step_ms)
    gc.collect()
    torch.cuda.empty_cache()
    amp_launches = phase_amp(peaks, train_step_ms)
    gc.collect()
    torch.cuda.empty_cache()
    data_launches, det_launches = phase_data()
    gc.collect()
    torch.cuda.empty_cache()
    ssd_launches = phase_ssd(peaks, smi)
    gc.collect()
    torch.cuda.empty_cache()
    lm_launches = phase_lm(peaks, smi)
    gc.collect()
    torch.cuda.empty_cache()
    zoo_launches = phase_zoo(smi)
    gc.collect()
    torch.cuda.empty_cache()
    dist_launches = phase_dist(smi)
    gc.collect()
    torch.cuda.empty_cache()
    ps_launches = phase_ps(smi)
    gc.collect()
    torch.cuda.empty_cache()
    resume_launches = phase_resume(smi)
    by_path = {k: {"serve": serve_launches[k], "train": train_launches[k],
                   "imperative": imperative_launches[k],
                   "resnet": resnet_launches[k],
                   "eager": eager_launches[k], "amp": amp_launches[k],
                   "data": data_launches[k], "det": det_launches[k],
                   "ssd": ssd_launches[k], "lm": lm_launches[k],
                   "zoo": zoo_launches[k], "dist": dist_launches.get(k, 0),
                   "ps": ps_launches.get(k, 0),
                   "resume": resume_launches.get(k, 0)}
               for k in imperative_launches}
    fp32, bf16 = torch.float32, torch.bfloat16
    kernels = [
        kernel_row("flash_fwd", "mxnet_tpu_torch/csrc/flash_fwd.cu",
                   "mxnet_tpu/ops/attention.py:148", by_path["flash_fwd"],
                   fwd[("bert-base", fp32)], fwd[("bert-base", bf16)],
                   {"bf16_train_": fwd[("bert-train", bf16)]}),
        kernel_row("flash_bwd_dq", "mxnet_tpu_torch/csrc/flash_bwd.cu",
                   "mxnet_tpu/ops/attention.py:260", by_path["flash_bwd_dq"],
                   bwd[("flash_bwd_dq", fp32)], bwd[("flash_bwd_dq", bf16)]),
        kernel_row("flash_bwd_dkv", "mxnet_tpu_torch/csrc/flash_bwd.cu",
                   "mxnet_tpu/ops/attention.py:304",
                   by_path["flash_bwd_dkv"], bwd[("flash_bwd_dkv", fp32)],
                   bwd[("flash_bwd_dkv", bf16)]),
    ] + [kernel_row("tpu_kernel:" + body, USER_KERNEL_SOURCE,
                    "mxnet_tpu/tpu_kernel.py:96",
                    {"user_kernels": user_launches[body],
                     "resnet": resnet_launches.get("tpu_kernel:" + body,
                                                   0),
                     "eager": eager_launches.get("tpu_kernel:" + body, 0),
                     "amp": amp_launches.get("tpu_kernel:" + body, 0),
                     "data": data_launches.get("tpu_kernel:" + body, 0),
                     "det": det_launches.get("tpu_kernel:" + body, 0),
                     "ssd": ssd_launches.get("tpu_kernel:" + body, 0),
                     "lm": lm_launches.get("tpu_kernel:" + body, 0),
                     "zoo": zoo_launches.get("tpu_kernel:" + body, 0),
                     "dist": dist_launches.get("tpu_kernel:" + body, 0),
                     "ps": ps_launches.get("tpu_kernel:" + body, 0),
                     "resume": resume_launches.get("tpu_kernel:" + body,
                                                   0)},
                    user[(body, fp32)], user[(body, bf16)],
                    {"default_grid_": user[(body + ":default_grid", fp32)],
                     "bf16_default_grid_": user[(body + ":default_grid",
                                                 bf16)]}
                    if body == "double" else None)
         for body in USER_KERNELS]
    log("smoke: all phases in %.1f s" % (time.perf_counter() - t_script))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-worker"]:
        dist_worker(sys.argv[2])
    elif sys.argv[1:2] == ["--ps-worker"]:
        ps_worker(sys.argv[2], sys.argv[3])
    elif sys.argv[1:2] == ["--resume-worker"]:
        resume_worker(sys.argv[2:])
    elif sys.argv[1:2] == ["--train-dist-async"]:
        train_dist_async(sys.argv[2:])
    else:
        main()
