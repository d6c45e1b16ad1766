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
4b. save_load -- parameter files on the card (``phase_save_load``, right
   after ``slice``): (a) the served BERT-base's ``save_parameters`` file
   (the reference's ``nd.save`` format; bytes and save / load GB/s
   printed) loaded into a fresh block by ``Servable.from_block`` and
   deployed over the first (``ModelHost``), the same 32 requests served
   one a micro-batch: every answer bitwise the first block's served the
   same way, within the slice's tolerance of the slice's burst, K1
   launched 12 times a micro-batch; (b) BERT-base with the MLM decoder
   (bf16, batch 16) through ``Trainer.step`` with Nadam: step 3 after
   ``save_parameters`` + ``Trainer.save_states`` and a fresh block and
   Trainer loaded from both, bitwise the uninterrupted step 3, K1-K3
   launched 12 times a step; (c) one step of each of the thirteen newer
   optimizers (``rmsprop`` ... ``sgld``) on the card against the CPU.
5. bf16    -- the same model cast to bfloat16, one 8 x 512 forward through
   the kernel; its deviation from the fp32 answer is printed for the record.
5c. serve_tier -- the serving tier around the engines
   (``phase_serve_tier``): two replica processes (``chip_smoke.py
   --serve-replica-worker``: BERT-base with the slice's weights beside
   the flat demo LM at the decode phase's bench geometry, under a
   ``ModelHost`` with an HBM budget), a ``FleetCollector`` scraping them
   over METRICS and serving FLEET, and a ``ServeRouter`` fed by it through
   ``serve_router_forever``.  (1) The slice's 32 requests from 8 clients
   through the router: every answer within the slice's tolerance of the
   composition, each client's requests on one replica (the replicas'
   ``serve.requests`` and the router's pins), both replicas with
   sessions, K1 launched exactly 12 x (2 x 4 warm + served micro-batches)
   over the two processes and K2-K4 never.  (2) GENERATE through the
   router by the decode phase's exact rule.  (3) Each replica's METRICS
   parse, carry ``program_compile_seconds`` and ``program_temp_bytes`` > 0
   for every bucket program and ``serve.active_version``, no
   ``program_retraces`` grow over the burst, and FLEET's counters sum
   the replicas'.  (4) In each replica the census's ``serve`` bytes are
   BERT-base's and the LM's parameter bytes, ``kv_cache`` the KV state's,
   the footprint live bytes plus the largest bucket's temp bytes, and the
   conv demo (resnet18) is refused under a budget of the two footprints +
   1 MiB, leaving the models and the census as they were.  (5) DRAIN of
   replica A with long generations in flight: they finish with the
   oracle's tokens, new sessions go to B, A exits 0 by itself within the
   deadline, the router shows A draining, then (after a SWAP's fan-out,
   refused in-band: no loader) dead.  (6) A restarted on its port, the
   router's probe takes it back; B killed (SIGKILL) mid-burst: every
   request answered once and right, ``router.failovers`` and
   ``router.sessions_unpinned`` at least 1.  (7) ``python -m
   mxnet_tpu_torch.serve --demo --decode`` behind ``python -m
   mxnet_tpu_torch.serve.router``: PREDICT equals the demo block, GENERATE
   the oracle, both exit 0 on STOP.  Printed: each replica's deploy and
   warm, bucket temp bytes and first-dispatch seconds, routed requests/s
   and p50/p99, the drain's and the failover's seconds, the command
   line's time to ready.
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
   (c) launch none of K1-K4.  After (a)'s steps, ``nd.multi_all_finite``
   over its gradients agrees with ``LossScaler.has_overflow`` and reads 0
   with one inf planted in one gradient (``nd.all_finite`` of that one
   too), and ``nd.amp_multicast`` casts a bf16 / fp32 pair to fp32
   exactly.
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
   uniform and normal draws; then 10^6 draws of each of the 14 ``_npi_*``
   samplers that carry the legacy aliases, held by the ``_npi_*`` rows of
   the same table and the closed-form moments of the others.  (e) The
   SSD-300 input: ``ImageDetIter`` over
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
   worker, T = 512, dropout 0).  (a) ``-n 1 -s 1``: 2 steps with the
   server's SGD (momentum 0.9), then the same 2 from the same weights
   and batches with a local updater on the card: step 1's loss bitwise
   equal, every weight within 1e-4 x max|ref|; printed: the push and
   pull ms a step (host clock) and each leg's wire bytes a step.  (c)
   One more server step under ``profiler.set_config(profile_all=True,
   device_trace_dir=...)``: the torch.profiler chrome trace names K1-K3's
   kernels, and ``profiler.dumps()`` telemetry's ``kv.client.PUSH`` and
   ``kv.client.PULL`` spans.  (b) ``-n 2 -s 2``, both ranks on ``cuda:0``
   on their own data, plain SGD (lr 0.1): 1 step each, then on rank 0
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
19. context -- sequence, pipeline and expert parallelism
   (``parallel/ring.py``, ``pipeline.py``, ``moe.py``, ``collectives.py``),
   no kernel of their own: ``chip_smoke.py --context-worker`` as two gloo
   ranks on ``cuda:0`` under the port's launcher (their point-to-point and
   all-to-all exchanges staged through pinned host buffers).  (a) The
   port's copy of ``examples/train_long_context.py`` at BERT-base widths
   (768, 12 heads, 12 layers), L = 16384, batch 1, fp32, on a (dp = 1, sp
   = 2) mesh: 3 Adam steps through the ring (K1 on each hop, K2 and K3 on
   each hop backward; a causal hop past the rank's own launches nothing),
   one step through Ulysses; rank 0 then trains the model at sp = 1 on the
   same seeds.  The first step's losses within 1e-4 of sp = 1's, Ulysses'
   gradients within 1e-4 x max|ref|, the ring's within 1e-4 plus what the
   ring's and sp = 1's attention gradients deviate from float64 at L =
   16384 in the same run (4 heads, each within 2e-3), every ring loss
   within 1e-3 relative, and each rank's K1-K3 launches equal to layers x
   hops x steps.  Printed per rank: step
   ms (CUDA events), peak memory, the hop's bytes and ms, K1's ms a hop.
   (b) GPipe over pp = 2, a BERT-base encoder layer a stage, T = 512,
   batch 16 in 4 microbatches: outputs and stage gradients against the
   sequential stack, K1-K3 once a tick.  (c) Top-1 MoE over ep = 2, 8
   BERT-base FFN experts, 4096 tokens a rank, capacity factor 2: outputs,
   the auxiliary loss and gradients against the token-by-token
   computation; the share of tokens dropped.
20. tensor -- tensor and FSDP parallelism (``phase_tensor``): BERT-base
   through ``TrainStep`` at tp = 2 and the sharded ``CompiledStep`` at
   fsdp = 2, plain and int8, two gloo ranks against one process.
21. several -- parameters with a copy on each of two contexts in one
   process (``phase_several``): BERT-base fp32, T = 128, batch 4 over
   ``[gpu(0), cpu(0)]`` (two cards: ``[gpu(0), gpu(1)]``), 3 steps of the
   eager loop (``split_and_load``, a forward and backward a copy,
   ``Trainer.step`` through ``kvstore="device"``), then 3 through
   ``make_compiled_step``, against one context on the whole batch: the
   first reduced gradient, the change from init, the copies after every
   step, the compiled lane against the eager, and a planted one-copy
   gradient that must fail; K1-K3 run in the card's copy (``several``).
22. resnet_dp -- global batch statistics in the dp ``TrainStep``
   (``phase_resnet_dp``): ``chip_smoke.py --resnet-dp-worker`` as two
   gloo ranks on ``cuda:0``, ``resnet50_v1`` on 8 images a rank, 3 steps
   in fp32 (timed; the BatchNorm all-reduces and the gradient exchange
   counted) and 3 in float64, against one process on the 16 images in
   float64 (the momentum, the change, the batch statistics, the running
   statistics, and a planted fault, each rank's own statistics, that must
   fail); none of K1-K4 launched (``resnet_dp``).
23. decode -- the GENERATE path (``phase_decode``): the demo LM (weights
   from one numpy seed) at the reference bench's geometry (dim 8, 1 head,
   6 layers, 8 slots, 48 tokens, prompt buckets 4 and 8) and at BERT-base's
   widths (vocab 30522, 768, 12 heads, 12 layers, 32 slots, 128 tokens,
   prompt buckets 64, 128 and 256).  At each: 32 seeded prompts (at the
   wide geometry 8 over one 128-token prefix) through the flat engine and
   the paged one (prefix sharing, chunked prefill), every token against
   ``reference_generate`` (the unbatched oracle) on the card, a difference
   allowed only at a float tie (the oracle's top-two logit gap in float64
   below 1e-4 x max|logit|; at most one a 1,000 tokens); the same burst
   over the wire (``serve_forever``, one streaming ``ServeClient.generate``
   a prompt) answering the engine's lists; tokens/s, the step's p50 / p99
   ms, the KV bytes and peak memory.  At BERT-base's widths and 12
   layers the demo LM is ill-conditioned in float32 (float32's logits
   ~10-30 % from float64's), so there the float32 run only measures, and
   that rule is held with the engines, the oracle and the wire built on
   float64 weights, and again in float32 at 4 layers of the same widths
   (float32 ~4e-6 from float64's logits).  Decode's
   attention is the composition: none of K1-K4 launched (``decode``).

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
import shutil
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
    # a ring hop of phase_context's LM (L = 16384 over sp = 2): an earlier
    # shard seen whole, and the rank's own, causal
    ("ring-hop", 1, 12, 8192, 8192, 64, torch.float32, False, True),
    ("ring-hop-diag", 1, 12, 8192, 8192, 64, torch.float32, True, True),
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
    ("ring-hop", 1, 12, 8192, 8192, 64, torch.float32, False, True),
    ("ring-hop-diag", 1, 12, 8192, 8192, 64, torch.float32, True, True),
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
            results[(kern, dtype, name)] = rec
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
                rec = results[(kern, dtype, name)]
                rec.update(library_ms=lib_ms, library_device_ms=lib_dev_ms)
                add_ratios(rec, rec.pop("ops"))
                log("kernels: timing %s %s %s" % (kern, tag,
                                                  json.dumps(rec)))
    check_lse_rule()
    check_nonfinite_scores()
    return results


#: the long-sequence fp32 stage check: B * H = 12 heads of D = 64 at these
#: lengths, causal and not, each stage of K1 -> K2/K3 held to float64
LONG_FP32_T = (8192, 16384)
LONG_FP32_HEADS = 12
LONG_FP32_TOL = 1e-4                # x max|ref|: the port's fp32 rule


def _rel(got, want):
    """max |got - want| / max |want| (float64)."""
    return float((got.double() - want).abs().max() / want.abs().max())


def phase_long_fp32():
    """K1 -> K2/K3 in fp32 at the long lengths of LONG_FP32_T, each stage
    held to a float64 computation of the same inputs, one head at a time
    (a float64 T x T matrix at T = 16384 is 2 GiB): K1's O and LSE; then,
    from K1's O and LSE in fp32 as the kernels take them, delta =
    rowsum(dO * O), P, dP and dS recomputed by plain fp32 PyTorch (no TF32);
    K2's dQ and K3's dK and dV on K1's O and LSE.  Each is max |x - x64| /
    max |x64| over the heads (LSE: max |d|, stricter than x max|LSE|).
    Fails unless every kernel output (K1's O and LSE, K2's dQ, K3's dK and
    dV) is within LONG_FP32_TOL."""
    from mxnet_tpu_torch.ops import attention as att
    tf32_was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    records, faults = [], []
    try:
        for T in LONG_FP32_T:
            for causal in (False, True):
                g = torch.Generator(device="cuda").manual_seed(SEED + 5)
                q, k, v, do = (torch.randn((1, LONG_FP32_HEADS, T, 64),
                                           generator=g, device="cuda")
                               for _ in range(4))
                scale = 64 ** -0.5
                o, lse = att.flash_attention_with_lse(q, k, v, scale, causal)
                kern = [att._flash_bwd_dq_cuda(q, k, v, o, lse, do, scale,
                                               causal)]
                kern += list(att._flash_bwd_dkv_cuda(q, k, v, o, lse, do,
                                                     scale, causal))
                names = ("O", "LSE", "delta", "P", "dP", "dS", "dQ", "dK",
                         "dV")
                err = dict.fromkeys(names, 0.0)
                peak = dict.fromkeys(names, 0.0)
                keep = att._causal_keep(T, T, "cuda") if causal else None
                for h in range(LONG_FP32_HEADS):
                    x = [t[0, h].double() for t in (q, k, v, do)]
                    s = (x[0] @ x[1].T) * scale
                    if causal:
                        s.masked_fill_(~keep, float("-inf"))
                    lse64 = torch.logsumexp(s, dim=-1)
                    p = torch.exp(s - lse64[:, None])
                    del s
                    o64 = p @ x[2]
                    dp = x[3] @ x[2].T
                    delta = (x[3] * o64).sum(-1)
                    ds = p * (dp - delta[:, None])
                    want = {"O": o64, "LSE": lse64, "delta": delta, "P": p,
                            "dP": dp, "dS": ds,
                            "dQ": (ds @ x[1]) * scale,
                            "dK": (ds.T @ x[0]) * scale, "dV": p.T @ x[3]}
                    del ds
                    # fp32 stages from K1's O and LSE, as the kernels
                    # recompute them
                    f = [t[0, h] for t in (q, k, v, do)]
                    o32, l32 = o[0, h], lse[0, h]
                    s32 = (f[0] @ f[1].T) * scale
                    if causal:
                        s32.masked_fill_(~keep, float("-inf"))
                    p32 = torch.exp(s32 - l32[:, None])
                    del s32
                    dp32 = f[3] @ f[2].T
                    d32 = (f[3] * o32).sum(-1)
                    ds32 = p32 * (dp32 - d32[:, None])
                    got = {"O": o32, "LSE": l32, "delta": d32, "P": p32,
                           "dP": dp32, "dS": ds32, "dQ": kern[0][0, h],
                           "dK": kern[1][0, h], "dV": kern[2][0, h]}
                    del p32, dp32, ds32
                    for nm in names:
                        ref = want[nm]
                        d = got[nm].double() - ref
                        if nm == "LSE":
                            err[nm] = max(err[nm], float(d.abs().max()))
                            continue
                        err[nm] = max(err[nm], float(d.abs().max()))
                        peak[nm] = max(peak[nm], float(ref.abs().max()))
                    del want, got, p, dp
                rel = {nm: (err[nm] if nm == "LSE" else err[nm] / peak[nm])
                       for nm in names}
                rec = {"T": T, "heads": LONG_FP32_HEADS, "causal": causal,
                       "rel_to_f64": rel}
                records.append(rec)
                log("long_fp32: %s" % json.dumps(rec))
                bad = {nm: rel[nm] for nm in ("O", "LSE", "dQ", "dK", "dV")
                       if not rel[nm] <= LONG_FP32_TOL}
                if bad:
                    faults.append("T = %d causal=%s: %s from float64"
                                  % (T, causal, bad))
                del q, k, v, do, o, lse, kern
                torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32_was
    if faults:
        raise RuntimeError("long_fp32: fp32 K1-K3 beyond %g x max|ref| of "
                           "float64: %s" % (LONG_FP32_TOL, faults))
    return records


def log_library_ratios(fwd, bwd):
    """K1, K2 and K3 in bf16 at the training shape against one PyTorch call
    in the same run: the forward, and the whole backward (dQ, dK and dV),
    of scaled_dot_product_attention; then K1 in fp32 at the serving shape
    against SDPA's fp32 forward, and K2 and K3 in fp32 against SDPA's fp32
    backward, as the pair that call replaces and each alone."""
    recs = [("K1", fwd[("bert-train", torch.bfloat16)], "forward"),
            ("K2", bwd[("flash_bwd_dq", torch.bfloat16, "bert-train")],
             "backward, dQ+dK+dV"),
            ("K3", bwd[("flash_bwd_dkv", torch.bfloat16, "bert-train")],
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
    dq, dkv = bwd[("flash_bwd_dq", torch.float32, "bert-train")], \
        bwd[("flash_bwd_dkv", torch.float32, "bert-train")]
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


def composition_outputs(net, tokens, types):
    """Each request's outputs (seq_out, pooled, nsp) from an in-process
    forward through the plain attention composition, 8 rows at a time,
    as host arrays."""
    from mxnet_tpu_torch.ops.attention import attention_impl_scope
    refs = []
    with torch.inference_mode(), attention_impl_scope("xla"):
        for lo in range(0, N_REQUESTS, max(BUCKETS)):
            hi = lo + max(BUCKETS)
            ref = net(torch.from_numpy(tokens[lo:hi, 0]).cuda(),
                      torch.from_numpy(types[lo:hi, 0]).cuda())
            ref = [r.float().cpu().numpy() for r in ref]
            refs += [[r[i:i + 1] for r in ref] for i in range(hi - lo)]
    return refs


def check_answers(label, answers, refs, version=1):
    """Every served answer (version, [3 outputs]) against its composition
    outputs at ``SLICE_TOL``; returns the worst |difference|."""
    worst = 0.0
    for i, ((got_version, outs), ref) in enumerate(zip(answers, refs)):
        if got_version != version or len(outs) != 3:
            raise RuntimeError("%s: request %d: version %r, %d outputs"
                               % (label, i, got_version, len(outs)))
        for o, r in zip(outs, ref):
            if o.shape != r.shape or not np.isfinite(o).all():
                raise RuntimeError("%s: request %d: output %s vs %s"
                                   % (label, i, o.shape, r.shape))
            err = float(np.abs(o - r).max())
            worst = max(worst, err)
            if not np.allclose(o, r, atol=SLICE_TOL, rtol=SLICE_TOL):
                raise RuntimeError("%s: request %d disagrees with the "
                                   "composition by %.3g" % (label, i, err))
    return worst


def phase_slice():
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon.model_zoo.bert import bert_12_768_12
    from mxnet_tpu_torch.ops import _kernels
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
    worst = check_answers("slice", answers,
                          composition_outputs(net, tokens, types))
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


# ---------------------------------------------------------------------------
# 4b. save_load: the parameter file, the loaded servable, the resumed loop
# ---------------------------------------------------------------------------

# (name, optimizer parameters) of the thirteen optimizers' on-card checks
SAVE_LOAD_OPTIMIZERS = [
    ("rmsprop", {"learning_rate": 1e-3, "wd": 1e-4, "clip_weights": 2.0}),
    ("rmsprop", {"learning_rate": 1e-3, "centered": True}),
    ("adagrad", {"learning_rate": 0.1, "wd": 1e-4}),
    ("adadelta", {"wd": 1e-4}),
    ("ftrl", {"learning_rate": 0.1, "wd": 1e-4}),
    ("lars", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}),
    ("signsgd", {"learning_rate": 1e-2, "wd": 1e-4}),
    ("signum", {"learning_rate": 1e-2, "wd": 1e-4, "wd_lh": 1e-4}),
    ("dcasgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("test", {}),
    ("ftml", {"learning_rate": 1e-2, "wd": 1e-4}),
    ("adamax", {"learning_rate": 2e-3, "wd": 1e-4}),
    ("nadam", {"learning_rate": 1e-3, "wd": 1e-4}),
    ("sgld", {"learning_rate": 1e-4}),
]
SAVE_LOAD_STEPS = 3             # the uninterrupted eager run; saved after 2


def _serve_burst(host, sv, tokens, types):
    """Deploy ``sv`` on ``host`` (warm, flip, drain the predecessor) and
    answer the requests over the wire, one request a micro-batch (bucket
    1, so that an answer does not depend on which requests arrived
    together); returns (answers, deploy s, burst s)."""
    from mxnet_tpu_torch.serve import ServeClient, ServeServer, serve_forever
    state = ServeServer(host, max_batch=1, max_delay_us=0, queue_cap=256)
    port = _free_port()
    stop, ready = threading.Event(), threading.Event()
    t0 = time.perf_counter()
    host.deploy(sv, example=[tokens[0], types[0]])
    t_deploy = time.perf_counter() - t0
    server = threading.Thread(
        target=serve_forever, name="chip-smoke-save-load",
        kwargs=dict(port=port, state=state, stop_event=stop,
                    bind="127.0.0.1", ready_event=ready))
    server.start()
    try:
        if not ready.wait(30):
            raise RuntimeError("serve_forever did not come up")
        answers, _, t_burst = run_burst(port, tokens, types)
        with ServeClient(["127.0.0.1:%d" % port], timeout=60) as cli:
            cli.stop()
    finally:
        stop.set()
        server.join(30)
    if server.is_alive():
        raise RuntimeError("serve_forever did not exit after STOP")
    return answers, t_deploy, t_burst


def save_load_serve(net, slice_answers, tmp):
    """(a) The served BERT-base's parameters written on the card with
    ``save_parameters``, loaded into a fresh block by
    ``Servable.from_block``, and served: every answer bitwise the first
    block's served the same way, the loaded parameters bitwise the
    saved ones, K1 launched 12 times a dispatched micro-batch."""
    from mxnet_tpu_torch.gluon.model_zoo.bert import bert_12_768_12
    from mxnet_tpu_torch.ops import _kernels
    from mxnet_tpu_torch.serve import BucketTable, ModelHost, Servable
    import mxnet_tpu_torch as mx
    tokens, types = make_requests()
    n_layers = len(net.encoder.transformer_cells)
    fname = os.path.join(tmp, "bert_12_768_12.params")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.save_parameters(fname)
    t_save = time.perf_counter() - t0
    nbytes = os.path.getsize(fname)
    host = ModelHost()
    first = Servable(net, name="bert_12_768_12", version=1,
                     buckets=BucketTable(BUCKETS))
    want, _, _ = _serve_burst(host, first, tokens, types)
    fresh = bert_12_768_12(use_decoder=False, dropout=0.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loaded = Servable.from_block(fresh, fname, ctx=mx.gpu(0),
                                 name="bert_12_768_12", version=2,
                                 buckets=BucketTable(BUCKETS))
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    same = [n for (n, a), (_, b) in zip(net.named_parameters(),
                                        fresh.named_parameters())
            if not torch.equal(a, b)]
    if same:
        raise RuntimeError("save_load: %d loaded parameters differ from the "
                           "saved ones, first %s" % (len(same), same[0]))
    # --- the loaded servable's main path, counted ---
    _kernels.reset_launches()
    got, t_deploy, t_burst = _serve_burst(host, loaded, tokens, types)
    launches = _kernels.launch_counts()
    served = loaded.batches
    # --- end of the counted main path ---
    expect = n_layers * (len(BUCKETS) + served)
    if launches != {"flash_fwd": expect, "flash_bwd_dq": 0,
                    "flash_bwd_dkv": 0}:
        raise RuntimeError("save_load: the loaded servable launched %s, "
                           "expected flash_fwd %d (%d layers x %d micro-"
                           "batches)" % (launches, expect, n_layers,
                                         len(BUCKETS) + served))
    unequal, worst_slice, bitwise_slice = 0, 0.0, 0
    for i, ((vg, og), (_, ow), (_, os_)) in enumerate(
            zip(got, want, slice_answers)):
        if vg != 2 or len(og) != len(ow):
            raise RuntimeError("save_load: request %d answered by version "
                               "%r with %d outputs" % (i, vg, len(og)))
        unequal += any(not np.array_equal(a, b) for a, b in zip(og, ow))
        bitwise_slice += all(np.array_equal(a, b) for a, b in zip(og, os_))
        worst_slice = max([worst_slice] + [float(np.abs(a - b).max())
                                           for a, b in zip(og, os_)])
    if unequal:
        raise RuntimeError("save_load: %d of %d answers of the loaded block "
                           "differ from the first block's" % (unequal,
                                                               len(got)))
    if worst_slice > SLICE_TOL:
        raise RuntimeError("save_load: answers %.3g from the slice's burst"
                           % worst_slice)
    rec = {"file_bytes": nbytes, "save_s": t_save, "load_s": t_load,
           "save_gb_per_s": nbytes / t_save / 1e9,
           "load_gb_per_s": nbytes / t_load / 1e9,
           "deploy_s": t_deploy, "burst_s": t_burst,
           "requests": len(got), "served_batches": served,
           "bitwise_equal_answers": len(got) - unequal,
           "bitwise_equal_to_slice_burst": bitwise_slice,
           "max_abs_diff_to_slice_burst": worst_slice,
           "launches": launches}
    log("save_load: serve %s" % json.dumps(rec))
    del first, loaded, fresh
    return launches


def _nadam_bert(gluon, initializer, bert_12_768_12):
    net = bert_12_768_12(vocab_size=VOCAB, max_length=SEQ_LEN, dropout=0.0,
                         use_classifier=False)
    net.initialize(initializer.Normal(0.02), seed=SEED)
    net.cast("bfloat16")
    trainer = gluon.Trainer(net.collect_params(), "nadam",
                            {"learning_rate": 1e-4,
                             "multi_precision": True})
    return net, trainer


def save_load_resume(tmp):
    """(b) BERT-base with the MLM decoder (bf16, batch 16, T = 512) through
    ``autograd.record()``, ``backward()`` and ``Trainer.step`` with Nadam
    (``multi_precision``): 2 steps, ``save_parameters`` +
    ``Trainer.save_states``, and the uninterrupted step 3; then a fresh
    block and Trainer loaded from both files take step 3: its loss and
    every parameter bitwise the uninterrupted step 3's; K1-K3 launched 12
    times a step (4 steps)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, initializer, nd
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.bert import bert_12_768_12
    from mxnet_tpu_torch.ops import _kernels
    ce = SoftmaxCrossEntropyLoss()
    host = train_batch_host(TRAIN_BATCH)
    tok, seg, lab = (nd.array(a, ctx=mx.gpu(0)) for a in host)

    def step(net, trainer):
        with autograd.record():
            loss = ce(net(tok, seg)[-1].astype("float32"), lab).mean()
        loss.backward()
        trainer.step(1)
        return float(loss.asscalar())

    def weights(net):
        return [(n, t.detach().clone()) for n, t in net.named_parameters()]

    # --- the resumed eager loop's main path, counted ---
    torch.cuda.synchronize()
    _kernels.reset_launches()
    net, trainer = _nadam_bert(gluon, initializer, bert_12_768_12)
    n_layers = len(net.encoder.transformer_cells)
    want = [step(net, trainer) for _ in range(SAVE_LOAD_STEPS - 1)]
    pfile = os.path.join(tmp, "bert_mlm.params")
    sfile = os.path.join(tmp, "bert_mlm.states")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.save_parameters(pfile)
    trainer.save_states(sfile)
    t_save = time.perf_counter() - t0
    want.append(step(net, trainer))             # the uninterrupted step 3
    want_w = weights(net)
    got = want[:-1]
    del net, trainer
    torch.cuda.empty_cache()
    net = bert_12_768_12(vocab_size=VOCAB, max_length=SEQ_LEN, dropout=0.0,
                         use_classifier=False)
    net.cast("bfloat16")
    t0 = time.perf_counter()
    net.load_parameters(pfile, ctx=mx.gpu(0))
    trainer = gluon.Trainer(net.collect_params(), "nadam",
                            {"learning_rate": 1e-4,
                             "multi_precision": True})
    trainer.load_states(sfile)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    got.append(step(net, trainer))
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    # --- end of the counted main path ---
    launches = {k: counts[k] for k in ("flash_fwd", "flash_bwd_dq",
                                       "flash_bwd_dkv")}
    got_w = weights(net)
    differ = [n for (n, a), (_, b) in zip(got_w, want_w)
              if not torch.equal(a, b)]
    rec = {"steps": SAVE_LOAD_STEPS, "losses": want, "resumed_losses": got,
           "params_bytes": os.path.getsize(pfile),
           "states_bytes": os.path.getsize(sfile), "save_s": t_save,
           "load_s": t_load, "params_differing": len(differ),
           "launches": launches}
    log("save_load: resume %s" % json.dumps(rec))
    if got != want or differ:
        raise RuntimeError("save_load: the resumed step 3 is not the "
                           "uninterrupted one: losses %s vs %s, %d "
                           "parameters differ (first %s)"
                           % (got, want, len(differ),
                              differ[0] if differ else None))
    n_steps = SAVE_LOAD_STEPS + 1
    if launches != {k: n_layers * n_steps for k in launches}:
        raise RuntimeError("save_load: launched %s, expected %d of each "
                           "kernel (%d layers x %d steps)"
                           % (launches, n_layers * n_steps, n_layers,
                              n_steps))
    del net, trainer
    return launches


def phase_save_load(net, slice_answers):
    """Parameter files on the card (:func:`save_load_serve`,
    :func:`save_load_resume`) and (c) one step of each of the thirteen
    newer optimizers (:data:`SAVE_LOAD_OPTIMIZERS`, RMSProp plain and
    centred) on the card against the CPU (:func:`eager_optimizers`);
    returns K1-K3's launches on (a) and (b)."""
    import tempfile
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_save_load_")
    try:
        launches = dict(save_load_serve(net, slice_answers, tmp))
        gc.collect()
        torch.cuda.empty_cache()
        for k, n in save_load_resume(tmp).items():
            launches[k] = launches.get(k, 0) + n
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    # the thirteen have no fused form: one step a parameter
    eager_optimizers(SAVE_LOAD_OPTIMIZERS, aggregates=(True,),
                     tag="save_load")
    log("save_load: phase %.1f s, launches %s"
        % (time.perf_counter() - t0, json.dumps(launches)))
    return launches


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
# 5c. serve_tier: two BERT-base replicas behind the router and the fleet
# ---------------------------------------------------------------------------

# the flat demo LM at the decode phase's bench geometry, beside BERT-base
TIER_LM = dict(dim=8, heads=1, layers=6, slots=8, max_tokens=48,
               prompt_buckets=(4, 8))
TIER_TICK_S = 0.005             # the replicas' decode pump tick (a drain
#                                 must land mid-generation)
TIER_DRAIN_S = 30.0             # the DRAIN's deadline
TIER_READY_S = 180              # seconds a replica process may take to warm
TIER_LONG = 8                   # long generations in flight at the DRAIN
TIER_PACE_S = 0.1               # a client's pause between the failover
#                                 burst's requests (the kill lands mid-burst)
_PROM_LINE = re.compile(r'^([A-Za-z_:][\w:]*)(?:\{(.*)\})? (\S+)$')
_PROM_LABEL = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text):
    """{(name, ((label, value), ...)): value} of a Prometheus text
    exposition; raises on a line that is not a comment or a sample."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _PROM_LINE.match(line)
        if m is None:
            raise RuntimeError("serve_tier: METRICS line does not parse: %r"
                               % line)
        labels = tuple(sorted(_PROM_LABEL.findall(m.group(2) or "")))
        out[(m.group(1), labels)] = float(m.group(3))
    return out


def serve_replica_worker(argv):
    """One replica of ``phase_serve_tier``: BERT-base (``phase_slice``'s
    seeded weights, fp32, ``BUCKETS``) beside the flat demo LM under a
    ``ModelHost`` with an HBM budget, behind ``serve_forever`` on
    ``127.0.0.1:<port>``.  After its warm it checks the census and the
    packer (the ``serve`` bytes, ``kv_cache``, the footprint, a refused
    resnet18) and writes them to ``<out>.rec``; once the port is free (a
    restarted replica waits for its predecessor's exit) and, when a third
    argument names a file, once that file exists, it serves, and
    ``serve_forever`` writes the bound port to ``<out>.ready``.  Its
    METRICS carry its launch counts; when ``serve_forever`` returns it
    writes ``<out>.exit``.

    ``--port-base B DIR`` is the launched form (``phase_launch_tier``,
    under the launcher's ``--serve-port-base B``): the replica binds
    ``B + MX_PROCESS_ID``, writes ``DIR/replica<rank>.*``, records where
    K1's library came from (the persistent compile cache or ``nvcc``) and
    skips the packer's refusal, which ``phase_serve_tier`` holds."""
    if not torch.cuda.is_available():
        raise SystemExit("serve-replica-worker: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    launched = argv[0] == "--port-base"
    if launched:
        rank = int(os.environ.get("MX_PROCESS_ID", "0"))
        port = int(argv[1]) + rank
        out = os.path.join(argv[2], "replica%d" % rank)
        go = None
    else:
        port, out = int(argv[0]), argv[1]
        go = argv[2] if len(argv) > 2 else None
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    from mxnet_tpu_torch import initializer, programs
    from mxnet_tpu_torch.gluon.model_zoo.bert import bert_12_768_12
    from mxnet_tpu_torch.ops import _kernels
    from mxnet_tpu_torch.serve import (BucketTable, BudgetExceeded,
                                       ModelHost, Servable, ServeServer,
                                       serve_forever)
    from mxnet_tpu_torch.serve.decode import (DecodeBatcher, DecodeConfig,
                                              DecodeServable, demo_lm_params)
    from mxnet_tpu_torch.serve.demo import demo_conv_block, demo_conv_example
    from mxnet_tpu_torch.telemetry import registry
    t0 = time.perf_counter()
    net = bert_12_768_12(use_decoder=False, dropout=0.0)
    net.initialize(initializer.Normal(0.02), seed=SEED)
    tokens, types = make_requests()
    # --- this replica's counted path starts at its deploy ---
    _kernels.reset_launches()
    host = ModelHost()
    sv = Servable(net, name="bert_12_768_12", version=1,
                  buckets=BucketTable(BUCKETS))
    t_deploy = time.perf_counter()
    host.deploy(sv, example=[tokens[0], types[0]])
    t_deploy = time.perf_counter() - t_deploy
    cfg = DecodeConfig(**TIER_LM)
    dsv = DecodeServable(config=cfg, params=demo_lm_params(cfg, dev))
    eng = DecodeBatcher(dsv, on_tick=lambda: time.sleep(TIER_TICK_S))

    class SmokeServer(ServeServer):
        def metrics_text(self, fmt="prometheus"):
            for k, v in _kernels.launch_counts().items():
                registry.gauge("smoke.launches", labels={"kernel": k}).set(v)
            registry.gauge("smoke.served").set(sv.batches)
            return super().metrics_text(fmt)

    state = SmokeServer(host, decode=eng, max_batch=max(BUCKETS),
                        max_delay_us=2000, queue_cap=256)
    # the census and the packer
    census = programs.buffer_census()
    table = programs.program_table()
    temps = {b: table["serve.bert_12_768_12.b%d" % b]["temp_bytes_peak"]
             for b in BUCKETS}
    compile_s = {b: table["serve.bert_12_768_12.b%d" % b]
                 ["compile_seconds"]["total"] for b in BUCKETS}
    bert_bytes = sum(int(p.nbytes) for p in net.parameters())
    lm_bytes = sum(int(t.nbytes) for t in dsv.params.values())
    f_bert, f_lm = sv.footprint_bytes(), dsv.footprint_bytes()
    checks = {
        "serve_bytes": (census["serve"]["bytes"], bert_bytes + lm_bytes),
        "kv_cache_bytes": (census["kv_cache"]["bytes"],
                           dsv.kv_state_bytes()),
        "bert_footprint": (f_bert, sv.live_bytes() + max(temps.values())),
        "lm_footprint": (f_lm, dsv.live_bytes() + programs.
                         program_memory_bytes("serve.decode.")
                         ["temp_bytes_peak"]),
    }
    bad = {k: v for k, v in checks.items() if v[0] != v[1]}
    if bad or not all(t and t > 0 for t in temps.values()):
        raise RuntimeError("serve-replica: census %s, bucket temp bytes %s"
                           % (bad, temps))
    owners = programs.CENSUS_OWNERS
    refused, t_refuse = "", None
    if not launched:
        host.hbm_budget = f_bert + f_lm + (1 << 20)
        models0 = host.models()
        before = {k: census[k]["bytes"] for k in owners}
        t_refuse = time.perf_counter()
        try:
            state.add_model(Servable(demo_conv_block(dev), name="demo-conv",
                                     buckets=BucketTable(BUCKETS)),
                            example=demo_conv_example())
        except BudgetExceeded as e:
            refused = str(e)
        else:
            raise RuntimeError("serve-replica: resnet18 was admitted past "
                               "the budget")
        t_refuse = time.perf_counter() - t_refuse
        gc.collect()
        after = programs.buffer_census()
        if host.models() != models0 or "demo-conv" in host.engines or any(
                after[k]["bytes"] != before[k] for k in owners):
            raise RuntimeError("serve-replica: the refused model left %s / "
                               "%s" % (host.models(),
                                       {k: (before[k], after[k]["bytes"])
                                        for k in owners}))
    from mxnet_tpu_torch import compile_cache
    rec = {"port": port, "pid": os.getpid(),
           "start_wall": process_start_wall(),
           "k1_from_cache": _kernels.FLASH_FWD.from_cache,
           "k1_nvcc_s": _kernels.FLASH_FWD.build_seconds,
           "compile_cache": compile_cache.stats(),
           "b1_program": {k: table["serve.bert_12_768_12.b1"][k]
                          for k in ("compiles", "cache_hits",
                                    "deserialize_seconds")},
           "build_and_warm_s": time.perf_counter() - t0,
           "deploy_warm_s": t_deploy, "bert_warm_s": sv.warm_seconds,
           "census": {k: census[k]["bytes"] for k in owners + ("other",)},
           "checks": checks, "bucket_temp_bytes": temps,
           "bucket_compile_s": compile_s, "hbm_budget": host.hbm_budget,
           "refused_s": t_refuse, "refused": refused[:160]}
    with open(out + ".rec", "w") as f:
        json.dump(rec, f)
    t_free = time.perf_counter()
    while go is not None and not os.path.exists(go):
        if time.perf_counter() - t_free > TIER_READY_S:
            raise RuntimeError("serve-replica: %s never appeared" % go)
        time.sleep(0.02)
    while True:
        probe = socket.socket()
        probe.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            probe.bind(("127.0.0.1", port))
            break
        except OSError:
            if time.perf_counter() - t_free > TIER_READY_S:
                raise
            time.sleep(0.02)
        finally:
            probe.close()
    serve_forever(port=port, state=state, bind="127.0.0.1",
                  ready_file=out + ".ready")
    with open(out + ".exit", "w") as f:
        json.dump({"launches": _kernels.launch_counts(),
                   "served": sv.batches, "draining": state.draining}, f)
    sys.stdout.flush()
    os._exit(0)


def _tier_spawn(port, out, go=None):
    root = os.path.dirname(os.path.abspath(__file__))
    log_f = open(out + ".log", "w")
    return subprocess.Popen(
        [sys.executable, os.path.join(root, "chip_smoke.py"),
         "--serve-replica-worker", str(port), out] + ([go] if go else []),
        cwd=root, stdout=log_f, stderr=subprocess.STDOUT)


def _tier_wait_file(path, proc, what, timeout=TIER_READY_S):
    """Wait until ``path`` holds something; raise with the process's log
    if it dies or the wait runs out."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        if os.path.exists(path) and os.path.getsize(path):
            return time.perf_counter() - t0
        if proc.poll() is not None:
            break
        time.sleep(0.05)
    tail = ""
    for log_path in (path.rsplit(".", 1)[0] + ".log", path + ".log"):
        if os.path.exists(log_path):
            tail = open(log_path).read()[-3000:]
    raise RuntimeError("serve_tier: %s never became ready (exit %r):\n%s"
                       % (what, proc.poll(), tail))


def _tier_metrics(addr):
    """One replica's METRICS: (the registry snapshot as a dict, the
    Prometheus text)."""
    from mxnet_tpu_torch.serve import ServeClient
    with ServeClient([addr], timeout=30) as cli:
        return (json.loads(cli.metrics(idx=0, fmt="json")),
                cli.metrics(idx=0))


def _tier_value(snap, key, default=0.0):
    ent = snap.get(key)
    return default if ent is None else float(ent.get("value", default))


def _tier_launches(snap):
    return {k[len("smoke.launches{kernel="):-1]: int(v["value"])
            for k, v in snap.items() if k.startswith("smoke.launches{")}


def _tier_burst(port, tokens, types, pace=0.0, on_first_round=None):
    """``run_burst`` through the router with a pause of ``pace`` seconds
    between a client's requests; ``on_first_round()`` runs once every
    client has its first answer.  Returns (answers, latencies, wall,
    each client's id)."""
    from mxnet_tpu_torch.serve import ServeClient
    answers, latency = [None] * N_REQUESTS, [None] * N_REQUESTS
    starts = [None] * N_REQUESTS
    cids, errors = [None] * N_CLIENTS, []
    barrier = threading.Barrier(N_CLIENTS + 1)
    first = threading.Barrier(N_CLIENTS + 1) if on_first_round else None

    def client(c):
        try:
            with ServeClient(["127.0.0.1:%d" % port], timeout=120) as cli:
                cids[c] = cli._client_id
                cli.health()
                barrier.wait(60)
                for n, i in enumerate(range(c, N_REQUESTS, N_CLIENTS)):
                    if n and pace:
                        time.sleep(pace)
                    starts[i] = time.perf_counter()
                    answers[i] = cli.predict([tokens[i], types[i]])
                    latency[i] = time.perf_counter() - starts[i]
                    if n == 0 and first is not None:
                        first.wait(60)
        except Exception as e:    # reported and failed below
            errors.append("client %d: %r" % (c, e))

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(N_CLIENTS)]
    for t in threads:
        t.start()
    barrier.wait(60)
    t0 = time.perf_counter()
    if first is not None:
        first.wait(60)
        on_first_round()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    if errors or any(a is None for a in answers):
        raise RuntimeError("serve_tier: PREDICT failed: %s" % errors)
    return answers, latency, wall, cids, starts


def phase_serve_tier(refs, smi):
    """The serving tier on the card (after ``bf16``): two replica
    processes (:func:`serve_replica_worker`), a ``FleetCollector``
    scraping them over METRICS and serving FLEET, a ``ServeRouter`` fed by
    it through ``serve_router_forever``.  Holds routed PREDICT (every
    answer against ``refs``, the slice's composition, each client on one
    replica, K1 exactly 12 x (2 x 4 warm + served micro-batches) over the
    replicas, no K2-K4), routed GENERATE (the exact rule), METRICS and the
    registry, the census and the packer (in each replica), a DRAIN, a
    failover after SIGKILL, and the two command lines.  Returns the
    launches of the routed burst, summed over the replicas."""
    import signal
    import tempfile
    from mxnet_tpu_torch import fleet
    from mxnet_tpu_torch.serve import ServeClient
    from mxnet_tpu_torch.serve.decode import (DecodeConfig, demo_lm_params,
                                              reference_generate)
    from mxnet_tpu_torch.serve.demo import demo_block, demo_requests
    from mxnet_tpu_torch.serve.router import ServeRouter, serve_router_forever
    from mxnet_tpu_torch.telemetry import registry
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-tier-")
    root = os.path.dirname(os.path.abspath(__file__))
    procs, stops, threads = [], [], []
    rec = {"card": smi}
    tokens, types = make_requests()
    try:
        # the command lines come up while the replicas build
        cli_ready = os.path.join(tmp, "cli.port")
        t_cli = time.perf_counter()
        cli_rep = subprocess.Popen(
            [sys.executable, "-m", "mxnet_tpu_torch.serve", "--demo",
             "--decode", "--port", "0", "--ready-file", cli_ready],
            cwd=root, stdout=open(cli_ready + ".log", "w"),
            stderr=subprocess.STDOUT)
        procs.append(cli_rep)
        pa, pb = _free_port(), _free_port()
        addr_a, addr_b = "127.0.0.1:%d" % pa, "127.0.0.1:%d" % pb
        out_a, out_b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        t_spawn = time.perf_counter()
        proc_a, proc_b = _tier_spawn(pa, out_a), _tier_spawn(pb, out_b)
        procs += [proc_a, proc_b]
        ready = {}
        for name, out, proc in (("a", out_a, proc_a), ("b", out_b, proc_b)):
            _tier_wait_file(out + ".ready", proc, "replica " + name)
            ready[name] = json.load(open(out + ".rec"))
        rec["replicas_ready_s"] = time.perf_counter() - t_spawn
        rec["replicas"] = ready
        for name, r in ready.items():
            log("serve_tier: replica %s deploy+warm %.3f s (bucket temp "
                "bytes %s, first-dispatch s %s), process ready in %.1f s; "
                "census %s; resnet18 refused under a budget of %d bytes "
                "(%s)" % (name, r["deploy_warm_s"],
                          json.dumps(r["bucket_temp_bytes"]),
                          json.dumps(r["bucket_compile_s"]),
                          r["build_and_warm_s"], json.dumps(r["census"]),
                          r["hbm_budget"], r["refused"][:80]))
        _tier_wait_file(cli_ready, cli_rep, "the CLI replica")
        rec["cli_ready_s"] = time.perf_counter() - t_cli
        cli_rt_ready = os.path.join(tmp, "clirt.port")
        cli_rt = subprocess.Popen(
            [sys.executable, "-m", "mxnet_tpu_torch.serve.router", "--port",
             "0", "--replicas", "127.0.0.1:%s" % open(cli_ready).read(),
             "--ready-file", cli_rt_ready],
            cwd=root, stdout=open(cli_rt_ready + ".log", "w"),
            stderr=subprocess.STDOUT)
        procs.append(cli_rt)

        # the fleet collector and the router
        coll = fleet.FleetCollector(
            [fleet.FleetMember("serve", 0, addr=addr_a),
             fleet.FleetMember("serve", 1, addr=addr_b)],
            interval=0.25).start(port=0)
        faddr = "127.0.0.1:%d" % coll.bound_ports["wire"]
        rt = ServeRouter(replicas=[addr_a, addr_b], fleet_addr=faddr,
                         refresh=0.2)
        rport = _free_port()
        rstop = threading.Event()
        rthread = threading.Thread(
            target=serve_router_forever, daemon=True,
            kwargs=dict(port=rport, router=rt, stop_event=rstop))
        rthread.start()
        stops.append(rstop)
        threads.append(rthread)
        deadline = time.perf_counter() + 30
        while True:
            try:
                socket.create_connection(("127.0.0.1", rport), 1).close()
                break
            except OSError:
                if time.perf_counter() > deadline:
                    raise RuntimeError("serve_tier: the router never bound")
                time.sleep(0.02)

        # 1. routed PREDICT
        m0 = {a: _tier_metrics(a)[0] for a in (addr_a, addr_b)}
        answers, latency, wall, cids, _ = _tier_burst(rport, tokens, types)
        worst = check_answers("serve_tier routed", answers, refs)
        m1 = {}
        for a in (addr_a, addr_b):
            m1[a] = _tier_metrics(a)
        req = {a: _tier_value(m1[a][0], "serve.requests")
               - _tier_value(m0[a], "serve.requests")
               for a in (addr_a, addr_b)}
        pins = {cid: rt._pins.get(cid) for cid in cids}
        per_replica = {a: sum(1 for p in pins.values() if p == a)
                       for a in (addr_a, addr_b)}
        per = N_REQUESTS // N_CLIENTS
        sessions = rt.health()["sessions"]
        if any(p is None for p in pins.values()) \
                or any(req[a] != per * per_replica[a] for a in req) \
                or min(per_replica.values()) < 1 or sessions < N_CLIENTS:
            raise RuntimeError("serve_tier: sessions %s (the router holds "
                               "%d), requests by replica %s"
                               % (per_replica, sessions, req))
        launches = {}
        served = 0
        for a in (addr_a, addr_b):
            for k, v in _tier_launches(m1[a][0]).items():
                launches[k] = launches.get(k, 0) + v
            served += int(_tier_value(m1[a][0], "smoke.served"))
        want = 12 * (2 * len(BUCKETS) + served)
        if launches.get("flash_fwd") != want or any(
                v for k, v in launches.items() if k != "flash_fwd"):
            raise RuntimeError("serve_tier: the replicas launched %s, "
                               "expected flash_fwd 12 x (2 x %d + %d) = %d "
                               "and nothing else" % (launches, len(BUCKETS),
                                                     served, want))
        lat = np.array(latency) * 1e3
        rec["routed"] = {"requests_per_s": N_REQUESTS / wall,
                         "p50_ms": float(np.percentile(lat, 50)),
                         "p99_ms": float(np.percentile(lat, 99)),
                         "served_batches": served,
                         "sessions_by_replica": per_replica,
                         "requests_by_replica": req,
                         "max_abs_err_vs_composition": worst,
                         "launches": launches}
        log("serve_tier: routed burst %s" % json.dumps(rec["routed"]))

        # 3. METRICS and the registry
        for a in (addr_a, addr_b):
            snap0, (snap, text) = m0[a], m1[a]
            prom = parse_prometheus(text)
            for b in BUCKETS:
                lbl = (("program", "serve.bert_12_768_12.b%d" % b),)
                if prom.get(("mx_program_compile_seconds_count", lbl), 0) \
                        < 1 or prom.get(("mx_program_temp_bytes", lbl),
                                        0) <= 0:
                    raise RuntimeError("serve_tier: %s METRICS lacks bucket "
                                       "%d's program rows" % (a, b))
            if prom.get(("mx_serve_active_version",
                         (("model", "bert_12_768_12"),))) != 1.0:
                raise RuntimeError("serve_tier: %s has no "
                                   "serve.active_version" % a)
            grew = {k: (_tier_value(snap0, k), v["value"])
                    for k, v in snap.items()
                    if k.startswith("program_retraces{")
                    and v["value"] != _tier_value(snap0, k)}
            if grew:
                raise RuntimeError("serve_tier: retraces grew over the burst "
                                   "%s" % grew)
        merged = coll.scrape_once()
        direct = {a: _tier_metrics(a)[0] for a in (addr_a, addr_b)}
        for name in ("serve.requests", "serve.batches", "serve.rows",
                     "serve.decode.tokens"):
            total = merged["counters"].get(name, {}).get("total")
            want_total = sum(_tier_value(direct[a], name) for a in direct)
            if total != want_total:
                raise RuntimeError("serve_tier: FLEET %s = %r, the replicas "
                                   "sum to %r" % (name, total, want_total))
        snap = fleet.fetch_fleet(faddr)
        if snap.get("schema") != fleet.SCHEMA or sorted(
                fleet.replica_signals(snap)) != sorted((addr_a, addr_b)):
            raise RuntimeError("serve_tier: FLEET snapshot %s" % snap.keys())

        # 2. GENERATE through the router, by the exact rule
        cfg = DecodeConfig(**TIER_LM)
        params = demo_lm_params(cfg, torch.device("cuda", 0))
        p64 = {k: v.double() for k, v in params.items()}
        prompts, news = decode_workload(cfg, 48, 2, SEED)
        oracle = {}

        def want_tokens(i):
            if i not in oracle:
                oracle[i] = reference_generate(prompts[i], news[i],
                                               params=params, config=cfg)
            return oracle[i]
        with ServeClient(["127.0.0.1:%d" % rport], timeout=120) as cli:
            gen = [cli.generate(prompts[i], max_tokens=news[i])[1]
                   for i in range(4)]
        decode_compare("serve_tier routed", gen,
                       [want_tokens(i) for i in range(4)], prompts[:4],
                       p64, cfg)

        # 5. DRAIN replica A
        pinned_a = None
        for _ in range(8):
            c = ServeClient(["127.0.0.1:%d" % rport], timeout=120)
            c.generate(prompts[3], max_tokens=news[3])
            if rt._pins.get(c._client_id) == addr_a:
                pinned_a = c
                break
            c.close()
        if pinned_a is None:
            raise RuntimeError("serve_tier: no session pinned to A")
        long_out, errors = {}, []

        def long_gen(i):
            try:
                with ServeClient([addr_a], timeout=120) as c:
                    long_out[i] = c.generate(prompts[i], max_tokens=48)[1]
            except Exception as e:      # noqa: BLE001 — raised below
                errors.append(repr(e))
        longs = [i for i in range(len(prompts)) if news[i] == 48][:TIER_LONG]
        gthreads = [threading.Thread(target=long_gen, args=(i,))
                    for i in longs]
        with ServeClient([addr_a], timeout=30) as probe:
            done0 = probe.decode_stats(idx=0)["sequences"]
            for t in gthreads:
                t.start()
            # every long generation admitted before the DRAIN closes the
            # door (a later one would be refused)
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 30:
                st = probe.decode_stats(idx=0)
                if st["active"] + st["queued"] + st["sequences"] - done0 \
                        >= len(longs):
                    break
                time.sleep(0.002)
            t_drain = time.perf_counter()
            status = probe.drain(timeout=TIER_DRAIN_S, idx=0)
        inflight = status.get("active", 0) + status.get("queued", 0)
        if inflight < 1:
            raise RuntimeError("serve_tier: the DRAIN found nothing in "
                               "flight: %s" % status)
        # A's successor builds meanwhile; it binds A's port once A is gone
        # and the router has seen A dead (the go file)
        t_restart = time.perf_counter()
        go_a2 = out_a + "2.go"
        proc_a2 = _tier_spawn(pa, out_a + "2", go=go_a2)
        procs.append(proc_a2)
        sp0 = registry.value("router.spills")
        moved = pinned_a.generate(prompts[5], max_tokens=news[5])[1]
        fresh = ServeClient(["127.0.0.1:%d" % rport], timeout=120)
        fresh_out = fresh.generate(prompts[6], max_tokens=news[6])[1]
        new_pins = (rt._pins.get(pinned_a._client_id),
                    rt._pins.get(fresh._client_id))
        state_after = rt._replicas.get(addr_a)
        pinned_a.close()
        fresh.close()
        for t in gthreads:
            t.join(120)
        if errors or len(long_out) != len(longs):
            raise RuntimeError("serve_tier: in-flight generations on the "
                               "drained replica failed: %s" % errors[:3])
        decode_compare("serve_tier drained", [long_out[i] for i in longs],
                       [reference_generate(prompts[i], 48, params=params,
                                           config=cfg) for i in longs],
                       [prompts[i] for i in longs], p64, cfg)
        decode_compare("serve_tier moved", [moved, fresh_out],
                       [want_tokens(5), want_tokens(6)],
                       [prompts[5], prompts[6]], p64, cfg)
        code_a = proc_a.wait(timeout=TIER_DRAIN_S)
        drain_s = time.perf_counter() - t_drain
        if code_a != 0 or drain_s > TIER_DRAIN_S:
            raise RuntimeError("serve_tier: the drained replica exited %r "
                               "after %.1f s" % (code_a, drain_s))
        exit_a = json.load(open(out_a + ".exit"))
        if new_pins != (addr_b, addr_b) or state_after != "draining" or \
                registry.value("router.spills") <= sp0:
            raise RuntimeError("serve_tier: after the DRAIN the sessions "
                               "went to %s, A is %r" % (new_pins,
                                                        state_after))
        # the fan-out of a SWAP reaches every member: A's death shows
        with ServeClient(["127.0.0.1:%d" % rport], timeout=60) as cli:
            try:
                cli.swap("/nonexistent/model")
                raise RuntimeError("serve_tier: a SWAP without a loader "
                                   "flipped")
            except Exception as e:      # noqa: BLE001 — checked here
                swap_refusal = str(e)
        if "swap failed" not in swap_refusal or \
                rt._replicas.get(addr_a) != "dead":
            raise RuntimeError("serve_tier: SWAP said %r, A is %r"
                               % (swap_refusal, rt._replicas.get(addr_a)))
        open(go_a2, "w").close()
        rec["drain"] = {"in_flight_at_drain": inflight,
                        "status": status, "exit_s": drain_s,
                        "generations": len(longs), "exit": exit_a,
                        "swap_refusal": swap_refusal[:120]}
        log("serve_tier: drain %s" % json.dumps(rec["drain"]))

        # 6. failover: A back on its port, then B killed mid-burst
        _tier_wait_file(out_a + "2.ready", proc_a2, "replica a restarted")
        t0 = time.perf_counter()
        while rt._replicas.get(addr_a) != "up":
            if time.perf_counter() - t0 > 10:
                raise RuntimeError("serve_tier: the router's probe never "
                                   "took A back")
            time.sleep(0.02)
        revive_s = time.perf_counter() - t0
        restart_s = time.perf_counter() - t_restart
        f0 = registry.value("router.failovers")
        u0 = registry.value("router.sessions_unpinned")
        killed = {}

        def kill_b():
            killed["pins"] = dict(rt._pins)
            killed["t"] = time.perf_counter()
            os.kill(proc_b.pid, signal.SIGKILL)
        answers2, latency2, _wall2, cids2, starts2 = _tier_burst(
            rport, tokens, types, pace=TIER_PACE_S, on_first_round=kill_b)
        worst2 = check_answers("serve_tier failover", answers2, refs)
        proc_b.wait(30)
        failovers = registry.value("router.failovers") - f0
        unpinned = registry.value("router.sessions_unpinned") - u0
        # the failover's cost: the first request after the kill of each
        # session that was pinned to B
        on_b = {c for c, cid in enumerate(cids2)
                if killed["pins"].get(cid) == addr_b}
        across = [latency2[i] for i in range(N_REQUESTS)
                  if i % N_CLIENTS in on_b and starts2[i] > killed["t"]
                  and i // N_CLIENTS == 1]
        if failovers < 1 or unpinned < 1 or not on_b or \
                rt._replicas.get(addr_b) != "dead":
            raise RuntimeError("serve_tier: failovers %d, unpinned %d, B's "
                               "sessions %d, B is %r"
                               % (failovers, unpinned, len(on_b),
                                  rt._replicas.get(addr_b)))
        snap_a2 = _tier_metrics(addr_a)[0]
        launches_a2 = _tier_launches(snap_a2)
        served_a2 = int(_tier_value(snap_a2, "smoke.served"))
        if launches_a2.get("flash_fwd") != 12 * (len(BUCKETS) + served_a2):
            raise RuntimeError("serve_tier: the restarted replica launched "
                               "%s for %d served batches"
                               % (launches_a2, served_a2))
        rec["failover"] = {"restart_ready_s": restart_s,
                           "probe_revive_s": revive_s,
                           "failovers": failovers,
                           "sessions_unpinned": unpinned,
                           "burst_after_kill_s":
                               time.perf_counter() - killed["t"],
                           "b_sessions_at_kill": len(on_b),
                           "failover_request_ms":
                               sorted(x * 1e3 for x in across),
                           "other_request_p50_ms": float(np.percentile(
                               [latency2[i] * 1e3 for i in range(N_REQUESTS)
                                if i % N_CLIENTS not in on_b], 50)),
                           "max_abs_err_vs_composition": worst2,
                           "a2_launches": launches_a2}
        log("serve_tier: failover %s" % json.dumps(rec["failover"]))
        with ServeClient(["127.0.0.1:%d" % rport], timeout=30) as cli:
            cli.stop()
        if proc_a2.wait(timeout=30) != 0:
            raise RuntimeError("serve_tier: the restarted replica did not "
                               "exit 0 on STOP")
        rthread.join(30)

        # 7. the command lines
        _tier_wait_file(cli_rt_ready, cli_rt, "the CLI router")
        x = demo_requests(1, rows=2, seed=SEED)[0][0]
        dcfg = DecodeConfig()
        dparams = demo_lm_params(dcfg, torch.device("cuda", 0))
        with torch.no_grad():
            mlp = demo_block()
            mlp_want = mlp(torch.from_numpy(x).cuda()).cpu().numpy()
        with ServeClient(["127.0.0.1:%s" % open(cli_rt_ready).read()],
                         timeout=60) as cli:
            version, mlp_out = cli.predict([x])
            _v, toks = cli.generate([3, 1, 4], max_tokens=8)
            cli.stop()
        decode_compare("serve_tier CLI", [toks], [reference_generate(
            [3, 1, 4], 8, params=dparams, config=dcfg)], [[3, 1, 4]],
            {k: v.double() for k, v in dparams.items()}, dcfg)
        if version != 1 or not np.allclose(mlp_out[0], mlp_want,
                                           rtol=1e-5, atol=1e-6):
            raise RuntimeError("serve_tier: the CLI replica answered %r"
                               % (mlp_out,))
        codes = (cli_rt.wait(30), cli_rep.wait(30))
        if codes != (0, 0):
            raise RuntimeError("serve_tier: the CLI router and replica "
                               "exited %s" % (codes,))
        rec["cli"] = {"replica_ready_s": rec.pop("cli_ready_s"),
                      "mlp_max_abs_err": float(np.abs(mlp_out[0] -
                                                      mlp_want).max())}
    finally:
        for ev in stops:
            ev.set()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
        for t in threads:
            t.join(10)
        try:
            coll.stop()
        except NameError:
            pass
        shutil.rmtree(tmp, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    log("serve_tier: %s" % json.dumps({k: rec[k] for k in
                                       ("replicas_ready_s", "cli",
                                        "phase_s", "card")}))
    return launches


# ---------------------------------------------------------------------------
# 5d. launch_tier: the program contracts on the card, then BERT-base
# replicas started, routed and autoscaled by the launcher, warm from the
# persistent compile cache
# ---------------------------------------------------------------------------

#: MX_FLEET_SLO_P99_MS of the launched tier: under the server-side p99
#: (queue_wait + serve_dispatch) of LAUNCH_BURST_CLIENTS clients over two
#: BERT-base replicas, above an idle fleet's (no samples: 0)
LAUNCH_SLO_P99_MS = 40.0
LAUNCH_FLEET = {"MX_FLEET_INTERVAL": "0.25", "MX_FLEET_WINDOW": "4",
                "MX_AUTOSCALE_HOLD": "3", "MX_AUTOSCALE_COOLDOWN": "10",
                "MX_AUTOSCALE_UP_BURN": "1.0",
                "MX_AUTOSCALE_DOWN_BURN": "0.5"}
LAUNCH_BURST_CLIENTS = 16       # the sustained burst's concurrent clients
LAUNCH_WAIT_S = 90              # the longest wait on one log line


class _LaunchLog:
    """The launcher's output (its supervisor's lines and its processes'),
    read as it grows."""

    def __init__(self, path, proc):
        self.path, self.proc = path, proc

    def text(self):
        with open(self.path, errors="replace") as f:
            return f.read()

    def wait(self, pattern, timeout=LAUNCH_WAIT_S):
        """The first match of ``pattern`` and the wall time it was seen;
        raises with the log's tail if the launcher exits or time runs
        out."""
        rx = re.compile(pattern)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < timeout:
            m = rx.search(self.text())
            if m:
                return m, time.time()
            if self.proc.poll() is not None:
                break
            time.sleep(0.02)
        raise RuntimeError("launch_tier: %r never appeared (launcher exit "
                           "%r):\n%s" % (pattern, self.proc.poll(),
                                         self.text()[-4000:]))

    def rounds(self):
        """Every autoscale round the supervisor logged: (round, burn)."""
        return [(int(r), float(b)) for r, b in re.findall(
            r"autoscale: round (\d+) burn (\S+)", self.text())]


def _free_port_block(n):
    """A port p with p .. p + n - 1 all free (the launcher's replicas bind
    base + rank)."""
    while True:
        base = _free_port()
        free = True
        for p in range(base, base + n):
            s = socket.socket()
            try:
                s.bind(("127.0.0.1", p))
            except OSError:
                free = False
            finally:
                s.close()
        if free:
            return base


def _router_states(rport):
    from mxnet_tpu_torch.serve import ServeClient
    with ServeClient(["127.0.0.1:%d" % rport], timeout=30) as cli:
        return cli.health()["replicas"]


def _wait_router(rport, addr, want, proc, timeout=LAUNCH_WAIT_S):
    """Until the router (which rereads its replicas file) holds ``addr``
    in state ``want`` (None: not "up")."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        try:
            st = _router_states(rport).get(addr)
        except Exception:       # noqa: BLE001 — not bound yet
            st = "?"
        if (st == want) if want else (st != "up"):
            return time.perf_counter() - t0
        if proc.poll() is not None:
            break
        time.sleep(0.05)
    raise RuntimeError("launch_tier: the router never held %s %s"
                       % (addr, want or "out of service"))


def _planted_dropped_donation():
    """A contract over a fused SGD body that rebinds its weights instead
    of writing them: the verifier must trip on it."""
    from mxnet_tpu_torch import programs

    def rebinding_sgd(weights, grads, masters, lrs):
        return [w - lr * g for w, g, lr in zip(weights, grads,
                                                lrs.tolist())]

    def col():
        return tuple(torch.empty((64,), device="meta") for _ in range(3))
    case = programs.ContractCase(
        "optimizer.fused_sgd", (col(), col(), None,
                                torch.empty((3,), device="meta")),
        label="planted", fn=rebinding_sgd)
    return programs.ProgramContract("planted.fused_sgd", lambda: [case],
                                    donate_argnums=(0, 2),
                                    temp_budget_bytes=1 << 20,
                                    origin=(__file__, 1))


def launch_contracts(ver, smi):
    """(a): the verifier's JSON from its own process: all 18 contracts,
    no finding, every budget measured and held; then a planted dropped
    donation verified in this process must trip."""
    from mxnet_tpu_torch.tools import contracts as tcon
    out, err = ver.communicate(timeout=600)
    try:
        doc = json.loads(out)
        log("launch_tier: the contracts on the card (%s):\n%s"
            % (smi, doc["budget_table"]))
    except ValueError:
        doc = None
    if ver.returncode != 0:
        raise RuntimeError("launch_tier: the contracts verifier exited %d:\n"
                           "%s\n%s" % (ver.returncode, json.dumps(
                               doc["violations"]) if doc else out[-3000:],
                               err[-3000:]))
    cases = sum(len(p["cases"]) for p in doc["programs"].values())
    b = doc["budgets"]
    if len(doc["contracts"]) != 18 or doc["violations"] or \
            b["held"] != cases or b["unmeasured"] or b["over"]:
        raise RuntimeError("launch_tier: contracts %d, findings %s, budgets "
                           "%s of %d cases" % (len(doc["contracts"]),
                                               doc["violations"][:3], b,
                                               cases))
    temps = {"%s/%s" % (p, c["label"]): c["temp_bytes"]
             for p, row in doc["programs"].items() for c in row["cases"]}
    diags, results, _ = tcon.verify(device="cuda",
                                    contracts=[_planted_dropped_donation()])
    if [d.rule for d in diags] != [tcon.RULE_DONATION] or \
            results[0].dropped != 3:
        raise RuntimeError("launch_tier: the planted dropped donation gave "
                           "%s" % [repr(d) for d in diags])
    log("launch_tier: planted dropped donation: %s" % diags[0].message[:200])
    return {"contracts": len(doc["contracts"]), "cases": cases,
            "budgets": b, "temp_bytes": temps,
            "worst_temp_over_budget": max(
                c["temp_bytes"] / c["budget"] for row in
                doc["programs"].values() for c in row["cases"]),
            "planted": diags[0].rule}


def _replica_ready_s(tmp, i):
    """Replica ``i``'s record and its seconds from process start to
    serving (the ready file's write)."""
    r = json.load(open(os.path.join(tmp, "replica%d.rec" % i)))
    ready = os.path.getmtime(os.path.join(tmp, "replica%d.ready" % i))
    return r, ready - r["start_wall"]


def _launch_burst(rport, tokens, types, refs, stop, errors, counts):
    """LAUNCH_BURST_CLIENTS clients through the router until ``stop``:
    each answer held to ``refs``."""
    from mxnet_tpu_torch.serve import ServeClient

    def client(c):
        try:
            with ServeClient(["127.0.0.1:%d" % rport], timeout=120) as cli:
                i = c
                while not stop.is_set():
                    k = i % N_REQUESTS
                    _v, outs = cli.predict([tokens[k], types[k]])
                    for o, r in zip(outs, refs[k]):
                        if not np.allclose(o, r, atol=SLICE_TOL,
                                           rtol=SLICE_TOL):
                            raise RuntimeError("request %d off the "
                                               "composition" % k)
                    counts[c] = counts.get(c, 0) + 1
                    i += LAUNCH_BURST_CLIENTS
        except Exception as e:      # noqa: BLE001 — reported by the phase
            errors.append("burst client %d: %r" % (c, e))
    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(LAUNCH_BURST_CLIENTS)]
    for t in threads:
        t.start()
    return threads


def phase_launch_tier(refs, smi):
    """The launcher's serving tier on the card (after ``serve_tier``).
    (a) ``python -m mxnet_tpu_torch.tools.contracts --device cuda`` in its
    own process: 18 contracts clean, every budget measured and held; a
    planted dropped donation trips.  (b) ``python -m
    mxnet_tpu_torch.tools.launch -n 2 --serve-port-base B --route P
    --autoscale 2:3 --compile-cache DIR`` over ``chip_smoke.py
    --serve-replica-worker --port-base B`` (BERT-base fp32, T = 512, the
    slice's weights): the cold replicas build K1 with nvcc and store it;
    the same 32 requests routed within SLICE_TOL; a burst holds the SLO
    burn until the supervisor spawns replica 2, which loads K1 from the
    cache; the router admits sessions to it; each replica launched K1
    exactly 12 x (warm + served) and nothing else; when the load ends
    replica 2 leaves the replicas file, is DRAINed with generations in
    flight and exits 0; a STOP through the router ends the job with 0.
    Returns the launches over the three replicas."""
    import tempfile
    from mxnet_tpu_torch.serve import ServeClient
    from mxnet_tpu_torch.serve.decode import (DecodeConfig, demo_lm_params,
                                              reference_generate)
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-launch-")
    root = os.path.dirname(os.path.abspath(__file__))
    # fresh and empty: the launcher's --compile-cache makes it
    cache = os.path.join(tmp, "compile-cache")
    rec = {"card": smi, "slo_p99_ms": LAUNCH_SLO_P99_MS,
           "fleet": LAUNCH_FLEET}
    procs, stop, threads = [], threading.Event(), []
    tokens, types = make_requests()
    try:
        ver = subprocess.Popen(
            [sys.executable, "-m", "mxnet_tpu_torch.tools.contracts",
             "--device", "cuda", "--format", "json"], cwd=root,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        procs.append(ver)
        base, rport = _free_port_block(3), _free_port()
        addrs = ["127.0.0.1:%d" % (base + i) for i in range(3)]
        env = dict(os.environ, MX_FLEET_SLO_P99_MS=str(LAUNCH_SLO_P99_MS),
                   **LAUNCH_FLEET)
        log_path = os.path.join(tmp, "launch.log")
        t_launch = time.time()
        launcher = subprocess.Popen(
            [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n", "2",
             "--serve-port-base", str(base), "--route", str(rport),
             "--autoscale", "2:3", "--compile-cache", cache, "--restart",
             "on-failure", "--", sys.executable,
             os.path.join(root, "chip_smoke.py"), "--serve-replica-worker",
             "--port-base", str(base), tmp],
            cwd=root, env=env, stdout=open(log_path, "w"),
            stderr=subprocess.STDOUT)
        procs.append(launcher)
        llog = _LaunchLog(log_path, launcher)
        for i in (0, 1):
            _tier_wait_file(os.path.join(tmp, "replica%d.ready" % i),
                            launcher, "launched replica %d" % i)
            _wait_router(rport, addrs[i], "up", launcher)
        rec["cold_up_s"] = time.time() - t_launch
        cold = {}
        for i in (0, 1):
            r, ready_s = _replica_ready_s(tmp, i)
            cc = r["compile_cache"]
            cold[i] = {"ready_s": ready_s, "k1_nvcc_s": r["k1_nvcc_s"],
                       "hits": cc["hits"], "misses": cc["misses"],
                       "writes": cc["writes"], "b1": r["b1_program"]}
            if r["k1_from_cache"] or cc["misses"] < 1 or cc["writes"] < 1 \
                    or not r["k1_nvcc_s"]:
                raise RuntimeError("launch_tier: cold replica %d %s"
                                   % (i, cold[i]))
        rec["cold"] = cold
        log("launch_tier: cold replicas %s" % json.dumps(cold))
        rec["contracts"] = launch_contracts(ver, smi)

        # 1. the same 32 requests, routed, sessions over both replicas
        m0 = {a: _tier_metrics(a)[0] for a in addrs[:2]}
        answers, latency, wall, _cids, _ = _tier_burst(rport, tokens, types)
        worst = check_answers("launch_tier routed", answers, refs)
        req = {a: _tier_value(_tier_metrics(a)[0], "serve.requests")
               - _tier_value(m0[a], "serve.requests") for a in addrs[:2]}
        per = N_REQUESTS // N_CLIENTS
        if sum(req.values()) != N_REQUESTS or \
                any(v < per or v % per for v in req.values()):
            raise RuntimeError("launch_tier: requests by replica %s (each "
                               "session pinned: %d a client)" % (req, per))
        lat = np.array(latency) * 1e3
        rec["routed"] = {"requests_per_s": N_REQUESTS / wall,
                         "p50_ms": float(np.percentile(lat, 50)),
                         "p99_ms": float(np.percentile(lat, 99)),
                         "requests_by_replica": req,
                         "max_abs_err_vs_composition": worst}
        log("launch_tier: routed %s" % json.dumps(rec["routed"]))

        # 2. a burst holds the burn until the supervisor spawns replica 2
        errors, counts = [], {}
        t_burst = time.time()
        threads = _launch_burst(rport, tokens, types, refs, stop, errors,
                                counts)
        m, t_seen = llog.wait(r"autoscale: burn (\S+) >= (\S+) held - "
                              r"spawning rank 2 at (\S+)")
        if m.group(3) != addrs[2] or float(m.group(1)) < float(m.group(2)):
            raise RuntimeError("launch_tier: %s" % m.group(0))
        rec["scale_up"] = {"after_burst_s": t_seen - t_burst,
                           "burn": float(m.group(1))}
        # 3. replica 2, warm from the cache; the burst goes on meanwhile
        _tier_wait_file(os.path.join(tmp, "replica2.ready"), launcher,
                        "autoscaled replica 2")
        _wait_router(rport, addrs[2], "up", launcher)
        r2, ready2 = _replica_ready_s(tmp, 2)
        cc2 = r2["compile_cache"]
        warm = {"ready_s": ready2, "spawn_to_up_s": time.time() - t_seen,
                "k1_nvcc_s": r2["k1_nvcc_s"], "hits": cc2["hits"],
                "misses": cc2["misses"], "writes": cc2["writes"],
                "b1": r2["b1_program"]}
        if not r2["k1_from_cache"] or cc2["hits"] < 1 or cc2["misses"] or \
                r2["k1_nvcc_s"] or r2["b1_program"]["cache_hits"] != 1:
            raise RuntimeError("launch_tier: replica 2 was not warm: %s"
                               % warm)
        rec["warm"] = warm
        log("launch_tier: autoscaled replica 2 %s" % json.dumps(warm))
        # 4. the router admits fresh sessions to replica 2
        mr2 = _tier_metrics(addrs[2])[0]
        for attempt in range(4):
            answers, _lat, _w, _c, _ = _tier_burst(rport, tokens, types)
            check_answers("launch_tier admitted", answers, refs)
            got2 = _tier_value(_tier_metrics(addrs[2])[0], "serve.requests") \
                - _tier_value(mr2, "serve.requests")
            if got2 >= 1:
                break
        if got2 < 1:
            raise RuntimeError("launch_tier: the router admitted no session "
                               "to replica 2")
        rec["admitted_to_2"] = {"requests": got2, "bursts": attempt + 1}
        # 6a. generations in flight on replica 2 from here to its DRAIN
        cfg = DecodeConfig(**TIER_LM)
        params = demo_lm_params(cfg, torch.device("cuda", 0))
        prompts, news = decode_workload(cfg, 48, 2, SEED)
        gens, gen_end = [], []

        def generate_until_refused(j):
            # two of these, so that one is mid-generation at any moment
            i = j
            while True:
                k = i % len(prompts)
                t0 = time.time()
                try:
                    with ServeClient([addrs[2]], timeout=60) as c:
                        toks = c.generate(prompts[k], max_tokens=48)[1]
                except Exception as e:      # noqa: BLE001 — the end
                    gen_end.append((time.time(), repr(e)[:160]))
                    return
                gens.append((k, t0, time.time(), toks))
                i += 2
        gthreads = [threading.Thread(target=generate_until_refused,
                                     args=(j,), daemon=True)
                    for j in (0, 1)]
        for t in gthreads:
            t.start()
        # 5. the load ends: each replica's launches, read while quiet
        stop.set()
        for t in threads:
            t.join(120)
        threads += gthreads
        if errors:
            raise RuntimeError("launch_tier: burst %s" % errors[:3])
        t_quiet = time.time()
        launches, per_replica = {}, {}
        for a in addrs:
            snap = _tier_metrics(a)[0]
            ln = _tier_launches(snap)
            served = int(_tier_value(snap, "smoke.served"))
            want = 12 * (len(BUCKETS) + served)
            per_replica[a] = {"flash_fwd": ln.get("flash_fwd"),
                              "served": served}
            if ln.get("flash_fwd") != want or any(
                    v for k, v in ln.items() if k != "flash_fwd"):
                raise RuntimeError("launch_tier: %s launched %s for %d "
                                   "served, expected flash_fwd 12 x (%d + "
                                   "%d) = %d and nothing else"
                                   % (a, ln, served, len(BUCKETS), served,
                                      want))
            for k, v in ln.items():
                launches[k] = launches.get(k, 0) + v
        rec["launches_by_replica"] = per_replica
        rec["burst_requests"] = sum(counts.values())
        # 6b. replica 2 retired drain-not-kill
        m, t_retire = llog.wait(r"burn (\S+) <= (\S+) held - retiring "
                                r"rank 2 drain-not-kill")
        _wait_router(rport, addrs[2], None, launcher)
        for t in gthreads:
            t.join(TIER_DRAIN_S + 30)
        exit2 = os.path.join(tmp, "replica2.exit")
        t0 = time.perf_counter()
        while not os.path.exists(exit2):
            if time.perf_counter() - t0 > TIER_DRAIN_S:
                raise RuntimeError("launch_tier: replica 2 never exited:\n%s"
                                   % llog.text()[-3000:])
            time.sleep(0.05)
        if "DRAIN failed" in llog.text() or "rank 2 failed" in llog.text():
            raise RuntimeError("launch_tier: the retirement was not a clean "
                               "DRAIN:\n%s" % llog.text()[-3000:])
        # a generation that ended after the retirement was seen was
        # admitted before the DRAIN (which refuses new ones): in flight
        in_flight = [g for g in gens if g[2] > t_retire]
        decode_compare("launch_tier drained", [g[3] for g in gens],
                       [reference_generate(prompts[g[0]], 48, params=params,
                                           config=cfg) for g in gens],
                       [prompts[g[0]] for g in gens],
                       {k: v.double() for k, v in params.items()}, cfg)
        # each thread ended on the DRAIN's refusal (the supervisor logs the
        # retirement just before it sends the DRAIN; the log is polled)
        if not in_flight or len(gen_end) != 2 or \
                min(t for t, _e in gen_end) < t_retire - 1.0:
            raise RuntimeError("launch_tier: generations %d (%d in flight at "
                               "the DRAIN), ended by %s before the "
                               "retirement at %.3f" % (len(gens),
                                                       len(in_flight),
                                                       gen_end, t_retire))
        rec["retire"] = {"after_quiet_s": t_retire - t_quiet,
                         "generations": len(gens),
                         "in_flight_at_drain": len(in_flight),
                         "ended_by": [e for _t, e in gen_end],
                         "exit": json.load(open(exit2))}
        rec["rounds"] = llog.rounds()
        log("launch_tier: autoscale rounds (round, worst burn) %s"
            % json.dumps(rec["rounds"]))
        log("launch_tier: retirement %s" % json.dumps(rec["retire"]))
        # 7. a STOP through the router ends the job
        with ServeClient(["127.0.0.1:%d" % rport], timeout=30) as cli:
            cli.stop()
        code = launcher.wait(timeout=60)
        if code != 0 or not all(os.path.exists(os.path.join(
                tmp, "replica%d.exit" % i)) for i in (0, 1)):
            raise RuntimeError("launch_tier: the launcher exited %r:\n%s"
                               % (code, llog.text()[-3000:]))
        rec["launcher_exit"] = code
    finally:
        stop.set()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
        for t in threads:
            t.join(10)
        shutil.rmtree(tmp, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    log("launch_tier: %s" % json.dumps({k: rec[k] for k in (
        "cold", "warm", "scale_up", "launcher_exit", "phase_s", "card")}))
    return launches


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


def eager_optimizers(optimizers=EAGER_OPTIMIZERS, aggregates=(True, False),
                     tag="eager"):
    """(c) Each optimizer of ``optimizers``, in fp32 and in bf16 with
    ``multi_precision``, fused (the default ``aggregate_num``) and, where
    ``aggregates`` holds False, one parameter at a time
    (``aggregate_num=0``): one ``Updater`` step from one numpy state
    (weights, gradients, every state buffer set to |N(0, 0.01)|) on the
    card and on the CPU.  fp32 weights, states and masters within 1e-6 +
    1e-5 * |CPU|; a bf16 weight against the CPU's float32 master by
    :func:`compare`'s bf16 rule at 1e-5.  SGLD draws its noise from a
    ``torch.Generator`` on each device, and a twin of it takes the noise
    out before the comparison (its bf16 weight is not compared)."""
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
        dev = "cuda" if ctx.device_type == "gpu" else "cpu"
        if name == "sgld":
            kw = dict(kw, generator=torch.Generator(device=dev).manual_seed(1))
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
        out = host(ws), host(inner), host(masters)
        if name == "sgld":
            # the noise each weight (or its master) got, in update order
            twin = torch.Generator(device=dev).manual_seed(1)
            for t in (out[2] if masters else out[0]):
                t -= (torch.randn(t.shape, generator=twin, device=dev)
                      * np.sqrt(kw["learning_rate"])).float().cpu()
        return out

    rows = []
    for name, kw in optimizers:
        for dtype in ("float32", "bfloat16"):
            for aggregate in aggregates:
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
                if dtype == "bfloat16" and name != "sgld":
                    for a, m in zip(card[0], cpu[2]):
                        err, good = compare(a.bfloat16(), m, 1e-5)
                        worst = max(worst, err)
                        ok = ok and good
                row = {"optimizer": name, "params": kw, "dtype": dtype,
                       "fused": aggregate, "max_abs_err": worst, "ok": ok}
                rows.append(row)
                log("%s: optimizer %s" % (tag, json.dumps(row)))
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise RuntimeError("%s: optimizers off their CPU step: %s"
                           % (tag, bad))
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
    rec["finite_checks"] = amp_finite_checks(net)
    del net, step
    return rec, counts


def amp_finite_checks(net):
    """After (a)'s steps: ``nd.multi_all_finite`` over every gradient of
    ``net`` agrees with ``LossScaler.has_overflow``; with one inf planted
    in one gradient it reads 0 (so does ``nd.all_finite`` of that
    gradient, and the scaler sees the overflow); ``nd.amp_multicast`` of a
    bf16 / fp32 pair casts both to fp32 with the bf16 values exact."""
    from mxnet_tpu_torch import amp, nd
    params = list(net.collect_params().values())
    grads = [g for p in params for g in p.list_grad()]
    scaler = amp.LossScaler()

    def flag():
        return float(nd.multi_all_finite(*grads, num_arrays=len(grads))
                     .asnumpy()[0])
    clean = flag()
    overflow = scaler.has_overflow(params)
    ms = time_ms(flag, iters=5, warmup=1)
    target = grads[len(grads) // 2]
    keep = target.data.view(-1)[0].clone()
    target.data.view(-1)[0] = float("inf")
    try:
        planted = flag()
        planted_one = float(nd.all_finite(target).asnumpy()[0])
        planted_overflow = scaler.has_overflow(params)
    finally:
        target.data.view(-1)[0] = keep
    a = nd.array(np.linspace(-3, 3, 64, dtype=np.float32),
                 ctx=target.context).astype("bfloat16")
    b = nd.array(np.ones(16, np.float32), ctx=target.context)
    cast = nd.amp_multicast(a, b, num_outputs=2)
    rec = {"gradients": len(grads), "multi_all_finite": clean,
           "has_overflow": overflow, "multi_all_finite_ms": ms,
           "planted": planted, "planted_all_finite": planted_one,
           "planted_has_overflow": planted_overflow,
           "multicast_dtypes": [str(c.dtype) for c in cast]}
    log("amp: finite %s" % json.dumps(rec))
    if (clean == 1.0) == overflow or planted != 0.0 or planted_one != 0.0 \
            or not planted_overflow:
        raise RuntimeError("amp: the finite checks disagree: %s" % rec)
    if rec["multicast_dtypes"] != ["float32", "float32"] or not \
            torch.equal(cast[0].data, a.data.float()):
        raise RuntimeError("amp: amp_multicast of bf16 / fp32 gave %s"
                           % rec["multicast_dtypes"])
    return rec


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
# params, mean, variance); its _npi_* rows are NPI_MOMENTS's first six
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


def _logseries_moments(p):
    lg = np.log(1 - p)
    return (-p / ((1 - p) * lg), -p * (p + lg) / ((1 - p) ** 2 * lg ** 2))


def _zeta(s, terms=100000):
    """Riemann's zeta by its series and the integral of the tail."""
    n = np.arange(1, terms + 1, dtype=np.float64)
    return float((n ** -s).sum() + terms ** (1 - s) / (s - 1))


# the 14 numpy-era samplers carrying the legacy aliases: the _npi_* rows of
# tests/test_random.py's MOMENTS table, then the closed-form moments of the
# other eight (dirichlet by its first component; vonmises by its circular
# mean and resultant length i1(4) / i0(4); standard_cauchy by its
# quartiles, -1 and 1) -- (op, params, mean, variance)
NPI_MOMENTS = [
    ("_npi_laplace", {"loc": -1.0, "scale": 0.5}, -1.0, 2.0 * 0.25),
    ("_npi_beta", {"a": 2.0, "b": 6.0}, 0.25, 2.0 * 6.0 / (64.0 * 9.0)),
    ("_npi_chisquare", {"df": 5.0}, 5.0, 10.0),
    ("_npi_standard_t", {"df": 10.0}, 0.0, 10.0 / 8.0),
    ("_npi_lognormal", {"mean": 0.0, "sigma": 0.5}, np.exp(0.125),
     (np.exp(0.25) - 1) * np.exp(0.25)),
    ("_npi_triangular", {"left": 0.0, "mode": 1.0, "right": 2.0}, 1.0,
     4.0 / 24.0),
    ("_npi_standard_gamma", {"shape_param": 2.0}, 2.0, 2.0),
    ("_npi_noncentral_chisquare", {"df": 3.0, "nonc": 2.0}, 5.0, 14.0),
    ("_npi_wald", {"mean": 3.0, "scale": 2.0}, 3.0, 13.5),
    ("_npi_logseries", {"p": 0.5}) + _logseries_moments(0.5),
    ("_npi_zipf", {"a": 6.0}, _zeta(5.0) / _zeta(6.0),
     _zeta(4.0) / _zeta(6.0) - (_zeta(5.0) / _zeta(6.0)) ** 2),
    ("_npi_dirichlet", {"alpha": (1.0, 2.0, 3.0)}, 1.0 / 6.0,
     5.0 / (36.0 * 7.0)),
    ("_npi_vonmises", {"mu": 0.5, "kappa": 4.0}, 0.5, None),
    ("_npi_standard_cauchy", {}, 0.0, None),
]
VONMISES_R = 0.8635078        # i1(4) / i0(4)


def data_samplers():
    """(d) continued: 10^6 draws on the card of each of ``NPI_MOMENTS``'s
    14 samplers, held by mean and variance at ``tests/test_random.py``'s
    tolerances (5 standard errors + 1e-3, 15 % + 5e-3); ``vonmises`` by its
    circular mean (within 0.02) and resultant length (within 0.01), the
    Cauchy by its quartiles (5 standard errors of a sample quantile); each
    repeats bitwise under one seed; ms of each draw (CUDA events)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ndarray.ndarray import invoke
    gpu = mx.gpu(0)
    rows, bad = [], []
    for op, params, mean, var in NPI_MOMENTS:
        mx.random.seed(7)
        x = invoke(op, size=(RANDOM_N,), ctx=gpu, **params).data
        mx.random.seed(7)
        again = invoke(op, size=(RANDOM_N,), ctx=gpu, **params).data
        xd = x.double()
        if op == "_npi_dirichlet":
            xd = xd[:, 0]
        row = {"op": op, "repeat_bitwise": torch.equal(x, again),
               "ms": time_ms(lambda: invoke(op, size=(RANDOM_N,), ctx=gpu,
                                            **params), iters=5, warmup=1)}
        ok = x.is_cuda and row["repeat_bitwise"] and \
            bool(torch.isfinite(xd).all())
        if op == "_npi_vonmises":
            z = torch.complex(torch.cos(xd), torch.sin(xd)).mean()
            row.update(circular_mean=float(torch.angle(z)),
                       resultant=float(z.abs()))
            ok = ok and abs(row["circular_mean"] - mean) < 0.02 and \
                abs(row["resultant"] - VONMISES_R) < 0.01
        elif op == "_npi_standard_cauchy":
            q = torch.quantile(xd, torch.tensor(
                [0.25, 0.5, 0.75], dtype=torch.float64, device=xd.device))
            se = np.sqrt(0.25 * 0.75 / RANDOM_N) * 2 * np.pi
            row.update(quartiles=[float(v) for v in q])
            ok = ok and abs(row["quartiles"][0] + 1) < 5 * se and \
                abs(row["quartiles"][2] - 1) < 5 * se and \
                abs(row["quartiles"][1]) < 5 * np.pi * np.sqrt(0.25 /
                                                              RANDOM_N)
        else:
            m, v = float(xd.mean()), float(xd.var(unbiased=False))
            row.update(mean=m, want_mean=mean, var=v, want_var=var)
            ok = ok and abs(m - mean) < 5 * np.sqrt(var / RANDOM_N) + \
                1e-3 and abs(v - var) < 0.15 * var + 5e-3
        row["ok"] = bool(ok)
        rows.append(row)
        if not ok:
            bad.append(row)
    log("data: samplers %s" % json.dumps({"n": RANDOM_N, "rows": rows}))
    if bad:
        raise RuntimeError("data: the _npi_* samplers on the card: %s" % bad)
    return rows


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
    data_samplers()
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
PS_STEPS_A = 2                  # server steps (the last one profiled),
                                # then as many local ones
PS_STEPS_B = 1                  # each rank's steps in part (b)
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
    """(c) A server step under the profiler with a device trace: the
    chrome trace must name K1-K3's kernels and ``profiler.dumps()`` the
    client's PUSH and PULL spans.  Returns ``(loss, kernels, spans)``."""
    from mxnet_tpu_torch import profiler
    profiler.set_config(profile_all=True, device_trace_dir=trace_dir)
    profiler.set_state("run")
    try:
        loss = ps_step(net, params, loss_fn, batch, kv)
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
    return loss, flash, spans


def ps_part_a(dev, trace_dir):
    """(a) One worker, one server: PS_STEPS_A steps with the server's SGD
    (momentum 0.9), the last of them profiled (c), then as many steps
    from the same weights and batches with a local updater of the same
    SGD on the card.  Step 1's loss bitwise equal, every weight after step
    PS_STEPS_A within PS_TOL_A x max|ref| of the local run's (from step 2
    on, the weights carry the server's momentum)."""
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
               for s in range(PS_STEPS_A)]
    timing = {}
    torch.cuda.synchronize()
    _kernels.reset_launches()
    # --- the ps main path, counted (its last step under the profiler) ---
    losses = [ps_step(net, params, loss_fn, batches[s], kv, timing)
              for s in range(PS_STEPS_A - 1)]
    t_c = time.perf_counter()
    loss_c, flash, spans = ps_profiled_step(net, params, loss_fn,
                                            batches[PS_STEPS_A - 1], kv,
                                            trace_dir)
    secs_c = time.perf_counter() - t_c
    losses.append(loss_c)
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    # --- end of the counted main path ---
    want = len(net.encoder.transformer_cells) * PS_STEPS_A
    if any(counts[k] != want for k in _FLASH):
        raise RuntimeError("ps (a): launched %s, expected %d of each of %s"
                           % (counts, want, _FLASH))
    w_ps = [p.data().data.detach().clone() for p in params]
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
    rank takes PS_STEPS_B steps on its own data and keeps the float64 sum
    S_r of the gradients it pushed.  After the barrier rank 0 pulls every weight:
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
        # CPU workers run several to a host (the tests start eight at
        # once): one intra-op thread each, or their thread pools contend
        # and a step outlasts MX_STEP_TIMEOUT
        torch.set_num_threads(1)
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


# ---------------------------------------------------------------------------
# 19. sequence, pipeline and expert parallelism
# ---------------------------------------------------------------------------

#: examples/train_long_context.py's model at BERT-base's widths (768, 12
#: heads, so D = 64, 12 layers) and L = 16384, batch 1 (the phase's); the
#: vocabulary and the corpus are the example's.  The CPU tests run it at
#: LC_TINY (D = 64 too, so the ring takes its kernel route).
LC_BASE = {"seq_len": 16384, "d_model": 768, "heads": 12, "layers": 12,
           "vocab": 64, "batch": 1}
LC_TINY = {"seq_len": 64, "d_model": 128, "heads": 2, "layers": 2,
           "vocab": 64, "batch": 4}
LC_LR = 3e-3                    # the example's default
LC_STEPS = 2
CONTEXT_TOL = 1e-4              # x max|ref|: the port's fp32 rule
#: attention's own rule (x max|ref|), for the attention check of the LM's
#: length against float64
CONTEXT_ATTN_TOL = 2e-3
#: the losses of sp = 2 against sp = 1 after the first step: Adam divides
#: each gradient by its own scale, so a gradient that differs in the
#: rounding (up to CONTEXT_TOL x max|ref| at step 1) moves its parameter
#: by up to 2 x lr where it is near zero; ten times the first step's rule
CONTEXT_LOSS_RTOL = 1e-3
CONTEXT_TIMEOUT = 600           # seconds the phase's launcher may take
PIPE_WIDTH, PIPE_HEADS, PIPE_FFN = 768, 12, 3072    # a BERT-base layer
PIPE_T, PIPE_BATCH, PIPE_MICRO = 512, 16, 4
MOE_D, MOE_HIDDEN, MOE_EXPERTS = 768, 3072, 8       # BERT-base's FFN
MOE_TOKENS, MOE_CF, MOE_AUX = 4096, 2.0, 0.01       # a rank's tokens


def long_context_init(cfg, dev):
    """The example's corpus permutation, then its parameters as a flat
    dict by name, from ``RandomState(0)`` in its draw order (the
    permutation; each layer's wqkv, wo, w1, w2; the embedding); returns
    (params, rng, perm): the batches continue the same stream."""
    d, vocab = cfg["d_model"], cfg["vocab"]
    rng = np.random.RandomState(0)
    perm = rng.permutation(vocab)

    def g(*shape):
        return torch.tensor(rng.randn(*shape) * 0.02, dtype=torch.float32,
                            device=dev)

    params = {}
    for i in range(cfg["layers"]):
        params.update({"layers.%d.wqkv" % i: g(d, 3 * d),
                       "layers.%d.wo" % i: g(d, d),
                       "layers.%d.w1" % i: g(d, 4 * d),
                       "layers.%d.w2" % i: g(4 * d, d),
                       "layers.%d.ln1" % i: torch.ones(d, device=dev),
                       "layers.%d.ln2" % i: torch.ones(d, device=dev)})
    params["emb"] = g(vocab, d)
    params["lnf"] = torch.ones(d, device=dev)
    return params, rng, perm


def long_context_batch(rng, perm, batch, seq_len):
    """The example's ``batch()``: a start token a row, then the map
    ``perm`` applied L times; (tokens, targets)."""
    seq = np.zeros((batch, seq_len + 1), np.int32)
    seq[:, 0] = rng.randint(0, len(perm), batch)
    for t in range(1, seq_len + 1):
        seq[:, t] = perm[seq[:, t - 1]]
    return seq[:, :-1], seq[:, 1:]


def _lc_norm(x, gamma):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return gamma * (x - mu) / torch.sqrt(var + 1e-5)


def long_context_loss(params, tokens, targets, cfg, attn):
    """The example's ``loss_fn`` on this rank's tokens: the embedding; per
    layer LN -> QKV -> ``attn`` -> WO and LN -> GELU MLP, with residuals;
    the tied head; the mean next-token cross-entropy."""
    import torch.nn.functional as F
    x = params["emb"][tokens]
    B, L, D = x.shape
    for i in range(cfg["layers"]):
        p = {n: params["layers.%d.%s" % (i, n)]
             for n in ("wqkv", "wo", "w1", "w2", "ln1", "ln2")}
        h = _lc_norm(x, p["ln1"])
        qkv = (h @ p["wqkv"]).reshape(B, L, 3, cfg["heads"],
                                      D // cfg["heads"])
        o = attn(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]).reshape(B, L, D)
        x = x + o @ p["wo"]
        h = _lc_norm(x, p["ln2"])
        x = x + F.gelu(h @ p["w1"], approximate="tanh") @ p["w2"]
    logits = _lc_norm(x, params["lnf"]) @ params["emb"].T
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets[..., None].long()).mean()


def mesh_mean(tensors, mesh, axes):
    """Each tensor's mean over the ranks of ``axes``: one flat buffer,
    all-reduced over each axis's group in turn."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    n = 1
    for axis in axes:
        if mesh.axis_size(axis) > 1:
            dist.all_reduce(flat, group=mesh.group(axis))
        n *= mesh.axis_size(axis)
    flat /= n
    return [f.view_as(t) for f, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def long_context_train(cfg, mesh, dev, steps, method="ring", lr=LC_LR):
    """The port's copy of the example's training: its model, parameters,
    corpus and Adam step, on a (dp, sp) mesh.  Each rank takes its (B/dp,
    L/sp) shard of every global batch, attention is
    ``context_parallel_attention(..., causal=True, method=method)`` over
    sp, and each rank's loss is the mean over its tokens, so the gradients
    (and the loss) are averaged over every rank of both axes.  Returns the
    losses, the first step's gradients, the final parameters and each
    step's ms (CUDA events on the card, the host clock on the CPU)."""
    from mxnet_tpu_torch.parallel import context_parallel_attention
    params, rng, perm = long_context_init(cfg, dev)
    coords = mesh.coords()
    bl = cfg["batch"] // mesh.axis_size("dp")
    ll = cfg["seq_len"] // mesh.axis_size("sp")
    rows = slice(coords["dp"] * bl, (coords["dp"] + 1) * bl)
    cols = slice(coords["sp"] * ll, (coords["sp"] + 1) * ll)

    def attn(q, k, v):
        return context_parallel_attention(q, k, v, mesh, causal=True,
                                          method=method)

    names = list(params)
    mom = {n: torch.zeros_like(p) for n, p in params.items()}
    vel = {n: torch.zeros_like(p) for n, p in params.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    out = {"losses": [], "step_ms": [], "grads": None}
    for t in range(steps):
        tok, tgt = (torch.from_numpy(np.ascontiguousarray(a[rows, cols]))
                    .to(dev) for a in long_context_batch(
                        rng, perm, cfg["batch"], cfg["seq_len"]))
        if dev.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
        else:
            t0 = time.perf_counter()
        leaves = [params[n].detach().requires_grad_(True) for n in names]
        loss = long_context_loss(dict(zip(names, leaves)), tok, tgt, cfg,
                                 attn)
        grads = torch.autograd.grad(loss, leaves)
        *grads, loss = mesh_mean(list(grads) + [loss.detach()[None]], mesh,
                                 ("sp", "dp"))
        with torch.no_grad():
            tt = t + 1
            for n, g in zip(names, grads):
                mom[n] = b1 * mom[n] + (1 - b1) * g
                vel[n] = b2 * vel[n] + (1 - b2) * g * g
                params[n] = params[n] - lr * (mom[n] / (1 - b1 ** tt)) / (
                    torch.sqrt(vel[n] / (1 - b2 ** tt)) + eps)
        if dev.type == "cuda":
            end.record()
            end.synchronize()
            out["step_ms"].append(start.elapsed_time(end))
        else:
            out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["losses"].append(float(loss))
        if t == 0:
            out["grads"] = dict(zip(names, grads))
        del leaves, grads
    out["params"] = params
    return out


def long_context_worker(argv=None):
    """The port's copy of ``examples/train_long_context.py``: a causal
    transformer LM whose sequence is split over the ``sp`` axis of a (dp,
    sp) mesh, every attention layer ``parallel.ring_attention``.  Run
    under the launcher::

        python -m mxnet_tpu_torch.tools.launch -n 2 --launcher local \\
            -- python chip_smoke.py --long-context-worker --sp 2 \\
            [--device cpu] [--seq-len 512 ...]

    Prints the example's ``step``, ``final loss`` lines (rank 0)."""
    import argparse
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.device import resolve
    from mxnet_tpu_torch.parallel import init_process_group, make_mesh
    p = argparse.ArgumentParser(description=long_context_worker.__doc__)
    p.add_argument("--seq-len", type=int, default=512)
    p.add_argument("--d-model", type=int, default=64)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--vocab", type=int, default=64)
    p.add_argument("--batch", type=int, default=4, help="global batch")
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--lr", type=float, default=LC_LR)
    p.add_argument("--sp", type=int, default=0,
                   help="sequence-parallel degree (0 = all ranks)")
    p.add_argument("--device", default="gpu", choices=["gpu", "cpu"])
    args = p.parse_args(argv)
    if args.device == "cpu":
        torch.set_num_threads(1)
    ctx = mx.cpu() if args.device == "cpu" else mx.gpu(0)
    # a caller that already joined the group keeps it
    own_group = not dist.is_initialized()
    dev = init_process_group(device=ctx) if own_group else resolve(ctx)
    world = dist.get_world_size()
    sp = args.sp or world
    mesh = make_mesh(("dp", "sp"), (-1, sp))
    cfg = {"seq_len": args.seq_len, "d_model": args.d_model,
           "heads": args.heads, "layers": args.layers, "vocab": args.vocab,
           "batch": args.batch}
    if dist.get_rank() == 0:
        emit("mesh: %s | L=%d (L/sp=%d per rank)" % (
            dict(mesh.shape), args.seq_len, args.seq_len // sp))
    res = long_context_train(cfg, mesh, dev, args.steps, lr=args.lr)
    if dist.get_rank() == 0:
        for i, loss in enumerate(res["losses"]):
            if i % 10 == 0 or i == args.steps - 1:
                emit("step %3d  loss %.4f" % (i, loss))
        emit("final loss %.4f (from %.4f) over L=%d with sp=%d"
             % (res["losses"][-1], res["losses"][0], args.seq_len, sp))
    if own_group:
        dist.destroy_process_group()


def _k123(counts):
    return {k: counts.get(k, 0) for k in _FLASH}


def context_attention_check(dev, mesh):
    """The ring's attention alone at the LM's length (L = 16384, causal,
    4 heads of 64, fp32): its output and gradients (sp = 2), one rank's on
    the whole L (K1-K3 at T = 16384) and the plain version's in float64
    (rank 0), each side's deviation from float64 x max|ref| for O, dQ, dK
    and dV; None on the other ranks."""
    from mxnet_tpu_torch.ops import attention as att
    from mxnet_tpu_torch.parallel import ring_attention
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    L, n, idx = LC_BASE["seq_len"], mesh.axis_size("sp"), \
        mesh.axis_index("sp")
    q, k, v, do = (torch.randn((1, L, 4, 64), generator=g, device=dev)
                   for _ in range(4))
    mine = slice(idx * L // n, (idx + 1) * L // n)
    leaves = [t[:, mine].clone().requires_grad_(True) for t in (q, k, v)]
    out = ring_attention(*leaves, causal=True, mesh=mesh)
    out.backward(do[:, mine])
    ring = []
    for part in [out.detach()] + [t.grad for t in leaves]:
        every = [torch.empty_like(part) for _ in range(n)]
        dist.all_gather(every, part.contiguous(), group=mesh.group("sp"))
        ring.append(torch.cat(every, dim=1).transpose(1, 2))
    del out, leaves
    if idx != 0:
        return None
    scale = 64 ** -0.5
    heads = [t.transpose(1, 2).contiguous() for t in (q, k, v, do)]
    leaves = [t.clone().requires_grad_(True) for t in heads[:3]]
    o1 = att.flash_attention(*leaves, scale, True)
    o1.backward(heads[3])
    one = [o1.detach()] + [t.grad for t in leaves]
    del o1, leaves
    x = [t.double() for t in heads]
    o64, lse64 = att.flash_attention_plain(*x[:3], scale, True)
    ref = [o64, att.flash_bwd_dq_plain(*x[:3], o64, lse64, x[3], scale,
                                       True)]
    ref += list(att.flash_bwd_dkv_plain(*x[:3], o64, lse64, x[3], scale,
                                        True))
    del x, o64, lse64

    def dev64(got):
        return [float((a.double() - b).abs().max() / b.abs().max())
                for a, b in zip(got, ref)]
    return {"ring_vs_f64": dev64(ring), "sp1_vs_f64": dev64(one)}


def context_part_a(dev):
    """(a) The long-context LM at BERT-base widths, L = 16384, on a (dp =
    1, sp = 2) mesh: LC_STEPS Adam steps through the ring (K1-K3 on every
    hop that is not skipped), one through Ulysses; then rank 0 trains the
    model at sp = 1 (one rank, K1-K3 on the whole L) on the same seeds.
    Against sp = 1's first step: both losses within CONTEXT_TOL, both
    paths' gradients within CONTEXT_TOL x max|ref|; both sides' attention
    at this length within
    CONTEXT_ATTN_TOL of float64 (:func:`context_attention_check`); every
    ring loss within CONTEXT_LOSS_RTOL.  Each rank launched each of K1-K3
    once a layer for each hop it did not skip (rank r: r + 1 hops, causal)
    a step, and once a layer a step through Ulysses."""
    from mxnet_tpu_torch.ops import _kernels
    from mxnet_tpu_torch.parallel import collectives, make_mesh
    rank, cfg = dist.get_rank(), LC_BASE
    mesh = make_mesh(("dp", "sp"), (1, 2))
    hops = mesh.axis_index("sp") + 1
    rec = {"part": "a", "rank": rank, "mesh": dict(mesh.shape)}
    torch.cuda.reset_peak_memory_stats(dev)
    collectives.reset_stats()
    _kernels.reset_launches()
    ring = long_context_train(cfg, mesh, dev, LC_STEPS)
    torch.cuda.synchronize()
    rec["ring"] = {"launches": _kernels.launch_counts(),
                   "expected": cfg["layers"] * hops * LC_STEPS,
                   "losses": ring["losses"], "step_ms": ring["step_ms"],
                   "peak_bytes": torch.cuda.max_memory_allocated(dev),
                   "collectives": collectives.stats()}
    pp = rec["ring"]["collectives"]["ppermute"]
    rec["ring"]["hop"] = {"bytes": pp["bytes"] / pp["calls"],
                          "ms": pp["seconds"] / pp["calls"] * 1e3,
                          "calls": pp["calls"]}
    del ring["params"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    collectives.reset_stats()
    _kernels.reset_launches()
    uly = long_context_train(cfg, mesh, dev, 1, method="ulysses")
    torch.cuda.synchronize()
    rec["ulysses"] = {"launches": _kernels.launch_counts(),
                      "expected": cfg["layers"], "losses": uly["losses"],
                      "step_ms": uly["step_ms"],
                      "peak_bytes": torch.cuda.max_memory_allocated(dev),
                      "collectives": collectives.stats()}
    del uly["params"]
    faults = ["%s launched %s, expected %d of each of K1-K3"
              % (path, rec[path]["launches"], rec[path]["expected"])
              for path in ("ring", "ulysses")
              if set(_k123(rec[path]["launches"]).values()) !=
              {rec[path]["expected"]}]
    gc.collect()
    torch.cuda.empty_cache()
    attn = context_attention_check(dev, mesh)
    if attn is not None:
        rec["attention"] = attn
        if max(max(v) for v in attn.values()) > CONTEXT_ATTN_TOL:
            faults.append("attention at L = %d: %s from float64 x max|ref|, "
                          "beyond %g" % (cfg["seq_len"], attn,
                                         CONTEXT_ATTN_TOL))
    if rank == 0:
        gc.collect()
        torch.cuda.empty_cache()
        _kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        one = long_context_train(cfg, make_mesh(("dp", "sp"), (1, 1),
                                                devices=[0]), dev, LC_STEPS)
        torch.cuda.synchronize()
        del one["params"]
        rec["sp1"] = {"launches": _k123(_kernels.launch_counts()),
                      "losses": one["losses"], "step_ms": one["step_ms"],
                      "peak_bytes": torch.cuda.max_memory_allocated(dev)}
        ref = one["losses"]
        for path, res, tol in (("ring", ring, CONTEXT_TOL),
                               ("ulysses", uly, CONTEXT_TOL)):
            worst = _worst_rel(res["grads"], one["grads"])
            first = abs(res["losses"][0] - ref[0]) / abs(ref[0])
            rec[path].update(first_grad_worst=worst, first_loss_rel=first)
            if not (worst <= tol and first <= CONTEXT_TOL):
                faults.append("%s's first step is %.3g (gradients, tolerance "
                              "%g) and %.3g (loss, tolerance %g) x max|ref| "
                              "from sp = 1's" % (path, worst, tol, first,
                                                 CONTEXT_TOL))
        rel = [abs(a - b) / abs(b) for a, b in zip(ring["losses"], ref)]
        rec["ring"]["loss_rel"] = rel
        if max(rel) > CONTEXT_LOSS_RTOL:
            faults.append("the ring's losses %s are %s relative from sp = "
                          "1's %s, tolerance %g" % (ring["losses"], rel, ref,
                                                    CONTEXT_LOSS_RTOL))
    return rec, faults


def pipe_params(n_stages, dev):
    """One BERT-base encoder layer's parameters per stage, stacked on a
    leading stage axis, from the seed (weights N(0, 0.02), LN 1 and 0)."""
    rng = np.random.RandomState(SEED)
    d, f = PIPE_WIDTH, PIPE_FFN

    def g(*shape):
        return torch.tensor(rng.randn(n_stages, *shape) * 0.02,
                            dtype=torch.float32, device=dev)

    def const(value, n):
        return torch.full((n_stages, n), value, device=dev)

    return (g(d, 3 * d), g(3 * d), g(d, d), g(d), const(1.0, d),
            const(0.0, d), g(d, f), g(f), g(f, d), g(d), const(1.0, d),
            const(0.0, d))


def pipe_stage(p, x):
    """A BERT-base encoder layer (post-LN, GELU, attention through
    ``attention_core``: K1-K3) on (batch, T, 768)."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.attention import attention_core
    wqkv, bqkv, wo, bo, g1, c1, w1, b1, w2, b2, g2, c2 = p
    B, T, d = x.shape
    qkv = (x @ wqkv + bqkv).reshape(B, T, 3, PIPE_HEADS, d // PIPE_HEADS)
    qkv = qkv.permute(2, 0, 3, 1, 4)
    a = attention_core(qkv[0], qkv[1], qkv[2]).transpose(1, 2)
    x = F.layer_norm(x + a.reshape(B, T, d) @ wo + bo, (d,), g1, c1, 1e-12)
    h = F.gelu(x @ w1 + b1) @ w2 + b2
    return F.layer_norm(x + h, (d,), g2, c2, 1e-12)


def context_part_b(dev):
    """(b) GPipe over pp = 2, each stage a BERT-base encoder layer, T =
    512, batch 16 in 4 microbatches: the outputs and each rank's stage
    gradients of the squared error to a random target within CONTEXT_TOL x
    max|ref| of the sequential stack on this rank; K1-K3 launched once a
    tick (5 ticks) on each rank.  (Not mean(out^2): the last layer norm
    makes that 1 whatever the parameters, and its gradients rounding
    noise.)"""
    from mxnet_tpu_torch.ops import _kernels
    from mxnet_tpu_torch.parallel import make_mesh, pipeline_parallel
    mesh = make_mesh(("pp",), (2,))
    idx = mesh.axis_index("pp")
    stacked = [t.requires_grad_(True) for t in pipe_params(2, dev)]
    rng = np.random.RandomState(SEED + 1)
    x, y = (torch.tensor(rng.randn(PIPE_BATCH, PIPE_T, PIPE_WIDTH),
                         dtype=torch.float32, device=dev) for _ in range(2))
    apply = pipeline_parallel(pipe_stage, mesh, n_microbatches=PIPE_MICRO)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = apply(tuple(stacked), x)
    grads = torch.autograd.grad(((out - y) ** 2).mean(), stacked)
    end.record()
    end.synchronize()
    launches = _kernels.launch_counts()
    ticks = PIPE_MICRO + mesh.axis_size("pp") - 1
    ref_leaves = [t.detach().clone().requires_grad_(True) for t in stacked]
    h = x
    for s in range(mesh.axis_size("pp")):
        h = pipe_stage(tuple(t[s] for t in ref_leaves), h)
    ref_grads = torch.autograd.grad(((h - y) ** 2).mean(), ref_leaves)
    worst_out = _worst_rel({"out": out.detach()}, {"out": h.detach()})
    worst_grad = _worst_rel(
        {i: g[idx] for i, g in enumerate(grads)},
        {i: g[idx] for i, g in enumerate(ref_grads)})
    rec = {"part": "b", "rank": dist.get_rank(), "stage": idx,
           "ticks": ticks, "launches": launches, "ms": start.elapsed_time(end),
           "out_worst": worst_out, "grad_worst": worst_grad}
    faults = []
    if set(_k123(launches).values()) != {ticks}:
        faults.append("pipeline launched %s, expected %d of each of K1-K3"
                      % (launches, ticks))
    if not (worst_out <= CONTEXT_TOL and worst_grad <= CONTEXT_TOL):
        faults.append("pipeline: outputs %.3g, gradients %.3g x max|ref| "
                      "from the sequential stack, tolerance %g"
                      % (worst_out, worst_grad, CONTEXT_TOL))
    return rec, faults


def moe_expert(p, x):
    import torch.nn.functional as F
    w1, w2 = p
    return F.gelu(x @ w1) @ w2


def moe_reference(x, gate_w, w1, w2, shards, cf):
    """Top-1 MoE token by token, on one rank: each shard's tokens routed
    to their most probable expert, the first ``capacity`` of each expert's
    in token order kept, each kept token's expert output scaled by its
    gate probability (a dropped token: 0).  Returns (y, the Switch loss
    averaged over the shards, the tokens dropped)."""
    n_experts = gate_w.shape[1]
    ys, auxes, dropped = [], [], 0
    for xs in x.chunk(shards):
        cap = max(1, int(cf * xs.shape[0] / n_experts))
        probs = torch.softmax(xs @ gate_w, dim=-1)
        pick = probs.argmax(dim=-1)
        y = torch.zeros_like(xs)
        for e in range(n_experts):
            mine = (pick == e).nonzero()[:, 0]
            kept = mine[:cap]
            dropped += len(mine) - len(kept)
            y = y.index_put((kept,), probs[kept, e, None] * moe_expert(
                (w1[e], w2[e]), xs[kept]))
        ys.append(y)
        frac = torch.nn.functional.one_hot(pick, n_experts).float().mean(0)
        auxes.append(n_experts * (frac * probs.mean(0)).sum())
    return torch.cat(ys), torch.stack(auxes).mean(), dropped


def context_part_c(dev):
    """(c) Top-1 MoE over ep = 2: 8 BERT-base FFN experts (768 -> 3072 ->
    768, GELU), 4096 tokens a rank, capacity factor 2.  This rank's
    outputs, the auxiliary loss and the gradients of its share of the loss
    (mean(y^2) / n + MOE_AUX x aux) within CONTEXT_TOL x max|ref| of
    :func:`moe_reference` on this rank; the share of tokens dropped."""
    from mxnet_tpu_torch.ops import _kernels
    from mxnet_tpu_torch.parallel import make_mesh, moe_parallel
    mesh = make_mesh(("ep",), (2,))
    n, idx = mesh.axis_size("ep"), mesh.axis_index("ep")
    rng = np.random.RandomState(SEED + 2)

    def g(*shape, s=0.02):
        return torch.tensor(rng.randn(*shape) * s, dtype=torch.float32,
                            device=dev)

    w1 = g(MOE_EXPERTS, MOE_D, MOE_HIDDEN)
    w2 = g(MOE_EXPERTS, MOE_HIDDEN, MOE_D)
    gate_w = g(MOE_D, MOE_EXPERTS, s=0.1)
    x = g(n * MOE_TOKENS, MOE_D, s=1.0)
    leaves = [t.requires_grad_(True) for t in (gate_w, w1, w2)]
    mine = x[idx * MOE_TOKENS:(idx + 1) * MOE_TOKENS]
    apply = moe_parallel(moe_expert, mesh, capacity_factor=MOE_CF)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    y, aux = apply(mine, leaves[0], tuple(leaves[1:]))
    grads = torch.autograd.grad((y ** 2).mean() / n + MOE_AUX * aux, leaves)
    end.record()
    end.synchronize()
    launches = _kernels.launch_counts()
    ref_leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
    y_ref, aux_ref, dropped = moe_reference(x, *ref_leaves, n, MOE_CF)
    ref_loss = sum((ys ** 2).mean() / n for ys in y_ref.chunk(n)) + \
        MOE_AUX * aux_ref
    ref_grads = torch.autograd.grad(ref_loss, ref_leaves)
    rows = slice(idx * MOE_EXPERTS // n, (idx + 1) * MOE_EXPERTS // n)
    worst = {"y": _worst_rel({0: y.detach()}, {0: y_ref.detach().chunk(n)[
                 idx]}),
             "aux": abs(float(aux.detach()) - float(aux_ref.detach()))
             / abs(float(aux_ref.detach())),
             "gate": _worst_rel({0: grads[0]}, {0: ref_grads[0]}),
             "experts": _worst_rel({1: grads[1][rows], 2: grads[2][rows]},
                                   {1: ref_grads[1][rows],
                                    2: ref_grads[2][rows]})}
    rec = {"part": "c", "rank": dist.get_rank(), "launches": launches,
           "ms": start.elapsed_time(end),
           "capacity": max(1, int(MOE_CF * MOE_TOKENS / MOE_EXPERTS)),
           "dropped_share": dropped / float(n * MOE_TOKENS),
           "aux": float(aux.detach()), "worst": worst}
    faults = ["moe: %s is %.3g x max|ref| from the per-token reference, "
              "tolerance %g" % (k, v, CONTEXT_TOL)
              for k, v in worst.items() if not v <= CONTEXT_TOL]
    return rec, faults


def context_worker():
    """One rank of ``phase_context``, started by the port's launcher with
    two ranks on ``cuda:0`` over gloo: parts (a), (b), (c) in turn; prints
    each part's record; raises if any check failed on any rank."""
    from mxnet_tpu_torch.parallel import init_process_group
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = init_process_group(backend="gloo")
    faults = []
    try:
        for part in (context_part_a, context_part_b, context_part_c):
            rec, bad = part(dev)
            emit("context-worker: " + json.dumps(rec))
            faults += bad
            gc.collect()
            torch.cuda.empty_cache()
            dist.barrier()
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, faults)
    finally:
        dist.destroy_process_group()
    every = [f for fs in every for f in fs]
    if every:
        raise RuntimeError("context: " + "; ".join(every))


def context_launch(timeout=CONTEXT_TIMEOUT):
    """``python -m mxnet_tpu_torch.tools.launch -n 2`` over
    ``chip_smoke.py --context-worker`` in a session of its own (killed,
    workers and all, past ``timeout``); returns the records and seconds."""
    import signal
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n", "2",
           "--launcher", "local", "--", sys.executable,
           os.path.join(root, "chip_smoke.py"), "--context-worker"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
    secs = time.perf_counter() - t0
    recs = [json.loads(line[len("context-worker: "):])
            for line in out.splitlines()
            if line.startswith("context-worker: ")]
    if proc.returncode != 0 or len(recs) != 6:
        raise RuntimeError("context: the launcher exited %s after %.1f s "
                           "with %d of 6 records:\n%s\n%s" % (
                               proc.returncode, secs, len(recs),
                               out[-4000:], err[-6000:]))
    return recs, secs


def phase_context(smi, fwd):
    """Sequence, pipeline and expert parallelism (``parallel/ring.py``,
    ``pipeline.py``, ``moe.py``, ``collectives.py``), no kernel of their
    own: K1-K3 run on every ring hop, in Ulysses' local attention and in
    the pipeline's stages, and are counted under ``context``.  Two ranks
    on ``cuda:0`` over gloo (NCCL refuses two ranks on one card), their
    point-to-point and all-to-all exchanges staged through pinned host
    buffers.  K1's ms a hop are ``phase_kernels``' ``ring-hop`` (whole)
    and ``ring-hop-diag`` (causal) cases, ``fwd``: rank r runs one diagonal
    hop and r whole ones a layer.  Returns every kernel's launches in (a)'s
    ring and Ulysses runs, (b)'s pipeline and (c)'s MoE, summed over the
    ranks."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    recs, secs = context_launch()
    diag = fwd[("ring-hop-diag", torch.float32)]["kernel_ms"]
    whole = fwd[("ring-hop", torch.float32)]["kernel_ms"]
    launches = {}
    for rec in sorted(recs, key=lambda r: (r["part"], r["rank"])):
        if rec["part"] == "a":
            rec["k1_hop_ms"] = {"diag": diag,
                                "full": whole if rec["rank"] else None}
        log("context: (%s) %s" % (rec["part"], json.dumps(rec)))
        paths = [rec["ring"], rec["ulysses"]] if rec["part"] == "a" else \
            [rec]
        for path in paths:
            for k, v in path["launches"].items():
                launches[k] = launches.get(k, 0) + v
    log("context: %s" % json.dumps({"launches": launches, "job_s": secs,
                                    "phase_s": time.perf_counter() - t_phase,
                                    "card": smi}))
    return launches


# ---------------------------------------------------------------------------
# 20. tensor and FSDP parallelism
# ---------------------------------------------------------------------------

#: BERT-base at full width, fp32, T = SEQ_LEN, batch 8, random weights from
#: the seed and phase_train's MLM loss, on two gloo ranks of the one card
TENSOR_BATCH, TENSOR_STEPS = 8, 3
TENSOR_TOL = 1e-4               # x max|ref|: first-step parameters
TENSOR_LOSS_RTOL = 2e-4         # the reference's rule for losses
#: the first gradient where no parameter's rounding hides it: SGD's
#: momentum after one step is -lr x g, Adam's moments are 0.1 x g and
#: 0.001 x g^2.  Each tensor against the one-process run's by norm,
#: ||got - want|| / ||want||: the port's fp32 rule; under int8 an element
#: whose sum rounds otherwise lands on the neighbouring level, 1/127 of its
#: block's max away, and g^2 doubles that
TENSOR_GRAD_RTOL = 1e-4
TENSOR_INT8_GRAD_RTOL = 2e-2
#: each parameter's change from init against the one-process run's by
#: norm, ||got - want|| / ||want - init||: a change that differs by
#: rounding may land on the neighbouring fp32 value of the parameter, an
#: ulp of it against a change of lr x |g|, and Adam's first step maps a
#: gradient within its eps (1e-8) of 0 (the key bias's is 0 up to
#: rounding) to a change that rounding decides
TENSOR_CHANGE_RTOL = 1e-2
#: (b)'s Adam lr: a gradient within rounding (or, under int8, within one
#: quantisation step) of 0 may take the other sign on the other side, and
#: Adam's first step moves such a parameter by up to 2 x lr whatever the
#: gradient's size; at this lr that is under TENSOR_TOL x max|ref| (the
#: LayerNorm gains are 1)
TENSOR_ADAM_LR = 1e-5
TENSOR_TIMEOUT = 300            # seconds each part's launcher may take


def tensor_net(dev):
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon.model_zoo.bert import bert_12_768_12
    net = bert_12_768_12(vocab_size=VOCAB, max_length=SEQ_LEN, dropout=0.0,
                         use_classifier=False)
    net.initialize(initializer.Normal(0.02), seed=SEED, device=dev)
    return net


def _tensor_stats(dev, n_steps, step_ms):
    """A rank's figures of one run: step ms (CUDA events), collective
    bytes and host ms a step, peak memory, K1-K4 launches."""
    from mxnet_tpu_torch.ops import _kernels
    from mxnet_tpu_torch.parallel import collectives
    st = collectives.stats()
    return {"step_ms": step_ms,
            "collective_bytes_per_step":
                sum(v["bytes"] for v in st.values()) / n_steps,
            "collective_ms_per_step":
                sum(v["seconds"] for v in st.values()) * 1e3 / n_steps,
            "collectives": st,
            "peak_bytes": torch.cuda.max_memory_allocated(dev),
            "launches": _kernels.launch_counts()}


def _tensor_reset(dev):
    from mxnet_tpu_torch.ops import _kernels
    from mxnet_tpu_torch.parallel import collectives
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    collectives.reset_stats()
    _kernels.reset_launches()


def _timed_steps(run, n):
    """``run()`` n times; (results, CUDA-event ms of each but the
    first)."""
    out, ms = [run()], []
    for _ in range(n - 1):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out.append(run())
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
    return out, ms


def _host(tensors):
    """A copy of each tensor in host memory (a rank's snapshots stay off
    the card, so that its peak memory is the step's)."""
    return {n: v.detach().to("cpu", copy=True) for n, v in tensors.items()}


def _compare(got, want, base=None):
    """Each tensor of ``want`` against ``got`` (either may lie on the
    host; the arithmetic runs on the card, a tensor at a time, in
    float64): ``{"worst", "at", "rels"}`` of ||got - want|| / ||want -
    base|| (``base`` None: 0; a tensor equal on both sides reads 0), for
    :func:`_held`; ``max_abs``, max |got - want| / max |want| over every
    tensor, and ``max_abs_each``, the worst tensor's own.  A tensor that
    ``got`` lacks reads inf."""
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    rels, d_max, w_max, each = {}, 0.0, 0.0, 0.0
    for n, w in want.items():
        if n not in got:
            rels[n] = d_max = each = float("inf")
            continue
        w = w.to(dev).double()
        d = got[n].to(dev).double() - w
        dn, da, wa = float(d.norm()), float(d.abs().max()), \
            float(w.abs().max())
        if base is not None:
            w = w - base[n].to(dev).double()
        ref = float(w.norm())
        rels[n] = 0.0 if dn == 0 else dn / ref if ref else float("inf")
        d_max, w_max = max(d_max, da), max(w_max, wa)
        each = max(each, da / (wa + 1e-30))
    at = max(rels, key=rels.get)
    return {"worst": rels[at], "at": at, "rels": rels,
            "max_abs": d_max / w_max if w_max
            else float("inf") if d_max else 0.0,
            "max_abs_each": each}


def _held(reading, limit):
    """A :func:`_compare` reading against ``limit``, for the record:
    the worst, where, and how many of the tensors are above the limit."""
    rels = reading.pop("rels")
    reading.update(limit=limit, tensors=len(rels),
                   over=sum(1 for v in rels.values() if not v <= limit))
    return reading["worst"] <= limit


def _opt_states(tr):
    """``{"<parameter>[j]": its updater's j-th state}`` of a Trainer,
    copied to the host (Adam's: 0 the first moment, 1 the second)."""
    upd = tr._updaters[0]
    out = {}
    for i, p in enumerate(tr._params):
        st = upd.states.get(i)
        st = () if st is None else st if isinstance(st, (tuple, list)) \
            else (st,)
        for j, s in enumerate(st):
            out["%s[%d]" % (p.name, j)] = s.data
    return _host(out)


def tensor_part_a(dev):
    """(a) ``TrainStep`` over (dp = 1, tp = 2) with the default
    alternation (Dense weights column- and row-parallel in turn, the
    word and position tables vocab-parallel), TENSOR_STEPS SGD-momentum
    steps; rank 0 then runs the one-process ``TrainStep`` on the same
    seeds.  Held after the first step, each tensor against it: the
    parameters within TENSOR_TOL x max|ref|, the momentum (-lr x the
    first gradient) within TENSOR_GRAD_RTOL and the parameters' change
    from init within TENSOR_CHANGE_RTOL by norm; every loss within
    TENSOR_LOSS_RTOL; each rank launched each of K1-K3 once a layer a
    step, and K4 never.  A planted fault, the one-process first step on
    half the batch, must fail the momentum's check."""
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.parallel import TrainStep, collectives, make_mesh
    from mxnet_tpu_torch.parallel.tensor import assemble
    ce = SoftmaxCrossEntropyLoss()

    def loss_fn(outputs, labels):
        return ce(outputs[-1].float(), labels).mean()

    def sgd(mesh=None):
        return TrainStep(net, loss_fn, mesh, device=dev,
                         learning_rate=TRAIN_LR, momentum=TRAIN_MOMENTUM)

    rank = dist.get_rank()
    batch = train_batch_host(TENSOR_BATCH)
    mesh = make_mesh(("dp", "tp"), (1, 2))
    net = tensor_net(dev)
    p0 = _host(dict(net.named_parameters())) if rank == 0 else None
    layers = len(net.encoder.transformer_cells)
    _tensor_reset(dev)
    step = sgd(mesh)
    first = float(step(*batch))
    first_stats = _tensor_stats(dev, 1, None)
    # the whole parameters and momenta (collective); the counters restart
    # after the gathers, so that the later steps' figures are theirs alone
    p1 = _host(step.gathered())
    m1 = _host({n: assemble(v, step.specs[n], mesh) if tuple(step.specs[n])
                else v for n, v in step.opt_state.items()})
    collectives.reset_stats()
    losses, ms = _timed_steps(lambda: float(step(*batch)), TENSOR_STEPS - 1)
    torch.cuda.synchronize()
    losses = [first] + losses
    rec = {"part": "a", "rank": rank, "mesh": dict(mesh.shape),
           "losses": losses,
           "split": sorted(n for n, sp in step.specs.items() if tuple(sp))}
    rec.update(_tensor_stats(dev, TENSOR_STEPS - 1, sum(ms) / len(ms)))
    rec["first_step"] = {k: first_stats[k] for k in (
        "collective_bytes_per_step", "collective_ms_per_step")}
    faults = []
    want = layers * TENSOR_STEPS
    if set(_k123(rec["launches"]).values()) != {want} or any(
            v for k, v in rec["launches"].items() if k not in _FLASH):
        faults.append("(a) rank %d launched %s, expected %d of each of "
                      "K1-K3 and no K4" % (rank, rec["launches"], want))
    del step
    if rank == 0:
        _tensor_reset(dev)
        one = sgd()
        ref = [float(one(*batch))]
        grad = _compare(m1, one.opt_state)
        change = _compare(p1, one.params, p0)
        worst = change["max_abs_each"]
        m1_one = _host(one.opt_state)
        more, ms1 = _timed_steps(lambda: float(one(*batch)),
                                 TENSOR_STEPS - 1)
        ref += more
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
        rec["one_process"] = {"losses": ref,
                              "step_ms": sum(ms1) / len(ms1),
                              "peak_bytes":
                                  torch.cuda.max_memory_allocated(dev)}
        del one
        half = sgd()
        half(*(a[:TENSOR_BATCH // 2] for a in batch))
        planted = _compare(half.opt_state, m1_one)
        del half
        ok = [worst <= TENSOR_TOL, _held(grad, TENSOR_GRAD_RTOL),
              _held(change, TENSOR_CHANGE_RTOL), max(rel) <= TENSOR_LOSS_RTOL]
        caught = not _held(planted, TENSOR_GRAD_RTOL)
        rec.update(first_params_worst=worst, first_grad=grad,
                   first_change=change, loss_rel=rel,
                   planted_half_batch=planted)
        if not all(ok):
            faults.append("(a) tp = 2 against one process: first-step "
                          "parameters %.3g x max|ref| (tolerance %g), "
                          "momentum %s, change from init %s, losses %s "
                          "relative (tolerance %g)" % (
                              worst, TENSOR_TOL, grad, change, rel,
                              TENSOR_LOSS_RTOL))
        if not caught:
            faults.append("(a) the momentum's check passes the first step "
                          "on half the batch: %s" % planted)
    return rec, faults


def tensor_part_b(dev):
    """(b) ``Trainer(params, "adam").make_compiled_step(net, loss,
    layout=SpecLayout(make_mesh(("data", "fsdp"), (1, 2))))``:
    TENSOR_STEPS steps, a ``save`` after the second; then the same with
    ``compression_params={"type": "int8"}``.  Rank 0 runs the one-process
    compiled steps (no layout; for int8, a layout of one rank, whose
    exchange body is the replicated one) on the same seeds.  Held against
    them: every loss within TENSOR_LOSS_RTOL; after the first step the
    parameters within TENSOR_TOL x max|ref| (over every tensor), Adam's
    moments within TENSOR_GRAD_RTOL (int8: TENSOR_INT8_GRAD_RTOL) and the
    parameters' change from init within TENSOR_CHANGE_RTOL, each tensor
    by norm; the per-rank bytes of parameters plus Adam state within 15 %
    of half the one-process figure.  The checkpoint is restored into a
    one-process step (every rank: the load is collective): right after
    the restore its parameters' change from init and its moments are held
    to the uninterrupted one-process run's after its second step, and
    after one more step the parameters to its last within TENSOR_TOL x
    max|ref| and their change from init within TENSOR_CHANGE_RTOL (which
    a lost update count, Adam's bias correction, would miss).  Each rank
    launched each of K1-K3 once a layer a step, and K4 never.  A planted
    fault, the one-process first step on half the batch, must fail the
    moments' check."""
    import tempfile
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.parallel import SpecLayout, make_mesh
    ce = SoftmaxCrossEntropyLoss()

    def loss_fn(outputs, labels):
        return ce(outputs[-1], labels)

    rank = dist.get_rank()
    tok, typ, lab = train_batch_host(TENSOR_BATCH)
    fsdp = SpecLayout(make_mesh(("data", "fsdp"), (1, 2)))
    ck = os.path.join(tempfile.gettempdir(), "tensor_ck_%d" % os.getppid())

    def build(compress=None, kvstore="device"):
        net = tensor_net(dev)
        tr = gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": TENSOR_ADAM_LR},
                           kvstore=kvstore, compression_params=compress)
        return net, tr

    def params(net):
        return _host(dict(net.named_parameters()))

    def run(step, tr, net, n, save_after=None, snap_at=None):
        """n steps: (losses, rank 0's ``{k: {"params", "states"}}`` after
        the first step and after step ``snap_at`` (a step without a
        layout), ms of the later steps, the first step's figures, state
        bytes); a sharded step's parameters and states are gathered for
        the first copy, and the collectives' counters restart after it,
        so that the later steps' figures are theirs alone."""
        from mxnet_tpu_torch.parallel import collectives
        losses, snaps, ms = [], {}, []
        for i in range(n):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            losses.append(float(step.step([tok, typ], lab).data.mean()))
            b.record()
            b.synchronize()
            if i:
                ms.append(a.elapsed_time(b))
            if i == 0:
                stats = _tensor_stats(dev, 1, None)
                state = step.state_bytes()
                if step._layout is not None:
                    step.release()
                collectives.reset_stats()
            if rank == 0 and i + 1 in (1, snap_at):
                snaps[i + 1] = {"params": params(net),
                                "states": _opt_states(tr)}
            if save_after == i + 1:
                step.save(ck)
        return losses, snaps, ms, stats, state

    rec, faults = {"part": "b", "rank": rank, "mesh": dict(fsdp.mesh.shape)}, []
    layers = 12
    p0 = None
    for name, compress in (("fsdp", None), ("fsdp_int8", {"type": "int8"})):
        _tensor_reset(dev)
        net, tr = build(compress)
        if p0 is None and rank == 0:
            p0 = params(net)
        step = tr.make_compiled_step(net, loss_fn, layout=fsdp)
        losses, got, ms, first, state = run(
            step, tr, net, TENSOR_STEPS,
            save_after=2 if compress is None else None)
        torch.cuda.synchronize()
        part = {"losses": losses, "state_bytes": state,
                "compiled": step.compiled}
        part.update(_tensor_stats(dev, TENSOR_STEPS - 1, sum(ms) / len(ms)))
        part["first_step"] = {k: first[k] for k in (
            "collective_bytes_per_step", "collective_ms_per_step")}
        want = layers * TENSOR_STEPS
        if set(_k123(part["launches"]).values()) != {want} or any(
                v for k, v in part["launches"].items() if k not in _FLASH):
            faults.append("(b) %s: rank %d launched %s, expected %d of "
                          "each of K1-K3 and no K4" % (name, rank,
                                                       part["launches"],
                                                       want))
        step.release()
        del step, tr, net
        if rank == 0:
            _tensor_reset(dev)
            one_layout = None if compress is None else SpecLayout(
                make_mesh(("data", "fsdp"), (1, 1), devices=[0]))
            net1, tr1 = build(compress, kvstore=None)
            one = tr1.make_compiled_step(net1, loss_fn, layout=one_layout)
            ref, snaps, ms1, _, state1 = run(
                one, tr1, net1, TENSOR_STEPS,
                snap_at=2 if compress is None else None)
            rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
            grad = _compare(got[1]["states"], snaps[1]["states"])
            change = _compare(got[1]["params"], snaps[1]["params"], p0)
            worst = change["max_abs"]
            ratio = state1 / state
            grad_tol = TENSOR_GRAD_RTOL if compress is None \
                else TENSOR_INT8_GRAD_RTOL
            ok = [max(rel) <= TENSOR_LOSS_RTOL, worst <= TENSOR_TOL,
                  _held(grad, grad_tol), _held(change, TENSOR_CHANGE_RTOL),
                  0.85 * 2 <= ratio <= 1.15 * 2]
            part.update(one_process={
                "losses": ref, "step_ms": sum(ms1) / len(ms1),
                "state_bytes": state1,
                "peak_bytes": torch.cuda.max_memory_allocated(dev)},
                loss_rel=rel, first_params_worst=worst, first_grad=grad,
                first_change=change, bytes_ratio=ratio)
            if not all(ok):
                faults.append("(b) %s against one process: losses %s "
                              "relative (tolerance %g), first-step "
                              "parameters %.3g x max|ref| (tolerance %g), "
                              "moments %s, change from init %s, state "
                              "bytes %.3g x fewer (want 2 +- 15 %%)"
                              % (name, rel, TENSOR_LOSS_RTOL, worst,
                                 TENSOR_TOL, grad, change, ratio))
            if one_layout is not None:
                one.release()
            if compress is None:
                at2, final = snaps[2], params(net1)
            del one, tr1, net1
            if compress is None:
                net3, tr3 = build(kvstore=None)
                half = tr3.make_compiled_step(net3, loss_fn)
                h = TENSOR_BATCH // 2
                half.step([tok[:h], typ[:h]], lab[:h])
                planted = _compare(_opt_states(tr3), snaps[1]["states"])
                part["planted_half_batch"] = planted
                if _held(planted, TENSOR_GRAD_RTOL):
                    faults.append("(b) the moments' check passes the first "
                                  "step on half the batch: %s" % planted)
                del half, tr3, net3
        rec[name] = part
    # the checkpoint of the fsdp run's second step, into one process
    gc.collect()
    torch.cuda.empty_cache()
    net2, tr2 = build(kvstore=None)
    two = tr2.make_compiled_step(net2, loss_fn)
    two.restore(ck)
    if rank == 0:
        restored = {
            "change": _compare(params(net2), at2["params"], p0),
            "moments": _compare(_opt_states(tr2), at2["states"])}
    two.step([tok, typ], lab)
    if rank == 0:
        restored["next_change"] = _compare(params(net2), final, p0)
        worst = restored["next_change"]["max_abs"]
        ok = [worst <= TENSOR_TOL,
              _held(restored["change"], TENSOR_CHANGE_RTOL),
              _held(restored["moments"], TENSOR_GRAD_RTOL),
              _held(restored["next_change"], TENSOR_CHANGE_RTOL)]
        rec.update(restored_worst=worst, restored=restored)
        if not all(ok):
            faults.append("(b) the fsdp checkpoint restored into one "
                          "process: %s; one step on, %.3g x max|ref| from "
                          "the uninterrupted run (tolerance %g)"
                          % (restored, worst, TENSOR_TOL))
        shutil.rmtree(ck, ignore_errors=True)
    return rec, faults


def tensor_worker(part):
    """One rank of ``phase_tensor``'s part ``a`` or ``b``, started by the
    port's launcher with two ranks on ``cuda:0`` over gloo; prints the
    part's record; raises if a check failed on any rank."""
    from mxnet_tpu_torch.parallel import init_process_group
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = init_process_group(backend="gloo")
    try:
        rec, faults = {"a": tensor_part_a, "b": tensor_part_b}[part](dev)
        emit("tensor-worker: " + json.dumps(rec))
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, faults)
    finally:
        dist.barrier()
        dist.destroy_process_group()
    every = [f for fs in every for f in fs]
    if every:
        raise RuntimeError("tensor: " + "; ".join(every))


def tensor_launch(part, timeout=TENSOR_TIMEOUT):
    """``python -m mxnet_tpu_torch.tools.launch -n 2`` over
    ``chip_smoke.py --tensor-worker <part>`` in a session of its own
    (killed, workers and all, past ``timeout``); returns the records and
    seconds."""
    import signal
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n", "2",
           "--launcher", "local", "--", sys.executable,
           os.path.join(root, "chip_smoke.py"), "--tensor-worker", part]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
    secs = time.perf_counter() - t0
    recs = [json.loads(line[len("tensor-worker: "):])
            for line in out.splitlines()
            if line.startswith("tensor-worker: ")]
    if proc.returncode != 0 or len(recs) != 2:
        raise RuntimeError("tensor (%s): the launcher exited %s after %.1f "
                           "s with %d of 2 records:\n%s\n%s" % (
                               part, proc.returncode, secs, len(recs),
                               out[-4000:], err[-6000:]))
    return recs, secs


def phase_tensor(smi):
    """Tensor and FSDP parallelism (``parallel/speclayout.py``,
    ``parallel/tensor.py``, ``step.py``): (a) ``TrainStep`` over (dp = 1,
    tp = 2), (b) the sharded ``CompiledStep`` over (data = 1, fsdp = 2),
    plain and int8, each two gloo ranks on ``cuda:0`` (NCCL refuses two
    ranks on one card) against one process.  No kernel of their own:
    K1-K3 run in BERT's attention (heads whole on every rank) and are
    counted under ``tensor``.  Returns every kernel's launches, summed
    over the ranks and parts."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    launches, secs = {}, {}
    for part in ("a", "b"):
        recs, secs[part] = tensor_launch(part)
        for rec in sorted(recs, key=lambda r: r["rank"]):
            log("tensor: (%s) %s" % (part, json.dumps(rec)))
            runs = [rec] if part == "a" else [rec["fsdp"],
                                              rec["fsdp_int8"]]
            for run in runs:
                for k, v in run["launches"].items():
                    launches[k] = launches.get(k, 0) + v
    log("tensor: %s" % json.dumps({"launches": launches, "jobs_s": secs,
                                   "phase_s": time.perf_counter() - t_phase,
                                   "card": smi}))
    return launches


# ---------------------------------------------------------------------------
# 21. parameters with a copy on each of several contexts in one process
# ---------------------------------------------------------------------------

#: BERT-base at full width, fp32, T = SEVERAL_T, a copy on each of two
#: contexts with SEVERAL_BATCH / 2 samples a copy, dropout 0, SGD
SEVERAL_T, SEVERAL_BATCH, SEVERAL_STEPS = 128, 4, 3
#: the first reduced gradient against one context's on the whole batch,
#: each tensor by norm, ||got - want|| / ||want||: the port's fp32 rule
SEVERAL_GRAD_RTOL = 1e-4
#: each parameter's change from init against one context's, by norm
#: (TENSOR_CHANGE_RTOL's reasons)
SEVERAL_CHANGE_RTOL = 1e-2
#: the two copies after every step, max |gpu - other| / max |gpu| over a
#: tensor: each copy applies the one reduced gradient with its own
#: context's arithmetic (the card's fused multiply-adds against the
#: host's), so they are equal to an ulp or so, not bitwise
SEVERAL_COPY_RTOL = 1e-6
#: the compiled lane against the eager loop, each tensor by norm against
#: its change from init
SEVERAL_COMPILED_RTOL = 1e-5


def several_contexts():
    """The two contexts of :func:`phase_several` and why: two cards where
    the machine has them; else the card and the host, the only two devices
    a one-card machine has (upstream MXNet takes that mix, and the store
    reduces on the first copy's device), which is no fallback."""
    import mxnet_tpu_torch as mx
    if torch.cuda.device_count() >= 2:
        return [mx.gpu(0), mx.gpu(1)], "two cards"
    return [mx.gpu(0), mx.cpu(0)], (
        "one card: its copy and a copy on the host, the second device "
        "this machine has")


def several_batch_host():
    rng = np.random.RandomState(SEED + 21)
    tok = rng.randint(0, VOCAB, size=(SEVERAL_BATCH, SEVERAL_T))
    lab = rng.randint(0, VOCAB, size=(SEVERAL_BATCH, SEVERAL_T))
    return tok.astype(np.int64), np.zeros_like(tok, np.int64), \
        lab.astype(np.int64)


def several_net(ctxs):
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon.model_zoo.bert import bert_12_768_12
    net = bert_12_768_12(vocab_size=VOCAB, max_length=SEQ_LEN, dropout=0.0,
                         use_classifier=False)
    net.initialize(initializer.Normal(0.02), seed=SEED, device=ctxs)
    return net


def _copy_gap(net):
    """max over tensors of max |copy 0 - copy d| / max |copy 0|, and the
    tensor that reaches it."""
    worst, at = 0.0, None
    for n, p in net.collect_params().items():
        ds = [d.data.detach() for d in p.list_data()]
        ref = ds[0].double()
        for d in ds[1:]:
            gap = float((d.to(ref.device).double() - ref).abs().max()) / \
                max(float(ref.abs().max()), 1e-30)
            if not gap <= worst:
                worst, at = gap, n
    return worst, at


def phase_several(smi):
    """Parameters with a copy on each of two contexts in one process
    (``Parameter.initialize(ctx=[...])``, ``gluon.Trainer`` over the copies
    with ``kvstore="device"``, ``make_compiled_step`` over them): BERT-base
    fp32 at T = SEVERAL_T, SEVERAL_BATCH samples split over the copies,
    SGD lr TRAIN_LR, momentum TRAIN_MOMENTUM, SEVERAL_STEPS steps of the
    eager loop (``split_and_load``, a forward and backward a copy,
    ``Trainer.step``), then the same start through the compiled lane.  The
    card's copy runs K1-K3; the host's the plain attention, the port's CPU
    route.  Held against one context (``gpu(0)``) on the whole batch: the
    first reduced gradient (SEVERAL_GRAD_RTOL), the change from init
    (SEVERAL_CHANGE_RTOL), the copies after every step
    (SEVERAL_COPY_RTOL), the compiled lane against the eager loop
    (SEVERAL_COMPILED_RTOL); a planted fault, one copy's gradient alone
    (half the batch), must fail the gradient's check.  Returns the kernel
    launches of the two several-context runs."""
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.ops import _kernels
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctxs, why = several_contexts()
    log("several: contexts %s (%s)" % (ctxs, why))
    ce = SoftmaxCrossEntropyLoss()

    def loss_fn(outputs, labels):
        return ce(outputs[-1], labels)

    host = several_batch_host()
    opt = {"learning_rate": TRAIN_LR, "momentum": TRAIN_MOMENTUM}

    def params(net):
        return _host({n: p.list_data()[0].data
                      for n, p in net.collect_params().items()})

    def grads(net, d=0):
        return _host({n: p.list_grad()[d].data
                      for n, p in net.collect_params().items()
                      if p.grad_req != "null"})

    def eager_step(net, tr, cs, first=False):
        parts = [gluon.utils.split_and_load(a, cs) for a in host]
        with autograd.record():
            losses = [loss_fn(net(t, s), y) for t, s, y in zip(*parts)]
        autograd.backward(losses)
        snap = None
        if first:
            snap = grads(net)           # this copy's own, before the merge
            tr.allreduce_grads()
            tr.update(SEVERAL_BATCH)
        else:
            tr.step(SEVERAL_BATCH)
        return [float(l.asnumpy().sum()) for l in losses], snap

    # one context on the whole batch: the yardstick
    one = several_net(ctxs[:1])
    p0 = params(one)
    tr1 = gluon.Trainer(one.collect_params(), "sgd", dict(opt))
    one_losses, g_one = [], None
    for i in range(SEVERAL_STEPS):
        ls, _ = eager_step(one, tr1, ctxs[:1])
        if i == 0:
            g_one = grads(one)
        one_losses.append(sum(ls))
    p_one = params(one)
    del one, tr1
    gc.collect()
    torch.cuda.empty_cache()

    # --- the several-context main path, counted ---
    torch.cuda.synchronize()
    _kernels.reset_launches()
    net = several_net(ctxs)
    tr = gluon.Trainer(net.collect_params(), "sgd", dict(opt),
                       kvstore="device")
    losses, copy_gaps, ms = [], [], []
    g_own = g_reduced = None
    for i in range(SEVERAL_STEPS):
        t0 = time.perf_counter()
        ls, own = eager_step(net, tr, ctxs, first=i == 0)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            g_own, g_reduced = own, grads(net)
        losses.append(sum(ls))
        copy_gaps.append(_copy_gap(net))
    p_eager = params(net)
    del net, tr
    gc.collect()
    cnet = several_net(ctxs)
    ctr = gluon.Trainer(cnet.collect_params(), "sgd", dict(opt),
                        kvstore="device")
    step = ctr.make_compiled_step(cnet, loss_fn)
    c_losses, c_ms = [], []
    for i in range(SEVERAL_STEPS):
        t0 = time.perf_counter()
        out = step.step(list(host[:2]), host[2], batch_size=SEVERAL_BATCH)
        torch.cuda.synchronize()
        c_ms.append((time.perf_counter() - t0) * 1e3)
        c_losses.append(float(out.asnumpy().sum()))
    counts = _kernels.launch_counts()
    # --- end of the counted main path ---
    c_gap = _copy_gap(cnet)
    p_comp = params(cnet)
    compiled = step.compiled
    del cnet, ctr, step
    gc.collect()
    torch.cuda.empty_cache()

    grad = _compare(g_reduced, g_one)
    planted = _compare(g_own, g_one)
    change = _compare(p_eager, p_one, p0)
    comp = _compare(p_comp, p_eager, p0)
    rec = {"contexts": [str(c) for c in ctxs], "why": why,
           "batch": SEVERAL_BATCH, "seq": SEVERAL_T,
           "losses": losses, "one_context_losses": one_losses,
           "compiled_losses": c_losses, "compiled": compiled,
           "eager_step_ms": ms, "compiled_step_ms": c_ms,
           "copy_gaps": [g for g, _ in copy_gaps],
           "copy_gap_at": [a for _, a in copy_gaps],
           "compiled_copy_gap": c_gap[0], "launches": _k123(counts),
           "card": smi}
    ok = [_held(grad, SEVERAL_GRAD_RTOL), _held(change, SEVERAL_CHANGE_RTOL),
          all(g <= SEVERAL_COPY_RTOL for g, _ in copy_gaps + [c_gap]),
          _held(comp, SEVERAL_COMPILED_RTOL), compiled]
    caught = not _held(planted, SEVERAL_GRAD_RTOL)
    rec.update(first_grad=grad, change=change, compiled_vs_eager=comp,
               planted_one_copy=planted)
    log("several: %s" % json.dumps(rec))
    log("several: first reduced gradient %.3g (limit %g); planted fault, "
        "one copy's gradient alone, %.3g (must exceed the limit); change "
        "from init %.3g (limit %g); copies %.3g (limit %g); compiled "
        "against eager %.3g (limit %g); phase %.1f s"
        % (grad["worst"], SEVERAL_GRAD_RTOL, planted["worst"],
           change["worst"], SEVERAL_CHANGE_RTOL,
           max(g for g, _ in copy_gaps + [c_gap]), SEVERAL_COPY_RTOL,
           comp["worst"], SEVERAL_COMPILED_RTOL,
           time.perf_counter() - t_phase))
    if not all(np.isfinite(losses + c_losses)):
        raise RuntimeError("several: losses %s %s are not all finite"
                           % (losses, c_losses))
    if not all(ok):
        raise RuntimeError("several: against one context: gradient %s, "
                           "change %s, copies %s / %s, compiled %s (%s)"
                           % (grad, change, copy_gaps, c_gap, comp,
                              compiled))
    if not caught:
        raise RuntimeError("several: the gradient's check passes one copy's "
                           "gradient alone: %s" % planted)
    if min(_k123(counts).values()) < 1:
        raise RuntimeError("several: the card's copy launched %s; K1-K3 "
                           "must run in its attention" % counts)
    return counts


# ---------------------------------------------------------------------------
# 22. ResNet-50 data-parallel: global batch statistics in the dp TrainStep
# ---------------------------------------------------------------------------

#: the port's copy of examples/train_resnet_dp.py: resnet50_v1, two gloo
#: ranks on the card, RESNET_DP_BATCH samples a rank, RESNET_DP_STEPS steps
RESNET_DP_BATCH, RESNET_DP_STEPS = 8, 3
#: the checks, each tensor by norm, run in float64: at its initialisation
#: this net amplifies rounding ~1000x through the training-mode
#: BatchNorms, so fp32 one-process runs miss float64 by percents
#: (resnet_fp32_checks), and a dp step differs from one process by the
#: same; the fp32 workload's readings are logged beside that floor
RESNET_DP_GRAD_RTOL = 1e-4      # the momentum after one step (-lr x g)
RESNET_DP_CHANGE_RTOL = 1e-2    # the change from init after the steps
RESNET_DP_STATS_RTOL = 1e-4     # the first step's batch statistics
RESNET_DP_TIMEOUT = 300


def biases_under_norms(net):
    """The structural names of the biases of layers whose output goes
    straight into a BatchNorm (a conv bias of ``resnet50_v1``'s bottleneck):
    the normalisation takes the bias out again, so their gradient is 0 up
    to rounding, and a norm relative to it measures rounding alone."""
    from mxnet_tpu_torch.gluon.nn import BatchNorm
    out = set()
    for prefix, m in net.named_modules():
        kids = list(m.named_children())
        for (name, a), (_, b) in zip(kids, kids[1:]):
            if isinstance(b, BatchNorm) and \
                    a._parameters.get("bias") is not None:
                out.add("%s%s.bias" % (prefix + "." if prefix else "", name))
    return out


def _split_zero(tensors, zero):
    return {n: v for n, v in tensors.items() if n not in zero}


def _zero_reading(got, want, zero):
    """max over the ``zero`` tensors of ||got|| and ||want||, each over
    the largest norm of a tensor of ``want``."""
    top = max(float(v.double().norm()) for v in want.values())
    return max(max(float(got[n].double().norm()),
                   float(want[n].double().norm())) for n in zero) / top


def _stats_tree(stats):
    """``{"<i>.mean", "<i>.var"}`` of a list of per-BatchNorm (mean,
    var)."""
    return {"%d.%s" % (i, k): st[j].double()
            for i, st in enumerate(stats)
            for j, k in ((0, "mean"), (1, "var"))}


def resnet_dp_worker():
    """One rank of :func:`phase_resnet_dp`, under the port's launcher (two
    ranks on ``cuda:0`` over gloo): ``TrainStep`` over dp = 2 of
    ``resnet50_v1`` on its half of the global batch, RESNET_DP_STEPS steps
    in fp32 (the workload: timed, its collectives counted), then in
    float64 (the checks).  Rank 0 then runs the one-process steps on the
    whole batch in both dtypes, and in float64 one step on each half alone
    (the planted fault: each rank normalising by its own shard's
    statistics).  Prints its record; raises if a check failed on any
    rank."""
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.gluon.nn import BatchNorm
    from mxnet_tpu_torch.ops import _kernels
    from mxnet_tpu_torch.parallel import (TrainStep, collectives,
                                          init_process_group, make_mesh)
    ce = SoftmaxCrossEntropyLoss()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = init_process_group(backend="gloo")
    rank = dist.get_rank()
    x32, y = resnet_batch_host(2 * RESNET_DP_BATCH)
    x64 = x32.astype(np.float64)
    half = slice(rank * RESNET_DP_BATCH, (rank + 1) * RESNET_DP_BATCH)

    def build(dtype="float32"):
        net = resnet50_v1(classes=RESNET_CLASSES)
        net.initialize(initializer.Xavier(), seed=SEED, device=dev)
        return net if dtype == "float32" else net.cast(dtype)

    def loss64(logits, labels):
        # the float64 checks take the loss in float64 too
        return ce(logits, labels).mean()

    def sgd(net, mesh=None):
        dt = next(net.parameters()).dtype
        return TrainStep(net, resnet_loss if dt == torch.float32 else loss64,
                         mesh, device=dev, learning_rate=RESNET_LR,
                         momentum=RESNET_MOMENTUM)

    def dp_run(dtype, x):
        """RESNET_DP_STEPS dp steps: (losses, first momenta, first batch
        statistics, parameters, ms of the timed steps, the BatchNorm
        collectives a later step, the parameters' bytes)."""
        step = sgd(build(dtype), make_mesh())
        losses = [float(step(x[half], y[half]))]
        m1 = _host(step.opt_state)
        stats = [tuple(t.detach().cpu() for t in st)
                 for st in step.batch_stats]
        collectives.reset_stats()
        more, ms = _timed_steps(lambda: float(step(x[half], y[half])),
                                RESNET_DP_STEPS - 1)
        bn = {k: v / (RESNET_DP_STEPS - 1) for k, v in collectives.stats(
            ).get("batch_norm", {"bytes": 0, "calls": 0}).items()}
        nbytes = sum(p.numel() * p.element_size()
                     for p in step.params.values())
        return losses + more, m1, stats, _host(step.params), ms, bn, nbytes

    def one_run(dtype, x, steps):
        """The one-process steps on the whole batch: (losses, first
        momenta, the first step's batch statistics at every BatchNorm's
        input, in float64, parameters)."""
        seen = []
        net = build(dtype)
        hooks = [m.register_forward_pre_hook(
            lambda m, a: seen.append(torch.var_mean(
                a[0].detach().double(), dim=(0, 2, 3), correction=0)[::-1]))
            for m in net.modules() if isinstance(m, BatchNorm)]
        step = sgd(net)
        losses = [float(step(x, y))]
        for h in hooks:
            h.remove()
        m1 = _host(step.opt_state)
        losses += [float(step(x, y)) for _ in range(steps - 1)]
        return losses, m1, seen, _host(step.params)

    p0 = {n: v.double() for n, v in _host(dict(
        build().named_parameters())).items()} if rank == 0 else None
    _tensor_reset(dev)
    losses, m32, stats32, p32, ms, bn, nbytes = dp_run("float32", x32)
    rec = {"rank": rank, "losses": losses, "step_ms": sum(ms) / len(ms),
           "batch_norm_bytes_per_step": bn["bytes"],
           "batch_norm_calls_per_step": bn["calls"],
           "gradient_exchange_bytes_per_step": nbytes,
           "batch_norms": len(stats32),
           "peak_bytes": torch.cuda.max_memory_allocated(dev),
           "launches": _kernels.launch_counts()}
    losses64, m64, stats64, p64, _, _, _ = dp_run("float64", x64)
    rec["losses_float64"] = losses64
    faults = []
    if any(rec["launches"].values()):
        faults.append("rank %d launched %s; none of K1-K4 is on the path"
                      % (rank, rec["launches"]))
    if rank == 0:
        _tensor_reset(dev)
        zero = biases_under_norms(build())
        one32, m_one32, seen32, p_one32 = one_run("float32", x32,
                                                  RESNET_DP_STEPS)
        one64, m_one64, seen64, p_one64 = one_run("float64", x64,
                                                  RESNET_DP_STEPS)
        # the planted fault: each half's own statistics, the momenta of
        # the two one-process steps averaged (what the ranks' all-reduce
        # of unsynchronised gradients gives)
        planted_m = None
        for r in range(2):
            h = sgd(build("float64"))
            sl = slice(r * RESNET_DP_BATCH, (r + 1) * RESNET_DP_BATCH)
            h(x64[sl], y[sl])
            mom = _host(h.opt_state)
            planted_m = mom if planted_m is None else {
                n: (planted_m[n] + mom[n]) / 2 for n in mom}
            del h

        def trained(t):
            return _split_zero(t, zero)

        # the checks, in float64
        grad = _compare(trained(m64), trained(m_one64))
        zero_grad = _zero_reading(m64, m_one64, zero)
        planted = _compare(trained(planted_m), trained(m_one64))
        change = _compare(trained(p64), trained(p_one64), p0)
        stats = _compare(_stats_tree(stats64), _stats_tree(seen64))
        running = _compare(
            {n: v for n, v in {**p32, **p64}.items()
             if n.endswith(RESNET_STATS)},
            {n: p0[n] for n in p0 if n.endswith(RESNET_STATS)})
        # the fp32 workload's readings, and the fp32 floor: the one-process
        # fp32 run against float64
        fp32 = {"first_grad": _compare(trained(m32), trained(m_one32)),
                "first_grad_to_float64": _compare(trained(m32),
                                                  trained(m_one64)),
                "floor_one_process_to_float64": _compare(
                    trained(m_one32), trained(m_one64)),
                "change": _compare(trained(p32), trained(p_one32), p0),
                "batch_stats": _compare(_stats_tree(stats32),
                                        _stats_tree(seen32)),
                "loss_rel": [abs(a - b) / abs(b)
                             for a, b in zip(losses, one32)]}
        for v in fp32.values():
            if isinstance(v, dict):
                v.pop("rels")
        rec.update(one_process={"losses": one32, "losses_float64": one64},
                   float64={"first_grad": grad, "change": change,
                            "batch_stats": stats,
                            "biases_under_norms": len(zero),
                            "biases_under_norms_momentum": zero_grad,
                            "planted_local_stats": planted},
                   running_stats=running, fp32=fp32)
        ok = [_held(grad, RESNET_DP_GRAD_RTOL),
              zero_grad <= RESNET_DP_GRAD_RTOL,
              _held(change, RESNET_DP_CHANGE_RTOL),
              _held(stats, RESNET_DP_STATS_RTOL),
              _held(running, 0.0), len(seen64) == len(stats64) > 0,
              all(np.isfinite(losses + losses64))]
        if not all(ok):
            faults.append("dp = 2 against one process (float64): momentum "
                          "%s, biases under norms %.3g, change %s, batch "
                          "statistics %s, running statistics %s, %d of %d "
                          "BatchNorms seen, losses %s %s" % (
                              grad, zero_grad, change, stats, running,
                              len(stats64), len(seen64), losses, losses64))
        if _held(planted, RESNET_DP_GRAD_RTOL):
            faults.append("the momentum's check passes each rank's own "
                          "statistics: %s" % planted)
    emit("resnet-dp-worker: " + json.dumps(rec))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, faults)
    every = [f for fs in every for f in fs]
    if every:
        raise RuntimeError("resnet_dp: " + "; ".join(every))


def phase_resnet_dp(smi):
    """The port's copy of ``examples/train_resnet_dp.py``: ``resnet50_v1``
    (1000 classes, 224 x 224) through the dp ``TrainStep`` over two gloo
    ranks on ``cuda:0``, every BatchNorm on the global batch's statistics
    (:func:`resnet_dp_worker`), started through the port's launcher.
    Returns every kernel's launches, summed over the ranks (none of K1-K4
    is on this path)."""
    import signal
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n", "2",
           "--launcher", "local", "--", sys.executable,
           os.path.join(root, "chip_smoke.py"), "--resnet-dp-worker"]
    proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=RESNET_DP_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
    secs = time.perf_counter() - t_phase
    recs = [json.loads(line[len("resnet-dp-worker: "):])
            for line in out.splitlines()
            if line.startswith("resnet-dp-worker: ")]
    if proc.returncode != 0 or len(recs) != 2:
        raise RuntimeError("resnet_dp: the launcher exited %s after %.1f s "
                           "with %d of 2 records:\n%s\n%s" % (
                               proc.returncode, secs, len(recs),
                               out[-4000:], err[-6000:]))
    launches = {}
    for rec in sorted(recs, key=lambda r: r["rank"]):
        log("resnet_dp: %s" % json.dumps(rec))
        for k, v in rec["launches"].items():
            launches[k] = launches.get(k, 0) + v
    r0 = [r for r in recs if r["rank"] == 0][0]
    c64, c32 = r0["float64"], r0["fp32"]
    log("resnet_dp: float64: first momentum %.3g (limit %g) over %d "
        "tensors, the %d biases under a BatchNorm %.3g of the largest "
        "momentum's norm (limit %g), change from init %.3g (limit %g), "
        "batch statistics %.3g (limit %g), planted fault (each rank's own "
        "statistics) %.3g (must exceed %g); running statistics %.3g (the "
        "step leaves them as they are); fp32: first momentum %.3g from one "
        "process, %.3g from its float64, where one fp32 process is %.3g "
        "from float64; change %.3g, batch statistics %.3g; %.1f ms a step "
        "a rank; phase %.1f s; %s"
        % (c64["first_grad"]["worst"], RESNET_DP_GRAD_RTOL,
           c64["first_grad"]["tensors"], c64["biases_under_norms"],
           c64["biases_under_norms_momentum"], RESNET_DP_GRAD_RTOL,
           c64["change"]["worst"], RESNET_DP_CHANGE_RTOL,
           c64["batch_stats"]["worst"], RESNET_DP_STATS_RTOL,
           c64["planted_local_stats"]["worst"], RESNET_DP_GRAD_RTOL,
           r0["running_stats"]["worst"], c32["first_grad"]["worst"],
           c32["first_grad_to_float64"]["worst"],
           c32["floor_one_process_to_float64"]["worst"],
           c32["change"]["worst"], c32["batch_stats"]["worst"],
           r0["step_ms"], secs, smi))
    return launches


# ---------------------------------------------------------------------------
# 23. decode: the GENERATE path (serve/decode.py, serve/paging.py)
# ---------------------------------------------------------------------------

# the demo LM at two geometries: the reference bench's decode lane
# (bench.py run_decode_bench) and BERT-base's widths.  ``exact``: the
# float32 engines' tokens must equal reference_generate's (a float tie
# aside).  At BERT-base's widths and 12 layers the demo LM is
# ill-conditioned in float32 (its residual stream grows ~400x over the 12
# layers and the attention softmax sharpens with it, so float32's logits
# are ~10-30 % from float64's and two float32 computations that only sum
# in another order part ways): float32 cannot decide the tokens there, so
# that run is measured and gated only on lengths, retraces and KV bytes.
# The exact rule is held there twice: in float64 at 12 layers, and in
# float32 at DECODE_EXACT_LAYERS layers of the same widths (the first
# layers of the same weights, float32 within ~4e-6 of float64's logits).
DECODE_GEOMETRIES = [
    ("bench", dict(dim=8, heads=1, layers=6, slots=8, max_tokens=48,
                   prompt_buckets=(4, 8)),
     dict(long_new=48, short_new=2), True),
    ("bert_base", dict(vocab=VOCAB, dim=768, heads=12, layers=12, slots=32,
                       max_tokens=128, prompt_buckets=(64, 128, 256),
                       prefill_chunk=64),
     dict(long_new=64, short_new=16), False),
]
DECODE_EXACT_LAYERS = 4
DECODE_PROMPTS = 32
DECODE_SHARED = 8               # prompts over one 128-token prefix (wide)
DECODE_SHARED_LEN = 128
DECODE_TIE_REL = 1e-4           # a top-two logit gap below this x max|logit|
DECODE_TIES_PER_1000 = 1        # is a float tie; at most this many
DECODE_STEP_TIMED = 50


def decode_workload(cfg, long_new, short_new, seed):
    """32 seeded prompts and their max_new: a quarter short generations;
    at the wide geometry the first 8 share one 128-token prefix (the
    second is the prefix alone: a full-coverage hit, the copy-on-write
    fork).  The bursts admit the first prompt alone, so its prefix pages
    are published before the others arrive."""
    rng = np.random.RandomState(seed)
    top = cfg.prompt_buckets[-1]
    lo = 2 if top <= 8 else 16
    prompts = [rng.randint(1, cfg.vocab, size=rng.randint(lo, top + 1))
               .tolist() for _ in range(DECODE_PROMPTS)]
    if top >= 2 * DECODE_SHARED_LEN:
        prefix = rng.randint(1, cfg.vocab, size=DECODE_SHARED_LEN).tolist()
        for i in range(min(DECODE_SHARED, DECODE_PROMPTS)):
            extra = 0 if i == 1 else rng.randint(1, top - DECODE_SHARED_LEN)
            prompts[i] = prefix + rng.randint(1, cfg.vocab,
                                              size=extra).tolist()
    news = [short_new if i % 4 == 3 else long_new
            for i in range(DECODE_PROMPTS)]
    return prompts, news


def lm_logits(params, cfg, seq):
    """The demo LM's next-token logits at every position of ``seq``, in
    ``params``' dtype: a causal recompute without any cache."""
    x = params["emb"][torch.tensor(seq, device=params["emb"].device)]
    n = x.shape[0]
    causal = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
    for l in range(cfg.layers):
        def heads(w):
            return (x @ params["l%d.%s" % (l, w)]).reshape(
                n, cfg.heads, cfg.head_dim).transpose(0, 1)
        s = heads("wq") @ heads("wk").transpose(1, 2) / \
            np.sqrt(cfg.head_dim)
        att = torch.softmax(s.masked_fill(~causal, float("-inf")), -1) @ \
            heads("wv")
        x = x + att.transpose(0, 1).reshape(n, cfg.dim) @ \
            params["l%d.wo" % l]
        x = x + torch.clamp_min(x @ params["l%d.w1" % l], 0.0) @ \
            params["l%d.w2" % l]
    return x @ params["unemb"]


def decode_compare(label, got, want, prompts, p64, cfg):
    """The exact rule: each generated list equals the oracle's, or equal
    up to a float tie at the first differing position (the oracle's
    top-two logit gap there, in float64, below ``DECODE_TIE_REL`` x
    max|logit|), after which that sequence is compared no further.
    Returns the ties; any other difference raises."""
    ties, bad = [], []
    for i, (g, w, p) in enumerate(zip(got, want, prompts)):
        if g == w:
            continue
        j = next((k for k, (a, b) in enumerate(zip(g, w)) if a != b),
                 min(len(g), len(w)))
        rel = None
        if j < min(len(g), len(w)):
            logits = lm_logits(p64, cfg, p + w[:j])[-1]
            top2 = torch.topk(logits, 2).values
            rel = float(top2[0] - top2[1]) / float(logits.abs().max())
        if rel is not None and rel < DECODE_TIE_REL:
            ties.append({"seq": i, "pos": j, "rel_gap": rel})
            log("decode: %s: a float tie in sequence %d at position %d "
                "(%.3g of max|logit|)" % (label, i, j, rel))
        else:
            bad.append({"seq": i, "pos": j, "got": g[j:j + 4],
                        "want": w[j:j + 4], "rel_gap": rel})
    if bad:
        raise RuntimeError("decode: %s differs from reference_generate: %s"
                           % (label, bad[:4]))
    return ties


def decode_planted(label, outs, oracle, prompts, p64, cfg):
    """The exact rule on a planted fault: one token of a sequence that
    equals the oracle's, moved to the next vocabulary id, must fail
    :func:`decode_compare`.  Returns where it was planted."""
    i = next(k for k, (g, w) in enumerate(zip(outs, oracle)) if g == w)
    bad = [list(o) for o in outs]
    j = len(bad[i]) // 2
    bad[i][j] = (bad[i][j] + 1) % cfg.vocab
    try:
        decode_compare(label + " planted", bad, oracle, prompts, p64, cfg)
    except RuntimeError:
        return {"seq": i, "pos": j, "failed": True}
    raise RuntimeError("decode: %s: a planted wrong token passed the exact "
                       "rule" % label)


def decode_burst(eng, prompts, news):
    """The first prompt, then, once its first token is out, the rest at
    once; (token lists, seconds, inter-token gaps in ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gens = [eng.submit(prompts[0], max_new=news[0])]
    gens[0].wait_new(0, timeout=60)
    gens += [eng.submit(p, max_new=n) for p, n in zip(prompts[1:],
                                                      news[1:])]
    outs = [g.result(timeout=300) for g in gens]
    dt = time.perf_counter() - t0
    gaps = sorted(t * 1e3 for g in gens for t in g.token_times[1:])
    return outs, dt, gaps


def decode_wire(eng, prompts, news):
    """The burst over the wire: ``serve_forever`` hosting ``eng``, one
    streaming ``ServeClient.generate`` a prompt from its own thread, the
    first alone until its prefill is done; (terminal lists, streamed
    lists, seconds)."""
    from mxnet_tpu_torch.serve import ServeClient, ServeServer, serve_forever
    from mxnet_tpu_torch.telemetry import registry
    port = _free_port()
    state = ServeServer(decode=eng)
    stop_ev, ready = threading.Event(), threading.Event()
    srv = threading.Thread(target=serve_forever, daemon=True, kwargs=dict(
        port=port, state=state, stop_event=stop_ev, bind="127.0.0.1",
        ready_event=ready))
    srv.start()
    if not ready.wait(60):
        raise RuntimeError("decode: the replica did not come up")
    out, streamed, errors = {}, {}, []

    def call(i):
        got = []
        try:
            with ServeClient(["127.0.0.1:%d" % port], timeout=120) as cli:
                out[i] = cli.generate(prompts[i], max_tokens=news[i],
                                      on_token=got.extend)[1]
            streamed[i] = got
        except Exception as e:          # noqa: BLE001 — raised below
            errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(prompts))]
    prefills = registry.value("serve.decode.prefills")
    threads[0].start()
    while registry.value("serve.decode.prefills") == prefills and \
            time.perf_counter() - t0 < 60:
        time.sleep(0.001)
    for t in threads[1:]:
        t.start()
    for t in threads:
        t.join(timeout=300)
    dt = time.perf_counter() - t0
    stop_ev.set()
    srv.join(timeout=30)
    if errors or len(out) != len(prompts):
        raise RuntimeError("decode: GENERATE over the wire failed: %s"
                           % errors[:4])
    return ([out[i] for i in range(len(prompts))],
            [streamed[i] for i in range(len(prompts))], dt)


def decode_step_ms(sv):
    """Device ms of one decode step over every slot (the full bucket),
    CUDA events around each of ``DECODE_STEP_TIMED`` steps: p50, p99."""
    ids = np.arange(sv.config.slots, dtype=np.int32)
    sv._reset_bookkeeping()             # every slot from position 0
    times = []
    for _ in range(DECODE_STEP_TIMED + 3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        sv.dispatch_step(ids)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    sv._reset_bookkeeping()
    times = sorted(times[3:])
    return {"p50": float(np.percentile(times, 50)),
            "p99": float(np.percentile(times, 99))}


def decode_run(label, cfg, params, prompts, news, check):
    """(a) The flat and the paged engine (prefix sharing, chunked prefill)
    built on ``params`` (their dtype is the engines') on the burst; with
    ``check``, every token against ``reference_generate`` (the unbatched
    oracle) in that dtype by the exact rule (:func:`decode_compare`), and
    then (b) the burst over the wire through the paged engine, streamed,
    answering (a)'s lists; without, measured.  Returns the record."""
    from mxnet_tpu_torch.serve.decode import (
        DecodeBatcher, DecodeServable, PagedDecodeBatcher,
        PagedDecodeServable, reference_generate)
    from mxnet_tpu_torch.telemetry import registry
    t0 = time.perf_counter()
    oracle = [reference_generate(p, n, params=params, config=cfg)
              for p, n in zip(prompts, news)] if check else None
    n_tokens = sum(news)
    rec = {"dtype": str(params["emb"].dtype), "layers": cfg.layers,
           "tokens": n_tokens, "held": bool(check),
           "oracle_s": time.perf_counter() - t0}
    p64 = {k: v.double() for k, v in params.items()}
    ties = []
    for engine, sv_cls, eng_cls in (("flat", DecodeServable, DecodeBatcher),
                                    ("paged", PagedDecodeServable,
                                     PagedDecodeBatcher)):
        torch.cuda.reset_peak_memory_stats()
        sv = sv_cls(config=cfg, params=params, device=params["emb"].device)
        if sv.params["emb"].dtype != params["emb"].dtype or \
                sv._state["k"].dtype != params["emb"].dtype:
            raise RuntimeError("decode: %s %s did not keep the parameters' "
                               "dtype" % (label, engine))
        t_warm = time.perf_counter()
        sv.warm()
        t_warm = time.perf_counter() - t_warm
        retraces = sv.retraces
        kv0 = sv.kv_state_bytes()
        cow0 = registry.value("serve.decode.cow_forks")
        shared0 = registry.value("serve.decode.shared_page_hits")
        eng = eng_cls(sv, queue_cap=4 * DECODE_PROMPTS)
        outs, dt, gaps = decode_burst(eng, prompts, news)
        r = {"warm_s": t_warm, "burst_s": dt,
             "tokens_per_s": sum(len(o) for o in outs) / dt,
             "inter_token_p50_ms": float(np.percentile(gaps, 50)),
             "inter_token_p99_ms": float(np.percentile(gaps, 99)),
             "kv_bytes": sv.kv_state_bytes(),
             "serve_retraces": sv.retraces - retraces,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        if [len(o) for o in outs] != list(news):
            raise RuntimeError("decode: %s %s generated other lengths than "
                               "asked" % (label, engine))
        if check:
            ties += decode_compare("%s %s" % (label, engine), outs, oracle,
                                   prompts, p64, cfg)
            r["planted"] = decode_planted(label, outs, oracle, prompts, p64,
                                          cfg)
        if sv.retraces != retraces or sv.kv_state_bytes() != kv0:
            raise RuntimeError("decode: %s %s retraced %d programs or its KV "
                               "bytes moved" % (label, engine,
                                                sv.retraces - retraces))
        if engine == "paged":
            r["page_stats"] = eng.page_stats()
            r["cow_forks"] = registry.value("serve.decode.cow_forks") - cow0
            r["shared_page_hits"] = registry.value(
                "serve.decode.shared_page_hits") - shared0
            if cfg.prompt_buckets[-1] >= 2 * DECODE_SHARED_LEN and not (
                    r["cow_forks"] and r["shared_page_hits"]):
                raise RuntimeError("decode: %s paged shared no prefix page "
                                   "(%r)" % (label, r))
        if engine == "paged" and check:
            # (b) the same burst over the wire, through this engine: the
            # same lists (a sequence with a tie in (a) may part there)
            wire, streamed, wdt = decode_wire(eng, prompts, news)
            tied = {t["seq"] for t in ties}
            if streamed != wire or any(wire[i] != outs[i]
                                       for i in range(len(outs))
                                       if i not in tied):
                raise RuntimeError("decode: %s GENERATE over the wire "
                                   "answered other tokens than the engine"
                                   % label)
            r["wire_burst_s"] = wdt
            r["wire_tokens_per_s"] = sum(len(o) for o in wire) / wdt
        if engine == "flat" and params["emb"].dtype == torch.float32:
            eng.close()
            r["step_ms"] = decode_step_ms(sv)
        eng.close()
        rec[engine] = r
        del eng, sv
        gc.collect()
        torch.cuda.empty_cache()
    # the flat and the paged burst each compare every token
    if len(ties) * 1000 > DECODE_TIES_PER_1000 * 2 * n_tokens:
        raise RuntimeError("decode: %s has %d float ties in %d tokens"
                           % (label, len(ties), n_tokens))
    rec["ties"] = ties
    return rec


def decode_conditioning(kw, params, prompt):
    """float32's distance from float64 at each depth of the model: over
    the positions of ``prompt``, max|logits32 - logits64| / max|logits64|
    of the first 1, 2, ... layers of ``params`` (:func:`lm_logits`)."""
    from mxnet_tpu_torch.serve.decode import DecodeConfig
    p64 = {k: v.double() for k, v in params.items()}
    out = []
    for depth in range(1, kw["layers"] + 1):
        cut = DecodeConfig(**dict(kw, layers=depth))
        l32 = lm_logits(params, cut, prompt).double()
        l64 = lm_logits(p64, cut, prompt)
        out.append(float(((l32 - l64).abs().max(dim=1).values /
                          l64.abs().max(dim=1).values).max()))
    return out


def decode_geometry(label, kw, load, exact, smi):
    """One geometry: :func:`decode_run` in float32, held (``exact``) or
    measured; at a geometry that is not ``exact``, held again in float64
    at the full depth and in float32 at ``DECODE_EXACT_LAYERS`` layers;
    (c) the figures."""
    from mxnet_tpu_torch.serve.decode import DecodeConfig, demo_lm_params
    dev = torch.device("cuda", 0)
    cfg = DecodeConfig(**kw)
    params = demo_lm_params(cfg, dev)
    prompts, news = decode_workload(cfg, seed=SEED, **load)
    rec = {"geometry": label, "config": repr(cfg), "prompts": len(prompts),
           "float32": decode_run(label, cfg, params, prompts, news, exact)}
    if not exact:
        rec["float32_logit_err_by_depth"] = decode_conditioning(
            kw, params, prompts[0])
        rec["float64"] = decode_run(label + " float64", cfg,
                                    {k: v.double() for k, v in
                                     params.items()}, prompts, news, True)
        del params
        cut = DecodeConfig(**dict(kw, layers=DECODE_EXACT_LAYERS))
        rec["float32_cut"] = decode_run(
            "%s float32 at %d layers" % (label, DECODE_EXACT_LAYERS), cut,
            demo_lm_params(cut, dev), prompts, news, True)
    held = [k for k in ("float32", "float64", "float32_cut")
            if k in rec and rec[k]["held"]]
    f32 = rec["float32"]
    log("decode: %s %s" % (label, json.dumps(rec)))
    if not exact:
        log("decode: %s float32 from float64, max|d logits| / max|logit| "
            "by depth 1..%d: %s" % (label, cfg.layers, " ".join(
                "%.3g" % e for e in rec["float32_logit_err_by_depth"])))
    log("decode: %s flat %.1f tokens/s, paged %.1f (float32, %d layers), "
        "over the wire %s tokens/s; step p50 %.3f / p99 %.3f ms at %d "
        "slots; KV %d bytes; every token held in %s; %s"
        % (label, f32["flat"]["tokens_per_s"], f32["paged"]["tokens_per_s"],
           cfg.layers, " / ".join("%.1f (%s)" % (
               rec[k]["paged"]["wire_tokens_per_s"], k) for k in held),
           f32["flat"]["step_ms"]["p50"], f32["flat"]["step_ms"]["p99"],
           cfg.slots, f32["flat"]["kv_bytes"], ", ".join(held), smi))
    return rec


def phase_decode(smi):
    """The decode engine on the card at the two geometries of
    ``DECODE_GEOMETRIES`` (:func:`decode_geometry`).  The launch counts are
    set to 0 at the start and read at the end: decode's attention is the
    composition in both packages, so none of K1-K4 may launch.  Returns
    the launches."""
    from mxnet_tpu_torch.ops import _kernels
    t0 = time.perf_counter()
    _kernels.reset_launches()
    recs = [decode_geometry(label, kw, load, exact, smi)
            for label, kw, load, exact in DECODE_GEOMETRIES]
    launches = _kernels.launch_counts()
    if any(launches.values()):
        raise RuntimeError("decode: launched %s; decode takes the "
                           "composition, none of K1-K4" % launches)
    log("decode: both geometries in %.1f s, K1-K4 launches %s"
        % (time.perf_counter() - t0, launches))
    return launches, recs


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


PHASE_SECONDS = {}


def _timed(phase, *args):
    """Run one phase and log its seconds (kept for the closing summary)."""
    t0 = time.perf_counter()
    out = phase(*args)
    PHASE_SECONDS[phase.__name__] = time.perf_counter() - t0
    log("smoke: %s took %.1f s" % (phase.__name__,
                                   PHASE_SECONDS[phase.__name__]))
    return out


def main():
    t_script = time.perf_counter()
    smi, name, peaks = phase_device()
    _timed(phase_build)
    fwd = _timed(phase_kernels, peaks)
    bwd = _timed(phase_bwd_kernels, peaks)
    log_library_ratios(fwd, bwd)
    long_fp32 = _timed(phase_long_fp32)
    net, sv, answers, serve_launches = _timed(phase_slice)
    save_load_launches = _timed(phase_save_load, net, answers)
    gc.collect()
    torch.cuda.empty_cache()
    tokens, types = make_requests()
    _timed(phase_breakdown, sv, tokens, types)
    refs = composition_outputs(net, tokens, types)
    _timed(phase_bf16, net, answers, tokens, types)
    del net, sv, answers
    gc.collect()
    torch.cuda.empty_cache()
    tier_launches = _timed(phase_serve_tier, refs, smi)
    gc.collect()
    torch.cuda.empty_cache()
    launch_launches = _timed(phase_launch_tier, refs, smi)
    del refs
    gc.collect()
    torch.cuda.empty_cache()
    train_launches, train_step_ms = _timed(phase_train, peaks)
    gc.collect()
    torch.cuda.empty_cache()
    user_launches, user = _timed(phase_user_kernels, peaks)
    gc.collect()
    torch.cuda.empty_cache()
    imperative_launches = _timed(phase_imperative, train_step_ms)
    gc.collect()
    torch.cuda.empty_cache()
    resnet_launches = _timed(phase_resnet, peaks)
    gc.collect()
    torch.cuda.empty_cache()
    eager_launches = _timed(phase_eager, peaks, train_step_ms)
    gc.collect()
    torch.cuda.empty_cache()
    amp_launches = _timed(phase_amp, peaks, train_step_ms)
    gc.collect()
    torch.cuda.empty_cache()
    data_launches, det_launches = _timed(phase_data)
    gc.collect()
    torch.cuda.empty_cache()
    ssd_launches = _timed(phase_ssd, peaks, smi)
    gc.collect()
    torch.cuda.empty_cache()
    lm_launches = _timed(phase_lm, peaks, smi)
    gc.collect()
    torch.cuda.empty_cache()
    zoo_launches = _timed(phase_zoo, smi)
    gc.collect()
    torch.cuda.empty_cache()
    dist_launches = _timed(phase_dist, smi)
    gc.collect()
    torch.cuda.empty_cache()
    ps_launches = _timed(phase_ps, smi)
    gc.collect()
    torch.cuda.empty_cache()
    resume_launches = _timed(phase_resume, smi)
    gc.collect()
    torch.cuda.empty_cache()
    context_launches = _timed(phase_context, smi, fwd)
    gc.collect()
    torch.cuda.empty_cache()
    tensor_launches = _timed(phase_tensor, smi)
    gc.collect()
    torch.cuda.empty_cache()
    several_launches = _timed(phase_several, smi)
    gc.collect()
    torch.cuda.empty_cache()
    resnet_dp_launches = _timed(phase_resnet_dp, smi)
    gc.collect()
    torch.cuda.empty_cache()
    decode_launches, _decode = _timed(phase_decode, smi)
    by_path = {k: {"serve": serve_launches[k], "train": train_launches[k],
                   "imperative": imperative_launches[k],
                   "resnet": resnet_launches[k],
                   "eager": eager_launches[k], "amp": amp_launches[k],
                   "data": data_launches[k], "det": det_launches[k],
                   "ssd": ssd_launches[k], "lm": lm_launches[k],
                   "zoo": zoo_launches[k], "dist": dist_launches.get(k, 0),
                   "ps": ps_launches.get(k, 0),
                   "resume": resume_launches.get(k, 0),
                   "context": context_launches.get(k, 0),
                   "tensor": tensor_launches.get(k, 0),
                   "several": several_launches.get(k, 0),
                   "resnet_dp": resnet_dp_launches.get(k, 0),
                   "save_load": save_load_launches.get(k, 0),
                   "decode": decode_launches.get(k, 0),
                   "serve_tier": tier_launches.get(k, 0),
                   "launch_tier": launch_launches.get(k, 0)}
               for k in imperative_launches}
    fp32, bf16 = torch.float32, torch.bfloat16
    kernels = [
        kernel_row("flash_fwd", "mxnet_tpu_torch/csrc/flash_fwd.cu",
                   "mxnet_tpu/ops/attention.py:148", by_path["flash_fwd"],
                   fwd[("bert-base", fp32)], fwd[("bert-base", bf16)],
                   {"bf16_train_": fwd[("bert-train", bf16)],
                    "ring_hop_": fwd[("ring-hop", fp32)],
                    "ring_hop_diag_": fwd[("ring-hop-diag", fp32)]}),
    ] + [kernel_row(kern, "mxnet_tpu_torch/csrc/flash_bwd.cu",
                    "mxnet_tpu/ops/attention.py:%d" % line, by_path[kern],
                    bwd[(kern, fp32, "bert-train")],
                    bwd[(kern, bf16, "bert-train")],
                    {"ring_hop_": bwd[(kern, fp32, "ring-hop")],
                     "ring_hop_diag_": bwd[(kern, fp32, "ring-hop-diag")]})
         for kern, line in (("flash_bwd_dq", 260), ("flash_bwd_dkv", 304))
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
                                                   0),
                     "context": context_launches.get("tpu_kernel:" + body,
                                                     0),
                     "tensor": tensor_launches.get("tpu_kernel:" + body,
                                                   0),
                     "several": several_launches.get("tpu_kernel:" + body,
                                                     0),
                     "resnet_dp": resnet_dp_launches.get(
                         "tpu_kernel:" + body, 0),
                     "save_load": save_load_launches.get(
                         "tpu_kernel:" + body, 0),
                     "decode": decode_launches.get("tpu_kernel:" + body,
                                                   0),
                     "serve_tier": tier_launches.get("tpu_kernel:" + body,
                                                     0),
                     "launch_tier": launch_launches.get(
                         "tpu_kernel:" + body, 0)},
                    user[(body, fp32)], user[(body, bf16)],
                    {"default_grid_": user[(body + ":default_grid", fp32)],
                     "bf16_default_grid_": user[(body + ":default_grid",
                                                 bf16)]}
                    if body == "double" else None)
         for body in USER_KERNELS]
    # the fp32 rows' worst deviation from float64 at the long lengths
    for row, stages in zip(kernels, (("O",), ("dQ",), ("dK", "dV"))):
        row["fp32_long_rel_to_f64"] = {
            "T=%d%s" % (r["T"], " causal" if r["causal"] else ""):
                max(r["rel_to_f64"][st] for st in stages)
            for r in long_fp32}
    log("smoke: phase seconds %s" % json.dumps(
        {k: round(v, 1) for k, v in PHASE_SECONDS.items()}))
    log("smoke: all phases in %.1f s" % (time.perf_counter() - t_script))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ps-worker"]:
        ps_worker(sys.argv[2], sys.argv[3])
    elif sys.argv[1:2] == ["--serve-replica-worker"]:
        serve_replica_worker(sys.argv[2:])
    elif sys.argv[1:2] == ["--resume-worker"]:
        resume_worker(sys.argv[2:])
    elif sys.argv[1:2] == ["--train-dist-async"]:
        train_dist_async(sys.argv[2:])
    elif sys.argv[1:2] in (["--dist-worker"], ["--context-worker"],
                           ["--long-context-worker"], ["--tensor-worker"],
                           ["--resnet-dp-worker"]):
        {"--dist-worker": lambda: dist_worker(sys.argv[2]),
         "--resnet-dp-worker": resnet_dp_worker,
         "--context-worker": context_worker,
         "--long-context-worker": lambda: long_context_worker(sys.argv[2:]),
         "--tensor-worker": lambda: tensor_worker(sys.argv[2]),
         }[sys.argv[1]]()
        # a worker of a process group leaves without the interpreter's
        # teardown, where a two-rank gloo worker could abort after its
        # work was done
        from mxnet_tpu_torch.parallel import end_process_group
        end_process_group(0)
    else:
        main()
