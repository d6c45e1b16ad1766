"""mxnet_tpu_torch: the PyTorch/CUDA port of ``mxnet_tpu``.

A package of its own beside the JAX reference.  It imports ``torch`` and
never ``jax`` or anything of ``mxnet_tpu``.  Entry points run on the GPU
(``torch.device("cuda")``) unless the caller passes ``device="cpu"``.

The first slice is the serving path: ``serve.Servable`` ->
``serve.ModelHost.deploy`` -> ``serve.Batcher`` -> ``serve.ServeServer`` /
``serve.serve_forever`` <-> ``serve.ServeClient``, over the model zoo's
BERT, with flash-attention forward as a hand-written CUDA kernel
(``csrc/flash_fwd.cu``).  The second is training: ``parallel.TrainStep``
over ``gluon.block.functionalize`` and ``gluon.loss``, with the
flash-attention backward as hand-written CUDA kernels
(``csrc/flash_bwd.cu``).  The third is the imperative front end: ``nd``
(NDArray and the op registry's functions), ``autograd`` over torch
autograd, gluon blocks called on NDArrays, and ``tpu_kernel``, user CUDA
kernels built with ``nvcc`` and launched or registered as ops.  Later
slices: ResNet training (convolution, BatchNorm, pooling, the vision
zoo), the Gluon eager training loop (``gluon.Parameter`` with deferred
init, ``gluon.Trainer``, ``optimizer``, ``lr_scheduler``, ``metric``) and
the input pipeline (``io`` with ``io.DevicePrefetcher``, ``gluon.data``,
``recordio``, ``image``, ``random``), and ``amp``, automatic mixed
precision at the registered-op dispatch, with the detection input path
(``image.ImageDetIter``) and the image and spatial ops, SSD-300 with the
detection ops, and the LSTM language model: the fused ``RNN`` op on
PyTorch's RNN (cuDNN on the card), ``gluon.rnn``'s layers and cells, the
rest of ``gluon.nn`` and the vision zoo; then data-parallel training
across processes: ``kvstore`` over ``torch.distributed`` (NCCL on the
GPU, gloo on the CPU) with fusion buckets and gradient compression,
``gluon.Trainer`` and ``parallel.TrainStep`` across ranks, and the
launcher ``python -m mxnet_tpu_torch.tools.launch``; then the
``dist_async`` parameter server (``kvstore.server``, the store
``KVStoreDistAsync`` and the launcher's ``-s``) with the host modules it
stands on: ``fault``, ``profiler``, ``telemetry`` and ``engine``; then
supervised training: ``checkpoint`` (crash-safe checkpoints on
``torch.distributed.checkpoint``, ``TrainStep.save`` / ``restore``),
``health`` (the NaN policy, the step watchdog, the heartbeat file) and
the launcher's supervisor (``--restart``, ``--hang-timeout``,
``--elastic``) and ssh mode.
"""
import sys as _sys

from .base import MXNetError, get_env, set_env, environment
from .device import (Context, Device, cpu, gpu, cpu_pinned,
                     current_context,
                     current_device, default_device, num_gpus,
                     gpu_memory_info)
from . import device as context
from . import initializer
from . import initializer as init
from . import fault
from . import profiler
from . import telemetry
from . import engine
from . import ops
from . import lr_scheduler
from . import optimizer
from . import metric
from . import autograd
from . import ndarray
from . import ndarray as nd
from .ndarray import NDArray, waitall
from . import gluon
from . import serve
from . import kvstore
from . import kvstore as kv
from . import parallel
from . import checkpoint
from . import health
from . import tpu_kernel
from . import random
from . import recordio
from . import image
from . import io
from . import amp
from . import contrib

# the reference's ``mx.context`` is a module of its own
_sys.modules[__name__ + ".context"] = context
# ``mx.nd.contrib`` is importable by its dotted name from the start (the
# reference registers it only at the first attribute access)
_sys.modules[__name__ + ".ndarray.contrib"] = contrib.ndarray

__all__ = ["MXNetError", "get_env", "set_env", "environment", "Context",
           "Device", "cpu", "gpu", "cpu_pinned", "current_context", "current_device", "default_device",
           "num_gpus", "gpu_memory_info", "context", "NDArray", "waitall",
           "initializer", "init", "fault", "profiler", "telemetry",
           "engine", "ops", "lr_scheduler", "optimizer", "metric", "autograd",
           "ndarray", "nd", "gluon", "serve", "kvstore", "kv", "parallel",
           "checkpoint", "health",
           "tpu_kernel",
           "random", "recordio", "image", "io", "amp", "contrib"]
