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
(``csrc/flash_bwd.cu``).
"""
from .base import MXNetError, get_env
from .device import cpu, gpu, default_device
from . import initializer
from . import initializer as init
from . import ops
from . import gluon
from . import serve
from . import parallel

__all__ = ["MXNetError", "get_env", "cpu", "gpu", "default_device",
           "initializer", "init", "ops", "gluon", "serve", "parallel"]
