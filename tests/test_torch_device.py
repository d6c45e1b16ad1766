"""The top-level names the reference's training loops call, against the
JAX reference on the CPU: ``mx.waitall``, ``mx.num_gpus``,
``mx.gpu_memory_info``, ``mx.current_device``, ``mx.Device``,
``mx.context`` and ``gluon.metric``."""
import importlib

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

import torch
# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)


def test_device_is_context_and_current_device_is_current_context():
    for mx in (jmx, tmx):
        assert mx.Device is mx.Context
        with mx.cpu():
            assert mx.current_device() == mx.current_context() == mx.cpu()
        with mx.Device("cpu", 0):
            assert mx.current_device() == mx.cpu(0)


def test_context_is_a_module_of_its_own():
    for name, mx in (("mxnet_tpu", jmx), ("mxnet_tpu_torch", tmx)):
        mod = importlib.import_module(name + ".context")
        assert mod is mx.context
        assert mod.Context is mx.Context and mod.cpu(1) == mx.cpu(1)
        assert mx.context.num_gpus() == mx.num_gpus()


def test_num_gpus_counts_the_cuda_devices():
    import torch
    assert tmx.num_gpus() == torch.cuda.device_count()
    if not torch.cuda.is_available():
        assert tmx.num_gpus() == jmx.num_gpus() == 0


def test_gpu_memory_info_needs_a_card():
    import torch
    if torch.cuda.is_available():
        free, total = tmx.gpu_memory_info(0)
        assert 0 < free <= total
    else:
        # the reference answers (0, 0) where its backend keeps no
        # statistics; the port, which runs on the card unless asked,
        # raises as upstream MXNet does
        with pytest.raises(MXNetError, match="cuda"):
            tmx.gpu_memory_info(0)


def test_waitall_returns_nothing():
    assert jmx.waitall() is None and tmx.waitall() is None
    assert tmx.waitall is tmx.nd.waitall


def test_gluon_metric_is_the_metric_module():
    assert tmx.gluon.metric is tmx.metric
    labels = [np.array([0, 1, 2, 1], np.float32)]
    preds = [np.array([[0.8, 0.1, 0.1], [0.2, 0.5, 0.3], [0.1, 0.2, 0.7],
                       [0.6, 0.3, 0.1]], np.float32)]
    got = []
    for mx in (jmx, tmx):
        with mx.cpu():
            acc = mx.gluon.metric.Accuracy()
            acc.update([mx.nd.array(a) for a in labels],
                       [mx.nd.array(a) for a in preds])
            got.append(acc.get())
    assert got[0] == got[1] == ("accuracy", 0.75)
