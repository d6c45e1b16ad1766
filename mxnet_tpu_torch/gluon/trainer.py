"""Gluon ``Trainer`` on one device.

Counterpart of ``mxnet_tpu/gluon/trainer.py`` (reference:
python/mxnet/gluon/trainer.py).  ``step(batch_size)`` sets the
optimizer's ``rescale_grad`` to ``1 / batch_size`` (times the
optimizer's own), runs the gradient allreduce and applies the optimizer
to every parameter whose ``grad_req`` is not 'null', the whole group in
one ``Updater`` call, so an optimizer with ``aggregate_num`` fuses it.

One device and one process: the reference makes no kvstore for that
layout, so the allreduce does nothing; ``kvstore``,
``compression_params`` and ``update_on_kvstore`` are accepted and have
nothing to act on, and parameters on more than one device raise until
the distributed slice.
Not ported: sparse gradients, ``make_compiled_step`` (it raises; the
CUDA-graph step is its counterpart to come) and the telemetry spans.
"""
from __future__ import annotations

from typing import List

from .. import optimizer as opt
from ..base import MXNetError
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


class Trainer:
    """Applies an optimizer to a set of parameters (reference:
    gluon.Trainer).

    ``params`` is a ``ParameterDict`` or dict (taken in sorted key order,
    which fixes each parameter's index in the optimizer state) or a list
    of :class:`~.parameter.Parameter`; ``optimizer`` a name or an
    ``Optimizer`` (then ``optimizer_params`` must be empty)."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            param_list = [params[key] for key in sorted(list(params.keys()))]
        elif isinstance(params, (list, tuple)):
            param_list = list(params)
        else:
            raise ValueError(
                "First argument must be a list or dict of Parameters, got %s"
                % type(params))
        self._params: List[Parameter] = []
        for param in param_list:
            if not isinstance(param, Parameter):
                raise ValueError("First argument must contain Parameters, "
                                 "got %s" % type(param))
            self._params.append(param)
            param._trainer = self
        self._contexts = self._check_contexts()
        self._init_optimizer(optimizer, optimizer_params or {})
        self._scale = self._optimizer.rescale_grad

    def _check_contexts(self):
        contexts = None
        for param in self._params:
            ctx = param.list_ctx()
            assert contexts is None or contexts == ctx, \
                "All Parameters must be initialized on the same set of " \
                "contexts, but Parameter %s is initialized on %s while " \
                "previous Parameters are initialized on %s" % (
                    param.name, str(ctx), str(contexts))
            contexts = ctx
        if contexts is not None and len(contexts) > 1:
            raise MXNetError("Trainer: parameters on %d devices; more than "
                             "one device comes with the distributed slice"
                             % len(contexts))
        return contexts or []

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = {i: param for i, param in enumerate(self._params)}
        if isinstance(optimizer, opt.Optimizer):
            assert not optimizer_params, \
                "optimizer_params must be None if optimizer is an Optimizer " \
                "instance"
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._updaters = [opt.get_updater(self._optimizer)]

    # -- properties --------------------------------------------------------
    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def make_compiled_step(self, net, loss_fn, metric=None, layout=None):
        raise MXNetError("Trainer.make_compiled_step is not ported: its "
                         "counterpart is the CUDA-graph training step, "
                         "still to come")

    # -- the step ----------------------------------------------------------
    def step(self, batch_size, ignore_stale_grad=False):
        """Rescale the gradients by ``1 / batch_size``, allreduce them and
        update the parameters."""
        self._check_and_rescale_grad(self._scale / batch_size)
        self.allreduce_grads()
        self._update(ignore_stale_grad)

    def allreduce_grads(self):
        """The allreduce alone, for work on the gradients between it and
        :meth:`update`: nothing to reduce on one device."""

    def update(self, batch_size, ignore_stale_grad=False):
        """The update alone (after :meth:`allreduce_grads`)."""
        self._check_and_rescale_grad(self._scale / batch_size)
        self._update(ignore_stale_grad)

    def _check_and_rescale_grad(self, scale):
        self._optimizer.rescale_grad = scale
        for upd in self._updaters:
            upd.optimizer.rescale_grad = scale

    def _update(self, ignore_stale_grad=False):
        idxs, grads, weights = [], [], []
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            idxs.append(i)
            weights.append(param.data())
            grads.append(param.grad())
        if idxs:
            self._updaters[0](idxs, grads, weights)

    # -- states ------------------------------------------------------------
    def save_states(self, fname):
        """Pickle the updater's states (momenta, moments, float32
        masters) and the optimizer to ``fname``."""
        with open(fname, "wb") as fout:
            fout.write(self._updaters[0].get_states(dump_optimizer=True))

    def load_states(self, fname):
        with open(fname, "rb") as f:
            states = f.read()
        for updater in self._updaters:
            updater.set_states(states)
            updater.optimizer = self._updaters[0].optimizer
        self._optimizer = self._updaters[0].optimizer
        self._optimizer.param_dict = {i: param for i, param
                                      in enumerate(self._params)}
