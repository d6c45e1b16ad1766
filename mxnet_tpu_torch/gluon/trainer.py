"""Gluon ``Trainer``.

Counterpart of ``mxnet_tpu/gluon/trainer.py`` (reference:
python/mxnet/gluon/trainer.py).  ``step(batch_size)`` sets the
optimizer's ``rescale_grad`` to ``1 / batch_size`` (times the
optimizer's own), runs the gradient allreduce and applies the optimizer
to every parameter whose ``grad_req`` is not 'null', the whole group in
one ``Updater`` call, so an optimizer with ``aggregate_num`` fuses it.

Across processes: inside a ``torch.distributed`` process group
(``parallel.init_process_group``, as the launcher's workers start it) the
Trainer makes its kvstore, ``ici`` for the default ``'device'``, and
``step`` pushes every gradient to it and pulls back the sum over the
ranks (``update_on_kvstore=False``, the default) or lets the store run
the optimizer and pulls back the weights (``update_on_kvstore=True``).
The weights start from rank 0's (``broadcast``), ``compression_params``
(or ``MX_GRAD_COMPRESS``) compress the exchange, and
``MX_EXCHANGE_OVERLAP=1`` launches each fusion bucket's exchange the
moment backward has written its last gradient.  A group of one rank
runs the same exchange.  Without a group the Trainer makes no store for
parameters on one context, as the reference makes none for one device in
one process.

Parameters with a copy on each of several contexts in one process
(``initialize(ctx=[c0, c1])``, the classic Gluon data-parallel loop) get
one updater a context, each advancing its own context's update counts,
and a store (``kvstore``, ``'device'`` by default; ``'ici'`` across
processes, which sums the copies first and then the ranks): ``step``
pushes every copy's gradient, pulls the sum back into every copy and
updates each copy with its context's updater.  The store starts every
copy from the first context's value.  ``make_compiled_step``
returns the whole-step lane (:mod:`..step`), sharded over a
``SpecLayout`` when one is given or set in the environment.  ``step``
times its ``exchange`` and ``optimizer_apply`` phases and ends with one
flight-recorder record (``telemetry.note_step``), as the reference's
does.  Not ported: sparse gradients.
"""
from __future__ import annotations

import functools
import threading
from typing import Dict, List

import torch.distributed as dist

from .. import optimizer as opt
from .. import telemetry as _telemetry
from ..base import get_env
from ..kvstore import create as kv_create
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


def _in_process_group() -> bool:
    return dist.is_available() and dist.is_initialized()


class Trainer:
    """Applies an optimizer to a set of parameters (reference:
    gluon.Trainer).

    ``params`` is a ``ParameterDict`` or dict (taken in sorted key order,
    which fixes each parameter's index in the optimizer state and its key
    in the kvstore) or a list of :class:`~.parameter.Parameter`;
    ``optimizer`` a name or an ``Optimizer`` (then ``optimizer_params``
    must be empty)."""

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
        if compression_params is None and get_env("MX_GRAD_COMPRESS"):
            compression_params = {"type": get_env("MX_GRAD_COMPRESS")}
        self._compression_params = compression_params
        self._contexts = self._check_contexts()
        self._init_optimizer(optimizer, optimizer_params or {})
        self._scale = self._optimizer.rescale_grad
        self._kvstore_params = {"kvstore": kvstore,
                                "update_on_kvstore": update_on_kvstore}
        # gradient hooks fire on the thread that runs backward; every
        # hand-off of the armed overlap session goes through this lock
        self._hook_lock = threading.Lock()
        #: (index, copy) -> (its tensor, its post-accumulate-grad hook)
        self._hooks: Dict[tuple, tuple] = {}
        self._reset_kvstore()

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
        # one updater a context over the one optimizer, as the reference
        # keeps them: each advances its own context's update counts
        self._updaters = [opt.get_updater(self._optimizer)
                          for _ in (self._contexts or [None])]

    def _reset_kvstore(self):
        self._kv_initialized = False
        self._kvstore = None
        self._update_on_kvstore = None
        self._params_to_init = list(self._params)
        self._kv_broadcast_done: set = set()
        self._overlap = False
        self._exchange_session = None
        self._armed_set = None

    def _init_kvstore(self):
        config = self._kvstore_params
        kvstore = config["kvstore"]
        update_on_kvstore = config["update_on_kvstore"]
        in_group = _in_process_group()
        if kvstore and (in_group or len(self._contexts) > 1):
            # the sum over the copies, and across processes over the
            # ranks, lives in the store; across processes the default
            # 'device' becomes 'ici', as the reference picks it for
            # accelerators and several processes
            if isinstance(kvstore, str):
                kv = kv_create("ici" if kvstore == "device" and in_group
                               else kvstore)
            else:
                kv = kvstore
            self._kvstore = kv
            if self._compression_params:
                kv.set_gradient_compression(self._compression_params)
            update_on_kvstore = bool(update_on_kvstore)
            if update_on_kvstore:
                kv.set_optimizer(self._optimizer)
            self._update_on_kvstore = update_on_kvstore
            # the store-side optimizer needs the whole key set at once
            self._overlap = not update_on_kvstore and \
                get_env("MX_EXCHANGE_OVERLAP", dtype=bool)
        else:
            self._kvstore = None
            self._update_on_kvstore = False
        self._kv_initialized = True

    def _init_params(self):
        assert self._kv_initialized
        if self._kvstore is None:
            self._params_to_init = []
            return
        for i, param in enumerate(self._params):
            if param._tensor().is_meta or i in self._kv_broadcast_done:
                # a broadcast parameter is not pulled again: after the
                # first step its store slot holds a gradient
                continue
            # every copy, and every worker, starts from the store's agreed
            # value: the first context's (rank 0's)
            self._kvstore.broadcast(i, param.data(self._contexts[0]),
                                    out=param.list_data())
            self._kv_broadcast_done.add(i)
        self._params_to_init = [p for p in self._params_to_init
                                if p._tensor().is_meta]

    def _init_store(self):
        if not self._kv_initialized:
            self._init_kvstore()
        if self._params_to_init:
            self._init_params()

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
        """The whole-step lane (:class:`~..step.CompiledStep`) over this
        Trainer: ``step(data, label)`` runs forward, backward, the
        exchange, the update and the metric as one call, reading and
        writing this Trainer's parameters and states.  ``layout`` (a
        :class:`~..parallel.speclayout.SpecLayout`; None reads
        ``MX_MESH_AXES`` / ``MX_FSDP``) runs it sharded over the layout's
        mesh of ranks."""
        from ..step import CompiledStep
        return CompiledStep(net, loss_fn, self, metric=metric,
                            layout=layout)

    # -- the step ----------------------------------------------------------
    def step(self, batch_size, ignore_stale_grad=False):
        """Rescale the gradients by ``1 / batch_size``, allreduce them and
        update the parameters."""
        self._check_and_rescale_grad(self._scale / batch_size)
        self._init_store()
        self._allreduce_grads()
        self._update(ignore_stale_grad)
        # one flight-recorder record a step: the phases above and the
        # dispatch counts, without a host sync
        _telemetry.note_step(batch_size=batch_size)

    def allreduce_grads(self):
        """The allreduce alone, for work on the gradients between it and
        :meth:`update`."""
        self._init_store()
        assert not (self._kvstore and self._update_on_kvstore), \
            "allreduce_grads() when parameters are updated on kvstore " \
            "is not supported. Try setting `update_on_kvstore` to False."
        self._allreduce_grads()

    def _exchange_set(self):
        """The indices of the parameters whose gradients the exchange
        carries this step, and for each a callable giving its gradient
        list as it is when the exchange reads it."""
        idxs = [i for i, p in enumerate(self._params)
                if p.grad_req != "null"]
        return idxs, [self._params[i].list_grad for i in idxs]

    def _arm_exchange(self):
        """Open the next step's overlap session and hook each parameter,
        so that during the next backward every written gradient notifies
        the session and a bucket's exchange launches the moment its last
        member lands (late layers first).  Results are written at the
        drain (:meth:`_allreduce_grads`)."""
        with self._hook_lock:
            self._exchange_session = None
        self._armed_set = None
        if not self._overlap or self._kvstore is None:
            return
        idxs, grad_lists = self._exchange_set()
        if not idxs:
            return
        sess = self._kvstore.begin_exchange(idxs, grad_lists)
        if sess is None:        # the store cannot overlap (dist_async)
            self._overlap = False
            return
        with self._hook_lock:
            self._exchange_session = sess
        self._armed_set = (idxs, [self._copy_tensors(i) for i in idxs])
        for i in idxs:
            for d, t in enumerate(self._copy_tensors(i)):
                self._hook(i, d, t)

    def _copy_tensors(self, i):
        """Parameter ``i``'s tensors, one a context."""
        return list(self._params[i]._tensors().values())

    def _hook(self, i, d, t):
        """Give copy ``d`` of parameter ``i`` (tensor ``t``) the hook that
        notifies the armed session (``autograd.backward`` runs it when it
        writes the gradient, as torch's own backward runs it after
        accumulating); a bucket launches when every copy of every member
        has landed."""
        old = self._hooks.get((i, d))
        if old is not None and old[0] is t:
            return
        if old is not None:
            old[1].remove()
        self._hooks[(i, d)] = (t, t.register_post_accumulate_grad_hook(
            functools.partial(self._on_grad_ready, i, d)))

    def _armed_set_current(self):
        """The armed session still covers this step's exchange: the same
        indices and the same parameter tensors (a ``grad_req`` change, a
        re-initialisation or a cast between steps changes one)."""
        if self._armed_set is None:
            return False
        idxs, _ = self._exchange_set()
        a_idxs, tensors = self._armed_set
        return idxs == a_idxs and all(
            len(ts) == len(cur) and all(a is b for a, b in zip(ts, cur))
            for ts, cur in zip(tensors, map(self._copy_tensors, idxs)))

    def _on_grad_ready(self, i, d, _tensor=None):
        with self._hook_lock:
            sess = self._exchange_session
        if sess is not None:
            # outside the lock: the session may launch a collective here
            sess.notify_key(i, d)

    def _allreduce_grads(self):
        if self._kvstore is None:
            return
        with self._hook_lock:
            sess = self._exchange_session
        if sess is not None and not self._armed_set_current():
            # the exchange set changed under the armed session: roll back
            # what it launched and take a fresh session
            sess.abort()
            sess = None
            with self._hook_lock:
                self._exchange_session = None
        if sess is None and not self._update_on_kvstore:
            # no session was armed before this backward (overlap off, or
            # its first step): a session drained at once is the serialized
            # exchange.  Overlapped, it packs late layers first, so that the
            # bucket layout (and the residuals' wire keys) is the
            # overlapped steps'; otherwise in key order, as a batched push
            idxs, grad_lists = self._exchange_set()
            if idxs:
                sess = self._kvstore.begin_exchange(idxs, grad_lists,
                                                    reverse=self._overlap)
                if sess is None:    # the store cannot overlap (dist_async)
                    self._overlap = False
        if sess is not None:
            with self._hook_lock:
                self._exchange_session = None
            with _telemetry.phase("exchange"):
                sess.drain()
        else:
            idxs, grad_lists = self._exchange_set()
            if idxs:
                # one batched push and pull: the store runs the optimizer
                # on the push and the weights come back, or (a store that
                # cannot overlap) the exchanged gradients do
                grads = [g() for g in grad_lists]
                with _telemetry.phase("exchange"):
                    self._kvstore.push(idxs, grads)
                    self._kvstore.pull(
                        idxs, [self._params[i].list_data() for i in idxs]
                        if self._update_on_kvstore else grads)
        self._arm_exchange()

    def update(self, batch_size, ignore_stale_grad=False):
        """The update alone (after :meth:`allreduce_grads`)."""
        self._init_store()
        assert not (self._kvstore and self._update_on_kvstore), \
            "update() when parameters are updated on kvstore " \
            "is not supported. Try setting `update_on_kvstore` to False."
        self._check_and_rescale_grad(self._scale / batch_size)
        self._update(ignore_stale_grad)

    def _check_and_rescale_grad(self, scale):
        if self._update_on_kvstore and self._kv_initialized and \
                self._optimizer.rescale_grad != scale:
            raise UserWarning(
                "Possible change in the `batch_size` from previous `step` "
                "detected. Optimizer gradient normalizing factor will not "
                "change w.r.t new batch_size when update_on_kvstore=True")
        self._optimizer.rescale_grad = scale
        for upd in self._updaters:
            upd.optimizer.rescale_grad = scale

    def _update(self, ignore_stale_grad=False):
        if self._update_on_kvstore:
            return
        idxs = [i for i, p in enumerate(self._params) if p.grad_req != "null"]
        if not idxs:
            return
        weights = [self._params[i].list_data() for i in idxs]
        grads = [self._params[i].list_grad() for i in idxs]
        with _telemetry.phase("optimizer_apply"):
            for d, upd in enumerate(self._updaters):
                # one call a context: its updater keys that context's
                # counts
                upd(idxs, [g[d] for g in grads], [w[d] for w in weights])

    # -- states ------------------------------------------------------------
    def save_states(self, fname):
        """Pickle the first context's updater's states (momenta, moments,
        float32 masters) and the optimizer to ``fname`` (the store's, when
        it runs the optimizer); :meth:`load_states` gives them to every
        context's updater."""
        self._init_store()
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname, dump_optimizer=True)
            return
        with open(fname, "wb") as fout:
            fout.write(self._updaters[0].get_states(dump_optimizer=True))

    def load_states(self, fname):
        self._init_store()
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            self._optimizer = self._kvstore._updater.optimizer
        else:
            with open(fname, "rb") as f:
                states = f.read()
            for updater in self._updaters:
                updater.set_states(states)
                updater.optimizer = self._updaters[0].optimizer
            self._optimizer = self._updaters[0].optimizer
        self._optimizer.param_dict = {i: param for i, param
                                      in enumerate(self._params)}
