"""Serving tier of the port: servables with their bucket programs and
the HBM packer, the micro-batcher, the decode engine, the wire server and
client (PREDICT / GENERATE / HEALTH / METRICS / SWAP / DRAIN / STOP), and
the session router (:mod:`.router`, loaded on first use).

``python -m mxnet_tpu_torch.serve`` runs one replica and
``python -m mxnet_tpu_torch.serve.router`` the router in front of
several."""
from .servable import BucketTable, BudgetExceeded, ModelHost, Servable
from .batcher import Batcher, Overloaded, result_timeout
from .server import ServeServer, serve_forever
from .client import ServeClient
from .decode import DecodeBatcher, DecodeConfig, DecodeServable

__all__ = ["BucketTable", "Servable", "ModelHost", "BudgetExceeded",
           "Batcher", "Overloaded", "result_timeout", "ServeServer",
           "serve_forever", "ServeClient", "DecodeBatcher", "DecodeConfig",
           "DecodeServable", "ServeRouter", "serve_router_forever"]


def __getattr__(name):
    # lazy (PEP 562): ``python -m mxnet_tpu_torch.serve.router`` must not
    # find the router module imported by its own package first (runpy's
    # double-execution warning)
    if name in ("ServeRouter", "serve_router_forever"):
        from . import router
        return getattr(router, name)
    raise AttributeError("module %r has no attribute %r"
                         % (__name__, name))
