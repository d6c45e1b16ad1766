"""Serving tier of the port: servables, micro-batcher, the decode engine,
wire server and client (PREDICT / GENERATE / HEALTH / STOP)."""
from .servable import BucketTable, ModelHost, Servable
from .batcher import Batcher, Overloaded, result_timeout
from .server import ServeServer, serve_forever
from .client import ServeClient
from .decode import DecodeBatcher, DecodeConfig, DecodeServable

__all__ = ["BucketTable", "ModelHost", "Servable", "Batcher", "Overloaded",
           "result_timeout", "ServeServer", "serve_forever", "ServeClient",
           "DecodeBatcher", "DecodeConfig", "DecodeServable"]
