"""Serving tier of the port: servables, micro-batcher, wire server and
client (PREDICT / HEALTH / STOP)."""
from .servable import BucketTable, ModelHost, Servable
from .batcher import Batcher, Overloaded, result_timeout
from .server import ServeServer, serve_forever
from .client import ServeClient

__all__ = ["BucketTable", "ModelHost", "Servable", "Batcher", "Overloaded",
           "result_timeout", "ServeServer", "serve_forever", "ServeClient"]
