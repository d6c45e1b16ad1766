"""KVStore package (reference: python/mxnet/kvstore/): the stores, their
fusion buckets and gradient compression, and the host-side wire codecs
(numpy only) that the serving wire shares."""
from .kvstore import KVStore, create
from .kvstore import KVStoreLocal, KVStoreDevice, KVStoreICI

__all__ = ["KVStore", "create", "KVStoreLocal", "KVStoreDevice", "KVStoreICI"]
