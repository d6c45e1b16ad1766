"""KVStore package (reference: python/mxnet/kvstore/): the stores, their
fusion buckets and gradient compression, the dist_async parameter server
(:mod:`.server`) and the host-side wire codecs (numpy only) that the
serving wire shares."""
from .kvstore import KVStore, create
from .kvstore import KVStoreLocal, KVStoreDevice, KVStoreICI
from .kvstore import KVStoreDistAsync

# the reference's exports; KVStoreDistAsync is reached as it is there,
# through create("dist_async") or the kvstore module
__all__ = ["KVStore", "create", "KVStoreLocal", "KVStoreDevice", "KVStoreICI"]
