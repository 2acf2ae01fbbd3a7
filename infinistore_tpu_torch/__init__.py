"""infinistore_tpu_torch: the KV-cache store's client side on PyTorch and CUDA.

The PyTorch port of ``infinistore_tpu``. The store itself (native core,
client, server) is framework-neutral and kept here as copies; what touches
device memory (the paged cache, its staging to host, the layerwise writer and
reader, the connector and the model) is rewritten on torch tensors, and the
TPU kernels (paged block copies, batched, ragged, sharded and int8 paged
decode, flash prefill) are hand-written CUDA kernels for Hopper
(``cuda/csrc``). The package imports nothing of
``infinistore_tpu`` and never imports jax.

Importing the package loads nothing: every name resolves lazily, so neither
the native library (compiled at first use of ``lib``) nor torch is pulled in
by ``import infinistore_tpu_torch``.
"""

__version__ = "0.1.0"

_LAZY = {
    "config": (
        "LINK_DCN", "LINK_ETHERNET", "LINK_IB", "LINK_ICI", "TYPE_DCN",
        "TYPE_RDMA", "TYPE_TCP", "ClientConfig", "ServerConfig",
    ),
    "lib": (
        "InfiniStoreColdTier", "InfiniStoreException", "InfiniStoreKeyNotFound",
        "InfiniStoreNoMatch", "InfiniStoreResourcePressure", "InfinityConnection",
        "LocalServer", "Logger", "start_local_server",
    ),
    "connector": ("FetchCoalescer", "KVConnector", "token_chain_hashes"),
    "engine": (
        "BlockPool", "ContinuousBatchingHarness", "DeviceGate", "EngineKVAdapter",
        "NGramDrafter", "RequestStats", "WaveCounters", "WaveDecoder",
        "reset_wave_counters", "wave_counters",
    ),
    "cuda.staging": ("HostStagingPool", "StagingLease", "StagingPoolExhausted"),
    "cuda.layerwise": (
        "LayerwiseKVReader", "LayerwiseKVWriter", "LayerwisePrefetch", "PartialReadError",
        "PrefetchDiscarded", "kv_block_key",
    ),
    "cuda.paged": ("PagedKVCacheSpec", "gather_blocks", "scatter_blocks"),
    "cuda.paged_attention": (
        "RaggedWaveMeta", "build_ragged_wave", "build_ragged_wave_sharded",
        "paged_decode_attention_ragged", "paged_decode_attention_ragged_sharded",
        "paged_decode_attention_rows", "paged_decode_attention_sharded",
    ),
    "cuda.kv_quant": (
        "QuantizedKVConnector", "QuantizingKVAdapter", "dequantize_kv",
        "paged_decode_attention_quantized", "quantize_kv",
    ),
}
_WHERE = {name: mod for mod, names in _LAZY.items() for name in names}


def __getattr__(name):
    mod = _WHERE.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)


__all__ = sorted(_WHERE)
