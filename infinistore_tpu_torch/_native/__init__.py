"""ctypes loader for the native core, built for the PyTorch port.

Mirrors ``infinistore_tpu/_native/__init__.py``: the same C API, declared the
same way. The difference is where the library comes from. The JAX package's
``libinfinistore_tpu.so`` is that package's own (its loader rebuilds it with
``make -C native``, which also writes ``native/src/*.o``), so the port
compiles the same sources itself, in ONE ``g++`` invocation with the flags
``native/Makefile`` states, into ``infinistore_tpu_torch/_build/``. The source
list and flags are parsed from the Makefile so they cannot drift. The build
runs at first import, under a file lock (see ``_build.py``).
"""

import ctypes
import os
import re
import shlex
from ctypes import (
    CFUNCTYPE,
    POINTER,
    c_char_p,
    c_double,
    c_int,
    c_int32,
    c_int64,
    c_uint8,
    c_uint32,
    c_uint64,
    c_void_p,
)

from .._build import BUILD_DIR, build_once

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO, "native")
_SO_PATH = os.path.join(BUILD_DIR, "libinfinistore_tpu_torch.so")


def _makefile_vars(path: str) -> dict:
    """The ``NAME ?= value`` / ``NAME := value`` assignments of a Makefile."""
    out = {}
    with open(path) as f:
        for line in f:
            m = re.match(r"^([A-Z_]+)\s*(\?=|:=)\s*(.*)$", line.rstrip("\n"))
            if m and m.group(1) not in out:
                out[m.group(1)] = m.group(3)
    return out


def _compile_commands(tmp_path: str):
    mk = _makefile_vars(os.path.join(_NATIVE_DIR, "Makefile"))
    flags = [
        "-I" + os.path.join(_NATIVE_DIR, f[2:])
        if f.startswith("-I") and not os.path.isabs(f[2:]) else f
        for f in shlex.split(mk["CXXFLAGS"])
    ]
    srcs = [os.path.join(_NATIVE_DIR, s) for s in shlex.split(mk["SRCS"])]
    cxx = mk.get("CXX", "g++")
    return [[cxx, *flags, *srcs, *shlex.split(mk["LDFLAGS"]), "-o", tmp_path]]


def _native_inputs():
    inputs = [os.path.join(_NATIVE_DIR, "Makefile")]
    for root, _dirs, files in os.walk(_NATIVE_DIR):
        inputs += [os.path.join(root, f) for f in files if f.endswith((".cpp", ".h"))]
    return inputs


if os.path.isdir(_NATIVE_DIR):
    build_once(_SO_PATH, _native_inputs(), _compile_commands)
elif not os.path.exists(_SO_PATH):
    raise ImportError(f"no native sources at {_NATIVE_DIR} and no {_SO_PATH}")

# Completion callback: (ctx, status_code). ctypes re-acquires the GIL when the
# reactor thread calls back into Python (the pybind equivalent needed explicit
# gil_scoped_acquire; here it is automatic).
COMPLETION_CB = CFUNCTYPE(None, c_void_p, c_int)
LOG_SINK_CB = CFUNCTYPE(None, c_int, c_char_p)


# Older glibc keeps shm_open/shm_unlink in librt; a .so built against a glibc
# that folded them into libc then fails to load with "undefined symbol:
# shm_open". Preloading librt globally resolves the symbols either way.
try:
    ctypes.CDLL("librt.so.1", mode=ctypes.RTLD_GLOBAL)
except OSError:
    pass  # no librt (musl / new glibc): the symbols live in libc already

lib = ctypes.CDLL(_SO_PATH)

# ---- logging ----
lib.its_set_log_level.argtypes = [c_int]
lib.its_set_log_sink.argtypes = [LOG_SINK_CB]
lib.its_log.argtypes = [c_int, c_char_p]

# ---- server ----
lib.its_server_create.argtypes = [
    c_char_p, c_int, c_uint64, c_uint64, c_int, c_uint64, c_int, c_double, c_double, c_int,
    c_int, c_char_p, c_uint64,
]
lib.its_server_create.restype = c_void_p
lib.its_server_start.argtypes = [c_void_p]
lib.its_server_start.restype = c_int
lib.its_server_stop.argtypes = [c_void_p]
lib.its_server_destroy.argtypes = [c_void_p]
lib.its_server_port.argtypes = [c_void_p]
lib.its_server_port.restype = c_int
lib.its_server_kvmap_len.argtypes = [c_void_p]
lib.its_server_kvmap_len.restype = c_uint64
lib.its_server_purge.argtypes = [c_void_p]
lib.its_server_purge.restype = c_uint64
lib.its_server_evict.argtypes = [c_void_p, c_double, c_double]
lib.its_server_evict.restype = c_uint64
lib.its_server_usage.argtypes = [c_void_p]
lib.its_server_usage.restype = c_double
lib.its_server_stats_json.argtypes = [c_void_p, c_char_p, c_int]
lib.its_server_stats_json.restype = c_int

# ---- client ----
# Trailing two ints: enable_ring (descriptor-ring data plane,
# docs/descriptor_ring.md) and ring_slots (0 = native default).
lib.its_conn_create.argtypes = [
    c_char_p, c_int, c_int, c_int, c_int, c_int, c_int, c_int,
]
lib.its_conn_create.restype = c_void_p
lib.its_conn_connect.argtypes = [c_void_p]
lib.its_conn_connect.restype = c_int
lib.its_conn_shm_active.argtypes = [c_void_p]
lib.its_conn_shm_active.restype = c_int
lib.its_conn_ring_active.argtypes = [c_void_p]
lib.its_conn_ring_active.restype = c_int
lib.its_conn_ring_name.argtypes = [c_void_p, c_char_p, c_int]
lib.its_conn_ring_name.restype = c_int
# Client ring ledger: posted, doorbells, full fallbacks, meta fallbacks,
# completions (lib.InfinityConnection.ring_stats).
lib.its_conn_ring_counters.argtypes = [
    c_void_p, POINTER(c_uint64), POINTER(c_uint64), POINTER(c_uint64),
    POINTER(c_uint64), POINTER(c_uint64),
]
# Mechanism ledger: batch slots, batch ops, reactor poll hits, poll
# arms (its_conn_ring_counters keeps its 5-value shape for stability).
lib.its_conn_ring_poll_counters.argtypes = [
    c_void_p, POINTER(c_uint64), POINTER(c_uint64), POINTER(c_uint64),
    POINTER(c_uint64),
]
# Multi-op batch grouping: bracket one event-loop tick's ring posts so a
# coalesced flush publishes as one batch slot (docs/descriptor_ring.md).
lib.its_conn_ring_group_begin.argtypes = [c_void_p]
lib.its_conn_ring_group_end.argtypes = [c_void_p]
lib.its_conn_close.argtypes = [c_void_p]
lib.its_conn_destroy.argtypes = [c_void_p]
lib.its_conn_connected.argtypes = [c_void_p]
lib.its_conn_connected.restype = c_int
lib.its_conn_register_mr.argtypes = [c_void_p, c_void_p, c_uint64]
lib.its_conn_register_mr.restype = c_int
lib.its_conn_unregister_mr.argtypes = [c_void_p, c_void_p]
lib.its_conn_unregister_mr.restype = c_int
lib.its_conn_alloc_shm_mr.argtypes = [c_void_p, c_uint64]
lib.its_conn_alloc_shm_mr.restype = c_void_p
# Trailing c_int: QoS class tag (0 = foreground/default, 1 = background —
# wire.PRIORITY_*; see docs/qos.md). The two trailing c_uint64s are the
# per-op trace context (trace id + client span id, docs/observability.md);
# 0/0 = untraced, zero extra wire bytes.
_batch_args = [
    c_void_p, c_char_p, c_uint64, c_uint32, POINTER(c_uint64), c_uint32, c_void_p,
    COMPLETION_CB, c_void_p, c_int, c_uint64, c_uint64,
]
lib.its_conn_put_batch.argtypes = _batch_args
lib.its_conn_put_batch.restype = c_int
lib.its_conn_get_batch.argtypes = _batch_args
lib.its_conn_get_batch.restype = c_int
_batch_sync_args = [
    c_void_p, c_char_p, c_uint64, c_uint32, POINTER(c_uint64), c_uint32, c_void_p, c_int,
    c_uint64, c_uint64,
]
lib.its_conn_put_batch_sync.argtypes = _batch_sync_args
lib.its_conn_put_batch_sync.restype = c_int
lib.its_conn_get_batch_sync.argtypes = _batch_sync_args
lib.its_conn_get_batch_sync.restype = c_int
lib.its_conn_tcp_put.argtypes = [c_void_p, c_char_p, c_void_p, c_uint64]
lib.its_conn_tcp_put.restype = c_int
lib.its_conn_tcp_get.argtypes = [c_void_p, c_char_p, POINTER(POINTER(c_uint8)), POINTER(c_uint64)]
lib.its_conn_tcp_get.restype = c_int
lib.its_free.argtypes = [c_void_p]
lib.its_conn_check_exist.argtypes = [c_void_p, c_char_p]
lib.its_conn_check_exist.restype = c_int
lib.its_conn_match_last_index.argtypes = [c_void_p, c_char_p, c_uint64, c_uint32]
lib.its_conn_match_last_index.restype = c_int32
lib.its_conn_delete_keys.argtypes = [c_void_p, c_char_p, c_uint64, c_uint32]
lib.its_conn_delete_keys.restype = c_int64
lib.its_conn_stat_json.argtypes = [c_void_p, c_char_p, c_int]
lib.its_conn_stat_json.restype = c_int
# Event-fd completion ring (fd owned by the Python side; never closed natively).
lib.its_conn_set_completion_fd.argtypes = [c_void_p, c_int]
lib.its_conn_drain_completions.argtypes = [
    c_void_p, POINTER(c_uint64), POINTER(c_int32), c_int,
]
lib.its_conn_drain_completions.restype = c_int
# Wakeup-coalescing counters: ring pushes vs eventfd writes (empty->non-empty
# transitions only), the completion_batch_size numerator/denominator.
lib.its_conn_completion_counters.argtypes = [
    c_void_p, POINTER(c_uint64), POINTER(c_uint64),
]

# ---- mempool (unit-test surface) ----
lib.its_mm_create.argtypes = [c_uint64, c_uint64, c_int]
lib.its_mm_create.restype = c_void_p
lib.its_mm_destroy.argtypes = [c_void_p]
lib.its_mm_allocate.argtypes = [c_void_p, c_uint64, c_uint32, POINTER(c_void_p)]
lib.its_mm_allocate.restype = c_int
lib.its_mm_deallocate.argtypes = [c_void_p, c_void_p, c_uint64]
lib.its_mm_usage.argtypes = [c_void_p]
lib.its_mm_usage.restype = c_double
lib.its_mm_extend.argtypes = [c_void_p, c_uint64]
lib.its_mm_extend.restype = c_int
lib.its_mm_total_bytes.argtypes = [c_void_p]
lib.its_mm_total_bytes.restype = c_uint64
lib.its_mm_used_bytes.argtypes = [c_void_p]
lib.its_mm_used_bytes.restype = c_uint64
lib.its_mm_pinned.argtypes = [c_void_p]
lib.its_mm_pinned.restype = c_int
