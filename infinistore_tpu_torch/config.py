"""Configuration for client and server.

Copy of ``infinistore_tpu/config.py`` for the PyTorch port, which imports
nothing of ``infinistore_tpu``; keep the two in step.

Single source of truth — the reference duplicates these structs in four places
by convention (C++ config.h:13-33, pybind.cpp, lib.py:38-152, server.py
argparse; the maintenance rule is documented at
reference src/config.h:7-12). Here the dataclasses below are the only
definition; the native layer receives plain scalars over the C API.
"""

import os
from dataclasses import dataclass, field

# Connection types (reference lib.py TYPE_RDMA/TYPE_TCP). On TPU VMs there is
# no ibverbs: TYPE_RDMA selects the batched zero-copy DCN data plane (the
# direct successor of the reference's RDMA path — same API, same semantics),
# TYPE_TCP the simple single-key path. Both ride the same socket.
TYPE_RDMA = "RDMA"
TYPE_TCP = "TCP"
TYPE_DCN = TYPE_RDMA  # TPU-native name for the batched data plane

# Link types are kept for config compatibility; they are advisory on TPU VMs
# (reference LINK_ETHERNET/LINK_IB choose the ibverbs GID type).
LINK_ETHERNET = "Ethernet"
LINK_IB = "IB"
LINK_DCN = "DCN"
LINK_ICI = "ICI"

SUPPORTED_CONN_TYPES = (TYPE_RDMA, TYPE_TCP)
SUPPORTED_LINK_TYPES = (LINK_ETHERNET, LINK_IB, LINK_DCN, LINK_ICI)


@dataclass
class ClientConfig:
    """Client-side connection config (reference ClientConfig, lib.py:38-91)."""

    host_addr: str = "127.0.0.1"
    service_port: int = 22345
    connection_type: str = TYPE_RDMA
    log_level: str = "warning"
    connect_timeout_ms: int = 10000
    # Deadline for synchronous control ops (tcp put/get, check_exist,
    # match_last_index, delete, stat): a stalled-but-connected server fails
    # the call with a typed error instead of hanging. <= 0 waits forever.
    op_timeout_ms: int = 30000
    # Same-host shm fast path: map the server's shm-backed pools and move
    # batched payloads with one memcpy instead of the socket. Auto-degrades
    # to the socket path for remote servers.
    enable_shm: bool = True
    # Egress cap for this connection in MB/s (SO_MAX_PACING_RATE — TCP
    # internal pacing, no qdisc needed). 0 = unlimited. Production: fairness
    # on a shared DCN link; tests: emulate a bandwidth-capped cross-host
    # stream on loopback (tools/striping_emulation.py). Caps PUTs; the
    # server-side knob caps GETs.
    pacing_rate_mbps: int = 0
    # Descriptor-ring data plane (docs/descriptor_ring.md): when the shm
    # fast path is up, batched segment ops post as fixed-slot descriptors in
    # a shared submission ring (no per-op socket writes; the socket is
    # demoted to a doze/wake doorbell) and complete via a shared completion
    # ring. Auto-degrades to the byte-identical socket path when shm is
    # unavailable or the server declines the attach.
    enable_ring: bool = True
    # Submission-slot count (power of two; 0 = native default, 64). The
    # in-flight ring-op bound equals it; a full ring falls back to the
    # socket path per-op (counted backpressure, never an error).
    ring_slots: int = 0
    # Opt-in recovery: when the native reactor reports the connection dead,
    # blocking ops reconnect (re-registering plain MRs) and retry once. A
    # restarted server looks like a cold cache, never a dead engine. The
    # reference has no reconnection at all (SURVEY.md §5.3).
    auto_reconnect: bool = False
    # Reference-compat knobs, advisory on TPU (no ibverbs device to pick):
    dev_name: str = ""
    ib_port: int = 1
    link_type: str = LINK_DCN
    hint_gid_index: int = -1

    def verify(self) -> None:
        """Validate field values; raises ValueError on any bad setting
        (mirrors the reference ClientConfig.verify, lib.py:76-91)."""
        if self.connection_type not in SUPPORTED_CONN_TYPES:
            raise ValueError(
                f"connection_type must be one of {SUPPORTED_CONN_TYPES}, "
                f"got {self.connection_type!r}"
            )
        if not (0 < self.service_port < 65536):
            raise ValueError(f"invalid service_port {self.service_port}")
        if self.log_level.lower() not in ("debug", "info", "warning", "error", "off"):
            raise ValueError(f"invalid log_level {self.log_level!r}")


@dataclass
class ServerConfig:
    """Server config (reference ServerConfig, lib.py:94-152, server.py:42-148)."""

    host: str = "0.0.0.0"
    service_port: int = 22345
    manage_port: int = 28080
    log_level: str = "info"
    # Memory pool sizing (reference defaults: 16GB prealloc, 64KB min alloc).
    prealloc_size: int = 16  # GB
    minimal_allocate_size: int = 64  # KB
    auto_increase: bool = False
    extend_size: int = 10  # GB per auto-extend pool
    pin_memory: bool = True
    # Eviction (reference server.py: periodic 0.6/0.8 every 5s; on-demand
    # 0.8/0.95 hardcoded in infinistore.cpp:52-53).
    evict_enabled: bool = False
    evict_min_threshold: float = 0.6
    evict_max_threshold: float = 0.8
    evict_interval: float = 5.0
    on_demand_evict_min: float = 0.8
    on_demand_evict_max: float = 0.95
    # Back pools with named /dev/shm segments so same-host clients get the
    # one-memcpy fast path (falls back to anonymous memory when unavailable).
    enable_shm: bool = True
    # Egress cap per accepted connection in MB/s (SO_MAX_PACING_RATE). Caps
    # the server->client GET direction; 0 = unlimited.
    pacing_rate_mbps: int = 0
    # File-backed spill tier: evicted blocks demote to an mmap'd (and
    # immediately unlinked — crash-safe) file under spill_dir instead of
    # being dropped, and promote back to RAM on access. Capacity beyond RAM
    # — the tier the reference only aspired to (its design.rst:36). Empty
    # dir or 0 size = off (evict drops, reference behavior).
    spill_dir: str = ""
    spill_size: int = 0  # GB
    # Reference-compat knobs, advisory on TPU:
    dev_name: str = ""
    ib_port: int = 1
    link_type: str = LINK_DCN
    hint_gid_index: int = -1
    # Extra fields tolerated for CLI forward-compat.
    extra: dict = field(default_factory=dict)

    def __post_init__(self):
        # Spill-tier misconfiguration fails AT CONSTRUCTION with a clear
        # message — not as a native-layer failure at the first demotion,
        # minutes into serving (docs/tiering.md). The low-level
        # ``start_local_server(spill_dir=...)`` test/bench entry point
        # bypasses this dataclass on purpose (the native layer's
        # disable-the-tier-not-the-server degrade stays covered by
        # tests/test_spill_tier.py).
        self._verify_spill()

    def _verify_spill(self) -> None:
        if self.spill_size < 0:
            raise ValueError(
                f"spill_size must be >= 0 GB, got {self.spill_size}"
            )
        if self.spill_dir and self.spill_size == 0:
            raise ValueError(
                f"spill_dir {self.spill_dir!r} is set but spill_size is 0 — "
                "give the tier capacity (GB) or clear spill_dir"
            )
        if self.spill_size > 0 and not self.spill_dir:
            raise ValueError(
                f"spill_size={self.spill_size} GB but spill_dir is empty — "
                "name the directory backing the spill file"
            )
        if self.spill_dir and not os.path.isdir(self.spill_dir):
            raise ValueError(
                f"spill_dir {self.spill_dir!r} does not exist (or is not a "
                "directory) — create it before starting the server"
            )

    def verify(self) -> None:
        """Validate field values; raises ValueError on any bad setting
        (mirrors the reference ServerConfig.verify, lib.py:140-152)."""
        if not (0 < self.service_port < 65536) or not (0 < self.manage_port < 65536):
            raise ValueError("ports must be in (0, 65536)")
        if self.service_port == self.manage_port:
            raise ValueError("service_port and manage_port must differ")
        if self.prealloc_size <= 0:
            raise ValueError("prealloc_size must be positive (GB)")
        # Reference enforces a 16KB floor (lib.py:140-152).
        if self.minimal_allocate_size < 16:
            raise ValueError("minimal_allocate_size must be >= 16 (KB)")
        if (self.minimal_allocate_size & (self.minimal_allocate_size - 1)) != 0:
            raise ValueError("minimal_allocate_size must be a power of two (KB)")
        if not (0.0 < self.evict_min_threshold < self.evict_max_threshold <= 1.0):
            raise ValueError("need 0 < evict_min_threshold < evict_max_threshold <= 1")
        if not (0.0 < self.on_demand_evict_min < self.on_demand_evict_max <= 1.0):
            raise ValueError("need 0 < on_demand_evict_min < on_demand_evict_max <= 1")
        if self.evict_interval <= 0:
            raise ValueError("evict_interval must be positive seconds")
        self._verify_spill()

    @property
    def prealloc_bytes(self) -> int:
        return self.prealloc_size << 30

    @property
    def block_bytes(self) -> int:
        return self.minimal_allocate_size << 10

    @property
    def extend_bytes(self) -> int:
        return self.extend_size << 30

    @property
    def spill_bytes(self) -> int:
        return self.spill_size << 30
