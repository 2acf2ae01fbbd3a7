"""Shared rate-shaped measurement helper.

Copy of ``infinistore_tpu/shaping.py`` for the PyTorch port, which imports
nothing of ``infinistore_tpu``; keep the two in step.

One implementation of the shaped striped roundtrip, used by ``bench.py``,
``tools/striping_emulation.py``, and ``tests/test_striping_shaped.py`` — the
three must measure the same workload or the bench, tool, and CI test silently
diverge. The shaping itself is ``pacing_rate_mbps`` (SO_MAX_PACING_RATE, TCP
internal pacing): the client knob caps PUT egress, the server knob caps GET
egress, together emulating a bandwidth-limited cross-host stream on loopback.
"""

import asyncio
import time
from typing import Optional, Tuple

import numpy as np

from . import wire
from .config import ClientConfig
from .lib import InfinityConnection, StripedConnection

BLOCK = 64 << 10


def shaped_config(port: int, cap_mbps: Optional[int]) -> ClientConfig:
    """Loopback client config with per-connection pacing and shm disabled
    (every byte rides the paced socket).

    ``cap_mbps`` of ``None`` or ``0`` means UNSHAPED: pacing off, but shm
    still off — the socket path without a bandwidth cap, the config the
    shaping edge-case tests pin (a zero cap must be a no-op, not a stall).

    Shm staying off also matters for the ADAPTIVE striped scheduler
    (lib.StripedConnection): its same-host detector keys on the shm fast
    path being active, so a shaped connection never auto-collapses to one
    stripe — pacing emulates a cross-host link and the scheduler must keep
    striping it, merely shrinking each stripe's chunks to the paced rate
    (throughput EWMA x target chunk latency)."""
    return ClientConfig(
        host_addr="127.0.0.1",
        service_port=port,
        log_level="error",
        enable_shm=False,  # force the socket path: that is what stripes split
        pacing_rate_mbps=int(cap_mbps or 0),
    )


def shaped_roundtrip_mbps(
    port: int,
    cap_mbps: Optional[int],
    streams: int,
    nbytes: int,
    key_prefix: str = "shaped",
    verify: bool = False,
    stats_out: Optional[dict] = None,
) -> Tuple[float, Optional[bool]]:
    """Aggregate write+read MB/s of the headline workload over N paced
    stripes against the (server-side paced) store on ``port``.

    Returns (mbps, verified): ``verified`` is None unless ``verify`` — the
    verifying variant reads into a second buffer and compares, at the cost of
    a larger working set. When ``stats_out`` is given and the connection is
    striped, the adaptive scheduler's ``data_plane_stats()`` snapshot is
    copied into it after the measurement (per-stripe chunk counts + EWMA —
    how the tests see that pacing shrank the chunks rather than starving a
    stripe).
    """
    cfg = shaped_config(port, cap_mbps)
    conn = (
        StripedConnection(cfg, streams=streams)
        if streams > 1
        else InfinityConnection(cfg)
    )
    conn.connect()
    n = nbytes // BLOCK
    src = np.random.randint(0, 256, size=n * BLOCK, dtype=np.uint8)
    conn.register_mr(src)
    dst = src
    if verify:
        dst = np.zeros_like(src)
        conn.register_mr(dst)
    pairs = [(f"{key_prefix}{streams}-{i}", i * BLOCK) for i in range(n)]

    async def once():
        # Explicitly FOREGROUND (qos_kwargs encodes nothing for class 0):
        # the shaped roundtrip measures the untagged wire path byte-for-byte.
        fg = wire.qos_kwargs(conn, wire.PRIORITY_FOREGROUND)
        await conn.write_cache_async(pairs, BLOCK, src.ctypes.data, **fg)
        await conn.read_cache_async(pairs, BLOCK, dst.ctypes.data, **fg)

    t0 = time.perf_counter()
    asyncio.run(once())
    dt = time.perf_counter() - t0
    verified = bool(np.array_equal(src, dst)) if verify else None
    if stats_out is not None and hasattr(conn, "data_plane_stats"):
        stats_out.update(conn.data_plane_stats())
    conn.close()
    return 2 * n * BLOCK / dt / (1 << 20), verified
