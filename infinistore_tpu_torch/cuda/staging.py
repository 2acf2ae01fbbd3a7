"""Device <-> host staging for the data plane (port of
``infinistore_tpu/tpu/staging.py``).

The store moves host bytes; the engine's KV cache lives in device memory.
This module owns the hop between them and keeps it to one host copy per
direction:

- Writes ship directly from the pinned host tensors the device-to-host copy
  lands in (``StagedTransfer.wait`` returns zero-copy views of them). On CUDA
  that copy runs on a side stream, ordered after the work already queued on
  the compute stream, so it overlaps whatever the compute stream does next.
  The buffer is registered with the connection for the transfer's lifetime
  and the shm data plane memcpys it straight into the server pool.
- Reads land in the pool below. When the server is same-host the pool is
  allocated with ``alloc_shm_mr``, so the server pushes blocks into it in one
  round trip. When the pool serves a CUDA device its buffer is page-locked
  with ``cudaHostRegister``, so the host-to-device upload is a DMA.
"""

import math
import weakref
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _ext


class StagingPoolExhausted(RuntimeError):
    """`HostStagingPool.reserve` could not find a contiguous free run.

    Deliberately a distinct type: callers treat exhaustion as backpressure
    (skip the speculative prefetch, fall back to the gated load path), not
    as a bug — so it must be catchable without swallowing real errors."""


class StagingLease:
    """A reserved contiguous run of staging-pool slots.

    Handed out by ``HostStagingPool.reserve``; release() (idempotent)
    returns the slots to the pool. The lease is pure accounting — the pool's
    buffer is shared, and the lease only guarantees no OTHER reserver gets
    these slots while it is held."""

    def __init__(self, pool: "HostStagingPool", start_slot: int, num_slots: int):
        self.pool = pool
        self.start_slot = start_slot
        self.num_slots = num_slots
        self._released = False

    @property
    def offset(self) -> int:
        """Byte offset of the lease's first slot within the pool buffer."""
        return self.start_slot * self.pool.block_size

    def view(self, nbytes: Optional[int] = None) -> np.ndarray:
        """Zero-copy uint8 view of the leased span (nbytes trims the tail)."""
        span = self.num_slots * self.pool.block_size
        if nbytes is not None:
            if nbytes > span:
                raise ValueError(f"nbytes {nbytes} > leased span {span}")
            span = nbytes
        return self.pool.buf[self.offset : self.offset + span]

    def release(self) -> None:
        """Return the slots to the pool (idempotent)."""
        if not self._released:
            self._released = True
            self.pool._release_run(self.start_slot, self.num_slots)


def _host_bytes(t: torch.Tensor) -> np.ndarray:
    """Zero-copy flat uint8 numpy view of a contiguous CPU tensor (numpy has
    no bfloat16, so the bytes travel as uint8)."""
    return t.reshape(-1).view(torch.uint8).numpy()


class StagedTransfer:
    """Handle for in-flight device-to-host copies.

    ``wait()`` returns flat uint8 host views of the transferred data without
    any further copy. Keep the transfer object alive until the network is
    done with the views — it owns the host tensors behind them.

    On CUDA each source is copied into a pinned host tensor on ``stream`` (a
    side stream), which first waits for the work already queued on the
    source's current stream; ``record_stream`` keeps the source's memory from
    being reused before the copy has read it, and ``wait()`` synchronises on
    a CUDA event recorded after the copies. CPU sources need no copy: the
    views alias them (they must be contiguous)."""

    def __init__(self, tensors: Sequence[torch.Tensor], stream=None):
        self._event = None
        cuda = [t for t in tensors if t.device.type != "cpu"]
        if not cuda:
            self._host = [t.contiguous() for t in tensors]
            self._views: Optional[List[np.ndarray]] = None
            return
        device = cuda[0].device
        if any(t.device != device for t in tensors):
            raise ValueError("StagedTransfer: all tensors must live on one device")
        if stream is None:
            stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        host = []
        with torch.cuda.stream(stream):
            for t in tensors:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                t.record_stream(stream)
                host.append(h)
            self._event = torch.cuda.Event()
            self._event.record(stream)
        self._host = host
        self._views = None

    def wait(self) -> List[np.ndarray]:
        """Block until the data is host-visible; returns zero-copy flat uint8
        host views (one per input tensor)."""
        if self._views is None:
            if self._event is not None:
                self._event.synchronize()
            self._views = [_host_bytes(h) for h in self._host]
        return self._views


class RegisteredTransfer:
    """A StagedTransfer whose host buffers are registered with a connection
    for the duration of one network op: ``wait()`` registers, ``release()``
    unregisters (call after the op's future resolves)."""

    def __init__(self, transfer: StagedTransfer, conn):
        self.transfer = transfer
        self.conn = conn
        self._registered: List[np.ndarray] = []

    def wait(self) -> List[np.ndarray]:
        """Block for the device-to-host copies, then register the host views
        with the connection (idempotent); returns the registered views."""
        hosts = self.transfer.wait()
        if not self._registered:
            for h in hosts:
                self.conn.register_mr(h.ctypes.data, h.nbytes)
            self._registered = hosts
        return hosts

    def release(self):
        """Unregister the host views (call after the network op's future
        resolves). Best-effort on a closed connection."""
        # Best-effort cleanup: a connection closed mid-flight already cleared
        # its region list — that must not mask the transport error the
        # caller is about to see (nor abort sibling releases).
        for h in self._registered:
            try:
                self.conn.unregister_mr(h.ctypes.data)
            except Exception:
                pass
        self._registered = []


class HostStagingPool:
    """A connection-registered host buffer carved into uniform block slots
    (the client-side mirror of the server's mempool).

    When ``conn`` is same-host with shm enabled, the pool is allocated via
    ``alloc_shm_mr`` so the server maps it too and batched ops ride the
    one-RTT PutFrom/GetInto path; otherwise it is a plain page-aligned
    registered buffer and ops use the socket (or two-phase shm) plane.

    ``device``: the device the pool stages for. For a CUDA device the buffer
    is page-locked (``cudaHostRegister``) so uploads from it are DMA; call
    ``close()`` before closing the connection, whose shm segment it is."""

    def __init__(self, nbytes: int, block_size: int, conn=None, align: int = 4096,
                 device="cuda"):
        if block_size <= 0 or nbytes < block_size:
            raise ValueError("need nbytes >= block_size > 0")
        self.device = _ext.resolve_device(device)
        self.block_size = block_size
        self.num_slots = nbytes // block_size
        self.conn = conn
        self.server_mapped = False
        self._nbytes = nbytes
        self._align = align
        self._shm_backed = False
        self._pinned_ptr = 0
        self._d2h_stream = None
        self._allocate(conn, nbytes, align)
        # Self-heal across reconnects: an ``alloc_shm_mr``-backed pool dies
        # with its connection's old segment (reconnect() unmaps it), which
        # would leave every later read/write of this pool raising against an
        # unregistered (worse: unmapped) buffer FOREVER on an otherwise
        # healed member. Re-back the pool on the fresh connection instead.
        # Weakly bound so a short-lived pool never pins itself to the
        # connection through its own listener. A StripedConnection has no
        # listener list of its own: its shm segments live on stripe 0, so
        # that is the reconnect that kills them — attach there.
        owner = conn
        if getattr(conn, "_reconnect_listeners", None) is None:
            stripes = getattr(conn, "conns", None)
            if stripes:
                owner = stripes[0]
        listeners = getattr(owner, "_reconnect_listeners", None)
        if listeners is not None:
            ref = weakref.WeakMethod(self._refresh_after_reconnect)
            listeners.append(lambda: (lambda m: m() if m is not None else None)(ref()))
        # Slot reservation state (reserve/release): a per-slot taken flag.
        # Reservation is OPT-IN — _LayerRegions carves the pool by fixed
        # layout on a pool it owns outright; a pool shared by reservers must
        # only be used through reserve().
        self._taken = bytearray(self.num_slots)
        self._reserved_slots = 0

    def _allocate(self, conn, nbytes: int, align: int):
        buf = None
        if conn is not None:
            buf = conn.alloc_shm_mr(nbytes)  # mmap: page-aligned by nature
            if buf is not None:
                self.server_mapped = conn.shm_active
                self._shm_backed = True
        if buf is None:
            # Over-allocate to align the base: DCN readv/writev and mlock both
            # like page-aligned bases.
            raw = np.zeros(nbytes + align, dtype=np.uint8)
            base_off = (-raw.ctypes.data) % align
            self._raw = raw  # keep alive
            buf = raw[base_off : base_off + nbytes]
            self._shm_backed = False
            if conn is not None:
                conn.register_mr(buf.ctypes.data, nbytes)
        self.buf = buf
        if self.device.type == "cuda":
            self._pin(buf)

    def _pin(self, buf: np.ndarray) -> None:
        code = int(torch.cuda.cudart().cudaHostRegister(buf.ctypes.data, buf.nbytes, 0))
        if code != 0:
            raise RuntimeError(f"cudaHostRegister of the staging pool failed: CUDA error {code}")
        self._pinned_ptr = buf.ctypes.data

    def close(self) -> None:
        """Release the page lock on the buffer (idempotent). The buffer stays
        usable as plain host memory."""
        if self._pinned_ptr:
            ptr, self._pinned_ptr = self._pinned_ptr, 0
            code = int(torch.cuda.cudart().cudaHostUnregister(ptr))
            if code != 0:
                raise RuntimeError(f"cudaHostUnregister failed: CUDA error {code}")

    def _refresh_after_reconnect(self):
        """Reconnect listener: a plain registered buffer survived (the
        reconnect re-registered it), but an shm segment did not — replace it
        on the fresh connection. Slot accounting is untouched: leases stay
        valid as accounting; their STAGED BYTES are gone, exactly like the
        in-flight ops the reconnect already failed."""
        if not self._shm_backed:
            return
        self.server_mapped = False
        # The old segment is already unmapped: its page lock goes with it.
        self._pinned_ptr = 0
        self._allocate(self.conn, self._nbytes, self._align)

    @property
    def slots_in_use(self) -> int:
        """Slots currently held by unreleased leases (reserve() users)."""
        return self._reserved_slots

    def reserve(self, slots: int) -> StagingLease:
        """Reserve a CONTIGUOUS run of ``slots`` slots (first fit).

        Contiguity is what lets a whole leased region ship as one network
        read and upload as one device transfer. Raises
        :class:`StagingPoolExhausted` when no run fits — callers treat that
        as backpressure, not failure."""
        if slots <= 0:
            raise ValueError("need slots > 0")
        run = 0
        for i in range(self.num_slots):
            run = 0 if self._taken[i] else run + 1
            if run == slots:
                start = i - slots + 1
                for j in range(start, start + slots):
                    self._taken[j] = 1
                self._reserved_slots += slots
                return StagingLease(self, start, slots)
        raise StagingPoolExhausted(
            f"no contiguous run of {slots} slots free "
            f"({self._reserved_slots}/{self.num_slots} reserved)"
        )

    def _release_run(self, start_slot: int, num_slots: int) -> None:
        for j in range(start_slot, start_slot + num_slots):
            self._taken[j] = 0
        self._reserved_slots -= num_slots

    @property
    def base_ptr(self) -> int:
        return self.buf.ctypes.data

    def slot_offset(self, slot: int) -> int:
        """Byte offset of a slot within the pool's registered buffer."""
        if not (0 <= slot < self.num_slots):
            raise IndexError(f"slot {slot} out of range [0, {self.num_slots})")
        return slot * self.block_size

    def slot_view(self, slot: int, nbytes: Optional[int] = None) -> np.ndarray:
        """Zero-copy uint8 view of one slot (nbytes trims the tail)."""
        off = self.slot_offset(slot)
        return self.buf[off : off + (nbytes or self.block_size)]

    def slots_for(self, arr_nbytes: int) -> int:
        """How many slots one array of arr_nbytes occupies."""
        return math.ceil(arr_nbytes / self.block_size)

    # -- device -> host ------------------------------------------------------

    def stage_out(self, tensors: Sequence[torch.Tensor]) -> "RegisteredTransfer":
        """Start device-to-host copies; the returned transfer's ``wait()``
        gives zero-copy registered host views to ship from (call
        ``release()`` after the network op completes)."""
        if self.conn is None:
            raise ValueError("stage_out needs a connection to register with")
        stream = None
        if any(t.device.type == "cuda" for t in tensors):
            if self._d2h_stream is None:
                self._d2h_stream = torch.cuda.Stream(self.device)
            stream = self._d2h_stream
        return RegisteredTransfer(StagedTransfer(tensors, stream), self.conn)

    # -- host -> device ------------------------------------------------------

    def stage_in(
        self,
        slots: Sequence[int],
        shape: Tuple[int, ...],
        dtype: torch.dtype,
        device=None,
    ) -> List[torch.Tensor]:
        """Upload staged blocks to ``device`` (default: the pool's device).
        One tensor per slot. The copies are complete when this returns, so
        the slots may be reused at once."""
        target = self.device if device is None else _ext.resolve_device(device)
        nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        out = []
        for slot in slots:
            host = torch.from_numpy(self.slot_view(slot, nbytes)).view(dtype).reshape(shape)
            out.append(host.to(target, copy=True))
        return out
