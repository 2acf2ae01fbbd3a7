"""Same-mesh KV-block transfer: a request's blocks move device to device,
with no host and no store (port of ``infinistore_tpu/tpu/ici.py``).

When the producer (prefill) and the consumer (decode) of a KV block run in
one process over one ordered list of devices, blocks move HBM to HBM; the
store stays the path between processes and meshes (``KVConnector.handoff``
takes this transport when it has one, the store otherwise).

The JAX package runs one SPMD program over a sharded array ``[axis_size,
num_blocks, *block]`` and moves shards with ``ppermute``. Here the mesh is
an ordered list of torch devices held by one process, a sharded array is a
list of per-shard tensors ``[num_blocks, *block]`` (shard ``i`` on
``mesh[i]``), and a ``ppermute`` is a copy into a buffer allocated on the
destination shard's device (``Tensor.copy_``: a peer copy when the devices
differ, a device-to-device copy when a mesh names one device twice, with
the same code either way). The gathers and scatters are the port's kernels
K1 and K2 (``cuda/paged.py``; their plain versions on the CPU), so a
handoff of every layer is one K1 launch over all 2L caches, one copy and
one K2 launch (``MAX_CACHES`` caches a launch; longer lists take more).
Each launch makes its caches' device current (``_ext.on_device``): K1 runs
on ``mesh[src]`` and K2 on ``mesh[dst]``, whichever card the caller has
current.
"""

from typing import List, Sequence, Tuple

import torch

from . import _ext
from .paged import gather_blocks, gather_blocks_many, scatter_blocks_many

Shards = List[torch.Tensor]


def mesh_from_devices(devices=None) -> Tuple[torch.device, ...]:
    """A 1-D mesh: the ordered devices of one transfer axis. Without
    ``devices``, every CUDA device (raises when there is none). A device may
    appear more than once, so that a disaggregated pair fits on one card."""
    if devices is None:
        _ext.resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    mesh = tuple(_ext.resolve_device(d) for d in devices)
    # "cuda" names the current card, as a tensor made there records it.
    mesh = tuple(torch.device("cuda", torch.cuda.current_device())
                 if d.type == "cuda" and d.index is None else d for d in mesh)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


class IciBlockTransfer:
    """Point-to-point KV-block moves across one mesh axis.

    ``perm`` is a list of ``(src_index, dst_index)`` pairs along the axis,
    typically ``[(prefill_idx, decode_idx)]`` for a disaggregated pair.
    ``transfer`` returns zeros on shards no pair names as a destination
    (``ppermute``'s semantics); the ``handoff_*`` calls change only the
    destination shard's caches, in place, and return them.

    ``launches`` counts transfer dispatches: one per call, whatever the
    number of layers, as the JAX package counts its compiled programs."""

    def __init__(self, mesh: Sequence, axis_name: str, perm: Sequence[Tuple[int, int]]):
        self.mesh = mesh_from_devices(mesh)
        self.axis_name = axis_name
        self.axis_size = len(self.mesh)
        self.perm = tuple((int(s), int(d)) for s, d in perm)
        for s, d in self.perm:
            self._check_index(s, "perm src")
            self._check_index(d, "perm dst")
        self.launches = 0

    def _check_index(self, i: int, what: str):
        if not 0 <= int(i) < self.axis_size:
            raise ValueError(
                f"{what} index {i} out of range for mesh axis "
                f"'{self.axis_name}' of size {self.axis_size}"
            )

    def _check_shards(self, what: str, shards) -> Shards:
        """One tensor per mesh device, each on its device."""
        shards = list(shards)
        if len(shards) != self.axis_size:
            raise ValueError(
                f"{what}: {len(shards)} shards for mesh axis '{self.axis_name}' "
                f"of size {self.axis_size}"
            )
        for i, (t, dev) in enumerate(zip(shards, self.mesh)):
            if t.device != dev:
                raise ValueError(f"{what}: shard {i} is on {t.device}, its mesh device is {dev}")
        return shards

    def _ids(self, ids, num_blocks: int, device: torch.device) -> torch.Tensor:
        """Block ids as an int32 tensor on ``device``; host ids are checked
        against ``[0, num_blocks)`` (K1/K2 leave an out-of-range block
        unread or unwritten)."""
        t = torch.as_tensor(ids)
        if t.dim() != 1:
            raise ValueError(f"block ids must be 1-D, got shape {tuple(t.shape)}")
        if t.device.type == "cpu" and t.numel() and not 0 <= int(t.min()) <= int(t.max()) < num_blocks:
            raise ValueError(f"block ids must lie in [0, {num_blocks}), got {t.tolist()}")
        return t.to(device=device, dtype=torch.int32).contiguous()

    def _move(self, blocks: torch.Tensor, dst: int) -> torch.Tensor:
        """The ``ppermute`` leg: a copy into a buffer on ``mesh[dst]``."""
        out = torch.empty(blocks.shape, dtype=blocks.dtype, device=self.mesh[dst])
        out.copy_(blocks)
        return out

    def transfer(self, blocks_by_device) -> Shards:
        """``blocks_by_device``: one ``[n_blocks, *block]`` tensor per shard.
        Returns the same layout with shard ``dst`` holding what shard ``src``
        sent, for each pair of ``perm``; other shards are zeros."""
        shards = self._check_shards("transfer", blocks_by_device)
        self.launches += 1
        out = [torch.zeros_like(t) for t in shards]
        for s, d in self.perm:
            out[d] = self._move(shards[s], d)
        return out

    def send_blocks(self, cache, block_ids, src: int, dst: int) -> Shards:
        """Gather ``block_ids`` from shard ``src``'s paged cache (K1) and
        deliver them to shard ``dst``. Returns one ``[n, *block]`` tensor per
        shard: the blocks at ``dst``, zeros elsewhere."""
        self._check_index(src, "src")
        self._check_index(dst, "dst")
        cache = self._check_shards("send_blocks", cache)
        ids = self._ids(block_ids, cache[src].shape[0], self.mesh[src])
        self.launches += 1
        blocks = gather_blocks(cache[src], ids)
        out = [torch.zeros_like(blocks, device=dev) for dev in self.mesh]
        out[dst] = self._move(blocks, dst)
        return out

    def _handoff(self, what, caches: Sequence[Shards], src_ids, dst_ids, src, dst):
        """Gather ``src_ids`` of every cache's shard ``src`` (K1), move the
        packed blocks to ``mesh[dst]``, scatter them at ``dst_ids`` into every
        cache's shard ``dst`` (K2). ``caches``: a list of shard lists of one
        shape and dtype."""
        self._check_index(src, "src")
        self._check_index(dst, "dst")
        caches = [self._check_shards(what, c) for c in caches]
        first = caches[0][src]
        for c in caches:
            for t in (c[src], c[dst]):
                if t.shape != first.shape or t.dtype != first.dtype:
                    raise ValueError(
                        f"{what} needs uniform per-layer cache shape/dtype; "
                        f"got {tuple(t.shape)}/{t.dtype} vs {tuple(first.shape)}/{first.dtype}"
                    )
        s_ids = self._ids(src_ids, first.shape[0], self.mesh[src])
        d_ids = self._ids(dst_ids, first.shape[0], self.mesh[dst])
        if s_ids.shape != d_ids.shape:
            raise ValueError(f"{what}: {s_ids.shape[0]} src ids but {d_ids.shape[0]} dst ids")
        self.launches += 1
        if s_ids.shape[0]:
            packed = gather_blocks_many([c[src] for c in caches], s_ids)
            scatter_blocks_many([c[dst] for c in caches], d_ids, self._move(packed, dst))
        return caches

    def handoff_blocks(self, cache, src_ids, dst_ids, src: int, dst: int) -> Shards:
        """The disaggregated handoff of one cache: ``src_ids`` of shard
        ``src`` land at ``dst_ids`` of shard ``dst``, in place. Returns the
        cache's shards."""
        return self._handoff("handoff_blocks", [cache], src_ids, dst_ids, src, dst)[0]

    def handoff_kv(self, k_cache, v_cache, src_ids, dst_ids, src: int,
                   dst: int) -> Tuple[Shards, Shards]:
        """One layer's K and V in one handoff: one K1 launch, one copy, one
        K2 launch."""
        k, v = self._handoff("handoff_kv", [k_cache, v_cache], src_ids, dst_ids, src, dst)
        return k, v

    def handoff_layers(self, caches, src_ids, dst_ids, src: int,
                       dst: int) -> List[Tuple[Shards, Shards]]:
        """Every layer's K and V in one handoff. ``caches``: per layer ``(K,
        V)``, each a list of per-shard ``[num_blocks, *block]`` tensors of
        one shape and dtype across layers (ragged layers raise ValueError;
        ``KVConnector.handoff`` sends those through ``handoff_kv``). All 2L
        caches' blocks are gathered by one K1 launch into one packed tensor,
        moved by one copy and scattered by one K2 launch."""
        if not caches:
            return []
        flat = [c for kv in caches for c in kv]
        out = self._handoff("handoff_layers", flat, src_ids, dst_ids, src, dst)
        return [(out[2 * i], out[2 * i + 1]) for i in range(len(caches))]
