"""Paged KV-cache block ops: gather and scatter between the paged cache and
contiguous buffers (port of ``infinistore_tpu/tpu/paged.py``).

The engine's KV cache is, per layer and per K/V, a tensor of shape
``[num_blocks, block_tokens, num_kv_heads, head_dim]``. Extracting a
request's blocks for offload, or re-inserting fetched blocks, is a
gather/scatter over block ids: the store's own device ops. On a CUDA tensor
they launch the hand-written kernels K1 and K2 (``csrc/paged_copy.cu``); on
a CPU tensor they run the plain versions beside them, ``index_select`` and
an in-place ``index_copy_``.

``gather_blocks_many`` / ``scatter_blocks_many`` move the same block ids of
several caches (a layer's K and V, or every layer's) in one launch, to and
from the packed ``[cache 0 blocks | cache 1 blocks | ...]`` layout the
staging buffers use: what the JAX package writes as a ``jnp.concatenate``
of per-cache gathers (fused there by XLA) and per-cache scatters. A launch
takes the kernel's TMA bulk ring when every pointer and the block size are
16-byte aligned, and its vector kernel otherwise (``_launch``).
"""

import math
from ctypes import c_void_p
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

from . import _ext


@dataclass(frozen=True)
class PagedKVCacheSpec:
    """Shape contract for one model's paged KV cache."""

    num_layers: int
    num_blocks: int
    block_tokens: int
    num_kv_heads: int
    head_dim: int
    dtype: torch.dtype = torch.bfloat16

    @property
    def block_shape(self) -> Tuple[int, int, int]:
        return (self.block_tokens, self.num_kv_heads, self.head_dim)

    @property
    def cache_shape(self) -> Tuple[int, int, int, int]:
        return (self.num_blocks, *self.block_shape)

    @property
    def block_nbytes(self) -> int:
        n = self.block_tokens * self.num_kv_heads * self.head_dim
        return n * torch.empty((), dtype=self.dtype).element_size()

    def make_caches(self, device="cuda") -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Fresh zeroed (K, V) cache pair per layer on ``device``.

        Every entry is a *distinct* tensor: ``scatter_blocks`` writes in
        place, so one zeros tensor shared across K/V/layers would make a
        write to one cache show up in all of them."""
        dev = _ext.resolve_device(device)
        return [
            (
                torch.zeros(self.cache_shape, dtype=self.dtype, device=dev),
                torch.zeros(self.cache_shape, dtype=self.dtype, device=dev),
            )
            for _ in range(self.num_layers)
        ]


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the CPU path and the kernels' reference.
# ---------------------------------------------------------------------------


def gather_blocks_plain(cache: torch.Tensor, block_ids: torch.Tensor) -> torch.Tensor:
    """out[i] = cache[block_ids[i]]."""
    return cache.index_select(0, block_ids.to(torch.long))


def scatter_blocks_plain(
    cache: torch.Tensor, block_ids: torch.Tensor, blocks: torch.Tensor
) -> torch.Tensor:
    """cache[block_ids[i]] = blocks[i], in place; returns ``cache``."""
    return cache.index_copy_(0, block_ids.to(torch.long), blocks.to(cache.dtype))


def gather_blocks_many_plain(caches: Sequence[torch.Tensor],
                             block_ids: torch.Tensor) -> torch.Tensor:
    """out[c * n + i] = caches[c][block_ids[i]]: every cache's blocks, packed
    cache after cache."""
    ids = block_ids.to(torch.long)
    return torch.cat([cache.index_select(0, ids) for cache in caches])


def scatter_blocks_many_plain(caches: Sequence[torch.Tensor], block_ids: torch.Tensor,
                              blocks) -> List[torch.Tensor]:
    """caches[c][block_ids[i]] = the i-th block of source c, in place;
    ``blocks`` is one packed tensor [C * n, ...] or C tensors [n, ...].
    Returns the caches."""
    ids = block_ids.to(torch.long)
    for cache, part in zip(caches, _sources(blocks, len(caches), ids.shape[0])):
        cache.index_copy_(0, ids, part.to(cache.dtype))
    return list(caches)


# ---------------------------------------------------------------------------
# Kernel wrappers (K1, K2).
# ---------------------------------------------------------------------------

# Caches one launch takes (csrc/paged_copy.cu: kMaxCaches); a longer list is
# split into several launches.
MAX_CACHES = 64


def _block_bytes(cache: torch.Tensor) -> int:
    return math.prod(cache.shape[1:]) * cache.element_size()


def _sources(blocks, count: int, n: int):
    """The per-cache sources of a scatter: views of one packed tensor, or the
    sequence as given."""
    if isinstance(blocks, torch.Tensor):
        return [blocks[c * n:(c + 1) * n] for c in range(count)]
    return list(blocks)


def _check_caches(name, caches, block_ids):
    """The first cache; raises unless every cache shares device, dtype,
    num_blocks and block shape, and the ids are one 1-D int32 tensor."""
    if not caches:
        raise ValueError(f"{name}: no caches given")
    first = caches[0]
    if first.dim() < 2:
        raise ValueError(f"{name}: cache must be [num_blocks, ...], got {tuple(first.shape)}")
    if block_ids.dim() != 1 or block_ids.dtype != torch.int32:
        raise ValueError(f"{name}: block_ids must be a 1-D int32 tensor")
    for cache in caches[1:]:
        if cache.shape != first.shape or cache.dtype != first.dtype or \
                cache.device != first.device:
            raise ValueError(
                f"{name}: every cache must share device, dtype, num_blocks and block shape; "
                f"got {tuple(cache.shape)} {cache.dtype} on {cache.device} beside "
                f"{tuple(first.shape)} {first.dtype} on {first.device}"
            )
    return first


def _check_sources(name, first, count, n, blocks):
    """Raises unless ``blocks`` is [count * n, ...] or ``count`` tensors
    [n, ...] of the caches' dtype."""
    if isinstance(blocks, torch.Tensor):
        srcs, want = [blocks], [(count * n, *first.shape[1:])]
    else:
        if len(blocks) != count:
            raise ValueError(f"{name}: {len(blocks)} sources for {count} caches")
        srcs, want = blocks, [(n, *first.shape[1:])] * count
    for src, shape in zip(srcs, want):
        if tuple(src.shape) != shape or src.dtype != first.dtype:
            raise ValueError(
                f"{name}: blocks must be {shape} {first.dtype}, got "
                f"{tuple(src.shape)} {src.dtype}"
            )


def _launch(name, caches, block_ids, flats):
    """K1 (``gather_blocks``) or K2 over ``caches`` and their contiguous
    sides at ``flats`` (one pointer each), ``MAX_CACHES`` caches a launch.
    Every pointer 16-byte aligned and a whole number of 16-byte units a
    block: the TMA bulk ring (``its_*_blocks_many``, counted also under
    ``*_bulk``); anything else: the vector kernel (``*_many_vec``)."""
    first = caches[0]
    n = block_ids.shape[0]
    block_bytes = _block_bytes(first)
    ptrs = [cache.data_ptr() for cache in caches]
    bulk = block_bytes % 16 == 0 and all(p % 16 == 0 for p in (*ptrs, *flats))
    entry = getattr(_ext.kernels(), f"its_{name}_many" if bulk else f"its_{name}_many_vec")
    stream = _ext.stream_of(first)
    with _ext.on_device(first.device):
        for lo in range(0, len(caches), MAX_CACHES):
            count = min(MAX_CACHES, len(caches) - lo)
            table = c_void_p * count
            code = entry(table(*ptrs[lo:lo + count]), table(*flats[lo:lo + count]),
                         block_ids.data_ptr(), count, n, first.shape[0], block_bytes, stream)
            _ext.LAUNCHES[name] += 1
            if bulk:
                _ext.LAUNCHES[f"{name}_bulk"] += 1
            _ext.check(code, name)


def _gather_many_cuda(caches, block_ids):
    first = _check_caches("gather_blocks", caches, block_ids)
    _ext.require_cuda("gather_blocks", first.device, block_ids=block_ids,
                      **{f"caches[{c}]": cache for c, cache in enumerate(caches)})
    n = block_ids.shape[0]
    out = torch.empty((len(caches) * n, *first.shape[1:]), dtype=first.dtype,
                      device=first.device)
    if n:
        step, base = n * _block_bytes(first), out.data_ptr()
        _launch("gather_blocks", caches, block_ids,
                [base + c * step for c in range(len(caches))])
    return out


def _scatter_many_cuda(caches, block_ids, blocks):
    first = _check_caches("scatter_blocks", caches, block_ids)
    n = block_ids.shape[0]
    _check_sources("scatter_blocks", first, len(caches), n, blocks)
    packed = isinstance(blocks, torch.Tensor)
    _ext.require_cuda("scatter_blocks", first.device, block_ids=block_ids,
                      **{f"caches[{c}]": cache for c, cache in enumerate(caches)},
                      **({"blocks": blocks} if packed else
                         {f"blocks[{c}]": src for c, src in enumerate(blocks)}))
    if n:
        if packed:
            step, base = n * _block_bytes(first), blocks.data_ptr()
            flats = [base + c * step for c in range(len(caches))]
        else:
            flats = [src.data_ptr() for src in blocks]
        _launch("scatter_blocks", caches, block_ids, flats)
    return list(caches)


def gather_blocks(cache: torch.Tensor, block_ids: torch.Tensor) -> torch.Tensor:
    """Gather cache blocks by id: kernel K1 on CUDA, ``index_select`` on CPU.

    Ids must lie in ``[0, num_blocks)``; on CUDA an id outside leaves its
    output block unwritten."""
    if cache.device.type == "cpu":
        return gather_blocks_plain(cache, block_ids)
    return _gather_many_cuda([cache], block_ids)


def scatter_blocks(
    cache: torch.Tensor, block_ids: torch.Tensor, blocks: torch.Tensor
) -> torch.Tensor:
    """Write ``blocks`` into ``cache`` at ``block_ids``, in place, and return
    ``cache``: kernel K2 on CUDA, ``index_copy_`` on CPU. Blocks not named
    keep their bytes. Duplicate ids have no defined winner."""
    if cache.device.type == "cpu":
        return scatter_blocks_plain(cache, block_ids, blocks)
    return _scatter_many_cuda([cache], block_ids, blocks)[0]


def gather_blocks_many(caches: Sequence[torch.Tensor],
                       block_ids: torch.Tensor) -> torch.Tensor:
    """The same blocks of several caches in one call: ``out[c * n + i] =
    caches[c][block_ids[i]]``, shape ``[C * n, *block_shape]`` (the packed
    ``[K blocks | V blocks]`` layout of the staging buffers, for one layer or
    all of them). One K1 launch for up to ``MAX_CACHES`` caches on CUDA;
    ``index_select`` and ``torch.cat`` on CPU. Every cache must share device,
    dtype, num_blocks and block shape."""
    if caches and caches[0].device.type == "cpu":
        _check_caches("gather_blocks", caches, block_ids)
        return gather_blocks_many_plain(caches, block_ids)
    return _gather_many_cuda(caches, block_ids)


def scatter_blocks_many(caches: Sequence[torch.Tensor], block_ids: torch.Tensor,
                        blocks) -> List[torch.Tensor]:
    """Write the same block ids of several caches in one call, in place:
    ``caches[c][block_ids[i]] = `` block ``i`` of source ``c``, where
    ``blocks`` is one packed tensor ``[C * n, ...]`` (source ``c`` is rows
    ``c * n`` to ``c * n + n``) or a sequence of ``C`` tensors ``[n, ...]``.
    Returns the caches. One K2 launch for up to ``MAX_CACHES`` caches on
    CUDA; ``index_copy_`` on CPU."""
    if caches and caches[0].device.type == "cpu":
        first = _check_caches("scatter_blocks", caches, block_ids)
        _check_sources("scatter_blocks", first, len(caches), block_ids.shape[0], blocks)
        return scatter_blocks_many_plain(caches, block_ids, blocks)
    return _scatter_many_cuda(caches, block_ids, blocks)
