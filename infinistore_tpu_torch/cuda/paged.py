"""Paged KV-cache block ops: gather and scatter between the paged cache and
contiguous buffers (port of ``infinistore_tpu/tpu/paged.py``).

The engine's KV cache is, per layer and per K/V, a tensor of shape
``[num_blocks, block_tokens, num_kv_heads, head_dim]``. Extracting a
request's blocks for offload, or re-inserting fetched blocks, is a
gather/scatter over block ids: the store's own device ops. On a CUDA tensor
they launch the hand-written kernels K1 and K2 (``csrc/paged_copy.cu``); on
a CPU tensor they run the plain versions beside them, ``index_select`` and
an in-place ``index_copy_``.
"""

from dataclasses import dataclass
from typing import List, Tuple

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


# ---------------------------------------------------------------------------
# Kernel wrappers (K1, K2).
# ---------------------------------------------------------------------------


def _check_blocks(name, cache, block_ids, blocks=None):
    if cache.dim() < 2:
        raise ValueError(f"{name}: cache must be [num_blocks, ...], got {tuple(cache.shape)}")
    if block_ids.dim() != 1 or block_ids.dtype != torch.int32:
        raise ValueError(f"{name}: block_ids must be a 1-D int32 tensor")
    tensors = {"cache": cache, "block_ids": block_ids}
    if blocks is not None:
        want = (block_ids.shape[0], *cache.shape[1:])
        if tuple(blocks.shape) != want or blocks.dtype != cache.dtype:
            raise ValueError(
                f"{name}: blocks must be {want} {cache.dtype}, got "
                f"{tuple(blocks.shape)} {blocks.dtype}"
            )
        tensors["blocks"] = blocks
    _ext.require_cuda(name, cache.device, **tensors)


def _gather_blocks_cuda(cache: torch.Tensor, block_ids: torch.Tensor) -> torch.Tensor:
    _check_blocks("gather_blocks", cache, block_ids)
    n = block_ids.shape[0]
    out = torch.empty((n, *cache.shape[1:]), dtype=cache.dtype, device=cache.device)
    block_bytes = cache[0].numel() * cache.element_size()
    code = _ext.kernels().its_gather_blocks(
        cache.data_ptr(), block_ids.data_ptr(), out.data_ptr(), n, cache.shape[0],
        block_bytes, _ext.stream_of(cache),
    )
    _ext.LAUNCHES["gather_blocks"] += 1
    _ext.check(code, "gather_blocks")
    return out


def _scatter_blocks_cuda(
    cache: torch.Tensor, block_ids: torch.Tensor, blocks: torch.Tensor
) -> torch.Tensor:
    _check_blocks("scatter_blocks", cache, block_ids, blocks)
    block_bytes = cache[0].numel() * cache.element_size()
    code = _ext.kernels().its_scatter_blocks(
        cache.data_ptr(), block_ids.data_ptr(), blocks.data_ptr(), block_ids.shape[0],
        cache.shape[0], block_bytes, _ext.stream_of(cache),
    )
    _ext.LAUNCHES["scatter_blocks"] += 1
    _ext.check(code, "scatter_blocks")
    return cache


def gather_blocks(cache: torch.Tensor, block_ids: torch.Tensor) -> torch.Tensor:
    """Gather cache blocks by id: kernel K1 on CUDA, ``index_select`` on CPU.

    Ids must lie in ``[0, num_blocks)``; on CUDA an id outside leaves its
    output block unwritten."""
    if cache.device.type == "cpu":
        return gather_blocks_plain(cache, block_ids)
    return _gather_blocks_cuda(cache, block_ids)


def scatter_blocks(
    cache: torch.Tensor, block_ids: torch.Tensor, blocks: torch.Tensor
) -> torch.Tensor:
    """Write ``blocks`` into ``cache`` at ``block_ids``, in place, and return
    ``cache``: kernel K2 on CUDA, ``index_copy_`` on CPU. Blocks not named
    keep their bytes. Duplicate ids have no defined winner."""
    if cache.device.type == "cpu":
        return scatter_blocks_plain(cache, block_ids, blocks)
    return _scatter_blocks_cuda(cache, block_ids, blocks)
