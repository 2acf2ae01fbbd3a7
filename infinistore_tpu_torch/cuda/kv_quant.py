"""int8 KV-cache quantization (port of ``infinistore_tpu/tpu/kv_quant.py``):
half the device-memory traffic per decode token and half the data bytes per
stored block.

- ``quantize_kv(x)`` -> (int8 data, f32 scales): symmetric, one scale per
  (token, head) vector of ``head_dim`` values, absmax / 127. Per-vector
  scaling keeps the error at the vector's own scale (a per-block scale would
  be hostage to one outlier token).
- ``dequantize_kv(data, scales)`` -> the float values (any dtype).
- ``paged_decode_attention_quantized``: batched paged decode over int8
  caches. On CUDA tensors this is kernel K8 (``csrc/kv_quant.cu``), which
  reads blocks at int8 width and applies the scales once per token; on CPU
  tensors the plain version (dequantise, then the plain batched decode).
- ``QuantizedKVConnector``: two ``KVConnector`` planes over the same chain
  keys, int8 data and f32 scales, with a commit order that makes a data hit
  imply the scales.
- ``QuantizingKVAdapter``: the engine adapter surface over it, so a float
  engine keeps its cache while its store bytes are int8.

The scales of a cache are [N, bt, KVH] f32, 1/head_dim of the data's
elements; they ride to the store as blocks of their own through a
``KVConnector`` whose spec has head_dim 1, as ``[..., None]`` views that
the block scatter (K2) writes in place.
"""

import numpy as np
import torch

from .. import wire
from . import _ext
from .paged import PagedKVCacheSpec, gather_blocks_many, scatter_blocks_many
from .paged_attention import (
    _check_decode_args,
    _check_table_args,
    _split_scratch,
    paged_decode_attention_plain_batched,
)

# XLA folds the JAX package's ``absmax / 127.0`` into a multiply by the f32
# reciprocal of 127 (its algebraic simplifier rewrites division by a
# constant), so that product is the reference's arithmetic; the port writes
# it out to give bitwise the same scales (a true division differs in the last
# place for about 4 % of vectors). The constant is exact in f32.
_INV_127 = float(np.float32(1.0 / 127.0))


def quantize_kv(x: torch.Tensor):
    """Symmetric int8 per-(token, head) quantization.

    x: [..., head_dim] float; returns (int8 of x's shape, f32 scales of
    x.shape[:-1]). Zero vectors get scale 0 and dequantize to exact zeros.
    Bitwise the JAX package's ``quantize_kv`` (round half to even in both)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) * _INV_127
    inv = torch.where(scale > 0, 1.0 / torch.clamp(scale, min=1e-30), torch.zeros_like(scale))
    q = torch.clamp(torch.round(xf * inv[..., None]), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(data: torch.Tensor, scales: torch.Tensor, dtype=torch.float32):
    """Inverse of quantize_kv: data [..., D] int8, scales [...] f32."""
    return (data.float() * scales[..., None]).to(dtype)


# ---------------------------------------------------------------------------
# Decode attention over int8 caches (K8).
# ---------------------------------------------------------------------------


def _quant_decode_plain(q, k_data, k_scales, v_data, v_scales, block_tables, seq_lens):
    """The plain version of K8: dequantise the caches to f32, then the plain
    batched decode (the JAX package's ``_quant_decode_xla``)."""
    return paged_decode_attention_plain_batched(
        q, dequantize_kv(k_data, k_scales), dequantize_kv(v_data, v_scales),
        block_tables, seq_lens,
    )


def _quant_decode_cuda(q, k_data, k_scales, v_data, v_scales, block_tables, seq_lens):
    name = "paged_decode_attention_quantized"
    _ext.require_cuda(
        name, q.device, q=q, k_data=k_data, k_scales=k_scales, v_data=v_data,
        v_scales=v_scales, block_tables=block_tables, seq_lens=seq_lens,
    )
    _check_decode_args(name, q, k_data, v_data, same_dtype=False)
    _check_table_args(name, q, block_tables, seq_lens)
    if k_data.dtype != torch.int8 or v_data.dtype != torch.int8:
        raise TypeError(f"{name}: k_data and v_data must be int8")
    want = tuple(k_data.shape[:-1])
    for arg, t in (("k_scales", k_scales), ("v_scales", v_scales)):
        if tuple(t.shape) != want or t.dtype != torch.float32:
            raise ValueError(f"{name}: {arg} must be {list(want)} float32")
    _ext.require_aligned(name, q=q, k_data=k_data, v_data=v_data)
    dtype = _ext.dtype_code(name, q.dtype)
    bsz, h, d = q.shape
    n, bt, kvh, _ = k_data.shape
    width = block_tables.shape[1]
    stream = _ext.stream_of(q)
    scratch, tickets, splits = _split_scratch(q, width, stream)
    out = torch.empty_like(q)
    with _ext.on_device(q.device):
        code = _ext.kernels().its_paged_decode_attention_quantized(
            q.data_ptr(), k_data.data_ptr(), k_scales.data_ptr(), v_data.data_ptr(),
            v_scales.data_ptr(), block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), tickets.data_ptr(), dtype, bsz, h, kvh, d, bt, n, width, splits,
            stream,
        )
    _ext.LAUNCHES["paged_decode_attention_quantized"] += 1
    _ext.check(code, name)
    return out


def paged_decode_attention_quantized(q, k_data, k_scales, v_data, v_scales, block_tables,
                                     seq_lens):
    """Batched decode attention over an int8 paged cache.

    q: [B, H, D] f32 or bf16; k/v_data: [N, bt, KVH, D] int8 with f32 scales
    [N, bt, KVH] (from quantize_kv); block_tables [B, max_blocks] int32;
    seq_lens [B] int32 (a zero row returns zeros). Returns [B, H, D] in q's
    dtype. Kernel K8 on CUDA tensors (within 1e-5 of the plain version with
    f32 q, 2e-2 with bf16 q, as the JAX package holds its kernel; two
    launches bitwise equal, each row bitwise its solo launch), the plain
    version on CPU tensors. The outputs equal attention over the
    dequantised cache; the quantization error is the int8 scheme's."""
    if q.device.type == "cpu":
        return _quant_decode_plain(q, k_data, k_scales, v_data, v_scales, block_tables,
                                   seq_lens)
    return _quant_decode_cuda(q, k_data, k_scales, v_data, v_scales, block_tables, seq_lens)


# ---------------------------------------------------------------------------
# Store glue.
# ---------------------------------------------------------------------------


class QuantizedKVConnector:
    """Store glue for an int8 paged cache: half the data bytes per cached
    block.

    A quantized engine's cache is (int8 data, f32 scales) per K/V side. This
    binds TWO ``KVConnector``s over the same chain keys, one for the data
    blocks (int8) and one for the scale blocks (head_dim 1, f32), and keeps
    the commit order safe: scales are saved BEFORE data, so the data plane's
    layer-0 sentinel (what ``lookup`` probes) commits last and a hit implies
    the scales are present too. A scales load that still races eviction
    degrades to a full miss (recompute), never a half-loaded cache.

    Keys and block bytes are the JAX package's, so a prefix either package
    saved loads in the other. The store allocates whole units of its
    ``block_bytes``: a scale block (bt x KVH x 4 bytes) takes a whole unit,
    so the capacity gain over a float cache depends on that unit.

    ``device``: where the caches live (default ``"cuda"``); ``close()``
    releases both planes' page-locked staging pools and must come before
    the connection's own close."""

    def __init__(self, conn, spec: PagedKVCacheSpec, model_id: str, max_blocks: int,
                 device="cuda"):
        """``spec``: the FLOAT cache spec the engine would use unquantized
        (its dtype is ignored for storage: data rides int8, scales f32)."""
        # Deferred import: the connector imports this package's modules.
        from ..connector import KVConnector

        self.spec = spec
        data_spec = PagedKVCacheSpec(
            num_layers=spec.num_layers, num_blocks=spec.num_blocks,
            block_tokens=spec.block_tokens, num_kv_heads=spec.num_kv_heads,
            head_dim=spec.head_dim, dtype=torch.int8,
        )
        scale_spec = PagedKVCacheSpec(
            num_layers=spec.num_layers, num_blocks=spec.num_blocks,
            block_tokens=spec.block_tokens, num_kv_heads=spec.num_kv_heads,
            head_dim=1, dtype=torch.float32,
        )
        self.data = KVConnector(conn, data_spec, f"{model_id}/q8", max_blocks, device=device)
        self.scales = KVConnector(conn, scale_spec, f"{model_id}/q8s", max_blocks,
                                  device=device)
        self.device = self.data.device

    def close(self) -> None:
        """Release both planes' staging page locks (idempotent)."""
        self.data.close()
        self.scales.close()

    def lookup(self, token_ids) -> int:
        """Blocks cached (data sentinel; commit order makes it imply scales)."""
        return self.data.lookup(token_ids)

    @staticmethod
    def _planes(quant_caches):
        """(data caches, scale caches) of per-layer ((k_int8, k_scales),
        (v_int8, v_scales)). The scale caches are [N, bt, KVH, 1] VIEWS of
        the scales, which a load's scatter writes in place: a copy here
        would silently lose every loaded scale."""
        data = [(kq, vq) for (kq, _), (vq, _) in quant_caches]
        scales = [(ks[..., None], vs[..., None]) for (_, ks), (_, vs) in quant_caches]
        return data, scales

    async def save(self, token_ids, quant_caches, block_ids, first_block: int = 0):
        """quant_caches: per layer ((k_int8, k_scales), (v_int8, v_scales)).
        Returns data blocks written."""
        data_caches, scale_caches = self._planes(quant_caches)
        await self.scales.save(token_ids, scale_caches, block_ids, first_block=first_block)
        return await self.data.save(token_ids, data_caches, block_ids, first_block=first_block)

    async def load(self, token_ids, quant_caches, block_ids, first_block: int = 0,
                   on_layer=None):
        """Fetch the cached prefix into (data, scales) caches, in place.
        Returns (quant_caches, blocks_loaded); a scales race degrades to a
        miss. A transport error mid-read re-raises ``PartialReadError`` whose
        ``caches`` carry the ZIPPED quantized structure.

        ``first_block``/``on_layer``: ``KVConnector.load``'s contract. A
        quantized layer is usable only once BOTH its data and scales landed,
        so the hook fires during the scales pass (the data pass completed
        first) with the zipped ((k_int8, k_scales), (v_int8, v_scales))."""
        # Deferred: the layerwise module loads the store library.
        from .layerwise import PartialReadError

        data_caches, scale_caches = self._planes(quant_caches)
        try:
            data_out, n = await self.data.load(
                token_ids, data_caches, block_ids, first_block=first_block)
        except PartialReadError as e:
            raise PartialReadError(self._zip(e.caches, scale_caches), e.cause) from e.cause
        if n == 0:
            return self._zip(data_out, scale_caches), 0

        def scale_hook(layer, pair):
            ks, vs = pair
            k_data, v_data = data_out[layer]
            on_layer(layer, ((k_data, ks[..., 0]), (v_data, vs[..., 0])))

        try:
            scale_out, ns = await self.scales.load(
                token_ids, scale_caches, block_ids, first_block=first_block,
                on_layer=scale_hook if on_layer is not None else None,
            )
        except PartialReadError as e:
            raise PartialReadError(self._zip(data_out, e.caches), e.cause) from e.cause
        if ns < n:
            # Scales raced away after the data hit: the data alone is
            # useless, report a miss (the engine recomputes).
            return self._zip(data_out, scale_out), 0
        return self._zip(data_out, scale_out), n

    def stage_layer_save(self, token_ids, layer: int, kv_pair, block_ids,
                         first_block: int = 0, priority: int = wire.PRIORITY_BACKGROUND):
        """Layer-granular save (``KVConnector.stage_layer_save``'s contract)
        of a quantized layer ``((k_int8, k_scales), (v_int8, v_scales))``.
        The returned ship puts scales BEFORE data; layer-by-layer callers
        ship layer 0 last, so the data sentinel still commits after
        everything: scales layers 1+, data layers 1+, scales 0, data 0.
        ``priority`` rides both ships."""
        (kq, ks), (vq, vs) = kv_pair
        ship_scales = self.scales.stage_layer_save(
            token_ids, layer, (ks[..., None], vs[..., None]), block_ids,
            first_block=first_block, priority=priority,
        )
        ship_data = self.data.stage_layer_save(
            token_ids, layer, (kq, vq), block_ids, first_block=first_block,
            priority=priority,
        )

        async def ship() -> int:
            await ship_scales()
            return await ship_data()

        return ship

    @staticmethod
    def _zip(data_caches, scale_caches):
        return [
            ((kq, ks[..., 0]), (vq, vs[..., 0]))
            for (kq, vq), (ks, vs) in zip(data_caches, scale_caches)
        ]

    def drop(self, token_ids) -> int:
        """Remove this prompt's data AND scale blocks."""
        return self.data.drop(token_ids) + self.scales.drop(token_ids)

    @property
    def conn(self):
        """The shared store connection (both planes ride one connection)."""
        return self.data.conn

    def manifest(self, token_ids, n_blocks=None):
        """Size-grouped key inventory (``KVConnector.manifest``): the scale
        group precedes the data group, mirroring ``save``'s commit order, so
        the data plane's layer-0 K sentinel lands last."""
        return (self.scales.manifest(token_ids, n_blocks)
                + self.data.manifest(token_ids, n_blocks))

    def get_stats(self) -> dict:
        """Connection stats (both planes ride one connection)."""
        return self.data.get_stats()


class QuantizingKVAdapter:
    """``EngineKVAdapter``-shaped surface that stores a FLOAT engine cache
    as int8.

    The engine keeps its float paged cache and block tables exactly as with
    the plain adapter; only the store bytes change: ``save_kv`` gathers the
    request's float blocks (K1 on CUDA), quantizes them on the device and
    ships int8 + scales; ``load_kv`` fetches int8 + scales and scatters
    dequantised floats back into the engine's cache (K2 on CUDA). A harness
    verifying against its prefill oracle needs a tolerance that allows the
    int8 scheme's error (``ContinuousBatchingHarness(verify_tol=...)``).
    There is no two-phase fetch: the engine takes its one-phase gated load."""

    def __init__(self, qconn: QuantizedKVConnector):
        self.qconn = qconn
        self.block_tokens = qconn.spec.block_tokens
        self._nq = qconn.spec.num_blocks  # staging rows for fetch/ship

    def _fresh_quant(self, rows: int):
        spec = self.qconn.spec
        shape = (rows, spec.block_tokens, spec.num_kv_heads, spec.head_dim)
        dev = self.qconn.device

        def side():
            return (torch.zeros(shape, dtype=torch.int8, device=dev),
                    torch.zeros(shape[:-1], dtype=torch.float32, device=dev))

        return [(side(), side()) for _ in range(spec.num_layers)]

    def get_num_matched_tokens(self, token_ids) -> int:
        return self.qconn.lookup(token_ids) * self.block_tokens

    async def save_kv(self, token_ids, caches, block_table, first_block: int = 0):
        """Gather the float blocks, quantize, ship int8 + scales. ``caches``
        may be the engine's full cache (gathered at ``block_table``) or
        already-gathered blocks with an identity table."""
        n = len(block_table)
        ids = torch.as_tensor(np.asarray(block_table), dtype=torch.int32,
                              device=caches[0][0].device)
        # Every layer's K and V blocks in one gather, quantised at once (the
        # scheme is per (token, head) vector); handed on as per-(layer, kind)
        # views.
        data, scales = quantize_kv(gather_blocks_many([t for kv in caches for t in kv], ids))
        quant = [
            tuple((data[j * n : (j + 1) * n], scales[j * n : (j + 1) * n])
                  for j in (2 * i, 2 * i + 1))
            for i in range(len(caches))
        ]
        return await self.qconn.save(
            token_ids, quant, np.arange(n, dtype=np.int32), first_block=first_block)

    async def load_kv(self, token_ids, caches, block_table):
        """Fetch int8 + scales, dequantise, scatter into the engine's float
        cache blocks in place. Returns (caches, tokens_loaded).

        Staging rows are bounded by the spec's num_blocks: a longer hit
        loads a shorter prefix and the engine computes the rest."""
        n = min(len(block_table), self._nq)
        if n == 0:
            return list(caches), 0
        staged, got = await self.qconn.load(
            token_ids, self._fresh_quant(n), np.arange(n, dtype=np.int32))
        if got == 0:
            return list(caches), 0
        ids = torch.as_tensor(np.asarray(block_table[:got]), dtype=torch.int32,
                              device=caches[0][0].device)
        out = []
        for (k_cache, v_cache), ((kq, ks), (vq, vs)) in zip(caches, staged):
            # The two dequantised halves scattered by one launch.
            out.append(tuple(scatter_blocks_many((k_cache, v_cache), ids, (
                dequantize_kv(kq[:got], ks[:got], k_cache.dtype),
                dequantize_kv(vq[:got], vs[:got], v_cache.dtype)))))
        return out, got * self.block_tokens

    def evict_request(self, token_ids) -> int:
        return self.qconn.drop(token_ids)
