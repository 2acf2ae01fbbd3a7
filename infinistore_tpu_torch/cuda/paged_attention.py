"""Fused paged decode attention for a wave of requests (port of the batched
decode in ``infinistore_tpu/tpu/paged_attention.py``).

One query token per request attends over the paged KV cache blocks its
block-table row names, without materialising the gathered context. On CUDA
tensors this is kernel K3 (``csrc/paged_attention.cu``); on CPU tensors the
plain version below, which mirrors the JAX package's XLA reference
(``_decode_attention_stats_xla`` + ``paged_decode_attention_xla_batched``).

Numerical contract (shared with the JAX package): logits and softmax
statistics in float32, output cast to the query dtype. Positions >= seq_len
are masked; padded block-table entries past the sequence contribute nothing;
a row with seq_len == 0 yields zeros, not NaN.
"""

import math

import torch

from . import _ext

_NEG_INF = -1e30


def paged_decode_attention_plain_batched(q, k_cache, v_cache, block_tables, seq_lens):
    """Gather each row's table blocks, mask positions >= seq_len, softmax in
    f32 through the raw (acc, m, l) statistics, normalise.

    q: [B, H, D]; caches: [N, bt, KVH, D]; block_tables: [B, max_blocks];
    seq_lens: [B]. Returns [B, H, D] in q's dtype."""
    bsz, h, d = q.shape
    _, bt, kvh, _ = k_cache.shape
    groups = h // kvh
    tables = block_tables.to(torch.long)
    k = k_cache[tables].reshape(bsz, -1, kvh, d).repeat_interleave(groups, dim=2)
    v = v_cache[tables].reshape(bsz, -1, kvh, d).repeat_interleave(groups, dim=2)
    scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("bhd,bthd->bht", q.float(), k.float()) * scale
    t = k.shape[1]
    valid = (
        torch.arange(t, device=q.device)[None, :]
        < seq_lens.to(device=q.device, dtype=torch.long)[:, None]
    )  # [B, T]
    logits = torch.where(valid[:, None, :], logits, torch.full_like(logits, _NEG_INF))
    m = logits.amax(dim=2, keepdim=True)
    p = torch.exp(logits - m)
    p = torch.where(valid[:, None, :], p, torch.zeros_like(p))
    l = p.sum(dim=2, keepdim=True)
    acc = torch.einsum("bht,bthd->bhd", p, v.float())
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def _paged_decode_attention_cuda(q, k_cache, v_cache, block_tables, seq_lens):
    name = "paged_decode_attention"
    _ext.require_cuda(
        name, q.device, q=q, k_cache=k_cache, v_cache=v_cache,
        block_tables=block_tables, seq_lens=seq_lens,
    )
    bsz, h, d = q.shape
    n, bt, kvh, dk = k_cache.shape
    if tuple(v_cache.shape) != tuple(k_cache.shape) or dk != d:
        raise ValueError(f"{name}: cache shapes {tuple(k_cache.shape)}/"
                         f"{tuple(v_cache.shape)} do not match q {tuple(q.shape)}")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"{name}: q and caches must share a dtype")
    if h % kvh or h // kvh not in (1, 2, 4, 8) or d not in (64, 128):
        raise ValueError(
            f"{name}: kernel takes head_dim 64 or 128 and 1, 2, 4 or 8 query "
            f"heads per KV head; got head_dim {d}, {h} heads, {kvh} KV heads"
        )
    if block_tables.dim() != 2 or block_tables.shape[0] != bsz or block_tables.dtype != torch.int32:
        raise ValueError(f"{name}: block_tables must be [{bsz}, max_blocks] int32")
    if tuple(seq_lens.shape) != (bsz,) or seq_lens.dtype != torch.int32:
        raise ValueError(f"{name}: seq_lens must be [{bsz}] int32")
    out = torch.empty_like(q)
    code = _ext.kernels().its_paged_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), block_tables.data_ptr(),
        seq_lens.data_ptr(), out.data_ptr(), _ext.dtype_code(name, q.dtype),
        bsz, h, kvh, d, bt, n, block_tables.shape[1], _ext.stream_of(q),
    )
    _ext.LAUNCHES["paged_decode_attention"] += 1
    _ext.check(code, name)
    return out


def paged_decode_attention_batched(q, k_cache, v_cache, block_tables, seq_lens):
    """Decode attention for a wave of requests against one shared paged cache.

    q: [B, n_heads, head_dim]; k_cache/v_cache: [num_blocks, block_tokens,
    n_kv_heads, head_dim]; block_tables: [B, max_blocks] int32 (each row
    padded with any valid block id); seq_lens: [B] int32. Returns [B,
    n_heads, head_dim] in q's dtype. Kernel K3 on CUDA (one launch for the
    wave), the plain version on CPU."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain_batched(q, k_cache, v_cache, block_tables, seq_lens)
    return _paged_decode_attention_cuda(q, k_cache, v_cache, block_tables, seq_lens)


def paged_decode_attention(q, k_cache, v_cache, block_table, seq_len):
    """Single-token decode attention (the B=1 form): q [n_heads, head_dim],
    block_table [max_blocks] int32, seq_len a count of valid context tokens.
    Returns [n_heads, head_dim] in q's dtype."""
    seq_lens = torch.as_tensor(seq_len, dtype=torch.int32, device=q.device).reshape(1)
    return paged_decode_attention_batched(
        q[None], k_cache, v_cache, block_table[None], seq_lens
    )[0]
