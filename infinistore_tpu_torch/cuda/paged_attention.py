"""Fused paged decode attention for a wave of requests (port of the batched
and ragged decode in ``infinistore_tpu/tpu/paged_attention.py``).

One query token per request attends over the paged KV cache blocks its
block-table row names, without materialising the gathered context. On CUDA
tensors this is kernel K3 (``csrc/paged_attention.cu``); on CPU tensors the
plain version below, which mirrors the JAX package's XLA reference
(``_decode_attention_stats_xla`` + ``paged_decode_attention_xla_batched``).

The ragged half (``RaggedWaveMeta``, ``build_ragged_wave``,
``paged_decode_attention_ragged``, ``paged_decode_attention_rows``) serves a
wave whose rows keep their own context lengths: the rows' page lists are
concatenated into one flat list, so a length-skewed wave reads
sum(ceil(len_i / bt)) pages instead of B x max_blocks. On CUDA tensors it
is kernel K6 (same source file, the same fold as K3); on CPU tensors the
rows' tables are rebuilt from the flat list and the plain batched version
runs over them, as the JAX package's XLA path does.

Numerical contract (shared with the JAX package): logits and softmax
statistics in float32, output cast to the query dtype. Positions >= seq_len
are masked; padded block-table entries past the sequence contribute nothing;
a row with seq_len == 0 yields zeros, not NaN.
"""

import math

import numpy as np
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


# ---------------------------------------------------------------------------
# Ragged decode attention (K6): one flat page list for the whole wave.
# ---------------------------------------------------------------------------


class RaggedWaveMeta:
    """Host-assembled metadata for one ragged decode wave of R rows (all
    int32 numpy arrays, built by :func:`build_ragged_wave`; the JAX
    package's layout contract, unchanged):

    - ``pages`` [P]: the rows' page lists concatenated in row order; row r's
      pages are ``pages[page_starts[r] : page_starts[r] + nb_r]`` with
      ``nb_r = max(1, ceil(seq_lens[r] / block_tokens))`` (a zero-length
      row carries one page, which attends to nothing: its output is zeros).
      The tail may be padded with copies of the last page; padded entries
      belong to the last row and are never read.
    - ``page_rows`` [P + 1]: owning row of each flat page, non-decreasing,
      with sentinel ``page_rows[P] == R``.
    - ``page_starts`` [R]: index of each row's first page in ``pages``.
    - ``seq_lens`` [R]: valid context tokens per row.
    - ``pad_pages``: how many tail entries are padding.
    """

    __slots__ = ("pages", "page_rows", "page_starts", "seq_lens", "pad_pages")

    def __init__(self, pages, page_rows, page_starts, seq_lens, pad_pages):
        self.pages = pages
        self.page_rows = page_rows
        self.page_starts = page_starts
        self.seq_lens = seq_lens
        self.pad_pages = pad_pages

    @property
    def num_pages(self) -> int:
        return int(self.pages.shape[0])

    @property
    def num_rows(self) -> int:
        return int(self.seq_lens.shape[0])


def build_ragged_wave(tables, seq_lens, block_tokens: int, pad_to: int = 0,
                      pad_to_pow2: bool = False) -> RaggedWaveMeta:
    """Assemble :class:`RaggedWaveMeta` from per-row page tables.

    ``tables``: R 1-D int sequences, row r's block table (entries past its
    sequence are ignored; it must cover ``ceil(seq_lens[r] / block_tokens)``
    entries). ``pad_to``: pad the flat page list to this length (0 = exact).
    ``pad_to_pow2``: pad to the power of two above the page count. The
    arrays are the JAX ``build_ragged_wave``'s, value for value."""
    seq_lens = np.asarray(seq_lens, dtype=np.int32)
    r = len(tables)
    if r == 0 or seq_lens.shape != (r,):
        raise ValueError(f"need >= 1 rows with one seq_len each, got {r} "
                         f"tables / seq_lens {seq_lens.shape}")
    chunks, starts, total = [], [], 0
    for row, table in enumerate(tables):
        table = np.asarray(table, dtype=np.int32).reshape(-1)
        nb = max(1, -(-int(seq_lens[row]) // block_tokens))
        if table.shape[0] < nb:
            raise ValueError(
                f"row {row}: table has {table.shape[0]} pages, needs {nb} "
                f"for seq_len {int(seq_lens[row])}"
            )
        chunks.append(table[:nb])
        starts.append(total)
        total += nb
    if pad_to and pad_to < total:
        raise ValueError(f"pad_to={pad_to} < {total} real pages")
    if pad_to_pow2 and not pad_to:
        pad_to = 1 << (total - 1).bit_length()
    p = pad_to or total
    pages = np.empty(p, dtype=np.int32)
    pages[:total] = np.concatenate(chunks)
    pages[total:] = pages[total - 1]  # a valid id; never read
    page_rows = np.empty(p + 1, dtype=np.int32)
    for row, start in enumerate(starts):
        end = starts[row + 1] if row + 1 < r else total
        page_rows[start:end] = row
    page_rows[total:p] = r - 1  # padding rides the last row
    page_rows[p] = r  # sentinel
    return RaggedWaveMeta(
        pages=pages,
        page_rows=page_rows,
        page_starts=np.asarray(starts, dtype=np.int32),
        seq_lens=seq_lens,
        pad_pages=p - total,
    )


def _ragged_row_tables(pages, page_starts, table_width: int):
    """[R, table_width] per-row tables rebuilt from the flat page list.
    Entries past a row's real pages alias later pages of the list (clamped
    in range): valid ids whose contents seq_len masks."""
    idx = page_starts.to(torch.long)[:, None] + torch.arange(
        table_width, dtype=torch.long, device=pages.device)[None, :]
    return pages[torch.clamp(idx, max=pages.shape[0] - 1)]


def _owned_tokens(pages, page_starts):
    """Tokens each row's slice of the flat list can hold: pages up to the
    next row's start (the last row: up to the end of the list) x bt is the
    most a row attends to, on both paths."""
    starts = page_starts.to(torch.long)
    ends = torch.cat([starts[1:], torch.tensor([pages.shape[0]], device=starts.device)])
    return torch.clamp(ends - starts, min=0)


def paged_decode_attention_ragged_plain(q, k_cache, v_cache, pages, page_starts,
                                        seq_lens, table_width: int):
    """The plain version of K6: rebuild each row's table from the flat list
    and run the plain batched version over it. A row attends to at most the
    pages it owns in the flat list (the kernel's rule; a well-formed wave
    never asks for more)."""
    bt = k_cache.shape[1]
    tables = _ragged_row_tables(pages, page_starts, table_width)
    lens = torch.minimum(seq_lens.to(torch.long), _owned_tokens(pages, page_starts) * bt)
    return paged_decode_attention_plain_batched(q, k_cache, v_cache, tables, lens)


def _paged_decode_attention_ragged_cuda(q, k_cache, v_cache, pages, page_rows,
                                        page_starts, seq_lens):
    name = "paged_decode_attention_ragged"
    _ext.require_cuda(
        name, q.device, q=q, k_cache=k_cache, v_cache=v_cache, pages=pages,
        page_rows=page_rows, page_starts=page_starts, seq_lens=seq_lens,
    )
    r, h, d = q.shape
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
    p = pages.shape[0] if pages.dim() == 1 else -1
    for arg, t, want in (("pages", pages, (p,)), ("page_rows", page_rows, (p + 1,)),
                         ("page_starts", page_starts, (r,)), ("seq_lens", seq_lens, (r,))):
        if tuple(t.shape) != want or t.dtype != torch.int32 or p <= 0:
            raise ValueError(f"{name}: {arg} must be {list(want)} int32 (pages [P], "
                             f"page_rows [P + 1], page_starts and seq_lens [{r}])")
    out = torch.empty_like(q)
    code = _ext.kernels().its_paged_decode_attention_ragged(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pages.data_ptr(),
        page_starts.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        _ext.dtype_code(name, q.dtype), r, h, kvh, d, bt, n, p, _ext.stream_of(q),
    )
    _ext.LAUNCHES["paged_decode_attention_ragged"] += 1
    _ext.check(code, name)
    return out


def paged_decode_attention_ragged(q, k_cache, v_cache, pages, page_rows, page_starts,
                                  seq_lens, *, table_width: int):
    """Decode attention for a RAGGED wave: R rows over one shared paged
    cache with per-row context lengths, no padding to the wave's longest.

    q: [R, n_heads, head_dim]; the flat metadata follows
    :class:`RaggedWaveMeta` (tensors, or numpy arrays moved to q's device).
    ``table_width``: the most pages any row spans; only the plain version
    uses it, to rebuild rectangular tables. Kernel K6 on CUDA (one launch,
    sum(ceil(len_i / bt)) page folds), the plain version on CPU. Rows with
    seq_len 0 return zeros."""
    pages, page_rows, page_starts, seq_lens = (
        torch.as_tensor(x, dtype=torch.int32, device=q.device)
        for x in (pages, page_rows, page_starts, seq_lens))
    if q.device.type == "cpu":
        return paged_decode_attention_ragged_plain(
            q, k_cache, v_cache, pages, page_starts, seq_lens, table_width)
    return _paged_decode_attention_ragged_cuda(
        q, k_cache, v_cache, pages, page_rows, page_starts, seq_lens)


def paged_decode_attention_rows(q, k_cache, v_cache, row_tables, seq_lens, pages,
                                page_rows, page_starts):
    """Per-row decode attention with both layouts in hand: the model's ragged
    wave body (``models/llama.py verify_step_ragged``) calls this with one
    row per flat wave token. Same semantics as
    :func:`paged_decode_attention_batched` over ``row_tables``. On CUDA the
    flat metadata goes to kernel K6; on CPU the plain batched version runs
    over ``row_tables``, as the JAX package's fallback does."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain_batched(q, k_cache, v_cache, row_tables, seq_lens)
    return _paged_decode_attention_ragged_cuda(
        q, k_cache, v_cache, pages, page_rows, page_starts, seq_lens.to(torch.int32))
