"""Fused paged decode attention for a wave of requests (port of the batched
and ragged decode in ``infinistore_tpu/tpu/paged_attention.py``).

One query token per request attends over the paged KV cache blocks its
block-table row names, without materialising the gathered context. On CUDA
tensors this is kernel K3 (``csrc/paged_attention.cu``); on CPU tensors the
plain version below, which mirrors the JAX package's XLA reference
(``_decode_attention_stats_xla`` + ``paged_decode_attention_xla_batched``).
The decode kernels (K3, K5-K8) split each row's pages across CTAs; a
wrapper sizes the split scratch from shapes alone (rows x splits x H x
(D + 2) f32, splits from the table width, asked of the library once per
width), takes it from the stream's workspace (allocated once, grown when a
launch needs more), and reads no device value.

The ragged half (``RaggedWaveMeta``, ``build_ragged_wave``,
``paged_decode_attention_ragged``, ``paged_decode_attention_rows``) serves a
wave whose rows keep their own context lengths: the rows' page lists are
concatenated into one flat list, so a length-skewed wave reads
sum(ceil(len_i / bt)) pages instead of B x max_blocks. On CUDA tensors it
is kernel K6 (same source file, the same fold as K3); on CPU tensors the
rows' tables are rebuilt from the flat list and the plain batched version
runs over them, as the JAX package's XLA path does.

The sharded half (``paged_decode_attention_sharded``,
``build_ragged_wave_sharded``, ``paged_decode_attention_ragged_sharded``)
serves a context whose pages are split over the ranks of a
``torch.distributed`` process group: each rank folds its own pages into the
raw softmax statistics (kernels K5 and K7 on CUDA tensors,
``decode_attention_stats_plain`` on CPU tensors), and one ``all_reduce``
MAX and two SUMs combine them (``combine_stats``), as the JAX package's
shard_map does with one pmax and two psums.

Numerical contract (shared with the JAX package): logits and softmax
statistics in float32, output cast to the query dtype. Positions >= seq_len
are masked; padded block-table entries past the sequence contribute nothing;
a row with seq_len == 0 yields zeros, not NaN.

K3 and K6 (and their plain versions) take a sliding ``window`` of keys (0,
the default: none): a row of seq_len keys then attends keys seq_len - window
.. seq_len - 1 alone. On the card the whole pages before the window are
neither read nor given splits, and the splits, with their scratch, are those
of the window's pages.
"""

import math

import numpy as np
import torch

from . import _ext

_NEG_INF = -1e30


def decode_attention_stats_plain(q, k_cache, v_cache, block_tables, seq_lens, window=0):
    """The raw softmax statistics of each row: gather its table's blocks,
    mask positions >= seq_len, f32 logits. Returns (acc [B, H, D], m [B, H,
    1], l [B, H, 1]), all f32: acc the unnormalised numerator, m the max
    logit, l the denominator relative to m. An empty row gives acc 0, l 0, m
    ``_NEG_INF``, so it carries no weight in a combine. Mirrors the JAX
    package's ``_decode_attention_stats_xla``; the plain version of K5.

    q: [B, H, D]; caches: [N, bt, KVH, D]; block_tables: [B, max_blocks];
    seq_lens: [B]; ``window`` > 0 also masks positions < seq_len - window."""
    bsz, h, d = q.shape
    _, bt, kvh, _ = k_cache.shape
    groups = h // kvh
    tables = block_tables.to(torch.long)
    k = k_cache[tables].reshape(bsz, -1, kvh, d).repeat_interleave(groups, dim=2)
    v = v_cache[tables].reshape(bsz, -1, kvh, d).repeat_interleave(groups, dim=2)
    scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("bhd,bthd->bht", q.float(), k.float()) * scale
    t = k.shape[1]
    lens = seq_lens.to(device=q.device, dtype=torch.long)[:, None]
    valid = torch.arange(t, device=q.device)[None, :] < lens  # [B, T]
    if window > 0:
        valid &= torch.arange(t, device=q.device)[None, :] >= lens - window
    logits = torch.where(valid[:, None, :], logits, torch.full_like(logits, _NEG_INF))
    m = logits.amax(dim=2, keepdim=True)
    p = torch.exp(logits - m)
    # An all-masked row leaves m at _NEG_INF and exp(0) = 1: zero those
    # weights so its (acc, l) contribute nothing.
    p = torch.where(valid[:, None, :], p, torch.zeros_like(p))
    l = p.sum(dim=2, keepdim=True)
    acc = torch.einsum("bht,bthd->bhd", p, v.float())
    return acc, m, l


def paged_decode_attention_plain_batched(q, k_cache, v_cache, block_tables, seq_lens,
                                         window=0):
    """The plain version of K3: the raw statistics, normalised.

    q: [B, H, D]; caches: [N, bt, KVH, D]; block_tables: [B, max_blocks];
    seq_lens: [B]; ``window``: a sliding window's keys (0: none). Returns [B,
    H, D] in q's dtype."""
    acc, _, l = decode_attention_stats_plain(q, k_cache, v_cache, block_tables, seq_lens,
                                             window)
    return _normalize(acc, l, q.dtype)


def _normalize(acc, l, dtype):
    """acc / max(l, 1e-30) in ``dtype``: an empty row (l 0) reads as zeros."""
    return (acc / torch.clamp(l, min=1e-30)).to(dtype)


def _check_decode_args(name, q, k_cache, v_cache, same_dtype=True):
    """The shape contract K3, K5, K6 and K7 share (K8 adds its own)."""
    _, h, d = q.shape
    _, _, kvh, dk = k_cache.shape
    if tuple(v_cache.shape) != tuple(k_cache.shape) or dk != d:
        raise ValueError(f"{name}: cache shapes {tuple(k_cache.shape)}/"
                         f"{tuple(v_cache.shape)} do not match q {tuple(q.shape)}")
    if same_dtype and (k_cache.dtype != q.dtype or v_cache.dtype != q.dtype):
        raise TypeError(f"{name}: q and caches must share a dtype")
    if h % kvh or d not in _ext.HEAD_DIMS:
        raise ValueError(
            f"{name}: kernel takes head_dim {_ext.HEAD_DIMS_TEXT} and KV heads dividing "
            f"the query heads; got head_dim {d}, {h} heads, {kvh} KV heads"
        )


def _check_table_args(name, q, block_tables, seq_lens):
    bsz = q.shape[0]
    if block_tables.dim() != 2 or block_tables.shape[0] != bsz or \
            block_tables.shape[1] < 1 or block_tables.dtype != torch.int32:
        raise ValueError(f"{name}: block_tables must be [{bsz}, max_blocks >= 1] int32")
    if tuple(seq_lens.shape) != (bsz,) or seq_lens.dtype != torch.int32:
        raise ValueError(f"{name}: seq_lens must be [{bsz}] int32")


def _check_ragged_args(name, q, pages, page_rows, page_starts, seq_lens) -> int:
    """Validates the flat wave metadata; returns P."""
    r = q.shape[0]
    p = pages.shape[0] if pages.dim() == 1 else -1
    for arg, t, want in (("pages", pages, (p,)), ("page_rows", page_rows, (p + 1,)),
                         ("page_starts", page_starts, (r,)), ("seq_lens", seq_lens, (r,))):
        if tuple(t.shape) != want or t.dtype != torch.int32 or p <= 0:
            raise ValueError(f"{name}: {arg} must be {list(want)} int32 (pages [P], "
                             f"page_rows [P + 1], page_starts and seq_lens [{r}])")
    return p


def _ragged_width(name, table_width, p: int) -> int:
    """The pages a ragged row may span on the kernel (its splits): the
    caller's table width, at most the flat list's P."""
    if int(table_width) < 1:
        raise ValueError(f"{name}: table_width must be >= 1, got {table_width}")
    return min(int(table_width), p)


def _fold_width(width: int, window: int, bt: int) -> int:
    """The pages a launch's rows may fold: ``width``, at most the pages a
    window of ``window`` keys spans once the whole pages before it are
    skipped, ceil((window + bt - 1) / bt) (``csrc/decode_fold.cuh``:
    fold_width)."""
    return min(width, (window + 2 * bt - 2) // bt) if window > 0 else width


def _split_scratch(q, width: int, stream: int):
    """(scratch, tickets, splits) of one decode launch over tables ``width``
    pages wide, from shapes alone: the library's split count of the width,
    and the stream's workspace, at least f32 partials for every (row, split,
    query head), acc [D] and (m, l), and a ticket counter per (row, query
    head, split): the kernels take one per (row, virtual KV head, split), a
    virtual KV head being one to eight query heads as the library picks
    (``csrc/decode_fold.cuh``: ``by_group``), and a row of many splits merges
    in a tree, one counter per group of splits."""
    rows, h, d = q.shape
    splits = _ext.decode_splits(width)
    scratch, tickets = _ext.split_workspace(q.device, stream, rows * splits * h * (d + 2),
                                            rows * h * splits)
    return scratch, tickets, splits


def _stats_outputs(q):
    rows, h, d = q.shape
    return (torch.empty((rows, h, d), dtype=torch.float32, device=q.device),
            torch.empty((rows, h, 1), dtype=torch.float32, device=q.device),
            torch.empty((rows, h, 1), dtype=torch.float32, device=q.device))


def _paged_decode_attention_cuda(q, k_cache, v_cache, block_tables, seq_lens, window=0):
    name = "paged_decode_attention"
    _ext.require_cuda(
        name, q.device, q=q, k_cache=k_cache, v_cache=v_cache,
        block_tables=block_tables, seq_lens=seq_lens,
    )
    _check_decode_args(name, q, k_cache, v_cache)
    _check_table_args(name, q, block_tables, seq_lens)
    _ext.require_aligned(name, k_cache=k_cache, v_cache=v_cache)
    dtype = _ext.dtype_code(name, q.dtype)
    bsz, h, d = q.shape
    n, bt, kvh, _ = k_cache.shape
    width = block_tables.shape[1]
    stream = _ext.stream_of(q)
    scratch, tickets, splits = _split_scratch(q, _fold_width(width, window, bt), stream)
    out = torch.empty_like(q)
    with _ext.on_device(q.device):
        code = _ext.kernels().its_paged_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), block_tables.data_ptr(),
            seq_lens.data_ptr(), out.data_ptr(), scratch.data_ptr(), tickets.data_ptr(), dtype,
            bsz, h, kvh, d, bt, n, width, splits, window, stream,
        )
    _ext.LAUNCHES["paged_decode_attention"] += 1
    _ext.check(code, name)
    return out


def paged_decode_attention_batched(q, k_cache, v_cache, block_tables, seq_lens, window=0):
    """Decode attention for a wave of requests against one shared paged cache.

    q: [B, n_heads, head_dim]; k_cache/v_cache: [num_blocks, block_tokens,
    n_kv_heads, head_dim]; block_tables: [B, max_blocks] int32 (each row
    padded with any valid block id); seq_lens: [B] int32; ``window``: a
    sliding window's keys (0: none). Returns [B, n_heads, head_dim] in q's
    dtype. Kernel K3 on CUDA (one launch for the wave), the plain version on
    CPU."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain_batched(q, k_cache, v_cache, block_tables, seq_lens,
                                                    window)
    return _paged_decode_attention_cuda(q, k_cache, v_cache, block_tables, seq_lens, window)


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


def decode_attention_stats_ragged_plain(q, k_cache, v_cache, pages, page_starts, seq_lens,
                                        table_width: int, window: int = 0):
    """The raw statistics of a ragged wave's rows (the plain version of K7):
    rebuild each row's table from the flat list and run
    :func:`decode_attention_stats_plain` over it. A row attends to at most
    the pages it owns in the flat list (the kernels' rule; a well-formed
    wave never asks for more)."""
    bt = k_cache.shape[1]
    tables = _ragged_row_tables(pages, page_starts, table_width)
    lens = torch.minimum(seq_lens.to(torch.long), _owned_tokens(pages, page_starts) * bt)
    return decode_attention_stats_plain(q, k_cache, v_cache, tables, lens, window)


def paged_decode_attention_ragged_plain(q, k_cache, v_cache, pages, page_starts,
                                        seq_lens, table_width: int, window: int = 0):
    """The plain version of K6: the ragged raw statistics, normalised."""
    acc, _, l = decode_attention_stats_ragged_plain(
        q, k_cache, v_cache, pages, page_starts, seq_lens, table_width, window)
    return _normalize(acc, l, q.dtype)


def _paged_decode_attention_ragged_cuda(q, k_cache, v_cache, pages, page_rows,
                                        page_starts, seq_lens, table_width, window=0):
    name = "paged_decode_attention_ragged"
    _ext.require_cuda(
        name, q.device, q=q, k_cache=k_cache, v_cache=v_cache, pages=pages,
        page_rows=page_rows, page_starts=page_starts, seq_lens=seq_lens,
    )
    _check_decode_args(name, q, k_cache, v_cache)
    p = _check_ragged_args(name, q, pages, page_rows, page_starts, seq_lens)
    width = _ragged_width(name, table_width, p)
    _ext.require_aligned(name, k_cache=k_cache, v_cache=v_cache)
    dtype = _ext.dtype_code(name, q.dtype)
    r, h, d = q.shape
    n, bt, kvh, _ = k_cache.shape
    stream = _ext.stream_of(q)
    scratch, tickets, splits = _split_scratch(q, _fold_width(width, window, bt), stream)
    out = torch.empty_like(q)
    with _ext.on_device(q.device):
        code = _ext.kernels().its_paged_decode_attention_ragged(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pages.data_ptr(),
            page_starts.data_ptr(), seq_lens.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            tickets.data_ptr(), dtype, r, h, kvh, d, bt, n, p, width, splits, window, stream,
        )
    _ext.LAUNCHES["paged_decode_attention_ragged"] += 1
    _ext.check(code, name)
    return out


def paged_decode_attention_ragged(q, k_cache, v_cache, pages, page_rows, page_starts,
                                  seq_lens, *, table_width: int, window: int = 0):
    """Decode attention for a RAGGED wave: R rows over one shared paged
    cache with per-row context lengths, no padding to the wave's longest.

    q: [R, n_heads, head_dim]; the flat metadata follows
    :class:`RaggedWaveMeta` (tensors, or numpy arrays moved to q's device).
    ``table_width``: the most pages any row spans; a row attends to at most
    that many, on both paths (the plain version rebuilds rectangular tables
    of that width, the kernel sizes its splits by it). Kernel K6 on CUDA
    (one launch, sum(ceil(len_i / bt)) page folds), the plain version on
    CPU. Rows with seq_len 0 return zeros. ``window``: a sliding window's
    keys (0: none)."""
    pages, page_rows, page_starts, seq_lens = (
        torch.as_tensor(x, dtype=torch.int32, device=q.device)
        for x in (pages, page_rows, page_starts, seq_lens))
    if q.device.type == "cpu":
        return paged_decode_attention_ragged_plain(
            q, k_cache, v_cache, pages, page_starts, seq_lens, table_width, window)
    return _paged_decode_attention_ragged_cuda(
        q, k_cache, v_cache, pages, page_rows, page_starts, seq_lens, table_width, window)


def paged_decode_attention_rows(q, k_cache, v_cache, row_tables, seq_lens, pages,
                                page_rows, page_starts, window=0):
    """Per-row decode attention with both layouts in hand: the model's ragged
    wave body (``models/llama.py verify_step_ragged``) calls this with one
    row per flat wave token. Same semantics as
    :func:`paged_decode_attention_batched` over ``row_tables``. On CUDA the
    flat metadata goes to kernel K6, its table width ``row_tables``'
    (``row_tables.shape[1]`` bounds its splits); on CPU the plain batched
    version runs over ``row_tables``, as the JAX package's fallback does.
    ``window``: a sliding window's keys (0: none)."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain_batched(q, k_cache, v_cache, row_tables, seq_lens,
                                                    window)
    return _paged_decode_attention_ragged_cuda(
        q, k_cache, v_cache, pages, page_rows, page_starts, seq_lens.to(torch.int32),
        row_tables.shape[1], window)


# ---------------------------------------------------------------------------
# Raw statistics (K5, K7) and sharded decode over torch.distributed.
# ---------------------------------------------------------------------------


def _decode_attention_stats_cuda(q, k_cache, v_cache, block_tables, seq_lens):
    name = "paged_decode_attention_stats"
    _ext.require_cuda(
        name, q.device, q=q, k_cache=k_cache, v_cache=v_cache,
        block_tables=block_tables, seq_lens=seq_lens,
    )
    _check_decode_args(name, q, k_cache, v_cache)
    _check_table_args(name, q, block_tables, seq_lens)
    _ext.require_aligned(name, k_cache=k_cache, v_cache=v_cache)
    dtype = _ext.dtype_code(name, q.dtype)
    bsz, h, d = q.shape
    n, bt, kvh, _ = k_cache.shape
    width = block_tables.shape[1]
    stream = _ext.stream_of(q)
    scratch, tickets, splits = _split_scratch(q, width, stream)
    acc, m, l = _stats_outputs(q)
    with _ext.on_device(q.device):
        code = _ext.kernels().its_paged_decode_attention_stats(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), block_tables.data_ptr(),
            seq_lens.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(), scratch.data_ptr(),
            tickets.data_ptr(), dtype, bsz, h, kvh, d, bt, n, width, splits, stream,
        )
    _ext.LAUNCHES["paged_decode_attention_stats"] += 1
    _ext.check(code, name)
    return acc, m, l


def _decode_attention_stats(q, k_cache, v_cache, block_tables, seq_lens):
    """Raw (acc [B, H, D], m [B, H, 1], l [B, H, 1]) per row, f32: kernel K5
    on CUDA tensors, :func:`decode_attention_stats_plain` on CPU tensors."""
    if q.device.type == "cpu":
        return decode_attention_stats_plain(q, k_cache, v_cache, block_tables, seq_lens)
    return _decode_attention_stats_cuda(q, k_cache, v_cache, block_tables, seq_lens)


def _decode_attention_stats_ragged_cuda(q, k_cache, v_cache, pages, page_rows, page_starts,
                                        seq_lens, table_width):
    name = "paged_decode_attention_ragged_stats"
    _ext.require_cuda(
        name, q.device, q=q, k_cache=k_cache, v_cache=v_cache, pages=pages,
        page_rows=page_rows, page_starts=page_starts, seq_lens=seq_lens,
    )
    _check_decode_args(name, q, k_cache, v_cache)
    p = _check_ragged_args(name, q, pages, page_rows, page_starts, seq_lens)
    width = _ragged_width(name, table_width, p)
    _ext.require_aligned(name, k_cache=k_cache, v_cache=v_cache)
    dtype = _ext.dtype_code(name, q.dtype)
    r, h, d = q.shape
    n, bt, kvh, _ = k_cache.shape
    stream = _ext.stream_of(q)
    scratch, tickets, splits = _split_scratch(q, width, stream)
    acc, m, l = _stats_outputs(q)
    with _ext.on_device(q.device):
        code = _ext.kernels().its_paged_decode_attention_ragged_stats(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pages.data_ptr(),
            page_starts.data_ptr(), seq_lens.data_ptr(), acc.data_ptr(), m.data_ptr(),
            l.data_ptr(), scratch.data_ptr(), tickets.data_ptr(), dtype, r, h, kvh, d, bt, n, p,
            width, splits, stream,
        )
    _ext.LAUNCHES["paged_decode_attention_ragged_stats"] += 1
    _ext.check(code, name)
    return acc, m, l


def _decode_attention_stats_ragged(q, k_cache, v_cache, pages, page_rows, page_starts,
                                   seq_lens, table_width: int):
    """Raw ragged (acc [R, H, D], m [R, H, 1], l [R, H, 1]), f32: kernel K7
    on CUDA tensors, the plain version on CPU tensors; ``table_width``
    bounds each row's pages on both, as in
    :func:`paged_decode_attention_ragged`."""
    pages, page_rows, page_starts, seq_lens = (
        torch.as_tensor(x, dtype=torch.int32, device=q.device)
        for x in (pages, page_rows, page_starts, seq_lens))
    if q.device.type == "cpu":
        return decode_attention_stats_ragged_plain(
            q, k_cache, v_cache, pages, page_starts, seq_lens, table_width)
    return _decode_attention_stats_ragged_cuda(
        q, k_cache, v_cache, pages, page_rows, page_starts, seq_lens, table_width)


def combine_stats(acc, m, l, dtype, all_max, all_sum):
    """Combine shard-local raw statistics exactly (softmax is permutation-
    invariant, so shard order does not matter):

        out = sum_p(acc_p * e^(m_p - m)) / sum_p(l_p * e^(m_p - m)),
        m = max_p(m_p)

    ``all_max`` / ``all_sum`` reduce a tensor over the shards: ``all_reduce``
    over a process group in the sharded entry points, a reduction over a
    stacked leading axis where one process holds every shard's statistics.
    Over one shard the weights are exp(0) = 1 and this is the kernel's own
    normalisation, bitwise. Returns the output in ``dtype``."""
    m_g = all_max(m)
    w = torch.exp(m - m_g)
    return _normalize(all_sum(acc * w), all_sum(l * w), dtype)


def _group_reducers(group):
    """(all_max, all_sum) over ``group``'s ranks; raises without an
    initialised process group (there is no single-process path)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "sharded decode needs an initialised torch.distributed process group "
            "(init_process_group); each rank passes its own shard of the cache"
        )

    def reducer(op):
        def reduce(t):
            out = t.clone()
            dist.all_reduce(out, op=op, group=group)
            return out

        return reduce

    return reducer(dist.ReduceOp.MAX), reducer(dist.ReduceOp.SUM)


def paged_decode_attention_sharded(q, k_cache, v_cache, local_table, local_len, *,
                                   group=None):
    """Decode attention for one request whose paged KV cache is sharded
    over the ranks of ``group`` (default: the world) on the block dimension:
    the long-context serving shape where one context exceeds one device.

    Called on every rank of the group with that rank's shard: ``k_cache`` /
    ``v_cache`` [blocks_per_shard, bt, KVH, D], ``local_table``
    [n_local] int32 SHARD-LOCAL block ids, ``local_len`` the rank's count of
    valid tokens (0 is fine: an empty shard contributes nothing). ``q`` is
    [H, D], the same on every rank. Each rank folds its blocks with the raw
    statistics (kernel K5 on CUDA, the plain version on CPU) and one
    ``all_reduce`` MAX and two SUMs combine them (:func:`combine_stats`);
    only [H, D]-sized statistics cross between ranks. Returns [H, D] in q's
    dtype, the same on every rank. The port of the JAX package's
    ``paged_decode_attention_sharded``, whose shard_map, pmax and psums
    become a process group and all_reduce."""
    all_max, all_sum = _group_reducers(group)
    table = torch.as_tensor(local_table, dtype=torch.int32, device=q.device).reshape(1, -1)
    lens = torch.as_tensor(local_len, dtype=torch.int32, device=q.device).reshape(1)
    acc, m, l = _decode_attention_stats(q[None], k_cache, v_cache, table, lens)
    return combine_stats(acc[0], m[0], l[0], q.dtype, all_max, all_sum)


def build_ragged_wave_sharded(local_tables, local_lens, block_tokens: int):
    """Per-shard :func:`build_ragged_wave` metadata for a ragged wave whose
    KV pages are sharded, stacked into [P, ...] arrays (rank p passes row p
    to :func:`paged_decode_attention_ragged_sharded`).

    ``local_tables``: P sequences of R per-row SHARD-LOCAL page tables;
    ``local_lens``: [P, R] valid tokens per (shard, row); 0 is fine: the
    row gets one page on that shard that it never reads, and (acc 0, m
    -1e30, l 0) statistics with no weight in the combine. Every shard's flat
    list pads to the fleet's longest so the stacked arrays are rectangular.

    Returns (pages [P, maxP], page_rows [P, maxP + 1], page_starts [P, R],
    seq_lens [P, R], table_width), value for value the JAX package's."""
    local_lens = np.asarray(local_lens, dtype=np.int32)
    p = len(local_tables)
    if p == 0 or local_lens.shape[0] != p:
        raise ValueError("need one table list + len row per shard")
    # Per-(shard, row) page counts, build_ragged_wave's rule (a zero-length
    # row still carries one page), give the fleet max without building each
    # shard's metadata twice.
    counts = np.maximum(1, -(-local_lens // block_tokens))
    max_p = int(counts.sum(axis=1).max())
    padded = [
        build_ragged_wave(tables, lens, block_tokens, pad_to=max_p)
        for tables, lens in zip(local_tables, local_lens)
    ]
    return (
        np.stack([m.pages for m in padded]),
        np.stack([m.page_rows for m in padded]),
        np.stack([m.page_starts for m in padded]),
        local_lens,
        int(counts.max()),
    )


def paged_decode_attention_ragged_sharded(q, k_cache, v_cache, local_pages, local_rows,
                                          local_starts, local_lens, *, table_width: int,
                                          group=None):
    """Ragged decode attention for a wave of R rows whose paged KV is
    sharded over the ranks of ``group`` (default: the world).

    Called on every rank with that rank's shard of the cache ([blocks_per_
    shard, bt, KVH, D]) and its row of :func:`build_ragged_wave_sharded`'s
    arrays: ``local_pages`` [maxP], ``local_rows`` [maxP + 1],
    ``local_starts`` [R], ``local_lens`` [R]. ``q`` is [R, H, D], the same
    on every rank. Each rank folds its pages with the ragged raw statistics
    (kernel K7 on CUDA, the plain version on CPU, which rebuilds rows of
    ``table_width`` pages) and the per-row statistics combine by the same
    one max and two sums as :func:`paged_decode_attention_sharded`. Returns
    [R, H, D] in q's dtype; a row empty on every shard reads as zeros."""
    all_max, all_sum = _group_reducers(group)
    acc, m, l = _decode_attention_stats_ragged(
        q, k_cache, v_cache, local_pages, local_rows, local_starts, local_lens, table_width)
    return combine_stats(acc, m, l, q.dtype, all_max, all_sum)
