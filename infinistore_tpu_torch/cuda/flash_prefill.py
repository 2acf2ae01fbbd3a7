"""Blocked causal (flash) attention for prefill (port of
``infinistore_tpu/tpu/flash_prefill.py``).

Streams K/V tile by tile with an online softmax, so no S x T logits are
materialised. On CUDA tensors this is kernel K4, which has two kernels by
dtype: bf16 runs on the tensor cores (``csrc/flash_prefill_wgmma.cu``: wgmma
fed by TMA), f32 on the CUDA cores (``csrc/flash_prefill.cu``). On CPU
tensors the plain dense version below, which mirrors the JAX package's
``flash_prefill_xla``.

Numerical contract: f32 softmax statistics, full-precision f32 dots, output
cast to the query dtype. For bf16 inputs the kernel takes dots in bf16 with
f32 accumulation and rounds the probabilities to bf16 before the PV product
(as the TPU kernel does), so it agrees with the plain version at bf16's
rounding scale, not f32's.

A causal prefill may take a sliding ``window`` of keys (0, the default:
none): row p attends keys max(0, p - window + 1) .. p. On the card each
query tile starts at the key tile of its first row's window, so the tiles
before it are neither loaded nor computed (at head_dim 256 no key split
then).
"""

import math

import torch

from . import _ext

_NEG_INF = -1e30

# bf16 K4 at head_dim 256 (csrc/flash_prefill_wgmma.cu: Plan): query tiles of
# 128 rows, key tiles of 80, and, where a prompt's heads give fewer than
# _SPLIT_BELOW query tiles, the heaviest query tiles split over keys in two,
# each part at least _SPLIT_MIN_CHUNK key tiles. A merge slot holds, for
# each of the two warpgroups' 128 threads, O (128 f32) then m and l (2
# each).
_SPLIT_ROWS, _SPLIT_KEYS, _SPLIT_MIN_CHUNK, _SPLIT_BELOW = 128, 80, 4, 256
_SPLIT_SLOT_FLOATS = 2 * 128 * (128 + 4)


def _key_tiles(s, t, causal, qt):
    n_all = -(-t // _SPLIT_KEYS)
    if not causal:
        return n_all
    return min(n_all, (min((qt + 1) * _SPLIT_ROWS, s) - 1) // _SPLIT_KEYS + 1)


def wgmma_split(s, t, causal, h):
    """bf16 K4's work plan at head_dim 256 for S queries over T keys and H
    query heads: (query tiles n_qt, chunk C, first split query tile q_s).
    The last query tile needs n_max key tiles; a tile that needs more than
    C = ceil(n_max / 2) + 1 is split into keys [0, C) and [C, n), which holds
    for the tiles from q_s on. No split (q_s = n_qt) when n_qt x H reaches
    _SPLIT_BELOW (enough tiles to spread without it) or n_max < 2 x
    _SPLIT_MIN_CHUNK. A function of S, T, H and ``causal`` alone: a
    prompt's work, and so its output, does not depend on the batch it is
    launched in. The kernel computes the same plan; the wrapper sizes the
    merge's scratch by it."""
    n_qt = -(-s // _SPLIT_ROWS)
    n_max = _key_tiles(s, t, causal, n_qt - 1)
    if n_max < 2 * _SPLIT_MIN_CHUNK or n_qt * h >= _SPLIT_BELOW:
        return n_qt, n_max, n_qt
    c = (n_max + 1) // 2 + 1
    return n_qt, c, (min(n_qt, c * _SPLIT_KEYS // _SPLIT_ROWS) if causal else 0)


def wgmma_items(s, t, causal, h):
    """The work items of one (batch, head) under ``wgmma_split``, in the
    order the kernel deals them: (query tile, first key tile, end key tile,
    chunk), chunk 0 / 1 for a split tile's two parts and None for a whole
    tile. Heaviest first: the split tiles' first parts (C key tiles each)
    from the last query tile back; then the split tiles' second parts and
    the whole tiles, merged by key tiles (second parts first on a tie; the
    kernel merges the two lists by a binary search). The kernel deals item
    i of a launch over B x H (batch, head) pairs as
    ``wgmma_items(...)[i // (B * H)]`` of pair ``i % (B * H)``."""
    n_qt, c, q_s = wgmma_split(s, t, causal, h)
    firsts = [(qt, 0, c, 0) for qt in range(n_qt - 1, q_s - 1, -1)]
    seconds = [(qt, c, _key_tiles(s, t, causal, qt), 1) for qt in range(n_qt - 1, q_s - 1, -1)]
    wholes = [(qt, 0, _key_tiles(s, t, causal, qt), None) for qt in range(q_s - 1, -1, -1)]
    # A stable sort of two lists that each get lighter, by key tiles: a merge.
    return firsts + sorted(seconds + wholes, key=lambda item: item[1] - item[2])


def flash_prefill_plain(q, k, v, *, causal=True, window=0):
    """Dense reference: q [B, S, H, D], k/v [B, T, KVH, D] -> [B, S, H, D];
    ``window`` > 0 (causal) also masks keys at or before row - window."""
    groups = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(groups, dim=2)
    v = v.repeat_interleave(groups, dim=2)
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    if causal:
        s, t = q.shape[1], k.shape[1]
        rows = torch.arange(s, device=q.device)[:, None]
        keys = torch.arange(t, device=q.device)[None, :]
        cm = rows >= keys
        if window > 0:
            cm &= keys > rows - window
        logits = logits.masked_fill(~cm[None, None], _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, v.float())
    return out.to(q.dtype)


def _flash_prefill_cuda(q, k, v, *, causal, window=0):
    """K4 on CUDA tensors. The kernel is chosen by dtype, and nothing else:
    bf16 goes to ``its_flash_prefill_wgmma`` (tensor cores), f32 to
    ``its_flash_prefill`` (CUDA cores: the f32 contract is HIGHEST-precision
    dots, which wgmma has no form for), at every head_dim of
    ``_ext.HEAD_DIMS`` in both; any other dtype or head_dim raises. There is no fallback: a failed build, tensor-map
    encode or launch raises. ``LAUNCHES["flash_prefill"]`` counts both;
    ``LAUNCHES["flash_prefill_wgmma"]`` the bf16 launches alone. bf16 at
    head_dim 256 takes its split's merge scratch and tickets from the
    stream's workspace (``_ext.split_workspace``), sized by
    ``wgmma_split``."""
    name = "flash_prefill_attention"
    _ext.require_cuda(name, q.device, q=q, k=k, v=v)
    b, s, h, d = q.shape
    bk, t, kvh, dk = k.shape
    if tuple(v.shape) != tuple(k.shape) or bk != b or dk != d:
        raise ValueError(f"{name}: k/v {tuple(k.shape)}/{tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k and v must share a dtype")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: unsupported dtype {q.dtype} (bfloat16 or float32)")
    if h % kvh or d not in _ext.HEAD_DIMS:
        raise ValueError(
            f"{name}: kernel takes head_dim {_ext.HEAD_DIMS_TEXT} and KV heads dividing "
            f"the query heads; got head_dim {d}, {h} heads, {kvh} KV heads"
        )
    out = torch.empty_like(q)
    wgmma = q.dtype == torch.bfloat16
    if wgmma and any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError(f"{name}: TMA needs 16-byte aligned q, k and v")
    lib = _ext.kernels()
    stream = _ext.stream_of(q)
    with _ext.on_device(q.device):
        if wgmma:
            slots, scratch, tickets = 0, None, None
            if d == 256 and not window:
                n_qt, _, q_s = wgmma_split(s, t, causal, h)
                slots = (n_qt - q_s) * b * h
                if slots:
                    scratch, tickets = _ext.split_workspace(
                        q.device, stream, slots * _SPLIT_SLOT_FLOATS, 2 * slots)
            code = lib.its_flash_prefill_wgmma(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if scratch is None else scratch.data_ptr(),
                None if tickets is None else tickets.data_ptr(),
                b, s, t, h, kvh, d, int(causal), slots, window, stream)
        else:
            code = lib.its_flash_prefill(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                         out.data_ptr(), b, s, t, h, kvh, d, int(causal), window,
                                         stream)
    _ext.LAUNCHES["flash_prefill"] += 1
    if wgmma:
        _ext.LAUNCHES["flash_prefill_wgmma"] += 1
    _ext.check(code, name)
    return out


def flash_prefill_attention(q, k, v, *, causal=True, window=0):
    """Prefill attention without materialising S x T logits.

    q: [B, S, H, D]; k/v: [B, T, KVH, D] with KVH dividing H (GQA); any S
    and T. Kernel K4 on CUDA, the plain dense version on CPU.

    ``causal=True`` masks by GLOBAL position assuming q and k both start at
    position 0, so it requires S == T; a suffix chunk attending a longer
    context would be silently over-masked, so it is rejected. ``window`` > 0
    (causal only): a sliding window of that many keys."""
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(
            f"causal=True assumes q and k start at position 0, so S must "
            f"equal T (got S={q.shape[1]}, T={k.shape[1]}); offset suffix "
            "chunks would be over-masked"
        )
    if window and not causal:
        raise ValueError("a sliding window needs causal=True")
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, causal=causal, window=window)
    return _flash_prefill_cuda(q, k, v, causal=causal, window=window)
