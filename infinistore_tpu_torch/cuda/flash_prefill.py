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
"""

import math

import torch

from . import _ext

_NEG_INF = -1e30


def flash_prefill_plain(q, k, v, *, causal=True):
    """Dense reference: q [B, S, H, D], k/v [B, T, KVH, D] -> [B, S, H, D]."""
    groups = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(groups, dim=2)
    v = v.repeat_interleave(groups, dim=2)
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    if causal:
        s, t = q.shape[1], k.shape[1]
        cm = torch.arange(s, device=q.device)[:, None] >= torch.arange(t, device=q.device)[None, :]
        logits = logits.masked_fill(~cm[None, None], _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, v.float())
    return out.to(q.dtype)


def _flash_prefill_cuda(q, k, v, *, causal):
    """K4 on CUDA tensors. The kernel is chosen by dtype, and nothing else:
    bf16 goes to ``its_flash_prefill_wgmma`` (tensor cores), f32 to
    ``its_flash_prefill`` (CUDA cores: the f32 contract is HIGHEST-precision
    dots, which wgmma has no form for), at every head_dim of
    ``_ext.HEAD_DIMS`` in both; any other dtype or head_dim raises. There is no fallback: a failed build, tensor-map
    encode or launch raises. ``LAUNCHES["flash_prefill"]`` counts both;
    ``LAUNCHES["flash_prefill_wgmma"]`` the bf16 launches alone."""
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
    entry = lib.its_flash_prefill_wgmma if wgmma else lib.its_flash_prefill
    with _ext.on_device(q.device):
        code = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     b, s, t, h, kvh, d, int(causal), _ext.stream_of(q))
    _ext.LAUNCHES["flash_prefill"] += 1
    if wgmma:
        _ext.LAUNCHES["flash_prefill_wgmma"] += 1
    _ext.check(code, name)
    return out


def flash_prefill_attention(q, k, v, *, causal=True):
    """Prefill attention without materialising S x T logits.

    q: [B, S, H, D]; k/v: [B, T, KVH, D] with KVH dividing H (GQA); any S
    and T. Kernel K4 on CUDA, the plain dense version on CPU.

    ``causal=True`` masks by GLOBAL position assuming q and k both start at
    position 0, so it requires S == T; a suffix chunk attending a longer
    context would be silently over-masked, so it is rejected."""
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(
            f"causal=True assumes q and k start at position 0, so S must "
            f"equal T (got S={q.shape[1]}, T={k.shape[1]}); offset suffix "
            "chunks would be over-masked"
        )
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, causal=causal)
    return _flash_prefill_cuda(q, k, v, causal=causal)
