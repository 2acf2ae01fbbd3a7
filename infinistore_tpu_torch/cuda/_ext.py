"""The port's Hopper kernels: build, load, bind, and count their launches.

The CUDA C++ sources in ``cuda/csrc`` have a plain C interface. At the first
launch in a process (never at import, never on a machine without a card),
each ``.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``, all started
together, and one more ``nvcc`` links them into
``infinistore_tpu_torch/_build/libits_kernels.so`` (``_build.build_once``:
under a file lock, rebuilt when a source changes). The library is loaded
with ctypes; pointers and the stream travel as ``c_void_p``. Every entry
returns ``cudaGetLastError()`` after its launch, and ``check`` raises on a
non-zero code.

``LAUNCHES`` counts, per kernel, the launches the wrappers made; a wrapper
adds one exactly where it launches its kernel, so a run can show that its
work went through the kernels. ``flash_prefill`` counts every launch of K4;
``flash_prefill_wgmma`` counts the ones that took its bf16 tensor-core
kernel, so a run can show which of K4's two kernels its path took. In the
same way ``gather_blocks`` / ``scatter_blocks`` count every launch of K1 /
K2, and ``gather_blocks_bulk`` / ``scatter_blocks_bulk`` the ones that
took the TMA bulk ring rather than the vector kernel.

The paged decode kernels (K3, K5-K8) split each row's pages across CTAs
(``csrc/decode_fold.cuh``). Their wrappers size the split scratch from
shapes alone, with the library's own split count for the table width
(``decode_splits``: ``its_decode_splits``, asked once per width), and take
the scratch and the ticket counters of the splits' merge from the stream's
workspace (``split_workspace``).
"""

import ctypes
import os
import shutil
import threading
from ctypes import c_int, c_int64, c_void_p

import torch

from .._build import BUILD_DIR, build_once

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCES = (
    "paged_copy.cu", "paged_attention.cu", "paged_attention_stats.cu", "kv_quant.cu",
    "flash_prefill.cu", "flash_prefill_wgmma.cu",
)
LIB_PATH = os.path.join(BUILD_DIR, "libits_kernels.so")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")

# dtype codes of csrc/common.cuh (its::DType).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = {
    "gather_blocks": 0,
    "gather_blocks_bulk": 0,
    "scatter_blocks": 0,
    "scatter_blocks_bulk": 0,
    "paged_decode_attention": 0,
    "paged_decode_attention_ragged": 0,
    "flash_prefill": 0,
    "flash_prefill_wgmma": 0,
    "paged_decode_attention_stats": 0,
    "paged_decode_attention_ragged_stats": 0,
    "paged_decode_attention_quantized": 0,
}

_lib = None
_lib_lock = threading.Lock()
# (device, stream) -> [f32 split scratch, int32 ticket zeros] of the decode kernels.
_WORKSPACE = {}
_workspace_lock = threading.Lock()
# table width -> the library's split count for it.
_SPLITS = {}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def resolve_device(device) -> torch.device:
    """The device an entry point was asked for; raises when it is a CUDA
    device and no card is present (there is no quiet move to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but no CUDA device is available; "
                "pass device='cpu' to run the plain PyTorch versions"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r} (expected cuda or cpu)")
    return dev


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def _compile_commands(tmp_path: str):
    nvcc = _nvcc()
    objs = []
    cmds = []
    for src in SOURCES:
        obj = os.path.join(BUILD_DIR, os.path.splitext(src)[0] + ".o")
        objs.append(obj)
        cmds.append([
            nvcc, *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-c",
            os.path.join(CSRC, src), "-o", obj,
        ])
    cmds.append([nvcc, *ARCH, "-shared", *objs, "-o", tmp_path])
    return cmds


def build() -> str:
    """Compile the kernel library if it is missing or stale; returns its path."""
    inputs = [os.path.join(CSRC, f) for f in sorted(os.listdir(CSRC))]
    return build_once(LIB_PATH, inputs, _compile_commands)


_P, _I = c_void_p, c_int
# Each entry point's C arguments, in order (pointers and the stream last as
# c_void_p; ctypes would otherwise pass them as 32-bit ints).
ARGTYPES = {
    # caches[C], flats[C] (ctypes arrays of c_void_p), ids, C, n, num_blocks,
    # block_bytes, stream: the TMA bulk ring and the vector kernel
    "its_gather_blocks_many": [_P, _P, _P] + [c_int64] * 4 + [_P],
    "its_scatter_blocks_many": [_P, _P, _P] + [c_int64] * 4 + [_P],
    "its_gather_blocks_many_vec": [_P, _P, _P] + [c_int64] * 4 + [_P],
    "its_scatter_blocks_many_vec": [_P, _P, _P] + [c_int64] * 4 + [_P],
    # q, k, v, tables, seq_lens, out, scratch, tickets,
    # dtype, B, H, KVH, D, bt, N, max_blocks, splits, stream
    "its_paged_decode_attention": [_P] * 8 + [_I] * 9 + [_P],
    # q, k, v, pages, page_starts, seq_lens, out, scratch, tickets,
    # dtype, R, H, KVH, D, bt, N, P, width, splits, stream
    "its_paged_decode_attention_ragged": [_P] * 9 + [_I] * 10 + [_P],
    # q, k, v, out, B, S, T, H, KVH, D, causal, stream
    "its_flash_prefill": [_P] * 4 + [_I] * 7 + [_P],
    "its_flash_prefill_wgmma": [_P] * 4 + [_I] * 7 + [_P],
    # K3's, with acc, m, l in place of out
    "its_paged_decode_attention_stats": [_P] * 10 + [_I] * 9 + [_P],
    # K6's, with acc, m, l in place of out
    "its_paged_decode_attention_ragged_stats": [_P] * 11 + [_I] * 10 + [_P],
    # K3's, with k_data, k_scales, v_data, v_scales in place of k, v
    "its_paged_decode_attention_quantized": [_P] * 10 + [_I] * 9 + [_P],
    "its_decode_splits": [_I],
}


def kernels() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in ARGTYPES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = c_int
            _lib = lib
    return _lib


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of the current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def decode_splits(width: int) -> int:
    """The decode kernels' split count for tables ``width`` pages wide (the
    grid's split dimension, by which a wrapper sizes its scratch): the
    library's ``its_decode_splits``, asked once per width, so a steady-state
    launch makes no call for it."""
    splits = _SPLITS.get(width)
    if splits is None:
        splits = _SPLITS[width] = kernels().its_decode_splits(width)
    return splits


def split_workspace(device: torch.device, stream: int, floats: int, tickets: int):
    """(scratch, tickets) of a decode launch on ``stream``: at least
    ``floats`` f32 of split scratch and at least ``tickets`` int32 ticket
    counters, zeros. Both are allocated once per (device, stream), on that
    stream, and grown when a launch needs more. Launches on one stream run in
    order, so they share them: a launch reads only the partials it wrote
    itself, and leaves the tickets zero (the last split of a row resets its
    counter). A stream of its own gets its own."""
    key = (device, stream)
    with _workspace_lock:
        ws = _WORKSPACE.get(key)
        if ws is None:
            ws = _WORKSPACE[key] = [torch.empty(0, dtype=torch.float32, device=device),
                                    torch.zeros(0, dtype=torch.int32, device=device)]
        if ws[0].numel() < floats:
            ws[0] = torch.empty(max(floats, 2 * ws[0].numel()), dtype=torch.float32,
                                device=device)
        if ws[1].numel() < tickets:
            ws[1] = torch.zeros(max(tickets, 2 * ws[1].numel(), 1024), dtype=torch.int32,
                                device=device)
        return ws[0], ws[1]


def check(code: int, name: str) -> None:
    """Raise when a kernel entry reported a CUDA error (a negative code is
    minus the CUresult of a failed tensor-map encode)."""
    if code < 0:
        raise RuntimeError(f"{name}: tensor-map encode failed with CUresult {-code}")
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def require_aligned(name: str, **tensors: torch.Tensor) -> None:
    """The decode kernels copy cache rows 16 bytes at a time: each of
    ``tensors`` must start on a 16-byte boundary."""
    for arg, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must start on a 16-byte boundary")


def require_cuda(name: str, device: torch.device, **tensors: torch.Tensor) -> None:
    """Every tensor a kernel takes must be a contiguous CUDA tensor on
    ``device``."""
    for arg, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {arg} is on {t.device}; the kernel takes CUDA tensors")
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def dtype_code(name: str, dtype: torch.dtype) -> int:
    code = DTYPE_CODES.get(dtype)
    if code is None:
        raise TypeError(f"{name}: unsupported dtype {dtype} (float32 or bfloat16)")
    return code
