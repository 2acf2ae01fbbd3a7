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
work went through the kernels.
"""

import ctypes
import os
import shutil
import threading
from ctypes import c_int, c_int64, c_void_p

import torch

from .._build import BUILD_DIR, build_once

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCES = ("paged_copy.cu", "paged_attention.cu", "flash_prefill.cu")
LIB_PATH = os.path.join(BUILD_DIR, "libits_kernels.so")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")

# dtype codes of csrc/common.cuh (its::DType).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = {
    "gather_blocks": 0,
    "scatter_blocks": 0,
    "paged_decode_attention": 0,
    "paged_decode_attention_ragged": 0,
    "flash_prefill": 0,
}

_lib = None
_lib_lock = threading.Lock()


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


def kernels() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            ptr = c_void_p
            lib.its_gather_blocks.argtypes = [ptr, ptr, ptr, c_int64, c_int64, c_int64, ptr]
            lib.its_scatter_blocks.argtypes = [ptr, ptr, ptr, c_int64, c_int64, c_int64, ptr]
            lib.its_paged_decode_attention.argtypes = [
                ptr, ptr, ptr, ptr, ptr, ptr, c_int, c_int, c_int, c_int, c_int,
                c_int, c_int, c_int, ptr,
            ]
            lib.its_paged_decode_attention_ragged.argtypes = [
                ptr, ptr, ptr, ptr, ptr, ptr, ptr, c_int, c_int, c_int, c_int, c_int,
                c_int, c_int, c_int, ptr,
            ]
            lib.its_flash_prefill.argtypes = [
                ptr, ptr, ptr, ptr, c_int, c_int, c_int, c_int, c_int, c_int, c_int,
                c_int, ptr,
            ]
            for fn in (lib.its_gather_blocks, lib.its_scatter_blocks,
                       lib.its_paged_decode_attention,
                       lib.its_paged_decode_attention_ragged, lib.its_flash_prefill):
                fn.restype = c_int
            _lib = lib
    return _lib


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of the current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(code: int, name: str) -> None:
    """Raise when a kernel entry reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


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
