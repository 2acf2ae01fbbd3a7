#!/usr/bin/env python3
"""Probe of the paged decode kernels K3 and K5-K8 on one CUDA card. Run
from the root of a checkout (the package's entry points do not import it):

    python3 infinistore_tpu_torch/cuda/decode_probe.py host [--root DIR]
    python3 infinistore_tpu_torch/cuda/decode_probe.py splits
    python3 infinistore_tpu_torch/cuda/decode_probe.py k8 [--root DIR]
    python3 infinistore_tpu_torch/cuda/decode_probe.py k5 [--root DIR]
    python3 infinistore_tpu_torch/cuda/decode_probe.py k7 [--root DIR]

``host``: the wrappers' host time per call of K3 and K6 at the shapes their
paths give them (``timing.host_us``: the card is kept busy by a spin, so
only the host's work is timed), for the package of the checkout at
``--root`` (default: this one). Two checkouts run in turn on one card
compare the wrappers of two trees. For this checkout it also
times the pieces of K3's wrapper one by one (``parts_us``).

``splits``: the decode fold's split policy. Builds ``paged_attention.cu``
and ``paged_attention_ragged.cu`` (K3 and K6) twice into ``_build/probe``:
as it is (``adaptive``: a row of n pages in about 8 splits of 4 to 16 pages)
and with every split 16 pages (``fixed16``: ``kMinSplitPages = 16``). Each
library is held against the plain version at every shape, then both are
timed through the wrappers (``timing.Timer``) in the order adaptive,
fixed16, fixed16, adaptive.

``k8``: K8 at the int8 round trip's wave (4 rows of 2,048 tokens, bf16 and
f32 q). ``k5``: K5 at the sharded decode's 32,768-token request (bf16), and
K3 on the same inputs. Each times, through the wrappers (``timing.Timer``,
in order and back again), the package's library (``this``), the same
sources built with ``-DITS_DECODE_NOMERGE`` into ``_build/probe/nomerge``
(each split writes its partial and exits: the fold's time without the
cross-split merge) and, with ``--root`` (another checkout, e.g. the parent
unpacked by ``git archive``), that tree's sources as they are (``root``).
``this`` and ``root`` are first held against the plain version (K8: 1e-5
f32, 2e-2 bf16; K5: its one-shard combine bitwise K3). Beside the times: an
empty launch (the launch floor under the same timer), the bound, the CTAs of
the launch, the CTAs an SM holds of this tree's kernel
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, from a small library of
its own) and hence the waves. ``k5 --root`` also holds this tree's K3 and
K6 bitwise against the root's at every shape of 16 splits or fewer below
(the round trip, ``prefill_continue``, the skewed wave, the engine's wave)
and times both there.

``k7``: K7 at ``chip_smoke.py``'s skewed wave and at its first
quarter-shard (what one of 4 ranks folds), bf16, held against its plain
statistics and its one-shard combine bitwise K6, then timed through the
wrappers as built (``this``), built with ``-DITS_DECODE_NOMERGE`` (no split
merge) and with ``-DITS_DECODE_PROLOGUE`` (each CTA stops after its row's
metadata, its page ids and q), and with ``--root`` the root's, beside an
empty launch: the chain split into launch, prologue, stages and merge, with
the CTAs launched and folding and the CTAs an SM holds. With ``--root``,
every decode kernel at every path shape above and below, and K4 (bf16, on
the tensor cores) at the round trip's prefill, are then held bitwise
between this tree and the root and timed through both.

Shapes (bf16, Llama-3-8B widths, 16-token blocks): K3 at the round trip's
decode step (4 rows of 2,048 tokens), at ``prefill_continue`` (256 rows at
contexts 769-1,024 over one 72-block table) and at the sharded decode's
32,768-token request; K6 on ``chip_smoke.py``'s skewed wave
(``skewed_wave``) and at the engine's wave (4 x 8-token chunks at 1,024
tokens); ``k7`` adds K5 at 32,768 tokens, K7 at the skewed wave and its
quarter-shard, K8 at the int8 wave and K4 at one 2,048-token prompt
(32 heads over 8, bf16, causal) (``_path_cases``). Prints one JSON
line per measurement.
"""

import argparse
import contextlib
import ctypes
import importlib.util
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(os.path.dirname(HERE))
PROBE_DIR = os.path.join(HERE, os.pardir, "_build", "probe")
BT, H, KVH, D = 16, 32, 8, 128
SHARDED_CONTEXT = 32768  # tokens of the sharded decode's one request
NOMERGE = "-DITS_DECODE_NOMERGE"
# Every probe build instantiates the decode kernels at the head_dim its
# shapes use alone (decode_fold.cuh: by_head_dim): an eighth of the compile.
ONE_HEAD_DIM = f"-DITS_DECODE_HEAD_DIM={D}"
K4_SOURCES = ("flash_prefill.cu", "flash_prefill_wgmma.cu")
# The sources of K3, K6, K5 and K7 (an older tree has only the first and
# the third, which hold all four entries).
DECODE_SOURCES = ("paged_attention.cu", "paged_attention_ragged.cu", "paged_attention_stats.cu",
                  "paged_attention_ragged_stats.cu")


def _timing():
    """This checkout's ``timing`` module, loaded by path (the package on
    ``sys.path`` may be a ``--root`` checkout's, which may have none)."""
    spec = importlib.util.spec_from_file_location("_probe_timing",
                                                  os.path.join(HERE, "timing.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def skewed_wave(width: int = 72):
    """``chip_smoke.py``'s skewed ragged wave at the engine's widths
    (``width``-page request tables): (per-row lens, per-row tables, table
    width, cache blocks). Rows 3-6 are one request's 4-token verification
    chunk (shared pages)."""
    import numpy as np

    lens = [1, 1152, 0, 300, 301, 302, 303, 700, 64, 17, 1000]
    req_of = [0, 1, 2, 3, 3, 3, 3, 4, 5, 6, 7]
    n_cache = 8 * width + 16
    rng = np.random.default_rng(5)
    req_tables = rng.permutation(n_cache)[: 8 * width].astype(np.int32).reshape(8, width)
    return lens, [req_tables[i] for i in req_of], width, n_cache


def _shapes(torch, np, pa):
    """name -> (call of the kernel's wrapper, call of its plain version)."""
    g = torch.Generator(device="cuda").manual_seed(7)

    def rn(shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    def table_case(rows, lens, width, shared):
        n = (width if shared else rows * width) + 16
        perm = torch.randperm(n, generator=g, device="cuda").to(torch.int32)
        tables = (perm[:width][None].expand(rows, width).contiguous() if shared
                  else perm[: rows * width].reshape(rows, width))
        lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
        args = (rn((rows, H, D)), rn((n, BT, KVH, D)), rn((n, BT, KVH, D)), tables, lens)
        return (lambda: pa.paged_decode_attention_batched(*args),
                lambda: pa.paged_decode_attention_plain_batched(*args))

    def ragged_case(lens, row_tables, width, n):
        m = pa.build_ragged_wave(row_tables, lens, BT, pad_to_pow2=True)
        meta = [torch.from_numpy(x).cuda() for x in (m.pages, m.page_rows, m.page_starts,
                                                       m.seq_lens)]
        q, k, v = rn((len(lens), H, D)), rn((n, BT, KVH, D)), rn((n, BT, KVH, D))
        return (lambda: pa.paged_decode_attention_ragged(q, k, v, *meta, table_width=width),
                lambda: pa.paged_decode_attention_ragged_plain(q, k, v, meta[0], meta[2],
                                                               meta[3], width))

    cases = {
        "k3_round_trip": table_case(4, [2048] * 4, 128, False),
        "k3_prefill_continue": table_case(256, list(range(769, 1025)), 72, True),
        "k3_32k": table_case(1, [32768], 2048, False),
    }
    lens, row_tables, width, n = skewed_wave()
    cases["k6_skewed"] = ragged_case(lens, row_tables, width, n)
    req = np.random.default_rng(6).permutation(4 * 72 + 16)[: 4 * 72].astype(np.int32)
    req = req.reshape(4, 72)
    cases["k6_engine_wave"] = ragged_case([1024 + j for _ in range(4) for j in range(8)],
                                          [req[r // 8] for r in range(32)], 72, 4 * 72 + 16)
    return cases


def host(args):
    sys.path.insert(0, os.path.abspath(args.root or CHECKOUT))
    tm = _timing()
    import numpy as np
    import torch

    from infinistore_tpu_torch.cuda import paged_attention as pa

    for name, (run, _) in _shapes(torch, np, pa).items():
        print(json.dumps({"root": args.root or ".", "package": os.path.dirname(pa.__file__),
                          "shape": name, "host_us": tm.host_us(torch, run, calls=200)}),
              flush=True)
    if not args.root:
        print(json.dumps({"parts_us": _host_parts(torch, tm)}), flush=True)
    return 0


def _host_parts(torch, tm):
    """Host µs per call of the pieces of K3's wrapper at ``prefill_continue``'s
    shape (256 rows, 72-block tables), each timed alone as ``host``
    times a whole call; ``torch.empty`` of the scratch is what a launch
    would cost to allocate it anew."""
    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.cuda import paged_attention as pa

    rows, width, n = 256, 72, 72 + 16
    q = torch.randn((rows, H, D), device="cuda").to(torch.bfloat16)
    k = torch.randn((n, BT, KVH, D), device="cuda").to(torch.bfloat16)
    v = torch.randn_like(k)
    tables = torch.zeros((rows, width), dtype=torch.int32, device="cuda")
    lens = torch.full((rows,), 1024, dtype=torch.int32, device="cuda")
    stream = _ext.stream_of(q)
    splits = _ext.decode_splits(width)
    floats = rows * splits * H * (D + 2)
    scratch, tickets, _ = pa._split_scratch(q, width, stream)
    out = torch.empty_like(q)
    lib = _ext.kernels()
    parts = {
        "whole_wrapper": lambda: pa.paged_decode_attention_batched(q, k, v, tables, lens),
        "require_cuda": lambda: _ext.require_cuda("k3", q.device, q=q, k=k, v=v,
                                                  tables=tables, lens=lens),
        "checks": lambda: (pa._check_decode_args("k3", q, k, v),
                           pa._check_table_args("k3", q, tables, lens)),
        "require_aligned": lambda: _ext.require_aligned("k3", k=k, v=v),
        "stream_of": lambda: _ext.stream_of(q),
        "split_scratch": lambda: pa._split_scratch(q, width, stream),
        "torch_empty_scratch": lambda: torch.empty(floats, dtype=torch.float32, device="cuda"),
        "empty_like_out": lambda: torch.empty_like(q),
        "entry_call": lambda: lib.its_paged_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), tables.data_ptr(), lens.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), tickets.data_ptr(), 1, rows, H, KVH, D, BT, n,
            width, splits, stream),
    }
    return {name: tm.host_us(torch, fn, calls=200) for name, fn in parts.items()}


VARIANTS = {"adaptive": {}, "fixed16": {"kMinSplitPages = 4;": "kMinSplitPages = 16;"}}


def _build_variant(nvcc, name, patches):
    out = os.path.join(PROBE_DIR, name)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, "csrc"), out)
    fold = os.path.join(out, "decode_fold.cuh")
    with open(fold) as f:
        src = f.read()
    for old, new in patches.items():
        if old not in src:
            raise RuntimeError(f"variant {name}: {old!r} not in decode_fold.cuh")
        src = src.replace(old, new)
    with open(fold, "w") as f:
        f.write(src)
    lib = os.path.join(out, "lib.so")
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-Xcompiler", "-fPIC", ONE_HEAD_DIM, "-shared",
           *(os.path.join(out, src) for src in ("paged_attention.cu", "paged_attention_ragged.cu")),
           "-o", lib]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def splits(args):
    sys.path.insert(0, CHECKOUT)
    tm = _timing()
    import numpy as np
    import torch

    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.cuda import paged_attention as pa

    nvcc = _ext._nvcc()
    builds = {name: _build_variant(nvcc, name, p) for name, p in VARIANTS.items()}
    libs = {}
    for name, (path, proc) in builds.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} did not build:\n{out.decode()[-4000:]}")
        lib = ctypes.CDLL(path)
        for entry, argtypes in _ext.ARGTYPES.items():
            if hasattr(lib, entry):
                getattr(lib, entry).argtypes = argtypes
                getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib

    def use(name):
        _ext._lib = libs[name]
        _ext._SPLITS.clear()

    cases = _shapes(torch, np, pa)
    for name in libs:
        use(name)
        for shape, (run, plain) in cases.items():
            err = tm.max_err(run(), plain())
            if not err <= 2e-2:
                raise AssertionError(f"variant {name} at {shape}: max abs err {err}")
    timer = tm.Timer(torch)
    times = {name: {shape: [] for shape in cases} for name in libs}
    for name in ("adaptive", "fixed16", "fixed16", "adaptive"):
        use(name)
        for shape, (run, _) in cases.items():
            times[name][shape].append(timer.ms(run))
    for name, by_shape in times.items():
        print(json.dumps({"variant": name, "ms": by_shape}), flush=True)
    return 0



# ---------------------------------------------------------------------------
# k8 and k5: the redesigned kernels against a root tree, fold against merge.
# ---------------------------------------------------------------------------

# CTAs an SM holds of K5's, K7's and K8's bf16 D = 128, G = 4 kernels.
OCCUPANCY_SRC = r"""
#include "kv_quant.cu"
template <typename K>
static int occupancy(K kernel, int smem, int* blocks) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kThreads, smem));
}
extern "C" int probe_occupancy(int which, int* blocks) {
  using T = __nv_bfloat16;
  if (which == 5)
    return occupancy(paged_decode<T, 128, 4, FloatKV<T>, RawStats>,
                     Smem<128, 4, FloatKV<T>>::kBytes, blocks);
  if (which == 7)
    return occupancy(paged_decode_ragged<T, 128, 4, FloatKV<T>, RawStats>,
                     Smem<128, 4, FloatKV<T>>::kBytes, blocks);
  return occupancy(quant_decode<T, 128, 4>, Q8Fold<128, 4>::kBytes, blocks);
}
"""


def build(name, sources, csrc=None, defines=()):
    """Starts ``nvcc`` on ``sources`` (files of ``csrc``, default this
    tree's; those the tree does not have are skipped) with ``defines`` and
    ``ONE_HEAD_DIM`` (which a tree without it ignores) into
    ``_build/probe/name/lib.so``, all started together. Returns a pending
    build for ``load``."""
    from infinistore_tpu_torch.cuda import _ext

    out = os.path.abspath(os.path.join(PROBE_DIR, name))
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    csrc = csrc or os.path.join(HERE, "csrc")
    objs, procs = [], []
    for src in (s for s in sources if os.path.exists(os.path.join(csrc, s))):
        obj = os.path.join(out, os.path.splitext(os.path.basename(src))[0] + ".o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [_ext._nvcc(), *_ext.ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", *defines,
             ONE_HEAD_DIM,
             "-I", csrc, "-c", os.path.join(csrc, src), "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    return name, out, objs, procs


def load(pending):
    """The library of a ``build``: links its objects, binds every entry it
    has with ``_ext.ARGTYPES``; raises with the compiler's output when a
    source did not build."""
    from infinistore_tpu_torch.cuda import _ext

    name, out, objs, procs = pending
    for proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name} did not build:\n{log.decode()[-4000:]}")
    path = os.path.join(out, "lib.so")
    link = subprocess.run([_ext._nvcc(), *_ext.ARCH, "-shared", *objs, "-o", path],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if link.returncode:
        raise RuntimeError(f"{name} did not link:\n{link.stdout.decode()[-4000:]}")
    lib = ctypes.CDLL(path)
    for entry, argtypes in _ext.ARGTYPES.items():
        if hasattr(lib, entry):
            getattr(lib, entry).argtypes = argtypes
            getattr(lib, entry).restype = ctypes.c_int
    return lib


class _OldK4Entry:
    """A library whose bf16 K4 entry predates its merge workspace (q, k, v,
    out, B, S, T, H, KVH, D, causal, stream), called with this tree's
    arguments: the workspace's three are dropped."""

    def __init__(self, lib):
        self._lib = lib
        self._k4 = lib.its_flash_prefill_wgmma
        self._k4.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]

    def its_flash_prefill_wgmma(self, q, k, v, out, _scratch, _tickets, *rest):
        return self._k4(q, k, v, out, *rest[:-2], rest[-1])

    def __getattr__(self, name):
        return getattr(self._lib, name)


def _old_k4_entry(csrc):
    """True when the tree at ``csrc`` has a bf16 K4 entry without the merge
    workspace."""
    path = os.path.join(csrc, "flash_prefill_wgmma.cu")
    return os.path.exists(path) and "int slots," not in open(path).read()


def _libs(args, sources, extra=(), root_extra=()):
    """name -> library: ``this`` (the package's), ``nomerge``, each (name,
    -D flags) of ``extra`` and, with ``--root``, ``root`` (``sources``,
    ``DECODE_SOURCES``, whose ``paged_attention.cu`` answers the wrappers'
    split count, and ``root_extra``), built at once; and this tree's
    occupancy query."""
    from infinistore_tpu_torch.cuda import _ext

    sources = tuple(dict.fromkeys(DECODE_SOURCES + sources))
    occ = os.path.abspath(os.path.join(PROBE_DIR, "occupancy.cu"))
    os.makedirs(os.path.dirname(occ), exist_ok=True)
    with open(occ, "w") as f:
        f.write(OCCUPANCY_SRC)
    pending = {"nomerge": build("nomerge", sources, defines=(NOMERGE,)),
               "occupancy": build("occupancy", (occ,))}
    root_csrc = os.path.join(os.path.abspath(args.root or "."), "infinistore_tpu_torch", "cuda",
                             "csrc")
    if args.root:
        pending["root"] = build("root", sources + tuple(root_extra), csrc=root_csrc)
    for name, defines in extra:
        pending[name] = build(name, sources, defines=defines)
    libs = {"this": _ext.kernels()}
    libs.update((name, load(p)) for name, p in pending.items())
    if args.root and "flash_prefill_wgmma.cu" in root_extra and _old_k4_entry(root_csrc):
        libs["root"] = _OldK4Entry(libs["root"])
    return libs


@contextlib.contextmanager
def using(lib):
    """The wrappers call ``lib`` inside the block (the probe's own device
    for timing other builds through the same wrappers)."""
    from infinistore_tpu_torch.cuda import _ext

    saved = _ext.kernels()
    _ext._lib = lib
    _ext._SPLITS.clear()
    try:
        yield
    finally:
        _ext._lib = saved
        _ext._SPLITS.clear()


def _time_libs(tm, torch, libs, cases, order):
    """ms of each case through each library, in ``order`` and back again:
    {lib: {case: [ms, ...]}}."""
    timer = tm.Timer(torch)
    times = {name: {case: [] for case in cases} for name in order}
    for name in list(order) + list(reversed(order)):
        with using(libs[name]):
            for case, run in cases.items():
                times[name][case].append(timer.ms(run))
    return times


def _occupancy(libs, which):
    """CTAs an SM holds of this tree's kernel ``which`` (5, 7 or 8)."""
    blocks = ctypes.c_int(0)
    code = libs["occupancy"].probe_occupancy(which, ctypes.byref(blocks))
    if code:
        raise RuntimeError(f"occupancy query failed with {code}")
    return blocks.value


def _report(torch, tm, kernel, libs, times, ctas, which, nbytes, flops):
    floor = tm.Timer(torch).ms(lambda: torch.cuda._sleep(0))  # an empty launch
    bms, by = tm.bound_ms(nbytes, flops, "bfloat16")
    occ = _occupancy(libs, which)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, ms in times.items():
        print(json.dumps({"kernel": kernel, "lib": name, "ms": ms, "ctas": ctas,
                          "ctas_per_sm": occ if name != "root" else None,
                          "waves": ctas / (occ * sms) if name != "root" else None,
                          "launch_floor_ms": floor, "bound_ms": bms, "bound_by": by}),
              flush=True)


def _k8_inputs(torch, kq, g):
    """K8 at the int8 round trip's wave (4 rows of 2,048 tokens): q in bf16
    and f32 -> the wrapper's arguments, and the launch's table width."""
    rows, tokens = 4, 2048
    width = tokens // BT
    n = rows * width + 16
    kd, ks = kq.quantize_kv(torch.randn((n, BT, KVH, D), generator=g, device="cuda"))
    vd, vs = kq.quantize_kv(torch.randn((n, BT, KVH, D), generator=g, device="cuda"))
    tables = torch.randperm(n, generator=g, device="cuda")[: rows * width].to(torch.int32)
    tables = tables.reshape(rows, width)
    lens = torch.full((rows,), tokens, dtype=torch.int32, device="cuda")
    return {str(dtype).removeprefix("torch."): (
        torch.randn((rows, H, D), generator=g, device="cuda").to(dtype), kd, ks, vd, vs, tables,
        lens) for dtype in (torch.bfloat16, torch.float32)}, width


def k8(args):
    sys.path.insert(0, CHECKOUT)
    tm = _timing()
    import torch

    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.cuda import kv_quant as kq

    libs = _libs(args, ("kv_quant.cu",))
    inputs, width = _k8_inputs(torch, kq, torch.Generator(device="cuda").manual_seed(8))
    cases = {}
    for name, a8 in inputs.items():
        tol = 2e-2 if name == "bfloat16" else 1e-5
        want = kq._quant_decode_plain(*a8)
        for lib in ("this", "root"):
            if lib in libs:
                with using(libs[lib]):
                    err = tm.max_err(kq.paged_decode_attention_quantized(*a8), want)
                if not err <= tol:
                    raise AssertionError(f"K8 {lib} {name}: max abs err {err} (tol {tol})")
        cases[name] = lambda a=a8: kq.paged_decode_attention_quantized(*a)
    order = (["root"] if args.root else []) + ["this", "nomerge"]
    times = _time_libs(tm, torch, libs, cases, order)
    q, _, _, _, _, tables, lens = inputs["bfloat16"]
    rows, tokens = q.shape[0], int(lens[0])
    nbytes = 2 * rows * tokens * KVH * (D + 4) + 2 * rows * H * D * 2 + tables.numel() * 4 + 16
    _report(torch, tm, "K8", libs, times, _ext.decode_splits(width) * KVH * rows, 8, nbytes,
            4.0 * H * D * rows * tokens)
    return 0


def _k5_inputs(torch, g):
    """K5 (and K3) at the sharded decode's one request of SHARDED_CONTEXT
    tokens, bf16: the wrappers' arguments."""
    n = SHARDED_CONTEXT // BT
    q = torch.randn((1, H, D), generator=g, device="cuda").to(torch.bfloat16)
    kc = torch.randn((n, BT, KVH, D), generator=g, device="cuda").to(torch.bfloat16)
    vc = torch.randn((n, BT, KVH, D), generator=g, device="cuda").to(torch.bfloat16)
    table = torch.randperm(n, generator=g, device="cuda").to(torch.int32)[None]
    lens = torch.tensor([SHARDED_CONTEXT], dtype=torch.int32, device="cuda")
    return q, kc, vc, table, lens


def k5(args):
    sys.path.insert(0, CHECKOUT)
    tm = _timing()
    import numpy as np
    import torch

    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.cuda import paged_attention as pa

    libs = _libs(args, ("paged_attention_stats.cu",))
    a5 = _k5_inputs(torch, torch.Generator(device="cuda").manual_seed(5))
    q, tokens, n = a5[0], SHARDED_CONTEXT, SHARDED_CONTEXT // BT
    ident = lambda t: t  # noqa: E731
    for name in ("this", "root"):
        if name in libs:
            with using(libs[name]):
                combined = pa.combine_stats(*pa._decode_attention_stats(*a5), q.dtype, ident,
                                            ident)
                k3 = pa.paged_decode_attention_batched(*a5)
                torch.cuda.synchronize()
            if not torch.equal(combined, k3):
                raise AssertionError(f"K5 {name} at {tokens} tokens: its one-shard combine "
                                     "is not K3")
    cases = {"k5_32k": lambda: pa._decode_attention_stats(*a5),
             "k3_32k": lambda: pa.paged_decode_attention_batched(*a5)}
    order = (["root"] if args.root else []) + ["this", "nomerge"]
    times = _time_libs(tm, torch, libs, cases, order)
    nbytes = 2 * tokens * KVH * D * 2 + q.numel() * 2 + (H * D + 2 * H) * 4 + n * 4 + 4
    _report(torch, tm, "K5", libs, times, _ext.decode_splits(n) * KVH, 5, nbytes,
            4.0 * H * D * tokens)
    if not args.root:
        return 0
    # K3 and K6 at the paths' shapes of 16 splits or fewer: bitwise the root's.
    short = {k: v for k, v in _shapes(torch, np, pa).items() if k != "k3_32k"}
    for shape, (run, _) in short.items():
        with using(libs["root"]):
            want = run()
        with using(libs["this"]):
            got = run()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{shape}: this tree's output is not bitwise the root's")
    times = _time_libs(tm, torch, libs, {s: run for s, (run, _) in short.items()},
                       ["root", "this"])
    print(json.dumps({"bitwise_root": sorted(short), "ms": times}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# k7: K7's chain (launch, prologue, stages, merge), and every decode kernel
# at every path shape against a root tree.
# ---------------------------------------------------------------------------

PROLOGUE = "-DITS_DECODE_PROLOGUE"


def _row_splits(npages):
    """Splits of a row of ``npages`` pages (decode_fold.cuh: split_pages)."""
    per = min(max(-(-npages // 8), 4), 16)
    return max(1, -(-npages // per))


def _k7_inputs(torch, pa, g, quarter):
    """K7 at the skewed wave (bf16, 72-page tables, its flat list padded to a
    power of two, as ``chip_smoke.py``'s kernel phase runs it), or at its
    first quarter-shard (each row's first 18 table entries, what rank 0 of 4
    holds, as ``build_ragged_wave_sharded`` lays it out). Returns (the
    wrapper's arguments, bound (ms, by), CTAs that fold)."""
    tm = _timing()
    lens, row_tables, width, n = skewed_wave()
    if quarter:
        width //= 4
        row_tables = [t[:width] for t in row_tables]
        lens = [min(x, width * BT) for x in lens]
        pages, rows, starts, seq, width = pa.build_ragged_wave_sharded([row_tables], [lens],
                                                                       BT)
        pages, rows, starts, seq = pages[0], rows[0], starts[0], seq[0]
    else:
        m = pa.build_ragged_wave(row_tables, lens, BT, pad_to_pow2=True)
        pages, rows, starts, seq = m.pages, m.page_rows, m.page_starts, m.seq_lens
    meta = [torch.from_numpy(x).cuda() for x in (pages, rows, starts, seq)]
    q = torch.randn((len(lens), H, D), generator=g, device="cuda").to(torch.bfloat16)
    kc = torch.randn((n, BT, KVH, D), generator=g, device="cuda").to(torch.bfloat16)
    vc = torch.randn((n, BT, KVH, D), generator=g, device="cuda").to(torch.bfloat16)
    used = [-(-x // BT) for x in lens]
    distinct = {int(pages[starts[r] + j]) for r, u in enumerate(used) for j in range(u)}
    # K and V of each distinct page, q, the f32 outputs, the page metadata.
    nbytes = 2 * len(distinct) * BT * KVH * D * 2 + q.numel() * 2 + \
        (q.numel() + 2 * len(lens) * H) * 4 + (pages.shape[0] + 3 * len(lens) + 1) * 4
    bound = tm.bound_ms(nbytes, 4.0 * H * D * sum(lens), "bfloat16")
    return (q, kc, vc, *meta, int(width)), bound, sum(_row_splits(u) for u in used) * KVH


def _path_cases(torch, np, pa, kq):
    """Every decode kernel at every path shape this probe knows, as calls of
    the wrappers: K3 and K6 (``_shapes``), K5 at 32,768 tokens, K7 at the
    skewed wave and its quarter-shard, K8 at the int8 wave in both q
    dtypes; and K4 (bf16) at the round trip's 2,048-token prompt."""
    from infinistore_tpu_torch.cuda import flash_prefill as fp

    cases = {name: run for name, (run, _) in _shapes(torch, np, pa).items()}
    g = torch.Generator(device="cuda").manual_seed(77)
    a5 = _k5_inputs(torch, g)
    cases["k5_32k"] = lambda: pa._decode_attention_stats(*a5)
    for name, quarter in (("k7_skewed", False), ("k7_quarter", True)):
        a7 = _k7_inputs(torch, pa, g, quarter)[0]
        cases[name] = lambda a=a7: pa._decode_attention_stats_ragged(*a)
    for name, a8 in _k8_inputs(torch, kq, g)[0].items():
        cases[f"k8_{name}"] = lambda a=a8: kq.paged_decode_attention_quantized(*a)
    qkv = [torch.randn((1, 2048, heads, D), generator=g, device="cuda").to(torch.bfloat16)
           for heads in (H, KVH, KVH)]
    cases["k4_round_trip"] = lambda: fp.flash_prefill_attention(*qkv, causal=True)
    return cases


def _bitwise(torch, libs, cases, name, against):
    """The cases whose output through library ``name`` is not bitwise the
    one through ``against``."""
    differ = []
    for shape, run in cases.items():
        with using(libs[against]):
            want = run()
        with using(libs[name]):
            got = run()
        torch.cuda.synchronize()
        want, got = (x if isinstance(x, tuple) else (x,) for x in (want, got))
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            differ.append(shape)
    return differ


def k7(args):
    sys.path.insert(0, CHECKOUT)
    tm = _timing()
    import numpy as np
    import torch

    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.cuda import kv_quant as kq
    from infinistore_tpu_torch.cuda import paged_attention as pa

    libs = _libs(args, ("paged_attention_stats.cu", "kv_quant.cu"),
                 extra=(("prologue", (PROLOGUE,)),), root_extra=K4_SOURCES)
    g = torch.Generator(device="cuda").manual_seed(7)
    shapes = {name: _k7_inputs(torch, pa, g, quarter)
              for name, quarter in (("k7_skewed", False), ("k7_quarter", True))}
    ident = lambda t: t  # noqa: E731
    for name in ("this", "root"):
        if name not in libs:
            continue
        with using(libs[name]):
            for shape, (a7, _, _) in shapes.items():
                q, kc, vc, pages, rows, starts, seq, width = a7
                stats = pa._decode_attention_stats_ragged(*a7)
                plain = pa.decode_attention_stats_ragged_plain(q, kc, vc, pages, starts, seq,
                                                               width)
                k6 = pa.paged_decode_attention_ragged(q, kc, vc, pages, rows, starts, seq,
                                                      table_width=width)
                torch.cuda.synchronize()
                err = tm.max_err(stats[0] / torch.clamp(stats[2], min=1e-30),
                                 plain[0] / torch.clamp(plain[2], min=1e-30))
                if not err <= 2e-2 or not torch.equal(
                        pa.combine_stats(*stats, q.dtype, ident, ident), k6):
                    raise AssertionError(f"K7 {name} at {shape}: err {err} (tol 2e-2), or its "
                                         "one-shard combine is not K6")
    cases = {shape: (lambda a=a7: pa._decode_attention_stats_ragged(*a))
             for shape, (a7, _, _) in shapes.items()}
    order = (["root"] if args.root else []) + ["this", "nomerge", "prologue"]
    times = _time_libs(tm, torch, libs, cases, order)
    floor = tm.Timer(torch).ms(lambda: torch.cuda._sleep(0))  # an empty launch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_sm = _occupancy(libs, 7)
    for shape, (a7, (bms, by), folding) in shapes.items():
        splits = _ext.decode_splits(a7[-1])
        med = {name: sorted(ms[shape])[len(ms[shape]) // 2] for name, ms in times.items()}
        print(json.dumps({
            "kernel": "K7", "shape": shape, "ms": {n: ms[shape] for n, ms in times.items()},
            "launch_floor_ms": floor, "bound_ms": bms, "bound_by": by, "splits": splits,
            "ctas": splits * KVH * a7[0].shape[0], "ctas_folding": folding,
            "ctas_per_sm": per_sm, "waves": splits * KVH * a7[0].shape[0] / (per_sm * sms),
            "chain_ms": {"launch": floor, "prologue": med["prologue"] - floor,
                         "stages": med["nomerge"] - med["prologue"],
                         "merge": med["this"] - med["nomerge"]}}), flush=True)
    if not args.root:
        return 0
    # Every decode kernel at every path shape: this tree bitwise the root's,
    # and both timed.
    paths = _path_cases(torch, np, pa, kq)
    differ = _bitwise(torch, libs, paths, "this", "root")
    if differ:
        raise AssertionError(f"this tree is not bitwise the root at {differ}")
    times = _time_libs(tm, torch, libs, paths, ["root", "this"])
    print(json.dumps({"bitwise_root": sorted(paths), "ms": times}), flush=True)
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    h = sub.add_parser("host", help="wrapper host time per call")
    h.add_argument("--root", default="", help="checkout whose package is timed")
    sub.add_parser("splits", help="the split policy, as is against fixed 16-page splits")
    for mode, what in (("k8", "K8 at the int8 wave"), ("k5", "K5 at 32,768 tokens"),
                       ("k7", "K7 at the skewed wave and its quarter-shard")):
        m = sub.add_parser(mode, help=f"{what}: fold and merge, and a root tree's")
        m.add_argument("--root", default="", help="checkout whose kernels are timed beside")
    args = ap.parse_args()
    # Run as a script, this directory heads sys.path: its modules are the
    # package's, imported through the package only.
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    import torch

    if not torch.cuda.is_available():
        print("decode_probe: needs a CUDA card", file=sys.stderr)
        return 1
    return {"host": host, "splits": splits, "k8": k8, "k5": k5, "k7": k7}[args.mode](args)


if __name__ == "__main__":
    sys.exit(main())
