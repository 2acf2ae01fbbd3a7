#!/usr/bin/env python3
"""Probe of the paged block copies K1 (gather) and K2 (scatter) on one CUDA
card. Run from the root of a checkout (the package does not import it):

    python3 infinistore_tpu_torch/cuda/copy_probe.py device [--root DIR]
    python3 infinistore_tpu_torch/cuda/copy_probe.py host [--root DIR]
    python3 infinistore_tpu_torch/cuda/copy_probe.py tune

``device``: what a launch costs apart from its bytes. K1 on one bf16 cache
of 4,096 32 KiB blocks (Llama-3-8B widths) at n = 1, 8, 32, 128, 512 and
2,048 blocks, fitted as time = a + b x bytes (least squares; a is the
per-launch part), beside a contiguous ``dst.copy_(src)`` of the same bytes
(the card's own copy) and an empty launch (a 0-cycle ``torch.cuda._sleep``),
all under ``timing.Timer``. With ``--root`` (a checkout of another tree,
e.g. the parent unpacked by ``git archive``) that tree's
``paged_copy.cu`` is built into ``_build/probe/root`` and its single-cache
entries are timed too: at the same n (and fitted), and at ``chip_smoke.py``'s
shapes (the table's 128 blocks, the writer's and reader's layer, the
engine's snapshot, the install span) as the sequence its paths ran there
(``chip_smoke.copy_calls`` without batched entries), in the order root,
this, this, root, beside this tree's batched call and its unfused sequence.

``host``: the K1/K2 wrappers' host time per call (``timing.host_us``:
the card is kept busy by a spin, so only the host's work is timed) at the
same shapes, for the package of the checkout at ``--root`` (default: this
one), through its batched entries where it has them. Two checkouts run in
turn on one card compare the wrappers of two trees.

``tune``: the bulk ring's chunk size and stage count. Builds
``paged_copy.cu`` once for each setting of ``TUNE`` into
``_build/probe/tune``, holds each against the plain versions at every shape
(bitwise), then times each at the shapes through the wrappers, in order and
back again. Prints one JSON line per measurement.
"""

import argparse
import ctypes
import functools
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(os.path.dirname(HERE))
PROBE_DIR = os.path.join(HERE, os.pardir, "_build", "probe")
BLOCK = (16, 8, 128)  # block_tokens, KV heads, head_dim of Llama-3-8B
FIT_BLOCKS = (1, 8, 32, 128, 512, 2048)


def _setting(kib, stages):
    return {r"kChunkBytes = \d+ << 10;": f"kChunkBytes = {kib} << 10;",
            r"kStages = \d+;": f"kStages = {stages};"}


# What ``tune`` builds, name -> {pattern in paged_copy.cu: replacement}: the
# bulk ring's chunk size and stage count (4 KiB x 2: a ring of 8 KiB of
# shared memory), and, at the source's own setting, three parts of a
# launch's fixed cost: each CTA waits at exit only until its stores have
# read shared memory; no proxy fence before each store; the barriers'
# initialisation fenced for the CTA's async proxy alone, not the cluster.
TUNE = {f"chunk{kib}k_stages{stages}": _setting(kib, stages)
        for kib, stages in ((4, 2), (8, 4), (8, 8), (16, 2), (16, 4), (16, 6), (32, 2), (32, 3),
                            (32, 6))}
TUNE["exit_on_read"] = {re.escape('"cp.async.bulk.wait_group 0;'):
                        '"cp.async.bulk.wait_group.read 0;'}
TUNE["no_proxy_fence"] = {
    re.escape('asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");'): ""}
TUNE["cta_init_fence"] = {re.escape('"fence.mbarrier_init.release.cluster;'):
                          '"fence.proxy.async.shared::cta;'}
# The entries of paged_copy.cu before the batched ones: cache, ids, out or
# blocks, n, num_blocks, block_bytes, stream.
SINGLE_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [ctypes.c_void_p]


def _chip_smoke():
    """This checkout's ``chip_smoke.py``, loaded by path (a ``--root``
    checkout may hold another)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(CHECKOUT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def _timing():
    """This checkout's ``timing`` module, loaded by path (the package on
    ``sys.path`` may be a ``--root`` checkout's, which may have none)."""
    spec = importlib.util.spec_from_file_location("_probe_timing",
                                                  os.path.join(HERE, "timing.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _nvcc(nvcc, csrc, out_dir):
    """Starts ``nvcc`` on ``csrc``'s ``paged_copy.cu`` into ``out_dir``/lib.so."""
    lib = os.path.join(out_dir, "lib.so")
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-Xcompiler", "-fPIC", "-shared", os.path.join(csrc, "paged_copy.cu"), "-o", lib]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _load(path, proc, what, argtypes):
    out, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"{what} did not build:\n{out.decode()[-4000:]}")
    lib = ctypes.CDLL(path)
    for entry, types in argtypes.items():
        if hasattr(lib, entry):
            getattr(lib, entry).argtypes = types
            getattr(lib, entry).restype = ctypes.c_int
    return lib


def _root_singles(torch, root, nvcc):
    """Single-cache gather and scatter through ``root``'s own
    ``its_gather_blocks`` / ``its_scatter_blocks``, built from its sources."""
    out_dir = os.path.join(PROBE_DIR, "root")
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.copytree(os.path.join(root, "infinistore_tpu_torch", "cuda", "csrc"), out_dir)
    lib = _load(*_nvcc(nvcc, out_dir, out_dir), f"{root}'s paged_copy.cu",
                {"its_gather_blocks": SINGLE_ARGTYPES, "its_scatter_blocks": SINGLE_ARGTYPES})

    def block_bytes(cache):
        return cache[0].numel() * cache.element_size()

    def check(code):
        if code:
            raise RuntimeError(f"root kernel: CUDA error {code}")

    def gather(cache, ids):
        out = torch.empty((ids.shape[0], *cache.shape[1:]), dtype=cache.dtype,
                          device=cache.device)
        check(lib.its_gather_blocks(cache.data_ptr(), ids.data_ptr(), out.data_ptr(),
                                    ids.shape[0], cache.shape[0], block_bytes(cache),
                                    torch.cuda.current_stream().cuda_stream))
        return out

    def scatter(cache, ids, blocks):
        check(lib.its_scatter_blocks(cache.data_ptr(), ids.data_ptr(), blocks.data_ptr(),
                                     ids.shape[0], cache.shape[0], block_bytes(cache),
                                     torch.cuda.current_stream().cuda_stream))
        return cache

    return gather, scatter


def _fit(points):
    """Least-squares (a ms, b ms per byte) of time = a + b x bytes."""
    n = len(points)
    mx = sum(x for x, _ in points) / n
    my = sum(y for _, y in points) / n
    b = sum((x - mx) * (y - my) for x, y in points) / sum((x - mx) ** 2 for x, _ in points)
    return my - b * mx, b


def _emit(**row):
    print(json.dumps(row), flush=True)


def device(args):
    sys.path.insert(0, CHECKOUT)
    cs = _chip_smoke()
    import torch

    from infinistore_tpu_torch.cuda import _ext, paged

    _ext.kernels()
    timer = _timing().Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(17)
    root = _root_singles(torch, os.path.abspath(args.root), _ext._nvcc()) if args.root else None

    # The per-launch part: one cache, n blocks, beside the card's own copy.
    cache = torch.randn((4096, *BLOCK), generator=g, device="cuda").to(torch.bfloat16)
    block_bytes = cache[0].numel() * cache.element_size()
    series = {"this": [], "copy": []}
    if root:
        series["root"] = []
    # The same calls with the L2 left warm (a 1-byte flush): what of the
    # floor the dirty 1 GiB flush adds.
    warm = _timing().Timer(torch)
    warm.flush = torch.empty(1, dtype=torch.uint8, device="cuda")
    _emit(empty_launch_ms=timer.ms(lambda: torch.cuda._sleep(0)),
          empty_launch_warm_ms=warm.ms(lambda: torch.cuda._sleep(0)))
    for n in FIT_BLOCKS:
        ids = torch.randperm(4096, generator=g, device="cuda")[:n].to(torch.int32)
        src = cache[:n].clone()
        dst = torch.empty_like(src)
        nbytes = 2 * n * block_bytes
        row = {"blocks": n, "bytes": nbytes,
               "this": timer.ms(lambda: paged.gather_blocks(cache, ids)),
               "copy": timer.ms(lambda: dst.copy_(src))}
        if root:
            row["root"] = timer.ms(lambda: root[0](cache, ids))
        if n == 128:
            row["warm"] = {"this": warm.ms(lambda: paged.gather_blocks(cache, ids)),
                           "copy": warm.ms(lambda: dst.copy_(src))}
            if root:
                row["warm"]["root"] = warm.ms(lambda: root[0](cache, ids))
        for name in series:
            series[name].append((nbytes, row[name]))
        _emit(fit_point=row)
    for name, points in series.items():
        a, b = _fit(points)
        _emit(fit=name, a_ms=a, b_ms_per_MiB=b * (1 << 20), GBps=1e-6 / b)
    del cache

    # chip_smoke.py's shapes: the batched call and the unfused sequence of
    # this tree, and root's sequence.
    inp = cs.copy_inputs(torch, g, torch.bfloat16, BLOCK, 64)
    variants = {
        "this": cs.copy_calls(inp, paged.gather_blocks, paged.scatter_blocks,
                              paged.gather_blocks_many, paged.scatter_blocks_many),
        "this_unfused": cs.copy_calls(inp, paged.gather_blocks, paged.scatter_blocks),
    }
    if root:
        variants["root"] = cs.copy_calls(inp, *root)
    order = ["root", "this", "this_unfused", "this_unfused", "this", "root"]
    times = {name: {f"{k}/{s}": [] for k, s in calls} for name, calls in variants.items()}
    for name in (o for o in order if o in variants):
        for (kind, shape), fn in variants[name].items():
            count = cs.COPY_SHAPES.get(kind, {}).get(shape, (1, 0))[0]
            times[name][f"{kind}/{shape}"].append(timer.ms(fn, spin=count))
    for name, by_shape in times.items():
        _emit(variant=name, ms=by_shape)
    return 0


def host(args):
    root = os.path.abspath(args.root or CHECKOUT)
    sys.path.insert(0, root)
    cs = _chip_smoke()
    import torch

    from infinistore_tpu_torch.cuda import paged

    g = torch.Generator(device="cuda").manual_seed(17)
    inp = cs.copy_inputs(torch, g, torch.bfloat16, BLOCK, 64)
    calls = cs.copy_calls(inp, paged.gather_blocks, paged.scatter_blocks,
                          getattr(paged, "gather_blocks_many", None),
                          getattr(paged, "scatter_blocks_many", None))
    for (kind, shape), fn in calls.items():
        _emit(root=args.root or ".", package=os.path.dirname(paged.__file__),
              batched=hasattr(paged, "gather_blocks_many"), shape=f"{kind}/{shape}",
              host_us=_timing().host_us(torch, fn, calls=100))
    return 0


def tune(args):
    sys.path.insert(0, CHECKOUT)
    cs = _chip_smoke()
    import torch

    from infinistore_tpu_torch.cuda import _ext, paged

    src = open(os.path.join(HERE, "csrc", "paged_copy.cu")).read()
    nvcc = _ext._nvcc()
    builds = {}
    for name, patches in TUNE.items():
        out_dir = os.path.join(PROBE_DIR, "tune", name)
        shutil.rmtree(out_dir, ignore_errors=True)
        shutil.copytree(os.path.join(HERE, "csrc"), out_dir)
        patched = src
        for pattern, replacement in patches.items():
            patched, hits = re.subn(pattern, replacement, patched)
            if hits != 1:
                raise RuntimeError(f"variant {name}: {pattern!r} not in paged_copy.cu")
        with open(os.path.join(out_dir, "paged_copy.cu"), "w") as f:
            f.write(patched)
        builds[name] = _nvcc(nvcc, out_dir, out_dir)
    libs = {name: _load(path, proc, name, _ext.ARGTYPES)
            for name, (path, proc) in builds.items()}

    g = torch.Generator(device="cuda").manual_seed(17)
    inp = cs.copy_inputs(torch, g, torch.bfloat16, BLOCK, 64)
    fused = (paged.gather_blocks, paged.scatter_blocks, paged.gather_blocks_many,
             paged.scatter_blocks_many)
    plain = (paged.gather_blocks_plain, paged.scatter_blocks_plain,
             paged.gather_blocks_many_plain, paged.scatter_blocks_many_plain)
    calls = cs.copy_calls(inp, *fused)
    for name, lib in libs.items():
        _ext._lib = lib
        for key in calls:
            if not cs.copy_matches(torch, inp, key, fused, plain):
                raise AssertionError(f"{name} {key}: differs from the plain version")
    timer = _timing().Timer(torch)
    times = {name: {f"{k}/{s}": [] for k, s in calls} for name in libs}
    for name in [*libs, *reversed(list(libs))]:
        _ext._lib = libs[name]
        for (kind, shape), fn in calls.items():
            times[name][f"{kind}/{shape}"].append(timer.ms(fn))
    for name, by_shape in times.items():
        _emit(setting=name, ms=by_shape)
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    for mode, text in (("device", "per-launch fit and another tree's kernels"),
                       ("host", "wrapper host time per call")):
        p = sub.add_parser(mode, help=text)
        p.add_argument("--root", default="", help="checkout of the other tree")
    sub.add_parser("tune", help="the bulk ring's chunk size and stage count")
    args = ap.parse_args()
    # Run as a script, this directory heads sys.path: its modules are the
    # package's, imported through the package only.
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    import torch

    if not torch.cuda.is_available():
        print("copy_probe: needs a CUDA card", file=sys.stderr)
        return 1
    return {"device": device, "host": host, "tune": tune}[args.mode](args)


if __name__ == "__main__":
    sys.exit(main())
