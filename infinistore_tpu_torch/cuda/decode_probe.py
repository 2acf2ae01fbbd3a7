#!/usr/bin/env python3
"""Probe of the paged decode kernels K3 and K6 on one CUDA card. Run from
the root of a checkout (the package does not import it):

    python3 infinistore_tpu_torch/cuda/decode_probe.py host [--root DIR]
    python3 infinistore_tpu_torch/cuda/decode_probe.py splits

``host``: the wrappers' host time per call of K3 and K6 at the shapes their
paths give them (``chip_smoke.host_us``: the card is kept busy by a spin,
so only the host's work is timed), for the package of the checkout at
``--root`` (default: this one). Two checkouts run in turn on one card
compare the wrappers of two trees. For this checkout it also
times the pieces of K3's wrapper one by one (``parts_us``).

``splits``: the decode fold's split policy. Builds ``paged_attention.cu``
twice into ``_build/probe``: as it is (``adaptive``: a row of n pages in
about 8 splits of 4 to 16 pages) and with every split 16 pages
(``fixed16``: ``kMinSplitPages = 16``). Each library is held against the
plain version at every shape, then both are timed through the wrappers
(``chip_smoke.Timer``) in the order adaptive, fixed16, fixed16, adaptive.

Shapes (bf16, Llama-3-8B widths, 16-token blocks): K3 at the round trip's
decode step (4 rows of 2,048 tokens), at ``prefill_continue`` (256 rows at
contexts 769-1,024 over one 72-block table) and at the sharded decode's
32,768-token request; K6 on ``chip_smoke.py``'s skewed wave and at the
engine's wave (4 x 8-token chunks at 1,024 tokens). Prints one JSON line
per measurement.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(os.path.dirname(HERE))
BT, H, KVH, D = 16, 32, 8, 128


def _chip_smoke():
    """This checkout's ``chip_smoke.py``, loaded by path (a ``--root``
    checkout may hold another)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(CHECKOUT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _shapes(torch, np, pa, cs):
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
    lens, row_tables, width, n = cs._skewed_wave()
    cases["k6_skewed"] = ragged_case(lens, row_tables, width, n)
    req = np.random.default_rng(6).permutation(4 * 72 + 16)[: 4 * 72].astype(np.int32)
    req = req.reshape(4, 72)
    cases["k6_engine_wave"] = ragged_case([1024 + j for _ in range(4) for j in range(8)],
                                          [req[r // 8] for r in range(32)], 72, 4 * 72 + 16)
    return cases


def host(args):
    sys.path.insert(0, os.path.abspath(args.root or CHECKOUT))
    cs = _chip_smoke()
    import numpy as np
    import torch

    from infinistore_tpu_torch.cuda import paged_attention as pa

    for name, (run, _) in _shapes(torch, np, pa, cs).items():
        print(json.dumps({"root": args.root or ".", "package": os.path.dirname(pa.__file__),
                          "shape": name, "host_us": cs.host_us(torch, run, calls=200)}),
              flush=True)
    if not args.root:
        print(json.dumps({"parts_us": _host_parts(torch, cs)}), flush=True)
    return 0


def _host_parts(torch, cs):
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
    scratch, tickets, _ = pa._split_scratch(q, KVH, width, stream)
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
        "split_scratch": lambda: pa._split_scratch(q, KVH, width, stream),
        "torch_empty_scratch": lambda: torch.empty(floats, dtype=torch.float32, device="cuda"),
        "empty_like_out": lambda: torch.empty_like(q),
        "entry_call": lambda: lib.its_paged_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), tables.data_ptr(), lens.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), tickets.data_ptr(), 1, rows, H, KVH, D, BT, n,
            width, splits, stream),
    }
    return {name: cs.host_us(torch, fn, calls=200) for name, fn in parts.items()}


VARIANTS = {"adaptive": {}, "fixed16": {"kMinSplitPages = 4;": "kMinSplitPages = 16;"}}


def _build_variant(nvcc, name, patches):
    out = os.path.join(HERE, os.pardir, "_build", "probe", name)
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
           "-Xcompiler", "-fPIC", "-shared", os.path.join(out, "paged_attention.cu"), "-o", lib]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def splits(args):
    sys.path.insert(0, CHECKOUT)
    cs = _chip_smoke()
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

    cases = _shapes(torch, np, pa, cs)
    for name in libs:
        use(name)
        for shape, (run, plain) in cases.items():
            err = cs.max_err(run(), plain())
            if not err <= 2e-2:
                raise AssertionError(f"variant {name} at {shape}: max abs err {err}")
    timer = cs.Timer(torch)
    times = {name: {shape: [] for shape in cases} for name in libs}
    for name in ("adaptive", "fixed16", "fixed16", "adaptive"):
        use(name)
        for shape, (run, _) in cases.items():
            times[name][shape].append(timer.ms(run))
    for name, by_shape in times.items():
        print(json.dumps({"variant": name, "ms": by_shape}), flush=True)
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    h = sub.add_parser("host", help="wrapper host time per call")
    h.add_argument("--root", default="", help="checkout whose package is timed")
    sub.add_parser("splits", help="the split policy, as is against fixed 16-page splits")
    args = ap.parse_args()
    # Run as a script, this directory heads sys.path: its modules are the
    # package's, imported through the package only.
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    import torch

    if not torch.cuda.is_available():
        print("decode_probe: needs a CUDA card", file=sys.stderr)
        return 1
    return host(args) if args.mode == "host" else splits(args)


if __name__ == "__main__":
    sys.exit(main())
