#!/usr/bin/env python3
"""Probe of K4, the prefill attention kernel, on one CUDA card. Run from the
root of a checkout (the package's entry points do not import it):

    python3 infinistore_tpu_torch/cuda/prefill_probe.py [--root DIR] [--only LABELS]
        [--variant NAME=-DFLAG[,-DFLAG...]] ...

Builds this tree's two K4 sources (``flash_prefill.cu``, f32 on the CUDA
cores; ``flash_prefill_wgmma.cu``, bf16 on the tensor cores) into
``_build/probe/k4_this`` with ``-Xptxas -v`` and prints each kernel's
registers and spills; with ``--root`` (another checkout, e.g. the parent
unpacked by ``git archive``) builds that tree's into ``_build/probe/k4_root``
at the same time, and each ``--variant`` (this tree's sources built with
its ``-D`` flags, e.g. ``ITS_K4_D256_NO_SPLIT``, ``ITS_K4_NO_MERGE``,
``ITS_F32_SKIP_QK``) into ``_build/probe/k4_NAME``; a variant is called
through its C entry with a merge workspace of one slot a query tile.

Then, at one ``PROMPT``-token prompt (and 4 at Gemma-2B's shape), for each
shape of ``CASES`` in f32 and bf16: the kernel against the plain version
(1e-5 f32, 2e-2 bf16), two launches bitwise equal, each prompt of a
4-prompt batch bitwise its solo launch, and with ``--root`` this tree's
output bitwise the root's or not (``bitwise_root``); then timed
(``timing.Timer``: CUDA events, median of 11, each behind an L2 flush) in
the order root, this, this, root, beside one
``F.scaled_dot_product_attention`` call on the same inputs (causal, GQA)
and the bound (operations over the card's peak rate of the dtype). The
SDPA kernels' names come from ``torch.profiler`` over one call. Prints one
JSON line per shape and dtype.
"""

import argparse
import ctypes
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
K4_SOURCES = ("flash_prefill.cu", "flash_prefill_wgmma.cu")
PROMPT = 2048
# label -> (query heads, KV heads, head_dim, prompts): the kernel phase's
# shapes (chip_smoke.py SHAPES_TAKEN, and the round trip's at head_dim 128),
# and Gemma-2B's at 4 prompts.
CASES = {
    "main": (32, 8, 128, 1),
    "d8": (4, 2, 8, 1),
    "d16": (4, 2, 16, 1),
    "d32": (8, 2, 32, 1),
    "d64": (32, 8, 64, 1),
    "d80": (32, 32, 80, 1),
    "d96": (32, 32, 96, 1),
    "mha128": (32, 32, 128, 1),
    "g7": (28, 4, 128, 1),
    "d256": (8, 1, 256, 1),
    "d256_b4": (8, 1, 256, 4),
}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# K4's C entry before it took a split workspace (a --root tree's, and the
# parent's): q, k, v, out, B, S, T, H, KVH, D, causal, stream.
OLD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def _timing():
    spec = importlib.util.spec_from_file_location("_probe_timing",
                                                  os.path.join(HERE, "timing.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _build(name, csrc, verbose, defines=()):
    """Starts one ``nvcc`` a K4 source of ``csrc`` (with ``defines``) into
    ``_build/probe/name``; returns the pending build."""
    from infinistore_tpu_torch.cuda import _ext

    out = os.path.abspath(os.path.join(PROBE_DIR, name))
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    objs, procs = [], []
    for src in K4_SOURCES:
        obj = os.path.join(out, os.path.splitext(src)[0] + ".o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [_ext._nvcc(), *_ext.ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
             *(("-Xptxas", "-v") if verbose else ()), *defines, "-I", csrc, "-c",
             os.path.join(csrc, src), "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    return name, out, objs, procs


def _load(pending):
    """Links a ``_build``; returns (library, the compiler's output)."""
    from infinistore_tpu_torch.cuda import _ext

    name, out, objs, procs = pending
    logs = []
    for proc in procs:
        log, _ = proc.communicate()
        logs.append(log.decode(errors="replace"))
        if proc.returncode:
            raise RuntimeError(f"{name} did not build:\n{logs[-1][-6000:]}")
    path = os.path.join(out, "lib.so")
    link = subprocess.run([_ext._nvcc(), *_ext.ARCH, "-shared", *objs, "-o", path],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if link.returncode:
        raise RuntimeError(f"{name} did not link:\n{link.stdout.decode()[-4000:]}")
    return ctypes.CDLL(path), "\n".join(logs)


def resources(log):
    """{kernel: (registers, spill store bytes, spill load bytes)} from
    ``-Xptxas -v`` output, for K4's kernels."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out.setdefault(name, [None, int(m.group(1)), int(m.group(2))])
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, [None, 0, 0])[0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items() if "flash" in k}


def _root_call(lib, torch):
    """K4 through a root tree's library, which takes the old C entry."""
    from infinistore_tpu_torch.cuda import _ext

    for entry in ("its_flash_prefill", "its_flash_prefill_wgmma"):
        getattr(lib, entry).argtypes = OLD_ARGTYPES
        getattr(lib, entry).restype = ctypes.c_int

    def run(q, k, v, causal=True):
        b, s, h, d = q.shape
        out = torch.empty_like(q)
        entry = lib.its_flash_prefill_wgmma if q.dtype == torch.bfloat16 else \
            lib.its_flash_prefill
        _ext.check(entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
                         k.shape[1], h, k.shape[2], d, int(causal), _ext.stream_of(q)), "root")
        return out
    return run


def _variant_call(lib, torch):
    """K4 through a variant build's C entry (this tree's signature), with a
    merge workspace of one slot a (query tile, batch, head): enough for any
    split plan."""
    from infinistore_tpu_torch.cuda import _ext

    for entry, argtypes in _ext.ARGTYPES.items():
        if hasattr(lib, entry):
            getattr(lib, entry).argtypes = argtypes
            getattr(lib, entry).restype = ctypes.c_int

    def run(q, k, v, causal=True):
        b, s, h, d = q.shape
        out = torch.empty_like(q)
        stream = _ext.stream_of(q)
        if q.dtype != torch.bfloat16:
            code = lib.its_flash_prefill(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                         out.data_ptr(), b, s, k.shape[1], h, k.shape[2], d,
                                         int(causal), stream)
        else:
            slots = -(-s // 128) * b * h
            scratch, tickets = _ext.split_workspace(q.device, stream, slots * 2 * 128 * 132,
                                                    2 * slots)
            code = lib.its_flash_prefill_wgmma(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                               out.data_ptr(), scratch.data_ptr(),
                                               tickets.data_ptr(), b, s, k.shape[1], h,
                                               k.shape[2], d, int(causal), slots, stream)
        _ext.check(code, "variant")
        return out
    return run


def _sdpa_kernels(torch, fn):
    """Names of the CUDA kernels one call of ``fn`` ran, by ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = []
    for evt in prof.key_averages():
        dev = getattr(evt, "device_time_total", None)
        if dev is None:
            dev = getattr(evt, "cuda_time_total", 0)
        if dev > 0:
            names.append(evt.key)
    return names


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default="", help="checkout whose K4 is built and timed beside")
    ap.add_argument("--only", default="", help="comma-separated labels of CASES")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=-DFLAG[,-DFLAG...]: this tree built with those flags")
    args = ap.parse_args()
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    sys.path.insert(0, CHECKOUT)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("prefill_probe: needs a CUDA card", file=sys.stderr)
        return 1
    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.cuda import flash_prefill as fp

    tm = _timing()
    pending = [_build("k4_this", os.path.join(HERE, "csrc"), True)]
    if args.root:
        pending.append(_build("k4_root", os.path.join(
            os.path.abspath(args.root), "infinistore_tpu_torch", "cuda", "csrc"), False))
    variants = dict(v.split("=", 1) for v in args.variant)
    for name, flags in variants.items():
        pending.append(_build(f"k4_{name}", os.path.join(HERE, "csrc"), False,
                              tuple(flags.split(","))))
    built = [_load(p) for p in pending]
    print(json.dumps({"ptxas": resources(built[0][1])}), flush=True)
    this_lib = built[0][0]
    for entry, argtypes in _ext.ARGTYPES.items():
        if hasattr(this_lib, entry):
            getattr(this_lib, entry).argtypes = argtypes
            getattr(this_lib, entry).restype = ctypes.c_int
    _ext._lib = this_lib  # the package's wrapper launches this build
    calls = {"this": lambda q, k, v: fp.flash_prefill_attention(q, k, v, causal=True)}
    if args.root:
        calls["root"] = _root_call(built[1][0], torch)
    for (name, _), (lib, _) in zip(variants.items(), built[1 + bool(args.root):]):
        calls[name] = _variant_call(lib, torch)
    order = (["root"] if args.root else []) + ["this"] + list(variants)
    order = order + order[::-1]

    timer = tm.Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(18)
    labels = args.only.split(",") if args.only else list(CASES)
    for label in labels:
        h, kvh, d, b = CASES[label]
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            q, k, v = (torch.randn((b, PROMPT, heads, d), generator=g, device="cuda").to(dtype)
                       for heads in (h, kvh, kvh))
            got = {name: call(q, k, v) for name, call in calls.items()}
            again = calls["this"](q, k, v)
            err = tm.max_err(got["this"], fp.flash_prefill_plain(q, k, v, causal=True))
            torch.cuda.synchronize()
            row = {"label": label, "dtype": dname, "prompts": b, "tokens": PROMPT, "heads": h,
                   "kv_heads": kvh, "head_dim": d, "max_abs_err": err, "tol": TOL[dname],
                   "bitwise_twice": bool(torch.equal(got["this"], again))}
            if b > 1:
                row["bitwise_solo"] = all(
                    torch.equal(calls["this"](q[i:i + 1], k[i:i + 1], v[i:i + 1]),
                                got["this"][i:i + 1]) for i in range(b))
            if "root" in got:
                row["bitwise_root"] = bool(torch.equal(got["this"], got["root"]))
            if variants:
                row["variant_err"] = {name: tm.max_err(got[name], fp.flash_prefill_plain(
                    q, k, v, causal=True)) for name in variants}
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

            def sdpa():
                return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                      enable_gqa=True)

            times = {name: [] for name in calls}
            for name in order:
                times[name].append(timer.ms(lambda c=calls[name]: c(q, k, v)))
            pairs = PROMPT * (PROMPT + 1) // 2
            bms, by = tm.bound_ms((2 * PROMPT * h * d + 2 * PROMPT * kvh * d) * b *
                                  q.element_size(), 4.0 * d * h * pairs * b, dname)
            row.update(ms=times, sdpa_ms=timer.ms(sdpa), sdpa_kernels=_sdpa_kernels(torch, sdpa),
                       bound_ms=bms, bound_by=by)
            print(json.dumps(row), flush=True)
            if err > TOL[dname] or not row["bitwise_twice"] or not row.get("bitwise_solo", True):
                print(f"prefill_probe: {label} {dname} failed its checks", file=sys.stderr)
                return 1
            del q, k, v, qt, kt, vt, got, again
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
