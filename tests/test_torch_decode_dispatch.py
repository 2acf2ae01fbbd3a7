"""The paged decode kernels' wrappers (K3, K5, K6, K7, K8 in
``infinistore_tpu_torch/cuda/paged_attention.py`` and ``kv_quant.py``)
against a fake kernel library, on CPU tensors.

Each wrapper must hand its entry the split scratch of the split-KV fold,
sized from shapes alone (rows x splits x H x (D + 2) f32, splits as the
library's ``its_decode_splits`` gives them for the table width, asked once
per width: ``max_blocks`` for a table, ``table_width`` at most P for a
ragged wave), and the ticket counters (one per row, KV head and split), both
from the stream's workspace, in the order of ``_ext.ARGTYPES``; read no
device value on the call; move its launch counter once per launch; raise on
a non-zero code with no fallback to the plain version; and raise on a bad
shape or dtype before any launch. The kernels take head_dim 8, 16, 32, 64,
80, 96, 128 and 256 and any group of query heads a KV head: each launch hands the library
its (dtype, head_dim, heads, KV heads), and the ticket counters cover
the virtual KV heads a group folds as (H / Gc, Gc the largest of 8, 4, 2
and 1 dividing the group: one counter per row, query head and split). The fold's split policy, read from its source's
constants, sizes K8's scratch as the kernel folds. The kernels themselves
run only on the card (``tests/test_torch_cuda_kernels.py``)."""

import os
import re

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from infinistore_tpu_torch.cuda import _ext
from infinistore_tpu_torch.cuda import kv_quant as kq
from infinistore_tpu_torch.cuda import paged_attention as pa

_STREAM = 0x5EED
BT, H, KVH, D, N = 4, 8, 2, 64, 40


def _fake_splits(width):
    """The fake library's split count for a table ``width`` pages wide: not
    the real library's rule (the card tests hold that one), so a wrapper
    passes the tests only by using what the library answers."""
    return width // 5 + 2


class _FakeLib:
    """Records each launch entry's arguments (each converted to its declared
    C type, as ctypes would) and returns ``code``; answers the split count
    with ``splits`` and records the widths it was asked about."""

    def __init__(self, code=0, splits=_fake_splits):
        self.calls = []
        self.code = code
        self.splits = splits
        self.split_widths = []

    def its_decode_splits(self, width):
        _ext.ARGTYPES["its_decode_splits"][0](width)
        self.split_widths.append(width)
        return self.splits(width)

    def _entry(self, name):
        def call(*args):
            argtypes = _ext.ARGTYPES[name]
            assert len(args) == len(argtypes), (name, args)
            for kind, arg in zip(argtypes, args):
                kind(arg)
            self.calls.append((name, args))
            return self.code
        return call

    def __getattr__(self, name):
        if name not in _ext.ARGTYPES:
            raise AttributeError(name)
        return self._entry(name)


class _NoDeviceReads(TorchFunctionMode):
    """Fails any read of a tensor's value into the host: on a card each one
    would wait for the device and stall the decode loop."""

    READS = {"item", "tolist", "cpu", "numpy", "__int__", "__bool__", "__float__",
             "__index__"}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        moves = name == "to" and any(
            isinstance(a, (torch.device, str)) for a in (*args[1:], *kwargs.values()))
        if name in self.READS or moves:
            raise AssertionError(f"the wrapper read a device value ({name})")
        return func(*args, **kwargs)


@pytest.fixture()
def fake_lib(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(_ext, "kernels", lambda: lib)
    monkeypatch.setattr(_ext, "require_cuda", lambda name, device, **tensors: None)
    monkeypatch.setattr(_ext, "stream_of", lambda t: _STREAM)
    monkeypatch.setattr(_ext, "LAUNCHES", dict.fromkeys(_ext.LAUNCHES, 0))
    monkeypatch.setattr(_ext, "_WORKSPACE", {})
    monkeypatch.setattr(_ext, "_SPLITS", {})
    scratch = []

    def recording(real):
        def split_scratch(q, width, stream):
            got = real(q, width, stream)
            scratch.append(got)
            return got
        return split_scratch

    monkeypatch.setattr(pa, "_split_scratch", recording(pa._split_scratch))
    monkeypatch.setattr(kq, "_split_scratch", recording(kq._split_scratch))

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA wrapper fell back to the plain version")

    for mod, fn in ((pa, "paged_decode_attention_plain_batched"),
                    (pa, "decode_attention_stats_plain"),
                    (pa, "paged_decode_attention_ragged_plain"),
                    (pa, "decode_attention_stats_ragged_plain"),
                    (kq, "_quant_decode_plain")):
        monkeypatch.setattr(mod, fn, refuse)
    lib.scratch = scratch
    return lib


def _rng(seed):
    return np.random.default_rng(seed)


def _f(seed, shape, dtype=torch.bfloat16):
    return torch.from_numpy(_rng(seed).standard_normal(shape).astype(np.float32)).to(dtype)


def _table_inputs(rows=3, width=37, dtype=torch.bfloat16, lens=None, table_seed=4, h=H, kvh=KVH,
                  d=D):
    q = _f(1, (rows, h, d), dtype)
    k, v = _f(2, (N, BT, kvh, d), dtype), _f(3, (N, BT, kvh, d), dtype)
    tables = torch.from_numpy(
        _rng(table_seed).integers(0, N, (rows, width)).astype(np.int32))
    lens = torch.tensor(lens if lens is not None else [0, 5, width * BT][:rows],
                        dtype=torch.int32)
    return q, k, v, tables, lens


def _ragged_inputs(lens=(0, 5, 70), table_width=18, dtype=torch.bfloat16, h=H, kvh=KVH, d=D):
    rows = len(lens)
    q = _f(1, (rows, h, d), dtype)
    k, v = _f(2, (N, BT, kvh, d), dtype), _f(3, (N, BT, kvh, d), dtype)
    tables = [_rng(10 + r).permutation(N)[:table_width] for r in range(rows)]
    m = pa.build_ragged_wave(tables, list(lens), BT, pad_to_pow2=True)
    meta = [torch.from_numpy(x) for x in (m.pages, m.page_rows, m.page_starts, m.seq_lens)]
    return q, k, v, meta, table_width


def _quant_inputs(rows=3, width=37, dtype=torch.bfloat16, lens=None, table_seed=4, h=H, kvh=KVH,
                  d=D):
    q, k, v, tables, lens = _table_inputs(rows, width, dtype, lens, table_seed, h, kvh, d)
    (kd, ks), (vd, vs) = kq.quantize_kv(k.float()), kq.quantize_kv(v.float())
    return q, kd, ks, vd, vs, tables, lens


def _k3(dtype=torch.bfloat16, **kw):
    q, k, v, tables, lens = _table_inputs(dtype=dtype, **kw)
    return (lambda: pa._paged_decode_attention_cuda(q, k, v, tables, lens),
            q, (q, k, v, tables, lens), tables.shape[1])


def _k5(dtype=torch.bfloat16, **kw):
    q, k, v, tables, lens = _table_inputs(dtype=dtype, **kw)
    return (lambda: pa._decode_attention_stats_cuda(q, k, v, tables, lens),
            q, (q, k, v, tables, lens), tables.shape[1])


def _k8(dtype=torch.bfloat16, **kw):
    q, kd, ks, vd, vs, tables, lens = _quant_inputs(dtype=dtype, **kw)
    return (lambda: kq._quant_decode_cuda(q, kd, ks, vd, vs, tables, lens),
            q, (q, kd, ks, vd, vs, tables, lens), tables.shape[1])


def _k6(dtype=torch.bfloat16, **kw):
    q, k, v, meta, width = _ragged_inputs(dtype=dtype, **kw)
    pages, rows, starts, lens = meta
    return (lambda: pa._paged_decode_attention_ragged_cuda(q, k, v, pages, rows, starts, lens,
                                                           width),
            q, (q, k, v, pages, starts, lens), min(width, pages.shape[0]))


def _k7(dtype=torch.bfloat16, **kw):
    q, k, v, meta, width = _ragged_inputs(dtype=dtype, **kw)
    pages, rows, starts, lens = meta
    return (lambda: pa._decode_attention_stats_ragged_cuda(q, k, v, pages, rows, starts, lens,
                                                           width),
            q, (q, k, v, pages, starts, lens), min(width, pages.shape[0]))


# (the call's maker, entry, counter, outputs the entry writes, ragged)
KERNELS = {
    "K3": (_k3, "its_paged_decode_attention", "paged_decode_attention", 1, False),
    "K5": (_k5, "its_paged_decode_attention_stats", "paged_decode_attention_stats", 3, False),
    "K6": (_k6, "its_paged_decode_attention_ragged", "paged_decode_attention_ragged", 1, True),
    "K7": (_k7, "its_paged_decode_attention_ragged_stats",
           "paged_decode_attention_ragged_stats", 3, True),
    "K8": (_k8, "its_paged_decode_attention_quantized", "paged_decode_attention_quantized", 1,
           False),
}


# The entries that take a sliding window (0: none) before the stream.
WINDOWED = {"K3", "K6"}


def _ptrs(tensors):
    return tuple(t.data_ptr() for t in tensors)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_wrapper_passes_scratch_sized_from_shapes(fake_lib, kernel, dtype):
    build, entry, counter, n_out, ragged = KERNELS[kernel]
    call, q, inputs, width = build(dtype)
    with _NoDeviceReads():
        call()
    (name, args), = fake_lib.calls
    assert name == entry
    (scratch, tickets, splits), = fake_lib.scratch
    rows = q.shape[0]
    assert fake_lib.split_widths == [width] and splits == _fake_splits(width)
    # A fresh workspace is allocated at the launch's own size.
    assert scratch.dtype == torch.float32 and scratch.numel() == rows * splits * H * (D + 2)
    assert tickets.dtype == torch.int32 and tickets.numel() >= rows * KVH * splits
    assert not tickets.any()
    ws = _ext._WORKSPACE[(q.device, _STREAM)]
    assert ws[0] is scratch and ws[1] is tickets
    # Inputs, then the outputs, then scratch and tickets; then the ints.
    n_in = len(inputs)
    assert args[:n_in] == _ptrs(inputs)
    assert args[n_in + n_out:n_in + n_out + 2] == (scratch.data_ptr(), tickets.data_ptr())
    ints = args[n_in + n_out + 2:-1]
    n_blocks = inputs[1].shape[0]
    head = (_ext.DTYPE_CODES[dtype], rows, H, KVH, D, BT, n_blocks)
    window = (0,) if kernel in WINDOWED else ()
    if ragged:
        assert ints == head + (inputs[3].shape[0], width, splits) + window
    else:
        assert ints == head + (width, splits) + window
    assert args[-1] == _STREAM
    assert _ext.LAUNCHES[counter] == 1
    assert sum(_ext.LAUNCHES.values()) == 1


@pytest.mark.parametrize("kernel", ["K3", "K5", "K8"])
def test_table_scratch_ignores_lengths_and_table_values(fake_lib, kernel):
    """Two calls that differ only in seq_lens and table contents get the same
    scratch size, split count and tickets: nothing is read from the
    device."""
    build = KERNELS[kernel][0]
    for seed, lens in ((4, [0, 0, 0]), (5, [148, 1, 2])):
        call, *_ = build(lens=lens, table_seed=seed)
        with _NoDeviceReads():
            call()
    (_, a), (_, b) = fake_lib.calls
    (sa, ta, na), (sb, tb, nb) = fake_lib.scratch
    assert sa is sb and na == nb == _fake_splits(37) and ta is tb
    tail = 4 if kernel in WINDOWED else 3
    assert a[-tail:] == b[-tail:]  # width, splits, (window,) stream


@pytest.mark.parametrize("table_width,width", [(1, 1), (5, 5), (17, 17), (40, 32), (999, 32)])
@pytest.mark.parametrize("kernel", ["K6", "K7"])
def test_ragged_splits_follow_table_width_at_most_p(fake_lib, kernel, table_width, width):
    q, k, v, meta, _ = _ragged_inputs(lens=(0, 5, 70))  # 1 + 2 + 18 pages, padded to 32
    pages, rows, starts, lens = meta
    assert pages.shape[0] == 32
    fn = (pa._paged_decode_attention_ragged_cuda if kernel == "K6"
          else pa._decode_attention_stats_ragged_cuda)
    with _NoDeviceReads():
        fn(q, k, v, pages, rows, starts, lens, table_width)
    (_, args), = fake_lib.calls
    if kernel in WINDOWED:
        assert args[-5:-1] == (32, width, _fake_splits(width), 0)
    else:
        assert args[-4:-1] == (32, width, _fake_splits(width))
    assert fake_lib.split_widths == [width]


def test_rows_entry_bounds_splits_by_its_row_tables(fake_lib, monkeypatch):
    """``paged_decode_attention_rows`` (the engine's wave body) hands K6 the
    width of its rectangular row tables."""
    seen = []
    monkeypatch.setattr(pa, "_paged_decode_attention_ragged_cuda",
                        lambda *args: seen.append(args))

    class _OnCard:
        device = torch.device("cuda")

    row_tables = torch.zeros((5, 23), dtype=torch.int32)
    lens = torch.ones(5, dtype=torch.int64)
    pa.paged_decode_attention_rows(_OnCard(), None, None, row_tables, lens, "pages", "rows",
                                   "starts")
    (args,) = seen
    assert args[3:6] == ("pages", "rows", "starts")
    assert args[6].dtype == torch.int32 and args[7] == 23


@pytest.mark.parametrize("kernel", KERNELS)
def test_each_launch_moves_its_counter_once(fake_lib, kernel):
    build, entry, counter, _, _ = KERNELS[kernel]
    call, *_ = build()
    for _ in range(3):
        call()
    assert [name for name, _ in fake_lib.calls] == [entry] * 3
    assert _ext.LAUNCHES[counter] == 3
    assert sum(_ext.LAUNCHES.values()) == 3
    # The three launches shared one scratch and one ticket buffer.
    assert len({(s.data_ptr(), t.data_ptr()) for s, t, _ in fake_lib.scratch}) == 1


@pytest.mark.parametrize("kernel", KERNELS)
def test_split_count_is_asked_once_per_width(fake_lib, kernel):
    """A steady-state launch makes no library call for its split count: the
    wrappers ask ``its_decode_splits`` once per table width, whichever
    kernel asked first."""
    build, ragged = KERNELS[kernel][0], KERNELS[kernel][4]
    call, _, _, width = build()
    other, _, _, other_width = (build(lens=(3, 44), table_width=11) if ragged
                                else build(rows=2, width=11, lens=[3, 44]))
    assert other_width == 11
    for _ in range(3):
        call()
        other()
    assert fake_lib.split_widths == [width, other_width]
    for name in KERNELS:
        KERNELS[name][0]()[0]()
    assert sorted(fake_lib.split_widths) == sorted({width, other_width, 37, 18})
    assert [s for _, _, s in fake_lib.scratch[:2]] == [_fake_splits(width),
                                                       _fake_splits(other_width)]


@pytest.mark.parametrize("kernel", KERNELS)
def test_a_failed_launch_raises_and_nothing_falls_back(fake_lib, kernel):
    build, entry, _, _, _ = KERNELS[kernel]
    fake_lib.code = 700
    call, *_ = build()
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        call()
    assert [name for name, _ in fake_lib.calls] == [entry]


def _misaligned(t):
    """``t``'s values in a contiguous tensor that starts 2 bytes past a
    16-byte boundary."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype)[1:].view(t.shape)
    out.copy_(t)
    return out


def _bad_cases():
    """(kernel, what, make the call) for inputs the kernels do not take."""
    cases = []
    for kernel in KERNELS:
        build = KERNELS[kernel][0]
        cases.append((kernel, "f16", lambda b=build: b(torch.float16)[0], TypeError,
                      "unsupported dtype"))
    q, k, v, tables, lens = _table_inputs()
    misaligned = torch.empty(k.numel() + 1, dtype=k.dtype)[1:].view(k.shape)
    misaligned.copy_(k)
    # The case keeps its name, "head_dim 96", from when 96 was refused; it
    # holds 72, which is.
    cases += [
        ("K3", "head_dim 96", lambda: (lambda: pa._paged_decode_attention_cuda(
            _f(1, (3, H, 72)), _f(2, (N, BT, KVH, 72)), _f(3, (N, BT, KVH, 72)), tables, lens)),
         ValueError, "head_dim 8, 16, 32, 64, 80, 96, 128 or 256"),
        ("K3", "7 heads over 2 KV heads", lambda: (lambda: pa._paged_decode_attention_cuda(
            _f(1, (3, 7, D)), k, v, tables, lens)), ValueError, "KV heads dividing"),
        ("K3", "int64 tables", lambda: (lambda: pa._paged_decode_attention_cuda(
            q, k, v, tables.long(), lens)), ValueError, "block_tables"),
        ("K3", "empty tables", lambda: (lambda: pa._paged_decode_attention_cuda(
            q, k, v, tables[:, :0].contiguous(), lens)), ValueError, "block_tables"),
        ("K5", "short seq_lens", lambda: (lambda: pa._decode_attention_stats_cuda(
            q, k, v, tables, lens[:2].contiguous())), ValueError, "seq_lens"),
        ("K3", "misaligned cache", lambda: (lambda: pa._paged_decode_attention_cuda(
            q, misaligned, v, tables, lens)), ValueError, "16-byte"),
        ("K5", "misaligned cache", lambda: (lambda: pa._decode_attention_stats_cuda(
            q, k, misaligned, tables, lens)), ValueError, "16-byte"),
        ("K3", "cache dtype", lambda: (lambda: pa._paged_decode_attention_cuda(
            q, k.float(), v.float(), tables, lens)), TypeError, "share a dtype"),
    ]
    rq, rk, rv, (pages, rows, starts, rlens), width = _ragged_inputs()
    for kernel, fn in (("K6", pa._paged_decode_attention_ragged_cuda),
                       ("K7", pa._decode_attention_stats_ragged_cuda)):
        cases += [
            (kernel, "table_width 0", lambda fn=fn: (lambda: fn(
                rq, rk, rv, pages, rows, starts, rlens, 0)), ValueError, "table_width"),
            (kernel, "page_rows", lambda fn=fn: (lambda: fn(
                rq, rk, rv, pages, rows[:-1].contiguous(), starts, rlens, width)), ValueError,
             "page_rows"),
            (kernel, "misaligned cache", lambda fn=fn: (lambda: fn(
                rq, misaligned, rv, pages, rows, starts, rlens, width)), ValueError, "16-byte"),
        ]
    q, kd, ks, vd, vs, tables, lens = _quant_inputs()
    cases += [
        ("K8", "float data", lambda: (lambda: kq._quant_decode_cuda(
            q, kd.float(), ks, vd.float(), vs, tables, lens)), TypeError, "int8"),
        ("K8", "scale shape", lambda: (lambda: kq._quant_decode_cuda(
            q, kd, ks[:, :1].contiguous(), vd, vs, tables, lens)), ValueError, "k_scales"),
        ("K8", "scale dtype", lambda: (lambda: kq._quant_decode_cuda(
            q, kd, ks, vd, vs.double(), tables, lens)), ValueError, "v_scales"),
        ("K8", "misaligned q", lambda: (lambda: kq._quant_decode_cuda(
            _misaligned(q), kd, ks, vd, vs, tables, lens)), ValueError, "16-byte"),
    ]
    return cases


BAD = _bad_cases()


# (query heads, KV heads) -> the virtual KV heads the launch folds as: the
# group G runs as G / Gc heads of Gc query heads, Gc the largest of 8, 4, 2
# and 1 dividing G (Qwen2-1.5B's 12 over 2 and Qwen2.5-7B's 28 over 4 among
# them).
GROUPS = {(2, 2): 2, (4, 2): 2, (6, 2): 6, (8, 2): 2, (12, 2): 6, (14, 2): 14, (16, 2): 2,
          (28, 4): 28, (32, 2): 4}


@pytest.mark.parametrize("d", _ext.HEAD_DIMS)
@pytest.mark.parametrize("h,kvh", list(GROUPS), ids=[f"h{h}-kvh{k}" for h, k in GROUPS])
@pytest.mark.parametrize("kernel", KERNELS)
def test_every_head_dim_and_group_launches(fake_lib, kernel, h, kvh, d):
    """Every head_dim of ``_ext.HEAD_DIMS`` and any group launch, with no device
    value read: the entry gets the call's (dtype, rows, H, KVH, D), the
    scratch is sized from them, and the tickets count a (row, virtual KV
    head, split) each."""
    build, entry, counter, n_out, ragged = KERNELS[kernel]
    call, q, inputs, width = build(torch.float32, h=h, kvh=kvh, d=d)
    with _NoDeviceReads():
        out = call()
    (name, args), = fake_lib.calls
    assert name == entry and _ext.LAUNCHES[counter] == 1
    (scratch, tickets, splits), = fake_lib.scratch
    rows = q.shape[0]
    n_in = len(inputs)
    assert args[n_in + n_out + 2:n_in + n_out + 7] == (_ext.DTYPE_CODES[torch.float32], rows, h,
                                                       kvh, d)
    assert scratch.numel() == rows * splits * h * (d + 2)
    assert tickets.numel() >= rows * GROUPS[(h, kvh)] * splits and not tickets.any()
    first = out[0] if isinstance(out, tuple) else out
    assert tuple(first.shape) == (rows, h, d)


@pytest.mark.parametrize("kernel", KERNELS)
def test_group_3_launches_as_three_virtual_heads(fake_lib, kernel):
    """Three query heads a KV head (6 over 2): one launch with H 6 and KVH
    2, and ticket counters for 6 virtual KV heads of one query head each."""
    build, entry, _, n_out, _ = KERNELS[kernel]
    call, q, inputs, _ = build(h=6, kvh=2)
    call()
    (name, args), = fake_lib.calls
    n_in = len(inputs)
    assert name == entry
    assert args[n_in + n_out + 4:n_in + n_out + 7] == (6, 2, D)
    (_, tickets, splits), = fake_lib.scratch
    assert tickets.numel() >= q.shape[0] * 6 * splits


@pytest.mark.parametrize("case", range(len(BAD)),
                         ids=[f"{k}-{what}" for k, what, *_ in BAD])
def test_bad_shape_or_dtype_raises_before_any_launch(fake_lib, case):
    _, _, make, error, match = BAD[case]
    with pytest.raises(error, match=match):
        make()()
    assert fake_lib.calls == []
    assert sum(_ext.LAUNCHES.values()) == 0


def test_tickets_are_per_stream_reused_and_grown(monkeypatch):
    """The workspace of a stream is reused while it is large enough and
    grown (at least doubled) when a launch needs more; the tickets stay
    zeros; another stream gets its own."""
    monkeypatch.setattr(_ext, "_WORKSPACE", {})
    dev = torch.device("cpu")
    sa, ta = _ext.split_workspace(dev, 1, 100, 10)
    assert sa.numel() == 100 and ta.numel() == 1024 and not ta.any()
    sa2, ta2 = _ext.split_workspace(dev, 1, 100, 1024)
    assert sa2 is sa and ta2 is ta
    sb, tb = _ext.split_workspace(dev, 2, 10, 10)
    assert sb is not sa and tb is not ta
    sc, tc = _ext.split_workspace(dev, 1, 150, 1500)
    assert sc.numel() == 200 and tc.numel() == 2048 and not tc.any()
    assert _ext._WORKSPACE[(dev, 1)][0] is sc and _ext._WORKSPACE[(dev, 1)][1] is tc
    sd, td = _ext.split_workspace(dev, 1, 1000, 5000)
    assert sd.numel() == 1000 and td.numel() == 5000
    sb2, tb2 = _ext.split_workspace(dev, 2, 10, 10)
    assert sb2 is sb and tb2 is tb


@pytest.mark.parametrize("count", [3, 16, 17, 40])
@pytest.mark.parametrize("kernel", KERNELS)
def test_scratch_follows_the_library_split_count(fake_lib, kernel, count):
    """The split count is the library's alone: a library that splits every
    table ``count`` ways (3; 16, the most one merge takes; 17 and 40, rows
    merged in the tree) gets scratch for that many splits, a ticket for
    each, and the count."""
    fake_lib.splits = lambda width: count
    call, q, _, _ = KERNELS[kernel][0]()
    call()
    (_, args), = fake_lib.calls
    (scratch, tickets, splits), = fake_lib.scratch
    assert splits == count and args[-3 if kernel in WINDOWED else -2] == count
    assert scratch.numel() == q.shape[0] * count * H * (D + 2)
    assert tickets.numel() >= q.shape[0] * KVH * count and not tickets.any()


def _fold_policy():
    """The fold's split policy as its source states it: (target splits,
    least and most pages a split) from ``csrc/decode_fold.cuh``."""
    with open(os.path.join(os.path.dirname(_ext.__file__), "csrc", "decode_fold.cuh")) as f:
        consts = {name: int(value)
                  for name, value in re.findall(r"constexpr int (k\w+) = (\d+);", f.read())}
    return consts["kTargetSplits"], consts["kMinSplitPages"], consts["kMaxSplitPages"]


def _row_splits(npages, target, least, most):
    """Splits of a row of ``npages`` pages under the policy (``split_pages``)."""
    per = min(max(-(-npages // target), least), most)
    return max(1, -(-npages // per))


def _grid_splits(width, target, least, most):
    """The grid's split dimension for tables ``width`` pages wide, as
    ``grid_splits`` computes it."""
    if width <= target * least:
        return -(-width // least)
    if width <= target * most:
        return target
    return -(-width // most)


@pytest.mark.parametrize("width", [1, 4, 5, 64, 65, 127, 128, 129, 511, 512, 513, 2048])
def test_k8_scratch_is_sized_by_its_own_split_policy(fake_lib, width):
    """K8's split policy is the fold's, ``decode_fold.cuh``'s (the constants
    of its source): the grid's split dimension covers every row of at most
    ``width`` pages, the int8 round trip's 2,048-token rows (128 pages) fold
    in 8 splits of 16 pages, and a fake library that answers by that policy
    gets K8 scratch for that many splits and tickets for each."""
    policy = _fold_policy()
    grid = _grid_splits(width, *policy)
    assert grid == max(_row_splits(n, *policy) for n in range(width + 1))
    assert _row_splits(128, *policy) == 8
    fake_lib.splits = lambda w: _grid_splits(w, *policy)
    call, q, _, got_width = _k8(rows=2, width=width, lens=[0, width * BT])
    assert got_width == width
    with _NoDeviceReads():
        call()
    (_, args), = fake_lib.calls
    (scratch, tickets, splits), = fake_lib.scratch
    assert splits == grid and args[-2] == grid and args[-3] == width
    assert fake_lib.split_widths == [width]
    assert scratch.numel() == 2 * grid * H * (D + 2)
    assert tickets.numel() >= 2 * KVH * grid and not tickets.any()
