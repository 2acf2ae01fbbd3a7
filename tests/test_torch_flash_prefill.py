"""The PyTorch port's flash prefill attention
(infinistore_tpu_torch/cuda/flash_prefill.py) against the JAX package's
Pallas kernel in interpret mode and its XLA reference, on the same numpy
inputs. On the CPU the port runs the plain version of kernel K4.

Also the CUDA path's dispatch, against a fake kernel library on CPU
tensors: bf16 to the tensor-core entry, f32 to the CUDA-core one, both at
every head_dim of ``_ext.HEAD_DIMS`` (8, 16, 32, 64, 80, 96, 128, 256); any
other dtype or head_dim raised before a launch; and the two launch
counters. bf16 at head_dim 256 splits its heaviest query tiles over keys:
its work plan (``wgmma_split`` / ``wgmma_items``, which the kernel computes
alike) covers every (batch, head, query tile, key tile) once, the same for
every batch size, and the wrapper hands the kernel a merge workspace of the
plan's size. The plain version also meets the Pallas kernel at lengths that
are no multiple of the kernels' tiles (64 and 128 rows, 64 and 80 keys).

Tolerances: f32 2e-5 (float32 rounding, another summation order); bf16 2e-2
(the TPU kernel rounds the probabilities to bf16 before the PV product, the
plain version does not)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinistore_tpu.tpu.flash_prefill import _flash_prefill_pallas, flash_prefill_xla
from infinistore_tpu_torch.cuda import _ext
from infinistore_tpu_torch.cuda import flash_prefill as fp


def _inputs(seed, b, s, h, kvh, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("s", [8, 24, 40])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_plain_matches_pallas_interpret_f32(s, causal):
    q, k, v = _inputs(s, 1, s, 4, 2, 16)  # GQA x2
    got = fp.flash_prefill_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal
    ).numpy()
    qj, kj, vj = (jnp.asarray(x) for x in (q, k, v))
    want = _flash_prefill_pallas(qj, kj, vj, causal=causal, block_q=16, block_k=8, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)
    want_xla = flash_prefill_xla(qj, kj, vj, causal=causal)
    np.testing.assert_allclose(got, np.asarray(want_xla), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("s", [8, 24, 40])
def test_plain_matches_pallas_interpret_bf16(s):
    q, k, v = _inputs(100 + s, 2, s, 8, 2, 32)  # batch 2, GQA x4
    got = fp.flash_prefill_attention(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)), causal=True
    )
    assert got.dtype == torch.bfloat16
    qj, kj, vj = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    want = _flash_prefill_pallas(qj, kj, vj, causal=True, block_q=16, block_k=16, interpret=True)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=2e-2, atol=2e-2
    )


def test_causal_requires_equal_lengths():
    q, k, v = _inputs(1, 1, 8, 4, 2, 16)
    qt = torch.from_numpy(q[:, :4].copy())
    with pytest.raises(ValueError, match="S must equal T"):
        fp.flash_prefill_attention(qt, torch.from_numpy(k), torch.from_numpy(v), causal=True)
    # Non-causal attention over a longer context is fine.
    out = fp.flash_prefill_attention(qt, torch.from_numpy(k), torch.from_numpy(v), causal=False)
    assert tuple(out.shape) == (1, 4, 4, 16)


# Lengths off every tile of the two kernels (f32: 128 query rows, 64 at
# head_dim 256, and 64 keys; bf16 at 256: 128 rows and 80 keys, and from
# 561 tokens the key split), at the head_dims of the f32 kernel's two
# layouts.
@pytest.mark.parametrize("s", [81, 200, 600])
@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_plain_matches_pallas_interpret_at_ragged_tiles(s, d, dtype, causal):
    q, k, v = _inputs(200 + s + d, 1, s, 2, 1, d)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = fp.flash_prefill_plain(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                                 causal=causal)
    assert got.dtype == tdt
    want = _flash_prefill_pallas(*(jnp.asarray(x).astype(jdt) for x in (q, k, v)),
                                 causal=causal, block_q=64, block_k=80, interpret=True)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _n_key_tiles(s, t, causal, qt):
    n_all = -(-t // fp._SPLIT_KEYS)
    if not causal:
        return n_all
    return min(n_all, (min((qt + 1) * fp._SPLIT_ROWS, s) - 1) // fp._SPLIT_KEYS + 1)


@pytest.mark.parametrize("s,t,causal,h", [(1, 1, True, 8), (24, 24, True, 8), (200, 200, True, 8),
                                          (560, 560, True, 8), (561, 561, True, 8),
                                          (1024, 1024, True, 8), (2047, 2047, True, 8),
                                          (2048, 2048, True, 8), (2048, 2048, True, 16),
                                          (4000, 4000, True, 3), (129, 1000, False, 8),
                                          (300, 2100, False, 8), (2048, 640, False, 1)])
def test_wgmma_items_cover_every_query_and_key_tile_once(s, t, causal, h):
    """bf16 K4's plan at head_dim 256: over a launch of B x H (batch,
    head) pairs, item i is ``wgmma_items[i // (B * H)]`` of pair
    ``i % (B * H)``; every pair gets every (query tile, key tile) it needs
    exactly once, in the same items in the same order whatever B is, split
    tiles in two parts of at most C key tiles each, and one merge slot per
    split tile."""
    items = fp.wgmma_items(s, t, causal, h)
    n_qt, c, q_s = fp.wgmma_split(s, t, causal, h)
    assert len(items) == 2 * n_qt - q_s
    for b in (1, 4):
        bh = b * 3
        order = [(i % bh, items[i // bh]) for i in range(len(items) * bh)]
        for pair in range(bh):
            assert [item for p, item in order if p == pair] == items
        covered = {}
        for pair, (qt, kt0, kt1, chunk) in order:
            for kt in range(kt0, kt1):
                key = (pair, qt, kt)
                covered[key] = covered.get(key, 0) + 1
        want = {(pair, qt, kt) for pair in range(bh) for qt in range(n_qt)
                for kt in range(_n_key_tiles(s, t, causal, qt))}
        assert set(covered) == want
        assert set(covered.values()) == {1}
    chunks = {}
    for qt, kt0, kt1, chunk in items:
        chunks.setdefault(qt, []).append((chunk, kt0, kt1))
    for qt, parts in chunks.items():
        if qt >= q_s:  # split: keys [0, C) then [C, n)
            assert sorted(parts, key=lambda p: p[0]) == [
                (0, 0, c), (1, c, _n_key_tiles(s, t, causal, qt))]
            assert c < _n_key_tiles(s, t, causal, qt) <= 2 * c
        else:
            assert parts == [(None, 0, _n_key_tiles(s, t, causal, qt))]
            assert _n_key_tiles(s, t, causal, qt) <= c or q_s == n_qt
    # Heaviest first: the first C-tile parts, then no part heavier than C,
    # each no heavier than the one before.
    sizes = [kt1 - kt0 for _, kt0, kt1, _ in items]
    assert max(sizes) == c and sizes[: n_qt - q_s] == [c] * (n_qt - q_s)
    assert sizes == sorted(sizes, reverse=True)


def test_wgmma_split_at_gemma_2b_prompt():
    """One 2,048-token prompt over Gemma-2B's 8 heads: 16 query tiles, the
    last needs 26 key tiles of 80; tiles 8-15 split at 14, so no item needs
    more than 14 key tiles (it was 32 of 64 keys, the whole last tile). No
    split under 2 x 4 key tiles, nor with 16 heads (256 query tiles)."""
    assert fp.wgmma_split(2048, 2048, True, 8) == (16, 14, 8)
    assert len(fp.wgmma_items(2048, 2048, True, 8)) == 24
    assert fp.wgmma_split(500, 500, True, 8) == (4, 7, 4)
    assert fp.wgmma_split(2048, 2048, True, 16) == (16, 26, 16)


def test_cuda_path_refuses_cpu_tensors():
    q, k, v = _inputs(2, 1, 8, 4, 2, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fp._flash_prefill_cuda(*(torch.from_numpy(x) for x in (q, k, v)), causal=True)


# The CUDA path's dispatch, on CPU tensors, against a fake kernel library
# that records its calls: which entry each dtype reaches, with which
# arguments, and which counters move.

_STREAM = 0x5EED


class _FakeLib:
    def __init__(self, code=0):
        self.calls = []
        self.code = code

    def _entry(self, name):
        def call(*args):
            argtypes = _ext.ARGTYPES[name]
            assert len(args) == len(argtypes), (name, args)
            for kind, arg in zip(argtypes, args):
                kind(arg)  # each argument converts to the C type declared for it
            self.calls.append((name, args))
            return self.code
        return call

    def __getattr__(self, name):
        if name not in _ext.ARGTYPES:
            raise AttributeError(name)
        return self._entry(name)


@pytest.fixture()
def fake_lib(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(_ext, "kernels", lambda: lib)
    monkeypatch.setattr(_ext, "require_cuda", lambda name, device, **tensors: None)
    monkeypatch.setattr(_ext, "stream_of", lambda t: _STREAM)
    monkeypatch.setattr(_ext, "LAUNCHES", dict.fromkeys(_ext.LAUNCHES, 0))
    return lib


def _torch_inputs(dtype, b=2, s=24, t=24, h=8, kvh=2, d=64):
    rng = np.random.default_rng(7)
    return tuple(
        torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
        for shape in ((b, s, h, d), (b, t, kvh, d), (b, t, kvh, d))
    )


@pytest.mark.parametrize("d", _ext.HEAD_DIMS)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_bf16_reaches_the_tensor_core_entry(fake_lib, d, causal):
    t = 24 if causal else 40
    q, k, v = _torch_inputs(torch.bfloat16, t=t, d=d)
    out = fp._flash_prefill_cuda(q, k, v, causal=causal)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    # q, k, v, out, scratch, tickets, B, S, T, H, KVH, D, causal, slots,
    # stream: the order of its argtypes; no split at 24 queries.
    assert fake_lib.calls == [("its_flash_prefill_wgmma", (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, None, 2, 24, t, 8, 2,
        d, int(causal), 0, _STREAM))]
    assert _ext.LAUNCHES["flash_prefill"] == 1
    assert _ext.LAUNCHES["flash_prefill_wgmma"] == 1


@pytest.mark.parametrize("d", _ext.HEAD_DIMS)
def test_f32_reaches_the_cuda_core_entry(fake_lib, d):
    q, k, v = _torch_inputs(torch.float32, d=d)
    out = fp._flash_prefill_cuda(q, k, v, causal=True)
    assert fake_lib.calls == [("its_flash_prefill", (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 2, 24, 24, 8, 2, d, 1,
        _STREAM))]
    assert _ext.LAUNCHES["flash_prefill"] == 1
    assert _ext.LAUNCHES["flash_prefill_wgmma"] == 0


def test_bf16_d32_launches_the_tensor_core_entry_with_d32(fake_lib):
    """head_dim 32 in bf16, once refused, takes the tensor-core kernel:
    the route is by dtype alone, at every head_dim."""
    q, k, v = _torch_inputs(torch.bfloat16, d=32)
    out = fp._flash_prefill_cuda(q, k, v, causal=True)
    (name, args), = fake_lib.calls
    assert name == "its_flash_prefill_wgmma" and args[11] == 32
    assert out.shape == q.shape
    assert _ext.LAUNCHES["flash_prefill_wgmma"] == 1


@pytest.mark.parametrize("s,t,causal", [(1024, 1024, True), (300, 2100, False)])
def test_bf16_d256_takes_a_merge_workspace_of_its_plan(fake_lib, s, t, causal):
    """At head_dim 256 the wrapper passes the stream's split workspace: one
    merge slot (two warpgroups x 128 threads x 132 f32) and two zero
    tickets per split query tile and (batch, head); other head_dims and f32
    pass none."""
    q, k, v = _torch_inputs(torch.bfloat16, b=2, s=s, t=t, h=4, kvh=1, d=256)
    fp._flash_prefill_cuda(q, k, v, causal=causal)
    (name, args), = fake_lib.calls
    n_qt, _, q_s = fp.wgmma_split(s, t, causal, 4)
    slots = (n_qt - q_s) * 2 * 4
    assert slots > 0 and args[13] == slots
    scratch, tickets = _ext.split_workspace(q.device, _STREAM, 0, 0)
    assert args[4] == scratch.data_ptr() and args[5] == tickets.data_ptr()
    assert scratch.numel() >= slots * 2 * 128 * 132 and scratch.dtype == torch.float32
    assert tickets.numel() >= 2 * slots and int(tickets.abs().sum()) == 0
    for dtype, d in ((torch.bfloat16, 128), (torch.float32, 256)):
        fake_lib.calls.clear()
        fp._flash_prefill_cuda(*_torch_inputs(dtype, s=s, t=t, d=d), causal=causal)
        (name, args), = fake_lib.calls
        assert (args[4], args[5], args[13]) == (None, None, 0) if dtype == torch.bfloat16 \
            else len(args) == 12


def test_counters_add_up_over_mixed_calls(fake_lib):
    for dtype in (torch.bfloat16, torch.float32, torch.bfloat16):
        fp._flash_prefill_cuda(*_torch_inputs(dtype), causal=True)
    assert [name for name, _ in fake_lib.calls] == [
        "its_flash_prefill_wgmma", "its_flash_prefill", "its_flash_prefill_wgmma"]
    assert _ext.LAUNCHES["flash_prefill"] == 3
    assert _ext.LAUNCHES["flash_prefill_wgmma"] == 2


# The ids keep their names from when 80, 96 and 256 were refused; the cases
# hold 72, 112 and 512, which are.
@pytest.mark.parametrize("dtype,d,error,match", [
    (torch.float16, 64, TypeError, "unsupported dtype"),
    (torch.float64, 128, TypeError, "unsupported dtype"),
    (torch.bfloat16, 72, ValueError, "head_dim 8, 16, 32, 64, 80, 96, 128 or 256"),
    (torch.bfloat16, 112, ValueError, "head_dim 8, 16, 32, 64, 80, 96, 128 or 256"),
    (torch.float32, 512, ValueError, "head_dim 8, 16, 32, 64, 80, 96, 128 or 256"),
], ids=["f16", "f64", "bf16-d80", "bf16-d96", "f32-d256"])
def test_unsupported_dtype_or_head_dim_raises_before_any_launch(fake_lib, dtype, d, error,
                                                                match):
    with pytest.raises(error, match=match):
        fp._flash_prefill_cuda(*_torch_inputs(dtype, d=d), causal=True)
    assert fake_lib.calls == []
    assert _ext.LAUNCHES["flash_prefill"] == 0
    assert _ext.LAUNCHES["flash_prefill_wgmma"] == 0


def test_misaligned_bf16_input_raises_before_any_launch(fake_lib):
    q, k, v = _torch_inputs(torch.bfloat16)
    shifted = torch.empty(q.numel() + 1, dtype=torch.bfloat16)[1:].view(q.shape)
    shifted.copy_(q)  # contiguous, 2 bytes off a 16-byte boundary (TMA needs 16)
    with pytest.raises(ValueError, match="16-byte"):
        fp._flash_prefill_cuda(shifted, k, v, causal=True)
    assert fake_lib.calls == []


@pytest.mark.parametrize("code,match", [(700, "CUDA error 700"),
                                        (-1, "tensor-map encode failed")],
                         ids=["launch", "encode"])
def test_a_failed_launch_raises_and_nothing_falls_back(fake_lib, code, match):
    fake_lib.code = code
    with pytest.raises(RuntimeError, match=match):
        fp._flash_prefill_cuda(*_torch_inputs(torch.bfloat16), causal=True)
    # The one call went to the tensor-core entry; nothing else was tried.
    assert [name for name, _ in fake_lib.calls] == ["its_flash_prefill_wgmma"]
