"""The PyTorch port's flash prefill attention
(infinistore_tpu_torch/cuda/flash_prefill.py) against the JAX package's
Pallas kernel in interpret mode and its XLA reference, on the same numpy
inputs. On the CPU the port runs the plain version of kernel K4.

Also the CUDA path's dispatch, against a fake kernel library on CPU
tensors: bf16 to the tensor-core entry, f32 to the CUDA-core one, both at
every head_dim of ``_ext.HEAD_DIMS`` (8, 16, 32, 64, 80, 96, 128, 256); any
other dtype or head_dim raised before a launch; and the two launch
counters.

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
    # q, k, v, out, B, S, T, H, KVH, D, causal, stream: the order of its argtypes.
    assert fake_lib.calls == [("its_flash_prefill_wgmma", (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 2, 24, t, 8, 2, d,
        int(causal), _STREAM))]
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
    assert name == "its_flash_prefill_wgmma" and args[9] == 32
    assert out.shape == q.shape
    assert _ext.LAUNCHES["flash_prefill_wgmma"] == 1


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
