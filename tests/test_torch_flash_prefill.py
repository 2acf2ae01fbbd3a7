"""The PyTorch port's flash prefill attention
(infinistore_tpu_torch/cuda/flash_prefill.py) against the JAX package's
Pallas kernel in interpret mode and its XLA reference, on the same numpy
inputs. On the CPU the port runs the plain version of kernel K4.

Tolerances: f32 2e-5 (float32 rounding, another summation order); bf16 2e-2
(the TPU kernel rounds the probabilities to bf16 before the PV product, the
plain version does not)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinistore_tpu.tpu.flash_prefill import _flash_prefill_pallas, flash_prefill_xla
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
