"""The PyTorch port's batched paged decode attention
(infinistore_tpu_torch/cuda/paged_attention.py) against the JAX package's
Pallas kernel in interpret mode and its XLA reference, on the same numpy
inputs. On the CPU the port runs the plain version of kernel K3; in f32 the
two agree to 2e-5 (float32 rounding in another summation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinistore_tpu.tpu.paged_attention import (
    _paged_decode_attention_pallas_batched,
    paged_decode_attention_xla_batched,
)
from infinistore_tpu_torch.cuda import paged_attention as pa

TOL = 2e-5


def _inputs(seed, b, h, kvh, d, n, bt, max_blocks, seq_lens):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((n, bt, kvh, d)).astype(np.float32)
    v = rng.standard_normal((n, bt, kvh, d)).astype(np.float32)
    tables = np.stack([rng.permutation(n)[:max_blocks] for _ in range(b)]).astype(np.int32)
    return q, k, v, tables, np.asarray(seq_lens, np.int32)


def _port(q, k, v, tables, lens, dtype=torch.float32):
    return pa.paged_decode_attention_batched(
        *(torch.from_numpy(x).to(dtype) for x in (q, k, v)),
        torch.from_numpy(tables), torch.from_numpy(lens),
    )


@pytest.mark.parametrize("h,kvh", [(4, 4), (4, 2), (8, 2)], ids=["groups1", "groups2", "groups4"])
def test_plain_matches_pallas_interpret(h, kvh):
    bt, d, n, max_blocks = 8, 16, 24, 5
    # Full table, partial last block, one block, a block boundary, zero.
    lens = [max_blocks * bt, 2 * bt + 3, 1, bt, 0]
    q, k, v, tables, lens = _inputs(h * 10 + kvh, len(lens), h, kvh, d, n, bt, max_blocks, lens)
    got = _port(q, k, v, tables, lens).numpy()
    args = [jnp.asarray(x) for x in (q, k, v, tables, lens)]
    want = np.asarray(_paged_decode_attention_pallas_batched(*args, interpret=True))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    want_xla = np.asarray(paged_decode_attention_xla_batched(*args))
    np.testing.assert_allclose(got, want_xla, rtol=TOL, atol=TOL)


def test_padded_table_entries_are_ignored():
    """Entries past seq_len may alias ANY valid block: their contents must
    not reach the output."""
    bt, d, n, h, kvh = 8, 16, 8, 4, 2
    q, k, v, _, _ = _inputs(7, 1, h, kvh, d, n, bt, 4, [0])
    lens = np.asarray([bt + 3], np.int32)  # two blocks in play, second partial
    base = np.asarray([[2, 5, 0, 0]], np.int32)
    alias = np.asarray([[2, 5, 7, 1]], np.int32)
    a = _port(q, k, v, base, lens)
    b = _port(q, k, v, alias, lens)
    assert torch.equal(a, b)
    want = _paged_decode_attention_pallas_batched(
        *(jnp.asarray(x) for x in (q, k, v, alias, lens)), interpret=True
    )
    np.testing.assert_allclose(a.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_zero_length_rows_give_zeros():
    q, k, v, tables, _ = _inputs(3, 2, 4, 2, 16, 8, 8, 3, [0, 0])
    lens = np.asarray([0, 5], np.int32)
    out = _port(q, k, v, tables, lens)
    assert torch.all(out[0] == 0) and torch.isfinite(out).all()
    assert out[1].abs().sum() > 0


def test_single_row_wrapper_matches_batched():
    q, k, v, tables, lens = _inputs(5, 3, 8, 2, 16, 16, 8, 4, [20, 32, 1])
    batched = _port(q, k, v, tables, lens)
    for i in range(3):
        one = pa.paged_decode_attention(
            torch.from_numpy(q[i]), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(tables[i]), int(lens[i]),
        )
        # The same arithmetic, batched by einsum in another order: f32 rounding.
        torch.testing.assert_close(one, batched[i], rtol=1e-6, atol=1e-6)


def test_bf16_matches_jax_reference():
    """bf16 operands: both sides widen to f32 for the logits and the sums and
    round the output to bf16, so they agree to bf16 rounding (2e-2)."""
    q, k, v, tables, lens = _inputs(9, 2, 8, 2, 64, 12, 8, 4, [29, 17])
    got = _port(q, k, v, tables, lens, torch.bfloat16).float().numpy()
    args = [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)]
    want = _paged_decode_attention_pallas_batched(
        *args, jnp.asarray(tables), jnp.asarray(lens), interpret=True
    )
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=2e-2, atol=2e-2)


def test_cuda_path_checks_shapes_before_launch():
    q, k, v, tables, lens = _inputs(1, 1, 4, 2, 16, 8, 8, 2, [5])
    with pytest.raises(ValueError, match="CUDA tensors"):
        pa._paged_decode_attention_cuda(
            *(torch.from_numpy(x) for x in (q, k, v, tables, lens))
        )
