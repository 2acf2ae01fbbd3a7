"""The port's ragged decode attention (infinistore_tpu_torch/cuda/
paged_attention.py: ``build_ragged_wave``, ``paged_decode_attention_ragged``,
``paged_decode_attention_rows``) against the JAX package's: the metadata
``build_ragged_wave`` must give the same int32 arrays, and on the same numpy inputs the
port's plain version of K6 must agree with the JAX ragged Pallas kernel in
interpret mode and with its XLA path (f32 1e-5 and bf16 2e-2, the JAX
package's own tolerances for this kernel). The port's model entries that
ride it, ``verify_step_ragged`` and ``prefill_continue``, are held against
the JAX model on the same weights (f32, 2e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinistore_tpu.models import llama as jl
from infinistore_tpu.tpu import paged_attention as jpa
from infinistore_tpu_torch.cuda import paged_attention as pa
from infinistore_tpu_torch.models import llama as tl

CASES = [
    # (num_blocks, block_tokens, kv_heads, head_dim, q_heads, table_len)
    (16, 8, 4, 16, 8, 8),  # GQA x2
    (32, 16, 2, 32, 8, 16),  # GQA x4
    (8, 8, 8, 16, 8, 4),  # MHA
    (16, 8, 1, 64, 4, 16),  # MQA
]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _meta(tables, lens, bt, **kw):
    return pa.build_ragged_wave(tables, lens, bt, **kw)


def _t(x, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t if dtype is None else t.to(dtype)


def _port_ragged(q, k, v, m, width, dtype=torch.float32):
    return pa.paged_decode_attention_ragged(
        _t(q, dtype), _t(k, dtype), _t(v, dtype),
        m.pages, m.page_rows, m.page_starts, m.seq_lens, table_width=width,
    )


@pytest.mark.parametrize("pad", [{}, {"pad_to": 32}, {"pad_to_pow2": True}],
                         ids=["exact", "pad_to", "pow2"])
def test_build_ragged_wave_matches_jax(pad):
    rng = np.random.default_rng(11)
    bt = 8
    lens = [0, 1, 17, 64, 8, 9, 33]
    tables = [rng.permutation(40)[:8] for _ in lens]
    got = pa.build_ragged_wave(tables, lens, bt, **pad)
    want = jpa.build_ragged_wave(tables, lens, bt, **pad)
    for name in ("pages", "page_rows", "page_starts", "seq_lens"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == np.int32 and b.dtype == np.int32, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (got.pad_pages, got.num_pages, got.num_rows) == (
        want.pad_pages, want.num_pages, want.num_rows)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_matches_pallas_interpret_and_xla(case, dtype):
    """Waves of 1, 3 and 8 rows with skewed seq_lens (a 1-token row beside a
    near-full one): the port's plain K6 against the JAX ragged kernel
    (interpret mode) and the JAX XLA dispatcher."""
    n, bt, kvh, d, h, ntbl = case
    rng = np.random.default_rng(sum(case))
    k = rng.standard_normal((n, bt, kvh, d)).astype(np.float32)
    v = rng.standard_normal((n, bt, kvh, d)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    full = ntbl * bt
    waves = {1: [full], 3: [1, full, full // 2 + 1],
             8: [1, full, 3, full - 1, bt, bt - 1, full // 2, 2]}
    for bsz, lens in waves.items():
        q = rng.standard_normal((bsz, h, d)).astype(np.float32)
        tables = [rng.permutation(n)[:ntbl] for _ in range(bsz)]
        m = _meta(tables, lens, bt)
        got = _port_ragged(q, k, v, m, ntbl, tdt).float().numpy()
        jargs = [jnp.asarray(x).astype(jdt) for x in (q, k, v)]
        jmeta = [jnp.asarray(x) for x in (m.pages, m.page_rows, m.page_starts, m.seq_lens)]
        want = jpa._paged_decode_attention_pallas_ragged(*jargs, *jmeta, interpret=True)
        np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=TOL[dtype],
                                   atol=TOL[dtype], err_msg=f"wave {bsz}")
        want_xla = jpa.paged_decode_attention_ragged(*jargs, *jmeta, table_width=ntbl)
        np.testing.assert_allclose(got, np.asarray(want_xla, np.float32), rtol=TOL[dtype],
                                   atol=TOL[dtype], err_msg=f"wave {bsz} (xla)")


def test_rows_entry_matches_jax_rows():
    """``paged_decode_attention_rows`` (the model's ragged body) with both
    layouts in hand: on the CPU it runs the plain batched version over the
    row tables, as the JAX fallback does; a verification chunk's rows share
    their request's pages."""
    n, bt, kvh, d, h = 24, 8, 2, 16, 8
    rng = np.random.default_rng(5)
    k = rng.standard_normal((n, bt, kvh, d)).astype(np.float32)
    v = rng.standard_normal((n, bt, kvh, d)).astype(np.float32)
    req_tables = np.stack([rng.permutation(n)[:4] for _ in range(2)]).astype(np.int32)
    row_of = np.array([0, 1, 1, 1], np.int32)
    lens = np.array([9, 20, 21, 22], np.int32)
    row_tables = req_tables[row_of]
    m = _meta(list(row_tables), lens, bt, pad_to_pow2=True)
    q = rng.standard_normal((4, h, d)).astype(np.float32)
    got = pa.paged_decode_attention_rows(
        _t(q), _t(k), _t(v), _t(row_tables), _t(lens),
        _t(m.pages), _t(m.page_rows), _t(m.page_starts),
    ).numpy()
    want = jpa.paged_decode_attention_rows(
        *(jnp.asarray(x) for x in (q, k, v, row_tables, lens, m.pages, m.page_rows,
                                   m.page_starts)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    # The flat-list entry over the same wave computes the same rows.
    ragged = _port_ragged(q, k, v, m, 4).numpy()
    np.testing.assert_allclose(ragged, got, rtol=1e-6, atol=1e-6)


def test_ragged_single_request_degenerates_to_batched():
    """A one-row wave is bitwise the batched entry on that row's table."""
    n, bt, kvh, d, h, ntbl = 16, 8, 2, 16, 4, 6
    rng = np.random.default_rng(41)
    k = rng.standard_normal((n, bt, kvh, d)).astype(np.float32)
    v = rng.standard_normal((n, bt, kvh, d)).astype(np.float32)
    q = rng.standard_normal((1, h, d)).astype(np.float32)
    table = rng.permutation(n)[:ntbl].astype(np.int32)
    for sl in (1, bt, ntbl * bt):
        rect = pa.paged_decode_attention_batched(
            _t(q), _t(k), _t(v), _t(table[None]), torch.tensor([sl], dtype=torch.int32))
        rag = _port_ragged(q, k, v, _meta([table], [sl], bt), ntbl)
        assert torch.equal(rect, rag), sl


def test_ragged_padding_pages_are_bitwise_noops():
    n, bt, kvh, d, h = 16, 8, 2, 16, 4
    rng = np.random.default_rng(43)
    k = rng.standard_normal((n, bt, kvh, d)).astype(np.float32)
    v = rng.standard_normal((n, bt, kvh, d)).astype(np.float32)
    q = rng.standard_normal((3, h, d)).astype(np.float32)
    tables = [rng.permutation(n)[:4] for _ in range(3)]
    lens = [9, 30, 17]
    exact = _port_ragged(q, k, v, _meta(tables, lens, bt), 4)
    padded = _port_ragged(q, k, v, _meta(tables, lens, bt, pad_to=16), 4)
    assert torch.equal(exact, padded)


def test_ragged_zero_length_row_returns_zeros():
    n, bt, kvh, d, h = 8, 8, 2, 16, 4
    rng = np.random.default_rng(47)
    k = rng.standard_normal((n, bt, kvh, d)).astype(np.float32)
    v = rng.standard_normal((n, bt, kvh, d)).astype(np.float32)
    q = rng.standard_normal((2, h, d)).astype(np.float32)
    m = _meta([[0, 1], [2, 3]], [0, 5], bt)
    out = _port_ragged(q, k, v, m, 2)
    assert torch.all(out[0] == 0) and torch.isfinite(out).all()
    assert out[1].abs().max() > 0
    want = jpa._paged_decode_attention_pallas_ragged(
        *(jnp.asarray(x) for x in (q, k, v, m.pages, m.page_rows, m.page_starts, m.seq_lens)),
        interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_over_long_row_attends_only_its_own_pages():
    """A row whose seq_len outruns its slice of the flat list attends to the
    pages it owns and no further (the kernel's clamp), as the JAX kernel's
    flat walk does."""
    n, bt, kvh, d, h = 12, 8, 2, 16, 4
    rng = np.random.default_rng(49)
    k = rng.standard_normal((n, bt, kvh, d)).astype(np.float32)
    v = rng.standard_normal((n, bt, kvh, d)).astype(np.float32)
    q = rng.standard_normal((2, h, d)).astype(np.float32)
    m = _meta([[4, 5], [6, 7]], [16, 16], bt)
    m.seq_lens = np.array([40, 16], np.int32)  # row 0 owns 2 pages, asks for 5
    got = _port_ragged(q, k, v, m, 5)
    want = jpa._paged_decode_attention_pallas_ragged(
        *(jnp.asarray(x) for x in (q, k, v, m.pages, m.page_rows, m.page_starts, m.seq_lens)),
        interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_build_ragged_wave_validates_and_cuda_path_checks_before_launch():
    with pytest.raises(ValueError):
        pa.build_ragged_wave([], [], 8)
    with pytest.raises(ValueError):
        pa.build_ragged_wave([[0]], [9], 8)  # needs 2 pages for len 9
    with pytest.raises(ValueError):
        pa.build_ragged_wave([[0, 1], [2]], [16, 3], 8, pad_to=2)
    m = pa.build_ragged_wave([[0, 1], [2]], [16, 3], 8, pad_to=8)
    assert m.num_pages == 8 and m.pad_pages == 5
    assert list(m.page_rows[:3]) == [0, 0, 1]
    assert all(r == 1 for r in m.page_rows[3:8])  # padding rides row 1
    assert m.page_rows[8] == 2  # sentinel
    assert list(m.page_starts) == [0, 2]
    q = torch.zeros(2, 4, 64)
    kc = torch.zeros(4, 8, 2, 64)
    meta = [torch.from_numpy(x) for x in (m.pages, m.page_rows, m.page_starts, m.seq_lens)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        pa._paged_decode_attention_ragged_cuda(q, kc, kc, *meta)


# -- the model's ragged wave and chunked resume -------------------------------

SHAPE = dict(vocab=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
             block_tokens=8)
JCFG = jl.LlamaConfig(dtype=jnp.float32, **SHAPE)
TCFG = tl.LlamaConfig(dtype=torch.float32, **SHAPE)
MODEL_TOL = 2e-4  # f32 logits and caches, as tests/test_torch_llama.py
NUM_BLOCKS, MAX_BLOCKS = 16, 4


@pytest.fixture(scope="module")
def weights():
    jparams = jl.init_params(JCFG, jax.random.PRNGKey(0))
    tparams = tl.params_from_numpy({k: np.asarray(v) for k, v in jparams.items()}, TCFG,
                                   device="cpu")
    return jparams, tparams


def _prefilled(weights, prompts, tables):
    jparams, tparams = weights
    jc = JCFG.kv_spec(NUM_BLOCKS).make_caches()
    tc = TCFG.kv_spec(NUM_BLOCKS).make_caches(device="cpu")
    for p, tab in zip(prompts, tables):
        _, jc = jl.prefill(jparams, jnp.asarray(p), jc, jnp.asarray(tab[:2]), JCFG)
        _, tc = tl.prefill(tparams, p, tc, tab[:2], TCFG)
    return jc, tc


def _close(t, j, what):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=MODEL_TOL, atol=MODEL_TOL,
                               err_msg=what)


def test_verify_step_ragged_matches_jax_on_a_mixed_wave(weights):
    """Two 1-token decode rows beside a 3-token verification chunk, tail
    padded to 8 flat rows and a power-of-two page bucket, as the engine's
    WaveDecoder assembles it."""
    jparams, tparams = weights
    rng = np.random.default_rng(61)
    tables = np.array([[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]], np.int32)
    prompts = [rng.integers(0, SHAPE["vocab"], 16).astype(np.int32) for _ in range(3)]
    jc, tc = _prefilled(weights, prompts, tables)
    toks = [5, 9, 11, 12, 13, 13, 13, 13]
    pos = [16, 16, 17, 18, 16, 16, 16, 16]
    row_of = [0, 1, 1, 1, 2, 2, 2, 2]
    btables = np.concatenate([tables, tables[-1:]])  # B padded to 4
    m = pa.build_ragged_wave([btables[r] for r in row_of], [p + 1 for p in pos],
                             SHAPE["block_tokens"], pad_to_pow2=True)
    jlog, jc = jl.verify_step_ragged(
        jparams, *(jnp.asarray(np.asarray(x, np.int32)) for x in (toks, pos, row_of)),
        jnp.asarray(m.pages), jnp.asarray(m.page_rows), jnp.asarray(m.page_starts), jc,
        jnp.asarray(btables), JCFG, MAX_BLOCKS)
    tlog, tc = tl.verify_step_ragged(
        tparams, toks, pos, row_of, m.pages, m.page_rows, m.page_starts, tc, btables,
        TCFG, MAX_BLOCKS)
    assert tuple(tlog.shape) == (8, SHAPE["vocab"])
    _close(tlog, jlog, "logits")
    for layer in range(SHAPE["n_layers"]):
        for kind in (0, 1):
            _close(tc[layer][kind], jc[layer][kind], f"cache layer {layer} kind {kind}")
    with pytest.raises(ValueError, match="page_starts"):
        tl.verify_step_ragged(tparams, toks, pos, row_of, m.pages, m.page_rows,
                              m.page_starts[:3], tc, btables, TCFG, MAX_BLOCKS)


def test_prefill_continue_matches_jax_and_the_decode_loop(weights):
    jparams, tparams = weights
    rng = np.random.default_rng(67)
    prompt = rng.integers(0, SHAPE["vocab"], 32).astype(np.int32)
    table = np.array([3, 11, 6, 9], np.int32)
    jc, tc = _prefilled(weights, [prompt[:16]], [table])
    jlog, jc = jl.prefill_continue(jparams, jnp.asarray(prompt[16:]), jnp.int32(16), jc,
                                   jnp.asarray(table), JCFG, MAX_BLOCKS)
    tlog, tc = tl.prefill_continue(tparams, prompt[16:], 16, tc, table, TCFG, MAX_BLOCKS)
    assert tuple(tlog.shape) == (16, SHAPE["vocab"])
    _close(tlog, jlog, "logits")
    for layer in range(SHAPE["n_layers"]):
        for kind in (0, 1):
            _close(tc[layer][kind], jc[layer][kind], f"cache layer {layer} kind {kind}")
    # The one-shot prefill of the whole prompt ends on the same logits.
    ref, _ = tl.prefill(tparams, prompt, TCFG.kv_spec(NUM_BLOCKS).make_caches("cpu"), table,
                        TCFG)
    np.testing.assert_allclose(tlog[-1].numpy(), ref.numpy(), rtol=MODEL_TOL, atol=MODEL_TOL)
    with pytest.raises(ValueError, match="max_blocks"):
        tl.prefill_continue(tparams, prompt[16:], 16, tc, table[:3], TCFG, MAX_BLOCKS)
