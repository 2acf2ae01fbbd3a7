"""The PyTorch port's model (infinistore_tpu_torch/models/llama.py) against
the JAX package's on the same weights: the JAX ``init_params`` output is
carried across with ``params_from_numpy``, and prefill / batched decode
logits and caches must agree (f32: 2e-4, the tolerance the JAX package's own
paged-decode == prefill pins use). On the CPU the port runs the plain
versions of its kernels; the JAX side runs its XLA paths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinistore_tpu.models import llama as jl
from infinistore_tpu_torch.models import llama as tl

TOL = 2e-4
SHAPE = dict(vocab=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
             block_tokens=8)
JCFG = jl.LlamaConfig(dtype=jnp.float32, **SHAPE)
TCFG = tl.LlamaConfig(dtype=torch.float32, **SHAPE)
NUM_BLOCKS = 16
MAX_BLOCKS = 4


@pytest.fixture(scope="module")
def weights():
    jparams = jl.init_params(JCFG, jax.random.PRNGKey(0))
    tparams = tl.params_from_numpy({k: np.asarray(v) for k, v in jparams.items()}, TCFG, device="cpu")
    return jparams, tparams


def _caches():
    return (JCFG.kv_spec(NUM_BLOCKS).make_caches(),
            TCFG.kv_spec(NUM_BLOCKS).make_caches(device="cpu"))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_prefill_logits_and_caches_match_jax(weights):
    jparams, tparams = weights
    tokens = np.random.default_rng(1).integers(0, SHAPE["vocab"], 24).astype(np.int32)
    table = np.array([3, 11, 6], np.int32)
    jc, tc = _caches()
    jlogits, jc = jl.prefill(jparams, jnp.asarray(tokens), jc, jnp.asarray(table), JCFG)
    tlogits, tc = tl.prefill(tparams, tokens, tc, table, TCFG)
    assert tuple(tlogits.shape) == (SHAPE["vocab"],)
    np.testing.assert_allclose(_np(tlogits), _np(jlogits), rtol=TOL, atol=TOL)
    for layer in range(SHAPE["n_layers"]):
        for kind in (0, 1):
            np.testing.assert_allclose(_np(tc[layer][kind]), _np(jc[layer][kind]), rtol=TOL, atol=TOL)


def test_decode_step_batched_matches_jax(weights):
    """A wave of two requests over a shared cache, three greedy steps."""
    jparams, tparams = weights
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, SHAPE["vocab"], 16).astype(np.int32) for _ in range(2)]
    tables = np.array([[0, 1, 2, 3], [8, 5, 9, 14]], np.int32)
    jc, tc = _caches()
    first = []
    for p, table in zip(prompts, tables):
        jlog, jc = jl.prefill(jparams, jnp.asarray(p), jc, jnp.asarray(table[:2]), JCFG)
        _, tc = tl.prefill(tparams, p, tc, table[:2], TCFG)
        first.append(int(jnp.argmax(jlog)))
    tokens = np.asarray(first, np.int32)
    for step in range(3):
        pos = np.full(2, 16 + step, np.int32)
        jlog, jc = jl.decode_step_batched(jparams, jnp.asarray(tokens), jnp.asarray(pos), jc,
                                          jnp.asarray(tables), JCFG, MAX_BLOCKS)
        tlog, tc = tl.decode_step_batched(tparams, tokens, pos, tc, tables, TCFG, MAX_BLOCKS)
        assert tuple(tlog.shape) == (2, SHAPE["vocab"])
        np.testing.assert_allclose(_np(tlog), _np(jlog), rtol=TOL, atol=TOL, err_msg=f"step {step}")
        tokens = np.array(jnp.argmax(jlog, axis=-1), np.int32)


def test_decode_matches_prefill(weights):
    """Paged incremental decode must reproduce full-prefill logits (the
    port's mirror of the JAX package's pin of the same name)."""
    _, tparams = weights
    full = np.random.default_rng(3).integers(0, SHAPE["vocab"], 24)
    table = np.array([0, 1, 2, 3], np.int32)
    spec = TCFG.kv_spec(NUM_BLOCKS)
    ref_logits, _ = tl.prefill(tparams, full, spec.make_caches("cpu"), table[:3], TCFG)
    logits, caches = tl.prefill(tparams, full[:16], spec.make_caches("cpu"), table[:2], TCFG)
    for pos in range(16, 24):
        logits, caches = tl.decode_step(tparams, full[pos], pos, caches, table, TCFG, MAX_BLOCKS)
    np.testing.assert_allclose(_np(logits), _np(ref_logits), rtol=TOL, atol=TOL)


def test_bf16_prefill_and_decode_match_jax():
    """bf16 weights and activations: the two frameworks round at slightly
    different places (silu, the rope product, matmul summation order on the
    CPU), so logits agree at bf16's scale — 6e-2 on logits of magnitude ~1,
    a few bf16 ulps — not f32's."""
    jcfg = jl.LlamaConfig(dtype=jnp.bfloat16, **SHAPE)
    tcfg = tl.LlamaConfig(dtype=torch.bfloat16, **SHAPE)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(4))
    tparams = tl.params_from_numpy({k: np.asarray(v) for k, v in jparams.items()}, tcfg, device="cpu")
    tokens = np.random.default_rng(5).integers(0, SHAPE["vocab"], 16).astype(np.int32)
    table = np.array([2, 7], np.int32)
    jlog, jc = jl.prefill(jparams, jnp.asarray(tokens), jcfg.kv_spec(NUM_BLOCKS).make_caches(),
                          jnp.asarray(table), jcfg)
    tlog, tc = tl.prefill(tparams, tokens, tcfg.kv_spec(NUM_BLOCKS).make_caches("cpu"), table, tcfg)
    np.testing.assert_allclose(tlog.float().numpy(), np.asarray(jlog, np.float32), rtol=6e-2, atol=6e-2)
    full_table = np.array([2, 7, 4, 5], np.int32)
    tok = int(jnp.argmax(jlog))
    jlog, _ = jl.decode_step(jparams, jnp.int32(tok), jnp.int32(16), jc, jnp.asarray(full_table),
                             jcfg, MAX_BLOCKS)
    tlog, _ = tl.decode_step(tparams, tok, 16, tc, full_table, tcfg, MAX_BLOCKS)
    np.testing.assert_allclose(tlog.float().numpy(), np.asarray(jlog, np.float32), rtol=6e-2, atol=6e-2)


def test_params_from_numpy_keeps_bf16_bits():
    jcfg = jl.LlamaConfig(dtype=jnp.bfloat16, **SHAPE)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(6))
    tparams = tl.params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()},
        tl.LlamaConfig(dtype=torch.bfloat16, **SHAPE), device="cpu",
    )
    for name, arr in jparams.items():
        t = tparams[name]
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == arr.shape
        assert t.view(torch.int16).numpy().tobytes() == np.asarray(arr).tobytes(), name


def test_init_params_is_seeded_and_shaped():
    a = tl.init_params(TCFG, torch.Generator().manual_seed(7), device="cpu")
    b = tl.init_params(TCFG, torch.Generator().manual_seed(7), device="cpu")
    jshapes = {k: v.shape for k, v in jl.init_params(JCFG, jax.random.PRNGKey(0)).items()}
    assert {k: tuple(v.shape) for k, v in a.items()} == jshapes
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(v.dtype == torch.float32 for v in a.values())


def test_moe_and_bad_tables_raise(weights):
    _, tparams = weights
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tl.init_params(tl.LlamaConfig(n_experts=2), torch.Generator(), device="cpu")
    with pytest.raises(ValueError, match="max_blocks"):
        tl.decode_step(tparams, 1, 3, TCFG.kv_spec(NUM_BLOCKS).make_caches("cpu"),
                       np.zeros(3, np.int32), TCFG, MAX_BLOCKS)
    with pytest.raises(ValueError, match="block_tokens"):
        tl.prefill(tparams, np.zeros(12, np.int32), TCFG.kv_spec(NUM_BLOCKS).make_caches("cpu"),
                   np.zeros(1, np.int32), TCFG)
