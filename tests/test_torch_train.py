"""The port's training path (infinistore_tpu_torch/models/llama.py
``loss_fn`` / ``train_step``) against the JAX package's on the same
weights and tokens.

The JAX ``init_params`` output is carried across with ``params_from_numpy``
and the tokens come from a numpy seed. f32: the loss within 1e-5 of JAX's,
every gradient within 1e-4 of its largest magnitude (``jax.value_and_grad``
of the JAX ``loss_fn``), ``train_step``'s new parameters within 1e-6 of the
JAX step's; bf16: the loss within 2e-2; the soft mixture of experts: loss,
gradients and new parameters within 2e-4. The mirror of
tests/test_model_disagg.py:206 (``test_train_step_runs``). Also: no kernel
entry drops a gradient (an input that requires grad is refused under grad
mode; the CPU routes stay differentiable), and a CPU rehearsal of
``chip_smoke.py``'s train path at a tiny width (its parallel_train path is
rehearsed in tests/test_torch_expert_parallel.py)."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinistore_tpu.models import llama as jl
from infinistore_tpu_torch.models import llama as tl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = dict(vocab=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
             block_tokens=8)
TOKENS = (4, 32)
# The chip script's paths at a tiny width (head_dim 64, as elsewhere).
REHEARSAL = dict(vocab=256, dim=256, n_layers=4, n_heads=4, n_kv_heads=2, ffn_dim=256,
                 block_tokens=16)


def _configs(dtype, n_experts=0):
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return (jl.LlamaConfig(dtype=jdt, n_experts=n_experts, **SHAPE),
            tl.LlamaConfig(dtype=tdt, n_experts=n_experts, **SHAPE))


def _weights(jcfg, tcfg, seed=0):
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(seed))
    return jparams, tl.params_from_numpy({k: np.asarray(v) for k, v in jparams.items()}, tcfg,
                                         device="cpu")


def _tokens(seed=3):
    return np.random.default_rng(seed).integers(0, SHAPE["vocab"], TOKENS).astype(np.int32)


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("n_experts,tol", [(0, 1e-5), (4, 2e-4)], ids=["dense", "moe"])
def test_loss_matches_jax(n_experts, tol):
    jcfg, tcfg = _configs("f32", n_experts)
    jparams, tparams = _weights(jcfg, tcfg)
    tokens = _tokens()
    want = float(jl.loss_fn(jparams, jnp.asarray(tokens), jcfg))
    got = tl.loss_fn(tparams, tokens, tcfg)
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) <= tol, (float(got), want)


@pytest.mark.parametrize("n_experts,tol", [(0, 1e-4), (4, 2e-4)], ids=["dense", "moe"])
def test_gradients_match_jax(n_experts, tol):
    """Every parameter's gradient within ``tol`` of its largest magnitude
    (``jax.value_and_grad`` of the JAX loss_fn); the soft mixture
    differentiates like the dense FFN."""
    jcfg, tcfg = _configs("f32", n_experts)
    jparams, tparams = _weights(jcfg, tcfg)
    tokens = _tokens()
    jloss, jgrads = jax.value_and_grad(jl.loss_fn)(jparams, jnp.asarray(tokens), jcfg)
    loss, grads = tl._loss_and_grads(tparams, lambda p: tl.loss_fn(p, tokens, tcfg))
    assert abs(float(loss) - float(jloss)) <= tol
    assert set(grads) == set(jgrads)
    for name, want in jgrads.items():
        want = np.asarray(want)
        scale = np.abs(want).max()
        assert scale > 0, name
        err = np.abs(_f32(grads[name]) - want).max()
        assert err <= tol * scale, (name, err, scale)


@pytest.mark.parametrize("n_experts,tol", [(0, 1e-6), (4, 2e-4)], ids=["dense", "moe"])
def test_train_step_matches_jax(n_experts, tol):
    """One SGD step: the loss and every new parameter; the port updates in
    place and hands back the same dict."""
    jcfg, tcfg = _configs("f32", n_experts)
    jparams, tparams = _weights(jcfg, tcfg, seed=1)
    tokens = _tokens(4)
    jnew, jloss = jl.train_step(jax.tree.map(jnp.copy, jparams), jnp.asarray(tokens), jcfg)
    before = {k: v.data_ptr() for k, v in tparams.items()}
    new, loss = tl.train_step(tparams, tokens, tcfg)
    assert new is tparams and {k: v.data_ptr() for k, v in new.items()} == before
    assert not any(v.requires_grad for v in new.values())
    assert abs(float(loss) - float(jloss)) <= max(tol, 1e-5)
    for name, want in jnew.items():
        np.testing.assert_allclose(_f32(new[name]), np.asarray(want), rtol=tol, atol=tol,
                                   err_msg=name)


def test_bf16_loss_and_step_match_jax():
    """bf16 weights: the loss within 2e-2 of JAX's (logits, softmax
    statistics and the NLL are f32 in both; activations round to bf16 at
    other places), and the step keeps the parameters' dtype."""
    jcfg, tcfg = _configs("bf16")
    jparams, tparams = _weights(jcfg, tcfg)
    tokens = _tokens()
    want = float(jl.loss_fn(jparams, jnp.asarray(tokens), jcfg))
    assert abs(float(tl.loss_fn(tparams, tokens, tcfg)) - want) <= 2e-2
    new, loss = tl.train_step(tparams, tokens, tcfg)
    assert abs(float(loss) - want) <= 2e-2
    assert all(v.dtype == torch.bfloat16 for v in new.values())


def test_train_step_runs():
    """The mirror of tests/test_model_disagg.py:206: a step on a copy of the
    weights gives a finite loss, and the parameters move."""
    _, tcfg = _configs("f32")
    params = tl.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = np.random.default_rng(4).integers(0, SHAPE["vocab"], TOKENS)
    new, loss = tl.train_step({k: v.clone() for k, v in params.items()}, tokens, tcfg)
    assert np.isfinite(float(loss))
    assert any(not torch.equal(params[k], new[k]) for k in params)


def test_kernel_entries_refuse_inputs_that_require_grad():
    """A kernel's output carries no gradient, so every CUDA route refuses an
    input that requires grad under grad mode (``_ext.require_cuda`` calls
    ``refuse_grad`` first, before any device check), naming the dense path
    that training takes; under ``no_grad``, or for inputs that do not
    require grad, nothing is refused. The CPU routes are the plain versions
    and stay differentiable."""
    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.cuda.flash_prefill import flash_prefill_attention
    from infinistore_tpu_torch.cuda.paged_attention import paged_decode_attention_batched

    x = torch.zeros(2, 4, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad.*loss_fn"):
        _ext.refuse_grad("flash_prefill_attention", q=x)
    with pytest.raises(RuntimeError, match="flash_prefill_attention: q requires grad"):
        _ext.require_cuda("flash_prefill_attention", torch.device("cuda", 0), q=x)
    with torch.no_grad():
        _ext.refuse_grad("flash_prefill_attention", q=x)
    _ext.refuse_grad("flash_prefill_attention", q=x.detach())

    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 16, h, 64)).astype(np.float32))
               .requires_grad_() for h in (4, 2, 2))
    flash_prefill_attention(q, k, v, causal=True).square().sum().backward()
    assert all(t.grad is not None and bool(t.grad.abs().sum() > 0) for t in (q, k, v))
    cache = torch.from_numpy(rng.standard_normal((4, 8, 2, 64)).astype(np.float32))
    kc, vc = cache.clone().requires_grad_(), cache.clone().requires_grad_()
    qd = torch.from_numpy(rng.standard_normal((2, 4, 64)).astype(np.float32)).requires_grad_()
    out = paged_decode_attention_batched(qd, kc, vc, torch.tensor([[0, 1], [2, 3]], dtype=torch.int32),
                                         torch.tensor([9, 16], dtype=torch.int32))
    out.square().sum().backward()
    assert all(t.grad is not None for t in (qd, kc, vc))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_train_rehearsal_on_cpu():
    """``chip_smoke.py``'s train path (phase 16) at a tiny width on the CPU:
    the bf16 step against f32 with its planted faults outside the bound,
    the f32 loss falling over two steps, the small model's step, no kernel
    launched."""
    chip_smoke = _chip_smoke()
    metrics, launches = chip_smoke._run_train(torch, device="cpu", geometry=REHEARSAL,
                                              batch=2, tokens=64)
    assert not any(launches.values()), launches
    assert metrics["grad_rel_err"]["sound"] <= chip_smoke.TRAIN_GRAD_TOL
    assert min(metrics["grad_rel_err"][f] for f in chip_smoke.TRAIN_FAULTS) > chip_smoke.TRAIN_GRAD_TOL
    assert metrics["f32_losses"][1] < metrics["f32_losses"][0]
