"""The port's ring and Ulysses attention (infinistore_tpu_torch/models/
ring_attention.py, ulysses.py) against the JAX package's, forward and
gradients, on the same numpy inputs.

Mirrors tests/test_ring_attention.py: the ring at 2, 4 and 8 ranks, causal
and full; bf16 inputs with f32 accumulation; Ulysses against the dense
oracle at 2 and 4 ranks, and against the ring; the gradients of the ring
(2, 4 and 8 ranks) and of Ulysses (2 and 4) against ``jax.grad`` of the JAX
entry points and of the dense oracle (3e-6, the JAX tests' bound). Each
world size runs once, as gloo ranks, each a process of its own passing its
sequence chunk (a module-scoped fixture per world size); the concatenated
chunks are held within 1e-5 (f32) of the JAX entry points on a sub-mesh of
the 8-device CPU mesh. Each rank backpropagates its own share of the loss
(its chunk's sum of squares over the global element count), so the
concatenated input gradients are the gradients of the global loss. jax is
imported by this process only: the rank processes import this module to
find their entry, and stay free of it."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
RANK_TIMEOUT_S = 180
B, S, H, D = 2, 32, 4, 16
TOL = 1e-5
GRAD_TOL = 3e-6


def spawn_ranks(tmp, world, module, entry, *args):
    """Run ``module.entry(world, rank, init_file, *args)`` in ``world``
    processes, one gloo rank each (FileStore init, loopback sockets, a
    timeout on every join); raises with a failing rank's output."""
    init_file = str(tmp / f"filestore{world}")
    env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo",
               PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    procs = []
    for rank in range(world):
        code = (f"import sys; sys.path.insert(0, {HERE!r}); import {module} as t; "
                f"t.{entry}({world}, {rank}, {init_file!r}, *{args!r})")
        procs.append(subprocess.Popen([sys.executable, "-c", code], env=env, cwd=REPO,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = []
    try:
        for proc in procs:
            out, _ = proc.communicate(timeout=RANK_TIMEOUT_S)
            logs.append((proc.returncode, out.decode(errors="replace")))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    failed = [log for rc, log in logs if rc != 0]
    assert not failed, failed[0][-3000:]


def _qkv():
    rng = np.random.default_rng(0)
    return tuple(rng.standard_normal((B, S, H, D)).astype(np.float32) for _ in range(3))


def _grads(name, attention, q, k, v):
    """This rank's gradients of the global mean of squares of the causal
    output, keyed ``{name}_grad_{q,k,v}``."""
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    (attention(*leaves, causal=True).square().sum() / (B * S * H * D)).backward()
    return {f"{name}_grad_{x}": t.grad.numpy() for x, t in zip("qkv", leaves)}


def _rank_main(world, rank, init_file, out_path):
    """One gloo rank: its chunk through every forward case of its world
    size."""
    import torch.distributed as dist

    from infinistore_tpu_torch.models.ring_attention import ring_attention
    from infinistore_tpu_torch.models.ulysses import ulysses_attention

    s_loc = S // world
    q, k, v = (torch.from_numpy(x[:, rank * s_loc:(rank + 1) * s_loc].copy()) for x in _qkv())
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        out = {f"ring_{c}": ring_attention(q, k, v, causal=c).numpy() for c in (True, False)}
        bf = [t.to(torch.bfloat16) for t in (q, k, v)]
        out["ring_bf16"] = ring_attention(*bf).float().numpy()
        out.update(_grads("ring", ring_attention, q, k, v))
        if H % world == 0:
            for c in (True, False):
                out[f"ulysses_{c}"] = ulysses_attention(q, k, v, causal=c).numpy()
            out.update(_grads("ulysses", ulysses_attention, q, k, v))
        else:
            try:
                ulysses_attention(q, k, v)
            except ValueError as exc:
                out["ulysses_refused"] = np.array(str(exc))
        np.savez(f"{out_path}{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module", params=[2, 4, 8])
def ranks(request, tmp_path_factory):
    """Every case at one world size; returns (world, outputs concatenated
    over the ranks' chunks)."""
    world = request.param
    tmp = tmp_path_factory.mktemp(f"ring{world}")
    spawn_ranks(tmp, world, "test_torch_ring_attention", "_rank_main", str(tmp / "out"))
    outs = [np.load(str(tmp / f"out{rank}.npz")) for rank in range(world)]
    return world, {key: (outs[0][key] if key == "ulysses_refused"
                         else np.concatenate([o[key] for o in outs], axis=1))
                   for key in outs[0].files}


def _jax(world):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from infinistore_tpu.models import ring_attention as jr

    mesh = Mesh(np.array(jax.devices()[:world]), ("sp",))
    return jax, jnp, mesh, jr


@pytest.mark.parametrize("causal", [True, False])
def test_ring_matches_jax_and_dense(ranks, causal):
    world, out = ranks
    jax, jnp, mesh, jr = _jax(world)
    qkv = tuple(jnp.asarray(x) for x in _qkv())
    want = np.asarray(jr.ring_attention(*qkv, mesh=mesh, axis="sp", causal=causal))
    got = out[f"ring_{causal}"]
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, np.asarray(jr.dense_attention_reference(*qkv, causal=causal)),
                               rtol=TOL, atol=TOL)


def test_bf16_inputs_fp32_accumulation(ranks):
    """bf16 inputs: the online accumulation is f32, so the result matches the
    JAX ring and the dense oracle on the same bf16 inputs up to the output's
    bf16 rounding (the JAX test's 2e-2)."""
    world, out = ranks
    jax, jnp, mesh, jr = _jax(world)
    q, k, v = (jnp.asarray(x).astype(jnp.bfloat16) for x in _qkv())
    for want in (jr.ring_attention(q, k, v, mesh=mesh, axis="sp"),
                 jr.dense_attention_reference(q, k, v)):
        np.testing.assert_allclose(out["ring_bf16"], np.asarray(want, np.float32),
                                   rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_ulysses_matches_jax_and_dense(ranks, causal):
    world, out = ranks
    if H % world:
        assert "must be a multiple" in str(out["ulysses_refused"])
        return
    jax, jnp, mesh, jr = _jax(world)
    from infinistore_tpu.models.ulysses import ulysses_attention as jax_ulysses

    qkv = tuple(jnp.asarray(x) for x in _qkv())
    got = out[f"ulysses_{causal}"]
    np.testing.assert_allclose(got, np.asarray(jax_ulysses(*qkv, mesh=mesh, axis="sp",
                                                           causal=causal)), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, np.asarray(jr.dense_attention_reference(*qkv, causal=causal)),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, out[f"ring_{causal}"], rtol=TOL, atol=TOL)


def _jax_grads(loss_of):
    import jax
    import jax.numpy as jnp

    qkv = tuple(jnp.asarray(x) for x in _qkv())
    return [np.asarray(g) for g in jax.grad(lambda q, k, v: (loss_of(q, k, v) ** 2).mean(),
                                            argnums=(0, 1, 2))(*qkv)]


def test_ring_gradients_match_jax_and_dense(ranks):
    """The mirror of tests/test_ring_attention.py's gradient test, at every
    world size: the hops' reverse carries each rank's K/V gradient home."""
    world, out = ranks
    jax, jnp, mesh, jr = _jax(world)
    want = _jax_grads(lambda q, k, v: jr.ring_attention(q, k, v, mesh=mesh, axis="sp",
                                                        causal=True))
    dense = _jax_grads(lambda q, k, v: jr.dense_attention_reference(q, k, v, causal=True))
    for x, w, d in zip("qkv", want, dense):
        got = out[f"ring_grad_{x}"]
        np.testing.assert_allclose(got, w, rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=x)
        np.testing.assert_allclose(got, d, rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=x)


def test_ulysses_gradients_match_jax_and_dense(ranks):
    world, out = ranks
    if H % world:
        assert "must be a multiple" in str(out["ulysses_refused"])
        return
    jax, jnp, mesh, jr = _jax(world)
    from infinistore_tpu.models.ulysses import ulysses_attention as jax_ulysses

    want = _jax_grads(lambda q, k, v: jax_ulysses(q, k, v, mesh=mesh, axis="sp"))
    dense = _jax_grads(lambda q, k, v: jr.dense_attention_reference(q, k, v))
    for x, w, d in zip("qkv", want, dense):
        got = out[f"ulysses_grad_{x}"]
        np.testing.assert_allclose(got, w, rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=x)
        np.testing.assert_allclose(got, d, rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=x)


def test_one_rank_makes_no_p2p_call_and_refuses_gradients(tmp_path, monkeypatch):
    """World size 1 (the card's case): no send to self, forward or backward,
    and the dense oracle's result and gradients; Ulysses' exchange with
    itself gives the same. (The name is kept from when inputs that require
    grad were refused; they are differentiated now.)"""
    import torch.distributed as dist

    from infinistore_tpu_torch.models import ring_attention as tr
    from infinistore_tpu_torch.models.ulysses import ulysses_attention

    q, k, v = (torch.from_numpy(x) for x in _qkv())
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/fs", rank=0, world_size=1)
    try:
        def no_p2p(*args, **kwargs):
            raise AssertionError("a ring of one rank posted a P2P op")

        monkeypatch.setattr(dist, "batch_isend_irecv", no_p2p)
        got = tr.ring_attention(q, k, v)
        torch.testing.assert_close(got, tr.dense_attention_reference(q, k, v), rtol=TOL, atol=TOL)
        want = _grads("dense", tr.dense_attention_reference, q, k, v)
        for name, attention in (("ring", tr.ring_attention), ("ulysses", ulysses_attention)):
            grads = _grads(name, attention, q, k, v)
            for x in "qkv":
                np.testing.assert_allclose(grads[f"{name}_grad_{x}"], want[f"dense_grad_{x}"],
                                           rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=f"{name} {x}")
    finally:
        dist.destroy_process_group()
