"""The port's expert-parallel MoE train step (infinistore_tpu_torch/models/
expert_parallel.py) against the JAX package's unsharded ``train_step``.

Mirrors tests/test_model_disagg.py:247 on 8 gloo ranks as a (dp, tp, ep) =
(2, 2, 2) grid, f32, the JAX test's placements: each rank holds only its
slice of the expert weights and the router before and after the step, and
its dp shard of the batch. The loss (the same on every rank) and the new
parameters, assembled from the slices, are within 1e-5 of the JAX
``train_step`` on the whole batch and weights; every copy of a weight held
on more than one rank is the same. Also a CPU rehearsal of ``chip_smoke.py``'s
parallel_train path (ring and Ulysses gradients, the pipeline and the
expert-parallel step) at a tiny width on 1 and 4 gloo ranks, as the script
runs it on 1 and 4 cards. Each rank is a process of its own; jax is
imported by this process only."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from test_torch_ring_attention import HERE, spawn_ranks

REPO = os.path.dirname(HERE)
MOE = dict(vocab=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128, n_experts=4,
           block_tokens=8)
GRID = (2, 2, 2)  # (dp, tp, ep)
B, S = 4, 16
TOL = 1e-5
REHEARSAL = dict(vocab=256, dim=256, n_layers=4, n_heads=4, n_kv_heads=2, ffn_dim=256,
                 block_tokens=16)


def _rank_main(world, rank, init_file, data_path, out_path):
    """One grid point: its slices and dp shard through one step."""
    import torch.distributed as dist

    from infinistore_tpu_torch.models import expert_parallel, llama

    cfg = llama.LlamaConfig(dtype=torch.float32, **MOE)
    data = np.load(data_path)
    params = llama.params_from_numpy({k: data[k] for k in data.files if k != "tokens"}, cfg,
                                     device="cpu")
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        grid = expert_parallel.ep_grid(*GRID)
        step, shard = expert_parallel.make_ep_train_step(grid, cfg, device="cpu")
        local = shard(params)
        before = {k: np.array(v.shape) for k, v in local.items()}
        b_loc = B // grid.dp
        local, loss = step(local, data["tokens"][grid.d * b_loc:(grid.d + 1) * b_loc])
    finally:
        dist.destroy_process_group()
    np.savez(f"{out_path}{rank}.npz", loss=loss.numpy(), coords=np.array([grid.d, grid.i, grid.j]),
             **{f"before_{k}": v for k, v in before.items()},
             **{f"new_{k}": v.numpy() for k, v in local.items()})


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX weights, batch and one-device step, and each rank's outputs."""
    import jax

    from infinistore_tpu.models import LlamaConfig, init_params, train_step

    jcfg = LlamaConfig(dtype=jax.numpy.float32, **MOE)
    jparams = init_params(jcfg, jax.random.PRNGKey(7))
    tokens = np.random.default_rng(8).integers(0, MOE["vocab"], (B, S)).astype(np.int32)
    tmp = tmp_path_factory.mktemp("ep")
    data_path = str(tmp / "inputs.npz")
    params_np = {k: np.asarray(v) for k, v in jparams.items()}
    np.savez(data_path, tokens=tokens, **params_np)
    world = int(np.prod(GRID))
    spawn_ranks(tmp, world, "test_torch_expert_parallel", "_rank_main", data_path,
                str(tmp / "out"))
    new, loss = train_step(jparams, tokens, jcfg)
    outs = [np.load(str(tmp / f"out{r}.npz")) for r in range(world)]
    return params_np, {k: np.asarray(v) for k, v in new.items()}, float(loss), outs


def _slices(name, full):
    """{(i, j): the slice rank (d, i, j) holds} for one weight's full value."""
    dp, tp, ep = GRID
    kind = name.rsplit(".", 1)[-1]
    out = {}
    for i in range(tp):
        for j in range(ep):
            t = full
            if kind in ("w_gate_up_moe", "w_down_moe", "router"):
                e_ax = 1 if kind == "router" else 0
                e = t.shape[e_ax] // ep
                t = np.take(t, range(j * e, (j + 1) * e), axis=e_ax)
            if kind in ("w_gate_up_moe", "w_down_moe"):
                f_ax = 3 if kind == "w_gate_up_moe" else 1
                f = t.shape[f_ax] // tp
                t = np.take(t, range(i * f, (i + 1) * f), axis=f_ax)
            out[(i, j)] = t
    return out


def test_expert_parallel_step_matches_jax(run):
    """The loss and every rank's new slice of every weight within 1e-5 of the
    JAX ``train_step`` on the whole batch, on one device."""
    _, new, loss, outs = run
    for out in outs:
        assert abs(float(out["loss"]) - loss) < TOL, (float(out["loss"]), loss)
        _d, i, j = (int(c) for c in out["coords"])
        for name, want in new.items():
            np.testing.assert_allclose(out[f"new_{name}"], _slices(name, want)[(i, j)],
                                       rtol=TOL, atol=TOL, err_msg=name)


def test_each_rank_holds_only_its_slice(run):
    """The JAX test's placements, before and after the step: the experts
    split over ep, their ffn columns over tp, the router's experts over ep,
    nothing gathered."""
    params, _, _, outs = run
    dp, tp, ep = GRID
    e, f, dim = MOE["n_experts"], MOE["ffn_dim"], MOE["dim"]
    want = {"w_gate_up_moe": (e // ep, dim, 2, f // tp), "w_down_moe": (e // ep, f // tp, dim),
            "router": (dim, e // ep)}
    assert sorted(tuple(int(c) for c in out["coords"]) for out in outs) == [
        (d, i, j) for d in range(dp) for i in range(tp) for j in range(ep)]
    for out in outs:
        for name, full in params.items():
            shape = want.get(name.rsplit(".", 1)[-1], full.shape)
            assert tuple(out[f"before_{name}"]) == shape, name
            assert out[f"new_{name}"].shape == shape, name


def test_every_copy_of_a_weight_agrees(run):
    """A weight's copies on different ranks (replicated ones everywhere,
    the router over dp and tp, the experts over dp) are the same after the
    step: every rank applied the same reduced gradient."""
    params, _, _, outs = run
    by_slice = {}
    for out in outs:
        _d, i, j = (int(c) for c in out["coords"])
        for name in params:
            kind = name.rsplit(".", 1)[-1]
            key = (name, (i, j) if kind in ("w_gate_up_moe", "w_down_moe") else
                   (j,) if kind == "router" else ())
            first = by_slice.setdefault(key, out[f"new_{name}"])
            np.testing.assert_array_equal(out[f"new_{name}"], first, err_msg=str(key))


def test_expert_parallel_refuses_bad_layouts(tmp_path):
    import torch.distributed as dist

    from infinistore_tpu_torch.models import expert_parallel, llama

    with pytest.raises(RuntimeError, match="process group"):
        expert_parallel.ep_grid(1, 1, 1)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/fs", rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="1 ranks"):
            expert_parallel.ep_grid(1, 2, 1)
        grid = expert_parallel.ep_grid(1, 1, 1)
        with pytest.raises(ValueError, match="MoE"):
            expert_parallel.make_ep_train_step(grid, llama.LlamaConfig(dtype=torch.float32),
                                               device="cpu")
        odd = expert_parallel.EpGrid(1, 1, 3, 0, 0, 0, None, None, None, None)
        with pytest.raises(ValueError, match="divide"):
            expert_parallel.make_ep_train_step(
                odd, llama.LlamaConfig(dtype=torch.float32, n_experts=4), device="cpu")
    finally:
        dist.destroy_process_group()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _rehearsal_rank(world, rank, init_file, out_path):
    metrics, launches = _chip_smoke()._run_parallel_train(
        torch, device="cpu", backend="gloo", geometry=REHEARSAL, rank=rank, world=world,
        init_file=init_file, sp_tokens=64, pp_batch=4, pp_tokens=32, ep_tokens=32)
    np.savez(f"{out_path}{rank}.npz", launches=np.array(sum(launches.values())),
             legs=np.array(sorted(metrics)), ep_grid=np.array(metrics["expert_parallel"]["grid"]),
             stages=np.array(metrics["pipeline"]["stages"]))


@pytest.mark.parametrize("world", [1, 4])
def test_chip_smoke_parallel_train_rehearsal_on_cpu(tmp_path, world):
    """``chip_smoke.py``'s parallel_train path (phase 17 at one rank; the
    ``--cards 4`` leg at four, the expert-parallel step at (1, 2, 2)) on
    gloo ranks at a tiny width: every leg's checks hold and no kernel
    launches."""
    spawn_ranks(tmp_path, world, "test_torch_expert_parallel", "_rehearsal_rank",
                str(tmp_path / "out"))
    for rank in range(world):
        out = np.load(str(tmp_path / f"out{rank}.npz"))
        assert int(out["launches"]) == 0
        assert {"ring_ulysses", "pipeline", "expert_parallel"} <= set(out["legs"].tolist())
        assert int(out["stages"]) == world
        assert out["ep_grid"].tolist() == ([1, 2, 2] if world == 4 else [1, 1, 1])
