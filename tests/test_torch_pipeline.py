"""The port's GPipe pipeline (infinistore_tpu_torch/models/pipeline.py)
against the JAX package's, on the same weights and tokens.

Mirrors tests/test_model_disagg.py:282 and :308, at 2 stages on 2 gloo
ranks and at 4 stages on 4 (4 layers, 4 microbatches, f32): every rank's
loss equals the dense ``loss_fn`` within 1e-5, a second step lowers it, the
stages' new stacked weights are within 1e-5 of the JAX
``make_pp_train_step``'s on a sub-mesh of as many CPU devices, and the
replicated weights are the same on every rank after a step. Each rank is a
process of its own; jax is imported by this process only."""

import numpy as np
import pytest
import torch

from test_torch_ring_attention import spawn_ranks

SHAPE = dict(vocab=128, dim=64, n_layers=4, n_heads=4, n_kv_heads=2, ffn_dim=128,
             block_tokens=8)
B, S, MICRO = 8, 16, 4
TOL = 1e-5


def _rank_main(world, rank, init_file, data_path, out_path):
    """One stage: two steps on the same batch."""
    import torch.distributed as dist

    from infinistore_tpu_torch.models import llama, pipeline

    cfg = llama.LlamaConfig(dtype=torch.float32, **SHAPE)
    data = np.load(data_path)
    params = llama.params_from_numpy({k: data[k] for k in data.files if k != "tokens"}, cfg,
                                     device="cpu")
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        step, shard = pipeline.make_pp_train_step(None, cfg, world, MICRO, device="cpu")
        local = shard(pipeline.stack_stage_params(params, cfg, world))
        local, loss = step(local, data["tokens"])
        out = {f"new_{k}": v.numpy().copy() for k, v in local.items()}
        _, loss2 = step(local, data["tokens"])
    finally:
        dist.destroy_process_group()
    np.savez(f"{out_path}{rank}.npz", loss=loss.numpy(), loss2=loss2.numpy(), **out)


@pytest.fixture(scope="module", params=[2, 4])
def run(request, tmp_path_factory):
    """The JAX weights and batch, and each stage's outputs."""
    import jax

    from infinistore_tpu.models import LlamaConfig, init_params

    world = request.param
    jcfg = LlamaConfig(dtype=jax.numpy.float32, **SHAPE)
    jparams = init_params(jcfg, jax.random.PRNGKey(11))
    tokens = np.random.default_rng(12).integers(0, SHAPE["vocab"], (B, S)).astype(np.int32)
    tmp = tmp_path_factory.mktemp(f"pp{world}")
    data_path = str(tmp / "inputs.npz")
    np.savez(data_path, tokens=tokens, **{k: np.asarray(v) for k, v in jparams.items()})
    spawn_ranks(tmp, world, "test_torch_pipeline", "_rank_main", data_path, str(tmp / "out"))
    return world, jcfg, jparams, tokens, [np.load(str(tmp / f"out{r}.npz")) for r in range(world)]


def test_pipeline_parallel_matches_dense_and_trains(run):
    """The mirror of :282: the pipelined loss EQUALS the dense loss_fn on
    every rank, and one SGD step through the inter-stage hops lowers it."""
    from infinistore_tpu.models import loss_fn

    world, jcfg, jparams, tokens, outs = run
    dense = float(loss_fn(jparams, tokens, jcfg))
    for rank, out in enumerate(outs):
        assert abs(float(out["loss"]) - dense) < TOL, (rank, float(out["loss"]), dense)
        assert float(out["loss2"]) < float(out["loss"])


def test_pipeline_step_matches_jax(run):
    """The new stacked weights against the JAX ``make_pp_train_step``'s on
    a ``world``-device "pp" mesh; the replicated ones equal on every rank."""
    import jax
    from jax.sharding import Mesh

    from infinistore_tpu.models.pipeline import make_pp_train_step, stack_stage_params

    world, jcfg, jparams, tokens, outs = run
    mesh = Mesh(np.array(jax.devices()[:world]), ("pp",))
    step, shard = make_pp_train_step(mesh, jcfg, stages=world, microbatches=MICRO)
    new, loss = step(shard(stack_stage_params(jparams, jcfg, stages=world)), tokens)
    for rank, out in enumerate(outs):
        assert abs(float(out["loss"]) - float(loss)) < TOL
    for name, want in new.items():
        want = np.asarray(want)
        if name in ("embed", "final_norm", "lm_head"):
            for rank, out in enumerate(outs):
                np.testing.assert_array_equal(out[f"new_{name}"], outs[0][f"new_{name}"])
            got = outs[0][f"new_{name}"]
        else:
            got = np.concatenate([out[f"new_{name}"] for out in outs])
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=name)


def test_pipeline_stacking_validates_inputs(tmp_path):
    """The mirror of :308, and a group whose size is not the stage count."""
    import torch.distributed as dist

    from infinistore_tpu_torch.models import llama, pipeline

    cfg = llama.LlamaConfig(n_layers=3, dtype=torch.float32)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        pipeline.stack_stage_params(params, cfg, stages=2)
    moe = llama.LlamaConfig(n_layers=2, n_experts=2, dtype=torch.float32)
    with pytest.raises(ValueError, match="dense"):
        pipeline.stack_stage_params(llama.init_params(moe, torch.Generator(), device="cpu"),
                                    moe, stages=2)
    with pytest.raises(RuntimeError, match="process group"):
        pipeline.make_pp_train_step(None, cfg, 1, 1, device="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/fs", rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="stages=2"):
            pipeline.make_pp_train_step(None, cfg, 2, 1, device="cpu")
    finally:
        dist.destroy_process_group()
