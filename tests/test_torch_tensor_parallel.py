"""The port's tensor-parallel train step (infinistore_tpu_torch/models/
tensor_parallel.py) against the JAX package's ``train_step`` under the
multi-chip dryrun's placements.

The reference is the JAX ``train_step`` with its weights placed by
``__graft_entry__.py``'s ``param_spec`` (copied below: heads, FFN hidden
columns and vocabulary over tp, experts over (ep, tp), norms replicated)
and its tokens as ``P("dp", "tp")``, on a sub-mesh of the 8-device CPU
mesh; GSPMD inserts the collectives. The port's step runs on gloo ranks,
one process each (one module-scoped spawn per world size): 1 rank at (dp,
tp, ep) = (1, 1, 1), 2 at (1, 2, 1) and 4 at (2, 2, 1) on the dense config,
8 at (2, 2, 2) on the MoE config; f32, and bf16 at 1 and 2 ranks. Each rank
holds only its slices, before and after the step, and its dp shard of the
batch.

Tolerances: the loss within 1e-5 of JAX's; each parameter's ``(p_old -
p_new) / lr`` within 1e-4 of the largest magnitude of JAX's (f32; ``LR`` is
large so that the update clears the weights' f32 spacing, which a step of
1e-3 on the norms' ones would not); bf16: the loss and each gradient within
2e-2 of ``jax.value_and_grad``'s on the same placements (the gradients as
relative norms, per slice). The norms' tp reduction, planted out, must break the f32
bound at tp > 1 (at tp = 1 there is nothing to reduce, and the planted step
is the sound one). No rank sees logits over the whole vocabulary, and no
tensor a collective carries has the vocabulary's size in its shape. Every
copy of a weight held on more than one rank agrees after the step. jax is
imported by this process only."""

import numpy as np
import pytest
import torch

from test_torch_ring_attention import spawn_ranks

DENSE = dict(vocab=192, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
             block_tokens=8)
MOE = dict(DENSE, n_experts=4)
B, S = 4, 16
LR = 1.0
TOL = 1e-5
GRAD_TOL = 1e-4
BF16_TOL = 2e-2
# world size -> (grid, shape, dtypes)
CASES = {
    1: ((1, 1, 1), DENSE, ("f32", "bf16")),
    2: ((1, 2, 1), DENSE, ("f32", "bf16")),
    4: ((2, 2, 1), DENSE, ("f32",)),
    8: ((2, 2, 2), MOE, ("f32",)),
}
NORMS = ("attn_norm", "ffn_norm", "final_norm")


def param_spec(name):
    """``__graft_entry__.py``'s placements (``dryrun_multichip``), copied."""
    from jax.sharding import PartitionSpec as P

    if name.endswith(("wq", "wk", "wv")):
        return P(None, "tp", None)
    if name.endswith("wo"):
        return P("tp", None, None)
    if name.endswith("w_gate_up_moe"):
        return P("ep", None, None, "tp")
    if name.endswith("w_down_moe"):
        return P("ep", "tp", None)
    if name.endswith("router"):
        return P(None, "ep")
    if name.endswith("w_gate_up"):
        return P(None, None, "tp")
    if name.endswith("w_down"):
        return P("tp", None)
    if name.endswith("lm_head"):
        return P(None, "tp")
    if name == "embed":
        return P("tp", None)
    return P()


def _torch_dtype(name):
    return {"f32": torch.float32, "bf16": torch.bfloat16}[name]


def _record_collectives(tensor_parallel, seen):
    """Wrap the collectives the step posts so that each records its
    tensors' shapes in ``seen``."""
    import torch.distributed as dist

    def wrap(fn):
        def recorded(*args, **kwargs):
            seen.extend(tuple(a.shape) for a in args if isinstance(a, torch.Tensor))
            return fn(*args, **kwargs)
        return recorded

    for name in ("all_reduce", "all_gather_into_tensor", "all_gather"):
        setattr(dist, name, wrap(getattr(dist, name)))
    tensor_parallel._reduce_scatter = wrap(tensor_parallel._reduce_scatter)
    nll = tensor_parallel._vocab_parallel_nll

    def logged_nll(logits, targets, grid):
        seen.append(("logits", *logits.shape))
        return nll(logits, targets, grid)

    tensor_parallel._vocab_parallel_nll = logged_nll


def _rank_main(world, rank, init_file, data_path, out_path):
    """One grid point through every case of its world size."""
    import torch.distributed as dist

    from infinistore_tpu_torch.models import expert_parallel, llama, tensor_parallel

    grid_shape, shape, dtypes = CASES[world]
    data = np.load(data_path)
    seen = []
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        grid = expert_parallel.ep_grid(*grid_shape)
        _record_collectives(tensor_parallel, seen)
        b_loc = B // grid.dp
        tokens = torch.from_numpy(data["tokens"][grid.d * b_loc:(grid.d + 1) * b_loc]).long()
        out = {"coords": np.array([grid.d, grid.i, grid.j])}
        for dt in dtypes:
            cfg = llama.LlamaConfig(dtype=_torch_dtype(dt), **shape)
            params = llama.params_from_numpy(
                {k[len(dt) + 1:]: data[k] for k in data.files if k.startswith(dt + "_")},
                cfg, device="cpu")
            step, shard = tensor_parallel.make_tp_train_step(grid, cfg, device="cpu")
            local = shard(params)
            out.update({f"{dt}_before_{k}": np.array(v.shape) for k, v in local.items()})
            # Copies: the step updates the slices in place.
            out.update({f"{dt}_old_{k}": v.float().numpy().copy() for k, v in local.items()})
            loss, grads = tensor_parallel.tp_loss_and_grads(local, tokens, cfg, grid)
            out[f"{dt}_loss"] = loss.numpy()
            out.update({f"{dt}_grad_{k}": g.float().numpy() for k, g in grads.items()})
            if dt == "f32":
                # The planted fault: the norms' gradients not summed over tp.
                _, planted = llama._loss_and_grads(
                    local, lambda p: tensor_parallel.tp_loss_fn(p, tokens, cfg, grid))
                tensor_parallel._reduce_grads(planted, grid, over_tp=("router",))
                out.update({f"planted_{k}": g.numpy() for k, g in planted.items()})
                local, step_loss = step(local, tokens, lr=LR)
                out["f32_step_loss"] = step_loss.numpy()
                out.update({f"f32_new_{k}": v.numpy() for k, v in local.items()})
    finally:
        dist.destroy_process_group()
    logits = [s[1:] for s in seen if s[:1] == ("logits",)]
    out["logits_shapes"] = np.array(logits)
    out["collective_dims"] = np.array(sorted({d for s in seen if s[:1] != ("logits",)
                                              for d in s}), dtype=np.int64)
    np.savez(f"{out_path}{rank}.npz", **out)


def _jax_reference(world, tmp):
    """The numpy weights and tokens (written to ``tmp``), and per dtype the
    JAX step on the dryrun's placements: {dtype: (loss, grads)} with grads
    ``(p_old - p_new) / LR`` in f32 and ``jax.value_and_grad``'s in bf16."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from infinistore_tpu.models import LlamaConfig, init_params, loss_fn, train_step

    grid_shape, shape, dtypes = CASES[world]
    mesh = Mesh(np.array(jax.devices()[:world]).reshape(grid_shape), ("dp", "tp", "ep"))
    tokens = np.random.default_rng(8).integers(0, shape["vocab"], (B, S)).astype(np.int32)
    arrays, ref = {"tokens": tokens}, {}
    for dt in dtypes:
        cfg = LlamaConfig(dtype={"f32": jnp.float32, "bf16": jnp.bfloat16}[dt], **shape)
        params = init_params(cfg, jax.random.PRNGKey(7))
        # bf16 weights travel as f32 (exact), cast back by params_from_numpy.
        arrays.update({f"{dt}_{k}": np.asarray(v, np.float32) for k, v in params.items()})
        placed = {k: jax.device_put(v, NamedSharding(mesh, param_spec(k))) for k, v in
                  params.items()}
        toks = jax.device_put(jnp.asarray(tokens), NamedSharding(mesh, P("dp", "tp")))
        with mesh:
            if dt == "f32":
                new, loss = train_step(placed, toks, cfg, lr=LR)
                grads = {k: (np.asarray(params[k]) - np.asarray(new[k])) / LR for k in params}
            else:
                loss, g = jax.value_and_grad(loss_fn)(placed, toks, cfg)
                grads = {k: np.asarray(v, np.float32) for k, v in g.items()}
        ref[dt] = float(loss), grads
    path = str(tmp / "inputs.npz")
    np.savez(path, **arrays)
    return path, ref


@pytest.fixture(scope="module", params=sorted(CASES))
def ranks(request, tmp_path_factory):
    """One world size: (world, the JAX reference, each rank's outputs)."""
    world = request.param
    tmp = tmp_path_factory.mktemp(f"tp{world}")
    data_path, ref = _jax_reference(world, tmp)
    spawn_ranks(tmp, world, "test_torch_tensor_parallel", "_rank_main", data_path,
                str(tmp / "out"))
    return world, ref, [np.load(str(tmp / f"out{r}.npz")) for r in range(world)]


def _slice(name, full, coords, grid_shape):
    """The slice of ``full`` rank (d, i, j) holds under the dryrun's
    placements."""
    _dp, tp, ep = grid_shape
    _d, i, j = coords
    for dim, axis in enumerate(param_spec(name)):
        if axis is not None:
            parts, at = (tp, i) if axis == "tp" else (ep, j)
            size = full.shape[dim] // parts
            full = np.take(full, range(at * size, (at + 1) * size), axis=dim)
    return full


def _worst(got, want_full, name, coords, grid_shape):
    """|got - want's slice|, over the largest magnitude of ``want_full``."""
    want = _slice(name, want_full, coords, grid_shape)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want_full).max())


def test_tp_step_matches_jax(ranks):
    """f32: the loss within 1e-5 and every slice's ``(p_old - p_new) / lr``
    within 1e-4 of the largest magnitude of the JAX step's, on every
    rank."""
    world, ref, outs = ranks
    grid_shape = CASES[world][0]
    loss, grads = ref["f32"]
    for out in outs:
        coords = tuple(int(c) for c in out["coords"])
        assert abs(float(out["f32_loss"]) - loss) <= TOL, (float(out["f32_loss"]), loss)
        assert abs(float(out["f32_step_loss"]) - loss) <= TOL
        for name, want in grads.items():
            got = (out[f"f32_old_{name}"] - out[f"f32_new_{name}"]) / LR
            err = _worst(got, want, name, coords, grid_shape)
            assert err <= GRAD_TOL, (coords, name, err)


def test_tp_bf16_matches_jax(ranks):
    """bf16 (1 and 2 ranks): the loss within 2e-2 of ``jax.value_and_grad``'s
    on the same placements, and every gradient slice within 2e-2 of its
    slice there, as ``||g - g_ref|| / ||g_ref||`` (bf16 rounds every
    activation and gradient, and the two packages sum in other orders: the
    one-device ``llama`` gradients read 0.013 from JAX's on these
    weights)."""
    world, ref, outs = ranks
    grid_shape, _shape, dtypes = CASES[world]
    if "bf16" not in dtypes:
        assert world in (4, 8)  # the f32 cases only
        return
    loss, grads = ref["bf16"]
    for out in outs:
        coords = tuple(int(c) for c in out["coords"])
        assert abs(float(out["bf16_loss"]) - loss) <= BF16_TOL
        for name, want in grads.items():
            want = _slice(name, want, coords, grid_shape)
            err = np.linalg.norm(out[f"bf16_grad_{name}"] - want) / np.linalg.norm(want)
            assert err <= BF16_TOL, (coords, name, err)


def test_planted_norm_fault_breaks_the_bound(ranks):
    """The norms' gradients left unsummed over tp: outside the bound at tp
    > 1 on every rank; at tp = 1 the same gradients as the sound step."""
    world, ref, outs = ranks
    grid_shape = CASES[world][0]
    _loss, grads = ref["f32"]
    for out in outs:
        coords = tuple(int(c) for c in out["coords"])
        norm_errs = [_worst(out[f"planted_{k}"], grads[k], k, coords, grid_shape)
                     for k in grads if k.rsplit(".", 1)[-1] in NORMS]
        if grid_shape[1] > 1:
            assert min(norm_errs) > 100 * GRAD_TOL, (coords, norm_errs)
        else:
            for k in grads:
                np.testing.assert_array_equal(out[f"planted_{k}"], out[f"f32_grad_{k}"])


def test_each_rank_holds_only_its_slice(ranks):
    """Before and after the step, every weight on every rank has its
    slice's shape, and the grid's points are each taken once."""
    world, ref, outs = ranks
    grid_shape = CASES[world][0]
    _loss, grads = ref["f32"]
    dp, tp, ep = grid_shape
    assert sorted(tuple(int(c) for c in out["coords"]) for out in outs) == [
        (d, i, j) for d in range(dp) for i in range(tp) for j in range(ep)]
    for out in outs:
        coords = tuple(int(c) for c in out["coords"])
        for name, full in grads.items():
            want = _slice(name, full, coords, grid_shape).shape
            assert tuple(out[f"f32_before_{name}"]) == want, name
            assert out[f"f32_new_{name}"].shape == want, name


def test_no_rank_sees_the_whole_vocabulary(ranks):
    """The loss reads [b, S - 1, V / tp] logits, and no collective carries a
    tensor with the vocabulary's size in its shape; at world size 1 no
    collective runs at all."""
    world, _ref, outs = ranks
    (dp, tp, _ep), shape, _dtypes = CASES[world]
    vocab = shape["vocab"]
    for out in outs:
        assert {tuple(s) for s in out["logits_shapes"].tolist()} == {
            (B // dp, S - 1, vocab // tp)}
        dims = out["collective_dims"].tolist()
        if world == 1:
            assert dims == []
        else:
            assert dims and vocab not in dims, dims


def test_every_copy_of_a_weight_agrees(ranks):
    """A weight held on several ranks (the norms everywhere, a tp slice over
    dp and ep, an expert slice over dp, the router over dp and tp) is the
    same on each after the step."""
    _world, ref, outs = ranks
    by_slice = {}
    for out in outs:
        _d, i, j = (int(c) for c in out["coords"])
        for name in ref["f32"][1]:
            spec = param_spec(name)
            key = (name, i if "tp" in spec else None, j if "ep" in spec else None)
            first = by_slice.setdefault(key, out[f"f32_new_{name}"])
            np.testing.assert_array_equal(out[f"f32_new_{name}"], first, err_msg=str(key))


@pytest.mark.parametrize("n_experts", [0, 4], ids=["dense", "moe"])
def test_world_size_one_posts_no_collective(n_experts):
    """At (1, 1, 1) the step needs no process group (it posts nothing), and
    its loss and new parameters are ``llama.train_step``'s within f32
    rounding."""
    from infinistore_tpu_torch.models import llama, tensor_parallel
    from infinistore_tpu_torch.models.expert_parallel import EpGrid

    cfg = llama.LlamaConfig(dtype=torch.float32, **dict(DENSE, n_experts=n_experts))
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (B, S))
    grid = EpGrid(1, 1, 1, 0, 0, 0, None, None, None, None)
    step, shard = tensor_parallel.make_tp_train_step(grid, cfg, device="cpu")
    local, loss = step(shard(params), tokens, lr=LR)
    ref, ref_loss = llama.train_step({k: v.clone() for k, v in params.items()}, tokens, cfg,
                                     lr=LR)
    assert abs(float(loss) - float(ref_loss)) <= TOL
    for name, want in ref.items():
        np.testing.assert_allclose(local[name].numpy(), want.numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("change,match", [
    (dict(n_heads=6, n_kv_heads=3), "n_kv_heads=3"),
    (dict(ffn_dim=129), "ffn_dim=129"),
    (dict(vocab=191), "vocab=191"),
])
def test_config_checks_refuse_what_does_not_divide(change, match):
    """KV heads, FFN hidden columns and vocabulary that do not divide over
    tp are refused when the step is built; a sequence that does not, at
    the step; so are experts over ep and a dense config over ep > 1."""
    from infinistore_tpu_torch.models import llama, tensor_parallel
    from infinistore_tpu_torch.models.expert_parallel import EpGrid

    grid = EpGrid(1, 2, 1, 0, 0, 0, None, None, None, None)
    bad = llama.LlamaConfig(dtype=torch.float32, **dict(DENSE, dim=96, **change))
    with pytest.raises(ValueError, match=match):
        tensor_parallel.make_tp_train_step(grid, bad, device="cpu")
    good = llama.LlamaConfig(dtype=torch.float32, **DENSE)
    step, shard = tensor_parallel.make_tp_train_step(grid, good, device="cpu")
    local = shard(llama.init_params(good, torch.Generator().manual_seed(0), device="cpu"))
    with pytest.raises(ValueError, match="sequence"):
        step(local, torch.zeros((1, S + 1), dtype=torch.long))
    with pytest.raises(ValueError, match="dense config"):
        tensor_parallel.make_tp_train_step(EpGrid(1, 1, 2, 0, 0, 0, None, None, None, None),
                                           good, device="cpu")
    with pytest.raises(ValueError, match="n_experts=3"):
        tensor_parallel.make_tp_train_step(
            EpGrid(1, 1, 2, 0, 0, 0, None, None, None, None),
            llama.LlamaConfig(dtype=torch.float32, **dict(DENSE, n_experts=3)), device="cpu")


# chip_smoke.py's tensor_parallel path at a tiny width (head_dim 64; KV heads
# that divide over 4 ranks).
REHEARSAL = dict(vocab=256, dim=256, n_layers=2, n_heads=4, n_kv_heads=4, ffn_dim=256,
                 block_tokens=16)


def _rehearsal_rank(world, rank, init_file, out_path):
    from test_torch_expert_parallel import _chip_smoke

    metrics, launches = _chip_smoke()._run_tensor_parallel(
        torch, device="cpu", backend="gloo", geometry=REHEARSAL, rank=rank, world=world,
        init_file=init_file, check_layers=2, timed_layers=2, batch=2, tokens=32)
    np.savez(f"{out_path}{rank}.npz", launches=np.array(sum(launches.values())),
             grid=np.array(metrics["grid"]), fault=np.array(metrics["check"]["fault"]),
             fault_err=np.array(metrics["check"]["fault_err"]),
             grad_err=np.array(metrics["check"]["grad_err"]),
             steps=np.array(len(metrics["step"]["step_s"])))


@pytest.mark.parametrize("world", [1, 4])
def test_chip_smoke_tensor_parallel_rehearsal_on_cpu(tmp_path, world):
    """``chip_smoke.py``'s tensor_parallel path (phase 18 at one rank; the
    ``--cards 4`` leg at (1, 4, 1)) on gloo ranks at a tiny width: its
    checks hold (the planted fault read outside the bound), two timed steps,
    no kernel launch."""
    spawn_ranks(tmp_path, world, "test_torch_tensor_parallel", "_rehearsal_rank",
                str(tmp_path / "out"))
    for rank in range(world):
        out = np.load(str(tmp_path / f"out{rank}.npz"))
        assert int(out["launches"]) == 0
        assert out["grid"].tolist() == [1, world, 1]
        assert str(out["fault"]) == ("norms_unreduced" if world > 1 else "shift_flipped")
        assert float(out["fault_err"]) > 1e-4 >= float(out["grad_err"])
        assert int(out["steps"]) == 2
