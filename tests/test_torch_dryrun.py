"""The port's multi-chip dryrun (infinistore_tpu_torch/dryrun.py), the
counterpart of tests/test_graft_entry.py:22 (``test_dryrun_multichip_8``).

``dryrun_multichip(n, device="cpu")`` at n = 1, 4 and 8 on gloo ranks: every
leg's check holds inside the call (it raises otherwise), the printed line
names the JAX dryrun's mesh for n, the handoff is one launch and, on the
CPU, no kernel launches. Without a card, the call and the module's command
line raise unless the CPU is asked for.

The dryrun's two decode legs are also held against the JAX dryrun's on the
same inputs: its own numpy draws (seeds 17 and 19, head_dim 16, its lengths
as drawn) through the JAX functions on the 8-device CPU mesh and through the
port's on 8 gloo ranks, within 1e-5."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
CROSS_RANKS = 8
RANK_TIMEOUT_S = 120


def _jax_mesh_rule(n):
    """``__graft_entry__.py``'s rule for the (dp, tp, ep) mesh, copied."""
    if n % 8 == 0:
        return 2, n // 4, 2
    if n % 2 == 0:
        return 2, n // 2, 1
    return 1, n, 1


@pytest.mark.parametrize("n", [1, 4, 8])
def test_dryrun_multichip_on_gloo_ranks(n, capsys):
    from infinistore_tpu_torch import dryrun

    result = dryrun.dryrun_multichip(n, device="cpu")
    printed = capsys.readouterr().out.strip().splitlines()
    assert printed[-1] == result["line"]
    dp, tp, ep = _jax_mesh_rule(n)
    assert result["line"].startswith(f"dryrun_multichip ok: mesh=(dp={dp},tp={tp},ep={ep}), ")
    assert f"ring-attn({n}-way sp)" in result["line"]
    assert "connector-ici ok (1 launch, all layers)" in result["line"]
    m = result["metrics"]
    assert m["tensor_parallel"]["mesh"] == [dp, tp, ep]
    assert np.isfinite(m["tensor_parallel"]["loss"]) and np.isfinite(m["pipeline"]["loss"])
    assert m["pipeline"]["stages"] == (2 if n >= 2 else 1)
    lens = m["sharded_decode"].pop("shard_lens")
    assert len(lens) == n and sum(lens) > 0 and (n == 1 or lens[-1] == 0)  # an empty shard
    for err in (*m["ring_ulysses"].values(), *m["sharded_decode"].values()):
        assert 0 <= err < 1e-4
    assert m["ici_handoff"] == {"launches": 1, "blocks": 2}
    assert set(result["launches"]) == {"tensor_parallel", "pipeline", "ring_ulysses",
                                       "sharded_decode", "ici_handoff"}
    assert all(c == 0 for counts in result["launches"].values() for c in counts.values())


def test_dryrun_needs_a_card_unless_the_cpu_is_asked_for(monkeypatch):
    from infinistore_tpu_torch import dryrun

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for n in (1, 4):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun.dryrun_multichip(n)
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "infinistore_tpu_torch.dryrun", "--n", "1"],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr



def test_chip_smoke_dryrun_rehearsal_on_cpu():
    """``chip_smoke.py``'s dryrun phase at one gloo rank: the dryrun's line,
    its legs, and no kernel launch on the CPU."""
    from test_torch_expert_parallel import _chip_smoke

    metrics, launches = _chip_smoke()._run_dryrun(torch, 1, device="cpu")
    assert metrics["line"].startswith("dryrun_multichip ok: mesh=(dp=1,tp=1,ep=1), ")
    assert set(metrics["launches_by_leg"]) == set(metrics["legs"])
    assert launches and set(launches.values()) == {0}


def _cross_rank_main(rank, init_file, out_path):
    """One gloo rank of the cross-package check: the port's two decode legs
    on the JAX dryrun's draws at 8 ranks (no shard emptied)."""
    import torch.distributed as dist

    from infinistore_tpu_torch import dryrun

    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=CROSS_RANKS)
    try:
        draws = dryrun.decode_draws(CROSS_RANKS, empty_last_shard=False)
        sp, rg = dryrun.decode_outputs(rank, CROSS_RANKS, torch.device("cpu"), draws)
        np.savez(out_path, sp=sp, rg=rg)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def cross_ranks(tmp_path_factory):
    """The port's decode legs on 8 gloo ranks; returns each rank's outputs."""
    tmp = tmp_path_factory.mktemp("dryrun_cross")
    init_file = str(tmp / "filestore")
    env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo",
               PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    procs = []
    for rank in range(CROSS_RANKS):
        code = (f"import sys; sys.path.insert(0, {HERE!r}); import test_torch_dryrun as t; "
                f"t._cross_rank_main({rank}, {init_file!r}, {str(tmp / f'out{rank}.npz')!r})")
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
    return [np.load(str(tmp / f"out{rank}.npz")) for rank in range(CROSS_RANKS)]


def _jax_draws_and_mesh():
    """The JAX dryrun's decode draws (``__graft_entry__.py``: seeds 17 and
    19, as it draws them) and its 8-device sp mesh."""
    import jax
    from jax.sharding import Mesh

    from infinistore_tpu_torch import dryrun

    devices = jax.devices()
    assert len(devices) == CROSS_RANKS
    n, nb, bt, kvh, d, h, n_loc = (CROSS_RANKS, dryrun.NB_LOCAL, dryrun.BT, dryrun.KVH,
                                   dryrun.D, dryrun.H, dryrun.N_LOC)
    assert (nb, bt, kvh, d, h, n_loc) == (4, 4, 2, 16, 4, 3)  # __graft_entry__.py:212
    rng = np.random.default_rng(17)
    spk = rng.standard_normal((n * nb, bt, kvh, d))
    spv = rng.standard_normal((n * nb, bt, kvh, d))
    spq = rng.standard_normal((h, d))
    tables = np.stack([rng.permutation(nb)[:n_loc] for _ in range(n)]).astype(np.int32)
    lens = rng.integers(0, n_loc * bt + 1, size=n).astype(np.int32)
    lens[0] = max(lens[0], 1)
    rng = np.random.default_rng(19)
    rgq = rng.standard_normal((3, h, d))
    rg_tables = [[rng.permutation(nb)[:n_loc] for _ in range(3)] for _ in range(n)]
    rg_lens = np.zeros((n, 3), np.int32)
    rg_lens[:, 0] = n_loc * bt - 1
    rg_lens[:, 1] = rng.integers(0, 3, size=n)
    rg_lens[0, 1] = max(rg_lens[0, 1], 1)
    rg_lens[n // 2, 2] = 5
    draws = dict(spk=spk, spv=spv, spq=spq, tables=tables, lens=lens, rgq=rgq,
                 rg_tables=rg_tables, rg_lens=rg_lens)
    return draws, Mesh(np.array(devices), ("sp",))


def test_dryrun_draws_are_the_jax_dryrun_draws():
    """``decode_draws`` without the emptied shard is the JAX dryrun's draws,
    bit for bit once cast to f32 (the JAX side casts them with
    ``jnp.asarray(..., jnp.float32)``)."""
    from infinistore_tpu_torch import dryrun

    want, _ = _jax_draws_and_mesh()
    got = dryrun.decode_draws(CROSS_RANKS, empty_last_shard=False)
    for key in ("spk", "spv", "spq", "rgq"):
        assert got[key].dtype == np.float32
        assert np.array_equal(got[key], want[key].astype(np.float32)), key
    for key in ("tables", "lens", "rg_lens"):
        assert np.array_equal(got[key], want[key]), key
    assert all(np.array_equal(a, b) for ga, wa in zip(got["rg_tables"], want["rg_tables"])
               for a, b in zip(ga, wa))
    emptied = dryrun.decode_draws(CROSS_RANKS)
    assert emptied["lens"][-1] == 0
    assert np.array_equal(emptied["lens"][:-1], want["lens"][:-1])


def test_dryrun_sharded_decode_leg_matches_jax_on_its_draws(cross_ranks):
    import jax.numpy as jnp

    from infinistore_tpu.tpu.paged_attention import paged_decode_attention_sharded

    d, mesh = _jax_draws_and_mesh()
    want = np.asarray(paged_decode_attention_sharded(
        jnp.asarray(d["spq"], jnp.float32), jnp.asarray(d["spk"], jnp.float32),
        jnp.asarray(d["spv"], jnp.float32), d["tables"], d["lens"], mesh=mesh, axis="sp"))
    for rank, out in enumerate(cross_ranks):
        np.testing.assert_allclose(out["sp"], want, rtol=1e-5, atol=1e-5, err_msg=f"rank {rank}")


def test_dryrun_ragged_sharded_decode_leg_matches_jax_on_its_draws(cross_ranks):
    import jax.numpy as jnp

    from infinistore_tpu.tpu.paged_attention import (
        build_ragged_wave_sharded,
        paged_decode_attention_ragged_sharded,
    )

    d, mesh = _jax_draws_and_mesh()
    pages, rows, starts, lens, width = build_ragged_wave_sharded(d["rg_tables"], d["rg_lens"], 4)
    want = np.asarray(paged_decode_attention_ragged_sharded(
        jnp.asarray(d["rgq"], jnp.float32), jnp.asarray(d["spk"], jnp.float32),
        jnp.asarray(d["spv"], jnp.float32), pages, rows, starts, lens, mesh=mesh, axis="sp",
        table_width=width))
    for rank, out in enumerate(cross_ranks):
        np.testing.assert_allclose(out["rg"], want, rtol=1e-5, atol=1e-5, err_msg=f"rank {rank}")
