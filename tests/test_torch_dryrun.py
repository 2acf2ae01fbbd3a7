"""The port's multi-chip dryrun (infinistore_tpu_torch/dryrun.py), the
counterpart of tests/test_graft_entry.py:22 (``test_dryrun_multichip_8``).

``dryrun_multichip(n, device="cpu")`` at n = 1, 4 and 8 on gloo ranks: every
leg's check holds inside the call (it raises otherwise), the printed line
names the JAX dryrun's mesh for n, the handoff is one launch and, on the
CPU, no kernel launches. Without a card, the call and the module's command
line raise unless the CPU is asked for."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
