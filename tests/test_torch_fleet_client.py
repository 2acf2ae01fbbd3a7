"""The port's fleet client (``python -m infinistore_tpu_torch.fleet_client``)
on the CPU.

- Seed, restart, verify: a client process seeds roots into two store
  servers with a durable journal, is stopped, and the same argv with
  ``--verify`` run in this process replays the journal, loads every root
  and byte-compares it with the regenerated one: 0 wrong, 0 misses.
- The seeded bytes: drawn on the CPU from numpy and cast by torch, the same
  on every call and for every device.
- The mirror of ``tests/test_recovery.py::TestKillRestartSubprocess`` with
  the port's own argv (``tools/fleet.py`` spawns the JAX package's client
  by name): a client killed mid-reshard restarts with the same argv,
  resumes, and a cold bootstrap client verifies every root. Marked slow and
  chaos, like its oracle.
"""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from infinistore_tpu_torch import fleet_client
from infinistore_tpu_torch import lib as tlib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from tools import fleet  # noqa: E402


def client_argv(manage_port, stores=(), journal="", peers=(), seed=23, roots=0,
                crash_after_moved=0, bootstrap=False, verify=False,
                gossip_interval_s=0.25, device="cpu"):
    """``tools.fleet.client_argv``'s argv for the port's client module."""
    argv = [
        sys.executable, "-m", "infinistore_tpu_torch.fleet_client",
        "--manage-port", str(manage_port), "--seed", str(seed), "--roots", str(roots),
        "--replicas", "2", "--gossip-interval", str(gossip_interval_s), "--device", device,
    ]
    if stores:
        argv += ["--stores", ",".join(stores)]
    if journal:
        argv += ["--journal", journal]
    if peers:
        argv += ["--peers", ",".join(peers)]
    if crash_after_moved:
        argv += ["--crash-after-moved", str(crash_after_moved)]
    if bootstrap:
        argv += ["--bootstrap"]
    if verify:
        argv += ["--verify"]
    return argv


def spawn_client(capture=False, wait_ready=True, timeout_s=120.0, **kw):
    manage_port = kw.pop("manage_port", 0) or fleet.free_port()
    argv = client_argv(manage_port, **kw)
    proc = subprocess.Popen(argv, cwd=REPO, stdout=subprocess.PIPE if capture else None)
    member = {"manage_port": manage_port, "proc": proc, "argv": argv}
    if wait_ready:
        try:
            fleet.wait_manage(manage_port, "/membership", timeout_s, proc=proc)
        except RuntimeError:
            proc.kill()
            raise
    return member


def test_seeded_bytes_are_numpy_draws_cast_by_torch():
    spec = fleet_client._spec()
    a = fleet_client._mk_caches(spec, 3, "cpu")
    b = fleet_client._mk_caches(spec, 3, torch.device("cpu"))
    assert len(a) == spec.num_layers
    for layer, ((ka, va), (kb, vb)) in enumerate(zip(a, b)):
        assert ka.dtype == torch.bfloat16 and tuple(ka.shape) == spec.cache_shape
        assert torch.equal(ka, kb) and torch.equal(va, vb)
        base = np.random.default_rng(3 * 100 + layer).standard_normal(
            spec.cache_shape, dtype=np.float32)
        assert torch.equal(ka, torch.from_numpy(base).to(torch.bfloat16))
        assert not torch.equal(ka, va)


def test_seed_restart_verify_reads_every_root_right():
    """Seed 4 roots through a client process (journal on), stop it, then the
    same argv with ``--verify`` in this process: the journal replay brings
    back the catalog, every root loads and matches its regenerated bytes."""
    servers = [tlib.start_local_server(prealloc_bytes=32 << 20, block_bytes=4 << 10)
               for _ in range(2)]
    tmp = tempfile.mkdtemp(prefix="its-torch-fleet-")
    stores = [f"127.0.0.1:{s.port}" for s in servers]
    journal = os.path.join(tmp, "a.journal")
    port = fleet.free_port()
    member = None
    try:
        member = spawn_client(manage_port=port, stores=stores, journal=journal, seed=5,
                              roots=4)
        doc = fleet.wait_manage(port, "/membership", 120, proc=member["proc"],
                                predicate=lambda d: d.get("reshard_catalog_roots", 0) >= 4)
        assert doc["reshard_catalog_roots"] == 4
        member["proc"].terminate()
        assert member["proc"].wait(timeout=60) == 0
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = fleet_client.main(member["argv"][3:] + ["--verify"])
        assert rc == 0
        report = json.loads(out.getvalue().strip().splitlines()[-1])
        assert (report["reads"], report["wrong"], report["misses"]) == (4, 0, 0), report
        assert report["catalog_roots"] == 4
    finally:
        if member is not None and member["proc"].poll() is None:
            member["proc"].kill()
            member["proc"].wait(timeout=30)
        for s in servers:
            s.stop()
        shutil.rmtree(tmp, ignore_errors=True)


@pytest.mark.chaos
@pytest.mark.slow
class TestKillRestartSubprocess:
    def test_client_killed_mid_reshard_resumes_and_verifies(self):
        n_roots, crash_after = 12, 2
        tmp = tempfile.mkdtemp(prefix="its-torch-recovery-test-")
        stores = fleet.spawn_fleet_servers(2)
        joiner = fleet.spawn_fleet_servers(1)[0]
        store_addrs = [f"127.0.0.1:{m['service_port']}" for m in stores]
        pa = fleet.free_port()
        A = spawn_client(
            manage_port=pa, stores=store_addrs, journal=f"{tmp}/a.journal", seed=11,
            roots=n_roots, crash_after_moved=crash_after, gossip_interval_s=0.1,
            wait_ready=False,
        )
        C = None
        try:
            fleet.wait_manage(
                pa, "/membership", 180, proc=A["proc"],
                predicate=lambda d: d.get("reshard_catalog_roots", 0) >= n_roots,
            )
            resp = fleet.manage_post_json(pa, "/membership", {
                "action": "add", "host": "127.0.0.1",
                "service_port": joiner["service_port"],
            })
            assert resp.get("status") == "ok", resp
            # The scripted faults.crash_process fires at the 2nd migrated
            # root: a real SIGKILL mid-reshard.
            assert fleet.wait_member_exit(A, timeout_s=120) == -9
            fleet.restart_member(A, timeout_s=180)
            doc = fleet.wait_manage(
                pa, "/membership", 180, proc=A["proc"],
                predicate=lambda d: (
                    d.get("membership_settled") == 1
                    and d.get("reshard_debt_roots") == 0
                    and d.get("reshard_active") == 0
                ),
            )
            assert doc["membership_members"] == 3
            assert doc["journal_replay_records"] >= n_roots
            events = fleet.manage_json(pa, "/events")["events"]
            restart_ev = [e for e in events if e["kind"] == "client_restart"]
            assert restart_ev
            assert restart_ev[0]["attrs"]["recovered_roots"] == n_roots
            assert restart_ev[0]["attrs"]["resume_reshard"] is True
            # Cold bootstrap + byte-verify: 0 wrong, 0 misses.
            C = spawn_client(peers=[f"127.0.0.1:{pa}"], seed=11, roots=n_roots,
                             bootstrap=True, verify=True, wait_ready=False, capture=True)
            out, _ = C["proc"].communicate(timeout=240)
            report = json.loads(out.decode().strip().splitlines()[-1])
            assert report["reads"] == n_roots
            assert report["wrong"] == 0
            assert report["misses"] == 0
            assert report["members"] == 3
        finally:
            members = [A] + stores + [joiner]
            if C is not None:
                members.append(C)
            fleet.stop_members(members)
            shutil.rmtree(tmp, ignore_errors=True)
