"""Isolation guards of the PyTorch port.

- No module of ``infinistore_tpu_torch`` (nor ``chip_smoke.py``) imports jax
  or anything of ``infinistore_tpu``: the port keeps its own copies.
- ``import infinistore_tpu_torch`` is light: it pulls in neither jax, triton
  nor the JAX package, and compiles nothing (the native library and the
  kernels are built at first use).
- The cluster, membership and fault-injection modules import neither jax
  nor the kernels, and resolve lazily from the package; the serving modules
  (the v1 connector, the trace generator, the benchmark CLI and the fleet
  client) import no jax, and the v1 names resolve lazily to ``vllm_v1``.
- Without a card, an entry point called without ``device=`` raises instead
  of running on the CPU (the cluster's default member factory, the
  benchmark CLI and the fleet client too), and the
  client library refuses to register a tensor that does not live on the CPU.
- The training modules (the pipeline, the expert-parallel step) and the
  ``shaping`` copy import no jax and nothing of the JAX package, and
  compile nothing.
- The tensor-parallel train step and the multi-chip dryrun import no jax
  and nothing of the JAX package, start no process and compile nothing at
  import; their names resolve lazily from ``models`` and the package.
- The multi-device serving modules (the block transfer, ring and Ulysses
  attention, the long-context prefill) import no jax and compile nothing;
  the ``models`` names of the sequence-parallel modules resolve lazily; the
  sequence-parallel entry points raise without a process group, and the
  transfer refuses shard indices outside its mesh and a mesh on a card
  that is not there.
"""

import ast
import os
import subprocess
import sys
import textwrap
import types

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "infinistore_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "infinistore_tpu")


def _port_sources():
    for root, _dirs, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_nothing_of_jax_or_the_jax_package():
    offenders = [
        (os.path.relpath(path, REPO), root)
        for path in _port_sources()
        for root in _imported_roots(path)
        if root in FORBIDDEN
    ]
    assert offenders == []
    assert sum(1 for _ in _port_sources()) > 10  # the scan saw the package
    scanned = {os.path.relpath(path, PORT) for path in _port_sources()}
    assert {"cluster.py", "membership.py", "faults.py"} <= scanned
    assert {"vllm_v1.py", "loadgen.py", "benchmark.py", "fleet_client.py"} <= scanned
    assert {os.path.join("cuda", "ici.py"), os.path.join("models", "ring_attention.py"),
            os.path.join("models", "ulysses.py"), os.path.join("models", "long_context.py")} <= scanned
    assert {os.path.join("models", "pipeline.py"), os.path.join("models", "expert_parallel.py"),
            "shaping.py"} <= scanned
    assert {os.path.join("models", "tensor_parallel.py"), "dryrun.py"} <= scanned


def test_package_import_is_light_and_builds_nothing():
    script = textwrap.dedent(
        """
        import subprocess, sys

        def refuse(*args, **kwargs):
            raise AssertionError(f"import started a process: {args[:1]}")

        subprocess.Popen = refuse
        import infinistore_tpu_torch
        import infinistore_tpu_torch.cuda.paged
        import infinistore_tpu_torch.cuda.paged_attention
        import infinistore_tpu_torch.cuda.flash_prefill
        import infinistore_tpu_torch.cuda.kv_quant
        import infinistore_tpu_torch.models.llama
        import infinistore_tpu_torch.engine
        from infinistore_tpu_torch.cuda import _ext
        assert _ext._lib is None, "kernel library loaded at import"
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "triton", "infinistore_tpu"))
        assert not bad, bad
        assert "infinistore_tpu_torch._native" not in sys.modules
        # The cluster's names resolve lazily: nothing of it, of membership
        # or of fault injection is imported with the package.
        for name in ("ClusterKVConnector", "CircuitBreaker", "rendezvous_owner",
                     "rendezvous_ranked", "MemberState", "Membership", "MembershipView",
                     "Resharder", "FaultRule", "FaultyConnection", "kill_transport"):
            assert name in infinistore_tpu_torch.__all__, name
        for mod in ("cluster", "membership", "faults", "lib", "connector"):
            assert f"infinistore_tpu_torch.{mod}" not in sys.modules, mod
        print("light")
        """
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "light"


def test_cluster_modules_import_neither_jax_nor_kernels():
    """The cluster, membership and fault-injection modules load the store
    library (built from ``native/`` if it is not yet) and nothing else: no
    jax, no triton, nothing of the JAX package, no kernel library; and the
    package's lazy names are those modules' objects."""
    script = textwrap.dedent(
        """
        import sys
        import infinistore_tpu_torch as itt
        from infinistore_tpu_torch import cluster, faults, membership
        from infinistore_tpu_torch.cuda import _ext
        assert _ext._lib is None, "kernel library loaded at import"
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "triton", "infinistore_tpu"))
        assert not bad, bad
        assert itt.ClusterKVConnector is cluster.ClusterKVConnector
        assert itt.CircuitBreaker is cluster.CircuitBreaker
        assert itt.Resharder is membership.Resharder
        assert itt.MemberState is membership.MemberState
        assert itt.FaultyConnection is faults.FaultyConnection
        print("ok")
        """
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_default_to_the_card_and_raise_without_one(monkeypatch):
    from infinistore_tpu_torch.cluster import ClusterKVConnector
    from infinistore_tpu_torch.connector import KVConnector
    from infinistore_tpu_torch.cuda.kv_quant import QuantizedKVConnector
    from infinistore_tpu_torch.cuda.paged import PagedKVCacheSpec
    from infinistore_tpu_torch.cuda.staging import HostStagingPool
    from infinistore_tpu_torch.disagg import DisaggHarness, demo_config
    from infinistore_tpu_torch.engine import ContinuousBatchingHarness, EngineKVAdapter
    from infinistore_tpu_torch.models import llama

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = llama.LlamaConfig(dtype=torch.float32)
    spec = PagedKVCacheSpec(1, 4, 8, 2, 64, torch.float32)
    no_card = "no CUDA device"
    with pytest.raises(RuntimeError, match=no_card):
        llama.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match=no_card):
        llama.params_from_numpy({}, cfg)
    with pytest.raises(RuntimeError, match=no_card):
        spec.make_caches()
    with pytest.raises(RuntimeError, match=no_card):
        HostStagingPool(1 << 16, 1 << 12)
    with pytest.raises(RuntimeError, match=no_card):
        KVConnector(None, spec, "m", 4)
    with pytest.raises(RuntimeError, match=no_card):
        QuantizedKVConnector(None, spec, "m", 4)
    adapter = EngineKVAdapter(KVConnector(None, spec, "m", 4, device="cpu"))
    with pytest.raises(RuntimeError, match=no_card):
        ContinuousBatchingHarness(adapter, {}, cfg, 4, 2)
    with pytest.raises(RuntimeError, match=no_card):
        DisaggHarness(lambda: None, demo_config(n_layers=1))
    fake = types.SimpleNamespace(config=types.SimpleNamespace(host_addr="h", service_port=1))
    with pytest.raises(RuntimeError, match=no_card):
        ClusterKVConnector([fake], spec, "m", 4)
    # Asked for the CPU explicitly, they run there.
    assert spec.make_caches(device="cpu")[0][0].device.type == "cpu"
    harness = ContinuousBatchingHarness(adapter, {}, cfg, 4, 2, device="cpu")
    assert harness.caches[0][0].device.type == "cpu"
    disagg_harness = DisaggHarness(lambda: None, demo_config(n_layers=1), device="cpu")
    assert disagg_harness.params["embed"].device.type == "cpu"
    assert disagg_harness.fresh_caches()[0][0].device.type == "cpu"
    # The prefill role's process, with no card visible and no --device, raises
    # before it connects to anything (the port it is given has no store).
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "infinistore_tpu_torch.disagg", "--port", "1"],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert no_card in out.stderr
    # The store server needs no card: its module starts without one
    # (tests/test_torch_disagg_overlap.py drives it on its ports).
    out = subprocess.run([sys.executable, "-m", "infinistore_tpu_torch.server", "--help"],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--manage-port" in out.stdout


@pytest.mark.parametrize("argv", [
    ["-m", "infinistore_tpu_torch.benchmark", "--wave", "4", "--service-port", "1"],
    ["-m", "infinistore_tpu_torch.fleet_client", "--roots", "1", "--stores", "127.0.0.1:1"],
])
def test_serving_entry_points_raise_without_a_card(argv):
    """The benchmark CLI and the fleet client, with no card visible and no
    --device, exit non-zero before they connect to anything."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, *argv], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


def test_serving_modules_import_neither_jax_nor_the_jax_package():
    """The v1 connector, the trace generator, the benchmark CLI and the
    fleet client import nothing of jax or the JAX package, and the
    package's lazy v1 names are ``vllm_v1``'s objects."""
    script = textwrap.dedent(
        """
        import sys
        import infinistore_tpu_torch as itt
        from infinistore_tpu_torch import benchmark, fleet_client, loadgen, vllm_v1
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "triton", "infinistore_tpu"))
        assert not bad, bad
        for name in ("InfiniStoreKVConnectorV1", "KVConnectorRole", "KVConnectorMetadata",
                     "KVLoadUnderDelivery"):
            assert name in itt.__all__, name
            assert getattr(itt, name) is getattr(vllm_v1, name), name
        print("ok")
        """
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_register_mr_refuses_tensors_off_the_cpu():
    from infinistore_tpu_torch import lib

    with pytest.raises(ValueError, match="not the CPU"):
        lib._extract_ptr_size(torch.empty(16, device="meta"), None)
    fake_cuda = types.SimpleNamespace(
        data_ptr=lambda: 0x1000, is_cuda=True, device=torch.device("cuda", 0),
        element_size=lambda: 1, nelement=lambda: 16,
    )
    with pytest.raises(ValueError, match="not the CPU"):
        lib._extract_ptr_size(fake_cuda, None)
    host = torch.zeros(16, dtype=torch.uint8)
    assert lib._extract_ptr_size(host, None) == (host.data_ptr(), 16)


def test_multi_device_modules_are_light_and_refuse_misuse(monkeypatch):
    script = textwrap.dedent(
        """
        import subprocess, sys

        def refuse(*args, **kwargs):
            raise AssertionError(f"import started a process: {args[:1]}")

        subprocess.Popen = refuse
        import infinistore_tpu_torch.models as models
        for mod in ("ring_attention", "ulysses", "long_context"):
            assert f"infinistore_tpu_torch.models.{mod}" not in sys.modules, mod
        from infinistore_tpu_torch.models import long_context, ulysses
        assert models.prefill_ring is long_context.prefill_ring
        assert models.ulysses_attention is ulysses.ulysses_attention
        from infinistore_tpu_torch.models import ring_attention
        assert models.dense_attention_reference is ring_attention.dense_attention_reference
        import infinistore_tpu_torch.cuda.ici
        from infinistore_tpu_torch.cuda import _ext
        assert _ext._lib is None, "kernel library loaded at import"
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "triton", "infinistore_tpu"))
        assert not bad, bad
        print("ok")
        """
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"

    from infinistore_tpu_torch.cuda.ici import IciBlockTransfer, mesh_from_devices
    from infinistore_tpu_torch.models import llama, ring_attention, ulysses
    from infinistore_tpu_torch.models.long_context import prefill_ring

    x = torch.zeros(1, 4, 2, 8)
    for fn in (ring_attention.ring_attention, ulysses.ulysses_attention):
        with pytest.raises(RuntimeError, match="process group"):
            fn(x, x, x)
    cfg = llama.LlamaConfig(dtype=torch.float32, n_layers=1)
    with pytest.raises(RuntimeError, match="process group"):
        prefill_ring(llama.init_params(cfg, torch.Generator(), device="cpu"),
                     torch.zeros(1, 8, dtype=torch.long), cfg)
    with pytest.raises(ValueError, match="out of range"):
        IciBlockTransfer(["cpu", "cpu"], "store", perm=[(0, 2)])
    tr = IciBlockTransfer(["cpu", "cpu"], "store", perm=[(0, 1)])
    cache = [torch.zeros(4, 2), torch.zeros(4, 2)]
    for src, dst in ((-1, 1), (0, 2)):
        with pytest.raises(ValueError, match="out of range"):
            tr.handoff_blocks(cache, [0], [1], src, dst)
        with pytest.raises(ValueError, match="out of range"):
            tr.send_blocks(cache, [0], src, dst)
    assert tr.launches == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_from_devices()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IciBlockTransfer(["cuda:0", "cuda:0"], "store", perm=[(0, 1)])


def test_training_modules_import_neither_jax_nor_the_jax_package():
    """The pipeline, the expert-parallel step and the ``shaping`` copy load
    nothing of jax, triton or the JAX package; the training modules start no
    process and build no kernel library; ``models`` exports ``loss_fn`` and
    ``train_step``."""
    script = textwrap.dedent(
        """
        import subprocess, sys

        def refuse(*args, **kwargs):
            raise AssertionError(f"import started a process: {args[:1]}")

        popen, subprocess.Popen = subprocess.Popen, refuse
        from infinistore_tpu_torch.models import expert_parallel, pipeline
        import infinistore_tpu_torch.models as models
        assert models.loss_fn is models.llama.loss_fn
        assert models.train_step is models.llama.train_step
        assert {"loss_fn", "train_step"} <= set(models.__all__)
        from infinistore_tpu_torch.cuda import _ext
        assert _ext._lib is None, "kernel library loaded at import"
        # shaping loads the store library, built from native/ at its first use.
        subprocess.Popen = popen
        from infinistore_tpu_torch import shaping
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "triton", "infinistore_tpu"))
        assert not bad, bad
        print("ok")
        """
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_tensor_parallel_and_dryrun_modules_are_light():
    """``models/tensor_parallel.py`` and ``dryrun.py`` load nothing of jax,
    triton or the JAX package, start no process and build no kernel library
    when imported; ``models`` and the package resolve their names lazily."""
    script = textwrap.dedent(
        """
        import subprocess, sys

        def refuse(*args, **kwargs):
            raise AssertionError(f"import started a process: {args[:1]}")

        subprocess.Popen = refuse
        import infinistore_tpu_torch as itt
        import infinistore_tpu_torch.models as models
        assert "infinistore_tpu_torch.models.tensor_parallel" not in sys.modules
        assert "infinistore_tpu_torch.dryrun" not in sys.modules
        from infinistore_tpu_torch import dryrun
        from infinistore_tpu_torch.models import tensor_parallel
        assert models.make_tp_train_step is tensor_parallel.make_tp_train_step
        assert models.tp_loss_and_grads is tensor_parallel.tp_loss_and_grads
        assert itt.dryrun_multichip is dryrun.dryrun_multichip
        assert "make_tp_train_step" in models.__all__ and "dryrun_multichip" in itt.__all__
        from infinistore_tpu_torch.cuda import _ext
        assert _ext._lib is None, "kernel library loaded at import"
        import torch.distributed as dist
        assert not dist.is_initialized(), "a process group at import"
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "triton", "infinistore_tpu"))
        assert not bad, bad
        print("ok")
        """
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
