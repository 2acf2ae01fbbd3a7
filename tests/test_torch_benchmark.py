"""The port's benchmark CLI (``python -m infinistore_tpu_torch.benchmark``)
against the port's server CLI, on the CPU.

- The two benchmark tests of ``tests/test_server_cli.py`` (the batched
  data plane and the single-key TCP path), verified and with positive
  rates.
- ``--wave 4 --device cpu``: the coalescing and decode-wave legs (K6 and
  K3's plain versions) report every key of the JAX package's CLI with
  positive values.
- ``--trace skewed --device cpu``: a loadgen trace replays through the
  port's continuous-batching engine with every request verified.
- The trace leg's engine model takes the kernels' shapes.
"""

import json
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

from infinistore_tpu_torch import benchmark


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def cli_server():
    service_port, manage_port = _free_port(), _free_port()
    proc = subprocess.Popen(
        [
            sys.executable, "-m", "infinistore_tpu_torch.server",
            "--host", "127.0.0.1",
            "--service-port", str(service_port),
            "--manage-port", str(manage_port),
            "--prealloc-size", "1",
            "--minimal-allocate-size", "16",
            "--no-pin-memory",
            "--log-level", "error",
        ],
    )
    deadline = time.time() + 60
    while time.time() < deadline:
        try:
            with socket.create_connection(("127.0.0.1", service_port), timeout=0.3):
                pass
            urllib.request.urlopen(f"http://127.0.0.1:{manage_port}/health", timeout=0.5)
            break
        except OSError:
            time.sleep(0.1)
    else:
        proc.terminate()
        pytest.fail("CLI server did not come up")
    yield {"service_port": service_port, "manage_port": manage_port}
    proc.send_signal(2)
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()


def _bench(cli_server, *args, timeout=300):
    out = subprocess.run(
        [sys.executable, "-m", "infinistore_tpu_torch.benchmark",
         "--service-port", str(cli_server["service_port"]), *args],
        capture_output=True, text=True, timeout=timeout,
    )
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_benchmark_cli_rdma(cli_server):
    result = _bench(cli_server, "--size", "16", "--block-size", "64", "--steps", "4",
                    "--json", "--device", "cpu")
    assert result["verified"] is True
    assert result["write_mb_s"] > 0 and result["read_mb_s"] > 0


def test_benchmark_cli_tcp(cli_server):
    result = _bench(cli_server, "--size", "4", "--block-size", "64", "--type", "tcp",
                    "--json", "--device", "cpu")
    assert result["verified"] is True


def test_benchmark_cli_wave_on_the_plain_versions(cli_server):
    result = _bench(cli_server, "--size", "4", "--block-size", "64", "--wave", "4",
                    "--json", "--device", "cpu")
    assert result["verified"] is True
    coalescing = result["coalescing"]
    assert coalescing["wave_requests"] == 4
    for key in ("wave_split_mb_s", "wave_merged_mb_s", "wave_coalescing_gain"):
        assert coalescing[key] > 0, key
    decode = result["decode_wave"]
    assert decode["wave_decode_requests"] == 4
    for key in ("wave_decode_skew_factor", "wave_decode_ragged_us", "wave_decode_padded_us",
                "wave_decode_ragged_gain"):
        assert decode[key] > 0, key
    assert result["completion_batch_size"] > 0


def test_benchmark_cli_trace_replay_verified(cli_server):
    result = _bench(cli_server, "--trace", "skewed", "--json", "--device", "cpu")
    assert result["verified"] is True
    assert result["trace"] == "skewed"
    assert result["trace_requests"] > 0
    assert result["decode_waves"] > 0
    for key in ("replay_wall_s", "requests_per_s", "p50_ttft_us", "p99_ttft_us",
                "wave_pad_fraction", "hit_rate", "wave_deferrals", "wave_aging_escapes",
                "wave_held_flushes", "wave_defer_age_us_p99", "p99_ttft_fg_us",
                "trace_prefill_only", "trace_background", "trace_seed", "skew_policy"):
        assert key in result, key


def test_trace_model_takes_the_kernels_shapes():
    """head_dim 64 and 2 query heads per KV head, shapes K3, K4 and K6 take
    (the JAX package's trace model, head_dim 16, is one they refuse); the
    rest of the JAX package's model is kept."""
    from infinistore_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig(**benchmark.TRACE_MODEL)
    assert cfg.head_dim == 64
    assert cfg.n_heads // cfg.n_kv_heads in (1, 2, 4, 8)
    assert (cfg.vocab, cfg.n_layers, cfg.block_tokens) == (128, 2, 8)


def test_chip_smoke_serving_cli_path_rehearsal_on_cpu():
    """``chip_smoke._run_serving_cli`` on the CPU at a smaller store leg:
    the benchmark's store, decode-wave and trace legs verified in process,
    the module entry point started, and a fleet client's seed, stop and
    in-process ``--verify`` reading every root right."""
    import os
    import sys

    import torch

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    import chip_smoke

    summary, launches = chip_smoke._run_serving_cli(
        torch, "cpu", benchmark_args=("--wave", "4", "--size", "8"), roots=2)
    assert summary["benchmark_store"]["verified"] is True
    assert summary["benchmark_store"]["decode_wave"]["wave_decode_requests"] == 4
    assert summary["benchmark_trace"]["verified"] is True
    assert summary["fleet_verify"]["reads"] == 2
    assert summary["fleet_verify"]["wrong"] == 0
    assert summary["fleet_verify"]["misses"] == 0
    # The plain versions count no launch: only a kernel launch does.
    assert set(chip_smoke.PATH_KERNELS["serving_cli"]) <= set(launches)
    assert all(launches[name] == 0 for name in chip_smoke.PATH_KERNELS["serving_cli"])


def test_chip_smoke_decode_wave_leg_check_rehearsal_on_cpu():
    """``chip_smoke._decode_wave_leg_check`` on the CPU, untimed: it builds
    the decode-wave leg's own inputs (``benchmark.decode_wave_inputs``) at
    the serving_cli path's wave and holds K6 and K3 (their plain versions
    here) against the plain functions, and the leg's K6 and K3 agree on
    every row."""
    import os
    import sys

    import torch

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    import chip_smoke

    rows = chip_smoke._decode_wave_leg_check(torch, None, device="cpu")
    assert set(rows) == {"paged_decode_attention", "paged_decode_attention_ragged"}
    for row in rows.values():
        assert row["rows"] == chip_smoke.SERVING_WAVE
        assert row["max_abs_err"] == 0.0
        assert row["distinct_pages"] <= row["pages"]
    ragged, padded, x = benchmark.decode_wave_inputs(chip_smoke.SERVING_WAVE, "cpu")
    assert x.q.dtype == torch.float32 and tuple(x.q.shape) == (8, 8, 64)
    assert x.lens == [256] + [32] * 7
    torch.testing.assert_close(ragged(x.q), padded(x.q), rtol=0, atol=1e-5)
