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
- The trace leg's engine model is the JAX package's, value for value (head
  dim 16, a shape the kernels take), and on the same weights, carried
  across with ``params_from_numpy``, one trace request's prefill and 4
  decode steps give the JAX package's logits within 2e-4.
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


def _jax_trace_model():
    """The JAX package's trace-leg ``LlamaConfig(...)`` keywords, read from
    its source (``infinistore_tpu/benchmark.py: _run_trace``): constants as
    they stand, the dtype by its name."""
    import ast
    import inspect

    from infinistore_tpu import benchmark as jbench

    tree = ast.parse(inspect.getsource(jbench._run_trace))
    call, = [node for node in ast.walk(tree) if isinstance(node, ast.Call)
             and getattr(node.func, "id", None) == "LlamaConfig"]
    return {kw.arg: (kw.value.attr if kw.arg == "dtype" else ast.literal_eval(kw.value))
            for kw in call.keywords}


def test_trace_model_takes_the_kernels_shapes():
    """``TRACE_MODEL`` is the JAX package's trace model, value for value:
    dim 64, 4 heads over 2 KV heads (head_dim 16, which K3, K4 and K6
    take), ffn 128, 2 layers, block 8, vocab 128, f32."""
    import torch

    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.models.llama import LlamaConfig

    want = _jax_trace_model()
    got = dict(benchmark.TRACE_MODEL)
    assert got.pop("dtype") is torch.float32 and want.pop("dtype") == "float32"
    assert got == want
    cfg = LlamaConfig(**benchmark.TRACE_MODEL)
    assert cfg.head_dim == 16 and cfg.head_dim in _ext.HEAD_DIMS


def test_trace_model_logits_match_jax_on_carried_weights():
    """The trace leg's model in both packages on the JAX package's
    ``init_params(PRNGKey(0))`` weights, carried across with
    ``params_from_numpy``: the first request of the skewed trace that fits
    its table with 4 tokens to spare is prefilled, then decoded 4 greedy
    steps, on the trace leg's 96-block cache and 8-block table. Logits agree
    within 2e-4 (f32, the tolerance of tests/test_torch_llama.py)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from infinistore_tpu.models import llama as jl
    from infinistore_tpu_torch import loadgen
    from infinistore_tpu_torch.models import llama as tl

    tol, steps, num_blocks, max_blocks = 2e-4, 4, 96, 8
    shape = {k: v for k, v in benchmark.TRACE_MODEL.items() if k != "dtype"}
    jcfg = jl.LlamaConfig(dtype=jnp.float32, **shape)
    tcfg = tl.LlamaConfig(**benchmark.TRACE_MODEL)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = tl.params_from_numpy({k: np.asarray(v) for k, v in jparams.items()}, tcfg,
                                   device="cpu")
    trace = loadgen.preset("skewed", seed=0, duration_s=0.4)
    bt = tcfg.block_tokens
    prompts = trace.prompts(bt, vocab=tcfg.vocab, max_blocks=max_blocks)
    prompt = next(p for p in prompts if len(p) + steps <= max_blocks * bt)
    table = np.arange(max_blocks, dtype=np.int32) * 11 % num_blocks  # 0, 11, 22, ...
    n = -(-len(prompt) // bt)
    tokens = np.asarray(prompt, np.int32)
    jc = jcfg.kv_spec(num_blocks).make_caches()
    tc = tcfg.kv_spec(num_blocks).make_caches(device="cpu")
    jlog, jc = jl.prefill(jparams, jnp.asarray(tokens), jc, jnp.asarray(table[:n]), jcfg)
    tlog, tc = tl.prefill(tparams, tokens, tc, table[:n], tcfg)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=tol, atol=tol)
    tok = int(jnp.argmax(jlog))
    for step in range(steps):
        pos = len(prompt) + step
        jlog, jc = jl.decode_step(jparams, jnp.int32(tok), jnp.int32(pos), jc,
                                  jnp.asarray(table), jcfg, max_blocks)
        tlog, tc = tl.decode_step(tparams, tok, pos, tc, table, tcfg, max_blocks)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=tol, atol=tol,
                                   err_msg=f"decode step {step}")
        tok = int(jnp.argmax(jlog))


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
    assert summary["trace_model"]["dim"] == "64"  # the JAX package's
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
