"""The AFMoE block's kernels on the card: K3, K6 and K4 over a sliding
window against their plain versions (and, at window 0, bitwise the launch
without a window); the routed experts' grouped GEMM (``cuda/moe.py``)
against its plain version, also replayed from a CUDA graph with other
row ends; and a tiny AFMoE's decode wave replayed as a CUDA graph, bitwise
the eager call, counters included.

Needs an NVIDIA GPU and nvcc; skipped elsewhere (the decision is
taken in a fixture, never at import). On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_afmoe.py
"""

import asyncio
import json
import os

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-5)])
@pytest.mark.parametrize("window", [0, 100, 2048])
def test_windowed_decode_kernels_match_their_plain_versions(dev, dtype, tol, window):
    from infinistore_tpu_torch.cuda import paged_attention as pa

    g = torch.Generator(device=dev).manual_seed(window)
    rows, h, kvh, d, bt, nb, n = 6, 32, 4, 128, 16, 256, 2048
    q = torch.randn(rows, h, d, generator=g, device=dev).to(dtype)
    kc = torch.randn(n, bt, kvh, d, generator=g, device=dev).to(dtype)
    vc = torch.randn(n, bt, kvh, d, generator=g, device=dev).to(dtype)
    tables = torch.randperm(n, generator=g, device=dev)[: rows * nb].reshape(rows, nb).to(
        torch.int32)
    lens = torch.tensor([4096, 4095, 2049, 2048, 17, 0], dtype=torch.int32, device=dev)
    got = pa.paged_decode_attention_batched(q, kc, vc, tables, lens, window=window)
    want = pa.paged_decode_attention_plain_batched(q, kc, vc, tables, lens, window=window)
    assert float((got.float() - want.float()).abs().max()) <= tol
    meta = pa.build_ragged_wave(list(tables.cpu().numpy()), lens.tolist(), bt, pad_to_pow2=True)
    ragged = pa.paged_decode_attention_ragged(q, kc, vc, meta.pages, meta.page_rows,
                                              meta.page_starts, meta.seq_lens,
                                              table_width=nb, window=window)
    assert float((ragged.float() - want.float()).abs().max()) <= tol
    if window == 0:
        assert torch.equal(got, pa.paged_decode_attention_batched(q, kc, vc, tables, lens))


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-5)])
@pytest.mark.parametrize("window", [64, 1000])
def test_windowed_flash_prefill_matches_its_plain_version(dev, dtype, tol, window):
    from infinistore_tpu_torch.cuda import flash_prefill as fp

    g = torch.Generator(device=dev).manual_seed(window)
    s, h, kvh, d = 1500, 32, 4, 128
    q, k, v = (torch.randn(1, s, n, d, generator=g, device=dev).to(dtype)
               for n in (h, kvh, kvh))
    got = fp.flash_prefill_attention(q, k, v, causal=True, window=window)
    want = fp.flash_prefill_plain(q, k, v, causal=True, window=window)
    assert float((got.float() - want.float()).abs().max()) <= tol


def _routing(dev, tokens, experts, k, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    choice = torch.rand((tokens, experts), generator=g, device=dev).topk(k, dim=-1).indices
    flat = choice.reshape(-1)
    counts = torch.zeros(experts, dtype=torch.int64, device=dev).scatter_add_(
        0, flat, torch.ones_like(flat))
    return torch.cumsum(counts, 0).to(torch.int32)


@pytest.mark.parametrize("tokens", [1, 16, 700])
def test_grouped_gemm_matches_its_plain_version_and_replays_from_a_graph(dev, tokens):
    from infinistore_tpu_torch.cuda import moe

    e, k, dim, f = 32, 4, 256, 128
    g = torch.Generator(device=dev).manual_seed(tokens)
    w = (torch.randn(e, dim, f, generator=g, device=dev) * dim ** -0.5).to(torch.bfloat16)
    x = torch.randn(tokens * k, dim, generator=g, device=dev).to(torch.bfloat16)
    ends = _routing(dev, tokens, e, k, 1)
    got = moe.grouped_gemm(x, w, ends)
    want = moe.grouped_gemm_plain(x, w, ends)
    assert float((got.float() - want.float()).abs().max()) <= 2e-2
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = moe.grouped_gemm(x, w, ends)
    ends.copy_(_routing(dev, tokens, e, k, 2))
    graph.replay()
    want = moe.grouped_gemm_plain(x, w, ends)
    assert float((out.float() - want.float()).abs().max()) <= 2e-2


def test_a_tiny_afmoe_wave_replays_bitwise_the_eager_call(dev):
    from h100bench.arch import afmoe
    from infinistore_tpu_torch import engine
    from infinistore_tpu_torch.engine import DeviceGate, WaveDecoder
    from infinistore_tpu_torch.models import llama

    with open(os.path.join(ROOT, "h100bench", "tests", "data", "tiny_afmoe_config.json")) as fh:
        tiny = dict(json.load(fh), torch_dtype="bfloat16", hidden_size=128, head_dim=32)
    cfg = afmoe.program(tiny)
    params = afmoe.params(tiny, 5, dev, torch.bfloat16)
    caches = cfg.kv_spec(32).make_caches(device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    for kc, vc in caches:
        kc.normal_(generator=g)
        vc.normal_(generator=g)
    h = engine.ContinuousBatchingHarness.__new__(engine.ContinuousBatchingHarness)
    h.params, h.config, h.max_req_blocks = params, cfg, 8
    h.gate, h.caches = DeviceGate(), caches
    wave = WaveDecoder(h)
    assert wave.counting
    seen = []
    launch = wave._launch_graphed

    def spy(t, t_real, host):
        seen.append(host)
        return launch(t, t_real, host)

    wave._launch_graphed = spy

    def one_wave():
        async def go():
            return await asyncio.gather(*(
                wave.step(i + 1, 40 + i, np.arange(8 * i, 8 * i + 8, dtype=np.int32))
                for i in range(3)))

        return torch.stack(asyncio.run(go()))

    one_wave()
    before = [(kc.clone(), vc.clone()) for kc, vc in h.caches]
    rows = one_wave()
    assert (wave.graph_captures, wave.graph_replays) == (1, 1)
    args = engine._int32_on(dev, *seen[-1])
    counts = llama.LaunchCounts()
    want, _ = llama.verify_step_ragged(params, *args[:6], before, args[6], cfg, 8,
                                       counts=counts)
    torch.cuda.synchronize()
    assert torch.equal(rows, want[:3])
    (graph,) = wave._graphs.values()
    assert torch.equal(graph.counts, counts.total())
