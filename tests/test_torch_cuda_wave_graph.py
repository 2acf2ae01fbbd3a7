"""The port's decode waves replayed as CUDA graphs (``engine.WaveDecoder``,
"CUDA graphs") on the card:

- at Mistral-7B's widths (2 of its 32 layers, bf16), the rungs T = 1, 2,
  4, 8 and 16 captured in turn (each capture may grow the capture stream's
  split workspace), then each rung's replayed wave gives logits and cache
  bytes bitwise equal to an eager ``verify_step_ragged`` call on the same
  canonical bucket, and counts its K6 launches;
- a mixed wave (two decode rows beside a 3-token verification chunk)
  replayed equals each request decoded alone within the engine's stated
  tolerance (1e-5, f32).

Needs an NVIDIA GPU and nvcc; skipped elsewhere (the decision is taken in a
fixture, never at import). On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_wave_graph.py
"""

import asyncio

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _bare_harness(params, cfg, caches, max_req_blocks):
    from infinistore_tpu_torch.engine import ContinuousBatchingHarness, DeviceGate

    h = ContinuousBatchingHarness.__new__(ContinuousBatchingHarness)
    h.params, h.config, h.max_req_blocks, h.gate = params, cfg, max_req_blocks, DeviceGate()
    h.caches = caches
    return h


def test_replayed_rungs_are_bitwise_the_eager_call_at_mistral_widths(dev):
    from infinistore_tpu_torch import engine
    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.engine import WaveDecoder
    from infinistore_tpu_torch.models import llama

    cfg = llama.LlamaConfig(vocab=32768, dim=4096, n_layers=2, n_heads=32, n_kv_heads=8,
                            ffn_dim=14336, block_tokens=16, rope_theta=1e6,
                            dtype=torch.bfloat16)
    mrb, rungs = 16, (1, 2, 4, 8, 16)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    caches = cfg.kv_spec(16 * mrb).make_caches(device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    for k, v in caches:
        k.normal_(generator=g)
        v.normal_(generator=g)
    h = _bare_harness(params, cfg, caches, mrb)
    wave = WaveDecoder(h)
    assert wave.capture is engine.capture_cuda_graph
    seen = []
    launch = wave._launch_graphed

    def spy(t, t_real, host):
        seen.append(host)
        return launch(t, t_real, host)

    wave._launch_graphed = spy
    rng = np.random.default_rng(2)

    def one_wave(t):
        """T one-token rows, request i on blocks [16i, 16i + 16): no two rows
        write one slot."""
        pos = rng.integers(0, mrb * cfg.block_tokens, t)
        toks = rng.integers(0, cfg.vocab, t)

        async def go():
            return await asyncio.gather(*(
                wave.step(int(toks[i]), int(pos[i]), np.arange(16 * i, 16 * i + 16,
                                                               dtype=np.int32))
                for i in range(t)))

        return torch.stack(asyncio.run(go()))

    for t in rungs:
        one_wave(t)
    assert wave.graph_captures == len(rungs) and wave.graph_replays == 0
    for t in rungs:
        before = [(k.clone(), v.clone()) for k, v in h.caches]
        k6 = _ext.LAUNCHES["paged_decode_attention_ragged"]
        rows = one_wave(t)
        torch.cuda.synchronize()
        assert _ext.LAUNCHES["paged_decode_attention_ragged"] - k6 == cfg.n_layers
        args = engine._int32_on(dev, *seen[-1])
        want, after = llama.verify_step_ragged(params, *args[:6], before, args[6], cfg, mrb)
        torch.cuda.synchronize()
        assert torch.equal(rows, want[:t]), t
        for (gk, gv), (ek, ev) in zip(h.caches, after):
            assert torch.equal(gk, ek) and torch.equal(gv, ev), t
    assert wave.graph_replays == len(rungs) and wave.eager_waves == 0
    assert wave.bucket_sizes == {(t, t, t * mrb) for t in rungs}


def test_replayed_mixed_wave_matches_sequential_decode(dev):
    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.engine import WaveDecoder
    from infinistore_tpu_torch.models import llama

    cfg = llama.LlamaConfig(vocab=128, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
                            ffn_dim=256, block_tokens=8, dtype=torch.float32)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    rng = np.random.default_rng(61)
    tables = np.array([[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]], np.int32)
    base = cfg.kv_spec(16).make_caches(device=dev)
    for tab in tables:
        _, base = llama.prefill(params, rng.integers(0, cfg.vocab, 16).tolist(), base, tab[:2], cfg)
    chunks = [([5], [16]), ([9, 11, 12], [16, 17, 18]), ([13], [16])]

    def fresh():
        return _bare_harness(params, cfg, [(k.clone(), v.clone()) for k, v in base], 4)

    async def mixed(wave):
        return await asyncio.gather(*(wave.step_chunk(t, p, tables[b])
                                      for b, (t, p) in enumerate(chunks)))

    h = fresh()
    wave = WaveDecoder(h)
    asyncio.run(mixed(wave))  # captures the rung; rewrites these slots alike
    k6 = _ext.LAUNCHES["paged_decode_attention_ragged"]
    w_outs = asyncio.run(mixed(wave))
    torch.cuda.synchronize()
    assert (wave.graph_captures, wave.graph_replays, wave.max_wave) == (1, 1, 3)
    assert _ext.LAUNCHES["paged_decode_attention_ragged"] - k6 == cfg.n_layers

    s = fresh()
    s_outs = []
    for b, (t, p) in enumerate(chunks):
        solo = WaveDecoder(s)
        solo.capture = None  # each request alone, eagerly
        s_outs.append(asyncio.run(solo.step_chunk(t, p, tables[b])))
    torch.cuda.synchronize()
    for a, b in zip(w_outs, s_outs):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    for (wk, wv), (sk, sv) in zip(h.caches, s.caches):
        torch.testing.assert_close(wk, sk, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(wv, sv, rtol=1e-5, atol=1e-5)
