"""The port's AFMoE block (``LlamaConfig``'s AFMoE fields) against the plain
float32 reference of the benchmark (``h100bench/reference/afmoe.py``), on
the CPU, at a tiny AFMoE: hidden 64, head_dim 16, 8 heads over 2, 6 layers
(2 dense, then 4 with 8 experts top-2 plus a shared one), a window of 16 keys
on five of the six layers, block 8, seeded random weights drawn by the
benchmark (``h100bench/arch/afmoe.py``).

Tolerances. Program and reference both run in float32 here, so they differ
only in the order of their sums (the attention's splits and masks, the
experts' sorted rows and weighted sum): about 4e-6 of logits whose largest
is about 4.5. ``LOGIT_TOL`` = 1e-4 is 25 times that, and under a ten
thousandth of what a wrong window, RoPE on the full layer, a dropped
sandwich norm, a constant gate, a wrong route scale or normalisation, top-1
routing or a dropped expert bias moves a logit (each was tried: 1.47 to
4.56); the RMSNorm epsilon of Mistral's 1e-6 in place of 1e-5 moves one by
8.1e-4, eight times the tolerance. The attention paths
are held at 1e-5 against dense masked attention, the f32 tolerance of the
kernels' plain versions in ``test_torch_paged_attention.py``.
"""

import asyncio
import hashlib
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from h100bench.arch import afmoe
from infinistore_tpu_torch import engine
from infinistore_tpu_torch.cuda import flash_prefill as fp
from infinistore_tpu_torch.cuda import paged_attention as pa
from infinistore_tpu_torch.engine import ContinuousBatchingHarness
from infinistore_tpu_torch.models import llama as tl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "h100bench", "tests", "data", "tiny_afmoe_config.json")) as f:
    TINY = json.load(f)
SEED = 2**31 + 11
LOGIT_TOL = 1e-4
ATTN_TOL = 1e-5
WINDOW = TINY["sliding_window"]
BT = TINY["block_tokens"]


@pytest.fixture(scope="module")
def model():
    cfg = afmoe.program(TINY)
    params = afmoe.params(TINY, SEED, "cpu", torch.float32)
    ref = afmoe.reference(TINY, SEED, "cpu", torch.float32)
    return cfg, params, ref


def _tokens(n, seed=3):
    return torch.randint(0, TINY["vocab_size"], (n,),
                         generator=torch.Generator().manual_seed(seed)).tolist()


def _close(got, want):
    err = float((got.float() - want).abs().max())
    assert err <= LOGIT_TOL, err


def test_tiny_afmoe_config_is_the_published_layer_at_a_tiny_size(model):
    cfg, params, _ = model
    assert cfg.head_dim == 16 and cfg.n_heads * cfg.head_dim == 2 * cfg.dim
    assert [cfg.layer_window(i) for i in range(6)] == [16, 16, 16, 0, 16, 16]
    assert [cfg.ffn_kind(i) for i in range(6)] == ["dense"] * 2 + ["topk"] * 4
    assert cfg.counts_launches and cfg.norm_eps == 1e-5 and cfg.embed_scale == 8.0
    assert set(params) == set(tl._param_shapes(cfg))
    for name, shape in tl._param_shapes(cfg).items():
        assert tuple(params[name].shape) == shape, name


def test_prefill_then_paged_decode_matches_the_reference_across_the_window(model):
    """24 prompt tokens (three blocks) then 24 decode steps through the
    paged cache: every position's logits, on both sides of the window."""
    cfg, params, ref = model
    toks = _tokens(48)
    want = ref.logits([toks], [list(range(48))])[0]
    caches = cfg.kv_spec(8).make_caches(device="cpu")
    logits, caches = tl.prefill(params, toks[:24], caches, [5, 2, 7], cfg)
    _close(logits, want[23])
    table = torch.tensor([5, 2, 7, 0, 1, 3, 4, 6], dtype=torch.int32)
    for pos in range(24, 48):
        logits, caches = tl.decode_step(params, toks[pos], pos, caches, table, cfg, 8)
        _close(logits, want[pos])


def test_prefill_continue_after_a_loaded_prefix_matches_the_reference(model):
    """A prefix computed elsewhere and installed into other blocks (as a
    store load does), then a 24-token suffix in one continuation."""
    cfg, params, ref = model
    toks = _tokens(40, seed=4)
    want = ref.logits([toks], [list(range(16, 40))])[0]
    donor = cfg.kv_spec(2).make_caches(device="cpu")
    _, donor = tl.prefill(params, toks[:16], donor, [0, 1], cfg)
    caches = cfg.kv_spec(8).make_caches(device="cpu")
    for (k, v), (dk, dv) in zip(caches, donor):
        k[[6, 3]] = dk[[0, 1]]
        v[[6, 3]] = dv[[0, 1]]
    table = torch.tensor([6, 3, 1, 4, 5, 0, 2, 7], dtype=torch.int32)
    counts = tl.LaunchCounts()
    logits, _ = tl.prefill_continue(params, toks[16:], 16, caches, table, cfg, 8, counts=counts)
    _close(logits, want)
    reads, pairs, most, skipped = counts.total().tolist()
    assert pairs == 4 * 24 * 2 and 4 <= reads <= 4 * 8 and 1 <= most <= 24
    # Sliding layers: row p skips max(0, p + 1 - 16) keys, five such layers.
    assert skipped == 5 * sum(max(0, p + 1 - WINDOW) for p in range(16, 40))


def test_a_harness_wave_of_mixed_lengths_matches_the_reference(model):
    """Three requests prefilled to 16, 40 and 24 tokens ride one ragged wave
    with chunks of 1, 3 and 2 rows; each row's logits match the reference,
    and the wave's counters leave its tail padding out."""
    cfg, params, ref = model
    h = ContinuousBatchingHarness(SimpleNamespace(), params, cfg, 24, 8, device="cpu")
    lens, chunk = [16, 40, 24], [1, 3, 2]
    seqs = [_tokens(n + c, seed=10 + i) for i, (n, c) in enumerate(zip(lens, chunk))]
    tables = [np.arange(8 * i, 8 * i + 8, dtype=np.int32) for i in range(3)]
    for seq, n, tab in zip(seqs, lens, tables):
        _, h.caches = tl.prefill(params, seq[:n], h.caches, tab[: n // BT], cfg)
    want = ref.logits(seqs, [list(range(n, n + c)) for n, c in zip(lens, chunk)])
    sinks = [engine.DeviceCounts() for _ in seqs]

    async def one(seq, n, c, tab, sink):
        engine._DEVICE_COUNTS.set(sink)
        rows = await h.wave.step_chunk(seq[n:n + c], list(range(n, n + c)), tab)
        sink.settle(0.0)
        return rows

    async def go():
        return await asyncio.gather(*(one(*a) for a in zip(seqs, lens, chunk, tables, sinks)))

    got = asyncio.run(go())
    assert h.wave.waves == 1 and h.wave.eager_waves == 1
    for g, w in zip(got, want):
        _close(g, w)
    # The wave's 6 rows (padded to 8) shared by rows: 1/6, 3/6, 2/6.
    pairs = [s.totals()[1] for s in sinks]
    assert pairs == pytest.approx([4 * 6 * 2 * c / 6 for c in chunk])
    skipped = sum(s.totals()[3] for s in sinks)
    assert skipped == pytest.approx(5 * sum(max(0, p + 1 - WINDOW) for n, c in zip(lens, chunk)
                                            for p in range(n, n + c)))


@pytest.mark.parametrize("window", [1, 5, 16, 40])
def test_windowed_decode_kernels_plain_paths_match_dense_masked_attention(window):
    """K3's and K6's plain paths over a window against dense attention with
    the window's mask (rows attend keys seq_len - window .. seq_len - 1)."""
    g = torch.Generator().manual_seed(window)
    rows, h, kvh, d, bt, nb = 5, 8, 2, 16, 8, 6
    q = torch.randn(rows, h, d, generator=g)
    kc, vc = torch.randn(40, bt, kvh, d, generator=g), torch.randn(40, bt, kvh, d, generator=g)
    tables = torch.stack([torch.randperm(40, generator=g)[:nb] for _ in range(rows)]).to(
        torch.int32)
    lens = torch.tensor([48, 41, 16, 3, 1], dtype=torch.int32)
    want = torch.empty(rows, h, d)
    for r in range(rows):
        n = int(lens[r])
        k = kc[tables[r].long()].reshape(-1, kvh, d)[:n]
        v = vc[tables[r].long()].reshape(-1, kvh, d)[:n]
        mask = (torch.arange(n) >= n - window)[None, None, :]
        want[r] = tl._attention(q[r][None, None], k[None], v[None], mask)[0, 0]
    got = pa.paged_decode_attention_batched(q, kc, vc, tables, lens, window=window)
    assert float((got - want).abs().max()) <= ATTN_TOL
    meta = pa.build_ragged_wave(list(tables.numpy()), lens.tolist(), bt, pad_to_pow2=True)
    ragged = pa.paged_decode_attention_ragged(q, kc, vc, meta.pages, meta.page_rows,
                                              meta.page_starts, meta.seq_lens,
                                              table_width=nb, window=window)
    assert float((ragged - want).abs().max()) <= ATTN_TOL


@pytest.mark.parametrize("window", [1, 7, 16, 64])
def test_windowed_flash_prefill_plain_path_matches_dense_masked_attention(window):
    g = torch.Generator().manual_seed(window)
    s, h, kvh, d = 40, 8, 2, 16
    q, k, v = (torch.randn(1, s, n, d, generator=g) for n in (h, kvh, kvh))
    pos = torch.arange(s)
    mask = (pos[:, None] >= pos[None, :]) & (pos[None, :] > pos[:, None] - window)
    want = tl._attention(q, k, v, mask[None])
    got = fp.flash_prefill_attention(q, k, v, causal=True, window=window)
    assert float((got - want).abs().max()) <= ATTN_TOL


def test_router_matches_the_reference_and_the_bias_moves_the_choice_only(model):
    cfg, params, ref = model
    layer = 3
    w = {k: t.float() for k, t in afmoe.layer(ref.s, SEED, layer, "cpu", torch.float32).items()}
    m = torch.randn(64, cfg.dim, generator=torch.Generator().manual_seed(9))
    pre = f"l{layer}."
    choice, weights = tl.route(m, params[pre + "router"], params[pre + "expert_bias"], cfg)
    scores = torch.sigmoid(m @ w["router"])
    want_choice = torch.topk(scores + w["expert_bias"], cfg.moe_top_k, dim=-1).indices
    assert torch.equal(choice, want_choice)
    chosen = scores.gather(-1, choice)
    want = chosen / (chosen.sum(-1, keepdim=True) + 1e-20) * TINY["route_scale"]
    assert torch.allclose(weights, want, rtol=1e-6, atol=1e-7)
    assert torch.allclose(weights.sum(-1), torch.full((64,), TINY["route_scale"]), rtol=1e-6)
    # A large bias on one expert: it is chosen by every row, its weight is
    # still its bare score's share.
    bias = torch.zeros(cfg.n_experts)
    bias[5] = 10.0
    choice, weights = tl.route(m, params[pre + "router"], bias, cfg)
    assert bool((choice == 5).any(-1).all())
    got5 = (weights * (choice == 5)).sum(-1)
    other = scores.gather(-1, choice).sum(-1)
    assert torch.allclose(got5, scores[:, 5] / (other + 1e-20) * TINY["route_scale"], rtol=1e-6)
    # The program's routed mixture (grouped GEMM path) against the reference's.
    got = tl.routed_experts(m, choice, weights, params[pre + "w_gate_up_moe"],
                            params[pre + "w_down_moe"])
    ref_w = dict(w, expert_bias=bias)
    assert torch.allclose(got, ref._routed(m, ref_w), rtol=1e-5, atol=1e-5)


# SHA-256 (first 32 hex digits) of the tiny Llama's outputs with the AFMoE
# fields at their defaults, computed with the code before they existed: a
# 40-token prefill's last logits, 8 decode steps' logits and the cache after
# them, then one ragged wave of three chunks (float32, CPU, seed 0 weights).
_BEFORE = {
    "prefill_decode": "1b82b08117e26092622ec674c35a3d8c",
    "ragged_wave": "3984b12ffaf9e1d39e402ba362bcfc90",
}


def _digest(tensors) -> str:
    hsh = hashlib.sha256()
    for t in tensors:
        hsh.update(t.detach().float().contiguous().numpy().tobytes())
    return hsh.hexdigest()[:32]


def _llama_outputs():
    cfg = tl.LlamaConfig(vocab=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
                         block_tokens=8, dtype=torch.float32)
    params = tl.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.randint(0, 128, (48,), generator=torch.Generator().manual_seed(1)).tolist()
    caches = cfg.kv_spec(8).make_caches(device="cpu")
    outs = []
    logits, caches = tl.prefill(params, toks[:40], caches, [3, 1, 4, 0, 2], cfg)
    outs.append(logits)
    table = torch.tensor([3, 1, 4, 0, 2, 5, 6, 7], dtype=torch.int32)
    for pos in range(40, 48):
        logits, caches = tl.decode_step(params, toks[pos], pos, caches, table, cfg, 8)
        outs.append(logits)
    outs.extend(t for kv in caches for t in kv)
    tables = [np.array([3, 1, 4, 0, 2, 5, 6, 7], np.int32)] * 3
    flat_pos = [47, 20, 21, 30, 30]
    row_of = [0, 1, 1, 2, 2]
    meta = pa.build_ragged_wave([tables[r] for r in row_of], [p + 1 for p in flat_pos], 8,
                                pad_to_pow2=True)
    wave, _ = tl.verify_step_ragged(params, [5, 6, 7, 8, 8], flat_pos, row_of,
                                    meta.pages, meta.page_rows, meta.page_starts, caches,
                                    np.stack(tables), cfg, 8)
    return outs, [wave]


def test_defaults_leave_the_llama_block_bit_for_bit_as_before():
    before, wave = _llama_outputs()
    assert _digest(before) == _BEFORE["prefill_decode"]
    assert _digest(wave) == _BEFORE["ragged_wave"]


def test_launch_counts_keep_each_routed_layers_choice(model):
    cfg, params, _ = model
    toks = _tokens(24, seed=6)
    counts = tl.LaunchCounts(choices=True)
    caches = cfg.kv_spec(3).make_caches(device="cpu")
    tl.prefill(params, toks, caches, [0, 1, 2], cfg, counts=counts)
    rows = counts.choice_rows()
    assert rows.shape == (24, 4, cfg.moe_top_k) and rows.dtype == torch.int16
    # Layer 2 (the first routed one) sees the dense layers' output: its
    # choice is route()'s on that layer's normed input.
    x = tl.embed_prompt(params, toks, cfg)
    pos = torch.arange(24, dtype=torch.int32)[None]
    for layer in range(2):
        k, v = tl._kv_proj(params, layer, x, pos, cfg)
        x = tl._block(params, layer, x, k, v, pos, None, cfg)
    k, v = tl._kv_proj(params, 2, x, pos, cfg)
    h = tl._attend(params, 2, x, k, v, pos, None, cfg)
    m = tl._rms_norm(h, params["l2.ffn_norm"], cfg.norm_eps)[0]
    choice, _ = tl.route(m, params["l2.router"], params["l2.expert_bias"], cfg)
    assert torch.equal(rows[:, 0].long(), choice)


def test_routing_log_keys_choices_by_token_chain():
    log = engine.RoutingLog()
    assert log.lookup([1, 2, 3]) is None
    keys = engine.RoutingLog.chain([5, 6, 7])
    assert keys[1] == engine.RoutingLog.link(keys[0], 6)
    rows = np.arange(3 * 2 * 2, dtype=np.int16).reshape(3, 2, 2)
    seq = [5, 6, 7]
    log.put(seq, 1, rows[1:])
    got = log.lookup([5, 6, 7, 8])
    assert (got[0] == -1).all() and (got[3] == -1).all()
    assert (got[1:3] == rows[1:]).all()
    # Another chain with the same last tokens is another key.
    assert (log.lookup([9, 6, 7]) == -1).all()
    # A chain computed again keeps its last choice.
    log.put(seq, 2, rows[:1])
    assert (log.lookup([5, 6, 7])[2] == rows[0]).all()
    # A step's rows lie in a sequence that grows after the step: a draft the
    # sequence did not take, and the rows after it, are dropped.
    seq.append(8)
    log.put(seq, 3, rows[:3], ids=[8, 4, 4])
    seq.append(9)
    got = log.lookup([5, 6, 7, 8, 9, 4])
    assert (got[3] == rows[0]).all() and (got[4:] == -1).all()
