"""The port at the head_dims the JAX package's kernels take beyond 16-128:
8 (the JAX package's model tests' config, ``LlamaConfig(dim=32, n_heads=4,
n_kv_heads=2)``), 80 (Phi-2), 96 (Phi-3-mini) and 256 (Gemma-2B).

On the same numpy inputs, the port's plain versions of K3, K5, K6, K7, K8
and K4 (what the CPU runs, and what the card's kernels are held against)
against the JAX package's Pallas kernels in interpret mode, as
tests/test_paged_attention.py runs them: 1e-5 in f32 and 2e-2 in bf16
(tests/test_paged_attention.py:51; K5 and K7 compared normalised). The
port's model against the JAX package's at those head_dims (prefill, then
``decode_step_batched``; weights from the JAX ``init_params`` carried
through numpy; 2e-4, tests/test_flash_prefill.py:122). A prefix saved by
either package at head_dim 96 and 256 loads byte for byte in the other.
And ``chip_smoke.py``'s round trip at those widths (``_run_round_trip``),
rehearsed on the CPU at a tiny width with a block of several store units.
The kernels themselves run on the card only (tests/test_torch_cuda_kernels.py).
"""

import asyncio
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import infinistore_tpu as its
from infinistore_tpu.connector import KVConnector as JaxKVConnector
from infinistore_tpu.models import llama as jl
from infinistore_tpu.tpu import flash_prefill as jfp
from infinistore_tpu.tpu import kv_quant as jkq
from infinistore_tpu.tpu import paged_attention as jpa
from infinistore_tpu.tpu.paged import PagedKVCacheSpec as JaxSpec
from infinistore_tpu_torch import config as tconfig
from infinistore_tpu_torch import lib as tlib
from infinistore_tpu_torch.connector import KVConnector
from infinistore_tpu_torch.cuda import _ext
from infinistore_tpu_torch.cuda import flash_prefill as fp
from infinistore_tpu_torch.cuda import kv_quant as tkq
from infinistore_tpu_torch.cuda import paged_attention as pa
from infinistore_tpu_torch.cuda.paged import PagedKVCacheSpec
from infinistore_tpu_torch.models import llama as tl

HEAD_DIMS = (8, 80, 96, 256)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
MODEL_TOL = 2e-4
# Decode shapes a head_dim: (cache blocks, block tokens, KV heads, query heads,
# table width). d8: the model tests' heads (4 over 2, block 8); d80, d96:
# Phi-2's and Phi-3's multi-head attention (one query head a KV head); d256:
# Gemma-2B's one KV head under 4 query heads.
DECODE = {8: (8, 8, 2, 4, 4), 80: (8, 8, 2, 2, 4), 96: (8, 8, 2, 2, 4), 256: (8, 8, 1, 4, 4)}
# Prefill shapes a head_dim: (query heads, KV heads).
PREFILL = {8: (4, 2), 80: (2, 2), 96: (2, 2), 256: (4, 1)}
# The model at each head_dim: the JAX model tests' config at 8, and 2-layer,
# 2-head configs at 80, 96 and 256 (one KV head at 256, as Gemma-2B).
MODELS = {
    8: dict(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=64, block_tokens=8),
    80: dict(vocab=64, dim=160, n_layers=2, n_heads=2, n_kv_heads=2, ffn_dim=128,
             block_tokens=8),
    96: dict(vocab=64, dim=192, n_layers=2, n_heads=2, n_kv_heads=2, ffn_dim=128,
             block_tokens=8),
    256: dict(vocab=64, dim=512, n_layers=2, n_heads=2, n_kv_heads=1, ffn_dim=128,
              block_tokens=8),
}


def _t(x, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t if dtype is None else t.to(dtype)


def _decode_inputs(d, seed):
    """q [rows, H, D], K/V caches, tables and lengths (zero, one token, a
    partial block, a block boundary, the full table) at ``DECODE[d]``."""
    n, bt, kvh, h, width = DECODE[d]
    rng = np.random.default_rng(seed + d)
    lens = np.asarray([0, 1, bt + 3, 2 * bt, width * bt], np.int32)
    q = rng.standard_normal((len(lens), h, d)).astype(np.float32)
    k = rng.standard_normal((n, bt, kvh, d)).astype(np.float32)
    v = rng.standard_normal((n, bt, kvh, d)).astype(np.float32)
    tables = np.stack([rng.permutation(n)[:width] for _ in lens]).astype(np.int32)
    return q, k, v, tables, lens


def _close(got, want, tol, **kw):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol, **kw)


def test_the_kernels_take_these_head_dims():
    assert set(HEAD_DIMS) <= set(_ext.HEAD_DIMS)
    assert _ext.HEAD_DIMS == (8, 16, 32, 64, 80, 96, 128, 256)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_k3_matches_pallas_interpret(d, dtype):
    q, k, v, tables, lens = _decode_inputs(d, 1)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = pa.paged_decode_attention_batched(_t(q, tdt), _t(k, tdt), _t(v, tdt), _t(tables),
                                            _t(lens))
    assert got.dtype == tdt and torch.all(got[0] == 0)
    want = jpa._paged_decode_attention_pallas_batched(
        *(jnp.asarray(x).astype(jdt) for x in (q, k, v)), jnp.asarray(tables),
        jnp.asarray(lens), interpret=True)
    _close(got.float().numpy(), want.astype(jnp.float32), TOL[dtype])


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_k5_stats_match_pallas_interpret(d):
    """K5's raw statistics, normalised, against the JAX stats kernel; the
    zero-length row is acc 0 and l 0 in both."""
    q, k, v, tables, lens = _decode_inputs(d, 2)
    acc, m, l = (x.numpy() for x in pa._decode_attention_stats(
        _t(q), _t(k), _t(v), _t(tables), _t(lens)))
    ja, _, jlsum = (np.asarray(x) for x in jpa._paged_decode_attention_pallas_stats(
        *(jnp.asarray(x) for x in (q, k, v, tables, lens)), interpret=True))
    assert np.abs(acc[0]).max() == 0 and l[0].max() == 0 and jlsum[0].max() == 0
    assert m[0].max() == -1e30
    for b in range(1, len(lens)):
        _close(acc[b] / l[b], ja[b] / jlsum[b], TOL["float32"], err_msg=f"row {b}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_k6_matches_pallas_ragged_interpret(d, dtype):
    """K6 over a wave's flat page list (pow2-padded), rows of 0 to a full
    table; each row is K3's over its own table."""
    q, k, v, tables, lens = _decode_inputs(d, 3)
    bt, width = DECODE[d][1], DECODE[d][4]
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    m = pa.build_ragged_wave(list(tables), lens, bt, pad_to_pow2=True)
    got = pa.paged_decode_attention_ragged(_t(q, tdt), _t(k, tdt), _t(v, tdt), m.pages,
                                           m.page_rows, m.page_starts, m.seq_lens,
                                           table_width=width)
    k3 = pa.paged_decode_attention_batched(_t(q, tdt), _t(k, tdt), _t(v, tdt), _t(tables),
                                           _t(lens))
    want = jpa._paged_decode_attention_pallas_ragged(
        *(jnp.asarray(x).astype(jdt) for x in (q, k, v)),
        *(jnp.asarray(x) for x in (m.pages, m.page_rows, m.page_starts, m.seq_lens)),
        interpret=True)
    _close(got.float().numpy(), want.astype(jnp.float32), TOL[dtype])
    _close(got.float().numpy(), k3.float().numpy(), TOL[dtype])


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_k7_ragged_stats_match_pallas_interpret(d):
    q, k, v, tables, lens = _decode_inputs(d, 4)
    bt, width = DECODE[d][1], DECODE[d][4]
    m = pa.build_ragged_wave(list(tables), lens, bt)
    meta = (m.pages, m.page_rows, m.page_starts, m.seq_lens)
    acc, mm, l = (x.numpy() for x in pa._decode_attention_stats_ragged(
        _t(q), _t(k), _t(v), *meta, table_width=width))
    ja, _, jlsum = (np.asarray(x) for x in jpa._paged_decode_attention_pallas_ragged_stats(
        *(jnp.asarray(x) for x in (q, k, v)), *(jnp.asarray(x) for x in meta), interpret=True))
    assert np.abs(acc[0]).max() == 0 and l[0].max() == 0 and jlsum[0].max() == 0
    assert mm[0].max() == -1e30
    for b in range(1, len(lens)):
        _close(acc[b] / l[b], ja[b] / jlsum[b], TOL["float32"], err_msg=f"row {b}")


@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_k8_matches_pallas_interpret(d, qdtype):
    """K8 over an int8 cache quantised by each package (bitwise the same
    bytes and scales), against the JAX kernel; the zero-length row zeros."""
    q, k, v, tables, lens = _decode_inputs(d, 5)
    jk, jv = jkq.quantize_kv(jnp.asarray(k)), jkq.quantize_kv(jnp.asarray(v))
    tk, tv = tkq.quantize_kv(_t(k)), tkq.quantize_kv(_t(v))
    for j, t in zip((*jk, *jv), (*tk, *tv)):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    tq = _t(q, getattr(torch, qdtype))
    got = tkq.paged_decode_attention_quantized(tq, *tk, *tv, _t(tables), _t(lens))
    assert got.dtype == tq.dtype and torch.all(got[0] == 0)
    want = jkq._quant_decode_pallas(jnp.asarray(q).astype(qdtype), *jk, *jv,
                                    jnp.asarray(tables), jnp.asarray(lens), interpret=True)
    _close(got.float().numpy(), want.astype(jnp.float32), TOL[qdtype])


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_k4_matches_pallas_interpret(d, dtype, causal):
    """K4 on a 24-token prompt, causal and full (the JAX kernel's blocks 16
    and 8, so the diagonal and a ragged key block both occur)."""
    h, kvh = PREFILL[d]
    rng = np.random.default_rng(6 + d)
    q = rng.standard_normal((1, 24, h, d)).astype(np.float32)
    k = rng.standard_normal((1, 24, kvh, d)).astype(np.float32)
    v = rng.standard_normal((1, 24, kvh, d)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = fp.flash_prefill_attention(_t(q, tdt), _t(k, tdt), _t(v, tdt), causal=causal)
    assert got.dtype == tdt
    want = jfp._flash_prefill_pallas(*(jnp.asarray(x).astype(jdt) for x in (q, k, v)),
                                     causal=causal, block_q=16, block_k=8, interpret=True)
    _close(got.float().numpy(), want.astype(jnp.float32), TOL[dtype])


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_model_prefill_and_decode_match_jax(d):
    """Prefill of a 16-token prompt and a 24-token one into a shared cache,
    then three batched greedy decode steps: logits and caches within 2e-4
    of the JAX package's, at each head_dim."""
    shape = MODELS[d]
    jcfg = jl.LlamaConfig(dtype=jnp.float32, **shape)
    tcfg = tl.LlamaConfig(dtype=torch.float32, **shape)
    assert jcfg.head_dim == tcfg.head_dim == d
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(d))
    tparams = tl.params_from_numpy({n: np.asarray(x) for n, x in jparams.items()}, tcfg,
                                   device="cpu")
    rng = np.random.default_rng(d)
    prompts = [rng.integers(0, shape["vocab"], n).astype(np.int32) for n in (16, 24)]
    tables = np.array([[0, 1, 2, 3], [7, 5, 6, 4]], np.int32)
    jc = jcfg.kv_spec(8).make_caches()
    tc = tcfg.kv_spec(8).make_caches(device="cpu")
    first = []
    for p, table in zip(prompts, tables):
        nb = len(p) // shape["block_tokens"]
        jlog, jc = jl.prefill(jparams, jnp.asarray(p), jc, jnp.asarray(table[:nb]), jcfg)
        tlog, tc = tl.prefill(tparams, p, tc, table[:nb], tcfg)
        _close(tlog.numpy(), jlog, MODEL_TOL, err_msg=f"prefill of {len(p)} tokens")
        first.append(int(jnp.argmax(jlog)))
    tokens = np.asarray(first, np.int32)
    pos = np.asarray([len(p) for p in prompts], np.int32)
    for step in range(3):
        jlog, jc = jl.decode_step_batched(jparams, jnp.asarray(tokens), jnp.asarray(pos), jc,
                                          jnp.asarray(tables), jcfg, 4)
        tlog, tc = tl.decode_step_batched(tparams, tokens, pos, tc, tables, tcfg, 4)
        _close(tlog.numpy(), jlog, MODEL_TOL, err_msg=f"decode step {step}")
        tokens = np.asarray(jnp.argmax(jlog, axis=-1), np.int32)
        pos = pos + 1
    for layer in range(shape["n_layers"]):
        for kind in (0, 1):
            _close(tc[layer][kind].numpy(), jc[layer][kind], MODEL_TOL)


# --- a prefix across the two packages at head_dim 96 and 256 ----------------

# (layers, cache blocks, block tokens, KV heads) a head_dim; bf16 blocks of
# 3 KiB (96: 8 tokens x 2 KV heads) and 4 KiB (256: 8 tokens x 1 KV head).
INTEROP = {96: (2, 16, 8, 2), 256: (2, 16, 8, 1)}


@pytest.fixture()
def conns():
    """One port server, one client of each package on it."""
    srv = tlib.start_local_server(prealloc_bytes=64 << 20, block_bytes=16 << 10)
    tconn = tlib.InfinityConnection(tconfig.ClientConfig(
        host_addr="127.0.0.1", service_port=srv.port, log_level="error"))
    jconn = its.InfinityConnection(its.ClientConfig(
        host_addr="127.0.0.1", service_port=srv.port, log_level="error"))
    tconn.connect()
    jconn.connect()
    yield jconn, tconn
    jconn.close()
    tconn.close()
    srv.stop()


def _block_bytes(cache, ids) -> bytes:
    if isinstance(cache, torch.Tensor):
        return cache[list(ids)].view(torch.uint8).numpy().tobytes()
    return np.asarray(cache)[list(ids)].tobytes()


@pytest.mark.parametrize("saver", ["jax", "port"])
@pytest.mark.parametrize("d", sorted(INTEROP))
def test_prefix_saved_by_one_package_loads_in_the_other(conns, d, saver):
    jconn, tconn = conns
    layers, blocks, bt, kvh = INTEROP[d]
    jspec = JaxSpec(layers, blocks, bt, kvh, d, jnp.bfloat16)
    tspec = PagedKVCacheSpec(layers, blocks, bt, kvh, d, torch.bfloat16)
    assert jspec.block_nbytes == tspec.block_nbytes == bt * kvh * d * 2
    rng = np.random.default_rng(d)
    jax_caches, torch_caches = [], []
    for _ in range(layers):
        base = [rng.standard_normal(tspec.cache_shape).astype(np.float32) for _ in range(2)]
        jax_caches.append(tuple(jnp.asarray(x).astype(jnp.bfloat16) for x in base))
        torch_caches.append(tuple(torch.from_numpy(x).to(torch.bfloat16) for x in base))
    tokens = list(range(1000 + d, 1000 + d + 3 * bt))  # 3 blocks
    src, dst = np.array([9, 2, 14], np.int32), np.array([0, 11, 5], np.int32)
    model = f"head-dim-{d}-{saver}"
    if saver == "jax":
        put = JaxKVConnector(jconn, jspec, model, 4)
        assert asyncio.run(put.save(tokens, jax_caches, src)) == 3 * 2 * layers
        get = KVConnector(tconn, tspec, model, 4, device="cpu")
        saved, fresh = jax_caches, tspec.make_caches("cpu")
    else:
        put = KVConnector(tconn, tspec, model, 4, device="cpu")
        assert asyncio.run(put.save(tokens, torch_caches, src)) == 3 * 2 * layers
        get = JaxKVConnector(jconn, jspec, model, 4)
        saved, fresh = torch_caches, jspec.make_caches()
    assert get.lookup(tokens) == 3
    loaded, n = asyncio.run(get.load(tokens, fresh, dst))
    assert n == 3
    for layer in range(layers):
        for kind in (0, 1):
            assert _block_bytes(loaded[layer][kind], dst) == _block_bytes(
                saved[layer][kind], src), (layer, kind)


# --- chip_smoke.py's round trips at these widths, rehearsed on the CPU -------


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_round_trips_name_the_new_head_dims():
    """The round trips run head_dim 96 at full depth and 80 and 256 at 2
    layers; ``SHAPES_TAKEN`` holds every head_dim (K4 in both dtypes);
    each round-trip path must launch K1-K4, K4 on the tensor cores and K1/K2
    on the bulk ring."""
    cs = _chip_smoke()
    dims = {path: g["dim"] // g["n_heads"] for path, g, *_ in cs.ROUND_TRIPS}
    assert dims == {"prefill_store_decode_phi3": 96, "prefill_store_decode_phi2": 80,
                    "prefill_store_decode_gemma2b": 256}
    assert cs.PHI3_MINI["n_layers"] == 32 and cs.PHI3_MINI["n_kv_heads"] == 32
    for path, geometry, _, store_bytes, unit in cs.ROUND_TRIPS:
        block = geometry["block_tokens"] * geometry["n_kv_heads"] * dims[path] * 2
        kv = cs.PROMPTS * cs.PROMPT_TOKENS // geometry["block_tokens"] * 2 * \
            geometry["n_layers"] * -(-block // unit) * unit
        assert kv <= store_bytes * 3 // 4, path
        assert set(cs.PATH_KERNELS[path]) == {"gather_blocks", "scatter_blocks",
                                              "paged_decode_attention", "flash_prefill"}
        assert path in cs.BF16_K4_PATHS and path in cs.BULK_COPY_PATHS
    taken = {label: row[3] for label, row in cs.SHAPES_TAKEN.items()}
    for d in HEAD_DIMS:
        assert d in taken.values()
    # K4 in both dtypes at every shape, so every head_dim the kernels take
    # has an f32 and a bf16 row (head_dim 64: d64, 32 heads over 8; 128:
    # mha128 and g7); Gemma-2B's shape in bf16 also at PROMPTS prompts.
    assert set(cs.SHAPES_TAKEN_K4) == set(cs.SHAPES_TAKEN)
    for label, dtypes in cs.SHAPES_TAKEN_K4.items():
        assert set(dtypes) == {"float32", "bfloat16"}
    assert set(taken.values()) == set(_ext.HEAD_DIMS)
    assert cs.SHAPES_TAKEN["d64"][1:4] == (32, 8, 64)
    assert {taken["mha128"], taken["g7"]} == {128}
    assert cs.K4_BATCHED == ("d256", "bfloat16") and cs.PROMPTS == 4


def test_chip_smoke_round_trip_rehearsal_on_cpu():
    """``_run_round_trip`` at head_dim 96 on the CPU at a tiny width, with a
    6 KiB block in 2 KiB store units: 3 units a key, loaded blocks
    byte-equal and decode logits bitwise equal across the engines, no
    kernel launched."""
    cs = _chip_smoke()
    geometry = dict(vocab=128, dim=192, n_layers=2, n_heads=2, n_kv_heads=2, ffn_dim=128,
                    block_tokens=16, rope_theta=10000.0)
    metrics, launches = cs._run_round_trip(torch, geometry, "phi-3-mini-rehearsal", 64 << 20,
                                           2 << 10, device="cpu", prompt_tokens=64)
    assert metrics["geometry"]["head_dim"] == 96 and metrics["geometry"]["units_per_key"] == 3
    assert metrics["store_bytes_per_key"] == 6 << 10
    assert metrics["kv_bytes_moved"] == cs.PROMPTS * 4 * (6 << 10) * 2 * 2
    assert set(launches.values()) == {0}
