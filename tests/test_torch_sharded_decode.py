"""The port's raw decode statistics (the plain versions of K5 and K7) and its
sharded decode over ``torch.distributed``, against the JAX package's
(infinistore_tpu/tpu/paged_attention.py), on the CPU.

Mirrors tests/test_paged_attention.py:346 (ragged stats normalise like the
XLA stats), :380 (a ragged wave sharded over the mesh, with a row that lives
on one shard), :466 (one request sharded, with an empty shard and ragged
per-shard lengths) and :516 (stats normalise like the XLA stats). The
sharded entry points run on 4 gloo ranks, each a process of its own holding
one shard of the cache, and are held within 1e-5 of the JAX entry points on
a 4-device sub-mesh of the 8-device CPU mesh and of a dense float64 oracle.
jax is imported inside the tests only: the rank processes import this
module to find their entry, and stay free of it."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from infinistore_tpu_torch.cuda import paged_attention as pa

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

WORLD = 4
NB_LOCAL, BT, KVH, D, H = 4, 4, 2, 16, 4  # blocks per shard, block tokens, heads
N_LOCAL = 3  # table entries per shard (single request)
R = 3  # rows of the ragged wave
RANK_TIMEOUT_S = 120


def _inputs():
    rng = np.random.default_rng(11)
    k = rng.standard_normal((WORLD * NB_LOCAL, BT, KVH, D)).astype(np.float32)
    v = rng.standard_normal((WORLD * NB_LOCAL, BT, KVH, D)).astype(np.float32)
    q = rng.standard_normal((H, D)).astype(np.float32)
    tables = np.stack([rng.permutation(NB_LOCAL)[:N_LOCAL] for _ in range(WORLD)]).astype(np.int32)
    lens = np.array([5, 0, 12, 3], np.int32)  # ragged, with an empty shard
    rq = rng.standard_normal((R, H, D)).astype(np.float32)
    rtables = np.stack([np.stack([rng.permutation(NB_LOCAL)[:3] for _ in range(R)])
                        for _ in range(WORLD)]).astype(np.int32)
    rlens = rng.integers(0, 3 * BT + 1, size=(WORLD, R)).astype(np.int32)
    rlens[0, 0] = max(rlens[0, 0], 1)
    rlens[:, 2] = 0
    rlens[2, 2] = 7  # row 2 lives on exactly one shard
    pages, rows, starts, slens, width = pa.build_ragged_wave_sharded(rtables, rlens, BT)
    return dict(k=k, v=v, q=q, tables=tables, lens=lens, rq=rq, rtables=rtables, rlens=rlens,
                pages=pages, rows=rows, starts=starts, slens=slens, width=np.int32(width))


def _rank_main(rank, init_file, data_path, out_path):
    """One gloo rank: its shard of the cache and its row of the metadata
    through both sharded entry points."""
    import torch.distributed as dist

    data = np.load(data_path)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=WORLD)
    try:
        shard = slice(rank * NB_LOCAL, (rank + 1) * NB_LOCAL)
        k = torch.from_numpy(data["k"][shard].copy())
        v = torch.from_numpy(data["v"][shard].copy())
        one = pa.paged_decode_attention_sharded(
            torch.from_numpy(data["q"]), k, v, data["tables"][rank], int(data["lens"][rank]))
        wave = pa.paged_decode_attention_ragged_sharded(
            torch.from_numpy(data["rq"]), k, v, data["pages"][rank], data["rows"][rank],
            data["starts"][rank], data["slens"][rank], table_width=int(data["width"]))
        np.savez(out_path, one=one.numpy(), wave=wave.numpy())
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the 4 gloo ranks once; returns (inputs, per-rank outputs)."""
    tmp = tmp_path_factory.mktemp("gloo")
    data = _inputs()
    data_path = str(tmp / "inputs.npz")
    np.savez(data_path, **data)
    init_file = str(tmp / "filestore")
    env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo",
               PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    procs = []
    for rank in range(WORLD):
        code = (f"import sys; sys.path.insert(0, {HERE!r}); import test_torch_sharded_decode as t; "
                f"t._rank_main({rank}, {init_file!r}, {data_path!r}, "
                f"{str(tmp / f'out{rank}.npz')!r})")
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
    outs = [np.load(str(tmp / f"out{rank}.npz")) for rank in range(WORLD)]
    return data, outs


def _dense(q, k_all, v_all):
    """Dense float64 attention of q [H, D] over [T, KVH, D] context."""
    groups = H // KVH
    k_rep = np.repeat(k_all, groups, axis=1).astype(np.float64)
    v_rep = np.repeat(v_all, groups, axis=1).astype(np.float64)
    logits = np.einsum("hd,thd->ht", q.astype(np.float64), k_rep) / np.sqrt(D)
    p = np.exp(logits - logits.max(axis=1, keepdims=True))
    p /= p.sum(axis=1, keepdims=True)
    return np.einsum("ht,thd->hd", p, v_rep)


def _mesh4():
    import jax
    from jax.sharding import Mesh

    devices = jax.devices()
    assert len(devices) == 8
    return Mesh(np.array(devices[:WORLD]), ("sp",))


def test_sharded_decode_matches_jax_on_four_ranks(ranks):
    import jax.numpy as jnp

    from infinistore_tpu.tpu.paged_attention import paged_decode_attention_sharded

    data, outs = ranks
    want = np.asarray(paged_decode_attention_sharded(
        jnp.asarray(data["q"]), jnp.asarray(data["k"]), jnp.asarray(data["v"]),
        data["tables"], data["lens"], mesh=_mesh4()))
    for rank, out in enumerate(outs):
        np.testing.assert_allclose(out["one"], want, rtol=1e-5, atol=1e-5, err_msg=f"rank {rank}")
        assert np.array_equal(out["one"], outs[0]["one"])  # replicated
    ks, vs = [], []
    for p in range(WORLD):
        rows = p * NB_LOCAL + data["tables"][p]
        ks.append(data["k"][rows].reshape(-1, KVH, D)[: data["lens"][p]])
        vs.append(data["v"][rows].reshape(-1, KVH, D)[: data["lens"][p]])
    oracle = _dense(data["q"], np.concatenate(ks), np.concatenate(vs))
    np.testing.assert_allclose(outs[0]["one"], oracle, rtol=1e-5, atol=1e-5)


def test_ragged_sharded_wave_matches_jax_on_four_ranks(ranks):
    import jax.numpy as jnp

    from infinistore_tpu.tpu.paged_attention import paged_decode_attention_ragged_sharded

    data, outs = ranks
    want = np.asarray(paged_decode_attention_ragged_sharded(
        jnp.asarray(data["rq"]), jnp.asarray(data["k"]), jnp.asarray(data["v"]),
        data["pages"], data["rows"], data["starts"], data["slens"], mesh=_mesh4(),
        table_width=int(data["width"])))
    for rank, out in enumerate(outs):
        np.testing.assert_allclose(out["wave"], want, rtol=1e-5, atol=1e-5,
                                   err_msg=f"rank {rank}")
    for r in range(R):
        ks, vs = [], []
        for p in range(WORLD):
            rows = p * NB_LOCAL + data["rtables"][p][r]
            ks.append(data["k"][rows].reshape(-1, KVH, D)[: data["rlens"][p][r]])
            vs.append(data["v"][rows].reshape(-1, KVH, D)[: data["rlens"][p][r]])
        oracle = _dense(data["rq"][r], np.concatenate(ks), np.concatenate(vs))
        np.testing.assert_allclose(outs[0]["wave"][r], oracle, rtol=1e-5, atol=1e-5,
                                   err_msg=f"row {r}")


def test_sharded_entry_points_raise_without_a_process_group():
    import torch.distributed as dist

    assert not (dist.is_available() and dist.is_initialized())
    k = torch.zeros((NB_LOCAL, BT, KVH, D))
    with pytest.raises(RuntimeError, match="process group"):
        pa.paged_decode_attention_sharded(torch.zeros((H, D)), k, k, [0, 1], 5)
    with pytest.raises(RuntimeError, match="process group"):
        pa.paged_decode_attention_ragged_sharded(
            torch.zeros((1, H, D)), k, k, [0], [0, 1], [0], [3], table_width=1)


def test_stats_plain_normalise_like_jax():
    """K5's plain version against the JAX stats kernel (interpret mode) and
    the XLA stats: the same raw statistics, and the same normalised rows
    (the empty row has acc 0, l 0 and m -1e30 in all three)."""
    import jax.numpy as jnp

    from infinistore_tpu.tpu.paged_attention import (
        _decode_attention_stats_xla,
        _paged_decode_attention_pallas_stats,
    )

    n, bt, kvh, d, h, ntbl, bsz = 16, 8, 2, 16, 4, 4, 3
    rng = np.random.default_rng(13)
    k = rng.standard_normal((n, bt, kvh, d)).astype(np.float32)
    v = rng.standard_normal((n, bt, kvh, d)).astype(np.float32)
    q = rng.standard_normal((bsz, h, d)).astype(np.float32)
    tables = np.stack([rng.permutation(n)[:ntbl] for _ in range(bsz)]).astype(np.int32)
    sls = np.array([1, ntbl * bt, 0], np.int32)  # incl. an empty row
    j_args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
              jnp.asarray(sls))
    kern = [np.asarray(x) for x in _paged_decode_attention_pallas_stats(*j_args, interpret=True)]
    xla = [np.asarray(x) for x in _decode_attention_stats_xla(*j_args)]
    got = [x.numpy() for x in pa.decode_attention_stats_plain(
        *(torch.from_numpy(x) for x in (q, k, v, tables, sls)))]
    for a, b in zip(got, xla):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    assert got[1][2].max() == -1e30 and got[2][2].max() == 0 and np.abs(got[0][2]).max() == 0
    for b in range(2):
        np.testing.assert_allclose(got[0][b] / got[2][b], kern[0][b] / kern[2][b],
                                   rtol=1e-5, atol=1e-5)
    assert kern[2][2].max() == 0 and np.abs(kern[0][2]).max() == 0


def test_ragged_stats_plain_normalise_like_jax():
    """K7's plain version against the JAX ragged stats kernel (interpret
    mode): the same normalised rows, the empty row zero in both."""
    import jax.numpy as jnp

    from infinistore_tpu.tpu.paged_attention import (
        _paged_decode_attention_pallas_ragged_stats,
        build_ragged_wave,
    )

    n, bt, kvh, d, h = 16, 8, 2, 16, 4
    rng = np.random.default_rng(53)
    k = rng.standard_normal((n, bt, kvh, d)).astype(np.float32)
    v = rng.standard_normal((n, bt, kvh, d)).astype(np.float32)
    q = rng.standard_normal((3, h, d)).astype(np.float32)
    tables = [rng.permutation(n)[:4] for _ in range(3)]
    lens = [1, 4 * bt, 0]
    m = build_ragged_wave(tables, lens, bt)
    meta = (m.pages, m.page_rows, m.page_starts, m.seq_lens)
    a1, _, l1 = (np.asarray(x) for x in _paged_decode_attention_pallas_ragged_stats(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), *(jnp.asarray(x) for x in meta),
        interpret=True))
    a2, m2, l2 = (x.numpy() for x in pa._decode_attention_stats_ragged(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), *meta, table_width=4))
    for b in range(2):
        np.testing.assert_allclose(a2[b] / l2[b], a1[b] / l1[b], rtol=1e-5, atol=1e-5)
    assert l1[2].max() == 0 and l2[2].max() == 0 and np.abs(a2[2]).max() == 0
    assert m2[2].max() == -1e30


@pytest.mark.parametrize("seed", [59, 60, 61])
def test_build_ragged_wave_sharded_matches_jax(seed):
    from infinistore_tpu.tpu.paged_attention import build_ragged_wave_sharded as jax_build

    rng = np.random.default_rng(seed)
    p, r = 4, 5
    tables = [[rng.permutation(8)[:4] for _ in range(r)] for _ in range(p)]
    lens = rng.integers(0, 4 * BT + 1, size=(p, r)).astype(np.int32)
    lens[:, 0] = 0  # a row with no tokens anywhere
    lens[1, 1] = 4 * BT
    got = pa.build_ragged_wave_sharded(tables, lens, BT)
    want = jax_build(tables, lens, BT)
    assert len(got) == len(want) == 5
    for a, b in zip(got[:4], want[:4]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got[4] == want[4]
    with pytest.raises(ValueError):
        pa.build_ragged_wave_sharded([], lens, BT)


def test_combine_over_one_shard_is_bitwise_and_over_slices_close():
    """combine_stats over one shard is the plain batched decode bitwise;
    over 4 disjoint slices of each row's pages, stacked in one process, it
    matches within 1e-5 (the check chip_smoke.py runs on the card)."""
    rng = np.random.default_rng(17)
    n, bt, kvh, d, h, width, bsz = 40, 4, 2, 16, 8, 8, 3
    k = torch.from_numpy(rng.standard_normal((n, bt, kvh, d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((n, bt, kvh, d)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((bsz, h, d)).astype(np.float32))
    tables = torch.from_numpy(
        np.stack([rng.permutation(n)[:width] for _ in range(bsz)]).astype(np.int32))
    lens = torch.tensor([width * bt, 13, 0], dtype=torch.int32)
    want = pa.paged_decode_attention_plain_batched(q, k, v, tables, lens)
    acc, m, l = pa.decode_attention_stats_plain(q, k, v, tables, lens)
    ident = lambda t: t  # noqa: E731
    assert torch.equal(pa.combine_stats(acc, m, l, q.dtype, ident, ident), want)
    parts = width // 4
    stats = [pa.decode_attention_stats_plain(
        q, k, v, tables[:, s * parts:(s + 1) * parts].contiguous(),
        torch.clamp(lens - s * parts * bt, min=0, max=parts * bt).to(torch.int32))
        for s in range(4)]
    acc4, m4, l4 = (torch.stack(x) for x in zip(*stats))
    got = pa.combine_stats(acc4, m4, l4, q.dtype, lambda t: t.amax(0), lambda t: t.sum(0))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.all(got[2] == 0)


def test_chip_smoke_sharded_decode_rehearsal_on_cpu():
    """``chip_smoke.py``'s sharded decode phase (both entry points on a
    process group of one rank, bitwise the unsharded decode) on the CPU with
    gloo at a tiny geometry."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    geometry = dict(vocab=256, dim=256, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=256,
                    block_tokens=16)
    launches = chip_smoke.sharded_decode_phase(torch, device="cpu", backend="gloo",
                                               geometry=geometry, tokens=512)
    assert set(launches.values()) == {0}  # the CPU runs the plain versions
    import torch.distributed as dist

    assert not dist.is_initialized()
