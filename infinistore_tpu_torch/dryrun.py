"""The multi-chip dryrun on the port: ``dryrun_multichip(n)``, the
counterpart of ``__graft_entry__.py: dryrun_multichip`` (the JAX package's
check that its parallel paths run together on an n-device mesh).

One process a rank over ``torch.distributed``: gloo with ``device="cpu"``,
NCCL on cards (one card a rank, so n cards). Each rank runs the dryrun's
legs in its order, each checked as the dryrun checks it:

1. the tensor-parallel train step (``models/tensor_parallel.py``) at the
   dryrun's mesh rule, ``(dp, tp, ep)`` = ``(2, n / 4, 2)`` when 8 divides
   n, ``(2, n / 2, 1)`` when 2 does, else ``(1, n, 1)``, on its config (a
   mixture of ``2 * ep`` experts at dim 64, bf16) and its ``[2 * dp, 8 *
   tp]`` tokens: the loss finite, every slice its shape after the step;
2. the GPipe pipeline (``models/pipeline.py``) at 2 stages (1 when n is 1),
   4 microbatches: the loss finite;
3. ring attention over all n ranks against ``dense_attention_reference``,
   within 1e-4;
4. Ulysses attention against the same reference, within 1e-4;
5. the sharded paged decode (``paged_decode_attention_sharded``; K5 on a
   card) against a numpy float64 oracle over the concatenated context,
   within 1e-4, with an empty shard when n > 1 (the dryrun's comment
   promises one, which its draws do not always give: here the last shard
   is emptied);
6. the ragged sharded decode (K7 on a card) on the dryrun's skewed 3-row
   wave against its oracle, within 1e-4;
7. on rank 0, ``KVConnector.handoff`` through an ``IciBlockTransfer`` over
   ``cuda.ici.mesh_from_devices`` of the n devices (``["cpu"] * n`` on the
   CPU), shard 0 to shard n - 1: exactly 1 launch (one K1, one copy, one K2
   on cards) and the blocks byte-equal.

The decode legs (5, 6) run the dryrun's own shapes (head_dim 16, 4 query
heads over 2 KV heads, 4-token blocks) and its numpy draws (seeds 17 and 19,
``decode_draws``); elsewhere a ``torch.Generator`` takes the dryrun's
integer seed where it draws with ``jax.random`` (0, 1, 3, 4, 5).

    python -m infinistore_tpu_torch.dryrun --n 8 --device cpu

runs it from the command line (the default device is the card, and the call
raises without one).
"""

import argparse
import asyncio
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from .cuda import _ext

HERE = os.path.dirname(os.path.abspath(__file__))
RANK_TIMEOUT_S = 600.0
TOL = 1e-4
# Decode legs: local blocks a shard, block tokens, KV heads, head_dim, query
# heads, table width (the dryrun's own).
NB_LOCAL, BT, KVH, D, H, N_LOC = 4, 4, 2, 16, 4, 3
RAGGED_ROWS = 3


def mesh_shape(n: int):
    """The dryrun's ``(dp, tp, ep)`` for n devices."""
    if n % 8 == 0:
        return 2, n // 4, 2
    if n % 2 == 0:
        return 2, n // 2, 1
    return 1, n, 1


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _all_max(value: float, dev) -> float:
    import torch.distributed as dist

    t = torch.tensor([value], dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def _tp_leg(rank, n, dev):
    from .models import expert_parallel, llama, tensor_parallel

    dp, tp, ep = mesh_shape(n)
    cfg = llama.LlamaConfig(vocab=64 * tp, dim=64, n_layers=2, n_heads=2 * tp, n_kv_heads=tp,
                            ffn_dim=32 * tp, n_experts=2 * ep, block_tokens=8,
                            dtype=torch.bfloat16)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2 * dp, 8 * tp), generator=torch.Generator().manual_seed(1))
    grid = expert_parallel.ep_grid(dp, tp, ep)
    step, shard = tensor_parallel.make_tp_train_step(grid, cfg, device=dev)
    local = shard(params)
    shapes = {k: tuple(v.shape) for k, v in local.items()}
    local, loss = step(local, tokens[grid.d * 2:(grid.d + 1) * 2])
    loss = float(loss)
    if not np.isfinite(loss):
        raise AssertionError(f"rank {rank}: dryrun loss not finite: {loss}")
    moved = [k for k, v in local.items() if tuple(v.shape) != shapes[k]]
    if moved:
        raise AssertionError(f"rank {rank}: slices changed shape in the step: {moved}")
    return {"mesh": [dp, tp, ep], "loss": loss}


def _pp_leg(rank, n, dev):
    import torch.distributed as dist

    from .models import llama, pipeline

    stages = 2 if n >= 2 else 1
    group = dist.new_group(list(range(stages)))  # every rank creates it
    if rank >= stages:
        return {"stages": stages}
    cfg = llama.LlamaConfig(vocab=128, dim=64, n_layers=4, n_heads=4, n_kv_heads=2, ffn_dim=128,
                            block_tokens=8, dtype=torch.bfloat16)
    stacked = pipeline.stack_stage_params(
        llama.init_params(cfg, torch.Generator().manual_seed(3), device="cpu"), cfg, stages)
    step, shard = pipeline.make_pp_train_step(group, cfg, stages, microbatches=4, device=dev)
    tokens = torch.randint(0, cfg.vocab, (8, 16), generator=torch.Generator().manual_seed(4))
    _, loss = step(shard(stacked), tokens)
    loss = float(loss)
    if not np.isfinite(loss):
        raise AssertionError(f"rank {rank}: pp dryrun loss not finite: {loss}")
    return {"stages": stages, "loss": loss}


def _sp_legs(rank, n, dev):
    """Ring and Ulysses attention on this rank's chunk against the dense
    reference over the whole sequence; the errors are the worst rank's."""
    from .models.ring_attention import dense_attention_reference, ring_attention
    from .models.ulysses import ulysses_attention

    g = torch.Generator().manual_seed(5)
    chunk = slice(rank * 8, (rank + 1) * 8)
    errs = {}
    for name, attention, heads in (("ring", ring_attention, 4),
                                   ("ulysses", ulysses_attention, 2 * n)):
        q, k, v = (torch.randn((1, 8 * n, heads, 16), generator=g).to(dev) for _ in range(3))
        got = attention(q[:, chunk], k[:, chunk], v[:, chunk], causal=True)
        want = dense_attention_reference(q, k, v, causal=True)[:, chunk]
        errs[name] = _all_max(float((got - want).abs().max()), dev)
        if not errs[name] < TOL:
            raise AssertionError(f"{name} attention diverged from dense: {errs[name]}")
    return errs


def _attend_f64(q, k, v):
    """The oracle: softmax attention of [H, D] q over [T, KVH, D] context in
    float64, the GQA heads repeated."""
    k = np.repeat(k, H // KVH, axis=1).astype(np.float64)
    v = np.repeat(v, H // KVH, axis=1).astype(np.float64)
    logits = np.einsum("hd,thd->ht", q.astype(np.float64), k) / np.sqrt(D)
    p = np.exp(logits - logits.max(axis=1, keepdims=True))
    p /= p.sum(axis=1, keepdims=True)
    return np.einsum("ht,thd->hd", p, v)


def decode_draws(n: int, empty_last_shard: bool = True) -> dict:
    """The decode legs' inputs, the dryrun's own numpy draws: the sharded
    leg's from seed 17 (caches ``spk``/``spv`` [n * NB_LOCAL, BT, KVH, D],
    ``spq`` [H, D], a table and a length a shard), the ragged leg's from
    seed 19 (``rgq`` [RAGGED_ROWS, H, D], a table a shard and row, the
    skewed lengths ``rg_lens`` [n, RAGGED_ROWS]). With ``empty_last_shard``
    (and n > 1) the last shard's length is 0, the empty shard the dryrun's
    comment promises; without it the lengths are the draws as they fall, as
    the dryrun runs them."""
    rng = np.random.default_rng(17)
    spk, spv = (rng.standard_normal((n * NB_LOCAL, BT, KVH, D)).astype(np.float32)
                for _ in range(2))
    spq = rng.standard_normal((H, D)).astype(np.float32)
    tables = np.stack([rng.permutation(NB_LOCAL)[:N_LOC] for _ in range(n)]).astype(np.int32)
    lens = rng.integers(0, N_LOC * BT + 1, size=n).astype(np.int32)
    lens[0] = max(lens[0], 1)  # at least one token globally
    if n > 1 and empty_last_shard:
        lens[-1] = 0

    rng = np.random.default_rng(19)
    rgq = rng.standard_normal((RAGGED_ROWS, H, D)).astype(np.float32)
    rg_tables = [[rng.permutation(NB_LOCAL)[:N_LOC] for _ in range(RAGGED_ROWS)]
                 for _ in range(n)]
    # The dryrun's 8:1-style skew: row 0 near-full everywhere, row 1 tiny,
    # row 2 absent from every shard but one.
    rg_lens = np.zeros((n, RAGGED_ROWS), np.int32)
    rg_lens[:, 0] = N_LOC * BT - 1
    rg_lens[:, 1] = rng.integers(0, 3, size=n)
    rg_lens[0, 1] = max(rg_lens[0, 1], 1)
    rg_lens[n // 2, 2] = 5
    return dict(spk=spk, spv=spv, spq=spq, tables=tables, lens=lens, rgq=rgq,
                rg_tables=rg_tables, rg_lens=rg_lens)


def decode_outputs(rank: int, n: int, dev, draws: dict):
    """This rank's run of the two decode legs on ``draws``: the sharded
    decode ([H, D]) and the ragged sharded decode ([RAGGED_ROWS, H, D]),
    both combined over the process group (so the same on every rank), as
    f32 numpy arrays. The rank holds shard ``rank`` of the caches."""
    from .cuda import paged_attention as pa

    shard = slice(rank * NB_LOCAL, (rank + 1) * NB_LOCAL)
    k_loc, v_loc = (torch.from_numpy(draws[x][shard].copy()).to(dev) for x in ("spk", "spv"))
    out = pa.paged_decode_attention_sharded(torch.from_numpy(draws["spq"]).to(dev), k_loc, v_loc,
                                            draws["tables"][rank], int(draws["lens"][rank]))
    pages, rows, starts, slens, width = pa.build_ragged_wave_sharded(draws["rg_tables"],
                                                                     draws["rg_lens"], BT)
    rg_out = pa.paged_decode_attention_ragged_sharded(
        torch.from_numpy(draws["rgq"]).to(dev), k_loc, v_loc, pages[rank], rows[rank],
        starts[rank], slens[rank], table_width=width)
    return out.cpu().numpy(), rg_out.cpu().numpy()


def _decode_legs(rank, n, dev):
    """The sharded and ragged sharded decode against their float64 oracles;
    the errors are the worst rank's."""
    draws = decode_draws(n)
    spk, spv, tables, lens = (draws[x] for x in ("spk", "spv", "tables", "lens"))
    out, rg_out = decode_outputs(rank, n, dev, draws)

    def context(cache, row_tables, row_lens):
        return np.concatenate([cache[p * NB_LOCAL + np.asarray(row_tables[p])]
                               .reshape(-1, KVH, D)[:row_lens[p]] for p in range(n)])

    want = _attend_f64(draws["spq"], context(spk, tables, lens), context(spv, tables, lens))
    sp_err = _all_max(float(np.abs(out.astype(np.float64) - want).max()), dev)
    if not sp_err < TOL:
        raise AssertionError(f"sharded decode attention diverged from dense: {sp_err}")

    rg_tables, rg_lens = draws["rg_tables"], draws["rg_lens"]
    rg_err = 0.0
    for r in range(RAGGED_ROWS):
        row_tables = [rg_tables[p][r] for p in range(n)]
        want = _attend_f64(draws["rgq"][r], context(spk, row_tables, rg_lens[:, r]),
                           context(spv, row_tables, rg_lens[:, r]))
        rg_err = max(rg_err, float(np.abs(rg_out[r].astype(np.float64) - want).max()))
    rg_err = _all_max(rg_err, dev)
    if not rg_err < TOL:
        raise AssertionError(f"ragged sharded decode diverged from dense: {rg_err}")
    return {"sp_decode": sp_err, "ragged_sp_decode": rg_err, "shard_lens": lens.tolist()}


def _ici_leg(n, dev):
    """Shard 0 hands two blocks of every layer to shard n - 1 through the
    connector's interconnect branch: one launch, the blocks byte-equal."""
    from .connector import KVConnector
    from .cuda.ici import IciBlockTransfer, mesh_from_devices
    from .cuda.paged import PagedKVCacheSpec

    devices = ["cpu"] * n if dev.type == "cpu" else [f"cuda:{i}" for i in range(n)]
    tr = IciBlockTransfer(mesh_from_devices(devices), "store", perm=[(0, n - 1)])
    spec = PagedKVCacheSpec(num_layers=2, num_blocks=8, block_tokens=8, num_kv_heads=2,
                            head_dim=8, dtype=torch.float32)
    kvc = KVConnector(None, spec, "dryrun", max_blocks=4, ici=tr, device=dev)
    try:
        full = [torch.arange(n * 8 * 8 * 2 * 8, dtype=torch.float32).reshape(n, 8, 8, 2, 8) + layer
                for layer in range(spec.num_layers)]
        caches = [([full[layer][i].to(tr.mesh[i]) for i in range(n)],
                   [torch.zeros((8, 8, 2, 8), device=tr.mesh[i]) for i in range(n)])
                  for layer in range(spec.num_layers)]
        src_ids = np.array([1, 3], dtype=np.int32)
        dst_ids = np.array([6, 2], dtype=np.int32)
        out, moved = asyncio.run(kvc.handoff(list(range(32)), caches, src_ids, dst_ids,
                                             src=0, dst=n - 1))
    finally:
        kvc.close()
    if moved != 2:
        raise AssertionError(f"the handoff moved {moved} blocks, not 2")
    if tr.launches != 1:
        raise AssertionError(f"fused handoff must be ONE launch for all layers, got {tr.launches}")
    for layer, (k_shards, _v) in enumerate(out):
        got = k_shards[n - 1].cpu()
        for s, d in zip(src_ids, dst_ids):
            if not torch.equal(got[d], full[layer][0][s]):
                raise AssertionError(f"ICI handoff mismatch (layer {layer}, block {s} -> {d})")
    return {"launches": tr.launches, "blocks": int(moved)}


def _run_rank(rank: int, n: int, init_file: str, device: str) -> dict:
    """One rank's legs; returns its metrics and each leg's kernel launches."""
    import torch.distributed as dist

    dev = _ext.resolve_device(device)
    backend = "gloo"
    if dev.type == "cuda":
        backend = "nccl"
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                            world_size=n, timeout=datetime.timedelta(seconds=300))
    legs = (("tensor_parallel", lambda: _tp_leg(rank, n, dev)),
            ("pipeline", lambda: _pp_leg(rank, n, dev)),
            ("ring_ulysses", lambda: _sp_legs(rank, n, dev)),
            ("sharded_decode", lambda: _decode_legs(rank, n, dev)),
            ("ici_handoff", lambda: _ici_leg(n, dev) if rank == 0 else {}))
    metrics, launches = {}, {}
    try:
        for name, leg in legs:
            _ext.reset_launches()
            metrics[name] = leg()
            _sync(dev)
            launches[name] = dict(_ext.LAUNCHES)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return {"rank": rank, "metrics": metrics, "launches": launches}


def _spawn(n: int, device: str, tmp: str):
    """The n rank processes, each this module with ``--rank``; returns their
    results, or raises with a failing rank's output (every rank is stopped
    before this returns)."""
    init_file = os.path.join(tmp, "filestore")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(HERE), os.environ.get("PYTHONPATH", "")]))
    if device == "cpu":
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
        env.setdefault("OMP_NUM_THREADS", "1")
    else:
        env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    procs, logs = [], []
    try:
        for rank in range(n):
            logs.append(open(os.path.join(tmp, f"rank{rank}.log"), "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "infinistore_tpu_torch.dryrun", "--rank", str(rank),
                 "--n", str(n), "--device", device, "--init-file", init_file],
                env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
        deadline = time.monotonic() + RANK_TIMEOUT_S
        while True:
            codes = [proc.poll() for proc in procs]
            if None not in codes or any(code not in (None, 0) for code in codes):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"dryrun ranks still running after {RANK_TIMEOUT_S} s")
            time.sleep(0.2)
    finally:
        stopped = [proc.poll() is None for proc in procs]
        for proc, stop in zip(procs, stopped):
            if stop:
                proc.kill()
            proc.wait()
    texts = []
    for log in logs:
        log.seek(0)
        texts.append(log.read())
        log.close()
    # A rank that failed on its own, before the ones stopped here.
    for rank in sorted(range(n), key=lambda r: stopped[r]):
        if procs[rank].returncode != 0:
            raise RuntimeError(f"dryrun rank {rank} exited {procs[rank].returncode}:\n"
                               f"{texts[rank][-4000:]}")
    return [json.loads(text.strip().splitlines()[-1]) for text in texts]


def dryrun_multichip(n: int, device="cuda") -> dict:
    """Run the dryrun's legs on n ranks (module docstring) and print its
    line. ``device`` "cuda" (the default) takes n cards and raises without
    them; "cpu" runs n gloo ranks. Returns the mesh, each leg's metrics (rank
    0's; the errors are the worst rank's), each leg's kernel launches summed
    over the ranks (K5 and K7 on the decode legs and K1 and K2 on the
    handoff, on cards; none on the CPU) and the printed line."""
    dev = _ext.resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"dryrun_multichip({n}) takes one card a rank; "
                           f"{torch.cuda.device_count()} present")
    with tempfile.TemporaryDirectory() as tmp:
        results = _spawn(n, dev.type, tmp)
    m = results[0]["metrics"]
    launches = {leg: {k: sum(r["launches"][leg][k] for r in results) for k in counts}
                for leg, counts in results[0]["launches"].items()}
    dp, tp, ep = m["tensor_parallel"]["mesh"]
    pp = m["pipeline"]
    line = (f"dryrun_multichip ok: mesh=(dp={dp},tp={tp},ep={ep}), "
            f"loss={m['tensor_parallel']['loss']:.4f}, "
            f"pp({pp['stages']}-stage) loss={pp['loss']:.4f}, "
            f"ring-attn({n}-way sp) err={m['ring_ulysses']['ring']:.1e}, "
            f"ulysses({n}-way all-to-all) err={m['ring_ulysses']['ulysses']:.1e}, "
            f"sp-decode({n}-shard paged) err={m['sharded_decode']['sp_decode']:.1e}, "
            f"ragged-sp-decode({RAGGED_ROWS}-row wave, {n}-shard) "
            f"err={m['sharded_decode']['ragged_sp_decode']:.1e}, "
            f"connector-ici ok ({m['ici_handoff']['launches']} launch, all layers)")
    print(line, flush=True)
    return {"n": n, "device": str(dev), "metrics": m, "launches": launches, "line": line}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="The multi-chip dryrun on the PyTorch port.")
    ap.add_argument("--n", type=int, default=1, help="ranks (one card a rank on cards)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init-file", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        print(json.dumps(_run_rank(args.rank, args.n, args.init_file, args.device)), flush=True)
        return 0
    dryrun_multichip(args.n, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
