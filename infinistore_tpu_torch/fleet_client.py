"""Scriptable cluster-client worker process (port of
``infinistore_tpu/fleet_client.py``; the fleet harness's client half —
``tools/fleet.py``'s helpers spawn, kill -9, and restart these).

One process = one ``ClusterKVConnector`` with a **durable journal**
(docs/membership.md, durability section), its own manage plane (serving
``/membership``, ``POST /gossip``, ``GET /bootstrap``), and a
``GossipAgent`` exchanging epochs with peer client processes. The
crash-recovery bench leg and tests drive it four ways:

- **seed-and-serve**: connect ``--stores``, save ``--roots`` deterministic
  roots (a seeded numpy generator, cast to bf16 by torch — any process of
  this package with the same ``--seed`` regenerates the exact bytes, on the
  CPU and on the card alike; they are not the JAX package's fleet client's
  bytes, so ``--verify`` holds within one package's fleet and a mixed fleet
  is not claimed to verify), then serve the manage plane + gossip until
  SIGTERM. On restart WITH THE SAME ARGV the journal replay recovers the
  catalog, so the save phase is skipped (idempotent startup) and an
  interrupted reshard RESUMES from the journaled debt.
- **crash-after-moved** (``--crash-after-moved K``): hard-kill this
  process (``faults.crash_process``, SIGKILL to self) the moment the
  resharder's K-th migrated root lands in the catalog — a deterministic
  ``kill -9`` mid-reshard. Disarmed automatically when the journal replay
  shows a previous incarnation already crashed (the restarted process
  must finish the job, not crash again).
- **bootstrap** (``--bootstrap``): no ``--stores`` at all — a COLD client
  reconstructs the view + catalog from any live peer's ``GET /bootstrap``
  (the seed list is ``--peers``).
- **verify** (``--verify``): sweep-read every seeded root (K2 scatters it
  into fresh caches on ``--device``), byte-compare against the regenerated
  contents (K1 gathers both sides), print one JSON report line to stdout
  and exit (0 reads wrong = the crash-safety acceptance bar).

``--device`` (default ``cuda``; raises without a card): where the caches
live; ``--device cpu`` runs the plain PyTorch versions.

Run: python -m infinistore_tpu_torch.fleet_client --manage-port 28090 \
        --stores 127.0.0.1:22345,127.0.0.1:22346 --journal /tmp/a.journal \
        --peers 127.0.0.1:28091 --roots 24
"""

import argparse
import asyncio
import json
import signal
import sys
import urllib.request

import numpy as np
import torch

from . import faults, telemetry
from .cluster import CircuitBreaker, ClusterKVConnector
from .config import ServerConfig
from .cuda import _ext
from .cuda.paged import PagedKVCacheSpec, gather_blocks
from .lib import Logger
from .server import ManageServer

MODEL_ID = "fleet"
SRC_BLOCKS = (3, 9)
DST_BLOCKS = (6, 2)


def _spec():
    return PagedKVCacheSpec(
        num_layers=2, num_blocks=16, block_tokens=8, num_kv_heads=2,
        head_dim=32, dtype=torch.bfloat16,
    )


def _prompts(spec, seed: int, n: int):
    rng = np.random.default_rng(seed)
    return [
        rng.integers(0, 1000, size=2 * spec.block_tokens).tolist()
        for _ in range(n)
    ]


def _mk_caches(spec, seed: int, device):
    """Deterministic per-root KV bytes: drawn on the CPU from numpy
    generators seeded ``seed * 100 + layer`` (``+ 50`` for V), cast to bf16
    by torch, then moved to ``device`` — identical bytes in every process of
    this package and on either device, so a verify client proves
    correctness without any side channel."""
    out = []
    for layer in range(spec.num_layers):
        pair = []
        for offset in (0, 50):
            rng = np.random.default_rng(seed * 100 + offset + layer)
            base = rng.standard_normal(spec.cache_shape, dtype=np.float32)
            pair.append(torch.from_numpy(base).to(spec.dtype).to(device))
        out.append(tuple(pair))
    return out


def _fast_breaker(i: int) -> CircuitBreaker:
    return CircuitBreaker(
        fail_threshold=2, probe_backoff_s=0.1, max_backoff_s=0.8, seed=i
    )


def _parse_hostports(arg: str):
    out = []
    for item in (arg or "").split(","):
        item = item.strip()
        if not item:
            continue
        host, _, port = item.rpartition(":")
        out.append((host or "127.0.0.1", int(port)))
    return out


def _connect_stores(its, stores):
    conns, ids = [], []
    for host, port in stores:
        conn = its.InfinityConnection(its.ClientConfig(
            host_addr=host, service_port=port, log_level="error",
            auto_reconnect=True, connect_timeout_ms=1000, op_timeout_ms=5000,
        ))
        conn.connect()
        conns.append(conn)
        ids.append(f"{host}:{port}")
    return conns, ids


def _fetch_bootstrap(peers, timeout_s: float = 5.0):
    """The cold-client seed walk: first live peer's /bootstrap wins."""
    last = None
    for host, port in peers:
        try:
            with urllib.request.urlopen(
                f"http://{host}:{port}/bootstrap", timeout=timeout_s
            ) as resp:
                doc = json.loads(resp.read(32 << 20))
            if doc.get("enabled") and doc.get("members"):
                return doc
            last = f"peer {host}:{port}: {doc.get('reason') or 'no view'}"
        except (OSError, ValueError) as e:
            last = f"peer {host}:{port}: {e!r}"
    raise RuntimeError(f"bootstrap failed from every peer ({last})")


def _build_cluster(args, its, spec, device):
    kw = dict(
        degrade=True, replicas=args.replicas,
        breaker_factory=_fast_breaker,
        journal_path=args.journal or None,
        device=device,
    )
    if args.bootstrap:
        payload = _fetch_bootstrap(_parse_hostports(args.peers))
        return ClusterKVConnector.bootstrap(
            payload, spec, MODEL_ID, max_blocks=8, **kw
        )
    stores = _parse_hostports(args.stores)
    if not stores:
        raise SystemExit("need --stores or --bootstrap")
    conns, ids = _connect_stores(its, stores)
    cluster = ClusterKVConnector(
        conns, spec, MODEL_ID, max_blocks=8, member_ids=ids, **kw
    )
    # The constructor copies conns into members; on journal replay the
    # arrays may have been rebuilt around them — either way the process
    # owns these dials and closes them on exit via _owned_dials.
    cluster._owned_dials.extend(conns)
    return cluster


def _arm_crash_after_moved(cluster, k: int):
    """Deterministic mid-reshard kill -9: SIGKILL the process the moment
    the K-th migrated root's holder record lands (and is journaled) —
    the crash the recovery gate restarts from."""
    orig = cluster.catalog_add_holder
    state = {"n": 0}

    def wrapper(root, member_id, blocks=0):
        ok = orig(root, member_id, blocks)
        if ok:
            state["n"] += 1
            if state["n"] >= k:
                faults.crash_process()  # no line below this runs
        return ok

    cluster.catalog_add_holder = wrapper


def _verify(args, cluster, spec, prompts, device):
    src = torch.tensor(SRC_BLOCKS, dtype=torch.int32, device=device)
    dst_ids = np.array(DST_BLOCKS, np.int32)
    dst = torch.from_numpy(dst_ids).to(device)
    reads = misses = wrong = 0
    for i, p in enumerate(prompts):
        reads += 1
        loaded, n = asyncio.run(cluster.load(p, spec.make_caches(device), dst_ids))
        if n == 0:
            misses += 1
            continue
        expect = _mk_caches(spec, i, device)
        bad = any(
            not torch.equal(
                gather_blocks(loaded[layer][kind], dst),
                gather_blocks(expect[layer][kind], src),
            )
            for layer in range(spec.num_layers)
            for kind in (0, 1)
        )
        wrong += bad
    status = cluster.membership_status()
    view = cluster.membership.view()
    return {
        "reads": reads, "misses": misses, "wrong": wrong,
        "epoch": view.epoch,
        "members": len(view.readable_ids()),
        "settled": int(status["membership_settled"]),
        "catalog_roots": int(status["reshard_catalog_roots"]),
        "bootstrap": int(bool(args.bootstrap)),
    }


async def _serve(args, cluster, spec, prompts, need_save: int, device):
    manage = ManageServer(
        ServerConfig(host="127.0.0.1", manage_port=args.manage_port),
        cluster=cluster,
        gossip=None,
    )
    agent = telemetry.GossipAgent(
        cluster,
        peers=[
            (f"{h}:{p}", h, p) for h, p in _parse_hostports(args.peers)
        ],
        interval_s=args.gossip_interval,
        fail_threshold=3, backoff_s=2.0,
    )
    manage.gossip = agent
    await manage.start()
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    agent.start()
    src = np.array(SRC_BLOCKS, np.int32)
    for i in range(need_save):
        await cluster.save(prompts[i], _mk_caches(spec, i, device), src)
    try:
        await stop.wait()
    finally:
        agent.stop()
        await manage.stop()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="infinistore-tpu-torch-fleet-client",
        description="scriptable cluster-client worker (docs/membership.md)",
    )
    p.add_argument("--stores", default="", help="host:service_port, comma-sep")
    p.add_argument("--journal", default="", help="durable journal path")
    p.add_argument("--manage-port", type=int, default=0)
    p.add_argument("--peers", default="",
                   help="peer manage planes host:manage_port, comma-sep")
    p.add_argument("--seed", type=int, default=23)
    p.add_argument("--roots", type=int, default=0)
    p.add_argument("--replicas", type=int, default=2)
    p.add_argument("--gossip-interval", type=float, default=0.25)
    p.add_argument("--crash-after-moved", type=int, default=0)
    p.add_argument("--reshard-batch-bytes", type=int, default=0)
    p.add_argument("--bootstrap", action="store_true")
    p.add_argument("--verify", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="where the caches live: cuda (raises without a card) or cpu")
    args = p.parse_args(argv)
    device = _ext.resolve_device(args.device)
    Logger.set_log_level("error")

    import infinistore_tpu_torch as its

    spec = _spec()
    prompts = _prompts(spec, args.seed, args.roots)
    cluster = _build_cluster(args, its, spec, device)
    try:
        if args.reshard_batch_bytes:
            cluster.resharder.max_batch_bytes = args.reshard_batch_bytes
        recovered = cluster.recovered
        if args.crash_after_moved > 0 and recovered is None:
            # First incarnation only: a recovered process must FINISH the
            # reshard, not crash again at the same mark.
            _arm_crash_after_moved(cluster, args.crash_after_moved)
        if args.verify:
            print(json.dumps(_verify(args, cluster, spec, prompts, device)))
            sys.stdout.flush()
            return 0
        need_save = args.roots
        if recovered is not None and recovered.get("roots", 0) >= args.roots:
            need_save = 0  # idempotent restart: the journal already knows
        asyncio.run(_serve(args, cluster, spec, prompts, need_save, device))
        return 0
    finally:
        cluster.close()


if __name__ == "__main__":
    sys.exit(main())
