"""Engine-facing KV-cache connector (port of ``infinistore_tpu/connector.py``:
``token_chain_hashes``, ``_ChainHashCache`` and ``KVConnector`` with
lookup / save / load / manifest / get_stats / drop).

A connector hashes token prefixes into chain keys, asks the store how much
of a prompt is already cached (``get_match_last_index``), and streams
paged-KV blocks layer by layer. It binds a paged cache spec + host staging
pool + store connection to a model id and exposes lookup / save / load in
engine terms (token ids and block ids).

Key scheme: ``{model}/L{layer}/{k|v}/{chain_hash_i}`` where ``chain_hash_i``
is a rolling SHA-256 over token blocks [0..i]. A block's key therefore
commits to the *entire prefix*, so two prompts share keys exactly for their
common block-aligned prefix. Keys, hashes and block bytes are identical to
the JAX package's, so a prefix either package saved loads in the other.
"""

import asyncio
import hashlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import tracing, wire
from .cuda import _ext
from .cuda.layerwise import LayerwiseKVReader, LayerwiseKVWriter, PartialReadError
from .cuda.paged import PagedKVCacheSpec
from .cuda.staging import HostStagingPool
from .lib import (
    InfiniStoreColdTier,
    InfiniStoreKeyNotFound,
    InfiniStoreNoMatch,
    InfiniStoreResourcePressure,
)
from .tiering import note_demotion_hit as tiering_note_demotion_hit


def token_chain_hashes(token_ids: Sequence[int], block_tokens: int) -> List[str]:
    """Rolling prefix hash per *complete* token block.

    hash_i covers tokens [0, (i+1) * block_tokens); an incomplete tail block
    is excluded (it cannot be reused — its key would never match another
    request's complete block).
    """
    n_full = len(token_ids) // block_tokens
    hashes = []
    h = hashlib.sha256()
    for i in range(n_full):
        chunk = np.asarray(
            token_ids[i * block_tokens : (i + 1) * block_tokens], dtype=np.int64
        )
        h.update(chunk.tobytes())
        hashes.append(h.copy().hexdigest()[:32])
    return hashes


class _ChainHashCache:
    """Incremental chain-hash cache for repeated/extended token prefixes.

    Chain hashes commit to the whole prefix, so an unchanged prefix yields
    byte-identical hashes call after call. This caches the last prompt's
    full-block tokens, its chain list, and the live sha256 state after the
    final full block:

    - same prompt again        -> one array compare, zero hashing
    - the cached prompt's own  -> a slice of the cached chains
      prefix (fewer blocks)
    - extended prompt          -> hash only the new tail blocks
    - anything else            -> full recompute, cache replaced

    One entry only, held as ONE tuple read once and swapped atomically (the
    GIL makes the swap safe; sync lookups may run from concurrent threads):
    churn between two prompt families costs a recompute, never a wrong
    hash."""

    __slots__ = ("_state",)

    def __init__(self):
        # (block_tokens, full-block tokens ndarray, chain hashes, sha256
        # state after the last cached full block) — or None before first use.
        self._state: Optional[tuple] = None

    def hashes(self, token_ids: Sequence[int], block_tokens: int) -> List[str]:
        n_full = len(token_ids) // block_tokens
        if n_full == 0:
            return []
        # copy=True matters: for ndarray inputs asarray would keep a VIEW of
        # the caller's buffer, and an engine reusing that buffer for the next
        # prompt would mutate our cached tokens into falsely matching it —
        # returning the OLD prompt's hashes (another request's KV keys).
        toks = np.array(token_ids[: n_full * block_tokens], dtype=np.int64, copy=True)
        state = self._state  # one read: threads race the swap, never a tear
        if state is not None and state[0] == block_tokens:
            _, c_toks, c_hashes, c_h = state
            if toks.size <= c_toks.size and np.array_equal(
                toks, c_toks[: toks.size]
            ):
                # Repeat or prefix of the cached prompt: pure cache read
                # (keep the longer entry — serving its prefixes is free).
                return c_hashes[:n_full]
            if toks.size > c_toks.size and np.array_equal(
                toks[: c_toks.size], c_toks
            ):
                # Extension: hash only the new tail blocks.
                h = c_h.copy()
                hashes = list(c_hashes)
                for i in range(len(hashes), n_full):
                    h.update(toks[i * block_tokens : (i + 1) * block_tokens].tobytes())
                    hashes.append(h.copy().hexdigest()[:32])
                self._state = (block_tokens, toks, hashes, h)  # atomic swap
                return list(hashes)
        h = hashlib.sha256()
        hashes = []
        for i in range(n_full):
            h.update(toks[i * block_tokens : (i + 1) * block_tokens].tobytes())
            hashes.append(h.copy().hexdigest()[:32])
        self._state = (block_tokens, toks, hashes, h)  # atomic swap
        return list(hashes)


class KVConnector:
    """Bind one model's paged KV cache to a store connection.

    The engine calls, per request:
      - ``lookup(tokens)`` -> how many leading blocks are already cached
      - ``load(tokens, caches, block_ids)`` -> scatter those blocks into the
        engine's paged cache (skipping recompute of the shared prefix)
      - ``save(tokens, caches, block_ids)`` -> stream the request's blocks
        out, layer by layer, overlapping device-to-host copies with the
        network

    ``device``: where the engine's caches live (default ``"cuda"``; raises
    when no card is present). The staging pool is page-locked for a CUDA
    device; ``close()`` releases it and must come before the connection's
    own close."""

    def __init__(
        self,
        conn,
        spec: PagedKVCacheSpec,
        model_id: str,
        max_blocks: int,
        pool: Optional[HostStagingPool] = None,
        device="cuda",
    ):
        self.device = _ext.resolve_device(device)
        self.conn = conn
        self.spec = spec
        self.model_id = model_id
        self.max_blocks = max_blocks
        if pool is None:
            # 6 read-staging regions (K+V each): deep enough that network
            # fetches and uploads overlap several layers (layerwise.py
            # _LayerRegions adapts the pipeline depth to this size).
            pool = HostStagingPool(
                12 * max_blocks * spec.block_nbytes, spec.block_nbytes, conn=conn,
                device=self.device,
            )
        self.pool = pool
        self._writer = LayerwiseKVWriter(conn, pool, spec, max_blocks)
        self._reader = LayerwiseKVReader(conn, pool, spec, max_blocks)
        # Chain-hash + sentinel-key caches: admission re-derives the same
        # prefix's keys on every lookup/load/save.
        self._chain_cache = _ChainHashCache()
        self._keys0_cache: Optional[Tuple[List[str], List[str]]] = None

    def close(self) -> None:
        """Release the staging pool's page lock (idempotent)."""
        self.pool.close()

    # -- key scheme ----------------------------------------------------------

    def block_key(self, layer: int, kind: str, chain_hash: str) -> str:
        """Store key for one block: ``{model}/L{layer}/{k|v}/{chain_hash}``."""
        return f"{self.model_id}/L{layer}/{kind}/{chain_hash}"

    def _key_fn(self, chains: List[str]):
        def key_fn(layer: int, kind: str, block: int) -> str:
            return self.block_key(layer, kind, chains[block])

        return key_fn

    def _chains(self, token_ids: Sequence[int]) -> List[str]:
        """Chain hashes for this prompt's complete blocks, served from the
        incremental cache."""
        return self._chain_cache.hashes(token_ids, self.spec.block_tokens)

    def _sentinel_keys(self, chains: List[str]) -> List[str]:
        """Layer-0 K keys for a chain (the whole-block presence sentinels
        lookups send). Cached: because chain hash i commits to the entire
        prefix, a match on length + final hash proves the whole key list is
        the cached one, and a shorter chain is served as a slice of a cached
        longer one."""
        cached = self._keys0_cache
        n = len(chains)
        if cached is not None:
            c_chains, c_keys = cached
            if len(c_chains) >= n and c_chains[n - 1] == chains[-1]:
                return c_keys[:n]
        keys = [self.block_key(0, "k", c) for c in chains]
        self._keys0_cache = (list(chains), keys)
        return keys

    def manifest(self, token_ids, n_blocks: Optional[int] = None):
        """Every store key this connector would hold for the prompt's first
        ``n_blocks`` complete blocks (default: all), as size-grouped
        ``[(block_nbytes, [key, ...])]``. Sentinel ordering: the layer-0 K
        key of each block (what ``lookup`` probes) is LAST in its group, so
        a batched copy that dies mid-stream never publishes a sentinel for
        an incompletely copied block."""
        chains = self._chains(token_ids)
        if n_blocks is not None:
            chains = chains[:n_blocks]
        keys = [
            self.block_key(layer, kind, c)
            for layer in range(self.spec.num_layers)
            for kind in ("k", "v")
            for c in chains
            if (layer, kind) != (0, "k")
        ] + [self.block_key(0, "k", c) for c in chains]
        return [(self.spec.block_nbytes, keys)] if keys else []

    # -- engine surface ------------------------------------------------------

    def lookup(self, token_ids: Sequence[int]) -> int:
        """Number of leading blocks of this prompt already in the store.

        One control round-trip: the layer-0 K keys stand in for the whole
        block (the writer commits layer 0 last, so a present sentinel means
        every layer is present), and the store's binary-search longest-prefix
        match does the rest.

        Only a semantic no-match maps to 0. A dead store, a timeout, or a
        protocol error raises — the engine must see the difference between
        "not cached" and "store unreachable"."""
        return self._lookup_chains(self._chains(token_ids))

    def _lookup_chains(self, chains: List[str]) -> int:
        if not chains:
            return 0
        keys = self._sentinel_keys(chains)
        try:
            # The blocking probe RTT: async callers hop it through an
            # executor (load()'s to_thread); sync lookup() owns the cost.
            return self.conn.get_match_last_index(keys) + 1  # its: allow[ITS-L001]
        except InfiniStoreNoMatch:
            return 0

    async def save(
        self, token_ids, caches, block_ids: np.ndarray, first_block: int = 0,
        priority: int = wire.PRIORITY_BACKGROUND,
    ) -> int:
        """Stream the request's KV blocks to the store. ``block_ids[i]`` is
        the engine's physical block holding logical block ``first_block + i``
        of this prompt. Returns blocks written (K+V across layers).

        Saves are BACKGROUND class by default (docs/qos.md): a prefill save
        is never decode-blocking. ``first_block`` serves sharded producers:
        each passes the FULL token list (chain hashes commit to the whole
        prefix) but saves just its logical span."""
        chains = self._chains(token_ids)
        if first_block < 0 or first_block > len(chains):
            raise ValueError(
                f"first_block={first_block} outside the prompt's "
                f"{len(chains)} complete blocks"
            )
        chains = chains[first_block:]
        n = min(len(chains), len(block_ids))
        if n == 0:
            return 0
        return await self._writer.write(
            caches, np.asarray(block_ids[:n]), self._key_fn(chains),
            priority=priority,
        )

    async def load(
        self, token_ids, caches, block_ids: np.ndarray, first_block: int = 0,
        on_layer=None,
    ):
        """Fetch this prompt's cached prefix into the engine's paged cache.

        Fetches up to ``lookup(tokens) - first_block`` blocks (capped by
        len(block_ids)) and scatters them in place; returns (caches,
        blocks_loaded). ``first_block`` skips a prefix the engine already
        holds: ``block_ids[i]`` then receives logical block ``first_block +
        i`` — symmetric with ``save``'s ``first_block``.

        On a mid-read store miss the returned caches are the partially
        updated list (``PartialReadError.caches``); use the returned list.

        ``on_layer(layer, (k, v))``: optional per-layer progress hook (layers
        complete in order — see LayerwiseKVReader.read)."""
        chains = self._chains(token_ids)
        if first_block < 0 or first_block > len(chains):
            raise ValueError(
                f"first_block={first_block} outside the prompt's "
                f"{len(chains)} complete blocks"
            )
        # The prefix lookup is a blocking store round trip: hop it through
        # the default executor so it does not stall the event loop.
        hit = await asyncio.to_thread(self._lookup_chains, chains)
        n = min(hit - first_block, len(block_ids))
        if n <= 0:
            return list(caches), 0
        # Trace: the cached prefix's store streaming begins here (the probe
        # above is control-plane; fetch_start marks the first data-plane leg).
        tspan = tracing.active_span()
        if tspan is not None:
            tspan.stage("fetch_start")
            tspan.annotate(hit_blocks=hit, fetch_blocks=n)
        span = chains[first_block : first_block + n]
        try:
            out = await self._reader.read(
                caches, np.asarray(block_ids[:n]), self._key_fn(span),
                on_layer=on_layer,
            )
        except PartialReadError as e:
            if isinstance(
                e.cause, (InfiniStoreKeyNotFound, InfiniStoreResourcePressure)
            ):
                # KeyNotFound: blocks raced away between lookup and read.
                # ResourcePressure: store RAM too pressured to serve right
                # now. Cache semantics either way — the engine recomputes;
                # transport errors still propagate.
                if isinstance(e.cause, InfiniStoreColdTier):
                    # The typed 512: cold BUT ALIVE — a tier demotion hit,
                    # not a miss (docs/tiering.md).
                    tiering_note_demotion_hit()
                return e.caches, 0
            raise
        return out, n

    def get_stats(self) -> dict:
        """The store connection's per-op stats snapshot."""
        return self.conn.get_stats()

    def drop(self, token_ids) -> int:
        """Remove this prompt's blocks from the store (all layers). Returns
        the number of store keys deleted."""
        chains = self._chains(token_ids)
        keys = [
            self.block_key(layer, kind, c)
            for layer in range(self.spec.num_layers)
            for kind in ("k", "v")
            for c in chains
        ]
        return self.conn.delete_keys(keys) if keys else 0
