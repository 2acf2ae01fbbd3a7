"""store.load_GBps: bytes of the prefix blocks that hits loaded over the
hits' summed store fetch and install times (RequestStats.fetch_us +
gate_hold_us), over the turns whose first token came in the window."""


def read(run):
    hits = [t for t in run.first_token_in_window() if t.stats.loaded_blocks]
    us = sum(t.stats.fetch_us + t.stats.gate_hold_us for t in hits)
    nbytes = sum(t.stats.loaded_blocks for t in hits) * run.shapes.block_bytes()
    return nbytes / (us * 1e-6) / 1e9 if us > 0 else None
