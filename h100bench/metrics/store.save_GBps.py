"""store.save_GBps: bytes handed to the store's save over the summed wall
time of those calls (the benchmark's own span around EngineKVAdapter.save_kv,
serve.TimedAdapter), for the saves that ended in the window."""


def read(run):
    saves = [(a, b, n) for a, b, n in run.saves if run.inside(b)]
    s = sum(b - a for a, b, _ in saves)
    return sum(n for _, _, n in saves) / s / 1e9 if s > 0 else None
