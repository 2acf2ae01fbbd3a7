"""engine.ttft_p90_ms: as engine.ttft_p50_ms, the 90th percentile (no bound: its runs
spread too widely, PERF.md §2)."""


def read(run):
    v = run.percentile([t.first_token - t.t_send for t in run.first_token_in_window()], 90)
    return None if v is None else v * 1e3
