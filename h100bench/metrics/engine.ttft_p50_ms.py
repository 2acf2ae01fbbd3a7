"""engine.ttft_p50_ms: from the moment a session sends a turn to its first generated
token on the host, the median over the turns whose first token came in the window
(no bound: on a host that swings its runs spread more than half the largest bound,
PERF.md §2)."""


def read(run):
    v = run.percentile([t.first_token - t.t_send for t in run.first_token_in_window()], 50)
    return None if v is None else v * 1e3
