"""engine.tpot_p90_ms: per turn, (its return - its first token) / (tokens - 1), the
90th percentile over the turns that returned in the window. The return comes
after the answer's blocks are saved to the store, so the save is inside."""


def read(run):
    v = run.percentile([(t.t_return - t.first_token) / (t.gen - 1)
                        for t in run.returned_in_window() if t.gen > 1], 90)
    return None if v is None else v * 1e3
