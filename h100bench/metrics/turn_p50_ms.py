"""turn_p50_ms: from the moment a session sends a turn to the turn's return (its
answer generated and the answer's blocks saved to the store, when the session
sends its next turn), the median over the turns that returned in the window."""


def read(run):
    v = run.percentile([t.t_return - t.t_send for t in run.returned_in_window()], 50)
    return None if v is None else v * 1e3
