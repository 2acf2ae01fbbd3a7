"""engine.token_gap_p90_ms: the gaps between consecutive ``token`` stamps of
each request (the program stamps a token once it is on the host), for the
gaps that ended in the window; the 90th percentile, in ms."""

from h100bench import program_spans as ps_mod


def read(run):
    ps = ps_mod.of_run(run)
    if ps is None:
        return None
    v = ps_mod.percentile(ps_mod.token_gaps(ps, run.start, run.end), 90)
    return None if v is None else v * 1e3
