"""store.save_wire_ms_p50: for each ``ttft`` save (``engine.save`` before the
first token) of the turns whose first token came in the window, the union of
its ``store.*`` wire ops' ``submit`` -> ``completion_ring`` intervals (the
program's own spans); the median, in ms. Beside the save's wall it tells the
wire (the server, its queues) from the client (the in-flight queue, the
device-to-host waits)."""

from h100bench import program_spans as ps_mod


def read(run):
    ps = ps_mod.of_run(run)
    if ps is None:
        return None
    turns = ps_mod.turns_in_window(ps, run.start, run.end)
    wire = [ps_mod.save_wire_s(ps, s)
            for group in ps_mod.ttft_saves(ps, turns).values() for s in group]
    v = ps_mod.percentile([w for w in wire if w is not None], 50)
    return None if v is None else v * 1e3
