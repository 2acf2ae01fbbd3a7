"""engine.ttft_save_share: in percent, the summed wall of the program's
``engine.save`` spans of path ``ttft`` (the prompt's computed suffix, saved
before the first token) over the summed program TTFT (``engine_request``'s
``enqueue`` to its first ``token`` stamp, taken once the token is on the
host), over the turns whose first token came in the window."""

from h100bench import program_spans as ps_mod


def read(run):
    ps = ps_mod.of_run(run)
    if ps is None:
        return None
    turns = ps_mod.turns_in_window(ps, run.start, run.end)
    ttft = sum(t.at("token") - t.at("enqueue") for t in turns)
    saves = ps_mod.ttft_saves(ps, turns)
    wall = sum(s.end - s.start for group in saves.values() for s in group)
    return 100.0 * wall / ttft if ttft > 0 else None
