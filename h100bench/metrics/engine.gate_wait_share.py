"""engine.gate_wait_share: in percent, the engine's exclusive device-gate waits
(RequestStats.gate_stall_us, the program's own counter) over the turns' TTFT
(RequestStats.ttft_us), summed over the turns whose first token came in the
window."""


def read(run):
    turns = run.first_token_in_window()
    ttft = sum(t.stats.ttft_us for t in turns)
    return 100.0 * sum(t.stats.gate_stall_us for t in turns) / ttft if ttft > 0 else None
