"""engine.output_tokens_per_s: tokens generated in the window (each stamped when its
decode step's result reached the host) over the window's seconds."""


def read(run):
    return run.tokens_in_window() / run.seconds
