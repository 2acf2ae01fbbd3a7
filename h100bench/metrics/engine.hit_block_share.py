"""engine.hit_block_share: in percent, prompt blocks loaded from the store
(RequestStats.loaded_blocks) over prompt blocks, summed over the turns whose
first token came in the window."""


def read(run):
    turns = run.first_token_in_window()
    blocks = sum(t.stats.loaded_blocks + t.stats.computed_blocks for t in turns)
    return 100.0 * sum(t.stats.loaded_blocks for t in turns) / blocks if blocks else None
