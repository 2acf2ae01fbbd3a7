"""setup_s: seconds from the process's start to the window's start: imports,
loading (or, in a fresh checkout, building) the kernels and the store
library, the weights, the store's pool, the paged cache and the warm-up
turns."""


def read(run):
    return run.setup_s
