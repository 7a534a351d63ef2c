"""setup_s: seconds from the process's start to the window's: imports, the
catalogs and grids, the program's objects, and the traffic's shapes run once
(in a fresh checkout also the kernels' build)."""


def read(run):
    return run.setup_s
