"""From the process's start until the first request is due: imports, the
kernels' build, the weights, the server's CUDA graphs and first replays,
the load generator's start."""
SOURCE = "host_clock"


def read(run):
    return run.setup_s
