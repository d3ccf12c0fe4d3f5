"""Device busy milliseconds in the traced sub-window over the pool's token
steps in it."""
LAYER = "model step"
SOURCE = "device_trace"


def read(run):
    steps = run.delta("pool_decode_steps", "s0", "s1")
    if not run.trace or not run.trace["n_ops"] or not steps:
        return None
    return run.trace["busy_s"] / steps * 1e3
