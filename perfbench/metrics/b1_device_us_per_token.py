"""Device busy microseconds in the traced sub-window over the dedicated
replicas' decode steps in it (``TTSEngine.decode_steps``, a block
counting its length)."""
LAYER = "model step"
SOURCE = "device_trace"


def read(run):
    steps = run.delta("engine_decode_steps", "s0", "s1")
    if not run.trace or not run.trace["n_ops"] or not steps:
        return None
    return run.trace["busy_s"] / steps * 1e6
