"""Host milliseconds the TTS pool spends gathering and launching a step
(its ``dispatch_s``), over the window's steps (``steps``)."""
LAYER = "TTS pool"
SOURCE = "program_counter"


def read(run):
    steps = run.delta("pool_steps")
    if not steps:
        return None
    return run.delta("pool_dispatch_s") / steps * 1e3
