"""Speech tokens the clients' requests got in the window, over the pool's
token steps (``decode_steps``, each step counting its width): how many of
the pool's rows a token step fills."""
LAYER = "TTS pool"
SOURCE = "program_counter"


def read(run):
    steps = run.delta("pool_decode_steps")
    if not steps:
        return None
    return sum(n for n, _ in run.blocks_window) / steps
