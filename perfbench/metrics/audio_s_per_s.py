"""Audio seconds the clients received inside the window, over the window:
the card's capacity where a closed loop keeps it full."""
SOURCE = "host_clock"


def read(run):
    w0, w1 = run.window
    frames = sum(n for t, n in run.chunks if w0 <= t < w1)
    return frames * run.ccfg.hop_length / run.ccfg.sample_rate / run.seconds
