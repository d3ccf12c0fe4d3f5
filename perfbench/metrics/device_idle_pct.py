"""Share of the traced sub-window in which no operation ran on the card."""
LAYER = "device"
SOURCE = "device_trace"


def read(run):
    if not run.trace or not run.trace["n_ops"]:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
