"""99th percentile of how late a 1 ms ticker on the server's event loop
wakes through the window: how long other work holds the loop."""
from perfbench.stats import percentile

LAYER = "server and scheduler"
SOURCE = "program_span"


def read(run):
    if not run.lags:
        return None
    return percentile([x * 1e3 for x in run.lags], 99)
