"""95th percentile over every request sent in the window of the time from
when it was due (open loop) or sent (closed loop) to its first audio bytes
at the client; a failed request reads as missing (``harness.MISSING``)."""
from perfbench.harness import MISSING
from perfbench.stats import percentile

SOURCE = "host_clock"


def read(run):
    vals = [(r["chunks"][0][0] - r["due"]) * 1e3
            if r["ok"] and r["chunks"] else MISSING for r in run.sent]
    return percentile(vals, 95)
