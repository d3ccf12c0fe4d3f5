"""95th percentile over every request sent in the window of (arrival of
its last audio byte - when it was due or sent) / its audio seconds; below
1 keeps ahead of playback.  A failed request reads as missing."""
from perfbench.harness import MISSING
from perfbench.stats import percentile

SOURCE = "host_clock"


def read(run):
    vals = [(r["chunks"][-1][0] - r["due"]) / r["audio_s"]
            if r["ok"] and r["audio_s"] > 0 else MISSING for r in run.sent]
    return percentile(vals, 95)
