"""A rate sweep of an open-loop cell, run once to fix the cell's rate.

The cell's system is built once; each rate then gets ``--seconds`` of the
cell's traffic from a fresh load generator, and the requests sent drain.
A rate is sustained when every request finished within ``--drain``
seconds of the phase's end and the median time to first audio of the
phase's last third is at most 1.5 times that of its first third (a
backlog that grows shows as a rising time to first audio).  Print one
line per rate; the cell runs at about four fifths of the highest rate
sustained.  The benchmark's own runs never run it.

    python3 -m perfbench.sweep --workload <cell> --rates 1,2,4 \\
        [--seconds 30] [--seed 1]
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time


def phase(sysm, mix, seed, rate, seconds, drain):
    from perfbench.traffic import generate
    from perfbench.traffic.drive import LoadProcess
    reqs = generate.requests(mix, seed, seconds, rate=rate)
    start = time.monotonic() + 0.5
    load = LoadProcess(sysm.port, mix["endpoint"], reqs, start,
                       start + seconds, start + seconds + drain)
    try:
        out = load.records()
        load.pcm([])
    finally:
        load.close()
    recs = sorted(out["records"], key=lambda r: r["due"])
    ok = [r for r in recs if r["ok"] and r["chunks"]]
    ttfa = [(r["chunks"][0][0] - r["due"]) * 1e3 for r in ok]
    third = max(1, len(ttfa) // 3)
    first = statistics.median(ttfa[:third]) if ttfa else float("inf")
    last = statistics.median(ttfa[-third:]) if ttfa else float("inf")
    return {"rate": rate, "sent": len(recs), "finished": len(ok),
            "ttfa_p50_ms": statistics.median(ttfa) if ttfa else None,
            "ttfa_first_third_ms": first, "ttfa_last_third_ms": last,
            "sustained": len(ok) == len(recs) and last <= 1.5 * first}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--drain", type=float, default=30.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from llmvox_tpu_torch.ops import build
    from perfbench import system
    from perfbench.spec import Bench
    build.build_all()
    bench = Bench()
    wl = bench.workload(args.workload)
    mix = bench.mix(wl["traffic"])
    laps = {}
    sysm = system.System(bench.config(wl["config"]), wl, args.seed, "cuda",
                         laps)
    server = system.ServerThread(sysm.server, sysm.port)
    server.start()
    try:
        for rate in (float(r) for r in args.rates.split(",")):
            print(json.dumps(phase(sysm, mix, args.seed, rate, args.seconds,
                                   args.drain)), flush=True)
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
