"""The check's two readings, on the card at a cell's own size: for each
seed one run of the cell with a short window, judged as every run is
(the program's readings: the lower ones) and again with the control in
the program's place (``reference/check.py``: the decoder's and the LLM's
weights through float8, the codec with TF32 on; the upper ones), and the
control judged against the cell's limits by the rule that decides
``correct``.  The benchmark's own runs never run it.  A limit sits
between the largest lower reading and the smallest upper one (``PERF.md``
keeps both).  It exits with 1 where a seed's control reads correct or a
seed's program does not.

    python3 -m perfbench.control --workload <cell> --seeds 1,2,3 \\
        [--seconds 10] [--out control.json]
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from perfbench.harness import run_cell
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run_cell(args.workload, seed, args.seconds, False,
                       control=True)
        row = {"seed": seed, "correct": res["correct"],
               "control_correct": res["control_correct"],
               **{k: v["value"] for k, v in res["checks"].items()}}
        rows.append(dict(row, readings=res.get("readings")))
        print(json.dumps(row), flush=True)
    # every reading the control has a twin of, compared or not
    readings = [r["readings"] for r in rows]
    names = [k for k in readings[0] if "control_" + k in readings[0]
             and isinstance(readings[0][k], (int, float))]
    summary = {k: {"lower": max(r[k] for r in readings),
                   "upper": min(r["control_" + k] for r in readings)}
               for k in names}
    failed = {"control reads correct": [r["seed"] for r in rows
                                         if r["control_correct"]],
              "program reads not correct": [r["seed"] for r in rows
                                            if not r["correct"]]}
    print(json.dumps({"workload": args.workload, "summary": summary,
                      "failed": failed}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary, "failed": failed},
                      f, indent=1)
    return 1 if any(failed.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
