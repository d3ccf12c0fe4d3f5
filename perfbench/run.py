"""Run one cell of the benchmark once.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  The last line of standard output is the result, one JSON object;
the lines before it on standard error give the card, the set-up's steps,
the window's counts and, last, each number the check compared beside its
limit.  Without CUDA, or with fewer cards than the cell asks for, it
exits with 2 and prints no result; so it does if JAX or the JAX package
is loaded once the window has closed.  See ``README.md``.
"""
from __future__ import annotations

import os
import time


def _process_start() -> float:
    """This process's start on ``time.monotonic()``'s clock: its age from
    /proc (start ticks against the uptime, both since boot), or now."""
    now = time.monotonic()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return now - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return now


T_PROC = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

# transformers, if anything loads it, must not load JAX or Flax
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

FORBIDDEN = ("jax", "jaxlib", "flax", "llmvox_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (the port's name begins with the JAX
    package's)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    print(f"[setup] interpreter start {time.monotonic() - T_PROC:.3f} s",
          file=sys.stderr, flush=True)

    import torch
    from perfbench.spec import Bench
    bench = Bench()
    chips = bench.workload(args.workload)["chips"]
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark runs only on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    from perfbench.harness import run_cell
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), chips=chips, bench=bench,
                      t_proc=T_PROC)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 2
    checks = result.pop("checks")
    for name, c in checks.items():
        print(f"[check] {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    result["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
