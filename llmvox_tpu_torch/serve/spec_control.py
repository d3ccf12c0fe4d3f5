"""Adaptive speculation depth for the pooled decoder.

The port's copy of ``llmvox_tpu/serve/spec_control.py``, its code
unchanged: the port keeps its own copy of what it needs.

Speculative block decode (models/decoder.py::decode_block_spec_batch)
trades ~2 memory sweeps per iteration for committing up to
``k_draft + 1`` tokens — whether a depth pays, and which depth pays
MOST, depends on the live accept rate, which depends on the checkpoint's
draft heads and on the data actually being decoded.  The original
LLMVoX decode loop is strictly per-token, with no speculation; this
controller is the operational piece that makes speculation safe to
leave ON in production: it watches the per-iteration accept statistics
the spec blocks already return, keeps a running estimate of the
per-position accept probability, and moves the pool between its
depth rungs — including rung 0 (the plain greedy block) — whenever the
predicted tokens/ms of another rung clears a hysteresis margin.  A
checkpoint whose draft heads never accept costs one probe step per
``probe_every`` instead of a permanent 2x slowdown.

Model: per-iteration commits = (leading draft accepts) + 1, and with an
iid per-position accept probability p the expected commits at depth k is
``E_k(p) = 1 + p + ... + p^k = (1 - p^(k+1)) / (1 - p)``.  p is
estimated by inverting ``E_k`` at the observed mean commits (EWMA'd),
which transfers the estimate across rungs.  Step cost per committed
token at rung k is ``cost_ms[k] / E_k(p)`` with ``cost_ms`` calibrated
once at warmup (DecodePool._calibrate_spec_costs) — the mean-field
approximation ignores that a batched step pays its slowest ROW's
iterations (E[max] > E[mean]); the switch margin absorbs that bias, and
the safety property does not depend on the model at all: every rung is
bit-identical (greedy) or distribution-exact (sampled) to the plain
block, so a wrong pick only costs speed.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence


def expected_commits(p: float, k: int) -> float:
    """E[tokens committed per iteration] at depth ``k`` with iid
    per-position accept probability ``p``: sum_{i=0..k} p^i."""
    if k <= 0:
        return 1.0
    if p >= 1.0:
        return float(k + 1)
    if p <= 0.0:
        return 1.0
    return (1.0 - p ** (k + 1)) / (1.0 - p)


def solve_p(mean_commits: float, k: int, tol: float = 1e-5) -> float:
    """Invert :func:`expected_commits` in p for fixed ``k`` (monotone).
    Observed means are clamped into the achievable open interval."""
    if k <= 0:
        raise ValueError("solve_p needs a speculative rung (k > 0)")
    m = min(max(float(mean_commits), 1.0), k + 1 - 1e-9)
    lo, hi = 0.0, 1.0
    while hi - lo > tol:
        mid = (lo + hi) / 2.0
        if expected_commits(mid, k) < m:
            lo = mid
        else:
            hi = mid
    return (lo + hi) / 2.0


class SpecController:
    """Pick the speculation rung for the next pool step.

    ``ladder`` is the set of compiled depths (rung 0 = the greedy
    block is always available); ``cost_ms`` maps each rung to its
    measured per-iteration cost (for rung 0: per-token cost — a greedy
    "iteration" commits exactly one token).  Rungs without a cost entry
    are never chosen.  The controller only ever returns rungs from the
    ladder, so a stale estimate can cost speed, never correctness.
    """

    def __init__(self, ladder: Sequence[int], k0: Optional[int] = None,
                 cost_ms: Optional[Dict[int, float]] = None,
                 ewma: float = 0.85, margin: float = 1.15,
                 dwell: int = 16, probe_every: int = 64):
        rungs = sorted({int(k) for k in ladder if k >= 0} | {0})
        if len(rungs) < 2:
            raise ValueError("ladder needs at least one rung > 0")
        self.ladder = tuple(rungs)
        self.cost_ms: Dict[int, float] = dict(cost_ms or {})
        self.k = int(k0) if k0 is not None and int(k0) in rungs \
            else self.ladder[-1]
        self.p: Optional[float] = None      # per-position accept estimate
        self.ewma = float(ewma)
        self.margin = float(margin)
        self.dwell = int(dwell)
        self.probe_every = int(probe_every)
        self.switches = 0
        self.probes = 0
        self._steps_since_switch = 0
        self._steps_since_spec = 0
        self._probed = False

    # -- statistics in ---------------------------------------------------
    def observe(self, k: int, commits: float, iters: float) -> None:
        """Feed one speculative step's pooled totals: ``commits`` tokens
        committed over ``iters`` per-row iterations (summed over active
        rows).  Greedy steps (k == 0) carry no accept signal."""
        if k <= 0 or iters <= 0:
            return
        p = solve_p(commits / iters, k)
        # a probe arrives after probe_every greedy steps: the old
        # estimate is stale by construction, so weight the fresh sample
        # heavily or recovery off greedy would take ~1/ewma probes
        w = 0.3 if self._probed else self.ewma
        self.p = p if self.p is None else w * self.p + (1.0 - w) * p
        self._probed = False
        self._steps_since_spec = 0

    # -- prediction -------------------------------------------------------
    def tokens_per_ms(self, k: int, p: Optional[float] = None
                      ) -> Optional[float]:
        c = self.cost_ms.get(int(k))
        if c is None or c <= 0:
            return None
        p = self.p if p is None else p
        if p is None:
            return None
        return expected_commits(p, k) / c

    # -- decision ---------------------------------------------------------
    def next_k(self) -> int:
        """Rung for the next step.  Called once per dispatched step."""
        self._steps_since_switch += 1
        self._steps_since_spec += 1
        spec_rungs = [k for k in self.ladder if k > 0]
        if self.p is None:
            # no accept signal yet: start speculating to get one
            return self.k if self.k > 0 else spec_rungs[0]
        if self.k == 0 and self._steps_since_spec >= self.probe_every:
            # parked on greedy: spend one probe step so a shift in the
            # accept rate (new speaker, new domain) can be noticed
            self.probes += 1
            self._probed = True
            self._steps_since_spec = 0
            return spec_rungs[0]
        if self._steps_since_switch < self.dwell:
            return self.k
        cur = self.tokens_per_ms(self.k)
        best_k, best = self.k, cur
        for k in self.ladder:
            t = self.tokens_per_ms(k)
            if t is not None and (best is None or t > best):
                best_k, best = k, t
        if best_k != self.k and cur is not None and best is not None \
                and best < cur * self.margin:
            return self.k                   # inside the hysteresis band
        if best_k != self.k:
            self.k = best_k
            self.switches += 1
            self._steps_since_switch = 0
        return self.k

    # -- observability ----------------------------------------------------
    def stats(self) -> Dict:
        return {
            "k": self.k,
            "p_hat": None if self.p is None else round(self.p, 4),
            "ladder": list(self.ladder),
            "cost_ms": {k: round(v, 4) for k, v in self.cost_ms.items()},
            "switches": self.switches,
            "probes": self.probes,
        }
