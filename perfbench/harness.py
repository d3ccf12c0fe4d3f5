"""One run of one cell: set-up, the measured window, the check.

1. Build the configuration's weights on the device from the seed, build
   the port's kernels (into ``build/llmvox_tpu_torch/`` in the checkout),
   the server and its CUDA graphs (``system.py``); warm only the cell's
   shapes.  Start the server on its own thread.
2. Start the load generator as a child process (``traffic/client.py``)
   with the requests ``traffic/generate.py`` draws from the mix and seed.
   ``setup_s`` ends when the first request is due.
3. After the cell's ramp, measure for ``--seconds``: the program's
   counters are read at the window's edges; a traced run (``--trace 1``)
   also runs the 1 ms ticker on the server's loop and profiles the
   window's last seconds (``profile.py``).
4. Requests sent in the window drain, up to the cell's ``drain_s``; one
   still open then has failed.
5. Read the device's peak memory, stop the server, drop the program's
   state, and judge a sample of the finished requests, drawn from the
   seed with the longest among them, against the reference
   (``reference/check.py``).
6. Every metric the cell reports comes from its file under ``metrics/``.
"""
from __future__ import annotations

import base64
import faulthandler
import gc
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import profile, system
from perfbench.reference import check
from perfbench.reference import text as ref_text
from perfbench.spec import Bench
from perfbench.traffic import generate
from perfbench.traffic.drive import LoadProcess

# a request that failed reads as this, so it misses every limit
MISSING = 1e9


_T0 = time.monotonic()


def _log(msg: str) -> None:
    print(f"[{time.monotonic() - _T0:7.1f}] {msg}", file=sys.stderr,
          flush=True)


class Run:
    """What the metric readers read (``metrics/<name>.py``'s ``read``)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def delta(self, key: str, a: str = "w0", b: str = "w1"):
        c0, c1 = self.counters.get(a), self.counters.get(b)
        if not c0 or not c1 or key not in c0:
            return None
        return c1[key] - c0[key]


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


class _Timeline:
    """Reads the program's counters at the window's edges.  In a traced
    run the 1 ms ticker runs on the server's loop, and the profiler covers
    the window's last ``trace_s`` seconds and stops after the window, so
    that its stop (seconds, for a few hundred thousand operations) falls
    outside it; the counters are read where it starts too (``s0``), and
    the host's metrics take the unprofiled part (``w0`` to ``s0``).  It
    runs on the main thread, which the profiler wants."""

    def __init__(self, sysm, w0, w1, sub, server_loop):
        self.sysm, self.w0, self.w1, self.sub = sysm, w0, w1, sub
        self.loop = server_loop
        self.counters: Dict[str, Dict] = {}
        self.lags = None
        self.trace = None
        self.error = None

    @staticmethod
    def _until(t: float) -> None:
        d = t - time.monotonic()
        if d > 0:
            time.sleep(d)

    def run(self) -> None:
        try:
            self._until(self.w0)
            self.counters["w0"] = self.sysm.counters()
            if not self.sub:
                self._until(self.w1)
                self.counters["w1"] = self.sysm.counters()
                return
            lag = system.LoopLag(self.loop)
            self._until(self.sub[0])
            self.lags = lag.stop()
            self.counters["s0"] = self.sysm.counters()
            # a stack dump if the profiler ever sticks
            faulthandler.dump_traceback_later(240, exit=False)
            sw = profile.SubWindow()
            with self.sysm.quiet():
                sw.start()
            sw.t0 = time.monotonic()
            self._until(self.sub[1])
            self.counters["s1"] = self.sysm.counters()
            t1 = time.monotonic()
            with self.sysm.quiet():
                sw.stop(at=t1)
            faulthandler.cancel_dump_traceback_later()
            _log(f"[trace] profiler stopped in "
                 f"{time.monotonic() - t1:.3f} s")
            self.trace = sw
        except Exception as e:  # noqa: BLE001 — reported by the harness
            self.error = e


def _until_eos(blocks, eos_id: int = 0) -> List[int]:
    """A request's LLM tokens in order, through the first eos."""
    out: List[int] = []
    for _, toks in blocks:
        for t in toks:
            out.append(t)
            if t == eos_id:
                return out
    return out


def _llm_blocks(taps, sysm, t0: float, t1: float) -> List[tuple]:
    """(tokens, first position, prompt tokens prefilled) of every LLM
    block fetched in [t0, t1); a request's first block carries its
    prefill of the prompt past the cached system prefix."""
    if sysm.llm_tree is None:
        return []
    system = sysm.scfg.system_prompt
    prefix = len(ref_text.byte_prompt(system, "")) - 1 \
        if sysm.scfg.llm_prefix_cache else 0
    out = []
    for text, blocks in list(taps.llm.items()):
        p = len(ref_text.byte_prompt(system, text))
        pos = p
        for k, (t, toks) in enumerate(blocks):
            if t0 <= t < t1:
                out.append((len(toks), pos, p - prefix if k == 0 else 0))
            pos += len(toks)
    return out


def _sample(done: List[Dict], k: int, seed: int) -> List[Dict]:
    """``k`` finished requests drawn from the seed, and the longest."""
    if not done:
        return []
    rng = np.random.default_rng(seed ^ 0x5EED)
    longest = max(done, key=lambda r: len(r["body"]["text"]))
    rest = [r for r in done if r is not longest]
    pick = [rest[i] for i in sorted(rng.choice(len(rest), size=min(
        k, len(rest)), replace=False))] if rest else []
    return [longest] + pick


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", chips: int = 1,
             bench: Optional[Bench] = None, control: bool = False,
             t_proc: Optional[float] = None) -> Dict:
    """The result line's object (and, with ``control``, the control's
    readings under ``checks``)."""
    t_proc = time.monotonic() if t_proc is None else t_proc
    bench = bench or Bench()
    wl = bench.workload(cell)
    config = bench.config(wl["config"])
    mix = bench.mix(wl["traffic"])
    laps: Dict[str, float] = {}
    laps["process start and imports"] = time.monotonic() - t_proc
    if device == "cuda":
        _log(f"[card] {card_line()}; torch {torch.__version__} cuda "
             f"{torch.version.cuda}; {torch.cuda.device_count()} visible")
        from llmvox_tpu_torch.ops import build
        t = time.monotonic()
        built = build.build_all()
        laps["kernel build"] = time.monotonic() - t
        _log(f"[setup] kernels compiled: {sorted(built) or 'none (cached)'}")
        torch.cuda.reset_peak_memory_stats()

    sysm = system.System(config, wl, seed, device, laps)
    if trace:
        t = time.monotonic()
        profile.SubWindow.warm()
        laps["profiler set-up"] = time.monotonic() - t
    taps = system.Taps(spans=trace)
    taps.install()
    server = system.ServerThread(sysm.server, sysm.port)
    t = time.monotonic()
    server.start()
    laps["server start"] = time.monotonic() - t

    ramp, drain = float(wl["ramp_s"]), float(wl["drain_s"])
    reqs = generate.requests(mix, seed, ramp + seconds, rate=wl.get("rate"))
    by_id = {r["id"]: r for r in reqs}
    t = time.monotonic()
    start = time.monotonic() + 0.5
    w0 = start + ramp
    w1 = w0 + seconds
    deadline = w1 + drain
    load = LoadProcess(sysm.port, mix["endpoint"], reqs, start, w1, deadline)
    laps["load generator start"] = time.monotonic() - t
    setup_s = start - t_proc
    sub = None
    if trace:
        span = min(float(wl["trace_s"]), seconds / 2)
        sub = (w1 - span, w1)
    timeline = _Timeline(sysm, w0, w1, sub, server.loop)
    _log("[setup] " + ", ".join(f"{k} {v:.3f} s" for k, v in laps.items())
         + f"; setup_s {setup_s:.3f} s; CUDA graphs captured at warmup "
         f"{sysm.captured}")
    try:
        timeline.run()
        if timeline.error is not None:
            raise timeline.error
        out = load.records()
        peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                else 0)
        server.stop()
        taps.uninstall()
        records = {r["id"]: r for r in out["records"]}
        sent = [r for r in records.values() if w0 <= r["sent"] < w1]
        errored = [r for r in sent if not r["ok"]
                   and not (r["error"] or "").startswith("late")]
        done = [dict(by_id[r["id"]], rec=r) for r in sent if r["ok"]]
        sample = _sample(done, int(wl["check"]["sample"]), seed)
        pcm = load.pcm([r["id"] for r in sample])
    finally:
        load.close()
        taps.uninstall()

    counters = timeline.counters
    last = counters.get("w1") or counters["s1"]
    in_window = last["captures"] - counters["w0"]["captures"]
    lateness = out.get("lateness_ms") or []
    _log(f"[window] {seconds} s after a {ramp} s ramp: {len(sent)} requests "
         f"sent, {sum(r['ok'] for r in sent)} finished, {len(errored)} "
         f"errored; CUDA graphs captured inside the window {in_window}; "
         + (f"generator lateness median {np.median(lateness):.3f} ms, max "
            f"{max(lateness):.3f} ms" if lateness else "closed loop"))
    if in_window:
        raise RuntimeError(f"{in_window} CUDA graphs were captured inside "
                           "the measured window")
    trace_red = None
    if timeline.trace is not None:
        t = time.monotonic()
        trace_red = timeline.trace.reduce(taps.spans)
        timeline.trace = None
        _log(f"[trace] reduced in {time.monotonic() - t:.1f} s")

    # the program's state goes before the reference runs
    tts = sysm.tts
    sysm.close()
    server = None
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    hop, sr = sysm.ccfg.hop_length, sysm.ccfg.sample_rate
    eos = sysm.scfg.eos_token
    judged, llm_judged = [], []
    for r in sample:
        text = r["body"]["text"]
        served = {rep: [s for s in sents if s]
                  for rep, sents in taps.served.get(text, {}).items()}
        deltas = (text.split(" ") + [eos] if sysm.text == "instant"
                  else taps.deltas.get(text, []))
        judged.append({
            "deltas": deltas, "served": served,
            "chunk_sizes": [n // 4 // hop for _, n in r["rec"]["chunks"]],
            "pcm": np.frombuffer(base64.b64decode(pcm[str(r["id"])]),
                                 "<f4").copy()})
        if sysm.llm_tree is not None:
            llm_judged.append({
                "prompt": ref_text.byte_prompt(sysm.scfg.system_prompt,
                                               text),
                "tokens": _until_eos(taps.llm.get(text, [])),
                "deltas": deltas})
    t = time.monotonic()
    readings = check.judge(tts, judged, control=control)
    if llm_judged:
        readings.update(check.judge_llm(
            {"params": sysm.llm_tree, "cfg": sysm.lcfg, "eos": eos},
            llm_judged, control=control))
    limits = wl["check"]["limits"]
    checks = {k: [readings[k], lim] for k, lim in limits.items()}
    checks.update(schedule_mismatch=[readings["schedule_mismatch"], 0],
                  errored_requests=[len(errored), 0])
    if llm_judged:
        checks["text_mismatch"] = [readings["text_mismatch"], 0]
    correct = (bool(sample) and readings["tokens"] > 0
               and all(v <= lim for v, lim in checks.values()))
    _log(f"[check] {len(sample)} requests, {readings['tokens']} served "
         f"tokens, {readings['chunks']} chunks"
         + (f", {readings['llm_tokens']} LLM tokens" if llm_judged else "")
         + f", in {time.monotonic() - t:.1f} s")
    for why in readings["why"]:
        _log(f"[check] mismatch: {why}")
    if llm_judged:
        _log(f"[check] LLM: {readings['llm_tokens']} served tokens, the "
             f"widest {readings['llm_gap']} below the reference's best "
             f"(not compared: see llm_miss_share)")
    if control:
        # the control judged by the same rule, on the numbers it stands in
        # for: it has to come out as not correct
        for k, lim in limits.items():
            checks["control_" + k] = [readings["control_" + k], lim]
        control_correct = bool(sample) and all(
            readings["control_" + k] <= lim for k, lim in limits.items())
        _log(f"[check] the control reads correct: {control_correct}")

    # a traced run's host metrics read the window up to the profiled part
    h1 = sub[0] if sub else w1
    if sub:
        counters = dict(counters, w1=counters["s0"])
    run = Run(
        cell=wl, config=config, mix=mix, seconds=h1 - w0, setup_s=setup_s,
        window=(w0, h1), sub=sub, counters=counters, trace=trace_red,
        lags=timeline.lags, dcfg=sysm.dcfg, ccfg=sysm.ccfg, scfg=sysm.scfg,
        sent=[dict(r, audio_s=sum(n for _, n in r["chunks"]) / 4 / sr)
              for r in sent],
        deadline=deadline,
        chunks=[(t_, n // 4 // hop) for r in records.values()
                for t_, n in r["chunks"]],
        blocks_window=taps.tokens_between(w0, h1),
        llm_window=_llm_blocks(taps, sysm, w0, h1),
        lcfg=getattr(sysm, "lcfg", None),
        blocks_sub=taps.tokens_between(*sub) if sub else [])
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench.metrics_for(cell, kind):
        value = bench.metric(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else device),
           "count": chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": len(sent),
              "failed": sum(not r["ok"] for r in sent), "metrics": metrics,
              "device": dev}
    if trace_red is not None:
        dev["busy_s"] = trace_red["busy_s"]
        dev["window_s"] = trace_red["window_s"]
        result["breakdown"] = {"device_ops": trace_red["device_ops"],
                               "idle_gaps": trace_red["idle_gaps"]}
        _log(f"[trace] {trace_red['n_ops']} device operations in "
             f"{trace_red['window_s']:.3f} s, busy {trace_red['busy_s']:.4f}"
             f" s")
    for k, v in metrics.items():
        _log(f"[metric] {k} {v['value']} {v['unit']}")
    for name, (v, lim) in checks.items():
        _log(f"[check] {name} {v} (limit {lim})")
    if control:
        result["control_correct"] = control_correct
        result["readings"] = {k: v for k, v in readings.items()
                              if k not in ("why",)}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result
