"""The one traffic generator: a mix's parameters and a seed -> requests.

Every seed gets the same sizes and arrivals; the run's seed only orders
them and draws the text, so two seeds load the system alike and differ in
what they say.  A closed loop's replies repeat a period of ``period``
sizes whose sentence counts follow the mix's shares exactly and whose
sentence lengths are spread evenly over the mix's range: each client
cycles through the period from an offset drawn from the seed, so every
stretch of a window sees the same mix.  An open loop's arrival times and
prompt lengths are drawn from the mix's ``shape_seed`` alone (Poisson at
the cell's rate, lognormal lengths), the same for every seed: with a
window's p95 resting on some 30 requests, a seed that put them in an
order of its own changed the tail far more than two runs of one seed
differ.

A request is ``{"id", "client", "due", "body", "sentences"}``: ``client``
is the closed loop's client that sends it (``due`` None: sent when that
client's previous request ends), ``due`` the open loop's send time in
seconds from the start of the traffic (``client`` None).  ``sentences``
holds the reply's sentences where the text is the reply itself.

Text is lower-case pseudo-words, commas and one full stop at the end of
each sentence: the server's ``clean_text`` leaves it as it is, and only a
sentence's last word ends with ``.``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

_CONS = "bcdfghjklmnprstvwz"
_VOWELS = "aeiou"


def _word(rng: np.random.Generator) -> str:
    n = int(rng.integers(1, 4))
    return "".join(_CONS[rng.integers(len(_CONS))]
                   + _VOWELS[rng.integers(len(_VOWELS))]
                   for _ in range(n)) + (
        _CONS[rng.integers(len(_CONS))] if rng.random() < 0.5 else "")


def sentence(rng: np.random.Generator, chars: int) -> str:
    """``chars`` characters of words (at least two), the last ending in
    "."."""
    words: List[str] = []
    length = -1
    while length < chars - 1:
        w = _word(rng)
        if words and rng.random() < 0.1:
            words[-1] += ","
            length += 1
        words.append(w)
        length += len(w) + 1
    text = " ".join(words)[:max(chars, 2) - 1]
    if text[-1] in " ,":
        text = text[:-1] + _VOWELS[rng.integers(len(_VOWELS))]
    return text[0].upper() + text[1:] + "."


def reply_period(mix: Dict) -> List[List[int]]:
    """One period of replies' sentence lengths: ``round(p * period)``
    replies of each sentence count, their sentences' lengths evenly
    spaced over the range and shuffled by the mix's shape seed."""
    rng = np.random.default_rng(mix["shape_seed"])
    r = mix["reply"]
    period = int(r["period"])
    counts = [k for k, p in zip(r["sentences"], r["p"])
              for _ in range(int(round(p * period)))]
    lo, hi = r["chars"]
    n = sum(counts)
    lengths = [int(round(lo + (hi - lo) * (i + 0.5) / n))
               for i in range(n)]
    lengths = [lengths[i] for i in rng.permutation(n)]
    out, at = [], 0
    for k in rng.permutation(counts):
        out.append(lengths[at:at + int(k)])
        at += int(k)
    return out


def _prompt_shapes(mix: Dict, n: int) -> List[int]:
    """``n`` user-text lengths, lognormal about the median, clipped."""
    rng = np.random.default_rng(mix["shape_seed"])
    p = mix["prompt"]
    x = rng.lognormal(math.log(p["median"]), p["sigma"], size=n)
    return [int(v) for v in np.clip(np.rint(x), p["min"], p["max"])]


def requests(mix: Dict, seed: int, seconds: float,
             rate: Optional[float] = None) -> List[Dict]:
    """The requests of one run of ``seconds`` of traffic (enough of them
    that a client or the schedule never runs out)."""
    rng = np.random.default_rng(seed)
    loop = mix["loop"]
    if loop == "closed":
        clients = int(mix["clients"])
        per = int(mix["requests_per_client"])
        n = clients * per
        client = [i % clients for i in range(n)]
        due: List[Optional[float]] = [None] * n
    elif loop == "open":
        if rate is None or rate <= 0:
            raise ValueError("an open loop needs the cell's rate")
        n = int(math.ceil(rate * seconds * 1.25)) + 16
        shape_rng = np.random.default_rng(mix["shape_seed"] + 1)
        gaps = shape_rng.exponential(1.0 / rate, size=n)
        due = [float(t) for t in np.cumsum(gaps)]
        client = [None] * n
    else:
        raise ValueError(f"unknown loop {loop!r}")
    reply = "reply" in mix
    if reply:
        cycle = reply_period(mix)
        offsets = rng.integers(len(cycle), size=int(mix["clients"]))
        shapes = [cycle[(offsets[client[i]] + i // len(offsets))
                        % len(cycle)] for i in range(n)]
        order = range(n)
    else:
        shapes = _prompt_shapes(mix, n)
        order = range(n)
    out, seen = [], set()
    for i in range(n):
        # the text names its request on the server side: draw again on a
        # repeat
        while True:
            if reply:
                sents = [sentence(rng, c) for c in shapes[order[i]]]
                text = " ".join(sents)
            else:
                sents = None
                text = sentence(rng, shapes[order[i]])[:-1] + "?"
            if text not in seen:
                break
        seen.add(text)
        out.append({"id": i, "client": client[i], "due": due[i],
                    "body": {"text": text}, "sentences": sents})
    return out
