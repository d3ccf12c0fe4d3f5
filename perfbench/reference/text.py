"""What the speech decoder of each sentence is fed, worked out again from
the text deltas a request's text stream produced.

The server's documented behaviour (the reference LLMVoX server,
streaming_server.py:184-426, as the port's ``serve/scheduler.py``
describes it): each delta is stripped and cleaned and goes to the active
replica's queue; a delta ending in "." flips the active replica.  A
replica's sentence is every delta it takes until one ends in "." or holds
the eos token (which is removed), each delta byte-tokenized with its own
``</s>`` (ByT5: byte + 3, then 1), and the speech-text EOS (385) after the
last.  The mux plays the replicas' sentences in turn.  ``clean_text`` is a
frozen copy of the server's normalisation (streaming_server.py:106-149).
"""
from __future__ import annotations

import re
from typing import List, Sequence, Tuple

BYTE_OFFSET = 3
EOS_ID = 1

_NUM_DOT = re.compile(r"(\d)\.(?=\s|$)")
_SPACES = re.compile(r"\s+")
_ELLIPSIS = re.compile(r"\.{3,}")
_NUM_COMMA = re.compile(r"(\d),(\d)")
_SLASHES = re.compile(r"\/+")
_BACKSLASHES = re.compile(r"\\+")


def clean_text(text: str) -> str:
    text = text.strip().replace("**", "").replace("-", " ")
    text = _NUM_DOT.sub(r"\1", text)
    text = text.replace("*", "").replace("#", " number ")
    text = text.replace("&", " and ").replace("@", " at ")
    text = _SPACES.sub(" ", text)
    text = _ELLIPSIS.sub(" pause ", text)
    text = _NUM_COMMA.sub(r"\1\2", text)
    text = _SLASHES.sub(" slash ", text)
    return _BACKSLASHES.sub(" backslash ", text)


def byt5(text: str) -> List[int]:
    return [b + BYTE_OFFSET for b in text.encode("utf-8")] + [EOS_ID]


def sentences(deltas: Sequence[str], eos: str, text_eos: int
              ) -> List[Tuple[int, List[int]]]:
    """(replica, text ids) of every sentence, in the order the mux plays
    them."""
    queues: List[List[str]] = [[], []]
    active = 0
    for out in deltas:
        if out in ("", "-"):
            continue
        out = out.strip()
        if out != eos:
            out = clean_text(out)
        if not out:
            continue
        queues[active].append(out)
        if out.endswith("."):
            active = 1 - active
    per: List[List[List[int]]] = [[], []]
    for r, q in enumerate(queues):
        cur: List[int] = []
        ended = False
        for delta in q:
            done = False
            if eos in delta:
                ended = done = True
                delta = delta.replace(eos, "")
            elif delta.endswith("."):
                done = True
            cur.extend(byt5(delta.strip()))
            if done:
                per[r].append(cur + [text_eos])
                cur = []
            if ended:
                break
        if cur and not ended:
            # the stream closed mid-sentence
            per[r].append(cur + [text_eos])
    order = []
    for j in range(max(len(per[0]), len(per[1])) * 2):
        r, i = j % 2, j // 2
        if i < len(per[r]):
            order.append((r, per[r][i]))
        else:
            break
    return order


def byte_prompt(system: str, prompt: str) -> List[int]:
    """The LLM's prompt ids under the byte tokenizer (id = byte + 1) for a
    tokenizer without a chat template: "system\\n\\nuser\\n"."""
    text = (system + "\n\n" if system else "") + prompt + "\n"
    return [b + 1 for b in text.encode("utf-8")]


def byte_text(ids: Sequence[int]) -> str:
    """What the byte tokenizer's ids spell (eos and ids past a byte
    dropped)."""
    return bytes(i - 1 for i in ids if 0 < i <= 256).decode("utf-8",
                                                            errors="ignore")
