"""Text normalization for TTS.

Behavior-compatible rebuild of the reference ``clean_text``
(streaming_server.py:106-149): strips markdown emphasis, spells out
symbols (#, &, @, /, \\), removes periods after bare numbers and commas
inside numbers, collapses whitespace, and turns long ellipses into a
spoken "pause".
"""
from __future__ import annotations

import re

_NUM_DOT = re.compile(r"(\d)\.(?=\s|$)")
_ASTERISK = re.compile(r"\*")
_HASH = re.compile(r"#")
_AMP = re.compile(r"&")
_AT = re.compile(r"@")
_SPACES = re.compile(r"\s+")
_ELLIPSIS = re.compile(r"\.{3,}")
_NUM_COMMA = re.compile(r"(\d),(\d)")
_SLASHES = re.compile(r"\/+")
_BACKSLASHES = re.compile(r"\\+")


def clean_text(text: str, eos_token: str = "<|eot_id|>") -> str:
    text = text.strip()
    text = text.replace("**", "")
    text = text.replace("-", " ")
    text = _NUM_DOT.sub(r"\1", text)
    text = _ASTERISK.sub("", text)
    text = _HASH.sub(" number ", text)
    text = _AMP.sub(" and ", text)
    text = _AT.sub(" at ", text)
    text = _SPACES.sub(" ", text)
    text = _ELLIPSIS.sub(" pause ", text)
    text = _NUM_COMMA.sub(r"\1\2", text)
    text = _SLASHES.sub(" slash ", text)
    text = _BACKSLASHES.sub(" backslash ", text)
    return text
