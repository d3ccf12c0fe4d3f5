"""The audio chunks of a request, from the speech tokens of its sentences
(the server's documented chunking, streaming_server.py:347-422): each
replica keeps a dump size that starts at its initial size and grows by
``dump_growth_factor`` (capped at ``max_dump_size``) after every chunk
and at every sentence's end.  Tokens gather in a buffer; a full dump is
vocoded; EOA flushes the buffer, and EOA or a buffer past
``max_audio_length`` ends the sentence, the rest of the buffer dropped.
EOA is never vocoded.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple


def _grow(d: int, scfg) -> int:
    return min(d * scfg.dump_growth_factor, scfg.max_dump_size) \
        if d < scfg.max_dump_size else d


def sentence_chunks(tokens: Sequence[int], dump: int, scfg, eoa: int
                    ) -> Tuple[List[List[int]], int, int]:
    """(chunks of codes, the dump size after the sentence, the tokens the
    sentence used) for one sentence's tokens in order."""
    out, buf, used = [], [], 0
    for tok in tokens:
        used += 1
        buf.append(tok)
        if len(buf) >= dump:
            chunk, buf = buf[:dump], buf[dump:]
            out.append([c for c in chunk if c != eoa])
            dump = _grow(dump, scfg)
        elif eoa in buf:
            out.append([c for c in buf if c != eoa])
            buf = []
            dump = _grow(dump, scfg)
        if tok == eoa or len(buf) > scfg.max_audio_length:
            break
    return [c for c in out if c], _grow(dump, scfg), used


def request_chunks(sentences: Sequence[Tuple[int, Sequence[int]]], scfg,
                   eoa: int) -> List[List[int]]:
    """Every chunk of a request in play order; ``sentences`` is (replica,
    tokens) in the mux's order."""
    dumps = [scfg.initial_dump_size_1, scfg.initial_dump_size_2]
    out: List[List[int]] = []
    for r, toks in sentences:
        chunks, dumps[r], _ = sentence_chunks(toks, dumps[r], scfg, eoa)
        out.extend(chunks)
    return out
