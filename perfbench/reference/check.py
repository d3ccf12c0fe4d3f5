"""The comparison that decides ``correct``, and its control.

For each sampled request the reference works out again what each sentence
fed the speech decoder (``text.py``), runs the decoder teacher-forced on
the tokens the program served, and reads the widest gap by which a served
token's logit lies below the reference's best (``token_gap``).  It cuts
the served tokens into the chunks the server must have vocoded
(``schedule.py``), checks their sizes against the chunks the client
received (``schedule_mismatch``, exact), decodes each chunk with the
reference codec and reads the largest difference from the received PCM
as a share of the request's peak (``audio_err``).

The control (``control=True``) is the reference put in the program's
place one precision step down: the speech decoder, served in bfloat16,
with its matmul weights rounded through float8 e4m3 (a scale per output
channel); the codec, served in float32 with TF32 off, with TF32 on.  Its
readings are the gap of the token that the float8 decoder puts first, and
the TF32 codec's difference from the float32 one, on the same sentences
and chunks.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from perfbench.reference import codec as ref_codec
from perfbench.reference import decoder as ref_decoder
from perfbench.reference import schedule, text


def fp8_weight(w: torch.Tensor) -> torch.Tensor:
    """``w`` (Cin, Cout) rounded through float8 e4m3, a scale a column."""
    s = w.abs().amax(dim=0, keepdim=True).clamp_min(1e-12) / 448.0
    return (w / s).to(torch.float8_e4m3fn).float() * s


@contextlib.contextmanager
def tf32(on: bool):
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def _worst(old: float, new: float) -> float:
    """The larger reading; a non-finite one reads as 1e30."""
    return max(old, new if math.isfinite(new) else 1e30)


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.float()


@torch.no_grad()
def judge(tts: Dict, requests: Sequence[Dict], control: bool = False
          ) -> Dict[str, float]:
    """``tts``: {"decoder", "text_table", "codec" (trees), "dcfg", "ccfg",
    "scfg", "eos"}; each request: {"deltas", "served" {replica: [tokens of
    each sentence]}, "chunk_sizes", "pcm" (float32 array)}.  Returns the
    readings (and the control's, as ``control_*``)."""
    dcfg, ccfg, scfg = tts["dcfg"], tts["ccfg"], tts["scfg"]
    dec, table = tts["decoder"], tts["text_table"]
    ctree = _f32(tts["codec"])
    codebook = ctree["codebooks"][0]
    eoa = tts["eoa"]
    out = {"token_gap": 0.0, "audio_err": 0.0, "schedule_mismatch": 0,
           "tokens": 0, "chunks": 0, "why": []}

    def mismatch(what: str) -> None:
        out["schedule_mismatch"] += 1
        if len(out["why"]) < 8:
            out["why"].append(what)

    if control:
        out.update(control_token_gap=0.0, control_audio_err=0.0)
    with tf32(False):
        for req in requests:
            sents = text.sentences(req["deltas"], tts["eos"],
                                   dcfg.text_eos_id)
            used = {0: 0, 1: 0}
            played: List = []
            for r, ids in sents:
                if len(ids) > scfg.max_audio_length:
                    # the length cap could end the sentence while its text
                    # still arrives; this reference does not follow that
                    mismatch(f"a sentence of {len(ids)} text ids passes "
                             f"max_audio_length {scfg.max_audio_length}")
                got = req["served"].get(r, [])
                if used[r] >= len(got):
                    mismatch(f"replica {r} served {len(got)} sentences, "
                             f"the text makes more")
                    continue
                toks = got[used[r]]
                used[r] += 1
                if not toks or min(toks) < 0 or max(toks) >= dcfg.vocab_size:
                    mismatch(f"replica {r}: tokens out of range or none")
                    continue
                lg = ref_decoder.logits(dec, table, codebook, dcfg, ids,
                                        toks)
                best = lg.max(-1).values
                idx = torch.as_tensor(toks, device=lg.device)[:, None]
                gap = (best - lg.gather(1, idx)[:, 0]).max().item()
                out["token_gap"] = _worst(out["token_gap"], gap)
                out["tokens"] += len(toks)
                if control:
                    lc = ref_decoder.logits(dec, table, codebook, dcfg, ids,
                                            toks, weight_fn=fp8_weight)
                    pick = lc.argmax(-1)[:, None]
                    cgap = (best - lg.gather(1, pick)[:, 0]).max().item()
                    out["control_token_gap"] = _worst(
                        out["control_token_gap"], cgap)
                played.append((r, toks))
            for r in (0, 1):
                if used[r] != len(req["served"].get(r, [])):
                    mismatch(f"replica {r} served "
                             f"{len(req['served'].get(r, []))} sentences, "
                             f"the text makes {used[r]}")
            chunks = schedule.request_chunks(played, scfg, eoa)
            hop = ccfg.hop_length
            sizes = [len(c) for c in chunks]
            if sizes != list(req["chunk_sizes"]):
                mismatch(f"chunks {req['chunk_sizes']} received, {sizes} "
                         f"from the served tokens")
                continue
            pcm = torch.tensor(np.asarray(req["pcm"], np.float32))
            if pcm.numel() != sum(sizes) * hop:
                mismatch(f"{pcm.numel()} samples received, "
                         f"{sum(sizes) * hop} due")
                continue
            pcm = pcm.to(codebook.device)
            ref = torch.cat([ref_codec.decode(ctree, ccfg, c)
                             for c in chunks]) if chunks else pcm[:0]
            out["chunks"] += len(chunks)
            if not len(ref):
                continue
            peak = ref.abs().max().clamp_min(1e-12)
            out["audio_err"] = _worst(out["audio_err"], (
                (pcm - ref).abs().max() / peak).item())
            if control:
                with tf32(True):
                    low = torch.cat([ref_codec.decode(ctree, ccfg, c)
                                     for c in chunks])
                out["control_audio_err"] = _worst(out["control_audio_err"], (
                    (low - ref).abs().max() / peak).item())
    return out


# a served LLM token this far below the reference's best logit is a miss
LLM_MISS = 0.5


@torch.no_grad()
def judge_llm(llm: Dict, requests: Sequence[Dict], control: bool = False
              ) -> Dict[str, float]:
    """``llm``: {"params", "cfg", "eos"}; each request: {"prompt" (ids),
    "tokens" (the served ids), "deltas" (the text the stream gave)}.

    ``llm_miss_share``: the share of served tokens whose logit lies more
    than ``LLM_MISS`` below the reference's best, over every request.
    (The largest such share of one request is not compared: the float8
    control reads it at only about twice the program.)  The widest such
    gap
    (``llm_gap``) is kept for the record and not compared: a bfloat16
    forward through the experts drifts from the float32 one far enough to
    change a token's top-2 expert set at some layer now and then, and
    that moves its logits by whole units, on a few per cent of tokens of
    every seed.  ``text_mismatch``: streams whose text is not what their
    tokens spell."""
    from perfbench.reference import mixtral
    out = {"llm_gap": 0.0, "llm_tokens": 0, "llm_miss_share": 0.0,
           "text_mismatch": 0}
    if control:
        out["control_llm_miss_share"] = 0.0
    seqs, ats, served = [], [], []
    for req in requests:
        toks, prompt = list(req["tokens"]), list(req["prompt"])
        said = "".join(d for d in req["deltas"] if d != llm["eos"])
        if said != text.byte_text(toks):
            out["text_mismatch"] += 1
        if toks:
            seqs.append(prompt + toks[:-1])
            ats.append(range(len(prompt) - 1, len(prompt) + len(toks) - 1))
            served.append(toks)
    if not served:
        return out
    with tf32(False):
        ref = mixtral.logits(llm["params"], llm["cfg"], seqs, ats)
        low = (mixtral.logits(llm["params"], llm["cfg"], seqs, ats,
                              weight_fn=fp8_weight) if control else None)
    misses = {"": 0, "control_": 0}

    if control:
        # every served token's gap, for the record of the control's run
        out.update(llm_gaps=[], control_llm_gaps=[])

    def count(prefix: str, gaps: torch.Tensor) -> None:
        if control:
            out[prefix + "llm_gaps"].append(
                [round(g, 4) for g in gaps.tolist()])
        misses[prefix] += int((~(gaps <= LLM_MISS)).sum().item())

    for j, (lg, toks) in enumerate(zip(ref, served)):
        best = lg.max(-1).values
        idx = torch.as_tensor(toks, device=lg.device)[:, None]
        gaps = best - lg.gather(1, idx)[:, 0]
        out["llm_gap"] = _worst(out["llm_gap"], gaps.max().item())
        out["llm_tokens"] += len(toks)
        count("", gaps)
        if low is not None:
            pick = low[j].argmax(-1)[:, None]
            count("control_", best - lg.gather(1, pick)[:, 0])
    out["llm_miss_share"] = misses[""] / out["llm_tokens"]
    if control:
        out["control_llm_miss_share"] = (misses["control_"]
                                         / out["llm_tokens"])
    return out
