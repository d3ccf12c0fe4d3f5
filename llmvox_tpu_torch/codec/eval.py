"""Batch codec evaluation over a decoded test set.

Counterpart of ``llmvox_tpu/codec/eval.py`` (the reference's eval harness,
WavTokenizer/metrics/infer.py:1-115): for every reference wav, find (or
synthesize) its reconstruction, run every metric
(``codec.metrics.evaluate_pair``: mel distance on ``--device``, SI-SNR,
periodicity, pitch and voicing F1, PESQ and STOI always; UTMOS when a
scorer is registered) and report per-file and mean metrics.

Two pairing modes:

  # score pre-decoded files: <recon_dir>/<name>_recon.wav or <name>.wav
  python -m llmvox_tpu_torch.codec.eval --refs filelist.txt --recon_dir recon/

  # copy-synthesize through a codec checkpoint on --device, then score
  python -m llmvox_tpu_torch.codec.eval --refs a.wav b.wav \\
      --codec_params out/codec.npz [--<CodecConfig field> ...]

Copy synthesis encodes each file (``WavCodec.encode_infer``) and decodes
it at its own length (``decode_codes_eager``), as
``tools/copy_synthesis.py`` does; JAX decodes with ``decode_codes(...,
pad_to_bucket=False)``, the same function at the exact length.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from llmvox_tpu_torch.codec.metrics import evaluate_pair
from llmvox_tpu_torch.utils.audio import convert_audio, read_wav, write_wav


def expand_refs(refs: Sequence[str]) -> List[str]:
    """A .txt argument is a filelist (one wav path per line, the reference's
    dataset format, decoder/dataset.py:44); anything else is a wav path."""
    out: List[str] = []
    for r in refs:
        if r.endswith(".txt"):
            with open(r) as f:
                out.extend(ln.strip() for ln in f if ln.strip())
        else:
            out.append(r)
    return out


def find_recon(ref_path: str, recon_dir: str) -> Optional[str]:
    base = os.path.basename(ref_path)
    for cand in (base.replace(".wav", "_recon.wav"), base):
        p = os.path.join(recon_dir, cand)
        if os.path.exists(p):
            return p
    return None


def _load(path: str, sample_rate: int) -> np.ndarray:
    wav, sr = read_wav(path)
    return convert_audio(wav, sr, sample_rate, 1)[0]  # mono (T,)


def evaluate_files(pairs: Sequence[Tuple[str, str]],
                   sample_rate: int = 24000, log=print,
                   device="cuda") -> Dict:
    """Score (recon_path, ref_path) pairs; returns
    {"n", "per_file": [...], "mean": {...}}."""
    per_file = []
    for recon_path, ref_path in pairs:
        y = _load(ref_path, sample_rate)
        y_hat = _load(recon_path, sample_rate)
        t = min(len(y), len(y_hat))
        m = evaluate_pair(y_hat[:t], y[:t], sample_rate, device)
        # non-finite scores serialize as None: json.dumps would otherwise
        # emit bare NaN, which is not strict JSON
        m = {k: (v if not isinstance(v, float) or np.isfinite(v) else None)
             for k, v in m.items()}
        row = {"ref": ref_path, "recon": recon_path, **m}
        per_file.append(row)
        log(json.dumps(row))
    keys = sorted({k for r in per_file for k, v in r.items()
                   if isinstance(v, (int, float)) or v is None})
    # the mean of the finite values: the built-in STOI returns nan for a
    # clip too short after silence removal, and one such file must not
    # poison the aggregate; a column with none reports None
    mean = {}
    for k in keys:
        vals = np.asarray([r[k] for r in per_file
                           if isinstance(r.get(k), (int, float))], np.float64)
        finite = vals[np.isfinite(vals)]
        mean[k] = float(finite.mean()) if finite.size else None
    return {"n": len(per_file), "per_file": per_file, "mean": mean}


def main(argv=None) -> Dict:
    from llmvox_tpu_torch.utils.config import (CodecConfig,
                                               add_dataclass_args,
                                               apply_cli_overrides)
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--refs", nargs="+", required=True,
                        help="reference wavs and/or .txt filelists")
    parser.add_argument("--recon_dir",
                        help="directory of pre-decoded reconstructions")
    parser.add_argument("--codec_params",
                        help="codec checkpoint: copy-synthesize on the fly")
    parser.add_argument("--out_json", help="write the report here")
    parser.add_argument("--device", type=str, default="cuda")
    add_dataclass_args(parser, CodecConfig)
    args = parser.parse_args(argv)
    if (args.recon_dir is None) == (args.codec_params is None):
        parser.error("exactly one of --recon_dir / --codec_params required")

    refs = expand_refs(args.refs)
    cfg = apply_cli_overrides(CodecConfig(), args)

    if args.codec_params:
        from llmvox_tpu_torch.codec.codec import WavCodec
        codec = WavCodec.from_pretrained(args.codec_params, cfg=cfg,
                                         device=args.device, graphs=False)
        recon_dir = tempfile.mkdtemp(prefix="llmvox_eval_")
        print(f"writing reconstructions to {recon_dir}", file=sys.stderr)
        for path in refs:
            wav = _load(path, cfg.sample_rate)
            _, codes = codec.encode_infer(wav[None])  # (B=1, T)
            recon = codec.decode_codes_eager(codes)
            out = os.path.join(
                recon_dir,
                os.path.basename(path).replace(".wav", "_recon.wav"))
            write_wav(out, recon[0], cfg.sample_rate)
        del codec
    else:
        recon_dir = args.recon_dir

    pairs = []
    for path in refs:
        recon = find_recon(path, recon_dir)
        if recon is None:
            print(f"WARNING: no reconstruction for {path}, skipping")
            continue
        pairs.append((recon, path))

    report = evaluate_files(pairs, cfg.sample_rate, device=args.device)
    print(json.dumps({"n": report["n"], "mean": report["mean"]}))
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
