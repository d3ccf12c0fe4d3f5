"""Golden parity of the port against the reference's own torch code, on
real checkpoints.

The port's counterpart of ``llmvox_tpu/tools/validate_parity.py``: it
converts the reference checkpoints with ``tools/convert.py``, imports
the reference's torch implementation from ``--reference`` (its checkout,
never vendored), runs both on the same inputs and reports the largest
absolute difference of each:

- decoder: the GPT's full-sequence logits on a random L2-normalised
  embedding sequence (``models/decoder.py::apply_decoder`` against the
  reference's ``src/model.py`` GPT);
- codec: codes to waveform on random ids (``WavCodec.decode_codes_eager``
  at the exact length against the reference WavTokenizer's ``decode``).

    python -m llmvox_tpu_torch.tools.validate_parity \\
        --reference /path/to/LLMVoX \\
        --decoder_ckpt CHECKPOINTS/ckpt_english_tiny.pt \\
        --codec_ckpt CHECKPOINTS/wavtokenizer_large_speech_320_24k.ckpt

Each section is skipped with a notice when its inputs are missing (a
checkpoint, or the reference checkout), so the script runs anywhere; it
exits 1 when a section that ran is off its tolerance.  ``--device``
(default ``cpu``) runs the port's side there.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _report(name: str, ours: np.ndarray, ref: np.ndarray,
            tol: float) -> bool:
    d = float(np.max(np.abs(ours.astype(np.float64)
                            - ref.astype(np.float64))))
    ok = d <= tol
    print(f"{name}: max |delta| = {d:.3e} "
          f"({'OK' if ok else f'FAIL (tol {tol:g})'})")
    return ok


def validate_decoder(reference: str, ckpt: str, tol: float = 2e-3,
                     device: str = "cpu") -> bool:
    import torch
    from llmvox_tpu_torch.models import decoder as dec
    from llmvox_tpu_torch.tools.convert import convert_decoder_ckpt
    from llmvox_tpu_torch.utils.config import DecoderConfig
    from llmvox_tpu_torch.utils.params import to_torch

    params, args = convert_decoder_ckpt(ckpt)
    cfg = DecoderConfig(n_layer=args["n_layer"], n_head=args["n_head"],
                        n_embd=args["n_embd"], block_size=args["block_size"],
                        bias=args.get("bias", False),
                        vocab_size=args.get("vocab_size", 4096))

    sys.path.insert(0, reference)
    from src.model import GPT, GPTConfig  # the reference implementation
    blob = torch.load(ckpt, map_location="cpu", weights_only=False)
    margs = dict(blob["model_args"])
    # is_train=True makes the reference's SDPA causal, as a full-sequence
    # logit comparison needs
    margs["is_train"] = True
    model = GPT(GPTConfig(**{k: v for k, v in margs.items()
                             if k in GPTConfig.__dataclass_fields__}))
    sd = {k.replace("_orig_mod.", ""): v for k, v in blob["model"].items()}
    model.load_state_dict(sd, strict=False)
    model.eval()

    rng = np.random.default_rng(0)
    t = 16
    emb = rng.standard_normal((1, t, cfg.n_embd)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)

    with torch.no_grad():
        ours = dec.apply_decoder(
            to_torch(params, device, torch.float32),
            torch.from_numpy(emb).to(device), cfg).cpu().numpy()
        # GPT.forward returns (logits, loss, new_kvcache); targets make it
        # emit the logits of every position
        dummy_targets = torch.zeros((1, t), dtype=torch.long)
        ref_logits = model(torch.from_numpy(emb), targets=dummy_targets)[0]
    ref = ref_logits.float().numpy()
    if ref.shape[1] == 1:  # inference mode returns the last position only
        ours = ours[:, -1:]
    return _report("decoder logits", ours, ref, tol)


def _stub_torchaudio() -> None:
    """The reference codec imports torchaudio, which its decode path never
    calls: where it is not installed, stub modules satisfy the imports
    (HTK mel converters included)."""
    import types
    try:
        import torchaudio  # noqa: F401
        return
    except ImportError:
        pass
    ta = types.ModuleType("torchaudio")
    ta.__path__ = []
    tr = types.ModuleType("torchaudio.transforms")
    tr.MelSpectrogram = None
    fn = types.ModuleType("torchaudio.functional")
    fn.__path__ = []
    fnf = types.ModuleType("torchaudio.functional.functional")
    fnf._hz_to_mel = lambda f, mel_scale="htk": 2595.0 * np.log10(
        1.0 + f / 700.0)
    fnf._mel_to_hz = lambda m, mel_scale="htk": 700.0 * (
        10.0 ** (m / 2595.0) - 1.0)
    ta.transforms, ta.functional, fn.functional = tr, fn, fnf
    for name, mod in (("torchaudio", ta), ("torchaudio.transforms", tr),
                      ("torchaudio.functional", fn),
                      ("torchaudio.functional.functional", fnf)):
        sys.modules.setdefault(name, mod)


def validate_codec(reference: str, ckpt: str, config_yaml: str = "",
                   tol: float = 5e-3, device: str = "cpu") -> bool:
    import torch
    _stub_torchaudio()
    from llmvox_tpu_torch.codec.codec import WavCodec
    from llmvox_tpu_torch.tools.convert import convert_wavtokenizer_ckpt
    from llmvox_tpu_torch.utils.config import CodecConfig

    params = convert_wavtokenizer_ckpt(ckpt, with_encoder=False)
    codec = WavCodec(params, CodecConfig(), buckets=(32,), device=device)

    sys.path.insert(0, os.path.join(reference, "WavTokenizer"))
    from decoder.pretrained import WavTokenizer  # the reference
    if not config_yaml:
        folder = os.path.join(reference, "WavTokenizer", "configs")
        config_yaml = [os.path.join(folder, f) for f in os.listdir(folder)
                       if "frame75" in f or "320" in f][0]
    ref_model = WavTokenizer.from_pretrained0802(config_yaml, ckpt)
    ref_model.eval()

    rng = np.random.default_rng(1)
    codes = rng.integers(0, 4096, (1, 32)).astype(np.int64)
    ours = codec.decode_codes_eager(codes.astype(np.int32))
    with torch.no_grad():
        feats = ref_model.codes_to_features(torch.from_numpy(codes))
        ref = ref_model.decode(
            feats, bandwidth_id=torch.tensor([0])).float().numpy()
    n = min(ours.shape[-1], ref.shape[-1])
    return _report("codec waveform", ours[..., :n], ref[..., :n], tol)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reference", default="",
                    help="the reference LLMVoX checkout")
    ap.add_argument("--decoder_ckpt", default="")
    ap.add_argument("--codec_ckpt", default="")
    ap.add_argument("--codec_config", default="")
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)

    have_ref = bool(args.reference) and os.path.isdir(args.reference)
    ok = True
    for name, ckpt, run in (
            ("decoder", args.decoder_ckpt, lambda: validate_decoder(
                args.reference, args.decoder_ckpt, device=args.device)),
            ("codec", args.codec_ckpt, lambda: validate_codec(
                args.reference, args.codec_ckpt, args.codec_config,
                device=args.device))):
        if not (ckpt and os.path.exists(ckpt)):
            print(f"{name}: checkpoint not provided/found — skipped")
        elif not have_ref:
            print(f"{name}: reference checkout not provided/found — "
                  "skipped")
        else:
            ok &= run()
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
