"""CLI: codec copy-synthesis, wav files encoded to codes and decoded back.

The port's ``python -m llmvox_tpu.tools.copy_synthesis`` (the codec's
manual quality check): each input is resampled to the codec's rate,
encoded (``WavCodec.encode_infer``) and decoded at its own length
(``decode_codes_eager``: the serving buckets are not captured here) on
``--device`` (default ``cuda``), and saved as PCM16
``<name>_recon.wav``:

    python -m llmvox_tpu_torch.tools.copy_synthesis \\
        --codec_params out/codec.npz --inputs a.wav b.wav --out_dir recon/
"""
from __future__ import annotations

import argparse
import os

from llmvox_tpu_torch.codec.codec import WavCodec
from llmvox_tpu_torch.utils.audio import convert_audio, read_wav, write_wav


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--codec_params", required=True)
    parser.add_argument("--inputs", nargs="+", required=True)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    codec = WavCodec.from_pretrained(args.codec_params, device=args.device,
                                     graphs=False)
    os.makedirs(args.out_dir, exist_ok=True)
    for path in args.inputs:
        wav, sr = read_wav(path)
        wav = convert_audio(wav, sr, codec.cfg.sample_rate, 1)
        _, codes = codec.encode_infer(wav)
        recon = codec.decode_codes_eager(codes)
        out = os.path.join(args.out_dir,
                           os.path.basename(path).replace(".wav", "_recon.wav"))
        write_wav(out, recon[0], codec.cfg.sample_rate)
        print(f"{path} -> {out} ({recon.shape[1] / codec.cfg.sample_rate:.2f}s)")


if __name__ == "__main__":
    main()
