"""CLI: offline dataset preparation, every training wav encoded to codes.

The port's ``python -m llmvox_tpu.tools.prepare_data``: for each item of
a reference-format manifest (``[{"id": ..., "answer_text": ...}, ...]``
with ``{id}.wav`` files) the audio is resampled to the codec's rate and
encoded (``WavCodec.encode_infer`` on ``--device``, default ``cuda``), the
natural EOA code stripped, the text tokenized per word (ByT5), and the
samples saved for ``train/data.py``:

    python -m llmvox_tpu_torch.tools.prepare_data \\
        --data_path train_data.json --speech_data_folder audios \\
        --codec_params out/codec.npz --out out/train_prepared.npz
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from llmvox_tpu_torch.codec.codec import WavCodec
from llmvox_tpu_torch.text.byt5 import ByT5Tokenizer
from llmvox_tpu_torch.train.data import Sample, save_prepared
from llmvox_tpu_torch.utils.audio import convert_audio, read_wav


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_path", required=True)
    parser.add_argument("--speech_data_folder", required=True)
    parser.add_argument("--codec_params", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--eoa_token_id", type=int, default=453)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    codec = WavCodec.from_pretrained(args.codec_params, device=args.device,
                                     graphs=False)
    tok = ByT5Tokenizer()
    with open(args.data_path) as f:
        items = json.load(f)
    samples = []
    for i, item in enumerate(items):
        path = os.path.join(args.speech_data_folder, f"{item['id']}.wav")
        wav, sr = read_wav(path)
        wav = convert_audio(wav, sr, codec.cfg.sample_rate, 1)
        _, codes = codec.encode_infer(wav)
        codes = codes[0]
        codes = codes[codes != args.eoa_token_id]
        samples.append(Sample(
            text_ids=np.asarray(tok.encode_words(item["answer_text"]),
                                np.int32),
            codes=codes.astype(np.int32)))
        if (i + 1) % 100 == 0:
            print(f"{i + 1}/{len(items)}")
    save_prepared(args.out, samples)
    print(f"wrote {args.out}: {len(samples)} samples")


if __name__ == "__main__":
    main()
