"""CLI: convert reference checkpoints to the port's .npz files.

The port's ``python -m llmvox_tpu.tools.convert_ckpt``, without JAX: the
files it writes (``train/checkpoint.py::save_params_npz``, with the same
``meta``) are read by the port's loaders and by the JAX package's.

  python -m llmvox_tpu_torch.tools.convert_ckpt decoder ckpt_english_tiny.pt out/decoder.npz
  python -m llmvox_tpu_torch.tools.convert_ckpt codec wavtokenizer_large_speech_320_24k.ckpt out/codec.npz
  python -m llmvox_tpu_torch.tools.convert_ckpt byt5 charsiu/g2p_multilingual_byT5_tiny_16_layers_100 out/byt5.npz
  python -m llmvox_tpu_torch.tools.convert_ckpt llama <HF Llama or Mixtral dir> out/llama.npz
  python -m llmvox_tpu_torch.tools.convert_ckpt whisper <HF Whisper dir> out/whisper.npz
  python -m llmvox_tpu_torch.tools.convert_ckpt utmos epoch=3-step=7459.ckpt out/utmos.npz

The ``llama``, ``whisper`` and ``byt5`` modes load the model with
transformers (from the network unless given a local directory).
"""
from __future__ import annotations

import argparse

import numpy as np

from llmvox_tpu_torch.tools import convert
from llmvox_tpu_torch.train.checkpoint import save_params_npz


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("kind", choices=["decoder", "codec", "byt5",
                                         "llama", "utmos", "whisper"])
    parser.add_argument("src")
    parser.add_argument("dst")
    parser.add_argument("--no-encoder", action="store_true",
                        help="codec: skip SEANet encoder weights")
    args = parser.parse_args(argv)

    if args.kind == "decoder":
        params, margs = convert.convert_decoder_ckpt(args.src)
        save_params_npz(args.dst, params, meta={"model_args": margs})
    elif args.kind == "codec":
        params = convert.convert_wavtokenizer_ckpt(
            args.src, with_encoder=not args.no_encoder)
        save_params_npz(args.dst, params)
    elif args.kind == "llama":
        # HF LlamaForCausalLM dir/name -> models/llama.py params + config
        # meta (read by streams/llm.py::build_llama_stream)
        from transformers import AutoConfig, AutoModelForCausalLM
        hf_cfg = AutoConfig.from_pretrained(args.src)
        model = AutoModelForCausalLM.from_pretrained(args.src)
        params = convert.convert_llama_state_dict(
            model.state_dict(), hf_cfg.num_hidden_layers)
        margs = {
            "vocab_size": hf_cfg.vocab_size,
            "n_layer": hf_cfg.num_hidden_layers,
            "n_head": hf_cfg.num_attention_heads,
            "n_kv_head": getattr(hf_cfg, "num_key_value_heads",
                                 hf_cfg.num_attention_heads),
            "n_embd": hf_cfg.hidden_size,
            "intermediate_size": hf_cfg.intermediate_size,
            "max_seq_len": min(hf_cfg.max_position_embeddings, 8192),
            "rope_theta": getattr(hf_cfg, "rope_theta", 10000.0),
            "rms_eps": hf_cfg.rms_norm_eps,
            "tie_embeddings": bool(getattr(hf_cfg, "tie_word_embeddings",
                                           False)),
        }
        # Mixtral-family MoE: wire the expert count / top-k into the
        # serving config so the converted checkpoint routes through the
        # MoE FFN (ops/moe.py) — detected the same way the state-dict
        # converter detects it
        if getattr(hf_cfg, "num_local_experts", 0):
            e = int(hf_cfg.num_local_experts)
            k = int(hf_cfg.num_experts_per_tok)
            margs.update({
                "n_experts": e,
                "moe_top_k": k,
                # HF inference computes every routed token with NO
                # capacity limit; a converted checkpoint must never drop
                # (the training default cf=2.0 caps an expert at n/2 for
                # E=8/k=2 and imbalanced routing would silently diverge
                # from HF — ADVICE r3).  cf = E/k makes moe_capacity()
                # return n at every shape; inference paths are drop-free
                # regardless (ops/moe.py), this covers teacher-forced
                # eval too.
                "moe_capacity_factor": float(e) / float(k),
            })
        # Llama 3.1/3.2 rope_scaling: without this the rotary frequencies
        # are wrong at every position (models/llama.py::_inv_freq)
        rs = getattr(hf_cfg, "rope_scaling", None)
        if rs:
            rtype = rs.get("rope_type", rs.get("type"))
            if rtype != "llama3":
                raise ValueError(
                    f"unsupported rope_scaling type {rtype!r}; only "
                    "'llama3' is implemented")
            margs.update({
                "rope_scaling_factor": float(rs["factor"]),
                "rope_low_freq_factor": float(rs["low_freq_factor"]),
                "rope_high_freq_factor": float(rs["high_freq_factor"]),
                "rope_original_max_position": int(
                    rs["original_max_position_embeddings"]),
            })
        save_params_npz(args.dst, params, meta={"model_args": margs})
    elif args.kind == "whisper":
        # HF WhisperForConditionalGeneration dir/name ->
        # models/whisper.py params + config meta (read by
        # streams/asr.py::WhisperModelASR)
        from transformers import WhisperForConditionalGeneration
        model = WhisperForConditionalGeneration.from_pretrained(args.src)
        hc, gc = model.config, model.generation_config
        params = convert.convert_whisper_state_dict(
            model.state_dict(), hc.encoder_layers, hc.decoder_layers)
        margs = {
            "vocab_size": hc.vocab_size, "n_mels": hc.num_mel_bins,
            "d_model": hc.d_model, "enc_layers": hc.encoder_layers,
            "dec_layers": hc.decoder_layers,
            "enc_heads": hc.encoder_attention_heads,
            "dec_heads": hc.decoder_attention_heads,
            "enc_ffn": hc.encoder_ffn_dim, "dec_ffn": hc.decoder_ffn_dim,
            "max_source_positions": hc.max_source_positions,
            "max_target_positions": hc.max_target_positions,
            "decoder_start_token_id": int(gc.decoder_start_token_id),
            "eos_token_id": int(gc.eos_token_id),
        }
        # generation metadata + tokenizer source: everything the serving
        # backend needs so transformers/torch stay out of the serve path
        gen = {
            "lang_to_id": dict(getattr(gc, "lang_to_id", None) or {}),
            "task_to_id": dict(getattr(gc, "task_to_id", None) or {}),
            "no_timestamps_token_id": getattr(gc, "no_timestamps_token_id",
                                              None),
            "suppress_tokens": list(getattr(gc, "suppress_tokens", None)
                                    or []),
            "begin_suppress_tokens": list(
                getattr(gc, "begin_suppress_tokens", None) or []),
            "max_length": getattr(gc, "max_length", None),
        }
        save_params_npz(args.dst, params,
                        meta={"model_args": margs, "generation": gen,
                              "tokenizer_src": args.src})
    elif args.kind == "utmos":
        # the reference's UTMOS Lightning checkpoint
        # ("epoch=3-step=7459.ckpt", WavTokenizer/metrics/UTMOS.py:26-28)
        # -> codec/utmos.py params; activate with codec.utmos.register()
        import torch
        ckpt = torch.load(args.src, map_location="cpu",
                          weights_only=False)
        sd = ckpt.get("state_dict", ckpt)
        params = convert.convert_utmos_state_dict(sd)
        save_params_npz(args.dst, params,
                        meta={"model_args": {
                            "encoder_layers":
                                int(params["layers"]["wq"].shape[0])}})
    else:
        table = convert.convert_byt5_from_hf(args.src)
        np.savez(args.dst, table=table)
    print(f"wrote {args.dst}")


if __name__ == "__main__":
    main()
