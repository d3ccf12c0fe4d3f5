"""Checkpoint conversion: reference / HF state dicts to the port's trees.

Copies of ``llmvox_tpu/tools/convert.py``'s converters, numpy in and
numpy out, so the card's host makes every npz without JAX:
- the decoder checkpoint (``ckpt_english_tiny.pt``: the ``_orig_mod.``
  prefix stripped, Linear weights transposed to ``(Cin, Cout)``);
- the WavTokenizer Lightning checkpoint (codebooks, backbone and head;
  the SEANet encoder with its weight norms folded, w = g v / ||v||);
- HF Llama / Mixtral and Whisper state dicts;
- the ByT5 embedding table, resized to 386 rows with mean-initialised
  rows for [PAD] and EOS;
- the Encodec LM (``codec/lm.py``) and the UTMOS scorer's Lightning
  checkpoint (``codec/utmos.py``; fairseq's weight-normed positional
  conv folded along its own norm axis).
The trees keep the JAX layout (stacked layers, Linear weights
``(Cin, Cout)``, conv kernels ``(K, Cin, Cout)``) as float32 arrays;
``utils/params.py::to_torch`` moves them to a device.  ``torch.load``
only reads files.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, np.float32)


def strip_prefix(sd: Mapping, prefix: str = "_orig_mod.") -> Dict:
    return {(k[len(prefix):] if k.startswith(prefix) else k): v
            for k, v in sd.items()}


def fold_weight_norm(sd: Mapping) -> Dict:
    """Fold weight_norm (g, v) pairs into plain ``weight`` entries.

    Handles both legacy (``weight_g``/``weight_v``) and new-style
    (``parametrizations.weight.original0``/``original1``) naming.
    torch weight_norm dim=0: per-output-channel norm over remaining dims.
    """
    out: Dict = {}
    done = set()
    for k in sd:
        if k.endswith("weight_g"):
            base = k[: -len("weight_g")]
            g, v = _np(sd[k]), _np(sd[base + "weight_v"])
        elif k.endswith("parametrizations.weight.original0"):
            base = k[: -len("parametrizations.weight.original0")]
            g = _np(sd[k])
            v = _np(sd[base + "parametrizations.weight.original1"])
            base = base.replace("parametrizations.", "")[: None]
        else:
            continue
        axes = tuple(range(1, v.ndim))
        norm = np.sqrt(np.sum(v * v, axis=axes, keepdims=True))
        out[base + "weight"] = g * v / np.maximum(norm, 1e-12)
        done.add(k)
        done.add(base + "weight_v")
        done.add(base + "parametrizations.weight.original1")
    for k, val in sd.items():
        if k in done or k.endswith(("weight_g", "weight_v")) or \
                "parametrizations.weight" in k:
            continue
        out.setdefault(k, val)
    return out


def _conv_w(w) -> np.ndarray:
    """torch Conv1d (Cout, Cin, K) -> (K, Cin, Cout)."""
    return np.transpose(_np(w), (2, 1, 0))


def _lin_w(w) -> np.ndarray:
    """torch Linear (Cout, Cin) -> (Cin, Cout)."""
    return _np(w).T


def convert_whisper_state_dict(sd: Mapping, enc_layers: int,
                               dec_layers: int) -> Dict:
    """HF ``WhisperForConditionalGeneration`` state dict ->
    ``models/whisper.py`` params (stacked-layer layout, Linear weights
    transposed to (Cin, Cout), conv kernels to (K, Cin, Cout))."""
    sd = strip_prefix(dict(sd))
    if any(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items()
              if k.startswith("model.")}

    def stack(fmt: str, n: int, f=_lin_w):
        return np.stack([f(sd[fmt.format(i)]) for i in range(n)])

    def attn_block(t: str, n: int, prefix: str = "") -> Dict:
        # k_proj has no bias in every Whisper attention block
        return {
            prefix + "wq": stack(t + ".q_proj.weight", n),
            prefix + "bq": stack(t + ".q_proj.bias", n, _np),
            prefix + "wk": stack(t + ".k_proj.weight", n),
            prefix + "wv": stack(t + ".v_proj.weight", n),
            prefix + "bv": stack(t + ".v_proj.bias", n, _np),
            prefix + "wo": stack(t + ".out_proj.weight", n),
            prefix + "bo": stack(t + ".out_proj.bias", n, _np),
        }

    def common(t: str, n: int) -> Dict:
        return {
            "ln1_s": stack(t + "self_attn_layer_norm.weight", n, _np),
            "ln1_b": stack(t + "self_attn_layer_norm.bias", n, _np),
            "ln2_s": stack(t + "final_layer_norm.weight", n, _np),
            "ln2_b": stack(t + "final_layer_norm.bias", n, _np),
            "fc1_w": stack(t + "fc1.weight", n),
            "fc1_b": stack(t + "fc1.bias", n, _np),
            "fc2_w": stack(t + "fc2.weight", n),
            "fc2_b": stack(t + "fc2.bias", n, _np),
        }

    te = "encoder.layers.{}."
    td = "decoder.layers.{}."
    enc_h = common(te, enc_layers)
    enc_h.update(attn_block(te + "self_attn", enc_layers))
    dec_h = common(td, dec_layers)
    dec_h.update(attn_block(td + "self_attn", dec_layers))
    dec_h.update(attn_block(td + "encoder_attn", dec_layers, prefix="x"))
    dec_h.update({
        "lnx_s": stack(td + "encoder_attn_layer_norm.weight", dec_layers,
                       _np),
        "lnx_b": stack(td + "encoder_attn_layer_norm.bias", dec_layers,
                       _np),
    })
    return {
        "enc": {
            "conv1_w": _conv_w(sd["encoder.conv1.weight"]),
            "conv1_b": _np(sd["encoder.conv1.bias"]),
            "conv2_w": _conv_w(sd["encoder.conv2.weight"]),
            "conv2_b": _np(sd["encoder.conv2.bias"]),
            "pos": _np(sd["encoder.embed_positions.weight"]),
            "h": enc_h,
            "lnf_s": _np(sd["encoder.layer_norm.weight"]),
            "lnf_b": _np(sd["encoder.layer_norm.bias"]),
        },
        "dec": {
            "tok_emb": _np(sd["decoder.embed_tokens.weight"]),
            "pos": _np(sd["decoder.embed_positions.weight"]),
            "h": dec_h,
            "lnf_s": _np(sd["decoder.layer_norm.weight"]),
            "lnf_b": _np(sd["decoder.layer_norm.bias"]),
        },
    }


def convert_decoder_state_dict(sd: Mapping, n_layer: int, bias: bool) -> Dict:
    sd = strip_prefix(dict(sd))

    def stack(fmt: str, f):
        return np.stack([f(sd[fmt.format(i)]) for i in range(n_layer)])

    h = {
        "ln1_s": stack("transformer.h.{}.ln_1.weight", _np),
        "wqkv": stack("transformer.h.{}.attn.c_attn.weight", _lin_w),
        "wo": stack("transformer.h.{}.attn.c_proj.weight", _lin_w),
        "ln2_s": stack("transformer.h.{}.ln_2.weight", _np),
        "wfc": stack("transformer.h.{}.mlp.c_fc.weight", _lin_w),
        "wproj": stack("transformer.h.{}.mlp.c_proj.weight", _lin_w),
    }
    if bias:
        h.update({
            "ln1_b": stack("transformer.h.{}.ln_1.bias", _np),
            "bqkv": stack("transformer.h.{}.attn.c_attn.bias", _np),
            "bo": stack("transformer.h.{}.attn.c_proj.bias", _np),
            "ln2_b": stack("transformer.h.{}.ln_2.bias", _np),
            "bfc": stack("transformer.h.{}.mlp.c_fc.bias", _np),
            "bproj": stack("transformer.h.{}.mlp.c_proj.bias", _np),
        })
    params = {
        "wpe": _np(sd["transformer.wpe.weight"]),
        "h": h,
        "lnf_s": _np(sd["transformer.ln_f.weight"]),
        "head": _lin_w(sd["lm_head.weight"]),
    }
    if bias:
        params["lnf_b"] = _np(sd["transformer.ln_f.bias"])
    return params


def convert_decoder_ckpt(pt_path: str):
    """Load the reference decoder checkpoint -> (params, model_args dict)."""
    import torch
    ckpt = torch.load(pt_path, map_location="cpu", weights_only=False)
    args = ckpt["model_args"]
    params = convert_decoder_state_dict(
        ckpt["model"], n_layer=args["n_layer"], bias=args.get("bias", False))
    return params, args


def _resnet(sd: Mapping, p: str) -> Dict:
    return {
        "norm1_s": _np(sd[f"{p}.norm1.weight"]),
        "norm1_b": _np(sd[f"{p}.norm1.bias"]),
        "conv1_w": _conv_w(sd[f"{p}.conv1.weight"]),
        "conv1_b": _np(sd[f"{p}.conv1.bias"]),
        "norm2_s": _np(sd[f"{p}.norm2.weight"]),
        "norm2_b": _np(sd[f"{p}.norm2.bias"]),
        "conv2_w": _conv_w(sd[f"{p}.conv2.weight"]),
        "conv2_b": _np(sd[f"{p}.conv2.bias"]),
    }


def _attn(sd: Mapping, p: str) -> Dict:
    def lin1x1(name):
        return _np(sd[f"{p}.{name}.weight"])[:, :, 0].T  # (C,C,1) -> (Cin,Cout)
    return {
        "norm_s": _np(sd[f"{p}.norm.weight"]),
        "norm_b": _np(sd[f"{p}.norm.bias"]),
        "q_w": lin1x1("q"), "q_b": _np(sd[f"{p}.q.bias"]),
        "k_w": lin1x1("k"), "k_b": _np(sd[f"{p}.k.bias"]),
        "v_w": lin1x1("v"), "v_b": _np(sd[f"{p}.v.bias"]),
        "proj_w": lin1x1("proj_out"), "proj_b": _np(sd[f"{p}.proj_out.bias"]),
    }


def convert_codec_state_dict(sd: Mapping, n_layers: int = 12,
                             n_q: int = 1) -> Dict:
    """Filtered Lightning state_dict -> codec inference params
    (codebooks + backbone + head)."""
    sd = {k: v for k, v in sd.items()
          if k.startswith(("backbone.", "head.", "feature_extractor."))}

    codebooks = np.stack([
        _np(sd[f"feature_extractor.encodec.quantizer.vq.layers.{q}"
               f"._codebook.embed"]) for q in range(n_q)])

    b = "backbone"
    convnext = {
        "dwconv_w": np.stack([
            np.transpose(_np(sd[f"{b}.convnext.{i}.dwconv.weight"]), (2, 1, 0))
            for i in range(n_layers)]),
        "dwconv_b": np.stack([_np(sd[f"{b}.convnext.{i}.dwconv.bias"])
                              for i in range(n_layers)]),
        "norm_scale": np.stack([_np(sd[f"{b}.convnext.{i}.norm.scale.weight"])
                                for i in range(n_layers)]),
        "norm_shift": np.stack([_np(sd[f"{b}.convnext.{i}.norm.shift.weight"])
                                for i in range(n_layers)]),
        "pw1_w": np.stack([_lin_w(sd[f"{b}.convnext.{i}.pwconv1.weight"])
                           for i in range(n_layers)]),
        "pw1_b": np.stack([_np(sd[f"{b}.convnext.{i}.pwconv1.bias"])
                           for i in range(n_layers)]),
        "pw2_w": np.stack([_lin_w(sd[f"{b}.convnext.{i}.pwconv2.weight"])
                           for i in range(n_layers)]),
        "pw2_b": np.stack([_np(sd[f"{b}.convnext.{i}.pwconv2.bias"])
                           for i in range(n_layers)]),
        "gamma": np.stack([_np(sd[f"{b}.convnext.{i}.gamma"])
                           for i in range(n_layers)]),
    }
    backbone = {
        "embed": {"w": _conv_w(sd[f"{b}.embed.weight"]),
                  "b": _np(sd[f"{b}.embed.bias"])},
        "pos_net": {
            "res0": _resnet(sd, f"{b}.pos_net.0"),
            "res1": _resnet(sd, f"{b}.pos_net.1"),
            "attn": _attn(sd, f"{b}.pos_net.2"),
            "res2": _resnet(sd, f"{b}.pos_net.3"),
            "res3": _resnet(sd, f"{b}.pos_net.4"),
            "gn_s": _np(sd[f"{b}.pos_net.5.weight"]),
            "gn_b": _np(sd[f"{b}.pos_net.5.bias"]),
        },
        "adanorm": {"scale": _np(sd[f"{b}.norm.scale.weight"]),
                    "shift": _np(sd[f"{b}.norm.shift.weight"])},
        "convnext": convnext,
        "final_ln": {"s": _np(sd[f"{b}.final_layer_norm.weight"]),
                     "b": _np(sd[f"{b}.final_layer_norm.bias"])},
    }
    return {
        "codebooks": codebooks,
        "backbone": backbone,
        "head": {"w": _lin_w(sd["head.out.weight"]),
                 "b": _np(sd["head.out.bias"])},
    }


def convert_seanet_encoder_state_dict(sd: Mapping, ratios=(2, 4, 5, 8),
                                      n_residual: int = 1,
                                      lstm_layers: int = 2) -> Dict:
    """SEANet encoder weights (after weight-norm folding).

    Sequential index layout (encoder/modules/seanet.py:107-141):
    0 conv_in; per stage: n_residual resblocks, ELU (no params), downsample
    conv; then SLSTM; ELU; conv_out.
    """
    sd = fold_weight_norm({k[len("feature_extractor.encodec.encoder."):]: v
                           for k, v in sd.items()
                           if k.startswith("feature_extractor.encodec.encoder.")})

    def conv(idx):
        return {"w": _conv_w(sd[f"model.{idx}.conv.conv.weight"]),
                "b": _np(sd[f"model.{idx}.conv.conv.bias"])}

    params: Dict = {"conv_in": conv(0)}
    idx = 1
    stages = []
    for si, ratio in enumerate(ratios):
        res_layers = []
        for j in range(n_residual):
            p = f"model.{idx}"
            res_layers.append({
                "conv1": {"w": _conv_w(sd[f"{p}.block.1.conv.conv.weight"]),
                          "b": _np(sd[f"{p}.block.1.conv.conv.bias"])},
                "conv2": {"w": _conv_w(sd[f"{p}.block.3.conv.conv.weight"]),
                          "b": _np(sd[f"{p}.block.3.conv.conv.bias"])},
                "shortcut": {"w": _conv_w(sd[f"{p}.shortcut.conv.conv.weight"]),
                             "b": _np(sd[f"{p}.shortcut.conv.conv.bias"])},
            })
            idx += 1
        idx += 1  # ELU
        stages.append({"res": res_layers, "down": conv(idx)})
        idx += 1
    params["stages"] = stages

    lstm = []
    for li in range(lstm_layers):
        p = f"model.{idx}.lstm"
        lstm.append({
            "wi": _np(sd[f"{p}.weight_ih_l{li}"]).T,
            "wh": _np(sd[f"{p}.weight_hh_l{li}"]).T,
            "bi": _np(sd[f"{p}.bias_ih_l{li}"]),
            "bh": _np(sd[f"{p}.bias_hh_l{li}"]),
        })
    params["lstm"] = lstm
    idx += 2  # SLSTM, ELU
    params["conv_out"] = conv(idx)
    return params


def convert_wavtokenizer_ckpt(ckpt_path: str, with_encoder: bool = True) -> Dict:
    import torch
    raw = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    sd = raw.get("state_dict", raw)
    params = convert_codec_state_dict(sd)
    if with_encoder:
        try:
            params["encoder"] = convert_seanet_encoder_state_dict(sd)
        except KeyError as e:
            print(f"note: encoder weights not converted ({e}); decode-only")
    return params


def convert_llama_state_dict(sd: Mapping, num_layers: int) -> Dict:
    """HF ``LlamaForCausalLM`` — or ``MixtralForCausalLM`` — state dict
    -> ``models/llama.py`` params (stacked-layer layout, Linear weights
    transposed to (Cin, Cout)).

    Mixtral checkpoints are detected by their ``block_sparse_moe`` keys
    and map onto the MoE FFN (ops/moe.py): ``gate`` -> router, expert
    ``w1``/``w3``/``w2`` -> moe_wgate/moe_wup/moe_wdown (HF names the
    SwiGLU projections w1=gate, w3=up, w2=down).  Mixtral's routing
    convention (softmax over the top-k selected logits) is exactly
    ``moe_ffn``'s; set ``LlamaConfig.n_experts`` / ``moe_top_k`` from
    the HF config's ``num_local_experts`` / ``num_experts_per_tok``.
    """
    sd = strip_prefix(dict(sd))

    def stack(fmt: str, f=_lin_w):
        return np.stack([f(sd[fmt.format(i)]) for i in range(num_layers)])

    t = "model.layers.{}."
    moe = (t.format(0) + "block_sparse_moe.gate.weight") in sd
    if moe:
        n_exp = sum(1 for k in sd
                    if k.startswith(t.format(0) + "block_sparse_moe.experts.")
                    and k.endswith(".w1.weight"))
        e = t + "block_sparse_moe.experts.{}."

        def estack(wname: str):
            return np.stack([
                np.stack([_lin_w(sd[e.format(i, j) + wname])
                          for j in range(n_exp)])
                for i in range(num_layers)])

        mlp = {
            "router": stack(t + "block_sparse_moe.gate.weight"),
            "moe_wgate": estack("w1.weight"),
            "moe_wup": estack("w3.weight"),
            "moe_wdown": estack("w2.weight"),
        }
    else:
        mlp = {
            "wgate": stack(t + "mlp.gate_proj.weight"),
            "wup": stack(t + "mlp.up_proj.weight"),
            "wdown": stack(t + "mlp.down_proj.weight"),
        }
    params = {
        "tok_emb": _np(sd["model.embed_tokens.weight"]),
        "h": {
            "ln1_s": stack(t + "input_layernorm.weight", _np),
            "wq": stack(t + "self_attn.q_proj.weight"),
            "wk": stack(t + "self_attn.k_proj.weight"),
            "wv": stack(t + "self_attn.v_proj.weight"),
            "wo": stack(t + "self_attn.o_proj.weight"),
            "ln2_s": stack(t + "post_attention_layernorm.weight", _np),
            **mlp,
        },
        "lnf_s": _np(sd["model.norm.weight"]),
    }
    if "lm_head.weight" in sd:
        params["head"] = _lin_w(sd["lm_head.weight"])
    return params


def convert_byt5_embeddings(embed_weight, target_rows: int = 386) -> np.ndarray:
    """T5 encoder.embed_tokens (V, 256) -> (386, 256) with mean-init rows
    for the [PAD]=384 / EOS=385 specials (model_handler.py:22-42)."""
    w = _np(embed_weight)
    if w.shape[0] >= target_rows:
        return w[:target_rows]
    mean = w.mean(axis=0, keepdims=True)
    pad = np.repeat(mean, target_rows - w.shape[0], axis=0)
    return np.concatenate([w, pad], axis=0)


def convert_byt5_from_hf(model_name_or_path: str,
                         target_rows: int = 386) -> np.ndarray:
    from transformers import T5ForConditionalGeneration
    model = T5ForConditionalGeneration.from_pretrained(model_name_or_path)
    return convert_byt5_embeddings(
        model.encoder.embed_tokens.weight, target_rows)


# ---------------------------------------------------------------------------
# Encodec LM (encoder/model.py:27-66; pretrained encodec_lm_*.th)
# ---------------------------------------------------------------------------

def convert_lm_state_dict(sd: Mapping, n_q: int, num_layers: int = 5) -> Dict:
    """torch ``LMModel`` state dict -> ``codec/lm.py`` params.

    Layer weights are stacked on a leading depth axis (the JAX
    layout); ``in_proj_weight`` (3D, D) becomes the (D, 3D) ``qkv.w`` so
    q/k/v are column slices.
    """
    sd = strip_prefix(dict(sd))

    def stack(fmt: str, f=_np):
        return np.stack([f(sd[fmt.format(i)]) for i in range(num_layers)])

    t = "transformer.layers.{}."
    layers = {
        "qkv": {"w": stack(t + "self_attn.in_proj_weight", _lin_w),
                "b": stack(t + "self_attn.in_proj_bias")},
        "out": {"w": stack(t + "self_attn.out_proj.weight", _lin_w),
                "b": stack(t + "self_attn.out_proj.bias")},
        "ff1": {"w": stack(t + "linear1.weight", _lin_w),
                "b": stack(t + "linear1.bias")},
        "ff2": {"w": stack(t + "linear2.weight", _lin_w),
                "b": stack(t + "linear2.bias")},
        "norm1": {"scale": stack(t + "norm1.weight"),
                  "bias": stack(t + "norm1.bias")},
        "norm2": {"scale": stack(t + "norm2.weight"),
                  "bias": stack(t + "norm2.bias")},
    }
    transformer = {"layers": layers}
    if "transformer.norm_in.weight" in sd:
        transformer["norm_in"] = {
            "scale": _np(sd["transformer.norm_in.weight"]),
            "bias": _np(sd["transformer.norm_in.bias"]),
        }
    return {
        "emb": np.stack([_np(sd[f"emb.{k}.weight"]) for k in range(n_q)]),
        "heads": {
            "w": np.stack([_lin_w(sd[f"linears.{k}.weight"])
                           for k in range(n_q)]),
            "b": np.stack([_np(sd[f"linears.{k}.bias"])
                           for k in range(n_q)]),
        },
        "transformer": transformer,
    }


# ---------------------------------------------------------------------------
# UTMOS MOS predictor (WavTokenizer/metrics/UTMOS.py, the Lightning
# checkpoint "epoch=3-step=7459.ckpt": fairseq wav2vec2-base keys under
# feature_extractors.0.ssl_model, head under output_layers)
# ---------------------------------------------------------------------------

def _fold_wn_anydim(g, v) -> np.ndarray:
    """Weight-norm fold for arbitrary norm dim: g keeps size along the
    kept dim(s) and is 1 elsewhere (fairseq's pos_conv uses dim=2, so the
    generic dim-0 fold above would normalize the wrong axes)."""
    g, v = _np(g), _np(v)
    axes = tuple(i for i, s in enumerate(g.shape) if s == 1)
    norm = np.sqrt(np.sum(v * v, axis=axes, keepdims=True))
    return g * v / np.maximum(norm, 1e-12)


def convert_utmos_state_dict(sd: Mapping, n_layer: int = 0) -> Dict:
    """Lightning UTMOS checkpoint state dict -> codec/utmos.py params.
    ``n_layer=0`` infers the encoder depth from the keys."""
    sd = {k[len("model."):] if k.startswith("model.") else k: v
          for k, v in sd.items()}
    ssl = "feature_extractors.0.ssl_model."
    if not n_layer:
        n_layer = 1 + max(
            int(k.split("encoder.layers.")[1].split(".")[0])
            for k in sd if "encoder.layers." in k)

    convs = []
    i = 0
    while f"{ssl}feature_extractor.conv_layers.{i}.0.weight" in sd:
        convs.append({"w": _conv_w(
            sd[f"{ssl}feature_extractor.conv_layers.{i}.0.weight"])})
        i += 1

    def stack(tmpl, f=None):
        f = f or _lin_w
        return np.stack([f(sd[tmpl.format(i)]) for i in range(n_layer)])

    pc = ssl + "encoder.pos_conv.0."
    if pc + "weight_g" in sd:
        pos_w = _fold_wn_anydim(sd[pc + "weight_g"], sd[pc + "weight_v"])
    elif pc + "parametrizations.weight.original0" in sd:
        pos_w = _fold_wn_anydim(
            sd[pc + "parametrizations.weight.original0"],
            sd[pc + "parametrizations.weight.original1"])
    else:
        pos_w = _np(sd[pc + "weight"])

    t = ssl + "encoder.layers.{}."
    params = {
        "conv": convs,
        "conv0_gn": {
            "s": _np(sd[ssl + "feature_extractor.conv_layers.0.2.weight"]),
            "b": _np(sd[ssl + "feature_extractor.conv_layers.0.2.bias"])},
        "fp_ln": {"s": _np(sd[ssl + "layer_norm.weight"]),
                  "b": _np(sd[ssl + "layer_norm.bias"])},
        "fp_w": _lin_w(sd[ssl + "post_extract_proj.weight"]),
        "fp_b": _np(sd[ssl + "post_extract_proj.bias"]),
        "pos_conv": {"w": np.transpose(pos_w, (2, 1, 0)),
                     "b": _np(sd[pc + "bias"])},
        "enc_ln": {"s": _np(sd[ssl + "encoder.layer_norm.weight"]),
                   "b": _np(sd[ssl + "encoder.layer_norm.bias"])},
        "layers": {
            "wq": stack(t + "self_attn.q_proj.weight"),
            "bq": stack(t + "self_attn.q_proj.bias", _np),
            "wk": stack(t + "self_attn.k_proj.weight"),
            "bk": stack(t + "self_attn.k_proj.bias", _np),
            "wv": stack(t + "self_attn.v_proj.weight"),
            "bv": stack(t + "self_attn.v_proj.bias", _np),
            "wo": stack(t + "self_attn.out_proj.weight"),
            "bo": stack(t + "self_attn.out_proj.bias", _np),
            "ln1_s": stack(t + "self_attn_layer_norm.weight", _np),
            "ln1_b": stack(t + "self_attn_layer_norm.bias", _np),
            "w1": stack(t + "fc1.weight"),
            "b1": stack(t + "fc1.bias", _np),
            "w2": stack(t + "fc2.weight"),
            "b2": stack(t + "fc2.bias", _np),
            "ln2_s": stack(t + "final_layer_norm.weight", _np),
            "ln2_b": stack(t + "final_layer_norm.bias", _np),
        },
        "domain_emb": _np(sd["feature_extractors.1.embedding.weight"]),
        "judge_emb": _np(sd["output_layers.0.judge_embedding.weight"]),
        "proj1_w": _lin_w(sd["output_layers.1.net.0.weight"]),
        "proj1_b": _np(sd["output_layers.1.net.0.bias"]),
        "proj2_w": _lin_w(sd["output_layers.1.net.3.weight"]),
        "proj2_b": _np(sd["output_layers.1.net.3.bias"]),
    }
    rnn = "output_layers.0.decoder_rnn."
    for direction, sfx in (("fwd", ""), ("bwd", "_reverse")):
        params[f"lstm_{direction}"] = {
            "wi": _lin_w(sd[rnn + f"weight_ih_l0{sfx}"]),
            "wh": _lin_w(sd[rnn + f"weight_hh_l0{sfx}"]),
            "bi": _np(sd[rnn + f"bias_ih_l0{sfx}"]),
            "bh": _np(sd[rnn + f"bias_hh_l0{sfx}"]),
        }
    return params
