"""GPT-2 weight import: the reference's ``init_from='gpt2'`` path.

Counterpart of ``llmvox_tpu/models/gpt2_import.py``.  HF GPT-2's Conv1D
kernels are already ``(Cin, Cout)``, the params layout, so the import
copies them.  The gpt2 architecture is forced from the model type
(vocab 50257 there, block 1024, biases), and the head onto the 4096
speech codes is drawn afresh, since GPT-2's text head means nothing for
codec codes.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np

from llmvox_tpu_torch.utils.config import DecoderConfig

GPT2_ARCH = {
    "gpt2": dict(n_layer=12, n_head=12, n_embd=768),
    "gpt2-medium": dict(n_layer=24, n_head=16, n_embd=1024),
    "gpt2-large": dict(n_layer=36, n_head=20, n_embd=1280),
    "gpt2-xl": dict(n_layer=48, n_head=25, n_embd=1600),
}


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, np.float32)


def convert_gpt2_state_dict(sd: Mapping, n_layer: int,
                            speech_vocab: int = 4096,
                            head_seed: int = 0) -> Dict:
    """HF GPT2LMHeadModel state dict -> decoder params (bias=True), the
    speech head drawn from normal(0.02) with ``head_seed``."""
    pre = "transformer." if any(k.startswith("transformer.") for k in sd) \
        else ""

    def stack(fmt, f=_np):
        return np.stack([f(sd[pre + fmt.format(i)]) for i in range(n_layer)])

    h = {
        "ln1_s": stack("h.{}.ln_1.weight"),
        "ln1_b": stack("h.{}.ln_1.bias"),
        "wqkv": stack("h.{}.attn.c_attn.weight"),     # Conv1D: (Cin, Cout)
        "bqkv": stack("h.{}.attn.c_attn.bias"),
        "wo": stack("h.{}.attn.c_proj.weight"),
        "bo": stack("h.{}.attn.c_proj.bias"),
        "ln2_s": stack("h.{}.ln_2.weight"),
        "ln2_b": stack("h.{}.ln_2.bias"),
        "wfc": stack("h.{}.mlp.c_fc.weight"),
        "bfc": stack("h.{}.mlp.c_fc.bias"),
        "wproj": stack("h.{}.mlp.c_proj.weight"),
        "bproj": stack("h.{}.mlp.c_proj.bias"),
    }
    n_embd = h["wo"].shape[-1]
    rng = np.random.default_rng(head_seed)
    return {
        "wpe": _np(sd[pre + "wpe.weight"]),
        "h": h,
        "lnf_s": _np(sd[pre + "ln_f.weight"]),
        "lnf_b": _np(sd[pre + "ln_f.bias"]),
        "head": (0.02 * rng.standard_normal((n_embd, speech_vocab))
                 ).astype(np.float32),
    }


def init_from_gpt2(model_type: str = "gpt2",
                   speech_vocab: int = 4096) -> Tuple[Dict, DecoderConfig]:
    """Download gpt2* from HF and convert (needs the network and
    transformers)."""
    from transformers import GPT2LMHeadModel
    arch = GPT2_ARCH[model_type]
    model = GPT2LMHeadModel.from_pretrained(model_type)
    params = convert_gpt2_state_dict(model.state_dict(), arch["n_layer"],
                                     speech_vocab)
    cfg = DecoderConfig(block_size=1024, vocab_size=speech_vocab,
                        bias=True, **arch)
    return params, cfg
