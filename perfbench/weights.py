"""Seeded weights, made on the device in the type they are served in.

Each tree is drawn from a ``torch.Generator`` on the device in one
``randn`` call per dtype, then cut into views and scaled, so a seed gives
the same tree on every run on one kind of device.  The trees have the
keys and shapes of the port's converted checkpoints (``utils/params.py``);
the distributions follow its initialisers (normal 0.02, residual
projections by 1/sqrt(2 n_layer), unit norms), with a clamp at two
standard deviations for the codec's truncated normals.  The harness hands
the same trees to the program and to the reference.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def sub_seed(seed: int, k: int) -> int:
    """A generator seed for part ``k`` of a run's ``seed``."""
    return (int(seed) * 1000003 + k * 7919) % (2 ** 63)


def _draw(specs: List[Tuple[str, tuple, float]], seed: int, device,
          dtype) -> Dict[str, torch.Tensor]:
    """One ``randn`` over every leaf of ``specs`` (name, shape, std; a
    negative std clamps at 2 standard deviations), cut into views."""
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(s) for _, s, _ in specs)
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, off = {}, 0
    for name, shape, std in specs:
        n = math.prod(shape)
        leaf = flat[off:off + n].view(shape)
        if std < 0:
            leaf.clamp_(-2.0, 2.0).mul_(-std)
        elif std != 1.0:
            leaf.mul_(std)
        out[name] = leaf
        off += n
    return out


def decoder_tree(seed: int, dcfg, device, dtype) -> Dict:
    """The speech decoder (no biases, as deployed)."""
    l, c, v = dcfg.n_layer, dcfg.n_embd, dcfg.vocab_size
    resid = 0.02 / math.sqrt(2 * l)
    w = _draw([("wpe", (dcfg.block_size, c), 0.02),
               ("head", (c, v), 0.02),
               ("wqkv", (l, c, 3 * c), 0.02), ("wo", (l, c, c), resid),
               ("wfc", (l, c, 4 * c), 0.02), ("wproj", (l, 4 * c, c), resid)],
              sub_seed(seed, 1), device, dtype)
    ones = lambda *s: torch.ones(s, device=device, dtype=dtype)  # noqa: E731
    return {"wpe": w["wpe"], "lnf_s": ones(c), "head": w["head"],
            "h": {"ln1_s": ones(l, c), "wqkv": w["wqkv"], "wo": w["wo"],
                  "ln2_s": ones(l, c), "wfc": w["wfc"],
                  "wproj": w["wproj"]}}


def text_table(seed: int, dcfg, device) -> torch.Tensor:
    """A random ByT5 byte-embedding table (f32, unit normal), standing in
    for the converted ByT5 encoder's embeddings."""
    return _draw([("t", (dcfg.text_vocab_size, dcfg.text_embed_dim), 1.0)],
                 sub_seed(seed, 2), device, torch.float32)["t"]


def codec_tree(seed: int, ccfg, device) -> Dict:
    """The codec's decode path in f32: codebooks (unit normal), the
    ConvNeXt backbone with its pos_net, the ISTFT head."""
    d, i, nl = (ccfg.backbone_dim, ccfg.backbone_intermediate_dim,
                ccfg.backbone_num_layers)
    ne, cin = ccfg.adanorm_num_embeddings, ccfg.backbone_input_channels
    t = -0.02
    specs = [("codebooks", (ccfg.num_quantizers, ccfg.vq_bins, ccfg.vq_dim),
              1.0),
             ("embed", (7, cin, d), t),
             ("dw", (nl, 7, 1, d), t), ("pw1", (nl, d, i), t),
             ("pw2", (nl, i, d), t), ("head", (d, ccfg.n_fft + 2), t)]
    for r in ("res0", "res1", "res2", "res3"):
        specs += [(f"{r}.c1", (3, d, d), t), (f"{r}.c2", (3, d, d), t)]
    specs += [(f"attn.{k}", (d, d), t) for k in ("q", "k", "v", "proj")]
    w = _draw(specs, sub_seed(seed, 3), device, torch.float32)
    z = lambda *s: torch.zeros(s, device=device)  # noqa: E731
    o = lambda *s: torch.ones(s, device=device)  # noqa: E731

    def res(r):
        return {"norm1_s": o(d), "norm1_b": z(d), "conv1_w": w[f"{r}.c1"],
                "conv1_b": z(d), "norm2_s": o(d), "norm2_b": z(d),
                "conv2_w": w[f"{r}.c2"], "conv2_b": z(d)}

    attn = {"norm_s": o(d), "norm_b": z(d)}
    for k in ("q", "k", "v", "proj"):
        attn[f"{k}_w"], attn[f"{k}_b"] = w[f"attn.{k}"], z(d)
    return {
        "codebooks": w["codebooks"],
        "backbone": {
            "embed": {"w": w["embed"], "b": z(d)},
            "pos_net": {"res0": res("res0"), "res1": res("res1"),
                        "attn": attn, "res2": res("res2"),
                        "res3": res("res3"), "gn_s": o(d), "gn_b": z(d)},
            "adanorm": {"scale": o(ne, d), "shift": z(ne, d)},
            "convnext": {"dwconv_w": w["dw"], "dwconv_b": z(nl, d),
                         "norm_scale": o(nl, ne, d),
                         "norm_shift": z(nl, ne, d),
                         "pw1_w": w["pw1"], "pw1_b": z(nl, i),
                         "pw2_w": w["pw2"], "pw2_b": z(nl, d),
                         "gamma": torch.full((nl, d), 1.0 / nl,
                                             device=device)},
            "final_ln": {"s": o(d), "b": z(d)},
        },
        "head": {"w": w["head"], "b": z(ccfg.n_fft + 2)},
    }


def llm_tree(seed: int, lcfg, device, dtype) -> Dict:
    """A Mixtral-family Llama tree (``models/llama.py``'s layout: Linear
    weights (Cin, Cout), experts stacked (E, C, I) and (E, I, C) on a
    layer axis), normal 0.02, RMSNorm scales 1: the attention, embedding
    and head in one draw, each expert matrix kind in one more."""
    l, c, v = lcfg.n_layer, lcfg.n_embd, lcfg.vocab_size
    e, i = lcfg.n_experts, lcfg.intermediate_size
    kvd = lcfg.n_kv_head * lcfg.head_dim
    w = _draw([("tok_emb", (v, c), 0.02), ("head", (c, v), 0.02),
               ("wq", (l, c, c), 0.02), ("wk", (l, c, kvd), 0.02),
               ("wv", (l, c, kvd), 0.02), ("wo", (l, c, c), 0.02),
               ("router", (l, c, e), 0.02)],
              sub_seed(seed, 4), device, dtype)
    for k, (name, shape) in enumerate((("moe_wgate", (l, e, c, i)),
                                       ("moe_wup", (l, e, c, i)),
                                       ("moe_wdown", (l, e, i, c)))):
        w.update(_draw([(name, shape, 0.02)], sub_seed(seed, 5 + k),
                       device, dtype))
    ones = lambda *s: torch.ones(s, device=device, dtype=dtype)  # noqa: E731
    return {"tok_emb": w["tok_emb"], "lnf_s": ones(c), "head": w["head"],
            "h": {"ln1_s": ones(l, c), "wq": w["wq"], "wk": w["wk"],
                  "wv": w["wv"], "wo": w["wo"], "ln2_s": ones(l, c),
                  "router": w["router"], "moe_wgate": w["moe_wgate"],
                  "moe_wup": w["moe_wup"], "moe_wdown": w["moe_wdown"]}}


def speakable_head(params: Dict) -> None:
    """Zero the head's columns but the byte tokenizer's printable ids
    (id = byte + 1, bytes 0x20..0x7e; eos 0 among the zeroed), as
    ``chip_smoke.speakable_head`` does: a random head would almost never
    pick a byte id, so greedy replies are printable text."""
    head = params["head"]
    keep = torch.zeros(head.shape[-1], dtype=head.dtype, device=head.device)
    keep[0x20 + 1:0x7e + 2] = 1
    head.mul_(keep)
