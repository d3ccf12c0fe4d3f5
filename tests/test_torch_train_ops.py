"""The port's training forward (llmvox_tpu_torch/ops/attention.py's
causal attention, models/decoder.py's apply_decoder, decoder_loss and
sample_block) against the JAX package's, in f32 on the CPU, on the same
numpy inputs drawn from a seed."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmvox_tpu.models import decoder as jdec
from llmvox_tpu.ops import attention as jattn
from llmvox_tpu_torch.models import decoder as tdec
from llmvox_tpu_torch.ops import attention as tattn
from llmvox_tpu_torch.ops import ring_attention as tring
from llmvox_tpu_torch.utils.config import DecoderConfig as TDecoderConfig
from llmvox_tpu_torch.utils.params import to_torch

from tests.test_golden import GOLD_LOGITS_LAST6
from tests.tiny_stack import DEC_CFG

# the tiny stack with two draft heads and an EOA inside the vocab
HEADS_CFG = dataclasses.replace(DEC_CFG, n_draft_heads=2, eoa_token_id=15)


def _tcfg(jcfg, **kw):
    return TDecoderConfig(**{**{f.name: getattr(jcfg, f.name)
                                for f in dataclasses.fields(TDecoderConfig)},
                             **kw})


def _np(t):
    return t.detach().numpy()


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _params(seed, cfg):
    return jax.device_get(jdec.init_decoder_params(jax.random.PRNGKey(seed),
                                                   cfg))


def _segments(b, t, rng):
    """Random packed segment ids (1.. per row, 0 on a padded tail) and the
    positions within each segment."""
    seg = np.zeros((b, t), np.int32)
    pos = np.zeros((b, t), np.int32)
    for r in range(b):
        o, s = 0, 0
        end = t - int(rng.integers(0, t // 4))
        while o < end:
            n = min(int(rng.integers(1, t // 3)), end - o)
            s += 1
            seg[r, o:o + n] = s
            pos[r, o:o + n] = np.arange(n)
            o += n
    return seg, pos


# ---------------------------------------------------------------------------
# attention: forward and gradients, naive and blockwise, with and without
# segments.  f32 tolerances: 2e-5 forward (T=2048 sums), 1e-4 on the
# gradients (f32 reductions of 2048 terms in different orders)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,packed", [(64, False), (64, True),
                                      (2048, False), (2048, True)])
def test_causal_attention_matches_jax(t, packed):
    rng = np.random.default_rng(t + packed)
    b, h, d = 2, 2, 16
    q, k, v, w = (rng.standard_normal((b, t, h, d)).astype(np.float32)
                  for _ in range(4))
    seg = _segments(b, t, rng)[0] if packed else None

    def jloss(q, k, v):
        return jnp.sum(jattn.causal_attention_auto(
            q, k, v, segments=None if seg is None else jnp.asarray(seg)) * w)

    jout = jattn.causal_attention_auto(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        segments=None if seg is None else jnp.asarray(seg))
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    tout = tattn.causal_attention_auto(
        tq, tk, tv, segments=None if seg is None else torch.tensor(seg))
    (tout * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(_np(tout), np.asarray(jout), atol=2e-5,
                               rtol=1e-5)
    for g, tx in zip(jgrads, (tq, tk, tv)):
        np.testing.assert_allclose(_np(tx.grad), np.asarray(g), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("packed", [False, True])
def test_blockwise_attention_equals_naive(packed):
    """Above the flash threshold the CPU path takes JAX's blockwise tiles
    (block_q 512, block_k 1024); at T=2048 it equals the naive path."""
    rng = np.random.default_rng(5)
    b, t, h, d = 1, 2048, 2, 8
    q, k, v = (torch.tensor(rng.standard_normal((b, t, h, d)),
                            dtype=torch.float32) for _ in range(3))
    seg = torch.tensor(_segments(b, t, rng)[0]) if packed else None
    flash = tattn.flash_causal_attention(q, k, v, segments=seg)
    naive = tattn.causal_attention(q, k, v, segments=seg)
    np.testing.assert_allclose(_np(flash), _np(naive), atol=2e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# apply_decoder and decoder_loss
# ---------------------------------------------------------------------------

def test_apply_decoder_gold_logits():
    """The JAX golden anchor, on the seed-7 JAX params (atol 1e-6 as
    tests/test_golden.py holds JAX)."""
    params = to_torch(_params(7, DEC_CFG), "cpu")
    emb = torch.linspace(-1, 1, 2 * 6 * DEC_CFG.n_embd).reshape(2, 6, -1)
    logits = tdec.apply_decoder(params, emb, _tcfg(DEC_CFG))
    np.testing.assert_allclose(_np(logits[1, -1, :6]), GOLD_LOGITS_LAST6,
                               atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("packed", [False, True])
def test_apply_decoder_and_hidden_match_jax(packed):
    rng = np.random.default_rng(21)
    params = _params(21, HEADS_CFG)
    emb = rng.standard_normal((2, 24, DEC_CFG.n_embd)).astype(np.float32)
    seg, pos = _segments(2, 24, rng) if packed else (None, None)
    jl, jh = jdec.apply_decoder(
        params, jnp.asarray(emb), HEADS_CFG, return_hidden=True,
        segments=None if seg is None else jnp.asarray(seg),
        positions=None if pos is None else jnp.asarray(pos))
    tl, th = tdec.apply_decoder(
        to_torch(params, "cpu"), torch.tensor(emb), _tcfg(HEADS_CFG),
        return_hidden=True,
        segments=None if seg is None else torch.tensor(seg),
        positions=None if pos is None else torch.tensor(pos))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(th), np.asarray(jh), atol=1e-5, rtol=1e-5)


def _loss_case(seed, packed, heads=True):
    cfg = HEADS_CFG if heads else DEC_CFG
    rng = np.random.default_rng(seed)
    params = _params(seed, cfg)
    b, t = 2, 32
    emb = rng.standard_normal((b, t, cfg.n_embd)).astype(np.float32)
    tgt = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    seg, pos = _segments(b, t, rng) if packed else (None, None)
    if packed:
        tgt[seg == 0] = cfg.ignore_index
    else:
        tgt[1, 20:] = cfg.ignore_index
    return cfg, params, emb, tgt, seg, pos


@pytest.mark.parametrize("packed,heads", [(False, False), (False, True),
                                          (True, False), (True, True)])
def test_decoder_loss_and_grads_match_jax(packed, heads):
    """The loss to 1e-6 relative and every gradient to 2e-5 (absolute,
    against gradients of order 1e-2), with draft heads and packed."""
    cfg, params, emb, tgt, seg, pos = _loss_case(31, packed, heads)

    def jloss(p):
        return jdec.decoder_loss(
            p, jnp.asarray(emb), jnp.asarray(tgt), cfg, train=False,
            segments=None if seg is None else jnp.asarray(seg),
            positions=None if pos is None else jnp.asarray(pos))

    lj, gj = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, params))
    model = tdec.DecoderModel(params, _tcfg(cfg))
    lt = model(torch.tensor(emb), torch.tensor(tgt), train=False,
               segments=None if seg is None else torch.tensor(seg),
               positions=None if pos is None else torch.tensor(pos))
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-6)
    gt = {k: _np(v.grad) for k, v in _flat(model.tree()).items()}
    gj = _flat(jax.device_get(gj))
    assert gt.keys() == gj.keys()
    for k in gj:
        np.testing.assert_allclose(gt[k], gj[k], atol=2e-5, rtol=1e-4,
                                   err_msg=k)


def test_packed_loss_equals_its_unpacked_twin():
    """Two sentences packed into one row give the loss (draft heads
    included) of the same two sentences in rows of their own."""
    cfg = _tcfg(HEADS_CFG)
    rng = np.random.default_rng(41)
    params = to_torch(_params(41, HEADS_CFG), "cpu")
    n1, n2, t = 9, 13, 24
    e = torch.tensor(rng.standard_normal((n1 + n2, cfg.n_embd)),
                     dtype=torch.float32)
    codes = torch.tensor(rng.integers(0, cfg.vocab_size, n1 + n2),
                         dtype=torch.int32)
    packed_emb = torch.zeros(1, t, cfg.n_embd)
    packed_emb[0, :n1 + n2] = e
    packed_tgt = torch.full((1, t), cfg.ignore_index, dtype=torch.int32)
    packed_tgt[0, :n1 + n2] = codes
    seg = torch.zeros(1, t, dtype=torch.int32)
    seg[0, :n1], seg[0, n1:n1 + n2] = 1, 2
    pos = torch.zeros(1, t, dtype=torch.int32)
    pos[0, :n1], pos[0, n1:n1 + n2] = torch.arange(n1), torch.arange(n2)
    lp = tdec.decoder_loss(params, packed_emb, packed_tgt, cfg, train=False,
                           segments=seg, positions=pos)
    un_emb = torch.zeros(2, t, cfg.n_embd)
    un_emb[0, :n1], un_emb[1, :n2] = e[:n1], e[n1:]
    un_tgt = torch.full((2, t), cfg.ignore_index, dtype=torch.int32)
    un_tgt[0, :n1], un_tgt[1, :n2] = codes[:n1], codes[n1:]
    # the unpacked mean weighs every position as the packed one does
    logits, hidden = tdec.apply_decoder(params, un_emb, cfg,
                                        return_hidden=True)
    lu = tdec._masked_ce(logits, un_tgt, cfg.ignore_index)
    aux = 0.0
    for j in range(cfg.n_draft_heads):
        sh = torch.nn.functional.pad(un_tgt[:, j + 1:], (0, j + 1),
                                     value=cfg.ignore_index)
        aux = aux + tdec._masked_ce(hidden @ params["draft_heads"][j], sh,
                                    cfg.ignore_index)
    lu = lu + 0.2 * aux / cfg.n_draft_heads
    np.testing.assert_allclose(float(lp), float(lu), rtol=1e-6)


def test_remat_layers_equal_non_remat():
    cfg, params, emb, tgt, seg, pos = _loss_case(51, packed=True)
    grads = []
    for remat in (False, True):
        model = tdec.DecoderModel(params, _tcfg(cfg, remat_layers=remat,
                                                dropout=0.1))
        gen = torch.Generator().manual_seed(3)
        loss = model(torch.tensor(emb), torch.tensor(tgt), generator=gen,
                     segments=torch.tensor(seg), positions=torch.tensor(pos))
        loss.backward()
        grads.append((float(loss.detach()), {k: _np(v.grad) for k, v in
                                    _flat(model.tree()).items()}))
    assert grads[0][0] == grads[1][0]
    for k in grads[0][1]:
        np.testing.assert_allclose(grads[1][1][k], grads[0][1][k],
                                   atol=1e-7, rtol=1e-6, err_msg=k)


def test_dropout_masks_by_distribution_and_off_at_zero():
    """p=0 (or eval, or no generator) is the plain forward; at p=0.3 the
    embedding dropout keeps ~70% of the entries, each scaled by 1/0.7,
    and two generators with one seed draw the same masks."""
    cfg0 = _tcfg(DEC_CFG)
    params = to_torch(_params(61, DEC_CFG), "cpu")
    emb = torch.randn(2, 40, cfg0.n_embd, generator=torch.Generator()
                      .manual_seed(0))
    plain = tdec.apply_decoder(params, emb, cfg0)
    gen = torch.Generator().manual_seed(1)
    np.testing.assert_array_equal(_np(tdec.apply_decoder(
        params, emb, cfg0, generator=gen, train=True)), _np(plain))
    cfg = _tcfg(DEC_CFG, dropout=0.3)
    np.testing.assert_array_equal(_np(tdec.apply_decoder(
        params, emb, cfg, train=False, generator=gen)), _np(plain))
    a = tdec.apply_decoder(params, emb, cfg, train=True,
                           generator=torch.Generator().manual_seed(7))
    b = tdec.apply_decoder(params, emb, cfg, train=True,
                           generator=torch.Generator().manual_seed(7))
    np.testing.assert_array_equal(_np(a), _np(b))
    assert not np.allclose(_np(a), _np(plain))
    x = torch.ones(200, 100, 32)
    keep = torch.rand(x.shape, generator=torch.Generator().manual_seed(2)) \
        < 0.7
    y = tdec._drop(x, keep, 0.3)
    frac = float((y != 0).float().mean())
    assert abs(frac - 0.7) < 0.01, frac
    np.testing.assert_allclose(_np(y[y != 0]), 1 / 0.7, rtol=1e-6)


def test_perm_is_refused_and_helpers_match_jax():
    """``decoder_loss(perm=)`` on one process (the rows run in zigzag
    order, the attention causal on their original positions) equals
    JAX's ``decoder_loss(perm=)`` through its zigzag ring on a (dp 1, sp
    2) mesh, and the loss without the perm, draft heads included; with a
    packed batch the perm is refused, as JAX asserts."""
    from jax.sharding import Mesh
    from llmvox_tpu.ops.ring_attention import make_zigzag_ring_attention
    cfg, params, emb, tgt, _, _ = _loss_case(71, packed=False)
    perm = tring.zigzag_permutation(32, 2)[0]
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("dp", "sp"))
    lj = jax.jit(lambda p: jdec.decoder_loss(
        p, jnp.asarray(emb), jnp.asarray(tgt), cfg, train=False,
        attn_fn=make_zigzag_ring_attention(mesh), perm=jnp.asarray(perm)))(
            jax.tree.map(jnp.asarray, params))
    tp, tc = to_torch(params, "cpu"), _tcfg(cfg)
    lt = tdec.decoder_loss(tp, torch.tensor(emb), torch.tensor(tgt), tc,
                           train=False, perm=perm)
    plain = tdec.decoder_loss(tp, torch.tensor(emb), torch.tensor(tgt), tc,
                              train=False)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)
    np.testing.assert_allclose(float(lt), float(plain), rtol=1e-6)
    _, _, pemb, ptgt, seg, pos = _loss_case(71, packed=True)
    with pytest.raises(ValueError, match="not composable with packed"):
        tdec.decoder_loss(tp, torch.tensor(pemb), torch.tensor(ptgt), tc,
                          segments=torch.tensor(seg),
                          positions=torch.tensor(pos), perm=perm)
    assert tdec.num_params(params) == jdec.num_params(params)
    assert (tdec.num_params(params, non_embedding=False)
            == jdec.num_params(params, non_embedding=False))
    cp, ccfg = tdec.crop_block_size(to_torch(params, "cpu"), _tcfg(cfg), 40)
    jp, jcfg = jdec.crop_block_size(params, cfg, 40)
    assert ccfg.block_size == jcfg.block_size == 40
    np.testing.assert_array_equal(_np(cp["wpe"]), np.asarray(jp["wpe"]))


# ---------------------------------------------------------------------------
# sample_block
# ---------------------------------------------------------------------------

def _sample_inputs(seed):
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda x: x + 0.3 * rng.standard_normal(x.shape).astype(np.float32),
        _params(seed, HEADS_CFG))
    table = rng.standard_normal((HEADS_CFG.text_vocab_size,
                                 HEADS_CFG.text_embed_dim)).astype(np.float32)
    codebook = rng.standard_normal((HEADS_CFG.vocab_size,
                                    HEADS_CFG.speech_embed_dim)
                                   ).astype(np.float32)
    window = rng.integers(3, 200, 16).astype(np.int32)
    return params, table, codebook, window


def _tstate(cfg):
    return tdec.init_decode_state(cfg, dtype=torch.float32)


def _targs(params, table, codebook, window, n_text=10, limit=16):
    return (to_torch(params, "cpu"), torch.tensor(table),
            torch.tensor(codebook), _tstate(_tcfg(HEADS_CFG)),
            torch.tensor(window), torch.tensor(n_text, dtype=torch.int32),
            torch.tensor(limit, dtype=torch.int32))


def test_sample_block_top_k_1_is_decode_block():
    params, table, codebook, window = _sample_inputs(81)
    cfg = _tcfg(HEADS_CFG)
    greedy, n, _ = tdec.decode_block(*_targs(params, table, codebook, window),
                                     cfg, block=16)
    got, m, _ = tdec.sample_block(*_targs(params, table, codebook, window),
                                  torch.Generator().manual_seed(0), 1.0, cfg,
                                  block=16, top_k=1)
    assert int(n) == int(m) > 0
    np.testing.assert_array_equal(got.numpy(), greedy.numpy())


@pytest.mark.parametrize("top_k", [None, 3])
def test_sample_block_with_jax_noise_equals_jax(top_k):
    """JAX's own Gumbel noise (the keys its scan splits, drawn the way
    ``jax.random.categorical`` draws them) gives JAX's tokens."""
    params, table, codebook, window = _sample_inputs(91)
    key = jax.random.PRNGKey(5)
    temp, block = 0.8, 12
    jstate = jdec.init_decode_state(HEADS_CFG, dtype=jnp.float32)
    jtok, jn, _ = jdec.sample_block(
        jax.tree.map(jnp.asarray, params), jnp.asarray(table),
        jnp.asarray(codebook), jstate, jnp.asarray(window), jnp.int32(10),
        jnp.int32(block), key, temp, HEADS_CFG, block=block, top_k=top_k)
    noise, k = [], key
    for _ in range(block):
        k, sub = jax.random.split(k)
        noise.append(np.asarray(jax.random.gumbel(
            sub, (HEADS_CFG.vocab_size,), jnp.float32)))
    ttok, tn, _ = tdec.sample_block(
        *_targs(params, table, codebook, window, limit=block), None, temp,
        _tcfg(HEADS_CFG), block=block, top_k=top_k,
        gumbel=torch.tensor(np.stack(noise)))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    assert int(tn) == int(jn)


def test_sample_block_by_distribution():
    """The first token's frequencies over 3000 draws (generator seeds)
    against the softmax of the temperature-scaled, top-k filtered logits
    (each within 4 standard errors), and two seeds drawing different
    chains."""
    params, table, codebook, window = _sample_inputs(101)
    cfg = _tcfg(HEADS_CFG)
    temp, top_k, n = 2.0, 5, 3000
    args = _targs(params, table, codebook, window)
    x = tdec.nn.l2_normalize(torch.cat([args[1][window[0]],
                                        torch.zeros(cfg.speech_embed_dim)]))
    _, logits = tdec._decode_one(args[0], cfg, x, _tstate(cfg),
                                 return_logits=True)
    logits = logits / temp
    kth = torch.topk(logits, top_k).values[-1]
    probs = torch.softmax(logits.masked_fill(logits < kth, float("-inf")),
                          -1).numpy()
    gen = torch.Generator().manual_seed(0)
    counts = np.zeros(cfg.vocab_size)
    for _ in range(n):
        tok, _, _ = tdec.sample_block(
            *_targs(params, table, codebook, window, limit=1), gen, temp,
            cfg, block=1, top_k=top_k)
        counts[int(tok[0])] += 1
    freq = counts / n
    se = np.sqrt(probs * (1 - probs) / n) + 1e-9
    assert (np.abs(freq - probs) <= 4 * se + 1e-12).all(), (freq, probs)
    chains = [tdec.sample_block(*_targs(params, table, codebook, window),
                                torch.Generator().manual_seed(s), 1.0, cfg,
                                block=16)[0].numpy() for s in (1, 2)]
    assert (chains[0] != chains[1]).any()
