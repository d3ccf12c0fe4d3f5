"""The port's decoder (llmvox_tpu_torch/models/decoder.py) against the JAX
decoder on the tiny stack's config, in f32 on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmvox_tpu.models import decoder as jdec
from llmvox_tpu_torch.models import decoder as tdec
from llmvox_tpu_torch.utils.config import DecoderConfig as TDecoderConfig
from llmvox_tpu_torch.utils.params import to_torch

from tests.tiny_stack import DEC_CFG

BLOCK = 8


def _tcfg(jcfg):
    return TDecoderConfig(**{f.name: getattr(jcfg, f.name)
                             for f in dataclasses.fields(TDecoderConfig)})


@pytest.fixture(scope="module")
def stack():
    rng = np.random.default_rng(11)
    params = jax.device_get(
        jdec.init_decoder_params(jax.random.PRNGKey(11), DEC_CFG))
    params = jax.tree.map(
        lambda x: x + 0.3 * rng.standard_normal(x.shape).astype(np.float32),
        params)
    table = rng.standard_normal(
        (DEC_CFG.text_vocab_size, DEC_CFG.text_embed_dim)).astype(np.float32)
    codebook = rng.standard_normal(
        (DEC_CFG.vocab_size, DEC_CFG.speech_embed_dim)).astype(np.float32)
    return params, table, codebook


def test_decode_one_logits_match(stack):
    params, _, _ = stack
    rng = np.random.default_rng(12)
    l, s, c = DEC_CFG.n_layer, DEC_CFG.block_size, DEC_CFG.n_embd
    k = rng.standard_normal((l, s, c)).astype(np.float32)
    v = rng.standard_normal((l, s, c)).astype(np.float32)
    x = rng.standard_normal(c).astype(np.float32)
    pos = 37
    jstate = jdec.DecodeState(jnp.asarray(k), jnp.asarray(v), jnp.int32(pos),
                              jnp.int32(3), jnp.bool_(False))
    jtok, jk, jv, jlogits = jdec._decode_one(
        jax.tree.map(jnp.asarray, params), DEC_CFG, jnp.asarray(x), jstate,
        return_logits=True)
    tstate = tdec.DecodeState(torch.from_numpy(k.copy()),
                              torch.from_numpy(v.copy()),
                              torch.tensor(pos, dtype=torch.int32),
                              torch.tensor(3, dtype=torch.int32),
                              torch.tensor(False))
    ttok, tlogits = tdec._decode_one(to_torch(params, "cpu"), _tcfg(DEC_CFG),
                                     torch.from_numpy(x), tstate,
                                     return_logits=True)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=1e-5)
    assert int(ttok) == int(jtok)
    np.testing.assert_allclose(tstate.k_cache.numpy(), np.asarray(jk),
                               atol=1e-5)
    np.testing.assert_allclose(tstate.v_cache.numpy(), np.asarray(jv),
                               atol=1e-5)


def _run_chain(decode, init, make_inputs, text_ids, limits):
    """Chained blocks, the window cut at the fetched position each time;
    returns (tokens per block, final state).  Window slots past the text
    hold a non-PAD id, so only the decoder's PAD switch at ``text_len``
    turns them into PAD."""
    state, pos, out = init(), 0, []
    for limit in limits:
        window = np.full(BLOCK, 99, np.int32)
        avail = text_ids[pos:pos + BLOCK]
        window[:len(avail)] = avail
        toks, state = decode(state, *make_inputs(window, len(text_ids),
                                                 limit))
        toks = [int(t) for t in np.asarray(toks)]
        out.append(toks)
        pos += sum(t >= 0 for t in toks)
    return out, state


def _chains(stack, jcfg):
    params, table, codebook = stack
    text_ids = list(range(40, 50))   # 10 ids: the PAD switch at pos 10
    limits = [BLOCK, 5, BLOCK]       # pacing: a short middle block
    jp = jax.tree.map(jnp.asarray, params)

    def jdecode(state, w, tl, lim):
        toks, _, st = jdec.decode_block(jp, jnp.asarray(table),
                                        jnp.asarray(codebook), state, w, tl,
                                        lim, jcfg, block=BLOCK)
        return toks, st

    jout, jstate = _run_chain(
        jdecode, lambda: jdec.init_decode_state(jcfg, jnp.float32),
        lambda w, tl, lim: (jnp.asarray(w), jnp.int32(tl), jnp.int32(lim)),
        text_ids, limits)

    tcfg = _tcfg(jcfg)
    tp, tt, tc = (to_torch(params, "cpu"), torch.from_numpy(table),
                  torch.from_numpy(codebook))

    def tdecode(state, w, tl, lim):
        toks, _, st = tdec.decode_block(tp, tt, tc, state, w, tl, lim, tcfg,
                                        block=BLOCK)
        return toks, st

    tout, tstate = _run_chain(
        tdecode, lambda: tdec.init_decode_state(tcfg, torch.float32),
        lambda w, tl, lim: (torch.from_numpy(w),
                            torch.tensor(tl, dtype=torch.int32),
                            torch.tensor(lim, dtype=torch.int32)),
        text_ids, limits)
    return jout, jstate, tout, tstate


def test_decode_block_chains_identical_with_eoa(stack):
    # make the EOA a token that the chain first emits after its first
    # block, so `done` is set mid-chain
    jout, _, _, _ = _chains(stack, DEC_CFG)
    flat = [t for blk in jout for t in blk if t >= 0]
    late = [t for i, t in enumerate(flat)
            if i >= BLOCK and t not in flat[:i]]
    assert late, f"no late first-occurrence token in {flat}"
    cfg = dataclasses.replace(DEC_CFG, eoa_token_id=late[0])

    jout, jstate, tout, tstate = _chains(stack, cfg)
    assert tout == jout
    assert -1 in jout[-1], "EOA should end the last block early"
    pos = int(jstate.pos)
    assert int(tstate.pos) == pos
    assert int(tstate.prev_token) == int(jstate.prev_token) == late[0]
    assert bool(tstate.done) and bool(jstate.done)
    np.testing.assert_allclose(tstate.k_cache[:, :pos + 1].numpy(),
                               np.asarray(jstate.k_cache)[:, :pos + 1],
                               atol=1e-5)
    np.testing.assert_allclose(tstate.v_cache[:, :pos + 1].numpy(),
                               np.asarray(jstate.v_cache)[:, :pos + 1],
                               atol=1e-5)


def test_decode_block_without_eoa_runs_past_text(stack):
    """No EOA: every active step emits, the text switches to PAD after
    pos 10, and the short block's inactive steps emit -1."""
    jout, jstate, tout, tstate = _chains(stack, DEC_CFG)
    assert tout == jout
    assert [sum(t >= 0 for t in b) for b in tout] == [BLOCK, 5, BLOCK]
    assert int(tstate.pos) == int(jstate.pos) == 2 * BLOCK + 5
    assert not bool(tstate.done)
