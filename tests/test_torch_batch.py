"""The port's multi-stream decode against the JAX package's, on the tiny
stack, both sides in f32 on the CPU from the same numpy parameters: K2's
plain version and wrapper, ``decode_block_batch`` (and its edge at the
cache's last row), the ragged codec decode and ``BatchTTS``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmvox_tpu.codec.codec import WavCodec as JWavCodec
from llmvox_tpu.codec.codec import init_codec_params
from llmvox_tpu.models import decoder as jdec
from llmvox_tpu.ops.pallas_attn import pallas_batched_decode_attention
from llmvox_tpu.serve.batch import BatchTTS as JBatchTTS
from llmvox_tpu_torch.codec.codec import WavCodec as TWavCodec
from llmvox_tpu_torch.models import decoder as tdec
from llmvox_tpu_torch.ops import attention as tattn
from llmvox_tpu_torch.ops import cuda_batched_attn
from llmvox_tpu_torch.serve.batch import BatchTTS as TBatchTTS
from llmvox_tpu_torch.serve.engine import TTSEngine as TTTSEngine
from llmvox_tpu_torch.utils import config as tconfig
from llmvox_tpu_torch.utils.params import to_torch

from tests.tiny_stack import CODEC_CFG, DEC_CFG, SERVE_CFG

# the attention kernel tests' bound (tests/test_pallas_attn.py), and the
# whole-codec-decode bound of the port's other parity tests
ATTN_TOL = dict(atol=2e-5, rtol=1e-5)
CODEC_TOL = dict(atol=2e-3, rtol=1e-3)
BLOCK = 8


def _tcfg(cls, jcfg):
    return cls(**{f.name: getattr(jcfg, f.name)
                  for f in dataclasses.fields(cls)})


T_DEC = _tcfg(tconfig.DecoderConfig, DEC_CFG)
T_CODEC = _tcfg(tconfig.CodecConfig, CODEC_CFG)


@pytest.fixture(scope="module")
def stack():
    rng = np.random.default_rng(51)
    params = jax.device_get(
        jdec.init_decoder_params(jax.random.PRNGKey(51), DEC_CFG))
    params = jax.tree.map(
        lambda x: x + 0.3 * rng.standard_normal(x.shape).astype(np.float32),
        params)
    table = rng.standard_normal(
        (DEC_CFG.text_vocab_size, DEC_CFG.text_embed_dim)).astype(np.float32)
    codebook = rng.standard_normal(
        (DEC_CFG.vocab_size, DEC_CFG.speech_embed_dim)).astype(np.float32)
    codec = jax.device_get(init_codec_params(jax.random.PRNGKey(52),
                                             CODEC_CFG))
    return params, table, codebook, codec


# ---------------------------------------------------------------------------
# K2: plain version and wrapper
# ---------------------------------------------------------------------------

def _attn_inputs(seed=0, b=3, s=512, c=256):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, c)).astype(np.float32),
            rng.standard_normal((b, s, c)).astype(np.float32),
            rng.standard_normal((b, s, c)).astype(np.float32),
            np.asarray([0, 130, 400], np.int32))


def test_batched_attention_plain_matches_jax_and_pallas():
    """tests/test_pallas_attn.py's batched case: b=3, s=512, c=256, h=4."""
    q, k, v, pos = _attn_inputs()
    args = [jnp.asarray(a) for a in (q, k, v, pos)]
    ref = jdec._batched_decode_attention(*args, n_head=4, chunk=128)
    pal = pallas_batched_decode_attention(*args, n_head=4, chunk=128,
                                          interpret=True)
    got = tattn.batched_decode_attention(
        *(torch.from_numpy(a) for a in (q, k, v, pos)), n_head=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **ATTN_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(pal), **ATTN_TOL)


def test_batched_attention_rows_match_single_stream():
    """Row b of the batched version is K1's plain version on stream b."""
    q, k, v, pos = (torch.from_numpy(a) for a in _attn_inputs(1))
    got = tattn.batched_decode_attention(q, k, v, pos, n_head=4)
    for b in range(3):
        one = tattn.decode_attention(q[b], k[b], v[b], pos[b], n_head=4)
        np.testing.assert_allclose(got[b].numpy(), one.numpy(), **ATTN_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_on_cpu_takes_the_plain_version(dtype):
    q, k, v, pos = (torch.from_numpy(a) for a in _attn_inputs(2))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    before = cuda_batched_attn.LAUNCHES
    got = cuda_batched_attn.batched_decode_attention(q, k, v, pos, 4)
    want = tattn.batched_decode_attention(q, k, v, pos, n_head=4)
    assert got.dtype == dtype
    assert torch.equal(got, want)
    assert cuda_batched_attn.LAUNCHES == before   # the CPU path counts none


def _bad(case):
    q, k, v, pos = (torch.from_numpy(a) for a in _attn_inputs(3))
    if case == "cache_width":
        k = v = torch.zeros(3, 512, 260)
    elif case == "batch":
        q = torch.zeros(4, 256)
    elif case == "k_v_shapes":
        v = v[:, :256].contiguous()
    elif case == "float16":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "mixed_dtypes":
        k = k.bfloat16()
    elif case == "pos_int64":
        pos = pos.long()
    elif case == "pos_shape":
        pos = torch.zeros(4, dtype=torch.int32)
    elif case == "meta_device":
        q, k, v, pos = (t.to("meta") for t in (q, k, v, pos))
    elif case == "mixed_devices":
        pos = pos.to("meta")
    elif case == "not_contiguous":
        k = k.transpose(0, 1).contiguous().transpose(0, 1)
    return q, k, v, pos


@pytest.mark.parametrize("case", [
    "cache_width", "batch", "k_v_shapes", "float16", "mixed_dtypes",
    "pos_int64", "pos_shape", "meta_device", "mixed_devices",
    "not_contiguous"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    with pytest.raises(ValueError):
        cuda_batched_attn.batched_decode_attention(*_bad(case), 4)


# ---------------------------------------------------------------------------
# decode_block_batch
# ---------------------------------------------------------------------------

TEXTS = [list(range(40, 50)), list(range(60, 64)), list(range(70, 84))]
# per-block, per-row limits: pacing, a short row and a stalled row
LIMITS = [[BLOCK, BLOCK, 3], [5, BLOCK, BLOCK], [BLOCK, 2, 0]]


def _windows(pos):
    """Each row's window cut at its fetched position; slots past the text
    hold a non-PAD id, so only the decoder's PAD switch makes them PAD."""
    w = np.full((len(TEXTS), BLOCK), 99, np.int32)
    for i, ids in enumerate(TEXTS):
        avail = ids[pos[i]:pos[i] + BLOCK]
        w[i, :len(avail)] = avail
    return w


def _batch_chain(stack, jcfg, side):
    """Three chained batched blocks; returns (tokens per block (B, BLOCK),
    final state as numpy arrays)."""
    params, table, codebook, _ = stack
    b = len(TEXTS)
    text_lens = np.asarray([len(t) for t in TEXTS], np.int32)
    pos = np.zeros(b, np.int32)
    out = []
    if side == "jax":
        state = jdec.init_decode_state_batch(jcfg, b, jnp.float32)
        p = jax.tree.map(jnp.asarray, params)
    else:
        tcfg = _tcfg(tconfig.DecoderConfig, jcfg)
        state = tdec.init_decode_state_batch(tcfg, b, torch.float32)
        p = to_torch(params, "cpu")
    for limits in LIMITS:
        w, lim = _windows(pos), np.asarray(limits, np.int32)
        if side == "jax":
            toks, _, state = jdec.decode_block_batch(
                p, jnp.asarray(table), jnp.asarray(codebook), state,
                jnp.asarray(w), jnp.asarray(text_lens), jnp.asarray(lim),
                jcfg, block=BLOCK)
        else:
            toks, _, state = tdec.decode_block_batch(
                p, torch.from_numpy(table), torch.from_numpy(codebook),
                state, torch.from_numpy(w), torch.from_numpy(text_lens),
                torch.from_numpy(lim), tcfg, block=BLOCK)
        toks = np.asarray(toks)
        out.append(toks)
        pos += (toks >= 0).sum(axis=1).astype(np.int32)
    return out, [np.asarray(x) for x in state]


def _eoa_cfg(stack):
    """An EOA that row 0 first emits after its first block, so ``done`` is
    set mid-chain for it while other rows run on."""
    jout, _ = _batch_chain(stack, DEC_CFG, "jax")
    flat = [int(t) for blk in jout for t in blk[0] if t >= 0]
    late = [t for i, t in enumerate(flat)
            if i >= BLOCK and t not in flat[:i]]
    assert late, f"no late first-occurrence token in {flat}"
    return dataclasses.replace(DEC_CFG, eoa_token_id=late[0])


@pytest.mark.parametrize("eoa", [False, True])
def test_decode_block_batch_chains_match_jax(stack, eoa):
    cfg = _eoa_cfg(stack) if eoa else DEC_CFG
    jout, jstate = _batch_chain(stack, cfg, "jax")
    tout, tstate = _batch_chain(stack, cfg, "port")
    for jb, tb in zip(jout, tout):
        np.testing.assert_array_equal(tb, jb)
    jk, jv, jpos, jprev, jdone = jstate
    tk, tv, tpos, tprev, tdone = tstate
    np.testing.assert_array_equal(tpos, jpos)
    np.testing.assert_array_equal(tprev, jprev)
    np.testing.assert_array_equal(tdone, jdone)
    for i, p in enumerate(jpos):
        np.testing.assert_allclose(tk[:, i, :p + 1], jk[:, i, :p + 1],
                                   atol=1e-5)
        np.testing.assert_allclose(tv[:, i, :p + 1], jv[:, i, :p + 1],
                                   atol=1e-5)
    if eoa:
        assert jdone[0] and -1 in jout[-1][0], "EOA should end row 0 early"
        assert not jdone.all()


def test_decode_block_batch_rows_match_port_single_stream(stack):
    """Each row of the batched chain equals the port's own B=1
    ``decode_block`` fed that row's windows, text length and limits."""
    params, table, codebook, _ = stack
    cfg = _eoa_cfg(stack)
    tcfg = _tcfg(tconfig.DecoderConfig, cfg)
    tout, _ = _batch_chain(stack, cfg, "port")
    p, tt, tc = (to_torch(params, "cpu"), torch.from_numpy(table),
                 torch.from_numpy(codebook))
    for i, ids in enumerate(TEXTS):
        state, pos = tdec.init_decode_state(tcfg, torch.float32), 0
        for blk, limits in enumerate(LIMITS):
            w = np.full(BLOCK, 99, np.int32)
            avail = ids[pos:pos + BLOCK]
            w[:len(avail)] = avail
            toks, _, state = tdec.decode_block(
                p, tt, tc, state, torch.from_numpy(w),
                torch.tensor(len(ids), dtype=torch.int32),
                torch.tensor(limits[i], dtype=torch.int32), tcfg,
                block=BLOCK)
            np.testing.assert_array_equal(toks.numpy(), tout[blk][i])
            pos += int((toks >= 0).sum())


def test_decode_block_batch_at_the_last_cache_row_matches_jax(stack):
    """Row 0 starts at pos S-3 with limit 3: active steps at S-3, S-2 and
    S-1 (the last row) take it to pos S, and the block's remaining steps
    are inactive at pos S.  JAX drops an out-of-range cache scatter and
    clamps the ``wpe`` gather; the port must write nothing there either.
    Row 2 is inactive throughout."""
    params, table, codebook, _ = stack
    l, s, c = DEC_CFG.n_layer, DEC_CFG.block_size, DEC_CFG.n_embd
    rng = np.random.default_rng(53)
    k = rng.standard_normal((l, 3, s, c)).astype(np.float32)
    v = rng.standard_normal((l, 3, s, c)).astype(np.float32)
    pos = np.asarray([s - 3, 7, 0], np.int32)
    prev = np.asarray([2, 3, 0], np.int32)
    windows = rng.integers(0, 300, (3, BLOCK)).astype(np.int32)
    text_lens = np.asarray([s + 8, 20, 0], np.int32)
    limits = np.asarray([3, BLOCK, 0], np.int32)

    jst = jdec.DecodeState(*(jnp.asarray(a) for a in (k, v, pos, prev)),
                           jnp.zeros(3, bool))
    jtoks, jn, jst = jdec.decode_block_batch(
        jax.tree.map(jnp.asarray, params), jnp.asarray(table),
        jnp.asarray(codebook), jst, jnp.asarray(windows),
        jnp.asarray(text_lens), jnp.asarray(limits), DEC_CFG, block=BLOCK)
    tst = tdec.DecodeState(*(torch.from_numpy(a.copy())
                             for a in (k, v, pos, prev)),
                           torch.zeros(3, dtype=torch.bool))
    ttoks, tn, tst = tdec.decode_block_batch(
        to_torch(params, "cpu"), torch.from_numpy(table),
        torch.from_numpy(codebook), tst, torch.from_numpy(windows),
        torch.from_numpy(text_lens), torch.from_numpy(limits), T_DEC,
        block=BLOCK)

    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert list(np.asarray(jn)) == [3, BLOCK, 0]
    np.testing.assert_array_equal(tst.pos.numpy(), np.asarray(jst.pos))
    assert int(tst.pos[0]) == s
    np.testing.assert_array_equal(tst.prev_token.numpy(),
                                  np.asarray(jst.prev_token))
    np.testing.assert_allclose(tst.k_cache.numpy(), np.asarray(jst.k_cache),
                               atol=1e-5)
    np.testing.assert_allclose(tst.v_cache.numpy(), np.asarray(jst.v_cache),
                               atol=1e-5)
    # the active steps wrote rows S-3..S-1 of stream 0; nothing else moved
    # there
    assert not np.allclose(tst.k_cache.numpy()[:, 0, s - 1], k[:, 0, s - 1])
    np.testing.assert_array_equal(tst.k_cache.numpy()[:, 0, :s - 3],
                                  k[:, 0, :s - 3])


# ---------------------------------------------------------------------------
# ragged codec decode and BatchTTS
# ---------------------------------------------------------------------------

def test_decode_codes_ragged_matches_jax(stack):
    *_, codec = stack
    jc = JWavCodec(codec, CODEC_CFG, buckets=SERVE_CFG.chunk_buckets)
    tc = TWavCodec(codec, T_CODEC, buckets=SERVE_CFG.chunk_buckets,
                   device="cpu")
    rng = np.random.default_rng(54)
    lengths = np.asarray([5, 11, 3], np.int32)
    codes = np.zeros((3, 11), np.int32)
    for i, n in enumerate(lengths):
        codes[i, :n] = rng.integers(0, CODEC_CFG.vq_bins, n)
    jw = jc.decode_codes_ragged(codes, lengths)
    tw = tc.decode_codes_ragged(codes, lengths)
    for i, n in enumerate(lengths):
        assert tw[i].shape == jw[i].shape == (n * CODEC_CFG.hop_length,)
        np.testing.assert_allclose(tw[i], jw[i], **CODEC_TOL)
        exact = tc.decode_codes(codes[i:i + 1, :n], pad_to_bucket=False)
        np.testing.assert_allclose(tw[i], exact[0], **CODEC_TOL)


TTS_TEXTS = ["Hello there.", "A different longer sentence here.", "Hi."]


def test_tts_batch_matches_jax_batch_and_single_stream(stack):
    params, table, _, codec = stack
    jb = JBatchTTS(params, table,
                   JWavCodec(codec, CODEC_CFG, buckets=SERVE_CFG.chunk_buckets),
                   max_streams=4, dcfg=DEC_CFG, scfg=SERVE_CFG,
                   cache_dtype=jnp.float32)
    tscfg = _tcfg(tconfig.ServeConfig, SERVE_CFG)
    tcodec = TWavCodec(codec, T_CODEC, buckets=SERVE_CFG.chunk_buckets,
                       device="cpu")
    tb = TBatchTTS(params, table, tcodec, max_streams=4, dcfg=T_DEC,
                   scfg=tscfg, device="cpu", cache_dtype=torch.float32)
    jw = jb.tts_batch(TTS_TEXTS, max_tokens=20)
    tw = tb.tts_batch(TTS_TEXTS, max_tokens=20)
    for a, b in zip(tw, jw):
        assert a.shape == b.shape == (20 * CODEC_CFG.hop_length,)
        np.testing.assert_allclose(a, b, **CODEC_TOL)
    # tokens: every row equals the port's B=1 engine on the same text;
    # blocks of 8 up to the cap of 20, with 4 kept in flight
    steps0 = tb.decode_steps
    toks = tb.decode_texts(TTS_TEXTS, max_tokens=20)
    assert tb.decode_steps - steps0 == 3 * SERVE_CFG.decode_block
    eng = TTTSEngine(params, table, tcodec, T_DEC, tscfg, device="cpu",
                     cache_dtype=torch.float32)
    for text, row in zip(TTS_TEXTS, toks):
        assert eng.tts(text, max_tokens=20)[1] == row


def test_batch_refuses_a_mesh(stack):
    """The meshes BatchTTS refuses: one its streams do not divide over
    (JAX's assertion), and one with a tensor-parallel axis (only the dp
    axis is ported)."""
    from llmvox_tpu_torch.parallel import create_mesh
    params, table, _, codec = stack
    tcodec = TWavCodec(codec, T_CODEC, device="cpu")
    with pytest.raises(ValueError, match="4 streams not divisible over "
                                         "3-way dp mesh"):
        TBatchTTS(params, table, tcodec, max_streams=4, dcfg=T_DEC,
                  device="cpu", mesh=create_mesh(3, devices=["cpu"] * 3))
    with pytest.raises(ValueError, match="a dp mesh only"):
        TBatchTTS(params, table, tcodec, max_streams=4, dcfg=T_DEC,
                  device="cpu",
                  mesh=create_mesh(2, tp_size=2, devices=["cpu"] * 4))
