"""The port's speculative decode against the JAX package's, on the tiny
configs, both sides in f32 on the CPU from the same numpy parameters:
K3's plain version and wrapper, ``decode_block_spec_batch`` and
``decode_block_spec`` with oracle, garbage and draft-head drafts, per-row
limits, EOA, chained blocks, the cache's last rows and the loop's stop
rule."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmvox_tpu.models import decoder as jdec
from llmvox_tpu.ops.pallas_attn import pallas_verify_attention
from llmvox_tpu.utils.config import DecoderConfig as JDecoderConfig
from llmvox_tpu_torch.models import decoder as tdec
from llmvox_tpu_torch.ops import attention as tattn
from llmvox_tpu_torch.ops import cuda_verify_attn
from llmvox_tpu_torch.utils import config as tconfig
from llmvox_tpu_torch.utils.params import to_torch

# the attention kernel tests' bound (tests/test_pallas_attn.py); caches
# are compared at the port's decode tests' bound
ATTN_TOL = dict(atol=2e-5, rtol=1e-5)
CACHE_ATOL = 1e-5

# tests/test_decoder_spec_batch.py's config, with three draft heads
CFG = JDecoderConfig(n_layer=2, n_head=4, n_embd=64, block_size=128,
                     vocab_size=64, text_embed_dim=24, speech_embed_dim=40,
                     text_vocab_size=386, eoa_token_id=10_000,
                     n_draft_heads=3)
B = 4
BLOCK = 32


def _tcfg(jcfg):
    return tconfig.DecoderConfig(**{
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(tconfig.DecoderConfig)})


@pytest.fixture(scope="module")
def stack():
    params = jax.device_get(jdec.init_decoder_params(jax.random.PRNGKey(0),
                                                     CFG))
    rng = np.random.default_rng(0)
    table = (0.05 * rng.standard_normal(
        (CFG.text_vocab_size, CFG.text_embed_dim))).astype(np.float32)
    codebook = (0.05 * rng.standard_normal(
        (CFG.vocab_size, CFG.speech_embed_dim))).astype(np.float32)
    windows = rng.integers(0, 256, (B, BLOCK)).astype(np.int32)
    tlens = np.asarray([20, 5, 32, 0], np.int32)
    return params, table, codebook, windows, tlens


# ---------------------------------------------------------------------------
# K3: plain version and wrapper
# ---------------------------------------------------------------------------

def _verify_inputs(seed, b=4, n=5, s=512, c=256):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n, c)).astype(np.float32),
            rng.standard_normal((b, s, c)).astype(np.float32),
            rng.standard_normal((b, s, c)).astype(np.float32))


def _in_range(pos, n, s):
    """(B, n) mask of the queries at positions below S."""
    return (np.asarray(pos)[:, None] + np.arange(n)[None]) < s


# tests/test_pallas_attn.py's positions, a row at S-nq (the deepest whose
# queries all lie in the cache) and a row whose later queries pass S
@pytest.mark.parametrize("pos", [[0, 3, 100, 250], [5, 5, 5, 5],
                                 [507, 0, 300, 510]])
def test_verify_attention_plain_matches_jax_and_pallas(pos):
    n, s, h = 5, 512, 4
    q, k, v = _verify_inputs(sum(pos))
    p = np.asarray(pos, np.int32)
    args = [jnp.asarray(a) for a in (q, k, v, p)]
    ref = np.asarray(jdec._batched_verify_attention(*args, n_head=h,
                                                    chunk=128))
    got = tattn.batched_verify_attention(
        *(torch.from_numpy(a) for a in (q, k, v, p)), n_head=h).numpy()
    keep = _in_range(p, n, s)
    np.testing.assert_allclose(got[keep], ref[keep], **ATTN_TOL)
    for mxu in (False, True):
        pal = np.asarray(pallas_verify_attention(*args, n_head=h, chunk=128,
                                                 interpret=True, mxu=mxu))
        np.testing.assert_allclose(got[keep], pal[keep], **ATTN_TOL)
    assert np.isfinite(got).all()


def test_verify_attention_plain_on_bf16_layer_views_matches_jax():
    """tests/test_pallas_attn.py's (L, B, S, C) bf16 caches, one layer view
    at a time; the sums are f32 on both sides."""
    l_, b, n, s, c, h = 3, 2, 4, 256, 128, 2
    rng = np.random.default_rng(5)
    q = rng.standard_normal((b, n, c)).astype(np.float32)
    k = jnp.asarray(rng.standard_normal((l_, b, s, c)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((l_, b, s, c)), jnp.bfloat16)
    p = np.asarray([60, 200], np.int32)
    tk = torch.from_numpy(np.asarray(k, np.float32)).bfloat16()
    tv = torch.from_numpy(np.asarray(v, np.float32)).bfloat16()
    for layer in range(l_):
        ref = jdec._batched_verify_attention(
            jnp.asarray(q), k[layer], v[layer], jnp.asarray(p), n_head=h,
            chunk=128)
        got = tattn.batched_verify_attention(
            torch.from_numpy(q), tk[layer], tv[layer], torch.from_numpy(p),
            n_head=h)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **ATTN_TOL)


def test_verify_attention_rows_match_batched_decode_attention():
    """Query j of stream b is K2's plain version at position pos[b]+j."""
    q, k, v = (torch.from_numpy(a) for a in _verify_inputs(7))
    pos = torch.tensor([0, 40, 200, 507], dtype=torch.int32)
    got = tattn.batched_verify_attention(q, k, v, pos, n_head=4)
    for j in range(q.shape[1]):
        one = tattn.batched_decode_attention(q[:, j].contiguous(), k, v,
                                             pos + j, n_head=4)
        np.testing.assert_allclose(got[:, j].numpy(), one.numpy(),
                                   **ATTN_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_verify_wrapper_on_cpu_takes_the_plain_version(dtype):
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _verify_inputs(2))
    pos = torch.tensor([0, 3, 100, 510], dtype=torch.int32)
    before = cuda_verify_attn.LAUNCHES
    got = cuda_verify_attn.verify_attention(q, k, v, pos, 4)
    want = tattn.batched_verify_attention(q, k, v, pos, n_head=4)
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, want)
    assert cuda_verify_attn.LAUNCHES == before    # the CPU path counts none


def _bad(case):
    q, k, v = (torch.from_numpy(a) for a in _verify_inputs(3))
    pos = torch.tensor([0, 3, 100, 250], dtype=torch.int32)
    if case == "q_2d":
        q = q[:, 0].contiguous()
    elif case == "cache_width":
        k = v = torch.zeros(4, 512, 260)
    elif case == "batch":
        q = torch.zeros(3, 5, 256)
    elif case == "k_v_shapes":
        v = v[:, :256].contiguous()
    elif case == "too_many_queries":
        q = torch.zeros(4, cuda_verify_attn.MAX_QUERIES + 1, 256)
    elif case == "no_queries":
        q = torch.zeros(4, 0, 256)
    elif case == "head_dim":
        q, k, v = (torch.zeros(*t.shape[:-1], 2 * 264) for t in (q, k, v))
    elif case == "float16":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "mixed_dtypes":
        k = k.bfloat16()
    elif case == "pos_int64":
        pos = pos.long()
    elif case == "pos_shape":
        pos = torch.zeros(3, dtype=torch.int32)
    elif case == "meta_device":
        q, k, v, pos = (t.to("meta") for t in (q, k, v, pos))
    elif case == "mixed_devices":
        pos = pos.to("meta")
    elif case == "not_contiguous":
        q = q.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "head_row_bytes":
        q, k, v = (torch.zeros(*t.shape[:-1], 4 * 66) for t in (q, k, v))
    elif case == "unaligned_cache":
        k = torch.zeros(k.numel() + 1)[1:].view(k.shape)
    return q, k, v, pos


@pytest.mark.parametrize("case", [
    "q_2d", "cache_width", "batch", "k_v_shapes", "too_many_queries",
    "no_queries", "head_dim", "float16", "mixed_dtypes", "pos_int64",
    "pos_shape", "meta_device", "mixed_devices", "not_contiguous",
    "head_row_bytes", "unaligned_cache"])
def test_verify_wrapper_refuses_what_the_kernel_does_not_take(case):
    q, k, v, pos = _bad(case)
    heads = 2 if case == "head_dim" else 4
    with pytest.raises(ValueError):
        cuda_verify_attn.verify_attention(q, k, v, pos, heads)


# ---------------------------------------------------------------------------
# decode_block_spec_batch and decode_block_spec against JAX
# ---------------------------------------------------------------------------

def _jax_greedy(stack, limits, cfg=CFG, block=BLOCK, windows=None):
    params, table, codebook, w, tlens = stack
    w = w if windows is None else windows
    st = jdec.init_decode_state_batch(cfg, B, jnp.float32)
    toks, n, st = jdec.decode_block_batch(
        params, jnp.asarray(table), jnp.asarray(codebook), st,
        jnp.asarray(w), jnp.asarray(tlens), jnp.asarray(limits, jnp.int32),
        cfg, block=block)
    return np.asarray(toks), np.asarray(n), st


def _drafts(kind, greedy):
    if kind == "oracle":
        return np.maximum(greedy, 0).astype(np.int32)
    if kind == "garbage":
        # a constant code greedy never emits at the first draft slot
        code = 0 if not np.any(greedy[..., 1] == 0) else 1
        return np.full(greedy.shape, code, np.int32)
    return None                                    # the draft heads


def _spec_batch(stack, limits, drafts, side, cfg=CFG, k_draft=3,
                block=BLOCK, states=None, windows=None):
    """One spec block on either side; returns (tokens, n, state as numpy
    arrays, iters, issued iterations (the port's; None for JAX))."""
    params, table, codebook, w, tlens = stack
    w = w if windows is None else windows
    lim = np.asarray(limits, np.int32)
    if side == "jax":
        st = (jdec.init_decode_state_batch(cfg, B, jnp.float32)
              if states is None else states)
        toks, n, st, iters = jdec.decode_block_spec_batch(
            params, jnp.asarray(table), jnp.asarray(codebook), st,
            jnp.asarray(w), jnp.asarray(tlens), jnp.asarray(lim), cfg,
            block=block, k_draft=k_draft,
            draft_tokens=None if drafts is None else jnp.asarray(drafts))
        issued = None
    else:
        tcfg = _tcfg(cfg)
        st = (tdec.init_decode_state_batch(tcfg, B, torch.float32)
              if states is None else states)
        before = tdec.SPEC_ITERATIONS
        toks, n, st, iters = tdec.decode_block_spec_batch(
            to_torch(params, "cpu"), torch.from_numpy(table),
            torch.from_numpy(codebook), st, torch.from_numpy(w),
            torch.from_numpy(tlens), torch.from_numpy(lim), tcfg,
            block=block, k_draft=k_draft,
            draft_tokens=None if drafts is None else torch.from_numpy(drafts))
        issued = tdec.SPEC_ITERATIONS - before
    return (np.asarray(toks), np.asarray(n), st, np.asarray(iters), issued)


def _np_state(st):
    return [np.asarray(x) for x in st]


def _assert_states_equal(tst, jst):
    tk, tv, tpos, tprev, tdone = _np_state(tst)
    jk, jv, jpos, jprev, jdone = _np_state(jst)
    np.testing.assert_array_equal(tpos, jpos)
    np.testing.assert_array_equal(tprev, jprev)
    np.testing.assert_array_equal(tdone, jdone)
    if tk.ndim == 3:                  # B=1 state (L, S, C)
        tk, tv, jk, jv = (a[:, None] for a in (tk, tv, jk, jv))
        jpos = np.reshape(jpos, (1,))
    for b, p in enumerate(np.reshape(jpos, (-1,))):
        np.testing.assert_allclose(tk[:, b, :p], jk[:, b, :p],
                                   atol=CACHE_ATOL)
        np.testing.assert_allclose(tv[:, b, :p], jv[:, b, :p],
                                   atol=CACHE_ATOL)


@pytest.mark.parametrize("kind", ["oracle", "garbage", "heads"])
def test_spec_batch_matches_jax_and_greedy(stack, kind):
    limits = [BLOCK] * B
    greedy, n_greedy, _ = _jax_greedy(stack, limits)
    drafts = _drafts(kind, greedy)
    jt, jn, jst, jit, _ = _spec_batch(stack, limits, drafts, "jax")
    tt, tn, tst, tit, issued = _spec_batch(stack, limits, drafts, "port")
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tt, greedy)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(tn, n_greedy)
    np.testing.assert_array_equal(tit, jit)
    _assert_states_equal(tst, jst)
    # tests/test_decoder_spec_batch.py's bounds on the iterations
    if kind == "oracle":
        assert tit.max() <= int(np.ceil(BLOCK / 4)) + 1
    assert tit.max() <= BLOCK
    # the stop rule: at most one masked iteration past JAX's, none past
    # the block
    assert jit.max() <= issued <= min(jit.max() + 1, BLOCK)


def _eoa_cfg(stack):
    base, _, _ = _jax_greedy(stack, [BLOCK] * B)
    return base, dataclasses.replace(CFG, eoa_token_id=int(base[0, 7]))


def test_spec_batch_per_row_limits_and_eoa_match_jax(stack):
    """tests/test_decoder_spec_batch.py:113: heterogeneous limits, row 0
    reaches EOA at its eighth token; every row freezes on its own."""
    base, cfg = _eoa_cfg(stack)
    limits = [BLOCK, 1, 7, 19]
    want, n_want, gst = _jax_greedy(stack, limits, cfg=cfg)
    drafts = np.maximum(base, 0).astype(np.int32)
    jt, jn, jst, jit, _ = _spec_batch(stack, limits, drafts, "jax", cfg=cfg)
    tt, tn, tst, tit, issued = _spec_batch(stack, limits, drafts, "port",
                                           cfg=cfg)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tt, want)
    np.testing.assert_array_equal(tn, n_want)
    np.testing.assert_array_equal(tit, jit)
    _assert_states_equal(tst, jst)
    assert bool(np.asarray(tst.done)[0]) and np.asarray(gst.done)[0]
    assert jit.max() <= issued <= jit.max() + 1


def test_chained_spec_batch_matches_jax_and_chained_greedy(stack):
    """tests/test_decoder_spec_batch.py:135: three chained 16-token blocks
    with random per-row limits, oracle drafts, the state carried on."""
    params, table, codebook, _, tlens = stack
    tcfg = _tcfg(CFG)
    jg = jdec.init_decode_state_batch(CFG, B, jnp.float32)
    js = jdec.init_decode_state_batch(CFG, B, jnp.float32)
    ts = tdec.init_decode_state_batch(tcfg, B, torch.float32)
    rng = np.random.default_rng(1)
    for _ in range(3):
        w = rng.integers(0, 256, (B, 16)).astype(np.int32)
        lim = rng.integers(1, 17, (B,)).astype(np.int32)
        tg, _, jg = jdec.decode_block_batch(
            params, jnp.asarray(table), jnp.asarray(codebook), jg,
            jnp.asarray(w), jnp.asarray(tlens), jnp.asarray(lim), CFG,
            block=16)
        drafts = np.maximum(np.asarray(tg), 0).astype(np.int32)
        run = dict(windows=w, block=16, k_draft=4)
        jt, _, js, jit, _ = _spec_batch(stack, lim, drafts, "jax",
                                        states=js, **run)
        tt, _, ts, tit, _ = _spec_batch(stack, lim, drafts, "port",
                                        states=ts, **run)
        np.testing.assert_array_equal(tt, np.asarray(tg))
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(tit, jit)
    _assert_states_equal(ts, js)
    np.testing.assert_array_equal(ts.pos.numpy(), np.asarray(jg.pos))


def _spec_one(stack, row, limit, drafts, side, cfg=CFG, k_draft=3,
              block=BLOCK):
    params, table, codebook, w, tlens = stack
    args = (w[row], np.int32(tlens[row]), np.int32(limit))
    if side == "jax":
        st = jdec.init_decode_state(cfg, jnp.float32)
        toks, n, st, iters = jdec.decode_block_spec(
            params, jnp.asarray(table), jnp.asarray(codebook), st,
            *(jnp.asarray(a) for a in args), cfg, block=block,
            k_draft=k_draft,
            draft_tokens=None if drafts is None else jnp.asarray(drafts))
    else:
        tcfg = _tcfg(cfg)
        st = tdec.init_decode_state(tcfg, torch.float32)
        toks, n, st, iters = tdec.decode_block_spec(
            to_torch(params, "cpu"), torch.from_numpy(table),
            torch.from_numpy(codebook), st,
            *(torch.from_numpy(np.asarray(a)) for a in args), tcfg,
            block=block, k_draft=k_draft,
            draft_tokens=None if drafts is None else torch.from_numpy(drafts))
        assert toks.shape == (block,) and n.dim() == iters.dim() == 0
    return np.asarray(toks), int(n), st, int(iters)


@pytest.mark.parametrize("kind", ["oracle", "garbage", "heads"])
def test_spec_single_stream_matches_jax(stack, kind):
    """``decode_block_spec`` (B=1, through K3's path on a (L, 1, S, C)
    view) against JAX's, per stream of the batch fixture, with pacing
    limits; the tokens are greedy's."""
    base, cfg = _eoa_cfg(stack)
    limits = [BLOCK, 1, 7, 19]
    for row, limit in enumerate(limits):
        greedy = base[row]
        drafts = _drafts(kind, greedy)
        jt, jn, jst, jit = _spec_one(stack, row, limit, drafts, "jax")
        tt, tn, tst, tit = _spec_one(stack, row, limit, drafts, "port")
        np.testing.assert_array_equal(tt, jt, err_msg=f"row {row}")
        np.testing.assert_array_equal(tt[:limit], greedy[:limit])
        assert tn == jn == limit and tit == jit
        _assert_states_equal(tst, jst)
    # EOA mid-block: row 0 stops at its eighth token
    drafts = _drafts(kind, base[0])
    jt, jn, jst, jit = _spec_one(stack, 0, BLOCK, drafts, "jax", cfg=cfg)
    tt, tn, tst, tit = _spec_one(stack, 0, BLOCK, drafts, "port", cfg=cfg)
    np.testing.assert_array_equal(tt, jt)
    assert tn == jn == 8 and tit == jit and bool(tst.done)
    _assert_states_equal(tst, jst)


def test_chained_spec_single_stream_matches_jax(stack):
    """tests/test_decoder_spec.py:137: three chained 16-token blocks."""
    params, table, codebook, _, _ = stack
    tcfg = _tcfg(CFG)
    p, tt_, tc_ = (to_torch(params, "cpu"), torch.from_numpy(table),
                   torch.from_numpy(codebook))
    jg = jdec.init_decode_state(CFG, jnp.float32)
    js = jdec.init_decode_state(CFG, jnp.float32)
    ts = tdec.init_decode_state(tcfg, torch.float32)
    rng = np.random.default_rng(1)
    for _ in range(3):
        w = rng.integers(0, 256, (16,)).astype(np.int32)
        tg, _, jg = jdec.decode_block(params, jnp.asarray(table),
                                      jnp.asarray(codebook), jg,
                                      jnp.asarray(w), jnp.int32(40),
                                      jnp.int32(16), CFG, block=16)
        drafts = np.maximum(np.asarray(tg), 0).astype(np.int32)
        jt, _, js, jit = jdec.decode_block_spec(
            params, jnp.asarray(table), jnp.asarray(codebook), js,
            jnp.asarray(w), jnp.int32(40), jnp.int32(16), CFG, block=16,
            k_draft=4, draft_tokens=jnp.asarray(drafts))
        tt, _, ts, tit = tdec.decode_block_spec(
            p, tt_, tc_, ts, torch.from_numpy(w),
            torch.tensor(40, dtype=torch.int32),
            torch.tensor(16, dtype=torch.int32), tcfg, block=16, k_draft=4,
            draft_tokens=torch.from_numpy(drafts))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(tg))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        assert int(tit) == int(jit)
    _assert_states_equal(ts, js)


# ---------------------------------------------------------------------------
# the cache's last rows
# ---------------------------------------------------------------------------

def _near_capacity_state(seed, batch):
    """Random caches, stream 0 at pos S-8 (its 8-token block ends on the
    last cache row), the other streams well inside the cache."""
    rng = np.random.default_rng(seed)
    l, s, c = CFG.n_layer, CFG.block_size, CFG.n_embd
    k = rng.standard_normal((l, batch, s, c)).astype(np.float32)
    v = rng.standard_normal((l, batch, s, c)).astype(np.float32)
    pos = np.asarray([s - 8, 40, 90, 3][:batch], np.int32)
    prev = np.asarray([5, 9, 17, 2][:batch], np.int32)
    return k, v, pos, prev


@pytest.mark.parametrize("kind", ["oracle", "garbage", "heads"])
def test_spec_near_capacity_matches_jax_greedy(stack, kind):
    """From pos S-8 to the last row, queries of the later iterations pass
    S.  The port's B=1 and batched spec blocks give JAX greedy's tokens
    and committed rows, and the batched one JAX's batched spec block's.
    (JAX's B=1 ``decode_block_spec`` is not the reference here: its
    window of cache rows and ``wpe`` rows slides down when pos + k_draft
    + 1 > S, and it rewrites committed rows.)"""
    params, table, codebook, _, _ = stack
    s, blk = CFG.block_size, 8
    k, v, pos, prev = _near_capacity_state(11, B)
    rng = np.random.default_rng(12)
    w = rng.integers(0, 256, (B, blk)).astype(np.int32)
    tl = np.asarray([s + 8, 60, 100, 0], np.int32)
    lim = np.full((B,), blk, np.int32)
    jargs = (params, jnp.asarray(table), jnp.asarray(codebook))
    jst0 = jdec.DecodeState(*(jnp.asarray(a) for a in (k, v, pos, prev)),
                            jnp.zeros(B, bool))
    gt, _, gst = jdec.decode_block_batch(
        *jargs, jst0, jnp.asarray(w), jnp.asarray(tl), jnp.asarray(lim), CFG,
        block=blk)
    gt = np.asarray(gt)
    assert int(np.asarray(gst.pos)[0]) == s
    drafts = _drafts(kind, gt)
    dj = None if drafts is None else jnp.asarray(drafts)
    jt, _, jst, jit = jdec.decode_block_spec_batch(
        *jargs, jst0, jnp.asarray(w), jnp.asarray(tl), jnp.asarray(lim),
        CFG, block=blk, k_draft=3, draft_tokens=dj)

    tcfg = _tcfg(CFG)
    targs = (to_torch(params, "cpu"), torch.from_numpy(table),
             torch.from_numpy(codebook))
    tst0 = tdec.DecodeState(*(torch.from_numpy(a.copy())
                              for a in (k, v, pos, prev)),
                            torch.zeros(B, dtype=torch.bool))
    dt = None if drafts is None else torch.from_numpy(drafts)
    tt, _, tst, tit = tdec.decode_block_spec_batch(
        *targs, tst0, torch.from_numpy(w), torch.from_numpy(tl),
        torch.from_numpy(lim), tcfg, block=blk, k_draft=3, draft_tokens=dt)
    np.testing.assert_array_equal(tt.numpy(), gt)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tit.numpy(), np.asarray(jit))
    _assert_states_equal(tst, gst)
    _assert_states_equal(tst, jst)

    # stream 0 alone on the B=1 path, against JAX greedy at B=1
    jone = jdec.DecodeState(jnp.asarray(k[:, 0]), jnp.asarray(v[:, 0]),
                            jnp.int32(pos[0]), jnp.int32(prev[0]),
                            jnp.asarray(False))
    g1, _, g1st = jdec.decode_block(*jargs, jone, jnp.asarray(w[0]),
                                    jnp.int32(tl[0]), jnp.int32(blk), CFG,
                                    block=blk)
    tone = tdec.DecodeState(torch.from_numpy(k[:, 0].copy()),
                            torch.from_numpy(v[:, 0].copy()),
                            torch.tensor(pos[0]), torch.tensor(prev[0]),
                            torch.tensor(False))
    t1, n1, t1st, _ = tdec.decode_block_spec(
        *targs, tone, torch.from_numpy(w[0]),
        torch.tensor(tl[0]), torch.tensor(blk, dtype=torch.int32), tcfg,
        block=blk, k_draft=3,
        draft_tokens=None if dt is None else dt[0].contiguous())
    np.testing.assert_array_equal(t1.numpy(), np.asarray(g1))
    assert int(n1) == blk and int(t1st.pos) == s
    _assert_states_equal(t1st, g1st)
    np.testing.assert_array_equal(t1.numpy(), tt.numpy()[0])


@pytest.mark.parametrize("kind", ["garbage", "heads"])
def test_jax_single_stream_spec_near_capacity_is_not_the_reference(stack,
                                                                   kind):
    """Why the port's B=1 spec block follows the batched rule: from pos
    S-8, JAX's ``decode_block_spec`` takes its ``wpe`` rows and its cache
    window with a start-clamped slice (models/decoder.py:645, 705-708), so
    once an iteration's queries pass S the window slides down and rewrites
    committed rows, and its tokens leave greedy's.  The port's stay on
    greedy's (test_spec_near_capacity_matches_jax_greedy)."""
    params, table, codebook, _, _ = stack
    s, blk = CFG.block_size, 8
    k, v, pos, prev = _near_capacity_state(11, B)
    w = np.random.default_rng(12).integers(0, 256, (B, blk)).astype(np.int32)
    jargs = (params, jnp.asarray(table), jnp.asarray(codebook))
    one = jdec.DecodeState(jnp.asarray(k[:, 0]), jnp.asarray(v[:, 0]),
                           jnp.int32(pos[0]), jnp.int32(prev[0]),
                           jnp.asarray(False))
    run = (jnp.asarray(w[0]), jnp.int32(s + 8), jnp.int32(blk), CFG)
    g, _, gst = jdec.decode_block(*jargs, one, *run, block=blk)
    drafts = _drafts(kind, np.asarray(g))
    t, _, st, _ = jdec.decode_block_spec(
        *jargs, one, *run, block=blk, k_draft=3,
        draft_tokens=None if drafts is None else jnp.asarray(drafts))
    gap = np.abs(np.asarray(st.k_cache) - np.asarray(gst.k_cache)).max()
    assert int(st.pos) == s and gap > 0.1
    assert not np.array_equal(np.asarray(t), np.asarray(g))
