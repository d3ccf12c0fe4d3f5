"""The port's quantization (llmvox_tpu_torch/ops/quant.py) and kernel K4's
plain version and wrapper (ops/cuda_int4_mm.py) against the JAX package's,
on the CPU from the same numpy weights: the quantizers, ``dequantize``,
``int8_matmul``, K4 against ``pallas_int4_matmul`` in interpret mode (the
TPU route, which the port follows) and against JAX's CPU einsum (which it
does not), ``nn.linear``'s dispatch, ``to_torch`` on a quantized JAX
tree, and w8 / w8a8 / w4 greedy chains through ``decode_block``,
``decode_block_batch``, ``decode_block_spec`` and
``decode_block_spec_batch`` in f32.

JAX sends a 2-D ``Int4Tensor`` through kernel K4 only on a TPU
(``llmvox_tpu/ops/nn.py:144-149``) and through an exact f32 einsum
elsewhere.  The port follows K4, so for w4 JAX's decoder runs here on its
TPU route with K4 in interpret mode (``jax_route``: ``jax.default_backend``
and ``pallas_int4_matmul`` patched, the jit caches cleared before and
after); nothing in the JAX package changes."""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llmvox_tpu.ops.pallas_quant as jpallas_quant
from llmvox_tpu.models import decoder as jdec
from llmvox_tpu.ops import quant as jq
from llmvox_tpu.ops.pallas_quant import pallas_int4_matmul
from llmvox_tpu.utils.config import DecoderConfig as JDecoderConfig
from llmvox_tpu_torch.models import decoder as tdec
from llmvox_tpu_torch.ops import cuda_int4_mm, nn
from llmvox_tpu_torch.ops import quant as tq
from llmvox_tpu_torch.utils import config as tconfig
from llmvox_tpu_torch.utils.params import to_torch

from tests.tiny_stack import DEC_CFG

MODES = ("w8", "w8a8", "w4")
# tests/test_torch_spec.py's config: three draft heads, vocab 64
CFG = JDecoderConfig(n_layer=2, n_head=4, n_embd=64, block_size=128,
                     vocab_size=64, text_embed_dim=24, speech_embed_dim=40,
                     text_vocab_size=386, eoa_token_id=10_000,
                     n_draft_heads=3)
B = 4
BLOCK = 16
_PALLAS_INT4 = jpallas_quant.pallas_int4_matmul

# K4's kernel and plain version against Pallas: the bf16 x bf16 products
# are exact in f32, so in f32 only the order of the f32 sums differs; a
# bf16 output may differ by one bf16 ulp (K1-K3's limit)
K4_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
          torch.bfloat16: dict(atol=2e-5, rtol=2 ** -7)}


def _tcfg(cls, jcfg):
    return cls(**{f.name: getattr(jcfg, f.name)
                  for f in dataclasses.fields(cls)})


def _w(seed, shape, std=0.02):
    return (std * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# quantizers, dequantize, int8_matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape, group", [
    ((32, 96), 256), ((2, 64, 48), 16), ((768, 2304), 256),
    ((4, 3072, 768), 256), ((3, 40, 32), 7)])
def test_quantizers_match_jax_bit_for_bit(shape, group):
    """Same numpy weight: ``q`` bit-identical and ``s`` equal for w8, w8a8
    and w4 (one group per 256 rows, the one-group fallback, and several
    groups)."""
    w = _w(sum(shape), shape)
    for j, t in ((jq.quantize_weight(jnp.asarray(w)),
                  tq.quantize_weight(w)),
                 (jq.quantize_weight(jnp.asarray(w), cls=jq.Int8Linear),
                  tq.quantize_weight(w, cls=tq.Int8Linear)),
                 (jq.quantize_weight4(jnp.asarray(w), group),
                  tq.quantize_weight4(w, group))):
        j = jax.device_get(j)
        assert type(t).__name__ == type(j).__name__
        assert t.q.dtype == torch.int8 and t.s.dtype == torch.float32
        np.testing.assert_array_equal(t.q.numpy(), j.q)
        np.testing.assert_array_equal(t.s.numpy(), j.s)
        assert t.shape == tuple(j.shape)
        np.testing.assert_array_equal(
            tq.dequantize(t).numpy(), np.asarray(jq.dequantize(j)))
    assert tq.unpack_int4(t.q).shape == shape


def test_dequantize_in_bf16_and_layer_slices_match_jax():
    """Dequantizing in bf16 multiplies in bf16, as JAX does; ``w[layer]``
    is the layer's 2-D container (JAX's tree-aware slice)."""
    w = _w(3, (2, 512, 64))
    for jfn, tfn in ((jq.quantize_weight, tq.quantize_weight),
                     (jq.quantize_weight4, tq.quantize_weight4)):
        j, t = jax.device_get(jfn(jnp.asarray(w))), tfn(w)
        for layer in range(2):
            tl = t[layer]
            assert type(tl) is type(t) and tl.q.dim() == 2
            jl = jax.tree.map(lambda a: a[layer], j)
            got = tq.dequantize(tl, torch.bfloat16)
            want = np.asarray(jq.dequantize(jl, jnp.bfloat16), np.float32)
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("m, cin, cout", [(1, 768, 2304), (5, 3072, 768),
                                          (16, 32, 96), (80, 768, 768)])
def test_int8_matmul_matches_jax(m, cin, cout):
    """The int32 product is exact on both sides, so the outputs agree to
    1e-6; the port's int32 sums equal an int64 product."""
    x = 4.0 * _x(m, (m, cin))
    w = _w(cin, (cin, cout), std=0.5)
    jw = jax.device_get(jq.quantize_weight(jnp.asarray(w), cls=jq.Int8Linear))
    tw = tq.quantize_weight(w, cls=tq.Int8Linear)
    want = np.asarray(jq.int8_matmul(jnp.asarray(x), jw))
    got = tq.int8_matmul(torch.from_numpy(x), tw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    # the int32 sums themselves
    tx = torch.from_numpy(x)
    sx = tx.abs().amax(-1, keepdim=True).clamp_min(1e-8) / 127.0
    qx = torch.round(tx / sx).clamp(-127, 127).to(torch.int8)
    exact = qx.long() @ tw.q.long()
    assert torch.equal(tq._int_mm(qx, tw.q).long(), exact)
    # leading dims pass through
    got3 = tq.int8_matmul(tx.reshape(1, m, cin), tw)
    assert torch.equal(got3[0], torch.from_numpy(got))


# ---------------------------------------------------------------------------
# K4: plain version against Pallas (interpret) and against JAX's einsum
# ---------------------------------------------------------------------------

# (M, Cin, Cout, group): every served M, several groups, and one call per
# deployed weight shape (768->2304 wqkv, 768->768 wo, 768->3072 wfc,
# 3072->768 wproj, groups of 256)
K4_CASES = [(1, 256, 128, 64), (5, 256, 128, 32), (16, 512, 64, 128),
            (48, 128, 96, 128), (80, 256, 48, 16),
            (1, 768, 2304, 256), (5, 768, 768, 256), (16, 768, 3072, 256),
            (80, 3072, 768, 256)]


@pytest.mark.parametrize("m, cin, cout, group", K4_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_plain_matches_pallas_interpret(m, cin, cout, group, dtype):
    """x and scales in the served dtype (bf16 serving casts the scales to
    bf16, as JAX's engines do)."""
    x = _x(m + cin, (m, cin))
    jw = jq.quantize_weight4(jnp.asarray(_w(cout, (cin, cout))), group)
    jdt = jnp.float32 if dtype is torch.float32 else jnp.bfloat16
    jw = jq.Int4Tensor(jw.q, jw.s.astype(jdt))
    want = np.asarray(pallas_int4_matmul(jnp.asarray(x, jdt), jw,
                                         interpret=True).astype(jnp.float32))
    tx = torch.from_numpy(x).to(dtype)
    q = torch.from_numpy(np.array(jw.q))
    s = torch.from_numpy(np.array(jw.s.astype(jnp.float32))).to(dtype)
    got = cuda_int4_mm.plain_int4_matmul(tx, q, s)
    assert got.dtype == dtype and got.shape == (m, cout)
    assert s.shape == (cin // group, 1, cout)
    np.testing.assert_allclose(got.float().numpy(), want, **K4_TOL[dtype])


def test_k4_differs_from_jax_cpu_einsum():
    """JAX routes a 2-D Int4Tensor through K4 only on a TPU and through the
    exact f32 einsum ``int4_matmul`` elsewhere.  K4 rounds the activation
    and each dequantized weight to bf16, so the two differ: the gap is
    recorded here (relative norm ~2e-3, absolute up to ~1e-2 at the
    deployed shapes) and bounded by 1e-2 in relative norm."""
    gaps = []
    for m, cin, cout in ((1, 768, 2304), (16, 3072, 768)):
        x = _x(m, (m, cin))
        jw = jq.quantize_weight4(jnp.asarray(_w(cin, (cin, cout))))
        ein = np.asarray(jq.int4_matmul(jnp.asarray(x), jw))
        dense = np.asarray(jnp.dot(jnp.asarray(x), jq.dequantize(jw),
                                   precision="highest"))
        got = cuda_int4_mm.plain_int4_matmul(
            torch.from_numpy(x), torch.from_numpy(np.asarray(jw.q)),
            torch.from_numpy(np.asarray(jw.s))).numpy()
        np.testing.assert_allclose(ein, dense, atol=2e-5, rtol=1e-5)
        rel = np.linalg.norm(got - ein) / np.linalg.norm(ein)
        gaps.append((rel, np.abs(got - ein).max()))
        assert 1e-4 < rel < 1e-2, rel
    assert max(a for _, a in gaps) > 1e-3


# ---------------------------------------------------------------------------
# the wrapper and nn.linear's dispatch
# ---------------------------------------------------------------------------

def _k4_inputs(dtype=torch.float32, m=5, cin=256, cout=128, group=64):
    t = tq.quantize_weight4(_w(9, (cin, cout)), group)
    return torch.from_numpy(_x(8, (m, cin))).to(dtype), t.q, t.s.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_wrapper_on_cpu_takes_the_plain_version(dtype):
    x, q, s = _k4_inputs(dtype)
    before = cuda_int4_mm.LAUNCHES
    got = cuda_int4_mm.int4_matmul(x[None], q, s)
    assert got.shape == (1, 5, 128) and got.dtype == dtype
    assert torch.equal(got[0], cuda_int4_mm.plain_int4_matmul(x, q, s))
    # mixed: f32 activations against bf16 scales
    mixed = cuda_int4_mm.int4_matmul(x.float(), q, s.bfloat16())
    assert mixed.dtype == torch.float32
    assert cuda_int4_mm.LAUNCHES == before      # the CPU path counts none


def _bad(case):
    x, q, s = _k4_inputs()
    if case == "q_int32":
        q = q.to(torch.int32)
    elif case == "q_3d":
        q = q[None]
    elif case == "q_not_contiguous":
        q = q.t().contiguous().t()
    elif case == "s_2d":
        s = s[:, 0]
    elif case == "s_width":
        s = s[..., :64].contiguous()
    elif case == "s_float16":
        s = s.half()
    elif case == "groups_do_not_divide":
        s = torch.ones(3, 1, 128)
    elif case == "cout_not_16":
        q, s = q[:, :120].contiguous(), s[..., :120].contiguous()
    elif case == "x_width":
        x = x[:, :200]
    elif case == "x_float16":
        x = x.half()
    elif case == "x_empty":
        x = x[:0]
    elif case == "meta_device":
        x, q, s = (t.to("meta") for t in (x, q, s))
    elif case == "mixed_devices":
        s = s.to("meta")
    elif case == "unaligned_q":
        q = torch.zeros(q.numel() + 1, dtype=torch.int8)[1:].view(q.shape)
    return x, q, s


@pytest.mark.parametrize("case", [
    "q_int32", "q_3d", "q_not_contiguous", "s_2d", "s_width", "s_float16",
    "groups_do_not_divide", "cout_not_16", "x_width", "x_float16", "x_empty",
    "meta_device", "mixed_devices", "unaligned_q"])
def test_k4_wrapper_refuses_what_the_kernel_does_not_take(case):
    with pytest.raises(ValueError):
        cuda_int4_mm.int4_matmul(*_bad(case))


def test_linear_dispatches_on_every_container_like_jax(monkeypatch):
    """Int8Linear -> int8_matmul, a 2-D Int4Tensor -> K4's wrapper (here its
    plain version), QuantizedTensor -> dequantize in x's dtype; the
    outputs match JAX's ``linear`` on the same containers (w4 on its K4
    route, in interpret mode)."""
    from llmvox_tpu.ops import nn as jnn
    x = _x(1, (3, 64))
    w = _w(2, (64, 96))
    b = _x(3, (96,))
    calls = []
    real = cuda_int4_mm.int4_matmul

    def spy(*a):
        calls.append(a[1].shape)
        return real(*a)

    monkeypatch.setattr(cuda_int4_mm, "int4_matmul", spy)
    for mode in ("w8", "w8a8", "w4"):
        jtree = jq.quantize_decoder_params({"h": {"wfc": w}}, mode)
        twt = to_torch(jax.device_get(jtree), "cpu")["h"]["wfc"]
        assert type(twt).__name__ == type(jtree["h"]["wfc"]).__name__
        if mode == "w4":
            want = pallas_int4_matmul(jnp.asarray(x), jtree["h"]["wfc"],
                                      interpret=True) + b
        else:
            want = jnn.linear(jnp.asarray(x), jtree["h"]["wfc"],
                              jnp.asarray(b))
        got = nn.linear(torch.from_numpy(x), twt, torch.from_numpy(b))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
        for dt in (torch.float32, torch.bfloat16):
            dense = nn.dense_weight(twt, dt)
            assert dense.dtype == dt and dense.shape == (64, 96)
    assert calls == [(32, 96)]
    # a plain tensor is cast; a stacked (3-D) Int4Tensor is not K4's
    plain = torch.from_numpy(w)
    assert torch.equal(nn.dense_weight(plain, torch.float32), plain)
    stacked = tq.quantize_weight4(np.stack([w, w]))
    got = nn.linear(torch.from_numpy(x), stacked)
    assert got.shape == (2, 3, 96) and calls == [(32, 96)]


def test_to_torch_keeps_quantized_jax_containers():
    """``to_torch`` on ``jax.device_get(quantize_decoder_params(...))``:
    the containers survive as the port's, ``q`` stays int8 and ``s`` takes
    the param dtype; the head stays w8 and the draft heads dense."""
    import dataclasses
    cfg = dataclasses.replace(DEC_CFG, n_draft_heads=2)
    params = jax.device_get(jdec.init_decoder_params(jax.random.PRNGKey(0),
                                                     cfg))
    want = {"w8": "QuantizedTensor", "w8a8": "Int8Linear",
            "w4": "Int4Tensor"}
    for mode, name in want.items():
        jtree = jax.device_get(jq.quantize_decoder_params(params, mode))
        for dtype in (torch.float32, torch.bfloat16):
            tree = to_torch(jtree, "cpu", dtype)
            h = tree["h"]
            for k in ("wqkv", "wo", "wfc", "wproj"):
                assert type(h[k]).__name__ == name
                assert h[k].q.dtype == torch.int8 and h[k].s.dtype == dtype
                np.testing.assert_array_equal(h[k].q.numpy(), jtree["h"][k].q)
                layer = h[k][1]
                assert layer.q.dim() == 2 and layer.q.shape[0] == (
                    jtree["h"][k].q.shape[1])
            assert type(tree["head"]) is tq.QuantizedTensor
            assert tree["head"].s.dtype == dtype
            assert isinstance(tree["draft_heads"], torch.Tensor)
            assert tree["draft_heads"].dtype == dtype
            assert h["ln1_s"].dtype == dtype
        # the port's own quantizer gives the same tree
        mine = tq.quantize_decoder_params(params, mode)
        np.testing.assert_array_equal(mine["h"]["wo"].q.numpy(),
                                      jtree["h"]["wo"].q)
        assert tq.quantized_bytes(mine) == jq.quantized_bytes(jtree)
    with pytest.raises(ValueError, match="unknown quantization mode 'w3'"):
        tq.quantize_decoder_params(params, "w3")


# ---------------------------------------------------------------------------
# greedy chains on every decode path, JAX's w4 on its K4 route
# ---------------------------------------------------------------------------

class _JnpF32Dot:
    """``jax.numpy`` for the K4 kernel body in interpret mode, with its
    bf16 x bf16 -> f32 ``jnp.dot`` taken as the f32 dot of the same bf16
    values.  The result is the same (the products are exact in f32 and
    summed in f32), but this CPU build of XLA runs a BF16 x BF16 = F32 dot
    at some shapes only ("Unsupported element type for DotThunk")."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def dot(a, b, preferred_element_type=None):
        assert a.dtype == b.dtype == jnp.bfloat16
        assert preferred_element_type == jnp.float32
        return jnp.dot(a.astype(jnp.float32), b.astype(jnp.float32),
                       precision=jax.lax.Precision.HIGHEST)


@contextlib.contextmanager
def jax_route(mode):
    """JAX's deployed route for ``mode``: for w4, K4 (interpret mode)."""
    if mode != "w4":
        yield
        return
    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "default_backend", lambda: "tpu")
        mp.setattr(jpallas_quant, "pallas_int4_matmul",
                   functools.partial(_PALLAS_INT4, interpret=True))
        mp.setattr(jpallas_quant, "jnp", _JnpF32Dot())
        try:
            yield
        finally:
            jax.clear_caches()


def _noisy_params(cfg, seed):
    params = jax.device_get(jdec.init_decoder_params(jax.random.PRNGKey(seed),
                                                     cfg))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: x + 0.05 * rng.standard_normal(x.shape).astype(np.float32),
        params)


@pytest.fixture(scope="module")
def stack():
    params = _noisy_params(CFG, 0)
    rng = np.random.default_rng(0)
    table = (0.05 * rng.standard_normal(
        (CFG.text_vocab_size, CFG.text_embed_dim))).astype(np.float32)
    codebook = (0.05 * rng.standard_normal(
        (CFG.vocab_size, CFG.speech_embed_dim))).astype(np.float32)
    windows = rng.integers(0, 256, (B, BLOCK)).astype(np.int32)
    tlens = np.asarray([12, 5, 16, 0], np.int32)
    return params, table, codebook, windows, tlens


def _trees(params, mode):
    """(JAX's quantized tree, the port's, quantized by each side's own
    quantizer from the same numpy weights)."""
    return (jq.quantize_decoder_params(params, mode),
            to_torch(tq.quantize_decoder_params(params, mode), "cpu"))


# ---------------------------------------------------------------------------

def _jax_run(path, jp, table, codebook, w, tlens, lim):
    args = (jp, jnp.asarray(table), jnp.asarray(codebook))
    if path == "decode_block":
        out = []
        st = jdec.init_decode_state(CFG, jnp.float32)
        for b in range(2):
            toks, _, st = jdec.decode_block(
                *args, st, jnp.asarray(w[b]), jnp.int32(tlens[b]),
                jnp.int32(lim[b]), CFG, block=BLOCK)
            out.append(np.asarray(toks))
        return np.stack(out), None
    if path == "decode_block_spec":
        st = jdec.init_decode_state(CFG, jnp.float32)
        toks, _, st, iters = jdec.decode_block_spec(
            *args, st, jnp.asarray(w[0]), jnp.int32(tlens[0]),
            jnp.int32(lim[0]), CFG, block=BLOCK, k_draft=3)
        return np.asarray(toks)[None], np.asarray(iters).reshape(1)
    st = jdec.init_decode_state_batch(CFG, B, jnp.float32)
    run = (jnp.asarray(w), jnp.asarray(tlens), jnp.asarray(lim), CFG)
    if path == "decode_block_batch":
        toks, _, _ = jdec.decode_block_batch(*args, st, *run, block=BLOCK)
        return np.asarray(toks), None
    toks, _, _, iters = jdec.decode_block_spec_batch(
        *args, st, *run, block=BLOCK, k_draft=3)
    return np.asarray(toks), np.asarray(iters)


def _port_run(path, tp, table, codebook, w, tlens, lim):
    tcfg = _tcfg(tconfig.DecoderConfig, CFG)
    args = (tp, torch.from_numpy(table), torch.from_numpy(codebook))
    i32 = functools.partial(torch.tensor, dtype=torch.int32)
    if path == "decode_block":
        out = []
        st = tdec.init_decode_state(tcfg, torch.float32)
        for b in range(2):
            toks, _, st = tdec.decode_block(
                *args, st, torch.from_numpy(w[b]), i32(tlens[b]),
                i32(lim[b]), tcfg, block=BLOCK)
            out.append(toks.numpy())
        return np.stack(out), None
    if path == "decode_block_spec":
        st = tdec.init_decode_state(tcfg, torch.float32)
        toks, _, st, iters = tdec.decode_block_spec(
            *args, st, torch.from_numpy(w[0]), i32(tlens[0]), i32(lim[0]),
            tcfg, block=BLOCK, k_draft=3)
        return toks.numpy()[None], iters.numpy().reshape(1)
    st = tdec.init_decode_state_batch(tcfg, B, torch.float32)
    run = (torch.from_numpy(w), torch.from_numpy(tlens),
           torch.from_numpy(np.asarray(lim, np.int32)), tcfg)
    if path == "decode_block_batch":
        toks, _, _ = tdec.decode_block_batch(*args, st, *run, block=BLOCK)
        return toks.numpy(), None
    toks, _, _, iters = tdec.decode_block_spec_batch(
        *args, st, *run, block=BLOCK, k_draft=3)
    return toks.numpy(), iters.numpy()


PATHS = ("decode_block", "decode_block_batch", "decode_block_spec",
         "decode_block_spec_batch")


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("mode", MODES)
def test_quantized_greedy_chains_match_jax(stack, mode, path, monkeypatch):
    """Identical tokens (and spec iterations) on both sides, per-row limits
    included; a spec block's tokens are the batched greedy block's; every
    w4 linear of the port went through K4's wrapper, 4 per layer and
    forward."""
    params, table, codebook, w, tlens = stack
    lim = np.asarray([BLOCK, 9, BLOCK, 3], np.int32)
    jp, tp = _trees(params, mode)
    calls = []
    real = cuda_int4_mm.int4_matmul
    monkeypatch.setattr(cuda_int4_mm, "int4_matmul",
                        lambda *a: calls.append(1) or real(*a))
    with jax_route(mode):
        want, jit = _jax_run(path, jp, table, codebook, w, tlens, lim)
        greedy = (_jax_run("decode_block_batch", jp, table, codebook, w,
                           tlens, lim)[0] if "spec" in path else None)
    got, tit = _port_run(path, tp, table, codebook, w, tlens, lim)
    np.testing.assert_array_equal(got, want)
    if jit is not None:
        np.testing.assert_array_equal(tit, jit)
        np.testing.assert_array_equal(got, greedy[:len(got)])
    assert (got >= 0).sum() > 0
    assert len(calls) % (4 * CFG.n_layer) == 0
    assert (len(calls) > 0) == (mode == "w4")


def test_w4_chain_with_several_scale_groups_follows_the_k4_route():
    """At width 512 every w4 weight has 2 to 8 scale groups of 256.  The
    port's 16-token chain (one layer) equals JAX's on its K4 route, and its
    k-cache lies 30x nearer K4's than JAX's CPU einsum route does: the
    einsum is exact in f32, K4 rounds x and the weights to bf16 (with
    other weights the two routes' chains part)."""
    n = 16
    cfg = dataclasses.replace(CFG, n_layer=1, n_head=8, n_embd=512,
                              text_embed_dim=192, speech_embed_dim=320,
                              n_draft_heads=0)
    params = _noisy_params(cfg, 1)
    rng = np.random.default_rng(1)
    table = rng.standard_normal(
        (cfg.text_vocab_size, cfg.text_embed_dim)).astype(np.float32)
    codebook = rng.standard_normal(
        (cfg.vocab_size, cfg.speech_embed_dim)).astype(np.float32)
    w = rng.integers(0, 256, (n,)).astype(np.int32)
    jp, tp = _trees(params, "w4")
    assert tp["h"]["wproj"].s.shape == (1, 8, 1, 512)

    def jax_chain():
        toks, _, st = jdec.decode_block(
            jp, jnp.asarray(table), jnp.asarray(codebook),
            jdec.init_decode_state(cfg, jnp.float32), jnp.asarray(w),
            jnp.int32(n), jnp.int32(n), cfg, block=n)
        return np.asarray(toks), np.asarray(st.k_cache)

    with jax_route("w4"):
        want, kc = jax_chain()
    jax.clear_caches()
    _, kc_einsum = jax_chain()
    jax.clear_caches()
    tcfg = _tcfg(tconfig.DecoderConfig, cfg)
    got, _, st = tdec.decode_block(
        tp, torch.from_numpy(table), torch.from_numpy(codebook),
        tdec.init_decode_state(tcfg, torch.float32), torch.from_numpy(w),
        torch.tensor(n, dtype=torch.int32),
        torch.tensor(n, dtype=torch.int32), tcfg, block=n)
    np.testing.assert_array_equal(got.numpy(), want)
    # K4 rounds every activation to bf16, so a last-bit difference in an
    # f32 sum can move a rounding: the caches agree to bf16 level (3.6e-4
    # at most here); the einsum route's differ from K4's by 0.012
    gap = np.abs(st.k_cache.numpy() - kc).max()
    route_gap = np.abs(kc_einsum - kc).max()
    assert gap < 2e-3 and route_gap > 10 * gap, (gap, route_gap)
