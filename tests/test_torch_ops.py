"""The port's ops (llmvox_tpu_torch/ops) against the JAX package's, on the
CPU: the same numpy inputs, made from a seed, go through both."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from llmvox_tpu.ops import attention as jattn
from llmvox_tpu.ops import istft as jistft
from llmvox_tpu.ops import nn as jnn
from llmvox_tpu.ops.pallas_attn import pallas_decode_attention
from llmvox_tpu_torch.ops import attention as tattn
from llmvox_tpu_torch.ops import cuda_attn
from llmvox_tpu_torch.ops import istft as tistft
from llmvox_tpu_torch.ops import nn as tnn


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, ref, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref, np.float32), **tol)


@pytest.mark.parametrize("bias", [False, True])
def test_layer_norm(bias):
    rng = _rng(0)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3 + 1
    s = rng.standard_normal(48).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32) if bias else None
    ref = jnn.layer_norm(jnp.asarray(x), jnp.asarray(s),
                         None if b is None else jnp.asarray(b), 1e-5)
    got = tnn.layer_norm(_t(x), _t(s), None if b is None else _t(b), 1e-5)
    _close(got, ref, atol=1e-5)


@pytest.mark.parametrize("valid_len", [None, 7, [5, 11]])
def test_group_norm(valid_len):
    rng = _rng(1)
    x = rng.standard_normal((2, 11, 64)).astype(np.float32)
    s = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    jvl = None if valid_len is None else jnp.asarray(valid_len, jnp.int32)
    tvl = (valid_len if not isinstance(valid_len, list)
           else torch.tensor(valid_len, dtype=torch.int32))
    ref = jnn.group_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), 8,
                         1e-6, jvl)
    got = tnn.group_norm(_t(x), _t(s), _t(b), 8, 1e-6, tvl)
    _close(got, ref, atol=1e-5)


@pytest.mark.parametrize("groups,k,pad", [(1, 7, (3, 3)), (1, 3, (1, 1)),
                                          (24, 7, (3, 3)), (1, 3, (2, 0))])
def test_conv1d(groups, k, pad):
    rng = _rng(2)
    cin, cout = 24, 24 if groups > 1 else 16
    x = rng.standard_normal((2, 13, cin)).astype(np.float32)
    w = rng.standard_normal((k, cin // groups, cout)).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    ref = jnn.conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                     padding=[pad], groups=groups)
    got = tnn.conv1d(_t(x), _t(w), _t(b), padding=[pad], groups=groups)
    assert got.shape == ref.shape
    _close(got, ref, atol=1e-4)


def test_linear_f32_and_bf16():
    rng = _rng(3)
    x = rng.standard_normal((3, 40)).astype(np.float32)
    w = rng.standard_normal((40, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    ref = jnn.linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = tnn.linear(_t(x), _t(w), _t(b))
    _close(got, ref, atol=1e-4)
    # bf16 in gives bf16 out
    got16 = tnn.linear(_t(x).bfloat16(), _t(w).bfloat16())
    ref16 = jnn.linear(jnp.asarray(x, jnp.bfloat16),
                       jnp.asarray(w, jnp.bfloat16))
    assert got16.dtype == torch.bfloat16 and ref16.dtype == jnp.bfloat16
    _close(got16.float(), ref16, atol=0.25, rtol=2e-2)


@pytest.mark.parametrize("name", ["gelu_tanh", "gelu_exact", "swish",
                                  "l2_normalize"])
def test_elementwise(name):
    x = (_rng(4).standard_normal((4, 33)) * 3).astype(np.float32)
    x[0] = 0.0   # l2_normalize's eps branch
    ref = getattr(jnn, name)(jnp.asarray(x))
    got = getattr(tnn, name)(_t(x))
    _close(got, ref, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("valid_len", [None, 6])
def test_istft_same(valid_len):
    rng = _rng(5)
    n_fft, hop, t = 128, 32, 9
    nb = n_fft // 2 + 1
    spec = (rng.standard_normal((2, t, nb))
            + 1j * rng.standard_normal((2, t, nb))).astype(np.complex64)
    ref = jistft.istft_same(jnp.asarray(spec), n_fft=n_fft, hop_length=hop,
                            valid_len=valid_len)
    got = tistft.istft_same(_t(spec), n_fft=n_fft, hop_length=hop,
                            valid_len=valid_len)
    assert got.shape == ref.shape == (2, hop * t)
    keep = hop * (valid_len or t)
    _close(got[:, :keep], np.asarray(ref)[:, :keep], atol=1e-4)
    np.testing.assert_array_equal(tistft.hann_window(64),
                                  jistft.hann_window(64))


@pytest.mark.parametrize("pos", [0, 3, 127, 128, 300])
def test_decode_attention_f32(pos):
    rng = _rng(6)
    s, c, h = 512, 256, 4
    q = rng.standard_normal(c).astype(np.float32)
    k = rng.standard_normal((s, c)).astype(np.float32)
    v = rng.standard_normal((s, c)).astype(np.float32)
    p = torch.tensor(pos, dtype=torch.int32)
    got = tattn.decode_attention(_t(q), _t(k), _t(v), p, n_head=h)
    ref = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.int32(pos), n_head=h,
                                 chunk=128)
    kern = pallas_decode_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.int32(pos), n_head=h,
                                   chunk=128, interpret=True)
    _close(got, ref, atol=2e-5, rtol=1e-5)
    _close(got, kern, atol=2e-5, rtol=1e-5)
    # the K1 wrapper takes the plain version for CPU tensors
    _close(cuda_attn.decode_attention(_t(q), _t(k), _t(v), p, h), got,
           atol=0, rtol=0)


def test_decode_attention_bf16_cache():
    rng = _rng(7)
    s, c, h, pos = 256, 128, 2, 100
    q = rng.standard_normal(c).astype(np.float32)
    k = rng.standard_normal((s, c)).astype(np.float32)
    v = rng.standard_normal((s, c)).astype(np.float32)
    kb, vb = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
    ref = jattn.decode_attention(jnp.asarray(q), kb, vb, jnp.int32(pos),
                                 n_head=h, chunk=128)
    kern = pallas_decode_attention(jnp.asarray(q), kb, vb, jnp.int32(pos),
                                   n_head=h, chunk=128, interpret=True)
    got = tattn.decode_attention(_t(q), _t(k).bfloat16(), _t(v).bfloat16(),
                                 torch.tensor(pos, dtype=torch.int32),
                                 n_head=h)
    _close(got, ref, atol=2e-2, rtol=2e-2)
    _close(got, kern, atol=2e-2, rtol=2e-2)


def test_decode_attention_wrapper_refuses_other_devices():
    q = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_attn.decode_attention(q, q.reshape(1, 8), q.reshape(1, 8),
                                   torch.zeros((), dtype=torch.int32,
                                               device="meta"), 2)

