"""Torch models of the algorithms inside kernels K1 and K4, on the CPU.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them against
their plain versions there).  These tests replay each kernel's own order of
work in plain torch, so the partition, the empty partials, the fragment
mapping and the fixed reduction orders are checked here against the port's
plain versions and the JAX package:

* K1 (``csrc/decode_attention.cu``): the rows 0..pos split over the NB
  blocks of a head's cluster by the device's ``pos`` (8-row tiles), 8-row
  warp tiles with the warp's running max (base-2 online softmax), the warps
  merged in warp order, the blocks in rank order, and an empty block's
  partial ``(-inf, 0)`` weighted 0.
* K4 (``csrc/int4_matmul.cu``): the ``mma.sync`` m16n8k16 B fragment built
  from packed bytes (packed row ``i0 + t`` holds logical k rows
  ``2(i0 + t)`` and ``2(i0 + t) + 1``), one f32 product per k16 step, the
  k-warp groups folded in group order and the split-K partials of the
  cluster summed in rank order.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmvox_tpu.ops import attention as jattn
from llmvox_tpu.ops import quant as jq
from llmvox_tpu.ops.pallas_attn import pallas_decode_attention
from llmvox_tpu.ops.pallas_quant import pallas_int4_matmul
from llmvox_tpu_torch.ops import attention as tattn
from llmvox_tpu_torch.ops import cuda_attn, cuda_int4_mm
from llmvox_tpu_torch.ops import quant as tq

# f32 sums in another order than the plain einsum's (K1's limit on the card)
K1_TOL = dict(atol=2e-5, rtol=1e-5)
# K4's limits (tests/test_torch_quant.py): exact bf16 products summed in
# f32 in another order; a bf16 output may differ by one bf16 ulp
K4_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
          torch.bfloat16: dict(atol=2e-5, rtol=2 ** -7)}


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------

def k1_partition(n: int, nb: int, n_warps: int = 8, rows: int = 8):
    """Each block's rows [b0, b1) of 0..n-1 and how many blocks have rows,
    as the kernel computes them from the device's ``pos``: rank 0 alone
    while the rows fit one ``rows``-row tile a warp, else equal shares
    rounded up to whole tiles."""
    if n <= rows * n_warps:
        return [(0, n)] + [(n, n)] * (nb - 1), 1
    chunk = -(-(-(-n // nb)) // rows) * rows
    used = -(-n // chunk)
    return [(r * chunk, min(n, r * chunk + chunk)) for r in range(nb)], used


def _merge(parts):
    """Merge (m, l, acc) partials in list order; one with l == 0 weighs 0
    (exp2 is never taken of -inf - -inf)."""
    live = [m for m, l, _ in parts if l > 0]
    big = max(live) if live else -math.inf
    weights = [torch.exp2(m - big) if l > 0 else torch.zeros(())
               for m, l, _ in parts]
    total = sum(l * w for (_, l, _), w in zip(parts, weights))
    acc = torch.zeros_like(parts[0][2])
    for (_, _, a), w in zip(parts, weights):
        if w != 0:
            acc = acc + a * w
    return big, total, acc


def k1_model(q, k, v, pos, n_head, nb, n_warps=8, rows=8):
    """K1 v2's order of work in f32: partition, warp tiles, merges."""
    s_len, c = k.shape
    d = c // n_head
    n = min(pos + 1, s_len)
    blocks, used = k1_partition(n, nb, n_warps, rows)
    covered = torch.zeros(s_len, dtype=torch.int32)
    out = torch.empty(c)
    scale = math.log2(math.e) / math.sqrt(d)
    for h in range(n_head):
        cols = slice(h * d, (h + 1) * d)
        qh = q[cols].float() * scale
        kh, vh = k[:, cols].float(), v[:, cols].float()
        block_parts = []
        for b0, b1 in blocks:
            warp_parts = []
            for w in range(n_warps):
                m = torch.tensor(-math.inf)
                l = torch.zeros(rows)            # one slot per quad of lanes
                acc = torch.zeros(rows, d)
                row0 = b0 + rows * w
                while row0 < b1:                 # this warp's tiles
                    vt = min(rows, b1 - row0)
                    if h == 0:
                        covered[row0:row0 + vt] += 1
                    sc = kh[row0:row0 + vt] @ qh
                    mt = sc.max()
                    if mt > m:                   # the warp's running max
                        alpha = torch.exp2(m - mt)
                        l, acc, m = l * alpha, acc * alpha, mt
                    p = torch.exp2(sc - m)
                    l[:vt] += p
                    acc[:vt] += p[:, None] * vh[row0:row0 + vt]
                    row0 += rows * n_warps
                warp_parts.append((m, l.sum(), acc.sum(0)))
            block_parts.append(_merge(warp_parts))
        _, total, acc = _merge(block_parts[:used])
        out[cols] = acc / total
    assert torch.equal(covered[:n], torch.ones(n, dtype=torch.int32))
    assert not covered[n:].any()
    return out.to(q.dtype)


def _k1_inputs(seed=11, s=512, c=256):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(c).astype(np.float32),
            rng.standard_normal((s, c)).astype(np.float32),
            rng.standard_normal((s, c)).astype(np.float32))


# warps a block: 8 at every head up to 200 bf16 or 100 f32 wide; 6 and 3
# for the f32 heads of 130 and 256 that chip_smoke.py holds on the card
@pytest.mark.parametrize("nb, n_warps", [(8, 8), (16, 8), (8, 6), (8, 3),
                                         (8, 2)])
@pytest.mark.parametrize("edge", ["0", "nb-1", "nb", "nb+1", "alone",
                                  "split", "odd", "S-1"])
def test_k1_model_matches_plain_and_jax(nb, n_warps, edge):
    """The partition's edges: one row, NB-1, NB and NB+1 rows, the last
    and the first row count past rank 0 alone (8 x warps), a pos+1 that
    no 8-row tile divides, and the last cache row."""
    q, k, v = _k1_inputs()
    s, h = k.shape[0], 4
    pos = {"0": 0, "nb-1": nb - 1, "nb": nb, "nb+1": nb + 1,
           "alone": 8 * n_warps - 1, "split": 8 * n_warps, "odd": 200,
           "S-1": s - 1}[edge]
    tq_, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    p = torch.tensor(pos, dtype=torch.int32)
    got = k1_model(tq_, tk, tv, pos, h, nb, n_warps)
    plain = tattn.decode_attention(tq_, tk, tv, p, n_head=h)
    ref = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.int32(pos), n_head=h,
                                 chunk=128)
    kern = pallas_decode_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.int32(pos), n_head=h,
                                   chunk=128, interpret=True)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **K1_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **K1_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), **K1_TOL)


@pytest.mark.parametrize("n, nb, want", [
    (1, 8, 1), (9, 8, 1), (64, 8, 1), (65, 8, 5), (101, 8, 7),
    (101, 16, 13), (8192, 8, 8), (8192, 16, 16), (100, 16, 13)])
def test_k1_partition_shares_rows_by_pos(n, nb, want):
    """Blocks with rows, as the kernel's note states them (pos < 64: rank 0
    alone; pos 100: 7 of 8 blocks; pos 8191: all); shares are whole 8-row
    tiles except the last."""
    blocks, used = k1_partition(n, nb)
    assert used == want
    assert blocks[0][0] == 0 and blocks[used - 1][1] == n
    for b0, b1 in blocks[:used - 1]:
        assert (b1 - b0) % 8 == 0 and b1 - b0 > 0
    assert all(b0 >= b1 for b0, b1 in blocks[used:])


def test_k1_merge_weighs_an_empty_partial_zero():
    acc = torch.arange(4.0)
    empty = (torch.tensor(-math.inf), torch.zeros(()), torch.zeros(4))
    m, l, a = _merge([(torch.tensor(3.0), torch.tensor(2.0), acc), empty])
    assert m == 3.0 and l == 2.0 and torch.equal(a, acc)
    m, l, a = _merge([empty, empty])
    assert m == -math.inf and l == 0 and not a.isnan().any()


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------

def k4_b_tile(q, s, i0, i_end, rpg):
    """The (16, Cout) B operand of the k16 step at packed row i0, built as
    the lanes build it: lane (g, t) of an n8 tile holds, for column g,
    register 0 = bf16x2 of byte q[i0 + t] (k rows 2t, 2t+1) and register 1
    = bf16x2 of byte q[i0 + 4 + t] (k rows 2t + 8, 2t + 9), each nibble
    scaled in f32 by its own row's group scale and rounded to bf16."""
    p, cout = q.shape
    b = torch.zeros(16, cout)
    for t in range(4):
        for reg in range(2):
            i = i0 + 4 * reg + t
            if i >= i_end:
                continue                      # zero-filled in shared memory
            byte = q[i].to(torch.int32)
            lo, hi = (byte << 28) >> 28, byte >> 4
            sc = s[min(i // rpg, s.shape[0] - 1), 0].float()
            b[8 * reg + 2 * t] = (lo.float() * sc).to(torch.bfloat16).float()
            b[8 * reg + 2 * t + 1] = (hi.float() * sc).to(
                torch.bfloat16).float()
    return b


def k4_model(x, q, s, n_split=8, n_kw=1):
    """K4 v2's order of work: each rank's share of packed rows, one f32
    m16n8k16 product per k16 step (x rounded to bf16), the k-warp groups
    folded in group order, the ranks' partials summed in rank order."""
    p, cout = q.shape
    rpg = p // s.shape[0]
    xb = x.to(torch.bfloat16).float()
    m = x.shape[0]
    chunk = -(-(-(-p // n_split)) // 8) * 8
    out = torch.zeros(m, cout)
    for r in range(n_split):
        i_begin, i_end = r * chunk, min(p, r * chunk + chunk)
        groups = [torch.zeros(m, cout) for _ in range(n_kw)]
        for step in range(max(0, -(-(i_end - i_begin) // 8))):
            i0 = i_begin + 8 * step
            a = torch.zeros(m, 16)
            width = min(16, 2 * (i_end - i0))
            a[:, :width] = xb[:, 2 * i0:2 * i0 + width]
            groups[step % n_kw] += a @ k4_b_tile(q, s, i0, i_end, rpg)
        fold = groups[1] if n_kw > 1 else None
        for g in groups[2:]:
            fold = fold + g
        part = groups[0] + fold if fold is not None else groups[0]
        out = out + part
    return out.to(x.dtype)


def _k4_weight(cin, cout, group, dtype, seed=5):
    w = (0.02 * np.random.default_rng(seed).standard_normal((cin, cout))
         ).astype(np.float32)
    jw = jq.quantize_weight4(jnp.asarray(w), group)
    jdt = jnp.float32 if dtype is torch.float32 else jnp.bfloat16
    jw = jq.Int4Tensor(jw.q, jw.s.astype(jdt))
    q = torch.from_numpy(np.array(jw.q))
    s = torch.from_numpy(np.array(jw.s.astype(jnp.float32))).to(dtype)
    return jw, q, s


@pytest.mark.parametrize("cin, group", [(256, 64), (96, 48), (768, 256),
                                        (64, 6)])
def test_k4_fragment_registers_are_the_logical_rows(cin, group):
    """Register 0 of lane (g, t) is packed byte i0 + t, i.e. logical rows
    2(i0 + t) and 2(i0 + t) + 1: the B tile of step i0 is logical rows
    2 i0 .. 2 i0 + 15 of the dequantized weight (bf16-rounded), for scale
    groups that start inside a k16 step too (group 6: 3 packed rows)."""
    w = tq.quantize_weight4(
        torch.randn(cin, 40, generator=torch.Generator().manual_seed(cin)),
        group)
    q, s = w.q, w.s
    p = q.shape[0]
    rpg = p // s.shape[0]
    dense = (tq.unpack_int4(q).float().reshape(s.shape[0], -1, 40) * s
             ).to(torch.bfloat16).float().reshape(cin, 40)
    for i0 in range(0, p, 8):
        b = k4_b_tile(q, s, i0, p, rpg)
        rows = min(16, 2 * (p - i0))
        assert torch.equal(b[:rows], dense[2 * i0:2 * i0 + rows])
        assert not b[rows:].any()


# (M, Cin, Cout, group, k-warp groups): every served M, several scale
# groups (one that ends inside a k16 step), ranks with no rows (Cin 96:
# 48 packed rows over 8 ranks of 8), and the 4-group fold of wproj
K4_PLANS = [(1, 256, 128, 64, 1), (5, 96, 32, 48, 1), (16, 512, 64, 32, 2),
            (48, 768, 96, 256, 1), (80, 3072, 48, 256, 4),
            (3, 64, 16, 6, 1)]


@pytest.mark.parametrize("m, cin, cout, group, n_kw", K4_PLANS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_model_matches_plain_and_pallas(m, cin, cout, group, n_kw,
                                           dtype):
    x = np.random.default_rng(m + cin).standard_normal((m, cin)).astype(
        np.float32)
    jw, q, s = _k4_weight(cin, cout, group, dtype)
    tx = torch.from_numpy(x).to(dtype)
    got = k4_model(tx, q, s, n_kw=n_kw)
    plain = cuda_int4_mm.plain_int4_matmul(tx, q, s)
    jdt = jnp.float32 if dtype is torch.float32 else jnp.bfloat16
    want = np.asarray(pallas_int4_matmul(jnp.asarray(x, jdt), jw,
                                         interpret=True).astype(jnp.float32))
    assert got.dtype == dtype and got.shape == (m, cout)
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                               **K4_TOL[dtype])
    np.testing.assert_allclose(got.float().numpy(), want, **K4_TOL[dtype])


def _cancelling_rows(wb, n_rows, rng):
    """Row r of x made so that output (r, r % Cout) sums to about 0 from
    terms that are not: the first half of the products all take one sign
    and the second half the other, scaled to cancel the first (the
    running f32 sum climbs to ~Cin/2 * E|x w| and comes back)."""
    cin, cout = wb.shape
    h = cin // 2
    x = np.zeros((n_rows, cin))
    for r in range(n_rows):
        col = wb[:, r % cout].numpy()
        a = rng.uniform(0.5, 1.5, cin)
        s1 = (np.abs(col[:h]) * a[:h]).sum()
        s2 = (np.abs(col[h:]) * a[h:]).sum()
        x[r, :h] = np.sign(col[:h]) * a[:h]
        x[r, h:] = -np.sign(col[h:]) * a[h:] * s1 / s2
    return x


def test_k4_f32_bound_holds_where_the_fixed_tolerance_is_too_tight():
    """Phase 11's f32 check of K4 (``chip_smoke.k4_f32_check``) on K4's
    replayed order of work at Cin 14336 (the Llama's wdown, groups of 256,
    8 ranks, 4 k-warp groups): K4's model and the plain version each lie
    within sqrt(Cin) * 2^-24 * sum |x||w| of the f64 product at every
    output; on rows whose outputs cancel to about 0 they part from each
    other by more than the old fixed 1e-5 (absolute and relative)."""
    import chip_smoke
    cin, cout = 14336, 16
    w = tq.quantize_weight4(0.02 * torch.randn(
        cin, cout, generator=torch.Generator().manual_seed(11)), 256)
    wb = tq.dequantize(w, torch.float32).to(torch.bfloat16).double()
    rng = np.random.default_rng(12)
    x = torch.from_numpy(np.concatenate([
        _cancelling_rows(wb, 16, rng),
        rng.standard_normal((16, cin))]).astype(np.float32))
    got = k4_model(x, w.q, w.s, n_kw=4)
    r = chip_smoke.k4_f32_check(x, w.q, w.s, got, "k4 model, Cin 14336")
    assert r["k4_ratio"] <= 1.0 and r["plain_ratio"] <= 1.0
    assert r["old_tol_fails"] > 0, r
    assert r["max_abs_err"] > 1e-5, r


# ---------------------------------------------------------------------------
# the wrappers: CPU path and refusals unchanged
# ---------------------------------------------------------------------------

def test_k1_wrapper_cpu_path_is_the_plain_version_and_counts_nothing():
    q, k, v = (torch.from_numpy(a) for a in _k1_inputs(3, 64, 32))
    p = torch.tensor(40, dtype=torch.int32)
    before = cuda_attn.LAUNCHES
    got = cuda_attn.decode_attention(q, k, v, p, 4)
    assert torch.equal(got, tattn.decode_attention(q, k, v, p, n_head=4))
    assert cuda_attn.LAUNCHES == before
    assert cuda_attn.CLUSTER == 8


def _k1_bad(case):
    q, k = torch.zeros(64), torch.zeros(16, 64)
    v, p = k.clone(), torch.zeros((), dtype=torch.int32)
    if case == "q_2d":
        q = q[None]
    elif case == "cache_shapes":
        v = v[:8]
    elif case == "width":
        q = torch.zeros(32)
    elif case == "heads_do_not_divide":
        return q, k, v, p, 3
    elif case == "head_dim_over_256":
        q, k, v = torch.zeros(512), torch.zeros(4, 512), torch.zeros(4, 512)
        return q, k, v, p, 1
    elif case == "float16":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "mixed_dtypes":
        k = k.bfloat16()
    elif case == "pos_int64":
        p = p.long()
    elif case == "pos_two":
        p = torch.zeros(2, dtype=torch.int32)
    elif case == "not_contiguous":
        k = torch.zeros(64, 16).t()
    return q, k, v, p, 4


@pytest.mark.parametrize("case", [
    "q_2d", "cache_shapes", "width", "heads_do_not_divide",
    "head_dim_over_256", "float16", "mixed_dtypes", "pos_int64", "pos_two",
    "not_contiguous"])
def test_k1_wrapper_check_refuses_what_the_kernel_does_not_take(case):
    """The checks the CUDA path runs before a launch (``_check``)."""
    with pytest.raises(ValueError):
        cuda_attn._check(*_k1_bad(case))


def test_k1_wrapper_check_takes_the_served_shapes():
    for dtype in (torch.float32, torch.bfloat16):
        q, k = torch.zeros(768, dtype=dtype), torch.zeros(64, 768,
                                                          dtype=dtype)
        cuda_attn._check(q, k, k, torch.zeros((), dtype=torch.int32), 8)
