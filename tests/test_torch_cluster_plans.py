"""Torch models of the algorithms inside kernels K2 and K3, on the CPU.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them against
their plain versions there).  These tests replay each kernel's own order of
work in plain torch, and hold it against the port's plain versions, the JAX
references and the Pallas kernels in interpret mode:

* K2 (``csrc/batched_decode_attention.cu``) is K1's design for each stream:
  the rows 0..pos[b] split over the cluster of a (head, stream) by that
  stream's own depth, 8-row warp tiles on four warps a block, the warps
  merged in warp order and the blocks in rank order
  (``test_torch_kernel_plans.k1_model``).
* K3 (``csrc/verify_attention.cu``): rows 0..min(pos[b] + nq - 1, S - 1)
  split over the cluster in 16-row tiles, four warps a block; the queries
  padded to the mma's 16 rows (rows j >= nq masked out of the output); per
  query the mask row <= pos[b] + j and a base-2 online softmax; in bf16 the
  value sum of P split into hi = bf16(P) and lo = bf16(P - hi); empty
  partials weighed 0; warps merged in warp order, blocks in rank order.
* ``ops/build.py`` names each library by a hash that covers the shared
  headers, and the wrappers refuse what the kernels do not take.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmvox_tpu.models import decoder as jdec
from llmvox_tpu.ops.pallas_attn import (pallas_batched_decode_attention,
                                        pallas_verify_attention)
from llmvox_tpu_torch.ops import attention as tattn
from llmvox_tpu_torch.ops import build, cuda_batched_attn, cuda_verify_attn

from tests.test_torch_kernel_plans import _merge, k1_model, k1_partition

# f32 sums in another order than the plain einsum's (K1's limit on the
# card); in bf16 the output is rounded once, so one bf16 ulp
TOL = {torch.float32: dict(atol=2e-5, rtol=1e-5),
       torch.bfloat16: dict(atol=2e-5, rtol=2 ** -7)}
S, C, H = 512, 256, 4
K3_TILE, K3_WARPS, MMA_ROWS = 16, 4, 16


def _inputs(seed, b, nq=None, dtype=torch.float32):
    """Numpy f32 inputs (rounded through ``dtype``) and their torch form."""
    rng = np.random.default_rng(seed)
    qshape = (b, C) if nq is None else (b, nq, C)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in (qshape, (b, S, C), (b, S, C))]
    ts = [torch.from_numpy(a).to(dtype) for a in arrs]
    return [t.float().numpy() for t in ts], ts


def _ragged(b, nq=1):
    """Per-stream depths: the partition's edges (rank 0 alone, the first
    split: 32 rows for K2, 64 for K3), rows that no tile divides, S - nq
    and the last rows."""
    base = [0, 1, 31, 32, 64 - nq, 64, 70, 100, 127, 200, 255, 333, 400,
            S - nq, S - 2, S - 1]
    return base[:b] if b < len(base) else base


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------

def k2_model(q, k, v, pos, n_head, nb=8, n_warps=4):
    """K2's order of work: K1's for each stream at its own depth."""
    return torch.stack([k1_model(q[b], k[b], v[b], int(pos[b]), n_head, nb,
                                 n_warps) for b in range(q.shape[0])])


@pytest.mark.parametrize("b", [1, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_model_matches_plain_jax_and_pallas(b, dtype):
    (q, k, v), (tq, tk, tv) = _inputs(21 + b, b, dtype=dtype)
    pos = np.asarray(_ragged(b) if b > 1 else [333], np.int32)
    tp = torch.from_numpy(pos)
    got = k2_model(tq, tk, tv, pos, H)
    plain = tattn.batched_decode_attention(tq, tk, tv, tp, n_head=H)
    args = [jnp.asarray(a) for a in (q, k, v, pos)]
    ref = np.asarray(jdec._batched_decode_attention(*args, n_head=H,
                                                    chunk=128))
    pal = np.asarray(pallas_batched_decode_attention(*args, n_head=H,
                                                     chunk=128,
                                                     interpret=True))
    assert got.dtype == dtype and got.shape == (b, C)
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                               **TOL[dtype])
    np.testing.assert_allclose(got.float().numpy(), ref, **TOL[dtype])
    np.testing.assert_allclose(got.float().numpy(), pal, **TOL[dtype])


@pytest.mark.parametrize("n, want", [(1, 1), (32, 1), (33, 5), (128, 8),
                                     (401, 8), (8192, 8)])
def test_k2_shares_rows_by_each_streams_depth(n, want):
    """A stream's blocks with rows follow its own depth: rank 0 alone up
    to one 8-row tile for each of four warps, whole tiles beyond."""
    blocks, used = k1_partition(n, 8, n_warps=4)
    assert used == want and blocks[used - 1][1] == n


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------

def k3_partition(n: int, nb: int = 8, n_warps: int = K3_WARPS,
                 tile: int = K3_TILE):
    """K3's share of rows 0..n-1 for each rank (``share_rows`` in
    ``csrc/attn_cluster.cuh``, 16-row tiles, rank 0 alone while the rows
    fit one tile a warp)."""
    return k1_partition(n, nb, n_warps, tile)


def k3_model(q, k, v, pos, n_head, nb=8, n_warps=K3_WARPS, hi_lo=False):
    """K3's order of work in f32: for each (stream, head) the cluster's
    shares of rows, each warp's 16-row tiles with the queries padded to 16
    mma rows, the per-query online softmax (base 2), the value sum (P as
    hi + lo bf16 terms with ``hi_lo``), the warps merged in warp order and
    the blocks in rank order.  Returns the output and the number of empty
    (query, block) partials among the blocks with rows."""
    bsz, nq, c = q.shape
    s_len = k.shape[1]
    d = c // n_head
    scale = math.log2(math.e) / math.sqrt(d)
    out = torch.empty(bsz, nq, c)
    empties = 0
    for b in range(bsz):
        p0 = int(pos[b])
        n = min(p0 + nq, s_len)
        blocks, used = k3_partition(n, nb, n_warps)
        qpos = p0 + torch.arange(MMA_ROWS)          # every mma row masked
        for h in range(n_head):
            cols = slice(h * d, (h + 1) * d)
            qh = torch.zeros(MMA_ROWS, d)
            qh[:nq] = q[b, :, cols].float()
            kh, vh = k[b, :, cols].float(), v[b, :, cols].float()
            block_parts = []
            for b0, b1 in blocks[:used]:
                warp_parts = []
                for w in range(n_warps):
                    m = torch.full((MMA_ROWS,), -math.inf)
                    l = torch.zeros(MMA_ROWS)
                    acc = torch.zeros(MMA_ROWS, d)
                    row0 = b0 + K3_TILE * w
                    while row0 < b1:
                        rows = row0 + torch.arange(K3_TILE)
                        live = (rows < b1)[None] & (rows[None] <=
                                                    qpos[:, None])
                        # rows past the share are zero-filled
                        inside = (rows < b1)[:, None]
                        kt = kh[rows.clamp(max=s_len - 1)] * inside
                        vt = vh[rows.clamp(max=s_len - 1)] * inside
                        sc = torch.where(live, (qh @ kt.T) * scale,
                                         -math.inf)
                        mt = torch.maximum(m, sc.max(1).values)
                        grow = mt > m
                        alpha = torch.where(grow, torch.exp2(m - mt),
                                            torch.ones(()))
                        l, acc, m = l * alpha, acc * alpha[:, None], mt
                        p = torch.where(sc == -math.inf, torch.zeros(()),
                                        torch.exp2(sc - m[:, None]))
                        l = l + p.sum(1)
                        if hi_lo:
                            hi = p.to(torch.bfloat16).float()
                            lo = (p - hi).to(torch.bfloat16).float()
                            acc = acc + hi @ vt
                            acc = acc + lo @ vt
                        else:
                            acc = acc + p @ vt
                        row0 += K3_TILE * n_warps
                    warp_parts.append((m, l, acc))
                block_parts.append([
                    _merge([(wm[j], wl[j], wa[j])
                            for wm, wl, wa in warp_parts])
                    for j in range(nq)])
                empties += sum(int(part[1] == 0) for part in block_parts[-1])
            for j in range(nq):
                _, total, acc = _merge([bp[j] for bp in block_parts])
                out[b, j, cols] = acc / total
    return out.to(q.dtype), empties


def _keep(pos, nq):
    return (np.asarray(pos)[:, None] + np.arange(nq)[None]) < S


@pytest.mark.parametrize("nq, b", [(1, 1), (3, 1), (5, 16), (13, 16),
                                   (13, 1), (5, 1)])
def test_k3_model_matches_plain_jax_and_pallas(nq, b):
    (q, k, v), (tq, tk, tv) = _inputs(31 + nq + b, b, nq)
    pos = np.asarray(_ragged(b, nq) if b > 1 else [S - nq], np.int32)
    got, _ = k3_model(tq, tk, tv, pos, H)
    plain = tattn.batched_verify_attention(tq, tk, tv, torch.from_numpy(pos),
                                           n_head=H)
    args = [jnp.asarray(a) for a in (q, k, v, pos)]
    ref = np.asarray(jdec._batched_verify_attention(*args, n_head=H,
                                                    chunk=128))
    keep = _keep(pos, nq)
    np.testing.assert_allclose(got.numpy()[keep], plain.numpy()[keep],
                               **TOL[torch.float32])
    np.testing.assert_allclose(got.numpy()[keep], ref[keep],
                               **TOL[torch.float32])
    for mxu in (True, False):
        pal = np.asarray(pallas_verify_attention(*args, n_head=H, chunk=128,
                                                 interpret=True, mxu=mxu))
        np.testing.assert_allclose(got.numpy()[keep], pal[keep],
                                   **TOL[torch.float32])
    assert np.isfinite(got.numpy()).all()


@pytest.mark.parametrize("nq", [1, 5, 13])
def test_k3_model_bf16_with_p_split_hi_lo_matches_plain(nq):
    """bf16 caches: the tensor-core path's P split into hi + lo bf16 terms
    stays within one bf16 ulp of the plain version (f32 sums, one
    rounding)."""
    _, (tq, tk, tv) = _inputs(41 + nq, 16, nq, torch.bfloat16)
    pos = np.asarray(_ragged(16, nq), np.int32)
    got, _ = k3_model(tq, tk, tv, pos, H, hi_lo=True)
    plain = tattn.batched_verify_attention(tq, tk, tv, torch.from_numpy(pos),
                                           n_head=H)
    keep = torch.from_numpy(_keep(pos, nq))
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got[keep].float(), plain[keep].float(),
                               **TOL[torch.bfloat16])


def test_k3_empty_partials_weigh_zero():
    """At pos 70 with 13 queries the rows 0..82 split into 16-row shares
    over six ranks; the early queries attend no row of the last ranks, so
    those (query, block) partials are empty, and the output still equals
    the plain version."""
    _, (tq, tk, tv) = _inputs(51, 1, 13)
    blocks, used = k3_partition(83)
    assert used == 6 and blocks[5] == (80, 83)
    got, empties = k3_model(tq, tk, tv, [70], H)
    assert empties > 0
    plain = tattn.batched_verify_attention(
        tq, tk, tv, torch.tensor([70], dtype=torch.int32), n_head=H)
    np.testing.assert_allclose(got.numpy(), plain.numpy(),
                               **TOL[torch.float32])


@pytest.mark.parametrize("n, want", [(1, 1), (64, 1), (65, 5), (132, 5),
                                     (8192, 8)])
def test_k3_shares_rows_in_16_row_tiles(n, want):
    """Rank 0 alone while the rows fit one 16-row tile for each of four
    warps; beyond, shares of whole tiles (pos 127 at nq 5: 132 rows over
    five ranks of 32)."""
    blocks, used = k3_partition(n)
    assert used == want and blocks[used - 1][1] == n
    for b0, b1 in blocks[:used - 1]:
        assert (b1 - b0) % K3_TILE == 0 and b1 > b0


# ---------------------------------------------------------------------------
# the build's hash and the wrappers' refusals
# ---------------------------------------------------------------------------

def test_editing_a_shared_header_changes_every_librarys_path(tmp_path,
                                                             monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    src = csrc / "kernel.cu"
    src.write_text('#include "shared.cuh"\n')
    hdr = csrc / "shared.cuh"
    hdr.write_text("// one\n")
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    assert build.headers() == [hdr] and build.sources() == [src]
    first = build._lib_path(src)
    assert build._lib_path(src) == first          # unchanged: reused
    hdr.write_text("// two\n")
    second = build._lib_path(src)
    assert second != first and second.name.startswith("libkernel-")
    src.write_text('#include "shared.cuh"\n// edited\n')
    assert build._lib_path(src) not in (first, second)


def test_k2_and_k3_share_the_cluster_header():
    names = {p.name for p in build.headers()}
    assert "attn_cluster.cuh" in names
    for stem in ("batched_decode_attention", "verify_attention"):
        text = (build.CSRC_DIR / f"{stem}.cu").read_text()
        assert '#include "attn_cluster.cuh"' in text
        assert "scratch_floats" not in text
    assert cuda_batched_attn.CLUSTER == cuda_verify_attn.CLUSTER == 8


def _k2_bad(case):
    q, k = torch.zeros(2, 64), torch.zeros(2, 16, 64)
    v, p = k.clone(), torch.zeros(2, dtype=torch.int32)
    heads = 4
    if case == "q_1d":
        q = q[0]
    elif case == "cache_shapes":
        v = v[:, :8]
    elif case == "batch":
        q = torch.zeros(3, 64)
    elif case == "heads_do_not_divide":
        heads = 3
    elif case == "head_dim_over_256":
        q, k = torch.zeros(2, 512), torch.zeros(2, 4, 512)
        v, heads = k.clone(), 1
    elif case == "float16":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "mixed_dtypes":
        k = k.bfloat16()
    elif case == "pos_int64":
        p = p.long()
    elif case == "pos_shape":
        p = torch.zeros(3, dtype=torch.int32)
    elif case == "not_contiguous":
        k = torch.zeros(2, 64, 16).transpose(1, 2)
    elif case == "too_many_streams":
        b = cuda_batched_attn.MAX_STREAMS + 1
        q, k = torch.zeros(b, 8), torch.zeros(b, 1, 8)
        v, p, heads = k.clone(), torch.zeros(b, dtype=torch.int32), 1
    elif case == "meta_device":
        q, k, v, p = (t.to("meta") for t in (q, k, v, p))
    return q, k, v, p, heads


@pytest.mark.parametrize("case", [
    "q_1d", "cache_shapes", "batch", "heads_do_not_divide",
    "head_dim_over_256", "float16", "mixed_dtypes", "pos_int64",
    "pos_shape", "not_contiguous", "too_many_streams", "meta_device"])
def test_k2_wrapper_refuses_what_the_kernel_does_not_take(case):
    with pytest.raises(ValueError):
        cuda_batched_attn.batched_decode_attention(*_k2_bad(case))


@pytest.mark.parametrize("case", ["too_many_streams", "q_not_4_aligned"])
def test_k3_wrapper_refuses_more_streams_and_an_odd_q(case):
    if case == "too_many_streams":
        b = cuda_verify_attn.MAX_STREAMS + 1
        q, k = torch.zeros(b, 1, 8), torch.zeros(b, 1, 8)
        heads = 1
    else:     # a bf16 q starting 2 bytes past a 4-byte boundary
        q = torch.zeros(2 * 3 * 64 + 1, dtype=torch.bfloat16)[1:].view(
            2, 3, 64)
        k, heads = torch.zeros(2, 16, 64, dtype=torch.bfloat16), 4
    p = torch.zeros(q.shape[0], dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_verify_attn.verify_attention(q, k, k.clone(), p, heads)


def test_k2_and_k3_wrappers_take_the_served_shapes_on_the_cpu():
    for dtype in (torch.float32, torch.bfloat16):
        q, k = torch.zeros(16, 768, dtype=dtype), torch.zeros(
            16, 32, 768, dtype=dtype)
        p = torch.full((16,), 31, dtype=torch.int32)
        cuda_batched_attn._check(q, k, k, p, 8)
        for nq in (1, 3, 5, 13, 16):
            cuda_verify_attn._check(torch.zeros(16, nq, 768, dtype=dtype),
                                    k, k, p, 8)
