"""The port's ring attention (ops/ring_attention.py) and the collectives
of sequence parallelism and FSDP (parallel/mesh.py: the ring rotation,
``ppermute``, the all-gather and reduce-scatter along one dimension, by
both routes) against the JAX package's ``make_ring_attention`` and
``make_zigzag_ring_attention`` on the 8-device virtual mesh, in f32 on the
CPU.

Four gloo ranks are spawned once for the module (``ring`` fixture,
``tests/torch_sp_ranks.py::ring_checks``): each runs ring and zigzag at
sp 2 (two sp groups, dp 2) and sp 4 on its share of the same global
q/k/v, with the forward and the gradients of sum(out * cot), while the
parent jits JAX's side once."""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmvox_tpu.ops import ring_attention as jra
from llmvox_tpu.parallel.mesh import create_mesh as jcreate_mesh
from llmvox_tpu_torch.ops import attention as tattn
from llmvox_tpu_torch.ops import ring_attention as tra
from llmvox_tpu_torch.parallel import mesh as pmesh
from llmvox_tpu_torch.parallel.launch import spawn

from tests import torch_sp_ranks as ranks

# tests/test_ring_attention.py's bounds
FWD_TOL = dict(atol=2e-5, rtol=1e-5)
GRAD_TOL = dict(atol=3e-5, rtol=1e-4)
B, T, H, D = 4, 64, 2, 16
LAYOUTS = [(2, "ring"), (2, "zigzag"), (4, "ring"), (4, "zigzag")]


def _jax_side(case):
    """JAX's attention and the gradients of sum(out * cot), in the
    original order, at (dp 2, sp 2) and (dp 1, sp 4); the zigzag
    permutation inside the differentiated function, as
    tests/test_ring_attention.py holds it."""
    q, k, v, cot = (jnp.asarray(case[n]) for n in ("q", "k", "v", "cot"))
    out = {}
    for sp, layout in LAYOUTS:
        mesh = jcreate_mesh(dp_size=4 // sp, sp_size=sp)
        if layout == "ring":
            attn = jra.make_ring_attention(mesh)
            perm = inv = np.arange(T)
        else:
            attn = jra.make_zigzag_ring_attention(mesh)
            perm, inv = jra.zigzag_permutation(T, sp)

        def loss(q, k, v, attn=attn, perm=perm):
            return jnp.sum(attn(q[:, perm], k[:, perm], v[:, perm])
                           * cot[:, perm])
        o = jax.jit(lambda q, k, v, attn=attn, perm=perm: attn(
            q[:, perm], k[:, perm], v[:, perm]))(q, k, v)
        g = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
        out[sp, layout] = (np.asarray(o)[:, inv],
                           [np.asarray(x) for x in g])
    return out


@pytest.fixture(scope="module")
def ring():
    rng = np.random.default_rng(0)
    case = {n: rng.standard_normal((B, T, H, D)).astype(np.float32)
            for n in ("q", "k", "v", "cot")}
    res = {}
    thread = threading.Thread(target=lambda: res.update(r=spawn(
        ranks.ring_checks, 4, case, threads=1, timeout_s=300)))
    thread.start()
    jax_out = _jax_side(case)
    thread.join()
    assert "r" in res, "the ranks failed (their traceback is above)"
    return dict(ranks=res["r"], jax=jax_out, case=case)


def _assemble(ranks_out, key):
    """The ranks' local outputs and gradients placed at their global rows
    and positions (original order)."""
    out = np.full((B, T, H, D), np.nan, np.float32)
    grads = [out.copy() for _ in range(3)]
    for r in ranks_out:
        a = r["attn"][key]
        idx = np.ix_(a["rows"], a["pos"])
        out[idx] = a["out"]
        for g, x in zip(grads, a["grads"]):
            g[idx] = x
    return out, grads


@pytest.mark.parametrize("sp,layout", LAYOUTS)
def test_forward_matches_jax(ring, sp, layout):
    got, _ = _assemble(ring["ranks"], (sp, layout))
    want, _ = ring["jax"][sp, layout]
    np.testing.assert_allclose(got, want, **FWD_TOL)


@pytest.mark.parametrize("sp,layout", LAYOUTS)
def test_gradients_match_jax(ring, sp, layout):
    """dq, dk and dv: the keys' gradients travel back around the ring to
    the rank that holds them."""
    _, got = _assemble(ring["ranks"], (sp, layout))
    _, want = ring["jax"][sp, layout]
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, w, **GRAD_TOL, err_msg=name)


def test_ranks_are_ordered_as_jaxs_mesh(ring):
    """At sp 2 of four ranks: rank r is sp index r % 2 and dp index
    r // 2, as JAX's create_mesh(dp 2, sp 2) orders its devices."""
    for r, out in enumerate(ring["ranks"]):
        assert out["layout"] == (2, 2, r // 2, r % 2)
    mesh = jcreate_mesh(dp_size=2, sp_size=2)
    ids = [d.id for d in mesh.devices.flat]
    assert ids == sorted(ids)


@pytest.mark.parametrize("t,n", [(32, 4), (64, 2), (48, 3), (16, 8)])
def test_zigzag_permutation_is_jaxs(t, n):
    perm, inv = tra.zigzag_permutation(t, n)
    jperm, jinv = jra.zigzag_permutation(t, n)
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(inv, jinv)
    assert perm.dtype == jperm.dtype == np.int32


def test_refusals(ring):
    """T not divisible by sp, or by 2*sp for zigzag, as JAX's ValueErrors
    (its ``zigzag_permutation`` asserts); a local zigzag share of odd
    length and an unknown layout refused on the ranks."""
    with pytest.raises(ValueError, match="T=30 not divisible by sp=4"):
        tra.check_seq(30, 4, "ring")
    with pytest.raises(ValueError, match=r"T=30 not divisible by 2\*sp=4"):
        tra.zigzag_permutation(30, 2)
    with pytest.raises(AssertionError, match="not divisible"):
        jra.zigzag_permutation(30, 2)
    q = jnp.zeros((2, 30, 2, 16))
    with pytest.raises(ValueError, match="not divisible by sp=4"):
        jra.make_ring_attention(jcreate_mesh(dp_size=2, sp_size=4))(q, q, q)
    ref = ring["ranks"][0]["refused"]
    assert "T=12 not divisible by 2*sp=8" in ref["zigzag_odd"]
    assert "sp_layout 'diagonal'" in ref["layout"]


@pytest.mark.parametrize("layout", ["ring", "zigzag"])
def test_one_rank_is_causal_attention(layout):
    """Over a group of one rank (``LOCAL``) the ring is causal attention,
    forward and backward."""
    g = torch.Generator().manual_seed(3)
    q, k, v, cot = (torch.randn((2, 24, 2, 8), generator=g)
                    for _ in range(4))
    for x in (q, k, v):
        x.requires_grad_()
    out = tra.ring_attention(q, k, v, pmesh.LOCAL, layout)
    grads = torch.autograd.grad((out * cot).sum(), (q, k, v))
    ref = tattn.causal_attention(q, k, v)
    want = torch.autograd.grad((ref * cot).sum(), (q, k, v))
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               **FWD_TOL)
    for a, b in zip(grads, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)


def _x(rank):
    return np.arange(12, dtype=np.float32).reshape(3, 4) * (rank + 1)


@pytest.mark.parametrize("group", ["world", "sp"])
def test_collective_routes_are_bitwise_equal(ring, group):
    """On CPU tensors gloo carries the native route; the all-reduce route
    (gloo's on CUDA tensors) forced on the CPU gives the same bits (sums
    of integers here, so the reduce-scatter's order of addition cannot
    show)."""
    for out in ring["ranks"]:
        c = out["collectives"][group]
        assert c["route"] == pmesh.NATIVE
        for name in ("rotate", "rotate_back", "gather", "scatter"):
            a, b = c[pmesh.NATIVE][name], c[pmesh.ALL_REDUCE][name]
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("group", ["world", "sp"])
def test_rotation_gather_and_scatter_values(ring, group):
    """Rank i of n receives rank (i - 1) % n's tensor (and (i + 1) % n's
    rotating back), the gather is the ranks' tensors in rank order, and
    the reduce-scatter keeps block i of the sum."""
    outs = ring["ranks"]
    for r, out in enumerate(outs):
        c = out["collectives"][group]
        n, i = c["n"], c["i"]
        members = [s for s, o in enumerate(outs)
                   if group == "world" or o["layout"][2] == out["layout"][2]]
        assert len(members) == n and members[i] == r
        got = c[pmesh.NATIVE]
        np.testing.assert_array_equal(got["rotate"],
                                      _x(members[(i - 1) % n]))
        np.testing.assert_array_equal(got["rotate_back"],
                                      _x(members[(i + 1) % n]))
        np.testing.assert_array_equal(
            got["gather"], np.concatenate([_x(m) for m in members], axis=1))
        np.testing.assert_array_equal(got["scatter"],
                                      sum(_x(m) for m in members))


@pytest.mark.parametrize("group", ["world", "sp"])
def test_ppermute_gradient_is_the_inverse_rotation(ring, group):
    """d/dx of sum(ppermute(x) * w) on rank i is the w of the rank that
    received x, (i + 1) % n: the inverse rotation of w; ``gather_shards``'
    gradient is rank i's block of the ranks' summed cotangents."""
    outs = ring["ranks"]
    for r, out in enumerate(outs):
        c = out["collectives"][group]
        n, i = c["n"], c["i"]
        members = [s for s, o in enumerate(outs)
                   if group == "world" or o["layout"][2] == out["layout"][2]]
        np.testing.assert_array_equal(
            c["ppermute_grad"], np.full((3, 4), members[(i + 1) % n] + 1.0))
        cot = np.arange(12 * n, dtype=np.float32).reshape(3 * n, 4)
        np.testing.assert_array_equal(c["gather_grad"],
                                      n * cot[3 * i:3 * (i + 1)])
