"""Where the port's plain Moller-Trumbore parts from the JAX package's on
the CPU: XLA's contraction of products into fused multiply-adds.

The lanes are those of ``tests/test_torch_lbvh.py::test_bvh_tracer_matches_jax``
on the soup: the 333-triangle soup, 2048 rays (``rng`` 1234, every other
one aimed at a triangle's centroid), the 1043 that JAX's LBVH walk hits,
each with the triangle it hit. JAX's ``vkrt_tpu/ops/intersect.py::mt_block``
runs jitted, one ray against one triangle under ``vmap``, as the walk calls
it; its t, u and v are the walk's bit for bit.

A copy of the port's plain ``mt_block`` with each contracted a*b + c
computed in float64 and rounded once to float32 gives JAX's t, u and v bit
for bit on every lane. The contraction that matches: each cross-product
component ``a1*b2 - a2*b1`` as fma(a1, b2, -(a2*b1)) (the first product
kept exact), each three-term dot product as a running fma from the first
product, ``fma(x2, y2, fma(x1, y1, x0*y0))``. The port's own ``mt_block``
is the same copy with every operation rounded on its own, bit for bit; the
port's kernels stay uncontracted (``__fmul_rn`` / ``__fadd_rn``), so this
gap is the reference's arithmetic, not the port's. Run with ``-s`` for the
mismatch counts of each variant."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vkrt_tpu.bvh.lbvh as jlbvh
from test_torch_lbvh import T_MAX, T_MIN, _arrays, _rays, _u32
from vkrt_tpu.ops.intersect import mt_block as jax_mt_block
from vkrt_tpu.ops.trace import trace_closest_bvh
from vkrt_tpu_torch.ops.intersect import _DET_EPS, mt_block


def _round(x):
    return x.to(torch.float32)


def _mul(a, b):
    return _round(a.double() * b.double())


def _fma(a, b, c):
    """a*b + c rounded once to f32 (the float64 sum of the exact product)."""
    return _round(a.double() * b.double() + c.double())


def _cross(a, b, contract: str):
    """``"first"``: fma(a1, b2, -(a2*b1)); ``"second"``: fma(-a2, b1, a1*b2);
    ``"none"``: both products rounded, then the difference."""
    out = []
    for i, j in ((1, 2), (2, 0), (0, 1)):
        p, q = (a[..., i], b[..., j]), (a[..., j], b[..., i])
        if contract == "first":
            out.append(_fma(*p, -_mul(*q)))
        elif contract == "second":
            out.append(_fma(-q[0], q[1], _mul(*p)))
        else:
            out.append(_round(_mul(*p).double() - _mul(*q).double()))
    return torch.stack(out, dim=-1)


def _dot(a, b, contract: str):
    """A running fma from the first product (``"first"``/``"second"``), or
    each product and sum rounded (``"none"``)."""
    if contract == "none":
        acc = _round(_mul(a[..., 0], b[..., 0]).double() + _mul(a[..., 1], b[..., 1]).double())
        return _round(acc.double() + _mul(a[..., 2], b[..., 2]).double())
    acc = _mul(a[..., 0], b[..., 0])
    acc = _fma(a[..., 1], b[..., 1], acc)
    return _fma(a[..., 2], b[..., 2], acc)


def mt_emulated(o, d, v0, e1, e2, contract: str):
    """A copy of the port's plain ``mt_block`` for one triangle a lane
    (all (N, 3) f32), each operation's rounding chosen by ``contract``.
    Returns (hit, t, u, v)."""
    pvec = _cross(d, e2, contract)
    det = _dot(e1, pvec, contract)
    ok = det.abs() > _DET_EPS
    inv_det = torch.where(ok, 1.0 / det, torch.zeros_like(det))
    tvec = o - v0
    u = _mul(_dot(tvec, pvec, contract), inv_det)
    qvec = _cross(tvec, e1, contract)
    v = _mul(_dot(d, qvec, contract), inv_det)
    t = _mul(_dot(e2, qvec, contract), inv_det)
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > T_MIN) & (t < T_MAX)
    return hit, t, u, v


@pytest.fixture(scope="module")
def lanes():
    """The soup's hit lanes: (o, d, v0, e1, e2) f32 numpy, one triangle a
    lane, and the walk's (t, u, v) of each."""
    arrs = _arrays("soup")
    live = (np.abs(arrs[1]) + np.abs(arrs[2])).any(1)
    o, d = _rays(2048, np.random.default_rng(1234), scale=2.0,
                 aim=tuple(a[live] for a in arrs))
    o, d = o.numpy(), d.numpy()
    ref = trace_closest_bvh(jlbvh.build_lbvh(*(jnp.asarray(a) for a in arrs)), *arrs,
                            jnp.asarray(o), jnp.asarray(d), T_MIN, T_MAX)
    hit = np.asarray(ref.hit)
    tri = np.asarray(ref.tri)[hit]
    walk = tuple(np.asarray(x)[hit] for x in (ref.t, ref.u, ref.v))
    return (o[hit], d[hit], *(a[tri] for a in arrs)), walk


def _jax_lanes(rays):
    one = jax.vmap(lambda o, d, v0, e1, e2: tuple(
        x[0, 0] for x in jax_mt_block(o[None], d[None], v0[None], e1[None], e2[None],
                                      T_MIN, T_MAX)))
    return tuple(np.asarray(x) for x in jax.jit(one)(*rays))


def _mismatches(got, want):
    return [int((_u32(a) != _u32(b)).sum()) for a, b in zip(got, want)]


def test_contracted_copy_matches_jax_bit_for_bit(lanes):
    rays, walk = lanes
    assert len(rays[0]) == 1043
    jhit, jt, ju, jv = _jax_lanes(rays)
    assert jhit.all()
    # the walk's t, u and v are jitted mt_block's, lane for lane
    assert _mismatches((jt, ju, jv), walk) == [0, 0, 0]
    tt = [torch.from_numpy(a) for a in rays]
    counts = {}
    for contract in ("first", "second", "none"):
        hit, t, u, v = mt_emulated(*tt, contract)
        counts[contract] = _mismatches((t.numpy(), u.numpy(), v.numpy()), (jt, ju, jv))
    print(f"t, u, v lanes apart from JAX's jitted mt_block of {len(jt)}: {counts}")
    assert counts["first"] == [0, 0, 0]
    # the other pairing and no contraction are both far off: the check
    # tells the contractions apart
    assert min(counts["second"]) > 100 and min(counts["none"]) > 100


def test_port_mt_block_is_the_uncontracted_copy(lanes):
    """The port's plain ``mt_block`` rounds every operation on its own: bit
    for bit the copy with no contraction, so what separates it from JAX's
    is the contraction alone."""
    rays, _ = lanes
    tt = [torch.from_numpy(a) for a in rays]
    n = len(rays[0])
    diag = torch.arange(n)
    hit, t, u, v = (x[diag, diag] for x in mt_block(*tt, T_MIN, T_MAX))
    ehit, et, eu, ev = mt_emulated(*tt, "none")
    assert torch.equal(hit, ehit)
    assert _mismatches((t.numpy(), u.numpy(), v.numpy()), (et.numpy(), eu.numpy(),
                                                            ev.numpy())) == [0, 0, 0]
