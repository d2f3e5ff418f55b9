"""The SSD intra-chunk kernels' plain versions held against the JAX package.

On the CPU the wrappers take their plain versions (whole-tile PyTorch);
the CUDA kernels themselves are held against the same plain versions on
the card by ``chip_smoke.py``.  Here, with numpy-seeded inputs fed to both
packages:

* the plain forward against ``ssd_intra_pallas(..., interpret=True)`` and
  against both packages' ``ssd_intra_ref``;
* the plain backward's five cotangents against
  ``ssd_intra_bwd_pallas(..., interpret=True)``;
* the ``torch.autograd.Function`` binding's gradients against the plain
  backward and against ``torch.autograd`` through ``ssd_intra_ref``;
* a chunk whose cumulative log-decay falls to about −1,000, as
  mamba2-2.7b's does: every output finite and equal to the JAX function's;
* the fallback on CPU tensors counted and warned once, and a tensor off the
  CPU never served by the plain version.

Grid and tolerances are those of ``tests/test_kernels.py``: forward f32
2e-5, bf16 2e-2; f32 gradients atol 2e-3 + rtol 2e-3; bf16 gradients (each
side rounds its f32 result to bf16 once) 2e-2.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import ssd_intra_ref as jax_ref
from repro.kernels.ssd_scan import ssd_intra_bwd_pallas as jax_bwd
from repro.kernels.ssd_scan import ssd_intra_pallas as jax_fwd
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ssd_scan as ss
from repro_torch.kernels.ref import ssd_intra_ref
from test_torch_flash_attention import (_bf16_values, _desc_read, _pack_a,
                                        _tma_tile, wgmma_acc_coord)

# the suite runs several worker processes side by side: one intra-op
# thread each, or the workers fight over the cores
torch.set_num_threads(1)

SHAPES = [                      # (B, nc, Q, H, P, N), tests/test_kernels.py
    (1, 2, 16, 2, 16, 16),
    (2, 3, 32, 4, 16, 24),
    (1, 1, 64, 1, 32, 32),
    (1, 4, 8, 8, 8, 8),
]
DTYPES = ["float32", "bfloat16"]
NAMES = ("dx", "ddt", "dlt", "dB", "dC")


def fwd_tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else \
        dict(atol=2e-5, rtol=2e-5)


def grad_tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else \
        dict(atol=2e-3, rtol=2e-3)


def inputs(B, nc, Q, H, P, N, seed, large_decay=False):
    """xr, dtr, ltT, Br, Cr and a cotangent g as f32 numpy.  The small
    decays are the JAX tests' (``|lt| <= 0.1 |N(0, 1)|``); the large ones
    are drawn as the model draws them: ``dt = softplus(N(0, 1))``,
    ``A = -linspace(1, 16, H)``, so a chunk of 128 reaches ``cum`` ≈ −1,000."""
    rng = np.random.default_rng(seed)
    xr = rng.normal(size=(B, nc, Q, H, P))
    dtr = np.log1p(np.exp(rng.normal(size=(B, nc, Q, H))))
    if large_decay:
        # rounded to multiples of 2^-10, so that every partial sum (down to
        # about -2,000) is exact in f32: the two packages' cumsums, taken in
        # different orders, then agree bit for bit, and the comparison
        # holds the kernels' arithmetic, not the cumsum's rounding (near
        # -1,000 one f32 ulp of cum moves exp by 6e-5 relative)
        ltT = np.moveaxis(dtr * -np.linspace(1.0, 16.0, H), -1, -2)
        ltT = np.round(ltT * 1024.0) / 1024.0
    else:
        ltT = -np.abs(rng.normal(size=(B, nc, H, Q))) * 0.1
    Br = rng.normal(size=(B, nc, Q, N))
    Cr = rng.normal(size=(B, nc, Q, N))
    g = rng.normal(size=(B, nc, Q, H, P))
    return [np.ascontiguousarray(a, dtype=np.float32)
            for a in (xr, dtr, ltT, Br, Cr, g)]


def both(arrs, dtype):
    """(jax, torch) operands: x, B, C, g in ``dtype``; dt and lt f32."""
    model = (0, 3, 4, 5)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    j = [jnp.asarray(a, jd if i in model else jnp.float32)
         for i, a in enumerate(arrs)]
    t = [torch.tensor(a).to(td if i in model else torch.float32)
         for i, a in enumerate(arrs)]
    return j, t


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_forward_matches_jax_kernel_and_ref(shape, dtype):
    (jx, jdt, jlt, jB, jC, _), (tx, tdt, tlt, tB, tC, _) = both(
        inputs(*shape, seed=sum(shape)), dtype)
    want = jax_fwd(jx, jdt, jlt, jB, jC, interpret=True)
    got = ss.ssd_intra_fwd(tx, tdt, tlt, tB, tC)
    assert got.dtype == tx.dtype and tuple(got.shape) == want.shape
    np.testing.assert_allclose(f32(got), f32(want), **fwd_tol(dtype))
    np.testing.assert_allclose(f32(got), f32(jax_ref(jx, jdt, jlt, jB, jC)),
                               **fwd_tol(dtype))
    np.testing.assert_allclose(f32(ssd_intra_ref(tx, tdt, tlt, tB, tC)),
                               f32(want), **fwd_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_jax_kernel(shape, dtype):
    """All five cotangents, in the input layouts and dtypes."""
    (jx, jdt, jlt, jB, jC, jg), (tx, tdt, tlt, tB, tC, tg) = both(
        inputs(*shape, seed=sum(shape) + 1), dtype)
    want = jax_bwd(jx, jdt, jlt, jB, jC, jg, interpret=True)
    got = ss.ssd_intra_bwd(tx, tdt, tlt, tB, tC, tg)
    for name, a, b, ref in zip(NAMES, got, want, (tx, tdt, tlt, tB, tC)):
        assert a.dtype == ref.dtype and a.shape == ref.shape, name
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(f32(a), f32(b), err_msg=name,
                                   **grad_tol(dtype))


def test_autograd_binding_matches_plain_backward_and_ref_autograd():
    xr, dtr, ltT, Br, Cr, g = (torch.tensor(a) for a in
                               inputs(2, 3, 32, 4, 16, 24, seed=7))
    leaves = [t.clone().requires_grad_(True) for t in (xr, dtr, ltT, Br,
                                                      Cr)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", kops.KernelFallbackWarning)
        y = kops.ssd_intra(*leaves)
    kops.reset_kernel_stats()
    got = torch.autograd.grad(y, leaves, g)
    plain = ss.ssd_intra_bwd(xr, dtr, ltT, Br, Cr, g)
    ref_leaves = [t.clone().requires_grad_(True) for t in (xr, dtr, ltT, Br,
                                                          Cr)]
    ref = torch.autograd.grad(ssd_intra_ref(*ref_leaves), ref_leaves, g)
    for name, a, b, c in zip(NAMES, got, plain, ref):
        assert torch.equal(a, b), name          # the binding IS the wrapper
        np.testing.assert_allclose(a.numpy(), c.numpy(), atol=2e-3,
                                   rtol=2e-3, err_msg=name)


@pytest.mark.parametrize("dtype", DTYPES)
def test_large_decay_is_finite_and_matches_jax(dtype):
    """cum falls to about -1,000 within the chunk: above the diagonal
    exp(cum_i - cum_j) would overflow.  The plain versions, the binding's
    gradients and the reference's autograd gradients stay finite and agree
    with the JAX kernels."""
    shape = (1, 2, 128, 4, 16, 32)
    arrs = inputs(*shape, seed=11, large_decay=True)
    (jx, jdt, jlt, jB, jC, jg), (tx, tdt, tlt, tB, tC, tg) = both(arrs,
                                                                   dtype)
    cum = torch.cumsum(tlt, -1)
    assert float(cum.min()) < -900.0
    assert torch.equal(cum, torch.cumsum(tlt.double(), -1).float())  # exact
    seg_max = float((cum[..., None, :] - cum[..., :, None]).max())
    assert seg_max > np.log(np.finfo(np.float32).max)   # exp would overflow
    y = ss.ssd_intra_fwd(tx, tdt, tlt, tB, tC)
    grads = ss.ssd_intra_bwd(tx, tdt, tlt, tB, tC, tg)
    assert all(bool(t.isfinite().all()) for t in (y,) + grads)
    np.testing.assert_allclose(
        f32(y), f32(jax_fwd(jx, jdt, jlt, jB, jC, interpret=True)),
        **fwd_tol(dtype))
    want = jax_bwd(jx, jdt, jlt, jB, jC, jg, interpret=True)
    for name, a, b in zip(NAMES, grads, want):
        np.testing.assert_allclose(f32(a), f32(b), err_msg=name,
                                   **grad_tol(dtype))
    if dtype == "float32":
        leaves = [t.clone().requires_grad_(True)
                  for t in (tx, tdt, tlt, tB, tC)]
        ref = torch.autograd.grad(ssd_intra_ref(*leaves), leaves, tg)
        for name, a, b in zip(NAMES, grads, ref):
            assert bool(b.isfinite().all()), name
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-3,
                                       rtol=2e-3, err_msg=name)


def test_dlt_is_the_transpose_of_the_cumsum():
    dcum = torch.tensor(np.random.default_rng(3).normal(size=(2, 3, 4, 16)),
                        dtype=torch.float32)
    lt = torch.zeros_like(dcum, requires_grad=True)
    (want,) = torch.autograd.grad(torch.cumsum(lt, -1), lt, dcum)
    np.testing.assert_allclose(ss.dlt_from_dcum(dcum, torch.float32).numpy(),
                               want.numpy(), atol=1e-5)


def test_fallback_counted_and_warned_once():
    xr, dtr, ltT, Br, Cr, _ = (torch.tensor(a) for a in
                               inputs(1, 2, 16, 2, 16, 16, seed=0))
    ref = ssd_intra_ref(xr, dtr, ltT, Br, Cr)
    launches = (ss.ssd_intra_fwd.launches, ss.ssd_intra_bwd.launches)
    kops.reset_kernel_stats()
    try:
        with pytest.warns(kops.KernelFallbackWarning, match="ssd_intra"):
            y = kops.ssd_intra(xr, dtr, ltT, Br, Cr)
        np.testing.assert_allclose(y.numpy(), ref.numpy(), atol=1e-6)
        # second call: counted again, but NOT warned again
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            kops.ssd_intra(xr, dtr, ltT, Br, Cr)
        assert kops.KERNEL_STATS.fallbacks == 2
        assert kops.KERNEL_STATS.calls == 0
        assert kops.KERNEL_STATS.reasons == {"ssd_intra:device:cpu": 2}
        # no kernel was launched
        assert launches == (ss.ssd_intra_fwd.launches,
                            ss.ssd_intra_bwd.launches)
    finally:
        kops.reset_kernel_stats()


def test_non_cpu_tensor_never_takes_the_plain_version():
    """A tensor that is not on the CPU goes to the kernel path: on a
    device the kernels do not serve it raises instead of computing."""
    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, device="meta", dtype=dtype)
    xr, dtr, ltT = meta(1, 2, 16, 2, 16), meta(1, 2, 16, 2), meta(1, 2, 2, 16)
    Bm = meta(1, 2, 16, 8)
    with pytest.raises(RuntimeError, match="unsupported device"):
        ss.ssd_intra_fwd(xr, dtr, ltT, Bm, Bm)
    with pytest.raises(RuntimeError, match="unsupported device"):
        ss.ssd_intra_bwd(xr, dtr, ltT, Bm, Bm, xr)
    with pytest.raises(ValueError, match="head dim"):
        wide = meta(1, 2, 16, 2, 160)
        ss.ssd_intra_fwd(wide, dtr, ltT, Bm, Bm)
    with pytest.raises(ValueError, match="share a dtype"):
        ss.ssd_intra_fwd(xr, dtr, ltT, Bm.to(torch.bfloat16), Bm)
    with pytest.raises(ValueError, match="float32"):
        ss.ssd_intra_fwd(xr, dtr.to(torch.bfloat16), ltT, Bm, Bm)
    with pytest.raises(ValueError, match="ltT must be"):
        ss.ssd_intra_fwd(xr, dtr, meta(1, 2, 16, 2), Bm, Bm)
    with pytest.raises(ValueError, match="g must be"):
        ss.ssd_intra_bwd(xr, dtr, ltT, Bm, Bm, xr[:, :1])


# ------------------------------------------ B6 on the tensor cores (bf16)
# ``ssd_bwd_tc`` (csrc/ssd_scan.cu) runs one block per (cell, group of
# ``head_groups`` heads): cb = C·Bᵀ once per block, per head the cotangents
# in the transposed frame T[j][i] with att split into bf16 hi + lo for
# dx = attᵀ·g, the group's dcb summed over its heads in order into a
# scratch, then a second kernel that sums the groups in order into dB / dC.
# Its grouping, its decomposition and its tile maps are held here.

@pytest.mark.parametrize("BC, H", [(16, 80), (1, 2), (2, 4), (8, 24),
                                   (33, 80), (64, 80), (132, 8), (200, 80),
                                   (4, 1), (16, 64), (1, 128)])
def test_head_groups_is_a_pure_function_of_the_shape(BC, H):
    G = ss.head_groups(BC, H)
    assert 1 <= G <= min(H, ss.TC_MAX_HEADS)
    assert G == ss.head_groups(BC, H)
    blocks = BC * -(-H // G)
    if G < ss.TC_MAX_HEADS:
        # the fewest heads a block that keep the grid within one wave
        assert blocks <= ss.WAVE or -(-H // G) == 1
        if G > 1:
            assert BC * -(-H // (G - 1)) > ss.WAVE
    if (BC, H) == (16, 80):                      # mamba2-2.7b, 1 x 2048
        assert (G, blocks) == (10, 128)


@pytest.mark.parametrize("dtype, Q, P, N, route", [
    (torch.bfloat16, 128, 64, 128, "wgmma"), (torch.bfloat16, 96, 40, 20,
                                              "wgmma"),
    (torch.bfloat16, 8, 8, 8, "wgmma"), (torch.float32, 128, 64, 128,
                                         "simt"),
    (torch.bfloat16, 256, 64, 128, "simt"), (torch.bfloat16, 128, 128, 128,
                                             "simt"),
    (torch.bfloat16, 128, 36, 128, "simt"), (torch.bfloat16, 128, 64, 160,
                                             "simt")])
def test_backward_routes_by_dtype_and_shape(dtype, Q, P, N, route):
    assert ss.bwd_route(dtype, Q, P, N) == route


def tc_bwd_emulation(xr, dtr, cum, Br, Cr, g, G):
    """What ``ssd_bwd_tc`` computes, in torch: per cell cbᵀ = B·Cᵀ once; per
    head in the transposed frame T[j][i] (live where j <= i) datt, decay,
    att, ddt (rows of T), dcum (columns minus rows), dx = (hi + lo)·g with
    att split into bf16 hi and lo = att − hi rounded again; dcbᵀ summed over
    each group's heads in order, the groups summed in order, then dB and
    dC.  Returns f32 ``(dx, ddt, dcum, dB, dC)`` before their final
    rounding."""
    B, nc, Q, H, P = xr.shape
    x = xr.float().movedim(3, 2)                           # (B,nc,H,Q,P)
    gg = g.float().movedim(3, 2)
    cbT = torch.matmul(Br.float(), Cr.float().transpose(-1, -2))  # [j][i]
    live = torch.triu(torch.ones(Q, Q, dtype=torch.bool))  # i >= j
    cj = cum[..., :, None]                                  # rows j
    ci = cum[..., None, :]                                  # columns i
    dec = torch.where(live, torch.exp(torch.where(live, ci - cj, 0.0)),
                      0.0)                                  # (B,nc,H,Q,Q)
    dtj = dtr.float().movedim(-1, -2)[..., :, None]         # (B,nc,H,Q,1)
    dattT = torch.matmul(x, gg.transpose(-1, -2))           # x gᵀ: [j][i]
    attT = cbT[:, :, None] * dec * dtj
    dad = dattT * dec
    tq = dad * cbT[:, :, None]
    ddt = tq.sum(-1)                                        # rows of T
    dseg = tq * dtj
    dcum = dseg.sum(-2) - dseg.sum(-1)                      # columns − rows
    hi = attT.to(torch.bfloat16).float()
    lo = (attT - hi).to(torch.bfloat16).float()
    dx = torch.matmul(hi, gg) + torch.matmul(lo, gg)        # attᵀ g: rows j
    per_head = dad * dtj                                    # dcbᵀ per head
    parts = [per_head[:, :, k:k + G].sum(2) for k in range(0, H, G)]
    dcbT = parts[0]
    for p in parts[1:]:
        dcbT = dcbT + p
    dB = torch.matmul(dcbT, Cr.float())                     # Σ_i dcbᵀ[j][i] C_i
    dC = torch.matmul(dcbT.transpose(-1, -2), Br.float())
    return dx.movedim(2, 3), ddt.movedim(-1, -2), dcum, dB, dC


@pytest.mark.parametrize("G", [1, 2, 3])
@pytest.mark.parametrize("shape, large_decay", [
    ((1, 2, 16, 4, 16, 16), False), ((2, 3, 32, 4, 16, 24), False),
    ((1, 2, 96, 6, 40, 20), True), ((1, 2, 128, 4, 16, 32), True)])
def test_grouped_decomposition_matches_plain_and_jax(shape, large_decay, G):
    """The tensor-core kernels' decomposition on bf16 inputs: against the
    plain backward on the same inputs (bf16 outputs within one bf16 ulp
    beyond 2^-16 of the largest value, f32 ddt / dltT within 1e-5 of it:
    the rules chip_smoke.py holds the kernel to on the card) and against
    the JAX kernel under ``interpret=True`` at the grid's tolerances."""
    arrs = inputs(*shape, seed=sum(shape) + G, large_decay=large_decay)
    (jx, jdt, jlt, jB, jC, jg), (tx, tdt, tlt, tB, tC, tg) = both(
        arrs, "bfloat16")
    cum = torch.cumsum(tlt, -1)
    dx, ddt, dcum, dB, dC = tc_bwd_emulation(tx, tdt, cum, tB, tC, tg, G)
    got = (dx.to(torch.bfloat16), ddt, ss.dlt_from_dcum(dcum, tlt.dtype),
           dB.to(torch.bfloat16), dC.to(torch.bfloat16))
    assert all(bool(t.isfinite().all()) for t in got)
    pdx, pddt, pdcum, pdB, pdC = ss.bwd_plain(tx, tdt, cum, tB, tC, tg)
    plain = (pdx, pddt, ss.dlt_from_dcum(pdcum, tlt.dtype), pdB, pdC)
    for name, a, b in zip(NAMES, got, plain):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        diff = (a.float() - b.float()).abs()
        scale = float(b.float().abs().max())
        if a.dtype == torch.float32:
            assert float(diff.max()) <= 1e-5 * scale, name
        else:
            mag = torch.maximum(a.float().abs(), b.float().abs())
            ulp = torch.ldexp(torch.ones_like(mag), torch.frexp(mag)[1] - 8)
            assert float(((diff - scale * 2 ** -16).clamp(min=0)
                          / ulp).max()) <= 1.0, name
    want = jax_bwd(jx, jdt, jlt, jB, jC, jg, interpret=True)
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_allclose(f32(a), f32(b), err_msg=name,
                                   **grad_tol("bfloat16"))


def test_att_hi_lo_split_keeps_the_f32_products_accuracy():
    rng = np.random.default_rng(4)
    att = torch.tensor(rng.normal(size=(64, 128)) * np.exp(
        rng.uniform(-20, 5, size=(64, 128))), dtype=torch.float32)
    hi = att.to(torch.bfloat16).float()
    lo = (att - hi).to(torch.bfloat16).float()
    assert torch.equal(att - hi + hi, att)           # att − hi is exact
    rel = ((hi + lo - att).abs() / att.abs()).max()
    assert float(rel) <= 2.0 ** -17


# The tile maps of ssd_bwd_tc_kernel, mirrored from the source and held
# against plain products of one 128-row tile (bf16 values: exact in f64).
# Shared memory: B panels at 0 and 16 KB, C panels at 32 and 48 KB (64
# columns each, stored by the threads in the 128-byte swizzle), the x and g
# tiles of a ring stage as TMA leaves them.
B6_TILE = 128 * 128                    # one 128-row, 64-column bf16 tile


def b6_bc_store_offset(which: int, r: int, n: int) -> int:
    """Byte offset at which the kernel's threads store element (row r,
    column n) of B (``which`` 0) or C (1): panel n // 64, chunk (n % 64) // 8
    XOR r % 8, as ``*(uint4*)(base + (2 which + pan) TILE_B + r SW_ROW +
    ((ch ^ (r & 7)) << 4))`` with the element's place in the 16 bytes."""
    pan, ch = n // 64, (n % 64) // 8
    return ((2 * which + pan) * B6_TILE + r * 128 + ((ch ^ (r & 7)) << 4)
            + (n % 8) * 2)


def b6_desc_start(operand: str, t: int, *, wg: int = 0) -> int:
    """Start offset of the kernel's descriptor for k-step ``t``: ``"b"``
    (warpgroup ``wg``'s 64 rows j of B, columns 16t …), ``"c"`` (all 128
    rows i of C), ``"x"`` / ``"g"`` (rows of the x / g tile at 0, columns
    16t …; x per warpgroup), ``"g_n"`` (g N-major: rows i = 16t …)."""
    if operand == "b":
        return (t >> 2) * B6_TILE + wg * 64 * 128 + (t & 3) * 32
    if operand == "c":
        return (2 + (t >> 2)) * B6_TILE + (t & 3) * 32
    if operand == "x":
        return wg * 64 * 128 + t * 32
    if operand == "g":
        return t * 32
    return t * 16 * 128


def halve_lanes(vals, mask):
    """The kernel's ``halve``: ``vals`` (32 lanes, n values) → (32, n / 2);
    the lane with the mask bit keeps the upper half plus its partner's."""
    n = vals.shape[1]
    out = np.empty((32, n // 2))
    for lane in range(32):
        up = bool(lane & mask)
        keep = vals[lane, n // 2:] if up else vals[lane, :n // 2]
        # the partner sends the half it does not keep: this lane's half
        send = vals[lane ^ mask, :n // 2] if not up else \
            vals[lane ^ mask, n // 2:]
        out[lane] = keep + send
    return out


def test_b6_tensor_core_maps_reproduce_the_tile_products():
    rng = np.random.default_rng(16)
    N, P = 128, 64
    Bm, Cm = _bf16_values(rng, (128, N)), _bf16_values(rng, (128, N))
    slots = np.full(4 * B6_TILE // 2, np.nan)
    for which, M in ((0, Bm), (1, Cm)):
        r, n = np.meshgrid(np.arange(128), np.arange(N), indexing="ij")
        off = np.vectorize(b6_bc_store_offset)(which, r, n)
        assert np.isnan(slots[off // 2]).all()          # written once
        slots[off // 2] = M
    # the threads' store is the layout TMA's 128-byte swizzle would give
    for which, M in ((0, Bm), (1, Cm)):
        base = 2 * which * B6_TILE // 2
        np.testing.assert_array_equal(
            slots[base:base + 2 * B6_TILE // 2], _tma_tile(M, 128))
    X, Gt = _bf16_values(rng, (128, P)), _bf16_values(rng, (128, P))
    sx, sg = _tma_tile(X, 128), _tma_tile(Gt, 128)
    tid, reg = np.meshgrid(np.arange(128), np.arange(64), indexing="ij")
    rows, cols = np.vectorize(wgmma_acc_coord)(tid, reg)
    tid32, reg32 = np.meshgrid(np.arange(128), np.arange(32), indexing="ij")
    rows64, cols64 = np.vectorize(wgmma_acc_coord)(tid32, reg32)
    for wg in (0, 1):
        j = slice(64 * wg, 64 * wg + 64)
        cbT = sum(_desc_read(slots, b6_desc_start("b", t, wg=wg), 64, True)
                  @ _desc_read(slots, b6_desc_start("c", t), 128, True).T
                  for t in range(N // 16))
        np.testing.assert_array_equal(cbT, Bm[j] @ Cm.T)
        dattT = sum(_desc_read(sx, b6_desc_start("x", t, wg=wg), 64, True)
                    @ _desc_read(sg, b6_desc_start("g", t), 128, True).T
                    for t in range(P // 16))
        np.testing.assert_array_equal(dattT, X[j] @ Gt.T)
        # attᵀ from the accumulator as hi and lo A fragments, times g
        # N-major, k-steps over i from 4 for the second warpgroup
        att = np.triu(_bf16_values(rng, (64, 128)), 64 * wg)
        dx = np.zeros((64, P))
        for t in range(4 * wg, 8):
            Bg = _desc_read(sg, b6_desc_start("g_n", t), 64, False)
            dx += _pack_a(att[rows, cols], 128)[:, 16 * t:16 * t + 16] @ Bg.T
        np.testing.assert_array_equal(dx, att @ Gt)
        # the dx epilogue: accumulator element 4c + 2x + b is (row, column)
        # r0 + 8x, 8c + c0 + b
        for t_ in range(0, 128, 37):
            for e in range(32):
                c, x, b = e // 4, (e // 2) % 2, e % 2
                assert (rows64[t_, e], cols64[t_, e]) == (
                    16 * (t_ // 32) + (t_ % 32) // 4 + 8 * x,
                    8 * c + 2 * (t_ % 4) + b)
    # column sums of T: one warp's 32 lanes × 32 partials (value 2c + b is
    # column 8c + c0 + b) reduce-scattered by halve over masks 16, 8, 4;
    # lane l then holds values (l & 28) + q, each summed over the 8 lanes
    # of its class l & 3, and every column is written once
    part = rng.normal(size=(32, 32))
    v = halve_lanes(halve_lanes(halve_lanes(part, 16), 8), 4)
    written = {}
    for lane in range(32):
        for q in range(4):
            vi = (lane & 28) + q
            col = 8 * (vi >> 1) + 2 * (lane & 3) + (vi & 1)
            assert col not in written
            written[col] = v[lane, q]
            want = sum(part[ln, vi] for ln in range(32)
                       if ln & 3 == lane & 3)
            np.testing.assert_allclose(v[lane, q], want, rtol=1e-12)
    assert sorted(written) == list(range(128))
