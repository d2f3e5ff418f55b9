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
