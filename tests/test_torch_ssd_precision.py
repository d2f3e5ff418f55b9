"""The port's SSD scan and Mamba-2 LM against the benchmark's plain
reference (``hippo_bench/reference``) run in float64, at the chunk of the
benchmark's ``mamba2-2.7b-f32`` configuration (Q 128) over two chunks, so
the state hand-off between chunks runs.

Two regimes of the step sizes ``dt``, with ``A = −(1 .. 16)`` across the
heads as the weights rule and upstream Mamba-2 both draw it:

* ``benchmark``: the weights rule's ``dt_bias`` 0, so ``dt ≈ softplus(N(0,
  1))``: a chunk's cumulative log-decay reaches about −1,000, where a
  float32 ulp is 6e-5 and the scan's exponents and the log-decays'
  gradients are ill-conditioned;
* ``upstream``: Mamba-2's initialisation, ``dt`` log-uniform in [1e-3,
  0.1], under which every head keeps its state for tens to thousands of
  steps and the inter-chunk state carries weight.

``chip_smoke.py``'s SSD phase holds the float32 route at the
configuration's own shape on the card.
"""

import math
import os
import sys
import warnings

import pytest
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from hippo_bench import cells, weights                          # noqa: E402
from hippo_bench.reference import lm as ref                     # noqa: E402
from hippo_bench.reference import ssd as ref_ssd                # noqa: E402
from repro_torch.kernels import ops as kops                     # noqa: E402
from repro_torch.models.ssm import ssd_chunked                  # noqa: E402
from repro_torch.models.transformer import LM                   # noqa: E402
from repro_torch.train.torch_trainer import value_and_grad      # noqa: E402

# the suite runs several worker processes side by side: one intra-op
# thread each, or the workers fight over the cores
torch.set_num_threads(1)

Q = 128                       # the configuration's chunk
REGIMES = ["benchmark", "upstream"]
ROUTES = ["plain", "kernel"]  # on the CPU the kernel route takes B5 / B6's
                              # plain versions through the same binding
NAMES = ("y", "dx", "ddt", "dA_log", "dB", "dC")

# Relative L2 distance from float64, for a float32 computation.  Measured
# on this file's shapes (CPU): the port reads 8e-8 to 2.3e-7 on every
# output; the scan with its log-decays summed in float32 (the reference's
# formula, and the port's before) reads up to 4.8e-5 on dA_log and 6.2e-6
# on ddt in the benchmark regime.  2e-6 is nine times the port's reading
# and below the float32 sums'.
SCAN_TOL = 2e-6
# The 2-layer LM's loss (nats) and each leaf's gradient: the port reads up
# to 6e-7 (loss) and 2.7e-6 (leaves: B's and C's streams, A_log, dt_bias);
# with float32 sums A_log reads 2.5e-5.  2e-6 and 1e-5 leave three and
# four times the port's reading.
LOSS_TOL, LEAF_TOL = 2e-6, 1e-5


def dt_of(regime, shape, gen):
    if regime == "benchmark":
        return F.softplus(torch.randn(shape, generator=gen))
    lo, hi = math.log(1e-3), math.log(0.1)
    return torch.exp(lo + (hi - lo) * torch.rand(shape, generator=gen))


def scan_inputs(regime, seed, B=2, S=2 * Q, H=4, P=16, N=16):
    gen = torch.Generator().manual_seed(seed)
    x = F.silu(torch.randn((B, S, H, P), generator=gen))
    Bm = F.silu(torch.randn((B, S, N), generator=gen))
    Cm = F.silu(torch.randn((B, S, N), generator=gen))
    dt = dt_of(regime, (B, S, H), gen)
    A_log = torch.log(torch.linspace(1.0, 16.0, H))
    g = torch.randn((B, S, H, P), generator=gen)
    return (x, dt, A_log, Bm, Cm), g


def scan_grads(fn, leaves, g, dtype):
    ins = [t.detach().to(dtype).requires_grad_(True) for t in leaves]
    x, dt, A_log, Bm, Cm = ins
    y = fn(x, dt, -torch.exp(A_log), Bm, Cm)
    return [y.detach()] + list(torch.autograd.grad(y, ins, g.to(dtype)))


def rel(got, want):
    want = want.double()
    return float((got.double() - want).norm() / want.norm())


def port_scan(route):
    def fn(x, dt, A, Bm, Cm):
        return ssd_chunked(x, dt, A, Bm, Cm, Q,
                           use_kernel=route == "kernel")[0]
    return fn


def ref_scan(x, dt, A, Bm, Cm):
    return ref_ssd.ssd(x, dt, A, Bm, Cm, Q, torch.matmul)


@pytest.fixture
def quiet_fallbacks():
    """The kernel route on CPU tensors takes the plain versions, counted
    and warned once per process: keep the warning out of the next test."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", kops.KernelFallbackWarning)
        yield
    kops.reset_kernel_stats()


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("regime", REGIMES)
def test_ssd_scan_matches_reference_in_float64(regime, route,
                                               quiet_fallbacks):
    """y and the five gradients of the port's scan in float32 against the
    reference's scan in float64, each within SCAN_TOL."""
    leaves, g = scan_inputs(regime, seed=7 + REGIMES.index(regime))
    want = scan_grads(ref_scan, leaves, g, torch.float64)
    got = scan_grads(port_scan(route), leaves, g, torch.float32)
    errs = {n: rel(a, b) for n, a, b in zip(NAMES, got, want)}
    assert all(e <= SCAN_TOL for e in errs.values()), errs
    if regime == "upstream":
        # the hand-off carries weight: the second chunk's output moves
        # when the first chunk's state is dropped
        x, dt, A_log, Bm, Cm = leaves
        alone = ref_scan(x[:, Q:], dt[:, Q:], -torch.exp(A_log), Bm[:, Q:],
                         Cm[:, Q:])
        assert rel(alone, want[0][:, Q:]) > 0.05


def small_lm_config(regime):
    cfg = dict(cells.load_config("mamba2-2.7b-f32"))
    cfg.update(d_model=64, d_state=16, chunk_size=Q, n_layer=2,
               vocab_size=256, seq_len=2 * Q, batch=2)
    return cfg


def small_lm(regime, seed):
    """The port's LM over the benchmark's weights at small widths; in the
    upstream regime each head's ``dt_bias`` is softplus⁻¹ of a
    log-uniform ``dt``."""
    cfg = small_lm_config(regime)
    mc = cells.port_config(cfg)
    with torch.device("meta"):
        skeleton = LM(mc).init(torch.Generator())
    params = weights.make_params(skeleton, mc.d_model, seed, "cpu")
    if regime == "upstream":
        block = params["cycles"][0]["ssm"]
        gen = torch.Generator().manual_seed(seed)
        dt = dt_of(regime, tuple(block["dt_bias"].shape), gen)
        block["dt_bias"] = dt + torch.log(-torch.expm1(-dt))
    tokens = weights.make_tokens(cfg["batch"], cfg["seq_len"],
                                 cfg["vocab_size"], seed, "cpu")
    return cfg, mc, params, tokens


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("regime", REGIMES)
def test_lm_loss_and_gradients_match_reference_in_float64(regime, route,
                                                          quiet_fallbacks):
    """A 2-layer Mamba-2 LM: the port's loss and every leaf's gradient in
    float32 against the reference's in float64 (the same weights and
    tokens), within LOSS_TOL and LEAF_TOL."""
    cfg, mc, params, tokens = small_lm(regime, 11 + REGIMES.index(regime))
    lm = LM(mc, use_kernel=route == "kernel")
    (loss, _), grads = value_and_grad(lm.loss, params,
                                      {"tokens": tokens.long()})
    model = ref.ReferenceLM(cfg)
    want_loss, want = model.loss_and_grads(
        {k: v.double() for k, v in ref.flat(params).items()}, tokens)
    assert abs(float(loss) - want_loss) <= LOSS_TOL
    got = ref.flat(grads)
    errs = {"/".join(map(str, k)): rel(got[k], want[k]) for k in want}
    assert all(e <= LEAF_TOL for e in errs.values()), errs
