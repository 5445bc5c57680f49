"""Random sampling primitives for the Gibbs sweep — the PyTorch
counterpart of cogaps_tpu/ops/rng.py, plus the Philox4x32-10 counter
generator that the CUDA sweep kernel (csrc/sweep.cu) carries.

Every formula here is written as the same sequence of float32
operations as its twin in csrc/sweep.cu, so that the plain sweep and the
kernel make the same decisions on the same uniforms:

* ``ndtr(x) = 0.5 * erfc(x * (-1/sqrt(2)))``: on the card torch.erfc
  reaches the same CUDA math function as erfcf in the kernel.
* ``ndtri`` is Acklam's rational approximation plus one Halley step,
  written as single operations (+, -, *, /, sqrt, log, exp, erfc), so
  both sides round it alike.
  (The JAX package uses jax.scipy.special.ndtr/ndtri on the CPU; the
  two agree to a few float32 ulps, so a decision that sits exactly on a
  threshold can differ between the packages.)
* No tensor is divided by a Python number, nor a Python number by a
  tensor: PyTorch turns those into multiplications by a reciprocal
  (on CUDA, and for ``number / tensor`` everywhere). Constants are
  multiplied in, or divided as tensors.

Distribution semantics follow the reference (src/math/Random.cpp):
``trunc_normal`` fails when more than 95% of the mass lies outside the
window (Random.cpp:178-191); exponential by inverse CDF (:172-175); the
truncated shape-2 gamma by Newton inversion (the reference's qgamma
table, :194-200).
"""

from __future__ import annotations

import torch

# the reference's global epsilon (reference: src/math/Math.h)
EPSILON = 1.0e-10
NEG_INV_SQRT2 = -0.7071067811865476

# Philox4x32-10 constants (Salmon et al., SC'11; Random123)
_PHILOX_M0 = 0xD2511F53
_PHILOX_M1 = 0xCD9E8D57
_PHILOX_W0 = 0x9E3779B9
_PHILOX_W1 = 0xBB67AE85
_MASK32 = 0xFFFFFFFF
TWO_POW_M24 = 2.0 ** -24


def ndtr(x):
    return 0.5 * torch.erfc(x * NEG_INV_SQRT2)


def ndtri(q):
    """Inverse normal CDF, one elementwise operation at a time: Acklam's
    rational approximation on p = min(q, 1-q) (exact), refined by one
    Halley step on ndtr(x) = p, where x <= 0 and ndtr is accurate
    (float32 cancellation in Acklam's central polynomial alone leaves
    ~2e-4 relative error). sqrt(2)*erfinv(2q-1) is not used: 2q-1 cancels
    for small q, which costs up to 0.5% at q = 1e-7 in float32.
    q must lie in (0, 1).

    The four polynomials run as one Horner loop over a stacked (4, ...)
    tensor; the shorter ones are padded with leading zeros, and
    0 * x + c == c exactly, so each is the plain Horner sequence."""
    upper = q > 0.5
    p = torch.where(upper, 1.0 - q, q)
    h = p - 0.5
    r = h * h
    t = torch.sqrt(-2.0 * torch.log(p))
    xs = torch.stack([r, r, t, t])
    coef = _ACKLAM.to(q.device).view((4, 6) + (1,) * q.dim())
    acc = coef[:, 0] * xs + coef[:, 1]
    for j in range(2, 6):
        acc = acc * xs + coef[:, j]
    num_mid, den_mid, num_tail, den_tail = acc
    x = torch.where(p < ACKLAM_P_LOW, num_tail / (den_tail * t + 1.0),
                    num_mid * h / (den_mid * r + 1.0))
    e = ndtr(x) - p
    u = e * SQRT_2PI * torch.exp(x * x * 0.5)
    x = x - u / (1.0 + x * u * 0.5)
    return torch.where(upper, -x, x)


# Acklam's coefficients, highest power first, each row padded to six with
# leading zeros: central numerator, central denominator, tail numerator,
# tail denominator (the denominators' constant term 1 is added apart)
_ACKLAM = torch.tensor([
    [-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
     1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00],
    [0.0, -5.447609879822406e+01, 1.615858368580409e+02,
     -1.556989798598866e+02, 6.680131188771972e+01, -1.328068155288572e+01],
    [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
     -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00],
    [0.0, 0.0, 7.784695709041462e-03, 3.224671290700398e-01,
     2.445134137142996e+00, 3.754408661907416e+00]], dtype=torch.float32)
ACKLAM_P_LOW = 0.02425
SQRT_2PI = 2.5066282746310002


def trunc_normal(u, a, b, mean, sd):
    """Truncated-normal draw via inverse CDF, with the reference's
    far-tail failure rule. `a`, `b` are tensors broadcastable to `u`.
    Returns (value clipped to [a, b], ok)."""
    sd = torch.clamp(sd, min=1e-30)
    p_lower = ndtr((a - mean) / sd)
    p_upper = ndtr((b - mean) / sd)
    ok = ~((p_lower > 0.95) | (p_upper < 0.05))
    q = p_lower + u * (p_upper - p_lower)
    q = torch.clamp(q, 1e-7, 1.0 - 1e-7)
    z = mean + sd * ndtri(q)
    z = torch.minimum(torch.maximum(z, a), b)
    return z, ok


def gibbs_mass(u, s, s_mu, a, b, lam=None):
    """The conditional "gibbs mass" draw (reference:
    src/gibbs_sampler/AlphaParameters.cpp:27-48): a truncated normal with
    mean (s_mu - lambda)/s (s_mu/s without lambda — the exchange form)
    and sd 1/sqrt(s); fails when s <= epsilon. The sd is an IEEE
    reciprocal of an IEEE square root (rsqrt is approximate on the
    card)."""
    s_safe = torch.clamp(s, min=EPSILON)
    mu = ((s_mu - lam) if lam is not None else s_mu) / s_safe
    sd = torch.reciprocal(torch.sqrt(s_safe))
    val, ok = trunc_normal(u, a, b, mu, sd)
    return val, ok & (s > EPSILON)


def exponential(u, lam):
    """Exp(lam) via inverse CDF (reference: src/math/Random.cpp:172-175)."""
    return -torch.log(torch.clamp(u, min=1e-30)) / lam


def log_uniform(u):
    """log(U) for Metropolis accepts, guarded against log(0)."""
    return torch.log(torch.clamp(u, min=1e-37))


def poisson_fast(z, lam):
    """Update-budget draw round(N(lam, sqrt(lam))), clipped at 0, from a
    standard normal `z` (cogaps_tpu/ops/rng.poisson_fast takes a key and
    draws z itself). The budget sets how much work an iteration does,
    not the stationary distribution."""
    return torch.clamp(torch.round(lam + torch.sqrt(torch.clamp(lam, min=0.0))
                                   * z), min=0.0).to(torch.int32)


def budget(z, n_atoms):
    """The engine's update budget of a sampler with `n_atoms` atoms:
    poisson_fast at lam = max(n_atoms, 10) (GapsRunner.cpp:293-296).
    csrc/span.cu::budget_of computes it in the kernel."""
    return poisson_fast(z, torch.clamp(n_atoms, min=10).float())


def poisson(lam: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Exact Poisson update-budget draw (reference: src/math/Random.cpp:
    125-170), on lam's device from an explicit generator; the atlas
    engine's budgets (cogaps_tpu/ops/rng.poisson draws them with
    jax.random.poisson, so the two packages agree in distribution)."""
    return torch.poisson(lam, generator=generator).to(torch.int32)


def trunc_gamma2_y(u, b):
    """Inverse CDF of a shape-2 gamma truncated to [0, b], in y = x/scale:
    solves 1 - e^-y (1+y) = u * upper by 12 Newton steps (the same-bin
    exchange redistribution, ProposalQueue.cpp:267-277)."""
    b = torch.clamp(b, min=1e-6)
    upper = 1.0 - torch.exp(-b) * (1.0 + b)
    q = torch.clamp(u * upper, min=1e-12)
    y = torch.minimum(torch.clamp(torch.sqrt(2.0 * q), min=1e-6), b)
    for _ in range(12):
        ey = torch.exp(-y)
        h = 1.0 - ey * (1.0 + y)
        dh = torch.clamp(ey * y, min=1e-30)
        y = torch.minimum(torch.clamp(y - (h - q) / dh, min=1e-7), b)
    return y


# ----------------------------------------------------------------------
# Philox4x32-10 on int64 tensors holding uint32 words
# ----------------------------------------------------------------------
def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of m * x for uint32 m and uint32 words x,
    without overflowing int64: x is split into 16-bit halves."""
    xh = x >> 16
    xl = x & 0xFFFF
    ph = m * xh  # < 2^48
    pl = m * xl  # < 2^48
    lo = (((ph & 0xFFFF) << 16) + pl) & _MASK32
    hi = (ph + (pl >> 16)) >> 16
    return hi, lo


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 of the counter words (c0..c3) under key (k0, k1).
    Words are int64 tensors (or ints) in [0, 2^32); returns four int64
    tensors. csrc/sweep.cu::philox is the same function."""
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W0) & _MASK32
            k1 = (k1 + _PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def to_unit(w):
    """uint32 word -> float32 uniform in [0, 1): (w >> 8) * 2^-24, exact."""
    return (w >> 8).to(torch.float32) * TWO_POW_M24


def philox_uniforms(key0, key1: int, chain: int, first_sweep: int,
                    n_sweeps: int, B: int, device=None):
    """The uniform blocks of sweeps [first, first + n) in the kernel's
    fast mode, as one (n*16, B) slab: in sweep s, lane l, row 4g+j is
    word j of philox((l, g, s, chain), (key0, key1)). `key0` is the
    chain's seed word (int or 0-dim tensor); the kernel's counter word
    `chain` is 0, whatever the chain (ops/sweep_cuda.PhiloxKey)."""
    shape = (n_sweeps, 4, B)
    sweep = torch.arange(first_sweep, first_sweep + n_sweeps,
                         dtype=torch.int64, device=device)
    g = torch.arange(4, dtype=torch.int64, device=device)
    lane = torch.arange(B, dtype=torch.int64, device=device)
    words = philox4x32(lane.expand(shape), g[:, None].expand(shape),
                       sweep[:, None, None].expand(shape),
                       torch.full(shape, chain, dtype=torch.int64,
                                  device=device),
                       key0 & _MASK32, key1 & _MASK32)
    # (n, 4 groups, 4 words, B) -> rows 4g + j
    return to_unit(torch.stack(words, dim=2)).reshape(n_sweeps * 16, B)


def philox_normals(key0, key1s):
    """Two standard normals per chain and key word (Box-Muller on the four
    words of philox((0, 0, 0, 0), (key0[chain], key1))): the update
    budgets of the A and P samplers. `key0` is an (NCH,) int64 tensor,
    `key1s` a (T,) int64 tensor; returns two (NCH, T) tensors. A chain's
    normals are its seed word's alone."""
    zero = torch.zeros((key0.shape[0], 1), dtype=torch.int64,
                       device=key0.device)
    w = philox4x32(zero, zero, zero, zero, (key0 & _MASK32)[:, None],
                   (key1s & _MASK32)[None, :])
    u = [to_unit(x) for x in w]
    two_pi = 6.283185307179586

    def box_muller(u1, u2):
        return (torch.sqrt(-2.0 * torch.log(1.0 - u1))
                * torch.cos(two_pi * u2))

    return box_muller(u[0], u[1]), box_muller(u[2], u[3])
