"""Spherical harmonic transform: Legendre products and the engine FFT.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/sht.py``: the
analysis/synthesis pair between values on a Gauss-Legendre (or equiangular)
× equiangular sphere grid and spherical-harmonic coefficients, and the
operators built on it (Laplacian, Poisson solve, zonal convolution,
gradient, divergence, vorticity, Helmholtz decomposition, vector
harmonics, rotation).

Longitude is the engine's batched FFT of length 2L (on the card the fused
Stockham kernel takes it wherever 2L is 7-smooth and ≤ 16,384).  Latitude
contracts against normalized associated Legendre tables P̄_lm(mu_i) built in
float64 on the host (stable three-term recurrence, Condon-Shortley phase,
matching scipy.special.sph_harm_y) and stored as fp32 triangular chunks over
m ≥ 0 (``_M_TILE`` orders a chunk; P̄_{l,-m} = (-1)^m P̄_lm folds the
negative orders into sign flips on the coefficients).  The chunks are kept
on the device (``utils.numerics.constant`` with a key), so a call can be
captured in a CUDA graph; each chunk's contraction is one batched product
at the config's ``op_precision``.  A real field takes the Hermitian path (rfft/irfft,
half the Legendre work).

Above ``_TABLES_MAX_L`` the tables give way to the recurrence pair
:func:`sht_recurrence` / :func:`isht_recurrence`: O(L²) memory, the
Legendre plane carried through a loop over degree l with exact power-of-two
rescaling (``compensated=True`` carries it as a double-word fp32 pair).
Each step is about ten small kernels, so the loop is bound by the host's
launches; it is not captured in a CUDA graph here.

Conventions: orthonormal complex Y_lm with Condon-Shortley phase;
a = sht(f) has a[m_idx, l] = ∫ f Y*_lm dΩ with the m axis packed
[0, 1, …, L-1, -(L-1), …, -1] and zeros for l < |m|.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..utils.config import DEFAULT_CONFIG, DTYPE, SpectralConfig
from ..utils.numerics import (
    as_tensor,
    as_tensors,
    constant,
    dw_add as _dw_add,
    dw_mul as _dw_mul,
    host_table,
    matmul_precision,
)
from .fft import fft, ifft
from .rfft import irfft, rfft

Tensor = torch.Tensor
_CDTYPE = torch.complex64

# m-axis tile of the triangular Legendre chunks
_M_TILE = 128
# band limit above which sht/isht take the O(L^2)-memory recurrence path
_TABLES_MAX_L = 1024


@functools.lru_cache(maxsize=16)
def _gauss_grid(L: int):
    """Gauss-Legendre nodes, weights and colatitudes (host fp64)."""
    mu, w = np.polynomial.legendre.leggauss(L)
    return mu, w, np.arccos(mu)


@functools.lru_cache(maxsize=16)
def _eq_grid(L: int):
    """Equiangular latitude grid for band limit lmax = L-1: nlat = 2L
    midpoint colatitudes with Fejér-type weights, exact for every Legendre
    moment of degree < 2L."""
    n = 2 * L
    j = np.arange(n)
    theta = np.pi * (2.0 * j + 1.0) / (2.0 * n)
    m = np.arange(1, n + 1)
    beta = np.where(m % 2 == 1, 2.0 / m, 0.0)
    c = (2.0 / n) * (np.sin(np.outer(theta, m)) @ beta)
    return np.cos(theta), c * np.sin(theta), theta


_GRIDS = ("gauss", "equiangular")


def _grid_arrays(L: int, grid: str):
    if grid == "gauss":
        return _gauss_grid(L)
    if grid == "equiangular":
        return _eq_grid(L)
    raise ValueError(f"grid must be one of {_GRIDS}, got {grid!r}")


def _host_recurrence_tables(L: int, grid: str = "gauss"):
    """Host fp64 (L, L) recurrence coefficients A[l, m], B[l, m] (zero
    where invalid) and sectoral seeds pmm[m, i]."""
    mu, _, _ = _grid_arrays(L, grid)
    lf = np.arange(L, dtype=np.float64)[:, None]
    mf = np.arange(L, dtype=np.float64)[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        A = np.sqrt((4.0 * lf * lf - 1.0) / (lf * lf - mf * mf))
        B = np.sqrt(
            ((2.0 * lf + 1.0) * ((lf - 1.0) ** 2 - mf * mf))
            / ((2.0 * lf - 3.0) * (lf * lf - mf * mf))
        )
    A = np.where(lf > mf, A, 0.0)
    B = np.where(lf > mf + 1, B, 0.0)
    st = np.sqrt(np.clip(1.0 - mu * mu, 0.0, None))
    pmm = np.empty((L, len(mu)))
    pmm[0] = 1.0 / math.sqrt(4.0 * math.pi)
    for m in range(1, L):
        pmm[m] = -math.sqrt((2.0 * m + 1.0) / (2.0 * m)) * st * pmm[m - 1]
    return A, B, pmm, mu


def _legendre_l_iter(L: int, grid: str = "gauss"):
    """Yield (l, P_l, P_{l-1}) with P_l the fp64 (m, i) Legendre plane."""
    A, B, pmm, mu = _host_recurrence_tables(L, grid)
    p1 = np.zeros((L, len(mu)))
    p2 = np.zeros((L, len(mu)))
    for l in range(L):
        p = A[l][:, None] * mu[None, :] * p1 - B[l][:, None] * p2
        p[l] = pmm[l]  # sectoral seed at m == l
        yield l, p, p1
        p2, p1 = p1, p


def _chunk_shells(L: int, nlat: int):
    """Empty triangular fp32 chunk set [(m0, (t, L-m0, nlat))…]."""
    out = []
    for m0 in range(0, L, _M_TILE):
        t = min(_M_TILE, L - m0)
        out.append((m0, np.zeros((t, L - m0, nlat), np.float32)))
    return out


def _fill_chunks(L: int, plane_iter, nlat: int):
    """Fill triangular chunks from an l-major (l, plane) iterator."""
    chunks = _chunk_shells(L, nlat)
    for l, plane in plane_iter:
        for m0, arr in chunks:
            if l >= m0:
                arr[:, l - m0, :] = plane[m0: m0 + arr.shape[0]]
    return tuple(chunks)


@functools.lru_cache(maxsize=8)
def _legendre_chunks(L: int, grid: str = "gauss"):
    """Triangular m >= 0 Legendre chunks for band limit lmax = L-1 (fp32)."""
    nlat = L if grid == "gauss" else 2 * L
    return _fill_chunks(L, ((l, p) for l, p, _ in _legendre_l_iter(L, grid)), nlat)


def _neg_signs(L: int) -> np.ndarray:
    """(-1)^m for m = 0..L-1."""
    return (-1.0) ** np.arange(L, dtype=np.float64)


def sht_grid(lmax: int, dtype=np.float64, grid: str = "gauss"):
    """(theta, phi, weights) of the analysis grid for band limit ``lmax``
    (L = lmax+1), host numpy: ``grid="gauss"`` is (L, 2L) Gauss-Legendre
    colatitudes × equiangular longitudes, ``grid="equiangular"`` (2L, 2L).
    sum(f * weights[:, None]) * (2*pi/nlon) integrates over the sphere."""
    if lmax < 0:
        raise ValueError(f"lmax must be >= 0, got {lmax}")
    L = lmax + 1
    _, w, theta = _grid_arrays(L, grid)
    phi = 2.0 * np.pi * np.arange(2 * L) / (2 * L)
    return theta.astype(dtype), phi.astype(dtype), w.astype(dtype)


def _select_packed_m(F: Tensor, L: int) -> Tensor:
    """Full FFT longitude bins restricted to the band limit in packed m
    order [0..L-1, -(L-1)..-1] (the Nyquist bin L is dropped)."""
    return torch.cat([F[..., :L], F[..., L + 1:]], dim=-1)


def _fold_neg_last(Fsel: Tensor, L: int) -> Tensor:
    """The packed negative-m bins (last axis) onto ascending m' = 0..L-1
    with the (-1)^m' parity; row m'=0 is zero."""
    half = torch.flip(Fsel[..., L:], (-1,))
    z = Fsel.new_zeros(Fsel.shape[:-1] + (1,))
    sign = host_table("sht_neg_signs", _neg_signs, L, like=Fsel)
    return torch.cat([z, half], dim=-1) * sign


def _bmm_planes(P: Tensor, X: Tensor, precision: str) -> Tensor:
    """Batched real P (t, a, b) @ complex X (t, b, n) as products at
    ``precision`` on the stacked (re, im) planes: (t, a, n) complex."""
    xr, xi = X.real, X.imag
    n = xr.shape[-1]
    with matmul_precision(precision):
        y = torch.bmm(P, torch.cat([xr, xi], dim=-1))
    return torch.complex(y[..., :n], y[..., n:])


# The host tables are reached by hashable keys: the tables of one (L, grid)
# are built on the host once (lru_cache) and kept on the device
# (``host_table``), also while dynamo traces a call, whose graph then holds
# the kept tensors: no table is traced, copied or uploaded per call.


def _chunk(kind: str, L: int, grid: str, m0: int, band) -> np.ndarray:
    chunks = (_legendre_chunks if kind == "sht_legendre" else _legendre_deriv_chunks)(L, grid)
    P = chunks[m0 // _M_TILE][1]
    return P if band is None else np.ascontiguousarray(P[..., band[0]: band[1]])


def _chunk_on(kind: str, L: int, grid: str, m0: int, like: Tensor, band=None) -> Tensor:
    """The (t, L − m0, nlat) chunk of ``kind``'s triangular tables
    ("sht_legendre", "sht_dlegendre") that starts at order m0, beside
    ``like``; ``band``, a (start, stop) pair, cuts its latitudes (a rank's
    band of the sharded transforms)."""
    return host_table("sht_chunk", _chunk, kind, L, grid, m0, band, like=like)


def _grid_table(name: str, L: int, grid: str) -> np.ndarray:
    _, w, theta = _grid_arrays(L, grid)
    if name == "sht_sin":
        return np.sin(theta)
    dphi = 2.0 * math.pi / (2 * L)
    return w * dphi if name == "sht_weights" else (w / np.sin(theta)) * dphi


def _grid_on(name: str, L: int, grid: str, like: Tensor) -> Tensor:
    """A latitude table of the (L, grid) sphere grid beside ``like``: the
    quadrature weights times dφ ("sht_weights"), the same over sin θ
    ("sht_weights_sin"), or sin θ ("sht_sin")."""
    return host_table("sht_grid", _grid_table, name, L, grid, like=like)


def _chunk_starts(L: int) -> range:
    return range(0, L, _M_TILE)


def _analyze(kind: str, Fsel: Tensor, weights: Tensor, L: int, config=DEFAULT_CONFIG,
             hermitian: bool = False, grid: str = "gauss", band=None) -> Tensor:
    """Latitude contraction of analysis: a[…, q, l] = Σ_i P̄[m, l, i] ·
    weights[i] · F[…, i, q] over the packed q axis, chunk by chunk over m
    (negative orders through the coefficient-side parity fold).
    ``hermitian=True`` is the real-field path: ``Fsel`` carries only the
    m >= 0 bins (…, i, L) of an rfft, and a_{l,-m} = (-1)^m conj(a_{lm}).
    ``kind`` names the tables ("sht_legendre", "sht_dlegendre") of
    (L, ``grid``), cut to the latitudes ``band`` where given
    (:func:`_chunk_on`); ``weights`` are the (nlat,) quadrature weights."""
    Fw = Fsel.to(_CDTYPE) * weights[:, None]
    fpos = Fw[..., :L]
    srcs = [fpos] if hermitian else [fpos, _fold_neg_last(Fw, L)]
    lead = Fsel.shape[:-2]
    nlat = Fsel.shape[-2]
    parts = [[] for _ in srcs]
    for m0 in _chunk_starts(L):
        Pj = _chunk_on(kind, L, grid, m0, Fsel, band)
        t = Pj.shape[0]
        for src, out in zip(srcs, parts):
            X = src[..., m0: m0 + t].reshape(-1, nlat, t).permute(2, 1, 0)  # (t, i, B)
            y = _bmm_planes(Pj, X, config.op_precision)               # (t, l, B)
            y = y.permute(2, 0, 1).reshape(lead + (t, L - m0))
            out.append(torch.nn.functional.pad(y, (m0, 0)))
    apos = torch.cat(parts[0], dim=-2)  # (…, L, L) m-major
    if hermitian:
        sign = host_table("sht_neg_signs", _neg_signs, L, like=apos)
        aneg = torch.conj(apos) * sign[:, None]
    else:
        aneg = torch.cat(parts[1], dim=-2)
    return torch.cat([apos, torch.flip(aneg[..., 1:, :], (-2,))], dim=-2)


def _grid_shape_L(f: Tensor, grid: str) -> int:
    if grid == "equiangular":
        if f.ndim < 2 or f.shape[-1] < 2 or f.shape[-2] != f.shape[-1] or f.shape[-1] % 2:
            raise ValueError(
                "equiangular f must be even-square (…, 2L, 2L) — got "
                f"{tuple(f.shape[-2:]) if f.ndim >= 2 else tuple(f.shape)}")
        return f.shape[-1] // 2
    if f.ndim < 2 or f.shape[-2] < 1 or f.shape[-1] != 2 * f.shape[-2]:
        raise ValueError(
            "f must be (…, L, 2L) on the sht_grid — got "
            f"{tuple(f.shape[-2:]) if f.ndim >= 2 else tuple(f.shape)}")
    return f.shape[-2]


def sht(f, *, grid: str = "gauss", config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Spherical harmonic analysis -> (…, 2L-1, L) coefficients a[m_idx, l]
    (packed m axis, zeros below the |m| diagonal).  "gauss" expects
    (…, L, 2L) values, "equiangular" (…, 2L, 2L); both exact for
    band-limited fields."""
    f = as_tensor(f)
    if grid not in _GRIDS:
        raise ValueError(f"grid must be one of {_GRIDS}, got {grid!r}")
    L = _grid_shape_L(f, grid)
    if L > _TABLES_MAX_L:
        if grid != "gauss":
            raise ValueError(
                f"equiangular sht is table-based and capped at L={_TABLES_MAX_L} "
                f"(got L={L}); the O(L^2)-memory recurrence path is Gauss-grid "
                "only — resample to the Gauss grid for larger band limits")
        return sht_recurrence(f, config=config)
    if not f.is_complex():
        # real field: rfft bins 0..L cover every order by a_{l,-m} = (-1)^m conj(a_{lm})
        Fpos = rfft(f.to(DTYPE), config=config)[..., :L]
        return _analyze("sht_legendre", Fpos, _grid_on("sht_weights", L, grid, Fpos), L,
                        config, hermitian=True, grid=grid)
    Fsel = _select_packed_m(fft(f, config=config), L)
    return _analyze("sht_legendre", Fsel, _grid_on("sht_weights", L, grid, Fsel), L, config,
                    grid=grid)


def _check_alm(alm: Tensor) -> int:
    if alm.ndim < 2 or alm.shape[-1] < 1 or alm.shape[-2] != 2 * alm.shape[-1] - 1:
        raise ValueError(
            "alm must be (…, 2L-1, L) packed coefficients — got "
            f"{tuple(alm.shape[-2:]) if alm.ndim >= 2 else tuple(alm.shape)}")
    return alm.shape[-1]


def isht(alm, *, real_output: bool = False, grid: str = "gauss",
         config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Spherical harmonic synthesis: (…, 2L-1, L) coefficients -> grid
    values (complex) — (…, L, 2L) for "gauss", (…, 2L, 2L) "equiangular".
    ``real_output=True`` is the path for coefficients with the real-field
    symmetry a_{l,-m} = (-1)^m conj(a_{lm}): only the m >= 0 bins are
    synthesized and longitude runs through irfft (real result; the
    negative-m coefficients are ignored)."""
    alm = as_tensor(alm)
    L = _check_alm(alm)
    if grid not in _GRIDS:
        raise ValueError(f"grid must be one of {_GRIDS}, got {grid!r}")
    if L > _TABLES_MAX_L:
        if grid != "gauss":
            raise ValueError(
                f"equiangular isht is table-based and capped at L={_TABLES_MAX_L} "
                f"(got L={L}); the O(L^2)-memory recurrence path is Gauss-grid "
                "only — synthesize on the Gauss grid for larger band limits")
        return isht_recurrence(alm, real_output=real_output, config=config)
    return _synthesize("sht_legendre", alm, config, hermitian=real_output, grid=grid)


def _degree_scale(values, L: int, like: Tensor, *args) -> Tensor:
    """The per-degree table ``values(L, *args)`` beside ``like``."""
    return host_table(values.__name__, values, L, *args, like=like)


def _laplacian(L: int) -> np.ndarray:
    l = np.arange(L, dtype=np.float64)
    return -(l * (l + 1.0))


def _inv_laplacian(L: int) -> np.ndarray:
    l = np.arange(L, dtype=np.float64)
    inv = np.zeros(L)
    inv[1:] = -1.0 / (l[1:] * (l[1:] + 1.0))
    return inv


def sphere_laplacian(f, *, grid: str = "gauss", config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Laplace-Beltrami operator on the unit sphere: sht, scale by
    -l(l+1), isht."""
    f = as_tensor(f)
    a = sht(f, grid=grid, config=config)
    a = a * _degree_scale(_laplacian, a.shape[-1], a)
    return isht(a, real_output=not f.is_complex(), grid=grid, config=config)


def poisson_solve_sphere(f, *, grid: str = "gauss",
                         config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Solve Δu = f on the unit sphere (zero-mean gauge): each coefficient
    divided by -l(l+1), the l = 0 mode projected out."""
    f = as_tensor(f)
    a = sht(f, grid=grid, config=config)
    ai = a * _degree_scale(_inv_laplacian, a.shape[-1], a)
    return isht(ai, real_output=not f.is_complex(), grid=grid, config=config)


def sphere_convolve(f, bl, *, grid: str = "gauss",
                    config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Convolve a sphere field with an isotropic (zonal) kernel: multiply
    a_lm by the kernel's per-degree coefficients ``bl`` (length L)."""
    f, b = as_tensors(f, bl)
    a = sht(f, grid=grid, config=config)
    L = a.shape[-1]
    if tuple(b.shape) != (L,):
        raise ValueError(
            f"bl must have one coefficient per degree: shape ({L},), got {tuple(b.shape)}")
    real_case = not f.is_complex() and not b.is_complex()
    return isht(a * b.to(a.dtype), real_output=real_case, grid=grid, config=config)


@functools.lru_cache(maxsize=8)
def _legendre_deriv_chunks(L: int, grid: str = "gauss"):
    """Triangular m-chunked d/dtheta tables from sin(theta)·dP̄_lm/dtheta =
    l·mu·P̄_lm − e_lm·P̄_{l-1,m}, e_lm = sqrt((l²−m²)(2l+1)/(2l−1))."""
    mu, _, theta = _grid_arrays(L, grid)
    s = np.sin(theta)
    lf = np.arange(L, dtype=np.float64)[:, None]
    mf = np.arange(L, dtype=np.float64)[None, :]
    with np.errstate(invalid="ignore"):
        e = np.sqrt((lf * lf - mf * mf) * (2.0 * lf + 1.0) / (2.0 * lf - 1.0))
    e = np.where((lf >= np.maximum(mf, 1.0)), e, 0.0)

    def planes():
        for l, p, p_prev in _legendre_l_iter(L, grid):
            yield l, (l * mu[None, :] * p - e[l][:, None] * p_prev) / s

    return _fill_chunks(L, planes(), len(mu))


def _synthesize(kind: str, alm: Tensor, config=DEFAULT_CONFIG, hermitian: bool = False,
                grid: str = "gauss", band=None) -> Tensor:
    """Synthesis core: contract the triangular m-chunked tables against
    (…, 2L-1, L) coefficients, place the m bins, inverse-FFT longitude.
    ``hermitian=True``: only the m >= 0 bins, longitude by irfft (real
    grid).  ``kind``, ``grid`` and ``band`` name the tables as in
    :func:`_analyze`."""
    alm = alm.to(_CDTYPE)
    L = alm.shape[-1]
    lead = alm.shape[:-2]
    apos = alm[..., :L, :]
    if hermitian:
        srcs = [apos]
    else:
        half = torch.flip(alm[..., L:, :], (-2,))
        z = alm.new_zeros(lead + (1, L))
        sign = host_table("sht_neg_signs", _neg_signs, L, like=alm)
        srcs = [apos, torch.cat([z, half], dim=-2) * sign[:, None]]
    parts = [[] for _ in srcs]
    for m0 in _chunk_starts(L):
        Pj = _chunk_on(kind, L, grid, m0, alm, band)
        t, _, nlat = Pj.shape
        PT = Pj.transpose(1, 2)                                    # (t, i, l)
        for src, out in zip(srcs, parts):
            X = src[..., m0: m0 + t, m0:].reshape(-1, t, L - m0).permute(1, 2, 0)
            y = _bmm_planes(PT, X, config.op_precision)                                 # (t, i, B)
            out.append(y.permute(2, 1, 0).reshape(lead + (nlat, t)))
    gpos = torch.cat(parts[0], dim=-1)  # (…, i, L)
    nlon = 2 * L
    zeros = gpos.new_zeros(gpos.shape[:-1] + (1,))  # Nyquist bin
    if hermitian:
        return irfft(torch.cat([gpos, zeros], dim=-1), n=nlon, config=config) * nlon
    gneg = torch.cat(parts[1], dim=-1)
    bins = torch.cat([gpos, zeros, torch.flip(gneg[..., 1:], (-1,))], dim=-1)
    return ifft(bins, config=config) * nlon


def _msigned(L: int, sign: float) -> np.ndarray:
    return sign * np.concatenate([np.arange(L), -np.arange(L - 1, 0, -1)]).astype(np.float64)


def _im_factor(sign: float, L: int, like: Tensor) -> Tensor:
    """i·sign·m over the packed m axis as a complex64 column kept on
    ``like``'s device."""
    im = host_table("sht_im", _msigned, L, sign, like=like)
    return torch.complex(torch.zeros_like(im), im)[:, None]


def sphere_grad(f, *, grid: str = "gauss", config: SpectralConfig = DEFAULT_CONFIG):
    """Surface gradient on the unit sphere: (u_theta, u_phi) =
    (∂f/∂theta, (1/sin theta)·∂f/∂phi), grids of ``f``'s shape: the theta
    part synthesizes against d/dtheta Legendre tables, the phi part
    multiplies a_lm by i·m and divides by sin(theta)."""
    f = as_tensor(f)
    a = sht(f, grid=grid, config=config)
    u_theta, u_phi = _grad_synth(a, a.shape[-1], config, grid)
    if not f.is_complex():
        u_theta, u_phi = u_theta.real, u_phi.real
    return u_theta, u_phi


def _check_tangent_shape(u_theta, u_phi, grid: str):
    ok = (
        u_theta.shape == u_phi.shape and u_theta.ndim >= 2
        and (
            u_theta.shape[-2] == u_theta.shape[-1] >= 2 and u_theta.shape[-1] % 2 == 0
            if grid == "equiangular"
            else u_theta.shape[-1] == 2 * u_theta.shape[-2]
        )
    )
    if not ok:
        want = "(…, 2L, 2L)" if grid == "equiangular" else "(…, L, 2L)"
        raise ValueError(f"u_theta and u_phi must share a {want} grid shape")


def _vector_analysis(u_theta: Tensor, u_phi: Tensor, config, grid: str = "gauss"):
    """Packed-m FFT pickup shared by the vector analysis ops."""
    L = u_theta.shape[-2] if grid == "gauss" else u_theta.shape[-1] // 2
    Ft = fft(u_theta, config=config)
    Fp = fft(u_phi, config=config)
    return L, _select_packed_m(Ft, L), _select_packed_m(Fp, L)


def _is_real(*xs) -> bool:
    return not any(x.is_complex() for x in xs)


def sphere_div(u_theta, u_phi, *, grid: str = "gauss",
               config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Surface divergence of a tangent field, grid in / grid out, computed
    weakly as the negative adjoint of :func:`sphere_grad`."""
    u_theta, u_phi = as_tensors(u_theta, u_phi)
    _check_tangent_shape(u_theta, u_phi, grid)
    d = _div_coef(u_theta, u_phi, config, grid)
    return isht(d, real_output=_is_real(u_theta, u_phi), grid=grid, config=config)


def _div_coef(u_theta: Tensor, u_phi: Tensor, config=DEFAULT_CONFIG,
              grid: str = "gauss") -> Tensor:
    """Divergence in coefficient space (the weak-form adjoint quadrature)."""
    L, Ut, Up = _vector_analysis(u_theta, u_phi, config, grid)
    t1 = _analyze("sht_dlegendre", Ut, _grid_on("sht_weights", L, grid, Ut), L, config,
                  grid=grid)
    t2 = _analyze("sht_legendre", Up, _grid_on("sht_weights_sin", L, grid, Up), L, config,
                  grid=grid)
    t2 = t2 * _im_factor(-1.0, L, t2)
    return -(t1 + t2)


def sphere_vort(u_theta, u_phi, *, grid: str = "gauss",
                config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Radial vorticity of a tangent field: the divergence of the
    quarter-turned field (u_phi, -u_theta)."""
    u_theta, u_phi = as_tensors(u_theta, u_phi)
    return sphere_div(u_phi, -u_theta, grid=grid, config=config)


def sphere_helmholtz(u_theta, u_phi, *, grid: str = "gauss",
                     config: SpectralConfig = DEFAULT_CONFIG):
    """Helmholtz decomposition u = grad(phi) + k x grad(psi): velocity
    potential phi = Δ⁻¹ div u and streamfunction psi = Δ⁻¹ vort u (zero-mean
    grids), in coefficient space throughout."""
    u_theta, u_phi = as_tensors(u_theta, u_phi)
    real_in = _is_real(u_theta, u_phi)
    d = _div_coef(u_theta, u_phi, config, grid)
    z = _div_coef(u_phi, -u_theta, config, grid)
    inv = _degree_scale(_inv_laplacian, d.shape[-1], d)
    phi = isht(d * inv, real_output=real_in, grid=grid, config=config)
    psi = isht(z * inv, real_output=real_in, grid=grid, config=config)
    return phi, psi


def _grad_synth(alm: Tensor, L: int, config=DEFAULT_CONFIG, grid: str = "gauss"):
    """Grid components of Σ_lm alm·∇Y_lm: (∂θ part, (1/sinθ)∂φ part);
    real coefficients are promoted to complex first."""
    alm = alm.to(_CDTYPE)
    g_theta = _synthesize("sht_dlegendre", alm, config, grid=grid)
    g_phi = _synthesize("sht_legendre", alm * _im_factor(1.0, L, alm), config,
                        grid=grid)
    g_phi = g_phi / _grid_on("sht_sin", L, grid, alm)[:, None]
    return g_theta, g_phi


def _inv_sqrt_degree(L: int, sign: float) -> np.ndarray:
    l = np.arange(L, dtype=np.float64)
    inv = np.zeros(L)
    inv[1:] = sign / np.sqrt(l[1:] * (l[1:] + 1.0))
    return inv


def vsht(u_theta, u_phi, *, grid: str = "gauss", config: SpectralConfig = DEFAULT_CONFIG):
    """Vector spherical harmonic analysis: tangent field pair ->
    (spheroidal, toroidal) packed coefficients, S_lm = -div_lm/λ,
    T_lm = -vort_lm/λ, λ = sqrt(l(l+1)) (the l = 0 row is zero)."""
    u_theta, u_phi = as_tensors(u_theta, u_phi)
    _check_tangent_shape(u_theta, u_phi, grid)
    d = _div_coef(u_theta, u_phi, config, grid)
    z = _div_coef(u_phi, -u_theta, config, grid)
    inv = _degree_scale(_inv_sqrt_degree, d.shape[-1], d, -1.0)
    return d * inv, z * inv


def ivsht(s_lm, t_lm, *, grid: str = "gauss", config: SpectralConfig = DEFAULT_CONFIG):
    """Vector spherical harmonic synthesis (inverse of :func:`vsht`):
    (…, 2L-1, L) spheroidal/toroidal coefficients -> (u_theta, u_phi),
    complex."""
    s_lm, t_lm = as_tensors(s_lm, t_lm)
    if s_lm.shape != t_lm.shape or s_lm.ndim < 2 or s_lm.shape[-2] != 2 * s_lm.shape[-1] - 1:
        raise ValueError("coefficients must share a (…, 2L-1, L) packed shape")
    L = s_lm.shape[-1]
    inv = _degree_scale(_inv_sqrt_degree, L, s_lm, 1.0)
    gt_s, gp_s = _grad_synth(s_lm * inv, L, config, grid)
    gt_t, gp_t = _grad_synth(t_lm * inv, L, config, grid)
    # r̂×∇Y = (-(1/sin)∂φY, ∂θY) in (θ, φ) components
    return gt_s - gp_t, gp_s + gt_t


# ---------------------------------------------------------------------------
# Legendre recurrence path: O(L²) memory instead of the ~L³/2 chunked
# tables.  A loop over degree l carries the (m, i) Legendre plane; values
# are rescaled by exact powers of two because the sectoral seeds
# P̄_mm ~ sin(theta)^m underflow fp32 long before the recurrence grows them
# back to O(1).
# ---------------------------------------------------------------------------

_RESCALE = 2.0 ** 60  # exact power-of-two renormalization step


@functools.lru_cache(maxsize=4)
def _sectoral_seeds(L: int):
    """Rescaled sectoral seeds P̄_mm = scaled·2^(-60·k) as fp64 (scaled, k)
    arrays of shape (m, i), computed in log space so no seed underflows."""
    _, _, theta = _gauss_grid(L)
    st = np.sin(theta)
    j = np.arange(1, L, dtype=np.float64)
    csum = np.concatenate([[0.0], np.cumsum(0.5 * np.log2((2.0 * j + 1.0) / (2.0 * j)))])
    log2_pmm = (
        -0.5 * np.log2(4.0 * np.pi)
        + csum[:, None]
        + np.arange(L, dtype=np.float64)[:, None] * np.log2(np.maximum(st, 1e-300))[None, :]
    )  # (m, i)
    k = np.maximum(0, np.ceil(-log2_pmm / 60.0)).astype(np.int32)
    # restore the Condon-Shortley sign (-1)^m lost in log space
    scaled = np.exp2(log2_pmm + 60.0 * k) * ((-1.0) ** np.arange(L))[:, None]
    return scaled, k


@functools.lru_cache(maxsize=4)
def _recurrence_coeffs(L: int):
    """Host O(L²) constants of the recurrence: A[l, m], B[l, m] and the
    sectoral seeds as exact (mantissa, k) pairs, P̄_mm = mant·2^(-60·k)."""
    mu, _, _ = _gauss_grid(L)
    A, B, _, _ = _host_recurrence_tables(L)
    scaled, k = _sectoral_seeds(L)
    return (A.astype(np.float32), B.astype(np.float32), scaled.astype(np.float32), k,
            mu.astype(np.float32))


@functools.lru_cache(maxsize=4)
def _recurrence_coeffs_dw(L: int):
    """fp32 low words of the recurrence constants (value64 - hi32), so the
    compensated path sees the fp64 coefficients to ~2^-48:
    (A_lo, B_lo, mant_lo, mu_lo)."""
    A, B, _, _ = _host_recurrence_tables(L)
    Ah, Bh, mant, _, mu = _recurrence_coeffs(L)
    mu64, _, _ = _gauss_grid(L)
    scaled, _ = _sectoral_seeds(L)
    return (
        (A - Ah.astype(np.float64)).astype(np.float32),
        (B - Bh.astype(np.float64)).astype(np.float32),
        (scaled - mant.astype(np.float64)).astype(np.float32),
        (mu64 - mu.astype(np.float64)).astype(np.float32),
    )


def _dw_step_chain(a: Tensor, a_lo: Tensor, mu: Tensor, mu_lo: Tensor, p1: Tensor,
                   p1_lo: Tensor, b: Tensor, b_lo: Tensor, p2: Tensor, p2_lo: Tensor):
    """One degree step of the compensated recurrence, op by op:
    (A·mu)·p1 − B·p2 with every operand and result a double-word (hi, lo)
    fp32 pair, as the JAX module's ``_dw_mul``/``_dw_add`` chain."""
    ch, cl = _dw_mul(a, a_lo, mu, mu_lo)
    t1h, t1l = _dw_mul(ch, cl, p1, p1_lo)
    t2h, t2l = _dw_mul(b, b_lo, p2, p2_lo)
    return _dw_add(t1h, t1l, -t2h, -t2l)


# The compensated degree step is one operator (``torch.library``, as the
# NUFFT's phase reduction is): a graph that dynamo or ``torch.export``
# captures holds it as one opaque node, whose CPU and CUDA implementations
# run the error-free chain op by op, so no compiler contracts a product and
# a sum of it into a fused multiply-add, and a compiled recurrence is
# bit-equal to eager.  Its operands are the kept coefficient tables and the
# carried planes, none of which takes a gradient.
_LIB = torch.library.Library("mixed_radix_sht", "DEF")
_LIB.define("dw_step(Tensor a, Tensor a_lo, Tensor mu, Tensor mu_lo, Tensor p1, Tensor p1_lo, "
            "Tensor b, Tensor b_lo, Tensor p2, Tensor p2_lo) -> (Tensor, Tensor)")
_LIB.impl("dw_step", _dw_step_chain, "CPU")
_LIB.impl("dw_step", _dw_step_chain, "CUDA")


def _dw_step_fake(*planes: Tensor):
    shape = torch.broadcast_shapes(*(t.shape for t in planes))
    return planes[4].new_empty(shape), planes[4].new_empty(shape)


torch.library.register_fake("mixed_radix_sht::dw_step", _dw_step_fake, lib=_LIB)


def _recurrence_table(L: int, name: str) -> np.ndarray:
    """One host table of the recurrence at band limit ``L`` by its name: the
    arrays of :func:`_recurrence_coeffs` ("A", "B", "mant", "k0", "mu"),
    their low words (:func:`_recurrence_coeffs_dw`: "A_lo", "B_lo",
    "mant_lo", "mu_lo") and the (L, L) identity ("eye") that marks the
    sectoral seeds."""
    if name == "eye":
        return np.eye(L, dtype=bool)
    if name.endswith("_lo"):
        return dict(zip(("A_lo", "B_lo", "mant_lo", "mu_lo"), _recurrence_coeffs_dw(L)))[name]
    return dict(zip(("A", "B", "mant", "k0", "mu"), _recurrence_coeffs(L)))[name]


def _recurrence_band(L: int, name: str, start: int, stop: int) -> np.ndarray:
    """:func:`_recurrence_table` with its latitude axis cut to the band
    ``start:stop`` (the tables without one whole)."""
    t = _recurrence_table(L, name)
    if name in ("mu", "mu_lo"):
        return t[start:stop]
    if name in ("mant", "k0", "mant_lo"):
        return t[:, start:stop]
    return t


def _legendre_scan(L: int, accumulate, acc0, xs_extra, lat=None, compensated=False,
                   like: Tensor = None):
    """Loop l = 0..L-1 carrying the rescaled (m, i) Legendre plane; at each
    step ``acc = accumulate(xs_extra[l], p0, acc)`` with p0 the true-scale
    plane (entries whose exponent offset k > 0 are < 2^-60 and passed as 0).
    ``lat`` optionally cuts the latitude arrays (mu, seed mantissa, seed
    exponent, mu_lo, mant_lo) to the band of latitudes ``(start, stop)``.
    ``compensated`` carries the plane as a double-word (hi, lo) fp32 pair
    with double-word constants: fp32-exact at any L for ~5x the work.
    The tables go to the device of ``like``."""
    # kept tables, built on the host also while dynamo traces
    def dev(name, dtype=DTYPE):
        if lat is None:
            return host_table("sht_recurrence", _recurrence_table, L, name, like=like,
                              dtype=dtype)
        return host_table("sht_recurrence_band", _recurrence_band, L, name, *lat, like=like,
                          dtype=dtype)

    Aj, Bj, mantj, muj = dev("A"), dev("B"), dev("mant"), dev("mu")[None, :]
    k0j = dev("k0", torch.int32)
    eye = dev("eye", torch.bool)
    if compensated:
        Alj, Blj = dev("A_lo"), dev("B_lo")
        mantlj, mujl = dev("mant_lo"), dev("mu_lo")[None, :]

    def renorm(k, planes):
        # exact power-of-two renorms: up for headroom while tiny, down as the
        # true value re-enters range (the hi word governs; scaling every word
        # of a double-word pair is exact)
        p, p1 = planes[0], planes[len(planes) // 2]
        mag = torch.maximum(torch.abs(p), torch.abs(p1))
        up = (mag > 0.0) & (mag < 1.0 / _RESCALE)
        planes = tuple(torch.where(up, q * _RESCALE, q) for q in planes)
        k = torch.where(up, k + 1, k)
        down = (torch.abs(planes[0]) > 1.0) & (k > 0)
        planes = tuple(torch.where(down, q / _RESCALE, q) for q in planes)
        return torch.where(down, k - 1, k), planes

    ni = muj.shape[-1]
    z = torch.zeros((L, ni), dtype=DTYPE, device=like.device)
    p1, p2, k = z, z, z.to(torch.int32)
    p1l = p2l = z
    acc = acc0
    for l in range(L):
        sm = eye[l][:, None]
        if compensated:
            p, plo = torch.ops.mixed_radix_sht.dw_step(
                Aj[l][:, None], Alj[l][:, None], muj, mujl, p1, p1l,
                Bj[l][:, None], Blj[l][:, None], p2, p2l)
            p = torch.where(sm, mantj[l][None, :], p)
            plo = torch.where(sm, mantlj[l][None, :], plo)
            k = torch.where(sm, k0j[l][None, :], k)
            k, (p, plo, p1, p1l) = renorm(k, (p, plo, p1, p1l))
            p2, p2l, p1, p1l = p1, p1l, p, plo
        else:
            p = Aj[l][:, None] * muj * p1 - Bj[l][:, None] * p2
            p = torch.where(sm, mantj[l][None, :], p)
            k = torch.where(sm, k0j[l][None, :], k)
            k, (p, p1) = renorm(k, (p, p1))
            p2, p1 = p1, p
        p0 = torch.where(k == 0, p, torch.zeros_like(p))
        acc = accumulate(xs_extra[l], p0, acc)
    return acc


def _as_planes_last(srcs: Tensor) -> Tensor:
    """(…, n) complex as (…, 2n) real: the re plane, then the im plane."""
    return torch.cat([srcs.real, srcs.imag], dim=-1)


def _from_planes_last(y: Tensor) -> Tensor:
    n = y.shape[-1] // 2
    return torch.complex(y[..., :n], y[..., n:])


def _rec_weights(L: int) -> np.ndarray:
    """The Gauss weights times the longitude step, fp32: the analysis
    quadrature of the recurrence."""
    _, w, _ = _gauss_grid(L)
    return (w * (2.0 * math.pi / (2 * L))).astype(np.float32)


def sht_recurrence(f, *, compensated: bool = False,
                   config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Spherical harmonic analysis through the Legendre recurrence: O(L²)
    memory, any band limit, the convention and output of :func:`sht`
    (Gauss grid).  ``compensated=True`` carries the recurrence as a
    double-word pair: fp32-exact coefficients at any L, where the plain
    fp32 loop drifts by ~L·eps."""
    f = as_tensor(f)
    if f.ndim < 2 or f.shape[-2] < 1 or f.shape[-1] != 2 * f.shape[-2]:
        raise ValueError("f must be (…, L, 2L) on the sht_grid")
    L = f.shape[-2]
    wj = host_table("sht_rec_weights", _rec_weights, L, like=f)
    hermitian = not f.is_complex()
    if hermitian:
        Fw = rfft(f.to(DTYPE), config=config)[..., :L] * wj[:, None]  # (…, i, m)
        srcs = Fw[None]
    else:
        Fw = _select_packed_m(fft(f, config=config), L) * wj[:, None]
        srcs = torch.stack([Fw[..., :L], _fold_neg_last(Fw, L)])  # (2, …, i, m)
    acc = _rec_analyze_core(srcs, L, config, compensated=compensated)
    return _rec_pack(acc, L, hermitian)


def _rec_analyze_core(srcs: Tensor, L: int, config=DEFAULT_CONFIG, lat=None,
                      compensated=False) -> Tensor:
    """Recurrence analysis core: weighted spectra srcs (s, …, i, m) ->
    (s, …, l, m) coefficient planes.  Each step is one batched product over
    m: y[m, ·] = p0[m, :] @ srcs[·, :, m]."""
    lead = srcs.shape[:-2]
    ni = srcs.shape[-2]
    X = _as_planes_last(srcs.reshape(-1, ni, L).permute(2, 1, 0))  # (m, i, 2B)

    def accumulate(_, p0, rows):
        with matmul_precision(config.op_precision):
            rows.append(torch.bmm(p0[:, None, :], X)[:, 0])       # (m, 2B)
        return rows

    rows = _legendre_scan(L, accumulate, [], range(L), lat=lat, compensated=compensated,
                          like=srcs)
    y = _from_planes_last(torch.stack(rows))                       # (l, m, B)
    return y.permute(2, 0, 1).reshape(lead + (L, L))


def _rec_pack(acc: Tensor, L: int, hermitian: bool) -> Tensor:
    """(s, …, l, m) recurrence accumulator -> packed (…, 2L-1, L)."""
    a = acc.transpose(-1, -2)  # (s, …, m, l)
    apos = a[0]
    if hermitian:
        sign = host_table("sht_neg_signs", _neg_signs, L, like=apos)
        aneg = torch.conj(apos) * sign[:, None]
    else:
        aneg = a[1]
    return torch.cat([apos, torch.flip(aneg[..., 1:, :], (-2,))], dim=-2)


def _rec_synth_core(srcs: Tensor, L: int, config=DEFAULT_CONFIG, lat=None,
                    compensated=False) -> Tensor:
    """Recurrence synthesis core: (s, …, m, l) coefficient sources ->
    (s, …, i, m) longitude-bin planes; each step adds one batched product
    over m: g[m] += p0[m, :, None] @ a_l[m, None, ·]."""
    lead = srcs.shape[:-2]
    X = _as_planes_last(srcs.reshape(-1, L, L).permute(2, 1, 0))   # (l, m, 2B)
    ni = L if lat is None else lat[1] - lat[0]
    acc0 = torch.zeros((L, ni, X.shape[-1]), dtype=DTYPE, device=srcs.device)

    def accumulate(a_l, p0, acc):
        with matmul_precision(config.op_precision):
            return torch.baddbmm(acc, p0[:, :, None], a_l[:, None, :])

    g = _legendre_scan(L, accumulate, acc0, X, lat=lat, compensated=compensated, like=srcs)
    g = _from_planes_last(g)                                       # (m, i, B)
    return g.permute(2, 1, 0).reshape(lead + (ni, L))


def isht_recurrence(alm, *, real_output: bool = False, compensated: bool = False,
                    config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Spherical harmonic synthesis through the Legendre recurrence: O(L²)
    memory, the convention of :func:`isht` (see :func:`sht_recurrence` for
    ``compensated``)."""
    alm = as_tensor(alm)
    if alm.ndim < 2 or alm.shape[-1] < 1 or alm.shape[-2] != 2 * alm.shape[-1] - 1:
        raise ValueError("alm must be (…, 2L-1, L) packed coefficients")
    alm = alm.to(_CDTYPE)
    L = alm.shape[-1]
    apos = alm[..., :L, :]
    if real_output:
        srcs = apos[None]
    else:
        half = torch.flip(alm[..., L:, :], (-2,))
        z = alm.new_zeros(alm.shape[:-2] + (1, L))
        sign = host_table("sht_neg_signs", _neg_signs, L, like=alm)
        srcs = torch.stack([apos, torch.cat([z, half], dim=-2) * sign[:, None]])
    g = _rec_synth_core(srcs, L, config, compensated=compensated)
    gpos = g[0]
    nlon = 2 * L
    zeros = gpos.new_zeros(gpos.shape[:-1] + (1,))
    if real_output:
        return irfft(torch.cat([gpos, zeros], dim=-1), n=nlon, config=config) * nlon
    bins = torch.cat([gpos, zeros, torch.flip(g[1][..., 1:], (-1,))], dim=-1)
    return ifft(bins, config=config) * nlon


# ---------------------------------------------------------------------------
# Rotation of spherical-harmonic coefficients: Wigner-D block-diagonal per
# degree.  The host builds the real Wigner-d(beta) stack; the alpha/gamma
# phases are e^{-i m phi} diagonals on the device; the degree blocks are
# one batched product over l.
# ---------------------------------------------------------------------------


def _packed_m_values(L: int) -> np.ndarray:
    """m per packed row: [0..L-1, -(L-1)..-1] (fft bin order)."""
    return np.concatenate([np.arange(L), np.arange(-(L - 1), 0)])


@functools.lru_cache(maxsize=8)
def _wigner_d_stack(L: int, beta: float) -> np.ndarray:
    """(L, 2L-1, 2L-1) real Wigner-d matrices in packed m order,
    D[l, n_idx, m_idx] = d^l_{m(n_idx), m(m_idx)}(beta), zero outside
    |m|, |m'| <= l: d^l(beta) = exp(-i·beta·J_y) through a host fp64
    eigendecomposition of the Hermitian tridiagonal J_y."""
    mv = _packed_m_values(L)
    out = np.zeros((L, 2 * L - 1, 2 * L - 1))
    for l in range(L):
        m = np.arange(-l, l + 1, dtype=np.float64)
        cp = np.sqrt(l * (l + 1.0) - m[:-1] * (m[:-1] + 1.0))  # m -> m+1
        Jy = np.zeros((2 * l + 1, 2 * l + 1), np.complex128)
        idx = np.arange(2 * l)
        Jy[idx + 1, idx] = cp / 2j
        Jy[idx, idx + 1] = -cp / 2j
        w, U = np.linalg.eigh(Jy)
        d = (U * np.exp(-1j * beta * w)) @ U.conj().T
        rows = np.where(np.abs(mv) <= l)[0]
        ms = mv[rows] + l
        out[l][np.ix_(rows, rows)] = np.real(d)[np.ix_(ms, ms)]
    return out


def rotate_sht(alm, alpha: float = 0.0, beta: float = 0.0, gamma: float = 0.0, *,
               config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Rotate packed (…, 2L-1, L) coefficients by ZYZ Euler angles:
    a'_{lm} = e^{-i·m·alpha} Σ_{m'} d^l_{m m'}(beta) e^{-i·m'·gamma} a_{lm'}.
    The inverse rotation is (-gamma, -beta, -alpha); per-degree power is
    preserved to fp32."""
    alm = as_tensor(alm)
    L = _check_alm(alm)
    alm = alm.to(_CDTYPE)
    mv = _packed_m_values(L).astype(np.float64)

    def mphase(a, ang: float):
        if ang == 0.0:
            return a
        ph = (-(mv * ang)) % (2.0 * np.pi)  # exact host reduction
        key = ("sht_mphase", L, ang)
        pr = constant(np.cos(ph), a, key=key + ("cos",))[:, None]
        pi = constant(np.sin(ph), a, key=key + ("sin",))[:, None]
        ar, ai = a.real, a.imag
        return torch.complex(ar * pr - ai * pi, ar * pi + ai * pr)

    a = mphase(alm, float(gamma))
    d = constant(lambda: _wigner_d_stack(L, float(beta)), a, key=("sht_wigner", L, float(beta)))
    lead = a.shape[:-2]
    X = a.reshape(-1, 2 * L - 1, L).permute(2, 1, 0)     # (l, m, B)
    b = _bmm_planes(d, X, config.op_precision)                                 # (l, n, B)
    b = b.permute(2, 1, 0).reshape(lead + (2 * L - 1, L))
    return mphase(b, float(alpha))
