"""PyTorch port: the ops that read ``config.dtype`` in the JAX package, in
float64.

Each case runs one op of the port with ``SpectralConfig(dtype=
torch.float64)`` on float64 data and holds it to a float64 oracle: scipy's
function where scipy has one, else the definition written out in numpy.
Errors are relative to the oracle's largest value, and each case states its
own tolerance: 1e-12 where the op is transforms, products and sums; 1e-10
for the recurrences (IIR filters, state-space simulation), the
homomorphic minimum phase (a log and an exp of the spectrum) and the
least-squares phase unwrapping; 1e-6 where the op stops a boundary sum at
a precision of 1e-6 (the spline prefilters, the JAX module's default) or
where the JAX module keeps a table in fp32 (``vmd``'s frequency grid).
Every output is float64 or complex128.  Data come from a generator made
per case from its id.
"""

import numpy as np
import pytest
import scipy.fft as sfft
import scipy.signal as ss
import torch

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch.ops import cqt as tcqt
from mixed_radix_fast_fourier_transform_tpu_torch.ops import mel as tmel

F64 = tp.SpectralConfig(dtype=torch.float64)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


# ---------------------------------------------------------------------------
# Cases: each returns a list of (port result, float64 oracle) pairs.


def _dct(r):
    x = r.standard_normal((3, 64))
    out = []
    for kind in (1, 2, 3, 4):
        for norm in (None, "ortho"):
            out.append((tp.dct(_t(x), type=kind, norm=norm, config=F64),
                        sfft.dct(x, type=kind, norm=norm)))
            out.append((tp.dst(_t(x), type=kind, norm=norm, config=F64),
                        sfft.dst(x, type=kind, norm=norm)))
    return out


def _czt(r):
    """A spiral against the direct sum Σ x[n]·a^−n·w^nk, and a zoom."""
    x = r.standard_normal((2, 100)) + 1j * r.standard_normal((2, 100))
    w, a = 0.9995 * np.exp(-2j * np.pi * 0.013), 0.9 * np.exp(0.3j)
    n, k = np.arange(100)[:, None], np.arange(77)[None, :]
    return [(tp.czt(_t(x), m=77, w=w, a=a, config=F64), x @ (a ** -n * w ** (n * k))),
            (tp.zoom_fft(_t(x), [0.1, 0.6], 64, config=F64), ss.zoom_fft(x, [0.1, 0.6], 64))]


def _fht(r):
    n, dln, mu, bias = 128, 0.05, 0.5, 0.3
    a = r.standard_normal((2, n))
    off = sfft.fhtoffset(dln, mu, bias=bias)
    return [(tp.fht(_t(a), dln, mu, offset=off, bias=bias, config=F64),
             sfft.fht(a, dln, mu, offset=off, bias=bias)),
            (tp.ifht(_t(a), dln, mu, offset=off, bias=bias, config=F64),
             sfft.ifht(a, dln, mu, offset=off, bias=bias))]


def _stft(r):
    nperseg, hop, t = 64, 16, 500
    x = r.standard_normal((2, t))
    xp = np.pad(x, [(0, 0), (nperseg // 2, nperseg // 2)], mode="reflect")
    n_frames = 1 + -(-(xp.shape[-1] - nperseg) // hop)
    xp = np.pad(xp, [(0, 0), (0, nperseg + (n_frames - 1) * hop - xp.shape[-1])])
    idx = np.arange(n_frames)[:, None] * hop + np.arange(nperseg)
    want = np.fft.rfft(xp[:, idx] * ss.get_window("hann", nperseg), axis=-1)
    S = tp.stft(_t(x), nperseg, nperseg - hop, config=F64)
    back = tp.istft(S, nperseg, nperseg - hop, length=t, config=F64)
    return [(S, want), (back, x)]


def _mel_yin(r):
    """yin's cumulative-mean-normalized difference against its definition,
    d(τ) = Σ_{j<W} (x[j] − x[j+τ])² per frame, cmnd(τ) = τ·d(τ)/Σ_{k≤τ} d(k)."""
    sr, fl, wl, hop, fmin, fmax = 8000.0, 256, 128, 64, 60.0, 500.0
    x = np.sin(2 * np.pi * 155.0 * np.arange(2048) / sr) + 0.1 * r.standard_normal(2048)
    cmnd, _, tau_max, _ = tmel._yin_cmnd(_t(x), fmin, fmax, sr, fl, wl, hop, True, F64)
    xp = np.pad(x, (fl // 2, fl // 2))
    frames = xp[np.arange(1 + (xp.size - fl) // hop)[:, None] * hop + np.arange(fl)]
    taus = np.arange(tau_max + 1)
    d = np.stack([np.sum((frames[:, :wl] - frames[:, tau: tau + wl]) ** 2, -1) for tau in taus],
                 -1)
    want = np.concatenate([np.ones_like(d[:, :1]),
                           d[:, 1:] * taus[1:] / np.cumsum(d[:, 1:], -1)], -1)
    return [(cmnd, want)]


def _cqt(r):
    fs, fmin, n_bins, bpo, hop = 8000.0, 110.0, 24, 12, 128
    x = r.standard_normal((2, 3000))
    K, nf = tcqt._cqt_spectral_kernel(fs, fmin, n_bins, bpo, "hann", 1.0, None)
    xp = np.pad(x, [(0, 0), (nf // 2, nf // 2)])
    n_frames = 1 + (xp.shape[-1] - nf) // hop
    frames = xp[:, np.arange(n_frames)[:, None] * hop + np.arange(nf)]
    want = np.fft.fft(frames, axis=-1) @ K.T
    got = tp.cqt(_t(x), fs=fs, fmin=fmin, n_bins=n_bins, bins_per_octave=bpo, hop=hop,
                 config=F64)
    return [(got, want)]


def _stockwell(r):
    T, gamma = 256, 1.0
    x = r.standard_normal((2, T))
    X = np.fft.fft(x)
    ks = np.arange(T // 2 + 1)
    j = np.where(np.arange(T) < (T + 1) // 2, np.arange(T), np.arange(T) - T)
    G = np.exp(-2.0 * (np.pi * gamma * j[None, :]) ** 2 / np.maximum(ks[:, None], 1) ** 2)
    want = np.fft.ifft(X[:, (j[None, :] + ks[:, None]) % T] * G, axis=-1)
    want[:, 0, :] = np.mean(x, -1, keepdims=True)
    S, _ = tp.stockwell(_t(x), gamma=gamma, config=F64)
    return [(S, want)]


def _feature(r):
    fl, hop = 256, 64
    x = r.standard_normal((2, 3000))
    xp = np.pad(x, [(0, 0), (fl // 2, fl // 2)])
    frames = xp[:, np.arange(1 + (xp.shape[-1] - fl) // hop)[:, None] * hop + np.arange(fl)]
    s = frames >= 0
    return [(tp.rms(_t(x), fl, hop, config=F64), np.sqrt(np.mean(frames ** 2, -1))),
            (tp.zero_crossing_rate(_t(x), fl, hop, config=F64),
             np.mean(s[..., 1:] != s[..., :-1], -1))]


def _signal_spectra(r):
    x, y = r.standard_normal((2, 2, 4096))
    out = []
    for detrend in ("constant", "linear"):
        f, p = tp.welch(_t(x), 100.0, nperseg=256, detrend=detrend, config=F64)
        out.append((p, ss.welch(x, 100.0, nperseg=256, detrend=detrend)[1]))
    out.append((tp.welch(_t(x), nperseg=256, average="median", config=F64)[1],
                ss.welch(x, nperseg=256, average="median")[1]))
    out.append((tp.csd(_t(x), _t(y), nperseg=256, config=F64)[1], ss.csd(x, y, nperseg=256)[1]))
    out.append((tp.periodogram(_t(x), window="hann", config=F64)[1],
                ss.periodogram(x, window="hann")[1]))
    return out


def _signal_transforms(r):
    x = r.standard_normal((2, 1000))
    h = ss.firwin(31, 0.3)
    t = np.linspace(0.0, 2 * np.pi, 128, endpoint=False)
    f = np.sin(3 * t) + 0.5 * np.cos(5 * t)
    g = np.sin(2 * t)[:, None] * np.cos(3 * t)[None, :]
    return [
        (tp.hilbert(_t(x), config=F64), ss.hilbert(x)),
        (tp.resample(_t(x), 777, config=F64), ss.resample(x, 777, axis=-1)),
        (tp.resample(_t(x), 1301, config=F64), ss.resample(x, 1301, axis=-1)),
        (tp.upfirdn(h, _t(x), 3, 2, config=F64), ss.upfirdn(h, x, 3, 2)),
        (tp.resample_poly(_t(x), 3, 2, config=F64), ss.resample_poly(x, 3, 2, axis=-1)),
        (tp.spectral_diff(_t(f), config=F64), 3 * np.cos(3 * t) - 2.5 * np.sin(5 * t)),
        (tp.poisson_solve(_t(g), config=F64), -g / 13.0),
        (tp.rceps(_t(x), config=F64),
         np.fft.ifft(np.log(np.abs(np.fft.fft(x)))).real),
    ]


def _signal_lombscargle(r):
    t = np.sort(r.uniform(0.0, 50.0, 300))
    y = np.sin(1.3 * t) + 0.3 * r.standard_normal(300)
    freqs = np.linspace(0.1, 3.0, 200)
    return [(tp.lombscargle(_t(t), _t(y), _t(freqs), config=F64),
             ss.lombscargle(t, y, freqs))]


def _signal_minimum_phase(r):
    h = ss.firwin(41, 0.25)
    return [(tp.minimum_phase(_t(h), 1024, config=F64),
             ss.minimum_phase(h, method="homomorphic", n_fft=1024))]


def _iir(r):
    x = r.standard_normal((2, 3000))
    b, a = ss.butter(4, 0.2)
    sos = ss.butter(6, [0.1, 0.3], btype="band", output="sos")
    return [(tp.lfilter(b, a, _t(x), config=F64), ss.lfilter(b, a, x)),
            (tp.sosfilt(sos, _t(x), config=F64), ss.sosfilt(sos, x)),
            (tp.filtfilt(b, a, _t(x), config=F64), ss.filtfilt(b, a, x)),
            (tp.sosfiltfilt(sos, _t(x), config=F64), ss.sosfiltfilt(sos, x))]


def _ltisys(r):
    A = np.array([[0.9, 0.2], [-0.2, 0.9]])
    B = np.array([[1.0], [0.5]])
    C = np.array([[1.0, -1.0]])
    D = np.array([[0.1]])
    u = r.standard_normal((400, 1))
    _, y, xs = tp.dlsim((A, B, C, D, 1.0), _t(u), x0=np.array([1.0, -0.5]), config=F64)
    _, yw, xw = ss.dlsim((A, B, C, D, 1.0), u, x0=np.array([1.0, -0.5]))
    Ac = np.array([[-0.5, 2.0], [-2.0, -0.5]])
    T = np.linspace(0.0, 10.0, 501)
    U = np.sin(T) + 0.2 * r.standard_normal(501)
    _, yl, _ = tp.lsim((Ac, B, C, D), _t(U), T, config=F64)
    _, ylw, _ = ss.lsim((Ac, B, C, D), U, T)
    return [(y, yw), (xs, xw), (yl, ylw[:, None] if np.ndim(ylw) == 1 else ylw)]


def _splines_symiir(r):
    """The mirror-symmetric smoothers with both boundary sums run until
    their terms fall below 1e-14 (precision 1e-28: scipy stops on the
    squared term)."""
    x = r.standard_normal(500)
    return [(tp.symiirorder1(_t(x), 0.5, 0.3, 1e-28, config=F64),
             ss.symiirorder1(x, 0.5, 0.3, 1e-28)),
            (tp.symiirorder2(_t(x), 0.5, 0.6, 1e-28, config=F64),
             ss.symiirorder2(x, 0.5, 0.6, 1e-28))]


def _splines_coefficients(r):
    """The spline prefilters at the float64 default precision, 1e-6 (the
    JAX module's rule): their boundary sums stop where the pole's power
    falls below it, while scipy's sum every sample."""
    x = r.standard_normal(500)
    img = r.standard_normal((40, 50))
    return [(tp.cspline1d(_t(x), config=F64), ss.cspline1d(x)),
            (tp.qspline1d(_t(x), config=F64), ss.qspline1d(x)),
            (tp.cspline2d(_t(img), config=F64), ss.cspline2d(img))]


def _register(r):
    """A smooth phase surface with steps below π wraps and unwraps exactly,
    up to one constant: the least-squares solution is the surface."""
    yy, xx = np.mgrid[0:48, 0:64] / 8.0
    phi = 3.0 * np.sin(xx) + 2.0 * np.cos(0.7 * yy) + 0.4 * xx * yy
    wrapped = np.angle(np.exp(1j * phi))
    got = _np(tp.unwrap_phase_2d(_t(wrapped), config=F64))
    return [(got - got.mean(), phi - phi.mean())]


def _vmd64(x, K, alpha, tau, n_iter, omega0):
    """The JAX module's VMD in float64 numpy (pinned initial frequencies)."""
    T0 = x.shape[-1]
    half = T0 // 2
    xm = np.concatenate([x[..., :half][..., ::-1], x, x[..., T0 - half:][..., ::-1]], -1)
    T = xm.shape[-1]
    pos = (np.arange(T) <= T // 2).astype(np.float64)
    w = np.abs(np.fft.fftfreq(T))
    f_pos = np.fft.fft(xm) * pos
    u = np.zeros(x.shape[:-1] + (K, T), complex)
    omega = np.broadcast_to(np.asarray(omega0, float), x.shape[:-1] + (K,)).copy()
    lam = np.zeros(x.shape[:-1] + (T,), complex)
    for _ in range(n_iter):
        sum_u = u.sum(-2)
        for k in range(K):
            sum_u = sum_u - u[..., k, :]
            u_k = (f_pos - sum_u + lam / 2) / (1 + 2 * alpha * (w - omega[..., k, None]) ** 2) * pos
            p = np.abs(u_k) ** 2
            omega[..., k] = (w * p).sum(-1) / (p.sum(-1) + 1e-30)
            u[..., k, :] = u_k
            sum_u = sum_u + u_k
        lam = lam + tau * (f_pos - sum_u)
    u_full = u + np.conj(np.flip(np.roll(u, -1, -1), -1))
    u_full[..., 0] = u[..., 0].real
    if T % 2 == 0:
        u_full[..., T // 2] = u[..., T // 2].real
    modes = np.fft.ifft(u_full).real[..., half: half + T0]
    order = np.argsort(omega, -1)
    return np.take_along_axis(modes, order[..., None], -2), np.take_along_axis(omega, order, -1)


def _vmd(r):
    n = np.arange(512)
    x = (np.cos(2 * np.pi * 0.03 * n) + 0.7 * np.cos(2 * np.pi * 0.12 * n)
         + 0.5 * np.cos(2 * np.pi * 0.31 * n) + 0.02 * r.standard_normal(512))
    omega0 = np.array([0.02, 0.15, 0.3])
    modes, omega = tp.vmd(_t(x), 3, 2000.0, 0.05, init_omega=omega0, n_iter=100, config=F64)
    m64, o64 = _vmd64(x, 3, 2000.0, 0.05, 100, omega0)
    return [(modes, m64), (omega, o64)]


# (case, tolerance relative to the oracle's largest value): see the
# module docstring for the looser ones.
CASES = {
    "dct": (_dct, 1e-12),
    "czt": (_czt, 1e-12),
    "fht": (_fht, 1e-12),
    "stft": (_stft, 1e-12),
    "mel.yin": (_mel_yin, 1e-12),
    "cqt": (_cqt, 1e-12),
    "tfr.stockwell": (_stockwell, 1e-12),
    "feature": (_feature, 1e-12),
    "signal.spectra": (_signal_spectra, 1e-12),
    "signal.transforms": (_signal_transforms, 1e-12),
    "signal.lombscargle": (_signal_lombscargle, 1e-12),
    "signal.minimum_phase": (_signal_minimum_phase, 1e-10),
    "iir": (_iir, 1e-10),
    "ltisys": (_ltisys, 1e-10),
    "splines.symiir": (_splines_symiir, 1e-12),
    "splines.coefficients": (_splines_coefficients, 1e-6),
    "register": (_register, 1e-10),
    "vmd": (_vmd, 1e-6),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_in_float64_against_its_float64_oracle(case):
    make, tol = CASES[case]
    r = np.random.default_rng([ord(ch) for ch in case])
    for i, (got, want) in enumerate(make(r)):
        if isinstance(got, torch.Tensor):
            assert got.dtype in (torch.float64, torch.complex128), (case, i, got.dtype)
        got, want = _np(got), np.asarray(want)
        assert got.shape == want.shape, (case, i, got.shape, want.shape)
        err = np.max(np.abs(got - want)) / np.max(np.abs(want))
        assert err <= tol, (case, i, err)
