"""PyTorch port: the time-frequency ops and the CQT that the JAX package's
tests run under ``jax.jit``, under ``torch.compile`` (the rest of the slice,
and the checks each op gets, are in ``test_torch_compile_ops.py``).

``wigner_ville``, ``ssq_cwt``, ``ssq_stft``, ``reassigned_spectrogram`` and
``stockwell`` at ``tests/test_tfr.py``'s calls and shapes, ``cqt`` on a
(2, 3, 1500) batch and ``icqt`` with five Landweber rounds at
``tests/test_cqt.py``'s: on both routes, compiled on the CPU with
``backend="aot_eager"``, ``fullgraph=True, dynamic=False``.  The squeezed
and reassigned planes are compared as ``tests/test_torch_tfr.py`` compares
them: a cell whose reassigned frequency sits on a bin edge flips bins
under fp-level differences (ROADMAP F2), so the bin sums (the marginal the
squeeze preserves) are held tightly, to the JAX function at 5e-4 and to
the eager port at 1e-6, and single cells loosely.  The signals are chirps
and tones with noise drawn per case, as there."""

import numpy as np
import pytest
import torch

import mixed_radix_fast_fourier_transform_tpu as jsp

import mixed_radix_fast_fourier_transform_tpu_torch as tp

from test_torch_compile_ops import (  # noqa: F401  (fixtures)
    EAGER_TOL, ROUTES, TOL, _np, _rel, case_rng, fresh_dynamo, hold, within,
)

torch.set_num_threads(1)

BIN_FLIP_TOL = 0.25
MARGINAL_TOL = 5e-4
GRID_TOL = 1e-7


def _signals(rng, rows, T):
    """A chirp, two tones and a tone pair (cycling), with a little noise."""
    t = np.arange(T)
    base = [np.cos(2 * np.pi * (0.03 * t + 0.5 * (0.2 / T) * t * t)),
            np.cos(2 * np.pi * 0.05 * t) + 0.7 * np.cos(2 * np.pi * 0.17 * t + 0.3),
            np.cos(2 * np.pi * 0.11 * t) + 0.5 * np.cos(2 * np.pi * 0.31 * t)]
    x = np.stack([base[i % 3] for i in range(rows)]) + 0.05 * rng.standard_normal((rows, T))
    return x.astype(np.float32)


def squeezed(axes):
    """(plane, freqs) pairs compared through the plane's bin sums over
    ``axes`` (tight) and cell by cell (loose), the grids exactly."""
    def check(tol):
        def compare(got, want):
            (S, f), (jS, jf) = got, want
            assert np.max(np.abs(_np(f) - np.asarray(jf))) / np.max(np.abs(_np(f))) <= GRID_TOL
            scale = max(1.0, float(np.max(np.abs(np.asarray(jS)))))
            assert _rel(_np(S).sum(axes), np.asarray(jS).sum(axes), scale) <= tol
            if tol == MARGINAL_TOL:
                assert _rel(S, jS, scale) <= BIN_FLIP_TOL
        return compare
    return check


CASES = {
    "wigner_ville": (dict(nperseg=33, hop=8), (2, 256), None),
    "ssq_cwt": (dict(n_scales=32, fmin=0.02, fmax=0.4), (2, 512), -2),
    "ssq_stft": (dict(nperseg=128), (2, 1024), -1),
    "reassigned_spectrogram": (dict(nperseg=128), (2, 1024), (-2, -1)),
    "stockwell": (dict(), (3, 128), None),
}


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name", CASES)
def test_time_frequency_ops_compile_whole(name, route, case_rng):
    """Their tables (lag indices, windows and their derivative and
    time-weighted forms, the Morlet bank, the voice windows, the frame
    phase) are host builds kept by key; ``dtype.to_real`` became
    ``utils.numerics.real_dtype``."""
    kw, shape, axes = CASES[name]
    config = ROUTES[route]
    port = lambda v: getattr(tp, name)(v, config=config, **kw)  # noqa: E731
    args, args2 = ([_signals(case_rng, *shape)] for _ in range(2))
    if axes is None:
        hold(port, lambda v: getattr(jsp, name)(v, **kw), args, args2, within(TOL),
             warm=route == "kernel")
        return
    check = squeezed(axes)
    hold(port, lambda v: getattr(jsp, name)(v, **kw), args, args2, check(MARGINAL_TOL),
         eager_check=check(EAGER_TOL), warm=route == "kernel")


@pytest.mark.parametrize("route", ROUTES)
def test_cqt_and_icqt_compile_whole(route, case_rng):
    """``cqt`` of a (2, 3, 1500) batch at 4 kHz, 24 bins from 60 Hz, hop
    200; ``icqt`` with five Landweber rounds (a cqt and a dual product each)
    of a two-tone signal of 16,384 samples at 8 kHz: the spectral and dual
    kernels and the overlap-add tables are host builds keyed by the ladder."""
    config = ROUTES[route]
    kw = dict(fs=4000.0, fmin=60.0, n_bins=24, hop=200)
    args, args2 = ([case_rng.standard_normal((2, 3, 1500)).astype(np.float32)] for _ in range(2))
    hold(lambda v: tp.cqt(v, config=config, **kw), lambda v: jsp.cqt(v, **kw), args, args2,
         within(TOL), tables=("cqt.kernel",), warm=route == "kernel")
    fs, n = 8000.0, 16384
    freqs = tp.cqt_frequencies(48, 55.0, 12)
    t = np.arange(n) / fs
    kw = dict(fs=fs, fmin=55.0, hop=256)
    coeffs = []
    for f1 in (freqs[20], freqs[24]):
        sig = (np.cos(2 * np.pi * f1 * t) + 0.5 * np.cos(2 * np.pi * freqs[35] * t)).astype(np.float32)
        coeffs.append(tp.cqt(torch.from_numpy(sig), n_bins=48, **kw).numpy())
    hold(lambda c: tp.icqt(c, length=n, n_iter=5, config=config, **kw),
         lambda c: jsp.icqt(c, length=n, n_iter=5, **kw), coeffs[:1], coeffs[1:], within(TOL),
         tables=("icqt.dual", "icqt.ola", "cqt.kernel"), warm=False)
