"""ShortTimeFFT-class interface and STFT window/frame theory helpers.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/shorttime.py``:
the scipy.signal.ShortTimeFFT surface (scipy 1.17 semantics: centered
slices ``p·hop − m_num//2``, canonical dual-window inversion, border index
arithmetic).  Where scipy loops a Python generator over slices, this class
pads once, takes every frame as one strided view (``Tensor.unfold``) and
runs ONE batched engine transform (ops.fft/ops.rfft) over the frame axis.
Overlap-add inversion is one ``index_add`` with a host-computed index table
(on the card its atomic adds are not bit-reproducible, within rounding
though).

Window/dual-window math (`check_COLA`, `check_NOLA`,
`closest_STFT_dual_window`, the canonical dual) is host-side fp64 via a
residue-class fold: for hop H, every per-sample periodized sum
``Σ_m f[n+mH]`` equals the fold of ``f`` into its H residue classes: one
pad-reshape-sum instead of scipy's shifted-add loop.  The host part is the
JAX module's, line for line.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.config import DEFAULT_CONFIG, SpectralConfig
from ..utils.numerics import as_tensor, constant, content_key, pad_last
from .fft import fft, fftshift, ifft, ifftshift
from .rfft import irfft, rfft
from .stft import get_window

Tensor = torch.Tensor

__all__ = [
    "ShortTimeFFT", "check_COLA", "check_NOLA", "closest_STFT_dual_window",
]

_FFT_MODES = ("twosided", "centered", "onesided", "onesided2X")
_PAD_MODES = {"zeros": "constant", "edge": "edge", "even": "reflect", "odd": "odd"}


# ---------------------------------------------------------------- fold algebra

def _fold_residues(x: np.ndarray, hop: int) -> np.ndarray:
    """Sum ``x`` over each residue class mod ``hop`` (length-``hop`` vector).

    Equals the periodized sum ``Σ_m x[r + m·hop]`` for every sample of class
    ``r`` — the quantity every COLA/NOLA/dual-window condition is built from.
    """
    m = len(x)
    k = -(-m // hop)
    xp = np.zeros(k * hop, dtype=x.dtype)
    xp[:m] = x
    return xp.reshape(k, hop).sum(axis=0)


def _expand_residues(s: np.ndarray, m: int) -> np.ndarray:
    """Broadcast a per-residue vector back to per-sample length ``m``."""
    hop = len(s)
    return s[np.arange(m) % hop]


def _canonical_dual(win: np.ndarray, hop: int) -> np.ndarray:
    """Canonical dual window win/D, D the per-sample |win|² periodization.

    Raises ValueError when the frame operator is singular (STFT not
    invertible at this hop).
    """
    if hop > len(win):
        raise ValueError(f"hop={hop} exceeds window length {len(win)}: "
                         "STFT not invertible")
    if np.issubdtype(win.dtype, np.integer):
        raise ValueError("win cannot be integer-typed")
    w2 = win.real ** 2 + win.imag ** 2
    d = _expand_residues(_fold_residues(w2, hop), len(win))
    if not np.all(d >= np.finfo(win.dtype).resolution * d.max()):
        raise ValueError("short-time Fourier transform not invertible for "
                         f"this window at hop={hop}")
    return win / d


def _resolve_window(window, nperseg: int) -> np.ndarray:
    if isinstance(window, str) or isinstance(window, tuple):
        return get_window(window, int(nperseg), dtype=np.float64, sym=False)
    win = np.asarray(window)
    if win.ndim != 1:
        raise ValueError("window must be 1-D")
    if win.shape[0] != nperseg:
        raise ValueError("window must have length nperseg")
    return win


def check_COLA(window, nperseg: int, noverlap: int, tol: float = 1e-10) -> bool:
    """Constant-OverLap-Add check (scipy.signal.check_COLA): the fold of the
    window over hop = nperseg − noverlap deviates from constant by < tol."""
    nperseg = int(nperseg)
    if nperseg < 1:
        raise ValueError("nperseg must be a positive integer")
    if noverlap >= nperseg:
        raise ValueError("noverlap must be less than nperseg.")
    win = _resolve_window(window, nperseg)
    binsums = _fold_residues(win, nperseg - int(noverlap))
    return bool(np.max(np.abs(binsums - np.median(binsums))) < tol)


def check_NOLA(window, nperseg: int, noverlap: int, tol: float = 1e-10) -> bool:
    """NOnzero-OverLap-Add check (scipy.signal.check_NOLA): the fold of the
    squared window is everywhere > tol, i.e. istft's normalization exists."""
    nperseg = int(nperseg)
    if nperseg < 1:
        raise ValueError("nperseg must be a positive integer")
    if noverlap >= nperseg:
        raise ValueError("noverlap must be less than nperseg")
    if noverlap < 0:
        raise ValueError("noverlap must be a nonnegative integer")
    win = _resolve_window(window, nperseg)
    binsums = _fold_residues(win.real ** 2 + win.imag ** 2,
                             nperseg - int(noverlap))
    return bool(np.min(binsums) > tol)


def closest_STFT_dual_window(win, hop: int, desired_dual=None, *,
                             scaled: bool = True):
    """Dual window of ``alpha·win`` closest to ``desired_dual``
    (scipy.signal.closest_STFT_dual_window, scipy 1.15+).

    The set of valid duals is an affine subspace (one linear constraint per
    residue class mod hop); the minimizer is the orthogonal projection of the
    desired window onto it, expressed through the canonical dual and the
    residue fold of ``conj(win)·desired``.
    """
    win = np.asarray(win)
    desired = (np.ones_like(win) if desired_dual is None
               else np.asarray(desired_dual))
    if not (win.ndim == 1 and win.shape == desired.shape):
        raise ValueError("win and desired_dual must be 1-D of equal length")
    if not (np.all(np.isfinite(win)) and np.all(np.isfinite(desired))):
        raise ValueError("win and desired_dual must have finite entries")
    if not (isinstance(hop, (int, np.integer)) and 1 <= hop <= len(win)):
        raise ValueError(f"hop={hop} must be an integer in [1, len(win)]")

    w_d = _canonical_dual(win, hop)
    q_d = w_d * _expand_residues(
        _fold_residues(np.conj(win) * desired, hop), len(win))
    if not scaled:
        return w_d + desired - q_d, 1.0
    numerator = np.vdot(q_d, w_d)
    denominator = float(np.sum(q_d.real ** 2 + q_d.imag ** 2))
    if not (abs(numerator) > 0
            and denominator > np.finfo(w_d.dtype).resolution):
        raise ValueError("numerically unstable scale factor; "
                         "try scaled=False")
    alpha = numerator / denominator
    if not np.iscomplexobj(w_d) and not np.iscomplexobj(desired):
        alpha = alpha.real
    return w_d + alpha * (desired - q_d), alpha


# ------------------------------------------------------------------- the class

class ShortTimeFFT:
    """scipy.signal.ShortTimeFFT-compatible STFT/ISTFT operator.

    Slice ``p`` covers samples ``[p·hop − m_num//2, p·hop − m_num//2 + m_num)``
    (centered convention); inversion uses the canonical dual window.  All
    transforms run through the engine's batched fft/rfft — no per-slice
    loop on the host.
    """

    def __init__(self, win: np.ndarray, hop: int, fs: float, *,
                 fft_mode: str = "onesided", mfft: Optional[int] = None,
                 dual_win: Optional[np.ndarray] = None,
                 scale_to: Optional[str] = None,
                 phase_shift: Optional[int] = 0,
                 config: SpectralConfig = DEFAULT_CONFIG):
        win = np.asarray(win)
        if not (win.ndim == 1 and win.size > 0):
            raise ValueError(f"win is not 1-D, shape {win.shape}")
        if not np.all(np.isfinite(win)):
            raise ValueError("win must have finite entries")
        if not (isinstance(hop, (int, np.integer)) and hop >= 1):
            raise ValueError(f"hop={hop} must be an integer >= 1")
        if np.issubdtype(win.dtype, np.integer):
            win = win.astype(np.float64)
        self._win = win.copy()
        self._hop = int(hop)
        if not fs > 0:
            raise ValueError(f"fs={fs} must be positive")
        self._fs = float(fs)
        self._mfft = len(win) if mfft is None else int(mfft)
        if self._mfft < len(win):
            raise ValueError(f"mfft={self._mfft} must be >= len(win)={len(win)}")
        if dual_win is not None:
            dual_win = np.asarray(dual_win)
            if dual_win.shape != win.shape:
                raise ValueError("dual_win must have the same shape as win")
            if not np.all(np.isfinite(dual_win)):
                raise ValueError("dual_win must have finite entries")
        self._dual_win = None if dual_win is None else dual_win.copy()
        if phase_shift is not None:
            if not isinstance(phase_shift, (int, np.integer)):
                raise ValueError("phase_shift must be an int or None")
            if not (-self.mfft < phase_shift < self.mfft):
                raise ValueError(f"phase_shift={phase_shift} out of "
                                 f"(-mfft, mfft)")
        self._phase_shift = None if phase_shift is None else int(phase_shift)
        self._fft_mode = None
        self._scaling = None
        self._config = config
        if scale_to is not None:
            self.scale_to(scale_to)  # validates magnitude/psd
        self.fft_mode = fft_mode  # validated by the setter (incl. onesided2X)
        self._border_cache: dict = {}

    # ------------------------------------------------------------ constructors

    @classmethod
    def from_window(cls, win_param, fs: float, nperseg: int, noverlap: int, *,
                    symmetric_win: bool = False, fft_mode: str = "onesided",
                    mfft: Optional[int] = None,
                    scale_to: Optional[str] = None,
                    phase_shift: Optional[int] = 0,
                    config: SpectralConfig = DEFAULT_CONFIG):
        """Build from a scipy get_window spec plus nperseg/noverlap."""
        if not 0 <= noverlap < nperseg:
            raise ValueError("noverlap must be in [0, nperseg)")
        win = get_window(win_param, int(nperseg), dtype=np.float64,
                         sym=bool(symmetric_win))
        return cls(win, nperseg - int(noverlap), fs, fft_mode=fft_mode,
                   mfft=mfft, scale_to=scale_to, phase_shift=phase_shift,
                   config=config)

    @classmethod
    def from_dual(cls, dual_win: np.ndarray, hop: int, fs: float, *,
                  fft_mode: str = "onesided", mfft: Optional[int] = None,
                  scale_to: Optional[str] = None,
                  phase_shift: Optional[int] = 0,
                  config: SpectralConfig = DEFAULT_CONFIG):
        """Build the operator whose *analysis* window is the canonical dual
        of ``dual_win`` (so ``dual_win`` becomes the synthesis window)."""
        dual_win = np.asarray(dual_win)
        win = _canonical_dual(dual_win, int(hop))
        return cls(win, int(hop), fs, fft_mode=fft_mode, mfft=mfft,
                   dual_win=dual_win, scale_to=scale_to,
                   phase_shift=phase_shift, config=config)

    @classmethod
    def from_win_equals_dual(cls, desired_win: np.ndarray, hop: int,
                             fs: float, *, fft_mode: str = "onesided",
                             mfft: Optional[int] = None,
                             scale_to: Optional[str] = None,
                             phase_shift: Optional[int] = 0,
                             config: SpectralConfig = DEFAULT_CONFIG):
        """Self-dual window closest in direction to ``desired_win``: each
        residue class is normalized to unit energy, making win its own
        canonical dual (a tight STFT frame).  ``scale_to='unitary'`` scales
        so the full STFT map is unitary."""
        desired_win = np.asarray(desired_win)
        if not (desired_win.ndim == 1 and desired_win.size > 0):
            raise ValueError("desired_win must be a non-empty 1-D array")
        if np.issubdtype(desired_win.dtype, np.integer):
            raise ValueError("desired_win cannot be integer-typed")
        if not np.all(np.isfinite(desired_win)):
            raise ValueError("desired_win must have finite entries")
        if not (isinstance(hop, (int, np.integer))
                and 1 <= hop <= len(desired_win)):
            raise ValueError(f"hop={hop} must be an integer in [1, len(win)]")
        if scale_to not in ("magnitude", "psd", "unitary", None):
            raise ValueError(f"scale_to={scale_to!r} not in "
                             "['magnitude','psd','unitary',None]")
        mfft_ = len(desired_win) if mfft is None else int(mfft)
        norms = np.sqrt(_fold_residues(
            desired_win.real ** 2 + desired_win.imag ** 2, int(hop)))
        tol = np.finfo(np.asarray(desired_win, dtype=float).dtype
                       ).resolution * np.abs(desired_win).max()
        if not np.all(norms > tol):
            raise ValueError("desired_win has an empty residue class: no "
                             f"self-dual window exists at hop={hop}")
        win = desired_win / _expand_residues(norms, len(desired_win))
        s_fac = np.sqrt(mfft_) if scale_to == "unitary" else 1.0
        obj = cls(win / s_fac, int(hop), fs, fft_mode=fft_mode, mfft=mfft_,
                  dual_win=win * s_fac, phase_shift=phase_shift,
                  scale_to=None if scale_to == "unitary" else scale_to,
                  config=config)
        if scale_to == "unitary":
            obj._scaling = "unitary"
        return obj

    # -------------------------------------------------------------- properties

    @property
    def win(self) -> np.ndarray:
        return self._win

    @property
    def hop(self) -> int:
        return self._hop

    @property
    def fs(self) -> float:
        return self._fs

    @fs.setter
    def fs(self, v: float):
        if not v > 0:
            raise ValueError("fs must be positive")
        self._fs = float(v)

    @property
    def T(self) -> float:
        return 1.0 / self._fs

    @T.setter
    def T(self, v: float):
        if not v > 0:
            raise ValueError("T must be positive")
        self._fs = 1.0 / float(v)

    @property
    def mfft(self) -> int:
        return self._mfft

    @property
    def m_num(self) -> int:
        return len(self._win)

    @property
    def m_num_mid(self) -> int:
        return self.m_num // 2

    @property
    def phase_shift(self) -> Optional[int]:
        return self._phase_shift

    @property
    def fft_mode(self) -> str:
        return self._fft_mode

    @fft_mode.setter
    def fft_mode(self, mode: str):
        if mode not in _FFT_MODES:
            raise ValueError(f"fft_mode={mode!r} not in {_FFT_MODES}")
        if mode in ("onesided", "onesided2X") and np.iscomplexobj(self._win):
            raise ValueError("one-sided spectra are not allowed for "
                             "complex-valued windows")
        if mode == "onesided2X" and self.scaling is None:
            raise ValueError("fft_mode='onesided2X' requires scaling "
                             "'magnitude' or 'psd'")
        self._fft_mode = mode

    @property
    def onesided_fft(self) -> bool:
        return self._fft_mode in ("onesided", "onesided2X")

    @property
    def scaling(self) -> Optional[str]:
        return self._scaling

    @property
    def f_pts(self) -> int:
        return self.mfft // 2 + 1 if self.onesided_fft else self.mfft

    @property
    def delta_f(self) -> float:
        return self._fs / self.mfft

    @property
    def delta_t(self) -> float:
        return self._hop / self._fs

    @property
    def f(self) -> np.ndarray:
        if self.onesided_fft:
            return np.fft.rfftfreq(self.mfft, self.T)
        if self._fft_mode == "centered":
            return np.fft.fftshift(np.fft.fftfreq(self.mfft, self.T))
        return np.fft.fftfreq(self.mfft, self.T)

    @property
    def dual_win(self) -> np.ndarray:
        if self._dual_win is None:
            self._dual_win = _canonical_dual(self._win, self._hop)
        return self._dual_win

    @property
    def invertible(self) -> bool:
        try:
            return len(self.dual_win) > 0
        except ValueError:
            return False

    @property
    def fac_magnitude(self) -> float:
        if self._scaling == "magnitude":
            return 1.0
        return 1.0 / abs(np.sum(self._win))

    @property
    def fac_psd(self) -> float:
        if self._scaling == "psd":
            return 1.0
        return 1.0 / np.sqrt(
            np.sum(self._win.real ** 2 + self._win.imag ** 2) / self.T)

    def scale_to(self, scaling: str):
        """Rescale win/dual_win in place so the STFT is a 'magnitude' or
        'psd' representation (scipy semantics: mutates the operator)."""
        if scaling not in ("magnitude", "psd"):
            raise ValueError(f"scaling={scaling!r} not in "
                             "{'magnitude','psd'}")
        if self._scaling == scaling:
            return
        s_fac = self.fac_psd if scaling == "psd" else self.fac_magnitude
        self._win = self._win * s_fac
        if self._dual_win is not None:
            self._dual_win = self._dual_win / s_fac
        self._scaling = scaling

    # ---------------------------------------------------- slice index geometry

    @property
    def p_min(self) -> int:
        return self._pre_padding()[1]

    @property
    def k_min(self) -> int:
        return self._pre_padding()[0]

    def p_max(self, n: int) -> int:
        return self._post_padding(n)[1]

    def k_max(self, n: int) -> int:
        return self._post_padding(n)[0]

    def p_num(self, n: int) -> int:
        return self.p_max(n) - self.p_min

    def _pre_padding(self):
        """(k_min, p_min): first sample index touched and first slice index —
        walk the window left until its support no longer overlaps t >= 0."""
        if "pre" in self._border_cache:
            return self._border_cache["pre"]
        w2 = self._win.real ** 2 + self._win.imag ** 2
        n0 = -self.m_num_mid
        result = None
        for p_, n_ in enumerate(range(n0, n0 - self.m_num - 1, -self._hop)):
            n_next = n_ - self._hop
            # support of the next slice inside t >= 0 is w2[n_next + m_num:]
            # in slice coordinates, i.e. the last -(n_next) window samples
            if n_next + self.m_num <= 0 or not np.any(w2[n_next:]):
                result = (n_, -p_)
                break
        assert result is not None  # p walks past the window length
        self._border_cache["pre"] = result
        return result

    def _post_padding(self, n: int):
        """(k_max, p_max): one-past-the-last sample touched and slice index —
        walk the window right until its support no longer overlaps t < t[n]."""
        self._check_n(n)
        key = ("post", n)
        if key in self._border_cache:
            return self._border_cache[key]
        w2 = self._win.real ** 2 + self._win.imag ** 2
        q1 = n // self._hop
        k1 = q1 * self._hop - self.m_num_mid
        result = None
        for q_, k_ in enumerate(range(k1, n + self.m_num, self._hop),
                                start=q1):
            n_next = k_ + self._hop
            if n_next >= n or not np.any(w2[: n - n_next]):
                result = (k_ + self.m_num, q_ + 1)
                break
        assert result is not None
        self._border_cache[key] = result
        return result

    def _check_n(self, n: int):
        min_n = self.m_num - self.m_num_mid
        if not n >= min_n:
            raise ValueError(f"n={n} must be >= ceil(m_num/2) = {min_n}")

    def lower_border_end(self):
        """(sample index, slice index) past which slices no longer stick out
        to the left of the signal."""
        if "lbe" in self._border_cache:
            return self._border_cache["lbe"]
        w2 = self._win.real ** 2 + self._win.imag ** 2
        m0 = int(np.flatnonzero(w2)[0])
        k0 = -self.m_num_mid + m0
        result = None
        for q_, k_ in enumerate(range(k0, self._hop + 1, self._hop)):
            if k_ + self._hop >= 0:
                result = (k_ + self.m_num, q_ + 1)
                break
        if result is None:
            result = (0, max(self.p_min, 0))
        self._border_cache["lbe"] = result
        return result

    def upper_border_begin(self, n: int):
        """(sample index, slice index) from which slices stick out past the
        signal's right edge."""
        self._check_n(n)
        key = ("ube", n)
        if key in self._border_cache:
            return self._border_cache[key]
        w2 = self._win.real ** 2 + self._win.imag ** 2
        q2 = n // self._hop + 1
        q1 = max((n - self.m_num) // self._hop - 1, -1)
        result = None
        for q_ in range(q2, q1, -1):
            k_ = q_ * self._hop + (self.m_num - self.m_num_mid)
            if k_ <= n or not np.any(w2[n - k_:]):
                result = ((q_ + 1) * self._hop - self.m_num_mid, q_ + 1)
                break
        assert result is not None
        self._border_cache[key] = result
        return result

    def nearest_k_p(self, k: int, left: bool = True) -> int:
        p_q, remainder = divmod(k, self._hop)
        if remainder == 0:
            return k
        return p_q * self._hop if left else (p_q + 1) * self._hop

    def p_range(self, n: int, p0: Optional[int] = None,
                p1: Optional[int] = None):
        p_max = self.p_max(n)
        p0_ = self.p_min if p0 is None else p0
        p1_ = p_max if p1 is None else p1
        if not (self.p_min <= p0_ < p1_ <= p_max):
            raise ValueError(f"invalid slice range p0={p0}, p1={p1}: need "
                             f"{self.p_min} <= p0 < p1 <= {p_max} for n={n}")
        return p0_, p1_

    def t(self, n: int, p0: Optional[int] = None, p1: Optional[int] = None,
          k_offset: int = 0) -> np.ndarray:
        p0, p1 = self.p_range(n, p0, p1)
        return np.arange(p0, p1) * self.delta_t + k_offset * self.T

    def extent(self, n: int, axes_seq: str = "tf",
               center_bins: bool = False):
        """imshow extent of the spectrogram (scipy semantics)."""
        if axes_seq not in ("tf", "ft"):
            raise ValueError(f"axes_seq={axes_seq!r} not in ['tf','ft']")
        if self.onesided_fft:
            q0, q1 = 0, self.f_pts
        elif self._fft_mode == "centered":
            q0 = -(self.mfft // 2)
            q1 = self.mfft // 2 + (self.mfft % 2)
        else:
            raise ValueError("extent needs fft_mode in "
                             "['centered','onesided','onesided2X']")
        p0, p1 = self.p_min, self.p_max(n)
        shift = -0.5 if center_bins else 0.0
        t0, t1 = self.delta_t * (p0 + shift), self.delta_t * (p1 + shift)
        f0, f1 = self.delta_f * (q0 + shift), self.delta_f * (q1 + shift)
        return (t0, t1, f0, f1) if axes_seq == "tf" else (f0, f1, t0, t1)

    # --------------------------------------------------------------- transform

    def _table(self, name: str, a: np.ndarray, like: Tensor) -> Tensor:
        """A window-sized host table beside ``like`` (complex64 or fp32)."""
        dtype = torch.complex64 if np.iscomplexobj(a) else torch.float32
        return constant(a, like, dtype, key=content_key("shorttime." + name, a))

    def _frames(self, x: Tensor, k_off: int, p0: int, p1: int,
                padding: str) -> Tensor:
        """All slices at once: pad once, one strided view of (P, m_num)
        frames, no per-slice Python loop."""
        if padding not in _PAD_MODES:
            raise ValueError(f"padding={padding!r} not in {tuple(_PAD_MODES)}")
        n = x.shape[-1]
        n1 = (p1 - p0) * self._hop
        k0 = p0 * self._hop - self.m_num_mid + k_off
        k1 = k0 + n1 + self.m_num
        i0, i1 = max(k0, 0), min(k1, n)
        x1 = pad_last(x[..., i0:i1], -min(k0, 0), max(k1 - n, 0), _PAD_MODES[padding])
        return x1.unfold(-1, self.m_num, self._hop)[..., : p1 - p0, :]

    def _onesided2x_scale(self, like: Tensor, inverse: bool) -> Tensor:
        fac = np.sqrt(2) if self._scaling == "psd" else 2.0

        def scale() -> np.ndarray:
            s = np.ones(self.f_pts, np.float32)
            s[1: -1 if self.mfft % 2 == 0 else None] = 1.0 / fac if inverse else fac
            return s

        return constant(scale, like, key=("shorttime.2x", self.mfft, float(fac), inverse))

    def _fft_frames(self, frames: Tensor) -> Tensor:
        """Windowed batched forward transform of (..., P, m_num) frames."""
        fz = frames * self._table("win", self._win.conj(), frames)
        if self._phase_shift is not None:
            fz = torch.cat(
                [fz, fz.new_zeros(*fz.shape[:-1], self.mfft - self.m_num)], dim=-1)
            p_s = (self._phase_shift + self.m_num_mid) % self.m_num
            fz = torch.roll(fz, -p_s, dims=-1)
        cfg = self._config
        if self.onesided_fft:
            if fz.is_complex():
                raise ValueError("one-sided fft_mode needs real input")
            X = rfft(fz, n=self.mfft, axis=-1, config=cfg)
            if self._fft_mode == "onesided2X":
                X = X * self._onesided2x_scale(fz, inverse=False)
            return X
        X = fft(fz, n=self.mfft, axis=-1, config=cfg)
        if self._fft_mode == "centered":
            X = fftshift(X, axes=-1)
        return X

    def _ifft_frames(self, X: Tensor) -> Tensor:
        """Inverse of :meth:`_fft_frames` back to (..., P, m_num) frames."""
        cfg = self._config
        if self._fft_mode == "twosided":
            xs = ifft(X, axis=-1, config=cfg)
        elif self._fft_mode == "centered":
            xs = ifft(ifftshift(X, axes=-1), axis=-1, config=cfg)
        elif self._fft_mode == "onesided":
            xs = irfft(X, n=self.mfft, axis=-1, config=cfg)
        else:  # onesided2X
            xs = irfft(X * self._onesided2x_scale(X.real, inverse=True),
                       n=self.mfft, axis=-1, config=cfg)
        if self._phase_shift is None:
            return xs[..., : self.m_num]
        p_s = (self._phase_shift + self.m_num_mid) % self.m_num
        return torch.roll(xs, p_s, dims=-1)[..., : self.m_num]

    def stft(self, x, p0: Optional[int] = None, p1: Optional[int] = None, *,
             k_offset: int = 0, padding: str = "zeros",
             axis: int = -1) -> Tensor:
        """STFT of ``x`` along ``axis`` → (..., f_pts, slices)."""
        return self.stft_detrend(x, None, p0, p1, k_offset=k_offset,
                                 padding=padding, axis=axis)

    def stft_detrend(self, x, detr, p0: Optional[int] = None,
                     p1: Optional[int] = None, *, k_offset: int = 0,
                     padding: str = "zeros", axis: int = -1) -> Tensor:
        """STFT with per-slice detrending applied before windowing.

        'constant' subtracts the slice mean; 'linear' projects out the affine
        component with one precomputed (m_num, 2) orthonormal basis: a
        batched matmul, not a per-slice solve.  A callable receives the full
        (..., P, m_num) frame tensor and must map over the last axis.
        """
        x = as_tensor(x)
        if self.onesided_fft and x.is_complex():
            raise ValueError(f"complex x not allowed for fft_mode="
                             f"{self._fft_mode!r}; use twosided/centered")
        x = x.to(torch.complex64 if x.is_complex() else torch.float32)
        n = x.shape[axis]
        self._check_n(n)
        if x.ndim > 1:
            x = torch.movedim(x, axis, -1)
        p0, p1 = self.p_range(n, p0, p1)
        frames = self._frames(x, k_offset, p0, p1, padding)
        if isinstance(detr, str):
            if detr == "constant":
                frames = frames - torch.mean(frames, dim=-1, keepdim=True)
            elif detr == "linear":
                m = self.m_num

                def basis() -> np.ndarray:
                    b = np.stack([np.ones(m), np.arange(m) - (m - 1) / 2.0], axis=1)
                    return np.linalg.qr(b)[0].astype(np.float32)

                qj = constant(basis, frames.real if frames.is_complex() else frames,
                              key=("shorttime.linear", m)).to(frames.dtype)
                frames = frames - (frames @ qj) @ qj.T
            else:
                raise ValueError(f"detr={detr!r} not 'constant'/'linear'")
        elif detr is not None:
            if not callable(detr):
                raise ValueError("detr must be a str, callable or None")
            frames = detr(frames)
        S = torch.swapaxes(self._fft_frames(frames), -1, -2)  # (..., f, P)
        if S.ndim > 2:
            S = torch.movedim(S, -2, axis if axis >= 0 else axis - 1)
        return S

    def spectrogram(self, x, y=None, detr=None, *, p0: Optional[int] = None,
                    p1: Optional[int] = None, k_offset: int = 0,
                    padding: str = "zeros", axis: int = -1) -> Tensor:
        """|S|² (or the cross-spectrogram Sx·conj(Sy) when ``y`` given)."""
        Sx = self.stft_detrend(x, detr, p0, p1, k_offset=k_offset,
                               padding=padding, axis=axis)
        if y is None or y is x:
            return Sx.real ** 2 + Sx.imag ** 2
        Sy = self.stft_detrend(y, detr, p0, p1, k_offset=k_offset,
                               padding=padding, axis=axis)
        return Sx * torch.conj(Sy)

    def istft(self, S, k0: int = 0, k1: Optional[int] = None, *,
              f_axis: int = -2, t_axis: int = -1) -> Tensor:
        """Inverse STFT over samples [k0, k1) via dual-window overlap-add:
        one batched inverse transform plus one scatter-add whose index table
        is computed on the host."""
        S = as_tensor(S)
        f_axis = f_axis % S.ndim
        t_axis = t_axis % S.ndim
        if f_axis == t_axis:
            raise ValueError("f_axis must differ from t_axis")
        if S.shape[f_axis] != self.f_pts:
            raise ValueError(f"S.shape[f_axis]={S.shape[f_axis]} != "
                             f"f_pts={self.f_pts}")
        n_min = self.m_num - self.m_num_mid
        q_num = self.p_num(n_min)
        if S.shape[t_axis] < q_num:
            raise ValueError(f"S needs at least {q_num} slices on t_axis")
        if (f_axis, t_axis) != (S.ndim - 2, S.ndim - 1):
            S = torch.movedim(S, (f_axis, t_axis), (-2, -1))

        q_max = S.shape[-1] + self.p_min
        k_maximum = (q_max - 1) * self._hop + self.m_num - self.m_num_mid
        k1 = k_maximum if k1 is None else k1
        if not (self.k_min <= k0 < k1 <= k_maximum):
            raise ValueError(f"need k_min={self.k_min} <= k0={k0} < k1={k1} "
                             f"<= k_max={k_maximum}")
        if k1 - k0 < n_min:
            raise ValueError(f"k1-k0={k1 - k0} must be >= ceil(m_num/2)="
                             f"{n_min}")

        q0 = (k0 // self._hop + self.p_min if k0 >= 0 else k0 // self._hop)
        q0 = max(q0, self.p_min)  # slices below p_min do not exist in S
        q1 = min(self.p_max(k1), q_max)
        k_q0 = self.nearest_k_p(k0)
        k_q1 = self.nearest_k_p(k1, left=False)
        n_pts = k_q1 - k_q0 + self.m_num - self.m_num_mid

        Sq = torch.swapaxes(S[..., :, q0 - self.p_min: q1 - self.p_min], -1, -2)
        xs = self._ifft_frames(Sq)  # (..., Q, m_num)
        xs = xs * self._table("dual", self.dual_win, xs.real if xs.is_complex() else xs)
        if self.onesided_fft and xs.is_complex():
            xs = xs.real

        # scatter-add with out-of-range contributions sent to a drop slot
        def positions() -> np.ndarray:
            qs = np.arange(q0, q1)
            pos = (qs[:, None] * self._hop - self.m_num_mid
                   + np.arange(self.m_num)[None, :]) - k0  # target sample index
            valid = (pos >= 0) & (pos < n_pts)
            return np.where(valid, pos, n_pts).reshape(-1)  # n_pts = drop slot

        like = xs.real if xs.is_complex() else xs
        pos_flat = constant(positions, like, torch.long, key=(
            "shorttime.ola", q0, q1, self._hop, self.m_num, k0, n_pts))
        contrib = xs.reshape(*xs.shape[:-2], -1)
        x = xs.new_zeros(*xs.shape[:-2], n_pts + 1)
        x = x.index_add(-1, pos_flat, contrib)[..., :n_pts]
        x = x[..., : k1 - k0]
        if x.ndim > 1:
            x = torch.movedim(x, -1, f_axis if f_axis < x.ndim else t_axis)
        return x
