"""Sensor-array radar walkthrough: channelize -> beamform -> detect.

Counterpart of the JAX package's ``examples/radar_array.py``, each stage
asserting its invariant:

1. an 8-element half-wavelength ULA receives two pulse-Doppler targets
   plus a strong off-axis jammer;
2. the PFB channelizer isolates the radar subband, and the inverse
   channelizer round-trips the data to fp32 round-off;
3. MVDR beamforming nulls the jammer while keeping unit gain on the look
   direction;
4. pulse compression + Doppler FFT form the range-Doppler map;
5. 2-D CA-CFAR pulls both targets out of the noise.

Run: python -m mixed_radix_fast_fourier_transform_tpu_torch.examples.radar_array
"""

from __future__ import annotations

import numpy as np
import torch

from .. import (cfar, mvdr_weights, pfb_analysis, pfb_synthesis, range_doppler,
                spatial_covariance, steering_vector)
from ..utils.numerics import resolve_device

TARGETS = (  # (angle°, range bin, Doppler bin, amplitude)
    (-25.0, 140, 6, 1.0),
    (10.0, 330, -4, 0.6),
)
JAM_ANGLE = 40.0


def scene(n_el: int = 8, n_pulses: int = 32, n_rng: int = 512, n_tx: int = 64):
    """The received CPI (elements, pulses, range) and the LFM pulse, drawn
    from seed 7 in the JAX example's order."""
    rng = np.random.default_rng(7)
    t = np.arange(n_tx)
    tx = np.exp(1j * np.pi * 0.6 / n_tx * (t - n_tx / 2) ** 2)  # LFM pulse
    m = np.arange(n_pulses)[:, None]
    rx = 0.25 * (rng.standard_normal((n_el, n_pulses, n_rng))
                 + 1j * rng.standard_normal((n_el, n_pulses, n_rng)))
    for ang, d0, fd, amp in TARGETS:
        a = steering_vector(n_el, ang)[:, 0]
        echo = amp * tx * np.exp(2j * np.pi * fd * m / n_pulses)
        rx[:, :, d0:d0 + n_tx] += a[:, None, None] * echo
    aj = steering_vector(n_el, JAM_ANGLE)[:, 0]
    jam = 5.0 * (rng.standard_normal((n_pulses, n_rng))
                 + 1j * rng.standard_normal((n_pulses, n_rng)))
    rx += aj[:, None, None] * jam
    return rx.astype(np.complex64), tx.astype(np.complex64)


def main(*, device=None, n_el: int = 8, n_pulses: int = 32, n_rng: int = 512,
         n_tx: int = 64) -> dict:
    dev = resolve_device(device)
    rx_np, tx_np = scene(n_el, n_pulses, n_rng, n_tx)
    rx = torch.tensor(rx_np, device=dev)
    tx = torch.tensor(tx_np, device=dev)
    out = {}

    # 1. PFB channelizer round trip (transport-layer integrity)
    K, P = 16, 8
    flat = rx.reshape(n_el, -1)
    Y = pfb_analysis(flat, K, P, mode="full")
    back = pfb_synthesis(Y, P)
    out["pfb_err"] = float((back - flat).abs().max())
    print(f"1. PFB channelize+invert: {Y.shape[-2]} frames x {K} channels, "
          f"round-trip err {out['pfb_err']:.2e}")
    assert out["pfb_err"] < 1e-3

    # 2. MVDR beamforming: null the jammer, keep the look direction
    R = spatial_covariance(flat, forward_backward=True)
    aj = steering_vector(n_el, JAM_ANGLE)[:, 0]
    ang = TARGETS[0][0]
    w0 = mvdr_weights(R, n_el, ang, diagonal_loading=1e-4)
    w0_host = w0.cpu().numpy()
    out["look_gain"] = float(abs(np.vdot(w0_host, steering_vector(n_el, ang)[:, 0])))
    out["jammer_gain"] = float(abs(np.vdot(w0_host, aj)))
    print(f"2. MVDR @ {ang:+.0f}°: look gain {out['look_gain']:.4f}, jammer gain "
          f"{out['jammer_gain']:.2e} ({20 * np.log10(out['jammer_gain']):.0f} dB)")
    assert abs(out["look_gain"] - 1.0) < 1e-3 and out["jammer_gain"] < 0.02

    # 3+4. beamform the CPI and form the range-Doppler map
    def beam_map(w):
        beam = torch.einsum("i,ipr->pr", w.conj(), rx)
        return range_doppler(beam, tx, window="hamming").abs() ** 2

    P_map = beam_map(w0)
    pk = tuple(int(i) for i in np.unravel_index(int(P_map.argmax()), tuple(P_map.shape)))
    want = (n_pulses // 2 + TARGETS[0][2], TARGETS[0][1])
    out["peak"] = pk
    print(f"3. range-Doppler peak at (doppler,range)={pk}, expected {want}")
    assert pk == want

    # 5. CFAR detection
    det, _ = cfar(P_map, num_train=6, num_guard=2, pfa=1e-4, axes=(-2, -1))
    det = det.cpu().numpy()
    out["detections"] = int(det.sum())
    print(f"4. CA-CFAR: {det.sum()} detections, target cell detected = {bool(det[want])}")
    assert det[want]

    # the second target sits off the beam's look direction but survives the
    # beamformer's distortionless response enough to detect too
    w1 = mvdr_weights(R, n_el, TARGETS[1][0], diagonal_loading=1e-4)
    det1, _ = cfar(beam_map(w1), num_train=6, num_guard=2, pfa=1e-4, axes=(-2, -1))
    want1 = (n_pulses // 2 + TARGETS[1][2], TARGETS[1][1])
    out["second_detected"] = bool(det1.cpu().numpy()[want1])
    print(f"5. second beam: target 2 detected = {out['second_detected']}")
    assert out["second_detected"]
    print("radar_array: all stages verified")
    return out


if __name__ == "__main__":
    main()
