"""PyTorch port: the nine example programs (``examples/``) on the CPU at a
reduced size, each asserting its own invariants.  The JAX examples that
keep their body under ``if __name__ == "__main__"`` are loaded by path:
their module-level helpers are held bit-equal to the port's, and where a
JAX example's main or its pieces take sizes, the port's numbers are held to
the JAX run's at the same size and data: 1e-5 relative for single
transforms, 1e-4 after iterations or training steps.  ``radar_array`` and
``signal_toolbox`` run at module level in the JAX package: only their
invariants are held."""

import importlib.util
import io
import pathlib
import re
import subprocess
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mixed_radix_fast_fourier_transform_tpu as sp
from mixed_radix_fast_fourier_transform_tpu.models import fno as jfno

from mixed_radix_fast_fourier_transform_tpu_torch.examples import (
    audio_features, demo, fno_train, mri_recon, pde_spectral, radar_array, serving_export,
    signal_toolbox, sphere_advection,
)

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-5         # single transforms
ITER_TOL = 1e-4    # after iterations or training steps


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _quiet(fn, *args, **kw):
    with redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


def test_helpers_are_bit_equal():
    jmri, jfno_ex = _jax_example("mri_recon"), _jax_example("fno_train")
    assert np.array_equal(mri_recon.phantom(24), jmri.phantom(24))
    for got, want in zip(mri_recon.radial_kspace(24, 16, 48), jmri.radial_kspace(24, 16, 48)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    a, b = mri_recon.phantom(16), np.random.default_rng(1).standard_normal((16, 16))
    assert mri_recon.psnr(b, a) == jmri.psnr(b, a)
    u0 = np.random.default_rng(2).standard_normal((3, 64)).astype(np.float32)
    assert np.array_equal(fno_train.heat_solution(u0), jfno_ex.heat_solution(u0))
    got = fno_train.make_batch(np.random.default_rng(3), 4, 64)
    want = jfno_ex.make_batch(np.random.default_rng(3), 4, 64)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_serving_export_matches_jax():
    out = _quiet(serving_export.main, device="cpu", batch=2, n=1024)
    frames = np.random.default_rng(0).standard_normal((2, 1024)).astype(np.float32)
    want = np.asarray(jax.jit(_jax_example("serving_export").denoise)(frames))
    assert _rel(out["output"].numpy(), want) <= TOL
    assert out["artifact_bytes"] > 0 and out["aot_max_err"] == 0.0


def test_fno_train_matches_jax():
    import optax

    steps, n, batch = 5, 64, 8
    jex = _jax_example("fno_train")
    params = jfno.init_fno(jax.random.PRNGKey(0), 1, 16, 1, n_layers=2, modes=24)
    start = jax.tree_util.tree_map(np.asarray, params)
    opt = optax.adam(3e-3)
    state = opt.init(params)

    @jax.jit
    def step(params, state, x, y):
        loss, grads = jax.value_and_grad(jfno.loss_fn)(params, x, y)
        updates, state = opt.update(grads, state)
        return optax.apply_updates(params, updates), state, loss

    rng = np.random.default_rng(0)
    xe, ye = jex.make_batch(rng, batch, n)
    for _ in range(steps):
        x, y = jex.make_batch(rng, batch, n)
        params, state, _ = step(params, state, jnp.asarray(x), jnp.asarray(y))
    want = float(jfno.loss_fn(params, jnp.asarray(xe), jnp.asarray(ye)))
    out = _quiet(fno_train.main, device="cpu", steps=steps, n=n, batch=batch, params=start)
    assert abs(out["final_eval_loss"] - want) <= ITER_TOL * want
    assert out["baseline"] == float(np.mean(ye ** 2))
    assert out["final_eval_loss"] < out["history"][0][2]   # it learns


def test_pde_spectral():
    assert _quiet(pde_spectral.heat_2d, device="cpu", n=32) < 1e-5
    burgers = _quiet(pde_spectral.burgers_1d, device="cpu", n=64, steps=50)
    assert burgers["err"] < 1e-3 and burgers["drift"] < 1e-5
    poisson = _quiet(pde_spectral.poisson_2d, device="cpu", n=48)
    assert poisson["err"] < 1e-5 and poisson["residual"] < 1e-2


def test_sphere_advection():
    out = _quiet(sphere_advection.main, device="cpu", lmax=15, steps=40)
    assert out["q"].shape == (16, 32) and out["err"] < 1e-4


def test_mri_recon_matches_jax():
    n, spokes, iters = 16, 32, 10
    out = _quiet(mri_recon.main, device="cpu", n=n, spokes=spokes, iters=iters)
    img = mri_recon.phantom(n)
    x, y, w = mri_recon.radial_kspace(n, spokes, 2 * n)
    b = np.asarray(sp.nufft2_2d(x, y, img.astype(np.complex64), isign=-1))
    assert _rel(out["samples"], b) <= TOL
    adj = np.asarray(sp.nufft1_2d(x, y, (b * w).astype(np.complex64), (n, n), isign=+1)) / len(x)
    assert _rel(out["adjoint"], adj) <= TOL
    rec = np.asarray(sp.nufft_lsq_2d(x, y, b.astype(np.complex64), (n, n), weights=w,
                                     iters=iters, isign=-1))
    assert _rel(out["cg"], rec) <= ITER_TOL
    assert out["psnr_cg"] > out["psnr_adjoint"]


def test_radar_array_invariants():
    out = _quiet(radar_array.main, device="cpu")
    assert out["peak"] == (22, 140) and out["second_detected"]
    assert out["pfb_err"] < 1e-3 and abs(out["look_gain"] - 1) < 1e-3


def test_audio_features_invariants():
    out = _quiet(audio_features.main, device="cpu", seconds=0.5, griffinlim_iters=4)
    assert out["mel_shape"][1] == 64 and out["mfcc_shape"][1] == 13
    assert abs(out["multitaper_peak"] - 660.0) < 5.0


def test_signal_toolbox_invariants():
    out = _quiet(signal_toolbox.main, device="cpu")
    assert out["hum"][1] < 0.1 * out["hum"][0] and out["bicoherence"] > 0.9
    assert out["kalman_mse"][1] < out["kalman_mse"][0]


SECTIONS = [s for s in demo.SECTIONS if s is not demo.demo_sharded]


@pytest.mark.parametrize("section", SECTIONS, ids=[s.__name__ for s in SECTIONS])
def test_demo_section(section):
    out = _quiet(section, device="cpu")
    assert isinstance(out, dict) and out
    if section in (demo.demo_complex, demo.demo_real):
        # the JAX demo's verdict at the same sizes: every round trip "[ok]"
        buf = io.StringIO()
        with redirect_stdout(buf):
            getattr(_jax_example("demo"), section.__name__)()
        verdicts = re.findall(r"N=\s*(\d+): round-trip MSE (\S+)\s+\[(\w+)\]", buf.getvalue())
        assert [int(n) for n, _, _ in verdicts] == list(out)
        assert all(v == "ok" for _, _, v in verdicts)


def test_demo_sharded_on_a_world_of_one():
    """In a process of its own: the test process joins no process group."""
    code = ("from mixed_radix_fast_fourier_transform_tpu_torch.examples import demo\n"
            "import torch.distributed as dist\n"
            "out = demo.demo_sharded(device='cpu')\n"
            "assert out['ranks'] == 1 and not dist.is_initialized()\n"
            "print('OK', out['four_step_err'], out['sht_err'])\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(ROOT))
    assert res.returncode == 0 and "OK" in res.stdout, res.stderr
