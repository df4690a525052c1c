"""Ahead-of-time set-up and serialized export of spectral pipelines.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/utils/aot.py``.  A
pipeline (any composition of this library's ops) can be

* **compiled ahead of time** (:func:`aot_compile`, JAX's
  ``jit(...).lower().compile()``): ``torch.compile`` of the pipeline for
  the example shapes, compiled now (plans, device tables and the fused
  kernel's library are built while it traces), and on the card one call
  captured in a CUDA graph, so the first real call pays no set-up; or
* **exported** (:func:`export_transform` / :func:`load_transform`):
  ``torch.export`` of the pipeline saved to bytes.  Plans are trace-time
  constants: the exported graph holds the plan constants as tensors, and
  no plan cache or factorization is left in the serving path.

An export takes the route the config and the device take live.  On the
stage pipeline (a CPU tensor by default, or ``use_kernel=False``) at fp32
"highest" the program is aten ops alone and reloads without this library.
At a length the fused kernel takes on the card (or with
``use_kernel=True``) the graph holds the kernel's operator,
``mixed_radix_fft::stockham_fft``, and at another precision or on 2-byte
planes the products' operator ``mixed_radix_precision::matmul``; each must
be registered where it reloads: :func:`load_transform` imports
``ops/cuda_fft.py`` (and with it the package), which needs no card to
import.
"""

from __future__ import annotations

import io
from typing import Any, Callable, Sequence

import torch

from .tree import tree_map
from .numerics import as_tensor


class _Prepared:
    """A pipeline compiled for fixed argument shapes; calls replay the CUDA
    graph captured at set-up where the arguments live on the card."""

    def __init__(self, fn: Callable, args, kwargs):
        self._static = [a.clone() for a in args]
        on_card = all(a.device.type == "cuda" for a in self._static)
        # Inductor on the card; on the CPU, which is no target of the port,
        # AOTAutograd's graph runs as it is (Inductor's C++ build there costs
        # tens of seconds a shape)
        name = getattr(fn, "__name__", "fn")
        fn = torch.compile(fn, fullgraph=True, dynamic=False,
                           backend="inductor" if on_card else "aot_eager")
        self._fn, self._kwargs = fn, kwargs
        self._graph = None
        try:
            out = fn(*self._static, **kwargs)      # compiles: plans, tables, the library
        except torch._dynamo.exc.TorchDynamoException as e:
            raise ValueError(
                f"aot_compile compiles {name} whole "
                f"(torch.compile, fullgraph=True), and it does not trace: the "
                f"port's compiled path covers fft, ifft, rfft, irfft, fft_convolve "
                f"and the engine under them at every SpectralConfig.precision and "
                f"working dtype, convolve and correlate (direct too), sht, isht, "
                f"sphere_grad, sht_recurrence and isht_recurrence (compensated too), "
                f"melspectrogram, pcen, linear_recurrence, "
                f"lfilter, sosfilt, filtfilt, sosfiltfilt, pfb_analysis, radon, iradon, "
                f"multitaper, griffinlim (seed=), wigner_ville, ssq_cwt, ssq_stft, "
                f"reassigned_spectrogram, stockwell, dwt, idwt, cqt, icqt, fht, ifht, "
                f"fwht, cwt_tc, ewt (boundaries=), specaugment (seed= or the default "
                f"draws), the dense NUFFTs and nufft3, nufft3_2d, nufft3_3d ('auto' "
                f"without extents takes dense; 'fast' needs static extents), "
                f"tempo, beat_track, scattering1d, scattering2d, vmd (every "
                f"init_omega form; their loops are loop operators: "
                f"utils.scan.fori_loop and scan), "
                f"every function of parallel/ on a plain tensor or a DTensor (the "
                f"four-step family, the pencils, the batch-sharded calls, the "
                f"sharded NUFFTs and SHTs; the API ops, the spectral filter, "
                f"melspectrogram, cqt, multitaper and the AFNO on a batch-sharded "
                f"DTensor), "
                f"and the spectral filter, FNO, S4D, FNet, AFNO, SFNO, PCEN front "
                f"end and Koopman models so far (their distributed forms too), "
                f"the ops other than the engine, "
                f"the convolutions, fwht, wct's smoothing, the dense NUFFTs and "
                f"the products of mel.py and feature.py at "
                f"precision 'highest' only; a host array made "
                f"inside the function (np.linspace as theta, a design as sos or h) "
                f"must be made outside it (ROADMAP.md lists the rest). "
                f"{str(e).splitlines()[0]}") from e
        if on_card:
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                fn(*self._static, **kwargs)
                self._graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(self._graph, stream=stream):
                    out = fn(*self._static, **kwargs)
            torch.cuda.current_stream().wait_stream(stream)
        self._out = out

    def __call__(self, *args):
        if len(args) != len(self._static) or any(
                a.shape != s.shape or a.dtype != s.dtype or a.device != s.device
                for a, s in zip(args, self._static)):
            raise ValueError(
                "arguments differ from the example shapes, dtypes or devices: "
                f"{[(tuple(a.shape), a.dtype, a.device) for a in args]}")
        if self._graph is None:
            return self._fn(*args, **self._kwargs)
        for s, a in zip(self._static, args):
            s.copy_(a)
        self._graph.replay()
        return tree_map(torch.clone, self._out)


def aot_compile(fn: Callable, *example_args: Any, **fn_kwargs):
    """Compile ``fn`` for the shapes and devices of ``example_args``
    (tensors; numpy arrays go to the card): ``torch.compile(fn,
    fullgraph=True, dynamic=False)`` (Inductor; ``aot_eager`` for CPU
    tensors) called once now, which builds every plan, device table and the
    kernel library it needs while it traces, and on the card a second call
    captured in a CUDA graph (with the products of a precision other than
    "highest", which set their own flags inside the graph: TF32 runs where
    the config asks for it); a ``fn`` that does not trace whole raises
    ValueError.  Returns a callable for arguments of those shapes, dtypes and devices
    (``fn_kwargs`` are passed on every call).  The JAX executable's
    ``.cost_analysis()`` and ``.memory_analysis()`` have no counterpart."""
    return _Prepared(fn, [as_tensor(a) for a in example_args], fn_kwargs)


class _Pipeline(torch.nn.Module):
    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_transform(
    fn: Callable,
    *example_args: Any,
    platforms: Sequence[str] | None = None,
) -> bytes:
    """Serialize ``fn`` for the given example shapes (tensors on the device
    the transform will run on) as ``torch.export`` bytes (see the module
    docstring).  ``platforms`` (the JAX function's lowering targets) has no
    counterpart: an exported program runs on the device its example
    tensors were on, and on another after ``.to``; it must be None."""
    if platforms is not None:
        raise ValueError("platforms has no torch counterpart; pass example tensors "
                         "on the target device instead")
    exported = torch.export.export(_Pipeline(fn), tuple(as_tensor(a) for a in example_args))
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    return buf.getvalue()


def load_transform(blob: bytes) -> Callable:
    """Reload a serialized transform (from :func:`export_transform`) as a
    callable module, checked against the export-time argument shapes.  The
    fused kernel's operator is registered first, for a program that holds
    it."""
    from ..ops import cuda_fft  # noqa: F401  (registers mixed_radix_fft::stockham_fft)

    return torch.export.load(io.BytesIO(blob)).module()
