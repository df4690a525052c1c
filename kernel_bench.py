"""Time the fused Stockham kernel of one or more checkouts on an NVIDIA GPU.

    python3 kernel_bench.py [ROOT ...]

Each ROOT is a directory holding a ``mixed_radix_fast_fourier_transform_tpu_torch``
package (default: this checkout).  The roots run in the order given, each in
a child process of its own, so that two versions can be compared in one run
on one card, e.g. ``parent . . parent``.  For each root it builds the kernel
and prints one JSON line with, at ``SHAPES``:

* ``kernel_us``: device time of one call, from 20 back-to-back calls
  captured in a CUDA graph and replayed 10 times between CUDA events;
* ``cufft_us``: the same for ``torch.fft.fft`` on the same values;
* ``wrapper_us``: wall time per call of 2000 back-to-back ``exec_kernel``
  calls at n = 2048, 8 rows, where the wrapper's host path sets the pace.

Needs one CUDA device; there is no CPU path.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# (n, rows) at which the kernel is held against cuFFT: the spectral filter's
# inner transform at batch 8 and 1024, the BENCH_r05 core lengths that the
# kernel takes, and n = 8192
SHAPES = ((2048, 8), (2048, 1024), (1024, 256), (4096, 64), (5040, 64), (8192, 1024))


def graph_us(torch, fn, launches: int = 20, replays: int = 10) -> float:
    """Device time of one call in µs: ``launches`` back-to-back calls
    captured in a CUDA graph, replayed ``replays`` times between two CUDA
    events (no host gaps between the launches)."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(launches):
                fn()
    torch.cuda.synchronize()
    for _ in range(3):
        graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / (launches * replays)


def wrapper_us(torch, fn, calls: int = 2000, warmup: int = 100) -> float:
    """Wall time of one call in µs: ``calls`` calls issued back to back after
    ``warmup``, where the host, not the card, sets the pace."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def measure(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from mixed_radix_fast_fourier_transform_tpu_torch.ops import cuda_fft

    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench: no CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"root": root, "card": torch.cuda.get_device_name(0), "shapes": []}
    for n, rows in SHAPES:
        xr = torch.randn(rows, n, device="cuda", generator=gen)
        xi = torch.randn(rows, n, device="cuda", generator=gen)
        xc = torch.complex(xr, xi)
        out["shapes"].append({
            "n": n, "batch": rows,
            "kernel_us": graph_us(torch, lambda: cuda_fft.exec_kernel(xr, xi, n, -1)),
            "cufft_us": graph_us(torch, lambda: torch.fft.fft(xc)),
        })
    xr = torch.randn(8, 2048, device="cuda", generator=gen)
    xi = torch.randn(8, 2048, device="cuda", generator=gen)
    out["wrapper_us"] = wrapper_us(torch, lambda: cuda_fft.exec_kernel(xr, xi, 2048, -1))
    return out


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(measure(argv[1])), flush=True)
        return 0
    for root in argv or ["."]:
        res = subprocess.run([sys.executable, __file__, "--one", root])
        if res.returncode != 0:
            return res.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
