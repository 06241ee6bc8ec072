"""Seeded KKT blocks and CUDA timing, shared by chip_smoke.py, the build
comparison (sweep_builds) and the GPU tests."""

from __future__ import annotations

import statistics

import numpy as np
import torch

__all__ = ["seeded_kkt", "time_ms", "graph_ms"]


def seeded_kkt(Bn, Tn, d, s, device, r=None, seed=0):
    """Seeded float32 blocks H, C, A, B, rz, rnu and a second right-hand
    side rz2, rnu2, shaped like dynamics defects (A ≈ -I, B ≈ I) and
    definite, so that float32 resolves them (their float32 error against
    float64 is ~1e-6 relative at d=15).  At the two-qubit size the noise
    shrinks with d, and B ≈ I/2 makes the chain contract: with B ≈ I the
    eliminated blocks sum H along the 40 knots, and the carried rhs reaches
    ~7e3, where float32 rounding alone is ~8e-5 of it (a CPU
    float32-vs-float64 probe).  With r, the right-hand sides have r
    columns."""
    rng = np.random.default_rng(seed)
    cols = () if r is None else (r,)
    small = d <= 16
    w = 0.3 if small else 1.0 / np.sqrt(d)
    Hs = np.eye(d) * 3 + w * rng.normal(size=(Bn, Tn, d, d))
    E = np.eye(s, d)
    out = [0.5 * (Hs + np.swapaxes(Hs, -1, -2)),
           (0.2 if small else 0.7 * w) * rng.normal(size=(Bn, Tn - 1, d, d)),
           -E + 0.1 * rng.normal(size=(Bn, Tn - 1, s, d)),
           (1.0 if small else 0.5) * E + 0.1 * rng.normal(size=(Bn, Tn - 1, s, d)),
           rng.normal(size=(Bn, Tn, d, *cols)), rng.normal(size=(Bn, Tn - 1, s, *cols)),
           rng.normal(size=(Bn, Tn, d, *cols)), rng.normal(size=(Bn, Tn - 1, s, *cols))]
    return [torch.as_tensor(x, dtype=torch.float32, device=device) for x in out]


def time_ms(fn, n=20, warm=3):
    """Median of n calls of fn between two CUDA events, after warm calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(fn, n=20):
    """Median device time of one replay of a CUDA graph holding fn (its
    launches back to back, without the host between them)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capture: the launchers' one-time set-up
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return time_ms(g.replay, n)
