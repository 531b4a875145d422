"""Profiling helpers (port of ``primus_fhe_tpu/utils/profiling.py``).

``trace()`` wraps a region in ``torch.profiler`` (CPU and, where there is
one, the card) and writes a Chrome trace; ``Timer`` is a wall clock that
waits for the card before it reads the clock; ``ntt_modmuls`` and
``op_rate`` turn measured times into the modmul/s accounting.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a region: ``with trace(dir) as prof: run()``; the trace lands
    in ``dir/trace.json`` (Perfetto or ``chrome://tracing``), and ``prof``
    gives ``key_averages()``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    """Wall-clock seconds of a ``with`` block (``elapsed``), with the card
    synchronised at both ends, so queued work counts where it ran."""

    def __init__(self):
        self.elapsed = 0.0

    def __enter__(self):
        _sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync()
        self.elapsed = time.perf_counter() - self._t0


def ntt_modmuls(n: int, count: int = 1) -> int:
    """NTT-equivalent modmul count: ``count * (n/2) * log2(n)``."""
    return count * (n // 2) * (n.bit_length() - 1)


def op_rate(ops: int, seconds: float) -> float:
    return ops / max(seconds, 1e-12)
