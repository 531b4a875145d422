"""Kernels 1 and 2: the 32-bit negacyclic NTT and its inverse, one launch for
all primes of a convolver.

Replaces ``pallas_forward32`` and ``pallas_inverse32``
(``primus_fhe_tpu/ops/ntt_pallas.py:848,855``, kernels
``_make_fwd_kernel32``/``_make_inv_kernel32``).  CUDA source:
``csrc/ntt32.cu``.

Design on Hopper.  What bounds the transforms: at N = 2048 a row is 8 KB in
and 8 KB out against 11k Shoup butterflies, so 256 rows (4.2 MB) are bound
by device memory (1.25 us at 3.35 TB/s), and a few rows by latency: the
launch, then the chain of dependent shared-memory round trips and barriers
through log N stages.  So each thread holds one radix-8 group of 8 words in
registers through 3 stages, and a transform is ``ceil(log N / 3)`` passes
with a barrier between two (4 passes, 3 barriers at N = 1024 and 2048); the
forward's first pass reads its groups straight from device memory and its
last pass (the remainder, 1-3 stages) stores them straight back, 8 or 16
bytes a thread, and the inverse mirrors it.  The passes between live in
shared memory at a swizzled index on which every warp hits 32 distinct
banks.  The forward's first pass takes its 7 roots into registers while
the prime's root table and Shoup quotients (16 KB at N = 2048) are copied
into shared memory; the inverse's first pass reads its twiddles from device
memory while the part its later passes use is copied.  A block takes a
tile of rows of one prime, so each staged table word serves the whole tile;
the C entry picks the tile from the rows, the SM count and the blocks an
SM holds (``csrc/ntt32.cu``'s ``pick_tile``: the smallest tile that runs
the grid in one wave).  The passes are one copy in
``csrc/ntt_passes.cuh``, shared with the CMux step kernel and (at 64 bits)
row 10's kernels.

The butterflies are the plain version's (:mod:`..transforms.ntt`) formulas
exactly, so canonical and lazy outputs are bit-equal to it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..numeric.limb import narrow_u32, widen_u32
from ..transforms.ntt import forward32 as _plan_forward32
from ..transforms.ntt import inverse32 as _plan_inverse32
from ..transforms.plan import build_plan32
from ..utils.contracts import check_range_u32
from . import build

MAX_PRIMES = 4  # PFT_MAX_KP in csrc/modarith32.cuh
MAX_LOG_N = 14  # the kernels' largest row (MAX_LOG_N in csrc/ntt32.cu)


class NttTables32:
    """Per-prime NTT plans of a prime list, and their kernel-side copies.

    ``prime_pack`` is the host array the kernels unpack into ``PrimeSet``
    (``csrc/modarith32.cuh``): per prime ``q, inv_n, inv_n_precon, inv_n_w,
    inv_n_w_precon, 2^32 mod q, floor(2^64 / q)``.
    """

    def __init__(self, log_n: int, primes):
        if not 1 <= len(primes) <= MAX_PRIMES:
            raise ValueError(f"1 to {MAX_PRIMES} primes supported")
        self.log_n = log_n
        self.n = 1 << log_n
        self.primes = tuple(int(p) for p in primes)
        self.plans = [build_plan32(log_n, p) for p in self.primes]
        self.prime_pack = np.array(
            [
                [pl.q, pl.inv_n, pl.inv_n_precon, pl.inv_n_w, pl.inv_n_w_precon,
                 (1 << 32) % pl.q, (1 << 64) // pl.q]
                for pl in self.plans
            ],
            dtype=np.uint64,
        ).reshape(-1)
        self._plans_on = {torch.device("cpu"): self.plans}
        self._kernel_on: dict = {}

    def plans_on(self, device) -> list:
        device = torch.device(device)
        if device not in self._plans_on:
            self._plans_on[device] = [pl.to(device) for pl in self.plans]
        return self._plans_on[device]

    def kernel_tables(self, device):
        """``(roots, roots_precon, inv_roots, inv_roots_precon)``, each
        ``(kp, n)`` in int32 storage on ``device``."""
        device = torch.device(device)
        if device not in self._kernel_on:
            self._kernel_on[device] = tuple(
                narrow_u32(torch.stack([getattr(pl, name) for pl in self.plans])).to(device)
                for name in ("roots", "roots_precon", "inv_roots", "inv_roots_precon")
            )
        return self._kernel_on[device]


def forward32_plain(tables: NttTables32, values: torch.Tensor, out_factor: int = 1):
    """Plain version: per-prime :func:`transforms.ntt.forward32` on
    ``values (kp, ..., n)`` int64 words."""
    plans = tables.plans_on(values.device)
    return torch.stack([_plan_forward32(pl, values[i], out_factor) for i, pl in enumerate(plans)])


def inverse32_plain(tables: NttTables32, values: torch.Tensor, out_factor: int = 1):
    """Plain version: per-prime :func:`transforms.ntt.inverse32`."""
    plans = tables.plans_on(values.device)
    return torch.stack([_plan_inverse32(pl, values[i], out_factor) for i, pl in enumerate(plans)])


def _run(wrapper, plain, entry: str, table_idx: int, tables: NttTables32, values, out_factor):
    """CPU tensors -> ``plain``; CUDA tensors -> the kernel ``entry`` with
    the tables at ``table_idx``; the output keeps the input's storage."""
    if values.device.type == "cpu":
        out = plain(tables, widen_u32(values), out_factor)
        return narrow_u32(out) if values.dtype == torch.int32 else out
    if values.device.type != "cuda":
        raise ValueError(f"{wrapper.__name__}: unsupported device {values.device}")
    kp, n = len(tables.primes), tables.n
    if values.shape[0] != kp or values.shape[-1] != n:
        raise ValueError(f"expected (kp={kp}, ..., n={n}), got {tuple(values.shape)}")
    if tables.log_n > MAX_LOG_N:
        raise ValueError(f"{wrapper.__name__}: the kernel takes log_n 1-{MAX_LOG_N} on the card, "
                         f"got {tables.log_n}")
    v = narrow_u32(values).contiguous()
    if v.data_ptr() % 16:  # the kernels move words 8 or 16 bytes at a time
        v = v.clone()
    out = torch.empty_like(v)
    rows = v[0].numel() // n
    if rows:
        tabs = tables.kernel_tables(v.device)
        err = getattr(build.library(), entry)(
            v.data_ptr(), out.data_ptr(),
            tabs[table_idx].data_ptr(), tabs[table_idx + 1].data_ptr(),
            build.ptr(tables.prime_pack), kp, rows, tables.log_n, int(out_factor == 1),
            torch.cuda.current_stream(v.device).cuda_stream,
        )
        build.check(err, entry)
        wrapper.launches += 1
    return out if values.dtype == torch.int32 else widen_u32(out)


def forward32(tables: NttTables32, values: torch.Tensor, out_factor: int = 1):
    """Forward NTT of ``values (kp, ..., n)``: prime ``i``'s transform on
    ``values[i]``.  Input normal order in ``[0,4q)``; output bit-reversed,
    canonical for ``out_factor=1`` and lazy ``[0,4q)`` for ``4``.

    CPU tensors take the plain version (any ``log_n``), CUDA tensors the
    kernel, which takes ``log_n`` 1-14 (:data:`MAX_LOG_N`; a ``ValueError``
    above) and at most 4 primes (:class:`NttTables32` refuses more).
    """
    if out_factor not in (1, 4):
        raise ValueError("out_factor must be 1 or 4")
    check_range_u32(values, tables.primes, 4, "forward32 input")
    return _run(forward32, forward32_plain, "pft_ntt32_forward", 0, tables, values, out_factor)


def inverse32(tables: NttTables32, values: torch.Tensor, out_factor: int = 1):
    """Inverse NTT of ``values (kp, ..., n)``, bit-reversed input in
    ``[0,2q)``; output normal order, canonical for ``out_factor=1`` and
    lazy ``[0,2q)`` for ``2``.  The same devices and limits as
    :func:`forward32`."""
    if out_factor not in (1, 2):
        raise ValueError("out_factor must be 1 or 2")
    check_range_u32(values, tables.primes, 2, "inverse32 input")
    return _run(inverse32, inverse32_plain, "pft_ntt32_inverse", 2, tables, values, out_factor)


def launch_tile(tables: NttTables32, rows: int, forward: bool = True) -> int:
    """Rows of one prime a block of the kernel's launch on ``rows`` rows a
    prime, on the current CUDA device (the C entry's own pick)."""
    import ctypes

    tile = ctypes.c_int()
    err = build.library().pft_ntt32_tile(int(forward), len(tables.primes), rows, tables.log_n,
                                         ctypes.addressof(tile))
    build.check(err, "pft_ntt32_tile")
    return tile.value


forward32.launches = 0
inverse32.launches = 0
