"""Kernels ``ntt64_forward`` and ``ntt64_inverse``: the 64-bit negacyclic NTT
and its inverse (``q < 2^62``, ``n <= 2^15``), one launch for every modulus of
a DCRT plan.

Replace ``pallas_forward64`` and ``pallas_inverse64``
(``primus_fhe_tpu/ops/ntt_pallas.py:486,494``, kernels ``_make_fwd_kernel``
and ``_make_inv_kernel``).  CUDA source: ``csrc/ntt64.cu``.

Design on Hopper.  What bounds the transforms: at n = 4096 a row is 32 KB
in and 32 KB out against 2048 x 12 Shoup butterflies, so a batch of
hundreds of rows could be bound by device memory (256 rows, 16.8 MB: 5.0
us at 3.35 TB/s) and a batch of a few rows (the DCRT rotation's batch-1
step: 16 rows forward, 4 inverse) is bound by the chain of one row through
its stages on one SM; on the card that chain is issue-bound by the u64
Shoup butterflies (three 64 x 64-bit products each), ~3.2k cycles a
radix-8 pass of a row (``csrc/ntt64.cu`` gives the numbers).  The
kernels run kernels 1-2's design (:mod:`.ntt32`) on u64 words, from the
same pass templates (``csrc/ntt_passes.cuh``): each thread holds one
radix-8 group of 8 words in registers through 3 stages, so a transform is
``ceil(log n / 3)`` passes with a barrier after each (4 at n = 4096); the
forward's first pass reads its groups straight from device memory with its
7 roots in registers and its last pass (the remainder, 1-3 stages) stores
them straight back, 16 bytes an access, and the inverse mirrors it.  The
passes between live in shared memory at an index swizzled for 8-byte words,
on which every half-warp hits 16 distinct words mod 16.  The root tables
and their Shoup quotients are staged into shared memory once a block, under
the row loads and the first pass, where they fit beside a row (the
forward's whole table up to n = 2^13; the inverse's part after its first
pass up to 2^14), and a block takes a tile of rows of one modulus, so each
staged word serves the tile; the C entry picks the tile (``csrc/ntt64.cu``'s
``pick_tile``: the smallest that runs the grid in one wave).  A Shoup
multiply is three native 64-bit multiplies, so the TPU kernels' u32-pair
emulation, pre-split 16-bit limb tables and lane rolls are gone.  A row of
2^15 words (256 KB) does not fit in one block's shared memory; there two
blocks share a row (``csrc/ntt64.cu`` says how).

The kernels run the plain version's butterflies
(:func:`..transforms.ntt.forward64` / ``inverse64``) on the same pairs,
stage by stage, so they are bit-equal to it at every ``out_factor``; the
TPU forward defers its reductions and so agrees with them exactly only at
``out_factor=1`` (mod q otherwise).
"""

from __future__ import annotations

import numpy as np
import torch

from ..numeric.limb import u64_tensor
from ..transforms.ntt import forward64 as _plan_forward64
from ..transforms.ntt import inverse64 as _plan_inverse64
from ..transforms.plan import NttPlan64, _quot64, build_plan64
from ..utils.contracts import check_range_u64
from . import build

MAX_MODULI = 4  # PFT_MAX_MOD64 in csrc/modarith64.cuh
MAX_LOG_N = 15


def mod_pack64(plans: list[NttPlan64]) -> np.ndarray:
    """The host pack that the kernels unpack into ``Mod64``
    (``csrc/modarith64.cuh``): per modulus ``q, inv_n, inv_n_p, inv_n_w,
    inv_n_w_p, 2^32 mod q, its Shoup quotient, floor(2^64 / q)`` and the
    least multiple of ``q`` at or above 2^50."""
    rows = []
    for pl in plans:
        q = pl.q
        c32 = (1 << 32) % q
        rows.append([q, pl.inv_n, pl.inv_n_precon, pl.inv_n_w, pl.inv_n_w_precon, c32,
                     _quot64(c32, q), _quot64(1, q), -(-(1 << 50) // q) * q])
    return np.array(rows, dtype=np.uint64).reshape(-1)


class NttTables64:
    """Per-modulus u64 NTT plans of a modulus list and their kernel-side
    copies (``(count, n)`` root tables, u64 patterns in int64).  ``roots``:
    one explicit primitive ``2n``-th root per modulus (the counterpart of
    ``PallasNttPlan64(root=)``), the minimal ones by default."""

    def __init__(self, log_n: int, moduli, roots=None):
        if not 1 <= len(moduli) <= MAX_MODULI:
            raise ValueError(f"1 to {MAX_MODULI} moduli supported")
        self.log_n = log_n
        self.n = 1 << log_n
        self.moduli = tuple(int(q) for q in moduli)
        self.roots = tuple(roots) if roots is not None else (None,) * len(self.moduli)
        if len(self.roots) != len(self.moduli):
            raise ValueError("one root per modulus")
        self.plans = [build_plan64(log_n, q, root=r) for q, r in zip(self.moduli, self.roots)]
        self.mod_pack = mod_pack64(self.plans)
        self._plans_on = {torch.device("cpu"): self.plans}
        self._kernel_on: dict = {}

    def plans_on(self, device) -> list:
        device = torch.device(device)
        if device not in self._plans_on:
            self._plans_on[device] = [pl.to(device) for pl in self.plans]
        return self._plans_on[device]

    def kernel_tables(self, device):
        """``(roots, roots_precon, inv_roots, inv_roots_precon)``, each
        ``(count, n)`` on ``device``."""
        device = torch.device(device)
        if device not in self._kernel_on:
            self._kernel_on[device] = tuple(
                torch.stack([getattr(pl, name) for pl in self.plans]).to(device).contiguous()
                for name in ("roots", "roots_precon", "inv_roots", "inv_roots_precon")
            )
        return self._kernel_on[device]


def reduce_to_2q(values: torch.Tensor, moduli, in_factor: int) -> torch.Tensor:
    """The inverse kernel's input chain: from ``[0, in_factor*q)`` (a power
    of two at least 2) down to ``[0, 2q)`` by conditional subtractions of
    ``in_factor/2 * q``, ..., ``2q``; ``values`` is ``(count, ..., n)``."""
    from ..modular.modops import reduce_once64

    q = u64_tensor(list(moduli), values.device).reshape((-1,) + (1,) * (values.dim() - 1))
    f = in_factor >> 1
    while f >= 2:
        values = reduce_once64(values, f * q)
        f >>= 1
    return values


def ntt64_forward_plain(tables: NttTables64, values: torch.Tensor, out_factor: int = 1):
    """Plain version: per-modulus :func:`transforms.ntt.forward64` on
    ``values (count, ..., n)``."""
    plans = tables.plans_on(values.device)
    return torch.stack([_plan_forward64(pl, values[i], out_factor) for i, pl in enumerate(plans)])


def ntt64_inverse_plain(tables: NttTables64, values: torch.Tensor, out_factor: int = 1,
                        in_factor: int = 2):
    """Plain version: the input chain, then per-modulus
    :func:`transforms.ntt.inverse64`."""
    values = reduce_to_2q(values, tables.moduli, in_factor)
    plans = tables.plans_on(values.device)
    return torch.stack([_plan_inverse64(pl, values[i], out_factor) for i, pl in enumerate(plans)])


def _launch(wrapper, entry: str, table_idx: int, tables: NttTables64, values, out_factor,
            *extra):
    count, n = len(tables.moduli), tables.n
    if values.device.type != "cuda":
        raise ValueError(f"{wrapper.__name__}: unsupported device {values.device}")
    if values.dtype != torch.int64 or values.shape[0] != count or values.shape[-1] != n:
        raise ValueError(f"expected int64 (count={count}, ..., n={n}), got "
                         f"{values.dtype} {tuple(values.shape)}")
    if tables.log_n > MAX_LOG_N:
        raise ValueError(f"{wrapper.__name__}: the kernels take n <= 2^{MAX_LOG_N}")
    v = values.contiguous()
    out = torch.empty_like(v)
    rows = v[0].numel() // n
    if rows:
        tabs = tables.kernel_tables(v.device)
        err = getattr(build.library(), entry)(
            v.data_ptr(), out.data_ptr(), tabs[table_idx].data_ptr(),
            tabs[table_idx + 1].data_ptr(), build.ptr(tables.mod_pack), count, rows,
            tables.log_n, int(out_factor == 1), *extra,
            torch.cuda.current_stream(v.device).cuda_stream,
        )
        build.check(err, entry)
        wrapper.launches += 1
    return out


def ntt64_forward(tables: NttTables64, values: torch.Tensor, out_factor: int = 1):
    """Forward NTT of ``values (count, ..., n)`` (modulus ``i`` on
    ``values[i]``), u64 patterns in int64.  Input normal order in
    ``[0,4q)``; output bit-reversed, canonical for ``out_factor=1`` and lazy
    ``[0,4q)`` for ``4``.

    CPU tensors take the plain version (any ``log_n``), CUDA tensors the
    kernel, which takes ``log_n`` 1-15 (:data:`MAX_LOG_N`; a ``ValueError``
    above) and at most 4 moduli (:class:`NttTables64` refuses more).
    """
    if out_factor not in (1, 4):
        raise ValueError("out_factor must be 1 or 4")
    check_range_u64(values, tables.moduli, 4, "ntt64_forward input")
    if values.device.type == "cpu":
        return ntt64_forward_plain(tables, values, out_factor)
    return _launch(ntt64_forward, "pft_ntt64_forward", 0, tables, values, out_factor)


def ntt64_inverse(tables: NttTables64, values: torch.Tensor, out_factor: int = 1,
                  in_factor: int = 2):
    """Inverse NTT of ``values (count, ..., n)``, bit-reversed input in
    ``[0, in_factor*q)``, ``in_factor`` a power of two of at least 2 (a
    ``ValueError`` otherwise); output normal order, canonical for
    ``out_factor=1`` and lazy ``[0,2q)`` for ``2``.  The same devices and
    limits as :func:`ntt64_forward`: the kernel takes ``log_n`` 1-15 and at
    most 4 moduli."""
    if out_factor not in (1, 2):
        raise ValueError("out_factor must be 1 or 2")
    if in_factor < 2 or in_factor & (in_factor - 1):
        raise ValueError("in_factor must be a power of two, at least 2")
    check_range_u64(values, tables.moduli, in_factor, "ntt64_inverse input")
    if values.device.type == "cpu":
        return ntt64_inverse_plain(tables, values, out_factor, in_factor)
    return _launch(ntt64_inverse, "pft_ntt64_inverse", 2, tables, values, out_factor, in_factor)


def launch_tile(tables: NttTables64, rows: int, forward: bool = True) -> int:
    """Rows of one modulus a block of the kernel's launch on ``rows`` rows a
    modulus, on the current CUDA device (the C entry's own pick)."""
    return pick_tile(int(forward), tables, rows)


def pick_tile(kind: int, tables: NttTables64, rows: int) -> int:
    """The C entry's tile pick for kernel ``kind`` of ``csrc/ntt64.cu`` (1
    the forward, 0 the inverse, 2 kernel E) on ``rows`` rows a modulus."""
    import ctypes

    tile = ctypes.c_int()
    err = build.library().pft_ntt64_tile(kind, len(tables.moduli), rows, tables.log_n,
                                         ctypes.addressof(tile))
    build.check(err, "pft_ntt64_tile")
    return tile.value


ntt64_forward.launches = 0
ntt64_inverse.launches = 0
