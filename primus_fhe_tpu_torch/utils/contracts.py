"""Opt-in lazy-range contract checks at transform entry points (port of
``primus_fhe_tpu/utils/contracts.py``).

The reference enforces its lazy-range invariants with ``debug_assert!``
(e.g. ``crates/primus_ntt/src/ntt/prime64/avx512/internal.rs:61-73``), which
release builds compile away.  Here each checked entry point calls
:func:`check_range_u32` or :func:`check_range_u64` on its input before it
launches anything.  Unless the process runs with ``PRIMUS_DEBUG=1`` a check
is one environment lookup: no device sync, no launch.  With the flag on it
reads the input's maximum (a device sync on the card) and raises
:class:`RangeContractError` before the kernel is launched, instead of
letting an out-of-contract caller get wrong words.
"""

from __future__ import annotations

import os

import torch

from ..numeric.limb import SIGN64, widen_u32


class RangeContractError(AssertionError):
    """A lazy-range invariant ([0, c*q)) was violated at a kernel boundary."""


def enabled() -> bool:
    return os.environ.get("PRIMUS_DEBUG") == "1"


def _fail(what: str, mx: int, bound: int):
    raise RangeContractError(
        f"{what}: max value {mx} breaks the [0, {bound}) range contract "
        f"(set by the lazy-reduction design)"
    )


def _rows(values: torch.Tensor, q):
    """``(rows, modulus)`` pairs: the whole tensor against one ``q``, or row
    ``i`` of the leading axis against ``q[i]`` for a sequence of moduli."""
    if isinstance(q, (list, tuple)):
        return [(values[i], int(qi)) for i, qi in enumerate(q)]
    return [(values, int(q))]


def check_range_u32(values: torch.Tensor, q, factor: int, what: str) -> None:
    """Every u32 word (int64, or int32 storage) below ``factor * q`` (debug
    only).  ``q``: an int, or one int a row of the leading axis."""
    if not enabled():
        return
    for rows, qi in _rows(values, q):
        if rows.numel():
            mx = int(widen_u32(rows).max())
            if mx >= factor * qi:
                _fail(what, mx, factor * qi)


def check_range_u64(values: torch.Tensor, q, factor: int, what: str) -> None:
    """Every u64 word (int64 patterns) below ``factor * q`` (debug only),
    compared unsigned; ``q`` as in :func:`check_range_u32`."""
    if not enabled():
        return
    for rows, qi in _rows(values, q):
        if rows.numel():
            mx = int((rows ^ SIGN64).max()) + (1 << 63)
            if mx >= factor * qi:
                _fail(what, mx, factor * qi)
