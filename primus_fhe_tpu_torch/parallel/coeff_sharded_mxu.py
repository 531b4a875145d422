"""Coefficient-sharded byte-radix NTT: the four-step split around ONE
``all_to_all`` (port of ``primus_fhe_tpu/parallel/coeff_sharded_mxu.py``).

The four-step's pass 1 contracts over the ``A`` axis of each lane ``k0``,
pass 2 over the ``B = 128`` lanes of each row ``r0``.  So the forward runs
pass 1 on each shard's lanes (K1), exchanges rows for lanes in one tiled
``all_to_all`` (:meth:`..parallel.mesh.LocalMesh.all_to_all`), and runs
pass 2 on each shard's rows (K2); the inverse mirrors it (Ki1, transpose,
``all_to_all``, Ki2).  The halves are row 13's kernels
(:mod:`..ops.ntt_mxu8_split`), on the tables of the single-card transform
(:class:`..ops.ntt_mxu8.Mxu8Tables64`): the sharded transforms give the
words of ``mxu8_forward64`` and ``mxu8_inverse64``/``mxu8_inverse64_mul``.

Layouts (one modulus q < 2^62; u64 words as int64 bit patterns; each
function takes and returns the list of this process's shard tensors, one
per held shard of ``mesh.shards``):

- coefficient domain ``(A, B, batch)``, coefficient ``i`` of polynomial
  ``b`` at ``[i // B, i % B, b]``, sharded over ``B``: a shard holds ``(A,
  B/D, batch)``;
- NTT domain ``(A, batch, B)``, NTT index ``j`` at ``[j // B, b, j % B]``
  (the natural, bit-reversed order), sharded over ``A``: a shard holds
  ``(A/D, batch, B)``.

``D``, the size of the mesh axis, must divide ``A = n / 128`` and ``B``.
A u64 word travels as one int64: one exchange where the reference sends the
``lo`` and ``hi`` halves in two, with the same bytes.

Outputs are canonical at every ``out_factor`` (the rule for lazy words is
stated in :mod:`..ops.ntt_mxu8_split`).
"""

from __future__ import annotations

import functools

import torch

from ..ops.ntt64 import NttTables64
from ..ops.ntt_mxu8 import Mxu8Tables64
from ..ops.ntt_mxu8_split import split_k1, split_k2, split_ki1, split_ki2


class ShardedMxuPlan64:
    """The byte-radix tables of one modulus ``q`` at ``log_n`` (``A = n /
    128`` rows by ``B = 128`` lanes) and the shards' offsets into them.

    ``tables`` is the single-card :class:`..ops.ntt_mxu8.Mxu8Tables64`; a
    shard of ``d`` reads its twiddles at its global lane ``k0`` or row
    ``r0`` (:meth:`offsets`), where the reference expands them over the
    batch."""

    def __init__(self, log_n: int, q: int):
        self.log_n, self.q = log_n, int(q)
        self.tables = Mxu8Tables64(NttTables64(log_n, [self.q]))
        self.A, self.B, self.planes = self.tables.A, self.tables.B, self.tables.planes

    def offsets(self, d: int, index: int) -> tuple[int, int]:
        """Shard ``index`` of ``d``: its first global lane ``k0`` and row
        ``r0``."""
        if self.A % d or self.B % d:
            raise ValueError(f"A={self.A}, B={self.B} must both divide by d={d}")
        return index * (self.B // d), index * (self.A // d)


@functools.lru_cache(maxsize=None)
def get_sharded_plan(log_n: int, q: int) -> ShardedMxuPlan64:
    return ShardedMxuPlan64(log_n, q)


# ---------------------------------------------------------------------------
# Layout converters ((batch, n) full tensors)
# ---------------------------------------------------------------------------


def to_coeff_layout(values: torch.Tensor, A: int, B: int) -> torch.Tensor:
    """``(batch, n)`` -> the coefficient layout ``(A, B, batch)``."""
    return values.reshape(-1, A, B).permute(1, 2, 0).contiguous()


def from_coeff_layout(values: torch.Tensor) -> torch.Tensor:
    """``(A, B, batch)`` -> ``(batch, n)``."""
    A, B, b = values.shape
    return values.permute(2, 0, 1).reshape(b, A * B)


def ntt_layout_from_flat(values: torch.Tensor, A: int, B: int) -> torch.Tensor:
    """``(batch, n)`` natural NTT order -> the NTT layout ``(A, batch, B)``."""
    return values.reshape(-1, A, B).permute(1, 0, 2).contiguous()


def ntt_layout_to_flat(values: torch.Tensor) -> torch.Tensor:
    """``(A, batch, B)`` -> ``(batch, n)`` natural NTT order."""
    A, b, B = values.shape
    return values.permute(1, 0, 2).reshape(b, A * B)


# ---------------------------------------------------------------------------
# The sharded transforms
# ---------------------------------------------------------------------------


def _check_factor(out_factor, allowed):
    if out_factor not in allowed:
        raise ValueError(f"out_factor must be one of {allowed}")


def sharded_mxu_forward64(mesh, axis: str, log_n: int, q: int, values, out_factor: int = 1):
    """Forward NTT: coefficient-layout shards ``(A, B/D, batch)`` -> NTT-layout
    shards ``(A/D, batch, B)``, canonical.  K1 on each shard's lanes, one
    ``all_to_all`` (rows for lanes), K2 on each shard's rows."""
    _check_factor(out_factor, (1, 2, 4))
    plan = get_sharded_plan(log_n, q)
    A, B, d = plan.A, plan.B, mesh.axis_size(axis)
    tabs = plan.tables
    pass1 = []
    for x, s in zip(values, mesh.shards):
        k0_off, _ = plan.offsets(d, mesh.axis_index(s, axis))
        bl, batch = x.shape[1], x.shape[2]
        pass1.append(split_k1(tabs, x.reshape(1, A, bl * batch), batch, k0_off)
                     .reshape(A, bl, batch))
    rows = mesh.all_to_all(pass1, axis, 0, 1)  # (A/D, B, batch)
    out = []
    for y in rows:
        al, _, batch = y.shape
        y = y.transpose(1, 2).reshape(1, al * batch, B)  # rows (r0, batch) of B words
        out.append(split_k2(tabs, y).reshape(al, batch, B))
    return out


def sharded_mxu_inverse64(mesh, axis: str, log_n: int, q: int, values, out_factor: int = 1,
                          mul_tab: torch.Tensor | None = None):
    """Inverse NTT: NTT-layout shards ``(A/D, batch, B)`` -> coefficient-layout
    shards ``(A, B/D, batch)``, canonical.  ``mul_tab``, a
    :meth:`..ops.ntt_mxu8.Mxu8Tables64.mul_table` ``(1, 2, n)`` of a fixed
    NTT-domain operand on ``mesh.device``, fuses its pointwise multiply into
    Ki1 (each shard takes its ``A/D`` rows): the sharded counterpart of
    ``mxu8_inverse64_mul``."""
    _check_factor(out_factor, (1, 2))
    plan = get_sharded_plan(log_n, q)
    A, B, d = plan.A, plan.B, mesh.axis_size(axis)
    tabs = plan.tables
    pass1 = []
    for x, s in zip(values, mesh.shards):
        _, r0_off = plan.offsets(d, mesh.axis_index(s, axis))
        al, batch, _ = x.shape
        key = None
        if mul_tab is not None:
            key = mul_tab.reshape(1, 2, A, B)[:, :, r0_off:r0_off + al].reshape(1, 2, al * B)
            key = key.contiguous()
        y = split_ki1(tabs, x.reshape(1, al * batch, B), batch, r0_off, key)
        pass1.append(y.reshape(al, batch, B).transpose(1, 2))  # (A/D, B, batch)
    lanes = mesh.all_to_all(pass1, axis, 1, 0)  # (A, B/D, batch)
    out = []
    for z in lanes:
        _, bl, batch = z.shape
        out.append(split_ki2(tabs, z.reshape(1, A, bl * batch)).reshape(A, bl, batch))
    return out
