"""Coefficient-sharded NTT: butterfly exchanges over a mesh axis (port of
``primus_fhe_tpu/parallel/coeff_sharded.py``).

With the coefficient axis split over the ``d`` devices of ``axis``, a stage
whose half-block ``t`` is at least the shard width pairs words at the same
local offset on devices ``i`` and ``i ^ (t / width)``: one XOR-partner swap
(:meth:`..parallel.mesh.LocalMesh.ppermute`) and a butterfly on each side.
The forward runs its ``log2 d`` exchange stages first, then the shard-local
stages, which are a width-``width`` forward over the shard's slice of the
expanded per-lane tables: one launch of :func:`..ops.ntt_stages.ntt32_stages_forward`
(or ``ntt64_``) per shard.  The inverse mirrors it: shard-local stages
first (``ntt*_stages_inverse``), then the exchange stages, the last fusing
``inv_n`` / ``inv_n w`` as the single-device transform does, so every output
equals the single-device transform's.

The JAX function's ``local_impl`` becomes the device rule of the stage
wrappers: the kernel for CUDA tensors, the plain version on the CPU.
``values`` is the list of this process's shard tensors ``(..., n/d)``, one per
held shard (``mesh.shards``), u32 words or u64 bit patterns in int64; the
result is such a list too.  Tables are ``(w, w_precon)`` pairs of ``(log_n,
n)`` int64 tensors; each shard takes its columns.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..golden.model import GoldenNtt
from ..modular.modops import reduce_once64
from ..numeric.limb import MASK32, mul_hi_u64, mulhi_u32, u64_tensor
from ..ops.ntt_stages import (
    ntt32_stages_forward,
    ntt32_stages_inverse,
    ntt64_stages_forward,
    ntt64_stages_inverse,
)

# ---------------------------------------------------------------------------
# Expanded per-lane tables (the stage kernels' layout)
# ---------------------------------------------------------------------------


def _expanded(log_n: int, q: int, bits: int, inverse: bool):
    g = GoldenNtt(log_n, q)
    n = 1 << log_n
    mask = (1 << bits) - 1
    roots = g.inv_roots if inverse else g.roots
    lane = np.arange(n)
    idx = np.zeros((log_n, n), dtype=np.int64)
    for s in range(log_n - 1 if inverse else log_n):
        if inverse:  # block j of stage s uses inv_roots[1 + n - (n >> s) + j]
            idx[s] = 1 + n - (n >> s) + lane // (2 << s)
        else:  # forward stage s: roots[2^s + p // (2t)], t = n >> (s + 1)
            idx[s] = (1 << s) + lane // (2 * (n >> (s + 1)))
    w = np.array([int(r) for r in roots], dtype=np.uint64)[idx]
    quot = np.array([((int(r) << bits) // q) & mask for r in roots], dtype=np.uint64)[idx]
    if inverse:  # the fused final stage: inv_n on the x half, inv_n * w on the y half
        for half, value in ((slice(0, n // 2), g.inv_n), (slice(n // 2, n), g.inv_n_w)):
            w[log_n - 1, half] = value
            quot[log_n - 1, half] = ((value << bits) // q) & mask
    return u64_tensor(w), u64_tensor(quot)


def build_expanded_tables32(log_n: int, q: int):
    """Per-lane forward tables ``(log_n, n)`` (u32 words, int64)."""
    return _expanded(log_n, q, 32, False)


def build_expanded_inverse_tables32(log_n: int, q: int):
    """Per-lane inverse tables ``(log_n, n)``; the final row holds ``inv_n``
    on the x half and ``inv_n * w`` on the y half."""
    return _expanded(log_n, q, 32, True)


def build_expanded_tables64(log_n: int, q: int):
    """Per-lane forward tables ``(log_n, n)`` (u64 patterns, int64)."""
    return _expanded(log_n, q, 64, False)


def build_expanded_inverse_tables64(log_n: int, q: int):
    """Per-lane inverse tables ``(log_n, n)`` (u64 patterns, int64)."""
    return _expanded(log_n, q, 64, True)


_BUILD = {"f32": build_expanded_tables32, "i32": build_expanded_inverse_tables32,
          "f64": build_expanded_tables64, "i64": build_expanded_inverse_tables64}


@functools.lru_cache(maxsize=None)
def _default_columns(kind: str, log_n: int, q: int, width: int, index: int, device):
    full = _default_tables(kind, log_n, q)
    return tuple(t[:, index * width:(index + 1) * width].to(device).contiguous() for t in full)


@functools.lru_cache(maxsize=None)
def _default_tables(kind: str, log_n: int, q: int):
    return _BUILD[kind](log_n, q)


def _shard_tables(mesh, axis, kind, log_n, q, tables, width):
    """Each held shard's ``(w, w_precon)`` columns on ``mesh.device`` (of
    ``tables``, or of the default tables, kept once per shard)."""
    out = []
    for s in mesh.shards:
        i = mesh.axis_index(s, axis)
        if tables is None:
            out.append(_default_columns(kind, log_n, q, width, i, mesh.device))
        else:
            out.append(tuple(t[:, i * width:(i + 1) * width].to(mesh.device).contiguous()
                             for t in tables))
    return out


def _geometry(mesh, axis, log_n):
    n = 1 << log_n
    d = mesh.axis_size(axis)
    width = n // d
    if width * d != n or d & (d - 1):
        raise ValueError(f"the axis size {d} must be a power of two dividing n = {n}")
    return n, d, width, d.bit_length() - 1


def _exchange(mesh, axis, v, delta, d, step):
    """One exchange stage: swap with the XOR partner at ``delta`` device steps
    and apply ``step(x, y, is_x, k)`` on every held shard ``k``."""
    partner = mesh.ppermute(v, axis, [(i ^ delta, i) for i in range(d)])
    out = []
    for k, s in enumerate(mesh.shards):
        is_x = (mesh.axis_index(s, axis) & delta) == 0
        x, y = (v[k], partner[k]) if is_x else (partner[k], v[k])
        out.append(step(x, y, is_x, k))
    return out


# ---------------------------------------------------------------------------
# u32 (q < 2^30)
# ---------------------------------------------------------------------------


def _shoup32(y, w, wp, q):
    return (w * y - q * mulhi_u32(y, wp)) & MASK32


def coeff_sharded_forward32(mesh, axis: str, log_n: int, q: int, values, tables=None):
    """Forward NTT of the shards ``values`` (normal order, ``[0, 4q)``) with
    the coefficient axis over ``mesh[axis]``: bit-reversed canonical output,
    sharded the same way."""
    n, d, width, log_d = _geometry(mesh, axis, log_n)
    tabs = _shard_tables(mesh, axis, "f32", log_n, q, tables, width)
    two_q = 2 * q
    v = list(values)
    for s in range(log_d):
        def step(x, y, is_x, k, s=s):
            tx = torch.where(x >= two_q, x - two_q, x)
            mm = _shoup32(y, tabs[k][0][s], tabs[k][1][s], q)
            return tx + mm if is_x else tx + two_q - mm

        v = _exchange(mesh, axis, v, (n >> (s + 1)) // width, d, step)
    if log_d < log_n:
        return [ntt32_stages_forward(log_n - log_d, q, w[log_d:], p[log_d:], x)
                for x, (w, p) in zip(v, tabs)]
    v = [torch.where(x >= two_q, x - two_q, x) for x in v]
    return [torch.where(x >= q, x - q, x) for x in v]


def coeff_sharded_inverse32(mesh, axis: str, log_n: int, q: int, values, tables=None):
    """Inverse NTT of the shards ``values`` (bit-reversed, ``[0, 2q)``),
    canonical normal-order output; equal to ``transforms.ntt.inverse32``.
    Needs ``d >= 2`` (the last stage is an exchange)."""
    n, d, width, log_d = _geometry(mesh, axis, log_n)
    if d < 2:
        raise ValueError("the coefficient-sharded inverse needs at least 2 shards")
    log_w = log_n - log_d
    tabs = _shard_tables(mesh, axis, "i32", log_n, q, tables, width)
    two_q = 2 * q
    v = list(values)
    if log_w > 0:
        v = [ntt32_stages_inverse(log_w, q, w[:log_w], p[:log_w], x) for x, (w, p) in zip(v, tabs)]
    for s in range(log_w, log_n):
        def step(x, y, is_x, k, s=s):
            w, p = tabs[k][0][s], tabs[k][1][s]
            sxy = x + y
            tx = torch.where(sxy >= two_q, sxy - two_q, sxy)
            dd = x + two_q - y
            if s == log_n - 1:  # fused final stage: inv_n (x half), inv_n * w (y half)
                return _shoup32(tx if is_x else dd, w, p, q)
            return tx if is_x else _shoup32(dd, w, p, q)

        v = _exchange(mesh, axis, v, (1 << s) // width, d, step)
    return [torch.where(x >= q, x - q, x) for x in v]


# ---------------------------------------------------------------------------
# u64 (q < 2^62)
# ---------------------------------------------------------------------------


def _shoup64(y, w, wp, q):
    return w * y - q * mul_hi_u64(y, wp)


def coeff_sharded_forward64(mesh, axis: str, log_n: int, q: int, values, tables=None):
    """u64 forward NTT with the coefficient axis over ``mesh[axis]``
    (``values``: shards of u64 patterns in ``[0, 4q)``); canonical
    bit-reversed output, equal to the single-device transform."""
    n, d, width, log_d = _geometry(mesh, axis, log_n)
    tabs = _shard_tables(mesh, axis, "f64", log_n, q, tables, width)
    two_q = 2 * q
    v = list(values)
    for s in range(log_d):
        def step(x, y, is_x, k, s=s):
            tx = reduce_once64(x, two_q)
            mm = _shoup64(y, tabs[k][0][s], tabs[k][1][s], q)
            return tx + mm if is_x else tx + two_q - mm

        v = _exchange(mesh, axis, v, (n >> (s + 1)) // width, d, step)
    if log_d < log_n:
        return [ntt64_stages_forward(log_n - log_d, q, w[log_d:], p[log_d:], x)
                for x, (w, p) in zip(v, tabs)]
    return [reduce_once64(reduce_once64(x, two_q), q) for x in v]


def coeff_sharded_inverse64(mesh, axis: str, log_n: int, q: int, values, tables=None):
    """u64 inverse NTT (bit-reversed input in ``[0, 2q)``, canonical
    normal-order output), coefficient axis sharded; ``d >= 2``."""
    n, d, width, log_d = _geometry(mesh, axis, log_n)
    if d < 2:
        raise ValueError("the coefficient-sharded inverse needs at least 2 shards")
    log_w = log_n - log_d
    tabs = _shard_tables(mesh, axis, "i64", log_n, q, tables, width)
    two_q = 2 * q
    v = list(values)
    if log_w > 0:
        v = [ntt64_stages_inverse(log_w, q, w[:log_w], p[:log_w], x) for x, (w, p) in zip(v, tabs)]
    for s in range(log_w, log_n):
        def step(x, y, is_x, k, s=s):
            w, p = tabs[k][0][s], tabs[k][1][s]
            tx = reduce_once64(x + y, two_q)
            dd = x + two_q - y
            if s == log_n - 1:
                return _shoup64(tx if is_x else dd, w, p, q)
            return tx if is_x else _shoup64(dd, w, p, q)

        v = _exchange(mesh, axis, v, (1 << s) // width, d, step)
    return [reduce_once64(x, q) for x in v]
