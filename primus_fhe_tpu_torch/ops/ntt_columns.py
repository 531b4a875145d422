"""The four-step through device memory: rows past what a cluster holds on
chip (``log_n`` 18-26), on u32 and u64 words.  CUDA source:
``csrc/ntt_columns.cu`` (the templates in ``csrc/ntt_columns.cuh``).

A row of ``2^log_n`` words is ``2^c`` sub-rows of ``2^l`` (``c = log_n -
l``).  The forward's first ``c`` stages pair words of different sub-rows:
column ``j`` (the words ``j + k 2^l``) runs them as a transform of ``2^c``
words on the row's own root table, and :func:`columns_forward` does so on
tiles of columns read from and written to device memory.  Every later stage
pairs words of one sub-row, which the transform's own kernel then runs as a
"slice" of the row, one block a sub-row (kernels 1-2 in ``csrc/ntt32.cu``,
row 10, D and E in ``csrc/ntt64.cu``).  The inverse mirrors it: the sub-row
launch leaves lazy words, then :func:`columns_inverse` runs the last ``c``
stages, ``inv_n`` folded into the final one.  The transforms' C entries
past ``log_n`` 17 issue their column launches themselves, so each entry
stays a whole transform; their wrappers count those launches on
:func:`columns_forward` / :func:`columns_inverse` by
:func:`count_entry_columns`.  Kernels H and J split the same way around
:func:`mac_sub` (their MAC and each sub-row's inverse stages).

The column launches run the plain version's butterflies on the same pairs,
so the words are the plain version's (:func:`columns_forward_plain`,
:func:`columns_inverse_plain` are the stages' plain versions on their own).
"""

from __future__ import annotations

import numpy as np
import torch

from ..numeric.limb import mul_hi_u64, u64_tensor
from . import build

CLUSTER_LOG_N = 17  # the widest row on chip (CLUSTER_MAX_LOG_N in csrc/ntt_columns.cuh)
MAX_LOG_N = 26  # FOUR_STEP_MAX_LOG_N: columns of up to 2^12 words beside sub-rows of 2^14
SUB_LOG = 14  # kernels 1-2, row 10, D and E: a sub-row of 2^14 words a block
MAC_SUB_LOG = 13  # kernels H and J: a sub-row of 2^13 words a block


def four_step(log_n: int) -> bool:
    """Whether a row of ``2^log_n`` words runs the four-step on the card."""
    return log_n > CLUSTER_LOG_N


def check_ring(what: str, log_n: int) -> None:
    """Raises a ``ValueError`` naming the cap past :data:`MAX_LOG_N`."""
    if log_n > MAX_LOG_N:
        raise ValueError(f"{what}: the card takes log_n up to {MAX_LOG_N}, got {log_n}")


# ---------------------------------------------------------------------------
# Plain versions: stages s_lo .. s_hi - 1 of the plain transforms
# (transforms/ntt.py's formulas, stage by stage)


def _ops(bits: int):
    # at call time: transforms/ imports the kernels' wrappers, which import this module
    from ..modular.modops import reduce_once32, reduce_once64
    from ..transforms.ntt import _shoup_lazy32, _shoup_lazy64

    return (reduce_once32, _shoup_lazy32) if bits == 32 else (reduce_once64, _shoup_lazy64)


def forward_stages(plan, values: torch.Tensor, s_lo: int, s_hi: int, bits: int):
    """Stages ``s_lo .. s_hi - 1`` of the plain forward on ``values (...,
    n)`` (words below 4q in, lazy ``[0, 4q)`` out)."""
    red, shoup = _ops(bits)
    n, q = plan.n, plan.q
    batch = values.shape[:-1]
    v = values
    for s in range(s_lo, s_hi):
        m, t = 1 << s, n >> (s + 1)
        w = plan.roots[m:2 * m].reshape(m, 1)
        wp = plan.roots_precon[m:2 * m].reshape(m, 1)
        v = v.reshape(*batch, m, 2, t)
        tx = red(v[..., 0, :], 2 * q)
        ty = shoup(v[..., 1, :], w, wp, q)
        v = torch.stack([tx + ty, tx + 2 * q - ty], dim=-2)
    return v.reshape(*batch, n)


def inverse_stages(plan, values: torch.Tensor, s_lo: int, s_hi: int, bits: int,
                   out_factor: int = 2):
    """Stages ``s_lo .. s_hi - 1`` of the plain inverse on ``values (...,
    n)`` (lazy ``[0, 2q)`` in); where ``s_hi`` is ``log_n`` the final stage
    folds ``inv_n`` in (canonical for ``out_factor=1``)."""
    red, shoup = _ops(bits)
    n, q = plan.n, plan.q
    batch = values.shape[:-1]
    v = values
    for s in range(s_lo, min(s_hi, plan.log_n - 1)):
        t, m = 1 << s, n >> (s + 1)
        start = 1 + n - (n >> s)
        w = plan.inv_roots[start:start + m].reshape(m, 1)
        wp = plan.inv_roots_precon[start:start + m].reshape(m, 1)
        v = v.reshape(*batch, m, 2, t)
        x, y = v[..., 0, :], v[..., 1, :]
        v = torch.stack([red(x + y, 2 * q), shoup(x + 2 * q - y, w, wp, q)], dim=-2)
    v = v.reshape(*batch, n)
    if s_hi < plan.log_n:
        return v
    half = n >> 1
    x, y = v[..., :half], v[..., half:]
    out = torch.cat([shoup(red(x + y, 2 * q), plan.inv_n, plan.inv_n_precon, q),
                     shoup(x + 2 * q - y, plan.inv_n_w, plan.inv_n_w_precon, q)], dim=-1)
    return red(out, q) if out_factor == 1 else out


def reduce_lazy64(values: torch.Tensor, q: int) -> torch.Tensor:
    """Any u64 word to ``[0, 2q)`` by a lazy Shoup multiply by 1, the
    column launch's load at mode 1 (``AnyIn64`` in ``csrc/ntt_passes.cuh``)."""
    from ..transforms.plan import _quot64

    return values - q * mul_hi_u64(values, u64_tensor([_quot64(1, q)], values.device))


def columns_forward_plain(plans, values: torch.Tensor, l: int, bits: int,
                          any_in: bool = False) -> torch.Tensor:
    """Plain version of :func:`columns_forward`: the forward's first
    ``log_n - l`` stages, modulus ``i`` on ``values[i]`` (int64 words)."""
    out = []
    for i, pl in enumerate(plans):
        v = reduce_lazy64(values[i], pl.q) if any_in else values[i]
        out.append(forward_stages(pl, v, 0, pl.log_n - l, bits))
    return torch.stack(out)


def columns_inverse_plain(plans, values: torch.Tensor, l: int, bits: int,
                          out_factor: int = 1) -> torch.Tensor:
    """Plain version of :func:`columns_inverse`: the inverse's stages ``l ..
    log_n - 1``."""
    return torch.stack([inverse_stages(pl, values[i], l, pl.log_n, bits, out_factor)
                        for i, pl in enumerate(plans)])


# ---------------------------------------------------------------------------
# The launches


def _columns(wrapper, inverse: int, mode: int, bits: int, v: torch.Tensor, out: torch.Tensor,
             tw: torch.Tensor, twp: torch.Tensor, pack: int, count: int, rows: int, log_n: int,
             l: int) -> None:
    err = build.library().pft_ntt_columns(
        bits, inverse, mode, v.data_ptr(), out.data_ptr(), tw.data_ptr(), twp.data_ptr(), pack,
        count, rows, log_n, l, torch.cuda.current_stream(v.device).cuda_stream)
    build.check(err, wrapper.__name__)
    wrapper.launches += 1


def count_entry_columns() -> None:
    """Adds the column launches the transforms' C entries made since the
    last call (``pft_ntt_columns_taken``) to :func:`columns_forward`'s and
    :func:`columns_inverse`'s counts; a wrapper calls it after an entry past
    ``log_n`` 17."""
    lib = build.library()
    columns_forward.launches += lib.pft_ntt_columns_taken(0)
    columns_inverse.launches += lib.pft_ntt_columns_taken(1)


def columns_forward(bits: int, v, out, tw, twp, pack: int, count: int, rows: int, log_n: int,
                    l: int = SUB_LOG, any_in: bool = False) -> None:
    """The forward's column launch on CUDA tensors ``v`` -> ``out`` (may be
    ``v``): ``count`` moduli x ``rows`` rows of ``2^log_n`` words (int32
    storage at ``bits=32``, int64 at 64), their ``(count, n)`` root tables
    ``tw``, ``twp`` and the kernels' constant pack at host address ``pack``;
    words below 4q in (``any_in``: any u64 word), lazy ``[0, 4q)`` out."""
    _columns(columns_forward, 0, int(any_in), bits, v, out, tw, twp, pack, count, rows, log_n, l)


def columns_inverse(bits: int, v, out, tw, twp, pack: int, count: int, rows: int, log_n: int,
                    l: int = SUB_LOG, canonical: bool = True) -> None:
    """The inverse's column launch, the same shapes: lazy ``[0, 2q)`` words
    in, canonical (or lazy ``[0, 2q)``) words out."""
    _columns(columns_inverse, 1, 0 if canonical else 1, bits, v, out, tw, twp, pack, count, rows,
             log_n, l)


def mac_sub_pack(kp: int, k1: int, bsz: int, macs: int, log_n: int, strides, table_ptrs,
                 prime_pack) -> np.ndarray:
    """The host pack ``pft_mac_sub`` reads: ``kp, k1, bsz, macs, log_n``, the
    six word strides (``f_pi, f_b, fs, k_pi, k_j, ks``), the inverse table
    and quotients' device addresses, then ``NttTables32.prime_pack``."""
    return np.concatenate([np.array([kp, k1, bsz, macs, log_n, *strides, *table_ptrs],
                                    dtype=np.uint64), prime_pack])


def mac_sub(f: torch.Tensor, key: torch.Tensor, out: torch.Tensor, pack: np.ndarray) -> None:
    """Kernels H and J's first launch past ``log_n`` 17 on CUDA int32
    tensors: the MAC of every sub-row of 2^13 words and the inverse's stages
    within it, lazy ``[0, 2p)`` words into ``out (kp, bsz, k1, n)``; the
    shapes and strides are the pack's (:func:`mac_sub_pack`)."""
    err = build.library().pft_mac_sub(f.data_ptr(), key.data_ptr(), out.data_ptr(),
                                       pack.ctypes.data,
                                       torch.cuda.current_stream(f.device).cuda_stream)
    build.check(err, "mac_sub")
    mac_sub.launches += 1


def mac_sub_plain(plans, f_rows: torch.Tensor, key_rows: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`mac_sub` on int64 words: ``f_rows (kp, ...,
    M, n)`` lazy digits and ``key_rows`` of the same shape, canonical (each
    output row sums its ``M`` products) -> the inverse's stages ``0 .. 12``
    of each prime's sum, lazy, ``(kp, ..., n)``."""
    out = []
    for i, pl in enumerate(plans):
        q = pl.q
        mac = ((f_rows[i] % q) * key_rows[i] % q).sum(dim=-2) % q
        out.append(inverse_stages(pl, mac, 0, MAC_SUB_LOG, 32))
    return torch.stack(out)


columns_forward.launches = 0
columns_inverse.launches = 0
mac_sub.launches = 0
