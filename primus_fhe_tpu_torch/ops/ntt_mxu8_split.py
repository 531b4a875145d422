"""Row 13: the four half-transforms of the coefficient-sharded byte-radix NTT.

The byte-radix four-step (:mod:`.ntt_mxu8`) of ``n = A x 128`` words splits
into two locally dense passes: pass 1 contracts over the ``A`` axis of each
lane ``k0``, pass 2 over the 128 lanes of each row ``r0``.  Sharded over
coefficients, pass 1 runs on a shard's lanes and pass 2 on a shard's rows,
one ``all_to_all`` apart (:mod:`..parallel.coeff_sharded_mxu`).  The four
halves, each replacing one kernel of
``primus_fhe_tpu/parallel/coeff_sharded_mxu.py``:

- K1, :func:`split_k1` (``_k1_forward``, ``:131``): forward pass 1 and the
  twiddle on a shard's ``(A, L)`` lanes, ``L = (B/D) batch`` in ``(k0,
  batch)`` order;
- K2, :func:`split_k2` (``_k2_forward``, ``:184``): forward pass 2 on a
  shard's ``(rows, 128)`` rows, ``rows = (A/D) batch`` in ``(r0, batch)``
  order: canonical NTT values in the four-step's natural (bit-reversed)
  order;
- Ki1, :func:`split_ki1` (``_ki1_inverse``, ``:229``): inverse pass 1 and the
  twiddle on a shard's rows, with the lazy Shoup multiply by the shard's rows
  of a fixed NTT-domain operand at load as an option (the sharded kernel D);
- Ki2, :func:`split_ki2` (``_ki2_inverse``, ``:297``): inverse pass 2
  (``inv_n`` folded in) on a shard's lanes: canonical coefficients.

All four take a :class:`.ntt_mxu8.Mxu8Tables64` (every modulus in one launch,
``values (count, ...)``) and the shard's place: ``k0_off``, the first global
lane of a K1 shard, and ``r0_off``, the first global row of a Ki1 shard, so
the twiddles come from the ``(A, B)`` tables at global indices; the
reference's copies expanded over the batch, and its bias, correction and
Solinas tables, are TPU layouts the port does not need.

Lazy words (the rule for every byte-radix entry point, rows 9, 12 and 13):
an output at ``out_factor`` 1 is canonical and word-equal to the reference;
above it, congruent mod q and below ``out_factor * q``; an intermediate is
congruent mod q and below the bound stated here.  K1 and Ki1 end on the
Shoup twiddle and give words in ``[0, 2q)`` (the reference's pass-1 words lie
below 4q or 5q, from its TPU folds): congruent to their plain versions, which
are canonical.  K2 and Ki2 are canonical, word-equal to their plain versions,
and take any u64 word.

CPU tensors take the plain versions (exact modular matrix products on the
plan's pass matrices, :meth:`.ntt_mxu8.Mxu8Tables64.pass_matrices`), CUDA
tensors the kernels of ``csrc/ntt_mxu8_split.cu``, where their design and
bounds are stated.
"""

from __future__ import annotations

import torch

from ..modular.factor import ShoupFactor64, factor_mul64, factor_mul_lazy64
from ..modular.modops import add64
from ..numeric.limb import u64_tensor
from . import build
from .ntt_mxu8 import Mxu8Tables64

_CHUNK_WORDS = 1 << 25  # words of one chunk of a plain pass's products


def _moduli(tables: Mxu8Tables64, device, dims: int) -> torch.Tensor:
    return u64_tensor(list(tables.moduli), device).reshape((-1,) + (1,) * dims)


def _pass_plain(tables: Mxu8Tables64, name: str, x: torch.Tensor) -> torch.Tensor:
    """``out[i, r, j] = sum_k M_i[r, k] x[i, k, j] mod q_i`` for any u64 words
    ``x (count, K, lanes)`` and the pass matrix ``name``: canonical ``(count,
    R, lanes)``.  Each product is a Shoup multiply reduced to ``[0, q)``; up
    to ``2^63 / 2^bits(q)`` of them sum exactly in int64."""
    m = tables.pass_matrices(x.device)[name]
    count, rows_out, k_in = m.value.shape
    lanes = x.shape[-1]
    q = _moduli(tables, x.device, 2)
    bits = max(tables.moduli).bit_length()
    chunk = max(1, min(k_in, 1 << (63 - bits), _CHUNK_WORDS // max(1, rows_out * lanes)))
    acc = None
    for k0 in range(0, k_in, chunk):
        ks = slice(k0, k0 + chunk)
        f = ShoupFactor64(m.value[:, :, ks, None], m.quotient[:, :, ks, None])
        terms = factor_mul64(x[:, None, ks, :], f, q[..., None])  # (count, R, chunk, lanes)
        part = torch.remainder(terms.sum(dim=2), q)
        acc = part if acc is None else add64(acc, part, q)
    return acc


def _twiddle_plain(tables, name, y, rows, cols):
    """``y * tw[rows][:, cols] mod q`` canonical, ``tw`` the ``(count, A, B)``
    twiddles ``name``; ``rows``/``cols`` index tensors or slices."""
    t = tables.pass_matrices(y.device)[name]
    f = ShoupFactor64(t.value[:, rows][:, :, cols], t.quotient[:, rows][:, :, cols])
    return factor_mul64(y, f, _moduli(tables, y.device, 2))


def split_k1_plain(tables: Mxu8Tables64, values, batch: int, k0_off: int):
    """Plain K1: ``m1`` over the A axis, times ``tw[r0][k0_off + lane //
    batch]``; canonical."""
    lanes = values.shape[-1]
    k0 = k0_off + torch.arange(lanes, device=values.device) // batch
    return _twiddle_plain(tables, "tw", _pass_plain(tables, "m1", values), slice(None), k0)


def split_k2_plain(tables: Mxu8Tables64, values):
    """Plain K2: ``m2`` over each row's 128 words; canonical."""
    return _pass_plain(tables, "m2", values.transpose(1, 2)).transpose(1, 2).contiguous()


def _key_rows(tables, values, batch, mul_rows):
    """``values (count, rows, B)`` times the shard's key rows ``(count, 2,
    (rows / batch) * B)``, row ``r`` by key row ``r // batch`` (lazy Shoup:
    ``[0, 2q)``)."""
    count, rows, b = values.shape
    r0 = torch.arange(rows, device=values.device) // batch
    kv = mul_rows[:, 0].reshape(count, -1, b)[:, r0]
    kq = mul_rows[:, 1].reshape(count, -1, b)[:, r0]
    return factor_mul_lazy64(values, ShoupFactor64(kv, kq), _moduli(tables, values.device, 2))


def split_ki1_plain(tables: Mxu8Tables64, values, batch: int, r0_off: int, mul_rows=None):
    """Plain Ki1: the key rows' lazy multiply (if given), ``m2i`` over each
    row's 128 words, times ``twi[r0_off + row // batch][k0]``; canonical."""
    if mul_rows is not None:
        values = _key_rows(tables, values, batch, mul_rows)
    y = _pass_plain(tables, "m2i", values.transpose(1, 2)).transpose(1, 2)
    r0 = r0_off + torch.arange(values.shape[1], device=values.device) // batch
    return _twiddle_plain(tables, "twi", y, r0, slice(None)).contiguous()


def split_ki2_plain(tables: Mxu8Tables64, values):
    """Plain Ki2: ``m1i`` (``inv_n`` folded in) over the A axis; canonical."""
    return _pass_plain(tables, "m1i", values)


def _check(wrapper, tables, values, dims, mul_rows=None):
    count = len(tables.moduli)
    if values.dtype != torch.int64 or values.shape[0] != count or values.dim() != 3 or any(
            want is not None and got != want for got, want in zip(values.shape[1:], dims)):
        raise ValueError(f"{wrapper.__name__}: expected int64 (count={count}, {dims[0]}, "
                         f"{dims[1]}), got {values.dtype} {tuple(values.shape)}")
    if mul_rows is not None and (mul_rows.device != values.device or mul_rows.dtype != torch.int64
                                 or not mul_rows.is_contiguous()):
        raise ValueError(f"{wrapper.__name__}: the key rows must be a contiguous int64 tensor "
                         f"on {values.device}")


def _launch(wrapper, entry, tables, values, wname, extra_ptrs, ints):
    """Runs C entry ``entry`` on the CUDA tensor ``values``: ``(in, out, w,
    tw, *extra_ptrs, mod_pack, count, *ints, log_n, planes, stream)``."""
    if values.device.type != "cuda":
        raise ValueError(f"{wrapper.__name__}: unsupported device {values.device}")
    if not 8 <= tables.log_n <= 12:
        raise ValueError(f"{wrapper.__name__}: the kernels take 8 <= log_n <= 12")
    v = values.contiguous()
    out = torch.empty_like(v)
    if v.numel():
        tabs = tables.kernel_tables(v.device)
        err = getattr(build.library(), entry)(
            v.data_ptr(), out.data_ptr(), tabs[wname].data_ptr(), tabs["tw"].data_ptr(),
            *extra_ptrs, build.ptr(tables.ntt.mod_pack), len(tables.moduli), *ints,
            tables.log_n, tables.planes, torch.cuda.current_stream(v.device).cuda_stream)
        build.check(err, entry)
        wrapper.launches += 1
    return out


def _check_lanes(tables, lanes, batch, k0_off):
    if batch < 1 or lanes % batch or k0_off < 0 or k0_off + lanes // batch > tables.B:
        raise ValueError(f"{lanes} lanes of batch {batch} from k0 = {k0_off} do not fit "
                         f"B = {tables.B}")


def _check_rows(tables, rows, batch, r0_off):
    if batch < 1 or rows % batch or r0_off < 0 or r0_off + rows // batch > tables.A:
        raise ValueError(f"{rows} rows of batch {batch} from r0 = {r0_off} do not fit "
                         f"A = {tables.A}")


def split_k1(tables: Mxu8Tables64, values: torch.Tensor, batch: int, k0_off: int = 0):
    """K1: forward pass 1 and the twiddle on ``values (count, A, L)`` (any u64
    words; lane ``j`` is global lane ``k0_off + j // batch``) -> lazy words
    ``(count, A, L)`` in ``[0, 2q)``, congruent to :func:`split_k1_plain`."""
    _check(split_k1, tables, values, (tables.A, None))
    _check_lanes(tables, values.shape[2], batch, k0_off)
    if values.device.type == "cpu":
        return split_k1_plain(tables, values, batch, k0_off)
    return _launch(split_k1, "pft_ntt_mxu8_split_k1", tables, values, "w1", (),
                   (values.shape[2], batch, k0_off))


def split_k2(tables: Mxu8Tables64, values: torch.Tensor):
    """K2: forward pass 2 on ``values (count, rows, 128)`` (any u64 words) ->
    canonical ``(count, rows, 128)``, each row's NTT values in the natural
    order."""
    _check(split_k2, tables, values, (None, tables.B))
    if values.device.type == "cpu":
        return split_k2_plain(tables, values)
    return _launch(split_k2, "pft_ntt_mxu8_split_k2", tables, values, "w2", (),
                   (values.shape[1],))


def split_ki1(tables: Mxu8Tables64, values: torch.Tensor, batch: int, r0_off: int = 0,
              mul_rows: torch.Tensor | None = None):
    """Ki1: inverse pass 1 and the twiddle on ``values (count, rows, 128)``
    (any u64 words; row ``r`` is global row ``r0_off + r // batch``), after a
    lazy Shoup multiply by ``mul_rows`` (the shard's rows of a
    :meth:`.ntt_mxu8.Mxu8Tables64.mul_table`, ``(count, 2, (rows / batch) *
    128)``) if given -> lazy words ``(count, rows, 128)`` in ``[0, 2q)``,
    congruent to :func:`split_ki1_plain`."""
    _check(split_ki1, tables, values, (None, tables.B), mul_rows)
    _check_rows(tables, values.shape[1], batch, r0_off)
    if mul_rows is not None and mul_rows.shape != (
            len(tables.moduli), 2, values.shape[1] // batch * tables.B):
        raise ValueError(f"split_ki1: key rows {tuple(mul_rows.shape)} do not match the shard")
    if values.device.type == "cpu":
        return split_ki1_plain(tables, values, batch, r0_off, mul_rows)
    key = () if mul_rows is None else (mul_rows.data_ptr(),)
    return _launch(split_ki1, "pft_ntt_mxu8_split_ki1", tables, values, "wi1", key or (None,),
                   (values.shape[1], batch, r0_off))


def split_ki2(tables: Mxu8Tables64, values: torch.Tensor):
    """Ki2: inverse pass 2 on ``values (count, A, L)`` (any u64 words) ->
    canonical coefficients ``(count, A, L)``."""
    _check(split_ki2, tables, values, (tables.A, None))
    if values.device.type == "cpu":
        return split_ki2_plain(tables, values)
    return _launch(split_ki2, "pft_ntt_mxu8_split_ki2", tables, values, "wi2", (),
                   (values.shape[2],))


split_k1.launches = 0
split_k2.launches = 0
split_ki1.launches = 0
split_ki2.launches = 0
