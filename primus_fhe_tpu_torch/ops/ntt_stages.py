"""Row 11: the shard-local butterfly stages of the coefficient-sharded NTT
(:mod:`..parallel.coeff_sharded`), as four kernels.

- ``ntt32_stages_forward``: the final ``log_w`` forward stages over rows of
  width ``2^log_w``, u32 words (``q < 2^30``), input in ``[0, 4q)``,
  canonical output for ``out_factor=1``, lazy ``[0, 4q)`` otherwise;
- ``ntt32_stages_inverse``: the first ``log_w`` regular inverse stages,
  input and output lazy in ``[0, 2q)``;
- ``ntt64_stages_forward`` / ``ntt64_stages_inverse``: the same over u64
  words (``q < 2^62``), with ``out_factor`` 1, 2 or 4 and the inverse's
  ``in_factor`` and range-doubling chain.

Replace ``pallas_stages_forward32``/``pallas_stages_inverse32``/
``pallas_stages_forward64``/``pallas_stages_inverse64``
(``primus_fhe_tpu/ops/ntt_pallas.py:620,629,675,683``).  CUDA source:
``csrc/ntt_stages.cu``, which states the design and what bounds it: one
machinery for both word types spreads a row over a thread-block cluster of
up to 8 blocks (each holding a slice of the row, the stages across slices
through distributed shared memory) and runs the stages within a slice as
radix-8 register passes on the per-lane tables, each entry read once a
tile of rows; the launch picks the cluster size and the rows a block
(:func:`launch_grid`).  The u32 forward's butterflies read both lanes'
entries (the TPU's select form), the u32 inverse's the y lane's, the u64
pair's the x lane's.  On the card all four take ``log_w <= 17``.

The twiddles are per-lane tables ``(log_w, 2^log_w)``, a shard's slice of
:func:`..parallel.coeff_sharded.build_expanded_tables32` (or ``64``); stage
``s`` reads entry ``[s, lane]``.  Each plain version repeats the TPU
kernel's schedule stage by stage, so lazy outputs are bit-equal to it too
(the u64 kernels defer reductions and take an approximate Shoup quotient,
see :func:`shoup_approx64`); the exchange stages consume those lazy words.

Values and tables are int64 tensors: u32 words in ``[0, 2^32)`` (int32
storage is also taken for the u32 values and kept), u64 bit patterns for
the u64 kernels.  CPU tensors take the plain version, CUDA tensors the
kernel.
"""

from __future__ import annotations

import torch

from ..modular.modops import reduce_once64
from ..numeric.limb import MASK32, mul_hi_u64, mulhi_u32, narrow_u32, widen_u32
from . import build

MAX_LOG_W32 = 17  # a row of 2^17 u32 words (512 KB) over a cluster of >= 4 blocks
MAX_LOG_W64 = 17  # a row of 2^17 u64 words (1 MB) over a cluster of 8 blocks, a row a tile


def _pairs(v: torch.Tensor, table: torch.Tensor, t: int):
    """Stage view of ``v (..., W)`` as ``(..., W/2t, 2, t)``: the x words
    ``[..., 0, :]`` pair with the y words ``[..., 1, :]``; ``table (W,)`` the
    same way."""
    m = v.shape[-1] // (2 * t)
    return v.reshape(*v.shape[:-1], m, 2, t), table.reshape(m, 2, t)


def ntt32_stages_forward_plain(log_w: int, q: int, w_loc, p_loc, values, out_factor: int = 1):
    """Plain version of kernel ``ntt32_stages_forward`` (int64 words)."""
    width, two_q = 1 << log_w, 2 * q
    v = values
    for s in range(log_w):
        t = width >> (s + 1)
        vv, w = _pairs(v, w_loc[s], t)
        _, p = _pairs(v, p_loc[s], t)
        x, y = vv[..., 0, :], vv[..., 1, :]
        tx = torch.where(x >= two_q, x - two_q, x)
        mx = (w[:, 0] * y - q * mulhi_u32(y, p[:, 0])) & MASK32
        my = (w[:, 1] * y - q * mulhi_u32(y, p[:, 1])) & MASK32
        v = torch.stack([tx + mx, tx + two_q - my], dim=-2).reshape(values.shape)
    if out_factor == 1:
        v = torch.where(v >= two_q, v - two_q, v)
        v = torch.where(v >= q, v - q, v)
    return v


def ntt32_stages_inverse_plain(log_w: int, q: int, w_loc, p_loc, values):
    """Plain version of kernel ``ntt32_stages_inverse`` (int64 words)."""
    two_q = 2 * q
    v = values
    for s in range(log_w):
        t = 1 << s
        vv, w = _pairs(v, w_loc[s], t)
        _, p = _pairs(v, p_loc[s], t)
        x, y = vv[..., 0, :], vv[..., 1, :]
        sxy = x + y
        d = x + two_q - y
        ty = (w[:, 1] * d - q * mulhi_u32(d, p[:, 1])) & MASK32
        v = torch.stack([torch.where(sxy >= two_q, sxy - two_q, sxy), ty], dim=-2)
        v = v.reshape(values.shape)
    return v


def shoup_approx64(y, w, wp, q):
    """``y * w mod q`` in ``[0, 4q)`` with the TPU kernels' approximate
    quotient (``_make_shoup_lazy64(exact=False)``): ``hi64(y * wp)`` less
    the low cross products and their carries, ``y_hi wp_hi + hi32(y_lo
    wp_hi) + hi32(y_hi wp_lo)``, under the exact one by at most 2."""
    ylo, yhi = y & MASK32, (y >> 32) & MASK32
    plo, phi = wp & MASK32, (wp >> 32) & MASK32
    q_hat = yhi * phi + mulhi_u32(ylo, phi) + mulhi_u32(yhi, plo)
    return w * y - q * q_hat


def _reduce_chain64(v, q: int, bound: int, target: int):
    """Conditional subtractions of ``(cp/2) q, ..., target q``, ``cp`` the
    least power of two at or above ``bound``: below ``bound q`` to below
    ``target q`` (``ntt_pallas._reduce_chain64``)."""
    cp = 1 << (bound - 1).bit_length()
    while cp > target:
        cp //= 2
        v = reduce_once64(v, cp * q)
    return v


def defers64(log_w: int, q: int) -> bool:
    """Whether the u64 forward defers its reductions: ``(4 + 4 log_w) q <
    2^64`` (then the Shoup quotient is the approximate one)."""
    return (4 + 4 * log_w) * q < 1 << 64


def ntt64_stages_forward_plain(log_w: int, q: int, w_loc, p_loc, values, out_factor: int = 1):
    """Plain version of kernel ``ntt64_stages_forward`` (u64 patterns)."""
    width, two_q = 1 << log_w, 2 * q
    defer = defers64(log_w, q)
    mq = 4 * q if defer else two_q
    v = values
    for s in range(log_w):
        t = width >> (s + 1)
        vv, w = _pairs(v, w_loc[s], t)
        _, p = _pairs(v, p_loc[s], t)
        x, y = vv[..., 0, :], vv[..., 1, :]
        if defer:
            tx, m = x, shoup_approx64(y, w[:, 0], p[:, 0], q)
        else:
            tx = reduce_once64(x, two_q)
            m = w[:, 0] * y - q * mul_hi_u64(y, p[:, 0])
        v = torch.stack([tx + m, tx + (mq - m)], dim=-2).reshape(values.shape)
    if defer:
        v = _reduce_chain64(v, q, 4 + 4 * log_w, 4)
    if out_factor <= 2:
        v = reduce_once64(v, two_q)
    if out_factor == 1:
        v = reduce_once64(v, q)
    return v


def ntt64_stages_inverse_plain(log_w: int, q: int, w_loc, p_loc, values, in_factor: int = 2):
    """Plain version of kernel ``ntt64_stages_inverse`` (u64 patterns)."""
    c = in_factor  # the words' bound, in units of q
    v = values
    for s in range(log_w):
        t = 1 << s
        if 2 * c * q >= 1 << 64:
            v = _reduce_chain64(v, q, c, 2)
            c = 2
        vv, w = _pairs(v, w_loc[s], t)
        _, p = _pairs(v, p_loc[s], t)
        x, y = vv[..., 0, :], vv[..., 1, :]
        m = shoup_approx64(x + c * q - y, w[:, 0], p[:, 0], q)
        v = torch.stack([x + y, m], dim=-2).reshape(values.shape)
        c = max(2 * c, 4)
    return _reduce_chain64(v, q, c, 2)


def _launch(wrapper, entry: str, log_w: int, max_log_w: int, w_loc, p_loc, v, q_arg, *extra):
    """Checks and launches ``entry`` on ``v (..., 2^log_w)`` (kernel storage)
    with the tables in the kernel's storage; returns the output."""
    width = 1 << log_w
    if not 1 <= log_w <= max_log_w:
        raise ValueError(f"{wrapper.__name__}: 1 <= log_w <= {max_log_w}, got {log_w}")
    if v.shape[-1] != width:
        raise ValueError(f"{wrapper.__name__}: rows of width {width}, got {tuple(v.shape)}")
    for tab in (w_loc, p_loc):
        if tab.shape != (log_w, width) or tab.device != v.device or tab.dtype != v.dtype:
            raise ValueError(f"{wrapper.__name__}: tables must be {v.dtype} ({log_w}, {width}) "
                             f"on {v.device}, got {tab.dtype} {tuple(tab.shape)} on {tab.device}")
    # held in names until the launch is queued: a temporary freed earlier
    # could hand its memory to the next copy before the kernel reads it
    v, w_loc, p_loc = v.contiguous(), w_loc.contiguous(), p_loc.contiguous()
    if v.data_ptr() % 16:  # the kernels move adjacent words 16 bytes at a time
        v = v.clone()
    out = torch.empty_like(v)
    rows = v.numel() // width
    if rows:
        err = getattr(build.library(), entry)(
            v.data_ptr(), out.data_ptr(), w_loc.data_ptr(), p_loc.data_ptr(), q_arg, rows, log_w,
            *extra,
            torch.cuda.current_stream(v.device).cuda_stream,
        )
        build.check(err, entry)
        wrapper.launches += 1
    return out


def _check_device(wrapper, values):
    if values.device.type != "cuda":
        raise ValueError(f"{wrapper.__name__}: unsupported device {values.device}")


def ntt32_stages_forward(log_w: int, q: int, w_loc, p_loc, values, out_factor: int = 1):
    """The final ``log_w`` forward stages of ``values (..., 2^log_w)`` (u32
    words in ``[0, 4q)``, ``q < 2^30``) with the per-lane tables ``w_loc``,
    ``p_loc (log_w, 2^log_w)``; canonical for ``out_factor=1``, lazy
    ``[0, 4q)`` for ``4``.  The output keeps the input's storage.  On the
    card ``1 <= log_w <= 17``."""
    if out_factor not in (1, 4):
        raise ValueError("out_factor must be 1 or 4")
    if not 1 < q < 1 << 30:
        raise ValueError("ntt32_stages_forward requires q < 2^30")
    if values.device.type == "cpu":
        out = ntt32_stages_forward_plain(log_w, q, widen_u32(w_loc), widen_u32(p_loc),
                                         widen_u32(values), out_factor)
        return narrow_u32(out) if values.dtype == torch.int32 else out
    _check_device(ntt32_stages_forward, values)
    out = _launch(ntt32_stages_forward, "pft_ntt32_stages_forward", log_w, MAX_LOG_W32,
                  narrow_u32(w_loc), narrow_u32(p_loc), narrow_u32(values), q,
                  int(out_factor == 1))
    return out if values.dtype == torch.int32 else widen_u32(out)


def ntt32_stages_inverse(log_w: int, q: int, w_loc, p_loc, values):
    """The first ``log_w`` inverse stages of ``values (..., 2^log_w)`` (u32
    words in ``[0, 2q)``); output lazy ``[0, 2q)``, the input's storage.  On
    the card ``1 <= log_w <= 17``."""
    if not 1 < q < 1 << 30:
        raise ValueError("ntt32_stages_inverse requires q < 2^30")
    if values.device.type == "cpu":
        out = ntt32_stages_inverse_plain(log_w, q, widen_u32(w_loc), widen_u32(p_loc),
                                         widen_u32(values))
        return narrow_u32(out) if values.dtype == torch.int32 else out
    _check_device(ntt32_stages_inverse, values)
    out = _launch(ntt32_stages_inverse, "pft_ntt32_stages_inverse", log_w, MAX_LOG_W32,
                  narrow_u32(w_loc), narrow_u32(p_loc), narrow_u32(values), q)
    return out if values.dtype == torch.int32 else widen_u32(out)


def _check64(wrapper, q: int, values, *tables):
    if not 1 < q < 1 << 62:
        raise ValueError(f"{wrapper.__name__} requires q < 2^62")
    if any(t.dtype != torch.int64 for t in (values, *tables)):
        raise ValueError(f"{wrapper.__name__}: u64 words come as int64 tensors")


def ntt64_stages_forward(log_w: int, q: int, w_loc, p_loc, values, out_factor: int = 1):
    """The final ``log_w`` forward stages of ``values (..., 2^log_w)`` (u64
    words in ``[0, 4q)``, ``q < 2^62``) with the per-lane tables; canonical
    for ``out_factor=1``, ``[0, 2q)`` for ``2``, ``[0, 4q)`` for ``4``.  On
    the card ``1 <= log_w <= 17``."""
    if out_factor not in (1, 2, 4):
        raise ValueError("out_factor must be 1, 2 or 4")
    _check64(ntt64_stages_forward, q, values, w_loc, p_loc)
    if values.device.type == "cpu":
        return ntt64_stages_forward_plain(log_w, q, w_loc, p_loc, values, out_factor)
    _check_device(ntt64_stages_forward, values)
    return _launch(ntt64_stages_forward, "pft_ntt64_stages_forward", log_w, MAX_LOG_W64,
                   w_loc, p_loc, values, q, out_factor)


def ntt64_stages_inverse(log_w: int, q: int, w_loc, p_loc, values, in_factor: int = 2):
    """The first ``log_w`` inverse stages of ``values (..., 2^log_w)`` (u64
    words in ``[0, in_factor q)``, ``in_factor`` a power of two at least
    2); output lazy ``[0, 2q)``.  On the card ``1 <= log_w <= 17``."""
    if in_factor < 2 or in_factor & (in_factor - 1):
        raise ValueError("in_factor must be a power of two, at least 2")
    _check64(ntt64_stages_inverse, q, values, w_loc, p_loc)
    if values.device.type == "cpu":
        return ntt64_stages_inverse_plain(log_w, q, w_loc, p_loc, values, in_factor)
    _check_device(ntt64_stages_inverse, values)
    return _launch(ntt64_stages_inverse, "pft_ntt64_stages_inverse", log_w, MAX_LOG_W64,
                   w_loc, p_loc, values, q, in_factor)


def launch_grid(log_w: int, q: int, rows: int, forward: bool, bits: int = 64) -> tuple[int, int]:
    """``(C, T)`` that a launch of the u64 (``bits=64``) or u32 (``bits=32``)
    pair on ``rows`` rows of ``2^log_w`` words takes on the current card:
    clusters of ``C`` blocks a row, tiles of ``T`` rows a block (the C
    entry's rule; asks the card)."""
    import ctypes

    if bits not in (32, 64):
        raise ValueError("bits must be 32 or 64")
    entry = f"pft_ntt{bits}_stages_grid"
    log_c, tile = ctypes.c_int(), ctypes.c_int()
    build.check(getattr(build.library(), entry)(
        int(forward), q, rows, log_w, ctypes.byref(log_c), ctypes.byref(tile)), entry)
    return 1 << log_c.value, tile.value


ntt32_stages_forward.launches = 0
ntt32_stages_inverse.launches = 0
ntt64_stages_forward.launches = 0
ntt64_stages_inverse.launches = 0
