"""A numpy model of kernel F, ``rotate`` (``rotate_kernel`` in
``csrc/cmux_front.cu``), held word for word against its plain version
``ops.rotate.rotate_plain`` and the JAX ``pallas_rotate`` (interpret mode)
on the CPU.

The model runs the kernel's index map on flat word memory, as the launch
sees it: the mode ``launch_rotate`` picks (a word at a time below 4 words a
row or off 16-byte alignment, else groups of 4 words read in place at the
source's row stride, 0 for the one broadcast row), max(1, 1024 / n) rows a
block and a thread a group up to 1024, every thread's groups in one row
(its one degree, loaded first), and for a group of 4
output words c .. c+3 of row r: the source index e = c - d mod 2n of word
c, the two aligned 16-byte loads at e - e mod 4 and 4 words on (mod 2n),
each load's sign (its words at or past n negated), the window's shift e mod
4 (the same for every group of a row), the optional subtraction of the
row's own words c .. c+3, one 16-byte store at the destination's row
stride.  Each access is checked for 16-byte alignment and to stay inside
its row.  Sources: one broadcast row (stride 0, ``expand``), contiguous
rows, rows of a wider tensor (strides that are and are not multiples of
4 words); destinations: new rows or a view with its own row stride
(``acc[:, -1, :]``); degrees of either sign in [-4n, 4n]; log_n 1-16.
Tolerance: zero (bit-equal).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primus_fhe_tpu.ops.rotate_pallas import pallas_rotate
from primus_fhe_tpu_torch.ops import rotate

M32 = 0xFFFFFFFF
WORDS, GROUPS = 0, 1  # rotate_kernel<SUB, GROUPS>


def launch_mode(log_n, in_off, out_off, in_stride, out_stride):
    """``launch_rotate``'s mode and rows a block (word offsets for
    addresses: 16-byte alignment is an offset that is a multiple of 4)."""
    aligned = (in_off % 4 == 0 and out_off % 4 == 0 and in_stride % 4 == 0
               and out_stride % 4 == 0)
    mode = WORDS if log_n < 2 or not aligned else GROUPS
    return mode, 1 if log_n >= 10 else 1 << (10 - log_n)


def model_rotate(src_mem, in_off, in_stride, out_mem, out_off, out_stride, degrees, rows,
                 log_n, subtract):
    """Kernel F on flat word memories ``src_mem`` and ``out_mem`` (u32
    words in int64): ``len(degrees) * rows`` rows.  Returns the mode."""
    n = 1 << log_n
    total = len(degrees) * rows
    mode, block_rows = launch_mode(log_n, in_off, out_off, in_stride, out_stride)
    row = np.arange(total)
    d = np.asarray(degrees, dtype=np.int64)[row // rows] % (2 * n)
    src_row = in_off + row * in_stride
    if mode != WORDS:  # a thread (threads stride over a block's groups): one row
        groups = np.arange(total * (n // 4))
        block, it = groups // (block_rows * (n // 4)), groups % (block_rows * (n // 4))
        rows_of = block * block_rows + it // (n // 4)
        threads = min(1024, block_rows * (n // 4))  # a thread a group, up to 1024
        pairs = np.unique(np.stack([block * threads + it % threads, rows_of]), axis=1)
        assert len(np.unique(pairs[0])) == pairs.shape[1]
    if mode == WORDS:
        c = np.arange(n)
        e = (c[None, :] - d[:, None]) % (2 * n)
        src = src_mem[src_row[:, None] + e % n]
        v = np.where(e >= n, -src & M32, src)
        own = src_mem[src_row[:, None] + c[None, :]]
        out = (v - own) & M32 if subtract else v
        out_mem[out_off + row[:, None] * out_stride + c[None, :]] = out
        return mode
    c = np.arange(0, n, 4)
    e = (c[None, :] - d[:, None]) % (2 * n)  # (rows, groups)
    sh, e0 = e & 3, e - (e & 3)
    assert (sh == sh[:, :1]).all()  # one shift a row
    e1 = (e0 + 4) % (2 * n)
    w = []
    for ei in (e0, e1):
        at = src_row[:, None] + ei % n
        assert (at % 4 == 0).all() and ((ei % n) + 4 <= n).all()  # aligned, inside the row
        x = src_mem[at[..., None] + np.arange(4)]
        w.append(np.where((ei >= n)[..., None], -x & M32, x))
    win = np.concatenate(w, axis=-1)  # (rows, groups, 8)
    v = np.take_along_axis(win, sh[..., None] + np.arange(4), axis=-1)
    if subtract:
        v = (v - src_mem[(src_row[:, None] + c[None, :])[..., None] + np.arange(4)]) & M32
    dst = out_off + row[:, None] * out_stride + c[None, :]
    assert (dst % 4 == 0).all()
    out_mem[dst[..., None] + np.arange(4)] = v
    return mode


def run(values_mem, in_off, in_stride, shape, degrees, log_n, subtract, out_spec=None):
    """The model on ``values`` laid out at ``in_off`` with row stride
    ``in_stride`` in ``values_mem``; ``out_spec`` ``(width, off, stride)``
    a destination memory, else new rows.  Returns (model rows, mode)."""
    n = 1 << log_n
    total = int(np.prod(shape[:-1]))
    width, out_off, out_stride = out_spec or (total * n, 0, n)
    out_mem = np.full(width, -1, dtype=np.int64)
    mode = model_rotate(values_mem, in_off, in_stride, out_mem, out_off, out_stride, degrees,
                        total // shape[0], log_n, subtract)
    rows = out_mem[out_off + np.arange(total)[:, None] * out_stride + np.arange(n)[None, :]]
    assert (rows >= 0).all()
    return rows.reshape(shape), mode


def _degrees(rng, bsz, n):
    d = rng.integers(-4 * n, 4 * n + 1, bsz)
    d[:3] = [-4 * n, 0, 4 * n][:bsz]
    return d


@pytest.mark.parametrize("log_n", range(1, 17))
def test_model_matches_plain(log_n):
    """Broadcast, contiguous and strided sources, new rows and a strided
    destination, with and without the subtraction, at every log_n."""
    n = 1 << log_n
    rng = np.random.default_rng(log_n)
    bsz, k1 = (3, 2) if log_n <= 12 else (2, 1)
    mem = rng.integers(0, 1 << 32, bsz * k1 * (n + 8) + 8, dtype=np.int64)
    deg = _degrees(rng, bsz, n)
    cases = [  # (in_off, in_stride, shape, the tensor it is)
        (4, 0, (bsz, n), torch.from_numpy(mem[4:4 + n]).expand(bsz, n)),
        (0, n, (bsz, k1, n), torch.from_numpy(mem[:bsz * k1 * n]).reshape(bsz, k1, n)),
        (4, n + 8, (bsz, k1, n),
         torch.from_numpy(mem[4:4 + bsz * k1 * (n + 8)]).reshape(bsz, k1, n + 8)[..., :n]),
        (3, n + 3, (bsz, k1, n),
         torch.from_numpy(mem[3:3 + bsz * k1 * (n + 3)]).reshape(bsz, k1, n + 3)[..., :n]),
    ]
    modes = set()
    for in_off, stride, shape, t in cases:
        assert stride == 0 or t.stride(-2) == stride
        for sub in (False, True):
            want = rotate.rotate_plain(t, torch.from_numpy(deg), sub).numpy()
            got, mode = run(mem, in_off, stride, shape, deg, log_n, sub)
            np.testing.assert_array_equal(got, want)
            modes.add(mode)
            # into acc[:, -1, :] of an accumulator (bsz, 3, n): row stride 3n
            if len(shape) == 2:
                got, _ = run(mem, in_off, stride, shape, deg, log_n, sub,
                             (bsz * 3 * n, 2 * n, 3 * n))
                np.testing.assert_array_equal(got, want)
    assert modes == ({WORDS} if log_n < 2 else {WORDS, GROUPS})


@pytest.mark.parametrize("log_n,rows", [(6, 2), (3, 1)])
def test_model_matches_pallas_rotate(log_n, rows):
    """The model and the wrapper (CPU: the plain version, an ``out=`` view
    included) against ``pallas_rotate`` in interpret mode, degrees of
    either sign up to 4n."""
    n, bsz = 1 << log_n, 4
    rng = np.random.default_rng(log_n)
    v = rng.integers(0, 1 << 32, (bsz, rows, n), dtype=np.int64)
    deg = _degrees(rng, bsz, n)
    for sub in (False, True):
        want = np.asarray(pallas_rotate(jnp.asarray(v.astype(np.uint32)),
                                        jnp.asarray(deg.astype(np.int32)), n, sub))
        got, _ = run(v.reshape(-1), 0, n, v.shape, deg, log_n, sub)
        np.testing.assert_array_equal(got, want.astype(np.int64))
        acc = torch.zeros((bsz, rows + 1, n), dtype=torch.int32)
        back = rotate.rotate(torch.from_numpy(v), torch.from_numpy(deg), sub, out=acc[:, 1:, :])
        assert back.data_ptr() == acc[:, 1:, :].data_ptr()
        np.testing.assert_array_equal(acc[:, 1:].numpy().astype(np.int64) & M32, want)
        assert not acc[:, 0].any()


def test_launch_modes():
    """The main path's start (64 rows from one broadcast row of 2048 into
    ``acc[:, -1, :]``), phase 13's contiguous rows and rows of 2^14 go in
    groups; rows of 2 words, or a row stride off 4 words, a word at a
    time; short rows share a block."""
    assert launch_mode(11, 0, 2048, 0, 2 * 2048) == (GROUPS, 1)
    assert launch_mode(11, 0, 0, 2048, 2048) == (GROUPS, 1)
    assert launch_mode(14, 0, 0, 0, 1 << 14) == (GROUPS, 1)
    assert launch_mode(1, 0, 0, 2, 2) == (WORDS, 512)
    assert launch_mode(8, 0, 0, 259, 256) == (WORDS, 4)
    assert launch_mode(5, 0, 0, 32, 32) == (GROUPS, 32)
