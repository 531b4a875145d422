#!/usr/bin/env python3
"""Device time of kernels A (``mxu_cmux_step``), B (``ntru_cmux_step``) and
the NTT-key CMux step (``fused_cmux_step``, kernels 3-4) on one CUDA card, at
BOOLEAN_128 width (N = 2048, k = 1, L = 3, two primes) and NTRU_128 width
(N = 1024, q = 1038337, L = 6), batch 1 and 64; the NTT-key blind
rotation at BOOLEAN_128 width (630 steps on a random canonical key): wall
ms, host us a step and the device's idle share; and the u64 transforms
of both routes, ``mxu8_forward64`` / ``mxu8_inverse64`` and row 10's
``ntt64_forward`` / ``ntt64_inverse``, on ``bench_dcrt.py``'s 50-bit moduli
at the shapes of their paths (:data:`NTT_SHAPES`, :data:`INV_SHAPES`: the
DCRT rotation's batch 1 and 16, a residue shard's, ``bench.py``'s round
trip of 512 rows, the four-step's sub-transforms of 256 words), each with
its bound, its share of it, row 10's tile of rows, and the byte-radix
wrappers' host time a call broken down; kernel E (``mxu8_roundtrip64_mul``)
at the round trip's 512 rows on a 7- and an 8-plane modulus (beside row 10,
``mxu8_forward64`` and D there) and at the card tests' shapes
(:data:`RT_SHAPES`), with its tile of rows.

    python3 cmux_mxu_timing.py                 # this checkout
    python3 cmux_mxu_timing.py --root DIR      # the package under DIR
    python3 cmux_mxu_timing.py --compare OLD   # OLD and this checkout in turns
    python3 cmux_mxu_timing.py --phases        # cycles per phase (clock64)
    python3 cmux_mxu_timing.py --ntt ...       # the u64 transforms and round trip only
    python3 cmux_mxu_timing.py --ntt --phases  # byte-radix cycles per phase, E's per pass
    python3 cmux_mxu_timing.py --grids         # byte-radix on every (R, S), E on every tile
    python3 cmux_mxu_timing.py --ntt32 ...     # kernels 1-2 and the NTT-key step only
    python3 cmux_mxu_timing.py --ntt32 --grids # kernels 1-2 on every tile of rows
    python3 cmux_mxu_timing.py --ntt32 --phases  # their cycles per pass (clock64)
    python3 cmux_mxu_timing.py --ntt64 ...     # row 10 only (with --compare OLD: in turns)
    python3 cmux_mxu_timing.py --ntt64 --grids # row 10 on every tile of rows
    python3 cmux_mxu_timing.py --ntt64 --phases  # its cycles per pass (clock64)
    python3 cmux_mxu_timing.py --split ...     # row 13's halves (with --compare OLD: in turns)
    python3 cmux_mxu_timing.py --split --grids # the four halves on every block size
    python3 cmux_mxu_timing.py --split --phases  # their cycles per phase (clock64)
    python3 cmux_mxu_timing.py --stages ...    # row 11's stage kernels (with --compare OLD: in turns)
    python3 cmux_mxu_timing.py --stages --grids  # the u32 and u64 pairs on every (C, T)
    python3 cmux_mxu_timing.py --stages --phases # their cycles per pass (clock64)
    python3 cmux_mxu_timing.py --keyprep ...   # kernel C beside kernel 1 (with --compare OLD: in turns)
    python3 cmux_mxu_timing.py --keyprep --phases  # kernel C's cycles a tile per phase (clock64)
    python3 cmux_mxu_timing.py --keyprep --grids   # kernel C on every tile of 1-8 rows
    python3 cmux_mxu_timing.py --rotate ...    # kernel F (with --compare OLD: in turns)
    python3 cmux_mxu_timing.py --rotate --phases   # kernel F's cycles (clock64)
    python3 cmux_mxu_timing.py --front ...     # kernel G (with --compare OLD: in turns)
    python3 cmux_mxu_timing.py --front --phases    # kernel G's cycles per phase (clock64)
    python3 cmux_mxu_timing.py --front --grids     # kernel G on every block size, both store kinds
    python3 cmux_mxu_timing.py --stage2 ...    # kernels H and J (with --compare OLD: in turns)
    python3 cmux_mxu_timing.py --stage2 --phases [--compare OLD]  # their cycles per phase
    python3 cmux_mxu_timing.py --stage2 --grids    # H and J on every slice count

Both forward transforms are bounded by the function they compute: 16 bytes
a word over the HBM rate, or the butterfly's ``n / 2 log n`` Shoup
multiplies a row (10 32-bit multiplies each) at the 32-bit multiply peak,
whichever is larger.  ``mxu8_forward64``'s own method, its int8 MACs at the
int8 peak, is given beside it as ``mac_roofline_ms``.  Its host time a
call is taken with the card held busy by a sleep kernel, so that the host
clock sees only the enqueue: the whole wrapper, the C entry alone (through
ctypes, arguments made ready), and the wrapper's Python parts one by one;
``loop_ms`` repeats ``chip_smoke.py``'s phase-16 reading (the mean of 20
calls back to back between two CUDA events, the host free to run ahead),
and ``device_max_ms`` is the slowest of the 20 device times.
``--grids`` copies the package to ``.proof/fwd_grids``, adds to that copy's
C entries a grid set from outside (rows a tile R in 1, 2, 4; column slices S
in 1, 2, 4, 8), and times ``mxu8_forward64``, ``mxu8_inverse64`` and kernel
D at their shapes on every grid that fits beside the launch's own choice,
and kernel E on every tile of rows (``pft_rt64_force_tile``); the source
itself has no such knob.  ``--ntt --phases`` stamps kernel E too
(:func:`stamp_rt`: clock64 laps per pass).  Under ``--compare`` the
summary gives E's device ms over row 10's two launches and over
``mxu8_forward64`` + D at the round trip's shapes (``rt_yardstick_new``).
``--ntt32`` times kernels 1-2 (``forward32``, ``inverse32``) at the shapes
their paths give them (:data:`NTT32_SHAPES`: BOOLEAN_128's external
products at batch 1 and 64, NTRU_128's NTT-evk step at batch 1 and 64, the
64-bit torus product's four primes at batch 1 and 64), each with its bound
(8 bytes a word, or ``n / 2 log n`` Shoup multiplies a row of 3 32-bit
multiplies each) and the tile of rows the launch picked, and
``fused_cmux_step`` at batch 1 and 64; ``--ntt32 --grids`` copies the
package to ``.proof/ntt32_tiles`` with the tile set from outside
(``pft_ntt32_force_tile``) and times both kernels at those shapes on
every tile of 1, 2, 4 and 8 rows; ``--ntt32 --phases`` copies it to
``.proof/ntt32_phases`` with clock64() laps in block 0 of both kernels and
their span on the device's global timer (:func:`stamp_ntt32`).
``--ntt64`` does the same for row 10 at its shapes: ``--grids`` from a copy
in ``.proof/ntt64_tiles`` whose C entry takes the tile from outside
(``pft_ntt64_force_tile``), ``--phases`` from ``.proof/ntt64_phases``
(:func:`stamp_ntt64`).  ``--split`` times row 13's four halves (K1, K2,
Ki1 with and without the key, Ki2) at phase 16's shard shapes, n = 4096
and 2^14 (:data:`SPLIT_SHAPES`), each with its bound
(``chip_smoke.split_bounds``),
and phase 16.2's sharded product a trip at D = 2 and 4, host-paced and
with the host ahead (:func:`sharded_trips`);
under ``--compare`` the summary gives new / old per shape
(``mean_split_ms``, None where the old side refuses the shape); ``--split --grids`` copies the package to
``.proof/split_tiles`` with the row kernel's tile and the column kernel's
threads a block set from outside (``pft_split_force_tile``,
``pft_split_force_threads``) and times K2 and Ki1 on every tile of 4-32
rows, K1 and Ki2 on blocks of 64-256 threads, beside the launch's own;
``--split --phases`` copies it to ``.proof/split_phases`` with clock64()
laps of block 0 per phase (row kernel: load, table wait, each pass,
twiddle, store; column kernel: load and table wait, the stages in each
layout, the layout change, twiddle or last stage, store;
:func:`stamp_split`).  ``--stages``
times row 11's four stage kernels at :data:`STAGE_SHAPES` (the u64 pair at
phase 15's shards of 2 x 2^14 and 2 x 2^15 words, the JAX kernel's tile of
8 x 2^14 and the card tests' smaller shards, on the exact-Shoup and a
deferring q; the u32 pair at phase 15's shards of n = 2^12 and the large
ring's, 2 x 2^14 to 2 x 2^16 and 8 x 2^14), each checked against its
plain version, with its bound, share, and the launch's (C, T), and phase
15.3's u64 and u32 trips at D = 4 and 2 (:func:`coeff_trips`); under
``--compare`` the summary gives new / old per shape (``mean_stages_ms``,
None where the old side refuses the shape); ``--stages --grids`` copies the
package to ``.proof/stages_grids`` with the grid set from outside
(``pft_st64_force_grid``, both word types) and times both pairs on every
(C, T) beside the launch's own; ``--stages --phases`` copies it to
``.proof/stages_phases`` with clock64() laps of block 0 after each pass and
the stages across the cluster (:func:`stamp_stages`).  The ``empty kernel`` line is the floor of
this way of timing: a launch that does nothing, timed the same way.
``--keyprep`` times kernel C (``mxu8_forward32``) and, on the same
canonical words, kernel 1's canonical forward (the same function) at
:data:`KEYPREP_SHAPES` (``chip_smoke.py``'s 2 x 12 and 2 x 768 rows of 2048,
BOOLEAN_128's whole key of 2 x 7560 and NTRU_128's evk of 4200 rows of
1024), with the bound, share, C's tile and persistent grid and C over
kernel 1; ``--keyprep --phases`` copies the package to
``.proof/keyprep_phases`` with clock64() laps of block 0's thread 0 summed
over its tiles (the wait for a tile's rows, pass 1, the middle passes, the
last pass and the store's issue; :func:`stamp_keyprep`).  ``--rotate``
times kernel F at :data:`ROTATE_SHAPES` (phase 13's 64 x 2 rows, the
bootstrap's start as the checkout's blind rotation runs it, with and
without its zero fill, and 1024 x 2 rows), with the launches the profiler
sees at the start; ``--rotate --phases`` stamps F's block 0
(:func:`stamp_rotate`).  ``--front`` times kernel G (``cmux_front``) at
:data:`FRONT_SHAPES` (BOOLEAN_128's batch 1, phase 13's 64 x 2 rows and
1024 x 2 rows), each with its byte bound, share and the launch's (mode,
threads a block, blocks), F at 64 x 2 beside it, and
ptxas's registers, stack and spill for every G instance; ``--front
--phases`` copies the package to ``.proof/front_phases`` with clock64()
laps of block 0's thread 0 (the degree, the window and own loads, the
digits and lifts, the stores' issue, the last two summed over the kp L
stores; :func:`stamp_front`); ``--front --grids`` times G on every block
size of :data:`FRONT_THREADS` (``pft_g_force``) from two copies,
``.proof/front_grids`` with the source's streaming stores (``__stcs``)
and ``.proof/front_grids_wb`` with write-back stores.  All three
take ``--compare OLD`` (new / old per shape in the summary; ``--front``
also each side's grids and ptxas figures); ``--keyprep --grids`` times C
on every tile of 1-8 rows (``pft_c_force_tile``, from a copy in
``.proof/keyprep_grids``).
``--stage2`` times kernels H (``cmux_stage2``) and J (``ntru_stage2``) at
their paths' shapes (:data:`STAGE2_H_SHAPES`: ``chip_smoke.py`` phase
21.2's; :data:`STAGE2_J_SHAPES`: phase 22.5's; J with the next step's
digits where the checkout's J writes them), each checked against its
plain version, with its bound, share and the launch's grid, ptxas's
figures of every instance, the staged NTRU step after a rotation's first
(``NtruStepPlan``: device ms of all its launches) and the 700-step NTRU
rotation at 2^13 (:func:`ntru_rotations`: host-clock ms and busy ms at
batch 1 and 16); ``--stage2 --phases`` copies the package to
``.proof/stage2_phases_new`` (and OLD's to ``..._old`` with ``--compare
OLD``, run old, new, new, old) with clock64() laps of thread 0 in every
block (the MAC, the inverse, the CRT or rotation; block 0's and each
phase's largest; :func:`stamp_stage2`); ``--stage2 --grids`` copies it to
``.proof/stage2_grids`` with the slice count set from outside
(``pft_h_force``, ``pft_j_force``) and times both on every C = 1-16 beside
the rule's own.

A kernel's device time is the median of 20 calls, each timed with CUDA
events queued behind a ~1 ms sleep kernel, so the events bracket the kernel
and not the host's launch work (where a package's step is two launches,
they run back to back behind the same sleep).  A rotation's wall time is the
least of 3 synchronised runs, its host time a step the least enqueue time
(synchronised before, not inside) over 630, its idle share 1 - the device
time ``torch.profiler`` sees in one run over that wall time.  ``--compare
OLD`` runs OLD, this checkout,
this checkout, OLD, each in its own process (each builds its own kernels
under its root), and prints every run and the mean per side.  ``--phases``
copies the package to ``.proof/phases`` (git-ignored), stamps ``clock64()``
in block 0 after each phase barrier of ``csrc/cmux_mxu.cu`` and of the step
kernel in ``csrc/cmux_fused.cu`` (with the first and last blocks' global
timer and the card's cluster occupancy), builds that copy and prints the
cycles of each phase; the source itself carries no
stamps.  Each mode prints the card's name and power limit and ends with
one JSON line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPS = 20
PHASES = ("digits", "forward pass 1", "forward pass 2", "MAC", "inverse pass 1",
          "inverse pass 2", "CRT / final add")


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def device_ms(torch, fn) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def kernels(torch, dev):
    """``{(kernel, batch): call}`` at the two profiles' widths, inputs made
    from a seeded generator on the card (int32 storage, as the blind
    rotations pass them)."""
    from primus_fhe_tpu_torch import params as P
    from primus_fhe_tpu_torch.decompose import ApproxSignedBasis32
    from primus_fhe_tpu_torch.lattice import tfhe
    from primus_fhe_tpu_torch.ops import cmux_fused, cmux_mxu, ntru_cmux_mxu

    p, pn = P.BOOLEAN_128, P.NTRU_128
    basis = ApproxSignedBasis32(None, p.log_basis, reverse_length=p.level)
    conv = tfhe.make_convolver(p.log_n, p.level, p.glwe_dim, p.log_basis)
    plan = cmux_mxu.plan_for(conv)
    n, k1 = p.n, p.glwe_dim + 1
    nctx, _ = P.make_ntru_context(pn)
    nplan = ntru_cmux_mxu.get_ntru_plan(pn.log_n, nctx.q_int)
    g = torch.Generator(device=dev).manual_seed(2026)
    kv, kpre = cmux_mxu.prepare_mxu_bsk(
        conv, torch.randint(0, 1 << 32, (1, k1, p.level, k1, n), generator=g, device=dev))
    kv, kpre = kv[0].to(torch.int32), kpre[0].to(torch.int32)
    nkv, nkpre = ntru_cmux_mxu.prepare_mxu_evk(
        nctx, torch.randint(0, nctx.q_int, (1, pn.level, nctx.n), generator=g, device=dev))
    nkv, nkpre = nkv[0].to(torch.int32), nkpre[0].to(torch.int32)
    qs = torch.tensor(conv.primes, device=dev).reshape(-1, 1, 1, 1, 1)
    key = (torch.randint(0, 1 << 62, (conv.count, k1, p.level, k1, n), generator=g, device=dev)
           % qs).to(torch.int32)
    calls = {}
    for bsz in (1, 64):
        acc = torch.randint(0, 1 << 32, (bsz, k1, n), generator=g, device=dev).to(torch.int32)
        deg = torch.randint(0, 2 * n, (bsz,), generator=g, device=dev, dtype=torch.int32)
        n_acc = torch.randint(0, nctx.q_int, (bsz, nctx.n), generator=g, device=dev).to(torch.int32)
        n_deg = torch.randint(0, 2 * nctx.n, (bsz,), generator=g, device=dev, dtype=torch.int32)
        calls[("A", bsz)] = (lambda a=acc, d=deg: cmux_mxu.mxu_cmux_step(
            plan, basis, conv, a, d, kv, kpre))
        calls[("B", bsz)] = (lambda a=n_acc, d=n_deg: ntru_cmux_mxu.ntru_cmux_step(
            nplan, nctx.basis, a, d, nkv, nkpre))
        calls[("step", bsz)] = (lambda a=acc, d=deg: cmux_fused.fused_cmux_step(
            conv, basis, a, d, key))
    return calls


# The u64 transforms' shapes: (label, moduli, rows a modulus[, log_n, 12 if
# absent]) of the forward (phase 10's batch 1 and 16, a residue shard's 64,
# bench.py's round trip of 512 rows, phase 12's sub-transforms of 256 words)
# and of the inverse (phase 10's 4 and 64 rows, a residue shard's 16, the
# forward's 16 and 64 for a like comparison, the round trip's 512 rows and
# the sub-transforms); row 10's forward on the round trip runs at
# out_factor 4 (NTT_OUT_FACTOR), as phase 11's butterfly route calls it;
# kernel D at bench.py's round trip, 512 rows of one modulus; the bound's
# peaks (H100 SXM data sheet; 64 32-bit multiplies a clock an SM x 132 SMs
# x 1.98 GHz, as chip_smoke.py counts them).
NTT_MODULI = (1125899906826241, 1125899906629633)
Q60 = 1152921504606830593  # phase 11's 8-plane modulus
NTT_SHAPES = (("16 rows", 2, 8), ("64 rows", 1, 64), ("256 rows", 2, 128), ("512 rows", 1, 512),
              ("512 x 256", 1, 512, 8), ("512 rows 8 planes", (Q60,), 512))
INV_SHAPES = (("4 rows", 2, 2), ("16 rows", 2, 8), ("shard 16 rows", 1, 16), ("64 rows", 1, 64),
              ("2x32 rows", 2, 32), ("512 rows", 1, 512), ("512 x 256", 1, 512, 8),
              ("512 rows 8 planes", (Q60,), 512))
NTT_OUT_FACTOR = {"512 rows": 4, "512 rows 8 planes": 4}
# row 10 with a row over a cluster of 2 blocks (log_n 15; --ntt64 only):
# phase 23.7's forward and inverse rows a modulus over its two moduli
# (ntt_prime_chain(50, 15, 2): NTT_MODULI are 1 mod 2^14 only)
Q50_15 = (1125899904679937, 1125899903827969)
Q50_17 = (1125899902124033, 1125899886395393)  # ntt_prime_chain(50, 17, 2): 2^17, 8 blocks
CLUSTER_SHAPES = (("forward", ("16 rows x 2^15", Q50_15, 16, 15)),
                  ("inverse", ("4 rows x 2^15", Q50_15, 4, 15)),
                  ("forward", ("16 rows x 2^17", Q50_17, 16, 17)),
                  ("inverse", ("4 rows x 2^17", Q50_17, 4, 17)))
D_SHAPES = (("512 rows", 1, 512), ("512 rows 8 planes", (Q60,), 512))
# kernel E at phase 11's two shapes and at the card tests' (log_n 8-12; rows
# 1, 5, 33; one 7-plane modulus, or it and an 8-plane one)
RT_SHAPES = (("512 rows", 1, 512), ("512 rows 8 planes", (Q60,), 512)) + tuple(
    (f"{count}x{rows} x 2^{log_n}", (NTT_MODULI[0], Q60)[:count], rows, log_n)
    for log_n in range(8, 13) for rows in (1, 5, 33) for count in (1, 2))
RT_TRIPS = 20
HBM_BYTES_S, INT8_OPS_S, INT32_MULS_S = 3.35e12, 1979e12, 132 * 64 * 1.98e9


def ntt_calls(torch, dev, row10_only: bool = False) -> dict:
    """``{(kernel, label): (call, bound ms, tables, input, MAC roofline ms or
    None, key table or None)}`` of the forward transforms at
    :data:`NTT_SHAPES`, the inverse ones at :data:`INV_SHAPES`, kernel D at
    :data:`D_SHAPES` and kernel E at :data:`RT_SHAPES` (n = 4096 where a
    shape gives no log_n; the first ``count`` of :data:`NTT_MODULI`, or
    the shape's own moduli), canonical inputs made from a seeded generator
    on the card.  Each is held to its function's bound (module docstring; D
    adds its key's Shoup multiply, 10 32-bit multiplies a word, and E two
    transforms and the key); the byte-radix route's own work, P planes by 8
    operand bytes over both passes, is its MAC roofline.  ``row10_only``
    adds row 10 at :data:`CLUSTER_SHAPES`."""
    from primus_fhe_tpu_torch.ops import ntt64, ntt_mxu8
    from primus_fhe_tpu_torch.transforms import dcrt as td

    g = torch.Generator(device=dev).manual_seed(2028)
    calls = {}
    shapes = ([("forward", s) for s in NTT_SHAPES] + [("inverse", s) for s in INV_SHAPES]
              + [("mul", s) for s in D_SHAPES] + [("rt", s) for s in RT_SHAPES]
              + (list(CLUSTER_SHAPES) if row10_only else []))
    for kind, (label, moduli, rows, *rest) in shapes:
        log_n = rest[0] if rest else 12
        n = 1 << log_n
        moduli = NTT_MODULI[:moduli] if isinstance(moduli, int) else moduli
        count = len(moduli)
        plan = td.build_dcrt_plan64(log_n, list(moduli))
        x = torch.stack([torch.randint(0, q, (rows, n), generator=g, device=dev) for q in moduli])
        words = count * rows * n
        keyed = kind in ("mul", "rt")
        muls = (count * rows * (n // 2) * log_n * 10 * (2 if kind == "rt" else 1)
                + (10 * words if keyed else 0))
        nbytes = 16 * words + (16 * count * n if keyed else 0)
        bound_ms = max(nbytes / HBM_BYTES_S, muls / INT32_MULS_S) * 1e3
        mac_ms = 2 * count * rows * plan.mxu.planes * n * 8 * (n // 128 + 128) / INT8_OPS_S * 1e3
        if kind == "forward":
            calls[("mxu8_forward64", label)] = (
                lambda p=plan, v=x: ntt_mxu8.mxu8_forward64(p.mxu, v),
                bound_ms, plan.mxu, x, mac_ms, None)
            of = NTT_OUT_FACTOR.get(label, 1)
            calls[("ntt64_forward", label)] = (
                lambda p=plan, v=x, f=of: ntt64.ntt64_forward(p.ntt, v, f), bound_ms, plan.ntt, x,
                None, None)
        elif kind == "inverse":
            calls[("mxu8_inverse64", label)] = (
                lambda p=plan, v=x: ntt_mxu8.mxu8_inverse64(p.mxu, v),
                bound_ms, plan.mxu, x, mac_ms, None)
            calls[("ntt64_inverse", label)] = (
                lambda p=plan, v=x: ntt64.ntt64_inverse(p.ntt, v), bound_ms, plan.ntt, x, None,
                None)
        else:
            mt = plan.mxu.mul_table(torch.stack([torch.randint(0, q, (n,), generator=g,
                                                               device=dev) for q in moduli]))
            if kind == "mul":
                calls[("mxu8_inverse64_mul", label)] = (
                    lambda p=plan, v=x, m=mt: ntt_mxu8.mxu8_inverse64_mul(p.mxu, v, m),
                    bound_ms, plan.mxu, x, mac_ms, mt)
            else:
                calls[("mxu8_roundtrip64_mul", label)] = (
                    lambda p=plan, v=x, m=mt: ntt_mxu8.mxu8_roundtrip64_mul(p.mxu, v, m),
                    bound_ms, plan.mxu, x, None, mt)
    return calls


# Kernels 1-2's shapes: (label, primes, forward rows a prime, inverse rows a
# prime, log_n).  BOOLEAN_128 (N = 2048, two primes, k1 = 2 rows a
# ciphertext): cmux_delta's and the external products' transforms at batch 1
# and 64; NTRU_128 (N = 1024, one prime): the NTT-evk step transforms L = 6
# digit rows a ciphertext forward and one back; the 64-bit torus product over
# four primes at batch 1 (k1 = 2 rows) and at phase 18's batch 64 (k1 L = 8
# digit rows forward, k1 back).
NTT32_SHAPES = (
    ("BOOLEAN_128 b1", (1073692673, 1073668097), 2, 2, 11),
    ("BOOLEAN_128 b64", (1073692673, 1073668097), 128, 128, 11),
    ("NTRU_128 b1", (1038337,), 6, 1, 10),
    ("NTRU_128 b64", (1038337,), 384, 64, 10),
    ("torus64 b1", "torus64", 2, 2, 11),
    ("torus64 b64", "torus64", 512, 128, 11),
    # a row over a cluster of 8 blocks: chip_smoke.py 21.1's kp 2 at 16 rows
    # and kernel 1 over 3 primes at 288 rows a prime (3x the 2^17 PBS's at batch 16)
    ("kp2 2^17 16 rows", "kp2", 16, 16, 17),
    ("kp3 2^17 288 rows", "pbs", 288, 288, 17),
)


NTT32_LOG_N = {label: log_n for label, *_, log_n in NTT32_SHAPES}


def ntt32_calls(torch, dev) -> dict:
    """``{(kernel, label): (call, bound ms, tables, rows a prime)}`` of
    kernels 1-2 at :data:`NTT32_SHAPES`: inputs in the kernels' input ranges
    ([0, 4q) forward, [0, 2q) inverse), int32 storage as the blind
    rotations pass them, made from a seeded generator on the card."""
    from primus_fhe_tpu_torch.lattice import tfhe, tfhe64
    from primus_fhe_tpu_torch.ops import ntt32
    from primus_fhe_tpu_torch.transforms.torus import TorusConvolver32

    g = torch.Generator(device=dev).manual_seed(2030)
    calls = {}
    for label, primes, f_rows, i_rows, log_n in NTT32_SHAPES:
        if primes == "torus64":  # phase 18's convolver: gadget 2^16 x 4, k = 1
            primes = tfhe64.make_convolver64(log_n, 4, 1, 16).primes
        elif primes == "kp2":
            primes = TorusConvolver32(log_n, 56).primes
        elif primes == "pbs":  # BOOLEAN_128's gadget at this ring
            primes = tfhe.make_convolver(log_n, 3, 1, 7).primes
        tables = ntt32.NttTables32(log_n, primes)
        n, kp = 1 << log_n, len(primes)
        q = torch.tensor(primes, device=dev).reshape(kp, 1, 1)
        for name, rows, factor, fn in (("forward32", f_rows, 4, ntt32.forward32),
                                       ("inverse32", i_rows, 2, ntt32.inverse32)):
            x = (torch.randint(0, 1 << 40, (kp, rows, n), generator=g, device=dev)
                 % (factor * q)).to(torch.int32)
            words = kp * rows * n
            muls = kp * rows * (n // 2) * log_n * 3
            bound_ms = max(8 * words / HBM_BYTES_S, muls / INT32_MULS_S) * 1e3
            calls[(name, label)] = (lambda f=fn, t=tables, v=x: f(t, v), bound_ms, tables, rows)
    return calls


def ntt32_times(torch, dev) -> dict:
    """Device ms, bound, share of the bound and the launch's tile of rows of
    kernels 1-2 at each shape, and ``fused_cmux_step`` at batch 1 and 64."""
    from primus_fhe_tpu_torch.ops import ntt32

    out = {}
    for (name, label), (fn, bound_ms, tables, rows) in ntt32_calls(torch, dev).items():
        ms = device_ms(torch, fn)
        row = {"ms": ms, "bound_ms": bound_ms, "share": bound_ms / ms}
        if hasattr(ntt32, "launch_tile"):  # an older checkout picks no tile
            row["tile"] = ntt32.launch_tile(tables, rows, name == "forward32")
        out[f"{name}@{label}"] = row
    for (k, b), fn in kernels(torch, dev).items():
        if k == "step":
            out[f"fused_cmux_step@b{b}"] = {"ms": device_ms(torch, fn)}
    # the floor of this timing: a kernel that does nothing, timed the same way
    out["empty kernel"] = {"ms": device_ms(torch, lambda: torch.cuda._sleep(1))}
    return out


def sweep_tiles(torch, calls: dict, force) -> dict:
    """Device ms of each call ``{key: (call, bound ms, the launch's own
    tile)}`` on its own tile and on every tile of 1, 2, 4 and 8 rows set by
    ``force(T)`` (0: the launch's own), None where the launch refuses a tile
    that does not fit in shared memory; every tile's words checked against
    the own tile's."""
    out = {}
    for key, (fn, bound_ms, own) in calls.items():
        force(0)
        want = fn()
        row = {"own": own, "own_ms": device_ms(torch, fn), "bound_ms": bound_ms}
        for tile in (1, 2, 4, 8):
            force(tile)
            try:
                got = fn()
            except RuntimeError:  # the launch refused a tile that does not fit
                row[f"tile{tile}"] = None
                continue
            if not torch.equal(got, want):
                raise SystemExit(f"{key} tile {tile}: words differ")
            row[f"tile{tile}"] = device_ms(torch, fn)
        force(0)
        out[key] = row
    return out


def tile_times(torch, dev) -> dict:
    """In a ``--ntt32 --grids`` copy: kernels 1-2 at each shape on every
    tile (:func:`sweep_tiles`)."""
    import ctypes

    from primus_fhe_tpu_torch.ops import build, ntt32

    lib = build.library()
    lib.pft_ntt32_force_tile.argtypes = [ctypes.c_int]
    calls = {f"{name}@{label}": (fn, bound_ms, ntt32.launch_tile(tables, rows,
                                                                  name == "forward32"))
             for (name, label), (fn, bound_ms, tables, rows) in ntt32_calls(torch, dev).items()}
    return sweep_tiles(torch, calls, lib.pft_ntt32_force_tile)


def tile_times64(torch, dev) -> dict:
    """In a ``--ntt64 --grids`` copy: row 10 at each shape on every tile
    (:func:`sweep_tiles`)."""
    import ctypes

    from primus_fhe_tpu_torch.ops import build

    lib = build.library()
    lib.pft_ntt64_force_tile.argtypes = [ctypes.c_int]
    calls = {f"{name}@{label}": (fn, bound_ms, ntt64_tile(tables, name, x))
             for (name, label), (fn, bound_ms, tables, x, _, _) in ntt_calls(torch, dev).items()
             if name.startswith("ntt64")}
    return sweep_tiles(torch, calls, lib.pft_ntt64_force_tile)


# Row 13's four halves on shard d - 1 of D = d: (label, log_n, q, d, batch).
# At log_n 12 (A = 32 rows of B = 128 lanes): phase 16.2's product (512 rows
# of each polynomial batch, D = 2 and 4, on bench.py's 7-plane q = 2^50 -
# 2^14 + 1 and the 8-plane q) and phase 16.1's forward (batch 64, D = 1, 2,
# 4); at log_n 14 (A = 128: 4 threads a lane in K1 / Ki2) phase 16.5's
# product shards (q = next_ntt_prime(50, 14); the first design refuses them).
SPLIT_Q14 = 1125899904679937
SPLIT_SHAPES = (("D2 b512", 12, NTT_MODULI[0], 2, 512), ("D2 b512 8 planes", 12, Q60, 2, 512),
                ("D4 b512", 12, NTT_MODULI[0], 4, 512), ("D4 b512 8 planes", 12, Q60, 4, 512),
                ("D1 b64", 12, NTT_MODULI[0], 1, 64), ("D2 b64", 12, NTT_MODULI[0], 2, 64),
                ("D4 b64", 12, NTT_MODULI[0], 4, 64), ("n14 D2 b512", 14, SPLIT_Q14, 2, 512),
                ("n14 D4 b512", 14, SPLIT_Q14, 4, 512))
SPLIT_NAMES = ("split_k1", "split_k2", "split_ki1", "split_ki1@nokey", "split_ki2")
# the stamped kernels' kinds: the row kernel's three, then the column kernel's two
SPLIT_KIND = {"split_k2": 0, "split_ki1": 1, "split_ki1@nokey": 2, "split_k1": 3, "split_ki2": 4}
SPLIT_TILES = (4, 8, 16, 32)  # the row kernel's rows a block
SPLIT_THREADS = (64, 128, 256)  # the column kernel's threads a block


def this_smoke():
    """This checkout's ``chip_smoke.py`` (bounds and timing helpers), so that
    both sides of ``--compare`` are timed by the same code."""
    spec = importlib.util.spec_from_file_location("pft_chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sharded_trips(torch, dev) -> dict:
    """Phase 16.2's sharded negacyclic product at ``bench.py``'s shape (n =
    4096, 512 rows, q = 2^50 - 2^14 + 1) on ``LocalMesh(D, 1)``, D = 2 and
    4, from and to coefficient-layout shards: ms a trip over 20 chained
    trips (``chip_smoke.chained_ms``, host-paced), the card's busy ms a trip
    with the host ahead and the host's enqueue ms a trip with the card
    asleep (``chip_smoke.queued_ms``), and the idle share."""
    from primus_fhe_tpu_torch.parallel import LocalMesh, shard
    from primus_fhe_tpu_torch.parallel import coeff_sharded_mxu as csm

    smoke = this_smoke()
    q, log_n, rows = NTT_MODULI[0], 12, 512
    plan = csm.get_sharded_plan(log_n, q)
    g = torch.Generator(device=dev).manual_seed(2032)
    x = torch.randint(0, q, (rows, 1 << log_n), generator=g, device=dev)
    mt = plan.tables.mul_table(torch.randint(0, q, (1, 1 << log_n), generator=g, device=dev))
    out = {}
    for d in (2, 4):
        mesh = LocalMesh(d, 1, dev)

        def step(v, mesh=mesh):
            f = csm.sharded_mxu_forward64(mesh, "residue", log_n, q, v)
            return csm.sharded_mxu_inverse64(mesh, "residue", log_n, q, f, mul_tab=mt)

        v0 = shard(mesh, csm.to_coeff_layout(x, plan.A, plan.B), (None, "residue", None))
        ms = smoke.chained_ms(torch, step, v0, smoke.RT_TRIPS)
        busy, enqueue = smoke.queued_ms(torch, step, v0, smoke.RT_TRIPS, ms)
        out[f"sharded product D={d}"] = {"ms": ms, "device_ms": busy, "enqueue_ms": enqueue,
                                         "idle": None if busy is None else 1 - busy / ms}
    return out


def split_calls(torch, dev) -> dict:
    """``{(name, label): (call, bound ms, rows of the row halves)}`` of the
    four halves (Ki1 with and without the key) at :data:`SPLIT_SHAPES`,
    inputs as phase 16.4 makes them (K1's and Ki2's lanes below q, the row
    halves' rows below 2q) from a seeded generator on the card, each held to
    its function's bound (``chip_smoke.split_bounds``)."""
    from primus_fhe_tpu_torch.ops import ntt_mxu8_split as split
    from primus_fhe_tpu_torch.parallel.coeff_sharded_mxu import get_sharded_plan

    g = torch.Generator(device=dev).manual_seed(2031)
    calls = {}
    for label, log_n, q, d, batch in SPLIT_SHAPES:
        plan = get_sharded_plan(log_n, q)
        tabs, A, B, n = plan.tables, plan.A, plan.B, 1 << log_n
        k0_off, r0_off = plan.offsets(d, d - 1)
        lanes, rows = B // d * batch, A // d * batch
        lane_in = torch.randint(0, q, (1, A, lanes), generator=g, device=dev)
        row_in = torch.randint(0, 2 * q, (1, rows, B), generator=g, device=dev)
        mt = tabs.mul_table(torch.randint(0, q, (1, n), generator=g, device=dev))
        key = mt.reshape(1, 2, A, B)[:, :, r0_off:r0_off + A // d].reshape(1, 2, -1).contiguous()
        split_bounds = this_smoke().split_bounds
        bnd = split_bounds(n, plan.planes, lanes, rows, d, True)
        bnd["split_ki1@nokey"] = split_bounds(n, plan.planes, lanes, rows, d, False)["split_ki1"]
        fns = {
            "split_k1": lambda t=tabs, v=lane_in, b=batch, o=k0_off: split.split_k1(t, v, b, o),
            "split_k2": lambda t=tabs, v=row_in: split.split_k2(t, v),
            "split_ki1": lambda t=tabs, v=row_in, b=batch, o=r0_off, k=key: split.split_ki1(
                t, v, b, o, k),
            "split_ki1@nokey": lambda t=tabs, v=row_in, b=batch, o=r0_off: split.split_ki1(
                t, v, b, o),
            "split_ki2": lambda t=tabs, v=lane_in: split.split_ki2(t, v),
        }
        for name in SPLIT_NAMES:
            calls[(name, label)] = (fns[name], bnd[name][0], rows)
    return calls


# Row 11's stage kernels (--stages): (label, bits, log_n, D, rows, q), each a
# shard's rows of 2^(log_n - log2 D) words on shard 1's table slices.  The
# u64 pair at phase 15's D = 4 shard (2 rows of 2^14 words), the JAX
# kernel's tile of 8 rows, the D = 2 shard (2 rows of 2^15: the first design
# refuses it) and the card tests' smaller shards (log_w 7, 9, 11), each at q
# = 4611686018425815041 (exact Shoup) and a 50-bit q (the forward deferring
# its reductions); the u32 pair at phase 15's shards (8 rows of 2^11, 2^10,
# 2^9 words, q = 536813569) and the large ring's (2 rows of 2^14, 2^15 and
# 2^16 words: n = 2^16 over D = 4, 2 and n = 2^17 over D = 2; 8 rows of
# 2^14), q = 1073479681.  STAGE_GRIDS: the (log2 C, T) grids --grids tries
# beside the launch's own.
STAGE_Q62, STAGE_Q32 = 4611686018425815041, 536813569
STAGE_Q50 = 1125899902124033  # = 1 mod 2^19 (next_ntt_prime(50, 17)): roots to n = 2^18
STAGE_Q32L = 1073479681  # next_ntt_prime(30, 17): = 1 mod 2^18, below 2^30
STAGE_SHAPES = tuple(
    (f"{rows}x2^{log_n - d.bit_length() + 1}{tag}", 64, log_n, d, rows, q)
    for log_n, d, rows in ((16, 4, 2), (16, 4, 8), (16, 2, 2), (9, 4, 2), (12, 8, 2), (12, 2, 2))
    for q, tag in ((STAGE_Q62, ""), (STAGE_Q50, " q50"))) + tuple(
    (f"u32 8x2^{12 - d.bit_length() + 1}", 32, 12, d, 8, STAGE_Q32) for d in (2, 4, 8)) + tuple(
    (f"u32 {rows}x2^{log_n - d.bit_length() + 1}", 32, log_n, d, rows, STAGE_Q32L)
    for log_n, d, rows in ((16, 4, 2), (16, 2, 2), (16, 4, 8), (17, 2, 2)))
STAGE_NAMES = {64: ("ntt64_stages_forward", "ntt64_stages_inverse"),
               32: ("ntt32_stages_forward", "ntt32_stages_inverse")}
STAGE_GRIDS = tuple((c, t) for c in range(4) for t in (1, 2, 4, 8))
COEFF_TRIP_SHARDS = (4, 2)  # chip_smoke.py phase 15.3's trips


def stage_calls(torch, dev) -> dict:
    """``{(name, label): (call, plain call, bound ms, log_w, rows, q)}`` of
    the four stage kernels at :data:`STAGE_SHAPES`: the forward at
    ``out_factor`` 1 on words below 4q, the inverse at ``in_factor`` 2 on
    words below 2q, made from a seeded generator on the card (the u32 pair
    in int32 storage, words and tables, so that a call is its one launch);
    each held to
    its function's bound (``chip_smoke.py``'s b32f / b32i / b64: rows and
    the table entries the function reads once over the HBM rate, or n/2 log
    n Shoup multiplies a row)."""
    from primus_fhe_tpu_torch.numeric.limb import mul_hi_u64
    from primus_fhe_tpu_torch.ops import ntt_stages as st
    from primus_fhe_tpu_torch.parallel import coeff_sharded as cs

    g = torch.Generator(device=dev).manual_seed(2033)
    calls = {}
    for label, bits, log_n, d, rows, q in STAGE_SHAPES:
        log_d = d.bit_length() - 1
        log_w, width = log_n - log_d, (1 << log_n) // d
        cols = slice(width, 2 * width)
        build = (cs.build_expanded_tables64, cs.build_expanded_inverse_tables64) if bits == 64 \
            else (cs.build_expanded_tables32, cs.build_expanded_inverse_tables32)
        w, p = (t[log_d:, cols].to(dev) for t in build[0](log_n, q))
        wi, pi = (t[:log_w, cols].to(dev) for t in build[1](log_n, q))
        words = torch.randint(-(1 << 63), (1 << 63) - 1, (2, rows, width), generator=g,
                              device=dev)
        xf, xi = mul_hi_u64(words[0], 4 * q), mul_hi_u64(words[1], 2 * q)
        size = bits // 8
        muls = rows * (width // 2) * log_w * (10 if bits == 64 else 3)
        # the table entries each function reads (w and its quotient): the u64
        # pair and the u32 inverse one lane of each pair (the x lane's, the
        # y lane's), the u32 forward both
        lanes = (width // 2, width // 2) if bits == 64 else (width, width // 2)
        bound_f, bound_i = (max((size * 2 * rows * width + 2 * size * log_w * n) / HBM_BYTES_S,
                                muls / INT32_MULS_S) * 1e3 for n in lanes)
        fwd, inv = (getattr(st, name) for name in STAGE_NAMES[bits])
        fwd_plain, inv_plain = (getattr(st, name + "_plain") for name in STAGE_NAMES[bits])
        if bits == 32:  # int32 storage in and out: the launch alone, no conversion kernels
            w, p, wi, pi, xf, xi = (t.to(torch.int32) for t in (w, p, wi, pi, xf, xi))
            fwd_plain, inv_plain = (
                lambda lw, q, w, p, x, f=f: f(lw, q, w.long() & 0xFFFFFFFF, p.long() & 0xFFFFFFFF,
                                              x.long() & 0xFFFFFFFF).to(torch.int32)
                for f in (fwd_plain, inv_plain))
        calls[(STAGE_NAMES[bits][0], label)] = (
            lambda f=fwd, lw=log_w, q=q, w=w, p=p, x=xf: f(lw, q, w, p, x),
            lambda f=fwd_plain, lw=log_w, q=q, w=w, p=p, x=xf: f(lw, q, w, p, x),
            bound_f, log_w, rows, q)
        calls[(STAGE_NAMES[bits][1], label)] = (
            lambda f=inv, lw=log_w, q=q, w=wi, p=pi, x=xi: f(lw, q, w, p, x),
            lambda f=inv_plain, lw=log_w, q=q, w=wi, p=pi, x=xi: f(lw, q, w, p, x),
            bound_i, log_w, rows, q)
    return calls


def stage_grid(name, log_w, rows, q):
    """``(C, T)`` the launch picks (None in a checkout without the rule for
    that word type)."""
    import inspect

    from primus_fhe_tpu_torch.ops import ntt_stages as st

    if not hasattr(st, "launch_grid"):
        return None
    if name.startswith("ntt64"):
        return st.launch_grid(log_w, q, rows, name.endswith("forward"))
    if "bits" not in inspect.signature(st.launch_grid).parameters:
        return None
    return st.launch_grid(log_w, q, rows, name.endswith("forward"), 32)


def coeff_trips(torch, dev) -> dict:
    """``chip_smoke.py`` phase 15.3's trips (the coefficient-sharded forward
    then inverse at n = 2^16, 2 rows; u64 at q = 4611686018425815041, u32
    at q = 1073479681) on ``LocalMesh(D, 1)`` at each D of
    :data:`COEFF_TRIP_SHARDS`: ms a trip over 20 chained trips
    (host-paced), the card's busy ms a trip with the host ahead and the
    host's enqueue ms (``chip_smoke.queued_ms``, as many trips queued as
    keep the launch queue from blocking the host), the host ops a trip and
    the idle share; None where the checkout refuses the shard."""
    from primus_fhe_tpu_torch.parallel import LocalMesh, shard
    from primus_fhe_tpu_torch.parallel import coeff_sharded as cs

    smoke = this_smoke()
    log_n, rows = smoke.LARGE_LOG_N, smoke.LARGE_ROWS
    g = torch.Generator(device=dev).manual_seed(2034)
    out = {}
    for bits, q, fwd_fn, inv_fn in (
            ("", smoke.LARGE_Q, cs.coeff_sharded_forward64, cs.coeff_sharded_inverse64),
            ("u32 ", STAGE_Q32L, cs.coeff_sharded_forward32, cs.coeff_sharded_inverse32)):
        x = torch.randint(0, q, (rows, 1 << log_n), generator=g, device=dev)
        for d in COEFF_TRIP_SHARDS:
            mesh = LocalMesh(d, 1, dev)

            def step(v, mesh=mesh, q=q, fwd_fn=fwd_fn, inv_fn=inv_fn):
                f = fwd_fn(mesh, "residue", log_n, q, v)
                return inv_fn(mesh, "residue", log_n, q, f)

            v0 = shard(mesh, x, (None, "residue"))
            try:
                step(v0)
            except ValueError as e:
                out[f"{bits}coeff trip D={d}"] = {"ms": None, "refused": str(e)}
                continue
            ms = smoke.chained_ms(torch, step, v0, smoke.CS_TRIPS)
            ops = smoke.count_host_ops(torch, lambda: step(v0))
            queued = max(1, min(smoke.CS_TRIPS, smoke.QUEUED_OPS // ops))
            busy, enqueue = smoke.queued_ms(torch, step, v0, queued, ms)
            out[f"{bits}coeff trip D={d}"] = {"ms": ms, "device_ms": busy, "enqueue_ms": enqueue,
                                              "host_ops": ops, "queued_trips": queued,
                                              "idle": None if busy is None else 1 - busy / ms}
    return out


# Kernel C's shapes: (label, profile, rows a prime): chip_smoke.py's phase-2
# batch 1 and 64 (2 x 12 and 2 x 768 rows of 2048), BOOLEAN_128's whole
# bootstrap key (2 x 7560) and NTRU_128's evk (1 x 4200 rows of 1024).
KEYPREP_SHAPES = (("2x12", "boolean", 12), ("2x768", "boolean", 768),
                  ("2x7560", "boolean", 7560), ("1x4200", "ntru", 4200))
# Kernel F's shapes: phase 13's 64 x 2 rows, the bootstrap's start (one
# broadcast test row into acc[:, -1, :] of 64 ciphertexts; the start with
# its zero fill too) and 1024 x 2 rows, all of 2048 words.
ROTATE_SHAPES = (("64x2", 64), ("start 64", 64), ("start+zeros 64", 64), ("1024x2", 1024))
# Kernel G's shapes at BOOLEAN_128 (n = 2048, k1 = 2, L = 3, two primes):
# batch 1, phase 13's 64 x 2 rows and F's large 1024 x 2.  FRONT_THREADS:
# the threads a block --front --grids tries.
FRONT_SHAPES = (("1x2", 1), ("64x2", 64), ("1024x2", 1024))
FRONT_THREADS = (32, 64, 128, 256, 512)


def keyprep_calls(torch, dev) -> dict:
    """``{(kernel, label): (call, bound ms, plan, rows)}`` of kernel C
    (``mxu8_forward32``) and kernel 1's canonical forward (``forward32``,
    the same function) on the same canonical words at
    :data:`KEYPREP_SHAPES`, int32 storage, each checked once against the
    plain version."""
    from primus_fhe_tpu_torch.lattice import tfhe
    from primus_fhe_tpu_torch.ops import cmux_mxu, ntru_cmux_mxu, ntt32, ntt_mxu8

    plans = {"boolean": cmux_mxu.plan_for(tfhe.make_convolver(11, 3, 1, 7)),
             "ntru": ntru_cmux_mxu.get_ntru_plan(10, 1038337)}
    g = torch.Generator(device=dev).manual_seed(2031)
    calls = {}
    for label, which, rows in KEYPREP_SHAPES:
        plan = plans[which]
        kp, n = len(plan.primes), plan.n
        q = torch.tensor(plan.primes, device=dev).reshape(kp, 1, 1)
        x = (torch.randint(0, 1 << 40, (kp, rows, n), generator=g, device=dev) % q)
        want = ntt_mxu8.mxu8_forward32_plain(plan, x).reshape(x.shape)
        x = x.to(torch.int32)
        muls = kp * rows * (n // 2) * plan.log_n * 3
        bound_ms = max(8 * x.numel() / HBM_BYTES_S, muls / INT32_MULS_S) * 1e3
        for name, fn in (("mxu8_forward32", lambda p=plan, v=x: ntt_mxu8.mxu8_forward32(p, v)),
                         ("forward32", lambda p=plan, v=x: ntt32.forward32(p.ntt, v))):
            got = fn().reshape(x.shape).to(torch.int64) & 0xFFFFFFFF
            if not torch.equal(got, want):
                raise SystemExit(f"{name}@{label}: words differ from the plain version")
            calls[(name, label)] = (fn, bound_ms, plan, rows)
    return calls


def keyprep_times(torch, dev) -> dict:
    """Device ms, bound and share of kernel C and kernel 1 at each shape,
    C's (tile, grid) and kernel 1's tile, C over kernel 1, and the floor of
    an empty launch timed the same way."""
    from primus_fhe_tpu_torch.ops import ntt32, ntt_mxu8

    out = {}
    calls = keyprep_calls(torch, dev)
    for (name, label), (fn, bound_ms, plan, rows) in calls.items():
        ms = device_ms(torch, fn)
        row = {"ms": ms, "bound_ms": bound_ms, "share": bound_ms / ms}
        if name == "forward32":
            row["tile"] = ntt32.launch_tile(plan.ntt, rows)
        elif hasattr(ntt_mxu8, "launch_grid"):  # an older checkout runs the byte planes
            row["tile_grid"] = ntt_mxu8.launch_grid(plan, rows)
        out[f"{name}@{label}"] = row
    for name in ("mxu8_forward32", "forward32"):  # the whole key, back to back: clocks, power
        out[f"{name}@2x7560"]["sustained"] = sustained_clocks(torch, calls[(name, "2x7560")][0])
    for label, *_ in KEYPREP_SHAPES:
        out[f"C/kernel1@{label}"] = {"ratio": out[f"mxu8_forward32@{label}"]["ms"]
                                     / out[f"forward32@{label}"]["ms"]}
    out["empty kernel"] = {"ms": device_ms(torch, lambda: torch.cuda._sleep(1))}
    return out


def sustained_clocks(torch, fn, seconds: float = 2.0) -> dict:
    """``fn`` back to back for ``seconds`` while ``nvidia-smi`` samples the
    SM clock and the power draw every 100 ms: the mean device ms a call
    over the run (CUDA events) and the samples' least, median and most."""
    import time

    fn()
    torch.cuda.synchronize()
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    time.sleep(0.3)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    calls, t0 = 0, time.perf_counter()
    start.record()
    while time.perf_counter() - t0 < seconds:
        for _ in range(50):
            fn()
        calls += 50
        torch.cuda.synchronize()
    end.record()
    torch.cuda.synchronize()
    smi.terminate()
    out, _ = smi.communicate()
    samples = [tuple(float(x) for x in line.split(",")) for line in out.splitlines()
               if line.count(",") == 1][3:]  # the first ones may predate the run
    clk = sorted(s[0] for s in samples)
    watts = sorted(s[1] for s in samples)
    pick = lambda xs: [xs[0], xs[len(xs) // 2], xs[-1]] if xs else None  # noqa: E731
    return {"ms_a_call": start.elapsed_time(end) / calls, "calls": calls,
            "sm_mhz": pick(clk), "power_w": pick(watts), "samples": len(samples)}


def ptxas_registers(root: Path) -> dict:
    """``{kernel: registers}`` of the newest kernel build under ``root``
    (ptxas's figures in the ``nvcc -Xptxas -v`` log beside the library)."""
    from primus_fhe_tpu_torch.ops.build import ptxas_figures

    logs = sorted((root / "primus_fhe_tpu_torch" / "build").glob("libpft_kernels_*.log"),
                  key=lambda f: f.stat().st_mtime)
    figures = ptxas_figures(logs[-1].read_text() if logs else "")
    return {re.sub(r"_GLOBAL__N__[0-9a-f_]+_", "", k): v.get("registers")
            for k, v in figures.items()}


def rotate_calls(torch, dev) -> dict:
    """``{label: (call, bound ms, plain)}`` of kernel F at
    :data:`ROTATE_SHAPES` (int32 storage), each checked once against the
    plain version.  The bootstrap's start runs as the checkout's blind
    rotation runs it: into ``out=acc[:, -1, :]`` where ``rotate`` takes
    ``out`` (one launch), else a contiguous copy of the broadcast row, the
    rotation and a strided copy into the accumulator."""
    import inspect

    from primus_fhe_tpu_torch.ops import rotate

    n, k1 = 2048, 2
    g = torch.Generator(device=dev).manual_seed(2032)
    takes_out = "out" in inspect.signature(rotate.rotate).parameters
    calls = {}
    for label, bsz in ROTATE_SHAPES:
        deg = torch.randint(-4 * n, 4 * n, (bsz,), generator=g, device=dev, dtype=torch.int32)
        if label.startswith("start"):
            row = torch.randint(0, 1 << 32, (n,), generator=g, device=dev)
            row32, acc = row.to(torch.int32), torch.zeros((bsz, k1, n), dtype=torch.int32,
                                                          device=dev)
            zeros = label.startswith("start+zeros")

            def fn(r=row32, d=deg, a=acc, z=zeros, b=bsz):
                if z:
                    a = torch.zeros((b, k1, n), dtype=torch.int32, device=dev)
                if takes_out:
                    rotate.rotate(r.expand(b, n), d, out=a[:, -1, :])
                else:
                    a[:, -1, :] = rotate.rotate(r.expand(b, n), d)
                return a[:, -1, :]

            want = rotate.rotate_plain(row.expand(bsz, n), deg)
            bound_ms = 4 * (n + bsz * n) / HBM_BYTES_S * 1e3
        else:
            v = torch.randint(0, 1 << 32, (bsz, k1, n), generator=g, device=dev)
            want = rotate.rotate_plain(v, deg)

            def fn(x=v.to(torch.int32), d=deg):
                return rotate.rotate(x, d)

            bound_ms = 8 * v.numel() / HBM_BYTES_S * 1e3
        if not torch.equal(fn().to(torch.int64) & 0xFFFFFFFF, want):
            raise SystemExit(f"rotate@{label}: words differ from the plain version")
        calls[label] = (fn, bound_ms)
    return calls


def launches_seen(torch, fn) -> list:
    """``(count, kernel)`` of every device kernel ``torch.profiler`` sees in
    one call of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.count, e.key[:80]) for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and e.self_device_time_total > 0]


def rotate_times(torch, dev) -> dict:
    """Device ms, bound and share of kernel F at each shape, the launches
    of the bootstrap's start, and the empty-launch floor."""
    out = {}
    for label, (fn, bound_ms) in rotate_calls(torch, dev).items():
        ms = device_ms(torch, fn)
        out[f"rotate@{label}"] = {"ms": ms, "bound_ms": bound_ms, "share": bound_ms / ms}
        if label.startswith("start"):
            seen = launches_seen(torch, fn)
            out[f"rotate@{label}"].update(launches=sum(c for c, _ in seen), kernels=seen)
    out["empty kernel"] = {"ms": device_ms(torch, lambda: torch.cuda._sleep(1))}
    return out


def front_calls(torch, dev) -> dict:
    """``{label: (call, bound ms, rows)}`` of kernel G at
    :data:`FRONT_SHAPES` (int32 storage), each checked once against the
    plain version.  The bound: the bytes once (the accumulator read, the
    kp L residues written) over the HBM rate, the lifts' multiplies beside
    them (bytes bound every shape)."""
    from primus_fhe_tpu_torch import params as P
    from primus_fhe_tpu_torch.decompose import ApproxSignedBasis32
    from primus_fhe_tpu_torch.lattice import tfhe
    from primus_fhe_tpu_torch.ops import cmux_front

    p = P.BOOLEAN_128
    basis = ApproxSignedBasis32(None, p.log_basis, reverse_length=p.level)
    primes = tfhe.make_convolver(p.log_n, p.level, p.glwe_dim, p.log_basis).primes
    n, k1, kp, level = p.n, p.glwe_dim + 1, len(primes), p.level
    g = torch.Generator(device=dev).manual_seed(2033)
    calls = {}
    for label, bsz in FRONT_SHAPES:
        acc = torch.randint(0, 1 << 32, (bsz, k1, n), generator=g, device=dev)
        deg = torch.randint(-4 * n, 4 * n + 1, (bsz,), generator=g, device=dev,
                            dtype=torch.int32)

        def fn(a=acc.to(torch.int32), d=deg):
            return cmux_front.cmux_front(a, d, basis, primes)

        want = cmux_front.cmux_front_plain(acc, deg, basis, primes)
        if not torch.equal(fn().to(torch.int64) & 0xFFFFFFFF, want):
            raise SystemExit(f"cmux_front@{label}: words differ from the plain version")
        words = acc.numel()
        bound_ms = max(4 * words * (1 + kp * level) / HBM_BYTES_S,
                       5 * kp * level * words / INT32_MULS_S) * 1e3
        calls[label] = (fn, bound_ms, bsz * k1)
    return calls


def front_times(torch, dev) -> dict:
    """Device ms, bound and share of kernel G at each shape with the
    launch's (mode, threads a block, blocks), kernel F at phase 13's 64 x 2 beside it,
    the empty-launch floor, and ptxas's figures for every G instance."""
    from primus_fhe_tpu_torch.ops import build, cmux_front, rotate

    out = {}
    for label, (fn, bound_ms, rows) in front_calls(torch, dev).items():
        ms = device_ms(torch, fn)
        out[f"cmux_front@{label}"] = {"ms": ms, "bound_ms": bound_ms, "share": bound_ms / ms}
        if hasattr(cmux_front, "launch_grid"):  # an older checkout launches a block a row
            out[f"cmux_front@{label}"]["grid"] = cmux_front.launch_grid(rows, 11)
    g = torch.Generator(device=dev).manual_seed(2034)
    v = torch.randint(0, 1 << 32, (64, 2, 2048), generator=g, device=dev).to(torch.int32)
    deg = torch.randint(-8192, 8193, (64,), generator=g, device=dev, dtype=torch.int32)
    out["rotate@64x2"] = {"ms": device_ms(torch, lambda: rotate.rotate(v, deg))}
    out["empty kernel"] = {"ms": device_ms(torch, lambda: torch.cuda._sleep(1))}
    out.update(ntru_rotations(torch, dev))
    log = build.build()[2]
    out["ptxas"] = {re.sub(r"_ZN12_GLOBAL__N_1\d+", "", k): v for k, v in (
        build.ptxas_figures(log) if hasattr(build, "ptxas_figures") else {}).items()
        if "cmux_front_kernel" in k}
    return out


def stamp_front(src: Path) -> None:
    """clock64() laps of thread 0 of block 0 of kernel G in its group mode:
    the degree's arrival, the window and own loads' (the diff ready), the
    digits and lifts of each store and each store's issue (summed over the
    kp L stores); its total cycles; the launch's span on the global timer;
    a C entry ``pft_read_g_laps`` that reads them and resets the span."""
    text = src.read_text()
    head = ("__device__ long long pft_g_laps[5];\n"
            "__device__ unsigned long long pft_g_gt[2] = {~0ull, 0ull};\n"
            "#define PFT_G_LAP(k) if (pft_on) { const long long t1 = clock64(); "
            "pft_acc[k] += t1 - pft_t; pft_t = t1; }\n")
    degree = ("    const int row = (int)(it >> lg), c = (int)(it & ((1 << lg) - 1)) << 2;\n"
              "    const int d = __ldg(a.degrees + ciphertext_of(row, a)) & (2 * n - 1);  // mod 2n, "
              "any sign\n")
    diff = "    const uint32_t diff[4] = {r.x - own.x, r.y - own.y, r.z - own.z, r.w - own.w};\n"
    store = ("        store4(o + pi * plane, make_uint4(lift_signed(digit[0], p), "
             "lift_signed(digit[1], p),\n"
             "                                          lift_signed(digit[2], p), "
             "lift_signed(digit[3], p)));\n      }\n    }\n")
    for anchor in (degree, diff, store):
        if text.count(anchor) != 1:
            raise SystemExit(f"cmux_mxu_timing: {src.name} changed near {anchor.strip()!r}")
    text = text.replace(degree, (
        "    const bool pft_on = blockIdx.x == 0 && threadIdx.x == 0;\n"
        "    long long pft_acc[4] = {0, 0, 0, 0};\n"
        "    long long pft_t = clock64();\n    const long long pft_t0 = pft_t;\n"
        "    unsigned long long pft_g0;\n"
        "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(pft_g0));\n")
        + degree + "    if (d >= 0) { PFT_G_LAP(0) }  // d has arrived\n")
    text = text.replace(diff, diff + "    if ((diff[0] | 1) != 0) { PFT_G_LAP(1) }\n")
    text = text.replace(store, (
        "        const uint4 pft_v = make_uint4(lift_signed(digit[0], p), "
        "lift_signed(digit[1], p),\n"
        "                                       lift_signed(digit[2], p), "
        "lift_signed(digit[3], p));\n"
        "        if ((pft_v.x | 1) != 0) { PFT_G_LAP(2) }\n"
        "        store4(o + pi * plane, pft_v);\n        PFT_G_LAP(3)\n"
        "      }\n    }\n"
        "    if (pft_on) {\n      for (int k = 0; k < 4; ++k) pft_g_laps[k] = pft_acc[k];\n"
        "      pft_g_laps[4] = clock64() - pft_t0;\n    }\n"
        "    if (threadIdx.x == 0) {\n      unsigned long long pft_g1;\n"
        "      asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(pft_g1));\n"
        "      atomicMin(&pft_g_gt[0], pft_g0);\n      atomicMax(&pft_g_gt[1], pft_g1);\n"
        "    }\n"))
    text = text.replace("namespace {\n", head + "namespace {\n", 1)
    reader = ("int pft_read_g_laps(void* laps, void* gt) {\n"
              "  cudaError_t e = cudaMemcpyFromSymbol(laps, pft_g_laps, sizeof(pft_g_laps));\n"
              "  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(gt, pft_g_gt, 16);\n"
              "  const unsigned long long reset[2] = {~0ull, 0ull};\n"
              "  if (e == cudaSuccess) e = cudaMemcpyToSymbol(pft_g_gt, reset, 16);\n"
              "  return (int)e;\n}\n")
    text = text.replace('extern "C" {\n', 'extern "C" {\n\n' + reader, 1)
    src.write_text(text)


def stamp_front_grids(src: Path, write_back: bool) -> None:
    """Adds to kernel G's C entry a block size set from outside the launch
    (``pft_g_force(T)``, 0 for the launch's own); with ``write_back``, G's
    16-byte stores are write-back stores in place of streaming ones
    (``st.global.cs``)."""
    text = src.read_text()
    pick = "  const FrontLaunch f = front_pick(a.rows, log_n, ((uintptr_t)acc & 15) == 0);\n"
    store = "  __stcs(reinterpret_cast<uint4*>(p), v);\n"
    for anchor in (pick, store):
        if text.count(anchor) != 1:
            raise SystemExit(f"cmux_mxu_timing: {src.name} changed near {anchor.strip()!r}")
    text = text.replace(pick, pick.replace("const FrontLaunch", "FrontLaunch") + (
        "  if (pft_g_t > 0) {\n"
        "    f.grid = (f.grid * f.threads + pft_g_t - 1) / pft_g_t;\n"
        "    f.threads = pft_g_t;\n  }\n"))
    if write_back:
        text = text.replace(store, "  *reinterpret_cast<uint4*>(p) = v;\n")
    text = text.replace("namespace {\n", "int pft_g_t = 0;\nnamespace {\n", 1)
    text = text.replace('extern "C" {\n', 'extern "C" {\n\nint pft_g_force(int t) {\n'
                        '  pft_g_t = t;\n  return 0;\n}\n', 1)
    src.write_text(text)


def front_grids(torch, dev) -> dict:
    """In a ``--front --grids`` copy: kernel G at each shape on every block
    size of :data:`FRONT_THREADS`, each checked against the launch's own
    words."""
    import ctypes

    from primus_fhe_tpu_torch.ops import build, cmux_front

    force = build.library().pft_g_force
    force.argtypes = [ctypes.c_int]
    out = {}
    for label, (fn, bound_ms, rows) in front_calls(torch, dev).items():
        force(0)
        want = fn()
        row = {"own": cmux_front.launch_grid(rows, 11), "own_ms": device_ms(torch, fn),
               "bound_ms": bound_ms}
        for t in FRONT_THREADS:
            force(t)
            if not torch.equal(fn(), want):
                raise SystemExit(f"{label} T {t}: words differ")
            row[f"T{t}"] = device_ms(torch, fn)
        force(0)
        out[f"cmux_front@{label}"] = row
    return out


def front_stamps(torch, dev) -> dict:
    """In a ``--front --phases`` copy: block 0's thread 0 cycles of kernel G
    at each shape, one group (:func:`stamp_front`)."""
    def names(laps):
        return {**{k: laps[i] for i, k in enumerate(
            ("degree", "windows + own", "digits + lifts", "store issue"))},
            "total_cycles": laps[4]}

    calls = {f"cmux_front@{label}": fn for label, (fn, *_) in front_calls(torch, dev).items()}
    return read_laps(torch, "pft_read_g_laps", 5, calls, names)


# --stage2: kernel H at chip_smoke.py phase 21.2's shapes (label, log_n,
# log_basis, level, k, make_convolver's bound bits or None, batch): the
# widened BOOLEAN_128 ring at batch 1 and 16, the ring at 2^16 over 3
# primes, k = 2 over 3 primes and a 2^1 x 20 gadget; kernel J at phase
# 22.5's (NTRU_128's gadget at N = 2^13, batch 1 and 16)
STAGE2_H_SHAPES = (("2^15 b1", 15, 7, 3, 1, None, 1), ("2^15 b16", 15, 7, 3, 1, None, 16),
                   ("2^16 kp3 b2", 16, 7, 3, 1, 60, 2), ("2^16 kp3 b16", 16, 7, 3, 1, 60, 16),
                   ("2^10 k2 kp3 b2", 10, 7, 3, 2, 60, 2), ("2^10 L20 b2", 10, 1, 20, 1, None, 2))
STAGE2_J_SHAPES = (("2^13 b1", 13, 1), ("2^13 b16", 13, 16))
STAGE2_LAPS = ("MAC", "inverse", "CRT / rotation")


def stage2_calls(torch, dev) -> dict:
    """``{name@label: (call, bound ms, grid)}`` of kernels H and J at
    :data:`STAGE2_H_SHAPES` / :data:`STAGE2_J_SHAPES` on int32 storage,
    each checked once against its plain version; the bounds are
    ``chip_smoke.py``'s (``stage2_bound``, ``ntru_stage2_bound``), the grid
    the checkout's ``launch_grid`` (blocks a row, threads, shared bytes and,
    for H, clusters held)."""
    import dataclasses
    import inspect

    from primus_fhe_tpu_torch import params as P
    from primus_fhe_tpu_torch.lattice import tfhe
    from primus_fhe_tpu_torch.ops import cmux_fused, ntru_cmux_mxu
    from primus_fhe_tpu_torch.ops.ntt32 import NttTables32
    from primus_fhe_tpu_torch.transforms.torus import TorusConvolver32

    smoke = this_smoke()
    g = torch.Generator(device=dev).manual_seed(2035)

    def residues(primes, shape, factor):
        q = torch.tensor(primes, dtype=torch.int64, device=dev).reshape((-1,) + (1,) * len(shape))
        return torch.randint(0, 1 << 40, (len(primes),) + shape, generator=g, device=dev) % (
            factor * q)

    by_batch = len(inspect.signature(cmux_fused.launch_grid).parameters) > 1
    calls = {}
    for label, log_n, log_basis, level, k, bits, bsz in STAGE2_H_SHAPES:
        conv = (TorusConvolver32(log_n, bits) if bits
                else tfhe.make_convolver(log_n, level, k, log_basis))
        n, kp, k1 = 1 << log_n, conv.count, k + 1
        f = residues(conv.primes, (bsz * k1, level, n), 4)
        key = residues(conv.primes, (k1, level, k1, n), 1)
        acc = torch.randint(0, 1 << 32, (bsz, k1, n), generator=g, device=dev)
        want = cmux_fused.cmux_stage2_plain(conv, f, key, acc)
        f32, key32, acc32 = f.to(torch.int32), key.to(torch.int32), acc.to(torch.int32)

        def fn(conv=conv, f32=f32, key32=key32, acc32=acc32):
            return cmux_fused.cmux_stage2(conv, f32, key32, acc32)

        if not torch.equal(fn().to(torch.int64) & 0xFFFFFFFF, want):
            raise SystemExit(f"cmux_stage2@{label}: words differ from the plain version")
        grid = cmux_fused.launch_grid(conv, k1, bsz) if by_batch else cmux_fused.launch_grid(conv)
        calls[f"cmux_stage2@{label}"] = (fn, smoke.stage2_bound(kp, bsz, k1, level, n)[0], grid)
    # J as the checkout's staged step runs it: with the next step's digits
    # over its input where the checkout's J writes them
    digits = "basis" in inspect.signature(ntru_cmux_mxu.ntru_stage2).parameters
    for label, log_n, bsz in STAGE2_J_SHAPES:
        pw = dataclasses.replace(P.NTRU_128, log_n=log_n)
        nctx = P.make_ntru_context(pw)[0]
        q, n, level = pw.q, 1 << log_n, pw.level
        tables = NttTables32(log_n, (q,))
        f = torch.randint(0, 4 * q, (level, bsz, n), generator=g, device=dev)
        evk = torch.randint(0, q, (level, n), generator=g, device=dev)
        acc = torch.randint(0, q, (bsz, n), generator=g, device=dev)
        deg = torch.randint(0, 2 * n, (bsz,), generator=g, device=dev, dtype=torch.int32)
        want = ntru_cmux_mxu.ntru_stage2_plain(tables, f, evk, acc, deg)
        f32, evk32, acc32 = f.to(torch.int32), evk.to(torch.int32), acc.to(torch.int32)
        kw = {"basis": nctx.basis} if digits else {}

        def fn(tables=tables, f32=f32, evk32=evk32, acc32=acc32, deg=deg, kw=kw):
            return ntru_cmux_mxu.ntru_stage2(tables, f32, evk32, acc32, deg, **kw)

        if not torch.equal(fn().to(torch.int64), want):
            raise SystemExit(f"ntru_stage2@{label}: words differ from the plain version")
        grid = (ntru_cmux_mxu.launch_grid(log_n, bsz) if len(inspect.signature(
            ntru_cmux_mxu.launch_grid).parameters) > 1 else ntru_cmux_mxu.launch_grid(log_n))
        j_bound = smoke.ntru_stage2_bound(bsz, level, n)[0]
        calls[f"ntru_stage2@{label}"] = (fn, j_bound, grid)
        # the staged step after the rotation's first: I, kernel 1 and J (3
        # launches) before the digits moved into J, kernel 1 and J after
        step = ntru_cmux_mxu.NtruStepPlan(nctx, dev)
        run = acc32.clone()
        plain = ntru_cmux_mxu.ntru_cmux_step_plain(ntru_cmux_mxu.get_ntru_plan(log_n, q),
                                                   nctx.basis, acc, deg, evk)
        if not torch.equal(step(run, deg, evk32, None).to(torch.int64), plain):
            raise SystemExit(f"ntru_step@{label}: words differ from the plain step")

        def sfn(step=step, run=run, deg=deg, evk32=evk32):
            return step(run, deg, evk32, None)

        # kernel 1's digits in place, then J's bound
        calls[f"ntru_step@{label}"] = (sfn, smoke.bound(8 * level * bsz * n)[0] + j_bound, grid)
    return calls


def ntru_rotations(torch, dev) -> dict:
    """The NTRU staged rotation at :data:`STAGE2_J_SHAPES`' ring (NTRU_128's
    gadget, n_lwe and sigmas at N = 2^13, ``chip_smoke.py`` phase 22.5's),
    batch 1 and 16 on the MXU evk: ``{"ntru_rotation@b<B>": {"ms": least of
    3 synchronised host-clock runs}, "ntru_rotation_busy@b<B>": {"ms": the
    device time ``torch.profiler`` sees in one run}}``."""
    import dataclasses
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from primus_fhe_tpu_torch import params as P
    from primus_fhe_tpu_torch.boot import ntru_blind_rotate as nbr

    log_n = STAGE2_J_SHAPES[0][1]
    pw = dataclasses.replace(P.NTRU_128, log_n=log_n)
    g = torch.Generator(device=dev).manual_seed(2036)
    keys = P.make_ntru_keys(pw, dev, g)
    q, n = keys.ctx.q_int, 1 << log_n
    tp = nbr.ntru_test_polynomial(n, q, (q - 1) // 8, dev)
    out = {}
    for bsz in (1, 16):
        ct = keys.encrypt(torch.randint(0, 2, (bsz,), generator=g, device=dev), g)
        sw = nbr.modulus_switch_q(ct, keys.ctx, log_n + 1)

        def fn(sw=sw):
            return nbr.ntru_blind_rotate(keys.ctx, keys.evk_mxu, sw, tp)

        fn()
        wall = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type != DeviceType.CPU) / 1e3
        out[f"ntru_rotation@b{bsz}"] = {"ms": min(wall)}
        out[f"ntru_rotation_busy@b{bsz}"] = {"ms": busy}
    return out


def stage2_times(torch, dev) -> dict:
    """Device ms, bound and share of kernels H and J at each shape, with the
    launch's grid, the empty-launch floor, and ptxas's figures for every H
    and J instance."""
    from primus_fhe_tpu_torch.ops import build

    out = {}
    for key, (fn, bound_ms, grid) in stage2_calls(torch, dev).items():
        ms = device_ms(torch, fn)
        out[key] = {"ms": ms, "bound_ms": bound_ms, "share": bound_ms / ms, "grid": list(grid)}
    out["empty kernel"] = {"ms": device_ms(torch, lambda: torch.cuda._sleep(1))}
    out.update(ntru_rotations(torch, dev))
    log = build.build()[2]
    out["ptxas"] = {re.sub(r"_ZN12_GLOBAL__N_1\d+", "", k): v for k, v in (
        build.ptxas_figures(log) if hasattr(build, "ptxas_figures") else {}).items()
        if "cmux_stage2_kernel" in k or "ntru_stage2_kernel" in k}
    return out


def stamp_stage2(src: Path, kernel: str, tag: str) -> None:
    """clock64() laps of thread 0 in every block of ``kernel`` (H's or J's
    body in ``src``): from its start to the line ``// 2.`` (the MAC and its
    barrier), to ``// 3.`` (the inverse and its barrier), to the body's end
    (the CRT or the rotation and the last cluster barrier); block 0's laps
    and each lap's largest over the blocks, the launch's span on the global
    timer, and a C entry ``pft_read_<tag>_laps`` that reads them and resets
    the span and the largest laps."""
    text = src.read_text()
    start = text.index(f"{kernel}(const Stage2Args a) {{\n")
    body0 = text.index("\n", start) + 1
    end = text.index("\n}\n", body0) + 1
    body = text[body0:end]
    for mark in ("  // 2.", "  // 3."):
        if body.count(mark) != 1:
            raise SystemExit(f"cmux_mxu_timing: {src.name} {kernel} lost its {mark!r} line")
    lap = ("  if (threadIdx.x == 0) {{ const long long pft_t1 = clock64(); "
           "pft_laps[{k}] = pft_t1 - pft_t; pft_t = pft_t1; }}\n")
    body = body.replace("  // 2.", lap.format(k=0) + "  // 2.", 1)
    body = body.replace("  // 3.", lap.format(k=1) + "  // 3.", 1)
    body = (f"  long long pft_t = clock64(), pft_laps[3] = {{0, 0, 0}};\n"
            "  unsigned long long pft_g0 = 0;\n"
            "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(pft_g0));\n" + body
            + lap.format(k=2)
            + "  if (threadIdx.x == 0) {\n"
            "    unsigned long long pft_g1;\n"
            "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(pft_g1));\n"
            f"    atomicMin(&pft_{tag}_gt[0], pft_g0);\n"
            f"    atomicMax(&pft_{tag}_gt[1], pft_g1);\n"
            "    for (int k = 0; k < 3; ++k) {\n"
            f"      if (blockIdx.x == 0) pft_{tag}_laps[k] = pft_laps[k];\n"
            f"      atomicMax(&pft_{tag}_laps[3 + k], pft_laps[k]);\n"
            "    }\n  }\n")
    # a `return` inside the body would skip the laps: the kernels have none
    if "return;" in body:
        raise SystemExit(f"cmux_mxu_timing: {src.name} {kernel} returns early")
    text = text[:body0] + body + text[end:]
    head = (f"__device__ long long pft_{tag}_laps[6];\n"
            f"__device__ unsigned long long pft_{tag}_gt[2] = {{~0ull, 0ull}};\n")
    text = text.replace("namespace {\n", head + "namespace {\n", 1)
    reader = (f"int pft_read_{tag}_laps(void* laps, void* gt) {{\n"
              f"  cudaError_t e = cudaMemcpyFromSymbol(laps, pft_{tag}_laps, "
              f"sizeof(pft_{tag}_laps));\n"
              f"  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(gt, pft_{tag}_gt, 16);\n"
              "  const unsigned long long reset[2] = {~0ull, 0ull};\n"
              "  const long long zero[6] = {0, 0, 0, 0, 0, 0};\n"
              f"  if (e == cudaSuccess) e = cudaMemcpyToSymbol(pft_{tag}_gt, reset, 16);\n"
              f"  if (e == cudaSuccess) e = cudaMemcpyToSymbol(pft_{tag}_laps, zero, 48);\n"
              "  return (int)e;\n}\n")
    text = text.replace('extern "C" {\n', 'extern "C" {\n\n' + reader, 1)
    src.write_text(text)


def stamp_stage2_grids(src: Path, pick: str, held: str, tag: str) -> None:
    """Adds to the C entry's slice rule ``pick`` (``h_pick`` / ``j_pick``)
    a lc set from outside (``pft_<tag>_force(lc)``, -1 for the rule's own):
    the launch then takes 2^lc slices a row where the card holds the
    cluster (``held``'s answer), else it is refused."""
    text = src.read_text()
    head = re.search(rf"int {pick}\([^)]*\) {{\n", text)
    if head is None:
        raise SystemExit(f"cmux_mxu_timing: {src.name} lost {pick}")
    text = (text[:head.start()] + "int pft_force_lc = -1;\n" + head.group(0)
            + "  if (pft_force_lc >= 0) {\n    *lc = pft_force_lc;\n"
            + f"    const int e = {held};\n"
            + "    return e != 0 ? e : *held < 1 ? (int)cudaErrorInvalidConfiguration : 0;\n  }\n"
            + text[head.end():])
    text = text.replace('extern "C" {\n', f'extern "C" {{\n\nint pft_{tag}_force(int lc) {{\n'
                        "  pft_force_lc = lc;\n  return 0;\n}\n", 1)
    src.write_text(text)


def stage2_grids(torch, dev) -> dict:
    """In a ``--stage2 --grids`` copy: kernels H and J at each shape on
    every lc of 0-4 (2^lc slices a row) beside the rule's own, each checked
    against the rule's words (None where the card refuses the cluster)."""
    import ctypes

    from primus_fhe_tpu_torch.ops import build

    lib = build.library()
    out = {}
    for key, (fn, bound_ms, grid) in stage2_calls(torch, dev).items():
        force = getattr(lib, "pft_h_force" if key.startswith("cmux") else "pft_j_force")
        force.argtypes = [ctypes.c_int]
        force(-1)
        want = fn()
        row = {"own": list(grid), "own_ms": device_ms(torch, fn), "bound_ms": bound_ms}
        for lc in range(5):
            force(lc)
            try:
                got = fn()
            except (RuntimeError, ValueError):
                row[f"C{1 << lc}"] = None
                continue
            if not torch.equal(got, want):
                raise SystemExit(f"{key} lc {lc}: words differ")
            row[f"C{1 << lc}"] = device_ms(torch, fn)
        force(-1)
        out[key] = row
    return out


def stage2_stamps(torch, dev) -> dict:
    """In a ``--stage2 --phases`` copy: block 0's thread 0 cycles of kernels
    H and J at each shape per phase (:func:`stamp_stage2`), each phase's
    largest over the blocks, the launch's span and the event-timed ms."""
    def names(laps):
        return {**{k: laps[i] for i, k in enumerate(STAGE2_LAPS)},
                **{f"{k} (largest block)": laps[3 + i] for i, k in enumerate(STAGE2_LAPS)}}

    calls = stage2_calls(torch, dev)
    out = read_laps(torch, "pft_read_h_laps", 6, {k: v[0] for k, v in calls.items()
                                                  if k.startswith("cmux")}, names)
    out.update(read_laps(torch, "pft_read_j_laps", 6, {k: v[0] for k, v in calls.items()
                                                       if k.startswith("ntru")}, names))
    for k, v in out.items():
        v["grid"] = list(calls[k][2])
    return out


def stamp_keyprep(src: Path) -> None:
    """clock64() laps of thread 0 of block 0 of kernel C, summed over the
    block's tiles: the wait for a tile's rows (its mbarrier), pass 1 with
    the table wait and barrier, the middle passes, the last pass with the
    store's issue; the tiles it ran and its total cycles; the launch's span
    on the global timer (earliest block start to latest block end); a C
    entry ``pft_read_c_laps`` that reads them and resets the span."""
    text = src.read_text()
    head = ("__device__ long long pft_c_laps[6];\n"
            "__device__ unsigned long long pft_c_gt[2] = {~0ull, 0ull};\n"
            "#define PFT_C_LAP(k) if (pft_on) { const long long t1 = clock64(); "
            "pft_acc[k] += t1 - pft_t; pft_t = t1; }\n")
    edits = [
        ("  if (threadIdx.x == 0 && first < last) load(first, 0);\n",
         "  const bool pft_on = blockIdx.x == 0 && threadIdx.x == 0;\n"
         "  long long pft_acc[5] = {0, 0, 0, 0, 0};\n"
         "  long long pft_t = clock64();\n  const long long pft_t0 = pft_t;\n"
         "  unsigned long long pft_g0;\n"
         "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(pft_g0));\n"),
        ("    mbar_wait(smem_addr(bars + s), (i / C_SLOTS) & 1);\n", "    PFT_C_LAP(0)\n"),
        ("    __syncthreads();\n    c_middle<LOG_N, 3, R>(count, table, q, rows);\n",
         "    PFT_C_LAP(2)\n"),
        ("      bulk_store(a.out + offset_of(item), smem_addr(slot), (uint32_t)count << (LOG_N + 2));"
         "\n", "    PFT_C_LAP(3)\n    if (pft_on) pft_acc[4] += 1;\n"),
        ("  if (threadIdx.x == 0) bulk_wait<0, false>();\n",
         "  if (pft_on) {\n    for (int k = 0; k < 5; ++k) pft_c_laps[k] = pft_acc[k];\n"
         "    pft_c_laps[5] = clock64() - pft_t0;\n  }\n"
         "  if (threadIdx.x == 0) {\n    unsigned long long pft_g1;\n"
         "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(pft_g1));\n"
         "    atomicMin(&pft_c_gt[0], pft_g0);\n    atomicMax(&pft_c_gt[1], pft_g1);\n  }\n"),
    ]
    for anchor, after in edits:
        if text.count(anchor) != 1:
            raise SystemExit(f"cmux_mxu_timing: {src.name} changed near {anchor.strip()!r}")
        if "c_middle" in anchor:  # pass 1's lap after its barrier, the middle's after them
            cut = anchor.index("    c_middle")
            text = text.replace(anchor, anchor[:cut] + "    PFT_C_LAP(1)\n" + anchor[cut:] + after)
        else:
            text = text.replace(anchor, anchor + after)
    text = text.replace("namespace {\n", head + "namespace {\n", 1)
    reader = ("int pft_read_c_laps(void* laps, void* gt) {\n"
              "  cudaError_t e = cudaMemcpyFromSymbol(laps, pft_c_laps, sizeof(pft_c_laps));\n"
              "  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(gt, pft_c_gt, 16);\n"
              "  const unsigned long long reset[2] = {~0ull, 0ull};\n"
              "  if (e == cudaSuccess) e = cudaMemcpyToSymbol(pft_c_gt, reset, 16);\n"
              "  return (int)e;\n}\n")
    text = text.replace('extern "C" {\n', 'extern "C" {\n\n' + reader, 1)
    src.write_text(text)


def stamp_rotate(src: Path) -> None:
    """clock64() laps of thread 0 of block 0 of kernel F in its group mode:
    from its start to its degree's arrival, then its groups; the launch's
    span on the global timer; a C entry ``pft_read_f_laps`` that reads them
    and resets the span."""
    text = src.read_text()
    head = ("__device__ long long pft_f_laps[2];\n"
            "__device__ unsigned long long pft_f_gt[2] = {~0ull, 0ull};\n")
    begin = "  const int count = min(a.block_rows, a.total - r0);\n"
    degree = ("        __ldg(a.degrees + min(r0 + (int)(threadIdx.x >> lg), a.total - 1) / a.rows), "
              "n);\n")
    end = "      *reinterpret_cast<uint4*>(a.out + row * a.out_stride + c) = v;\n    }\n"
    for anchor in (begin, degree, end):
        if text.count(anchor) != 1:
            raise SystemExit(f"cmux_mxu_timing: {src.name} changed near {anchor.strip()!r}")
    text = text.replace(begin, begin + (
        "  const bool pft_on = blockIdx.x == 0 && threadIdx.x == 0;\n"
        "  const long long pft_t0 = clock64();\n  long long pft_t1 = pft_t0;\n"
        "  unsigned long long pft_g0;\n"
        "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(pft_g0));\n"))
    text = text.replace(degree, degree + "    if (d >= 0) pft_t1 = clock64();  // d has arrived\n")
    text = text.replace(end, end + (
        "    if (pft_on) {\n      pft_f_laps[0] = pft_t1 - pft_t0;\n"
        "      pft_f_laps[1] = clock64() - pft_t1;\n    }\n"
        "    if (threadIdx.x == 0) {\n      unsigned long long pft_g1;\n"
        "      asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(pft_g1));\n"
        "      atomicMin(&pft_f_gt[0], pft_g0);\n      atomicMax(&pft_f_gt[1], pft_g1);\n    }\n"))
    text = text.replace("namespace {\n", head + "namespace {\n", 1)
    reader = ("int pft_read_f_laps(void* laps, void* gt) {\n"
              "  cudaError_t e = cudaMemcpyFromSymbol(laps, pft_f_laps, sizeof(pft_f_laps));\n"
              "  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(gt, pft_f_gt, 16);\n"
              "  const unsigned long long reset[2] = {~0ull, 0ull};\n"
              "  if (e == cudaSuccess) e = cudaMemcpyToSymbol(pft_f_gt, reset, 16);\n"
              "  return (int)e;\n}\n")
    text = text.replace('extern "C" {\n', 'extern "C" {\n\n' + reader, 1)
    src.write_text(text)


def stamp_keyprep_grids(src: Path) -> None:
    """Adds to kernel C's C entry a tile set from outside the launch
    (``pft_c_force_tile(T)``, 0 for the launch's own), its grid the wave of
    blocks the card holds at T, capped at the items."""
    text = src.read_text()
    pick = "  c_pick(kp, rows, log_n, *d, &a.tile, &grid);\n"
    if text.count(pick) != 1:
        raise SystemExit(f"cmux_mxu_timing: {src.name}'s pick moved")
    force = ("  if (pft_c_force > 0) {\n    int i = 0;\n    while ((1 << i) < pft_c_force) ++i;\n"
             "    const long items = (long)kp * ((rows + pft_c_force - 1) / pft_c_force);\n"
             "    const long wave = (long)d->sms * d->c_resident[log_n][i];\n"
             "    if (wave == 0) return (int)cudaErrorInvalidValue;\n"
             "    a.tile = pft_c_force;\n    grid = (int)(items < wave ? items : wave);\n  }\n")
    text = text.replace(pick, pick + force)
    text = text.replace("namespace {\n", "int pft_c_force = 0;\nnamespace {\n", 1)
    text = text.replace('extern "C" {\n', 'extern "C" {\n\nint pft_c_force_tile(int t) {\n'
                        '  pft_c_force = t;\n  return 0;\n}\n', 1)
    src.write_text(text)


def keyprep_grids(torch, dev) -> dict:
    """In a ``--keyprep --grids`` copy: kernel C at each shape on every tile
    of 1, 2, 4 and 8 rows (None where it does not fit), each tile's words
    checked against the launch's own."""
    import ctypes

    from primus_fhe_tpu_torch.ops import build, ntt_mxu8

    force = build.library().pft_c_force_tile
    force.argtypes = [ctypes.c_int]
    out = {}
    for (name, label), (fn, bound_ms, plan, rows) in keyprep_calls(torch, dev).items():
        if name != "mxu8_forward32":
            continue
        force(0)
        want = fn()
        row = {"own": ntt_mxu8.launch_grid(plan, rows), "own_ms": device_ms(torch, fn),
               "bound_ms": bound_ms}
        for tile in (1, 2, 4, 8):
            force(tile)
            try:
                got = fn()
            except RuntimeError:  # the tile does not fit
                row[f"tile{tile}"] = None
                continue
            if not torch.equal(got, want):
                raise SystemExit(f"{label} tile {tile}: words differ")
            row[f"tile{tile}"] = device_ms(torch, fn)
        force(0)
        out[f"mxu8_forward32@{label}"] = row
    return out


def read_laps(torch, entry: str, count: int, calls: dict, names) -> dict:
    """In a stamped copy: for each call ``{key: fn}``, its event-timed
    device ms, then one more call's laps (``count`` words from ``entry``)
    named by ``names(laps)`` and its span on the device (ns)."""
    import ctypes

    from primus_fhe_tpu_torch.ops import build

    read = getattr(build.library(), entry)
    read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    out = {}
    for key, fn in calls.items():
        ms = device_ms(torch, fn)
        laps = (ctypes.c_longlong * count)()
        gt = (ctypes.c_ulonglong * 2)()
        build.check(read(ctypes.addressof(laps), ctypes.addressof(gt)), entry)  # resets the span
        fn()
        torch.cuda.synchronize()
        build.check(read(ctypes.addressof(laps), ctypes.addressof(gt)), entry)
        out[key] = {**names(list(laps)), "span_ns": gt[1] - gt[0], "event_ms": ms}
    return out


def keyprep_stamps(torch, dev) -> dict:
    """In a ``--keyprep --phases`` copy: block 0's cycles a tile per phase of
    kernel C at each shape (:func:`stamp_keyprep`)."""
    def names(laps):
        tiles = max(laps[4], 1)
        row = {k: laps[i] / tiles for i, k in enumerate(
            ("rows wait", "pass 1 + table wait", "middle passes", "last pass + store issue"))}
        return {**row, "tiles": laps[4], "total_cycles": laps[5]}

    calls = {f"mxu8_forward32@{label}": fn for (name, label), (fn, *_)
             in keyprep_calls(torch, dev).items() if name == "mxu8_forward32"}
    return read_laps(torch, "pft_read_c_laps", 6, calls, names)


def rotate_stamps(torch, dev) -> dict:
    """In a ``--rotate --phases`` copy: block 0's cycles of kernel F at each
    shape, to its degree and its groups (:func:`stamp_rotate`)."""
    calls = {f"rotate@{label}": fn for label, (fn, _) in rotate_calls(torch, dev).items()}
    return read_laps(torch, "pft_read_f_laps", 2, calls,
                     lambda laps: {"degree": laps[0], "groups": laps[1]})


def stage_times(torch, dev) -> dict:
    """Each stage kernel at each shape: its words checked against its plain
    version, device ms, bound, share of the bound and the u64 launch's
    grid (None where the checkout refuses the shape); the floor of this
    timing (an empty kernel); phase 15.3's trips (:func:`coeff_trips`)."""
    out = {}
    for (name, label), (fn, plain, bound_ms, log_w, rows, q) in stage_calls(torch, dev).items():
        try:
            got = fn()
        except ValueError as e:
            out[f"{name}@{label}"] = {"ms": None, "refused": str(e), "bound_ms": bound_ms}
            continue
        if not torch.equal(got, plain()):
            raise SystemExit(f"{name}@{label}: kernel != plain")
        ms = device_ms(torch, fn)
        out[f"{name}@{label}"] = {"ms": ms, "bound_ms": bound_ms, "share": bound_ms / ms,
                                  "grid": stage_grid(name, log_w, rows, q)}
    out["empty kernel"] = {"ms": device_ms(torch, lambda: torch.cuda._sleep(1))}
    out.update(coeff_trips(torch, dev))
    return out


def stage_label_laps(forward: bool, log_w: int, log_c: int) -> list[str]:
    """The laps a ``--stages --phases`` copy stamps in block 0 of a u64 stage
    kernel on clusters of 2^log_c blocks: the forward's stages across
    slices (at load), then its passes (radix 8, the remainder last); the
    inverse's passes (the remainder first), then its stages across slices;
    each lap ends as thread 0 finishes that part (the barrier before it
    included)."""
    l = log_w - log_c
    if forward:
        sizes = [min(3, l - s) for s in range(0, l, 3)]
    else:
        r = l - 3 * ((l - 1) // 3)
        sizes = [r] + [3] * ((l - r) // 3)
    names, s0 = [], 0
    for size in sizes:
        names.append(f"pass stages {s0}-{s0 + size - 1}")
        s0 += size
    cross = f"{log_c} stages across the cluster's slices"
    if log_c:
        names = [cross + " (at load)"] + names if forward else names + [cross + " (store)"]
    return names


def stamp_stages(src: Path, phases: bool) -> None:
    """A copy of ``ntt_stages.cu`` for ``--stages --grids`` (the launch's
    grid, u32 or u64, set from outside, ``pft_st64_force_grid(log_c, T)``;
    -1 for the launch's own; refused where it does not fit) or ``--stages
    --phases`` (clock64() laps of thread 0 of block 0 of the four kernels
    after each pass and the stages across the cluster, the earliest block
    start and latest block end on the global timer; ``pft_read_st64(kind,
    stamps, gt)`` reads them, kind 0 the last forward, 1 the last inverse)."""
    text = src.read_text()
    if not phases:
        pick = "  err = pick_grid(*d, kind, a.rows, a.log_w, &a.log_c, &a.tile);\n"
        if text.count(pick) != 1:
            raise SystemExit("cmux_mxu_timing: ntt_stages.cu's pick moved")
        text = text.replace(pick, pick + (
            "  if (pft_st_force_c >= 0) {\n    a.log_c = pft_st_force_c;\n"
            "    a.tile = pft_st_force_t;\n"
            "    if (!grid_ok(a.log_w, a.log_c, a.tile, log_size(kind)))\n"
            "      return (int)cudaErrorInvalidValue;\n  }\n"))
        text = text.replace("namespace {\n", "int pft_st_force_c = -1, pft_st_force_t = 1;\n"
                            "namespace {\n", 1)
        entry = ("int pft_st64_force_grid(int c, int t) {\n  pft_st_force_c = c;\n"
                 "  pft_st_force_t = t;\n  return 0;\n}\n")
        text = text.replace('extern "C" {\n', 'extern "C" {\n\n' + entry, 1)
        src.write_text(text)
        return
    head = ("__device__ long long pft_st_stamps[2][16];\n__device__ int pft_st_k[2];\n"
            "__device__ unsigned long long pft_st_gt[2][2] = {{~0ull, 0ull}, {~0ull, 0ull}};\n"
            "#define PFT_LAP(K) if (threadIdx.x == 0 && blockIdx.x == 0) "
            "pft_st_stamps[K][pft_st_k[K]++ & 15] = clock64();\n"
            "#define PFT_BEGIN(K) if (threadIdx.x == 0 && blockIdx.x == 0) pft_st_k[K] = 0; "
            "PFT_LAP(K) { unsigned long long pft_g0; "
            "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(pft_g0)); "
            "if (threadIdx.x == 0) atomicMin(&pft_st_gt[K][0], pft_g0); }\n"
            "#define PFT_END(K) { unsigned long long pft_g1; "
            "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(pft_g1)); "
            "if (threadIdx.x == 0) atomicMax(&pft_st_gt[K][1], pft_g1); }\n")
    for fn, k in (("fwd_passes", 0), ("inv_passes", 1)):
        start = text.index(f"__device__ __forceinline__ void {fn}(")
        end = text.index("\n}\n", start)
        body = re.sub(r"(lane_pass<\d, (?:true|false)>\([^;]*\));", rf"{{ \1; PFT_LAP({k}) }}",
                      text[start:end])
        text = text[:start] + body + text[end:]
    # a lap after the stages across the cluster, the span's end at every exit:
    # (pattern, text before it, text after it), the indent kept
    edits = [
        (r"( *)if constexpr \(SPLIT\) \{\n *if \(!arrived\) cluster_arrive\(\);\n", "PFT_LAP(1)",
         ""),
        (r"( *)if \(a\.log_c == 3\) cross_forward<8>\(a, b, sm, bf\);\n", "", "PFT_LAP(0)"),
        (r"( *)fwd_passes\(b\.count, b\.l, tab, bf, rows, ClusterSync\{\}, rows, dst[^;]*\);\n",
         "", "PFT_END(0)"),
        (r"NoSync\{\}, rows, dst[^;]*\);\n( *)return;\n", "PFT_END(0)", ""),
        (r"( *)if \(a\.log_c == 3\) cross_inverse<8, FIX>\(a, b, sm, bfs\);\n", "", "PFT_END(1)"),
        (r"inv_passes\(b\.count, b\.l, tab, bfs, src, rows, dst[^;]*\);\n( *)return;\n",
         "PFT_END(1)", ""),
    ]
    for pattern, before, after in edits:
        found = list(re.finditer(pattern, text))
        if len(found) != 1:
            raise SystemExit(f"cmux_mxu_timing: ntt_stages.cu changed near {pattern!r}")
        m = found[0]
        indent = m.group(1)
        if pattern.endswith("return;\\n"):  # before the return
            at = m.start(1)
            text = text[:at] + indent + before + "\n" + text[at:]
        else:
            text = (text[:m.start()] + (indent + before + "\n" if before else "") + m.group(0)
                    + (indent + after + "\n" if after else "") + text[m.end():])
    for kernel, k in (("stages64_forward_kernel(const StagesArgs<uint64_t> a) {\n", 0),
                      ("stages64_inverse_kernel(const StagesArgs<uint64_t> a) {\n", 1),
                      ("lane32_forward_kernel(const StagesArgs<uint32_t> a) {\n", 0),
                      ("lane32_inverse_kernel(const StagesArgs<uint32_t> a) {\n", 1)):
        words = "uint64_t sm[]" if "stages64" in kernel else "uint32_t sm32[]"
        anchor = kernel + f"  extern __shared__ __align__(16) {words};\n"
        if text.count(anchor) != 1:
            raise SystemExit(f"cmux_mxu_timing: ntt_stages.cu's {kernel.strip()} moved")
        text = text.replace(anchor, anchor + f"  PFT_BEGIN({k})\n")
    text = text.replace("namespace {\n", head + "namespace {\n", 1)
    reader = ("int pft_read_st64(int kind, void* stamps, void* gt) {\n"
              "  cudaError_t e = cudaMemcpyFromSymbol(stamps, pft_st_stamps, 128, kind * 128);\n"
              "  int k = 0;\n"
              "  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(&k, pft_st_k, 4, kind * 4);\n"
              "  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(gt, pft_st_gt, 16, kind * 16);\n"
              "  const unsigned long long reset[2] = {~0ull, 0ull};\n"
              "  if (e == cudaSuccess) e = cudaMemcpyToSymbol(pft_st_gt, reset, 16, kind * 16);\n"
              "  return e == cudaSuccess ? -k : (int)e;\n}\n")
    text = text.replace('extern "C" {\n', 'extern "C" {\n\n' + reader, 1)
    src.write_text(text)


def stage_stamps(torch, dev) -> dict:
    """In a ``--stages --phases`` copy (:func:`stamp_stages`): block 0's
    cycles per part of each stage kernel's last launch at each shape, the
    launch's span on the device beside its event-timed device ms."""
    import ctypes

    from primus_fhe_tpu_torch.ops import build

    read = build.library().pft_read_st64
    read.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    read.restype = ctypes.c_int
    out = {}
    for (name, label), (fn, _, _, log_w, rows, q) in stage_calls(torch, dev).items():
        forward = name.endswith("forward")
        c, tile = stage_grid(name, log_w, rows, q)
        ms = device_ms(torch, fn)
        stamps = (ctypes.c_longlong * 16)()
        gt = (ctypes.c_ulonglong * 2)()
        read(int(not forward), ctypes.addressof(stamps), ctypes.addressof(gt))  # resets the span
        fn()
        torch.cuda.synchronize()
        k = -read(int(not forward), ctypes.addressof(stamps), ctypes.addressof(gt))
        laps = list(stamps)[:k]
        names = stage_label_laps(forward, log_w, c.bit_length() - 1)
        if len(laps) != len(names) + 1:
            raise SystemExit(f"{name}@{label}: {len(laps)} laps for {len(names)} parts")
        row = dict(zip(names, [laps[i + 1] - laps[i] for i in range(len(names))]))
        row.update(total_cycles=laps[-1] - laps[0], span_ns=gt[1] - gt[0], event_ms=ms,
                   grid=[c, tile])
        out[f"{name}@{label}"] = row
    return out


def stage_grids(torch, dev) -> dict:
    """In a ``--stages --grids`` copy (:func:`stamp_stages`): each stage
    kernel's device ms at each shape on the launch's own grid and on every
    grid of :data:`STAGE_GRIDS` that fits (a block's tile at most 128 KB),
    each one's words checked against the own grid's."""
    import ctypes

    from primus_fhe_tpu_torch.ops import build

    lib = build.library()
    lib.pft_st64_force_grid.argtypes = [ctypes.c_int, ctypes.c_int]
    out = {}
    for (name, label), (fn, _, bound_ms, log_w, rows, q) in stage_calls(torch, dev).items():
        size = 8 if name.startswith("ntt64") else 4
        lib.pft_st64_force_grid(-1, 1)
        want = fn()
        row = {"own": stage_grid(name, log_w, rows, q), "own_ms": device_ms(torch, fn),
               "bound_ms": bound_ms}
        for c, tile in STAGE_GRIDS:
            if log_w - c < max(c, 1) or (tile << (log_w - c)) * size > 1 << 17 or tile > 2 * rows:
                continue
            lib.pft_st64_force_grid(c, tile)
            if not torch.equal(fn(), want):
                raise SystemExit(f"{name}@{label} grid ({1 << c}, {tile}): words differ")
            row[f"C{1 << c} T{tile}"] = device_ms(torch, fn)
        lib.pft_st64_force_grid(-1, 1)
        out[f"{name}@{label}"] = row
    return out


def idle_us(torch, fn, calls: int = 200) -> float:
    """Median over 5 runs of the host microseconds a call of ``fn`` with
    nothing queued ahead of it: where the call's kernels are shorter than
    its host time, the card idles between launches (:func:`host_us` is the
    same with a long queue ahead)."""
    import time

    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return sorted(runs)[2]


def split_times(torch, dev) -> dict:
    """Device ms, bound and share of the bound of each half at each shape,
    the floor of this timing (an empty kernel), phase 16.2's sharded
    product a trip (:func:`sharded_trips`), and the host us a call of each
    half at the D = 2 product shard and of an empty kernel, behind a queue
    (:func:`host_us`) and with none (:func:`idle_us`)."""
    out = {}
    for (name, label), (fn, bound_ms, _) in split_calls(torch, dev).items():
        try:
            fn()
        except ValueError as e:  # a checkout that refuses the shape (A > 32 on byte planes)
            out[f"{name}@{label}"] = {"ms": None, "refused": str(e), "bound_ms": bound_ms}
            continue
        ms = device_ms(torch, fn)
        out[f"{name}@{label}"] = {"ms": ms, "bound_ms": bound_ms, "share": bound_ms / ms}
        if label == SPLIT_SHAPES[0][0]:
            out[f"{name}@{label}"].update(queued_us=host_us(torch, fn), idle_us=idle_us(torch, fn))
    empty = lambda: torch.cuda._sleep(1)  # noqa: E731
    out["empty kernel"] = {"ms": device_ms(torch, empty), "queued_us": host_us(torch, empty),
                           "idle_us": idle_us(torch, empty)}
    out.update(sharded_trips(torch, dev))
    return out


def stamp_split(src: Path, phases: bool) -> None:
    """A copy of ``ntt_mxu8_split.cu`` for ``--split --grids`` (the row
    kernel's tile and the column kernel's threads a block set from outside
    the launch, ``pft_split_force_tile(T)`` / ``pft_split_force_threads(N)``,
    0 for the launch's own; ``pft_split_used_tile`` / ``_threads`` read the
    last launch's) or ``--split --phases`` (clock64() laps of thread 0 of
    block 0 of the row and column kernels after each phase, the earliest
    block start and latest block end on the global timer, per kind;
    ``pft_read_split`` reads them and resets the span)."""
    text = src.read_text()
    if not phases:
        pick = "  a.tile = pick_rows(ms.count, rows, sms);\n"
        cols = "constexpr int COL_THREADS = 128;\n"
        if text.count(pick) != 1 or text.count(cols) != 1:
            raise SystemExit("cmux_mxu_timing: ntt_mxu8_split.cu's picks moved")
        text = text.replace(pick, pick + "  if (pft_split_force > 0) a.tile = pft_split_force;\n"
                            "  pft_split_used = a.tile;\n")
        text = text.replace(cols, "int col_threads() {\n  pft_col_used = pft_col_force > 0 ? "
                            "pft_col_force : 128;\n  return pft_col_used;\n}\n"
                            "#define COL_THREADS col_threads()\n")
        text = text.replace("namespace {\n", "int pft_split_force = 0, pft_split_used = 0;\n"
                            "int pft_col_force = 0, pft_col_used = 0;\nnamespace {\n", 1)
        entry = ("int pft_split_force_tile(int t) {\n  pft_split_force = t;\n  return 0;\n}\n"
                 "int pft_split_used_tile() { return pft_split_used; }\n"
                 "int pft_split_force_threads(int t) {\n  pft_col_force = t;\n  return 0;\n}\n"
                 "int pft_split_used_threads() { return pft_col_used; }\n")
        text = text.replace('extern "C" {\n', 'extern "C" {\n\n' + entry, 1)
        src.write_text(text)
        return
    lap = "if (threadIdx.x == 0 && blockIdx.x == 0) pft_split_stamps[pft_kind][pft_k++] = clock64();"
    timer = ("{{ unsigned long long tg; asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(tg)); "
             "if (threadIdx.x == 0) atomic{0}(&pft_split_gt[pft_kind][{1}], tg); }}")

    def stamp(text, begin, end, edits):
        """The kernel between ``begin`` and ``end`` with laps at ``edits``
        ((anchor, text to add, after the anchor?)) and at its end."""
        pre, body, post = kernel_region(text, begin, end)
        for anchor, add, after in edits:
            if body.count(anchor) != 1:
                raise SystemExit(f"cmux_mxu_timing: a split kernel changed near {anchor.strip()!r}")
            body = body.replace(anchor, anchor + add if after else add + anchor)
        body = body.rstrip()
        if not body.endswith("}"):
            raise SystemExit("cmux_mxu_timing: a split kernel's end moved")
        return pre + body[:-1] + f"  {lap}\n  {timer.format('Max', 1)}\n}}\n\n" + post

    text = stamp(text, "split_row_kernel(const RowArgs a)", "// The SM count of the current device", [
        ("  uint64_t* slice = sm + ROW_TABLE + tr * B;\n",
         "  constexpr int pft_kind = INVERSE ? (MUL ? 1 : 2) : 0;\n  int pft_k = 0;\n"
         f"  {timer.format('Min', 0)}\n  {lap}\n", True),
        ("  cp_async_wait<0>();\n  __syncthreads();  // the table\n", f"  {lap}\n", False),
        ("  cp_async_wait<0>();\n  __syncthreads();  // the table\n", f"  {lap}\n", True),
        ("#pragma unroll\n  for (int k = 0; k < 8; ++k) {\n    const uint64_t x[2] = {v0[k], v1[k]};\n"
         "    store_words(row_chunk(slice, r, k, t), x);", f"  {lap}\n", False),  # pass A
        ("    store_words(row_chunk(slice, r, k, t), x);\n  }\n  __syncwarp();\n", f"  {lap}\n",
         True),  # to the slice
        ("    store_words(row_chunk(slice, r, t, j), x);\n  }\n  __syncwarp();\n", f"  {lap}\n",
         True),  # pass B / A', back to the slice
        ("    inv_stages<3, 2>(v1, tw2, q);\n", f"    {lap}\n", True),  # stages 4-5
        ("  // the store: chunks t + 8k", f"  {lap}\n", False),  # stage 6 and the twiddle
    ])
    text = stamp(text, "split_col_kernel(const ColArgs a)", "// Threads a block: 128 at every shape", [
        ("  uint64_t* slots = sm + 2 * A + (threadIdx.x >> 5) * 32 * W;  // the warp's slice\n",
         "  constexpr int pft_kind = INVERSE ? 4 : 3;\n  int pft_k = 0;\n"
         f"  {timer.format('Min', 0)}\n  {lap}\n", True),
        ("  __syncthreads();  // the table\n", f"  {lap}\n", True),  # loads + table
        ("    // stages log T .. log A - 1 in L2", f"    {lap}\n", False),  # K1: L1 + layout
        ("    // the twiddle tw[r0][k0]", f"    {lap}\n", False),  # K1: L2 stages
        ("    const uint64_t fy = sm[0], fyp = sm[A];", f"    {lap}\n", False),  # Ki2: L2
        ("#pragma unroll\n    for (int r = 0; r < W; ++r) v[r] = reduce_once64(v[r], q);",
         f"    {lap}\n", False),  # Ki2: layout, L1 stages, the last stage
        ("  // the store: the forward from L2", f"  {lap}\n", False),  # twiddle / canonical
    ])
    text = text.replace("namespace {\n", "__device__ long long pft_split_stamps[5][16];\n"
                        "__device__ unsigned long long pft_split_gt[5][2] = {{~0ull, 0ull}, "
                        "{~0ull, 0ull}, {~0ull, 0ull}, {~0ull, 0ull}, {~0ull, 0ull}};\n"
                        "namespace {\n", 1)
    reader = ("int pft_read_split(int kind, void* stamps, void* gt) {\n"
              "  cudaError_t e = cudaMemcpyFromSymbol(stamps, pft_split_stamps, 128, kind * 128);\n"
              "  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(gt, pft_split_gt, 16, kind * 16);\n"
              "  const unsigned long long reset[2] = {~0ull, 0ull};\n"
              "  if (e == cudaSuccess) e = cudaMemcpyToSymbol(pft_split_gt, reset, 16, kind * 16);\n"
              "  return (int)e;\n}\n")
    text = text.replace('extern "C" {\n', 'extern "C" {\n\n' + reader, 1)
    src.write_text(text)


SPLIT_PHASES = {0: ("load", "table wait", "pass A (stages 0-2)", "to the slice",
                    "pass B (stages 3-6), back to the slice", "from the slice", "store"),
                1: ("load + key", "table wait", "(no pass A)", "to the slice",
                    "pass A' (stages 0-3), back to the slice", "from the slice + stages 4-5",
                    "twiddle loads + stage 6", "store"),
                3: ("load + table wait", "L1 stages + layout change", "L2 stages", "twiddle",
                    "store"),
                4: ("load + table wait", "L2 stages", "layout change + L1 stages + last stage",
                    "canonical", "store")}
SPLIT_PHASES[2] = SPLIT_PHASES[1]


def split_stamps(torch, dev) -> dict:
    """In a ``--split --phases`` copy (:func:`stamp_split`): block 0's
    cycles per phase of the row kernel's last launch at each shape, and the
    launch's span on the device beside its event-timed device ms."""
    import ctypes

    from primus_fhe_tpu_torch.ops import build

    read = build.library().pft_read_split
    read.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    out = {}
    for (name, label), (fn, _, _) in split_calls(torch, dev).items():
        if name not in SPLIT_KIND:
            continue
        kind = SPLIT_KIND[name]
        ms = device_ms(torch, fn)
        stamps = (ctypes.c_longlong * 16)()
        gt = (ctypes.c_ulonglong * 2)()
        build.check(read(kind, ctypes.addressof(stamps), ctypes.addressof(gt)), "pft_read_split")
        fn()
        torch.cuda.synchronize()
        build.check(read(kind, ctypes.addressof(stamps), ctypes.addressof(gt)), "pft_read_split")
        laps = list(stamps)
        names = SPLIT_PHASES[kind]
        row = dict(zip(names, [laps[i + 1] - laps[i] for i in range(len(names))]))
        row.update(total_cycles=laps[len(names)] - laps[0], span_ns=gt[1] - gt[0], event_ms=ms)
        out[f"{name}@{label}"] = row
    return out


def split_grids(torch, dev) -> dict:
    """In a ``--split --grids`` copy (:func:`stamp_split`): each half's device
    ms at each shape on the launch's own block and on every other, every
    block's words checked against the own block's: the row kernel (K2, Ki1)
    on tiles of :data:`SPLIT_TILES` rows, the column kernel (K1, Ki2) on
    blocks of :data:`SPLIT_THREADS` threads."""
    import ctypes

    from primus_fhe_tpu_torch.ops import build

    lib = build.library()
    lib.pft_split_force_tile.argtypes = [ctypes.c_int]
    lib.pft_split_force_threads.argtypes = [ctypes.c_int]
    out = {}
    for (name, label), (fn, bound_ms, _) in split_calls(torch, dev).items():
        col = name in ("split_k1", "split_ki2")
        force, used, sizes, tag = ((lib.pft_split_force_threads, lib.pft_split_used_threads,
                                    SPLIT_THREADS, "threads") if col else
                                   (lib.pft_split_force_tile, lib.pft_split_used_tile,
                                    SPLIT_TILES, "tile"))
        force(0)
        want = fn()
        row = {"own": used(), "own_ms": device_ms(torch, fn), "bound_ms": bound_ms}
        for size in sizes:
            force(size)
            if not torch.equal(fn(), want):
                raise SystemExit(f"{name}@{label} {tag} {size}: words differ")
            row[f"{tag}{size}"] = device_ms(torch, fn)
        force(0)
        out[f"{name}@{label}"] = row
    return out


def stamp_passes(src: Path, tag: str, edits: list) -> None:
    """clock64() laps of thread 0 of block 0 of a transform's two kernels
    (forward first; ``edits``: (anchor, count, text after it), None at the
    kernels' heads, ``LAP`` / ``END`` in the text for a lap / the last lap),
    the earliest block start and the latest block end on the global timer,
    and a C entry ``pft_read_<tag>`` that reads them (kind 0 the forward, 1
    the inverse) and resets the span."""
    text = src.read_text()
    up = tag.upper()
    head = (f"__device__ long long pft_{tag}_stamps[2][8];\n"
            f"__device__ unsigned long long pft_{tag}_gt[2][2] = "
            "{{~0ull, 0ull}, {~0ull, 0ull}};\n"
            f"#define PFT_{up}_LAP() if (threadIdx.x == 0 && blockIdx.x == 0) "
            f"pft_{tag}_stamps[pft_kind][pft_k++] = clock64();\n"
            f"#define PFT_{up}_BEGIN(K) const int pft_kind = K; int pft_k = 0; "
            "unsigned long long pft_g0; asm volatile(\"mov.u64 %0, %%globaltimer;\" : "
            f"\"=l\"(pft_g0)); PFT_{up}_LAP()\n"
            f"#define PFT_{up}_END() {{ PFT_{up}_LAP() unsigned long long pft_g1; "
            "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(pft_g1)); "
            f"if (threadIdx.x == 0) {{ atomicMin(&pft_{tag}_gt[pft_kind][0], pft_g0); "
            f"atomicMax(&pft_{tag}_gt[pft_kind][1], pft_g1); }} }}\n")
    for anchor, count, after in edits:
        if text.count(anchor) != count:
            raise SystemExit(f"cmux_mxu_timing: {src.name} changed near {anchor.strip()!r}")
        if after is None:  # the two kernels' heads: forward first
            at = text.index(anchor) + len(anchor)
            text = text[:at] + f"  PFT_{up}_BEGIN(0)\n" + text[at:]
            at = text.index(anchor, at) + len(anchor)
            text = text[:at] + f"  PFT_{up}_BEGIN(1)\n" + text[at:]
        else:
            after = after.replace("LAP", f"PFT_{up}_LAP()").replace("END", f"PFT_{up}_END()")
            text = text.replace(anchor, anchor + after)
    text = text.replace("namespace {\n", head + "namespace {\n", 1)
    reader = (f"int pft_read_{tag}(int kind, void* stamps, void* gt) {{\n"
              f"  cudaError_t e = cudaMemcpyFromSymbol(stamps, pft_{tag}_stamps, "
              "8 * sizeof(long long),"
              " kind * 8 * sizeof(long long));\n"
              f"  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(gt, pft_{tag}_gt, 16, "
              "kind * 16);\n"
              "  const unsigned long long reset[2] = {~0ull, 0ull};\n"
              f"  if (e == cudaSuccess) e = cudaMemcpyToSymbol(pft_{tag}_gt, reset, 16, "
              "kind * 16);\n"
              "  return (int)e;\n}\n")
    text = text.replace('extern "C" {\n', 'extern "C" {\n\n' + reader, 1)
    src.write_text(text)


def stamp_ntt32(src: Path) -> None:
    """:func:`stamp_passes` in kernels 1-2: laps after pass 1, after the
    table wait and barrier, after each middle pass, at the end (the
    inverse's passes after the first as one lap)."""
    stamp_passes(src, "n32", [
        ("  const Tile t = block_tile(a);\n", 2, None),
        ("  fwd_pass<3>(t.count, log_n, 0, FwdFirst(groots, groots_p, 8), q, src, rows);\n", 1,
         "  LAP\n"),
        ("  if (r == 1) inv_pass<1, Last::no>(t.count, log_n, 0, global, pc, src, rows);\n", 1,
         "  LAP\n"),
        ("  cp_async_wait<0>();\n  __syncthreads();\n", 2, "  LAP\n"),
        ("    fwd_pass<3>(t.count, log_n, s0, table, q, rows, rows);\n    __syncthreads();\n", 1,
         "    LAP\n"),
        ("  if (r == 1) fwd_pass<1>(t.count, log_n, log_n - 1, table, q, rows, dst);\n", 1,
         "  END\n"),
        ("  inv_rest<LAST>(rows, t.count, log_n, r, InvTable{tw, twp, n - m}, pc, dst);\n", 1,
         "  END\n"),
    ])


def stamp_ntt64(src: Path) -> None:
    """:func:`stamp_passes` in row 10's kernels, the same laps as
    :func:`stamp_ntt32` (a row in one block)."""
    stamp_passes(src, "n64", [
        ("  const Tile t = block_tile(a);\n", 2, None),
        ("  fwd_pass<3>(t.count, log_n, 0, FwdFirst(groots, groots_p, 8), q, src, rows);\n", 1,
         "  LAP\n"),
        ("  if (r == 1) inv_pass<1, Last::no>(t.count, log_n, 0, global, c, src, rows);\n", 1,
         "  LAP\n"),
        ("  cp_async_wait<0>();\n  __syncthreads();\n", 2, "  LAP\n"),
        ("      fwd_pass<3>(t.count, l, s0, table, q, rows, rows);\n      __syncthreads();\n", 1,
         "      LAP\n"),
        ("    if (r == 1) fwd_pass<1>(t.count, l, l - 1, table, q, rows, dst);\n", 1,
         "    END\n"),
        ("  inv_rest<LAST>(rows, t.count, log_n, r, staged, c, dst);\n", 1, "  END\n"),
    ])


def pass_stamps(torch, tag: str, calls: dict) -> dict:
    """In a ``--phases`` copy (:func:`stamp_passes`): block 0's cycles per
    pass of the last launch of each call ``{key: (call, forward, log_n)}``,
    and the launch's span on the device (earliest block start to latest
    block end, ns) beside its event-timed device ms."""
    import ctypes

    from primus_fhe_tpu_torch.ops import build

    lib = build.library()
    read = getattr(lib, f"pft_read_{tag}")
    read.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    out = {}
    for key, (fn, forward, log_n) in calls.items():
        kind = 0 if forward else 1
        ms = device_ms(torch, fn)
        stamps = (ctypes.c_longlong * 8)()
        gt = (ctypes.c_ulonglong * 2)()
        build.check(read(kind, ctypes.addressof(stamps), ctypes.addressof(gt)),
                    f"pft_read_{tag}")  # resets the span
        fn()
        torch.cuda.synchronize()
        build.check(read(kind, ctypes.addressof(stamps), ctypes.addressof(gt)), f"pft_read_{tag}")
        passes = -(-log_n // 3)
        laps = list(stamps)[:passes + 2 if forward else 4]
        names = (["pass 1", "table wait + barrier"]
                 + [f"pass {i}" for i in range(2, passes)] + [f"pass {passes} (stores)"]
                 if forward else ["pass 1", "table wait + barrier", "passes 2+ (stores)"])
        row = dict(zip(names, [laps[i + 1] - laps[i] for i in range(len(names))]))
        row.update(total_cycles=laps[len(names)] - laps[0], span_ns=gt[1] - gt[0], event_ms=ms)
        out[key] = row
    return out


def ntt32_stamps(torch, dev) -> dict:
    """:func:`pass_stamps` of kernels 1-2 at each shape."""
    return pass_stamps(torch, "n32", {
        f"{name}@{label}": (fn, name == "forward32", NTT32_LOG_N[label])
        for (name, label), (fn, _, _, _) in ntt32_calls(torch, dev).items()})


def ntt64_stamps(torch, dev) -> dict:
    """:func:`pass_stamps` of row 10 at each shape."""
    return pass_stamps(torch, "n64", {
        f"{name}@{label}": (fn, name == "ntt64_forward", tables.log_n)
        for (name, label), (fn, _, tables, _, _, _) in ntt_calls(torch, dev).items()
        if name.startswith("ntt64")})


def stamp_tiles(src: Path, tag: str, pick: str, guard: str,
                smem: str = "smem_bytes(forward, log_n, a.tile)") -> None:
    """Adds to a transform's source a tile of rows set from outside the
    launch (``pft_<tag>_force_tile(T)``; 0 for the launch's own), after its
    pick line ``pick``, where ``guard`` holds, refused where its shared
    memory ``smem`` does not fit."""
    text = src.read_text()
    if text.count(pick) != 1:
        raise SystemExit(f"cmux_mxu_timing: {src.name}'s pick moved")
    force = (f"  if (pft_{tag}_force > 0 && {guard}) a.tile = pft_{tag}_force;\n"
             f"  if ({smem} > (size_t)SMEM_MAX)\n"
             "    return (int)cudaErrorInvalidValue;\n")
    text = text.replace(pick, pick + force)
    text = text.replace("namespace {\n", f"int pft_{tag}_force = 0;\nnamespace {{\n", 1)
    entry = f"int pft_{tag}_force_tile(int t) {{\n  pft_{tag}_force = t;\n  return 0;\n}}\n"
    text = text.replace('extern "C" {\n', 'extern "C" {\n\n' + entry, 1)
    src.write_text(text)


def device_times(torch, fn) -> list[float]:
    """The :func:`device_ms` readings of ``fn``, each call timed behind a
    sleep kernel, sorted."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)


def loop_ms(torch, fn) -> float:
    """``chip_smoke.cuda_ms``: the mean of :data:`REPS` calls back to back
    between two CUDA events, after two warm-up calls; the host runs ahead,
    so a call's enqueue counts where it is longer than its kernel."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def host_us(torch, fn, calls: int = 200) -> float:
    """Median over 5 runs of the host microseconds a call of ``fn``, the
    card held busy by a ~30 ms sleep kernel so that every launch only
    queues."""
    import time

    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(5):
        torch.cuda._sleep(60_000_000)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return sorted(runs)[2]


ENTRIES = {"mxu8_forward64": ("pft_ntt_mxu8_forward64", ("w1s", "w2s"), ("w1", "w2")),
           "mxu8_inverse64": ("pft_ntt_mxu8_inverse64", ("wi1s", "wi2s"), ("wi1", "wi2")),
           "mxu8_inverse64_mul": ("pft_ntt_mxu8_inverse64_mul", ("wi1s", "wi2s"),
                                  ("wi1", "wi2"))}


def wrapper_host(torch, name, tables, x, key) -> dict:
    """Host microseconds a call of the wrapper ``name`` (:data:`ENTRIES`) on
    ``x``: the wrapper, the C entry alone, and the wrapper's Python parts
    (the checks and the output's allocation, the table lookup, the stream,
    the pointers)."""
    from primus_fhe_tpu_torch.ops import build, ntt_mxu8

    entry_name, names, old_names = ENTRIES[name]
    wrapper = getattr(ntt_mxu8, name)
    tabs = tables.kernel_tables(x.device)
    names = names if names[0] in tabs else old_names  # an older checkout's tables
    keyed = () if key is None else (key,)
    out = torch.empty_like(x)
    entry = getattr(build.library(), entry_name)
    args = (x.data_ptr(), out.data_ptr(), *(tabs[k].data_ptr() for k in names),
            tabs["tw"].data_ptr(), *(k.data_ptr() for k in keyed),
            build.ptr(tables.ntt.mod_pack), len(tables.moduli), x[0].numel() // tables.n,
            tables.log_n, tables.planes, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(entry(*args), entry_name)
    if not torch.equal(out, wrapper(tables, x, *keyed)):
        raise SystemExit(f"{entry_name}: the C entry's words differ from the wrapper's")

    def checks_alloc():
        v = x.contiguous()
        if v.dtype != torch.int64 or v.shape[0] != len(tables.moduli):
            raise SystemExit("bad input")
        return torch.empty_like(v)

    return {
        "wrapper_us": host_us(torch, lambda: wrapper(tables, x, *keyed)),
        "entry_us": host_us(torch, lambda: entry(*args)),
        "checks_alloc_us": host_us(torch, checks_alloc),
        "tables_us": host_us(torch, lambda: tables.kernel_tables(x.device)),
        "stream_us": host_us(torch, lambda: torch.cuda.current_stream(x.device).cuda_stream),
        "pointers_us": host_us(torch, lambda: (x.data_ptr(), out.data_ptr(),
                                               *(tabs[k].data_ptr() for k in names),
                                               tabs["tw"].data_ptr(),
                                               build.ptr(tables.ntt.mod_pack))),
    }


def roundtrip_times(torch, dev) -> dict:
    """``bench.py``'s round trip at 512 x 4096 on its modulus, ms a trip
    over :data:`RT_TRIPS` chained trips (``chip_smoke.chained_ms``) and
    modmul/s, on the three routes: kernel E, ``mxu8_forward64`` + D, and the
    butterfly kernels around a torch Shoup multiply."""
    from primus_fhe_tpu_torch.modular.factor import ShoupFactor64, factor_mul_lazy64
    from primus_fhe_tpu_torch.ops import ntt64, ntt_mxu8

    n, log_n, rows, q = 4096, 12, 512, NTT_MODULI[0]
    g = torch.Generator(device=dev).manual_seed(2029)
    ntt = ntt64.NttTables64(log_n, [q])
    mxu = ntt_mxu8.Mxu8Tables64(ntt)
    x = torch.randint(0, q, (1, rows, n), generator=g, device=dev)
    mt = mxu.mul_table(torch.randint(0, q, (1, n), generator=g, device=dev))
    kf = ShoupFactor64(mt[0, 0], mt[0, 1])
    routes = {
        "E": lambda v: ntt_mxu8.mxu8_roundtrip64_mul(mxu, v, mt),
        "fwd+D": lambda v: ntt_mxu8.mxu8_inverse64_mul(mxu, ntt_mxu8.mxu8_forward64(mxu, v), mt),
        "butterfly": lambda v: ntt64.ntt64_inverse(
            ntt, factor_mul_lazy64(ntt64.ntt64_forward(ntt, v, 4), kf, q)),
    }
    outs = {name: route(x) for name, route in routes.items()}
    if not all(torch.equal(outs["E"], o) for o in outs.values()):
        raise SystemExit("the round-trip routes differ")
    modmuls = rows * (n * log_n + n)
    out = {}
    for name, route in routes.items():
        route(x)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        v = x
        start.record()
        for _ in range(RT_TRIPS):
            v = route(v)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / RT_TRIPS
        out[name] = {"ms": ms, "modmul_s": modmuls / (ms / 1e3)}
    return out


def ntt64_tile(tables, name, x):
    """The tile of rows row 10's launch picks for ``x`` (None in an older
    checkout, which picks none)."""
    from primus_fhe_tpu_torch.ops import ntt64

    if not hasattr(ntt64, "launch_tile"):
        return None
    return ntt64.launch_tile(tables, x[0].numel() // tables.n, name == "ntt64_forward")


def ntt_times(torch, dev, row10_only: bool = False) -> dict:
    """Device ms, bound and share of the bound of each transform call, and
    the tile of rows row 10's and kernel E's launches pick; for the byte-radix kernels also
    their MAC roofline, the slowest device time, :func:`loop_ms` five times
    and :func:`wrapper_host` (``row10_only``: row 10's calls alone); and the
    floor of this timing, an empty kernel."""
    from primus_fhe_tpu_torch.ops import ntt_mxu8

    out = {}
    for (name, label), (fn, bound_ms, tables, x, mac_ms, key) in ntt_calls(
            torch, dev, row10_only).items():
        if row10_only and not name.startswith("ntt64"):
            continue
        times = device_times(torch, fn)
        ms = times[len(times) // 2]
        row = {"ms": ms, "bound_ms": bound_ms, "share": bound_ms / ms}
        if name.startswith("ntt64"):
            row["tile"] = ntt64_tile(tables, name, x)
        if name == "mxu8_roundtrip64_mul" and hasattr(ntt_mxu8, "roundtrip_tile"):
            row["tile"] = ntt_mxu8.roundtrip_tile(tables, x[0].numel() // tables.n)
        if name in ENTRIES:
            row.update(mac_roofline_ms=mac_ms, mac_share=mac_ms / ms, device_max_ms=times[-1],
                       loop_ms=[loop_ms(torch, fn) for _ in range(5)],
                       host=wrapper_host(torch, name, tables, x, key))
        out[f"{name}@{label}"] = row
    out["empty kernel"] = {"ms": device_ms(torch, lambda: torch.cuda._sleep(1))}
    return out


def grid_times(torch, dev) -> dict:
    """In a ``--grids`` copy: the byte-radix transforms' device ms at each
    shape on the launch's own grid and on every (R, S) (None where the
    launch refuses the grid: its shared memory does not fit), and kernel E
    at each shape on every tile of rows (:func:`sweep_tiles`)."""
    import ctypes

    from primus_fhe_tpu_torch.ops import build, ntt_mxu8

    lib = build.library()
    lib.pft_fwd_force_grid.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.pft_fwd_used_grid.argtypes = [ctypes.c_void_p]
    out = {}
    for (name, label), (fn, bound_ms, _, _, _, _) in ntt_calls(torch, dev).items():
        if name not in ENTRIES:
            continue
        lib.pft_fwd_force_grid(0, 0)
        want = fn()
        used = (ctypes.c_int * 2)()
        lib.pft_fwd_used_grid(ctypes.addressof(used))
        row = {"own": list(used), "own_ms": device_ms(torch, fn), "bound_ms": bound_ms}
        for r in (1, 2, 4):
            for s in (1, 2, 4, 8):
                lib.pft_fwd_force_grid(r, s)
                try:
                    got = fn()
                except RuntimeError:  # the launch refused a grid that does not fit
                    row[f"{r}x{s}"] = None
                    continue
                if not torch.equal(got, want):
                    raise SystemExit(f"{name} grid {(r, s)} at {label}: words differ")
                row[f"{r}x{s}"] = device_ms(torch, fn)
        lib.pft_fwd_force_grid(0, 0)
        out[f"{name}@{label}"] = row
    lib.pft_rt64_force_tile.argtypes = [ctypes.c_int]
    calls = {f"{name}@{label}": (fn, bound_ms, ntt_mxu8.roundtrip_tile(tables, x[0].numel()
                                                                        // tables.n))
             for (name, label), (fn, bound_ms, tables, x, _, _) in ntt_calls(torch, dev).items()
             if name == "mxu8_roundtrip64_mul"}
    out.update(sweep_tiles(torch, calls, lib.pft_rt64_force_tile))
    return out


def stamp_grids(src: Path) -> None:
    """Adds to ``ntt_mxu8.cu`` a grid set from outside the launches of the
    forward and of the inverse (``pft_fwd_force_grid(R, S)``; 0, 0 for the
    launch's own) and a read of the grid the last launch ran
    (``pft_fwd_used_grid``)."""
    text = src.read_text()
    for pick in ("  fwd_pick(count, rows, log_n, d->sms, d->fits, &R, &S);\n",
                 "  inv_pick(count, rows, log_n, d->sms, &R, &S);\n"):
        if text.count(pick) != 1:
            raise SystemExit("cmux_mxu_timing: a launch's pick moved")
        text = text.replace(pick, pick + "  if (pft_fwd_force[0] > 0) {\n    R = pft_fwd_force[0];\n"
                            "    S = pft_fwd_force[1];\n  }\n  pft_fwd_used[0] = R;\n"
                            "  pft_fwd_used[1] = S;\n")
    text = text.replace("namespace {\n", "int pft_fwd_force[2] = {0, 0};\n"
                        "int pft_fwd_used[2] = {0, 0};\nnamespace {\n", 1)
    entries = ("int pft_fwd_force_grid(int r, int s) {\n  pft_fwd_force[0] = r;\n"
               "  pft_fwd_force[1] = s;\n  return 0;\n}\n"
               "int pft_fwd_used_grid(int* out) {\n  out[0] = pft_fwd_used[0];\n"
               "  out[1] = pft_fwd_used[1];\n  return 0;\n}\n")
    text = text.replace('extern "C" {\n', 'extern "C" {\n\n' + entries, 1)
    src.write_text(text)


def rotations(torch, dev) -> dict:
    """The NTT-key blind rotation at BOOLEAN_128 width, batch 1 and 64:
    ``{batch: {"ms", "host_us_step", "idle_share"}}``."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from primus_fhe_tpu_torch import params as P
    from primus_fhe_tpu_torch.boot.blind_rotate import blind_rotate
    from primus_fhe_tpu_torch.decompose import ApproxSignedBasis32
    from primus_fhe_tpu_torch.lattice import tfhe

    p = P.BOOLEAN_128
    basis = ApproxSignedBasis32(None, p.log_basis, reverse_length=p.level)
    conv = tfhe.make_convolver(p.log_n, p.level, p.glwe_dim, p.log_basis)
    n, k1, steps = p.n, p.glwe_dim + 1, p.lwe_dim
    g = torch.Generator(device=dev).manual_seed(2027)
    qs = torch.tensor(conv.primes, device=dev).reshape(-1, 1, 1, 1, 1)
    bsk = torch.stack([
        (torch.randint(0, 1 << 62, (conv.count, k1, p.level, k1, n), generator=g, device=dev)
         % qs).to(torch.int32) for _ in range(steps)])
    tp = torch.full((n,), 1 << 29, dtype=torch.int64, device=dev)
    out = {}
    for bsz in (1, 64):
        lwe = torch.randint(0, 2 * n, (bsz, steps + 1), generator=g, device=dev,
                            dtype=torch.int32)

        def fn():
            return blind_rotate(conv, basis, bsk, lwe, tp)

        fn()
        wall, enq = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            enq.append(t1 - t0)
            wall.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type != DeviceType.CPU) / 1e3
        ms = min(wall) * 1e3
        out[bsz] = {"ms": ms, "host_us_step": min(enq) * 1e6 / steps,
                    "idle_share": 1 - busy / ms}
    return out


def run_here(stamps: bool, ntt_only: bool = False, ntt32_only: bool = False,
             ntt64_only: bool = False, split_only: bool = False,
             stages_only: bool = False, keyprep_only: bool = False,
             rotate_only: bool = False, front_only: bool = False,
             stage2_only: bool = False) -> dict:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("cmux_mxu_timing: needs a CUDA card")
    dev = torch.device("cuda", 0)
    result = {"root": str(Path(sys.path[0]).resolve()), "card": card()}
    if keyprep_only:
        result["keyprep"] = keyprep_times(torch, dev)
        return result
    if rotate_only:
        result["rotate"] = rotate_times(torch, dev)
        return result
    if front_only:
        result["front"] = front_times(torch, dev)
        return result
    if stage2_only:
        result["stage2"] = stage2_times(torch, dev)
        return result
    if split_only:
        result["split"] = split_times(torch, dev)
        return result
    if stages_only:
        result["stages"] = stage_times(torch, dev)
        return result
    if ntt32_only:
        result["ntt32"] = ntt32_times(torch, dev)
        return result
    if ntt64_only:
        result["ntt64"] = ntt_times(torch, dev, row10_only=True)
        return result
    if not stamps:
        result["ntt"] = ntt_times(torch, dev)
        result["roundtrip"] = roundtrip_times(torch, dev)
    if ntt_only:
        return result
    calls = kernels(torch, dev)
    result["ms"] = {f"{k}@{b}": device_ms(torch, fn) for (k, b), fn in calls.items()}
    if not stamps:
        result["rotation"] = rotations(torch, dev)
    if stamps:
        import ctypes

        from primus_fhe_tpu_torch.ops import build

        lib = build.library()
        lib.pft_read_stamps.argtypes = [ctypes.c_void_p]
        buf = (ctypes.c_longlong * 32)()
        result["cycles"] = {}
        for (k, b), fn in calls.items():
            fn()
            torch.cuda.synchronize()
            if k == "step":
                result["cycles"][f"{k}@{b}"] = step_stamps(torch, lib, b)
                continue
            build.check(lib.pft_read_stamps(ctypes.addressof(buf)), "pft_read_stamps")
            row = list(buf)[16 if k == "B" else 0:][:len(PHASES) + 1]
            result["cycles"][f"{k}@{b}"] = dict(
                zip(PHASES, [row[i + 1] - row[i] for i in range(len(PHASES))]),
                total=row[-1] - row[0])
    return result


def step_stamps(torch, lib, bsz: int) -> dict:
    """Cycles per phase of block 0 of the last step launch (BOOLEAN_128),
    the first and last blocks' start and end on the global timer (ns from
    the first start), and the clusters the card holds at once."""
    import ctypes

    from primus_fhe_tpu_torch import params as P
    from primus_fhe_tpu_torch.decompose import ApproxSignedBasis32
    from primus_fhe_tpu_torch.lattice import tfhe
    from primus_fhe_tpu_torch.ops import build, cmux_fused

    lib.pft_read_step_stamps.argtypes = [ctypes.c_void_p] * 3
    lib.pft_step_clusters.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    stamps = (ctypes.c_longlong * 32)()
    count = ctypes.c_int()
    gt = (ctypes.c_ulonglong * 4)()
    build.check(lib.pft_read_step_stamps(ctypes.addressof(stamps), ctypes.addressof(count),
                                         ctypes.addressof(gt)), "pft_read_step_stamps")
    p = P.BOOLEAN_128
    basis = ApproxSignedBasis32(None, p.log_basis, reverse_length=p.level)
    conv = tfhe.make_convolver(p.log_n, p.level, p.glwe_dim, p.log_basis)
    plan = cmux_fused.CmuxStepPlan(conv, basis, p.glwe_dim + 1, torch.device("cuda", 0))
    clusters = ctypes.c_int()
    build.check(lib.pft_step_clusters(ctypes.c_void_p(plan.pack.ctypes.data), bsz,
                                      ctypes.addressof(clusters)), "pft_step_clusters")
    passes = (p.log_n + 2) // 3
    names = (["digits + forward pass 1"] + [f"forward pass {i}" for i in range(2, passes + 1)]
             + ["key rows wait", "MAC (thread 0)", "tables wait (thread 0)", "cluster sync 1",
                "inverse pass 1 (row sum)", "inverse passes 2+, CRT push (thread 0)",
                "cluster sync 2", "CRT (thread 0)"])
    row = list(stamps)[:count.value]
    if len(row) != len(names) + 1:
        raise SystemExit(f"cmux_mxu_timing: {len(row)} step stamps for {len(names)} phases")
    out = dict(zip(names, [row[i + 1] - row[i] for i in range(len(names))]), total=row[-1] - row[0])
    t0 = gt[0]
    out.update(first_block_ns=[0, gt[1] - t0], last_block_ns=[gt[2] - t0, gt[3] - t0],
               clusters_at_once=clusters.value)
    return out


def subprocess_run(root: Path, *extra: str) -> dict:
    out = subprocess.run([sys.executable, str(HERE / "cmux_mxu_timing.py"), "--root", str(root),
                          *extra], capture_output=True, text=True)
    if out.returncode != 0:
        raise SystemExit(f"run under {root} failed:\n{out.stdout}\n{out.stderr}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def stamped_copy() -> Path:
    """The package copied to .proof/phases with clock64() stamps in block 0
    of kernels A and B after every phase barrier."""
    root = HERE / ".proof" / "phases"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(HERE / "primus_fhe_tpu_torch", root / "primus_fhe_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    src = root / "primus_fhe_tpu_torch" / "csrc" / "cmux_mxu.cu"
    text = src.read_text()
    stamp = ("if (threadIdx.x == 0 && blockIdx.x == 0) "
             "pft_stamps[(NTRU ? 16 : 0) + pft_k++] = clock64();")
    text = text.replace("namespace {\n", "__device__ long long pft_stamps[32];\nnamespace {\n", 1)
    start = "  cluster.sync();\n\n  const uint32_t* acc"
    text = text.replace(start, start.replace("\n\n", f"\n  int pft_k = 0;\n  {stamp}\n\n"), 1)
    text = text.replace("bar_sync(1, CONSUMERS);", f"bar_sync(1, CONSUMERS); {stamp}")
    text = re.sub(r"(cluster\.sync\(\);  // (no block leaves|keep every block)[^\n]*\n)",
                  lambda m: m.group(1) + f"    {stamp}\n", text)
    reader = ("int pft_read_stamps(void* host) {\n"
              "  return (int)cudaMemcpyFromSymbol(host, pft_stamps, sizeof(pft_stamps));\n}\n")
    text = text.replace('extern "C" {\n', 'extern "C" {\n\n' + reader, 1)
    if text.count(stamp) != 9:  # the start, six phase barriers, the two tails
        raise SystemExit("cmux_mxu_timing: cmux_mxu.cu's phase barriers moved; update the stamps")
    src.write_text(text)
    stamp_step(root / "primus_fhe_tpu_torch" / "csrc" / "cmux_fused.cu")
    return root


def stamp_step(src: Path) -> None:
    """clock64() stamps in block 0 of the step kernel after every barrier of
    its body, the global timer at the start and end of the first and last
    blocks, and C entries that read them and the kernel's cluster
    occupancy."""
    text = src.read_text()
    head = "cmux_step_kernel(const StepArgs a) {\n"
    start, end = text.index(head) + len(head), text.index("\nint threads_for")
    body = text[start:end]
    stamp = ("if (threadIdx.x == 0 && blockIdx.x == 0) "
             "pft_step_stamps[pft_step_n = pft_k++] = clock64();")
    timer = ("{{ unsigned long long t; asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t)); "
             "if (threadIdx.x == 0 && blockIdx.x == 0) pft_step_gt[{0}] = t; "
             "if (threadIdx.x == 0 && blockIdx.x == gridDim.x - 1) pft_step_gt[{1}] = t; }}")
    first = "  const int tid = threadIdx.x, nt = blockDim.x;\n"
    body = body.replace(first, first + f"  int pft_k = 0;\n  {timer.format(0, 2)}\n  {stamp}\n", 1)
    body = body.replace("__syncthreads();", f"__syncthreads(); {stamp}")
    body = body.replace("cp_async_wait<0>();", f"{stamp} cp_async_wait<0>();")
    body = body.replace("cluster.sync();", f"{stamp} cluster.sync(); {stamp}")
    at = body.rindex("}")  # the kernel's closing brace
    body = body[:at] + f"  {stamp} {timer.format(1, 3)}\n" + body[at:]
    text = text[:start] + body + text[end:]
    text = text.replace("namespace {\n", "__device__ long long pft_step_stamps[32];\n"
                        "__device__ int pft_step_n;\n__device__ unsigned long long pft_step_gt[4];\n"
                        "namespace {\n", 1)
    reader = ("int pft_read_step_stamps(void* stamps, void* count, void* gt) {\n"
              "  cudaError_t e = cudaMemcpyFromSymbol(stamps, pft_step_stamps, "
              "sizeof(pft_step_stamps));\n"
              "  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(count, pft_step_n, sizeof(int));\n"
              "  if (e == cudaSuccess) *(int*)count += 1;\n"
              "  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(gt, pft_step_gt, "
              "sizeof(pft_step_gt));\n"
              "  return (int)e;\n}\n"
              "int pft_step_clusters(const void* plan, int bsz, int* out) {\n"
              "  StepArgs a{};\n  cudaLaunchConfig_t cfg;\n  cudaLaunchAttribute attr;\n"
              "  const int err = configure((const uint64_t*)plan, bsz, nullptr, &a, &cfg, &attr);\n"
              "  if (err != 0) return err;\n"
              "  return (int)cudaOccupancyMaxActiveClusters(out, cmux_step_kernel, &cfg);\n}\n")
    text = text.replace('extern "C" {\n', 'extern "C" {\n\n' + reader, 1)
    if body.count(stamp) < 11:
        raise SystemExit("cmux_mxu_timing: cmux_fused.cu's barriers moved; update the stamps")
    src.write_text(text)


def kernel_region(text: str, begin: str, end: str) -> tuple[str, str, str]:
    """``text`` split around the kernel whose definition holds ``begin``
    (its ``__global__`` line on) up to ``end``."""
    at = text.index("__global__", text.index(begin) - 200)
    stop = text.index(end, at)
    return text[:at], text[at:stop], text[stop:]


FWD_PHASES = ("w1 wait", "pass 1 twiddles + chunk wait", "pass 1 wgmma",
              "pass 1 copies + epilogue + cluster barrier", "pass 2 stage waits",
              "pass 2 wgmma + release", "pass 2 swap + epilogue")


def stamp_forward(src: Path) -> None:
    """clock64() laps of thread 0 of block 0 of ``mxu8_forward64``'s kernel,
    summed per phase over its chunks and stages (:data:`FWD_PHASES`), the
    global timer at the first and last blocks' start and end, and a C entry
    that reads them."""
    text = src.read_text()
    lap = ("{{ long long pft_n = clock64(); pft_c[{0}] += pft_n - pft_t; pft_t = pft_n; }}")
    edits = [
        ("  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n",
         "  long long pft_c[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n  long long pft_t = clock64();\n"),
        ("    for (int kk = 0; kk < geo.k1c; ++kk) wait_full(wg * geo.k1c + kk);\n",
         lap.format(0) + "\n"),
        ("  for (int ch = rank; ch < chunks; ch += geo.C) {\n", "    " + lap.format(3) + "\n"),
        ("    bar_sync(1, FWD_CONSUMERS);  // chunk ch is in sc\n", "    " + lap.format(1) + "\n"),
        ("      wgmma_commit();\n      wgmma_wait<0>();\n      wg_fence_regs(d);\n    }\n",
         lap.format(2) + "\n"),
        ("  cluster.sync();  // every operand row of every block of the cluster is written\n",
         lap.format(3) + "\n"),
        ("      wait_full(it);\n", "      " + lap.format(4) + "\n"),
        ("        release(it - 1);\n      }\n    }\n", None),
    ]
    pre, body, post = kernel_region(text, "ntt_mxu8_forward64_kernel(",
                                    "// The launch of a (R, S) grid")
    for anchor, add in edits:
        if body.count(anchor) != 1:
            raise SystemExit(f"cmux_mxu_timing: ntt_mxu8.cu changed near {anchor.strip()!r}")
        if anchor.startswith("      wait_full"):
            body = body.replace(anchor, "      " + lap.format(6) + "\n" + anchor + add)
        elif anchor.startswith("        release"):
            body = body.replace(anchor, anchor[:-6] + "      " + lap.format(5) + "\n    }\n")
        else:
            body = body.replace(anchor, anchor + add)
    text = pre + body + post
    timer = ("{{ unsigned long long tg; asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(tg)); "
             "if (threadIdx.x == 0 && blockIdx.x == 0) pft_fwd_gt[{0}] = tg; "
             "if (threadIdx.x == 0 && blockIdx.x == gridDim.x - 1) pft_fwd_gt[{1}] = tg; }}")
    head = "  extern __shared__ __align__(16) uint8_t smem[];\n  constexpr int B = PFT_MXU_B;\n  const FwdGeometry"
    if text.count(head) != 1:
        raise SystemExit("cmux_mxu_timing: the forward kernel's head moved")
    text = text.replace(head, "  " + timer.format(0, 2) + "\n" + head)
    tail = "  }\n}\n\n// The launch of a (R, S) grid"
    if text.count(tail) != 1:
        raise SystemExit("cmux_mxu_timing: the forward kernel's tail moved")
    text = text.replace(tail, "  }\n  " + lap.format(6) + "\n  if (threadIdx.x == 0 && blockIdx.x == 0)"
                        " for (int k = 0; k < 7; ++k) pft_fwd_stamps[k] = pft_c[k];\n  "
                        + timer.format(1, 3) + "\n}\n\n// The launch of a (R, S) grid")
    text = text.replace("namespace {\n", "__device__ long long pft_fwd_stamps[8];\n"
                        "__device__ unsigned long long pft_fwd_gt[4];\nnamespace {\n", 1)
    reader = ("int pft_read_fwd_stamps(void* stamps, void* gt) {\n"
              "  cudaError_t e = cudaMemcpyFromSymbol(stamps, pft_fwd_stamps, sizeof(pft_fwd_stamps));\n"
              "  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(gt, pft_fwd_gt, sizeof(pft_fwd_gt));\n"
              "  return (int)e;\n}\n")
    text = text.replace('extern "C" {\n', 'extern "C" {\n\n' + reader, 1)
    src.write_text(text)


INV_PHASES = ("load + barrier", "pass 1 stage waits", "pass 1 wgmma + release",
              "pass 1 epilogue", "pass 2 barrier + wi2 wait", "pass 2 wgmma",
              "pass 2 epilogue")


def stamp_inverse(src: Path) -> None:
    """clock64() laps of thread 0 of block 0 of the inverse kernel
    (``mxu8_inverse64`` and D), summed per phase over its column groups,
    stages and tasks (:data:`INV_PHASES`), the global timer at the first and
    last blocks' start and end, and a C entry that reads them."""
    text = src.read_text()
    lap = "{{ long long pft_n = clock64(); pft_c[{0}] += pft_n - pft_t; pft_t = pft_n; }}"
    pre, body, post = kernel_region(text, "ntt_mxu8_inverse64_kernel(",
                                    "template <int P, bool MUL>\nint launch_inverse64(")
    timer = ("{{ unsigned long long tg; asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(tg)); "
             "if (threadIdx.x == 0 && blockIdx.x == 0) pft_inv_gt[{0}] = tg; "
             "if (threadIdx.x == 0 && blockIdx.x == gridDim.x - 1) pft_inv_gt[{1}] = tg; }}")
    edits = [  # (anchor, count, text before it, text after it)
        ("  extern __shared__ __align__(16) uint8_t smem[];\n", 1, "  " + timer.format(0, 2) + "\n",
         ""),
        ("  const int wg = warp >> 2, wt = tid & 127, ww = wt >> 5;\n", 1, "",
         "  long long pft_c[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n  long long pft_t = clock64();\n"),
        ("  bar_sync(1, FWD_CONSUMERS);  // every operand row of pass 1 is written\n", 1, "",
         "  " + lap.format(0) + "\n"),
        ("        wait_full(it);\n", 2, "        " + lap.format("kc == 0 ? 3 : 2") + "\n",
         "        " + lap.format(1) + "\n"),  # the epilogue before a group's first stage
        ("      if (last) release(xfree);", 2, lap.format(2) + "\n      ", ""),
        ("  fence_proxy_async();\n  bar_sync(1, FWD_CONSUMERS);  // every operand row of pass 2", 1,
         "  " + lap.format(3) + "\n", ""),
        ("  mbar_wait(w2full, 0);\n", 1, "", "  " + lap.format(4) + "\n"),
        ("    const int mt = t / geo.g1, g = t - mt * geo.g1;\n", 1, "",
         "    " + lap.format(6) + "\n"),
        ("    wgmma_commit();\n    wgmma_wait<0>();\n    wg_fence_regs(d);\n", 1, "",
         "    " + lap.format(5) + "\n"),
    ]
    for anchor, count, before, after in edits:
        if body.count(anchor) != count:
            raise SystemExit(f"cmux_mxu_timing: the inverse kernel changed near {anchor.strip()!r}")
        body = body.replace(anchor, before + anchor + after)
    if not body.endswith("  }\n}\n\n"):
        raise SystemExit("cmux_mxu_timing: the inverse kernel's tail moved")
    body = body[:-len("}\n\n")] + ("  " + lap.format(6) + "\n  if (threadIdx.x == 0 && blockIdx.x == 0)"
                                    " for (int k = 0; k < 7; ++k) pft_inv_stamps[k] = pft_c[k];\n  "
                                    + timer.format(1, 3) + "\n}\n\n")
    text = pre + body + post
    text = text.replace("namespace {\n", "__device__ long long pft_inv_stamps[8];\n"
                        "__device__ unsigned long long pft_inv_gt[4];\nnamespace {\n", 1)
    reader = ("int pft_read_inv_stamps(void* stamps, void* gt) {\n"
              "  cudaError_t e = cudaMemcpyFromSymbol(stamps, pft_inv_stamps, sizeof(pft_inv_stamps));\n"
              "  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(gt, pft_inv_gt, sizeof(pft_inv_gt));\n"
              "  return (int)e;\n}\n")
    text = text.replace('extern "C" {\n', 'extern "C" {\n\n' + reader, 1)
    src.write_text(text)


def stamp_rt(src: Path) -> None:
    """clock64() laps of thread 0 of block 0 of kernel E
    (``ntt64_roundtrip_kernel`` in ``ntt64.cu``) after each pass's barrier:
    the load with the forward's first pass, the table wait, the forward's
    middle passes, the fused pass (the forward's last pass, the key, the
    inverse's first), the inverse's middle passes (its ``inv_rest`` written
    out) and the last pass with the stores; the earliest block start and
    the latest block end on the global timer; and a C entry
    ``pft_read_rt_stamps`` that reads them and resets the span."""
    text = src.read_text()
    lap = "if (threadIdx.x == 0 && blockIdx.x == 0) pft_rt_stamps[pft_k++] = clock64();"
    timer = ("{{ unsigned long long tg; asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(tg)); "
             "if (threadIdx.x == 0) atomic{0}(&pft_rt_gt[{1}], tg); }}")
    pre, body, post = kernel_region(text, "ntt64_roundtrip_kernel(",
                                    "// What the launches read of a device")
    edits = [  # (anchor, text after it)
        ("  extern __shared__ __align__(16) uint64_t sm[];\n",
         f"  int pft_k = 0;\n  {timer.format('Min', 0)}\n  {lap}\n"),
        ("              AnyIn64{a.in + t.off, log_n, q, c.p1}, rows);\n", f"  {lap}\n"),
        ("  cp_async_wait<0>();\n  __syncthreads();\n", f"  {lap}\n"),
        ("    fwd_pass<3>(t.count, log_n, s0, table, q, rows, rows);\n    __syncthreads();\n",
         f"    {lap}\n"),
        ("  if (r == 1) inv_pass<1, Last::no>(t.count, log_n, 0, global, c, mid, rows);\n"
         "  __syncthreads();\n", f"  {lap}\n"),
    ]
    for anchor, after in edits:
        if body.count(anchor) != 1:
            raise SystemExit(f"cmux_mxu_timing: kernel E changed near {anchor.strip()!r}")
        body = body.replace(anchor, anchor + after)
    rest = "  inv_rest<Last::canonical>(rows, t.count, log_n, r, staged, c, dst);\n"
    if body.count(rest) != 1:
        raise SystemExit("cmux_mxu_timing: kernel E's inverse passes moved")
    body = body.replace(rest, (
        "  for (int s0 = r; s0 < log_n - 3; s0 += 3) {\n"
        "    inv_pass<3, Last::no>(t.count, log_n, s0, staged, c, rows, rows);\n"
        f"    __syncthreads();\n    {lap}\n  }}\n"
        "  inv_pass<3, Last::canonical>(t.count, log_n, log_n - 3, staged, c, rows, dst);\n"
        f"  {lap}\n  {timer.format('Max', 1)}\n"))
    text = pre + body + post
    text = text.replace("namespace {\n", "__device__ long long pft_rt_stamps[16];\n"
                        "__device__ unsigned long long pft_rt_gt[2] = {~0ull, 0ull};\n"
                        "namespace {\n", 1)
    reader = ("int pft_read_rt_stamps(void* stamps, void* gt) {\n"
              "  cudaError_t e = cudaMemcpyFromSymbol(stamps, pft_rt_stamps, sizeof(pft_rt_stamps));\n"
              "  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(gt, pft_rt_gt, sizeof(pft_rt_gt));\n"
              "  const unsigned long long reset[2] = {~0ull, 0ull};\n"
              "  if (e == cudaSuccess) e = cudaMemcpyToSymbol(pft_rt_gt, reset, sizeof(reset));\n"
              "  return (int)e;\n}\n")
    text = text.replace('extern "C" {\n', 'extern "C" {\n\n' + reader, 1)
    src.write_text(text)


def rt_stamps(torch) -> dict:
    """In a ``--ntt --phases`` copy (:func:`stamp_rt`): block 0's cycles per
    pass of kernel E's last launch at each of its shapes, and the launch's
    span on the device (earliest block start to latest block end, ns)
    beside its event-timed device ms."""
    import ctypes

    from primus_fhe_tpu_torch.ops import build

    read = build.library().pft_read_rt_stamps
    read.argtypes = [ctypes.c_void_p] * 2
    out = {}
    for (name, label), (fn, _, tables, _, _, _) in ntt_calls(torch,
                                                             torch.device("cuda", 0)).items():
        if name != "mxu8_roundtrip64_mul":
            continue
        ms = device_ms(torch, fn)
        stamps = (ctypes.c_longlong * 16)()
        gt = (ctypes.c_ulonglong * 2)()
        build.check(read(ctypes.addressof(stamps), ctypes.addressof(gt)), "read stamps")
        fn()
        torch.cuda.synchronize()
        build.check(read(ctypes.addressof(stamps), ctypes.addressof(gt)), "read stamps")
        p = -(-tables.log_n // 3)
        names = (["load + forward pass 1", "table wait + barrier"]
                 + [f"forward pass {i}" for i in range(2, p)]
                 + [f"forward pass {p} + key + inverse pass 1"]
                 + [f"inverse pass {i}" for i in range(2, p)] + [f"inverse pass {p} (stores)"])
        laps = list(stamps)[:len(names) + 1]
        row = dict(zip(names, [laps[i + 1] - laps[i] for i in range(len(names))]))
        row.update(total_cycles=laps[-1] - laps[0], span_ns=gt[1] - gt[0], event_ms=ms)
        out[f"{name}@{label}"] = row
    return out


def kernel_stamps(torch) -> dict:
    """Cycles per phase of block 0's thread 0 in the last launch of each
    byte-radix transform at each shape (the launch's own grid), and the
    first and last blocks' start and end on the global timer (ns from the
    first start): the forward's (:data:`FWD_PHASES`), the inverse's and
    D's (:data:`INV_PHASES`)."""
    import ctypes

    from primus_fhe_tpu_torch.ops import build

    lib = build.library()
    readers = {"mxu8_forward64": (lib.pft_read_fwd_stamps, FWD_PHASES),
               "mxu8_inverse64": (lib.pft_read_inv_stamps, INV_PHASES),
               "mxu8_inverse64_mul": (lib.pft_read_inv_stamps, INV_PHASES)}
    out = {}
    for (name, label), (fn, _, _, _, _, _) in ntt_calls(torch, torch.device("cuda", 0)).items():
        if name not in readers:
            continue
        read, phases = readers[name]
        read.argtypes = [ctypes.c_void_p] * 2
        fn()
        torch.cuda.synchronize()
        stamps = (ctypes.c_longlong * 8)()
        gt = (ctypes.c_ulonglong * 4)()
        build.check(read(ctypes.addressof(stamps), ctypes.addressof(gt)), "read stamps")
        row = dict(zip(phases, list(stamps)[:len(phases)]))
        row.update(total=sum(list(stamps)[:len(phases)]), first_block_ns=[0, gt[1] - gt[0]],
                   last_block_ns=[gt[2] - gt[0], gt[3] - gt[0]])
        out[f"{name}@{label}"] = row
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, help="import primus_fhe_tpu_torch from this directory")
    ap.add_argument("--compare", type=Path, help="time OLD and this checkout in turns")
    ap.add_argument("--phases", action="store_true", help="cycles per phase, stamped copy")
    ap.add_argument("--ntt", action="store_true", help="the u64 transforms only")
    ap.add_argument("--ntt32", action="store_true", help="kernels 1-2 and the NTT-key step only")
    ap.add_argument("--ntt64", action="store_true", help="row 10's butterfly kernels only")
    ap.add_argument("--split", action="store_true", help="row 13's four halves only")
    ap.add_argument("--stages", action="store_true", help="row 11's stage kernels only")
    ap.add_argument("--keyprep", action="store_true", help="kernel C and kernel 1 at C's shapes")
    ap.add_argument("--rotate", action="store_true", help="kernel F at its paths' shapes")
    ap.add_argument("--front", action="store_true", help="kernel G at its three shapes")
    ap.add_argument("--stage2", action="store_true", help="kernels H and J at their paths' shapes")
    ap.add_argument("--grids", action="store_true", help="the byte-radix kernels on every grid")
    ap.add_argument("--stamps", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.root is not None:
        sys.path.insert(0, str(args.root.resolve()))
        if args.stamps and (args.keyprep or args.rotate or args.front):
            import torch

            dev = torch.device("cuda", 0)
            if args.grids:
                res = {"grids": (keyprep_grids if args.keyprep else front_grids)(torch, dev)}
            else:
                res = {"cycles": (keyprep_stamps if args.keyprep else rotate_stamps
                                  if args.rotate else front_stamps)(torch, dev)}
            print(json.dumps(res), flush=True)
            return
        if args.stamps and args.stage2:
            import torch

            dev = torch.device("cuda", 0)
            print(json.dumps({"grids": stage2_grids(torch, dev)} if args.grids
                             else {"cycles": stage2_stamps(torch, dev)}), flush=True)
            return
        if args.stamps and args.stages:
            import torch

            dev = torch.device("cuda", 0)
            res = ({"cycles": stage_stamps(torch, dev)} if args.phases
                   else {"grids": stage_grids(torch, dev)})
            print(json.dumps(res), flush=True)
            return
        if args.stamps and args.split:
            import torch

            dev = torch.device("cuda", 0)
            res = ({"cycles": split_stamps(torch, dev)} if args.phases
                   else {"tiles": split_grids(torch, dev)})
            print(json.dumps(res), flush=True)
            return
        if args.stamps and (args.ntt32 or args.ntt64):
            import torch

            dev = torch.device("cuda", 0)
            stamps, tiles = ((ntt32_stamps, tile_times) if args.ntt32
                             else (ntt64_stamps, tile_times64))
            res = ({"cycles": stamps(torch, dev)} if args.phases
                   else {"tiles": tiles(torch, dev)})
            print(json.dumps(res), flush=True)
            return
        if args.stamps and (args.ntt or args.grids):
            import torch

            res = ({"grids": grid_times(torch, torch.device("cuda", 0))} if args.grids
                   else {"cycles": {**kernel_stamps(torch), **rt_stamps(torch)}})
            print(json.dumps(res), flush=True)
            return
        print(json.dumps(run_here(args.stamps, args.ntt, args.ntt32, args.ntt64, args.split,
                                  args.stages, args.keyprep, args.rotate, args.front,
                                  args.stage2)),
              flush=True)
        return
    print(card(), flush=True)
    if args.stage2 and args.grids:
        root = HERE / ".proof" / "stage2_grids"
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(HERE / "primus_fhe_tpu_torch", root / "primus_fhe_tpu_torch",
                        ignore=shutil.ignore_patterns("build", "__pycache__"))
        csrc = root / "primus_fhe_tpu_torch" / "csrc"
        stamp_stage2_grids(csrc / "cmux_stage2.cu", "h_pick",
                           "held_clusters(kp, log_n, *lc, held)", "h")
        stamp_stage2_grids(csrc / "ntru_stage.cu", "j_pick", "j_held(log_n, *lc, held)", "j")
        res = subprocess_run(root, "--stamps", "--stage2", "--grids")
        for key, row in res["grids"].items():
            print(key, json.dumps(row), flush=True)
        res["card"] = card()
        print(json.dumps(res), flush=True)
        return
    if args.stage2 and args.phases:  # this checkout's stamped copy, OLD's beside it in turns
        sides = [("new", HERE)] + ([("old", args.compare)] if args.compare else [])
        roots = {}
        for side, base in sides:
            root = HERE / ".proof" / f"stage2_phases_{side}"
            shutil.rmtree(root, ignore_errors=True)
            shutil.copytree(base / "primus_fhe_tpu_torch", root / "primus_fhe_tpu_torch",
                            ignore=shutil.ignore_patterns("build", "__pycache__"))
            csrc = root / "primus_fhe_tpu_torch" / "csrc"
            stamp_stage2(csrc / "cmux_stage2.cu", "cmux_stage2_kernel", "h")
            stamp_stage2(csrc / "ntru_stage.cu", "ntru_stage2_kernel", "j")
            roots[side] = root
        order = ["old", "new", "new", "old"] if args.compare else ["new"]
        runs = []
        for side in order:
            res = subprocess_run(roots[side], "--stamps", "--stage2", "--phases")
            res["side"] = side
            for key, row in res["cycles"].items():
                print(side, key, json.dumps(row), flush=True)
            runs.append(res)
        print(json.dumps({"card": card(), "runs": runs}), flush=True)
        return
    if args.front and (args.grids or args.phases):
        runs = {}
        for tag, stamp in ((("front_phases", stamp_front),) if args.phases else
                           (("front_grids", lambda src: stamp_front_grids(src, False)),
                            ("front_grids_wb", lambda src: stamp_front_grids(src, True)))):
            root = HERE / ".proof" / tag
            shutil.rmtree(root, ignore_errors=True)
            shutil.copytree(HERE / "primus_fhe_tpu_torch", root / "primus_fhe_tpu_torch",
                            ignore=shutil.ignore_patterns("build", "__pycache__"))
            stamp(root / "primus_fhe_tpu_torch" / "csrc" / "cmux_front.cu")
            res = subprocess_run(root, "--stamps", "--front",
                                 "--phases" if args.phases else "--grids")
            for key, row in res["cycles" if args.phases else "grids"].items():
                print(tag, key, json.dumps(row), flush=True)
            runs[tag] = res
        print(json.dumps({"card": card(), **runs}), flush=True)
        return
    if (args.keyprep and args.grids) or ((args.keyprep or args.rotate) and args.phases):
        tag = "keyprep" if args.keyprep else "rotate"
        kind = "grids" if args.grids else "phases"
        root = HERE / ".proof" / f"{tag}_{kind}"
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(HERE / "primus_fhe_tpu_torch", root / "primus_fhe_tpu_torch",
                        ignore=shutil.ignore_patterns("build", "__pycache__"))
        csrc = root / "primus_fhe_tpu_torch" / "csrc"
        src = csrc / ("ntt32.cu" if args.keyprep else "cmux_front.cu")
        {("keyprep", "phases"): stamp_keyprep, ("rotate", "phases"): stamp_rotate,
         ("keyprep", "grids"): stamp_keyprep_grids}[tag, kind](src)
        res = subprocess_run(root, "--stamps", f"--{tag}", f"--{kind}")
        for key, row in res["cycles" if kind == "phases" else "grids"].items():
            print(key, json.dumps(row), flush=True)
        res["card"] = card()
        print(json.dumps(res), flush=True)
        return
    if args.stages and (args.grids or args.phases):
        root = HERE / ".proof" / f"stages_{'grids' if args.grids else 'phases'}"
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(HERE / "primus_fhe_tpu_torch", root / "primus_fhe_tpu_torch",
                        ignore=shutil.ignore_patterns("build", "__pycache__"))
        stamp_stages(root / "primus_fhe_tpu_torch" / "csrc" / "ntt_stages.cu", args.phases)
        res = subprocess_run(root, "--stamps", "--stages",
                             "--phases" if args.phases else "--grids")
        for key, row in res["cycles" if args.phases else "grids"].items():
            print(key, json.dumps(row), flush=True)
        res["card"] = card()
        print(json.dumps(res), flush=True)
        return
    if args.split and (args.grids or args.phases):
        root = HERE / ".proof" / f"split_{'tiles' if args.grids else 'phases'}"
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(HERE / "primus_fhe_tpu_torch", root / "primus_fhe_tpu_torch",
                        ignore=shutil.ignore_patterns("build", "__pycache__"))
        stamp_split(root / "primus_fhe_tpu_torch" / "csrc" / "ntt_mxu8_split.cu", args.phases)
        res = subprocess_run(root, "--stamps", "--split",
                             "--phases" if args.phases else "--grids")
        for key, row in res["cycles" if args.phases else "tiles"].items():
            print(key, json.dumps(row), flush=True)
        res["card"] = card()
        print(json.dumps(res), flush=True)
        return
    if (args.ntt32 or args.ntt64) and (args.grids or args.phases):
        tag = "ntt32" if args.ntt32 else "ntt64"
        root = HERE / ".proof" / f"{tag}_{'tiles' if args.grids else 'phases'}"
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(HERE / "primus_fhe_tpu_torch", root / "primus_fhe_tpu_torch",
                        ignore=shutil.ignore_patterns("build", "__pycache__"))
        src = root / "primus_fhe_tpu_torch" / "csrc" / f"{tag}.cu"
        if args.grids and args.ntt32:
            stamp_tiles(src, "ntt32", "  a.tile = pick_tile(forward, kp, rows, log_n, *d);\n",
                        "true")
        elif args.grids:
            stamp_tiles(src, "ntt64", "  a.tile = pick_tile(forward, count, rows, log_n, *d);\n",
                        "!log_split(log_n)")
        else:
            (stamp_ntt32 if args.ntt32 else stamp_ntt64)(src)
        res = subprocess_run(root, "--stamps", f"--{tag}", *(() if args.grids else ("--phases",)))
        for key, row in res["tiles" if args.grids else "cycles"].items():
            print(key, json.dumps(row), flush=True)
        res["card"] = card()
        print(json.dumps(res), flush=True)
        return
    if args.grids or (args.phases and args.ntt):
        root = HERE / ".proof" / ("fwd_grids" if args.grids else "fwd_phases")
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(HERE / "primus_fhe_tpu_torch", root / "primus_fhe_tpu_torch",
                        ignore=shutil.ignore_patterns("build", "__pycache__"))
        src = root / "primus_fhe_tpu_torch" / "csrc" / "ntt_mxu8.cu"
        rt_src = root / "primus_fhe_tpu_torch" / "csrc" / "ntt64.cu"
        if args.grids:
            stamp_grids(src)
            stamp_tiles(rt_src, "rt64", "  a.tile = pick_tile(ROUNDTRIP, count, rows, log_n, *d);\n",
                        "true", "rt_smem_bytes(log_n, a.tile)")
        else:
            stamp_forward(src)
            stamp_inverse(src)
            stamp_rt(rt_src)
        res = subprocess_run(root, "--stamps", "--grids" if args.grids else "--ntt")
        for key, row in res["grids" if args.grids else "cycles"].items():
            print(key, json.dumps(row), flush=True)
        res["card"] = card()
        print(json.dumps(res), flush=True)
        return
    if args.phases:
        res = subprocess_run(stamped_copy(), "--stamps")
        for key, cyc in res["cycles"].items():
            print(key, json.dumps(cyc), flush=True)
        print(json.dumps(res), flush=True)
        return
    if args.compare is None:
        sys.path.insert(0, str(HERE))
        print(json.dumps(run_here(False, args.ntt, args.ntt32, args.ntt64, args.split,
                                  args.stages, args.keyprep, args.rotate, args.front,
                                  args.stage2)),
              flush=True)
        return
    runs = []
    extra = (("--ntt",) if args.ntt else ("--ntt32",) if args.ntt32 else ("--ntt64",)
             if args.ntt64 else ("--split",) if args.split else ("--stages",) if args.stages
             else ("--keyprep",) if args.keyprep else ("--rotate",) if args.rotate
             else ("--front",) if args.front else ("--stage2",) if args.stage2 else ())
    for side, root in (("old", args.compare), ("new", HERE), ("new", HERE), ("old", args.compare)):
        res = subprocess_run(root, *extra)
        res["side"] = side
        runs.append(res)
        print(json.dumps(res), flush=True)

    def mean(key, fields):
        return {side: {f: sum(fields(r)[f] for r in runs if r["side"] == side) / 2
                       for f in fields(runs[0])} for side in ("old", "new")} if key in runs[0] else {}

    ntt = mean("ntt", lambda r: {k: v["ms"] for k, v in r["ntt"].items()})
    if ntt:
        ntt["share_new"] = {k: runs[1]["ntt"][k]["bound_ms"] / ntt["new"][k] for k in ntt["new"]
                            if "bound_ms" in runs[1]["ntt"][k]}
        # kernel E against row 10's two launches and against forward + D
        ntt["rt_yardstick_new"] = {label: {
            "E / (ntt64_forward + ntt64_inverse)": ntt["new"][f"mxu8_roundtrip64_mul@{label}"]
            / (ntt["new"][f"ntt64_forward@{label}"] + ntt["new"][f"ntt64_inverse@{label}"]),
            "E / (mxu8_forward64 + D)": ntt["new"][f"mxu8_roundtrip64_mul@{label}"]
            / (ntt["new"][f"mxu8_forward64@{label}"] + ntt["new"][f"mxu8_inverse64_mul@{label}"]),
        } for label, *_ in D_SHAPES}
    host = mean("ntt", lambda r: {f"{k}:{part}": us for k, v in r["ntt"].items()
                                  for part, us in v.get("host", {}).items()})
    split = mean("split", lambda r: {k: v["ms"] or 0.0 for k, v in r["split"].items()})
    if split:  # the table's ratios: new / old, the new run's share of the bound; the trips' busy ms
        split["host_us"] = {side: {k: [(r["split"][k]["queued_us"], r["split"][k]["idle_us"])
                                       for r in runs if r["side"] == side]
                                   for k in runs[0]["split"] if "idle_us" in runs[0]["split"][k]}
                            for side in ("old", "new")}
        for field in ("device_ms", "enqueue_ms"):
            split[field] = {side: {k: [r["split"][k].get(field) for r in runs
                                       if r["side"] == side]
                                   for k in runs[0]["split"] if k.startswith("sharded")}
                            for side in ("old", "new")}
        split["new_over_old"] = {k: split["new"][k] / split["old"][k] if split["old"][k]
                                 else None for k in split["new"]}
        split["share_new"] = {k: runs[1]["split"][k]["bound_ms"] / split["new"][k]
                              for k in split["new"]
                              if "bound_ms" in runs[1]["split"][k] and split["new"][k]}
    stages = mean("stages", lambda r: {k: v.get("ms") or 0.0 for k, v in r["stages"].items()
                                       if "ms" in v})
    if stages:  # new / old per shape (None where the old side refused it), the new share
        stages["new_over_old"] = {k: stages["new"][k] / stages["old"][k] if stages["old"][k]
                                  else None for k in stages["new"]}
        stages["share_new"] = {k: runs[1]["stages"][k]["bound_ms"] / stages["new"][k]
                               for k in stages["new"]
                               if "bound_ms" in runs[1]["stages"][k] and stages["new"][k]}
        for field in ("device_ms", "enqueue_ms", "idle"):
            stages[field] = {side: {k: [r["stages"][k].get(field) for r in runs
                                        if r["side"] == side]
                                    for k in runs[0]["stages"] if "coeff trip" in k}
                             for side in ("old", "new")}
    for tag in ("keyprep", "rotate", "front", "stage2"):  # new / old per shape; C over kernel 1
        if tag not in runs[0]:
            continue
        m = mean(tag, lambda r, tag=tag: {k: v["ms"] for k, v in r[tag].items()
                                          if isinstance(v, dict) and "ms" in v})
        m["new_over_old"] = {k: m["new"][k] / m["old"][k] for k in m["new"]}
        m["share_new"] = {k: runs[1][tag][k]["bound_ms"] / m["new"][k] for k in m["new"]
                          if "bound_ms" in runs[1][tag][k]}
        if tag == "keyprep":
            m["c_over_kernel1"] = {side: {label: m[side][f"mxu8_forward32@{label}"]
                                          / m[side][f"forward32@{label}"]
                                          for label, *_ in KEYPREP_SHAPES} for side in ("old", "new")}
        elif tag == "stage2":  # each side's grid
            m["grid"] = {r["side"]: {k: v.get("grid") for k, v in r[tag].items()
                                     if isinstance(v, dict) and "grid" in v} for r in runs[:2]}
        elif tag == "rotate":
            m["launches"] = {r["side"]: {k: v.get("launches") for k, v in r[tag].items()
                                         if "launches" in v} for r in runs[:2]}
        else:  # G's launch and ptxas figures on each side
            m["grid"] = {r["side"]: {k: v.get("grid") for k, v in r[tag].items()
                                     if k.startswith("cmux_front@")} for r in runs[:2]}
            m["ptxas"] = {r["side"]: r[tag]["ptxas"] for r in runs[:2]}
        old_regs, new_regs = ptxas_registers(args.compare), ptxas_registers(HERE)
        m["registers_changed"] = {k: [old_regs.get(k), new_regs.get(k)]
                                  for k in sorted(set(old_regs) | set(new_regs))
                                  if old_regs.get(k) != new_regs.get(k)}
        m["registers_same"] = sum(old_regs.get(k) == v for k, v in new_regs.items())
        print(json.dumps({f"mean_{tag}_ms": m}), flush=True)
    summary = {"card": runs[0]["card"], "mean_stages_ms": stages, "mean_split_ms": split,
               "mean_ntt_ms": ntt,
               "mean_host_us": host,
               "mean_ntt32_ms": mean("ntt32", lambda r: {k: v["ms"] for k, v in r["ntt32"].items()}),
               "mean_ntt64_ms": mean("ntt64", lambda r: {k: v["ms"] for k, v in r["ntt64"].items()}),
               "mean_roundtrip_ms": mean("roundtrip", lambda r: {
                   k: v["ms"] for k, v in r["roundtrip"].items()}),
               "mean_ms": mean("ms", lambda r: r["ms"]),
               "mean_rotation": mean("rotation", lambda r: {
                   f"{b}:{m}": r["rotation"][b][m] for b in r["rotation"]
                   for m in r["rotation"][b]}),
               "runs": runs}
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
