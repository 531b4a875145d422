#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``primus_fhe_tpu_torch``) on one
NVIDIA card, at full width: the BOOLEAN_128 profile (N=2048, n_lwe=630,
bootstrap gadget 2^7 x 3, key-switch gadget 2^1 x 12) on both bootstrap-key
kinds, and the NTRU_128 profile (N=1024, q=1038337, n_lwe=700, NGS gadget
2^3 x 6, key switch 2^1 x 16).

Run from the repository root:  ``python3 chip_smoke.py``

Phases (each prints its own lines; any failure raises and the exit code is
non-zero):

1. device facts (``nvidia-smi`` name and power limit, torch and CUDA
   versions) and the kernel build from ``primus_fhe_tpu_torch/csrc``;
2. each of the six kernels (1-2, the one-launch CMux step for 3-4, A, B, C)
   against its plain PyTorch version on the same
   CUDA inputs, at the main paths' shapes, batch 1 and 64 (bit-equal), with
   both times from CUDA events and the kernel's device time from CUDA
   events behind a sleep kernel; kernels A and B also with their int8 MACs
   a second on the device and their share of the bound (their batch-64
   launches run partial and whole clusters of ciphertexts); kernel C also
   at the key preparations' sizes (BOOLEAN_128's whole bootstrap key, 2 x
   7560 rows of 2048; NTRU_128's evk, 4200 rows of 1024) with kernel 1's
   canonical forward on the same words beside it;
3. ``make_context(BOOLEAN_128)`` (NTT key kind) on the card from a seeded
   generator;
4. NAND/AND/OR truth tables, NOT, and NAND(NAND(a,b), NAND(a,b)) == AND(a,b),
   key switch included, with the measured phase error beside the noise
   model's prediction;
5. one bootstrap through the kernels on the card and through the plain
   versions on the CPU, same keys and input: the same words;
6. the launch counts of phases 3-4: every kernel launched, and the CMux
   step kernel exactly once per key slice per bootstrap;
7. single-gate latency at batch 1 and gates/s at batch 64 (truth-checked),
   each split into bootstrap and key switch, with the device's busy time
   and top kernels from ``torch.profiler``, and the launches of the
   bootstrap's start (``initial_accumulator``: the zero fill and kernel F);
8. the MXU key kind (``bsk_kind="mxu"``, same seed as phase 3, so the same
   GGSW material): truth tables and composition with its launch counts
   (kernel A once per key slice per bootstrap, kernel C in key
   preparation), the key preparation's seconds, one bootstrap through both
   key kinds (the same words), and the phase-7 timings on this route;
9. NTRU_128: keys on the card, truth tables and a composition on both
   evaluation keys, each counted on its own: kernel B once a step on the
   MXU pack and on the NTT evk alike (its values are the pack's words; its
   Shoup quotients made once a rotation, timed), no launch of kernels 1-2;
   the same NAND words on both forms, the gate-output phase error and
   decision margin, one bootstrap on each form and through the plain
   versions on the CPU (the same words), the evk preparation's seconds, and
   latency and gates/s on both forms with their ratio;
10. the RNS/DCRT blind rotation at N=4096 over the two 50-bit moduli of
    ``bench_dcrt.py`` (L=4 levels of 2^25, k=1, n_lwe=630, sigma 3.2,
    binary secrets): the four u64 NTT kernels against their plain versions
    at the rotation's shapes (batch 1 and 16), key generation on the card,
    the rotation at batch 1 and 16 on the MXU route (``"auto"``) and the
    butterfly route (the same words) with exact launch counts, the same
    rotation on the CPU through the plain versions (the first 64 key slices
    when all 630 would take over a minute there), decryption within delta/4
    with the phase error beside the noise estimate, and per route the
    rotation ms at batch 1, CMux/s at batch 16, the device's idle share, top
    device rows and host ops per step;
11. the negacyclic product by a fixed NTT-domain operand at ``bench.py``'s
    shape (n=4096, q = 2^50 - 2^14 + 1, batch 512): kernel E
    (``mxu8_roundtrip64_mul``), ``mxu8_forward64`` then kernel D
    (``mxu8_inverse64_mul``), and the butterfly route (``ntt64_forward`` at
    ``out_factor=4``, a Shoup multiply, ``ntt64_inverse``) give the same
    words on all 512 rows and rows 0-15 equal the plain ``negacyclic_mul64``;
    D and E against their plain versions at 7 and 8 byte planes, E's tile
    of rows, device ms and share of its bound beside ``mxu8_forward64`` + D
    at both and row 10's forward + inverse at 7, and the butterfly route's
    ``ntt64_forward`` (``out_factor=4``) and ``ntt64_inverse`` against
    their plain versions at the 512 rows; per route ms a trip over 20
    chained trips and ``bench.py``'s modmul/s;
12. the large-n four-step NTT at n = 2^16 over the 62-bit
    q = 4611686018425815041, 2 rows, on the MXU and butterfly routes: the
    forward equals the plain ``forward64``, the lazy forward round-trips,
    both routes agree; ms a transform per route;
13. kernels F (``rotate``) and G (``cmux_front``) at BOOLEAN_128 width,
    batch 64, against their plain versions (F also at the bootstrap's
    start, one broadcast test row into ``acc[:, -1, :]``; G also at batch
    1 and over 5 primes, two launches; both at 1024 x 2 rows, with their
    shares of the byte bound), and
    one CMux step
    ``acc + cmux_delta(...)`` on key slice 0 through kernel G, bit-equal to
    ``fused_cmux_step`` (kernels 3-4), with its launch counts;
14. the mesh layer's multi-device step on one card: phase 10's rotation
    (same key, inputs, 630 steps, batch 16) on a ``LocalMesh`` of (residue 2,
    batch 2), one modulus and 8 ciphertexts a shard, route ``"auto"``: the
    same words as phase 10's, ``mxu8_forward64``/``mxu8_inverse64`` each
    launched 4 x 630 times (row 12: the byte-radix kernels on each shard's
    own tables), rotation ms and CMux/s; route ``"butterfly"`` over the
    first 64 steps against the single-card prefix; and that prefix again on
    a world-size-1 NCCL ``ProcessGroupMesh`` (NCCL refuses two ranks on one
    card, so the multi-shard runs use ``LocalMesh``);
15. the coefficient-sharded NTT on ``LocalMesh``es: u32 at n = 2^12, q =
    536813569, batch 8 over D = 2, 4, 8 against kernels 1-2, u64 at n = 2^16,
    q = 4611686018425815041, 2 rows over D = 4 and 2 (rows of 2^14 and 2^15
    words a shard) against the plain forward64, both round trips, one stage
    launch a shard a transform; the four stage kernels (row 11) against their
    plain versions at those shapes (the u64 pair at both shards, with the
    cluster size and rows a block each launch picks); 15.3: the u64 forward +
    inverse trip at D = 4 and 2 timed over 20 chained trips, with its host
    ops, the card's busy time with the host ahead and the idle share; 15.4:
    n = 2^18 over D = 2 (u32 and u64, shards of 2^17 words) against the
    unsharded plain transforms, and the four stage kernels at log_w 17;
16. row 13, the coefficient-sharded byte-radix NTT (four half-transform
    kernels around one ``all_to_all``) at ``bench_coeff_sharded_mxu.py``'s
    shape (n = 4096, batch 64, q = 2^50 - 2^14 + 1): the sharded forward at
    D = 1, 2, 4 on ``LocalMesh``es equals ``mxu8_forward64`` and round-trips,
    with the D = 1 local pipeline's time against ``mxu8_forward64``'s; the
    sharded negacyclic product at ``bench.py``'s shape (512 rows) over D = 2
    and 4 equals kernel E, with exact launch counts and ms a trip beside E and
    forward + D, each with the card's busy time a trip with the host ahead
    and the idle share; once at 8 byte planes; K1, K2, Ki1 (with and without
    the key) and Ki2 against their plain versions (the lazy halves below 2q
    and equal mod q), each with its share of its bound; the sharded product
    at n = 2^14 (A = 128, q = next_ntt_prime(50, 14), 512 rows) over D = 2
    and 4 against row 10's route (``ntt64_forward``, the key's Shoup
    multiply, ``ntt64_inverse``), counted and timed the same way, and K1 /
    Ki2 against their plain versions at its D = 2 shard;
17. the 32-bit DCRT transforms against kernels 1-2 and the residue- and
    batch-sharded external product on a ``LocalMesh`` (2, 2) at BOOLEAN_128
    width (key slice 0 of phase 3's bootstrap key, batch 64) against the
    single-card one, with launch counts and ms;
18. the 64-bit torus external product at N = 2048, k = 1, gadget 2^16 x 4:
    GGSW(1) gives full-range words back, GGSW(X^3) the negacyclic shift, and a
    random key's product equals the CPU plain versions'; launches and ms;
19. circuit bootstrapping at BOOLEAN_128 width on phase 3's NTT key: the two
    private KSKs (2^7 x 3) made on the card (seconds, MB); for a fresh LWE of
    each bit, ``circuit_bootstrap`` (a GGSW at 2^3 x 3), ``ggsw_to_ntt`` and
    one ``leveled_mux`` of two GLWEs carrying 2048 random bits: every
    coefficient decrypts to the selected input, the phase error's std and
    maximum beside the noise model's prediction, exact launch counts; the
    bit-1 circuit bootstrap on the CPU (the same words); 64 fresh LWEs packed
    into one GLWE by ``pack_lwes``, decrypted; ms of a circuit bootstrap (its
    bootstraps and its private switches, each switch against its byte
    bound), of a ``leveled_mux`` and of a ``pack_lwes``;
20. the host layer on phase 3's NTT key: ``params.save_keys`` to an
    ``.npz`` under the build directory and ``params.load_keys`` onto the
    card (seconds, the same words), ``tracked.gate`` NAND, AND and OR at
    batch 64 (truth tables, output std within [0.2, 5]x of the tracked
    prediction, ``margin(2) > 1``, exactly 630 ``fused_cmux_step`` and 1
    ``rotate`` launches a gate, an inflated variance refused before any
    launch, ms a gate), ``pack_container`` of the reloaded bootstrap key
    from the card and back, the ``modops`` and ``compact`` extras on CUDA
    tensors against the CPU's words, the ternary and CRT samplers on a CUDA
    generator (frequencies within 5 sigma), kernel 1 refusing a 4q input
    under ``PRIMUS_DEBUG=1`` before its launch, and ``secrets.delete``
    zeroing the reloaded secrets on the card;
21. the NTT-key blind rotation past the one-launch step's caps: kernels 1-2
    at log_n 15, 16 and 17 (a row over a cluster of 2, 4 or 8 blocks) over 2
    and 3 primes, 1 and 16 rows a prime, every ``out_factor`` against the
    plain versions, timed (and at the 2^17 PBS's rows); kernel H (``cmux_stage2``) and the staged step
    (kernel G, kernel 1, kernel H) over 4 steps at batch 2 against the plain
    step at N = 2^15 (L 3, kp 2), 2^16 (kp 3), 2^10 with k = 2 over 3 primes,
    2^10 with a 2^1 x 20 gadget and 2^17 (kp 3), H's and the step's device
    ms at N = 2^15 and 2^17, batch 1 and 16, against H's bound (G and F at
    2^17 too), with H's grid (a row over a cluster of C slices, C > 1
    asserted); BOOLEAN_128
    with its ring widened to N = 2^15 (``make_context`` on the card) running
    a 4-bit programmable bootstrap (``lut_test_polynomial`` of 3m + 1 mod
    16) on 16 ciphertexts, each decrypted under the GLWE key, the phase
    error against ``noise.blind_rotate``, exact launches (630 each of G,
    kernel 1 and H, one F, no fused step), ms at batch 1 and 16 and the
    idle share; a BOOLEAN_128 bootstrap still on the fused step alone; the
    same programmable bootstrap at N = 2^17 (21.5: the key made in chunks of
    LWE indices, keygen's seconds and peak device memory), and again on the
    MXU key made from the same draws (in chunks, no Shoup quotients past
    kernel A: the same 16 output words, keygen's seconds and peak memory);
22. the MXU bootstrap key and the NTRU MXU evk past kernels A-C's caps:
    the route rules (``mxu_step_route``, ``ntru_step_route``, on kernels A
    and B's C entry) over a grid of shapes, ``plan_for``'s host seconds at
    N = 2^15 and 2^16; kernel C's route (kernel 1 at ``out_factor=1``) at
    log_n 13-17, kp 2, 16 rows, against its plain version; BOOLEAN_128 at N
    = 4096 on the MXU key (k1 L = 6: past kernel A, so the NTT key's fused
    step on the pack's values) running NAND at batch 64 with the key switch
    against its truth table, exactly 630 fused-step launches a gate and
    none of kernel A, G or H, ms at batch 1 and 64 and the idle share;
    21.3's 4-bit programmable bootstrap at N = 2^15 on the MXU key made
    from the same draws (the same 16 output words, 630 launches each of G,
    kernel 1 and H), ms at batch 1 and 16 and the idle share; NTRU_128's gadget, n_lwe and
    sigmas at N = 2^13 (``make_ntru_keys``, both evk forms), kernels I
    (``ntru_digits``) and J (``ntru_stage2``, with the next step's digits
    over its input: both outputs held) against their plain versions at
    batch 1 and 16 with device ms against their bounds (J also without the
    digits) and J's grid (C > 1 slices a row asserted), the first 8 staged
    steps at batch 1 and 16 against the plain step, a full 700-step
    rotation at batch 2 against the CPU's plain rotation (exact launches:
    I once, 700 each of kernel 1 and J), the key-switched output's phase
    std (``noise.py`` has no NTRU model: the measured std alone), the
    rotation's ms at batch 1 and 16 and the idle share; 22.6: the same
    gadget at N = 2^17 (the evk alone), I and J timed, 8 staged steps against
    the plain step, a 700-step rotation's launches and ms at batch 1 and 16;
    BOOLEAN_128 and NTRU_128 still on kernels A and B (630 and 700 launches a
    gate, none of I or J);
23. DCRT bases past the four moduli of one u64 launch: 5 and 6 moduli of
    50 bits at N = 4096 with ``bench_dcrt.py``'s gadget (2^25, L = 10 and
    12): the four u64 transforms at the rotation's shapes against their
    plain versions (two launches a call), 8 rotation steps at batch 2 on
    both routes against the CPU's plain rotation, exact launch counts;
    23.7: row 9's four u64 functions (forward64, inverse64, D, E) at log_n
    13-17 on row 10's passes (a row over a cluster of 2, 4, 8 blocks at
    15-17) against their plain versions, one launch a call, timed; at 16
    and 17 row 10's forward and inverse too, and all six over 5 and 6
    moduli (two launches a call); 23.8: 4 DCRT rotation steps at N = 8192
    and 65536 on route ``"mxu8"`` against ``"butterfly"`` and the CPU; 23.9:
    kernel E on ``bench.py``'s 512 rows at n = 2^16 and 2^17 against its
    bound;
24. the rings past what a cluster holds, on the four-step through device
    memory (``csrc/ntt_columns.cu``: a column launch and a sub-row launch a
    transform): kernels 1-2 at log_n 18, 19 and 20 over 2 and 3 primes, 1
    and 16 rows a prime, every ``out_factor`` and in place, against the
    plain versions with exact launches (the column launch, which the
    transforms' C entries issue, counted on its own), the u32 and u64
    column kernels alone against theirs, kernel 1 at the 2^18 PBS's rows;
    each timed at 3 primes and 16 rows (past 2^18 the plain versions on
    their checking run alone: repeated, they would cost minutes); 24.7-24.9: row 9's four u64 functions, D, E, row
    10 and row 12 at 18-20 (23.7's shapes, the column launches asserted),
    4 DCRT steps at N = 2^18 on both routes against the plain rotation run
    on the card, kernel E on 512 rows of 2^18; 24.3: the staged TFHE step
    at 18-20 (BOOLEAN_128's gadget, kp 3: G, kernel 1 and the split H,
    mac_sub then H's column launch with the CRT) over 4 steps at batch 1
    and 16 against the plain step, the split H and its two launches, G and
    F against their plain versions; 24.4: the staged NTRU step at 18-20
    (NTRU_128's gadget, the least q that has a 2^(log_n + 1)-th root; the
    split J: mac_sub, the inverse's columns, ``ntru_finish``) over 8 steps
    at batch 1 and 16 against the plain step, the split J with its digits
    and ``ntru_finish`` against their plain versions; 24.6: the 4-bit
    programmable bootstrap at N = 2^18 on the NTT key (int32 words, made in
    chunks; keygen's seconds and peak memory), decrypted, exact launches
    (630 each of G, kernel 1, its columns, mac_sub and H's columns, one F),
    ms at batch 1 and 16 and the idle share.

Each phase ends with its seconds.

The line before the last is the kernel table as JSON (every kernel with its
launches on its main path, its time, its plain version's time and its bound,
the least time the card could take for the same work); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time

SEED = 2026
BATCH = 64
KEY_ROWS = {"bsk": 7560, "evk": 4200}  # kernel C's rows a prime: BOOLEAN_128's key, NTRU_128's evk
F_ROWS = 1024  # kernel F's large shape: 1024 x 2 rows of 2048
LAT_REPS = 5
KERNEL_REPS = 20
NTRU_NOISE_RECORD = 8519.48  # NOISE_CHECK_NTRU_r05.json measured_std (mod-q units)

# Peaks of one H100 SXM (the bound of every kernel row): HBM3 bytes/s and
# dense int8 tensor-core ops/s (a MAC is 2 ops) from NVIDIA's data sheet; 32-bit
# integer multiplies/s from the CUDA throughput table for compute capability
# 9.0 (64 a clock an SM) x 132 SMs x 1.98 GHz.  A Shoup multiply costs 3
# 32-bit multiplies on u32 words and 10 on u64 words (3 + 3 for the two low
# products, 4 for the high word).
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
INT32_MULS_S = 132 * 64 * 1.98e9


def bound(nbytes: float, int8_macs: float = 0, muls32: float = 0) -> tuple[float, str]:
    """``(ms, "bytes" or "operations")``: the least time the card could take
    to read every input once and write every output once, or to do the
    work at peak, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = max(2 * int8_macs / INT8_OPS_S, muls32 / INT32_MULS_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def ntt_muls(rows: int, n: int, u64: bool = False) -> int:
    """32-bit multiplies of ``rows`` butterfly NTTs of size ``n``: ``n/2
    log n`` Shoup multiplies a row.  Every NTT kernel is bounded by this,
    the function's work, whatever its method: the u32 and u64 forward and
    inverse NTTs on either route, kernel C (the u32 forward on byte planes),
    kernels D (one inverse and the key, one Shoup multiply a word) and E (two
    transforms and the key), and row 13's split kernels K1-Ki2 by their
    sub-transforms' (:func:`split_bounds`).  Only kernels A and B, whose
    function is a CMux step, are held to their int8 MACs
    (:func:`four_step_macs`)."""
    return rows * (n // 2) * (n.bit_length() - 1) * (10 if u64 else 3)


def four_step_macs(rows: int, n: int, out_planes: int, in_bytes: int,
                   in_bytes2: int | None = None) -> int:
    """int8 MACs of ``rows`` byte-radix four-step transforms (``A = n/128``
    by ``B = 128``): pass 1 ``B x (P A) x (V A)``, pass 2 ``A x (P B) x (V2
    B)`` a row, with P output planes, V operand bytes a word in pass 1 and
    V2 (default V) in pass 2.  Kernels A and B feed pass 1 gadget digits
    (V = 1 or 2 bytes) and pass 2 its u32 outputs (V2 = 4)."""
    a, b = n // 128, 128
    return rows * out_planes * n * (in_bytes * a + (in_bytes2 or in_bytes) * b)


_PHASE = {"name": None, "t0": 0.0}


def end_phase() -> None:
    """Prints the seconds of the phase that is running, if any."""
    if _PHASE["name"] is not None:
        log(f"   ({_PHASE['name']}: {time.perf_counter() - _PHASE['t0']:.1f} s)")
        _PHASE["name"] = None


def log(msg: str) -> None:
    """Prints ``msg``; a "== phase" title first ends the running phase
    (its seconds) and starts the next one's clock; a "-- " subtitle gets
    the seconds of the phase so far."""
    if msg.startswith("== phase"):
        end_phase()
        _PHASE.update(name=msg[3:].split(":")[0], t0=time.perf_counter())
    elif msg.startswith("-- ") and _PHASE["name"] is not None:
        msg += f" [{time.perf_counter() - _PHASE['t0']:.1f} s into {_PHASE['name']}]"
    print(msg, flush=True)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` runs, CUDA events, after
    two warm-up runs."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_time(torch, fn):
    """Device time (ms) of one run of ``fn``, summed over the kernels that
    ``torch.profiler`` sees, and the per-kernel rows ``(ms total, count,
    name)``; ``(None, [])`` if it saw none.  Only device-side rows count: a
    host op's row repeats its kernels' time.  For runs of hundreds of
    launches or more (a gate, 16 DCRT steps): the profiler may lose a
    session's last launch records (seen: up to 26 of 630), so the busy time
    is a lower bound and the idle share an upper one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [
        (e.self_device_time_total / 1e3, e.count, e.key)
        for e in prof.key_averages()
        if e.device_type != DeviceType.CPU and e.self_device_time_total > 0
    ]
    if not rows:
        return None, []
    return sum(r[0] for r in rows), sorted(rows, reverse=True)


def kernel_device_ms(torch, fn) -> float:
    """Device ms of the kernel one wrapper call runs: the median over
    ``KERNEL_REPS`` calls of CUDA events around the call, queued behind a
    ~1 ms ``torch.cuda._sleep`` so that the events bracket the kernel on the
    card and not the host's launch work.  (``torch.profiler`` is not used
    here: in a short session it loses the last launch records, 1-20 of 20
    in this script's later phases.)"""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(KERNEL_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def wall_ms(torch, fn, reps: int) -> list[float]:
    """Host-clock milliseconds of each of ``reps`` synchronised runs."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def once_ms(torch, fn):
    """``(fn(), ms)``: one run of ``fn`` between two CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def compare_kernel(torch, table, name, bsz, kern, kern32, plain, bnd, macs=None,
                   plain_once=False):
    """Holds ``kern`` (int64 words) and ``kern32`` (int32 storage) against
    ``plain`` bit for bit, then times the int32 wrapper and the plain
    version (CUDA events; ``plain_once``: the plain version's one checking
    run, for shapes where its repetitions would cost seconds) and the
    kernel's device time (:func:`kernel_device_ms`); ``bnd`` is the work's
    :func:`bound`; with the work's int8 ``macs``, also the achieved MACs/s
    and the share of the bound (bound ms / device ms)."""
    got = kern()
    want, once = once_ms(torch, plain)
    got32 = kern32()
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"{name} batch {bsz}: kernel != plain (max abs err {err})")
    if not torch.equal(got32.to(torch.int64) & 0xFFFFFFFF, want):
        raise AssertionError(f"{name} batch {bsz}: int32-storage kernel != plain")
    ms = cuda_ms(torch, kern32, KERNEL_REPS)
    plain_ms = once if plain_once else cuda_ms(torch, plain, KERNEL_REPS)
    dev_ms = kernel_device_ms(torch, kern32)
    log(f"{name:22s} batch {bsz:3d} shape {tuple(got.shape)}: bit-equal; "
        f"wrapper {ms:.4f} ms (device {dev_ms:.4f} ms), plain {plain_ms:.4f} ms"
        f"{' (one run)' if plain_once else ''}, bound {bnd[0]:.4f} ms ({bnd[1]})")
    if macs is not None:
        log(f"{name:22s} batch {bsz:3d}: {macs} int8 MACs, {macs / (dev_ms * 1e-3):.4g} MACs/s "
            f"on the device; share of the bound {bnd[0] / dev_ms:.4f}")
    table.setdefault(name, {})[bsz] = (err, ms, plain_ms, dev_ms, bnd)


def compare_kernel64(torch, table, name, bsz, kern, plain, bnd, plain_once=False):
    """Holds ``kern`` against ``plain`` (int64 u64 words) bit for bit, then
    times both (CUDA events; ``plain_once`` as :func:`compare_kernel`) and
    the kernel's device time (:func:`kernel_device_ms`)."""
    got = kern()
    want, once = once_ms(torch, plain)
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"{name} batch {bsz}: kernel != plain ({bad} words differ)")
    ms = cuda_ms(torch, kern, KERNEL_REPS)
    plain_ms = once if plain_once else cuda_ms(torch, plain, KERNEL_REPS)
    dev_ms = kernel_device_ms(torch, kern)
    log(f"{name:22s} batch {bsz:3d} shape {tuple(got.shape)}: bit-equal; "
        f"wrapper {ms:.4f} ms (device {dev_ms:.4f} ms), plain {plain_ms:.4f} ms"
        f"{' (one run)' if plain_once else ''}, bound {bnd[0]:.4f} ms ({bnd[1]})")
    table.setdefault(name, {})[bsz] = (0, ms, plain_ms, dev_ms, bnd)


def count_host_ops(torch, fn) -> int:
    """PyTorch operators dispatched by ``fn`` (each one a host-side call,
    most of them one kernel launch on the card)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def enqueue_ms(torch, fn, reps: int) -> float:
    """Least host-clock milliseconds to enqueue ``fn`` (synchronised before,
    not inside): the host's own work when the launch queue does not fill."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return min(out)


def time_gate(torch, label, gate, boot, ks, check, steps):
    """Truth-checks ``gate`` once, then its host-clock latency, the
    bootstrap and key-switch parts, the host time a rotation step (the
    bootstrap's enqueue over its ``steps``) and the profiler's device
    split."""
    check(gate())
    gate_ms = wall_ms(torch, gate, LAT_REPS)
    big = boot()
    boot_ms = wall_ms(torch, boot, LAT_REPS)
    ks_ms = wall_ms(torch, lambda: ks(big), LAT_REPS)
    host_us = enqueue_ms(torch, boot, LAT_REPS) * 1e3 / steps
    mean = sum(gate_ms) / len(gate_ms)
    log(f"{label}: truth table correct; gate mean {mean:.2f} ms (min {min(gate_ms):.2f}); "
        f"bootstrap min {min(boot_ms):.2f} ms; key switch min {min(ks_ms):.2f} ms "
        f"(host clock, {LAT_REPS} runs each); host {host_us:.1f} us a step (bootstrap "
        f"enqueue / {steps})")
    dev_ms, rows = device_time(torch, gate)
    if dev_ms is None:
        log(f"{label}: device time not measured (the profiler saw no device activity)")
    else:
        log(f"{label}: device busy {dev_ms:.2f} ms of {mean:.2f} ms wall -> idle share "
            f"{1 - dev_ms / mean:.3f}; top device rows:")
        for ms_, count, key_ in rows[:6]:
            log(f"    {ms_:9.3f} ms  x{count:<5d} {key_[:90]}")
    return mean


DCRT_LOG_N = 12
DCRT_MODULI = [1125899906826241, 1125899906629633]  # bench_dcrt.py's 2 x 50-bit
DCRT_LOG_BASIS = 25  # L = 4 levels over Q ~ 2^100 (bench_dcrt.py)
DCRT_N_LWE = 630  # BOOLEAN_128's LWE dimension
DCRT_BATCH = 16  # bench_dcrt.py's batch
DCRT_SIGMA = 3.2
DCRT_CPU_SLICES = 64
DCRT_PROFILE_STEPS = 16


def phase10_dcrt(torch, dev, table) -> tuple[dict, dict]:
    """Phase 10: the RNS/DCRT blind rotation at full width.  Returns the
    launch counts of the rotations (the main path of this phase) and the
    state phase 14 reuses: the plan, basis, base, key, LWE batch,
    accumulators and the batch-16 output of route ``"auto"``."""
    import math

    import numpy as np

    from primus_fhe_tpu_torch.boot import dcrt_blind_rotate as dbr
    from primus_fhe_tpu_torch.decompose import BigUintApproxSignedBasis
    from primus_fhe_tpu_torch.distr import DiscreteGaussian, sample_binary
    from primus_fhe_tpu_torch.lattice import dcrt
    from primus_fhe_tpu_torch.numeric.bigint import big_to_ints
    from primus_fhe_tpu_torch.ops import ntt64, ntt_mxu8
    from primus_fhe_tpu_torch.rns import RNSBase64
    from primus_fhe_tpu_torch.transforms import dcrt as td

    n, n_lwe, k = 1 << DCRT_LOG_N, DCRT_N_LWE, 1
    k1 = k + 1
    base = RNSBase64(DCRT_MODULI)
    basis = BigUintApproxSignedBasis(base, DCRT_LOG_BASIS)
    level = basis.decompose_length
    plan = td.build_dcrt_plan64(DCRT_LOG_N, DCRT_MODULI)
    Q = base.q_product
    log(f"DCRT: N={n} moduli={DCRT_MODULI} (Q = 2^{Q.bit_length() - 1}.x) L={level} x "
        f"2^{DCRT_LOG_BASIS} k={k} n_lwe={n_lwe} sigma={DCRT_SIGMA} batch {DCRT_BATCH}; "
        f"MXU tier {plan.mxu.planes} byte planes, route 'auto' = {td.resolve_route(plan)!r}")
    g = torch.Generator(device=dev).manual_seed(SEED + 3)

    def residues(rows):
        return torch.stack([torch.randint(0, q, (rows, n), generator=g, device=dev)
                            for q in DCRT_MODULI])

    # -- 1. the four kernels at the rotation's shapes ----------------------------
    log("-- 10.1: the u64 NTT kernels vs plain versions (bit-equal)")
    for bsz in (1, DCRT_BATCH):
        f_in, i_in = residues(k1 * level * bsz), residues(k1 * bsz)
        rf, ri = f_in.numel() // n, i_in.numel() // n  # rows over every modulus
        compare_kernel64(torch, table, "ntt64_forward", bsz,
                         lambda: ntt64.ntt64_forward(plan.ntt, f_in),
                         lambda: ntt64.ntt64_forward_plain(plan.ntt, f_in),
                         bound(16 * rf * n, muls32=ntt_muls(rf, n, u64=True)))
        compare_kernel64(torch, table, "ntt64_inverse", bsz,
                         lambda: ntt64.ntt64_inverse(plan.ntt, i_in),
                         lambda: ntt64.ntt64_inverse_plain(plan.ntt, i_in),
                         bound(16 * ri * n, muls32=ntt_muls(ri, n, u64=True)))
        compare_kernel64(torch, table, "mxu8_forward64", bsz,
                         lambda: ntt_mxu8.mxu8_forward64(plan.mxu, f_in),
                         lambda: ntt_mxu8.mxu8_forward64_plain(plan.mxu, f_in),
                         bound(16 * rf * n, muls32=ntt_muls(rf, n, u64=True)))
        compare_kernel64(torch, table, "mxu8_inverse64", bsz,
                         lambda: ntt_mxu8.mxu8_inverse64(plan.mxu, i_in),
                         lambda: ntt_mxu8.mxu8_inverse64_plain(plan.mxu, i_in),
                         bound(16 * ri * n, muls32=ntt_muls(ri, n, u64=True)))

    # -- 2. key generation on the card ---------------------------------------------
    log("-- 10.2: DCRT bootstrap key on the card")
    gk = torch.Generator(device=dev).manual_seed(SEED + 4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, secret = dcrt.dcrt_glwe_secret(gk, k, plan)
    lwe_secret = sample_binary(gk, (n_lwe,))
    bsk = dbr.make_dcrt_bootstrap_key(gk, lwe_secret, secret, basis, DiscreteGaussian(DCRT_SIGMA),
                                      plan, base)
    torch.cuda.synchronize()
    log(f"keygen: {time.perf_counter() - t0:.3f} s for {n_lwe} DCRT GGSWs, bsk "
        f"{tuple(bsk.shape)} = {bsk.numel() * 8 / 1e6:.1f} MB")

    # the test vector v_j = (j+1) delta on the body, and random LWE inputs
    delta = Q >> 8
    v = np.array([(j + 1) * delta % Q for j in range(n)], dtype=object)
    acc_coeff = torch.zeros((len(DCRT_MODULI), k1, n), dtype=torch.int64, device=dev)
    for mi, q in enumerate(DCRT_MODULI):
        acc_coeff[mi, 1] = torch.tensor([int(x % q) for x in v], dtype=torch.int64, device=dev)
    acc0 = td.dcrt_forward64_fast(plan, acc_coeff)
    accs = acc0.unsqueeze(0).expand(DCRT_BATCH, -1, -1, -1).contiguous()
    lwe = torch.randint(0, 2 * n, (DCRT_BATCH, n_lwe + 1), generator=g, device=dev)
    args = (plan, basis, base, bsk)

    # -- 3. the rotation on both routes, counted ----------------------------------
    log("-- 10.3: rotation at batch 1 and 16 on route 'auto' (MXU kernels) and 'butterfly'")
    kernels = {"ntt64_forward": ntt64.ntt64_forward, "ntt64_inverse": ntt64.ntt64_inverse,
               "mxu8_forward64": ntt_mxu8.mxu8_forward64,
               "mxu8_inverse64": ntt_mxu8.mxu8_inverse64}
    own = {"auto": ("mxu8_forward64", "mxu8_inverse64"),
           "butterfly": ("ntt64_forward", "ntt64_inverse")}
    outs, counts = {}, {}
    for route in ("auto", "butterfly"):
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.synchronize()
        outs[route, DCRT_BATCH] = dbr.dcrt_blind_rotate_batched(*args, lwe, accs, route=route)
        outs[route, 1] = dbr.dcrt_blind_rotate(*args, lwe[0], acc0, route=route)
        torch.cuda.synchronize()
        got = {name: fn.launches for name, fn in kernels.items()}
        log(f"[{route}] launches: {json.dumps(got)}")
        # one forward call (all k+1 rows x L levels x batch x moduli) and one
        # inverse call per CMux step, per rotation
        want = {name: (2 * n_lwe if name in own[route] else 0) for name in kernels}
        if got != want:
            raise AssertionError(f"[{route}] launch counts {got}, want {want} (forward and "
                                 f"inverse: 1 per step x {n_lwe} steps x 2 rotations)")
        counts.update({name: got[name] for name in own[route]})
    log(f"launch counts exact: per route, forward = inverse = {n_lwe} steps x 2 rotations "
        f"(batch 1, batch {DCRT_BATCH}) = {2 * n_lwe}; the other route's kernels 0")
    for bsz in (1, DCRT_BATCH):
        if not torch.equal(outs["auto", bsz], outs["butterfly", bsz]):
            raise AssertionError(f"batch {bsz}: the MXU and butterfly routes differ")
    if not torch.equal(outs["auto", 1], outs["auto", DCRT_BATCH][0]):
        raise AssertionError("the single rotation differs from row 0 of the batched one")
    log(f"both routes: the same {outs['auto', DCRT_BATCH].numel()} words at batch "
        f"{DCRT_BATCH} and {outs['auto', 1].numel()} at batch 1 (= row 0 of the batch)")

    # -- 4. the same rotation on the CPU through the plain versions --------------
    cut = torch.cat([lwe[:1, :DCRT_CPU_SLICES], lwe[:1, -1:]], dim=1)
    cpu_bsk = bsk[:DCRT_CPU_SLICES].cpu()
    t0 = time.perf_counter()
    out_cpu = dbr.dcrt_blind_rotate_batched(plan, basis, base, cpu_bsk, cut.cpu(),
                                            acc0.unsqueeze(0).cpu())
    cpu_s = time.perf_counter() - t0
    est_s = cpu_s * n_lwe / DCRT_CPU_SLICES
    out_gpu = dbr.dcrt_blind_rotate_batched(plan, basis, base, bsk[:DCRT_CPU_SLICES], cut,
                                            acc0.unsqueeze(0))
    if not torch.equal(out_gpu.cpu(), out_cpu):
        raise AssertionError("DCRT rotation on cuda and on cpu differ")
    if est_s < 60:
        t0 = time.perf_counter()
        full_cpu = dbr.dcrt_blind_rotate(plan, basis, base, bsk.cpu(), lwe[0].cpu(), acc0.cpu())
        if not torch.equal(outs["auto", 1].cpu(), full_cpu):
            raise AssertionError("full DCRT rotation on cuda and on cpu differ")
        log(f"cpu plain versions, all {n_lwe} key slices: the same words as cuda "
            f"({time.perf_counter() - t0:.1f} s on the cpu)")
    else:
        log(f"cpu plain versions, the first {DCRT_CPU_SLICES} of {n_lwe} key slices only "
            f"(all {n_lwe} would take ~{est_s:.0f} s there): the accumulators after step "
            f"{DCRT_CPU_SLICES} are the same words on cuda and cpu ({cpu_s:.1f} s on the cpu)")

    # -- 5. decryption ---------------------------------------------------------
    log("-- 10.5: decryption of the batch-16 rotation")
    ph = dcrt.dcrt_glwe_phase(outs["auto", DCRT_BATCH].transpose(0, 1), secret, plan, base)
    got = big_to_ints(base.compose(ph))  # (B, N) ints mod Q
    s_bits = lwe_secret.cpu().numpy()
    lw = lwe.cpu().numpy()
    errs = []
    for b in range(DCRT_BATCH):
        rot = (-int(lw[b, n_lwe]) + int((lw[b, :n_lwe] * s_bits).sum())) % (2 * n)
        idx = (np.arange(n) + rot) % (2 * n)  # X^rot sends j to j + rot (negacyclic)
        expect = np.empty(n, dtype=object)
        expect[idx % n] = np.where(idx < n, v, (Q - v) % Q)
        d = (got[b] - expect) % Q
        errs.append(np.where(d > Q // 2, d - Q, d))
    err = np.concatenate(errs).astype(float)
    worst = max(abs(int(x)) for x in np.concatenate(errs))
    if worst >= delta // 4:
        raise AssertionError(f"decryption error {worst} >= delta/4")
    est = DCRT_N_LWE * k1 * level * n * DCRT_SIGMA ** 2 * (1 << DCRT_LOG_BASIS) ** 2 / 12
    log(f"all {err.size} coefficients within delta/4 = 2^{math.log2(delta // 4):.1f}: max |e| "
        f"2^{math.log2(max(worst, 1)):.2f}, std 2^{math.log2(err.std()):.2f}; estimate "
        f"k1*L*N*sigma^2*B^2/12 x {n_lwe} steps -> std 2^{math.log2(est) / 2:.2f}")

    # -- 6./7. timings ---------------------------------------------------------
    log("-- 10.7: timings (host clock; device split from torch.profiler)")
    prof_lwe = torch.cat([lwe[:, :DCRT_PROFILE_STEPS], lwe[:, -1:]], dim=1)
    step_lwe = torch.cat([lwe[:, :1], lwe[:, -1:]], dim=1)
    rates = {}
    for route in ("auto", "butterfly"):
        one = wall_ms(torch, lambda: dbr.dcrt_blind_rotate(*args, lwe[0], acc0, route=route), 2)
        many = wall_ms(torch, lambda: dbr.dcrt_blind_rotate_batched(*args, lwe, accs,
                                                                    route=route), 2)
        cmux_s = n_lwe * DCRT_BATCH / (min(many) / 1e3)
        ops = count_host_ops(torch, lambda: dbr.dcrt_blind_rotate_batched(
            plan, basis, base, bsk[:2], torch.cat([lwe[:, :2], lwe[:, -1:]], dim=1), accs,
            route=route)) - count_host_ops(torch, lambda: dbr.dcrt_blind_rotate_batched(
                plan, basis, base, bsk[:1], step_lwe, accs, route=route))
        log(f"[{route}] rotation ({n_lwe} steps) batch 1: {min(one):.1f} ms (runs "
            f"{', '.join(f'{x:.1f}' for x in one)}); batch {DCRT_BATCH}: {min(many):.1f} ms "
            f"-> {cmux_s:.1f} CMux/s; {ops} host ops per step")
        for bsz in (1, DCRT_BATCH):
            short = lambda: dbr.dcrt_blind_rotate_batched(  # noqa: E731
                plan, basis, base, bsk[:DCRT_PROFILE_STEPS], prof_lwe[:bsz], accs[:bsz],
                route=route)
            wall = min(wall_ms(torch, short, 2))
            dev_ms, rows = device_time(torch, short)
            if dev_ms is None:
                log(f"[{route}] device time not measured (the profiler saw no device activity)")
                continue
            log(f"[{route}] {DCRT_PROFILE_STEPS} steps at batch {bsz}: device busy "
                f"{dev_ms:.2f} ms of {wall:.2f} ms wall -> idle share {1 - dev_ms / wall:.3f}; "
                f"top device rows:")
            for ms_, count, key_ in rows[:6]:
                log(f"    {ms_:9.3f} ms  x{count:<6d} {key_[:90]}")
        rates[route] = (min(one), cmux_s)
    log(f"DCRT summary: MXU route {rates['auto'][0]:.1f} ms/rotation at batch 1, "
        f"{rates['auto'][1]:.1f} CMux/s at batch {DCRT_BATCH}; butterfly route "
        f"{rates['butterfly'][0]:.1f} ms, {rates['butterfly'][1]:.1f} CMux/s")
    state = dict(plan=plan, basis=basis, base=base, bsk=bsk, lwe=lwe, accs=accs,
                 out=outs["auto", DCRT_BATCH], rates=rates)
    return counts, state


RT_LOG_N = 12  # bench.py's round trip: n = 4096
RT_MODULI = (1125899906826241, 1152921504606830593)  # 7 planes (bench.py's q), 8 planes
RT_BATCH = 512
RT_TRIPS = 20
RT_ORACLE_ROWS = 16
LARGE_LOG_N = 16  # the four-step's config-2 headline shape
LARGE_Q = 4611686018425815041
LARGE_ROWS = 2


def chained_ms(torch, step, x, trips: int) -> float:
    """Milliseconds a trip of ``step`` over ``trips`` chained trips (each
    output feeds the next call), CUDA events, after one warm-up trip."""
    step(x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    v = x
    start.record()
    for _ in range(trips):
        v = step(v)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / trips


def queued_ms(torch, step, x, trips: int, host_ms: float) -> tuple[float | None, float]:
    """``(busy, enqueue)``: the card's busy milliseconds a trip of ``step``
    and the host's milliseconds a trip to enqueue it.  ``trips`` chained
    trips are queued behind a sleep kernel long enough (twice the
    host-paced ``host_ms`` a trip) for the host to enqueue them all first,
    CUDA events around them, so that no launch waits for the host (the gaps
    between launches on the card count); the host clock times the enqueue,
    the card asleep.  busy is None if the host still fell behind the sleep
    (the sleep's length assumes a clock of at most 2 GHz)."""
    step(x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sleep_ms = 2 * trips * host_ms + 1
    torch.cuda._sleep(int(sleep_ms * 2e6))
    t0 = time.perf_counter()
    v = x
    start.record()
    for _ in range(trips):
        v = step(v)
    end.record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    busy = None if enqueue_ms >= sleep_ms else start.elapsed_time(end) / trips
    return busy, enqueue_ms / trips


def phase11_roundtrip(torch, dev, table) -> dict:
    """Phase 11: the negacyclic product by a fixed NTT-domain operand at
    ``bench.py``'s shape.  Returns the launch counts of its main path."""
    from primus_fhe_tpu_torch.modular.factor import ShoupFactor64, factor_mul_lazy64
    from primus_fhe_tpu_torch.modular.modulus import barrett64
    from primus_fhe_tpu_torch.ops import ntt64, ntt_mxu8
    from primus_fhe_tpu_torch.transforms.ntt import inverse64, negacyclic_mul64

    n, log_n = 1 << RT_LOG_N, RT_LOG_N
    kernels = {"mxu8_roundtrip64_mul": ntt_mxu8.mxu8_roundtrip64_mul,
               "mxu8_inverse64_mul": ntt_mxu8.mxu8_inverse64_mul,
               "mxu8_forward64": ntt_mxu8.mxu8_forward64,
               "ntt64_forward": ntt64.ntt64_forward, "ntt64_inverse": ntt64.ntt64_inverse}
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    counts = {}
    for q in RT_MODULI:
        ntt = ntt64.NttTables64(log_n, [q])
        mxu = ntt_mxu8.Mxu8Tables64(ntt)
        P = mxu.planes
        x = torch.randint(0, q, (1, RT_BATCH, n), generator=g, device=dev)
        key = torch.randint(0, q, (1, n), generator=g, device=dev)  # NTT domain, bit-reversed
        mt = mxu.mul_table(key)
        kf = ShoupFactor64(mt[0, 0], mt[0, 1])
        routes = {
            "E": lambda v: ntt_mxu8.mxu8_roundtrip64_mul(mxu, v, mt),
            "fwd+D": lambda v: ntt_mxu8.mxu8_inverse64_mul(mxu, ntt_mxu8.mxu8_forward64(mxu, v),
                                                           mt),
            "butterfly": lambda v: ntt64.ntt64_inverse(
                ntt, factor_mul_lazy64(ntt64.ntt64_forward(ntt, v, 4), kf, q)),
        }
        log(f"-- q = {q} ({P} byte planes), n = {n}, batch {RT_BATCH}")
        if q == RT_MODULI[0]:  # the main path: one trip on each route, counted
            for fn in kernels.values():
                fn.launches = 0
            torch.cuda.synchronize()
            outs = {name: route(x) for name, route in routes.items()}
            torch.cuda.synchronize()
            counts = {name: fn.launches for name, fn in kernels.items()}
            log(f"launches of one trip on each route: {json.dumps(counts)}")
            want = {"mxu8_roundtrip64_mul": 1, "mxu8_inverse64_mul": 1, "mxu8_forward64": 1,
                    "ntt64_forward": 1, "ntt64_inverse": 1}
            if counts != want:
                raise AssertionError(f"round-trip launch counts {counts}, want {want}")
            for name in ("fwd+D", "butterfly"):
                if not torch.equal(outs["E"], outs[name]):
                    raise AssertionError(f"route E and route {name} differ")
            plan = ntt.plans_on(dev)[0]
            b = inverse64(plan, key[0])  # the coefficient-domain operand
            oracle = negacyclic_mul64(plan, barrett64(q, dev), x[0, :RT_ORACLE_ROWS], b)
            if not torch.equal(outs["E"][0, :RT_ORACLE_ROWS], oracle):
                raise AssertionError("the round trip differs from the plain negacyclic_mul64")
            log(f"routes E, forward + D and butterfly: the same {outs['E'].numel()} words on all "
                f"{RT_BATCH} rows; rows 0-{RT_ORACLE_ROWS - 1} equal the plain negacyclic_mul64")
        fwd = ntt_mxu8.mxu8_forward64(mxu, x)  # kernel D's input
        words = RT_BATCH * n
        key_muls = 10 * words  # the key's lazy Shoup multiply, one a word
        tag = "" if q == RT_MODULI[0] else f"@{P}planes"
        compare_kernel64(torch, table, "mxu8_inverse64_mul" + tag, RT_BATCH,
                         lambda: ntt_mxu8.mxu8_inverse64_mul(mxu, fwd, mt),
                         lambda: ntt_mxu8.mxu8_inverse64_mul_plain(mxu, fwd, mt),
                         bound(8 * (2 * words + 2 * n),
                               muls32=ntt_muls(RT_BATCH, n, u64=True) + key_muls))
        compare_kernel64(torch, table, "mxu8_roundtrip64_mul" + tag, RT_BATCH,
                         lambda: ntt_mxu8.mxu8_roundtrip64_mul(mxu, x, mt),
                         lambda: ntt_mxu8.mxu8_roundtrip64_mul_plain(mxu, x, mt),
                         bound(8 * (2 * words + 2 * n),
                               muls32=2 * ntt_muls(RT_BATCH, n, u64=True) + key_muls))
        e_row = table["mxu8_roundtrip64_mul" + tag][RT_BATCH]
        log(f"kernel E{tag}: tile of {ntt_mxu8.roundtrip_tile(mxu, RT_BATCH)} rows a block, "
            f"device {e_row[3]:.4f} ms, share of the bound {e_row[4][0] / e_row[3]:.4f}")
        fwd_dev = kernel_device_ms(torch, lambda: ntt_mxu8.mxu8_forward64(mxu, x))
        d_dev = table["mxu8_inverse64_mul" + tag][RT_BATCH][3]
        log(f"kernel E{tag} {e_row[3]:.4f} device ms against mxu8_forward64 {fwd_dev:.4f} + D "
            f"{d_dev:.4f} = {fwd_dev + d_dev:.4f} (E / (forward + D) = "
            f"{e_row[3] / (fwd_dev + d_dev):.4f}; one trip of {16 * words / 1e6:.1f} MB through "
            f"device memory and one launch saved)")
        if q != RT_MODULI[0]:
            continue
        row10 = bound(16 * words, muls32=ntt_muls(RT_BATCH, n, u64=True))
        compare_kernel64(torch, table, "ntt64_forward@rt", RT_BATCH,
                         lambda: ntt64.ntt64_forward(ntt, x, 4),
                         lambda: ntt64.ntt64_forward_plain(ntt, x, 4), row10)
        compare_kernel64(torch, table, "ntt64_inverse@rt", RT_BATCH,
                         lambda: ntt64.ntt64_inverse(ntt, x),
                         lambda: ntt64.ntt64_inverse_plain(ntt, x), row10)
        row10_dev = sum(table[k][RT_BATCH][3] for k in ("ntt64_forward@rt", "ntt64_inverse@rt"))
        log(f"kernel E {e_row[3]:.4f} device ms against row 10's forward + inverse "
            f"{row10_dev:.4f} (E / (forward + inverse) = {e_row[3] / row10_dev:.4f})")
        log(f"ms a trip over {RT_TRIPS} chained trips (CUDA events); bench.py's metric "
            f"{RT_BATCH} x (n log n + n) modmuls a trip")
        modmuls = RT_BATCH * (n * log_n + n)
        for name, route in routes.items():
            ms = chained_ms(torch, route, x, RT_TRIPS)
            log(f"[{name:9s}] {ms:.4f} ms a trip -> {modmuls / (ms / 1e3):.4e} modmul/s")
    return counts


def phase12_large(torch, dev) -> None:
    """Phase 12: the four-step u64 NTT at n = 2^16 on both routes."""
    from primus_fhe_tpu_torch.transforms import ntt_large
    from primus_fhe_tpu_torch.transforms.ntt import forward64
    from primus_fhe_tpu_torch.transforms.plan import build_plan64

    n, q = 1 << LARGE_LOG_N, LARGE_Q
    plan = ntt_large.LargeNttPlan64(LARGE_LOG_N, q)
    log(f"n = 2^{LARGE_LOG_N} = {plan.A} x {plan.B}, q = {q}, {LARGE_ROWS} rows; route 'auto' = "
        f"{ntt_large.resolve_route(plan)!r}")
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    x = torch.randint(0, q, (LARGE_ROWS, n), generator=g, device=dev)
    want = forward64(build_plan64(LARGE_LOG_N, q, dev), x)
    outs = {}
    for route in ("mxu8", "butterfly"):
        outs[route] = ntt_large.large_forward64(plan, x, 1, route)
        if not torch.equal(outs[route], want):
            raise AssertionError(f"[{route}] the four-step forward differs from the plain forward64")
        back = ntt_large.large_inverse64(plan, ntt_large.large_forward64(plan, x, 4, route), 1,
                                         route)
        if not torch.equal(back, x):
            raise AssertionError(f"[{route}] the four-step does not round-trip")
        f_ms = cuda_ms(torch, lambda: ntt_large.large_forward64(plan, x, 1, route), KERNEL_REPS)
        i_ms = cuda_ms(torch, lambda: ntt_large.large_inverse64(plan, want, 1, route),
                       KERNEL_REPS)
        log(f"[{route:9s}] forward equals the plain forward64 and round-trips; forward "
            f"{f_ms:.4f} ms, inverse {i_ms:.4f} ms a transform of {LARGE_ROWS} rows (CUDA events)")
    if not torch.equal(outs["mxu8"], outs["butterfly"]):
        raise AssertionError("the four-step routes differ")
    log(f"both routes: the same {want.numel()} words")


def phase13_front(torch, dev, table, conv, basis, key0, counted) -> dict:
    """Phase 13: kernels F and G at BOOLEAN_128 width, and one CMux step
    through ``cmux_delta``.  Returns the launch counts of that step."""
    from primus_fhe_tpu_torch.lattice import tfhe
    from primus_fhe_tpu_torch.ops import cmux_front, cmux_fused, rotate
    from primus_fhe_tpu_torch.utils.primes import ntt_prime_chain

    n, kp, level = conv.n, conv.count, basis.decompose_length
    k1 = key0.shape[1]
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    acc = torch.randint(0, 1 << 32, (BATCH, k1, n), generator=g, device=dev)
    deg = torch.randint(-4 * n, 4 * n, (BATCH,), generator=g, device=dev, dtype=torch.int32)
    acc32 = acc.to(torch.int32)
    words = BATCH * k1 * n
    for sub in (False, True):
        compare_kernel(torch, table, "rotate" + ("@subtract" if sub else ""), BATCH,
                       lambda: rotate.rotate(acc, deg, sub),
                       lambda: rotate.rotate(acc32, deg, sub),
                       lambda: rotate.rotate_plain(acc, deg, sub), bound(8 * words))
    # the bootstrap's start: the one test row (a broadcast view) into the
    # accumulator's last component, as initial_accumulator launches it
    row = torch.randint(0, 1 << 32, (n,), generator=g, device=dev)
    row32 = row.to(torch.int32)
    start = torch.zeros((BATCH, k1, n), dtype=torch.int32, device=dev)
    compare_kernel(torch, table, "rotate@start", BATCH,
                   lambda: rotate.rotate(row32.expand(BATCH, n), deg, out=start[:, -1, :]).to(
                       torch.int64) & 0xFFFFFFFF,
                   lambda: rotate.rotate(row32.expand(BATCH, n), deg, out=start[:, -1, :]),
                   lambda: rotate.rotate_plain(row.expand(BATCH, n), deg),
                   bound(4 * (n + BATCH * n)))
    big = torch.randint(0, 1 << 32, (F_ROWS, k1, n), generator=g, device=dev)
    big_deg = torch.randint(-4 * n, 4 * n, (F_ROWS,), generator=g, device=dev, dtype=torch.int32)
    big32 = big.to(torch.int32)
    f_b = bound(8 * big.numel())
    compare_kernel(torch, table, "rotate@1024", F_ROWS, lambda: rotate.rotate(big, big_deg),
                   lambda: rotate.rotate(big32, big_deg),
                   lambda: rotate.rotate_plain(big, big_deg), f_b)
    log(f"rotate@1024: share of the byte bound {f_b[0] / table['rotate@1024'][F_ROWS][3]:.3f}")
    # kernel G at batch 1, BATCH and F_ROWS: its bound the bytes once (the
    # accumulator read, kp L residues written), the lifts' multiplies beside
    for name, bsz, a, a32, d in (("cmux_front", 1, acc[:1], acc32[:1], deg[:1]),
                                 ("cmux_front", BATCH, acc, acc32, deg),
                                 ("cmux_front@1024", F_ROWS, big, big32, big_deg)):
        w = a.numel()
        compare_kernel(torch, table, name, bsz,
                       lambda a=a, d=d: cmux_front.cmux_front(a, d, basis, conv.primes),
                       lambda a32=a32, d=d: cmux_front.cmux_front(a32, d, basis, conv.primes),
                       lambda a=a, d=d: cmux_front.cmux_front_plain(a, d, basis, conv.primes),
                       bound(4 * (w + kp * level * w), muls32=5 * kp * level * w))
    g_b = table["cmux_front@1024"][F_ROWS]
    log(f"cmux_front@1024: share of the byte bound {g_b[4][0] / g_b[3]:.3f}")
    # kernel G over 5 primes: a launch a group of at most 4, into slices of one output
    primes5 = tuple(ntt_prime_chain(30, conv.log_n, 5))
    l0 = cmux_front.cmux_front.launches
    cmux_front.cmux_front(acc32, deg, basis, primes5)
    torch.cuda.synchronize()
    if cmux_front.cmux_front.launches - l0 != 2:
        raise AssertionError(f"cmux_front over 5 primes: {cmux_front.cmux_front.launches - l0} "
                             f"launches, want 2")
    w = acc.numel()
    compare_kernel(torch, table, "cmux_front@kp5", BATCH,
                   lambda: cmux_front.cmux_front(acc, deg, basis, primes5),
                   lambda: cmux_front.cmux_front(acc32, deg, basis, primes5),
                   lambda: cmux_front.cmux_front_plain(acc, deg, basis, primes5),
                   bound(4 * (w + 5 * level * w), muls32=5 * 5 * level * w))
    log(f"cmux_front over 5 primes {primes5}: 2 launches (4 + 1 primes) a call, equal to the "
        f"plain version")
    del big, big32
    for fn in counted:
        fn.launches = 0
    torch.cuda.synchronize()
    step = (acc + tfhe.cmux_delta(conv, basis, acc, deg, key0)) & 0xFFFFFFFF
    torch.cuda.synchronize()
    counts = {fn.__name__: fn.launches for fn in counted}
    log(f"one CMux step through cmux_delta, launches: {json.dumps(counts)}")
    want = {name: 0 for name in counts} | {"cmux_front": 1, "forward32": 1, "inverse32": 1}
    if counts != want:
        raise AssertionError(f"cmux_delta launch counts {counts}, want {want}")
    if not torch.equal(step, cmux_fused.fused_cmux_step(conv, basis, acc, deg, key0)):
        raise AssertionError("acc + cmux_delta differs from fused_cmux_step (kernels 3-4)")
    log(f"acc + cmux_delta(...) on key slice 0, batch {BATCH}: the same {step.numel()} words as "
        f"fused_cmux_step (kernels 3-4, one launch)")
    return counts


SHARD_MESH = (2, 2)  # phase 14: (residue, batch), one modulus and 8 ciphertexts a shard
NCCL_BACKEND = "nccl"
CS_Q32, CS_LOG_N32, CS_ROWS32, CS_SHARDS32 = 536813569, 12, 8, (2, 4, 8)  # bench_coeff_sharded.py
CS_SHARDS64 = (4, 2)  # phase 15's u64 shape: phase 12's n = 2^16 and LARGE_Q over 4 and 2 shards
# phase 15's u32 large ring, LARGE_ROWS rows: (log_n, D), shards of 2^14, 2^15, 2^16 words
CS_LARGE32 = ((16, 4), (16, 2), (17, 2))
CS_Q32L = 1073479681  # next_ntt_prime(30, 17): = 1 mod 2^18, below 2^30
CS_TOP_LOG_N = 18  # 15.4: n = 2^18 over D = 2, shards of 2^17 words (row 11 at log_w 17)
CS_Q32T = 1056440321  # next_ntt_prime(30, 18): = 1 mod 2^19, below 2^30 (LARGE_Q is too)
CS_TRIPS = 20  # 15.3: chained forward + inverse trips timed
QUEUED_OPS = 1000  # host ops queued behind one sleep: more fill the launch queue and block the host


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase14_sharded(torch, dev, table, state) -> dict:
    """Phase 14: the residue- and batch-sharded DCRT rotation on a
    ``LocalMesh`` at phase 10's full width, on phase 10's key and inputs, and
    row 12 (the byte-radix kernels on a shard's tables) at a shard's shapes.
    Returns the launch counts of its route-``"auto"`` rotation."""
    import torch.distributed as dist

    from primus_fhe_tpu_torch.boot import dcrt_blind_rotate as dbr
    from primus_fhe_tpu_torch.ops import ntt64, ntt_mxu8, ntt_mxu8_dyn
    from primus_fhe_tpu_torch.parallel import (LocalMesh, ProcessGroupMesh,
                                               make_sharded_blind_rotation, shard_rotation_inputs,
                                               unshard)
    from primus_fhe_tpu_torch.parallel.sharded_rotation import ACC_SPEC

    plan, basis, base = state["plan"], state["basis"], state["base"]
    bsk, lwe, accs = state["bsk"], state["lwe"], state["accs"]
    n_lwe = bsk.shape[0]
    kernels = {"ntt64_forward": ntt64.ntt64_forward, "ntt64_inverse": ntt64.ntt64_inverse,
               "mxu8_forward64": ntt_mxu8.mxu8_forward64,
               "mxu8_inverse64": ntt_mxu8.mxu8_inverse64}

    def rotate(mesh, route, key, lwe_):
        rot = make_sharded_blind_rotation(mesh, "residue", "batch", basis, plan, base, route)
        args = shard_rotation_inputs(mesh, "residue", "batch", key, lwe_, accs)
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = rot(*args)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        return unshard(mesh, out, ACC_SPEC), {k: fn.launches for k, fn in kernels.items()}, secs

    def expect(counts, route, shards, steps):
        own = ("mxu8_forward64", "mxu8_inverse64") if route == "auto" else (
            "ntt64_forward", "ntt64_inverse")
        want = {k: (shards * steps if k in own else 0) for k in kernels}
        if counts != want:
            raise AssertionError(f"[{route}] sharded launch counts {counts}, want {want} (one "
                                 f"forward and one inverse a shard a step)")

    mesh = LocalMesh(*SHARD_MESH, dev)
    log(f"mesh {mesh}: {mesh.size} shards, "
        f"{plan.count // SHARD_MESH[0]} modulus and {DCRT_BATCH // SHARD_MESH[1]} ciphertexts each")
    out, counts, secs = rotate(mesh, "auto", bsk, lwe)
    log(f"[auto] launches: {json.dumps(counts)}")
    expect(counts, "auto", mesh.size, n_lwe)
    if not torch.equal(out, state["out"]):
        raise AssertionError("the sharded rotation differs from phase 10's single-card rotation")
    single_ms, single_rate = state["rates"]["auto"]
    log(f"[auto] all {n_lwe} steps: the same {out.numel()} words as phase 10's batch-{DCRT_BATCH} "
        f"rotation; launches exact ({mesh.size} shards x {n_lwe} steps = {mesh.size * n_lwe} "
        f"each of mxu8_forward64 and mxu8_inverse64); rotation {secs * 1e3:.1f} ms (host clock) "
        f"-> {n_lwe * DCRT_BATCH / secs:.1f} CMux/s, against {single_rate:.1f} CMux/s single-card "
        f"in phase 10")
    rot = make_sharded_blind_rotation(mesh, "residue", "batch", basis, plan, base, "auto")

    def prefix(steps_):
        cut_ = torch.cat([lwe[:, :steps_], lwe[:, -1:]], dim=1)
        args = shard_rotation_inputs(mesh, "residue", "batch", bsk[:steps_], cut_, accs)
        return lambda: rot(*args)

    short = prefix(DCRT_PROFILE_STEPS)
    wall = min(wall_ms(torch, short, 2))
    dev_ms, rows = device_time(torch, short)
    ops = count_host_ops(torch, prefix(2)) - count_host_ops(torch, prefix(1))
    if dev_ms is None:
        log(f"[auto] sharded: device time not measured (the profiler saw no device activity); "
            f"{ops} host ops per step")
    else:
        log(f"[auto] sharded, {DCRT_PROFILE_STEPS} steps at batch {DCRT_BATCH}: device busy "
            f"{dev_ms:.2f} ms of {wall:.2f} ms wall -> idle share {1 - dev_ms / wall:.3f}; {ops} host "
            f"ops per step; top device rows:")
        for ms_, count, key_ in rows[:6]:
            log(f"    {ms_:9.3f} ms  x{count:<6d} {key_[:90]}")

    log("-- 14.2: row 12, mxu8_forward64/mxu8_inverse64 on shard 0's tables at a shard's "
        "shapes (bit-equal)")
    sp = ntt_mxu8_dyn.stack_dyn_plans(plan, SHARD_MESH[0])[0]
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    n, b_loc = plan.n, DCRT_BATCH // SHARD_MESH[1]
    rf, ri = 2 * basis.decompose_length * b_loc * sp.count, 2 * b_loc * sp.count
    f_in = torch.randint(0, sp.moduli[0], (sp.count, rf, n), generator=g, device=dev)
    i_in = torch.randint(0, sp.moduli[0], (sp.count, ri, n), generator=g, device=dev)
    compare_kernel64(torch, table, "mxu8_forward64@shard", b_loc,
                     lambda: ntt_mxu8.mxu8_forward64(sp.mxu, f_in),
                     lambda: ntt_mxu8.mxu8_forward64_plain(sp.mxu, f_in),
                     bound(16 * rf * n, muls32=ntt_muls(rf, n, u64=True)))
    compare_kernel64(torch, table, "mxu8_inverse64@shard", b_loc,
                     lambda: ntt_mxu8.mxu8_inverse64(sp.mxu, i_in),
                     lambda: ntt_mxu8.mxu8_inverse64_plain(sp.mxu, i_in),
                     bound(16 * ri * n, muls32=ntt_muls(ri, n, u64=True)))

    steps = DCRT_CPU_SLICES
    cut = torch.cat([lwe[:, :steps], lwe[:, -1:]], dim=1)
    want = dbr.dcrt_blind_rotate_batched(plan, basis, base, bsk[:steps], cut, accs,
                                         route="butterfly")
    out_b, counts_b, secs_b = rotate(mesh, "butterfly", bsk[:steps], cut)
    expect(counts_b, "butterfly", mesh.size, steps)
    if not torch.equal(out_b, want):
        raise AssertionError("the sharded butterfly prefix differs from the single-card prefix")
    log(f"[butterfly] the first {steps} steps: the same words as the single-card prefix; "
        f"launches exact ({json.dumps(counts_b)}); {secs_b * 1e3:.1f} ms")

    port = _free_port()
    dist.init_process_group(NCCL_BACKEND, init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0)
    try:
        pg = ProcessGroupMesh(1, 1, dev)
        out_n, counts_n, secs_n = rotate(pg, "auto", bsk[:steps], cut)
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    expect(counts_n, "auto", 1, steps)
    if not torch.equal(out_n, want):
        raise AssertionError(f"the world-size-1 {NCCL_BACKEND} prefix differs from the single-card "
                             f"prefix")
    log(f"[{backend} world size 1, mesh (1, 1), auto] the first {steps} steps: the same words "
        f"(the compose's reduce-scatter and all-gather on int64 {out_n.device.type} tensors each "
        f"step); {secs_n * 1e3:.1f} ms")
    return counts


def phase15_coeff(torch, dev, table) -> dict:
    """Phase 15: the coefficient-sharded NTT on ``LocalMesh``es, held
    against the single-card transforms (the u32 large ring at n = 2^16 and
    2^17 against the plain ``forward32``: kernels 1-2 take log_n <= 14),
    and the four stage kernels against their plain versions.  Returns the
    stage kernels' launch counts."""
    from primus_fhe_tpu_torch.numeric.limb import mul_hi_u64
    from primus_fhe_tpu_torch.ops import ntt32, ntt_stages as st
    from primus_fhe_tpu_torch.parallel import LocalMesh, shard, unshard
    from primus_fhe_tpu_torch.parallel import coeff_sharded as cs
    from primus_fhe_tpu_torch.transforms.ntt import forward32, forward64
    from primus_fhe_tpu_torch.transforms.plan import build_plan32, build_plan64

    spec = (None, "residue")
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    kernels = {"ntt32_stages_forward": st.ntt32_stages_forward,
               "ntt32_stages_inverse": st.ntt32_stages_inverse,
               "ntt64_stages_forward": st.ntt64_stages_forward,
               "ntt64_stages_inverse": st.ntt64_stages_inverse}
    q32, n32 = CS_Q32, 1 << CS_LOG_N32
    single = ntt32.NttTables32(CS_LOG_N32, (q32,))
    x32 = torch.randint(0, q32, (CS_ROWS32, n32), generator=g, device=dev)
    q64, n64 = LARGE_Q, 1 << LARGE_LOG_N
    x64 = torch.randint(0, q64, (LARGE_ROWS, n64), generator=g, device=dev)
    want32 = ntt32.forward32(single, x32[None])[0]
    want64 = forward64(build_plan64(LARGE_LOG_N, q64, dev), x64)
    qL = CS_Q32L
    xL = {log_n: torch.randint(0, qL, (LARGE_ROWS, 1 << log_n), generator=g, device=dev)
          for log_n in sorted({log_n for log_n, _ in CS_LARGE32})}
    wantL = {log_n: forward32(build_plan32(log_n, qL, dev), x) for log_n, x in xL.items()}

    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    outs = {}
    for d in CS_SHARDS32:
        mesh = LocalMesh(d, 1, dev)
        f = cs.coeff_sharded_forward32(mesh, "residue", CS_LOG_N32, q32, shard(mesh, x32, spec))
        back = cs.coeff_sharded_inverse32(mesh, "residue", CS_LOG_N32, q32, f)
        outs["u32", d] = unshard(mesh, f, spec), unshard(mesh, back, spec), want32, x32
    for d in CS_SHARDS64:
        mesh = LocalMesh(d, 1, dev)
        f = cs.coeff_sharded_forward64(mesh, "residue", LARGE_LOG_N, q64, shard(mesh, x64, spec))
        back = cs.coeff_sharded_inverse64(mesh, "residue", LARGE_LOG_N, q64, f)
        outs["u64", d] = unshard(mesh, f, spec), unshard(mesh, back, spec), want64, x64
    for log_n, d in CS_LARGE32:
        mesh = LocalMesh(d, 1, dev)
        f = cs.coeff_sharded_forward32(mesh, "residue", log_n, qL, shard(mesh, xL[log_n], spec))
        back = cs.coeff_sharded_inverse32(mesh, "residue", log_n, qL, f)
        outs[f"u32 n=2^{log_n}", d] = (unshard(mesh, f, spec), unshard(mesh, back, spec),
                                      wantL[log_n], xL[log_n])
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in kernels.items()}
    log(f"launches: {json.dumps(counts)}")
    shards32 = sum(CS_SHARDS32) + sum(d for _, d in CS_LARGE32)
    want = {"ntt32_stages_forward": shards32, "ntt32_stages_inverse": shards32,
            "ntt64_stages_forward": sum(CS_SHARDS64), "ntt64_stages_inverse": sum(CS_SHARDS64)}
    if counts != want:
        raise AssertionError(f"stage launch counts {counts}, want {want} (one a shard a transform)")
    inv32 = ntt32.inverse32(single, want32[None])[0]
    for (kind, d), (fwd, back, ref, x) in outs.items():
        if not torch.equal(fwd, ref):
            raise AssertionError(f"{kind} D={d}: the sharded forward differs from the single-card one")
        if not torch.equal(back, x) or (kind == "u32" and not torch.equal(inv32, x)):
            raise AssertionError(f"{kind} D={d}: the sharded round trip does not return the input")
    log(f"u32 n=2^{CS_LOG_N32} q={q32} batch {CS_ROWS32}, D = {CS_SHARDS32}: forward equal to "
        f"forward32 (kernel 1), inverse returns the input as inverse32 (kernel 2) does; u64 "
        f"n=2^{LARGE_LOG_N} q={q64} {LARGE_ROWS} rows, D = {CS_SHARDS64} (rows of 2^"
        f"{LARGE_LOG_N - 2} and 2^{LARGE_LOG_N - 1} words a shard): forward equal to the plain "
        f"forward64, round trip returns the input; u32 n=2^16 and 2^17 q={qL} {LARGE_ROWS} rows, "
        f"(log_n, D) = {CS_LARGE32}: forward equal to the plain forward32, round trip returns "
        f"the input; launches exact (one a shard a transform)")

    log("-- 15.2: the stage kernels vs plain versions (bit-equal), shard 1's tables")
    d = CS_SHARDS32[0]
    log_d, width = d.bit_length() - 1, n32 // d
    log_w, cols = CS_LOG_N32 - log_d, slice(width, 2 * width)
    w, p = (t[log_d:, cols].to(dev) for t in cs.build_expanded_tables32(CS_LOG_N32, q32))
    wi, pi = (t[:log_w, cols].to(dev) for t in cs.build_expanded_inverse_tables32(CS_LOG_N32, q32))
    w32, p32, wi32, pi32 = (t.to(torch.int32) for t in (w, p, wi, pi))
    xf = torch.randint(0, 4 * q32, (CS_ROWS32, width), generator=g, device=dev)
    xi = torch.randint(0, 2 * q32, (CS_ROWS32, width), generator=g, device=dev)
    xf32, xi32 = xf.to(torch.int32), xi.to(torch.int32)
    # the tables' entries each function reads: the forward both lanes' (w and
    # its quotient, 8 bytes a lane a stage), the inverse the y lanes' only
    b32f, b32i = (bound(4 * 2 * CS_ROWS32 * width + lanes * 8 * log_w,
                        muls32=ntt_muls(CS_ROWS32, width)) for lanes in (width, width // 2))
    compare_kernel(torch, table, "ntt32_stages_forward", CS_ROWS32,
                   lambda: st.ntt32_stages_forward(log_w, q32, w, p, xf),
                   lambda: st.ntt32_stages_forward(log_w, q32, w32, p32, xf32),
                   lambda: st.ntt32_stages_forward_plain(log_w, q32, w, p, xf), b32f)
    compare_kernel(torch, table, "ntt32_stages_inverse", CS_ROWS32,
                   lambda: st.ntt32_stages_inverse(log_w, q32, wi, pi, xi),
                   lambda: st.ntt32_stages_inverse(log_w, q32, wi32, pi32, xi32),
                   lambda: st.ntt32_stages_inverse_plain(log_w, q32, wi, pi, xi), b32i)
    log_stage_shares(table, ("ntt32_stages_forward", "ntt32_stages_inverse"), CS_ROWS32,
                     [st.launch_grid(log_w, q32, CS_ROWS32, fwd, 32) for fwd in (True, False)])
    for log_n, d in ((16, 2), (17, 2)):  # the u32 pair at 2 x 2^15 and 2 x 2^16 (n = 2^17)
        log_w, width = log_n - 1, 1 << (log_n - 1)
        cols, tag = slice(width, 2 * width), f"@w{log_n - 1}"
        w, p = (t[1:, cols].to(dev) for t in cs.build_expanded_tables32(log_n, qL))
        wi, pi = (t[:log_w, cols].to(dev) for t in cs.build_expanded_inverse_tables32(log_n, qL))
        w32, p32, wi32, pi32 = (t.to(torch.int32) for t in (w, p, wi, pi))
        xf = torch.randint(0, 4 * qL, (LARGE_ROWS, width), generator=g, device=dev)
        xi = torch.randint(0, 2 * qL, (LARGE_ROWS, width), generator=g, device=dev)
        xf32, xi32 = xf.to(torch.int32), xi.to(torch.int32)
        bf, bi = (bound(4 * 2 * LARGE_ROWS * width + lanes * 8 * log_w,
                        muls32=ntt_muls(LARGE_ROWS, width)) for lanes in (width, width // 2))
        log(f"u32 shard of n = 2^{log_n} over D = {d}: 2^{log_w} words a row, q = {qL}, tables "
            f"{width * 8 * log_w / 1e6:.2f} MB read forward (both lanes), "
            f"{width * 4 * log_w / 1e6:.2f} MB inverse (y lanes)")
        compare_kernel(torch, table, "ntt32_stages_forward" + tag, LARGE_ROWS,
                       lambda: st.ntt32_stages_forward(log_w, qL, w, p, xf),
                       lambda: st.ntt32_stages_forward(log_w, qL, w32, p32, xf32),
                       lambda: st.ntt32_stages_forward_plain(log_w, qL, w, p, xf), bf)
        compare_kernel(torch, table, "ntt32_stages_inverse" + tag, LARGE_ROWS,
                       lambda: st.ntt32_stages_inverse(log_w, qL, wi, pi, xi),
                       lambda: st.ntt32_stages_inverse(log_w, qL, wi32, pi32, xi32),
                       lambda: st.ntt32_stages_inverse_plain(log_w, qL, wi, pi, xi), bi)
        if not torch.equal(st.ntt32_stages_forward(log_w, qL, w, p, xf, 4),
                           st.ntt32_stages_forward_plain(log_w, qL, w, p, xf, 4)):
            raise AssertionError(f"ntt32_stages_forward log_w {log_w} out_factor 4: kernel != plain")
        log_stage_shares(table, ("ntt32_stages_forward" + tag, "ntt32_stages_inverse" + tag),
                         LARGE_ROWS, [st.launch_grid(log_w, qL, LARGE_ROWS, fwd, 32)
                                      for fwd in (True, False)])
    for d in CS_SHARDS64:  # row 11's u64 pair at log_w 14 (D = 4) and 15 (D = 2)
        log_d, width = d.bit_length() - 1, n64 // d
        log_w, cols = LARGE_LOG_N - log_d, slice(width, 2 * width)
        tag = "" if d == CS_SHARDS64[0] else f"@w{log_w}"
        w, p = (t[log_d:, cols].to(dev) for t in cs.build_expanded_tables64(LARGE_LOG_N, q64))
        wi, pi = (t[:log_w, cols].to(dev)
                  for t in cs.build_expanded_inverse_tables64(LARGE_LOG_N, q64))
        words = torch.randint(-(1 << 63), (1 << 63) - 1, (2, LARGE_ROWS, width), generator=g,
                              device=dev)
        xf, xi = mul_hi_u64(words[0], 4 * q64), mul_hi_u64(words[1], 2 * q64)  # [0, 4q), [0, 2q)
        # the x lanes' entries only (w and its quotient, 16 bytes an x lane a
        # stage): the x lane's entry serves the pair
        tab_bytes = 16 * log_w * (width // 2)
        b64 = bound(8 * 2 * LARGE_ROWS * width + tab_bytes,
                    muls32=ntt_muls(LARGE_ROWS, width, u64=True))
        grids = [st.launch_grid(log_w, q64, LARGE_ROWS, fwd) for fwd in (True, False)]
        log(f"u64 shard of D = {d}: 2^{log_w} words a row, tables "
            f"{tab_bytes / 1e6:.2f} MB read (x lanes); the forward "
            f"{'defers' if st.defers64(log_w, q64) else 'does not defer'} its reductions; "
            f"(blocks a cluster, rows a block) forward {grids[0]}, inverse {grids[1]}")
        compare_kernel64(torch, table, "ntt64_stages_forward" + tag, LARGE_ROWS,
                         lambda: st.ntt64_stages_forward(log_w, q64, w, p, xf),
                         lambda: st.ntt64_stages_forward_plain(log_w, q64, w, p, xf), b64)
        compare_kernel64(torch, table, "ntt64_stages_inverse" + tag, LARGE_ROWS,
                         lambda: st.ntt64_stages_inverse(log_w, q64, wi, pi, xi),
                         lambda: st.ntt64_stages_inverse_plain(log_w, q64, wi, pi, xi), b64)
        for of in (2, 4):  # the lazy outputs, which the exchange stages consume
            if not torch.equal(st.ntt64_stages_forward(log_w, q64, w, p, xf, of),
                               st.ntt64_stages_forward_plain(log_w, q64, w, p, xf, of)):
                raise AssertionError(f"ntt64_stages_forward log_w {log_w} out_factor {of}: "
                                     "kernel != plain")
        log_stage_shares(table, ("ntt64_stages_forward" + tag, "ntt64_stages_inverse" + tag),
                         LARGE_ROWS, grids)

    phase15_top(torch, dev, table, g)

    log(f"-- 15.3: the u64 and u32 forward + inverse trips at n = 2^{LARGE_LOG_N}, {LARGE_ROWS} "
        f"rows, timed over {CS_TRIPS} chained trips (CUDA events)")
    trips = (("u64", cs.coeff_sharded_forward64, cs.coeff_sharded_inverse64, q64, x64),
             ("u32", cs.coeff_sharded_forward32, cs.coeff_sharded_inverse32, qL, xL[LARGE_LOG_N]))
    for bits, fwd_fn, inv_fn, q, x in trips:
        for d in CS_SHARDS64:
            mesh = LocalMesh(d, 1, dev)

            def step(v, mesh=mesh, fwd_fn=fwd_fn, inv_fn=inv_fn, q=q):
                f = fwd_fn(mesh, "residue", LARGE_LOG_N, q, v)
                return inv_fn(mesh, "residue", LARGE_LOG_N, q, f)

            v0 = shard(mesh, x, spec)
            if not torch.equal(unshard(mesh, step(v0), spec), x):
                raise AssertionError(f"{bits} D={d}: the timed trip does not return its input")
            ms = chained_ms(torch, step, v0, CS_TRIPS)
            ops = count_host_ops(torch, lambda: step(v0))
            queued = max(1, min(CS_TRIPS, QUEUED_OPS // ops))
            busy, enqueue = queued_ms(torch, step, v0, queued, ms)
            log(f"[{bits} D={d}] {ms:.4f} ms a trip; {ops} host ops a trip, enqueued in "
                f"{enqueue:.4f} ms with the card asleep ({queued} trips queued); device busy "
                + ("not measured (the host fell behind the sleep)" if busy is None else
                   f"{busy:.4f} ms a trip with the host ahead (idle share {1 - busy / ms:.3f})"))
    return counts


def phase15_top(torch, dev, table, g) -> None:
    """15.4: the coefficient-sharded NTT at n = 2^18 over D = 2 (u32 at
    ``CS_Q32T``, u64 at ``LARGE_Q``): the forward equal to the unsharded
    plain transform, the round trip returning the input, one stage launch
    a shard a transform; then row 11's four kernels at log_w 17 (a shard's
    rows, its tables) against their plain versions, timed (tags "@w17")."""
    from primus_fhe_tpu_torch.numeric.limb import mul_hi_u64
    from primus_fhe_tpu_torch.ops import ntt_stages as st
    from primus_fhe_tpu_torch.parallel import LocalMesh, shard, unshard
    from primus_fhe_tpu_torch.parallel import coeff_sharded as cs
    from primus_fhe_tpu_torch.transforms.ntt import forward32, forward64
    from primus_fhe_tpu_torch.transforms.plan import build_plan32, build_plan64

    log_n, d, spec = CS_TOP_LOG_N, 2, (None, "residue")
    n, log_w = 1 << log_n, CS_TOP_LOG_N - 1
    width = n // d
    log(f"-- 15.4: n = 2^{log_n} over D = {d} (rows of 2^{log_w} words a shard), u32 q = "
        f"{CS_Q32T} and u64 q = {LARGE_Q}, {LARGE_ROWS} rows")
    kernels = (st.ntt32_stages_forward, st.ntt32_stages_inverse, st.ntt64_stages_forward,
               st.ntt64_stages_inverse)
    before = [k.launches for k in kernels]
    mesh = LocalMesh(d, 1, dev)
    for bits, q, fwd_fn, inv_fn, plain in (
            (32, CS_Q32T, cs.coeff_sharded_forward32, cs.coeff_sharded_inverse32,
             lambda x: forward32(build_plan32(log_n, CS_Q32T, dev), x)),
            (64, LARGE_Q, cs.coeff_sharded_forward64, cs.coeff_sharded_inverse64,
             lambda x: forward64(build_plan64(log_n, LARGE_Q, dev), x))):
        x = torch.randint(0, q, (LARGE_ROWS, n), generator=g, device=dev)
        f = fwd_fn(mesh, "residue", log_n, q, shard(mesh, x, spec))
        if not torch.equal(unshard(mesh, f, spec), plain(x)):
            raise AssertionError(f"u{bits} n = 2^{log_n} over D = {d}: the sharded forward "
                                 "differs from the unsharded plain transform")
        back = inv_fn(mesh, "residue", log_n, q, f)
        if not torch.equal(unshard(mesh, back, spec), x):
            raise AssertionError(f"u{bits} n = 2^{log_n} over D = {d}: the round trip does not "
                                 "return the input")
    torch.cuda.synchronize()
    launched = [k.launches - b for k, b in zip(kernels, before)]
    if launched != [d] * 4:
        raise AssertionError(f"n = 2^{log_n} over D = {d}: stage launches {launched}, want "
                             f"{[d] * 4}")
    log(f"u32 and u64 at n = 2^{log_n} over D = {d}: the forward equals the unsharded plain "
        f"transform, the round trip returns the input; stage launches {launched} (one a shard "
        "a transform)")
    tag, cols = f"@w{log_w}", slice(width, 2 * width)
    w, p = (t[1:, cols].to(dev) for t in cs.build_expanded_tables32(log_n, CS_Q32T))
    wi, pi = (t[:log_w, cols].to(dev) for t in cs.build_expanded_inverse_tables32(log_n, CS_Q32T))
    w32, p32, wi32, pi32 = (t.to(torch.int32) for t in (w, p, wi, pi))
    qt = CS_Q32T
    xf = torch.randint(0, 4 * qt, (LARGE_ROWS, width), generator=g, device=dev)
    xi = torch.randint(0, 2 * qt, (LARGE_ROWS, width), generator=g, device=dev)
    xf32, xi32 = xf.to(torch.int32), xi.to(torch.int32)
    bf, bi = (bound(4 * 2 * LARGE_ROWS * width + lanes * 8 * log_w,
                    muls32=ntt_muls(LARGE_ROWS, width)) for lanes in (width, width // 2))
    compare_kernel(torch, table, "ntt32_stages_forward" + tag, LARGE_ROWS,
                   lambda: st.ntt32_stages_forward(log_w, qt, w, p, xf),
                   lambda: st.ntt32_stages_forward(log_w, qt, w32, p32, xf32),
                   lambda: st.ntt32_stages_forward_plain(log_w, qt, w, p, xf), bf)
    compare_kernel(torch, table, "ntt32_stages_inverse" + tag, LARGE_ROWS,
                   lambda: st.ntt32_stages_inverse(log_w, qt, wi, pi, xi),
                   lambda: st.ntt32_stages_inverse(log_w, qt, wi32, pi32, xi32),
                   lambda: st.ntt32_stages_inverse_plain(log_w, qt, wi, pi, xi), bi)
    if not torch.equal(st.ntt32_stages_forward(log_w, qt, w, p, xf, 4),
                       st.ntt32_stages_forward_plain(log_w, qt, w, p, xf, 4)):
        raise AssertionError(f"ntt32_stages_forward log_w {log_w} out_factor 4: kernel != plain")
    log_stage_shares(table, ("ntt32_stages_forward" + tag, "ntt32_stages_inverse" + tag),
                     LARGE_ROWS, [st.launch_grid(log_w, qt, LARGE_ROWS, fwd, 32)
                                  for fwd in (True, False)])
    q64 = LARGE_Q
    w, p = (t[1:, cols].to(dev) for t in cs.build_expanded_tables64(log_n, q64))
    wi, pi = (t[:log_w, cols].to(dev) for t in cs.build_expanded_inverse_tables64(log_n, q64))
    words = torch.randint(-(1 << 63), (1 << 63) - 1, (2, LARGE_ROWS, width), generator=g,
                          device=dev)
    xf, xi = mul_hi_u64(words[0], 4 * q64), mul_hi_u64(words[1], 2 * q64)  # [0, 4q), [0, 2q)
    b64 = bound(8 * 2 * LARGE_ROWS * width + 16 * log_w * (width // 2),
                muls32=ntt_muls(LARGE_ROWS, width, u64=True))
    compare_kernel64(torch, table, "ntt64_stages_forward" + tag, LARGE_ROWS,
                     lambda: st.ntt64_stages_forward(log_w, q64, w, p, xf),
                     lambda: st.ntt64_stages_forward_plain(log_w, q64, w, p, xf), b64)
    compare_kernel64(torch, table, "ntt64_stages_inverse" + tag, LARGE_ROWS,
                     lambda: st.ntt64_stages_inverse(log_w, q64, wi, pi, xi),
                     lambda: st.ntt64_stages_inverse_plain(log_w, q64, wi, pi, xi), b64)
    for of in (2, 4):
        if not torch.equal(st.ntt64_stages_forward(log_w, q64, w, p, xf, of),
                           st.ntt64_stages_forward_plain(log_w, q64, w, p, xf, of)):
            raise AssertionError(f"ntt64_stages_forward log_w {log_w} out_factor {of}: "
                                 "kernel != plain")
    log_stage_shares(table, ("ntt64_stages_forward" + tag, "ntt64_stages_inverse" + tag),
                     LARGE_ROWS, [st.launch_grid(log_w, q64, LARGE_ROWS, fwd)
                                  for fwd in (True, False)])


def log_stage_shares(table, names, rows, grids) -> None:
    """Each stage kernel's share of its bound at ``rows`` rows, with the grid
    ``(blocks a cluster, rows a block)`` its launch picked (forward, then
    inverse)."""
    for name, grid in zip(names, grids):
        _, _, _, dev_ms, (bound_ms, bound_by) = table[name][rows]
        log(f"{name:26s} share of the bound {bound_ms / dev_ms:.4f} ({bound_ms:.4f} ms by "
            f"{bound_by} over {dev_ms:.4f} device ms); grid {grid}")


CSM_LOG_N, CSM_BATCH = 12, 64  # bench_coeff_sharded_mxu.py's shape (q = RT_MODULI[0])
CSM_SHARDS = (2, 4)
CSM_BATCH8 = 64  # rows of the 8-plane product (RT_MODULI[1])
CSM14_LOG_N, CSM14_Q = 14, 1125899904679937  # 16.5: n = 2^14 (A = 128), next_ntt_prime(50, 14)


def compare_lazy64(torch, table, name, bsz, kern, plain, q, bnd):
    """Holds a lazy kernel output against its canonical plain version: below
    2q and equal mod q (the lazy-word rule of ``ops/ntt_mxu8_split.py``),
    then times both and the kernel's device time like
    :func:`compare_kernel64`."""
    from primus_fhe_tpu_torch.modular.modops import reduce_once64

    got, want = kern(), plain()
    torch.cuda.synchronize()
    if not bool((got >= 0).all() and (got < 2 * q).all()):
        raise AssertionError(f"{name} batch {bsz}: a lazy word at or above 2q")
    err = int((reduce_once64(got, q) - want).abs().max())
    if err:
        raise AssertionError(f"{name} batch {bsz}: kernel != plain mod q (max abs err {err})")
    ms = cuda_ms(torch, kern, KERNEL_REPS)
    plain_ms = cuda_ms(torch, plain, KERNEL_REPS)
    dev_ms = kernel_device_ms(torch, kern)
    log(f"{name:22s} batch {bsz:3d} shape {tuple(got.shape)}: below 2q, equal mod q; "
        f"wrapper {ms:.4f} ms (device {dev_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
        f"{bnd[0]:.4f} ms ({bnd[1]})")
    table.setdefault(name, {})[bsz] = (0, ms, plain_ms, dev_ms, bnd)


def split_bounds(n: int, planes: int, lanes: int, rows: int, d: int, key: bool) -> dict:
    """The :func:`bound` of each half-transform on a shard of ``d``, by the
    function it computes: ``lanes`` (k0, batch) lanes of the column halves
    and ``rows`` (r0, batch) rows of the row halves; each word read and
    written once, and the shard's ``n / d`` twiddles and key words (16 bytes
    each, value and quotient) read once; or its Shoup multiplies (10 32-bit
    multiplies each) at the multiply peak: an A-point (K1, Ki2) or 128-point
    (K2, Ki1) butterfly transform a lane or row, ``m/2 log m``, plus one a
    word for the twiddle (K1, Ki1) and the key (Ki1), and ``inv_n`` folded
    into the last stage (Ki2, half the words).  ``planes`` is unused by the
    bound: the method's int8 MACs (``planes x 8m x m`` a lane or row) are
    not the function's work."""
    a, b = n // 128, 128
    col, row, shard_tab = 16 * a * lanes, 16 * b * rows, 16 * n // d

    def sub(m: int) -> int:  # Shoup multiplies of one m-point butterfly transform
        return m // 2 * (m.bit_length() - 1)

    return {
        "split_k1": bound(col + shard_tab, muls32=10 * lanes * (sub(a) + a)),
        "split_k2": bound(row, muls32=10 * rows * sub(b)),
        "split_ki1": bound(row + shard_tab * (2 if key else 1),
                           muls32=10 * rows * (sub(b) + b * (2 if key else 1))),
        "split_ki2": bound(col, muls32=10 * lanes * (sub(a) + a // 2)),
    }


def phase16_sharded_mxu(torch, dev, table) -> dict:
    """Phase 16: row 13, the coefficient-sharded byte-radix NTT.  Returns the
    launch counts of its main path: the sharded negacyclic product at
    ``bench.py``'s shape over D = 2 and 4."""
    from primus_fhe_tpu_torch.modular.factor import ShoupFactor64, factor_mul_lazy64
    from primus_fhe_tpu_torch.ops import ntt64, ntt_mxu8, ntt_mxu8_split as split
    from primus_fhe_tpu_torch.parallel import LocalMesh, shard, unshard
    from primus_fhe_tpu_torch.parallel import coeff_sharded_mxu as csm

    coeff, ntt = (None, "residue", None), ("residue", None, None)
    kernels = {"split_k1": split.split_k1, "split_k2": split.split_k2,
               "split_ki1": split.split_ki1, "split_ki2": split.split_ki2}
    q, n, log_n = RT_MODULI[0], 1 << CSM_LOG_N, CSM_LOG_N
    plan = csm.get_sharded_plan(log_n, q)
    tabs, A, B, P = plan.tables, plan.A, plan.B, plan.planes
    g = torch.Generator(device=dev).manual_seed(SEED + 10)

    def reset():
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.synchronize()

    def read():
        torch.cuda.synchronize()
        return {k: fn.launches for k, fn in kernels.items()}

    def sharded(d, x, mt=None, forward_only=False, log_n=log_n, q=q):
        """Coefficient-layout shards of ``x (batch, n)`` on ``LocalMesh(d, 1)``
        through the sharded forward (and the inverse, keyed by ``mt``)."""
        mesh = LocalMesh(d, 1, dev)
        xs = shard(mesh, csm.to_coeff_layout(x, x.shape[1] // B, B), coeff)
        f = csm.sharded_mxu_forward64(mesh, "residue", log_n, q, xs)
        if forward_only:
            return csm.ntt_layout_to_flat(unshard(mesh, f, ntt))
        y = csm.sharded_mxu_inverse64(mesh, "residue", log_n, q, f, mul_tab=mt)
        return csm.from_coeff_layout(unshard(mesh, y, coeff))

    def trip_lines(routes, modmuls):
        for name, (step, v0) in routes.items():
            ms = chained_ms(torch, step, v0, RT_TRIPS)
            busy, enqueue = queued_ms(torch, step, v0, RT_TRIPS, ms)
            log(f"[{name:12s}] {ms:.4f} ms a trip -> {modmuls / (ms / 1e3):.4e} modmul/s; "
                f"{count_host_ops(torch, lambda: step(v0))} host ops a trip, enqueued in "
                f"{enqueue:.4f} ms with the card asleep; device busy "
                + ("not measured (the host fell behind the sleep)" if busy is None else
                   f"{busy:.4f} ms a trip with the host ahead (idle share {1 - busy / ms:.3f})"))

    log(f"n = {n} = {A} x {B}, q = {q} ({P} byte planes); D must divide A and B")
    # -- 16.1: the forward at bench_coeff_sharded_mxu.py's shape ------------------
    x = torch.randint(0, q, (CSM_BATCH, n), generator=g, device=dev)
    want = ntt_mxu8.mxu8_forward64(tabs, x[None])[0]
    reset()
    outs = {d: sharded(d, x, forward_only=True) for d in (1,) + CSM_SHARDS}
    back = {d: sharded(d, x) for d in (1,) + CSM_SHARDS}
    counts_f = read()
    total = 1 + sum(CSM_SHARDS)
    want_f = {"split_k1": 2 * total, "split_k2": 2 * total, "split_ki1": total, "split_ki2": total}
    if counts_f != want_f:
        raise AssertionError(f"forward/round-trip launch counts {counts_f}, want {want_f}")
    for d in outs:
        if not torch.equal(outs[d], want):
            raise AssertionError(f"D={d}: the sharded forward differs from mxu8_forward64")
        if not torch.equal(back[d], x):
            raise AssertionError(f"D={d}: the sharded round trip does not return the input")
    log(f"batch {CSM_BATCH}: the sharded forward at D = 1, 2, 4 equals mxu8_forward64 "
        f"({want.numel()} words) and the inverse returns the input; launches exact "
        f"({json.dumps(counts_f)}: one a shard a transform)")

    xc = csm.to_coeff_layout(x, A, B)

    def local_pipeline():  # bench_coeff_sharded_mxu.py's D = 1 pipeline: K1, transpose, K2
        s = split.split_k1(tabs, xc.reshape(1, A, B * CSM_BATCH), CSM_BATCH, 0)
        s = s.reshape(A, B, CSM_BATCH).transpose(1, 2).reshape(1, A * CSM_BATCH, B)
        return split.split_k2(tabs, s)

    if not torch.equal(csm.ntt_layout_to_flat(local_pipeline().reshape(A, CSM_BATCH, B)), want):
        raise AssertionError("the D = 1 local pipeline differs from mxu8_forward64")
    fused_ms = cuda_ms(torch, lambda: ntt_mxu8.mxu8_forward64(tabs, x[None]), KERNEL_REPS)
    local_ms = cuda_ms(torch, local_pipeline, KERNEL_REPS)
    fused_ms2 = cuda_ms(torch, lambda: ntt_mxu8.mxu8_forward64(tabs, x[None]), KERNEL_REPS)
    log(f"D = 1 local pipeline (K1, transpose, K2) {local_ms:.4f} ms against mxu8_forward64 "
        f"{fused_ms:.4f} / {fused_ms2:.4f} ms (before / after): ratio "
        f"{local_ms / min(fused_ms, fused_ms2):.3f} (bench_coeff_sharded_mxu.py's metric, CUDA "
        f"events, batch {CSM_BATCH})")

    # -- 16.2: the sharded negacyclic product at bench.py's shape, counted ------
    log(f"-- 16.2: the sharded negacyclic product at bench.py's shape (n = {n}, {RT_BATCH} rows)")
    xr = torch.randint(0, q, (RT_BATCH, n), generator=g, device=dev)
    key = torch.randint(0, q, (1, n), generator=g, device=dev)
    mt = tabs.mul_table(key)
    e_out = ntt_mxu8.mxu8_roundtrip64_mul(tabs, xr[None], mt)[0]
    reset()
    prods = {d: sharded(d, xr, mt) for d in CSM_SHARDS}
    counts = read()
    want_c = {k: sum(CSM_SHARDS) for k in kernels}
    log(f"launches of one product at D = {CSM_SHARDS}: {json.dumps(counts)}")
    if counts != want_c:
        raise AssertionError(f"sharded product launch counts {counts}, want {want_c}")
    for d, out in prods.items():
        if not torch.equal(out, e_out):
            raise AssertionError(f"D={d}: the sharded product differs from kernel E")
    log(f"D = {CSM_SHARDS}: the same {e_out.numel()} words as kernel E (mxu8_roundtrip64_mul)")
    modmuls = RT_BATCH * (n * log_n + n)
    log(f"ms a trip over {RT_TRIPS} chained trips (CUDA events; the sharded trips from and to "
        f"coefficient-layout shards); bench.py's metric")
    routes = {"E": (lambda v: ntt_mxu8.mxu8_roundtrip64_mul(tabs, v[None], mt)[0], xr),
              "fwd+D": (lambda v: ntt_mxu8.mxu8_inverse64_mul(
                  tabs, ntt_mxu8.mxu8_forward64(tabs, v[None]), mt)[0], xr)}
    for d in CSM_SHARDS:
        mesh = LocalMesh(d, 1, dev)
        routes[f"sharded D={d}"] = (
            lambda v, mesh=mesh: csm.sharded_mxu_inverse64(
                mesh, "residue", log_n, q, csm.sharded_mxu_forward64(mesh, "residue", log_n, q, v),
                mul_tab=mt),
            shard(mesh, csm.to_coeff_layout(xr, A, B), coeff))
    trip_lines(routes, modmuls)

    # -- 16.3: the 8-plane tier --------------------------------------------------
    q8 = RT_MODULI[1]
    plan8 = csm.get_sharded_plan(log_n, q8)
    x8 = torch.randint(0, q8, (CSM_BATCH8, n), generator=g, device=dev)
    mt8 = plan8.tables.mul_table(torch.randint(0, q8, (1, n), generator=g, device=dev))
    mesh = LocalMesh(CSM_SHARDS[-1], 1, dev)
    f8 = csm.sharded_mxu_forward64(mesh, "residue", log_n, q8,
                                   shard(mesh, csm.to_coeff_layout(x8, A, B), coeff))
    if not torch.equal(csm.ntt_layout_to_flat(unshard(mesh, f8, ntt)),
                       ntt_mxu8.mxu8_forward64(plan8.tables, x8[None])[0]):
        raise AssertionError("8 planes: the sharded forward differs from mxu8_forward64")
    p8 = csm.sharded_mxu_inverse64(mesh, "residue", log_n, q8, f8, mul_tab=mt8)
    if not torch.equal(csm.from_coeff_layout(unshard(mesh, p8, coeff)),
                       ntt_mxu8.mxu8_roundtrip64_mul(plan8.tables, x8[None], mt8)[0]):
        raise AssertionError("8 planes: the sharded product differs from kernel E")
    log(f"q = {q8} ({plan8.planes} planes), batch {CSM_BATCH8}, D = {CSM_SHARDS[-1]}: forward "
        f"equals mxu8_forward64, product equals kernel E")

    # -- 16.4: the four kernels against their plain versions ---------------------
    d = CSM_SHARDS[0]
    log(f"-- 16.4: K1, K2, Ki1, Ki2 vs plain versions at the product's shard shapes (D = {d}, "
        f"shard {d - 1}, {RT_BATCH} rows)")
    k0_off, r0_off = plan.offsets(d, d - 1)
    lanes, rows = B // d * RT_BATCH, A // d * RT_BATCH
    lane_in = torch.randint(0, q, (1, A, lanes), generator=g, device=dev)
    row_in = torch.randint(0, 2 * q, (1, rows, B), generator=g, device=dev)
    key_rows = mt.reshape(1, 2, A, B)[:, :, r0_off:r0_off + A // d].reshape(1, 2, -1).contiguous()
    bnd = split_bounds(n, P, lanes, rows, d, True)
    compare_lazy64(torch, table, "split_k1", RT_BATCH,
                   lambda: split.split_k1(tabs, lane_in, RT_BATCH, k0_off),
                   lambda: split.split_k1_plain(tabs, lane_in, RT_BATCH, k0_off), q,
                   bnd["split_k1"])
    compare_kernel64(torch, table, "split_k2", RT_BATCH, lambda: split.split_k2(tabs, row_in),
                     lambda: split.split_k2_plain(tabs, row_in), bnd["split_k2"])
    compare_lazy64(torch, table, "split_ki1", RT_BATCH,
                   lambda: split.split_ki1(tabs, row_in, RT_BATCH, r0_off, key_rows),
                   lambda: split.split_ki1_plain(tabs, row_in, RT_BATCH, r0_off, key_rows), q,
                   bnd["split_ki1"])
    compare_lazy64(torch, table, "split_ki1@nokey", RT_BATCH,
                   lambda: split.split_ki1(tabs, row_in, RT_BATCH, r0_off),
                   lambda: split.split_ki1_plain(tabs, row_in, RT_BATCH, r0_off), q,
                   split_bounds(n, P, lanes, rows, d, False)["split_ki1"])
    compare_kernel64(torch, table, "split_ki2", RT_BATCH, lambda: split.split_ki2(tabs, lane_in),
                     lambda: split.split_ki2_plain(tabs, lane_in), bnd["split_ki2"])
    for name in ("split_k1", "split_k2", "split_ki1", "split_ki1@nokey", "split_ki2"):
        _, _, _, dev_ms, (bound_ms, bound_by) = table[name][RT_BATCH]
        log(f"{name:22s} share of the bound {bound_ms / dev_ms:.4f} ({bound_ms:.4f} ms by "
            f"{bound_by} over {dev_ms:.4f} device ms)")

    # -- 16.5: the sharded product at n = 2^14 (A = 128: 4 threads a lane) ----
    log14, q14 = CSM14_LOG_N, CSM14_Q
    n14 = 1 << log14
    plan14 = csm.get_sharded_plan(log14, q14)
    tabs14, A14 = plan14.tables, plan14.A
    log(f"-- 16.5: the sharded negacyclic product at n = {n14} = {A14} x {B} ({RT_BATCH} rows, "
        f"q = {q14}, {plan14.planes} planes) against row 10's route")
    x14 = torch.randint(0, q14, (RT_BATCH, n14), generator=g, device=dev)
    mt14 = tabs14.mul_table(torch.randint(0, q14, (1, n14), generator=g, device=dev))
    q14t = torch.tensor([q14], dtype=torch.int64, device=dev).reshape(1, 1, 1)

    def row10_route(v):  # ntt64_forward, the key's lazy Shoup multiply, ntt64_inverse
        f = ntt64.ntt64_forward(tabs14.ntt, v[None])
        key = ShoupFactor64(mt14[:, 0, None], mt14[:, 1, None])
        return ntt64.ntt64_inverse(tabs14.ntt, factor_mul_lazy64(f, key, q14t))[0]

    want14 = row10_route(x14)
    reset()
    prods14 = {d: sharded(d, x14, mt14, log_n=log14, q=q14) for d in CSM_SHARDS}
    counts14 = read()
    log(f"launches of one product at n = {n14}, D = {CSM_SHARDS}: {json.dumps(counts14)}")
    if counts14 != want_c:
        raise AssertionError(f"n = {n14}: sharded product launch counts {counts14}, want {want_c}")
    for d, out in prods14.items():
        if not torch.equal(out, want14):
            raise AssertionError(f"n = {n14}, D={d}: the sharded product differs from row 10's route")
    log(f"D = {CSM_SHARDS}: the same {want14.numel()} words as row 10's route")
    routes = {"row 10 route": (row10_route, x14)}
    for d in CSM_SHARDS:
        mesh = LocalMesh(d, 1, dev)
        routes[f"sharded D={d}"] = (
            lambda v, mesh=mesh: csm.sharded_mxu_inverse64(
                mesh, "residue", log14, q14,
                csm.sharded_mxu_forward64(mesh, "residue", log14, q14, v), mul_tab=mt14),
            shard(mesh, csm.to_coeff_layout(x14, A14, B), coeff))
    trip_lines(routes, RT_BATCH * (n14 * log14 + n14))
    d = CSM_SHARDS[0]
    k0_off, _ = plan14.offsets(d, d - 1)
    lanes, rows = B // d * RT_BATCH, A14 // d * RT_BATCH
    lane14 = torch.randint(0, q14, (1, A14, lanes), generator=g, device=dev)
    bnd = split_bounds(n14, plan14.planes, lanes, rows, d, True)
    compare_lazy64(torch, table, "split_k1@n14", RT_BATCH,
                   lambda: split.split_k1(tabs14, lane14, RT_BATCH, k0_off),
                   lambda: split.split_k1_plain(tabs14, lane14, RT_BATCH, k0_off), q14,
                   bnd["split_k1"])
    compare_kernel64(torch, table, "split_ki2@n14", RT_BATCH,
                     lambda: split.split_ki2(tabs14, lane14),
                     lambda: split.split_ki2_plain(tabs14, lane14), bnd["split_ki2"])
    for name in ("split_k1@n14", "split_ki2@n14"):
        _, _, _, dev_ms, (bound_ms, bound_by) = table[name][RT_BATCH]
        log(f"{name:22s} share of the bound {bound_ms / dev_ms:.4f} ({bound_ms:.4f} ms by "
            f"{bound_by} over {dev_ms:.4f} device ms; D = {d} shard, {lanes} lanes of {A14})")
    return counts


SHARD_DCRT_MESH = (2, 2)  # phase 17: one prime and 32 ciphertexts a shard


def phase17_sharded_dcrt32(torch, dev, conv, basis, key0) -> dict:
    """Phase 17: the 32-bit DCRT transforms and the residue- and
    batch-sharded external product at BOOLEAN_128 width.  Returns the
    kernel 1-2 launch counts of the sharded product."""
    from primus_fhe_tpu_torch.lattice import tfhe
    from primus_fhe_tpu_torch.ops import ntt32
    from primus_fhe_tpu_torch.parallel import LocalMesh, sharded, unshard
    from primus_fhe_tpu_torch.transforms import dcrt

    n, kp = conv.n, conv.count
    k1 = key0.shape[1]
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    plan = dcrt.build_dcrt_plan32(conv.log_n, conv.primes)
    qs = torch.tensor(conv.primes, dtype=torch.int64, device=dev).reshape(kp, 1, 1)
    x = torch.randint(0, 1 << 40, (kp, BATCH * k1, n), generator=g, device=dev) % (4 * qs)
    y = torch.randint(0, 1 << 40, (kp, BATCH * k1, n), generator=g, device=dev) % (2 * qs)
    for of in (1, 4):
        if not torch.equal(dcrt.dcrt_forward32(plan, x, of), ntt32.forward32(conv.ntt, x, of)):
            raise AssertionError(f"dcrt_forward32 out_factor {of} differs from forward32")
    for of in (1, 2):
        if not torch.equal(dcrt.dcrt_inverse32(plan, y, of), ntt32.inverse32(conv.ntt, y, of)):
            raise AssertionError(f"dcrt_inverse32 out_factor {of} differs from inverse32")
    log(f"dcrt_forward32/dcrt_inverse32 over primes {conv.primes} (one launch): equal to "
        f"forward32/inverse32 at every out_factor, {x.numel()} words")
    glwe = torch.randint(0, 1 << 32, (BATCH, k1, n), generator=g, device=dev)
    want = tfhe.external_product(conv, basis, glwe, key0)
    mesh = LocalMesh(*SHARD_DCRT_MESH, dev)
    gs, ks = sharded.shard_external_product_inputs(mesh, glwe, key0)
    for fn in (ntt32.forward32, ntt32.inverse32):
        fn.launches = 0
    torch.cuda.synchronize()
    out = sharded.sharded_external_product(conv, basis, gs, ks, mesh)
    torch.cuda.synchronize()
    counts = {"forward32": ntt32.forward32.launches, "inverse32": ntt32.inverse32.launches}
    if counts != {"forward32": mesh.size, "inverse32": mesh.size}:
        raise AssertionError(f"sharded product launch counts {counts}, want {mesh.size} each (one "
                             f"a shard a transform)")
    if not torch.equal(unshard(mesh, out, sharded.glwe_spec(3)), want):
        raise AssertionError("the sharded external product differs from the single-card one")
    single_ms = cuda_ms(torch, lambda: tfhe.external_product(conv, basis, glwe, key0), KERNEL_REPS)
    sharded_ms = cuda_ms(torch, lambda: sharded.sharded_external_product(conv, basis, gs, ks, mesh),
                         KERNEL_REPS)
    log(f"sharded_external_product on LocalMesh {SHARD_DCRT_MESH}, batch {BATCH}, key slice 0 of "
        f"phase 3's bootstrap key: the same {want.numel()} words as the single-card "
        f"external_product; launches {json.dumps(counts)}; {sharded_ms:.4f} ms against "
        f"{single_ms:.4f} ms single-card (CUDA events)")
    return counts


T64_LOG_BASIS, T64_LEVEL = 16, 4  # tests/test_tfhe64.py's gadget: 64 bits, none dropped


def phase18_torus64(torch, dev, p) -> dict:
    """Phase 18: the 64-bit torus external product at BOOLEAN_128's ring.
    Returns the kernel 1-2 launch counts of one product."""
    from primus_fhe_tpu_torch.decompose import ApproxSignedBasis64
    from primus_fhe_tpu_torch.lattice import tfhe64
    from primus_fhe_tpu_torch.ops import ntt32

    n, k = p.n, p.glwe_dim
    k1 = k + 1
    basis = ApproxSignedBasis64(None, T64_LOG_BASIS, reverse_length=T64_LEVEL)
    conv = tfhe64.make_convolver64(p.log_n, T64_LEVEL, k, T64_LOG_BASIS)
    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    words = lambda *shape: (torch.randint(0, 1 << 32, shape, generator=g, device=dev) << 32) | (  # noqa: E731
        torch.randint(0, 1 << 32, shape, generator=g, device=dev))
    glwe = words(BATCH, k1, n)
    log(f"N = {n}, k = {k}, gadget 2^{T64_LOG_BASIS} x {T64_LEVEL} (drop {basis.drop_bits} bits), "
        f"{conv.count} primes {conv.primes}, batch {BATCH}; full-range u64 words")

    def trivial_ggsw(shift):
        """Noise-free GGSW(X^shift): row r, level l = X^shift * scalar_l at r."""
        ggsw = torch.zeros((k1, T64_LEVEL, k1, n), dtype=torch.int64, device=dev)
        for r in range(k1):
            for lvl in range(T64_LEVEL):
                ggsw[r, lvl, r, shift] = basis.scalars[lvl]
        return tfhe64.ggsw_to_ntt64(conv, ggsw)

    identity = trivial_ggsw(0)
    for fn in (ntt32.forward32, ntt32.inverse32):
        fn.launches = 0
    torch.cuda.synchronize()
    one = tfhe64.external_product64(conv, basis, glwe, identity)
    torch.cuda.synchronize()
    counts = {"forward32": ntt32.forward32.launches, "inverse32": ntt32.inverse32.launches}
    if not torch.equal(one, glwe):
        raise AssertionError("GGSW(1) did not give back the full-range GLWE words")
    if counts != {"forward32": 1, "inverse32": 1}:
        raise AssertionError(f"64-bit product launch counts {counts}, want one forward (the "
                             f"digits) and one inverse")
    shift = tfhe64.external_product64(conv, basis, glwe, trivial_ggsw(3))
    want = torch.cat([-glwe[..., n - 3:], glwe[..., :n - 3]], dim=-1)
    if not torch.equal(shift, want):
        raise AssertionError("GGSW(X^3) did not give the negacyclic shift by 3")
    key = tfhe64.ggsw_to_ntt64(conv, words(k1, T64_LEVEL, k1, n))
    out = tfhe64.external_product64(conv, basis, glwe, key)
    rows = 8
    t0 = time.perf_counter()
    cpu = tfhe64.external_product64(conv, basis, glwe[:rows].cpu(), key.cpu())
    cpu_s = time.perf_counter() - t0
    if not torch.equal(out[:rows].cpu(), cpu):
        raise AssertionError("the 64-bit external product on cuda and on cpu differ")
    ms = cuda_ms(torch, lambda: tfhe64.external_product64(conv, basis, glwe, key), KERNEL_REPS)
    log(f"GGSW(1): the {glwe.numel()} words back exactly; GGSW(X^3): the negacyclic shift; a "
        f"random key: rows 0-{rows - 1} equal the cpu plain versions' ({cpu_s:.2f} s there); "
        f"launches a product {json.dumps(counts)}; {ms:.4f} ms a product at batch {BATCH} (CUDA "
        f"events)")
    return counts


CB_LOG_BASIS, CB_LEVEL = 3, 3  # phase 19: the leveled-MUX gadget (B_cb, L_cb) of the GGSW
PRIV_LOG_BASIS, PRIV_LEVEL = 7, 3  # the private functional switches' gadget
PACK_LOG_BASIS, PACK_LEVEL = 7, 3  # the packing switch's gadget
PACK_COUNT = 64
CB_CPU_BUDGET_S = 90  # the cpu cross-check takes every level when they fit this
TFHE_NOISE_RECORD = 448683.05828684  # NOISE_CHECK_r05.json measured_std: a bootstrap's output


def cb_mux_noise_stddev(p, pbs_std: float, basis_priv, basis_cb) -> float:
    """Predicted stddev (torus units) of the phase error of a leveled MUX on
    a circuit-bootstrapped GGSW at profile ``p``, by ``noise.py``'s model:

    - a GGSW row is a bootstrap output (``pbs_std``) through a private
      functional switch (``noise.key_switch`` over ``n_ext + 1 = kN + 1``
      inputs): the KSK term ``(n_ext+1) L_priv B_priv^2/12 sigma^2`` (~2^13.2
      at 2^7 x 3) and the dropped bits (~2^14.2) beside the bootstrap's
      ~2^18.8, which dominates;
    - the MUX is one external product by that GGSW over the selected input's
      fresh noise (``noise.external_product``): ``(k+1) L_cb N B_cb^2/12
      sigma_ggsw^2`` (~2^26.8 at 2^3 x 3) and the dropped bits ``(k+1) N
      eps^2/12 / 2`` (~2^26.7), ~2^27.2 in all against the 2^30 margin of
      bits at 2^31 (about 7 sigma).
    """
    from primus_fhe_tpu_torch import noise

    ggsw = noise.key_switch(noise.NoiseEstimate(pbs_std**2), p.glwe_sigma, p.glwe_dim * p.n + 1,
                            basis_priv.decompose_length, basis_priv.log_basis,
                            basis_priv.drop_bits)
    return noise.external_product(noise.NoiseEstimate(p.glwe_sigma**2), ggsw.stddev, p.n,
                                  p.glwe_dim, basis_cb.decompose_length, basis_cb.log_basis,
                                  basis_cb.drop_bits).stddev


def phase19_circuit_bootstrap(torch, dev, ctx, smi, cpu_boot_s, reset_counts, read_counts) -> dict:
    """Phase 19: circuit bootstrapping (LWE bit -> GGSW) and the leveled MUX
    at BOOLEAN_128 width on phase 3's NTT key, and the packing switch of 64
    LWEs.  Returns the launch counts of the circuit-bootstrap path (both
    bits: the circuit bootstrap, ``ggsw_to_ntt`` and one ``leveled_mux``)."""
    import copy

    from primus_fhe_tpu_torch import noise
    from primus_fhe_tpu_torch.boot import circuit_bootstrap as cb
    from primus_fhe_tpu_torch.boot.blind_rotate import bootstrap
    from primus_fhe_tpu_torch.boot.gates import leveled_mux
    from primus_fhe_tpu_torch.decompose import ApproxSignedBasis32
    from primus_fhe_tpu_torch.distr.sampling import DiscreteGaussian
    from primus_fhe_tpu_torch.lattice import glwe, glwe_keyswitch, tfhe
    from primus_fhe_tpu_torch.lattice.lwe import encrypt_torus32, phase_torus32
    from primus_fhe_tpu_torch.transforms.torus import TorusConvolver32

    p, conv = ctx.params, ctx.conv
    n, k, n_lwe = p.n, p.glwe_dim, p.lwe_dim
    k1, n_ext = k + 1, k * n
    mask = 0xFFFFFFFF
    basis_cb = ApproxSignedBasis32(None, CB_LOG_BASIS, reverse_length=CB_LEVEL)
    basis_priv = ApproxSignedBasis32(None, PRIV_LOG_BASIS, reverse_length=PRIV_LEVEL)
    # the bootstrap's convolver also serves the private switches (constant
    # polynomials: n_ext + 1 inputs, no factor N) and the MUX: |V| < P/8
    for what, bits in (
            ("private switch", tfhe.external_product_bound_bits(1, PRIV_LEVEL, n_ext,
                                                                PRIV_LOG_BASIS)),
            ("leveled MUX", tfhe.external_product_bound_bits(n, CB_LEVEL, k, CB_LOG_BASIS))):
        if bits + 3 >= conv.product.bit_length():
            raise AssertionError(f"the convolver's primes do not cover the {what} ({bits} bits)")
    model_pbs = noise.blind_rotate(n_lwe, p.glwe_sigma, n, k, p.level, p.log_basis,
                                   ctx.basis.drop_bits).stddev
    mux_model = lambda pbs: cb_mux_noise_stddev(p, pbs, basis_priv, basis_cb)  # noqa: E731
    predicted = mux_model(TFHE_NOISE_RECORD)
    log(f"[{smi}] N={n} k={k} n_lwe={n_lwe}; PBS gadget 2^{p.log_basis} x {p.level}, leveled-MUX "
        f"gadget 2^{CB_LOG_BASIS} x {CB_LEVEL}, private switch 2^{PRIV_LOG_BASIS} x {PRIV_LEVEL}, "
        f"convolver primes {conv.primes}; predicted MUX phase-error std {predicted:.4g} "
        f"(2^{math.log2(predicted):.2f}) from the bootstrap noise record (2^"
        f"{math.log2(TFHE_NOISE_RECORD):.2f}), {mux_model(model_pbs):.4g} (2^"
        f"{math.log2(mux_model(model_pbs)):.2f}) from the model's (2^"
        f"{math.log2(model_pbs):.2f}); margin 2^30")
    glwe_gauss = DiscreteGaussian(p.glwe_sigma)
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    minus_x = torch.zeros(n, dtype=torch.int64, device=dev)
    minus_x[0] = mask
    functions = [(f"mask row {j}, f = s_{j} x", ctx.glwe_secret[j]) for j in range(k)]
    functions.append(("body row, f = -x", minus_x))
    ksks = []
    for label, f in functions:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ksks.append(cb.make_private_functional_ksk(f, ctx.glwe_secret.reshape(-1),
                                                   ctx.glwe_secret, basis_priv, glwe_gauss, conv,
                                                   g))
        torch.cuda.synchronize()
        log(f"private KSK ({label}): {tuple(ksks[-1].shape)}, {ksks[-1].numel() * 8 / 1e6:.1f} MB "
            f"of int64 words, made on the card in {time.perf_counter() - t0:.3f} s")

    cts = encrypt_torus32(torch.tensor([0, 1], device=dev) << 31, ctx.lwe_secret, ctx.gaussian, g)
    x_bits = torch.randint(0, 2, (n,), generator=g, device=dev)
    y_bits = torch.randint(0, 2, (n,), generator=g, device=dev)
    cx = glwe.encrypt_torus(x_bits << 31, ctx.glwe_secret, glwe_gauss, conv, g)
    cy = glwe.encrypt_torus(y_bits << 31, ctx.glwe_secret, glwe_gauss, conv, g)
    cb_args = (conv, ctx.basis, ctx.bsk, conv, basis_cb, basis_priv, ksks)

    def cb_path(ct):
        ggsw = cb.circuit_bootstrap(*cb_args, ct, p.log_n)
        ggsw_ntt = tfhe.ggsw_to_ntt(conv, ggsw)
        return ggsw, ggsw_ntt, leveled_mux(conv, basis_cb, ggsw_ntt, cx, cy)

    reset_counts()
    runs = [cb_path(cts[b]) for b in (0, 1)]
    counts = read_counts()
    log(f"launches of both bits' circuit bootstrap, ggsw_to_ntt and leveled_mux: "
        f"{json.dumps(counts)}")
    want = {"fused_cmux_step": 2 * CB_LEVEL * n_lwe, "rotate": 2 * CB_LEVEL,
            "inverse32": 2 * (k1 * CB_LEVEL + 1), "forward32": 2 * 2}
    for name, c in counts.items():
        if c != want.get(name, 0):
            raise AssertionError(f"{name}: {c} launches on the circuit-bootstrap path, want "
                                 f"{want.get(name, 0)}")
    log(f"exact: fused_cmux_step {CB_LEVEL} x {n_lwe} a circuit bootstrap, rotate {CB_LEVEL} (one a "
        f"bootstrap), inverse32 {k1} x {CB_LEVEL} (one a private switch) + 1 (the MUX), "
        f"forward32 1 (ggsw_to_ntt) + 1 (the MUX's digits), each per bit")

    errors = []
    for bit, (ggsw, _, out) in enumerate(runs):
        if ggsw.shape != (k1, CB_LEVEL, k1, n):
            raise AssertionError(f"GGSW shape {tuple(ggsw.shape)}")
        sel = x_bits if bit else y_bits
        ph = glwe.phase_torus(out, ctx.glwe_secret, conv)
        got = ((ph + (1 << 30)) >> 31) & 1
        bad = int((got != sel).sum())
        if bad:
            raise AssertionError(f"MUX on the bit-{bit} GGSW: {bad} of {n} coefficients wrong")
        err = (ph - (sel << 31)) & mask
        errors.append(torch.where(err >= 1 << 31, err - (1 << 32), err))
        log(f"bit {bit}: the MUX selects {'x' if bit else 'y'} on all {n} coefficients")
    err = torch.cat(errors).double()
    std = err.std().item()
    log(f"[{smi}] MUX phase error over {err.numel()} coefficients: std {std:.4g} "
        f"(2^{math.log2(std):.2f}), max |e| {err.abs().max().item():.4g} "
        f"(2^{math.log2(err.abs().max().item()):.2f}); predicted std {predicted:.4g} "
        f"(2^{math.log2(predicted):.2f}); measured / predicted {std / predicted:.3f}")

    # the bootstrap output noise under the GGSW rows, measured as
    # NOISE_CHECK_r05.json was: 256 sign bootstraps, no key switch
    pbs_bits = torch.randint(0, 2, (256,), generator=g, device=dev)
    pbs_out = bootstrap(conv, ctx.basis, ctx.bsk, ctx.encrypt(pbs_bits, g),
                        torch.full((n,), 1 << 28, dtype=torch.int64, device=dev), p.log_n)
    pbs_err = (phase_torus32(pbs_out, ctx.glwe_secret.reshape(-1))
               - torch.where(pbs_bits.bool(), 1 << 28, -(1 << 28))) & mask
    pbs_std = torch.where(pbs_err >= 1 << 31, pbs_err - (1 << 32), pbs_err).double().std().item()
    log(f"bootstrap output noise over {pbs_bits.numel()} sign bootstraps (no key switch): std "
        f"{pbs_std:.4g} (2^{math.log2(pbs_std):.2f}); record 2^{math.log2(TFHE_NOISE_RECORD):.2f}, "
        f"model 2^{math.log2(model_pbs):.2f}; the MUX model on the measured std: "
        f"{mux_model(pbs_std):.4g} (2^{math.log2(mux_model(pbs_std)):.2f})")

    # the same circuit bootstrap on the cpu (the kernels' plain versions)
    full = CB_LEVEL * cpu_boot_s <= CB_CPU_BUDGET_S
    basis_cpu = basis_cb
    if not full:  # the first level: the same call with one gadget scalar
        basis_cpu = copy.copy(basis_cb)
        basis_cpu.scalars = basis_cb.scalars[:1]
    t0 = time.perf_counter()
    ggsw_cpu = cb.circuit_bootstrap(conv, ctx.basis, ctx.bsk.cpu(), conv, basis_cpu, basis_priv,
                                    [kk.cpu() for kk in ksks], cts[1].cpu(), p.log_n)
    cpu_s = time.perf_counter() - t0
    ggsw_gpu = runs[1][0] if full else runs[1][0][:, :1]
    if not torch.equal(ggsw_gpu.cpu(), ggsw_cpu):
        raise AssertionError("the circuit bootstrap on cuda and on cpu differ")
    log(f"circuit bootstrap of bit 1 on cuda and on cpu (keys copied with .cpu()): the same "
        f"{ggsw_cpu.numel()} words, "
        + (f"all {CB_LEVEL} levels" if full else
           f"the first level's bootstrap and its {k1} private switches (all {CB_LEVEL} would take "
           f"~{CB_LEVEL * cpu_boot_s:.0f} s; the rest checked by decryption above)")
        + f"; {cpu_s:.2f} s on the cpu")

    # the packing switch: 64 fresh LWEs into one GLWE
    basis_pack = ApproxSignedBasis32(None, PACK_LOG_BASIS, reverse_length=PACK_LEVEL)
    pconv = TorusConvolver32(p.log_n, tfhe.external_product_bound_bits(n, PACK_LEVEL, n_lwe,
                                                                       PACK_LOG_BASIS))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pksk = glwe_keyswitch.make_packing_keyswitch_key(ctx.lwe_secret, ctx.glwe_secret, basis_pack,
                                                     glwe_gauss, pconv, g)
    torch.cuda.synchronize()
    pksk_s = time.perf_counter() - t0
    pbits = torch.randint(0, 2, (PACK_COUNT,), generator=g, device=dev)
    lwes = encrypt_torus32(pbits << 31, ctx.lwe_secret, ctx.gaussian, g)
    packed = glwe_keyswitch.pack_lwes(pconv, basis_pack, lwes, pksk)
    want_p = torch.zeros(n, dtype=torch.int64, device=dev)
    want_p[:PACK_COUNT] = pbits
    ph = glwe.phase_torus(packed, ctx.glwe_secret, conv)
    got = ((ph + (1 << 30)) >> 31) & 1
    if not torch.equal(got, want_p):
        raise AssertionError(f"pack_lwes: {int((got != want_p).sum())} of {n} coefficients wrong")
    perr = (ph - (want_p << 31)) & mask
    perr = torch.where(perr >= 1 << 31, perr - (1 << 32), perr).double()
    log(f"pack_lwes: {PACK_COUNT} fresh LWEs (bits at 2^31) into one GLWE, gadget "
        f"2^{PACK_LOG_BASIS} x {PACK_LEVEL}, {pconv.count} primes {pconv.primes}; packing KSK "
        f"{tuple(pksk.shape)} made in {pksk_s:.3f} s; coefficients 0-{PACK_COUNT - 1} decrypt to "
        f"the bits and {PACK_COUNT}-{n - 1} to 0; phase error std {perr.std().item():.4g}, max "
        f"|e| {perr.abs().max().item():.4g}")

    # timings
    ct1 = cts[1]
    cb_ms = wall_ms(torch, lambda: cb.circuit_bootstrap(*cb_args, ct1, p.log_n), 3)
    tp = torch.full((n,), 1 << 28, dtype=torch.int64, device=dev)
    boots_ms = wall_ms(torch, lambda: [bootstrap(conv, ctx.basis, ctx.bsk, ct1, tp, p.log_n)
                                       for _ in range(CB_LEVEL)], 3)
    big = bootstrap(conv, ctx.basis, ctx.bsk, ct1, tp, p.log_n)
    switch_ms = [cuda_ms(torch, lambda kk=kk: cb.private_functional_key_switch(
        conv, basis_priv, big, kk), KERNEL_REPS) for kk in ksks]
    mux_ms = cuda_ms(torch, lambda: leveled_mux(conv, basis_cb, runs[1][1], cx, cy), KERNEL_REPS)
    pack_ms = cuda_ms(torch, lambda: glwe_keyswitch.pack_lwes(pconv, basis_pack, lwes, pksk),
                      KERNEL_REPS)
    ops = {name: count_host_ops(torch, fn) for name, fn in (
        ("private switch", lambda: cb.private_functional_key_switch(conv, basis_priv, big, ksks[0])),
        ("leveled_mux", lambda: leveled_mux(conv, basis_cb, runs[1][1], cx, cy)),
        ("pack_lwes", lambda: glwe_keyswitch.pack_lwes(pconv, basis_pack, lwes, pksk)))}
    log(f"host ops a call: {json.dumps(ops)}")
    ksk_bound = bound(4 * ksks[0].numel())  # the KSK's u32 words read once
    log(f"[{smi}] one circuit bootstrap: {min(cb_ms):.2f} ms (least of 3, host clock); its "
        f"{CB_LEVEL} bootstraps {min(boots_ms):.2f} ms (host clock), its {k1 * CB_LEVEL} private "
        f"switches {CB_LEVEL * sum(switch_ms):.2f} ms (CUDA events, {KERNEL_REPS} runs each)")
    for (label, _), ms in zip(functions, switch_ms):
        log(f"[{smi}] private switch ({label}): {ms:.4f} ms a switch against its byte bound "
            f"{ksk_bound[0]:.4f} ms (the KSK's {ksks[0].numel()} u32 words read once at 3.35 TB/s; "
            f"stored as int64, twice that), share {ksk_bound[0] / ms:.4f}")
    log(f"[{smi}] one leveled_mux: {mux_ms:.4f} ms; one pack_lwes of {PACK_COUNT} LWEs: "
        f"{pack_ms:.4f} ms (CUDA events, {KERNEL_REPS} runs each)")
    return counts


TRACKED_KINDS = ("nand", "and", "or")
SAMPLER_DRAWS = 1 << 20  # phase 20's sampler checks: draws a test


def _within_5_sigma(label: str, count: int, draws: int, p: float) -> str:
    """Checks that ``count`` of ``draws`` lies within 5 sigma of ``draws p``."""
    sigma = math.sqrt(draws * p * (1 - p))
    if abs(count - draws * p) > 5 * sigma:
        raise AssertionError(f"{label}: {count} of {draws}, want {draws * p:.0f} +- 5 x {sigma:.1f}")
    return f"{label} {count / draws:.5f} (want {p}, {abs(count - draws * p) / sigma:.2f} sigma)"


def phase20_extras(torch, dev) -> None:
    """Phase 20.3-20.4: the modular extras on CUDA int64 tensors against the
    same calls on their CPU copies, and the samplers on a CUDA generator."""
    from primus_fhe_tpu_torch.distr import sampling
    from primus_fhe_tpu_torch.modular import barrett32, barrett64, compact, modops

    q32, q64 = 1073692673, 1125899906826241  # the parity tests' primes
    qc32, qc64 = (1 << 30) - 35, (1 << 62) - 57
    g = torch.Generator().manual_seed(SEED + 21)

    def draw(q, shape=(4096,)):
        return torch.randint(0, q, shape, generator=g, dtype=torch.int64)

    a32, b32, c32 = draw(q32), draw(q32), draw(q32)
    e32 = draw(1 << 32)
    a64, b64, c64 = draw(q64), draw(q64), draw(q64)
    ac, bc, cc = draw(qc32), draw(qc32), draw(qc32)
    ad, bd = draw(qc32, (64, 53)), draw(qc32, (64, 53))
    a6, b6 = draw(qc64), draw(qc64)
    a6d, b6d = draw(qc64, (16, 19)), draw(qc64, (16, 19))
    w_lo, w_hi = draw(1 << 62) << 1, draw(q64 >> 2)
    cases = {
        "lazy_add32": lambda o, m, n: modops.lazy_add32(o(a32 + q32 * (a32 & 1)), o(b32), 2 * q32),
        "double32": lambda o, m, n: modops.double32(o(a32), q32),
        "sqr32": lambda o, m, n: modops.sqr32(o(a32), m),
        "mul_add32": lambda o, m, n: modops.mul_add32(o(a32), o(b32), o(c32), m),
        "exp32": lambda o, m, n: modops.exp32(o(a32), q32 - 1, m),
        "exp32 (tensor e)": lambda o, m, n: modops.exp32(o(a32), o(e32), m),
        "exp_pow_of_2_32": lambda o, m, n: modops.exp_pow_of_2_32(o(a32), 5, m),
        "inv32": lambda o, m, n: modops.inv32(o(a32), m, q32),
        "div32": lambda o, m, n: modops.div32(o(a32), o(b32), m, q32),
        "uint_mul32": lambda o, m, n: modops.uint_mul32(o(e32), o(e32.flip(0)), 12345678),
        "double64": lambda o, m, n: modops.double64(o(a64), q64),
        "barrett_lazy_reduce_wide64": lambda o, m, n: modops.barrett_lazy_reduce_wide64(
            o(w_lo), o(w_hi), n),
        "lazy_mul64": lambda o, m, n: modops.lazy_mul64(o(a64), o(b64), n),
        "sqr64": lambda o, m, n: modops.sqr64(o(a64), n),
        "mul_add64": lambda o, m, n: modops.mul_add64(o(a64), o(b64), o(c64), n),
        "exp64": lambda o, m, n: modops.exp64(o(a64), 1 << 20, n),
        "exp_pow_of_2_64": lambda o, m, n: modops.exp_pow_of_2_64(o(a64), 3, n),
        "inv64": lambda o, m, n: modops.inv64(o(a64), n, q64),
        "div64": lambda o, m, n: modops.div64(o(a64), o(b64), n, q64),
        "uint_mul64": lambda o, m, n: modops.uint_mul64(o(a64), o(b64), (1 << 63) - 25),
        "compact_add32": lambda o, m, n: compact.compact_add32(o(ac), o(bc), qc32),
        "compact_sub32": lambda o, m, n: compact.compact_sub32(o(ac), o(bc), qc32),
        "compact_double32": lambda o, m, n: compact.compact_double32(o(ac), qc32),
        "compact_neg32": lambda o, m, n: compact.compact_neg32(o(ac), qc32),
        "compact_lazy_sub32": lambda o, m, n: compact.compact_lazy_sub32(o(ac), o(bc), qc32),
        "compact_reduce_once32": lambda o, m, n: compact.compact_reduce_once32(o(ac + bc), qc32),
        "compact_mul32": lambda o, m, n: compact.compact_mul32(o(ac), o(bc), qc32),
        "compact_mul_add32": lambda o, m, n: compact.compact_mul_add32(o(ac), o(bc), o(cc), qc32),
        "compact_dot32": lambda o, m, n: compact.compact_dot32(o(ad), o(bd), qc32),
        "compact_add64": lambda o, m, n: compact.compact_add64(o(a6), o(b6), qc64),
        "compact_sub64": lambda o, m, n: compact.compact_sub64(o(a6), o(b6), qc64),
        "compact_double64": lambda o, m, n: compact.compact_double64(o(a6), qc64),
        "compact_lazy_sub64": lambda o, m, n: compact.compact_lazy_sub64(o(a6), o(b6), qc64),
        "compact_reduce_once64": lambda o, m, n: compact.compact_reduce_once64(o(a6 + b6), qc64),
        "compact_mul64": lambda o, m, n: compact.compact_mul64(o(a6), o(b6), qc64),
        "compact_dot64": lambda o, m, n: compact.compact_dot64(o(a6d), o(b6d), qc64),
    }
    recs = {d: (barrett32(q32, d), barrett64(q64, d)) for d in ("cpu", dev)}
    for name, fn in cases.items():
        want = fn(lambda x: x, *recs["cpu"])
        got = fn(lambda x: x.to(dev), *recs[dev])
        if got.device.type != dev.type or not torch.equal(got.cpu(), want):
            raise AssertionError(f"{name}: the card's words differ from the cpu's")
    log(f"{len(cases)} modops and compact extras on CUDA int64 tensors: the same words as on "
        f"the cpu ({', '.join(cases)})")

    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    q, moduli, draws = q32, (q32, 1073668097), SAMPLER_DRAWS
    t = sampling.sample_ternary(gen, (draws,), q)
    lines = [_within_5_sigma("sample_ternary P[0]", int((t == 0).sum()), draws, 0.5),
             _within_5_sigma("P[1]", int((t == 1).sum()), draws, 0.25),
             _within_5_sigma("P[q-1]", int((t == q - 1).sum()), draws, 0.25)]
    crt = sampling.sample_crt_ternary(gen, (draws,), moduli)
    qcol = torch.tensor(moduli, device=dev).unsqueeze(1)
    signed = torch.where(crt == qcol - 1, -1, crt)
    if crt.shape != (2, draws) or not torch.equal(signed[0], signed[1]) or int(
            (signed.abs() > 1).sum()):
        raise AssertionError("sample_crt_ternary: slots disagree or leave {0, 1, q - 1}")
    lines.append(_within_5_sigma("sample_crt_ternary P[-1]", int((signed[0] == -1).sum()), draws,
                                 0.25))
    bits = sampling.sample_crt_binary(gen, (draws,), moduli)
    if not torch.equal(bits[0], bits[1]):
        raise AssertionError("sample_crt_binary: slots disagree")
    lines.append(_within_5_sigma("sample_crt_binary P[1]", int(bits[0].sum()), draws, 0.5))
    gauss = sampling.DiscreteGaussian(3.2)
    gs = sampling.sample_crt_gaussian(gen, (draws,), moduli, gauss)
    cent = torch.where(gs > qcol // 2, gs - qcol, gs)
    if not torch.equal(cent[0], cent[1]) or int(cent.abs().max()) > 40:
        raise AssertionError("sample_crt_gaussian: slots disagree or a draw past 12 sigma")
    lines.append(_within_5_sigma("sample_crt_gaussian P[0]", int((cent[0] == 0).sum()), draws,
                                 float(1 / (3.2 * math.sqrt(2 * math.pi)))))
    u = gauss.sample_mod_u64(gen, (draws,), q64)
    if int(((u >= 64) & (u < q64 - 64)).sum()) or int((u == q64 - 1).sum()) == 0:
        raise AssertionError("sample_mod_u64: a draw outside [q - 64, q) + [0, 64)")
    log(f"samplers on a CUDA generator, {draws} draws each: " + "; ".join(lines)
        + "; sample_mod_u64 wraps negatives to q64 + s")


def phase20_tracked(torch, dev, ctx, smi, reset_counts, read_counts) -> dict:
    """Phase 20: the evaluation keys saved, loaded onto the card, and run as
    noise-tracked gates; the host layer's checks beside them.  Returns the
    launch counts of the three tracked gates."""
    import os
    import tempfile

    from primus_fhe_tpu_torch import noise, tracked
    from primus_fhe_tpu_torch import params as P
    from primus_fhe_tpu_torch.boot.gates import TRUE_MU
    from primus_fhe_tpu_torch.ops import build, ntt32
    from primus_fhe_tpu_torch.utils import contracts, profiling, secrets, serialize

    p = ctx.params
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        path = os.path.join(tmp, "keys.npz")
        with profiling.Timer() as t_save:
            P.save_keys(path, ctx)
        size_mb = os.path.getsize(path) / 1e6
        with profiling.Timer() as t_load:
            lctx = P.load_keys(path, device=dev)
    if lctx.params != p or lctx.device != ctx.device:
        raise AssertionError(f"load_keys: {lctx.params} on {lctx.device}")
    for name in ("bsk", "ksk", "lwe_secret", "glwe_secret"):
        if not torch.equal(getattr(lctx, name), getattr(ctx, name)):
            raise AssertionError(f"load_keys: the reloaded {name} differs from the original")
    log(f"[{smi}] save_keys: {t_save.elapsed:.3f} s ({size_mb:.1f} MB .npz); load_keys onto the "
        f"card: {t_load.elapsed:.3f} s (profiling.Timer); bsk {tuple(lctx.bsk.shape)}, ksk "
        f"{tuple(lctx.ksk.shape)} and both secrets equal the originals word for word")

    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    idx = torch.arange(BATCH, device=dev)
    a_bits, b_bits = (idx & 1).bool(), ((idx >> 1) & 1).bool()
    ta, tb = tracked.encrypt_bit(lctx, g, a_bits), tracked.encrypt_bit(lctx, g, b_bits)
    truth = {"nand": ~(a_bits & b_bits), "and": a_bits & b_bits, "or": a_bits | b_bits}
    zero = {name: 0 for name in read_counts()}
    want = zero | {"fused_cmux_step": p.lwe_dim, "rotate": 1}
    totals = dict(zero)
    errors = []
    for kind in TRACKED_KINDS:
        reset_counts()
        out = tracked.gate(lctx, kind, ta, tb)
        counts = read_counts()
        if counts != want:
            raise AssertionError(f"tracked {kind}: launches {counts}, want {want}")
        totals = {k: totals[k] + counts[k] for k in totals}
        ph = tracked.decrypt_phase(lctx, out)
        if not torch.equal(ph > 0, truth[kind]):
            raise AssertionError(f"tracked {kind}: wrong truth table")
        errors.append(ph - torch.where(truth[kind], TRUE_MU, -TRUE_MU))
        if out.margin(2) <= 1:
            raise AssertionError(f"tracked {kind}: margin(2) {out.margin(2):.3f} <= 1")
    std = torch.cat(errors).double().std().item()
    pred = out.noise.stddev
    if not 0.2 * pred < std < 5 * pred:
        raise AssertionError(f"tracked gates: output std {std:.4g} outside [0.2, 5] x the "
                             f"prediction {pred:.4g}")
    log(f"tracked NAND, AND, OR at batch {BATCH} (each input pair {BATCH // 4} times): truth "
        f"tables right; launches a gate {json.dumps(want)} (asserted, nothing else); output "
        f"phase error std {std:.4g} (2^{math.log2(std):.2f}) against the tracked prediction "
        f"{pred:.4g} (2^{math.log2(pred):.2f}), ratio {std / pred:.3f}; margin(2) "
        f"{out.margin(2):.3f}")
    bad = tracked.TrackedLwe(ta.ct, noise.NoiseEstimate(2.0**58))
    reset_counts()
    try:
        tracked.gate(lctx, "nand", bad, bad)
    except ValueError as e:
        if "unsafe" not in str(e):
            raise
        refusal = str(e)
    else:
        raise AssertionError("tracked gate on an inflated variance did not refuse")
    if read_counts() != zero:
        raise AssertionError("the refused tracked gate launched a kernel")
    log(f"inflated variance 2^58: {refusal!r}, no launch")
    gate_s = []
    for _ in range(3):
        with profiling.Timer() as t_gate:
            tracked.gate(lctx, "nand", ta, tb)
        gate_s.append(t_gate.elapsed)
    log(f"[{smi}] tracked NAND at batch {BATCH}: {1e3 * min(gate_s):.2f} ms (least of 3, "
        f"profiling.Timer; all {', '.join(f'{1e3 * s:.2f}' for s in gate_s)})")

    moduli = tuple(lctx.conv.primes)
    with profiling.Timer() as t_pack:
        data = serialize.pack_container("bootstrap_key", lctx.bsk, domain="ntt", moduli=moduli)
    with profiling.Timer() as t_unpack:
        kind, bsk2, meta = serialize.unpack_container(data, expect_kind="bootstrap_key",
                                                      device=dev)
    if not torch.equal(bsk2, lctx.bsk) or meta != {"domain": "ntt", "moduli": moduli}:
        raise AssertionError("pack_container / unpack_container changed the bootstrap key")
    log(f"[{smi}] pack_container(bootstrap_key) from the card: {len(data) / 1e6:.1f} MB in "
        f"{t_pack.elapsed:.3f} s; unpacked onto the card in {t_unpack.elapsed:.3f} s, equal")
    del data, bsk2

    phase20_extras(torch, dev)

    tabs = lctx.conv.ntt
    col = torch.tensor(tabs.primes, device=dev).reshape(-1, 1, 1)
    over = (4 * col).expand(len(tabs.primes), 1, tabs.n).contiguous()  # 4q: one past the contract
    saved = os.environ.get("PRIMUS_DEBUG")
    os.environ["PRIMUS_DEBUG"] = "1"
    try:
        l0 = ntt32.forward32.launches
        try:
            ntt32.forward32(tabs, over)
        except contracts.RangeContractError as e:
            refusal = str(e)
        else:
            raise AssertionError("PRIMUS_DEBUG=1: kernel 1 took a 4q input")
        if ntt32.forward32.launches != l0:
            raise AssertionError("the contract check let kernel 1 launch")
        ntt32.forward32(tabs, over - 1)
        torch.cuda.synchronize()
        if ntt32.forward32.launches != l0 + 1:
            raise AssertionError("kernel 1 did not launch on an input inside the contract")
    finally:
        if saved is None:
            os.environ.pop("PRIMUS_DEBUG")
        else:
            os.environ["PRIMUS_DEBUG"] = saved
    log(f"PRIMUS_DEBUG=1: kernel 1 on 4q words raised before its launch ({refusal}); on 4q - 1 "
        f"it launched once")

    secret = lctx.glwe_secret
    view = secret.view(-1)
    secrets.delete(lctx.lwe_secret, secret)
    torch.cuda.synchronize()
    if secret.device != ctx.device or int(view.abs().sum()) or int(lctx.lwe_secret.abs().sum()):
        raise AssertionError("secrets.delete left a nonzero word")
    log("secrets.delete zeroed the reloaded context's secrets on the card in place")
    return totals


WIDE_LOG_N = 15  # phase 21: BOOLEAN_128 with its ring widened to N = 2^15
TOP_LOG_N = 17  # 21.1, 21.2, 21.5 and 22.6: the widest ring kernels 1-2, H and J take
WIDE_BATCH = 16  # 21.2's batch for kernel H's times; 21.3's 16 ciphertexts
MSG_BITS = 4  # 21.3 and 21.5: the programmable bootstrap's message bits (and a padding bit)
# 21.2: (log_n, log_basis, level, k, bound_bits or None: make_convolver's)
STAGED_SHAPES = [(15, 7, 3, 1, None), (16, 7, 3, 1, 60), (10, 7, 3, 2, 60), (10, 1, 20, 1, None),
                 (17, 7, 3, 1, None)]


def stage2_bound(kp: int, bsz: int, k1: int, level: int, n: int) -> tuple[float, str]:
    """Kernel H's :func:`bound`: the digits, the key slice, the accumulator
    in and out and the inverse tables once; the MAC's products and the kp
    B k1 inverse NTTs."""
    nbytes = 4 * (kp * bsz * k1 * level * n + kp * k1 * level * k1 * n + 2 * bsz * k1 * n
                  + 2 * kp * n)
    return bound(nbytes, muls32=kp * bsz * k1 * k1 * level * n + ntt_muls(kp * bsz * k1, n))


def time_stage2(torch, dev, table, smi, g, residues, log_n: int, tag: str) -> None:
    """21.2's kernel H at BOOLEAN_128's gadget widened to ``2^log_n``, batch
    1 and ``WIDE_BATCH``, against its plain version (the table's
    ``"cmux_stage2" + tag``), and the staged step's device ms with G's and
    kernel 1's."""
    import dataclasses

    from primus_fhe_tpu_torch import params as P
    from primus_fhe_tpu_torch.decompose import ApproxSignedBasis32
    from primus_fhe_tpu_torch.lattice import tfhe
    from primus_fhe_tpu_torch.ops import cmux_front, cmux_fused, ntt32, rotate

    wide = dataclasses.replace(P.BOOLEAN_128, log_n=log_n)
    conv = tfhe.make_convolver(wide.log_n, wide.level, wide.glwe_dim, wide.log_basis)
    basis = ApproxSignedBasis32(None, wide.log_basis, reverse_length=wide.level)
    n, kp, k1, level = wide.n, conv.count, wide.glwe_dim + 1, wide.level
    key = residues(conv.primes, (k1, level, k1, n), 1)
    key32 = key.to(torch.int32)
    plan = cmux_fused.CmuxStepPlan(conv, basis, k1, dev)
    for bsz in (1, WIDE_BATCH):
        f = residues(conv.primes, (bsz * k1, level, n), 4)
        acc = torch.randint(0, 1 << 32, (bsz, k1, n), generator=g, device=dev)
        f32, acc32 = f.to(torch.int32), acc.to(torch.int32)
        hb = stage2_bound(kp, bsz, k1, level, n)
        compare_kernel(torch, table, "cmux_stage2" + tag, bsz,
                       lambda: cmux_fused.cmux_stage2(conv, f, key, acc),
                       lambda: cmux_fused.cmux_stage2(conv, f32, key32, acc32),
                       lambda: cmux_fused.cmux_stage2_plain(conv, f, key, acc), hb)
        h_ms = table["cmux_stage2" + tag][bsz][3]
        h_grid = cmux_fused.launch_grid(conv, k1, bsz)
        if h_grid[0] < 2:  # a row over a cluster of slices, one block a row before
            raise AssertionError(f"kernel H at N = 2^{log_n}, batch {bsz}: grid {h_grid}")
        deg = torch.randint(0, 2 * n, (bsz,), generator=g, device=dev, dtype=torch.int32)
        gb = bound(4 * (bsz * k1 * n + kp * bsz * k1 * level * n))  # G: acc in, digits out
        if tag:  # G and F at this ring in the table too (F: the bootstrap's start)
            compare_kernel(torch, table, "cmux_front" + tag, bsz,
                           lambda: cmux_front.cmux_front(acc, deg, basis, conv.primes),
                           lambda: cmux_front.cmux_front(acc.to(torch.int32), deg, basis,
                                                         conv.primes),
                           lambda: cmux_front.cmux_front_plain(acc, deg, basis, conv.primes), gb)
            test_row = acc[0, 0]
            compare_kernel(torch, table, "rotate" + tag, bsz,
                           lambda: rotate.rotate(test_row.expand(bsz, n), deg),
                           lambda: rotate.rotate(test_row.to(torch.int32).expand(bsz, n), deg),
                           lambda: rotate.rotate_plain(test_row.expand(bsz, n), deg),
                           bound(4 * (n + bsz * n)))
        digits = torch.empty((kp, bsz, k1, level, n), dtype=torch.int32, device=dev)
        g_ms = kernel_device_ms(torch, lambda: cmux_front.cmux_front(acc32, deg, basis,
                                                                     conv.primes, out=digits))
        one_ms = kernel_device_ms(torch, lambda: ntt32.forward32(conv.ntt, digits, 4, out=digits))
        step_ms = kernel_device_ms(torch, lambda: plan(acc32, deg, key32, out=acc32))
        log(f"[{smi}] staged step at N = 2^{log_n}, batch {bsz}: device {step_ms:.4f} ms "
            f"(CUDA events behind a sleep): G {g_ms:.4f} (bound {gb[0]:.4f}), kernel 1 "
            f"{one_ms:.4f}, H {h_ms:.4f} ms; H's bound {hb[0]:.4f} ms ({hb[1]}), share "
            f"{hb[0] / h_ms:.4f}; H's launch (blocks a row, threads, shared bytes, clusters "
            f"held) {h_grid}")


def programmable_bootstrap(torch, dev, smi, label, wide, seed, reps, reset_counts,
                           read_counts):
    """``make_context(wide, bsk_kind="ntt")`` on the card (its seconds and
    peak device memory) and a ``MSG_BITS``-bit programmable bootstrap of 16
    ciphertexts, decrypted under the GLWE key (every message to f(m)), with
    its exact launches (G, kernel 1 and H once a key slice, F once), its
    phase error against ``noise.blind_rotate``, and its latency at batch 1
    and 16 (least of ``reps``), busy ms and idle share.  Returns the
    launch counts and the 16 outputs."""
    from primus_fhe_tpu_torch import noise
    from primus_fhe_tpu_torch import params as P
    from primus_fhe_tpu_torch.boot.blind_rotate import bootstrap, lut_test_polynomial
    from primus_fhe_tpu_torch.lattice.lwe import encrypt_torus32, phase_torus32

    log(f"-- {label}: make_context(BOOLEAN_128 at N = 2^{wide.log_n}, bsk_kind='ntt') and a "
        f"{MSG_BITS}-bit programmable bootstrap")
    n, level = wide.n, wide.level
    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.empty_cache()  # the earlier phases' cached blocks
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wctx = P.make_context(wide, dev, gen, bsk_kind="ntt")
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"keygen: {keygen_s:.3f} s, peak device memory {peak:.2f} GB "
        f"(torch.cuda.max_memory_allocated); bsk {tuple(wctx.bsk.shape)} "
        f"({wctx.bsk.numel() * wctx.bsk.element_size() / 1e9:.2f} GB), ksk "
        f"{tuple(wctx.ksk.shape)}; primes {wctx.conv.primes}")
    delta = 1 << (32 - MSG_BITS - 1)  # the padding bit: messages in [0, 2^31)
    f_of = [(3 * m + 1) % (1 << MSG_BITS) for m in range(1 << MSG_BITS)]
    tp = lut_test_polynomial([v * delta for v in f_of], wide.log_n, MSG_BITS).to(dev)
    msgs = torch.arange(1 << MSG_BITS, device=dev)
    cts = encrypt_torus32(msgs * delta, wctx.lwe_secret, wctx.gaussian, gen)
    reset_counts()
    out = bootstrap(wctx.conv, wctx.basis, wctx.bsk, cts, tp, wide.log_n)
    counts = read_counts()
    ph = phase_torus32(out, wctx.glwe_secret.reshape(-1))
    got = ((ph + delta // 2) // delta) % (2 << MSG_BITS)
    want = torch.tensor(f_of, device=dev)
    log(f"16 messages m -> f(m) = 3m + 1 mod 16, decrypted under the GLWE key: "
        f"{got.tolist()}")
    if not torch.equal(got, want):
        raise AssertionError(f"programmable bootstrap: got {got.tolist()}, want {want.tolist()}")
    err = ph - want * delta
    err = torch.where(err >= 1 << 31, err - (1 << 32), err).double()
    pred = noise.blind_rotate(wide.lwe_dim, wide.glwe_sigma, n, wide.glwe_dim, level,
                              wide.log_basis, wctx.basis.drop_bits)
    pre = noise.modulus_switch(noise.fresh_lwe(wide.lwe_sigma), wide.lwe_dim, wide.log_n + 1)
    ks = noise.key_switch(pred, wide.lwe_sigma, wide.glwe_dim * n, wide.ks_level,
                          wide.ks_log_basis, wctx.ks_basis.drop_bits)
    std = err.std().item()
    log(f"phase error of the 16 extracted samples: std {std:.1f} (2^{math.log2(std):.2f}), max "
        f"|e| {err.abs().max().item():.0f}; noise.blind_rotate predicts {pred.stddev:.1f} "
        f"(2^{math.log2(pred.stddev):.2f}), ratio {std / pred.stddev:.3f}; the model's margins "
        f"at {MSG_BITS} bits: pre-rotation {pre.decryption_failure_margin(MSG_BITS):.2f}, "
        f"bootstrapped sample {pred.decryption_failure_margin(MSG_BITS):.2f}, after the key "
        f"switch {ks.decryption_failure_margin(MSG_BITS):.3f} (1 bit: "
        f"{ks.decryption_failure_margin(1):.3f}; so no key switch here)")
    if pred.decryption_failure_margin(MSG_BITS) <= 1:
        raise AssertionError(f"{MSG_BITS} message bits at N = 2^{wide.log_n}: the model's margin "
                             f"{pred.decryption_failure_margin(MSG_BITS):.3f} is not above 1")
    steps = wide.lwe_dim
    want_counts = {name: 0 for name in counts} | (
        {"cmux_front": steps, "forward32": steps, "columns_forward": steps, "mac_sub": steps,
         "cmux_stage2_cols": steps, "rotate": 1} if wide.log_n > TOP_LOG_N else
        {"cmux_front": steps, "forward32": steps, "cmux_stage2": steps, "rotate": 1})
    log(f"launches of one bootstrap at batch 16: {json.dumps(counts)}")
    if counts != want_counts:
        raise AssertionError(f"programmable bootstrap launches {counts}, want {want_counts}")
    boot = lambda c: bootstrap(wctx.conv, wctx.basis, wctx.bsk, c, tp, wide.log_n)  # noqa: E731
    lat = min(wall_ms(torch, lambda: boot(cts[:1]), reps))
    rate = min(wall_ms(torch, lambda: boot(cts), reps))
    busy, rows = device_time(torch, lambda: boot(cts))
    idle = "not measured" if busy is None else f"{1 - busy / rate:.3f}"
    log(f"[{smi}] programmable bootstrap at N = 2^{wide.log_n}: batch 1 {lat:.2f} ms, batch 16 "
        f"{rate:.2f} ms ({16e3 / rate:.1f} bootstraps/s) (host clock, synchronised, least of "
        f"{reps}); device busy {busy if busy is None else round(busy, 3)} ms of the batch-16 run "
        f"-> idle share {idle}; top device rows: "
        + "; ".join(f"{key_[:50]} x{c} ({ms_:.2f} ms)" for ms_, c, key_ in rows[:4]))
    del wctx, cts
    torch.cuda.empty_cache()
    return counts, out


def mxu_key_bootstrap(torch, dev, smi, label, wide, seed, pbs_ref, reps, reset_counts,
                      read_counts) -> dict:
    """``make_context(wide, bsk_kind="mxu")`` from the generator state that
    made ``pbs_ref``'s NTT key (``Generator(seed)``), its seconds and peak
    device memory, and the same ``MSG_BITS``-bit programmable bootstrap of
    16 ciphertexts on it: the same outputs word for word, with exact
    launches (G, kernel 1 and H once a key slice, F once: the MXU pack's
    values on the staged route, past kernel A, so the pack carries no
    quotients), and its latency at batch 1 and 16 (least of ``reps``), busy
    ms and idle share.  Returns the bootstrap's launch counts."""
    from primus_fhe_tpu_torch import params as P
    from primus_fhe_tpu_torch.boot.blind_rotate import bootstrap, lut_test_polynomial
    from primus_fhe_tpu_torch.lattice.lwe import encrypt_torus32

    log(f"-- {label}: make_context(BOOLEAN_128 at N = 2^{wide.log_n}, bsk_kind='mxu') from the "
        f"NTT key's draws and its {MSG_BITS}-bit programmable bootstrap")
    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wctx = P.make_context(wide, dev, gen, bsk_kind="mxu")
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    vals, precons = wctx.bsk
    if precons is not None:
        raise AssertionError(f"the MXU pack at N = 2^{wide.log_n} carries quotients past kernel A")
    log(f"keygen: {keygen_s:.3f} s, peak device memory {peak:.2f} GB "
        f"(torch.cuda.max_memory_allocated; kernel 1 prepares the MXU key at this ring, in "
        f"chunks); bsk values {tuple(vals.shape)} ({vals.numel() * vals.element_size() / 1e9:.2f} "
        f"GB), no quotients (past kernel A)")
    delta = 1 << (32 - MSG_BITS - 1)
    f_of = [(3 * m + 1) % (1 << MSG_BITS) for m in range(1 << MSG_BITS)]
    tp = lut_test_polynomial([v * delta for v in f_of], wide.log_n, MSG_BITS).to(dev)
    msgs = torch.arange(1 << MSG_BITS, device=dev)
    cts = encrypt_torus32(msgs * delta, wctx.lwe_secret, wctx.gaussian, gen)
    reset_counts()
    pbs = bootstrap(wctx.conv, wctx.basis, wctx.bsk, cts, tp, wide.log_n)
    counts_p = read_counts()
    if not torch.equal(pbs, pbs_ref):
        raise AssertionError(f"the programmable bootstrap on the MXU key at N = 2^{wide.log_n} "
                             "differs from the NTT key's")
    want_p = {name: 0 for name in counts_p} | {
        "cmux_front": wide.lwe_dim, "forward32": wide.lwe_dim, "cmux_stage2": wide.lwe_dim,
        "rotate": 1}
    if counts_p != want_p:
        raise AssertionError(f"programmable bootstrap on the MXU key: launches {counts_p}")
    log(f"the 16 outputs equal the NTT key's word for word ({pbs.numel()} words); launches of "
        f"one bootstrap: {json.dumps(counts_p)}")
    boot = lambda c: bootstrap(wctx.conv, wctx.basis, wctx.bsk, c, tp, wide.log_n)  # noqa: E731
    lat = min(wall_ms(torch, lambda: boot(cts[:1]), reps))
    rate = min(wall_ms(torch, lambda: boot(cts), reps))
    busy, rows = device_time(torch, lambda: boot(cts))
    idle = "not measured" if busy is None else f"{1 - busy / rate:.3f}"
    log(f"[{smi}] programmable bootstrap at N = 2^{wide.log_n} on the MXU key: batch 1 "
        f"{lat:.2f} ms, batch 16 {rate:.2f} ms (host clock, synchronised, least of {reps}); "
        f"device busy {busy if busy is None else round(busy, 3)} ms of the batch-16 run -> idle "
        f"share {idle}")
    del wctx, vals, cts, pbs
    torch.cuda.empty_cache()
    return counts_p


def phase21_staged(torch, dev, table, ctx, smi, reset_counts, read_counts) -> dict:
    """Phase 21: the NTT-key blind rotation past the one-launch step's caps.
    21.1 kernels 1-2 at log_n 15-17 (a row over a cluster); 21.2 kernel H
    and the staged step (kernel G, kernel 1, kernel H) against the plain
    step, timed at N = 2^15 and 2^17; 21.3 a 4-bit programmable bootstrap
    at N = 2^15 on the card; 21.4 BOOLEAN_128 still on the fused step; 21.5
    the programmable bootstrap at N = 2^17 on the NTT key and on the MXU key
    (made in chunks, the same 16 outputs).  Returns the launch counts of
    21.3's and 21.5's bootstraps and 21.3's 16 outputs."""
    import dataclasses

    from primus_fhe_tpu_torch import params as P
    from primus_fhe_tpu_torch.boot.blind_rotate import bootstrap
    from primus_fhe_tpu_torch.decompose import ApproxSignedBasis32
    from primus_fhe_tpu_torch.lattice import tfhe
    from primus_fhe_tpu_torch.ops import cmux_front, cmux_fused, ntt32, rotate
    from primus_fhe_tpu_torch.transforms.torus import TorusConvolver32

    g = torch.Generator(device=dev).manual_seed(SEED + 21)

    def residues(primes, shape, factor):
        q = torch.tensor(primes, dtype=torch.int64, device=dev).reshape((-1,) + (1,) * len(shape))
        return torch.randint(0, 1 << 40, (len(primes),) + shape, generator=g, device=dev) % (
            factor * q)

    # -- 21.1: kernels 1-2 at log_n 15-17 --------------------------------------
    log("-- 21.1: kernels 1-2 at log_n 15-17 (a row over a cluster of 2, 4 or 8 blocks)")
    for log_n in (15, 16, TOP_LOG_N):
        n = 1 << log_n
        for kp in (2, 3):
            tables = TorusConvolver32(log_n, 56 if kp == 2 else 60).ntt
            if len(tables.primes) != kp:
                raise AssertionError(f"log_n {log_n}: {len(tables.primes)} primes, want {kp}")
            for rows in (1, WIDE_BATCH):
                x4, x2 = residues(tables.primes, (rows, n), 4), residues(tables.primes, (rows, n), 2)
                for of in (1, 4):
                    if not torch.equal(ntt32.forward32(tables, x4, of),
                                       ntt32.forward32_plain(tables, x4, of)):
                        raise AssertionError(f"forward32 log_n {log_n} kp {kp} x {rows}: != plain")
                for of in (1, 2):
                    if not torch.equal(ntt32.inverse32(tables, x2, of),
                                       ntt32.inverse32_plain(tables, x2, of)):
                        raise AssertionError(f"inverse32 log_n {log_n} kp {kp} x {rows}: != plain")
                b = bound(8 * kp * rows * n, muls32=ntt_muls(kp * rows, n))
                x4_32, x2_32 = x4.to(torch.int32), x2.to(torch.int32)
                compare_kernel(torch, table, f"ntt32_forward@log{log_n}kp{kp}", rows,
                               lambda: ntt32.forward32(tables, x4, 4),
                               lambda: ntt32.forward32(tables, x4_32, 4),
                               lambda: ntt32.forward32_plain(tables, x4, 4), b)
                compare_kernel(torch, table, f"ntt32_inverse@log{log_n}kp{kp}", rows,
                               lambda: ntt32.inverse32(tables, x2),
                               lambda: ntt32.inverse32(tables, x2_32),
                               lambda: ntt32.inverse32_plain(tables, x2), b)
    log(f"kernels 1-2 at log_n 15, 16 and {TOP_LOG_N}, kp 2 and 3, 1 and 16 rows a prime: every "
        "out_factor bit-equal to the plain versions (timed: the forward at out_factor 4, the "
        "staged route's, and the canonical inverse)")
    tables = tfhe.make_convolver(TOP_LOG_N, 3, 1, 7).ntt  # the staged PBS's kernel 1 at 2^17
    kp, n = len(tables.primes), 1 << TOP_LOG_N
    # kp 3 (its 58-bit bound): 18 / 288 rows at batch 1 / 16
    for bsz in (1, WIDE_BATCH):
        rows = bsz * 2 * 3
        x4 = residues(tables.primes, (rows, n), 4)
        x4_32 = x4.to(torch.int32)
        compare_kernel(torch, table, f"ntt32_forward@pbs{TOP_LOG_N}", bsz,
                       lambda: ntt32.forward32(tables, x4, 4),
                       lambda: ntt32.forward32(tables, x4_32, 4, out=x4_32),
                       lambda: ntt32.forward32_plain(tables, x4, 4),
                       bound(8 * kp * rows * n + 8 * kp * n, muls32=ntt_muls(kp * rows, n)))

    # -- 21.2: kernel H and the staged step ------------------------------------
    log("-- 21.2: kernel H (cmux_stage2) and the staged step against the plain step")
    for log_n, log_basis, level, k, bound_bits in STAGED_SHAPES:
        conv = (TorusConvolver32(log_n, bound_bits) if bound_bits
                else tfhe.make_convolver(log_n, level, k, log_basis))
        basis = ApproxSignedBasis32(None, log_basis, reverse_length=level)
        n, kp, k1 = 1 << log_n, conv.count, k + 1
        plan = cmux_fused.CmuxStepPlan(conv, basis, k1, dev)
        if plan.route != "staged":
            raise AssertionError(f"{(log_n, level, kp, k1)}: route {plan.route}, want staged")
        acc = torch.randint(0, 1 << 32, (2, k1, n), generator=g, device=dev)
        key = residues(conv.primes, (k1, level, k1, n), 1)
        acc32, key32 = acc.to(torch.int32), key.to(torch.int32)
        counted = (cmux_front.cmux_front, ntt32.forward32, cmux_fused.cmux_stage2,
                   cmux_fused.fused_cmux_step)
        l0 = [fn.launches for fn in counted]
        for step in range(4):
            deg = torch.randint(0, 2 * n, (2,), generator=g, device=dev, dtype=torch.int32)
            acc = cmux_fused.cmux_stage2_plain(
                conv, cmux_fused.cmux_stage1_plain(conv, basis, acc, deg), key, acc)
            plan(acc32, deg, key32, out=acc32)
            if not torch.equal(acc32.to(torch.int64) & 0xFFFFFFFF, acc):
                raise AssertionError(f"staged step {step} at {(log_n, level, kp, k1)} != plain")
        launched = [fn.launches - b for fn, b in zip(counted, l0)]
        if launched != [4, 4, 4, 0]:
            raise AssertionError(f"staged steps at {(log_n, level, kp, k1)}: launches {launched}")
        log(f"log_n {log_n}, 2^{log_basis} x {level}, k1 {k1} over {kp} primes (kp k1 = "
            f"{kp * k1}): 4 staged steps at batch 2 bit-equal to the plain step; launches G / "
            f"kernel 1 / H / fused {launched}; H's launch (blocks a row, threads, shared bytes, "
            f"clusters held) {cmux_fused.launch_grid(conv, k1, 2)}")
    for log_n, tag in ((WIDE_LOG_N, ""), (TOP_LOG_N, f"@log{TOP_LOG_N}")):
        time_stage2(torch, dev, table, smi, g, residues, log_n, tag)
    wide = dataclasses.replace(P.BOOLEAN_128, log_n=WIDE_LOG_N)

    # -- 21.3: a 4-bit programmable bootstrap at N = 2^15 -------------------------
    counts, out = programmable_bootstrap(torch, dev, smi, "21.3", wide, SEED + 23, 3,
                                         reset_counts, read_counts)

    # -- 21.4: BOOLEAN_128 stays on the fused step --------------------------------
    p = ctx.params
    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    reset_counts()
    ct = ctx.encrypt(torch.tensor([1, 0], device=dev), gen)
    bootstrap(ctx.conv, ctx.basis, ctx.bsk, ct,
              torch.full((p.n,), 1 << 29, dtype=torch.int64, device=dev), p.log_n)
    fused = read_counts()
    if fused["fused_cmux_step"] != p.lwe_dim or fused["cmux_stage2"] or fused["cmux_front"]:
        raise AssertionError(f"BOOLEAN_128 bootstrap launches {fused}")
    log(f"-- 21.4: a BOOLEAN_128 bootstrap: {fused['fused_cmux_step']} fused_cmux_step "
        f"launches, {fused['cmux_stage2']} of kernel H, {fused['cmux_front']} of G (the fused "
        f"route, as before)")

    # -- 21.5: a 4-bit programmable bootstrap at N = 2^17, on both key kinds -----
    top = dataclasses.replace(P.BOOLEAN_128, log_n=TOP_LOG_N)
    counts17, out17 = programmable_bootstrap(torch, dev, smi, "21.5", top, SEED + 27, 2,
                                             reset_counts, read_counts)
    mxu_key_bootstrap(torch, dev, smi, "21.5", top, SEED + 27, out17, 2, reset_counts,
                      read_counts)
    return counts, out, counts17


MXU_WIDE_LOG_N = 12  # 22.3: BOOLEAN_128 at N = 4096 on the MXU key (k1 L = 6: past kernel A)
NTRU_WIDE_LOG_N = 13  # 22.5: NTRU_128's gadget, n_lwe and sigmas at N = 2^13
NTRU_WIDE_BATCH = 16
NTRU_CHECK_STEPS = 8  # 22.5: staged steps held to the plain step on the card


def ntru_stage2_bound(bsz: int, level: int, n: int, digits: bool = True) -> tuple[float, str]:
    """Kernel J's :func:`bound`: the digits, the evk row, the accumulator in
    and out, the degrees and the inverse tables once, and with ``digits``
    the next step's digits out; the MAC's products and the B inverse
    NTTs."""
    nbytes = 4 * ((1 + digits) * level * bsz * n + level * n + 2 * bsz * n + bsz + 2 * n)
    return bound(nbytes, muls32=bsz * level * n + ntt_muls(bsz, n))


def ntru_top(torch, dev, table, smi, reset_counts, read_counts) -> dict:
    """22.6: NTRU_128's gadget, n_lwe and sigmas at N = 2^17 on the staged
    route.  ``make_ntru_keys`` on the card (both evaluation-key forms, made
    in chunks of LWE indices, and the key-switch key; its seconds and peak
    memory); kernels I, 1 (at the step's ``L x B`` rows, kp 1) and J at
    batch 1 and ``NTRU_WIDE_BATCH`` against their plain versions;
    ``NTRU_CHECK_STEPS`` staged steps against the plain step; one rotation
    on each evaluation-key form, the same words, each with the launches I 1,
    kernel 1 and J ``n_lwe``; the latency at batch 1 (both forms) and
    ``NTRU_WIDE_BATCH`` (MXU pack; least of 2), busy ms and idle share.
    Returns the MXU pack's rotation's launch counts."""
    import dataclasses

    from primus_fhe_tpu_torch import params as P
    from primus_fhe_tpu_torch.boot import ntru_blind_rotate as nbr
    from primus_fhe_tpu_torch.ops import ntru_cmux_mxu, ntt32

    pw = dataclasses.replace(P.NTRU_128, log_n=TOP_LOG_N)
    log(f"-- 22.6: NTRU_128's gadget, n_lwe and sigmas at N = 2^{TOP_LOG_N} (q = {pw.q}): "
        f"make_ntru_keys on the card, kernels I, 1 and J, the staged rotation on both evk forms")
    gen = torch.Generator(device=dev).manual_seed(SEED + 28)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    keys = P.make_ntru_keys(pw, dev, gen)
    torch.cuda.synchronize()
    kctx, evk_mxu = keys.ctx, keys.evk_mxu
    qn, nn = kctx.q_int, kctx.n
    level = kctx.basis.decompose_length
    log(f"make_ntru_keys: {time.perf_counter() - t0:.3f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB (held after it "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB); evk {tuple(keys.evk.shape)}, evk_mxu "
        f"{tuple(evk_mxu[0].shape)} x 2, ksk {tuple(keys.ksk.shape)}")
    tag = f"@log{TOP_LOG_N}"
    for bsz in (1, NTRU_WIDE_BATCH):
        rows = level * bsz  # kernel 1 in the staged step: the digits of B rows, in place
        x = torch.randint(0, qn, (1, rows, nn), generator=gen, device=dev)
        x32 = x.to(torch.int32)
        compare_kernel(torch, table, f"ntt32_forward@ntru{TOP_LOG_N}", bsz,
                       lambda: ntt32.forward32(kctx.ntt, x, 4),
                       lambda: ntt32.forward32(kctx.ntt, x32, 4, out=x32),
                       lambda: ntt32.forward32_plain(kctx.ntt, x, 4),
                       bound(8 * rows * nn + 8 * nn, muls32=ntt_muls(rows, nn)))
        acc = torch.randint(0, qn, (bsz, nn), generator=gen, device=dev)
        acc32 = acc.to(torch.int32)
        deg = torch.randint(0, 2 * nn, (bsz,), generator=gen, device=dev, dtype=torch.int32)
        compare_kernel(torch, table, "ntru_digits" + tag, bsz,
                       lambda: ntru_cmux_mxu.ntru_digits(kctx.basis, acc),
                       lambda: ntru_cmux_mxu.ntru_digits(kctx.basis, acc32),
                       lambda: ntru_cmux_mxu.ntru_digits_plain(kctx.basis, acc),
                       bound(4 * (bsz * nn + level * bsz * nn)))
        f = ntru_cmux_mxu.ntru_stage1(kctx.ntt, kctx.basis, acc)
        f32 = f.to(torch.int32)
        evk_row = evk_mxu[0][0].reshape(level, nn)
        evk32 = evk_row.to(torch.int32)
        want_j, want_dig = ntru_cmux_mxu.ntru_stage2_plain(kctx.ntt, f, evk_row, acc, deg,
                                                           kctx.basis)
        f_dig, acc_in = f32.clone(), acc32.clone()
        out_j = ntru_cmux_mxu.ntru_stage2(kctx.ntt, f_dig, evk32, acc_in, deg, out=acc_in,
                                          basis=kctx.basis)
        if not (torch.equal(out_j.to(torch.int64), want_j)
                and torch.equal(f_dig.to(torch.int64), want_dig)):
            raise AssertionError(f"kernel J with digits at N = 2^{TOP_LOG_N}, batch {bsz}: "
                                 "!= plain")
        f_run = f32.clone()  # the timed calls write their digits over it
        compare_kernel(torch, table, "ntru_stage2" + tag, bsz,
                       lambda: ntru_cmux_mxu.ntru_stage2(kctx.ntt, f32.clone(), evk32, acc32, deg,
                                                         basis=kctx.basis).to(torch.int64),
                       lambda: ntru_cmux_mxu.ntru_stage2(kctx.ntt, f_run, evk32, acc32, deg,
                                                         basis=kctx.basis),
                       lambda: ntru_cmux_mxu.ntru_stage2_plain(kctx.ntt, f, evk_row, acc, deg),
                       ntru_stage2_bound(bsz, level, nn))
        step = ntru_cmux_mxu.NtruStepPlan(kctx, dev)
        if step.route != "staged":
            raise AssertionError(f"NTRU at N = 2^{TOP_LOG_N}: route {step.route}")
        kv32 = evk_mxu[0][:NTRU_CHECK_STEPS].to(torch.int32).contiguous()
        nplan = ntru_cmux_mxu.get_ntru_plan(TOP_LOG_N, qn)
        plain_acc, run = acc.clone(), acc32.clone()
        sw = torch.randint(0, 2 * nn, (NTRU_CHECK_STEPS, bsz), generator=gen, device=dev,
                           dtype=torch.int32)
        for i in range(NTRU_CHECK_STEPS):
            plain_acc = ntru_cmux_mxu.ntru_cmux_step_plain(nplan, kctx.basis, plain_acc, sw[i],
                                                           evk_mxu[0][i])
            run = step(run, sw[i], kv32[i], None)
            if not torch.equal(run.to(torch.int64), plain_acc):
                raise AssertionError(f"NTRU staged step {i} at N = 2^{TOP_LOG_N}, batch {bsz} "
                                     "!= plain")
        step_ms = kernel_device_ms(torch, lambda: step(run, sw[0], kv32[0], None))
        log(f"[{smi}] N = 2^{TOP_LOG_N}: the first {NTRU_CHECK_STEPS} staged steps at batch "
            f"{bsz} bit-equal to the plain step on the card; one step after the first "
            f"{step_ms:.4f} device ms (kernel 1 "
            f"{table[f'ntt32_forward@ntru{TOP_LOG_N}'][bsz][3]:.4f}, J with digits "
            f"{table['ntru_stage2' + tag][bsz][3]:.4f}, I "
            f"{table['ntru_digits' + tag][bsz][3]:.4f} once a rotation); J's launch (blocks a "
            f"row, threads, shared bytes, clusters held) "
            f"{ntru_cmux_mxu.launch_grid(TOP_LOG_N, bsz)}")
    tpn = nbr.ntru_test_polynomial(nn, qn, (qn - 1) // 8, dev)
    sw = torch.randint(0, 2 * nn, (NTRU_WIDE_BATCH, pw.lwe_dim + 1), generator=gen, device=dev,
                       dtype=torch.int32)
    rotated, counted = {}, {}
    for form, evk in (("MXU pack", evk_mxu), ("NTT evk", keys.evk)):
        reset_counts()
        rotated[form] = nbr.ntru_blind_rotate(kctx, evk, sw[:1], tpn)
        counts_form = counted[form] = read_counts()
        want = {name: 0 for name in counts_form} | {
            "ntru_digits": 1, "forward32": pw.lwe_dim, "ntru_stage2": pw.lwe_dim}
        log(f"launches of one rotation at batch 1 on the {form}: {json.dumps(counts_form)}")
        if counts_form != want:
            raise AssertionError(f"NTRU staged rotation at N = 2^{TOP_LOG_N} on the {form}: "
                                 f"launches {counts_form}, want {want}")
    if not torch.equal(rotated["MXU pack"], rotated["NTT evk"]):
        raise AssertionError(f"NTRU rotation at N = 2^{TOP_LOG_N}: the two evk forms differ")
    counts = counted["MXU pack"]
    lat_ntt = min(wall_ms(torch, lambda: nbr.ntru_blind_rotate(kctx, keys.evk, sw[:1], tpn), 2))
    log(f"[{smi}] both evk forms rotate to the same {rotated['NTT evk'].numel()} words; the NTT "
        f"evk's rotation at batch 1 {lat_ntt:.2f} ms (host clock, synchronised, least of 2)")
    lat = min(wall_ms(torch, lambda: nbr.ntru_blind_rotate(kctx, evk_mxu, sw[:1], tpn), 2))
    rate = min(wall_ms(torch, lambda: nbr.ntru_blind_rotate(kctx, evk_mxu, sw, tpn), 2))
    busy, rows = device_time(torch, lambda: nbr.ntru_blind_rotate(kctx, evk_mxu, sw, tpn))
    idle = "not measured" if busy is None else f"{1 - busy / rate:.3f}"
    log(f"[{smi}] NTRU staged rotation at N = 2^{TOP_LOG_N} ({pw.lwe_dim} steps): batch 1 "
        f"{lat:.2f} ms, batch {NTRU_WIDE_BATCH} {rate:.2f} ms (host clock, synchronised, least "
        f"of 2); device busy {busy if busy is None else round(busy, 3)} ms of the batch-"
        f"{NTRU_WIDE_BATCH} run -> idle share {idle}; top rows: "
        + "; ".join(f"{key_[:40]} x{c} ({ms_:.2f} ms)" for ms_, c, key_ in rows[:4]))
    del keys, evk_mxu
    torch.cuda.empty_cache()
    return counts


def phase22_mxu_ntru(torch, dev, table, smi, pbs_21, reset_counts, read_counts) -> dict:
    """Phase 22: the MXU key and the NTRU MXU evk past kernels A-C's caps.
    22.1 the route rules on kernels A and B's C entry; 22.2 kernel C's route
    at log_n 13-16; 22.3 BOOLEAN_128 at N = 4096 on the MXU key; 22.4
    21.3's programmable bootstrap on the MXU key; 22.5 NTRU at N = 2^13 on
    kernels I, 1 and J; 22.6 NTRU at N = 2^17 on the same kernels; 22.7
    BOOLEAN_128 and NTRU_128 still on kernels A and B.  Returns the launch
    counts of 22.4's bootstrap, 22.3's gate and 22.5's and 22.6's
    rotations."""
    import dataclasses

    from primus_fhe_tpu_torch import params as P
    from primus_fhe_tpu_torch.boot import gates, ntru_gates
    from primus_fhe_tpu_torch.boot import ntru_blind_rotate as nbr
    from primus_fhe_tpu_torch.modular.modops import add32, neg32, sub32
    from primus_fhe_tpu_torch.ops import cmux_fused, cmux_mxu, ntru_cmux_mxu, ntt32, ntt_mxu8
    from primus_fhe_tpu_torch.transforms.torus import TorusConvolver32

    # -- 22.1: the route rules on kernels A and B's C entry -----------------------
    log("-- 22.1: mxu_step_route / ntru_step_route on the card")
    routes = {"mxu": 0, "fused": 0, "staged": 0}
    levels = list(range(1, 9)) + [12, 20, 32]
    for log_n in range(8, TOP_LOG_N + 1):
        for kp in (1, 2, 4):
            for k1 in range(1, 5):
                for dp in (1, 2):
                    got = [cmux_mxu.mxu_step_route(kp, k1, level, log_n, dp) for level in levels]
                    held = [r == "mxu" for r in got]
                    # kernel A's plan grows with L; it holds nothing past log_n 12
                    if held != sorted(held, reverse=True) or (log_n > 12 and any(held)):
                        raise AssertionError(f"mxu_step_route {(kp, k1, log_n, dp)}: {got}")
                    for level, r in zip(levels, got):
                        if r != "mxu" and r != cmux_fused.step_route(kp, k1, level, log_n):
                            raise AssertionError(f"mxu_step_route {(kp, k1, level, log_n, dp)}")
                        routes[r] += 1
    from primus_fhe_tpu_torch.ops.ntt_columns import MAX_LOG_N as CARD_MAX_LOG_N

    for bad in ((2, 2, 3, CARD_MAX_LOG_N + 1, 1), (5, 2, 3, 13, 1), (2, 2, 33, 13, 1),
                (2, 2, 3, 11, 3)):
        try:
            cmux_mxu.mxu_step_route(*bad)
        except ValueError:
            continue
        raise AssertionError(f"mxu_step_route took {bad}")
    named = {"BOOLEAN_128": cmux_mxu.mxu_step_route(2, 2, 3, 11, 1),
             "BOOLEAN_128 at N = 4096": cmux_mxu.mxu_step_route(2, 2, 3, 12, 1),
             "BOOLEAN_128 at N = 2^15": cmux_mxu.mxu_step_route(2, 2, 3, 15, 1),
             "NTRU_128": ntru_cmux_mxu.ntru_step_route(6, 10, 1),
             "NTRU_128 at N = 4096": ntru_cmux_mxu.ntru_step_route(6, 12, 1),
             "NTRU_128 at N = 2^13": ntru_cmux_mxu.ntru_step_route(6, 13, 1)}
    if list(named.values()) != ["mxu", "fused", "staged", "mxu", "staged", "staged"]:
        raise AssertionError(f"routes of the named shapes: {named}")
    log(f"routes over {(TOP_LOG_N - 7) * 3 * 4 * 2 * len(levels)} shapes (log_n 8-{TOP_LOG_N}, "
        f"kp 1, 2, 4, k1 1-4, L 1-8, 12, 20, 32, 1-2 digit planes): {routes}; {named}; log_n "
        f"{CARD_MAX_LOG_N + 1}, kp 5, L 33, 3 planes refused")
    for log_n in (15, 16):
        conv = TorusConvolver32(log_n, 56)
        t0 = time.perf_counter()
        cmux_mxu.CmuxMxuPlan(log_n, tuple(conv.primes)).fold_inverse_scale(conv.product)
        log(f"plan_for's work at N = 2^{log_n} (CmuxMxuPlan + fold_inverse_scale, kp 2): "
            f"{time.perf_counter() - t0:.4f} s host (no int8 plane matrix built)")

    # -- 22.2: kernel C's route at log_n 13-17 -------------------------------------
    log(f"-- 22.2: mxu8_forward32 at log_n 13-{TOP_LOG_N} (kernel 1 at out_factor 1), kp 2, 16 "
        "rows")
    g = torch.Generator(device=dev).manual_seed(SEED + 22)
    for log_n in range(13, TOP_LOG_N + 1):
        conv = TorusConvolver32(log_n, 56)
        plan = cmux_mxu.CmuxMxuPlan(log_n, tuple(conv.primes))
        q = torch.tensor(conv.primes, dtype=torch.int64, device=dev).reshape(-1, 1, 1)
        x = torch.randint(0, 1 << 40, (2, 16, 1 << log_n), generator=g, device=dev) % q
        before = (ntt_mxu8.mxu8_forward32.launches, ntt32.forward32.launches)
        got = ntt_mxu8.mxu8_forward32(plan, x)
        launched = (ntt_mxu8.mxu8_forward32.launches - before[0],
                    ntt32.forward32.launches - before[1])
        if not torch.equal(got, ntt_mxu8.mxu8_forward32_plain(plan, x)) or launched != (0, 1):
            raise AssertionError(f"mxu8_forward32 at log_n {log_n}: != plain or launches "
                                 f"{launched}")
        log(f"log_n {log_n}: bit-equal to the plain version; launches (kernel C, kernel 1) "
            f"{launched}")

    # -- 22.3: BOOLEAN_128 at N = 4096 on the MXU key ------------------------------
    wide = dataclasses.replace(P.BOOLEAN_128, log_n=MXU_WIDE_LOG_N)
    log(f"-- 22.3: make_context(BOOLEAN_128 at N = {wide.n}, bsk_kind='mxu'), NAND at batch "
        f"{BATCH} with the key switch")
    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    t0 = time.perf_counter()
    mctx = P.make_context(wide, dev, gen, bsk_kind="mxu")
    torch.cuda.synchronize()
    if mctx.bsk[1] is not None:
        raise AssertionError("the MXU pack at N = 4096 carries quotients past kernel A")
    log(f"keygen: {time.perf_counter() - t0:.3f} s; bsk values {tuple(mctx.bsk[0].shape)}, no "
        f"quotients (past kernel A), primes {mctx.conv.primes}")
    args = (mctx.conv, mctx.basis, mctx.bsk, mctx.ksk, mctx.ks_basis)
    bits_a = torch.randint(0, 2, (BATCH,), generator=gen, device=dev)
    bits_b = torch.randint(0, 2, (BATCH,), generator=gen, device=dev)
    ca, cb = mctx.encrypt(bits_a, gen), mctx.encrypt(bits_b, gen)
    want = ~(bits_a.bool() & bits_b.bool())
    reset_counts()
    res = gates.nand_gate(*args, ca, cb, wide.log_n)
    counts_m = read_counts()
    if not torch.equal(mctx.decrypt(res), want):
        raise AssertionError("NAND at N = 4096 on the MXU key: wrong truth table")
    want_m = {name: 0 for name in counts_m} | {"fused_cmux_step": wide.lwe_dim, "rotate": 1}
    log(f"NAND truth table at batch {BATCH} correct; launches of one gate: "
        f"{json.dumps(counts_m)}")
    if counts_m != want_m:
        raise AssertionError(f"NAND at N = 4096 on the MXU key: launches {counts_m}, want {want_m}")
    err = (mctx.phase(res) - torch.where(want, gates.TRUE_MU, -gates.TRUE_MU)).double()
    lat = min(wall_ms(torch, lambda: gates.nand_gate(*args, ca[:1], cb[:1], wide.log_n), 3))
    rate = min(wall_ms(torch, lambda: gates.nand_gate(*args, ca, cb, wide.log_n), 3))
    busy, rows = device_time(torch, lambda: gates.nand_gate(*args, ca, cb, wide.log_n))
    idle = "not measured" if busy is None else f"{1 - busy / rate:.3f}"
    log(f"[{smi}] NAND at N = {wide.n} on the MXU key (fused step): batch 1 {lat:.2f} ms, "
        f"batch {BATCH} {rate:.2f} ms ({BATCH * 1e3 / rate:.1f} gates/s) (host clock, "
        f"synchronised, least of 3); device busy {busy if busy is None else round(busy, 3)} ms "
        f"of the batch-{BATCH} gate -> idle share {idle}; output phase std {err.std().item():.1f} "
        f"(2^{math.log2(err.std().item()):.2f}) against the 2^29 decision threshold; top rows: "
        + "; ".join(f"{key_[:40]} x{c} ({ms_:.2f} ms)" for ms_, c, key_ in rows[:4]))
    del mctx, args, ca, cb, res

    # -- 22.4: 21.3's programmable bootstrap on the MXU key ------------------------
    counts_p = mxu_key_bootstrap(torch, dev, smi, "22.4", dataclasses.replace(
        P.BOOLEAN_128, log_n=WIDE_LOG_N), SEED + 23, pbs_21, 3, reset_counts, read_counts)

    # -- 22.5: NTRU at N = 2^13 on kernels I, 1 and J ------------------------------
    pw = dataclasses.replace(P.NTRU_128, log_n=NTRU_WIDE_LOG_N)
    log(f"-- 22.5: NTRU_128's gadget, n_lwe and sigmas at N = 2^{NTRU_WIDE_LOG_N} (q = "
        f"{pw.q}): make_ntru_keys, kernels I and J, the staged rotation")
    gen_n = torch.Generator(device=dev).manual_seed(SEED + 25)
    t0 = time.perf_counter()
    keys = P.make_ntru_keys(pw, dev, gen_n)
    torch.cuda.synchronize()
    kctx, qn, nn = keys.ctx, keys.ctx.q_int, keys.ctx.n
    level = kctx.basis.decompose_length
    log(f"make_ntru_keys: {time.perf_counter() - t0:.3f} s; evk {tuple(keys.evk.shape)}, evk_mxu "
        f"{tuple(keys.evk_mxu[0].shape)} x 2 (kernel 1 prepared it), ksk {tuple(keys.ksk.shape)}")
    evk_row = keys.evk_mxu[0][0].reshape(level, nn)
    if not torch.equal(evk_row, keys.evk[0]):
        raise AssertionError("the MXU evk's values differ from the NTT evk's")
    for bsz in (1, NTRU_WIDE_BATCH):
        acc = torch.randint(0, qn, (bsz, nn), generator=gen_n, device=dev)
        acc[0, :3] = torch.tensor([0, qn - 1, kctx.basis.wrap_threshold or 1])
        acc32 = acc.to(torch.int32)
        deg = torch.randint(0, 2 * nn, (bsz,), generator=gen_n, device=dev, dtype=torch.int32)
        compare_kernel(torch, table, "ntru_digits", bsz,
                       lambda: ntru_cmux_mxu.ntru_digits(kctx.basis, acc),
                       lambda: ntru_cmux_mxu.ntru_digits(kctx.basis, acc32),
                       lambda: ntru_cmux_mxu.ntru_digits_plain(kctx.basis, acc),
                       bound(4 * (bsz * nn + level * bsz * nn)))
        f = ntru_cmux_mxu.ntru_stage1(kctx.ntt, kctx.basis, acc)
        f32 = f.to(torch.int32)
        evk32 = evk_row.to(torch.int32)
        # J as the staged step runs it: the accumulator and, over f, the
        # next step's digits, both against the plain version
        want_j, want_dig = ntru_cmux_mxu.ntru_stage2_plain(kctx.ntt, f, evk_row, acc, deg,
                                                           kctx.basis)
        f_dig, acc_in = f32.clone(), acc32.clone()
        out_j = ntru_cmux_mxu.ntru_stage2(kctx.ntt, f_dig, evk32, acc_in, deg, out=acc_in,
                                          basis=kctx.basis)
        if not (torch.equal(out_j.to(torch.int64), want_j)
                and torch.equal(f_dig.to(torch.int64), want_dig)):
            raise AssertionError(f"kernel J with digits at batch {bsz}: != plain")
        f_run = f32.clone()  # the timed calls write their digits over it
        compare_kernel(torch, table, "ntru_stage2", bsz,
                       lambda: ntru_cmux_mxu.ntru_stage2(kctx.ntt, f32.clone(), evk32, acc32, deg,
                                                         basis=kctx.basis).to(torch.int64),
                       lambda: ntru_cmux_mxu.ntru_stage2(kctx.ntt, f_run, evk32, acc32, deg,
                                                         basis=kctx.basis),
                       lambda: ntru_cmux_mxu.ntru_stage2_plain(kctx.ntt, f, evk_row, acc, deg),
                       ntru_stage2_bound(bsz, level, nn))
        compare_kernel(torch, table, "ntru_stage2@nodigits", bsz,
                       lambda: ntru_cmux_mxu.ntru_stage2(kctx.ntt, f, evk_row, acc, deg),
                       lambda: ntru_cmux_mxu.ntru_stage2(kctx.ntt, f32, evk32, acc32, deg),
                       lambda: ntru_cmux_mxu.ntru_stage2_plain(kctx.ntt, f, evk_row, acc, deg),
                       ntru_stage2_bound(bsz, level, nn, digits=False))
        step = ntru_cmux_mxu.NtruStepPlan(kctx, dev)
        if step.route != "staged":
            raise AssertionError(f"NTRU at N = 2^{NTRU_WIDE_LOG_N}: route {step.route}")
        kv32 = keys.evk_mxu[0][:NTRU_CHECK_STEPS].to(torch.int32).contiguous()
        nplan = ntru_cmux_mxu.get_ntru_plan(NTRU_WIDE_LOG_N, qn)
        plain_acc, run = acc.clone(), acc32.clone()
        sw = torch.randint(0, 2 * nn, (NTRU_CHECK_STEPS, bsz), generator=gen_n, device=dev,
                           dtype=torch.int32)
        for i in range(NTRU_CHECK_STEPS):
            plain_acc = ntru_cmux_mxu.ntru_cmux_step_plain(nplan, kctx.basis, plain_acc, sw[i],
                                                           keys.evk_mxu[0][i])
            run = step(run, sw[i], kv32[i], None)
            if not torch.equal(run.to(torch.int64), plain_acc):
                raise AssertionError(f"NTRU staged step {i} at batch {bsz} != plain")
        step_ms = kernel_device_ms(torch, lambda: step(run, sw[0], kv32[0], None))
        j_grid = ntru_cmux_mxu.launch_grid(NTRU_WIDE_LOG_N, bsz)
        if j_grid[0] < 2:  # a row over a cluster of slices, one block a row before
            raise AssertionError(f"kernel J at N = 2^{NTRU_WIDE_LOG_N}, batch {bsz}: {j_grid}")
        log(f"[{smi}] the first {NTRU_CHECK_STEPS} staged steps at batch {bsz} bit-equal to the "
            f"plain step on the card; one step after the first {step_ms:.4f} device ms (kernel 1 "
            f"and J with digits {table['ntru_stage2'][bsz][3]:.4f}; J without them "
            f"{table['ntru_stage2@nodigits'][bsz][3]:.4f}, I {table['ntru_digits'][bsz][3]:.4f} "
            f"once a rotation); J's launch (blocks a row, threads, shared bytes, clusters held) "
            f"{j_grid}")
    nt = (qn - 1) // 8
    xa_bits = torch.tensor([1, 0], device=dev)
    xb_bits = torch.tensor([1, 1], device=dev)
    xa, xb = keys.encrypt(xa_bits, gen_n), keys.encrypt(xb_bits, gen_n)
    nand_const = torch.zeros(pw.lwe_dim + 1, dtype=torch.int64, device=dev)
    nand_const[-1] = 5 * nt % qn
    sw = nbr.modulus_switch_q(sub32(add32(xa, xb, qn), nand_const, qn), kctx, pw.log_n + 1)
    tpn = nbr.ntru_test_polynomial(nn, qn, nt, dev)
    reset_counts()
    rot = nbr.ntru_blind_rotate(kctx, keys.evk_mxu, sw, tpn)
    counts_n = read_counts()
    want_n = {name: 0 for name in counts_n} | {  # I for the first step only
        "ntru_digits": 1, "forward32": pw.lwe_dim, "ntru_stage2": pw.lwe_dim}
    log(f"launches of one rotation at batch 2: {json.dumps(counts_n)}")
    if counts_n != want_n:
        raise AssertionError(f"NTRU staged rotation: launches {counts_n}, want {want_n}")
    t0 = time.perf_counter()
    rot_cpu = nbr.ntru_blind_rotate(kctx, tuple(x.cpu() for x in keys.evk_mxu), sw.cpu(),
                                    tpn.cpu())
    cpu_s = time.perf_counter() - t0
    if not torch.equal(rot.cpu(), rot_cpu):
        raise AssertionError("the NTRU staged rotation on the card differs from the CPU's")
    log(f"the {pw.lwe_dim}-step rotation at batch 2 equals the CPU's plain rotation word for "
        f"word ({rot.numel()} words; the CPU took {cpu_s:.2f} s)")
    a_vec = nbr.extract_lwe_ntru(rot, qn)
    out_s = nbr.ntru_key_switch(kctx, torch.cat([neg32(a_vec, qn), torch.zeros_like(a_vec[..., :1])],
                                                dim=-1), keys.ksk, keys.ks_basis)
    want_bits = ~(xa_bits.bool() & xb_bits.bool())
    nerr = (keys.phase(out_s) - torch.where(want_bits, nt, -nt)).double()
    log(f"NAND through the rotation and the key switch: decrypted "
        f"{keys.decrypt(out_s).int().tolist()}, NAND {want_bits.int().tolist()}; phase error "
        f"{nerr.tolist()} (std {nerr.std().item():.1f}) against the decision margin q/8 = "
        f"{qn / 8:.0f}; noise.py has no NTRU model, so the truth table is not checked here")
    big = keys.encrypt(torch.randint(0, 2, (NTRU_WIDE_BATCH,), generator=gen_n, device=dev), gen_n)
    big_sw = nbr.modulus_switch_q(big, kctx, pw.log_n + 1)
    lat = min(wall_ms(torch, lambda: nbr.ntru_blind_rotate(kctx, keys.evk_mxu, big_sw[:1], tpn),
                      3))
    rate = min(wall_ms(torch, lambda: nbr.ntru_blind_rotate(kctx, keys.evk_mxu, big_sw, tpn), 3))
    busy, rows = device_time(torch, lambda: nbr.ntru_blind_rotate(kctx, keys.evk_mxu, big_sw, tpn))
    idle = "not measured" if busy is None else f"{1 - busy / rate:.3f}"
    log(f"[{smi}] NTRU staged rotation at N = 2^{NTRU_WIDE_LOG_N} ({pw.lwe_dim} steps): batch 1 "
        f"{lat:.2f} ms, batch {NTRU_WIDE_BATCH} {rate:.2f} ms (host clock, synchronised, least "
        f"of 3); device busy {busy if busy is None else round(busy, 3)} ms of the batch-"
        f"{NTRU_WIDE_BATCH} run -> idle share {idle}; top rows: "
        + "; ".join(f"{key_[:40]} x{c} ({ms_:.2f} ms)" for ms_, c, key_ in rows[:4]))
    del keys, rot, rot_cpu

    # -- 22.6: NTRU at N = 2^17 on kernels I, 1 and J ------------------------------
    counts_top = ntru_top(torch, dev, table, smi, reset_counts, read_counts)

    # -- 22.7: BOOLEAN_128 and NTRU_128 stay on kernels A and B --------------------
    p = P.BOOLEAN_128
    gen = torch.Generator(device=dev).manual_seed(SEED + 26)
    bctx = P.make_context(p, dev, gen, bsk_kind="mxu")
    c1, c2 = bctx.encrypt(torch.tensor([0, 1], device=dev), gen), bctx.encrypt(
        torch.tensor([1, 1], device=dev), gen)
    reset_counts()
    ok_b = torch.equal(bctx.decrypt(gates.nand_gate(bctx.conv, bctx.basis, bctx.bsk, bctx.ksk,
                                                    bctx.ks_basis, c1, c2, p.log_n)),
                       torch.tensor([True, False], device=dev))
    cb_ = read_counts()
    keys = P.make_ntru_keys(P.NTRU_128, dev, gen)
    n1, n2 = keys.encrypt([0, 1], gen), keys.encrypt([1, 1], gen)
    reset_counts()
    ok_n = torch.equal(keys.decrypt(ntru_gates.ntru_nand(keys.ctx, keys.evk_mxu, keys.ksk,
                                                         keys.ks_basis, n1, n2)),
                       torch.tensor([True, False], device=dev))
    cn_ = read_counts()
    seen = (cb_["mxu_cmux_step"], cn_["ntru_cmux_step"], cb_["ntru_digits"] + cn_["ntru_digits"],
            cb_["ntru_stage2"] + cn_["ntru_stage2"], cb_["cmux_stage2"] + cn_["cmux_stage2"])
    if not (ok_b and ok_n) or seen != (p.lwe_dim, P.NTRU_128.lwe_dim, 0, 0, 0):
        raise AssertionError(f"22.7: NAND right {ok_b, ok_n}; launches A, B, I, J, H {seen}")
    log(f"-- 22.7: a BOOLEAN_128 NAND on the MXU key and an NTRU_128 NAND on the MXU evk: "
        f"right; kernel A {seen[0]}, kernel B {seen[1]}, I {seen[2]}, J {seen[3]}, H {seen[4]} "
        f"launches")
    return {"mxu": counts_p, "mxu4096": counts_m, "ntru": counts_n, "ntru_top": counts_top}


MODULI_COUNTS = (5, 6)  # phase 23: DCRT bases past the four moduli one u64 launch takes
MODULI_STEPS = 8
MODULI_BATCH = 2


def phase23_dcrt_moduli(torch, dev, table) -> dict:
    """Phase 23: the DCRT layer at N = 4096 over 5 and 6 moduli of 50 bits
    (``ntt_prime_chain(50, 12, count)``, the first two phase 10's) with
    ``bench_dcrt.py``'s gadget (2^25, L = the product's bits / 25): the
    four u64 transforms at the rotation's shapes against their plain
    versions (two launches a call: moduli 0-3, then the rest), and
    ``MODULI_STEPS`` rotation steps at batch ``MODULI_BATCH`` on both routes
    against the CPU's plain rotation, with exact launch counts.  Returns
    each count's launches of the rotation on its route."""
    from primus_fhe_tpu_torch.boot import dcrt_blind_rotate as dbr
    from primus_fhe_tpu_torch.decompose import BigUintApproxSignedBasis
    from primus_fhe_tpu_torch.ops import ntt64, ntt_mxu8
    from primus_fhe_tpu_torch.rns import RNSBase64
    from primus_fhe_tpu_torch.transforms import dcrt as td
    from primus_fhe_tpu_torch.utils.primes import ntt_prime_chain

    n, k1, steps, bsz = 1 << DCRT_LOG_N, 2, MODULI_STEPS, MODULI_BATCH
    kernels = {"ntt64_forward": ntt64.ntt64_forward, "ntt64_inverse": ntt64.ntt64_inverse,
               "mxu8_forward64": ntt_mxu8.mxu8_forward64,
               "mxu8_inverse64": ntt_mxu8.mxu8_inverse64}
    own = {"auto": ("mxu8_forward64", "mxu8_inverse64"),
           "butterfly": ("ntt64_forward", "ntt64_inverse")}
    counts = {}
    for count in MODULI_COUNTS:
        moduli = ntt_prime_chain(50, DCRT_LOG_N, count)
        base = RNSBase64(moduli)
        basis = BigUintApproxSignedBasis(base, DCRT_LOG_BASIS)
        level = basis.decompose_length
        plan = td.build_dcrt_plan64(DCRT_LOG_N, moduli)
        groups = len(ntt64.mod_groups(count))
        log(f"-- 23.{count}: {count} moduli {moduli} (Q = 2^{base.q_product.bit_length() - 1}.x, "
            f"{base.big_len} limbs), L = {level} x 2^{DCRT_LOG_BASIS}, route 'auto' = "
            f"{td.resolve_route(plan)!r}, {groups} launches a transform")
        g = torch.Generator(device=dev).manual_seed(SEED + 30 + count)

        def residues(*shape):
            return torch.stack([torch.randint(0, q, shape, generator=g, device=dev)
                                for q in moduli])

        f_in, i_in = residues(k1 * level * bsz, n), residues(k1 * bsz, n)
        rf, ri = f_in.numel() // n, i_in.numel() // n
        for name, kern, plain, x, r in (
                ("ntt64_forward", lambda x: ntt64.ntt64_forward(plan.ntt, x),
                 lambda x: ntt64.ntt64_forward_plain(plan.ntt, x), f_in, rf),
                ("ntt64_inverse", lambda x: ntt64.ntt64_inverse(plan.ntt, x),
                 lambda x: ntt64.ntt64_inverse_plain(plan.ntt, x), i_in, ri),
                ("mxu8_forward64", lambda x: ntt_mxu8.mxu8_forward64(plan.mxu, x),
                 lambda x: ntt_mxu8.mxu8_forward64_plain(plan.mxu, x), f_in, rf),
                ("mxu8_inverse64", lambda x: ntt_mxu8.mxu8_inverse64(plan.mxu, x),
                 lambda x: ntt_mxu8.mxu8_inverse64_plain(plan.mxu, x), i_in, ri)):
            compare_kernel64(torch, table, f"{name}@m{count}", bsz, lambda: kern(x),
                             lambda: plain(x), bound(16 * r * n, muls32=ntt_muls(r, n, u64=True)))
            before = kernels[name].launches
            kern(x)
            if kernels[name].launches - before != groups:
                raise AssertionError(f"{name} over {count} moduli: "
                                     f"{kernels[name].launches - before} launches, want {groups}")
        bsk = residues(steps, k1, level, k1, n).movedim(0, 3).contiguous()
        accs = residues(bsz, k1, n).transpose(0, 1).contiguous()
        lwe = torch.randint(0, 2 * n, (bsz, steps + 1), generator=g, device=dev)
        outs = {}
        for route in ("auto", "butterfly"):
            for fn in kernels.values():
                fn.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[route] = dbr.dcrt_blind_rotate_batched(plan, basis, base, bsk, lwe, accs,
                                                        route=route)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            got = {name: fn.launches for name, fn in kernels.items()}
            want = {name: (groups * steps if name in own[route] else 0) for name in kernels}
            if got != want:
                raise AssertionError(f"[{count} moduli, {route}] launches {got}, want {want}")
            counts[count] = counts.get(count, {}) | {name: got[name] for name in own[route]}
            log(f"[{count} moduli, {route}] {steps} steps at batch {bsz}: launches "
                f"{json.dumps(got)} ({groups} a transform call); {secs * 1e3:.1f} ms (host "
                f"clock, first call)")
        t0 = time.perf_counter()
        cpu = dbr.dcrt_blind_rotate_batched(plan, basis, base, bsk.cpu(), lwe.cpu(), accs.cpu())
        cpu_s = time.perf_counter() - t0
        if not (torch.equal(outs["auto"], outs["butterfly"])
                and torch.equal(outs["auto"].cpu(), cpu)):
            raise AssertionError(f"[{count} moduli] the routes and the CPU's rotation differ")
        log(f"[{count} moduli] both routes and the CPU's plain rotation: the same "
            f"{cpu.numel()} words ({cpu_s:.2f} s on the cpu)")
    return counts


ROW9_WIDE_LOG_N = (13, 14, 15, 16, 17)  # 23.7: row 9's functions on row 10's passes
# rows a modulus: the forward and E at 16 (phase 10's batch-1 forward), the inverse and D at 4
ROW9_ROWS = (16, 4)
CLUSTER_LOG_N = (16, 17)  # 23.7: row 10 too, and 5-6 moduli, where a row spans 4 and 8 blocks
ROW9_DCRT_LOG_N = (13, 16)  # 23.8: the DCRT rotation at N = 8192 and 65536 on route "mxu8"
ROW9_DCRT_STEPS = 4
RT_WIDE_LOG_N = (16, 17)  # 23.9: kernel E on bench.py's 512 rows at these rings


def phase23_row9_wide(torch, dev, table, wide=ROW9_WIDE_LOG_N, cluster=CLUSTER_LOG_N,
                      dcrt=ROW9_DCRT_LOG_N, rt_log_n=RT_WIDE_LOG_N, moduli_counts=MODULI_COUNTS,
                      step="23") -> dict:
    """23.7: row 9's four u64 functions (``mxu8_forward64``,
    ``mxu8_inverse64``, D and E) at log_n 13-17 over two 50-bit moduli, any
    u64 words in, against their plain versions (one launch a call, on row
    10's passes: ``csrc/ntt64.cu``, a row over a cluster at 15-17), timed
    (tags "@log13" ..); at 16-17 row 10's forward and inverse too, row 12
    (forward and inverse on a residue shard's tables, tags "@shard16",
    "@shard17"), and all six over 5 and 6 moduli (two launches a call); 23.8
    ``ROW9_DCRT_STEPS`` DCRT rotation steps at N = 8192 and 65536, batch 2,
    on route ``"mxu8"`` against route ``"butterfly"`` and the CPU; 23.9
    kernel E on ``bench.py``'s 512 rows at n = 2^16 and 2^17 (tags "@rt16",
    "@rt17").  Returns the rotations' launches on route "mxu8", by N.
    Phase 24 runs it past 2^17 (``wide``, ``cluster``, ``dcrt``, ``rt_log_n`` its
    rings, no ``moduli_counts``): there every call also launches the
    four-step's column kernel (forward64 and E before the sub-row launch,
    inverse64, D and E after it), counted and asserted too, and the u64
    column kernels are held to their plain versions (tags "@fs18u64" ..);
    past 2^18, and for E at 512 rows past 2^17, the plain versions are
    timed on their checking run alone."""
    from primus_fhe_tpu_torch.ops import build, ntt64, ntt_columns, ntt_mxu8, ntt_mxu8_dyn
    from primus_fhe_tpu_torch.transforms import dcrt as td
    from primus_fhe_tpu_torch.utils.primes import next_ntt_prime, ntt_prime_chain

    g = torch.Generator(device=dev).manual_seed(SEED + 37)
    names = ("mxu8_forward64", "mxu8_inverse64", "mxu8_inverse64_mul", "mxu8_roundtrip64_mul")
    fns = {name: getattr(ntt_mxu8, name) for name in names}
    fns |= {"ntt64_forward": ntt64.ntt64_forward, "ntt64_inverse": ntt64.ntt64_inverse}

    def calls(tabs, x, mt, moduli):
        """name -> (kernel, plain, keyed) of the six u64 wrappers on ``x``."""
        out = {name: (lambda f=fns[name], a=a: f(tabs, x, *a),
                      lambda name=name, a=a: getattr(ntt_mxu8, name + "_plain")(tabs, x, *a),
                      bool(a))
               for name, a in zip(names, ((), (), (mt,), (mt,)))}
        xr = torch.stack([x[i] % q for i, q in enumerate(moduli)])  # row 10's inputs: < 4q
        out["ntt64_forward"] = (lambda: ntt64.ntt64_forward(tabs.ntt, xr, 4),
                                lambda: ntt64.ntt64_forward_plain(tabs.ntt, xr, 4), False)
        out["ntt64_inverse"] = (lambda: ntt64.ntt64_inverse(tabs.ntt, xr),
                                lambda: ntt64.ntt64_inverse_plain(tabs.ntt, xr), False)
        return out

    cols = (ntt_columns.columns_forward, ntt_columns.columns_inverse)
    want_cols = {"mxu8_forward64": (1, 0), "mxu8_inverse64": (0, 1), "mxu8_inverse64_mul": (0, 1),
                 "mxu8_roundtrip64_mul": (1, 1), "ntt64_forward": (1, 0), "ntt64_inverse": (0, 1)}
    for log_n in wide:
        n = 1 << log_n
        four = ntt_columns.four_step(log_n)
        moduli = ntt_prime_chain(50, log_n, 2)
        plan = td.build_dcrt_plan64(log_n, moduli)
        tabs, once = plan.mxu, log_n > FS_PBS_LOG_N
        log(f"-- {step}.7: row 9 at log_n {log_n} (A = {tabs.A}, B = {tabs.B} as the JAX plan; a row "
            f"over {1 << max(0, log_n - 14)} block(s)), moduli {moduli}")
        key = torch.stack([torch.randint(0, q, (n,), generator=g, device=dev) for q in moduli])
        mt = tabs.mul_table(key)
        timed = names + (("ntt64_forward", "ntt64_inverse") if log_n in cluster else ())
        for name in timed:
            rows = ROW9_ROWS[0] if name in ("mxu8_forward64", "mxu8_roundtrip64_mul",
                                            "ntt64_forward") else ROW9_ROWS[1]
            x = torch.randint(-(1 << 63), (1 << 63) - 1, (len(moduli), rows, n), generator=g,
                              device=dev)
            kern, plain, keyed = calls(tabs, x, mt, moduli)[name]
            rt = name == "mxu8_roundtrip64_mul"
            nbytes = 16 * len(moduli) * rows * n + (16 * len(moduli) * n if keyed else 0)
            b = bound(nbytes, muls32=ntt_muls(len(moduli) * rows, n, u64=True) * (2 if rt else 1))
            compare_kernel64(torch, table, f"{name}@log{log_n}", rows, kern, plain, b, once)
            before = fns[name].launches
            cols0 = tuple(fn.launches for fn in cols)
            kern()
            cols1 = tuple(b - a for a, b in zip(cols0, (fn.launches for fn in cols)))
            if fns[name].launches - before != 1 or cols1 != (want_cols[name] if four else (0, 0)):
                raise AssertionError(f"{name} at log_n {log_n}: {fns[name].launches - before} "
                                     f"launches, column launches {cols1}")
        if log_n > ntt_mxu8.MXU_LOG_N[1] and tabs._plans is not None:
            raise AssertionError(f"row 9 at log_n {log_n} built byte-plane plans it never reads")
        log(f"log_n {log_n}: {len(timed)} wrappers bit-equal to their plain versions, one launch "
            f"each; kernel E's tile at {ROW9_ROWS[0]} rows: "
            f"{ntt_mxu8.roundtrip_tile(tabs, ROW9_ROWS[0])}")
        if four:  # the u64 column kernels alone, on the forward's and the inverse's rows
            cq = torch.tensor(moduli, dtype=torch.int64, device=dev).reshape(-1, 1, 1)
            bt, pack = tabs.ntt.kernel_tables(dev), build.ptr(tabs.ntt.mod_pack)
            plans = tabs.ntt.plans_on(dev)
            for inverse, rows in ((False, ROW9_ROWS[0]), (True, ROW9_ROWS[1])):
                x = torch.randint(-(1 << 63), (1 << 63) - 1, (len(moduli), rows, n), generator=g,
                                  device=dev)
                if inverse:
                    x = x.abs() % (2 * cq)  # the sub-row launch's lazy words

                def col(x=x, inverse=inverse, rows=rows):
                    out = torch.empty_like(x)
                    if inverse:
                        ntt_columns.columns_inverse(64, x, out, bt[2], bt[3], pack, len(moduli),
                                                    rows, log_n)
                    else:
                        ntt_columns.columns_forward(64, x, out, bt[0], bt[1], pack, len(moduli),
                                                    rows, log_n, any_in=True)
                    return out

                def plain(x=x, inverse=inverse):
                    if inverse:
                        return ntt_columns.columns_inverse_plain(plans, x, 14, 64)
                    return ntt_columns.columns_forward_plain(plans, x, 14, 64, any_in=True)

                name = "ntt_columns_inverse" if inverse else "ntt_columns_forward"
                compare_kernel64(torch, table, f"{name}@fs{log_n}u64", rows, col, plain,
                                 bound(16 * len(moduli) * rows * n,
                                       muls32=10 * len(moduli) * rows * (n // 2) * (log_n - 14)),
                                 once)
        if log_n not in cluster:
            continue
        # row 12: the same kernels on a residue shard's tables (one modulus), at
        # phase 14's shard shapes (8 ciphertexts, k1 2, L 4: 64 rows forward, 16 back)
        sp = ntt_mxu8_dyn.stack_dyn_plans(plan, 2)[0]
        for name, rows in (("mxu8_forward64", 64), ("mxu8_inverse64", 16)):
            x = torch.randint(0, sp.moduli[0], (1, rows, n), generator=g, device=dev)
            compare_kernel64(torch, table, f"{name}@shard{log_n}", rows,
                             lambda f=fns[name], v=x: f(sp.mxu, v),
                             lambda name=name, v=x: getattr(ntt_mxu8, name + "_plain")(sp.mxu, v),
                             bound(16 * rows * n, muls32=ntt_muls(rows, n, u64=True)), once)
            before = fns[name].launches
            cols0 = tuple(fn.launches for fn in cols)
            fns[name](sp.mxu, x)
            cols1 = tuple(b - a for a, b in zip(cols0, (fn.launches for fn in cols)))
            if fns[name].launches - before != 1 or cols1 != (want_cols[name] if four else (0, 0)):
                raise AssertionError(f"row 12 {name} at log_n {log_n}: launches "
                                     f"{fns[name].launches - before}, columns {cols1}")
        for count in moduli_counts:
            moduli = ntt_prime_chain(50, log_n, count)
            moduli[-1] = next_ntt_prime(62, log_n) if count == 6 else moduli[-1]
            tabs = ntt_mxu8.Mxu8Tables64(ntt64.NttTables64(log_n, moduli))
            mt = tabs.mul_table(torch.stack([torch.randint(0, q, (n,), generator=g, device=dev)
                                             for q in moduli]))
            x = torch.randint(-(1 << 63), (1 << 63) - 1, (count, 2, n), generator=g, device=dev)
            for name, (kern, plain, _) in calls(tabs, x, mt, moduli).items():
                before = fns[name].launches
                if not torch.equal(kern(), plain()):
                    raise AssertionError(f"{name} at log_n {log_n} over {count} moduli != plain")
                if fns[name].launches - before != 2:
                    raise AssertionError(f"{name} at log_n {log_n} over {count} moduli: "
                                         f"{fns[name].launches - before} launches, want 2")
            log(f"log_n {log_n}, {count} moduli{' (the last of 62 bits)' if count == 6 else ''}, "
                f"2 rows: the six u64 wrappers bit-equal to their plain versions, two launches "
                f"each")

    counts = {}
    for log_n in dcrt:
        counts[1 << log_n] = dcrt_row9_steps(torch, dev, g, log_n, step)

    for log_n in rt_log_n:
        n = 1 << log_n
        q = next_ntt_prime(50, log_n)
        tabs = ntt_mxu8.Mxu8Tables64(ntt64.NttTables64(log_n, [q]))
        log(f"-- {step}.9: kernel E on bench.py's {RT_BATCH} rows at n = 2^{log_n}, q = {q} (50 bits; "
            f"bench.py's own q is 1 mod 2^14 only)")
        x = torch.randint(0, q, (1, RT_BATCH, n), generator=g, device=dev)
        mt = tabs.mul_table(torch.randint(0, q, (1, n), generator=g, device=dev))
        words = RT_BATCH * n
        compare_kernel64(torch, table, f"mxu8_roundtrip64_mul@rt{log_n}", RT_BATCH,
                         lambda: ntt_mxu8.mxu8_roundtrip64_mul(tabs, x, mt),
                         lambda: ntt_mxu8.mxu8_roundtrip64_mul_plain(tabs, x, mt),
                         bound(8 * (2 * words + 2 * n),
                               muls32=2 * ntt_muls(RT_BATCH, n, u64=True) + 10 * words),
                         log_n > TOP_LOG_N)
        e_row = table[f"mxu8_roundtrip64_mul@rt{log_n}"][RT_BATCH]
        modmuls = RT_BATCH * (n * log_n + n)
        log(f"kernel E at n = 2^{log_n} x {RT_BATCH}: device {e_row[3]:.4f} ms, share of the "
            f"bound {e_row[4][0] / e_row[3]:.4f}; {modmuls / (e_row[3] / 1e3):.4e} modmul/s "
            f"(bench.py's metric)")
        del x
    return counts


DCRT_CPU_MAX_LOG_N = 17  # 23.8 / 24.7: past it the plain rotation on the card stands in for the CPU's


@contextlib.contextmanager
def plain_dcrt_transforms():
    """The DCRT layer's butterfly transforms on their plain versions, on any
    device, while the block runs (route ``"butterfly"`` then launches no
    kernel)."""
    from primus_fhe_tpu_torch.ops import ntt64
    from primus_fhe_tpu_torch.transforms import dcrt as td

    saved = td.ntt64_forward, td.ntt64_inverse
    td.ntt64_forward, td.ntt64_inverse = ntt64.ntt64_forward_plain, ntt64.ntt64_inverse_plain
    try:
        yield
    finally:
        td.ntt64_forward, td.ntt64_inverse = saved


def dcrt_row9_steps(torch, dev, g, log_n, step="23") -> dict:
    """23.8: ``ROW9_DCRT_STEPS`` DCRT rotation steps at N = 2^log_n, batch
    2, two 50-bit moduli, on route ``"mxu8"`` (row 9 on row 10's passes)
    against route ``"butterfly"`` and the CPU's plain rotation.  Returns
    route "mxu8"'s launches (past 2^17 the column kernels' too; there the
    plain rotation runs on the card, not the CPU, where it would take
    minutes)."""
    from primus_fhe_tpu_torch.boot import dcrt_blind_rotate as dbr
    from primus_fhe_tpu_torch.ops import ntt_columns
    from primus_fhe_tpu_torch.decompose import BigUintApproxSignedBasis
    from primus_fhe_tpu_torch.ops import ntt64, ntt_mxu8
    from primus_fhe_tpu_torch.rns import RNSBase64
    from primus_fhe_tpu_torch.transforms import dcrt as td
    from primus_fhe_tpu_torch.utils.primes import ntt_prime_chain

    steps, bsz, k1 = ROW9_DCRT_STEPS, 2, 2
    n = 1 << log_n
    moduli = ntt_prime_chain(50, log_n, 2)
    base = RNSBase64(moduli)
    basis = BigUintApproxSignedBasis(base, DCRT_LOG_BASIS)
    level = basis.decompose_length
    plan = td.build_dcrt_plan64(log_n, moduli)
    log(f"-- {step}.8: {steps} DCRT rotation steps at N = {n}, moduli {moduli}, L = {level} x "
        f"2^{DCRT_LOG_BASIS}, batch {bsz}: route 'mxu8' against 'butterfly' (route 'auto' = "
        f"{td.resolve_route(plan)!r})")

    def residues(*shape):
        return torch.stack([torch.randint(0, q, shape, generator=g, device=dev) for q in moduli])

    bsk = residues(steps, k1, level, k1, n).movedim(0, 3).contiguous()
    accs = residues(bsz, k1, n).transpose(0, 1).contiguous()
    lwe = torch.randint(0, 2 * n, (bsz, steps + 1), generator=g, device=dev)
    counted = {"mxu8_forward64": ntt_mxu8.mxu8_forward64,
               "mxu8_inverse64": ntt_mxu8.mxu8_inverse64,
               "ntt64_forward": ntt64.ntt64_forward, "ntt64_inverse": ntt64.ntt64_inverse,
               "columns_forward": ntt_columns.columns_forward,
               "columns_inverse": ntt_columns.columns_inverse}
    outs, counts = {}, {}
    for route in ("mxu8", "butterfly"):
        before = {k: f.launches for k, f in counted.items()}
        outs[route] = dbr.dcrt_blind_rotate_batched(plan, basis, base, bsk, lwe, accs, route=route)
        torch.cuda.synchronize()
        counts[route] = {k: f.launches - before[k] for k, f in counted.items()}
    four = steps * ntt_columns.four_step(log_n)
    want = {"mxu8_forward64": steps, "mxu8_inverse64": steps, "ntt64_forward": 0,
            "ntt64_inverse": 0, "columns_forward": four, "columns_inverse": four}
    if counts["mxu8"] != want:
        raise AssertionError(f"route mxu8 at N = {n}: launches {counts['mxu8']}, want {want}")
    t0 = time.perf_counter()
    if log_n <= DCRT_CPU_MAX_LOG_N:
        where = "on the cpu"
        cpu = dbr.dcrt_blind_rotate_batched(plan, basis, base, bsk.cpu(), lwe.cpu(), accs.cpu())
    else:
        where = "the plain versions on the card, standing in for the CPU (minutes there)"
        before = {k: f.launches for k, f in counted.items()}
        with plain_dcrt_transforms():
            cpu = dbr.dcrt_blind_rotate_batched(plan, basis, base, bsk, lwe, accs,
                                                route="butterfly").cpu()
        if {k: f.launches for k, f in counted.items()} != before:
            raise AssertionError(f"the plain rotation at N = {n} launched a kernel")
    cpu_s = time.perf_counter() - t0
    if not (torch.equal(outs["mxu8"], outs["butterfly"]) and torch.equal(outs["mxu8"].cpu(), cpu)):
        raise AssertionError(f"the DCRT rotation at N = {n}: routes mxu8 and butterfly (or the "
                             "plain rotation) differ")
    log(f"route 'mxu8': launches {json.dumps(counts['mxu8'])}; route 'butterfly': "
        f"{json.dumps(counts['butterfly'])}; both and the plain rotation give the same "
        f"{cpu.numel()} words ({cpu_s:.2f} s, {where})")
    return counts["mxu8"]


FS_LOG_N = (18, 19, 20)  # phase 24: rings past what a cluster holds, the four-step
FS_PBS_LOG_N = 18  # 24.6: the programmable bootstrap's ring (kp 3)
FS_REPS = 5  # phase 24's timing repetitions (KERNEL_REPS elsewhere): its shapes are large


def four_step_ntt32(torch, dev, table, g, residues) -> None:
    """24.1: kernels 1-2 at log_n 18-20 (the column launch, then the
    sub-row launch; the inverse mirrored), kp 2 and 3 at 1 and 16 rows,
    every out_factor and the in-place out_factor 4 against the plain
    versions, launches asserted; kp 3 at 16 rows timed, and the column
    kernels alone against their plain versions (tags "@fs18" ..; past 2^18
    the plain versions timed on their checking run alone); kernel 1 at the
    2^18 PBS's rows, in place (tag "@pbs18")."""
    from primus_fhe_tpu_torch.lattice import tfhe
    from primus_fhe_tpu_torch.numeric.limb import widen_u32
    from primus_fhe_tpu_torch.ops import build, ntt32
    from primus_fhe_tpu_torch.ops import ntt_columns as nc
    from primus_fhe_tpu_torch.transforms.torus import TorusConvolver32

    counted = (ntt32.forward32, ntt32.inverse32, nc.columns_forward, nc.columns_inverse)
    for log_n in FS_LOG_N:
        n, c, once = 1 << log_n, log_n - nc.SUB_LOG, log_n > FS_PBS_LOG_N
        for kp in (2, 3):
            tables = TorusConvolver32(log_n, 56 if kp == 2 else 60).ntt
            if len(tables.primes) != kp:
                raise AssertionError(f"log_n {log_n}: {len(tables.primes)} primes, want {kp}")
            for rows in (1, WIDE_BATCH):
                x4, x2 = residues(tables.primes, (rows, n), 4), residues(tables.primes, (rows, n), 2)
                l0 = [fn.launches for fn in counted]
                for of in (1, 4):
                    if not torch.equal(ntt32.forward32(tables, x4, of),
                                       ntt32.forward32_plain(tables, x4, of)):
                        raise AssertionError(f"forward32 log_n {log_n} kp {kp} x {rows}: != plain")
                y = x4.to(torch.int32)
                ntt32.forward32(tables, y, 4, out=y)
                if not torch.equal(widen_u32(y), ntt32.forward32_plain(tables, x4, 4)):
                    raise AssertionError(f"forward32 in place log_n {log_n} kp {kp} x {rows}")
                for of in (1, 2):
                    if not torch.equal(ntt32.inverse32(tables, x2, of),
                                       ntt32.inverse32_plain(tables, x2, of)):
                        raise AssertionError(f"inverse32 log_n {log_n} kp {kp} x {rows}: != plain")
                launched = [fn.launches - b for fn, b in zip(counted, l0)]
                if launched != [3, 2, 3, 2]:
                    raise AssertionError(f"kernels 1-2 at log_n {log_n}: launches {launched} "
                                         "(forward32, inverse32, columns forward, inverse)")
                if rows != WIDE_BATCH or kp != 3:  # kp 2 and one row: checked, not timed
                    continue
                b = bound(8 * kp * rows * n + 8 * kp * n, muls32=ntt_muls(kp * rows, n))
                x4_32, x2_32 = x4.to(torch.int32), x2.to(torch.int32)
                compare_kernel(torch, table, f"ntt32_forward@fs{log_n}kp{kp}", rows,
                               lambda: ntt32.forward32(tables, x4, 4),
                               lambda: ntt32.forward32(tables, x4_32, 4),
                               lambda: ntt32.forward32_plain(tables, x4, 4), b, plain_once=once)
                compare_kernel(torch, table, f"ntt32_inverse@fs{log_n}kp{kp}", rows,
                               lambda: ntt32.inverse32(tables, x2),
                               lambda: ntt32.inverse32(tables, x2_32),
                               lambda: ntt32.inverse32_plain(tables, x2), b, plain_once=once)
                tabs, pack = tables.kernel_tables(dev), build.ptr(tables.prime_pack)
                plans = tables.plans_on(dev)

                def col(x32, inverse):
                    out = torch.empty_like(x32)
                    fn = nc.columns_inverse if inverse else nc.columns_forward
                    fn(32, x32, out, tabs[2 * inverse], tabs[2 * inverse + 1], pack, kp, rows,
                       log_n)
                    return out
                cb = bound(8 * kp * rows * n, muls32=3 * kp * rows * (n // 2) * c)
                name = "ntt_columns_forward" + ("" if log_n == FS_PBS_LOG_N else f"@fs{log_n}")
                compare_kernel(torch, table, name, rows,
                               lambda: widen_u32(col(x4_32, False)), lambda: col(x4_32, False),
                               lambda: nc.columns_forward_plain(plans, x4, nc.SUB_LOG, 32), cb,
                               plain_once=once)
                name = name.replace("forward", "inverse")
                compare_kernel(torch, table, name, rows,
                               lambda: widen_u32(col(x2_32, True)), lambda: col(x2_32, True),
                               lambda: nc.columns_inverse_plain(plans, x2, nc.SUB_LOG, 32), cb,
                               plain_once=once)
            del x4, x2
        log(f"kernels 1-2 at log_n {log_n} (2^{c} sub-rows of 2^14 words), kp 2 and 3, 1 and "
            f"16 rows a prime: every out_factor and the in-place out_factor 4 bit-equal to the "
            f"plain versions, two launches a call (the column launch counted on its own)")
        torch.cuda.empty_cache()
    tables = tfhe.make_convolver(FS_PBS_LOG_N, 3, 1, 7).ntt  # the 2^18 PBS's kernel 1
    kp, n = len(tables.primes), 1 << FS_PBS_LOG_N
    for bsz in (1, WIDE_BATCH):
        rows = bsz * 2 * 3
        x4 = residues(tables.primes, (rows, n), 4)
        x4_32 = x4.to(torch.int32)
        compare_kernel(torch, table, f"ntt32_forward@pbs{FS_PBS_LOG_N}", bsz,
                       lambda: ntt32.forward32(tables, x4, 4),
                       lambda: ntt32.forward32(tables, x4_32, 4, out=x4_32),
                       lambda: ntt32.forward32_plain(tables, x4, 4),
                       bound(8 * kp * rows * n + 8 * kp * n, muls32=ntt_muls(kp * rows, n)))


def staged_four_step(torch, dev, table, smi, g, residues, log_n) -> None:
    """24.3: BOOLEAN_128's gadget (kp 3, L 3, k1 2) at N = 2^log_n on the
    staged step past 2^17: kernels G and 1 (the column launch and the
    sub-row launch) and the split H (mac_sub, then H's column launch with
    the CRT); 4 staged steps at batch 1 and 16 against the plain step with
    exact launches; split H against ``cmux_stage2_plain``, its two launches
    against their plain versions, G and F (tags "@fs18" ..; at 2^18 the
    new launches' untagged rows; past 2^18 the plain versions timed on
    their checking run alone)."""
    from primus_fhe_tpu_torch.decompose import ApproxSignedBasis32
    from primus_fhe_tpu_torch.lattice import tfhe
    from primus_fhe_tpu_torch.ops import cmux_front, cmux_fused, ntt32, rotate
    from primus_fhe_tpu_torch.ops import ntt_columns as nc

    conv = tfhe.make_convolver(log_n, 3, 1, 7)
    basis = ApproxSignedBasis32(None, 7, reverse_length=3)
    n, kp, k1, level = 1 << log_n, conv.count, 2, 3
    tag = f"@fs{log_n}"
    base = log_n == FS_PBS_LOG_N  # the new launches' rows at the PBS's ring
    once = log_n > FS_PBS_LOG_N  # the plain versions timed on their checking run
    plan = cmux_fused.CmuxStepPlan(conv, basis, k1, dev)
    if plan.route != "staged" or not plan._stage2.split:
        raise AssertionError(f"N = 2^{log_n}: route {plan.route}, split H expected")
    key = residues(conv.primes, (k1, level, k1, n), 1)
    key32 = key.to(torch.int32)
    counted = (cmux_front.cmux_front, ntt32.forward32, nc.columns_forward, nc.mac_sub,
               cmux_fused.cmux_stage2_cols, cmux_fused.cmux_stage2, cmux_fused.fused_cmux_step)
    for bsz in (1, WIDE_BATCH):
        acc = torch.randint(0, 1 << 32, (bsz, k1, n), generator=g, device=dev)
        acc32 = acc.to(torch.int32)
        l0 = [fn.launches for fn in counted]
        for i in range(4):
            deg = torch.randint(0, 2 * n, (bsz,), generator=g, device=dev, dtype=torch.int32)
            acc = cmux_fused.cmux_stage2_plain(
                conv, cmux_fused.cmux_stage1_plain(conv, basis, acc, deg), key, acc)
            plan(acc32, deg, key32, out=acc32)
            if not torch.equal(acc32.to(torch.int64) & 0xFFFFFFFF, acc):
                raise AssertionError(f"staged step {i} at N = 2^{log_n}, batch {bsz} != plain")
        launched = [fn.launches - b for fn, b in zip(counted, l0)]
        if launched != [4, 4, 4, 4, 4, 0, 0]:
            raise AssertionError(f"staged steps at N = 2^{log_n}: launches {launched}")
        f = residues(conv.primes, (bsz * k1, level, n), 4)
        f32 = f.to(torch.int32)
        hb = stage2_bound(kp, bsz, k1, level, n)
        compare_kernel(torch, table, "cmux_stage2" + tag, bsz,
                       lambda: cmux_fused.cmux_stage2(conv, f, key, acc),
                       lambda: cmux_fused.cmux_stage2(conv, f32, key32, acc32),
                       lambda: cmux_fused.cmux_stage2_plain(conv, f, key, acc), hb, plain_once=once)
        # split H's two launches alone
        sub_pack, part = plan._stage2._sub(bsz)
        plans = conv.ntt.plans_on(dev)
        f_rows = f.reshape(kp, bsz, k1 * level, n).unsqueeze(2).expand(kp, bsz, k1, k1 * level, n)
        key_rows = key.permute(0, 3, 1, 2, 4).reshape(kp, 1, k1, k1 * level, n).expand(
            kp, bsz, k1, k1 * level, n)

        def run_sub():
            out = torch.empty_like(part)
            nc.mac_sub(f32, key32, out, sub_pack)
            return out
        compare_kernel(torch, table, "mac_sub" + ("" if base else tag), bsz,
                       lambda: run_sub().to(torch.int64) & 0xFFFFFFFF, run_sub,
                       lambda: nc.mac_sub_plain(plans, f_rows, key_rows).reshape(part.shape),
                       bound(4 * (kp * bsz * k1 * level * n + kp * k1 * level * k1 * n
                                  + kp * bsz * k1 * n),
                             muls32=kp * bsz * k1 * k1 * level * n
                             + 3 * kp * bsz * k1 * (n // 2) * nc.MAC_SUB_LOG), plain_once=once)
        lazy = run_sub()
        lazy64 = lazy.to(torch.int64) & 0xFFFFFFFF

        def run_cols():
            out = torch.empty_like(acc32)
            cmux_fused.cmux_stage2_cols(plan._stage2, lazy, acc32, out, bsz)
            return out
        compare_kernel(torch, table, "cmux_stage2_cols" + ("" if base else tag), bsz,
                       lambda: run_cols().to(torch.int64) & 0xFFFFFFFF, run_cols,
                       lambda: cmux_fused.cmux_stage2_cols_plain(conv, lazy64, acc),
                       bound(4 * (kp * bsz * k1 * n + 2 * bsz * k1 * n),
                             muls32=3 * kp * bsz * k1 * (n // 2) * (log_n - nc.MAC_SUB_LOG)),
                       plain_once=once)
        deg = torch.randint(0, 2 * n, (bsz,), generator=g, device=dev, dtype=torch.int32)
        gb = bound(4 * (bsz * k1 * n + kp * bsz * k1 * level * n))  # G: acc in, digits out
        compare_kernel(torch, table, "cmux_front" + tag, bsz,
                       lambda: cmux_front.cmux_front(acc, deg, basis, conv.primes),
                       lambda: cmux_front.cmux_front(acc32, deg, basis, conv.primes),
                       lambda: cmux_front.cmux_front_plain(acc, deg, basis, conv.primes), gb,
                       plain_once=once)
        test_row = acc[0, 0]
        compare_kernel(torch, table, "rotate" + tag, bsz,
                       lambda: rotate.rotate(test_row.expand(bsz, n), deg),
                       lambda: rotate.rotate(test_row.to(torch.int32).expand(bsz, n), deg),
                       lambda: rotate.rotate_plain(test_row.expand(bsz, n), deg),
                       bound(4 * (n + bsz * n)), plain_once=once)
        f0 = (rotate.rotate.launches, cmux_front.cmux_front.launches)
        rotate.rotate(test_row.expand(bsz, n), deg)
        cmux_front.cmux_front(acc32, deg, basis, conv.primes)
        if (rotate.rotate.launches - f0[0], cmux_front.cmux_front.launches - f0[1]) != (1, 1):
            raise AssertionError(f"F and G at N = 2^{log_n}: not one launch a call")
        step_ms = kernel_device_ms(torch, lambda: plan(acc32, deg, key32, out=acc32))
        one = table.get(f"ntt32_forward@pbs{log_n}", {}).get(bsz)
        log(f"[{smi}] staged step at N = 2^{log_n}, batch {bsz}: 4 steps bit-equal to the plain "
            f"step, launches G / kernel 1 / its columns / mac_sub / H's columns / H / fused "
            f"{launched}; one step {step_ms:.4f} device ms (CUDA events behind a sleep): G "
            f"{table['cmux_front' + tag][bsz][3]:.4f}, kernel 1 with its columns "
            f"{'not timed here' if one is None else f'{one[3]:.4f}'}, split H "
            f"{table['cmux_stage2' + tag][bsz][3]:.4f} ms (bound {hb[0]:.4f} ms, {hb[1]})")
        del f, f32, f_rows, key_rows, lazy, lazy64
    torch.cuda.empty_cache()


def _has_ntt_prime(bits: int, log_n: int) -> bool:
    from primus_fhe_tpu_torch.utils.primes import next_ntt_prime

    try:
        next_ntt_prime(bits, log_n)
    except ValueError:
        return False
    return True


def ntru_four_step(torch, dev, table, smi, g, log_n) -> dict:
    """24.4: NTRU_128's gadget at N = 2^log_n on the staged route past 2^17:
    kernel 1 (two launches) and the split J (mac_sub, the inverse's column
    launch, ntru_finish) at batch 1 and 16 on random evk rows, 8 staged
    steps against the plain step with exact launches, split J against
    ``ntru_stage2_plain`` (digits too) and ntru_finish against its plain
    version (tags "@ntru18" ..; at 2^18 ntru_finish's untagged row).
    Returns the launches of the steps at batch 1, by wrapper."""
    import dataclasses

    from primus_fhe_tpu_torch import params as P
    from primus_fhe_tpu_torch.ops import ntru_cmux_mxu, ntt32
    from primus_fhe_tpu_torch.ops import ntt_columns as nc

    # NTRU_128's 20-bit q has no 2^(log_n + 1)-th root past 2^17: the least
    # q_bits that has one (23 at 2^18-2^19, 25 at 2^20), the gadget kept
    q_bits = next(b for b in range(P.NTRU_128.q_bits, 31) if _has_ntt_prime(b, log_n))
    pw = dataclasses.replace(P.NTRU_128, log_n=log_n, q_bits=q_bits)
    kctx, _ = P.make_ntru_context(pw)
    qn, nn, level = kctx.q_int, kctx.n, kctx.basis.decompose_length
    log(f"q = {qn} ({q_bits} bits), gadget 2^{kctx.basis.log_basis} x {level}")
    tag, once = f"@ntru{log_n}", log_n > FS_PBS_LOG_N
    step = ntru_cmux_mxu.NtruStepPlan(kctx, dev)
    if step.route != "staged" or not step._stage2.split:
        raise AssertionError(f"NTRU at N = 2^{log_n}: route {step.route}, split J expected")
    evk = torch.randint(0, qn, (NTRU_CHECK_STEPS, level, nn), generator=g, device=dev)
    evk32 = evk.to(torch.int32)
    counted = (ntru_cmux_mxu.ntru_digits, ntt32.forward32, nc.columns_forward, nc.mac_sub,
               nc.columns_inverse, ntru_cmux_mxu.ntru_finish, ntru_cmux_mxu.ntru_stage2)
    counts = {}
    for bsz in (1, NTRU_WIDE_BATCH):
        acc = torch.randint(0, qn, (bsz, nn), generator=g, device=dev)
        acc32 = acc.to(torch.int32)
        sw = torch.randint(0, 2 * nn, (NTRU_CHECK_STEPS, bsz), generator=g, device=dev,
                           dtype=torch.int32)
        plain_acc, run = acc.clone(), acc32.clone()
        l0 = [fn.launches for fn in counted]
        for i in range(NTRU_CHECK_STEPS):
            f = ntru_cmux_mxu.ntru_stage1_plain(kctx.ntt, kctx.basis, plain_acc)
            plain_acc = ntru_cmux_mxu.ntru_stage2_plain(kctx.ntt, f, evk[i], plain_acc, sw[i])
            run = step(run, sw[i], evk32[i], None)
            if not torch.equal(run.to(torch.int64), plain_acc):
                raise AssertionError(f"NTRU staged step {i} at N = 2^{log_n}, batch {bsz} != plain")
        s_ = NTRU_CHECK_STEPS
        launched = [fn.launches - b for fn, b in zip(counted, l0)]
        if launched != [1, s_, s_, s_, s_, s_, 0]:  # J past 2^17: its three launches, not one
            raise AssertionError(f"NTRU staged steps at N = 2^{log_n}: launches {launched}")
        f = ntru_cmux_mxu.ntru_stage1(kctx.ntt, kctx.basis, acc)
        f32 = f.to(torch.int32)
        deg = sw[0]
        want_j, want_dig = ntru_cmux_mxu.ntru_stage2_plain(kctx.ntt, f, evk[0], acc, deg,
                                                           kctx.basis)
        f_dig, acc_in = f32.clone(), acc32.clone()
        out_j = ntru_cmux_mxu.ntru_stage2(kctx.ntt, f_dig, evk32[0], acc_in, deg, out=acc_in,
                                          basis=kctx.basis)
        if not (torch.equal(out_j.to(torch.int64), want_j)
                and torch.equal(f_dig.to(torch.int64), want_dig)):
            raise AssertionError(f"split J with digits at N = 2^{log_n}, batch {bsz}: != plain")
        f_run = f32.clone()
        compare_kernel(torch, table, "ntru_stage2" + tag, bsz,
                       lambda: ntru_cmux_mxu.ntru_stage2(kctx.ntt, f32.clone(), evk32[0], acc32,
                                                         deg, basis=kctx.basis).to(torch.int64),
                       lambda: ntru_cmux_mxu.ntru_stage2(kctx.ntt, f_run, evk32[0], acc32, deg,
                                                         basis=kctx.basis),
                       lambda: ntru_cmux_mxu.ntru_stage2_plain(kctx.ntt, f, evk[0], acc, deg),
                       ntru_stage2_bound(bsz, level, nn), plain_once=once)
        delta = torch.randint(0, qn, (bsz, nn), generator=g, device=dev)
        delta32 = delta.to(torch.int32)
        digits = torch.empty((level, bsz, nn), dtype=torch.int32, device=dev)

        def fin():
            out = torch.empty_like(acc32)
            ntru_cmux_mxu.ntru_finish(step._stage2, delta32, acc32, deg, out, digits)
            return out
        want_fin, want_fd = ntru_cmux_mxu.ntru_finish_plain(qn, delta, acc, deg, kctx.basis)
        if not (torch.equal(fin().to(torch.int64), want_fin)
                and torch.equal(digits.to(torch.int64), want_fd)):
            raise AssertionError(f"ntru_finish at N = 2^{log_n}, batch {bsz}: != plain")
        compare_kernel(torch, table, "ntru_finish" + ("" if log_n == FS_PBS_LOG_N else tag), bsz,
                       lambda: fin().to(torch.int64), fin,
                       lambda: ntru_cmux_mxu.ntru_finish_plain(qn, delta, acc, deg),
                       bound(4 * (3 * bsz * nn + level * bsz * nn + bsz)), plain_once=once)
        step_ms = kernel_device_ms(torch, lambda: step(run, sw[0], evk32[0], None))
        log(f"[{smi}] NTRU at N = 2^{log_n}, batch {bsz}: {NTRU_CHECK_STEPS} staged steps "
            f"bit-equal to the plain step, launches I / kernel 1 / its columns / mac_sub / J's "
            f"columns / ntru_finish / J {launched}; one step after the first {step_ms:.4f} "
            f"device ms; split J {table['ntru_stage2' + tag][bsz][3]:.4f} ms")
        counts = counts if bsz != 1 else dict(zip((fn.__name__ for fn in counted), launched))
        del f, f32, f_run, f_dig
    torch.cuda.empty_cache()
    return counts


def phase24_four_step(torch, dev, table, smi, reset_counts, read_counts) -> dict:
    """Phase 24: the rings past what a cluster holds, on the four-step
    through device memory (csrc/ntt_columns.cu).  24.1 kernels 1-2 at
    log_n 18-20; 24.2 the u64 transforms there (row 9's four functions, D,
    E, row 10, row 12, the u64 column kernels; :func:`phase23_row9_wide`),
    with 24.8 the DCRT steps at N = 2^18 and 24.9 kernel E on 512 rows
    there; 24.3 the staged TFHE step with the split H, F and G; 24.4 the
    NTRU step with the split J; 24.6 a 4-bit programmable bootstrap at N =
    2^18 on the int32 NTT key.  Returns the launch counts of 24.6's
    bootstrap (key "pbs"), 24.8's DCRT steps (key "dcrt", by N) and 24.4's
    8 NTRU steps at N = 2^18, batch 1 (key "ntru")."""
    import dataclasses

    from primus_fhe_tpu_torch import params as P

    global KERNEL_REPS
    reps, KERNEL_REPS = KERNEL_REPS, FS_REPS
    try:
        g = torch.Generator(device=dev).manual_seed(SEED + 29)

        def residues(primes, shape, factor):
            q = torch.tensor(primes, dtype=torch.int64, device=dev).reshape(
                (-1,) + (1,) * len(shape))
            return torch.randint(0, 1 << 40, (len(primes),) + shape, generator=g,
                                 device=dev) % (factor * q)

        log(f"-- 24.1: kernels 1-2 at log_n {FS_LOG_N} (the column launch and the sub-row "
            f"launch)")
        four_step_ntt32(torch, dev, table, g, residues)
        counts = {"dcrt": phase23_row9_wide(torch, dev, table, wide=FS_LOG_N, cluster=FS_LOG_N,
                                            dcrt=(FS_PBS_LOG_N,), rt_log_n=(FS_PBS_LOG_N,),
                                            moduli_counts=(), step="24")}
        for log_n in FS_LOG_N:
            log(f"-- 24.3: the staged TFHE step at N = 2^{log_n} (split H)")
            staged_four_step(torch, dev, table, smi, g, residues, log_n)
        for log_n in FS_LOG_N:
            log(f"-- 24.4: the staged NTRU step at N = 2^{log_n} (split J)")
            ntru_counts = ntru_four_step(torch, dev, table, smi, g, log_n)
            counts.setdefault("ntru", ntru_counts)
    finally:
        KERNEL_REPS = reps
    top = dataclasses.replace(P.BOOLEAN_128, log_n=FS_PBS_LOG_N)
    counts["pbs"], _ = programmable_bootstrap(torch, dev, smi, "24.6", top, SEED + 30, 2,
                                              reset_counts, read_counts)
    return counts


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this run needs a CUDA card")

    from primus_fhe_tpu_torch import params as P
    from primus_fhe_tpu_torch.boot import gates, ntru_gates
    from primus_fhe_tpu_torch.boot import ntru_blind_rotate as nbr
    from primus_fhe_tpu_torch.boot.blind_rotate import bootstrap, initial_accumulator
    from primus_fhe_tpu_torch.decompose import ApproxSignedBasis32
    from primus_fhe_tpu_torch.lattice import keyswitch, tfhe
    from primus_fhe_tpu_torch.modular.modops import add32, neg32, sub32
    from primus_fhe_tpu_torch.numeric.limb import narrow_u32
    from primus_fhe_tpu_torch.ops import (build, cmux_front, cmux_fused, cmux_mxu, ntru_cmux_mxu,
                                          ntt32, ntt_columns, ntt_mxu8, rotate)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # -- phase 1: device facts and kernel build ------------------------------
    log("== phase 1: device and build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log("card (nvidia-smi --query-gpu=name,power.limit --format=csv,noheader):")
    log(smi)
    log(f"torch {torch.__version__}  cuda {torch.version.cuda}  python {sys.version.split()[0]}")
    log(f"device 0: {torch.cuda.get_device_name(0)}  count {torch.cuda.device_count()}")
    so, build_s, build_log = build.build()
    build.library()
    log(f"kernel build: {so.name} in {build_s:.2f} s (one nvcc per source, in parallel)")
    for line in build_log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    p = P.BOOLEAN_128
    basis = ApproxSignedBasis32(None, p.log_basis, reverse_length=p.level)
    conv = tfhe.make_convolver(p.log_n, p.level, p.glwe_dim, p.log_basis)
    n, kp, k1, level = p.n, conv.count, p.glwe_dim + 1, p.level
    plan = cmux_mxu.plan_for(conv)
    log(f"BOOLEAN_128: N={n} n_lwe={p.lwe_dim} primes={conv.primes} L={level} k1={k1}")
    pn = P.NTRU_128
    nctx, _ = P.make_ntru_context(pn)
    qn, nn = nctx.q_int, nctx.n
    nplan = ntru_cmux_mxu.get_ntru_plan(pn.log_n, qn)
    log(f"NTRU_128: N={nn} q={qn} n_lwe={pn.lwe_dim} NGS 2^{pn.log_basis} x {pn.level}, "
        f"key switch 2^{pn.ks_log_basis} x {pn.ks_level}")

    # -- phase 2: kernels against their plain versions -----------------------
    log("== phase 2: kernels vs plain versions (bit-equal)")
    g = torch.Generator(device=dev).manual_seed(SEED)
    qs = torch.tensor(conv.primes, dtype=torch.int64, device=dev).reshape(kp, 1, 1)

    def residues(rows, factor, primes=qs, count=kp, width=n):
        r = torch.randint(0, 1 << 40, (count, rows, width), generator=g, device=dev)
        return r % (factor * primes)

    def words(*shape):
        return torch.randint(0, 1 << 32, shape, generator=g, device=dev)

    i32 = lambda *ts: tuple(t.to(torch.int32) for t in ts)  # noqa: E731
    table = {}
    qn_t = torch.tensor([qn], dtype=torch.int64, device=dev).reshape(1, 1, 1)
    for bsz in (1, BATCH):
        rows = bsz * k1
        x_fwd, x_inv = residues(rows, 4), residues(rows, 2)
        acc = words(bsz, k1, n)
        degrees = torch.randint(0, 2 * n, (bsz,), generator=g, device=dev, dtype=torch.int32)
        key = torch.randint(0, 1 << 40, (kp, k1, level, k1, n), generator=g, device=dev)
        key = key % qs.reshape(kp, 1, 1, 1, 1)
        # kernel wrappers on int64 words (checked: narrow + kernel + widen)
        # and on int32 storage (timed: what the blind-rotation loop passes)
        x_fwd32, x_inv32, acc32, key32 = i32(x_fwd, x_inv, acc, key)
        kv, kpre = cmux_mxu.prepare_mxu_bsk(conv, words(1, k1, level, k1, n))
        kv, kpre = kv[0], kpre[0]
        kv32, kpre32 = i32(kv, kpre)
        c_in = residues(bsz * k1 * level * k1, 1)  # bsz key slices per prime
        c_in32, = i32(c_in)
        # work of each kernel at these shapes (u32 words, 4 bytes each)
        xr, cr, dp = kp * rows, c_in.numel() // n, cmux_mxu.digit_planes(basis)
        ntt_b = bound(8 * xr * n, muls32=ntt_muls(xr, n))
        # the one-launch step: acc in and out, the key slice, the degrees and
        # the four root tables; kp*rows*L forward and kp*rows inverse NTTs
        # and the MAC's kp*rows*k1*L products
        step_b = bound(4 * (2 * rows * n + kp * k1 * level * k1 * n + bsz + 4 * kp * n),
                       muls32=ntt_muls(kp * rows * level, n) + ntt_muls(kp * rows, n)
                       + kp * rows * k1 * level * n)
        mxu_a_macs = kp * bsz * (four_step_macs(k1 * level, n, 4, dp, 4)
                                 + four_step_macs(k1, n, 4, 4))
        mxu_a_b = bound(4 * (2 * rows * n + 2 * kp * k1 * level * k1 * n), mxu_a_macs,
                        3 * kp * bsz * k1 * level * k1 * n)
        compare_kernel(torch, table, "ntt32_forward", bsz,
                       lambda: ntt32.forward32(conv.ntt, x_fwd),
                       lambda: ntt32.forward32(conv.ntt, x_fwd32),
                       lambda: ntt32.forward32_plain(conv.ntt, x_fwd), ntt_b)
        compare_kernel(torch, table, "ntt32_inverse", bsz,
                       lambda: ntt32.inverse32(conv.ntt, x_inv),
                       lambda: ntt32.inverse32(conv.ntt, x_inv32),
                       lambda: ntt32.inverse32_plain(conv.ntt, x_inv), ntt_b)
        compare_kernel(torch, table, "fused_cmux_step", bsz,
                       lambda: cmux_fused.fused_cmux_step(conv, basis, acc, degrees, key),
                       lambda: cmux_fused.fused_cmux_step(conv, basis, acc32, degrees, key32),
                       lambda: cmux_fused.cmux_stage2_plain(
                           conv, cmux_fused.cmux_stage1_plain(conv, basis, acc, degrees), key,
                           acc), step_b)
        log(f"fused_cmux_step        batch {bsz:3d}: share of the bound "
            f"{step_b[0] / table['fused_cmux_step'][bsz][3]:.4f}")
        compare_kernel(torch, table, "mxu_cmux_step", bsz,
                       lambda: cmux_mxu.mxu_cmux_step(plan, basis, conv, acc, degrees, kv, kpre),
                       lambda: cmux_mxu.mxu_cmux_step(plan, basis, conv, acc32, degrees, kv32,
                                                      kpre32),
                       lambda: cmux_mxu.mxu_cmux_step_plain(conv, basis, acc, degrees, kv),
                       mxu_a_b, mxu_a_macs)
        compare_kernel(torch, table, "mxu8_forward32", bsz,
                       lambda: ntt_mxu8.mxu8_forward32(plan, c_in),
                       lambda: ntt_mxu8.mxu8_forward32(plan, c_in32),
                       lambda: ntt_mxu8.mxu8_forward32_plain(plan, c_in),
                       bound(8 * cr * n, muls32=ntt_muls(cr, n)))
        # NTRU_128 shapes: kernel B (both evaluation keys run it)
        n_acc = torch.randint(0, qn, (bsz, nn), generator=g, device=dev)
        n_deg = torch.randint(0, 2 * nn, (bsz,), generator=g, device=dev, dtype=torch.int32)
        nkv, nkpre = ntru_cmux_mxu.prepare_mxu_evk(
            nctx, torch.randint(0, qn, (1, pn.level, nn), generator=g, device=dev))
        nkv, nkpre = nkv[0], nkpre[0]
        n_acc32, nkv32, nkpre32 = i32(n_acc, nkv, nkpre)
        ndp = cmux_mxu.digit_planes(nctx.basis)
        ntru_macs = bsz * (four_step_macs(pn.level, nn, 4, ndp, 4) + four_step_macs(1, nn, 4, 4))
        compare_kernel(torch, table, "ntru_cmux_step", bsz,
                       lambda: ntru_cmux_mxu.ntru_cmux_step(nplan, nctx.basis, n_acc, n_deg, nkv,
                                                            nkpre),
                       lambda: ntru_cmux_mxu.ntru_cmux_step(nplan, nctx.basis, n_acc32, n_deg,
                                                            nkv32, nkpre32),
                       lambda: ntru_cmux_mxu.ntru_cmux_step_plain(nplan, nctx.basis, n_acc, n_deg,
                                                                  nkv),
                       bound(4 * (2 * bsz * nn + 2 * pn.level * nn), ntru_macs,
                             3 * bsz * pn.level * nn), ntru_macs)

    # a partial last cluster (its spare blocks store nothing): A at batch 5,
    # B at batch 9, against their plain versions
    for bsz in (5, 9):
        acc = words(bsz, k1, n)
        degrees = torch.randint(0, 2 * n, (bsz,), generator=g, device=dev, dtype=torch.int32)
        n_acc = torch.randint(0, qn, (bsz, nn), generator=g, device=dev)
        n_deg = torch.randint(0, 2 * nn, (bsz,), generator=g, device=dev, dtype=torch.int32)
        got = cmux_mxu.mxu_cmux_step(plan, basis, conv, acc, degrees, kv, kpre)
        n_got = ntru_cmux_mxu.ntru_cmux_step(nplan, nctx.basis, n_acc, n_deg, nkv, nkpre)
        if not (torch.equal(got, cmux_mxu.mxu_cmux_step_plain(conv, basis, acc, degrees, kv))
                and torch.equal(n_got, ntru_cmux_mxu.ntru_cmux_step_plain(
                    nplan, nctx.basis, n_acc, n_deg, nkv))):
            raise AssertionError(f"kernels A/B at batch {bsz} (a partial cluster) != plain")
        c_a = cmux_mxu.launch_clusters(False, kp, k1, p.log_n, dp, level, bsz)
        c_b = cmux_mxu.launch_clusters(True, 1, 1, pn.log_n, ndp, pn.level, bsz)
        log(f"mxu_cmux_step / ntru_cmux_step batch {bsz}: bit-equal, {c_a} / {c_b} ciphertexts a "
            f"cluster ({bsz % c_a or c_a} / {bsz % c_b or c_b} in the last)")

    # kernel C at the key preparations' sizes, kernel 1's canonical forward
    # (the same function, a hand-written kernel of the port) on the same words
    for tag, cplan, primes_t, count, width in (("bsk", plan, qs, kp, n),
                                               ("evk", nplan, qn_t, 1, nn)):
        rows_k = KEY_ROWS[tag]
        x_k = residues(rows_k, 1, primes_t, count, width)
        x_k32, = i32(x_k)
        k_b = bound(8 * x_k.numel(), muls32=ntt_muls(x_k.numel() // width, width))
        compare_kernel(torch, table, f"mxu8_forward32@{tag}", rows_k,
                       lambda: ntt_mxu8.mxu8_forward32(cplan, x_k),
                       lambda: ntt_mxu8.mxu8_forward32(cplan, x_k32),
                       lambda: ntt_mxu8.mxu8_forward32_plain(cplan, x_k), k_b)
        compare_kernel(torch, table, f"ntt32_forward@{tag}", rows_k,
                       lambda: ntt32.forward32(cplan.ntt, x_k),
                       lambda: ntt32.forward32(cplan.ntt, x_k32),
                       lambda: ntt32.forward32_plain(cplan.ntt, x_k), k_b)
        c_ms, one_ms = (table[f"{k}@{tag}"][rows_k][3] for k in ("mxu8_forward32", "ntt32_forward"))
        log(f"mxu8_forward32@{tag}: {count} x {rows_k} rows of {width}, tile and grid "
            f"{ntt_mxu8.launch_grid(cplan, rows_k)}; device {c_ms:.4f} ms against kernel 1's "
            f"{one_ms:.4f} (ratio {c_ms / one_ms:.3f}); share of the bound {k_b[0] / c_ms:.3f}")
        del x_k, x_k32

    counted = (ntt32.forward32, ntt32.inverse32, cmux_fused.fused_cmux_step,
               cmux_mxu.mxu_cmux_step, ntru_cmux_mxu.ntru_cmux_step, ntt_mxu8.mxu8_forward32,
               rotate.rotate, cmux_front.cmux_front, cmux_fused.cmux_stage2,
               ntru_cmux_mxu.ntru_digits, ntru_cmux_mxu.ntru_stage2,
               ntt_columns.columns_forward, ntt_columns.columns_inverse, ntt_columns.mac_sub,
               cmux_fused.cmux_stage2_cols, ntru_cmux_mxu.ntru_finish)

    def reset_counts():
        for fn in counted:
            fn.launches = 0

    def read_counts():
        torch.cuda.synchronize()
        return {fn.__name__: fn.launches for fn in counted}

    # -- phases 3-4: the NTT-key path, counted -------------------------------
    reset_counts()
    log("== phase 3: make_context(BOOLEAN_128) on the card (bsk_kind='ntt')")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctx = P.make_context(p, dev, gen, bsk_kind="ntt")
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    log(f"keygen: {keygen_s:.3f} s; bsk {tuple(ctx.bsk.shape)}, ksk {tuple(ctx.ksk.shape)}")

    log("== phase 4: gates at full width, key switch included")
    a_bits = torch.tensor([0, 0, 1, 1], device=dev)
    b_bits = torch.tensor([0, 1, 0, 1], device=dev)
    truth = {
        "nand_gate": lambda a, b: ~(a & b),
        "and_gate": lambda a, b: a & b,
        "or_gate": lambda a, b: a | b,
    }

    def tfhe_truth_tables(c, gen_c, label):
        """Truth tables, NOT and a composition on context ``c``; returns the
        number of bootstraps and the phase errors of the outputs."""
        args = (c.conv, c.basis, c.bsk, c.ksk, c.ks_basis)
        ca, cb = c.encrypt(a_bits, gen_c), c.encrypt(b_bits, gen_c)
        errors = []

        def check(tag, out, want_bits):
            got = c.decrypt(out)
            mu = torch.where(want_bits, gates.TRUE_MU, -gates.TRUE_MU)
            errors.append(c.phase(out) - mu)
            log(f"[{label}] {tag}: got {got.int().tolist()} want {want_bits.int().tolist()}")
            if not torch.equal(got, want_bits):
                raise AssertionError(f"[{label}] {tag}: wrong truth table")

        for name, fn in truth.items():
            out = getattr(gates, name)(*args, ca, cb, p.log_n)
            check(f"{name} (a,b)=(00,01,10,11)", out, fn(a_bits.bool(), b_bits.bool()))
        check("not_gate (0,1)", gates.not_gate(c.encrypt(torch.tensor([0, 1], device=dev), gen_c)),
              torch.tensor([True, False], device=dev))
        nand = gates.nand_gate(*args, ca, cb, p.log_n)
        comp = gates.nand_gate(*args, nand, nand, p.log_n)
        check("NAND(NAND(a,b),NAND(a,b)) == AND(a,b)", comp, a_bits.bool() & b_bits.bool())
        return len(truth) + 2, errors

    bootstraps, errors = tfhe_truth_tables(ctx, gen, "ntt key")
    counts = read_counts()

    err = torch.cat(errors).double()
    predicted = P.gate_noise_stddev(p)
    log(f"gate output phase error over {err.numel()} outputs: std {err.std().item():.1f} "
        f"(2^{torch.log2(err.std()).item():.2f}), max |e| {err.abs().max().item():.0f}; "
        f"noise.py predicts std {predicted:.1f} (2^{torch.log2(torch.tensor(predicted)).item():.2f}); "
        f"decision threshold 2^29")

    # -- phase 5: the same bootstrap on the card and on the CPU --------------
    log("== phase 5: bootstrap on cuda (kernels) vs cpu (plain versions), all key slices")
    ct = ctx.encrypt(torch.tensor([1], device=dev), gen)
    tp = torch.full((n,), gates.TRUE_MU, dtype=torch.int64, device=dev)
    out_gpu = bootstrap(ctx.conv, ctx.basis, ctx.bsk, ct, tp, p.log_n)
    t0 = time.perf_counter()
    out_cpu = bootstrap(ctx.conv, ctx.basis, ctx.bsk.cpu(), ct.cpu(), tp.cpu(), p.log_n)
    boot_cpu_s = time.perf_counter() - t0
    if not torch.equal(out_gpu.cpu(), out_cpu):
        raise AssertionError("bootstrap on cuda and on cpu differ")
    log(f"{p.lwe_dim} steps: cuda and cpu outputs equal ({out_cpu.numel()} words); "
        f"cpu plain bootstrap took {boot_cpu_s:.2f} s")

    # -- phase 6: launch counts of the NTT-key path --------------------------
    log("== phase 6: launch counts of phases 3-4")
    log(json.dumps(counts))
    want_cmux = bootstraps * p.lwe_dim
    for name in ("forward32", "inverse32", "fused_cmux_step"):
        if counts[name] <= 0:
            raise AssertionError(f"{name} was never launched on the NTT-key path")
    if counts["fused_cmux_step"] != want_cmux:
        raise AssertionError(f"fused_cmux_step: {counts['fused_cmux_step']} launches, "
                             f"want {want_cmux}")
    log(f"fused_cmux_step: {want_cmux} = {bootstraps} bootstraps x {p.lwe_dim} steps (one "
        f"launch a step, {p.lwe_dim} a bootstrap)")
    if counts["rotate"] != bootstraps or counts["cmux_front"]:
        raise AssertionError(f"rotate: {counts['rotate']} launches, want {bootstraps} (one a "
                             f"bootstrap); cmux_front: {counts['cmux_front']}, want 0")
    log(f"rotate: {counts['rotate']} = one a bootstrap (the accumulator's v * X^-b)")

    # -- phase 7: timings of the NTT-key path ---------------------------------
    log("== phase 7: timings (bsk_kind='ntt')")

    def time_tfhe(c, label, bits):
        args = (c.conv, c.basis, c.bsk, c.ksk, c.ks_basis)
        xa, xb = c.encrypt(bits, gen), c.encrypt(bits.flip(0), gen)
        want = ~(bits.bool() & bits.flip(0).bool())

        def check(out):
            if not torch.equal(c.decrypt(out), want):
                raise AssertionError(f"NAND {label}: wrong truth table")

        return time_gate(
            torch, f"NAND {label}", lambda: gates.nand_gate(*args, xa, xb, p.log_n),
            lambda: bootstrap(c.conv, c.basis, c.bsk, xa, tp, p.log_n),
            lambda big: keyswitch.key_switch(big, c.ksk, c.ks_basis), check, p.lwe_dim)

    bits64 = torch.randint(0, 2, (BATCH,), generator=gen, device=dev)
    lat = time_tfhe(ctx, "ntt key, batch 1", torch.tensor([1], device=dev))
    rate = time_tfhe(ctx, f"ntt key, batch {BATCH}", bits64)
    log(f"[ntt key] single-gate latency (batch 1): {lat:.2f} ms; NAND gates/s at batch {BATCH}: "
        f"{BATCH / (rate / 1e3):.1f}")
    # the bootstrap's start at batch 64: one kernel F launch by the counters,
    # and every launch the profiler sees (it may lose a session's last record,
    # so its rows are shown, not held to the count)
    start_deg = -torch.randint(0, 2 * n, (BATCH,), generator=gen, device=dev, dtype=torch.int32)
    reset_counts()
    initial_accumulator(tp, start_deg, k1)
    start_counts = {k: v for k, v in read_counts().items() if v}
    if start_counts != {"rotate": 1}:
        raise AssertionError(f"the bootstrap's start launched {start_counts}, want kernel F once")
    _, start_rows = device_time(torch, lambda: initial_accumulator(tp, start_deg, k1))
    f_seen = sum(c for _, c, key_ in start_rows if "rotate_kernel" in key_)
    log(f"bootstrap start (initial_accumulator, batch {BATCH}): counted {start_counts}; the "
        f"profiler saw {sum(c for _, c, _ in start_rows)} launch(es), kernel F x{f_seen}"
        + ("" if f_seen else " (its record lost)") + ": "
        + "; ".join(f"{key_[:60]} x{c} ({ms_ * 1e3:.2f} us)" for ms_, c, key_ in start_rows))
    if f_seen > 1:
        raise AssertionError(f"the profiler saw kernel F {f_seen} times in the bootstrap's start")

    # -- phase 8: the MXU key kind -------------------------------------------
    log("== phase 8: BOOLEAN_128 on the MXU key kind (kernel A per CMux step, kernel C in keygen)")
    reset_counts()
    gen_m = torch.Generator(device=dev).manual_seed(SEED + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctx_m = P.make_context(p, dev, gen_m, bsk_kind="mxu")
    torch.cuda.synchronize()
    keygen_m_s = time.perf_counter() - t0
    log(f"keygen: {keygen_m_s:.3f} s; bsk (vals, precons) {tuple(ctx_m.bsk[0].shape)} x 2, "
        f"ksk {tuple(ctx_m.ksk.shape)}")
    if not (torch.equal(ctx_m.lwe_secret, ctx.lwe_secret) and torch.equal(ctx_m.ksk, ctx.ksk)):
        raise AssertionError("the seeded MXU context does not share phase 3's secrets")
    bootstraps_m, _ = tfhe_truth_tables(ctx_m, gen_m, "mxu key")
    counts_m = read_counts()
    log(json.dumps(counts_m))
    want_a = bootstraps_m * p.lwe_dim
    if counts_m["mxu_cmux_step"] != want_a:
        raise AssertionError(f"mxu_cmux_step: {counts_m['mxu_cmux_step']} launches, want {want_a}")
    if counts_m["mxu8_forward32"] < 1:
        raise AssertionError("mxu8_forward32 was never launched in key preparation")
    if counts_m["fused_cmux_step"]:
        raise AssertionError("the MXU key ran the NTT-key CMux kernel")
    if counts_m["rotate"] != bootstraps_m:
        raise AssertionError(f"rotate: {counts_m['rotate']} launches, want {bootstraps_m}")
    log(f"mxu_cmux_step: {want_a} = {bootstraps_m} bootstraps x {p.lwe_dim} steps; "
        f"mxu8_forward32: {counts_m['mxu8_forward32']} launch(es) in key preparation")
    ggsw_c = torch.randint(0, 1 << 32, (p.lwe_dim, k1, level, k1, n), generator=gen_m, device=dev)
    prep_s = min(wall_ms(torch, lambda: cmux_mxu.prepare_mxu_bsk(conv, ggsw_c), 3)) / 1e3
    log(f"key preparation (prepare_mxu_bsk: lift, kernel C over {kp} x "
        f"{p.lwe_dim * k1 * level * k1} rows, Shoup quotients): {prep_s:.4f} s (least of 3)")
    del ggsw_c
    cts = ctx.encrypt(torch.tensor([1, 0, 1], device=dev), gen)
    b_ntt = bootstrap(ctx.conv, ctx.basis, ctx.bsk, cts, tp, p.log_n)
    b_mxu = bootstrap(ctx_m.conv, ctx_m.basis, ctx_m.bsk, cts, tp, p.log_n)
    if not torch.equal(b_ntt, b_mxu):
        raise AssertionError("MXU-key and NTT-key bootstraps differ")
    log(f"one bootstrap (3 ciphertexts) through the MXU pack and the NTT key: the same "
        f"{b_mxu.numel()} words")
    lat_m = time_tfhe(ctx_m, "mxu key, batch 1", torch.tensor([1], device=dev))
    rate_m = time_tfhe(ctx_m, f"mxu key, batch {BATCH}", bits64)
    log(f"[mxu key] single-gate latency (batch 1): {lat_m:.2f} ms; NAND gates/s at batch {BATCH}: "
        f"{BATCH / (rate_m / 1e3):.1f}  (ntt key in this run: {lat:.2f} ms; "
        f"{BATCH / (rate / 1e3):.1f} gates/s)")
    del ctx_m

    # -- phase 9: NTRU_128 ----------------------------------------------------
    log("== phase 9: NTRU_128 at full width (kernel B on both evaluation keys, the MXU pack and "
        "the NTT evk)")
    reset_counts()
    gen_n = torch.Generator(device=dev).manual_seed(SEED + 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    keys = P.make_ntru_keys(pn, dev, gen_n)
    torch.cuda.synchronize()
    keygen_n_s = time.perf_counter() - t0
    counts_kg = read_counts()
    kctx = keys.ctx
    log(f"keygen: {keygen_n_s:.3f} s; evk {tuple(keys.evk.shape)}, evk_mxu "
        f"{tuple(keys.evk_mxu[0].shape)} x 2, ksk {tuple(keys.ksk.shape)}; launches "
        f"{json.dumps(counts_kg)}")
    for name in ("forward32", "inverse32", "mxu8_forward32"):
        if counts_kg[name] < 1:
            raise AssertionError(f"{name} was never launched in the NTRU key generation")
    if not torch.equal(keys.evk_mxu[0].reshape(keys.evk.shape), keys.evk):
        raise AssertionError("the NTRU MXU evk's values differ from the NTT evk's")
    nt = (qn - 1) // 8
    ntru_truth = {"ntru_nand": truth["nand_gate"], "ntru_and": truth["and_gate"],
                  "ntru_or": truth["or_gate"]}
    n_errors = []
    counts_kind = {}
    gate_outs = {}
    for kind, evk in (("mxu", keys.evk_mxu), ("ntt", keys.evk)):
        nargs = (kctx, evk, keys.ksk, keys.ks_basis)
        g_in = torch.Generator(device=dev).manual_seed(SEED + 20)  # the same inputs on both
        ca, cb = keys.encrypt(a_bits, g_in), keys.encrypt(b_bits, g_in)
        reset_counts()

        def ncheck(tag, out, want_bits):
            got = keys.decrypt(out)
            n_errors.append(keys.phase(out) - torch.where(want_bits, nt, -nt))
            log(f"[ntru {kind} evk] {tag}: got {got.int().tolist()} want {want_bits.int().tolist()}")
            if not torch.equal(got, want_bits):
                raise AssertionError(f"[ntru {kind} evk] {tag}: wrong truth table")

        for name, fn in ntru_truth.items():
            ncheck(f"{name} (a,b)=(00,01,10,11)", getattr(ntru_gates, name)(*nargs, ca, cb),
                   fn(a_bits.bool(), b_bits.bool()))
        ncheck("ntru_not (0,1)", ntru_gates.ntru_not(kctx, keys.encrypt([0, 1], g_in)),
               torch.tensor([True, False], device=dev))
        nand = ntru_gates.ntru_nand(*nargs, ca, cb)
        gate_outs[kind] = nand
        ncheck("NAND(NAND(a,b),NAND(a,b)) == AND(a,b)", ntru_gates.ntru_nand(*nargs, nand, nand),
               a_bits.bool() & b_bits.bool())
        counts_kind[kind] = read_counts()
        want = {name: 0 for name in counts_kind[kind]} | {
            "ntru_cmux_step": (len(ntru_truth) + 2) * pn.lwe_dim}
        log(f"[ntru {kind} evk] launches: {json.dumps(counts_kind[kind])}")
        if counts_kind[kind] != want:  # kernel B a step, no launch of kernels 1-2
            raise AssertionError(f"[ntru {kind} evk] launches {counts_kind[kind]}, want {want}")
    counts_n, counts_nt = counts_kind["mxu"] | {"mxu8_forward32": counts_kg["mxu8_forward32"]}, \
        counts_kind["ntt"]
    if not torch.equal(gate_outs["mxu"], gate_outs["ntt"]):
        raise AssertionError("NTRU NAND on the NTT evk differs from the MXU evk's")
    log(f"ntru_cmux_step: {counts_n['ntru_cmux_step']} launches on each evk form = "
        f"{len(ntru_truth) + 2} bootstraps x {pn.lwe_dim} steps, no forward32 / inverse32 "
        f"(the NTT evk's old route); the same NAND words on both forms; mxu8_forward32 "
        f"{counts_kg['mxu8_forward32']} (evk preparation)")
    qv = keys.evk
    quot_ms = cuda_ms(torch, lambda: narrow_u32(cmux_mxu.shoup_precons(qv, (qn,), 0)).contiguous(),
                      5)
    narrow_ms = cuda_ms(torch, lambda: narrow_u32(qv).contiguous(), 5)
    log(f"[{smi}] the NTT evk's Shoup quotients, made once a rotation on the card "
        f"(shoup_precons and the int32 narrowing): {quot_ms:.4f} ms for {qv.numel()} words "
        f"({qv.numel() * 8 / 1e6:.1f} MB int64 read, {qv.numel() * 4 / 1e6:.1f} MB int32 out); "
        f"the values' narrowing, which both forms make: {narrow_ms:.4f} ms (CUDA events, mean "
        f"of 5)")
    evk_c = torch.randint(0, qn, (pn.lwe_dim, pn.level, nn), generator=gen_n, device=dev)
    prep_n_s = min(wall_ms(torch, lambda: ntru_cmux_mxu.prepare_mxu_evk(kctx, evk_c), 3)) / 1e3
    log(f"evk preparation (prepare_mxu_evk: kernel C over {pn.lwe_dim * pn.level} rows, Shoup "
        f"quotients): {prep_n_s:.4f} s (least of 3)")
    del evk_c
    nerr = torch.cat(n_errors).double()
    nstd = nerr.std().item()
    log(f"NTRU gate output phase error over {nerr.numel()} outputs: std {nstd:.1f} "
        f"(2^{torch.log2(torch.tensor(nstd)).item():.2f}), max |e| {nerr.abs().max().item():.0f}; "
        f"decision margin (q/8)/std = {qn / 8 / nstd:.2f}; noise record "
        f"NOISE_CHECK_NTRU_r05.json measured std {NTRU_NOISE_RECORD} (a noise figure, not a speed)")

    ct_n = keys.encrypt([1, 0], gen_n)
    switched = nbr.modulus_switch_q(ct_n, kctx, pn.log_n + 1)
    tpn = nbr.ntru_test_polynomial(nn, qn, nt, dev)
    rot_b = nbr.ntru_blind_rotate(kctx, keys.evk_mxu, switched, tpn)
    rot_n = nbr.ntru_blind_rotate(kctx, keys.evk, switched, tpn)
    t0 = time.perf_counter()
    rot_c = nbr.ntru_blind_rotate(kctx, tuple(x.cpu() for x in keys.evk_mxu), switched.cpu(),
                                  tpn.cpu())
    cpu_n_s = time.perf_counter() - t0
    ext = [nbr.extract_lwe_ntru(r, qn).cpu() for r in (rot_b, rot_n, rot_c)]
    if not (torch.equal(ext[0], ext[1]) and torch.equal(ext[0], ext[2])):
        raise AssertionError("NTRU bootstraps on the MXU evk, the NTT evk and the CPU differ")
    log(f"one NTRU bootstrap (2 ciphertexts, {pn.lwe_dim} steps) through kernel B on the MXU "
        f"evk, on the NTT evk and through the plain versions on the cpu: the same "
        f"{ext[0].numel()} words; cpu plain took {cpu_n_s:.2f} s")

    def time_ntru(kind, evk, label, bits):
        nargs = (kctx, evk, keys.ksk, keys.ks_basis)
        xa, xb = keys.encrypt(bits, gen_n), keys.encrypt(bits.flip(0), gen_n)
        want = ~(bits.bool() & bits.flip(0).bool())
        nand_const = torch.zeros(pn.lwe_dim + 1, dtype=torch.int64, device=dev)
        nand_const[-1] = 5 * nt % qn
        sw = nbr.modulus_switch_q(sub32(add32(xa, xb, qn), nand_const, qn), kctx, pn.log_n + 1)

        def boot():  # the gate's bootstrap: blind rotation, extraction, mask negation
            acc = nbr.ntru_blind_rotate(kctx, evk, sw, tpn)
            mask = neg32(nbr.extract_lwe_ntru(acc, qn), qn)
            return torch.cat([mask, torch.zeros_like(mask[..., :1])], dim=-1)

        def check(out):
            if not torch.equal(keys.decrypt(out), want):
                raise AssertionError(f"NTRU NAND {label}: wrong truth table")

        return time_gate(
            torch, f"NTRU NAND {label}", lambda: ntru_gates.ntru_nand(*nargs, xa, xb), boot,
            lambda big: nbr.ntru_key_switch(kctx, big, keys.ksk, keys.ks_basis), check,
            pn.lwe_dim)

    nbits64 = torch.randint(0, 2, (BATCH,), generator=gen_n, device=dev)
    ntru_rates = {}
    for kind, evk in (("mxu", keys.evk_mxu), ("ntt", keys.evk)):
        lat_n = time_ntru(kind, evk, f"{kind} evk, batch 1", torch.tensor([1], device=dev))
        rate_n = time_ntru(kind, evk, f"{kind} evk, batch {BATCH}", nbits64)
        ntru_rates[kind] = (lat_n, BATCH / (rate_n / 1e3))
        log(f"[{smi}] [ntru {kind} evk] single-gate latency (batch 1): {lat_n:.2f} ms; NAND "
            f"gates/s at batch {BATCH}: {BATCH / (rate_n / 1e3):.1f}")
    lat_ratio, rate_ratio = (ntru_rates["ntt"][i] / ntru_rates["mxu"][i] for i in (0, 1))
    log(f"[{smi}] NTRU NAND, NTT evk / MXU evk: latency {lat_ratio:.3f}, gates/s "
        f"{rate_ratio:.3f}; the quotients' "
        f"{quot_ms:.4f} ms are {quot_ms / ntru_rates['ntt'][0]:.4f} of the NTT evk's batch-1 gate")

    # -- phase 10: the RNS/DCRT blind rotation --------------------------------
    log("== phase 10: RNS/DCRT blind rotation at N=4096, 2 x 50-bit moduli, L=4, n_lwe=630")
    counts_d, dcrt_state = phase10_dcrt(torch, dev, table)

    # -- phases 11-13 ----------------------------------------------------------
    log("== phase 11: the negacyclic product by a fixed NTT-domain operand (bench.py's shape)")
    counts_rt = phase11_roundtrip(torch, dev, table)
    log("== phase 12: the large-n four-step NTT at n = 2^16, q < 2^62")
    phase12_large(torch, dev)
    log("== phase 13: rotation and CMux front end at BOOLEAN_128 width")
    counts_f = phase13_front(torch, dev, table, conv, basis, ctx.bsk[0], counted)

    # -- phases 14-15: the mesh layer on one card -------------------------------
    log(f"== phase 14: the residue- and batch-sharded DCRT rotation on a LocalMesh "
        f"{SHARD_MESH}, phase 10's width")
    counts_s = phase14_sharded(torch, dev, table, dcrt_state)
    del dcrt_state
    log("== phase 15: the coefficient-sharded NTT on LocalMeshes")
    counts_c = phase15_coeff(torch, dev, table)

    # -- phases 16-18: row 13, the 32-bit DCRT sharding, the 64-bit torus ------
    log("== phase 16: row 13, the coefficient-sharded byte-radix NTT around one all_to_all")
    counts_x = phase16_sharded_mxu(torch, dev, table)
    log(f"== phase 17: the sharded 32-bit DCRT path at BOOLEAN_128 width, LocalMesh "
        f"{SHARD_DCRT_MESH}")
    counts_17 = phase17_sharded_dcrt32(torch, dev, conv, basis, ctx.bsk[0])
    log("== phase 18: the 64-bit torus external product at BOOLEAN_128's ring")
    counts_18 = phase18_torus64(torch, dev, p)

    # -- phase 19: circuit bootstrapping ---------------------------------------
    log("== phase 19: circuit bootstrapping (LWE bit -> GGSW), the leveled MUX and the packing "
        "switch at BOOLEAN_128 width, NTT key")
    counts_cb = phase19_circuit_bootstrap(torch, dev, ctx, smi, boot_cpu_s, reset_counts,
                                          read_counts)

    # -- phase 20: keys saved and reloaded, noise-tracked gates ----------------
    log("== phase 20: save_keys / load_keys onto the card, tracked NAND/AND/OR at batch "
        f"{BATCH}, the host layer (modops, compact, samplers, containers, contracts, secrets)")
    counts_tr = phase20_tracked(torch, dev, ctx, smi, reset_counts, read_counts)

    # -- phase 21: the NTT-key rotation past the one-launch step's caps --------
    log(f"== phase 21: kernels 1-2 at log_n 15-{TOP_LOG_N}, kernel H and the staged CMux step, "
        f"{MSG_BITS}-bit programmable bootstraps at N = 2^{WIDE_LOG_N} and 2^{TOP_LOG_N}")
    counts_21, pbs_21, counts_21_top = phase21_staged(torch, dev, table, ctx, smi, reset_counts,
                                                      read_counts)

    # -- phase 22: the MXU key and the NTRU MXU evk past kernels A-C's caps -----
    log(f"== phase 22: the MXU key past kernel A (N = 4096 on the fused step, 2^{WIDE_LOG_N} on "
        f"the staged route), kernel C's route at log_n 13-{TOP_LOG_N}, NTRU at N = "
        f"2^{NTRU_WIDE_LOG_N} and 2^{TOP_LOG_N} on kernels I, 1 and J")
    counts_22 = phase22_mxu_ntru(torch, dev, table, smi, pbs_21, reset_counts, read_counts)

    # -- phase 23: DCRT bases past four moduli ---------------------------------
    log(f"== phase 23: the DCRT layer at N = {1 << DCRT_LOG_N} over {MODULI_COUNTS} moduli of 50 "
        f"bits, the u64 kernels a group of four moduli a launch")
    counts_23 = phase23_dcrt_moduli(torch, dev, table)
    log(f"== phase 23.7: the u64 transforms at log_n {ROW9_WIDE_LOG_N[0]}-{ROW9_WIDE_LOG_N[-1]} "
        f"(a row over a cluster past 14), the DCRT steps at N = "
        f"{[1 << log_n for log_n in ROW9_DCRT_LOG_N]}, kernel E at {RT_BATCH} x 2^{RT_WIDE_LOG_N}")
    counts_23w = phase23_row9_wide(torch, dev, table)

    # -- phase 24: rings past a cluster, the four-step through device memory ---
    log(f"== phase 24: the four-step past 2^17: kernels 1-2, the u64 transforms, F, G and the "
        f"split H and J at log_n {FS_LOG_N}, a {MSG_BITS}-bit programmable bootstrap at N = "
        f"2^{FS_PBS_LOG_N}")
    counts_24 = phase24_four_step(torch, dev, table, smi, reset_counts, read_counts)

    end_phase()

    # -- the kernel table -----------------------------------------------------
    # name -> (source, TPU kernel, launches on its main path, the table key of
    # the "ms" shape, the batch of the extra "ms_b" columns or None)
    dcrt = (1, DCRT_BATCH)
    sources = {
        "ntt32_forward": ("ntt32.cu", "ops/ntt_pallas.py:848", counts["forward32"], (1, BATCH)),
        "ntt32_inverse": ("ntt32.cu", "ops/ntt_pallas.py:855", counts["inverse32"], (1, BATCH)),
        "fused_cmux_step": ("cmux_fused.cu", ("ops/cmux_fused.py:140", "ops/cmux_fused.py:226"),
                            counts["fused_cmux_step"], (1, BATCH)),
        "mxu_cmux_step": ("cmux_mxu.cu", "ops/cmux_mxu.py:621", counts_m["mxu_cmux_step"],
                          (1, BATCH)),
        "ntru_cmux_step": ("cmux_mxu.cu", "ops/ntru_cmux_mxu.py:259", counts_n["ntru_cmux_step"],
                           (1, BATCH)),
        "mxu8_forward32": ("ntt32.cu", "ops/ntt_mxu8.py:917",
                           counts_m["mxu8_forward32"] + counts_n["mxu8_forward32"], (1, BATCH)),
        "ntt64_forward": ("ntt64.cu", "ops/ntt_pallas.py:486", counts_d["ntt64_forward"], dcrt),
        "ntt64_inverse": ("ntt64.cu", "ops/ntt_pallas.py:494", counts_d["ntt64_inverse"], dcrt),
        "mxu8_forward64": ("ntt_mxu8.cu", "ops/ntt_mxu8.py:917", counts_d["mxu8_forward64"], dcrt),
        "mxu8_inverse64": ("ntt_mxu8.cu", "ops/ntt_mxu8.py:959", counts_d["mxu8_inverse64"], dcrt),
        "mxu8_inverse64_mul": ("ntt_mxu8.cu", "ops/ntt_mxu8.py:968",
                               counts_rt["mxu8_inverse64_mul"], (RT_BATCH, None)),
        "mxu8_roundtrip64_mul": ("ntt64.cu", "ops/ntt_mxu8.py:977",
                                 counts_rt["mxu8_roundtrip64_mul"], (RT_BATCH, None)),
        "rotate": ("cmux_front.cu", "ops/rotate_pallas.py:29", counts["rotate"], (BATCH, None)),
        "cmux_front": ("cmux_front.cu", "ops/cmux_pallas.py:74", counts_f["cmux_front"],
                       (BATCH, 1)),
        "ntt32_stages_forward": ("ntt_stages.cu", "ops/ntt_pallas.py:620",
                                 counts_c["ntt32_stages_forward"], (CS_ROWS32, None)),
        "ntt32_stages_inverse": ("ntt_stages.cu", "ops/ntt_pallas.py:629",
                                 counts_c["ntt32_stages_inverse"], (CS_ROWS32, None)),
        "ntt64_stages_forward": ("ntt_stages.cu", "ops/ntt_pallas.py:675",
                                 counts_c["ntt64_stages_forward"], (LARGE_ROWS, None)),
        "ntt64_stages_inverse": ("ntt_stages.cu", "ops/ntt_pallas.py:683",
                                 counts_c["ntt64_stages_inverse"], (LARGE_ROWS, None)),
        "split_k1": ("ntt_mxu8_split.cu", "parallel/coeff_sharded_mxu.py:131",
                     counts_x["split_k1"], (RT_BATCH, None)),
        "split_k2": ("ntt_mxu8_split.cu", "parallel/coeff_sharded_mxu.py:184",
                     counts_x["split_k2"], (RT_BATCH, None)),
        "split_ki1": ("ntt_mxu8_split.cu", "parallel/coeff_sharded_mxu.py:229",
                      counts_x["split_ki1"], (RT_BATCH, None)),
        "split_ki2": ("ntt_mxu8_split.cu", "parallel/coeff_sharded_mxu.py:297",
                      counts_x["split_ki2"], (RT_BATCH, None)),
        "cmux_stage2": ("cmux_stage2.cu", "ops/cmux_fused.py:226", counts_21["cmux_stage2"],
                        (1, WIDE_BATCH)),
        "ntru_digits": ("ntru_stage.cu", "ops/ntru_cmux_mxu.py:259",
                        counts_22["ntru"]["ntru_digits"], (1, NTRU_WIDE_BATCH)),
        "ntru_stage2": ("ntru_stage.cu", "ops/ntru_cmux_mxu.py:259",
                        counts_22["ntru"]["ntru_stage2"], (1, NTRU_WIDE_BATCH)),
        # the four-step's launches past 2^17 (phase 24; their rows at N = 2^18)
        "ntt_columns_forward": ("ntt_columns.cu", ("ops/ntt_pallas.py:848",
                                                   "ops/ntt_pallas.py:486"),
                                counts_24["pbs"]["columns_forward"], (WIDE_BATCH, None)),
        "ntt_columns_inverse": ("ntt_columns.cu", ("ops/ntt_pallas.py:855",
                                                   "ops/ntt_pallas.py:494"),
                                counts_24["dcrt"][1 << FS_PBS_LOG_N]["columns_inverse"],
                                (WIDE_BATCH, None)),
        "mac_sub": ("ntt_columns.cu", ("ops/cmux_fused.py:226", "ops/ntru_cmux_mxu.py:259"),
                    counts_24["pbs"]["mac_sub"], (1, WIDE_BATCH)),
        "cmux_stage2_cols": ("cmux_stage2.cu", "ops/cmux_fused.py:226",
                             counts_24["pbs"]["cmux_stage2_cols"], (1, WIDE_BATCH)),
        "ntru_finish": ("ntru_stage.cu", "ops/ntru_cmux_mxu.py:259",
                        counts_24["ntru"]["ntru_finish"], (1, NTRU_WIDE_BATCH)),
    }
    kernels = []
    for name, (src, rep, launches, (b0, bb)) in sources.items():
        if launches < 1:
            raise AssertionError(f"{name} was never launched on its main path")
        err, ms, plain_ms, dev_ms, (bound_ms, bound_by) = table[name][b0]
        row = {
            "name": name, "route": "cuda", "source": f"primus_fhe_tpu_torch/csrc/{src}",
            "replaces": ", ".join(f"primus_fhe_tpu/{r}" for r in
                                  ((rep,) if isinstance(rep, str) else rep)),
            "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "batch": b0, "device_ms": dev_ms,
        }
        if bb is not None:
            eb, msb, pmsb, devb, (bmsb, bbyb) = table[name][bb]
            row["max_abs_err"] = max(err, eb)
            row.update({f"ms_b{bb}": msb, f"plain_ms_b{bb}": pmsb, f"device_ms_b{bb}": devb,
                        f"bound_ms_b{bb}": bmsb, f"bound_by_b{bb}": bbyb})
        if name == "ntru_cmux_step":  # phase 9's gates on the NTT evk
            row["launches_ntt_evk_path"] = counts_nt["ntru_cmux_step"]
        cb_name = {"ntt32_forward": "forward32", "ntt32_inverse": "inverse32",
                   "fused_cmux_step": "fused_cmux_step", "rotate": "rotate"}.get(name)
        if cb_name:  # phase 19's circuit bootstrap, ggsw_to_ntt and MUX, both bits
            row["launches_cb_path"] = counts_cb[cb_name]
        if name in ("fused_cmux_step", "rotate"):  # phase 20's three tracked gates
            row["launches_tracked_path"] = counts_tr[name]
        path22 = {"ntt32_forward": "forward32", "cmux_front": "cmux_front",
                  "cmux_stage2": "cmux_stage2", "rotate": "rotate",
                  "mxu_cmux_step": "mxu_cmux_step"}.get(name)
        if path22:  # 22.4's programmable bootstrap at N = 2^15 on the MXU key
            row["launches_mxu_staged_path"] = counts_22["mxu"][path22]
        if name in ("fused_cmux_step", "rotate", "mxu_cmux_step"):  # 22.3's NAND at N = 4096
            row["launches_mxu_4096_path"] = counts_22["mxu4096"][name]
        path22 = {"ntt32_forward": "forward32", "ntru_digits": "ntru_digits",
                  "ntru_stage2": "ntru_stage2", "ntru_cmux_step": "ntru_cmux_step"}.get(name)
        if path22:  # 22.5's rotation at N = 2^13
            row["launches_ntru_staged_path"] = counts_22["ntru"][path22]
        if name in ("ntt32_forward", "ntt32_inverse"):  # phases 17-18's and 21.3's paths
            key = name.replace("ntt32_", "") + "32"
            row.update({"launches_sharded_dcrt32_path": counts_17[key],
                        "launches_torus64_path": counts_18[key],
                        "launches_staged_path": counts_21[key]})
        for log_n, kp in ((15, 2), (16, 3)):  # kernels 1-2 over a cluster (21.1), 16 rows
            if f"{name}@log{log_n}kp{kp}" in table:
                _, lms, lpms, ldev, (lbms, lbby) = table[f"{name}@log{log_n}kp{kp}"][WIDE_BATCH]
                row.update({f"ms_log{log_n}": lms, f"plain_ms_log{log_n}": lpms,
                            f"device_ms_log{log_n}": ldev, f"bound_ms_log{log_n}": lbms,
                            f"bound_by_log{log_n}": lbby})
        for tag in ("w15", "w16"):  # row 11 on the n = 2^16, 2^17 shards over D = 2
            if f"{name}@{tag}" in table:
                _, wms, wpms, wdev, (wbms, _) = table[f"{name}@{tag}"][LARGE_ROWS]
                row.update({f"ms_{tag}": wms, f"plain_ms_{tag}": wpms, f"device_ms_{tag}": wdev,
                            f"bound_ms_{tag}": wbms})
        if f"{name}@n14" in table:  # K1 / Ki2 at phase 16.5's D = 2 shard, n = 2^14
            _, nms, npms, ndev, (nbms, _) = table[f"{name}@n14"][b0]
            row.update({"ms_n14": nms, "plain_ms_n14": npms, "device_ms_n14": ndev,
                        "bound_ms_n14": nbms})
        for tag, rows_k in (("bsk", KEY_ROWS["bsk"]), ("evk", KEY_ROWS["evk"]),
                            ("start", BATCH), ("1024", F_ROWS)):
            # C and kernel 1 at the key preparations' sizes; F at the
            # bootstrap's start and F and G at 1024 x 2 rows
            if f"{name}@{tag}" in table:
                _, kms, kpms, kdev, (kbms, kbby) = table[f"{name}@{tag}"][rows_k]
                row.update({f"ms_{tag}": kms, f"plain_ms_{tag}": kpms, f"device_ms_{tag}": kdev,
                            f"bound_ms_{tag}": kbms, f"bound_by_{tag}": kbby})
        if f"{name}@nodigits" in table:  # J without the next step's digits
            for bsz_ in (1, NTRU_WIDE_BATCH):
                _, kms, kpms, kdev, (kbms, _) = table[f"{name}@nodigits"][bsz_]
                row.update({f"ms_nodigits_b{bsz_}": kms, f"device_ms_nodigits_b{bsz_}": kdev,
                            f"bound_ms_nodigits_b{bsz_}": kbms})
        if f"{name}@nokey" in table:  # Ki1 without the fused key multiply
            _, kms, kpms, kdev, (kbms, _) = table[f"{name}@nokey"][b0]
            row.update({"ms_nokey": kms, "plain_ms_nokey": kpms, "device_ms_nokey": kdev,
                        "bound_ms_nokey": kbms})
        if f"{name}@rt" in table:  # row 10 on phase 11's butterfly route, 512 rows
            _, rms, rpms, rdev, (rbms, rbby) = table[f"{name}@rt"][RT_BATCH]
            row.update({"launches_roundtrip_path": counts_rt[name], "ms_rt": rms,
                        "plain_ms_rt": rpms, "device_ms_rt": rdev, "bound_ms_rt": rbms,
                        "bound_by_rt": rbby})
        for m in MODULI_COUNTS:  # phase 23's bases past four moduli, batch 2
            if f"{name}@m{m}" in table:
                _, mms, mpms, mdev, (mbms, _) = table[f"{name}@m{m}"][MODULI_BATCH]
                row.update({f"launches_dcrt_m{m}_path": counts_23[m][name], f"ms_m{m}": mms,
                            f"plain_ms_m{m}": mpms, f"device_ms_m{m}": mdev,
                            f"bound_ms_m{m}": mbms})
        # the rings this slice opened: kernels 1-2 at 2^17 (21.1: kp 2 and 3 at
        # 16 rows, the staged PBS's 12 / 192 rows), H, I and J at 2^17 (21.2,
        # 22.6), row 11 at log_w 17 (15.4), rows 9 and 10 at log_n 13-17 (23.7),
        # E at 512 x 2^16, 2^17 (23.9)
        wide_tags = [(f"log{TOP_LOG_N}kp2", WIDE_BATCH), (f"log{TOP_LOG_N}kp3", WIDE_BATCH),
                     (f"pbs{TOP_LOG_N}", 1), (f"pbs{TOP_LOG_N}", WIDE_BATCH),
                     (f"log{TOP_LOG_N}", 1), (f"log{TOP_LOG_N}", WIDE_BATCH),
                     (f"ntru{TOP_LOG_N}", 1), (f"ntru{TOP_LOG_N}", NTRU_WIDE_BATCH),
                     (f"w{CS_TOP_LOG_N - 1}", LARGE_ROWS)]
        wide_tags += [(f"log{log_n}", r) for log_n in ROW9_WIDE_LOG_N for r in ROW9_ROWS]
        wide_tags += [(f"rt{log_n}", RT_BATCH) for log_n in RT_WIDE_LOG_N]
        wide_tags += [(f"shard{log_n}", r) for log_n in CLUSTER_LOG_N for r in (64, 16)]
        # phase 24's rings past 2^17: kernels 1-2 (kp 2 and 3 at 16 rows, the
        # 2^18 PBS's 18 / 288 rows), H, F, G and the new launches (batch 1
        # and 16), J and ntru_finish, the u32 and u64 column kernels, rows 9,
        # 10 and 12, D and E (23.7's shapes), E at 512 x 2^18
        wide_tags += [(f"fs{L}kp{kp}", WIDE_BATCH) for L in FS_LOG_N for kp in (2, 3)]
        wide_tags += [(f"pbs{FS_PBS_LOG_N}", 1), (f"pbs{FS_PBS_LOG_N}", WIDE_BATCH)]
        wide_tags += [(f"fs{L}", b) for L in FS_LOG_N for b in (1, WIDE_BATCH)]
        wide_tags += [(f"ntru{L}", b) for L in FS_LOG_N for b in (1, NTRU_WIDE_BATCH)]
        wide_tags += [(f"fs{L}u64", r) for L in FS_LOG_N for r in ROW9_ROWS]
        wide_tags += [(f"log{L}", r) for L in FS_LOG_N for r in ROW9_ROWS]
        wide_tags += [(f"shard{L}", r) for L in FS_LOG_N for r in (64, 16)]
        wide_tags += [(f"rt{FS_PBS_LOG_N}", RT_BATCH)]
        for tag, bsz_ in wide_tags:
            if bsz_ in table.get(f"{name}@{tag}", {}):
                _, xms, xpms, xdev, (xbms, xbby) = table[f"{name}@{tag}"][bsz_]
                sfx = f"{tag}_b{bsz_}"
                row.update({f"ms_{sfx}": xms, f"plain_ms_{sfx}": xpms, f"device_ms_{sfx}": xdev,
                            f"bound_ms_{sfx}": xbms, f"bound_by_{sfx}": xbby})
        path_top = {"ntt32_forward": "forward32", "cmux_front": "cmux_front",
                    "cmux_stage2": "cmux_stage2", "rotate": "rotate"}.get(name)
        if path_top:  # 21.5's programmable bootstrap at N = 2^17
            row[f"launches_pbs{TOP_LOG_N}_path"] = counts_21_top[path_top]
        path_top = {"ntt32_forward": "forward32", "ntru_digits": "ntru_digits",
                    "ntru_stage2": "ntru_stage2"}.get(name)
        if path_top:  # 22.6's rotation at N = 2^17
            row[f"launches_ntru{TOP_LOG_N}_path"] = counts_22["ntru_top"][path_top]
        path_fs = {"ntt32_forward": "forward32", "cmux_front": "cmux_front", "rotate": "rotate",
                   "ntt_columns_forward": "columns_forward", "mac_sub": "mac_sub",
                   "cmux_stage2_cols": "cmux_stage2_cols"}.get(name)
        if path_fs:  # 24.6's programmable bootstrap at N = 2^18
            row[f"launches_pbs{FS_PBS_LOG_N}_path"] = counts_24["pbs"][path_fs]
        path_fs = {"ntt32_forward": "forward32", "ntt_columns_forward": "columns_forward",
                   "mac_sub": "mac_sub", "ntt_columns_inverse": "columns_inverse",
                   "ntru_finish": "ntru_finish", "ntru_digits": "ntru_digits"}.get(name)
        if path_fs:  # 24.4's 8 NTRU steps at N = 2^18, batch 1
            row[f"launches_ntru{FS_PBS_LOG_N}_path"] = counts_24["ntru"][path_fs]
        if name in ("mxu8_forward64", "mxu8_inverse64", "ntt_columns_forward",
                    "ntt_columns_inverse"):  # 24.8: N = 2^18 on "mxu8"
            row[f"launches_dcrt{1 << FS_PBS_LOG_N}_path"] = \
                counts_24["dcrt"][1 << FS_PBS_LOG_N][name.replace("ntt_", "")]
        if name in ("mxu8_forward64", "mxu8_inverse64"):  # 23.8: N = 8192, 65536 on "mxu8"
            for dcrt_n, dcrt_counts in counts_23w.items():
                row[f"launches_dcrt{dcrt_n}_path"] = dcrt_counts[name]
        if f"{name}@shard" in table:  # row 12: the same kernels on a residue shard's tables
            _, sms, spms, sdev, (sbms, _) = table[f"{name}@shard"][DCRT_BATCH // SHARD_MESH[1]]
            row.update({"launches_sharded_path": counts_s[name], "ms_sharded_path": sms,
                        "plain_ms_sharded_path": spms, "device_ms_sharded_path": sdev,
                        "bound_ms_sharded_path": sbms})
        kernels.append(row)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
