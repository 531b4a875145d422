#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``primus_fhe_tpu_torch``) on one
NVIDIA card, at the full BOOLEAN_128 profile (N=2048, n_lwe=630, bootstrap
gadget 2^7 x 3, key-switch gadget 2^1 x 12).

Run from the repository root:  ``python3 chip_smoke.py``

Phases (each prints its own lines; any failure raises and the exit code is
non-zero):

1. device facts (``nvidia-smi`` name and power limit, torch and CUDA
   versions) and the kernel build from ``primus_fhe_tpu_torch/csrc``;
2. each of the four kernels against its plain PyTorch version on the same
   CUDA inputs, at the main path's shapes, batch 1 and 64 (bit-equal), with
   both times from CUDA events and the kernel's device time from
   ``torch.profiler``;
3. ``make_context(BOOLEAN_128)`` on the card from a seeded generator;
4. NAND/AND/OR truth tables, NOT, and NAND(NAND(a,b), NAND(a,b)) == AND(a,b),
   key switch included, with the measured phase error beside the noise
   model's prediction;
5. one bootstrap through the kernels on the card and through the plain
   versions on the CPU, same keys and input: the same words;
6. the launch counts of phases 3-4: every kernel launched, and the CMux
   kernels exactly once per key slice per bootstrap;
7. single-gate latency at batch 1 and gates/s at batch 64 (truth-checked),
   each split into bootstrap and key switch, with the device's busy time
   and top kernels from ``torch.profiler``.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

SEED = 2026
BATCH = 64
LAT_REPS = 5
KERNEL_REPS = 20


def log(msg: str) -> None:
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


def device_time(torch, fn, reps: int):
    """Device time (ms) of ``fn`` per run, summed over the kernels that
    ``torch.profiler`` sees in ``reps`` runs, and the per-kernel rows
    ``(ms total, count, name)``; ``(None, [])`` if it saw none.  Only
    device-side rows count: a host op's row repeats its kernels' time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [
        (e.self_device_time_total / 1e3, e.count, e.key)
        for e in prof.key_averages()
        if e.device_type != DeviceType.CPU and e.self_device_time_total > 0
    ]
    if not rows:
        return None, []
    return sum(r[0] for r in rows) / reps, sorted(rows, reverse=True)


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


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this run needs a CUDA card")

    from primus_fhe_tpu_torch import params as P
    from primus_fhe_tpu_torch.boot import gates
    from primus_fhe_tpu_torch.boot.blind_rotate import bootstrap
    from primus_fhe_tpu_torch.decompose import ApproxSignedBasis32
    from primus_fhe_tpu_torch.lattice import keyswitch, tfhe
    from primus_fhe_tpu_torch.ops import build, cmux_fused, ntt32

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
    log(f"kernel build: {so.name} in {build_s:.2f} s")
    for line in build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    p = P.BOOLEAN_128
    basis = ApproxSignedBasis32(None, p.log_basis, reverse_length=p.level)
    conv = tfhe.make_convolver(p.log_n, p.level, p.glwe_dim, p.log_basis)
    n, kp, k1, level = p.n, conv.count, p.glwe_dim + 1, p.level
    log(f"BOOLEAN_128: N={n} n_lwe={p.lwe_dim} primes={conv.primes} L={level} k1={k1}")

    # -- phase 2: kernels against their plain versions -----------------------
    log("== phase 2: kernels vs plain versions (bit-equal)")
    g = torch.Generator(device=dev).manual_seed(SEED)
    qs = torch.tensor(conv.primes, dtype=torch.int64, device=dev).reshape(kp, 1, 1)

    def residues(rows, factor):
        r = torch.randint(0, 1 << 40, (kp, rows, n), generator=g, device=dev)
        return r % (factor * qs)

    def words(*shape):
        return torch.randint(0, 1 << 32, shape, generator=g, device=dev)

    table = {}
    for bsz in (1, BATCH):
        rows = bsz * k1
        x_fwd = residues(rows, 4)
        x_inv = residues(rows, 2)
        acc = words(bsz, k1, n)
        degrees = torch.randint(0, 2 * n, (bsz,), generator=g, device=dev, dtype=torch.int32)
        key = torch.randint(0, 1 << 40, (kp, k1, level, k1, n), generator=g, device=dev)
        key = key % qs.reshape(kp, 1, 1, 1, 1)
        f = cmux_fused.cmux_stage1_plain(conv, basis, acc, degrees)
        # kernel wrappers on int64 words (checked: narrow + kernel + widen)
        # and on int32 storage (timed: what the blind-rotation loop passes)
        x_fwd32, x_inv32, acc32, f32, key32 = (
            t.to(torch.int32) for t in (x_fwd, x_inv, acc, f, key)
        )
        cases = {
            "ntt32_forward": (
                lambda: ntt32.forward32(conv.ntt, x_fwd),
                lambda: ntt32.forward32(conv.ntt, x_fwd32),
                lambda: ntt32.forward32_plain(conv.ntt, x_fwd),
            ),
            "ntt32_inverse": (
                lambda: ntt32.inverse32(conv.ntt, x_inv),
                lambda: ntt32.inverse32(conv.ntt, x_inv32),
                lambda: ntt32.inverse32_plain(conv.ntt, x_inv),
            ),
            "cmux_stage1": (
                lambda: cmux_fused.cmux_stage1(conv, basis, acc, degrees),
                lambda: cmux_fused.cmux_stage1(conv, basis, acc32, degrees),
                lambda: cmux_fused.cmux_stage1_plain(conv, basis, acc, degrees),
            ),
            "cmux_stage2": (
                lambda: cmux_fused.cmux_stage2(conv, f, key, acc),
                lambda: cmux_fused.cmux_stage2(conv, f32, key32, acc32),
                lambda: cmux_fused.cmux_stage2_plain(conv, f, key, acc),
            ),
        }
        for name, (kern, kern32, plain) in cases.items():
            got, want = kern(), plain()
            got32 = kern32()
            torch.cuda.synchronize()
            err = int((got - want).abs().max())
            if not torch.equal(got, want):
                raise AssertionError(f"{name} batch {bsz}: kernel != plain (max abs err {err})")
            if not torch.equal(got32.to(torch.int64) & 0xFFFFFFFF, want):
                raise AssertionError(f"{name} batch {bsz}: int32-storage kernel != plain")
            ms = cuda_ms(torch, kern32, KERNEL_REPS)
            plain_ms = cuda_ms(torch, plain, KERNEL_REPS)
            dev_ms, _ = device_time(torch, kern32, KERNEL_REPS)
            dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
            log(f"{name:14s} batch {bsz:3d} shape {tuple(got.shape)}: bit-equal; "
                f"wrapper {ms:.4f} ms (device {dev_txt}), plain {plain_ms:.4f} ms")
            table.setdefault(name, {})[bsz] = (err, ms, plain_ms, dev_ms)

    # -- phases 3-4: the main path, counted ----------------------------------
    counted = (ntt32.forward32, ntt32.inverse32, cmux_fused.cmux_stage1, cmux_fused.cmux_stage2)
    for fn in counted:
        fn.launches = 0

    log("== phase 3: make_context(BOOLEAN_128) on the card")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctx = P.make_context(p, dev, gen)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    log(f"keygen: {keygen_s:.3f} s; bsk {tuple(ctx.bsk.shape)}, ksk {tuple(ctx.ksk.shape)}")

    log("== phase 4: gates at full width, key switch included")
    args = (ctx.conv, ctx.basis, ctx.bsk, ctx.ksk, ctx.ks_basis)
    a_bits = torch.tensor([0, 0, 1, 1], device=dev)
    b_bits = torch.tensor([0, 1, 0, 1], device=dev)
    ca, cb = ctx.encrypt(a_bits, gen), ctx.encrypt(b_bits, gen)
    truth = {
        "nand_gate": lambda a, b: ~(a & b),
        "and_gate": lambda a, b: a & b,
        "or_gate": lambda a, b: a | b,
    }
    bootstraps = 0
    errors = []

    def check(label, out, want_bits):
        got = ctx.decrypt(out)
        mu = torch.where(want_bits, gates.TRUE_MU, -gates.TRUE_MU)
        errors.append(ctx.phase(out) - mu)
        log(f"{label}: got {got.int().tolist()} want {want_bits.int().tolist()}")
        if not torch.equal(got, want_bits):
            raise AssertionError(f"{label}: wrong truth table")

    for name, fn in truth.items():
        out = getattr(gates, name)(*args, ca, cb, p.log_n)
        bootstraps += 1
        check(f"{name} (a,b)=(00,01,10,11)", out, fn(a_bits.bool(), b_bits.bool()))
    check("not_gate (0,1)", gates.not_gate(ctx.encrypt(torch.tensor([0, 1], device=dev), gen)),
          torch.tensor([True, False], device=dev))
    nand = gates.nand_gate(*args, ca, cb, p.log_n)
    comp = gates.nand_gate(*args, nand, nand, p.log_n)
    bootstraps += 2
    check("NAND(NAND(a,b),NAND(a,b)) == AND(a,b)", comp, a_bits.bool() & b_bits.bool())
    torch.cuda.synchronize()
    counts = {fn.__name__: fn.launches for fn in counted}

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
    cpu_s = time.perf_counter() - t0
    if not torch.equal(out_gpu.cpu(), out_cpu):
        raise AssertionError("bootstrap on cuda and on cpu differ")
    log(f"{p.lwe_dim} steps: cuda and cpu outputs equal ({out_cpu.numel()} words); "
        f"cpu plain bootstrap took {cpu_s:.2f} s")

    # -- phase 6: launch counts of the main path -----------------------------
    log("== phase 6: launch counts of phases 3-4")
    log(json.dumps(counts))
    want_cmux = bootstraps * p.lwe_dim
    for name, c in counts.items():
        if c <= 0:
            raise AssertionError(f"{name} was never launched on the main path")
    for name in ("cmux_stage1", "cmux_stage2"):
        if counts[name] != want_cmux:
            raise AssertionError(f"{name}: {counts[name]} launches, want {want_cmux}")
    log(f"cmux_stage1/2: {want_cmux} = {bootstraps} bootstraps x {p.lwe_dim} steps (2 x {p.lwe_dim} "
        f"launches per bootstrap)")

    # -- phase 7: timings ----------------------------------------------------
    log("== phase 7: timings")

    def split(label, bits):
        xa = ctx.encrypt(bits, gen)
        xb = ctx.encrypt(bits.flip(0), gen)
        gate = lambda: gates.nand_gate(*args, xa, xb, p.log_n)  # noqa: E731
        if not torch.equal(ctx.decrypt(gate()), ~(bits.bool() & bits.flip(0).bool())):
            raise AssertionError(f"NAND {label}: wrong truth table")
        gate_ms = wall_ms(torch, gate, LAT_REPS)
        big = bootstrap(ctx.conv, ctx.basis, ctx.bsk, xa, tp, p.log_n)
        boot_ms = wall_ms(torch, lambda: bootstrap(ctx.conv, ctx.basis, ctx.bsk, xa, tp, p.log_n),
                          LAT_REPS)
        ks_ms = wall_ms(torch, lambda: keyswitch.key_switch(big, ctx.ksk, ctx.ks_basis), LAT_REPS)
        mean = sum(gate_ms) / len(gate_ms)
        log(f"NAND {label}: truth table correct; gate mean {mean:.2f} ms (min {min(gate_ms):.2f}); "
            f"bootstrap min {min(boot_ms):.2f} ms; key switch min {min(ks_ms):.2f} ms "
            f"(host clock, {LAT_REPS} runs each)")
        dev_ms, rows = device_time(torch, gate, 1)
        if dev_ms is None:
            log(f"NAND {label}: device time not measured (the profiler saw no device activity)")
        else:
            log(f"NAND {label}: device busy {dev_ms:.2f} ms of {mean:.2f} ms wall -> idle share "
                f"{1 - dev_ms / mean:.3f}; top device rows:")
            for ms_, count, key_ in rows[:6]:
                log(f"    {ms_:9.3f} ms  x{count:<5d} {key_[:90]}")
        return mean

    lat = split("batch 1", torch.tensor([1], device=dev))
    bits = torch.randint(0, 2, (BATCH,), generator=gen, device=dev)
    rate = split(f"batch {BATCH}", bits)
    log(f"single-gate latency (batch 1): {lat:.2f} ms; NAND gates/s at batch {BATCH}: "
        f"{BATCH / (rate / 1e3):.1f}")

    sources = {
        "ntt32_forward": ("primus_fhe_tpu_torch/csrc/ntt32.cu", "primus_fhe_tpu/ops/ntt_pallas.py:848"),
        "ntt32_inverse": ("primus_fhe_tpu_torch/csrc/ntt32.cu", "primus_fhe_tpu/ops/ntt_pallas.py:855"),
        "cmux_stage1": ("primus_fhe_tpu_torch/csrc/cmux_fused.cu", "primus_fhe_tpu/ops/cmux_fused.py:140"),
        "cmux_stage2": ("primus_fhe_tpu_torch/csrc/cmux_fused.cu", "primus_fhe_tpu/ops/cmux_fused.py:226"),
    }
    launch_key = {"ntt32_forward": "forward32", "ntt32_inverse": "inverse32",
                  "cmux_stage1": "cmux_stage1", "cmux_stage2": "cmux_stage2"}
    kernels = []
    for name, (src, rep) in sources.items():
        e1, ms1, pms1, dev1 = table[name][1]
        eb, msb, pmsb, devb = table[name][BATCH]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": counts[launch_key[name]], "max_abs_err": max(e1, eb),
            "ms": ms1, "plain_ms": pms1, "device_ms": dev1,
            f"ms_b{BATCH}": msb, f"plain_ms_b{BATCH}": pmsb, f"device_ms_b{BATCH}": devb,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
