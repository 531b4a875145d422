#!/usr/bin/env python3
"""Device time of kernels A (``mxu_cmux_step``), B (``ntru_cmux_step``) and
the NTT-key CMux step (``fused_cmux_step``, kernels 3-4) on one CUDA card, at
BOOLEAN_128 width (N = 2048, k = 1, L = 3, two primes) and NTRU_128 width
(N = 1024, q = 1038337, L = 6), batch 1 and 64; and the NTT-key blind
rotation at BOOLEAN_128 width (630 steps on a random canonical key): wall
ms, host us a step and the device's idle share.

    python3 cmux_mxu_timing.py                 # this checkout
    python3 cmux_mxu_timing.py --root DIR      # the package under DIR
    python3 cmux_mxu_timing.py --compare OLD   # OLD and this checkout in turns
    python3 cmux_mxu_timing.py --phases        # cycles per phase (clock64)

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


def run_here(stamps: bool) -> dict:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("cmux_mxu_timing: needs a CUDA card")
    dev = torch.device("cuda", 0)
    calls = kernels(torch, dev)
    result = {"root": str(Path(sys.path[0]).resolve()), "card": card(),
              "ms": {f"{k}@{b}": device_ms(torch, fn) for (k, b), fn in calls.items()}}
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, help="import primus_fhe_tpu_torch from this directory")
    ap.add_argument("--compare", type=Path, help="time OLD and this checkout in turns")
    ap.add_argument("--phases", action="store_true", help="cycles per phase, stamped copy")
    ap.add_argument("--stamps", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.root is not None:
        sys.path.insert(0, str(args.root.resolve()))
        print(json.dumps(run_here(args.stamps)), flush=True)
        return
    print(card(), flush=True)
    if args.phases:
        res = subprocess_run(stamped_copy(), "--stamps")
        for key, cyc in res["cycles"].items():
            print(key, json.dumps(cyc), flush=True)
        print(json.dumps(res), flush=True)
        return
    if args.compare is None:
        sys.path.insert(0, str(HERE))
        print(json.dumps(run_here(False)), flush=True)
        return
    runs = []
    for side, root in (("old", args.compare), ("new", HERE), ("new", HERE), ("old", args.compare)):
        res = subprocess_run(root)
        res["side"] = side
        runs.append(res)
        print(json.dumps(res), flush=True)
    mean = {side: {key: sum(r["ms"][key] for r in runs if r["side"] == side) / 2
                   for key in runs[0]["ms"]} for side in ("old", "new")}
    rot = {side: {f"{b}:{m}": sum(r["rotation"][b][m] for r in runs if r["side"] == side) / 2
                  for b in runs[0]["rotation"] for m in runs[0]["rotation"][b]}
           for side in ("old", "new")}
    print(json.dumps({"card": runs[0]["card"], "mean_ms": mean, "mean_rotation": rot,
                      "runs": runs}), flush=True)


if __name__ == "__main__":
    main()
