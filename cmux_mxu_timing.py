#!/usr/bin/env python3
"""Device time of kernels A (``mxu_cmux_step``) and B (``ntru_cmux_step``) on
one CUDA card, at BOOLEAN_128 width (N = 2048, k = 1, L = 3, two primes) and
NTRU_128 width (N = 1024, q = 1038337, L = 6), batch 1 and 64.

    python3 cmux_mxu_timing.py                 # this checkout
    python3 cmux_mxu_timing.py --root DIR      # the package under DIR
    python3 cmux_mxu_timing.py --compare OLD   # OLD and this checkout in turns
    python3 cmux_mxu_timing.py --phases        # cycles per phase (clock64)

A kernel's device time is the median of 20 calls, each timed with CUDA
events queued behind a ~1 ms sleep kernel, so the events bracket the kernel
and not the host's launch work.  ``--compare OLD`` runs OLD, this checkout,
this checkout, OLD, each in its own process (each builds its own kernels
under its root), and prints every run and the mean per side.  ``--phases``
copies the package to ``.proof/phases`` (git-ignored), stamps ``clock64()``
in block 0 after each phase barrier of ``csrc/cmux_mxu.cu``, builds that
copy and prints the cycles of each phase; the source itself carries no
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
    from primus_fhe_tpu_torch.ops import cmux_mxu, ntru_cmux_mxu

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
    return calls


def run_here(stamps: bool) -> dict:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("cmux_mxu_timing: needs a CUDA card")
    dev = torch.device("cuda", 0)
    calls = kernels(torch, dev)
    result = {"root": str(Path(sys.path[0]).resolve()), "card": card(),
              "ms": {f"{k}@{b}": device_ms(torch, fn) for (k, b), fn in calls.items()}}
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
            build.check(lib.pft_read_stamps(ctypes.addressof(buf)), "pft_read_stamps")
            row = list(buf)[16 if k == "B" else 0:][:len(PHASES) + 1]
            result["cycles"][f"{k}@{b}"] = dict(
                zip(PHASES, [row[i + 1] - row[i] for i in range(len(PHASES))]),
                total=row[-1] - row[0])
    return result


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
    return root


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
    print(json.dumps({"card": runs[0]["card"], "mean_ms": mean, "runs": runs}), flush=True)


if __name__ == "__main__":
    main()
