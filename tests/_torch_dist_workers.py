"""Rank workers for the gloo tests of the port's mesh layer.

This module imports torch, numpy and the port only: a spawned rank imports
it afresh, and must not import JAX (or a test module, which would pull in
the root conftest).  :func:`run_ranks` starts ``world`` spawned processes
that meet through a file rendezvous (``file://<dir>/rdv``, so parallel test
workers never race for a TCP port), joins each under one deadline and
terminates every rank still alive when it passes, so a hung rendezvous fails
one test and no more.
"""

from __future__ import annotations

import multiprocessing as mp
import time
import traceback
from pathlib import Path

import numpy as np
import torch

SHAPE = (4, 8)  # every collective case: divisible by 4 on both dims


def shard_input(s: int) -> torch.Tensor:
    """Device ``s``'s input to the collective cases."""
    rng = np.random.default_rng(100 + s)
    return torch.from_numpy(rng.integers(-(1 << 40), 1 << 40, SHAPE, dtype=np.int64))


def bigint_input(s: int, branch: str, n_limbs: int = 5):
    """Device ``s``'s big integers below ``Q = 2^101 - 1`` for a
    :func:`psum_bigint` branch: 1-D for the all-reduce, 8 coefficients
    otherwise."""
    rng = np.random.default_rng(200 + s)
    q = (1 << 101) - 1
    count = 1 if branch == "allreduce" else 8
    vals = [int(rng.integers(0, 1 << 62)) * int(rng.integers(0, 1 << 62)) % q
            for _ in range(count)]
    limbs = [[(v >> (32 * i)) & 0xFFFFFFFF for i in range(n_limbs)] for v in vals]
    t = torch.tensor(limbs, dtype=torch.int64)
    return (t[0] if branch == "allreduce" else t), vals, q


def collective_cases(mesh) -> dict:
    """Every collective of ``mesh`` on both axes, and :func:`psum_bigint` on
    its three branches over the residue axis: ``{case: [tensor per held
    shard]}``."""
    from primus_fhe_tpu_torch.parallel.overlap import psum_bigint, q_multiples

    xs = [shard_input(s) for s in mesh.shards]
    out = {}
    for axis in ("residue", "batch"):
        g = mesh.axis_size(axis)
        out[f"psum/{axis}"] = mesh.psum(xs, axis)
        for dim in (0, 1):
            out[f"psum_scatter{dim}/{axis}"] = mesh.psum_scatter(xs, axis, dim)
            out[f"all_gather{dim}/{axis}"] = mesh.all_gather(xs, axis, dim)
        for delta in range(1, g):
            out[f"swap{delta}/{axis}"] = mesh.ppermute(xs, axis, [(i ^ delta, i) for i in range(g)])
        out[f"shift/{axis}"] = mesh.ppermute(xs, axis, [(i, i + 1) for i in range(g - 1)])
    d = mesh.axis_size("residue")
    for branch in ("allreduce", "halves", "narrow"):
        parts = [bigint_input(s, branch)[0] for s in mesh.shards]
        q = bigint_input(0, branch)[2]
        q_bits = q.bit_length() if branch == "narrow" else None
        out[f"bigint/{branch}"] = psum_bigint(mesh, parts, "residue", 5,
                                              q_multiples(q, 5, d, mesh.device), q_bits)
    return out


def _collectives(meshes):
    from primus_fhe_tpu_torch.parallel.mesh import ProcessGroupMesh

    return {shape: collective_cases(ProcessGroupMesh(*shape, "cpu")) for shape in meshes}


def _dcrt_setup(log_n):
    from primus_fhe_tpu_torch.decompose import BigUintApproxSignedBasis
    from primus_fhe_tpu_torch.parallel.entry import LOG_BASIS, MODULI
    from primus_fhe_tpu_torch.rns import RNSBase64
    from primus_fhe_tpu_torch.transforms.dcrt import build_dcrt_plan64

    base = RNSBase64(MODULI)
    return base, BigUintApproxSignedBasis(base, LOG_BASIS), build_dcrt_plan64(log_n, MODULI)


def _dcrt(shape, inputs_path):
    """The sharded gadget product, the sharded rotation and the entry step
    on a ``shape`` process-group mesh, on the inputs saved at
    ``inputs_path``; every output assembled on every rank."""
    from primus_fhe_tpu_torch.parallel import entry
    from primus_fhe_tpu_torch.parallel.mesh import ProcessGroupMesh, unshard
    from primus_fhe_tpu_torch.parallel.overlap import (
        GLWE_SPEC, make_sharded_gadget_product, shard_gadget_inputs)
    from primus_fhe_tpu_torch.parallel.sharded_rotation import (
        ACC_SPEC, make_sharded_blind_rotation, shard_rotation_inputs)

    inp = torch.load(inputs_path)
    base, basis, plan = _dcrt_setup(inp["log_n"])
    mesh = ProcessGroupMesh(*shape, "cpu")
    out = {}
    gadget = make_sharded_gadget_product(mesh, "residue", basis, plan, base, "butterfly")
    glwe, ggsw = shard_gadget_inputs(mesh, "residue", inp["glwe"], inp["ggsw"])
    out["gadget"] = unshard(mesh, gadget(glwe, ggsw), GLWE_SPEC)
    rot = make_sharded_blind_rotation(mesh, "residue", "batch", basis, plan, base, "butterfly")
    bsk, lwe, acc = shard_rotation_inputs(mesh, "residue", "batch", inp["bsk"], inp["lwe"],
                                          inp["acc"])
    out["rotation"] = unshard(mesh, rot(bsk, lwe, acc), ACC_SPEC)
    step, (lwe, acc, bsk), _ = entry.make_sharded_rotation_step(
        mesh, inp["log_n"], inp["n_lwe"], inp["batch"], route="butterfly")
    out["entry"] = unshard(mesh, step(lwe, acc, bsk), ACC_SPEC)
    return out


def all_to_all_cases(mesh) -> dict:
    """The tiled ``all_to_all`` on both axes, both dims: ``{case: [tensor per
    held shard]}``."""
    xs = [shard_input(s) for s in mesh.shards]
    return {f"all_to_all{sd}{cd}/{axis}": mesh.all_to_all(xs, axis, sd, cd)
            for axis in ("residue", "batch") for sd, cd in ((0, 1), (1, 0), (0, 0))}


def _coeff_mxu(shape, inputs_path):
    """The tiled ``all_to_all`` cases and the coefficient-sharded byte-radix
    transforms on a ``shape`` process-group mesh, on the inputs saved at
    ``inputs_path``; every output assembled on every rank."""
    from primus_fhe_tpu_torch.parallel import coeff_sharded_mxu as csm
    from primus_fhe_tpu_torch.parallel.mesh import ProcessGroupMesh, shard, unshard

    inp = torch.load(inputs_path)
    mesh = ProcessGroupMesh(*shape, "cpu")
    out = {k: v[0] for k, v in all_to_all_cases(mesh).items()}
    coeff, ntt = (None, "residue", None), ("residue", None, None)
    log_n, q = inp["log_n"], inp["q"]
    f = csm.sharded_mxu_forward64(mesh, "residue", log_n, q, shard(mesh, inp["coeff"], coeff))
    out["forward"] = unshard(mesh, f, ntt)
    out["inverse"] = unshard(mesh, csm.sharded_mxu_inverse64(mesh, "residue", log_n, q, f), coeff)
    out["inverse_mul"] = unshard(
        mesh, csm.sharded_mxu_inverse64(mesh, "residue", log_n, q, f, mul_tab=inp["mul_tab"]), coeff)
    return out


TASKS = {"collectives": _collectives, "dcrt": _dcrt, "coeff_mxu": _coeff_mxu}


def _rank(rdv: str, world: int, rank: int, task: str, args, out_path: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{rdv}", world_size=world, rank=rank)
        torch.save(TASKS[task](*args), out_path)
    except BaseException:
        Path(out_path + ".err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(workdir: Path, world: int, task: str, args=(), timeout: float = 240.0) -> list:
    """Runs ``TASKS[task](*args)`` on ``world`` gloo ranks; returns each
    rank's result, rank order.  Raises if a rank fails or the deadline
    passes (every live rank is terminated first)."""
    ctx = mp.get_context("spawn")
    workdir.mkdir(parents=True, exist_ok=True)
    rdv = workdir / "rdv"
    outs = [str(workdir / f"rank{r}.pt") for r in range(world)]
    procs = [ctx.Process(target=_rank, args=(str(rdv), world, r, task, args, outs[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        alive = [r for r, p in enumerate(procs) if p.is_alive()]
        if alive:
            raise TimeoutError(f"gloo ranks {alive} of {world} still running after {timeout} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
    errors = [Path(o + ".err").read_text() for o in outs if Path(o + ".err").exists()]
    codes = [p.exitcode for p in procs]
    if errors or any(codes):
        raise RuntimeError(f"gloo ranks failed (exit codes {codes}):\n" + "\n".join(errors))
    return [torch.load(o) for o in outs]
