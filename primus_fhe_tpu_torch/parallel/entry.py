"""The multi-device entry point: one sharded batched DCRT blind-rotation step
(the twin of ``make_sharded_rotation_step`` and ``dryrun_multichip`` in the
repository's ``__graft_entry__.py``).

The step runs on a ``(residue, batch)`` mesh of either backend: the bootstrap
key split over the residue axis, the ciphertexts over the batch axis.  Its
inputs are the JAX entry's: the same draws from ``np.random.default_rng(1)``
in the same order, so a test can hold the two steps equal.  Dimensions
default to the JAX entry's production ones: N = 1024, two 50-bit moduli,
k + 1 = 2, L = 4 levels of 2^25, n_lwe = 512, batch ``2 x devices``.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..decompose.big_integer import BigUintApproxSignedBasis
from ..numeric.limb import u64_tensor
from ..rns.base import RNSBase64
from ..transforms.dcrt import build_dcrt_plan64
from .sharded_rotation import make_sharded_blind_rotation, shard_rotation_inputs

MODULI = [1125899906826241, 1125899906629633]  # 2 x 50-bit
K1 = 2
LOG_BASIS = 25


def make_inputs(log_n: int, n_lwe: int, batch: int):
    """The JAX entry's numpy inputs: ``bsk (n_lwe, k+1, L, 2, k+1, N)``, ``acc
    (batch, 2, k+1, N)`` (u64) and ``lwe (batch, n_lwe+1)`` (int32)."""
    n = 1 << log_n
    level = BigUintApproxSignedBasis(RNSBase64(MODULI), LOG_BASIS).decompose_length
    rng = np.random.default_rng(1)
    q0 = min(MODULI)
    bsk = rng.integers(0, q0, size=(n_lwe, K1, level, len(MODULI), K1, n), dtype=np.uint64)
    acc = rng.integers(0, q0, size=(batch, len(MODULI), K1, n), dtype=np.uint64)
    lwe = rng.integers(0, 2 * n, size=(batch, n_lwe + 1)).astype(np.int32)
    return bsk, acc, lwe


def make_sharded_rotation_step(mesh, log_n: int = 10, n_lwe: int = 512, batch: int | None = None,
                               route: str = "auto"):
    """Builds the sharded batched blind-rotation step on ``mesh``.

    Returns ``(step, (lwe, acc, bsk), mesh)``: ``step(lwe, acc, bsk)`` takes
    and returns lists of the held shards (:func:`.sharded_rotation.shard_rotation_inputs`
    made them from the numpy inputs of :func:`make_inputs`)."""
    base = RNSBase64(MODULI)
    basis = BigUintApproxSignedBasis(base, LOG_BASIS)
    plan = build_dcrt_plan64(log_n, MODULI)
    if batch is None:
        batch = 2 * mesh.size
    bsk, acc, lwe = make_inputs(log_n, n_lwe, batch)
    bsk_s, lwe_s, acc_s = shard_rotation_inputs(mesh, "residue", "batch", u64_tensor(bsk),
                                                torch.from_numpy(lwe), u64_tensor(acc))
    rot = make_sharded_blind_rotation(mesh, "residue", "batch", basis, plan, base, route)
    return (lambda lwe_, acc_, bsk_: rot(bsk_, lwe_, acc_)), (lwe_s, acc_s, bsk_s), mesh


def dryrun_multichip(mesh, log_n: int = 10, n_lwe: int = 512, batch: int | None = None,
                     route: str = "auto") -> dict:
    """Runs ONE sharded batched blind-rotation step and prints (on the
    process holding device 0) the JAX entry's JSON line describing the dims
    run; returns that description."""
    step, (lwe, acc, bsk), mesh = make_sharded_rotation_step(mesh, log_n, n_lwe, batch, route)
    out = step(lwe, acc, bsk)
    if [o.shape for o in out] != [a.shape for a in acc]:
        raise AssertionError("the step changed the accumulator shards' shapes")
    b_loc, m_loc, k1, n = acc[0].shape
    desc = {
        "dryrun": "batched DCRT blind rotation",
        "n_devices": mesh.size,
        "mesh": dict(mesh.shape),
        "N": n,
        "residues": m_loc * mesh.axis_size("residue"),
        "moduli_bits": 50,
        "glwe_k_plus_1": k1,
        "gadget_levels": bsk[0].shape[2],
        "lwe_dim": bsk[0].shape[0],
        "batch": b_loc * mesh.axis_size("batch"),
    }
    if 0 in mesh.shards:
        print(json.dumps(desc), flush=True)
    return desc
