"""The residue- and batch-sharded DCRT blind rotation, the multi-device step
(port of ``primus_fhe_tpu/parallel/sharded_rotation.py``).

On a ``(residue, batch)`` mesh:

- the batch axis is pure data parallelism: no collective;
- the residue axis carries the CRT compose of every CMux step, one
  :func:`.overlap.psum_bigint` a step (:class:`.overlap.GadgetStep`);
- each shard's transforms run on its own moduli's plan
  (:func:`..ops.ntt_mxu8_dyn.stack_dyn_plans`), one inverse launch and one
  forward launch a shard a step, on the kernels ``route`` names (the JAX's
  ``local_ntt``): ``"mxu8"`` the byte-radix ``mxu8_forward64`` /
  ``mxu8_inverse64``, ``"butterfly"`` ``ntt64_forward`` / ``ntt64_inverse``,
  ``"auto"`` as :func:`..transforms.dcrt.resolve_route` picks.

The loop is the single-card one, :func:`..boot.dcrt_blind_rotate.rotate_shards`,
over the held shards with :class:`.overlap.GadgetStep` as its external
product, so it runs on both mesh backends; its output equals
``dcrt_blind_rotate_batched`` word for word.
"""

from __future__ import annotations

import torch

from ..boot.dcrt_blind_rotate import rotate_shards
from .mesh import shard
from .overlap import GadgetStep

BSK_SPEC = (None, None, None, "residue", None, None)
LWE_SPEC = ("batch", None)
ACC_SPEC = ("batch", "residue", None, None)


def make_sharded_blind_rotation(mesh, r_axis: str, b_axis: str, basis, plan, rns_base,
                                route: str = "auto"):
    """Builds ``fn(bsk, lwe, acc) -> list`` over the held shards with the
    layouts of ``dcrt_blind_rotate_batched``: ``bsk (n_lwe, k+1, L, n_mod, k+1,
    N)`` residue-sharded on dim 3, ``lwe (B, n_lwe+1)`` batch-sharded, ``acc
    (B, n_mod, k+1, N)`` batch- and residue-sharded (:func:`shard_rotation_inputs`);
    the result is laid out as ``acc``."""
    if (r_axis, b_axis) != ("residue", "batch"):
        raise ValueError("the rotation runs on the ('residue', 'batch') axes")
    gadget = GadgetStep(mesh, r_axis, basis, plan, rns_base, route)

    def run(bsk_shards, lwe_shards, acc_shards):
        accs = rotate_shards([rs.plan for rs in gadget.shards], [rs.base for rs in gadget.shards],
                             gadget, bsk_shards, lwe_shards,
                             [acc.transpose(0, 1) for acc in acc_shards], gadget.route)
        return [acc.transpose(0, 1).contiguous() for acc in accs]

    return run


def shard_rotation_inputs(mesh, r_axis: str, b_axis: str, bsk: torch.Tensor, lwe: torch.Tensor,
                          acc: torch.Tensor):
    """Splits the rotation operands over the mesh (each residue slice of the
    key is one tensor, shared by the shards along the batch axis)."""
    if (r_axis, b_axis) != ("residue", "batch"):
        raise ValueError("the rotation runs on the ('residue', 'batch') axes")
    return shard(mesh, bsk, BSK_SPEC), shard(mesh, lwe, LWE_SPEC), shard(mesh, acc, ACC_SPEC)
