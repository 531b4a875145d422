"""Row 12: the per-residue byte-radix NTT of the residue-sharded DCRT path
(port of ``primus_fhe_tpu/ops/ntt_mxu8_dyn.py`` as far as the sharded code
calls it: the slicing).

The JAX module exists so that one compiled SPMD program can transform
whichever modulus a device holds: every q-dependent constant of the 7/8-plane
byte-radix transform becomes an array argument (``stack_dyn_tables`` /
``stack_dyn_inv_tables`` stack them over the residues, ``shard_map`` hands
each device its slice, and ``mxu8_dyn_forward64``/``mxu8_dyn_inverse64``
run them).  Here no new kernel is needed: :func:`.ntt_mxu8.mxu8_forward64`
and :func:`.ntt_mxu8.mxu8_inverse64` (``csrc/ntt_mxu8.cu``) already take q
and every table at run time, with the plane count a template parameter.  A
residue shard's counterpart of its slice of the stacked tables is a
:class:`..transforms.dcrt.DcrtPlan64` of that shard's moduli, whose
``.mxu`` tables feed those kernels (and whose butterfly tables and monomial
tables serve the other route).  Each shard builds its tables at its own
tier; outputs are canonical on every tier, so the JAX's homogeneous
8-plane stacks of mixed residue sets are not needed.

Lazy words follow the rule of :mod:`.ntt_mxu8`: word-equal to the
reference at ``out_factor`` 1; above it congruent mod q and below
``out_factor * q`` (canonical here, where the JAX forward may leave words in
``[0, 4q)`` at ``out_factor`` 4).
"""

from __future__ import annotations

from ..transforms.dcrt import DcrtPlan64


def stack_dyn_plans(plan: DcrtPlan64, shards: int) -> list[DcrtPlan64]:
    """The residue shards' plans: shard ``r`` of ``shards`` holds the moduli
    ``plan.moduli[r m : (r+1) m]``, ``m = count / shards`` (the residue axis's
    slicing of ``stack_dyn_tables``/``stack_dyn_inv_tables``)."""
    if shards < 1 or plan.count % shards:
        raise ValueError(f"{plan.count} residues do not split over {shards} shards")
    m = plan.count // shards
    return [DcrtPlan64(plan.log_n, plan.moduli[r * m:(r + 1) * m]) for r in range(shards)]

