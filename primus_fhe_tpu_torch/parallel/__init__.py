"""The mesh layer on ``torch.distributed`` (port of ``primus_fhe_tpu/parallel/``).

- :mod:`.mesh`: the ``(residue, batch)`` mesh, its two backends
  (:class:`LocalMesh`, every shard in one process; :class:`ProcessGroupMesh`,
  one shard per rank) and the shard/unshard helpers;
- :mod:`.coeff_sharded`: the coefficient-sharded NTT (exchange stages around
  the row-11 stage kernels);
- :mod:`.coeff_sharded_mxu`: the coefficient-sharded byte-radix NTT (row 13's
  half-transforms around one ``all_to_all``);
- :mod:`.overlap`: the sharded CRT compose (:func:`psum_bigint`) and the
  residue-sharded gadget product;
- :mod:`.sharded`: the residue-sharded 32-bit DCRT transforms and the
  residue- and batch-sharded TFHE external product;
- :mod:`.sharded_rotation`: the residue- and batch-sharded DCRT blind
  rotation;
- :mod:`.entry`: the multi-device step of ``__graft_entry__``.
"""

from .coeff_sharded import (
    build_expanded_inverse_tables32,
    build_expanded_inverse_tables64,
    build_expanded_tables32,
    build_expanded_tables64,
    coeff_sharded_forward32,
    coeff_sharded_forward64,
    coeff_sharded_inverse32,
    coeff_sharded_inverse64,
)
from .coeff_sharded_mxu import (
    ShardedMxuPlan64,
    from_coeff_layout,
    get_sharded_plan,
    ntt_layout_from_flat,
    ntt_layout_to_flat,
    sharded_mxu_forward64,
    sharded_mxu_inverse64,
    to_coeff_layout,
)
from .entry import dryrun_multichip, make_sharded_rotation_step
from .mesh import LocalMesh, ProcessGroupMesh, shard, unshard
from .overlap import make_sharded_gadget_product, psum_bigint, shard_gadget_inputs
from .sharded import (
    shard_dcrt_values,
    shard_external_product_inputs,
    sharded_dcrt_forward32,
    sharded_dcrt_inverse32,
    sharded_external_product,
)
from .sharded_rotation import make_sharded_blind_rotation, shard_rotation_inputs

__all__ = [
    "LocalMesh",
    "ProcessGroupMesh",
    "ShardedMxuPlan64",
    "build_expanded_inverse_tables32",
    "build_expanded_inverse_tables64",
    "build_expanded_tables32",
    "build_expanded_tables64",
    "coeff_sharded_forward32",
    "coeff_sharded_forward64",
    "coeff_sharded_inverse32",
    "coeff_sharded_inverse64",
    "dryrun_multichip",
    "from_coeff_layout",
    "get_sharded_plan",
    "make_sharded_blind_rotation",
    "make_sharded_gadget_product",
    "make_sharded_rotation_step",
    "ntt_layout_from_flat",
    "ntt_layout_to_flat",
    "psum_bigint",
    "shard",
    "shard_gadget_inputs",
    "shard_dcrt_values",
    "shard_external_product_inputs",
    "shard_rotation_inputs",
    "sharded_dcrt_forward32",
    "sharded_dcrt_inverse32",
    "sharded_external_product",
    "sharded_mxu_forward64",
    "sharded_mxu_inverse64",
    "to_coeff_layout",
    "unshard",
]
