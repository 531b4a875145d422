"""The mesh layer on ``torch.distributed`` (port of ``primus_fhe_tpu/parallel/``).

- :mod:`.mesh`: the ``(residue, batch)`` mesh, its two backends
  (:class:`LocalMesh`, every shard in one process; :class:`ProcessGroupMesh`,
  one shard per rank) and the shard/unshard helpers;
- :mod:`.coeff_sharded`: the coefficient-sharded NTT (exchange stages around
  the row-11 stage kernels);
- :mod:`.overlap`: the sharded CRT compose (:func:`psum_bigint`) and the
  residue-sharded gadget product;
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
from .entry import dryrun_multichip, make_sharded_rotation_step
from .mesh import LocalMesh, ProcessGroupMesh, shard, unshard
from .overlap import make_sharded_gadget_product, psum_bigint, shard_gadget_inputs
from .sharded_rotation import make_sharded_blind_rotation, shard_rotation_inputs

__all__ = [
    "LocalMesh",
    "ProcessGroupMesh",
    "build_expanded_inverse_tables32",
    "build_expanded_inverse_tables64",
    "build_expanded_tables32",
    "build_expanded_tables64",
    "coeff_sharded_forward32",
    "coeff_sharded_forward64",
    "coeff_sharded_inverse32",
    "coeff_sharded_inverse64",
    "dryrun_multichip",
    "make_sharded_blind_rotation",
    "make_sharded_gadget_product",
    "make_sharded_rotation_step",
    "psum_bigint",
    "shard",
    "shard_gadget_inputs",
    "shard_rotation_inputs",
    "unshard",
]
