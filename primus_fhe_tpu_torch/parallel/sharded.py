"""Residue- and batch-sharded DCRT transforms and the sharded TFHE external
product (port of ``primus_fhe_tpu/parallel/sharded.py``).

The JAX module annotates shardings and leaves the collectives to XLA; here
they are written out.  Each function takes and returns the list of this
process's shard tensors, one per held shard of ``mesh.shards``:

- the DCRT transforms touch only the coefficient axis, so sharded over
  ``residue`` (axis 0 of ``(count, ..., n)``, each shard its moduli) they
  need no collective: each shard transforms its residues on its own plan;
- the external product runs the digits' forward transforms, the MAC and the
  inverse per residue shard, with the GLWE batch over ``batch``; the CRT
  recombine needs every prime's residue, so one ``all_gather`` over
  ``residue`` assembles them and each shard recombines its batch slice as
  the single card does (a ``psum`` of partial sums would have to carry the
  fixed-point ``alpha``'s overflow count exactly).
"""

from __future__ import annotations

import functools

from ..lattice.tfhe import external_product_mac
from ..transforms.dcrt import DcrtPlan32, dcrt_forward32, dcrt_inverse32
from .mesh import shard

KEY_SPEC = ("residue", None, None, None, None)  # (kp, k+1, L, k+1, N)


def residue_spec(ndim: int, batch_axis: int | None = None) -> tuple:
    """Axis 0 over ``residue``, ``batch_axis`` (if any) over ``batch``."""
    spec = ["residue"] + [None] * (ndim - 1)
    if batch_axis is not None:
        spec[batch_axis] = "batch"
    return tuple(spec)


def glwe_spec(ndim: int) -> tuple:
    """A batch of GLWEs ``(B, k+1, N)`` over ``batch``; one GLWE replicated."""
    return ("batch",) + (None,) * (ndim - 1) if ndim > 2 else (None,) * ndim


def shard_dcrt_values(values, mesh, batch_axis: int | None = None) -> list:
    """Places ``(count, ..., n)`` residues onto ``mesh``: the shards of
    :func:`residue_spec`."""
    return shard(mesh, values, residue_spec(values.dim(), batch_axis))


@functools.lru_cache(maxsize=None)
def _shard_plan(log_n: int, moduli: tuple) -> DcrtPlan32:
    return DcrtPlan32(log_n, moduli)


def _plans(plan: DcrtPlan32, mesh):
    """Each held shard's plan: its slice of ``plan.moduli``."""
    r = mesh.axis_size("residue")
    if plan.count % r:
        raise ValueError(f"{plan.count} residues do not split over {r} shards")
    m = plan.count // r
    return [_shard_plan(plan.log_n, plan.moduli[i * m:(i + 1) * m])
            for i in (mesh.axis_index(s, "residue") for s in mesh.shards)]


def sharded_dcrt_forward32(plan: DcrtPlan32, values, mesh, out_factor: int = 1) -> list:
    """Residue-sharded forward NTT: no collective."""
    return [dcrt_forward32(p, x, out_factor) for p, x in zip(_plans(plan, mesh), values)]


def sharded_dcrt_inverse32(plan: DcrtPlan32, values, mesh, out_factor: int = 1) -> list:
    """Residue-sharded inverse NTT: no collective."""
    return [dcrt_inverse32(p, x, out_factor) for p, x in zip(_plans(plan, mesh), values)]


class _PrimeShard:
    """A residue shard's view of a :class:`..transforms.torus.TorusConvolver32`:
    the primes ``start .. start + count`` (what :func:`external_product_mac`
    and the transforms need of a convolver)."""

    def __init__(self, conv, start: int, count: int):
        self.conv, self.count = conv, count
        self.rows = slice(start, start + count)
        self.plan = _shard_plan(conv.log_n, tuple(conv.primes[self.rows]))

    def _m(self, x, extra: int):
        shape = (self.count,) + (1,) * extra
        return self.conv.consts(x.device)["modulus"].map(lambda v: v[self.rows].reshape(shape))

    def forward(self, x, out_factor: int = 1):
        return dcrt_forward32(self.plan, self.conv.lift(x)[self.rows], out_factor)

    def inverse(self, res):
        return dcrt_inverse32(self.plan, res)


def shard_external_product_inputs(mesh, glwe, key_ntt) -> tuple[list, list]:
    """The shards of ``glwe (B..., k+1, N)`` (:func:`glwe_spec`) and of
    ``key_ntt (kp, k+1, L, k+1, N)`` (``KEY_SPEC``)."""
    return shard(mesh, glwe, glwe_spec(glwe.dim())), shard(mesh, key_ntt, KEY_SPEC)


def sharded_external_product(conv, basis, glwe, key_ntt, mesh) -> list:
    """``glwe ⊡ key`` with residue-sharded transforms and MAC and
    batch-sharded ciphertexts (:func:`shard_external_product_inputs`): the
    shards of the output ``(B..., k+1, N)`` (:func:`glwe_spec`), equal to
    :func:`..lattice.tfhe.external_product` on one card."""
    r = mesh.axis_size("residue")
    if conv.count % r:
        raise ValueError(f"{conv.count} primes do not split over {r} shards")
    m = conv.count // r
    partial = []
    for g, key, s in zip(glwe, key_ntt, mesh.shards):
        view = _PrimeShard(conv, mesh.axis_index(s, "residue") * m, m)
        nbatch = g.dim() - 2
        digits = basis.decompose(g).movedim(0, -2)  # (B..., k+1, L, N)
        acc = external_product_mac(view, view.forward(digits), key, nbatch)
        partial.append(view.inverse(acc))  # (m, B..., k+1, N)
    full = mesh.all_gather(partial, "residue", 0)  # every prime's residues
    return [conv.recombine(res) for res in full]
