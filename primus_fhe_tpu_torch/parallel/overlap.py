"""The residue-sharded DCRT gadget product and its CRT compose collective
(port of ``primus_fhe_tpu/parallel/overlap.py``).

The CRT compose is the one cross-residue contraction of an otherwise
residue-parallel gadget product.  Each residue shard folds only its own
residues into a big integer below Q (:meth:`..rns.base.RNSBase64.compose_partial`);
:func:`psum_bigint` sums the shards' values mod Q.  When the coefficient
axis divides the group it runs as a reduce-scatter of W-bit limbs
(``W = 32 - ceil(log2 D)``, so sums of D limbs fit a u32 lane), a carry walk
and ``log2 D`` conditional subtractions of ``2^j Q`` on each device's slice
of the coefficients, then an all-gather of the canonical words.  Every
branch gives the unique canonical value mod Q, so the result equals the
single-device compose.  The lanes travel as int64 (no collective sums
uint32), twice the JAX wire bytes.

The level loop after the compose (digits, centred re-spread, NTT,
multiply-accumulate) touches only a shard's own residues: one forward
transform launch a shard over every component, level and ciphertext
(:func:`..lattice.dcrt.gadget_ntt_big`), on the shard's plan
(:func:`..ops.ntt_mxu8_dyn.stack_dyn_plans`).  Where the JAX program emits
one compose collective per GLWE component ahead of the level compute, this
one emits a single batched one a step: every component and ciphertext of a
shard in one reduce-scatter and one all-gather.
"""

from __future__ import annotations

import torch

from ..decompose.big_integer import BigUintApproxSignedBasis
from ..lattice.dcrt import dcrt_ggsw_mac, gadget_ntt_big
from ..numeric.bigint import big_cond_sub, big_from_int
from ..numeric.limb import MASK32
from ..ops.ntt_mxu8_dyn import stack_dyn_plans
from ..rns.base import RNSBase64
from ..transforms.dcrt import DcrtPlan64, resolve_route
from .mesh import shard


def q_multiples(q_prod: int, n_limbs: int, d: int, device) -> list:
    """The ladder ``2^(log2 d - 1) Q, ..., 2Q, Q`` (``[Q]`` for ``d = 1``) as
    ``n_limbs``-limb tensors: takes a sum of ``d`` values below Q to below Q."""
    log_d = max(0, d.bit_length() - 1)
    mults = [(1 << j) * q_prod for j in range(log_d - 1, -1, -1)] or [q_prod]
    return [torch.from_numpy(big_from_int(m, n_limbs)).to(device) for m in mults]


def _cond_ladder(value, mults):
    for mult in mults:
        value = big_cond_sub(value, mult)
    return value


def _halves(partial, n_limbs):
    """u32 limbs -> 16-bit halves, low first: ``(..., 2 n_limbs)``."""
    return torch.stack([partial & 0xFFFF, partial >> 16], dim=-1).reshape(
        *partial.shape[:-1], 2 * n_limbs)


def _finish_halves(hv, n_limbs, mults):
    """Carry walk over summed 16-bit halves, repack into u32 limbs, ladder."""
    carry, packed = 0, []
    for j in range(2 * n_limbs):
        s = hv[..., j] + carry
        packed.append(s & 0xFFFF)
        carry = s >> 16
    limbs = [packed[2 * j] | (packed[2 * j + 1] << 16) for j in range(n_limbs)]
    return _cond_ladder(torch.stack(limbs, dim=-1), mults)


def psum_bigint(mesh, partials, axis: str, n_limbs: int, mults, q_bits: int | None = None):
    """Exact sum mod Q over ``mesh[axis]`` of big integers ``partials`` (one
    per held shard, ``(..., n_limbs)`` u32 limbs in int64, each below Q):

    - the coefficient axis (dim -2) not divisible by the group size, or a
      1-D value: an all-reduce of 16-bit halves, then the carry walk;
    - divisible but no room for the narrow pack (or no ``q_bits``): the
      halves reduce-scattered over the coefficients, the carry walk on each
      slice, an all-gather of the u32 limbs;
    - otherwise: ``ceil(q_bits / W)`` W-bit limbs reduce-scattered, the carry
      walk and the ladder on each slice, an all-gather of the
      ``ceil(q_bits / 32)`` canonical words, zero-padded.

    ``mults``: :func:`q_multiples`.  Returns one tensor per held shard."""
    g = mesh.axis_size(axis)
    x0 = partials[0]
    n_coeff = x0.shape[-2] if x0.dim() >= 2 else 0
    use_rs = x0.dim() >= 2 and n_coeff % g == 0
    log_g = (g - 1).bit_length()
    W = 32 - log_g
    n_w = -(-int(q_bits) // W) if q_bits else 0
    narrow_ok = (use_rs and q_bits is not None and 0 < q_bits <= 32 * n_limbs
                 and n_w * W + 32 <= 32 * n_limbs)  # the carry word fits the pack

    if not use_rs:
        summed = mesh.psum([_halves(p, n_limbs) for p in partials], axis)
        return [_finish_halves(hv, n_limbs, mults) for hv in summed]
    sc_dim = x0.dim() - 2
    if not narrow_ok:
        parts = mesh.psum_scatter([_halves(p, n_limbs) for p in partials], axis, sc_dim)
        return mesh.all_gather([_finish_halves(hv, n_limbs, mults) for hv in parts], axis,
                               sc_dim)

    mask_w = (1 << W) - 1

    def narrow(partial):  # u32 limbs -> n_w W-bit limbs
        out = []
        for j in range(n_w):
            i0, s = divmod(j * W, 32)
            w = partial[..., i0] >> s
            if s + W > 32 and i0 + 1 < n_limbs:
                w = w | (partial[..., i0 + 1] << (32 - s))
            out.append(w & mask_w)
        return torch.stack(out, dim=-1)

    def finish(part):  # carry walk, pack into u32 limbs, ladder
        carry, ws = 0, []
        for j in range(n_w):
            s = part[..., j] + carry
            ws.append(s & mask_w)
            carry = s >> W
        ws.append(carry)  # below D Q: the final carry is one extra word
        limbs = [torch.zeros_like(part[..., 0]) for _ in range(n_limbs)]
        for j, w in enumerate(ws):
            i0, s = divmod(j * W, 32)
            limbs[i0] = limbs[i0] | ((w << s) & MASK32)
            if s and i0 + 1 < n_limbs:
                limbs[i0 + 1] = limbs[i0 + 1] | (w >> (32 - s))
        return _cond_ladder(torch.stack(limbs, dim=-1), mults)

    parts = mesh.psum_scatter([narrow(p) for p in partials], axis, sc_dim)
    n_out = -(-int(q_bits) // 32)  # the top words of a value below Q are zero
    gathered = mesh.all_gather([finish(p)[..., :n_out].contiguous() for p in parts], axis, sc_dim)
    if n_out == n_limbs:
        return gathered
    return [torch.cat([x, torch.zeros(x.shape[:-1] + (n_limbs - n_out,), dtype=x.dtype,
                                      device=x.device)], dim=-1) for x in gathered]


class ResidueShard:
    """What a residue shard holds: its moduli's plan and RNS base (for the
    transforms, re-spread, monomials and modular arithmetic) and the index
    of its first modulus in the full base (for its compose terms)."""

    def __init__(self, plan: DcrtPlan64, start: int):
        self.plan = plan
        self.base = RNSBase64(plan.moduli)
        self.start = start


class GadgetStep:
    """The per-shard gadget product of the sharded programs, one step over
    the held shards: the partial composes, one :func:`psum_bigint` over
    ``axis``, then each shard's digits, forward transform and
    multiply-accumulate against its slice of the GGSW."""

    def __init__(self, mesh, axis: str, basis: BigUintApproxSignedBasis, plan: DcrtPlan64,
                 rns_base: RNSBase64, route: str):
        d = mesh.axis_size(axis)
        if rns_base.count % d:
            raise ValueError("the residue count must divide the mesh axis")
        self.mesh, self.axis, self.basis, self.rns_base = mesh, axis, basis, rns_base
        self.route = resolve_route(plan, route)
        m_loc = rns_base.count // d
        residues = [ResidueShard(p, r * m_loc) for r, p in enumerate(stack_dyn_plans(plan, d))]
        self.shards = [residues[mesh.axis_index(s, axis)] for s in mesh.shards]
        self.L = rns_base.big_len
        self.q_bits = rns_base.q_product.bit_length()
        self.mults = q_multiples(rns_base.q_product, self.L + 1, d, mesh.device)

    def __call__(self, crt_glwes, ggsws):
        """``crt_glwes``: per held shard ``(m_loc, ..., k+1, N)`` coefficient
        domain; ``ggsws``: ``(k+1, L, m_loc, k+1, N)`` NTT domain -> the
        products ``(m_loc, ..., k+1, N)``, NTT domain."""
        partials = [self.rns_base.compose_partial(x, rs.start)
                    for x, rs in zip(crt_glwes, self.shards)]
        bigs = psum_bigint(self.mesh, partials, self.axis, self.L + 1, self.mults, self.q_bits)
        return [dcrt_ggsw_mac(gadget_ntt_big(big[..., :self.L], self.basis, rs.plan, rs.base,
                                             self.route), g, rs.base)
                for big, g, rs in zip(bigs, ggsws, self.shards)]


def make_sharded_gadget_product(mesh, axis: str, basis: BigUintApproxSignedBasis,
                                plan: DcrtPlan64, rns_base: RNSBase64, route: str = "auto"):
    """The residue-sharded external product ``fn(crt_glwes, ggsws) -> list``:
    ``crt_glwe (n_mod, k+1, N)`` coefficient domain sharded over ``axis`` on
    dim 0, ``ggsw (k+1, L, n_mod, k+1, N)`` on dim 2 (:func:`shard_gadget_inputs`),
    output ``(n_mod, k+1, N)`` NTT domain, residue-sharded.  Equal to
    :func:`..lattice.dcrt.crt_glwe_mul_dcrt_ggsw`.  ``route`` picks the
    per-shard transform kernels (:func:`..transforms.dcrt.resolve_route`)."""
    return GadgetStep(mesh, axis, basis, plan, rns_base, route)


GLWE_SPEC = ("residue", None, None)
GGSW_SPEC = (None, None, "residue", None, None)


def shard_gadget_inputs(mesh, axis: str, crt_glwe: torch.Tensor, ggsw: torch.Tensor):
    """Splits the gadget-product operands over the mesh (the residue axis on
    dim 0 of the GLWE, dim 2 of the GGSW)."""
    glwe_spec = tuple(axis if a else None for a in GLWE_SPEC)
    ggsw_spec = tuple(axis if a else None for a in GGSW_SPEC)
    return shard(mesh, crt_glwe, glwe_spec), shard(mesh, ggsw, ggsw_spec)
