"""Blind rotation over an RNS (DCRT) accumulator, the 62-bit-tier bootstrap
pipeline (port of ``primus_fhe_tpu/boot/dcrt_blind_rotate.py``).

The accumulator lives in the NTT domain, so ``acc * X^d`` is one pointwise
multiply by the monomial diagonal (:func:`..transforms.dcrt.dcrt_monomial64`).
Each CMux step is::

    rotated = acc * NTT(X^a_i)                (pointwise, per modulus)
    diff    = INTT(rotated - acc)             (one inverse launch)
    delta   = diff gadget-x GGSW_i            (compose -> digits -> re-spread
                                               -> one forward launch -> MAC)
    acc    += delta

The batch rides inside the residue-major layout ``(count, B, k+1, N)``, so
one transform launch carries every ciphertext of the batch (the reference's
``_rotate_core``).  Per step: one inverse transform over ``count x B x
(k+1)`` rows and one forward transform over ``count x (k+1) x L x B`` rows.
``route`` picks the transform kernels (:mod:`..transforms.dcrt`).  The loop,
:func:`rotate_shards`, runs over a list of shards, so the mesh's sharded
rotation (:mod:`..parallel.sharded_rotation`) is the same loop.
"""

from __future__ import annotations

import torch

from ..decompose.big_integer import BigUintApproxSignedBasis
from ..lattice.dcrt import crt_glwe_mul_dcrt_ggsw, dcrt_ggsw_encrypt
from ..modular.modops import add64, mul64, sub64
from ..numeric.limb import from_u64_pair
from ..rns.base import RNSBase64
from ..transforms.dcrt import DcrtPlan64, dcrt_inverse64_fast, dcrt_monomial64


def rotate_shards(plans, bases, gadget, bsks, lwes, accs0, route: str) -> list:
    """The CMux loop, one bulk-synchronous step at a time over a list of
    shards (one on a single card; the held shards of a mesh).  Per shard:
    its ``DcrtPlan64`` and ``RNSBase64`` (its own moduli), ``bsk (n_lwe, k+1,
    L, m, k+1, N)``, ``lwe (B, n_lwe+1)`` mod 2N, ``acc0 (m, B, k+1, N)`` NTT
    domain.  ``gadget(diffs, ggsws)`` is the external product of each
    shard's coefficient-domain difference with its slice of GGSW ``i``.
    Returns the rotated accumulators, laid out as ``acc0``."""
    n_lwe = bsks[0].shape[0]
    mods = [base.modulus_bc(3, acc0.device) for base, acc0 in zip(bases, accs0)]
    accs, a_ts = [], []
    for plan, m, lwe, acc0 in zip(plans, mods, lwes, accs0):
        lwe = lwe.to(torch.int64)
        mono_b = dcrt_monomial64(plan, torch.remainder(-lwe[:, n_lwe], 2 * plan.n)[:, None])
        accs.append(mul64(acc0, mono_b.unsqueeze(-2), m))
        a_ts.append(torch.remainder(lwe[:, :n_lwe], 2 * plan.n).t())  # (n_lwe, B)
    for i in range(n_lwe):
        diffs = []
        for plan, m, acc, a_t in zip(plans, mods, accs, a_ts):
            mono = dcrt_monomial64(plan, a_t[i][:, None])  # (m, B, N)
            rotated = mul64(acc, mono.unsqueeze(-2), m)
            diffs.append(dcrt_inverse64_fast(plan, sub64(rotated, acc, m.value), 1, route))
        deltas = gadget(diffs, [bsk[i] for bsk in bsks])
        accs = [add64(acc, delta, m.value) for acc, delta, m in zip(accs, deltas, mods)]
    return accs


def _rotate_core(plan: DcrtPlan64, basis: BigUintApproxSignedBasis, rns_base: RNSBase64,
                 bsk: torch.Tensor, lwe_switched: torch.Tensor, acc0: torch.Tensor,
                 route: str) -> torch.Tensor:
    """``bsk (n_lwe, k+1, L, count, k+1, N)``, ``lwe_switched (B, n_lwe+1)``
    mod 2N, ``acc0 (count, B, k+1, N)`` NTT domain -> the rotated
    accumulators, same layout."""
    def gadget(diffs, ggsws):
        return [crt_glwe_mul_dcrt_ggsw(diffs[0], ggsws[0], basis, plan, rns_base, route)]

    return rotate_shards([plan], [rns_base], gadget, [bsk], [lwe_switched], [acc0], route)[0]


def dcrt_blind_rotate(plan: DcrtPlan64, basis: BigUintApproxSignedBasis, rns_base: RNSBase64,
                      bsk: torch.Tensor, lwe_switched: torch.Tensor, acc0: torch.Tensor,
                      route: str = "auto") -> torch.Tensor:
    """Single-ciphertext rotation: ``lwe_switched (n_lwe+1,)`` mod 2N, ``acc0
    (count, k+1, N)`` NTT domain -> the accumulator, NTT domain."""
    return _rotate_core(plan, basis, rns_base, bsk, lwe_switched[None], acc0[:, None],
                        route)[:, 0]


def dcrt_blind_rotate_batched(plan: DcrtPlan64, basis: BigUintApproxSignedBasis,
                              rns_base: RNSBase64, bsk: torch.Tensor, lwe_batch: torch.Tensor,
                              acc_batch: torch.Tensor, route: str = "auto") -> torch.Tensor:
    """Batched rotation: ``lwe_batch (B, n_lwe+1)``, ``acc_batch (B, count,
    k+1, N)`` -> ``(B, count, k+1, N)``; the bootstrap key is shared."""
    out = _rotate_core(plan, basis, rns_base, bsk, lwe_batch, acc_batch.transpose(0, 1), route)
    return out.transpose(0, 1).contiguous()


def make_dcrt_bootstrap_key(generator: torch.Generator, lwe_secret: torch.Tensor, secret_ntt,
                            basis: BigUintApproxSignedBasis, gaussian, plan: DcrtPlan64,
                            rns_base: RNSBase64, route: str = "auto") -> torch.Tensor:
    """DcrtGgsw(s_i) of every LWE secret bit, ``(n_lwe, k+1, L, count, k+1,
    N)``, encrypted in one batch on the generator's device."""
    return dcrt_ggsw_encrypt(generator, lwe_secret, secret_ntt, basis, gaussian, plan, rns_base,
                             batch=(lwe_secret.shape[0],), route=route)


def from_jax_dcrt_state(*pairs, device="cuda"):
    """The reference's DCRT state -> the port's tensors: each argument is a
    ``U64(lo, hi)`` (or a ``(lo, hi)`` pair of u32 arrays) holding the
    bootstrap key ``(n_lwe, k+1, L, count, k+1, N)``, the NTT-domain secret
    ``(count, k, N)`` or accumulators; returns int64 tensors of the u64
    words on ``device`` (the card unless the caller asks for the CPU), in the
    same order."""
    return tuple(from_u64_pair((p[0], p[1]), device) for p in pairs)
