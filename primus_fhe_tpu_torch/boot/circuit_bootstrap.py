"""Circuit bootstrapping: LWE(bit) -> GGSW(bit) (port of
``primus_fhe_tpu/boot/circuit_bootstrap.py``).

The composite that turns leveled TFHE into fully composable circuits
(Chillotti et al.): for every gadget level, a programmable bootstrap
produces ``LWE(m * B^l * 2^drop)`` under the extracted key; private
functional key switches then place each level into the GGSW rows — row
``j < k`` needs phase ``-s_j * m * B^l`` (function ``f_j(x) = s_j x``), the
body row needs phase ``m * B^l`` (function ``f(x) = -x``).

Private functional key switch (the generalization of the packing switch):

    sigma       = (s_ext_1 .. s_ext_n, -1)          extended secret
    K_{i,l}     = GLWE_s( f(sigma_i) * B^l * 2^drop )
    out         = sum_{i,l} decomp_l(c_i) * K_{i,l},  c = (a, b)
    phase(out) ~= f(sum a_i s_i - b) = f(-mu)

so ``f = s_j x`` yields ``-s_j mu`` and ``f = -x`` yields ``mu``.

On the card a circuit bootstrap is ``L_cb`` bootstraps (each 630 launches of
the CMux step kernel and one of kernel F at BOOLEAN_128) and ``(k+1) L_cb``
private switches, each a torch MAC (:func:`..lattice.glwe_keyswitch.gadget_mac`:
the digits are constant polynomials, so their residues serve every NTT slot
and no forward transform runs) and one launch of kernel 2.
"""

from __future__ import annotations

import torch

from ..decompose.primitive import ApproxSignedBasis32
from ..distr.sampling import DiscreteGaussian
from ..lattice.glwe import generate_random_zero_sample_torus
from ..lattice.glwe_keyswitch import gadget_mac
from ..numeric.limb import MASK32, mul_lo_u32
from ..transforms.torus import TorusConvolver32
from .blind_rotate import bootstrap


def make_private_functional_ksk(f_poly: torch.Tensor, ext_secret: torch.Tensor,
                                glwe_secret: torch.Tensor, basis: ApproxSignedBasis32,
                                gaussian: DiscreteGaussian, conv: TorusConvolver32,
                                generator: torch.Generator) -> torch.Tensor:
    """KSK ``(kp, n_ext+1, L, k+1, N)``: entry ``(i, l)`` encrypts ``f_poly *
    sigma_i * B^l * 2^drop`` under ``glwe_secret (k, N)``, with ``sigma =
    (ext_secret, -1)``; ``f_poly (N,)`` is the function's torus polynomial.
    Every zero sample is drawn in one batch from ``generator``."""
    n_ext = ext_secret.shape[0]
    level = basis.decompose_length
    zs = generate_random_zero_sample_torus(glwe_secret, gaussian, conv, generator,
                                           (n_ext + 1, level))  # (n_ext+1, L, k+1, N)
    sigma = torch.cat([ext_secret, ext_secret.new_full((1,), MASK32)])  # -1 == 2^32 - 1
    scal = torch.tensor([s & MASK32 for s in basis.scalars], dtype=torch.int64,
                        device=ext_secret.device)
    # two words multiply mod 2^32 through 16-bit halves (f = -x and sigma = -1
    # are both 2^32 - 1); times a power of two below 2^32 stays below 2^63
    f_sigma = mul_lo_u32(f_poly[None, :], sigma[:, None])  # (n_ext+1, N)
    zs[..., -1, :] += (f_sigma[:, None, :] * scal[None, :, None]) & MASK32
    return conv.forward(zs & MASK32)


def private_functional_key_switch(conv: TorusConvolver32, basis: ApproxSignedBasis32,
                                  lwe: torch.Tensor, ksk_ntt: torch.Tensor) -> torch.Tensor:
    """``sum_{i,l} decomp_l(c_i) ⊡ K_{i,l}`` for one LWE ``(n_ext+1,)`` (its
    whole ``(a, b)`` vector): a GLWE ``(k+1, N)``.

    A constant polynomial is constant across the NTT slots, so the scalar
    digits' centered residues go straight into the MAC, one per ``(i, l)``.
    """
    digits = basis.decompose(lwe).movedim(0, -1)  # (n_ext+1, L)
    res = conv.lift(digits).unsqueeze(-1)  # (kp, n_ext+1, L, 1)
    return conv.recombine(conv.inverse(gadget_mac(conv, res, ksk_ntt, 0)))


def circuit_bootstrap(conv_pbs: TorusConvolver32, basis_pbs: ApproxSignedBasis32, bsk_ntt,
                      conv_ks: TorusConvolver32, basis_cb: ApproxSignedBasis32,
                      basis_priv: ApproxSignedBasis32, priv_ksks, lwe_ct: torch.Tensor,
                      log_n: int) -> torch.Tensor:
    """LWE(bit) -> GGSW(bit) ``(k+1, L_cb, k+1, N)``, coefficient domain.

    ``bsk_ntt``: the bootstrap key (an NTT key or the MXU pack, as
    :func:`.blind_rotate.bootstrap` takes); ``priv_ksks``: the ``k+1``
    private KSKs (rows ``j < k``: ``f = s_j x``; row ``k``: ``f = -x``);
    ``lwe_ct (n_lwe+1,)`` encrypts ``m`` in ``{0, 1}`` at ``m * 2^31``.
    """
    n = 1 << log_n
    # shift phases off the sign-bucket boundaries: m/2 -> m/2 + 1/4, so m=0
    # lands in the lower half and m=1 in the upper half
    lin = lwe_ct.clone()
    lin[-1] = (lin[-1] + (1 << 30)) & MASK32
    rows = [[] for _ in priv_ksks]
    for scal in basis_cb.scalars:
        half = (scal & MASK32) // 2
        # v = -scalar/2: the sign test gives -scalar/2 for m=0 and +scalar/2
        # for m=1 (the upper half negates); adding scalar/2 gives {0, scalar}
        test_poly = torch.full((n,), -half & MASK32, dtype=torch.int64, device=lwe_ct.device)
        big = bootstrap(conv_pbs, basis_pbs, bsk_ntt, lin, test_poly, log_n)
        big[-1] = (big[-1] + half) & MASK32
        for row, ksk in zip(rows, priv_ksks):
            row.append(private_functional_key_switch(conv_ks, basis_priv, big, ksk))
    return torch.stack([torch.stack(r) for r in rows])
