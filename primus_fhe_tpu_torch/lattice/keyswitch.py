"""LWE key switching via gadget decomposition (port of
``primus_fhe_tpu/lattice/keyswitch.py``).

    KSK[i, l] = LWE_{s'}( s_i * B^l * 2^drop )      (torus 2^32)
    switch(c) : out = (0, b) - sum_{i,l} d_l(a_i) * KSK[i, l]

No Pallas kernel stands behind it: it stays torch ops.  CUDA's
``torch.matmul`` takes no int64, so the contraction over ``(n_in, L)`` is an
int64 multiply-and-sum, chunked over ``n_in``.  The digits are centered
first (``|d| <= B/2``), so every product and the whole sum stay far below
2^63 and the final mask to 32 bits is exact.  No float enters the value
path.
"""

from __future__ import annotations

import torch

from ..decompose.primitive import ApproxSignedBasis32
from ..distr.sampling import DiscreteGaussian, uniform_u32
from ..numeric.limb import MASK32

# Budget of the int64 (batch, chunk, L, n_out+1) product built per chunk.
_CHUNK_BYTES = 256 << 20


def make_keyswitch_key(secret_in: torch.Tensor, secret_out: torch.Tensor,
                       basis: ApproxSignedBasis32, gaussian: DiscreteGaussian,
                       generator: torch.Generator) -> torch.Tensor:
    """KSK ``(n_in, level, n_out + 1)`` torus words.

    ``secret_in``: ``(n_in,)`` the extracted-domain secret (the flattened
    GLWE key); ``secret_out``: ``(n_out,)`` the target LWE secret;
    ``gaussian`` the LWE-side sampler (lwe_sigma).
    """
    n_in = secret_in.shape[0]
    n_out = secret_out.shape[0]
    level = basis.decompose_length
    a = uniform_u32(generator, (n_in, level, n_out))
    e = gaussian.sample_torus32(generator, (n_in, level))
    scal = torch.tensor([s & MASK32 for s in basis.scalars], dtype=torch.int64,
                        device=secret_in.device)
    msg = secret_in[:, None] * scal[None, :]  # (n_in, level)
    b = ((a * secret_out).sum(dim=-1) + msg + e) & MASK32
    return torch.cat([a, b.unsqueeze(-1)], dim=-1)


def key_switch(lwe: torch.Tensor, ksk: torch.Tensor, basis: ApproxSignedBasis32) -> torch.Tensor:
    """Switches ``(..., n_in + 1)`` LWE to ``(..., n_out + 1)`` under KSK."""
    n_in, level, n_out1 = ksk.shape
    batch = lwe.shape[:-1]
    lw = lwe.reshape(-1, n_in + 1)
    digits = basis.decompose(lw[:, :n_in]).permute(1, 2, 0)  # (B, n_in, level)
    digits = torch.where(digits >= 1 << 31, digits - (1 << 32), digits)  # centered
    bsz = lw.shape[0]
    chunk = max(1, min(n_in, _CHUNK_BYTES // max(1, bsz * level * n_out1 * 8)))
    acc = torch.zeros((bsz, n_out1), dtype=torch.int64, device=lwe.device)
    for i in range(0, n_in, chunk):
        prod = digits[:, i : i + chunk, :, None] * ksk[None, i : i + chunk]
        acc += prod.sum(dim=(1, 2))
    out = torch.zeros((bsz, n_out1), dtype=torch.int64, device=lwe.device)
    out[:, -1] = lw[:, n_in]
    return ((out - acc) & MASK32).reshape(*batch, n_out1)
