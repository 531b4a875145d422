"""TFHE blind-rotation bootstrapping (port of
``primus_fhe_tpu/boot/blind_rotate.py``).

1. **modulus switch**: LWE coefficients mod 2^32 -> rounded mod 2N,
2. **blind rotate**: ``acc <- acc + (acc * X^{a_i} - acc) ⊡ BSK_i`` over
   the LWE mask — a Python loop over the ``n_lwe`` key slices.  The key
   pack picks the step, as in the reference: an NTT-domain key tensor runs
   the fused two-kernel CMux (:mod:`..ops.cmux_fused`), an MXU pack
   ``(vals, precons)`` the one-kernel int8 CMux (:mod:`..ops.cmux_mxu`),
3. **sample extract**: GLWE coefficient 0 -> LWE.

The accumulator and the key are narrowed to int32 storage once per call and
stay narrowed across every step; the result is widened once at the end.
"""

from __future__ import annotations

import numpy as np
import torch

from ..lattice.rlwe import extract_lwe_torus32
from ..lattice.tfhe import ggsw_encrypt_torus
from ..numeric.limb import MASK32, narrow_u32, widen_u32
from ..ops.cmux_fused import fused_cmux_step
from ..ops.cmux_mxu import mxu_cmux_step, plan_for, prepare_mxu_bsk
from ..ops.rotate import rotate


def modulus_switch(lwe: torch.Tensor, log_2n: int) -> torch.Tensor:
    """``round(x * 2N / 2^32) mod 2N`` — the standard pre-rotation switch."""
    shift = 32 - log_2n
    half = 1 << (shift - 1)
    return ((((lwe + half) & MASK32) >> shift) & ((1 << log_2n) - 1)).to(torch.int32)


def blind_rotate(conv, basis, bsk_ntt, lwe_switched, test_poly):
    """Returns the rotated accumulator GLWE ``(..., k+1, N)``.

    ``bsk_ntt``: ``(n_lwe, kp, k+1, L, k+1, N)`` — GGSW(s_i) in NTT
    residues — or the MXU pack ``(vals, precons)``, each ``(n_lwe, kp,
    k+1, L, k+1, A, 128)`` (int64 or int32 storage); ``lwe_switched``:
    ``(..., n_lwe+1)`` int32 mod 2N; ``test_poly``: ``(N,)`` torus words.
    ``acc = (0, v * X^{-b})`` (kernel F on the card), then one CMux per
    mask element.
    """
    use_mxu = isinstance(bsk_ntt, (tuple, list))
    key = bsk_ntt[0] if use_mxu else bsk_ntt
    n_lwe, k1 = key.shape[0], key.shape[2]
    n = conv.n
    batch = lwe_switched.shape[:-1]
    sw = lwe_switched.reshape(-1, n_lwe + 1)
    bsz = sw.shape[0]

    acc = torch.zeros((bsz, k1, n), dtype=torch.int32, device=sw.device)
    acc[:, -1, :] = rotate(narrow_u32(test_poly).expand(bsz, n), -sw[:, n_lwe])  # kernel F
    a_t = sw[:, :n_lwe].t().to(torch.int32).contiguous()  # (n_lwe, B)
    if use_mxu:
        plan = plan_for(conv)
        kv = narrow_u32(bsk_ntt[0]).contiguous()
        kpre = narrow_u32(bsk_ntt[1]).contiguous()
        for i in range(n_lwe):
            acc = mxu_cmux_step(plan, basis, conv, acc, a_t[i], kv[i], kpre[i])
    else:
        key = narrow_u32(bsk_ntt).contiguous()
        for i in range(n_lwe):
            acc = fused_cmux_step(conv, basis, acc, a_t[i], key[i])
    return widen_u32(acc).reshape(*batch, k1, n)


def _bsk_coeff(lwe_secret, glwe_secret, basis, gaussian, conv, generator):
    """GGSW(s_i) for every LWE key bit, coefficient domain ``(n_lwe, k+1,
    L, k+1, N)``, all encrypted in one batch."""
    n = glwe_secret.shape[-1]
    mu = torch.zeros((lwe_secret.shape[0], n), dtype=torch.int64, device=lwe_secret.device)
    mu[:, 0] = lwe_secret
    return ggsw_encrypt_torus(mu, glwe_secret, basis, gaussian, conv, generator)


def make_bootstrap_key(lwe_secret, glwe_secret, basis, gaussian, conv, generator):
    """BSK_i = GGSW(s_i) under the GLWE secret, stacked
    ``(n_lwe, kp, k+1, L, k+1, N)`` in the NTT domain.

    ``gaussian`` is the GLWE-side sampler (glwe_sigma).  All ``n_lwe``
    GGSW encryptions and their forward transforms run as one batch.
    """
    ggsw_all = _bsk_coeff(lwe_secret, glwe_secret, basis, gaussian, conv, generator)
    # contiguous, so that every key slice the CMux loop hands on is one block
    return conv.forward(ggsw_all).movedim(0, 1).contiguous()


def make_bootstrap_key_mxu(lwe_secret, glwe_secret, basis, gaussian, conv, generator):
    """The MXU key pack ``(vals, precons)`` of the same GGSW material as
    :func:`make_bootstrap_key` (the same generator draws): the byte-radix
    forward transform (kernel C on a CUDA tensor) and exact Shoup
    quotients, each ``(n_lwe, kp, k+1, L, k+1, A, 128)``."""
    return prepare_mxu_bsk(conv, _bsk_coeff(lwe_secret, glwe_secret, basis, gaussian, conv,
                                            generator))


def test_polynomial(n: int, message_bits: int, device=None) -> torch.Tensor:
    """The negacyclic sign test vector: constant ``2^(32 - message_bits - 1)``."""
    return torch.full((n,), 1 << (32 - message_bits - 1), dtype=torch.int64, device=device)


def bootstrap(conv, basis, bsk_ntt, lwe_ct, test_poly, log_n: int):
    """Full pipeline: modulus switch -> blind rotate -> extract LWE."""
    switched = modulus_switch(lwe_ct, log_n + 1)
    acc = blind_rotate(conv, basis, bsk_ntt, switched, test_poly)
    return extract_lwe_torus32(acc)


def lut_test_polynomial(values, log_n: int, message_bits: int) -> torch.Tensor:
    """Programmable-bootstrap test vector for a lookup table ``values``
    ``(2^message_bits,)`` of torus outputs (negacyclic step encoding)."""
    n = 1 << log_n
    values = np.asarray(values, dtype=np.uint32)
    m_count = values.shape[0]
    reps = n // m_count
    if reps * m_count != n:
        raise ValueError("2^message_bits must divide N")
    tp = np.repeat(values, reps)
    tp = np.roll(tp, -(reps // 2))
    tp[-(reps // 2):] = (-tp[-(reps // 2):].astype(np.int64) % (1 << 32)).astype(np.uint32)
    return torch.from_numpy(tp.astype(np.int64))
