"""TFHE blind-rotation bootstrapping (port of
``primus_fhe_tpu/boot/blind_rotate.py``).

1. **modulus switch**: LWE coefficients mod 2^32 -> rounded mod 2N,
2. **blind rotate**: ``acc <- acc + (acc * X^{a_i} - acc) ⊡ BSK_i`` over
   the LWE mask — a Python loop over the ``n_lwe`` key slices.  The key
   pack picks the step, as in the reference: an NTT-domain key tensor runs
   the one-kernel CMux step (:mod:`..ops.cmux_fused`, its launch
   constants built once a rotation in a :class:`~..ops.cmux_fused.CmuxStepPlan`
   and the accumulator updated in place), an MXU pack
   ``(vals, precons)`` the one-kernel int8 CMux (:mod:`..ops.cmux_mxu`)
   where kernel A takes the shape, and elsewhere the NTT key's step on the
   pack's values, which are the NTT key's rows
   (:func:`mxu_pack_reads_quotients`, decided once a rotation; the pack
   carries no quotients there),
3. **sample extract**: GLWE coefficient 0 -> LWE.

The accumulator and the key are narrowed to int32 storage once per call and
stay narrowed across every step; the result is widened once at the end.
"""

from __future__ import annotations

import numpy as np
import torch

from ..lattice.rlwe import extract_lwe_torus32
from ..lattice.glwe import zero_sample_draws, zero_samples_from
from ..lattice.tfhe import ggsw_encrypt_torus, ggsw_from_zero_samples
from ..numeric.limb import MASK32, narrow_u32, widen_u32
from ..ops.cmux_fused import CmuxStepPlan
from ..ops.cmux_mxu import (digit_planes, mxu_cmux_step, mxu_key_values, mxu_step_route,
                            plan_for, shoup_precons)
from ..ops.rotate import rotate


def modulus_switch(lwe: torch.Tensor, log_2n: int) -> torch.Tensor:
    """``round(x * 2N / 2^32) mod 2N`` — the standard pre-rotation switch."""
    shift = 32 - log_2n
    half = 1 << (shift - 1)
    return ((((lwe + half) & MASK32) >> shift) & ((1 << log_2n) - 1)).to(torch.int32)


def initial_accumulator(test_poly, degrees, k1: int) -> torch.Tensor:
    """``acc = (0, ..., 0, v * X^degrees[b])``, ``(B, k1, N)`` int32, for the
    test polynomial ``v (N,)``: kernel F on the card reads the one test row
    in place for every ciphertext (a broadcast view) and writes the
    accumulator's last component, so the start is one launch beside the
    zero fill."""
    bsz, n = degrees.shape[0], test_poly.shape[-1]
    acc = torch.zeros((bsz, k1, n), dtype=torch.int32, device=degrees.device)
    rotate(narrow_u32(test_poly).expand(bsz, n), degrees, out=acc[:, -1, :])
    return acc


def blind_rotate(conv, basis, bsk_ntt, lwe_switched, test_poly):
    """Returns the rotated accumulator GLWE ``(..., k+1, N)``.

    ``bsk_ntt``: ``(n_lwe, kp, k+1, L, k+1, N)`` — GGSW(s_i) in NTT
    residues — or the MXU pack ``(vals, precons)``, each ``(n_lwe, kp,
    k+1, L, k+1, A, 128)`` (int64 or int32 storage; ``precons`` None where
    the step does not read them, :func:`mxu_pack_reads_quotients`);
    ``lwe_switched``: ``(..., n_lwe+1)`` int32 mod 2N; ``test_poly``:
    ``(N,)`` torus words.
    ``acc = (0, v * X^{-b})`` (:func:`initial_accumulator`), then one CMux
    per mask element.
    """
    use_mxu = isinstance(bsk_ntt, (tuple, list))
    key = bsk_ntt[0] if use_mxu else bsk_ntt
    n_lwe, k1 = key.shape[0], key.shape[2]
    n = conv.n
    batch = lwe_switched.shape[:-1]
    sw = lwe_switched.reshape(-1, n_lwe + 1)
    bsz = sw.shape[0]

    acc = initial_accumulator(test_poly, -sw[:, n_lwe], k1)
    a_t = sw[:, :n_lwe].t().to(torch.int32).contiguous()  # (n_lwe, B)
    level = basis.decompose_length
    if use_mxu and mxu_pack_reads_quotients(conv, basis, k1, sw.device):
        plan = plan_for(conv)
        kv = narrow_u32(bsk_ntt[0]).contiguous()
        kpre = narrow_u32(bsk_ntt[1]).contiguous()
        for i in range(n_lwe):
            acc = mxu_cmux_step(plan, basis, conv, acc, a_t[i], kv[i], kpre[i])
    else:  # the NTT key, or the MXU pack's values: the same canonical NTT rows
        key = narrow_u32(key).reshape(n_lwe, conv.count, k1, level, k1, n).contiguous()
        step = CmuxStepPlan(conv, basis, k1, sw.device)
        for i in range(n_lwe):
            acc = step(acc, a_t[i], key[i], out=acc)
    return widen_u32(acc).reshape(*batch, k1, n)


def mxu_pack_reads_quotients(conv, basis, k1: int, device) -> bool:
    """Whether a rotation on the MXU pack reads its Shoup quotients: on the
    CPU (kernel A's plain version takes the pack whole) and on the card
    where kernel A takes the step (:func:`~..ops.cmux_mxu.mxu_step_route`
    ``"mxu"``).  Past kernel A the step runs on the pack's values alone."""
    return torch.device(device).type == "cpu" or mxu_step_route(
        conv.count, k1, basis.decompose_length, conv.log_n, digit_planes(basis)) == "mxu"


KEY_CHUNK_WORDS = 1 << 27  # NTT-domain words of a chunk of the key (1 GB of int64)


def _bsk_messages(lwe_secret: torch.Tensor, n: int) -> torch.Tensor:
    """The GGSW messages ``s_i`` as constant polynomials ``(n_lwe, N)``."""
    mu = torch.zeros((lwe_secret.shape[0], n), dtype=torch.int64, device=lwe_secret.device)
    mu[:, 0] = lwe_secret
    return mu


def _bsk_coeff(lwe_secret, glwe_secret, basis, gaussian, conv, generator):
    """GGSW(s_i) for every LWE key bit, coefficient domain ``(n_lwe, k+1,
    L, k+1, N)``, all encrypted in one batch: the words (and the generator
    draws) that :func:`_chunked_key`'s chunks reproduce."""
    mu = _bsk_messages(lwe_secret, glwe_secret.shape[-1])
    return ggsw_encrypt_torus(mu, glwe_secret, basis, gaussian, conv, generator)


def _chunked_key(lwe_secret, glwe_secret, basis, gaussian, conv, generator, transform):
    """GGSW(s_i) for every LWE key bit under the GLWE secret, each chunk of
    coefficient-domain GGSWs ``(m, k+1, L, k+1, N)`` mapped by ``transform``
    into a preallocated ``(n_lwe, ...)`` key.

    The random draws of all ``n_lwe`` GGSW encryptions are taken in one
    batch, in the order of :func:`..lattice.tfhe.ggsw_encrypt_torus` on all
    of them; the samples, the messages and ``transform`` then run on chunks
    of LWE indices of at most :data:`KEY_CHUNK_WORDS` key words each (at
    least one index).  Each GGSW depends on its own draws alone, so the key
    is the one-batch key word for word, and the generator's state after the
    call is the one-batch call's; the working set is a chunk's, not the
    key's (BOOLEAN_128's whole key is one chunk; at N = 2^17 the one-batch
    transforms would pass 80 GB)."""
    n_lwe = lwe_secret.shape[0]
    k, n = glwe_secret.shape
    level = basis.decompose_length
    a, e = zero_sample_draws(glwe_secret, gaussian, generator, (n_lwe, k + 1, level))
    mu = _bsk_messages(lwe_secret, n)
    step = max(1, KEY_CHUNK_WORDS // (conv.count * (k + 1) * level * (k + 1) * n))
    key = None
    for i in range(0, n_lwe, step):
        j = slice(i, i + step)
        part = transform(ggsw_from_zero_samples(
            mu[j], zero_samples_from(glwe_secret, conv, a[j], e[j]), basis))
        if key is None:
            key = torch.empty((n_lwe,) + tuple(part.shape[1:]), dtype=part.dtype,
                              device=part.device)
        key[j] = part
    return key


def make_bootstrap_key(lwe_secret, glwe_secret, basis, gaussian, conv, generator):
    """BSK_i = GGSW(s_i) under the GLWE secret, stacked
    ``(n_lwe, kp, k+1, L, k+1, N)`` in the NTT domain (contiguous, so that
    every key slice the CMux loop hands on is one block), made in chunks
    (:func:`_chunked_key`).  ``gaussian`` is the GLWE-side sampler
    (glwe_sigma).  The key's canonical words are stored as their 32 bits
    (int32, :func:`..numeric.limb.narrow_u32`), the storage the CMux step
    reads, so :func:`blind_rotate` copies nothing a call: half the int64
    key's bytes (23.8 GB at N = 2^18, kp 3)."""
    return _chunked_key(lwe_secret, glwe_secret, basis, gaussian, conv, generator,
                        lambda ggsw: narrow_u32(conv.forward(ggsw).movedim(0, 1)))


def make_bootstrap_key_mxu(lwe_secret, glwe_secret, basis, gaussian, conv, generator):
    """The MXU key pack ``(vals, precons)`` of the same GGSW material as
    :func:`make_bootstrap_key` (the same generator draws, the same chunks):
    ``vals`` the canonical forward transform (:func:`~..ops.cmux_mxu.
    mxu_key_values`: kernel C, or kernel 1 at ``log_n`` 13-17, on a CUDA
    tensor), ``(n_lwe, kp, k+1, L, k+1, A, 128)`` int64; ``precons`` its
    exact Shoup quotients, the same shape, where a rotation reads them (on
    the CPU, and on the card where kernel A takes the step:
    :func:`mxu_pack_reads_quotients`), else None (past kernel A the step
    reads the values alone: at N = 2^17 the values are 23.8 GB)."""
    vals = _chunked_key(lwe_secret, glwe_secret, basis, gaussian, conv, generator,
                        lambda ggsw: mxu_key_values(conv, ggsw))
    if not mxu_pack_reads_quotients(conv, basis, glwe_secret.shape[0] + 1, vals.device):
        return vals, None
    return vals, shoup_precons(vals, conv.primes, 1).contiguous()


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
