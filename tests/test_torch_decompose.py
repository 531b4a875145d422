"""Port vs reference: ``ApproxSignedBasis32`` in torus mode, including the
BOOLEAN_128 key-switch gadget (2^1 x 12) and bootstrap gadget (2^7 x 3), and
in mod-q mode, including the NTRU_128 gadgets (2^3 x 6 and 2^1 x 16 mod
q = 1038337) with values at and around ``wrap_threshold``.  Tolerance: zero
(bit-equal digits)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primus_fhe_tpu.decompose import ApproxSignedBasis32 as JaxBasis
from primus_fhe_tpu_torch.decompose import ApproxSignedBasis32

FIELDS = (
    "basis", "basis_minus_one", "modulus_minus_basis", "decompose_length", "drop_bits",
    "carry_mask", "init_carry_mask", "scalars", "shr_bits", "approximate_error_bound",
)


@pytest.mark.parametrize("log_basis,level", [(7, 3), (1, 12), (8, 3), (8, None)])
def test_decompose_matches_reference(log_basis, level):
    port = ApproxSignedBasis32(None, log_basis, reverse_length=level)
    ref = JaxBasis(None, log_basis, reverse_length=level)
    for name in FIELDS:
        assert getattr(port, name) == getattr(ref, name), name
    rng = np.random.default_rng(log_basis * 100 + (level or 0))
    v = rng.integers(0, 1 << 32, 8192, dtype=np.uint64).astype(np.uint32)
    v[:6] = [0, 1, (1 << 31) - 1, 1 << 31, (1 << 32) - 1, 1 << (32 - log_basis)]
    got = port.decompose(torch.from_numpy(v.astype(np.int64)).reshape(4, 2048))
    want = np.asarray(ref.decompose(jnp.asarray(v.reshape(4, 2048)))).astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("log_basis,level", [(7, 3), (1, 12)])
def test_digits_recompose_within_drop_error(log_basis, level):
    """Sum of signed digits times the gadget scalars is the value up to the
    approximation bound, and every digit is within [-B/2, B/2]."""
    port = ApproxSignedBasis32(None, log_basis, reverse_length=level)
    rng = np.random.default_rng(7)
    v = torch.from_numpy(rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.int64))
    d = port.decompose(v)
    signed = torch.where(d >= 1 << 31, d - (1 << 32), d)
    assert int(signed.abs().max()) <= port.basis // 2
    scal = torch.tensor(port.scalars, dtype=torch.int64)[:, None]
    rec = (signed * scal).sum(0) & 0xFFFFFFFF
    err = (v - rec) & 0xFFFFFFFF
    err = torch.where(err >= 1 << 31, err - (1 << 32), err)
    assert int(err.abs().max()) <= port.approximate_error_bound


MODQ_FIELDS = FIELDS + ("modulus", "value_bits", "wrap_threshold", "adjust_add")
Q_NTRU = 1038337  # NTRU_128's q = next_ntt_prime(20, 10)


def test_mod_q_mode_is_not_ported():
    """The mod-q mode is ported now: its derived parameters equal the
    reference's for a 30-bit prime, where no wrap threshold exists."""
    port = ApproxSignedBasis32(1073692673, 8)
    ref = JaxBasis(1073692673, 8)
    for name in MODQ_FIELDS:
        assert getattr(port, name) == getattr(ref, name), name


@pytest.mark.parametrize(
    "q,log_basis,level",
    [(Q_NTRU, 3, 6), (Q_NTRU, 1, 16), (Q_NTRU, 4, None), (1073692673, 10, 3), (257, 1, None),
     (1048573, 1, 17)],  # the last: log_basis 1 with a wrap threshold
)
def test_mod_q_decompose_matches_reference(q, log_basis, level):
    port = ApproxSignedBasis32(q, log_basis, reverse_length=level)
    ref = JaxBasis(q, log_basis, reverse_length=level)
    for name in MODQ_FIELDS:
        assert getattr(port, name) == getattr(ref, name), name
    rng = np.random.default_rng(q % 1000 + log_basis)
    v = rng.integers(0, q, 4096, dtype=np.int64)
    edge = [0, 1, q - 1, q // 2, q // 2 + 1]
    thr = ref.wrap_threshold
    if thr is not None:
        edge += [thr - 1, thr, thr + 1]
    v[: len(edge)] = edge
    got = port.decompose(torch.from_numpy(v).reshape(4, 1024))
    want = np.asarray(ref.decompose(jnp.asarray(v.astype(np.uint32).reshape(4, 1024))))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert int(got.max()) < q
