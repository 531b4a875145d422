"""Port vs reference: ``key_switch`` on a JAX-made key-switching key at
log_basis 1 (L=12, the BOOLEAN_128 gadget) and 8 (L=3), and the port's own
key by decryption.  Tolerance: zero (bit-equal) for the switch; the
decryption check bounds the phase error by the noise model."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primus_fhe_tpu.decompose import ApproxSignedBasis32 as JaxBasis
from primus_fhe_tpu.distr.sampling import DiscreteGaussian as JaxGaussian
from primus_fhe_tpu.lattice import keyswitch as jks
from primus_fhe_tpu_torch.decompose import ApproxSignedBasis32
from primus_fhe_tpu_torch.distr.sampling import DiscreteGaussian
from primus_fhe_tpu_torch.lattice import keyswitch
from primus_fhe_tpu_torch.lattice.lwe import phase_torus32

N_IN = 96
N_OUT = 24


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


@pytest.mark.parametrize("log_basis,level", [(1, 12), (8, 3)])
def test_key_switch_matches_reference(log_basis, level):
    rng = np.random.default_rng(log_basis)
    s_in = rng.integers(0, 2, N_IN).astype(np.uint32)
    s_out = rng.integers(0, 2, N_OUT).astype(np.uint32)
    jbasis = JaxBasis(None, log_basis, reverse_length=level)
    ksk = jks.make_keyswitch_key(
        jax.random.PRNGKey(log_basis), jnp.asarray(s_in), jnp.asarray(s_out), jbasis,
        JaxGaussian(3.2),
    )
    lwe = rng.integers(0, 1 << 32, (5, N_IN + 1), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jks.key_switch(jnp.asarray(lwe), ksk, jbasis)).astype(np.int64)
    basis = ApproxSignedBasis32(None, log_basis, reverse_length=level)
    got = keyswitch.key_switch(_t(lwe), _t(ksk), basis)
    np.testing.assert_array_equal(got.numpy(), want)
    # unbatched input takes the same path
    np.testing.assert_array_equal(keyswitch.key_switch(_t(lwe[0]), _t(ksk), basis).numpy(), want[0])


def test_key_switch_chunks_agree(monkeypatch):
    """A chunk budget far below the product size changes nothing."""
    rng = np.random.default_rng(4)
    basis = ApproxSignedBasis32(None, 1, reverse_length=12)
    ksk = _t(rng.integers(0, 1 << 32, (N_IN, 12, N_OUT + 1), dtype=np.uint64))
    lwe = _t(rng.integers(0, 1 << 32, (3, N_IN + 1), dtype=np.uint64))
    whole = keyswitch.key_switch(lwe, ksk, basis)
    monkeypatch.setattr(keyswitch, "_CHUNK_BYTES", 4096)
    assert torch.equal(keyswitch.key_switch(lwe, ksk, basis), whole)


def test_port_keyswitch_key_decrypts():
    """Port keygen at the BOOLEAN_128 gadget: the switched phase stays
    within 8 sigma of the key-switch noise (lwe sigma 2^10 here)."""
    g = torch.Generator().manual_seed(5)
    rng = np.random.default_rng(5)
    s_in = _t(rng.integers(0, 2, N_IN))
    s_out = _t(rng.integers(0, 2, N_OUT))
    basis = ApproxSignedBasis32(None, 1, reverse_length=12)
    sigma = 1024.0
    ksk = keyswitch.make_keyswitch_key(s_in, s_out, basis, DiscreteGaussian(sigma), g)
    assert ksk.shape == (N_IN, 12, N_OUT + 1)
    mu = _t(rng.integers(0, 1 << 32, 16, dtype=np.uint64))
    a = _t(rng.integers(0, 1 << 32, (16, N_IN), dtype=np.uint64))
    b = ((a * s_in).sum(-1) + mu) & 0xFFFFFFFF
    out = keyswitch.key_switch(torch.cat([a, b[:, None]], -1), ksk, basis)
    err = (phase_torus32(out, s_out) - mu) & 0xFFFFFFFF
    err = torch.where(err >= 1 << 31, err - (1 << 32), err).abs()
    drop = 1 << basis.drop_bits
    bound = 8 * (N_IN * 12 * sigma**2 / 3 + N_IN * drop**2 / 24) ** 0.5
    assert float(err.max()) < bound
