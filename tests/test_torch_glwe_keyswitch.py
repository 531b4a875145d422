"""The GLWE -> GLWE key switch and the LWE -> GLWE packing switch through the
port, at the JAX tests' sizes (``tests/test_glwe_keyswitch.py``: N=32,
gadget 2^8 x 3; k_in 2 -> k_out 1; 4 LWEs of dimension 16 packed).

1. On keys made by the JAX package (``from_jax_ntt_key``) the port's
   ``glwe_key_switch`` and ``pack_lwes`` equal the JAX outputs word for
   word (tolerance: zero), also with the MAC cut into chunks of one input
   component.  The JAX work runs once, in a module fixture.
2. The port's own keys (``torch.Generator``) preserve the phase: within
   delta/4 after the switch, and every packed coefficient decrypts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primus_fhe_tpu.decompose import ApproxSignedBasis32 as JaxBasis
from primus_fhe_tpu.distr.sampling import DiscreteGaussian as JaxGaussian
from primus_fhe_tpu.lattice import glwe as jglwe
from primus_fhe_tpu.lattice import glwe_keyswitch as jks
from primus_fhe_tpu.lattice.tfhe import external_product_bound_bits
from primus_fhe_tpu.transforms.torus import TorusConvolver32 as JaxConvolver
from primus_fhe_tpu_torch.decompose import ApproxSignedBasis32
from primus_fhe_tpu_torch.distr.sampling import DiscreteGaussian, sample_binary
from primus_fhe_tpu_torch.lattice import glwe, glwe_keyswitch as ks
from primus_fhe_tpu_torch.lattice.lwe import encrypt_torus32
from primus_fhe_tpu_torch.lattice.tfhe import external_product_bound_bits as bound_bits
from primus_fhe_tpu_torch.params import from_jax_ntt_key
from primus_fhe_tpu_torch.transforms.torus import TorusConvolver32

LOG_N, N = 5, 32
K_IN, K_OUT = 2, 1
LB, LV = 8, 3
N_LWE = 16
MASK32 = 0xFFFFFFFF


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _centered(x):
    x = np.asarray(x).astype(np.int64)
    return np.where(x >= 1 << 31, x - (1 << 32), x)


def _bits(key, shape):
    return (jax.random.bits(key, shape, dtype=jnp.uint32) & 1).astype(jnp.uint32)


@pytest.fixture(scope="module")
def jax_run():
    basis = JaxBasis(None, LB, reverse_length=LV)
    gauss = JaxGaussian(3.2)
    # the GLWE switch (tests/test_glwe_keyswitch.py's first test)
    conv = JaxConvolver(LOG_N, external_product_bound_bits(N, LV, max(K_IN, K_OUT), LB))
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(13), 4)
    s_in, s_out = _bits(k1, (K_IN, N)), _bits(k2, (K_OUT, N))
    ksk = jks.make_glwe_keyswitch_key(k3, s_in, s_out, basis, gauss, conv)
    msg = (np.arange(N, dtype=np.uint32) % 8) << 27
    ct = jglwe.encrypt_torus(k4, jnp.asarray(msg), s_in, gauss, conv)
    cts = jnp.stack([ct, jglwe.encrypt_torus(jax.random.fold_in(k4, 1), jnp.asarray(msg[::-1]),
                                             s_in, gauss, conv)])
    switched = jks.glwe_key_switch(conv, basis, cts, ksk)
    # the packing switch (its second test)
    pconv = JaxConvolver(LOG_N, external_product_bound_bits(N, LV, 1, LB))
    p1, p2, p3, p4 = jax.random.split(jax.random.PRNGKey(23), 4)
    lwe_s, glwe_s = _bits(p1, (N_LWE,)), _bits(p2, (1, N))
    pksk = jks.make_packing_keyswitch_key(p3, lwe_s, glwe_s, basis, gauss, pconv)
    lwes = []
    for j, m in enumerate([1, 3, 0, 2]):
        a = jax.random.bits(jax.random.fold_in(p4, j), (N_LWE,), dtype=jnp.uint32)
        lwes.append(jnp.concatenate([a, (jnp.sum(a * lwe_s, dtype=jnp.uint32)
                                         + jnp.uint32(m << 28))[None]]))
    lwes = jnp.stack(lwes)
    packed = jks.pack_lwes(pconv, basis, lwes, pksk)
    return dict(primes=list(conv.primes), pprimes=list(pconv.primes), ksk=np.asarray(ksk),
                cts=np.asarray(cts), switched=np.asarray(switched), pksk=np.asarray(pksk),
                lwes=np.asarray(lwes), packed=np.asarray(packed))


@pytest.fixture(scope="module")
def port_convs(jax_run):
    conv = TorusConvolver32(LOG_N, bound_bits(N, LV, max(K_IN, K_OUT), LB))
    pconv = TorusConvolver32(LOG_N, bound_bits(N, LV, 1, LB))
    assert conv.primes == jax_run["primes"] and pconv.primes == jax_run["pprimes"]
    return conv, pconv, ApproxSignedBasis32(None, LB, reverse_length=LV)


@pytest.mark.parametrize("chunk_bytes", [None, 1], ids=["one_chunk", "a_component_a_chunk"])
def test_glwe_key_switch_matches_jax(jax_run, port_convs, monkeypatch, chunk_bytes):
    conv, _, basis = port_convs
    if chunk_bytes is not None:
        monkeypatch.setattr(ks, "_CHUNK_BYTES", chunk_bytes)
    ksk = from_jax_ntt_key(jax_run["ksk"], conv, device="cpu")
    got = ks.glwe_key_switch(conv, basis, _t(jax_run["cts"]), ksk)
    assert got.shape == (2, K_OUT + 1, N)
    np.testing.assert_array_equal(got.numpy(), jax_run["switched"].astype(np.int64))


@pytest.mark.parametrize("chunk_bytes", [None, 1], ids=["one_chunk", "a_component_a_chunk"])
def test_pack_lwes_matches_jax(jax_run, port_convs, monkeypatch, chunk_bytes):
    _, pconv, basis = port_convs
    if chunk_bytes is not None:
        monkeypatch.setattr(ks, "_CHUNK_BYTES", chunk_bytes)
    pksk = from_jax_ntt_key(jax_run["pksk"], pconv, device="cpu")
    got = ks.pack_lwes(pconv, basis, _t(jax_run["lwes"]), pksk)
    np.testing.assert_array_equal(got.numpy(), jax_run["packed"].astype(np.int64))


def test_own_glwe_key_switch_preserves_phase(port_convs):
    conv, _, basis = port_convs
    gen = torch.Generator().manual_seed(3)
    gauss = DiscreteGaussian(3.2)
    s_in, s_out = sample_binary(gen, (K_IN, N)), sample_binary(gen, (K_OUT, N))
    ksk = ks.make_glwe_keyswitch_key(s_in, s_out, basis, gauss, conv, gen)
    assert ksk.shape == (conv.count, K_IN, LV, K_OUT + 1, N)
    delta = 1 << 27
    msg = (torch.arange(N) % 8) * delta
    out = ks.glwe_key_switch(conv, basis, glwe.encrypt_torus(msg, s_in, gauss, conv, gen), ksk)
    assert out.shape == (K_OUT + 1, N)
    err = _centered((glwe.phase_torus(out, s_out, conv) - msg).numpy() & MASK32)
    assert np.abs(err).max() < delta // 4, np.abs(err).max()


def test_own_pack_lwes_decrypts(port_convs):
    _, pconv, basis = port_convs
    gen = torch.Generator().manual_seed(4)
    gauss = DiscreteGaussian(3.2)
    lwe_s, glwe_s = sample_binary(gen, (N_LWE,)), sample_binary(gen, (1, N))
    pksk = ks.make_packing_keyswitch_key(lwe_s, glwe_s, basis, gauss, pconv, gen)
    delta = 1 << 28
    msgs = torch.randint(0, 4, (N,), generator=gen)
    lwes = encrypt_torus32(msgs * delta, lwe_s, gauss, gen)  # N samples: every coefficient
    packed = ks.pack_lwes(pconv, basis, lwes, pksk)
    err = _centered((glwe.phase_torus(packed, glwe_s, pconv) - msgs * delta).numpy() & MASK32)
    assert np.abs(err).max() < delta // 4, np.abs(err).max()
    with pytest.raises(ValueError):
        ks.pack_lwes(pconv, basis, torch.cat([lwes, lwes[:1]]), pksk)
