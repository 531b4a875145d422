"""Circuit bootstrapping (LWE bit -> GGSW), ``ggsw_to_ntt`` and the leveled
MUX through the port, at the JAX test's sizes (``tests/test_circuit_bootstrap.py``:
N=32, k=1, n_lwe=8, PBS gadget 2^8 x 3, circuit-bootstrap gadget 2^8 x 2,
private-switch gadget 2^8 x 3).

1. On keys made by the JAX package (carried across by ``from_jax_ntt_key``)
   the port's private functional key switch (mask row ``f = s_0 x`` and
   body row ``f = -x``), ``circuit_bootstrap`` for bits 0 and 1,
   ``ggsw_to_ntt``, ``external_product`` on its result and ``leveled_mux``
   equal the JAX outputs word for word (tolerance: zero).  The JAX work
   runs once, in a module fixture.
2. The port's own keys (drawn from a ``torch.Generator``): every private
   KSK entry decrypts to ``f * sigma_i * B^l * 2^drop`` within the
   sampler's bound (the body row's last entry is ``(-1)(-1) = 1``, a product
   of two words 2^32 - 1), and the port's circuit bootstrap then MUX
   selects the right input on every coefficient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primus_fhe_tpu.boot import make_bootstrap_key as jax_make_bootstrap_key
from primus_fhe_tpu.boot import circuit_bootstrap as jcb
from primus_fhe_tpu.boot import gates as jgates
from primus_fhe_tpu.decompose import ApproxSignedBasis32 as JaxBasis
from primus_fhe_tpu.distr.sampling import DiscreteGaussian as JaxGaussian
from primus_fhe_tpu.lattice import glwe as jglwe
from primus_fhe_tpu.lattice import tfhe as jtfhe
from primus_fhe_tpu_torch.boot import circuit_bootstrap as cb
from primus_fhe_tpu_torch.boot.blind_rotate import make_bootstrap_key
from primus_fhe_tpu_torch.boot.gates import leveled_mux
from primus_fhe_tpu_torch.decompose import ApproxSignedBasis32
from primus_fhe_tpu_torch.distr.sampling import DiscreteGaussian, sample_binary
from primus_fhe_tpu_torch.lattice import glwe, tfhe
from primus_fhe_tpu_torch.lattice.lwe import encrypt_torus32
from primus_fhe_tpu_torch.params import from_jax_ntt_key

LOG_N, N, K, N_LWE = 5, 32, 1, 8
LB_PBS, LV_PBS = 8, 3
LB_CB, LV_CB = 8, 2
LB_PRIV, LV_PRIV = 8, 3
SIGMA = 3.2
BOUND = int(np.ceil(SIGMA * 10)) + 1  # the CDT sampler's largest |e| (tail cut 10 sigma)
MASK32 = 0xFFFFFFFF


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _np(x):
    return np.asarray(x).astype(np.int64)


def _centered(x):
    x = np.asarray(x).astype(np.int64)
    return np.where(x >= 1 << 31, x - (1 << 32), x)


def _jax_glwe(key, msg, secret, gauss, conv):
    return jglwe.encrypt_torus(key, jnp.asarray(msg.astype(np.uint32)), secret, gauss, conv)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX test's keys, and every JAX output the parity tests compare
    with, computed once."""
    basis_pbs = JaxBasis(None, LB_PBS, reverse_length=LV_PBS)
    basis_cb = JaxBasis(None, LB_CB, reverse_length=LV_CB)
    basis_priv = JaxBasis(None, LB_PRIV, reverse_length=LV_PRIV)
    conv = jtfhe.make_convolver(LOG_N, max(LV_PBS, LV_PRIV), K, 8)
    gauss = JaxGaussian(SIGMA)
    k1, k2, k3, k4, k5 = jax.random.split(jax.random.PRNGKey(31), 5)
    lwe_s = (jax.random.bits(k1, (N_LWE,), dtype=jnp.uint32) & 1).astype(jnp.uint32)
    glwe_s = (jax.random.bits(k2, (K, N), dtype=jnp.uint32) & 1).astype(jnp.uint32)
    bsk = jax_make_bootstrap_key(k3, lwe_s, glwe_s, basis_pbs, gauss, conv)
    ext = glwe_s.reshape(-1)
    minus_one = jnp.zeros(N, dtype=jnp.uint32).at[0].set(jnp.uint32(MASK32))
    fs = [glwe_s[0], minus_one]  # mask row f = s_0 x, body row f = -x
    ksks = [jcb.make_private_functional_ksk(jax.random.fold_in(k4, j), f, ext, glwe_s,
                                            basis_priv, gauss, conv) for j, f in enumerate(fs)]
    rng = np.random.default_rng(5)
    big = rng.integers(0, 1 << 32, (K * N + 1,), dtype=np.uint64).astype(np.uint32)
    switched = [jcb.private_functional_key_switch(conv, basis_priv, jnp.asarray(big), ksk)
                for ksk in ksks]
    out = {"big": big, "switched": [_np(s) for s in switched], "bits": {}}
    for bit in (0, 1):
        kb = jax.random.fold_in(k5, bit)
        a = jax.random.bits(kb, (N_LWE,), dtype=jnp.uint32)
        ct = jnp.concatenate([a, (jnp.sum(a * lwe_s, dtype=jnp.uint32)
                                  + jnp.uint32(bit << 31))[None]])
        ggsw = jcb.circuit_bootstrap(conv, basis_pbs, bsk, conv, basis_cb, basis_priv, ksks, ct,
                                     LOG_N)
        ggsw_ntt = jtfhe.ggsw_to_ntt(conv, ggsw)
        msg = rng.integers(0, 8, N) << 28
        cx = _jax_glwe(jax.random.fold_in(kb, 1), msg, glwe_s, gauss, conv)
        cy = _jax_glwe(jax.random.fold_in(kb, 2), (msg + (1 << 30)) & MASK32, glwe_s, gauss,
                       conv)
        out["bits"][bit] = dict(
            ct=_np(ct), ggsw=_np(ggsw), ggsw_ntt=_np(ggsw_ntt), cx=_np(cx), cy=_np(cy),
            product=_np(jtfhe.external_product(conv, basis_cb, cx, ggsw_ntt)),
            mux=_np(jgates.leveled_mux(conv, basis_cb, ggsw_ntt, cx, cy)),
        )
    keys = dict(bsk=_np(bsk), ksks=[np.asarray(k) for k in ksks], glwe_s=_np(glwe_s),
                primes=list(conv.primes))
    return keys, out


@pytest.fixture(scope="module")
def port(jax_run):
    keys, _ = jax_run
    basis_pbs = ApproxSignedBasis32(None, LB_PBS, reverse_length=LV_PBS)
    basis_cb = ApproxSignedBasis32(None, LB_CB, reverse_length=LV_CB)
    basis_priv = ApproxSignedBasis32(None, LB_PRIV, reverse_length=LV_PRIV)
    conv = tfhe.make_convolver(LOG_N, max(LV_PBS, LV_PRIV), K, 8)
    assert conv.primes == keys["primes"]
    ksks = [from_jax_ntt_key(k, conv, device="cpu") for k in keys["ksks"]]
    return conv, basis_pbs, basis_cb, basis_priv, _t(keys["bsk"]), ksks


def test_from_jax_ntt_key_checks_words(port, jax_run):
    conv = port[0]
    ksk = np.asarray(jax_run[0]["ksks"][0])
    got = from_jax_ntt_key(ksk, conv, device="cpu")
    assert got.dtype == torch.int64 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), ksk.astype(np.int64))
    bad = ksk.astype(np.int64).copy()
    bad[1, 0, 0, 0, 0] = conv.primes[1]
    with pytest.raises(ValueError):
        from_jax_ntt_key(bad, conv, device="cpu")
    with pytest.raises(ValueError):
        from_jax_ntt_key(ksk[:1], conv, device="cpu")


@pytest.mark.parametrize("row", [0, 1], ids=["mask_row", "body_row"])
def test_private_functional_key_switch_matches_jax(port, jax_run, row):
    conv, _, _, basis_priv, _, ksks = port
    _, out = jax_run
    got = cb.private_functional_key_switch(conv, basis_priv, _t(out["big"]), ksks[row])
    np.testing.assert_array_equal(got.numpy(), out["switched"][row])


@pytest.mark.parametrize("bit", [0, 1])
def test_circuit_bootstrap_matches_jax(port, jax_run, bit):
    conv, basis_pbs, basis_cb, basis_priv, bsk, ksks = port
    want = jax_run[1]["bits"][bit]
    got = cb.circuit_bootstrap(conv, basis_pbs, bsk, conv, basis_cb, basis_priv, ksks,
                               _t(want["ct"]), LOG_N)
    assert got.shape == (K + 1, LV_CB, K + 1, N)
    np.testing.assert_array_equal(got.numpy(), want["ggsw"])


@pytest.mark.parametrize("bit", [0, 1])
def test_ggsw_to_ntt_product_and_mux_match_jax(port, jax_run, bit):
    conv, _, basis_cb, _, _, _ = port
    want = jax_run[1]["bits"][bit]
    ggsw_ntt = tfhe.ggsw_to_ntt(conv, _t(want["ggsw"]))
    np.testing.assert_array_equal(ggsw_ntt.numpy(), want["ggsw_ntt"])
    cx, cy = _t(want["cx"]), _t(want["cy"])
    np.testing.assert_array_equal(tfhe.external_product(conv, basis_cb, cx, ggsw_ntt).numpy(),
                                  want["product"])
    np.testing.assert_array_equal(leveled_mux(conv, basis_cb, ggsw_ntt, cx, cy).numpy(),
                                  want["mux"])


@pytest.fixture(scope="module")
def own_keys(port):
    """The port's own keys from one seeded generator."""
    conv, basis_pbs, _, basis_priv, _, _ = port
    gen = torch.Generator().manual_seed(17)
    gauss = DiscreteGaussian(SIGMA)
    lwe_s = sample_binary(gen, (N_LWE,))
    glwe_s = sample_binary(gen, (K, N))
    bsk = make_bootstrap_key(lwe_s, glwe_s, basis_pbs, gauss, conv, gen)
    minus_one = torch.zeros(N, dtype=torch.int64)
    minus_one[0] = MASK32
    fs = [glwe_s[j] for j in range(K)] + [minus_one]
    ksks = [cb.make_private_functional_ksk(f, glwe_s.reshape(-1), glwe_s, basis_priv, gauss,
                                           conv, gen) for f in fs]
    return gen, gauss, lwe_s, glwe_s, bsk, fs, ksks


@pytest.mark.parametrize("row", [0, 1], ids=["mask_row", "body_row"])
def test_own_private_ksk_decrypts_per_entry(port, own_keys, row):
    conv, _, _, basis_priv, _, _ = port
    _, _, _, glwe_s, _, fs, ksks = own_keys
    ksk = ksks[row]
    assert ksk.shape == (conv.count, K * N + 1, LV_PRIV, K + 1, N)
    coeff = conv.recombine(conv.inverse(ksk))  # (n_ext+1, L, k+1, N)
    phase = glwe.phase_torus(coeff, glwe_s, conv).numpy()
    sigma = [int(s) for s in glwe_s.reshape(-1)] + [MASK32]
    f = [int(x) for x in fs[row]]
    for i, s_i in enumerate(sigma):
        for lvl, scal in enumerate(basis_priv.scalars):
            want = np.array([(c * s_i * scal) & MASK32 for c in f], dtype=np.int64)
            err = _centered((phase[i, lvl] - want) & MASK32)
            assert np.abs(err).max() <= BOUND, (i, lvl, np.abs(err).max())
    if row == 1:  # f = -x and sigma_{n_ext} = -1: the message (-1)(-1) B^l 2^drop
        last = _centered(phase[-1] - np.array(basis_priv.scalars)[:, None] * (np.arange(N) == 0))
        assert np.abs(last).max() <= BOUND


@pytest.mark.parametrize("bit", [0, 1])
def test_own_circuit_bootstrap_then_mux_selects(port, own_keys, bit):
    conv, basis_pbs, basis_cb, basis_priv, _, _ = port
    gen, gauss, lwe_s, glwe_s, bsk, _, ksks = own_keys
    ct = encrypt_torus32(torch.tensor(bit << 31), lwe_s, gauss, gen)
    ggsw = cb.circuit_bootstrap(conv, basis_pbs, bsk, conv, basis_cb, basis_priv, ksks, ct,
                                LOG_N)
    ggsw_ntt = tfhe.ggsw_to_ntt(conv, ggsw)
    x_bits = torch.randint(0, 2, (N,), generator=gen)
    y_bits = torch.randint(0, 2, (N,), generator=gen)
    cx = glwe.encrypt_torus(x_bits << 31, glwe_s, gauss, conv, gen)
    cy = glwe.encrypt_torus(y_bits << 31, glwe_s, gauss, conv, gen)
    out = leveled_mux(conv, basis_cb, ggsw_ntt, cx, cy)
    want = (x_bits if bit else y_bits).numpy()
    err = _centered((glwe.phase_torus(out, glwe_s, conv).numpy() - (want << 31)) & MASK32)
    assert np.abs(err).max() < 1 << 28, np.abs(err).max()
