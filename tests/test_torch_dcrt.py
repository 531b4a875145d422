"""Port vs reference: the RNS/DCRT blind rotation and the modules under it.

- ``build_dcrt_plan64``, ``dcrt_forward64``/``dcrt_inverse64``, the routed
  ``_fast`` transforms and ``dcrt_monomial64`` against JAX;
- ``RNSBase64`` ``compose``/``decompose``/``wrapping_decompose_small``
  (two and three moduli) and ``BigUintApproxSignedBasis`` (both threshold
  branches, dropped bits, ``log_basis=1``) against JAX;
- ``add_dcrt_glev_mul_crt_poly``, ``crt_glwe_mul_dcrt_ggsw`` and
  ``dcrt_glwe_phase`` against JAX with batch dims;
- ``dcrt_blind_rotate`` and ``dcrt_blind_rotate_batched`` (log_n=4, n_lwe=4,
  batch 3) on a bootstrap key made by JAX ``dcrt_ggsw_encrypt`` and carried
  across with ``from_jax_dcrt_state``: bit-equal;
- a port-made key (``make_dcrt_bootstrap_key``): the rotated test vector
  decrypts within delta/4 of ``v * X^(-b + sum a_i s_i)``;
- at log_n=8 on the CPU, the ``"auto"`` (MXU plain versions) and
  ``"butterfly"`` routes give the same rotation.

Tolerance: zero (bit-equal words), except the decryption check (delta/4,
the JAX test's bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primus_fhe_tpu.boot import dcrt_blind_rotate as jrot
from primus_fhe_tpu.decompose import BigUintApproxSignedBasis as JBasis
from primus_fhe_tpu.distr.sampling import DiscreteGaussian as JGaussian
from primus_fhe_tpu.lattice import dcrt as jdcrt
from primus_fhe_tpu.numeric.limb import U64, from_u64_pair as jfrom, to_u64_pair as jto
from primus_fhe_tpu.rns import RNSBase64 as JBase
from primus_fhe_tpu.transforms import dcrt as jtd
from primus_fhe_tpu_torch.boot.dcrt_blind_rotate import (
    dcrt_blind_rotate, dcrt_blind_rotate_batched, from_jax_dcrt_state, make_dcrt_bootstrap_key,
)
from primus_fhe_tpu_torch.decompose import BigUintApproxSignedBasis
from primus_fhe_tpu_torch.distr import DiscreteGaussian
from primus_fhe_tpu_torch.lattice import dcrt
from primus_fhe_tpu_torch.numeric.bigint import big_to_ints
from primus_fhe_tpu_torch.numeric.limb import u64_numpy, u64_tensor
from primus_fhe_tpu_torch.rns import RNSBase64
from primus_fhe_tpu_torch.transforms import dcrt as td

MODULI = [1125899906826241, 1125899906629633]
Q60 = 1152921504606830593
LOG_N, N, N_LWE, K1 = 4, 16, 4, 2


def _res(rng, moduli, shape):
    """Canonical residues ``(count, *shape)`` (u64 numpy)."""
    return np.stack([rng.integers(0, q, shape, dtype=np.uint64) for q in moduli])


def _t(x):
    return u64_tensor(x)


@pytest.mark.parametrize("log_n", [4, 8])
def test_dcrt_transforms_and_monomial_match_reference(log_n):
    n = 1 << log_n
    rng = np.random.default_rng(log_n)
    plan, jplan = td.build_dcrt_plan64(log_n, MODULI), jtd.build_dcrt_plan64(log_n, MODULI)
    x = _res(rng, MODULI, (3, n))
    want_f = jfrom(jtd.dcrt_forward64(jplan, jto(x)))
    want_i = jfrom(jtd.dcrt_inverse64(jplan, jto(x)))
    np.testing.assert_array_equal(u64_numpy(td.dcrt_forward64(plan, _t(x))), want_f)
    np.testing.assert_array_equal(u64_numpy(td.dcrt_inverse64(plan, _t(x))), want_i)
    assert td.resolve_route(plan) == ("mxu8" if log_n >= 8 else "butterfly")
    if log_n < 8:  # the byte-radix plan needs B = 128 lanes
        with pytest.raises(ValueError):
            td.dcrt_forward64_fast(plan, _t(x), route="mxu8")
    for route in td.ROUTES if log_n >= 8 else ("auto", "butterfly"):
        np.testing.assert_array_equal(
            u64_numpy(td.dcrt_forward64_fast(plan, _t(x), route=route)), want_f)
        np.testing.assert_array_equal(
            u64_numpy(td.dcrt_inverse64_fast(plan, _t(x), route=route)), want_i)
    deg = np.array([[0], [1], [n], [2 * n - 1], [5 * n + 3]])
    for neg in (False, True):
        got = td.dcrt_monomial64(plan, torch.from_numpy(deg), negate=neg)
        want = jtd.dcrt_monomial64(jplan, jnp.asarray(deg.astype(np.int32)), negate=neg)
        np.testing.assert_array_equal(u64_numpy(got), jfrom(want))
    with pytest.raises(ValueError):
        td.resolve_route(plan, "tpu")


@pytest.mark.parametrize("moduli", [MODULI, MODULI + [Q60]])
def test_rns_base_matches_reference(moduli):
    rng = np.random.default_rng(len(moduli))
    base, jbase = RNSBase64(moduli), JBase(moduli)
    assert (base.big_len, base.q_product) == (jbase.big_len, jbase.q_product)
    r = _res(rng, moduli, (3, 8))
    r[:, 0, 0] = 0
    r[:, 0, 1] = [q - 1 for q in moduli]
    big = base.compose(_t(r))
    want = np.asarray(jbase.compose(jto(r))).astype(np.int64)
    np.testing.assert_array_equal(big.numpy(), want)
    back = base.decompose(big)
    np.testing.assert_array_equal(u64_numpy(back), r)
    np.testing.assert_array_equal(u64_numpy(back), jfrom(jbase.decompose(jnp.asarray(want.astype(np.uint32)))))
    small = rng.integers(0, 1 << 25, (3, 8), dtype=np.uint64)
    for sm in (2, 1 << 25):
        got = base.wrapping_decompose_small(torch.from_numpy(small.astype(np.int64)), sm)
        np.testing.assert_array_equal(u64_numpy(got),
                                      jfrom(jbase.wrapping_decompose_small(jto(small), sm)))


@pytest.mark.parametrize("log_basis,reverse", [(25, None), (20, None), (7, None), (1, None),
                                               (7, 10), (3, 30)])
def test_big_basis_matches_reference(log_basis, reverse):
    base, jbase = RNSBase64(MODULI), JBase(MODULI)
    basis, jbasis = (BigUintApproxSignedBasis(base, log_basis, reverse),
                     JBasis(jbase, log_basis, reverse))
    for name in ("decompose_length", "drop_bits", "init_carry_mask_bit", "carry_mask",
                 "threshold_int", "adjust_add_int", "shr_bits", "scalar_ints",
                 "scalars_residue_ints", "approximate_error_bound"):
        assert getattr(basis, name) == getattr(jbasis, name), name
    rng = np.random.default_rng(log_basis)
    r = _res(rng, MODULI, (40,))
    big = base.compose(_t(r))
    Q = base.q_product
    big[0] = torch.from_numpy(np.array([(Q - 1) >> (32 * i) & 0xFFFFFFFF for i in range(4)]))
    if basis.threshold_int is not None:  # values at and around the threshold
        for j, v in enumerate((basis.threshold_int - 1, basis.threshold_int)):
            big[1 + j] = torch.from_numpy(np.array([v >> (32 * i) & 0xFFFFFFFF for i in range(4)]))
    got = basis.unsigned_decompose(big)
    want = jbasis.unsigned_decompose(jnp.asarray(big.numpy().astype(np.uint32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


@pytest.fixture(scope="module")
def ctx():
    base, jbase = RNSBase64(MODULI), JBase(MODULI)
    return dict(base=base, jbase=jbase, basis=BigUintApproxSignedBasis(base, 20),
                jbasis=JBasis(jbase, 20), plan=td.build_dcrt_plan64(LOG_N, MODULI),
                jplan=jtd.build_dcrt_plan64(LOG_N, MODULI))


def test_gadget_products_and_phase_match_reference(ctx):
    c = ctx
    rng = np.random.default_rng(3)
    L = c["basis"].decompose_length
    acc = _res(rng, MODULI, (3, K1, N))
    glev = np.stack([_res(rng, MODULI, (K1, N)) for _ in range(L)])  # (L, count, k1, N)
    poly = _res(rng, MODULI, (3, N))
    got = dcrt.add_dcrt_glev_mul_crt_poly(_t(acc), _t(glev), _t(poly), c["basis"], c["plan"],
                                          c["base"])
    want = jdcrt.add_dcrt_glev_mul_crt_poly(jto(acc), jto(glev), jto(poly), c["jbasis"],
                                            c["jplan"], c["jbase"])
    np.testing.assert_array_equal(u64_numpy(got), jfrom(want))
    glwe = _res(rng, MODULI, (2, K1, N))
    ggsw = np.stack([np.stack([_res(rng, MODULI, (K1, N)) for _ in range(L)])
                     for _ in range(K1)])  # (k1, L, count, k1, N)
    got = dcrt.crt_glwe_mul_dcrt_ggsw(_t(glwe), _t(ggsw), c["basis"], c["plan"], c["base"])
    want = jdcrt.crt_glwe_mul_dcrt_ggsw(jto(glwe), jto(ggsw), c["jbasis"], c["jplan"],
                                        c["jbase"])
    np.testing.assert_array_equal(u64_numpy(got), jfrom(want))
    secret = _res(rng, MODULI, (1, N))
    ph = dcrt.dcrt_glwe_phase(_t(glwe[:, 0]), _t(secret), c["plan"], c["base"])
    want = jdcrt.dcrt_glwe_phase(jto(glwe[:, 0]), jto(secret), c["jplan"], c["jbase"])
    np.testing.assert_array_equal(u64_numpy(ph), jfrom(want))


def _expected_rotation(v, a, b, s, Q):
    rot = (-b + sum(ai * si for ai, si in zip(a, s))) % (2 * N)
    out = [0] * N
    for j, cj in enumerate(v):
        k = (j + rot) % (2 * N)
        if k < N:
            out[k] = (out[k] + cj) % Q
        else:
            out[k - N] = (out[k - N] - cj) % Q
    return out


def _test_vector(base):
    delta = base.q_product >> 8
    v = [(j + 1) * delta % base.q_product for j in range(N)]
    acc = np.zeros((len(MODULI), K1, N), dtype=np.uint64)
    for mi, q in enumerate(MODULI):
        acc[mi, 1] = [x % q for x in v]
    return v, delta, acc


def test_blind_rotate_matches_reference_on_jax_keys(ctx):
    """A JAX-made encrypted bootstrap key carried across: the port's single
    and batched rotations equal JAX's word for word, and decrypt."""
    c = ctx
    key = jax.random.PRNGKey(55)
    ks, kg = jax.random.split(key)
    bits = np.asarray(jax.random.bits(ks, (1, N), dtype=jnp.uint32) & 1, dtype=np.uint64)
    jsecret = jtd.dcrt_forward64(c["jplan"], jto(np.broadcast_to(bits[None], (2, 1, N)).copy()))
    lwe_secret = [1, 0, 1, 1]
    rows = [jdcrt.dcrt_ggsw_encrypt(jax.random.fold_in(kg, i), s, jsecret, c["jbasis"],
                                    JGaussian(3.2), c["jplan"], c["jbase"])
            for i, s in enumerate(lwe_secret)]
    jbsk = U64(jnp.stack([r.lo for r in rows]), jnp.stack([r.hi for r in rows]))
    v, delta, acc_coeff = _test_vector(c["base"])
    jacc0 = jtd.dcrt_forward64(c["jplan"], jto(acc_coeff))
    rng = np.random.default_rng(7)
    lwes = rng.integers(0, 2 * N, (3, N_LWE + 1)).astype(np.int32)
    lwes[0] = [3, 7, 12, 30, 5]
    accs = np.stack([jfrom(jacc0)] + [_res(rng, MODULI, (K1, N)) for _ in range(2)])
    bsk, secret, tacc = from_jax_dcrt_state(jbsk, jsecret, jto(accs), device="cpu")
    want = jfrom(jrot.dcrt_blind_rotate_batched(c["jplan"], c["jbasis"], c["jbase"], jbsk,
                                                jnp.asarray(lwes), jto(accs)))
    got = dcrt_blind_rotate_batched(c["plan"], c["basis"], c["base"], bsk,
                                    torch.from_numpy(lwes), tacc)
    np.testing.assert_array_equal(u64_numpy(got), want)
    single = dcrt_blind_rotate(c["plan"], c["basis"], c["base"], bsk, torch.from_numpy(lwes[0]),
                               tacc[0])
    jsingle = jrot.dcrt_blind_rotate(c["jplan"], c["jbasis"], c["jbase"], jbsk,
                                     jnp.asarray(lwes[0]), jacc0)
    np.testing.assert_array_equal(u64_numpy(single), jfrom(jsingle))
    ph = big_to_ints(c["base"].compose(dcrt.dcrt_glwe_phase(single, secret, c["plan"], c["base"])))
    Q = c["base"].q_product
    for g, e in zip(ph, _expected_rotation(v, lwes[0][:N_LWE], lwes[0][N_LWE], lwe_secret, Q)):
        d = (int(g) - e) % Q
        assert min(d, Q - d) < delta // 4


def test_port_key_rotation_decrypts(ctx):
    """Key generation in the port (batched, on a ``torch.Generator``): the
    rotation of the test vector decrypts within delta/4."""
    c = ctx
    gen = torch.Generator().manual_seed(5)
    s_coeff, secret = dcrt.dcrt_glwe_secret(gen, 1, c["plan"])
    lwe_secret = torch.tensor([1, 1, 0, 1])
    gauss = DiscreteGaussian(3.2)
    bsk = make_dcrt_bootstrap_key(gen, lwe_secret, secret, c["basis"], gauss, c["plan"],
                                  c["base"])
    assert bsk.shape == (N_LWE, K1, c["basis"].decompose_length, len(MODULI), K1, N)
    # a fresh zero sample decrypts to small noise (10 sigma)
    z = dcrt.dcrt_glwe_zero_sample(gen, secret, gauss, c["plan"], c["base"], batch=(2,))
    ph = big_to_ints(c["base"].compose(dcrt.dcrt_glwe_phase(z.movedim(1, 0), secret, c["plan"],
                                                            c["base"])))
    Q = c["base"].q_product
    assert all(min(int(x), Q - int(x)) <= 32 for x in ph.ravel())
    v, delta, acc_coeff = _test_vector(c["base"])
    acc0 = td.dcrt_forward64(c["plan"], _t(acc_coeff))
    a, b = [9, 2, 31, 17], 11
    out = dcrt_blind_rotate(c["plan"], c["basis"], c["base"], bsk, torch.tensor(a + [b]), acc0)
    ph = big_to_ints(c["base"].compose(dcrt.dcrt_glwe_phase(out, secret, c["plan"], c["base"])))
    for g, e in zip(ph, _expected_rotation(v, a, b, lwe_secret.tolist(), Q)):
        d = (int(g) - e) % Q
        assert min(d, Q - d) < delta // 4


def test_rotation_routes_agree_at_log_n_8():
    """At log_n=8 ``"auto"`` takes the MXU route (its plain versions here) and
    ``"butterfly"`` the butterfly: the same words."""
    base = RNSBase64(MODULI)
    basis = BigUintApproxSignedBasis(base, 25)
    plan = td.build_dcrt_plan64(8, MODULI)
    rng = np.random.default_rng(8)
    bsk = np.stack([np.stack([np.stack([_res(rng, MODULI, (K1, 256)) for _ in range(4)])
                              for _ in range(K1)]) for _ in range(2)])
    acc = _t(np.stack([_res(rng, MODULI, (K1, 256)) for _ in range(2)]))
    lwe = torch.from_numpy(rng.integers(0, 512, (2, 3)))
    outs = [dcrt_blind_rotate_batched(plan, basis, base, _t(bsk), lwe, acc, route=r)
            for r in ("auto", "butterfly", "mxu8")]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
