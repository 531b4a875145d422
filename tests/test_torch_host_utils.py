"""The port's host utilities against the JAX package.

- ``utils/serialize.py``: container bytes packed by one package unpack in
  the other to the same words, and both packages write the same bytes for
  the same values (every kind of ``test_serialize_containers.py``, both
  tiers); the same layout, type-confusion and garbage errors.
- ``utils/contracts.py``: off by default; under ``PRIMUS_DEBUG=1`` every
  checked entry point (``transforms/ntt.py``'s four transforms, kernels 1-2,
  row 10 and ``mxu8_forward64`` on their CPU paths) raises
  ``RangeContractError`` on an out-of-range input and leaves an in-range
  one's words unchanged (the inputs of ``test_contracts.py``).
- ``utils/secrets.py``, ``utils/profiling.py``; ``utils/security.py``,
  ``golden/model.py``, ``native.py`` and the copied ``utils`` helpers give
  the JAX package's values.
Tolerance: none.
"""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

from primus_fhe_tpu import native as jnative
from primus_fhe_tpu import params as jparams
from primus_fhe_tpu.golden import model as jgolden
from primus_fhe_tpu.numeric.limb import from_u64_pair as jfrom
from primus_fhe_tpu.numeric.limb import to_u64_pair as jto
from primus_fhe_tpu.utils import bits as jbits
from primus_fhe_tpu.utils import gcd as jgcd
from primus_fhe_tpu.utils import primes as jprimes
from primus_fhe_tpu.utils import security as jsec
from primus_fhe_tpu.utils import serialize as jser
from primus_fhe_tpu_torch import native
from primus_fhe_tpu_torch import params as P
from primus_fhe_tpu_torch.golden import model as golden
from primus_fhe_tpu_torch.numeric.limb import u64_numpy, u64_tensor
from primus_fhe_tpu_torch.ops import ntt32, ntt64, ntt_mxu8
from primus_fhe_tpu_torch.transforms import ntt, plan
from primus_fhe_tpu_torch.utils import bits, contracts, gcd, primes, profiling, secrets, security
from primus_fhe_tpu_torch.utils import serialize as ser

RNG = np.random.default_rng(7)
CASES = [  # test_serialize_containers.py's kinds and layouts
    ("lwe", (513,)), ("lwe", (4, 513)), ("multi_lwe", (520,)), ("rlwe", (2, 1024)),
    ("glwe", (3, 1024)), ("glev", (4, 2, 256)), ("rlev", (4, 2, 256)),
    ("ggsw", (2, 4, 2, 256)), ("rgsw", (2, 3, 2, 64)), ("ntru", (1024,)), ("poly", (2, 64)),
    ("bootstrap_key", (8, 2, 3, 2, 32)), ("keyswitch_key", (32, 3, 9)), ("secret_key", (630,)),
]
MODULI = (1125899906826241, 1125899906629633)
Q32, Q64 = 536813569, 1125899906826241  # test_contracts.py's primes
N = 16


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


@pytest.mark.parametrize("kind,shape", CASES)
def test_containers_cross_package_u32(kind, shape):
    v = RNG.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)
    data = ser.pack_container(kind, _t(v), moduli=())
    assert data == jser.pack_container(kind, v, moduli=())
    k2, out, meta = jser.unpack_container(data)
    assert k2 == kind and out.dtype == np.uint32 and (out == v).all()
    k3, back, meta3 = ser.unpack_container(jser.pack_container(kind, v), device="cpu")
    assert k3 == kind and meta3 == meta == {"domain": "coeff", "moduli": ()}
    np.testing.assert_array_equal(back.numpy(), v.astype(np.int64))
    # int32 storage packs to the same bytes
    assert ser.pack_container(kind, _t(v).to(torch.int32)) == data


@pytest.mark.parametrize("kind,shape", CASES)
def test_containers_cross_package_u64(kind, shape):
    v = RNG.integers(0, (1 << 50) - 27, size=(len(MODULI),) + shape, dtype=np.uint64)
    data = ser.pack_container(kind, u64_tensor(v), domain="ntt", moduli=MODULI, bits=64)
    assert data == jser.pack_container(kind, jto(v), domain="ntt", moduli=MODULI)
    _, out, meta = jser.unpack_container(data)
    assert (jfrom(out) == v).all() and meta == {"domain": "ntt", "moduli": MODULI}
    _, back, _ = ser.unpack_container(jser.pack_container(kind, v, domain="ntt", moduli=MODULI),
                                      device="cpu")
    np.testing.assert_array_equal(u64_numpy(back), v)


def test_container_errors_match():
    glwe = RNG.integers(0, 1 << 32, size=(3, 256), dtype=np.uint64).astype(np.uint32)
    data = ser.glwe_to_bytes(_t(glwe), moduli=(1 << 32))
    out, meta = ser.glwe_from_bytes(data, device="cpu")
    assert (out.numpy() == glwe).all() and meta["moduli"] == ((1 << 32),)
    assert data == jser.glwe_to_bytes(glwe, moduli=(1 << 32))
    for port, ref, match in ((ser.ggsw_from_bytes, jser.ggsw_from_bytes, "expected a 'ggsw'"),
                             (ser.lwe_from_bytes, jser.lwe_from_bytes, "expected a 'lwe'")):
        with pytest.raises(ValueError, match=match):
            port(data, device="cpu")
        with pytest.raises(ValueError, match=match):
            ref(data)
    for kind, shape, match in (("ggsw", (2, 4, 3, 256), "not a valid ggsw"),
                               ("rlwe", (3, 256), "not a valid rlwe"),
                               ("glwe", (2, 100), "not a valid glwe"),
                               ("nonsense", (4,), "unknown container kind")):
        v = np.zeros(shape, np.uint32)
        with pytest.raises(ValueError, match=match):
            ser.pack_container(kind, _t(v))
        with pytest.raises(ValueError, match=match):
            jser.pack_container(kind, v)
    with pytest.raises(ValueError, match="unknown domain"):
        ser.pack_container("poly", _t(np.zeros(4, np.uint32)), domain="fourier")
    with pytest.raises(TypeError, match="uint32 or uint64"):
        ser.pack_container("poly", np.zeros(4, np.int32))
    with pytest.raises(ValueError, match="bits=64"):
        ser.pack_container("poly", torch.tensor([1 << 40, 0, 0, 0]))
    with pytest.raises(ValueError, match="PFT1"):
        ser.unpack_container(b"\x00" * 64, device="cpu")
    # the byte helpers
    w = RNG.integers(0, 1 << 60, size=(2, 8), dtype=np.uint64)
    assert ser.u64_to_bytes(u64_tensor(w)) == jser.u64_to_bytes(jto(w))
    np.testing.assert_array_equal(u64_numpy(ser.u64_from_bytes(jser.u64_to_bytes(jto(w)), (2, 8),
                                                               device="cpu")), w)
    assert ser.u32_to_bytes(_t(glwe)) == jser.u32_to_bytes(glwe)
    np.testing.assert_array_equal(ser.u32_from_bytes(jser.u32_to_bytes(glwe), (3, 256),
                                                     device="cpu").numpy(), glwe)


def _v32(shift=0, shape=(5, N)):
    return _t(RNG.integers(0, Q32, size=shape, dtype=np.uint64) + shift)


def _v64(shift=0, q=Q64, shape=(5, N)):
    return u64_tensor(RNG.integers(0, q, size=shape, dtype=np.uint64) + np.uint64(shift))


def test_contracts_off_by_default(monkeypatch):
    monkeypatch.delenv("PRIMUS_DEBUG", raising=False)
    assert not contracts.enabled()
    ntt.forward32(plan.build_plan32(4, Q32), _v32(shift=3 * Q32), out_factor=4)


def test_contracts_u32_entry_points(monkeypatch):
    monkeypatch.setenv("PRIMUS_DEBUG", "1")
    assert contracts.enabled()
    p32 = plan.build_plan32(4, Q32)
    ok = _v32(shift=2 * Q32)
    with monkeypatch.context() as m:  # the checks observe: the same words with the flag off
        m.delenv("PRIMUS_DEBUG")
        want = ntt.forward32(p32, ok)
    assert torch.equal(ntt.forward32(p32, ok), want)
    with pytest.raises(contracts.RangeContractError, match="inverse32 input"):
        ntt.inverse32(p32, _v32(shift=3 * Q32))
    tabs = ntt32.NttTables32(4, [Q32, 1073692673])
    both = torch.stack([_v32(), _v32()])
    assert torch.equal(ntt32.forward32(tabs, both)[0], ntt.forward32(p32, both[0]))
    over = both.clone()
    over[1, 0, 0] = 4 * 1073692673  # row 1 against its own prime
    with pytest.raises(contracts.RangeContractError, match="forward32 input"):
        ntt32.forward32(tabs, over)
    with pytest.raises(contracts.RangeContractError, match="inverse32 input"):
        ntt32.inverse32(tabs, both + 2 * Q32)


def test_contracts_u64_entry_points(monkeypatch):
    monkeypatch.setenv("PRIMUS_DEBUG", "1")
    p64 = plan.build_plan64(4, Q64)
    ntt.forward64(p64, _v64(shift=3 * Q64))  # < 4q: fine
    with pytest.raises(contracts.RangeContractError, match="forward64 input"):
        ntt.forward64(p64, _v64(shift=4 * Q64))
    with pytest.raises(contracts.RangeContractError, match="inverse64 input"):
        ntt.inverse64(p64, _v64(shift=2 * Q64))
    tabs = ntt64.NttTables64(4, [Q64])
    wide = _v64(shift=3 * Q64)[None]  # < 4q: legal for the inverse only when declared
    ntt64.ntt64_inverse(tabs, wide, 1, in_factor=4)
    with pytest.raises(contracts.RangeContractError, match="ntt64_inverse input"):
        ntt64.ntt64_inverse(tabs, wide, 1, in_factor=2)
    with pytest.raises(contracts.RangeContractError, match="ntt64_forward input"):
        ntt64.ntt64_forward(tabs, _v64(shift=4 * Q64)[None])
    mx = ntt_mxu8.Mxu8Tables64(ntt64.NttTables64(8, [Q64]))  # 7 byte planes: words < 2^56
    assert mx.planes == 7
    ntt_mxu8.mxu8_forward64(mx, _v64(q=1 << 56, shape=(1, 2, 256)))
    with pytest.raises(contracts.RangeContractError, match="mxu8_forward64 input"):
        ntt_mxu8.mxu8_forward64(mx, _v64(shift=1 << 56, q=1 << 8, shape=(1, 2, 256)))


def test_secrets_and_profiling(tmp_path):
    a, b = torch.arange(1, 9), torch.arange(1, 5)
    view = a[2:6]
    secrets.delete(a, (b,), "not a tensor")
    assert int(a.abs().sum()) == 0 and int(b.abs().sum()) == 0 and int(view.abs().sum()) == 0
    h = np.arange(1, 5)
    ro = np.arange(1, 5)
    ro.flags.writeable = False
    secrets.scrub_host(h, ro)
    assert not h.any() and ro.all()
    with profiling.Timer() as t:
        torch.ones(4).sum()
    assert t.elapsed > 0
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.ones(8).cumsum(0)
    assert (tmp_path / "tr" / "trace.json").exists() and len(prof.key_averages())
    assert profiling.ntt_modmuls(4096, 3) == 3 * 2048 * 12
    assert profiling.op_rate(10, 0.5) == 20.0


def _plain(x):
    """A security report as plain values (the two packages' dataclasses are
    distinct types)."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return dataclasses.astuple(x) if dataclasses.is_dataclass(x) else x


def test_security_estimator_equals_the_jax():
    assert _plain(security.lwe_security(512, 12289, 2.0, "gaussian")) == _plain(
        jsec.lwe_security(512, 12289, 2.0, "gaussian"))
    assert security.required_sigma(256, float(1 << 32), 80.0) == jsec.required_sigma(
        256, float(1 << 32), 80.0)
    for name in ("TOY", "BOOLEAN_TFHE_LIB"):
        assert _plain(security.tfhe_profile_security(getattr(P, name))) == _plain(
            jsec.tfhe_profile_security(getattr(jparams, name)))
    assert _plain(security.ntru_profile_security(P.NTRU_128)) == _plain(
        jsec.ntru_profile_security(jparams.NTRU_128))
    assert security.lwe_security(630, float(1 << 32), 2.0**15).classical_bits == \
        jsec.lwe_security(630, float(1 << 32), 2.0**15).classical_bits
    assert security.secret_variance("ternary", 1.0) == jsec.secret_variance("ternary", 1.0)


def test_golden_model_and_utils_equal_the_jax():
    rng = np.random.default_rng(5)
    for q, width in ((Q32, 32), (Q64, 64)):
        assert golden.barrett_ratio(q, width) == jgolden.barrett_ratio(q, width)
        for v in rng.integers(0, 1 << 62, 8):
            v = int(v) % (1 << width)
            assert golden.barrett_lazy_reduce(v, q, width) == jgolden.barrett_lazy_reduce(v, q, width)
            assert golden.barrett_lazy_reduce_wide(v, v >> 3, q, width) == \
                jgolden.barrett_lazy_reduce_wide(v, v >> 3, q, width)
            w = v % q
            pre = golden.shoup_quotient(w, q, width)
            assert pre == jgolden.shoup_quotient(w, q, width)
            assert golden.shoup_mul_lazy(v % q, w, pre, q, width) == jgolden.shoup_mul_lazy(
                v % q, w, pre, q, width)
            assert golden.reduce_once(w + q - 1, q) == jgolden.reduce_once(w + q - 1, q)
    g, jg = golden.GoldenNtt(5, Q32), jgolden.GoldenNtt(5, Q32)
    a = [int(x) for x in rng.integers(0, Q32, 32)]
    b = [int(x) for x in rng.integers(0, Q32, 32)]
    assert g.forward(a) == jg.forward(a) and g.inverse(a) == jg.inverse(a)
    assert g.monomial(7, 45) == jg.monomial(7, 45)
    assert g.negacyclic_mul(a, b) == jg.negacyclic_mul(a, b) == golden.naive_negacyclic_mul(
        a, b, Q32) == jgolden.naive_negacyclic_mul(a, b, Q32)
    assert np.array_equal(bits.bit_reverse_indices(6), jbits.bit_reverse_indices(6))
    assert gcd.hensel_inv_pow2(12345, 64) == jgcd.hensel_inv_pow2(12345, 64)
    assert primes.ntt_prime_chain(30, 11, 3) == jprimes.ntt_prime_chain(30, 11, 3)
    assert dataclasses.asdict(P.BOOLEAN_TFHE_LIB) == dataclasses.asdict(jparams.BOOLEAN_TFHE_LIB)


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")
def test_native_oracle():
    q, log_n = 1152921504606830593, 7  # test_native.py's inputs
    nat, jnat = native.NativeNtt(log_n, q), jnative.NativeNtt(log_n, q)
    assert nat.roots.tolist() == jnat.roots.tolist()
    a = np.random.default_rng(616).integers(0, q, 1 << log_n, dtype=np.uint64)
    fwd = nat.forward(a)
    assert fwd.tolist() == jnat.forward(a).tolist()
    # the port's plain transform gives the native oracle's words
    assert u64_numpy(ntt.forward64(plan.build_plan64(log_n, q), u64_tensor(a))).tolist() == \
        fwd.tolist()
    assert nat.inverse(fwd).tolist() == a.tolist()
    assert nat.negacyclic_mul(a, a).tolist() == jnat.negacyclic_mul(a, a).tolist()
    assert native.minimal_primitive_root(11, 1073692673) == jnative.minimal_primitive_root(
        11, 1073692673)
    assert native.mod_inv(12345, 1073692673) == jnative.mod_inv(12345, 1073692673)
