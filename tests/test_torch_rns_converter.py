"""Port vs the JAX package: the u32 RNS base and the base converters
(``primus_fhe_tpu_torch/rns/{base,converter}.py``) and ``dot64``
(``modular/modops.py``), on the cases of ``tests/test_rns.py`` and
``tests/test_exact_convert.py``.

- ``RNSBase32`` decompose, compose and the centred small lift: the JAX's
  words and the Python-integer values;
- ``BaseConverter32``/``BaseConverter64`` ``fast_convert`` and
  ``exact_convert``: the JAX's words on the same residues (values spread over
  ``[0, Q)``, away from ``Q/2``'s multiples, and just below Q for the centred
  case), and ``exact_convert`` the values mod ``p``;
- ``_alpha_fixed32`` and ``dot64`` against the JAX's.

Tolerance: zero (exact integers).
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primus_fhe_tpu.modular.modops import dot64 as jdot64
from primus_fhe_tpu.modular.modulus import barrett64 as jbarrett64
from primus_fhe_tpu.numeric import from_u64_pair as jfrom
from primus_fhe_tpu.numeric import to_u64_pair as jto
from primus_fhe_tpu.numeric.bigint import big_from_int, big_to_ints
from primus_fhe_tpu.rns import BaseConverter32 as JConv32
from primus_fhe_tpu.rns import BaseConverter64 as JConv64
from primus_fhe_tpu.rns import RNSBase32 as JBase32
from primus_fhe_tpu.rns import RNSBase64 as JBase64
from primus_fhe_tpu.rns.converter import _alpha_fixed32 as jalpha
from primus_fhe_tpu_torch.modular.modops import dot64
from primus_fhe_tpu_torch.modular.modulus import barrett64
from primus_fhe_tpu_torch.numeric.limb import u64_numpy, u64_tensor
from primus_fhe_tpu_torch.rns import BaseConverter32, BaseConverter64, RNSBase32, RNSBase64
from primus_fhe_tpu_torch.rns.converter import _alpha_fixed32

MOD32 = [536813569, 536608769, 536543233]
OUT32 = [1073682433, 1073668097]
MOD64 = [1125899906826241, 1125899906629633]
OUT64 = [1152921504606830593]


def _residues(vals, moduli):
    return [[v % q for v in vals] for q in moduli]


def test_rns32_base_matches_jax():
    rng = random.Random(5)
    base, jbase = RNSBase32(MOD32), JBase32(MOD32)
    vals = [rng.randrange(base.q_product) for _ in range(64)]
    limbs = np.stack([big_from_int(v, base.big_len) for v in vals])
    res = base.decompose(torch.from_numpy(limbs.astype(np.int64)))
    np.testing.assert_array_equal(res.numpy(), np.asarray(jbase.decompose(jnp.asarray(limbs)))
                                  .astype(np.int64))
    assert res.tolist() == _residues(vals, MOD32)
    back = base.compose(res)
    assert big_to_ints(back.numpy().astype(np.uint32)).tolist() == vals
    small = np.array([rng.randrange(256) for _ in range(64)], dtype=np.uint32)
    np.testing.assert_array_equal(
        base.wrapping_decompose_small(torch.from_numpy(small.astype(np.int64)), 256).numpy(),
        np.asarray(jbase.wrapping_decompose_small(jnp.asarray(small), 256)).astype(np.int64))
    with pytest.raises(ValueError):
        RNSBase32([1 << 31 | 1])


@pytest.mark.parametrize("spread", ["low", "centred", "any"])
def test_converter32_matches_jax(spread):
    """``low``: values in ``[Q/16, 7Q/16)``, exact mod p; ``centred``: just
    below Q, ``(V - Q) mod p``; ``any``: all of ``[0, Q)``, the JAX's words."""
    rng = random.Random(808)
    conv, jconv = BaseConverter32(RNSBase32(MOD32), RNSBase32(OUT32)), JConv32(
        JBase32(MOD32), JBase32(OUT32))
    Q = conv.input_base.q_product
    vals = {"low": lambda: rng.randrange(Q // 16, 7 * Q // 16),
            "centred": lambda: Q - 1 - rng.randrange(1000),
            "any": lambda: rng.randrange(Q)}[spread]
    vals = [vals() for _ in range(64)]
    arr = np.array(_residues(vals, MOD32), dtype=np.uint32)
    t = torch.from_numpy(arr.astype(np.int64))
    for name in ("fast_convert", "exact_convert"):
        got = getattr(conv, name)(t).numpy()
        want = np.asarray(getattr(jconv, name)(jnp.asarray(arr))).astype(np.int64)
        np.testing.assert_array_equal(got, want, err_msg=name)
    if spread != "any":
        shift = Q if spread == "centred" else 0
        assert conv.exact_convert(t).tolist() == [[(v - shift) % p for v in vals] for p in OUT32]


def test_converter64_matches_jax():
    rng = random.Random(809)
    conv = BaseConverter64(RNSBase64(MOD64), RNSBase64(OUT64))
    jconv = JConv64(JBase64(MOD64), JBase64(OUT64))
    Q = conv.input_base.q_product
    vals = [rng.randrange(Q // 16, 7 * Q // 16) for _ in range(32)] + [
        rng.randrange(Q) for _ in range(32)]
    arr = np.array(_residues(vals, MOD64), dtype=np.uint64)
    for name in ("fast_convert", "exact_convert"):
        got = u64_numpy(getattr(conv, name)(u64_tensor(arr)))
        np.testing.assert_array_equal(got, jfrom(getattr(jconv, name)(jto(arr))), err_msg=name)
    exact = u64_numpy(conv.exact_convert(u64_tensor(arr)))[0, :32]
    assert exact.astype(object).tolist() == [v % OUT64[0] for v in vals[:32]]
    with pytest.raises(ValueError):
        BaseConverter64(RNSBase64([97, 193]), RNSBase64(OUT64)).exact_convert(
            torch.zeros((2, 1), dtype=torch.int64))


def test_alpha_and_dot64_match_jax():
    rng = np.random.default_rng(3)
    y = np.stack([rng.integers(0, q, 40, dtype=np.uint64) for q in MOD32]).astype(np.uint32)
    fix = np.array([(1 << 64) // q for q in MOD32], dtype=np.uint64)
    got = _alpha_fixed32(torch.from_numpy(y.astype(np.int64)), u64_tensor(fix))
    want = np.asarray(jalpha(jnp.asarray(y), jto(fix))).astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), want)
    q = MOD64[0]
    a = rng.integers(0, q, (3, 17), dtype=np.uint64)
    b = rng.integers(0, q, (3, 17), dtype=np.uint64)
    got = dot64(u64_tensor(a), u64_tensor(b), barrett64(q))
    np.testing.assert_array_equal(u64_numpy(got), jfrom(jdot64(jto(a), jto(b), jbarrett64(q))))
