"""The NTT plans' root tables built on whole arrays
(``primus_fhe_tpu_torch/transforms/plan.py``) against the golden model's
per-word construction (``GoldenNtt``, the JAX package's ``golden/model.py``
copied) and the JAX package's own u32 plans: every table word, the Shoup
quotients and the ``inv_n`` constants, on u32 and u64 primes, with the
minimal root and with an explicit one; and the uint64 Shoup arithmetic
under them against Python integers.  Tolerance: zero."""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from primus_fhe_tpu_torch.golden.model import GoldenNtt, minimal_primitive_root
from primus_fhe_tpu_torch.numeric.limb import u64_tensor
from primus_fhe_tpu_torch.transforms import plan as PL
from primus_fhe_tpu_torch.utils.primes import next_ntt_prime

MASK64 = (1 << 64) - 1


def _golden(log_n, q, root=None, bits=32):
    g = GoldenNtt(log_n, q, root)
    if bits == 32:
        words = lambda v: torch.tensor(v, dtype=torch.int64)  # noqa: E731
        quot = lambda w: ((w << 32) // q) & 0xFFFFFFFF  # noqa: E731
    else:
        words = lambda v: u64_tensor([int(x) for x in v])  # noqa: E731
        quot = lambda w: ((w << 64) // q) & MASK64  # noqa: E731
    return {
        "roots": words(g.roots), "roots_precon": words([quot(w) for w in g.roots]),
        "inv_roots": words(g.inv_roots),
        "inv_roots_precon": words([quot(w) for w in g.inv_roots]),
        "inv_n": g.inv_n, "inv_n_precon": quot(g.inv_n), "inv_n_w": g.inv_n_w,
        "inv_n_w_precon": quot(g.inv_n_w), "ordinal_roots": words(g.ordinal_roots),
        "monomial_base": torch.tensor([2 * i + 1 for i in g.reverse_lsbs], dtype=torch.int64),
    }


def _same(plan, want):
    for name, w in want.items():
        got = getattr(plan, name)
        if isinstance(w, torch.Tensor):
            assert got.dtype == torch.int64 and torch.equal(got, w), name
        else:
            assert got == w, name


@pytest.mark.parametrize("log_n", [1, 2, 3, 7, 10, 12])
@pytest.mark.parametrize("bits", [20, 30])
def test_plan32_tables_equal_the_golden_model(log_n, bits):
    q = next_ntt_prime(bits, log_n)
    _same(PL.build_plan32(log_n, q), _golden(log_n, q))


@pytest.mark.parametrize("log_n", [1, 3, 8, 11])
@pytest.mark.parametrize("bits", [20, 31, 33, 50, 61])
def test_plan64_tables_equal_the_golden_model(log_n, bits):
    q = next_ntt_prime(bits, log_n)
    _same(PL.build_plan64(log_n, q), _golden(log_n, q, bits=64))
    root = pow(minimal_primitive_root(log_n + 1, q), 3, q)  # an explicit odd power
    _same(PL.build_plan64(log_n, q, root=root), _golden(log_n, q, root, bits=64))


def test_minimal_root_and_refusals():
    for log_n in range(1, 13):
        for bits in (17, 30, 31, 50, 61):
            q = next_ntt_prime(bits, log_n)
            assert PL._minimal_root(log_n + 1, q) == minimal_primitive_root(log_n + 1, q)
    q = next_ntt_prime(50, 4)
    with pytest.raises(ValueError, match="root"):
        PL.build_plan64(4, q, root=2)
    with pytest.raises(ValueError):
        PL._minimal_root(8, 97)  # 97 - 1 is not a multiple of 2^8


@pytest.mark.parametrize("q", [3, 97, (1 << 30) - 35, 1125899906826241, 4611686018425815041])
def test_shoup_arithmetic_on_uint64_words(q):
    rng = random.Random(q)
    w = [rng.randrange(q) for _ in range(4000)] + [0, 1, q - 1]
    arr = np.array(w, dtype=np.uint64)
    for c in (0, 1, q - 1, rng.randrange(q)):
        assert [int(x) for x in PL._mul_mod(arr, c, q)] == [x * c % q for x in w]
    assert [int(x) for x in PL._shoup_quotients(arr, q)] == [((x << 64) // q) & MASK64 for x in w]
    b = rng.randrange(1 << 64)
    assert [int(x) for x in PL._mul_hi(arr, b)] == [(x * b) >> 64 for x in w]


@pytest.mark.parametrize("log_n", [4, 10])
def test_plan32_equals_the_jax_plan(log_n):
    from primus_fhe_tpu.transforms import plan as jplan

    q = next_ntt_prime(30, log_n)
    got, want = PL.build_plan32(log_n, q), jplan.build_plan32(log_n, q)
    for name in ("roots", "roots_precon", "inv_roots", "inv_roots_precon", "ordinal_roots",
                 "monomial_base", "inv_n", "inv_n_precon", "inv_n_w", "inv_n_w_precon"):
        got_words = np.asarray(getattr(got, name)).astype(np.int64)
        want_words = np.asarray(getattr(want, name)).astype(np.int64)
        assert np.array_equal(got_words, want_words), name
