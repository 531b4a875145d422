"""Row 9's four u64 functions at log_n 13-15, where the card runs them on
row 10's radix-8 passes (``ops/ntt_mxu8.py``, ``csrc/ntt64.cu``), on the CPU.

- ``Mxu8NttPlan64``'s split (``A``, ``B``) equals the JAX plan's at log_n
  13-15 (``B = 256`` at 15), as do ``Mxu8Tables64``'s;
- the four wrappers (``mxu8_forward64``, ``mxu8_inverse64``, kernel D
  ``mxu8_inverse64_mul``, kernel E ``mxu8_roundtrip64_mul``) on CPU tensors
  give the words of JAX ``mxu8_fused_forward64``, ``_inverse64``,
  ``_inverse64_mul`` and ``_roundtrip64_mul`` (Pallas in interpret mode,
  as ``tests/test_ntt_mxu8.py`` runs them) at log_n 13 on 2 rows;
- the numpy models of row 10's kernels (``test_torch_ntt64_model.py``) with
  the loads these functions add (the forward taking any u64 word, each
  brought to [0, 2q) as it loads; the inverse multiplying each word by 1,
  or by kernel D's key, as it loads: ``pft_ntt64_inverse_mul``) and kernel
  E as the forward's lazy output, the key and the inverse on the same
  groups, equal the plain versions at log_n 13-15 on a 62-bit and a 50-bit
  modulus (a row over two blocks at 15); E's shared memory fits one tile at
  each (the forward's table read from device memory past 2^12).

Inputs from a numpy seed; tolerance zero (bit-equal words).
"""

import numpy as np
import pytest

from primus_fhe_tpu.numeric.limb import from_u64_pair as jfrom, to_u64_pair as jto
from primus_fhe_tpu.ops import ntt_mxu8 as jmxu
from primus_fhe_tpu_torch.numeric.limb import u64_tensor
from primus_fhe_tpu_torch.ops import ntt64, ntt_mxu8
from primus_fhe_tpu_torch.utils.primes import next_ntt_prime
from test_torch_ntt64_model import (SMEM_MAX, _u64, largest_tile, log_split, model_forward,
                                    model_inverse)
from test_torch_ntt_rt64_model import rt_smem_bytes

Q30 = next_ntt_prime(30, 15)  # 4 planes: the split does not depend on q
MODULI = [next_ntt_prime(62, 15), next_ntt_prime(50, 15)]  # 8 and 7 planes, rings to 2^15


@pytest.mark.parametrize("log_n", [13, 14, 15])
def test_plan_split_matches_jax(log_n):
    """``A``, ``B`` of the port's plan and table stack are the JAX plan's
    (its default ``h1``); row 13's 128-lane tables exist only at ``B =
    128``."""
    jplan = jmxu.Mxu8NttPlan64(log_n, Q30)
    plan = ntt_mxu8.Mxu8NttPlan64(log_n, Q30)
    assert (plan.A, plan.B) == (jplan.A, jplan.B) == ntt_mxu8.four_step_split(log_n)
    tables = ntt_mxu8.Mxu8Tables64(ntt64.NttTables64(log_n, [Q30]))
    assert (tables.A, tables.B) == (jplan.A, jplan.B)
    assert (plan.cyclic is None) == (plan.B != 128)


def test_wrappers_match_jax_at_log_n_13():
    """Two rows of a 50-bit modulus (7 planes): the forward, the inverse of
    its output, D with a key and E with the same key."""
    log_n, q = 13, next_ntt_prime(50, 13)
    n = 1 << log_n
    rng = np.random.default_rng(27)
    x = rng.integers(0, q, (2, n), dtype=np.uint64)
    key = rng.integers(0, q, (n,), dtype=np.uint64)
    jplan = jmxu.Mxu8NttPlan64(log_n, q)
    jtabs = jplan.inverse_mul_tabs(key, 2)
    tables = ntt_mxu8.Mxu8Tables64(ntt64.NttTables64(log_n, [q]))
    mt = tables.mul_table(u64_tensor(key)[None])
    f = jfrom(jmxu.mxu8_fused_forward64(jplan, jto(x), 1, 2))
    got = ntt_mxu8.mxu8_forward64(tables, u64_tensor(x)[None])
    np.testing.assert_array_equal(_u64(got)[0], f)
    want = jfrom(jmxu.mxu8_fused_inverse64(jplan, jto(f), 1, 2))
    got = ntt_mxu8.mxu8_inverse64(tables, u64_tensor(f)[None])
    np.testing.assert_array_equal(_u64(got)[0], want)
    want = jfrom(jmxu.mxu8_fused_inverse64_mul(jplan, jto(f), jtabs, 1, 2))
    got = ntt_mxu8.mxu8_inverse64_mul(tables, u64_tensor(f)[None], mt)
    np.testing.assert_array_equal(_u64(got)[0], want)
    want = jfrom(jmxu.mxu8_fused_roundtrip64_mul(jplan, jto(x), jtabs, 1, 2))
    got = ntt_mxu8.mxu8_roundtrip64_mul(tables, u64_tensor(x)[None], mt)
    np.testing.assert_array_equal(_u64(got)[0], want)


@pytest.mark.parametrize("log_n", [13, 14, 15])
def test_row10_models_with_row9_loads_match_plain(log_n):
    """Any u64 words (the extremes included) on 2 rows of each modulus: the
    forward (``pft_ntt64_forward_any``), the inverse times 1 and times the
    key (``pft_ntt64_inverse_mul``: D's new entry), and E (the forward's
    lazy words, the key, the inverse) against the plain versions, in the
    tiles the card's rules allow."""
    n = 1 << log_n
    ntt = ntt64.NttTables64(log_n, MODULI)
    tables = ntt_mxu8.Mxu8Tables64(ntt)
    rng = np.random.default_rng(log_n)
    x = rng.integers(0, 1 << 64, (len(MODULI), 2, n), dtype=np.uint64)
    x[:, 0, :3] = [0, (1 << 64) - 1, 1 << 63]
    key = np.stack([rng.integers(0, q, n, dtype=np.uint64) for q in MODULI])
    mt = tables.mul_table(u64_tensor(key))
    mt_np, xt = _u64(mt), u64_tensor(x)
    ft, it = largest_tile(True, log_n, 2), largest_tile(False, log_n, 2)
    fwd = model_forward(ntt, x, 1, ft, any_words=True)
    np.testing.assert_array_equal(fwd, _u64(ntt_mxu8.mxu8_forward64_plain(tables, xt)))
    inv = model_inverse(ntt, x, 1, 2, it, load="any")
    np.testing.assert_array_equal(inv, _u64(ntt_mxu8.mxu8_inverse64_plain(tables, xt)))
    d = model_inverse(ntt, x, 1, 2, it, load="key", key=mt_np)
    np.testing.assert_array_equal(d, _u64(ntt_mxu8.mxu8_inverse64_mul_plain(tables, xt, mt)))
    lazy = model_forward(ntt, x, 4, ft, any_words=True)  # E's forward: its last pass unfolded
    e = model_inverse(ntt, lazy, 1, 2, it, load="key", key=mt_np)
    np.testing.assert_array_equal(e, _u64(ntt_mxu8.mxu8_roundtrip64_mul_plain(tables, xt, mt)))


@pytest.mark.parametrize("log_n", [13, 14, 15])
def test_roundtrip_fits_one_tile_past_2_12(log_n):
    """Kernel E past n = 2^12: no forward table in shared memory, the
    inverse's staged part and one tile of rows (half a row at 2^15) fit; a
    second row fits only at 2^13."""
    assert rt_smem_bytes(log_n, 1) <= SMEM_MAX
    assert (rt_smem_bytes(log_n, 2) <= SMEM_MAX) == (log_n == 13)
    assert log_split(log_n) == (log_n == 15)
