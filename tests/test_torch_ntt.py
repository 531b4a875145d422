"""Port vs reference: the 32-bit NTT plan and the plain versions of kernels 1
and 2 (``ops.ntt32`` on CPU tensors) against the JAX Pallas kernels
``pallas_forward32``/``pallas_inverse32`` run in interpret mode, and the
torus primes at log_n=11 against ``transforms.forward32``.
Tolerance: zero (bit-equal, lazy outputs included)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primus_fhe_tpu.ops.ntt_pallas import PallasNttPlan32, pallas_forward32, pallas_inverse32
from primus_fhe_tpu.transforms import build_plan32 as jax_build_plan32
from primus_fhe_tpu.transforms import forward32 as jax_forward32
from primus_fhe_tpu.transforms import inverse32 as jax_inverse32
from primus_fhe_tpu_torch.ops import ntt32
from primus_fhe_tpu_torch.transforms.plan import build_plan32
from primus_fhe_tpu_torch.lattice.tfhe import make_convolver


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("q", [536813569, 1073692673])
@pytest.mark.parametrize("log_n", [6, 9])
def test_plain_ntt32_matches_pallas(q, log_n):
    n = 1 << log_n
    tables = ntt32.NttTables32(log_n, [q])
    pp = PallasNttPlan32(log_n, q)
    rng = np.random.default_rng(q % 1000 + log_n)
    data = rng.integers(0, q, (3, n), dtype=np.uint64).astype(np.uint32)
    x = torch.from_numpy(data.astype(np.int64))[None]  # (kp=1, 3, n)
    for out_factor in (1, 4):
        got = ntt32.forward32(tables, x, out_factor)[0]
        want = _np(pallas_forward32(pp, jnp.asarray(data), out_factor, 2))
        np.testing.assert_array_equal(got.numpy(), want)
    fwd = ntt32.forward32(tables, x, 1)
    got_i = ntt32.inverse32(tables, fwd)[0]
    want_i = _np(pallas_inverse32(pp, jnp.asarray(_np(fwd[0]).astype(np.uint32)), 1, 2))
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_i.numpy(), data.astype(np.int64))


@pytest.mark.parametrize("log_n", [6, 11])
def test_plan_tables_match_reference(log_n):
    q = 1073692673
    port = build_plan32(log_n, q)
    ref = jax_build_plan32(log_n, q)
    for name in ("roots", "roots_precon", "inv_roots", "inv_roots_precon"):
        np.testing.assert_array_equal(getattr(port, name).numpy(), _np(getattr(ref, name)))
    for name in ("inv_n", "inv_n_precon", "inv_n_w", "inv_n_w_precon"):
        assert getattr(port, name) == int(getattr(ref, name)), name


def test_torus_primes_log_n_11_match_forward32():
    """The BOOLEAN_128 convolver's primes at N=2048, both primes in one
    ``(kp, ...)`` call, against the jnp reference transforms."""
    conv = make_convolver(11, 3, 1, 7)
    n = conv.n
    rng = np.random.default_rng(11)
    data = np.stack(
        [rng.integers(0, 4 * p, (2, n), dtype=np.uint64) for p in conv.primes]
    ).astype(np.uint32)  # forward accepts [0, 4q)
    x = torch.from_numpy(data.astype(np.int64))
    for out_factor in (1, 4):
        got = ntt32.forward32(conv.ntt, x, out_factor).numpy()
        for i, p in enumerate(conv.primes):
            want = _np(jax_forward32(jax_build_plan32(11, p), jnp.asarray(data[i]), out_factor))
            np.testing.assert_array_equal(got[i], want)
    lazy = np.stack(
        [rng.integers(0, 2 * p, (2, n), dtype=np.uint64) for p in conv.primes]
    ).astype(np.uint32)  # inverse accepts [0, 2q)
    for out_factor in (1, 2):
        got_i = ntt32.inverse32(conv.ntt, torch.from_numpy(lazy.astype(np.int64)), out_factor)
        for i, p in enumerate(conv.primes):
            want = _np(jax_inverse32(jax_build_plan32(11, p), jnp.asarray(lazy[i]), out_factor))
            np.testing.assert_array_equal(got_i[i].numpy(), want)


def test_wrapper_keeps_int32_storage():
    """Narrowed input stays narrowed: the same bits come back as int32."""
    q = 536813569
    tables = ntt32.NttTables32(6, [q])
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, q, (1, 2, 64), dtype=np.uint64).astype(np.int64))
    wide = ntt32.forward32(tables, x, 4)
    narrow = ntt32.forward32(tables, x.to(torch.int32), 4)
    assert narrow.dtype == torch.int32
    assert torch.equal(narrow.to(torch.int64) & 0xFFFFFFFF, wide)


def test_wrapper_rejects_other_devices():
    tables = ntt32.NttTables32(6, [536813569])
    x = torch.zeros((1, 2, 64), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        ntt32.forward32(tables, x)
    with pytest.raises(ValueError):
        ntt32.inverse32(tables, x)
