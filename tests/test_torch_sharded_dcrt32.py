"""Port vs the JAX package: the 32-bit DCRT transforms
(``primus_fhe_tpu_torch/transforms/dcrt.py``) and the sharded DCRT and
external product (``primus_fhe_tpu_torch/parallel/sharded.py``).

- ``dcrt_forward32``/``dcrt_inverse32`` against the JAX's at ``out_factor`` 1
  and 4 (forward) and 1 and 2 (inverse): four 30-bit primes (one kernel
  group) and five (two groups), log_n 8;
- the residue-sharded transforms on ``LocalMesh`` (4, 2) and (2, 1) equal to
  the single-card ones;
- ``sharded_external_product`` on ``LocalMesh`` (2, 4), (2, 2) and (1, 2),
  batched and unbatched, against the JAX's ``tfhe.external_product`` on the
  case of ``tests/test_sharding.py:79`` (N = 32, k = 1, gadget 2^8 x 3).

Tolerance: zero (exact integers).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primus_fhe_tpu.decompose import ApproxSignedBasis32 as JBasis32
from primus_fhe_tpu.lattice import tfhe as jtfhe
from primus_fhe_tpu.transforms import dcrt as jdcrt
from primus_fhe_tpu_torch.decompose import ApproxSignedBasis32
from primus_fhe_tpu_torch.lattice import tfhe
from primus_fhe_tpu_torch.parallel import sharded
from primus_fhe_tpu_torch.parallel.mesh import LocalMesh, unshard
from primus_fhe_tpu_torch.transforms import dcrt

MOD32 = [1073707009, 1073698817, 1073692673, 1073682433]  # tests/test_sharding.py
MOD32_5 = MOD32 + [1073668097]


def _values(moduli, factor, shape, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, factor * q, shape, dtype=np.uint64) for q in moduli])


@pytest.mark.parametrize("moduli", [MOD32, MOD32_5])
def test_dcrt32_matches_jax(moduli):
    log_n = 8
    plan, jplan = dcrt.build_dcrt_plan32(log_n, moduli), jdcrt.build_dcrt_plan32(log_n, moduli)
    assert len(plan.groups) == (len(moduli) + 3) // 4
    x = _values(moduli, 4, (3, 1 << log_n), len(moduli))
    for of in (1, 4):
        got = dcrt.dcrt_forward32(plan, torch.from_numpy(x.astype(np.int64)), of).numpy()
        want = np.asarray(jdcrt.dcrt_forward32(jplan, jnp.asarray(x.astype(np.uint32)), of))
        np.testing.assert_array_equal(got, want.astype(np.int64), err_msg=f"forward {of}")
    y = _values(moduli, 2, (3, 1 << log_n), 7)
    for of in (1, 2):
        got = dcrt.dcrt_inverse32(plan, torch.from_numpy(y.astype(np.int64)), of).numpy()
        want = np.asarray(jdcrt.dcrt_inverse32(jplan, jnp.asarray(y.astype(np.uint32)), of))
        np.testing.assert_array_equal(got, want.astype(np.int64), err_msg=f"inverse {of}")


@pytest.mark.parametrize("shape", [(4, 2), (2, 1)])
def test_residue_sharded_dcrt32_matches_single(shape):
    log_n = 8
    plan = dcrt.build_dcrt_plan32(log_n, MOD32)
    x = torch.from_numpy(_values(MOD32, 1, (4, 1 << log_n), 3).astype(np.int64))
    mesh = LocalMesh(*shape, "cpu")
    spec = sharded.residue_spec(3, 1)
    f = sharded.sharded_dcrt_forward32(plan, sharded.shard_dcrt_values(x, mesh, 1), mesh)
    assert torch.equal(unshard(mesh, f, spec), dcrt.dcrt_forward32(plan, x))
    back = sharded.sharded_dcrt_inverse32(plan, f, mesh)
    assert torch.equal(unshard(mesh, back, spec), x)
    lazy = sharded.sharded_dcrt_forward32(plan, sharded.shard_dcrt_values(x, mesh), mesh, 4)
    assert torch.equal(unshard(mesh, lazy, sharded.residue_spec(3)),
                       dcrt.dcrt_forward32(plan, x, 4))
    with pytest.raises(ValueError):
        sharded.sharded_dcrt_forward32(dcrt.build_dcrt_plan32(log_n, MOD32[:3]), f, mesh)


@pytest.mark.parametrize("shape", [(2, 4), (2, 2), (1, 2)])
def test_sharded_external_product_matches_jax(shape):
    log_n, k, lb, lv, batch = 5, 1, 8, 3, 4
    n = 1 << log_n
    conv = tfhe.make_convolver(log_n, lv, k, lb)
    jconv = jtfhe.make_convolver(log_n, lv, k, lb)
    assert conv.primes == jconv.primes
    rng = np.random.default_rng(5)
    glwe = rng.integers(0, 1 << 32, (batch, k + 1, n), dtype=np.uint64)
    key = rng.integers(0, 1 << 20, (conv.count, k + 1, lv, k + 1, n), dtype=np.uint64)
    want = np.asarray(jtfhe.external_product(
        jconv, JBasis32(None, lb, reverse_length=lv), jnp.asarray(glwe.astype(np.uint32)),
        jnp.asarray(key.astype(np.uint32)))).astype(np.int64)
    basis = ApproxSignedBasis32(None, lb, reverse_length=lv)
    mesh = LocalMesh(*shape, "cpu")
    g_t, k_t = torch.from_numpy(glwe.astype(np.int64)), torch.from_numpy(key.astype(np.int64))
    for g_full, w in ((g_t, want), (g_t[1], want[1])):
        g, kk = sharded.shard_external_product_inputs(mesh, g_full, k_t)
        out = sharded.sharded_external_product(conv, basis, g, kk, mesh)
        got = unshard(mesh, out, sharded.glwe_spec(g_full.dim()))
        np.testing.assert_array_equal(got.numpy(), w)
