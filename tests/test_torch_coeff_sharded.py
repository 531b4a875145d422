"""Port vs the JAX package: the coefficient-sharded NTT
(``primus_fhe_tpu_torch/parallel/coeff_sharded.py``) and the plain versions
of its stage kernels (``ops/ntt_stages.py``).

- the expanded per-lane tables equal ``build_expanded_*``;
- each plain stage function equals the JAX ``pallas_stages_*`` kernel in
  interpret mode on the same words, lazy outputs included: u32 forward at
  ``out_factor`` 1 and 4, u32 inverse, u64 forward at 1, 2 and 4 and u64
  inverse at ``in_factor`` 2 and 4, each u64 one on a 50-bit modulus (the
  deferred schedule with the approximate Shoup quotient) and on the 62-bit
  q = 4611686018425815041 (exact Shoup, a reduction each stage);
- the four transforms on ``LocalMesh`` (d, log_n) = (2, 8), (4, 9), u32 and
  u64, against the JAX's with ``local_impl="jnp"`` on the JAX CPU mesh,
  forward, inverse and the round trip; and against ``local_impl="pallas"``
  (interpret mode) once per width at (2, 8).

Tolerance: zero (exact integers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from primus_fhe_tpu.numeric.limb import U64, from_u64_pair, to_u64_pair
from primus_fhe_tpu.ops import ntt_pallas as jp
from primus_fhe_tpu.parallel import coeff_sharded as jcs
from primus_fhe_tpu.parallel.mesh import make_mesh as jmake_mesh
from primus_fhe_tpu_torch.numeric.limb import u64_numpy, u64_tensor
from primus_fhe_tpu_torch.ops import ntt_stages as st
from primus_fhe_tpu_torch.parallel import coeff_sharded as cs
from primus_fhe_tpu_torch.parallel.mesh import LocalMesh, shard, unshard

Q32 = 536813569
Q50 = 1125899906826241
Q62 = 4611686018425815041
SPEC = (None, "residue")


def _j64(x):
    return to_u64_pair(np.asarray(x, dtype=np.uint64))


@pytest.mark.parametrize("log_n,q64", [(8, Q50), (9, Q62)])
def test_expanded_tables_match_jax(log_n, q64):
    for mine, theirs in ((cs.build_expanded_tables32, jcs.build_expanded_tables32),
                         (cs.build_expanded_inverse_tables32, jcs.build_expanded_inverse_tables32)):
        for a, b in zip(mine(log_n, Q32), theirs(log_n, Q32)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(np.int64))
    for mine, theirs in ((cs.build_expanded_tables64, jcs.build_expanded_tables64),
                         (cs.build_expanded_inverse_tables64, jcs.build_expanded_inverse_tables64)):
        for a, b in zip(mine(log_n, q64), theirs(log_n, q64)):
            np.testing.assert_array_equal(u64_numpy(a), from_u64_pair(b))


LOG_N, D = 9, 4  # stage slices of shard 1: width 128, 7 local stages
WIDTH, LOG_W = (1 << LOG_N) // D, LOG_N - 2


def _slices(tables, rows, cols):
    return tuple(t[rows, cols] for t in tables)


def test_stages32_plain_match_pallas():
    rng = np.random.default_rng(1)
    cols = slice(WIDTH, 2 * WIDTH)
    w, p = _slices(cs.build_expanded_tables32(LOG_N, Q32), slice(2, None), cols)
    x = rng.integers(0, 4 * Q32, (3, WIDTH), dtype=np.uint64).astype(np.uint32)
    for of in (1, 4):
        want = jp.pallas_stages_forward32(LOG_W, Q32, jnp.asarray(w.numpy().astype(np.uint32)),
                                          jnp.asarray(p.numpy().astype(np.uint32)),
                                          jnp.asarray(x), out_factor=of)
        got = st.ntt32_stages_forward(LOG_W, Q32, w, p, torch.from_numpy(x.astype(np.int64)), of)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    wi, pi = _slices(cs.build_expanded_inverse_tables32(LOG_N, Q32), slice(0, LOG_W), cols)
    x = rng.integers(0, 2 * Q32, (3, WIDTH), dtype=np.uint64).astype(np.uint32)
    want = jp.pallas_stages_inverse32(LOG_W, Q32, jnp.asarray(wi.numpy().astype(np.uint32)),
                                      jnp.asarray(pi.numpy().astype(np.uint32)), jnp.asarray(x))
    got = st.ntt32_stages_inverse(LOG_W, Q32, wi, pi, torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    # int32 storage in, int32 storage out, the same words
    got32 = st.ntt32_stages_inverse(LOG_W, Q32, wi, pi, torch.from_numpy(x.view(np.int32)))
    assert got32.dtype == torch.int32
    np.testing.assert_array_equal(got32.numpy().view(np.uint32), np.asarray(want))


def test_stages32_plain_match_pallas_on_tables_whose_pairs_differ():
    """The select form: the u32 forward multiplies y by the x lane's entry
    for x' and by the y lane's for y', the inverse by the y lane's; on
    per-lane tables drawn entry by entry (w < q, wp = floor(w 2^32 / q)),
    whose pair entries differ, the plain versions equal the JAX kernels
    (interpret mode) word for word, lazy outputs included."""
    rng = np.random.default_rng(3)
    log_w, width = 5, 32
    w = rng.integers(0, Q32, (log_w, width), dtype=np.int64)
    p = (w << 32) // Q32
    jw, jpp = jnp.asarray(w.astype(np.uint32)), jnp.asarray(p.astype(np.uint32))
    x = rng.integers(0, 4 * Q32, (3, width), dtype=np.int64)
    for of in (1, 4):
        want = jp.pallas_stages_forward32(log_w, Q32, jw, jpp, jnp.asarray(x.astype(np.uint32)),
                                          out_factor=of)
        got = st.ntt32_stages_forward(log_w, Q32, torch.from_numpy(w), torch.from_numpy(p),
                                      torch.from_numpy(x), of)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    x = rng.integers(0, 2 * Q32, (3, width), dtype=np.int64)
    want = jp.pallas_stages_inverse32(log_w, Q32, jw, jpp, jnp.asarray(x.astype(np.uint32)))
    got = st.ntt32_stages_inverse(log_w, Q32, torch.from_numpy(w), torch.from_numpy(p),
                                  torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("q", [Q50, Q62])
def test_stages64_plain_match_pallas(q):
    rng = np.random.default_rng(2)
    cols = slice(WIDTH, 2 * WIDTH)
    assert st.defers64(LOG_W, q) == (q == Q50)
    w, p = _slices(cs.build_expanded_tables64(LOG_N, q), slice(2, None), cols)
    jw, jpp = _j64(u64_numpy(w)), _j64(u64_numpy(p))
    x = rng.integers(0, 4 * q, (3, WIDTH), dtype=np.uint64)
    xp = _j64(x)
    for of in (1, 2, 4):
        lo, hi = jp.pallas_stages_forward64(LOG_W, q, jw, jpp, xp.lo, xp.hi, out_factor=of)
        got = st.ntt64_stages_forward(LOG_W, q, w, p, u64_tensor(x), of)
        np.testing.assert_array_equal(u64_numpy(got), from_u64_pair(U64(lo, hi)))
    wi, pi = _slices(cs.build_expanded_inverse_tables64(LOG_N, q), slice(0, LOG_W), cols)
    jwi, jpi = _j64(u64_numpy(wi)), _j64(u64_numpy(pi))
    for inf in (2, 4):
        x = rng.integers(0, inf * q, (3, WIDTH), dtype=np.uint64)
        xp = _j64(x)
        lo, hi = jp.pallas_stages_inverse64(LOG_W, q, jwi, jpi, xp.lo, xp.hi, in_factor=inf)
        got = st.ntt64_stages_inverse(LOG_W, q, wi, pi, u64_tensor(x), inf)
        np.testing.assert_array_equal(u64_numpy(got), from_u64_pair(U64(lo, hi)))


def _jax_sharded(d, log_n, fn, values, impl):
    mesh = jmake_mesh(d, residue=d)
    sh = NamedSharding(mesh, P(None, "residue"))
    put = jax.tree.map(lambda a: jax.device_put(a, sh), values)
    return fn(mesh, "residue", log_n, values_q(fn), put, local_impl=impl)


def values_q(fn):
    return Q32 if fn in (jcs.coeff_sharded_forward32, jcs.coeff_sharded_inverse32) else Q50


def _check32(d, log_n, impl):
    n = 1 << log_n
    rng = np.random.default_rng(d + log_n)
    x = rng.integers(0, Q32, (3, n), dtype=np.uint64).astype(np.uint32)
    mesh = LocalMesh(d, 1, "cpu")
    want_f = np.asarray(_jax_sharded(d, log_n, jcs.coeff_sharded_forward32, jnp.asarray(x), impl))
    got_f = cs.coeff_sharded_forward32(mesh, "residue", log_n, Q32,
                                       shard(mesh, torch.from_numpy(x.astype(np.int64)), SPEC))
    np.testing.assert_array_equal(unshard(mesh, got_f, SPEC).numpy(), want_f.astype(np.int64))
    want_i = np.asarray(_jax_sharded(d, log_n, jcs.coeff_sharded_inverse32, jnp.asarray(want_f),
                                     impl))
    got_i = cs.coeff_sharded_inverse32(mesh, "residue", log_n, Q32, got_f)
    np.testing.assert_array_equal(unshard(mesh, got_i, SPEC).numpy(), want_i.astype(np.int64))
    np.testing.assert_array_equal(want_i, x)


def _check64(d, log_n, impl):
    n = 1 << log_n
    rng = np.random.default_rng(d + log_n + 1)
    x = rng.integers(0, Q50, (2, n), dtype=np.uint64)
    mesh = LocalMesh(d, 1, "cpu")
    want_f = from_u64_pair(_jax_sharded(d, log_n, jcs.coeff_sharded_forward64, _j64(x), impl))
    got_f = cs.coeff_sharded_forward64(mesh, "residue", log_n, Q50,
                                       shard(mesh, u64_tensor(x), SPEC))
    np.testing.assert_array_equal(u64_numpy(unshard(mesh, got_f, SPEC)), want_f)
    want_i = from_u64_pair(_jax_sharded(d, log_n, jcs.coeff_sharded_inverse64, _j64(want_f),
                                        impl))
    got_i = cs.coeff_sharded_inverse64(mesh, "residue", log_n, Q50, got_f)
    np.testing.assert_array_equal(u64_numpy(unshard(mesh, got_i, SPEC)), want_i)
    np.testing.assert_array_equal(want_i, x)


@pytest.mark.parametrize("d,log_n", [(2, 8), (4, 9)])
@pytest.mark.parametrize("width", [32, 64])
def test_coeff_sharded_matches_jax(d, log_n, width):
    (_check32 if width == 32 else _check64)(d, log_n, "jnp")


@pytest.mark.parametrize("width", [32, 64])
def test_coeff_sharded_matches_jax_pallas(width):
    (_check32 if width == 32 else _check64)(2, 8, "pallas")


def test_inverse_needs_two_shards():
    mesh = LocalMesh(1, 1, "cpu")
    with pytest.raises(ValueError):
        cs.coeff_sharded_inverse32(mesh, "residue", 8, Q32, [torch.zeros(1, 256, dtype=torch.int64)])
