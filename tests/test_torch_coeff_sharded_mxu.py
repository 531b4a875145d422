"""Port vs the JAX package and numpy: row 13, the coefficient-sharded
byte-radix NTT (``primus_fhe_tpu_torch/parallel/coeff_sharded_mxu.py`` and
its half-transforms ``ops/ntt_mxu8_split.py``), and the tiled
``all_to_all`` of the mesh layer.

- ``all_to_all`` on ``LocalMesh`` (2, 2), (4, 1), (1, 4), both axes, against
  a numpy model of ``jax.lax.all_to_all(..., tiled=True)``, and on a 2-rank
  gloo ``ProcessGroupMesh`` equal to the local mesh's;
- ``sharded_mxu_forward64`` and ``sharded_mxu_inverse64`` (with and without
  the fixed operand) on ``LocalMesh(8, 1)`` against the JAX's on its 8
  virtual CPU devices (Pallas in interpret mode) at log_n 10, batch 8, for a
  7-plane general prime and an 8-plane prime;
- D = 1, 2, 4 on ``LocalMesh`` and D = 2 on gloo against the port's
  single-card ``mxu8_forward64``/``mxu8_inverse64``/``mxu8_inverse64_mul``
  plain versions (already held to the JAX);
- a numpy model of the four kernels' data flow on the kernel-layout tables
  (the csrc's byte planes, fold and Shoup twiddle) against the plain halves,
  shard offsets and the key included: K2 and Ki2 word-equal, K1 and Ki1
  below 2q and equal mod q (the lazy-word rule of ``ops/ntt_mxu8_split.py``);
- the layout converters against the JAX's.

Tolerance: zero (exact integers).
"""

import jax
import numpy as np
import pytest
import torch

import _torch_dist_workers as workers
from primus_fhe_tpu.numeric.limb import to_u64_pair as jto
from primus_fhe_tpu.numeric.limb import from_u64_pair as jfrom
from primus_fhe_tpu.ops.ntt_mxu8 import Mxu8NttPlan64 as JPlan
from primus_fhe_tpu.parallel import coeff_sharded_mxu as jcsm
from primus_fhe_tpu_torch.numeric.limb import u64_numpy, u64_tensor
from primus_fhe_tpu_torch.ops import ntt_mxu8, ntt_mxu8_split as split
from primus_fhe_tpu_torch.parallel import coeff_sharded_mxu as csm
from primus_fhe_tpu_torch.parallel.mesh import LocalMesh, shard, unshard
from test_torch_ntt64 import _bytes64, _canonical, _consts, _planes64, _shoup

LOG_N, BATCH = 10, 8
Q50 = 1125899906629633  # 7 planes, not a Solinas prime
Q60 = 1152921504606830593  # 8 planes
COEFF, NTT = (None, "residue", None), ("residue", None, None)


# -- the tiled all_to_all -----------------------------------------------------


def _expected_all_to_all(shape, case):
    name, axis = case.split("/")
    sd, cd = int(name[-2]), int(name[-1])
    size = shape[0] * shape[1]
    xs = [workers.shard_input(s).numpy() for s in range(size)]
    out = []
    for s in range(size):
        r, b = divmod(s, shape[1])
        members = ([i * shape[1] + b for i in range(shape[0])] if axis == "residue"
                   else [r * shape[1] + j for j in range(shape[1])])
        i = members.index(s)
        out.append(np.concatenate([np.split(xs[m], len(members), axis=sd)[i] for m in members],
                                  axis=cd))
    return out


@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (1, 4)])
def test_local_all_to_all_matches_numpy(shape):
    for case, got in workers.all_to_all_cases(LocalMesh(*shape, "cpu")).items():
        for s, (g, w) in enumerate(zip(got, _expected_all_to_all(shape, case))):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{shape} {case} dev {s}")


# -- the sharded transforms ---------------------------------------------------


def _inputs(q, seed, log_n=LOG_N, batch=BATCH):
    rng = np.random.default_rng(seed)
    n = 1 << log_n
    return (rng.integers(0, q, (batch, n), dtype=np.uint64),
            rng.integers(0, q, n, dtype=np.uint64))


def _port(d, q, x, key, log_n=LOG_N):
    """Forward, inverse and keyed inverse on ``LocalMesh(d, 1)``, each
    assembled to ``(batch, n)``."""
    mesh = LocalMesh(d, 1, "cpu")
    plan = csm.get_sharded_plan(log_n, q)
    xc = shard(mesh, csm.to_coeff_layout(u64_tensor(x), plan.A, plan.B), COEFF)
    f = csm.sharded_mxu_forward64(mesh, "residue", log_n, q, xc)
    mt = plan.tables.mul_table(u64_tensor(key)[None])
    inv = csm.sharded_mxu_inverse64(mesh, "residue", log_n, q, f)
    inv_mul = csm.sharded_mxu_inverse64(mesh, "residue", log_n, q, f, mul_tab=mt)
    return (u64_numpy(csm.ntt_layout_to_flat(unshard(mesh, f, NTT))),
            u64_numpy(csm.from_coeff_layout(unshard(mesh, inv, COEFF))),
            u64_numpy(csm.from_coeff_layout(unshard(mesh, inv_mul, COEFF))))


@pytest.mark.parametrize("q", [Q50, Q60])
def test_sharded_transforms_match_jax(q):
    x, key = _inputs(q, 1)
    jplan = JPlan(LOG_N, q)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:8]), ("d",))
    f3 = jcsm.sharded_mxu_forward64(jmesh, "d", LOG_N, q, jcsm.to_coeff_layout(jto(x), 8, 128), 1)
    want_f = jfrom(jcsm.ntt_layout_to_flat(f3))
    want_i = jfrom(jcsm.from_coeff_layout(jcsm.sharded_mxu_inverse64(jmesh, "d", LOG_N, q, f3, 1)))
    want_m = jfrom(jcsm.from_coeff_layout(jcsm.sharded_mxu_inverse64(
        jmesh, "d", LOG_N, q, f3, 1, mul_tabs=jplan.inverse_mul_tabs(key))))
    got_f, got_i, got_m = _port(8, q, x, key)
    np.testing.assert_array_equal(got_f, want_f)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_m, want_m)
    np.testing.assert_array_equal(got_i, x)


def _single_card(q, x, key, log_n=LOG_N):
    tables = csm.get_sharded_plan(log_n, q).tables
    f = ntt_mxu8.mxu8_forward64_plain(tables, u64_tensor(x)[None])
    mt = tables.mul_table(u64_tensor(key)[None])
    return u64_numpy(f[0]), u64_numpy(ntt_mxu8.mxu8_inverse64_mul_plain(tables, f, mt)[0])


@pytest.mark.parametrize("d,q,log_n", [(1, Q50, 10), (2, Q60, 10), (4, Q50, 10), (2, Q50, 8)])
def test_sharded_transforms_match_single_card(d, q, log_n):
    x, key = _inputs(q, 10 + d, log_n, 4)
    want_f, want_m = _single_card(q, x, key, log_n)
    got_f, got_i, got_m = _port(d, q, x, key, log_n)
    np.testing.assert_array_equal(got_f, want_f)
    np.testing.assert_array_equal(got_i, x)
    np.testing.assert_array_equal(got_m, want_m)


def test_gloo_all_to_all_and_sharded_transforms(tmp_path):
    q, shape = Q50, (2, 1)
    x, key = _inputs(q, 5, LOG_N, 4)
    plan = csm.get_sharded_plan(LOG_N, q)
    torch.save({"log_n": LOG_N, "q": q, "mul_tab": plan.tables.mul_table(u64_tensor(key)[None]),
                "coeff": csm.to_coeff_layout(u64_tensor(x), plan.A, plan.B)},
               tmp_path / "inputs.pt")
    ranks = workers.run_ranks(tmp_path, 2, "coeff_mxu", (shape, str(tmp_path / "inputs.pt")))
    local = workers.all_to_all_cases(LocalMesh(*shape, "cpu"))
    for case, vals in local.items():
        for r in range(2):
            assert torch.equal(ranks[r][case], vals[r]), (case, r)
    want_f, want_m = _single_card(q, x, key)
    for r in range(2):
        np.testing.assert_array_equal(u64_numpy(csm.ntt_layout_to_flat(ranks[r]["forward"])), want_f)
        np.testing.assert_array_equal(u64_numpy(csm.from_coeff_layout(ranks[r]["inverse"])), x)
        np.testing.assert_array_equal(u64_numpy(csm.from_coeff_layout(ranks[r]["inverse_mul"])),
                                      want_m)


def test_sharded_refuses_bad_splits():
    mesh = LocalMesh(4, 1, "cpu")  # A = 2 at log_n 8: 4 does not divide it
    x = torch.zeros((2, 32, 1), dtype=torch.int64)
    with pytest.raises(ValueError):
        csm.sharded_mxu_forward64(mesh, "residue", 8, Q50, [x] * 4)
    with pytest.raises(ValueError):
        csm.sharded_mxu_forward64(LocalMesh(1, 1, "cpu"), "residue", 8, Q50, [x[:, :1]], 3)


def test_layout_converters_match_jax():
    x, _ = _inputs(Q50, 3, 8, 3)
    t = u64_tensor(x)
    np.testing.assert_array_equal(u64_numpy(csm.to_coeff_layout(t, 2, 128)),
                                  jfrom(jcsm.to_coeff_layout(jto(x), 2, 128)))
    np.testing.assert_array_equal(u64_numpy(csm.ntt_layout_from_flat(t, 2, 128)),
                                  jfrom(jcsm.ntt_layout_from_flat(jto(x), 2, 128)))
    np.testing.assert_array_equal(u64_numpy(csm.from_coeff_layout(csm.to_coeff_layout(t, 2, 128))),
                                  x)
    np.testing.assert_array_equal(
        u64_numpy(csm.ntt_layout_to_flat(csm.ntt_layout_from_flat(t, 2, 128))), x)


# -- a numpy model of the four kernels --------------------------------------


def _model(tables, kind, x, batch=1, off=0, key=None):
    """``split_col64_kernel`` (K1, Ki2) or ``split_row64_kernel`` (K2, Ki1)
    of ``csrc/ntt_mxu8_split.cu`` on one modulus: ``x (A, L)`` or ``(rows,
    128)`` u64 -> the kernel's words."""
    tabs = {k: v.numpy() for k, v in tables.kernel_tables("cpu").items()}
    P, A, B = tables.planes, tables.A, tables.B
    c = _consts(tables, 0)
    tw = tabs["tw"][0].view(np.uint64).astype(object).reshape(4, A, B)
    if kind in ("k1", "ki2"):
        w = tabs["w1" if kind == "k1" else "wi2"][0]
        y = _planes64(_bytes64(x.T, w.shape[1]), w, P, w.shape[0] // P, A, c).T  # (A, L)
        if kind == "ki2":
            return _canonical(y, c)
        k0 = off + np.arange(x.shape[1]) // batch
        return _shoup(y, tw[0][:, k0], tw[1][:, k0], c["q"])
    if key is not None:
        idx = (np.arange(x.shape[0]) // batch)[:, None] * B + np.arange(B)
        x = _shoup(x.astype(object), key[0][idx], key[1][idx], c["q"]).astype(np.uint64)
    w = tabs["w2" if kind == "k2" else "wi1"][0]
    y = _planes64(_bytes64(x, 8 * B), w, P, B, B, c)  # (rows, B)
    if kind == "k2":
        return _canonical(y, c)
    r0 = off + np.arange(x.shape[0]) // batch
    return _shoup(y, tw[2][r0], tw[3][r0], c["q"])


def _lazy_equal(model, plain, q):
    model = model.astype(object)
    assert (model < 2 * q).all()
    np.testing.assert_array_equal((model % q).astype(np.uint64), plain)


@pytest.mark.parametrize("log_n,q,d,index", [(8, Q50, 2, 1), (10, Q60, 4, 2), (12, Q50, 8, 5)])
def test_split_kernel_model_matches_plain(log_n, q, d, index):
    plan = csm.get_sharded_plan(log_n, q)
    tables = plan.tables
    A, B = plan.A, plan.B
    k0_off, r0_off = plan.offsets(d, index)
    batch = 2
    rng = np.random.default_rng(log_n)
    lanes = rng.integers(0, 1 << 64, (A, B // d * batch), dtype=np.uint64)
    lanes[0, :3] = [0, (1 << 64) - 1, q]
    rows = rng.integers(0, 1 << 64, (A // d * batch, B), dtype=np.uint64)
    key = rng.integers(0, q, (1, 1 << log_n), dtype=np.uint64)
    mt = tables.mul_table(u64_tensor(key))
    mul_rows = mt.reshape(1, 2, A, B)[:, :, r0_off:r0_off + A // d].reshape(1, 2, -1).contiguous()
    kr = u64_numpy(mul_rows[0]).astype(object)

    k1 = split.split_k1(tables, u64_tensor(lanes)[None], batch, k0_off)
    _lazy_equal(_model(tables, "k1", lanes, batch, k0_off), u64_numpy(k1[0]), q)
    ki2 = split.split_ki2(tables, u64_tensor(lanes)[None])
    np.testing.assert_array_equal(_model(tables, "ki2", lanes).astype(np.uint64), u64_numpy(ki2[0]))
    k2 = split.split_k2(tables, u64_tensor(rows)[None])
    np.testing.assert_array_equal(_model(tables, "k2", rows).astype(np.uint64), u64_numpy(k2[0]))
    for kr_, mr in ((None, None), (kr, mul_rows)):
        ki1 = split.split_ki1(tables, u64_tensor(rows)[None], batch, r0_off, mr)
        _lazy_equal(_model(tables, "ki1", rows, batch, r0_off, kr_), u64_numpy(ki1[0]), q)


def test_split_wrappers_refuse_bad_arguments():
    tables = csm.get_sharded_plan(8, Q50).tables
    meta = torch.zeros((1, 2, 256), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        split.split_k1(tables, meta, 2, 0)
    with pytest.raises(ValueError):
        split.split_k1(tables, torch.zeros((1, 2, 256), dtype=torch.int64), 2, 64)  # past B
    with pytest.raises(ValueError):
        split.split_ki1(tables, torch.zeros((1, 4, 128), dtype=torch.int64), 3, 0)  # rows % batch
    with pytest.raises(ValueError):
        split.split_k2(tables, torch.zeros((1, 4, 64), dtype=torch.int64))
    with pytest.raises(ValueError):
        split.split_ki1(tables, torch.zeros((1, 4, 128), dtype=torch.int64), 2, 0,
                        torch.zeros((1, 2, 128), dtype=torch.int64))
