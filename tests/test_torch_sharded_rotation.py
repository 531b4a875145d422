"""Port vs the JAX package: the residue-sharded gadget product, the sharded
DCRT blind rotation and the multi-device entry step
(``primus_fhe_tpu_torch/parallel/{overlap,sharded_rotation,entry}.py``).

- ``make_sharded_gadget_product`` (log_n 5, two 50-bit moduli, L = 4) on
  ``LocalMesh`` (1, 2) and (2, 2), both routes' plain versions, against the
  JAX ``make_sharded_gadget_product`` on a (2, 2) CPU mesh;
- the entry step (log_n 5, n_lwe 4, batch 16, the JAX entry's
  ``default_rng(1)`` inputs): the JAX ``__graft_entry__.make_sharded_rotation_step``
  (``make_sharded_blind_rotation`` on a (2, 4) mesh) is the reference for
  the port's ``parallel/entry.py`` twin on ``LocalMesh`` (2, 4) and for the
  port's ``make_sharded_blind_rotation`` on ``LocalMesh`` (2, 4), (2, 1),
  (1, 2) on the inputs, both routes; the dry run's description line
  matches the JAX entry's keys and values;
- the same three on a 4-rank gloo ``ProcessGroupMesh`` (2, 2), ranks run
  by ``tests/_torch_dist_workers.py`` under a join deadline;
- the byte-radix route (``"mxu8"``: the plans need log_n >= 8) at log_n 8,
  n_lwe 2 on ``LocalMesh`` (2, 4) and (1, 2), against the JAX
  ``dcrt_blind_rotate_batched``: a JAX sharded step at that width would
  take ~20 s more to compile here, and the JAX's own
  ``tests/test_sharded_rotation.py`` holds it equal to the sharded one.

Tolerance: zero (bit-equal words).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
import _torch_dist_workers as workers
from primus_fhe_tpu.boot.dcrt_blind_rotate import dcrt_blind_rotate_batched as jrotate
from primus_fhe_tpu.decompose import BigUintApproxSignedBasis as JBasis
from primus_fhe_tpu.numeric.limb import from_u64_pair, to_u64_pair
from primus_fhe_tpu.parallel.mesh import make_mesh as jmake_mesh
from primus_fhe_tpu.parallel.overlap import make_sharded_gadget_product as jgadget
from primus_fhe_tpu.parallel.overlap import shard_gadget_inputs as jshard_gadget
from primus_fhe_tpu.rns import RNSBase64 as JBase
from primus_fhe_tpu.transforms.dcrt import build_dcrt_plan64 as jplan
from primus_fhe_tpu_torch.decompose import BigUintApproxSignedBasis
from primus_fhe_tpu_torch.numeric.limb import u64_numpy, u64_tensor
from primus_fhe_tpu_torch.parallel import entry
from primus_fhe_tpu_torch.parallel.mesh import LocalMesh, unshard
from primus_fhe_tpu_torch.parallel.overlap import (
    GLWE_SPEC, make_sharded_gadget_product, shard_gadget_inputs)
from primus_fhe_tpu_torch.parallel.sharded_rotation import (
    ACC_SPEC, make_sharded_blind_rotation, shard_rotation_inputs)
from primus_fhe_tpu_torch.rns import RNSBase64
from primus_fhe_tpu_torch.transforms.dcrt import build_dcrt_plan64

MODULI = entry.MODULI
LOG_N, N_LWE, BATCH = 5, 4, 16


def _port(log_n):
    base = RNSBase64(MODULI)
    return base, BigUintApproxSignedBasis(base, 25), build_dcrt_plan64(log_n, MODULI)


def _gadget_inputs():
    rng = np.random.default_rng(3)
    level = BigUintApproxSignedBasis(RNSBase64(MODULI), 25).decompose_length
    glwe = rng.integers(0, min(MODULI), size=(2, 2, 1 << LOG_N), dtype=np.uint64)
    ggsw = rng.integers(0, min(MODULI), size=(2, level, 2, 2, 1 << LOG_N), dtype=np.uint64)
    return glwe, ggsw


@pytest.fixture(scope="module")
def jax_gadget():
    """The JAX sharded gadget product on a (residue 2, batch 2) mesh."""
    glwe, ggsw = _gadget_inputs()
    base = JBase(MODULI)
    mesh = jmake_mesh(4, residue=2)
    fn = jgadget(mesh, "residue", JBasis(base, 25), jplan(LOG_N, MODULI), base)
    return from_u64_pair(fn(*jshard_gadget(mesh, "residue", to_u64_pair(glwe),
                                           to_u64_pair(ggsw))))


@pytest.fixture(scope="module")
def jax_step():
    """The JAX entry's sharded rotation step and its inputs."""
    step, (lwe, acc, bsk), (mesh, _) = jentry.make_sharded_rotation_step(
        8, log_n=LOG_N, n_lwe=N_LWE)
    out = step(lwe, acc, bsk)
    return dict(out=from_u64_pair(out), bsk=from_u64_pair(bsk), acc=from_u64_pair(acc),
                lwe=np.array(lwe), mesh=dict(mesh.shape))


@pytest.fixture(scope="module")
def gloo_results(tmp_path_factory):
    """The gadget product, the rotation and the entry step on 4 gloo ranks."""
    path = tmp_path_factory.mktemp("gloo_dcrt")
    glwe, ggsw = _gadget_inputs()
    bsk, acc, lwe = entry.make_inputs(LOG_N, N_LWE, BATCH)
    torch.save(dict(log_n=LOG_N, n_lwe=N_LWE, batch=BATCH, glwe=u64_tensor(glwe), ggsw=u64_tensor(ggsw),
                    bsk=u64_tensor(bsk), acc=u64_tensor(acc), lwe=torch.from_numpy(lwe)),
               path / "inputs.pt")
    ranks = workers.run_ranks(path / "ranks", 4, "dcrt", ((2, 2), str(path / "inputs.pt")))
    for r in ranks[1:]:  # every rank assembled the same outputs
        assert all(torch.equal(r[k], ranks[0][k]) for k in r)
    return ranks[0]


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
@pytest.mark.parametrize("route", ["butterfly", "auto"])
def test_gadget_product_local_matches_jax(jax_gadget, shape, route):
    base, basis, plan = _port(LOG_N)
    glwe, ggsw = _gadget_inputs()
    mesh = LocalMesh(*shape, "cpu")
    fn = make_sharded_gadget_product(mesh, "residue", basis, plan, base, route)
    out = fn(*shard_gadget_inputs(mesh, "residue", u64_tensor(glwe), u64_tensor(ggsw)))
    np.testing.assert_array_equal(u64_numpy(unshard(mesh, out, GLWE_SPEC)), jax_gadget)


def test_entry_inputs_and_step_match_jax(jax_step, capsys):
    bsk, acc, lwe = entry.make_inputs(LOG_N, N_LWE, BATCH)
    np.testing.assert_array_equal(bsk, jax_step["bsk"])
    np.testing.assert_array_equal(acc, jax_step["acc"])
    np.testing.assert_array_equal(lwe, jax_step["lwe"])
    mesh = LocalMesh(2, 4, "cpu")
    step, (s_lwe, s_acc, s_bsk), _ = entry.make_sharded_rotation_step(mesh, LOG_N, N_LWE)
    got = unshard(mesh, step(s_lwe, s_acc, s_bsk), ACC_SPEC)
    np.testing.assert_array_equal(u64_numpy(got), jax_step["out"])
    capsys.readouterr()
    desc = entry.dryrun_multichip(mesh, LOG_N, N_LWE)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == desc
    batch, n_res, k1, n = jax_step["acc"].shape
    assert desc == {"dryrun": "batched DCRT blind rotation", "n_devices": 8,
                    "mesh": jax_step["mesh"], "N": n, "residues": n_res, "moduli_bits": 50,
                    "glwe_k_plus_1": k1, "gadget_levels": jax_step["bsk"].shape[2],
                    "lwe_dim": jax_step["bsk"].shape[0], "batch": batch}


@pytest.mark.parametrize("shape", [(2, 4), (2, 1), (1, 2)])
@pytest.mark.parametrize("route", ["butterfly", "auto"])
def test_rotation_local_matches_jax(jax_step, shape, route):
    base, basis, plan = _port(LOG_N)
    mesh = LocalMesh(*shape, "cpu")
    fn = make_sharded_blind_rotation(mesh, "residue", "batch", basis, plan, base, route)
    out = fn(*shard_rotation_inputs(mesh, "residue", "batch", u64_tensor(jax_step["bsk"]),
                                    torch.from_numpy(jax_step["lwe"]), u64_tensor(jax_step["acc"])))
    np.testing.assert_array_equal(u64_numpy(unshard(mesh, out, ACC_SPEC)), jax_step["out"])


def test_gadget_product_gloo_matches_jax(gloo_results, jax_gadget):
    np.testing.assert_array_equal(u64_numpy(gloo_results["gadget"]), jax_gadget)


def test_rotation_gloo_matches_jax(gloo_results, jax_step):
    np.testing.assert_array_equal(u64_numpy(gloo_results["rotation"]), jax_step["out"])


def test_entry_gloo_matches_jax(gloo_results, jax_step):
    np.testing.assert_array_equal(u64_numpy(gloo_results["entry"]), jax_step["out"])


def test_mxu8_route_matches_jax_rotation():
    log_n, n_lwe, batch = 8, 2, 8
    n = 1 << log_n
    rng = np.random.default_rng(7)
    level = BigUintApproxSignedBasis(RNSBase64(MODULI), 25).decompose_length
    bsk = rng.integers(0, min(MODULI), size=(n_lwe, 2, level, 2, 2, n), dtype=np.uint64)
    acc = rng.integers(0, min(MODULI), size=(batch, 2, 2, n), dtype=np.uint64)
    lwe = rng.integers(0, 2 * n, size=(batch, n_lwe + 1)).astype(np.int32)
    jbase = JBase(MODULI)
    want = from_u64_pair(jrotate(jplan(log_n, MODULI), JBasis(jbase, 25), jbase,
                                 to_u64_pair(bsk), jnp.asarray(lwe), to_u64_pair(acc)))
    base, basis, plan = _port(log_n)
    for shape in ((2, 4), (1, 2)):
        mesh = LocalMesh(*shape, "cpu")
        fn = make_sharded_blind_rotation(mesh, "residue", "batch", basis, plan, base, "mxu8")
        out = fn(*shard_rotation_inputs(mesh, "residue", "batch", u64_tensor(bsk),
                                        torch.from_numpy(lwe), u64_tensor(acc)))
        np.testing.assert_array_equal(u64_numpy(unshard(mesh, out, ACC_SPEC)), want)

