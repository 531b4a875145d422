"""Port vs numpy and the JAX package: the mesh layer's collectives and the
CRT compose collective (``primus_fhe_tpu_torch/parallel/{mesh,overlap}.py``).

- every collective (``psum``, tiled ``psum_scatter`` and ``all_gather`` on
  both dims, XOR swaps, a partial shift ``ppermute``) on both axes of
  ``LocalMesh`` (2, 2), (4, 1) and (1, 4), against a numpy model of the
  ``shard_map`` semantics;
- the same cases on gloo ``ProcessGroupMesh``es of 2 ranks ((2, 1), (1, 2))
  and 4 ranks ((4, 1), (2, 2), (1, 4)), equal to the local mesh's; the ranks
  run in ``tests/_torch_dist_workers.py`` under a join deadline;
- ``psum_bigint`` on its three branches (1-D all-reduce, 16-bit halves
  reduce-scatter, W-bit narrow reduce-scatter) at D = 1, 2, 4 against the
  JAX ``_psum_bigint`` under ``shard_map`` on the same limbs, and against
  Python integers;
- ``shard``/``unshard`` round trips with a replicated axis.

Tolerance: zero (exact integers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_dist_workers as workers
from primus_fhe_tpu.numeric.bigint import big_from_int as jbig_from_int
from primus_fhe_tpu.parallel.mesh import make_mesh as jmake_mesh
from primus_fhe_tpu.parallel.overlap import _psum_bigint
from primus_fhe_tpu_torch.parallel.mesh import LocalMesh, shard, unshard
from primus_fhe_tpu_torch.parallel.overlap import psum_bigint, q_multiples

LOCAL_SHAPES = [(2, 2), (4, 1), (1, 4)]
BRANCHES = ("allreduce", "halves", "narrow")


def _line(shape, s, axis):
    r, b = divmod(s, shape[1])
    if axis == "residue":
        return [i * shape[1] + b for i in range(shape[0])]
    return [r * shape[1] + j for j in range(shape[1])]


def _limbs_to_int(v):
    return sum(int(x) << (32 * i) for i, x in enumerate(v))


def _expected(shape, case):
    """The numpy model of one collective case: every device's result."""
    size = shape[0] * shape[1]
    name, axis = case.split("/")
    if name == "bigint":  # the sum mod Q over the residue line, as Python ints
        q = workers.bigint_input(0, axis)[2]
        out = []
        for s in range(size):
            vals = [workers.bigint_input(m, axis)[1] for m in _line(shape, s, "residue")]
            out.append([sum(v[c] for v in vals) % q for c in range(len(vals[0]))])
        return out
    xs = [workers.shard_input(s).numpy() for s in range(size)]
    out = []
    for s in range(size):
        members = _line(shape, s, axis)
        i, g = members.index(s), len(members)
        vals = [xs[m] for m in members]
        if name == "psum":
            out.append(sum(vals))
        elif name.startswith("psum_scatter"):
            out.append(np.split(sum(vals), g, axis=int(name[-1]))[i])
        elif name.startswith("all_gather"):
            out.append(np.concatenate(vals, axis=int(name[-1])))
        elif name.startswith("swap"):
            out.append(vals[i ^ int(name[4:])])
        else:  # shift: device i receives device i-1's shard, device 0 zeros
            out.append(vals[i - 1] if i else np.zeros_like(vals[0]))
    return out


def _check_cases(shape, results):
    """``results[case][s]``: device ``s``'s tensor."""
    for case, got in results.items():
        want = _expected(shape, case)
        for s, (g, w) in enumerate(zip(got, want)):
            if case.startswith("bigint"):
                got_ints = [_limbs_to_int(v) for v in g.reshape(-1, 5).tolist()]
                assert got_ints == w, (shape, case, s)
            else:
                np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{shape} {case} dev {s}")


@pytest.mark.parametrize("shape", LOCAL_SHAPES)
def test_local_mesh_collectives(shape):
    _check_cases(shape, workers.collective_cases(LocalMesh(*shape, "cpu")))


@pytest.mark.parametrize("world,shapes", [(2, [(2, 1), (1, 2)]), (4, [(4, 1), (2, 2), (1, 4)])])
def test_gloo_mesh_collectives(tmp_path, world, shapes):
    ranks = workers.run_ranks(tmp_path, world, "collectives", (shapes,))
    for shape in shapes:
        by_case = {case: [ranks[r][shape][case][0] for r in range(world)]
                   for case in ranks[0][shape]}
        _check_cases(shape, by_case)
        local = workers.collective_cases(LocalMesh(*shape, "cpu"))
        for case, vals in local.items():
            for r in range(world):
                assert torch.equal(by_case[case][r], vals[r]), (shape, case, r)


def _jax_psum_bigint(d, branch):
    parts = np.stack([workers.bigint_input(s, branch)[0].numpy() for s in range(d)])
    q = workers.bigint_input(0, branch)[2]
    log_d = max(0, d.bit_length() - 1)
    mults = [jnp.asarray(jbig_from_int((1 << j) * q, 5)) for j in range(log_d - 1, -1, -1)] or [
        jnp.asarray(jbig_from_int(q, 5))]
    q_bits = q.bit_length() if branch == "narrow" else None
    fn = jax.jit(jax.shard_map(
        lambda x: _psum_bigint(x[0], "residue", 5, mults, q_bits),
        mesh=jmake_mesh(d, residue=d), in_specs=P("residue"), out_specs=P(), check_vma=False))
    return np.asarray(fn(jnp.asarray(parts.astype(np.uint32))))


@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("branch", BRANCHES)
def test_psum_bigint_matches_jax(d, branch):
    mesh = LocalMesh(d, 1, "cpu")
    q = workers.bigint_input(0, branch)[2]
    parts = [workers.bigint_input(s, branch)[0] for s in mesh.shards]
    q_bits = q.bit_length() if branch == "narrow" else None
    got = psum_bigint(mesh, parts, "residue", 5, q_multiples(q, 5, d, "cpu"), q_bits)
    want = _jax_psum_bigint(d, branch)
    for s in range(d):
        np.testing.assert_array_equal(got[s].numpy(), want.astype(np.int64))
    total = [sum(workers.bigint_input(s, branch)[1][c] for s in range(d)) % q
             for c in range(1 if branch == "allreduce" else 8)]
    assert [_limbs_to_int(v) for v in got[0].reshape(-1, 5).tolist()] == total


def test_shard_unshard_round_trip():
    mesh = LocalMesh(2, 4, "cpu")
    full = torch.arange(8 * 3 * 4 * 8, dtype=torch.int64).reshape(8, 3, 4, 8)
    for spec in (("batch", None, "residue", None), (None, None, None, "residue"),
                 ("residue", None, None, "batch")):
        parts = shard(mesh, full, spec)
        assert len(parts) == mesh.size
        assert torch.equal(unshard(mesh, parts, spec), full)
    # a replicated axis shares one tensor between its shards
    parts = shard(mesh, full, (None, None, "residue", None))
    assert parts[0] is parts[3] and parts[4] is parts[7] and parts[0] is not parts[4]
    with pytest.raises(ValueError):
        shard(mesh, full, (None, "residue", None, None))  # 3 rows over 2 shards


def test_local_mesh_names_its_device():
    """No default device: a mesh built without one must not run on the CPU
    unasked."""
    with pytest.raises(TypeError):
        LocalMesh(2, 2)
    assert LocalMesh(2, 2, "cpu").device == torch.device("cpu")
