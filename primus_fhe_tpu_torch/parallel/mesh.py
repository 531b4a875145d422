"""The device mesh and its collectives (port of ``primus_fhe_tpu/parallel/mesh.py``
and of the ``shard_map`` collectives its callers use).

A mesh has the named axes ``("residue", "batch")`` laid out as the JAX
``make_mesh`` lays out devices: shard ``(r, b)`` is device index ``r * batch + b``.  Two
backends share one interface:

- :class:`LocalMesh` holds every shard in one process on one device (the
  counterpart of JAX's ``--xla_force_host_platform_device_count``): the
  collectives stack, sum and slice across the shard list, and kernels still
  launch once per shard at the per-shard shape.  One card runs the sharded
  programs this way: NCCL refuses two ranks on one device.
- :class:`ProcessGroupMesh` holds one shard per rank of ``torch.distributed``
  (gloo on the CPU, NCCL on cards), with one subgroup per axis line; the
  XOR-partner swap is a ``batch_isend_irecv`` and the tiled ``all_to_all`` an
  ``all_to_all_single``.

Sharded code is written once, as bulk-synchronous steps over
``mesh.shards`` (the device indices this process holds) and lists of
tensors, one per held shard: a list of one under a process group, of
``residue * batch`` on a local mesh.  Each collective takes such a list and
names one axis; it acts within every line of shards that differ only on that
axis, the members ordered by their index on it (the axis index).
``all_to_all(xs, axis, split_dim, concat_dim)`` is ``jax.lax.all_to_all(...,
tiled=True)``: each member splits ``split_dim`` into one chunk per member,
sends chunk ``j`` to member ``j``, and concatenates what it receives along
``concat_dim`` in sender order.

No collective takes unsigned words: neither NCCL nor gloo sums uint32, so the
callers carry u32 lanes in int64 (twice the JAX wire bytes).

:func:`shard` and :func:`unshard` split a full tensor into shard tensors and
assemble it back by a ``PartitionSpec``-like tuple (an axis name or
``None`` per dimension); a dimension the spec leaves ``None`` is replicated.
"""

from __future__ import annotations

import torch

AXES = ("residue", "batch")


class _Mesh:
    """Geometry shared by both backends; the collectives are theirs."""

    def __init__(self, residue: int, batch: int, device):
        if residue < 1 or batch < 1:
            raise ValueError(f"mesh axes must be positive, got residue={residue} batch={batch}")
        self.shape = {"residue": int(residue), "batch": int(batch)}
        self.size = self.shape["residue"] * self.shape["batch"]
        self.device = torch.device(device)

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def axis_index(self, shard: int, axis: str) -> int:
        """Index of device ``shard`` on ``axis``."""
        r, b = divmod(shard, self.shape["batch"])
        return r if axis == "residue" else b

    def line(self, shard: int, axis: str) -> list[int]:
        """The devices that differ from ``shard`` only on ``axis``, in axis
        order."""
        if axis not in AXES:
            raise ValueError(f"axis must be one of {AXES}, got {axis!r}")
        r, b = divmod(shard, self.shape["batch"])
        if axis == "residue":
            return [i * self.shape["batch"] + b for i in range(self.shape["residue"])]
        return [r * self.shape["batch"] + j for j in range(self.shape["batch"])]

    def __repr__(self) -> str:
        return f"{type(self).__name__}(residue={self.shape['residue']}, " \
               f"batch={self.shape['batch']}, device={self.device})"


class LocalMesh(_Mesh):
    """Every shard of a ``residue x batch`` mesh in this process, on one
    ``device``."""

    def __init__(self, residue: int, batch: int, device):
        super().__init__(residue, batch, device)
        self.shards = list(range(self.size))

    def _lines(self, xs, axis):
        """``(line members' positions in xs, their tensors)`` per line."""
        if len(xs) != self.size:
            raise ValueError(f"expected {self.size} shard tensors, got {len(xs)}")
        seen = set()
        for s in self.shards:
            members = self.line(s, axis)
            if members[0] not in seen:
                seen.add(members[0])
                yield members, [xs[m] for m in members]

    def psum(self, xs, axis: str):
        out = [None] * self.size
        for members, ts in self._lines(xs, axis):
            total = torch.stack(ts).sum(dim=0)
            for m in members:
                out[m] = total
        return out

    def psum_scatter(self, xs, axis: str, dim: int):
        out = [None] * self.size
        for members, ts in self._lines(xs, axis):
            parts = torch.stack(ts).sum(dim=0).chunk(len(members), dim=dim)
            for m, part in zip(members, parts):
                out[m] = part.contiguous()
        return out

    def all_gather(self, xs, axis: str, dim: int):
        out = [None] * self.size
        for members, ts in self._lines(xs, axis):
            full = torch.cat(ts, dim=dim)
            for m in members:
                out[m] = full
        return out

    def ppermute(self, xs, axis: str, perm):
        out = [None] * self.size
        for members, ts in self._lines(xs, axis):
            got = {dst: ts[src] for src, dst in perm}
            for i, m in enumerate(members):
                out[m] = got[i] if i in got else torch.zeros_like(ts[i])
        return out

    def all_to_all(self, xs, axis: str, split_dim: int, concat_dim: int):
        out = [None] * self.size
        for members, ts in self._lines(xs, axis):
            chunks = [t.chunk(len(members), dim=split_dim) for t in ts]
            for j, m in enumerate(members):
                out[m] = torch.cat([c[j] for c in chunks], dim=concat_dim)
        return out

    def gather_shards(self, xs):
        return list(xs)


class ProcessGroupMesh(_Mesh):
    """One shard per rank of the default ``torch.distributed`` process group
    (which must be initialised, with world size ``residue * batch``); rank
    ``r * batch + b`` holds shard ``(r, b)`` on ``device``.  Builds one
    subgroup per line of each axis (every rank takes part in each
    ``new_group`` call, in the same order)."""

    def __init__(self, residue: int, batch: int, device):
        import torch.distributed as dist

        super().__init__(residue, batch, device)
        if not dist.is_initialized():
            raise RuntimeError("ProcessGroupMesh needs an initialised torch.distributed group")
        if dist.get_world_size() != self.size:
            raise ValueError(f"world size {dist.get_world_size()} != residue*batch = {self.size}")
        self.rank = dist.get_rank()
        self.shards = [self.rank]
        self._groups = {}
        for axis in AXES:
            for s in range(self.size):
                members = self.line(s, axis)
                if members[0] != s:
                    continue
                group = dist.new_group(members)
                if self.rank in members:
                    self._groups[axis] = group

    def _one(self, xs):
        if len(xs) != 1:
            raise ValueError(f"a process holds one shard, got {len(xs)} tensors")
        return xs[0]

    def psum(self, xs, axis: str):
        import torch.distributed as dist

        total = self._one(xs).clone()
        dist.all_reduce(total, group=self._groups[axis])
        return [total]

    def psum_scatter(self, xs, axis: str, dim: int):
        import torch.distributed as dist

        x = self._one(xs).movedim(dim, 0).contiguous()
        g = self.axis_size(axis)
        out = torch.empty((x.shape[0] // g,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, x, group=self._groups[axis])
        return [out.movedim(0, dim).contiguous()]

    def all_gather(self, xs, axis: str, dim: int):
        import torch.distributed as dist

        x = self._one(xs).contiguous()
        parts = [torch.empty_like(x) for _ in range(self.axis_size(axis))]
        dist.all_gather(parts, x, group=self._groups[axis])
        return [torch.cat(parts, dim=dim)]

    def ppermute(self, xs, axis: str, perm):
        import torch.distributed as dist

        x = self._one(xs).contiguous()
        members = self.line(self.rank, axis)
        me = members.index(self.rank)
        out, ops = None, []
        for src, dst in perm:
            if src == me and dst == me:
                out = x.clone()
            elif src == me:
                ops.append(dist.P2POp(dist.isend, x, members[dst]))
            elif dst == me:
                out = torch.empty_like(x)
                ops.append(dist.P2POp(dist.irecv, out, members[src]))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return [out if out is not None else torch.zeros_like(x)]

    def all_to_all(self, xs, axis: str, split_dim: int, concat_dim: int):
        import torch.distributed as dist

        g = self.axis_size(axis)
        x = self._one(xs).movedim(split_dim, 0).contiguous()  # chunk j: rows j*c .. (j+1)*c
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self._groups[axis])
        return [torch.cat([c.movedim(0, split_dim) for c in out.chunk(g, dim=0)], dim=concat_dim)]

    def gather_shards(self, xs):
        """Every device's shard (device order), gathered over all ranks."""
        import torch.distributed as dist

        x = self._one(xs).contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x)
        return parts


def _slices(mesh, shape, spec, s):
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} does not match a tensor of {len(shape)} dims")
    out = []
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        size = mesh.axis_size(axis)
        if shape[dim] % size:
            raise ValueError(f"dim {dim} of size {shape[dim]} does not split over {axis}={size}")
        part = shape[dim] // size
        out.append((dim, mesh.axis_index(s, axis) * part, part))
    return tuple(out)


def shard(mesh, full: torch.Tensor, spec) -> list:
    """The shard tensors of ``full`` for the shards this process holds, on
    ``mesh.device``, contiguous; shards whose slices coincide (a replicated
    axis) share one tensor."""
    made: dict = {}
    out = []
    for s in mesh.shards:
        key = _slices(mesh, full.shape, spec, s)
        if key not in made:
            part = full
            for dim, start, length in key:
                part = part.narrow(dim, start, length)
            made[key] = part.to(mesh.device).contiguous()
        out.append(made[key])
    return out


def unshard(mesh, shards, spec) -> torch.Tensor:
    """The full tensor from every device's shard (gathered over the ranks on
    a process-group mesh); shards along a replicated axis must agree."""
    parts = mesh.gather_shards(shards)
    shape = list(parts[0].shape)
    for dim, axis in enumerate(spec):
        if axis is not None:
            shape[dim] *= mesh.axis_size(axis)
    full = torch.empty(shape, dtype=parts[0].dtype, device=parts[0].device)
    for s, part in enumerate(parts):
        view = full
        for dim, start, length in _slices(mesh, shape, spec, s):
            view = view.narrow(dim, start, length)
        view.copy_(part)
    return full
