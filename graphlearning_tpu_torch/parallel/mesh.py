"""The node mesh of the distribution layer, on ``torch.distributed``.

Counterpart of ``graphlearning_tpu/parallel/mesh.py``.  In the JAX package
one process holds every device of a mesh and GSPMD places the
collectives; here each rank is a process with one device, and the
collectives are explicit calls on the :class:`Mesh`: ``all_reduce`` (the
dot products and norms of the solvers), ``all_gather`` (the ELL route's X
and the final gather) and the ring exchanges (the band route's halo, the
ring SpMM).  Graphs are 1-D row-partitioned over the ``"nodes"`` axis.
A second axis (``"batch"``) replicates: the world of ``Pn * Pb`` ranks is
a grid of shape ``(Pn, Pb)``, rank r at ``(r // Pb, r % Pb)`` as JAX's
``np.asarray(devices).reshape(Pn, Pb)``, and each batch index holds its
own node group (``torch.distributed.new_group``), over which the
collectives run.  Each of the ``Pb`` replicas computes the same fit, as
the JAX package's ``node_sharding`` replicates over ``"batch"``.

With no process group initialized, :func:`make_mesh` gives a world-size-1
mesh whose collectives are the identity.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from graphlearning_tpu_torch import config

_REDUCE_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


class Mesh:
    """This rank's view of a mesh: the process group of its node axis
    (None at a node-axis size of 1), ``size`` ranks along the node axis,
    this rank's index there (``rank``), the axis names with their sizes
    (``shape``) and this rank's ``device``.  ``peers`` lists the global
    ranks of the node group in node order (None: the ranks themselves)."""

    def __init__(self, group, size: int, rank: int, device,
                 axis_names=("nodes",), node_axis: str = "nodes",
                 sizes=None, peers=None):
        if node_axis not in axis_names:
            raise ValueError(f"node axis {node_axis!r} not in mesh axes "
                             f"{tuple(axis_names)}")
        self.group = group
        self.size = int(size)
        self.rank = int(rank)
        self.device = torch.device(device)
        self.axis_names = tuple(axis_names)
        self.node_axis = node_axis
        if sizes is None:
            sizes = [self.size if a == node_axis else 1
                     for a in self.axis_names]
        self._sizes = tuple(int(s) for s in sizes)
        self.peers = None if peers is None else [int(p) for p in peers]

    @classmethod
    def from_config(cls, cfg) -> "Mesh":
        """The mesh of a :class:`config.GLTConfig`: ``mesh_shape`` over
        ``mesh_axes`` (None: the world along the first axis)."""
        return _grid_mesh(cfg.mesh_shape, cfg.mesh_axes, cfg.node_axis,
                          cfg.devices)

    @property
    def shape(self) -> dict:
        """Ranks along each axis, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self._sizes))

    def __repr__(self):
        return (f"Mesh(shape={self.shape}, rank={self.rank}, "
                f"device={self.device})")

    # -- collectives (the identity without a group) ---------------------------

    def all_reduce(self, t, op: str = "sum"):
        """``t`` summed (``op="sum"``), maximized (``"max"``) or minimized
        (``"min"``) over the ranks; a new tensor."""
        if self.group is None:
            return t
        out = t.detach().clone().contiguous()
        dist.all_reduce(out, op=getattr(dist.ReduceOp, _REDUCE_OPS[op]),
                        group=self.group)
        return out

    def all_gather(self, t):
        """The ranks' ``t`` (equal shapes) stacked along dim 0 in rank
        order."""
        if self.group is None:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim=0)

    def _exchange(self, sends, recvs):
        """Post ``(tensor, peer, tag)`` sends and receives in one batch
        and wait for them all; ``peer`` is a node-axis index, posted to
        its global rank."""
        glob = (lambda p: p) if self.peers is None else self.peers.__getitem__
        ops = [dist.P2POp(dist.isend, t, glob(peer), self.group, tag)
               for t, peer, tag in sends]
        ops += [dist.P2POp(dist.irecv, t, glob(peer), self.group, tag)
                for t, peer, tag in recvs]
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    def halo(self, X, H: int):
        """The single-hop halo of this rank's rows ``X``: ``(left,
        right)``, rank p-1's last ``H`` rows and rank p+1's first ``H``,
        wrapping around the ring as ``lax.ppermute`` does.  At world size
        1 the wrap is to the rank itself: a local slice."""
        if self.size == 1:
            return X[-H:], X[:H]
        p, P = self.rank, self.size
        tail, head = X[-H:].contiguous(), X[:H].contiguous()
        left, right = torch.empty_like(tail), torch.empty_like(head)
        self._exchange([(tail, (p + 1) % P, 1), (head, (p - 1) % P, 2)],
                       [(left, (p - 1) % P, 1), (right, (p + 1) % P, 2)])
        return left, right

    def ring_shift(self, X):
        """Rank p+1's ``X`` (equal shapes), this rank's going to p-1."""
        if self.size == 1:
            return X
        p, P = self.rank, self.size
        X = X.contiguous()
        out = torch.empty_like(X)
        self._exchange([(X, (p - 1) % P, 3)], [(out, (p + 1) % P, 3)])
        return out


def _rank_device(devices, rank: int) -> torch.device:
    """This rank's device: ``devices`` (or ``devices[rank]``), else the
    default device, on CUDA the card ``LOCAL_RANK`` (or ``rank`` modulo
    the card count) unless the default names one."""
    if isinstance(devices, (list, tuple)):
        devices = devices[rank]
    if devices is not None:
        return config.device(devices)
    dev = config.device(None)
    pinned = config._default_device
    if dev.type == "cuda" and (pinned is None or pinned.index is None):
        local = os.environ.get("LOCAL_RANK")
        idx = (int(local) if local is not None
               else rank % torch.cuda.device_count())
        dev = torch.device("cuda", idx)
    return dev


# The node groups of each grid, made once a world: new_group is a
# collective that every rank enters in the same order.  The world's group
# object is kept beside its groups so that its id is not reused.
_NODE_GROUPS: dict = {}


def _node_groups(world, shape, node_dim):
    """``(rows, groups)``: the ranks of the grid ``shape`` grouped along
    axis ``node_dim`` (each row the global ranks of one node group, in
    node order) and each row's process group, made once a world."""
    grid = np.arange(int(np.prod(shape))).reshape(shape)
    rows = np.moveaxis(grid, node_dim, -1).reshape(-1, shape[node_dim])
    key = (id(world), tuple(shape), node_dim)
    if key not in _NODE_GROUPS:
        groups = [dist.new_group(ranks=[int(r) for r in row])
                  for row in rows]
        _NODE_GROUPS[key] = (world, groups)
    return rows, _NODE_GROUPS[key][1]


def _grid_mesh(shape, axis_names, node_axis, devices) -> Mesh:
    """This rank's :class:`Mesh` on the grid ``shape`` (None: the world
    along the first axis) over the initialized process group (world size 1
    without one): ranks in row-major order, as JAX's ``reshape`` of the
    device list, the node group the ranks that differ only along
    ``node_axis``."""
    axis_names = tuple(axis_names)
    world_group = dist.group.WORLD if dist.is_initialized() else None
    world = dist.get_world_size() if world_group is not None else 1
    grank = dist.get_rank() if world_group is not None else 0
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh_shape {shape} does not match mesh_axes "
                         f"{axis_names}")
    if node_axis not in axis_names:
        raise ValueError(f"node axis {node_axis!r} not in mesh axes "
                         f"{axis_names}")
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} has {int(np.prod(shape))} "
                         f"ranks but the process group has {world}")
    node_dim = axis_names.index(node_axis)
    size = shape[node_dim]
    device = _rank_device(devices, grank)
    if size == world:                  # one node group: the world itself
        return Mesh(world_group, size, grank, device, axis_names,
                    node_axis, sizes=shape)
    if size == 1:                      # a replica alone: no collectives
        return Mesh(None, 1, 0, device, axis_names, node_axis, sizes=shape)
    rows, groups = _node_groups(world_group, shape, node_dim)
    row = int(np.nonzero(rows == grank)[0][0])
    rank = int(np.nonzero(rows[row] == grank)[0][0])
    return Mesh(groups[row], size, rank, device, axis_names, node_axis,
                sizes=shape, peers=rows[row])


def make_mesh(n_nodes_axis: int | None = None, batch_axis: int = 1,
              devices=None) -> Mesh:
    """The ``(n_nodes_axis, batch_axis)`` mesh with axes ("nodes",
    "batch") over the initialized process group (world size 1 without
    one): ``n_nodes_axis`` (None: the world size over ``batch_axis``)
    times ``batch_axis`` must be the world size.  Rank r sits at ``(r //
    batch_axis, r % batch_axis)``; the ranks of one batch index form the
    node group its fits run on."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    batch_axis = int(batch_axis)
    if n_nodes_axis is None:
        n_nodes_axis = world // batch_axis
    if int(n_nodes_axis) * batch_axis != world:
        raise ValueError(f"n_nodes_axis={n_nodes_axis} x batch_axis="
                         f"{batch_axis} but the process group has {world} "
                         "ranks")
    return _grid_mesh((int(n_nodes_axis), batch_axis), ("nodes", "batch"),
                      "nodes", devices)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a per-node array lies on a mesh: its leading axis split over
    the node axis (``rows``), or whole on every rank."""

    mesh: Mesh
    rows: bool
    ndim: int = 1


def node_sharding(mesh: Mesh, ndim: int = 1) -> Sharding:
    """Shard the leading (node) axis; replicate the rest."""
    return Sharding(mesh, True, ndim)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, False)


def _backend(device) -> str:
    dev = torch.device(device) if device is not None else (
        config._default_device)
    if dev is None:
        return "nccl" if torch.cuda.is_available() else "gloo"
    return "nccl" if dev.type == "cuda" else "gloo"


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, device=None):
    """Join the process group (``torch.distributed.init_process_group``):
    rendezvous at ``coordinator_address`` ("host:port", taken as
    ``tcp://``; a ``tcp://`` or ``file://`` URL as it is), else at
    ``MASTER_ADDR`` / ``MASTER_PORT`` (``env://``), with ``num_processes``
    ranks (else ``WORLD_SIZE``) as rank ``process_id`` (else ``RANK``).
    NCCL when this rank runs on CUDA (``device``, else the default
    device), gloo on the CPU.  A no-op when a group is initialized or
    nothing names a rendezvous."""
    if dist.is_initialized():
        return
    if coordinator_address is None:
        if "MASTER_ADDR" not in os.environ:
            return
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    world = int(num_processes if num_processes is not None
                else os.environ.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None
               else os.environ.get("RANK", 0))
    dist.init_process_group(_backend(device), init_method=init_method,
                            world_size=world, rank=rank)
