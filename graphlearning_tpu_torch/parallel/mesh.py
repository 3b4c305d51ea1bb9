"""The node mesh of the distribution layer, on ``torch.distributed``.

Counterpart of ``graphlearning_tpu/parallel/mesh.py``.  In the JAX package
one process holds every device of a mesh and GSPMD places the
collectives; here each rank is a process with one device, and the
collectives are explicit calls on the :class:`Mesh`: ``all_reduce`` (the
dot products and norms of the solvers), ``all_gather`` (the ELL route's X
and the final gather) and the ring exchanges (the band route's halo, the
ring SpMM).  Graphs are 1-D row-partitioned over the ``"nodes"`` axis;
a ``batch`` axis (independent trials over a second axis) comes with P15c.

With no process group initialized, :func:`make_mesh` gives a world-size-1
mesh whose collectives are the identity.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from graphlearning_tpu_torch import config

_REDUCE_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


class Mesh:
    """This rank's view of a 1-D node mesh: the process group (None at
    world size 1 without one), ``size`` ranks, this ``rank``, the axis
    names with the node axis first, and this rank's ``device``."""

    def __init__(self, group, size: int, rank: int, device,
                 axis_names=("nodes",), node_axis: str = "nodes"):
        if node_axis not in axis_names:
            raise ValueError(f"node axis {node_axis!r} not in mesh axes "
                             f"{tuple(axis_names)}")
        self.group = group
        self.size = int(size)
        self.rank = int(rank)
        self.device = torch.device(device)
        self.axis_names = tuple(axis_names)
        self.node_axis = node_axis

    @classmethod
    def from_config(cls, cfg) -> "Mesh":
        shape = cfg.mesh_shape
        if shape is not None and len(shape) > 1 and any(
                int(s) != 1 for s in shape[1:]):
            raise NotImplementedError(
                f"mesh_shape {tuple(shape)}: axes beyond the node axis "
                "come with P15c")
        mesh = make_mesh(None if shape is None else int(shape[0]),
                         devices=cfg.devices)
        return cls(mesh.group, mesh.size, mesh.rank, mesh.device,
                   axis_names=cfg.mesh_axes, node_axis=cfg.node_axis)

    @property
    def shape(self) -> dict:
        """Ranks along each axis, as ``jax.sharding.Mesh.shape``."""
        return {a: (self.size if a == self.node_axis else 1)
                for a in self.axis_names}

    def __repr__(self):
        return (f"Mesh(size={self.size}, rank={self.rank}, "
                f"device={self.device}, axes={self.axis_names})")

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
        and wait for them all."""
        ops = [dist.P2POp(dist.isend, t, peer, self.group, tag)
               for t, peer, tag in sends]
        ops += [dist.P2POp(dist.irecv, t, peer, self.group, tag)
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


def make_mesh(n_nodes_axis: int | None = None, batch_axis: int = 1,
              devices=None) -> Mesh:
    """The node mesh over the initialized process group (world size 1
    without one): ``n_nodes_axis`` must be the world size.  A
    ``batch_axis`` above 1 comes with P15c."""
    if batch_axis != 1:
        raise NotImplementedError("a batch axis of the mesh comes with P15c")
    group = dist.group.WORLD if dist.is_initialized() else None
    size = dist.get_world_size() if group is not None else 1
    rank = dist.get_rank() if group is not None else 0
    if n_nodes_axis is not None and int(n_nodes_axis) != size:
        raise ValueError(f"n_nodes_axis={n_nodes_axis} but the process "
                         f"group has {size} ranks")
    return Mesh(group, size, rank, _rank_device(devices, rank),
                axis_names=("nodes", "batch"))


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
