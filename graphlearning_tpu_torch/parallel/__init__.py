"""The distribution layer: graphs row-partitioned over a mesh of ranks
(``torch.distributed``), the sharded SpMM on the ELL rows or the
partitioned band (K1, K3 and a ring halo), and the :class:`Distributor`
that ``ssl.distribute`` fits run on."""
from graphlearning_tpu_torch.parallel.mesh import (
    make_mesh, node_sharding, replicated, initialize_distributed)
from graphlearning_tpu_torch.parallel.shard import (
    pad_graph_to,
    shard_graph,
    sharded_spmm,
    sharded_spmm_ring,
    put_features,
)
from graphlearning_tpu_torch.parallel.execute import Distributor

__all__ = [
    "make_mesh",
    "initialize_distributed",
    "node_sharding",
    "replicated",
    "pad_graph_to",
    "shard_graph",
    "sharded_spmm",
    "sharded_spmm_ring",
    "put_features",
    "Distributor",
]
