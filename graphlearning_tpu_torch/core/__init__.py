"""Graph containers of graphlearning_tpu_torch."""
from graphlearning_tpu_torch.core.sparse import SparseGraph

__all__ = ["SparseGraph"]
