from .ops import fused_edge_reduce, fused_pull, fused_push

__all__ = ["fused_pull", "fused_push", "fused_edge_reduce"]
