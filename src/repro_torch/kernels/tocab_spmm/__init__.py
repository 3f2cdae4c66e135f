from .ops import tocab_spmm, tocab_spmm_partials

__all__ = ["tocab_spmm", "tocab_spmm_partials"]
