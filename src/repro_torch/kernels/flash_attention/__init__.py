from .decode_kernel import flash_decode, flash_decode_ref
from .ops import attention
from .ref import attention_ref

__all__ = ["attention", "attention_ref", "flash_decode", "flash_decode_ref"]
