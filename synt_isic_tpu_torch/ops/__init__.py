from .attention import LAUNCHES, attention_reference, fused_attention
from .norms import group_norm_silu_fast

__all__ = ["LAUNCHES", "attention_reference", "fused_attention",
           "group_norm_silu_fast"]
