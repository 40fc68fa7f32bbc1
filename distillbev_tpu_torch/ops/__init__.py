from .bev_pool import bev_pool_batched
from .ms_deform_attn import ms_deform_attn
from .scatter_rows import (scatter_add_rows_batched,
                           scatter_add_rows_batched_plain,
                           scatter_add_rows_expand,
                           scatter_add_rows_expand_plain)

__all__ = ["bev_pool_batched", "ms_deform_attn", "scatter_add_rows_batched",
           "scatter_add_rows_batched_plain", "scatter_add_rows_expand",
           "scatter_add_rows_expand_plain"]
