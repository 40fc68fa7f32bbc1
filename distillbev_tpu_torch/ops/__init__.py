from .bev_pool import bev_pool_batched
from .gather_rows import gather_rows, gather_rows_plain
from .ms_deform_attn import ms_deform_attn
from .scatter_rows import (scatter_add_rows, scatter_add_rows_batched,
                           scatter_add_rows_batched_plain,
                           scatter_add_rows_expand,
                           scatter_add_rows_expand_plain,
                           scatter_add_rows_plain)
from .segmented_scan import (segmented_cumsum_rows,
                             segmented_cumsum_rows_plain)

__all__ = ["bev_pool_batched", "gather_rows", "gather_rows_plain",
           "ms_deform_attn", "scatter_add_rows", "scatter_add_rows_batched",
           "scatter_add_rows_batched_plain", "scatter_add_rows_expand",
           "scatter_add_rows_expand_plain", "scatter_add_rows_plain",
           "segmented_cumsum_rows", "segmented_cumsum_rows_plain"]
