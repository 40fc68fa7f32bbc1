from .bev_pool import bev_pool_batched
from .scatter_rows import (scatter_add_rows_batched,
                           scatter_add_rows_batched_plain)

__all__ = ["bev_pool_batched", "scatter_add_rows_batched",
           "scatter_add_rows_batched_plain"]
