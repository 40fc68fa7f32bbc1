from . import post_processing
from .bbox import box_ops, coders

__all__ = ["box_ops", "coders", "post_processing"]
