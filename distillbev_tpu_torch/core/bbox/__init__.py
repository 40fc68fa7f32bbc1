from . import box_ops, coders

__all__ = ["box_ops", "coders"]
