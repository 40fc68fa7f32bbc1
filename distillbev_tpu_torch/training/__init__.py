from . import optim, schedules
from .train_step import (BEVFormerBatch, gravity_centered,
                         make_bevformer_train_step)

__all__ = ["optim", "schedules", "BEVFormerBatch", "gravity_centered",
           "make_bevformer_train_step"]
