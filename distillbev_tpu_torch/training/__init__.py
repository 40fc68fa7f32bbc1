from . import optim, schedules
from .train_step import (BEVFormerBatch, DistillBatch, gravity_centered,
                         make_bevformer_train_step, make_distill_train_step)

__all__ = ["optim", "schedules", "BEVFormerBatch", "DistillBatch",
           "gravity_centered", "make_bevformer_train_step",
           "make_distill_train_step"]
