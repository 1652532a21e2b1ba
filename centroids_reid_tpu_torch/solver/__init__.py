from .build import (
    Optimizers,
    build_optimizers,
    lr_for_epoch,
    set_learning_rate,
)

__all__ = ["Optimizers", "build_optimizers", "lr_for_epoch",
           "set_learning_rate"]
