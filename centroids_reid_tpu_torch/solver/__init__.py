from .build import (
    Optimizers,
    build_optimizers,
    current_learning_rate,
    lr_for_epoch,
    set_learning_rate,
)

__all__ = ["Optimizers", "build_optimizers", "current_learning_rate",
           "lr_for_epoch", "set_learning_rate"]
