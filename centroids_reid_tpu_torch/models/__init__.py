from .baseline import ReidModel, create_model, init_model
from .convert import (
    from_jax_opt_state,
    from_jax_params,
    from_jax_train_state,
    full_state_dict,
    load_converted,
)
from .resnet import backbone_emb_size, build_backbone

__all__ = [
    "ReidModel",
    "backbone_emb_size",
    "build_backbone",
    "create_model",
    "from_jax_opt_state",
    "from_jax_params",
    "from_jax_train_state",
    "full_state_dict",
    "init_model",
    "load_converted",
]
