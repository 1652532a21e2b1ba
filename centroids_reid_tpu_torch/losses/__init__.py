from .centroid import ctl_centroid_loss
from .classification import (
    center_loss,
    cross_entropy_label_smooth,
    init_centers,
)
from .distances import (
    cosine_dist,
    cosine_sim,
    euclidean_dist,
    get_dist_func,
    l2_normalize,
    squared_euclidean_dist,
)
from .triplet import batch_hard_mine, triplet_loss

__all__ = ["batch_hard_mine", "center_loss", "cosine_dist", "cosine_sim",
           "cross_entropy_label_smooth", "ctl_centroid_loss",
           "euclidean_dist", "get_dist_func", "init_centers",
           "l2_normalize", "squared_euclidean_dist", "triplet_loss"]
