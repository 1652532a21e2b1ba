from .distances import (
    cosine_dist,
    cosine_sim,
    get_dist_func,
    squared_euclidean_dist,
)

__all__ = ["cosine_dist", "cosine_sim", "get_dist_func",
           "squared_euclidean_dist"]
