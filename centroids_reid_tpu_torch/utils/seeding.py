"""Deterministic seeding (counterpart of
``centroids_reid_tpu/utils/seeding.py``): Python's ``random``, numpy and
torch's default generators, and ``PYTHONHASHSEED`` for child processes."""

import os
import random

import numpy as np
import torch


def seed_everything(seed: int) -> int:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    return seed
