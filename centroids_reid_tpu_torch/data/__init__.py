from .datasets import Record, ReidDataset, init_dataset
from .loader import EvalLoader, ImageStore, TrainLoader
from .sampler import EpochPlan, build_epoch_plan, max_steps_bound
from .transforms import (
    AugmentParams,
    apply_augment,
    augment_batch,
    available_decoder,
    decode_and_pack_yuv420_bytes,
    decode_and_resize_bytes,
    draw_augment_params,
    ingest_blobs,
    load_and_pack_yuv420,
    load_and_resize,
    normalize_batch,
    normalize_yuv420_batch,
    yuv420_to_rgb,
)

__all__ = [
    "AugmentParams",
    "EpochPlan",
    "EvalLoader",
    "ImageStore",
    "Record",
    "ReidDataset",
    "TrainLoader",
    "apply_augment",
    "augment_batch",
    "available_decoder",
    "build_epoch_plan",
    "decode_and_pack_yuv420_bytes",
    "decode_and_resize_bytes",
    "draw_augment_params",
    "ingest_blobs",
    "init_dataset",
    "load_and_pack_yuv420",
    "load_and_resize",
    "max_steps_bound",
    "normalize_batch",
    "normalize_yuv420_batch",
    "yuv420_to_rgb",
]
