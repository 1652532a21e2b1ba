from .datasets import Record, ReidDataset, init_dataset
from .loader import EvalLoader, ImageStore
from .transforms import (
    available_decoder,
    decode_and_resize_bytes,
    ingest_blobs,
    load_and_resize,
    normalize_batch,
)

__all__ = [
    "EvalLoader",
    "ImageStore",
    "Record",
    "ReidDataset",
    "available_decoder",
    "decode_and_resize_bytes",
    "ingest_blobs",
    "init_dataset",
    "load_and_resize",
    "normalize_batch",
]
