from .transforms import (
    available_decoder,
    decode_and_resize_bytes,
    ingest_blobs,
    normalize_batch,
)

__all__ = [
    "available_decoder",
    "decode_and_resize_bytes",
    "ingest_blobs",
    "normalize_batch",
]
