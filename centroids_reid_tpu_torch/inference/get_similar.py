"""Top-k retrieval of gallery entries for a folder of query images, on the
card.

The flags of ``inference/get_similar.py`` plus ``--device``; writes
``results.npy`` (dict: query path -> {indices, paths, distances}),
``query_embeddings.npy`` and ``query_paths.npy`` under ``OUTPUT_DIR``. The
ranking is the exact fp32 top-k (hierarchical, on the K3 kernel) when
``TPU.USE_PALLAS_RETRIEVAL`` and ``--topk`` > 0, else the full distance
matrix and a stable argsort. ``TPU.RERANK True`` re-ranks with k-reciprocal
encoding: each query's top-``TPU.RERANK_WINDOW`` window when that is > 0
(and ``--topk`` > 0), else the full distance matrix.

    python -m centroids_reid_tpu_torch.inference.get_similar \\
        --config_file configs/256_resnet50.yml --gallery_data /out \\
        MODEL.PRETRAIN_PATH model.ckpt DATASETS.ROOT_DIR /queries \\
        OUTPUT_DIR /results
"""

import argparse
import logging
import os
from typing import Optional, Sequence

from ..config import get_default_cfg
from .api import find_similar


def main(argv: Optional[Sequence[str]] = None):
    logging.basicConfig(level=os.environ.get("LOGLEVEL", "INFO"))
    parser = argparse.ArgumentParser(
        description="Find top-k most similar gallery entries per query image")
    parser.add_argument("--config_file", default="", type=str)
    parser.add_argument("--images-in-subfolders", action="store_true")
    parser.add_argument("--print_freq", type=int, default=10)
    parser.add_argument(
        "--gallery_data", type=str,
        help="path to root where previously prepared embeddings and paths "
             "were saved")
    parser.add_argument("--normalize_features", action="store_true")
    parser.add_argument("--topk", type=int, default=100,
                        help="top k similar ids per query; 0 returns all")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: the card)")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    cfg = get_default_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts)
    return find_similar(cfg, gallery_data=args.gallery_data,
                        images_in_subfolders=args.images_in_subfolders,
                        normalize_features=args.normalize_features,
                        topk=args.topk, print_freq=args.print_freq,
                        device=args.device)


if __name__ == "__main__":
    main()
