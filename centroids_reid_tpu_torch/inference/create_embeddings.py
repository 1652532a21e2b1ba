"""Build a gallery embedding index from an image folder, on the card.

The flags of ``inference/create_embeddings.py`` plus ``--device``; writes
``embeddings.npy`` + ``paths.npy`` under ``OUTPUT_DIR``. With
``MODEL.USE_CENTROIDS True`` the index holds per-pid centroids, with pids
taken from the parent directory (default) or the filename
(``--pid_from filename``).

    python -m centroids_reid_tpu_torch.inference.create_embeddings \\
        --config_file configs/256_resnet50.yml \\
        MODEL.PRETRAIN_PATH model.ckpt DATASETS.ROOT_DIR /imgs OUTPUT_DIR /out
"""

import argparse
import logging
import os
from typing import Optional, Sequence

from ..config import get_default_cfg
from .api import build_embeddings


def main(argv: Optional[Sequence[str]] = None):
    logging.basicConfig(level=os.environ.get("LOGLEVEL", "INFO"))
    parser = argparse.ArgumentParser(
        description="Create embeddings for images that will serve as the "
                    "database (gallery)")
    parser.add_argument("--config_file", default="", type=str)
    parser.add_argument("--images-in-subfolders", action="store_true")
    parser.add_argument("--print_freq", type=int, default=10)
    parser.add_argument(
        "--pid_from", choices=["parent_dir", "filename"], default="parent_dir",
        help="how to derive pids for centroid grouping")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: the card)")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    cfg = get_default_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts)
    return build_embeddings(cfg, args.images_in_subfolders, args.print_freq,
                            args.pid_from, device=args.device)


if __name__ == "__main__":
    main()
