"""Export a checkpoint as a self-contained serving artifact.

The flags of ``inference/export_model.py`` plus ``--device`` (where the
checkpoint loads; default: the card). Writes one file holding a
``torch.export`` program per device type of ``--platforms`` (default
``cuda,cpu``) with the weights baked in, loadable with
``centroids_reid_tpu_torch.inference.load_embedder``:

    python -m centroids_reid_tpu_torch.inference.export_model \\
        --config_file configs/256_resnet50.yml --output model.crt \\
        MODEL.PRETRAIN_PATH model.ckpt

``--retriever --gallery_data /index`` exports the serving pipeline instead:
the embed program at a fixed batch plus the gallery rows and paths, served
by ``python -m centroids_reid_tpu_torch.inference.server --artifact`` with
no checkpoint or index on the serving host (``load_retriever``). With
``TPU.INT8_EVAL True`` the program is the int8 PTQ embed of the calibrated
``TPU.INT8_CACHE_PATH``.
"""

import argparse
import logging
import os
from typing import Optional, Sequence

from ..config import get_default_cfg
from .export import export_from_config, export_retriever_from_config


def main(argv: Optional[Sequence[str]] = None) -> dict:
    logging.basicConfig(level=os.environ.get("LOGLEVEL", "INFO"))
    parser = argparse.ArgumentParser(
        description="Export a self-contained CUDA/CPU serving artifact")
    parser.add_argument("--config_file", default="", type=str)
    parser.add_argument("--output", required=True, type=str)
    parser.add_argument(
        "--batch-size", type=int, default=None,
        help="fix the serving batch (default: symbolic, any batch size)")
    parser.add_argument(
        "--platforms", default="cuda,cpu",
        help="comma-separated device types, one program each "
             "(default: cuda,cpu)")
    parser.add_argument(
        "--no-normalize", action="store_true",
        help="skip the L2-normalize epilogue (raw BNNeck embeddings)")
    parser.add_argument(
        "--retriever", action="store_true",
        help="export the serving pipeline (embed program + gallery rows and "
             "paths): requires --gallery_data; serve it with "
             "inference.server --artifact")
    parser.add_argument(
        "--gallery_data", default="", type=str,
        help="(--retriever) dir with embeddings.npy/paths.npy from "
             "create_embeddings")
    parser.add_argument(
        "--topk", type=int, default=100,
        help="(--retriever) ranking depth")
    parser.add_argument("--device", default="cuda",
                        help="torch device the checkpoint loads on "
                             "(default: the card)")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    cfg = get_default_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts)
    platforms = tuple(p.strip() for p in args.platforms.split(",") if p)
    if args.retriever:
        if not args.gallery_data:
            raise SystemExit("--retriever requires --gallery_data")
        meta = export_retriever_from_config(
            cfg, args.gallery_data, args.output, k=args.topk,
            batch_size=args.batch_size, platforms=platforms,
            normalize=not args.no_normalize, device=args.device)
    else:
        meta = export_from_config(
            cfg, args.output, batch_size=args.batch_size,
            platforms=platforms, normalize=not args.no_normalize,
            device=args.device)
    print(f"wrote {args.output}: {meta}")
    return meta


if __name__ == "__main__":
    main()
