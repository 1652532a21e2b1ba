"""The offline CLIs of the port on an orbax checkpoint of the JAX package
(``MODEL.PRETRAIN_PATH`` a ``CheckpointManager`` directory), against the
JAX package's flows on the same directory, on the CPU (resnet18, 32x16
JPEGs, fp32):

* ``create_embeddings``: paths equal, embeddings within 1e-4;
* ``get_similar --topk 4``: indices and paths equal, distances within 1e-4
  of the squared norms' scale (as ``tests/test_torch_cli.py``);
* ``export_model`` (the CPU program): the artifact embeds as the live
  model loaded from the checkpoint, L2-normalised, within 1e-5 (the
  program traces the live model's ops).
"""

import numpy as np
import torch

from centroids_reid_tpu.config import get_default_cfg as jax_default_cfg
from test_torch_cli import _cfg, _write_folder
from test_torch_orbax import _port_cfg, write_jax_checkpoint

_OPTS = ["MODEL.NAME", "resnet18", "MODEL.BACKBONE_EMB_SIZE", "512",
         "USE_MIXED_PRECISION", "False", "INPUT.SIZE_TEST", "[32,16]",
         "TEST.IMS_PER_BATCH", "8"]


def test_clis_take_a_jax_checkpoint(tmp_path):
    from centroids_reid_tpu.inference import api as japi
    from centroids_reid_tpu_torch.inference import (
        create_embeddings,
        export_model,
        get_similar,
        load_embedder,
        load_inference_model,
    )
    from centroids_reid_tpu_torch.inference.service import embed_query

    ckpt, _ = write_jax_checkpoint(tmp_path / "jax", 5, seed=4)
    gallery, queries = _write_folder(tmp_path)
    jout, tout = str(tmp_path / "jax_index"), str(tmp_path / "port_index")
    japi.build_embeddings(_cfg(jax_default_cfg, ckpt, gallery, jout),
                          images_in_subfolders=True)
    create_embeddings.main(["--images-in-subfolders", "--device", "cpu",
                            *_OPTS, "MODEL.PRETRAIN_PATH", ckpt,
                            "DATASETS.ROOT_DIR", gallery, "OUTPUT_DIR",
                            tout])
    np.testing.assert_array_equal(np.load(f"{tout}/paths.npy"),
                                  np.load(f"{jout}/paths.npy"))
    g = np.load(f"{jout}/embeddings.npy")
    np.testing.assert_allclose(np.load(f"{tout}/embeddings.npy"), g,
                               rtol=1e-4, atol=1e-4)

    jres, tres = str(tmp_path / "jres"), str(tmp_path / "tres")
    japi.find_similar(_cfg(jax_default_cfg, ckpt, queries, jres), jout,
                      images_in_subfolders=False, normalize_features=False,
                      topk=4)
    get_similar.main(["--gallery_data", jout, "--topk", "4", "--device",
                      "cpu", *_OPTS, "MODEL.PRETRAIN_PATH", ckpt,
                      "DATASETS.ROOT_DIR", queries, "OUTPUT_DIR", tres])
    ref = np.load(f"{jres}/results.npy", allow_pickle=True).item()
    got = np.load(f"{tres}/results.npy", allow_pickle=True).item()
    q = np.load(f"{jres}/query_embeddings.npy")
    scale = (q * q).sum(axis=1).max() + (g * g).sum(axis=1).max()
    assert list(got) == list(ref) and len(ref) == 7
    for qp in ref:
        np.testing.assert_array_equal(got[qp]["indices"], ref[qp]["indices"])
        np.testing.assert_array_equal(got[qp]["paths"], ref[qp]["paths"])
        np.testing.assert_allclose(got[qp]["distances"],
                                   ref[qp]["distances"], rtol=0,
                                   atol=1e-4 * scale)

    artifact = str(tmp_path / "model.crt")
    export_model.main(["--output", artifact, "--platforms", "cpu",
                       "--device", "cpu", *_OPTS, "MODEL.PRETRAIN_PATH",
                       ckpt])
    imgs = np.random.RandomState(3).randint(0, 256, (3, 32, 16, 3),
                                            dtype=np.uint8)
    got = load_embedder(artifact, "cpu").embed(imgs)
    cfg = _port_cfg(ckpt)
    model = load_inference_model(cfg, "cpu")
    with torch.no_grad():
        live = embed_query(model, torch.from_numpy(imgs),
                           cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD,
                           torch.float32, True).numpy()
    np.testing.assert_allclose(got, live, rtol=0, atol=1e-5)
