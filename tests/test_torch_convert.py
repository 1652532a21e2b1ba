"""Reference-format checkpoints through the port's loader
(centroids_reid_tpu_torch/inference/api.py, models/convert.py) and the JAX
package's, with the functional torch oracle (tests/torch_oracle.py) as a
third witness. fp32 on the CPU: rtol 1e-4 and an absolute floor of 1e-4 of
the embedding scale (conv/reduction order only)."""

import numpy as np
import pytest
import torch

from centroids_reid_tpu.config import get_default_cfg
from test_torch_model import _close, _jax_embed, _x, small_archs  # noqa: F401
from torch_oracle import make_reference_state_dict, reid_embed_from_state_dict


def test_reference_checkpoint_through_both_loaders(tmp_path):
    """A reference-format checkpoint (backbone.* with downsample.0/.1,
    bn.* BNNeck, fc_query, center_loss) loads through the port's
    ``load_inference_model`` and the JAX package's; both embed as the
    functional oracle does on the raw state dict."""
    from centroids_reid_tpu.inference import api as japi
    from centroids_reid_tpu_torch.inference import load_inference_model

    sd = make_reference_state_dict(layers=(1, 1, 1, 1), num_classes=4,
                                   feat_dim=2048, seed=3)
    path = str(tmp_path / "reference.ckpt")
    torch.save({"state_dict": {k: torch.from_numpy(np.asarray(v))
                               for k, v in sd.items()}}, path)
    cfg = get_default_cfg()
    cfg.MODEL.NAME = "t_bottleneck"
    cfg.USE_MIXED_PRECISION = False
    cfg.INPUT.SIZE_TEST = [64, 32]
    cfg.MODEL.PRETRAIN_PATH = path

    x = _x(2, seed=6)
    oracle, _ = reid_embed_from_state_dict(x.transpose(0, 3, 1, 2), sd,
                                           layers=(1, 1, 1, 1))
    model = load_inference_model(cfg, "cpu")
    with torch.no_grad():
        got = model.embed(torch.from_numpy(x).permute(0, 3, 1, 2))
    jmodel, params, stats = japi.load_inference_model(cfg)
    ref = _jax_embed(jmodel, params, stats, x)
    _close(got.numpy(), oracle.numpy())
    _close(ref, oracle.numpy())


def test_loader_rejects_what_it_cannot_load(tmp_path):
    from centroids_reid_tpu_torch.inference import load_inference_model

    cfg = get_default_cfg()
    with pytest.raises(ValueError, match="PRETRAIN_PATH"):
        load_inference_model(cfg, "cpu")
    cfg.MODEL.PRETRAIN_PATH = str(tmp_path)   # neither state.pt nor orbax
    with pytest.raises(FileNotFoundError, match="orbax"):
        load_inference_model(cfg, "cpu")
