"""The port stands without JAX: importing it and serving a query on the CPU,
through the bf16 path and the int8 path (PTQ embed + int8 gallery), loads
neither jax nor flax; and the service refuses what is not ported."""

import subprocess
import sys
import textwrap

import numpy as np
import pytest

from conftest import cpu_subprocess_env

_SCRIPT = textwrap.dedent("""
    import io, sys
    import numpy as np
    from PIL import Image
    import centroids_reid_tpu_torch
    from centroids_reid_tpu_torch.config import get_default_cfg
    from centroids_reid_tpu_torch.inference import RetrievalService
    from centroids_reid_tpu_torch.models import create_model
    from centroids_reid_tpu_torch.models.quantized import quantize_reid_model

    cfg = get_default_cfg()
    cfg.MODEL.NAME = "resnet18"
    cfg.INPUT.SIZE_TEST = [32, 16]
    rng = np.random.RandomState(0)
    gallery = rng.randn(40, 512).astype(np.float32)
    model = create_model(cfg)
    svc = RetrievalService(cfg, gallery, [str(i) for i in range(40)], k=3,
                           device="cpu", model=model)
    img = rng.randint(0, 256, (32, 16, 3)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG")
    d, idx, _ = svc.query_bytes([buf.getvalue()])
    assert d.shape == (1, 3) and np.isfinite(d).all(), d
    qfn = quantize_reid_model(model, [img[None]], cfg.INPUT.PIXEL_MEAN,
                              cfg.INPUT.PIXEL_STD, use_pallas=True)
    svc = RetrievalService(cfg, gallery, [str(i) for i in range(40)], k=3,
                           device="cpu", model=model, int8_qfn=qfn,
                           use_int8_gallery=True)
    d, idx, _ = svc.query_bytes([buf.getvalue()])
    assert d.shape == (1, 3) and np.isfinite(d).all(), d
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "flax"))
    assert not bad, bad
    print("OK")
""")


def test_port_imports_and_serves_without_jax():
    proc = subprocess.run([sys.executable, "-c", _SCRIPT],
                          env=cpu_subprocess_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


class _Int8EmbedStub:
    """Stands in for a QuantizedEmbed where the service is only built."""

    def to(self, device):
        return self


@pytest.mark.parametrize("option,kwargs", [
    ("mesh", {"mesh": object()}),
    ("rerank_window", {"rerank_window": 20}),
    ("TPU.FAST_DECODE", {}),
    # re-ranking stays unported on the int8 gallery too
    ("rerank_window", {"use_int8_gallery": True, "rerank_window": 20}),
    # the fast ingest is refused unless an int8 embed takes RGB instead
    ("TPU.FAST_DECODE", {"use_int8_gallery": True}),
])
def test_service_refuses_unported_options(option, kwargs):
    from centroids_reid_tpu_torch.config import get_default_cfg
    from centroids_reid_tpu_torch.inference import RetrievalService

    cfg = get_default_cfg()
    if option == "TPU.FAST_DECODE":
        cfg.TPU.FAST_DECODE = True
    with pytest.raises(NotImplementedError, match=f"{option} .*not ported"):
        RetrievalService(cfg, np.ones((4, 8), np.float32), list("abcd"),
                         device="cpu", model=object(), **kwargs)


def test_fast_decode_with_an_int8_embed_serves_rgb():
    from centroids_reid_tpu_torch.config import get_default_cfg
    from centroids_reid_tpu_torch.inference import RetrievalService

    import torch

    cfg = get_default_cfg()
    cfg.TPU.FAST_DECODE = True
    svc = RetrievalService(cfg, np.ones((4, 8), np.float32), list("abcd"),
                           device="cpu", model=torch.nn.Identity(),
                           int8_qfn=_Int8EmbedStub(), use_int8_gallery=True)
    assert svc.ingest_format == "rgb"


@pytest.mark.parametrize("kwargs,match", [
    ({"mesh": object()}, "mesh"),
    ({"exact_rescore": False, "rerank_window": 8}, "re-rank"),
])
def test_service_refuses_int8_gallery_combinations(kwargs, match):
    """The reference's guards: the int8 gallery is single-device, and its
    capacity mode keeps no full-precision rows to re-rank."""
    from centroids_reid_tpu_torch.config import get_default_cfg
    from centroids_reid_tpu_torch.inference import RetrievalService

    with pytest.raises(ValueError, match=match):
        RetrievalService(get_default_cfg(), np.ones((4, 8), np.float32),
                         list("abcd"), device="cpu", model=object(),
                         use_int8_gallery=True, **kwargs)


def test_service_refuses_empty_gallery():
    from centroids_reid_tpu_torch.config import get_default_cfg
    from centroids_reid_tpu_torch.inference import RetrievalService

    with pytest.raises(ValueError, match="empty gallery"):
        RetrievalService(get_default_cfg(), np.zeros((0, 8), np.float32), [],
                         device="cpu", model=object())
