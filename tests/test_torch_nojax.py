"""The port stands without JAX: importing it and serving a query on the CPU
loads neither jax nor flax; and the service refuses what is not ported."""

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

    cfg = get_default_cfg()
    cfg.MODEL.NAME = "resnet18"
    cfg.INPUT.SIZE_TEST = [32, 16]
    rng = np.random.RandomState(0)
    gallery = rng.randn(40, 512).astype(np.float32)
    svc = RetrievalService(cfg, gallery, [str(i) for i in range(40)], k=3,
                           device="cpu", model=create_model(cfg))
    img = rng.randint(0, 256, (32, 16, 3)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG")
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


@pytest.mark.parametrize("option,value", [
    ("mesh", object()), ("use_int8_gallery", True), ("rerank_window", 20),
    ("int8_calib_imgs", np.zeros((1, 32, 16, 3), np.uint8)),
    ("int8_qfn", object()), ("TPU.FAST_DECODE", True),
])
def test_service_refuses_unported_options(option, value):
    from centroids_reid_tpu_torch.config import get_default_cfg
    from centroids_reid_tpu_torch.inference import RetrievalService

    cfg = get_default_cfg()
    kwargs = {}
    if option == "TPU.FAST_DECODE":
        cfg.TPU.FAST_DECODE = True
    else:
        kwargs[option] = value
    with pytest.raises(NotImplementedError, match="not ported yet"):
        RetrievalService(cfg, np.ones((4, 8), np.float32), list("abcd"),
                         device="cpu", model=object(), **kwargs)


def test_service_refuses_empty_gallery():
    from centroids_reid_tpu_torch.config import get_default_cfg
    from centroids_reid_tpu_torch.inference import RetrievalService

    with pytest.raises(ValueError, match="empty gallery"):
        RetrievalService(get_default_cfg(), np.zeros((0, 8), np.float32), [],
                         device="cpu", model=object())
