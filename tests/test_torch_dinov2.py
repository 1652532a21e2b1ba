"""DINOv2 ViT with registers (``models/dinov2.py``) against the benchmark's
plain fp32 reference (``portbench/reference/dinov2.py``, loaded by path)
on seeded weights at a small size on the CPU: embed 64, depth 2, 2 heads
of 32, SwiGLU's hidden width from DINOv2's own rule (176), a 5x5 position
grid resized to the 4x2 patches of a 56x28 input, 4 registers or none.
Also the position grid at the published 37x37 -> 18x9, the LayerScale
add of a site op by op, DINOv2's own state-dict names, the embed path
with camera ids, the folder CLI, the trunk's spans and counters, the
published widths (on the meta device) and every path that refuses a
DINOv2 config."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from centroids_reid_tpu_torch.config import get_default_cfg
from centroids_reid_tpu_torch.data.transforms import normalize_batch
from centroids_reid_tpu_torch.engine import evaluate
from centroids_reid_tpu_torch.models import create_model
from centroids_reid_tpu_torch.models import dinov2 as D
from centroids_reid_tpu_torch.models import transreid as T
from centroids_reid_tpu_torch.ops.add_norm import add_norm, add_norm_plain
from centroids_reid_tpu_torch.utils import profiling

_REF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "portbench", "reference", "dinov2.py")
_spec = importlib.util.spec_from_file_location("portbench_ref_dinov2", _REF)
R = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(R)

DIM, DEPTH, HEADS, GRID = 64, 2, 2, 5
HW = (56, 28)   # 4x2 patches of 14
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
SMALL = dict(embed_dim=DIM, depth=DEPTH, num_heads=HEADS, mlp_ratio=4.0,
             patch_size=14, grid=GRID, num_register_tokens=4)
VITG = "dinov2_vitg14_reg"
# fp32 on both sides: SDPA against the explicit softmax and the sums of
# each matmul in another order agree to ~1e-7 at this size
RTOL = 1e-5


def _model(neck_feat="before", registers=4, seed=1, classes=0):
    m = D.DinoV2ReID(**dict(SMALL, num_register_tokens=registers),
                     neck_feat=neck_feat, num_classes=classes)
    D.init_dinov2(m, torch.Generator().manual_seed(seed)).eval()
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():   # running statistics a trained model would have
        bn = m.bottleneck
        bn.running_mean.normal_(0.0, 0.1, generator=g)
        bn.running_var.uniform_(0.5, 2.0, generator=g)
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.normal_(0.0, 0.1, generator=g)
    return m


def _spec(neck_feat="before", registers=4):
    return dict(depth=DEPTH, num_heads=HEADS, patch_size=14,
                num_register_tokens=registers, interpolate_antialias=True,
                ln_eps=1e-6, neck_feat=neck_feat,
                pixel_mean=MEAN, pixel_std=STD)


def _images(n, hw=HW, seed=2):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, hw[0], hw[1], 3), generator=g,
                         dtype=torch.uint8)


def _port(m, imgs, cams=None):
    x = normalize_batch(imgs, MEAN, STD).permute(0, 3, 1, 2)
    with torch.no_grad():
        return m.embed(x, cams)


def _rel(got, ref):
    return float(((got - ref).norm(dim=1) / ref.norm(dim=1)).max())


def _cfg(**extra):
    cfg = get_default_cfg()
    opts = {"MODEL.NAME": "transformer", "MODEL.TRANSFORMER_TYPE": VITG,
            "MODEL.JPM": "False", "MODEL.SIE_CAMERA": "False",
            "MODEL.BACKBONE_EMB_SIZE": str(DIM),
            "INPUT.SIZE_TRAIN": str(list(HW)),
            "INPUT.SIZE_TEST": str(list(HW)),
            "INPUT.PIXEL_MEAN": str(list(MEAN)),
            "INPUT.PIXEL_STD": str(list(STD)), "TEST.NECK_FEAT": "before",
            "TEST.IMS_PER_BATCH": "4", "USE_MIXED_PRECISION": "False"}
    opts.update(extra)
    cfg.merge_from_list([str(v) for kv in opts.items() for v in kv])
    return cfg


@pytest.fixture()
def small(monkeypatch):
    """``dinov2_vitg14_reg`` at the small widths, so that the config path
    builds through the model's constructor."""
    monkeypatch.setitem(D.DINOV2_WIDTHS, VITG, SMALL)


@pytest.mark.parametrize("neck_feat", ["before", "after"])
@pytest.mark.parametrize("registers", [4, 0])
def test_forward_matches_reference(neck_feat, registers):
    """The final norm's cls token, before or after the BNNeck, with 4
    registers or none, within RTOL of the reference."""
    m = _model(neck_feat, registers)
    imgs = _images(5)
    got = _port(m, imgs, torch.tensor([0, 5, 2, 3, 1]))
    ref = R.embed(m.state_dict(), imgs, _spec(neck_feat, registers), block=2)
    assert got.shape == ref.shape == (5, DIM)
    assert got.dtype == torch.float32
    assert _rel(got, ref) < RTOL


@pytest.mark.parametrize("fault", ["ls", "reg", "aa", "gate"])
def test_each_part_is_visible(monkeypatch, fault):
    """Each of the benchmark's planted faults moves the port's features
    past ten times RTOL from the reference's: LayerScale dropped, the
    registers left out, the grid resized without antialias (the least
    here, 4e-4: a 5x5 grid shrinks to 4x2, where the cell's 37x37 shrinks
    to 18x9), SiLU on the wrong half."""
    m = _model()
    imgs = _images(3, seed=5)
    ref = R.embed(m.state_dict(), imgs, _spec())
    assert _rel(_port(m, imgs), ref) < RTOL
    if fault == "ls":
        monkeypatch.setattr(D.LayerScale, "factor", lambda self: None)
    elif fault == "reg":
        monkeypatch.setattr(D.DinoVisionTransformer, "registers",
                            lambda self: None)
    elif fault == "aa":
        real = D.interpolate_grid
        monkeypatch.setattr(D, "interpolate_grid",
                            lambda g, size: real(g, size, False))
    else:
        def wrong_half(x12):
            x1, x2 = x12.chunk(2, dim=-1)
            return x1 * torch.nn.functional.silu(x2)

        monkeypatch.setattr(D.SwiGLUFFN, "gate", staticmethod(wrong_half))
    assert _rel(_port(m, imgs), ref) > 10 * RTOL


@pytest.mark.parametrize("hw", [(252, 126), (518, 518), (266, 252)])
def test_position_grid_is_the_published_interpolation(hw):
    """The 37x37 grid (plus cls) resized as ``interpolate_pos_encoding``
    resizes it (bicubic, antialias, by size): 18x9 at 252x126, the grid
    itself at 518x518 (the published shortcut), 19x18 at 266x252."""
    bb = D.DinoVisionTransformer(embed_dim=8, depth=0, num_heads=1, grid=37)
    with torch.no_grad():
        bb.pos_embed.normal_(0.0, 0.2,
                             generator=torch.Generator().manual_seed(3))
    rows, cols = hw[0] // 14, hw[1] // 14
    got = bb.position(rows, cols, hw[0], hw[1], torch.float32)
    ref = R._Ref({"backbone.pos_embed": bb.pos_embed.detach()},
                 _spec() | {"ln_eps": 1e-6}, None)
    want = ref.interpolate_pos_encoding(torch.zeros(1, 1 + rows * cols, 8),
                                        hw[0], hw[1])
    assert got.shape == (1, 1 + rows * cols, 8)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    if hw == (518, 518):
        assert torch.equal(got, bb.pos_embed)


def test_layer_scale_site_is_the_eager_ops():
    """A site with a LayerScale: ``x + delta * gamma`` with the product
    rounded to fp32 before the add (a bf16 delta promoted by the fp32
    gamma), then the LayerNorm; on a bf16 stream the product is rounded
    to bf16 first, as the eager bf16 ops round it."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn(6, 1536, generator=g)
    delta = torch.randn(6, 1536, generator=g).to(torch.bfloat16)
    gamma = torch.rand(1536, generator=g) * 0.45 + 0.05
    w, b = torch.ones(1536), torch.zeros(1536)
    s, y = add_norm(x, delta, w, b, 1e-6, torch.bfloat16, gamma)
    want = x + delta.float() * gamma
    assert torch.equal(s, want)
    torch.testing.assert_close(y, torch.nn.functional.layer_norm(
        want, (1536,), w, b, 1e-6).to(torch.bfloat16), rtol=0, atol=0)
    xs, gs = x.to(torch.bfloat16), gamma.to(torch.bfloat16)
    s16, _ = add_norm_plain(xs, delta, w.bfloat16(), b.bfloat16(), 1e-6,
                            None, gs)
    assert s16.dtype == torch.bfloat16
    assert torch.equal(s16, xs + (delta * gs))


def test_dinov2_state_dict_loads_by_its_own_names(small, tmp_path):
    """A state dict under DINOv2's own names below ``backbone.`` (the
    hub's keys: ``blocks.{i}.mlp.w12``, ``ls1.gamma``, ``register_tokens``,
    ``mask_token``, ...) and the BNNeck loads into the port's model with
    ``strict=True``, the hub's keys alone into its ``backbone``, and a
    ``.pth`` through ``load_inference_model``."""
    from centroids_reid_tpu_torch.inference.api import load_inference_model

    cfg = _cfg()
    trained = create_model(cfg, num_classes=7,
                           generator=torch.Generator().manual_seed(9))
    keys = set(trained.state_dict())
    hub = {"cls_token", "pos_embed", "register_tokens", "mask_token",
           "patch_embed.proj.weight", "patch_embed.proj.bias",
           "norm.weight", "norm.bias"}
    for i in range(DEPTH):
        hub |= {f"blocks.{i}.{k}" for k in (
            "norm1.weight", "norm1.bias", "attn.qkv.weight", "attn.qkv.bias",
            "attn.proj.weight", "attn.proj.bias", "ls1.gamma",
            "norm2.weight", "norm2.bias", "mlp.w12.weight", "mlp.w12.bias",
            "mlp.w3.weight", "mlp.w3.bias", "ls2.gamma")}
    assert keys == {"backbone." + k for k in hub} | {
        "bottleneck.weight", "bottleneck.bias", "bottleneck.running_mean",
        "bottleneck.running_var", "bottleneck.num_batches_tracked",
        "classifier.weight"}
    sd = {k: torch.randn_like(v) if v.is_floating_point() else v
          for k, v in trained.state_dict().items()}
    fresh = create_model(cfg, num_classes=7)
    assert fresh.load_state_dict(sd, strict=True) is not None
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, sd[k]), k
    other = create_model(cfg)
    other.backbone.load_state_dict(
        {k[len("backbone."):]: v for k, v in sd.items()
         if k.startswith("backbone.")}, strict=True)
    assert torch.equal(other.backbone.blocks[1].mlp.w12.weight,
                       sd["backbone.blocks.1.mlp.w12.weight"])
    path = tmp_path / "dinov2_vitg14_reg_120.pth"
    torch.save({"module." + k: v for k, v in trained.state_dict().items()},
               path)
    cfg.MODEL.PRETRAIN_PATH = str(path)
    loaded = load_inference_model(cfg, device="cpu")
    assert isinstance(loaded, D.DinoV2ReID) and loaded.num_classes == 0
    imgs = _images(3)
    torch.testing.assert_close(_port(loaded, imgs), _port(trained.eval(),
                                                          imgs),
                               rtol=0, atol=0)


def _loader(imgs, cams, batch):
    """``EvalLoader``'s batches: the last padded, ``valid`` False there."""
    n = imgs.shape[0]
    for s in range(0, n, batch):
        e = min(s + batch, n)
        pad = batch - (e - s)
        x = imgs[s:e].numpy()
        yield {"images": np.concatenate([x, np.zeros((pad,) + x.shape[1:],
                                                     np.uint8)]),
               "pids": np.pad(np.arange(s, e), (0, pad)),
               "camids": np.pad(cams[s:e].numpy(), (0, pad)),
               "valid": np.arange(batch) < e - s}


def test_embed_path_takes_camera_ids_and_reads_none(small):
    """``extract_embeddings`` hands each batch's camera ids to the model,
    which reads none: every valid row, the padded last batch's too, as the
    reference, and bit for bit the embeddings without camera ids."""
    cfg = _cfg()
    m = create_model(cfg, generator=torch.Generator().manual_seed(3))
    imgs, cams = _images(10, seed=4), torch.arange(10) % 6
    emb, pids, camids = evaluate.extract_embeddings(
        m, cfg, _loader(imgs, cams, 4))
    assert emb.shape == (10, DIM) and emb.dtype == np.float32
    np.testing.assert_array_equal(pids, np.arange(10))
    np.testing.assert_array_equal(camids, cams.numpy())
    ref = R.embed(m.state_dict(), imgs, _spec())
    assert _rel(torch.from_numpy(emb), ref) < RTOL
    fn = evaluate.make_embed_fn(m, cfg)
    torch.testing.assert_close(fn(imgs[:4].numpy(), cams[:4].numpy()),
                               fn(imgs[:4].numpy()), rtol=0, atol=0)


def test_embed_path_records_the_trunk_spans(small):
    """Under a profiler the model's spans run below ``embed``: per batch
    one ``dino.patch``, one ``dino.attn`` and one ``dino.mlp`` a block and
    one ``dino.head``; ``dino.tokens`` counts the tokens entering the
    blocks (cls, 4 registers, 8 patches an image); ``vit.norms`` the rows
    of every site (two a block and the final norm), none fused on the
    CPU."""
    cfg = _cfg()
    m = create_model(cfg)
    imgs, cams = _images(10, seed=5), torch.arange(10) % 6
    profiling.reset()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        evaluate.extract_embeddings(m, cfg, _loader(imgs, cams, 4))
    spans = profiling.spans()
    counts = profiling.counts()
    profiling.reset()
    roots = [s for s in spans if s.name == "embed"]
    assert len(roots) == 1 and roots[0].parent == -1
    for name, n in (("dino.patch", 1), ("dino.attn", DEPTH),
                    ("dino.mlp", DEPTH), ("dino.head", 1)):
        kids = [s for s in spans if s.name == name]
        assert len(kids) == 3 * n, name
        assert all(s.parent == roots[0].index for s in kids), name
    rows, tokens = 12, 1 + 4 + 8   # three batches of 4, the last padded
    assert counts["dino.tokens"] == rows * tokens
    assert counts["vit.norms"] == rows * tokens * (2 * DEPTH + 1)
    assert "vit.norms_fused" not in counts
    assert counts["embed.images"] == 10 and counts["embed.rows"] == rows


def test_published_widths():
    """``dinov2_vitg14_reg`` as the hub builds it (on the meta device, no
    memory): patch 14, D 1,536, 40 blocks of 24 heads of 64, qkv and proj
    with bias, SwiGLU ``w12`` Linear(1536, 2 x 4096) and ``w3``
    Linear(4096, 1536) with bias, LayerScale on both branches, LayerNorm
    eps 1e-6, 4 registers, a 37x37 grid plus cls; 1.136 B parameters in
    the backbone; 167 tokens at 252x126."""
    with torch.device("meta"):
        m = D.DinoV2ReID(**D.DINOV2_WIDTHS[VITG])
    bb = m.backbone
    assert bb.patch_embed.proj.kernel_size == (14, 14) == \
        bb.patch_embed.proj.stride
    assert len(bb.blocks) == 40 and m.emb_size == 1536
    blk = bb.blocks[0]
    assert blk.attn.num_heads == 24 and blk.attn.qkv.bias is not None
    assert tuple(blk.attn.qkv.weight.shape) == (4608, 1536)
    assert tuple(blk.mlp.w12.weight.shape) == (8192, 1536)
    assert tuple(blk.mlp.w3.weight.shape) == (1536, 4096)
    assert blk.mlp.w12.bias is not None and blk.mlp.w3.bias is not None
    assert blk.ls1.gamma.shape == blk.ls2.gamma.shape == (1536,)
    assert blk.norm1.eps == bb.norm.eps == 1e-6
    assert tuple(bb.register_tokens.shape) == (1, 4, 1536)
    assert tuple(bb.pos_embed.shape) == (1, 37 * 37 + 1, 1536)
    n = sum(p.numel() for p in bb.parameters())
    assert 1.13e9 < n < 1.14e9, n
    assert D.swiglu_hidden(1536, 4.0) == 4096 and D.swiglu_hidden(64, 4.0) \
        == 176
    assert 1 + 4 + (252 // 14) * (126 // 14) == 167


def test_other_trunks_unchanged_by_the_dispatch():
    """``create_model`` still builds a ResNet, TransReID's ViT and Swin
    for their configs: the family each config names."""
    cfg = get_default_cfg()
    assert T.family(cfg) == T.TRANSREID
    cfg.merge_from_list(["MODEL.TRANSFORMER_TYPE",
                         "swin_base_patch4_window7_224"])
    assert T.family(cfg) == T.SWIN
    cfg.merge_from_list(["MODEL.TRANSFORMER_TYPE", VITG])
    assert T.family(cfg) == T.DINOV2 == D.DinoV2ReID.FAMILY
    assert not D.is_dinov2(cfg)   # MODEL.NAME is a ResNet's
    cfg = get_default_cfg()
    cfg.merge_from_list(["MODEL.NAME", "resnet18", "MODEL.BACKBONE_EMB_SIZE",
                         "512"])
    assert not isinstance(create_model(cfg), D.DinoV2ReID)


def test_folder_cli_embeds_dinov2(small, tmp_path):
    """The folder CLI (``build_embeddings``: ``create_embeddings`` and
    ``get_similar``) embeds with DINOv2, which needs no camera id: the
    features the model gives on the same images."""
    from PIL import Image

    from centroids_reid_tpu_torch.inference.api import build_embeddings

    cfg = _cfg()
    model = create_model(cfg, generator=torch.Generator().manual_seed(4))
    path = tmp_path / "dinov2_120.pth"
    torch.save(model.state_dict(), path)
    folder = tmp_path / "images"
    folder.mkdir()
    imgs = _images(3, HW, 8)
    for i, img in enumerate(imgs.numpy()):
        Image.fromarray(img).save(folder / f"p{i}_c1.png")
    cfg.merge_from_list(["MODEL.PRETRAIN_PATH", str(path),
                         "DATASETS.ROOT_DIR", str(folder),
                         "OUTPUT_DIR", str(tmp_path / "out"),
                         "MODEL.USE_CENTROIDS", "False"])
    emb, paths = build_embeddings(cfg, False, device="cpu")
    assert emb.shape == (3, DIM) and len(paths) == 3
    torch.testing.assert_close(torch.from_numpy(emb), _port(model.eval(),
                                                            imgs),
                               rtol=1e-5, atol=1e-5)


def _raises(fn, what):
    with pytest.raises(NotImplementedError, match=what):
        fn()


@pytest.mark.parametrize("path", ["fit", "service", "server", "int8",
                                  "int8_flow", "export", "jpm_on", "sie_on",
                                  "directory"])
def test_unported_paths_refuse(small, tmp_path, path):
    """Each path that does not run DINOv2 (``fit``, the /search service,
    the HTTP server, both int8 paths, export, a checkpoint directory) and
    each head it lacks raises, naming DINOv2; none falls into TransReID's
    or a ResNet's branch."""
    cfg = _cfg()
    dino = r"does not run DINOv2 \(MODEL.NAME transformer\)"
    if path == "fit":
        from centroids_reid_tpu_torch.engine.fit import fit

        _raises(lambda: fit(cfg, "ctl", str(tmp_path), device="cpu"),
                "fit " + dino + ".*not ported")
    elif path == "service":
        from centroids_reid_tpu_torch.inference.service import (
            RetrievalService,
        )

        _raises(lambda: RetrievalService(cfg, np.zeros((4, DIM), np.float32),
                                         ["a", "b", "c", "d"],
                                         device="cpu",
                                         model=create_model(cfg)),
                "/search service " + dino)
    elif path == "server":
        from centroids_reid_tpu_torch.inference.server import build_from_args

        opts = ["MODEL.NAME", "transformer", "MODEL.TRANSFORMER_TYPE", VITG]
        _raises(lambda: build_from_args(["--gallery_data", str(tmp_path),
                                         "--device", "cpu"] + opts),
                "HTTP server " + dino)
    elif path == "int8":
        from centroids_reid_tpu_torch.models.quantized import (
            quantize_reid_model,
        )

        _raises(lambda: quantize_reid_model(create_model(cfg), [], MEAN,
                                            STD),
                "int8 quantization " + dino)
    elif path == "int8_flow":
        from centroids_reid_tpu_torch.models.quantized import (
            quantize_for_serving,
        )

        _raises(lambda: quantize_for_serving(cfg, create_model(cfg), []),
                "int8 quantization " + dino)
    elif path == "export":
        from centroids_reid_tpu_torch.inference.export import export_embedder

        _raises(lambda: export_embedder(create_model(cfg), cfg,
                                        platforms=("cpu",)),
                "export " + dino)
    elif path == "jpm_on":
        _raises(lambda: create_model(_cfg(**{"MODEL.JPM": "True"})),
                dino + ".*cls")
    elif path == "sie_on":
        _raises(lambda: create_model(_cfg(**{"MODEL.SIE_CAMERA": "True"}),
                                     cameras=6),
                dino + ".*camera")
    else:
        cfg.MODEL.PRETRAIN_PATH = str(tmp_path)
        from centroids_reid_tpu_torch.inference.api import (
            load_inference_model,
        )

        _raises(lambda: load_inference_model(cfg, device="cpu"),
                "checkpoint directory " + dino)


def test_unknown_dinov2_type_and_ragged_input_are_refused():
    """Another DINOv2 size is not ported; an input that is not a whole
    number of 14x14 patches raises rather than drop a row."""
    with pytest.raises(ValueError, match="not ported"):
        create_model(_cfg(**{"MODEL.TRANSFORMER_TYPE": "dinov2_vitl14_reg"}))
    with pytest.raises(ValueError, match="whole number"):
        _port(_model(), _images(1, (60, 28)))
