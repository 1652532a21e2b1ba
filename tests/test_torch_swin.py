"""SOLIDER-REID's Swin (``models/swin.py``) against the benchmark's plain
fp32 reference (``portbench/reference/swin.py``, loaded by path) on seeded
weights at tiny widths on the CPU: C 16, depths [2, 2, 2, 2], heads [1, 2,
2, 4], window 7, 64x32 images, so every stage pads (16x8 -> 21x14, 8x4 ->
14x7, 4x2 and 2x1 -> 7x7) and every stage has a shifted block. Also the
window geometry against the published pad, roll and partition, the padded
keys left unmasked, SOLIDER's state-dict names, the embed path with camera
ids, TransReID and ResNet embeddings unchanged by the dispatch, the
trunk's spans and counters, and every path that refuses a Swin config."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from centroids_reid_tpu_torch.config import get_default_cfg
from centroids_reid_tpu_torch.data.transforms import normalize_batch
from centroids_reid_tpu_torch.engine import evaluate
from centroids_reid_tpu_torch.models import create_model
from centroids_reid_tpu_torch.models import swin as S
from centroids_reid_tpu_torch.models import transreid as T
from centroids_reid_tpu_torch.utils import profiling

_REF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "portbench", "reference", "swin.py")
_spec = importlib.util.spec_from_file_location("portbench_ref_swin", _REF)
R = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(R)

C, DEPTHS, HEADS = 16, (2, 2, 2, 2), (1, 2, 2, 4)
HW = (64, 32)
MEAN, STD = (0.5, 0.5, 0.5), (0.5, 0.5, 0.5)
TINY = dict(embed_dim=C, depths=DEPTHS, num_heads=HEADS)
RTOL = 1e-5   # two fp32 orders of the same sums; they agree to ~1e-6
SWIN_B = "swin_base_patch4_window7_224"


def _model(neck_feat="before", semantic_weight=0.2, seed=1, classes=0):
    m = S.SwinReID(**TINY, semantic_weight=semantic_weight,
                   neck_feat=neck_feat, num_classes=classes)
    S.init_swin(m, torch.Generator().manual_seed(seed)).eval()
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():   # running statistics a trained model would have
        bn = m.bottleneck
        bn.running_mean.normal_(0.0, 0.1, generator=g)
        bn.running_var.uniform_(0.5, 2.0, generator=g)
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.normal_(0.0, 0.1, generator=g)
    return m


def _spec(neck_feat="before", semantic_weight=0.2):
    return dict(depths=list(DEPTHS), num_heads=list(HEADS), window_size=7,
                patch_size=4, ln_eps=1e-5, semantic_weight=semantic_weight,
                neck_feat=neck_feat, pixel_mean=MEAN, pixel_std=STD)


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
    opts = {"MODEL.NAME": "transformer", "MODEL.TRANSFORMER_TYPE": SWIN_B,
            "MODEL.JPM": "False", "MODEL.SIE_CAMERA": "False",
            "MODEL.SEMANTIC_WEIGHT": "0.2",
            "MODEL.BACKBONE_EMB_SIZE": str(8 * C),
            "INPUT.SIZE_TRAIN": str(list(HW)),
            "INPUT.SIZE_TEST": str(list(HW)),
            "INPUT.PIXEL_MEAN": "[0.5, 0.5, 0.5]",
            "INPUT.PIXEL_STD": "[0.5, 0.5, 0.5]", "TEST.NECK_FEAT": "before",
            "TEST.IMS_PER_BATCH": "4", "USE_MIXED_PRECISION": "False"}
    opts.update(extra)
    cfg.merge_from_list([str(v) for kv in opts.items() for v in kv])
    return cfg


@pytest.fixture()
def tiny(monkeypatch):
    """``swin_base_patch4_window7_224`` at the tiny widths, so that the
    config path builds through the model's constructor."""
    monkeypatch.setitem(S.SWIN_WIDTHS, SWIN_B, TINY)


@pytest.mark.parametrize("neck_feat", ["before", "after"])
@pytest.mark.parametrize("semantic_weight", [0.2, -1.0])
def test_forward_matches_reference(neck_feat, semantic_weight):
    """The 8C-wide feature, before or after the BNNeck, with and without
    the semantic controller, within 1e-5 of the reference."""
    m = _model(neck_feat, semantic_weight)
    imgs = _images(5)
    got = _port(m, imgs, torch.tensor([0, 5, 2, 3, 1]))
    ref = R.embed(m.state_dict(), imgs, _spec(neck_feat, semantic_weight),
                  block=2)
    assert got.shape == ref.shape == (5, 8 * C)
    assert got.dtype == torch.float32
    assert _rel(got, ref) < RTOL


@pytest.mark.parametrize("hw,shift", [((16, 8), 3), ((16, 8), 0),
                                      ((2, 1), 3), ((14, 7), 3),
                                      ((24, 8), 3)])
def test_window_geometry_is_the_published_data_movement(hw, shift):
    """One gather by ``order`` of the padded map is the published roll and
    ``window_partition``; one gather back by ``inverse`` is
    ``window_reverse``, the roll back and the crop; ``region`` is mmdet's
    ``img_mask`` fill, exactly."""
    h, w = hw
    g = S.window_geometry(h, w, 7, shift, torch.device("cpu"))
    x = torch.randn(2, h, w, 3)
    padded = torch.nn.functional.pad(x, (0, 0, 0, g.wp - w, 0, g.hp - h))
    rolled = torch.roll(padded, (-shift, -shift), (1, 2)) if shift \
        else padded
    want = R.window_partition(rolled, 7).reshape(2, -1, 3)
    got = padded.reshape(2, -1, 3).index_select(1, g.order)
    assert torch.equal(got, want)
    back = R.window_reverse(want.reshape(-1, 7, 7, 3), g.hp, g.wp, 7)
    if shift:
        back = torch.roll(back, (shift, shift), (1, 2))
    assert torch.equal(got.index_select(1, g.inverse),
                       back[:, :h, :w].reshape(2, h * w, 3))
    if not shift:
        assert g.region is None
        return
    ref = R._Ref({}, {"ln_eps": 1e-5, "window_size": 7}, None)
    captured = {}

    def capture(x, name, heads, mask=None):
        captured["mask"] = mask
        return x

    ref.window_msa = capture
    ref.shift_window_msa(torch.zeros(1, h * w, 2), (h, w), "b", 1, shift)
    assert torch.equal(g.region, captured["mask"])


def test_window_mask_is_bias_plus_region():
    """The additive mask: the bias for every window of an unshifted block
    (one row, broadcast), bias + region per window and image of a shifted
    one, -100 exactly where the regions differ."""
    blk = _model().base.stages[0].blocks[1].attn
    bias = blk.w_msa.position_bias()
    g = S.window_geometry(16, 8, 7, 3, torch.device("cpu"))
    m = S.window_mask(bias, g.region, 2, torch.float32)
    assert m.shape == (2 * 6, 1, 49, 49)
    torch.testing.assert_close(m.view(2, 6, 1, 49, 49)[1],
                               bias[None] + g.region[:, None], rtol=0,
                               atol=0)
    assert set(g.region.unique().tolist()) == {0.0, -100.0}
    plain = S.window_mask(bias, None, 2, torch.float32)
    assert plain.shape == (1, 1, 49, 49)
    assert torch.equal(plain[0], bias)
    table = blk.w_msa.relative_position_bias_table
    idx = R.relative_position_index(7)
    assert torch.equal(blk.w_msa.relative_position_index, idx)
    assert torch.equal(bias, table[idx.view(-1)].view(49, 49, -1).permute(
        2, 0, 1))


def _masking_padded_keys(monkeypatch):
    """The port with every padded token masked out as a key (-100 added
    to its column, in every block's region): what the published code does
    not do."""
    geometry = S.window_geometry

    def geo(h, w, window, shift, device):
        g = geometry(h, w, window, shift, device)
        y, x = g.order // g.wp, g.order % g.wp
        pad = ((y >= g.h) | (x >= g.w)).view(-1, 1, window * window)
        keys = torch.where(pad, S.SHIFT_FILL, 0.0).expand(
            -1, window * window, -1)
        return g._replace(region=keys if g.region is None
                          else g.region + keys)

    monkeypatch.setattr(S, "window_geometry", geo)


def test_padded_keys_take_part(monkeypatch):
    """The padded tokens stay unmasked keys and values, as published: with
    the seeded nonzero qkv biases, their q, k and v are those biases, and
    masking them moves the features far past the tolerance."""
    m = _model()
    qkv = m.base.stages[2].blocks[0].attn.w_msa.qkv
    assert float(qkv.bias.detach().abs().min()) > 0
    imgs = _images(3, seed=5)
    ref = R.embed(m.state_dict(), imgs, _spec())
    assert _rel(_port(m, imgs), ref) < RTOL
    _masking_padded_keys(monkeypatch)
    assert _rel(_port(m, imgs), ref) > 1e-3


def test_solider_state_dict_loads_unchanged(tiny, tmp_path):
    """A SOLIDER-REID checkpoint (DataParallel's ``module.`` prefix, the
    mmdet names, ``norm0``-``norm3``, the controller's linears, the
    classifier) loads by its own names, here and through
    ``load_inference_model``."""
    from centroids_reid_tpu_torch.inference.api import load_inference_model

    cfg = _cfg()
    trained = create_model(cfg, num_classes=7,
                           generator=torch.Generator().manual_seed(9))
    keys = set(trained.state_dict())
    assert {"base.patch_embed.projection.weight",
            "base.patch_embed.norm.bias",
            "base.stages.0.blocks.1.norm1.weight",
            "base.stages.0.blocks.1.attn.w_msa.qkv.weight",
            "base.stages.0.blocks.1.attn.w_msa.relative_position_bias_table",
            "base.stages.0.blocks.1.attn.w_msa.relative_position_index",
            "base.stages.0.blocks.1.attn.w_msa.proj.bias",
            "base.stages.0.blocks.1.norm2.weight",
            "base.stages.2.blocks.0.ffn.layers.0.0.weight",
            "base.stages.2.blocks.0.ffn.layers.1.bias",
            "base.stages.0.downsample.norm.weight",
            "base.stages.2.downsample.reduction.weight",
            "base.norm0.weight", "base.norm3.bias",
            "base.semantic_embed_w.0.weight", "base.semantic_embed_b.3.bias",
            "bottleneck.running_var", "classifier.weight"} <= keys
    assert "base.stages.3.downsample.norm.weight" not in keys
    assert "base.stages.2.downsample.reduction.bias" not in keys
    sd = {"module." + k: v for k, v in trained.state_dict().items()}
    fresh = T.load_transreid_state_dict(create_model(cfg), sd)
    for k, v in fresh.state_dict().items():
        torch.testing.assert_close(v, trained.state_dict()[k], rtol=0, atol=0)
    path = tmp_path / "swin_base_120.pth"
    torch.save(sd, path)
    cfg.MODEL.PRETRAIN_PATH = str(path)
    loaded = load_inference_model(cfg, device="cpu")
    assert isinstance(loaded, S.SwinReID) and loaded.num_classes == 0
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


def test_embed_path_takes_camera_ids_and_reads_none(tiny):
    """``extract_embeddings`` hands each batch's camera ids to the model,
    which reads none: every valid row, the padded last batch's too, as the
    reference, and bit for bit the embeddings without camera ids."""
    cfg = _cfg()
    m = create_model(cfg, generator=torch.Generator().manual_seed(3))
    imgs, cams = _images(10, seed=4), torch.arange(10) % 6
    emb, pids, camids = evaluate.extract_embeddings(
        m, cfg, _loader(imgs, cams, 4))
    assert emb.shape == (10, 8 * C) and emb.dtype == np.float32
    np.testing.assert_array_equal(pids, np.arange(10))
    np.testing.assert_array_equal(camids, cams.numpy())
    ref = R.embed(m.state_dict(), imgs, _spec())
    assert _rel(torch.from_numpy(emb), ref) < RTOL
    fn = evaluate.make_embed_fn(m, cfg)
    torch.testing.assert_close(fn(imgs[:4].numpy(), cams[:4].numpy()),
                               fn(imgs[:4].numpy()), rtol=0, atol=0)


def test_embed_path_records_the_trunk_spans(tiny):
    """Under a profiler the model's spans run below ``embed``: per batch
    one ``swin.patch``, one ``swin.wmsa`` and one ``swin.mlp`` a block,
    three ``swin.merge`` and one ``swin.head``; ``swin.tokens`` counts the
    real tokens entering window attention, ``swin.window_tokens`` the
    padded ones; ``vit.norms`` every site's rows (the patch norm, two a
    block, the merges, ``norm3``); none fused on the CPU, neither a site
    nor a window attention (``swin.wmsa_fused``)."""
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
    for name, n in (("swin.patch", 1), ("swin.wmsa", 8), ("swin.mlp", 8),
                    ("swin.merge", 3), ("swin.head", 1)):
        kids = [s for s in spans if s.name == name]
        assert len(kids) == 3 * n, name
        assert all(s.parent == roots[0].index for s in kids), name
    maps = [(16, 8), (8, 4), (4, 2), (2, 1)]
    padded = [(21, 14), (14, 7), (7, 7), (7, 7)]
    rows = 12   # three batches of 4, the last padded
    assert counts["swin.tokens"] == rows * 2 * sum(h * w for h, w in maps)
    assert counts["swin.window_tokens"] == rows * 2 * sum(
        h * w for h, w in padded)
    norms = (maps[0][0] * maps[0][1] + 2 * 2 * sum(h * w for h, w in maps)
             + sum(h * w for h, w in maps[1:]) + maps[-1][0] * maps[-1][1])
    assert counts["vit.norms"] == rows * norms
    assert "vit.norms_fused" not in counts
    assert "swin.wmsa_fused" not in counts
    assert counts["embed.images"] == 10 and counts["embed.rows"] == rows


def test_published_widths_and_padding():
    """``swin_base_patch4_window7_224`` at 384x128: C 128, depths [2, 2,
    18, 2], heads 4 / 8 / 16 / 32 (every head 32 wide), MLP 4C, LayerNorm
    eps 1e-5, window 7, a 1,024-d feature; the stage maps 96x32, 48x16,
    24x8, 12x4 pad to 98x35, 49x21, 28x14, 14x7."""
    cfg = _cfg(**{"INPUT.SIZE_TRAIN": "[384, 128]",
                  "INPUT.SIZE_TEST": "[384, 128]",
                  "MODEL.BACKBONE_EMB_SIZE": "1024"})
    m = create_model(cfg)
    assert isinstance(m, S.SwinReID) and m.emb_size == 1024
    base = m.base
    assert base.patch_embed.projection.kernel_size == (4, 4)
    assert [len(s.blocks) for s in base.stages] == [2, 2, 18, 2]
    for i, s in enumerate(base.stages):
        blk = s.blocks[1]
        assert blk.attn.w_msa.num_heads == 4 * 2 ** i
        assert blk.attn.w_msa.qkv.in_features == 128 * 2 ** i
        assert blk.ffn.layers[0][0].out_features == 512 * 2 ** i
        assert blk.norm1.eps == 1e-5
        assert (s.blocks[0].attn.shift, blk.attn.shift) == (0, 3)
    assert [d.weight.shape[0] for d in base.semantic_embed_w] == [
        256, 512, 1024, 1024]
    for (h, w), pad in zip([(96, 32), (48, 16), (24, 8), (12, 4)],
                           [(98, 35), (49, 21), (28, 14), (14, 7)]):
        g = S.window_geometry(h, w, 7, 3, torch.device("cpu"))
        assert (g.hp, g.wp) == pad


def test_transreid_and_resnet_unchanged_by_the_dispatch():
    """``create_model`` builds TransReID's ViT and a ResNet as before:
    bit for bit the embeddings of the models built directly from the same
    seed."""
    from centroids_reid_tpu_torch.models.baseline import ReidModel, init_model

    cfg = get_default_cfg()
    cfg.merge_from_list(["MODEL.NAME", "resnet18", "MODEL.BACKBONE_EMB_SIZE",
                         "512", "INPUT.SIZE_TEST", "[64, 32]",
                         "USE_MIXED_PRECISION", "False"])
    imgs = _images(3, (64, 32), 6)
    got = _port(create_model(cfg), imgs)
    direct = init_model(ReidModel("resnet18", 1),
                        torch.Generator().manual_seed(0)).eval()
    torch.testing.assert_close(got, _port(direct, imgs), rtol=0, atol=0)

    vit = dict(embed_dim=32, depth=2, num_heads=2, mlp_ratio=4.0,
               patch_size=16)
    cfg = get_default_cfg()
    cfg.merge_from_list([
        "MODEL.NAME", "transformer", "MODEL.TRANSFORMER_TYPE",
        "vit_base_patch16_224_TransReID", "MODEL.STRIDE_SIZE", "[12, 12]",
        "MODEL.SIE_CAMERA", "True", "MODEL.JPM", "True",
        "MODEL.BACKBONE_EMB_SIZE", "160", "INPUT.SIZE_TRAIN", "[112, 64]",
        "INPUT.SIZE_TEST", "[112, 64]", "TEST.NECK_FEAT", "before",
        "USE_MIXED_PRECISION", "False"])
    old = T.VIT_WIDTHS["vit_base_patch16_224_TransReID"]
    T.VIT_WIDTHS["vit_base_patch16_224_TransReID"] = vit
    try:
        m = create_model(cfg, cameras=6,
                         generator=torch.Generator().manual_seed(4))
    finally:
        T.VIT_WIDTHS["vit_base_patch16_224_TransReID"] = old
    assert isinstance(m, T.TransReIDModel)
    direct = T.init_transreid(
        T.TransReIDModel(img_size=(112, 64), cameras=6, **vit),
        torch.Generator().manual_seed(4)).eval()
    imgs, cams = _images(3, (112, 64), 7), torch.tensor([0, 2, 5])
    torch.testing.assert_close(_port(m, imgs, cams), _port(direct, imgs,
                                                           cams),
                               rtol=0, atol=0)


def test_odd_map_is_refused():
    """Patch merging of an odd map (mmdet's corner padding) is not
    ported: it raises rather than drop a row."""
    m = _model()
    with pytest.raises(ValueError, match="odd map"):
        _port(m, _images(1, (60, 32)))


def _raises(fn, what):
    with pytest.raises(NotImplementedError, match=what):
        fn()


@pytest.mark.parametrize("path", ["fit", "service", "server", "int8",
                                  "int8_flow", "export", "jpm_on", "sie_on",
                                  "directory"])
def test_unported_paths_refuse(tiny, tmp_path, path):
    """Each path that does not run Swin raises, naming the model; none
    falls back to another trunk."""
    cfg = _cfg()
    swin = r"does not run Swin \(SOLIDER-REID"
    if path == "fit":
        from centroids_reid_tpu_torch.engine.fit import fit

        _raises(lambda: fit(cfg, "ctl", str(tmp_path), device="cpu"),
                "fit " + swin + ".*not ported")
    elif path == "service":
        from centroids_reid_tpu_torch.inference.service import (
            RetrievalService,
        )

        _raises(lambda: RetrievalService(cfg, np.zeros((4, 8 * C),
                                                       np.float32),
                                         ["a", "b", "c", "d"],
                                         device="cpu",
                                         model=create_model(cfg)),
                "/search service " + swin)
    elif path == "server":
        from centroids_reid_tpu_torch.inference.server import build_from_args

        opts = ["MODEL.NAME", "transformer", "MODEL.TRANSFORMER_TYPE",
                SWIN_B]
        _raises(lambda: build_from_args(["--gallery_data", str(tmp_path),
                                         "--device", "cpu"] + opts),
                "HTTP server " + swin)
    elif path == "int8":
        from centroids_reid_tpu_torch.models.quantized import (
            quantize_reid_model,
        )

        _raises(lambda: quantize_reid_model(create_model(cfg), [], MEAN,
                                            STD),
                "int8 quantization " + swin)
    elif path == "int8_flow":
        from centroids_reid_tpu_torch.models.quantized import (
            quantize_for_serving,
        )

        _raises(lambda: quantize_for_serving(cfg, create_model(cfg), []),
                "int8 quantization " + swin)
    elif path == "export":
        from centroids_reid_tpu_torch.inference.export import export_embedder

        _raises(lambda: export_embedder(create_model(cfg), cfg,
                                        platforms=("cpu",)),
                "export " + swin)
    elif path == "jpm_on":
        _raises(lambda: create_model(_cfg(**{"MODEL.JPM": "True"})),
                swin + ".*global head")
    elif path == "sie_on":
        _raises(lambda: create_model(_cfg(**{"MODEL.SIE_CAMERA": "True"}),
                                     cameras=6),
                swin + ".*camera")
    else:
        cfg.MODEL.PRETRAIN_PATH = str(tmp_path)
        from centroids_reid_tpu_torch.inference.api import (
            load_inference_model,
        )

        _raises(lambda: load_inference_model(cfg, device="cpu"),
                "checkpoint directory " + swin)


def test_unknown_swin_type_is_refused():
    with pytest.raises(ValueError, match="not ported"):
        create_model(_cfg(**{"MODEL.TRANSFORMER_TYPE":
                             "swin_large_patch4_window12_384"}))
