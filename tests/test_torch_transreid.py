"""TransReID (``models/transreid.py``) against the benchmark's plain fp32
reference (``portbench/reference/transreid.py``, loaded by path) on seeded
weights at tiny widths on the CPU: 112x64 images give 9 x 5 = 45 patches,
an odd count that takes ``shuffle_unit``'s padding branch; 100x64 give 40.
Also the embed path with camera ids, TransReID's state-dict names, ResNet
embeddings unchanged by camera ids, the trunk's spans and counters, and
every path that refuses a TransReID config."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from centroids_reid_tpu_torch.config import get_default_cfg
from centroids_reid_tpu_torch.data.transforms import normalize_batch
from centroids_reid_tpu_torch.engine import evaluate
from centroids_reid_tpu_torch.models import create_model
from centroids_reid_tpu_torch.models import transreid as T
from centroids_reid_tpu_torch.utils import profiling

_REF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "portbench", "reference", "transreid.py")
_spec = importlib.util.spec_from_file_location("portbench_ref_transreid",
                                               _REF)
R = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(R)

D, HEADS, DEPTH = 64, 2, 3
MEAN, STD = (0.5, 0.5, 0.5), (0.5, 0.5, 0.5)
TINY = dict(embed_dim=D, depth=DEPTH, num_heads=HEADS, mlp_ratio=4.0,
            patch_size=16)
RTOL = 1e-5   # two fp32 orders of the same sums; they agree to ~3e-7


def _model(hw=(112, 64), cameras=6, neck_feat="before", seed=1):
    m = T.TransReIDModel(img_size=hw, embed_dim=D, depth=DEPTH,
                         num_heads=HEADS, cameras=cameras,
                         neck_feat=neck_feat)
    T.init_transreid(m, torch.Generator().manual_seed(seed)).eval()
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():   # running statistics a trained model would have
        for name in ["bottleneck"] + [f"bottleneck_{i}" for i in range(1, 5)]:
            bn = getattr(m, name)
            bn.running_mean.normal_(0.0, 0.1, generator=g)
            bn.running_var.uniform_(0.5, 2.0, generator=g)
            bn.weight.uniform_(0.5, 1.5, generator=g)
            bn.bias.normal_(0.0, 0.1, generator=g)
    return m


def _spec(neck_feat="before", rearrange=True):
    return dict(num_heads=HEADS, depth=DEPTH, stride_size=[12, 12],
                sie_coe=3.0, shift_num=5, shuffle_groups=2, divide_length=4,
                rearrange=rearrange, neck_feat=neck_feat, pixel_mean=MEAN,
                pixel_std=STD)


def _images(n, hw, seed=2):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, hw[0], hw[1], 3), generator=g,
                         dtype=torch.uint8)


def _port(m, imgs, cams):
    x = normalize_batch(imgs, MEAN, STD).permute(0, 3, 1, 2)
    with torch.no_grad():
        return m.embed(x, cams)


def _rel(got, ref):
    return float(((got - ref).norm(dim=1) / ref.norm(dim=1)).max())


def _cfg(**extra):
    cfg = get_default_cfg()
    opts = {"MODEL.NAME": "transformer",
            "MODEL.TRANSFORMER_TYPE": "vit_base_patch16_224_TransReID",
            "MODEL.STRIDE_SIZE": "[12, 12]", "MODEL.SIE_CAMERA": "True",
            "MODEL.JPM": "True", "MODEL.BACKBONE_EMB_SIZE": str(5 * D),
            "INPUT.SIZE_TRAIN": "[112, 64]", "INPUT.SIZE_TEST": "[112, 64]",
            "INPUT.PIXEL_MEAN": "[0.5, 0.5, 0.5]",
            "INPUT.PIXEL_STD": "[0.5, 0.5, 0.5]", "TEST.NECK_FEAT": "before",
            "TEST.IMS_PER_BATCH": "4", "USE_MIXED_PRECISION": "False"}
    opts.update(extra)
    cfg.merge_from_list([str(v) for kv in opts.items() for v in kv])
    return cfg


@pytest.fixture()
def tiny(monkeypatch):
    """``vit_base_patch16_224_TransReID`` at the tiny widths, so that the
    config path builds through the model's constructor."""
    monkeypatch.setitem(T.VIT_WIDTHS, "vit_base_patch16_224_TransReID",
                        TINY)


@pytest.mark.parametrize("hw", [(112, 64), (100, 64)])
@pytest.mark.parametrize("neck_feat", ["before", "after"])
@pytest.mark.parametrize("cameras", [6, 0])
def test_forward_matches_reference(hw, neck_feat, cameras):
    """Each branch (the global feature and each local one / 4, before or
    after its BNNeck) within 1e-5 of the reference, SIE on and off."""
    m = _model(hw, cameras, neck_feat)
    imgs = _images(5, hw)
    cams = torch.tensor([0, 5, 2, 3, 1])
    got = _port(m, imgs, cams if cameras else None)
    ref = R.embed(m.state_dict(), imgs, cams, _spec(neck_feat), block=2)
    assert got.shape == ref.shape == (5, 5 * D)
    assert got.dtype == torch.float32
    for i in range(5):
        sl = slice(i * D, (i + 1) * D)
        assert _rel(got[:, sl], ref[:, sl]) < RTOL, i


def test_odd_patch_count_takes_the_padding_branch():
    """45 patch tokens after the shift: the published ``except`` branch
    pads with token [-2]; both shuffles give the same 46 tokens."""
    f = torch.randn(2, 46, 8)
    got = T.shuffle_unit(f, 5, 2)
    assert got.shape == (2, 46, 8)
    torch.testing.assert_close(got, R.shuffle_unit(f, 5, 2), rtol=0, atol=0)
    x = torch.cat([f[:, 5:], f[:, 1:5]], dim=1)
    x = torch.cat([x, x[:, -2:-1]], dim=1)
    torch.testing.assert_close(got[:, 0], x[:, 0], rtol=0, atol=0)
    torch.testing.assert_close(got[:, 1], x[:, 23], rtol=0, atol=0)


def test_rearrange_off_matches_reference():
    m = _model()
    m.rearrange = False
    imgs, cams = _images(3, (112, 64)), torch.tensor([1, 2, 3])
    ref = R.embed(m.state_dict(), imgs, cams, _spec(rearrange=False))
    assert _rel(_port(m, imgs, cams), ref) < RTOL


def test_sie_reads_each_rows_camera():
    """The same image under two cameras embeds apart, each as the
    reference does; without SIE the camera is not read."""
    m = _model()
    img = _images(1, (112, 64)).expand(2, -1, -1, -1).contiguous()
    cams = torch.tensor([0, 4])
    got = _port(m, img, cams)
    assert _rel(got[:1], got[1:]) > 1e-3
    ref = R.embed(m.state_dict(), img, cams, _spec())
    assert _rel(got, ref) < RTOL
    off = _model(cameras=0)
    torch.testing.assert_close(_port(off, img, cams), _port(off, img, None),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="camera id"):
        _port(m, img, None)


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


def test_embed_path_passes_camera_ids(tiny):
    """``extract_embeddings`` through ``make_embed_fn`` and
    ``embed_query`` hands each batch's camera ids to the model: every
    valid row, the padded last batch's too, as the reference."""
    cfg = _cfg()
    m = create_model(cfg, cameras=6,
                     generator=torch.Generator().manual_seed(3))
    imgs, cams = _images(10, (112, 64), 4), torch.arange(10) % 6
    emb, pids, camids = evaluate.extract_embeddings(
        m, cfg, _loader(imgs, cams, 4))
    assert emb.shape == (10, 5 * D) and emb.dtype == np.float32
    np.testing.assert_array_equal(pids, np.arange(10))
    np.testing.assert_array_equal(camids, cams.numpy())
    ref = R.embed(m.state_dict(), imgs, cams, _spec())
    assert _rel(torch.from_numpy(emb), ref) < RTOL


def test_embed_path_records_the_trunk_spans(tiny):
    """Under a profiler ``extract_embeddings`` is the root span ``embed``,
    the model's four spans run once a batch below it, and the counters
    hold the real images, the rows launched and the LayerNorm sites' rows:
    2 x (DEPTH - 1) + 3 sites over each batch's [4, 46] tokens, ``b2``'s 3
    over its [16, 12] groups; on the CPU none is fused."""
    cfg = _cfg()
    m = create_model(cfg, cameras=6)
    imgs, cams = _images(10, (112, 64), 5), torch.arange(10) % 6
    profiling.reset()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        evaluate.extract_embeddings(m, cfg, _loader(imgs, cams, 4))
    spans = profiling.spans()
    roots = [s for s in spans if s.name == "embed"]
    assert len(roots) == 1 and roots[0].parent == -1
    for name in ("vit.patch", "vit.blocks", "vit.global", "vit.jpm"):
        kids = [s for s in spans if s.name == name]
        assert len(kids) == 3, name
        assert all(s.parent == roots[0].index for s in kids), name
    norms = 3 * ((2 * (DEPTH - 1) + 3) * 4 * 46 + 3 * 16 * 12)
    assert profiling.counts() == {"embed.images": 10, "embed.rows": 12,
                                  "vit.norms": norms}
    profiling.reset()


def test_transreid_state_dict_loads_unchanged(tiny, tmp_path):
    """A TransReID checkpoint (DataParallel's ``module.`` prefix, the
    backbone's unused ImageNet head ``base.fc``, five classifiers) loads
    by its own names, here and through ``load_inference_model`` with SIE
    sized by the file."""
    from centroids_reid_tpu_torch.inference.api import load_inference_model

    cfg = _cfg()
    trained = create_model(cfg, num_classes=7, cameras=6,
                           generator=torch.Generator().manual_seed(9))
    keys = set(trained.state_dict())
    assert {"base.cls_token", "base.pos_embed", "base.sie_embed",
            "base.patch_embed.proj.weight", "base.blocks.2.attn.qkv.weight",
            "base.norm.weight", "b1.0.mlp.fc2.bias", "b2.1.weight",
            "bottleneck.running_var", "bottleneck_4.weight",
            "classifier.weight", "classifier_4.weight"} <= keys
    sd = {"module." + k: v for k, v in trained.state_dict().items()}
    sd["module.base.fc.weight"] = torch.zeros(1000, D)
    sd["module.base.fc.bias"] = torch.zeros(1000)
    fresh = T.load_transreid_state_dict(create_model(cfg, cameras=6), sd)
    for k, v in fresh.state_dict().items():
        torch.testing.assert_close(v, trained.state_dict()[k], rtol=0, atol=0)
    path = tmp_path / "transformer_120.pth"
    torch.save(sd, path)
    cfg.MODEL.PRETRAIN_PATH = str(path)
    loaded = load_inference_model(cfg, device="cpu")
    assert loaded.cameras == 6
    imgs, cams = _images(3, (112, 64)), torch.tensor([0, 3, 5])
    torch.testing.assert_close(_port(loaded, imgs, cams),
                               _port(trained.eval(), imgs, cams),
                               rtol=0, atol=0)


def test_resnet_embeddings_unchanged_by_camera_ids():
    """A ResNet takes the camera ids and reads none: bit for bit the
    embeddings it gives without them, through the model and the embed
    path."""
    cfg = get_default_cfg()
    cfg.merge_from_list(["MODEL.NAME", "resnet18", "MODEL.BACKBONE_EMB_SIZE",
                         "512", "INPUT.SIZE_TEST", "[64, 32]",
                         "USE_MIXED_PRECISION", "False"])
    m = create_model(cfg)
    imgs = _images(4, (64, 32), 6).numpy()
    cams = np.array([0, 1, 2, 5])
    x = normalize_batch(torch.from_numpy(imgs), cfg.INPUT.PIXEL_MEAN,
                        cfg.INPUT.PIXEL_STD).permute(0, 3, 1, 2)
    with torch.no_grad():
        torch.testing.assert_close(m.embed(x, torch.from_numpy(cams)),
                                   m.embed(x), rtol=0, atol=0)
    fn = evaluate.make_embed_fn(m, cfg)
    torch.testing.assert_close(fn(imgs, cams), fn(imgs), rtol=0, atol=0)


def test_create_model_reads_the_heads_embedding_size(tiny, capsys):
    """The size warning reads the head's 5 x D (3,840 at ViT-B), not the
    ResNet table."""
    create_model(_cfg(**{"MODEL.BACKBONE_EMB_SIZE": "2048"}), cameras=6)
    assert f"backbone native {5 * D}; using {5 * D}" in capsys.readouterr().out
    create_model(_cfg(), cameras=6)
    assert "BACKBONE_EMB_SIZE" not in capsys.readouterr().out


def test_published_widths():
    """``vit_base_patch16_224_TransReID`` at 256x128, stride 12: a 21 x 10
    grid, 211 tokens, d 768, 12 heads, MLP 3072, 12 blocks in ``base``
    (11 run), a 3,840-d embedding."""
    cfg = _cfg(**{"INPUT.SIZE_TRAIN": "[256, 128]",
                  "INPUT.SIZE_TEST": "[256, 128]",
                  "MODEL.BACKBONE_EMB_SIZE": "3840"})
    m = create_model(cfg, cameras=6)
    pe = m.base.patch_embed
    assert (pe.num_y, pe.num_x) == (21, 10)
    assert m.base.pos_embed.shape == (1, 211, 768)
    assert m.base.sie_embed.shape == (6, 1, 768)
    assert len(m.base.blocks) == 12
    blk = m.base.blocks[0]
    assert blk.attn.num_heads == 12 and blk.mlp.fc1.out_features == 3072
    assert blk.norm1.eps == 1e-6 and m.emb_size == 3840


def _residual(rows=6, d=D, seed=7):
    """(x fp32 [2, rows, d], a branch fp32, the LayerNorm's weight and bias)
    with a per-row offset, as the residual stream has."""
    g = torch.Generator().manual_seed(seed)
    x = 2.0 * torch.randn(2, rows, d, generator=g) + torch.randn(
        2, rows, 1, generator=g)
    return (x, torch.randn(2, rows, d, generator=g),
            1.0 + 0.1 * torch.randn(d, generator=g),
            0.1 * torch.randn(d, generator=g))


@pytest.mark.parametrize("delta_dtype", [torch.float32, torch.bfloat16, None])
@pytest.mark.parametrize("y_dtype", [None, torch.float32, torch.bfloat16])
def test_add_norm_plain_is_todays_ops(delta_dtype, y_dtype):
    """``add_norm_plain`` (and ``add_norm`` on the CPU, which takes it and
    launches nothing) gives bit for bit ``x + delta``, ``F.layer_norm``
    and the cast; with no delta it returns x itself."""
    from centroids_reid_tpu_torch.ops import add_norm as K8
    from centroids_reid_tpu_torch.ops import launch_counts, reset_launch_counts

    x, b, w, bias = _residual()
    delta = None if delta_dtype is None else b.to(delta_dtype)
    s = x if delta is None else x + delta
    y = torch.nn.functional.layer_norm(s, (D,), w, bias, 1e-6)
    y = y if y_dtype is None else y.to(y_dtype)
    reset_launch_counts()
    for fn in (K8.add_norm_plain, K8.add_norm):
        got_s, got_y = fn(x, delta, w, bias, 1e-6, y_dtype)
        assert torch.equal(got_s, s) and got_s.dtype == torch.float32
        assert torch.equal(got_y, y) and got_y.dtype == y.dtype
        if delta is None:
            assert got_s is x
    assert launch_counts()["add_norm"] == 0


@pytest.mark.parametrize("delta", [True, False])
@pytest.mark.parametrize("y_dtype", [None, torch.bfloat16])
def test_add_norm_plain_on_a_bf16_stream(delta, y_dtype):
    """On a bf16 residual stream (bf16 x, branch, weight and bias, a
    model cast wholly to bf16) ``add_norm`` on the CPU is bit for bit the
    bf16 add and ``F.layer_norm``, whose output is bf16 (None)."""
    from centroids_reid_tpu_torch.ops import add_norm as K8
    from centroids_reid_tpu_torch.ops import launch_counts, reset_launch_counts

    x, b, w, bias = (t.bfloat16() for t in _residual())
    b = b if delta else None
    s = x if b is None else x + b
    y = torch.nn.functional.layer_norm(s, (D,), w, bias, 1e-6)
    reset_launch_counts()
    got_s, got_y = K8.add_norm(x, b, w, bias, 1e-6, y_dtype)
    assert got_s.dtype == torch.bfloat16 and torch.equal(got_s, s)
    assert got_y.dtype == torch.bfloat16 and torch.equal(got_y, y)
    assert launch_counts()["add_norm"] == 0


@pytest.mark.parametrize("fault", ["width", "x_dtype", "delta_shape",
                                   "y_dtype", "weight", "grad",
                                   "bf16_stream_fp32_delta",
                                   "weight_dtype", "bf16_stream_fp32_y"])
def test_add_norm_kernel_refuses(fault):
    """The kernel's wrapper refuses, before any launch, what K8 does not
    take: a width it is not built for, a residual stream other than fp32
    or bf16, a delta of another shape, y other than fp32 or bf16, a weight
    of another width, tensors that need a gradient (K8 has no backward),
    an fp32 delta on a bf16 stream (PyTorch would promote the sum to
    fp32), a weight of another type than the stream, and an fp32 y of a
    bf16 stream outside autocast (the eager LayerNorm's is bf16)."""
    from centroids_reid_tpu_torch.ops import add_norm as K8

    x, b, w, bias = _residual(d=768)
    args = {"x": x, "delta": b.to(torch.bfloat16), "weight": w,
            "bias": bias, "eps": 1e-6, "dtype": torch.bfloat16}
    err = ValueError
    if fault == "width":
        x, b, w, bias = _residual(d=640)
        args.update(x=x, delta=b, weight=w, bias=bias)
    elif fault == "x_dtype":
        args["x"], err = x.double(), TypeError
    elif fault == "delta_shape":
        args["delta"] = b[:, :3]
    elif fault == "y_dtype":
        args["dtype"], err = torch.float16, TypeError
    elif fault == "weight":
        args["weight"] = w[:384]
    elif fault == "bf16_stream_fp32_delta":
        args.update(x=x.bfloat16(), delta=b, weight=w.bfloat16(),
                    bias=bias.bfloat16())
    elif fault == "weight_dtype":
        args["weight"] = w.bfloat16()
    elif fault == "bf16_stream_fp32_y":
        args.update(x=x.bfloat16(), weight=w.bfloat16(),
                    bias=bias.bfloat16(), dtype=torch.float32)
        err = TypeError
    else:
        args["x"], err = x.requires_grad_(), RuntimeError
    with pytest.raises(err):
        K8._launch(**args)


@pytest.mark.parametrize("mixed", [False, True])
def test_block_forward_alone_is_unchanged(mixed):
    """``Block.forward`` called alone gives bit for bit the composition it
    had before the fused sites, ``x + attn(norm1(x))`` then ``+
    mlp(norm2(x))``, with and without bf16 autocast."""
    m = _model()
    blk = m.base.blocks[1]
    x = _residual(rows=46)[0]
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16,
                                         enabled=mixed):
        got = blk(x)
        h = x + blk.attn(blk.norm1(x))
        want = h + blk.mlp(blk.norm2(h))
    assert got.dtype == torch.float32
    assert torch.equal(got, want)


def test_bf16_block_forward_alone_is_unchanged():
    """A block cast wholly to bf16 (its residual stream too, as the
    benchmark's bf16 control runs it) gives bit for bit the eager
    composition in bf16."""
    blk = _model().base.blocks[1].bfloat16()
    x = _residual(rows=46)[0].bfloat16()
    with torch.no_grad():
        got = blk(x)
        h = x + blk.attn(blk.norm1(x))
        want = h + blk.mlp(blk.norm2(h))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


def test_trunk_counts_its_norm_sites():
    """At the published depth and geometry (256x128, 211 tokens; narrow
    widths for the CPU) ``vit.norms`` counts the rows of all 28 sites a
    batch: 25 over [B, 211] (11 blocks x 2, ``b1``'s 3) and ``b2``'s 3 over
    [4B, 53]; ``vit.norms_fused`` counts none on the CPU."""
    m = T.TransReIDModel(img_size=(256, 128), embed_dim=D, depth=12,
                         num_heads=HEADS, cameras=6)
    T.init_transreid(m, torch.Generator().manual_seed(5)).eval()
    imgs, cams = _images(2, (256, 128), 9), torch.tensor([1, 4])
    profiling.reset()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        _port(m, imgs, cams)
    counts = profiling.counts()
    profiling.reset()
    assert counts["vit.norms"] == 25 * 2 * 211 + 3 * 8 * 53
    assert counts.get("vit.norms_fused", 0) == 0


def _raises(fn, what):
    with pytest.raises(NotImplementedError, match=what):
        fn()


@pytest.mark.parametrize("path", ["fit", "service", "server", "int8",
                                  "int8_flow", "export", "jpm_off",
                                  "directory", "folder"])
def test_unported_paths_refuse(tiny, tmp_path, path):
    """Each path that does not run TransReID raises, naming what it
    lacks; none drops SIE or JPM silently."""
    cfg = _cfg()
    if path == "fit":
        from centroids_reid_tpu_torch.engine.fit import fit

        _raises(lambda: fit(cfg, "ctl", str(tmp_path), device="cpu"),
                "fit does not run TransReID.*not ported")
    elif path == "service":
        from centroids_reid_tpu_torch.inference.service import (
            RetrievalService,
        )

        _raises(lambda: RetrievalService(cfg, np.zeros((4, 5 * D),
                                                       np.float32),
                                         ["a", "b", "c", "d"],
                                         device="cpu",
                                         model=create_model(cfg, cameras=6)),
                "/search service.*camera id")
    elif path == "server":
        from centroids_reid_tpu_torch.inference.server import build_from_args

        opts = [str(v) for kv in {
            "MODEL.NAME": "transformer", "MODEL.JPM": "True"}.items()
            for v in kv]
        _raises(lambda: build_from_args(["--gallery_data", str(tmp_path),
                                         "--device", "cpu"] + opts),
                "HTTP server.*camera id")
    elif path == "int8":
        from centroids_reid_tpu_torch.models.quantized import (
            quantize_reid_model,
        )

        _raises(lambda: quantize_reid_model(create_model(cfg, cameras=6),
                                            [], MEAN, STD),
                "int8 quantization")
    elif path == "int8_flow":
        from centroids_reid_tpu_torch.models.quantized import (
            quantize_for_serving,
        )

        _raises(lambda: quantize_for_serving(cfg, create_model(cfg,
                                                               cameras=6),
                                             []),
                "int8 quantization")
    elif path == "export":
        from centroids_reid_tpu_torch.inference.export import export_embedder

        _raises(lambda: export_embedder(create_model(cfg, cameras=6), cfg,
                                        platforms=("cpu",)),
                "export.*camera id")
    elif path == "jpm_off":
        _raises(lambda: create_model(_cfg(**{"MODEL.JPM": "False"}),
                                     cameras=6),
                "MODEL.JPM True")
    elif path == "folder":
        from centroids_reid_tpu_torch.inference.api import build_embeddings

        _folder_setup(cfg, tmp_path, cameras=6)
        _raises(lambda: build_embeddings(cfg, False, device="cpu"),
                "folder embedding.*camera id")
    else:
        cfg.MODEL.PRETRAIN_PATH = str(tmp_path)
        _raises(lambda: _load(cfg), "checkpoint directory")


def _folder_setup(cfg, tmp_path, cameras):
    """A TransReID ``.pth`` and a folder of three images for the offline
    folder CLI (``build_embeddings``)."""
    from PIL import Image

    model = create_model(cfg, cameras=cameras,
                         generator=torch.Generator().manual_seed(4))
    path = tmp_path / "transformer_120.pth"
    torch.save(model.state_dict(), path)
    folder = tmp_path / "images"
    folder.mkdir()
    for i, img in enumerate(_images(3, (112, 64), 8).numpy()):
        Image.fromarray(img).save(folder / f"p{i}_c1.png")
    cfg.merge_from_list(["MODEL.PRETRAIN_PATH", str(path),
                         "DATASETS.ROOT_DIR", str(folder),
                         "OUTPUT_DIR", str(tmp_path / "out"),
                         "MODEL.USE_CENTROIDS", "False"])
    return model


def test_folder_embedding_runs_without_sie(tiny, tmp_path):
    """With ``SIE_CAMERA False`` no camera id is needed, so the folder CLI
    embeds: the 5 x D features the model gives on the same images."""
    from centroids_reid_tpu_torch.inference.api import build_embeddings

    cfg = _cfg(**{"MODEL.SIE_CAMERA": "False"})
    model = _folder_setup(cfg, tmp_path, cameras=0).eval()
    emb, paths = build_embeddings(cfg, False, device="cpu")
    assert emb.shape == (3, 5 * D) and len(paths) == 3
    imgs = _images(3, (112, 64), 8)
    torch.testing.assert_close(torch.from_numpy(emb), _port(model, imgs, None),
                               rtol=1e-5, atol=1e-5)


def _load(cfg):
    from centroids_reid_tpu_torch.inference.api import load_inference_model

    return load_inference_model(cfg, device="cpu")
