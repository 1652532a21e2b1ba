"""ResNet / ResNet-IBN-a backbones (NCHW; channels_last works).

Counterpart of ``centroids_reid_tpu/models/resnet.py``, with the module and
parameter names of the reference torch backbones, so reference state dicts
load key for key. Behavioural quirks kept from the reference:

* the plain ResNet omits the stem ReLU; IBN-a keeps it;
* ``last_stride`` sets the stride of layer4 (1 in the re-id configs);
* IBN-a splits ``bn1`` of the bottlenecks of layers 1-3 into InstanceNorm
  on the first half of the channels and BatchNorm on the rest.

The space-to-depth stem of the JAX package (``TPU.SPACE_TO_DEPTH_STEM``) is
not ported: it computes the same function as the 7x7 stride-2 stem.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn


class IBN(nn.Module):
    """InstanceNorm (affine, no running stats) on channels [:C//2],
    BatchNorm on [C//2:]."""

    def __init__(self, planes: int):
        super().__init__()
        self.half = planes // 2
        self.IN = nn.InstanceNorm2d(self.half, affine=True, eps=1e-5)
        self.BN = nn.BatchNorm2d(planes - self.half, eps=1e-5)

    def forward(self, x):
        a, b = torch.split(x, [self.half, x.shape[1] - self.half], dim=1)
        return torch.cat([self.IN(a.contiguous()), self.BN(b.contiguous())], 1)


def _conv(cin: int, cout: int, kernel: int, stride: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2,
                     bias=False)


def _downsample(cin: int, cout: int, stride: int) -> nn.Sequential:
    return nn.Sequential(_conv(cin, cout, 1, stride), nn.BatchNorm2d(cout))


class BasicBlock(nn.Module):
    """Two 3x3 convs. Used by resnet18/34."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None, use_ibn: bool = False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, 1)
        self.bn2 = nn.BatchNorm2d(planes)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(out + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1; ``bn1`` is the IBN split when
    ``use_ibn``."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None, use_ibn: bool = False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1, 1)
        self.bn1 = IBN(planes) if use_ibn else nn.BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = _conv(planes, planes * 4, 1, 1)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(out + residual)


class ResNet(nn.Module):
    """ResNet trunk without avgpool/fc: conv1 -> bn1 -> [relu] -> maxpool ->
    layer1..4."""

    def __init__(self, block=Bottleneck, layers: Sequence[int] = (3, 4, 6, 3),
                 last_stride: int = 1, ibn: bool = False,
                 stem_relu: bool = False):
        super().__init__()
        self.stem_relu = stem_relu
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes = 64
        strides = (1, 2, 2, last_stride)
        for stage, nblocks in enumerate(layers):
            planes = 64 * 2 ** stage
            use_ibn = ibn and planes != 512  # layer4 keeps plain BN
            blocks = []
            for b in range(nblocks):
                stride = strides[stage] if b == 0 else 1
                ds = None
                if b == 0 and (stride != 1
                               or inplanes != planes * block.expansion):
                    ds = _downsample(inplanes, planes * block.expansion, stride)
                blocks.append(block(inplanes, planes, stride, ds, use_ibn))
                inplanes = planes * block.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, x):
        x = self.bn1(self.conv1(x))
        if self.stem_relu:
            x = self.relu(x)
        x = self.maxpool(x)
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))


_ARCHS = {
    "resnet18": dict(block=BasicBlock, layers=(2, 2, 2, 2), ibn=False, emb=512),
    "resnet34": dict(block=BasicBlock, layers=(3, 4, 6, 3), ibn=False, emb=512),
    "resnet50": dict(block=Bottleneck, layers=(3, 4, 6, 3), ibn=False, emb=2048),
    "resnet101": dict(block=Bottleneck, layers=(3, 4, 23, 3), ibn=False, emb=2048),
    "resnet152": dict(block=Bottleneck, layers=(3, 8, 36, 3), ibn=False, emb=2048),
    "resnet50_ibn_a": dict(block=Bottleneck, layers=(3, 4, 6, 3), ibn=True, emb=2048),
    "resnet101_ibn_a": dict(block=Bottleneck, layers=(3, 4, 23, 3), ibn=True, emb=2048),
    "resnet152_ibn_a": dict(block=Bottleneck, layers=(3, 8, 36, 3), ibn=True, emb=2048),
}


def backbone_emb_size(name: str) -> int:
    return _ARCHS[name]["emb"]


def build_backbone(name: str, last_stride: int = 1) -> ResNet:
    if name not in _ARCHS:
        raise ValueError(f"Unknown backbone {name}; options: {sorted(_ARCHS)}")
    spec = _ARCHS[name]
    return ResNet(block=spec["block"], layers=spec["layers"],
                  last_stride=last_stride, ibn=spec["ibn"],
                  stem_relu=spec["ibn"])


def random_init_(module: nn.Module, generator: torch.Generator) -> None:
    """The reference random init, drawn from ``generator``: conv weights
    N(0, sqrt(2 / (k*k*out_channels))), norm weights 1 and biases 0."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            n = m.kernel_size[0] * m.kernel_size[1] * m.out_channels
            with torch.no_grad():
                m.weight.normal_(0.0, math.sqrt(2.0 / n), generator=generator)
        elif isinstance(m, (nn.BatchNorm2d, nn.BatchNorm1d, nn.InstanceNorm2d)):
            if m.weight is not None:
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
