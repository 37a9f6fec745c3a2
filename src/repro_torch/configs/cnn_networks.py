"""The paper's five complete networks (§III.A / Fig. 14) as CNNConfigs,
plus the branching-topology configs (ResNet-18, U-Net mini) the DAG planner
exercises (DESIGN.md §11).

Layer stacks follow the canonical publications; batch sizes follow Table 1.
Branching networks are built by parameterized BUILDER functions
(``CNN_BUILDERS``) so ``reduced_cnn`` can downscale them without breaking
merge-shape consistency: a residual add needs both branches to agree on
(C, H, W) at every image size, which a naive ``replace(image_hw=...)``
cannot guarantee — the builder re-derives every skip edge instead.
"""
from repro_torch.configs.base import CNNConfig, ConvSpec
from repro_torch.shapes import conv_out_hw, pool_out_hw


def _conv(name, co, k, s=1, p=0, inputs=()):
    return ConvSpec(name, "conv", out_channels=co, kernel=k, stride=s, pad=p,
                    inputs=tuple(inputs))


def _pool(name, k, s, op="max"):
    return ConvSpec(name, "pool", kernel=k, stride=s, pool_op=op)


def _relu(name):
    return ConvSpec(name, "relu")


def _fc(name, out):
    return ConvSpec(name, "fc", fc_out=out)


LENET = CNNConfig(
    name="lenet", batch=128, in_channels=1, image_hw=28, num_classes=10,
    layers=(
        _conv("conv1", 16, 5, 1, 2), _relu("relu1"), _pool("pool1", 2, 2),
        _conv("conv2", 16, 5, 1, 2), _relu("relu2"), _pool("pool2", 2, 2),
        ConvSpec("flatten", "flatten"),
        _fc("fc1", 128), _relu("relu3"), _fc("fc2", 10),
        ConvSpec("softmax", "softmax"),
    ))

CIFARNET = CNNConfig(
    name="cifarnet", batch=128, in_channels=3, image_hw=24, num_classes=10,
    layers=(
        _conv("conv1", 64, 5, 1, 2), _relu("relu1"), _pool("pool1", 3, 2),
        _conv("conv2", 64, 5, 1, 2), _relu("relu2"), _pool("pool2", 3, 2),
        ConvSpec("flatten", "flatten"),
        _fc("fc1", 64), _relu("relu3"), _fc("fc2", 10),
        ConvSpec("softmax", "softmax"),
    ))

ALEXNET = CNNConfig(
    name="alexnet", batch=128, in_channels=3, image_hw=227, num_classes=1000,
    layers=(
        _conv("conv1", 96, 11, 4, 0), _relu("relu1"), _pool("pool1", 3, 2),
        _conv("conv2", 256, 5, 1, 2), _relu("relu2"), _pool("pool2", 3, 2),
        _conv("conv3", 384, 3, 1, 1), _relu("relu3"),
        _conv("conv4", 384, 3, 1, 1), _relu("relu4"),
        _conv("conv5", 256, 3, 1, 1), _relu("relu5"), _pool("pool3", 3, 2),
        ConvSpec("flatten", "flatten"),
        _fc("fc6", 4096), _relu("relu6"),
        _fc("fc7", 4096), _relu("relu7"),
        _fc("fc8", 1000),
        ConvSpec("softmax", "softmax"),
    ))

ZFNET = CNNConfig(
    name="zfnet", batch=64, in_channels=3, image_hw=224, num_classes=1000,
    layers=(
        _conv("conv1", 96, 7, 2, 1), _relu("relu1"), _pool("pool1", 3, 2),
        _conv("conv2", 256, 5, 2, 0), _relu("relu2"), _pool("pool2", 3, 2),
        _conv("conv3", 384, 3, 1, 1), _relu("relu3"),
        _conv("conv4", 384, 3, 1, 1), _relu("relu4"),
        _conv("conv5", 256, 3, 1, 1), _relu("relu5"), _pool("pool3", 3, 2),
        ConvSpec("flatten", "flatten"),
        _fc("fc6", 4096), _relu("relu6"),
        _fc("fc7", 4096), _relu("relu7"),
        _fc("fc8", 1000),
        ConvSpec("softmax", "softmax"),
    ))


def _vgg_block(i, co, n):
    layers = []
    for j in range(n):
        layers += [_conv(f"conv{i}_{j+1}", co, 3, 1, 1), _relu(f"relu{i}_{j+1}")]
    layers.append(_pool(f"pool{i}", 2, 2))
    return layers

VGG16 = CNNConfig(
    name="vgg16", batch=32, in_channels=3, image_hw=224, num_classes=1000,
    layers=tuple(
        _vgg_block(1, 64, 2) + _vgg_block(2, 128, 2) + _vgg_block(3, 256, 3)
        + _vgg_block(4, 512, 3) + _vgg_block(5, 512, 3)
        + [ConvSpec("flatten", "flatten"),
           _fc("fc6", 4096), _relu("relu6"),
           _fc("fc7", 4096), _relu("relu7"),
           _fc("fc8", 1000),
           ConvSpec("softmax", "softmax")]
    ))

CNN_CONFIGS = {c.name: c for c in (LENET, CIFARNET, ALEXNET, ZFNET, VGG16)}


# ---------------------------------------------------------------------------
# branching networks (DAG planner targets, DESIGN.md §11)
# ---------------------------------------------------------------------------

def _res_block(prefix, co, stride, skip, downsample):
    """One ResNet basic block (no BN in this stack — weights-only residual):
    convA -> reluA -> convB -> add(convB, skip') -> relu, with a 1x1/stride
    projection convS on the skip when the block changes shape.  Returns
    (layers, tail_name)."""
    layers = []
    skip2 = skip
    if downsample:
        layers.append(_conv(f"{prefix}_convS", co, 1, stride, 0,
                            inputs=(skip,)))
        skip2 = f"{prefix}_convS"
    layers += [
        _conv(f"{prefix}_convA", co, 3, stride, 1, inputs=(skip,)),
        _relu(f"{prefix}_reluA"),
        _conv(f"{prefix}_convB", co, 3, 1, 1),
        ConvSpec(f"{prefix}_add", "add",
                 inputs=(f"{prefix}_convB", skip2)),
        _relu(f"{prefix}_relu"),
    ]
    return layers, f"{prefix}_relu"


def build_resnet18(batch: int = 32, image_hw: int = 224,
                   num_classes: int = 1000, width: int = 64) -> CNNConfig:
    """ResNet-18 (residual-add family): stem conv7/2 + pool3/2, four stages
    of two basic blocks ([w, 2w, 4w, 8w] channels, stride-2 projection at
    each stage entry), global average pool, fc head."""
    layers = [_conv("conv1", width, 7, 2, 3), _relu("relu1"),
              _pool("pool1", 3, 2)]
    tail = "pool1"
    hw = pool_out_hw(conv_out_hw(image_hw, 7, 2, 3), 3, 2)
    for li, co in enumerate((width, 2 * width, 4 * width, 8 * width), 1):
        for bi in (1, 2):
            stride = 2 if (li > 1 and bi == 1) else 1
            blk, tail = _res_block(f"l{li}b{bi}", co, stride, tail,
                                   downsample=(stride != 1))
            layers += blk
            hw = conv_out_hw(hw, 3, stride, 1)
    layers += [_pool("gap", hw, hw, "avg"),
               ConvSpec("flatten", "flatten"),
               _fc("fc", num_classes),
               ConvSpec("softmax", "softmax")]
    return CNNConfig(name="resnet18", batch=batch, in_channels=3,
                     image_hw=image_hw, num_classes=num_classes,
                     layers=tuple(layers))


def build_unet_mini(batch: int = 8, image_hw: int = 32,
                    num_classes: int = 10, width: int = 8) -> CNNConfig:
    """Small U-Net (concat-skip family): two encoder levels, a middle conv,
    and two decoder levels whose upsampled features concat with the matching
    encoder activation, closed by a classification head (gap + fc) so it
    runs under the existing executors."""
    if image_hw % 4:
        raise ValueError(f"unet_mini needs image_hw % 4 == 0, "
                         f"got {image_hw}")
    w = width
    layers = [
        _conv("enc1", w, 3, 1, 1), _relu("enc1_relu"),
        _pool("pool1", 2, 2),
        _conv("enc2", 2 * w, 3, 1, 1), _relu("enc2_relu"),
        _pool("pool2", 2, 2),
        _conv("mid", 4 * w, 3, 1, 1), _relu("mid_relu"),
        ConvSpec("up2", "upsample", kernel=2),
        ConvSpec("cat2", "concat", inputs=("up2", "enc2_relu")),
        _conv("dec2", 2 * w, 3, 1, 1), _relu("dec2_relu"),
        ConvSpec("up1", "upsample", kernel=2),
        ConvSpec("cat1", "concat", inputs=("up1", "enc1_relu")),
        _conv("dec1", w, 3, 1, 1), _relu("dec1_relu"),
        _pool("gap", image_hw, image_hw, "avg"),
        ConvSpec("flatten", "flatten"),
        _fc("fc", num_classes),
        ConvSpec("softmax", "softmax"),
    ]
    return CNNConfig(name="unet_mini", batch=batch, in_channels=3,
                     image_hw=image_hw, num_classes=num_classes,
                     layers=tuple(layers))


# name -> builder(batch, image_hw, num_classes, width); reduced_cnn uses
# these to downscale branching topologies with consistent merge shapes
CNN_BUILDERS = {
    "resnet18": build_resnet18,
    "unet_mini": build_unet_mini,
}

RESNET18 = build_resnet18()
UNET_MINI = build_unet_mini()
CNN_CONFIGS[RESNET18.name] = RESNET18
CNN_CONFIGS[UNET_MINI.name] = UNET_MINI


def _first_conv_width(cfg: CNNConfig) -> int:
    return next(s.out_channels for s in cfg.layers if s.kind == "conv")


def reduced_cnn(cfg: CNNConfig, batch: int = 4) -> CNNConfig:
    """A smoke-test-sized variant: small batch, small images for big nets.

    Branching topologies go back through their builder so every skip edge is
    re-derived at the reduced size (merge shapes stay consistent); linear
    stacks keep the historical behaviour (shrink only batch + image, which
    preserves their legacy ``network_id`` fingerprints)."""
    builder = CNN_BUILDERS.get(cfg.name)
    hw = min(cfg.image_hw, 32)
    if builder is not None:
        width = min(_first_conv_width(cfg), 16)
        return builder(batch=batch, image_hw=hw,
                       num_classes=cfg.num_classes, width=width)
    # drop stride-heavy first convs cleanly by shrinking only batch + image
    return cfg.replace(batch=batch, image_hw=hw)
