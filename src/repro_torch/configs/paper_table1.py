"""The paper's Table 1: benchmark layer configurations (verbatim).

``ConvLayer`` and ``PoolLayer`` are the per-layer descriptors the layout
selector reads (``core.selector.LayerDesc``); ``SOFTMAX_LAYERS`` are the
twelve softmax shapes of Fig. 13.  Columns: Ni (batch), Co
(output channels), HW (input height=width), F (filter), Ci (input
channels), S (stride).  A copy of ``repro/configs/paper_table1.py``: the
classes keep the reference's names and fields, so their reprs agree letter
for letter.
"""
from dataclasses import dataclass

from repro_torch.shapes import conv_out_hw


@dataclass(frozen=True)
class ConvLayer:
    name: str
    N: int
    Co: int
    HW: int
    F: int
    Ci: int
    S: int
    net: str
    pad: int = 0        # Table 1 layers are unpadded; network configs set it

    @property
    def out_hw(self) -> int:
        return conv_out_hw(self.HW, self.F, self.S, self.pad)


@dataclass(frozen=True)
class PoolLayer:
    name: str
    N: int
    C: int
    HW: int
    F: int
    S: int
    net: str

    @property
    def overlapped(self) -> bool:
        return self.F > self.S


@dataclass(frozen=True)
class SoftmaxLayer:
    name: str
    N: int
    C: int          # number of categories


CONV_LAYERS = (
    ConvLayer("CV1", 128, 16, 28, 5, 1, 1, "lenet"),
    ConvLayer("CV2", 128, 16, 14, 5, 16, 1, "lenet"),
    ConvLayer("CV3", 128, 64, 24, 5, 3, 1, "cifar"),
    ConvLayer("CV4", 128, 64, 12, 5, 64, 1, "cifar"),
    ConvLayer("CV5", 64, 96, 224, 3, 3, 2, "zfnet"),
    ConvLayer("CV6", 64, 256, 55, 5, 96, 2, "zfnet"),
    ConvLayer("CV7", 64, 384, 13, 3, 256, 1, "zfnet"),
    ConvLayer("CV8", 64, 384, 13, 3, 384, 1, "zfnet"),
    ConvLayer("CV9", 32, 64, 224, 3, 3, 1, "vgg"),
    ConvLayer("CV10", 32, 256, 56, 3, 128, 1, "vgg"),
    ConvLayer("CV11", 32, 512, 28, 3, 256, 1, "vgg"),
    ConvLayer("CV12", 32, 512, 14, 3, 512, 1, "vgg"),
)

POOL_LAYERS = (
    PoolLayer("PL1", 128, 16, 28, 2, 2, "lenet"),
    PoolLayer("PL2", 128, 16, 14, 2, 2, "lenet"),
    PoolLayer("PL3", 128, 64, 24, 3, 2, "cifar"),
    PoolLayer("PL4", 128, 64, 12, 3, 2, "cifar"),
    PoolLayer("PL5", 128, 96, 55, 3, 2, "alexnet"),
    PoolLayer("PL6", 128, 192, 27, 3, 2, "alexnet"),
    PoolLayer("PL7", 128, 256, 13, 3, 2, "alexnet"),
    PoolLayer("PL8", 64, 96, 110, 3, 2, "zfnet"),
    PoolLayer("PL9", 64, 256, 26, 3, 2, "zfnet"),
    PoolLayer("PL10", 64, 256, 13, 3, 2, "zfnet"),
)

# Paper §VI Fig. 13: twelve (batch x categories) softmax configs.
SOFTMAX_LAYERS = tuple(
    SoftmaxLayer(f"SM_{n}x{c}", n, c)
    for n in (32, 64, 128)
    for c in (10, 100, 1000, 10000)
)

CONV_BY_NAME = {l.name: l for l in CONV_LAYERS}
POOL_BY_NAME = {l.name: l for l in POOL_LAYERS}

# Paper Table 1 / §VI ground truth: preferred layout per conv layer
# (CHWN for CV1-CV5 & CV9; NCHW for CV6-CV8 & CV10-CV12); pooling always CHWN.
PAPER_PREFERRED_CONV_LAYOUT = {
    "CV1": "CHWN", "CV2": "CHWN", "CV3": "CHWN", "CV4": "CHWN",
    "CV5": "CHWN", "CV9": "CHWN",
    "CV6": "NCHW", "CV7": "NCHW", "CV8": "NCHW",
    "CV10": "NCHW", "CV11": "NCHW", "CV12": "NCHW",
}
