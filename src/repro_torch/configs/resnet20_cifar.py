"""resnet20-cifar (copy of `repro/configs/resnet20_cifar.py`): the paper's
own evaluation network (Fig. 10 uses
ResNet20/CIFAR10 and ResNet18/ImageNet, both LSQ-quantized to 4 bit).

Used by the noise-tolerance benchmark; convolutions run through the TD
execution simulator via im2col (chain length 3*3*C matches the paper's
576 = 3x3x64 baseline decomposition).
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class ResNetCfg:
    name: str = "resnet20-cifar"
    stages: tuple = (16, 32, 64)
    blocks_per_stage: int = 3
    classes: int = 10
    img: int = 32


CONFIG = ResNetCfg()


def smoke() -> ResNetCfg:
    return ResNetCfg(name="resnet20-smoke", stages=(8, 16),
                     blocks_per_stage=1, classes=10, img=16)
