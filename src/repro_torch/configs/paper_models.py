"""The paper's own evaluation models (section 8, Appendix B): the port's
copy of ``repro/configs/paper_models.py``.

- MNIST-MLP3: 3-layer MLP on 28x28 grayscale, 10 classes.
- CIFAR10-CNN6: 6-layer CNN on 32x32x3, 10 classes.
- CIFAR10-WRN28: 28-layer WideResNet (widen factor 4 by default).

Their models are in ``models/small.py``.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class MLPConfig:
    name: str = "mnist-mlp3"
    input_dim: int = 784
    hidden: tuple[int, ...] = (256, 128)
    n_classes: int = 10


@dataclass(frozen=True)
class CNNConfig:
    name: str = "cifar10-cnn6"
    image_hw: int = 32
    in_channels: int = 3
    channels: tuple[int, ...] = (32, 32, 64, 64, 128, 128)  # 6 conv layers
    n_classes: int = 10


@dataclass(frozen=True)
class WRNConfig:
    name: str = "cifar10-wrn28"
    image_hw: int = 32
    in_channels: int = 3
    depth: int = 28  # 28 = 6n+4 -> n=4 blocks per group
    widen: int = 4
    n_classes: int = 10


MNIST_MLP3 = MLPConfig()
CIFAR10_CNN6 = CNNConfig()
CIFAR10_WRN28 = WRNConfig()
