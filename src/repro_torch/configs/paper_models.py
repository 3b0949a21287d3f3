"""The paper's own model families (§8.1): modified VGG-11 on CIFAR-10
(9,750,922 params) and modified ResNet-18 on FEMNIST (11,192,746 params).

CPU-scale reduced variants (width_mult < 1, smaller images) are used by the
benchmark harness; the full configs are expressible and shape-checked.
"""
from repro_torch.configs.base import CNNConfig

PAPER_VGG11_CIFAR10 = CNNConfig(
    name="paper-vgg11-cifar10",
    arch="vgg",
    in_channels=3,
    image_size=32,
    num_classes=10,
    width_mult=1.0,
    source="paper §8.1 (modified VGG-11, 9.75M params, CIFAR-10)",
)

PAPER_RESNET18_FEMNIST = CNNConfig(
    name="paper-resnet18-femnist",
    arch="resnet",
    in_channels=1,
    image_size=28,
    num_classes=62,
    width_mult=1.0,
    source="paper §8.1 (modified ResNet-18, 11.19M params, FEMNIST)",
)

# CPU-scale stand-ins used by benchmarks (same families, reduced width).
BENCH_CNN_CIFAR = CNNConfig(
    name="bench-vgg-small", arch="vgg", in_channels=3, image_size=16,
    num_classes=10, width_mult=0.125,
    source="reduced VGG family for CPU-scale reproduction",
)
BENCH_CNN_FEMNIST = CNNConfig(
    name="bench-resnet-small", arch="resnet", in_channels=1, image_size=14,
    num_classes=62, width_mult=0.25,
    source="reduced ResNet family for CPU-scale reproduction",
)
BENCH_MLP = CNNConfig(
    name="bench-mlp", arch="mlp", in_channels=1, image_size=8,
    num_classes=10, width_mult=1.0,
    source="tiny MLP for fast benchmark sweeps",
)
