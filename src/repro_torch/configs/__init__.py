from repro_torch.configs.base import (ChannelConfig, CNNConfig,
                                      CompressionSchedule, PFELSConfig)
from repro_torch.configs.paper_models import (BENCH_CNN_CIFAR,
                                              BENCH_CNN_FEMNIST, BENCH_MLP,
                                              PAPER_RESNET18_FEMNIST,
                                              PAPER_VGG11_CIFAR10)

__all__ = ["ChannelConfig", "CNNConfig", "CompressionSchedule",
           "PFELSConfig", "BENCH_CNN_CIFAR", "BENCH_CNN_FEMNIST",
           "BENCH_MLP", "PAPER_RESNET18_FEMNIST", "PAPER_VGG11_CIFAR10"]
