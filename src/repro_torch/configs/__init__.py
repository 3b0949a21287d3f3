from repro_torch.configs.base import (ChannelConfig, CNNConfig,
                                      CompressionSchedule, ModelConfig,
                                      MoEConfig, PFELSConfig, SSMConfig)
from repro_torch.configs.paper_models import (BENCH_CNN_CIFAR,
                                              BENCH_CNN_FEMNIST, BENCH_MLP,
                                              PAPER_RESNET18_FEMNIST,
                                              PAPER_VGG11_CIFAR10)
from repro_torch.configs.registry import (ARCHS, get_config, list_archs,
                                          reduced_config)
from repro_torch.configs.shapes import (DECODE_32K, LONG_500K, PREFILL_32K,
                                        SHAPES, TRAIN_4K, InputShape)

__all__ = ["ChannelConfig", "CNNConfig", "CompressionSchedule",
           "ModelConfig", "MoEConfig", "PFELSConfig", "SSMConfig",
           "BENCH_CNN_CIFAR", "BENCH_CNN_FEMNIST", "BENCH_MLP",
           "PAPER_RESNET18_FEMNIST", "PAPER_VGG11_CIFAR10", "ARCHS",
           "get_config", "list_archs", "reduced_config", "SHAPES",
           "InputShape", "TRAIN_4K", "PREFILL_32K", "DECODE_32K",
           "LONG_500K"]
