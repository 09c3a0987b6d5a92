"""Models of the port: the JAX package's zoo (``bluefog_tpu/models``)."""

from bluefog_tpu_torch.models.resnet import (ResNet, ResNet18, ResNet34,
                                             ResNet50, ResNet101, ResNet152)
from bluefog_tpu_torch.models.simple import (MLP, LeNet5, LinearModel,
                                             LogisticRegression)
from bluefog_tpu_torch.models.transformer import (TransformerConfig,
                                                  TransformerLM,
                                                  local_attention)
from bluefog_tpu_torch.models.vgg import VGG, VGG11, VGG16, VGG19
from bluefog_tpu_torch.models.vit import ViT

__all__ = ["ResNet", "ResNet18", "ResNet34", "ResNet50", "ResNet101",
           "ResNet152", "LeNet5", "MLP", "LogisticRegression", "LinearModel",
           "TransformerConfig", "TransformerLM", "local_attention", "VGG",
           "VGG11", "VGG16", "VGG19", "ViT"]
