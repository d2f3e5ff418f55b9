"""Model substrate (PyTorch): functional models over dict-of-tensor param trees."""

from repro_torch.models.config import ModelConfig
from repro_torch.models.resnet import ResNet
from repro_torch.models.transformer import LM
