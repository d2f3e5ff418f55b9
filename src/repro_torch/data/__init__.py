"""Data pipeline substrate."""

from repro_torch.data.pipeline import DataPipeline, synthetic_cifar, synthetic_lm_dataset
