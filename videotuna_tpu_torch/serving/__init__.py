"""Serving of the port: step-level continuous batching."""

from videotuna_tpu_torch.serving.continuous import ContinuousBatchEngine

__all__ = ["ContinuousBatchEngine"]
