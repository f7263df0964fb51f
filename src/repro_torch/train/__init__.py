"""Training substrate (the port of ``repro.train``): a train step with
autograd, activation checkpointing, microbatch gradient accumulation,
loss/grad-norm metrics and optional int8-compressed gradients."""
from .step import TrainStepConfig, make_train_step

__all__ = ["TrainStepConfig", "make_train_step"]
