"""Optimizer substrate (the port of ``repro.optim``): AdamW with fp32
moments, written by hand, gradient clipping, LR schedules, and
error-feedback int8 gradient compression.

Parameters, gradients, moments and residuals are dicts of tensors keyed by
parameter name (:func:`named_tensors` of a module)."""
from .adamw import (AdamState, adamw_init, adamw_update, clip_by_global_norm,
                    named_tensors)
from .compress import (compress_grads_int8, decompress_grads_int8,
                       residuals_init)
from .schedule import cosine_schedule, linear_warmup

__all__ = [
    "AdamState", "adamw_init", "adamw_update", "clip_by_global_norm",
    "cosine_schedule", "linear_warmup", "named_tensors",
    "compress_grads_int8", "decompress_grads_int8", "residuals_init",
]
