"""Deterministic, shard-aware synthetic token pipeline (the port of
``repro.data``, numpy only).

Every (step, dp_shard) pair maps statelessly to its batch slice via a
counter-based hash — so the pipeline is (a) resumable from any step with no
iterator state in checkpoints, (b) elastic: re-sharding to a different DP
width reproduces the identical global batch, (c) host-local: each host
generates only its addressable slice.
"""
from .pipeline import TokenPipeline

__all__ = ["TokenPipeline"]
