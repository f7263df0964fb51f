"""--arch registry: maps arch ids to (ModelConfig, model module).

The port of ``repro.models.registry``.  The full-scale configs live in
``repro_torch.configs.<arch>``; :func:`get_module` wires the dense and vlm
families to :mod:`repro_torch.models.transformer` and raises
``NotImplementedError`` for the families the port does not run yet
(ROADMAP A.13b).
"""
from __future__ import annotations

import importlib

from . import transformer
from .config import SHAPES, ModelConfig

ARCHS = [
    "llava_next_34b",
    "zamba2_7b",
    "internlm2_20b",
    "qwen3_4b",
    "qwen3_8b",
    "glm4_9b",
    "deepseek_moe_16b",
    "mixtral_8x7b",
    "xlstm_1_3b",
    "seamless_m4t_medium",
]

def normalize(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{normalize(arch)}")
    return mod.CONFIG


def get_module(cfg: ModelConfig):
    transformer.check_family(cfg)
    return transformer


def shape_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """Whether an (arch × shape) cell runs, and why not."""
    if shape == "long_500k" and not cfg.subquadratic:
        return False, ("full quadratic attention with unbounded KV — "
                       "long_500k skipped (DESIGN.md §Arch-applicability)")
    return True, ""


def all_cells():
    """Every (arch, shape) cell with its applicability."""
    out = []
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES:
            ok, why = shape_applicable(cfg, shape)
            out.append((arch, shape, ok, why))
    return out
