"""Config registry: ``get_config(arch_id)`` / ``get_smoke_config(arch_id)``.

Every arch id of the JAX package resolves here (both spellings:
``qwen2.5-3b`` / ``qwen25_3b``), and every one of them is ported.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      active_param_count,
                                      applicable_shapes, param_count,
                                      reduce_for_smoke, shape_applicability)

# every arch id the JAX package knows -> its config module name
_ARCH_MODULES: dict[str, str] = {
    "mistral-large-123b": "mistral_large_123b",
    "stablelm-3b": "stablelm_3b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "qwen2.5-3b": "qwen25_3b",
    "rwkv6-7b": "rwkv6_7b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "hubert-xlarge": "hubert_xlarge",
    "zamba2-7b": "zamba2_7b",
}

ARCH_IDS: tuple[str, ...] = tuple(_ARCH_MODULES)

# the arch ids whose config module exists in this package: all of them
PORTED: tuple[str, ...] = ("mistral-large-123b", "stablelm-3b",
                           "phi3-mini-3.8b", "qwen2.5-3b", "rwkv6-7b",
                           "zamba2-7b", "phi3.5-moe-42b-a6.6b",
                           "qwen3-moe-235b-a22b", "qwen2-vl-72b",
                           "hubert-xlarge")


def resolve_arch(arch: str) -> str:
    """Canonical arch id from any accepted spelling (``qwen2.5-3b``,
    ``qwen25_3b``, or any punctuation/case variant)."""
    if arch in _ARCH_MODULES:
        return arch

    def norm(s: str) -> str:
        return s.lower().replace("-", "").replace("_", "").replace(".", "")

    n = norm(arch)
    for key, mod in _ARCH_MODULES.items():
        if n in (norm(key), norm(mod)):
            return key
    raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")


def _module(arch: str):
    key = resolve_arch(arch)
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[key]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def runnable_cells() -> list[tuple[str, str]]:
    """The (arch, shape) pairs ``shape_applicability`` takes, in JAX's
    order (``repro/configs/__init__.py:74-81``)."""
    return [(a, s) for a in ARCH_IDS for s, shape in SHAPES.items()
            if shape_applicability(get_config(a), shape)[0]]


__all__ = ["ARCH_IDS", "PORTED", "SHAPES", "ModelConfig", "ShapeConfig",
           "active_param_count", "applicable_shapes", "get_config",
           "get_smoke_config", "param_count",
           "reduce_for_smoke", "resolve_arch", "runnable_cells",
           "shape_applicability"]
