"""Architecture registry: ``--arch <id>`` resolution.

Only the architectures whose family the port serves are listed; the other
arch modules of ``repro.configs`` come with the slices that port their
families.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ArchConfig

_ARCH_MODULES = {
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "deepseek-coder-33b": "repro_torch.configs.deepseek_coder_33b",
    "internlm2-20b": "repro_torch.configs.internlm2_20b",
    "glm4-9b": "repro_torch.configs.glm4_9b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2_7b",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b_a22b",
}


def arch_ids() -> List[str]:
    return list(_ARCH_MODULES)


def get_arch(name: str) -> ArchConfig:
    if name.endswith("-smoke"):
        return get_arch(name[: -len("-smoke")]).reduced()
    try:
        mod = importlib.import_module(_ARCH_MODULES[name])
    except KeyError as e:
        raise KeyError(
            f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}"
        ) from e
    return mod.CONFIG
