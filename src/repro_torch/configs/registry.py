"""Architecture registry: ``--arch <id>`` resolution for the port's
launchers: every architecture of the reference."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "unimo-text": "repro_torch.configs.unimo_text",
    "qwen3-4b": "repro_torch.configs.qwen3_4b",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
    "phi3-mini-3.8b": "repro_torch.configs.phi3_mini_3_8b",
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "gemma3-27b": "repro_torch.configs.gemma3_27b",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b_a22b",
    "internvl2-1b": "repro_torch.configs.internvl2_1b",
    "musicgen-medium": "repro_torch.configs.musicgen_medium",
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
}

# the archs the dry run sweeps (``launch/dryrun.py --all``): every one but
# the paper's own unimo-text, as in the reference
ASSIGNED: List[str] = [a for a in _MODULES if a != "unimo-text"]


def get_config(arch: str) -> ModelConfig:
    return importlib.import_module(_MODULES[arch]).config()


def get_reduced(arch: str) -> ModelConfig:
    return importlib.import_module(_MODULES[arch]).reduced()


def list_archs() -> List[str]:
    return list(_MODULES)
