"""Architecture configs the port runs: all ten of the JAX package's.  Each
module exposes ``full()`` (the published configuration) and ``smoke()`` (a
reduced same-family config for CPU tests).  Select with ``--arch <id>`` in
the launchers, or ``get_config(id)`` here; an unknown id raises.
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "zamba2_7b", "rwkv6_1_6b", "minitron_4b", "internlm2_20b",
    "qwen2_5_32b", "llama3_405b", "mixtral_8x22b", "deepseek_v3_671b",
    "musicgen_large", "qwen2_vl_2b",
]

# canonical dashed names from the assignment table
ALIASES = {
    "zamba2-7b": "zamba2_7b", "rwkv6-1.6b": "rwkv6_1_6b",
    "minitron-4b": "minitron_4b", "internlm2-20b": "internlm2_20b",
    "qwen2.5-32b": "qwen2_5_32b", "llama3-405b": "llama3_405b",
    "mixtral-8x22b": "mixtral_8x22b", "deepseek-v3-671b": "deepseek_v3_671b",
    "musicgen-large": "musicgen_large", "qwen2-vl-2b": "qwen2_vl_2b",
}


def get_config(arch: str, variant: str = "full"):
    mod_name = ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))
    if mod_name not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch!r}; known: "
                         f"{', '.join(ALIASES)}")
    if variant not in ("full", "smoke"):
        raise ValueError(f"variant must be 'full' or 'smoke', got {variant!r}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return getattr(mod, variant)()


def all_archs() -> list[str]:
    return list(ALIASES.keys())
