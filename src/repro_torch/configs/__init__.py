"""Architecture configs the port runs.  Each module exposes ``full()`` (the
published configuration) and ``smoke()`` (a reduced same-family config for
CPU tests).  Select with ``--arch <id>`` in the launchers, or
``get_config(id)`` here.

Only the families the port has are registered; any other id raises, and
ROADMAP.md says where its family waits.
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "zamba2_7b", "rwkv6_1_6b", "minitron_4b", "internlm2_20b",
    "qwen2_5_32b", "llama3_405b", "mixtral_8x22b", "deepseek_v3_671b",
]

# canonical dashed names from the assignment table
ALIASES = {
    "zamba2-7b": "zamba2_7b", "rwkv6-1.6b": "rwkv6_1_6b",
    "minitron-4b": "minitron_4b", "internlm2-20b": "internlm2_20b",
    "qwen2.5-32b": "qwen2_5_32b", "llama3-405b": "llama3_405b",
    "mixtral-8x22b": "mixtral_8x22b", "deepseek-v3-671b": "deepseek_v3_671b",
}


def get_config(arch: str, variant: str = "full"):
    mod_name = ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))
    if mod_name not in ARCH_IDS:
        raise ValueError(
            f"architecture {arch!r} is not ported to repro_torch (it has "
            f"{', '.join(ALIASES)}); ROADMAP.md, queue 1 (the LM stack), "
            f"lists where its family waits")
    if variant not in ("full", "smoke"):
        raise ValueError(f"variant must be 'full' or 'smoke', got {variant!r}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return getattr(mod, variant)()


def all_archs() -> list[str]:
    return list(ALIASES.keys())
