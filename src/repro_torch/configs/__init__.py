"""Architecture registry (``repro.configs``).

Each ported architecture's module exposes, with the JAX package's values:
  CONFIG   — the full-scale ModelConfig
  REDUCED  — a same-family reduced config for CPU tests
  ARCH     — ArchSpec metadata

``ARCH_NAMES`` lists every architecture of the JAX package; asking for one
that the port does not carry yet raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import importlib

ARCH_NAMES = [
    "phi4-mini-3.8b",
    "qwen3-8b",
    "tinyllama-1.1b",
    "gemma3-1b",
    "olmoe-1b-7b",
    "deepseek-v3-671b",
    "llama-3.2-vision-90b",
    "seamless-m4t-large-v2",
    "rwkv6-3b",
    "jamba-1.5-large-398b",
]

PORTED = ("phi4-mini-3.8b", "qwen3-8b", "tinyllama-1.1b", "gemma3-1b",
          "olmoe-1b-7b", "deepseek-v3-671b")

SHAPES = {
    # name: (seq_len, global_batch, step kind)
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    supports_long: bool           # sub-quadratic attention for long_500k
    moment_dtype: str = "float32"
    notes: str = ""


def _module(name: str):
    if name not in ARCH_NAMES:
        raise KeyError(f"unknown architecture {name!r}")
    if name not in PORTED:
        raise NotImplementedError(
            f"architecture {name!r} is not ported to repro_torch yet "
            f"(ported: {', '.join(PORTED)})")
    return importlib.import_module(
        "repro_torch.configs." + name.replace("-", "_").replace(".", "_"))


def get_config(name: str):
    return _module(name).CONFIG


def get_reduced(name: str):
    return _module(name).REDUCED


def get_arch(name: str) -> ArchSpec:
    return _module(name).ARCH
