"""--arch registry: maps architecture ids to their assigned configs.

Port of ``src/repro/configs/registry.py``; the ten configs beside it are
copies of the reference's.  The port's model serves all ten: the dense
attention kinds (``global``, ``local``, ``chunk``), the recurrent ``rglru``
and ``ssd`` kinds, MoE layers, ``cross`` layers, the encoder and the
frontends (see ``repro_torch.models.transformer``).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ArchConfig, reduced

_MODULES = {
    "gemma3-12b": "repro_torch.configs.gemma3_12b",
    "llama-3.2-vision-11b": "repro_torch.configs.llama_3_2_vision_11b",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
    "chatglm3-6b": "repro_torch.configs.chatglm3_6b",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick_400b_a17b",
    "qwen2.5-14b": "repro_torch.configs.qwen2_5_14b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "mamba2-780m": "repro_torch.configs.mamba2_780m",
}

ARCH_IDS = tuple(_MODULES)

#: input shapes assigned to this paper
SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, mode="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, mode="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, mode="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, mode="decode"),
}

#: archs with a sub-quadratic long-context story (see DESIGN.md) —
#: the only ones that run long_500k.
LONG_CONTEXT_ARCHS = (
    "gemma3-12b", "recurrentgemma-9b", "starcoder2-3b",
    "llama4-maverick-400b-a17b", "mixtral-8x22b", "mamba2-780m",
)


def get_config(arch_id: str) -> ArchConfig:
    mod = importlib.import_module(_MODULES[arch_id])
    return mod.CONFIG


def get_reduced_config(arch_id: str, **kw) -> ArchConfig:
    return reduced(get_config(arch_id), **kw)


def shape_supported(arch_id: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch_id in LONG_CONTEXT_ARCHS
    return True
