"""Architecture registry: --arch <id> -> ModelConfig."""

from importlib import import_module

ARCHS = {
    "llava-next-34b": "llava_next_34b",
    "qwen3-14b": "qwen3_14b",
    "yi-34b": "yi_34b",
    "starcoder2-3b": "starcoder2_3b",
    "yi-6b": "yi_6b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "mamba2-1.3b": "mamba2_1_3b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "grok-1-314b": "grok_1_314b",
    "zamba2-1.2b": "zamba2_1_2b",
}


def get_config(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return import_module(f"repro_torch.configs.{ARCHS[arch]}").config()


def all_archs():
    return list(ARCHS)
