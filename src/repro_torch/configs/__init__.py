"""Architecture registry: ``--arch <id>`` resolves here."""
from .base import ModelConfig, SHAPES  # noqa

from .qwen3_8b import CONFIG as qwen3_8b
from .gemma_2b import CONFIG as gemma_2b
from .llama3_8b import CONFIG as llama3_8b
from .qwen3_1p7b import CONFIG as qwen3_1p7b
from .qwen2_vl_7b import CONFIG as qwen2_vl_7b
from .olmoe_1b_7b import CONFIG as olmoe_1b_7b
from .arctic_480b import CONFIG as arctic_480b
from .hubert_xlarge import CONFIG as hubert_xlarge
from .jamba_1p5_large import CONFIG as jamba_1p5_large
from .mamba2_2p7b import CONFIG as mamba2_2p7b

ARCHS = {
    "qwen3-8b": qwen3_8b,
    "gemma-2b": gemma_2b,
    "llama3-8b": llama3_8b,
    "qwen3-1.7b": qwen3_1p7b,
    "qwen2-vl-7b": qwen2_vl_7b,
    "olmoe-1b-7b": olmoe_1b_7b,
    "arctic-480b": arctic_480b,
    "hubert-xlarge": hubert_xlarge,
    "jamba-1.5-large-398b": jamba_1p5_large,
    "mamba2-2.7b": mamba2_2p7b,
}


def get_arch(name: str) -> ModelConfig:
    return ARCHS[name]
