"""Architecture registry of the LLM layer, the assigned input shapes and
the dry-run's matrix (the reference's `repro/configs/__init__.py`)."""
from repro_torch.configs.archs import ARCHS, get_config, reduced
from repro_torch.configs.shapes import INPUT_SHAPES, InputShape, get_shape

ASSIGNED_ARCHS = (
    "kimi-k2-1t-a32b", "llama3-405b", "gemma3-12b", "jamba-v0.1-52b",
    "llama3-8b", "xlstm-125m", "mixtral-8x22b", "chameleon-34b",
    "whisper-large-v3", "yi-34b",
)

# (arch, shape) pairs excluded from the dry-run matrix, with reasons
DRYRUN_SKIPS = {
    ("whisper-large-v3", "long_500k"):
        "enc-dec with <=448-token decoder spec and no sub-quadratic mode; "
        "524k-token self-attention decode is not meaningful for this "
        "family",
}

__all__ = ["ARCHS", "ASSIGNED_ARCHS", "DRYRUN_SKIPS", "INPUT_SHAPES",
           "InputShape", "get_config", "get_shape", "reduced"]
