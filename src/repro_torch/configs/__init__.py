"""Architecture registry of the LLM layer."""
from repro_torch.configs.archs import ARCHS, get_config, reduced

__all__ = ["ARCHS", "get_config", "reduced"]
