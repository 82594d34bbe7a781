"""Checkpoints: template-shaped trees and self-describing array dicts."""
from repro_torch.checkpoint.io import (CheckpointError, latest_step,
                                       load_array_dict, load_checkpoint,
                                       save_array_dict, save_checkpoint)
