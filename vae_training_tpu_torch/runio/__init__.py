from .checkpoint import checkpoint_exists, restore_checkpoint, save_checkpoint
from .export import (
    from_reference_state_dict,
    load_model_pkl,
    save_model_pkl,
    state_from_flax,
    to_reference_state_dict,
)
from .outdir import get_output_dir, make_output_dir

__all__ = [
    "checkpoint_exists", "restore_checkpoint", "save_checkpoint",
    "from_reference_state_dict", "load_model_pkl", "save_model_pkl",
    "state_from_flax", "to_reference_state_dict", "get_output_dir",
    "make_output_dir",
]
