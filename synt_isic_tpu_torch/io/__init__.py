from .convert import state_dict_from_jax
from .pth import load_checkpoint, save_checkpoint, unwrap_state_dict

__all__ = ["load_checkpoint", "save_checkpoint", "unwrap_state_dict",
           "state_dict_from_jax"]
