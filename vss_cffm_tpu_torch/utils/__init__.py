from .benchmark import time_apply_chunked
from .weights import load_torch_state_dict, state_dict_from_jax

__all__ = ["state_dict_from_jax", "load_torch_state_dict", "time_apply_chunked"]
