from .benchmark import time_apply_chunked
from .weights import state_dict_from_jax

__all__ = ["state_dict_from_jax", "time_apply_chunked"]
