from .envflags import env_flag, env_tristate
from .hw import default_n_parallel, inference_chunk, resolve_device, training_chunk
from .progress import ProgressReporter

__all__ = [
    "env_flag",
    "env_tristate",
    "default_n_parallel",
    "inference_chunk",
    "training_chunk",
    "resolve_device",
    "ProgressReporter",
]
