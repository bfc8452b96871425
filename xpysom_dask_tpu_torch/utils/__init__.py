from .envflags import env_flag
from .hw import (
    backend_kind,
    default_n_parallel,
    find_cpu_cores,
    inference_chunk,
    resolve_device,
    round_up,
    training_chunk,
)
from .progress import ProgressReporter

__all__ = [
    "env_flag",
    "find_cpu_cores",
    "backend_kind",
    "round_up",
    "default_n_parallel",
    "inference_chunk",
    "training_chunk",
    "resolve_device",
    "ProgressReporter",
]
