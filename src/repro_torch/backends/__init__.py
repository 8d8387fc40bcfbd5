"""Backend registry of the port: one record per lowering target."""
from repro_torch.backends.registry import (names, register, resolve,
                                           resolve_calibrated)
from repro_torch.backends.spec import Backend, UnsupportedBackendError
from repro_torch.backends.seeds import (CUDA_STREAM, SEED_BACKENDS, TORCH,
                                        TORCH_STAGED)

__all__ = [
    "Backend", "UnsupportedBackendError",
    "register", "resolve", "resolve_calibrated", "names",
    "TORCH", "TORCH_STAGED", "CUDA_STREAM", "SEED_BACKENDS",
]
