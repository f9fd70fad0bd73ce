"""Model zoo of the port: the dense decoder (qwen3 family) so far."""
from repro_torch.models.model_api import get_api, matmul_shapes

__all__ = ["get_api", "matmul_shapes"]
