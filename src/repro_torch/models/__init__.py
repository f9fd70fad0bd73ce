"""Model zoo of the port: the dense decoder (qwen3 family) and the
paper's ResNet20-family CNN (`resnet`)."""
from repro_torch.models import resnet
from repro_torch.models.model_api import get_api, matmul_shapes

__all__ = ["get_api", "matmul_shapes", "resnet"]
