"""Model zoo of the port: the attention decoders, dense and MoE, with
stub frontends and tied embeddings (`transformer`), the enc-dec family
(`encdec`), behind one API (`model_api`), and the paper's ResNet20-family
CNN (`resnet`)."""
from repro_torch.models import resnet
from repro_torch.models.model_api import get_api, matmul_shapes

__all__ = ["get_api", "matmul_shapes", "resnet"]
