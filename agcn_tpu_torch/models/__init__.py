from agcn_tpu_torch.models.aagcn import AAGCN
from agcn_tpu_torch.models.aagcn_transformer import AAGCNTransformer
from agcn_tpu_torch.models.agcn import AGCN, STGCNBlock, UnitGCN, UnitTCN
from agcn_tpu_torch.models.registry import build_model

__all__ = ["AAGCN", "AAGCNTransformer", "AGCN", "STGCNBlock", "UnitGCN",
           "UnitTCN", "build_model"]
