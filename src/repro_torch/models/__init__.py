"""Model zoo: the dense family, rwkv6 (ssm) and hymba (hybrid)."""
from repro_torch.models.registry import build_model

__all__ = ["build_model"]
