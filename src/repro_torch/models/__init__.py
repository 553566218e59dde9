"""Model zoo: the dense family, rwkv6 (ssm), hymba (hybrid), moe,
encdec and vlm."""
from repro_torch.models.registry import build_model, prefix_len, side_inputs

__all__ = ["build_model", "prefix_len", "side_inputs"]
