"""InternVL2-26b-shaped VLM (arXiv:2404.16821), counterpart of
``repro/models/vlm.py``. The InternViT frontend is a stub, as there: the
inputs carry precomputed patch embeddings (B, vis_tokens, vis_dim). A
2-layer MLP projector maps them into the LM's embedding space; they become
a prefix ahead of the text tokens, outside the loss, and the dense backbone
runs causally over [prefix, text]. Positions count the prefix, so a decode
step after a prompt of P text tokens is at position vis_tokens + P + i.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike
from repro_torch.models import common as cm
from repro_torch.models.transformer import (DecodeCache, TransformerLM,
                                            _Params)


class Projector(_Params):
    """ln (vis_dim,) f32, w1 (vis_dim, d), w2 (d, d)."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        self.add("ln", (cfg.vis_dim,), torch.float32, "ones", device)
        self.add("w1", (cfg.vis_dim, cfg.d_model), cfg.tdtype, "scaled",
                 device)
        self.add("w2", (cfg.d_model, cfg.d_model), cfg.tdtype, "scaled",
                 device)


class VlmLM(TransformerLM):
    """Patch-prefix VLM over the dense transformer backbone; decode_step is
    ``TransformerLM``'s."""

    def __init__(self, cfg: ArchConfig, *, device: DeviceLike = None,
                 attn_impl: str = "flash"):
        super().__init__(cfg, device=device, attn_impl=attn_impl)
        self.projector = Projector(cfg, self.embed.device)

    def project_patches(self, patches: torch.Tensor) -> torch.Tensor:
        p = self.projector
        x = cm.rms_norm(patches, p.ln) @ p.w1
        x = F.gelu(x.float(), approximate="tanh").to(x.dtype)
        return x @ p.w2

    def _embed_multimodal(self, batch: Dict[str, torch.Tensor]
                          ) -> torch.Tensor:
        text = self.embed_tokens(batch["tokens"])
        prefix = self.project_patches(batch["patches"])
        return torch.cat([prefix.to(text.dtype), text], dim=1)

    def logits(self, batch: Dict[str, torch.Tensor], *,
               remat: bool = True) -> torch.Tensor:
        """Logits over [prefix, text], (B, vis_tokens + S, V); ``loss``
        (``TransformerLM``'s) reads the last S, the text."""
        x = self._embed_multimodal(batch)
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        return self.unembed(self.backbone(x, positions, remat=remat))

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor],
                cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, DecodeCache]:
        """Prefix + prompt in one pass; the cache covers both, so
        ``cache_len`` counts the prefix too."""
        return self.prefill_embedded(self._embed_multimodal(batch),
                                     cache_len)
