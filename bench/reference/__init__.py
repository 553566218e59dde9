"""Plain PyTorch references of the benchmark's model families, in float32
with TF32 off. They import nothing of the program: each module holds its
family's weight layout (``leaves``), its forward pass and its loss, written
from the published description and the configuration file. They are handed
the benchmark's weights and tokens and work out everything else again.

``precision`` "f32" is the reference; "fp8" rounds both operands of every
matrix product to float8 e4m3 (a scale per tensor, gradients passed
straight through): the control, the reference computed one precision below
the configuration's bfloat16.
"""
from __future__ import annotations

from collections.abc import Mapping
from types import ModuleType

import torch

from bench.cell import family_module

PRECISIONS = ("f32", "fp8")


def family(name: str) -> ModuleType:
    """The reference module of a configuration's ``family``: the file
    ``reference/<family>.py``, so a family is added as a file."""
    return family_module("reference", name)


def exact_float32() -> None:
    """float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 with one scale for the tensor (its largest
    magnitude at 448), the gradient passed through unchanged."""
    s = 448.0 / t.detach().abs().amax().clamp_min(1e-12)
    q = (t.detach() * s).to(torch.float8_e4m3fn).to(t.dtype) / s
    return t + (q - t.detach())


def matmul(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        return fp8(x) @ fp8(w)
    if precision != "f32":
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    return x @ w


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * scale


def padded_vocab(c) -> int:
    m = c.get("pad_vocab_to") or 1
    return -(-c["vocab"] // m) * m


def head_dim(c) -> int:
    return c.get("head_dim") or c["d_model"] // c["n_heads"]


def cross_entropy(logits: torch.Tensor, tokens: torch.Tensor
                  ) -> torch.Tensor:
    """Mean next-token cross entropy: position t predicts token t + 1, the
    last position of each row predicts nothing."""
    lp = torch.log_softmax(logits[:, :-1], dim=-1)
    return -lp.gather(-1, tokens[:, 1:, None].long()).mean()


def params(sd, grad: bool):
    """The reference's float32 copy of the benchmark's weights (a name ->
    tensor mapping), as leaves that take gradients where ``grad``."""
    return {n: t.detach().float().requires_grad_(grad) for n, t in sd.items()}


class Float32View(Mapping):
    """The benchmark's weights (a name -> tensor mapping) as float32 leaves
    that take no gradient: each leaf is upcast when it is read and freed
    once its reader lets it go, so no float32 copy of the whole model is
    held. A leaf reads as the same numbers as in ``params(sd, False)``."""

    def __init__(self, sd):
        self.sd = sd

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.sd[name].detach().float()

    def __iter__(self):
        return iter(self.sd)

    def __len__(self) -> int:
        return len(self.sd)
