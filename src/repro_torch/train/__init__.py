"""Serving steps (the training step arrives with the training slice)."""
from repro_torch.train.step import make_prefill_step, make_serve_step

__all__ = ["make_prefill_step", "make_serve_step"]
