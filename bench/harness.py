"""What the drivers share: the run's context, the program's model built from
the configuration file and loaded with the benchmark's weights, and the
check of served tokens against the reference."""
from __future__ import annotations

import dataclasses
import gc
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from bench import reference, weights
from bench.cell import Cell

@dataclasses.dataclass
class Context:
    cell: Cell
    seed: int
    device: torch.device
    #: "fp8": the reference one precision down stands in for the program
    control: Optional[str] = None
    #: a fault planted in the stand-in (training: "half_batch")
    fault: Optional[str] = None

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    def ref(self):
        return reference.family(self.config["family"])

    def weights(self) -> Dict[str, torch.Tensor]:
        """The run's weights, made anew from the seed."""
        return weights.make(self.ref().leaves(self.config), self.seed,
                            self.device)

    def tokens(self, shape, *what) -> torch.Tensor:
        """int32 tokens uniform over the vocabulary, one stream per
        ``what``."""
        return torch.randint(0, self.config["vocab"], shape,
                             generator=weights.generator(
                                 self.device, self.seed, *what),
                             device=self.device,
                             dtype=torch.int32)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def arch_config(config: Mapping):
    """The program's ArchConfig of a configuration file: every key that
    names one of its fields, JSON lists as tuples. The other keys (source,
    reduced, assumed, departures, deployment, rms_norm_eps, max_positions)
    are the reference's alone."""
    from repro_torch.configs.base import ArchConfig
    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    return ArchConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in config.items() if k in fields})


def program_model(ctx: Context):
    """The program's model of the configuration, its weights loaded from
    the benchmark's state dict."""
    from repro_torch.models import build_model
    model = build_model(arch_config(ctx.config), device=ctx.device)
    sd = ctx.weights()
    model.load_state_dict(sd, strict=True)
    del sd
    return model


# ------------------------------------------------------ serving checks --
@dataclasses.dataclass
class Served:
    """One finished request: its prompt's stream and row, its prompt
    length, and the tokens served."""
    stream: tuple
    rows: int
    row: int
    prompt_len: int
    tokens: List[int]


def sample(served: Sequence[Served], seed: int, n: int) -> List[Served]:
    """n finished requests drawn from the seed, the one with the longest
    sequence always among them."""
    if not served:
        return []
    rng = np.random.default_rng(weights.derive(seed, "sample"))
    longest = max(range(len(served)),
                  key=lambda i: served[i].prompt_len + len(served[i].tokens))
    rest = [i for i in range(len(served)) if i != longest]
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [served[longest]] + [served[rest[i]] for i in sorted(pick)]


def logit_gaps(ctx: Context, picked: Sequence[Served]) -> Dict[str, float]:
    """Run the reference once over each picked prompt with its served
    tokens. ``logit_gap``: the widest gap by which a served token's
    reference logit lies below the reference's best at its position. With
    a control, the gap of the token the control puts first at each of the
    same positions instead. The reference reads the served weights through
    a float32 view: the served weights, one leaf in float32 and the
    reference's activations are held at a time."""
    ref = ctx.ref()
    reference.exact_float32()
    P = reference.Float32View(ctx.weights())
    free(ctx.device)
    worst, n = 0.0, 0
    for s in picked:
        prompt = ctx.tokens((s.rows, s.prompt_len), *s.stream)[s.row]
        served = torch.tensor(s.tokens, dtype=torch.int32, device=ctx.device)
        seq = torch.cat([prompt, served[:-1]])
        at = torch.arange(s.prompt_len - 1, len(seq), device=ctx.device)
        lg = ref.logits_at(ctx.config, P, seq, at)
        if ctx.control:
            served = ref.logits_at(ctx.config, P, seq, at,
                                   ctx.control).argmax(-1)
        best = lg.max(-1).values
        gap = best - lg.gather(-1, served.long()[:, None])[:, 0]
        worst = max(worst, gap.max().item())
        n += len(s.tokens)
    del P
    free(ctx.device)
    return {"logit_gap": worst, "tokens_compared": n}


def finished(batch_tokens: torch.Tensor, gens: Sequence[int], stream: tuple,
             prompt_len: int) -> List[Served]:
    """The requests of one finished batch: (B, steps) tokens on the host,
    request b served ``gens[b]`` of them."""
    rows = batch_tokens.shape[0]
    return [Served(stream, rows, b, prompt_len,
                   batch_tokens[b, :g].tolist()) for b, g in enumerate(gens)]

