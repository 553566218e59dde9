"""The sharded train step: ``make_train_step`` on a ("data", "model") or
("pod", "data", "model") mesh, the counterpart of JAX's step jitted with
``in_shardings`` from ``tree_shardings`` and the ZeRO-1 state of
``opt_state_axes`` (``repro/launch/dryrun.py::lower_cell``).

Each rank runs, per step:
- its rows of each of the ``n_micro`` microbatches (microbatch m is rows
  [m B/n, (m+1) B/n) of the global batch, split over the batch axes:
  JAX's ``shard_map`` view of its scan), through the model whose
  parameters ``sharding.params.place`` stored as pieces and gathers per
  layer; the MoE FFN goes expert-parallel (``models.moe_ep``) under the
  rules;
- the gradients summed over the batch axes by ``make_grad_allreduce``
  (hierarchical where the mesh has a 'pod' axis), in one flat f32 buffer,
  and divided by the number of batch ranks. A tensor-parallel leaf
  (``sharding.tp``: every family's attention, MLP, vocab and head blocks
  over 'model') has the gradient of its piece, summed over the batch
  axes alone; the per-head leaves a tensor-parallel block holds whole
  (``tp.PARTIAL``: the qk-norm scales, and rwkv6's ``w0``/``u`` and
  hymba's ``wdt``/``a_log``/``dt_bias`` where the heads do not divide by
  M) act on the rank's heads only, so their gradients are summed over
  'model' too;
- AdamW with ZeRO-1: each 'data' rank updates its slice of m, v and the
  parameter (the dim ``zero1_leaf_axes`` puts 'fsdp' on), then the slices
  are all-gathered over 'data'.

ZeRO-1 on the stacked ``layers`` dim: for 8 leaves of the production
configs the stacked leaf's largest free dim is ``layers``. The port holds
one tensor a layer and cannot split that dim, so layer l's state and
update for such a leaf belong to 'data' rank l mod D, whole; the updated
layers are all-gathered over 'data', the owned layers of each rank
stacked (L divides by D, which is why ``zero1_leaf_axes`` chose that dim).

The global gradient norm adds each leaf's sums of squares once: a rank
contributes a leaf's sums only at index 0 of every axis the leaf's
gradient is repeated over; the sums go through one all-reduce and are
added in the single-device order. On a (1, 1) mesh every collective
moves nothing and the step gives the single-device step's bits.

Gradient compression (``compress_grads``) is not supported here.
"""
from __future__ import annotations

import collections
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.convert import stacked_depths
from repro_torch.sharding import collectives as col
from repro_torch.sharding import tp as tpm
from repro_torch.sharding.params import (Placement, batch_axes, place,
                                         stored, whole_params)
from repro_torch.sharding.partition import Rules, mesh_axes, use_rules
from repro_torch.train.optimizer import (adamw_leaf, adamw_scalars, decays,
                                         piece_sums, zero1_leaf_axes)
from repro_torch.train.step import TrainConfig, accumulate_grads


def _layer_of(cfg, name: str) -> Optional[Tuple[str, int, int]]:
    """(stack, layer index, depth) of a layer leaf's name, else None."""
    parts = name.split(".")
    depths = stacked_depths(cfg)
    if len(parts) > 2 and parts[0] in depths and parts[1].isdigit():
        return parts[0], int(parts[1]), depths[parts[0]]
    return None


def zero1_split(cfg, name: str, pl: Placement, mesh, rules: Rules):
    """How the ZeRO-1 state of one parameter splits over the fsdp axes:
    None (whole on every rank), ("dim", k) or ("layers", owner index)."""
    spec = pl.spec
    layer = _layer_of(cfg, name)
    if layer is not None:
        z = zero1_leaf_axes(spec.stacked(layer[2]), mesh, rules)
        if z[0] == "fsdp":
            fs = col.axis_size(mesh, fsdp_axes(mesh, rules))
            return ("layers", layer[1] % fs)
        z = z[1:]
    else:
        z = zero1_leaf_axes(spec, mesh, rules)
    return ("dim", z.index("fsdp")) if "fsdp" in z else None


def fsdp_axes(mesh, rules: Rules) -> Tuple[str, ...]:
    f = rules.get("fsdp")
    f = (f,) if isinstance(f, str) else tuple(f or ())
    return tuple(a for a in f if a in mesh_axes(mesh))


class ShardedTraining:
    """A model placed on ``mesh`` for training: the placements, the
    ZeRO-1 splits and the tensors that hold the parameters here. Every
    rank builds it from the same (initialised) parameters, then takes
    ``init_opt_state`` and ``make_step``."""

    def __init__(self, model, mesh, rules: Rules):
        self.model, self.mesh, self.rules = model, mesh, rules
        self.batch = batch_axes(mesh, rules)
        self.b_size = col.axis_size(mesh, self.batch)
        if not set(self.batch) <= {"pod", "data"} or (
                self.batch and "data" not in self.batch):
            raise ValueError(f"batch axes {self.batch}: the gradient "
                             f"all-reduce runs over ('pod', 'data')")
        self.fsdp = fsdp_axes(mesh, rules)
        self.D = col.axis_size(mesh, self.fsdp)
        self.d = col.axis_index(mesh, self.fsdp)
        self.plan = place(model, mesh, rules)
        self.params = {n: stored(model, n) for n in self.plan}
        self.partial = tpm.partial_leaves(model)
        self.zero1 = {n: zero1_split(model.cfg, n, pl, mesh, rules)
                      for n, pl in self.plan.items()}

    # ------------------------------------------------------------ state --
    def mine(self, name: str) -> bool:
        """Whether this rank holds (and updates) leaf ``name``'s state."""
        z = self.zero1[name]
        return z is None or z[0] == "dim" or z[1] == self.d

    def state_shape(self, name: str) -> Tuple[int, ...]:
        shape = list(self.params[name].shape)
        z = self.zero1[name]
        if z is not None and z[0] == "dim":
            shape[z[1]] //= self.D
        return tuple(shape)

    def init_opt_state(self, state_dtype: str = "float32") -> Dict[str, Any]:
        """Zero moments of this rank's ZeRO-1 slices, step 0."""
        dt = getattr(torch, state_dtype)
        mv = {n: torch.zeros(self.state_shape(n), dtype=dt, device=p.device)
              for n, p in self.params.items() if self.mine(n)}
        dev = next(iter(self.params.values())).device
        return {"m": mv, "v": {n: torch.zeros_like(t) for n, t in mv.items()},
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def whole(self) -> Dict[str, torch.Tensor]:
        """Every parameter whole, in JAX's layout (the tensor-parallel
        pieces gathered): what a checkpoint saves. Every rank calls it."""
        return whole_params(self.model, self.plan)

    # ------------------------------------------------------------- step --
    def rows(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's rows of the global batch (or of a microbatch)."""
        if not self.batch:
            return batch
        out = {}
        for k, x in batch.items():
            if x.shape[0] % self.b_size:
                raise ValueError(f"batch {k} of {x.shape[0]} rows does not "
                                 f"split over {self.batch} ({self.b_size})")
            out[k] = col.chunk_dim(x, self.mesh, self.batch, 0)
        return out

    def reduce(self, grads: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        """Sum the gradients over the batch axes their storage does not
        already sum over, in one flat f32 buffer per set of axes, and
        divide by the number of batch ranks."""
        buckets = collections.defaultdict(list)
        for n, pl in self.plan.items():
            axes = {a for a in self.batch if a not in pl.axes()}
            if n in self.partial:
                axes.add(tpm.AXIS)
            buckets[tuple(a for a in mesh_axes(self.mesh) if a in axes)
                    ].append(n)
        out = {}
        for axes, names in buckets.items():
            flat = torch.cat([grads[n].float().reshape(-1) for n in names])
            if axes == self.batch and axes:
                D = col.axis_size(self.mesh, "data")
                size = flat.numel()
                flat = torch.nn.functional.pad(flat, (0, -size % D))
                flat = col.make_grad_allreduce(self.mesh)({"g": flat})["g"]
            elif axes:
                flat = col.all_reduce_sum(flat, self.mesh, axes)
            off = 0
            for n in names:
                g = grads[n]
                out[n] = flat[off:off + g.numel()].view(g.shape)
                if self.b_size > 1:
                    out[n] = out[n] / self.b_size
                off += g.numel()
        return {n: out[n] for n in self.plan}

    def global_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        sums = []
        for n, pl in self.plan.items():
            once = all(col.axis_index(self.mesh, a) == 0
                       for a in mesh_axes(self.mesh) if a not in pl.axes())
            for s in piece_sums(grads[n]):
                sums.append(s if once else torch.zeros_like(s))
        vec = col.all_reduce_sum(torch.stack(sums), self.mesh,
                                 tuple(mesh_axes(self.mesh)))
        return torch.sqrt(sum(vec.unbind(0)))

    @torch.no_grad()
    def update(self, cfg, opt_state: Dict[str, Any],
               grads: Dict[str, torch.Tensor], gnorm: torch.Tensor):
        sc = adamw_scalars(cfg, opt_state["step"], gnorm)
        owned = collections.defaultdict(list)
        for n, p in self.params.items():
            z = self.zero1[n]
            wd = cfg.weight_decay > 0 and decays(n, p)
            if z is not None and z[0] == "layers":
                layer = _layer_of(self.model.cfg, n)
                key = (layer[0], n.split(".", 2)[2])
                owned[key].append((layer[1], n))
                if z[1] != self.d:
                    continue
            if z is not None and z[0] == "dim":
                k = z[1]
                size = p.shape[k] // self.D
                part = p.narrow(k, self.d * size, size).contiguous()
                adamw_leaf(cfg, wd, part, grads[n].narrow(
                    k, self.d * size, size).contiguous(),
                    opt_state["m"][n], opt_state["v"][n], sc)
                p.copy_(col.gather_dim(part, self.mesh, self.fsdp, k))
            else:
                adamw_leaf(cfg, wd, p, grads[n], opt_state["m"][n],
                           opt_state["v"][n], sc)
        for _, layers in sorted(owned.items()):
            # rank r owns layers r, r + D, ...: gather each rank's stack;
            # layer l lands at (l mod D) * (L / D) + l // D
            layers.sort()
            mine = [self.params[n] for l, n in layers if l % self.D == self.d]
            full = col.gather_dim(torch.stack(mine), self.mesh, self.fsdp, 0)
            per = len(layers) // self.D
            for l, n in layers:
                self.params[n].copy_(full[(l % self.D) * per + l // self.D])
        opt_state["step"] = sc["step"]
        return opt_state, {"grad_norm": gnorm, "lr": sc["lr"]}

    def grads(self, tcfg: TrainConfig, batch: Dict[str, torch.Tensor]):
        """The step's first half: (loss, metrics, gradients of the stored
        pieces) on this rank's rows of each microbatch of the global
        batch, under the rules."""
        with use_rules(self.mesh, self.rules):
            return accumulate_grads(self.model, self.params, tcfg, batch,
                                    rows=self.rows)

    def apply(self, tcfg: TrainConfig, opt_state: Dict[str, Any], loss,
              metrics: Dict[str, torch.Tensor],
              grads: Dict[str, torch.Tensor]):
        """The second half: reduce the gradients, the ZeRO-1 AdamW and the
        metrics over the batch axes."""
        grads = self.reduce(grads)
        gnorm = self.global_norm(grads)
        opt_state, opt_metrics = self.update(tcfg.opt, opt_state, grads,
                                             gnorm)
        del grads
        if self.batch:
            loss = col.all_reduce_sum(loss, self.mesh,
                                      self.batch) / self.b_size
        metrics = dict(metrics, **opt_metrics, loss=loss)
        if "tokens" in metrics and self.batch:
            metrics["tokens"] = col.all_reduce_sum(metrics["tokens"],
                                                   self.mesh, self.batch)
        return opt_state, metrics

    def make_step(self, tcfg: TrainConfig) -> Callable:
        if tcfg.compress_grads:
            raise ValueError("the sharded step has no gradient compression")

        def train_step(opt_state: Dict[str, Any],
                       batch: Dict[str, torch.Tensor]):
            loss, metrics, grads = self.grads(tcfg, batch)
            return self.apply(tcfg, opt_state, loss, metrics, grads)

        return train_step

