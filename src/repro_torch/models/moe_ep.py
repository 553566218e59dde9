"""Expert-parallel MoE dispatch with an explicit all_to_all. Counterpart of
``repro/models/moe_ep.py``.

The token->expert shuffle is what it physically is: an all_to_all over
the expert-parallel ('model') axis, as JAX runs it inside ``shard_map``.
Each rank

  1. takes its block of tokens: its rows of the batch (the caller holds
     B/|batch axes| of them) and its 1/M of the sequence over the EP axis,
  2. routes them (local top-k, local capacity C),
  3. packs an (M, E/M, C, d) send buffer,
  4. exchanges it over the EP axis (tokens travel to their expert's rank),
  5. runs its E/M local experts over what it received,
  6. exchanges the results back and combines them with the gates,

and every rank returns the full sequence again (an all-gather over the EP
axis), which the layers around the FFN need. ``aux`` is the per-rank
Switch estimator averaged over all ranks (JAX's ``pmean``), without a
gradient across ranks: neither package's loss reads it.

Wire bytes a rank puts on the EP axis per layer and forward, with
n_tok = B/|batch| * S tokens of d_model elements: the exchanges
2 (M-1)/M E C d, and the sequence all-gather (M-1)/M n_tok d.

Three things differ from JAX's ``shard_fn``, none in the arithmetic:
- The router runs on the rank's whole sequence, and the rank takes its
  slice of the probabilities, gates and token rows (``SliceDim``, whose
  backward gathers the slices' gradients): a token's routing is its own,
  so the values are the slice's, and every model rank then holds the
  whole gradient of the router and of its input, as the layers around
  the FFN (repeated on every model rank) need.
- The combine adds each token's k values by rising expert id
  (``moe._combine``), where JAX scatter-adds them.
- The exchange is a callable: ``all_to_all_single`` over the EP group
  here; ``ep_ranks`` also runs M ranks in one process with the exchange
  done as the transpose the all_to_all performs.

Where JAX falls back to its dense ``moe_ffn`` under the rules (the
experts do not split: M <= 1 or E % M; ``REPRO_MOE_DENSE=1``; or S % M,
a decode step's one token), GSPMD runs it on the global batch: C is the
capacity of the global token count, and a pair is dropped by its rank
among all the batch's pairs to its expert, in global token order. A rank
here holds only its rows (B/|batch axes| of them; JAX's B % |batch| is
the caller's, ``train/sharded.py`` refuses a batch that does not
divide), so it does the same with one exchange (``global_pairs``): its
per-expert pair counts and routing-probability sums, all-gathered over
the batch axes in index order (rank r holds global rows r*B_loc...).
Each pair's global rank is the earlier ranks' count for its expert plus
its rank here; the rank computes its own kept pairs only, in a buffer of
min(C, T_loc) rows an expert, where JAX's (E, C, d) buffer is replicated
over 'data' (GSPMD's lowering, not a result); ``aux`` is JAX's Switch
estimator over the global batch. With one batch rank nothing is
exchanged: the dense ``moe_ffn`` as on one device. Where S % M, JAX's
fallback runs with the experts' weights and buffers split over
'experts' -> 'model': every model rank holds its data rank's tokens and
computes its E/M experts' rows of the buffer (``held_ranks``); the
ranks' gated outputs, at (token, choice) and zero for the other ranks'
experts, are summed over 'model' (exact: one rank's value and zeros)
and then added by rising expert id, so the result is the dense
dispatch's, bit for bit.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch import flags
from repro_torch.configs.base import ArchConfig
from repro_torch.models.moe import (Experts, _combine, _to_experts,
                                    capacity, dense_experts, dispatch,
                                    expert_compute, kept_pairs, moe_ffn,
                                    pair_values, route, route_probs,
                                    sum_rising, switch_aux)
from repro_torch.sharding import collectives as col
from repro_torch.sharding.params import batch_axes, held_over
from repro_torch.sharding.partition import (current_rules, mesh_axes,
                                            mesh_axis_size)

#: exchange(one (M, E/M, C, d) buffer per rank run here) -> what each of
#: those ranks receives, in the same layout
Exchange = Callable[[List[torch.Tensor]], List[torch.Tensor]]
#: gather(one (2, E) tensor per data rank run here) -> for each of those
#: ranks, the (D, 2, E) tensor of all D data ranks', in index order
Gather = Callable[[List[torch.Tensor]], List[torch.Tensor]]
#: one rank's (token, choice) pairs: (gates, topi, order, dest, keep), as
#: ``route_probs`` and ``moe.dispatch`` give them
Pairs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
              torch.Tensor]


def local_capacity(cfg: ArchConfig, t_loc: int) -> int:
    """JAX's local per-expert capacity, 8-aligned."""
    E, k = cfg.n_experts, cfg.moe_topk
    return max(8, int(-(-cfg.capacity_factor * t_loc * k / E // 8) * 8))


def _local_pack(cfg: ArchConfig, xt: torch.Tensor, topi: torch.Tensor,
                C: int):
    """The (E, C, d) send buffer of the local tokens xt (T, d) with their
    choices topi (T, k): (buffer, order, dest, keep), JAX's slots."""
    E, k = cfg.n_experts, cfg.moe_topk
    order, dest, keep = dispatch(cfg, topi, C)
    buf = _to_experts(xt, order // k, dest, E * C + 1)
    return buf[:-1].reshape(E, C, xt.shape[1]), order, dest, keep


def _expert_compute(cfg: ArchConfig, wi: torch.Tensor, wo: torch.Tensor,
                    recv: torch.Tensor) -> torch.Tensor:
    """recv (M, E/M, C, d), per source rank the tokens for this rank's
    experts -> their outputs in the same layout."""
    M, El, C, d = recv.shape
    y = expert_compute(cfg, wi, wo,
                       recv.transpose(0, 1).reshape(El, M * C, d))
    return y.reshape(El, M, C, d).transpose(0, 1).contiguous()


def ep_ranks(cfg: ArchConfig, router: torch.Tensor, ranks: Sequence[int],
             experts: Sequence[Tuple[torch.Tensor, torch.Tensor]],
             x: torch.Tensor, M: int, C: int, exchange: Exchange,
             split: Callable, join: Callable
             ) -> Tuple[torch.Tensor, List[torch.Tensor], torch.Tensor]:
    """The per-rank body for the EP ranks of index ``ranks``, whose local
    experts are ``experts`` (one (wi, wo) pair a rank, E/M experts each),
    all holding the rows x (B, S, d). ``split(t)`` gives each of those
    ranks its sequence slice of t (B, S, ...); ``join(outs)`` makes the
    full sequence of their outputs. Returns (join's output, [aux a rank],
    the number of (token, choice) pairs dropped, a tensor)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.moe_topk
    w = S // M
    probs, gates, topi = route_probs(cfg, router, x.reshape(B * S, d))
    probs, topi = probs.reshape(B, S, E), topi.reshape(B, S, k)
    packs, auxes = [], []
    for m, xr, gr in zip(ranks, split(x), split(gates.reshape(B, S, k))):
        ti = topi[:, m * w:(m + 1) * w].reshape(-1, k)
        auxes.append(switch_aux(
            cfg, probs[:, m * w:(m + 1) * w].reshape(-1, E), ti))
        packs.append((_local_pack(cfg, xr.reshape(-1, d), ti, C), gr, ti))
    recv = exchange([pk[0][0].reshape(M, E // M, C, d) for pk in packs])
    back = exchange([_expert_compute(cfg, wi, wo, rv)
                     for (wi, wo), rv in zip(experts, recv)])
    outs, dropped = [], 0
    for ((_, order, dest, keep), gr, ti), bk in zip(packs, back):
        out = _combine(bk.reshape(E * C, d), gr.reshape(-1, k), order, dest,
                       keep, ti, x.dtype)
        outs.append(out.reshape(B, w, d))
        dropped = dropped + (~keep).sum()
    return join(outs), auxes, dropped


def global_pairs(cfg: ArchConfig, router: torch.Tensor,
                 xts: Sequence[torch.Tensor], ranks: Sequence[int],
                 gather: Gather) -> Tuple[List[Pairs], torch.Tensor, int]:
    """JAX's dense dispatch of the global batch, placed for the data ranks
    of index ``ranks``, each holding its T tokens xts[i] (T, d) (data rank
    r the global tokens r*T ... (r+1)*T - 1). Each rank routes its tokens
    and sends its per-expert pair counts and routing-probability sums
    through ``gather``; C is the capacity of the D*T global tokens, and a
    pair is kept where the earlier ranks' pairs to its expert plus its
    rank here fall below C. Returns ([a rank's pairs], JAX's Switch aux
    over the global batch (no gradient), R): the pairs placed in a buffer
    of R = min(C, T) rows an expert, as a rank sends an expert at most
    one pair a token."""
    E, k = cfg.n_experts, cfg.moe_topk
    T = xts[0].shape[0]
    routed, stats = [], []
    for xt in xts:
        probs, gates, topi = route_probs(cfg, router, xt)
        ones = torch.ones(topi.numel(), dtype=torch.float64,
                          device=xt.device)
        counts = torch.zeros(E, dtype=torch.float64, device=xt.device
                             ).index_add_(0, topi.reshape(-1), ones)
        # counts in f64 are exact below 2^53 pairs
        stats.append(torch.stack([counts, probs.detach().sum(0).double()]))
        routed.append((gates, topi))
    every = gather(stats)
    D = every[0].shape[0]
    C = capacity(cfg, D * T)
    R = min(C, T)
    out = []
    for r, (gates, topi), got in zip(ranks, routed, every):
        offsets = got[:r, 0].sum(0).long()
        out.append((gates, topi, *dispatch(cfg, topi, C, offsets, R)))
    total = every[0].sum(0)
    aux = E * torch.sum(total[0] / (D * T * k) * (total[1] / (D * T)))
    return out, aux.float(), R


def virtual_gather(stats: List[torch.Tensor]) -> List[torch.Tensor]:
    """The all-gather among D data ranks run in one process."""
    return [torch.stack(stats)] * len(stats)


def mesh_gather(mesh, axes) -> Optional[Gather]:
    """The all-gather over the batch axes of this rank's one tensor; None
    where the batch does not split (one batch rank)."""
    if col.axis_size(mesh, axes) == 1:
        return None
    return lambda stats: [col.gather_dim(stats[0][None], mesh, axes, 0)]


def _held_experts(cfg: ArchConfig, ranks: Sequence[int],
                  experts: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                  xt: torch.Tensor, pairs: Pairs, R: int,
                  reduce: Callable) -> torch.Tensor:
    """The dense dispatch of xt (T, d) on the 'model' ranks of index
    ``ranks`` with their E/M experts: each computes its experts' rows of
    the (E, R, d) buffer and its pairs' gated outputs (zero for the other
    ranks' pairs); ``reduce`` sums the ranks' (T, k, d) values, added by
    rising expert id: (T, d)."""
    gates, topi, order, dest, keep = pairs
    k = cfg.moe_topk
    d = xt.shape[1]
    buf = _to_experts(xt, order // k, dest, cfg.n_experts * R + 1)[:-1]
    parts = []
    for m, (wi, wo) in zip(ranks, experts):
        El = wi.shape[0]
        rows = El * R
        y = expert_compute(cfg, wi, wo, buf[m * rows:(m + 1) * rows]
                           .reshape(El, R, d)).reshape(rows, d)
        mine = keep & (dest // rows == m)
        parts.append(pair_values(y, gates, order,
                                 torch.where(mine, dest - m * rows, rows),
                                 mine, topi, xt.dtype))
    return sum_rising(reduce(parts), topi)


def held_ranks(cfg: ArchConfig, router: torch.Tensor, ranks: Sequence[int],
               experts: Sequence[Tuple[torch.Tensor, torch.Tensor]],
               x: torch.Tensor, reduce: Callable, data_rank: int = 0,
               gather: Optional[Gather] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The dense dispatch of the tokens x (B, S, d), which every 'model'
    rank holds, on the ranks of index ``ranks`` with their E/M experts
    ``experts`` (one (wi, wo) pair a rank); ``reduce`` sums the ranks'
    values. With ``gather``, x is data rank ``data_rank``'s rows and the
    pairs are placed as in the global batch (``global_pairs``). Returns
    (out (B, S, d), aux, dropped pairs, a tensor)."""
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    if gather is None:
        C = capacity(cfg, T)
        gates, topi, aux = route(cfg, router, xt)
        pairs, R = (gates, topi, *dispatch(cfg, topi, C)), C
    else:
        (pairs,), aux, R = global_pairs(cfg, router, [xt], [data_rank],
                                        gather)
    out = _held_experts(cfg, ranks, experts, xt, pairs, R, reduce)
    return out.reshape(B, S, d), aux, (~pairs[4]).sum()


def _in_order(xs: List[torch.Tensor]) -> torch.Tensor:
    """The sum of the ranks' values in rank order."""
    out = xs[0]
    for t in xs[1:]:
        out = out + t
    return out


def moe_ffn_held(cfg: ArchConfig, p: Experts, x: torch.Tensor, M: int,
                 reduce: Callable = _in_order
                 ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """``held_ranks`` for M ranks run in one process, each rank's
    experts a slice of the whole weights; ``reduce`` the sum over them
    (default: in rank order). Returns (out, aux, dropped pairs)."""
    out, aux, dropped = held_ranks(cfg, p.router, range(M),
                                   _expert_slices(cfg, p, M), x, reduce)
    return out, aux, int(dropped)


def _expert_slices(cfg: ArchConfig, p: Experts, M: int
                   ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    El = cfg.n_experts // M
    return [(p.wi[m * El:(m + 1) * El], p.wo[m * El:(m + 1) * El])
            for m in range(M)]


def moe_ffn_fallback_virtual(cfg: ArchConfig, p: Experts, x: torch.Tensor,
                             D: int, M: int = 1
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """JAX's dense fallback on the global batch x (B, S, d), run as D data
    ranks in one process, each on its B/D rows (the exchange a stack),
    each data rank's experts over M 'model' ranks as at a decode step
    (M 1: every expert, as at 'model' 1). Returns (out (B, S, d), aux,
    the kept pairs (B*S, k) bool)."""
    B, S, d = x.shape
    if B % D or cfg.n_experts % M:
        raise ValueError(f"B {B} must divide by D {D}, E {cfg.n_experts} "
                         f"by M {M}")
    xts = [xr.reshape(-1, d) for xr in x.chunk(D)]
    pairs, aux, R = global_pairs(cfg, p.router, xts, range(D),
                                 virtual_gather)
    experts = _expert_slices(cfg, p, M)
    outs = [dense_experts(cfg, p.wi, p.wo, xt, *pr, R) if M == 1 else
            _held_experts(cfg, range(M), experts, xt, pr, R, _in_order)
            for xt, pr in zip(xts, pairs)]
    kept = torch.cat([kept_pairs(pr[2], pr[4], cfg.moe_topk)
                      for pr in pairs])
    return torch.cat(outs).reshape(B, S, d), aux, kept


def _local_experts(cfg: ArchConfig, p: Experts, mesh, ep_axis: str, M: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's E/M experts: the stored shard where the parameters are
    placed over the EP axis (``sharding.params``), else its slice of the
    whole tensors."""
    El = cfg.n_experts // M
    m = col.axis_index(mesh, ep_axis)
    out = []
    for name in ("wi", "wo"):
        w = held_over(p, name, ep_axis)
        if w is None:
            w = getattr(p, name)
        out.append(w[m * El:(m + 1) * El] if w.shape[0] != El else w)
    return out[0], out[1]


def virtual_exchange(bufs: List[torch.Tensor]) -> List[torch.Tensor]:
    """The all_to_all among M ranks run in one process: rank r receives
    chunk r of every rank's buffer, in rank order."""
    return list(torch.stack(bufs).transpose(0, 1).unbind(0))


def moe_ffn_ep_virtual(cfg: ArchConfig, p: Experts, x: torch.Tensor,
                       M: int) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The EP body of M ranks of one data rank, run in one process on x
    (B, S, d), the exchange a tensor transpose: (out, aux averaged over
    the M ranks, dropped pairs)."""
    B, S, _ = x.shape
    E = cfg.n_experts
    if E % M or S % M:
        raise ValueError(f"E {E} and S {S} must divide by M {M}")
    C = local_capacity(cfg, B * (S // M))
    experts = _expert_slices(cfg, p, M)
    out, auxes, dropped = ep_ranks(
        cfg, p.router, range(M), experts, x, M, C, virtual_exchange,
        lambda t: list(t.chunk(M, dim=1)), lambda outs: torch.cat(outs, 1))
    return out, torch.stack(auxes).mean(), int(dropped)


def _dense_fallback(cfg: ArchConfig, p: Experts, x: torch.Tensor, mesh,
                    batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's dense ``moe_ffn`` on the global batch, this rank's rows of
    it: the pairs placed by ``global_pairs`` over the batch axes, every
    expert here; ``moe_ffn`` itself where the batch does not split."""
    gather = mesh_gather(mesh, batch)
    if gather is None:
        return moe_ffn(cfg, p, x)
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    (pairs,), aux, R = global_pairs(cfg, p.router, [xt],
                                    [col.axis_index(mesh, batch)], gather)
    return dense_experts(cfg, p.wi, p.wo, xt, *pairs, R).reshape(B, S, d), \
        aux


def moe_ffn_ep(cfg: ArchConfig, p: Experts, x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE FFN under the active (mesh, rules), with the
    'experts' logical axis mapped to a mesh axis; JAX's dense fallback on
    the global batch otherwise, the dense ``moe_ffn`` with no rules. x:
    this rank's rows (B, S, d), the whole sequence; returns (out (B, S,
    d), aux)."""
    active = current_rules()
    if active is None:
        return moe_ffn(cfg, p, x)
    mesh, rules = active
    batch = batch_axes(mesh, rules)
    ep_axis = rules.get("experts")
    M = mesh_axis_size(mesh, ep_axis)
    if flags.moe_dense() or M <= 1 or cfg.n_experts % M:
        return _dense_fallback(cfg, p, x, mesh, batch)
    if isinstance(ep_axis, tuple):
        ep_axis = ep_axis[0]
    B, S, d = x.shape
    if S % M:
        out, aux, _ = held_ranks(
            cfg, p.router, [col.axis_index(mesh, ep_axis)],
            [_local_experts(cfg, p, mesh, ep_axis, M)], x,
            lambda parts: col.Reduce.apply(parts[0], mesh, ep_axis),
            col.axis_index(mesh, batch), mesh_gather(mesh, batch))
        return out, aux
    C = local_capacity(cfg, B * (S // M))
    out, auxes, _ = ep_ranks(
        cfg, p.router, [col.axis_index(mesh, ep_axis)],
        [_local_experts(cfg, p, mesh, ep_axis, M)], x, M, C,
        lambda bufs: [col.AllToAll.apply(bufs[0], mesh, ep_axis)],
        lambda t: [col.SliceDim.apply(t, mesh, ep_axis, 1)],
        lambda outs: col.GatherDim.apply(outs[0], mesh, ep_axis, 1, True))
    everyone = tuple(mesh_axes(mesh))
    aux = col.all_reduce_sum(auxes[0].detach(), mesh, everyone) / \
        col.axis_size(mesh, everyone)
    return out, aux
