"""The MoE's dense fallback on a batch split over data ranks, against the
JAX package's ``moe_ffn`` on the global batch.

Under the rules JAX falls back to ``moe_ffn`` where the experts do not
split over 'model' (M <= 1, E % M, ``REPRO_MOE_DENSE``) and at a decode
step (S % M); GSPMD runs it on the global batch, so the capacity is the
global token count's and a pair drops by its rank among all the batch's
pairs to its expert. The port's data rank holds its rows only and places
its pairs from an all-gather of the ranks' per-expert counts
(``moe_ep.global_pairs``). Here D data ranks run in one process
(``moe_ffn_fallback_virtual``, the gather a stack): dbrx smoke with 8
experts, top-2 and capacity factor 0.5, so that about half of the pairs
drop; at 'model' 1 on a B 8 x S 128 batch and at a decode step (S 1) of
1024 rows with the experts held over 4 'model' ranks. The outputs,
concatenated, match JAX's within the moe tests' tolerance and the kept
(token, choice) pairs equal JAX's exactly; the rank-local dispatch, the
control, keeps other pairs.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.moe_ep import (held_ranks,  # noqa: E402
                                       moe_ffn_fallback_virtual)

#: test_torch_families.py's moe tolerance (f32)
ATOL, RTOL = 1e-4, 1e-4
#: the aux against JAX's (the same estimator, summed in another order)
AUX_ATOL = 1e-5
#: kind -> (B, S, 'model' ranks, seed)
CASES = {"m1": (8, 128, 1, 0), "held": (1024, 1, 4, 1)}
OVER = dict(n_experts=8, moe_topk=2, capacity_factor=0.5)


def _cfgs():
    return (jconfigs.get_config("dbrx-132b").smoke().scaled(**OVER),
            tconfigs.get_config("dbrx-132b").smoke().scaled(**OVER))


def _inputs(kind):
    """numpy (x, {router, wi, wo}, loss weights), f32."""
    B, S, _, seed = CASES[kind]
    _, cfg = _cfgs()
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    rng = np.random.RandomState(200 + seed)
    p = {"router": rng.randn(d, E).astype(np.float32),
         "wi": (rng.randn(E, d, 2 * f) / np.sqrt(d)).astype(np.float32),
         "wo": (rng.randn(E, f, d) / np.sqrt(f)).astype(np.float32)}
    return (rng.randn(B, S, d).astype(np.float32), p,
            rng.randn(B, S, d).astype(np.float32))


def _experts(p, requires_grad=False):
    _, cfg = _cfgs()
    e = moe.Experts(cfg, torch.device("cpu"))
    with torch.no_grad():
        for k, v in p.items():
            getattr(e, k).copy_(torch.from_numpy(v))
    return e.requires_grad_(requires_grad)


def _jax_global(kind):
    """JAX's moe_ffn on the global batch: (out, aux, kept (T, k) bool),
    the kept pairs read as moe_ffn places them (moe.py:79-86)."""
    jcfg, _ = _cfgs()
    x, p, _ = _inputs(kind)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    out, aux = jax_moe.moe_ffn(jcfg, jp, jnp.asarray(x))
    T, k = x.shape[0] * x.shape[1], jcfg.moe_topk
    _, topi, _ = jax_moe.route(jcfg, jp["router"],
                               jnp.asarray(x.reshape(T, -1)))
    e_flat = topi.reshape(-1)
    order = jnp.argsort(e_flat, stable=True)
    es = e_flat[order]
    starts = jnp.searchsorted(es, jnp.arange(jcfg.n_experts, dtype=es.dtype))
    rank = jnp.arange(T * k, dtype=jnp.int32) - starts[es].astype(jnp.int32)
    keep = rank < jax_moe.capacity(jcfg, T)
    kept = jnp.zeros(T * k, bool).at[order].set(keep).reshape(T, k)
    return np.asarray(out), float(aux), np.asarray(kept)


def _rank_local(kind, D):
    """The control: each data rank dispatches its own rows alone, its
    capacity from its own token count (the port before the exchange):
    (out, kept (T, k) bool)."""
    _, cfg = _cfgs()
    x, p, _ = _inputs(kind)
    M = CASES[kind][2]
    e = _experts(p)
    El = cfg.n_experts // M
    experts = [(e.wi[m * El:(m + 1) * El], e.wo[m * El:(m + 1) * El])
               for m in range(M)]
    outs, kept = [], []
    with torch.no_grad():
        for xr in torch.from_numpy(x).chunk(D):
            xt = xr.reshape(-1, cfg.d_model)
            outs.append(held_ranks(cfg, e.router, range(M), experts, xr,
                                   lambda parts: sum(parts[1:], parts[0]))[0])
            _, topi, _ = moe.route(cfg, e.router, xt)
            order, _, keep = moe.dispatch(cfg, topi,
                                          moe.capacity(cfg, xt.shape[0]))
            kept.append(moe.kept_pairs(order, keep, cfg.moe_topk))
    return torch.cat(outs).numpy(), torch.cat(kept).numpy()


@pytest.mark.parametrize("D", [1, 2, 8])
@pytest.mark.parametrize("kind", sorted(CASES))
def test_fallback_on_data_ranks_equals_jax_global(kind, D):
    """D data ranks' outputs, concatenated, match JAX's moe_ffn on the
    global batch; their kept pairs are JAX's exactly (about half of the
    pairs drop); aux is JAX's global estimator."""
    _, cfg = _cfgs()
    x, p, _ = _inputs(kind)
    want, want_aux, want_kept = _jax_global(kind)
    with torch.no_grad():
        out, aux, kept = moe_ffn_fallback_virtual(
            cfg, _experts(p), torch.from_numpy(x), D, CASES[kind][2])
    np.testing.assert_array_equal(kept.numpy(), want_kept)
    assert 0 < int((~want_kept).sum()) < want_kept.size
    np.testing.assert_allclose(out.numpy(), want, atol=ATOL, rtol=RTOL)
    assert abs(float(aux) - want_aux) <= AUX_ATOL


@pytest.mark.parametrize("D", [2, 8])
@pytest.mark.parametrize("kind", sorted(CASES))
def test_rank_local_dispatch_keeps_other_pairs(kind, D):
    """The control: with each rank's capacity from its own rows, the kept
    pairs and the output leave JAX's."""
    want, _, want_kept = _jax_global(kind)
    out, kept = _rank_local(kind, D)
    assert (kept != want_kept).any()
    assert int((~kept).sum()) != int((~want_kept).sum())
    assert not np.allclose(out, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("D", [2, 8])
def test_fallback_gradients_equal_jax_global(D):
    """The backward (``PlainSpanFn``'s recompute with the same slots)
    gives jax.grad of JAX's global moe_ffn: x by data rank, the router
    and the experts summed over the ranks."""
    jcfg, cfg = _cfgs()
    x, p, w = _inputs("m1")

    def jloss(jp, jx):
        return jnp.sum(jax_moe.moe_ffn(jcfg, jp, jx)[0] * w)

    jg = jax.grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    e = _experts(p, requires_grad=True)
    tx = torch.from_numpy(x).requires_grad_(True)
    out, _, _ = moe_ffn_fallback_virtual(cfg, e, tx, D)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[1]),
                               atol=ATOL, rtol=RTOL)
    for k in p:
        np.testing.assert_allclose(getattr(e, k).grad.numpy(),
                                   np.asarray(jg[0][k]), atol=ATOL,
                                   rtol=RTOL, err_msg=k)


def test_no_drop_fallback_equals_the_dense_dispatch():
    """Where nothing drops, the D ranks' dispatch is the dense one's on
    the whole batch, pair for pair."""
    _, cfg = _cfgs()
    roomy = dataclasses.replace(cfg, capacity_factor=8.0)
    x, p, _ = _inputs("m1")
    e, tx = _experts(p), torch.from_numpy(x)
    with torch.no_grad():
        want, _ = moe.moe_ffn(roomy, e, tx)
        out, _, kept = moe_ffn_fallback_virtual(roomy, e, tx, 8)
    assert bool(kept.all())
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-6,
                               rtol=1e-6)
