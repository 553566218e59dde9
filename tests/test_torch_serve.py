"""The port's JoSS router and serving flow against the JAX package's
router and the flow of examples/serve_lm.py."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.topology import VirtualCluster as JaxCluster  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serve import JossServeRouter as JaxRouter  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.train import make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.topology import VirtualCluster  # noqa: E402
from repro_torch.serve import JossServeRouter, Request  # noqa: E402
from repro_torch.serve.lm import route_requests, serve  # noqa: E402


def _stream(seed, n=60, pods=4):
    """A request stream with fresh, recurring and session-less requests,
    completions and pod failures, as (op, args) tuples."""
    rng = np.random.RandomState(seed)
    ops, live = [], []
    for i in range(n):
        u = rng.rand()
        if u < 0.1:
            ops.append(("fail", int(rng.randint(pods))))
        elif u < 0.3 and live:
            ops.append(("complete", live.pop(int(rng.randint(len(live))))))
        else:
            sess = None if rng.rand() < 0.2 else f"s{rng.randint(8)}"
            args = (f"r{i}", sess, int(rng.randint(1, 600)),
                    int(rng.randint(1, 64)))
            ops.append(("route", args))
            live.append(args)
    return ops


def _drive(router, request_cls, ops):
    out, pod_of = [], {}
    for op, args in ops:
        if op == "route":
            d = router.route(request_cls(*args))
            pod_of[args[0]] = d.pod
            out.append((d.rid, d.pod, d.policy, d.cache_hit))
        elif op == "complete":
            router.complete(request_cls(*args), pod_of[args[0]])
        else:
            out.append(("lost", sorted(router.pod_failed(args))))
        out.append(dict(router.load))
    return out, router.cache_hit_rate(), router.load_imbalance()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape", [[4, 4], [2, 3, 5, 1]])
def test_router_matches_jax_router(seed, shape):
    ops = _stream(seed, pods=len(shape))
    got = _drive(JossServeRouter(VirtualCluster(shape)), Request, ops)
    want = _drive(JaxRouter(JaxCluster(shape)), JaxRequest, ops)
    assert got == want


def test_cluster_shape():
    c = VirtualCluster([4, 4, 2])
    assert (c.k, c.n_hosts) == (3, 10)
    with pytest.raises(ValueError):
        VirtualCluster([])
    with pytest.raises(ValueError):
        VirtualCluster([2, 0])


def test_serve_matches_serve_lm_flow():
    """serve(device='cpu') generates the tokens and route decisions of the
    examples/serve_lm.py flow, given the same params and prompts."""
    B, P, G = 4, 16, 6
    jcfg = jax_get_config("qwen3-4b").smoke()
    model = jax_build(jcfg)
    params = model.init(jax.random.PRNGKey(0))
    prompts = np.random.RandomState(0).randint(0, jcfg.vocab, (B, P))

    router = JaxRouter(JaxCluster([4, 4]))
    want_routes = []
    for r in range(B):
        d = router.route(JaxRequest(f"req{r}", session=f"sess{r % (B // 2)}",
                                    prompt_tokens=P, decode_tokens=G))
        want_routes.append((d.rid, d.pod, d.policy, d.cache_hit))
    prefill = jax.jit(make_prefill_step(model, cache_len=P + G))
    decode = jax.jit(make_serve_step(model))
    next_tok, cache = prefill(params, {"tokens": jnp.asarray(prompts,
                                                             jnp.int32)})
    out = [next_tok]
    for i in range(G - 1):
        next_tok, _, cache = decode(params, cache, out[-1], jnp.int32(P + i))
        out.append(next_tok)
    want = np.asarray(jnp.concatenate(out, axis=1))

    tcfg = get_config("qwen3-4b").smoke()
    res = serve(tcfg, B, P, G, device="cpu",
                params=params_from_jax(
                    tcfg, jax.tree_util.tree_map(np.asarray, params)),
                prompts=prompts)
    np.testing.assert_array_equal(res.tokens.numpy(), want)
    assert [(d.rid, d.pod, d.policy, d.cache_hit)
            for d in res.decisions] == want_routes
    assert res.cache_hit_rate == router.cache_hit_rate()
    assert res.load_imbalance == router.load_imbalance()
    assert tuple(res.logits.shape) == (B, G - 1, tcfg.padded_vocab)
    assert bool(torch.isfinite(res.logits).all())
    assert res.prefill_s > 0 and res.decode_s > 0


@pytest.mark.parametrize("arch,P", [("rwkv6-7b", 16), ("hymba-1.5b", 40)])
def test_serve_recurrent_families_match_serve_lm_flow(arch, P):
    """serve() on the rwkv6 and hymba smoke configs gives the tokens of the
    examples/serve_lm.py flow in JAX (hymba's 40-token prompt passes its
    32-token smoke window, so the ring wraps)."""
    B, G = 4, 6
    jcfg = jax_get_config(arch).smoke()
    model = jax_build(jcfg)
    params = model.init(jax.random.PRNGKey(0))
    prompts = np.random.RandomState(0).randint(0, jcfg.vocab, (B, P))
    prefill = jax.jit(make_prefill_step(model, cache_len=P + G))
    decode = jax.jit(make_serve_step(model))
    next_tok, cache = prefill(params, {"tokens": jnp.asarray(prompts,
                                                             jnp.int32)})
    out = [next_tok]
    for i in range(G - 1):
        next_tok, _, cache = decode(params, cache, out[-1], jnp.int32(P + i))
        out.append(next_tok)
    want = np.asarray(jnp.concatenate(out, axis=1))

    tcfg = get_config(arch).smoke()
    res = serve(tcfg, B, P, G, device="cpu",
                params=params_from_jax(
                    tcfg, jax.tree_util.tree_map(np.asarray, params)),
                prompts=prompts)
    np.testing.assert_array_equal(res.tokens.numpy(), want)
    assert tuple(res.logits.shape) == (B, G - 1, tcfg.padded_vocab)
    assert bool(torch.isfinite(res.logits).all())


def test_serve_initialises_from_seed_on_the_device():
    tcfg = get_config("granite-3-2b").smoke()
    a = serve(tcfg, 2, 8, 3, device="cpu", seed=5)
    b = serve(tcfg, 2, 8, 3, device="cpu", seed=5)
    assert torch.equal(a.tokens, b.tokens)
    assert tuple(a.tokens.shape) == (2, 3)


def test_route_requests_half_the_sessions_recur():
    router = route_requests(8, 512, 32)
    assert [d.policy for d in router.decisions] == ["A"] * 4 + ["B"] * 4
    assert router.cache_hit_rate() == 0.5
    assert router.load_imbalance() == 0.0
    assert route_requests(1, 4, 2).decisions[0].policy == "A"
