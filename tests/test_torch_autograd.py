"""The kernels' autograd Functions (kernels/autograd.py) on the CPU path,
where each kernel's wrapper runs its plain version: gradcheck in f64 at
tiny shapes; the gradients of kernels.ops against autograd of the plain
functions JAX trains through, and against JAX's own gradients; the raw
wrappers refuse grad-requiring inputs; a model's gradients with the
kernels equal its gradients with the plain attention and GLA."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import common as jcm  # noqa: E402
from repro.models.recurrence import gla_chunked as jax_gla  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import gla_scan as gs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.autograd import (FlashAttentionFn,  # noqa: E402
                                          GlaScanFn)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402

F64 = torch.float64

@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny shapes: one intra-op thread a test process (the test workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# (B, Sq, Sk, H, G, D, causal, window, self attention)
ATTN = {
    "causal": (1, 6, 6, 2, 1, 16, True, 0, True),
    "gqa": (2, 5, 5, 4, 2, 16, True, 0, True),
    "window": (1, 7, 7, 2, 2, 16, True, 3, True),
    "banded": (1, 8, 8, 2, 1, 16, True, 2, True),    # S % w == 0, S >= 2w
    "cross": (1, 3, 5, 2, 1, 16, False, 0, False),
}
# (B, T, H, K, V, u, initial state)
GLA = {
    "u_state": (1, 5, 1, 8, 8, True, True),
    "plain": (2, 4, 2, 8, 8, False, False),
    "two_chunks": (1, 33, 1, 8, 8, True, False),     # crosses a chunk edge
}


def _attn_inputs(case, dtype, seed=0):
    B, Sq, Sk, H, G, D, causal, window, self_attn = ATTN[case]
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g, dtype=torch.float64).to(dtype)
               for shape in ((B, Sq, H, D), (B, Sk, G, D), (B, Sk, G, D)))
    pos = torch.arange(Sq, dtype=torch.int32)
    kpos = pos if self_attn else torch.arange(Sk, dtype=torch.int32) - 1
    return q, k, v, causal, window, pos, kpos, self_attn


def _gla_inputs(case, dtype, seed=0):
    B, T, H, K, V, use_u, init = GLA[case]
    g = torch.Generator().manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64)

    r, k, v = (rn(B, T, H, K) * 0.5).to(dtype), (rn(B, T, H, K) * 0.5).to(
        dtype), rn(B, T, H, V).to(dtype)
    logw = -torch.exp(rn(B, T, H, K).clamp(-2, 1))
    logw = logw.to(torch.promote_types(dtype, torch.float32))
    u = (rn(H, K) * 0.3).to(logw.dtype) if use_u else None
    s0 = rn(B, H, K, V).to(logw.dtype) if init else None
    return r, k, v, logw, u, s0


@pytest.mark.parametrize("case", list(ATTN))
def test_flash_attention_fn_gradcheck(case):
    q, k, v, causal, window, qpos, kpos, self_attn = _attn_inputs(case, F64)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    assert torch.autograd.gradcheck(
        lambda q, k, v: FlashAttentionFn.apply(q, k, v, causal, window, qpos,
                                               kpos, self_attn),
        (q, k, v))


@pytest.mark.parametrize("case", list(GLA))
def test_gla_scan_fn_gradcheck(case):
    r, k, v, logw, u, s0 = _gla_inputs(case, F64)
    args = [t.requires_grad_() if t is not None else None
            for t in (r, k, v, logw, u, s0)]
    assert torch.autograd.gradcheck(lambda *a: GlaScanFn.apply(*a),
                                    tuple(args))


@pytest.mark.parametrize("case", list(ATTN))
def test_ops_flash_attention_grads_match_plain_and_jax(case):
    """f32: ops.flash_attention's gradients are autograd of the training
    dispatch (attention_plain) and agree with JAX's gradients of the same
    function (attention_banded / attention_chunked)."""
    q, k, v, causal, window, qpos, kpos, self_attn = _attn_inputs(
        case, torch.float32, seed=1)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(2))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=causal, window=window,
                              qpos=qpos, kpos=kpos, self_attention=self_attn)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, do)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(cm.attention_plain(
        *ref, causal=causal, window=window, qpos=qpos, kpos=kpos,
        self_attention=self_attn), ref, do)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
    S = k.shape[1]

    def jax_fn(q, k, v):
        if self_attn and window and S % window == 0 and S >= 2 * window:
            o = jcm.attention_banded(q, k, v, window=window,
                                     qpos=jnp.asarray(qpos.numpy()),
                                     kpos=jnp.asarray(kpos.numpy()))
        else:
            o = jcm.attention_chunked(q, k, v, causal=causal, window=window,
                                      qpos=jnp.asarray(qpos.numpy()),
                                      kpos=jnp.asarray(kpos.numpy()),
                                      block_k=min(1024, max(S, 128)))
        return jnp.sum(o * jnp.asarray(do.numpy()))

    jg = jax.grad(jax_fn, argnums=(0, 1, 2))(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    for a, b in zip(got, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize("case", list(GLA))
def test_ops_gla_grads_match_plain_and_jax(case):
    """f32: ops.gla's gradients are autograd of gla_scan_ref, and agree with
    JAX's gradients of gla_chunked (the same function, chunked as the JAX
    models chunk it)."""
    r, k, v, logw, u, s0 = _gla_inputs(case, torch.float32, seed=3)
    g = torch.Generator().manual_seed(4)
    dy = torch.randn(v.shape, generator=g)
    ds = torch.randn((r.shape[0], r.shape[2], r.shape[3], v.shape[3]),
                     generator=g)
    ins = [t for t in (r, k, v, logw, u, s0) if t is not None]

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in ins]
        it = iter(leaves)
        args = [next(it) if t is not None else None
                for t in (r, k, v, logw, u, s0)]
        y, state = fn(*args)
        return torch.autograd.grad((y, state), leaves, (dy, ds))

    got = grads(lambda r, k, v, w, u, s: ops.gla(r, k, v, w, u,
                                                 initial_state=s))
    want = grads(lambda r, k, v, w, u, s: gs.gla_scan_ref(
        r, k, v, w, u, initial_state=s))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
    T = r.shape[1]

    def jax_fn(*xs):  # the JAX models' chunking: 32 where it divides T
        it = iter(xs)
        a = [next(it) if t is not None else None
             for t in (r, k, v, logw, u, s0)]
        y, state = jax_gla(*a[:5], chunk=32 if T % 32 == 0 else T,
                           initial_state=a[5])
        return (jnp.sum(y * jnp.asarray(dy.numpy()))
                + jnp.sum(state * jnp.asarray(ds.numpy())))

    jg = jax.grad(jax_fn, argnums=tuple(range(len(ins))))(
        *(jnp.asarray(t.numpy()) for t in ins))
    for a, b in zip(got, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-4)


def test_raw_wrappers_refuse_grad_inputs():
    """A raw wrapper's output has no grad_fn: on inputs that require grad
    under grad mode it raises (before its CPU branch), instead of handing
    back an output whose inputs would get zero gradient."""
    q, k, v, causal, window, qpos, kpos, _ = _attn_inputs("gqa",
                                                          torch.float32)
    r, gk, gv, logw, u, s0 = _gla_inputs("u_state", torch.float32)
    for i in range(3):
        qkv = [t.clone() for t in (q, k, v)]
        qkv[i].requires_grad_()
        with pytest.raises(RuntimeError, match="requires grad"):
            fa.flash_attention(*qkv, causal=causal, window=window,
                               qpos=qpos, kpos=kpos)
        with torch.no_grad():
            out = fa.flash_attention(*qkv, causal=causal, window=window,
                                     qpos=qpos, kpos=kpos)
        assert out.grad_fn is None
    for i in range(6):
        args = [t.clone() for t in (r, gk, gv, logw, u, s0)]
        args[i].requires_grad_()
        with pytest.raises(RuntimeError, match="requires grad"):
            gs.gla_scan(*args[:5], initial_state=args[5])
    y, _ = gs.gla_scan(r, gk, gv, logw, u, initial_state=s0)
    assert y.grad_fn is None


def test_ops_without_grad_call_the_raw_wrappers():
    """No grad needed: ops returns the wrapper's output, no Function."""
    q, k, v, causal, window, qpos, kpos, _ = _attn_inputs("gqa",
                                                          torch.float32)
    q.requires_grad_()
    with torch.no_grad():
        assert ops.flash_attention(q, k, v, qpos=qpos,
                                   kpos=kpos).grad_fn is None
    assert ops.flash_attention(q.detach(), k, v, qpos=qpos,
                               kpos=kpos).grad_fn is None
    assert ops.flash_attention(q, k, v, qpos=qpos, kpos=kpos).grad_fn \
        is not None


@pytest.mark.parametrize("arch,S", [("qwen3-4b", 16), ("rwkv6-7b", 40),
                                    ("hymba-1.5b", 64)])
def test_model_grads_with_kernels_match_plain_model(arch, S):
    """The training wiring: every parameter's gradient of the loss with the
    kernels (attn_impl="flash", gla_impl="kernel", through their autograd
    Functions) equals the all-plain model's (attn_impl="chunked",
    gla_impl="chunked"), with remat on and off; every gradient is there and
    some are nonzero in each layer's attention and GLA weights."""
    cfg = tconfigs.get_config(arch).smoke()
    kern = build_model(cfg, device="cpu")
    kern.init_params(torch.Generator().manual_seed(0))
    plain = build_model(cfg, device="cpu", attn_impl="chunked",
                        gla_impl="chunked")
    plain.load_state_dict(kern.state_dict())
    toks = torch.randint(0, cfg.vocab, (2, S),
                         generator=torch.Generator().manual_seed(1))
    out = {}
    for name, m, remat in (("kern", kern, True), ("kern_noremat", kern,
                                                  False),
                           ("plain", plain, True)):
        m.zero_grad(set_to_none=True)
        loss, _ = m.loss({"tokens": toks}, remat=remat)
        loss.backward()
        out[name] = (float(loss.detach()), {n: p.grad.clone()
                                   for n, p in m.named_parameters()})
    for name in ("kern_noremat", "plain"):
        assert out[name][0] == pytest.approx(out["kern"][0], rel=1e-5)
        assert out[name][1].keys() == out["kern"][1].keys()
        for n, g in out["kern"][1].items():
            torch.testing.assert_close(g, out[name][1][n], atol=1e-5,
                                       rtol=1e-4, msg=n)
    watched = {"dense": ("attn.wq", "attn.wk", "attn.wv"),
               "ssm": ("att.wr", "att.wk", "att.wv", "att.wA", "att.w0",
                       "att.u"),
               "hybrid": ("attn.wq", "attn.wk", "attn.wv", "ssm.wB",
                          "ssm.wC", "ssm.a_log")}[cfg.family]
    for i in range(cfg.n_layers):
        for w in watched:
            if w in ("att.u", "att.w0", "ssm.a_log"):
                continue  # zero at init: may carry a zero gradient
            assert out["kern"][1][f"layers.{i}.{w}"].abs().max() > 0, w


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_backward_follows_the_callers_block_k(causal):
    """A caller that passes its block_k (JAX's direct attention_chunked
    call sites: encdec, the moe and vlm prefills) gets the gradients of
    attention_chunked at that block_k exactly, not those of the
    causal_attention dispatch, whose block_k is min(1024, max(S, 128));
    at Sk = 700 the two split the keys differently."""
    g = torch.Generator().manual_seed(3)
    B, Sq, Sk, H, G, D = 1, 9, 700, 2, 1, 16
    q, k, v = (torch.randn(s, generator=g) for s in
               ((B, Sq, H, D), (B, Sk, G, D), (B, Sk, G, D)))
    qpos = torch.arange(Sk - Sq, Sk, dtype=torch.int32)
    kpos = torch.arange(Sk, dtype=torch.int32)
    do = torch.randn(q.shape, generator=g)
    kw = dict(causal=causal, qpos=qpos, kpos=kpos)

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        return torch.autograd.grad(fn(*leaves), leaves, do)

    got = grads(lambda *x: ops.flash_attention(*x, block_k=512, **kw))
    want = grads(lambda *x: cm.attention_chunked(*x, block_k=512, **kw))
    other = grads(lambda *x: cm.attention_chunked(*x, block_k=700, **kw))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not all(torch.equal(a, b) for a, b in zip(got, other))
    dispatch = grads(lambda *x: ops.flash_attention(*x, **kw))
    assert all(torch.equal(a, b) for a, b in zip(dispatch, other))


# The backward kernels' plain version (flash_attention_bwd_ref, the kernels'
# recurrence) against autograd of attention_plain: ATTN's cases, rows that
# see no key, keys over three 64-key tiles with empty slots, and each head
# dim of the kernels. (B, Sq, Sk, H, G, D, causal, window, qpos, kpos)
BWD = {case: (*ATTN[case][:8], None, None) for case in ATTN}
BWD["no_key_rows"] = (1, 4, 6, 2, 1, 16, True, 0, torch.arange(4),
                      torch.arange(6) + 2)               # rows 0, 1: no key
BWD["tiles"] = (1, 70, 150, 4, 2, 16, True, 0, torch.arange(80, 150),
                torch.where((torch.arange(150) >= 10)
                            & (torch.arange(150) < 20), -1,
                            torch.arange(150)))
BWD.update({f"d{D}": (1, 5, 5, 2, 1, D, True, 0, None, None)
            for D in fa.HEAD_DIMS})


def _bwd_inputs(case, dtype):
    B, Sq, Sk, H, G, D, causal, window, qpos, kpos = BWD[case]
    if case in ATTN:
        q, k, v, causal, window, qpos, kpos, _ = _attn_inputs(case, dtype,
                                                              seed=6)
    else:
        g = torch.Generator().manual_seed(6)
        q, k, v = (torch.randn(s, generator=g, dtype=F64).to(dtype) for s in
                   ((B, Sq, H, D), (B, Sk, G, D), (B, Sk, G, D)))
        qpos = torch.arange(Sq) if qpos is None else qpos
        kpos = torch.arange(Sk) if kpos is None else kpos
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(7),
                     dtype=F64).to(dtype)
    return q, k, v, do, dict(causal=causal, window=window,
                             qpos=qpos.to(torch.int32),
                             kpos=kpos.to(torch.int32))


def _plain_grads(q, k, v, do, kw):
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = cm.attention_plain(*leaves, **kw)
    return o.detach(), torch.autograd.grad(o, leaves, do)


@pytest.mark.parametrize("dtype", [F64, torch.float32])
@pytest.mark.parametrize("case", list(BWD))
def test_flash_backward_plain_version_matches_autograd(case, dtype):
    q, k, v, do, kw = _bwd_inputs(case, dtype)
    o, want = _plain_grads(q, k, v, do, kw)
    if case == "no_key_rows":
        # autograd of the plain function is nan through a row with no
        # valid key; such a row adds nothing to dk and dv, and its dq is 0
        o, want = _plain_grads(q[:, 2:], k, v, do[:, 2:],
                               dict(kw, qpos=kw["qpos"][2:]))
        o = torch.cat([torch.zeros_like(q[:, :2]), o], dim=1)
        want = (torch.cat([torch.zeros_like(q[:, :2]), want[0]], dim=1),
                *want[1:])
    got = fa.flash_attention_bwd_ref(q, k, v, o, do, **kw)
    tol = dict(atol=1e-10, rtol=1e-8) if dtype == F64 else dict(atol=2e-5,
                                                                 rtol=1e-4)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        torch.testing.assert_close(a, b, **tol)


@pytest.mark.parametrize("case", list(ATTN))
def test_flash_backward_plain_version_in_bf16(case):
    """bf16: P and dS rounded as the kernels' operands are; within the
    card's bf16 gradient tolerance (chip_smoke.py's GRAD_RTOL, 5e-2) of the
    f32 gradients of the same bf16 values, in norm."""
    q, k, v, do, kw = _bwd_inputs(case, torch.bfloat16)
    f32 = [t.float() for t in (q, k, v, do)]
    o, want = _plain_grads(*f32, kw)
    got = fa.flash_attention_bwd_ref(q, k, v, o.bfloat16(), do, **kw)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        assert (a.float() - b).norm() <= 2e-2 * b.norm()


def test_flash_backward_dispatch_on_the_cpu_takes_the_plain_path():
    """CPU (and f32, f64): the Function's backward is autograd of the plain
    function, counted in plain_calls; no kernel launch."""
    q, k, v, do, kw = _bwd_inputs("gqa", torch.float32)
    assert not fa.backward_on_kernel(q)
    counter = fa.flash_attention_backward
    before = (counter.launches, counter.plain_calls)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*leaves, self_attention=True, **kw)
    torch.autograd.grad(out, leaves, do)
    assert (counter.launches, counter.plain_calls) == (before[0],
                                                       before[1] + 1)
