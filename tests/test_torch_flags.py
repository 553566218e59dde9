"""The port's feature flags against the JAX package's: ``REPRO_NO_BANDED``
sends sliding-window attention down the chunked path instead of the banded
one, in the forward and in the training backward, as JAX's
``causal_attention`` does; ``REPRO_MOE_DENSE`` leaves the single-device
MoE as it is. f32 on the CPU."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import flags as jflags  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import flags  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.moe_ep import moe_ffn_ep  # noqa: E402

# f32 on both sides: summation order only, as the model tests hold it
ATOL, RTOL = 1e-4, 1e-4
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-3
ARCH, B = "hymba-1.5b", 2


def _perturb(params, seed=7):
    rng = np.random.RandomState(seed)

    def f(path, a):
        if path[-1].key in ("a_log", "dt_bias", "norm", "attn_norm",
                            "scale"):
            return a + (0.1 * rng.randn(*a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(f, params)


def _banded_raises(*args, **kwargs):
    raise AssertionError("attention_banded called under REPRO_NO_BANDED")


@pytest.mark.parametrize("name,value", [("REPRO_NO_BANDED", "1"),
                                        ("REPRO_MOE_DENSE", "1"),
                                        ("REPRO_NO_BANDED", "0")])
def test_flags_read_the_environment_at_call_time(monkeypatch, name, value):
    monkeypatch.setenv(name, value)
    port = {"REPRO_NO_BANDED": flags.no_banded_attention,
            "REPRO_MOE_DENSE": flags.moe_dense}[name]
    jax_fn = {"REPRO_NO_BANDED": jflags.no_banded_attention,
              "REPRO_MOE_DENSE": jflags.moe_dense}[name]
    assert port() == jax_fn() == (value == "1")
    monkeypatch.delenv(name)
    assert not port() and not jax_fn()


def test_no_banded_attention_plain_takes_the_chunked_path(monkeypatch):
    """At S = 2 x window the dispatch is banded; under REPRO_NO_BANDED it
    is attention_chunked at JAX's block_k = min(1024, max(S, 128)),
    exactly, and attention_banded is never called."""
    rng = np.random.RandomState(0)
    S, w = 64, 32
    q, k, v = (torch.from_numpy(rng.randn(2, S, h, 16).astype(np.float32))
               for h in (4, 2, 2))
    pos = torch.arange(S)
    kw = dict(causal=True, window=w, qpos=pos, kpos=pos)
    banded = cm.attention_plain(q, k, v, **kw)
    assert torch.equal(banded, cm.attention_banded(q, k, v, window=w,
                                                   qpos=pos, kpos=pos))
    monkeypatch.setenv("REPRO_NO_BANDED", "1")
    monkeypatch.setattr(cm, "attention_banded", _banded_raises)
    got = cm.attention_plain(q, k, v, **kw)
    want = cm.attention_chunked(q, k, v, block_k=min(1024, max(S, 128)),
                                **kw)
    assert torch.equal(got, want)
    torch.testing.assert_close(got, banded, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("attn_impl", ["flash", "chunked"])
def test_no_banded_hymba_matches_jax(monkeypatch, attn_impl):
    """hymba's smoke config at S = 2 x window under REPRO_NO_BANDED: the
    forward logits and one loss's gradients against JAX's, which takes
    the chunked path too. The JAX side runs un-jitted, after
    jax.clear_caches(), so no trace made without the flag is reused. The
    port never calls attention_banded: not in the plain forward
    ("chunked"), not in the kernel's backward ("flash")."""
    monkeypatch.setenv("REPRO_NO_BANDED", "1")
    jcfg = jconfigs.get_config(ARCH).smoke()
    tcfg = tconfigs.get_config(ARCH).smoke()
    S = 2 * tcfg.sliding_window
    model = jax_build(jcfg)
    params = _perturb(model.init(jax.random.PRNGKey(0)))
    toks = np.random.RandomState(1).randint(0, jcfg.vocab, (B, S)
                                            ).astype(np.int32)
    batch = {"tokens": jnp.asarray(toks)}
    jax.clear_caches()
    want_logits = np.asarray(model.forward(params, batch, remat=False))
    (want_loss, _), want_grads = jax.value_and_grad(
        lambda p: model.loss(p, batch, remat=True), has_aux=True)(params)

    monkeypatch.setattr(cm, "attention_banded", _banded_raises)
    port = build_model(tcfg, device="cpu", attn_impl=attn_impl)
    port.load_state_dict(params_from_jax(
        tcfg, jax.tree_util.tree_map(np.asarray, params)))
    ttoks = {"tokens": torch.from_numpy(toks)}
    np.testing.assert_allclose(port.forward(ttoks).numpy(), want_logits,
                               atol=ATOL, rtol=RTOL)
    loss, _ = port.loss(ttoks)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    grads = params_to_numpy(tcfg, {n: p.grad for n, p
                                   in port.named_parameters()})
    for path, w in jax.tree_util.tree_flatten_with_path(want_grads)[0]:
        g = grads
        for key in path:
            g = g[key.key]
        np.testing.assert_allclose(g, np.asarray(w), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_moe_dense_leaves_the_single_device_moe_unchanged(monkeypatch):
    """On one device moe_ffn_ep is moe_ffn, with or without
    REPRO_MOE_DENSE, and both agree with JAX's moe_ffn_ep under the flag."""
    jcfg = jconfigs.get_config("dbrx-132b").smoke()
    tcfg = tconfigs.get_config("dbrx-132b").smoke()
    rng = np.random.RandomState(4)
    x = rng.randn(2, 16, tcfg.d_model).astype(np.float32)
    experts = moe.Experts(tcfg, torch.device("cpu"))
    for p in experts.parameters():
        p.data.copy_(torch.from_numpy(
            (0.2 * rng.randn(*p.shape)).astype(np.float32)))
    tx = torch.from_numpy(x)
    off, _ = moe_ffn_ep(tcfg, experts, tx)
    monkeypatch.setenv("REPRO_MOE_DENSE", "1")
    on, _ = moe_ffn_ep(tcfg, experts, tx)
    assert torch.equal(off, on)
    assert torch.equal(on, moe.moe_ffn(tcfg, experts, tx)[0])
    from repro.models.moe_ep import moe_ffn_ep as jax_ep
    jp = {n: jnp.asarray(p.detach().numpy())
          for n, p in experts.named_parameters()}
    want, _ = jax_ep(jcfg, jp, jnp.asarray(x))
    np.testing.assert_allclose(on.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(
        np.asarray(jax_moe.moe_ffn(jcfg, jp, jnp.asarray(x))[0]),
        np.asarray(want), atol=0, rtol=0)
