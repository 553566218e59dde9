"""The flash-attention backward kernels (attn_bwd_dq, attn_bwd_dkv) on the
card; every test skips without one. Run on a machine with an NVIDIA GPU:

    PYTHONPATH=src python -m pytest -q -m card tests/test_torch_flash_backward_card.py

- the gradients through ``ops.flash_attention`` (the tc forward with its
  log-sum-exp, then the backward kernels) against autograd of the plain
  attention the port trained through before (``attention_plain``), at the
  training shapes of granite-3-2b (D 64), qwen3-4b (D 128), stablelm-12b
  (D 160), hymba-1.5b (a sliding window), whisper-medium's cross
  attention (non-causal, Sq != Sk) and a tensor-parallel rank (H 8, G 2),
  within chip_smoke.py's bf16 tolerance; a control with dS left out of dK
  that the tolerance rejects;
- the kernels against their plain version (``flash_attention_bwd_ref``),
  the same arithmetic, on ragged shapes with every kind of mask and rows
  that see no key (zero gradient);
- a bf16 training step launches the backward kernels once an attention
  layer and never the plain backward.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402

pytestmark = pytest.mark.card

#: chip_smoke.py's GRAD_RTOL for bf16: the kernels' f32 accumulation and
#: bf16 P and dS against the plain attention's bf16 accumulation
GRAD_RTOL = 5e-2
#: the kernels against their plain version: the same roundings, another
#: order of f32 sums and ex2 against exp, then bf16 outputs
REF_RTOL = 1e-2

# (B, Sq, Sk, H, G, D, causal, window, the caller's block_k)
TRAINING = {
    "granite-3-2b": (4, 1024, 1024, 32, 8, 64, True, 0, None),
    "qwen3-4b": (4, 1024, 1024, 32, 8, 128, True, 0, None),
    "stablelm-12b": (4, 1024, 1024, 32, 8, 160, True, 0, None),
    "hymba-1.5b": (4, 2048, 2048, 25, 5, 64, True, 1024, None),
    "whisper-medium-cross": (8, 448, 1500, 16, 16, 64, False, 0, 512),
    "tp-rank": (4, 1024, 1024, 8, 2, 128, True, 0, None),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _inputs(card, B, Sq, Sk, H, G, D, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    return [torch.randn(s, generator=g, device=card).bfloat16() for s in
            ((B, Sq, H, D), (B, Sk, G, D), (B, Sk, G, D))]


def _grads(fn, qkv, target):
    """Gradients of 0.5 ||fn(q, k, v) - target||^2, as phase 7 takes them."""
    leaves = [t.clone().requires_grad_() for t in qkv]
    loss = 0.5 * (fn(*leaves).float() - target).square().sum()
    return torch.autograd.grad(loss, leaves)


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.parametrize("name", list(TRAINING))
def test_kernels_match_autograd_of_the_plain_attention(card, name):
    B, Sq, Sk, H, G, D, causal, window, block_k = TRAINING[name]
    qkv = _inputs(card, B, Sq, Sk, H, G, D, seed=1)
    pos = {"qpos": torch.arange(Sq, dtype=torch.int32, device=card),
           "kpos": torch.arange(Sk, dtype=torch.int32, device=card)}
    kw = dict(causal=causal, window=window, self_attention=Sq == Sk,
              block_k=block_k, **pos)
    target = torch.randn((B, Sq, H, D), device=card)
    launches = fa.flash_attention_backward.launches
    got = _grads(lambda *x: ops.flash_attention(*x, **kw), qkv, target)
    want = _grads(lambda *x: cm.attention_plain(*x, **kw), qkv, target)
    assert fa.flash_attention_backward.launches == launches + 1
    for a, b in zip(got, want):
        assert torch.isfinite(a).all() and a.float().norm() > 0
        assert _rel(a, b) <= GRAD_RTOL


def test_control_dk_without_ds_is_rejected(card):
    """dK with P in place of dS (the softmax's Jacobian left out) reads
    above the tolerance at granite-3-2b's training shape."""
    B, Sq, Sk, H, G, D, causal, window, _ = TRAINING["granite-3-2b"]
    q, k, v = _inputs(card, B, Sq, Sk, H, G, D, seed=2)
    target = torch.randn((B, Sq, H, D), device=card)
    _, want, _ = _grads(lambda *x: cm.attention_plain(*x), (q, k, v), target)
    qg = q.float().reshape(B, Sq, G, H // G, D)
    s = torch.einsum("bsgqd,btgd->bgqst", qg, k.float()) / math.sqrt(D)
    s = s.masked_fill(torch.ones(Sq, Sk, dtype=torch.bool,
                                 device=card).triu(1), -math.inf)
    dk = torch.einsum("bgqst,bsgqd->btgd", s.softmax(-1), qg) / math.sqrt(D)
    assert _rel(dk, want) > GRAD_RTOL


def _ragged(card):
    """(name, B, Sq, Sk, H, G, D, causal, window, qpos, kpos)."""
    def ar(n, off=0):
        return torch.arange(off, off + n, dtype=torch.int32, device=card)
    holes = torch.where((ar(150) >= 10) & (ar(150) < 25), -1, ar(150))
    return [
        # a query block at the end of a cache with empty slots
        ("cache", 2, 77, 150, 6, 3, 32, True, 0, ar(77, 73), holes),
        ("window", 2, 150, 150, 10, 2, 64, True, 40, ar(150), ar(150)),
        # rows 0-19 see no key (zero gradient)
        ("no_key_rows", 1, 40, 94, 4, 1, 16, True, 0, ar(40), ar(94, 20)),
        ("cross_d160", 1, 100, 70, 4, 2, 160, False, 0, ar(100), ar(70)),
        ("gqa7_d128", 2, 130, 130, 7, 1, 128, True, 0, ar(130), ar(130)),
    ]


def test_kernels_match_their_plain_version(card):
    for (name, B, Sq, Sk, H, G, D, causal, window, qpos,
         kpos) in _ragged(card):
        q, k, v = _inputs(card, B, Sq, Sk, H, G, D, seed=3)
        do = torch.randn(q.shape, device=card).bfloat16()
        kw = dict(causal=causal, window=window, qpos=qpos, kpos=kpos)
        o, lse = fa.flash_attention_fwd_lse(q, k, v, **kw)
        got = fa.flash_attention_backward(q, k, v, o, lse, do, **kw)
        want = fa.flash_attention_bwd_ref(q, k, v, o, do, **kw)
        for part, a, b in zip("qkv", got, want):
            assert torch.isfinite(a).all(), (name, part)
            assert _rel(a, b) <= REF_RTOL, (name, part, _rel(a, b))
        if name == "no_key_rows":
            assert not got[0][:, :20].any()


def test_training_step_launches_the_backward_kernels(card):
    """A bf16 training step of a two-layer model: one backward launch an
    attention layer, no plain backward."""
    cfg = tconfigs.get_config("granite-3-2b").smoke()
    model = build_model(cfg, device=card)
    model.init_params(torch.Generator(device=card).manual_seed(0))
    model.to(torch.bfloat16)
    toks = torch.randint(0, cfg.vocab, (2, 64), device=card)
    counter = fa.flash_attention_backward
    before = (counter.launches, counter.plain_calls)
    loss, _ = model.loss({"tokens": toks}, remat=True)
    loss.backward()
    assert (counter.launches, counter.plain_calls) == (
        before[0] + cfg.n_layers, before[1])
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.parameters())
