"""The plain reference against the program on tiny float32
configurations, on the CPU: the same weights and tokens give the same
logits, loss and gradients; the control's precision differs; the weights
follow the seed."""
from __future__ import annotations

import pytest
import torch

from bench import reference, weights

DENSE = dict(name="tiny-dense", family="dense", n_layers=2, d_model=64,
             n_heads=4, n_kv_heads=2, head_dim=16, d_ff=96, vocab=250,
             pad_vocab_to=256, tie_embeddings=True, rope_theta=10000.0,
             rms_norm_eps=1e-6, dtype="float32")
CPU = torch.device("cpu")


def _program(c, sd):
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models import build_model
    from bench.harness import ARCH_KEYS
    model = build_model(ArchConfig(**{k: c[k] for k in ARCH_KEYS if k in c}),
                        device=CPU)
    model.load_state_dict(sd, strict=True)
    return model


@pytest.mark.parametrize("c", [DENSE, dict(DENSE, tie_embeddings=False,
                                             n_kv_heads=4)],
                         ids=["gqa-tied", "mha-untied"])
def test_reference_matches_program(c):
    ref = reference.family(c["family"])
    sd = weights.make(ref.leaves(c), 11, CPU)
    model = _program(c, sd)
    toks = torch.randint(0, c["vocab"], (2, 40),
                         generator=torch.Generator().manual_seed(3))
    P = reference.params(sd, grad=True)
    want = ref.logits(c, P, ref.hidden(c, P, toks))
    got = model.forward({"tokens": toks})[..., :c["vocab"]]
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-4 * scale
    loss = ref.loss(c, P, toks)
    grads = torch.autograd.grad(loss, list(P.values()))
    got_loss, _ = model.loss({"tokens": toks})
    got_loss.backward()
    assert got_loss.item() == pytest.approx(loss.item(), rel=1e-5)
    want_g = dict(zip(P, grads))
    for name, p in model.named_parameters():
        g = want_g[name]
        assert (p.grad - g).norm() <= 1e-4 * g.norm() + 1e-9, name


def test_control_is_coarser():
    ref = reference.family("dense")
    sd = weights.make(ref.leaves(DENSE), 12, CPU)
    P = reference.params(sd, grad=False)
    toks = torch.randint(0, 250, (1, 24), generator=torch.Generator()
                         .manual_seed(4))
    exact = ref.logits_at(DENSE, P, toks[0])
    coarse = ref.logits_at(DENSE, P, toks[0], precision="fp8")
    err = (coarse - exact).abs().max().item() / exact.abs().max().item()
    assert 1e-3 < err < 0.5


def test_weights_follow_the_seed():
    leaves = reference.family("dense").leaves(DENSE)
    a, b = weights.make(leaves, 2 ** 31 + 9, CPU), \
        weights.make(leaves, 2 ** 31 + 9, CPU)
    c = weights.make(leaves, 2 ** 31 + 10, CPU)
    assert list(a) == [n for n, *_ in leaves]
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["layers.0.attn.wq"], c["layers.0.attn.wq"])
    assert torch.equal(a["layers.1.ln1.scale"], torch.ones(64))


def test_family_is_found_by_file():
    assert reference.family("dense").__name__ == "bench.reference.dense"
    with pytest.raises(ValueError):
        reference.family("ssm")
