"""The plain reference against the program on tiny float32
configurations, on the CPU: the same weights and tokens give the same
logits, loss and gradients; the control's precision differs; the weights
follow the seed."""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from bench import harness, reference, weights
from bench.cell import Cell
from bench.tests.families import moe_reference

DENSE = dict(name="tiny-dense", family="dense", n_layers=2, d_model=64,
             n_heads=4, n_kv_heads=2, head_dim=16, d_ff=96, vocab=250,
             pad_vocab_to=256, tie_embeddings=True, rope_theta=10000.0,
             rms_norm_eps=1e-6, dtype="float32")
CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[2]
#: a configuration file's keys that are the reference's alone
NOT_FIELDS = dict(source="a test", reduced=["n_layers"],
                  assumed={"weights": "random"}, departures=["none"],
                  deployment="a test", max_positions=64)


def _program(c, sd):
    from repro_torch.models import build_model
    model = build_model(harness.arch_config(c), device=CPU)
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


def test_every_arch_config_field_reaches_the_program(monkeypatch):
    """Each key of the file that names an ArchConfig field, those of other
    families too, reaches the model program_model builds; no other key
    does, and granite's file selects the same 13 keys as ever."""
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models import build_model
    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    given = dict(DENSE, family="moe", n_experts=4, moe_topk=2, qk_norm=True,
                 sliding_window=16, skip_shapes=["long_500k"])
    cfg = harness.arch_config(dict(given, **NOT_FIELDS))
    want = {k: v for k, v in given.items() if k in fields}
    assert cfg == ArchConfig(**dict(want, skip_shapes=("long_500k",)))
    ctx = harness.Context(Cell("tiny", 1, dict(given, **NOT_FIELDS), {}, {},
                               [], []), 5, CPU)
    monkeypatch.setattr(harness.Context, "weights",
                        lambda self: build_model(cfg, device=CPU)
                        .state_dict())
    model = harness.program_model(ctx)
    assert model.cfg == cfg
    assert (model.cfg.n_experts, model.cfg.moe_topk, model.cfg.qk_norm,
            model.cfg.sliding_window) == (4, 2, True, 16)
    granite = json.loads((ROOT / "bench/configs/granite-3-2b.json")
                         .read_text())
    assert set(granite) & fields == {
        "name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
        "d_ff", "vocab", "head_dim", "rope_theta", "tie_embeddings",
        "dtype", "pad_vocab_to"}


def test_moe_test_reference_matches_program():
    """The moe reference the tests add as a file gives the program's moe
    logits in float32, where its capacity drops no pair."""
    c = dict(DENSE, name="tiny-moe", family="moe", n_experts=4, moe_topk=2)
    sd = weights.make(moe_reference.leaves(c), 13, CPU)
    model = _program(c, sd)
    toks = torch.randint(0, c["vocab"], (1, 40),
                         generator=torch.Generator().manual_seed(5))
    want = moe_reference.logits_at(c, reference.Float32View(sd), toks[0])
    with torch.no_grad():
        got = model.forward({"tokens": toks})[0, :, :c["vocab"]]
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


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
