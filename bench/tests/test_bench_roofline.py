"""The yardstick's operation and byte counts against counts made by hand
at small shapes."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from bench import roofline
from bench.cell import family_module
from bench.counts import dense
from bench.tests.families import moe_count

ROOT = Path(__file__).resolve().parents[2]

# d 4, H 2, G 1, D 2, d_ff 3, one layer, vocabulary 5 (padded to 8)
DENSE = dict(family="dense", n_layers=1, d_model=4, n_heads=2, n_kv_heads=1,
             head_dim=2, d_ff=3, vocab=5, pad_vocab_to=8,
             tie_embeddings=True)


def test_dense_layer_weights():
    # q 4x4, k 4x2, v 4x2, o 4x4, wi 4x6, wo 3x4
    assert dense.layer_weights(DENSE) == 16 + 8 + 8 + 16 + 24 + 12
    assert family_module("counts", "dense") is dense
    with pytest.raises(ValueError):
        family_module("counts", "ssm")


def test_dense_forward_and_training():
    # B 1, S 3: projections 2 * 84 * 3; causal pairs 1 + 2 + 3 = 6, each 2
    # flops for q.k and 2 for p.v on each of 2 heads of D 2: 4 * 2 * 2 * 6;
    # logits 2 * 4 * 5 at one position
    fwd = 2 * 84 * 3 + 4 * 2 * 2 * 6 + 2 * 4 * 5
    assert roofline.prefill_flops(DENSE, 1, 3) == fwd
    assert roofline.train_flops(DENSE, 1, 3) == 3 * (fwd + 2 * 4 * 5 * 2)


def test_moe_forward_and_training(monkeypatch):
    """A routed-expert layer counts the router and the k experts a token is
    sent to: 4 experts of which 2 a token."""
    c = dict(DENSE, family="moe", n_experts=4, moe_topk=2)
    # q, k, v, o 48; router 4x4; 2 experts of SwiGLU in 4x6 and out 3x4
    assert moe_count.layer_weights(c) == 48 + 16 + 2 * (24 + 12)
    monkeypatch.setattr(roofline, "family_module",
                        lambda kind, name: {("counts", "moe"): moe_count}[
                            kind, name])
    fwd = 2 * 136 * 3 + 4 * 2 * 2 * 6 + 2 * 4 * 5
    assert roofline.prefill_flops(c, 1, 3) == fwd
    assert roofline.train_flops(c, 1, 3) == 3 * (fwd + 2 * 4 * 5 * 2)


def test_counts_at_the_cells_shapes():
    """The granite cells' whole-step counts, as before the counts moved to
    counts/<family>.py: training B 4 x 1024, prefill 16 x each length."""
    c = json.loads((ROOT / "bench/configs/granite-3-2b.json").read_text())
    assert roofline.train_flops(c, 4, 1024) == 64323594485760.0
    for P, flops in ((512, 40549054873600.0), (1024, 82469277859840.0),
                     (2048, 170432892436480.0), (4092, 362455542988800.0)):
        assert roofline.prefill_flops(c, 16, P) == flops


def test_attention_kernel():
    f, b = roofline.attn_fwd(2, 3, 2, 1, 2)
    assert f == 4 * 2 * 2 * 2 * 6 and b == 2 * 2 * 3 * 2 * (2 * 2 + 2 * 1)


def test_bound():
    assert roofline.bound_s(989e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert roofline.bound_s(989e12, 2 * 3.35e12) == pytest.approx(2.0)
