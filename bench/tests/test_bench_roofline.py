"""The yardstick's operation and byte counts against counts made by hand
at small shapes."""
from __future__ import annotations

import pytest

from bench import roofline

# d 4, H 2, G 1, D 2, d_ff 3, one layer, vocabulary 5 (padded to 8)
DENSE = dict(family="dense", n_layers=1, d_model=4, n_heads=2, n_kv_heads=1,
             head_dim=2, d_ff=3, vocab=5, pad_vocab_to=8,
             tie_embeddings=True)


def test_dense_layer_weights():
    # q 4x4, k 4x2, v 4x2, o 4x4, wi 4x6, wo 3x4
    assert roofline.dense_layer_weights(DENSE) == 16 + 8 + 8 + 16 + 24 + 12


def test_dense_forward_and_training():
    # B 1, S 3: projections 2 * 84 * 3; causal pairs 1 + 2 + 3 = 6, each 2
    # flops for q.k and 2 for p.v on each of 2 heads of D 2: 4 * 2 * 2 * 6;
    # logits 2 * 4 * 5 at one position
    fwd = 2 * 84 * 3 + 4 * 2 * 2 * 6 + 2 * 4 * 5
    assert roofline.prefill_flops(DENSE, 1, 3) == fwd
    assert roofline.train_flops(DENSE, 1, 3) == 3 * (fwd + 2 * 4 * 5 * 2)


def test_attention_kernel():
    f, b = roofline.attn_fwd(2, 3, 2, 1, 2)
    assert f == 4 * 2 * 2 * 2 * 6 and b == 2 * 2 * 3 * 2 * (2 * 2 + 2 * 1)


def test_bound():
    assert roofline.bound_s(989e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert roofline.bound_s(989e12, 2 * 3.35e12) == pytest.approx(2.0)
