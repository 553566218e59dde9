"""The port's copy of the HLO cost analyzer against the JAX package's, on
the 8 cases of tests/test_hlo_analysis.py: the HLO text is made by JAX here
(or crafted) and fed to both analyses, whose CostTotals must be equal; the
port's roofline puts the same totals over the H100 datasheet peaks."""
import dataclasses

import jax
import jax.numpy as jnp
import pytest

from repro.launch import hlo_analysis as jh
from repro_torch.launch import hlo_analysis as th

CRAFTED = """
HloModule crafted

ENTRY %main (p0: f32[1024]) -> f32[64] {
  %p0 = f32[1024]{0} parameter(0)
  %ar = f32[1024]{0} all-reduce(%p0), replica_groups=[16,16]<=[256], to_apply=%add
  %ag = f32[1024]{0} all-gather(%p0), replica_groups=[16,16]<=[256], dimensions={0}
  %cp = f32[1024]{0} collective-permute(%ag), source_target_pairs={{0,1}}
  ROOT %rs = f32[64]{0} reduce-scatter(%cp), replica_groups=[16,16]<=[256], to_apply=%add
}
"""

UPCAST = """
HloModule up

ENTRY %main (p0: bf16[64]) -> f32[1024] {
  %p0 = bf16[64]{0} parameter(0)
  %wide_convert = f32[64]{0} convert(%p0)
  ROOT %ag = f32[1024]{0} all-gather(%wide_convert), replica_groups=[16,16]<=[256], dimensions={0}
}
"""

F32, BF16 = jnp.float32, jnp.bfloat16


def _spec(shape, dt=F32):
    return jax.ShapeDtypeStruct(shape, dt)


def _scan(x, w):
    def step(c, _):
        return jnp.tanh(c @ w), None
    return jax.lax.scan(step, x, None, length=13)[0]


def _nested(x, w):
    def outer(c, _):
        def inner(ci, _):
            return jnp.tanh(ci @ w), None
        return jax.lax.scan(inner, c, None, length=3)[0], None
    return jax.lax.scan(outer, x, None, length=5)[0]


def _grad(x, w):
    return jnp.sum(jnp.tanh(x @ w))


def _hlo(case):
    """The case's HLO text and device count."""
    if case == "crafted_collectives":
        return CRAFTED, 256
    if case == "narrowing":
        return UPCAST, 256
    if case == "scan":
        fn, args = jax.jit(_scan), (_spec((64, 128)), _spec((128, 128)))
    elif case == "nested_scan":
        fn, args = jax.jit(_nested), (_spec((32, 64)), _spec((64, 64)))
    elif case == "grad":
        fn = jax.jit(jax.grad(_grad, argnums=1))
        args = (_spec((64, 128)), _spec((128, 128)))
    elif case == "roofline":
        fn = jax.jit(lambda x, w: x @ w)
        args = (_spec((8192, 8192), BF16), _spec((8192, 8192), BF16))
    else:  # dus
        fn = jax.jit(lambda b, u: jax.lax.dynamic_update_slice(b, u, (0, 0)),
                     donate_argnums=(0,))
        args = (_spec((4096, 4096)), _spec((4, 4096)))
    return fn.lower(*args).compile().as_text(), 1


CASES = ("scan", "nested_scan", "grad", "crafted_collectives",
         "narrowing", "roofline", "dus")


def test_shape_bytes_equal():
    for s in ("f32[128,256]{1,0}", "bf16[4096]", "(f32[2,2]{1,0}, s32[4])",
              "pred[8]", "token[]"):
        assert th.shape_bytes(s) == jh.shape_bytes(s)
    assert th.shape_bytes("f32[128,256]{1,0}") == 128 * 256 * 4


@pytest.mark.parametrize("case", CASES)
def test_cost_totals_equal_jax(case):
    hlo, n = _hlo(case)
    got = dataclasses.asdict(th.analyze_hlo(hlo, n))
    assert got == dataclasses.asdict(jh.analyze_hlo(hlo, n))
    if case == "scan":
        assert got["flops"] == pytest.approx(13 * 2 * 64 * 128 * 128,
                                             rel=1e-6)
    if case == "nested_scan":
        assert got["flops"] == pytest.approx(5 * 3 * 2 * 32 * 64 * 64,
                                             rel=1e-6)
    if case == "crafted_collectives":
        assert got["per_collective"]["all-reduce"] == pytest.approx(
            2 * 15 / 16 * 4096)
    if case == "roofline":
        rl = th.roofline_from_hlo(hlo, n, model_flops_global=2 * 8192**3)
        assert rl.compute_s == rl.totals.flops / 989e12
        assert rl.memory_s == rl.totals.mem_bytes / 3.35e12
        assert rl.dominant in ("compute", "memory")
        assert 0.5 < rl.useful_flop_fraction <= 1.2
