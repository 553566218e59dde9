"""The port's logical-axis rules against the JAX package's: the cases of
tests/test_sharding.py with JAX's answers written beside them, every
parameter of every config under DEFAULT_RULES on both production meshes
(logical_to_spec and the ZeRO-1 axes), the DTensor placements the specs
map to, and hint's contract. No process group: the meshes are axis names
and sizes."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import sharding as jsh  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.common import ParamSpec as JSpec  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import make_production_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import (ParamSpec, axes_tree,  # noqa: E402
                                       shape_tree, tree_leaves)
from repro_torch.sharding import (DEFAULT_RULES, MeshShape, Rules,  # noqa: E402
                                  current_rules, hint, logical_to_spec,
                                  mesh_axis_size, named_sharding,
                                  tree_shardings, use_rules)
from repro_torch.train.optimizer import (opt_state_axes,  # noqa: E402
                                         zero1_leaf_axes)

ARCHS = sorted(jconfigs.ARCHS)


class FakeMesh:
    """JAX's mesh stand-in (tests/test_sharding.py:20)."""

    def __init__(self, **axes):
        self.axis_names = tuple(axes)
        self.shape = dict(axes)


MESHES = {"pod": dict(data=16, model=16),
          "multipod": dict(pod=2, data=16, model=16)}


# ------------------------------------------- the cases of test_sharding --
def test_divisibility_fallback():                     # test_sharding.py:29
    m = MeshShape.of(data=16, model=16)
    spec = logical_to_spec(m, DEFAULT_RULES, ("vocab", "embed"),
                           (49155, 2048))
    assert spec == tuple(P()) == ()
    spec2 = logical_to_spec(m, DEFAULT_RULES, ("vocab", "embed"),
                            (49408, 2048))
    assert spec2 == tuple(P("model")) == ("model",)


def test_axis_conflict_drops_later_dim():             # test_sharding.py:39
    m = MeshShape.of(pod=2, data=16, model=16)
    rules = DEFAULT_RULES.updated(embed="data")
    spec = logical_to_spec(m, rules, ("batch", "seq", "embed"),
                           (256, 4096, 2048))
    assert spec == tuple(P(("pod", "data"))) == (("pod", "data"),)


def test_missing_mesh_axis_dropped():                 # test_sharding.py:48
    m = MeshShape.of(data=16, model=16)
    spec = logical_to_spec(m, DEFAULT_RULES, ("batch", None), (256, 128))
    assert spec == tuple(P("data")) == ("data",)


def test_mesh_axis_size():                            # test_sharding.py:55
    m = MeshShape.of(pod=2, data=16, model=16)
    assert mesh_axis_size(m, None) == 1
    assert mesh_axis_size(m, "data") == 16
    assert mesh_axis_size(m, ("pod", "data")) == 32
    assert mesh_axis_size(m, "absent") == 1


def test_zero1_axes_adds_fsdp_on_largest_free_dim():  # test_sharding.py:63
    m = MeshShape.of(data=16, model=16)
    spec = ParamSpec((48, 5120, 2048), torch.bfloat16, "scaled",
                     ("layers", "embed", "qkv"))
    assert zero1_leaf_axes(spec, m, DEFAULT_RULES) == (
        "layers", "fsdp", "qkv")


def test_zero1_axes_no_double_data():                 # test_sharding.py:72
    m = MeshShape.of(data=16, model=16)
    rules = DEFAULT_RULES.updated(embed="data")
    spec = ParamSpec((48, 5120, 2048), torch.bfloat16, "scaled",
                     ("layers", "embed", "qkv"))
    assert zero1_leaf_axes(spec, m, rules) == ("layers", "embed", "qkv")


def test_hint_is_noop_outside_rules():                # test_sharding.py:82
    x = torch.ones((4, 4))
    assert current_rules() is None
    assert hint(x, ("batch", "embed")) is x


def test_hint_keeps_the_shape_inside_rules():         # test_sharding.py:88
    """JAX's case is red (its jit under a 1-device mesh fails on the JAX
    version here); the port holds it to the shape being kept."""
    m = MeshShape.of(data=1, model=1)
    x = torch.ones((4, 4))
    with use_rules(m, DEFAULT_RULES):
        assert current_rules() == (m, DEFAULT_RULES)
        y = hint(x, ("batch", "embed"))
    assert y.shape == (4, 4) and torch.equal(y, x)
    assert current_rules() is None


def test_rules_updated_immutably():                   # test_sharding.py:95
    r2 = DEFAULT_RULES.updated(seq="model")
    assert DEFAULT_RULES.get("seq") is None
    assert r2.get("seq") == "model"


def test_default_rules_are_jax_copies():
    assert DEFAULT_RULES.table == jsh.DEFAULT_RULES.table
    assert Rules.make({"a": "b"}).table == jsh.Rules.make({"a": "b"}).table


def test_production_meshes():
    assert make_production_mesh() == MeshShape(("data", "model"), (16, 16))
    assert make_production_mesh(multi_pod=True) == MeshShape(
        ("pod", "data", "model"), (2, 16, 16))


# ------------------------------------------ every parameter of every config --
def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


#: leaves whose ZeRO-1 axes put 'fsdp' on the stacked 'layers' dim (their
#: other dims already on 'model' or not dividing 16), on both production
#: meshes. The port keeps one tensor a layer, so its sharded step must
#: realise these by placing whole layers (ROADMAP Queue 1, item 5)
FSDP_ON_LAYERS = {
    ("hymba-1.5b", "layers.attn_norm"), ("hymba-1.5b", "layers.ssm.a_log"),
    ("hymba-1.5b", "layers.ssm.dt_bias"), ("hymba-1.5b", "layers.ssm.norm"),
    ("qwen2.5-14b", "layers.attn.bq"), ("qwen2.5-14b", "layers.attn.bk"),
    ("qwen2.5-14b", "layers.attn.bv"), ("rwkv6-7b", "layers.att.ln_x")}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_every_param_spec_and_zero1_axes_equal_jax(arch, mesh):
    axes = MESHES[mesh]
    jm = jax_build(jconfigs.get_config(arch))
    tm = build_model(tconfigs.get_config(arch), device="meta")
    jspecs, tspecs = _flat(jm.param_specs()), _flat(tm.param_specs())
    assert jspecs.keys() == tspecs.keys()
    fake, port_mesh = FakeMesh(**axes), MeshShape.of(**axes)
    on_layers = set()
    for path, s in tspecs.items():
        j = jspecs[path]
        want = tuple(jsh.logical_to_spec(fake, jsh.DEFAULT_RULES, j.axes,
                                         j.shape))
        assert logical_to_spec(port_mesh, DEFAULT_RULES, s.axes,
                               s.shape) == want, path
        z = zero1_leaf_axes(s, port_mesh, DEFAULT_RULES)
        assert z == jopt.zero1_leaf_axes(j, fake, jsh.DEFAULT_RULES), path
        if s.axes[0] == "layers" and z[0] == "fsdp":
            on_layers.add((arch, path))
    assert on_layers == {x for x in FSDP_ON_LAYERS if x[0] == arch}
    # the whole trees, as the optimizer state lays them out
    got = opt_state_axes(tm.param_specs(), port_mesh, DEFAULT_RULES)
    want = jopt.opt_state_axes(jm.param_specs(), fake, jsh.DEFAULT_RULES)
    assert got["step"] == want["step"] == ()
    for key in ("m", "v"):
        assert _flat(got[key]) == _flat(want[key])
    plain = opt_state_axes(tm.param_specs(), port_mesh, DEFAULT_RULES,
                           zero1=False)
    assert _flat(plain["m"]) == {p: s.axes for p, s in tspecs.items()}


# --------------------------------------------------------------- placements --
def test_named_sharding_maps_specs_to_placements():
    m = MeshShape.of(pod=2, data=16, model=16)
    # batch over (pod, data) in the mesh's order: a Shard(0) on each
    assert named_sharding(m, DEFAULT_RULES, ("batch", "seq", "vocab"),
                          (256, 4096, 49408)) == (Shard(0), Shard(0),
                                                  Shard(2))
    # nothing divides: every mesh dim replicates
    assert named_sharding(m, DEFAULT_RULES, ("vocab", "embed"),
                          (49155, 2048)) == (Replicate(),) * 3
    assert named_sharding(MeshShape.of(data=16, model=16), DEFAULT_RULES,
                          ("embed", "qkv"), (2048, 4096)) == (Replicate(),
                                                              Shard(1))


def test_named_sharding_refuses_a_tuple_against_the_mesh_order():
    """DTensor splits a dim sharded over several mesh dims in mesh order;
    a rule whose tuple has another order is refused, never reordered."""
    m = MeshShape.of(pod=2, data=16, model=16)
    rules = DEFAULT_RULES.updated(batch=("data", "pod"))
    assert logical_to_spec(m, rules, ("batch",), (256,)) == (("data",
                                                              "pod"),)
    with pytest.raises(ValueError, match="mesh's order"):
        named_sharding(m, rules, ("batch", None), (256, 8))


def test_tree_shardings_with_and_without_shapes():
    mesh = make_production_mesh()
    tm = build_model(tconfigs.get_config("granite-3-2b"), device="meta")
    specs = tm.param_specs()
    got = _flat(tree_shardings(mesh, DEFAULT_RULES, axes_tree(specs),
                               shape_tree(specs)))
    flat_specs = _flat(specs)
    assert got.keys() == flat_specs.keys()
    for path, placements in got.items():
        s = flat_specs[path]
        assert placements == named_sharding(mesh, DEFAULT_RULES, s.axes,
                                            s.shape)
    # granite's vocab 49155 pads to 49408, which divides by 16
    assert got["embed"] == (Replicate(), Shard(0))
    # a cache's axes without shapes: no divisibility fallback
    cache = tree_shardings(mesh, DEFAULT_RULES, tm.cache_axes())
    assert cache.k == (Shard(1), Shard(2))
    assert cache.kpos == (Replicate(), Replicate())


def test_param_specs_of_a_jax_spec_type_match():
    """ParamSpec keeps JAX's fields and its rank check."""
    s = ParamSpec((2, 3), torch.float32, "zeros", ("a", None))
    j = JSpec((2, 3), jnp.float32, "zeros", ("a", None))
    assert (s.shape, s.init, s.axes, s.init_scale) == (
        j.shape, j.init, j.axes, j.init_scale)
    with pytest.raises(ValueError):
        ParamSpec((2, 3), torch.float32, "zeros", ("a",))
    assert s.stacked(4) == ParamSpec((4, 2, 3), torch.float32, "zeros",
                                     ("layers", "a", None))
    assert len(tree_leaves({"x": s, "y": {"z": s}})) == 2


@pytest.mark.parametrize("kind", ("all-gather", "reduce-scatter",
                                  "all-reduce", "all-to-all"))
def test_collectives_on_a_mesh_shape_take_meta_tensors_only(kind):
    """On a MeshShape (the dry run's plan) a collective on meta tensors
    is logged and gives the result's shape; a real tensor raises, as
    there are no ranks to exchange with (and no values to give back)."""
    from repro_torch.sharding import collectives as col
    mesh = make_production_mesh(multi_pod=True)
    call = {"all-gather": lambda x: col.gather_dim(x, mesh, "data", 1),
            "reduce-scatter": lambda x: col.scatter_sum_dim(x, mesh,
                                                            "data", 1),
            "all-reduce": lambda x: col.all_reduce_sum(x, mesh,
                                                       ("pod", "data")),
            "all-to-all": lambda x: col.all_to_all0(x, mesh, "model")}[kind]
    shape = {"all-gather": (16, 2, 3), "reduce-scatter": (16, 32, 3),
             "all-reduce": (16, 2, 3), "all-to-all": (16, 2, 3)}[kind]
    want = {"all-gather": (16, 32, 3), "reduce-scatter": (16, 2, 3)}.get(
        kind, shape)
    col.LOG.reset()
    out = call(torch.empty(shape, device="meta"))
    assert out.is_meta and tuple(out.shape) == want
    assert col.LOG.n_calls() == {kind: 1}
    with pytest.raises(ValueError, match="meta"):
        call(torch.zeros(shape))
    if kind == "reduce-scatter":
        with pytest.raises(ValueError, match="meta"):
            col.make_grad_allreduce(mesh)({"g": torch.zeros(32, 3)})
    col.LOG.reset()
