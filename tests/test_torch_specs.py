"""The port's spec surface against the JAX package's, for all ten configs
of src/repro/configs/ at the smoke size and at full size: the stacked
spec tree (shapes, dtypes, init styles, logical axes), n_params,
n_active_params, model_flops of every shape cell, the cache and input
specs and axes. Full size is built on the meta device on the port's side
and as ParamSpecs only on JAX's: nothing is allocated."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import hymba, moe, transformer  # noqa: E402

ARCHS = sorted(jconfigs.ARCHS)
SIZES = ("smoke", "full")


def _cfgs(arch, size):
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    return (j.smoke(), t.smoke()) if size == "smoke" else (j, t)


def _models(arch, size):
    jcfg, tcfg = _cfgs(arch, size)
    return jax_build(jcfg), build_model(tcfg, device="meta")


def _dtype(d):
    """'bfloat16' / 'float32' / 'int32' of a JAX or a torch dtype."""
    return str(d).replace("torch.", "") if isinstance(d, torch.dtype) \
        else np.dtype(d).name


def _flat(tree, prefix=""):
    """{dotted path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _spec_rows(tree):
    return {p: (tuple(s.shape), _dtype(s.dtype), s.init, tuple(s.axes),
                s.init_scale) for p, s in _flat(tree).items()}


def test_all_ten_configs_are_covered():
    assert len(ARCHS) == 10 and sorted(tconfigs.ARCHS) == ARCHS


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax(arch, size):
    """Leaf for leaf: shape, dtype (bf16 <-> bf16, f32 <-> f32), init
    style, axes; and shape_tree / axes_tree of them."""
    jm, tm = _models(arch, size)
    jspecs, tspecs = jm.param_specs(), tm.param_specs()
    assert _spec_rows(tspecs) == _spec_rows(jspecs)
    shapes = _flat(cm.shape_tree(tspecs))
    jshapes = _flat(jcm.shape_tree(jspecs))
    assert shapes.keys() == jshapes.keys()
    for path, t in shapes.items():
        assert t.device.type == "meta"
        assert (tuple(t.shape), _dtype(t.dtype)) == (
            tuple(jshapes[path].shape), _dtype(jshapes[path].dtype))
    assert _flat(cm.axes_tree(tspecs)) == _flat(jcm.axes_tree(jspecs))
    assert tm.layer_specs().keys() == jm.layer_specs().keys()


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_counts_and_model_flops_equal_jax(arch, size):
    jm, tm = _models(arch, size)
    assert tm.n_params() == jm.n_params() == jcm.count_params(
        jm.param_specs())
    assert tm.n_active_params() == jm.n_active_params()
    assert tm.n_params() == sum(p.numel() for p in tm.parameters())
    for name, cell in tconfigs.SHAPES.items():
        assert tm.model_flops(cell) == jm.model_flops(
            jconfigs.SHAPES[name]), name


def _struct_rows(x):
    """A cache/input spec tree as {path: (shape, dtype)} or its axes."""
    if dataclasses.is_dataclass(x):
        return {f.name: _struct_rows(getattr(x, f.name))
                for f in dataclasses.fields(x) if f.name != "extras"}
    if isinstance(x, dict):
        return {k: _struct_rows(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return x
    return (tuple(x.shape), _dtype(x.dtype))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_input_specs_equal_jax(arch, size):
    jm, tm = _models(arch, size)
    assert _struct_rows(tm.cache_specs(3, 40)) == _struct_rows(
        jm.cache_specs(3, 40))
    assert _struct_rows(tm.cache_axes()) == _struct_rows(jm.cache_axes())
    for name, cell in tconfigs.SHAPES.items():
        jcell = jconfigs.SHAPES[name]
        assert tm.cache_len(cell) == jm.cache_len(jcell)
        assert _struct_rows(tm.input_specs(cell)) == _struct_rows(
            jm.input_specs(jcell)), name
        assert _struct_rows(tm.input_axes(cell)) == _struct_rows(
            jm.input_axes(jcell)), name
        for v in cm.tree_leaves(tm.input_specs(cell)):
            assert v.device.type == "meta"
    if hasattr(jm.cache_specs(1, 8), "extras"):
        assert jm.cache_specs(1, 8).extras == {}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_and_init_tree_give_the_spec_shapes(arch):
    _, tcfg = _cfgs(arch, "smoke")
    model = build_model(tcfg, device="cpu")
    model.init_params(torch.Generator().manual_seed(0))
    named = model.named_param_specs()
    sd = model.state_dict()
    assert named.keys() == sd.keys()
    for name, spec in named.items():
        assert tuple(sd[name].shape) == spec.shape
        assert sd[name].dtype == spec.dtype
        assert bool(torch.isfinite(sd[name]).all())
        assert spec.axes[0] != "layers"   # the per-layer view
    tree = cm.init_tree(model.param_specs(), torch.Generator().manual_seed(0),
                        device="cpu")
    rows = _spec_rows(model.param_specs())
    got = _flat(tree)
    assert got.keys() == rows.keys()
    for path, t in got.items():
        assert (tuple(t.shape), _dtype(t.dtype)) == rows[path][:2]


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "dbrx-132b", "arctic-480b",
                                  "hymba-1.5b", "whisper-medium"])
def test_family_spec_helpers_equal_jax(arch):
    """The module-level spec helpers (attention, mlp, norms, MoE experts,
    hymba's SSM heads, whisper's encoder layers) equal JAX's."""
    from repro.models import moe as jmoe
    from repro.models import transformer as jtr
    jcfg, tcfg = _cfgs(arch, "full")
    L = 3
    pairs = [(transformer.attention_specs(tcfg, L),
              jtr.attention_specs(jcfg, L)),
             (transformer.attention_specs(tcfg, L, cross=True),
              jtr.attention_specs(jcfg, L, cross=True)),
             (transformer.mlp_specs(tcfg, L), jtr.mlp_specs(jcfg, L)),
             (transformer._norm_spec(tcfg, L), jtr._norm_spec(jcfg, L)),
             (transformer._final_norm_spec(tcfg),
              jtr._final_norm_spec(jcfg))]
    jm, tm = _models(arch, "full")
    if tcfg.family == "moe":
        pairs.append((moe.moe_specs(tcfg, L), jmoe.moe_specs(jcfg, L)))
        assert tm.moe_weight_axes_note() == jm.moe_weight_axes_note()
    if tcfg.family == "hybrid":
        pairs.append((tm.ssm_specs(L), jm.ssm_specs(L)))
        assert isinstance(tm, hymba.HymbaLM)
    if tcfg.family == "encdec":
        pairs.append((tm.encoder_layer_specs(), jm.encoder_layer_specs()))
    for t, j in pairs:
        assert _spec_rows(t) == _spec_rows(j)


def test_full_size_specs_allocate_nothing():
    """arctic-480b (478.6 B params) on meta: every parameter on meta."""
    tm = build_model(tconfigs.get_config("arctic-480b"), device="meta")
    assert all(p.device.type == "meta" for p in tm.parameters())
    assert tm.n_params() == 478_584_357_888
    assert jax.devices()[0].platform == "cpu"
