"""The program's spans (``repro_torch.spans``) on the CPU: under
``torch.profiler`` the train step, the router, the prefill and the decode
step each record their range once a call, and the head its range once a
call of every family, nested as the table states; with no profiler
``span()`` enters no ``record_function``; the profiler moves no bit of a
loss, a parameter or a token."""
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import configs, spans  # noqa: E402
from repro_torch.kernels.autograd import BACKWARD_SPANS  # noqa: E402
from repro_torch.models import build_model, prefix_len, side_inputs  # noqa: E402,E501
from repro_torch.serve.lm import route_requests  # noqa: E402
from repro_torch.sharding import tp as tpm  # noqa: E402
from repro_torch.train import (OptConfig, TrainConfig, adamw_init,  # noqa: E402
                               make_prefill_step, make_serve_step,
                               make_train_step)

B, P, G, STEPS = 2, 16, 3, 2
#: the families, one smoke config each
ARCHS = ["granite-3-2b", "rwkv6-7b", "hymba-1.5b", "dbrx-132b",
         "internvl2-26b", "whisper-medium"]
NEW = {k for k in spans.SPANS if not k.endswith("_backward")}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(arch, vocab_ranks=0):
    cfg = configs.get_config(arch).smoke().scaled(vocab=250)
    model = build_model(cfg, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    model.init_params(gen)
    if vocab_ranks:
        tpm.place_virtual(model, vocab_ranks)
        assert model.vocab_tp()
    return cfg, model


def _batch(cfg, i):
    gen = torch.Generator()
    gen.manual_seed(100 + i)
    out = {"tokens": torch.randint(0, cfg.vocab, (B, P), generator=gen,
                                   dtype=torch.int32)}
    out.update({k: torch.from_numpy(x) for k, x in side_inputs(
        cfg, B, seed=i, n_frames=P).items()})
    return out


def _drive(cfg, model, n_micro=1):
    """STEPS train steps, then one routed batch: its prefill and G - 1
    decode steps. (losses, parameters, tokens)."""
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=0),
                       n_micro=n_micro)
    opt = adamw_init(dict(model.named_parameters()))
    step = make_train_step(model, tcfg)
    losses = []
    for i in range(STEPS):
        opt, met = step(opt, _batch(cfg, i))
        losses.append(met["loss"])
    route_requests(B, P, G)
    V = prefix_len(cfg)
    nxt, cache = make_prefill_step(model, cache_len=V + P + G)(
        _batch(cfg, STEPS))
    decode, toks = make_serve_step(model), [nxt]
    for j in range(G - 1):
        nxt, _, cache = decode(cache, nxt, V + P + j)
        toks.append(nxt)
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return torch.stack(losses), params, torch.cat(toks, dim=1)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    names = {spans.PREFIX + k: k for k in spans.SPANS}
    ranges = [e for e in prof.events() if e.name in names]
    return out, ranges, names


def _ancestors(e, names):
    out, p = [], e.cpu_parent
    while p is not None:
        if p.name in names:
            out.append(names[p.name])
        p = p.cpu_parent
    return out


def _counts(ranges, names):
    got = {}
    for e in ranges:
        got[names[e.name]] = got.get(names[e.name], 0) + 1
    return got


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_each_span_once_a_call_nested_as_stated(arch, n_micro):
    cfg, model = _model(arch)
    _, ranges, names = _profiled(lambda: _drive(cfg, model, n_micro))
    got = _counts(ranges, names)
    per_step = STEPS * n_micro
    want = {"train.forward": per_step, "train.optimizer": STEPS, "serve.route": 1, "serve.prefill": 1,
            "serve.decode_step": G - 1,
            "model.unembed": per_step + 1 + (G - 1)}
    assert {k: v for k, v in got.items() if k in NEW} == want
    parents = {}
    for e in ranges:
        up = _ancestors(e, names)
        parents.setdefault(names[e.name], set()).add(up[0] if up else None)
    assert parents["model.unembed"] == {"train.forward", "serve.prefill",
                                        "serve.decode_step"}
    # the backward ranges too: loss.backward() opens no span
    for k in set(got) - {"model.unembed"}:
        assert parents[k] == {None}, (k, parents[k])
    assert ("flash_attention_backward" in got) == (arch != "rwkv6-7b")


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen3-4b"])
def test_vocab_parallel_head_once_a_call(arch):
    """Under vocab parallelism (2 virtual 'model' ranks) the head's range
    is ``logit_parts``' alone: unembed gathers its parts outside it."""
    cfg, model = _model(arch, vocab_ranks=2)
    _, ranges, names = _profiled(lambda: _drive(cfg, model))
    got = _counts(ranges, names)
    assert got["model.unembed"] == STEPS + 1 + (G - 1)
    for e in ranges:
        if e.name == spans.PREFIX + "model.unembed":
            assert "model.unembed" not in _ancestors(e, names)


@pytest.mark.parametrize("arch", ["granite-3-2b", "rwkv6-7b"])
def test_profiler_moves_no_bit(arch):
    cfg, model = _model(arch)
    plain = _drive(cfg, model)
    cfg, model = _model(arch)
    traced, ranges, _ = _profiled(lambda: _drive(cfg, model))
    assert ranges
    assert torch.equal(plain[0], traced[0])
    assert plain[1].keys() == traced[1].keys()
    for n, p in plain[1].items():
        assert torch.equal(p, traced[1][n]), n
    assert torch.equal(plain[2], traced[2])


class _Counting:
    """Stands in for ``torch.profiler.record_function`` and counts the
    ranges entered."""
    entered = 0

    def __init__(self, name):
        self.inner = _REAL(name)

    def __enter__(self):
        type(self).entered += 1
        return self.inner.__enter__()

    def __exit__(self, *exc):
        return self.inner.__exit__(*exc)


_REAL = torch.profiler.record_function


def test_no_profiler_enters_no_record_function(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _Counting)
    monkeypatch.setattr(_Counting, "entered", 0)
    cfg, model = _model("granite-3-2b")
    _drive(cfg, model)
    assert _Counting.entered == 0
    off = spans.span("train.forward")
    assert off is spans.span("serve.prefill")      # the shared no-op
    with off as x:
        assert x is None
    _, ranges, _ = _profiled(lambda: _drive(cfg, model))
    assert _Counting.entered == len(ranges) > 0    # the patch is read


def test_span_enters_its_range_under_a_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("serve.route"):
            torch.ones(2).sum()
    assert "repro_torch::serve.route" in {e.name for e in prof.events()}
    assert not isinstance(spans.span("serve.route"),
                          torch.profiler.record_function)


def test_span_table():
    assert spans.PREFIX == "repro_torch::"
    assert len(set(spans.SPANS)) == len(spans.SPANS)
    assert NEW == {"train.forward", "train.optimizer", "serve.route",
                   "serve.prefill", "serve.decode_step", "model.unembed"}


def test_backward_spans_unchanged():
    assert BACKWARD_SPANS == {
        "flash_attention": "repro_torch::flash_attention_backward",
        "gla_scan": "repro_torch::gla_scan_backward",
        "moe_dispatch": "repro_torch::moe_dispatch_backward"}
    assert {spans.PREFIX + k for k in spans.SPANS} >= set(
        BACKWARD_SPANS.values())
