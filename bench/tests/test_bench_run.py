"""A run of the harness on the CPU at a tiny size, without its look for a
card: the result line's schema, the refusals, and ``correct`` false under
the control and under each fault planted in the timed path."""
from __future__ import annotations

import copy
import json
import shutil
import subprocess
import sys
import time
import weakref
from pathlib import Path

import pytest
import torch

from bench import run as runner
from bench.cell import Cell

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
SEED = 2 ** 31 + 12345
DENSE = dict(name="tiny-dense", family="dense", n_layers=2, d_model=64,
             n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=250,
             pad_vocab_to=256, tie_embeddings=True, rope_theta=10000.0,
             rms_norm_eps=1e-6, dtype="bfloat16")
OPT = json.loads((ROOT / "bench/traffic/train_b16_s1024.json").read_text()
                 )["optimizer"]
TRAIN = dict(driver="train", batch=2, seq_len=64, optimizer=OPT,
             traced_steps=1)
PREFILL = dict(driver="prefill", batch=2, prompt_lens=[16, 32],
               length_weights=[1, 1], replay_seed=0, replay_batches=8,
               gen_len=6, rate=50.0, traced_batches=2, check_requests=4)
# limits for these tiny sizes, between the program's readings and the
# control's (set as the cells' are: readings of both, room on each side)
TRAIN_LIMITS = {"first_loss_gap": 1e-3, "grad_gap": 0.02, "change_gap": 0.5}
SERVE_LIMITS = {"logit_gap": 0.05}
E2E = [{"name": "setup_s", "unit": "s"},
       {"name": "train_tokens_per_s", "unit": "tokens/s"},
       {"name": "ttft_p95_ms", "unit": "ms"}]


def cell(conf, traffic, limits):
    return Cell("tiny", 1, conf, traffic, limits, E2E, [])


def run(c, **kw):
    return runner.run_cell(c, SEED, 0.3, False, CPU, time.perf_counter(),
                           **kw)


def test_result_line_schema(capsys):
    out = runner.result_line(run(cell(DENSE, TRAIN, TRAIN_LIMITS)), "cpu",
                             "none")
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "check"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    assert set(out["metrics"]) == {"setup_s", "train_tokens_per_s"}
    assert all(set(m) == {"value", "unit"} for m in out["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(out["device"])
    assert set(out["check"]) == set(TRAIN_LIMITS)
    assert all(set(c) == {"value", "limit"} for c in out["check"].values())
    json.dumps(out)
    err = capsys.readouterr().err.strip().splitlines()
    assert [ln.split()[1] for ln in err[-3:]] == list(TRAIN_LIMITS)


def test_forbidden_modules():
    assert runner.forbidden(["jax.numpy", "repro.core.joss", "flax",
                             "repro_torch.models", "jaxlib", "numpy",
                             "jaxtyping"]) == ["flax", "jax", "jaxlib",
                                               "repro"]
    assert runner.forbidden(["repro_torch", "torch", "bench.run"]) == []


def test_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "bench/run.py", "--workload",
                          "granite-3-2b.train", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    out = subprocess.run([sys.executable, "bench/run.py", "--workload",
                          "granite-3-2b.train", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_training_sound_control_and_faults(monkeypatch):
    c = cell(DENSE, TRAIN, TRAIN_LIMITS)
    assert run(c)["correct"] is True
    assert run(c, control="fp8")["correct"] is False
    assert run(c, fault="half_batch")["correct"] is False

    import repro_torch.train as rt
    from repro_torch.models.transformer import TransformerLM

    def unchanged(model, tcfg):
        def step(opt_state, batch):
            loss, _ = model.loss(batch)
            return opt_state, {"loss": loss.detach(),
                               "grad_norm": torch.zeros(())}
        return step

    with monkeypatch.context() as m:
        m.setattr(rt, "make_train_step", unchanged)
        got = run(c)
        assert got["correct"] is False
        assert got["check"]["change_gap"]["value"] == pytest.approx(1.0)

    loss = TransformerLM.loss

    def half(self, batch, **kw):
        b = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
        return loss(self, b, **kw)

    with monkeypatch.context() as m:
        m.setattr(TransformerLM, "loss", half)
        assert run(c)["correct"] is False


def test_serving_sound_control_and_faults(monkeypatch):
    c = cell(DENSE, PREFILL, SERVE_LIMITS)
    sound = run(c)
    assert sound["correct"] is True
    assert sound["info"]["tokens_compared"] >= 12
    assert run(c, control="fp8")["correct"] is False

    import repro_torch.train as rt
    make = rt.make_serve_step

    def altered(model):
        step = make(model)

        def serve(cache, tokens, pos):
            nxt, logits, cache = step(cache, tokens, pos)
            return (nxt + 1) % DENSE["vocab"], logits, cache
        return serve

    def unchanged(model):
        step = make(model)

        def serve(cache, tokens, pos):
            nxt, logits, _ = step(copy.deepcopy(cache), tokens, pos)
            return nxt, logits, cache
        return serve

    for fault in (altered, unchanged):
        with monkeypatch.context() as m:
            m.setattr(rt, "make_serve_step", fault)
            assert run(c)["correct"] is False, fault.__name__


def test_serving_check_upcasts_a_leaf_at_a_time(monkeypatch):
    """The serving check reads the served bfloat16 weights through a float32
    view: the logit gaps of an eager float32 copy of every leaf, bit for
    bit, with the control too, and no more than two upcast leaves alive at
    once."""
    from bench import harness, reference
    picked = [harness.Served(("prompt", i), 2, i % 2, P, [7, 91, 3, 200])
              for i, P in enumerate((32, 16, 32))]
    alive, most = [], [0]

    class Counted(reference.Float32View):
        def __getitem__(self, name):
            t = super().__getitem__(name)
            if t.dtype != self.sd[name].dtype:
                alive.append(weakref.ref(t))
                most[0] = max(most[0], sum(r() is not None for r in alive))
            return t

    for control in (None, "fp8"):
        ctx = harness.Context(cell(DENSE, PREFILL, SERVE_LIMITS), SEED, CPU,
                              control)
        with monkeypatch.context() as m:
            m.setattr(reference, "Float32View", Counted)
            got = harness.logit_gaps(ctx, picked)
        with monkeypatch.context() as m:
            m.setattr(reference, "Float32View",
                      lambda sd: reference.params(sd, grad=False))
            want = harness.logit_gaps(ctx, picked)
        assert got == want and got["tokens_compared"] == 12
        assert got["logit_gap"] > 0 or control is None
    assert len(alive) > 2 * 8 * DENSE["n_layers"] and 1 <= most[0] <= 2


def test_prefill_replay_is_fixed_and_follows_its_weights():
    from bench.drivers import prefill
    t = dict(PREFILL, prompt_lens=[16, 32, 48], length_weights=[1, 0, 3],
             replay_batches=400)
    got = prefill.replay(t)
    assert got == prefill.replay(t) and len(got) == 400
    assert 32 not in got and 250 < got.count(48) < 350
    assert prefill.replay(dict(t, replay_seed=1)) != got
