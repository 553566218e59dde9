"""Training flow: JoSS-placed data pipeline -> train step -> async
checkpointing -> resume. The port of ``examples/train_lm.py``.

Run:  PYTHONPATH=src python -m repro_torch.train.lm [--arch ARCH]
          [--smoke] [--n-layers N] [--steps N] [--batch B] [--seq-len S]
          [--device cpu] [--resume] [--ckpt-dir DIR]

The corpus is 32 seeded token shards placed on ``VirtualCluster([4, 4])``;
``JossDataPipeline`` assigns them to pods by JoSS policy B and serves
pod-major batches. ``--smoke`` takes the arch's smoke config with a
512-token vocab (the example's demo model); the step, loss and locality
report are printed every 10 steps and at the end. Encdec (whisper)
trains on seeded log-mel frame embeddings beside the pipeline's tokens
(``--frames`` a sequence, the sequence length by default), vlm on seeded
patch embeddings, as ``models.side_inputs`` draws them for each step.
Checkpoints go to ``--ckpt-dir`` (``build/train_ckpt`` in the checkout by
default) every ``--ckpt-every`` steps and at the end; ``--resume`` starts
from the latest.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import List, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.core.topology import VirtualCluster
from repro_torch.data import JossDataPipeline, TokenStore
from repro_torch.device import resolve_device
from repro_torch.models import build_model, side_inputs
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import OptConfig, adamw_init
from repro_torch.train.step import TrainConfig, make_train_step

DEFAULT_CKPT = Path(__file__).resolve().parents[3] / "build" / "train_ckpt"


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke config, vocab 512")
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--frames", type=int, default=None,
                    help="encdec: audio frames a sequence (default: the "
                         "sequence length)")
    ap.add_argument("--device", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT))
    ap.add_argument("--ckpt-every", type=int, default=20)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke().scaled(vocab=512)
    if args.n_layers:
        cfg = cfg.scaled(n_layers=args.n_layers)
    steps, B, S = args.steps, args.batch, args.seq_len
    model = build_model(cfg, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {cfg.name} {n_params:,} params | {steps} steps | "
          f"batch {B}x{S} | {dev}")

    # JoSS-placed data pipeline over a 2-pod virtual cluster
    cluster = VirtualCluster([4, 4])
    store = TokenStore(cluster, n_shards=32, seqs_per_shard=64,
                       seq_len=S, vocab=cfg.vocab, seed=0)
    pipe = JossDataPipeline(store, global_batch=B, seed=1)

    tcfg = TrainConfig(opt=OptConfig(lr=3e-4, warmup_steps=20,
                                     total_steps=steps))
    step_fn = make_train_step(model, tcfg)
    model.init_params(torch.Generator(device=dev).manual_seed(0))
    opt_state = adamw_init(dict(model.named_parameters()))
    start = 0
    if args.resume and ckpt.latest_step(args.ckpt_dir) is not None:
        state, start = ckpt.restore(args.ckpt_dir, {
            "params": model.state_dict(), "opt": opt_state})
        model.load_state_dict(state["params"])
        opt_state = state["opt"]
        print(f"resumed from step {start}")

    saver = ckpt.AsyncCheckpointer(args.ckpt_dir, keep=2)
    t0 = time.perf_counter()
    for i, batch_np in enumerate(pipe.batches(steps - start)):
        step = start + i + 1
        batch = {"tokens": torch.as_tensor(batch_np, device=dev)}
        for name, x in side_inputs(cfg, B, seed=step,
                                   n_frames=args.frames or S).items():
            batch[name] = torch.as_tensor(x, device=dev).to(cfg.tdtype)
        opt_state, metrics = step_fn(opt_state, batch)
        if step % 10 == 0 or step == steps:
            print(f"step {step:4d}  loss {float(metrics['loss']):.4f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"gnorm {float(metrics['grad_norm']):.2f}  "
                  f"{(time.perf_counter() - t0) / (i + 1):.2f}s/step")
        if step % args.ckpt_every == 0 or step == steps:
            saver.submit(step, {"params": model.state_dict(),
                                "opt": opt_state})
    saver.wait()
    rep = pipe.locality_report()
    print(f"data locality: host={rep.host_rate:.2f} pod={rep.pod_rate:.2f} "
          f"off-pod={rep.off_pod_rate:.2f} (inter-pod bytes="
          f"{rep.int_bytes / 2**20:.1f} MiB)")
    print(f"final checkpoint: step {ckpt.latest_step(args.ckpt_dir)}")


if __name__ == "__main__":
    main()
