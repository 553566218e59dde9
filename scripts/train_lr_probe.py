#!/usr/bin/env python3
"""The loss on the repeated batch of chip_smoke.py's dense training runs
at several AdamW learning rates, through the flash kernel and through
the plain attention (``attn_impl="chunked"``): whether a loss that does
not fall is the rate's or the kernel's.

Each run is ``chip_smoke.run_train`` (phase 9: the config at its TRAIN
depth, 5 pipeline batches, then the last one repeated 3 times) with the
rate replaced; the gate's checks are recorded instead of raised. Prints
one JSON line a run at the end: the rate, the path, the losses on the
repeated batch, whether the last is below the first (the gate) and
whether any step rose. Run on the card from the repository root:

    python3 scripts/train_lr_probe.py
"""
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

# (arch, AdamW rate, attn_impl: None is the model's default, the kernel)
RUNS = [(arch, lr, impl) for arch in ("qwen2.5-14b", "stablelm-12b")
        for lr, impl in ((1e-3, None), (1e-3, "chunked"), (3e-4, None),
                         (1e-4, None))] + [("granite-3-2b", 1e-3, None)]


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("train_lr_probe: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    failed, trained = [], []
    cs.check = lambda ok, msg: ok or failed.append(msg)
    emit = cs.emit

    def keep(**kw):  # the train lines still print; their losses are kept
        if kw.get("phase") == "train":
            trained.append(kw)
        emit(**kw)

    cs.emit = keep
    build = cs.build_model
    lines = []
    for arch, lr, impl in RUNS:
        cs.TRAIN_LR = {arch: lr}
        cs.build_model = ((lambda cfg, device: build(cfg, device=device,
                                                     attn_impl=impl))
                          if impl else build)
        del failed[:]
        cs.run_train(arch)
        repeated = trained[-1]["losses"][cs.TRAIN[arch][3]:]
        lines.append(dict(arch=arch, lr=lr, attn_impl=impl or "flash",
                          repeated_losses=repeated,
                          fell=repeated[-1] < repeated[0],
                          rose_at_a_step=any(b > a for a, b in
                                             zip(repeated, repeated[1:])),
                          checks_failed=list(failed)))
    for line in lines:
        print(json.dumps(dict(lr_probe=True, **line)), flush=True)


if __name__ == "__main__":
    main()
