"""Training substrate: AdamW, the microbatched train step with remat,
int8 error-feedback gradient compression and checkpointing, the sharded
step on a mesh (``train.sharded``); and the serving steps."""
from repro_torch.train.optimizer import (OptConfig, adamw_init, adamw_update,
                                         lr_schedule)
from repro_torch.train.step import (TrainConfig, init_train_state,
                                    make_prefill_step, make_serve_step,
                                    make_train_step)

__all__ = ["OptConfig", "adamw_init", "adamw_update", "lr_schedule",
           "TrainConfig", "init_train_state", "make_prefill_step",
           "make_serve_step", "make_train_step"]
