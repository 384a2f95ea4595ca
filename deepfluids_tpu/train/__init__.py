"""Training runtime: losses, optimizer/schedule, the Trainer.

Reference parity target: ``trainer.py`` of byungsook/deep-fluids
(SURVEY.md §2 "Trainer", §3.1/3.3/3.4 call stacks [M][B]) — rebuilt as
jit/pjit-compiled functional train steps over a device mesh with .npz
checkpoints, instead of a TF1 Supervisor session.
"""

from deepfluids_tpu.train.losses import (
    l1,
    field_loss,
    generator_loss,
    autoencoder_loss,
    latent_window_loss,
)
from deepfluids_tpu.train.state import (
    cosine_lr_schedule,
    make_optimizer,
    create_train_state,
)
from deepfluids_tpu.train.trainer import Trainer

__all__ = [
    "l1",
    "field_loss",
    "generator_loss",
    "autoencoder_loss",
    "latent_window_loss",
    "cosine_lr_schedule",
    "make_optimizer",
    "create_train_state",
    "Trainer",
]
