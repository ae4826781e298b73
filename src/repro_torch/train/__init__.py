"""Training (counterpart of ``repro.train``): the optimizer and its
schedules, checkpoints, and the loop over the diffusion data pipeline."""
from .checkpoint import CheckpointManager
from .loop import TrainResult, train
from .optimizer import Optimizer, TrainState, adamw
from .schedule import constant, warmup_cosine

__all__ = ["CheckpointManager", "Optimizer", "TrainResult", "TrainState",
           "adamw", "constant", "train", "warmup_cosine"]
