"""repro_torch.train - optimizer, train step, loss and checkpointing (twin of
the JAX package's ``repro.train``).

Training loops consume batches through ``DeviceFeeder`` (re-exported from
``repro_torch.feed``): service fetch and the host→device copy run on a
background thread behind a double buffer, so the step never blocks on input.
On the card the flash-attention, ``ssd_scan`` and ``moe_router`` kernels
train through their backward kernels; ``decode_attention`` (serving) raises
when a gradient would pass through it.
"""
from ..feed import DeviceFeeder, FeedMetrics
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .optimizer import AdamWConfig, apply_updates, init_state, lr_schedule
from .step import (
    cross_entropy,
    init_train_state,
    make_eval_step,
    make_loss_fn,
    make_train_step,
)

__all__ = [
    "AdamWConfig",
    "DeviceFeeder",
    "FeedMetrics",
    "apply_updates",
    "cross_entropy",
    "init_state",
    "init_train_state",
    "latest_step",
    "lr_schedule",
    "make_eval_step",
    "make_loss_fn",
    "make_train_step",
    "restore_checkpoint",
    "save_checkpoint",
]
