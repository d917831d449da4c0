"""The criteria the benchmark's configurations use."""

from .basic import l1_loss, mse_loss

LOSSES = {"mse": mse_loss, "l2": mse_loss, "l1": l1_loss}


def get_loss(name, device=None):
    return LOSSES[name]
