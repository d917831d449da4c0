"""Loss registry (PyTorch port of dbw_tpu/losses/__init__.py).

``get_loss(name)`` returns a ready-to-call loss: the functions as they are
and the classes instantiated with their defaults, as the JAX package does,
so that every entry is called on (imgs, rec). ``tv`` (one image argument)
and ``chamfer`` (a pair of results) are in the table as in the JAX package,
and, as there, a model whose criterion is one of them fails in its first
loss evaluation. An unknown name raises KeyError.
"""

from ..utils.device import DEFAULT_DEVICE
from .basic import (bce_with_logits_loss, huber_loss, l1_loss, mse2psnr, mse_loss,
                    total_variation, tv_norm_funcs)
from .chamfer import chamfer_distance
from .ssim import SSIM, ssim_loss
from .vgg import LPIPSLoss, PerceptualLoss, VGG16Features

LOSSES = {
    "bce": bce_with_logits_loss,
    "mse": mse_loss,
    "l2": mse_loss,
    "l1": l1_loss,
    "huber": huber_loss,
    "perceptual": PerceptualLoss,
    "lpips": LPIPSLoss,
    "ssim": SSIM,
    "chamfer": chamfer_distance,
    "tv": total_variation,
}


def get_loss(name, device=DEFAULT_DEVICE):
    """Name -> loss; the VGG16 losses build their features on ``device``."""
    entry = LOSSES[name]
    if entry in (PerceptualLoss, LPIPSLoss):
        return entry(device=device)
    return entry() if isinstance(entry, type) else entry

