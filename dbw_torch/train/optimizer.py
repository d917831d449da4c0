"""Optimizer factory (PyTorch port of dbw_tpu/train/optimizer.py).

Two parameter groups: ``texture*`` parameters at the texture learning rate,
everything else at the main one; the schedulers write each group's ``lr``.

``adam`` is ``torch.optim.Adam`` with the configured betas and eps
(defaulting to optax.scale_by_adam's (0.9, 0.999) and 1e-8). Every other
name of the JAX package is a small ``torch.optim.Optimizer`` with the
semantics and defaults of the optax transformation the JAX package builds,
not torch's own optimizer of that name: per leaf ``u = transform(g,
state)``, then ``p += u * -lr``.

- ``sgd``: ``optax.trace(momentum)`` (``g + momentum * trace``), or the
  gradient itself without momentum;
- ``adamw``: ``scale_by_adam()`` at its defaults (the configured betas and
  eps are ignored, as in the JAX package), then ``add_decayed_weights``
  (``weight_decay``, default 1e-2);
- ``adamax``: ``scale_by_adamax`` (0.9, 0.999, 1e-8);
- ``rmsprop``: ``scale_by_rms`` (decay 0.9, eps 1e-8 inside the square
  root, initial scale 0);
- ``adagrad``: ``scale_by_rss`` (initial accumulator 0.1, eps 1e-7, and 0
  where the sum is 0);
- ``adadelta``: ``scale_by_adadelta`` (rho 0.9, eps 1e-6).

Each rule's per-leaf state carries optax's field names (``fields``),
and ``count`` where optax counts steps; ``train/checkpoint.py`` writes it
in optax's layout.
"""

from __future__ import annotations

import torch

TEXTURE_PARAM_NAMES = ("texture_bkg", "texture_ground", "textures")


def param_groups(params: dict, lr_main, lr_texture):
    main = [p for k, p in params.items() if k not in TEXTURE_PARAM_NAMES]
    tex = [p for k, p in params.items() if k in TEXTURE_PARAM_NAMES]
    return [{"params": main, "lr": lr_main, "name": "main"},
            {"params": tex, "lr": lr_texture, "name": "texture"}]


def _bias_correction(m, decay, count):
    """optax's m / (1 - decay ** count), the power taken in float32."""
    d = torch.tensor(decay, dtype=torch.float32, device=m.device)
    return m / (1.0 - d ** count)


class OptaxRule(torch.optim.Optimizer):
    """An optax gradient transformation as a torch optimizer: the state of a
    leaf is a dict of optax's fields (``count``: the step count, where the
    rule keeps one)."""

    name = ""
    fields = ()
    counted = False

    def __init__(self, groups, **hyper):
        super().__init__(groups, dict(lr=1e-3, **hyper))

    def init_state(self, p):
        """The state of a leaf before its first step (optax's init)."""
        st = {f: torch.zeros_like(p, memory_format=torch.preserve_format)
              for f in self.fields}
        if self.counted:
            st["count"] = 0
        return st

    def transform(self, g, st, p, h):
        """The update u of gradient g (the state ``st`` updated in place)."""
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st.update(self.init_state(p))
                if self.counted:
                    st["count"] += 1
                u = self.transform(p.grad, st, p, group)
                p.add_(u * -group["lr"])
        return loss


class SGD(OptaxRule):
    name = "sgd"

    def __init__(self, groups, momentum=0.0):
        super().__init__(groups, momentum=float(momentum))
        self.fields = ("trace",) if self.defaults["momentum"] else ()

    def transform(self, g, st, p, h):
        if not h["momentum"]:
            return g.clone()
        st["trace"] = g + h["momentum"] * st["trace"]
        return st["trace"]


class AdamW(OptaxRule):
    name = "adamw"
    fields = ("mu", "nu")
    counted = True
    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, groups, weight_decay=1e-2):
        super().__init__(groups, weight_decay=float(weight_decay))

    def transform(self, g, st, p, h):
        st["mu"] = (1 - self.B1) * g + self.B1 * st["mu"]
        st["nu"] = (1 - self.B2) * g ** 2 + self.B2 * st["nu"]
        mu_hat = _bias_correction(st["mu"], self.B1, st["count"])
        nu_hat = _bias_correction(st["nu"], self.B2, st["count"])
        return mu_hat / (torch.sqrt(nu_hat) + self.EPS) + h["weight_decay"] * p


class Adamax(OptaxRule):
    name = "adamax"
    fields = ("mu", "nu")
    counted = True
    B1, B2, EPS = 0.9, 0.999, 1e-8

    def transform(self, g, st, p, h):
        st["mu"] = (1 - self.B1) * g + self.B1 * st["mu"]
        st["nu"] = torch.maximum(g.abs() + self.EPS, self.B2 * st["nu"])
        return _bias_correction(st["mu"], self.B1, st["count"]) / st["nu"]


class RMSProp(OptaxRule):
    name = "rmsprop"
    fields = ("nu",)
    DECAY, EPS = 0.9, 1e-8

    def transform(self, g, st, p, h):
        st["nu"] = (1 - self.DECAY) * g ** 2 + self.DECAY * st["nu"]
        return torch.rsqrt(st["nu"] + self.EPS) * g


class Adagrad(OptaxRule):
    name = "adagrad"
    fields = ("sum_of_squares",)
    INITIAL, EPS = 0.1, 1e-7

    def init_state(self, p):
        return {"sum_of_squares": torch.full_like(p, self.INITIAL)}

    def transform(self, g, st, p, h):
        st["sum_of_squares"] = g * g + st["sum_of_squares"]
        s = st["sum_of_squares"]
        return torch.where(s > 0, torch.rsqrt(s + self.EPS), torch.zeros_like(s)) * g


class Adadelta(OptaxRule):
    name = "adadelta"
    fields = ("e_g", "e_x")
    RHO, EPS = 0.9, 1e-6

    def transform(self, g, st, p, h):
        st["e_g"] = (1 - self.RHO) * g ** 2 + self.RHO * st["e_g"]
        u = torch.sqrt(st["e_x"] + self.EPS) / torch.sqrt(st["e_g"] + self.EPS) * g
        st["e_x"] = (1 - self.RHO) * u ** 2 + self.RHO * st["e_x"]
        return u


RULES = {r.name: r for r in (SGD, AdamW, Adamax, RMSProp, Adagrad, Adadelta)}


def optimizer_name(optimizer):
    """The config name of an optimizer made by ``create_optimizer``."""
    return getattr(optimizer, "name", "adam")


def create_optimizer(cfg, params: dict) -> torch.optim.Optimizer:
    """cfg: the full config dict (``training.optimizer`` is read); params:
    name -> leaf tensor. An unknown name raises KeyError, as in the JAX
    package."""
    kwargs = dict(cfg["training"].get("optimizer") or {})
    name = kwargs.pop("name", "adam") or "sgd"
    txt = kwargs.pop("texture", None) or {}
    lr_main = float(kwargs.pop("lr", 1e-3))
    lr_texture = float(txt.get("lr", lr_main))
    groups = param_groups(params, lr_main, lr_texture)
    if name == "adam":
        betas = tuple(kwargs.pop("betas", (0.9, 0.999)))
        return torch.optim.Adam(groups, betas=betas, eps=float(kwargs.pop("eps", 1e-8)))
    rule = RULES[name]
    if rule is SGD:
        return SGD(groups, momentum=kwargs.get("momentum", 0.0))
    if rule is AdamW:
        return AdamW(groups, weight_decay=kwargs.get("weight_decay", 1e-2))
    return rule(groups)
