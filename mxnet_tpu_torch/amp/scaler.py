"""DynamicLossScaler — fp16 gradient-underflow protection (counterpart of
mxnet_tpu/amp/scaler.py).

fp16's 5-bit exponent flushes small gradients to zero, so fp16 training
multiplies the loss by a large scale before the backward, unscales before
the update, and skips any step whose scaled gradients overflowed to
inf/nan (Micikevicius et al. 2018 §3.2). bfloat16 keeps fp32's exponent
and needs none of this.

Two usage shapes, as in the JAX package:

  - Host-driven (custom loops): scale the loss, check the gradients,
    ``update(overflow)`` each step.
  - Device-driven (``DataParallelTrainer(dtype="float16")``): the state
    is a 3-element f32 tensor ``[scale, good_steps, skipped_total]`` on
    the card, updated by :meth:`update_state` inside the captured step,
    so K replays grow and back off exactly as K single steps, with no
    host sync.
"""
from __future__ import annotations

import torch


class DynamicLossScaler:
    """Grow-on-success / backoff-on-overflow loss scale.

    The scale starts at ``init_scale``; every ``growth_interval``
    consecutive finite steps it multiplies by ``growth_factor`` (capped at
    ``max_scale``); a non-finite gradient multiplies it by
    ``backoff_factor`` (floored at ``min_scale``) and the step is skipped.
    """

    def __init__(self, init_scale=2.0 ** 15, growth_factor=2.0,
                 backoff_factor=0.5, growth_interval=2000,
                 min_scale=1.0, max_scale=2.0 ** 24):
        if init_scale <= 0:
            raise ValueError("DynamicLossScaler: init_scale must be > 0")
        self.init_scale = float(init_scale)
        self.growth_factor = float(growth_factor)
        self.backoff_factor = float(backoff_factor)
        self.growth_interval = int(growth_interval)
        self.min_scale = float(min_scale)
        self.max_scale = float(max_scale)
        self.scale = self.init_scale
        self.good_steps = 0
        self.skipped_steps = 0

    # -- host-driven API ----------------------------------------------------

    def scale_loss(self, loss):
        return loss * self.scale

    def unscale(self, grads):
        inv = 1.0 / self.scale
        return [g * inv for g in grads]

    def has_overflow(self, grads):
        for g in grads:
            t = getattr(g, "_data", g)
            if not isinstance(t, torch.Tensor):
                t = torch.as_tensor(t)
            if not bool(torch.isfinite(t).all()):
                return True
        return False

    def update(self, overflow):
        """Advance the schedule after one step; True when the step should
        be applied (no overflow)."""
        if overflow:
            self.scale = max(self.scale * self.backoff_factor,
                             self.min_scale)
            self.good_steps = 0
            self.skipped_steps += 1
            return False
        self.good_steps += 1
        if self.good_steps >= self.growth_interval:
            self.scale = min(self.scale * self.growth_factor,
                             self.max_scale)
            self.good_steps = 0
        return True

    # -- checkpoint round trip ----------------------------------------------

    def get_state(self):
        """JSON-safe position of the schedule (the hyperparameters are
        construction-time configuration)."""
        return {"scale": float(self.scale),
                "good_steps": int(self.good_steps),
                "skipped_steps": int(self.skipped_steps)}

    def set_state(self, state):
        self.scale = float(state["scale"])
        self.good_steps = int(state["good_steps"])
        self.skipped_steps = int(state["skipped_steps"])

    # -- device-driven API (the captured step) ------------------------------

    def state0(self, device="cpu"):
        """The initial state tensor [scale, good, skipped] (f32)."""
        return torch.tensor([self.scale, float(self.good_steps),
                             float(self.skipped_steps)],
                            dtype=torch.float32, device=device)

    def update_state(self, state, finite):
        """The schedule's update on the device: ``state`` the 3-element
        tensor, ``finite`` a boolean scalar tensor (all gradients finite).
        Returns the new state tensor; nothing reads it on the host."""
        scale, good, skipped = state[0], state[1], state[2]
        good = torch.where(finite, good + 1.0, torch.zeros_like(good))
        grow = good >= float(self.growth_interval)
        new_scale = torch.where(
            finite,
            torch.where(grow,
                        torch.clamp(scale * self.growth_factor,
                                    max=self.max_scale),
                        scale),
            torch.clamp(scale * self.backoff_factor, min=self.min_scale))
        good = torch.where(grow, torch.zeros_like(good), good)
        skipped = skipped + torch.where(finite, 0.0, 1.0).to(skipped.dtype)
        return torch.stack([new_scale, good, skipped])
