"""Learning-rate schedulers (counterpart of mxnet_tpu/lr_scheduler.py):
FactorScheduler, MultiFactorScheduler, PolyScheduler keyed on the
optimizer's ``num_update``. Each schedule is a pure function of
``num_update`` (the decay count in closed form), as in the JAX package.
"""
from __future__ import annotations

import logging

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler"]


class LRScheduler:
    """Base: maps the optimizer's update counter to a learning rate."""

    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr

    def __call__(self, num_update):
        raise NotImplementedError

    def _log_if_changed(self, num_update, lr):
        last = getattr(self, "_last_lr", None)
        self._last_lr = lr
        if last is not None and lr != last:
            logging.info("Update[%d]: learning rate is now %0.5e",
                         num_update, lr)
        return lr


class FactorScheduler(LRScheduler):
    """lr = base_lr * factor^k after every `step` updates, floored at
    stop_factor_lr. Decay k happens once num_update exceeds k*step."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8):
        super().__init__()
        if step < 1:
            raise ValueError("step must be >= 1")
        if factor > 1.0:
            raise ValueError("factor must be <= 1 (lr must not grow)")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr

    def __call__(self, num_update):
        decays = max(0, (num_update - 1) // self.step)
        lr = max(self.base_lr * self.factor ** decays, self.stop_factor_lr)
        return self._log_if_changed(num_update, lr)


class MultiFactorScheduler(LRScheduler):
    """lr *= factor when num_update passes each milestone in `step`."""

    def __init__(self, step, factor=1):
        super().__init__()
        if not isinstance(step, list) or not step:
            raise ValueError("step must be a non-empty list of milestones")
        if any(s < 1 for s in step):
            raise ValueError("milestones must be >= 1")
        if any(b <= a for a, b in zip(step, step[1:])):
            raise ValueError("milestones must be strictly increasing")
        if factor > 1.0:
            raise ValueError("factor must be <= 1 (lr must not grow)")
        self.step = step
        self.factor = factor

    def __call__(self, num_update):
        decays = sum(1 for s in self.step if num_update > s)
        lr = self.base_lr * self.factor ** decays
        return self._log_if_changed(num_update, lr)


class PolyScheduler(LRScheduler):
    """Polynomial decay base_lr * (1 - t/T)^power down to 0 at T."""

    def __init__(self, max_update, base_lr=0.01, pwr=2):
        super().__init__(base_lr)
        if not isinstance(max_update, int) or max_update < 1:
            raise ValueError("max_update must be a positive int")
        self.max_update = max_update
        self.power = pwr

    def __call__(self, num_update):
        t = min(num_update, self.max_update)
        return self.base_lr * (1.0 - t / self.max_update) ** self.power
