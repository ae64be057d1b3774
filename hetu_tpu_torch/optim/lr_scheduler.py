"""Learning-rate schedules (port of ``hetu_tpu/optim/lr_scheduler.py``).

Each schedule is a pure function of the step counter, an integer tensor
that lives beside the optimizer state on the executor's device, so reading
the rate costs the host no sync.  ``get`` returns an f32 0-d tensor on the
step's device.
"""

from __future__ import annotations

import math

import torch


def _steps(step):
    return torch.as_tensor(step).float()


class LRScheduler:
    def get(self, step):
        raise NotImplementedError

    def __call__(self, step):
        return self.get(step)


class FixedScheduler(LRScheduler):
    def __init__(self, learning_rate):
        self.learning_rate = learning_rate

    def get(self, step):
        return torch.full((), self.learning_rate, dtype=torch.float32,
                          device=torch.as_tensor(step).device)


class StepScheduler(LRScheduler):
    """lr * gamma^(step // step_size)."""

    def __init__(self, learning_rate, step_size, gamma=0.1):
        if step_size <= 0:
            raise ValueError("step_size must be positive")
        self.learning_rate = learning_rate
        self.step_size = step_size
        self.gamma = gamma

    def get(self, step):
        e = (torch.as_tensor(step) // self.step_size).float()
        return self.learning_rate * torch.pow(self.gamma, e)


class MultiStepScheduler(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1):
        self.learning_rate = learning_rate
        self.milestones = tuple(sorted(milestones))
        self.gamma = gamma

    def get(self, step):
        step = torch.as_tensor(step)
        ms = torch.as_tensor(self.milestones, device=step.device)
        n = (step >= ms).sum().float()
        return self.learning_rate * torch.pow(self.gamma, n)


class ExponentialScheduler(LRScheduler):
    def __init__(self, learning_rate, gamma=0.99):
        self.learning_rate = learning_rate
        self.gamma = gamma

    def get(self, step):
        return self.learning_rate * torch.pow(self.gamma, _steps(step))


class CosineScheduler(LRScheduler):
    def __init__(self, learning_rate, total_steps, min_lr=0.0, warmup_steps=0):
        self.learning_rate = learning_rate
        self.total_steps = total_steps
        self.min_lr = min_lr
        self.warmup_steps = warmup_steps

    def get(self, step):
        s = _steps(step)
        warm = self.learning_rate * s / max(self.warmup_steps, 1)
        t = ((s - self.warmup_steps)
             / max(self.total_steps - self.warmup_steps, 1)).clamp(0.0, 1.0)
        cos = self.min_lr + 0.5 * (self.learning_rate - self.min_lr) \
            * (1.0 + torch.cos(math.pi * t))
        return torch.where(s < self.warmup_steps, warm, cos)


class LinearWarmupScheduler(LRScheduler):
    """Linear warmup then linear decay to zero (BERT-style)."""

    def __init__(self, learning_rate, warmup_steps, total_steps):
        self.learning_rate = learning_rate
        self.warmup_steps = warmup_steps
        self.total_steps = total_steps

    def get(self, step):
        s = _steps(step)
        warm = s / max(self.warmup_steps, 1)
        decay = ((self.total_steps - s)
                 / max(self.total_steps - self.warmup_steps, 1)).clamp(0.0,
                                                                       1.0)
        return self.learning_rate * torch.where(s < self.warmup_steps, warm,
                                                decay)


def as_schedule(lr):
    if isinstance(lr, LRScheduler):
        return lr
    return FixedScheduler(lr)
