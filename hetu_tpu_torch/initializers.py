"""Variable initializers (PyTorch port of ``hetu_tpu/initializers.py``).

Each initializer is a callable ``(generator, shape, dtype) -> torch.Tensor``
that draws on the CPU from the ``torch.Generator`` it is given; the
executor seeds one generator per variable from ``(seed, crc32(name))`` and
moves the result to its device.  Values are therefore deterministic and the
same on every device, but they are NOT the JAX package's bits (threefry and
torch's Mersenne Twister differ): to run the same weights through both
packages, carry them across with ``weights.params_from_jax``.
"""

from __future__ import annotations

import math

import numpy as np
import torch


class Initializer:
    def __call__(self, generator, shape, dtype=torch.float32):
        raise NotImplementedError


class ConstantInit(Initializer):
    def __init__(self, constant=0.0):
        self.constant = constant

    def __call__(self, generator, shape, dtype=torch.float32):
        return torch.full(tuple(shape), self.constant, dtype=dtype)


class ZerosInit(ConstantInit):
    def __init__(self):
        super().__init__(0.0)


class OnesInit(ConstantInit):
    def __init__(self):
        super().__init__(1.0)


class UniformInit(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, generator, shape, dtype=torch.float32):
        out = torch.empty(tuple(shape), dtype=dtype)
        return out.uniform_(self.low, self.high, generator=generator)


class NormalInit(Initializer):
    def __init__(self, mean=0.0, stddev=1.0):
        self.mean, self.stddev = mean, stddev

    def __call__(self, generator, shape, dtype=torch.float32):
        out = torch.empty(tuple(shape), dtype=dtype)
        return out.normal_(self.mean, self.stddev, generator=generator)


class TruncatedNormalInit(Initializer):
    """``mean + stddev * x`` with x a standard normal cut to [-2, 2]."""

    def __init__(self, mean=0.0, stddev=1.0):
        self.mean, self.stddev = mean, stddev

    def __call__(self, generator, shape, dtype=torch.float32):
        out = torch.empty(tuple(shape), dtype=dtype)
        torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        return self.mean + self.stddev * out


def _fans(shape):
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv kernels (O, I, H, W) layout
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class XavierNormalInit(Initializer):
    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, generator, shape, dtype=torch.float32):
        fan_in, fan_out = _fans(shape)
        std = self.gain * math.sqrt(2.0 / (fan_in + fan_out))
        return NormalInit(0.0, std)(generator, shape, dtype)


class XavierUniformInit(Initializer):
    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, generator, shape, dtype=torch.float32):
        fan_in, fan_out = _fans(shape)
        limit = self.gain * math.sqrt(6.0 / (fan_in + fan_out))
        return UniformInit(-limit, limit)(generator, shape, dtype)


class HeNormalInit(Initializer):
    def __call__(self, generator, shape, dtype=torch.float32):
        fan_in, _ = _fans(shape)
        return NormalInit(0.0, math.sqrt(2.0 / fan_in))(generator, shape,
                                                         dtype)


class HeUniformInit(Initializer):
    def __call__(self, generator, shape, dtype=torch.float32):
        fan_in, _ = _fans(shape)
        limit = math.sqrt(6.0 / fan_in)
        return UniformInit(-limit, limit)(generator, shape, dtype)


class LecunNormalInit(Initializer):
    def __call__(self, generator, shape, dtype=torch.float32):
        fan_in, _ = _fans(shape)
        return NormalInit(0.0, math.sqrt(1.0 / fan_in))(generator, shape,
                                                         dtype)


class NumpyInit(Initializer):
    """Wraps a concrete numpy array (provided-value Variables)."""

    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, generator, shape, dtype=torch.float32):
        if tuple(shape) != tuple(self.value.shape):
            raise ValueError(
                f"shape mismatch {tuple(shape)} vs {self.value.shape}")
        return torch.as_tensor(self.value).to(dtype)


# functional aliases matching the reference's API names
def zeros(): return ZerosInit()
def ones(): return OnesInit()
def constant(c=0.0): return ConstantInit(c)
def uniform(low=-1.0, high=1.0): return UniformInit(low, high)
def normal(mean=0.0, stddev=1.0): return NormalInit(mean, stddev)
def truncated_normal(mean=0.0, stddev=1.0): return TruncatedNormalInit(mean, stddev)
def xavier_normal(gain=1.0): return XavierNormalInit(gain)
def xavier_uniform(gain=1.0): return XavierUniformInit(gain)
def he_normal(): return HeNormalInit()
def he_uniform(): return HeUniformInit()
def lecun_normal(): return LecunNormalInit()
