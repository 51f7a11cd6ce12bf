"""Weights and other tensors made from the seed, on the device.

Every tensor of a parameter table (``reference.sgpn.param_specs``,
``reference.efficientnet.param_specs``) is cut from one normal draw of a
``torch.Generator`` on the device, in float32 (the type the program keeps
its parameters in): products' weights with std 1/sqrt(fan-in) (Xavier's
fan for the heads), biases 0.1 z, BN scales 1 + 0.1 z, shifts 0.1 z,
stored means 0.1 z and variances exp(0.2 z). The same seed gives the same
tensors, so the reference can draw them again after the program is gone.
"""

from __future__ import annotations

import hashlib
import math

import torch


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one purpose, stable across runs and machines."""
    h = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def generator(seed: int, purpose: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, purpose))


def make_params(specs, seed: int, device) -> dict[str, torch.Tensor]:
    total = sum(math.prod(shape) for _n, shape, _k, _f in specs)
    z = torch.randn(total, generator=generator(seed, "weights", device), device=device)
    out, off = {}, 0
    for name, shape, kind, fan in specs:
        n = math.prod(shape)
        t = z[off:off + n].view(shape)
        off += n
        if kind in ("dense", "conv", "xavier"):
            t = t * (1.0 / math.sqrt(fan))
        elif kind in ("bias", "bn_bias", "bn_running_mean"):
            t = t * 0.1
        elif kind == "bn_weight":
            t = 1.0 + 0.1 * t
        elif kind == "bn_running_var":
            t = torch.exp(0.2 * t)
        else:
            raise ValueError(f"{name}: unknown kind {kind!r}")
        out[name] = t.contiguous()
    return out


def class_weights(seed: int, n: int, purpose: str, device) -> torch.Tensor:
    """Loss weights per class in [0.5, 1.5) (the published config weights
    classes by their frequency; these stand in for a split's)."""
    g = generator(seed, purpose, device)
    return torch.rand(n, generator=g, device=device) + 0.5
