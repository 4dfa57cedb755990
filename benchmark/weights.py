"""Seeded weights of a configuration, made on the device.

One ``torch.rand`` and one ``torch.randn`` call on a generator of the run's
device draw every parameter at once; each entry of the published
state_dict is a slice of them: convolution and linear weights and biases
U(-1/sqrt(fan_in), 1/sqrt(fan_in)), class tokens N(0, 0.02), LayerNorm
scales 1 and shifts 0, the positional tables the published sinusoid.  The
same seed gives the same weights, which the port and the reference both
read.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference.model import param_specs, sinusoid_table


def make_weights(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} for every entry of the
    configuration's state_dict, drawn from ``seed``."""
    specs = param_specs(model)
    g = torch.Generator(device=device).manual_seed(seed)
    n_uniform = sum(math.prod(s) for _, s, init, _ in specs
                    if init == "uniform")
    n_normal = sum(math.prod(s) for _, s, init, _ in specs if init == "token")
    uniform = torch.rand(n_uniform, generator=g, device=device)
    normal = torch.randn(n_normal, generator=g, device=device)
    out, iu, inn, tables = {}, 0, 0, {}
    for name, shape, init, fan_in in specs:
        n = math.prod(shape)
        if init == "uniform":
            bound = 1.0 / math.sqrt(fan_in)
            t = (uniform[iu:iu + n] * 2.0 - 1.0) * bound
            iu += n
        elif init == "token":
            t = (normal[inn:inn + n] * 0.02).clamp(-2.0, 2.0)
            inn += n
        elif init == "pe":
            if shape not in tables:
                tables[shape] = torch.from_numpy(
                    sinusoid_table(shape[0], shape[-1])).to(device)
            t = tables[shape].clone()
        else:
            t = (torch.ones if init == "ones" else torch.zeros)(
                n, device=device)
        out[name] = t.reshape(shape)
    return out
