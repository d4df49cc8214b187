"""Small constant tensors kept on the device.

The observation, the reward and the rotation helpers multiply by a few
fixed numbers at every step: a quaternion's conjugation signs, the
heading mask, the configuration's base rotation, the reward weights, the
end-effector rows. Made from Python numbers at each call, each would be a
copy from pageable host memory, which on a card waits for the stream and
cannot sit in a CUDA graph. `const` makes each such tensor once per
(values, device, dtype) and hands the same one back afterwards, so a step
copies nothing from the host. The values are those the call sites used,
so every result is the same, bit for bit.

A tensor from `const` is shared by every caller: never write to it.
"""
from __future__ import annotations

import torch

from uhc_tpu_torch.utils.spans import count

_CACHE: dict = {}


def const(values: tuple, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """`values` (a tuple of numbers) as a 1-D tensor on `like`'s device, in
    `dtype` (`like`'s by default); made on first use, then kept."""
    dtype = like.dtype if dtype is None else dtype
    key = (values, like.device, dtype)
    t = _CACHE.get(key)
    if t is None:
        # the one copy from the host: on a card it waits for the stream
        count("host_sync")
        t = _CACHE[key] = torch.tensor(values, dtype=dtype,
                                       device=like.device)
    return t
