"""The one input generator: a traffic mix's ``inputs`` parameters -> a pool of
distinct batches, drawn on the device from the run's seed.

Parameters a mix file may give under ``inputs``:

* ``{"dist": "normal", "scale": s}``: ``s N(0, 1)`` per entry (``"mean"``
  adds a shift);
* ``{"dist": "uniform", "low": a, "high": b}``: ``U(a, b)`` per entry.

A batch is ``(batch, dim)`` float64, ``dim`` set by the configuration's
entry.  Where the entry gives a domain, the rows outside it are drawn again
from the same stream until every row lies inside, so every seed gives the
same sizes.
"""

from __future__ import annotations

import torch

__all__ = ["make_generator", "draw", "pool"]

MAX_REDRAWS = 64


def make_generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**64)
    return gen


def draw(spec: dict, shape: tuple, gen: torch.Generator, device) -> torch.Tensor:
    dist = spec["dist"]
    if dist == "normal":
        x = torch.randn(shape, generator=gen, device=device, dtype=torch.float64)
        return spec.get("mean", 0.0) + spec["scale"] * x
    if dist == "uniform":
        x = torch.rand(shape, generator=gen, device=device, dtype=torch.float64)
        return spec["low"] + (spec["high"] - spec["low"]) * x
    raise ValueError(f"unknown input distribution {dist!r}")


def pool(traffic: dict, dim: int, gen: torch.Generator, device, accept=None):
    """``traffic['pool']`` batches of ``(traffic['batch'], dim)``; ``accept``
    maps a batch to a ``(batch,)`` bool mask of the rows inside the entry's
    domain.  Returns ``(batches, redrawn)``: the rows drawn again, summed."""
    batches, redrawn = [], 0
    for _ in range(traffic["pool"]):
        x = draw(traffic["inputs"], (traffic["batch"], dim), gen, device)
        for _ in range(MAX_REDRAWS):
            if accept is None:
                break
            bad = ~accept(x)
            count = int(bad.sum())
            if count == 0:
                break
            redrawn += count
            x[bad] = draw(traffic["inputs"], (count, dim), gen, device)
        else:
            raise RuntimeError("inputs stay outside the entry's domain after "
                               f"{MAX_REDRAWS} redraws")
        batches.append(x)
    return batches, redrawn
