"""Seeds: every input of a run is drawn from `--seed` through a named
sub-seed, so that the same seed gives the same inputs and two draws never
share a stream."""

from __future__ import annotations

import hashlib

import torch


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for the stream named by `tags` under `seed`."""
    key = ":".join(str(t) for t in (seed, *tags)).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 1


def generator(device, seed: int, *tags) -> torch.Generator:
    """A torch.Generator on `device` seeded with `sub_seed(seed, *tags)`."""
    return torch.Generator(torch.device(device)).manual_seed(
        sub_seed(seed, *tags))


def uniform_leaves(shapes, bounds, gen: torch.Generator, device,
                   dtype=torch.float32) -> list:
    """One tensor per shape, uniform in (-bound, bound), drawn on `device`
    in ONE call and cut into leaves of their own storage."""
    sizes = [int(torch.Size(s).numel()) for s in shapes]
    flat = torch.rand(sum(sizes), generator=gen, device=device, dtype=dtype)
    flat.mul_(2.0).sub_(1.0)
    return [chunk.view(s) * b
            for chunk, s, b in zip(flat.split(sizes), shapes, bounds)]
