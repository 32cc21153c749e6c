"""The benchmark's own input generators, frozen.

Structure (which blocks are stored) is drawn on the host with numpy from
the seed: it is a few thousand integers.  Payloads are drawn on the
device with one `torch.Generator` call each, in float32, so set-up moves
no payload across the bus.

The arithmetic of the structure is a frozen copy of the port's
``utils/generators.py``: `random_block_ids` is ``random_block_matrix``'s
(``nb = n // b``, ``round(density * nb^2)`` blocks drawn without
replacement, sorted).  Only the source of the payload values differs:
the device generator in place of numpy's ``standard_normal``.
"""

from __future__ import annotations

import numpy as np
import torch


def host_rng(seed: int, *stream: int) -> np.random.Generator:
    """numpy generator for `seed` and a sub-stream (pool member, operand)."""
    return np.random.default_rng([int(seed) % 2**63, *stream])


def device_generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % 2**63)
    return g


def random_block_ids(n: int, b: int, density: float, rng: np.random.Generator) -> np.ndarray:
    """Sorted int64 block ids (row-major over the ``n/b`` grid) of a
    uniformly random block-sparse matrix at `density`."""
    nb = n // b
    n_blocks = max(1, int(round(density * nb * nb)))
    return np.sort(rng.choice(nb * nb, n_blocks, replace=False)).astype(np.int64)


def normal_payloads(count: int, b: int, gen: torch.Generator, device) -> torch.Tensor:
    """[count, b, b] float32 N(0, 1) blocks in one device call."""
    return torch.randn((count, b, b), generator=gen, device=device, dtype=torch.float32)
