"""The paper's 16-d two-component Gaussian mixture and its sampler.

A frozen copy of the benchmark's data definition (Flash-SD-KDE, §5):
means ±separation/2 on the first four coordinates and 0 elsewhere,
isotropic standard deviations 1.0 and 0.7, weights 0.6 and 0.4.  The
traffic draws every input from it, on the generator's device, and hands
the same tensors to the program and to the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Mixture:
    """An isotropic Gaussian mixture."""

    means: np.ndarray    # (k, d)
    stds: np.ndarray     # (k,)
    weights: np.ndarray  # (k,), sums to 1

    @property
    def dim(self) -> int:
        return int(self.means.shape[1])

    def sampler(self, device: "str | torch.device") -> "Sampler":
        """A sampler holding this mixture's tensors on ``device``."""
        return Sampler(self, torch.device(device))


class Sampler:
    """Draws from a mixture on one device.  The mixture's tensors are
    uploaded once, so a draw launches device work only and never waits
    for the device: a client thread can draw while other work runs."""

    def __init__(self, mix: Mixture, device: torch.device):
        self.dim = mix.dim
        self.device = device
        cum = np.cumsum(mix.weights)[:-1]
        self._cum = torch.as_tensor(cum, dtype=torch.float32, device=device)
        self._mu = torch.as_tensor(mix.means, dtype=torch.float32,
                                   device=device)
        self._sd = torch.as_tensor(mix.stds, dtype=torch.float32,
                                   device=device)

    def sample(self, n: int, generator: torch.Generator) -> torch.Tensor:
        """``n`` iid float32 points: a uniform draw picks each point's
        component by the cumulative weights, then normal noise is scaled
        and shifted by it."""
        u = torch.rand((n,), generator=generator, device=self.device)
        comp = torch.searchsorted(self._cum, u, right=True)
        noise = torch.randn((n, self.dim), generator=generator,
                            dtype=torch.float32, device=self.device)
        return torch.addcmul(self._mu[comp], self._sd[comp][:, None], noise)


def from_config(spec: dict) -> Mixture:
    """The mixture a configuration file's ``mixture`` entry states:
    ``dim``, ``separation``, ``shifted_dims``, ``stds`` and ``weights``."""
    d = int(spec["dim"])
    k = int(spec["shifted_dims"])
    half = float(spec["separation"]) / 2.0
    m0, m1 = np.zeros(d), np.zeros(d)
    m0[:k], m1[:k] = -half, half
    return Mixture(means=np.stack([m0, m1]),
                   stds=np.asarray(spec["stds"], dtype=np.float64),
                   weights=np.asarray(spec["weights"], dtype=np.float64))


def stream_seed(seed: int, *path: "int | str") -> int:
    """A 63-bit generator seed for one named stream of a run's seed: the
    run's ``--seed`` and a path such as ``("task", 7)``, mixed by numpy's
    SeedSequence, so any seed up to 2**64 and any stream give their own
    numbers and the same pair gives the same numbers."""
    words: Sequence[int] = [int(seed) & (2**64 - 1), int(seed) >> 64] + [
        int(p) if isinstance(p, int) else int.from_bytes(
            str(p).encode()[:8].ljust(8, b"\0"), "little") for p in path]
    ss = np.random.SeedSequence([w & (2**64 - 1) for w in words])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def generator(device: "str | torch.device", seed: int,
              *path: "int | str") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded for one stream."""
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, *path))
    return gen


__all__ = ["Mixture", "Sampler", "from_config", "stream_seed", "generator"]
