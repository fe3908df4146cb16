"""Oracle Gaussian-mixture densities used by the paper's benchmarks.

The counterpart of ``repro.core.mixtures``: an isotropic Gaussian mixture
with an exact log-pdf and score (the oracle), sampling from a
``torch.Generator``, and the paper's benchmark instances.  JAX and
PyTorch draw different numbers from one seed, so only the densities are
comparable across the two packages.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class GaussianMixture:
    """Isotropic Gaussian mixture with exact pdf — the benchmark oracle."""

    means: np.ndarray    # (k, d)
    stds: np.ndarray     # (k,)  isotropic per component
    weights: np.ndarray  # (k,)  sums to 1

    @property
    def dim(self) -> int:
        return int(self.means.shape[1])

    @property
    def n_components(self) -> int:
        return int(self.means.shape[0])

    def sample(self, n: int, generator: torch.Generator,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Draw ``n`` iid samples on the generator's device."""
        dev = generator.device
        w = torch.as_tensor(self.weights, dtype=torch.float64, device=dev)
        comps = torch.multinomial(w, n, replacement=True, generator=generator)
        means = torch.as_tensor(self.means, dtype=dtype, device=dev)[comps]
        stds = torch.as_tensor(self.stds, dtype=dtype, device=dev)[comps]
        noise = torch.randn((n, self.dim), generator=generator, dtype=dtype,
                            device=dev)
        return means + stds[:, None] * noise

    def log_pdf(self, x: torch.Tensor) -> torch.Tensor:
        """Exact log density at ``x`` of shape (m, d), in ``x``'s dtype."""
        mu = torch.as_tensor(self.means, dtype=x.dtype, device=x.device)[None]
        std = torch.as_tensor(self.stds, dtype=x.dtype, device=x.device)[None]
        sqd = torch.sum((x[:, None, :] - mu) ** 2, dim=-1)          # (m, k)
        d = self.dim
        log_comp = (-0.5 * sqd / (std**2) - d * torch.log(std)
                    - 0.5 * d * math.log(2.0 * math.pi))
        logw = torch.log(torch.as_tensor(self.weights, dtype=x.dtype,
                                         device=x.device))[None]
        return torch.logsumexp(log_comp + logw, dim=1)

    def pdf(self, x: torch.Tensor) -> torch.Tensor:
        return torch.exp(self.log_pdf(x))

    def score(self, x: torch.Tensor) -> torch.Tensor:
        """Exact oracle score ``∇ log p`` at ``x`` (m, d), in ``x``'s
        dtype (for SD-KDE-with-oracle ablations).

        Closed form: Σ_k r_k(x)·(μ_k − x)/σ_k², with r_k the components'
        posterior weights, softmax of the weighted component log-pdfs."""
        mu = torch.as_tensor(self.means, dtype=x.dtype, device=x.device)
        std = torch.as_tensor(self.stds, dtype=x.dtype, device=x.device)
        logw = torch.log(torch.as_tensor(self.weights, dtype=x.dtype,
                                         device=x.device))
        diff = mu[None] - x[:, None, :]                             # (m, k, d)
        sqd = torch.sum(diff * diff, dim=-1)
        log_comp = -0.5 * sqd / std**2 - self.dim * torch.log(std)
        resp = torch.softmax(log_comp + logw, dim=1)                # (m, k)
        return torch.einsum("mk,mkd->md", resp / std**2, diff)


def benchmark_mixture_16d(separation: float = 4.0) -> GaussianMixture:
    """The paper's 16-D benchmark: two isotropic components separated
    along the first four coordinates."""
    d = 16
    m0 = np.zeros((d,))
    m1 = np.zeros((d,))
    m1[:4] = separation / 2.0
    m0[:4] = -separation / 2.0
    return GaussianMixture(means=np.stack([m0, m1]),
                           stds=np.array([1.0, 0.7]),
                           weights=np.array([0.6, 0.4]))


def benchmark_mixture_1d() -> GaussianMixture:
    """Trimodal 1-D benchmark mixture (Fig. 3 family)."""
    return GaussianMixture(means=np.array([[-3.0], [0.0], [2.5]]),
                           stds=np.array([0.8, 0.5, 1.2]),
                           weights=np.array([0.3, 0.4, 0.3]))


def mixture_for_dim(d: int) -> GaussianMixture:
    """A benchmark mixture for arbitrary d (tests sweep dimensions)."""
    if d == 1:
        return benchmark_mixture_1d()
    m0 = np.zeros((d,))
    m1 = np.zeros((d,))
    m1[: min(4, d)] = 2.0
    m0[: min(4, d)] = -2.0
    return GaussianMixture(means=np.stack([m0, m1]),
                           stds=np.array([1.0, 0.7]),
                           weights=np.array([0.6, 0.4]))


__all__ = ["GaussianMixture", "benchmark_mixture_16d",
           "benchmark_mixture_1d", "mixture_for_dim"]
