"""Row sampling: bagging and GOSS, drawn on the training device.

Counterpart of ``lightgbm_tpu/boosting/sample_strategy.py`` (reference:
SampleStrategy, include/LightGBM/sample_strategy.h:31; BaggingSampleStrategy,
src/boosting/bagging.hpp:14; GOSSStrategy, src/boosting/goss.hpp:18). As in
the JAX package, a strategy gives a dense ``[N]`` {0, 1} in-bag mask that
multiplies into the gradient, hessian and in-bag count channels: rows are
never compacted, and each row is in bag with probability
``bagging_fraction`` (the reference draws an exact count).

The draws come from a ``torch.Generator`` on the run's device, seeded for
each draw as the JAX package seeds its key: ``bagging_seed + iter // freq``
for a bag, ``bagging_seed + iter`` for GOSS. The JAX package's threefry
stream cannot be reproduced in torch, so ``draws`` takes the draws from
outside: a callable ``(seed, size) -> [size]`` float32 uniforms in [0, 1)
on the run's device, which the tests set to the JAX package's
``jax.random.uniform(PRNGKey(seed), (size,))``. Nothing here reads the
device from the host.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


class SampleStrategy:
    """The in-bag mask of an iteration (None: every row in bag)."""

    # GOSS changes the gradients (its amplification)
    is_hessian_change = False

    def __init__(self, config, num_data: int, metadata, device):
        self.config = config
        self.num_data = num_data
        self.metadata = metadata
        self.device = device
        # True when the last bag_mask drew a new bag (False: it reused the
        # cached one, or sampled nothing); the compact grower keeps a reused
        # bag in its permuted records, not in the cached vector
        self.last_fresh = False
        # the draws' seam: (seed, size) -> [size] uniforms; None draws from
        # a torch.Generator
        self.draws: Optional[Callable[[int, int], torch.Tensor]] = None
        self._gen: Optional[torch.Generator] = None

    @property
    def enabled(self) -> bool:
        return False

    def _uniform(self, seed: int, size: int) -> torch.Tensor:
        if self.draws is not None:
            return self.draws(seed, size).to(self.device, torch.float32)
        if self._gen is None:
            self._gen = torch.Generator(device=self.device)
        # within 32 bits: the CPU generator keeps only the low 32 of a seed
        self._gen.manual_seed(seed & 0xFFFF_FFFF)
        return torch.rand(size, generator=self._gen, device=self.device)

    def bag_mask(self, iter_num: int, grad: Optional[torch.Tensor],
                 hess: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """``[N]`` f32 in-bag mask of iteration ``iter_num``, or None for
        every row; ``grad``/``hess`` ``[K, N]`` (GOSS reads them)."""
        self.last_fresh = False
        return None

    def scale_grad_hess(self, mask, grad, hess):
        """GOSS amplifies its sampled small-gradient rows; bagging does
        not."""
        return grad, hess

    @property
    def amplify(self) -> Optional[torch.Tensor]:
        """``[N]`` per-row gradient factor of the last mask, or None."""
        return None


class BaggingStrategy(SampleStrategy):
    """(reference: BaggingSampleStrategy, src/boosting/bagging.hpp:14)"""

    def __init__(self, config, num_data: int, metadata, device):
        super().__init__(config, num_data, metadata, device)
        self.fraction = float(config.get("bagging_fraction", 1.0))
        self.pos_fraction = float(config.get("pos_bagging_fraction", 1.0))
        self.neg_fraction = float(config.get("neg_bagging_fraction", 1.0))
        self.freq = int(config.get("bagging_freq", 0))
        self.seed = int(config.get("bagging_seed", 3))
        self.by_query = bool(config.get("bagging_by_query", False))
        self.balanced = self.pos_fraction < 1.0 or self.neg_fraction < 1.0
        self._enabled = self.freq > 0 and (self.fraction < 1.0
                                           or self.balanced)
        self._cached = None
        self._rate = None
        self._row_query = None
        if not self._enabled or metadata is None:
            return
        if self.by_query and metadata.query_boundaries is not None:
            qb = np.asarray(metadata.query_boundaries, np.int64)
            self._num_queries = len(qb) - 1
            self._row_query = torch.from_numpy(np.repeat(
                np.arange(self._num_queries), np.diff(qb))).to(device)
        elif self.balanced and metadata.label is not None:
            pos = torch.from_numpy(np.asarray(metadata.label) > 0).to(device)
            self._rate = torch.where(
                pos, torch.tensor(self.pos_fraction, device=device),
                torch.tensor(self.neg_fraction, device=device)).to(
                    torch.float32)

    @property
    def enabled(self) -> bool:
        return self._enabled

    def bag_mask(self, iter_num, grad, hess):
        self.last_fresh = False
        if not self._enabled:
            return None
        if iter_num % self.freq != 0 and self._cached is not None:
            return self._cached
        self.last_fresh = True
        seed = self.seed + iter_num // max(self.freq, 1)
        if self._row_query is not None:
            keep = self._uniform(seed, self._num_queries) < self.fraction
            mask = keep[self._row_query].to(torch.float32)
        else:
            u = self._uniform(seed, self.num_data)
            rate = self._rate if self._rate is not None else self.fraction
            mask = (u < rate).to(torch.float32)
        self._cached = mask
        return mask


def linear_quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(x, q)`` of a 1-D float32 tensor (linear
    interpolation, the JAX package's arithmetic: the position ``q (n - 1)``
    in f32, the two order statistics around it from one sort, then
    ``lo * w_lo + hi * w_hi`` as XLA's CPU backend computes it, the second
    product fused into the sum, one f32 rounding), as a 0-d tensor with no
    host read. ``torch.quantile`` refuses more than 2^24 elements; this
    does not. One sort, not two ``torch.kthvalue`` selects: on the H100 at
    9.45M rows the selects took 79 device ms (PERF.md)."""
    n = x.numel()
    f32 = np.float32
    pos = f32(q) * (f32(n) - f32(1))
    low, high = np.floor(pos), np.ceil(pos)
    w_high = f32(pos - low)
    w_low = f32(f32(1) - w_high)
    low = int(np.clip(low, 0, n - 1))
    high = int(np.clip(high, 0, n - 1))
    srt = torch.sort(x).values
    lo_v, hi_v = srt[low], srt[high]
    # the fused multiply-add, exact in f64 (a 24 x 24-bit product)
    out = ((lo_v * float(w_low)).double()
           + hi_v.double() * float(w_high)).float()
    # jnp.quantile is NaN when any element is
    return torch.where(torch.isnan(x).any(), torch.full_like(out, np.nan),
                       out)


class GOSSStrategy(SampleStrategy):
    """Gradient-based one-side sampling (reference: GOSSStrategy,
    src/boosting/goss.hpp:18): keep the ``top_rate`` rows of largest
    ``sum_k |g_k| h_k``, keep each other row with probability
    ``other_rate / (1 - top_rate)``, and multiply the kept other rows'
    gradients and hessians by ``(1 - top_rate) / other_rate``. No sampling
    for the first ``1 / learning_rate`` iterations."""

    is_hessian_change = True

    def __init__(self, config, num_data: int, metadata, device):
        super().__init__(config, num_data, metadata, device)
        self.top_rate = float(config.get("top_rate", 0.2))
        self.other_rate = float(config.get("other_rate", 0.1))
        self.seed = int(config.get("bagging_seed", 3))
        self.learning_rate = float(config.get("learning_rate", 0.1))
        self._amplify = None

    @property
    def enabled(self) -> bool:
        return True

    @property
    def amplify(self):
        return self._amplify

    def bag_mask(self, iter_num, grad, hess):
        self.last_fresh = False
        if iter_num < int(1.0 / max(self.learning_rate, 1e-12)):
            self._amplify = None
            return None
        self.last_fresh = True
        mag = torch.sum(torch.abs(grad) * hess, dim=0)
        is_top = mag >= linear_quantile(mag, 1.0 - self.top_rate)
        keep_rate = self.other_rate / max(1.0 - self.top_rate, 1e-12)
        u = self._uniform(self.seed + iter_num, self.num_data)
        sampled = ~is_top & (u < keep_rate)
        amp = (1.0 - self.top_rate) / max(self.other_rate, 1e-12)
        self._amplify = torch.where(sampled, torch.full_like(mag, amp),
                                    torch.ones_like(mag))
        return (is_top | sampled).to(torch.float32)

    def scale_grad_hess(self, mask, grad, hess):
        if self._amplify is None:
            return grad, hess
        return grad * self._amplify, hess * self._amplify


def create_sample_strategy(config, num_data: int, metadata,
                           device) -> SampleStrategy:
    """(reference: SampleStrategy::CreateSampleStrategy,
    src/boosting/sample_strategy.cpp)"""
    if str(config.get("data_sample_strategy", "bagging")).lower() == "goss":
        return GOSSStrategy(config, num_data, metadata, device)
    return BaggingStrategy(config, num_data, metadata, device)
