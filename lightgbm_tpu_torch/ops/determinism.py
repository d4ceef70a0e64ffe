"""The deterministic mode (``deterministic=True``): equal bits across runs
on the card.

On the TPU a sum follows the physical row order, so a run repeats itself
bit for bit. The port's Hopper histogram kernels add f32 values with
atomics in no fixed order, and some PyTorch ops on the training path do
too. In the deterministic mode:

* the histogram kernels K1 (every float mode), K2 (through K1's record
  mode) and K3 (both paths) add in **fixed point**: each f32 addend (on
  K3's tile path, each block's deterministic partial sum) becomes an int64
  at a power-of-two scale, the cells add with integer atomics, whose sum
  does not depend on their order, and the cells convert back to f32 at the
  end. The scale is one a channel for the whole tree (``det_scale``),
  computed on the device from the tree's ``max |addend|`` and row count so
  that no sum can overflow, and read by the kernels through a pointer: no
  host read. ``fixed_point_histogram`` is the plain version of that sum;
* float cumulative sums on the training path (the split scan, the forced
  split's left sums, renewal, the quantized renewal) take ``cumsum``, a
  log-step scan of elementwise adds (CUDA's float ``torch.cumsum`` has no
  deterministic algorithm);
* ``deterministic_algorithms`` turns on PyTorch's deterministic algorithms
  (the float ``index_add_`` of the quantized renewal's leaf sums and of
  lambdarank's position biases) for the duration of a training call, and
  puts the previous setting back after it.

With the mode off nothing here acts: the kernels, their launches and the
ops are those of the default mode.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator

import torch

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "lgbt_deterministic", default=False)

# fixed-point sums stay below 2^62: N x max |addend| x scale < 2^62
_FIXED_BITS = 62


def active() -> bool:
    """Whether the calling code runs inside ``deterministic_algorithms``."""
    return _ACTIVE.get()


@contextlib.contextmanager
def deterministic_algorithms(enabled: bool = True) -> Iterator[None]:
    """Inside: ``active()`` is ``enabled``, and with ``enabled`` PyTorch's
    deterministic algorithms are on (without filling new tensors, which
    every kernel here writes before it reads). Both settings are restored
    on exit."""
    if not enabled:
        yield
        return
    token = _ACTIVE.set(True)
    was = torch.are_deterministic_algorithms_enabled()
    was_warn = torch.is_deterministic_algorithms_warn_only_enabled()
    import torch.utils.deterministic as tud
    was_fill = tud.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    tud.fill_uninitialized_memory = False
    try:
        yield
    finally:
        tud.fill_uninitialized_memory = was_fill
        torch.use_deterministic_algorithms(was, warn_only=was_warn)
        _ACTIVE.reset(token)


def det_scale(max_abs: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The fixed-point scales ``[K]`` (float64 powers of two) of channels
    whose addends are at most ``max_abs [K]`` in magnitude, over at most
    ``n_rows`` rows: the largest ``2^s`` with ``n_rows x max_abs x 2^s <
    2^62``, so any sum of rounded addends fits an int64. A zero channel
    takes ``2^62``. Computed on ``max_abs``'s device: no host read."""
    bound = max_abs.to(torch.float64) * float(max(int(n_rows), 1))
    # bound = m 2^e with m in [0.5, 1): bound < 2^e
    _, e = torch.frexp(bound)
    e = torch.where(bound > 0, e, torch.zeros_like(e))
    one = torch.ones_like(bound)
    return torch.ldexp(one, (_FIXED_BITS - e).to(torch.float64))


def channel_scale(channels: torch.Tensor, n_rows: int) -> torch.Tensor:
    """``det_scale`` of the columns of ``channels [N, K]``."""
    return det_scale(channels.abs().amax(dim=0), n_rows)


def to_fixed(values: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``values`` (f32, channels last) as int64 fixed point: rounded to
    nearest, ties to even, as the kernels' ``__double2ll_rn``."""
    return torch.round(values.to(torch.float64) * scale).to(torch.int64)


def from_fixed(acc: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int64 fixed-point sums back to f32 (through float64, as the
    kernels' finishing pass)."""
    return (acc.to(torch.float64) / scale).to(torch.float32)


def cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.cumsum`` outside the mode; inside it, for float tensors, an
    inclusive scan of ceil(log2 n) rounds of elementwise adds (Hillis and
    Steele), whose result is fixed by the inputs alone."""
    if not active() or not x.is_floating_point():
        return torch.cumsum(x, dim=dim)
    y = x.movedim(dim, -1)
    n = y.shape[-1]
    s = 1
    while s < n:
        y = torch.cat([y[..., :s], y[..., s:] + y[..., :-s]], dim=-1)
        s *= 2
    return y.movedim(-1, dim).contiguous()
