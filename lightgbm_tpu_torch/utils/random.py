"""The port's noise source.

The JAX package draws its training noise from threefry keys
(``PRNGKey(objective_seed + iter)`` split and folded per use, gbdt.py).
This package draws the same uniforms from a ``torch.Generator`` on the
data's device, seeded with ``objective_seed + iteration``:

- ``rank_uniforms``: rank_xendcg's ``[Q, M]`` gammas (one per query and
  padded document slot);
- ``goss_uniform``: GOSS's per-row draw that picks the sampled rest rows;
- ``quant_uniforms``: the stochastic-rounding offsets of the quantized
  gradient and hessian of one class tree.

Draw order within an iteration: rank_xendcg's gammas first (with that
objective), then GOSS's draw (when GOSS is active), then the two offsets
of class 0, of class 1, ... of class K-1, in the order the step grows the
class trees. The class index is an argument so that a
replay of the JAX package's stream can fold it into its key as the JAX
package does (``fold_in(qkey, k)``); this stream ignores it and depends on
the call order alone.

The two streams give different numbers from the same seed, so a test that
compares the packages hands the port the JAX package's draws through an
object with the same methods (tests/test_torch_train.py). The JAX
package keys the gammas by path (the iteration's key itself on a full-row
step, the first half of its split under GOSS), so ``rank_uniforms`` is
told whether GOSS is active; this stream ignores it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


class TorchNoise:
    """Per-iteration uniforms from one ``torch.Generator`` re-seeded with
    ``seed + iteration``; within an iteration the draws come in call
    order (the step calls the gradients first, then GOSS, then the
    quantizer once per class)."""

    def __init__(self, seed: int, device: torch.device):
        self.seed = int(seed)
        self.device = torch.device(device)
        self._iteration: Optional[int] = None
        self._gen: Optional[torch.Generator] = None

    def _generator(self, iteration: int) -> torch.Generator:
        if self._iteration != iteration:
            self._gen = torch.Generator(device=self.device)
            self._gen.manual_seed(self.seed + int(iteration))
            self._iteration = iteration
        return self._gen

    def rank_uniforms(self, iteration: int, Q: int, M: int, goss: bool
                      ) -> torch.Tensor:
        """``[Q, M]`` float32 uniforms in [0, 1): rank_xendcg's gammas."""
        return torch.rand((Q, M), generator=self._generator(iteration),
                          device=self.device, dtype=torch.float32)

    def goss_uniform(self, iteration: int, n: int) -> torch.Tensor:
        """``[n]`` float32 uniforms in [0, 1)."""
        return torch.rand(n, generator=self._generator(iteration),
                          device=self.device, dtype=torch.float32)

    def quant_uniforms(self, iteration: int, n: int, k: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Two ``[n]`` float32 offsets in [-0.5, 0.5) for class ``k``'s
        tree: gradient, hessian."""
        gen = self._generator(iteration)
        ng = torch.rand(n, generator=gen, device=self.device) - 0.5
        nh = torch.rand(n, generator=gen, device=self.device) - 0.5
        return ng, nh
