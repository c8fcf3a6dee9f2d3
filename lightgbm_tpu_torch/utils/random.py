"""The port's noise source.

The JAX package draws its training noise from threefry keys
(``PRNGKey(objective_seed + iter)`` split and folded per use, gbdt.py).
This package draws the same uniforms from a ``torch.Generator`` on the
data's device, seeded with ``objective_seed + iteration``:

- ``rank_uniforms``: rank_xendcg's ``[Q, M]`` gammas (one per query and
  padded document slot);
- ``goss_uniform``: GOSS's per-row draw that picks the sampled rest rows;
- ``quant_uniforms``: the stochastic-rounding offsets of the quantized
  gradient and hessian of one class tree;
- ``node_uniforms``: ``feature_fraction_bynode``'s ``[C, F]`` draw of one
  split search of C leaves (the root, or a round's 2 x leaf-batch
  children, inactive lanes included);
- ``extra_uniforms``: ``extra_trees``' ``[C, F]`` draw of one split
  search, one threshold per leaf and feature.

Draw order within an iteration: rank_xendcg's gammas first (with that
objective), then GOSS's draw (when GOSS is active), then for class 0, 1,
... K-1 in the order the step grows the class trees: the two offsets,
then for each split search of the tree (the root first, then each round)
its bynode draw and then its extra_trees draw. The class index and the
search's tag (``L + 7`` at the root, the round's first node index after)
are arguments so that a replay of the JAX package's stream can derive its
keys as the JAX package does (``fold_in(qkey, k)`` for the offsets;
``fold_in(fold_in(qkey, 0xB14D + k), tag)`` for bynode, with
``fold_in(., 0xE77A + extra_seed)`` before the tag for extra_trees); the
offsets and the bynode draws of this stream ignore them and depend on the
call order alone. The extra_trees draws come from a generator of their
own, seeded from the iteration and ``extra_seed``, so that
``extra_seed`` picks other thresholds.

The two streams give different numbers from the same seed, so a test that
compares the packages hands the port the JAX package's draws through an
object with the same methods (tests/test_torch_train.py). The JAX
package keys the gammas by path (the iteration's key itself on a full-row
step, the first half of its split under GOSS), so ``rank_uniforms`` is
told whether GOSS is active; this stream ignores it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

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
        self._extra_gens: Dict[int, torch.Generator] = {}

    def _generator(self, iteration: int) -> torch.Generator:
        if self._iteration != iteration:
            self._gen = torch.Generator(device=self.device)
            self._gen.manual_seed(self.seed + int(iteration))
            self._extra_gens = {}
            self._iteration = iteration
        return self._gen

    def _extra_generator(self, iteration: int, extra_seed: int
                         ) -> torch.Generator:
        self._generator(iteration)
        gen = self._extra_gens.get(extra_seed)
        if gen is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(((self.seed + int(iteration)) << 20)
                            ^ (int(extra_seed) & 0xFFFFF))
            self._extra_gens[extra_seed] = gen
        return gen

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

    def node_uniforms(self, iteration: int, k: int, tag: int, C: int,
                      F: int) -> torch.Tensor:
        """``[C, F]`` float32 uniforms in [0, 1): the bynode draw of one
        split search of class ``k``'s tree."""
        return torch.rand((C, F), generator=self._generator(iteration),
                          device=self.device, dtype=torch.float32)

    def extra_uniforms(self, iteration: int, k: int, tag: int, C: int,
                       F: int, extra_seed: int = 6) -> torch.Tensor:
        """``[C, F]`` float32 uniforms in [0, 1): the extra_trees draw of
        one split search of class ``k``'s tree."""
        return torch.rand((C, F),
                          generator=self._extra_generator(iteration,
                                                          extra_seed),
                          device=self.device, dtype=torch.float32)
