"""Record the side of the kink every ReLU unit takes, and replay it elsewhere.

Two implementations of one model (K1 against the dense f32 aggregation, this
package against the JAX one) agree in their activations to rounding, but a
pre-activation that lies within that rounding of 0 can fall on either side of
a ReLU's kink. Forward, that moves nothing; backward, the unit's derivative
is 0 on one side and 1 on the other, and every gradient below it moves by a
visible amount. A comparison of gradients that is to hold a tight tolerance
therefore pins the branches: ``record`` notes ``x > 0`` at every ``nn.ReLU``
call of one model, ``replay`` makes a second model take the same branches and
counts the units where it would have chosen otherwise (the flips).

Every ReLU of the models in this package is an ``nn.ReLU`` module; the hooks
follow call order, so a step that runs two forwards records both.

A max pool is such a kink too: where two nodes reach a graph's max within
rounding, either may win, and the gradient goes to the winner. ``max_pool``
records the winners of every ``segment_max`` call of a module (graph
contrast's pooling) and replays them elsewhere.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional

import torch
from torch import nn

# Added to a pre-activation that must count as positive: relu'(x) = 1 for any
# x > 0, and the value itself is below every tolerance.
_TINY = 1e-30


def _relus(model: nn.Module) -> List[nn.Module]:
    found = [m for m in model.modules() if isinstance(m, nn.ReLU)]
    if not found:
        raise ValueError("the model has no nn.ReLU module to hook")
    return found


@contextlib.contextmanager
def record(model: nn.Module) -> Iterator[List[torch.Tensor]]:
    """Within the block, append ``x > 0`` of every ReLU call to the list."""
    branches: List[torch.Tensor] = []
    handles = [m.register_forward_pre_hook(
        lambda _m, args: branches.append(args[0].detach() > 0))
        for m in _relus(model)]
    try:
        yield branches
    finally:
        for h in handles:
            h.remove()


@contextlib.contextmanager
def replay(model: nn.Module, branches) -> Iterator[List[int]]:
    """Within the block, the k-th ReLU call takes ``branches[k]`` (a bool
    tensor or array, True = the unit passes its input and its gradient; None
    leaves the call alone, as for a forward that no gradient flows through).
    The list counts, per call, the units whose own sign said otherwise."""
    queue = list(branches)
    flips: List[int] = []

    def hook(_m, args):
        x = args[0]
        if not queue:
            raise RuntimeError("more ReLU calls than recorded branches")
        on = queue.pop(0)
        if on is None:                  # a call that is left to itself
            flips.append(0)
            return None
        on = torch.as_tensor(on, device=x.device).bool()
        if on.shape != x.shape:
            raise ValueError(f"recorded branches {tuple(on.shape)} do not fit "
                             f"a pre-activation {tuple(x.shape)}")
        agree = (x.detach() > 0) == on
        flips.append(int((~agree).sum()))
        forced = torch.where(on, x - x.detach() + _TINY, torch.zeros_like(x))
        return (torch.where(agree, x, forced),)

    handles = [m.register_forward_pre_hook(hook) for m in _relus(model)]
    try:
        yield flips
    finally:
        for h in handles:
            h.remove()
    if queue:
        raise RuntimeError(f"{len(queue)} recorded ReLU calls were not replayed")


@contextlib.contextmanager
def max_pool(module, record: Optional[list] = None,
             replay: Optional[list] = None) -> Iterator[List[int]]:
    """Within the block, each call of ``module.segment_max`` appends its
    winners (per segment and feature, the valid rows equal to the max) to
    ``record``; or, with ``replay``, returns the mean of the data over the
    next recorded winners, so that value and gradient go where they went in
    the recorded model. The yielded list counts, per replayed call, the
    entries where the model's own winners differ."""
    real = module.segment_max
    flips: List[int] = []

    def winners(data, ids, num, mask):
        data = data.detach()
        return (data == real(data, ids, num, mask)[ids.long()]) & mask.bool()[:, None]

    def recording(data, ids, num, mask):
        record.append(winners(data, ids, num, mask))
        return real(data, ids, num, mask)

    def replaying(data, ids, num, mask):
        win = replay.pop(0)
        flips.append(int((win != winners(data, ids, num, mask)).sum()))
        ids = ids.long()
        w = win.to(data.dtype)
        count = torch.zeros(num, data.shape[1], device=data.device).index_add_(0, ids, w)
        w = w / torch.clamp(count, min=1.0)[ids]
        return torch.zeros(num, data.shape[1], device=data.device).index_add_(0, ids, data * w)

    module.segment_max = recording if record is not None else replaying
    try:
        yield flips
    finally:
        module.segment_max = real
