"""Lower- and upper-bound ops with the pass-through gradient rule.

Counterpart of spatiotemporalentropymodel_tpu/ops/bound.py (compressai's
``LowerBound``, compressai/ops/bound_ops.py:19-53): forward is
``max(x, bound)``; backward passes the incoming gradient iff ``x >= bound``
or the gradient would push ``x`` upward (``grad_output < 0``).
``upper_bound`` is its mirror image, ``-lower_bound(-x, -bound)``.
"""

import torch


class LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound: float):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, grad_output):
        (x,) = ctx.saved_tensors
        pass_through = (x >= ctx.bound) | (grad_output < 0)
        return torch.where(pass_through, grad_output,
                           torch.zeros_like(grad_output)), None


def lower_bound(x, bound: float):
    return LowerBound.apply(x, float(bound))


def upper_bound(x, bound: float):
    """min(x, bound); the gradient passes iff ``x <= bound`` or it would
    push ``x`` downward (``grad_output > 0``)."""
    return -lower_bound(-x, -float(bound))
