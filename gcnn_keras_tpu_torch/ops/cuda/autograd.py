"""What the running backward pass needs of a Function's inputs.

``ctx.needs_input_grad`` says only whether an input requires a gradient at
all. A force pass (``torch.autograd.grad(energy, coordinates)``) runs the
backward of every Function on the path to the coordinates, and an input of
such a Function may require a gradient (it depends on the parameters) that
this pass does not want: the first interaction's node features, or the
filter weights. JAX's linearization never emits those cotangents. This asks
the autograd engine, as its own built-in nodes do, whether the node that
would receive the cotangent runs in this pass.
"""
from __future__ import annotations

import torch


def input_needed(ctx, i: int) -> bool:
    """Whether the current backward pass uses the cotangent of input ``i``.
    Every input before ``i`` must be a tensor: ``ctx.next_functions`` has
    entries for the tensor inputs only.

    The engine answers for an input that an operation made; for a leaf
    (a parameter) under ``torch.autograd.grad`` it cannot, and the answer
    is ``ctx.needs_input_grad[i]``."""
    if not ctx.needs_input_grad[i]:
        return False
    node = ctx.next_functions[i][0]
    if node is None:
        return False
    if type(node).__name__ == "AccumulateGrad":
        return True
    return torch._C._will_engine_execute_node(node)
