"""Row gather whose backward sums in a fixed order.

``x.index_select(0, index)`` scatters its gradient back with ``index_add_``,
which on CUDA adds with atomics: rows gathered more than once (an image in
several mined pairs) sum their gradients in whatever order the atomics land,
so two identical train steps can differ in the last bit. ``gather_rows`` is
the same forward gather; its backward is one product of the [N, P] one-hot
matrix of ``index`` with the [P, rest] gradient, accumulated in float32 and
rounded once to the gradient's type, which sums every row in one fixed
order on the CPU and on the card.

The product is small on the training path: P is the padded pair count
(``max_pairs``, 49 at batch 16) and N the batch.
"""

from __future__ import annotations

import torch


class _GatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(index)
        ctx.n_rows = x.shape[0]
        return x.index_select(0, index)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (index,) = ctx.saved_tensors
        onehot = torch.nn.functional.one_hot(index, ctx.n_rows).t().float()
        grad = onehot @ g.reshape(index.numel(), -1).float()
        return grad.reshape((ctx.n_rows,) + g.shape[1:]).to(g.dtype), None


def gather_rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x.index_select(0, index)`` (``index`` int64) with a deterministic
    backward."""
    return _GatherRows.apply(x, index)
