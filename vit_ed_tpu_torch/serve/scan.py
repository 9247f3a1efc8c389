"""Headless retrieval scan from a serving bundle, with no model code
(``vit_ed_tpu/serve/scan.py``).

The signature workload (the O(N^2) pair scan) driven entirely from an
exported bundle: encode + kv once per row block, prepare once per column
batch, score_row per row: the amortisation schedule of
``parallel/pairs.py``, with every device computation a replayed
``torch.export`` artifact. The stage outputs stay on the scorer's device
between calls; the score matrix is copied to the host once, at the end.
"""

from __future__ import annotations

import numpy as np
import torch

from vit_ed_tpu_torch.serve.export import ExportedScorer

__all__ = ["scan_pairs"]


def scan_pairs(scorer: ExportedScorer, images, batch_size: int = 8,
               dtype=np.float16) -> np.ndarray:
    """Full symmetric pair score matrix for ``images`` ([N, H, W, 3]).

    Returns [N, N] (or [N, N, C] for multi-logit heads) in ``dtype``,
    mirroring score_dataset's assembled output. Row/column batches pad
    up to a servable batch (bucketed) and truncate.
    """
    n = len(images)
    if n == 0:
        return np.zeros((0, 0), dtype)
    out_dtype = torch.from_numpy(np.zeros(0, dtype)).dtype

    def pad_to(arr, b):
        arr = torch.as_tensor(arr)
        if arr.shape[0] == b:
            return arr
        pad = arr.new_zeros((b - arr.shape[0],) + tuple(arr.shape[1:]))
        return torch.cat([arr, pad])

    sim = None
    for i0 in range(0, n, batch_size):
        i1 = min(i0 + batch_size, n)
        bi = scorer.servable_batch(i1 - i0)
        feats = scorer("encode", pad_to(images[i0:i1], bi))
        kv = scorer("kv", feats)[:, : i1 - i0]
        for j0 in range(i0, n, batch_size):
            j1 = min(j0 + batch_size, n)
            bj = scorer.servable_batch(j1 - j0)
            tokens = scorer("prepare", pad_to(images[j0:j1], bj))[: j1 - j0]
            for i in range(i0, i1):
                lo = max(i, j0)
                if lo >= j1:
                    continue
                bc = scorer.servable_batch(j1 - lo)
                out = scorer("score_row", kv[:, i - i0: i - i0 + 1],
                             pad_to(tokens[lo - j0:], bc))[: j1 - lo]
                if sim is None:
                    sim = torch.zeros((n, n, out.shape[-1]), dtype=out_dtype,
                                      device=out.device)
                sim[i, lo:j1] = out.to(out_dtype)
    # mirror to the lower triangle
    sim = sim.cpu().numpy()
    out = sim if sim.shape[-1] > 1 else sim[..., 0]
    il = np.tril_indices(n, -1)
    out[il] = np.swapaxes(out, 0, 1)[il]
    return out
