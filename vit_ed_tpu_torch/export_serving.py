"""Export a (pretrained) pjs scorer into a serving bundle (the JAX
package's ``scripts/export_serving.py``).

    python -m vit_ed_tpu_torch.export_serving --cfg configs/... \\
        [--pretrained <.ckpt or .pth>] --output serving/ \\
        [--batch-sizes 64,128 | sym] [--verify] [--device cpu]

``torch.export`` artifacts (``vit_ed_tpu_torch/serve/export.py``): the six
scan stages + ``weights.pt`` + ``serving_meta.json`` land in ``--output``;
a serving host replays them with ``vit_ed_tpu_torch.serve.load_scorer`` (or
``python -m vit_ed_tpu_torch.serve --bundle <dir>``) without the model
code. This is the one place of the serving tier that builds a model.

Defaults: symbolic batch (one artifact serves every batch size), exported
on the CUDA card; ``--device cpu`` exports (and ``--verify`` replays) on the
CPU. ``--opts TPU.INT8_SCORE True`` exports the int8 GEMMs of
``ops/quant.py`` over the same float32 weights. ``--platforms tpu`` and
``--mesh-data`` (multi-chip bundles) are refused.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch

from vit_ed_tpu_torch.config import get_config
from vit_ed_tpu_torch.device import resolve_device
from vit_ed_tpu_torch.models.build import build_model
from vit_ed_tpu_torch.ops.quant import int8_gemms
from vit_ed_tpu_torch.serve import export_scorer, load_scorer
from vit_ed_tpu_torch.train.checkpoint import load_pretrained
from vit_ed_tpu_torch.utils.logger import create_logger


def parse_option(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser("serving export (PyTorch port)")
    parser.add_argument("--cfg", type=str, required=True, metavar="FILE")
    parser.add_argument("--opts", default=None, nargs="+")
    parser.add_argument("--pretrained", default="",
                        help="a checkpoint of the port (.ckpt) or a reference .pth")
    parser.add_argument("--output", required=True)
    parser.add_argument("--batch-sizes", default="sym",
                        help='"sym" (symbolic batch) or comma ints')
    parser.add_argument("--platforms", default="",
                        help="the JAX exporter's target platforms; the port "
                             "exports for the device it runs on (--device)")
    parser.add_argument("--mesh-data", type=int, default=0,
                        help="multi-chip bundles: not ported yet")
    parser.add_argument("--verify", action="store_true",
                        help="replay the bundle against the live model on "
                             "this device and compare")
    parser.add_argument("--disable_amp", action="store_true")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--tag", default="export")
    args, _ = parser.parse_known_args(argv)
    # the bundle goes to --output itself, not to the run directory that
    # get_config derives from it
    output = args.output
    del args.output
    config = get_config(args)
    args.output = output
    return args, config


def main(argv: Optional[List[str]] = None) -> dict:
    """Export (and with ``--verify`` check) the bundle; returns its meta."""
    args, config = parse_option(argv)
    if args.platforms.strip() and args.platforms.strip() != "cuda":
        raise NotImplementedError(
            f"--platforms {args.platforms}: the port exports for the device "
            f"it runs on (--device cuda or cpu), not for a TPU")
    if args.mesh_data:
        raise NotImplementedError("--mesh-data: multi-chip bundles are not "
                                  "ported yet (ROADMAP queue A item 12b part 4)")
    device = resolve_device(args.device)
    os.makedirs(args.output, exist_ok=True)
    logger = create_logger(args.output, name="export")

    torch.manual_seed(config.SEED)
    model = build_model(config, device).eval()
    if args.pretrained:
        load_pretrained(model, args.pretrained, logger)
    int8 = bool(config.TPU.INT8_SCORE)
    batch_sizes = (None if args.batch_sizes.strip() == "sym"
                   else [int(x) for x in args.batch_sizes.split(",")])
    meta = export_scorer(
        model, None, args.output, batch_sizes=batch_sizes, device=device,
        int8=int8, extra_meta={"config": os.path.basename(args.cfg),
                               "pretrained": args.pretrained,
                               "int8_score": int8})
    for stage, entries in meta["stages"].items():
        logger.info(f"exported {stage}: " + ", ".join(e["file"] for e in entries))

    if args.verify:
        scorer = load_scorer(args.output, device=device)
        img = config.DATA.IMG_SIZE
        b = 2 if batch_sizes is None else batch_sizes[0]
        x = torch.from_numpy(np.random.default_rng(0).normal(
            size=(b, 2, img, img, 3)).astype(np.float32)).to(device)
        with torch.inference_mode(), int8_gemms(model, int8):
            live = model(x)
        got = scorer("pair", x)
        # the JAX script's bounds: a couple of ulps of the compute dtype
        atol = 2e-3 if model.dtype == torch.bfloat16 else 1e-5
        gap = float((got.float() - live.float()).abs().max())
        logger.info(f"verify: pair replay against the live model at batch {b}: "
                    f"max |diff| {gap:.3e} (atol {atol:g})")
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   live.float().cpu().numpy(), atol=atol)
        logger.info(f"verify ok: pair stage replay matches at batch {b}")
    return meta


if __name__ == "__main__":
    main()
