"""The serving tier of the port (``vit_ed_tpu/serve``): the export bundle,
its headless scan, the HTTP host and its client."""

from vit_ed_tpu_torch.serve.client import ServeClient, ServeError
from vit_ed_tpu_torch.serve.export import (FORMAT_VERSION, STAGES, ExportedScorer,
                                           export_scorer, load_scorer, stage_fns)
from vit_ed_tpu_torch.serve.scan import scan_pairs
from vit_ed_tpu_torch.serve.server import BundleServer, DynamicBatcher

__all__ = ["BundleServer", "DynamicBatcher", "ExportedScorer",
           "FORMAT_VERSION", "STAGES", "ServeClient", "ServeError",
           "export_scorer", "load_scorer", "scan_pairs", "stage_fns"]
