"""``python -m vit_ed_tpu_torch.serve``: the HTTP serving host CLI."""

from vit_ed_tpu_torch.serve.server import main

main()
