"""Command-line tools: ``python -m raht3dgs_tpu_torch.cli.encode_ply`` and
``python -m raht3dgs_tpu_torch.cli.decode``."""
