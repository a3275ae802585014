"""3D Gaussian Splatting checkpoint ingestion (gsplat ``torch.save`` format).

Counterpart of ``raht3dgs_tpu/io/gsplat_ckpt.py``: reads a gsplat training
checkpoint (``ckpt['splats']`` with means/quats/scales/opacities/sh0/shN)
with ``torch.load(weights_only=True)``, converts the parameters out of
their training-space encodings and returns plain float64 numpy arrays:

- quats: L2-normalized;
- scales: ``exp`` if stored in log space (negative values present);
- opacities: ``sigmoid`` if stored as logits (values outside [0, 1]);
- SH: ``sh0 (N, 1, 3)`` and ``shN (N, K, 3)`` concatenated and flattened
  to ``(N, 3 * (K + 1))``, one coefficient's three channels after another
  (the 48-channel [dc, rest] layout of the compressed-3DGS PLY).
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional

import numpy as np
import torch


def load_gsplat_checkpoint(path) -> Optional[Dict[str, np.ndarray]]:
    """Load and normalize a gsplat checkpoint.

    Returns a dict with means (N, 3), quats (N, 4), scales (N, 3),
    opacities (N,) and colors (N, C), or None (with a warning) if the file
    cannot be parsed."""
    try:
        # weights_only: never unpickle arbitrary objects from a checkpoint
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        splats = ckpt["splats"] if "splats" in ckpt else ckpt
        if "means" not in splats:
            raise KeyError("no 'means' in checkpoint")
    except Exception as e:  # noqa: BLE001 - reported, and None returned
        warnings.warn(
            f"could not parse gsplat checkpoint {path}: {e} — if this is a "
            "weights_only unpickling failure, the checkpoint contains "
            "non-tensor entries (configs/optimizer state); re-save it with "
            "tensors only, or extract the 'splats' dict yourself"
        )
        return None

    def grab(key):
        return splats[key].detach().cpu().numpy().astype(np.float64)

    means = grab("means")
    quats = grab("quats")
    scales = grab("scales")
    opac = grab("opacities").reshape(-1)
    sh0 = grab("sh0")   # (N, 1, 3)
    shN = grab("shN") if "shN" in splats else np.zeros((means.shape[0], 0, 3))

    norms = np.linalg.norm(quats, axis=1, keepdims=True)
    quats = quats / np.where(norms > 0, norms, 1.0)
    if scales.min() < 0:  # log-space storage
        scales = np.exp(scales)
    if opac.min() < 0 or opac.max() > 1:  # logit storage
        opac = 1.0 / (1.0 + np.exp(-opac))

    sh = np.concatenate([sh0, shN], axis=1)        # (N, K+1, 3)
    colors = sh.reshape(sh.shape[0], -1)            # (N, 3*(K+1))
    return {"means": means, "quats": quats, "scales": scales,
            "opacities": opac, "colors": colors}
