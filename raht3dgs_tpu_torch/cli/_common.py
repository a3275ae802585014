"""Shared CLI plumbing: device and dtype selection, profiling, CSV logging.

Counterpart of ``raht3dgs_tpu/cli/_common.py``. ``--platform`` picks the
device: ``cuda`` by default (the CLIs raise without a card), ``cpu``
when asked.
"""

from __future__ import annotations

import argparse
import contextlib
import os
from pathlib import Path

import torch

from raht3dgs_tpu_torch.config import RuntimeConfig


def add_runtime_args(p: argparse.ArgumentParser) -> None:
    rc = RuntimeConfig()
    p.add_argument(
        "--platform", choices=("cuda", "cpu"), default=rc.platform,
        help="device to run on (default: cuda; raises without a card)",
    )
    p.add_argument(
        "--dtype", choices=("float32", "float64"), default=rc.dtype,
        help="transform precision (float64 matches the reference; float32 "
        "is the fast path)",
    )
    p.add_argument(
        "--bucket", type=int, default=rc.bucket,
        help="padding granularity of a frame's voxel count",
    )
    p.add_argument("--csv", default=None, help="CSV log path (default: results/...)")
    p.add_argument(
        "--profile", default=None, metavar="DIR",
        help="write a torch.profiler chrome trace of the run into DIR: the "
        "kernels and copies, and the program's own spans (r3:prelude, "
        "r3:encode_sweep, r3:rlgr_encode, r3:decode, ...) with the request id "
        "of each entry call among their arguments",
    )


def add_geometry_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--code-geometry", action="store_true",
        help="attach a lossless geometry section (octree occupancy and an "
        "adaptive binary range coder) to every saved stream, so that "
        "cli.decode needs no --positions; its rate is printed apart from "
        "the attribute bpp (the CSV schema is unchanged)",
    )


def add_quant_args(p: argparse.ArgumentParser) -> None:
    """Quantizer selection flags (shared by the encode CLIs)."""
    p.add_argument(
        "--quant-mode", choices=("mid", "deadzone"), default="mid",
        help="scalar quantizer: 'mid' = the reference's round-half-up; "
        "'deadzone' = sign-symmetric dead zone with biased reconstruction",
    )
    p.add_argument(
        "--quant-f", type=float, default=0.3,
        help="dead-zone encoder rounding offset in (0, 0.5]",
    )
    p.add_argument(
        "--rec-delta", type=float, default=0.12,
        help="dead-zone reconstruction offset",
    )
    p.add_argument(
        "--entropy", choices=("rlgr", "rac", "auto"), default="rlgr",
        help="attribute entropy coder: 'rlgr' = the reference coder; 'rac' = "
        "adaptive binary range coding (the same reconstructions); 'auto' = "
        "per channel the smallest of both. Recorded per channel in the "
        "stream, so decode needs no flag",
    )
    p.add_argument(
        "--predict", action="store_true",
        help="inter-depth predicted RAHT: code each depth group's "
        "coefficients as residuals against an upsampled prediction from the "
        "coarser depth's reconstruction, with a per-depth on/off decision "
        "signalled in the stream (decode needs no flag). On the card the "
        "device encoder runs it; decode replays the host closed loop",
    )


def quant_kwargs(args) -> dict:
    """AttributeCodec / BatchAttributeCodec kwargs from the
    :func:`add_quant_args` flags."""
    return {
        "quant_mode": args.quant_mode,
        "quant_f": args.quant_f,
        "rec_delta": args.rec_delta,
        "entropy": getattr(args, "entropy", "rlgr"),
        "predict": getattr(args, "predict", False),
    }


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "float64": torch.float64}[name]


@contextlib.contextmanager
def maybe_profile(args, device: torch.device):
    """With ``--profile DIR``: a torch.profiler session around the run,
    written to ``DIR/trace.json`` (chrome trace format) when it ends. The
    program's spans (``utils/timing.py``) record inside it as ``r3:``
    ranges; shapes are recorded so that each range carries its request
    id."""
    if not args.profile:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, record_shapes=True) as prof:
        yield
    os.makedirs(args.profile, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))


class CsvLogger:
    def __init__(self, path, header: str):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "w")
        self._f.write(header + "\n")
        self._f.flush()

    def row(self, line: str) -> None:
        self._f.write(line + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()
