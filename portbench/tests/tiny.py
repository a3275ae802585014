"""Tiny sizes of every cell for the benchmark's CPU tests."""

import argparse

from portbench import harness

SIZES = {
    "vox10-colour-8ivfb": {"points_per_frame": 6000, "depth": 6, "bucket": 256},
    "gs-56ch-2m": {"gaussians": 6000, "depth": 6, "bucket": 256},
}


def cell(name: str) -> harness.Cell:
    c = harness.find_cell(name)
    c.config = dict(c.config, **SIZES[c.workload["config"]])
    return c


def args(name: str, seed: int = 2**40 + 3, seconds: float = 0.5, trace: int = 0):
    return argparse.Namespace(workload=name, seed=seed, seconds=seconds, trace=trace)


def cells():
    return [w["name"] for w in harness.benchmark()["workloads"]]
