"""A 3DGS compression sweep: ``voxelize_3dgs`` then ``encode_3dgs`` without
the PLY writes and reads.

One unit is one scene: ``models.gs_voxelize.compress_to_nvox`` (voxelize
the means, merge each voxel's Gaussians) and ``models.gs_codec.
encode_gs_frame`` over every step of the configuration, the 56-channel
payload ``[quats, scales, opacity, colors]`` of the merge with its vmin
and width as ``encode_3dgs`` passes them (``cli/encode_3dgs.py:128``),
each step decoded and scored by group PSNR. The loop is closed and cycles
over the set-up's scenes. Work: voxels x steps. The program's codec is
handed to ``encode_gs_frame`` behind :class:`KeepRecs`, which keeps the
reconstructions of a sampled unit's sampled steps for the check.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import synth
from portbench.kinds.colour_sweep import sample_steps
from portbench.reference import codec as ref
from portbench.reference import gs as refgs

PER_STEP = ("Quant_time", "Entropy_enc_time", "Entropy_dec_time",
            "Coeff_reorder_dec_time", "Dequant_time", "iRAHT_time")
PER_FRAME = ("RAHT_prelude_time", "RAHT_transform_time")
PSNR_KEYS = ("psnr_all", "psnr_quats", "psnr_scales", "psnr_opacity", "psnr_colors")


def make_scenes(ctx, device):
    g = synth.generator(ctx.seed, device)
    return [synth.gaussian_scene(g, ctx.cfg["gaussians"], device)
            for _ in range(ctx.cfg["scenes"])]


class KeepRecs:
    """The program's codec as ``encode_gs_frame`` calls it, keeping the
    reconstruction of each decode whose index (the step's, in the sweep's
    order) is in ``pick``; everything else is the codec's own."""

    def __init__(self, codec):
        self._codec = codec
        self.pick = ()
        self.recs = {}
        self.calls = 0

    def __getattr__(self, name):
        return getattr(self._codec, name)

    def start(self, pick=()) -> None:
        self.pick, self.recs, self.calls = tuple(pick), {}, 0

    def decode(self, *a, **k):
        rec, timer = self._codec.decode(*a, **k)
        if self.calls in self.pick:
            self.recs[self.calls] = rec
        self.calls += 1
        return rec, timer


def setup(ctx):
    from raht3dgs_tpu_torch.models.pipeline import AttributeCodec

    cfg = ctx.cfg
    state = {"scenes": make_scenes(ctx, ctx.device),
             "codec": KeepRecs(AttributeCodec(cfg["depth"], dtype=getattr(torch, cfg["dtype"]),
                                              device=ctx.device))}
    for i in range(len(state["scenes"])):  # every scene's shapes once
        _scene(ctx, state, i, keep=False)
    return state


def payload(c) -> np.ndarray:
    n = c.n_voxels
    return np.concatenate([c.quats[:n], c.scales[:n], c.opacities[:n, None], c.colors[:n]],
                          axis=1)


def _scene(ctx, state, i: int, keep: bool = True):
    from raht3dgs_tpu_torch.models.gs_codec import encode_gs_frame
    from raht3dgs_tpu_torch.models.gs_voxelize import compress_to_nvox

    cfg, span = ctx.cfg, ctx.spans
    k = i % len(state["scenes"])
    scene = state["scenes"][k]
    steps = [float(s) for s in cfg["steps"]]
    slot = ctx.sample.offer() if keep else None
    pick = sample_steps(ctx.sample.rng, len(steps), ctx.mix["check_steps"]) \
        if slot is not None else ()
    state["codec"].start(pick)
    with span("merge"):
        c = compress_to_nvox(scene, depth=cfg["depth"], device=ctx.device)
    n = c.n_voxels
    with span("encode_sweep"):
        points = encode_gs_frame(
            c.positions_int[:n], payload(c), depth=cfg["depth"], steps=steps,
            bucket=cfg["bucket"], dtype=getattr(torch, cfg["dtype"]), keep_streams=True,
            codec=state["codec"], vmin=c.vmin, width=float(c.voxel_size) * (1 << cfg["depth"]),
            device=ctx.device)
    if not keep:
        return
    ctx.add_stages({s: v for s, v in points[0].times.items() if s in PER_FRAME})
    for pt in points:
        ctx.add_stages(pt.times, PER_STEP)
    bad = len(points) != len(steps)
    bad += sum(pt.n_voxels != n or pt.encoded is None or pt.encoded.stream.n_voxels != n
               or not all(np.isfinite(pt.psnr[q]) for q in PSNR_KEYS) for pt in points)
    ctx.failed += bool(bad)
    ctx.count("frames", 1)
    ctx.work += n * len(steps)
    if slot is not None:
        recs = state["codec"].recs
        ctx.sample.put(slot, {
            "scene": k, "n": n, "positions": c.positions_int[:n].copy(),
            "cluster": c.cluster_of_input.copy(), "vmin": np.asarray(c.vmin, np.float64),
            "voxel_size": float(c.voxel_size), "payload": payload(c),
            "steps": [steps[j] for j in pick],
            "streams": [points[j].encoded.stream.to_bytes() for j in pick],
            "psnrs": [dict(points[j].psnr) for j in pick],
            "recs": [recs.get(j) for j in pick],
        })
    state["codec"].start()


def unit(ctx, state, i: int) -> None:
    with ctx.spans("unit"):
        _scene(ctx, state, i)


def release(state) -> None:
    state.pop("codec", None)


def _judge(ctx, state, produce):
    """Worst numbers over the sampled scenes. ``produce(scene, kept)``
    gives the merge (positions, cluster, n, vmin, voxel size, payload) and
    ``[(stream bytes, psnr dict, rec), ...]`` for the kept steps."""
    depth = ctx.cfg["depth"]
    worst = {}

    def put(k, v):
        worst[k] = max(worst.get(k, 0.0), v)

    for kept in ctx.sample.kept:
        scene = state["scenes"][kept["scene"]]
        (P, cluster, n, vmin, vs, pay), coded = produce(scene, kept)
        put("vox_gap", refgs.voxel_gap(scene["means"], depth, P, cluster, n, vmin, vs))
        if not np.isfinite(worst["vox_gap"]):
            continue
        merged = refgs.merge(scene, cluster, n)
        put("merge_err", refgs.merge_err(pay, merged))
        r = ref.RefFrame(P[:n], merged, depth)
        for (data, psnr, rec), step in zip(coded, kept["steps"]):
            # the Python coder takes ~0.2 s a channel to encode: the bytes
            # of a seeded sample of channels are compared, every channel
            # is decoded
            chans = ctx.sample.rng.choice(ctx.cfg["channels"], ctx.mix["reencode_channels"],
                                          replace=False)
            nums, R = ref.judge_stream(r, data, step, rec=rec,
                                       reencode=[int(x) for x in chans])
            if R is not None:
                want = ref.gs_group_psnr(r.attrs, R)
                nums["psnr_err_db"] = max(abs(psnr[q] - want[q]) for q in PSNR_KEYS)
            for q, v in nums.items():
                put(q, v)
    worst["failed_units"] = float(ctx.failed)
    return worst


def check(ctx, state):
    return _judge(ctx, state, lambda scene, kept: (
        (kept["positions"], kept["cluster"], kept["n"], kept["vmin"], kept["voxel_size"],
         kept["payload"]), list(zip(kept["streams"], kept["psnrs"], kept["recs"]))))


def control_sample(ctx):
    """The seed's scenes and ``check_units`` draws of a scene and steps."""
    scenes = make_scenes(ctx, ctx.device)
    for _ in range(ctx.sample.k):
        pick = sample_steps(ctx.sample.rng, len(ctx.cfg["steps"]), ctx.mix["check_steps"])
        ctx.sample.kept.append({"scene": int(ctx.sample.rng.integers(0, len(scenes))),
                                "steps": [float(ctx.cfg["steps"][j]) for j in pick]})
    return {"scenes": scenes}


def control(ctx, state, dtype=torch.bfloat16):
    """The reference in ``dtype`` in the program's place: voxelize, merge,
    transform, quantize and reconstruct (the decode and its PSNRs)."""
    from portbench.reference import entropy

    depth = ctx.cfg["depth"]

    def produce(scene, kept):
        u, vmin, vs = refgs.voxel_coords(scene["means"], depth, dtype)
        V = np.clip(np.floor(u), 0, (1 << depth) - 1).astype(np.int64)
        P, cluster = np.unique(V, axis=0, return_inverse=True)
        cluster = cluster.reshape(-1)
        pay = refgs.merge(scene, cluster, len(P), dtype)
        r = ref.RefFrame(P, pay, depth)
        coded = []
        for step in kept["steps"]:
            q = r.symbols(step, dtype)
            rec = r.reconstruct(q, step, dtype)
            coded.append((entropy.write_stream(q, step, depth), ref.gs_group_psnr(r.attrs, rec),
                          rec))
        return (P, cluster, len(P), vmin, vs, pay), coded

    return _judge(ctx, state, produce)
