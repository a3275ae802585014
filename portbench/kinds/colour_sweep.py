"""A dataset RD sweep in batches: ``encode_dataset --batch B`` without the
PLY reads, in the order of ``raht3dgs_tpu_torch/cli/encode_dataset.py:
_encode_depth_batch``.

One unit is one batch of B frames: RGB to YUV and ``prepare_frame_batch``
(the prelude), the batched transform and inverse order, the pipelined
sweep over every step, a batched decode a step and each frame's Y PSNR.
The loop is closed and cycles over the set-up's frames in batches.
Work: voxels x steps encoded, decoded and scored.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import synth
from portbench.reference import codec as ref

PER_STEP = ("Quant_time", "Entropy_enc_time", "Entropy_dec_time",
            "Coeff_reorder_dec_time", "Dequant_time", "iRAHT_time")


def make_frames(ctx, device):
    cfg = ctx.cfg
    g = synth.generator(ctx.seed, device)
    return [synth.dataset_frame(g, f, cfg["points_per_frame"], cfg["depth"], device)
            for f in range(cfg["frames"])]


def batches_of(n_frames: int, batch: int):
    return [list(range(i, min(i + batch, n_frames))) for i in range(0, n_frames, batch)]


def setup(ctx):
    from raht3dgs_tpu_torch.models.batch_codec import BatchAttributeCodec

    cfg = ctx.cfg
    frames = make_frames(ctx, ctx.device)
    state = {"frames": frames, "batches": batches_of(len(frames), ctx.mix["batch"]),
             "codec": BatchAttributeCodec(cfg["depth"], dtype=getattr(torch, cfg["dtype"]),
                                          device=ctx.device)}
    for i in range(len(state["batches"])):  # every batch's shapes once
        _sweep(ctx, state, i, keep=False)
    return state


def _sweep(ctx, state, i: int, keep: bool = True):
    from raht3dgs_tpu_torch.models.batch_codec import prepare_frame_batch
    from raht3dgs_tpu_torch.models.color_codec import y_psnr_db
    from raht3dgs_tpu_torch.ops.color import rgb_to_yuv

    cfg, span, dev = ctx.cfg, ctx.spans, ctx.device
    dtype = getattr(torch, cfg["dtype"])
    idx = state["batches"][i % len(state["batches"])]
    members = [state["frames"][f] for f in idx]
    bc = state["codec"]
    steps = [float(s) for s in cfg["steps"]]
    with span("prelude"):
        pos = [np.floor(np.asarray(v)).astype(np.int64) for v, _ in members]
        yuv = [rgb_to_yuv(torch.as_tensor(np.asarray(c), device=dev), dtype=dtype).cpu().numpy()
               for _, c in members]
        frames = prepare_frame_batch(pos, yuv, cfg["depth"], bucket=cfg["bucket"], dtype=dtype,
                                     device=dev)
    with span("transform"):
        coeffs, orderp, t_timer = bc.transform(frames)
    with span("inverse_order"):
        inv = bc.inverse_order(frames)
    refs = [f.attributes[:f.n_voxels, 0].cpu().numpy() for f in frames]
    with span("encode_sweep"):
        sweep = bc.encode_sweep(frames, steps, coeffs=coeffs, orderp=orderp)
    outs = []
    for step, (streams, timer) in zip(steps, sweep):
        with span("decode"):
            recs, timer = bc.decode(streams, frames, timer=timer, inv=inv)
        with span("psnr"):
            psnrs = [y_psnr_db(refs[j], recs[j][:, 0]) for j in range(len(frames))]
        outs.append((streams, recs, psnrs, timer))
    if not keep:
        return
    ctx.add_stages(t_timer.stages)
    nvox = [len(v) for v, _ in members]
    bad = 0
    for streams, recs, psnrs, timer in outs:
        ctx.add_stages(timer.stages, PER_STEP)
        bad += len(streams) != len(members) or len(recs) != len(members)
        bad += sum(s.n_voxels != n for s, n in zip(streams, nvox))
        bad += sum(r.shape != (n, cfg["channels"]) for r, n in zip(recs, nvox))
        bad += sum(not np.isfinite(p) for p in psnrs)
    ctx.failed += bool(bad)
    ctx.count("frames", len(members))
    ctx.work += sum(nvox) * len(steps)
    slot = ctx.sample.offer()
    if slot is not None:
        # every frame of the batch, each at its own draw of steps, so a
        # fault in any slot of the batch shows
        kept = []
        for j in range(len(members)):
            pick = sample_steps(ctx.sample.rng, len(steps), ctx.mix["check_steps"])
            kept.append({
                "frame": idx[j],
                "steps": [steps[k] for k in pick],
                "streams": [outs[k][0][j].to_bytes() for k in pick],
                "recs": [outs[k][1][j].copy() for k in pick],
                "psnrs": [outs[k][2][j] for k in pick],
            })
        ctx.sample.put(slot, kept)


def sample_steps(rng, n_steps: int, k: int):
    """The finest step (the longest stream), then ``k - 1`` others drawn
    from the seed."""
    rest = rng.choice(np.arange(1, n_steps), size=min(k - 1, n_steps - 1), replace=False)
    return [0] + sorted(int(x) for x in rest)


def unit(ctx, state, i: int) -> None:
    with ctx.spans("unit"):
        _sweep(ctx, state, i)


def release(state) -> None:
    state.pop("codec", None)


def reference_frame(ctx, frame) -> "ref.RefFrame":
    V, rgb = frame
    return ref.RefFrame(V, ref.rgb_to_yuv(rgb), ctx.cfg["depth"])


def _judge(ctx, state, produce):
    """The numbers of every frame of every sampled unit, their worst.
    ``produce(r, kept)`` gives ``[(stream bytes, rec, psnr), ...]`` for a
    frame's kept steps."""
    worst = {}
    for kept in (k for unit in ctx.sample.kept for k in unit):
        r = reference_frame(ctx, state["frames"][kept["frame"]])
        for (data, rec, psnr), step in zip(produce(r, kept), kept["steps"]):
            # every channel is decoded; the pure-Python coder re-encodes
            # a seeded sample of channels for the bytes (~1.5 s a channel)
            chans = ctx.sample.rng.choice(ctx.cfg["channels"], ctx.mix["reencode_channels"],
                                          replace=False)
            nums, R = ref.judge_stream(r, data, step, rec=rec, reencode=[int(x) for x in chans])
            if R is not None:
                nums["psnr_err_db"] = abs(psnr - ref.y_psnr_db(r.attrs[:, 0], R[:, 0]))
            for k, v in nums.items():
                worst[k] = max(worst.get(k, 0.0), v)
    worst["failed_units"] = float(ctx.failed)
    return worst


def check(ctx, state):
    return _judge(ctx, state, lambda r, kept: zip(kept["streams"], kept["recs"], kept["psnrs"]))


def control_sample(ctx):
    """The state and sample a run would judge, without the program: the
    seed's frames and ``check_units`` draws of a batch, each of its frames
    with its own steps."""
    frames = make_frames(ctx, ctx.device)
    batches = batches_of(len(frames), ctx.mix["batch"])
    rng = ctx.sample.rng
    for _ in range(ctx.sample.k):
        unit = []
        for f in batches[int(rng.integers(0, len(batches)))]:
            pick = sample_steps(rng, len(ctx.cfg["steps"]), ctx.mix["check_steps"])
            unit.append({"frame": f, "steps": [float(ctx.cfg["steps"][k]) for k in pick]})
        ctx.sample.kept.append(unit)
    return {"frames": frames}


def control(ctx, state, dtype=torch.bfloat16):
    """The reference in ``dtype`` in the program's place: its symbols in a
    stream, its reconstruction and its PSNR."""
    from portbench.reference import entropy

    def produce(r, kept):
        out = []
        for step in kept["steps"]:
            q = r.symbols(step, dtype)
            rec = r.reconstruct(q, step, dtype)
            data = entropy.write_stream(q, step, r.depth)
            y = torch.from_numpy(r.attrs[:, 0]).to(dtype).double().numpy()
            out.append((data, rec, ref.y_psnr_db(y, rec[:, 0])))
        return out

    return _judge(ctx, state, produce)
