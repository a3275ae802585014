"""A player decoding frames back to back: ``AttributeCodec.decode`` of
R3TC streams whose geometry is given, as the decoder's API takes it.

Set-up encodes the set-up's frames at the mix's step (the streams a
player receives) and prepares each frame's padded geometry. One unit
decodes one frame; the loop is closed with one client and cycles over
the frames. Work: frames decoded; each decode's time is a sample of the
tail. The check holds a sampled frame's set-up stream (its symbols and
bytes) and the window's decode of it against the reference, which works
the frame's coefficients out again from the seed's frame.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.kinds import colour_sweep
from portbench.reference import codec as ref

DECODE_STAGES = ("Coeff_reorder_dec_time", "Entropy_dec_time", "Dequant_time",
                 "iRAHT_time")


def setup(ctx):
    from raht3dgs_tpu_torch.models.pipeline import AttributeCodec, prepare_voxel_frame
    from raht3dgs_tpu_torch.ops.color import rgb_to_yuv

    cfg, dev = ctx.cfg, ctx.device
    dtype = getattr(torch, cfg["dtype"])
    frames = colour_sweep.make_frames(ctx, dev)
    codec = AttributeCodec(cfg["depth"], dtype=dtype, device=dev)
    step = float(ctx.mix["step"])
    prepared, streams = [], []
    for V, rgb in frames:
        yuv = rgb_to_yuv(torch.as_tensor(rgb, device=dev), dtype=dtype).cpu().numpy()
        f = prepare_voxel_frame(V, yuv, cfg["depth"], bucket=cfg["bucket"], dtype=dtype,
                                device=dev)
        prepared.append(f)
        streams.append(codec.encode(f, step).stream)
    state = {"frames": frames, "prepared": prepared, "streams": streams, "codec": codec}
    for i in range(len(frames)):  # every frame's shapes once
        _decode(state, i)
    return state


def _decode(state, i: int):
    f = state["prepared"][i % len(state["prepared"])]
    return state["codec"].decode(state["streams"][i % len(state["streams"])], f.codes,
                                 f.weights)


def unit(ctx, state, i: int) -> None:
    with ctx.spans("unit"):
        rec, timer = _decode(state, i)
    k = i % len(state["frames"])
    ctx.add_stages(timer.stages, DECODE_STAGES)
    ctx.failed += rec.shape != (len(state["frames"][k][0]), ctx.cfg["channels"]) \
        or not np.isfinite(rec).all()
    ctx.count("frames", 1)
    ctx.work += 1
    slot = ctx.sample.offer()
    if slot is not None:
        ctx.sample.put(slot, {"frame": k, "rec": rec.copy()})


def release(state) -> None:
    for k in ("codec", "prepared"):
        state.pop(k, None)
    state["streams"] = [s.to_bytes() for s in state["streams"]]


def _judge(ctx, state, produce):
    worst = {}
    step = float(ctx.mix["step"])
    for kept in ctx.sample.kept:
        r = colour_sweep.reference_frame(ctx, state["frames"][kept["frame"]])
        data, rec = produce(r, kept)
        nums, _ = ref.judge_stream(r, data, step, rec=rec)
        for k, v in nums.items():
            worst[k] = max(worst.get(k, 0.0), v)
    worst["failed_units"] = float(ctx.failed)
    return worst


def check(ctx, state):
    return _judge(ctx, state, lambda r, kept: (state["streams"][kept["frame"]], kept["rec"]))


def control_sample(ctx):
    """The seed's frames and ``check_units`` frames drawn from the seed."""
    frames = colour_sweep.make_frames(ctx, ctx.device)
    for _ in range(ctx.sample.k):
        ctx.sample.kept.append({"frame": int(ctx.sample.rng.integers(0, len(frames)))})
    return {"frames": frames}


def control(ctx, state, dtype=torch.bfloat16):
    """The reference in ``dtype`` in the program's place: the set-up's
    stream of the frame encoded from its symbols in ``dtype`` and the
    window's decode reconstructed in ``dtype``."""
    from portbench.reference import entropy

    step = float(ctx.mix["step"])

    def produce(r, kept):
        q = r.symbols(step, dtype)
        return entropy.write_stream(q, step, r.depth), r.reconstruct(q, step, dtype)

    return _judge(ctx, state, produce)
