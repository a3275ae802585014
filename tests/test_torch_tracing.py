"""The port's spans and counters (``utils/timing.py``): off without a
profiler, on the profiler's clock under one, nested by request, with the
same bytes and reconstructions either way; the copy helper's byte rule,
the native coder's per-job nanoseconds and the fused group PSNR's
counter. No test here needs JAX; the last needs a card."""

import ctypes
import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from raht3dgs_tpu_torch.codec import rlgr
from raht3dgs_tpu_torch.eval.metrics import gs_group_psnr
from raht3dgs_tpu_torch.models.batch_codec import BatchAttributeCodec, prepare_frame_batch
from raht3dgs_tpu_torch.models.color_codec import y_psnr_db
from raht3dgs_tpu_torch.models.gs_codec import encode_gs_frame
from raht3dgs_tpu_torch.models.gs_voxelize import compress_to_nvox
from raht3dgs_tpu_torch.models.pipeline import AttributeCodec, prepare_voxel_frame
from raht3dgs_tpu_torch.utils import device as tdev
from raht3dgs_tpu_torch.utils import synth, timing

DEPTH, BUCKET = 6, 64
STEPS = [1.0, 4.0]


def _cloud(seed, n=500, d=3):
    pts, _, attrs = synth.unique_voxel_cloud(np.random.default_rng(seed), n, DEPTH, d)
    return pts, attrs


def _colour():
    """A frame prepared, swept, decoded at its finest step and scored."""
    pts, attrs = _cloud(1)
    codec = AttributeCodec(DEPTH, dtype=torch.float32, device="cpu")
    f = prepare_voxel_frame(pts, attrs, DEPTH, bucket=BUCKET, dtype=torch.float32,
                            device="cpu")
    encs = codec.encode_sweep(f, STEPS)
    rec, _ = codec.decode(encs[0].stream, f.codes, f.weights)
    y_psnr_db(attrs[:, 0], rec[:, 0])
    return [e.stream.to_bytes() for e in encs], [rec]


def _gs():
    pts, attrs = _cloud(2, 400, 56)
    pts_ = encode_gs_frame(pts, attrs, depth=DEPTH, steps=STEPS, dtype=torch.float32,
                           bucket=BUCKET, keep_streams=True, device="cpu")
    return [p.encoded.stream.to_bytes() for p in pts_], [p.psnr["psnr_all"] for p in pts_]


def _batch():
    (p1, a1), (p2, a2) = _cloud(3), _cloud(4, 300)
    bc = BatchAttributeCodec(DEPTH, dtype=torch.float32, device="cpu")
    frames = prepare_frame_batch([p1, p2], [a1, a2], DEPTH, bucket=BUCKET,
                                 dtype=torch.float32, device="cpu")
    coeffs, orderp, _ = bc.transform(frames)
    sweep = bc.encode_sweep(frames, STEPS, coeffs=coeffs, orderp=orderp)
    recs, _ = bc.decode(sweep[0][0], frames)
    return [s.to_bytes() for streams, _ in sweep for s in streams], recs


def _merge():
    scene = synth.gaussian_scene(3000, seed=5)
    c = compress_to_nvox(scene, depth=DEPTH, device="cpu")
    return [c.positions_int.tobytes()], [c.colors]


# each entry call: its root spans, then every span it must record
CASES = {
    "colour": (_colour, ["prelude", "encode_sweep", "decode", "psnr"],
               {"prelude", "host_sort", "upload", "encode_sweep", "RAHT_transform_time",
                "rlgr_encode", "decode", "Coeff_reorder_dec_time", "rlgr_decode",
                "Dequant_time", "iRAHT_time", "psnr"}),
    "gs": (_gs, ["encode_gs_frame"],
           {"encode_gs_frame", "prelude", "host_sort", "upload",
            "RAHT_transform_time", "encode_sweep", "rlgr_encode", "decode", "rlgr_decode",
            "iRAHT_time", "psnr"}),
    "batch": (_batch, ["prepare_frame_batch", "transform", "encode_sweep", "decode"],
              {"prepare_frame_batch", "prelude", "transform", "RAHT_transform_time",
               "encode_sweep", "rlgr_encode", "decode", "rlgr_decode", "iRAHT_time"}),
    "merge": (_merge, ["merge"], {"merge", "upload", "voxelize_merge", "download"}),
}


@pytest.fixture(autouse=True)
def _fresh():
    timing.reset()
    yield
    timing.reset()


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


@pytest.mark.parametrize("case", sorted(CASES))
def test_off_records_nothing(case, monkeypatch):
    """Without a profiler no span or counter records and no profiler range
    is ever opened."""
    def refuse(*a, **k):
        raise AssertionError("a profiler range opened while tracing is off")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not timing.enabled()
    assert timing.span("prelude") is timing.span("decode")
    CASES[case][0]()
    tdev.count_copy("h2d", torch.ones(3))
    assert timing.SPANS == [] and timing.COUNTS == {}
    assert timing.snapshot() == {"spans": {}, "counts": {}}


@pytest.mark.parametrize("case", sorted(CASES))
def test_spans_nest_by_request(case):
    """Under a CPU profiler every layer span of the entry calls records,
    nested under one request id per entry call, with self time its duration
    less its children's union; the profiler holds each
    span's ``r3:`` range; bytes and reconstructions are the untraced run's."""
    fn, roots, names = CASES[case]
    off_bytes, off_out = fn()
    timing.reset()
    (on_bytes, on_out), prof = _traced(fn)
    assert on_bytes == off_bytes
    for a, b in zip(on_out, off_out):
        np.testing.assert_array_equal(a, b)

    recs = list(timing.SPANS)
    by_id = {r.id: r for r in recs}
    assert names <= {r.name for r in recs}
    top = [r for r in recs if r.parent is None]
    assert [r.name for r in sorted(top, key=lambda r: r.start_ns)] == roots
    assert len({r.request for r in recs}) == len(top)
    for r in recs:
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.request == r.request
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
        kids = sorted((c.start_ns, c.end_ns) for c in recs if c.parent == r.id)
        covered, end = 0, r.start_ns
        for s, e in kids:
            s = max(s, end)
            if e > s:
                covered, end = covered + e - s, e
        assert r.self_ns == r.end_ns - r.start_ns - covered >= 0

    assert len({r.thread for r in recs}) == 1
    ranges = {e.name for e in prof.events()}
    assert {timing.PREFIX + r.name for r in recs} <= ranges
    snap = timing.snapshot()
    for n in names:
        s = snap["spans"][n]
        assert s["calls"] >= 1 and 0 <= s["self_s"] <= s["total_s"] + 1e-9


def test_counters_of_a_sweep():
    """The sweep's voxel-steps, the frames prepared and the coder's jobs
    within its thread slots; on the CPU nothing crosses to a card."""
    _traced(_colour)
    snap = timing.snapshot()
    c, s = snap["counts"], snap["spans"]
    pts, _ = _cloud(1)
    assert c["frames_prepared"] == 1
    assert c["voxel_steps"] == len(pts) * len(STEPS)
    assert s["rlgr_encode"]["calls"] == len(STEPS) and s["rlgr_decode"]["calls"] == 1
    assert 0 < c["rlgr_job_ns"] <= c["rlgr_thread_slots"]
    assert not any(k.endswith(("_pageable", "_pinned")) for k in c)


def test_nested_span_of_one_name_counts_once():
    def inner():
        with timing.span("decode"):
            pass

    with profile(activities=[ProfilerActivity.CPU]):
        with timing.span("decode"):
            inner()
            with timing.span("psnr"):
                inner()
    s = timing.snapshot()["spans"]
    outer = [r for r in timing.SPANS if r.name == "decode" and r.parent is None][0]
    assert s["decode"]["calls"] == 3 and s["decode"]["roots"] == 1
    assert s["decode"]["total_s"] == (outer.end_ns - outer.start_ns) / 1e9
    assert s["psnr"]["calls"] == 1 and s["psnr"]["roots"] == 0


@pytest.mark.parametrize("direction", ["h2d", "d2h"])
@pytest.mark.parametrize("pinned", [False, True])
@pytest.mark.parametrize("dtype,shape", [(torch.int32, (3, 1000)), (torch.float64, (7,)),
                                         (torch.int16, ()), (torch.float32, (0, 4))])
def test_copy_byte_rule(direction, pinned, dtype, shape, monkeypatch):
    """A copy counts its host tensor's elements times their size, under the
    counter of its direction and of the host memory's kind."""
    monkeypatch.setattr(torch.Tensor, "is_pinned", lambda self: pinned)
    t = torch.zeros(shape, dtype=dtype)
    with profile(activities=[ProfilerActivity.CPU]):
        tdev.count_copy(direction, t)
        tdev.count_copy(direction, t)
    kind = "pinned" if pinned else "pageable"
    want = 2 * t.numel() * torch.finfo(dtype).bits // 8 if dtype.is_floating_point \
        else 2 * t.numel() * torch.iinfo(dtype).bits // 8
    assert timing.COUNTS == {f"{direction}_bytes_{kind}": want}


def test_helpers_count_nothing_on_the_cpu():
    x = np.arange(12, dtype=np.int32).reshape(3, 4)
    with profile(activities=[ProfilerActivity.CPU]):
        t = tdev.to_device(x, torch.device("cpu"))
        back = tdev.to_host(t)
        s = tdev.to_device(2.5, torch.device("cpu"), torch.float32)
    np.testing.assert_array_equal(back, x)
    assert s.dtype == torch.float32 and float(s) == 2.5
    assert timing.COUNTS == {}


def _native_batch(fn_name, args, count):
    """A native batch call without (``args(0)``) and with (``args(1)``) the
    per-job output: both return codes and the jobs' nanoseconds."""
    fn = getattr(rlgr.NATIVE.load(), fn_name)
    job_ns = np.zeros(count, dtype=np.uint64)
    return (fn(*args(0), None),
            fn(*args(1), job_ns.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))), job_ns)


@pytest.mark.parametrize("threads", [0, 1, 3])
def test_native_per_job_ns_leaves_the_bits(threads):
    """The batch entries give the same streams and symbols with and without
    the per-job nanoseconds, and every job's reads above 0."""
    rng = np.random.default_rng(threads)
    D, N = 5, 4000
    q = np.ascontiguousarray(rng.laplace(0, 3, size=(D, N)).round().astype(np.int32))
    offs = rlgr._sz_array([d * N for d in range(D)])
    ns = rlgr._sz_array([N] * D)
    outs = [(ctypes.POINTER(ctypes.c_uint8) * D)() for _ in range(2)]
    lens = [np.zeros(D, dtype=np.uintp) for _ in range(2)]

    def enc_args(i):
        return (q.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), rlgr._sz_ptr(offs),
                rlgr._sz_ptr(ns), D, 1, threads, outs[i], rlgr._sz_ptr(lens[i]))

    rc0, rc1, enc_ns = _native_batch("rlgr_encode_batch32_timed", enc_args, D)
    assert rc0 == rc1 == 0
    lib = rlgr.NATIVE.load()
    streams = []
    for i in range(2):
        streams.append([ctypes.string_at(outs[i][d], int(lens[i][d])) for d in range(D)])
        for d in range(D):
            lib.rlgr_buffer_free(outs[i][d])
    assert streams[0] == streams[1] == rlgr.rlgr_encode_channels(q, channel_major=True)[0]
    assert (enc_ns > 0).all()

    buf = b"".join(streams[0])
    boffs = rlgr._sz_array(np.cumsum([0] + [len(s) for s in streams[0][:-1]]))
    blens = rlgr._sz_array([len(s) for s in streams[0]])
    got = [np.zeros((D, N), np.int32) for _ in range(2)]

    def dec_args(i):
        return (rlgr._as_u8(buf), rlgr._sz_ptr(boffs), rlgr._sz_ptr(blens), rlgr._sz_ptr(ns),
                rlgr._sz_ptr(offs), D, 1, threads,
                got[i].ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))

    rc0, rc1, dec_ns = _native_batch("rlgr_decode_batch32_timed", dec_args, D)
    assert rc0 == rc1 == 0
    np.testing.assert_array_equal(got[0], q)
    np.testing.assert_array_equal(got[1], q)
    assert (dec_ns > 0).all()
    want = min(threads or lib.rlgr_pool_size(1 << 20, 0), D)
    assert lib.rlgr_pool_size(D, threads) == want


def test_worker_thread_records_nothing():
    """The profiler's state is its thread's own: a span or a counter in a
    thread it does not record is off, and its caller's spans are whole."""
    seen = []

    def work():
        seen.append(timing.enabled())
        with timing.span("psnr"):
            timing.count("frames_prepared")

    with profile(activities=[ProfilerActivity.CPU]):
        with timing.span("decode"):
            t = threading.Thread(target=work)
            t.start()
            t.join()
    assert seen == [False]
    assert [r.name for r in timing.SPANS] == ["decode"] and timing.COUNTS == {}


@pytest.mark.parametrize("dtype,fused", [(np.float32, 1), (np.float64, 0)])
def test_group_psnr_counts_its_fused_pass(dtype, fused):
    """A float32 pair takes the fused pass and counts it once; a float64
    pair keeps numpy and counts nothing; either opens one ``psnr`` span."""
    rng = np.random.default_rng(9)
    a, b = rng.normal(size=(2, 300, 56)).astype(dtype)
    with profile(activities=[ProfilerActivity.CPU]):
        gs_group_psnr(a, b)
    snap = timing.snapshot()
    assert snap["counts"].get("psnr_fused", 0) == fused
    assert snap["spans"]["psnr"]["calls"] == 1 and snap["spans"]["psnr"]["roots"] == 1


def test_reset_forgets_everything():
    with profile(activities=[ProfilerActivity.CPU]):
        with timing.span("decode"):
            timing.count("voxel_steps", 5)
    assert timing.snapshot()["counts"] == {"voxel_steps": 5}
    timing.reset()
    assert timing.snapshot() == {"spans": {}, "counts": {}}


def _memcpy_bytes(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    out = {"h2d": 0, "d2h": 0}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("cat") == "gpu_memcpy":
            kind = "h2d" if "HtoD" in e["name"] else "d2h" if "DtoH" in e["name"] else None
            if kind:
                out[kind] += int(e["args"]["bytes"])
    return out


@pytest.mark.cuda
def test_decode_copy_bytes_on_card(tmp_path):
    """On the card the bytes one decode counts are the tensors it moves:
    its symbols up, its two scalars up, its reconstruction down; and the
    profiler's copies carry the same bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: copies to a card")
    pts, attrs = _cloud(6, 3000)
    codec = AttributeCodec(DEPTH, dtype=torch.float32, device="cuda")
    f = prepare_voxel_frame(pts, attrs, DEPTH, bucket=BUCKET, dtype=torch.float32,
                            device="cuda")
    stream = codec.encode(f, 4.0).stream
    codec.decode(stream, f.codes, f.weights)
    torch.cuda.synchronize()
    timing.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rec, _ = codec.decode(stream, f.codes, f.weights)
        torch.cuda.synchronize()
    np_ = f.codes.shape[0]
    c = timing.snapshot()["counts"]
    copies = {k: v for k, v in c.items() if "_bytes_" in k}
    assert copies == {"h2d_bytes_pageable": 3 * np_ * 4 + 2 * 4,
                      "d2h_bytes_pageable": np_ * 3 * 4}
    assert timing.snapshot()["spans"]["rlgr_decode"]["calls"] == 1
    assert rec.shape == (len(pts), 3)
    seen = _memcpy_bytes(prof, tmp_path)
    assert seen == {"h2d": copies["h2d_bytes_pageable"], "d2h": copies["d2h_bytes_pageable"]}
