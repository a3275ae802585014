"""The port's temporal prediction (``ops/temporal.py``) and I/P sequence
codec (``models/temporal.py``) against the JAX package's, on the CPU.

Inputs: a few thousand voxels of a seeded shell translating one voxel a
frame along x (a few percent of voxels dropped a frame, non-integer smooth
colours with noise), padded to one bucket, at J = 7 (int32 codes) and
J = 12 (int64 codes). The motion search, the block map and the prediction
are integer work (the witness errors float64, formed as XLA:CPU forms
them, a chain of fused multiply-adds in channel order), so every output
must equal the JAX package's bitwise, through both of the port's joins.

The sequence codec is held to the gate of ROADMAP queue A item 6: float64
streams byte-identical except symbols within 1e-9 of a quantization tie
(counted and reported), and each package decodes the other's sequence to
within 1e-9 of its own reconstruction. In float32 the closed loop carries
last-bit differences from frame to frame, so the tolerance grows with the
distance from the I-frame (``F32_TOL``, measured)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from raht3dgs_tpu.codec.bitstream import FrameStream as JaxStream
from raht3dgs_tpu.models import pipeline as jp, temporal as jtm
from raht3dgs_tpu.ops import temporal as jt
from raht3dgs_tpu.ops.prelude import morton_codes_np
from raht3dgs_tpu_torch.codec.bitstream import FrameStream
from raht3dgs_tpu_torch.models import pipeline as tp, temporal as ttm
from raht3dgs_tpu_torch.ops import temporal as tt
from raht3dgs_tpu_torch.ops.morton import morton_encode

_TORCH = {jnp.float64: torch.float64, jnp.float32: torch.float32}
BUCKET = 4096
STEP = 4.0
TIE_TOL = 1e-9
F64_TOL = 1e-9
# float32 cross-decodes, absolute on colours in [0, 255]: a frame k frames
# after its I-frame within F32_TOL * (k + 1) (measured on this sequence:
# 3.1e-5 at the I-frame, 3.8e-5 three frames on)
F32_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sequence(depth, n_frames=5, n=3000, seed=0, drop=0.03):
    """(V, attrs) per frame: a jittered spherical shell moving +1 voxel in x
    a frame, a share ``drop`` of its voxels dropped at random each frame (so
    the centroid moves by exactly one voxel only at ``drop=0``); colours a smooth
    function of the content position plus a fixed per-voxel texture (which
    prediction carries and intra coding pays for) and seeded noise."""
    rng = np.random.default_rng(seed)
    g = 2**depth
    d = rng.normal(size=(4 * n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = 0.5 * g + (0.28 * g + rng.normal(0, 0.01 * g, 4 * n))[:, None] * d
    base = np.clip(np.floor(pts), 0, g - n_frames - 1).astype(np.int64)
    _, first = np.unique(morton_codes_np(base, depth), return_index=True)
    base = base[np.sort(first)][:n]
    u = base / g
    colour = np.stack([120 + 90 * np.sin(7 * u[:, 0] + 3 * u[:, 1]),
                       100 + 80 * np.cos(5 * u[:, 2] - 2 * u[:, 0]),
                       60 + 150 * u[:, 1] * u[:, 2]], axis=1) + 0.37
    colour = colour + rng.uniform(-30, 30, colour.shape)
    out = []
    for k in range(n_frames):
        keep = rng.random(len(base)) >= drop
        V = base[keep] + np.array([k, 0, 0])
        out.append((V, colour[keep] + rng.normal(0, 0.8, (int(keep.sum()), 3))))
    return out


def _frames(seq, depth, dtype=jnp.float64):
    jf = [jp.prepare_voxel_frame(V, A, depth, bucket=BUCKET, dtype=dtype) for V, A in seq]
    tf = [tp.voxel_frame_from_arrays(np.array(f.codes), np.array(f.attributes),
                                     np.array(f.weights), f.n_voxels, f.depth, f.vmin,
                                     f.width, device="cpu") for f in jf]
    return jf, tf


@pytest.fixture(scope="module")
def j7():
    return _frames(_sequence(7), 7)


@pytest.fixture(scope="module")
def j12():
    return _frames(_sequence(12, n_frames=2, n=1500, seed=1, drop=0.0), 12)


def _eq(t, j):
    a, b = t.numpy(), np.asarray(j)
    return a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("depth", [7, 12])
def test_ops_match_jax_bitwise(j7, j12, depth):
    """Every op through both of the port's joins against the JAX package's
    golden join (``search``; its own tests pin ``sort`` to it). The int64
    depth runs the strided search and the 27-probe prediction only (the
    JAX package compiles each variant anew)."""
    jf, tf = j7 if depth == 7 else j12
    (jb, ja), (tb, ta) = jf[:2], tf[:2]   # frame 1 predicted from frame 0
    assert ta.codes.dtype == (torch.int32 if depth == 7 else torch.int64)
    assert ta.codes.shape[0] > ta.n_voxels  # pad slots take part
    kw = dict(join="search")
    mj = jt.estimate_global_motion(ja.codes, ja.weights, jb.codes, jb.weights, depth, **kw)
    rj = jt.refine_block_motion(ja.codes, ja.weights, jb.codes, jb.weights, depth, mj, **kw)
    strides = (1, 4) if depth == 7 else (4,)
    variants = ((7, None), (7, "field"), (27, "field"), (27, "global")) if depth == 7 \
        else ((27, "field"),)
    sj = {stride: jt.search_block_motion(ja.codes, ja.attributes, ja.weights, jb.codes,
                                         jb.attributes, jb.weights, depth, mj,
                                         stride=stride, **kw) for stride in strides}
    pj = {(probes, m): jt.predict_from_previous(
        ja.codes, jb.codes, jb.attributes, jb.weights, depth, probes,
        None if m is None else (mj if m == "global" else sj[strides[0]]), **kw)
        for probes, m in variants}
    for join in tt.JOINS:
        mt = tt.estimate_global_motion(ta.codes, ta.weights, tb.codes, tb.weights, depth,
                                       join=join)
        assert _eq(mt, mj) and mt.tolist() == [1, 0, 0]
        rt = tt.refine_block_motion(ta.codes, ta.weights, tb.codes, tb.weights, depth, mt,
                                    join=join)
        assert _eq(rt, rj)
        st = {}
        for stride in strides:
            st[stride] = tt.search_block_motion(ta.codes, ta.attributes, ta.weights,
                                                tb.codes, tb.attributes, tb.weights, depth,
                                                mt, join=join, stride=stride)
            assert _eq(st[stride], sj[stride]), (join, stride)
        for (probes, m), (pred_j, found_j) in pj.items():
            pt, ft = tt.predict_from_previous(
                ta.codes, tb.codes, tb.attributes, tb.weights, depth, probes,
                None if m is None else (mt if m == "global" else st[strides[0]]),
                join=join)
            assert _eq(pt, pred_j) and _eq(ft, found_j), (join, probes, m)
            assert float(ft[:ta.n_voxels].float().mean()) > 0.8
    for bsl in (2, 4):
        want = np.asarray(jt.block_first(np.asarray(ja.codes), depth, bsl))
        assert np.array_equal(tt.block_first(ta.codes.numpy(), depth, bsl), want)
        assert _eq(tt.block_first(ta.codes, depth, bsl), want)


def test_joins_give_the_same_integers(j7):
    _, (tb, ta, *_) = j7
    out = {}
    for join in tt.JOINS:
        hit, idx = tt._probe_match(
            tt._probe_codes(tt.morton_decode(ta.codes, 7), tt._SHELL27, 127, 7,
                            tb.codes.dtype), tb.codes, tb.weights > 0, join)
        out[join] = (hit, torch.where(hit, idx, -1))
    assert torch.equal(out["search"][0], out["sort"][0])
    assert torch.equal(out["search"][1], out["sort"][1])
    with pytest.raises(ValueError, match="unknown join"):
        tt.predict_from_previous(ta.codes, tb.codes, tb.attributes, tb.weights, 7, join="x")


def test_motion_ignores_pad_votes():
    """Pad sentinels decode to in-range positions: were they to vote, this
    small translated blob would elect the zero vector at some buckets."""
    rng = np.random.default_rng(1)
    B = np.array([[x, y, z] for x in (5, 6) for y in (4, 5, 6) for z in (12, 13, 14)])
    A = rng.uniform(0, 255, (len(B), 3))
    for bucket in (512, 1024, 4096):
        fp = tp.prepare_voxel_frame(B, A, 5, bucket=bucket, device="cpu")
        fc = tp.prepare_voxel_frame(B + np.array([3, 0, 0]), A, 5, bucket=bucket,
                                    device="cpu")
        m = tt.estimate_global_motion(fc.codes, fc.weights, fp.codes, fp.weights, 5)
        assert m.tolist() == [3, 0, 0]


def test_pack_unpack_motion_match_jax(j7):
    jf, tf = j7
    ja, jb = jf[1], jf[0]
    m = jt.estimate_global_motion(ja.codes, ja.weights, jb.codes, jb.weights, 7)
    mv = np.asarray(jt.search_block_motion(ja.codes, ja.attributes, ja.weights, jb.codes,
                                           jb.attributes, jb.weights, 7, m))
    codes = np.asarray(ja.codes)
    g = np.asarray(m).astype(np.int64)
    for bsl in (3, 4):
        want = jtm._pack_motion(codes, ja.n_voxels, 7, bsl, g, mv)
        got = ttm._pack_motion(codes, ja.n_voxels, 7, bsl, g, mv)
        assert got == want
        back = ttm._unpack_motion(got, codes, ja.n_voxels, len(codes), 7)
        assert back.dtype == np.int32 and np.array_equal(
            back, jtm._unpack_motion(want, codes, ja.n_voxels, len(codes), 7))
        if bsl == 4:  # the searched field is block-constant at its own blocks
            assert np.array_equal(back[:ja.n_voxels], mv[:ja.n_voxels])
    s = FrameStream(depth=7, n_voxels=1, steps=np.ones(1), channels=[b""], inter=True,
                    motion=want)
    assert np.array_equal(ttm.signalled_global_motion(s), jtm.signalled_global_motion(s))
    assert ttm.signalled_global_motion(s).tolist() == [1, 0, 0]
    s.inter = False
    assert ttm.signalled_global_motion(s) is None


def _recorded_inputs(jcodec):
    """Wrap the JAX codec's ``encode`` to remember the frame each stream
    coded (the frame, or a P-frame's residual)."""
    seen = {}
    encode = jcodec.encode

    def rec(frame, steps, *a, **k):
        out = encode(frame, steps, *a, **k)
        seen[id(out.stream)] = frame
        return out

    jcodec.encode = rec
    return seen


def _symbols(stream, n):
    from raht3dgs_tpu_torch.models.pipeline import decode_entropy_channels

    out = np.zeros((stream.n_channels, n), dtype=np.int32)
    decode_entropy_channels(stream, n, out)
    return out


def _gate(jstreams, tstreams, jinputs, jcodec):
    """Item 6's gate: the streams are byte-identical, or their symbols
    differ only where the JAX coefficient / step is within TIE_TOL of a
    rounding tie (by one). Returns the number of such symbols."""
    n_tie = 0
    for s_j, s_t in zip(jstreams, tstreams):
        assert (s_t.inter, s_t.n_voxels) == (s_j.inter, s_j.n_voxels)
        if s_t.to_bytes() == s_j.to_bytes():
            continue
        assert not s_j.predict, "predicted streams must be byte-identical"
        n = s_j.n_voxels
        a, b = _symbols(s_j, n), _symbols(s_t, n)
        diff = a != b
        coeffs, order, _, _ = jcodec.transform(jinputs[id(s_j)])
        o = np.asarray(order)
        c = np.asarray(coeffs, np.float64)[o[o < n]].T / STEP + 0.5
        ties = np.abs(c - np.round(c)) <= TIE_TOL * np.maximum(1.0, np.abs(c))
        assert not (diff & ~ties).any(), "symbols differ away from a tie"
        assert np.abs(a - b)[diff].max() == 1
        n_tie += int(diff.sum())
    return n_tie


CONFIGS = {
    "v3": dict(gop=8),
    "v2": dict(gop=8, signal_motion=False),
    "fixed_gop3": dict(gop=3, adaptive=False),
    "adaptive_gop3": dict(gop=3),
    "gop1": dict(gop=1),
    "predict": dict(gop=8, adaptive=False, predict=True),
    "probes7_stride4": dict(gop=8, adaptive=False, probes=7, search_stride=4),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sequence_codec_matches_jax_f64(j7, name, capsys):
    """In lockstep (the port's prediction source set to the JAX encoder's
    reconstruction before each frame: XLA's fused multiply-adds leave the
    two reconstructions apart in the last bits, and the motion search may
    break a near-tie of witness errors differently on them) the streams
    pass item 6's gate; free-running, each package decodes the other's
    sequence within F64_TOL and the port's decode is its encoder's
    reconstruction, bit for bit."""
    kw = CONFIGS[name]
    jf, tf = j7
    jsc = jtm.SequenceCodec(7, **kw)
    jinputs = _recorded_inputs(jsc.codec)
    tsc = ttm.SequenceCodec(7, device="cpu", **kw)
    js, jr, ts = [], [], []
    for a, b in zip(jf, tf):
        if jsc._prev is not None:
            tsc._prev = (tsc._prev[0], torch.as_tensor(np.array(jsc._prev[1])))
        s, r = jsc.encode_frame(a, STEP)
        js.append(s)
        jr.append(r)
        ts.append(tsc.encode_frame(b, STEP)[0])
    kinds = [s.inter for s in ts]
    assert kinds[0] is False
    if kw["gop"] > 1:
        assert any(kinds)
    n_tie = _gate(js, ts, jinputs, jsc.codec)
    with capsys.disabled():
        print(f"\n{name}: frames {['P' if k else 'I' for k in kinds]}, "
              f"symbols differing at a tie: {n_tie}")
    # free-running: the port's closed loop, and the cross-decodes
    ts, tr = ttm.SequenceCodec(7, device="cpu", **kw).encode_sequence(tf, STEP)
    dec = ttm.SequenceCodec(7, device="cpu", **kw).decode_sequence(
        [FrameStream.from_bytes(s.to_bytes()) for s in ts], tf)
    assert all(np.array_equal(a, b) and a.dtype == b.dtype for a, b in zip(tr, dec))
    td = ttm.SequenceCodec(7, device="cpu", **kw).decode_sequence(
        [FrameStream.from_bytes(s.to_bytes()) for s in js], tf)
    jd = jtm.SequenceCodec(7, **kw).decode_sequence(
        [JaxStream.from_bytes(s.to_bytes()) for s in ts], jf)
    for i in range(len(jf)):
        assert float(np.abs(td[i] - jr[i]).max()) <= F64_TOL, i
        assert float(np.abs(jd[i] - tr[i]).max()) <= F64_TOL, i
        ref = np.asarray(jf[i].attributes)[:jf[i].n_voxels]
        assert float(np.sqrt(np.mean((tr[i] - ref) ** 2))) < STEP


def test_sequence_codec_f32_cross_decode(capsys):
    jf, tf = _frames(_sequence(7, n_frames=4), 7, jnp.float32)
    js, jr = jtm.SequenceCodec(7, gop=8, adaptive=False, dtype=jnp.float32
                               ).encode_sequence(jf, STEP)
    tsc = ttm.SequenceCodec(7, gop=8, adaptive=False, dtype=torch.float32, device="cpu")
    ts, tr = tsc.encode_sequence(tf, STEP)
    assert all(s.dtype32 for s in ts) and [s.inter for s in ts] == [False] + [True] * 3
    td = ttm.SequenceCodec(7, dtype=torch.float32, device="cpu").decode_sequence(
        [FrameStream.from_bytes(s.to_bytes()) for s in js], tf)
    jd = jtm.SequenceCodec(7, dtype=jnp.float32).decode_sequence(
        [JaxStream.from_bytes(s.to_bytes()) for s in ts], jf)
    errs = []
    for k in range(len(jf)):
        e = max(float(np.abs(td[k] - jr[k]).max()), float(np.abs(jd[k] - tr[k]).max()))
        errs.append(e)
        assert e <= F32_TOL * (k + 1), (k, e)
    with capsys.disabled():
        print(f"\nf32 cross-decode max abs error by frames since the I-frame: {errs}")
    dec = ttm.SequenceCodec(7, dtype=torch.float32, device="cpu").decode_sequence(ts, tf)
    assert all(np.array_equal(a, b) for a, b in zip(tr, dec))


@pytest.mark.parametrize("adaptive", [True, False])
def test_encode_frame_target_matches_jax(j7, adaptive):
    jf, tf = j7
    jsc = jtm.SequenceCodec(7, gop=4, adaptive=adaptive)
    tsc = ttm.SequenceCodec(7, gop=4, adaptive=adaptive, device="cpu")
    kinds = []
    for k in range(4):
        if jsc._prev is not None:  # lockstep, as in test_sequence_codec_matches_jax_f64
            tsc._prev = (tsc._prev[0], torch.as_tensor(np.array(jsc._prev[1])))
        sj, rj, stj = jsc.encode_frame_target(jf[k], 1.5)
        st, rt, stt = tsc.encode_frame_target(tf[k], 1.5)
        assert stt == stj and st.inter == sj.inter and st.to_bytes() == sj.to_bytes()
        assert float(np.abs(rt - rj).max()) <= F64_TOL
        assert st.bpp() <= 1.5
        kinds.append(st.inter)
    assert kinds[0] is False and (adaptive or all(kinds[1:]))


def test_guards_match_jax(j7):
    jf, tf = j7
    ts, _ = ttm.SequenceCodec(7, gop=8, device="cpu").encode_sequence(tf[:3], STEP)
    s = ts[1]
    assert s.inter and s.motion is not None
    js = JaxStream.from_bytes(s.to_bytes())

    def same_error(fn_t, fn_j, match):
        with pytest.raises(ValueError, match=match) as got:
            fn_t()
        with pytest.raises(ValueError) as want:
            fn_j()
        assert str(got.value) == str(want.value)

    # an inter frame with nothing decoded before it
    same_error(lambda: ttm.SequenceCodec(7, device="cpu").decode_frame(s, tf[1]),
               lambda: jtm.SequenceCodec(7).decode_frame(js, jf[1]), "preceding")
    # the transform dtype must be the encoder's
    t32 = ttm.SequenceCodec(7, dtype=torch.float32, device="cpu")
    t32._prev = (tf[0], t32._padded_recon(tf[0], np.zeros((tf[0].n_voxels, 3))))
    j32 = jtm.SequenceCodec(7, dtype=jnp.float32)
    j32._prev = (jf[0], j32._padded_recon(jf[0], np.zeros((jf[0].n_voxels, 3))))
    same_error(lambda: t32.decode_frame(s, tf[1]), lambda: j32.decode_frame(js, jf[1]),
               "precision")
    # a corrupt motion section: cut, or applied to another frame's positions
    for motion, k, match in ((s.motion[:4], 1, "header cut off"), (s.motion, 0, "blocks")):
        same_error(
            lambda: ttm._unpack_motion(motion, tf[k].codes.numpy(), tf[k].n_voxels,
                                       BUCKET, 7),
            lambda: jtm._unpack_motion(motion, np.asarray(jf[k].codes), jf[k].n_voxels,
                                       BUCKET, 7), match)
    for bad, match in ((dict(gop=0), "gop"), (dict(probes=9), "probes"),
                       (dict(search_stride=0), "search_stride"),
                       (dict(search_iters=0), "search_iters")):
        with pytest.raises(ValueError, match=match):
            ttm.SequenceCodec(7, device="cpu", **bad)


def _exact_fma(a, b, c):
    from fractions import Fraction

    return float(Fraction(a) * Fraction(b) + Fraction(c))


def test_fma_rounds_once():
    """``_fma`` against exact rational arithmetic, rounded once: random
    operands over many scales, cancellations and products whose low half
    decides the rounding."""
    rng = np.random.default_rng(11)
    a = rng.standard_normal(3000) * 10.0 ** rng.integers(-6, 6, 3000)
    b = rng.standard_normal(3000) * 10.0 ** rng.integers(-6, 6, 3000)
    c = rng.standard_normal(3000) * 10.0 ** rng.integers(-8, 8, 3000)
    c[:500] = -(a[:500] * b[:500])          # the product's rounding error alone
    one = 1.0 + 2.0 ** -27
    a = np.concatenate([a, [one, one, 0.0, 3.0, -one]])
    b = np.concatenate([b, [one, one, 5.0, 0.0, one]])
    c = np.concatenate([c, [-1.0, 2.0 ** 53, 1.5, -2.0, 1.0]])
    got = tt._fma(*(torch.as_tensor(x) for x in (a, b, c))).numpy()
    want = np.array([_exact_fma(x, y, z) for x, y, z in zip(a, b, c)])
    assert np.array_equal(got, want)


def test_witness_tie_broken_as_jax_breaks_it():
    """Two witnesses whose squared errors tie in exact arithmetic (the
    same channel offsets, permuted) but not in float64: the plain
    channel-order sum and XLA's fused multiply-add chain rank them apart,
    and the port's witness is the JAX package's."""
    import jax

    rng = np.random.default_rng(5)
    for _ in range(20000):
        at = np.round(rng.uniform(0, 255, 3), 3)
        off = rng.uniform(-30, 30, 3)
        pa, pb = at + off, at + off[[2, 1, 0]]
        da, db = pa - at, pb - at
        plain = [(d[0] * d[0] + d[1] * d[1]) + d[2] * d[2] for d in (da, db)]
        fused = [_exact_fma(d[2], d[2], _exact_fma(d[1], d[1], d[0] * d[0]))
                 for d in (da, db)]
        if (plain[0] <= plain[1]) != (fused[0] <= fused[1]):
            break
    else:
        pytest.fail("no discriminating pair found")
    depth = 4
    prev_V = torch.tensor([[5, 5, 5], [4, 5, 5], [6, 5, 5]])
    prev_codes, order = torch.sort(morton_encode(prev_V, depth))
    attrs_prev = torch.as_tensor(np.stack([at + 99.0, pa, pb]))[order]
    P = torch.tensor([[5, 5, 5]])
    args = (P, torch.as_tensor(at[None, :]), torch.ones(1, dtype=torch.bool),
            torch.zeros_like(P), prev_codes, attrs_prev, torch.ones(3, dtype=torch.bool),
            (1 << depth) - 1, depth, "search")
    woff, valid = tt._witness_offsets(*args)
    jw = jax.jit(jt._witness_offsets, static_argnames=("lim", "depth", "join"))
    jwoff, jvalid = jw(*(jnp.asarray(a.numpy()) for a in args[:7]), lim=args[7],
                       depth=depth, join="search")
    assert bool(valid[0]) and bool(np.asarray(jvalid)[0])
    assert woff[0].tolist() == np.asarray(jwoff)[0].tolist()
    # the winner is (4,5,5), offset (-1,0,0), exactly where the fused errors rank it
    assert (woff[0].tolist() == [-1.0, 0.0, 0.0]) == (fused[0] <= fused[1])
