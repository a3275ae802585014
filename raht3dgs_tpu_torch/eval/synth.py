"""Synthetic evaluation workloads with realistic attribute statistics.

Counterpart of ``raht3dgs_tpu/eval/synth.py``: every generator returns the
JAX package's arrays for the same seed (the same rng call order).
White-noise attributes make RAHT spectra flat, so every moderate step
lands in the all-zeros regime; real scans and trained 3DGS scenes have
spatially smooth fields. These generators build band-limited (1/f^beta)
random fields over the voxel cube at the reference's attribute scales
(unit quats, linear scales ~ exp(log-space), sigmoid opacity, SH ~ N(0,
0.3)), temporally coherent shells, and articulated body scans.
"""

from __future__ import annotations

import numpy as np
import torch

from raht3dgs_tpu_torch.ops.morton import morton_codes_np, morton_decode


def _unique_morton_voxels(rng, n, depth):
    pts = rng.integers(0, 2**depth, size=(2 * n, 3))
    codes = np.unique(morton_codes_np(pts, depth))[:n]
    # the decode of host codes, on the host: a generator, not a device path
    return morton_decode(torch.from_numpy(codes), depth).numpy().astype(np.float64)


def smooth_field_fn(rng, V, depth):
    """Returns ``field(d, octaves=7, waves=4, beta=1.0)`` sampling fractal
    (1/f^beta) random fields at the voxel positions ``V``, unit variance
    per column. The multi-octave spectrum makes RAHT coefficient
    magnitudes decay gradually, so a quantization sweep removes a
    different shell of coefficients at every step — a realistic RD spread
    instead of white noise's all-zeros cliff."""
    n = len(V)

    def smooth_field(d, octaves=7, waves=4, beta=1.0):
        out = np.zeros((n, d))
        for o in range(octaves):
            f = rng.uniform(0.5, 1.0, size=(3, waves)) * (2.0**o)
            f *= rng.choice([-1, 1], size=(3, waves)) / (2**depth)
            phase = rng.uniform(0, 2 * np.pi, size=waves)
            basis = np.cos(2 * np.pi * (V @ f) + phase)        # (n, waves)
            mix = rng.normal(size=(waves, d)) * 2.0 ** (-beta * o)
            out += basis @ mix
        return out / out.std(axis=0, keepdims=True)

    return smooth_field


def synthetic_gs_frame(n=20000, depth=10, seed=0):
    """Morton-ordered voxelized 3DGS frame: (V int positions (n,3),
    attrs (n,56) = [quats(4), scales(3), opacity(1), SH(48)]).

    EXACT rng call order matters: ``scripts/rd_parity_3dgs.py`` pins its
    published parity table to this generator."""
    rng = np.random.default_rng(seed)
    V = _unique_morton_voxels(rng, n, depth)
    n = len(V)
    smooth_field = smooth_field_fn(rng, V, depth)

    quats = smooth_field(4) + 0.05 * rng.normal(size=(n, 4))
    quats[:, 0] += 2.0  # bias toward identity, as trained scenes are
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    scales = np.exp(np.log(0.01) + 0.5 * smooth_field(3)
                    + 0.05 * rng.normal(size=(n, 3)))
    opacity = 1.0 / (1.0 + np.exp(-(1.0 + smooth_field(1))))
    sh_dc = 0.5 + 0.3 * smooth_field(3) + 0.03 * rng.normal(size=(n, 3))
    sh_rest = 0.15 * smooth_field(45) + 0.02 * rng.normal(size=(n, 45))
    attrs = np.concatenate([quats, scales, opacity, sh_dc, sh_rest], axis=1)
    return V, attrs


def synthetic_color_sequence(depth=7, seed=0, n_frames=8, samples=150_000,
                             motion=1.2, drift=0.08, texture=14.0,
                             noise=1.0):
    """Temporally coherent dynamic sequence: list of (positions_t,
    colors_t).

    Real dynamic scans (8iVFBv2 bodies) are DENSE 2D surfaces moving
    through the grid — voxel occupancy is contiguous on the manifold, and
    frame-to-frame correspondence lives within a couple of voxels. This
    generator voxelizes a deforming, translating sphere shell: frame t
    moves the center by ``motion`` voxels and phase-shifts a smooth
    angular radius/color field by ``drift``. Crucially, each surface
    point also carries PERSISTENT high-frequency ``texture`` (drawn once,
    riding the moving point across frames — skin/cloth detail): spatially
    expensive for an intra coder every frame, but temporally stable, so
    an inter codec must exploit it. ``noise`` is fresh per frame (sensor
    noise — irreducible for both modes).
    """
    rng = np.random.default_rng(seed)
    lim = 2**depth - 1
    c0 = np.full(3, (lim + 1) / 2.0)
    r0 = (lim + 1) * 0.3
    direction = rng.normal(size=3)
    direction /= np.linalg.norm(direction)
    # fixed random angular harmonics for the radius and color fields
    ak = rng.normal(scale=0.06, size=(6, 3))   # radius deformation
    ck = rng.normal(scale=0.5, size=(8, 3, 3))  # color field (3 channels)
    phases = rng.uniform(0, 2 * np.pi, size=(8, 3))
    u = rng.normal(size=(samples, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)  # shared direction set
    # persistent texture: a high-frequency angular field (wavelength a few
    # voxels at this depth) — spatially expensive, temporally stable
    kt = 12
    tdirs = rng.normal(size=(kt, 3))
    tdirs /= np.linalg.norm(tdirs, axis=1, keepdims=True)
    tfreq = 2 * np.pi * r0 / rng.uniform(3.0, 8.0, size=kt)
    tphase = rng.uniform(0, 2 * np.pi, size=(kt, 3))
    tmix = rng.normal(size=(kt, 3))
    tex_all = sum(
        np.cos(tfreq[k] * (u @ tdirs[k])[:, None] + tphase[k][None, :])
        * tmix[k]
        for k in range(kt)
    ) / np.sqrt(kt)

    frames = []
    for t in range(n_frames):
        center = c0 + direction * motion * t
        # smoothly deforming radius: low-order harmonics of the direction
        r = r0 * (1.0 + sum(
            ak[k] @ (u**(k % 3 + 1)).T * np.cos(0.3 * t * (k + 1) / 6)
            for k in range(6)
        ) / 6.0)
        P = center + u * r[:, None]
        Vt = np.clip(np.round(P), 0, lim).astype(np.int64)
        keys = (Vt[:, 0] * (lim + 1) + Vt[:, 1]) * (lim + 1) + Vt[:, 2]
        _, first = np.unique(keys, return_index=True)
        kept = np.sort(first)
        Vt = Vt[kept]
        uk = u[kept]
        # smooth angular color field, phase-drifting over time
        rgb = 128.0 + 36.0 * sum(
            np.cos(uk @ ck[k].T * (k % 4 + 1)
                   + phases[k][None, :] + drift * t)
            for k in range(8)
        ) / np.sqrt(8)
        rgb += texture * tex_all[kept]
        rgb += noise * rng.normal(size=rgb.shape)
        frames.append((Vt, np.clip(rgb, 0.0, 255.0)))
    return frames


def synthetic_color_frame(n=20000, depth=10, seed=0):
    """Morton-ordered voxel cloud with smooth [0, 255] RGB colors —
    the encode_ply workload shape."""
    rng = np.random.default_rng(seed)
    V = _unique_morton_voxels(rng, n, depth)
    smooth_field = smooth_field_fn(rng, V, depth)
    rgb = 128.0 + 48.0 * smooth_field(3) + 4.0 * rng.normal(
        size=(len(V), 3)
    )
    return V, np.clip(rgb, 0.0, 255.0)


# -- articulated body scans (8iVFBv2-like statistics) -------------------------
#
# The shell generators above are good RD workloads but their occupancy
# statistics are NOT scan-like: the harmonic radius field plus per-frame
# noise makes deep-level occupancy nearly random, which is exactly the
# regime where neighbor contexts cannot help a geometry coder. Real scans
# (8iVFBv2 human bodies, vox10, ~0.7-1M voxels) are piecewise-smooth 2D
# manifolds — locally planar at voxel scale, with curvature concentrated
# at limbs and folds — and that local structure is what G-PCC-style
# occupancy contexts exploit. This generator builds an articulated
# humanoid from tapered capsules with low-frequency cloth-fold
# displacement and (optionally) sub-voxel scan noise, producing voxel
# shells whose level-occupancy statistics are scan-like. Used by
# scripts/exp_geom_contexts.py to (re)judge geometry context models and
# by the temporal measurement scripts for realistic motion.


_BODY_PARTS = (
    # name, p0 (m), p1 (m), r0, r1, color group, swing group
    ("torso", (0.0, 0.0, 0.95), (0.0, 0.0, 1.45), 0.16, 0.18, "shirt", None),
    ("pelvis", (0.0, 0.0, 0.88), (0.0, 0.0, 1.00), 0.15, 0.16, "pants", None),
    ("head", (0.0, 0.0, 1.56), (0.0, 0.0, 1.66), 0.105, 0.105, "skin", None),
    ("neck", (0.0, 0.0, 1.44), (0.0, 0.0, 1.54), 0.055, 0.06, "skin", None),
    ("uarm_l", (0.21, 0.0, 1.40), (0.30, 0.0, 1.14), 0.052, 0.045, "shirt",
     ("shoulder_l", +1)),
    ("uarm_r", (-0.21, 0.0, 1.40), (-0.30, 0.0, 1.14), 0.052, 0.045, "shirt",
     ("shoulder_r", -1)),
    ("farm_l", (0.30, 0.0, 1.14), (0.35, 0.0, 0.86), 0.042, 0.035, "skin",
     ("shoulder_l", +1)),
    ("farm_r", (-0.30, 0.0, 1.14), (-0.35, 0.0, 0.86), 0.042, 0.035, "skin",
     ("shoulder_r", -1)),
    ("hand_l", (0.35, 0.0, 0.86), (0.37, 0.0, 0.76), 0.04, 0.025, "skin",
     ("shoulder_l", +1)),
    ("hand_r", (-0.35, 0.0, 0.86), (-0.37, 0.0, 0.76), 0.04, 0.025, "skin",
     ("shoulder_r", -1)),
    ("thigh_l", (0.095, 0.0, 0.90), (0.105, 0.0, 0.50), 0.085, 0.06, "pants",
     ("hip_l", -1)),
    ("thigh_r", (-0.095, 0.0, 0.90), (-0.105, 0.0, 0.50), 0.085, 0.06,
     "pants", ("hip_r", +1)),
    ("shin_l", (0.105, 0.0, 0.50), (0.105, 0.0, 0.10), 0.055, 0.04, "pants",
     ("hip_l", -1)),
    ("shin_r", (-0.105, 0.0, 0.50), (-0.105, 0.0, 0.10), 0.055, 0.04,
     "pants", ("hip_r", +1)),
    ("foot_l", (0.105, 0.02, 0.06), (0.105, 0.16, 0.05), 0.045, 0.035,
     "shoes", ("hip_l", -1)),
    ("foot_r", (-0.105, 0.02, 0.06), (-0.105, 0.16, 0.05), 0.045, 0.035,
     "shoes", ("hip_r", +1)),
)

_BODY_COLORS = {  # base RGB per group, 0..255
    "skin": (208.0, 156.0, 128.0),
    "shirt": (156.0, 48.0, 52.0),
    "pants": (52.0, 60.0, 96.0),
    "shoes": (40.0, 36.0, 34.0),
}

_BODY_PIVOTS = {  # rotation pivots for the swing groups (meters)
    "shoulder_l": (0.21, 0.0, 1.40),
    "shoulder_r": (-0.21, 0.0, 1.40),
    "hip_l": (0.095, 0.0, 0.90),
    "hip_r": (-0.095, 0.0, 0.90),
}


def _sample_capsule(rng, p0, p1, r0, r1, n):
    """~n area-weighted surface samples of a tapered capsule.

    Returns (points (m,3), normals (m,3), local uv (m,2)): uv = (axial
    fraction, angle) parameterizes the surface for persistent
    displacement/texture fields that ride the part under articulation."""
    p0 = np.asarray(p0, dtype=np.float64)
    p1 = np.asarray(p1, dtype=np.float64)
    axis = p1 - p0
    length = np.linalg.norm(axis)
    az = axis / length if length > 0 else np.array([0.0, 0.0, 1.0])
    # orthonormal frame
    ref = np.array([1.0, 0.0, 0.0]) if abs(az[0]) < 0.9 else np.array(
        [0.0, 1.0, 0.0])
    ax = np.cross(az, ref)
    ax /= np.linalg.norm(ax)
    ay = np.cross(az, ax)
    slant = np.hypot(length, r1 - r0)
    a_side = np.pi * (r0 + r1) * slant
    a_cap0 = 2 * np.pi * r0 * r0
    a_cap1 = 2 * np.pi * r1 * r1
    a_tot = a_side + a_cap0 + a_cap1
    n_side = int(round(n * a_side / a_tot))
    n_c0 = int(round(n * a_cap0 / a_tot))
    n_c1 = max(0, n - n_side - n_c0)

    pts, nrm, uv = [], [], []
    if n_side:
        t = rng.random(n_side)
        phi = rng.uniform(0, 2 * np.pi, n_side)
        r = r0 + (r1 - r0) * t
        radial = (np.cos(phi)[:, None] * ax[None, :]
                  + np.sin(phi)[:, None] * ay[None, :])
        pts.append(p0 + t[:, None] * axis[None, :] + r[:, None] * radial)
        nrm.append(radial)  # taper tilt is negligible for these ratios
        uv.append(np.stack([t, phi], axis=1))
    for (nc, rc, pc, sgn, t0) in ((n_c0, r0, p0, -1.0, 0.0),
                                  (n_c1, r1, p1, +1.0, 1.0)):
        if not nc:
            continue
        d = rng.normal(size=(nc, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        # flip into the outward hemisphere
        flip = np.sign(d @ az) != sgn
        d[flip] -= 2 * (d[flip] @ az)[:, None] * az[None, :]
        pts.append(pc + rc * d)
        nrm.append(d)
        uv.append(np.stack([np.full(nc, t0 + sgn * 0.2),
                            np.arctan2(d @ ay, d @ ax)], axis=1))
    return np.concatenate(pts), np.concatenate(nrm), np.concatenate(uv)


def _rot_x(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float64)


def synthetic_body_scan(depth=10, seed=0, n_frames=1, samples_per_voxel=5.0,
                        noise_vox=0.25, fold_amp=0.012, swing=0.45,
                        motion_vox=1.5, height=1.85, phase_rate=0.9,
                        texture_fine=8.0):
    """Articulated humanoid scans: list of ``n_frames`` (V int (N,3),
    rgb (N,3) in [0,255]) voxelized at ``depth``.

    Surface = tapered capsules (torso/head/arms/legs/feet) + persistent
    low-frequency cloth-fold displacement (``fold_amp`` meters, riding the
    part) + fresh per-frame scan noise of ``noise_vox`` voxels.
    ``phase_rate`` scales articulation speed: the default 0.9 rad/frame of
    walk phase is FAST motion (~20 deg/frame at the shoulder — a stress
    case; limbs displace tens of voxels per frame at J=10); 30fps captures
    of normal motion are nearer 0.1-0.2 (the temporal codecs' adaptive
    intra fallback engages on the fast default, by design). Colors =
    per-part base + lambertian shading + persistent high-frequency texture
    + fresh sensor noise. Frames articulate: arms/legs counter-swing
    (walk-like, ``swing`` radians peak) and the body translates
    ``motion_vox`` voxels/frame — temporal correspondence is rigid per
    part, like real capture of a walking subject.

    At depth=10 this yields ~0.5M voxels (8iVFBv2 scans: 0.7-1M), locally
    planar at voxel scale — REAL-scan-like occupancy statistics, which the
    shell generators above do not have (their deep-level occupancy is
    noise-dominated). See scripts/exp_geom_contexts.py.
    """
    rng = np.random.default_rng(seed)
    rng_tex = np.random.default_rng(seed + 77003)
    vox = height / (1 << depth)
    # area-proportional sample counts per part
    parts = []
    for (name, p0, p1, r0, r1, grp, sw) in _BODY_PARTS:
        length = np.linalg.norm(np.subtract(p1, p0))
        slant = np.hypot(length, r1 - r0)
        area = np.pi * (r0 + r1) * slant + 2 * np.pi * (r0**2 + r1**2)
        n = int(samples_per_voxel * area / (vox * vox))
        pts, nrm, uvs = _sample_capsule(rng, p0, p1, r0, r1, n)
        # persistent fold displacement + texture: fixed random harmonics
        # over the part-local uv chart (they ride the articulation)
        kf = rng.normal(size=(6, 2)) * np.array([5.0, 3.0])
        ph = rng.uniform(0, 2 * np.pi, 6)
        amp = rng.normal(size=6)
        fold = fold_amp * sum(
            amp[k] * np.cos(uvs @ kf[k] + ph[k]) for k in range(6)
        ) / np.sqrt(6)
        if grp in ("shirt", "pants"):
            pts = pts + fold[:, None] * nrm
        kt = rng.normal(size=(8, 2)) * np.array([40.0, 24.0])
        pht = rng.uniform(0, 2 * np.pi, 8)
        ampt = rng.normal(size=(8, 3)) * 10.0
        tex = sum(np.cos(uvs @ kt[k] + pht[k])[:, None] * ampt[k]
                  for k in range(8)) / np.sqrt(8)
        # fine persistent detail (fabric weave / skin pores): wavelength a
        # few voxels at J=9-10 — the component that makes real captures
        # expensive for an intra coder every frame but nearly free for a
        # temporal predictor (it rides the surface point). Drawn from a
        # SEPARATE rng stream so the main stream's call order (which pins
        # the published geometry/occupancy tables — positions must not
        # move) is untouched.
        ktf = rng_tex.normal(size=(8, 2)) * np.array([420.0, 260.0])
        phtf = rng_tex.uniform(0, 2 * np.pi, 8)
        amptf = rng_tex.normal(size=(8, 3)) * (
            texture_fine if grp in ("shirt", "pants")
            else 0.6 * texture_fine)
        tex = tex + sum(
            np.cos(uvs @ ktf[k] + phtf[k])[:, None] * amptf[k]
            for k in range(8)
        ) / np.sqrt(8)
        parts.append((name, grp, sw, pts, nrm, tex))

    light = np.array([0.5, -0.7, 0.6])
    light /= np.linalg.norm(light)
    walk_dir = np.array([0.0, 1.0, 0.0])
    frames = []
    lim = (1 << depth) - 1
    # center the body in the grid (xy), feet near z=0; leave walking room
    base_off = np.array([0.5 * (lim + 1) * vox,
                         0.25 * (lim + 1) * vox, 0.02])
    for t in range(n_frames):
        phase = phase_rate * t
        all_pts, all_rgb = [], []
        for (name, grp, sw, pts, nrm, tex) in parts:
            P = pts
            N = nrm
            if sw is not None:
                pivot, sign = np.asarray(_BODY_PIVOTS[sw[0]]), sw[1]
                R = _rot_x(sign * swing * np.sin(phase))
                P = (P - pivot) @ R.T + pivot
                N = N @ R.T
            P = P + base_off + walk_dir * (motion_vox * vox * t)
            shade = 0.75 + 0.25 * np.clip(N @ light, -1, 1)
            rgb = (np.asarray(_BODY_COLORS[grp])[None, :] * shade[:, None]
                   + tex)
            all_pts.append(P)
            all_rgb.append(rgb)
        P = np.concatenate(all_pts)
        rgb = np.concatenate(all_rgb)
        if noise_vox:
            P = P + rng.normal(scale=noise_vox * vox, size=P.shape)
        Vt = np.clip(np.floor(P / vox), 0, lim).astype(np.int64)
        keys = (Vt[:, 0] * (lim + 1) + Vt[:, 1]) * (lim + 1) + Vt[:, 2]
        order = np.argsort(keys, kind="stable")
        keys = keys[order]
        starts = np.flatnonzero(np.concatenate([[True],
                                                keys[1:] != keys[:-1]]))
        counts = np.diff(np.append(starts, keys.size))
        rgb_mean = (np.add.reduceat(rgb[order], starts, axis=0)
                    / counts[:, None])
        rgb_mean += rng.normal(scale=1.0, size=rgb_mean.shape)
        frames.append((Vt[order][starts],
                       np.clip(rgb_mean, 0.0, 255.0)))
    return frames
