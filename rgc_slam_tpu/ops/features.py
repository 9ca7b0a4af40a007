"""Feature front-end: the JAX re-expression of the `scanRegistration` node.

Reference behavior rebuilt here (see SURVEY §2.1 A1-A4, §3.1):
  * A1 range gate + rear-cone cut      (scanRegistration.cpp:107-113,732-763)
  * A2 ring binning & relative time    (scanRegistration.cpp:115-231)
  * A3 curvature triple (xyz / range / intensity), incidence-angle smoothing,
    occlusion masking, per-ring 6-sector greedy pick with neighbor suppression
                                       (scanRegistration.cpp:233-306,433-663)
  * A4 ground marking + weighted PCA plane fit
                                       (scanRegistration.cpp:34-40,307-431)

Design: the whole scan is one flat padded tensor sorted ring-major (valid
points contiguous per ring).  Window ops are shifted-array sums (they vectorize);
the reference's *sequential* greedy pick becomes a fixed number of
argmax-and-suppress rounds that run all (ring × sector) segments in parallel —
identical per-sector semantics, only cross-sector suppression ordering differs.
Everything jits and vmaps (fleet config 5 of BASELINE.json).

The per-point windowed stack is factored as a row-block function
(`_pointwise_block`) so the sp-sharded variant (`extract_features_sp`) runs
the EXACT same math on a device's block — the reference's OpenMP point loops
(scanRegistration.cpp:233-306) re-expressed as block slicing over the sp mesh
axis.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import SlamConfig
from ..types import FeatureCloud, GroundPlane, PointCloud
from ..utils import pytree


@pytree.dataclass
class FeatureExtraction:
    """Output of the front-end for one scan."""

    full: PointCloud          # organized (ring-major) cloud
    sharp: FeatureCloud       # edge features (+ merged intensity corners)
    flat: FeatureCloud        # planar features
    inten: FeatureCloud       # intensity-edge features
    ground: GroundPlane
    ground_mask: jax.Array    # [N] bool on the organized cloud
    curvature: jax.Array      # [N] diagnostics
    normals_cov: jax.Array    # [N, 3, 3] per-point covariance (for VGICP)


# ---------------------------------------------------------------------------
# organization
# ---------------------------------------------------------------------------


def organize(cloud: PointCloud, cfg: SlamConfig) -> tuple[PointCloud, jax.Array, jax.Array]:
    """Sort points ring-major (ring asc, time asc, invalid last).

    Returns (organized cloud, ring_start [n_scans], ring_count [n_scans]).
    Replaces the per-ring push_back concatenation at scanRegistration.cpp:221-230.
    """
    n = cloud.capacity
    big = jnp.float32(1e9)
    key = jnp.where(
        cloud.mask,
        cloud.ring.astype(jnp.float32) * 10.0 + cloud.rel_time,
        big,
    )
    order = jnp.argsort(key)
    out = jax.tree.map(lambda a: a[order], cloud)
    ring_count = jax.ops.segment_sum(
        cloud.mask.astype(jnp.int32), jnp.where(cloud.mask, cloud.ring, cfg.n_scans),
        num_segments=cfg.n_scans + 1,
    )[: cfg.n_scans]
    ring_start = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(ring_count)[:-1]]
    )
    return out, ring_start, ring_count


def _shift(x: jax.Array, o: int) -> jax.Array:
    """x[i+o] with TRUE zero padding at the flat-array ends.

    The C++ window loops bound every neighbor access with 0 <= j < n
    (scanRegistration.cpp:333-348); a wrapping roll would instead read
    values from the opposite end of the flat array.  Within rings the
    boundary is handled by the interior/validity masks, but the flood
    window in the ground fit reads shifted seeds/ranges directly, so the pad
    must be zero (seed=False, gate=0 -> never a hit) to match the oracle's
    explicit bounds check for any ground_scan_rings configuration."""
    if o == 0:
        return x
    pad = [(0, 0)] * x.ndim
    if o > 0:
        pad[0] = (0, o)
        return jnp.pad(x, pad)[o:]
    pad[0] = (-o, 0)
    return jnp.pad(x, pad)[:o]


# ---------------------------------------------------------------------------
# the per-point windowed stack (block-sliceable)
# ---------------------------------------------------------------------------

# Dependency radius of the windowed stack (for block slicing): the deepest
# shift chain is iext ← igap_ok (±5) ← smoothed intensity (+1 gap read, ±5
# window) ← raw intensity / xyz (±5) ≈ 10-11 points; 12 adds margin.
_HALO = 12


def _strip(x: jax.Array, start, per: int, halo: int) -> jax.Array:
    """x[start-halo : start+per+halo] along axis 0 with TRUE zero padding
    outside [0, n) — `_shift`'s boundary convention, so a window op computed
    on the strip and trimmed by `halo` equals its full-array result exactly.
    `start` may be traced (sp block slicing); the strip length is static."""
    pad = [(halo, halo)] + [(0, 0)] * (x.ndim - 1)
    return jax.lax.dynamic_slice_in_dim(
        jnp.pad(x, pad), start, per + 2 * halo, axis=0
    )


def _pointwise_block(
    xyz_f: jax.Array,
    inten_f: jax.Array,
    ring_f: jax.Array,
    mask_f: jax.Array,
    pos_f: jax.Array,
    count_f: jax.Array,
    start,
    per: int,
    cfg: SlamConfig,
) -> dict:
    """The per-point windowed stack on rows [start, start+per): incidence
    smoothing + curvature triple (cpp:233-306), ground seed + flood
    (cpp:307-348), occlusion/parallel masks (cpp:433-456), and the
    gap-suppression extents (cpp:517-534).

    Inputs are the FULL organized arrays; the block computes on a ±_HALO
    strip so every window op sees its true neighbors, then trims to the
    owned rows.  start=0 / per=n IS the replicated path (extract_features);
    extract_features_sp calls it with the device's block and all-gathers.
    """
    dtype = xyz_f.dtype
    h = _HALO
    xyz = _strip(xyz_f, start, per, h)
    inten_raw = _strip(inten_f, start, per, h)
    ring = _strip(ring_f, start, per, h)
    mask = _strip(mask_f, start, per, h)
    pos_in_ring = _strip(pos_f, start, per, h)
    count_of_ring = _strip(count_f, start, per, h)
    L = xyz.shape[0]

    # the reference trims 5 points at both ring ends (scanStartInd/EndInd ±5)
    interior = mask & (pos_in_ring >= 5) & (pos_in_ring < count_of_ring - 5)
    r = jnp.linalg.norm(xyz, axis=-1)

    # ---- incidence angle for near points (scanRegistration.cpp:238-255) ----
    pa = _shift(xyz, 5)
    pb = _shift(xyz, -5)
    pc = 0.5 * (pa + pb)
    pnorm = jnp.cross(pa - pb, xyz - pc)
    denom = jnp.linalg.norm(pnorm, axis=-1) * jnp.maximum(r, 1e-6)
    scan_angle = jnp.abs(jnp.sum(pnorm * xyz, axis=-1) / jnp.maximum(denom, 1e-9))
    near = (r < 2.0) & interior
    scan_angle = jnp.where(near, scan_angle, 1.0)

    # ---- intensity smoothing at glancing incidence (cpp:256-268) ----
    glancing = (scan_angle < 0.07) & near
    neigh_sum = jnp.zeros_like(inten_raw)
    for o in range(-5, 6):
        if o != 0:
            neigh_sum = neigh_sum + _shift(inten_raw, o)
    inten = jnp.where(glancing, 0.9 * inten_raw + 0.005 * neigh_sum, inten_raw)

    # ---- curvature triple (cpp:269-306) ----
    def window_diff(x):
        s = -10.0 * x
        for o in range(-5, 6):
            if o != 0:
                s = s + _shift(x, o)
        return s

    diff_xyz = jnp.stack([window_diff(xyz[:, k]) for k in range(3)], axis=-1)
    diff_i = window_diff(inten)
    diff_r = window_diff(r)

    dis_factor = jnp.maximum(2.0 / (1.0 + r / 20.0), 0.2)
    curvature = jnp.sum(diff_xyz * diff_xyz, axis=-1) * dis_factor
    distance_source = 0.5 + dis_factor
    inten_curv = jnp.where(glancing, (scan_angle + 0.3) * diff_i, diff_i)
    other_source = jnp.where(glancing, scan_angle * 10.0 + 0.6, 3.0)
    curvature2 = jnp.abs(diff_r * dis_factor)

    curvature = jnp.where(interior, curvature, 0.0)
    curvature2 = jnp.where(interior, curvature2, 0.0)
    inten_curv = jnp.where(interior, inten_curv, 0.0)

    # ---- ground seed + neighbor flood (cpp:307-348) ----
    expected = jnp.asarray(cfg.expected_ground_ranges, dtype)
    gsi = cfg.ground_scan_rings
    in_ground_rings = (
        mask & (ring < gsi) & (pos_in_ring >= 5) & (pos_in_ring < count_of_ring - 5)
    )
    ring_c = jnp.clip(ring, 0, gsi)
    # `i / (groundScanInd-1)` in the C++ is INTEGER division (both ints,
    # scanRegistration.cpp:323-325): the gate and weight are step functions
    # of the ring, not linear ramps — 0.8/1.5 for rings 0..gsi-2, 1.6/0.5
    # for ring gsi-1
    ring_step = (ring // (gsi - 1)).astype(dtype)
    gate = cfg.ground_range_gate * (1.0 + ring_step)
    seed = (
        in_ground_rings
        & (jnp.abs(r - expected[ring_c]) < gate)
        & (xyz[:, 2] < cfg.ground_z_max)
    )
    # each seed i pushes the neighbors j = i+n, n in [-5, 4] that pass
    # |r[j] - r[i]| < gate_i/2 (the SEED's ring gate), across ring boundaries
    # in the flat array.  The C++ appends to nearGround once PER SEED, so a
    # point flooded by several seeds enters the moments and the
    # robustified-distance pass multiple times — reproduced as
    # multiplicity/weight accumulators.
    gw_all = 1.5 - ring_step                        # groundweight of a seed
    w = jnp.zeros((L,), dtype)       # total push weight per point
    mult = jnp.zeros((L,), dtype)    # push count per point
    for o in range(-4, 6):           # o = seed_index - point_index
        hit = _shift(seed, o) & (jnp.abs(r - _shift(r, o)) < _shift(gate, o) / 2.0) & mask
        w = w + jnp.where(hit, _shift(gw_all, o), 0.0)
        mult = mult + hit.astype(dtype)

    # ---- occlusion / steep-surface mask (cpp:433-456) ----
    r_next = _shift(r, 1)
    same_ring_next = (ring == _shift(ring, 1)) & mask & _shift(mask, 1)
    occl_fwd = (r - r_next > 0.04 * r_next) & same_ring_next   # current occluded soon
    occl_bwd = (r_next - r > 0.04 * r) & same_ring_next
    blocked = jnp.zeros((L,), bool)
    for o in range(0, 6):   # i-5..i marked when forward jump at i
        blocked = blocked | _shift(occl_fwd, o)
    for o in range(1, 7):   # i+1..i+6 marked when backward jump at i
        blocked = blocked | _shift(occl_bwd, -o)
    if cfg.parallel_surface_check:
        # A-LOAM beam-parallel surface suppression (restored; see config),
        # made resolution-aware: flag when both ring-neighbor gaps exceed 2x
        # the ring's nominal spacing r*dtheta, i.e. incidence shallower than
        # ~30 degrees (A-LOAM's absolute 2e-4 r^2 constant plays this role on
        # KITTI's fine 0.2-degree grid but over/under-flags on other grids)
        az_step = 2.0 * jnp.pi / jnp.maximum(count_of_ring.astype(dtype), 1.0)
        thresh = (2.0 * r * az_step) ** 2
        d_next = jnp.sum((_shift(xyz, 1) - xyz) ** 2, axis=-1)
        d_prev = jnp.sum((_shift(xyz, -1) - xyz) ** 2, axis=-1)
        parallel = (d_next > thresh) & (d_prev > thresh)
        blocked = blocked | (parallel & interior)

    # ---- neighbor-gap suppression extents (cpp:517-534) ----
    gap_next = jnp.sum((_shift(xyz, 1) - xyz) ** 2, axis=-1)
    gap_ok = (gap_next <= 0.05) & same_ring_next
    # ext_r[i]: how many of i+1.. are suppressed when i is picked (≤5)
    ext_r = jnp.zeros((L,), jnp.int32)
    run = jnp.ones((L,), bool)
    for l in range(1, 6):
        run = run & _shift(gap_ok, l - 1)
        ext_r = ext_r + run.astype(jnp.int32)
    ext_l = jnp.zeros((L,), jnp.int32)
    run = jnp.ones((L,), bool)
    for l in range(1, 6):
        run = run & _shift(gap_ok, -l)
        ext_l = ext_l + run.astype(jnp.int32)

    # ---- intensity-gap suppression extents (separate array, cpp:560-583) ----
    igap = jnp.abs(_shift(inten, 1) - inten)
    igap_ok = (igap <= 35.0) & same_ring_next
    iext_r = jnp.zeros((L,), jnp.int32)
    run = jnp.ones((L,), bool)
    for l in range(1, 6):
        run = run & _shift(igap_ok, l - 1)
        iext_r = iext_r + run.astype(jnp.int32)
    iext_l = jnp.zeros((L,), jnp.int32)
    run = jnp.ones((L,), bool)
    for l in range(1, 6):
        run = run & _shift(igap_ok, -l)
        iext_l = iext_l + run.astype(jnp.int32)

    out = dict(
        interior=interior,
        intensity=inten,
        curvature=curvature,
        curvature2=curvature2,
        inten_curv=inten_curv,
        distance_source=distance_source,
        other_source=other_source,
        blocked=blocked,
        ext_l=ext_l,
        ext_r=ext_r,
        iext_l=iext_l,
        iext_r=iext_r,
        ground_w=w,
        ground_mult=mult,
        ground_mask=mult > 0,
    )
    return {k: v[h : h + per] for k, v in out.items()}


def _point_covariances(
    org: PointCloud,
    pos_in_ring: jax.Array,
    count_of_ring: jax.Array,
    cfg: SlamConfig,
    row_start=0,
    row_count: "int | None" = None,
) -> jax.Array:
    """Per-point covariances for VGICP: "scan" = ring-window PCA (the
    kd-tree kNN analog, default) | "rbf" = Gaussian-kernel moments (G8,
    covariance_estimation_rbf.cu via GPU_RBF_KERNEL) — both feed the same
    regularizer set (cfg.cov_regularization).  Optional row block for sp
    slicing; the gather operands stay the FULL arrays."""
    if cfg.cov_estimation == "rbf":
        from .covariance import rbf_covariances

        return rbf_covariances(
            org.xyz, org.mask, cfg.rbf_kernel_width, cfg.rbf_kernel_max_dist,
            cfg.cov_regularization, row_start=row_start, row_count=row_count,
        )
    from .covariance import scan_covariances

    return scan_covariances(
        org.xyz, org.mask, org.ring, pos_in_ring, count_of_ring, cfg,
        row_start=row_start, row_count=row_count,
    )


# ---------------------------------------------------------------------------
# the main front-end
# ---------------------------------------------------------------------------


def _organize_preamble(cloud: PointCloud, cfg: SlamConfig):
    """A1 range gate + rear-cone cut, then A2 ring-major organization —
    shared by the replicated and sp-sharded front-ends so the two can never
    diverge on the preamble."""
    from ..utils.cloud import range_filter_mask

    mask0 = range_filter_mask(cloud.xyz, cloud.mask, cfg.minimum_range, cfg.maximum_range)
    org, ring_start, ring_count = organize(cloud.replace(mask=mask0), cfg)
    idx = jnp.arange(cloud.capacity)
    pos_in_ring = idx - ring_start[jnp.clip(org.ring, 0, cfg.n_scans - 1)]
    count_of_ring = ring_count[jnp.clip(org.ring, 0, cfg.n_scans - 1)]
    return org, ring_start, ring_count, pos_in_ring, count_of_ring


def extract_features(cloud: PointCloud, cfg: SlamConfig, debug: bool = False):
    """Feature front-end.  With debug=True (static) additionally returns the
    intermediate arrays the golden-oracle test compares against
    (utils/oracle.py replicates the reference's sequential picker on them)."""
    dtype = cloud.xyz.dtype
    n = cloud.capacity

    org, ring_start, ring_count, pos_in_ring, count_of_ring = _organize_preamble(
        cloud, cfg
    )

    # ---- A3/A4: the per-point windowed stack, full-span block ----
    pw = _pointwise_block(
        org.xyz, org.intensity, org.ring, org.mask, pos_in_ring, count_of_ring,
        0, n, cfg,
    )
    ground = _ground_solve(org.xyz, pw["ground_w"], pw["ground_mult"], cfg, dtype)
    covs = _point_covariances(org, pos_in_ring, count_of_ring, cfg)

    # ---- pickers + compaction ----
    sharp, flat, intenf, picks = _pick_and_pack(
        org, pos_in_ring, count_of_ring, pw, cfg, dtype
    )

    fx = FeatureExtraction(
        full=org,
        sharp=sharp,
        flat=flat,
        inten=intenf,
        ground=ground,
        ground_mask=pw["ground_mask"],
        curvature=pw["curvature"],
        normals_cov=covs,
    )
    if debug:
        dbg = {
            "xyz": org.xyz, "mask": org.mask, "interior": pw["interior"],
            "ring_start": ring_start, "ring_count": ring_count,
            "curvature": pw["curvature"], "curvature2": pw["curvature2"],
            "inten_curv": pw["inten_curv"], "intensity": pw["intensity"],
            "ground_mask": pw["ground_mask"], "blocked": pw["blocked"],
            "sharp_picked": picks[0], "flat_picked": picks[1],
            "inten_picked": picks[2],
            "distance_source": pw["distance_source"],
            "other_source": pw["other_source"],
            "rel_time": org.rel_time,
        }
        return fx, dbg
    return fx


def extract_features_sp(cloud: PointCloud, cfg: SlamConfig) -> FeatureExtraction:
    """Block-sharded feature front-end over the sp mesh axis.

    Meant for 128-beam-class caps (131,072 points), where the feature stage
    is real device compute worth slicing for single-stream latency (not
    measured on the H100 yet).  Engine sp convention (ops/registration.py,
    models/odometry.py:264-278): inputs are replicated, each device computes
    rows [i·per, (i+1)·per) of the windowed stack + covariances on a ±_HALO
    strip (the halo is sliced from the replicated arrays, so no ppermute is
    needed), the ground moments psum over cfg.psum_axis, and the per-point
    outputs all-gather so the cheap global stages (organize, picker,
    compaction) stay replicated.  The window ops see identical operands, so
    results match extract_features to compile-variant fp (separate strip
    compilations contract FMAs differently; feature masks match exactly in
    the equality test); the GroundPlane additionally psum-reassociates its
    moment sums.
    Requires the sp axis size == cfg.sp_shards and cfg.sp_shards to divide
    the cloud capacity (validated in SlamConfig for max_points and
    re-checked at trace time here — a mismatch would silently corrupt the
    gather).  Reference analog: the OpenMP
    parallel point loops over this same stage (scanRegistration.cpp:233-306).
    """
    axis = cfg.psum_axis
    if axis is None or cfg.sp_shards <= 1:
        raise ValueError("extract_features_sp needs an sp mesh (psum_axis + sp_shards)")
    dtype = cloud.xyz.dtype
    n = cloud.capacity
    # trace-time validation — a mismatch would SILENTLY corrupt the gather
    # (the edge devices' dynamic slices clamp onto the same block, so the
    # psum double-counts rows and zeroes others; both checks are static)
    if n % cfg.sp_shards:
        raise ValueError(
            f"cloud capacity {n} not divisible by sp_shards={cfg.sp_shards}"
        )
    axis_sz = jax.lax.axis_size(axis)
    if axis_sz != cfg.sp_shards:
        raise ValueError(
            f"sp mesh axis {axis!r} has size {axis_sz}, cfg.sp_shards={cfg.sp_shards}"
        )
    per = n // cfg.sp_shards
    start = jax.lax.axis_index(axis) * per

    org, ring_start, ring_count, pos_in_ring, count_of_ring = _organize_preamble(
        cloud, cfg
    )

    pw = _pointwise_block(
        org.xyz, org.intensity, org.ring, org.mask, pos_in_ring, count_of_ring,
        start, per, cfg,
    )
    ground = _ground_solve(
        jax.lax.dynamic_slice_in_dim(org.xyz, start, per, axis=0),
        pw["ground_w"], pw["ground_mult"], cfg, dtype, psum_axis=axis,
    )
    covs = _point_covariances(
        org, pos_in_ring, count_of_ring, cfg, row_start=start, row_count=per
    )

    def gather(x):
        """Reassemble the full per-point array from the device blocks.

        dynamic-update into a zero buffer + psum instead of all_gather: the
        sum is exact (exactly one contribution per row, and float x + 0 is
        exact) and — unlike all_gather, whose output stays typed as
        axis-varying — psum output is typed replicated, which the
        downstream picker's fori_loop carry and the caller's out_specs
        require (JAX vma checking)."""
        is_bool = x.dtype == jnp.bool_
        buf = jnp.zeros((n,) + x.shape[1:], jnp.int32 if is_bool else x.dtype)
        buf = jax.lax.dynamic_update_slice_in_dim(
            buf, x.astype(buf.dtype), start, axis=0
        )
        out = jax.lax.psum(buf, axis)
        return out.astype(jnp.bool_) if is_bool else out

    # gather only what the picker/output consume — intensity (debug-only)
    # and ground_w/ground_mult (already reduced into `ground`) would be
    # 3 extra [n]-sized all-reduces per scan on the latency-sensitive path
    needed = (
        "interior", "curvature", "curvature2", "inten_curv",
        "distance_source", "other_source", "blocked",
        "ext_l", "ext_r", "iext_l", "iext_r", "ground_mask",
    )
    pw = {k: gather(pw[k]) for k in needed}
    covs = gather(covs)

    sharp, flat, intenf, _ = _pick_and_pack(
        org, pos_in_ring, count_of_ring, pw, cfg, dtype
    )
    return FeatureExtraction(
        full=org,
        sharp=sharp,
        flat=flat,
        inten=intenf,
        ground=ground,
        ground_mask=pw["ground_mask"],
        curvature=pw["curvature"],
        normals_cov=covs,
    )


# ---------------------------------------------------------------------------
# pickers + compaction (replicated even under sp: global segment reductions
# over small arrays, far off the FLOP path)
# ---------------------------------------------------------------------------


def _pick_and_pack(
    org: PointCloud,
    pos_in_ring: jax.Array,
    count_of_ring: jax.Array,
    pw: dict,
    cfg: SlamConfig,
    dtype,
):
    """Sector segmentation, the three greedy picks, the degraded-geometry
    intensity merge, and fixed-size compaction (cpp:457-663)."""
    xyz = org.xyz
    interior = pw["interior"]

    # ---- sector segmentation ----
    # sector = floor(6 * (pos-5) / (count-10)) within the trimmed ring interior
    interior_len = jnp.maximum(count_of_ring - 10, 1)
    sector = jnp.clip(
        (cfg.n_sectors * (pos_in_ring - 5)) // interior_len, 0, cfg.n_sectors - 1
    )
    seg_id = jnp.where(
        interior & (count_of_ring >= 20),
        org.ring * cfg.n_sectors + sector,
        cfg.n_scans * cfg.n_sectors,
    ).astype(jnp.int32)
    n_segs = cfg.n_scans * cfg.n_sectors

    # ---- greedy pick: sharp ----
    sharp_elig = (
        interior
        & ~pw["blocked"]
        & ~pw["ground_mask"]
        & (pw["curvature"] > cfg.sharp_curv_thresh)
        & (pw["curvature2"] > cfg.sharp_curv2_thresh)
    )
    sharp_picked, picked_any = _greedy_pick(
        pw["curvature"], sharp_elig, seg_id, n_segs, cfg.max_sharp_per_sector,
        pw["ext_l"], pw["ext_r"], descending=True,
    )

    # ---- greedy pick: flat (shares the suppression state) ----
    flat_elig = (
        interior
        & ~pw["blocked"]
        & ~picked_any
        & (pw["curvature"] < cfg.flat_curv_thresh)
        & (pw["curvature2"] < cfg.flat_curv2_thresh)
    )
    flat_picked, _ = _greedy_pick(
        pw["curvature"], flat_elig, seg_id, n_segs, cfg.max_flat_per_sector,
        pw["ext_l"], pw["ext_r"], descending=False,
    )

    # ---- greedy pick: intensity corners (separate suppression array) ----
    inten_elig = (
        interior
        & ~pw["ground_mask"]
        & ~sharp_picked
        & (pw["inten_curv"] > cfg.inten_curv_thresh)
    )
    inten_picked, _ = _greedy_pick(
        pw["inten_curv"], inten_elig, seg_id, n_segs, cfg.max_inten_per_sector,
        pw["iext_l"], pw["iext_r"], descending=True,
    )

    # ---- degraded-geometry fallback (cpp:645-663): merge intensity corners
    # into the sharp set when sharp/flat ratio is low ----
    n_sharp = jnp.sum(sharp_picked)
    n_flat = jnp.maximum(jnp.sum(flat_picked), 1)
    merge = cfg.use_intensity & (
        n_sharp.astype(dtype) / n_flat.astype(dtype) < cfg.intensity_merge_ratio
    )
    sharp_out_mask = sharp_picked | (merge & inten_picked)
    sharp_conf = jnp.where(
        inten_picked & ~sharp_picked, pw["other_source"], pw["distance_source"] + 1.0
    )

    # ---- compact feature clouds ----
    sharp = _compact(xyz, org.rel_time, sharp_conf, sharp_out_mask, cfg.max_sharp_total)
    flat = _compact(xyz, org.rel_time, pw["distance_source"], flat_picked, cfg.max_flat_total)
    intenf = _compact(xyz, org.rel_time, pw["other_source"], inten_picked, cfg.max_inten_total)
    return sharp, flat, intenf, (sharp_picked, flat_picked, inten_picked)


def _greedy_pick(
    score: jax.Array,
    eligible: jax.Array,
    seg_id: jax.Array,
    n_segs: int,
    rounds: int,
    ext_l: jax.Array,
    ext_r: jax.Array,
    descending: bool,
):
    """Per-segment greedy pick with ±5 neighbor suppression.

    Each round, every segment picks its best eligible point in parallel, then
    suppresses that point's gap-connected neighbors (the reference's inner
    while loops, scanRegistration.cpp:487-583).  Returns (picked mask,
    picked-or-suppressed mask).
    """
    n = score.shape[0]
    idx = jnp.arange(n)
    s = score if descending else -score

    def body(_, carry):
        picked, suppressed = carry
        ok = eligible & ~picked & ~suppressed
        val = jnp.where(ok, s, -jnp.inf)
        seg_best = jax.ops.segment_max(val, seg_id, num_segments=n_segs + 1)
        best_here = ok & (val == seg_best[seg_id]) & jnp.isfinite(val)
        # break ties toward the lowest index: keep only segment-argmin index
        cand_idx = jnp.where(best_here, idx, n)
        seg_arg = jax.ops.segment_min(cand_idx, seg_id, num_segments=n_segs + 1)
        pick = best_here & (idx == seg_arg[seg_id])
        picked = picked | pick
        # suppression interval [i - ext_l, i + ext_r] via difference array
        delta = jnp.zeros((n + 1,), jnp.int32)
        starts = jnp.where(pick, jnp.maximum(idx - ext_l, 0), n)
        ends = jnp.where(pick, jnp.minimum(idx + ext_r + 1, n), n)
        delta = delta.at[starts].add(jnp.where(pick, 1, 0))
        delta = delta.at[ends].add(jnp.where(pick, -1, 0))
        covered = jnp.cumsum(delta[:-1]) > 0
        suppressed = suppressed | covered
        return picked, suppressed

    picked = jnp.zeros((n,), bool)
    suppressed = jnp.zeros((n,), bool)
    picked, suppressed = jax.lax.fori_loop(0, rounds, body, (picked, suppressed))
    return picked, picked | suppressed


def _compact(xyz, rel_time, conf, mask, cap: int) -> FeatureCloud:
    """Gather masked points into a fixed-size FeatureCloud (valid-first)."""
    order = jnp.argsort(~mask, stable=True)[:cap]
    m = mask[order]
    return FeatureCloud(
        xyz=jnp.where(m[:, None], xyz[order], 0.0),
        rel_time=jnp.where(m, rel_time[order], 0.0),
        confidence=jnp.where(m, conf[order], 0.0),
        mask=m,
    )


# ---------------------------------------------------------------------------
# ground plane solve (cpp:349-431; the seed+flood lives in _pointwise_block)
# ---------------------------------------------------------------------------


def _ground_solve(xyz, w, mult, cfg: SlamConfig, dtype, psum_axis=None):
    """Weighted PCA plane + robustified distance over the flooded ground set.

    Row inputs may be one device's block: every moment sum is then
    psum-reduced over `psum_axis` (sp feature sharding) and the tiny 3x3
    eigendecomposition replicates on each device."""

    def _red(x):
        return jax.lax.psum(x, psum_axis) if psum_axis is not None else x

    wsum = jnp.maximum(_red(jnp.sum(w)), 1e-6)
    center = _red(jnp.sum(xyz * w[:, None], axis=0)) / wsum
    d = xyz - center
    cov = _red(jnp.einsum("n,ni,nj->ij", w, d, d)) / wsum
    evals, evecs = jnp.linalg.eigh(cov)  # ascending
    normal = evecs[:, 0]
    normal = jnp.where(jnp.dot(center, normal) < 0, -normal, normal)
    planarity_ok = evals[1] > cfg.ground_planarity_ratio * evals[0]

    # robustified distance (cpp:386-413), per-push multiplicity preserved
    d_unit = d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-9)
    dw = 1.0 - 100.0 * jnp.abs(d_unit @ normal)
    dw = jnp.where(dw < 0, 0.1, dw) * mult
    dwsum = jnp.maximum(_red(jnp.sum(dw)), 1e-6)
    distance = _red(jnp.sum(dw * (xyz @ normal))) / dwsum
    gsize = jnp.maximum(_red(jnp.sum(mult)), 1.0)
    source1 = dwsum / gsize

    h = cfg.lidar_height
    ratio = distance / h
    distance = jnp.where((ratio > 1.1) | (ratio < 0.9), h, distance)
    distance = jnp.where(source1 < 0.9, 0.9 * h + 0.1 * distance, distance)

    valid = (_red(jnp.sum(mult > 0)) > 0) & planarity_ok
    return GroundPlane(
        normal=normal.astype(dtype),
        v1=evecs[:, 1].astype(dtype),
        v2=evecs[:, 2].astype(dtype),
        distance=distance.astype(dtype),
        source=(1.0 - source1).astype(dtype),
        valid=valid,
    )
