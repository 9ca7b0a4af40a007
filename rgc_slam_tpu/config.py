"""Configuration for the JAX RGC-SLAM rebuild.

Mirrors the reference's ROS parameter-server configuration plus the hardcoded
physical constants surveyed in SURVEY.md §5.6 (``launch/run.launch:4-36``,
``scanRegistration.cpp:34-40``, ``utility.h:73-74,253-254``), restructured as a
static (hashable) dataclass so every field is a compile-time constant for jit.

Static shape capacities (MAX_*) replace the reference's dynamically sized PCL
containers — the price of XLA's static-shape compilation model, and the reason
the whole pipeline vmaps into a fleet (BASELINE config 5).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    # ---- sensor / projection (ref scanRegistration.cpp:34-40,57-72) ----
    n_scans: int = 16                     # 16 / 32 / 64 beam
    scan_period: float = 0.1              # seconds per sweep
    minimum_range: float = 0.5
    maximum_range: float = 80.0
    lidar_height: float = 0.56            # `laderH`, sensor height over ground

    # ---- static shape capacities ----
    max_points: int = 32768               # padded cloud size (per full scan)
    max_points_per_ring: int = 2048       # horizontal resolution budget
    max_imu: int = 64                     # IMU samples per scan interval

    # ---- feature extraction (ref scanRegistration.cpp:233-663) ----
    n_sectors: int = 6
    max_sharp_per_sector: int = 20
    max_flat_per_sector: int = 40
    max_inten_per_sector: int = 20
    sharp_curv_thresh: float = 0.1        # cloudCurvature > 0.1
    sharp_curv2_thresh: float = 0.3       # cloudCurvature2 > 0.3
    flat_curv_thresh: float = 0.3         # cloudCurvature < 0.3
    flat_curv2_thresh: float = 0.4        # cloudCurvature2 < 0.4
    inten_curv_thresh: float = 65.0       # intensityCurvature > 65
    use_intensity: bool = True
    intensity_merge_ratio: float = 0.3    # merge inten corners if sharp/plane < 0.3
    # A-LOAM's parallel-surface suppression (|Δp|^2 > 2e-4 r^2 on both ring
    # neighbors).  The reference dropped it (scanRegistration.cpp:432-456 has
    # only the occlusion branches), which lets viewpoint-dependent curvature
    # picks on grazing smooth walls drag the mapping solve in corridor-like
    # scenes; restored here as a default-on robustness improvement.
    parallel_surface_check: bool = True
    max_sharp_total: int = 2048           # compacted feature-cloud budgets
    max_flat_total: int = 4096
    max_inten_total: int = 2048

    # ---- ground segmentation (ref scanRegistration.cpp:34-40,307-431) ----
    ground_scan_rings: int = 7            # groundScanInd
    ground_z_max: float = 0.3
    ground_range_gate: float = 0.8        # base |r - expected| gate
    ground_planarity_ratio: float = 6.0   # lambda1 > 6*lambda0
    use_ground: bool = True

    # ---- odometry / VGICP (ref RGC_odometer.cpp:993-1009) ----
    vgicp_resolution: float = 1.0
    vgicp_max_iterations: int = 25
    vgicp_max_corr_dist: float = 2.0
    source_voxel_size: float = 0.2        # planeResolution1
    target_voxel_size: float = 0.3        # planeResolution2
    submap_window: int = 3                # `slipwide`
    max_source_points: int = 8192         # downsampled source budget
    max_voxels: int = 16384               # voxel hash capacity (power of 2)
    hash_probes: int = 16                  # open-addressing probe budget
    neighbor_search: int = 1              # DIRECT1 / 7 / 27 voxel offsets
    cov_knn_window: int = 10              # +/- window for scan-local covariances

    # ---- IMU (ref RGC_odometer.cpp:444-716, utility.h:245-269) ----
    use_imu: bool = True
    imu_rate_hint: float = 200.0
    # DeltaRFactor cov during fast rotation (|d_ypr| > 0.6 deg); the
    # slow-rotation branch uses 1 - vgicp fitness like the reference
    # (RGC_odometer.cpp:1106-1117), so no second constant exists
    imu_cov_fast: float = 0.0005
    gravity: float = 9.81
    # DeltaR(IMU) weight source: "reference" keeps the two hardcoded
    # constants above (RGC_odometer.cpp:1024-1119); "preint" uses the
    # θ-block of the propagated 15-dim preintegration covariance
    # (ops/imu.preintegrate_full) — principled, per-interval, bias-aware
    imu_cov_mode: str = "reference"
    # IMU noise densities for the covariance propagation (VINS conventions:
    # white noise σ/√Hz, bias random walk σ·√Hz)
    imu_acc_n: float = 0.08
    imu_gyr_n: float = 0.004
    imu_acc_w: float = 4e-5
    imu_gyr_w: float = 2e-6

    # ---- keyframes / mapping (ref RGC_mapping.cpp:133,215-245,1843-1862) ----
    keyframe_dist: float = 0.5            # keyframeAddingDistance
    keyframe_angle: float = 0.3           # keyframeAddingAngle (rad)
    surrounding_radius: float = 15.0      # surroundingKeyframeSearchRadius
    # keyframes gathered into the local map: the reference takes ALL within
    # the radius (RGC_mapping.cpp:1536-1548); 32 covers a 15 m ball at the
    # 0.5 m gate in revisit-heavy maps (r1 used 12, which truncated)
    surrounding_keyframes: int = 32
    max_keyframes: int = 512
    max_kf_corner: int = 512              # per-keyframe corner cloud budget
    max_kf_surf: int = 2048               # per-keyframe surf cloud budget
    max_map_points: int = 32768           # assembled local map budget
    map_corner_voxel: float = 0.2         # lineResolution
    map_surf_voxel: float = 0.4           # planeResolution
    map_opt_iterations: int = 2           # outer relinearization count
    map_knn: int = 5                      # 5-NN line/plane fits
    # eigenvalue floor for degeneracy-aware solution remapping in the mapping
    # solve (0 disables, the default); opt-in guard for prior-map localization
    # in feature-starved environments — combined with parallel-surface
    # suppression it can freeze legitimate corrections in low-feature SLAM, so
    # it is not enabled globally
    degeneracy_thresh: float = 0.0

    # ---- mode (ref run.launch:30, RGC_mapping.cpp:238): True = build the map,
    # False = localization in a prior map (keyframe store frozen, no loops) ----
    map_update: bool = True

    # ---- initial pose (ref run.launch:33-36, RGC_odometer.cpp:865-870) ----
    init_x: float = 0.0
    init_y: float = 0.0
    init_z: float = 0.0
    init_yaw: float = 0.0                 # radians (ref takes degrees)

    # ---- mapping cadence (ref run.launch:8-9 mapping_skip_frame) ----
    mapping_skip_frame: int = 1

    # ---- loop closure / PGO (ref RGC_mapping.cpp:154-160,2006-2466) ----
    loop_closure_enable: bool = True
    # scans between loop-closure/PGO dispatches — the reference's 1 Hz
    # pose-graph thread at 10 Hz scans (RGC_mapping.cpp:1964).  One field
    # shared by SlamSystem, the fleet CLI, and eval.py so evaluation runs
    # the cadence users get
    loop_cadence: int = 10
    # no-loop keyframe eviction inside mapping_step.  Disable for vmapped
    # fleets: a batched lax.cond executes BOTH branches, so the inline
    # compaction's store-permutation gathers would run every scan for every
    # robot — use parallel/fleet.compact_fleet on a host cadence instead
    inline_compaction: bool = True
    loop_search_radius: float = 15.0
    loop_travel_gate: float = 20.0        # travel-distance difference gate
    loop_submap_halfwidth: int = 50       # +/- keyframes in loop submap (ref ±50, RGC_mapping.cpp:157,2195)
    loop_icp_iterations: int = 30
    loop_fitness_thresh: float = 0.1
    # loop-submap downsample resolution.  The point-to-point fitness floor
    # is the squared NN spacing of the submap, so this voxel directly sets
    # what fitness an accepted loop can reach; 0 -> use map_surf_voxel
    # (reference behavior: one ICP filter resolution, RGC_mapping.cpp:150)
    loop_submap_voxel: float = 0.0
    # "point": pcl::IterativeClosestPoint parity (point-to-point + Kabsch);
    # "gicp": distribution-to-distribution alignment (ops/gicp) — tighter
    # basin from large drift, costs kNN covariance estimation per attempt
    # "plane": point-to-plane (target normals from kNN covariances) — wider
    # basin than point-to-point at ~half the gicp cost
    loop_icp_method: str = "point"
    max_loops: int = 64
    pgo_iterations: int = 10
    pgo_cg_iters: int = 128               # CG steps per GN iteration
    max_loop_submap_points: int = 16384

    # ---- solver ----
    opt_dtype: str = "float32"
    rotation_epsilon: float = 2e-3        # LsqRegistration convergence
    translation_epsilon: float = 5e-4
    lm_init_lambda_factor: float = 1e-9
    lm_max_inner: int = 10

    # ---- GNSS (off by default, as in reference run.launch) ----
    use_gnss: bool = False

    # ---- multi-chip sharding ----
    # When set, the registration hot loop runs point-sharded over this mesh
    # axis: each device linearizes its slice of the source cloud and the
    # 6x6 H / b / cost are psum-reduced over the device interconnect (scaling-book style "sp"
    # axis; composes with a "dp" fleet axis over robots — parallel/fleet.py).
    psum_axis: "str | None" = None
    # Static shard count of the psum_axis (the mesh's sp extent).  With
    # sp_shards > 1 the sharded stages take a BLOCK SLICE of their query
    # points (static size n/sp_shards — a real FLOP/memory reduction per
    # device), instead of only masking a stride; the odometry VGICP and the
    # mapping kNN association + 12-dim GN both shard this way (VERDICT r2
    # item 4).  Must divide the point capacities; 1 = mask-only sharding.
    sp_shards: int = 1
    # Shard the feature front-end's per-point work over the sp axis too
    # (ops/features.extract_features_sp): each device computes
    # max_points/sp_shards rows of the windowed stack + covariances on a
    # ±halo strip and the results all-gather.  OFF by default; meant for
    # dense single-stream deployments (131k-point caps).  Its gain on real
    # devices is not measured yet.
    sp_features: bool = False
    # per-point covariance regularization — the full fast_gicp
    # RegularizationMethod set (gicp_settings.hpp,
    # impl/fast_gicp_impl.hpp:365-398): "plane" (the reference default:
    # eigenvalues -> 1e-3,1,1) | "min_eig" | "norm_min_eig" | "frobenius" |
    # "none".  Keep "plane" unless measured otherwise: modes that preserve
    # line-shaped Gaussians ring-lock on ground scan lines
    # (ops/covariance.norm_min_eig_regularize's docstring)
    cov_regularization: str = "plane"
    # covariance-estimation mode feeding the regularizer above: "scan" =
    # ring-window PCA (the kd-tree kNN analog, default) | "rbf" = G8
    # Gaussian-kernel moments (covariance_estimation_rbf.cu, selected by
    # GPU_RBF_KERNEL in fast_vgicp_cuda.hpp:21); width/max_dist defaults
    # mirror fast_vgicp_cuda.cu:25-26
    cov_estimation: str = "scan"
    rbf_kernel_width: float = 0.25
    rbf_kernel_max_dist: float = 3.0
    # mapping-solve robust loss: "huber" = reference-exact Ceres
    # HuberLoss(0.1) semantics (frozen-weight corrector, parity-oracle
    # enforced) | "l1" = differentiate through the IRLS weight, i.e. an L1
    # M-estimator — a documented deviation with harder outlier suppression
    # (degenerate grazing-wall corridor: 0.20 m vs 0.66 m ATE, see
    # models/mapping._huber_weight)
    mapping_loss: str = "huber"

    def __post_init__(self):
        # block-slice sp sharding drops tail points silently if a capacity
        # is not divisible; reject at construction (fleet.fleet_shard_step
        # falls back to stride masking instead of raising)
        if self.sp_shards > 1:
            names = ["max_source_points", "max_kf_corner", "max_kf_surf"]
            if self.sp_features:
                names.append("max_points")
            for name in names:
                cap = getattr(self, name)
                if cap % self.sp_shards:
                    raise ValueError(
                        f"sp_shards={self.sp_shards} must divide {name}={cap} "
                        f"(block-slice sharding would drop the tail points)"
                    )

    @property
    def expected_ground_ranges(self) -> Tuple[float, ...]:
        """Per-ring expected ground range for the configured sensor height.

        Generalizes the hardcoded `Ground_scan_range[16]` table
        (scanRegistration.cpp:40): ground hit distance = h / sin(|elev|) with
        the per-sensor elevation of ring i (ring->angle formulas inverted from
        scanRegistration.cpp:145-178 / io/convert.ring_from_vertical_angle):
          16-beam VLP-16:   elev = -15 + 2*i      (ring 0 = lowest beam)
          32-beam HDL-32E:  elev = -92/3 + 4/3*i  (ring 0 = lowest beam)
          64-beam HDL-64E:  ring 0 is the HIGHEST beam (+2 deg) — the low-ring
          ground heuristic does not transfer; configure use_ground=False (the
          KITTI config does) or supply a custom table.
        """
        import math

        if self.n_scans == 16:
            elev_of = lambda i: -15.0 + 2.0 * i
        elif self.n_scans == 32:
            elev_of = lambda i: -92.0 / 3.0 + (4.0 / 3.0) * i
        else:
            if self.use_ground:
                raise ValueError(
                    "expected_ground_ranges: no low-ring elevation table for "
                    f"n_scans={self.n_scans}; set use_ground=False or add one"
                )
            # unused (ground segmentation off) — benign placeholder
            elev_of = lambda i: -15.0 + 2.0 * i
        out = []
        for i in range(self.ground_scan_rings + 1):
            elev = abs(elev_of(i)) * math.pi / 180.0
            out.append(self.lidar_height / max(math.sin(elev), 1e-3))
        return tuple(out)


# A small config for unit tests (tiny capacities, fast compiles).
TEST_CONFIG = SlamConfig(
    max_points=4096,
    max_points_per_ring=256,
    max_source_points=1024,
    max_voxels=2048,
    max_keyframes=64,
    max_kf_corner=128,
    max_kf_surf=512,
    max_map_points=4096,
    max_loops=8,
    max_loop_submap_points=2048,
    surrounding_keyframes=12,
    loop_submap_halfwidth=25,
    vgicp_max_iterations=15,
    max_sharp_total=512,
    max_flat_total=1024,
    max_inten_total=512,
)
