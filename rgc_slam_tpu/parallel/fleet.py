"""Multi-robot fleet SLAM + multi-chip sharding.

The reference's parallelism is 3 pipelined processes + OpenMP point loops
(SURVEY §2.4); there is nothing to shard across machines for one robot.  The
accelerator scaling story (BASELINE config 5) is therefore:

  * **vmap fleet** — one compiled program runs B independent SLAM instances
    per device (multi-robot fleets / parameter sweeps).  All state is a
    batched pytree; the whole pipeline was built mask-padded so this is a
    one-liner.
  * **dp × sp mesh** — `shard_map` over a 2-D device Mesh: the fleet batch is
    sharded over the ``dp`` axis (zero cross-robot communication) and the
    VGICP hot loop is point-sharded over ``sp`` with psum-reduced 6x6 H / b /
    cost partials (annotate shardings, let XLA insert the collectives; see
    cfg.psum_axis / ops/registration.py).  A psum'd fleet-health summary over
    ``dp`` exercises the data-parallel collective as well.
"""
from __future__ import annotations

import dataclasses
import functools
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..config import SlamConfig
from ..types import ImuBatch, PointCloud
from ..models.slam import SlamState, slam_step


def fleet_init(cfg: SlamConfig, n_robots: int) -> SlamState:
    """Batched initial state [B, ...] for a fleet of independent robots."""
    one = SlamState.init(cfg)
    return jax.tree.map(lambda a: jnp.broadcast_to(a, (n_robots,) + a.shape), one)


def fleet_step(states: SlamState, clouds: PointCloud, imus: ImuBatch,
               stamps: jax.Array, cfg: SlamConfig):
    """vmapped slam_step over the robot axis (single device)."""
    return jax.vmap(functools.partial(slam_step, cfg=cfg))(states, clouds, imus, stamps)


def compact_fleet(states: SlamState) -> SlamState:
    """Host-cadenced keyframe-store compaction for vmapped fleets.

    mapping_step's inline eviction is a lax.cond whose predicate is
    per-robot; under vmap XLA executes both branches, so every robot would
    pay the store-permutation gathers every scan.  Fleets therefore run
    with cfg.inline_compaction=False and compact inside the step program
    (``fleet_step_compacting``).  Each robot compacts only if its store is within
    COMPACT_MARGIN of capacity (where-select per leaf, so under-capacity
    robots keep their state bit-exact)."""
    from ..models.mapping import COMPACT_MARGIN, compact_keyframe_store

    def one(ms):
        need = ms.kf_count >= ms.kf_q.shape[0] - COMPACT_MARGIN
        ms2, _, _ = compact_keyframe_store(ms)
        return jax.tree.map(lambda a, b: jnp.where(need, a, b), ms2, ms)

    return states.replace(mapping=jax.vmap(one)(states.mapping))


def fleet_step_compacting(states: SlamState, clouds: PointCloud,
                          imus: ImuBatch, stamps: jax.Array,
                          cfg: SlamConfig):
    """fleet_step with DEVICE-RESIDENT keyframe-store compaction.

    The compaction decision is a top-level ``lax.cond`` — NOT under vmap,
    so exactly one branch executes (the CLAUDE rule "cond only for
    genuinely expensive rare paths" is exactly this case): when any
    robot's store is within COMPACT_MARGIN of capacity the where-select
    ``compact_fleet`` runs, otherwise the step pays one scalar reduction.

    No device->host fetch, no extra dispatch, no staleness — a robot is
    compacted the very scan it crosses the margin, so the capacity freeze
    backstop is unreachable at any chunk size.  Fleets running loop closure
    must instead rely on fleet_loop_step's loop-aware compaction (same
    reasoning as compact_fleet's docstring)."""
    from ..models.mapping import COMPACT_MARGIN

    states, outs = fleet_step(states, clouds, imus, stamps, cfg)
    K = states.mapping.kf_q.shape[-2]
    need = jnp.any(states.mapping.kf_count >= K - COMPACT_MARGIN)
    states = jax.lax.cond(need, compact_fleet, lambda s: s, states)
    return states, outs


def fleet_loop_init(cfg: SlamConfig, n_robots: int):
    """Batched LoopState [B, ...] for fleet loop closure."""
    from ..models.loop import LoopState

    one = LoopState.init(cfg)
    return jax.tree.map(lambda a: jnp.broadcast_to(a, (n_robots,) + a.shape), one)


def fleet_loop_step(states: SlamState, loop_states, cfg: SlamConfig):
    """vmapped loop_closure_step — fleet SLAM includes the pose-graph thread
    (the reference always runs it when enabled, RGC_mapping.cpp:303-304,1962;
    VERDICT r2 item 2).  Host-cadenced like SlamSystem (every
    cfg.loop_cadence scans); the PGO lax.cond executes both branches under
    vmap, which the cadence amortizes.  Also performs the loop-aware
    keyframe-store compaction, so fleets running loops must NOT mix in
    ``compact_fleet`` (it would relabel keyframes under the loop store)."""
    from ..models.loop import loop_closure_step

    return jax.vmap(functools.partial(loop_closure_step, cfg=cfg))(
        states, loop_states
    )


def fleet_loop_fused_step(states: SlamState, loop_states, counter: jax.Array,
                          clouds: PointCloud, imus: ImuBatch,
                          stamps: jax.Array, cfg: SlamConfig):
    """fleet_step + cadence-gated loop closure in ONE program.

    The reference decouples the pose graph onto a 1 Hz thread so it never
    serializes the odometry/mapping hot path (RGC_mapping.cpp:1964,303-304);
    here it must not serialize the dispatch pipeline either: a separate
    host-cadenced ``fleet_loop_step`` call costs a dispatch every
    ``cfg.loop_cadence`` scans and denies the surrounding scans chunk
    amortization.

    Here the loop-closure + PGO + loop-aware compaction call sits behind a
    TOP-LEVEL ``lax.cond`` (the ``fleet_step_compacting`` pattern: one branch
    executes, and the vmapped loop program only runs on the scans where
    ``counter`` crosses the cadence), so the whole thing chains under
    ``make_fleet_chunk_step`` and the deployment mode rides the same
    dispatch amortization as the loop-less headline.

    ``counter`` is a traced int32 scalar (scan count BEFORE this step) so
    cadence progress lives on device — no host round-trip, no recompiles.
    """
    states, outs = fleet_step(states, clouds, imus, stamps, cfg)
    new_counter = counter + 1
    run = jnp.mod(new_counter, cfg.loop_cadence) == 0

    def do(args):
        s, ls = args
        s2, ls2, _info = fleet_loop_step(s, ls, cfg)
        return s2, ls2

    states, loop_states = jax.lax.cond(
        run, do, lambda a: a, (states, loop_states)
    )
    return states, loop_states, new_counter, outs


def _needs_exact_cadence(cfg: SlamConfig, chunk: int) -> bool:
    """Whether ``make_fleet_chunk_step`` must use its cond-per-scan program.

    The single-cond-at-chunk-end program fires a cadence boundary at the
    next multiple of ``chunk``, i.e. ``(-boundary) % chunk`` scans late.
    With ``r = loop_cadence % chunk != 0`` that delay shrinks by ``r`` per
    boundary until it wraps up by ``chunk - r``, so the worst-case gap
    between loop-aware compaction opportunities is exactly
    ``loop_cadence + chunk - r`` scans (e.g. cadence 10, chunk 8: delays
    cycle 6,4,2,0 and the max gap is 16, not 17).  Past
    ``mapping.COMPACT_MARGIN`` that gap risks the silent keyframe-write
    backstop (mapping.py ``add_kf & (kf_count < K)``), mirroring run.py's
    ``loop_cadence > COMPACT_MARGIN`` rejection (gap == margin is safe —
    compaction keeps ``COMPACT_MARGIN`` slots free when it runs)."""
    from ..models.mapping import COMPACT_MARGIN, worst_cadence_gap

    return chunk > cfg.loop_cadence or (
        worst_cadence_gap(cfg.loop_cadence, chunk) > COMPACT_MARGIN
    )


def make_fleet_chunk_step(cfg: SlamConfig, chunk: int):
    """Compile a fleet program advancing ``chunk`` scans per dispatch WITH
    loop closure folded in (see ``fleet_loop_fused_step``).  The returned
    callable takes ``(states, loop_states, counter, *flat)`` where flat
    interleaves chunk (clouds, imus, stamps) triples, and returns
    ``(states, loop_states, counter, [outs] * chunk)``.

    Compile-cost shape: each ``lax.cond`` embeds the full vmapped
    loop-closure + PGO program, so the number of conds is kept minimal.
    When ``chunk <= cfg.loop_cadence`` at most ONE cadence boundary can
    fall inside a chunk, so a single cond at chunk end is enough — the loop
    fires within the same chunk the boundary lands in (up to chunk-1 scans
    later than the per-dispatch path, matching the reference's
    asynchronous 1 Hz pose-graph thread, RGC_mapping.cpp:1964; and when
    ``cfg.loop_cadence % chunk == 0`` the boundary is always the chunk end,
    making the two paths bit-identical —
    test_fleet.test_fused_chunk_matches_per_dispatch).

    Keyframe-eviction headroom: loop-aware compaction only gets a chance to
    run when the cond fires, and a non-divisor chunk delays a firing past
    its cadence boundary — worst-case gap between compaction opportunities
    ``loop_cadence + chunk - loop_cadence % chunk`` scans (see
    ``_needs_exact_cadence``).  If that exceeds ``mapping.COMPACT_MARGIN``
    a robot keyframing every scan could fill its store and hit the silent
    ``kf_count < K`` write backstop (mapping.py), so such chunks — like
    ``chunk > loop_cadence`` — take the cond-per-scan fallback: exact
    cadence (never exceeds the margin the cadence itself fits in) at
    chunk-times the compile cost."""
    exact_cadence = _needs_exact_cadence(cfg, chunk)

    def chunk_step(states, loop_states, counter, *flat):
        if exact_cadence:
            outs = []
            for i in range(chunk):
                states, loop_states, counter, out = fleet_loop_fused_step(
                    states, loop_states, counter, *flat[3 * i:3 * i + 3], cfg
                )
                outs.append(out)
            return states, loop_states, counter, outs

        outs = []
        for i in range(chunk):
            states, out = fleet_step(states, *flat[3 * i:3 * i + 3], cfg)
            outs.append(out)
        new_counter = counter + chunk
        run = (new_counter // cfg.loop_cadence) > (counter // cfg.loop_cadence)

        def do(args):
            s, ls = args
            s2, ls2, _info = fleet_loop_step(s, ls, cfg)
            return s2, ls2

        states, loop_states = jax.lax.cond(
            run, do, lambda a: a, (states, loop_states)
        )
        return states, loop_states, new_counter, outs

    return jax.jit(chunk_step)


def make_mesh(n_dp: int, n_sp: int) -> Mesh:
    devs = np.asarray(jax.devices()[: n_dp * n_sp]).reshape(n_dp, n_sp)
    return Mesh(devs, axis_names=("dp", "sp"))


def _sp_plan(cfg: SlamConfig, n_sp: int) -> SlamConfig:
    """Resolve the sp-axis sharding plan for an n_sp-wide mesh.

    Block-slice sharding needs the point capacities divisible by sp;
    otherwise fall back to stride-masked sharding (correct, less speedup).
    The two fallbacks are independent: an indivisible max_points disables
    only the sp FEATURE front-end (sp_features=False), never the
    registration/mapping block sharding that its own caps allow — and
    SlamConfig validates max_points only when sp_features stays on."""
    divisible = all(
        c % n_sp == 0
        for c in (cfg.max_source_points, cfg.max_kf_corner, cfg.max_kf_surf)
    )
    sp_features = cfg.sp_features and divisible and cfg.max_points % n_sp == 0
    return dataclasses.replace(
        cfg,
        psum_axis="sp",
        sp_shards=n_sp if divisible else 1,
        sp_features=sp_features,
    )


def make_distributed_step(mesh: Mesh, cfg: SlamConfig):
    """shard_map'd fleet step over a ('dp','sp') mesh.

    The robot batch is sharded over dp; each robot's registration reduction is
    point-sharded over sp (psum on H/b/cost inside lm_register).  State and
    inputs are replicated over sp and sharded over dp.  Returns a function
    (states, clouds, imus, stamps) -> (states, outputs, fleet_mean_fitness).
    """
    n_sp = int(mesh.shape["sp"])
    sp_cfg = _sp_plan(cfg, n_sp)

    def local_step(states, clouds, imus, stamps):
        new_states, outs = jax.vmap(functools.partial(slam_step, cfg=sp_cfg))(
            states, clouds, imus, stamps
        )
        # fleet-health summary: mean fitness over ALL robots (dp collective)
        local_sum = jnp.sum(outs.fitness)
        local_n = jnp.asarray(outs.fitness.shape[0], jnp.float32)
        total = jax.lax.psum(local_sum, "dp")
        count = jax.lax.psum(local_n, "dp")
        return new_states, outs, total / count

    # robots sharded over dp, replicated over sp
    batch_spec = P("dp")
    return jax.jit(
        jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=(batch_spec, batch_spec, batch_spec, batch_spec),
            out_specs=(batch_spec, batch_spec, P()),
            check_vma=False,
        )
    )
