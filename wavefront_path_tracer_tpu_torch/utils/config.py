"""Render configuration.

The reference hardcodes its knobs (2880x1620 viewport in
``gpu_wavefront_pt/src/main.rs:33``, ``SPP=10`` / ``SPF=1`` compile-time
constants in ``wavefront_common/src/parameters.rs:4-5``, bounce cap 50
and the queue-drain heuristic 128 as literals in
``gpu_wavefront_pt/src/path_tracer.rs:323,332``, ``USE_BVH`` baked into
shader source at ``extend.wgsl:1``).  Here they are one dataclass that
doubles as the CLI surface.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """All static knobs of a render.

    Frozen + hashable so it can be a jit static argument.
    """

    width: int = 400
    height: int = 225
    samples_per_pixel: int = 10        # reference SPP (parameters.rs:4)
    samples_per_frame: int = 1         # reference SPF (parameters.rs:5)
    max_bounces: int = 50              # reference bounce cap (path_tracer.rs:323)
    frame: int = 0                     # RNG frame salt
    engine: str = "wavefront"          # "megakernel" | "wavefront" | "fused"
    intersector: str = "bruteforce"    # "bruteforce" | "bvh"
    ray_chunk: int = 0                 # 0 = whole wavefront in one chunk
    sphere_chunk: int = 128            # spheres per intersection block
    tile_rows: int = 8                 # fused engine: tile = tile_rows x 128 rays
    # Wavefront engine: partition the hit queue by material and shade
    # with per-material kernels (the reference's TODO, README.md:19).
    material_split: bool = False
    # Fused/baked engine: leaf cluster size for hierarchical consensus
    # culling of spheres AND triangles (0 = no culling; -1 = auto —
    # measured optima: 16 below 2000 primitives, 32 at 10k;
    # exp/sweep10k.py).
    baked_clusters: int = 0
    # Fused engine: group pixels into NxN image blocks per ray tile so
    # cluster culling sees spatially coherent lanes (0 = linear order).
    block_tiles: int = 32
    # Fused engine: split each pixel's sample budget over K duplicate
    # lanes — cuts the persistent-loop tail (a tile runs as long as its
    # slowest lane) at the cost of K x input planes.  Auto-reduced to a
    # divisor of the frame's sample count.
    lane_split: int = 1
    # Fused engine: rotate which pixel of the tile a lane traces each
    # sample (lane (r,c)'s k-th sample -> pixel row (r+k) % tile_rows),
    # averaging per-lane work over tile_rows pixels — the heavy-pixel
    # straggler fix.  Same (pixel, sample) RNG streams either way; only
    # float summation order changes.
    lane_rotate: bool = True
    # Fused engine: column phases for the rotation above.  A tile row
    # holds 4 image rows x 32 columns, so row rotation alone never
    # varies a lane's image column; with N > 1 every rows-th sample
    # also shifts the lane's image column by 32/N, spreading vertically
    # coherent hotspots (sphere silhouettes) at the cost of N x more
    # in-kernel accumulator planes.  Power of two dividing 32.
    # Measured at the 1080p headline: N=2 is a wash, N=4 loses ~5%
    # (the extra selects eat the utilization gain) — default stays 1.
    lane_rotate_cols: int = 1
    # Fused/baked engine: texel budget per image texture.  Per-lane
    # texel gathers are pathological on TPU, so image textures bake to
    # mean-pooled LUTs evaluated by a when-gated select tree whose cost
    # is O(texels) *only for tiles that see the sphere* — raise for
    # fidelity (the XLA engines always sample full resolution), lower
    # for speed on texture-heavy tiles.  RGB is packed 10:10:10 into
    # one int32 tree (quantization <= 1/1023 per channel), so the cost
    # per texel is a third of the per-channel-float form.  Measured
    # fidelity/cost curve vs the XLA full-res oracle on a mixed-content
    # 256x128 texture (exp/texlut.py, TPU, 400x224@64):
    #   512 -> 3.1e-2, 2048 -> 7.2e-3, 8192 -> 3.0e-3 (+15% render
    #   cost), 32768 (full res) -> 1.7e-4 (2x render cost).
    # 8192 is the knee: pooling error ~ the same-stream texture gate
    # (3e-3) at modest cost.  Budgets above ~4k texels need the raised
    # kernel VMEM limit (pallas_kernels: vmem_limit_bytes=100M).
    tex_lut_max: int = 8192
    # Fused/baked culled engine: winner-cluster shortlist.  Each lane
    # remembers which cluster its last hit came from; the next
    # intersect prepass-tests exactly those clusters so the consensus
    # cap is tight before the main sweep — the temporal-coherence
    # answer to incoherent bounce rays, which defeat front-to-back
    # ordering.  Results identical up to float-tie iteration order.
    winner_hint: bool = False
    # Fused engine: ray-coherence re-clustering segment length (0 =
    # off).  The persistent kernel binds a lane to a pixel for a whole
    # sample, so after the first diffuse bounce a tile's rays decohere
    # and whole-tile consensus culling degenerates (50k-tri knot: most
    # clusters entered every iteration).  With K > 0 each sample runs
    # as SEGMENTS: K bounces in-kernel, then live rays are re-sorted by
    # direction octant x origin Morton cell (dead rays to the back), so
    # a tile's lanes share a frustum again.  Segment lengths double
    # after the second segment (coherence matters most while most rays
    # live), so sorts are O(log(max_bounces / K)) per sample.  Identical
    # per-(pixel,sample,bounce) RNG streams — parity with the other
    # engines is unchanged.  Measured win on incoherent scenes
    # (BENCHMARKS.md round 4); a loss on small coherent scenes where
    # culling already skips little.
    recluster: int = 0
    # Multi-chip: number of devices to shard pixels over (1 = single chip).
    num_devices: int = 1
    # Russian roulette: 0 disables (default — matches the reference's
    # always-trace-to-cap semantics); N > 0 starts unbiased roulette at
    # the N-th surface event (continue with p = max throughput
    # component, survivors compensated by 1/p).  The roulette draw uses
    # an independently salted RNG stream, so rr-off renders are
    # bit-identical with or without this feature.  Supported by all
    # engines; cuts time-to-N-spp on bounce-heavy scenes.
    rr_start_bounce: int = 0
    # Russian roulette survival floor: the continue probability is
    # clip(max(throughput), rr_floor, 1).  A higher floor kills fewer
    # dark paths (less variance in the killed tail — fewer fireflies)
    # at the cost of tracing more of them; tune together with
    # rr_start_bounce for the speed/variance frontier.
    rr_floor: float = 0.05
    # AA sampler: "random" (the reference's pure-PCG disk jitter) or
    # "stratified" (the two AA-disk uniforms remapped onto a 4x4
    # stratum grid cycling with the sample index — same draw count and
    # stream positions, so lens and bounce streams are untouched;
    # unbiased, lower pixel variance at low spp).  All engines share
    # the formula, so cross-engine bit-identity is preserved.
    sampler: str = "random"
    # Per-sample componentwise radiance clamp (standard production
    # control).  0 disables.  NOTE: this renderer's per-sample radiance
    # is <= 1 by construction (multiplicative albedo <= 1, sky <= 1,
    # roulette weight division bounded by max-throughput survival), so
    # values >= 1 are provably inert (exp/clamp_bias.py measures 0
    # bias); < 1 darkens highlights in exchange for variance.
    clamp: float = 0.0
    # Adaptive stop: end the progressive loop when the mean absolute
    # display-image change per frame batch falls below this (the SPP
    # budget stays the hard cap).  0 disables.
    stop_delta: float = 0.0
    # Exact termination (0, default) vs the reference's lossy early
    # break (path_tracer.rs:330-332): with N > 0 the wavefront loop
    # stops once a bounce produces fewer than N misses — the reference's
    # exact quantity (its literal is 128).
    drain_threshold: int = 0

    def __post_init__(self) -> None:
        # A negative start bounce would silently diverge the engines:
        # XLA engines treat it as "always active" (int compare) while
        # the fused kernel's u32 cast makes it "never active".
        if self.rr_start_bounce < 0:
            raise ValueError(
                f"rr_start_bounce must be >= 0, got {self.rr_start_bounce} "
                "(0 disables Russian roulette)")
        if self.drain_threshold < 0:
            raise ValueError(
                f"drain_threshold must be >= 0, got {self.drain_threshold}")
        if not 0.0 < self.rr_floor <= 1.0:
            raise ValueError(
                f"rr_floor must be in (0, 1], got {self.rr_floor} "
                "(a zero floor would divide by a zero continue probability)")
        if self.tex_lut_max < 4:
            raise ValueError(
                f"tex_lut_max must be >= 4, got {self.tex_lut_max}")
        if self.clamp < 0.0:
            raise ValueError("clamp must be >= 0 (0 disables)")
        if self.stop_delta < 0.0:
            raise ValueError("stop_delta must be >= 0 (0 disables)")
        if self.sampler not in ("random", "stratified"):
            raise ValueError(
                f"sampler must be 'random' or 'stratified', "
                f"got {self.sampler!r}")
        if self.baked_clusters < -1:
            raise ValueError(
                f"baked_clusters must be >= -1, got {self.baked_clusters} "
                "(-1 = auto, 0 = no culling, N = leaf cluster size)")
        if self.recluster < 0:
            raise ValueError(
                f"recluster must be >= 0, got {self.recluster} "
                "(0 disables segment re-sorting)")
        if self.recluster > 2:
            # Measured, not hypothetical: recluster=4 repeatably crashes
            # the TPU worker (round-4 BENCHMARKS: the fused 8-key sort's
            # scoped VMEM at K>=3 segment sizes exceeds what Mosaic can
            # schedule and takes down the device, not the process).  A
            # shipped flag must not kill the worker, so refuse up front.
            raise ValueError(
                f"recluster must be <= 2, got {self.recluster}: segment "
                "counts above 2 are refused because the fused segment "
                "sort at K>=3 crashes the TPU worker (measured at K=4, "
                "BENCHMARKS.md round 4). Use recluster=2, which doubles "
                "segment lengths after the second segment and covers "
                "deep bounce chains already")
        if self.recluster > 0 and self.winner_hint:
            raise ValueError(
                "recluster and winner_hint are mutually exclusive: the "
                "segment kernel carries no shortlist plane (re-sorting "
                "replaces temporal hints as the coherence mechanism)")
        if self.winner_hint and self.baked_clusters == 0:
            raise ValueError(
                "winner_hint requires baked_clusters > 0 (the shortlist "
                "prepasses the cull hierarchy's clusters; without "
                "clustering it would silently do nothing)")

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class RenderProgress:
    """Progressive accumulation bookkeeping (reference parameters.rs:61-101)."""

    frame: int = 0
    accumulated_samples: int = 0

    def progress(self, spp: int) -> float:
        return min(1.0, self.accumulated_samples / max(1, spp))

    def reset(self) -> None:
        self.frame = 0
        self.accumulated_samples = 0
