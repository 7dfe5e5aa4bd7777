"""Configuration for the JAX VO engine.

The reference scatters its configuration over compile-time constants, a
runtime ``struct param`` (reference src/viso.h:58-72) and environment
variables (src/kitti.cpp:96, src/calib_sfm.cpp:56).  Here every knob is a
frozen dataclass field so configs are hashable and can be closed over by
jit-compiled functions (static), while the calibration itself is a small
pytree of arrays (traced).

Defaults reproduce the reference behavior:
  - stereo detector: 1200 corners, 24x5 bins, Harris k=.04, block 3,
    aperture 5, descriptor radius 5    (src/viso.cpp:911-979, 1172-1174)
  - stereo matching: radius 80, Sampson gate 1.0 for LR, ratio .9 for
    temporal matches                    (src/viso.cpp:62-74)
  - RANSAC: inlier threshold 2 px, GN convergence 1e-4, >=6 inliers
    required (src/viso.h:60, src/viso.cpp:1571); hypothesis count is 64
    vs the reference's 50 serial iterations — a deliberate round-up to a
    vmap-friendly batch (PARITY.md divergence #8)
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class Calib:
    """Rectified stereo calibration (reference ``param.calib`` + ``base``).

    Derived from KITTI projection matrices exactly as the reference does
    (src/viso.cpp:1183-1187): f = P1[0,0], cu = P1[0,2], cv = P1[1,2],
    base = |P2[0,3] / P2[0,0]|.
    """

    f: float
    cu: float
    cv: float
    base: float

    @staticmethod
    def from_projections(P1, P2) -> "Calib":
        P1 = jnp.asarray(P1)
        P2 = jnp.asarray(P2)
        return Calib(
            f=float(P1[0, 0]),
            cu=float(P1[0, 2]),
            cv=float(P1[1, 2]),
            base=float(abs(P2[0, 3] / P2[0, 0])),
        )


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Harris binned detector + Sobel-patch descriptor configuration.

    ``max_features`` is the target corner budget spread uniformly over
    ``nbinx * nbiny`` spatial bins (reference keeps
    ``max_features // (nbinx*nbiny)`` corners per bin, src/viso.cpp:944).
    ``num_slots`` is the fixed keypoint tensor size (padded to a multiple
    of 128 so every matcher problem has one static shape).
    """

    max_features: int = 1200
    nbinx: int = 24
    nbiny: int = 5
    harris_k: float = 0.04
    block_size: int = 3
    aperture: int = 5
    descriptor_radius: int = 5
    num_slots: int = 1280  # fixed keypoint tensor size (>= max_features)
    # Patch-gather implementation for the Sobel descriptor windows:
    #   'onehot'    — two chained 0/1-selection matmuls (columns then
    #                 rows), bin-banded for binned keypoints; bitwise
    #                 identical to 'take' (each output has exactly one
    #                 nonzero contribution and the products run in full
    #                 f32, ops/features.py::_SELECT_PRECISION).
    #   'onehot_i8' — the same with int8 selectors; exact for
    #                 integer-valued (uint8) images only.
    #   'take'      — one flat XLA gather; the default, ~8% faster per
    #                 full-width frame step than 'onehot' on an H100.
    descriptor_gather: str = "take"
    # Beyond-reference options (BASELINE config 3):
    pyramid_levels: int = 1  # >1 enables multi-scale detection
    subpixel: bool = False   # quadratic subpixel corner refinement
    # Unsharp-mask preconditioner for defocused imagery (beyond-reference;
    # both views, before detection AND description).  Heavy defocus is the
    # one measured SILENT failure regime (docs/realism.md breaking points:
    # blur sigma=3 walks meters off while every frame reports ok);
    # sharpening restores it — measured ATE at blur sigma=3: 0.60 -> 0.08 m
    # with (sigma=3, amount=4).  Off by default (reference parity; also
    # amplifies sensor noise, so enable it when the per-frame `sharpness`
    # stat collapses, not unconditionally).  Pure elementwise shifted-adds
    # that XLA fuses into the Harris pipeline (ops/features.py::unsharp_mask).
    sharpen_sigma: float = 0.0   # Gaussian sigma [px]; 0 disables
    sharpen_amount: float = 4.0  # high-pass gain when enabled
    # Auto mode: apply the mask only on frames whose in-graph blur
    # metric (ops/features.py::blur_metric — scene- and noise-
    # independent, measured ~0.37 sharp vs ~0.19-0.24 defocused) falls
    # below the trigger.  Sharp frames are bit-exact no-ops, so auto
    # mode is safe to leave on for rigs that may defocus.  Combined
    # HEAVY noise+defocus is not recoverable either way — but it fails
    # loudly (ok flags drop), unlike pure defocus (docs/realism.md).
    sharpen_auto: bool = False
    sharpen_trigger: float = 0.28
    # Non-max suppression radius [px] before the per-bin top-k
    # (beyond-reference; the reference keeps raw nth_element winners,
    # src/viso.cpp:961-963, so one strong corner's neighboring pixels
    # can occupy several budget slots).  r>0 keeps only pixels that are
    # the maximum of their (2r+1)^2 neighborhood — a reduce_window
    # max-pool equality, fused into the response pipeline by XLA.  0
    # disables (reference parity).  Turning it on spreads the budget
    # over distinct corners, which is what keyframe-based loop closure
    # needs (pipeline/loop.py); per-frame VO is insensitive either way.
    nms_radius: int = 0

    def __post_init__(self):
        if self.descriptor_gather not in ("onehot", "onehot_i8", "take"):
            raise ValueError(
                f"descriptor_gather must be 'onehot', 'onehot_i8' or "
                f"'take', got {self.descriptor_gather!r}")
        if self.descriptor_gather == "onehot_i8" and (
                self.sharpen_sigma > 0 or self.pyramid_levels > 1):
            # The int8 split is exact only for integer-valued images;
            # sharpening (fractional Gaussian taps) and pyramid
            # downscales produce fractional pixels that the split would
            # silently round (ADVICE r3).  Use 'onehot' — exact for any
            # f32 (and measured faster than i8 since the round-4
            # bin-banded gather, ops/features.py).
            raise ValueError(
                "descriptor_gather='onehot_i8' requires integer-valued "
                "images; sharpen_sigma>0 / pyramid_levels>1 break that — "
                "use 'onehot' (exact for any f32)")
        if self.sharpen_sigma < 0:
            raise ValueError("sharpen_sigma must be >= 0")
        if self.sharpen_auto and self.sharpen_sigma <= 0:
            raise ValueError(
                "sharpen_auto needs sharpen_sigma > 0 (the mask that "
                "auto mode gates); with sigma 0 it would silently "
                "protect nothing")

    @property
    def corners_per_bin(self) -> int:
        return self.max_features // (self.nbinx * self.nbiny)

    @property
    def descriptor_dim(self) -> int:
        d = 2 * self.descriptor_radius + 1
        return d * d

    @property
    def descriptor_dim_padded(self) -> int:
        """Descriptor length padded to a multiple of 128 (121 -> 128 at
        the default radius): the matcher and its tests rely on it."""
        return ((self.descriptor_dim + 127) // 128) * 128


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Descriptor matcher configuration (reference MatchParams, viso.cpp:48-75).

    The reference caps candidates at ``max_neighbors`` because its FLANN
    radius search materializes a neighbor list; the dense matcher scores
    every candidate inside the radius, a strict superset (deliberate,
    documented divergence — more candidates can only improve the best-match
    search).
    """

    radius: float = 80.0  # L1 radius in pixels on keypoint positions
    # Strip-banded matcher (round 4, ops/matching.py): keypoints from
    # the binned detector are x-strip-ordered and the position gate
    # confines candidates to ceil((radius+2)/strip) strips either side,
    # so the masked tensors shrink ~5x at KITTI scale.  OFF by default:
    # XLA fuses the dense gates into the argmin reduction pass, so the
    # mask traffic the banding saves need not reach device memory,
    # while the banded path pays real gather/scatter costs.  Its speed
    # on the GPU is not measured.  The implementation stays (tested
    # equal-on-detector-output; may pay at larger N); True + a
    # caller-supplied frame width enables it.
    banded: bool = False
    use_epipolar: bool = False
    sampson_thresh: float = 1.0
    use_ratio: bool = False
    ratio: float = 0.9
    # Descriptor distance.  'l2' (default since round 2) computes true
    # Euclidean distance via the matmul identity, so the (N1 x N2 x D)
    # reduction is one matrix product; 'l1' reproduces the reference
    # metric (NORM_L1, src/viso.cpp:989-992) as a broadcast-reduce —
    # strict-parity mode, CLI ``--metric l1``; 'l2q8' quantizes the
    # descriptors to int8 for an integer product.  Equivalence evidence
    # for the default flip: tests/test_matcher_equivalence.py — a
    # 14-sequence battery over seeds, noise, densities, low/repetitive
    # texture, and exposure drift; battery-wide median and geometric-mean
    # ATE ratio within 15% of 1 and every frame solving under both
    # metrics.
    metric: str = "l2"

    @staticmethod
    def stereo() -> "MatchConfig":
        """LR match: epipolar-gated, no ratio test (viso.cpp:62-71)."""
        return MatchConfig(use_epipolar=True, sampson_thresh=1.0,
                           use_ratio=False, ratio=0.8, radius=80.0)

    @staticmethod
    def temporal() -> "MatchConfig":
        """Frame-to-frame match: ratio .9, no epipolar gate (viso.cpp:72-74)."""
        return MatchConfig(use_epipolar=False, use_ratio=True, ratio=0.9,
                           radius=80.0)


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """RANSAC + Gauss-Newton configuration (src/viso.h:60, viso.cpp:1543-1623).

    All ``num_hypotheses`` models are estimated simultaneously as a vmapped
    batch (SURVEY.md C11).  ``gn_iters`` bounds the inner Gauss-Newton loop;
    the reference iterates up to 100 with early exit, we run a fixed-shape
    ``lax.while_loop`` with the same bound.  The reference's convergence test
    has a misplaced parenthesis (viso.cpp:1610) that makes it always
    "converged" after one step whose update is finite; we implement the
    intended test ``max_j |p_j| <= converge_thresh`` (deliberate divergence,
    SURVEY.md §3.5).
    """

    # Vmapped hypothesis lanes.  The reference runs 50 serial RANSAC
    # iterations (param.ransac_iter, viso.h:60); round 1 shipped the
    # lane-friendly round-up 64.  Measured (tests/test_ransac_budget.py:
    # 8 regimes incl. 12 moving occluders and fast motion, 3-4 seeds
    # each): 32 lanes match 64 in worst-case ATE and frame failures —
    # the circular-consistency filter (ops/circle.py) feeds RANSAC a
    # high-inlier support, where 32 three-point samples already hit an
    # all-inlier draw with >99% probability.  Halves the solve stage.
    # Statistical edge: below ~45% inliers 32 turns marginal (success
    # 1-(1-w^3)^N) — raise to 64+ for supports the circle filter can't
    # clean (no measured regime does this); PARITY.md divergence #8.
    num_hypotheses: int = 32
    gn_iters: int = 100
    # Iteration cap for the minimal-sample (3-point) hypothesis fits.
    # The reference iterates each sample up to 100 with a per-sample early
    # exit (serial loop); vmapped, the while_loop runs until the SLOWEST
    # lane finishes, and a single degenerate sample that never converges
    # pins every lane at the full 100.  Well-posed 3-point fits converge in
    # well under 30 steps; capping the fit phase cuts the slowest-lane
    # trips with no measurable trajectory change (the full `gn_iters`
    # budget still applies to the accuracy-critical inlier refit).
    fit_gn_iters: int = 30
    # Minimal-sample hypothesis estimator:
    #   'procrustes' (default) — closed-form 3D-3D Kabsch alignment
    #                  (Horn quaternion, no SVD) between the
    #                  previous-frame points and the triangulated
    #                  current-frame points (the reference's OTHER
    #                  estimator, solveRigidMotion estimation.cpp:29-51 /
    #                  ransacRigidMotion viso.cpp:1101-1135) plus a short
    #                  image-space polish.  Fewer solve-stage
    #                  trips, with trajectories bit-identical
    #                  to 'gn' on every tested sequence — the
    #                  accuracy-critical inlier refit is the same GN
    #                  either way.  PARITY.md divergence #7.
    #   'gn'         — iterative Gauss-Newton reprojection fit from zero
    #                  init, the reference's method (viso.cpp:1559);
    #                  strict hypothesis-distribution parity.
    hypothesis_method: str = "procrustes"
    # Image-space GN polish steps applied to each closed-form
    # Procrustes hypothesis before scoring (solvers/ransac.py).  The
    # polish only has to be good enough for the inlier VOTE to pick the
    # right support — the accuracy-critical refit then runs the full
    # gn_iters budget from that support.  Measured (round 4): 3 steps
    # reproduce the 8-step worst-case ATE to 4 decimals across every
    # stress regime (clean/occl12/fast+occl/hard sprite battery +
    # world frames, 3 seeds each, zero frame failures) with fewer
    # vmapped while_loop trips in the solve stage.
    procrustes_polish_iters: int = 3
    # Masked GN steps per while_loop iteration (results are bit-identical
    # for any factor — converged lanes freeze under the mask; the factor
    # only trades redundant tail compute against loop-condition overhead).
    gn_unroll: int = 2
    inlier_threshold: float = 2.0
    converge_thresh: float = 1e-4
    min_inliers: int = 6
    model_size: int = 3
    # Levenberg-Marquardt ridge on the GN normal equations, relative to
    # diag(JtJ).  0 (default) = plain GN, exact reference parity
    # (viso.cpp:1599-1606).  Loop-closure verification sets ~1e-3: its
    # support sets can be small and spatially clustered, where the
    # unregularized 6x6 system is near-singular along the weakly observed
    # translation direction and plain GN walks off to km-scale poses.
    gn_lm_lambda: float = 0.0
    # NOTE — dominant movers (VERDICT r3 #3): a feature-rich object
    # moving with coherent wrong motion SILENTLY captures the support
    # once it dominates the frame from the start at low relative speed
    # (measured envelope: benchmarks/world_mover_sweep.py; postmortem
    # of the rejected complement-re-solve guard: docs/realism.md
    # "Dominant movers" — the capture regime is geometrically
    # two-interpretation-ambiguous and arbitration cannot be anchored).
    # The shipped defense is the `motion_jump` health stat (pipeline
    # drivers) — locked runs flip between motion modes (jump 0.4-0.6)
    # while clean runs stay < 0.2.  The reference fails identically
    # (its RANSAC also follows the majority, viso.cpp:1543-1580).

    def __post_init__(self):
        if self.hypothesis_method not in ("gn", "procrustes"):
            raise ValueError(
                f"hypothesis_method must be 'gn' or 'procrustes', got "
                f"{self.hypothesis_method!r}")
        if self.gn_unroll < 1:
            raise ValueError(
                f"gn_unroll must be >= 1 (got {self.gn_unroll}): 0 would "
                "make the while_loop body the identity and hang the solve")


@dataclasses.dataclass(frozen=True)
class MonoConfig:
    """Monocular estimator thresholds (SURVEY.md C3; VERDICT r1 #8).

    The reference hard-codes none of these (its mono path stops before
    pose recovery, src/viso.cpp:1393-1395); they govern the completion —
    essential-matrix RANSAC, cheirality gating, and relative-scale
    propagation — and are config fields so the CLI can tune them.
    """

    # Sampson gate on NORMALIZED image coordinates (K^-1 pixels): the
    # pixel-space analog is sampson_thresh * f^2 ≈ 2e-5 * 700^2 ≈ 10 px².
    sampson_thresh: float = 2e-5
    # Cheirality gate: minimum points in front of both cameras for the
    # recovered (R, t) to count (the two-view analog of the stereo
    # pipeline's >= 6-inlier rule, src/viso.cpp:1571).
    min_good: int = 10
    # Lowe ratio for the epipolar re-match under the induced F
    # (the reference re-matches with ratio .9, src/viso.cpp:1386-1390).
    rematch_ratio: float = 0.9
    # RANSAC sample count for the essential matrix; 0 = auto (64 for the
    # 5-point solver — each sample scores up to 22 models — 128 for 8pt).
    num_hypotheses: int = 0
    # Minimal solver: '5pt' (findEssentialMat parity, viso.cpp:1384) or '8pt'.
    method: str = "5pt"
    # Solver for the FIRST RANSAC pass (est1), whose only products are
    # the induced F for the epipolar re-match gate and a sanity ok flag
    # — the pose comes from est2 on the re-matched set.  'same'
    # (default) runs the full `method` twice: strict first-pass parity
    # with findEssentialMat (viso.cpp:1384).  '8pt' runs the
    # ~2.5x-cheaper 8-point solver for the gate pass — measured
    # ATE-equivalent on
    # feature-rich configs (1200 pts: medians 0.060 vs 0.063 over 15
    # regime-seeds incl. noise and repetitive texture) but up to ~4x
    # worse on a sparser 900-point config (medians 0.094 vs 0.023) —
    # the cheap gate's F admits worse re-matches when correspondences
    # are thin, so it stays OPT-IN.
    first_pass: str = "same"
    # RANSAC hypothesis-selection quality (r5 estimator round,
    # geometry/essential.py::ransac_essential): 'msac' = truncated
    # quadratic at sampson_thresh (r2-r4 behavior); 'magsac' =
    # sigma-marginalized (MSAC quality averaged over a tau/4..4tau
    # threshold ladder) — selection stops depending on one threshold
    # guess.  Measured (benchmarks/mono_estimator_battery.py, 5 regimes
    # x 5 seeds = 25 paired rows): magsac + soft_refit cuts the
    # default path's overall median sim3 ATE 37% (0.0424 -> 0.0269) at
    # zero cost — wins 16/25 pairs outright, paired median ratio 0.91,
    # worst single-pair regression +39% — and does NOT rescue the
    # cheap 8pt gate pass
    # on sparse configs (its regression is the model class, not
    # selection noise), so the fast knobs stay opt-in.
    scoring: str = "magsac"
    # Continuous truncated-linear refit weights instead of 0/1 inliers
    # (chi^2-style downweighting of near-threshold points).
    soft_refit: bool = True
    # Gauss-Newton Sampson-error polish of (R, t) on its 5-dof manifold
    # after cheirality voting (geometry/essential.py::refine_relative_pose).
    # The linear RANSAC refit leaves the translation direction degrees off
    # at small baselines; 8 guarded iterations cut that ~30x. 0 disables.
    refine_iters: int = 8
    # Relative-scale propagation between consecutive essential-matrix
    # steps (VERDICT r1 #3): triangulate landmarks shared by steps t-1 and
    # t in the common camera (frame t-1), take the robust median depth
    # ratio as the scale of step t relative to step t-1.  Off = every
    # step has unit-norm translation (constant-speed assumption).
    scale_propagation: bool = True
    # Minimum shared landmarks for a trustworthy scale estimate; below
    # this the previous step's speed carries over unchanged.
    min_scale_support: int = 12
    # Fraction of shared landmarks kept for the scale median, ranked by
    # the SMALLER of their two triangulation angles (pipeline/mono.py::
    # _pair_parallax).  Near-FOE depths are hypersensitive to the
    # translation-direction estimate; trimming them cuts the ratio bias.
    parallax_keep_frac: float = 0.5
    # Scale estimator on the shared-landmark evidence:
    #   'bundle' (default) — three-view bundle adjustment
    #     (essential.py::three_view_bundle): re-optimizes both pair
    #     poses + per-track depths against the raw observations in all
    #     three frames; |t2| is the scale.  The ML estimator — every
    #     ratio-of-depths scheme inherits the errors-in-variables
    #     dilution of two-view triangulation (depths shrunk by
    #     ~sigma^2/parallax^2, ratios biased toward 1 by 10-20% on slow
    #     steps; measured), which the bundle avoids outright.
    #   'regression' — warp-aware robust LS: separates log s from BOTH
    #     pairs' pose-error depth-warp fields via their analytic
    #     gradients (essential.py::depth_log_grads); corrects the warp
    #     bias but not the triangulation dilution.
    #   'median' — parallax-trimmed median depth ratio (the simplest,
    #     and the most biased).
    #   'pnp' — motion-only PnP on stored landmarks (essential.py::
    #     pnp_refine_pose); inherits the previous pair's dilution
    #     through the fixed 3D points.
    scale_estimator: str = "bundle"
    # GN iterations for the 'pnp' estimator.
    pnp_iters: int = 10
    # GN iterations for the 'bundle' estimator.
    bundle_iters: int = 10

    def __post_init__(self):
        if self.method not in ("5pt", "8pt"):
            raise ValueError(
                f"method must be '5pt' or '8pt', got {self.method!r}")
        if self.first_pass not in ("same", "8pt"):
            raise ValueError(
                f"first_pass must be 'same' or '8pt', got "
                f"{self.first_pass!r}")
        if self.scale_estimator not in ("bundle", "regression", "median",
                                        "pnp"):
            raise ValueError(
                "scale_estimator must be bundle|regression|median|pnp, "
                f"got {self.scale_estimator!r}")

    def resolved_hypotheses(self) -> int:
        if self.num_hypotheses > 0:
            return self.num_hypotheses
        return 64 if self.method == "5pt" else 128


@dataclasses.dataclass(frozen=True)
class BAConfig:
    """Sliding-window bundle-adjustment configuration (BASELINE config
    4/5; VERDICT r3 #8 — every BA knob a config field).

    The reference has no BA (each pose uses only frame k-1 -> k,
    src/viso.cpp:1313-1321); these govern the beyond-reference windowed
    refinement (pipeline/windowed.py, pipeline/refine.py).
    """

    window: int = 8          # frames per BA window
    stride: int = 4          # window start spacing (< window = overlap)
    iters: int = 10          # GN/Schur iterations per BA stage
    # Two-stage observation gates (pipeline/refine.py): initial
    # reprojection gate for gross track mismatches, then a re-gate at
    # the coarse solution's residuals.
    outlier_px: float = 30.0
    rerank_px: float = 2.0
    # Cross-window marginalization prior strength (0 disables; see
    # run_windowed_ba docstring for the calibration).
    prior_strength: float = 1.0
    # VO-anchor shrinkage prior on ALL window frames, in the same units
    # (fraction of the marginalization prior's per-dof weight).
    # MEASURED POSTMORTEM (r5, benchmarks/ba_gate_experiment_r5.jsonl):
    # built as the structural fix for BA's clean-run ATE degradations
    # (pose motion along reprojection-flat directions), it does damp
    # them (4 -> 2 worse-than-VO rows at strength 0.05) but shrinks the
    # genuine corrections MORE (mean ATE 0.078 -> 0.089, captures
    # 20 -> 13/24) at EVERY strength 0.05-0.5 — the flat directions of
    # a bad-VO window coincide with the directions the correction needs.
    # The recalibrated holdout gate dominates it on both axes, so the
    # default stays 0; the knob remains for ablation.
    vo_prior_strength: float = 0.0
    # Both endpoint cameras of a motion must keep this many post-gate
    # observations or the frame falls back to its VO motion (measured:
    # a weakly-observed camera's refined motion can be meters off while
    # the window cost still drops).
    min_cam_obs: int = 24
    # Acceptance gate (VERDICT r3 #6, recalibrated r5): a window's
    # refined motions are applied only when they predict the gate
    # observations CLEARLY better than the VO poses
    # (pipeline/refine.py::holdout_gate — paired per-observation error
    # ratio against the frozen X0, MEAN over the two parity halves
    # <= margin < 1).  Calibration on 48 rows (24 + 24 fresh-seed,
    # benchmarks/ba_gate_fine{,_fresh}_r5.jsonl): at 0.90 the gate cuts
    # worse-than-VO rows 11 -> 4 /48 and mean harm 2.6x vs ungated BA
    # while keeping ~73% of its net accuracy win (the r4 both-halves-
    # <=0.85 form rejected every window in 19/24 rows and forfeited
    # measured 2.6x wins).  NOT a never-worse guarantee — the
    # reprojection statistic is blind to reprojection-flat pose error
    # (see holdout_gate docstring).  gate=False restores the round-3
    # always-apply behavior.  holdout_modulus: 0 gates on all masked
    # observations (nothing excluded from BA — the default; strict
    # holdouts lack statistical power under world-texture track
    # attrition); m>1 excludes every m-th landmark from BA and gates on
    # those only.
    gate: bool = True
    holdout_modulus: int = 0
    gate_margin: float = 0.90

    def __post_init__(self):
        if self.stride > self.window:
            raise ValueError(
                f"stride ({self.stride}) must be <= window "
                f"({self.window}): larger strides leave frames covered "
                "by no BA window")
        if self.holdout_modulus < 0:
            raise ValueError("holdout_modulus must be >= 0")


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Run-level health-alarm thresholds (docs/operations.md; VERDICT
    r4 #4).  Both calibrated on the round-4 dominant-mover sweep
    (benchmarks/world_mover_sweep_r4.jsonl): the support ratio dropped
    below 0.72 on 17/17 locked rows while healthy driving sits >= ~0.73;
    motion jumps of 0.34-0.78 mark mode-flipping capture vs ~0.05 smooth
    driving (benign transients reach 0.41, so the jump is the SECONDARY
    signal — docs/operations.md signal table)."""

    support_ratio_alarm: float = 0.72   # alarm when min ratio < this
    motion_jump_alarm: float = 0.3      # alarm when max jump > this

    # Deliberately NOT a PipelineConfig field: checkpoint fingerprints
    # hash repr(cfg), and tuning an alert threshold must never
    # invalidate a resume (the thresholds affect only the run-level
    # summary, not any computation).


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Top-level stereo odometry pipeline configuration."""

    detector: DetectorConfig = DetectorConfig()
    stereo_match: MatchConfig = MatchConfig.stereo()
    temporal_match: MatchConfig = MatchConfig.temporal()
    ransac: RansacConfig = RansacConfig()
    min_circle_matches: int = 3  # frame skipped below this (viso.cpp:1283)
    dtype: str = "float32"
    # Transient-dropout recovery (beyond-reference; streaming step only).
    # When a frame's solve FAILS, keep the last good frame's
    # features/3D as the temporal match target, so the next frame
    # recovers the spanning motion instead of matching against the bad
    # frame (the reference always advances, viso.cpp:1283-1288, so one
    # corrupt frame costs TWO motions).  Measured (tests/test_realism.py
    # dropout battery): one black frame mid-sequence, ATE 1.11 -> 0.29 m
    # and one fewer failed frame.  After `max_keep_age` consecutive
    # failures the new frame is accepted anyway (a genuinely changed
    # scene must re-sync rather than pin to stale features).  Bounded
    # worst case: if the re-sync accepts a frame that itself has a few
    # garbage corners, the next failure can hold THOSE for another cap
    # round — total re-sync delay <= 2x max_keep_age frames, never
    # unbounded.  In-graph selects, no host sync; unsupported in the
    # batched/DP/pipelined drivers (they raise), hence off by default.
    keep_features_on_failure: bool = False
    max_keep_age: int = 3

    def __post_init__(self):
        if self.keep_features_on_failure and self.max_keep_age < 1:
            raise ValueError("max_keep_age must be >= 1")

    def with_metric(self, metric: str) -> "PipelineConfig":
        """Return a copy with both matchers switched to ``metric``."""
        return dataclasses.replace(
            self,
            stereo_match=dataclasses.replace(self.stereo_match,
                                             metric=metric),
            temporal_match=dataclasses.replace(self.temporal_match,
                                               metric=metric),
        )

    @staticmethod
    def mono() -> "PipelineConfig":
        """Monocular SfM defaults (viso.cpp:1335-1337, 1365-1367)."""
        return PipelineConfig(
            detector=DetectorConfig(max_features=1500, descriptor_radius=9,
                                    num_slots=1536),
            stereo_match=MatchConfig(radius=10.0, use_epipolar=True,
                                     sampson_thresh=1.0, use_ratio=True,
                                     ratio=0.9),
            temporal_match=MatchConfig(radius=10.0),
        )
