"""Monocular calibrated SfM / visual odometry pipeline (SURVEY.md C3).

The reference's ``calibratedSFM`` (src/viso.cpp:1332-1398) detects Harris
corners (radius 9, 1500 features), matches consecutive frames within a
10 px radius, estimates an essential matrix, re-matches under the induced
epipolar gate — and then stops, leaving P1/P2 at identity forever
(src/viso.cpp:1393-1395).  This module completes the capability: pose
recovery by cheirality voting, and **relative-scale propagation** so the
chained trajectory is correct up to ONE global scale (monocular VO cannot
observe absolute scale, but the scale RATIO between consecutive steps is
observable through landmarks shared by both steps).

Scale propagation (VERDICT r1 #3): each essential-matrix step recovers a
unit-norm translation.  Landmarks seen in three consecutive frames are
triangulated twice — once by step t-1 (depth in camera t-1, in units of
step t-1's baseline) and once by step t (depth in the SAME camera t-1, in
units of step t's unit baseline).  The true step-t scale, in step t-1
units, is the robust median of the depth ratios; the host chains the
running product.  Frames with too little three-view support fall back to
carrying the previous speed (constant-velocity), which is also the round-1
behavior when propagation is disabled.

Note the reference reads the principal point from K(0,3)/K(1,3), an
out-of-bounds access on a 3x3 K (src/viso.cpp:1347, SURVEY.md §3.2); we
read K(0,2)/K(1,2).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, NamedTuple

import functools

import jax
import jax.numpy as jnp
import numpy as np

from libviso_tpu.config import MonoConfig, PipelineConfig
from libviso_tpu.geometry.essential import (
    depth_log_grads,
    normalize_points,
    pnp_refine_pose,
    ransac_essential,
    recover_pose,
    refine_relative_pose,
    three_view_bundle,
    two_view_depths,
    undistort_points,
)
from libviso_tpu.geometry.mvg import e2h
from libviso_tpu.utils.stats import masked_median, masked_quantile
from libviso_tpu.ops.features import Keypoints, detect_and_describe
from libviso_tpu.ops.matching import match_descriptors


class MonoState(NamedTuple):
    kp: Keypoints
    desc: jax.Array
    # landmark depth per keypoint slot in THIS frame's camera, in units of
    # the step that produced it (unit-norm translation); feeds the next
    # step's scale-ratio estimate
    depth: jax.Array        # (N,) float
    depth_valid: jax.Array  # (N,) bool
    # sin(triangulation angle) of the pair that produced `depth`: gates
    # scale evidence on well-conditioned landmarks in BOTH pairs
    parallax: jax.Array     # (N,) float
    # d log(depth) / d (5-dof pose error of the producing pair)
    # (essential.py::depth_log_grads): covariates for the 'regression'
    # scale estimator, which separates the true inter-step scale from
    # both pairs' residual pose-error depth warps
    depth_grad: jax.Array   # (N, 5) float
    # the producing pair's OTHER observation (normalized coords in the
    # frame before this one) and its pose: the 'bundle' estimator
    # re-optimizes the full three-view geometry from raw observations
    obs_prev: jax.Array     # (N, 2) float
    R_pair: jax.Array       # (3, 3) float
    t_pair: jax.Array       # (3,) float, |t| = 1
    # consecutive solves failed while this state was HELD as the match
    # target (cfg.keep_features_on_failure; always 0 otherwise)
    fail_age: jax.Array     # () int32


class MonoOutput(NamedTuple):
    transform: jax.Array   # (4, 4) current -> previous camera (unit-norm t)
    ok: jax.Array          # () bool
    num_matches: jax.Array
    num_inliers: jax.Array
    # step-t translation scale in units of step t-1's translation:
    # median depth ratio over landmarks shared by both steps (inf when
    # support is empty; host gates on scale_support)
    scale_ratio: jax.Array    # () float
    scale_support: jax.Array  # () int32
    # mean Harris response over detected corners — the defocus health
    # signal (same semantics as stereo FrameOutput.sharpness; the mono
    # solver flags are consistency checks too, docs/realism.md)
    sharpness: jax.Array      # () float
    # frames this transform SPANS: 1 normally; 1 + held-failure count
    # when keep_features_on_failure bridged a dropout.  The host uses it
    # for the constant-velocity scale fallback when the spanning step's
    # ratio evidence is too thin (a unit-speed scale on a multi-frame
    # translation would silently under-advance the trajectory).
    span: jax.Array           # () int32


def empty_mono_state(cfg: PipelineConfig, dtype=jnp.float32) -> MonoState:
    n = cfg.detector.num_slots
    d = cfg.detector.descriptor_dim_padded
    kp = Keypoints(xy=jnp.zeros((n, 2), dtype),
                   response=jnp.zeros((n,), dtype),
                   valid=jnp.zeros((n,), bool))
    return MonoState(kp=kp, desc=jnp.zeros((n, d), dtype),
                     depth=jnp.zeros((n,), dtype),
                     depth_valid=jnp.zeros((n,), bool),
                     parallax=jnp.zeros((n,), dtype),
                     depth_grad=jnp.zeros((n, 5), dtype),
                     obs_prev=jnp.zeros((n, 2), dtype),
                     R_pair=jnp.eye(3, dtype=dtype),
                     t_pair=jnp.array([0.0, 0.0, 1.0], dtype),
                     fail_age=jnp.zeros((), jnp.int32))




def _pair_parallax(R, x1, x2):
    """sin(triangulation angle) per correspondence: the angle between the
    camera-2 ray and the camera-1 ray rotated into camera 2.  Depth from a
    two-view pair is hypersensitive to the translation-direction estimate
    when this angle is small (points near the focus of expansion), so
    scale evidence is gated on it."""
    h1 = e2h(x1)
    h2 = e2h(x2)
    r1 = jnp.einsum("ij,nj->ni", R, h1, precision="highest")
    r1 = r1 / jnp.linalg.norm(r1, axis=-1, keepdims=True)
    r2 = h2 / jnp.linalg.norm(h2, axis=-1, keepdims=True)
    return jnp.linalg.norm(jnp.cross(r2, r1), axis=-1)


def build_mono_step(K, cfg: PipelineConfig, mono: MonoConfig = None, D=None,
                    # legacy kwargs (pre-MonoConfig callers)
                    num_hypotheses=None, sampson_thresh=None, method=None):
    """Jittable mono frame step.

    Pipeline per frame (reference order, completed):
      detect/describe -> short-radius temporal match (viso.cpp:1365-1367)
      -> normalize via K^-1 (viso.cpp:1382-1383)
      -> batched-RANSAC essential matrix: Nister 5-point by default
         (exact findEssentialMat parity, geometry/five_point.py) or 8pt
      -> epipolar re-match with the induced gate (viso.cpp:1386-1390)
      -> re-estimate E on the re-matched set -> recover (R, t) [new]
      -> shared-landmark depth ratios vs the previous step [new]

    Thresholds live in ``MonoConfig`` (config.py); the legacy kwargs
    override individual fields for older call sites.
    """
    mono = mono or MonoConfig()
    if sampson_thresh is not None:
        mono = dataclasses.replace(mono, sampson_thresh=sampson_thresh)
    if method is not None:
        mono = dataclasses.replace(mono, method=method)
    if num_hypotheses is not None:
        mono = dataclasses.replace(mono, num_hypotheses=num_hypotheses)
    n_hyp = mono.resolved_hypotheses()
    K = np.asarray(K, np.float64)
    Kj = jnp.asarray(K, jnp.float32)
    Dj = None if D is None else jnp.asarray(D, jnp.float32)

    def _norm(x):
        if Dj is None:
            return normalize_points(x, Kj)
        return undistort_points(x, Kj, Dj)
    # F = K^-T E K^-1 (viso.cpp:1385) for the pixel-space epipolar re-match
    Kinv = np.linalg.inv(K)

    def step(state: MonoState, im, key):
        kp, d = detect_and_describe(im, cfg.detector)
        m = match_descriptors(kp, d, state.kp, state.desc,
                              cfg.temporal_match)

        n_slots = cfg.detector.num_slots
        idx_safe = jnp.clip(m.idx, 0, n_slots - 1)
        x_cur = kp.xy                          # (N, 2) current pixels
        x_prev = state.kp.xy[idx_safe]         # matched previous pixels

        xn_cur = _norm(x_cur)
        xn_prev = _norm(x_prev)

        k1, k2 = jax.random.split(key)
        # est1 only feeds the epipolar re-match gate (its E -> F) and a
        # sanity flag; the pose comes from est2 on the re-matched set —
        # MonoConfig.first_pass='8pt' swaps in the cheaper solver here
        fp_method = (mono.method if mono.first_pass == "same"
                     else mono.first_pass)
        fp_hyp = (n_hyp if fp_method == mono.method
                  else dataclasses.replace(
                      mono, method=fp_method).resolved_hypotheses())
        est1 = ransac_essential(k1, xn_cur, xn_prev, valid=m.valid,
                                num_hypotheses=fp_hyp,
                                sampson_thresh=mono.sampson_thresh,
                                method=fp_method,
                                scoring=mono.scoring,
                                soft_refit=mono.soft_refit)

        # epipolar re-match under the induced fundamental matrix
        F = jnp.matmul(jnp.matmul(jnp.asarray(Kinv.T, jnp.float32), est1.E,
                                  precision="highest"),
                       jnp.asarray(Kinv, jnp.float32), precision="highest")
        rematch_cfg = dataclasses.replace(
            cfg.stereo_match, radius=cfg.temporal_match.radius,
            use_epipolar=True, use_ratio=True, ratio=mono.rematch_ratio,
            metric=cfg.temporal_match.metric)
        m2 = match_descriptors(kp, d, state.kp, state.desc, rematch_cfg,
                               F=F)
        idx2_safe = jnp.clip(m2.idx, 0, n_slots - 1)
        xn_cur2 = _norm(kp.xy)
        xn_prev2 = _norm(state.kp.xy[idx2_safe])

        est2 = ransac_essential(k2, xn_cur2, xn_prev2, valid=m2.valid,
                                num_hypotheses=n_hyp,
                                sampson_thresh=mono.sampson_thresh,
                                method=mono.method,
                                scoring=mono.scoring,
                                soft_refit=mono.soft_refit)

        R, t, good, n_good = recover_pose(est2.E, xn_cur2, xn_prev2,
                                          valid=est2.inliers)
        if mono.refine_iters > 0:
            # ML polish of (R, t): the linear refit's algebraic cost
            # leaves the translation direction degrees off at small
            # baselines, which biases every shared-landmark depth and
            # thus the scale ratio (geometry/essential.py).
            w_ref = (est2.inliers & good & m2.valid).astype(xn_cur2.dtype)
            R, t = refine_relative_pose(R, t, xn_cur2, xn_prev2, w_ref,
                                        iters=mono.refine_iters)
            z1r, z2r = two_view_depths(R, t, xn_cur2, xn_prev2)
            good = (z1r > 0) & (z2r > 0) & m2.valid
            n_good = jnp.sum((good & est2.inliers).astype(jnp.int32))
        ok = est1.ok & est2.ok & (n_good >= mono.min_good)

        # --- relative-scale evidence (three-view depth ratios) ---
        # recover_pose convention here: x1 = cur, x2 = prev, so z_cur is
        # the landmark depth in the CURRENT camera and z_prev in the
        # PREVIOUS camera — both in units of this step's unit baseline.
        z_cur, z_prev = two_view_depths(R, t, xn_cur2, xn_prev2)
        par = _pair_parallax(R, xn_cur2, xn_prev2)
        pts_good = good & est2.inliers & m2.valid
        prev_depth = state.depth[idx2_safe]
        prev_dv = state.depth_valid[idx2_safe] & m2.valid
        ratio = prev_depth / jnp.maximum(z_prev, 1e-9)
        rv_all = (pts_good & prev_dv & (z_prev > 1e-6)
                  & jnp.isfinite(ratio) & (ratio > 1e-2) & (ratio < 1e2))
        # Parallax gate: keep the best-conditioned landmarks — those whose
        # triangulation angle is large in BOTH the producing and the
        # current pair.  Low-parallax (near-FOE) depths magnify the
        # residual translation-direction error into the ratio.
        cond = jnp.minimum(state.parallax[idx2_safe], par)
        thresh = masked_quantile(cond, rv_all,
                                  1.0 - mono.parallax_keep_frac)
        rv = rv_all & (cond >= thresh)
        scale_support = jnp.sum(rv.astype(jnp.int32))
        # Robust location of log-ratio: median seed, then MAD-gated IRLS
        # mean.  A plain median is attenuated toward ratio=1 by false
        # matches (a random landmark pair's depth ratio centers at 1);
        # the MAD gate drops that diffuse contamination while the tight
        # cluster of true three-view tracks keeps full weight.
        y_log = jnp.log(jnp.clip(ratio, 1e-3, 1e3))
        mu = jnp.log(jnp.clip(masked_median(ratio, rv), 1e-3, 1e3))
        for _ in range(4):  # static unroll
            mad = masked_median(jnp.abs(y_log - mu), rv)
            c = jnp.maximum(3.0 * 1.4826 * mad, 0.02)
            w_s = rv.astype(y_log.dtype) * (jnp.abs(y_log - mu) <= c)
            mu = jnp.sum(w_s * y_log) / jnp.maximum(jnp.sum(w_s), 1.0)

        g1, g2 = depth_log_grads(R, t, xn_cur2, xn_prev2)  # (N, 5) each
        if mono.scale_estimator == "median":
            scale_ratio = jnp.exp(mu)
        elif mono.scale_estimator == "bundle":
            # Three-view bundle (essential.py::three_view_bundle): the
            # ML estimator — ratio-based estimators inherit the
            # errors-in-variables depth dilution (each two-view depth is
            # shrunk by ~sigma^2/parallax^2, biasing every ratio toward
            # 1 by 10-20% on slow steps; measured).  Frame t-1 anchors
            # the tracks; pair-1 pose is refined on its 5-dof manifold
            # (gauge |t1| = 1 = the previous step's baseline) and pair-2
            # translation is FREE — |t2| is the scale ratio.
            z0 = jnp.where(prev_dv, jnp.maximum(prev_depth, 1e-3),
                           jnp.maximum(z_prev, 1e-3) * jnp.exp(mu))
            _, _, R_b, t_b, _ = three_view_bundle(
                state.R_pair, state.t_pair, state.obs_prev[idx2_safe],
                R, t * jnp.exp(mu), xn_prev2, xn_cur2, z0,
                rv_all.astype(y_log.dtype), iters=mono.bundle_iters)
            s_b = jnp.linalg.norm(t_b)
            # the bundle also sharpens the step pose: keep its direction
            support_all = jnp.sum(rv_all.astype(jnp.int32))
            bundle_ok = jnp.isfinite(s_b) & (s_b > 1e-6) & (
                support_all >= 12)
            R = jnp.where(bundle_ok, R_b, R)
            t = jnp.where(bundle_ok,
                          t_b / jnp.maximum(s_b, 1e-12), t)
            scale_ratio = jnp.where(bundle_ok, s_b, jnp.exp(mu))
        elif mono.scale_estimator == "regression":
            # Warp-aware robust regression (config.py rationale): to first
            # order  y_i = log s + g_prev_i . d_{t-1} - g_cur_i . d_t
            # where d_* are the two pairs' residual 5-dof pose errors and
            # g_* the analytic depth-log gradients.  A plain median
            # absorbs the field AVERAGE of both warp terms (percent-level
            # per pair); fitting them out leaves log s unbiased.  Ridge on
            # the 10 pose-error coefficients (none on log s) keeps the
            # 11x11 solve stable when support is thin or fields are flat.
            prev_grad = state.depth_grad[idx2_safe]        # (N, 5)
            A = jnp.concatenate(
                [jnp.ones_like(y_log)[:, None], prev_grad, -g2], axis=1)
            beta = jnp.zeros((11,), y_log.dtype).at[0].set(mu)
            ridge = jnp.ones((11,), y_log.dtype).at[0].set(0.0)
            for _ in range(4):  # static unroll; MAD-gated IRLS
                r = y_log - A @ beta
                mad = masked_median(jnp.abs(r), rv)
                c = jnp.maximum(3.0 * 1.4826 * mad, 0.02)
                w_s = rv.astype(y_log.dtype) * (jnp.abs(r) <= c)
                Aw = A * w_s[:, None]
                H = jnp.matmul(A.T, Aw, precision="highest")
                lam = 1e-3 * jnp.trace(H) / 11.0 + 1e-9
                H = H + lam * jnp.diag(ridge)
                b = jnp.einsum("ni,n->i", Aw, y_log)
                cand = jnp.linalg.solve(H, b)
                beta = jnp.where(jnp.all(jnp.isfinite(cand)), cand, beta)
            scale_ratio = jnp.exp(beta[0])
        else:  # 'pnp'
            # Motion-only PnP on the previous pair's landmarks: |t| of the
            # optimum IS the step scale in previous-step units
            # (essential.py::pnp_refine_pose).  Seeded at the median
            # ratio; reprojection weighting de-emphasizes near-FOE points
            # natively, so the un-trimmed support set is used.
            X_prev = prev_depth[:, None] * e2h(xn_prev2)
            _, tp = pnp_refine_pose(R, t * jnp.exp(mu), X_prev, xn_cur2,
                                    rv_all.astype(y_log.dtype),
                                    iters=mono.pnp_iters)
            scale_ratio = jnp.linalg.norm(tp)

        if mono.scale_estimator == "bundle":
            # the bundle may have moved (R, t): refresh the per-slot
            # quantities the NEXT step will consume
            z_cur, z_prev = two_view_depths(R, t, xn_cur2, xn_prev2)
            par = _pair_parallax(R, xn_cur2, xn_prev2)
            g1, _ = depth_log_grads(R, t, xn_cur2, xn_prev2)
            pts_good = ((z_cur > 0) & (z_prev > 0) & est2.inliers
                        & m2.valid)

        # transform maps current-camera points to previous-camera points:
        # exactly the pose_{k-1 <- k} factor chained by the host loop.
        T = jnp.zeros((4, 4), R.dtype).at[:3, :3].set(R)
        T = T.at[:3, 3].set(t).at[3, 3].set(1.0)

        # scale evidence is only valid if THIS step was accepted: the
        # host never multiplies a failed step's ratio into the running
        # speed, so depths stored in a failed step's unit-baseline units
        # would make the NEXT ratio wrong by one step factor (the chain
        # must break at failed frames and fall back to constant velocity)
        new_state = MonoState(
            kp=kp, desc=d,
            depth=jnp.where(pts_good, z_cur, 0.0),
            depth_valid=pts_good & (z_cur > 1e-6) & ok,
            parallax=jnp.where(pts_good, par, 0.0),
            depth_grad=jnp.where(pts_good[:, None], g1, 0.0),
            obs_prev=jnp.where(pts_good[:, None], xn_prev2, 0.0),
            R_pair=R, t_pair=t,
            fail_age=jnp.zeros((), jnp.int32))
        if cfg.keep_features_on_failure:
            # dropout recovery, the stereo step's scheme.  Scale
            # semantics hold: the host's speed chain already breaks at
            # failed frames, and the held state's depths stay in their
            # own good pair's units for the next accepted step's ratio.
            from libviso_tpu.pipeline.stereo import hold_state_on_failure

            new_state = hold_state_on_failure(
                state, new_state, ok, jnp.any(state.kp.valid),
                cfg.max_keep_age)
        n_kp = jnp.sum(kp.valid.astype(jnp.int32))
        return new_state, MonoOutput(
            transform=T, ok=ok,
            num_matches=jnp.sum(m.valid.astype(jnp.int32)),
            num_inliers=est2.num_inliers,
            scale_ratio=scale_ratio, scale_support=scale_support,
            sharpness=(jnp.sum(jnp.where(kp.valid, kp.response, 0.0))
                       / jnp.maximum(n_kp, 1)),
            span=state.fail_age + 1)

    return step


def build_mono_chunk(K, cfg: PipelineConfig, chunk: int,
                     mono: MonoConfig = None,
                     method: str = None):
    """``chunk`` consecutive mono steps as ONE dispatch (`lax.scan` of
    the per-frame step) — the mono analog of
    pipeline/stereo.py::build_frame_chunk.  Per-frame semantics are
    untouched (the scan body IS build_mono_step with the state threaded
    through), so outputs are bitwise identical to ``chunk`` separate
    step calls; only the dispatch granularity changes.

    Returns chunk_step(state, ims, keys) -> (state, MonoOutput stacked
    over the leading chunk axis); ims is (chunk, H, W), keys a
    (chunk,)-stacked PRNG key array.
    """
    kw = {} if method is None else {"method": method}
    step = build_mono_step(K, cfg, mono=mono, **kw)

    def chunk_step(state: MonoState, ims, keys):
        def body(st, xs):
            im, k = xs
            st, out = step(st, im, k)
            return st, out

        return jax.lax.scan(body, state, (ims, keys))

    return chunk_step


@dataclasses.dataclass
class MonoResult:
    poses: np.ndarray     # (T, 4, 4) up-to-one-global-scale (with
    #                       propagation) or unit-step (without)
    frame_ok: np.ndarray
    stats: list
    speeds: np.ndarray = None   # (T,) per-step translation norms applied



@functools.lru_cache(maxsize=8)
def _jitted_mono_step(k_bytes: bytes, cfg, mono, D):
    """One jitted mono step per configuration (repeat calls skip the
    recompile; see stereo.py::_jitted_step)."""
    K = np.frombuffer(k_bytes, np.float64).reshape(3, 3)
    return jax.jit(build_mono_step(K, cfg, mono=mono,
                                   D=D))

def run_mono_sequence(frames: Iterable, K,
                      cfg: PipelineConfig = None,
                      seed: int = 0,
                      mono: MonoConfig = None,
                      method: str = None, D=None) -> MonoResult:
    """Host driver for the monocular pipeline (calib_sfm.cpp analog).

    ``D``: optional (k1, k2, p1, p2) lens distortion; None matches the
    reference's empty-distortion undistortPoints call (viso.cpp:1382).
    With ``mono.scale_propagation`` (default) per-step speeds chain by
    the shared-landmark depth-ratio estimate; the trajectory is then
    correct up to one global scale factor instead of assuming constant
    speed.
    """
    if cfg is None:
        cfg = PipelineConfig.mono()
    mono = mono or MonoConfig()
    if method is not None:
        mono = dataclasses.replace(mono, method=method)
    step = _jitted_mono_step(
        np.ascontiguousarray(K, np.float64).tobytes(), cfg, mono,
        None if D is None else tuple(float(d) for d in D))
    key = jax.random.PRNGKey(seed)

    state = empty_mono_state(cfg)
    # collect device outputs as futures; materializing per frame would
    # cost a host round-trip each step and serialize the dispatch pipeline
    outs = []
    for t, im in enumerate(frames):
        state, out = step(state, jnp.asarray(im), jax.random.fold_in(key, t))
        outs.append(out)

    poses, oks, speeds, stats = chain_mono_outputs(outs, mono)
    return MonoResult(poses=poses, frame_ok=oks, stats=stats,
                      speeds=speeds)


def chain_mono_outputs(outs, mono: MonoConfig):
    """Chain per-frame MonoOutputs into a trajectory on the host.

    The scale-propagation chain of ``run_mono_sequence`` factored out so
    other drivers (the Sim(3) loop back-end, pipeline/mono_loop.py) can
    reuse it unchanged.  Returns ``(poses (T,4,4), frame_ok (T,),
    speeds (T,), stats list)``; ``speeds[t]`` is the translation
    magnitude applied at step t (0 on failed frames) — also the unit
    conversion for step t's landmark depths (MonoState.depth is in
    units of the step's unit-norm baseline).
    """
    pose = np.eye(4)
    speed = 1.0
    poses, oks, stats, speeds = [], [], [], []
    # `speed` is the last ACCEPTED pair's translation magnitude (the
    # quantity scale ratios chain against); `last_span` is how many
    # frames that pair spanned (1 unless dropout recovery bridged a
    # gap).  The constant-velocity fallback estimates per-frame speed
    # as speed/last_span and covers all `span` frames of this step —
    # a single-step speed on a multi-frame translation would silently
    # under-advance the trajectory (dropout-recovery scale bug).
    last_span = 1
    for t, out in enumerate(outs):
        ok = bool(out.ok) and t > 0
        support = int(out.scale_support)
        ratio = float(out.scale_ratio)
        span = int(out.span)
        if (mono.scale_propagation and ok
                and support >= mono.min_scale_support
                and np.isfinite(ratio) and 1e-2 < ratio < 1e2):
            # measured: the ratio compares this transform against the
            # held pair, so it already carries any multi-frame span
            scale_t = speed * ratio
        else:
            scale_t = speed * span / last_span
        if ok:
            T = np.asarray(out.transform)
            T = T.copy()
            T[:3, 3] *= scale_t
            pose = pose @ T
            speed = scale_t
            last_span = span
        poses.append(pose.copy())
        oks.append(ok)
        speeds.append(scale_t if ok else 0.0)
        stats.append({
            "frame": t, "ok": ok,
            "num_matches": int(out.num_matches),
            "num_inliers": int(out.num_inliers),
            "scale_support": support,
            "scale_ratio": ratio if np.isfinite(ratio) else None,
            "speed": speed if ok else None,
            "span": span,
            "sharpness": float(out.sharpness),
        })
    return (np.stack(poses), np.asarray(oks, bool),
            np.asarray(speeds), stats)
