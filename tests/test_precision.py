"""Explicit matmul precision on the GPU-sensitive paths.

On a GPU, float32 products at Precision DEFAULT or HIGH run as TF32 (11
significant bits).  The one-hot descriptor gather is only exact, and the
l2 matcher's cancellation and the mono geometry only accurate, at full
float32, so these paths carry Precision.HIGHEST in their traced programs.
The CPU computes full f32 whatever the flag says, so these tests read the
jaxpr instead of the numbers.  The numerical checks on the card are chip_smoke.py phase 8
and the `gpu`-marked test below.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libviso_tpu.config import DetectorConfig
from libviso_tpu.ops.features import detect_harris_binned, extract_descriptors
from libviso_tpu.ops.matching import _l2_desc_dist


def _dot_precisions(jaxpr):
    """Precision params of every dot_general, sub-jaxprs included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in v if isinstance(v, (list, tuple)) else (v,):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    out.extend(_dot_precisions(inner))
    return out


def _image(h=96, w=240, seed=0):
    return jnp.asarray(np.random.default_rng(seed).integers(
        0, 256, (h, w)).astype(np.float32))


def test_onehot_gather_traces_at_highest():
    cfg = DetectorConfig(max_features=120, nbinx=6, nbiny=2, num_slots=128,
                         descriptor_gather="onehot")
    img = _image()
    kp = detect_harris_binned(img, cfg)
    for binned in (True, False):
        jp = jax.make_jaxpr(lambda im, k: extract_descriptors(
            im, k, cfg, binned_layout=binned))(img, kp)
        precs = _dot_precisions(jp.jaxpr)
        assert len(precs) >= 2, precs
        assert all(p == (jax.lax.Precision.HIGHEST,) * 2 for p in precs)


def test_l2_cross_term_traces_at_highest():
    d = jnp.ones((16, 128), jnp.float32)
    precs = _dot_precisions(jax.make_jaxpr(_l2_desc_dist)(d, d).jaxpr)
    assert precs == [(jax.lax.Precision.HIGHEST,) * 2]


def test_mono_step_traces_at_highest():
    """Every product of the mono step (5-point, RANSAC, pose refit, scale
    bundle) states Precision.HIGHEST: with TF32 products the card's mono
    trajectories drift off the CPU's, and no one of those groups at full
    f32 is enough to bring them back (geometry/essential.py)."""
    from libviso_tpu.config import MatchConfig, PipelineConfig
    from libviso_tpu.pipeline.mono import build_mono_step, empty_mono_state

    cfg = PipelineConfig(
        detector=DetectorConfig(max_features=120, nbinx=6, nbiny=2,
                                num_slots=128),
        temporal_match=MatchConfig(radius=60.0, use_ratio=True, ratio=0.9))
    K = np.array([[300.0, 0, 120], [0, 300.0, 48], [0, 0, 1]])
    step = build_mono_step(K, cfg)
    jp = jax.make_jaxpr(step)(empty_mono_state(cfg), _image(),
                              jax.random.PRNGKey(0))
    precs = _dot_precisions(jp.jaxpr)
    assert len(precs) > 10, len(precs)
    assert all(p == (jax.lax.Precision.HIGHEST,) * 2 for p in precs), set(
        precs)


@pytest.mark.gpu
def test_gathers_bitwise_equal_take_on_gpu(gpu_device):
    """Fractional (sharpened) input: every one-hot gather equals 'take'
    bitwise on the card (TF32 would round the selected values)."""
    from libviso_tpu.ops.features import unsharp_mask

    cfg = DetectorConfig()
    img = unsharp_mask(jax.device_put(_image(376, 1241), gpu_device),
                       3.0, 4.0)
    kp = detect_harris_binned(img, cfg)
    take = extract_descriptors(
        img, kp, dataclasses.replace(cfg, descriptor_gather="take"),
        binned_layout=True)
    onehot = dataclasses.replace(cfg, descriptor_gather="onehot")
    for binned in (True, False):
        got = extract_descriptors(img, kp, onehot, binned_layout=binned)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(take))
