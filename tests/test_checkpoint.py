"""Checkpoint / resume (SURVEY.md §5.4 — absent in the reference).

The contract under test: an interrupted stereo run resumed from its latest
checkpoint produces BIT-IDENTICAL motions/poses to an uninterrupted run
(per-frame RANSAC keys are fold_in(key, t), state is snapshotted exactly).
"""

import numpy as np
import pytest

from libviso_tpu.config import DetectorConfig, PipelineConfig, RansacConfig
from libviso_tpu.pipeline import run_stereo_sequence
from libviso_tpu.synthetic import generate_sequence
from libviso_tpu.utils.checkpoint import (
    Checkpoint,
    CheckpointManager,
    config_fingerprint,
)


@pytest.fixture(scope="module")
def tiny_cfg():
    return PipelineConfig(
        detector=DetectorConfig(max_features=120, nbinx=6, nbiny=2,
                                num_slots=128),
        ransac=RansacConfig(num_hypotheses=16, gn_iters=10),
    )


@pytest.fixture(scope="module")
def seq():
    return generate_sequence(num_frames=7, num_points=300, width=160,
                             height=96, f=120.0, seed=3)


def test_manager_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), every=5, keep=2)
    ck = Checkpoint(
        next_frame=10,
        motions=np.arange(60, dtype=np.float64).reshape(10, 6),
        oks=np.array([True] * 9 + [False]),
        state_leaves=[np.ones((3, 2), np.float32),
                      np.array([1, -1], np.int32)],
        stats=[{"frame": i, "ok": True} for i in range(10)],
        fingerprint="abc123",
    )
    mgr.save(ck)
    got = mgr.latest()
    assert got.next_frame == 10
    np.testing.assert_array_equal(got.motions, ck.motions)
    np.testing.assert_array_equal(got.oks, ck.oks)
    assert len(got.state_leaves) == 2
    np.testing.assert_array_equal(got.state_leaves[1], ck.state_leaves[1])
    assert got.stats[3] == {"frame": 3, "ok": True}
    assert got.fingerprint == "abc123"


def test_manager_prunes_old(tmp_path):
    mgr = CheckpointManager(str(tmp_path), every=1, keep=2)
    base = Checkpoint(next_frame=0, motions=np.zeros((0, 6)),
                      oks=np.zeros(0, bool), state_leaves=[], stats=[],
                      fingerprint="x")
    import dataclasses
    for f in (2, 4, 6, 8):
        mgr.save(dataclasses.replace(base, next_frame=f))
    assert mgr.latest().next_frame == 8
    import os
    assert len([n for n in os.listdir(tmp_path)
                if n.startswith("ckpt_")]) == 2


def test_resume_is_bit_exact(tmp_path, tiny_cfg, seq):
    """Full run vs run-interrupted-at-4 + resume: identical output."""
    full = run_stereo_sequence(seq.frames, seq.P1, seq.P2, tiny_cfg, seed=0)

    mgr = CheckpointManager(str(tmp_path / "ck"), every=2)
    # "interrupted" run: only the first 4 frames
    run_stereo_sequence(seq.frames[:4], seq.P1, seq.P2, tiny_cfg, seed=0,
                        checkpoint=mgr)
    assert mgr.latest().next_frame == 4

    resumed = run_stereo_sequence(seq.frames, seq.P1, seq.P2, tiny_cfg,
                                  seed=0, checkpoint=mgr)
    np.testing.assert_array_equal(resumed.motions, full.motions)
    np.testing.assert_array_equal(resumed.frame_ok, full.frame_ok)
    np.testing.assert_allclose(resumed.poses, full.poses, rtol=0, atol=0)
    assert [s["frame"] for s in resumed.stats] == list(range(len(seq.frames)))


def test_fingerprint_mismatch_raises(tmp_path, tiny_cfg, seq):
    mgr = CheckpointManager(str(tmp_path / "ck"), every=2)
    run_stereo_sequence(seq.frames[:3], seq.P1, seq.P2, tiny_cfg, seed=0,
                        checkpoint=mgr)
    with pytest.raises(ValueError, match="fingerprint"):
        run_stereo_sequence(seq.frames, seq.P1, seq.P2, tiny_cfg, seed=1,
                            checkpoint=mgr)


def test_completed_run_reruns_as_noop(tmp_path, tiny_cfg, seq):
    mgr = CheckpointManager(str(tmp_path / "ck"), every=100)
    first = run_stereo_sequence(seq.frames, seq.P1, seq.P2, tiny_cfg,
                                seed=0, checkpoint=mgr)
    # final snapshot was written even though every=100 > T
    assert mgr.latest().next_frame == len(seq.frames)
    again = run_stereo_sequence(seq.frames, seq.P1, seq.P2, tiny_cfg,
                                seed=0, checkpoint=mgr)
    np.testing.assert_array_equal(again.motions, first.motions)


def test_fingerprint_sensitivity(tiny_cfg):
    f0 = config_fingerprint(tiny_cfg, 0)
    assert f0 == config_fingerprint(tiny_cfg, 0)
    assert f0 != config_fingerprint(tiny_cfg, 1)
    assert f0 != config_fingerprint(tiny_cfg, 0, scope="00:0:None")
    assert f0 != config_fingerprint(PipelineConfig(), 0)


def test_resume_bit_exact_while_recovery_state_held(tmp_path, tiny_cfg,
                                                    seq):
    """Resume from a checkpoint taken WHILE dropout-recovery state is
    held (the frame before it failed, fail_age > 0 in the snapshot):
    the resumed run must still be bit-identical to the uninterrupted
    one — the held features and their age are part of the state tree."""
    import dataclasses

    keep = dataclasses.replace(tiny_cfg, keep_features_on_failure=True)
    frames = [(np.asarray(l), np.asarray(r)) for l, r in seq.frames]
    frames[3] = (np.zeros_like(frames[3][0]), np.zeros_like(frames[3][1]))

    full = run_stereo_sequence(frames, seq.P1, seq.P2, keep, seed=0)
    assert not full.frame_ok[3]  # the dropout fails...
    assert full.frame_ok[4]      # ...and the held state bridges it

    mgr = CheckpointManager(str(tmp_path / "ck"), every=2)
    # interrupt right after the failed frame: the every=2 snapshot at
    # next_frame=4 carries the held state with fail_age=1
    run_stereo_sequence(frames[:4], seq.P1, seq.P2, keep, seed=0,
                        checkpoint=mgr)
    assert mgr.latest().next_frame == 4

    resumed = run_stereo_sequence(frames, seq.P1, seq.P2, keep, seed=0,
                                  checkpoint=mgr)
    np.testing.assert_array_equal(resumed.motions, full.motions)
    np.testing.assert_array_equal(resumed.frame_ok, full.frame_ok)


def test_chunked_resume_bit_exact(tmp_path, tiny_cfg):
    """Chunked dispatch (chunk=3) + a checkpoint cadence (every=2) that is
    NOT a multiple of the chunk: boundaries falling inside a chunk defer
    the snapshot to the chunk end, multiple boundaries inside one chunk
    collapse to one snapshot, and a resume from a chunk-end frame is
    bit-identical to the chunk=1 no-checkpoint run (ADVICE r2 #3 — the
    cadence arithmetic in run_stereo_sequence's _run_buf)."""
    seq10 = generate_sequence(num_frames=10, num_points=300, width=160,
                              height=96, f=120.0, seed=3)
    full = run_stereo_sequence(seq10.frames, seq10.P1, seq10.P2, tiny_cfg,
                               seed=0)  # chunk=1, no checkpoint

    mgr = CheckpointManager(str(tmp_path / "ck"), every=2)
    # interrupted run: 6 frames = two full chunks.  every=2 boundaries at
    # t=2 (inside chunk [0,3)) and t=4,6 (inside chunk [3,6) — collapsed):
    # snapshots land at chunk ends 3 and 6 only.
    run_stereo_sequence(seq10.frames[:6], seq10.P1, seq10.P2, tiny_cfg,
                        seed=0, checkpoint=mgr, chunk=3)
    assert mgr.latest().next_frame == 6

    resumed = run_stereo_sequence(seq10.frames, seq10.P1, seq10.P2,
                                  tiny_cfg, seed=0, checkpoint=mgr,
                                  chunk=3)
    # resume covers frames 6-9: one chunk [6,9) + a 1-frame tail
    np.testing.assert_array_equal(resumed.motions, full.motions)
    np.testing.assert_array_equal(resumed.frame_ok, full.frame_ok)
    np.testing.assert_allclose(resumed.poses, full.poses, rtol=0, atol=0)
    assert [s["frame"] for s in resumed.stats] == list(range(10))
