"""CLI drivers (SURVEY.md C1/C3 glue): eval subcommand + arg wiring."""

import json

import numpy as np
import pytest

from libviso_tpu import cli
from libviso_tpu.io.kitti import save_poses_kitti


def _traj(T, step=1.0, drift=0.0):
    poses = [np.eye(4)]
    for i in range(1, T):
        p = poses[-1].copy()
        p[2, 3] += step
        p[0, 3] += drift
        poses.append(p)
    return np.stack(poses)


def test_eval_identical_trajectories(tmp_path, capsys):
    gt = _traj(20)
    est_p = str(tmp_path / "est.txt")
    gt_p = str(tmp_path / "gt.txt")
    save_poses_kitti(est_p, gt)
    save_poses_kitti(gt_p, gt)
    cli.main(["eval", est_p, gt_p])
    out = json.loads(capsys.readouterr().out)
    assert out["frames"] == 20
    assert out["ate_rmse_m"] == pytest.approx(0.0, abs=1e-9)
    assert out["rpe_trans_mean_m"] == pytest.approx(0.0, abs=1e-9)


def test_eval_detects_drift(tmp_path, capsys):
    gt = _traj(30)
    est = _traj(30, drift=0.1)
    est_p = str(tmp_path / "est.txt")
    gt_p = str(tmp_path / "gt.txt")
    save_poses_kitti(est_p, est)
    save_poses_kitti(gt_p, gt)
    cli.main(["eval", est_p, gt_p])
    out = json.loads(capsys.readouterr().out)
    assert out["ate_rmse_m"] > 0.5
    assert out["rpe_trans_mean_m"] == pytest.approx(0.1, rel=1e-6)


def test_eval_truncates_to_shorter(tmp_path, capsys):
    est_p = str(tmp_path / "est.txt")
    gt_p = str(tmp_path / "gt.txt")
    save_poses_kitti(est_p, _traj(10))
    save_poses_kitti(gt_p, _traj(15))
    cli.main(["eval", est_p, gt_p])
    assert json.loads(capsys.readouterr().out)["frames"] == 10


def test_eval_too_short_exits(tmp_path):
    est_p = str(tmp_path / "est.txt")
    gt_p = str(tmp_path / "gt.txt")
    save_poses_kitti(est_p, _traj(1))
    save_poses_kitti(gt_p, _traj(1))
    with pytest.raises(SystemExit):
        cli.main(["eval", est_p, gt_p])


def test_unknown_command_exits():
    with pytest.raises(SystemExit):
        cli.main(["nope"])


def test_eval_plot(tmp_path, capsys):
    est = _traj(25, drift=0.05)
    gt = _traj(25)
    est_p, gt_p = str(tmp_path / "e.txt"), str(tmp_path / "g.txt")
    save_poses_kitti(est_p, est)
    save_poses_kitti(gt_p, gt)
    plot = str(tmp_path / "traj.png")
    cli.main(["eval", est_p, gt_p, "--plot", plot])
    out = json.loads(capsys.readouterr().out)
    assert out["plot"] == plot
    import os
    assert os.path.getsize(plot) > 500


def test_cfg_flags_apply():
    """--metric/--hyp flags map onto the pipeline config."""
    import argparse

    p = argparse.ArgumentParser()
    cli._add_cfg_flags(p)
    from libviso_tpu.config import PipelineConfig

    args = p.parse_args(["--metric", "l2", "--hyp", "procrustes"])
    cfg = cli._apply_cfg_flags(PipelineConfig(), args)
    assert cfg.stereo_match.metric == "l2"
    assert cfg.temporal_match.metric == "l2"
    assert cfg.ransac.hypothesis_method == "procrustes"

    args = p.parse_args([])
    cfg = cli._apply_cfg_flags(PipelineConfig(), args)
    assert cfg == PipelineConfig()


def test_cfg_flags_detector_options():
    import argparse

    p = argparse.ArgumentParser()
    cli._add_cfg_flags(p)
    from libviso_tpu.config import PipelineConfig

    args = p.parse_args(["--subpixel", "--pyramid", "3", "--hyp", "gn"])
    cfg = cli._apply_cfg_flags(PipelineConfig(), args)
    assert cfg.detector.subpixel is True
    assert cfg.detector.pyramid_levels == 3
    assert cfg.ransac.hypothesis_method == "gn"  # explicit gn must stick


def test_cfg_flags_sharpen_options():
    """--sharpen/--sharpen-auto plumbing: explicit sigma, auto default
    (must protect, not no-op), and the contradictory --sharpen 0 rejected
    by config validation."""
    import argparse

    import pytest

    p = argparse.ArgumentParser()
    cli._add_cfg_flags(p)
    from libviso_tpu.config import PipelineConfig

    args = p.parse_args(["--sharpen", "2.5", "--sharpen-amount", "3"])
    cfg = cli._apply_cfg_flags(PipelineConfig(), args)
    assert cfg.detector.sharpen_sigma == 2.5
    assert cfg.detector.sharpen_amount == 3.0
    assert cfg.detector.sharpen_auto is False

    args = p.parse_args(["--sharpen-auto"])
    cfg = cli._apply_cfg_flags(PipelineConfig(), args)
    assert cfg.detector.sharpen_auto is True
    assert cfg.detector.sharpen_sigma == 3.0  # measured-best default

    args = p.parse_args(["--sharpen", "0", "--sharpen-auto"])
    with pytest.raises(ValueError, match="sharpen_auto"):
        cli._apply_cfg_flags(PipelineConfig(), args)


def test_serve_rejects_single_sequence(tmp_path, monkeypatch):
    """`serve` is the >=2-stream mode; one sequence must point at `kitti`."""
    monkeypatch.setenv("KITTI_HOME", str(tmp_path))
    with pytest.raises(SystemExit, match=">=2"):
        cli.main(["serve", "sha", "00"])


def test_serve_requires_kitti_home(monkeypatch):
    monkeypatch.delenv("KITTI_HOME", raising=False)
    with pytest.raises(SystemExit, match="KITTI_HOME"):
        cli.main(["serve", "sha", "00,01"])


def test_serve_rejects_mixed_shapes(tmp_path, monkeypatch):
    """Streams share one compiled program: mixed image shapes exit at the
    argv edge, before any compile."""
    import os

    from PIL import Image

    for name, (w, h) in (("aa", (64, 32)), ("bb", (80, 40))):
        base = tmp_path / "sequences" / name
        (base / "image_0").mkdir(parents=True)
        (base / "image_1").mkdir(parents=True)
        P = f"{100.0:.9e} 0 {w/2:.9e} 0 0 {100.0:.9e} {h/2:.9e} 0 0 0 1 0"
        (base / "calib.txt").write_text(f"P0: {P}\nP1: {P}\n")
        im = Image.fromarray(np.zeros((h, w), np.uint8))
        for k in range(2):
            im.save(base / "image_0" / f"{k:06d}.png")
            im.save(base / "image_1" / f"{k:06d}.png")
    monkeypatch.setenv("KITTI_HOME", str(tmp_path))
    with pytest.raises(SystemExit, match="share one image shape"):
        cli.main(["serve", "sha", "aa,bb"])


def test_synth_world_flag_selects_world_generator(monkeypatch, capsys):
    """--world / --world-loop pick the textured-world generators (the
    pipeline itself is stubbed: generator selection is what's under
    test)."""
    import libviso_tpu.pipeline as pl
    import libviso_tpu.synthetic_world as sw

    calls = []

    def fake_world(num_frames, seed, **kw):
        calls.append(("world", num_frames))
        from libviso_tpu.synthetic import generate_sequence

        return generate_sequence(num_frames=num_frames, num_points=20,
                                 width=64, height=32, seed=seed)

    def fake_plaza(num_frames, seed, **kw):
        calls.append(("plaza", num_frames))
        from libviso_tpu.synthetic import generate_sequence

        return generate_sequence(num_frames=num_frames, num_points=20,
                                 width=64, height=32, seed=seed)

    class _Res:
        def __init__(self, T):
            self.poses = np.tile(np.eye(4), (T, 1, 1))
            self.frame_ok = np.ones(T, bool)

    def fake_run(frames, P1, P2, cfg, **kw):
        return _Res(len(frames))

    monkeypatch.setattr(sw, "generate_world_sequence", fake_world)
    monkeypatch.setattr(sw, "generate_plaza_sequence", fake_plaza)
    monkeypatch.setattr(pl, "run_stereo_sequence", fake_run)

    cli.main(["synth", "--frames", "3", "--world"])
    out = json.loads(capsys.readouterr().out)
    assert out["frames"] == 3
    cli.main(["synth", "--frames", "4", "--world-loop"])
    json.loads(capsys.readouterr().out)
    assert calls == [("world", 3), ("plaza", 4)]


def test_run_summary_names_the_device(monkeypatch, capsys):
    """Every driver summary carries platform + device_kind, so a run that
    fell back to the CPU cannot pass for an accelerator run."""
    import libviso_tpu.pipeline as pl

    class _Res:
        def __init__(self, T):
            self.poses = np.tile(np.eye(4), (T, 1, 1))
            self.frame_ok = np.ones(T, bool)

    monkeypatch.setattr(pl, "run_stereo_sequence",
                        lambda frames, *a, **kw: _Res(len(frames)))
    cli.main(["synth", "--frames", "3"])
    out = json.loads(capsys.readouterr().out)
    assert out["platform"] == "cpu" and out["device_kind"]


def test_serve_rejects_chunk(tmp_path, monkeypatch):
    """serve dispatches per lockstep timestep; --chunk is rejected
    explicitly rather than silently ignored."""
    monkeypatch.setenv("KITTI_HOME", str(tmp_path))
    with pytest.raises(SystemExit, match="chunk"):
        cli.main(["serve", "sha", "00,01", "--chunk", "4"])


@pytest.mark.slow
def test_serve_pool_works_queue_through_slots(tmp_path, monkeypatch,
                                              capsys):
    """`serve --pool N` (round 4): three sequences through two slots —
    the finished slot is re-seeded with the queued sequence without
    recompiling, every sequence gets its poses/metrics written, and
    each stream's trajectory matches its solo run within the
    multistream f32-batching contract."""
    import json as _json
    import os

    from PIL import Image

    from libviso_tpu.config import (
        DetectorConfig,
        PipelineConfig,
        RansacConfig,
    )
    from libviso_tpu.pipeline import run_stereo_sequence
    from libviso_tpu.synthetic import generate_sequence

    lengths = {"aa": 5, "bb": 3, "cc": 4}
    seqs = {}
    for i, (name, T) in enumerate(lengths.items()):
        seq = generate_sequence(num_frames=T, num_points=300, seed=7 + i,
                                width=160, height=96, f=120.0)
        seqs[name] = seq
        base = tmp_path / "sequences" / name
        (base / "image_0").mkdir(parents=True)
        (base / "image_1").mkdir(parents=True)
        (base / "calib.txt").write_text(
            "P0: " + " ".join(f"{v:.9e}" for v in seq.P1.reshape(-1))
            + "\nP1: " + " ".join(f"{v:.9e}"
                                  for v in seq.P2.reshape(-1)) + "\n")
        for k, (l, r) in enumerate(seq.frames):
            Image.fromarray(np.asarray(l).astype(np.uint8)).save(
                base / "image_0" / f"{k:06d}.png")
            Image.fromarray(np.asarray(r).astype(np.uint8)).save(
                base / "image_1" / f"{k:06d}.png")
    monkeypatch.setenv("KITTI_HOME", str(tmp_path))

    cli.main(["serve", "poolsha", "aa,bb,cc", "--pool", "2"])
    out = _json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["pool"] == 2 and out["streams"] == 3
    cfg = PipelineConfig()
    for i, (name, T) in enumerate(lengths.items()):
        row = out["sequences"][i]
        assert row["sequence"] == name
        assert row["frames"] == T
        assert row["solved"] == T - 1, row
        assert os.path.exists(row["poses"])
        # the pooled stream must match its solo run (seed contract:
        # stream i uses seed 0 + i) within f32 batching noise
        solo = run_stereo_sequence(
            [(np.asarray(l, np.float32), np.asarray(r, np.float32))
             for l, r in _png_frames(tmp_path, name, T)],
            seqs[name].P1, seqs[name].P2, cfg, seed=i)
        poses = np.loadtxt(row["poses"]).reshape(-1, 3, 4)
        np.testing.assert_allclose(poses, solo.poses[:, :3, :],
                                   rtol=0, atol=5e-5)


def _png_frames(root, name, T):
    from PIL import Image

    base = root / "sequences" / name
    out = []
    for k in range(T):
        out.append((np.asarray(Image.open(base / "image_0"
                                          / f"{k:06d}.png")),
                    np.asarray(Image.open(base / "image_1"
                                          / f"{k:06d}.png"))))
    return out


def test_health_alarm_flags_plumb_to_summary(tmp_path, monkeypatch,
                                             capsys):
    """The --support-ratio-alarm / --motion-jump-alarm thresholds must
    reach the run-level health summary (VERDICT r4 #4): with absurdly
    strict thresholds, a perfectly healthy mini run trips BOTH alarms."""
    import json
    import os

    import numpy as np
    from PIL import Image

    from libviso_tpu import cli
    from libviso_tpu.synthetic import generate_sequence

    seq = generate_sequence(num_frames=4, num_points=300, width=160,
                            height=96, f=120.0, seed=3)
    base = tmp_path / "sequences" / "55"
    (base / "image_0").mkdir(parents=True)
    (base / "image_1").mkdir(parents=True)
    (base / "calib.txt").write_text(
        "P0: " + " ".join(f"{v:.9e}" for v in seq.P1.reshape(-1)) + "\n"
        + "P1: " + " ".join(f"{v:.9e}" for v in seq.P2.reshape(-1))
        + "\n")
    for i, (l, r) in enumerate(seq.frames):
        Image.fromarray(np.asarray(l).astype(np.uint8)).save(
            base / "image_0" / f"{i:06d}.png")
        Image.fromarray(np.asarray(r).astype(np.uint8)).save(
            base / "image_1" / f"{i:06d}.png")
    monkeypatch.setenv("KITTI_HOME", str(tmp_path))

    cli.main(["kitti", "hsha", "55",
              "--support-ratio-alarm", "1.5",
              "--motion-jump-alarm", "0.0"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out["health"]["alarms"]) == {"support_ratio",
                                            "motion_jump"}

    cli.main(["kitti", "hsha2", "55"])  # defaults: healthy run, silent
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["health"]["alarms"] == []
