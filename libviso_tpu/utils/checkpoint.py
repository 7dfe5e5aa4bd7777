"""Sequence checkpoint / resume (SURVEY.md §5.4).

The reference accumulates poses in memory and writes them once at the end
(src/kitti.cpp:111-116) — a crash loses the whole sequence and multi-hour
multi-sequence runs can't resume.  Here the stereo driver periodically
snapshots its full loop state: the per-frame motion/validity history, the
carried FrameState pytree (previous-frame keypoints/descriptors/3D), the
per-frame stats, and a config fingerprint so a resume with different
settings fails loudly instead of silently diverging.

Format: a single .npz per checkpoint (atomic rename), `ckpt_<frame>.npz`
in the checkpoint directory; `latest()` picks the highest frame.  The
FrameState pytree is flattened with jax.tree_util against the template from
``empty_state(cfg)``, so the layout tracks the pipeline automatically.

Resume is exact: RANSAC keys are derived per-frame as fold_in(key, t)
(pipeline/stereo.py), so a resumed run produces bit-identical motions to an
uninterrupted one — tested in tests/test_checkpoint.py.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
from typing import List, Optional

import numpy as np


def config_fingerprint(cfg, seed: int, scope: str = "") -> str:
    """Stable hash of everything that must match for a resume to be valid.

    ``scope`` identifies the input slice (e.g. the KITTI begin/end frame
    range): resuming with a shifted range would silently stitch motions
    across misaligned frames, so it must invalidate the checkpoint.
    """
    text = f"{cfg!r}|seed={seed}|scope={scope}"
    return hashlib.sha256(text.encode()).hexdigest()[:16]


@dataclasses.dataclass
class Checkpoint:
    next_frame: int            # first frame index NOT yet processed
    motions: np.ndarray        # (next_frame, 6)
    oks: np.ndarray            # (next_frame,) bool
    state_leaves: List[np.ndarray]  # flattened FrameState pytree
    stats: list                # per-frame dicts
    fingerprint: str


class CheckpointManager:
    """Own a checkpoint directory; save every `every` frames, resume latest."""

    _PAT = re.compile(r"^ckpt_(\d+)\.npz$")

    def __init__(self, directory: str, every: int = 100, keep: int = 2):
        self.directory = directory
        self.every = max(1, int(every))
        self.keep = max(1, int(keep))
        os.makedirs(directory, exist_ok=True)

    def _path(self, frame: int) -> str:
        return os.path.join(self.directory, f"ckpt_{frame:08d}.npz")

    def _frames_on_disk(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            m = self._PAT.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def save(self, ckpt: Checkpoint) -> str:
        path = self._path(ckpt.next_frame)
        tmp = path + ".tmp.npz"
        payload = {
            "next_frame": np.int64(ckpt.next_frame),
            "motions": np.asarray(ckpt.motions, np.float64),
            "oks": np.asarray(ckpt.oks, bool),
            "stats_json": np.frombuffer(
                json.dumps(ckpt.stats).encode(), dtype=np.uint8),
            "fingerprint": np.frombuffer(
                ckpt.fingerprint.encode(), dtype=np.uint8),
            "n_leaves": np.int64(len(ckpt.state_leaves)),
        }
        for i, leaf in enumerate(ckpt.state_leaves):
            payload[f"leaf_{i}"] = np.asarray(leaf)
        np.savez(tmp, **payload)
        os.replace(tmp, path)
        # prune old checkpoints beyond `keep`
        for f in self._frames_on_disk()[: -self.keep]:
            try:
                os.remove(self._path(f))
            except OSError:
                pass
        return path

    def latest(self) -> Optional[Checkpoint]:
        frames = self._frames_on_disk()
        if not frames:
            return None
        return self.load(self._path(frames[-1]))

    @staticmethod
    def load(path: str) -> Checkpoint:
        with np.load(path) as z:
            n = int(z["n_leaves"])
            return Checkpoint(
                next_frame=int(z["next_frame"]),
                motions=z["motions"],
                oks=z["oks"],
                state_leaves=[z[f"leaf_{i}"] for i in range(n)],
                stats=json.loads(bytes(z["stats_json"]).decode()),
                fingerprint=bytes(z["fingerprint"]).decode(),
            )
