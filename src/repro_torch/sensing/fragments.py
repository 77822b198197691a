"""Fragment dataset generation (paper §III-C step 1).

The port's own copy of ``repro.sensing.fragments`` (the port imports
nothing of ``repro``): the same numpy sampler, so one seed gives the same
fragments in both packages.

From a frame dataset with object masks, sample balanced positive fragments
(window contains an object center) and negative fragments (window is
object-free), matching the paper: "random sampling positive and negative
fragments from each frame ... it is also important to balance the number of
negative and positive samples."
"""

from __future__ import annotations

import numpy as np

Array = np.ndarray


def sample_fragments(frames, masks, *, h: int, w: int,
                     per_frame: int = 2, seed: int = 0
                     ) -> tuple[Array, Array]:
    """Balanced fragment dataset ``(frags (N,h,w), labels (N,))``.

    numpy-side (data pipeline, not jit) — runs once per training job.
    """
    frames = np.asarray(frames)
    masks = np.asarray(masks)
    rng = np.random.default_rng(seed)  # repro-lint: disable=RA002 (host-side training-data sampler, explicitly seeded; runs once per job, never under jit)
    H, W = frames.shape[1:]
    frags, labels = [], []

    for f, m in zip(frames, masks):
        ys, xs = np.nonzero(m > 0.5)
        has_obj = len(ys) > 0
        for _ in range(per_frame):
            if has_obj:
                # positive: window covering a random object pixel
                i = rng.integers(len(ys))
                cy = int(np.clip(ys[i] - rng.integers(h), 0, H - h))
                cx = int(np.clip(xs[i] - rng.integers(w), 0, W - w))
                window_mask = m[cy:cy + h, cx:cx + w]
                if window_mask.sum() > 0:
                    frags.append(f[cy:cy + h, cx:cx + w])
                    labels.append(1)
            # negative: rejection-sample an object-free window
            for _attempt in range(20):
                cy = int(rng.integers(0, H - h + 1))
                cx = int(rng.integers(0, W - w + 1))
                if masks is None or m[cy:cy + h, cx:cx + w].sum() == 0:
                    frags.append(f[cy:cy + h, cx:cx + w])
                    labels.append(0)
                    break

    frags = np.stack(frags).astype(np.float32)
    labels = np.asarray(labels, dtype=np.int32)

    # balance classes by subsampling the majority
    pos_idx = np.nonzero(labels == 1)[0]
    neg_idx = np.nonzero(labels == 0)[0]
    n = min(len(pos_idx), len(neg_idx))
    if n == 0:
        return frags, labels
    keep = np.concatenate([rng.permutation(pos_idx)[:n],
                           rng.permutation(neg_idx)[:n]])
    keep = rng.permutation(keep)
    return frags[keep], labels[keep]
