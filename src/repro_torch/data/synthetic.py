"""Procedural synthetic datasets: a numpy copy of the JAX package's
``data/synthetic.py``, so the port builds the same images and prompts as
the JAX package for the same seed.

Images (28x28, for the paper's experiments):
  * ``blood_cells``   -- 7 ID classes of textured-ellipse 'cells' with
    class-dependent radius / eccentricity / granularity / intensity,
    mimicking the BloodMNIST morphology axes, plus an 8th generator
    ('erythroblast') drawn from a held-out morphology for the OOD split.
  * ``glyphs``        -- 10 stroke-rendered digit-like classes (MNIST
    stand-in).
  * ``ambiguous``     -- convex pixel blends of two glyph classes (the
    Ambiguous-MNIST construction).
  * ``fashion_ood``   -- striped/checkered garment-like silhouettes,
    structurally unlike glyphs (epistemic OOD).

Tokens (for the LM architectures): a Zipf-weighted order-2 Markov chain
over the arch's vocabulary — deterministic given (seed, host, step), so
the stream is shardable across hosts and exactly resumable from a
checkpointed cursor.
"""

from __future__ import annotations

import dataclasses

import numpy as np

IMG = 28


# ---------------------------------------------------------------------------
# image primitives
# ---------------------------------------------------------------------------

def _grid():
    y, x = np.mgrid[0:IMG, 0:IMG].astype(np.float32)
    return (x - IMG / 2) / (IMG / 2), (y - IMG / 2) / (IMG / 2)


_X, _Y = _grid()

# per-class morphology: (radius, eccentricity, granularity, nucleus, hue)
_BLOOD_CLASSES = {
    0: (0.55, 1.00, 0.9, 0.35, 0.9),   # basophil: dark granular
    1: (0.60, 1.05, 0.7, 0.45, 0.7),   # eosinophil: bilobed
    2: (0.70, 0.95, 0.5, 0.60, 0.6),   # immature granulocyte: large
    3: (0.45, 1.00, 0.1, 0.80, 0.5),   # lymphocyte: big round nucleus
    4: (0.75, 0.90, 0.2, 0.50, 0.55),  # monocyte: kidney nucleus
    5: (0.60, 1.10, 0.6, 0.30, 0.65),  # neutrophil: multilobed
    6: (0.25, 1.00, 0.3, 0.00, 0.8),   # platelet: tiny fragment
    # held-out morphology -> epistemic OOD at prediction time
    7: (0.50, 1.30, 0.15, 0.95, 0.3),  # erythroblast: dense round nucleus,
                                        # strongly eccentric halo
}


def blood_cells(rng: np.random.Generator, n: int, classes=range(7)):
    """-> images (n, 3, 28, 28) float32 in [0,1], labels (n,)."""
    classes = list(classes)
    labels = rng.integers(0, len(classes), n)
    imgs = np.zeros((n, 3, IMG, IMG), np.float32)
    for i in range(n):
        c = classes[labels[i]]
        rad, ecc, gran, nuc, hue = _BLOOD_CLASSES[c]
        cx, cy = rng.uniform(-0.15, 0.15, 2)
        th = rng.uniform(0, np.pi)
        xr = (_X - cx) * np.cos(th) + (_Y - cy) * np.sin(th)
        yr = -(_X - cx) * np.sin(th) + (_Y - cy) * np.cos(th)
        r2 = (xr / (rad * ecc)) ** 2 + (yr / rad) ** 2
        body = np.clip(1.2 - r2, 0, 1)
        tex = gran * rng.standard_normal((IMG, IMG)).astype(np.float32)
        tex = np.clip(tex, -1, 1) * (body > 0)
        nucleus = nuc * np.clip(1.0 - r2 / (0.35 + 0.1 * nuc), 0, 1)
        base = 0.25 + 0.5 * body + 0.25 * tex
        img = np.stack([
            base * (1.0 - 0.5 * hue) + nucleus * 0.6,
            base * 0.8 + nucleus * 0.2,
            base * hue + nucleus * 0.7,
        ])
        img += 0.03 * rng.standard_normal(img.shape).astype(np.float32)
        imgs[i] = np.clip(img, 0, 1)
    return imgs, labels.astype(np.int32)


def blood_cells_ood(rng, n):
    imgs, _ = blood_cells(rng, n, classes=[7])
    return imgs, np.full((n,), -1, np.int32)


# digit-like strokes: each class = set of line segments in unit coords
_GLYPH_STROKES = {
    0: [(.3, .2, .7, .2), (.7, .2, .7, .8), (.7, .8, .3, .8), (.3, .8, .3, .2)],
    1: [(.5, .2, .5, .8), (.4, .3, .5, .2)],
    2: [(.3, .25, .7, .25), (.7, .25, .7, .5), (.7, .5, .3, .8), (.3, .8, .7, .8)],
    3: [(.3, .2, .7, .3), (.7, .3, .4, .5), (.4, .5, .7, .7), (.7, .7, .3, .8)],
    4: [(.6, .2, .3, .6), (.3, .6, .75, .6), (.6, .2, .6, .85)],
    5: [(.7, .2, .3, .2), (.3, .2, .3, .5), (.3, .5, .7, .6), (.7, .6, .3, .8)],
    6: [(.6, .2, .35, .5), (.35, .5, .35, .75), (.35, .75, .65, .75),
        (.65, .75, .65, .55), (.65, .55, .35, .55)],
    7: [(.3, .2, .7, .2), (.7, .2, .45, .8)],
    8: [(.5, .2, .7, .35), (.7, .35, .3, .6), (.3, .6, .5, .8),
        (.5, .8, .7, .6), (.7, .6, .3, .35), (.3, .35, .5, .2)],
    9: [(.65, .45, .35, .45), (.35, .45, .35, .25), (.35, .25, .65, .25),
        (.65, .25, .65, .8)],
}


def _render_strokes(strokes, rng, thick=0.08):
    img = np.zeros((IMG, IMG), np.float32)
    jit = rng.uniform(-0.05, 0.05, 4 * len(strokes))
    for si, (x0, y0, x1, y1) in enumerate(strokes):
        j = jit[4 * si:4 * si + 4]
        x0, y0, x1, y1 = x0 + j[0], y0 + j[1], x1 + j[2], y1 + j[3]
        ts = np.linspace(0, 1, 40)[:, None]
        pts = np.stack([x0 + (x1 - x0) * ts[:, 0],
                        y0 + (y1 - y0) * ts[:, 0]], 1) * IMG
        d2 = (np.arange(IMG)[None, :, None] - pts[:, 0]) ** 2 + \
             (np.arange(IMG)[:, None, None] - pts[:, 1]) ** 2
        img = np.maximum(img, np.exp(-d2.min(-1) /
                                     (2 * (thick * IMG) ** 2)))
    return img


def glyphs(rng: np.random.Generator, n: int):
    """MNIST stand-in: (n, 1, 28, 28) in [0,1], labels (n,)."""
    labels = rng.integers(0, 10, n)
    imgs = np.zeros((n, 1, IMG, IMG), np.float32)
    for i in range(n):
        img = _render_strokes(_GLYPH_STROKES[int(labels[i])], rng,
                              thick=rng.uniform(0.06, 0.1))
        img += 0.05 * rng.standard_normal((IMG, IMG)).astype(np.float32)
        imgs[i, 0] = np.clip(img, 0, 1)
    return imgs, labels.astype(np.int32)


def ambiguous_glyphs(rng: np.random.Generator, n: int):
    """Convex blends of two classes (the Ambiguous-MNIST construction).

    labels: the pair (a, b) packed as a*10+b — evaluation treats either
    constituent as 'correct' and expects HIGH SE, LOW MI.
    """
    a = rng.integers(0, 10, n)
    b = (a + rng.integers(1, 10, n)) % 10
    w = rng.uniform(0.35, 0.65, n).astype(np.float32)
    imgs = np.zeros((n, 1, IMG, IMG), np.float32)
    for i in range(n):
        ia = _render_strokes(_GLYPH_STROKES[int(a[i])], rng)
        ib = _render_strokes(_GLYPH_STROKES[int(b[i])], rng)
        img = w[i] * ia + (1 - w[i]) * ib
        img += 0.05 * rng.standard_normal((IMG, IMG)).astype(np.float32)
        imgs[i, 0] = np.clip(img, 0, 1)
    return imgs, (a * 10 + b).astype(np.int32)


def fashion_ood(rng: np.random.Generator, n: int):
    """Garment-like silhouettes (Fashion-MNIST stand-in): epistemic OOD."""
    imgs = np.zeros((n, 1, IMG, IMG), np.float32)
    for i in range(n):
        kind = rng.integers(0, 3)
        w, h = rng.uniform(0.4, 0.8, 2)
        mask = (np.abs(_X) < w / 1.4) & (np.abs(_Y) < h / 1.4)
        if kind == 0:      # striped shirt
            tex = 0.5 + 0.5 * np.sin(_Y * rng.uniform(8, 20))
        elif kind == 1:    # checkered bag
            tex = ((np.floor(_X * 6) + np.floor(_Y * 6)) % 2)
        else:              # trouser split
            mask &= np.abs(_X) > 0.12
            tex = np.full_like(_X, 0.8)
        img = mask * tex * rng.uniform(0.6, 1.0)
        img += 0.05 * rng.standard_normal((IMG, IMG)).astype(np.float32)
        imgs[i, 0] = np.clip(img, 0, 1)
    return imgs, np.full((n,), -1, np.int32)


# ---------------------------------------------------------------------------
# token streams
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TokenStreamState:
    """Exactly-resumable cursor for the synthetic LM stream."""
    seed: int
    host: int
    num_hosts: int
    step: int = 0


def token_batch(state: TokenStreamState, batch: int, seq: int,
                vocab: int) -> tuple[np.ndarray, TokenStreamState]:
    """Zipf-weighted order-2 Markov token stream, sharded per host.

    Deterministic in (seed, host, step) -- restarting from a checkpointed
    ``state`` regenerates the identical remaining stream.
    """
    rng = np.random.default_rng(
        (state.seed * 1_000_003 + state.host) * 1_000_003 + state.step)
    # stationary Zipf over a hashed permutation of the vocab
    ranks = 1.0 / np.arange(1, min(vocab, 4096) + 1) ** 1.1
    probs = ranks / ranks.sum()
    base = rng.choice(len(probs), size=(batch, seq), p=probs)
    # order-2 structure: every 3rd token is a deterministic mix of the
    # previous two (gives the model something learnable)
    toks = base.astype(np.int64)
    toks[:, 2::3] = (toks[:, 1::3][:, :toks[:, 2::3].shape[1]] * 31 +
                     toks[:, 0::3][:, :toks[:, 2::3].shape[1]] * 17) % \
        max(vocab // 7, 11)
    toks = toks % vocab
    new_state = dataclasses.replace(state, step=state.step + 1)
    return toks.astype(np.int32), new_state
