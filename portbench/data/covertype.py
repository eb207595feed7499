"""Frozen synthetic twin of UCI Covertype (Blackard & Dean, 1998).

Same schema as the UCI file ``covtype.data``: 581,012 rows of 54 columns
in the file's order, the 10 integer-valued cartographic columns, then the
one-hot ``Wilderness_Area`` (4) and ``Soil_Type`` (40) groups of 0/1 with
exactly one 1 in each group a row, and 7 cover types with the file's
published counts (scaled to ``m``, exact at 581,012).  Every column comes
back as a float32 array.

Features are drawn by class from distributions that overlap.  Like the
file's 30 m cells, which come in stands, the rows of a class lie in its
share of ``PATCHES`` stands, each stand's centre a draw of the class's
normals (``NUMERIC``: elevation separates most, the rest little) and each
row near its stand, at ``SPREAD`` of the class's spread, rounded and
clipped to the file's range; a ``MIX`` share of the rows takes a stand of
another class.  Wilderness and soil follow per-class probabilities: the
wilderness shares set by hand, the soil shares a fixed Dirichlet draw,
not the file's class-soil association.  The three constants set how wide
and how deep a fully grown tree grows; they were selected to give a tree
of at least 20,000 nodes and a level of at least 2,048, not fitted to the
file (``configs/covertype_udt.json`` gives the rule and the tree they
give).  Nothing here reads a file.
"""
from __future__ import annotations

import numpy as np

__all__ = ["CLASS_NAMES", "CLASS_COUNTS", "N_ROWS", "N_FEATURES", "NUMERIC",
           "N_WILDERNESS", "N_SOIL", "PATCHES", "SPREAD", "MIX",
           "class_counts", "synth_covertype"]

CLASS_NAMES = ("spruce_fir", "lodgepole_pine", "ponderosa_pine",
               "cottonwood_willow", "aspen", "douglas_fir", "krummholz")
CLASS_COUNTS = (211840, 283301, 35754, 2747, 9493, 17367, 20510)
N_ROWS = 581012
N_WILDERNESS = 4
N_SOIL = 40
PATCHES = 4000
SPREAD = 0.3
MIX = 0.1

# (name, low, high, per-class means, per-class spreads), in the file's order
NUMERIC = (
    ("Elevation", 1859, 3858,
     (3129, 2920, 2394, 2224, 2787, 2420, 3362),
     (156, 190, 197, 102, 96, 188, 106)),
    ("Aspect", 0, 360,
     (157, 152, 177, 138, 140, 181, 153), (110,) * 7),
    ("Slope", 0, 66,
     (13.1, 13.6, 20.8, 18.5, 16.6, 19.0, 14.3),
     (7.2, 7.5, 8.5, 8.7, 7.5, 8.3, 7.4)),
    ("Horizontal_Distance_To_Hydrology", 0, 1397,
     (271, 279, 211, 229, 213, 210, 357),
     (220, 210, 190, 130, 190, 180, 250)),
    ("Vertical_Distance_To_Hydrology", -173, 601,
     (48, 46, 62, 41, 51, 64, 70), (60, 58, 62, 40, 55, 60, 75)),
    ("Horizontal_Distance_To_Roadways", 0, 7117,
     (2614, 2429, 944, 915, 1349, 1037, 2738),
     (1500, 1550, 450, 300, 800, 500, 1300)),
    ("Hillshade_9am", 0, 254,
     (211, 213, 201, 223, 223, 192, 217), (25, 26, 35, 20, 20, 38, 22)),
    ("Hillshade_Noon", 0, 254,
     (223, 225, 216, 216, 220, 209, 221), (19, 19, 24, 20, 18, 28, 20)),
    ("Hillshade_3pm", 0, 254,
     (144, 142, 141, 112, 121, 150, 135), (36, 37, 48, 35, 33, 46, 37)),
    ("Horizontal_Distance_To_Fire_Points", 0, 7173,
     (2009, 2168, 910, 860, 1577, 1055, 2070),
     (1400, 1500, 500, 300, 1000, 600, 1300)),
)
N_FEATURES = len(NUMERIC) + N_WILDERNESS + N_SOIL

# Rawah, Neota, Comanche Peak, Cache la Poudre, by class
_WILDERNESS = np.array([[.49, .09, .42, .00], [.52, .03, .43, .02],
                        [.00, .00, .35, .65], [.00, .00, .00, 1.0],
                        [.41, .00, .59, .00], [.00, .00, .44, .56],
                        [.26, .12, .62, .00]])


def _soil_probs() -> np.ndarray:
    """``[7, 40]`` soil-type probabilities by class: fixed, whatever the
    seed or ``m``."""
    sig = np.random.default_rng(1998)
    return sig.dirichlet(np.full(N_SOIL, 0.3), size=len(CLASS_NAMES))


def class_counts(m: int) -> np.ndarray:
    """The file's class counts scaled to ``m`` rows (largest remainders),
    exact at ``N_ROWS``."""
    share = np.asarray(CLASS_COUNTS, np.float64) * m / N_ROWS
    counts = np.floor(share).astype(np.int64)
    rest = np.argsort(-(share - counts), kind="stable")[:m - counts.sum()]
    counts[rest] += 1
    return counts


def _pick(u, probs, y):
    """Index of the category each uniform ``u`` falls in, under the
    probabilities ``probs [7, n]`` of its row's class ``y``."""
    cum = np.cumsum(probs, axis=1)[y]
    return np.minimum((u[:, None] > cum).sum(1), probs.shape[1] - 1)


def synth_covertype(m: int, seed: int):
    """``(cols, y)``: ``m`` rows of the twin drawn from ``seed``; ``cols``
    54 float32 arrays, ``y`` int32 class ids 0..6."""
    rng = np.random.default_rng(seed)
    n_cls = len(CLASS_NAMES)
    y = np.repeat(np.arange(n_cls, dtype=np.int32), class_counts(m))
    y = y[rng.permutation(m)]
    u = rng.random((m, 5))
    # stands: each class's share of PATCHES, then each row's, at random
    # among those of its class or, for a MIX share, of another class
    share = np.maximum(1, np.round(np.asarray(CLASS_COUNTS) / N_ROWS
                                   * PATCHES)).astype(np.int64)
    first = np.concatenate([[0], np.cumsum(share)[:-1]])
    owner = np.repeat(np.arange(n_cls), share)
    mean = np.array([c[3] for c in NUMERIC], np.float64).T       # [7, 10]
    sd = np.array([c[4] for c in NUMERIC], np.float64).T
    centre = mean[owner] + sd[owner] * rng.standard_normal(
        (len(owner), len(NUMERIC)))
    src = np.where(u[:, 0] < MIX, (y + 1 + (u[:, 1] * (n_cls - 1)).astype(
        np.int32)) % n_cls, y)
    stand = first[src] + (u[:, 4] * share[src]).astype(np.int64)
    z = rng.standard_normal((m, len(NUMERIC)))
    num = np.rint(centre[stand] + SPREAD * sd[src] * z)
    num[:, 1] = np.mod(num[:, 1], 360)
    lo = np.array([c[1] for c in NUMERIC], np.float64)
    hi = np.array([c[2] for c in NUMERIC], np.float64)
    num = np.clip(num, lo, hi).astype(np.float32)
    onehot = np.zeros((m, N_WILDERNESS + N_SOIL), np.float32)
    rows = np.arange(m)
    onehot[rows, _pick(u[:, 2], _WILDERNESS, y)] = 1.0
    onehot[rows, N_WILDERNESS + _pick(u[:, 3], _soil_probs(), y)] = 1.0
    cols = [num[:, j].copy() for j in range(len(NUMERIC))]
    cols += [onehot[:, j].copy() for j in range(onehot.shape[1])]
    return cols, y
