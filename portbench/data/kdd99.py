"""Frozen copy of the KDD Cup 1999 (10 %) synthetic twin.

The generator is copied here, not imported, so that a later change to the
program cannot change the data the benchmark measures.  Same schema as the
UCI file: 41 columns, the categoricals protocol_type / service / flag at
columns 1-3 with real vocabularies, labels collapsed to the conventional
five superclasses with the real 10 % subset's priors.  Numeric columns come
back as float32 arrays, categorical columns as object arrays of strings.
"""
from __future__ import annotations

import numpy as np

__all__ = ["SUPERCLASSES", "CAT_COLS", "N_FEATURES", "PRIORS", "synth_kdd99",
           "split_rows"]

SUPERCLASSES = ("normal", "dos", "probe", "r2l", "u2r")
N_FEATURES = 41
CAT_COLS = (1, 2, 3)        # protocol_type, service, flag
PRIORS = (0.1969, 0.7924, 0.0083, 0.0023, 0.0001)

_PROTOCOLS = ("tcp", "udp", "icmp")
_SERVICES = ("http", "smtp", "ftp", "ftp_data", "telnet", "pop_3",
             "domain_u", "private", "ecr_i", "eco_i", "finger", "other")
_FLAGS = ("SF", "S0", "REJ", "RSTR", "RSTO", "SH")


def _columns(num, cats):
    cols, ni = [], 0
    for j in range(N_FEATURES):
        if j in CAT_COLS:
            cols.append(cats[j])
        else:
            cols.append(num[:, ni])
            ni += 1
    return cols


def synth_kdd99(m: int, seed: int):
    """``(cols, y)``: ``m`` rows of the twin drawn from ``seed``.  Class
    counts follow ``PRIORS`` (each class floored at 8 rows); categoricals
    and a third of the numeric columns shift per class; columns 1 and 2 of
    the numeric block are heavy-tailed log-normals (src_bytes /
    dst_bytes)."""
    rng = np.random.default_rng(seed)
    counts = np.maximum(np.round(np.asarray(PRIORS) * m).astype(int), 8)
    counts[np.argmax(counts)] += m - counts.sum()
    y = np.repeat(np.arange(len(SUPERCLASSES), dtype=np.int32), counts)
    y = y[rng.permutation(m)]

    p_proto = np.array([[.75, .20, .05], [.30, .05, .65], [.45, .15, .40],
                        [.90, .08, .02], [.95, .04, .01]])
    p_flag = np.array([[.90, .02, .04, .02, .01, .01],
                       [.55, .35, .05, .03, .01, .01],
                       [.25, .30, .25, .10, .05, .05],
                       [.70, .05, .15, .05, .04, .01],
                       [.85, .03, .05, .03, .02, .02]])
    p_service = np.array(
        [[.40, .12, .06, .08, .03, .05, .10, .05, .01, .01, .04, .05],
         [.05, .01, .01, .01, .01, .01, .02, .30, .50, .05, .01, .02],
         [.05, .02, .02, .02, .02, .02, .05, .35, .10, .25, .05, .05],
         [.05, .05, .25, .20, .25, .05, .02, .05, .01, .01, .05, .01],
         [.05, .02, .10, .05, .55, .02, .02, .05, .01, .01, .10, .02]])

    def draw(vocab, probs):
        out = np.empty(m, dtype=object)
        for c in range(len(SUPERCLASSES)):
            sel = y == c
            out[sel] = np.asarray(vocab, dtype=object)[
                rng.choice(len(vocab), size=int(sel.sum()), p=probs[c])]
        return out

    cats = {1: draw(_PROTOCOLS, p_proto), 2: draw(_SERVICES, p_service),
            3: draw(_FLAGS, p_flag)}
    n_num = N_FEATURES - len(CAT_COLS)
    # per-class numeric signatures: fixed, whatever the seed or m
    sig_rng = np.random.default_rng(1999)
    shift = np.where(sig_rng.uniform(size=(len(SUPERCLASSES), n_num)) < .35,
                     sig_rng.normal(scale=2.0,
                                    size=(len(SUPERCLASSES), n_num)), 0.0)
    num = (rng.normal(size=(m, n_num)).astype(np.float32)
           + shift[y].astype(np.float32))
    num[:, 1] = np.exp(rng.normal(size=m) * 2.0
                       + np.asarray([5., 8., 2., 6., 4.])[y]).astype(np.float32)
    num[:, 2] = np.exp(rng.normal(size=m) * 2.0
                       + np.asarray([6., 1., 1., 5., 5.])[y]).astype(np.float32)
    return _columns(num, cats), y


def split_rows(m: int, seed: int, val_fraction: float):
    """Seeded split of ``m`` row ids: ``(train, val)``, the validation
    block ``int(m * val_fraction)`` rows long."""
    perm = np.random.default_rng(seed).permutation(m)
    n_val = int(m * val_fraction)
    return np.sort(perm[n_val:]), np.sort(perm[:n_val])
