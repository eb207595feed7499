"""KDD Cup 1999 network-intrusion data, offline twin only: the port's copy
of ``synth_kdd99`` from ``repro.data.kdd99``.

The paper trains its UDT on KDD99 (the 10% subset: 494,021 connections,
41 features, 3 of them categorical).  The real file is not in the
repository, so the port's main path runs on the JAX package's
deterministic SYNTHETIC twin: same schema (41 columns, categoricals at the
same indices with the real vocabularies), the conventional 5-superclass
collapse of the attack labels and the real class marginals.  There is no
download and no cache lookup here.
"""
from __future__ import annotations

import numpy as np

__all__ = ["SUPERCLASSES", "CAT_COLS", "N_FEATURES", "M_REAL",
           "ATTACK_SUPERCLASS", "synth_kdd99"]

# the 5 superclasses, id order fixed (class ids = index into this tuple)
SUPERCLASSES = ("normal", "dos", "probe", "r2l", "u2r")

# conventional raw-label -> superclass collapse (Tavallaee et al. 2009)
ATTACK_SUPERCLASS = {
    "normal": "normal",
    "back": "dos", "land": "dos", "neptune": "dos", "pod": "dos",
    "smurf": "dos", "teardrop": "dos",
    "ipsweep": "probe", "nmap": "probe", "portsweep": "probe",
    "satan": "probe",
    "ftp_write": "r2l", "guess_passwd": "r2l", "imap": "r2l",
    "multihop": "r2l", "phf": "r2l", "spy": "r2l", "warezclient": "r2l",
    "warezmaster": "r2l",
    "buffer_overflow": "u2r", "loadmodule": "u2r", "perl": "u2r",
    "rootkit": "u2r",
}

N_FEATURES = 41
CAT_COLS = (1, 2, 3)        # protocol_type, service, flag
M_REAL = 494021             # the 10% subset's row count (schema check)

# superclass marginals of the real 10% subset — the synthetic fallback
# reproduces these so base-rate floors transfer between worlds
PRIORS = (0.1969, 0.7924, 0.0083, 0.0023, 0.0001)

# class-conditional vocabularies for the synthetic twin (real KDD values)
_PROTOCOLS = ("tcp", "udp", "icmp")
_SERVICES = ("http", "smtp", "ftp", "ftp_data", "telnet", "pop_3",
             "domain_u", "private", "ecr_i", "eco_i", "finger", "other")
_FLAGS = ("SF", "S0", "REJ", "RSTR", "RSTO", "SH")


def _columns(num, cats):
    """Reassemble the 41-column layout from the parsed blocks."""
    cols, ni = [], 0
    for j in range(N_FEATURES):
        if j in CAT_COLS:
            cols.append(list(cats[j]))
        else:
            cols.append(num[:, ni])
            ni += 1
    return cols


def synth_kdd99(m: int = 50000, seed: int = 0):
    """Deterministic synthetic KDD99 twin: same schema (41 columns,
    categoricals at ``CAT_COLS`` with real vocabularies) and the real
    superclass marginals (``PRIORS``, each class floored at 8 rows so
    every superclass is present at any ``m``); features are
    class-conditional — protocol/service/flag distributions and a few
    count-style numeric channels shift per superclass, traffic-volume
    columns are heavy-tailed log-normals — so a tree ensemble can beat
    the base rate by a wide margin, but not trivially (class-conditional
    noise overlaps).  Returns ``(cols, y)``; same layout as the real
    loader."""
    rng = np.random.default_rng(seed)
    counts = np.maximum(np.round(np.asarray(PRIORS) * m).astype(int), 8)
    counts[np.argmax(counts)] += m - counts.sum()
    y = np.repeat(np.arange(len(SUPERCLASSES), dtype=np.int32), counts)
    perm = rng.permutation(m)
    y = y[perm]

    # class-conditional categorical distributions (rows: superclasses)
    p_proto = np.array([[.75, .20, .05],     # normal: mostly tcp
                        [.30, .05, .65],     # dos: smurf-style icmp floods
                        [.45, .15, .40],     # probe: sweeps mix icmp/tcp
                        [.90, .08, .02],     # r2l: remote logins are tcp
                        [.95, .04, .01]])    # u2r: shell sessions are tcp
    p_flag = np.array([[.90, .02, .04, .02, .01, .01],
                       [.55, .35, .05, .03, .01, .01],
                       [.25, .30, .25, .10, .05, .05],
                       [.70, .05, .15, .05, .04, .01],
                       [.85, .03, .05, .03, .02, .02]])
    # service: normal spreads over user services, dos concentrates on
    # ecr_i/private, probe on eco_i/private, r2l on ftp/telnet, u2r telnet
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
    # per-class numeric signatures: a random but FIXED (seed-independent
    # of m) shift pattern over ~1/3 of the numeric columns per class
    sig_rng = np.random.default_rng(1999)
    shift = np.where(sig_rng.uniform(size=(len(SUPERCLASSES), n_num)) < .35,
                     sig_rng.normal(scale=2.0,
                                    size=(len(SUPERCLASSES), n_num)), 0.0)
    num = rng.normal(size=(m, n_num)).astype(np.float32) + \
        shift[y].astype(np.float32)
    # traffic-volume style heavy tails on the first two numeric channels
    # (src_bytes / dst_bytes analogues), still class-shifted
    num[:, 1] = np.exp(rng.normal(size=m) * 2.0
                       + np.asarray([5., 8., 2., 6., 4.])[y]).astype(
                           np.float32)
    num[:, 2] = np.exp(rng.normal(size=m) * 2.0
                       + np.asarray([6., 1., 1., 5., 5.])[y]).astype(
                           np.float32)
    return _columns(num, cats), y
