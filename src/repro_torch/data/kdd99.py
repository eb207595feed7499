"""KDD Cup 1999 network-intrusion data: the paper's headline dataset
(counterpart of ``repro.data.kdd99``).

The paper trains its UDT on KDD99 (the 10% subset: 494,021 connections,
41 features, 3 of them categorical), collapsed to the conventional 5
SUPERCLASSES of the 23 raw attack labels -- normal / dos / probe / r2l /
u2r.

``load_kdd99`` first looks for a cached copy (``REPRO_KDD99_CACHE``,
default ``~/.cache/repro/kdd99``), then -- when the environment allows
network -- downloads the UCI archive once (bounded retries with
exponential backoff, the payload verified before it is cached), and
otherwise falls back to the deterministic SYNTHETIC twin ``synth_kdd99``
with the same schema (41 columns, categoricals at the same indices with
the real vocabularies) and the same class marginals.  Callers see the same
``(cols, y, info)`` contract either way; ``info["source"]`` says which
world they are in.  The port's card runs bin ``synth_kdd99`` directly and
never reach the network.
"""
from __future__ import annotations

import gzip
import os
import pathlib
import time
import urllib.request

import numpy as np

__all__ = ["SUPERCLASSES", "CAT_COLS", "N_FEATURES", "M_REAL",
           "ATTACK_SUPERCLASS", "DownloadError", "load_kdd99",
           "synth_kdd99", "cache_dir"]

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

_URLS = (
    "https://archive.ics.uci.edu/ml/machine-learning-databases/"
    "kddcup99-mld/kddcup.data_10_percent.gz",
    "http://kdd.ics.uci.edu/databases/kddcup99/kddcup.data_10_percent.gz",
)

# class-conditional vocabularies for the synthetic twin (real KDD values)
_PROTOCOLS = ("tcp", "udp", "icmp")
_SERVICES = ("http", "smtp", "ftp", "ftp_data", "telnet", "pop_3",
             "domain_u", "private", "ecr_i", "eco_i", "finger", "other")
_FLAGS = ("SF", "S0", "REJ", "RSTR", "RSTO", "SH")


def cache_dir() -> pathlib.Path:
    """The dataset cache directory (``REPRO_KDD99_CACHE`` overrides; CI
    caches this path so the real-data check runs warm when network ever
    allowed a download)."""
    return pathlib.Path(os.environ.get(
        "REPRO_KDD99_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "repro", "kdd99")))


def _parse_raw(raw: bytes):
    """Parse the decompressed CSV: 38 numeric f32 columns, the 3
    categorical string columns, and collapsed superclass ids."""
    rows = raw.decode("ascii", errors="replace").strip().split("\n")
    m = len(rows)
    num_idx = [j for j in range(N_FEATURES) if j not in CAT_COLS]
    num = np.empty((m, len(num_idx)), dtype=np.float32)
    cats = {j: np.empty(m, dtype=object) for j in CAT_COLS}
    y = np.empty(m, dtype=np.int32)
    sup_id = {name: i for i, name in enumerate(SUPERCLASSES)}
    for i, line in enumerate(rows):
        parts = line.split(",")
        label = parts[N_FEATURES].rstrip(".")
        y[i] = sup_id[ATTACK_SUPERCLASS[label]]
        for j in CAT_COLS:
            cats[j][i] = parts[j]
        num[i] = [float(parts[j]) for j in num_idx]
    return num, cats, y


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


def _load_cached(path: pathlib.Path):
    with np.load(path, allow_pickle=True) as z:
        cats = {j: z[f"cat{j}"] for j in CAT_COLS}
        return z["num"], cats, z["y"]


class DownloadError(RuntimeError):
    """Raised by ``load_kdd99(allow_download=True)`` when every download
    attempt failed; carries the per-attempt failure list in ``errors``."""

    def __init__(self, msg: str, errors: list):
        super().__init__(msg)
        self.errors = errors


def _verify_payload(gz: bytes) -> bytes:
    """Decompress and sanity-check a downloaded archive BEFORE it is
    cached: a truncated body, an HTML error page, or a wrong file must
    never poison the cache.  Returns the decompressed CSV bytes."""
    raw = gzip.decompress(gz)        # raises BadGzipFile/EOFError on junk
    head = raw[:4096].decode("ascii", errors="replace")
    first = head.split("\n", 1)[0]
    if first.count(",") != N_FEATURES:
        raise ValueError(
            f"payload is not the KDD99 CSV: expected {N_FEATURES + 1} "
            f"comma-separated fields per line, first line has "
            f"{first.count(',') + 1}")
    return raw


def _download(dest: pathlib.Path, timeout: float = 30.0, *,
              attempts: int = 3, backoff_base: float = 0.5,
              sleep=None) -> bytes | None:
    """Fetch the 10% archive with bounded retry + exponential backoff.

    Each round tries every mirror in ``_URLS``; between rounds it sleeps
    ``backoff_base * 2**round`` seconds (``sleep`` injectable for tests).
    Every payload is integrity-checked by :func:`_verify_payload` before
    the ``.gz`` is written to the cache.  Returns the decompressed CSV on
    success; on total failure returns ``None`` with the per-attempt
    errors recorded on ``_download.last_errors`` (so the caller can
    surface WHY when the user explicitly asked for a download)."""
    do_sleep = sleep if sleep is not None else time.sleep
    errors: list = []
    _download.last_errors = errors
    for attempt in range(attempts):
        if attempt:
            do_sleep(backoff_base * 2 ** (attempt - 1))
        for url in _URLS:
            try:
                with urllib.request.urlopen(url, timeout=timeout) as r:
                    gz = r.read()
                raw = _verify_payload(gz)
            except Exception as e:          # noqa: BLE001 — recorded, bounded
                errors.append(f"attempt {attempt + 1} {url}: "
                              f"{type(e).__name__}: {e}")
                continue
            dest.parent.mkdir(parents=True, exist_ok=True)
            tmp = dest.with_suffix(dest.suffix + ".tmp")
            tmp.write_bytes(gz)
            os.replace(tmp, dest)
            return raw
    return None


_download.last_errors = []


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


def load_kdd99(m: int | None = None, *, seed: int = 0,
               allow_download: bool | None = None, fallback_m: int = 50000):
    """Load KDD99 (10% subset, 5 superclasses): ``(cols, y, info)``.

    Resolution order: the parsed cache under ``cache_dir()``; the raw
    ``.gz`` in the cache (parsed + re-cached); a network download (unless
    ``allow_download`` is False or ``REPRO_KDD99_OFFLINE`` is set); the
    synthetic twin (``synth_kdd99(fallback_m, seed)``).  ``m`` subsamples
    (stratified-free uniform, deterministic under ``seed``) — the smoke
    benchmark's lever.  ``info`` carries ``source`` ("real"/"synthetic"),
    ``m``, ``classes`` and the empirical ``priors``.

    Failure policy: downloads retry with exponential backoff and verify
    payload integrity before caching (see :func:`_download`).  Only an
    EXPLICIT ``allow_download=True`` turns total download failure into a
    :class:`DownloadError` naming every attempt — the default (env-
    resolved) path never raises for missing network, so offline CI
    always proceeds on the synthetic fallback."""
    explicit = allow_download is True
    if allow_download is None:
        allow_download = not os.environ.get("REPRO_KDD99_OFFLINE")
    cdir = cache_dir()
    npz, gz = cdir / "kdd99_5class.npz", cdir / "kddcup.data_10_percent.gz"
    num = cats = y = None
    if npz.exists():
        num, cats, y = _load_cached(npz)
    else:
        raw = gzip.decompress(gz.read_bytes()) if gz.exists() else (
            _download(gz) if allow_download else None)
        if raw is None and explicit and not gz.exists():
            detail = "; ".join(_download.last_errors) or "no attempts made"
            raise DownloadError(
                "KDD99 download failed after every attempt and "
                "allow_download=True was passed explicitly — refusing to "
                f"silently substitute synthetic data ({detail})",
                list(_download.last_errors))
        if raw is not None:
            num, cats, y = _parse_raw(raw)
            cdir.mkdir(parents=True, exist_ok=True)
            np.savez_compressed(
                npz, num=num, y=y,
                **{f"cat{j}": cats[j] for j in CAT_COLS})
    if num is not None:
        source = "real"
        cols = _columns(num, {j: np.asarray(cats[j], dtype=object)
                              for j in CAT_COLS})
        y = np.asarray(y, dtype=np.int32)
    else:
        source = "synthetic"
        cols, y = synth_kdd99(fallback_m, seed)
    total = len(y)
    if m is not None and m < total:
        idx = np.random.default_rng(seed).choice(total, size=m,
                                                 replace=False)
        cols = [np.asarray(c, dtype=object)[idx].tolist()
                if j in CAT_COLS else np.asarray(c)[idx]
                for j, c in enumerate(cols)]
        y = y[idx]
    priors = np.bincount(y, minlength=len(SUPERCLASSES)) / len(y)
    info = dict(source=source, m=int(len(y)), classes=list(SUPERCLASSES),
                priors=[round(float(p), 6) for p in priors],
                n_features=N_FEATURES, cat_cols=list(CAT_COLS))
    return cols, y, info
