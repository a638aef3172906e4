"""Measurement-Set data edge: host-side I/O behind one small API
(counterpart of smartcal_tpu/cal/ms_io.py, the same numpy code; its
``TABLE.sct`` stores go through the port's own native library and are
byte-identical to the JAX package's).

The reference talks to CASA Measurement Sets through python-casacore
(``calibration/casa_io.py:9-72`` read_corr/write_corr, ``generate_data.py:
877-887`` add_column, ``changefreq.py`` SPECTRAL_WINDOW rewrite,
``addnoise.py`` AWGN at a given SNR) and averages real observations with an
external DP3 run (``generate_data.py:623-681`` extract_dataset).  None of
that is TPU work — it is the host-side data edge — so here it lives in one
numpy module with two storage backends:

* **casacore**, used when python-casacore is importable and the path is a
  real MS (``table.dat`` present).  Import is gated: nothing in the package
  requires casacore to exist.
* **sct**, the framework's own native columnar store (``TABLE.sct``, one
  binary file written/read by the first-party C++ library in
  :mod:`smartcal_tpu_torch.native` — the in-build counterpart of the casacore
  table system).  The default write format: the library is built on
  first use, and a failed build raises (no silent npz store);
  ``SMARTCAL_MS_FORMAT=npz`` chooses the pure-python backend explicitly.
* **npz**, an MS-shaped directory (``MAIN.npz`` + ``META.npz``), with
  identical semantics.

Both synthetic backends share the real-MS row semantics: one row per
(time, antenna pair) INCLUDING autocorrelations, sorted by
TIME,ANTENNA1,ANTENNA2, DATA of shape (nrows, nchan, 4).  They are the
synthetic stand-in the rest of the pipeline (featurization, evaluate CLI)
exercises in tests, through the very same code path a real MS would take.

Everything here is host-side numpy; device work happens downstream on the
split-real arrays these functions return (the writers take tensors on any
device and copy them to the host).
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from smartcal_tpu_torch import native
from smartcal_tpu_torch.cal.observation import OMEGA_EARTH

try:  # gated: real MS support only when python-casacore is installed
    from casacore import tables as _ctab
except Exception:  # pragma: no cover - exercised implicitly everywhere
    _ctab = None

MAIN = "MAIN.npz"
META = "META.npz"
SCT = "TABLE.sct"

# Columns every store carries; extra data columns (MODEL_DATA, ...) are
# created on demand by add_column.
_BASE_COLS = ("TIME", "ANTENNA1", "ANTENNA2", "UVW", "INTERVAL", "DATA")


def _host(x):
    """A tensor (any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def is_sct_ms(path) -> bool:
    return os.path.isfile(os.path.join(path, SCT))


def is_npz_ms(path) -> bool:
    """True for any synthetic (non-casacore) store, either backend."""
    return (os.path.isfile(os.path.join(path, MAIN)) or is_sct_ms(path))


def _is_casa_ms(path) -> bool:
    return os.path.isfile(os.path.join(path, "table.dat"))


def _write_format() -> str:
    fmt = os.environ.get("SMARTCAL_MS_FORMAT", "").strip().lower()
    if fmt in ("sct", "npz"):
        return fmt
    if fmt:
        raise ValueError(
            f"SMARTCAL_MS_FORMAT={fmt!r}: expected 'sct' or 'npz'")
    return "sct"


def _load(path):
    if is_sct_ms(path):
        cols = native.sct_read(os.path.join(path, SCT))
        main = {k[5:]: v for k, v in cols.items() if k.startswith("MAIN/")}
        meta = {k[5:]: v for k, v in cols.items() if k.startswith("META/")}
        return main, meta
    if not os.path.isfile(os.path.join(path, MAIN)):
        raise FileNotFoundError(f"not a synthetic MS (sct or npz): {path}")
    with np.load(os.path.join(path, MAIN)) as z:
        main = dict(z)
    with np.load(os.path.join(path, META)) as z:
        meta = dict(z)
    return main, meta


def _store(path, main, meta):
    os.makedirs(path, exist_ok=True)
    fmt = _write_format()
    # Crash-window discipline per branch (_load PREFERS sct):
    #  * writing sct over an npz store: write first, remove after — a
    #    failed/interrupted sct_write must not destroy the npz original,
    #    and once TABLE.sct lands readers already see the new data.
    #  * writing npz over an sct store: remove TABLE.sct FIRST — with it
    #    present, a crash after savez would leave readers silently serving
    #    the stale pre-mutation sct forever; remove-first turns that
    #    window into a loud missing-store error instead.
    if fmt == "sct":
        cols = {"MAIN/" + k: v for k, v in main.items()}
        cols.update({"META/" + k: v for k, v in meta.items()})
        native.sct_write(os.path.join(path, SCT), cols)
        stale = (MAIN, META)
    else:
        f = os.path.join(path, SCT)
        if os.path.isfile(f):
            os.remove(f)
        np.savez(os.path.join(path, MAIN), **main)
        np.savez(os.path.join(path, META), **meta)
        stale = ()
    for name in stale:
        f = os.path.join(path, name)
        if os.path.isfile(f):
            os.remove(f)


class MSInfo(NamedTuple):
    """Shape/metadata summary (the subtable reads of
    generate_data.py:727-746)."""

    n_stations: int
    n_baselines: int
    n_times: int
    n_chan: int
    freqs: np.ndarray      # (nchan,) CHAN_FREQ
    ref_freq: float
    ra0: float
    dec0: float
    t0: float              # first TIME value (s)
    interval: float        # integration time (s)


def ms_info(path) -> MSInfo:
    if _ctab is not None and _is_casa_ms(path):
        return _casa_ms_info(path)
    main, meta = _load(path)
    n_st = int(meta["N_ANTENNA"])
    b = n_st * (n_st - 1) // 2
    nrows, nchan, _ = main["DATA"].shape
    # rows per integration: B + N with autocorrelation rows (what
    # write_observation_ms emits), plain B without (extract_dataset
    # preserves whatever structure the source casacore MS had) — count
    # the actual autocorrelation rows instead of assuming
    n_auto = int(np.count_nonzero(main["ANTENNA1"] == main["ANTENNA2"]))
    rows_per_time = b + n_st if n_auto else b
    return MSInfo(
        n_stations=n_st, n_baselines=b, n_times=nrows // rows_per_time,
        n_chan=nchan, freqs=np.asarray(meta["CHAN_FREQ"], np.float64),
        ref_freq=float(meta["REF_FREQUENCY"]), ra0=float(meta["RA0"]),
        dec0=float(meta["DEC0"]), t0=float(main["TIME"][0]),
        interval=float(main["INTERVAL"][0]))


def read_corr(path, colname: str = "MODEL_DATA"):
    """MS column -> (uu, vv, ww, xx, xy, yx, yy), autocorrelations excluded.

    Row order: TIME major, then baseline p<q — the reference's sorted query
    (casa_io.py:9-43).  Channel 0 only, like the reference.
    """
    if _ctab is not None and _is_casa_ms(path):
        return _casa_read_corr(path, colname)
    main, _ = _load(path)
    if colname not in main:
        raise KeyError(f"column {colname} not in {path}")
    cross = main["ANTENNA1"] != main["ANTENNA2"]
    vl = main[colname][cross, 0]                      # (B*T, 4) complex
    uvw = main["UVW"][cross]
    return (uvw[:, 0].astype(np.float32), uvw[:, 1].astype(np.float32),
            uvw[:, 2].astype(np.float32), vl[:, 0].astype(np.csingle),
            vl[:, 1].astype(np.csingle), vl[:, 2].astype(np.csingle),
            vl[:, 3].astype(np.csingle))


def write_corr(path, xx, xy, yx, yy, colname: str = "CORRECTED_DATA"):
    """Write correlations into ``colname`` (cross rows, all channels get the
    channel-0 value — casa_io.py:46-72)."""
    if _ctab is not None and _is_casa_ms(path):
        return _casa_write_corr(path, xx, xy, yx, yy, colname)
    main, meta = _load(path)
    if colname not in main:
        add_column(path, colname)
        main, meta = _load(path)
    cross = main["ANTENNA1"] != main["ANTENNA2"]
    vl = main[colname]
    block = np.stack([xx, xy, yx, yy], axis=-1).astype(vl.dtype)
    vl[cross] = block[:, None, :]                    # broadcast over chans
    main[colname] = vl
    _store(path, main, meta)


def add_column(path, colname: str):
    """Add a DATA-shaped complex column, zero-filled
    (generate_data.py:877-887)."""
    if _ctab is not None and _is_casa_ms(path):
        return _casa_add_column(path, colname)
    main, meta = _load(path)
    if colname not in main:
        main[colname] = np.zeros_like(main["DATA"])
        _store(path, main, meta)


def change_freq(path, freq: float):
    """Rewrite SPECTRAL_WINDOW to a single frequency (changefreq.py role)."""
    if _ctab is not None and _is_casa_ms(path):
        return _casa_change_freq(path, freq)
    main, meta = _load(path)
    nchan = main["DATA"].shape[1]
    meta["CHAN_FREQ"] = np.full(nchan, freq, np.float64)
    meta["REF_FREQUENCY"] = np.float64(freq)
    _store(path, main, meta)


def add_noise(path, snr: float, rng=None, colname: str = "DATA"):
    """AWGN at the given SNR into ``colname`` (addnoise.py role):
    noise_std = ||data|| / (snr * sqrt(2 * size))."""
    rng = rng or np.random.default_rng(0)
    main, meta = _load(path)
    d = main[colname]
    scale = np.linalg.norm(d) / (snr * np.sqrt(2.0 * d.size))
    noise = (rng.standard_normal(d.shape)
             + 1j * rng.standard_normal(d.shape)) * scale
    main[colname] = (d + noise).astype(d.dtype)
    _store(path, main, meta)


# ---------------------------------------------------------------------------
# Synthetic writer: Observation + split-real V -> MS-shaped store
# ---------------------------------------------------------------------------

def write_observation_ms(path, obs, V_sr, freq: float,
                         extra_cols: Optional[List[str]] = None):
    """Write ONE sub-band of a simulated observation as an MS-shaped store.

    obs : cal.observation.Observation (uvw (T,B,3), times, ra0/dec0)
    V_sr: (T, B, 2, 2, 2) split-real visibilities for this sub-band
    freq: channel frequency (Hz)

    Emits real-MS row structure: (B + N) rows per time (autocorrelations
    zero), sorted TIME,ANTENNA1,ANTENNA2 — so readers cannot tell this from
    a casacore-exported single-channel MS.
    """
    n_st = obs.n_stations
    V_sr = _host(V_sr)
    T, B = V_sr.shape[0], V_sr.shape[1]
    if B != n_st * (n_st - 1) // 2:
        raise ValueError(f"{B} baselines for {n_st} stations")
    p, q = np.triu_indices(n_st, 0)                  # incl. autocorr, sorted
    npair = p.size                                   # B + N
    cross = p != q

    Vc = (V_sr[..., 0] + 1j * V_sr[..., 1]).astype(np.complex64) \
        .reshape(T, B, 4)                              # (T, B, 4) complex
    data = np.zeros((T * npair, 1, 4), np.csingle)
    data[np.tile(cross, T).nonzero()[0], 0, :] = Vc.reshape(T * B, 4)

    uvw_rows = np.zeros((T * npair, 3), np.float32)
    uvw_rows[np.tile(cross, T).nonzero()[0]] = \
        np.asarray(_host(obs.uvw), np.float32).reshape(T * B, 3)

    times = np.asarray(_host(obs.times), np.float64)
    t_int = float(times[1] - times[0]) if T > 1 else 1.0
    # absolute epoch seconds consistent with lst0 = OMEGA * t0 mod 2pi
    t0_abs = obs.lst0 / OMEGA_EARTH
    main = {
        "TIME": np.repeat(t0_abs + times, npair),
        "ANTENNA1": np.tile(p, T).astype(np.int32),
        "ANTENNA2": np.tile(q, T).astype(np.int32),
        "UVW": uvw_rows,
        "INTERVAL": np.full(T * npair, t_int, np.float64),
        "DATA": data,
    }
    for c in (extra_cols or []):
        main[c] = np.zeros_like(data)
    meta = {
        "CHAN_FREQ": np.asarray([freq], np.float64),
        "REF_FREQUENCY": np.float64(freq),
        "RA0": np.float64(obs.ra0), "DEC0": np.float64(obs.dec0),
        "N_ANTENNA": np.int64(n_st),
    }
    _store(path, main, meta)
    return path


def observation_to_ms_set(outdir, obs, V_all_sr, basename="L_SB"):
    """One MS per sub-band (the LOFAR L_SB*.MS convention,
    dosimul.sh:14-32).  V_all_sr: (Nf, T, B, 2, 2, 2)."""
    freqs = np.asarray(_host(obs.freqs), np.float64)
    V_all_sr = _host(V_all_sr)
    paths = []
    for fi in range(V_all_sr.shape[0]):
        ms = os.path.join(outdir, f"{basename}{fi}.MS")
        write_observation_ms(ms, obs, V_all_sr[fi], float(freqs[fi]))
        paths.append(ms)
    return paths


# ---------------------------------------------------------------------------
# extract_dataset: DP3-averaging replacement (generate_data.py:623-681)
# ---------------------------------------------------------------------------

def _load_any(path):
    """(main, meta) column dicts from any backend — sct/npz directly, or a
    casacore MS read column-by-column into the same layout (so the
    averaging/extraction logic below is backend-agnostic; extracted work
    files are always written as synthetic stores, leaving real MSs
    untouched)."""
    if is_npz_ms(path):
        return _load(path)
    if _ctab is None or not _is_casa_ms(path):  # pragma: no cover
        raise FileNotFoundError(f"not an MS (npz or casacore): {path}")
    # pragma: no cover - needs casacore
    tt = _ctab.table(path, readonly=True)
    t1 = tt.query(sortlist="TIME,ANTENNA1,ANTENNA2")
    main = {c: t1.getcol(c) for c in _BASE_COLS if c in t1.colnames()}
    n_st = int(max(main["ANTENNA1"].max(), main["ANTENNA2"].max())) + 1
    t1.close()
    tt.close()
    info = _casa_ms_info(path)
    meta = {"CHAN_FREQ": info.freqs,
            "REF_FREQUENCY": np.float64(info.ref_freq),
            "RA0": np.float64(info.ra0), "DEC0": np.float64(info.dec0),
            "N_ANTENNA": np.int64(n_st)}
    return main, meta


def _peek_freq(path) -> float:
    """First channel frequency without loading the main data columns."""
    if is_sct_ms(path):
        freq = native.sct_read_one(os.path.join(path, SCT),
                                   "META/CHAN_FREQ")
        return float(np.asarray(freq).ravel()[0])
    if is_npz_ms(path):
        with np.load(os.path.join(path, META)) as z:
            return float(np.asarray(z["CHAN_FREQ"]).ravel()[0])
    if _ctab is not None and _is_casa_ms(path):  # pragma: no cover
        tf = _ctab.table(os.path.join(path, "SPECTRAL_WINDOW"),
                         readonly=True)
        f = float(tf.getcol("CHAN_FREQ")[0][0])
        tf.close()
        return f
    raise FileNotFoundError(f"not an MS (npz or casacore): {path}")


def extract_dataset(mslist: List[str], timesec: float, Nf: int = 3,
                    rng=None, outdir: str = ".", basename: str = "EX_SB"):
    """Choose ``Nf`` sub-band MSs, average their channels to one, and cut a
    random ``timesec``-second time window; write the results as NEW npz
    stores (work files — sources are only read).

    Sub-band choice matches the reference: always the lowest and highest
    frequency plus Nf-2 random interior ones (:662-668).  The averaging the
    reference delegates to DP3 (avg.freqstep=64, :648-658) is a mean over
    the channel axis here.
    """
    rng = rng or np.random.default_rng(0)
    # sort by actual sub-band frequency, not name (lexicographic order
    # breaks for unpadded L_SB10.MS vs L_SB2.MS, silently mispicking the
    # endpoint sub-bands below)
    mslist = sorted(mslist, key=_peek_freq)
    if len(mslist) < Nf:
        raise ValueError(f"need >= {Nf} MS, got {len(mslist)}")

    main0, _ = _load_any(mslist[0])
    tcol = main0["TIME"]
    tstart, tend = float(tcol[0]), float(tcol[-1])
    t_lo = rng.random() * max(tend - tstart - timesec, 0.0) + tstart
    t_hi = t_lo + timesec

    if len(mslist) == Nf:
        sub = list(mslist)
    else:
        interior = np.sort(rng.choice(np.arange(1, len(mslist) - 1),
                                      Nf - 2, replace=False))
        sub = [mslist[0]] + [mslist[i] for i in interior] + [mslist[-1]]

    out = []
    for ci, src in enumerate(sub):
        dst = os.path.join(outdir, f"{basename}{ci}.MS")
        if os.path.abspath(dst) in {os.path.abspath(m) for m in mslist}:
            raise ValueError(
                f"extract_dataset output {dst} would overwrite a source MS;"
                " use a different outdir/basename")
        main, meta = _load_any(src)
        sel = (main["TIME"] >= t_lo) & (main["TIME"] <= t_hi)
        if not np.any(sel):
            raise ValueError(
                f"extract_dataset: the {timesec}s window [{t_lo:.1f}, "
                f"{t_hi:.1f}] selects no rows of {src} (integration "
                "interval longer than the window?) — increase timesec")
        new_main = {}
        for k, v in main.items():
            v = v[sel]
            if v.ndim == 3:                       # data columns: chan mean
                v = v.mean(axis=1, keepdims=True)
            new_main[k] = v
        meta = dict(meta)
        meta["CHAN_FREQ"] = np.asarray(
            [float(np.mean(meta["CHAN_FREQ"]))], np.float64)
        _store(dst, new_main, meta)
        out.append(dst)
    return out


# ---------------------------------------------------------------------------
# casacore backend (thin; only reached when python-casacore is installed)
# ---------------------------------------------------------------------------

def _casa_ms_info(path) -> MSInfo:  # pragma: no cover - needs casacore
    tt = _ctab.table(path, readonly=True)
    a1 = tt.getcol("ANTENNA1")
    a2 = tt.getcol("ANTENNA2")
    n_st = int(max(a1.max(), a2.max())) + 1
    b = n_st * (n_st - 1) // 2
    t0 = float(tt[0]["TIME"])
    interval = float(tt[0]["INTERVAL"])
    nrows = tt.nrows()
    # count autocorrelation rows rather than guessing from divisibility
    # (T*(N-1) divisible by N+1 happens for real shapes, e.g. N=15, T=16)
    n_auto = int(np.count_nonzero(a1 == a2))
    rows_per_time = b + n_st if n_auto else b
    tt.close()
    tf = _ctab.table(os.path.join(path, "SPECTRAL_WINDOW"), readonly=True)
    freqs = np.asarray(tf.getcol("CHAN_FREQ")[0], np.float64)
    ref = float(tf.getcol("REF_FREQUENCY")[0])
    tf.close()
    fld = _ctab.table(os.path.join(path, "FIELD"), readonly=True)
    ra0, dec0 = (float(x) for x in fld.getcol("PHASE_DIR")[0][0])
    fld.close()
    return MSInfo(n_st, b, nrows // rows_per_time, freqs.size, freqs, ref,
                  ra0, dec0, t0, interval)


def _casa_read_corr(path, colname):  # pragma: no cover - needs casacore
    tt = _ctab.table(path, readonly=True)
    t1 = tt.query(sortlist="TIME,ANTENNA1,ANTENNA2",
                  columns="ANTENNA1,ANTENNA2,UVW," + colname)
    vl = t1.getcol(colname)
    a1, a2 = t1.getcol("ANTENNA1"), t1.getcol("ANTENNA2")
    uvw = t1.getcol("UVW")
    t1.close()
    tt.close()
    cross = a1 != a2
    return (uvw[cross, 0].astype(np.float32),
            uvw[cross, 1].astype(np.float32),
            uvw[cross, 2].astype(np.float32),
            vl[cross, 0, 0].astype(np.csingle),
            vl[cross, 0, 1].astype(np.csingle),
            vl[cross, 0, 2].astype(np.csingle),
            vl[cross, 0, 3].astype(np.csingle))


def _casa_write_corr(path, xx, xy, yx, yy, colname):  # pragma: no cover
    tt = _ctab.table(path, readonly=False)
    t1 = tt.query(sortlist="TIME,ANTENNA1,ANTENNA2",
                  columns="ANTENNA1,ANTENNA2," + colname)
    vl = t1.getcol(colname)
    cross = t1.getcol("ANTENNA1") != t1.getcol("ANTENNA2")
    block = np.stack([xx, xy, yx, yy], axis=-1)
    vl[cross] = block[:, None, :]
    t1.putcol(colname, vl)
    t1.close()
    tt.close()


def _casa_add_column(path, colname):  # pragma: no cover - needs casacore
    tt = _ctab.table(path, readonly=False)
    if colname not in tt.colnames():
        cd = tt.getcoldesc("DATA")
        cd["name"] = colname
        tt.addcols(_ctab.makecoldesc(colname, cd))
    tt.close()


def _casa_change_freq(path, freq):  # pragma: no cover - needs casacore
    tf = _ctab.table(os.path.join(path, "SPECTRAL_WINDOW"), readonly=False)
    ch = tf.getcol("CHAN_FREQ")
    ch[:] = freq
    tf.putcol("CHAN_FREQ", ch)
    tf.putcol("REF_FREQUENCY", np.full_like(tf.getcol("REF_FREQUENCY"),
                                            freq))
    tf.close()
