"""Host-side text-format parsers/writers for the calibration data edge
(counterpart of smartcal_tpu/cal/skyio.py, the same numpy code on the
port's ``coords`` and ``coherency.SkyArrays``).

Parity targets: ``calibration/calibration_tools.py`` readsolutions (:88),
read_global_solutions (:122), read_spatial_solutions (:162), read_rho (:470),
read_skycluster (:488), readuvw/writeuvw (:505-522), readcluster (:1228),
and the sky/cluster parsing embedded in skytocoherencies (:244-282).

These are pure-numpy, vectorized (no per-line python math on the hot fields),
and only ever run at the host data edge — device code consumes the arrays.
"""

import numpy as np

from smartcal_tpu_torch.cal import coords
from smartcal_tpu_torch.cal.coherency import SkyArrays


def _data_lines(path):
    with open(path) as fh:
        return [ln for ln in fh
                if not ln.startswith("#") and len(ln.strip()) > 0]


def parse_sky_model(path):
    """SAGECal LSM sky model -> dict name -> field array (18 floats):
    [ra_h, ra_m, ra_s, dec_d, dec_m, dec_s, sI, sQ, sU, sV,
     sp1, sp2, sp3, RM, eX, eY, eP, f0].
    Gaussian sources are flagged by a leading 'G' in the name
    (reference calibration_tools.py:419-422)."""
    out = {}
    for ln in _data_lines(path):
        parts = ln.split()
        out[parts[0]] = np.asarray([float(x) for x in parts[1:19]],
                                   dtype=np.float64)
    return out


def parse_cluster_file(path):
    """Cluster file -> list of (cluster_line_order, [source names]).
    Format per line: cluster_id hybrid name1 name2 ...
    (reference calibration_tools.py:253-288)."""
    return [(i, ln.split()[2:]) for i, ln in enumerate(_data_lines(path))]


def build_sky_arrays(sky_path, cluster_path, ra0, dec0):
    """Parse sky + cluster files into a device-ready SkyArrays.

    The flux column stores log(sI); spectral coefficients pass through.
    Cluster ids follow cluster-file line order, as in the reference.
    """
    S = parse_sky_model(sky_path)
    clusters = parse_cluster_file(cluster_path)
    rows, cl_ids, names = [], [], []
    for cid, snames in clusters:
        for nm in snames:
            rows.append(S[nm])
            cl_ids.append(cid)
            names.append(nm)
    info = np.stack(rows)                                  # (S, 18)
    ra = coords.hms_to_rad(info[:, 0], info[:, 1], info[:, 2])
    # dec stays a per-row loop: dms_to_rad's negative-zero sign logic is
    # scalar-only
    dec = np.asarray([coords.dms_to_rad(*row[3:6]) for row in info])
    l, m, n = (np.asarray(v)
               for v in coords.radectolm(ra, dec, ra0, dec0))

    flux_coef = np.stack([np.log(info[:, 6]), info[:, 10],
                          info[:, 11], info[:, 12]], axis=-1)
    gauss = info[:, [14, 15, 16]]
    is_gauss = np.asarray([nm.startswith("G") for nm in names])
    return SkyArrays(
        lmn=np.stack([l, m, n], axis=-1), flux_coef=flux_coef,
        f0=info[:, 17], gauss=gauss, is_gauss=is_gauss,
        cluster=np.asarray(cl_ids), n_clusters=len(clusters))


def write_sky_model(path, rows):
    """SAGECal LSM writer: ``rows`` of (name, ra_rad, dec_rad, sI, sp1,
    eX, eY, eP, f0) -> the 18-column text format parse_sky_model reads.
    Gaussian sources are any with nonzero extent (name should lead 'G')."""
    with open(path, "w") as fh:
        fh.write("## LSM file\n")
        fh.write("### Name | RA (h m s) | DEC (d m s) | I Q U V | SI0 SI1 "
                 "SI2 | RM | eX eY eP | f0\n")
        for (name, ra, dec, sI, sp1, eX, eY, eP, f0) in rows:
            hh, mm, ss = coords.rad_to_ra(ra)
            dd, dm, ds = coords.rad_to_dec(dec)
            fh.write(f"{name} {hh} {mm} {ss:.6f} {dd} {dm} {ds:.6f} "
                     f"{sI} 0 0 0 {sp1} 0 0 0 {eX} {eY} {eP} {f0}\n")


def write_cluster_file(path, clusters, hybrid=1):
    """Cluster-file writer: ``clusters`` = [(cluster_id, [names])]."""
    with open(path, "w") as fh:
        fh.write("### Cluster file\n")
        for cid, names in clusters:
            fh.write(f"{cid} {hybrid} " + " ".join(names) + "\n")


def _sex_to_rad(txt, is_ra):
    """DP3 position field -> radians.

    Accepts Ra 'hh:mm:ss.s', Dec '+dd.mm.ss.s' (dot-separated sexagesimal
    needs >= 2 dots), colon-separated dec, and plain decimal degrees
    ('52.3444' — one dot — is degrees, NOT 52 deg 3444 min)."""
    t = txt.strip().replace("+", "")
    neg = t.startswith("-")
    body = t.lstrip("-")
    if ":" in body:
        parts = body.split(":")
    elif body.count(".") >= 2:             # dd.mm.ss[.frac] sexagesimal
        p = body.split(".")
        parts = [p[0], p[1], ".".join(p[2:]) if len(p) > 2 else "0"]
    else:      # plain decimal degrees (legal for both Ra and Dec)
        val = np.deg2rad(float(body))
        return -val if neg else val
    a, b, c = (float(x) for x in (parts + ["0", "0"])[:3])
    if is_ra:
        val = float(coords.hms_to_rad(a, b, c))
        return -val if neg else val
    val = np.deg2rad(a + b / 60.0 + c / 3600.0)
    return -val if neg else val


def _split_csv_brackets(ln):
    """Split a makesourcedb row on commas OUTSIDE [...] brackets (a
    multi-term SpectralIndex like '[-0.7, 0.02]' is one field)."""
    out, depth, cur = [], 0, []
    for ch in ln:
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth = max(0, depth - 1)
        if ch == "," and depth == 0:
            out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    out.append("".join(cur).strip())
    return out


def parse_makesourcedb(path):
    """DP3 makesourcedb sky model -> (sources, patches).

    The format the LINC target download produces (and lsmtool consumes in
    the reference's ``convertmodel.py``): a ``format = Name, Type, Patch,
    Ra, Dec, I, ...`` header, patch-definition rows with empty Name/Type,
    and per-source rows.  Returns sources as dicts with keys name/type/
    patch/ra/dec/I/spectral_index/major/minor/orientation/ref_freq and
    the ordered patch-name list.
    """
    def _fields_from(spec):
        """Field names + their header defaults (e.g.
        ReferenceFrequency='134e6' declares the value used when a row
        leaves that column empty)."""
        names, defaults = [], {}
        for f in _split_csv_brackets(spec.strip(" ()")):
            if "=" in f:
                nm, dv = f.split("=", 1)
                nm = nm.strip().strip("()")
                defaults[nm] = dv.strip().strip("'\"")
            else:
                nm = f.strip().strip("()")
            names.append(nm)
        return names, defaults

    fields, defaults = None, {}
    sources, patches = [], []
    with open(path) as fh:
        for ln in fh:
            ln = ln.strip()
            if not ln or ln.startswith("#"):
                # two header styles exist: '# (<fields>) = format' (the
                # trailing marker; fields may themselves contain '=', e.g.
                # ReferenceFrequency='134e6') and 'format = <fields>'
                body = ln.lstrip("# ").rstrip()
                if body.lower().endswith("= format"):
                    fields, defaults = _fields_from(
                        body[:body.lower().rfind("= format")])
                continue
            if fields is None and ln.lower().startswith("format"):
                fields, defaults = _fields_from(ln.split("=", 1)[1])
                continue
            if fields is None:
                raise ValueError(
                    f"{path}: data row before any recognized 'format' "
                    "header — cannot assign columns")
            vals = _split_csv_brackets(ln)
            row = dict(zip(fields, vals))
            name = row.get("Name", "")
            if not name:                       # patch definition row
                if row.get("Patch"):
                    patches.append(row["Patch"])
                continue
            si_txt = row.get("SpectralIndex", "").strip("[] ")
            # multi-term indices split on ',' or ';'; first term used
            si = (float(si_txt.replace(";", ",").split(",")[0])
                  if si_txt else 0.0)
            f0 = float(row.get("ReferenceFrequency")
                       or defaults.get("ReferenceFrequency") or 0.0) \
                or 100e6
            asec = np.pi / (180.0 * 3600.0)
            sources.append({
                "name": name,
                "type": row.get("Type", "POINT").upper(),
                "patch": row.get("Patch", ""),
                "ra": _sex_to_rad(row["Ra"], True),
                "dec": _sex_to_rad(row["Dec"], False),
                "I": float(row.get("I", 0.0) or 0.0),
                "spectral_index": si,
                "major": float(row.get("MajorAxis") or 0.0) * asec,
                "minor": float(row.get("MinorAxis") or 0.0) * asec,
                "orientation": np.pi / 2 - (np.pi - np.deg2rad(
                    float(row.get("Orientation") or 0.0))),
                "ref_freq": f0,
            })
            if sources[-1]["patch"] and sources[-1]["patch"] not in patches:
                patches.append(sources[-1]["patch"])
    return sources, patches


def convert_dp3_skymodel(skymodel, out_sky, out_cluster, out_rho,
                         start_cluster=1, num_patches=0):
    """DP3 makesourcedb model -> SAGECal sky/cluster/rho text files.

    Reference: ``calibration/convertmodel.py:16-76`` (lsmtool-based) —
    one cluster per patch, Gaussian sources renamed 'G<patch><i>' and
    points 'P<patch><i>', rho 1.0 per cluster, patch order preserved.
    Returns the number of clusters written.
    """
    sources, patches = parse_makesourcedb(skymodel)
    if num_patches > 0:
        patches = patches[:num_patches]
    rows, clusters, rhos = [], [], []
    cid = start_cluster
    for patch in patches:
        names = []
        for ci, s in enumerate(p for p in sources if p["patch"] == patch):
            prefix = "G" if s["type"] == "GAUSSIAN" else "P"
            # separator prevents cross-patch collisions
            # ('X' idx 11 vs 'X1' idx 1 both -> 'PX11')
            name = f"{prefix}{patch}.{ci}"
            names.append(name)
            rows.append((name, s["ra"], s["dec"], s["I"],
                         s["spectral_index"], s["major"], s["minor"],
                         s["orientation"], s["ref_freq"]))
        if names:
            clusters.append((cid, names))
            rhos.append(cid)
            cid += 1
    write_sky_model(out_sky, rows)
    write_cluster_file(out_cluster, clusters)
    # rho 1.0 per cluster like the reference (:49), ids matching the
    # cluster file (the start_cluster interchange contract)
    write_rho(out_rho, np.ones(len(rhos), np.float32),
              np.zeros(len(rhos), np.float32), ids=rhos)
    return len(clusters)


def write_bbs_skymodel(path, rows, f0):
    """Inverse direction: SAGECal-style rows -> a DP3 makesourcedb file
    (the ``sky_bbs.txt`` the simulator emits for external DP3 runs,
    simulate.py:139-141).  ``rows`` as for :func:`write_sky_model`."""
    with open(path, "w") as fh:
        fh.write("# (Name, Type, Patch, Ra, Dec, I, Q, U, V, "
                 f"ReferenceFrequency='{f0}', SpectralIndex='[]', "
                 "MajorAxis, MinorAxis, Orientation) = format\n")
        fh.write(", , center, 00:00:00.0, +00.00.00.0\n")
        for (name, ra, dec, sI, sp1, eX, eY, eP, rf0) in rows:
            hh, mm, ss = coords.rad_to_ra(ra)
            # sign handled here: rad_to_dec carries it on the first
            # NONZERO field, which would print '+00.-30.00' for
            # declinations in (-1, 0) deg
            sgn = "-" if dec < 0 else "+"
            dd, dm, ds = coords.rad_to_dec(abs(float(dec)))
            stype = "GAUSSIAN" if (eX or eY) else "POINT"
            # inverse of the parse-side convention
            # (orientation = deg2rad(o) - pi/2), so write/parse round-trip
            ori_deg = np.rad2deg(eP + np.pi / 2)
            fh.write(f"{name}, {stype}, center, "
                     f"{int(hh):02d}:{int(mm):02d}:{ss:06.3f}, "
                     f"{sgn}{int(dd):02d}.{int(dm):02d}.{ds:06.3f}, "
                     f"{sI}, 0, 0, 0, {rf0}, [{sp1}], "
                     f"{eX * 180 * 3600 / np.pi}, "
                     f"{eY * 180 * 3600 / np.pi}, "
                     f"{ori_deg}\n")


def read_rho(path, n_clusters):
    """admm rho file: 'id hybrid rho_spectral rho_spatial' per cluster.
    Returns (rho_spectral, rho_spatial), each (K,) float32.
    Reference: calibration_tools.py:470-484."""
    vals = np.asarray([[float(x) for x in ln.split()[:4]]
                       for ln in _data_lines(path)], dtype=np.float32)
    if vals.shape[0] != n_clusters:
        raise ValueError(f"rho file {path} has {vals.shape[0]} rows, "
                         f"expected {n_clusters}")
    return vals[:, 2].copy(), vals[:, 3].copy()


def write_rho(path, rho_spectral, rho_spatial, hybrid=1, ids=None):
    """Inverse of read_rho, format per reference calibenv.py:105-114.
    ``ids`` overrides the default 1..K numbering (files are matched by id
    externally, e.g. after convert_dp3_skymodel's start_cluster)."""
    with open(path, "w") as fh:
        fh.write("# id hybrid rho_spectral rho_spatial\n")
        for i, (rs, rp) in enumerate(zip(rho_spectral, rho_spatial)):
            cid = ids[i] if ids is not None else i + 1
            fh.write(f"{cid} {hybrid} {float(rs)} {float(rp)}\n")


def read_skycluster(path, n_rows):
    """skylmn table: 'cluster_id l m sI sP' -> (M, 5) float32.
    Reference: calibration_tools.py:488-502."""
    vals = np.asarray([[float(x) for x in ln.split()[:5]]
                       for ln in _data_lines(path)[:n_rows]], dtype=np.float32)
    return vals


def read_uvw_visibilities(path):
    """Text visibilities: u v w xx.re xx.im xy.re xy.im yx.re yx.im
    yy.re yy.im -> (XX, XY, YX, YY) complex vectors.
    Reference: readuvw, calibration_tools.py:505-512."""
    a = np.loadtxt(path, delimiter=" ")
    return (a[:, 3] + 1j * a[:, 4], a[:, 5] + 1j * a[:, 6],
            a[:, 7] + 1j * a[:, 8], a[:, 9] + 1j * a[:, 10])


def write_uvw_visibilities(path, XX, XY, YX, YY):
    """Inverse of read_uvw_visibilities (reference writeuvw, :515-522);
    writes only the 8 visibility columns, one sample per line."""
    cols = np.stack([XX.real, XX.imag, XY.real, XY.imag,
                     YX.real, YX.imag, YY.real, YY.imag], axis=-1)
    with open(path, "w") as fh:
        for row in cols:
            fh.write(" ".join(str(x) for x in row) + "\n")


def read_solutions(path):
    """Per-direction Jones solutions text file -> (freq, J).

    Header: 2 comment lines, then 'freq/MHz BW time N ? K'.  Body: Nt lines
    of 1+K floats; each block of 8N rows is one timeslot, station n's 8
    values are (J00.re, J00.im, J01.re, J01.im, J10.re, J10.im, J11.re,
    J11.im).  Returns J (K, 2*N*Nto, 2) complex64.
    Reference: readsolutions, calibration_tools.py:88-119."""
    with open(path) as fh:
        next(fh)
        next(fh)
        meta = next(fh).split()
        freq = float(meta[0]) * 1e6
        n_stat = int(meta[3])
        K = int(meta[5])
        body = np.loadtxt(fh, dtype=np.float32, ndmin=2)
    a = body[:, 1:1 + K]
    nto = a.shape[0] // (8 * n_stat)
    a = a[:nto * 8 * n_stat].reshape(nto, n_stat, 4, 2, K)
    c = a[:, :, :, 0, :] + 1j * a[:, :, :, 1, :]          # (Nto, N, 4, K)
    J = np.transpose(c, (3, 0, 1, 2)).reshape(K, 2 * n_stat * nto, 2)
    return freq, J.astype(np.complex64)


def write_solutions(path, freq, J, n_stat, bw_mhz=0.18, t_min=10.0):
    """Inverse of read_solutions: J (K, 2*N*Nto, 2) -> text file."""
    K = J.shape[0]
    nto = J.shape[1] // (2 * n_stat)
    c = J.reshape(K, nto, n_stat, 2, 2)                    # [k,t,n,i,j]
    c = np.transpose(c, (1, 2, 3, 4, 0)).reshape(nto, n_stat, 4, K)
    vals = np.empty((nto, n_stat, 8, K), dtype=np.float32)
    vals[:, :, 0::2] = c.real
    vals[:, :, 1::2] = c.imag
    flat = vals.reshape(nto * n_stat * 8, K)
    with open(path, "w") as fh:
        fh.write("# solutions file (smartcal_tpu)\n")
        fh.write("# freq(MHz) bandwidth(MHz) time_interval(min) stations"
                 " clusters effective_clusters\n")
        fh.write(f"{freq / 1e6} {bw_mhz} {t_min} {n_stat} {K} {K}\n")
        for i, row in enumerate(flat):
            fh.write(str(i % (8 * n_stat)) + " "
                     + " ".join(f"{x:.6e}" for x in row) + "\n")


def read_global_solutions(path):
    """Global Z polynomial solutions -> (N, freq, P, K, Z) with Z shaped
    (Nto, K, 2*P*N, 2) complex64.
    Reference: read_global_solutions, calibration_tools.py:122-160."""
    with open(path) as fh:
        next(fh)
        next(fh)
        meta = next(fh).split()
        freq = float(meta[0]) * 1e6
        P = int(meta[1])
        n_stat = int(meta[2])
        K = int(meta[4])
        body = np.loadtxt(fh, dtype=np.float32, ndmin=2)
    a = body[:, 1:1 + K]
    blk = 8 * P * n_stat
    nto = a.shape[0] // blk
    a = a[:nto * blk].reshape(nto, blk, K)
    c = a[:, 0::2, :] + 1j * a[:, 1::2, :]                # (Nto, 4PN, K)
    half = 2 * P * n_stat
    Z = np.empty((nto, K, half, 2), dtype=np.complex64)
    Z[..., 0] = np.transpose(c[:, :half, :], (0, 2, 1))
    Z[..., 1] = np.transpose(c[:, half:, :], (0, 2, 1))
    return n_stat, freq, P, K, Z


def read_spatial_solutions(path):
    """Spatial (spherical-harmonic) Z solutions -> (N, F, thetak, phik, Z)
    with Z shaped (Nto, 2*F*N, 2*G) complex64.
    Reference: read_spatial_solutions, calibration_tools.py:162-211."""
    with open(path) as fh:
        next(fh)
        next(fh)
        next(fh)
        meta = next(fh).split()
        F = int(meta[1])
        G = int(meta[2])
        n_stat = int(meta[3])
        thetak = [float(x) for x in next(fh).split()]
        phik = [float(x) for x in next(fh).split()]
        body = np.loadtxt(fh, dtype=np.float32, ndmin=2)
    a = body[:, 1:1 + G]
    blk = 8 * F * n_stat
    nto = a.shape[0] // blk
    a = a[:nto * blk].reshape(nto, blk, G)
    c = a[:, 0::2, :] + 1j * a[:, 1::2, :]                # (Nto, 4FN, G)
    half = 2 * F * n_stat
    Z = np.empty((nto, half, 2 * G), dtype=np.complex64)
    Z[:, :, 0::2] = c[:, :half, :]
    Z[:, :, 1::2] = c[:, half:, :]
    return n_stat, F, thetak, phik, Z


def read_cluster_lines(path):
    """Cluster file -> {order: raw line} for later regeneration of reduced
    cluster files.  Reference: readcluster, calibration_tools.py:1228-1249."""
    return {i: ln for i, ln in enumerate(_data_lines(path))}
