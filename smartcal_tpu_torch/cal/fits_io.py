"""Minimal first-party FITS image I/O (no astropy in the image):
the counterpart of smartcal_tpu/cal/fits_io.py, host numpy, writing files
byte-identical to the JAX package's.

The reference moves every image through FITS files: the envs read
``orig/{influenceI,data,res}.fits`` back from excon
(``calibration/calibenv.py:148-158``), and ``calmean.sh:1-100`` generates
a python script that inverse-variance-averages a list of FITS images into
``bar.fits`` carrying weighted BMAJ/BMIN, circular-mean BPA and weighted
CRVAL3/RESTFREQ headers.  The TPU framework keeps images as device arrays
end-to-end (``cal/imager.py``), but the FITS data edge is still the
interchange format a reference user expects for inspection and for
feeding external tools — this module provides it with plain numpy.

Scope: single-HDU image files, BITPIX -32/-64/16/32, the standard
2880-byte record structure, and the radio-image convention the reference
consumes — 4 axes (RA---SIN, DEC--SIN, FREQ, STOKES) with the pixel data
in the first two.  Not a general FITS library (no extensions, no tables,
no scaling beyond BSCALE/BZERO).
"""

from __future__ import annotations

import math
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

BLOCK = 2880
_BITPIX_DTYPE = {-32: ">f4", -64: ">f8", 16: ">i2", 32: ">i4", 8: ">u1"}


# ---------------------------------------------------------------------------
# Header cards
# ---------------------------------------------------------------------------

def _card(key: str, value, comment: str = "") -> bytes:
    """One 80-byte header card (fixed format)."""
    key = key.upper()
    if len(key) > 8:
        # never truncate silently — an 8-char prefix can collide with a
        # standard card (RESTFREQX -> RESTFREQ) and vanish without error
        raise ValueError(f"FITS keyword {key!r} exceeds 8 characters")
    if value is None:                          # comment-style card
        text = f"{key:<8}{comment:<72}"[:80]
        return text.encode("ascii")
    if isinstance(value, bool):
        v = "T" if value else "F"
        body = f"= {v:>20}"
    elif isinstance(value, (int, np.integer)):
        body = f"= {int(value):>20}"
    elif isinstance(value, (float, np.floating)):
        body = f"= {float(value):>20.13E}"
    else:                                      # string
        # never truncate silently (same policy as over-length keywords),
        # and never truncate AFTER escaping — cutting a doubled '' pair
        # in half would leave an unbalanced quote (ADVICE r4 item 1).
        # No CONTINUE-card support, so an unrepresentable value raises.
        s = str(value).replace("'", "''")
        if len(s) > 67:
            raise ValueError(
                f"FITS string value for {key} exceeds 67 characters "
                f"after quote escaping: {str(value)!r}")
        body = f"= '{s:<8}'"
    text = f"{key:<8}{body}"
    if comment:
        text += f" / {comment}"
    return f"{text:<80}"[:80].encode("ascii")


def _parse_value(raw: str):
    raw = raw.strip()
    if raw.startswith("'"):
        end = raw.rfind("'")
        return raw[1:end].replace("''", "'").rstrip()
    if raw in ("T", "F"):
        return raw == "T"
    try:
        if any(c in raw for c in ".EeDd") and not raw.lstrip("+-").isdigit():
            return float(raw.replace("D", "E").replace("d", "e"))
        return int(raw)
    except ValueError:
        return raw


def _pad(buf: bytes, fill: bytes = b" ") -> bytes:
    rem = (-len(buf)) % BLOCK
    return buf + fill * rem


# ---------------------------------------------------------------------------
# Write
# ---------------------------------------------------------------------------

def write_image(path, data, *, ra0: float = 0.0, dec0: float = 0.0,
                cell_rad: float = 1e-5, freq: float = 150e6,
                dfreq: float = 1e6, bmaj: Optional[float] = None,
                bmin: Optional[float] = None, bpa: Optional[float] = None,
                bunit: str = "JY/BEAM", object_name: str = "",
                extra: Optional[Dict[str, object]] = None) -> str:
    """Write a 2-D image as a 4-axis radio FITS file (BITPIX -32).

    ``data`` is (ny, nx) with the framework's row-major (l, m) layout
    (`cal/imager.pixel_grid`); stored as the standard (1, 1, ny, nx) cube
    so readers index ``[0, 0, y, x]`` exactly like the reference does
    (``calmean.sh``: ``itmp[0,0,XLOW:XHIGH,...]``).  ra0/dec0 in rad,
    cell_rad the pixel scale, freq on the FREQ axis (CRVAL3 — where
    ``calmean.sh`` reads it), bmaj/bmin/bpa in deg like excon emits.
    """
    img = np.ascontiguousarray(np.asarray(data, np.float32))
    if img.ndim != 2:
        raise ValueError(f"expected 2-D image, got shape {img.shape}")
    ny, nx = img.shape
    cdelt = math.degrees(cell_rad)
    std: List[Tuple[str, object, str]] = [
        # the JAX package's comment card: both packages write the same bytes
        ("SIMPLE", True, "first-party smartcal_tpu writer"),
        ("BITPIX", -32, ""),
        ("NAXIS", 4, ""),
        ("NAXIS1", nx, ""),
        ("NAXIS2", ny, ""),
        ("NAXIS3", 1, ""),
        ("NAXIS4", 1, ""),
        ("CTYPE1", "RA---SIN", ""),
        ("CRVAL1", math.degrees(ra0), ""),
        ("CDELT1", -cdelt, ""),
        ("CRPIX1", nx // 2 + 1.0, ""),
        ("CUNIT1", "deg", ""),
        ("CTYPE2", "DEC--SIN", ""),
        ("CRVAL2", math.degrees(dec0), ""),
        ("CDELT2", cdelt, ""),
        ("CRPIX2", ny // 2 + 1.0, ""),
        ("CUNIT2", "deg", ""),
        ("CTYPE3", "FREQ", ""),
        ("CRVAL3", float(freq), ""),
        ("CDELT3", float(dfreq), ""),
        ("CRPIX3", 1.0, ""),
        ("CUNIT3", "Hz", ""),
        ("CTYPE4", "STOKES", ""),
        ("CRVAL4", 1.0, ""),
        ("CDELT4", 1.0, ""),
        ("CRPIX4", 1.0, ""),
        ("BUNIT", bunit, ""),
    ]
    if object_name:
        std.append(("OBJECT", object_name, ""))
    for key, val in ((("BMAJ", bmaj), ("BMIN", bmin), ("BPA", bpa))):
        if val is not None:
            std.append((key, float(val), ""))
    # ``extra`` entries matching a standard card OVERRIDE it in place
    # (single card, original position) instead of appending a duplicate —
    # fits_mean uses this to carry an accepted base header's CRPIX /
    # CDELT1 / etc through to the output (ADVICE r4 item 2).  Structural
    # cards stay derived from the actual payload no matter what.
    structural = {"SIMPLE", "BITPIX"}

    def _is_structural(k: str) -> bool:
        # every NAXISn (any n, plus bare NAXIS) is payload-derived: a
        # carried-through NAXIS5 card from a 5-axis input would declare
        # an axis this 4-axis writer does not emit
        return k in structural or re.fullmatch(r"NAXIS\d*", k) is not None

    extra_d = {str(k).upper(): v for k, v in (extra or {}).items()
               if not _is_structural(str(k).upper())}
    cards: List[bytes] = []
    for key, val, com in std:
        if key in extra_d:
            val = extra_d.pop(key)
        cards.append(_card(key, val, com))
    for key, val in extra_d.items():
        cards.append(_card(key, val))
    cards.append(f"{'END':<80}".encode("ascii"))
    header = _pad(b"".join(cards))
    payload = _pad(img[None, None].astype(">f4").tobytes(), b"\0")
    tmp = str(path) + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(header)
        fh.write(payload)
    os.replace(tmp, str(path))
    return str(path)


# ---------------------------------------------------------------------------
# Read
# ---------------------------------------------------------------------------

def read_image(path) -> Tuple[np.ndarray, Dict[str, object]]:
    """(data, header): data squeezed to 2-D (ny, nx) float; header a dict
    of parsed cards.  Accepts any NAXIS as long as at most two axes are
    non-degenerate (the radio-image cube convention)."""
    with open(path, "rb") as fh:
        header: Dict[str, object] = {}
        while True:
            block = fh.read(BLOCK)
            if len(block) < BLOCK:
                raise ValueError(f"truncated FITS header in {path}")
            done = False
            for i in range(0, BLOCK, 80):
                card = block[i:i + 80].decode("ascii", "replace")
                key = card[:8].strip()
                if key == "END":
                    done = True
                    break
                if not key or key in ("COMMENT", "HISTORY"):
                    continue
                if card[8:10] != "= ":
                    continue
                body = card[10:]
                slash = _comment_split(body)
                header[key] = _parse_value(body[:slash])
            if done:
                break
        bitpix = int(header["BITPIX"])
        naxis = int(header["NAXIS"])
        shape = [int(header[f"NAXIS{i}"]) for i in range(naxis, 0, -1)]
        count = int(np.prod(shape)) if shape else 0
        dtype = np.dtype(_BITPIX_DTYPE[bitpix])
        nbytes = count * dtype.itemsize
        raw = fh.read(nbytes + (-nbytes) % BLOCK)[:nbytes]
        data = np.frombuffer(raw, dtype=dtype).reshape(shape)
    scale = float(header.get("BSCALE", 1.0))
    zero = float(header.get("BZERO", 0.0))
    arr = data.astype(np.float64) * scale + zero
    arr = np.squeeze(arr)
    if arr.ndim > 2:
        raise ValueError(f"more than two non-degenerate axes: {arr.shape}")
    return arr.astype(np.float32 if bitpix == -32 else np.float64), header


def _comment_split(body: str) -> int:
    """Index of the comment slash in a card body, quote-aware."""
    in_str = False
    for i, ch in enumerate(body):
        if ch == "'":
            in_str = not in_str
        elif ch == "/" and not in_str:
            return i
    return len(body)


# ---------------------------------------------------------------------------
# calmean: weighted average of FITS images
# ---------------------------------------------------------------------------

def fits_mean(paths: List[str], out: str, vmax: float = 0.01,
              vmin: float = 1e-12, box: Tuple[int, int, int, int] =
              (1, 10, 1, 10)) -> str:
    """Weighted mean of FITS images -> ``out`` (the calmean.sh role).

    Parity with the generated ``calmean_.py`` (``calmean.sh:1-100``):
    each accepted image contributes with inverse-variance weight
    sigma = 1/wt^2 where wt is the pixel std in ``box`` — images with
    wt outside (vmin, vmax) or NaN are rejected; BMAJ/BMIN and the FREQ
    value (CRVAL3, mirrored to RESTFREQ) are weight-averaged and BPA is
    a weighted circular mean; the output carries the first image's
    remaining header.  NOTE the shipped script currently short-circuits
    wt to a constant 0.99999 (every image accepted, plain mean) — with
    the default vmax=0.01 this implementation applies the variance gate
    the script documents; pass vmax=1.0 to reproduce the accept-all
    behavior.
    """
    if not paths:
        raise ValueError("fits_mean needs at least one input")
    xlo, xhi, ylo, yhi = box
    loaded = [read_image(p) for p in paths]
    acc = None
    wgt = 0.0
    bmaj = bmin = bpax = bpay = 0.0
    beam_wgt = 0.0
    freq0 = 0.0
    freq_wgt = 0.0                 # CRVAL3-carrying weight only — a
    # sigma that contributed no frequency must not dilute the average
    base_header = None             # first ACCEPTED image's header: the
    # output WCS must describe an image that actually contributed
    accepted = 0
    for img, hdr in loaded:
        wt = float(np.std(img[xlo:xhi, ylo:yhi]))
        if math.isnan(wt) or not (vmin < wt < vmax):
            continue
        if base_header is None:
            base_header = hdr
            acc = np.zeros_like(img, np.float64)
        sigma = 1.0 / (wt * wt)
        acc += img * sigma
        wgt += sigma
        accepted += 1
        if all(k in hdr for k in ("BMAJ", "BMIN", "BPA")):
            bmaj += float(hdr["BMAJ"]) * sigma
            bmin += float(hdr["BMIN"]) * sigma
            bpax += math.cos(math.radians(float(hdr["BPA"]))) * sigma
            bpay += math.sin(math.radians(float(hdr["BPA"]))) * sigma
            beam_wgt += sigma
        if "CRVAL3" in hdr:
            freq0 += float(hdr["CRVAL3"]) * sigma
            freq_wgt += sigma
    if base_header is None:        # every input rejected: zero image in
        base_header = loaded[0][1]  # the first input's frame
        acc = np.zeros_like(loaded[0][0], np.float64)
    if wgt == 0.0:
        wgt = 1.0                  # calmean.sh:78-80 parity
    mean = (acc / wgt).astype(np.float32)
    hdr = dict(base_header)
    freq = (freq0 / freq_wgt if freq_wgt > 0
            else float(hdr.get("CRVAL3", 0.0)))
    extra: Dict[str, object] = {"RESTFREQ": freq, "NIMAGES": accepted}
    beam = {}
    if beam_wgt > 0:
        beam = {"bmaj": bmaj / beam_wgt, "bmin": bmin / beam_wgt,
                "bpa": math.degrees(math.atan2(bpay / beam_wgt,
                                               bpax / beam_wgt))}
    # carry the base header's remaining cards through (the reference's
    # calmean copies the full first header): every card not computed
    # above rides along as an in-place override, so an externally
    # produced input with an off-center CRPIX or non-square CDELT1 keeps
    # a truthful WCS in the output (ADVICE r4 item 2).  Excluded: cards
    # re-derived from the payload (structural ones are dropped by
    # write_image itself), the weight-averaged quantities, and
    # BSCALE/BZERO — read_image already applied them to the pixels.
    computed = {"BSCALE", "BZERO", "EXTEND", "CRVAL3", "RESTFREQ",
                "NIMAGES"}
    if beam:
        computed |= {"BMAJ", "BMIN", "BPA"}
    for key, val in hdr.items():
        if key not in computed and key not in extra:
            extra[key] = val
    write_image(
        out, mean,
        ra0=math.radians(float(hdr.get("CRVAL1", 0.0))),
        dec0=math.radians(float(hdr.get("CRVAL2", 0.0))),
        cell_rad=math.radians(abs(float(hdr.get("CDELT2", 1e-5)))),
        freq=freq,
        bunit=str(hdr.get("BUNIT", "JY/BEAM")),
        extra=extra, **beam)
    return out
