"""The save_binary bin cache: its writer and its reader.

Copy of the cache format of lightgbm_tpu/io/stream.py (``write_bin_cache``,
``create_bin_cache``, ``bin_crc32s``): an npz whose ``bins`` member is the
(N, F) binned matrix, with a per-block CRC32 table (``bins_crc32``, one
entry per ``bins_crc_rows`` rows), the bin mappers and the rows' metadata.
The format is the same byte for byte in both packages, so a cache written
by either loads in the other.  ``read_bin_cache`` loads one whole and checks
every block against the table.

Not here (ROADMAP A12): the streamed sweeps of a cache (BinCacheStream,
out_of_core), appended rows and their segment files.
"""

from __future__ import annotations

import os
import tempfile
import zlib
from typing import Any, Dict

import numpy as np

# rows per CRC32 entry; independent of how the cache is later read
DEFAULT_CRC_ROWS = 65536


class CorruptBinCacheError(RuntimeError):
    """A save_binary cache whose matrix fails its CRC32 table: names the
    failing block and its rows."""

    def __init__(self, path: str, chunk_index: int, row_lo: int, row_hi: int,
                 reason: str):
        super().__init__(
            f"{path}:bins is corrupt at CRC chunk {chunk_index} (rows "
            f"[{row_lo}, {row_hi})): {reason}; rebuild it with save_binary")
        self.path = path
        self.chunk_index = chunk_index
        self.row_lo = row_lo
        self.row_hi = row_hi


def bin_crc32s(bins: np.ndarray, crc_rows: int = DEFAULT_CRC_ROWS) -> np.ndarray:
    """Per-block CRC32 table over a C-order 2-D binned matrix."""
    bins = np.ascontiguousarray(bins)
    crc_rows = max(int(crc_rows), 1)
    return np.asarray([zlib.crc32(bins[lo:lo + crc_rows]) & 0xFFFFFFFF
                       for lo in range(0, bins.shape[0], crc_rows)], np.uint32)


def write_bin_cache(fh, bins: np.ndarray, mappers, *, label=None, weight=None,
                    group=None, init_score=None, position=None, feature_names=(),
                    crc_rows: int = DEFAULT_CRC_ROWS) -> None:
    """The save_binary npz payload into the open binary file ``fh``;
    ``mappers`` is a DatasetBinner's mapper list."""
    bins_c = np.ascontiguousarray(bins)
    np.savez_compressed(
        fh,
        bins=bins_c,
        bins_crc32=bin_crc32s(bins_c, crc_rows),
        bins_crc_rows=np.asarray(crc_rows, np.int64),
        label=label if label is not None else np.zeros(0),
        weight=weight if weight is not None else np.zeros(0),
        group=group if group is not None else np.zeros(0, np.int64),
        init_score=init_score if init_score is not None else np.zeros(0),
        position=position if position is not None else np.zeros(0, np.int64),
        uppers=np.concatenate([np.asarray(m.upper_bounds, np.float64)
                               for m in mappers]),
        upper_sizes=np.asarray([len(m.upper_bounds) for m in mappers]),
        missing_types=np.asarray([m.missing_type for m in mappers]),
        cats=np.concatenate([
            np.asarray(m.categories, np.float64)
            if m.categories is not None else np.zeros(0) for m in mappers]),
        cat_sizes=np.asarray([
            len(m.categories) if m.categories is not None else 0
            for m in mappers]),
        min_values=np.asarray([m.min_value for m in mappers], np.float64),
        max_values=np.asarray([m.max_value for m in mappers], np.float64),
        feature_names=np.asarray(feature_names),
    )


def create_bin_cache(path: str, bins: np.ndarray, mappers, **kw) -> None:
    """Write a cache at ``path`` atomically: a temporary file in the same
    directory, fsynced, then renamed over ``path``, so a crash never
    leaves a torn cache.  ``kw`` goes to :func:`write_bin_cache`."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".tmp.", dir=d)
    try:
        umask = os.umask(0)
        os.umask(umask)
        os.fchmod(fd, 0o666 & ~umask)
        with os.fdopen(fd, "wb") as fh:
            write_bin_cache(fh, bins, mappers, **kw)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def is_bin_cache(path: str) -> bool:
    """Whether ``path`` is a zip file (a save_binary cache) rather than
    text."""
    with open(path, "rb") as fh:
        return fh.read(4) == b"PK\x03\x04"


def _live_segments(path: str, watermark: int) -> list:
    d = os.path.dirname(os.path.abspath(path))
    prefix = os.path.basename(path) + ".seg."
    return sorted(name for name in os.listdir(d) if name.startswith(prefix)
                  and name[len(prefix):].isdigit()
                  and int(name[len(prefix):]) > watermark)


def read_bin_cache(path: str) -> Dict[str, Any]:
    """Load a cache whole: {bins, mappers (the BinMapper fields of each
    feature), label, weight, group, init_score, position, feature_names},
    with empty metadata as None.  Every block of the matrix is checked
    against the CRC32 table (CorruptBinCacheError); a cache with appended
    segments not folded into it raises NotImplementedError (ROADMAP A12)."""
    with np.load(path, allow_pickle=False) as z:
        watermark = (int(np.asarray(z["bins_seg_watermark"]).reshape(-1)[0])
                     if "bins_seg_watermark" in z.files else -1)
        if _live_segments(path, watermark):
            raise NotImplementedError(
                f"{path} has appended segment files: reading them is not ported "
                "to lightgbm_tpu_torch yet (ROADMAP queue A12)")
        bins = np.asarray(z["bins"])
        if "bins_crc32" in z.files:
            rows = int(np.asarray(z["bins_crc_rows"]).reshape(-1)[0])
            want = np.asarray(z["bins_crc32"], np.uint32)
            got = bin_crc32s(bins, rows)
            if len(got) != len(want):
                raise CorruptBinCacheError(path, min(len(got), len(want)), 0,
                                           bins.shape[0], "the CRC table has "
                                           f"{len(want)} entries for {len(got)} blocks")
            bad = np.flatnonzero(got != want)
            if len(bad):
                k = int(bad[0])
                raise CorruptBinCacheError(path, k, k * rows,
                                           min((k + 1) * rows, bins.shape[0]),
                                           "CRC32 mismatch")
        sizes = z["upper_sizes"]
        uppers, mt = z["uppers"], z["missing_types"]
        cat_sizes = (z["cat_sizes"] if "cat_sizes" in z.files
                     else np.zeros(len(sizes), np.int64))
        cats = z["cats"] if "cats" in z.files else np.zeros(0)
        minv = z["min_values"] if "min_values" in z.files else np.zeros(len(sizes))
        maxv = z["max_values"] if "max_values" in z.files else np.zeros(len(sizes))
        mappers, off, coff = [], 0, 0
        for i, s in enumerate(sizes):
            s, cs = int(s), int(cat_sizes[i])
            mappers.append(dict(upper_bounds=uppers[off:off + s],
                                missing_type=int(mt[i]), is_categorical=cs > 0,
                                categories=cats[coff:coff + cs] if cs else None,
                                min_value=float(minv[i]), max_value=float(maxv[i])))
            off += s
            coff += cs

        def member(name):
            if name not in z.files:
                return None
            v = np.asarray(z[name])
            return v if v.size else None

        out = {name: member(name) for name in ("label", "weight", "group",
                                               "init_score", "position")}
        out.update(bins=bins, mappers=mappers,
                   feature_names=[str(x) for x in z["feature_names"]])
    return out
