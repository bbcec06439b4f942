"""Bin caches: the save_binary format, streamed sweeps, appended segments.

Copy of lightgbm_tpu/io/stream.py's cache functions (the format is the same
byte for byte in both packages, so a cache written by either reads in the
other): an npz whose ``bins`` member is the (N, F) binned matrix, with a
per-block CRC32 table (``bins_crc32``, one entry per ``bins_crc_rows``
rows), the bin mappers and the rows' metadata.

* ``BinCacheStream`` reads the matrix member sequentially in row chunks
  through one reused host buffer (an .npy payload is a header and then the
  C-order rows; a zip member streams), checking every CRC block as its
  rows complete, and goes on through the live appended segments;
* ``append_rows`` appends binned rows atomically: a streamed rewrite, or a
  CRC'd sidecar segment ``<path>.seg.<k>`` (``segment_threshold``) folded
  back by ``compact_bin_cache`` under a watermark, so a segment a crash
  strands is ignored, never counted twice;
* ``read_bin_cache`` loads a cache whole (segments included) and
  ``read_cache_meta`` everything but the matrix;
* ``prefetch_device`` (torch, the JAX package's is JAX's): a one-deep
  upload pipeline through two reused staging buffers, pinned when the
  target is the card, each written again only after the event behind its
  last copy has completed; on the card the uploads run on a copy stream
  the consumer's stream waits on.

Not here (ROADMAP A13): a rank's reads of its rows of a shared cache
(``read_cache_shard``, ``cache_shard_fingerprint`` and the Dataset's
``bin_cache_shard``), which the distributed launcher's cache feed takes;
they raise.  ``BinCacheStream``'s ``shard=`` range stays: the segment
sweep reads its sub-ranges through it.
"""

from __future__ import annotations

import ast
import io as _io
import os
import tempfile
import zipfile
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

DEFAULT_CHUNK_ROWS = 65536

# fixed CRC32 block size for save_binary caches (rows per CRC entry) —
# independent of the READ chunk size, so any sweep granularity verifies
# against the same trailer table
DEFAULT_CRC_ROWS = 65536


class CorruptBinCacheError(RuntimeError):
    """A ``save_binary`` cache failed integrity verification while
    streaming: a per-chunk CRC32 mismatch, a truncated member, or a
    decompression failure.  Carries the failing CRC chunk and its row
    range, so the error names WHERE the cache is bad instead of letting
    training proceed on garbage bins."""

    def __init__(self, path: str, member: str, chunk_index: int,
                 row_lo: int, row_hi: int, reason: str):
        super().__init__(
            f"{path}:{member} is corrupt at CRC chunk {chunk_index} "
            f"(rows [{row_lo}, {row_hi})): {reason} — the bin cache is "
            "torn or bit-rotted; rebuild it with save_binary "
            "(docs/ROBUSTNESS.md)")
        self.path = path
        self.member = member
        self.chunk_index = chunk_index
        self.row_lo = row_lo
        self.row_hi = row_hi


def bin_crc32s(bins: np.ndarray,
               crc_rows: int = DEFAULT_CRC_ROWS) -> np.ndarray:
    """Per-block CRC32 table over a C-order 2-D binned matrix — the
    values ``save_binary`` stores next to the matrix and
    :class:`BinCacheStream` verifies on read."""
    bins = np.ascontiguousarray(bins)
    crc_rows = max(int(crc_rows), 1)
    out = [zlib.crc32(bins[lo:lo + crc_rows]) & 0xFFFFFFFF
           for lo in range(0, bins.shape[0], crc_rows)]
    return np.asarray(out, np.uint32)


def _read_npy_header(fh) -> Tuple[tuple, np.dtype, bool]:
    """Parse an .npy stream's header: (shape, dtype, fortran_order).
    Reads exactly the header bytes, leaving the stream at element 0."""
    magic = fh.read(6)
    if magic != b"\x93NUMPY":
        raise ValueError("not an .npy stream (bad magic)")
    major, _minor = fh.read(1)[0], fh.read(1)[0]
    if major == 1:
        hlen = int.from_bytes(fh.read(2), "little")
    else:
        hlen = int.from_bytes(fh.read(4), "little")
    header = ast.literal_eval(fh.read(hlen).decode("latin1"))
    return (tuple(header["shape"]), np.dtype(header["descr"]),
            bool(header["fortran_order"]))


class BinCacheStream:
    """Chunked sequential reader of one array member of a save_binary npz.

    ``shape``/``dtype`` come from the member header without reading the
    payload.  :meth:`chunks` yields ``(row_lo, view)`` pairs where
    ``view`` is a window into the SAME reused buffer — consumers must
    copy (device upload copies) before advancing.  Re-iterable: each
    :meth:`chunks` call reopens the member (a fresh sequential
    decompress — the out-of-core price for a full pass).

    ``shard=(row_lo, row_hi)`` restricts the stream to that row range —
    the rank-sharded form for distributed out-of-core training: each
    rank streams ONLY its shard of one shared cache (the fleet manifest
    already fingerprints per-rank shards, docs/ROBUSTNESS.md), paying a
    seek instead of a whole-prefix decompress on the stored (default
    ``save_binary``) members.  ``chunks`` then yields GLOBAL row_lo
    values within [row_lo, row_hi); CRC32 blocks are verified whenever
    the stream covers them from their true start — blocks cut by a shard
    boundary cannot be (their prefix bytes were never read) and are
    skipped, so a whole-cache sweep still verifies everything while a
    shard sweep verifies every fully-covered block."""

    def __init__(self, path: str, member: str = "bins",
                 shard: Optional[Tuple[int, int]] = None) -> None:
        self.path = path
        self.member = member + ".npy"
        try:
            with zipfile.ZipFile(path) as zf, zf.open(self.member) as fh:
                shape, dtype, fortran = _read_npy_header(fh)
        except (zipfile.BadZipFile, zlib.error) as e:
            # small stored members are CRC-checked whole by zipfile on the
            # very first read: surface the same typed row-ranged error the
            # sweep path raises instead of a raw BadZipFile
            raise CorruptBinCacheError(
                path, self.member, 0, 0, 0,
                f"{type(e).__name__}: {e}") from None
        if fortran or len(shape) != 2:
            raise ValueError(
                f"{path}:{self.member} must be a C-order 2-D array for row "
                f"streaming (shape={shape}, fortran={fortran})")
        self.shape = shape
        self.dtype = dtype
        # base-member row extent — live append SEGMENTS (
        # sidecar `<path>.seg.<k>` files) ride BEHIND it in the logical
        # row space; self.shape grows to cover them below
        self._base_rows = int(shape[0])
        # per-chunk CRC trailer table (written by save_binary since round
        # 13).  Old trailerless caches still load — with a warning, since
        # nothing can vouch for their bytes.
        self.crc_rows: Optional[int] = None
        self.crcs: Optional[np.ndarray] = None
        # append-origin log (continual ingest): global row
        # offsets where each append_rows() call began, so a row-ranged
        # corruption error can NAME the appended chunk it falls in
        self.append_log: Optional[np.ndarray] = None
        # compaction watermark (): segment indices <= watermark
        # are already folded into the base member — a stale sidecar left
        # by a crash between the compaction's atomic replace and its
        # segment deletes is IGNORED, never double-counted
        self.seg_watermark = -1
        try:
            with np.load(path, allow_pickle=False) as z:
                if (f"{member}_crc32" in z.files
                        and f"{member}_crc_rows" in z.files):
                    self.crcs = np.asarray(z[f"{member}_crc32"], np.uint32)
                    self.crc_rows = max(
                        int(np.asarray(z[f"{member}_crc_rows"]).reshape(-1)[0]),
                        1)
                if f"{member}_append_rows" in z.files:
                    self.append_log = np.asarray(
                        z[f"{member}_append_rows"], np.int64)
                if f"{member}_seg_watermark" in z.files:
                    self.seg_watermark = int(np.asarray(
                        z[f"{member}_seg_watermark"]).reshape(-1)[0])
        except (OSError, ValueError, zipfile.BadZipFile):
            pass  # chunk reads will surface real corruption row-ranged
        # live segments: each is itself a mini bin cache (bins + CRC
        # table + label/weight), so a nested stream verifies it with the
        # SAME machinery.  Segment files are never themselves segmented
        # (append_rows only writes sidecars next to the base path).
        self.segments: List[Tuple[int, str, int]] = []  # (k, path, rows)
        if member == "bins":
            n_total = self._base_rows
            starts: List[int] = []
            for k, sp in _live_segments(path, self.seg_watermark):
                sub = BinCacheStream(sp)
                if (sub.shape[1] != shape[1] or sub.dtype != self.dtype):
                    raise CorruptBinCacheError(
                        sp, "bins.npy", 0, 0, sub.shape[0],
                        f"segment shape {sub.shape}/{sub.dtype} does not "
                        f"match base cache {shape}/{self.dtype}")
                starts.append(n_total)
                self.segments.append((k, sp, sub.shape[0]))
                n_total += sub.shape[0]
            if self.segments:
                self.shape = (n_total, shape[1])
                base_log = (np.asarray(self.append_log, np.int64)
                            if self.append_log is not None
                            else np.zeros(0, np.int64))
                self.append_log = np.concatenate(
                    [base_log, np.asarray(starts, np.int64)])
        if shard is not None:
            lo, hi = int(shard[0]), int(shard[1])
            if not (0 <= lo < hi <= self.shape[0]):
                raise ValueError(
                    f"shard range [{lo}, {hi}) is outside the cache's "
                    f"{self.shape[0]} rows")
            self.shard = (lo, hi)
        else:
            self.shard = None
        if self.crcs is not None:
            expect = (-(-self._base_rows // self.crc_rows)
                      if self._base_rows else 0)
            if len(self.crcs) != expect:
                raise CorruptBinCacheError(
                    path, self.member, 0, 0, min(self.crc_rows,
                                                 self._base_rows),
                    f"CRC table has {len(self.crcs)} entries, "
                    f"expected {expect}")
        else:
            from ..utils.log import log_warning

            log_warning(
                f"bin cache {path} carries no per-chunk CRC trailers "
                "(pre-round-13 format): reads cannot be verified against "
                "bit-rot — re-run save_binary to upgrade it")

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def shard_rows(self) -> int:
        """Rows this stream actually yields (== n_rows without a shard)."""
        if self.shard is None:
            return self.shape[0]
        return self.shard[1] - self.shard[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    def _corrupt(self, row: int, reason: str) -> CorruptBinCacheError:
        crc_rows = self.crc_rows or DEFAULT_CRC_ROWS
        chunk = row // crc_rows
        if self.append_log is not None and len(self.append_log):
            # name the appended chunk the bad row falls in: the newest
            # append whose start row is <= the failing row (rows before
            # the first append are the original save_binary payload)
            starts = np.asarray(self.append_log, np.int64)
            k = int(np.searchsorted(starts, row, side="right")) - 1
            if k >= 0:
                reason += (f" (inside appended chunk {k} — append_rows() "
                           f"call starting at row {int(starts[k])})")
            else:
                reason += " (inside the original pre-append payload)"
        return CorruptBinCacheError(
            self.path, self.member, chunk, chunk * crc_rows,
            min((chunk + 1) * crc_rows, self.shape[0]), reason)

    def chunks(self, chunk_rows: int) -> Iterator[Tuple[int, np.ndarray]]:
        """Sequential (row_lo, chunk_view) sweep; the view aliases one
        reused buffer of ``chunk_rows`` rows (allocated once here).

        Every sweep re-verifies the per-chunk CRC32 table when the cache
        carries one: the rolling CRC is checked at each CRC-block
        boundary BEFORE the rows completing the block are yielded, so a
        corrupt or truncated cache raises the row-ranged
        :class:`CorruptBinCacheError` at the failing chunk instead of
        feeding garbage bins to training.  (With the default read chunk
        == CRC block size, no unverified row is ever yielded; smaller
        read chunks may see at most one partially-verified trailing
        block's rows before its boundary check runs.)

        With a ``shard`` the sweep covers only [row_lo, row_hi): the
        member is seeked to row_lo (stored members skip the prefix
        without decompressing it) and blocks the shard enters mid-way
        are skipped by verification, never trusted blind — a corrupt
        byte inside any FULLY covered block still raises row-ranged.

        Live append segments ride transparently: the sweep covers the
        base member, then each segment in index order, with GLOBAL row
        offsets — each segment verifies against its OWN CRC table
        through a nested stream."""
        lo0, hi0 = self.shard if self.shard is not None else (0,
                                                              self.shape[0])
        nb = self._base_rows
        if lo0 < nb:
            yield from self._base_chunks(chunk_rows, lo0, min(hi0, nb))
        off = nb
        for _k, sp, n_seg in self.segments:
            s_lo, s_hi = max(lo0 - off, 0), min(hi0 - off, n_seg)
            if s_lo < s_hi:
                sub = BinCacheStream(
                    sp, shard=((s_lo, s_hi) if (s_lo, s_hi) != (0, n_seg)
                               else None))
                for seg_lo, view in sub.chunks(chunk_rows):
                    yield off + seg_lo, view
            off += n_seg

    def _base_chunks(self, chunk_rows: int, lo0: int,
                     hi0: int) -> Iterator[Tuple[int, np.ndarray]]:
        """The base-member sweep over rows [lo0, hi0) — the pre-segment
        chunks() body, with the row range parameterized so the composed
        sweep can clip it to the base extent."""
        n, f = self._base_rows, self.shape[1]
        chunk_rows = max(int(chunk_rows), 1)
        buf = np.empty((chunk_rows, f), self.dtype)  # the reused buffer
        flat = buf.reshape(-1).view(np.uint8)
        row_bytes = f * self.dtype.itemsize
        verify = self.crcs is not None
        crc_cur = 0  # rolling CRC of the current (partial) CRC block
        # a shard entering a CRC block mid-way cannot verify it (the
        # block's leading bytes were never read); arm from the first
        # block the shard covers from its true start
        crc_valid = verify and (not lo0 or lo0 % self.crc_rows == 0)
        with zipfile.ZipFile(self.path) as zf, zf.open(self.member) as fh:
            _read_npy_header(fh)  # skip to element 0
            if lo0:
                try:
                    fh.seek(fh.tell() + lo0 * row_bytes)
                except (OSError, zipfile.BadZipFile, zlib.error) as e:
                    raise self._corrupt(
                        lo0, f"seek to shard start failed: "
                        f"{type(e).__name__}: {e}") from None
            lo = lo0
            while lo < hi0:
                m = min(chunk_rows, hi0 - lo)
                want = m * row_bytes
                got = 0
                mv = memoryview(flat)[:want]
                while got < want:
                    try:
                        k = fh.readinto(mv[got:])
                    except (zipfile.BadZipFile, zlib.error, OSError) as e:
                        raise self._corrupt(
                            lo + got // row_bytes,
                            f"{type(e).__name__}: {e}") from None
                    if not k:
                        raise self._corrupt(lo + got // row_bytes,
                                            "truncated member")
                    got += k
                if verify:
                    # feed the freshly read rows into the rolling CRC,
                    # checking every block boundary they complete
                    pos, row, end_row = 0, lo, lo + m
                    while row < end_row:
                        block = row // self.crc_rows
                        block_end = min((block + 1) * self.crc_rows, n)
                        take = min(block_end, end_row) - row
                        if crc_valid:
                            crc_cur = zlib.crc32(
                                mv[pos:pos + take * row_bytes], crc_cur)
                        pos += take * row_bytes
                        row += take
                        if row == block_end:
                            if crc_valid and (crc_cur & 0xFFFFFFFF) != int(
                                    self.crcs[block]):
                                raise self._corrupt(block_end - 1,
                                                    "CRC32 mismatch")
                            crc_cur = 0
                            crc_valid = verify  # past the shard's cut
                            # block, every block starts from its true head
                yield lo, buf[:m]
                lo += m


def read_cache_shard(path: str, row_lo: int, row_hi: int, *args, **kwargs):
    """Rows [row_lo, row_hi) of a shared cache, a rank's feed: not ported
    (ROADMAP queue A13, the distributed launcher)."""
    raise NotImplementedError("read_cache_shard (a rank's rows of a shared cache) is "
                              "not ported to lightgbm_tpu_torch yet (ROADMAP queue A13)")


def cache_shard_fingerprint(path: str, row_lo: int, row_hi: int, *args, **kwargs):
    """A rank's shard fingerprint for the launcher's manifests: not ported
    (ROADMAP queue A13)."""
    raise NotImplementedError("cache_shard_fingerprint is not ported to "
                              "lightgbm_tpu_torch yet (ROADMAP queue A13)")


# ---------------------------------------------------------------------------
# append-able caches (continual ingest — README "Continuous
# training"): save_binary caches grow in place through append_rows(), so a
# live trainer can keep CRC-verified durable ingest without ever holding
# the whole matrix.  The write is a streamed REWRITE (zip members cannot
# be extended in place): the old payload is swept once through the same
# verified BinCacheStream path every training sweep uses — so appending to
# a corrupt cache fails row-ranged BEFORE the atomic replace, and the old
# file survives intact — and the fresh CRC table covers every row, old and
# new.  Appending to a LEGACY (trailerless) cache UPGRADES it: the sweep
# is the one moment every old byte passes through host memory anyway, so
# the new file always carries a full table instead of silently mixing
# verified new blocks with unverifiable old ones.
# ---------------------------------------------------------------------------


class _CrcTableBuilder:
    """Rolling per-block CRC32 over a row stream (the bin_crc32s layout,
    fed incrementally so the appended cache's table is computed in the
    same single sweep that writes the payload)."""

    def __init__(self, crc_rows: int, row_bytes: int):
        self.crc_rows = max(int(crc_rows), 1)
        self.row_bytes = int(row_bytes)
        self._crc = 0
        self._rows_in_block = 0
        self._table: List[int] = []

    def feed(self, data, n_rows: int) -> None:
        mv = memoryview(data)
        pos = 0
        while n_rows:
            take = min(self.crc_rows - self._rows_in_block, n_rows)
            self._crc = zlib.crc32(mv[pos:pos + take * self.row_bytes],
                                   self._crc)
            pos += take * self.row_bytes
            self._rows_in_block += take
            n_rows -= take
            if self._rows_in_block == self.crc_rows:
                self._table.append(self._crc & 0xFFFFFFFF)
                self._crc = 0
                self._rows_in_block = 0

    def finish(self) -> np.ndarray:
        if self._rows_in_block:
            self._table.append(self._crc & 0xFFFFFFFF)
            self._crc = 0
            self._rows_in_block = 0
        return np.asarray(self._table, np.uint32)


def _npy_member_bytes(arr: np.ndarray) -> bytes:
    """Full .npy byte payload for a small array member."""
    bio = _io.BytesIO()
    np.save(bio, np.ascontiguousarray(arr), allow_pickle=False)
    return bio.getvalue()


def _write_streamed_bins(zf: zipfile.ZipFile, member: str,
                         n_rows: int, n_cols: int, dtype: np.dtype,
                         chunks: Iterator[Tuple[int, np.ndarray]],
                         crc: _CrcTableBuilder) -> None:
    """Write ``member`` (an .npy of (n_rows, n_cols) ``dtype``) into an
    open zip by streaming row chunks — the matrix is never materialized
    whole, the out-of-core contract this module exists for.  ZIP_STORED,
    so shard seeks on the result stay O(1)."""
    zinfo = zipfile.ZipInfo(member)
    zinfo.compress_type = zipfile.ZIP_STORED
    header = _io.BytesIO()
    np.lib.format.write_array_header_1_0(
        header, {"descr": np.lib.format.dtype_to_descr(np.dtype(dtype)),
                 "fortran_order": False, "shape": (int(n_rows), int(n_cols))})
    with zf.open(zinfo, "w", force_zip64=True) as out:
        out.write(header.getvalue())
        for _lo, view in chunks:
            block = np.ascontiguousarray(view, dtype=dtype)
            data = block.reshape(-1).view(np.uint8).data
            out.write(data)
            crc.feed(data, block.shape[0])


def write_bin_cache(fh, bins: np.ndarray, mappers, *,
                    label=None, weight=None, group=None, init_score=None,
                    position=None, feature_names=(),
                    crc_rows: int = DEFAULT_CRC_ROWS, compress: bool = True) -> None:
    """The save_binary npz payload (Dataset._savez_binary delegates here;
    the continual runner also creates fresh ingest caches through it
    without needing a Dataset).  ``mappers`` is a DatasetBinner-style
    mapper list; the per-chunk CRC32 trailer table always rides along.
    ``compress=False`` stores the members uncompressed."""
    bins_c = np.ascontiguousarray(bins)
    # compress=False stores the members (ZIP_STORED): a streamed sweep
    # then reads the matrix without inflating it, pass after pass
    (np.savez_compressed if compress else np.savez)(
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


def _atomic_replace(path: str, write_fn, mode: int) -> None:
    """The ONE binary crash-safety scaffold (same-dir temp + explicit
    permissions + fsync AFTER ``write_fn`` returns + ``os.replace``):
    :func:`create_bin_cache` and :func:`append_rows` both ride it, so
    the recipe cannot drift between the create and append halves
    (utils/checkpoint.py owns the separate text+trailer variant).
    ``write_fn(fh)`` must fully CLOSE any framing it opens (e.g. a
    ZipFile's central directory) before returning — the fsync here is
    the last write barrier before publication."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".tmp.",
                               dir=d)
    try:
        os.fchmod(fd, mode)
        with os.fdopen(fd, "wb") as fh:
            write_fn(fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _umask_mode() -> int:
    """0o666 under the current umask — what a plain open()-write would
    create (shared dirs, serving processes under another uid; the same
    rule utils/checkpoint.py's atomic writer applies)."""
    umask = os.umask(0)
    os.umask(umask)
    return 0o666 & ~umask


def create_bin_cache(path: str, bins: np.ndarray, mappers, **kw) -> None:
    """Atomically CREATE a save_binary cache at ``path``: the
    creation-side counterpart of :func:`append_rows`'s crash contract —
    a crash mid-write must not leave a torn cache that poisons every
    later append.  ``kw`` forwards to :func:`write_bin_cache`."""
    _atomic_replace(path, lambda fh: write_bin_cache(fh, bins, mappers,
                                                     **kw),
                    _umask_mode())


# members append_rows recomputes; everything else (mappers, group,
# init_score, position, names) is byte-copied verbatim from the old zip
_APPEND_REWRITTEN = ("bins.npy", "bins_crc32.npy", "bins_crc_rows.npy",
                     "bins_append_rows.npy", "bins_seg_watermark.npy",
                     "label.npy", "weight.npy")


def _seg_path(path: str, k: int) -> str:
    return f"{path}.seg.{k}"


def _live_segments(path: str, watermark: int) -> List[Tuple[int, str]]:
    """Sidecar segment files of ``path`` NOT yet folded into the base
    (index past the compaction watermark), in index order.  A cheap
    directory scan — no payload reads."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    prefix = os.path.basename(path) + ".seg."
    out: List[Tuple[int, str]] = []
    try:
        names = os.listdir(d)
    except OSError:
        return out
    for name in names:
        if not name.startswith(prefix):
            continue
        tail = name[len(prefix):]
        if not tail.isdigit():
            continue  # temp files from an in-flight atomic write
        k = int(tail)
        if k > watermark:
            out.append((k, os.path.join(d, name)))
    out.sort()
    return out


def _cache_row_meta(path: str, stream: "BinCacheStream"):
    """(label, weight, group, init_score, position) across the base npz
    AND its live segments — the concatenated per-row metadata a rewrite
    or materialized load must carry (group/init/position never ride
    segments: appends refuse those caches outright)."""
    with np.load(path, allow_pickle=False) as z:
        label = z["label"] if "label" in z.files else np.zeros(0)
        weight = z["weight"] if "weight" in z.files else np.zeros(0)
        group = z["group"] if "group" in z.files else np.zeros(0)
        init = z["init_score"] if "init_score" in z.files else np.zeros(0)
        pos = z["position"] if "position" in z.files else np.zeros(0)
    labels, weights = [np.asarray(label, np.float64)], [
        np.asarray(weight, np.float64)]
    for _k, sp, _n in stream.segments:
        with np.load(sp, allow_pickle=False) as z:
            if "label" in z.files and z["label"].size:
                labels.append(np.asarray(z["label"], np.float64))
            if "weight" in z.files and z["weight"].size:
                weights.append(np.asarray(z["weight"], np.float64))
    return (np.concatenate(labels), np.concatenate(weights),
            group, init, pos)


def _validate_append(path: str, stream: "BinCacheStream", bins_new,
                    label, weight):
    """Shared admission checks for both append modes.  Returns
    (bins_new_contig, label_f64_or_None, weight_f64_or_None,
    old_label, old_weight)."""
    f = stream.shape[1]
    bins_new = np.ascontiguousarray(bins_new)
    if bins_new.ndim != 2 or bins_new.shape[1] != f:
        raise ValueError(
            f"append_rows: appended chunk has shape {bins_new.shape}, "
            f"cache {path} holds {f}-feature rows")
    info = np.iinfo(stream.dtype) if np.issubdtype(stream.dtype, np.integer) \
        else None
    if info is not None and bins_new.size and (
            int(bins_new.max()) > info.max or int(bins_new.min()) < info.min):
        raise ValueError(
            f"append_rows: bin values outside the cache dtype "
            f"{stream.dtype} — the chunk was not binned by this cache's "
            "mappers")
    old_label, old_weight, old_group, old_init, old_pos = _cache_row_meta(
        path, stream)
    if old_group.size or old_init.size or old_pos.size:
        raise ValueError(
            "append_rows: caches carrying group/init_score/position rows "
            "cannot be appended to (per-row metadata would go out of step)")
    n_new = int(bins_new.shape[0])
    if old_label.size:
        if label is None:
            raise ValueError(
                f"append_rows: cache {path} carries labels; the appended "
                "chunk must bring labels too")
        label = np.asarray(label, np.float64).ravel()
        if len(label) != n_new:
            raise ValueError(
                f"append_rows: {n_new} rows but {len(label)} labels")
    elif label is not None:
        raise ValueError(
            f"append_rows: cache {path} carries no labels; appending "
            "labeled rows would leave the original rows unlabeled")
    if old_weight.size:
        if weight is None:
            raise ValueError(
                f"append_rows: cache {path} carries weights; the appended "
                "chunk must bring weights too")
        weight = np.asarray(weight, np.float64).ravel()
        if len(weight) != n_new:
            raise ValueError(
                f"append_rows: {n_new} rows but {len(weight)} weights")
    elif weight is not None:
        raise ValueError(
            f"append_rows: cache {path} carries no weights; appending "
            "weighted rows would leave the original rows unweighted")
    return bins_new, label, weight, old_label, old_weight


def _rewrite_cache(path: str, stream: "BinCacheStream", bins_new,
                   new_label: np.ndarray, new_weight: np.ndarray,
                   append_log: np.ndarray, watermark: int,
                   chunk_rows: int) -> None:
    """Stream base + live segments (+ optionally fresh rows) into a new
    base npz through the ONE atomic-replace scaffold.  Every old byte
    passes the verified chunks() path, so corruption raises row-ranged
    BEFORE the replace; the watermark member marks every folded segment
    index so stale sidecars a crash leaves behind are ignored."""
    n_total = stream.shape[0] + (int(bins_new.shape[0])
                                 if bins_new is not None else 0)
    f = stream.shape[1]
    crc_rows = stream.crc_rows or DEFAULT_CRC_ROWS
    crc = _CrcTableBuilder(crc_rows, f * stream.dtype.itemsize)

    def _write(fh):
        # closing the ZipFile INSIDE the writer is what makes the
        # scaffold's post-writer fsync cover the central directory
        with zipfile.ZipFile(fh, "w", zipfile.ZIP_STORED) as zf:
            # the old payload (base AND segments) sweeps through the
            # VERIFIED stream (chunks() raises row-ranged on corruption
            # — before the replace ever runs), chained with the new
            # rows; one CRC table covers every seam
            def _all_chunks():
                yield from stream.chunks(chunk_rows)
                if bins_new is not None:
                    yield from array_chunks(bins_new, chunk_rows)

            _write_streamed_bins(zf, "bins.npy", n_total, f,
                                 stream.dtype, _all_chunks(), crc)
            zf.writestr("bins_crc32.npy", _npy_member_bytes(crc.finish()))
            zf.writestr("bins_crc_rows.npy",
                        _npy_member_bytes(np.asarray(crc_rows, np.int64)))
            zf.writestr("bins_append_rows.npy",
                        _npy_member_bytes(append_log))
            if watermark >= 0:
                zf.writestr("bins_seg_watermark.npy",
                            _npy_member_bytes(np.asarray(watermark,
                                                         np.int64)))
            zf.writestr("label.npy", _npy_member_bytes(new_label))
            zf.writestr("weight.npy", _npy_member_bytes(new_weight))
            with zipfile.ZipFile(path) as zf_old:
                for name in zf_old.namelist():
                    if name not in _APPEND_REWRITTEN:
                        zf.writestr(name, zf_old.read(name))

    # keep the original cache's permissions: a shared (e.g. 0644,
    # serving process under another uid) cache stays readable after
    # its first append
    _atomic_replace(path, _write, os.stat(path).st_mode & 0o7777)


def append_rows(path: str, bins_new: np.ndarray, *,
                label=None, weight=None,
                chunk_rows: int = DEFAULT_CHUNK_ROWS,
                segment_threshold: Optional[int] = None) -> int:
    """Append binned rows (already transformed by the cache's FROZEN
    mappers) to a save_binary cache, atomically.

    Two modes, both riding the one :func:`_atomic_replace` scaffold:

    * **rewrite** (default, ``segment_threshold`` unset/0) — the old
      payload streams through the CRC-verified :class:`BinCacheStream`
      path into a same-directory temp file, the new rows follow, and
      ``os.replace`` publishes.  Any live segments fold in on the way
      through.  O(total rows) per append, but the cache stays one file.
    * **segment** (``segment_threshold >= 1``) — the new rows land in a
      CRC'd sidecar ``<path>.seg.<k>`` (its OWN atomic replace; the base
      file is untouched), O(new rows) per append — the continual
      runner's steady-state ingest cost.  Once live segments reach the
      threshold, :func:`compact_bin_cache` folds them back into the base
      (the rewrite path), bumping the compaction watermark so sidecars a
      crash strands are ignored, never double-counted.

    A crash anywhere leaves the previous logical cache intact, and a
    corrupt old cache raises the row-ranged :class:`CorruptBinCacheError`
    before anything is replaced.  A legacy trailerless cache is UPGRADED
    to a full CRC table by any rewrite (never a mixed
    verified/unverified file); the append-origin log
    (``bins_append_rows``) records where each append began so later
    corruption errors can name the appended chunk.  Returns the new
    total row count.

    Labels must ride along when the cache carries them (training data and
    targets may never go out of step); ranking caches (non-empty
    ``group``) and init_score/position-carrying caches refuse appends."""
    stream = BinCacheStream(path)
    n_old = stream.shape[0]
    bins_new, label, weight, old_label, old_weight = _validate_append(
        path, stream, bins_new, label, weight)
    n_new = int(bins_new.shape[0])
    from ..obs import metrics as _obs

    if segment_threshold and int(segment_threshold) >= 1:
        k = max([s[0] for s in stream.segments] + [stream.seg_watermark]) + 1
        _write_segment(path, k, bins_new, stream.dtype,
                       stream.crc_rows or DEFAULT_CRC_ROWS,
                       label, weight, chunk_rows)
        _obs.counter("bin_cache_appends_total").inc()
        _obs.counter("bin_cache_appended_rows_total").inc(n_new)
        _obs.counter("bin_cache_segment_appends_total").inc()
        _obs.event("bin_cache_segment_append", path=os.fspath(path),
                   segment=k, rows=n_new, total_rows=n_old + n_new,
                   live_segments=len(stream.segments) + 1)
        if len(stream.segments) + 1 >= int(segment_threshold):
            compact_bin_cache(path, chunk_rows=chunk_rows)
        return n_old + n_new

    upgraded = stream.crcs is None
    new_label = (np.concatenate([old_label, label])
                 if old_label.size else np.zeros(0))
    new_weight = (np.concatenate([old_weight, weight])
                  if old_weight.size else np.zeros(0))
    append_log = np.concatenate([
        (np.asarray(stream.append_log, np.int64)
         if stream.append_log is not None else np.zeros(0, np.int64)),
        np.asarray([n_old], np.int64)])
    folded = [s[0] for s in stream.segments]
    watermark = max(folded + [stream.seg_watermark])
    _rewrite_cache(path, stream, bins_new, new_label, new_weight,
                   append_log, watermark, chunk_rows)
    _reap_segments(path, stream.segments)
    _obs.counter("bin_cache_appends_total").inc()
    _obs.counter("bin_cache_appended_rows_total").inc(n_new)
    if upgraded:
        _obs.counter("bin_cache_crc_upgrades_total").inc()
        from ..utils.log import log_warning

        log_warning(
            f"bin cache {path} carried no CRC trailer table (pre-round-13 "
            "format); the append upgraded it — every block of the new "
            "file, old rows included, is now verifiable")
    _obs.event("bin_cache_append", path=os.fspath(path), rows=n_new,
               total_rows=n_old + n_new, upgraded=upgraded)
    return n_old + n_new


def _write_segment(path: str, k: int, bins_new: np.ndarray, dtype,
                   crc_rows: int, label, weight, chunk_rows: int) -> None:
    """One CRC'd sidecar segment, atomically published next to the base
    cache (its own temp + fsync + replace — a crash strands at most a
    temp file the segment scan already skips)."""
    n, f = bins_new.shape
    crc = _CrcTableBuilder(crc_rows, f * np.dtype(dtype).itemsize)

    def _write(fh):
        with zipfile.ZipFile(fh, "w", zipfile.ZIP_STORED) as zf:
            _write_streamed_bins(zf, "bins.npy", n, f, dtype,
                                 array_chunks(bins_new, chunk_rows), crc)
            zf.writestr("bins_crc32.npy", _npy_member_bytes(crc.finish()))
            zf.writestr("bins_crc_rows.npy",
                        _npy_member_bytes(np.asarray(crc_rows, np.int64)))
            zf.writestr("label.npy", _npy_member_bytes(
                label if label is not None else np.zeros(0)))
            zf.writestr("weight.npy", _npy_member_bytes(
                weight if weight is not None else np.zeros(0)))

    _atomic_replace(_seg_path(path, k), _write,
                    os.stat(path).st_mode & 0o7777)


def _reap_segments(path: str, segments) -> None:
    """Best-effort deletion of folded sidecars AFTER the rewrite
    published — a crash in between strands files the watermark already
    excludes from every future read."""
    for _k, sp, _n in segments:
        try:
            os.unlink(sp)
        except OSError:
            pass


def compact_bin_cache(path: str,
                      chunk_rows: int = DEFAULT_CHUNK_ROWS) -> int:
    """Fold every live segment of ``path`` back into its base npz: one
    verified streamed rewrite through the atomic-replace scaffold, then
    the folded sidecars are deleted.  The new base's watermark covers
    every folded index, so the crash window between the replace and the
    deletes is safe — a stranded sidecar is ignored, never
    double-counted.  Returns the total row count (unchanged by
    compaction).  No-op (no rewrite) when no live segments exist."""
    stream = BinCacheStream(path)
    if not stream.segments:
        return stream.shape[0]
    new_label, new_weight, _g, _i, _p = _cache_row_meta(path, stream)
    append_log = (np.asarray(stream.append_log, np.int64)
                  if stream.append_log is not None
                  else np.zeros(0, np.int64))
    watermark = max([s[0] for s in stream.segments]
                    + [stream.seg_watermark])
    _rewrite_cache(path, stream, None, new_label, new_weight,
                   append_log, watermark, chunk_rows)
    _reap_segments(path, stream.segments)
    from ..obs import metrics as _obs

    _obs.counter("bin_cache_compactions_total").inc()
    _obs.event("bin_cache_compact", path=os.fspath(path),
               folded_segments=len(stream.segments),
               total_rows=stream.shape[0], watermark=watermark)
    return stream.shape[0]


def load_segmented_cache(path: str, chunk_rows: int = DEFAULT_CHUNK_ROWS):
    """``(bins, label, weight)`` fully materialized across base + live
    segments — the materialized Dataset loader's segment-aware path —
    or None when the cache has no live segments (the caller's plain
    ``np.load`` view is already complete)."""
    stream = BinCacheStream(path)
    if not stream.segments:
        return None
    out = np.empty((stream.shape[0], stream.shape[1]), stream.dtype)
    for lo, view in stream.chunks(chunk_rows):
        out[lo:lo + view.shape[0]] = view
    label, weight, _g, _i, _p = _cache_row_meta(path, stream)
    return out, label, weight


def array_chunks(arr: np.ndarray,
                 chunk_rows: int) -> Iterator[Tuple[int, np.ndarray]]:
    """The BinCacheStream protocol over an in-memory matrix: row-chunk
    views, zero copies (numpy slices of a C-order array are views)."""
    n = arr.shape[0]
    chunk_rows = max(int(chunk_rows), 1)
    for lo in range(0, n, chunk_rows):
        yield lo, arr[lo:lo + chunk_rows]




def is_bin_cache(path: str) -> bool:
    """Whether ``path`` is a zip file (a save_binary cache) rather than
    text."""
    with open(path, "rb") as fh:
        return fh.read(4) == b"PK\x03\x04"


def read_cache_meta(path: str) -> Dict[str, Any]:
    """Everything of a cache but its matrix: {mappers (the BinMapper fields
    of each feature), label, weight, group, init_score, position (across
    the live segments too; empty as None), feature_names, shape (rows of
    the base and live segments, columns), stream (its BinCacheStream)}."""
    stream = BinCacheStream(path)
    label, weight, group, init, pos = _cache_row_meta(path, stream)
    with np.load(path, allow_pickle=False) as z:
        sizes = z["upper_sizes"]
        uppers, mt = z["uppers"], z["missing_types"]
        cat_sizes = (z["cat_sizes"] if "cat_sizes" in z.files
                     else np.zeros(len(sizes), np.int64))
        cats = z["cats"] if "cats" in z.files else np.zeros(0)
        minv = z["min_values"] if "min_values" in z.files else np.zeros(len(sizes))
        maxv = z["max_values"] if "max_values" in z.files else np.zeros(len(sizes))
        names = [str(x) for x in z["feature_names"]]
    mappers, off, coff = [], 0, 0
    for i, sz in enumerate(sizes):
        sz, cs = int(sz), int(cat_sizes[i])
        mappers.append(dict(upper_bounds=uppers[off:off + sz], missing_type=int(mt[i]),
                            is_categorical=cs > 0,
                            categories=cats[coff:coff + cs] if cs else None,
                            min_value=float(minv[i]), max_value=float(maxv[i])))
        off += sz
        coff += cs

    def some(v):
        v = np.asarray(v)
        return v if v.size else None

    return dict(mappers=mappers, label=some(label), weight=some(weight),
                group=some(group), init_score=some(init), position=some(pos),
                feature_names=names, shape=tuple(stream.shape), stream=stream)


def read_bin_cache(path: str, chunk_rows: int = DEFAULT_CHUNK_ROWS) -> Dict[str, Any]:
    """Load a cache whole: read_cache_meta's fields and ``bins``, the base
    matrix and every live segment after it.  The matrix is read through
    the stream, so every block is checked against its CRC32 table
    (CorruptBinCacheError names the failing block)."""
    out = read_cache_meta(path)
    stream = out.pop("stream")
    bins = np.empty(stream.shape, stream.dtype)
    for lo, view in stream.chunks(chunk_rows):
        bins[lo:lo + view.shape[0]] = view
    out["bins"] = bins
    return out


class _Staging:
    """prefetch_device's two reused host buffers (pinned for the card),
    the event behind each one's last upload and the copy stream the
    uploads run on."""

    def __init__(self):
        self.bufs: list = []
        self.events: list = []
        self.stream = None  # the uploads' own stream, made at the first one
        self.waits = 0  # uploads waited for before a buffer was written again


def prefetch_device(chunks: Iterator[Tuple[int, np.ndarray]], device,
                    dtype=torch.int16, staging: Optional[_Staging] = None
                    ) -> Iterator[Tuple[int, int, torch.Tensor]]:
    """One-deep upload pipeline: chunk k + 1 is staged and its upload
    enqueued before chunk k is yielded, so the copy engine works while the
    consumer launches on chunk k.  Yields (row_lo, rows, device chunk).

    The host chunks alias a reused read buffer (BinCacheStream), so each
    is first copied into one of two reused staging buffers (pinned when
    ``device`` is the card, so the upload is asynchronous); a staging
    buffer is written again only after the event recorded behind its last
    upload has completed.  On the card the uploads run on a stream of
    their own: an upload waits for the work the consumer had enqueued
    before it (its device buffer may reuse their memory), and the consumer
    waits on the upload's event, on the device, before a chunk is yielded.
    ``staging`` keeps the buffers and the stream across sweeps (the spill
    grower sweeps once a split)."""
    device = torch.device(device)
    st = staging if staging is not None else _Staging()
    cuda = device.type == "cuda"
    if cuda and st.stream is None:
        st.stream = torch.cuda.Stream(device)
    prev = None
    k = 0
    for lo, view in chunks:
        m = view.shape[0]
        slot = k % 2
        k += 1
        if len(st.bufs) <= slot or st.bufs[slot].shape[0] < m or (
                st.bufs[slot].shape[1:] != view.shape[1:]):
            buf = torch.empty(view.shape, dtype=dtype, pin_memory=cuda)
            if len(st.bufs) <= slot:
                st.bufs.append(buf)
                st.events.append(None)
            else:
                st.bufs[slot] = buf
        buf, ev = st.bufs[slot], st.events[slot]
        if ev is not None and not ev.query():
            st.waits += 1
            ev.synchronize()  # its last upload still reads it
        host = buf[:m]
        host.numpy()[...] = view
        if cuda:
            cur = torch.cuda.current_stream(device)
            dev = torch.empty(host.shape, dtype=dtype, device=device)
            st.stream.wait_stream(cur)
            with torch.cuda.stream(st.stream):
                dev.copy_(host, non_blocking=True)
            dev.record_stream(st.stream)
            ev = torch.cuda.Event()
            ev.record(st.stream)
            st.events[slot] = ev
        else:
            dev = host.clone()
        if prev is not None:
            yield _ready(prev, cuda, device)
        prev = (lo, m, dev, st.events[slot] if cuda else None)
    if prev is not None:
        yield _ready(prev, cuda, device)


def _ready(item, cuda: bool, device) -> Tuple[int, int, torch.Tensor]:
    """A staged chunk for the consumer: on the card, its stream waits (on
    the device) for the chunk's upload first."""
    lo, m, dev, ev = item
    if cuda:
        torch.cuda.current_stream(device).wait_event(ev)
    return lo, m, dev
