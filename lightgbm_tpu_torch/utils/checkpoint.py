"""Durable checkpoints: atomic model writes + integrity trailers + torn-
snapshot fallback (docs/ROBUSTNESS.md).

The reference's entire fault model is ``snapshot_freq``: GBDT::Train
writes ``<output_model>.snapshot_iter_<n>`` every freq iterations and a
restart loads it via ``input_model``.  A crash MID-WRITE, however, leaves
a torn file that a restart happily parses into a half-model — the exact
silent-corruption class a recovery story must exclude.  Three properties
fix it:

* **Atomicity** — every model file is written to a same-directory temp
  file, fsync'd, and ``os.replace``d into place.  A crash at any point
  leaves either the old file or the new file, never a hybrid; stray
  ``*.tmp.*`` files are garbage, not checkpoints.
* **Integrity trailer** — snapshots carry a final comment line
  ``# lgbm-tpu-checkpoint v1 sha256=<hex> bytes=<n>`` over the payload.
  The model-text parser never sees it (loads strip it), and a resume can
  distinguish "valid snapshot" from "torn/bit-rotted file" instead of
  trusting mtime.
* **Fallback scan** — :func:`latest_valid_snapshot` walks the snapshot
  family of an output model, newest first, and returns the first one
  whose trailer verifies; engine.train resumes from it when the
  requested snapshot fails verification.

Kept import-light (stdlib + utils only): basic.py and engine.py both use
it, and the launcher's thin worker processes must not pay a jax import
to write a model atomically.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import tempfile
import time
from typing import Dict, List, Optional, Tuple

from . import faults

TRAILER_VERSION = "v1"
_TRAILER_RE = re.compile(
    r"^# lgbm-tpu-checkpoint (?P<ver>v\d+) sha256=(?P<digest>[0-9a-f]{64}) "
    r"bytes=(?P<nbytes>\d+)\s*$")
_SNAPSHOT_RE = re.compile(r"^(?P<prefix>.*)\.snapshot_iter_(?P<it>\d+)$")


def _digest(payload: str) -> str:
    return hashlib.sha256(payload.encode("utf-8")).hexdigest()


def add_trailer(payload: str) -> str:
    """Append the integrity trailer line to a model text."""
    if not payload.endswith("\n"):
        payload += "\n"
    return (f"{payload}# lgbm-tpu-checkpoint {TRAILER_VERSION} "
            f"sha256={_digest(payload)} bytes={len(payload.encode('utf-8'))}\n")


def verify_text(text: str) -> Tuple[str, Optional[bool]]:
    """Split a model text into (payload, verdict).

    verdict is True (trailer present and verifies), False (trailer
    present but digest/length mismatch — a torn or corrupted file), or
    None (no trailer: a plain model file, nothing to verify)."""
    lines = text.splitlines(keepends=True)
    for i in range(len(lines) - 1, -1, -1):
        if lines[i].strip():
            m = _TRAILER_RE.match(lines[i].strip())
            if m is None:
                return text, None
            payload = "".join(lines[:i])
            ok = (m.group("ver") == TRAILER_VERSION
                  and len(payload.encode("utf-8")) == int(m.group("nbytes"))
                  and _digest(payload) == m.group("digest"))
            return payload, ok
    return text, None


def atomic_write_text(path: str, text: str,
                      fault_round: Optional[int] = None) -> None:
    """Write ``text`` to ``path`` atomically (same-dir temp + fsync +
    ``os.replace``).  ``fault_round`` arms the ``snapshot_write``
    injection site mid-write (utils/faults.py): the crash lands after a
    partial payload is flushed to the TEMP file, proving no torn file can
    reach the final path."""
    path = os.fspath(path)
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".tmp.", dir=d)
    try:
        # mkstemp creates 0600; restore umask-based permissions so the
        # final file is readable exactly as a plain open()-write would be
        # (shared model dirs, serving processes under another uid)
        umask = os.umask(0)
        os.umask(umask)
        os.fchmod(fd, 0o666 & ~umask)
        # utf-8 everywhere: the trailer digest and the verify readers
        # hash/decode utf-8 — the write must not follow the locale
        with os.fdopen(fd, "w", encoding="utf-8") as fh:
            if fault_round is not None and faults.armed("snapshot_write"):
                # injection scaffolding only when armed: the extra
                # flush+fsync of the split write must not tax every
                # production snapshot
                half = text[: len(text) // 2]
                fh.write(half)
                fh.flush()
                os.fsync(fh.fileno())
                faults.maybe_crash("snapshot_write", fault_round)
                fh.write(text[len(half):])
            else:
                fh.write(text)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    # telemetry AFTER the replace: only durable writes count (lazy import —
    # thin launcher workers write models without extra import cost)
    from ..obs import metrics as _obs

    _obs.counter("checkpoint_writes_total").inc()


def save_snapshot(path: str, model_text: str, iteration: int) -> None:
    """Atomic, trailer-stamped snapshot write (engine.py snapshot_freq)."""
    atomic_write_text(path, add_trailer(model_text), fault_round=iteration)
    from ..obs import metrics as _obs

    _obs.counter("checkpoint_snapshots_total").inc()
    _obs.event("checkpoint_snapshot", path=os.fspath(path),
               iteration=iteration)


def verify_file(path: str) -> Optional[bool]:
    """Trailer verdict for a file on disk (see :func:`verify_text`).
    Unreadable files count as torn (False), and so does a SNAPSHOT-named
    file with no trailer at all — snapshots are always written with one,
    so truncation that ate the trailer line must not read as 'legacy
    file, nothing to verify'."""
    try:
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
    except (OSError, UnicodeDecodeError):
        ok = False
    else:
        ok = verify_text(text)[1]
        if ok is None and is_snapshot_path(path):
            ok = False
    if ok is False:
        from ..obs import metrics as _obs

        _obs.counter("checkpoint_torn_total").inc()
        _obs.event("checkpoint_torn", path=os.fspath(path))
    return ok


def snapshot_iteration(path: str) -> Optional[int]:
    """The <k> of a ``*.snapshot_iter_<k>`` path, None for other paths."""
    m = _SNAPSHOT_RE.match(os.fspath(path))
    return int(m.group("it")) if m else None


def is_snapshot_path(path: str) -> bool:
    """True for ``*.snapshot_iter_<k>`` paths.  Snapshots are ALWAYS
    written with a trailer, so a snapshot-named file without a valid one
    is torn by definition — truncation that chops the trailer off must
    not demote a snapshot to an unverifiable 'legacy' file."""
    return _SNAPSHOT_RE.match(os.fspath(path)) is not None


def read_and_verify(path: str) -> Tuple[str, Optional[bool]]:
    """(payload, raw trailer verdict) for a file on disk — unlike
    :func:`verify_file` this reports the TEXT verdict (None = no trailer)
    so callers can distinguish a pre-trailer-era file from a torn one.
    An undecodable file reports ("", False): corrupted, not a crash."""
    try:
        with open(path, encoding="utf-8") as fh:
            return verify_text(fh.read())
    except UnicodeDecodeError:
        return "", False


def snapshot_family(path: str) -> List[Tuple[int, str]]:
    """All ``<prefix>.snapshot_iter_<k>`` siblings of ``path`` (itself a
    snapshot path or the bare output-model prefix), sorted newest first."""
    m = _SNAPSHOT_RE.match(os.fspath(path))
    prefix = m.group("prefix") if m else os.fspath(path)
    base_dir = os.path.dirname(os.path.abspath(prefix)) or "."
    base_name = os.path.basename(prefix)
    out = []
    try:
        entries = os.listdir(base_dir)
    except OSError:
        return []
    for name in entries:
        sm = _SNAPSHOT_RE.match(name)
        if sm is not None and sm.group("prefix") == base_name:
            out.append((int(sm.group("it")), os.path.join(base_dir, name)))
    out.sort(reverse=True)
    return out


def latest_valid_snapshot(path: str,
                          below_iter: Optional[int] = None
                          ) -> Optional[Tuple[int, str]]:
    """Newest snapshot in ``path``'s family whose trailer VERIFIES
    (trailerless files are skipped — they cannot be vouched for).
    ``below_iter`` restricts the scan to strictly older snapshots (the
    fallback case: the iter-k snapshot is torn, look before k)."""
    for it, snap in snapshot_family(path):
        if below_iter is not None and it >= below_iter:
            continue
        if verify_file(snap) is True:
            return it, snap
    return None


# ---------------------------------------------------------------------------
# retention: bounded snapshot families (snapshot_keep=)
# ---------------------------------------------------------------------------

def prune_snapshots(path: str, keep: int) -> List[Tuple[int, str]]:
    """Delete the oldest snapshots in ``path``'s family beyond the newest
    ``keep`` of them — but NEVER the newest snapshot that actually
    verifies, whatever its age: retention must not be able to throw away
    the only state a resume could use (a family whose newest ``keep``
    entries are all torn keeps its last good snapshot).  ``keep <= 0``
    means keep-all (the default behavior).  Returns the pruned
    ``(iteration, path)`` pairs; each deletion is evented through obs."""
    if keep <= 0:
        return []
    family = snapshot_family(path)  # newest first
    newest_valid: Optional[str] = None
    for _, snap in family:
        if verify_file(snap) is True:
            newest_valid = snap
            break
    pruned: List[Tuple[int, str]] = []
    for it, snap in family[keep:]:
        if snap == newest_valid:
            continue
        try:
            os.unlink(snap)
        except OSError:
            continue  # already gone / unremovable: not worth failing a run
        pruned.append((it, snap))
    if pruned:
        from ..obs import metrics as _obs

        _obs.counter("checkpoint_pruned_total").inc(len(pruned))
        _obs.event("checkpoint_prune", path=os.fspath(path),
                   kept=keep, pruned=[p for _, p in pruned])
    return pruned


# ---------------------------------------------------------------------------
# fleet-consistent checkpoints (docs/ROBUSTNESS.md "Elastic fleet recovery")
#
# A fleet checkpoint for round k is three things, all in the launch dir:
#   fleet.snapshot_iter_<k>            rank 0's model snapshot (sha256
#                                      trailer via save_snapshot, raw-delta
#                                      form so resume is bitwise)
#   fleet.manifest_iter_<k>.json       the manifest (schema below), written
#                                      ATOMICALLY and only AFTER the
#                                      snapshot is durable
#   fleet.manifest_iter_<k>.ack.rank<r>  one marker per non-zero rank,
#                                      carrying that rank's own ensemble
#                                      sha256 at round k
#
# A round is *fleet-valid* — and only then resumable — when the manifest
# parses, the snapshot's trailer verifies, the snapshot payload hashes to
# the manifest's ensemble_sha256, and every rank 1..W-1 has acked with a
# MATCHING ensemble sha.  A crash anywhere in the protocol (including the
# armed ``manifest_write`` injection window between snapshot and manifest)
# leaves the previous fleet-valid round authoritative.
# ---------------------------------------------------------------------------

FLEET_SCHEMA = "lgbmtpu-fleet-ckpt-v1"
_FLEET_MANIFEST_RE = re.compile(r"^fleet\.manifest_iter_(?P<it>\d+)\.json$")


def fleet_snapshot_path(d: str, round_i: int) -> str:
    return os.path.join(d, f"fleet.snapshot_iter_{round_i}")


def fleet_manifest_path(d: str, round_i: int) -> str:
    return os.path.join(d, f"fleet.manifest_iter_{round_i}.json")


def fleet_ack_path(d: str, round_i: int, rank: int) -> str:
    return os.path.join(d, f"fleet.manifest_iter_{round_i}.ack.rank{rank}")


def ensemble_digest(model_text: str) -> str:
    """sha256 over the model text normalized exactly as the snapshot
    trailer hashes it (trailing newline ensured) — so the manifest's
    ensemble_sha256 equals the snapshot trailer's digest and cross-checks
    are byte-for-byte."""
    if not model_text.endswith("\n"):
        model_text += "\n"
    return _digest(model_text)


def write_fleet_checkpoint(d: str, model_text: str, round_i: int,
                           world_size: int,
                           shard_fingerprints: Optional[Dict[str, str]] = None,
                           keep: int = 0,
                           slices: Optional[Dict[str, int]] = None) -> str:
    """Rank 0's half of the protocol: durable snapshot FIRST, manifest
    publish SECOND (the ordering is the whole point — a manifest may never
    refer to a snapshot that might not exist).  ``shard_fingerprints``
    maps rank -> data-shard sha256 so a resumed rank can refuse to
    continue on changed data.  ``keep`` > 0 prunes old fleet rounds after
    a successful publish (never the newest valid one).  ``slices`` maps
    rank -> slice id for multi-slice fleets (docs/ROBUSTNESS.md
    "Slice-granular recovery"): it lets :func:`
    latest_slice_valid_fleet_manifest` answer which rounds a REPLACEMENT
    slice can rejoin at without the lost slice's own acks.  Returns the
    manifest path."""
    snap = fleet_snapshot_path(d, round_i)
    save_snapshot(snap, model_text, round_i)
    # torn-fleet-state injection window (utils/faults.py manifest_write):
    # the snapshot is durable but the manifest making it fleet-valid is
    # not yet — a crash here must leave the PREVIOUS round authoritative
    faults.maybe_crash("manifest_write", round_i)
    manifest = {
        "schema": FLEET_SCHEMA,
        "round": int(round_i),
        "snapshot": os.path.basename(snap),
        "ensemble_sha256": ensemble_digest(model_text),
        "world_size": int(world_size),
        "shards": {str(r): str(fp)
                   for r, fp in (shard_fingerprints or {}).items()},
        "ts": time.time(),
    }
    if slices:
        manifest["slices"] = {str(r): int(s) for r, s in slices.items()}
        manifest["num_slices"] = len(set(manifest["slices"].values()))
    atomic_write_text(fleet_manifest_path(d, round_i),
                      json.dumps(manifest, indent=1) + "\n")
    from ..obs import metrics as _obs

    _obs.counter("fleet_checkpoints_total").inc()
    _obs.event("fleet_checkpoint", round=int(round_i),
               manifest=fleet_manifest_path(d, round_i),
               world_size=int(world_size))
    if keep > 0:
        prune_fleet_checkpoints(d, keep)
    return fleet_manifest_path(d, round_i)


def confirm_fleet_checkpoint(d: str, round_i: int, rank: int,
                             model_text: Optional[str] = None) -> str:
    """A non-zero rank's half: drop the ack marker for round ``round_i``.
    With ``model_text`` the ack carries this rank's own ensemble sha256,
    so fleet validity additionally proves cross-rank state CONSISTENCY
    (an empty ack only proves liveness through the round).  Markers are
    written atomically — a torn ack must read as absent, not garbage."""
    ack = fleet_ack_path(d, round_i, rank)
    sha = ensemble_digest(model_text) if model_text is not None else ""
    atomic_write_text(ack, sha + "\n")
    return ack


def fleet_manifest_valid(manifest_path: str,
                         world_size: Optional[int] = None,
                         exclude_ranks: Tuple[int, ...] = ()
                         ) -> Optional[Dict]:
    """The fleet-validity check.  Returns the manifest dict (with
    ``snapshot`` resolved to an absolute path) when EVERY leg holds:

    * the manifest parses and carries the ``lgbmtpu-fleet-ckpt-v1`` schema
      (with a sane round and world_size);
    * ``world_size``, when given, matches the manifest's (a resume must
      not mix fleet sizes — shard fingerprints are per-rank);
    * the snapshot exists and its sha256 trailer verifies;
    * the snapshot payload hashes to the manifest's ``ensemble_sha256``;
    * every rank 1..W-1 has an ack, and every sha-carrying ack matches.

    ``exclude_ranks`` drops the ack requirement for the named ranks —
    the slice-granular recovery form (docs/ROBUSTNESS.md): a LOST
    slice's members cannot ack any more, and the round the replacement
    slice rejoins at needs only the SURVIVING ranks' confirmation.  An
    excluded rank's ack, when present, must still MATCH (a diverged ack
    proves inconsistent state whoever wrote it).

    Anything else returns None — an unconfirmed or torn round is never
    resumed into."""
    d = os.path.dirname(os.path.abspath(manifest_path))
    try:
        with open(manifest_path, encoding="utf-8") as fh:
            manifest = json.load(fh)
    except (OSError, ValueError):
        return None
    if not isinstance(manifest, dict) or manifest.get("schema") != FLEET_SCHEMA:
        return None
    try:
        round_i = int(manifest["round"])
        w = int(manifest["world_size"])
        snap_name = str(manifest["snapshot"])
        want_sha = str(manifest["ensemble_sha256"])
    except (KeyError, TypeError, ValueError):
        return None
    if round_i < 1 or w < 1:
        return None
    if world_size is not None and w != int(world_size):
        return None
    snap = os.path.join(d, snap_name)
    payload, ok = read_and_verify(snap)
    if ok is not True or _digest(payload) != want_sha:
        return None
    excluded = {int(r) for r in exclude_ranks}
    for r in range(1, w):
        try:
            with open(fleet_ack_path(d, round_i, r),
                      encoding="utf-8") as fh:
                ack_sha = fh.read().strip()
        except OSError:
            if r in excluded:
                continue  # a lost slice's member cannot ack any more
            return None  # unconfirmed rank: not fleet-valid
        if ack_sha and ack_sha != want_sha:
            return None  # rank diverged from rank 0's ensemble
    manifest = dict(manifest)
    manifest["snapshot"] = snap
    return manifest


def latest_valid_fleet_manifest(d: str,
                                world_size: Optional[int] = None
                                ) -> Optional[Tuple[int, str, Dict]]:
    """Newest fleet-VALID round in directory ``d``: scans
    ``fleet.manifest_iter_<k>.json`` newest-first and returns
    ``(round, manifest_path, manifest)`` for the first one that passes
    :func:`fleet_manifest_valid`, else None."""
    try:
        entries = os.listdir(d)
    except OSError:
        return None
    rounds = []
    for name in entries:
        m = _FLEET_MANIFEST_RE.match(name)
        if m is not None:
            rounds.append(int(m.group("it")))
    for round_i in sorted(rounds, reverse=True):
        path = fleet_manifest_path(d, round_i)
        manifest = fleet_manifest_valid(path, world_size)
        if manifest is not None:
            return round_i, path, manifest
    return None


def latest_slice_valid_fleet_manifest(
        d: str, world_size: Optional[int], lost_ranks: Tuple[int, ...]
) -> Optional[Tuple[int, str, Dict]]:
    """Newest SLICE-valid round in directory ``d`` for a replacement of
    the ranks in ``lost_ranks`` (docs/ROBUSTNESS.md "Slice-granular
    recovery"): the manifest must parse, its snapshot verify, and every
    SURVIVING rank's ack be present and matching — the lost slice's own
    acks are not required (its members died, possibly before acking the
    newest round the survivors confirmed).  Returns
    ``(round, manifest_path, manifest)`` or None."""
    try:
        entries = os.listdir(d)
    except OSError:
        return None
    rounds = []
    for name in entries:
        m = _FLEET_MANIFEST_RE.match(name)
        if m is not None:
            rounds.append(int(m.group("it")))
    lost = tuple(int(r) for r in lost_ranks)
    for round_i in sorted(rounds, reverse=True):
        path = fleet_manifest_path(d, round_i)
        manifest = fleet_manifest_valid(path, world_size,
                                        exclude_ranks=lost)
        if manifest is not None:
            return round_i, path, manifest
    return None


def prune_fleet_checkpoints(d: str, keep: int) -> List[int]:
    """Fleet-side retention: drop whole rounds (snapshot + manifest +
    acks) beyond the newest ``keep``, never the newest fleet-VALID round.
    Returns the pruned round numbers."""
    if keep <= 0:
        return []
    try:
        entries = os.listdir(d)
    except OSError:
        return []
    rounds = set()
    for name in entries:
        m = _FLEET_MANIFEST_RE.match(name)
        if m is not None:
            rounds.add(int(m.group("it")))
        sm = _SNAPSHOT_RE.match(name)
        if sm is not None and sm.group("prefix") == "fleet":
            rounds.add(int(sm.group("it")))
    ordered = sorted(rounds, reverse=True)
    newest_valid = latest_valid_fleet_manifest(d)
    keep_round = newest_valid[0] if newest_valid else None
    pruned: List[int] = []
    for round_i in ordered[keep:]:
        if round_i == keep_round:
            continue
        victims = [fleet_snapshot_path(d, round_i),
                   fleet_manifest_path(d, round_i)]
        victims += [os.path.join(d, n) for n in entries
                    if n.startswith(f"fleet.manifest_iter_{round_i}.ack.")]
        for path in victims:
            try:
                os.unlink(path)
            except OSError:
                pass
        pruned.append(round_i)
    if pruned:
        from ..obs import metrics as _obs

        _obs.counter("fleet_checkpoints_pruned_total").inc(len(pruned))
        _obs.event("fleet_checkpoint_prune", kept=keep, pruned=pruned)
    return pruned
