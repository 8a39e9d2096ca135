"""Comms ledger: what this rank's collectives move, as it issues them.

The counterpart of ``tony_tpu/obs/comms.py``. The reference parses each
compiled step's optimized HLO for its collectives (``extract_collectives``);
eager PyTorch has no compiled program, so ``parallel/dist.py`` records each
collective here as it issues it, at the one place its payload is summed
into ``dist.BYTES``: the op, its kind (the reference's kind names), its
payload bytes and its group (the mesh axis's name, size and ranks). The
ledger's totals by kind therefore equal ``BYTES`` (:func:`totals`).

Rows are keyed by op name, ``<kind>.<axis>`` (``all-gather.fsdp``), and
the fsdp ring's hops by their ``ops/overlap.py`` ring
(``collective-permute.fsdp.ring_contract``); each row counts its calls
and bytes, and ``runs_as`` where the transport runs another kind (gloo's
reduce-scatter is an all-reduce). The profile controller snapshots the
rows recorded during a capture window beside its manifest
(:func:`write_window`), in the shape ``obs/anatomy.py``
``ledger_collectives`` reads (a compile-ledger snapshot's ``entries``),
so the anatomy report pairs each kind's bytes with the window's
measured time.

Stdlib-only: the read paths run in deviceless processes.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any

# BYTES's transfer names (parallel/dist.py) -> the reference's kind names
KINDS = {
    "hop": "collective-permute",
    "all_gather": "all-gather",
    "reduce_scatter": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_to_all": "all-to-all",
    "broadcast": "collective-broadcast",
}
LEDGER_FILE = "comms.json"

_lock = threading.Lock()
_rows: dict[str, dict[str, Any]] = {}


def record(transfer: str, nbytes: int, axis_name: str, size: int,
           ranks: tuple[int, ...] = (), op: str = "", runs_as: str = "") -> None:
    """One collective of ``transfer`` (a ``dist.BYTES`` name) moving
    ``nbytes`` of this rank's payload over the named axis; ``op`` names
    the call site within it (a ring), ``runs_as`` the transfer the
    transport runs instead (gloo's reduce-scatter is an all-reduce)."""
    kind = KINDS[transfer]
    name = f"{kind}.{axis_name}" + (f".{op}" if op else "")
    with _lock:
        row = _rows.get(name)
        if row is None:
            row = _rows[name] = {"name": name, "kind": kind, "transfer": transfer,
                                 "axis": axis_name, "size": int(size),
                                 "replica_groups": [list(ranks)], "calls": 0,
                                 "total_bytes": 0}
            if runs_as:
                row["runs_as"] = KINDS[runs_as]
        row["calls"] += 1
        row["total_bytes"] += int(nbytes)


def reset() -> None:
    with _lock:
        _rows.clear()


def rows() -> list[dict[str, Any]]:
    """The ledger's rows, each with ``bytes`` = its mean payload a call
    (the reference's per-op payload), largest first."""
    with _lock:
        out = [dict(r, bytes=r["total_bytes"] // max(r["calls"], 1)) for r in _rows.values()]
    return sorted(out, key=lambda r: (-r["total_bytes"], r["name"]))


def totals() -> dict[str, int]:
    """Payload bytes by ``dist.BYTES`` name (every name, 0 where unused)."""
    out = {t: 0 for t in KINDS}
    for r in rows():
        out[r["transfer"]] += r["total_bytes"]
    return out


def write_window(out_dir: str, start: dict[str, dict[str, Any]]) -> str:
    """Snapshot the rows recorded since ``start`` (a :func:`mark`) as
    ``comms.json`` in ``out_dir``; returns the path ('' on failure)."""
    window = []
    for r in rows():
        before = start.get(r["name"], {})
        calls = r["calls"] - before.get("calls", 0)
        if calls:
            total = r["total_bytes"] - before.get("total_bytes", 0)
            window.append(dict(r, calls=calls, total_bytes=total, bytes=total // calls))
    path = os.path.join(out_dir, LEDGER_FILE)
    try:
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"entries": [{"fn": "train.step", "collectives": window}]}, f)
        os.replace(tmp, path)
    except OSError:
        return ""
    return path


def mark() -> dict[str, dict[str, Any]]:
    """The rows' counts now, for :func:`write_window`."""
    with _lock:
        return {n: {"calls": r["calls"], "total_bytes": r["total_bytes"]}
                for n, r in _rows.items()}


def read_window(out_dir: str) -> dict[str, Any] | None:
    """A capture's ``comms.json`` payload, or None."""
    try:
        with open(os.path.join(out_dir, LEDGER_FILE), encoding="utf-8") as f:
            d = json.load(f)
    except (OSError, ValueError):
        return None
    return d if isinstance(d, dict) else None


__all__ = ["KINDS", "LEDGER_FILE", "mark", "read_window", "record", "reset", "rows", "totals",
           "write_window"]
