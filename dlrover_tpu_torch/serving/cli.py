"""The serving CLI's forensic view (port of ``dlrover_tpu/serving/cli.py``).

``requests --events PATH [--json]`` renders the request ledger from an
event timeline (the JSONL file ``DLROVER_TPU_EVENTS_FILE`` names):
submitted, completed, evicted and expired requests, serve runs, live
resizes, the prefix pool's columns and the speculative-decode totals::

    python -m dlrover_tpu_torch.serving.cli requests --events events.jsonl

The live views (``serve --addr``, ``requests --addr``) need the master
client, and ``serve slo`` the control plane's slot-ledger derivation:
both raise until they are ported (ROADMAP A12).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

from dlrover_tpu_torch.telemetry.events import read_events
from dlrover_tpu_torch.telemetry.names import EventKind


def _waits(what: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP A12)")


def _forensic_report(events_path: str) -> Dict:
    records = read_events(events_path)

    def count(kind):
        return sum(1 for r in records if r.get("kind") == kind)

    return {
        # the router's accepted completions (a worker's DONE events
        # double on a re-leased twin; the router dedups)
        "requests": {
            "submitted": count(EventKind.SERVE_REQUEST_SUBMITTED),
            "completed": count(EventKind.SERVE_REQUEST_COMPLETED),
            "evicted": count(EventKind.SERVE_REQUEST_EVICTED),
            "leases_expired": count(EventKind.SERVE_LEASE_EXPIRED),
        },
        "runs": count(EventKind.SERVE_START),
        "completed_runs": [
            {"decode_steps": r.get("decode_steps"),
             "completed": r.get("completed")}
            for r in records if r.get("kind") == EventKind.SERVE_END
        ],
        "resizes": [
            {"world_from": r.get("world_from"),
             "world_to": r.get("world_to"),
             "seconds": r.get("reshard_seconds"),
             "recompiled": r.get("recompiled")}
            for r in records if r.get("kind") == EventKind.SERVE_RESIZE_DONE
        ],
        "evicted": count(EventKind.SERVE_REQUEST_EVICTED),
        "leases_expired": count(EventKind.SERVE_LEASE_EXPIRED),
        # a worker's HIT edges carry the admitted tokens, its EVICTED
        # edges the evicted pages
        "prefix": {
            "hits": count(EventKind.SERVE_PREFIX_HIT),
            "saved_prefill_tokens": sum(
                int(r.get("hit_tokens", 0) or 0) for r in records
                if r.get("kind") == EventKind.SERVE_PREFIX_HIT),
            "evicted_pages": sum(
                int(r.get("pages", 0) or 0) for r in records
                if r.get("kind") == EventKind.SERVE_PREFIX_EVICTED),
        },
        "spec": _spec_forensic(records),
    }


def _spec_forensic(records) -> Dict:
    """The speculative-decode totals of the router's COMPLETED edges
    (a worker's DONE twins would count a re-leased request twice)."""
    drafted = accepted = 0
    for r in records:
        if r.get("kind") != EventKind.SERVE_REQUEST_COMPLETED:
            continue
        drafted += int(r.get("spec_drafted") or 0)
        accepted += int(r.get("spec_accepted") or 0)
    return {
        "drafted_tokens": drafted,
        "accepted_tokens": accepted,
        "wasted_tokens": drafted - accepted,
        "accept_rate": (round(accepted / drafted, 4)
                        if drafted else -1.0),
    }


def _requests_main(argv: List[str]) -> int:
    p = argparse.ArgumentParser(
        prog="requests",
        description="the request ledger, from an event timeline")
    p.add_argument("--addr", default="",
                   help="live view: master address (ROADMAP A12)")
    p.add_argument("--events", default="",
                   help="forensic view: event-timeline JSONL path")
    p.add_argument("--json", action="store_true", dest="as_json")
    args = p.parse_args(argv)
    if args.addr:
        raise _waits("requests --addr (the master client)")
    if not args.events:
        print("requests: need --events", file=sys.stderr)
        return 2
    report = _forensic_report(args.events)
    print(json.dumps(report, indent=2))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("usage: python -m dlrover_tpu_torch.serving.cli requests "
              "--events PATH [--json]", file=sys.stderr)
        return 2
    cmd, rest = argv[0], argv[1:]
    if cmd == "serve":
        if rest and rest[0] == "slo":
            raise _waits("serve slo (goodput.derive_slot_ledger)")
        raise _waits("serve --addr (the master client)")
    if cmd == "requests":
        return _requests_main(rest)
    print(f"unknown serving command {cmd!r}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
