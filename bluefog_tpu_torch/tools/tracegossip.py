"""``trace-gossip``: the flight-recorder dumps of a gang merged into one
chrome trace, the port of ``bluefog_tpu/tools/tracegossip.py`` over the
port's ``utils/flightrec.py``.

    python -m bluefog_tpu_torch.tools trace-gossip <prefix> [-o out.json] \
        [--json]

Each rank's dump ``<prefix>.<rank>.bin`` becomes a process lane, wall
aligned through the dump's clock anchor; every sampled wire trace tag
(``BLUEFOG_TPU_TRACE_SAMPLE``) seen at both ends becomes a flow arrow from
the sender's enqueue to the receiver's decode, and the one-way delays per
edge make the p50/p99 table it prints (``--json``: the stats and the
table as one JSON document).  Host math over whatever dumps survived.
"""

from __future__ import annotations

import glob
import json
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from bluefog_tpu_torch.utils import flightrec

__all__ = ["dump_files", "load_dumps", "edge_delays", "delay_table",
           "edge_delay_records", "merge_gossip"]

# Sender-side chain start and receiver-side chain end of one tagged
# message, for flow arrows and the delay table.
_TX_TYPES = (flightrec.ENQUEUE, flightrec.FLUSH, flightrec.SENDMSG)


def dump_files(prefix: str) -> Dict[int, str]:
    """``{rank: path}`` of the flight-recorder dumps written under
    ``prefix`` (the naming contract: ``<prefix>.<rank>.bin``)."""
    out: Dict[int, str] = {}
    for path in glob.glob(glob.escape(prefix) + ".*.bin"):
        m = re.fullmatch(re.escape(prefix) + r"\.(\d+)\.bin", path)
        if m:
            out[int(m.group(1))] = path
    return dict(sorted(out.items()))


def load_dumps(prefix: str) -> List[dict]:
    """Load every per-rank dump: ``[{rank, offset_us, events}, ...]``
    with ``offset_us`` the µs to add to an event's monotonic timestamp
    to land on the unix-time axis (the dump's clock anchor)."""
    files = dump_files(prefix)
    if not files:
        raise FileNotFoundError(
            f"no flight-recorder dumps match {prefix}.<rank>.bin")
    out = []
    for rank, path in files.items():
        header, events = flightrec.load(path)
        out.append({"rank": rank, "path": path,
                    "offset_us": header["unix_us"] - header["mono_us"],
                    "events": events})
    return out


def _tag_endpoints(dumps: List[dict]):
    """Per matched trace tag ``(src_rank, seq)``: the sender's first tx
    event and the receiver's first rx event, each as ``(dump, index)``.
    Unmatched tags (the other side's ring wrapped past them, or the peer
    died before dumping) are simply absent — the black box reports what
    it has."""
    tx: Dict[Tuple[int, int], Tuple[dict, int]] = {}
    rx: Dict[Tuple[int, int], Tuple[dict, int]] = {}
    for d in dumps:
        ev = d["events"]
        tagged = np.nonzero(ev["seq"])[0]
        for i in tagged:
            key = (int(ev["src"][i]), int(ev["seq"][i]))
            et = int(ev["etype"][i])
            # Only ENQUEUE (tx) and DECODE/FOLD/COMMIT (rx) events carry
            # a TRACE seq; on FLUSH/SENDMSG frame events the seq field is
            # the frame's message count, never a tag.
            if et == flightrec.ENQUEUE:
                if key not in tx or ev["t_us"][i] < \
                        tx[key][0]["events"]["t_us"][tx[key][1]]:
                    tx[key] = (d, int(i))
            elif et == flightrec.DECODE:
                if key not in rx or ev["t_us"][i] < \
                        rx[key][0]["events"]["t_us"][rx[key][1]]:
                    rx[key] = (d, int(i))
            elif et in (flightrec.FOLD, flightrec.COMMIT) \
                    and key not in rx:
                rx[key] = (d, int(i))
    return tx, rx


def edge_delays(dumps: List[dict]) -> Dict[Tuple[int, int], np.ndarray]:
    """One-way delays per directed edge: ``{(src_rank, dst_rank):
    delays_us}`` from matched (sender enqueue → receiver decode) trace
    tags, wall-aligned through each dump's clock anchor."""
    tx, rx = _tag_endpoints(dumps)
    per_edge: Dict[Tuple[int, int], List[float]] = {}
    for key, (sd, si) in tx.items():
        hit = rx.get(key)
        if hit is None:
            continue
        rd, ri = hit
        send_wall = int(sd["events"]["t_us"][si]) + sd["offset_us"]
        recv_wall = int(rd["events"]["t_us"][ri]) + rd["offset_us"]
        edge = (key[0], rd["rank"])
        per_edge.setdefault(edge, []).append(recv_wall - send_wall)
    return {e: np.asarray(v, dtype=np.float64)
            for e, v in sorted(per_edge.items())}


def delay_table(delays: Dict[Tuple[int, int], np.ndarray]) -> str:
    """Per-edge one-way-delay p50/p99 text table (ms)."""
    if not delays:
        return ("trace-gossip: no matched trace tags across the dumps "
                "(was BLUEFOG_TPU_TRACE_SAMPLE set on the senders?)")
    header = (f"{'edge':<14} {'tags':>6} {'p50_ms':>9} {'p99_ms':>9} "
              f"{'max_ms':>9}")
    lines = [header, "-" * len(header)]
    for (src, dst), d in delays.items():
        p50, p99 = np.percentile(d, [50, 99])
        lines.append(f"{f'{src} -> {dst}':<14} {len(d):>6} "
                     f"{p50 / 1e3:>9.3f} {p99 / 1e3:>9.3f} "
                     f"{d.max() / 1e3:>9.3f}")
    return "\n".join(lines)


def edge_delay_records(delays: Dict[Tuple[int, int], np.ndarray]) \
        -> List[dict]:
    """The delay table as machine-readable rows (``--json``): one dict
    per directed edge, same edges and the same ms percentiles as
    :func:`delay_table` — what CI and ``bench_comm.py`` diff against the
    link observatory's ONLINE estimates."""
    out = []
    for (src, dst), d in delays.items():
        p50, p99 = np.percentile(d, [50, 99])
        out.append({"src": int(src), "dst": int(dst), "tags": int(len(d)),
                    "p50_ms": float(p50 / 1e3), "p99_ms": float(p99 / 1e3),
                    "max_ms": float(d.max() / 1e3)})
    return out


def merge_gossip(prefix: str, out_path: Optional[str] = None,
                 dumps: Optional[List[dict]] = None) -> Tuple[str, dict]:
    """Merge the dumps under ``prefix`` into one chrome trace with a
    process lane per rank and cross-rank flow arrows per matched trace
    tag.  Returns ``(out_path, stats)``."""
    if dumps is None:
        dumps = load_dumps(prefix)
    tx, rx = _tag_endpoints(dumps)
    flows = {k for k in tx if k in rx}
    # Rebase so t=0 is the earliest wall-aligned event (readable numbers).
    starts = [int(d["events"]["t_us"].min()) + d["offset_us"]
              for d in dumps if len(d["events"])]
    base = min(starts, default=0)
    merged: List[dict] = []
    for d in dumps:
        rank = d["rank"]
        merged.append({"name": "process_name", "ph": "M", "pid": rank,
                       "tid": 0, "ts": 0, "args": {"name": f"rank {rank}"}})
        merged.append({"name": "process_sort_index", "ph": "M",
                       "pid": rank, "tid": 0, "ts": 0,
                       "args": {"sort_index": rank}})
        for tid, label in ((0, "tx"), (1, "rx")):
            merged.append({"name": "thread_name", "ph": "M", "pid": rank,
                           "tid": tid, "ts": 0, "args": {"name": label}})
        ev = d["events"]
        for i in range(len(ev)):
            et = int(ev["etype"][i])
            ts = int(ev["t_us"][i]) + d["offset_us"] - base
            tid = 0 if et in _TX_TYPES else 1
            name = ev["name"][i].split(b"\0", 1)[0].decode(
                "utf-8", "replace")
            ename = flightrec.ETYPE_NAMES.get(et, str(et))
            merged.append({
                "name": f"{ename} {name}".rstrip(), "ph": "X", "ts": ts,
                "dur": 1, "pid": rank, "tid": tid, "cat": "gossip",
                "args": {"op": int(ev["op"][i]), "src": int(ev["src"][i]),
                         "dst": int(ev["dst"][i]),
                         "seq": int(ev["seq"][i]),
                         "stripe": int(ev["stripe"][i]),
                         "bytes": int(ev["len"][i])}})
            key = (int(ev["src"][i]), int(ev["seq"][i]))
            if key in flows:
                # Flow arrow endpoints bind to the co-timed slice above
                # (identity match: the dicts are the loaded dump objects).
                if tx[key][0] is d and tx[key][1] == i:
                    merged.append({"name": "gossip", "cat": "flow",
                                   "ph": "s", "id": (key[0] << 32)
                                   | key[1], "pid": rank, "tid": tid,
                                   "ts": ts})
                elif rx[key][0] is d and rx[key][1] == i:
                    merged.append({"name": "gossip", "cat": "flow",
                                   "ph": "f", "bp": "e",
                                   "id": (key[0] << 32) | key[1],
                                   "pid": rank, "tid": tid, "ts": ts})
    if out_path is None:
        out_path = prefix + ".merged.json"
    with open(out_path, "w") as f:
        json.dump(merged, f)
    stats = {
        "ranks": [d["rank"] for d in dumps],
        "events": int(sum(len(d["events"]) for d in dumps)),
        "tags_sent": len(tx),
        "flows_matched": len(flows),
    }
    return out_path, stats


def main_trace_gossip(prefix: str, out_path: Optional[str] = None,
                      as_json: bool = False) -> int:
    dumps = load_dumps(prefix)
    out, stats = merge_gossip(prefix, out_path, dumps=dumps)
    delays = edge_delays(dumps)
    if as_json:
        # Machine-readable mode: stdout is EXACTLY one JSON document
        # (json.loads round-trips the whole output), same edges as the
        # text table.
        print(json.dumps({"trace": out, "stats": stats,
                          "edges": edge_delay_records(delays)},
                         indent=2, sort_keys=True))
        return 0
    print(f"trace-gossip: wrote {out} ({stats['events']} events, "
          f"{len(stats['ranks'])} rank lane(s), "
          f"{stats['flows_matched']}/{stats['tags_sent']} trace tag(s) "
          "matched into flow arrows)")
    print()
    print(delay_table(delays))
    return 0
