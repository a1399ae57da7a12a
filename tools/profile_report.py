"""Per-stage device-vs-host time table from a jax.profiler trace.

Run the pipeline with --profile_dir <dir>, then:

    python tools/profile_report.py <dir> [--out PROFILE_STAGES.json]

Finds the `telr_stage:<name>` spans the pipeline emits (pipeline.py
timed()) and attributes every device-lane op whose timestamp falls inside
a stage span to that stage.  The output table is the SURVEY §5
"tracing/profiling" artifact: measured device seconds per stage next to
wall seconds.  Device lanes are the GPU planes (`/device:GPU:N`).

Data source: `*.xplane.pb` (the profiler's complete event store), parsed
with a minimal protobuf wire reader below — the exported perfetto
trace.json.gz is capped at 1,000,000 events, which a pipeline run blows
through in seconds (observed: a 10-minute bundled run kept only its first
10.8s of events), silently emptying the table.  Falls back to the
perfetto JSON when no xplane file exists.
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import sys
from collections import defaultdict

# ---------------------------------------------------------------------------
# Minimal protobuf wire-format reader for the XSpace schema
# (tsl/profiler/protobuf/xplane.proto).  Only the fields the report needs:
#   XSpace.planes(1) -> XPlane{name(2), lines(3), event_metadata(4)}
#   XLine{name(2), timestamp_ns(3), events(4)}
#   XEvent{metadata_id(1), offset_ps(2), duration_ps(3)}
#   XEventMetadata{id(1), name(2)}    (map value of XPlane.event_metadata)
# ---------------------------------------------------------------------------


def _varint(buf: memoryview, i: int):
    r = 0
    s = 0
    while True:
        b = buf[i]
        i += 1
        r |= (b & 0x7F) << s
        if not b & 0x80:
            return r, i
        s += 7


def _fields(buf: memoryview):
    """Yield (field_no, wire_type, value_or_span) over one message body."""
    i, n = 0, len(buf)
    while i < n:
        key, i = _varint(buf, i)
        fno, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _varint(buf, i)
            yield fno, wt, v
        elif wt == 2:
            ln, i = _varint(buf, i)
            yield fno, wt, buf[i:i + ln]
            i += ln
        elif wt == 1:
            yield fno, wt, buf[i:i + 8]
            i += 8
        elif wt == 5:
            yield fno, wt, buf[i:i + 4]
            i += 4
        else:  # group wire types: not used by xplane
            raise ValueError(f"unsupported wire type {wt}")


def _parse_event(buf: memoryview):
    mid = off_ps = dur_ps = 0
    for fno, wt, v in _fields(buf):
        if fno == 1 and wt == 0:
            mid = v
        elif fno == 2 and wt == 0:
            off_ps = v
        elif fno == 3 and wt == 0:
            dur_ps = v
    return mid, off_ps, dur_ps


def _parse_line(buf: memoryview):
    name = ""
    ts_ns = 0
    events = []
    for fno, wt, v in _fields(buf):
        if fno == 2 and wt == 2:
            name = bytes(v).decode("utf-8", "replace")
        elif fno == 3 and wt == 0:
            ts_ns = v
        elif fno == 4 and wt == 2:
            events.append(v)
    return name, ts_ns, events


def _parse_meta_entry(buf: memoryview):
    """map<int64, XEventMetadata> entry -> (id, name)."""
    mid, name = 0, ""
    for fno, wt, v in _fields(buf):
        if fno == 1 and wt == 0:
            mid = v
        elif fno == 2 and wt == 2:
            for f2, w2, v2 in _fields(v):
                if f2 == 1 and w2 == 0:
                    mid = v2
                elif f2 == 2 and w2 == 2:
                    name = bytes(v2).decode("utf-8", "replace")
    return mid, name


def _parse_plane_header(buf: memoryview):
    """Plane name + raw line spans + event-metadata names (lazy events)."""
    name = ""
    lines = []
    meta = {}
    for fno, wt, v in _fields(buf):
        if fno == 2 and wt == 2:
            name = bytes(v).decode("utf-8", "replace")
        elif fno == 3 and wt == 2:
            lines.append(v)
        elif fno == 4 and wt == 2:
            mid, mname = _parse_meta_entry(v)
            meta[mid] = mname
    return name, lines, meta


def iter_planes(path: str):
    with open(path, "rb") as f:
        data = f.read()
    buf = memoryview(data)
    for fno, wt, v in _fields(buf):
        if fno == 1 and wt == 2:
            yield _parse_plane_header(v)


# ---------------------------------------------------------------------------


def build_report_xplane(path: str) -> dict:
    stages = []        # (name, t0_ps, t1_ps)
    device_planes = []  # (plane_name, [(line_name, ts_ns, [event spans])])

    for pname, lines, meta in iter_planes(path):
        is_dev = pname.startswith("/device:GPU:")
        if is_dev:
            parsed = [_parse_line(lb) for lb in lines]
            device_planes.append((pname, parsed))
            continue
        # host plane: hunt for telr_stage spans
        stage_mids = {mid: n.split(":", 1)[1] for mid, n in meta.items()
                      if n.startswith("telr_stage:")}
        if not stage_mids:
            continue
        for lb in lines:
            _, ts_ns, events = _parse_line(lb)
            base_ps = ts_ns * 1000
            for eb in events:
                mid, off_ps, dur_ps = _parse_event(eb)
                if mid in stage_mids:
                    t0 = base_ps + off_ps
                    stages.append((stage_mids[mid], t0, t0 + dur_ps))
    stages.sort(key=lambda s: s[1])

    dev_time = defaultdict(float)   # stage -> ps
    dev_total = 0.0
    lanes = []
    starts = [s[1] for s in stages]
    import bisect
    for pname, parsed in device_planes:
        lanes.append(pname)
        # prefer the "XLA Ops" lanes (device busy time); "XLA Modules"
        # spans whole executable launches including gaps and would
        # double-count on top of the op lane
        op_lines = [pl for pl in parsed if "op" in pl[0].lower()]
        use = op_lines if op_lines else parsed
        for lname, ts_ns, events in use:
            low = lname.lower()
            if "step" in low or "counter" in low or "module" in low:
                continue
            base_ps = ts_ns * 1000
            for eb in events:
                _, off_ps, dur_ps = _parse_event(eb)
                dev_total += dur_ps
                t = base_ps + off_ps
                k = bisect.bisect_right(starts, t) - 1
                if k >= 0 and t < stages[k][2]:
                    dev_time[stages[k][0]] += dur_ps
    table = []
    for name, s0, s1 in stages:
        wall = (s1 - s0) / 1e12
        dev = dev_time.get(name, 0.0) / 1e12
        table.append({
            "stage": name,
            "wall_s": round(wall, 3),
            "device_s": round(dev, 3),
            "device_frac": round(dev / wall, 3) if wall else 0.0,
        })
    return {"stages": table,
            "device_total_s": round(dev_total / 1e12, 3),
            "device_lanes": sorted(lanes),
            "source": "xplane"}


# --------------------------- perfetto fallback -----------------------------


def load_trace(profile_dir: str) -> dict:
    cands = sorted(glob.glob(os.path.join(
        profile_dir, "**", "*.trace.json.gz"), recursive=True),
        key=os.path.getmtime)
    if not cands:
        raise SystemExit(f"no trace.json.gz under {profile_dir}")
    with gzip.open(cands[-1], "rt") as f:
        return json.load(f)


def build_report(trace: dict) -> dict:
    events = trace.get("traceEvents", [])
    pid_names = {}
    tid_names = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pid_names[e["pid"]] = e["args"].get("name", "")
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            tid_names[(e["pid"], e.get("tid"))] = e["args"].get("name", "")

    device_pids = {p for p, n in pid_names.items()
                   if "/device:GPU:" in n}
    stages = []   # (name, ts, te)
    for e in events:
        if e.get("ph") == "X" and str(e.get("name", "")).startswith(
                "telr_stage:"):
            stages.append((e["name"].split(":", 1)[1], e["ts"],
                           e["ts"] + e.get("dur", 0)))
    stages.sort(key=lambda s: s[1])

    dev_time = defaultdict(float)
    dev_total = 0.0
    for e in events:
        if e.get("ph") != "X" or e.get("pid") not in device_pids:
            continue
        tname = tid_names.get((e["pid"], e.get("tid")), "")
        if "step" in tname.lower():
            continue
        ts = e["ts"]
        dur = e.get("dur", 0)
        dev_total += dur
        for name, s0, s1 in stages:
            if s0 <= ts < s1:
                dev_time[name] += dur
                break

    table = []
    for name, s0, s1 in stages:
        wall = (s1 - s0) / 1e6
        dev = dev_time.get(name, 0.0) / 1e6
        table.append({
            "stage": name,
            "wall_s": round(wall, 3),
            "device_s": round(dev, 3),
            "device_frac": round(dev / wall, 3) if wall else 0.0,
        })
    return {"stages": table,
            "device_total_s": round(dev_total / 1e6, 3),
            "device_lanes": sorted(pid_names[p] for p in device_pids),
            "source": "perfetto (1M-event cap; prefer xplane)"}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("profile_dir")
    ap.add_argument("--out", default="PROFILE_STAGES.json")
    a = ap.parse_args()
    xplanes = sorted(glob.glob(os.path.join(
        a.profile_dir, "**", "*.xplane.pb"), recursive=True),
        key=os.path.getmtime)
    if xplanes:
        report = build_report_xplane(xplanes[-1])
    else:
        report = build_report(load_trace(a.profile_dir))
    with open(a.out, "w") as f:
        json.dump(report, f, indent=2)
    for row in report["stages"]:
        print(f"{row['stage']:20s} wall {row['wall_s']:8.2f}s   "
              f"device {row['device_s']:8.2f}s   "
              f"({row['device_frac'] * 100:5.1f}%)")
    print(f"device lanes: {report['device_lanes']}")


if __name__ == "__main__":
    main()
