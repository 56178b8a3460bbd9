"""Parse a jax.profiler trace (--profile DIR) into per-op device-time totals.

The device-time reconciliation tool: aggregates the traced HLO ops by
category and by op so a per-kernel table can be checked against the measured
fused device time.  Uses xprof's ``hlo_stats`` tool (xprof is not a
dependency of the program; install it where traces are read).

Usage:
    python scripts/parse_xla_trace.py <profile_dir> [--top N] [--json]
"""

import argparse
import glob
import json
import os
import sys
from collections import defaultdict


def find_xplane(profile_dir: str) -> list[str]:
    return sorted(glob.glob(os.path.join(profile_dir, "**", "*.xplane.pb"),
                            recursive=True))


def _rows(table):
    cols = [c["id"] for c in table["cols"]]
    for row in table.get("rows", []):
        yield dict(zip(cols, (c.get("v") for c in row["c"])))


def load_hlo_stats(paths: list[str]):
    from xprof.convert import raw_to_tool_data

    data, _ct = raw_to_tool_data.xspace_to_tool_data(paths, "hlo_stats", {})
    table = json.loads(data if isinstance(data, str) else data.decode())
    rows = list(_rows(table))
    if rows:
        return rows
    # CPU traces carry no device HLO plane — fall back to framework op stats
    # (op name in "operation", category in "type"; remap to the hlo schema)
    data, _ct = raw_to_tool_data.xspace_to_tool_data(
        paths, "framework_op_stats", {}
    )
    tables = json.loads(data if isinstance(data, str) else data.decode())
    out = []
    for t in tables if isinstance(tables, list) else [tables]:
        for r in _rows(t):
            out.append({
                "category": r.get("type"),
                "hlo_op_name": r.get("operation"),
                "total_self_time": r.get("total_self_time"),
                "bound_by": r.get("bound_by"),
            })
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("profile_dir")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args()

    paths = find_xplane(args.profile_dir)
    if not paths:
        print(f"no .xplane.pb under {args.profile_dir}", file=sys.stderr)
        return 1

    by_cat = defaultdict(float)
    by_op = defaultdict(float)
    bound = defaultdict(float)
    total_us = 0.0
    for row in load_hlo_stats(paths):
        t = float(row.get("total_self_time") or 0.0)  # microseconds
        cat = str(row.get("category") or "?")
        if cat.lower() == "idle":
            continue
        total_us += t
        by_cat[cat] += t
        by_op[str(row.get("hlo_op_name") or "?")] += t
        bound[str(row.get("bound_by") or "?")] += t

    cats = sorted(by_cat.items(), key=lambda kv: -kv[1])
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[: args.top]

    if args.json:
        print(json.dumps({
            "total_us": total_us,
            "by_category_us": dict(cats),
            "top_ops_us": dict(ops),
            "bound_by_us": dict(bound),
        }))
        return 0

    print(f"total traced device self-time: {total_us / 1e3:.3f} ms")
    print("\nby HLO category:")
    for name, t in cats:
        print(f"  {t / 1e3:9.3f} ms  {100 * t / max(total_us, 1e-12):5.1f}%  {name}")
    if any(k != "?" for k in bound):
        print("\nby bound-by:")
        for name, t in sorted(bound.items(), key=lambda kv: -kv[1]):
            print(f"  {t / 1e3:9.3f} ms  {100 * t / max(total_us, 1e-12):5.1f}%  {name}")
    print(f"\ntop {args.top} ops by self-time:")
    for name, t in ops:
        print(f"  {t / 1e3:9.3f} ms  {100 * t / max(total_us, 1e-12):5.1f}%  {name[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
