"""Consolidate a sweep JSON into the README ladder table: per-rung warm
(compile-free) suite totals vs the reference's published CPU numbers
(NLP_comparison.md:15–20), green-cell counts, and a markdown table.

Usage: python benchmarks/ladder_report.py sweep.json [--markdown]
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict

# CTDirect + Ipopt/MUMPS CPU suite totals (NLP_comparison.md:15–20)
REFERENCE = {250: 0.6, 500: 1.4, 1000: 3.8, 2500: 18.0, 5000: 74.8}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("json_file")
    ap.add_argument("--markdown", action="store_true")
    args = ap.parse_args()
    rows = json.load(open(args.json_file))

    by_n = defaultdict(list)
    for r in rows:
        by_n[r["N"]].append(r)

    print(f"{'N':>6} {'green':>7} {'warm_s':>8} {'ipopt_s':>8} {'speedup':>8}")
    md = ["| N | green cells | suite warm (s) | Ipopt/MUMPS CPU (s) | speedup |",
          "|---|---|---|---|---|"]
    for N in sorted(by_n):
        cells = by_n[N]
        green = sum(1 for r in cells if r.get("ok") and r.get("warm_ok", True))
        warm = sum(r.get("warm_s", float("nan")) for r in cells)
        ref = REFERENCE.get(N)
        sp = (ref / warm) if (ref and warm == warm and warm > 0) else float("nan")
        print(f"{N:>6} {green:>4}/{len(cells):<2} {warm:>8.2f} "
              f"{ref if ref else float('nan'):>8.1f} {sp:>7.2f}x")
        md.append(f"| {N} | {green}/{len(cells)} | {warm:.2f} | {ref} | {sp:.2f}x |")
    fails = [r for r in rows if not r.get("ok")]
    if fails:
        print("\nnon-green cells:")
        for r in fails:
            print(f"  {r['problem']} N={r['N']}: "
                  f"{r.get('error', 'obj=' + str(r.get('obj')) + ' iters=' + str(r.get('iters')))}")
    if args.markdown:
        print("\n" + "\n".join(md))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
