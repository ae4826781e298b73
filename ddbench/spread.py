"""The spread of each metric over sets of runs, for setting a bound.

    python3 ddbench/spread.py set1/*.out -- set2/*.out

Each file holds one run's standard output; its last line is the result.
Files before ``--`` are one set, files after it another (same seeds).  For
each metric it prints each set's median and spread (the distance between
the quartiles over the median, as ``statistics.quantiles(values, n=4)``
gives them), the wider spread, and five times it: the bound the rules ask
for, never under 1%.
"""
from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ddbench import arith  # noqa: E402


def _values(paths: list[str]) -> dict[str, list[float]]:
    out: dict[str, list[float]] = {}
    for p in paths:
        res = json.loads(Path(p).read_text().strip().splitlines()[-1])
        for name, m in res["metrics"].items():
            out.setdefault(name, []).append(m["value"])
    return out


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    cut = args.index("--") if "--" in args else len(args)
    sets = [s for s in (args[:cut], args[cut + 1:]) if s]
    readings = [_values(s) for s in sets]
    for name in sorted(readings[0]):
        rows, widest = [], 0.0
        for r in readings:
            v = r.get(name, [])
            if len(v) < 2:
                continue
            sp = arith.spread(v)
            widest = max(widest, sp)
            rows.append(f"median {statistics.median(v):.6g} spread {sp:.4f} "
                        f"(n={len(v)})")
        print(f"{name}: {' | '.join(rows)} | widest {widest:.4f} | "
              f"5x {max(5 * widest, 0.01):.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
