"""The format density sweep (tools/sparse_sweep.py's twin).

Builds a pair-intersect workload at each density (the defaults straddle
the 5% sparse density threshold and the 4096-value roaring array
break-even: 0.3% and 3% stage as sorted-array containers, 30% as packed
words), serves it through `MeshManager.count`, the one entry point that
dispatches both container formats (K4 for two sorted-array leaves, K1
for packed words), and gates every density on exact agreement with the
host fold's C++ kernels (ops.native) over the same containers. Writes a
JSON report with each density's QPS, the resident format picked, the
staged bytes split by format and the residency ratio. Exits 1 on any
card-vs-host mismatch or on a format pick that contradicts the density
(a 3% workload staged dense means the stager is broken, not slow).

The card is the default device (without one it raises); `--device cpu`
serves through the kernels' plain versions, where `vs_host` compares
two host paths and only the gates mean anything.

Run: python -m pilosa_tpu_torch.tools.sparse_sweep [--device cuda|cpu]
     [--slices 8] [--iters 5] [--densities 0.003,0.03,0.3]
     [--out chiprun_out/SPARSE_SWEEP.json]
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

from .common import REPO, best_of, build_sparse_holder

PAIR = "Count(Intersect(Bitmap(rowID=0), Bitmap(rowID=1)))"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the pair is served (default cuda; raises "
                         "without a card)")
    ap.add_argument("--slices", type=int, default=8)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--densities", default="0.003,0.03,0.3")
    ap.add_argument("--out", type=Path,
                    default=REPO / "chiprun_out" / "SPARSE_SWEEP.json")
    args = ap.parse_args(argv)

    from ..executor import Executor
    from ..ops import native
    from ..parallel.mesh import ARRAY_VALUE_CAP
    from ..parallel.plan import _lower_tree
    from ..parallel.serve import resident_format
    from ..pql import parse_string

    densities = [float(d) for d in args.densities.split(",") if d]
    tmp = tempfile.mkdtemp(prefix="sparse_sweep_")
    sweep: dict = {}
    failures = []
    holders = []
    try:
        for density in densities:
            hs = build_sparse_holder(tmp, args.slices, density=density)
            holders.append(hs)
            es = Executor(hs, device=args.device)
            mgr = es.mesh_manager()
            tree = parse_string(PAIR).calls[0].children[0]
            leaves: list = []
            shape = _lower_tree(hs, "i", tree, leaves)
            slices = list(range(args.slices))
            n = es._num_slices("i", slices)
            got = mgr.count("i", shape, leaves, slices, n)

            pairs = []
            for s in slices:
                st = hs.fragment("i", "general", "standard", s).storage
                for b in range(16):
                    pairs.append((st.containers[st._find_key(b)],
                                  st.containers[st._find_key(16 + b)]))

            def host_once(pairs_=pairs):
                total = 0
                for ca, cb in pairs_:
                    if ca.array is not None and cb.array is not None:
                        total += native.intersection_count_sorted(
                            ca.array, cb.array)
                    else:
                        total += native.popcnt_and_slice(
                            ca.bitmap.reshape(-1), cb.bitmap.reshape(-1))
                return total

            want = host_once()
            t0 = time.perf_counter()
            for _ in range(3):
                host_once()
            host_dt = (time.perf_counter() - t0) / 3
            dt = best_of(
                lambda m=mgr, sh=shape, lv=leaves, sl=slices, nn=n:
                m.count("i", sh, lv, sl, nn), 1, args.iters)
            sv = mgr._views.get(("i", "general", "standard"))
            fmt = resident_format(sv) if sv is not None else "unstaged"
            dm = mgr.device_memory()
            row = {
                "qps": round(1.0 / dt, 2),
                "mean_ms": round(dt * 1e3, 4),
                "host_cpu_qps": round(1.0 / host_dt, 2),
                "vs_host": round(host_dt / dt, 4),
                "format": fmt,
                "staged_sparse_bytes": int(dm["sparse_bytes"]),
                "staged_dense_bytes": int(dm["padded_bytes"]
                                          - dm["sparse_bytes"]),
                "residency_ratio": round(dm["residency_ratio"], 4),
                "device_vs_host_exact": bool(got == want),
            }
            sweep[f"{density:g}"] = row
            if got != want:
                failures.append(
                    f"density {density:g}: device {got} != host {want}")
            # The 4096-value break-even: an array-container workload must
            # stage sorted-array, a bitmap-container one dense.
            per_container = int(65536 * density)
            expect = ("sparse" if per_container <= ARRAY_VALUE_CAP
                      else "dense")
            if fmt != expect:
                failures.append(
                    f"density {density:g}: staged {fmt}, expected {expect}")
            print(f"density {density:g}: {fmt:6s} "
                  f"qps={row['qps']:>9} vs_host={row['vs_host']} "
                  f"exact={row['device_vs_host_exact']} "
                  f"({args.device})", flush=True)
            mgr.invalidate()
    finally:
        for hs in holders:
            try:
                hs.close()
            except Exception:  # noqa: BLE001 — the report still goes out
                pass
        shutil.rmtree(tmp, ignore_errors=True)

    report = {
        "slices": args.slices,
        "iters": args.iters,
        "sweep": sweep,
        "failures": failures,
        "ok": not failures,
    }
    args.out.parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
        f.write("\n")
    print(f"wrote {args.out}; ok={report['ok']}")
    if failures:
        for msg in failures:
            print("FAIL:", msg, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
