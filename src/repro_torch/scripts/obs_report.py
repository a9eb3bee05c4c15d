"""Bench-trajectory regression gate on the port's ``obs.regression``.

Diffs fresh ``BENCH_*.json`` documents against a committed baseline and
exits nonzero when any metric regressed beyond tolerance:

  PYTHONPATH=src python -m repro_torch.scripts.obs_report --fresh bench-out \\
      --timing-tolerance 1.5 --behavior-tolerance 0.05 \\
      --fail-on behavior --report-out bench-out/regression-report.txt

Timing metrics (us_per_call rows, qps_compute, p99 latency) are
machine-dependent: under ``--fail-on behavior`` timing drift beyond its
tolerance only warns. Behavior metrics (cache_hit_rate,
batch_fill_ratio, per-lane request counts, exactness/parity flags, fill
ratios, relaxation round counts, overflow counts) are deterministic
given the same trace/preset, so the tight default tolerance applies and
always gates. Required-table coverage losses gate under either policy.
``--report-out`` also writes the report to a file. No device code runs.
"""
import argparse
import pathlib

from repro_torch.obs.regression import compare_dirs, format_report


def main(argv=None) -> dict:
    """Returns the gate's ``exit_code`` (1 when a regression gates),
    the ``report`` text and the regressions."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--baseline", default=".",
                    help="directory with the committed BENCH_*.json "
                         "(default: the current directory)")
    ap.add_argument("--fresh", required=True,
                    help="directory with the freshly generated "
                         "BENCH_*.json")
    ap.add_argument("--tables", default="",
                    help="comma-separated table names to REQUIRE (e.g. "
                         "serving,query); a required table missing from "
                         "the fresh run fails the gate. Empty: compare "
                         "whatever overlaps")
    ap.add_argument("--timing-tolerance", type=float, default=0.5,
                    help="relative tolerance for timing metrics")
    ap.add_argument("--behavior-tolerance", type=float, default=0.05,
                    help="relative tolerance for deterministic behavior "
                         "metrics")
    ap.add_argument("--fail-on", choices=["any", "behavior"],
                    default="any",
                    help="'any': every regression gates (legacy). "
                         "'behavior': only behavior/coverage regressions "
                         "gate; timing drift beyond tolerance warns")
    ap.add_argument("--report-out", default=None,
                    help="also write the report to this file (CI "
                         "artifact)")
    args = ap.parse_args(argv)
    tables = [t for t in args.tables.split(",") if t] or None
    regs, compared, skipped = compare_dirs(
        args.baseline, args.fresh, tables=tables,
        timing_tolerance=args.timing_tolerance,
        behavior_tolerance=args.behavior_tolerance)
    report = format_report(regs, compared, skipped,
                           timing_tolerance=args.timing_tolerance,
                           behavior_tolerance=args.behavior_tolerance)
    if args.fail_on == "behavior":
        gating = [r for r in regs if r.kind != "timing"]
        warn = len(regs) - len(gating)
        if warn:
            report += (f"\nWARN: {warn} timing regression(s) above "
                       "tolerance — not gating under --fail-on behavior")
        if regs and not gating:
            report += "\nOK (gate): no behavior/coverage regressions"
    else:
        gating = regs
    print(report)
    if not compared and not regs:
        print("WARNING: no tables compared (no overlapping BENCH_*.json)")
    if args.report_out:
        out = pathlib.Path(args.report_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(report + "\n")
        print(f"# report written to {out}")
    return {"exit_code": 1 if gating else 0, "report": report,
            "regressions": regs, "compared": compared, "skipped": skipped}


if __name__ == "__main__":
    raise SystemExit(main()["exit_code"])
