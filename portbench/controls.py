"""The precision control of the check, run on the chip at a cell's own
size; the benchmark's runs never run it.

For each seed it makes two runs of the cell through ``bench.run_cell``
with a short window, and reports what each run's check compared:

* ``program``: the timed path as it is (the lower reading);
* ``bf16``: the reference put in the program's place, computed in
  bfloat16, the precision below the configurations' float32: every
  answer of ``ISLabelIndex.query_host`` is the bfloat16 reference's
  distance over the edge list the index was built from (the upper
  reading).

    python3 portbench/controls.py --workload btc_er2m.q1024 --seeds 1 2 3

Prints one JSON line a run, then the smallest and largest count of
mismatched pairs of each side over the seeds.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from portbench import bench, reference  # noqa: E402


@contextlib.contextmanager
def bf16_in_place(device: str):
    """While open, ``ISLabelIndex.query_host`` answers with the bfloat16
    reference over the edges its index was built from."""
    from repro_torch.core.index import ISLabelIndex
    build, query_host = ISLabelIndex.build, ISLabelIndex.query_host

    def built(n, src, dst, w, *args, **kw):
        idx = build(n, src, dst, w, *args, **kw)
        idx.control_edges = (n, src, dst, w)
        return idx

    def answered(self, s, t):
        return reference.pair_distances(*self.control_edges, s, t, device,
                                        dtype=torch.bfloat16)

    ISLabelIndex.build = staticmethod(built)
    ISLabelIndex.query_host = answered
    try:
        yield
    finally:
        ISLabelIndex.build = staticmethod(build)
        ISLabelIndex.query_host = query_host


def readings(cell: dict, config: dict, traffic: dict, seeds, device: str,
             seconds: float) -> list[dict]:
    """One record a seed and side: what the check compared, and
    ``correct``."""
    out = []
    for seed in seeds:
        for side in ("program", "bf16"):
            with (bf16_in_place(device) if side == "bf16"
                  else contextlib.nullcontext()):
                result, _ = bench.run_cell(cell, config, traffic, seed,
                                           seconds, False, device,
                                           time.perf_counter(), [])
            out.append({"seed": seed, "side": side,
                        "correct": result["correct"],
                        **{k: v["value"]
                           for k, v in result["checks"].items()}})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    spec = bench.load_json(ROOT / "BENCHMARK.json")
    cell, config, traffic = bench.resolve(spec, args.workload)
    recs = readings(cell, config, traffic, args.seeds, "cuda", 1.0)
    for rec in recs:
        print(json.dumps(rec))
    print(json.dumps({"workload": args.workload, **{
        side: [min(r["mismatched_pairs"] for r in recs if r["side"] == side),
               max(r["mismatched_pairs"] for r in recs if r["side"] == side)]
        for side in ("program", "bf16")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
